"""sched.worker_offcpu_share: the share of the server worker's time in
the traced slice that its thread spent off the CPU (waiting on the
interpreter lock, preempted): wall minus thread CPU time over wall, summed
over the worker's outermost spans (``server.*``, ``sched.boundary``), less
the spans that wait by design (``engine.chunk.wait``, the chunk's host
transfer, and ``server.wait``, the idle worker).  The worker is the
thread of the ``engine.chunk`` spans."""
import collections

from portbench import spans

WAITS = ("engine.chunk.wait", "server.wait")


def read(ctx):
    got = spans.spans_in(ctx)
    threads = collections.Counter(s.thread for s in got or ()
                                  if s.name == "engine.chunk")
    if not threads:
        return None
    worker = threads.most_common(1)[0][0]
    mine = sorted((s for s in got if s.thread == worker),
                  key=lambda s: (s.t0, -s.t1))
    wall = cpu = 0
    end = None
    for s in mine:
        if end is None or s.t0 >= end:          # an outermost span
            wall += s.t1 - s.t0
            cpu += s.cpu
            end = s.t1
        if s.name in WAITS:
            wall -= s.t1 - s.t0
            cpu -= s.cpu
    return (wall - cpu) / wall if wall > 0 else None
