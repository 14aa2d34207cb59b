"""setup_s: seconds from process start to the window's start: imports,
weights from the seed, the engine, kernel builds (a checkout's first run)
and the warm-up through the window's own server and bank."""


def read(ctx):
    return ctx.setup_s
