"""T8 engine: launch bounds of the port's CUDA grids, the counterpart of
``repro/analysis/kernelbounds.py`` (which evaluates Pallas BlockSpec index
maps over their grids).

The port's kernels take their grids and splits from the Python plans of
``kernels/plan.py`` (``pick_tiles``, ``pick_split``, ``split_plan``,
``flash_route``, ``partial_route``, ``norm_route``, ``norm_rows``), which
this module evaluates as the wrappers do, and index by ``blockIdx`` in
``kernels/csrc/*.cu``.  This
module models, for every kernel of B1-B5, its grid and what each block
addresses: query rows, the K/V slots of its split, the page-table entries
and pool pages it reads, the partial or output rows it writes; and for the
merge (``merge_kernel``) and the carry fold (``carry_fold_kernel``) the
rows and columns each thread owns.  Over a matrix of configurations (the
reference's ``CONFIGS`` shapes, a W=256 chain and Fig. 10b's B5 shape,
the card's 132 SMs and the resident-slot counts the CPU tests hand
``split_plan``; and, where the caller hands them in, ``chip_smoke.py``'s
main-path and split-edge shapes: ``shapes(chip)``), it proves:

* **bounds**: every block's rows start inside ``G*W`` and its slot range
  inside the cache, every read and write lies inside its operand;
* **tiling**: the output, partial and workspace rows are written exactly
  once (no gap, no double write);
* **page domain**: the table walk reads only its own row of the block
  table and addresses only pages reserved in that row or the trash page;
* **merge coverage**: the merge and fold grids cover every (row, head,
  column) once and read only the parts the walk wrote.

**Ties to the CUDA sources.**  The grids used are the ``.cu`` files' own
``dim3 grid(...)`` and launch expressions, read from the sources and
evaluated (``read_launches``), and each must equal the model's grid; the
launch constants (``kRows``, ``kTile``, ``kThreads``, ``kWarpRows``, ...)
are read from the sources and must equal the model's ``MODEL_CONSTANTS``
and the Python plans' (``plan.FLASH_TILE``, ``plan.WARP_ROWS``, ...).  A
constant or a grid changed in C and not here fails.

Everything here is stdlib-only, like the rules that run it (``plan.py``
imports no torch).
"""
from __future__ import annotations

import ast
import dataclasses
import functools
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.kernels.plan import (flash_route, norm_route, norm_rows,
                                      partial_route, pick_tiles, split_plan)

KERNELS_DIR = Path(__file__).resolve().parents[1] / "kernels"
CSRC = KERNELS_DIR / "csrc"

# the launch constants the model is written against, per source
MODEL_CONSTANTS = {
    "attention_common.cuh": {"kThreads": 256},
    "flash_common.cuh": {"kThreads": 128, "kTile": 64, "kRows": 64,
                         "kHdMax": 128},
    "tree_partial.cu": {"kWarpRows": 8, "kWarpThreads": 128,
                        "kWarpKeys": 64, "kWarpHdMax": 128,
                        "kF32Threads": 128, "kF32Keys": 64,
                        "kF32HdMax": 128},
}
# the Python plans' launch constants: name in kernels/plan.py -> (source,
# constant)
PLAN_CONSTANTS = {
    "FLASH_TILE": ("flash_common.cuh", "kTile"),
    "FLASH_ROWS": ("flash_common.cuh", "kRows"),
    "FLASH_HD_MAX": ("flash_common.cuh", "kHdMax"),
    "WARP_KEYS": ("tree_partial.cu", "kWarpKeys"),
    "WARP_ROWS": ("tree_partial.cu", "kWarpRows"),
    "F32_KEYS": ("tree_partial.cu", "kF32Keys"),
}
SMS = 132                     # an H100 SXM's streaming multiprocessors
PER_SM = (1, 2)               # resident split-walk blocks an SM holds


# --------------------------------------------------------------------------
# the C sources: constants and launch expressions
# --------------------------------------------------------------------------
_CONST_RE = re.compile(r"constexpr\s+int\s+(\w+)\s*=\s*([^;]+);")


def _c_to_py(expr: str) -> str:
    expr = re.sub(r"\((?:long long|size_t|int|unsigned)\)", "", expr)
    expr = re.sub(r"\b(?:a|p)\s*(?:\.|->)\s*", "", expr)
    expr = re.sub(r"\b\w+::", "", expr)
    return expr.replace("/", "//")


def _eval(expr: str, env: Dict[str, int]) -> int:
    return int(eval(compile(expr, "<cuda>", "eval"),  # noqa: S307
                    {"__builtins__": {}, "min": min, "max": max}, env))


def read_constants(csrc: Path = CSRC) -> Dict[str, Dict[str, int]]:
    """Every ``constexpr int`` of each source that evaluates on the
    constants before it (template-dependent ones are left out)."""
    out: Dict[str, Dict[str, int]] = {}
    for path in sorted(csrc.glob("*.cu*")):
        env: Dict[str, int] = {}
        for name, expr in _CONST_RE.findall(path.read_text()):
            try:
                env.setdefault(name, _eval(_c_to_py(expr), dict(env)))
            except Exception:            # noqa: BLE001 - template constant
                continue
        out[path.name] = env
    return out


def read_plan_constants(kernels: Path = KERNELS_DIR) -> Dict[str, int]:
    """The module-level int constants of ``plan.py`` under ``kernels`` (by
    AST, so a copy of the sources can be checked)."""
    out = {}
    for st in ast.parse((kernels / "plan.py").read_text()).body:
        if isinstance(st, ast.Assign) and \
                isinstance(st.value, ast.Constant) and \
                isinstance(st.value.value, int):
            for t in st.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = st.value.value
    return out


@dataclasses.dataclass
class CLaunch:
    file: str
    kernel: str                    # the launched name, templates stripped
    line: int
    grid: Tuple[str, ...]          # Python expressions, x [, y [, z]]
    threads: str


def _balanced(text: str, i: int, open_="(", close=")") -> int:
    """Index just past the bracket matching ``text[i]``."""
    depth = 0
    for j in range(i, len(text)):
        if text[j] == open_:
            depth += 1
        elif text[j] == close:
            depth -= 1
            if depth == 0:
                return j + 1
    raise ValueError("unbalanced")


def _split_top(text: str) -> List[str]:
    """``text`` split at the commas outside parentheses."""
    out, depth, cur = [], 0, ""
    for ch in text:
        depth += (ch == "(") - (ch == ")")
        if ch == "," and depth == 0:
            out.append(cur.strip())
            cur = ""
        else:
            cur += ch
    out.append(cur.strip())
    return out


def _local(text: str, lo: int, pos: int, name: str) -> Optional[str]:
    """The last ``const int <name> = expr;`` in ``text[lo:pos]``."""
    best = None
    for m in re.finditer(r"(?:const\s+)?(?:int|size_t|long long)\s+"
                         + name + r"\s*=\s*([^;]+);", text[lo:pos]):
        best = m.group(1)
    return best


def _qualify(expr: str, file: str, consts) -> str:
    """Namespaced launch constants (``flash::kRows``) by their value, the
    rest left to ``_c_to_py``."""
    spaces = {"flash": "flash_common.cuh", "attn": "attention_common.cuh"}

    def sub(m):
        return str(consts.get(spaces[m.group(1)], {}).get(m.group(2),
                                                          m.group(0)))
    expr = re.sub(r"\b(flash|attn)::(k\w+)\b", sub, expr)
    own = dict(consts.get("attention_common.cuh", {}))
    own.update(consts.get(file, {}))
    return re.sub(r"\b(k[A-Z]\w*)\b",
                  lambda m: str(own.get(m.group(1), m.group(1))), expr)


def read_launches(csrc: Path = CSRC) -> List[CLaunch]:
    """Every ``kernel<<<grid, threads, ...>>>`` of the sources, with the
    grid's expressions resolved through the locals of its function (the
    text since the last top-level closing brace) and the constants."""
    consts = read_constants(csrc)
    out: List[CLaunch] = []
    for path in sorted(csrc.glob("*.cu")):
        text = path.read_text()
        for m in re.finditer(r"<<<", text):
            i = m.start()
            lo = text.rfind("\n}", 0, i)
            j = i
            if text[j - 1] == ">":                  # template arguments
                depth = 0
                while True:
                    j -= 1
                    depth += {">": 1, "<": -1}.get(text[j], 0)
                    if depth == 0:
                        break
            k = j
            while k > 0 and (text[k - 1].isalnum() or text[k - 1] in "_:"):
                k -= 1
            kernel = text[k:j].split("::")[-1]
            end = text.index(">>>", i)
            args = _split_top(text[i + 3:end])
            g = args[0]
            if g.startswith("dim3"):
                a = g.index("(")
                grid = _split_top(g[a + 1:_balanced(g, a) - 1])
            elif re.fullmatch(r"\w+", g):
                dm = None
                for dm in re.finditer(r"dim3\s+" + g + r"\s*\(",
                                      text[lo:i]):
                    pass
                if dm is not None:
                    a = lo + dm.end() - 1
                    grid = _split_top(text[a + 1:_balanced(text, a) - 1])
                else:
                    grid = [g]
            else:
                grid = [g]
            resolved = []
            for e in grid:
                for _ in range(4):      # locals defined through locals
                    for name in set(re.findall(r"\b[A-Za-z_]\w*\b", e)):
                        v = _local(text, lo, i, name)
                        if v is not None:
                            e = re.sub(r"\b" + name + r"\b", f"({v})", e)
                resolved.append(_c_to_py(_qualify(e, path.name, consts)))
            threads = _c_to_py(_qualify(args[1], path.name, consts)) \
                if len(args) > 1 else ""
            out.append(CLaunch(path.name, kernel,
                               text.count("\n", 0, i) + 1, tuple(resolved),
                               threads))
    return out


def check_constants(csrc: Path = CSRC, kernels: Path = KERNELS_DIR
                    ) -> List[str]:
    """The model's constants and the Python plans' against the sources."""
    errs = []
    consts = read_constants(csrc)
    for src, want in MODEL_CONSTANTS.items():
        got = consts.get(src, {})
        for name, v in want.items():
            if got.get(name) != v:
                errs.append(f"{src}: `{name}` is {got.get(name)} in C, "
                            f"{v} in the launch-bounds model — update "
                            f"repro_torch/analysis/launchbounds.py with it")
    plans = read_plan_constants(kernels)
    for name, (src, cname) in PLAN_CONSTANTS.items():
        c = consts.get(src, {}).get(cname)
        if plans.get(name) != c:
            errs.append(f"kernels/plan.py: `{name}` = {plans.get(name)} but "
                        f"{src} states `{cname}` = {c}")
    return errs


# --------------------------------------------------------------------------
# the C side of the plans
# --------------------------------------------------------------------------
def attn_smem_bytes(R, W, hd, tile) -> int:
    """``attention_common.cuh::smem_bytes``."""
    floats = 2 * R * hd + tile * (hd + 1) + tile * hd + R * tile + 3 * R \
        + 2 * tile
    ints = 2 * tile + 2 * W
    return floats * 4 + ints * 4 + W * W + R * tile


def _flash_fits(hd) -> int:
    """The tensor-core walk's shared memory as ``split_plan`` asks for it:
    0, since whether a head_dim fits is the library's own check at the
    call (``flash::layout``), and no grid depends on the amount."""
    return 0


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(n):
    """The occupancy query's answer, ``n`` blocks an SM (one function per
    ``n``, so ``split_plan``'s cache keeps one entry a shape)."""
    return lambda hd: n


# --------------------------------------------------------------------------
# configurations
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Shape:
    """One shape: a dense cache of S slots, or a page pool of P pages
    (the trash page last) walked through ``table`` (B rows of maxp pages,
    -1 unreserved)."""
    desc: str
    B: int
    W: int
    Hq: int
    Hkv: int
    hd: int
    S: int = 0
    ps: int = 0
    P: int = 0
    table: Optional[List[List[int]]] = None

    @property
    def maxp(self) -> int:
        return len(self.table[0]) if self.table else 0

    @property
    def paged(self) -> bool:
        return self.table is not None


def _tables(B, maxp, holes=()):
    """Rows of consecutive pages, row b owning [b*maxp, (b+1)*maxp), with
    the (row, page) entries of ``holes`` unreserved."""
    t = [[b * maxp + i for i in range(maxp)] for b in range(B)]
    for b, i in holes:
        t[b][i] = -1
    return t


# the reference's CONFIGS shapes (``repro/analysis/kernelbounds.py``: dense
# (B, W, Hq, Hkv, hd, S), paged (B, W, Hq, Hkv, hd, ps, P, tables), sparse
# (B, W, Hq, Hkv, hd))
REFERENCE_DENSE = [(2, 4, 4, 2, 8, 16), (1, 2, 2, 1, 4, 5),
                   (3, 4, 8, 4, 16, 3), (2, 8, 8, 2, 8, 64),
                   (1, 4, 4, 4, 8, 1)]
REFERENCE_PAGED = [
    (2, 4, 4, 2, 8, 8, 6, [[0, 1, 2, -1], [3, -1, -1, -1]]),
    (1, 2, 2, 1, 4, 16, 3, [[-1, -1]]),
    (3, 4, 8, 4, 16, 8, 9, [[0, 1, 2, 3, 4, 5], [6, 7, -1, -1, -1, -1],
                            [-1] * 6]),
    (2, 8, 8, 8, 8, 16, 4, [[0], [2]]),
]
REFERENCE_SPARSE = [(2, 4, 4, 2, 8), (1, 2, 2, 2, 4), (3, 8, 8, 4, 16)]

# the W=256 chain (a --prefill-chunk 256 piece) and Fig. 10b's B5 shape
WIDE = {"chain W=256": (4, 256, 32, 32, 128, 832),
        "fig10b": (1, 256, 8, 8, 128, 0)}


def shapes(chip: Optional[dict] = None
           ) -> List[Tuple[Shape, Tuple[Tuple[str, str], ...]]]:
    """Every shape with the (q, pool) dtypes it is evaluated at.  ``chip``
    (``chip_smoke.launch_shapes``) adds the smoke's shapes: ``main``
    (label -> (B, W, Hq, Hkv, hd, S), dense and paged at ``main_ps``
    slots a page) and ``split_edge`` (label -> (Hkv, G, W, hd, q dtype,
    pool dtype, S), ``edge_b`` rows at ``edge_ps`` slots a page)."""
    every = (("float32", "float32"), ("bfloat16", "bfloat16"),
             ("bfloat16", "int8"), ("float32", "int8"))
    out = []
    for B, W, Hq, Hkv, hd, S in REFERENCE_DENSE:
        out.append((Shape(f"reference dense B={B} W={W} Hq={Hq} Hkv={Hkv} "
                          f"hd={hd} S={S}", B, W, Hq, Hkv, hd, S=S),
                    every[:2]))
    for B, W, Hq, Hkv, hd, ps, P, t in REFERENCE_PAGED:
        out.append((Shape(f"reference paged B={B} W={W} Hq={Hq} Hkv={Hkv} "
                          f"hd={hd} ps={ps} P={P}", B, W, Hq, Hkv, hd,
                          S=len(t[0]) * ps, ps=ps, P=P, table=t), every))
    for B, W, Hq, Hkv, hd in REFERENCE_SPARSE:
        out.append((Shape(f"reference sparse B={B} W={W} Hq={Hq} "
                          f"Hkv={Hkv} hd={hd}", B, W, Hq, Hkv, hd),
                    every[:2]))
    for label, (B, W, Hq, Hkv, hd, S) in (chip or {}).get("main",
                                                           {}).items():
        ps = chip["main_ps"]
        out.append((Shape(f"chip main {label}", B, W, Hq, Hkv, hd, S=S),
                    every[:2]))
        maxp = -(-S // ps)
        out.append((Shape(f"chip main paged {label}", B, W, Hq, Hkv, hd,
                          S=maxp * ps, ps=ps, P=B * maxp + 1,
                          table=_tables(B, maxp)), every[1:3]))
    for label, (Hkv, G, W, hd, q, pool, S) in (chip or {}).get(
            "split_edge", {}).items():
        B, ps = chip["edge_b"], chip["edge_ps"]
        maxp = -(-S // ps)
        holes = [(1, i) for i in range(4, 8)] + \
            [(B - 1, i) for i in range(maxp // 2, maxp)]
        out.append((Shape(f"chip split edge {label}", B, W, Hkv * G, Hkv,
                          hd, S=S), ((q, q),)))
        out.append((Shape(f"chip split edge paged {label}", B, W, Hkv * G,
                          Hkv, hd, S=maxp * ps, ps=ps, P=B * maxp + 1,
                          table=_tables(B, maxp, holes)), ((q, pool),)))
    for label, (B, W, Hq, Hkv, hd, S) in WIDE.items():
        out.append((Shape(f"wide {label}", B, W, Hq, Hkv, hd, S=S),
                    every[:2]))
    return out


def resident() -> List[Tuple[int, int]]:
    """(sms, blocks per SM) the split plans are evaluated at."""
    return [(SMS, n) for n in PER_SM] + [(8, 1)]


# --------------------------------------------------------------------------
# the launch models
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Launch:
    """One modelled kernel launch: its grid, its threads, the sizes (in
    elements) of the operands it touches, and ``blocks()`` yielding each
    block's (blockIdx, reads, writes): lists of (operand, start, end)
    element ranges."""
    name: str                  # the key into C_LAUNCHES
    kernel: str
    grid: Tuple[int, int, int]
    threads: int
    env: Dict[str, int]
    sizes: Dict[str, int]
    blocks: object = None      # callable(grid) -> iterable
    table: Optional[List[List[int]]] = None
    trash: int = -1


# model launch -> (source, launched name) whose grid it must equal
C_LAUNCHES = {
    "B1 flash": ("verify_attention.cu", "verify_flash_kernel"),
    "B1 cuda-core": ("verify_attention.cu", "verify_attention_kernel"),
    "B1 merge": ("verify_attention.cu", "merge_kernel"),
    "B2 flash": ("paged_attention.cu", "kernel"),
    "B2 cuda-core": ("paged_attention.cu", "paged_attention_kernel"),
    "B2 merge": ("paged_attention.cu", "merge_kernel"),
    "B3 flash": ("paged_attention.cu", "kernel"),
    "B3 cuda-core": ("paged_attention.cu", "paged_attention_kernel"),
    "B3 fold": ("paged_attention.cu", "carry_fold_kernel"),
    "B4 warp": ("tree_partial.cu", "tree_warp_kernel"),
    "B4 tiles": ("tree_partial.cu", "tree_partial_kernel"),
    "B5 flash": ("tree_partial.cu", "tree_norm_flash_kernel"),
    "B5 f32": ("tree_partial.cu", "kernel"),
    "B5 tiles": ("tree_partial.cu", "tree_partial_kernel"),
}


def _rows(s, r0, nr):
    """(g, w) of the block's query rows r0 .. r0 + nr - 1 (r = g*W + w)."""
    return [divmod(r, s.W) for r in range(r0, r0 + nr)]


def _row_blocks(s, rows, x, y):
    """(b, h, r0, nr) of block (x, y): kv head h of batch row b, its
    query rows [y*rows, min(y*rows + rows, G*W))."""
    G = s.Hq // s.Hkv
    b, h = divmod(x, s.Hkv)
    r0 = y * rows
    return b, h, r0, min(rows, G * s.W - r0)


def _q_reads(s, b, h, r0, nr, name="q"):
    G = s.Hq // s.Hkv
    out = []
    for g, w in _rows(s, r0, nr):
        off = ((b * s.W + w) * s.Hq + h * G + g) * s.hd
        out.append((name, off, off + s.hd))
    return out


def _part_writes(s, b, h, r0, nr, part, o="ws_o", m="ws_m", l="ws_l"):
    """The rows of partial ``part`` a block writes: o (parts, B, W, Hq,
    hd), m and l (parts, B, Hq, W); the ``o`` row's index is its record."""
    G = s.Hq // s.Hkv
    n_o, n_m = s.B * s.W * s.Hq * s.hd, s.B * s.Hq * s.W
    out = []
    for g, w in _rows(s, r0, nr):
        hq = h * G + g
        oo = part * n_o + ((b * s.W + w) * s.Hq + hq) * s.hd
        mi = part * n_m + (b * s.Hq + hq) * s.W + w
        out += [(o, oo, oo + s.hd), (m, mi, mi + 1), (l, mi, mi + 1)]
    return out


def _slot_reads(s, b, h, jb, je):
    """A walk's reads of slots [jb, je): key positions, K/V (dense) or the
    table, the pool pages and their scales (paged)."""
    if jb >= je:
        return []
    if not s.paged:
        first = ((b * s.S + jb) * s.Hkv + h) * s.hd
        last = ((b * s.S + je - 1) * s.Hkv + h) * s.hd + s.hd
        return [("key_pos", b * s.S + jb, b * s.S + je),
                ("k", first, last), ("v", first, last)]
    out = [("key_pos", b * s.maxp * s.ps + jb, b * s.maxp * s.ps + je)]
    flat = [p for row in s.table for p in row]
    for i in range(jb // s.ps, (je - 1) // s.ps + 1):
        idx = b * s.maxp + i
        out.append(("table", idx, idx + 1))
        if not 0 <= idx < len(flat):
            continue
        page = flat[idx]
        if page < 0:
            continue
        lo = max(jb, i * s.ps) % s.ps
        hi = min(je, (i + 1) * s.ps) - i * s.ps
        a = ((page * s.ps + lo) * s.Hkv + h) * s.hd
        z = ((page * s.ps + hi - 1) * s.Hkv + h) * s.hd + s.hd
        out += [("pool_k", a, z), ("pool_v", a, z),
                ("page", idx, page),
                ("scale_k", page * s.Hkv + h, page * s.Hkv + h + 1),
                ("scale_v", page * s.Hkv + h, page * s.Hkv + h + 1)]
    return out


def _tree_reads(s, b, h):
    a = (b * s.W * s.Hkv + h) * s.hd
    z = ((b * s.W + s.W - 1) * s.Hkv + h) * s.hd + s.hd
    return [("k_new", a, z), ("v_new", a, z), ("tree_mask", 0, s.W * s.W)]


def _operand_sizes(s, parts, cache=True):
    n_o, n_m = s.B * s.W * s.Hq * s.hd, s.B * s.Hq * s.W
    sizes = {"q": n_o, "out": n_o, "k_new": s.B * s.W * s.Hkv * s.hd,
             "v_new": s.B * s.W * s.Hkv * s.hd, "tree_mask": s.W * s.W,
             "q_pos": s.B * s.W, "lo": s.B * s.W,
             "ws_o": parts * n_o, "ws_m": parts * n_m, "ws_l": parts * n_m,
             "o": n_o, "m": n_m, "l": n_m}
    if cache and s.paged:
        sizes.update(key_pos=s.B * s.maxp * s.ps, table=s.B * s.maxp,
                     pool_k=s.P * s.ps * s.Hkv * s.hd,
                     pool_v=s.P * s.ps * s.Hkv * s.hd,
                     scale_k=s.P * s.Hkv, scale_v=s.P * s.Hkv)
    elif cache:
        sizes.update(key_pos=s.B * s.S, k=s.B * s.S * s.Hkv * s.hd,
                     v=s.B * s.S * s.Hkv * s.hd)
    return sizes


def _split_walk(s, name, kernel, threads, rows, n_split, split_len, parts,
                tree):
    """B1/B2 (``tree``) and B3: grid (B*Hkv, row tiles, parts).  With the
    tree a part of its own (``parts > n_split``), block z == 0 walks the
    tree and z >= 1 split z - 1; else block z walks split z and the last
    split's block also walks the tree (``flash_common.cuh::split_block``;
    the CUDA-core kernels put the tree at z == 0 always).  Part z goes to
    the workspace, or with one cache-only split to the caller's (o, m, l)
    (``paged_attention.cu``: ``direct``)."""
    dest = ("o", "m", "l") if not tree and n_split == 1 else \
        ("ws_o", "ws_m", "ws_l")
    GW = s.Hq // s.Hkv * s.W
    Sl = s.maxp * s.ps if s.paged else s.S
    grid = (s.B * s.Hkv, -(-GW // rows), parts)

    def blocks(g):
        for x in range(g[0]):
            for y in range(g[1]):
                for z in range(g[2]):
                    b, h, r0, nr = _row_blocks(s, rows, x, y)
                    reads = _q_reads(s, b, h, r0, max(nr, 0))
                    reads += [("q_pos", b * s.W, b * s.W + s.W),
                              ("lo", b * s.W, b * s.W + s.W)]
                    apart = parts > n_split
                    split = z - 1 if (apart and tree) else z
                    if split >= 0:
                        jb = split * split_len
                        je = min(Sl, jb + split_len)
                        reads.append(("split", jb, je))
                        reads += _slot_reads(s, b, h, jb, je)
                    if tree and (split < 0 or
                                 (not apart and split == n_split - 1)):
                        reads += _tree_reads(s, b, h)
                    writes = _part_writes(s, b, h, r0, max(nr, 0), z,
                                          *dest)
                    yield (x, y, z), (r0, nr), reads, writes

    return Launch(name, kernel, grid, threads,
                  dict(B=s.B, W=s.W, Hq=s.Hq, Hkv=s.Hkv, hd=s.hd, S=Sl,
                       GW=GW, rows=rows, parts=parts, nsplit=n_split,
                       maxp=s.maxp, ps=s.ps),
                  _operand_sizes(s, parts), blocks, table=s.table,
                  trash=s.P - 1 if s.paged else -1)


def _merge(s, name, kernel, parts, fold):
    """The Eq.-1 merge (``out``) or the carry fold (``o``, ``m``, ``l``)
    of ``parts`` partials: a thread per 4 columns of one (b, w, head)."""
    total = s.B * s.W * s.Hq * (s.hd // 4)
    grid = (-(-total // 128), 1, 1)

    def blocks(g):
        per_row = s.hd // 4
        n_o, n_m = s.B * s.W * s.Hq * s.hd, s.B * s.Hq * s.W
        for x in range(g[0]):
            lo, hi = x * 128, min((x + 1) * 128, total)
            if lo >= hi:
                yield (x, 0, 0), (0, 0), [], []
                continue
            rows = range(lo // per_row, (hi - 1) // per_row + 1)
            reads, writes = [], []
            for row in rows:
                a = max(lo, row * per_row) - row * per_row
                z = min(hi, (row + 1) * per_row) - row * per_row
                hq, w, b = row % s.Hq, (row // s.Hq) % s.W, \
                    row // (s.W * s.Hq)
                mi = (b * s.Hq + hq) * s.W + w
                for p in range(parts):
                    reads += [("ws_o", p * n_o + row * s.hd + 4 * a,
                               p * n_o + row * s.hd + 4 * z),
                              ("ws_m", p * n_m + mi, p * n_m + mi + 1),
                              ("ws_l", p * n_m + mi, p * n_m + mi + 1)]
                if fold:
                    writes.append(("o", row * s.hd + 4 * a,
                                   row * s.hd + 4 * z))
                    if a == 0:
                        writes += [("m", mi, mi + 1), ("l", mi, mi + 1)]
                else:
                    writes.append(("out", row * s.hd + 4 * a,
                                   row * s.hd + 4 * z))
            yield (x, 0, 0), (0, 0), reads, writes

    return Launch(name, kernel, grid, 128,
                  dict(B=s.B, W=s.W, Hq=s.Hq, Hkv=s.Hkv, hd=s.hd,
                       parts=parts), _operand_sizes(s, parts, cache=False),
                  blocks)


def _tree_kernel(s, name, kernel, threads, rows, norm):
    """B4 and B5: grid (B*Hkv, ceil(G*W / rows)), every block its rows
    against the W tree KVs; the partial (o, m, l) or the normalized
    output."""
    GW = s.Hq // s.Hkv * s.W
    grid = (s.B * s.Hkv, -(-GW // rows), 1)

    def blocks(g):
        for x in range(g[0]):
            for y in range(g[1]):
                b, h, r0, nr = _row_blocks(s, rows, x, y)
                reads = _q_reads(s, b, h, r0, max(nr, 0)) + \
                    _tree_reads(s, b, h)
                if norm:
                    writes = [("out", a, z) for _, a, z in
                              _q_reads(s, b, h, r0, max(nr, 0))]
                else:
                    writes = _part_writes(s, b, h, r0, max(nr, 0), 0,
                                          "o", "m", "l")
                yield (x, y, 0), (r0, nr), reads, writes

    return Launch(name, kernel, grid, threads,
                  dict(B=s.B, W=s.W, Hq=s.Hq, Hkv=s.Hkv, hd=s.hd, GW=GW,
                       rows=rows), _operand_sizes(s, 1, cache=False),
                  blocks)


def launches(s: Shape, q: str, pool: str, sms: int, per_sm: int
             ) -> List[Launch]:
    """The launches of every kernel at one shape, dtype pair and card."""
    fc = MODEL_CONSTANTS["flash_common.cuh"]
    ac = MODEL_CONSTANTS["attention_common.cuh"]
    tc = MODEL_CONSTANTS["tree_partial.cu"]
    out: List[Launch] = []
    GW = s.Hq // s.Hkv * s.W

    def walk(b, flash, tree):
        """A split walk (B1, B2; B3 without the tree) on its plan."""
        _, rows, n, ln, parts = split_plan(
            attn_smem_bytes, _flash_fits, _blocks_per_sm(per_sm), sms,
            flash, s.B, s.W, s.Hq, s.Hkv, s.hd,
            s.maxp * s.ps if s.paged else s.S, page=s.ps if s.paged else 1,
            tree=tree)
        name = f"{b} {'flash' if flash else 'cuda-core'}"
        out.append(_split_walk(
            s, name, C_LAUNCHES[name][1],
            fc["kThreads"] if flash else ac["kThreads"], rows, n, ln, parts,
            tree))
        return n, parts

    def tiles():
        return pick_tiles(attn_smem_bytes, GW, s.W, s.hd)[1]

    if s.S and not s.paged:                                   # B1
        _, parts = walk("B1", flash_route(q, q, s.hd), True)
        out.append(_merge(s, "B1 merge", "merge_kernel", parts, False))
    if s.paged:                                               # B2, B3
        flash = flash_route(q, pool, s.hd, pool == "int8")
        _, parts = walk("B2", flash, True)
        out.append(_merge(s, "B2 merge", "merge_kernel", parts, False))
        n, parts = walk("B3", flash, False)
        if n > 1:
            out.append(_merge(s, "B3 fold", "carry_fold_kernel", parts,
                              True))
    if not s.paged:                                           # B4, B5
        if partial_route(s.W, s.hd) == 1:
            out.append(_tree_kernel(s, "B4 warp", "tree_warp_kernel",
                                    tc["kWarpThreads"], tc["kWarpRows"],
                                    False))
        else:
            out.append(_tree_kernel(s, "B4 tiles", "tree_partial_kernel",
                                    ac["kThreads"], tiles(), False))
        route = norm_route(q, s.W, s.hd)
        if route == 1:
            out.append(_tree_kernel(s, "B5 flash", "tree_norm_flash_kernel",
                                    fc["kThreads"],
                                    norm_rows(1, s.B, s.Hkv, GW), True))
        elif route == 2:
            out.append(_tree_kernel(s, "B5 f32", "tree_norm_f32_kernel",
                                    tc["kF32Threads"],
                                    norm_rows(2, s.B, s.Hkv, GW), True))
        else:
            out.append(_tree_kernel(s, "B5 tiles", "tree_partial_kernel",
                                    ac["kThreads"], tiles(), True))
    return out


# --------------------------------------------------------------------------
# the checks
# --------------------------------------------------------------------------
def _c_grid(launch: Launch, c_launches: List[CLaunch]
            ) -> Tuple[Optional[Tuple[int, int, int]], List[str]]:
    """The grid the C source launches ``launch``'s kernel with, evaluated
    at the launch's values; its thread count must be the model's."""
    src, kernel = C_LAUNCHES[launch.name]
    grids = set()
    errs = []
    for c in c_launches:
        if c.file != src or c.kernel != kernel:
            continue
        try:
            g = tuple(_eval(e, dict(launch.env)) for e in c.grid)
            t = _eval(c.threads, dict(launch.env))
        except Exception as e:                     # noqa: BLE001
            errs.append(f"{src}:{c.line} the launch of `{kernel}` uses a "
                        f"name the launch-bounds model does not model "
                        f"({e}) — extend repro_torch/analysis/"
                        f"launchbounds.py")
            continue
        if t != launch.threads:
            errs.append(f"{src}:{c.line} `{kernel}` launches {t} threads a "
                        f"block, the model {launch.threads}")
        grids.add(g + (1,) * (3 - len(g)))
    if not grids and not errs:
        errs.append(f"{src}: no launch of `{kernel}` found for the model's "
                    f"`{launch.name}`")
    if len(grids) > 1:
        errs.append(f"{src}: the launches of `{kernel}` disagree on the "
                    f"grid: {sorted(grids)}")
    return (next(iter(grids)) if len(grids) == 1 else None), errs


def check_launch(launch: Launch, c_launches: List[CLaunch],
                 desc: str) -> List[str]:
    """Every violation of one modelled launch: its grid against the C
    source's, block starts and accesses in bounds, outputs tiled once,
    the page walk in its row's pages."""
    errs: List[str] = []
    tag = f"`{launch.name}` [{desc}]"
    grid = launch.grid
    cg, cerrs = _c_grid(launch, c_launches)
    errs += [f"{tag}: {e}" for e in cerrs]
    if cg is not None and cg != grid:
        errs.append(f"{tag}: the C source launches grid {cg}, the model "
                    f"{grid}")
        grid = cg
    if any(g < 1 for g in grid) or launch.threads < 1:
        return errs + [f"{tag}: empty launch grid {grid} x "
                       f"{launch.threads}"]
    written: Dict[str, list] = {}
    maxp = len(launch.table[0]) if launch.table else 0
    for idx, (r0, nr), reads, writes in launch.blocks(grid):
        if launch.name.split()[-1] not in ("merge", "fold") and nr < 1:
            errs.append(f"{tag}: block {idx} starts at query row {r0}, "
                        f"past the {launch.env.get('GW')} rows")
            break
        for op, a, z in reads:
            if op == "split":
                if a >= z:
                    errs.append(f"{tag}: block {idx} walks an empty slot "
                                f"range [{a}, {z}) of S="
                                f"{launch.env.get('S')}")
                continue
            if op == "page":
                b = idx[0] // launch.env["Hkv"]
                own = launch.table[b] if 0 <= b < len(launch.table) else []
                if not b * maxp <= a < (b + 1) * maxp:
                    errs.append(f"{tag}: block {idx} reads table entry "
                                f"{a}, outside row {b}'s entries")
                elif z not in own and z != launch.trash:
                    errs.append(f"{tag}: block {idx} addresses page {z}, "
                                f"neither reserved in row {b} nor the "
                                f"trash page")
                continue
            size = launch.sizes.get(op)
            if size is None or a < 0 or z > size or a >= z:
                errs.append(f"{tag}: block {idx} reads {op}[{a}:{z}] "
                            f"outside its {size} elements")
        for op, a, z in writes:
            size = launch.sizes.get(op)
            if size is None or a < 0 or z > size or a >= z:
                errs.append(f"{tag}: block {idx} writes {op}[{a}:{z}] "
                            f"outside its {size} elements")
                continue
            written.setdefault(op, []).append((a, z, idx))
        if len(errs) > 20:
            break
    errs += _coverage(launch, written, tag)
    return errs


def _coverage(launch: Launch, written, tag) -> List[str]:
    """The writes of each output tile it exactly once: sorted, the
    written ranges of an output run from 0 to its end with no gap and no
    overlap (a double write)."""
    e = launch.env
    n_o, n_m = e["B"] * e["W"] * e["Hq"] * e["hd"], e["B"] * e["Hq"] * e["W"]
    kind = launch.name.split()[-1]
    if kind == "merge" or launch.name.startswith("B5"):
        want = {"out": n_o}
    elif kind == "fold" or "o" in written:
        want = {"o": n_o, "m": n_m, "l": n_m}
    else:
        k = e.get("parts", 1)
        want = {"ws_o": k * n_o, "ws_m": k * n_m, "ws_l": k * n_m}
    errs = []
    for op, size in want.items():
        end = 0
        for a, z, idx in sorted(written.get(op, [])):
            if a < end:
                errs.append(f"{tag}: {op}[{a}:{min(z, end)}] is written "
                            f"twice (block {idx} again)")
                break
            if a > end:
                errs.append(f"{tag}: {op}[{end}:{a}] is never written")
                break
            end = z
        else:
            if end != size:
                errs.append(f"{tag}: {op}[{end}:{size}] is never written")
    return errs


def verify(shape_list=None, csrc: Path = CSRC, kernels: Path = KERNELS_DIR,
           cards=None) -> List[str]:
    """Every violation over the configuration matrix, the constants check
    included: empty when every proof holds."""
    errs = check_constants(csrc, kernels)
    c_launches = read_launches(csrc)
    for s, dtypes in (shape_list or shapes()):
        for q, pool in dtypes:
            for sms, per_sm in (cards or resident()):
                desc = f"{s.desc} q={q} pool={pool} sms={sms}x{per_sm}"
                for launch in launches(s, q, pool, sms, per_sm):
                    errs += check_launch(launch, c_launches, desc)
    return errs


def launch_names(shape_list=None) -> Iterable[str]:
    """The model launches the matrix exercises (every one of C_LAUNCHES
    must be)."""
    seen = set()
    for s, dtypes in (shape_list or shapes()):
        for q, pool in dtypes:
            for sms, per_sm in resident():
                for launch in launches(s, q, pool, sms, per_sm):
                    seen.add(launch.name)
    return seen
