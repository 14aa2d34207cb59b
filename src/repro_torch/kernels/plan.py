"""The launch plans of B1-B5 from shapes alone: the key tile and the
query-row tile that fit a block's shared memory (``pick_tiles``), the
split over the cache of the split walks (``pick_split``, ``split_plan``),
and each kernel's route (``flash_route``, ``partial_route``,
``norm_route``, ``norm_rows``).

Standard library only: the wrappers (``launch.py``, ``tree_partial.py``)
plan their launches with these functions, and the launch-bounds model
(``analysis/launchbounds.py``), which imports no torch, evaluates the same
plans over its configurations.  A dtype is a ``torch.dtype`` or its name
(``"bfloat16"``).  The C sources state the same rules; their launch
constants are held to these by ``launchbounds.check_constants``.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

SMEM_LIMIT = 232_448          # dynamic shared memory a block may use (H100)
TILES = (64, 32, 16)          # keys per tile, largest first
# the tensor-core walk of csrc/flash_common.cuh: keys per tile (kTile),
# query rows per block (kRows: 4 warps of 16), head_dim its register
# tiles hold (kHdMax)
FLASH_TILE = 64
FLASH_ROWS = 64
FLASH_HD_MAX = 128

# B4's routes (the codes of csrc/tree_partial.cu::partial_route)
PARTIAL_TILES, PARTIAL_WARP = 0, 1
WARP_KEYS = 64              # the warp route's keys a row, in one pass
WARP_ROWS = 8               # query rows a block of it (two a warp)

# B5's routes (the codes of csrc/tree_partial.cu::norm_route)
ROUTE_TILES, ROUTE_FLASH, ROUTE_F32 = 0, 1, 2
F32_KEYS = 64               # the fp32 route's one key tile
# query rows a block, largest first, per route
NORM_ROWS = {ROUTE_FLASH: (64, 32, 16), ROUTE_F32: (32, 16)}
# blocks a grid should reach: about one per SM of an H100 SXM (132)
NORM_MIN_BLOCKS = 128

_NAMES: Dict[object, str] = {}


def dtype_name(dtype) -> str:
    """``"bfloat16"`` for ``torch.bfloat16`` or ``"bfloat16"``."""
    name = _NAMES.get(dtype)
    if name is None:
        name = _NAMES[dtype] = str(dtype).rsplit(".", 1)[-1]
    return name


def _max_rows(smem_bytes, W, hd, tile, GW):
    """Most query rows (at most GW) whose block fits at ``tile`` keys; 0 if
    not even one does.  ``smem_bytes`` grows with the row count."""
    lo, hi = 0, GW
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if smem_bytes(mid, W, hd, tile) <= SMEM_LIMIT:
            lo = mid
        else:
            hi = mid - 1
    return lo


# (id of the library's smem_bytes, GW, W, hd) -> (smem_bytes, tile, rows):
# the choice depends on shapes alone, and a call should not redo the
# search; the entry keeps smem_bytes alive, so its id is never reused
_PICKED: Dict[tuple, Tuple[object, int, int]] = {}


def pick_tiles(smem_bytes, GW, W, hd):
    """``(key tile, rows per block)`` for G*W = ``GW`` query rows:
    ``smem_bytes(rows, W, hd, tile)`` is the kernel library's own count.

    The largest key tile at which all GW rows fit one block (the main
    path's verify and decode: one row tile, as before row tiles existed);
    else the largest key tile and the most rows a block of it holds, spread
    evenly over the row tiles (a W=256 prefill piece: 4 tiles of 64)."""
    key = (id(smem_bytes), GW, W, hd)
    if key not in _PICKED:
        _PICKED[key] = (smem_bytes,) + _pick(smem_bytes, GW, W, hd)
    return _PICKED[key][1:]


def _pick(smem_bytes, GW, W, hd):
    for tile in TILES:
        if smem_bytes(GW, W, hd, tile) <= SMEM_LIMIT:
            return tile, GW
    for tile in TILES:
        rows = _max_rows(smem_bytes, W, hd, tile, GW)
        if rows:
            n = -(-GW // rows)
            return tile, -(-GW // n)
    raise ValueError(f"a W={W} tree at head_dim {hd} does not fit one "
                     f"block's shared memory")


def flash_route(q_dtype, pool_dtype, hd, scaled=False) -> bool:
    """Whether a split walk (B1, B2, B3) runs on the tensor cores: bf16
    queries over bf16 keys without scales (or an int8 pool, dequantized to
    bf16 on the way), head_dim within the register tiles.  Otherwise its
    products run on the CUDA cores in fp32 in the same split grid.  The C
    sources (``use_flash``) state the same rule."""
    pool = dtype_name(pool_dtype)
    return (dtype_name(q_dtype) == "bfloat16" and hd <= FLASH_HD_MAX
            and (pool == "int8" or (pool == "bfloat16" and not scaled)))


@functools.lru_cache(maxsize=None)
def pick_split(S: int, blocks: int, tile: int, resident: int,
               page: int = 1, extra: int = 0) -> Tuple[int, int]:
    """``(n_split, split_len)`` of a walk over ``S`` slots whose grid has
    ``blocks`` blocks per split (B*Hkv*row tiles) and ``extra`` blocks
    besides (the tree's, where it is a part of its own): from the shapes
    alone, no read of the data.

    A split holds a whole number of chunks of ``lcm(tile, page)`` slots
    (whole key tiles, and whole pages of a paged pool); the last one may
    end at the ragged edge S.  As many splits as the card holds resident
    at once (``resident`` blocks: every block starts at once and pays its
    fixed cost, its first copies' latency and its partial's store, only
    once per SM slot; ``chip_smoke.py`` phase 5 times this fill against
    two), never more than there are chunks, at least one; so
    ``n_split = 1`` when S fits one chunk.  The chunks are spread evenly,
    and no split is empty."""
    gran = tile * page // math.gcd(tile, page)
    chunks = -(-S // gran)
    n = max(1, min(chunks, (resident - extra) // max(blocks, 1)))
    per = -(-chunks // n)
    n = -(-chunks // per)
    return n, per * gran


# (ids of the library's functions, sms, flash, shapes) -> (the functions,
# split_plan's answer): from shapes alone, so a call does not redo it; the
# entry keeps the functions alive, so no id is reused
_PLANS: Dict[tuple, Tuple[object, Tuple[int, int, int, int, int]]] = {}


def split_plan(smem_bytes, flash_smem_bytes, flash_blocks_per_sm, sms, flash,
               B, W, Hq, Hkv, hd, S, page=1, tree=True):
    """``(tile, rows, n_split, split_len, parts)`` of a split walk (B1,
    B2; B3 with ``tree=False``).  The tensor-core path takes
    ``FLASH_TILE`` keys and ``FLASH_ROWS`` rows a block
    (``flash_smem_bytes(hd)`` must fit); the CUDA-core path takes
    ``pick_tiles``' choice.  ``parts`` partials: one per split, and for a
    walk with a tree one more unless the tensor-core path walks a tree of
    at most one key tile in the last split's block
    (``flash_common.cuh::split_block``); the cache-only walk has no tree
    part, so ``parts == n_split`` at every W.

    The card holds ``flash_blocks_per_sm(hd)`` blocks (the library's
    occupancy query of its tensor-core walk) on each of its ``sms`` SMs at
    once.  The CUDA-core walk, which only fp32 queries or head_dim above
    128 take, counts the same slots at head_dim 128: its split count sets
    how many blocks run, never what they compute."""
    key = (id(smem_bytes), id(flash_smem_bytes), id(flash_blocks_per_sm),
           sms, flash, B, W, Hq, Hkv, hd, S, page, tree)
    hit = _PLANS.get(key)
    if hit is None:
        GW = Hq // Hkv * W
        if flash:
            if flash_smem_bytes(hd) > SMEM_LIMIT:
                raise ValueError(f"head_dim {hd} does not fit one block's "
                                 f"shared memory")
            tile, rows = FLASH_TILE, FLASH_ROWS
        else:
            tile, rows = pick_tiles(smem_bytes, GW, W, hd)
        per_sm = flash_blocks_per_sm(min(hd, FLASH_HD_MAX))
        if per_sm < 1:
            raise RuntimeError(f"the occupancy query of the split walk "
                               f"failed at head_dim {hd} ({per_sm})")
        blocks = B * Hkv * -(-GW // rows)
        # the tree: a part of its own
        apart = tree and (not flash or W > FLASH_TILE)
        n_split, split_len = pick_split(S, blocks, tile, per_sm * sms, page,
                                        extra=blocks if apart else 0)
        parts = n_split + apart
        hit = _PLANS[key] = ((smem_bytes, flash_smem_bytes,
                              flash_blocks_per_sm),
                             (tile, rows, n_split, split_len, parts))
    return hit[1]


def partial_route(W, hd) -> int:
    """B4's route: ``tree_warp_kernel`` with all W keys in one pass for
    W <= 64 and head_dim <= 128 (fp32 or bf16), else
    ``tree_partial_kernel``."""
    return PARTIAL_WARP if W <= WARP_KEYS and hd <= FLASH_HD_MAX \
        else PARTIAL_TILES


def norm_route(dtype, W, hd) -> int:
    """B5's route: the tensor cores for bf16 at head_dim <= 128, the
    one-pass fp32 kernel for fp32 with all W keys in one tile and head_dim
    <= 128, else B4's kernel with the normalized epilogue."""
    name = dtype_name(dtype)
    if name == "bfloat16" and hd <= FLASH_HD_MAX:
        return ROUTE_FLASH
    if name == "float32" and W <= F32_KEYS and hd <= FLASH_HD_MAX:
        return ROUTE_F32
    return ROUTE_TILES


def norm_rows(route, B, Hkv, GW) -> int:
    """Query rows a block of B5's route: the largest of ``NORM_ROWS`` whose
    grid of ``B * Hkv * ceil(GW / rows)`` blocks still reaches
    ``NORM_MIN_BLOCKS``, else the smallest (Fig. 10b, B*Hkv = 8 and
    G*W = 256: 16 rows, 128 blocks).  A smaller tile costs more blocks
    each reading the kv head's W keys again (from L2); a larger one leaves
    SMs idle."""
    choices = NORM_ROWS[route]
    for rows in choices:
        if B * Hkv * -(-GW // rows) >= NORM_MIN_BLOCKS:
            return rows
    return choices[-1]
