"""BMN's boundary-matching layer, relu(Conv3d(mid @ mask)), as a gather over the mask's nonzeros.

``boundary_matching(mid, weight, bias, lists)`` takes the features mid [B, C, T] (float32), the (N, 1, 1)
Conv3d's weight viewed as [C3, C, N] and its bias [C3], and the mask's lists (``boundary_matching_lists``),
and returns [B, C3, D, T]: what the JAX package computes at clip_fsar_tpu/models/heads/bmn.py:94-103, the
product of mid with the dense sample mask [T, N*D*T], viewed as [B, C, N, D, T], through the Conv3d of stride
(N, 1, 1) and a ReLU.  Both steps are linear, so the op groups them the other way round:

    P[n, t', b, o] = sum_c W[o, c, n] * mid[b, c, t']            (torch.matmul)
    y[b, o, d, t]  = relu(bias[o] + sum_n sum_t' mask[t', n, d, t] * P[n, t', b, o])

P is laid out as rows [N*T, B*C3], a row's channels side by side.  The second step is the gather
``bm_gather_fwd`` (``csrc/boundary_matching.cu``: tiles of cells over the union of their rows staged in shared
memory, cells in pairs; the lists' forward tile form, ``fwd_tile_lists``) on a CUDA tensor and
``gather_fwd_reference`` (over the column form) on a CPU tensor.  Its backward forms dP by walking each (n, t') row's entries in
ascending order under the ReLU's mask (``bm_gather_bwd``, which first lays the masked gradient out as
[D*T, B*C3], then walks tiles of rows over the union of their cells staged in shared memory;
``gather_bwd_reference``) and takes dW and dmid from two matrix products and dbias from a sum:
no atomics, so a train step through the layer repeats bit
for bit, and no [B, C, N, D, T] activation (10.5 GB at the EPIC preset's 8 windows) is ever formed.
The kernels and the plain versions add in the same order, rounding each product and each sum, so they
give the same fp32 bits.  There is no fallback from the kernel to its plain version.

The lists are built once per mask key on the host from ``models.heads.bmn.boundary_matching_mask`` itself
(its float32 nonzeros: the JAX mask's bits); the tile forms the kernels read are moved once to each device that asks
for them, and the column and row forms, which only the plain versions read, once to each device they run on.  The JAX
package's layer reaches no Pallas kernel: this op replaces no TPU kernel.
"""

from __future__ import annotations

import copy
import functools
import time
from typing import Dict, Optional

import numpy as np
import torch

from clip_fsar_torch.ops import _build

# kernel launches since the last reset (a run shows it went through the kernels)
LAUNCHES = {"bm_gather_fwd": 0, "bm_gather_bwd": 0}
# (T, D, N, per-bin, ratio) -> host seconds the mask and its lists took to build
LISTS_BUILD_SECONDS: Dict[tuple, float] = {}
# the backward's row tiles (csrc/boundary_matching.cu kTileN, kTileT, kChunk, which refuses lists built for others): TILE_N
# samples n by TILE_T positions t' (TILE_T even: rows go in pairs), their union of cells streamed in chunks of TILE_CHUNK
TILE_N, TILE_T, TILE_CHUNK = 4, 16, 32
# the forward's cell tiles (kFwdTileD, kFwdTileT, kChunk, refused likewise): FWD_TILE_D durations d by FWD_TILE_T starts t
# (FWD_TILE_D even: cells go in pairs d, d + 1), their union of rows streamed in chunks of TILE_CHUNK
FWD_TILE_D, FWD_TILE_T = 8, 8


class BMLists:
    """The nonzeros of one sample mask [T', N, D, T] in the orders the gathers and their plain versions walk.

    ``order`` [D*T] int32: the active cells (cell = d * T + t with an entry in some n) ascending, then the rest.
    Column form, over the ``active`` first cells of ``order``: ``col_t`` [N, K, A] int16 and ``col_w`` [N, K, A]
    float32, the entries (t', w) of column (n, order[i]) in ascending t', padded with (0, 0.0) to K, the largest
    count of any column (read from the mask); ``col_n`` [N, A] uint8, the counts.  Row form (CSR over the N*T
    rows n * T + t'): ``row_ptr`` [N*T + 1] int32, ``row_cell`` and ``row_w`` [nnz], each row's entries in
    ascending cell.  Tile form, for the backward kernel (``tile_lists``): ``tile_cell_ptr`` [tiles + 1] and
    ``tile_cells``, each tile's union of cells ascending; ``tile_chunk_ptr`` [tiles + 1], each tile's first chunk of
    TILE_CHUNK union cells among all tiles' chunks; ``ent`` [merged, 4] int32, for each chunk, row pair (the tile's rows
    t' and t' + 1 of one n, t' even) and cell of the chunk that either row holds, ascending: (the cell's index in the
    chunk | 256 if row t' holds it | 512 if row t' + 1 does, the two weights' float32 bits (0 where absent), 0);
    ``chunk_cut`` [chunks * PAIRS + 1], the first merged entry of (chunk, pair): pair p's entries in chunk c are
    ``ent[chunk_cut[c * PAIRS + p]:chunk_cut[c * PAIRS + p + 1]]``, PAIRS = TILE_N * TILE_T / 2.
    ``max_chunk_entries``: the most merged entries of any chunk; ``tile``: the (TILE_N, TILE_T, TILE_CHUNK) the tile form
    was built for, which the kernel holds against its own.  Forward tile form, for the forward kernel
    (``fwd_tile_lists``), the same with cells and rows in each other's places: tiles of FWD_TILE_D durations by
    FWD_TILE_T starts, ``fwd_tile_row_ptr`` / ``fwd_tile_rows`` each tile's union of rows n * T + t' ascending,
    ``fwd_tile_chunk_ptr``, ``fwd_ent`` (the row's index in the chunk | 256 if cell (d even, t) holds it | 512 if cell
    (d + 1, t) does, the two weights' bits, 0) and ``fwd_chunk_cut`` over the tile's cell pairs p = (d % FWD_TILE_D) // 2
    * FWD_TILE_T + t % FWD_TILE_T; ``fwd_max_chunk_entries`` and ``fwd_tile`` as above.

    ``device`` is where the tile forms, the ones the kernels read (KERNEL_TENSORS), lie.  The column and row forms
    stay on the host whatever ``device`` is; ``columns(device)`` and ``rows(device)`` give them on a device."""

    KERNEL_TENSORS = ("fwd_tile_row_ptr", "fwd_tile_rows", "fwd_tile_chunk_ptr", "fwd_chunk_cut", "fwd_ent",
                      "tile_cell_ptr", "tile_cells", "tile_chunk_ptr", "chunk_cut", "ent")
    COLUMN_TENSORS = ("order", "col_t", "col_w", "col_n")
    ROW_TENSORS = ("row_ptr", "row_cell", "row_w")

    def __init__(self, shape: tuple, active: int, max_per_row: int, tensors: Dict[str, torch.Tensor], tile: tuple, fwd_tile: tuple):
        self.tscale, self.num_sample, self.dscale = shape  # T, N, D
        self.active, self.max_per_row, self.tile, self.fwd_tile = active, max_per_row, tuple(tile), tuple(fwd_tile)
        for name in self.KERNEL_TENSORS + self.COLUMN_TENSORS + self.ROW_TENSORS:
            setattr(self, name, tensors[name])
        self.max_per_column = int(self.col_t.shape[1])
        self.nnz = int(self.row_w.numel())
        self.max_chunk_entries = _max_chunk_entries(self.chunk_cut, self.tile)
        self.fwd_max_chunk_entries = _max_chunk_entries(self.fwd_chunk_cut, self.fwd_tile)
        self._on: Dict[torch.device, "BMLists"] = {}
        self._plain_on: Dict[tuple, tuple] = {}  # (form, device) -> the column or row form on a device that asked for it

    @property
    def device(self) -> torch.device:
        return self.ent.device

    @property
    def cells(self) -> int:
        return self.dscale * self.tscale

    def to(self, device) -> "BMLists":
        """These lists on ``device``, copied there once and kept."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device == self.device:
            return self
        if device not in self._on:
            moved = copy.copy(self)  # the counts, the row form and its copies on other devices shared
            for name in self.KERNEL_TENSORS:
                setattr(moved, name, getattr(self, name).to(device))
            moved._on = {}
            self._on[device] = moved
        return self._on[device]

    def _plain(self, form: tuple, device) -> tuple:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        host = tuple(getattr(self, name) for name in form)
        if device == host[0].device:
            return host
        if (form, device) not in self._plain_on:
            self._plain_on[form, device] = tuple(t.to(device) for t in host)
        return self._plain_on[form, device]

    def columns(self, device) -> tuple:
        """The column form (order, col_t, col_w, col_n) on ``device``, copied there once and kept."""
        return self._plain(self.COLUMN_TENSORS, device)

    def rows(self, device) -> tuple:
        """The row form (row_ptr, row_cell, row_w) on ``device``, copied there once and kept."""
        return self._plain(self.ROW_TENSORS, device)


def _max_chunk_entries(chunk_cut: torch.Tensor, tile: tuple) -> int:
    """The most merged entries of any chunk of a tile form whose tiles hold tile[0] * tile[1] outputs in pairs."""
    pairs = tile[0] * tile[1] // 2
    return int((chunk_cut[pairs::pairs] - chunk_cut[:-1:pairs]).max()) if chunk_cut.numel() > 1 else 0


def _merged_tiles(tile: np.ndarray, pair: np.ndarray, odd: np.ndarray, item: np.ndarray, w: np.ndarray, tiles: int, pairs: int,
                  items: int, chunk_size: int) -> tuple:
    """A tile form of nonzeros: nonzero i adds ``item[i]`` (of ``items``) with weight w[i] to output ``odd[i]`` of pair
    ``pair[i]`` of tile ``tile[i]``.  Returns each tile's union of items ascending (ptr [tiles + 1], union), each tile's
    first chunk of ``chunk_size`` union items (chunk_ptr [tiles + 1]), the merged entries [merged, 4] int32, one for each
    (chunk, pair, item) in ascending order: (the item's index in the chunk | 256 if output 0 of the pair holds it | 512 if
    output 1 does, the two weights' float32 bits (0 where absent), 0), and the cuts [chunks * pairs + 1], the first
    merged entry of each (chunk, pair)."""
    union, u = np.unique(tile * items + item, return_inverse=True)  # every tile's items, ascending within the tile
    ptr = np.searchsorted(union // items, np.arange(tiles + 1))
    u = u.reshape(-1) - ptr[tile]
    chunk_ptr = np.concatenate([[0], np.cumsum(-(-np.diff(ptr) // chunk_size))])
    chunk = chunk_ptr[tile] + u // chunk_size  # the chunk's index over all tiles
    # one merged entry for each (chunk, pair, item): which of the pair's outputs hold the item, and their weights
    key = (chunk * pairs + pair) * chunk_size + u % chunk_size
    merged, at = np.unique(key, return_inverse=True)
    at = at.reshape(-1)
    ent = np.zeros((len(merged), 4), np.int32)
    ent[:, 0] = merged % chunk_size
    np.bitwise_or.at(ent[:, 0], at, (1 << (8 + odd)).astype(np.int32))
    ent[at, 1 + odd] = w.astype(np.float32).view(np.int32)
    cut = np.searchsorted(merged // chunk_size, np.arange(chunk_ptr[-1] * pairs + 1))
    return ptr.astype(np.int32), (union % items).astype(np.int32), chunk_ptr.astype(np.int32), cut.astype(np.int32), ent


def tile_lists(n: np.ndarray, tp: np.ndarray, cell: np.ndarray, w: np.ndarray, n_n: int, t_n: int, cells: int) -> Dict[str, np.ndarray]:
    """The tile form of the nonzeros (n, t', cell, w) of a mask with N = n_n samples, T = t_n positions and ``cells``
    cells (see ``BMLists``): tile (n // TILE_N) * ceil(T / TILE_T) + t' // TILE_T; its row pair (n % TILE_N) * TILE_T / 2 +
    (t' % TILE_T) // 2, whose rows a and b are the even and the odd t'; chunk k of the tile its union cells
    [k * TILE_CHUNK, (k + 1) * TILE_CHUNK)."""
    tiles_t = -(-t_n // TILE_T)
    tile = ((n // TILE_N) * tiles_t + tp // TILE_T).astype(np.int64)
    pair = ((n % TILE_N) * TILE_T + tp % TILE_T).astype(np.int64) // 2
    parts = _merged_tiles(tile, pair, (tp % 2).astype(np.int64), cell, w, -(-n_n // TILE_N) * tiles_t, TILE_N * TILE_T // 2, cells, TILE_CHUNK)
    return dict(zip(("tile_cell_ptr", "tile_cells", "tile_chunk_ptr", "chunk_cut", "ent"), parts))


def fwd_tile_lists(n: np.ndarray, tp: np.ndarray, d: np.ndarray, t: np.ndarray, w: np.ndarray, n_n: int, t_n: int, d_n: int) -> Dict[str, np.ndarray]:
    """The forward tile form of the nonzeros (n, t', d, t, w) of a mask with N = n_n samples, T = t_n positions and D = d_n
    durations (see ``BMLists``): tile (d // FWD_TILE_D) * ceil(T / FWD_TILE_T) + t // FWD_TILE_T; its cell pair
    (d % FWD_TILE_D) // 2 * FWD_TILE_T + t % FWD_TILE_T, whose cells a and b are the even and the odd d; chunk k of the
    tile its union rows n * T + t' [k * TILE_CHUNK, (k + 1) * TILE_CHUNK)."""
    tiles_t = -(-t_n // FWD_TILE_T)
    tile = ((d // FWD_TILE_D) * tiles_t + t // FWD_TILE_T).astype(np.int64)
    pair = ((d % FWD_TILE_D) // 2 * FWD_TILE_T + t % FWD_TILE_T).astype(np.int64)
    row = n.astype(np.int64) * t_n + tp
    parts = _merged_tiles(tile, pair, (d % 2).astype(np.int64), row, w, -(-d_n // FWD_TILE_D) * tiles_t, FWD_TILE_D * FWD_TILE_T // 2,
                          n_n * t_n, TILE_CHUNK)
    return dict(zip(("fwd_tile_row_ptr", "fwd_tile_rows", "fwd_tile_chunk_ptr", "fwd_chunk_cut", "fwd_ent"), parts))


def lists_from_mask(mask: np.ndarray) -> BMLists:
    """``BMLists`` of a float32 mask [T', N, D, T] (``boundary_matching_mask``): every nonzero once in each form."""
    tp_n, n_n, d_n, t_n = mask.shape
    if tp_n != t_n:
        raise ValueError(f"the mask is [T', N, D, T] with T' = T, got {mask.shape}")
    if t_n > np.iinfo(np.int16).max or d_n * t_n >= 2**31 or n_n * t_n >= 2**31:
        raise ValueError(f"the lists hold t' in int16 and cells in int32, got a mask of {mask.shape}")
    tp, n, d, t = np.nonzero(mask)  # ascending in (t', n, d, t)
    w = mask[tp, n, d, t].astype(np.float32)
    cell = d.astype(np.int64) * t_n + t
    cells = d_n * t_n
    # column form: (n, cell, t') ascending
    by_col = np.lexsort((tp, cell, n))
    col_key = n[by_col] * cells + cell[by_col]
    counts = np.bincount(col_key, minlength=n_n * cells).reshape(n_n, cells)
    k_max = int(counts.max()) if counts.size else 0
    if k_max > np.iinfo(np.uint8).max:
        raise ValueError(f"a column of the mask holds {k_max} entries; the lists count them in uint8")
    is_active = counts.sum(0) > 0
    active_cells = np.flatnonzero(is_active)
    order = np.concatenate([active_cells, np.flatnonzero(~is_active)]).astype(np.int32)
    slot = np.full(cells, -1, np.int64)
    slot[active_cells] = np.arange(len(active_cells))
    a = len(active_cells)
    starts = np.concatenate([[0], np.cumsum(counts.reshape(-1))[:-1]])
    k = np.arange(len(by_col)) - starts[col_key]
    col_t = np.zeros((n_n, k_max, a), np.int16)
    col_w = np.zeros((n_n, k_max, a), np.float32)
    col_t[n[by_col], k, slot[cell[by_col]]] = tp[by_col]
    col_w[n[by_col], k, slot[cell[by_col]]] = w[by_col]
    col_n = counts[:, active_cells].astype(np.uint8)
    # row form: (n, t', cell) ascending
    by_row = np.lexsort((cell, tp, n))
    row_key = n[by_row] * tp_n + tp[by_row]
    row_ptr = np.concatenate([[0], np.cumsum(np.bincount(row_key, minlength=n_n * tp_n))]).astype(np.int32)
    tensors = {"order": order, "col_t": col_t, "col_w": col_w, "col_n": col_n, "row_ptr": row_ptr,
               "row_cell": cell[by_row].astype(np.int32), "row_w": w[by_row], **tile_lists(n, tp, cell, w, n_n, t_n, cells),
               **fwd_tile_lists(n, tp, d, t, w, n_n, t_n, d_n)}
    max_per_row = int(np.diff(row_ptr).max()) if len(row_ptr) > 1 else 0
    return BMLists((t_n, n_n, d_n), a, max_per_row, {name: torch.from_numpy(np.ascontiguousarray(v)) for name, v in tensors.items()},
                   (TILE_N, TILE_T, TILE_CHUNK), (FWD_TILE_D, FWD_TILE_T, TILE_CHUNK))


@functools.lru_cache(maxsize=4)
def boundary_matching_lists(tscale: int, dscale: int, num_sample: int, num_sample_perbin: int, boundary_ratio: float) -> BMLists:
    """The lists of ``boundary_matching_mask(tscale, dscale, num_sample, num_sample_perbin, boundary_ratio)``,
    built once per key on the host (the dense mask is dropped after); the seconds go to LISTS_BUILD_SECONDS."""
    from clip_fsar_torch.models.heads.bmn import boundary_matching_mask

    key = (tscale, dscale, num_sample, num_sample_perbin, boundary_ratio)
    t0 = time.perf_counter()
    lists = lists_from_mask(boundary_matching_mask(*key))
    LISTS_BUILD_SECONDS[key] = time.perf_counter() - t0
    return lists


def project(mid: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """P [N, T, B, C3] = sum_c weight[o, c, n] * mid[b, c, t] as one matrix product: row n * T + t of P holds its B*C3
    channels side by side."""
    c3, c, n = weight.shape
    b, _, t = mid.shape
    return torch.matmul(mid.permute(2, 0, 1).reshape(t * b, c), weight.permute(2, 1, 0)).view(n, t, b, c3)


def gather_fwd_reference(p: torch.Tensor, bias: torch.Tensor, lists: BMLists) -> torch.Tensor:
    """Plain-torch ``bm_gather_fwd``: from P [N, T, B, C3], relu(bias + the sum over n ascending, then each column's t'
    ascending, of w * P) at every cell, as [B, C3, D*T]; the cells of no entry give relu(bias)."""
    n_s, t_s, b, c3 = p.shape
    order, col_t, col_w, _ = lists.columns(p.device)
    rows = p.reshape(n_s, t_s, b * c3)
    acc = torch.zeros(lists.active, b * c3, dtype=p.dtype, device=p.device)
    for n in range(n_s):
        for k in range(lists.max_per_column):
            # padded entries add 0 * P[n, 0] = 0: the same bits as the kernel, which holds no such entry
            acc = acc + col_w[n, k, :, None] * rows[n, col_t[n, k].long()]
    full = torch.zeros(lists.cells, b * c3, dtype=p.dtype, device=p.device)
    full[order[: lists.active].long()] = acc
    return torch.relu(full.t().contiguous().view(b, c3, lists.cells) + bias.view(1, c3, 1))


def gather_bwd_reference(out: torch.Tensor, dout: torch.Tensor, lists: BMLists) -> torch.Tensor:
    """Plain-torch ``bm_gather_bwd``: dP [B, C3, N, T], each row's sum of w * (out > 0 ? dout : 0) over its
    cells ascending."""
    b, c3 = out.shape[:2]
    dy = torch.where(out > 0, dout, torch.zeros((), dtype=dout.dtype, device=dout.device)).reshape(b, c3, -1)
    row_ptr, row_cell, row_w = lists.rows(out.device)
    first, last = row_ptr[:-1].long(), row_ptr[1:].long()
    acc = torch.zeros(b, c3, first.numel(), dtype=out.dtype, device=out.device)
    for k in range(lists.max_per_row):
        e = first + k
        live = e < last
        e = torch.where(live, e, torch.zeros_like(e))
        w = torch.where(live, row_w[e], torch.zeros((), dtype=row_w.dtype, device=out.device))
        acc = acc + w * dy[:, :, row_cell[e].long()]
    return acc.view(b, c3, lists.num_sample, lists.tscale)


def _check_lists(lists: BMLists, device: torch.device) -> None:
    if lists.device != device:
        raise ValueError(f"the mask's lists are on {lists.device}, the tensors on {device}")


def bm_gather_fwd_cuda(p: torch.Tensor, bias: torch.Tensor, lists: BMLists) -> torch.Tensor:
    """Launch ``bm_gather_fwd``: [B, C3, D*T] float32 from P [N, T, B, C3] (``project``'s) and bias [C3], float32,
    contiguous, on one card with the lists.  Raises on any input the kernel does not take."""
    if p.device.type != "cuda" or bias.device != p.device:
        raise ValueError(f"bm_gather_fwd_cuda needs CUDA tensors on one device, got {p.device} and {bias.device}")
    if p.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError(f"bm_gather_fwd takes float32, got {p.dtype} and {bias.dtype}")
    n, t, b, c3 = p.shape
    if (n, t) != (lists.num_sample, lists.tscale) or bias.shape != (c3,) or not (p.is_contiguous() and bias.is_contiguous()):
        raise ValueError(f"bm_gather_fwd needs contiguous P [{lists.num_sample}, {lists.tscale}, B, C3] and bias [C3], got "
                         f"{tuple(p.shape)} and {tuple(bias.shape)}")
    _check_lists(lists, p.device)
    out = torch.empty(b, c3, lists.cells, dtype=torch.float32, device=p.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(p.device):
        code = lib.bm_gather_fwd(p.data_ptr(), lists.fwd_tile_rows.data_ptr(), lists.fwd_tile_row_ptr.data_ptr(),
                                 lists.fwd_tile_chunk_ptr.data_ptr(), lists.fwd_chunk_cut.data_ptr(), lists.fwd_ent.data_ptr(),
                                 bias.data_ptr(), out.data_ptr(), b, c3, n, t, lists.dscale, lists.fwd_max_chunk_entries, *lists.fwd_tile,
                                 torch.cuda.current_stream().cuda_stream)
    _build.check(code, "bm_gather_fwd launch")
    LAUNCHES["bm_gather_fwd"] += 1
    return out


def bm_gather_bwd_cuda(out: torch.Tensor, dout: torch.Tensor, lists: BMLists, scratch: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch ``bm_gather_bwd``: dP [B, C3, N, T] float32 from the forward's output and its gradient, both
    [B, C3, D*T] (or [B, C3, D, T]) float32 and contiguous, on one card with the lists.  ``scratch`` (made here
    when None) receives (out > 0 ? dout : 0) as [D*T, B*C3], which the kernel gathers from.  Raises on any
    input the kernel does not take."""
    if out.device.type != "cuda" or dout.device != out.device:
        raise ValueError(f"bm_gather_bwd_cuda needs CUDA tensors on one device, got {out.device} and {dout.device}")
    if out.dtype != torch.float32 or dout.dtype != torch.float32:
        raise TypeError(f"bm_gather_bwd takes float32, got {out.dtype} and {dout.dtype}")
    b, c3 = out.shape[:2]
    if out.shape != dout.shape or out[0, 0].numel() != lists.cells or not (out.is_contiguous() and dout.is_contiguous()):
        raise ValueError(f"bm_gather_bwd needs contiguous out and dout of one shape [B, C3, {lists.dscale}, {lists.tscale}], got "
                         f"{tuple(out.shape)} and {tuple(dout.shape)}")
    _check_lists(lists, out.device)
    if scratch is None:
        scratch = torch.empty(lists.cells, b * c3, dtype=torch.float32, device=out.device)
    if scratch.shape != (lists.cells, b * c3) or scratch.dtype != torch.float32 or scratch.device != out.device or not scratch.is_contiguous():
        raise ValueError(f"bm_gather_bwd's scratch is a contiguous float32 [{lists.cells}, {b * c3}] on {out.device}, got "
                         f"{scratch.dtype} {tuple(scratch.shape)} on {scratch.device}")
    dp = torch.empty(b, c3, lists.num_sample, lists.tscale, dtype=torch.float32, device=out.device)
    if dp.numel() == 0:
        return dp
    lib = _build.library()
    with torch.cuda.device(out.device):
        code = lib.bm_gather_bwd(out.data_ptr(), dout.data_ptr(), scratch.data_ptr(), lists.tile_cells.data_ptr(), lists.tile_cell_ptr.data_ptr(),
                                 lists.tile_chunk_ptr.data_ptr(), lists.chunk_cut.data_ptr(), lists.ent.data_ptr(), dp.data_ptr(), b, c3,
                                 lists.num_sample, lists.tscale, lists.cells, lists.max_chunk_entries, *lists.tile,
                                 torch.cuda.current_stream().cuda_stream)
    _build.check(code, "bm_gather_bwd launch")
    LAUNCHES["bm_gather_bwd"] += 1
    return dp


class _BoundaryMatching(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mid: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, lists: BMLists) -> torch.Tensor:
        p = project(mid, weight)
        out = gather_fwd_reference(p, bias, lists) if mid.device.type == "cpu" else bm_gather_fwd_cuda(p, bias.contiguous(), lists)
        ctx.lists = lists
        ctx.save_for_backward(mid, weight, out)
        return out.view(mid.shape[0], weight.shape[0], lists.dscale, lists.tscale)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        mid, weight, out = ctx.saved_tensors
        lists = ctx.lists
        dy = dy.reshape(out.shape).contiguous()
        c3, c, n = weight.shape
        b, _, t = mid.shape
        if dy.device.type == "cpu":
            dp = gather_bwd_reference(out, dy, lists)
            dbias = torch.where(out > 0, dy, torch.zeros((), dtype=dy.dtype)).sum((0, 2))
        else:
            scratch = torch.empty(lists.cells, b * c3, dtype=torch.float32, device=dy.device)
            dp = bm_gather_bwd_cuda(out, dy, lists, scratch)
            dbias = scratch.sum(0).view(b, c3).sum(0)  # the kernel's (out > 0 ? dy : 0), transposed
        dmid = dweight = None
        if ctx.needs_input_grad[0]:  # sum over (o, n) of W[o, c, n] * dP[b, o, n, t]
            dmid = torch.matmul(weight.permute(1, 0, 2).reshape(c, c3 * n), dp.view(b, c3 * n, t))
        if ctx.needs_input_grad[1]:  # sum over (b, t) of dP[b, o, n, t] * mid[b, c, t]
            dweight = torch.matmul(dp.permute(1, 2, 0, 3).reshape(c3 * n, b * t), mid.permute(0, 2, 1).reshape(b * t, c))
            dweight = dweight.view(c3, n, c).permute(0, 2, 1)
        return dmid, dweight, dbias if ctx.needs_input_grad[2] else None, None


def boundary_matching(mid: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, lists: BMLists) -> torch.Tensor:
    """relu(Conv3d(mid @ mask)) of BMN as [B, C3, D, T] (see the module docstring): mid [B, C, T], the Conv3d's
    weight viewed as [C3, C, N], its bias [C3], and the mask's lists (moved to mid's device once).  float32 on a
    card; on the CPU the plain versions in any float type."""
    if mid.dim() != 3 or weight.dim() != 3 or mid.shape[1] != weight.shape[1] or mid.shape[2] != lists.tscale or \
            weight.shape[2] != lists.num_sample or bias.shape != (weight.shape[0],):
        raise ValueError(f"boundary_matching needs mid [B, C, {lists.tscale}], weight [C3, C, {lists.num_sample}] and bias [C3], got "
                         f"{tuple(mid.shape)}, {tuple(weight.shape)} and {tuple(bias.shape)}")
    return _BoundaryMatching.apply(mid, weight, bias, lists.to(mid.device))
