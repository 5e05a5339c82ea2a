"""The forward tile form of BMN's boundary-matching lists (clip_fsar_torch/ops/boundary_matching.py ``fwd_tile_lists``),
which the forward kernel ``bm_gather_fwd`` walks, on the CPU.

At the EPIC-Kitchens-100 preset's key (T = D = 200, N = 32) and at the small keys of the op's tests: every nonzero lies
in exactly one (chunk, cell) run of one merged entry, once, and each cell's runs, chunk after chunk, give its column's
entries in ascending (n, t'); each tile's union of rows is ascending and holds exactly its cells' rows.  Then a
plain-torch emulation of the kernel's schedule (tile by tile, the union of rows staged in chunks of TILE_CHUNK rows
with the chunk's merged entries and cuts, as a slot of the kernel's ring holds them, each cell pair's merged entries of
the chunk added in order from the slot to the cells that hold the row, a product and a sum rounded apart, then the bias
and the ReLU) gives ``gather_fwd_reference``'s fp32 bits.
"""

import os
import re

import numpy as np
import pytest
import torch

from clip_fsar_torch.ops import boundary_matching as bm

torch.set_num_threads(2)

# (T, D, N, per-bin, ratio): the EPIC preset, the localization tests' key, D < T, another per-bin count and ratio
KEYS = [(200, 200, 32, 3, 0.5), (32, 32, 8, 3, 0.5), (32, 12, 8, 3, 0.5), (20, 20, 5, 2, 0.25), (24, 10, 6, 3, 0.5)]
IDS = ["epic_T200_N32", "T32_D32_N8", "T32_D12_N8", "T20_D20_N5_bin2", "T24_D10_N6"]
CELLS = bm.FWD_TILE_D * bm.FWD_TILE_T
PAIRS = CELLS // 2


def _tiles(lists):
    """numpy views of the forward tile form: each tile's union of rows, its chunks, the (chunk, pair) cuts, the entries."""
    as64 = lambda t: t.numpy().astype(np.int64)  # noqa: E731
    return (as64(lists.fwd_tile_row_ptr), as64(lists.fwd_tile_rows), as64(lists.fwd_tile_chunk_ptr), as64(lists.fwd_chunk_cut),
            lists.fwd_ent.numpy())


def _tile_cell_of(lists):
    """For each tile and local cell j = (d % FWD_TILE_D) * FWD_TILE_T + t % FWD_TILE_T: the cell d * T + t (-1 where
    the tile runs past D or T)."""
    tiles_t = -(-lists.tscale // bm.FWD_TILE_T)
    tiles = -(-lists.dscale // bm.FWD_TILE_D) * tiles_t
    tile, j = np.meshgrid(np.arange(tiles), np.arange(CELLS), indexing="ij")
    d = (tile // tiles_t) * bm.FWD_TILE_D + j // bm.FWD_TILE_T
    t = (tile % tiles_t) * bm.FWD_TILE_T + j % bm.FWD_TILE_T
    return np.where((d < lists.dscale) & (t < lists.tscale), d * lists.tscale + t, -1)


def _pair_cells(q: np.ndarray, half: np.ndarray) -> np.ndarray:
    """The local cell of output ``half`` (0: d even, 1: d + 1) of cell pair ``q``."""
    return (q // bm.FWD_TILE_T) * 2 * bm.FWD_TILE_T + q % bm.FWD_TILE_T + half * bm.FWD_TILE_T


def _nonzeros(lists):
    """Every nonzero as (cell, row n * T + t', weight), from the row form."""
    rows = np.repeat(np.arange(lists.num_sample * lists.tscale), np.diff(lists.row_ptr.numpy()))
    return lists.row_cell.numpy().astype(np.int64), rows, lists.row_w.numpy()


@pytest.mark.parametrize("key", KEYS, ids=IDS)
def test_fwd_tile_lists_hold_every_nonzero_once_in_column_order(key):
    lists = bm.boundary_matching_lists(*key)
    ptr, union, chunk_ptr, cut, ent = _tiles(lists)
    tiles = len(ptr) - 1
    items = lists.num_sample * lists.tscale
    assert lists.fwd_tile == (bm.FWD_TILE_D, bm.FWD_TILE_T, bm.TILE_CHUNK)
    assert tiles == -(-lists.dscale // bm.FWD_TILE_D) * -(-lists.tscale // bm.FWD_TILE_T)
    assert lists.fwd_ent.shape[1] == 4 and lists.fwd_ent.dtype == torch.int32
    assert ptr[0] == 0 and (np.diff(ptr) >= 0).all() and ptr[-1] == len(union) and ((union >= 0) & (union < items)).all()
    chunks = np.diff(chunk_ptr)
    assert chunk_ptr[0] == 0 and (chunks == -(-np.diff(ptr) // bm.TILE_CHUNK)).all()
    assert len(cut) == chunk_ptr[-1] * PAIRS + 1 and cut[0] == 0 and cut[-1] == len(ent) and (np.diff(cut) >= 0).all()
    assert lists.fwd_max_chunk_entries == np.diff(cut).reshape(-1, PAIRS).sum(1).max()
    local, flags = ent[:, 0] & 255, ent[:, 0] >> 8
    w = ent[:, 1:3].copy().view(np.float32)  # [merged, 2]: cell d even, cell d + 1
    assert ((local >= 0) & (local < bm.TILE_CHUNK)).all() and ((flags >= 1) & (flags <= 3)).all() and (ent[:, 3] == 0).all()
    for half in (0, 1):
        held = (flags >> half & 1) == 1
        assert (w[held, half] != 0).all() and (w[~held, half] == 0).all()

    # each merged entry's place: its (chunk, pair), the chunk's tile, the row it reads through the tile's union
    run = np.searchsorted(cut, np.arange(len(ent)), side="right") - 1  # chunk * PAIRS + pair
    chunk, pair = run // PAIRS, run % PAIRS
    tile = np.searchsorted(chunk_ptr, chunk, side="right") - 1
    at = ptr[tile] + (chunk - chunk_ptr[tile]) * bm.TILE_CHUNK + local
    assert (at < ptr[tile + 1]).all()  # within the tile's union
    cell_of = _tile_cell_of(lists)
    got_e, got_cell, got_row, got_w = [], [], [], []
    for half in (0, 1):
        held = np.flatnonzero((flags >> half & 1) == 1)
        got_e.append(held)
        got_cell.append(cell_of[tile[held], _pair_cells(pair[held], half)])
        got_row.append(union[at[held]])
        got_w.append(w[held, half])
    e, cell, row, wt = (np.concatenate(x) for x in (got_e, got_cell, got_row, got_w))
    assert (cell >= 0).all()  # no entry for a cell past D or T
    # every nonzero once: the (cell, row, weight) triples are the mask's
    want_cell, want_row, want_w = _nonzeros(lists)
    assert len(cell) == lists.nnz
    got_order, want_order = np.lexsort((row, cell)), np.lexsort((want_row, want_cell))
    np.testing.assert_array_equal(cell[got_order], want_cell[want_order])
    np.testing.assert_array_equal(row[got_order], want_row[want_order])
    np.testing.assert_array_equal(wt[got_order].view(np.uint32), want_w[want_order].view(np.uint32))
    # the kernel walks a pair's entries chunk by chunk and in order within a chunk, i.e. in entry order: each cell's
    # rows come ascending in (n, t'), its column's order
    by_cell = np.lexsort((e, cell))
    same = np.diff(cell[by_cell]) == 0
    assert (np.diff(row[by_cell])[same] > 0).all()
    # each tile's union of rows: ascending, exactly its cells' rows
    tiles_t = -(-lists.tscale // bm.FWD_TILE_T)
    nz_tile = (want_cell // lists.tscale // bm.FWD_TILE_D) * tiles_t + want_cell % lists.tscale // bm.FWD_TILE_T
    want_union = np.unique(nz_tile * items + want_row)
    union_tile = np.repeat(np.arange(tiles), np.diff(ptr))
    np.testing.assert_array_equal(union_tile * items + union, want_union)
    assert all((np.diff(union[ptr[t]:ptr[t + 1]]) > 0).all() for t in range(tiles))


def tiled_gather_fwd(p: torch.Tensor, bias: torch.Tensor, lists) -> torch.Tensor:
    """``bm_gather_fwd`` as the kernel schedules it, in plain torch: P's rows [N*T, B*C3]; for every tile at once, chunk
    by chunk, a ring slot staged with the chunk's union rows [TILE_CHUNK, B*C3] (zeros past the union), its merged
    entries and its cuts, and each cell pair's merged entries of the chunk, one a step, added in order from the slot to
    the cells that hold the row; then each cell's sum plus the bias through the ReLU, written at its cell."""
    n_s, t_s, b, c3 = p.shape
    rows = p.reshape(n_s * t_s, b * c3)
    ptr, union, chunk_ptr, cut, ent = _tiles(lists)
    tiles, chunks = len(ptr) - 1, np.diff(chunk_ptr)
    acc = torch.zeros(tiles, PAIRS, 2, b * c3)
    t_ix = torch.arange(tiles)[:, None].expand(tiles, PAIRS)
    for k in range(int(chunks.max(initial=0))):
        live_tile = chunks > k
        slot_u = k * bm.TILE_CHUNK + np.arange(bm.TILE_CHUNK)
        in_union = slot_u[None, :] < np.diff(ptr)[:, None]  # [tiles, TILE_CHUNK]
        slot_rows = union[np.minimum(ptr[:-1, None] + slot_u[None, :], len(union) - 1)]
        ring = torch.where(torch.from_numpy(in_union)[..., None], rows[torch.from_numpy(slot_rows)], torch.zeros(()))
        c = np.where(live_tile, chunk_ptr[:-1] + k, 0)
        cuts = cut[c[:, None] * PAIRS + np.arange(PAIRS + 1)[None, :]]  # the slot's cuts [tiles, PAIRS + 1]
        width = np.where(live_tile, cuts[:, -1] - cuts[:, 0], 0)
        slot_ent = ent[np.minimum(cuts[:, :1] + np.arange(max(1, int(width.max())))[None, :], len(ent) - 1)]  # the slot's entries
        first = torch.from_numpy(np.where(live_tile[:, None], cuts[:, :-1] - cuts[:, :1], 0))
        end = torch.from_numpy(np.where(live_tile[:, None], cuts[:, 1:] - cuts[:, :1], 0))
        ent_u = torch.from_numpy(slot_ent[..., 0].astype(np.int64) & 255)
        slot_flags = torch.from_numpy(slot_ent[..., 0].astype(np.int64) >> 8)
        slot_w = torch.from_numpy(slot_ent[..., 1:3].copy().view(np.float32))  # [tiles, width, 2]
        for step in range(int((end - first).max())):
            e = first + step
            live = e < end
            e = torch.where(live, e, 0)
            v = ring[t_ix, torch.gather(ent_u, 1, e)]  # [tiles, PAIRS, B*C3]
            flags = torch.gather(slot_flags, 1, e)
            for half in (0, 1):
                held = live & ((flags >> half) & 1 == 1)
                w = torch.gather(slot_w[..., half], 1, e)
                acc[:, :, half] = torch.where(held[..., None], acc[:, :, half] + w[..., None] * v, acc[:, :, half])
    # each pair's two cells to their places in the tile, then to the grid of cells, with the bias and the ReLU
    q = np.arange(PAIRS)
    local = torch.from_numpy(np.stack([_pair_cells(q, 0), _pair_cells(q, 1)], 1))  # [PAIRS, 2]
    by_local = torch.zeros(tiles, CELLS, b * c3)
    by_local[:, local.reshape(-1)] = acc.reshape(tiles, PAIRS * 2, b * c3)
    cell_of = torch.from_numpy(_tile_cell_of(lists))
    out = torch.zeros(lists.cells, b * c3)
    out[cell_of[cell_of >= 0]] = torch.relu(by_local[cell_of >= 0] + bias.repeat(b))
    return out.t().contiguous().view(b, c3, lists.cells)


@pytest.mark.parametrize("key", KEYS, ids=IDS)
def test_fwd_tiled_schedule_gives_the_plain_bits(key):
    lists = bm.boundary_matching_lists(*key)
    b, c3 = (1, 2) if key[0] == 200 else (2, 3)
    g = torch.Generator().manual_seed(sum(key[:3]))
    p = torch.randn(lists.num_sample, lists.tscale, b, c3, generator=g)
    bias = torch.tensor([0.25, -0.5, 0.125][:c3])  # both signs: some cells relu(bias), some bias cut
    want = bm.gather_fwd_reference(p, bias, lists)
    got = tiled_gather_fwd(p, bias, lists)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name, value", [("kFwdTileD", bm.FWD_TILE_D), ("kFwdTileT", bm.FWD_TILE_T), ("kChunk", bm.TILE_CHUNK)])
def test_fwd_tile_matches_the_kernels(name, value):
    """The forward tile the lists are built for is the one csrc/boundary_matching.cu compiles (its C entry refuses
    lists of any other, so a mismatch would make every launch fail on the card)."""
    src = open(os.path.join(os.path.dirname(bm.__file__), "..", "csrc", "boundary_matching.cu")).read()
    found = re.search(rf"\b{name} = (\d+)\b", src)
    assert found and int(found.group(1)) == value
