"""The tile form of BMN's boundary-matching lists (clip_fsar_torch/ops/boundary_matching.py ``tile_lists``), which
the backward kernel ``bm_gather_bwd`` walks, on the CPU.

At the EPIC-Kitchens-100 preset's key (T = D = 200, N = 32) and at the small keys of the op's tests: every nonzero
lies in exactly one merged entry of one (chunk, row pair) run, once; each tile's union of cells is ascending and holds
exactly its rows' cells; and the runs of a pair, chunk after chunk, give each of its two rows' entries in ascending
cell order, each through the chunk's cells.  Then a plain-torch emulation of the kernel's schedule (tile by tile, the
union staged in chunks of TILE_CHUNK cells with the chunk's merged entries and cuts, as a slot of the kernel's ring
holds them, each pair's merged entries of the chunk added in order from the slot to the rows that hold the cell, a
product and a sum rounded apart) gives ``gather_bwd_reference``'s fp32 bits.
"""

import numpy as np
import pytest
import torch

from clip_fsar_torch.ops import boundary_matching as bm

torch.set_num_threads(2)

# (T, D, N, per-bin, ratio): the EPIC preset, the localization tests' key, D < T, another per-bin count and ratio
KEYS = [(200, 200, 32, 3, 0.5), (32, 32, 8, 3, 0.5), (32, 12, 8, 3, 0.5), (20, 20, 5, 2, 0.25), (24, 10, 6, 3, 0.5)]
IDS = ["epic_T200_N32", "T32_D32_N8", "T32_D12_N8", "T20_D20_N5_bin2", "T24_D10_N6"]
ROWS = bm.TILE_N * bm.TILE_T
PAIRS = ROWS // 2


def _tiles(lists):
    """numpy views of the tile form: each tile's union of cells, its chunks, the (chunk, row) cuts, the entries."""
    as64 = lambda t: t.numpy().astype(np.int64)  # noqa: E731
    return as64(lists.tile_cell_ptr), lists.tile_cells.numpy(), as64(lists.tile_chunk_ptr), as64(lists.chunk_cut), lists.ent.numpy()


def _tile_row_of(lists):
    """For each tile and local row: the global row n * T + t' (-1 where the tile runs past N or T)."""
    tiles_t = -(-lists.tscale // bm.TILE_T)
    tiles = -(-lists.num_sample // bm.TILE_N) * tiles_t
    t_idx, j = np.meshgrid(np.arange(tiles), np.arange(ROWS), indexing="ij")
    n = (t_idx // tiles_t) * bm.TILE_N + j // bm.TILE_T
    tp = (t_idx % tiles_t) * bm.TILE_T + j % bm.TILE_T
    return np.where((n < lists.num_sample) & (tp < lists.tscale), n * lists.tscale + tp, -1)


@pytest.mark.parametrize("key", KEYS, ids=IDS)
def test_tile_lists_hold_every_nonzero_once_in_ascending_order(key):
    lists = bm.boundary_matching_lists(*key)
    cell_ptr, cells, chunk_ptr, cut, ent = _tiles(lists)
    tiles = len(cell_ptr) - 1
    assert lists.ent.shape[1] == 4 and lists.ent.dtype == torch.int32
    assert cell_ptr[0] == 0 and (np.diff(cell_ptr) >= 0).all() and cell_ptr[-1] == len(cells)
    chunks = np.diff(chunk_ptr)
    assert chunk_ptr[0] == 0 and (chunks == -(-np.diff(cell_ptr) // bm.TILE_CHUNK)).all()
    # the (chunk, pair) runs tile the merged entries in order; each nonzero is one row's half of one merged entry
    assert len(cut) == chunk_ptr[-1] * PAIRS + 1 and cut[0] == 0 and cut[-1] == len(ent) and (np.diff(cut) >= 0).all()
    assert lists.max_chunk_entries == np.diff(cut).reshape(-1, PAIRS).sum(1).max()
    u_local, flags = ent[:, 0] & 255, ent[:, 0] >> 8
    w = ent[:, 1:3].copy().view(np.float32)  # [merged, 2]: row t', row t' + 1
    assert ((u_local >= 0) & (u_local < bm.TILE_CHUNK)).all() and ((flags >= 1) & (flags <= 3)).all() and (ent[:, 3] == 0).all()
    for half in (0, 1):
        held = (flags >> half & 1) == 1
        assert (w[held, half] != 0).all() and (w[~held, half] == 0).all()
    assert int((flags & 1).sum() + (flags >> 1).sum()) == lists.nnz
    row_of = _tile_row_of(lists)
    row_ptr, row_cell, row_w = lists.row_ptr.numpy(), lists.row_cell.numpy(), lists.row_w.numpy()
    for t in range(tiles):
        union = cells[cell_ptr[t]:cell_ptr[t + 1]]
        assert (np.diff(union) > 0).all()
        touched = []
        for p in range(PAIRS):
            runs = [(k, cut[(chunk_ptr[t] + k) * PAIRS + p], cut[(chunk_ptr[t] + k) * PAIRS + p + 1]) for k in range(chunks[t])]
            merged_u = np.concatenate([k * bm.TILE_CHUNK + u_local[a:b] for k, a, b in runs] + [u_local[:0]])
            assert (np.diff(merged_u) > 0).all() and (merged_u < len(union)).all()
            for half in (0, 1):
                got = [(k * bm.TILE_CHUNK + u_local[a:b][(flags[a:b] >> half & 1) == 1], w[a:b, half][(flags[a:b] >> half & 1) == 1])
                       for k, a, b in runs]
                got_u = np.concatenate([g[0] for g in got] + [u_local[:0]])
                got_w = np.concatenate([g[1] for g in got] + [w[:0, 0]])
                r = row_of[t, 2 * p + half]
                want = (row_cell[row_ptr[r]:row_ptr[r + 1]], row_w[row_ptr[r]:row_ptr[r + 1]]) if r >= 0 else (row_cell[:0], row_w[:0])
                np.testing.assert_array_equal(union[got_u], want[0])  # the row's cells, ascending, through the union
                np.testing.assert_array_equal(got_w.view(np.uint32), want[1].view(np.uint32))
                touched.append(want[0])
        np.testing.assert_array_equal(union, np.unique(np.concatenate(touched)))


def tiled_gather_bwd(out: torch.Tensor, dout: torch.Tensor, lists) -> torch.Tensor:
    """``bm_gather_bwd`` as the kernel schedules it, in plain torch: dyt [cells, B*C3] masked and transposed, then for
    every tile at once, chunk by chunk, a ring slot staged with the chunk's union cells [TILE_CHUNK, B*C3] (zeros past
    the union), its merged entries and its cuts, and each row pair's merged entries of the chunk, one a step, added in
    order from the slot to the rows that hold the cell."""
    b, c3 = out.shape[:2]
    dyt = torch.where(out > 0, dout, torch.zeros(())).reshape(b * c3, -1).t()
    cell_ptr, cells, chunk_ptr, cut, ent = _tiles(lists)
    tiles, chunks = len(cell_ptr) - 1, np.diff(chunk_ptr)
    acc = torch.zeros(tiles, PAIRS, 2, b * c3)
    t_ix = torch.arange(tiles)[:, None].expand(tiles, PAIRS)
    for k in range(int(chunks.max())):
        live_tile = chunks > k
        slot_u = k * bm.TILE_CHUNK + np.arange(bm.TILE_CHUNK)
        in_union = slot_u[None, :] < np.diff(cell_ptr)[:, None]  # [tiles, TILE_CHUNK]
        slot_cells = cells[np.minimum(cell_ptr[:-1, None] + slot_u[None, :], len(cells) - 1)]
        ring = torch.where(torch.from_numpy(in_union)[..., None], dyt[torch.from_numpy(slot_cells.astype(np.int64))], torch.zeros(()))
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
    row_of = torch.from_numpy(_tile_row_of(lists))
    acc = acc.reshape(tiles, ROWS, b * c3)  # row 2p + half
    dp = torch.zeros(lists.num_sample * lists.tscale, b * c3)
    dp[row_of[row_of >= 0]] = acc[row_of >= 0]
    return dp.t().reshape(b, c3, lists.num_sample, lists.tscale)


@pytest.mark.parametrize("key", KEYS, ids=IDS)
def test_tiled_schedule_gives_the_plain_bits(key):
    lists = bm.boundary_matching_lists(*key)
    b, c3 = (1, 2) if key[0] == 200 else (2, 3)
    g = torch.Generator().manual_seed(sum(key[:3]))
    out = torch.randn(b, c3, lists.cells, generator=g)  # both signs: the ReLU's mask cuts about half
    dout = torch.randn(b, c3, lists.cells, generator=g)
    want = bm.gather_bwd_reference(out, dout, lists)
    got = tiled_gather_bwd(out, dout, lists)
    assert torch.equal(got, want)


def test_lists_move_only_what_the_kernels_read():
    """``BMLists.to`` moves the two tile forms the kernels read and leaves the column and row forms, which only the
    plain versions read, on the host, shared with the host lists; ``columns(device)`` and ``rows(device)`` copy them
    there once; the lists carry the tiles they were built for."""
    lists = bm.boundary_matching_lists(*KEYS[1])
    moved = lists.to("meta")
    assert moved is lists.to("meta") and moved.device == torch.device("meta") and lists.device == torch.device("cpu")
    assert set(bm.BMLists.KERNEL_TENSORS) == {"tile_cell_ptr", "tile_cells", "tile_chunk_ptr", "chunk_cut", "ent", "fwd_tile_row_ptr",
                                              "fwd_tile_rows", "fwd_tile_chunk_ptr", "fwd_chunk_cut", "fwd_ent"}
    assert all(getattr(moved, name).device == torch.device("meta") for name in bm.BMLists.KERNEL_TENSORS)
    assert all(getattr(moved, name) is getattr(lists, name) for name in bm.BMLists.COLUMN_TENSORS + bm.BMLists.ROW_TENSORS)
    assert (moved.nnz, moved.max_chunk_entries, moved.tile) == (lists.nnz, lists.max_chunk_entries, (bm.TILE_N, bm.TILE_T, bm.TILE_CHUNK))
    assert (moved.fwd_max_chunk_entries, moved.fwd_tile) == (lists.fwd_max_chunk_entries, (bm.FWD_TILE_D, bm.FWD_TILE_T, bm.TILE_CHUNK))
    for form, names in ((moved.rows, bm.BMLists.ROW_TENSORS), (moved.columns, bm.BMLists.COLUMN_TENSORS)):
        on_meta = form("meta")
        assert on_meta is form("meta") and all(t.device == torch.device("meta") for t in on_meta)
        assert [t.shape for t in on_meta] == [getattr(lists, name).shape for name in names]
        assert all(a is getattr(lists, name) for a, name in zip(form("cpu"), names))
    assert lists.rows("meta") is moved.rows("meta") and lists.columns("meta") is moved.columns("meta")
