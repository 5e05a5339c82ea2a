"""BMN's boundary-matching op (clip_fsar_torch/ops/boundary_matching.py) against the JAX package on the CPU.

The mask's lists rebuild ``boundary_matching_mask`` bit for bit in both forms, and hold every nonzero once
in ascending order; the op's plain version (P by a matrix product, then the gather over the lists, bias and
ReLU) against the JAX layer (clip_fsar_tpu/models/heads/bmn.py:94-103: ``einsum`` by the dense mask, the
(N, 1, 1) ``nn.Conv``, ReLU) on numpy inputs from a seed, the JAX weights carried across by the video
converter: the output at 1e-5 and the gradients of mid, weight and bias at 1e-4, in float32.  Keys at
BMN_TINY-like sizes, D = T and D < T.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

# (T, D, N, per-bin, ratio): the localization tests' key, D < T, another per-bin count and ratio, and D < T at N = 6
KEYS = [(32, 32, 8, 3, 0.5), (32, 12, 8, 3, 0.5), (20, 20, 5, 2, 0.25), (24, 10, 6, 3, 0.5)]
IDS = ["T32_D32_N8", "T32_D12_N8", "T20_D20_N5_bin2", "T24_D10_N6"]


def jax_mask(key):
    from clip_fsar_tpu.models.heads.bmn import boundary_matching_mask

    return boundary_matching_mask(*key)


def row_mask(lists) -> np.ndarray:
    """The mask [T', N, D, T] rebuilt from the row form alone."""
    out = np.zeros((lists.num_sample, lists.tscale, lists.cells), np.float32)
    counts = np.diff(lists.row_ptr.numpy())
    rows = np.repeat(np.arange(lists.num_sample * lists.tscale), counts)
    out[rows // lists.tscale, rows % lists.tscale, lists.row_cell.numpy()] = lists.row_w.numpy()
    return out.reshape(lists.num_sample, lists.tscale, lists.dscale, lists.tscale).transpose(1, 0, 2, 3)


def column_mask(lists) -> np.ndarray:
    """The mask [T', N, D, T] rebuilt from the column form alone."""
    out = np.zeros((lists.tscale, lists.num_sample, lists.cells), np.float32)
    col_t, col_w, col_n = lists.col_t.numpy(), lists.col_w.numpy(), lists.col_n.numpy()
    cells = lists.order.numpy()[: lists.active]
    for n in range(lists.num_sample):
        for k in range(lists.max_per_column):
            live = k < col_n[n]
            out[col_t[n, k][live], n, cells[live]] = col_w[n, k][live]
    return out.reshape(lists.tscale, lists.num_sample, lists.dscale, lists.tscale)


@pytest.mark.parametrize("key", KEYS, ids=IDS)
def test_lists_rebuild_the_jax_mask_bit_for_bit(key):
    """Both forms of the lists put every weight of the JAX package's mask back at its place, bit for bit, and
    nothing else; the host's lists are built once per key."""
    from clip_fsar_torch.ops.boundary_matching import boundary_matching_lists

    want = jax_mask(key)
    lists = boundary_matching_lists(*key)
    assert boundary_matching_lists(*key) is lists
    assert (lists.tscale, lists.num_sample, lists.dscale) == (key[0], key[2], key[1])
    for got in (row_mask(lists), column_mask(lists)):
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("key", KEYS, ids=IDS)
def test_every_nonzero_appears_once_in_each_form_in_ascending_order(key):
    """Each form holds the mask's nonzeros once: the rows' cells and the columns' t' strictly ascending, the
    columns' padding (0, 0.0) past their counts, K the largest count of any column of the mask; ``order`` is
    the active cells ascending (those with an entry in some n), then the others ascending."""
    from clip_fsar_torch.ops.boundary_matching import boundary_matching_lists

    mask = jax_mask(key)
    t, n_s, d, _ = mask.shape
    lists = boundary_matching_lists(*key)
    nnz = int(np.count_nonzero(mask))
    row_ptr, row_cell, row_w = lists.row_ptr.numpy(), lists.row_cell.numpy(), lists.row_w.numpy()
    assert lists.nnz == nnz == row_ptr[-1] and len(row_ptr) == n_s * t + 1 and (row_w != 0).all()
    for r in range(n_s * t):
        cells = row_cell[row_ptr[r]:row_ptr[r + 1]]
        assert (np.diff(cells) > 0).all()
        n, tp = divmod(r, t)
        np.testing.assert_array_equal(cells, np.flatnonzero(mask[tp, n].reshape(-1)))
    assert lists.max_per_row == int(np.diff(row_ptr).max())
    counts = (mask != 0).sum(0).reshape(n_s, d * t)  # [N, cells]
    active = np.flatnonzero(counts.sum(0) > 0)
    order = lists.order.numpy()
    np.testing.assert_array_equal(order, np.concatenate([active, np.flatnonzero(counts.sum(0) == 0)]))
    assert lists.active == len(active) and lists.max_per_column == counts.max() > 0
    col_t, col_w, col_n = lists.col_t.numpy(), lists.col_w.numpy(), lists.col_n.numpy()
    np.testing.assert_array_equal(col_n, counts[:, active])
    assert int(col_n.sum()) == nnz
    for n in range(n_s):
        for i, cell in enumerate(active):
            c = col_n[n, i]
            assert (np.diff(col_t[n, :c, i]) > 0).all() and (col_w[n, :c, i] != 0).all()
            assert (col_t[n, c:, i] == 0).all() and (col_w[n, c:, i] == 0).all()
            np.testing.assert_array_equal(col_t[n, :c, i], np.flatnonzero(mask[:, n].reshape(t, -1)[:, cell]))


def jax_layer(key, mid_btc, kernel, bias):
    """The JAX package's boundary-matching layer (BaseBMN.__call__'s lines for it): [B, T, C] -> [B, D, T, C3]."""
    t, d, n_s = key[0], key[1], key[2]
    mask = jnp.asarray(jax_mask(key).reshape(t, -1))
    b, _, c = mid_btc.shape
    bm = jnp.einsum("btc,tm->bcm", mid_btc, mask).reshape(b, c, n_s, d, t).transpose(0, 2, 3, 4, 1)
    conv = nn.Conv(kernel.shape[-1], (n_s, 1, 1), strides=(n_s, 1, 1), param_dtype=jnp.float32)
    return nn.relu(conv.apply({"params": {"kernel": kernel, "bias": bias}}, bm))[:, 0]


@pytest.mark.parametrize("key", KEYS, ids=IDS)
def test_plain_op_matches_the_jax_layer_and_its_gradients(key):
    """``boundary_matching`` on CPU tensors (its plain versions; no kernel launched) against the JAX layer on the
    same numpy inputs: mid [3, 16, T] after a ReLU, the Conv3d's kernel and a bias with both signs (so that some
    outputs are relu(bias) and some bias is cut by the ReLU), converted by ``params_from_jax``; the output at 1e-5
    and, under one cotangent, the gradients of mid, weight and bias at 1e-4."""
    from clip_fsar_torch.models.video.convert import params_from_jax
    from clip_fsar_torch.ops import boundary_matching as bm_op

    t, d, n_s = key[0], key[1], key[2]
    b, c, c3 = 3, 16, 12
    rng = np.random.default_rng(sum(key[:4]))
    mid = np.maximum(rng.normal(size=(b, c, t)), 0).astype(np.float32)
    kernel = (rng.normal(size=(n_s, 1, 1, c, c3)) / np.sqrt(c * n_s)).astype(np.float32)
    bias = (0.1 * rng.normal(size=(c3,))).astype(np.float32)
    cot = rng.normal(size=(b, d, t, c3)).astype(np.float32)

    want, vjp = jax.vjp(lambda m, k, bb: jax_layer(key, m, k, bb), jnp.asarray(mid.transpose(0, 2, 1)), jnp.asarray(kernel), jnp.asarray(bias))
    d_mid, d_kernel, d_bias = (np.asarray(g) for g in vjp(jnp.asarray(cot)))

    state = params_from_jax({"params": {"x_3d_p": {"kernel": kernel, "bias": bias}}})
    weight = state["x_3d_p.weight"].view(c3, c, n_s).clone().requires_grad_(True)
    bias_t = state["x_3d_p.bias"].clone().requires_grad_(True)
    mid_t = torch.from_numpy(mid).requires_grad_(True)
    before = dict(bm_op.LAUNCHES)
    out = bm_op.boundary_matching(mid_t, weight, bias_t, bm_op.boundary_matching_lists(*key))
    assert out.shape == (b, c3, d, t) and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy().transpose(0, 2, 3, 1), np.asarray(want), atol=1e-5, rtol=1e-5)
    out.backward(torch.from_numpy(cot.transpose(0, 3, 1, 2).copy()))
    assert bm_op.LAUNCHES == before
    np.testing.assert_allclose(mid_t.grad.numpy(), d_mid.transpose(0, 2, 1), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(weight.grad.numpy(), params_from_jax({"params": {"k": {"kernel": d_kernel}}})["k.weight"].view(c3, c, n_s).numpy(),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(bias_t.grad.numpy(), d_bias, atol=1e-4, rtol=1e-4)
    # both signs of the bias reach the output: relu(bias) where no entry lies (D < T, or a short proposal's
    # samples outside [0, T)), the bias cut where it is negative
    assert (bias < 0).any() and (bias > 0).any()


def test_plain_versions_add_in_the_kernels_order():
    """The plain forward adds each column's products n by n and t' by t' (the kernel's order), the plain backward
    each row's cells in ascending order: recomputed here entry by entry in float32, the same bits."""
    from clip_fsar_torch.ops.boundary_matching import boundary_matching_lists, gather_bwd_reference, gather_fwd_reference

    key = KEYS[1]
    lists = boundary_matching_lists(*key)
    g = torch.Generator().manual_seed(0)
    p = torch.randn(lists.num_sample, lists.tscale, 2, 3, generator=g)  # P's rows [N, T], each row's (b, o) side by side
    bias = torch.randn(3, generator=g)
    out = gather_fwd_reference(p, bias, lists)
    order, col_n = lists.order.tolist(), lists.col_n
    for i in (0, lists.active // 2, lists.active - 1, lists.active, lists.cells - 1):
        for b, o in ((0, 0), (1, 2)):
            acc = torch.zeros((), dtype=torch.float32)
            if i < lists.active:
                for n in range(lists.num_sample):
                    for k in range(int(col_n[n, i])):
                        acc = acc + lists.col_w[n, k, i] * p[n, lists.col_t[n, k, i].long(), b, o]
            assert torch.equal(out[b, o, order[i]], torch.relu(acc + bias[o]))
    dout = torch.randn(out.shape, generator=g)
    dp = gather_bwd_reference(out, dout, lists)
    for r in (0, lists.tscale + 3, lists.num_sample * lists.tscale - 1):
        for b, o in ((0, 1), (1, 0)):
            acc = torch.zeros((), dtype=torch.float32)
            for e in range(int(lists.row_ptr[r]), int(lists.row_ptr[r + 1])):
                cell = int(lists.row_cell[e])
                if out[b, o, cell] > 0:
                    acc = acc + lists.row_w[e] * dout[b, o, cell]
            assert torch.equal(dp[b, o].reshape(-1)[r], acc)


def test_bmn_holds_the_lists_not_the_dense_mask():
    """BaseBMN keeps no [T, N*D*T] buffer (its state dict and buffers are the convolutions' own), and its forward on
    the CPU launches no kernel; the kernels' wrappers refuse CPU tensors rather than fall back."""
    from clip_fsar_torch.config.config import Config
    from clip_fsar_torch.models.heads.bmn import BaseBMN
    from clip_fsar_torch.ops import boundary_matching as bm_op

    cfg = Config({"DATA": {"TEMPORAL_SCALE": 20, "DURATION_SCALE": 0},
                  "VIDEO": {"DIM1D": 16, "DIM2D": 8, "DIM3D": 8,
                            "HEAD": {"NUM_SAMPLE": 5, "NUM_SAMPLE_PERBIN": 2, "BOUNDARY_RATIO": 0.25}}})
    head = BaseBMN(cfg, 12)
    assert not list(head.buffers()) and all(not k.startswith("bm") for k in head.state_dict())
    before = dict(bm_op.LAUNCHES)
    out = head(torch.randn(2, 12, 20, generator=torch.Generator().manual_seed(0)))
    assert out["confidence_map"].shape == (2, 2, 20, 20) and bm_op.LAUNCHES == before
    lists = bm_op.boundary_matching_lists(20, 20, 5, 2, 0.25)
    with pytest.raises(ValueError, match="CUDA"):
        bm_op.bm_gather_fwd_cuda(torch.zeros(1, 1, 5, 20), torch.zeros(1), lists)
    with pytest.raises(ValueError, match="CUDA"):
        bm_op.bm_gather_bwd_cuda(torch.zeros(1, 1, 20, 20), torch.zeros(1, 1, 20, 20), lists)
