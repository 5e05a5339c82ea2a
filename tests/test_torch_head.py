"""The CLIP-FSAR head of clip_fsar_torch against clip_fsar_tpu: the
prototype-modulation TransformerV1 and every branch of the head (plain
OTAM, MERGE_BEFORE, SINGLE_DIRECT, EVAL_TEXT, COMBINE, and the train
branch), on the tiny ViT with the same weights and the same numpy
episodes; the dropout masks of the train branch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_fsar_torch.data.types import Episode
from clip_fsar_torch.models.clip import convert
from clip_fsar_torch.models.heads.clipfsar import CLIPFSARConfig, CLIPFSARHead
from clip_fsar_torch.models.heads.common import TransformerV1
from tests.torch_parity import jax_tiny_model, port_head_state

torch.set_num_threads(2)


@pytest.mark.parametrize("heads, dim_head, depth", [(8, 4, 1), (8, 4, 2), (1, 32, 1)])
def test_transformer_v1_matches_jax(heads, dim_head, depth):
    """Layer 0 attends LN(q) to LN(k), LN(v); deeper layers self-attend;
    one head spanning the width skips to_out.  fp32 at 1e-5."""
    from clip_fsar_tpu.models.heads.common import TransformerV1 as JTransformerV1

    rng = np.random.RandomState(depth + heads)
    q, k, v = (rng.randn(3, 5, 32).astype(np.float32) for _ in range(3))
    jmod = JTransformerV1(dim=32, heads=heads, dim_head_k=dim_head, depth=depth)
    variables = jax.jit(jmod.init)(jax.random.PRNGKey(0), *(jnp.asarray(x) for x in (q, k, v)))
    want = np.asarray(jmod.apply(variables, *(jnp.asarray(x) for x in (q, k, v)), deterministic=True))

    sd = {}
    convert._context2(sd, jax.device_get(variables["params"]))
    mod = TransformerV1(32, heads=heads, dim_head_k=dim_head, depth=depth)
    mod.load_state_dict({key[len("context2."):]: val for key, val in sd.items()})
    assert (mod.attn_0.to_out is None) == (heads == 1)
    with torch.no_grad():
        got = mod(*(torch.from_numpy(x) for x in (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def _episodes(num=2, way=5, frames=4, res=64, text_rows=10, seed=0):
    """E normalized-image episodes (1 shot, 1 query per class), numpy."""
    rng = np.random.RandomState(seed)
    eps = []
    for _ in range(num):
        classes = rng.choice(text_rows, size=way, replace=False)
        s_lab, q_lab = rng.permutation(way), rng.permutation(way)
        eps.append(dict(
            support_images=rng.randn(way, frames, res, res, 3).astype(np.float32),
            support_labels=s_lab.astype(np.int32),
            real_support_labels=classes[s_lab].astype(np.int32),
            target_images=rng.randn(way, frames, res, res, 3).astype(np.float32),
            target_labels=q_lab.astype(np.int32),
            real_target_labels=classes[q_lab].astype(np.int32),
            batch_class_list=classes.astype(np.int32),
        ))
    return {k: np.stack([e[k] for e in eps]) for k in eps[0]}


@pytest.mark.parametrize(
    "variant",
    [{}, {"MERGE_BEFORE": True}, {"SINGLE_DIRECT": True}, {"EVAL_TEXT": True}, {"COMBINE": True}, {"COMBINE": True, "TEXT_COFF": 0.6}],
    ids=["plain", "merge_before", "single_direct", "eval_text", "combine", "combine_coff"],
)
def test_head_eval_branches_match_jax(variant):
    """Head logits (and class logits where the branch makes them) for two
    episodes in one call, vs the JAX head vmapped over them, in the eval
    branch and in the train branch; fp32 at 1e-4."""
    from clip_fsar_tpu.data.types import Episode as JEpisode
    from clip_fsar_tpu.models.heads.clipfsar import CLIPFSARConfig as JConfig
    from clip_fsar_tpu.models.heads.clipfsar import CLIPFSARHead as JHead

    cfg, arch, clip_vars, model = jax_tiny_model()
    cfg = cfg.deep_copy()
    for key, value in variant.items():
        cfg.TRAIN[key] = value
    batch = _episodes()

    jhead = JHead(arch=arch, head_cfg=JConfig.from_cfg(cfg), dtype=jnp.float32)
    # the eval branch, and the train branch with dropout off (deterministic=True), in one compiled call
    run = jax.jit(jax.vmap(lambda ep: [jhead.apply(model.variables, ep, model.text_train, model.text_test, train=train, deterministic=True)
                                       for train in (False, True)]))
    want, want_train = run(JEpisode(**{k: jnp.asarray(v) for k, v in batch.items()}))

    head = CLIPFSARHead(arch, CLIPFSARConfig.from_cfg(cfg), dtype=torch.float32)
    head.load_state_dict({k: v for k, v in port_head_state(model, clip_vars).items() if not k.startswith("text.")})
    text_train, text_test = (torch.from_numpy(np.array(t)) for t in (model.text_train, model.text_test))
    with torch.no_grad():
        got = head(Episode(**{k: torch.from_numpy(v) for k, v in batch.items()}), text_train, text_test)
    assert got["logits"].shape == (2, 5, 5)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=1e-4, rtol=1e-4)
    if want["class_logits"] is None:
        assert got["class_logits"] is None
    else:
        np.testing.assert_allclose(got["class_logits"].numpy(), np.asarray(want["class_logits"]), atol=1e-4, rtol=1e-4)

    # train branch: the train text bank modulates the prototypes, the class logits follow
    # USE_CLASSIFICATION, EVAL_TEXT and COMBINE do not apply; no generator, so no dropout
    with torch.no_grad():
        got = head(Episode(**{k: torch.from_numpy(v) for k, v in batch.items()}), text_train, text_test, train=True)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want_train["logits"]), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got["class_logits"].numpy(), np.asarray(want_train["class_logits"]), atol=1e-4, rtol=1e-4)


def test_dropout_masks():
    """Dropout as flax draws it: keep with probability 1 - rate, kept values
    scaled by 1/(1 - rate), identity without a generator; the same generator
    seed gives the same mask.  The rate is read from 200k draws at 4 sigma."""
    from clip_fsar_torch.models.heads.common import dropout

    x = torch.ones(200_000)
    assert dropout(x, 0.2, None) is x and dropout(x, 0.0, torch.Generator().manual_seed(0)) is x
    a = dropout(x, 0.2, torch.Generator().manual_seed(3))
    b = dropout(x, 0.2, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    assert set(a.unique().tolist()) == {0.0, 1.25}
    kept = (a > 0).float().mean().item()
    assert abs(kept - 0.8) < 4 * (0.8 * 0.2 / x.numel()) ** 0.5
    assert not torch.equal(a, dropout(x, 0.2, torch.Generator().manual_seed(4)))
    mod = TransformerV1(32, heads=8, dim_head_k=4, dropout_atte=0.2, dropout_ffn=0.05)
    assert (mod.attn_0.rate, mod.ff_0.rate) == (0.2, 0.05)
