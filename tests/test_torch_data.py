"""The port's episodic data path against clip_fsar_tpu: byte-identical
episodes from the same seed, step and slot (train, val and test splits),
the train augmentation given the JAX package's own draws, the in-order
threaded loader and its start step, and the move to a device."""

import dataclasses

import numpy as np
import pytest
import torch

from clip_fsar_torch.data.augment import (
    ErasingConfig,
    ErasingDraws,
    JitterConfig,
    JitterDraws,
    color_jitter_batch,
    draw_erasing,
    draw_jitter,
    erase_box_sizes,
    fewshot_train_augment,
    host_generator,
    random_erasing_batch,
)
from clip_fsar_torch.data.datasets import DATASET_REGISTRY
from clip_fsar_torch.data.episodes import EpisodeLoader
from clip_fsar_torch.data.transforms import normalize_images, standardize
from clip_fsar_torch.data.types import Episode, stack_episodes
from tests.torch_parity import tiny_cfg

torch.set_num_threads(2)

_FIELDS = [f.name for f in dataclasses.fields(Episode)]


@pytest.mark.parametrize("split", ["test", "val", "train"])
def test_sampler_episodes_byte_identical_to_jax(split):
    """Same cfg, split file, synthetic decoder and (seed, step, slot):
    every field of every episode equal, images byte for byte (train: random
    crop and flip, 5 support and 25 query clips)."""
    from clip_fsar_tpu.data.datasets import FewShotVideoDataset as JDataset

    cfg = tiny_cfg("TRAIN.ENABLE", str(split == "train"))
    cfg.AUGMENTATION["RANDOM_FLIP"] = True  # support clips flip too (query clips always may)
    jsampler = JDataset(cfg, split).make_sampler()
    tsampler = DATASET_REGISTRY.get(cfg.TRAIN.DATASET)(cfg, split).make_sampler()
    assert tsampler.seed == jsampler.seed
    for step, slot in ((0, 0), (0, 1), (7, 3)):
        jsampler.reseed_for_slot(step, slot)
        tsampler.reseed_for_slot(step, slot)
        want, got = jsampler.sample_episode(), tsampler.sample_episode()
        for name in _FIELDS:
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.support_images.shape == (5, 4, 64, 64, 3) and got.support_images.dtype == np.uint8
    assert got.target_images.shape[0] == (25 if split == "train" else 5)


def test_train_split_is_not_ported_yet():
    """Nothing of the train split's augmentation is left unported: random
    erasing (off in base.yaml and the shipped few-shot configs) runs under
    its ENABLE, on query clips always and on support clips unless
    AUGMENTATION.NO_RANDOM_ERASE (augment.py:424-428), after the jitter and
    normalization and with the same generator; without a generator the clips
    are only normalized."""
    cfg = tiny_cfg("AUGMENTATION.NO_RANDOM_ERASE", "True", "AUGMENTATION.RANDOM_ERASING.ENABLE", "True", "AUGMENTATION.RANDOM_ERASING.PROB", "1.0")
    clips = torch.from_numpy(np.random.RandomState(3).randint(0, 256, size=(4, 2, 16, 16, 3)).astype(np.uint8))
    mean, std = cfg.DATA.MEAN, cfg.DATA.STD
    plain = normalize_images(clips, mean, std)
    erased = fewshot_train_augment(clips, cfg, mean, std, True, torch.Generator().manual_seed(0))
    unerased = fewshot_train_augment(clips, tiny_cfg(), mean, std, True, torch.Generator().manual_seed(0))
    assert (erased == 0).any() and not (unerased == 0).any()
    assert torch.equal(torch.where(erased == 0, unerased, erased), unerased)  # the jitter's draws came first, as without erasing
    assert torch.equal(fewshot_train_augment(clips, cfg, mean, std, False, torch.Generator().manual_seed(0)), plain)
    cfg.AUGMENTATION["NO_RANDOM_ERASE"] = False
    assert (fewshot_train_augment(clips, cfg, mean, std, False, torch.Generator().manual_seed(0)) == 0).any()
    assert torch.equal(fewshot_train_augment(clips, cfg, mean, std, True, None), plain)


def _jax_erasing_draws(key, shape, ec: ErasingConfig) -> ErasingDraws:
    """The draws the JAX package's random_erasing makes from ``key``, in the order and shapes of
    augment.py:189-222 (one key per clip, then per rectangle; the geometry of the attempts taken
    by the port's ``erase_box_sizes``, so a rule other than JAX's moves the rectangles)."""
    import jax
    import jax.numpy as jnp

    n, t, img_h, img_w, c = shape
    min_count, max_count = ec.count
    log_lo, log_hi = np.log(ec.min_aspect), np.log(1.0 / ec.min_aspect)
    fields = {k: [] for k in ("on", "top", "left", "height", "width", "use", "fill")}
    for clip_key in jax.random.split(key, n):
        k_on, k_cnt, k_geo, k_fill = jax.random.split(clip_key, 4)
        count = min_count if min_count == max_count else int(jax.random.randint(k_cnt, (), min_count, max_count + 1))
        fields["on"].append(bool(jax.random.uniform(k_on) < ec.probability))
        rows = {k: [] for k in ("top", "left", "height", "width", "use", "fill")}
        for blk, (geo, fill_key) in enumerate(zip(jax.random.split(k_geo, max_count), jax.random.split(k_fill, max_count))):
            ka, kr, kt, kl = jax.random.split(geo, 4)
            area = torch.from_numpy(np.array(jax.random.uniform(ka, (10,), jnp.float32, *ec.area_range)))
            log_ratio = torch.from_numpy(np.array(jax.random.uniform(kr, (10,), jnp.float32, log_lo, log_hi)))
            h, w, fits = (int(v) for v in erase_box_sizes(area, log_ratio, torch.tensor(count), img_h, img_w))
            rows["top"].append(int(jax.random.randint(kt, (), 0, max(img_h - h, 1))))
            rows["left"].append(int(jax.random.randint(kl, (), 0, max(img_w - w, 1))))
            rows["height"].append(h), rows["width"].append(w), rows["use"].append(bool(fits) and blk < count)
            fill_shape = {"rand": (c,), "pixel": (t, img_h, img_w, c)}.get(ec.mode)
            rows["fill"].append(None if fill_shape is None else np.array(jax.random.normal(fill_key, fill_shape, jnp.float32)))
        for k, v in rows.items():
            fields[k].append(v)
    draws = {k: torch.tensor(fields[k]) for k in ("on", "top", "left", "height", "width", "use")}
    fill = None if ec.mode == "const" else torch.from_numpy(np.stack([np.stack(f) for f in fields["fill"]]))
    return ErasingDraws(fill=fill, **draws)


@pytest.mark.parametrize("mode, count, num_splits", [("const", (1, 1), 0), ("rand", (1, 3), 0), ("pixel", (2, 2), 2)])
def test_random_erasing_matches_jax_with_its_draws(mode, count, num_splits):
    """random_erasing of the JAX package on normalized clips against the
    port's apply fed the JAX draws from the same key, for each fill mode,
    with a count range (rectangles that overlap, a later one on top) and a
    clean split: the same bits (the apply only selects input and fill
    values)."""
    import jax
    import jax.numpy as jnp

    from clip_fsar_tpu.data import augment as jaug

    ec = ErasingConfig(probability=0.7, area_range=(0.05, 0.4), min_aspect=0.3, mode=mode, count=count, num_splits=num_splits)
    x = np.random.RandomState(8).standard_normal((8, 3, 24, 20, 3)).astype(np.float32)
    key = jax.random.PRNGKey(21)
    want = np.asarray(jaug.random_erasing(key, jnp.asarray(x), probability=ec.probability, area_range=ec.area_range,
                                          min_aspect=ec.min_aspect, mode=mode, count=count, num_splits=num_splits))
    draws = _jax_erasing_draws(key, x.shape, ec)
    got = random_erasing_batch(torch.from_numpy(x), draws, ec).numpy()
    assert (got != x).any() and draws.on.any() and not draws.on.all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["const", "rand", "pixel"])
def test_random_erasing_own_draws_stay_in_range(mode):
    """The port's draws from a generator: about PROB of the clips erased,
    each rectangle inside the frame, the same in every frame, of an area
    within AREA_RANGE of the frame shared among the clip's rectangles (up
    to the rounding of its sides) and an aspect within [MIN_ASPECT,
    1/MIN_ASPECT] (the same), its count within COUNT; nothing is read back
    while drawing and applying."""
    from tests.torch_parity import host_reads

    ec = ErasingConfig(probability=0.5, area_range=(0.02, 0.33), min_aspect=0.3, mode=mode, count=(1, 2))
    n, t, img_h, img_w = 400, 2, 32, 48
    x = torch.randn(n, t, img_h, img_w, 3)
    g = torch.Generator().manual_seed(4)
    with host_reads() as reads:
        draws = draw_erasing(g, x.shape, ec)
        out = random_erasing_batch(x, draws, ec)
    assert reads == []
    assert 0.4 < draws.on.float().mean().item() < 0.6
    changed = (out != x).any(dim=-1)  # [N, T, H, W]
    assert torch.equal(changed[:, 0], changed[:, 1])  # the same rectangles in every frame
    assert not changed[~draws.on].any()
    count = draws.use.sum(dim=1)
    assert (count <= 2).all() and (count[draws.on] >= 1).float().mean() > 0.95  # a rectangle fits in nearly every attempt set
    h, w = draws.height[draws.use].double(), draws.width[draws.use].double()
    top, left = draws.top[draws.use], draws.left[draws.use]
    assert (top >= 0).all() and (left >= 0).all() and (top + h <= img_h).all() and (left + w <= img_w).all()
    per_clip = draws.use.sum(dim=1, keepdim=True).expand_as(draws.use)[draws.use].double()
    area = h * w * per_clip / (img_h * img_w)
    slack = (h + w + 1) * per_clip / (img_h * img_w)  # the sides are rounded to whole pixels
    assert ((area >= 0.02 - slack) & (area <= 0.33 + slack)).all()
    aspect = h / w
    assert ((aspect >= 0.3 * (1 - 1 / w) - 1 / w) & (aspect <= (1 + 1 / h) / 0.3 + 1 / w)).all()
    if mode == "const":
        assert (out[changed] == 0).all()


@pytest.mark.parametrize("consistent", [True, False])
def test_train_augment_matches_jax_with_its_draws(consistent):
    """fewshot_train_augment of the JAX package on query clips against the
    port's apply step fed the JAX draws, recomputed here from the same key as
    augment.py:347-355, 383, 390 draws them, with one factor per clip or per
    frame.  fp32 at 1e-5 (the same ops in the same order)."""
    import jax
    import jax.numpy as jnp

    from clip_fsar_tpu.data import augment as jaug

    cfg = tiny_cfg("AUGMENTATION.CONSISTENT", str(consistent))
    clips = np.random.RandomState(5).randint(0, 256, size=(6, 4, 16, 16, 3)).astype(np.uint8)
    mean, std = tuple(cfg.DATA.MEAN), tuple(cfg.DATA.STD)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jaug.fewshot_train_augment(key, jnp.asarray(clips), cfg, mean, std, is_query=True))

    jc = JitterConfig.from_cfg(cfg)
    n, t = clips.shape[:2]
    shape = (n, 1, 1, 1, 1) if consistent else (n, t, 1, 1, 1)
    k = jax.random.split(jax.random.split(key)[0], 6)

    def unif(i, lo, hi, size):
        return torch.from_numpy(np.array(jax.random.uniform(k[i], size, jnp.float32, lo, hi)))

    draws = JitterDraws(
        brightness=unif(0, max(0.0, 1.0 - jc.brightness), 1.0 + jc.brightness, shape),
        contrast=unif(1, max(0.0, 1.0 - jc.contrast), 1.0 + jc.contrast, shape),
        saturation=unif(2, max(0.0, 1.0 - jc.saturation), 1.0 + jc.saturation, shape),
        hue=unif(3, -jc.hue, jc.hue, shape[:-1]),
        order=int(jax.random.randint(k[4], (), 0, 24)),
        gray=torch.from_numpy(np.array(jax.random.uniform(k[5], (n, 1, 1, 1, 1)) < jc.grayscale)),
    )
    got = standardize(color_jitter_batch(torch.from_numpy(clips).float() / 255.0, draws, jc), mean, std)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("is_query, color_aug", [(True, False), (False, True), (False, False)])
def test_train_augment_gates(is_query, color_aug):
    """Query clips are jittered unconditionally, support clips only under
    AUGMENTATION.COLOR_AUG (augment.py:410); without jitter, or without a
    generator, the clips are only normalized."""
    cfg = tiny_cfg("AUGMENTATION.COLOR_AUG", str(color_aug))
    clips = torch.from_numpy(np.random.RandomState(6).randint(0, 256, size=(3, 2, 8, 8, 3)).astype(np.uint8))
    mean, std = cfg.DATA.MEAN, cfg.DATA.STD
    plain = normalize_images(clips, mean, std)
    own = fewshot_train_augment(clips, cfg, mean, std, is_query, torch.Generator().manual_seed(0))
    assert torch.equal(own, plain) != (is_query or color_aug)
    assert torch.equal(fewshot_train_augment(clips, cfg, mean, std, is_query, None), plain)


def test_jitter_order_is_drawn_anew_on_every_call_and_repeats_with_the_seed():
    """The op order is drawn on the host (nothing is read back from the
    generator's device): one pair of generators used over many calls draws
    varying orders, a second pair of the same seed draws the same sequence,
    another seed another one."""
    from tests.torch_parity import host_reads

    jc = JitterConfig(brightness=0.4, contrast=0.4, saturation=0.4, hue=0.1)

    def orders(seed, calls=12):
        generator = torch.Generator().manual_seed(seed)
        host = host_generator(generator)
        return [draw_jitter(generator, host, 2, 3, jc).order for _ in range(calls)]

    with host_reads() as reads:
        first = orders(7)
    assert reads == []
    assert all(0 <= o < 24 for o in first) and len(set(first)) > 1
    assert orders(7) == first
    assert orders(8) != first


class _CountingSampler:
    """Deterministic stand-in sampler: the episode encodes (step, slot)."""

    def __init__(self, fail_at=None):
        self.key = None
        self.fail_at = fail_at

    def reseed_for_slot(self, step, slot):
        self.key = (step, slot)

    def sample_episode(self):
        if self.key == self.fail_at:
            raise IOError("decode failed")
        step, slot = self.key
        z = np.full((1,), step * 100 + slot, np.int32)
        return Episode(z, z, z, z, z, z)


def test_loader_is_in_step_order_for_any_worker_count():
    for workers in (1, 3):
        with EpisodeLoader(lambda i: _CountingSampler(), episodes_per_step=2, num_workers=workers, num_steps=7) as loader:
            got = [batch.support_images[:, 0].tolist() for batch in loader]
        assert got == [[s * 100, s * 100 + 1] for s in range(7)]
    # a resumed run continues the stream: global steps 5, 6, 7
    with EpisodeLoader(lambda i: _CountingSampler(), episodes_per_step=2, num_workers=2, num_steps=3, start_step=5) as loader:
        assert [batch.support_images[:, 0].tolist() for batch in loader] == [[s * 100, s * 100 + 1] for s in (5, 6, 7)]


def test_loader_reraises_a_worker_error():
    with EpisodeLoader(lambda i: _CountingSampler(fail_at=(2, 1)), episodes_per_step=2, num_workers=2, num_steps=5) as loader:
        with pytest.raises(RuntimeError, match="episode worker failed"):
            list(loader)


def test_episode_stack_and_move():
    z = np.arange(6, dtype=np.int32)
    batch = stack_episodes([Episode(z, z, z, z, z, z), Episode(z + 1, z, z, z, z, z)])
    assert batch.support_images.shape == (2, 6) and batch.batch_class_list is None
    moved = batch.to("cpu")
    assert isinstance(moved.support_images, torch.Tensor) and moved.support_images.dtype == torch.int32
    np.testing.assert_array_equal(moved.support_images.numpy(), batch.support_images)
    assert moved.batch_class_list is None
