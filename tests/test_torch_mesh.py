"""The port's data-parallel mesh (clip_fsar_torch/parallel/mesh.py) against
the JAX package's (clip_fsar_tpu/parallel/mesh.py), with no process group:
the mesh arithmetic at 1, 2, 4 and 8 ranks against a 1-D JAX mesh of as
many of the conftest's 8 CPU devices, the loader's episode slots, the
environment a run joins its process group from, the TPU.MESH keys the port
refuses (F7), and the retry around uploads."""

import datetime
import os
from unittest import mock

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from clip_fsar_torch.data.loader import build_few_shot_loader
from clip_fsar_torch.parallel import mesh
from clip_fsar_torch.train import loop
from tests.torch_parity import tiny_cfg

torch.set_num_threads(2)

_ENV = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS", "WORLD_SIZE", "JAX_NUM_PROCESSES", "RANK", "JAX_PROCESS_ID",
        "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


def _port_mesh(world: int, rank: int) -> mesh.Mesh:
    return mesh.Mesh(world=world, rank=rank, local_rank=0, data=world, backend="gloo", device=torch.device("cpu"))


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_mesh_arithmetic_matches_jax(world):
    """round_to_data_mesh, check_batch_divisible and each rank's
    local_episode_range against the JAX functions on a 1-D mesh of ``world``
    devices: rank r owns the rows JAX's data sharding puts on device r."""
    from clip_fsar_tpu.parallel import mesh as jmesh

    jm = jmesh.build_mesh(None, devices=jax.devices()[:world])
    for e in range(1, 19):
        assert mesh.round_to_data_mesh(e, _port_mesh(world, 0)) == jmesh.round_to_data_mesh(e, jm), e
        assert mesh.data_axis_size(_port_mesh(world, 0)) == jmesh.data_axis_size(jm)
        try:
            jmesh.check_batch_divisible(e, jm)
            jax_ok = True
        except ValueError as err:
            jax_ok, jax_msg = False, str(err)
        if jax_ok:
            mesh.check_batch_divisible(e, _port_mesh(world, 0))
            rows = {dev.id: idx[0] for dev, idx in jmesh.data_sharding(jm).devices_indices_map((e,)).items()}
            for r, dev in enumerate(jm.devices.reshape(-1)):
                want = (rows[dev.id].start or 0, e if rows[dev.id].stop is None else rows[dev.id].stop)
                assert mesh.local_episode_range(e, _port_mesh(world, r)) == want, (e, r)
        else:
            with pytest.raises(ValueError) as got:
                mesh.check_batch_divisible(e, _port_mesh(world, 0))
            assert str(got.value) == jax_msg
            if world > 1:
                with pytest.raises(ValueError):
                    mesh.local_episode_range(e, _port_mesh(world, 1))
    assert mesh.local_episode_range(7, _port_mesh(1, 0)) == jmesh.local_episode_range(7, jm) == (0, 7)


def test_episode_range_slices_the_global_batch():
    """A loader with episode_range (lo, hi) emits exactly rows lo:hi of the
    full batch, byte for byte, as the JAX loader's does (the property the
    ranks' feeding relies on; tests/test_multihost.py:42-56)."""
    from clip_fsar_tpu.data.loader import build_few_shot_loader as jax_loader

    cfg = tiny_cfg("TRAIN.ENABLE", "True")
    with build_few_shot_loader(cfg, "train", num_steps=2, episodes_per_step=4) as loader:
        full = list(loader)
    with build_few_shot_loader(cfg, "train", num_steps=2, episodes_per_step=4, start_step=0, episode_range=(1, 3)) as loader:
        part = list(loader)
    with jax_loader(cfg, "train", num_steps=2, episodes_per_step=4, episode_range=(1, 3)) as loader:
        jax_part = list(loader)
    assert len(part) == 2
    for fb, pb, jb in zip(full, part, jax_part):
        for name in ("support_images", "target_images", "support_labels", "target_labels", "real_support_labels", "real_target_labels",
                     "batch_class_list"):
            np.testing.assert_array_equal(getattr(pb, name), getattr(fb, name)[1:3], err_msg=name)
            np.testing.assert_array_equal(getattr(pb, name), np.asarray(getattr(jb, name)), err_msg=name)


def test_empty_episode_range_yields_zero_row_batches():
    """(0, 0) gives [0, ...] batches with the step batch's trailing shapes and
    dtypes (tests/test_multihost.py:59-70)."""
    cfg = tiny_cfg("TRAIN.ENABLE", "True")
    with build_few_shot_loader(cfg, "train", num_steps=1, episodes_per_step=4) as loader:
        full = next(iter(loader))
    with build_few_shot_loader(cfg, "train", num_steps=2, episodes_per_step=4, episode_range=(0, 0)) as loader:
        batches = list(loader)
    assert len(batches) == 2
    for b in batches:
        for name in ("support_images", "target_images", "target_labels", "batch_class_list"):
            got, want = getattr(b, name), getattr(full, name)
            assert got.shape == (0,) + want.shape[1:] and got.dtype == want.dtype, name


class _FakeGroup:
    """torch.distributed's init and queries, recorded instead of joined."""

    def __init__(self, monkeypatch):
        self.calls = []
        self.devices = []
        monkeypatch.setattr(dist, "init_process_group", self.init)
        monkeypatch.setattr(dist, "is_initialized", lambda: bool(self.calls))
        monkeypatch.setattr(dist, "get_rank", lambda group=None: self.calls[-1]["rank"])
        monkeypatch.setattr(dist, "get_world_size", lambda group=None: self.calls[-1]["world_size"])
        monkeypatch.setattr(torch.cuda, "set_device", self.devices.append)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)

    def init(self, backend, **kwargs):
        self.calls.append({"backend": backend, **kwargs})


def _jax_join(env: dict, pai: bool):
    """What the JAX package's maybe_init_distributed does in ``env``: its
    return value and its jax.distributed.initialize arguments, or the error."""
    from clip_fsar_tpu.parallel import mesh as jmesh

    calls = []
    cfg = tiny_cfg("PAI", str(pai))
    with mock.patch.dict(os.environ, env), mock.patch.object(jax.distributed, "initialize", lambda **kw: calls.append(kw)), \
            mock.patch.object(jax.distributed, "is_initialized", lambda: False, create=True):
        try:
            return jmesh.maybe_init_distributed(cfg), calls
        except RuntimeError as err:
            return err, calls


@pytest.mark.parametrize("env, pai", [
    ({}, False),
    ({"WORLD_SIZE": "2", "RANK": "1"}, False),  # no rendezvous address, PAI off: one process, as in JAX
    ({"WORLD_SIZE": "2", "RANK": "1"}, True),  # PAI on and no address: refused, as in JAX
    ({"WORLD_SIZE": "2", "RANK": "1", "JAX_COORDINATOR_ADDRESS": "10.0.0.7:4321"}, False),
    ({"JAX_NUM_PROCESSES": "4", "JAX_PROCESS_ID": "3", "COORDINATOR_ADDRESS": "host-a:1234"}, True),
    ({"WORLD_SIZE": "1", "RANK": "0", "JAX_COORDINATOR_ADDRESS": "10.0.0.7:4321"}, False),
])
def test_maybe_init_distributed_reads_the_jax_environment(monkeypatch, env, pai):
    """The JAX package's variable names and PAI: the port joins where JAX
    initializes (same address, world and rank), stays one process where
    JAX does, and raises the same error where JAX does."""
    for name in _ENV:
        monkeypatch.delenv(name, raising=False)
    want, jax_calls = _jax_join(env, pai)
    fake = _FakeGroup(monkeypatch)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    cfg = tiny_cfg("PAI", str(pai))
    if isinstance(want, RuntimeError):
        with pytest.raises(RuntimeError, match="no coordinator address"):
            mesh.maybe_init_distributed(cfg, "gloo")
        assert str(want).startswith("multi-process run requested (WORLD_SIZE>1 with PAI=true) but no coordinator address")
        assert not fake.calls
        return
    assert mesh.maybe_init_distributed(cfg, "gloo") is want
    if not want:
        assert not fake.calls and not jax_calls
        return
    (call,), (jcall,) = fake.calls, jax_calls
    assert call["init_method"] == f"tcp://{jcall['coordinator_address']}"
    assert (call["world_size"], call["rank"]) == (jcall["num_processes"], jcall["process_id"])
    assert call["backend"] == "gloo" and call["device_id"] is None and not fake.devices
    assert isinstance(call["timeout"], datetime.timedelta) and call["timeout"] == mesh.TIMEOUT
    assert (cfg.SHARD_ID, cfg.NUM_SHARDS) == (jcall["process_id"], jcall["num_processes"])


def test_maybe_init_distributed_reads_torchrun_and_sets_the_card(monkeypatch):
    """torchrun's MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE / LOCAL_RANK:
    the rank's card is set before NCCL's group is made and bound to it; a
    process that is already a rank (a caller made the group) is left as it
    is, with its SHARD_ID / NUM_SHARDS set; the CLI's device picks the
    backend."""
    for name in _ENV:
        monkeypatch.delenv(name, raising=False)
    fake = _FakeGroup(monkeypatch)
    for name, value in {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "29517", "WORLD_SIZE": "8", "RANK": "6", "LOCAL_RANK": "2"}.items():
        monkeypatch.setenv(name, value)
    cfg = tiny_cfg()
    assert mesh.maybe_init_distributed(cfg, mesh.backend_for(None)) is True
    (call,) = fake.calls
    assert (call["backend"], call["init_method"], call["world_size"], call["rank"]) == ("nccl", "tcp://127.0.0.1:29517", 8, 6)
    assert fake.devices == [2] and call["device_id"] == torch.device("cuda", 2)
    assert mesh.local_rank() == 2 and (cfg.SHARD_ID, cfg.NUM_SHARDS) == (6, 8)
    again = tiny_cfg()
    assert mesh.maybe_init_distributed(again, "nccl") is False and len(fake.calls) == 1
    assert (again.SHARD_ID, again.NUM_SHARDS) == (6, 8)
    assert (mesh.backend_for("cpu"), mesh.backend_for("cuda"), mesh.backend_for(torch.device("cpu"))) == ("gloo", "nccl", "gloo")


@pytest.mark.parametrize("key, error, match", [
    ("MODEL", ValueError, "TPU.MESH.MODEL=2 must divide the device count 1"),
    ("DATA", ValueError, "TPU.MESH.DATA=4 but only 1 devices present"),
])
@pytest.mark.parametrize("runner", ["train", "test"])
def test_mesh_keys_the_port_cannot_give_raise_before_any_work(key, error, match, runner):
    """F7: the port once ran on one card whatever TPU.MESH asked.  A model
    axis (MODEL > 1) that does not divide the one process, and DATA above the
    world size, raise the JAX package's ValueError (mesh.py:80-81, 88-89,
    held to JAX's own message below), before any model is built."""
    from clip_fsar_tpu.parallel import mesh as jmesh

    cfg = tiny_cfg("TRAIN.ENABLE", "True", "TRAIN.NUM_TRAIN_TASKS", "1")
    cfg.TPU.MESH[key] = 2 if key == "MODEL" else 4  # base.yaml has no MODEL key: the JAX builder reads it where set
    with pytest.raises(ValueError, match=match):
        jmesh.build_mesh(cfg, devices=jax.devices()[:1])
    with mock.patch.object(loop, "build_few_shot_model", side_effect=AssertionError("a model was built")):
        with pytest.raises(error, match=match):
            (loop.train_few_shot if runner == "train" else loop.test_few_shot)(cfg, device="cpu")


def test_data_axis_must_be_the_world():
    """DATA -1 or the world size runs on every rank; DATA below the world
    size raises and says to launch that many processes (a process group
    does not shrink: the port's form of JAX's "use fewer devices")."""
    for data in (-1, 4):
        assert mesh.check_mesh_cfg(tiny_cfg("TPU.MESH.DATA", str(data)), 4) == 4
    with pytest.raises(ValueError, match="launch 2 processes"):
        mesh.check_mesh_cfg(tiny_cfg("TPU.MESH.DATA", "2"), 4)
    built = mesh.build_mesh(tiny_cfg(), "cpu")
    assert (built.world, built.rank, built.local_rank, built.data, built.backend, built.device) == (1, 0, 0, 1, None, torch.device("cpu"))


@pytest.mark.parametrize("data, model, world, want", [
    (-1, 2, 4, 2), (2, 2, 4, 2), (-1, 2, 2, 1), (1, 2, 4, "launch 2 processes"), (4, 2, 4, "mesh 4x2 needs 8 devices, have 4"),
    (-1, 3, 4, "TPU.MESH.MODEL=3 must divide the device count 4"),
])
def test_data_times_model_must_be_the_world(data, model, world, want):
    """With a model axis the grid is DATA x MODEL ranks, DATA -1 meaning
    world / MODEL: a grid of the world's size runs (its data axis returned),
    a larger one or a MODEL that does not divide raises the JAX package's
    ValueError, and a smaller one raises with the number of processes to
    launch (a process group does not shrink)."""
    cfg = tiny_cfg("TPU.MESH", f"{{DATA: {data}, MODEL: {model}}}")
    if isinstance(want, int):
        assert mesh.check_mesh_cfg(cfg, world) == want
    else:
        with pytest.raises(ValueError, match=want):
            mesh.check_mesh_cfg(cfg, world)


def test_collectives_are_the_identity_without_a_process_group():
    """With no process group a run is the one-process run it was: nothing
    is reduced, gathered, broadcast or waited for."""
    assert not mesh.distributed() and mesh.world_size() == 1 and mesh.rank() == 0 and mesh.host_leader()
    x = torch.arange(6.0).reshape(3, 2)
    flags = torch.tensor([True, False])
    assert mesh.all_gather_rows(x) is x and mesh.all_gather_rows(flags) is flags
    y = x.clone()
    mesh.all_reduce_mean([y])
    assert torch.equal(y, x)
    lin = torch.nn.Linear(2, 2)
    lin.weight.grad = torch.ones(2, 2)
    before = {k: v.clone() for k, v in lin.state_dict().items()}
    mesh.all_reduce_grads(lin.parameters())
    mesh.broadcast_module(lin)
    mesh.barrier()
    assert torch.equal(lin.weight.grad, torch.ones(2, 2)) and all(torch.equal(v, before[k]) for k, v in lin.state_dict().items())


def test_buckets_split_by_dtype_and_size():
    """The flat buckets of the gradient all-reduce: runs of one dtype, at
    most the limit each unless one tensor alone is larger."""
    ts = [torch.zeros(10), torch.zeros(10), torch.zeros(30), torch.zeros(5, dtype=torch.float64), torch.zeros(2)]
    assert list(mesh._buckets(ts, limit=100)) == [[0, 1], [2], [3], [4]]
    assert list(mesh._buckets(ts, limit=1 << 20)) == [[0, 1, 2], [3], [4]]


def test_retry_transient_backs_off_like_jax(monkeypatch):
    """Out-of-device-memory errors are retried with the JAX package's
    backoff (5, 10, 20 s; held to its delays on its RESOURCE_EXHAUSTED
    errors), the last one re-raised; any other error is not retried."""
    from clip_fsar_tpu.parallel import mesh as jmesh

    sleeps = []
    monkeypatch.setattr(mesh.time, "sleep", sleeps.append)  # one time module: the JAX package's sleeps land here too

    def run(retry, fail: int, error):
        """(result or the error raised, calls made, sleeps taken) of ``retry`` on a stub that fails ``fail`` times."""
        calls = [0]

        def fn():
            calls[0] += 1
            if calls[0] <= fail:
                raise error
            return calls[0]

        sleeps.clear()
        try:
            got = retry(fn, "upload")
        except Exception as err:  # noqa: BLE001 -- the error is the result under test
            got = err
        return got, calls[0], list(sleeps)

    oom, exhausted = torch.OutOfMemoryError("CUDA out of memory"), RuntimeError("RESOURCE_EXHAUSTED: out of memory")
    assert run(mesh.retry_transient, 2, oom) == (3, 3, [5.0, 10.0]) == run(jmesh.retry_transient, 2, exhausted)
    assert run(mesh.retry_transient, 9, oom) == (oom, 4, [5.0, 10.0, 20.0])
    assert run(jmesh.retry_transient, 9, exhausted) == (exhausted, 4, [5.0, 10.0, 20.0])
    other = ValueError("not a memory error")
    assert run(mesh.retry_transient, 1, other) == (other, 1, [])
