"""The port's parallel/ (torch.distributed) against the JAX package's on
the CPU:

  - pad_batch_to, process_batch_slice, local_batch_size and
    mesh_from_config against JAX: equal bytes, equal errors, and the
    stated difference that the port's default mesh is the process group's
    world where JAX's is the process's devices;
  - in one gloo group of 4 ranks: sharded_conv2d (3x3, 5x5, two stacked)
    and halo_exchange against JAX's parallel/spatial.py on a 4-device
    sub-mesh and against an unsharded conv, at JAX's own tolerances
    (tests/test_spatial.py); predict_tiled_sharded on 128 x 192 at tile
    64 / overlap 32 (15 tiles, not a multiple of 4) against JAX's and the
    port's predict_tiled; the mesh, process_batch_slice, shard_batch and
    replicated in the group;
  - a world of one: initialize forms nothing, halo_exchange's halos are
    zeros as JAX's on one device; a named group that cannot form raises;
    BatchNorm2d takes the library's batch norm there, and the global
    statistics' path forced by global_batch_stats() equals it in float64.

JAX is imported inside the tests: the spawned ranks import this module and
need torch only.
"""
import contextlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_gloo
from unet_watermark_tpu_torch.configs import get_cfg_defaults
from unet_watermark_tpu_torch.inference.tiled import (plan_tiles,
                                                      predict_tiled,
                                                      predict_tiled_sharded)
from unet_watermark_tpu_torch.parallel import distributed as tdist
from unet_watermark_tpu_torch.parallel import mesh as tmesh
from unet_watermark_tpu_torch.parallel import spatial as tspatial

WORLD = 4
TILE, OVERLAP = 64, 32


def _conv_inputs():
    """The inputs of tests/test_spatial.py: (x, kernels) for 3x3, 5x5 and
    the two stacked convs."""
    r0, r1, r2 = (np.random.default_rng(i) for i in range(3))
    return {
        "3x3": (r0.normal(size=(2, 64, 32, 4)).astype(np.float32),
                [r0.normal(size=(3, 3, 4, 6)).astype(np.float32)]),
        "5x5": (r1.normal(size=(1, 64, 16, 3)).astype(np.float32),
                [r1.normal(size=(5, 5, 3, 2)).astype(np.float32)]),
        "stacked": (r2.normal(size=(1, 64, 16, 3)).astype(np.float32),
                    [r2.normal(size=(3, 3, 3, 5)).astype(np.float32),
                     r2.normal(size=(3, 3, 5, 2)).astype(np.float32)]),
    }


def _image():
    return np.random.default_rng(1).random((128, 192, 3)).astype(np.float32)


def _forward(x):
    """tests/test_tiled.py's forward: twice the channel sum."""
    return x.sum(-1, keepdim=True) * 2.0


def _halo_input():
    return np.arange(2 * 64 * 8, dtype=np.float32).reshape(2, 64, 8, 1)


def _group_checks(rank, world):
    """Everything the 4-rank group computes, returned to the parent."""
    mesh = tmesh.mesh_from_config(get_cfg_defaults())
    out = {"mesh_shape": mesh.shape, "mesh_ranks": mesh.devices.tolist(),
           "slice_aware": tdist.make_slice_aware_mesh().devices.tolist(),
           "batch_slice": tdist.process_batch_slice(16)}
    try:
        tdist.process_batch_slice(15)
    except ValueError as e:
        out["batch_slice_error"] = str(e)
    cfg = get_cfg_defaults()
    cfg.PARALLEL.MESH_SHAPE, cfg.PARALLEL.MESH_AXES = [2, 2], ["data", "sp"]
    grid = tmesh.mesh_from_config(cfg)
    out["grid"] = (grid.shape, grid.devices.tolist(), grid.coords())
    batch = {"image": np.arange(8 * 3).reshape(8, 3),
             "valid": np.ones(8, np.float32)}
    out["shard_batch"] = tmesh.shard_batch(batch, mesh)
    out["shard_batch_2d"] = tmesh.shard_batch(
        {"x": np.arange(4 * 4).reshape(4, 4)},
        tmesh.batch_sharding(grid, "data", "sp"))
    t = torch.full((3,), float(rank))
    lin = torch.nn.Linear(2, 2)
    torch.nn.init.constant_(lin.weight, float(rank))
    tmesh.replicated({"t": t, "m": [lin.weight]}, mesh)
    tmesh.replicated(lin, mesh)
    out["replicated"] = (t.tolist(), lin.weight.detach().tolist())

    convs = {}
    for name, (x, ks) in _conv_inputs().items():
        y = tspatial.shard_spatial(x, mesh)
        for k in ks:
            y = tspatial.sharded_conv2d(y, k, mesh)
        convs[name] = (y, tspatial.gather_spatial(y, mesh))
    out["convs"] = convs
    xs = tspatial.shard_spatial(_halo_input(), mesh)
    halo = tspatial.halo_exchange(xs, 2, mesh)
    out["halo"] = (halo, tspatial.gather_spatial(halo, mesh))
    out["tiled"] = predict_tiled_sharded(
        _forward, torch.from_numpy(_image()), mesh, tile=TILE,
        overlap=OVERLAP)
    out["tiled_batch3"] = predict_tiled_sharded(
        _forward, torch.from_numpy(_image()), mesh, tile=TILE,
        overlap=OVERLAP, batch=3)
    return out


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    return torch_gloo.run(_group_checks, WORLD,
                          tmp_path_factory.mktemp("group"), timeout=240)


@pytest.fixture(scope="module")
def jax_mesh4():
    import jax
    from unet_watermark_tpu.parallel import make_mesh

    return make_mesh(devices=jax.devices()[:WORLD])


def _unsharded(x, kernels):
    y = torch.from_numpy(x)
    for k in kernels:
        kt = torch.from_numpy(k).permute(3, 2, 0, 1)
        y = F.conv2d(y.permute(0, 3, 1, 2), kt,
                     padding=(k.shape[0] // 2, k.shape[1] // 2)
                     ).permute(0, 2, 3, 1)
    return y.numpy()


# ---------------------------------------------------------------------------
# single-process helpers against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,n", [(3, 4), (4, 4), (1, 6), (5, 8)])
def test_pad_batch_to_matches_jax(b, n):
    from unet_watermark_tpu.parallel import pad_batch_to as jpad

    rng = np.random.default_rng(b * 10 + n)
    batch = {"image": rng.integers(0, 255, (b, 8, 8, 3), dtype=np.uint8),
             "mask": (rng.random((b, 8, 8, 1)) > 0.5).astype(np.uint8),
             "extra": [rng.random((b, 2)).astype(np.float32)]}
    got, gmask = tmesh.pad_batch_to(batch, n)
    want, wmask = jpad(batch, n)
    assert gmask.dtype == wmask.dtype == np.float32
    assert gmask.tobytes() == wmask.tobytes()
    for k in ("image", "mask"):
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes(), k
    assert got["extra"][0].tobytes() == want["extra"][0].tobytes()


def test_batch_slice_and_local_batch_size_match_jax():
    import jax
    from unet_watermark_tpu.parallel import (local_batch_size,
                                             make_mesh,
                                             process_batch_slice)

    assert tdist.process_batch_slice(16) == process_batch_slice(16)
    assert tdist.process_batch_slice(7) == process_batch_slice(7)
    for n in (1, 2, 4, 8):
        jm = make_mesh(devices=jax.devices()[:n])
        tm = tmesh.make_mesh(devices=list(range(n)))
        assert tm.shape == dict(jm.shape) and tm.size == jm.devices.size
        for gb in (8, 16, 24):
            assert tmesh.local_batch_size(gb, tm) == \
                local_batch_size(gb, jm)
        if n > 1:
            with pytest.raises(ValueError) as want:
                local_batch_size(8 * n + 1, jm)
            with pytest.raises(ValueError) as got:
                tmesh.local_batch_size(8 * n + 1, tm)
            assert str(got.value) == str(want.value)


def test_mesh_from_config_matches_jax_and_spans_the_world():
    """JAX's default mesh spans the process's 8 devices, the port's the
    group's world (a world of one here): the stated difference. A shape
    whose product is not the size raises ValueError in both."""
    from unet_watermark_tpu.configs import get_cfg_defaults as jdefaults
    from unet_watermark_tpu.parallel import mesh_from_config as jfrom

    cfg, jcfg = get_cfg_defaults(), jdefaults()
    assert tmesh.mesh_from_config(cfg).shape == {"data": 1}
    assert dict(jfrom(jcfg).shape) == {"data": 8}
    for shape in ([3], [2, 3]):
        cfg.PARALLEL.MESH_SHAPE = jcfg.PARALLEL.MESH_SHAPE = shape
        cfg.PARALLEL.MESH_AXES = jcfg.PARALLEL.MESH_AXES = \
            ["data", "spatial"][:len(shape)]
        with pytest.raises(ValueError):
            jfrom(jcfg)
        with pytest.raises(ValueError):
            tmesh.mesh_from_config(cfg)
    cfg.PARALLEL.MESH_SHAPE, jcfg.PARALLEL.MESH_SHAPE = [1, 1], [8, 1]
    tm, jm = tmesh.mesh_from_config(cfg), jfrom(jcfg)
    assert tm.axis_names == tuple(jm.axis_names) == ("data", "spatial")
    assert list(tm.shape) == list(jm.shape)


def test_world_of_one_forms_nothing_and_halos_are_zero():
    import jax
    import jax.numpy as jnp
    from unet_watermark_tpu.parallel import make_mesh
    from unet_watermark_tpu.parallel.spatial import (halo_exchange,
                                                     shard_spatial)

    assert tdist.initialize(device="cpu") == (0, 1)
    assert not tdist.in_group()
    x = _halo_input()
    got = tspatial.halo_exchange(torch.from_numpy(x), 3, tmesh.make_mesh())
    jm = make_mesh(devices=jax.devices()[:1])
    want = np.asarray(halo_exchange(shard_spatial(jnp.asarray(x), jm), 3,
                                    jm))
    assert got.shape == want.shape == (2, 70, 8, 1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[:, :3].any() and not got[:, -3:].any()
    img = torch.from_numpy(_image())
    np.testing.assert_array_equal(
        predict_tiled_sharded(_forward, img, tmesh.make_mesh(), TILE,
                              OVERLAP, batch=4).numpy(),
        predict_tiled(_forward, img, TILE, OVERLAP, batch=4).numpy())


def test_a_named_group_that_cannot_form_raises(tmp_path):
    """JAX logs and carries on as one process; the port raises (a stated
    difference), since N copies would train alone."""
    with pytest.raises(RuntimeError, match="did not form"):
        tdist.initialize(f"file://{tmp_path / 'store'}", 2, 0,
                         device="cpu", timeout_s=2)
    assert not tdist.in_group()


def test_global_batch_stats_equal_the_library_batch_norm_in_float64():
    """A world of one takes the library's batch norm; global_batch_stats()
    forces the path of a group of several ranks (flax's sums), which in
    float64 gives the same output, gradients and running buffers."""
    from unet_watermark_tpu_torch.models import encoders

    x = torch.from_numpy(np.random.default_rng(5).normal(
        3.0, 2.0, (4, 6, 5, 7)))
    g = torch.from_numpy(np.random.default_rng(6).normal(size=x.shape))
    got = []
    for force in (False, True):
        bn = encoders.BatchNorm2d(6).double().train()
        with torch.no_grad():
            bn.weight.uniform_(0.5, 1.5, generator=torch.Generator()
                               .manual_seed(1))
        xi = x.clone().requires_grad_(True)
        calls = []
        forward = bn._global_forward
        bn._global_forward = lambda t: calls.append(1) or forward(t)
        ctx = encoders.global_batch_stats() if force \
            else contextlib.nullcontext()
        with ctx:
            y = bn(xi)
            (y * g).sum().backward()
        assert len(calls) == force and not encoders._FORCE_GLOBAL
        got.append([y.detach(), xi.grad, bn.weight.grad, bn.bias.grad,
                    bn.running_mean, bn.running_var])
    for a, b in zip(*got):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-12)


# ---------------------------------------------------------------------------
# the 4-rank gloo group
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["3x3", "5x5", "stacked"])
def test_sharded_conv_matches_jax_and_unsharded(group, jax_mesh4, name):
    import jax.numpy as jnp
    from unet_watermark_tpu.parallel.spatial import (shard_spatial,
                                                     sharded_conv2d)

    x, kernels = _conv_inputs()[name]
    tol = 1e-4 if name == "stacked" else 1e-5
    y = shard_spatial(jnp.asarray(x), jax_mesh4)
    for k in kernels:
        y = sharded_conv2d(y, jnp.asarray(k), jax_mesh4)
    want = np.asarray(y)
    dense = _unsharded(x, kernels)
    h = x.shape[1] // WORLD
    for rank, res in enumerate(group):
        local, whole = res["convs"][name]
        assert local.shape == (x.shape[0], h, x.shape[2],
                               kernels[-1].shape[-1])
        np.testing.assert_allclose(local.numpy(),
                                   want[:, rank * h:(rank + 1) * h],
                                   rtol=tol, atol=tol)
        np.testing.assert_allclose(whole.numpy(), want, rtol=tol, atol=tol)
        np.testing.assert_allclose(whole.numpy(), dense, rtol=tol, atol=tol)


def test_halo_exchange_matches_jax(group, jax_mesh4):
    import jax.numpy as jnp
    from unet_watermark_tpu.parallel.spatial import (halo_exchange,
                                                     shard_spatial)

    x = _halo_input()
    want = np.asarray(halo_exchange(shard_spatial(jnp.asarray(x),
                                                  jax_mesh4), 2, jax_mesh4))
    assert want.shape == (2, 64 + WORLD * 4, 8, 1)
    for rank, res in enumerate(group):
        local, whole = res["halo"]
        assert local.shape == (2, 16 + 4, 8, 1)
        np.testing.assert_array_equal(whole.numpy(), want)
        # the neighbours' rows, zeros at the image's top and bottom
        top = x[:, rank * 16 - 2:rank * 16] if rank else 0 * x[:, :2]
        bottom = x[:, (rank + 1) * 16:(rank + 1) * 16 + 2] \
            if rank < WORLD - 1 else 0 * x[:, :2]
        np.testing.assert_array_equal(local[:, :2].numpy(), top)
        np.testing.assert_array_equal(local[:, -2:].numpy(), bottom)


def test_predict_tiled_sharded_matches_jax_and_unsharded(group, jax_mesh4):
    import jax.numpy as jnp
    from unet_watermark_tpu.inference.tiled import \
        predict_tiled_sharded as jsharded

    img = _image()

    def jforward(x):
        return jnp.sum(x, axis=-1, keepdims=True) * 2.0

    want = np.asarray(jsharded(jforward, jnp.asarray(img), jax_mesh4,
                               tile=TILE, overlap=OVERLAP))
    plain = predict_tiled(_forward, torch.from_numpy(img), TILE, OVERLAP,
                          batch=4).numpy()
    assert len(plan_tiles(128, 192, TILE, OVERLAP)) % WORLD  # padded
    for res in group:
        for key in ("tiled", "tiled_batch3"):
            got = res[key].numpy()
            assert got.shape == (128, 192, 1) and got.dtype == np.float32
            np.testing.assert_allclose(got, want, atol=1e-5)
            np.testing.assert_allclose(got, plain, atol=1e-5)
            np.testing.assert_array_equal(got, group[0]["tiled"].numpy())


def test_group_mesh_slices_and_placement(group):
    for rank, res in enumerate(group):
        assert res["mesh_shape"] == {"data": WORLD}
        assert res["mesh_ranks"] == list(range(WORLD))
        assert res["slice_aware"] == list(range(WORLD))
        assert res["batch_slice"] == (4, 4 * rank, 4 * rank + 4)
        assert res["batch_slice_error"] == \
            "global batch 15 not divisible by process count 4"
        shape, ranks, coords = res["grid"]
        assert shape == {"data": 2, "sp": 2} and ranks == [[0, 1], [2, 3]]
        assert coords == {"data": rank // 2, "sp": rank % 2}
        sb = res["shard_batch"]
        assert sb["image"].tolist() == \
            np.arange(24).reshape(8, 3)[2 * rank:2 * rank + 2].tolist()
        assert sb["valid"].shape == (2,)
        d, s = rank // 2, rank % 2
        assert res["shard_batch_2d"]["x"].tolist() == np.arange(16).reshape(
            4, 4)[2 * d:2 * d + 2, 2 * s:2 * s + 2].tolist()
        # rank 0's values on every rank
        assert res["replicated"] == ([0.0] * 3, [[0.0, 0.0], [0.0, 0.0]])
