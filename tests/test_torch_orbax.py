"""The JAX package's orbax checkpoints read by the port (training/ocdbt.py,
training/checkpoint.py, utils/shipping.load_variables) against orbax and
tensorstore themselves, on stores and checkpoints written here:

  - the OCDBT reader's list() and read() against tensorstore's kvstore on
    stores of one key and many, inline and indirect values, small B+tree
    nodes (interior levels), many versions (a version tree), a deleted
    key range and orbax's per-process layout; a bad CRC-32C raises, and
    so do a numbered manifest and orbax without OCDBT;
  - zarr v2 arrays of every dtype orbax writes, chunked smaller than the
    array with chunks missing, zstd-compressed or not, against
    tensorstore's zarr driver;
  - JAX's save_checkpoint of a Unet/resnet34 TrainState (the shipped
    weights) for Adam (clip
    on), AdamW (clip off) and SGD (clip on): the port's restore_raw equal
    to JAX's array for array; restore_checkpoint mapping the optax state
    onto the port's Optimizer, a mismatched optimizer or a slim best save
    starting it fresh as JAX's fallback does; load_variables equal to
    JAX's on a .npz, a tree/ directory and a bare orbax directory;
    WatermarkPredictor's mask from a JAX checkpoint directory equal to
    JAX's (engines.load_lama on train_inpaint's orbax output:
    tests/test_torch_train_inpaint.py; train --resume from a JAX
    checkpoint: tests/test_torch_train_loop.py).

Tolerance: none (arrays, masks and bytes compared exactly).
"""
import importlib
import logging

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch

from unet_watermark_tpu.configs import get_cfg_defaults as jax_defaults
from unet_watermark_tpu.models import create_model_from_config as jax_model
from unet_watermark_tpu.models import init_model as jax_init_model
from unet_watermark_tpu.inference.predict import \
    WatermarkPredictor as JaxPredictor
from unet_watermark_tpu.training import checkpoint as jck
from unet_watermark_tpu.utils import shipping as jship
from unet_watermark_tpu_torch.configs import get_cfg_defaults
from unet_watermark_tpu_torch.inference.predict import WatermarkPredictor
from unet_watermark_tpu_torch.models.convert import flax_name, to_flax
from unet_watermark_tpu_torch.training import checkpoint as tck
from unet_watermark_tpu_torch.training import ocdbt
from unet_watermark_tpu_torch.training import train as ttrain
from unet_watermark_tpu_torch.utils import image_io
from unet_watermark_tpu_torch.utils import shipping as tship
from unet_watermark_tpu_torch.utils.synthetic import watermarked_images

jtrain = importlib.import_module("unet_watermark_tpu.training.train")
SIZE = 32


def _keystr(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", getattr(
        p, "name", p)))) for p in path)


def _flat(tree) -> dict:
    """A JAX tree as {"/".join(key path): array} (dict keys, sequence
    indices and named-tuple fields, as orbax names them), None leaves
    dropped."""
    return {_keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# -- the OCDBT key-value store ------------------------------------------------

def _kvstore(path, **config):
    return ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/",
                            "config": config}).result()


def _fill(kv, rng, writes, keys=50, max_len=80, transaction=False):
    for _ in range(writes):
        k = f"grp{rng.integers(0, 3)}/key{rng.integers(0, keys):03d}/x"
        kv.write(k.encode(), rng.bytes(int(rng.integers(0, max_len)))
                 ).result()


LAYOUTS = ("one_key", "small_nodes", "all_indirect", "versions",
           "deleted_range", "large_values", "orbax")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_ocdbt_matches_tensorstore(tmp_path, layout):
    rng = np.random.default_rng(LAYOUTS.index(layout))
    root = tmp_path / layout
    if layout == "one_key":
        _kvstore(root).write(b"only", b"value").result()
    elif layout == "small_nodes":  # B+tree of several levels
        _fill(_kvstore(root, max_decoded_node_bytes=300,
                       max_inline_value_bytes=30), rng, 200)
    elif layout == "all_indirect":
        _fill(_kvstore(root, max_inline_value_bytes=0), rng, 40)
    elif layout == "versions":  # > 16 commits: a version tree
        _fill(_kvstore(root, version_tree_arity_log2=2), rng, 60)
    elif layout == "deleted_range":
        kv = _kvstore(root, max_decoded_node_bytes=400)
        _fill(kv, rng, 40)
        kv.delete_range(ts.KvStore.KeyRange(b"grp1", b"grp2")).result()
    elif layout == "large_values":  # values of 1 MB, indirect
        kv = _kvstore(root)
        for i in range(3):
            kv.write(f"big{i}".encode(), rng.bytes(1 << 20)).result()
    else:
        ckpt = ocp.StandardCheckpointer()
        ckpt.save(root, {"a": {"w": rng.standard_normal((40, 30)).astype(
            np.float32)}, "n": np.int32(3), "e": None})
        ckpt.wait_until_finished()
    ref = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/"}
                          ).result()
    keys = sorted(ref.list().result())
    store = ocdbt.OcdbtStore(str(root))
    assert store.list() == keys and keys
    for k in keys:
        assert store.read(k) == ref.read(k).result().value, k
    assert store.read(b"no such key") is None


def test_bad_crc_raises(tmp_path):
    """A flipped byte in the manifest's body or in a node fails the file's
    CRC-32C (and the length, where it is in the header)."""
    _fill(_kvstore(tmp_path / "s", max_inline_value_bytes=200),
          np.random.default_rng(0), 20)
    manifest = tmp_path / "s" / "manifest.ocdbt"
    data = bytearray(manifest.read_bytes())
    data[20] ^= 1
    manifest.write_bytes(bytes(data))
    with pytest.raises(ocdbt.OrbaxError, match="CRC-32C"):
        ocdbt.OcdbtStore(str(tmp_path / "s"))
    data[20] ^= 1
    manifest.write_bytes(bytes(data))
    node = max((tmp_path / "s" / "d").iterdir(),
               key=lambda p: p.stat().st_mtime)
    blob = bytearray(node.read_bytes())
    blob[len(blob) // 2] ^= 0x10
    node.write_bytes(bytes(blob))
    with pytest.raises(ocdbt.OrbaxError, match="CRC-32C|magic|bytes"):
        ocdbt.OcdbtStore(str(tmp_path / "s")).list()


def test_unread_stores_raise(tmp_path):
    """A file that is not OCDBT's, a numbered manifest (tensorstore's
    option; orbax writes a single one) and orbax without OCDBT raise,
    naming what they met."""
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / "manifest.ocdbt").write_bytes(
        b"\x0c\xdb\x3a\x2a" + bytes(30))
    with pytest.raises(ocdbt.OrbaxError, match="bytes"):
        ocdbt.OcdbtStore(str(tmp_path / "bad"))
    _fill(_kvstore(tmp_path / "numbered", manifest_kind="numbered"),
          np.random.default_rng(1), 5)
    with pytest.raises(ocdbt.OrbaxError, match="manifest kind 1"):
        ocdbt.OcdbtStore(str(tmp_path / "numbered"))
    ckptr = ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_ocdbt=False))
    ckptr.save(tmp_path / "plain", {"w": np.ones(3, np.float32)})
    with pytest.raises(ocdbt.OrbaxError, match="without OCDBT"):
        ocdbt.read_pytree(str(tmp_path / "plain"))


# -- zarr v2 arrays -------------------------------------------------------------

DTYPES = ("<f4", "<f2", "<f8", "bfloat16", "<i4", "<i8", "<u4", "|u1", "|b1",
          "<i2")


@pytest.mark.parametrize("compressor", ["zstd", None])
@pytest.mark.parametrize("dtype", DTYPES)
def test_zarr_arrays_match_tensorstore(tmp_path, dtype, compressor):
    """A (10, 7) array in (3, 5) chunks with the last chunk row never
    written (its fill value), and a 0-d array, in one OCDBT store."""
    rng = np.random.default_rng(DTYPES.index(dtype))
    base = {"driver": "ocdbt", "base": f"file://{tmp_path}/"}
    comp = {"id": "zstd", "level": 1} if compressor else None
    fill = False if dtype == "|b1" else 3
    arr = ts.open({"driver": "zarr", "kvstore": base, "path": "a.b",
                   "metadata": {"dtype": dtype, "shape": [10, 7],
                                "chunks": [3, 5], "compressor": comp,
                                "fill_value": fill}},
                  create=True).result()
    values = rng.standard_normal((9, 7)) * 50
    arr[:9].write(values.astype(arr.dtype.numpy_dtype)).result()
    scalar = ts.open({"driver": "zarr", "kvstore": base, "path": "s",
                      "metadata": {"dtype": dtype, "shape": [],
                                   "chunks": [], "compressor": comp}},
                     create=True).result()
    scalar.write(np.asarray(5).astype(scalar.dtype.numpy_dtype)).result()
    store = ocdbt.OcdbtStore(str(tmp_path))
    for name, ref in (("a.b", arr), ("s", scalar)):
        want = np.asarray(ref.read().result())
        got = ocdbt.read_zarr(store, name)
        if dtype == "bfloat16":  # the float32 values it denotes
            want = want.astype(np.float32)
        assert got.shape == want.shape and got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want)


def test_unread_zarr_forms_raise(tmp_path):
    base = {"driver": "ocdbt", "base": f"file://{tmp_path}/"}
    for name, meta in (
            ("blosc", {"compressor": {"id": "blosc", "cname": "lz4",
                                      "clevel": 5, "shuffle": 1}}),
            ("fortran", {"order": "F", "compressor": None})):
        ts.open({"driver": "zarr", "kvstore": base, "path": name,
                 "metadata": {"dtype": "<f4", "shape": [4, 4],
                              "chunks": [4, 4], **meta}},
                create=True).result()[...].write(np.ones((4, 4),
                                                         np.float32)).result()
    store = ocdbt.OcdbtStore(str(tmp_path))
    with pytest.raises(ocdbt.OrbaxError, match="compressor 'blosc'"):
        ocdbt.read_zarr(store, "blosc")
    with pytest.raises(ocdbt.OrbaxError, match="order 'F'"):
        ocdbt.read_zarr(store, "fortran")
    with pytest.raises(ocdbt.OrbaxError, match="no .zarray"):
        ocdbt.read_zarr(store, "missing")


# -- JAX checkpoints ------------------------------------------------------------

OPTS = {"Adam": 1.0, "AdamW": 0.0, "SGD": 1.0}  # name: TRAIN.GRADIENT_CLIP


def _cfgs(opt: str, clip: float):
    out = []
    for c in (get_cfg_defaults(), jax_defaults()):
        c.MODEL.NAME, c.MODEL.ENCODER_NAME = "Unet", "resnet34"
        c.MODEL.DTYPE = "float32"
        c.DATA.IMG_SIZE = SIZE
        c.OPTIMIZER.NAME = opt
        c.TRAIN.GRADIENT_CLIP = clip
        c.TRAIN.WEIGHT_DECAY = 1e-4
        out.append(c)
    return out


def _randomized(tree, rng):
    """Every array leaf replaced by random values of its shape and dtype
    (counts 3): an optimizer state that is not its initial one."""
    def leaf(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.integer):
            return np.full(x.shape, 3, x.dtype)
        return rng.standard_normal(x.shape).astype(x.dtype) * 1e-3
    return jax.tree_util.tree_map(leaf, tree)


_JIT_INIT = jax.jit(jax_init_model, static_argnums=(0, 1, 2))


def _jax_state(jcfg, seed):
    """JAX's create_train_state, with flax's init compiled (eager, it
    takes ~30 s a model on the CPU)."""
    from unet_watermark_tpu.training.state import TrainState

    model = jax_model(jcfg)
    variables = _JIT_INIT(model, jcfg.DATA.IMG_SIZE, seed)
    tx = jtrain.make_optimizer(jcfg)
    return TrainState(step=np.int32(0), params=variables["params"],
                      batch_stats=variables["batch_stats"],
                      opt_state=tx.init(variables["params"]), tx=tx,
                      apply_fn=model.apply)


@pytest.fixture(scope="module")
def jax_ckpts(tmp_path_factory):
    """{optimizer: (checkpoint dir, JAX state)}: the shipped Unet/resnet34
    weights, each optimizer's state randomized."""
    root = tmp_path_factory.mktemp("jax_ckpts")
    rng = np.random.default_rng(0)
    _, jcfg = _cfgs("Adam", 1.0)
    state = _jax_state(jcfg, 0)
    shipped = jship.load_params_npz(
        str(tship.seg_weights_path("Unet", "resnet34")),
        {"params": state.params, "batch_stats": state.batch_stats})
    params, stats = shipped["params"], shipped["batch_stats"]
    out = {}
    for opt, clip in OPTS.items():
        _, jcfg = _cfgs(opt, clip)
        tx = jtrain.make_optimizer(jcfg)
        st = state.replace(params=params, batch_stats=stats, tx=tx,
                           opt_state=_randomized(tx.init(params), rng),
                           step=np.int32(17))
        path = jck.save_checkpoint(str(root / opt), "checkpoint_epoch_3", st,
                                   {"epoch": 3, "best_val_loss": 0.25})
        out[opt] = (path, st)
    slim = state.replace(params=params, batch_stats=stats, opt_state=None,
                         step=np.int32(9))
    out["slim"] = (jck.save_checkpoint(str(root / "Adam"), "best_model", slim,
                                       {"epoch": 3}), slim)
    return out


@pytest.mark.parametrize("opt", list(OPTS) + ["slim"])
def test_restore_raw_equals_jax(jax_ckpts, opt):
    path, _ = jax_ckpts[opt]
    jtree, jmeta = jck.restore_raw(path)
    tree, meta = tck.restore_raw(path)
    want = _flat(jtree)
    assert meta == jmeta and sorted(tree) == sorted(want)
    for k, v in want.items():
        assert tree[k].dtype == v.dtype and tree[k].shape == v.shape, k
        np.testing.assert_array_equal(tree[k], v, err_msg=k)


def _port_state(opt, clip, seed=5):
    cfg, _ = _cfgs(opt, clip)
    return ttrain.create_train_state(cfg, seed=seed, device="cpu")


def _to_np(t: torch.Tensor) -> np.ndarray:
    a = t.detach().numpy()
    return np.transpose(a, (2, 3, 1, 0)) if a.ndim == 4 else a


@pytest.mark.parametrize("opt", list(OPTS))
def test_restore_checkpoint_maps_the_optimizer(jax_ckpts, opt):
    """Parameters, statistics, step, the moments (Adam: inner_state 1,
    AdamW: 0) or the trace (SGD: 1) under opt_state/1 (clip on) or
    opt_state (clip off), their count and the injected learning rate."""
    path, jstate = jax_ckpts[opt]
    state, meta = tck.restore_checkpoint(path, _port_state(opt, OPTS[opt]))
    assert meta["epoch"] == 3 and int(state.step) == 17
    flat = to_flax(state.model)
    for k, v in _flat({"params": jstate.params,
                       "batch_stats": jstate.batch_stats}).items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)
    jopt = _flat(jstate.opt_state)
    base = "1/" if OPTS[opt] > 0 else ""
    inner = f"{base}inner_state/{0 if opt == 'AdamW' else 1}/"
    names = [n for n, _ in state.model.named_parameters()]
    for kind, tensors in state.opt.state_tensors().items():
        for n, t in zip(names, tensors):
            key = inner + kind + "/" + flax_name(n)[len("params/"):]
            np.testing.assert_array_equal(_to_np(t), jopt[key], err_msg=key)
    if opt != "SGD":
        assert int(state.opt.count) == int(jopt[inner + "count"]) == 3
    assert float(state.opt.lr) == float(
        jopt[base + "hyperparams/learning_rate"])


@pytest.mark.parametrize("ckpt,opt,clip", [
    ("Adam", "SGD", 1.0), ("Adam", "Adam", 0.0), ("AdamW", "Adam", 0.0),
    ("slim", "Adam", 1.0)])
def test_other_optimizer_or_slim_save_starts_fresh(jax_ckpts, caplog, ckpt,
                                                   opt, clip):
    """Another optimizer, another clip setting or a slim best save: the
    parameters, statistics and step come back, the optimizer state starts
    fresh with a warning, as JAX's restore_checkpoint falls back."""
    path, jstate = jax_ckpts[ckpt]
    _, jcfg = _cfgs(opt, clip)
    jfresh = _jax_state(jcfg, 1)
    with caplog.at_level(logging.WARNING):
        jrestored, _ = jck.restore_checkpoint(path, jfresh)
        state, _ = tck.restore_checkpoint(path, _port_state(opt, clip))
    assert sum("fresh optimizer state" in r.getMessage()
               for r in caplog.records) == 2
    assert all(float(np.abs(np.asarray(x)).max()) == 0 for x in
               jax.tree_util.tree_leaves(jrestored.opt_state)
               if np.asarray(x).dtype != np.float32 or np.asarray(x).ndim)
    assert int(state.opt.count) == 0 and all(
        float(t.abs().max()) == 0 for ts_ in state.opt.state_tensors().values()
        for t in ts_)
    assert int(state.step) == int(jrestored.step) == int(jstate.step)
    flat = to_flax(state.model)
    for k, v in _flat({"params": jrestored.params,
                       "batch_stats": jrestored.batch_stats}).items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)


def test_latest_checkpoint_and_not_a_checkpoint(jax_ckpts, tmp_path):
    path, _ = jax_ckpts["Adam"]
    parent = str(path).rsplit("/", 1)[0]
    assert tck.latest_checkpoint(parent) == jck.latest_checkpoint(parent)
    (tmp_path / "empty" / "tree").mkdir(parents=True)
    for d in (tmp_path / "empty", tmp_path / "nothing"):
        with pytest.raises(FileNotFoundError, match="no checkpoint"):
            tck.restore_raw(str(d))


def test_load_variables_equals_jax(jax_ckpts, tmp_path):
    """A .npz (JAX's save_params_npz), a checkpoint directory (tree/ and
    meta.json, filtered to the template's top-level keys) and a bare orbax
    directory: the port's flat trees equal JAX's load_variables'."""
    path, jstate = jax_ckpts["Adam"]
    template = {"params": jstate.params, "batch_stats": jstate.batch_stats}
    npz = jship.save_params_npz(str(tmp_path / "w.npz"), template)
    bare = tmp_path / "bare"
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(bare, template)
    ckptr.wait_until_finished()
    flat_template = _flat(template)
    for src in (npz, path, str(bare)):
        want = _flat(jship.load_variables(src, template))
        got = tship.load_variables(src, flat_template)
        assert sorted(got) == sorted(want), src
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        weights = tship.load_variables(src)  # no template: the weights
        assert sorted(weights) == sorted(want)


def test_predictor_mask_from_a_jax_checkpoint_equals_jax(jax_ckpts,
                                                         tmp_path):
    """The probability map and the thresholded mask (POST_PROCESS off: the
    mask chains are held against JAX's in tests/test_torch_maskproc.py) of
    the weights in a JAX checkpoint directory, in both predictors."""
    path, _ = jax_ckpts["Adam"]
    cfg, jcfg = _cfgs("Adam", 1.0)
    for c in (cfg, jcfg):
        c.PREDICT.POST_PROCESS = False
    img = (watermarked_images(1, 48, seed=4)[0][0] * 255).astype(np.uint8)
    image_io.write_png(tmp_path / "x.png", img)
    jpred = JaxPredictor(model_path=path, config=jcfg)
    # the same forward with the weights as arguments: jit over the
    # predictor's closure folds them in as constants, ~1 min on the CPU
    apply = jax.jit(lambda v, x: jpred.model.apply(v, x, train=False))
    jpred._forward = lambda x: apply(jpred.variables, x)
    path_x = str(tmp_path / "x.png")
    pred = WatermarkPredictor(cfg, weights_path=path, device="cpu")
    jprobs = jpred._infer_prob_map(image_io.read_rgb(path_x))
    probs = pred._infer_prob_map(image_io.read_rgb_tensor(path_x, "cpu"))
    # float32 forwards of XLA and torch: within 1e-5 of each other
    np.testing.assert_allclose(probs.numpy(), jprobs, rtol=0, atol=1e-5)
    err = np.abs(probs.numpy() - jprobs).max()
    # a threshold in the widest gap of the map's values in its middle
    # half, so the mask holds both classes; the gap is wider than twice
    # the maps' difference, so no pixel can fall on the other side of it
    vals = np.unique(jprobs)
    lo, hi = len(vals) // 4, 3 * len(vals) // 4
    cut = lo + int(np.argmax(np.diff(vals[lo:hi + 1])))
    assert vals[cut + 1] - vals[cut] > 2 * err
    for c in (pred.cfg, jpred.cfg):
        c.PREDICT.THRESHOLD = float((vals[cut] + vals[cut + 1]) / 2)
    jmask = jpred.predict_mask(path_x)
    assert 0 < jmask.mean() < 255  # both classes present
    np.testing.assert_array_equal(pred.predict_mask(path_x), jmask)


def test_model_selector_loads_jax_checkpoints(jax_ckpts):
    """A folder of JAX checkpoint directories (tree/ and meta.json): the
    selector finds them as JAX's does and loads each one's weights."""
    from unet_watermark_tpu.scripts.model_selector import \
        ModelSelector as JaxSelector
    from unet_watermark_tpu_torch.scripts.model_selector import ModelSelector

    path, jstate = jax_ckpts["SGD"]
    parent = str(path).rsplit("/", 1)[0]
    cfg, jcfg = _cfgs("SGD", 1.0)
    sel = ModelSelector(parent, parent, config=cfg, device="cpu")
    found = sel.discover_checkpoints()
    assert found == JaxSelector(parent, parent, config=jcfg
                                ).discover_checkpoints() == [path]
    flat = to_flax(sel._load_model(found[0]))
    for k, v in _flat({"params": jstate.params,
                       "batch_stats": jstate.batch_stats}).items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)


def test_latent_inpainter_reads_an_orbax_directory(tmp_path):
    """train_latent_diffusion's output ({"ae", "denoiser"} saved by orbax)
    as DIFFUSION_WEIGHTS: the inpainter's modules hold its arrays."""
    from unet_watermark_tpu_torch.diffusion import latent_diffusion as ld

    ae, den = ld.init_ld_modules(seed=3)
    flat = ld.ld_weights(ae, den)
    tree = {}
    for k, v in flat.items():
        node = tree
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    out = tmp_path / "latent_diffusion"
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(out, tree)
    ckptr.wait_until_finished()
    inp = ld.LatentInpainter(str(out), device="cpu", dtype=None)
    got = ld.ld_weights(inp.ae, inp.denoiser)
    assert sorted(got) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
