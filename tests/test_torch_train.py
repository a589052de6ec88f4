"""The port's training path against the JAX package's, on the CPU at 64²
(Unet/resnet34, float32):

  - the optimizer (adam, adamw, sgd, with and without clipping) against
    optax's chain from make_optimizer, on the same gradients;
  - LRScheduler and EarlyStopping on the same loss sequences;
  - init_model's distributions against flax's init, layer by layer;
  - BatchNorm's running statistics after a train-mode forward;
  - one train step and one eval step against JAX's jitted steps, from the
    same parameters, with a padded batch; in bf16, the loss and the eval
    logits, loosely (see that test);
  - the shipped .npz both ways.

tests/test_torch_train_loop.py holds train() itself: 2 epochs against
JAX's, checkpoints and resume.

Tolerances. Adam's first step moves each parameter by about ±lr whatever
its gradient's size, so where a gradient is near zero its sign, and so
the step, may differ between the packages: the gradients are compared
tightly (in float64, see the test), the optimizer tightly on equal
gradients, and the stepped parameters to within 2·lr.
"""
import functools
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_watermark_tpu.configs import get_cfg_defaults as jax_defaults
from unet_watermark_tpu.models import create_model_from_config as jax_model
from unet_watermark_tpu.models import init_model as jax_init_model
from unet_watermark_tpu.ops import augment as jaug
from unet_watermark_tpu.ops import losses as jlosses
from unet_watermark_tpu.training import state as jstate
from unet_watermark_tpu.utils import shipping as jship
from unet_watermark_tpu_torch.configs import get_cfg_defaults
from unet_watermark_tpu_torch.models.convert import (flax_name,
                                                     load_flax_weights,
                                                     to_flax, torch_name)
from unet_watermark_tpu_torch.models.factory import (create_model_from_config,
                                                     init_model)
from unet_watermark_tpu_torch.ops import augment as taug
from unet_watermark_tpu_torch.ops import losses as tlosses
from unet_watermark_tpu_torch.training import state as tstate
from unet_watermark_tpu_torch.training import train as ttrain
from unet_watermark_tpu_torch.utils import shipping as tship
from unet_watermark_tpu_torch.utils.synthetic import watermarked_images

# the module (the package's __init__ exports the function train)
jtrain = importlib.import_module("unet_watermark_tpu.training.train")

SIZE, BATCH = 64, 4
ZERO = dict(hflip_p=0.0, vflip_p=0.0, rot90_p=0.0, affine_p=0.0, bc_p=0.0,
            hsv_p=0.0, noise_p=0.0, blur_p=0.0, jpeg_p=0.0)


def _cfgs(tmp=None, arch="Unet"):
    out = []
    for c in (get_cfg_defaults(), jax_defaults()):
        c.MODEL.NAME, c.MODEL.ENCODER_NAME = arch, "resnet34"
        c.MODEL.DTYPE = "float32"
        c.DATA.IMG_SIZE = SIZE
        c.TRAIN.BATCH_SIZE = BATCH
        c.TRAIN.LR = 1e-3
        if tmp is not None:
            c.TRAIN.CHECKPOINT_DIR = str(tmp / "ckpt")
            c.TRAIN.OUTPUT_DIR = str(tmp / "out")
            c.TRAIN.MODEL_SAVE_PATH = str(tmp / "models" / "m.pth")
        out.append(c)
    return out


def _flat(variables) -> dict:
    return {k: np.array(v) for k, v in jship.flatten_tree(
        {"params": variables["params"],
         "batch_stats": variables["batch_stats"]}).items()}


def _port_state(cfg, flat) -> tstate.TrainState:
    """A port state holding the flax weights `flat` (the optimizer made
    after the load, which replaces the model's tensors)."""
    model = create_model_from_config(cfg)
    load_flax_weights(model, flat)
    return tstate.TrainState(model, tstate.make_optimizer(cfg, model))


def _batch(seed=0, valid=(1, 1, 1, 0)):
    images, logos = watermarked_images(BATCH, SIZE, seed=seed)
    return {"image": np.rint(images * 255).astype(np.uint8),
            "mask": logos.astype(np.uint8)[..., None],
            "valid": np.asarray(valid, np.float32)}


@pytest.fixture(scope="module")
def jax_unet():
    """JAX's Unet state at 64², its jitted steps (no augmentation)."""
    _, jcfg = _cfgs()
    # create_train_state with its init compiled (eager flax init is slow)
    model = jax_model(jcfg)
    variables = jax.jit(jax_init_model, static_argnums=(0, 1))(model, SIZE)
    tx = jstate.make_optimizer(jcfg)
    state = jstate.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]), tx=tx, apply_fn=model.apply)
    loss_fn = jlosses.get_loss_function(jcfg)
    zero = jaug.AugmentPolicy(**ZERO)
    return {"cfg": jcfg, "model": model, "state": state,
            "step": jtrain.make_train_step(model, loss_fn, zero,
                                           donate=False),
            "eval": jtrain.make_eval_step(model, loss_fn),
            "loss_fn": loss_fn,
            "flat": _flat({"params": state.params,
                           "batch_stats": state.batch_stats})}


# ---------------------------------------------------------------------------
# the optimizer, the scheduler, early stopping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clip", [0.0, 1.0, 1e-3])
@pytest.mark.parametrize("name", ["Adam", "AdamW", "SGD"])
def test_optimizer_matches_optax(name, clip):
    """Five steps on the same gradients (some steps clipped, the learning
    rate changed between steps as the epoch loop does): parameters and
    moments equal optax's to float32 rounding."""
    cfg, jcfg = _cfgs()
    for c in (cfg, jcfg):
        c.OPTIMIZER.NAME = name
        c.TRAIN.GRADIENT_CLIP = clip
        c.TRAIN.WEIGHT_DECAY = 1e-2
    rng = np.random.default_rng(1)
    shapes = {"a": (3, 3, 4, 8), "b": (8,), "c": (5, 7)}
    params = {k: rng.normal(0, 1, s).astype(np.float32)
              for k, s in shapes.items()}
    tx = jstate.make_optimizer(jcfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    tp = [torch.tensor(params[k]) for k in shapes]
    opt = tstate.Optimizer(tp, name, jcfg.TRAIN.LR, 1e-2, clip)
    for i in range(5):
        g = {k: (rng.normal(0, 10 ** (i - 2), s)).astype(np.float32)
             for k, s in shapes.items()}
        lr = 1e-3 * 0.5 ** i
        opt_state = jstate._set_hyperparam(opt_state, "learning_rate", lr)
        opt.lr.fill_(lr)
        upd, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   opt_state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        opt.step([torch.tensor(g[k]) for k in shapes])
        for k, t in zip(shapes, tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
    if name != "SGD":
        assert int(opt.count) == 5


def test_clip_is_optax_not_clip_grad_norm():
    """The clip scales by max_norm / norm exactly (no 1e-6 in the norm)."""
    g = [torch.full((4,), 3.0), torch.full((4,), 4.0)]  # norm 10
    opt = tstate.Optimizer([torch.zeros(4), torch.zeros(4)], "sgd", 1.0,
                           0.0, 1.0)
    opt.clip_by_global_norm(g)
    assert g[0][0].item() == pytest.approx(0.3, abs=1e-7)
    assert torch.linalg.vector_norm(torch.cat(g)).item() == \
        pytest.approx(1.0, abs=1e-6)
    small = [torch.full((4,), 0.1)]
    opt.clip_by_global_norm(small)
    assert small[0][0].item() == float(np.float32(0.1))  # unchanged


@pytest.mark.parametrize("kind", ["ReduceLROnPlateau",
                                  "CosineAnnealingWarmRestarts",
                                  "CosineAnnealing", "StepLR", "none"])
def test_scheduler_and_early_stopping_match_jax(kind):
    cfg, jcfg = _cfgs()
    for c in (cfg, jcfg):
        c.OPTIMIZER.LR_SCHEDULER = kind
        c.OPTIMIZER.SCHEDULER_PATIENCE = 2
        c.OPTIMIZER.SCHEDULER_T_0 = 3
        c.TRAIN.EPOCHS = 20
    losses = [1.0, 0.9, 0.95, 0.96, 0.97, 0.8, 0.81, 0.82, 0.83, 0.84,
              0.7, 0.7, 0.7, 0.7, 0.7]
    ts, js = tstate.LRScheduler(cfg), jstate.LRScheduler(jcfg)
    te, je = tstate.EarlyStopping(3, 0.01), jstate.EarlyStopping(3, 0.01)
    for i, v in enumerate(losses):
        assert ts.step(v) == js.step(v)
        assert te(v) == je(v)
        if i == 6:  # a round trip through the state dicts
            ts2, te2 = tstate.LRScheduler(cfg), tstate.EarlyStopping(3, 0.01)
            ts2.load_state_dict(json.loads(json.dumps(ts.state_dict())))
            te2.load_state_dict(te.state_dict())
            ts, te = ts2, te2
    assert ts.state_dict() == js.state_dict()
    assert te.state_dict() == je.state_dict()


def test_unknown_optimizer_and_scheduler_raise():
    with pytest.raises(ValueError):
        tstate.Optimizer([torch.zeros(1)], "lamb")
    cfg, _ = _cfgs()
    cfg.OPTIMIZER.LR_SCHEDULER = "cyclic"
    with pytest.raises(ValueError):
        tstate.LRScheduler(cfg).step(1.0)


# ---------------------------------------------------------------------------
# the model in train mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["Unet", "UnetPlusPlus"])
def test_init_matches_flax_distributions(arch, jax_unet):
    """Every conv kernel's std is sqrt(1 / fan_in) as flax's lecun_normal
    gives it (truncated at 2 sigma), in both packages, within the spread
    of a sample of that size; conv biases and BN are the same constants."""
    cfg, jcfg = _cfgs(arch=arch)
    model = init_model(create_model_from_config(cfg), seed=3)
    jflat = jax_unet["flat"] if arch == "Unet" else _flat(
        jax.jit(jax_init_model, static_argnums=(0, 1))(
            jax_model(jcfg), SIZE))
    port = to_flax(model)
    assert set(port) == set(jflat)
    for key, want in jflat.items():
        got = port[key]
        if key.endswith("/kernel"):
            n = got.size
            expect = (1.0 / (n // got.shape[-1])) ** 0.5
            for arr in (got, want):
                assert abs(arr.std() / expect - 1) < 6 / n ** 0.5 + 0.02, key
            assert np.abs(got).max() <= 2 * expect / 0.8796256 + 1e-6
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)


def test_batchnorm_running_stats_follow_flax(jax_unet):
    """A train-mode forward updates the running mean and the running
    variance (with the biased batch variance, momentum 0.9) as flax does;
    the outputs use the batch statistics in both."""
    j = jax_unet
    cfg, _ = _cfgs()
    x = np.random.default_rng(4).normal(0, 1, (BATCH, SIZE, SIZE, 3)
                                        ).astype(np.float32)
    y, mutated = j["model"].apply(
        {"params": j["state"].params, "batch_stats": j["state"].batch_stats},
        jnp.asarray(x), train=True, mutable=["batch_stats"])
    model = create_model_from_config(cfg)
    load_flax_weights(model, j["flat"])
    out = model.train()(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y),
                               rtol=1e-4, atol=2e-4)
    want = _flat({"params": j["state"].params,
                  "batch_stats": mutated["batch_stats"]})
    got = to_flax(model)
    moved = 0
    for key in want:
        if key.startswith("batch_stats/"):
            # the batch's means and variances of activations that agree
            # to ~1e-6 of their scale; a mean near zero keeps that
            # absolute error
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       atol=1e-5, err_msg=key)
            moved += not np.allclose(want[key], j["flat"][key])
    assert moved == len([k for k in want if k.startswith("batch_stats/")])


def test_remat_gives_the_same_step():
    """MODEL.REMAT: the checkpointed forward's gradients and running
    statistics equal the plain forward's (no second update on the
    recomputation)."""
    cfg, _ = _cfgs()
    x = torch.from_numpy(np.random.default_rng(5).normal(
        0, 1, (2, SIZE, SIZE, 3)).astype(np.float32))
    outs = []
    for remat in (False, True):
        cfg.MODEL.REMAT = remat
        model = init_model(create_model_from_config(cfg), seed=1).train()
        model(x).square().mean().backward()
        outs.append((to_flax(model), [p.grad.clone() for p in
                                      model.parameters()]))
    (s0, g0), (s1, g1) = outs
    for k in s0:
        np.testing.assert_allclose(s1[k], s0[k], rtol=1e-6, atol=1e-7)
    for a, b in zip(g0, g1):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-8)


# ---------------------------------------------------------------------------
# the steps against JAX's
# ---------------------------------------------------------------------------

def _jax_grads(j, batch, model=None, dtype=jnp.float32):
    """jax.grad of the train step's loss (its loss_of), on the same state
    and batch; with a float64 model, at float64 parameters. One compile
    for each model and dtype."""
    model = model or j["model"]
    key = (str(model.dtype), str(dtype))  # the model's compute dtype
    if key not in _GRAD_FNS:
        _GRAD_FNS[key] = jax.jit(functools.partial(
            _loss_grads, model, j["loss_fn"], dtype))
    cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda x: jnp.asarray(x, dtype), t)
    # the float32 input as the step makes it, outside the compiled
    # function (where XLA may divide by 255 as a multiply)
    images = jaug.normalize(jnp.asarray(batch["image"], jnp.float32)
                            / 255.0)
    grads = _GRAD_FNS[key](cast(j["state"].params),
                           cast(j["state"].batch_stats), images,
                           jnp.asarray(batch["mask"], jnp.float32),
                           jnp.asarray(batch["valid"]))
    return {k: np.array(v) for k, v in jship.flatten_tree(
        {"params": grads}).items()}


_GRAD_FNS = {}


def _loss_grads(model, loss_fn, dtype, params, batch_stats, images, masks,
                valid):
    vmask = valid.reshape(-1, 1, 1, 1)

    def loss_of(params):
        logits, _ = model.apply(
            {"params": params, "batch_stats": batch_stats}, images,
            train=True, mutable=["batch_stats"])
        logits = jnp.where(vmask > 0, logits, -20.0)
        scale = images.shape[0] / jnp.maximum(jnp.sum(valid), 1.0)
        return loss_fn(logits, masks * vmask) * scale

    return jax.grad(loss_of)(params)


def test_train_step_matches_jax(jax_unet):
    """One step from the same parameters on a padded batch (3 valid of
    4): the loss, the confusion counts and the new running statistics;
    the new parameters within Adam's ±2·lr allowance (the gradients are
    held in float64 below)."""
    j = jax_unet
    cfg, _ = _cfgs()
    batch = _batch(seed=1)
    jnew, jm = j["step"](j["state"], {k: jnp.asarray(v)
                                      for k, v in batch.items()},
                         jax.random.PRNGKey(0))
    state = _port_state(cfg, j["flat"])
    step = ttrain.make_train_step(cfg, tlosses.get_loss_function(cfg),
                                  taug.AugmentPolicy(**ZERO),
                                  torch.Generator())
    m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    total = BATCH * SIZE * SIZE * 3 / 4  # the valid pixels
    for k in ("tp", "fp", "fn", "tn"):
        # a pixel whose probability sits at 0.5 within rounding may count
        # on the other side
        assert abs(float(m[k]) - float(jm[k])) <= 1e-4 * total, k
    want = _flat({"params": jnew.params, "batch_stats": jnew.batch_stats})
    got = to_flax(state.model)
    lr = cfg.TRAIN.LR
    for key in want:
        if key.startswith("batch_stats/"):
            # means and variances of activations that agree to ~1e-6 of
            # their scale; a mean near zero keeps that absolute error
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       atol=1e-5, err_msg=key)
        else:
            assert np.abs(got[key] - want[key]).max() <= 2 * lr + 1e-6, key
    assert int(state.step) == int(jnew.step) == 1


def test_train_step_gradients_match_jax_in_float64(jax_unet):
    """Every gradient of the train step's loss, both packages computing
    the network in float64 (the input, the logits and the loss stay
    float32 in both, as the heads cast them, and round alike). In float32
    the gradients of this network at init are ill-conditioned (BatchNorm
    over 2 x 2 x 4 values at stride 32 amplifies a rounding ~1e6-fold):
    against a float64 reference JAX's own float32 gradients are off by up
    to ~12 % of a layer's scale and the port's by ~4 %, so float32 cannot
    hold them tightly; float64 can."""
    j = jax_unet
    cfg, _ = _cfgs()
    batch = _batch(seed=1)
    with jax.enable_x64(True):
        _, jcfg = _cfgs()
        jcfg.MODEL.DTYPE = "float64"
        jgrads = _jax_grads(j, batch, jax_model(jcfg), jnp.float64)
    state = _port_state(cfg, j["flat"])
    model = state.model.double().train()
    images = taug.normalize(torch.from_numpy(batch["image"]).float() / 255.0)
    masks = torch.from_numpy(batch["mask"]).float()
    valid = torch.from_numpy(batch["valid"])
    logits, targets, scale = ttrain._masked(model(images), masks, valid)
    (tlosses.get_loss_function(cfg)(logits, targets) * scale).backward()
    for name, p in model.named_parameters():
        key = flax_name(name)
        got, want = p.grad.numpy(), jgrads[key]
        if got.ndim == 4:
            got = np.transpose(got, (2, 3, 1, 0))
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * scale, err_msg=key)


def test_optimizer_on_jax_gradients_is_tight(jax_unet):
    """The port's optimizer step on JAX's own float32 gradients gives
    JAX's new parameters to float32 rounding: the ±lr allowance above is
    the gradients' rounding through Adam, not the optimizer."""
    j = jax_unet
    cfg, jcfg = _cfgs()
    batch = _batch(seed=2)
    jgrads = _jax_grads(j, batch)
    state = _port_state(cfg, j["flat"])
    names = [n for n, _ in state.model.named_parameters()]
    g = []
    for n in names:
        arr = jgrads[flax_name(n)]
        if arr.ndim == 4:
            arr = np.transpose(arr, (3, 2, 0, 1))
        g.append(torch.tensor(arr))  # a copy: step() clips in place
    state.opt.step(g)
    tx = jstate.make_optimizer(jcfg)
    jg = jax.tree_util.tree_map(jnp.asarray, jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(j["state"].params),
        [jgrads["params/" + "/".join(
            str(getattr(p, "key", p)) for p in path)]
         for path, _ in jax.tree_util.tree_flatten_with_path(
             j["state"].params)[0]]))
    upd, _ = jax.jit(tx.update)(jg, tx.init(j["state"].params),
                                j["state"].params)
    new = jax.tree_util.tree_map(lambda p, u: p + u, j["state"].params, upd)
    want = _flat({"params": new, "batch_stats": j["state"].batch_stats})
    got = to_flax(state.model)
    lr = cfg.TRAIN.LR
    for key in want:
        if key.startswith("params/"):
            # Adam divides by |g + wd·p| + eps: where the weight decay
            # cancels the gradient to near eps, one rounding of g + wd·p
            # (a fused multiply-add against optax's multiply then add)
            # moves that element's step by up to ~1e-3 of lr
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                       atol=1e-3 * lr, err_msg=key)


def test_eval_step_matches_jax(jax_unet):
    j = jax_unet
    cfg, _ = _cfgs()
    batch = _batch(seed=3, valid=(1, 0, 1, 0))
    jm = j["eval"](j["state"], {k: jnp.asarray(v) for k, v in batch.items()})
    state = _port_state(cfg, j["flat"])
    step = ttrain.make_eval_step(cfg, tlosses.get_loss_function(cfg))
    m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(m["weight"]) == float(jm["weight"]) == 2.0
    total = 2 * SIZE * SIZE
    for k in ("tp", "fp", "fn", "tn"):
        assert abs(float(m[k]) - float(jm[k])) <= 1e-4 * total, k
    assert sum(float(m[k]) for k in ("tp", "fp", "fn", "tn")) == total


def test_bf16_train_step_matches_jax_loosely(jax_unet):
    """MODEL.DTYPE bfloat16, as users train: one train step (torch.autocast
    over fp32 parameters) against JAX's jitted bf16 step (flax's
    dtype/param_dtype split), and the eval-mode forward against JAX's.

    Tolerances, from measured gaps (Unet and UNet++, 64² and 128²):
    each package's bf16 loss is 4e-5..6e-4 (relative) from its float32
    loss and the two bf16 losses 3e-4..6e-4 apart, so the loss is held to
    2e-3; the eval logits are 0.9-1.4 % of their largest value from each
    package's float32 logits and from each other, so they are held to 4 %.
    The bf16 gradients and running statistics are not compared: at init
    the train-mode network is so ill-conditioned (see the float64 test
    above) that JAX's own bf16 gradients are 55-120 % (relative L2) from
    its float32 ones. That the port computes in bf16 at all is checked:
    its bf16 logits sit at least a quarter of JAX's bf16-to-float32 gap
    from its float32 ones."""
    j = jax_unet
    batch = _batch(seed=4)
    _, jcfg = _cfgs()
    jcfg.MODEL.DTYPE = "bfloat16"
    jmodel = jax_model(jcfg)
    jstate16 = j["state"].replace(apply_fn=jmodel.apply)
    zero = jaug.AugmentPolicy(**ZERO)
    jstep = jtrain.make_train_step(jmodel, j["loss_fn"], zero, donate=False)
    _, jm = jstep(jstate16, {k: jnp.asarray(v) for k, v in batch.items()},
                  jax.random.PRNGKey(0))
    cfg, _ = _cfgs()
    cfg.MODEL.DTYPE = "bfloat16"
    state = _port_state(cfg, j["flat"])
    step = ttrain.make_train_step(cfg, tlosses.get_loss_function(cfg),
                                  taug.AugmentPolicy(**ZERO),
                                  torch.Generator())
    m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=2e-3)

    images = taug.normalize(torch.from_numpy(batch["image"]).float() / 255.0)
    variables = {"params": j["state"].params,
                 "batch_stats": j["state"].batch_stats}
    xj = jnp.asarray(images.numpy())
    want = {dt: np.array(jax.jit(functools.partial(
        model.apply, train=False))(variables, xj), np.float32)
        for dt, model in (("bfloat16", jmodel), ("float32", j["model"]))}
    got = {}
    for dt in ("bfloat16", "float32"):
        cfg.MODEL.DTYPE = dt
        model = _port_state(cfg, j["flat"]).model.eval()
        with torch.no_grad(), ttrain._autocast(cfg, torch.device("cpu")):
            got[dt] = model(images).float().numpy()
    top = np.abs(want["float32"]).max()
    gap = np.abs(want["bfloat16"] - want["float32"]).max()
    assert np.abs(got["bfloat16"] - want["bfloat16"]).max() <= 0.04 * top
    assert np.abs(got["bfloat16"] - got["float32"]).max() >= 0.25 * gap


# ---------------------------------------------------------------------------
# the shipped .npz
# ---------------------------------------------------------------------------

def _stepped_state(cfg, seed=0):
    state = ttrain.create_train_state(cfg, seed=seed, device="cpu")
    step = ttrain.make_train_step(cfg, tlosses.get_loss_function(cfg),
                                  "basic", torch.Generator().manual_seed(0))
    step(state, {k: torch.from_numpy(v) for k, v in _batch().items()})
    return state


def test_shipped_npz_both_ways(tmp_path, jax_unet):
    """The port writes the JAX package's shipped format (BF16:: keys,
    uint16 views, the flax tree's keys) and reads it back; each package
    loads the other's file to the same bf16 values."""
    cfg, _ = _cfgs()
    state = _stepped_state(cfg)
    flat = to_flax(state.model)
    path = tship.save_params_npz(tmp_path / "port.npz", flat)
    template = {"params": jax_unet["state"].params,
                "batch_stats": jax_unet["state"].batch_stats}
    loaded = _flat(jship.load_params_npz(path, template))
    assert set(loaded) == set(flat)
    bf16 = lambda a: torch.from_numpy(np.array(a, np.float32)).to(  # noqa
        torch.bfloat16).float().numpy()
    for k, v in flat.items():
        np.testing.assert_array_equal(loaded[k], bf16(v), err_msg=k)
    # JAX's file (the decoder and head: the encoder's 21 M weights are
    # the same code path) into the port
    jpath = str(tmp_path / "jax.npz")
    sub = {c: {k: v for k, v in template[c].items() if k != "encoder"}
           for c in template}
    jship.save_params_npz(jpath, sub)
    back = tship.load_npz(jpath)
    assert set(back) == set(_flat(sub))
    for k, v in _flat(sub).items():
        np.testing.assert_array_equal(back[k], bf16(v), err_msg=k)
    # every name maps back and forth
    for name in state.model.state_dict():
        if not name.endswith("num_batches_tracked"):
            assert torch_name(flax_name(name)) == name
