"""The port's inpainting trainer (training/train_inpaint.py), the PatchGAN
and the train mode of the FFC-LaMa generator (models/lama.py) against the
JAX package's, on the CPU. Inputs come from np.random.default_rng; each
test states its tolerance and what it observed.

JAX's GAN step is a closure inside train_inpaint; the tests take it from
there: jax.jit is replaced in that module by a stand-in that hands the
step function back, the generator and discriminator by narrow float64
ones (base 16, 2 FFC blocks), and the run stops at its next call
(load_clean_batches). With optax's chain replaced by SGD at rate 1 and no
clipping, the step's update is minus JAX's own gradient."""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unet_watermark_tpu.inference import engines as jengines
from unet_watermark_tpu.models import lama as jlama
from unet_watermark_tpu.training import train_inpaint as jti
from unet_watermark_tpu.utils.shipping import flatten_tree
from unet_watermark_tpu_torch.inference import engines
from unet_watermark_tpu_torch.models import lama
from unet_watermark_tpu_torch.models.convert import (lama_flax_path,
                                                     load_lama_weights,
                                                     module_to_flax)
from unet_watermark_tpu_torch.training import train_inpaint as ti
from unet_watermark_tpu_torch.utils.image_io import write_png
from unet_watermark_tpu_torch.utils.shipping import WEIGHTS_DIR, load_npz
from unet_watermark_tpu_torch.utils.synthetic import watermarked_images

torch.set_num_threads(2)

S, N = 64, 2  # image size and batch of the step tests
BASE, BLOCKS, D_BASE = 16, 2, 16  # the narrow generator and discriminator
LR, D_LR = 2e-4, 1e-4
# the JAX modules' own names, which _jax_step stubs in jlama
JDisc, jinit_lama = jlama.LamaDiscriminator, jlama.init_lama


def _tree(flat):
    tree = {}
    for k, v in flat.items():
        parts = k.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _flat(tree, prefix="params"):
    return {k: np.asarray(v) for k, v in flatten_tree({prefix: tree}).items()}


def _images(seed, n=N, s=S):
    return np.random.default_rng(seed).random((n, s, s, 3)).astype(
        np.float32)


# -- the mask raster ---------------------------------------------------------

def _jax_draws(key, n, size, max_boxes=3, max_strokes=4):
    """random_mask_batch's draws, recovered from its keys as it splits
    them, in draw_masks' layout."""
    u, ri = jax.random.uniform, jax.random.randint

    def one(sk):
        keys = jax.random.split(sk, max_boxes + max_strokes + 1)
        box = [jax.random.split(keys[i], 5) for i in range(max_boxes)]
        st = [jax.random.split(keys[max_boxes + i], 6)
              for i in range(max_strokes)]
        col = lambda f, ks: jnp.stack([f(k) for k in ks])  # noqa: E731
        lo, hi = size // 8, size // 3
        return {
            "box_use": col(lambda k: u(k[0]) < 0.7, box),
            "bw": col(lambda k: ri(k[1], (), lo, hi), box),
            "bh": col(lambda k: ri(k[2], (), lo, hi), box),
            "bx": col(lambda k: ri(k[3], (), 0, size - hi), box),
            "by": col(lambda k: ri(k[4], (), 0, size - hi), box),
            "stroke_use": col(lambda k: u(k[0]) < 0.6, st),
            "x0": col(lambda k: u(k[1], minval=0.0, maxval=float(size)), st),
            "y0": col(lambda k: u(k[2], minval=0.0, maxval=float(size)), st),
            "ang": col(lambda k: u(k[3], minval=0.0, maxval=2 * np.pi), st),
            "ln": col(lambda k: u(k[4], minval=size / 8, maxval=size / 2),
                      st),
            "wd": col(lambda k: u(k[5], minval=size / 64,
                                  maxval=size / 16), st)}

    d = jax.jit(jax.vmap(one))(jax.random.split(key, n))
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


@pytest.mark.parametrize("size,n,seed", [(64, 8, 0), (256, 4, 1)])
def test_mask_raster_on_jax_draws_matches_jax(size, n, seed):
    """The raster of JAX's own draws equals JAX's masks; at most 4 pixels
    may take the other side of a stroke's edge, where XLA's and torch's
    float32 cos/sin or FMA contraction differ by an ulp (observed: 0 in
    both cases)."""
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jax.jit(jti.random_mask_batch, static_argnums=(1, 2))(
        key, n, size))
    out = ti.raster_masks(_jax_draws(key, n, size), size).numpy()
    assert out.shape == ref.shape == (n, size, size, 1)
    assert (out != ref).sum() <= 4
    assert 0.01 < ref.mean() < 0.6


def test_random_mask_batch_draws_on_the_generators_device():
    """Draws from a torch.Generator: the same seed gives the same masks,
    another seed others; {0, 1}, coverage like JAX's recipe (JAX's 64
    masks at 128²: mean 0.183; the port's: within 0.1 of it)."""
    a = ti.random_mask_batch(torch.Generator().manual_seed(0), 64, 128,
                             "cpu")
    b = ti.random_mask_batch(torch.Generator().manual_seed(0), 64, 128,
                             "cpu")
    c = ti.random_mask_batch(torch.Generator().manual_seed(1), 64, 128,
                             "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert set(a.unique().tolist()) <= {0.0, 1.0}
    ref = float(np.asarray(jax.jit(jti.random_mask_batch, static_argnums=(
        1, 2))(jax.random.PRNGKey(3), 64, 128)).mean())
    assert abs(float(a.mean()) - ref) < 0.1


def test_inpaint_loss_matches_jax():
    """float32 on both sides; rtol 1e-6, observed 3.6e-7."""
    rng = np.random.default_rng(0)
    pred, target = rng.random((2, 3, 32, 40, 3)).astype(np.float32)
    mask = (rng.random((3, 32, 40, 1)) < 0.3).astype(np.float32)
    ref = float(jti.inpaint_loss(jnp.asarray(pred), jnp.asarray(target),
                                 jnp.asarray(mask)))
    out = float(ti.inpaint_loss(torch.from_numpy(pred),
                                torch.from_numpy(target),
                                torch.from_numpy(mask)))
    assert out == pytest.approx(ref, rel=1e-6)


# -- the discriminator and the generator's train mode ------------------------

def _jax_disc_vars(seed=0, dtype=jnp.float32):
    """The discriminator and flax's init of it, as train_inpaint draws it
    (seed + 1 there)."""
    disc = JDisc(base=D_BASE, dtype=dtype)
    v = jax.jit(disc.init)(jax.random.PRNGKey(seed), jnp.zeros((1, S, S, 3)))
    return disc, v


def _port_disc(flat):
    d = lama.LamaDiscriminator(base=D_BASE)
    assert load_lama_weights(d, flat) == len(flat) == 16
    return d


def test_discriminator_matches_jax():
    """Random non-trivial weights (flax's init, GroupNorm scales and biases
    drawn), float32, 2 x 64²: logits and the four feature maps within
    1e-5 (observed 5.0e-6, on features up to 5.3); flax's GroupNorm
    epsilon is 1e-6."""
    disc, v = _jax_disc_vars()
    rng = np.random.default_rng(1)
    flat = _flat(v["params"])
    for k in flat:
        if "/norm" in k:
            flat[k] = rng.uniform(0.5, 1.5, flat[k].shape).astype(
                np.float32) * (1 if k.endswith("scale") else 0.3)
    x = _images(2)
    logits, feats = jax.jit(disc.apply)({"params": _tree(flat)["params"]},
                                        jnp.asarray(x))
    port = _port_disc(flat)
    assert port.norm1.eps == 1e-6
    with torch.no_grad():
        tl, tf = port(torch.from_numpy(x))
    assert tl.dtype == torch.float32 and tl.shape == (N, 6, 6, 1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(logits), rtol=0,
                               atol=1e-5)
    for t, f in zip(tf, feats):
        np.testing.assert_allclose(t.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(f), rtol=0, atol=1e-5)


def _jax_gen_vars(seed=0, dtype=jnp.float32):
    """The narrow generator and init_lama's variables of it (jitted: the
    same draws)."""
    model = jlama.LamaGenerator(base_channels=BASE, num_blocks=BLOCKS,
                                dtype=dtype)
    return model, jax.jit(lambda: jinit_lama(model, img_size=S,
                                             seed=seed))()


def _port_gen(flat):
    model = lama.LamaGenerator(base_channels=BASE, num_blocks=BLOCKS)
    load_lama_weights(model, flat)
    return model


def _masks(seed, n=N, s=S):
    """JAX's random_mask_batch of PRNGKey(seed), as a writable array."""
    return np.array(jax.jit(jti.random_mask_batch, static_argnums=(1, 2))(
        jax.random.PRNGKey(seed), n, s))


def test_generator_train_mode_matches_flax_after_two_steps():
    """Two train-mode forwards (batch statistics, the running ones
    updated) from the same flax init on two batches: the outputs within
    1e-4 (observed 5.7e-6) and every running mean and variance within
    1e-5 (observed 6.0e-7). torch's BatchNorm2d, which the parent built,
    moves the variance toward the unbiased batch variance: with it this
    test fails, block0/ffc1/bn_g's variances 3.2e-3 off flax's."""
    jmodel, v = _jax_gen_vars()
    params, bs = v["params"], v["batch_stats"]
    model = _port_gen({**_flat(params), **_flat(bs, "batch_stats")}).train()
    apply = jax.jit(functools.partial(jmodel.apply, train=True,
                                      mutable=["batch_stats"]))
    for step in range(2):
        x, m = _images(10 + step), _masks(10 + step)
        ref, mut = apply({"params": params, "batch_stats": bs},
                         jnp.asarray(x), jnp.asarray(m))
        bs = mut["batch_stats"]
        out = model(torch.from_numpy(x), torch.from_numpy(m))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                                   rtol=0, atol=1e-4)
    got = module_to_flax(model, lama_flax_path)
    want = _flat(bs, "batch_stats")
    assert len(want) == 2 * sum(isinstance(m_, torch.nn.BatchNorm2d)
                                for m_ in model.modules())
    for k, ref in want.items():
        np.testing.assert_allclose(got[k], ref, rtol=1e-5, atol=1e-5,
                                   err_msg=k)


# -- the GAN step against JAX's ----------------------------------------------

class _Stop(Exception):
    pass


_SGD1 = types.SimpleNamespace(  # update = -grad
    chain=optax.chain, clip_by_global_norm=lambda c: optax.identity(),
    adam=lambda lr: optax.sgd(1.0), apply_updates=optax.apply_updates)


def _jax_step(monkeypatch, dtype, opt_ns=optax):
    """JAX's step closure of train_inpaint with the narrow models in
    `dtype`, jitted, and the tx each optimizer state is built with. The
    run's own initial variables are not used (the tests start from
    _start's), so its inits are stubbed."""
    got = []

    class Jax:
        def __getattr__(self, name):
            return getattr(jax, name)

        def jit(self, fn=None, **kw):
            if fn is None:
                return lambda f: self.jit(f, **kw)
            got.append(jax.jit(fn, **kw))
            return fn

    def stop(*a, **k):
        raise _Stop

    stub = {"params": {"w": jnp.zeros(1)}, "batch_stats": {}}
    disc = JDisc(base=D_BASE, dtype=dtype)
    monkeypatch.setattr(jti, "jax", Jax())
    monkeypatch.setattr(jti, "optax", opt_ns)
    monkeypatch.setattr(jti, "load_clean_batches", stop)
    monkeypatch.setattr(jlama, "create_lama", lambda variant: (
        jlama.LamaGenerator(base_channels=BASE, num_blocks=BLOCKS,
                            dtype=dtype)))
    monkeypatch.setattr(jlama, "init_lama", lambda *a, **k: stub)
    monkeypatch.setattr(jlama, "LamaDiscriminator", lambda: (
        types.SimpleNamespace(init=lambda *a: stub, apply=disc.apply)))
    with pytest.raises(_Stop):
        jti.train_inpaint("unused", "unused", img_size=S, batch_size=N,
                          lr=LR, d_lr=D_LR)
    tx = opt_ns.chain(opt_ns.clip_by_global_norm(1.0), opt_ns.adam(LR))
    d_tx = opt_ns.chain(opt_ns.clip_by_global_norm(1.0), opt_ns.adam(D_LR))
    return got[0], tx, d_tx


def _start(dtype):
    """The step's starting state: flax's init of both narrow models (the
    same draws train_inpaint makes), cast to `dtype`."""
    _, v = _jax_gen_vars(0)
    _, dv = _jax_disc_vars(1)
    cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: jnp.asarray(a, dtype), t)
    return cast(v["params"]), cast(v["batch_stats"]), cast(dv["params"])


def _port_trainer(params, bs, d_params, dtype):
    model = _port_gen({**_flat(params), **_flat(bs, "batch_stats")})
    disc = _port_disc(_flat(d_params))
    return ti.InpaintTrainer(model.to(dtype), disc.to(dtype), LR, D_LR,
                             compute_dtype=None)


def _as_flax(module, grads):
    """Gradients of `module`'s parameters in flax's names and layouts."""
    saved = [p.data for p in module.parameters()]
    for p, g in zip(module.parameters(), grads):
        p.data = g
    try:
        return {k: v for k, v in module_to_flax(module, lama_flax_path)
                .items() if k.startswith("params/")}
    finally:
        for p, s in zip(module.parameters(), saved):
            p.data = s


def test_gan_step_matches_jax_in_float64(monkeypatch):
    """One GAN step from the same state, images and masks, both packages'
    modules in float64. JAX's gradients come from its own step (optax's
    chain as SGD at rate 1, so the update is minus the gradient); JAX
    casts to float32 around its DFT, its sigmoid and its logits in any
    dtype, the port stays in float64 there, so the two differ by JAX's
    float32 rounding. Every gradient of the generator's loss (L1 +
    gradient terms, the adversarial term, feature matching) and of the
    discriminator's hinge loss within 1e-5 of each tensor's largest
    (observed 4.2e-7), the losses within rel 1e-6 (observed 4.2e-7); the
    biases of the discriminator's convs 1-3 have no gradient (InstanceNorm
    follows them): both hold rounding noise of ~2e-16 there, under the
    1e-12 floor. Then InpaintTrainer.step against JAX's optimizer chain
    (clip_by_global_norm(1.0) + adam, lr 2e-4 and 1e-4) on JAX's
    gradients: the running statistics within 1e-6 (observed 5.9e-8),
    every parameter within Adam's ±2·lr (the first step moves each by
    about ±lr whatever its gradient's size, so a gradient near zero may
    take the other sign)."""
    key = jax.random.PRNGKey(5)
    x = _images(7).astype(np.float64)
    tree_sub = functools.partial(jax.tree_util.tree_map,
                                 lambda a, b: a - b)
    with jax.enable_x64(True):
        step, tx, d_tx = _jax_step(monkeypatch, jnp.float64, _SGD1)
        params, bs, d_params = _start(jnp.float64)
        masks = torch.from_numpy(_masks(5)).double()
        out = step(params, bs, tx.init(params), d_params,
                   d_tx.init(d_params), jnp.asarray(x), key, use_gan=True)
        new, new_bs, _, new_d, _, g_loss, d_loss = out
        g_tree, d_tree = tree_sub(params, new), tree_sub(d_params, new_d)
        stepped = []
        for p, g, lr in ((params, g_tree, LR), (d_params, d_tree, D_LR)):
            real = optax.chain(optax.clip_by_global_norm(1.0),
                               optax.adam(lr))
            upd, _ = real.update(g, real.init(p), p)
            stepped.append(_flat(optax.apply_updates(p, upd)))
        jg, jd = _flat(g_tree), _flat(d_tree)
    trainer = _port_trainer(params, bs, d_params, torch.float64)
    images = torch.from_numpy(x)
    tl, fake, grads = trainer.g_loss_grads(images, masks, True)
    dl, d_grads = trainer.d_loss_grads(images, fake)
    assert float(tl) == pytest.approx(float(g_loss), rel=1e-6)
    assert float(dl) == pytest.approx(float(d_loss), rel=1e-6)
    for want, got in ((jg, _as_flax(trainer.model, grads)),
                      (jd, _as_flax(trainer.disc, d_grads))):
        assert set(want) == set(got)
        for k in want:
            scale = np.abs(want[k]).max()
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=1e-5 * scale + 1e-12, err_msg=k)
    fresh = _port_trainer(params, bs, d_params, torch.float64)
    sl, sd = fresh.step(images, None, True, masks=masks)
    assert float(sl) == float(tl) and float(sd) == float(dl)
    got = fresh.weights()
    for k, ref in _flat(new_bs, "batch_stats").items():
        np.testing.assert_allclose(got[k], ref, rtol=0, atol=1e-6,
                                   err_msg=k)
    got_d = module_to_flax(fresh.disc, lama_flax_path)
    for want, have, lr in ((stepped[0], got, LR), (stepped[1], got_d, D_LR)):
        for k, ref in want.items():
            assert np.abs(have[k] - ref).max() <= 2 * lr + 1e-9, k


def test_warmup_step_leaves_the_discriminator():
    """Without the GAN terms (warmup) the step updates the generator only
    and its d_loss is 0."""
    params, bs, d_params = _start(jnp.float32)
    trainer = _port_trainer(params, bs, d_params, torch.float32)
    before = module_to_flax(trainer.disc, lama_flax_path)
    g_before = trainer.weights()
    tl, dl = trainer.step(torch.from_numpy(_images(8)),
                          torch.Generator().manual_seed(0), False)
    assert float(dl) == 0.0 and np.isfinite(float(tl))
    after = module_to_flax(trainer.disc, lama_flax_path)
    for k in before:
        np.testing.assert_array_equal(after[k], before[k])
    moved = trainer.weights()
    assert any(not np.array_equal(moved[k], g_before[k]) for k in g_before
               if k.startswith("params/"))


# -- the samplers ------------------------------------------------------------

def _write_folder(d, shapes, seed=0):
    d.mkdir(parents=True, exist_ok=True)
    for i, (h, w) in enumerate(shapes):
        img, _ = watermarked_images(1, max(h, w), seed=seed + i, clean=1)
        write_png(d / f"c{i:02d}.png",
                  np.rint(img[0, :h, :w] * 255).astype(np.uint8))


def test_device_clean_sampler_gathers_random_crops(tmp_path):
    """(batch, size, size, 3) float32 crops in one gather: each equals the
    crop that the generator's draws name (drawn again from the same
    seed), and the same image count as JAX's sampler."""
    d = tmp_path / "eq"
    _write_folder(d, [(80, 96)] * 3)
    sample, n = ti.device_clean_sampler(str(d), 5, 48, device="cpu")
    assert n == jti.device_clean_sampler(str(d), 5, 48)[1] == 3
    out = sample(torch.Generator().manual_seed(4))
    assert out.shape == (5, 48, 48, 3) and out.dtype == torch.float32
    g = torch.Generator().manual_seed(4)
    idx = torch.randint(0, 3, (5,), generator=g)
    ys = torch.randint(0, 80 - 48 + 1, (5,), generator=g)
    xs = torch.randint(0, 96 - 48 + 1, (5,), generator=g)
    imgs = [torch.from_numpy(ti.image_io.read_rgb(p))
            for p in ti.clean_files(str(d))]
    for j in range(5):
        y, x = int(ys[j]), int(xs[j])
        want = imgs[int(idx[j])][y:y + 48, x:x + 48].float() / 255.0
        assert torch.equal(out[j], want)


@pytest.mark.parametrize("case", ["mixed", "small", "max_mb"])
def test_device_clean_sampler_returns_none_as_jax(tmp_path, case):
    shapes = {"mixed": [(64, 64), (64, 80)], "small": [(64, 64), (40, 64)],
              "max_mb": [(64, 64)] * 2}[case]
    d = tmp_path / case
    _write_folder(d, shapes)
    max_mb = 0 if case == "max_mb" else 2048
    assert jti.device_clean_sampler(str(d), 2, 48, max_mb=max_mb) is None
    assert ti.device_clean_sampler(str(d), 2, 48, max_mb=max_mb,
                                   device="cpu") is None


def test_load_clean_batches_equals_jax(tmp_path):
    """The host iterator's first 3 batches equal JAX's value for value: the
    same numpy draws, cv2.imread's pixels, and an image smaller than the
    crop resized up as cv2's INTER_LINEAR resizes it."""
    d = tmp_path / "mixed"
    _write_folder(d, [(80, 96), (64, 64), (40, 70), (100, 52)])
    ours = ti.load_clean_batches(str(d), 3, 56, seed=2)
    ref = jti.load_clean_batches(str(d), 3, 56, seed=2)
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_webp_in_the_clean_folder_raises_before_any_work(tmp_path):
    """A still WEBP in the clean folder decodes as cv2 reads it, and a
    truncated one (cv2.imread gives None) is skipped as JAX skips it: both
    samplers count the same images and the host batches equal JAX's. An
    animated WEBP, a form not ported yet, still refuses the folder before
    any work (ROADMAP.md §A.5)."""
    import cv2
    import struct

    d = tmp_path / "webp"
    _write_folder(d, [(64, 64)] * 2)
    ok, data = cv2.imencode(".webp", cv2.imread(str(d / "c00.png"))[:, ::-1],
                            [cv2.IMWRITE_WEBP_QUALITY, 80])
    (d / "w.webp").write_bytes(data.tobytes())
    (d / "z.webp").write_bytes(data.tobytes()[:len(data) // 2])
    assert cv2.imread(str(d / "z.webp")) is None
    assert ti.device_clean_sampler(str(d), 2, 32, device="cpu")[1] == \
        jti.device_clean_sampler(str(d), 2, 32)[1] == 3
    ours = ti.load_clean_batches(str(d), 3, 32, seed=1)
    ref = jti.load_clean_batches(str(d), 3, 32, seed=1)
    for _ in range(2):
        np.testing.assert_array_equal(next(ours), next(ref))
    vp8x = b"VP8X" + struct.pack("<I", 10) + bytes([2, 0, 0, 0]) + bytes(6)
    (d / "z.webp").write_bytes(b"RIFF" + struct.pack("<I", 4 + len(vp8x))
                               + b"WEBP" + vp8x)
    for call in (lambda: ti.device_clean_sampler(str(d), 2, 32,
                                                 device="cpu"),
                 lambda: next(ti.load_clean_batches(str(d), 2, 32)),
                 lambda: ti.train_inpaint(str(d), str(tmp_path / "o"),
                                          device="cpu")):
        with pytest.raises(NotImplementedError, match="§A.5"):
            call()
    assert not (tmp_path / "o").exists()


# -- the whole trainer, its outputs both ways --------------------------------

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """`python -m ...train_inpaint` at full width ('lama') with JAX's flags
    and --device cpu: 64², batch 2, 4 steps (2 of warmup, a log every 2
    steps: log_every is not a flag, so the history of the run comes from
    train_inpaint's meta.json, logged at log_every)."""
    import json

    root = tmp_path_factory.mktemp("inpaint")
    _write_folder(root / "clean", [(64, 64)] * 4)
    out = root / "lama"
    argv = ["--clean-dir", str(root / "clean"), "--output", str(out),
            "--img-size", "64", "--batch-size", "2", "--steps", "4",
            "--warmup-steps", "2"]
    orig = ti.train_inpaint
    ti.train_inpaint = functools.partial(orig, log_every=2)
    try:
        assert ti.main(argv + ["--device", "cpu"]) == 0
    finally:
        ti.train_inpaint = orig
    meta = json.loads((out / "meta.json").read_text())
    return root, out, meta, argv


def test_train_inpaint_writes_what_both_packages_serve(trained, monkeypatch):
    """The history's losses and hole PSNR are finite; the checkpoint
    directory and its .npz load through the port's get_engine("lama") as
    "ffc-lama" with the same weights; JAX's get_engine("lama",
    weights_path=<the .npz>) serves them, its bf16 output on hole pixels
    within max 5e-3 and mean 1e-3 of the port's bf16 engine (the bound of
    test_torch_lama.py's bf16 test; observed max 5.4e-4, mean 1.0e-4),
    known pixels the input's."""
    root, out, meta, _ = trained
    history = meta["history"]
    assert [h["step"] for h in history] == [2, 4]
    for h in history:
        assert all(np.isfinite([h["g_loss"], h["d_loss"], h["hole_psnr"]]))
    assert history[0]["d_loss"] == 0.0  # warmup
    assert history[1]["d_loss"] > 0.0
    assert meta["variant"] == "lama" and meta["steps"] == 4
    npz = str(out) + ".npz"
    a = engines.get_engine("lama", weights_path=str(out), device="cpu")
    b = engines.get_engine("lama", weights_path=npz, device="cpu")
    assert a.name == b.name == "ffc-lama"
    img = _images(3)
    mask = _masks(3)
    oa, ob = a(img, mask), b(img, mask)
    assert torch.equal(oa, ob)  # the dir's fp32 weights cast to bf16
    # JAX's loader inits a 256² model only for its tree: give it the tree
    from test_torch_lama import _template

    monkeypatch.setattr(jlama, "init_lama", lambda m, img_size=256, seed=0:
                        _template(npz))
    monkeypatch.delenv("PREDICT_INPAINT_WEIGHTS", raising=False)
    ref = np.asarray(jengines.get_engine("lama", weights_path=npz)(
        jnp.asarray(img), jnp.asarray(mask)))
    hole = np.broadcast_to(mask > 0, img.shape)
    err = np.abs(oa.numpy() - ref)[hole]
    assert err.max() <= 5e-3 and err.mean() <= 1e-3, (err.max(), err.mean())
    np.testing.assert_array_equal(oa.numpy()[~hole], img[~hole])


def test_jax_npz_resumes_in_the_port():
    """--resume-from a .npz the JAX package wrote (the shipped
    lama_ffc.npz, from its train_inpaint): the generator starts from its
    weights as they are (bf16 values in float32), all 433."""
    src = WEIGHTS_DIR / "lama_ffc.npz"
    want = load_npz(src)
    got = ti.build_trainer(resume_from=str(src), device="cpu").weights()
    assert set(got) == set(want) and len(want) == 433
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_orbax_directories_raise_naming_a7(tmp_path):
    """What JAX's train_inpaint writes at `output` ({"params",
    "batch_stats"} saved by orbax's StandardCheckpointer, written here
    with orbax from a seeded generator) loads in the port's loader and as
    --resume-from, its weights those JAX's load_variables restores and
    its fill JAX's generator's with them; a
    directory that is neither a port checkpoint nor an orbax store (an
    empty tree/ folder, an orbax metadata file alone) still raises."""
    import orbax.checkpoint as ocp

    from unet_watermark_tpu.utils.shipping import load_variables
    from unet_watermark_tpu_torch.models.factory import init_model

    model = init_model(lama.create_lama("lama", torch.float32), 7)
    flat = module_to_flax(model, lama_flax_path)
    tree = _tree(flat)
    out = tmp_path / "lama_out"
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(out, tree)
    ckptr.wait_until_finished()
    want = {k: np.asarray(v) for k, v in flatten_tree(
        load_variables(str(out), tree)).items()}
    loaded, name = engines.load_lama(str(out), device="cpu",
                                     dtype=torch.float32)
    trainer = ti.build_trainer(resume_from=str(out), device="cpu")
    assert name == "lama"
    for got in (module_to_flax(loaded, lama_flax_path), trainer.weights()):
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    # the fill: JAX's generator with the variables JAX's loader restored
    # against the loaded port model, float32, 1 x 32²; atol 1e-4
    # (tests/test_torch_lama.py's), observed 2.4e-7
    img = _images(4, n=1, s=32)
    mask = (np.random.default_rng(5).random((1, 32, 32, 1)) > 0.7).astype(
        np.float32)
    jmodel = jlama.create_lama("lama", dtype=jnp.float32)
    jvars = load_variables(str(out), tree)
    ref = np.asarray(jax.jit(lambda v, a, b: jmodel.apply(
        v, a, b, train=False))(jvars, img, mask))
    with torch.inference_mode():
        fill = loaded(torch.from_numpy(img), torch.from_numpy(mask))
    np.testing.assert_allclose(fill.numpy(), ref, rtol=0, atol=1e-4)
    for d in (tmp_path / "orbax", tmp_path / "ck"):
        d.mkdir()
    (tmp_path / "orbax" / "_CHECKPOINT_METADATA").write_text("{}")
    (tmp_path / "ck" / "tree").mkdir()
    for d in (tmp_path / "orbax", tmp_path / "ck"):
        with pytest.raises(FileNotFoundError, match="no checkpoint"):
            engines.load_lama(d, device="cpu")
        with pytest.raises(FileNotFoundError, match="no checkpoint"):
            ti.build_trainer(resume_from=str(d), device="cpu")


def test_cli_defaults_to_the_card(trained):
    """With no --device the command takes "cuda", which raises without a
    card (the fixture ran it with --device cpu)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default trains there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ti.main(trained[3])
