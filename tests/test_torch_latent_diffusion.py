"""The port's latent-diffusion inpainter (diffusion/latent_diffusion.py),
its trainer (training/train_latent_diffusion.py), its engine and the
`repair --watermark-model diffusion` command against the JAX package's,
on the CPU, with the shipped latent_diffusion.npz. Inputs come from
np.random.default_rng; each test states its tolerance and what it
observed.

JAX's two train steps are closures inside train_latent_diffusion; the
tests take them from there as tests/test_torch_train_inpaint.py takes the
GAN step (jax.jit handed back, the models in float64, optax's chains as
SGD at rate 1, so an update is minus JAX's own gradient)."""
import functools
import json
import logging
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from test_torch_lama import _template
from test_torch_repair import PORT_KEYS, TIME_KEYS, _jax
from test_torch_train_inpaint import _Stop, _write_folder
from unet_watermark_tpu import cli as jax_cli
from unet_watermark_tpu.diffusion import latent_diffusion as jld
from unet_watermark_tpu.training import train_inpaint as jti
from unet_watermark_tpu.training import train_latent_diffusion as jtld
from unet_watermark_tpu.utils import shipping as jshipping
from unet_watermark_tpu.utils.shipping import flatten_tree, load_params_npz
from unet_watermark_tpu_torch import cli
from unet_watermark_tpu_torch.diffusion import latent_diffusion as ld
from unet_watermark_tpu_torch.inference import engines
from unet_watermark_tpu_torch.models.convert import (ld_torch_name,
                                                     load_flax_weights)
from unet_watermark_tpu_torch.training import train_latent_diffusion as tld
from unet_watermark_tpu_torch.utils import shipping
from unet_watermark_tpu_torch.utils.image_io import write_png
from unet_watermark_tpu_torch.utils.shipping import WEIGHTS_DIR, load_npz
from unet_watermark_tpu_torch.utils.synthetic import watermarked_images

torch.set_num_threads(2)

LD = WEIGHTS_DIR / "latent_diffusion.npz"
S, N = 64, 2
_init_ld = jld.init_ld_variables


def jinit_ld(ae, denoiser, img_size=64, seed=0):
    """JAX's init_ld_variables, jitted (the same draws): its eager init
    takes seconds for a template whose values are replaced."""
    return jax.jit(lambda: _init_ld(ae, denoiser, img_size, seed))()


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_tree(tree).items()}


def _nhwc(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.fixture(scope="module")
def jvars():
    return load_params_npz(str(LD), _template(LD))


@pytest.fixture(scope="module")
def port32():
    """The shipped weights in the port's inpainter, float32 throughout."""
    return ld.LatentInpainter(str(LD), device="cpu", dtype=None)


# -- layout and schedule -----------------------------------------------------

@pytest.mark.parametrize("src,dst", [(16, 2), (64, 8), (96, 12), (40, 5),
                                     (17, 3), (10, 4)])
def test_downsample_mask_is_jax_image_resize_nearest(src, dst):
    """jax.image.resize(..., "nearest") takes row floor((i + 0.5)·src/dst),
    8i + 4 at /8: equal, value for value. F.interpolate's "nearest" takes
    8i and differs."""
    m = np.random.default_rng(src).random((2, src, src + 3, 1)).astype(
        np.float32)
    w = (src + 3) * dst // src or 1
    ref = np.asarray(jax.image.resize(jnp.asarray(m), (2, dst, w, 1),
                                      "nearest"))
    out = ld.downsample_mask(torch.from_numpy(m), dst, w).numpy()
    np.testing.assert_array_equal(out, ref)
    if src == 8 * dst:
        plain = torch.nn.functional.interpolate(
            torch.from_numpy(m).permute(0, 3, 1, 2), size=(dst, w),
            mode="nearest").permute(0, 2, 3, 1).numpy()
        assert not np.array_equal(plain, ref)


def test_schedule_and_timesteps_match_jax():
    np.testing.assert_array_equal(ld.alpha_bars(), jld.alpha_bars())
    for steps in range(1, 61):
        np.testing.assert_array_equal(
            ld.ddim_timesteps(steps),
            np.asarray(jnp.linspace(jld.T_TRAIN - 1, 1, steps).astype(
                jnp.int32)), err_msg=str(steps))


@pytest.mark.parametrize("s,cin,cout", [(4, 8, 6), (5, 16, 8)])
def test_conv_transpose_same_flip_with_bias(s, cin, cout):
    """flax ConvTranspose(4x4, stride 2, SAME, bias) loaded through the
    latent-diffusion name map: the kernel permuted and flipped; atol 1e-5
    (observed 3.8e-6 on outputs up to 27). Without the flip the outputs
    differ by O(1)."""
    rng = np.random.default_rng(s * cin)
    x = _nhwc(rng, 2, s, s, cin)
    kernel = _nhwc(rng, 4, 4, cin, cout)
    bias = _nhwc(rng, cout)
    jconv = fnn.ConvTranspose(cout, (4, 4), strides=(2, 2), padding="SAME")
    ref = np.asarray(jconv.apply({"params": {"kernel": kernel,
                                             "bias": bias}}, x))
    module = torch.nn.Module()
    module.up0 = torch.nn.ConvTranspose2d(cin, cout, 4, 2, 1)
    load_flax_weights(module, {"up0/kernel": kernel, "up0/bias": bias},
                      ld_torch_name)
    with torch.no_grad():
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        out = module.up0(xt).permute(0, 2, 3, 1).numpy()
        unflipped = torch.nn.functional.conv_transpose2d(
            xt, torch.from_numpy(np.ascontiguousarray(np.transpose(
                kernel, (2, 3, 0, 1)))), torch.from_numpy(bias), 2,
            1).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    assert np.abs(unflipped - ref).max() > 0.5


# -- the modules on the shipped weights --------------------------------------

def test_shipped_weights_load_every_key_once(port32):
    flat = load_npz(LD)
    assert len(flat) == 112
    assert ld.load_ld_weights(ld.TinyAutoencoder(), ld.LatentDenoiser(),
                              flat) == 112
    back = ld.ld_weights(port32.ae, port32.denoiser)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


def test_autoencoder_matches_jax(jvars, port32):
    """float32, shipped weights, 2 x 64²: the latent and the
    reconstruction within 1e-5 (observed 1.6e-6)."""
    x = np.random.default_rng(0).random((N, S, S, 3)).astype(np.float32)
    ae = jld.TinyAutoencoder(dtype=jnp.float32)
    v = {"params": jvars["ae"]}
    z = np.asarray(jax.jit(functools.partial(
        ae.apply, method=jld.TinyAutoencoder.encode))(v, x))
    rec = np.asarray(jax.jit(ae.apply)(v, x))
    with torch.no_grad():
        tz = port32.ae.encode(torch.from_numpy(x))
        trec = port32.ae(torch.from_numpy(x))
    assert tz.shape == (N, S // 8, S // 8, 4) and tz.dtype == torch.float32
    np.testing.assert_allclose(tz.numpy(), z, rtol=0, atol=1e-5)
    np.testing.assert_allclose(trec.numpy(), rec, rtol=0, atol=1e-5)


def test_timestep_embedding_matches_jax():
    """float32; atol 5e-5 (observed 3.1e-5: XLA's and torch's float32 exp
    give 9 of the 64 frequencies one ulp apart, which t = 998 makes 3e-5
    of angle)."""
    t = np.array([0, 1, 17, 500, 998, 999], np.int32)
    ref = np.asarray(jld.timestep_embedding(jnp.asarray(t)))
    out = ld.timestep_embedding(torch.from_numpy(t)).numpy()
    assert out.shape == ref.shape == (6, 128)
    np.testing.assert_allclose(out, ref, rtol=0, atol=5e-5)


def test_denoiser_matches_jax(jvars, port32):
    """float32, shipped weights, latents of 2 x 8², timesteps across the
    schedule: eps within 1e-4 (observed 5.2e-6 on values up to 6.7)."""
    rng = np.random.default_rng(1)
    z_t, z_m = _nhwc(rng, N, 8, 8, 4), _nhwc(rng, N, 8, 8, 4)
    m = (rng.random((N, 8, 8, 1)) < 0.4).astype(np.float32)
    t = np.array([999, 3], np.int32)
    dn = jld.LatentDenoiser(dtype=jnp.float32)
    ref = np.asarray(jax.jit(dn.apply)({"params": jvars["denoiser"]}, z_t,
                                       z_m, m, t))
    with torch.no_grad():
        out = port32.denoiser(*(torch.from_numpy(a) for a in (z_t, z_m, m,
                                                               t)))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)


def _holes(seed, n=N, s=S):
    m = np.zeros((n, s, s, 1), np.float32)
    rng = np.random.default_rng(seed)
    for i in range(n):
        y, x = rng.integers(4, s // 2, 2)
        m[i, y:y + s // 3, x:x + s // 4] = 1.0
    return m


def test_sampler_fed_jax_noise_matches_jax(port32, monkeypatch):
    """The DDIM fill, 4 steps at 2 x 64², float32 in both, the port's
    sampler given the noise JAX's draws (recovered from its key as it
    splits it): within 1e-5 on hole pixels (observed 7.2e-7; each step
    divides by sqrt(alpha_bar), 3e-3 at t = 999, but z0_hat is clipped to
    ±1.5); known pixels equal to the input's in both."""
    monkeypatch.setattr(jld, "init_ld_variables", jinit_ld)
    inp = jld.LatentInpainter(str(LD))
    inp.ae = jld.TinyAutoencoder(dtype=jnp.float32)
    inp.denoiser = jld.LatentDenoiser(dtype=jnp.float32)
    x = np.random.default_rng(2).random((N, S, S, 3)).astype(np.float32)
    m = _holes(2)
    ref = inp.inpaint(x, m, steps=4, seed=0)
    key = jax.random.PRNGKey(0)
    shape = (N, S // 8, S // 8, 4)
    z_init = np.array(jax.random.normal(key, shape))
    noise = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), shape)) for i in range(4)])
    out = port32.sample(torch.from_numpy(x), torch.from_numpy(m),
                        torch.from_numpy(z_init), torch.from_numpy(noise))
    hole = np.broadcast_to(m > 0, x.shape)
    np.testing.assert_allclose(out.numpy()[hole], ref[hole], rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(out.numpy()[~hole], x[~hole])
    np.testing.assert_array_equal(ref[~hole], x[~hole])
    assert np.ptp(out.numpy()[hole]) > 0.1


def test_inpaint_on_bgr_keeps_known_pixels_and_shape():
    """diffusion_inpaint_bgr on a 50 x 70 BGR image (padded to 64 x 96):
    the shape and dtype back, known pixels as JAX computes them
    ((v / 255)·255 in float32, truncated), from the cached inpainter."""
    img = (np.random.default_rng(3).random((50, 70, 3)) * 255).astype(
        np.uint8)
    mask = np.zeros((50, 70), np.uint8)
    mask[10:30, 20:50] = 255
    out = ld.diffusion_inpaint_bgr(img, mask, steps=2, device="cpu")
    assert out.shape == img.shape and out.dtype == np.uint8
    keep = mask <= 127
    want = (img.astype(np.float32) / np.float32(255) * np.float32(255)
            ).astype(np.uint8)
    np.testing.assert_array_equal(out[keep], want[keep])
    assert ld.get_inpainter("cpu") is ld.get_inpainter("cpu")


# -- the train steps against JAX's -------------------------------------------

_SGD1 = types.SimpleNamespace(  # update = -grad
    chain=optax.chain, clip_by_global_norm=lambda c: optax.identity(),
    adam=lambda lr: optax.sgd(1.0), apply_updates=optax.apply_updates)


class AE64(jld.TinyAutoencoder):
    dtype: object = jnp.float64


class Denoiser64(jld.LatentDenoiser):
    dtype: object = jnp.float64


def _jax_steps(monkeypatch, variables):
    """JAX's ae_step and dn_step closures of train_latent_diffusion with
    float64 modules, starting from `variables`, jitted."""
    got = []

    def key(seed):
        if len(got) == 2:
            raise _Stop  # both steps are defined: the loop's key is next
        return jax.random.PRNGKey(seed)

    class Jax:
        random = types.SimpleNamespace(**{
            k: getattr(jax.random, k) for k in dir(jax.random)
            if not k.startswith("_")} | {"PRNGKey": key})

        def __getattr__(self, name):
            return getattr(jax, name)

        def jit(self, fn):
            got.append(jax.jit(fn))
            return fn

    monkeypatch.setattr(jtld, "jax", Jax())
    monkeypatch.setattr(jtld, "optax", _SGD1)
    monkeypatch.setattr(jtld, "TinyAutoencoder", AE64)
    monkeypatch.setattr(jtld, "LatentDenoiser", Denoiser64)
    monkeypatch.setattr(jtld, "init_ld_variables", lambda *a, **k: variables)
    monkeypatch.setattr(jtld, "device_clean_sampler", lambda *a, **k: None)
    monkeypatch.setattr(jtld, "load_clean_batches", lambda *a, **k: iter(()))
    with pytest.raises(_Stop):
        jtld.train_latent_diffusion("unused", "unused", img_size=S,
                                    batch_size=N, ae_steps=0, dn_steps=0)
    return got


def _grads_as_flax(module, grads, prefix):
    saved = [p.data for p in module.parameters()]
    for p, g in zip(module.parameters(), grads):
        p.data = g
    try:
        return ld.module_to_flax(module, ld.ld_flax_path, params=prefix)
    finally:
        for p, s in zip(module.parameters(), saved):
            p.data = s


def test_train_steps_gradients_match_jax_in_float64(monkeypatch):
    """The autoencoder's L1 step and the denoiser's eps-MSE step (masks,
    timesteps and noise recovered from the step's key) from flax's init,
    both packages' modules in float64 (the latent, the reconstruction and
    eps are float32 in both, where each casts): losses within rel 1e-6
    (observed 1.4e-9), every gradient within 1e-5 of its tensor's largest
    (observed 3.1e-7)."""
    x = np.random.default_rng(4).random((N, S, S, 3))
    key = jax.random.PRNGKey(6)
    with jax.enable_x64(True):
        v32 = jinit_ld(jld.TinyAutoencoder(), jld.LatentDenoiser(), S, 0)
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                   v32)
        ae_step, dn_step = _jax_steps(monkeypatch, v)
        tx = optax.sgd(1.0)
        new_ae, _, ae_loss = ae_step(v["ae"], tx.init(v["ae"]),
                                     jnp.asarray(x))
        ctx = optax.chain(optax.identity(), optax.sgd(1.0))
        new_dn, _, dn_loss = dn_step(v["denoiser"], ctx.init(v["denoiser"]),
                                     jnp.asarray(x), key)
        k_mask, k_t, k_eps = jax.random.split(key, 3)
        masks = np.asarray(jti.random_mask_batch(k_mask, N, S))
        t = np.asarray(jax.random.randint(k_t, (N,), 0, jld.T_TRAIN))
        eps = np.asarray(jax.random.normal(k_eps, (N, S // 8, S // 8, 4)))
        want = {**_flat({"ae": jax.tree_util.tree_map(
            lambda a, b: a - b, v["ae"], new_ae)}),
            **_flat({"denoiser": jax.tree_util.tree_map(
                lambda a, b: a - b, v["denoiser"], new_dn)})}
    ae, dn = ld.TinyAutoencoder(), ld.LatentDenoiser()
    ld.load_ld_weights(ae, dn, _flat(v32))
    trainer = tld.LatentDiffusionTrainer(ae.double(), dn.double(),
                                         compute_dtype=None)
    images = torch.from_numpy(x)
    tl, ae_grads = trainer.ae_loss_grads(images)
    dl, dn_grads = trainer.dn_loss_grads(
        images, masks=torch.from_numpy(masks), t=torch.from_numpy(t),
        eps=torch.from_numpy(eps))
    assert float(tl) == pytest.approx(float(ae_loss), rel=1e-6)
    assert float(dl) == pytest.approx(float(dn_loss), rel=1e-6)
    got = {**_grads_as_flax(trainer.ae, ae_grads, "ae/"),
           **_grads_as_flax(trainer.denoiser, dn_grads, "denoiser/")}
    assert set(got) == set(want) and len(want) == 112
    for k in want:
        scale = np.abs(want[k]).max()
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-5 * scale + 1e-12, err_msg=k)


def test_trainer_steps_run_and_move_the_weights():
    """ae_step (adam, no clip) and dn_step (clip 1.0 + adam) in bf16 on
    the CPU: finite losses; the autoencoder moves only in stage 1, the
    denoiser only in stage 2."""
    trainer = tld.build_ld_trainer(0, "cpu")
    x = torch.from_numpy(np.random.default_rng(5).random(
        (N, S, S, 3)).astype(np.float32))
    w0 = trainer.weights()
    assert np.isfinite(float(trainer.ae_step(x)))
    w1 = trainer.weights()
    assert np.isfinite(float(trainer.dn_step(x, torch.Generator()
                                             .manual_seed(0))))
    w2 = trainer.weights()
    moved = lambda a, b, p: any(  # noqa: E731
        not np.array_equal(a[k], b[k]) for k in a if k.startswith(p))
    assert moved(w0, w1, "ae/") and not moved(w0, w1, "denoiser/")
    assert moved(w1, w2, "denoiser/") and not moved(w1, w2, "ae/")
    assert trainer.dn_opt.clip == 1.0 and trainer.ae_opt.clip == 0.0


def test_trainer_writes_what_both_packages_load(tmp_path, monkeypatch):
    """`python -m ...train_latent_diffusion` with --device cpu (64², batch
    2, 2 + 2 steps) writes the port's checkpoint directory; ship_weights
    to a given path writes the shipped format, which JAX's LatentInpainter
    loads with the same values, and so do the port's (from the directory
    and from the .npz, the bf16 values in float32)."""
    _write_folder(tmp_path / "clean", [(64, 64)] * 3)
    out = tmp_path / "ld"
    assert tld.main(["--clean-dir", str(tmp_path / "clean"), "--output",
                     str(out), "--img-size", "64", "--batch-size", "2",
                     "--ae-steps", "2", "--dn-steps", "2",
                     "--device", "cpu"]) == 0
    assert (out / "tree.npz").exists()
    flat = shipping.load_variables(str(out))
    assert len(flat) == 112
    npz = tmp_path / "ship" / "latent_diffusion.npz"
    assert tld.ship_weights(flat, str(npz)) == str(npz)
    monkeypatch.setattr(jld, "init_ld_variables", jinit_ld)
    jv = _flat(jld.LatentInpainter(str(npz)).variables)
    shipped = load_npz(npz)
    assert set(jv) == set(shipped)
    for k in shipped:
        np.testing.assert_array_equal(jv[k], shipped[k], err_msg=k)
    for path, want in ((out, flat), (npz, shipped)):
        inp = ld.LatentInpainter(str(path), device="cpu")
        got = ld.ld_weights(inp.ae, inp.denoiser)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tld.main(["--clean-dir", str(tmp_path / "clean"), "--output",
                      str(tmp_path / "o2")])


# -- the engine and the repair command ---------------------------------------

def test_resolve_diffusion_matches_jax(tmp_path, monkeypatch):
    """DIFFUSION_WEIGHTS first, then the shipped file, then the legacy
    <repo>/models/latent_diffusion, each only if on disk (the env value
    verbatim), as JAX resolves."""
    monkeypatch.delenv("DIFFUSION_WEIGHTS", raising=False)
    assert shipping.resolve("diffusion") == str(LD) == \
        jshipping.resolve("diffusion")
    monkeypatch.setenv("DIFFUSION_WEIGHTS", "/env/ld.npz")
    assert shipping.resolve("diffusion") == "/env/ld.npz" == \
        jshipping.resolve("diffusion")
    assert shipping.resolve("diffusion", explicit="/x") == "/x"
    monkeypatch.delenv("DIFFUSION_WEIGHTS")
    monkeypatch.setattr(shipping, "WEIGHTS_DIR", tmp_path / "weights")
    monkeypatch.setattr(shipping, "REPO_ROOT", tmp_path)
    assert shipping.resolve("diffusion") is None
    (tmp_path / "models" / "latent_diffusion").mkdir(parents=True)
    assert shipping.resolve("diffusion") == str(
        tmp_path / "models" / "latent_diffusion")


def test_engine_falls_back_to_pushpull_without_weights(monkeypatch, caplog):
    monkeypatch.setenv("DIFFUSION_WEIGHTS", "/no/such/ld.npz")
    with caplog.at_level(logging.WARNING):
        engine = engines.get_engine("diffusion", device="cpu")
    assert engine.name == "pushpull"
    assert "falling back" in caplog.text
    monkeypatch.delenv("DIFFUSION_WEIGHTS")
    assert ld.available()


def test_repair_with_diffusion_writes_the_jax_summary(tmp_path,
                                                      monkeypatch):
    """`repair --watermark-model diffusion --no-ocr --device cpu` against
    the JAX CLI's on 3 images of 64² (one clean): the same summary apart
    from times, the port's extra keys, engine "latent-diffusion"; repaired
    pixels outside step 1's masks equal the input's."""
    folder = tmp_path / "in"
    folder.mkdir()
    imgs, _ = watermarked_images(3, 64, seed=21, clean=1)
    for i, img in enumerate(imgs):
        write_png(folder / f"d{i}.png", (img * 255).astype(np.uint8))
    opts = ["--no-ocr", "--watermark-model", "diffusion", "--device", "cpu",
            "--opts", "DATA.IMG_SIZE", "64", "MODEL.DTYPE", "float32"]
    monkeypatch.delenv("DIFFUSION_WEIGHTS", raising=False)
    assert cli.main(["repair", "--input", str(folder), "--output",
                     str(tmp_path / "t")] + opts) == 0
    jpred = _jax()
    monkeypatch.setattr("unet_watermark_tpu.inference.WatermarkPredictor",
                        lambda model_path=None, config=None: jpred)
    monkeypatch.setattr(jld, "init_ld_variables", jinit_ld)
    jargs = jax_cli.build_parser().parse_args(
        ["repair", "--input", str(folder), "--output", str(tmp_path / "j")]
        + opts)
    assert jax_cli.repair_command(jargs) == 0
    j = json.loads((tmp_path / "j" / "repair_summary.json").read_text())
    t = json.loads((tmp_path / "t" / "repair_summary.json").read_text())
    assert [t.pop(k) for k in PORT_KEYS] == [0, "latent-diffusion", None, 0]
    for key in TIME_KEYS:
        assert t.pop(key) > 0 and j.pop(key) > 0
    assert t == j and t["status"] == "success"
    from unet_watermark_tpu_torch.utils.image_io import read_gray, read_rgb
    checked = 0
    for name in sorted(p.name for p in folder.iterdir()):
        final = tmp_path / "t" / "step2_watermark_repaired" / name
        mask = tmp_path / "t" / "step1_masks" / name.replace(".png",
                                                             "_mask.png")
        if not final.exists() or not mask.exists():
            continue
        checked += 1
        keep = read_gray(mask) <= 127
        np.testing.assert_array_equal(read_rgb(final)[keep],
                                      read_rgb(folder / name)[keep])
    assert checked >= 1
