"""ops/losses.py and ops/metrics.py of the port against the JAX package's:
every loss's value and its gradient with respect to the logits (torch
autograd against jax.grad) in float32, Lovasz with tied errors (a stable
descending sort in both), get_loss_function for every configured name,
and the metrics (confusion counts with a padded batch, the metric dict,
soft dice and IoU, PSNR with and without a mask, SSIM)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_watermark_tpu.configs import get_cfg_defaults as jax_defaults
from unet_watermark_tpu.ops import losses as jl
from unet_watermark_tpu.ops import metrics as jm
from unet_watermark_tpu_torch.configs import get_cfg_defaults
from unet_watermark_tpu_torch.ops import losses as tl
from unet_watermark_tpu_torch.ops import metrics as tm

# float32 sums over 2 x 24 x 24 values in another order: values agree to
# a few ulps of their size, gradients (each ~1e-4..1e-2) to 1e-7 absolute
VALUE_RTOL, GRAD_ATOL, GRAD_RTOL = 2e-6, 1e-7, 1e-5


def _inputs(seed, ties=False):
    rng = np.random.default_rng(seed)
    shape = (2, 24, 24, 1)
    if ties:  # a few distinct logits: many tied hinge errors
        logits = rng.choice([-1.5, -0.5, 0.0, 0.5, 1.5], shape)
    else:
        logits = rng.normal(0, 3, shape)
    targets = (rng.random(shape) < 0.3).astype(np.float32)
    return logits.astype(np.float32), targets


def _both(jfn, tfn, logits, targets):
    jv, jg = jax.value_and_grad(lambda x: jfn(x, jnp.asarray(targets)))(
        jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    tv = tfn(x, torch.from_numpy(targets))
    tv.backward()
    return (float(jv), np.asarray(jg)), (tv.item(), x.grad.numpy())


LOSSES = {
    "dice": (lambda x, t: jl.dice_loss(x, t), tl.dice_loss),
    "dice_smooth1": (lambda x, t: jl.dice_loss(x, t, 1.0),
                     lambda x, t: tl.dice_loss(x, t, 1.0)),
    "jaccard": (jl.jaccard_loss, tl.jaccard_loss),
    "bce": (jl.bce_loss, tl.bce_loss),
    "focal": (jl.focal_loss, tl.focal_loss),
    "focal_a5_g3": (lambda x, t: jl.focal_loss(x, t, 0.5, 3.0),
                    lambda x, t: tl.focal_loss(x, t, 0.5, 3.0)),
    "tversky": (jl.tversky_loss, tl.tversky_loss),
    "tversky_3_7": (lambda x, t: jl.tversky_loss(x, t, 0.3, 0.7),
                    lambda x, t: tl.tversky_loss(x, t, 0.3, 0.7)),
    "lovasz": (jl.lovasz_hinge_loss, tl.lovasz_hinge_loss),
    "edge": (jl.edge_loss, tl.edge_loss),
    "combined": (jl.CombinedLoss(0.4, 0.6, 0.2, 0.1),
                 tl.CombinedLoss(0.4, 0.6, 0.2, 0.1)),
}


# tied logits make flat regions whose Sobel responses are zero up to the
# order of a conv's float sums, where |.| has its kink: the edge term's
# gradient there is a rounding's sign in either package, so the losses
# with an edge term take the untied inputs only
CASES = [(name, seed, ties) for name in LOSSES for seed in (0, 1)
         for ties in (False, True)
         if not (ties and name in ("edge", "combined"))]


@pytest.mark.parametrize("name, seed, ties", CASES,
                         ids=[f"{n}-{s}-{'ties' if t else 'normal'}"
                              for n, s, t in CASES])
def test_loss_and_gradient_match_jax(name, seed, ties):
    (jv, jg), (tv, tg) = _both(*LOSSES[name], *_inputs(seed, ties))
    assert tv == pytest.approx(jv, rel=VALUE_RTOL, abs=1e-7)
    np.testing.assert_allclose(tg, jg, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_lovasz_ties_need_the_stable_sort():
    """With tied errors an unstable order gives other per-logit gradients:
    the port's stable sort gives JAX's exactly where the errors tie."""
    logits, targets = _inputs(3, ties=True)
    (_, jg), (_, tg) = _both(*LOSSES["lovasz"], logits, targets)
    np.testing.assert_allclose(tg, jg, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert len(np.unique(np.round(jg, 9))) > 3  # the ties spread the grads


@pytest.mark.parametrize("name", ["DiceLoss", "JaccardLoss", "BCELoss",
                                  "SoftBCEWithLogitsLoss", "FocalLoss",
                                  "TverskyLoss", "LovaszLoss",
                                  "CombinedLoss"])
def test_get_loss_function_matches_jax(name):
    cfg, jcfg = get_cfg_defaults(), jax_defaults()
    for c in (cfg, jcfg):
        c.LOSS.NAME = name
        c.LOSS.FOCAL_WEIGHT = 0.3
        c.LOSS.EDGE_LOSS_WEIGHT = 0.2
    logits, targets = _inputs(5)
    (jv, jg), (tv, tg) = _both(jl.get_loss_function(jcfg),
                               tl.get_loss_function(cfg), logits, targets)
    assert tv == pytest.approx(jv, rel=VALUE_RTOL, abs=1e-7)
    np.testing.assert_allclose(tg, jg, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_unknown_loss_raises():
    cfg = get_cfg_defaults()
    cfg.LOSS.NAME = "NoSuchLoss"
    with pytest.raises(ValueError):
        tl.get_loss_function(cfg)


@pytest.mark.parametrize("valid", [None, [1, 1, 0]], ids=["all", "padded"])
def test_confusion_stats_and_metrics_match_jax(valid):
    logits, targets = _inputs(7)
    logits = np.concatenate([logits, logits[:1]])
    targets = np.concatenate([targets, targets[:1]])
    jv = None if valid is None else jnp.asarray(valid, jnp.float32)
    tv = None if valid is None else torch.tensor(valid, dtype=torch.float32)
    js = jm.confusion_stats(jnp.asarray(logits), jnp.asarray(targets),
                            valid=jv)
    ts = tm.confusion_stats(torch.from_numpy(logits),
                            torch.from_numpy(targets), valid=tv)
    for k in ("tp", "fp", "fn", "tn"):
        assert float(ts[k]) == float(js[k]), k
    jmet = jm.metrics_from_stats(js)
    tmet = tm.metrics_from_stats(ts)
    assert set(tmet) == set(jmet)
    for k in jmet:
        assert float(tmet[k]) == pytest.approx(float(jmet[k]), rel=1e-6), k
    jc = jm.compute_metrics(jnp.asarray(logits), jnp.asarray(targets), 0.3)
    tc = tm.compute_metrics(torch.from_numpy(logits),
                            torch.from_numpy(targets), 0.3)
    for k in jc:
        assert float(tc[k]) == pytest.approx(float(jc[k]), rel=1e-6), k


def test_soft_scores_psnr_ssim_match_jax():
    rng = np.random.default_rng(11)
    p = rng.random((2, 32, 32, 3)).astype(np.float32)
    t = np.clip(p + rng.normal(0, 0.05, p.shape), 0, 1).astype(np.float32)
    m = (rng.random((2, 32, 32, 1)) < 0.4).astype(np.float32)
    pairs = [
        (jm.dice_coef, tm.dice_coef, (p, t)),
        (jm.iou_score, tm.iou_score, (p, t)),
        (jm.psnr, tm.psnr, (p, t)),
        (lambda a, b: jm.psnr(a, b, mask=jnp.asarray(m)),
         lambda a, b: tm.psnr(a, b, mask=torch.from_numpy(m)), (p, t)),
        (jm.ssim, tm.ssim, (p, t)),
        (jm.ssim, tm.ssim, (p[0], t[0])),
    ]
    for jf, tf, (a, b) in pairs:
        want = float(jf(jnp.asarray(a), jnp.asarray(b)))
        got = float(tf(torch.from_numpy(a), torch.from_numpy(b)))
        assert got == pytest.approx(want, rel=1e-5)
