"""scripts/calibrate_quant.py of the port against the JAX package's.

The observe pass: both packages' calibrate() on the same normalized
batches (their calibration_batches replaced by one list of numpy batches),
Unet/resnet34 with the shipped weights at 64², float32 in both: every
conv's recorded amax within AMAX_RTOL of JAX's (float32 convs summed in
other orders). The sidecar: JAX's keys (the shipped
sidecar's), the weights' sha256 under __weights_sha256__. The one
departure: calibrate(out=None) and main without --out raise and write
nothing, where JAX writes beside the shipped weights.
"""
import os

import numpy as np
import pytest
import torch

import unet_watermark_tpu.configs as jconfigs
import unet_watermark_tpu.scripts.calibrate_quant as JC
from unet_watermark_tpu_torch.configs import get_cfg_defaults as pcfg
from unet_watermark_tpu_torch.ops import quant
from unet_watermark_tpu_torch.scripts import calibrate_quant as PC
from unet_watermark_tpu_torch.utils import shipping

AMAX_RTOL = 1e-4
SIZE = 64


def _f32(get):
    def make():
        cfg = get()
        cfg.MODEL.DTYPE = "float32"
        return cfg
    return make


@pytest.fixture(scope="module")
def sidecars(tmp_path_factory):
    root = tmp_path_factory.mktemp("calib")
    rng = np.random.default_rng(6)
    batches = [rng.normal(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
               for _ in range(2)]
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jconfigs, "get_cfg_defaults",
                   _f32(jconfigs.get_cfg_defaults))
        mp.setattr(PC, "get_cfg_defaults", _f32(pcfg))
        mp.setattr(JC, "calibration_batches", lambda *a, **k: iter(batches))
        mp.setattr(PC, "calibration_batches", lambda *a, **k: (
            torch.from_numpy(b) for b in batches))
        j = JC.calibrate("Unet", img_size=SIZE, out=str(root / "j.json"),
                         workdir=str(root / "wj"))
        p = PC.calibrate("Unet", img_size=SIZE, out=str(root / "p.json"),
                         workdir=str(root / "wp"), device="cpu")
    finally:
        mp.undo()
    return j, p


def test_observe_pass_amax_matches_jax(sidecars):
    j, p = (quant.load_scales(s) for s in sidecars)
    assert sorted(p) == sorted(j) and len(p) == 50
    for k in j:
        assert p[k] == pytest.approx(j[k], rel=AMAX_RTOL), k
        assert np.isfinite(p[k]) and p[k] > 0


def test_sidecar_keys_and_metadata(sidecars):
    _, p = sidecars
    weights = str(shipping.seg_weights_path("Unet", "resnet34"))
    shipped = quant.quant_sidecar_path(weights)
    assert sorted(quant.load_scales(p)) == sorted(quant.load_scales(shipped))
    meta = quant.load_sidecar_meta(p)
    assert meta == quant.load_sidecar_meta(sidecars[0])
    assert meta["weights_sha256"] == PC.file_sha256(weights) == \
        JC.file_sha256(weights) == quant.load_sidecar_meta(shipped)[
            "weights_sha256"]
    assert PC.quant_sidecar_path is quant.quant_sidecar_path
    assert PC.quant_sidecar_path(weights) == JC.quant_sidecar_path(weights)
    assert (PC.CALIB_CLEAN_SEED, PC.CALIB_COMPOSE_SEED) == \
        (JC.CALIB_CLEAN_SEED, JC.CALIB_COMPOSE_SEED)


def _snapshot(d):
    return sorted((f, os.stat(os.path.join(d, f)).st_mtime_ns)
                  for f in os.listdir(d))


def test_out_none_raises_and_writes_nothing(tmp_path):
    before = _snapshot(shipping.WEIGHTS_DIR)
    with pytest.raises(ValueError, match="out"):
        PC.calibrate("Unet", out=None, workdir=str(tmp_path / "w"),
                     device="cpu")
    with pytest.raises(ValueError, match="out"):
        PC.main(["--model", "Unet", "--workdir", str(tmp_path / "w"),
                 "--device", "cpu"])
    assert _snapshot(shipping.WEIGHTS_DIR) == before
    assert not (tmp_path / "w").exists()  # refused before any work


def test_calibration_batches_and_main(tmp_path):
    """The procedural set (synth_clean + gen_data at the calibration
    seeds): JAX's file names, normalized float32 batches on the device;
    main writes the sidecar it is given."""
    batches = list(PC.calibration_batches(str(tmp_path / "p"), 3, SIZE, 2,
                                          device="cpu"))
    assert [tuple(b.shape) for b in batches] == [(2, SIZE, SIZE, 3),
                                                  (1, SIZE, SIZE, 3)]
    assert all(torch.isfinite(b).all() for b in batches)
    list(JC.calibration_batches(str(tmp_path / "j"), 3, SIZE, 2))
    for sub in ("calib_clean_v2", "calib_logos", "calib_set_v2/watermarked",
                "calib_set_v2/masks"):
        assert sorted(os.listdir(tmp_path / "p" / sub)) == \
            sorted(os.listdir(tmp_path / "j" / sub)), sub
    out = tmp_path / "s.json"
    PC.main(["--model", "Unet", "--img-size", str(SIZE), "--images", "2",
             "--batch", "2", "--workdir", str(tmp_path / "p"), "--out",
             str(out), "--device", "cpu"])
    assert len(quant.load_scales(str(out))) == 50
