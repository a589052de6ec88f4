"""scripts/quality_report.eval_e2e_repair of the port against the JAX
package's on the textured tier: the triads of
ensure_frozen_set(textured=True) at 128² (4 of them, made by the port; its
files are held against JAX's in tests/test_torch_quality_report.py), the
shipped UNet++ and LaMa weights, the segmentation in float32 in both and
the LaMa fill in bf16 in both, in both mask modes. Each PSNR (rounded to 2
decimals by both) is held within E2E_DB_TOL, the no-op floor within 0.01,
and each engine stands on the same side of the floor in both. The tight
chain repaints less texture than the parity chain: JAX's tight LaMa repair
scores above its parity one, and the port's too. chip_smoke.py's phase 3k
scores the same set in tight mode on the card against the host.
"""
import pytest

import unet_watermark_tpu.configs as jconfigs
from test_torch_quality_e2e import E2E_DB_TOL
from test_torch_quality_report import _f32
from unet_watermark_tpu_torch.configs import get_cfg_defaults as pcfg
from unet_watermark_tpu_torch.scripts import quality_report as pqr
from unet_watermark_tpu_torch.tools.smoke_phases import TEX_SIZE, TEX_TRIADS

MODES = ("parity", "tight")


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    """{mode: (JAX's result, the port's)} on the same textured triads."""
    from unet_watermark_tpu.scripts.quality_report import \
        eval_e2e_repair as je2e

    root = pqr.ensure_frozen_set(
        str(tmp_path_factory.mktemp("tex")), n=TEX_TRIADS,
        img_size=TEX_SIZE, textured=True, device="cpu")
    mp = pytest.MonkeyPatch()
    mp.setattr(jconfigs, "get_cfg_defaults",
               _f32(jconfigs.get_cfg_defaults))
    mp.setattr(pqr, "get_cfg_defaults", _f32(pcfg))
    try:
        out = {}
        for mode in MODES:
            kw = dict(limit=TEX_TRIADS, batch=TEX_TRIADS, img_size=TEX_SIZE,
                      mask_mode=mode)
            out[mode] = (je2e(root, **kw),
                         pqr.eval_e2e_repair(root, device="cpu", **kw))
        return out
    finally:
        mp.undo()


@pytest.mark.parametrize("mode", MODES)
def test_textured_e2e_repair_matches_jax(readings, mode):
    j, p = readings[mode]
    assert p["n_images"] == j["n_images"] == TEX_TRIADS
    for k in ("psnr_to_clean_db", "region_psnr_db"):
        assert abs(p["floor"][k] - j["floor"][k]) <= 0.01
        for engine in ("pushpull", "lama"):
            assert abs(p[engine][k] - j[engine][k]) <= E2E_DB_TOL, \
                (engine, k)
    floor = "psnr_to_clean_db"
    for engine in ("pushpull", "lama"):
        assert (p[engine][floor] > p["floor"][floor]) == \
            (j[engine][floor] > j["floor"][floor]), engine
    assert p["lama"]["engine_used"] == j["lama"]["engine_used"] == \
        "ffc-lama"


def test_textured_tight_repair_above_parity_as_jax(readings):
    """The relation phase 3k gates on the card at 512²; at this size
    JAX's tight LaMa repair also clears the no-op floor, which 3k gates on
    the card here."""
    key = "psnr_to_clean_db"
    for side in (0, 1):  # JAX's, then the port's
        tight, parity = (readings[m][side]["lama"][key] for m in
                         ("tight", "parity"))
        assert tight > parity, (side, tight, parity)
        tight_floor = readings["tight"][side]["floor"][key]
        assert tight > tight_floor, (side, tight, tight_floor)

