"""scripts/quality_report.eval_e2e_repair of the port against the JAX
package's, in both mask modes, on the same triads (made by the port's
gen_data) and the shipped UNet++ and LaMa weights: the default config in
float32 in both, the LaMa fill in bf16 in both (each fused fn's own). Each
PSNR (rounded to 2 decimals by both) is held within E2E_DB_TOL, the no-op
floor within 0.01 (numpy's and torch's float32 means).
"""
import pytest

import unet_watermark_tpu.configs as jconfigs
from test_torch_quality_report import SIZE, _f32, triads  # noqa: F401
from unet_watermark_tpu_torch.configs import get_cfg_defaults as pcfg
from unet_watermark_tpu_torch.scripts import quality_report as pqr

E2E_DB_TOL = 0.1


@pytest.mark.parametrize("mode", ["parity", "tight"])
def test_eval_e2e_repair_matches_jax(triads, mode, monkeypatch):
    from unet_watermark_tpu.scripts.quality_report import \
        eval_e2e_repair as je2e

    monkeypatch.setattr(jconfigs, "get_cfg_defaults",
                        _f32(jconfigs.get_cfg_defaults))
    monkeypatch.setattr(pqr, "get_cfg_defaults", _f32(pcfg))
    kw = dict(limit=4, batch=4, img_size=SIZE, mask_mode=mode)
    j = je2e(triads, **kw)
    p = pqr.eval_e2e_repair(triads, device="cpu", **kw)
    assert sorted(p) == sorted(j) == ["floor", "lama", "n_images",
                                      "pushpull"]
    assert p["n_images"] == j["n_images"] == 4
    for k in ("psnr_to_clean_db", "region_psnr_db"):
        assert abs(p["floor"][k] - j["floor"][k]) <= 0.01
        for engine in ("pushpull", "lama"):
            assert abs(p[engine][k] - j[engine][k]) <= E2E_DB_TOL, \
                (engine, k)
    assert p["lama"]["engine_used"] == j["lama"]["engine_used"] == \
        "ffc-lama"
    assert p["pushpull"]["engine_used"] == "pushpull"
