"""text/diagnose.py against the JAX package's: run_all's sections and keys
(the port adds one, fonts.renderer, naming the block font it draws with:
a stated difference), the fonts and OCR findings on this machine, and the
pipeline finding its block-font text on the CPU.

The values the two packages may differ in are stated: JAX counts the fonts
PIL renders, the port the TrueType/OpenType files among the same first
20 (it renders none); JAX's probe names requests' exception, the port's
urllib's."""
import numpy as np
import pytest

from unet_watermark_tpu.text import diagnose as jd
from unet_watermark_tpu_torch.text import diagnose as td


@pytest.fixture(scope="module")
def both():
    return jd.run_all(), td.run_all("cpu")


def test_run_all_keys_equal_jax(both):
    want, got = both
    assert list(got) == list(want) == ["fonts", "ocr", "pipeline"]
    assert set(got["fonts"]) == set(want["fonts"]) | {"renderer"}
    assert got["fonts"]["renderer"] == td.RENDERER
    for section in ("ocr", "pipeline"):
        assert list(got[section]) == list(want[section]), section


def test_fonts_and_ocr_agree_with_jax(both):
    want, got = both
    for key in ("fonts_found", "fonts_renderable_sampled", "sample_fonts"):
        assert got["fonts"][key] == want["fonts"][key], key
    assert ("fix" in got["fonts"]) == ("fix" in want["fonts"])
    assert isinstance(got["fonts"]["sample_text"], str)
    assert got["ocr"]["easyocr"] == want["ocr"]["easyocr"]
    assert got["ocr"]["builtin"] == want["ocr"]["builtin"] == "available"
    assert got["ocr"]["paddle_service"].split(" (")[0] == \
        want["ocr"]["paddle_service"].split(" (")[0]


def test_pipeline_finds_text(both):
    _, got = both
    assert got["pipeline"]["builtin_ocr_found_text"] is True
    assert 0 < got["pipeline"]["optimized_mask_coverage"] < 0.5


def test_fonts_without_any(monkeypatch):
    monkeypatch.setattr("unet_watermark_tpu_torch.data.gen_data."
                        "load_system_fonts", lambda: [])
    out = td.diagnose_fonts()
    assert out["fonts_found"] == 0 and "fix" in out
    assert out["sample_fonts"] == []


def test_main_prints_json_and_defaults_to_the_card(capsys):
    import json

    with pytest.raises(RuntimeError):
        td.diagnose_pipeline()  # "cuda" by default; no card here
    r = td.main(["--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert printed["pipeline"] == r["pipeline"]
    assert np.isfinite(printed["pipeline"]["optimized_mask_coverage"])
