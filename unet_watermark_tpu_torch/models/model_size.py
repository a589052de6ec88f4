"""Model sizes (models/model_size.py in the JAX package): the parameter
count of an arch/encoder pair with its float32 and bfloat16 sizes, and a
table over several pairs.

    python -m unet_watermark_tpu_torch.models.model_size [--model M]
        [--encoder E] [--sweep]

The models are built on the meta device: nothing is allocated or drawn.
img_size matters only to PAN, whose parameters depend on the input size
(models/archs.py), as JAX's init does.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence

import torch


def get_model_size(model_name: str = "UnetPlusPlus",
                   encoder_name: str = "resnet34",
                   decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                   img_size: int = 64) -> Dict:
    """{model, encoder, parameters, fp32_mb, bf16_mb} (MB of 10^6 bytes)."""
    from .factory import SMPModelFactory, count_parameters

    with torch.device("meta"):
        model = SMPModelFactory.create_model(
            model_name=model_name, encoder_name=encoder_name,
            decoder_channels=decoder_channels, img_size=img_size)
    params = count_parameters(model)
    return {
        "model": model_name,
        "encoder": encoder_name,
        "parameters": params,
        "fp32_mb": params * 4 / 1e6,
        "bf16_mb": params * 2 / 1e6,
    }


def compare_model_sizes(models: Optional[Sequence[str]] = None,
                        encoders: Optional[Sequence[str]] = None,
                        img_size: int = 64,
                        print_table: bool = True) -> List[Dict]:
    """get_model_size over models x encoders (JAX's defaults); a pair
    that cannot be built gives {model, encoder, error}."""
    models = list(models or ["Unet", "UnetPlusPlus", "FPN", "Linknet"])
    encoders = list(encoders or ["resnet18", "resnet34", "resnet50",
                                 "efficientnet-b0", "efficientnet-b3"])
    rows = []
    for m in models:
        for e in encoders:
            try:
                rows.append(get_model_size(m, e, img_size=img_size))
            except Exception as ex:  # noqa: BLE001 - a row, as in JAX
                rows.append({"model": m, "encoder": e, "error": str(ex)})
    if print_table:
        print(f"{'model':<16}{'encoder':<18}{'params':>12}{'fp32 MB':>10}")
        print("-" * 56)
        for r in rows:
            if "error" in r:
                print(f"{r['model']:<16}{r['encoder']:<18}  error")
            else:
                print(f"{r['model']:<16}{r['encoder']:<18}"
                      f"{r['parameters']:>12,}{r['fp32_mb']:>10.1f}")
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description="model size tools")
    p.add_argument("--model", default=None)
    p.add_argument("--encoder", default=None)
    p.add_argument("--sweep", action="store_true")
    args = p.parse_args(argv)
    if args.sweep:
        compare_model_sizes()
    else:
        print(get_model_size(args.model or "UnetPlusPlus",
                             args.encoder or "resnet34"))


if __name__ == "__main__":
    main()
