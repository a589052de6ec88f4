"""The zoo's weights files against the JAX package's, on the CPU: .npz
(the shipped format, bf16) and .pth (the reference's dict) both ways for
FPN and an efficientnet-b0 UNet++ (UnetTPU's in test_torch_unettpu.py,
whose check_weights_round_trip says what is held). JAX's .npz reader and
writer cast leaf by leaf, each shape compiled once: the EfficientNet's
~400 leaves take ~25 s."""
import pytest
import torch

from test_torch_unettpu import check_weights_round_trip

torch.set_num_threads(2)


@pytest.mark.parametrize("arch, encoder", [
    ("FPN", "resnet18"), ("UnetPlusPlus", "efficientnet-b0")])
def test_weights_files_round_trip_both_ways(arch, encoder, tmp_path):
    check_weights_round_trip(arch, encoder, tmp_path)
