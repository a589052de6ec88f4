"""DINOv2, the ViT of transformers' Dinov2Model (4.57), in plain torch (the
card's machine has no transformers): its parameter names are transformers'
state-dict keys, so a Dinov2Model's weights load as they are.

  embeddings   a 14-pixel patch conv, a CLS token, position embeddings
               (bicubic, align_corners=False, in float32, where the patch
               grid differs from the trained one: dinov2-base's 37 × 37
               grid at 518² against 16 × 16 at 224²)
  layers       pre-norm: LayerNorm, self-attention with separate q, k, v
               projections, LayerScale, residual; LayerNorm, an MLP with
               exact-erf GELU, LayerScale, residual (the giant model's
               SwiGLU is not ported)
  output       the final LayerNorm; last_hidden_state[:, 0] is the CLS
               feature

load_dinov2(path_or_id, device) reads a directory, or a hub id from the
local Hugging Face cache as from_pretrained(..., local_files_only=True)
does (HF_HUB_CACHE, else HF_HOME/hub, else ~/.cache/huggingface/hub;
models--org--name/snapshots/<refs/main>): config.json, then
model.safetensors (utils/safetensors.py) or pytorch_model.bin. Nothing is
fetched. init_random(config, generator) draws the weights with
transformers' recipe (normal, std initializer_range, for the patch conv,
the linears, the CLS token and the position embeddings; zero biases and
mask token; unit LayerNorms; LayerScale at layerscale_value) from a
torch.Generator on the CPU, so the same seed gives the same model on
every device.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, fields
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclass
class Dinov2Config:
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    mlp_ratio: float = 4
    hidden_act: str = "gelu"
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-6
    image_size: int = 224
    patch_size: int = 14
    num_channels: int = 3
    qkv_bias: bool = True
    layerscale_value: float = 1.0
    use_swiglu_ffn: bool = False

    @classmethod
    def from_dict(cls, d: Dict) -> "Dinov2Config":
        names = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})




class PatchEmbeddings(nn.Module):
    def __init__(self, c: Dinov2Config):
        super().__init__()
        self.projection = nn.Conv2d(c.num_channels, c.hidden_size,
                                    c.patch_size, stride=c.patch_size)


class Embeddings(nn.Module):
    def __init__(self, c: Dinov2Config):
        super().__init__()
        n = (c.image_size // c.patch_size) ** 2
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.hidden_size))
        self.mask_token = nn.Parameter(torch.zeros(1, c.hidden_size))
        self.patch_embeddings = PatchEmbeddings(c)
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, n + 1, c.hidden_size))
        self.patch_size = c.patch_size

    def _positions(self, patches: int, h: int, w: int) -> torch.Tensor:
        pos = self.position_embeddings
        trained = pos.shape[1] - 1
        if patches == trained and h == w:
            return pos
        dim = pos.shape[-1]
        side = int(trained ** 0.5)
        grid = pos[:, 1:].reshape(1, side, side, dim).permute(0, 3, 1, 2)
        grid = F.interpolate(grid.to(torch.float32),
                             size=(h // self.patch_size, w // self.patch_size),
                             mode="bicubic", align_corners=False
                             ).to(pos.dtype)
        return torch.cat([pos[:, :1],
                          grid.permute(0, 2, 3, 1).reshape(1, -1, dim)], 1)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        b, _, h, w = pixels.shape
        proj = self.patch_embeddings.projection
        x = proj(pixels.to(proj.weight.dtype)).flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.expand(b, -1, -1), x], 1)
        return x + self._positions(x.shape[1] - 1, h, w)


class SelfAttention(nn.Module):
    def __init__(self, c: Dinov2Config):
        super().__init__()
        self.heads = c.num_attention_heads
        self.head_size = c.hidden_size // c.num_attention_heads
        self.query = nn.Linear(c.hidden_size, c.hidden_size, bias=c.qkv_bias)
        self.key = nn.Linear(c.hidden_size, c.hidden_size, bias=c.qkv_bias)
        self.value = nn.Linear(c.hidden_size, c.hidden_size, bias=c.qkv_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]

        def split(t):
            return t.view(b, -1, self.heads, self.head_size).transpose(1, 2)

        q, k, v = (split(f(x)) for f in (self.query, self.key, self.value))
        w = torch.matmul(q, k.transpose(-1, -2)) * self.head_size ** -0.5
        w = F.softmax(w, dim=-1, dtype=torch.float32).to(q.dtype)
        out = torch.matmul(w, v).transpose(1, 2)
        return out.reshape(b, -1, self.heads * self.head_size)


class SelfOutput(nn.Module):
    def __init__(self, c: Dinov2Config):
        super().__init__()
        self.dense = nn.Linear(c.hidden_size, c.hidden_size)


class Attention(nn.Module):
    def __init__(self, c: Dinov2Config):
        super().__init__()
        self.attention = SelfAttention(c)
        self.output = SelfOutput(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output.dense(self.attention(x))


class LayerScale(nn.Module):
    def __init__(self, c: Dinov2Config):
        super().__init__()
        self.lambda1 = nn.Parameter(
            c.layerscale_value * torch.ones(c.hidden_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.lambda1


class MLP(nn.Module):
    def __init__(self, c: Dinov2Config):
        super().__init__()
        hidden = int(c.hidden_size * c.mlp_ratio)
        self.fc1 = nn.Linear(c.hidden_size, hidden)
        self.fc2 = nn.Linear(hidden, c.hidden_size)
        if c.hidden_act != "gelu" or c.use_swiglu_ffn:  # dinov2-base's
            raise ValueError("only the exact-erf GELU MLP is ported, not "
                             f"{c.hidden_act!r} or SwiGLU")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Layer(nn.Module):
    def __init__(self, c: Dinov2Config):
        super().__init__()
        self.norm1 = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.attention = Attention(c)
        self.layer_scale1 = LayerScale(c)
        self.norm2 = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.mlp = MLP(c)
        self.layer_scale2 = LayerScale(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.layer_scale1(self.attention(self.norm1(x))) + x
        return self.layer_scale2(self.mlp(self.norm2(x))) + x


class Encoder(nn.Module):
    def __init__(self, c: Dinov2Config):
        super().__init__()
        self.layer = nn.ModuleList(Layer(c) for _ in
                                   range(c.num_hidden_layers))


class Dinov2Model(nn.Module):
    def __init__(self, config: Dinov2Config):
        super().__init__()
        self.config = config
        self.embeddings = Embeddings(config)
        self.encoder = Encoder(config)
        self.layernorm = nn.LayerNorm(config.hidden_size,
                                      eps=config.layer_norm_eps)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(B, C, H, W) → last_hidden_state (B, 1 + patches, hidden)."""
        x = self.embeddings(pixel_values)
        for layer in self.encoder.layer:
            x = layer(x)
        return self.layernorm(x)

    def cls_features(self, pixel_values: torch.Tensor) -> torch.Tensor:
        return self.forward(pixel_values)[:, 0]


def init_random(config: Dinov2Config, generator: torch.Generator
                ) -> Dinov2Model:
    """A model with transformers' init recipe drawn from `generator` (a CPU
    generator), in float32 on the CPU."""
    model = Dinov2Model(config)
    std = config.initializer_range
    norms = {f"{n}.{leaf}" for n, m in model.named_modules()
             if isinstance(m, nn.LayerNorm) for leaf in ("weight", "bias")}
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name in norms:
                p.fill_(1.0 if leaf == "weight" else 0.0)
            elif leaf == "lambda1":
                p.fill_(config.layerscale_value)
            elif leaf in ("bias", "mask_token"):
                p.zero_()
            else:  # conv, linears, cls token, position embeddings
                p.copy_(torch.randn(p.shape, generator=generator) * std)
    return model


def load_state(model: Dinov2Model, state: Dict[str, np.ndarray]) -> int:
    """Carry a transformers Dinov2Model state dict (numpy arrays or
    tensors; a "dinov2." prefix stripped) into `model`; every parameter
    must be given. Returns the number of tensors loaded."""
    clean = {(k[len("dinov2."):] if k.startswith("dinov2.") else k): v
             for k, v in state.items()}
    own = model.state_dict()
    missing = sorted(set(own) - set(clean))
    if missing:
        raise KeyError(f"the weights lack {missing[:5]} "
                       f"({len(missing)} tensors)")
    with torch.no_grad():
        for k, t in own.items():
            v = torch.as_tensor(np.asarray(clean[k]))
            if tuple(v.shape) != tuple(t.shape):
                raise ValueError(f"{k}: {tuple(v.shape)} against "
                                 f"{tuple(t.shape)}")
            t.copy_(v.to(t.dtype))
    return len(own)


def _hub_root() -> Path:
    if os.environ.get("HF_HUB_CACHE"):
        return Path(os.environ["HF_HUB_CACHE"])
    if os.environ.get("HF_HOME"):
        return Path(os.environ["HF_HOME"]) / "hub"
    return Path.home() / ".cache" / "huggingface" / "hub"


def resolve(path_or_id: str) -> Path:
    """The directory holding the model's files: path_or_id itself, or its
    snapshot in the local hub cache. FileNotFoundError where neither
    exists (nothing is downloaded)."""
    p = Path(path_or_id)
    if p.is_dir():
        return p
    repo = _hub_root() / ("models--" + path_or_id.replace("/", "--"))
    ref = repo / "refs" / "main"
    if ref.is_file():
        snap = repo / "snapshots" / ref.read_text().strip()
        if snap.is_dir():
            return snap
    raise FileNotFoundError(f"{path_or_id}: no local directory or cached "
                            f"snapshot under {repo}")


def read_weights(folder: Path) -> Dict[str, np.ndarray]:
    from ..utils import safetensors

    if (folder / "model.safetensors").is_file():
        return safetensors.load(folder / "model.safetensors")
    if (folder / "pytorch_model.bin").is_file():
        sd = torch.load(folder / "pytorch_model.bin", map_location="cpu",
                        weights_only=True)
        return {k: v.float().numpy() for k, v in sd.items()}
    raise FileNotFoundError(f"{folder}: no model.safetensors or "
                            f"pytorch_model.bin")


def load_dinov2(path_or_id: str, device="cuda",
                require_processor: bool = False) -> Dinov2Model:
    """The pretrained model from a local directory or the hub cache, in
    eval mode on `device`. require_processor: fail, as
    AutoImageProcessor.from_pretrained does, where the folder has no
    preprocessor_config.json."""
    from ..utils.device import resolve_device

    folder = resolve(path_or_id)
    if require_processor and not (folder / "preprocessor_config.json"
                                  ).is_file():
        raise FileNotFoundError(f"{folder}: no preprocessor_config.json")
    cfg = json.loads((folder / "config.json").read_text())
    if cfg.get("model_type", "dinov2") != "dinov2":
        raise ValueError(f"{folder}: model_type {cfg.get('model_type')!r}, "
                         f"not dinov2")
    model = Dinov2Model(Dinov2Config.from_dict(cfg))
    load_state(model, read_weights(folder))
    return model.eval().to(resolve_device(device))


def model_from_config(config: Optional[Dinov2Config] = None, seed: int = 0,
                      device="cuda") -> Dinov2Model:
    """init_random from torch.Generator().manual_seed(seed), on device."""
    from ..utils.device import resolve_device

    gen = torch.Generator().manual_seed(seed)
    model = init_random(config or Dinov2Config(), gen)
    return model.eval().to(resolve_device(device))
