"""Image clustering (scripts/classify_image.py in the JAX package):
features per image with an on-disk cache, seeded KMeans (after PCA where
there are more features and more images than pca_dims), cluster copies,
per-cluster videos, and a DBSCAN grouping on cosine distance.

The feature chain is JAX's as it resolves without downloads: a pretrained
DINOv2 from a local directory or the Hugging Face cache
(models/dinov2.load_dinov2; its CLS feature at 224² with ImageNet
normalization), else a DINOv2 of JAX's small config (384 wide, 4 layers,
6 heads) with random weights, else the histogram features. The random
weights are drawn from torch.Generator().manual_seed(seed), not by
transformers' unseeded init: the same recipe, other draws. The
histogram features are cv2's: the resize to 128² (INTER_LINEAR on uint8),
calcHist's 32 bins a channel, RGB2GRAY, Sobel into float32 with the
default BORDER_REFLECT_101, and a 16-bin orientation histogram weighted by
the gradient magnitude (the angle from a float64 atan2 rounded to float32,
then numpy's float32 steps, each division by a tensor: CUDA divides by a
Python number as a product with its reciprocal). Clustering is
ops/cluster.py (sklearn's KMeans, PCA and DBSCAN on the device).

The cache is JAX's .npz ({abspath: float32 features} pickled under
"cache"), so each package reads the other's.

CLI (on the card unless --device cpu):
    python -m unet_watermark_tpu_torch.scripts.classify_image --input D \\
        --output O [--clusters 5] [--videos]
"""
from __future__ import annotations

import argparse
import logging
import math
import os
import shutil
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops import cluster, imgproc
from ..ops.resize import resize_linear_u8
from ..utils import image_io
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

HIST_DIMS = 112
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
EXTS = (".jpg", ".jpeg", ".png", ".webp")


def _hist_features(img_rgb: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) uint8 RGB on a device → (112,) float32 on it: three
    32-bin colour histograms and a 16-bin gradient-orientation histogram,
    each normalized to sum 1."""
    img = resize_linear_u8(img_rgb, (128, 128))
    feats = []
    for c in range(3):
        h = torch.bincount((img[..., c] >> 3).flatten().long(),
                           minlength=32).float()
        feats.append(h / (h.sum() + 1e-8))
    gx, gy = imgproc.sobel_f32(imgproc.gray_u8(img, "rgb"))
    mag = torch.sqrt(gx ** 2 + gy ** 2)
    ang = torch.atan2(gy.double(), gx.double()).float()
    ang = (ang + math.pi) / torch.full_like(ang, 2 * math.pi) * 16
    hog = torch.zeros(16, dtype=torch.float32, device=img.device)
    bins = torch.floor(ang).long()
    keep = (bins >= 0) & (bins < 16)
    hog.index_add_(0, bins[keep], mag[keep])
    feats.append(hog / (hog.sum() + 1e-8))
    return torch.cat(feats)


class FeatureExtractor:
    """Pretrained DINOv2 → random DINOv2 → histogram features."""

    def __init__(self, model_name: str = "facebook/dinov2-base",
                 allow_random_init: bool = True, device="cuda",
                 seed: int = 0):
        from ..models import dinov2

        self.model_name = model_name
        self.device = resolve_device(device)
        self.backend = "hist"
        self._model = None
        try:
            self._model = dinov2.load_dinov2(model_name, self.device,
                                             require_processor=True)
            self.backend = "dinov2"
        except (OSError, ValueError, KeyError) as e:
            logger.info("pretrained %s unavailable locally (%s)",
                        model_name, e)
            if allow_random_init:
                self._model = dinov2.model_from_config(
                    dinov2.Dinov2Config(hidden_size=384,
                                        num_hidden_layers=4,
                                        num_attention_heads=6),
                    seed, self.device)
                self.backend = "dinov2-random"
        logger.info("feature backend: %s", self.backend)

    def pixels(self, image_rgb: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) uint8 → the (1, 3, 224, 224) float32 model input."""
        img = resize_linear_u8(image_rgb, (224, 224)).float()
        img = img / torch.full_like(img, 255.0)
        dev = img.device
        mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float64, device=dev)
        std = torch.tensor(IMAGENET_STD, dtype=torch.float64, device=dev)
        x = ((img.double() - mean) / std).float()
        return x.permute(2, 0, 1)[None].contiguous()

    @torch.inference_mode()
    def extract(self, image_rgb: torch.Tensor) -> np.ndarray:
        image_rgb = torch.as_tensor(image_rgb).to(self.device)
        if self.backend.startswith("dinov2"):
            return self._model.cls_features(self.pixels(image_rgb)
                                            ).cpu().numpy().ravel()
        return _hist_features(image_rgb).cpu().numpy()


def _images(folder: str) -> List[str]:
    return sorted(os.path.join(folder, f) for f in os.listdir(folder)
                  if f.lower().endswith(EXTS))


class StableImageClassifier:
    """Cached features + seeded KMeans (+PCA) + cluster copies/videos."""

    def __init__(self, extractor: Optional[FeatureExtractor] = None,
                 cache_path: Optional[str] = None, seed: int = 42,
                 device="cuda"):
        self.extractor = extractor or FeatureExtractor(device=device)
        self.device = self.extractor.device
        self.cache_path = cache_path
        self.seed = seed
        self._cache: Dict[str, np.ndarray] = {}
        if cache_path and os.path.exists(cache_path):
            data = np.load(cache_path, allow_pickle=True)
            self._cache = dict(data["cache"].item())

    def _features_for(self, paths: List[str]) -> np.ndarray:
        feats = []
        for p in paths:
            key = os.path.abspath(p)
            if key not in self._cache:
                try:
                    img = image_io.read_rgb_tensor(p, self.device)
                except image_io.UNREADABLE:
                    img = None
                if img is None:
                    self._cache[key] = np.zeros(
                        len(next(iter(self._cache.values())))
                        if self._cache else HIST_DIMS, np.float32)
                else:
                    self._cache[key] = self.extractor.extract(img).astype(
                        np.float32)
            feats.append(self._cache[key])
        if self.cache_path:
            np.savez_compressed(self.cache_path, cache=self._cache)
        return np.stack(feats)

    def stable_cluster_images(self, folder: str, n_clusters: int = 5,
                              pca_dims: Optional[int] = 64
                              ) -> Dict[str, int]:
        """{path: cluster} over the folder's images."""
        paths = _images(folder)
        if not paths:
            return {}
        feats = torch.from_numpy(self._features_for(paths)).to(self.device)
        if pca_dims and feats.shape[1] > pca_dims and len(paths) > pca_dims:
            feats = cluster.pca(feats, pca_dims, self.seed)
        k = min(n_clusters, len(paths))
        labels, _ = cluster.kmeans(feats, k, self.seed, n_init=10)
        return dict(zip(paths, labels.tolist()))

    def copy_clusters(self, assignment: Dict[str, int],
                      output_dir: str) -> None:
        for path, c in assignment.items():
            d = os.path.join(output_dir, f"cluster_{c}")
            os.makedirs(d, exist_ok=True)
            shutil.copy2(path, os.path.join(d, os.path.basename(path)))

    def cluster_videos(self, assignment: Dict[str, int],
                       output_dir: str) -> List[str]:
        """One video a cluster (scripts/video_generator.py's writer)."""
        from .video_generator import VideoGenerator

        os.makedirs(output_dir, exist_ok=True)
        gen = VideoGenerator(width=640, height=480, duration_per_image=0.5,
                             fps=10, device=self.device)
        outputs = []
        by_cluster: Dict[int, List[str]] = {}
        for p, c in assignment.items():
            by_cluster.setdefault(c, []).append(p)
        for c, paths in sorted(by_cluster.items()):
            out = os.path.join(output_dir, f"cluster_{c}.mp4")
            writer = gen._writer(out)
            try:
                for p in sorted(paths):
                    img = gen._read_bgr(p)
                    if img is None:
                        continue
                    frame = gen.add_text_overlay(
                        gen.resize_image_with_padding(img), f"cluster {c}")
                    gen._hold(writer, frame, 0.5)
            finally:
                writer.release()
            outputs.append(out)
        return outputs


def dbscan_group(folder: str, eps: float = 0.5, min_samples: int = 2,
                 extractor: Optional[FeatureExtractor] = None,
                 device="cuda") -> Dict[str, int]:
    """DBSCAN on cosine distance over L2-normalized features."""
    classifier = StableImageClassifier(extractor, device=device)
    paths = _images(folder)
    if not paths:
        return {}
    feats = torch.from_numpy(classifier._features_for(paths)).to(
        classifier.device)
    labels = cluster.dbscan(cluster.l2_normalize(feats), eps, min_samples,
                            metric="cosine")
    return dict(zip(paths, labels.tolist()))


def main(argv=None):
    p = argparse.ArgumentParser(description="image clustering")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--clusters", type=int, default=5)
    p.add_argument("--videos", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    c = StableImageClassifier(device=args.device)
    assignment = c.stable_cluster_images(args.input, args.clusters)
    c.copy_clusters(assignment, args.output)
    if args.videos:
        c.cluster_videos(assignment, os.path.join(args.output, "videos"))
    counts = {f"cluster_{v}": sum(1 for x in assignment.values() if x == v)
              for v in sorted(set(assignment.values()))}
    print(counts)
    return assignment


if __name__ == "__main__":
    main()
