"""The self-improving training loop (training/auto_train.py of the JAX
package, the `auto` command). Each cycle:

  1. model selection   the best checkpoint by detection rate
                       (scripts/model_selector.py: one vmapped forward of
                       every checkpoint of the architecture)
  2. training          resume from it for epochs_per_cycle more epochs
                       (training/train.py; EPOCHS = its epoch + K)
  3. prediction        the repair pipeline over the test folder, no OCR
  4. video             the side-by-side comparison video of step 3
                       (scripts/video_generator.py)
  5. data growth       the training set grows by data_growth with the
                       configured watermark kinds (data/gen_data.py)
  6. held-out eval     the newest checkpoint's raw and pipeline IoU on the
                       held-out triads (scripts/quality_report.py), when
                       heldout_eval_dir is set

A cycle that fails logs, writes its cycle_N_info.json with status
"failed" and the loop goes on (JAX's isolation); final_report.json sums
the cycles up. Everything runs on the loop's `device` ("cuda" unless the
caller passes "cpu"). Step 2's best saves write cycle_N_model.pth at
MODEL_SAVE_PATH (models/torch_import.export_pth, JAX's payload) and the
shipped-format .npz beside it (training/train.export_npz).
"""
from __future__ import annotations

import copy
import dataclasses
import json
import logging
import os
import time
from typing import Dict, List, Optional

from ..configs import get_cfg_defaults, update_config
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class AutoTrainConfig:
    project_root: str = "."
    config_path: str = ""
    max_cycles: int = 100
    epochs_per_cycle: int = 50
    batch_size: int = 8
    learning_rate: float = 0.001
    output_dir: str = "models/auto"
    samples: int = 1000
    prediction_limit: int = 100
    transparent_ratio: float = 0.6
    multi_watermark_ratio: float = 0.4
    text_watermark_ratio: float = 0.5
    mixed_watermark_ratio: float = 0.2
    data_growth: float = 0.2
    train_data_dir: str = "data/train"
    test_data_dir: str = "data/test"
    clean_data_dir: str = "data/clean"
    logos_dir: str = "data/logos"
    generate_video: bool = True
    inpaint_model: str = "lama"
    heldout_eval_dir: str = ""
    heldout_eval_limit: int = 32
    heldout_eval_tex_dir: str = ""


class AutoTrainingLoop:
    def __init__(self, config: AutoTrainConfig, base_cfg=None,
                 device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.cfg = copy.deepcopy(base_cfg) if base_cfg is not None else \
            get_cfg_defaults()
        if base_cfg is None and config.config_path and \
                os.path.exists(config.config_path):
            update_config(self.cfg, config.config_path)
        self.cfg.TRAIN.BATCH_SIZE = config.batch_size
        self.cfg.TRAIN.LR = config.learning_rate
        root = config.project_root
        self.train_dir = os.path.join(root, config.train_data_dir)
        self.test_dir = os.path.join(root, config.test_data_dir)
        self.clean_dir = os.path.join(root, config.clean_data_dir)
        self.logos_dir = os.path.join(root, config.logos_dir)
        self.output_dir = os.path.join(root, config.output_dir)
        os.makedirs(self.output_dir, exist_ok=True)
        self.cfg.DATA.ROOT_DIR = self.train_dir
        self.cfg.TRAIN.CHECKPOINT_DIR = os.path.join(self.output_dir,
                                                     "checkpoints")
        self.cycle_history: List[Dict] = []
        self.step_seconds: Dict[str, float] = {}  # the last cycle's steps

    def step1_model_selection(self, cycle: int) -> Optional[str]:
        from ..scripts.model_selector import ModelSelector
        from .checkpoint import latest_checkpoint

        ckpt_dir = self.cfg.TRAIN.CHECKPOINT_DIR
        if not os.path.isdir(ckpt_dir) or not os.listdir(ckpt_dir):
            logger.info("cycle %d: no checkpoints yet, training from "
                        "scratch", cycle)
            return None
        if not os.path.isdir(self.test_dir) or not os.listdir(self.test_dir):
            return latest_checkpoint(ckpt_dir)
        selector = ModelSelector(
            models_dir=ckpt_dir, images_dir=self.test_dir,
            output_dir=os.path.join(self.output_dir,
                                    f"cycle_{cycle}_selection"),
            config=self.cfg, num_images=min(10, self.config.prediction_limit),
            device=self.device)
        try:
            return selector.get_best_model_path()
        except NotImplementedError:
            raise
        except Exception as e:  # noqa: BLE001
            logger.error("model selection failed: %s", e)
            return None

    def step2_training(self, cycle: int, resume_from: Optional[str]) -> Dict:
        from .train import train

        cfg = copy.deepcopy(self.cfg)
        base_epoch = 0
        if resume_from:
            meta_path = os.path.join(resume_from, "meta.json")
            if os.path.exists(meta_path):
                with open(meta_path) as f:
                    base_epoch = int(json.load(f).get("epoch", 0))
        cfg.TRAIN.EPOCHS = base_epoch + self.config.epochs_per_cycle
        cfg.TRAIN.OUTPUT_DIR = os.path.join(self.output_dir,
                                            f"cycle_{cycle}_training")
        cfg.TRAIN.MODEL_SAVE_PATH = os.path.join(
            self.output_dir, f"cycle_{cycle}_model.pth")
        return train(cfg, resume_from=resume_from, device=self.device)

    def _newest_checkpoint(self) -> Optional[str]:
        """The latest epoch checkpoint, else best_model where it was
        written (short cycles may not reach SAVE_INTERVAL)."""
        from .checkpoint import latest_checkpoint

        ckpt = latest_checkpoint(self.cfg.TRAIN.CHECKPOINT_DIR)
        if ckpt:
            return ckpt
        best = os.path.join(self.cfg.TRAIN.CHECKPOINT_DIR, "best_model")
        return best if os.path.exists(os.path.join(best, "tree.npz")) \
            else None

    def step3_prediction(self, cycle: int) -> Dict:
        from ..inference.predict import WatermarkPredictor

        best = self._newest_checkpoint() or os.path.join(
            self.cfg.TRAIN.CHECKPOINT_DIR, "best_model")
        out = os.path.join(self.output_dir, f"cycle_{cycle}_predictions")
        predictor = WatermarkPredictor(self.cfg, weights_path=best,
                                       device=self.device)
        return predictor.process_folder_batch(
            self.test_dir, out, watermark_model=self.config.inpaint_model,
            use_ocr=False, limit=self.config.prediction_limit, steps=1)

    def step4_video_generation(self, cycle: int) -> Optional[str]:
        if not self.config.generate_video:
            return None
        from ..scripts.video_generator import VideoGenerator

        pred_dir = os.path.join(self.output_dir,
                                f"cycle_{cycle}_predictions")
        video = os.path.join(self.output_dir, f"cycle_{cycle}_video.mp4")
        gen = VideoGenerator(width=1280, height=720, duration_per_image=1.0,
                             fps=15, device=self.device)
        return gen.create_side_by_side_video(self.test_dir, pred_dir, video)

    def augmentation_ratios(self) -> Dict[str, float]:
        c = self.config
        return {
            "logo": max(c.transparent_ratio - c.text_watermark_ratio / 2,
                        0.1),
            "multi": c.multi_watermark_ratio,
            "text": c.text_watermark_ratio,
            "mixed": c.mixed_watermark_ratio,
        }

    def step5_data_augmentation(self, cycle: int) -> Dict:
        from ..data.gen_data import generate_dataset

        wm_dir = os.path.join(self.train_dir, "watermarked")
        existing = len(os.listdir(wm_dir)) if os.path.isdir(wm_dir) else 0
        new_count = max(int(existing * self.config.data_growth), 10)
        if not os.path.isdir(self.clean_dir) or not os.listdir(
                self.clean_dir):
            logger.warning("no clean images at %s; skipping augmentation",
                           self.clean_dir)
            return {"generated": 0}
        stats = generate_dataset(
            self.clean_dir, self.train_dir,
            logos_dir=self.logos_dir if os.path.isdir(self.logos_dir)
            else None,
            count=new_count, ratios=self.augmentation_ratios(),
            seed=1000 + cycle, device=self.device)
        return {"generated": sum(v for k, v in stats.items()
                                 if k != "skipped"), **stats}

    def step6_heldout_eval(self, cycle: int) -> Optional[Dict]:
        root = self.config.heldout_eval_dir
        if not root:
            return None
        from ..scripts.quality_report import eval_segmentation

        ckpt = self._newest_checkpoint()
        if not ckpt:
            return None
        out: Dict = {"checkpoint": ckpt}
        tiers = [("smooth", root)]
        if self.config.heldout_eval_tex_dir:
            tiers.append(("textured", self.config.heldout_eval_tex_dir))
        for tier, tier_root in tiers:
            res = eval_segmentation(
                tier_root, limit=self.config.heldout_eval_limit,
                weights=ckpt, model_name=self.cfg.MODEL.NAME,
                encoder=self.cfg.MODEL.ENCODER_NAME,
                img_size=self.cfg.DATA.IMG_SIZE, device=self.device)
            out[tier] = {"n_images": res.get("n_images"),
                         "raw": res.get("raw"),
                         "pipeline": res.get("pipeline"),
                         "error": res.get("error")}
        out.update(out["smooth"])
        return out

    def run_cycle(self, cycle: int) -> Dict:
        info: Dict = {"cycle": cycle, "start_time": time.time(),
                      "steps": {}}
        self.step_seconds = {}

        def timed(name, fn, *args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                self.step_seconds[name] = time.perf_counter() - t0

        try:
            best = timed("model_selection", self.step1_model_selection,
                         cycle)
            info["steps"]["model_selection"] = {"best_model": best}

            tr = timed("training", self.step2_training, cycle, best)
            info["steps"]["training"] = {
                "best_val_loss": tr["best_val_loss"],
                "epochs_run": tr["epochs_run"],
            }

            pred = timed("prediction", self.step3_prediction, cycle)
            info["steps"]["prediction"] = {
                "status": pred.get("status"),
                "successful_images": pred.get("successful_images", 0),
            }

            video = timed("video", self.step4_video_generation, cycle)
            info["steps"]["video"] = {"path": video}

            aug = timed("data_augmentation", self.step5_data_augmentation,
                        cycle)
            info["steps"]["data_augmentation"] = aug

            held = timed("heldout_eval", self.step6_heldout_eval, cycle)
            if held is not None:
                info["steps"]["heldout_eval"] = held
            info["status"] = "success"
        except Exception as e:  # noqa: BLE001
            logger.exception("cycle %d failed: %s", cycle, e)
            info["status"] = "failed"
            info["error"] = str(e)
        info["duration"] = time.time() - info["start_time"]
        with open(os.path.join(self.output_dir,
                               f"cycle_{cycle}_info.json"), "w") as f:
            json.dump(info, f, indent=2, default=str)
        return info

    def run_all_cycles(self) -> Dict:
        for cycle in range(self.config.max_cycles):
            logger.info("=== auto-train cycle %d/%d ===", cycle + 1,
                        self.config.max_cycles)
            info = self.run_cycle(cycle)
            self.cycle_history.append(info)
        report = {
            "cycles_completed": len(self.cycle_history),
            "successful_cycles": sum(
                1 for c in self.cycle_history if c["status"] == "success"),
            "cycles": self.cycle_history,
        }
        with open(os.path.join(self.output_dir, "final_report.json"),
                  "w") as f:
            json.dump(report, f, indent=2, default=str)
        return report
