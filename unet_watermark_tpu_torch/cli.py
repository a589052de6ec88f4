"""The port's command line (cli.py in the JAX package): the `train`,
`repair` and `auto` subcommands, with the JAX CLI's flags and defaults.

    python -m unet_watermark_tpu_torch.cli train -c <yaml> --data-dir D \\
        [--epochs N] [--resume DIR] [--init-weights W.npz] [--opts K V ...]
    python -m unet_watermark_tpu_torch.cli repair --input D --output O \\
        [--device cuda|cpu] [--no-ocr] [--ocr-engine easy|builtin|paddle] \\
        [--video [--video-width W --video-height H --duration S --fps F]]
    python -m unet_watermark_tpu_torch.cli auto --project-root R \\
        [--max-cycles N] [--epochs K] [--config-file overrides.json]

`train` follows the JAX CLI's order, CLI flags over --opts over the YAML
over the defaults, and writes checkpoints, training_history.json and the
shipped-format .npz beside --model-save-path (training/train.py). Under
torchrun it trains data parallel over the group, one rank a card:

    torchrun --nproc-per-node N -m unet_watermark_tpu_torch.cli train ...

(`--device cpu` there forms a gloo group of CPU ranks); rank 0 logs and
writes the files.

Steps 1-5 run as in the JAX CLI, OCR included (--ocr-engine easy gives the
builtin detector where easyocr is not installed, as there). --device is
"cuda" unless it says "cpu" ("auto" and "gpu" mean "cuda"); "cuda" without
a card raises. --model takes a shipped-format .npz, a port checkpoint
directory or a reference .pth (an smp-layout UNet++ is detected);
--inpaint-weights a LaMa .npz or directory, or a big-lama torch
checkpoint (.pt, .pth, .ckpt). `train --use-blurred-mask` trains on the
soft blurred masks (data/dataset.py). --video writes
comparison_video.mp4 (scripts/video_generator.py: three-way where the
output has masks/, else side by side); a writer error is logged as in the
JAX CLI, an input form the port does not read yet is raised. `auto` runs
training/auto_train.AutoTrainingLoop with the JAX CLI's flags, a JSON
--config-file's keys over them. --quant runs the int8 tier
(PREDICT.QUANT, set after --opts are merged). The LaMa weights of --inpaint-weights go into the config
(PREDICT.INPAINT_WEIGHTS) where the JAX CLI sets the
PREDICT_INPAINT_WEIGHTS environment variable.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys

from .configs import DEFAULT_CONFIG

logger = logging.getLogger("unet_watermark_tpu_torch.cli")

DEVICES = {"cuda": "cuda", "gpu": "cuda", "auto": "cuda", "": "cuda",
           "cpu": "cpu"}


def setup_device(device_str: str) -> str:
    """The torch device of --device; anything but cuda/gpu/auto/cpu raises."""
    if device_str not in DEVICES:
        raise ValueError(f"--device {device_str!r}: the port runs on 'cuda' "
                         f"(also 'gpu', 'auto') or 'cpu'")
    return DEVICES[device_str]


def _load_cfg(args):
    from .configs import get_cfg_defaults, update_config

    cfg = get_cfg_defaults()
    if getattr(args, "config", None) and os.path.exists(args.config):
        update_config(cfg, args.config)
    return cfg


def train_command(args) -> int:
    """training.train.train on the config after the CLI's overrides."""
    device = setup_device(args.device)
    cfg = _load_cfg(args)
    if args.data_dir:
        cfg.DATA.ROOT_DIR = args.data_dir
    if args.output_dir:
        cfg.TRAIN.OUTPUT_DIR = args.output_dir
    if args.model_save_path:
        cfg.TRAIN.MODEL_SAVE_PATH = args.model_save_path
    if args.batch_size:
        cfg.TRAIN.BATCH_SIZE = args.batch_size
    if args.epochs:
        cfg.TRAIN.EPOCHS = args.epochs
    if args.lr:
        cfg.TRAIN.LR = args.lr
    if args.no_early_stopping:
        cfg.TRAIN.USE_EARLY_STOPPING = False
    if args.early_stopping_patience:
        cfg.TRAIN.EARLY_STOPPING_PATIENCE = args.early_stopping_patience
    if args.opts:
        cfg.merge_from_list(args.opts)

    from .parallel import distributed
    from .training.train import train

    # under torchrun: one rank a card (cuda:LOCAL_RANK, NCCL) or gloo
    # ranks on the CPU; a plain run is a world of one and forms no group
    owned = not distributed.in_group()
    rank, world = distributed.initialize(device=device)
    if distributed.in_group() and device == "cuda":
        device = f"cuda:{distributed.local_rank()}"
    if rank:
        logging.getLogger().setLevel(logging.WARNING)
    try:
        result = train(cfg, resume_from=args.resume,
                       use_blurred_mask=args.use_blurred_mask,
                       init_weights=args.init_weights, device=device)
    finally:
        if owned:
            distributed.shutdown()
    logger.info("training done: best_val_loss=%.4f over %d epochs "
                "(%d rank%s)", result["best_val_loss"],
                result["epochs_run"], world, "s" if world > 1 else "")
    return 0


def repair_command(args) -> int:
    """WatermarkPredictor.process_folder_batch on the --input folder, then
    repair_summary.json in --output."""
    device = setup_device(args.device)
    cfg = _load_cfg(args)
    if args.opts:
        cfg.merge_from_list(args.opts)
    if args.quant:  # after --opts, as the JAX CLI
        cfg.PREDICT.QUANT = True
    if args.inpaint_weights:
        cfg.PREDICT.INPAINT_WEIGHTS = args.inpaint_weights

    from .inference.predict import WatermarkPredictor

    model_path = args.model if args.model and os.path.exists(args.model) \
        else None
    if args.model and model_path is None:
        logger.warning("model %s not found; using the shipped weights",
                       args.model)
    predictor = WatermarkPredictor(cfg, weights_path=model_path,
                                   device=device)
    stats = predictor.process_folder_batch(
        args.input, args.output,
        watermark_model=args.watermark_model,
        text_model=args.text_model,
        use_unet=not args.no_unet,
        use_ocr=not args.no_ocr,
        ocr_languages=args.ocr_languages,
        ocr_engine=args.ocr_engine,
        timeout=args.timeout,
        save_intermediate=args.save_intermediate,
        merge_masks=args.merge_masks,
        limit=args.limit,
        steps=args.steps,
    )
    summary_path = os.path.join(args.output, "repair_summary.json")
    os.makedirs(args.output, exist_ok=True)
    with open(summary_path, "w") as f:
        json.dump(stats, f, indent=2)
    logger.info("summary written: %s", summary_path)

    if args.video and stats.get("status") == "success":
        from .scripts.video_generator import VideoGenerator

        try:
            gen = VideoGenerator(width=args.video_width,
                                 height=args.video_height,
                                 duration_per_image=args.duration,
                                 fps=args.fps, device=device)
            video_path = os.path.join(args.output, "comparison_video.mp4")
            mask_dir = os.path.join(args.output, "masks")
            if os.path.isdir(mask_dir):
                gen.create_three_way_comparison_video(
                    args.video_input or args.input, args.output, mask_dir,
                    video_path)
            else:
                gen.create_side_by_side_video(
                    args.video_input or args.input, args.output, video_path)
            logger.info("comparison video: %s", video_path)
        except NotImplementedError:
            raise
        except Exception as e:  # noqa: BLE001
            logger.error("video generation failed: %s", e)
    return 0 if stats.get("status") == "success" else 1


def auto_train_command(args) -> int:
    """training.auto_train.AutoTrainingLoop over the JAX CLI's flags, with
    a --config-file JSON's keys set over them."""
    device = setup_device(args.device)
    cfg = _load_cfg(args)

    from .training.auto_train import AutoTrainConfig, AutoTrainingLoop

    auto_cfg = AutoTrainConfig(
        project_root=args.project_root or os.getcwd(),
        config_path=args.config or str(DEFAULT_CONFIG),
        max_cycles=args.max_cycles,
        epochs_per_cycle=args.epochs,
        batch_size=args.batch_size,
        learning_rate=args.learning_rate,
        output_dir=args.output_dir,
        samples=args.samples,
        prediction_limit=args.prediction_limit,
        transparent_ratio=args.transparent_ratio,
        text_watermark_ratio=args.text_watermark_ratio,
        mixed_watermark_ratio=args.mixed_watermark_ratio,
    )
    if args.config_file and os.path.exists(args.config_file):
        with open(args.config_file) as f:
            overrides = json.load(f)
        for k, v in overrides.items():
            if hasattr(auto_cfg, k):
                setattr(auto_cfg, k, v)
    loop = AutoTrainingLoop(auto_cfg, base_cfg=cfg, device=device)
    report = loop.run_all_cycles()
    logger.info("auto-train finished: %d cycles",
                report.get("cycles_completed", 0))
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="unet-watermark-tpu-torch",
        description="watermark detection and removal on one NVIDIA GPU "
                    "(the PyTorch/CUDA port)")
    sub = parser.add_subparsers(dest="command")

    tp = sub.add_parser("train", help="train the segmentation model")
    tp.add_argument("--config", "-c", type=str, default=str(DEFAULT_CONFIG))
    tp.add_argument("--device", type=str, default="cuda")
    tp.add_argument("--data-dir", type=str)
    tp.add_argument("--output-dir", type=str)
    tp.add_argument("--model-save-path", type=str)
    tp.add_argument("--batch-size", type=int)
    tp.add_argument("--epochs", type=int)
    tp.add_argument("--lr", type=float)
    tp.add_argument("--no-early-stopping", action="store_true")
    tp.add_argument("--early-stopping-patience", type=int)
    tp.add_argument("--resume", type=str)
    tp.add_argument("--init-weights", type=str, default=None,
                    help="warm-start params from a shipped-format .npz "
                         "(fine-tune; unlike --resume, optimizer state "
                         "and history start fresh)")
    tp.add_argument("--use-blurred-mask", action="store_true",
                    help="soft blurred training masks")
    tp.add_argument("--opts", nargs="*", default=None,
                    help="KEY VALUE pairs overriding config entries")
    tp.set_defaults(func=train_command)

    rp = sub.add_parser("repair", help="detect and repair watermarks")
    rp.add_argument("--input", type=str, default="data/test")
    rp.add_argument("--output", type=str, default="data/result")
    rp.add_argument("--model", type=str,
                    default="models/unet_watermark.pth")
    rp.add_argument("--config", "-c", type=str, default=str(DEFAULT_CONFIG))
    rp.add_argument("--device", type=str, default="cuda")
    rp.add_argument("--watermark-model", type=str, default="lama")
    rp.add_argument("--text-model", type=str, default="mat")
    rp.add_argument("--inpaint-weights", type=str, default=None,
                    help="FFC-LaMa weights (.npz); falls back to the "
                         "pushpull engine when none resolve")
    rp.add_argument("--timeout", type=int, default=300)
    rp.add_argument("--steps", type=int, default=3)
    rp.add_argument("--save-intermediate", action="store_true", default=True)
    rp.add_argument("--merge-masks", action="store_true", default=True)
    rp.add_argument("--limit", type=int)
    rp.add_argument("--quant", action="store_true",
                    help="int8 segmentation forward (needs the weights' "
                         "calibrated .quant.json sidecar)")
    rp.add_argument("--no-unet", action="store_true")
    rp.add_argument("--no-ocr", action="store_true",
                    help="skip steps 3-4 (the OCR text masks and their "
                         "repair)")
    rp.add_argument("--ocr-engine", type=str,
                    choices=["paddle", "easy", "builtin"], default="easy")
    rp.add_argument("--ocr-languages", type=str, nargs="+",
                    default=["en", "ch_sim"])
    rp.add_argument("--video", action="store_true",
                    help="write comparison_video.mp4 into --output")
    rp.add_argument("--video-input", type=str, default=None)
    rp.add_argument("--video-width", type=int, default=1920)
    rp.add_argument("--video-height", type=int, default=1080)
    rp.add_argument("--duration", type=float, default=2.0)
    rp.add_argument("--fps", type=int, default=30)
    rp.add_argument("--opts", nargs="*", default=None)
    rp.set_defaults(func=repair_command)

    ap = sub.add_parser("auto", help="self-improving train loop")
    ap.add_argument("--config-file", type=str,
                    help="JSON of AutoTrainConfig fields set over the flags")
    ap.add_argument("--config", "-c", type=str, default=str(DEFAULT_CONFIG))
    ap.add_argument("--project-root", type=str)
    ap.add_argument("--max-cycles", type=int, default=100)
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--learning-rate", type=float, default=0.001)
    ap.add_argument("--output-dir", type=str, default="models/auto")
    ap.add_argument("--samples", type=int, default=1000)
    ap.add_argument("--prediction-limit", type=int, default=100)
    ap.add_argument("--transparent-ratio", type=float, default=0.6)
    ap.add_argument("--text-watermark-ratio", type=float, default=0.5)
    ap.add_argument("--mixed-watermark-ratio", type=float, default=0.2)
    ap.set_defaults(func=auto_train_command)
    return parser


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command is None:
        parser.print_help()
        return 2
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
