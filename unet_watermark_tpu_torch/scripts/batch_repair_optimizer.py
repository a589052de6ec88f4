"""Resource-aware chunked repair (scripts/batch_repair_optimizer.py in the
JAX package): a large repair job in chunks of `chunk_size` images, each a
process_folder_batch(limit=chunk_size) of the predictor (step 1 skips the
images whose masks are already in the output), with the memory manager
(utils/memory.py: the card's and the host's memory) consulted before each
chunk: cleanup under warning, aggressive cleanup and a pause when
critical. The chunk records and the stop rule (a chunk with no images
ends the job) are JAX's.

CLI (on the card unless --device cpu):
    python -m unet_watermark_tpu_torch.scripts.batch_repair_optimizer \\
        --model W.npz --input D --output O [--config Y] [--chunk-size 32]
"""
from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Dict

logger = logging.getLogger(__name__)


class BatchRepairOptimizer:
    def __init__(self, predictor, chunk_size: int = 32,
                 pause_seconds: float = 5.0, memory_manager=None):
        from ..utils.memory import get_global_memory_manager

        self.predictor = predictor
        self.chunk_size = chunk_size
        self.pause_seconds = pause_seconds
        self.mm = memory_manager or get_global_memory_manager()

    def run(self, input_folder: str, output_folder: str,
            **repair_kwargs) -> Dict:
        files = self.predictor._get_image_files(input_folder)
        total = len(files)
        chunks = max(1, -(-total // self.chunk_size))
        logger.info("repair job: %d images in %d chunks", total, chunks)
        aggregate: Dict = {"chunks": [], "total_images": total}
        done = 0
        for ci in range(chunks):
            level = self.mm.check_memory_pressure()
            if level == "critical":
                logger.warning("memory critical before chunk %d; cleaning "
                               "and pausing %.0fs", ci, self.pause_seconds)
                self.mm.aggressive_cleanup()
                time.sleep(self.pause_seconds)
            elif level == "warning":
                self.mm.cleanup()
            stats = self.predictor.process_folder_batch(
                input_folder, output_folder, limit=self.chunk_size,
                **repair_kwargs)
            aggregate["chunks"].append({
                "chunk": ci,
                "status": stats.get("status"),
                "images": stats.get("total_images", 0),
                "time": stats.get("processing_time", 0.0),
            })
            done += stats.get("total_images", 0)
            if stats.get("total_images", 0) == 0:
                break  # nothing left unprocessed
        aggregate["processed"] = done
        return aggregate


def main(argv=None):
    p = argparse.ArgumentParser(description="chunked resource-aware repair")
    p.add_argument("--model", required=True)
    p.add_argument("--config", default=None)
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--chunk-size", type=int, default=32)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ..configs import get_cfg_defaults, update_config
    from ..inference.predict import WatermarkPredictor

    cfg = get_cfg_defaults()
    if args.config and os.path.exists(args.config):
        update_config(cfg, args.config)
    predictor = WatermarkPredictor(cfg, weights_path=args.model,
                                   device=args.device)
    opt = BatchRepairOptimizer(predictor, chunk_size=args.chunk_size)
    out = opt.run(args.input, args.output, use_ocr=False, steps=1,
                  watermark_model="pushpull")
    print(out)
    return out


if __name__ == "__main__":
    main()
