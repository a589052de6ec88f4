"""Run a function in a gloo process group of N CPU ranks, for the port's
data-parallel tests (tests/test_torch_parallel.py, test_torch_dp_train.py).

Each rank is a spawned process that forms the group through the port's
parallel.distributed.initialize with a file:// store in the test's tmp
directory (no TCP port, so xdist workers cannot collide), calls
`target(rank, world, *args)` and saves what it returns with torch.save.
A rank that raises writes its traceback and exits non-zero; the others
are then killed, as are all of them past the timeout, and the test
fails with the tracebacks."""
from __future__ import annotations

import multiprocessing
import time
import traceback
from pathlib import Path

import torch


def _entry(target, rank: int, world: int, store: str, out: str,
           threads: int, args: tuple) -> None:
    from unet_watermark_tpu_torch.parallel import distributed

    torch.set_num_threads(threads)
    try:
        distributed.initialize(f"file://{store}", world, rank,
                               device="cpu", timeout_s=120)
        result = target(rank, world, *args)
        torch.save(result, Path(out) / f"rank{rank}.pt")
        distributed.shutdown()
    except BaseException:  # noqa: BLE001 — reported by the parent
        (Path(out) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise SystemExit(1)


def start(target, world: int, tmp: Path, *args, threads: int = 2):
    """Start the ranks; returns a handle for join()."""
    out = Path(tmp) / f"ranks_{target.__name__}"
    out.mkdir(parents=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry, daemon=True,
                         args=(target, r, world, str(out / "store"),
                               str(out), threads, args))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, out


def join(handle, timeout: float = 300.0) -> list:
    """Wait for every rank; the list of their results in rank order."""
    procs, out = handle
    deadline = time.monotonic() + timeout
    failed = False
    while any(p.is_alive() for p in procs):
        failed = any(p.exitcode not in (None, 0) for p in procs)
        if failed or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join(5)
    errors = "\n".join(f.read_text() for f in sorted(out.glob("*.err")))
    codes = [p.exitcode for p in procs]
    if errors or any(c != 0 for c in codes):
        raise AssertionError(f"ranks ended with {codes}"
                             f"{' (timeout)' if not failed and not errors else ''}"
                             f":\n{errors}")
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(len(procs))]


def run(target, world: int, tmp: Path, *args, timeout: float = 300.0,
        threads: int = 2) -> list:
    return join(start(target, world, tmp, *args, threads=threads), timeout)
