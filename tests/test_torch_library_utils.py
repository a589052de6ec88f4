"""unet_watermark_tpu_torch.utils against unet_watermark_tpu.utils: each
case of the JAX package's tests/test_utils.py on the port, and the parts
with a JAX answer held to it.

  make_buckets, pad_to_bucket   equal for 1..300
  build_schedule                equal to optax's schedules at every step
                                0..N (rtol 1e-6), each scheduler, with and
                                without warmup; optax is evaluated with
                                64-bit floats (jax.enable_x64)
                                and the port's schedule is Python floats:
                                in float32 the cosine's last steps differ
                                by an ulp of cos(), several 1e-6 of lr
  build_optimizer               the parameters after each step equal
                                optax's on the same arrays and gradients
                                (adamw, adam, sgd; with clip; MultiSteps
                                k = 2) to 1e-6 of the update, plus one
                                float32 ulp of the parameter (the add)
  OptimizationConfig            JSON and YAML files written by either
                                package load in the other to equal configs
  list_checkpoints              JAX's rows on a directory with a JAX orbax
                                checkpoint (JAX's own save_checkpoint), a
                                port checkpoint and a .pth: equal but the
                                port directory's kind ("npz"; JAX's rule
                                names every directory with meta.json
                                "orbax", a stated difference)
The memory, monitor and profiler cases run on the CPU here (no card: the
device fields are zero, as JAX's are without device stats); the card's
readings are chip_smoke.py's phase 3p."""
import json
import logging
import os
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from unet_watermark_tpu import utils as ju
from unet_watermark_tpu.utils import optimization_config as joc
from unet_watermark_tpu.utils import training_optimizer as jto
from unet_watermark_tpu_torch import utils as tu
from unet_watermark_tpu_torch.utils import optimization_config as toc
from unet_watermark_tpu_torch.utils import training_optimizer as tto

torch.set_num_threads(2)
UPDATE_RTOL = 1e-6


def test_exports_equal_jax():
    assert tu.__all__ == ju.__all__ and len(tu.__all__) == 30
    assert all(hasattr(tu, name) for name in tu.__all__)


def test_timer_and_monitor():
    mon = tu.PerformanceMonitor()
    with tu.timer("t", log=False) as r:
        with mon.track("op"):
            time.sleep(0.01)
    assert r["seconds"] >= 0.01
    st = mon.stats("op")
    assert st["count"] == 1 and st["p50"] >= 0.01


def test_memory_manager_snapshot_and_pressure():
    mm = tu.TPUMemoryManager()
    snap = mm.snapshot()
    assert snap.host_total > 0 and 0 <= snap.host_percent <= 100
    assert snap.device_bytes_limit == 0  # no card here
    assert mm.check_memory_pressure() in ("ok", "warning", "critical")
    with tu.memory_context(mm, "x"):
        pass
    assert tu.get_global_memory_manager() is tu.get_global_memory_manager()


def test_pressure_callbacks_and_monitor_thread():
    mm = tu.TPUMemoryManager(warning_threshold=0.0, critical_threshold=0.001,
                             monitor_interval=0.01)
    heard = []
    mm.add_callback(lambda snap, level: heard.append(level))
    assert mm.check_memory_pressure() == "critical"
    mm.start_monitoring()
    time.sleep(0.1)
    mm.stop_monitoring()
    assert len(heard) >= 2 and set(heard) == {"critical"}
    params = mm.optimize_dataloader_params(512 * 512 * 3, 8)
    assert 1 <= params["num_workers"] <= 16
    assert 1 <= params["prefetch_factor"] <= 8


def test_log_memory_usage(caplog):
    from unet_watermark_tpu_torch.utils.memory import log_memory_usage

    with caplog.at_level(logging.INFO,
                         logger="unet_watermark_tpu_torch.utils.memory"):
        snap = log_memory_usage("unit")
    assert snap.host_total > 0
    assert any("unit memory:" in r.message for r in caplog.records)


def test_compiled_memory_bytes():
    """A run's peak on the card; without a card argument, None (as JAX's
    without a memory analysis)."""
    x = torch.zeros(128, 128)
    assert tu.TPUMemoryManager.compiled_memory_bytes(lambda v: v * 2, x) \
        is None
    assert tu.TPUMemoryManager().fits_on_device(lambda v: v, x) is None


def test_batch_size_optimizer():
    def make(b):
        return (lambda x: x.sum()), (torch.zeros(b, 8, 8),)

    opt = tu.BatchSizeOptimizer(make, max_batch=16)
    assert opt.find_optimal_batch_size() == 16
    assert opt.peaks == {1: None, 2: None, 4: None, 8: None, 16: None}


def test_batch_size_optimizer_raises_other_errors():
    def make(b):
        def fn(x):
            raise ValueError("not a memory error")
        return fn, (torch.zeros(b),)

    with pytest.raises(ValueError):
        tu.BatchSizeOptimizer(make, max_batch=4).find_optimal_batch_size()


def test_adaptive_batch_processor_halves_on_failure():
    calls = []

    def process(items):
        calls.append(len(items))
        if len(items) > 2:
            raise RuntimeError("too big")
        return [i * 2 for i in items]

    p = tu.AdaptiveBatchProcessor(process, initial_batch_size=8)
    out = p.process_all(list(range(10)))
    assert sorted(out) == [i * 2 for i in range(10)]
    assert p.get_statistics()["processed"] == 10
    q = ju.AdaptiveBatchProcessor(process, initial_batch_size=8)
    calls_port = list(calls)
    calls.clear()
    assert q.process_all(list(range(10))) == out
    assert calls == calls_port
    assert q.get_statistics()["current_batch_size"] == \
        p.get_statistics()["current_batch_size"]


def test_buckets_equal_jax():
    assert tu.make_buckets(32) == [1, 2, 4, 8, 16, 32]
    assert tu.pad_to_bucket(5, [1, 2, 4, 8]) == 8
    assert tu.pad_to_bucket(100, [1, 2, 4, 8]) == 8
    for n in range(1, 301):
        buckets = ju.make_buckets(n)
        assert tu.make_buckets(n) == buckets
        for m in (1, n // 2 + 1, n, n + 1):
            assert tu.pad_to_bucket(m, buckets) == \
                ju.pad_to_bucket(m, buckets)


def test_optimization_config_presets_and_roundtrip(tmp_path):
    for level in ("conservative", "balanced", "aggressive"):
        cfg = tu.OptimizationConfig.from_level(level)
        assert cfg.validate() == []
        assert cfg.to_dict() == ju.OptimizationConfig.from_level(
            level).to_dict()
    a = tu.OptimizationConfig.aggressive()
    p = str(tmp_path / "opt.yaml")
    a.save(p)
    b = tu.OptimizationConfig.load(p)
    assert b.to_dict() == a.to_dict() and b.level == a.level
    cm = tu.ConfigManager(str(tmp_path / "presets"))
    path = cm.save_preset("agg", a)
    assert path.endswith(".yaml") and "agg" in cm.list_presets()
    assert cm.load_preset("agg").to_dict() == a.to_dict()
    d = tu.ConfigManager.diff(tu.OptimizationConfig.balanced(), a)
    assert any("batch" in k for k in d)
    assert d == ju.ConfigManager.diff(ju.OptimizationConfig.balanced(),
                                      ju.OptimizationConfig.aggressive())


@pytest.mark.parametrize("suffix", [".json", ".yaml"])
def test_optimization_config_files_cross_packages(tmp_path, suffix):
    cfg = toc.OptimizationConfig.conservative()
    cfg.model.compile_cache_dir = "cache dir: 'x'"
    cfg.memory.monitor_interval = 1e-06
    cfg.batch.max_batch_size = 12
    port_file = str(tmp_path / f"port{suffix}")
    cfg.save(port_file)
    from_jax = joc.OptimizationConfig.load(port_file)
    assert from_jax.to_dict() == cfg.to_dict()
    jax_file = str(tmp_path / f"jax{suffix}")
    from_jax.save(jax_file)
    assert toc.OptimizationConfig.load(jax_file).to_dict() == cfg.to_dict()
    problems = toc.OptimizationConfig.from_dict(
        {"batch": {"initial_batch_size": 99}}).validate()
    assert problems == joc.OptimizationConfig.from_dict(
        {"batch": {"initial_batch_size": 99}}).validate()


def test_optimization_config_autodetect():
    cfg = tu.OptimizationConfig.auto_detect()
    assert cfg.validate() == []
    assert cfg.level == tu.OptimizationLevel.CONSERVATIVE  # no card here


def test_optimization_manager_facade(tmp_path):
    from unet_watermark_tpu_torch.configs import get_cfg_defaults

    om = tu.OptimizationManager(tu.OptimizationConfig.balanced())
    base = get_cfg_defaults()
    base.MODEL.DTYPE = "float32"
    cfg = om.optimize_model_config(base)
    assert cfg.MODEL.DTYPE == "bfloat16" and base.MODEL.DTYPE == "float32"
    assert cfg.TRAIN.BATCH_SIZE == 8 and cfg.DATA.NUM_WORKERS == 8
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.benchmark)
    with om.optimization_context("work"):
        time.sleep(0.01)
    assert flags == (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.benchmark)
    recs = om.get_recommendations()
    assert isinstance(recs, list) and recs
    paths = om.generate_report(str(tmp_path / "report"))
    assert os.path.exists(paths["json"]) and os.path.exists(paths["markdown"])
    with open(paths["json"]) as f:
        assert set(json.load(f)) == {"system", "operations",
                                     "recommendations"}
    om.shutdown()


def test_performance_analyzer_profile_decorator():
    pa = tu.PerformanceAnalyzer()

    @pa.performance_profile("myop")
    def work():
        time.sleep(0.005)

    for _ in range(3):
        work()
    st = pa.profiler.stats("myop")
    assert st["count"] == 3
    s = pa.monitor.sample()
    assert 0 <= s.cpu_percent <= 100 and 0 < s.ram_percent <= 100
    assert pa.recommendations()


def test_recommendation_rules_equal_jax():
    """JAX's thresholds in JAX's order, on the same samples and timings."""
    def fill(pa, sample_cls, rows, op_times):
        pa.monitor.samples = [sample_cls(0.0, c, r, d, 0)
                              for c, r, d in rows]
        for t in op_times:
            pa.profiler.record("op", t)

    from unet_watermark_tpu.utils import performance_analyzer as jpa
    from unet_watermark_tpu_torch.utils import performance_analyzer as tpa

    cases = [([(90, 90, 10), (95, 88, 95)], [0.1] * 19 + [10.0]),
             ([(10, 10, 50), (20, 20, 60)], [0.1] * 5),
             ([(50, 86, 93), (50, 90, 20)], [])]
    for rows, times in cases:
        p, j = tpa.PerformanceAnalyzer(), jpa.PerformanceAnalyzer()
        fill(p, tpa.SystemSample, rows, times)
        fill(j, jpa.SystemSample, rows, times)
        ours, theirs = p.recommendations(), j.recommendations()
        assert len(ours) == len(theirs)
        assert p.monitor.summary() == j.monitor.summary()
        for a, b in zip(ours, theirs):
            assert a.split(" — ")[0].split()[0] == b.split(" — ")[0].split()[0]


def test_optimized_dataset_lru():
    class DS:
        def __len__(self):
            return 10

        def __getitem__(self, i):
            return i * i

    ds, jds = tu.OptimizedDataset(DS(), 3), ju.OptimizedDataset(DS(), 3)
    for i in [0, 1, 2, 0, 1, 3, 0]:
        assert ds[i] == jds[i]
    assert ds.cache_stats() == jds.cache_stats()
    assert ds.cache_stats()["cached"] <= 3


def test_optimized_predictor_pads_remainder():
    seen = []

    def fwd(x):
        seen.append(tuple(x.shape))
        return x * 2.0

    p = tu.OptimizedPredictor(fwd, batch_size=4, device="cpu")
    out = p.predict([np.full((2, 2), float(i)) for i in range(6)])
    assert len(out) == 6 and seen == [(4, 2, 2), (4, 2, 2)]
    np.testing.assert_allclose(out[5].numpy(), np.full((2, 2), 10.0))
    st = p.get_statistics()
    assert st["batch_size"] == 4 and st["count"] == 2


def test_optimized_predictor_tuples_tuning_and_saving(tmp_path):
    def fwd(x):
        return x.sum(dim=(1, 2)), ["kind"] * x.shape[0]

    p = tu.OptimizedPredictor(fwd, batch_size=3, device="cpu",
                              auto_tune_batch=True,
                              example_input=np.ones((2, 2), np.float32),
                              max_batch_size=8)
    assert p.batch_size == 8  # no card: every batch runs, none measured
    out = p.predict([np.full((2, 2), 1.0)] * 3)
    assert [float(a) for a, _ in out] == [4.0] * 3
    assert all(k == "kind" for _, k in out)
    q = tu.OptimizedPredictor(lambda x: x + 1, batch_size=2, device="cpu")
    paths = q.predict_and_save([np.zeros(3)] * 3, str(tmp_path))
    assert len(paths) == 3
    np.testing.assert_array_equal(np.load(paths[2]), np.ones(3))


def test_predictor_defaults_to_the_card():
    with pytest.raises(RuntimeError):
        tu.OptimizedPredictor(lambda x: x)


def test_benchmark_pipeline():
    batches = [{"image": torch.zeros((4, 2, 2, 3)),
                "valid": torch.ones((4,))} for _ in range(3)]
    stats = tu.benchmark_pipeline(iter(batches))
    assert stats["samples"] == 12 and stats["batches"] == 3
    stats = tu.benchmark_pipeline(iter([{"image": np.zeros((5, 2))}]))
    assert stats["samples"] == 5


def test_auto_tune_loader_params():
    got = tu.auto_tune_loader_params(3 * 512 * 512, 8)
    assert set(got) == {"num_workers", "prefetch_factor"}


SCHEDULES = [dict(scheduler=s, warmup_steps=w, total_steps=60,
                  learning_rate=0.1, min_lr=1e-4, step_decay_every=7,
                  step_decay_factor=0.5)
             for s in ("cosine", "step", "plateau", "none") for w in (0, 9)]


@pytest.mark.parametrize("kw", SCHEDULES,
                         ids=[f"{k['scheduler']}-w{k['warmup_steps']}"
                              for k in SCHEDULES])
def test_build_schedule_equals_optax(kw):
    ours = tto.build_schedule(tto.TrainingConfig(**kw))
    with jax.enable_x64(True):
        theirs = jto.build_schedule(jto.TrainingConfig(**kw))
        want = [float(theirs(jnp.asarray(k, jnp.int64)))
                for k in range(kw["total_steps"] + 5)]
    got = [ours(k) for k in range(kw["total_steps"] + 5)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if kw["warmup_steps"]:
        assert got[0] == 0.0 and got[kw["warmup_steps"]] == pytest.approx(
            0.1, rel=1e-6)


def test_training_optimizer_schedules():
    cfg = tu.TrainingConfig(learning_rate=0.1, warmup_steps=10,
                            total_steps=100, scheduler="cosine")
    sched = tu.build_schedule(cfg)
    assert sched(0) == pytest.approx(0.0)
    assert sched(10) == pytest.approx(0.1, rel=1e-5)
    assert sched(99) < 0.1
    # grad accumulation: after 4 micro-steps exactly one update happened
    w = torch.ones(3)
    tx = tu.build_optimizer(tu.TrainingConfig(gradient_accumulation_steps=4),
                            [w])
    moved = [tx.step([torch.ones(3)]) for _ in range(4)]
    assert moved == [False, False, False, True]
    assert not torch.allclose(w, torch.ones(3))


OPTIMIZERS = [dict(optimizer=o, gradient_clip=c,
                   gradient_accumulation_steps=k)
              for o in ("adamw", "adam", "sgd") for c in (0.0, 0.05)
              for k in (1, 2)]


@pytest.mark.parametrize("kw", OPTIMIZERS,
                         ids=[f"{k['optimizer']}-clip{k['gradient_clip']}-"
                              f"k{k['gradient_accumulation_steps']}"
                              for k in OPTIMIZERS])
def test_build_optimizer_updates_equal_optax(kw):
    cfg = dict(kw, learning_rate=0.05, weight_decay=0.1, warmup_steps=2,
               total_steps=8, scheduler="cosine", min_lr=1e-3)
    rng = np.random.default_rng(1)
    p0 = {"w": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal(4).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) * 0.2
              for k, v in p0.items()} for _ in range(8)]
    tx = jto.build_optimizer(jto.TrainingConfig(**cfg))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    tp = [torch.from_numpy(p0[k].copy()) for k in ("w", "b")]
    opt = tto.build_optimizer(tto.TrainingConfig(**cfg), tp)
    update = jax.jit(tx.update)
    for g in grads:
        upd, state = update({k: jnp.asarray(v) for k, v in g.items()},
                            state, jp)
        new = optax.apply_updates(jp, upd)
        opt.step([torch.from_numpy(g[k]) for k in ("w", "b")])
        for i, k in enumerate(("w", "b")):
            want = np.asarray(new[k])
            step = np.abs(np.asarray(upd[k])).max()
            # 1e-6 of the update, and the rounding of the add into p
            np.testing.assert_allclose(
                tp[i].numpy(), want, rtol=0,
                atol=UPDATE_RTOL * step + np.spacing(np.abs(want).max()))
        jp = new


def test_build_optimizer_refuses_unknown():
    with pytest.raises(ValueError):
        tu.build_optimizer(tu.TrainingConfig(optimizer="lamb"),
                           [torch.zeros(1)])


class Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.c = nn.Conv2d(3, 1, 1)

    def forward(self, x):  # (N, H, W, 3) → (N, H, W, 1), as the port's nets
        return self.c(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def test_training_optimizer_trains(tmp_path):
    def loss_fn(out, target):
        return torch.mean((out - target) ** 2)

    cfg = tu.TrainingConfig(learning_rate=0.05, scheduler="none",
                            output_dir=str(tmp_path / "topt"),
                            total_steps=100, gradient_clip=0.0,
                            compute_dtype="float32")
    topt = tu.TrainingOptimizer(Tiny(), loss_fn, cfg, device="cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((8, 8, 8, 3)).astype(np.float32))
    y = x[..., :1] * 2.0

    def batches():
        yield {"image": x, "mask": y}

    result = topt.train(batches, epochs=12, val_batches_fn=batches)
    h = result["history"]["train_loss"]
    assert h[-1] < h[0] and len(result["history"]["val_loss"]) == 12
    assert set(result["history"]) == {"train_loss", "val_loss", "lr",
                                      "epoch_time"}
    assert os.path.exists(tmp_path / "topt" / "training_history.json")
    assert result["state"]["step"] == 12


def test_training_optimizer_accumulates():
    cfg = tu.TrainingConfig(learning_rate=0.01, scheduler="none",
                            gradient_accumulation_steps=2,
                            compute_dtype="float32", output_dir="unused")
    topt = tu.TrainingOptimizer(Tiny(), lambda o, t: (o - t).square().mean(),
                                cfg, device="cpu")
    batch = {"image": torch.rand(2, 4, 4, 3), "mask": torch.rand(2, 4, 4, 1)}
    state = topt.init_state(batch)
    before = [p.detach().clone() for p in topt.model.parameters()]
    moved = []
    for _ in range(4):
        state, loss = topt.step(state, batch)
        now = [p.detach().clone() for p in topt.model.parameters()]
        moved.append(any(not torch.equal(a, b) for a, b in zip(before, now)))
        before = now
        assert torch.isfinite(loss)
    assert moved == [False, True, False, True]


def _jax_checkpoint(directory):
    from unet_watermark_tpu.training import checkpoint as jck

    state = types.SimpleNamespace(
        params={"c": {"kernel": jnp.ones((1, 1, 3, 1))}},
        batch_stats={}, step=jnp.asarray(7, jnp.int32), opt_state=None)
    meta = {"epoch": 3, "history": {"val_loss": [0.5, 0.25],
                                    "val_iou": [0.1, 0.625],
                                    "val_f1": [0.2, 0.75]}}
    jck.save_checkpoint(str(directory), "jax_ckpt", state, meta)


def test_model_manager_lists_and_compares(tmp_path, capsys):
    from unet_watermark_tpu_torch.training import checkpoint as tck

    torch.save({"model_state_dict": {}, "epoch": 5, "best_val_loss": 0.1,
                "val_metrics": {"iou": 0.8, "f1": 0.9}},
               str(tmp_path / "a.pth"))
    _jax_checkpoint(tmp_path)
    tck.save_checkpoint(str(tmp_path), "port_ckpt",
                        {"params/c/kernel": np.ones((1, 1, 3, 1),
                                                    np.float32)},
                        {"epoch": 1, "history": {"val_loss": [0.75],
                                                 "val_iou": [0.5],
                                                 "val_f1": [0.25]}})
    (tmp_path / "notes.txt").write_text("not a checkpoint")
    os.makedirs(tmp_path / "empty_dir")
    rows = tu.list_checkpoints(str(tmp_path))
    want = ju.list_checkpoints(str(tmp_path))
    assert [r["name"] for r in rows] == ["a.pth", "jax_ckpt", "port_ckpt"]
    assert [r["kind"] for r in rows] == ["pth", "orbax", "npz"]
    for r, w in zip(rows, want):
        assert list(r) == list(w)
        assert {k: v for k, v in r.items() if k != "kind"} == \
            {k: v for k, v in w.items() if k != "kind"}
    assert [w["kind"] for w in want] == ["pth", "orbax", "orbax"]
    rows2 = tu.compare_models(str(tmp_path))
    out = capsys.readouterr().out
    ju.compare_models(str(tmp_path))
    jout = capsys.readouterr().out
    assert "a.pth" in out and len(rows2) == len(rows)
    assert out.replace("npz    ", "orbax  ") == jout
    assert tu.list_checkpoints(str(tmp_path / "missing")) == []


def test_xla_trace_and_annotate(tmp_path):
    with tu.xla_trace(str(tmp_path / "trace")):
        with tu.annotate("region"):
            torch.ones(4).add_(1)
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "region" in f.read()
