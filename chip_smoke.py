#!/usr/bin/env python3
"""Drive the PyTorch port (meme_challenge_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which makes the script exit non-zero if it fails:

1. The card's name and power limit (nvidia-smi).
2. Build every CUDA kernel of the port from the sources in this checkout.
3. Kernel phase: each kernel at the main path's shapes (UNITER-base
   attention: B 16, H 12, S 160, D 64), float32 and bfloat16, dropout rate 0
   and 0.1, against its plain PyTorch version on the same inputs (TF32 off):
   rate 0 within atol 1e-5 (float32) / 2e-2 (bfloat16); rate 0.1 with the
   same values and exactly the same zero positions of the dropped
   probabilities. Times by CUDA events: the kernel, its plain version, and
   torch's scaled_dot_product_attention as a yardstick (never called by the
   port), beside the least time the card could take (the bound).
4. Slice phase: full-width UNITER-base inference through the port's CLI
   (``train_uniter.main`` with ``--max_epoch 0``) on a synthetic dataset, with
   the fused attention kernel, in float32, in bfloat16, and with the
   pair-blocked kernel. Checks the CSVs and metrics JSON, the launch counts
   (12 layers × eval batches), and one batch's float32 logits on the card
   against the same model and batch on the CPU (plain versions) within 1e-4.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PACKAGE = os.path.join(ROOT, "meme_challenge_tpu_torch")

# main-path attention shapes: UNITER-base, batch 16, 60 text + 100 boxes
B, H, S, D = 16, 12, 160, 64
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LOGIT_TOL = 1e-4
# H100 SXM data sheet (dense): memory bytes/s, and operations/s by type
PEAK_BYTES = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}
REPLACES = {
    "fused_attention": "meme_challenge_tpu/ops/attention.py:96",
    "fused_attention_blocked": "meme_challenge_tpu/ops/attention.py:265",
}
SOURCE = "meme_challenge_tpu_torch/ops/csrc/fused_attention.cu"


def fail(msg: str) -> None:
    print("FAIL: " + msg, file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


_CYCLES_PER_MS = []


def device_ms(fn, iters: int = 20, reps: int = 5) -> tuple:
    """(device ms per call, host ms per call) of ``fn``.

    The device time is taken with CUDA events around ``iters`` calls queued
    behind a ``torch.cuda._sleep`` long enough for the host to enqueue them
    all, so the card runs them back to back and the host's launch cost
    (Python, ctypes) stays out of it; the median of ``reps`` such runs. The
    host time is the wall time of one call while the card is busy."""
    import torch

    if not _CYCLES_PER_MS:
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        torch.cuda._sleep(10 ** 7)
        b.record()
        b.synchronize()
        _CYCLES_PER_MS.append(10 ** 7 / a.elapsed_time(b))
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(int(_CYCLES_PER_MS[0] * (3 * iters * host + 5)))
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times), host


def attention_bound_ms(dtype: str) -> tuple:
    """Least time for one launch: q, k, v read once, out written once, the
    fp32 key bias read once; 2·S·S·D multiply-adds twice per pair."""
    item = 4 if dtype == "float32" else 2
    nbytes = 4 * B * H * S * D * item + B * S * 4
    ops = 4 * B * H * S * S * D
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_OPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def attention_inputs(torch, dtype, gen):
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(B, H, S, D, generator=gen, device="cuda").to(dt)
               for _ in range(3))
    lens = torch.randint(20, S + 1, (B,), generator=gen, device="cuda")
    mask = (torch.arange(S, device="cuda")[None] < lens[:, None]).float()
    bias = ((1.0 - mask) * -10000.0)[:, None, None, :].contiguous()
    return q, k, v, bias


RAGGED = ((2, 3, 24, 8), (3, 4, 100, 64), (2, 2, 256, 128), (2, 12, 17, 16))


def ragged_checks(torch, A, gen) -> None:
    """Both kernels at shapes off the main path (S not a multiple of 32, the
    largest S and D the kernel takes) against their plain versions."""
    for shape in RAGGED:
        b, h, s, d = shape
        for name, kernel, plain, n_seeds in (
                ("fused_attention", A.fused_attention,
                 A.fused_attention_plain, b),
                ("fused_attention_blocked", A.fused_attention_blocked,
                 A.fused_attention_blocked_plain, A.blocked_seed_count(b, h))):
            for dtype in ("float32", "bfloat16"):
                dt = getattr(torch, dtype)
                q, k, v = (torch.randn(shape, generator=gen,
                                       device="cuda").to(dt) for _ in range(3))
                lens = torch.randint(1, s + 1, (b,), generator=gen,
                                     device="cuda")
                bias = ((torch.arange(s, device="cuda")[None] >= lens[:, None])
                        .float() * -10000.0)[:, None, None, :].contiguous()
                seeds = torch.randint(0, 2 ** 31 - 1, (n_seeds,),
                                      generator=gen, device="cuda",
                                      dtype=torch.int32)
                for rate in (0.0, 0.1):
                    out = kernel(q, k, v, bias, d ** -0.5, rate, seeds)
                    ref = plain(q, k, v, bias, d ** -0.5, rate, seeds)
                    err = (out.float() - ref.float()).abs().max().item()
                    if err > TOL[dtype] or not torch.equal(out == 0,
                                                           ref == 0):
                        fail("kernel %s %s at %s rate %g: max_abs_err %.3g"
                             % (name, dtype, shape, rate, err))
    torch.cuda.synchronize()
    log("kernel shapes %s: both kernels, fp32 and bf16, rate 0 and 0.1, "
        "agree with their plain versions" % (RAGGED,))


def kernel_phase(torch) -> dict:
    from meme_challenge_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(0)
    ragged_checks(torch, A, gen)
    scale = 1.0 / D ** 0.5
    rate = 0.1
    pairs = (("fused_attention", A.fused_attention, A.fused_attention_plain,
              B),
             ("fused_attention_blocked", A.fused_attention_blocked,
              A.fused_attention_blocked_plain, A.blocked_seed_count(B, H)))
    results = {}
    for name, kernel, plain, n_seeds in pairs:
        for dtype in ("float32", "bfloat16"):
            q, k, v, bias = attention_inputs(torch, dtype, gen)
            seeds = torch.randint(0, 2 ** 31 - 1, (n_seeds,), generator=gen,
                                  device="cuda", dtype=torch.int32)
            out = kernel(q, k, v, bias, scale)
            torch.cuda.synchronize()
            ref = plain(q, k, v, bias, scale)
            err0 = (out.float() - ref.float()).abs().max().item()
            out_d = kernel(q, k, v, bias, scale, rate, seeds)
            ref_d = plain(q, k, v, bias, scale, rate, seeds)
            err_d = (out_d.float() - ref_d.float()).abs().max().item()
            # one-hot v windows reveal every dropped probability p[i, j]
            zeros_equal, dropped, total = True, 0, 0
            for c in (0, 64, 96):
                probe = torch.zeros_like(v)
                d_idx = torch.arange(D, device="cuda")
                probe[:, :, c + d_idx, d_idx] = 1
                zk = kernel(q, k, probe, bias, scale, rate, seeds) == 0
                zp = plain(q, k, probe, bias, scale, rate, seeds) == 0
                zeros_equal &= bool(torch.equal(zk, zp))
                kept = plain(q, k, probe, bias, scale) != 0
                dropped += int((zk & kept).sum())
                total += int(kept.sum())
            torch.cuda.synchronize()
            tol = TOL[dtype]
            ok = err0 <= tol and err_d <= tol and zeros_equal
            ms, host_ms = device_ms(lambda: kernel(q, k, v, bias, scale))
            plain_ms, _ = device_ms(lambda: plain(q, k, v, bias, scale))
            mask = bias.to(q.dtype)
            library_ms, _ = device_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, scale=scale))
            bound_ms, bound_by = attention_bound_ms(dtype)
            log("kernel %s %s: max_abs_err rate0=%.3g rate%.1f=%.3g (tol %g) "
                "zero_positions_equal=%s dropped_share=%.4f | ms=%.4f "
                "plain_ms=%.4f library_ms=%.4f bound_ms=%.4f (%s) "
                "wrapper_host_ms=%.4f"
                % (name, dtype, err0, rate, err_d, tol, zeros_equal,
                   dropped / max(total, 1), ms, plain_ms, library_ms,
                   bound_ms, bound_by, host_ms))
            if not ok:
                fail("kernel %s %s disagrees with its plain version"
                     % (name, dtype))
            results[(name, dtype)] = dict(
                max_abs_err=max(err0, err_d), ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
    return results


class PassLog:
    """Collects the trainer's per-pass inference records (memes, seconds)."""

    def __init__(self):
        import logging

        self.passes = []
        parent = self

        class Handler(logging.Handler):
            def emit(self, record):
                if record.getMessage().startswith("inference pass"):
                    _, n, secs = record.args[:3]
                    parent.passes.append((int(n), float(secs)))

        self.handler = Handler(level=logging.INFO)
        logger = logging.getLogger("meme_challenge_tpu_torch.train")
        logger.setLevel(logging.INFO)
        logger.addHandler(self.handler)


def forward_breakdown(torch, model, batch, dtype: str) -> None:
    """Where one batch-16 forward's time goes (informational, after the
    counted runs): device ms (queue-filled events) against the host's ms to
    issue it, and the device time by operator from torch.profiler."""
    def forward():
        with torch.inference_mode():
            model(batch)

    # one forward queues ~700 launches: more than one would overflow the
    # launch queue during the sleep and let the host's pace back in
    dev, host = device_ms(forward, iters=1, reps=5)
    log("breakdown %s: one batch-16 forward: device %.3f ms, host issue "
        "%.3f ms -> %s-bound; device-bound rate %.1f memes/s"
        % (dtype, dev, host, "host" if host > dev else "device",
           16 / dev * 1e3))
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        n = 3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                forward()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / n
        rows = []
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                t = getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
                rows.append((t / n / 1e3, e.key))
        rows.sort(reverse=True)
        busy = sum(t for t, _ in rows)
        log("breakdown %s: profiled forward: wall %.3f ms, kernels %.3f ms, "
            "device idle share %.3f; top kernels (ms): %s"
            % (dtype, wall, busy, 1.0 - busy / wall,
               "; ".join("%s %.3f" % (k[:40], t) for t, k in rows[:6])))
    except Exception as e:  # informational: a missing trace fails nothing
        log("breakdown %s: profiler unavailable (%s)" % (dtype, e))


def _n_lines(path: str) -> int:
    with open(path) as f:
        return sum(1 for line in f if line.strip())


def slice_phase(torch, work: str) -> dict:
    """Full-width UNITER-base inference through the port's CLI; returns
    the launches of each (kernel, dtype) run."""
    from meme_challenge_tpu_torch.core.config import UniterConfig
    from meme_challenge_tpu_torch.core.seeding import torch_generator
    from meme_challenge_tpu_torch.data.meme_dataset import MemeDataset
    from meme_challenge_tpu_torch.data.tokenizer import BertTokenizer
    from meme_challenge_tpu_torch.models.uniter import init_meme_uniter
    from meme_challenge_tpu_torch.ops import attention as A
    from meme_challenge_tpu_torch.train import train_uniter
    from meme_challenge_tpu_torch.train.checkpoint import ModelSaver
    from meme_challenge_tpu_torch.train.steps import to_device
    from meme_challenge_tpu_torch.utils.synthetic import make_synthetic_dataset

    t0 = time.time()
    synth = make_synthetic_dataset(os.path.join(work, "data"), n_train=16,
                                   n_dev=40, n_test=36, img_dim=2048,
                                   max_boxes=100, seed=0)
    log("slice: synthetic dataset (img_dim 2048, up to 100 boxes) in %.1f s"
        % (time.time() - t0))
    batch_size, layers = 16, UniterConfig().num_hidden_layers
    names = ("dev_seen", "test_seen", "test_unseen", "dev_seen", "dev_unseen")
    n_batches = sum(-(-_n_lines(synth[n]) // batch_size) for n in names)
    n_memes = sum(_n_lines(synth[n]) for n in names)

    ckpt_name = "uniter_base.ckpt"
    base_ckpt = os.path.join(work, ckpt_name)
    fused = UniterConfig(use_pallas_attention=True)
    model = init_meme_uniter(fused, 1, "cuda", torch_generator(0, "cuda"))
    ModelSaver(base_ckpt).save(model)
    log("slice: UNITER-base MemeUniter (%.1f M parameters) saved"
        % (sum(p.numel() for p in model.parameters()) / 1e6))

    passlog = PassLog()
    runs = (("fused_attention", "float32", False),
            ("fused_attention", "bfloat16", False),
            ("fused_attention_blocked", "float32", True),
            ("fused_attention_blocked", "bfloat16", True))
    launches = {}
    for name, dtype, blocked in runs:
        run_dir = os.path.join(work, "%s_%s" % (name, dtype))
        os.makedirs(run_dir)
        os.link(base_ckpt, os.path.join(run_dir, ckpt_name))
        cfg_path = os.path.join(run_dir, "uniter.json")
        with open(cfg_path, "w") as f:
            json.dump(UniterConfig(use_pallas_attention=True,
                                   pallas_blocked=blocked).to_dict(), f)
        argv = ["--data_path", synth["root"],
                "--feature_path", synth["feature_dir"],
                "--vocab_file", synth["vocab"], "--model_path", run_dir,
                "--model_save_name", ckpt_name, "--max_epoch", "0",
                "--num_folds", "0", "--batch_size", str(batch_size),
                "--uniter_config", cfg_path]
        if dtype == "bfloat16":
            argv.append("--compute_bf16")
        passlog.passes.clear()
        for key in A.LAUNCHES:
            A.LAUNCHES[key] = 0
        t0 = time.time()
        train_uniter.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = dict(A.LAUNCHES)
        launches[(name, dtype)] = counts[name]
        expected = layers * n_batches
        others = sum(v for k, v in counts.items() if k != name)
        memes = sum(n for n, _ in passlog.passes)
        secs = sum(s for _, s in passlog.passes)
        warm = passlog.passes[1:]
        log("slice %s %s: CLI %.1f s, launches %d (expected %d = %d layers x "
            "%d eval batches), inference %d memes in %.4f s = %.1f memes/s "
            "(after the first pass: %.1f memes/s)"
            % (name, dtype, wall, counts[name], expected, layers, n_batches,
               memes, secs, memes / secs,
               sum(n for n, _ in warm) / sum(s for _, s in warm)))
        if counts[name] != expected or others != 0:
            fail("launch counts %s, expected %d of %s only"
                 % (counts, expected, name))
        if memes != n_memes:
            fail("inference passes covered %d memes, expected %d"
                 % (memes, n_memes))
        base = ckpt_name.rsplit(".", 1)[0]
        for ds in ("dev_seen", "dev_unseen", "test_seen", "test_unseen"):
            path = os.path.join(run_dir, "%s_%s_preds.csv" % (base, ds))
            if not os.path.isfile(path):
                fail("missing " + path)
            with open(path) as f:
                rows = [r.split(",") for r in f.read().split("\n")[1:] if r]
            probs = [float(r[1]) for r in rows]
            if len(rows) != _n_lines(synth[ds]) or not all(
                    0.0 <= p <= 1.0 for p in probs):
                fail("bad predictions in " + path)
        with open(os.path.join(run_dir, base + "_metrics.json")) as f:
            metrics = json.load(f)
        if set(metrics) != {"dev", "train", "test"} or set(
                metrics["test"]) != {"dev_seen", "dev_unseen", "test_seen",
                                     "test_unseen"}:
            fail("unexpected metrics JSON: %s" % sorted(metrics))
        log("slice %s %s: 4 CSVs + metrics JSON, dev_seen AUROC %.4f"
            % (name, dtype, metrics["test"]["dev_seen"]["aucroc"]))

    # one batch's float32 logits: card (kernel) against CPU (plain version)
    ds = MemeDataset(synth["dev_seen"], feature_dir=synth["feature_dir"],
                     tokenizer=BertTokenizer(synth["vocab"]), max_txt_len=60,
                     max_bb=100, img_dim=2048)
    batch = ds.batch(list(range(batch_size)))
    logits = {}
    for device in ("cuda", "cpu"):
        m = init_meme_uniter(fused, 1, device, torch_generator(1, device))
        ModelSaver(base_ckpt).load(m)
        with torch.inference_mode():
            logits[device] = m(to_device(batch, device)).float().cpu()
        if device == "cuda":
            forward_breakdown(torch, m, to_device(batch, device), "float32")
            m_bf16 = init_meme_uniter(fused.replace(dtype="bfloat16"), 1,
                                      device, torch_generator(1, device))
            ModelSaver(base_ckpt).load(m_bf16)
            forward_breakdown(torch, m_bf16, to_device(batch, device),
                              "bfloat16")
            del m_bf16
        del m
    err = (logits["cuda"] - logits["cpu"]).abs().max().item()
    log("slice: float32 logits of one batch of %d, card vs CPU: max_abs_err "
        "%.3g (tol %g), finite=%s" % (batch_size, err, LOGIT_TOL,
                                     bool(torch.isfinite(logits["cuda"]).all())))
    if not (err <= LOGIT_TOL and torch.isfinite(logits["cuda"]).all()):
        fail("card logits disagree with the CPU's")
    return launches


def main(argv) -> None:
    if not os.path.isdir(PACKAGE):
        fail("meme_challenge_tpu_torch/ not found beside chip_smoke.py: run "
             "from a checkout of the repository")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail("nvidia-smi failed: " + smi.stderr.strip())
    card = smi.stdout.strip().splitlines()[0]
    log("card: " + card)
    log("torch %s, CUDA %s, python %s" % (torch.__version__,
                                         torch.version.cuda,
                                         sys.version.split()[0]))

    from meme_challenge_tpu_torch.ops import cuda_build

    t0 = time.time()
    secs = cuda_build.build()
    log("build: %.1f s total, %s" % (time.time() - t0, json.dumps(
        {k: round(v, 1) for k, v in secs.items()})))
    for name in cuda_build.LIBRARIES:
        for line in cuda_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log("ptxas %s: %s" % (name, line.strip()))

    kernels = kernel_phase(torch)
    if "--kernels-only" in argv:
        return
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(
            dir=os.path.join(ROOT, "build"), prefix="chip_smoke_") as work:
        launches = slice_phase(torch, work)

    entries = []
    for (name, dtype), r in kernels.items():
        entries.append({
            "name": "%s[%s]" % (name, dtype), "route": "cuda",
            "source": SOURCE, "replaces": REPLACES[name],
            "launches": launches[(name, dtype)],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
