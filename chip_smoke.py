"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. build: compile every kernel under multi_modal_transformers_tokenmerge_torch/csrc
   with nvcc for sm_90a;
2. kernels: hold each kernel against its plain PyTorch version on the card
   at octo_base shapes, and time both with CUDA events;
3. serving: the full-width octo_base policy in bfloat16 (random weights
   from a seed) served through PolicyEngine with a cached instruction, at
   batch 1 and batch 8, counting every kernel launch of that run;
4. reference: octo_base in float32, CUDA (kernels) against CPU (plain
   versions) on the same weights, inputs and noise;
5. profile: device time by kernel over a few batch-1 requests.

Prints the card's name and power limit, a JSON ``kernels`` line, and as its
last line ``{"ok": true, "device": {...}}``.  Exits non-zero without a
result when no CUDA device is present.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# bytes / FLOP rates of one H100 SXM (NVIDIA data sheet), for bound_ms
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}
# kernel vs plain in float32: |kernel - plain| <= F32_TOL * (1 + |plain|);
# the kernel sums its 768-wide products in another order than cuBLAS
F32_TOL = 1e-4
# kernel vs plain in bfloat16 / float16: |kernel - plain| <= LOW_ULPS *
# eps(dtype) * (1 + |plain|).  Where the two float32 sums straddle a rounding
# boundary of the compute dtype they round one unit apart and the loop
# carries that on; the largest seen at octo_base on an H100 (700 W) is
# 0.34 eps in bf16 (B=37, DDIM raw) and 0.54 eps in fp16 (B=8, DDIM raw).
# A rounding point moved off the JAX one shifts every element.
LOW_ULPS = 2.0
E2E_F32_TOL = 1e-3      # octo_base CUDA vs CPU, float32 (see phase 4)
SERVE_REQUESTS = 300    # per batch size, after two warm-up requests
OUT_DIR = "chiprun_out"


def log(*a):
    print(*a, flush=True)


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


def card_line():
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        if r.returncode == 0 and r.stdout.strip():
            return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return f"{torch.cuda.get_device_name(0)}, power limit not measured"


def time_ms(fn, iters=30, warmup=5):
    """Median milliseconds of ``fn`` over ``iters`` CUDA-event timed runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def device_ms(fn, kernel_name, iters=20, warmup=3):
    """Mean device time (ms) of the kernels named ``kernel_name`` per call
    of ``fn``, from the profiler: the kernel alone, without the host time
    of its wrapper."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if kernel_name in e.key)
    if total <= 0:
        fail(f"the profiler saw no {kernel_name} kernel")
    return total / 1e3 / iters


# -- phase 2: the sampler kernel ---------------------------------------------

def sampler_inputs(head, batch, steps, dtype, seed):
    """Random sampler inputs at the head's widths, on its device."""
    g = torch.Generator(device=head.alphas.device).manual_seed(seed)
    d = head.denoiser
    dev = head.alphas.device
    a, h = d.first_out.weight.shape
    r = lambda *s: torch.randn(*s, generator=g, device=dev)
    return dict(noisy=r(batch, a), contexts=r(steps, batch, h).to(dtype),
                noise=r(steps, batch, a),
                wn=(r(h, a) * (2.0 / a) ** 0.5), bn=r(h) * 1e-2,
                wo=(r(a, h) * (2.0 / h) ** 0.5), bo=r(a) * 1e-2)


def run_sampler(fn, x, coeffs, clip, mode, dtype=None):
    """``fn`` on ``x``; ``dtype`` casts the contexts (the compute dtype;
    the sampler casts the weights to it)."""
    ctx = x["contexts"] if dtype is None else x["contexts"].to(dtype)
    ddim = mode != "ddpm"
    return fn(x["noisy"], ctx, None if ddim else x["noise"], coeffs,
              x["wn"], x["bn"], x["wo"], x["bo"], clip_value=clip,
              ddim_x0clip=ddim, ddim_eps_recompute=mode == "ddim_recompute")


def sampler_bound_ms(batch, steps, hidden, adim, dtype, mode):
    e = torch.tensor([], dtype=dtype).element_size()
    ncoef = 3 if mode == "ddpm" else 4
    nbytes = (batch * adim * 4 + steps * batch * hidden * e
              + (steps * batch * adim * 4 if mode == "ddpm" else 0)
              + steps * ncoef * 4 + 2 * hidden * adim * e + (hidden + adim) * e
              + batch * adim * 4)
    flops = steps * batch * 4 * hidden * adim
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def kernel_phase(head):
    from multi_modal_transformers_tokenmerge_torch.ops.ddpm_sampler import (
        ddpm_sample_reference, ddpm_sampler)
    cfg = head.cfg
    clip = cfg.clip_value
    schedules = {"ddpm": head.schedule(None)[1],
                 "ddim_raw": head.schedule(8)[1],
                 "ddim_recompute": head.schedule(8)[1]}
    f32_err = 0.0
    low_err = {}
    for batch in (1, 8, 37):
        x = sampler_inputs(head, batch, cfg.diffusion_steps, torch.float32,
                           seed=batch)
        for mode, coeffs in schedules.items():
            xs = dict(x, contexts=x["contexts"][:coeffs.shape[0]],
                      noise=x["noise"][:coeffs.shape[0]])
            truth = run_sampler(ddpm_sample_reference, xs, coeffs, clip, mode)
            ker = run_sampler(ddpm_sampler, xs, coeffs, clip, mode)
            err = (ker - truth).abs().max().item()
            f32_err = max(f32_err, err)
            ok = bool(((ker - truth).abs() <= F32_TOL * (1 + truth.abs()))
                      .all()) and torch.isfinite(ker).all().item()
            log(f"  sampler f32  B={batch:2d} {mode:15s} |kernel-plain|="
                f"{err:.3e} (tol {F32_TOL:g} * (1 + |plain|)) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"sampler f32 B={batch} {mode}")
            for dt in (torch.bfloat16, torch.float16):
                name = str(dt).split(".")[-1]
                p16 = run_sampler(ddpm_sample_reference, xs, coeffs, clip,
                                  mode, dt)
                k16 = run_sampler(ddpm_sampler, xs, coeffs, clip, mode, dt)
                e_plain = (p16 - truth).abs().max().item()
                e_ker = (k16 - truth).abs().max().item()
                diff = (k16 - p16).abs().max().item()
                eps = torch.finfo(dt).eps
                ulps = ((k16 - p16).abs() / (eps * (1 + p16.abs()))).max()\
                    .item()
                low_err[name] = max(low_err.get(name, 0.0), ulps)
                ok = (e_ker <= 3.0 * e_plain + 0.05 and ulps <= LOW_ULPS
                      and torch.isfinite(k16).all().item())
                log(f"  sampler {name:8s} B={batch:2d} {mode:15s} vs f32 "
                    f"truth: kernel {e_ker:.3e}, plain {e_plain:.3e} (rule: "
                    f"kernel <= 3*plain + 0.05); |kernel-plain|={diff:.3e} = "
                    f"{ulps:.3f} eps*(1+|plain|) (tol {LOW_ULPS:g}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"sampler {name} B={batch} {mode}")

    timings = {}
    for batch in (1, 8, 37):
        x = sampler_inputs(head, batch, cfg.diffusion_steps, torch.bfloat16,
                           seed=100 + batch)
        x.update({k: x[k].to(torch.bfloat16) for k in ("wn", "bn", "wo",
                                                       "bo")})
        coeffs = schedules["ddpm"]
        call = lambda: run_sampler(ddpm_sampler, x, coeffs, clip, "ddpm")
        call_ms = time_ms(call)
        ms = device_ms(call, "ddpm_sampler_kernel")
        plain = time_ms(lambda: run_sampler(ddpm_sample_reference, x, coeffs,
                                            clip, "ddpm"), iters=20)
        bound, by = sampler_bound_ms(batch, cfg.diffusion_steps,
                                     cfg.mlp_dim, cfg.action_space_dim,
                                     torch.bfloat16, "ddpm")
        timings[batch] = (ms, call_ms, plain, bound, by)
        log(f"  sampler bf16 DDPM T={cfg.diffusion_steps} B={batch:2d}: "
            f"kernel {ms:.4f} ms on the device ({call_ms:.4f} ms a wrapper "
            f"call, CUDA events), plain {plain:.4f} ms, bound {bound:.6f} "
            f"ms ({by}); no single PyTorch call computes this function")
    log(f"  largest |kernel-plain| / (eps*(1+|plain|)): {low_err}")
    return f32_err, timings


# -- phase 3: serving --------------------------------------------------------

def serve_phase(model, cfg, counters):
    from multi_modal_transformers_tokenmerge_torch.serve.policy import (
        PolicyEngine)
    g = np.random.default_rng(0)
    ids = g.integers(0, cfg.text.vocab_size, (cfg.text.max_length,))
    frames = cfg.num_observation_blocks
    clip = cfg.heads.diffusion.clip_value
    results = {}
    for name in counters:
        counters[name].launches = 0
    requests = 0
    for batch in (1, 8):
        n = SERVE_REQUESTS + 2
        eng = PolicyEngine(model, batch_size=batch, seed=1)
        eng.set_instruction(ids)
        times = []
        for _ in range(n):
            images = torch.from_numpy(g.integers(
                0, 256, (batch, frames, *cfg.images.image_size)).astype(
                    np.float32)).cuda()
            before = counters["ddpm_sampler"].launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            act = eng(images)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            requests += 1
            if counters["ddpm_sampler"].launches != before + 1:
                fail("a request did not launch the sampler kernel once")
            if tuple(act.shape) != (batch, cfg.heads.diffusion.
                                    action_space_dim):
                fail(f"action shape {tuple(act.shape)}")
            if not torch.isfinite(act).all() or act.abs().max() > clip:
                fail("action not finite or outside +-clip_value")
        steady = times[2:]
        med = statistics.median(steady)
        p90 = statistics.quantiles(steady, n=10)[-1]
        results[batch] = {"median_ms": med, "p90_ms": p90,
                          "requests": len(steady)}
        log(f"  serve octo_base bf16 B={batch}: {len(steady)} requests after "
            f"two warm-up ({times[0]:.1f}, {times[1]:.1f} ms): median "
            f"{med:.4f} ms/request, p90 {p90:.4f}, min {min(steady):.4f}, "
            f"max {max(steady):.4f}")
    launches = {k: c.launches for k, c in counters.items()}
    if launches["ddpm_sampler"] != requests:
        fail(f"sampler launches {launches['ddpm_sampler']} != "
             f"{requests} requests")
    return results, launches


# -- phase 4: float32 CUDA vs CPU ----------------------------------------------

def reference_phase(cfg32):
    from multi_modal_transformers_tokenmerge_torch.models.octo import Octo
    from multi_modal_transformers_tokenmerge_torch.ops.ddpm_sampler import (
        ddpm_sampler)
    gpu = Octo(cfg32, device="cuda", seed=3).eval()
    cpu = Octo(cfg32, device="cpu", seed=None).eval()
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    g = np.random.default_rng(5)
    b, frames = 2, cfg32.num_observation_blocks
    ids = torch.from_numpy(g.integers(0, cfg32.text.vocab_size,
                                      (b, cfg32.text.max_length)))
    images = torch.from_numpy(g.integers(
        0, 256, (b, frames, *cfg32.images.image_size)).astype(np.float32))
    a = cfg32.heads.diffusion.action_space_dim
    t = cfg32.heads.diffusion.diffusion_steps
    noisy = torch.from_numpy(g.normal(size=(b, a)).astype(np.float32))
    noise = torch.from_numpy(g.normal(size=(t, b, a)).astype(np.float32))
    with torch.inference_mode():
        before = ddpm_sampler.launches
        out_gpu = gpu.predict_diffusion_action(
            ids.cuda(), images.cuda(), noisy=noisy.cuda(),
            noise=noise.cuda()).cpu()
        if ddpm_sampler.launches != before + 1:
            fail("the float32 CUDA run did not launch the sampler kernel")
        out_cpu = cpu.predict_diffusion_action(ids, images, noisy=noisy,
                                               noise=noise)
    err = (out_gpu - out_cpu).abs().max().item()
    log(f"  octo_base f32 predict_diffusion_action B={b}: |cuda-cpu|="
        f"{err:.3e} (tol {E2E_F32_TOL:g}: cuDNN/cuBLAS sum in another order "
        f"than the CPU, and 32 sampling steps amplify it)")
    if not err <= E2E_F32_TOL:
        fail("float32 CUDA and CPU disagree")
    del gpu, cpu
    return err


# -- phase 5: profile ----------------------------------------------------------

def profile_phase(model, cfg, request_ms):
    from torch.profiler import ProfilerActivity, profile
    from multi_modal_transformers_tokenmerge_torch.serve.policy import (
        PolicyEngine)
    eng = PolicyEngine(model, batch_size=1, seed=2)
    eng.set_instruction(np.arange(cfg.text.max_length))
    images = torch.zeros(1, cfg.num_observation_blocks,
                         *cfg.images.image_size, device="cuda")
    for _ in range(3):
        eng(images)
    torch.cuda.synchronize()
    n = 5
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            eng(images)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    # device-side events only: host ops also report the time of the
    # kernels they launched
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e3 / n
    log(f"  profile octo_base bf16 B=1, {n} requests: device kernels "
        f"{busy:.4f} ms/request; against the unprofiled median of "
        f"{request_ms:.4f} ms/request the device idle share is "
        f"{max(0.0, 1 - busy / request_ms):.3f}; "
        f"{sum(e.count for e in events) / n:.0f} kernel launches per request "
        f"of {len(events)} kernel names "
        f"(wall under the profiler {wall / n:.3f} ms/request)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"    {e.self_device_time_total / 1e3 / n:8.4f} ms/request "
            f"x{e.count / n:5.1f}  {e.key[:90]}")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "profile_b1.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=60))


def main():
    if not torch.cuda.is_available():
        log("no CUDA device: chip_smoke.py runs on the card only")
        return 2
    from multi_modal_transformers_tokenmerge_torch import _build
    from multi_modal_transformers_tokenmerge_torch.models.octo import Octo
    from multi_modal_transformers_tokenmerge_torch.models.presets import (
        octo_base)
    from multi_modal_transformers_tokenmerge_torch.ops.ddpm_sampler import (
        ddpm_sampler)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    log("phase 1: build")
    t0 = time.perf_counter()
    for name in _build.sources():
        _build.load_library(name)
    log(f"  built {sorted(_build.sources())} in "
        f"{time.perf_counter() - t0:.1f} s")
    counters = {"ddpm_sampler": ddpm_sampler}
    replaces = {"ddpm_sampler": (
        "multi_modal_transformers_tokenmerge_tpu/ops/ddpm_sampler.py:51")}

    cfg = octo_base(dtype="bfloat16")
    t0 = time.perf_counter()
    model = Octo(cfg, device="cuda", seed=0).eval()
    log(f"octo_base bf16 built on the card in "
        f"{time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in model.parameters())} parameters)")

    log("phase 2: kernels")
    f32_err, timings = kernel_phase(model.diffusion_action_head)

    log("phase 3: serving")
    serve_ms, launches = serve_phase(model, cfg, counters)

    log("phase 4: reference")
    reference_phase(octo_base(dtype="float32"))

    log("phase 5: profile")
    profile_phase(model, cfg, serve_ms[1]["median_ms"])

    ms, call_ms, plain, bound, by = timings[1]
    kernels = [{
        "name": "ddpm_sampler", "route": "cuda",
        "source": "multi_modal_transformers_tokenmerge_torch/csrc/"
                  "ddpm_sampler.cu",
        "replaces": replaces["ddpm_sampler"],
        "launches": launches["ddpm_sampler"], "max_abs_err": f32_err,
        "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
        "library_ms": None, "call_ms": call_ms,
        "shape": "octo_base bf16 DDPM T=32 H=768 A=8 B=1",
    }]
    log(json.dumps({"serve_ms_per_request": serve_ms, "card": card}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
