"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. build: compile every kernel under multi_modal_transformers_tokenmerge_torch/csrc
   with nvcc for sm_90a, one nvcc per source, all at once; log the registers
   and spill stores of every flash forward, dq and dk/dv instantiation (the
   whole report in chiprun_out/ptxas.txt) and fail if a bf16 or fp16 one
   spills;
2. kernels: hold each kernel against its plain PyTorch version on the card
   at the shapes of the main paths (the register sampler kernel at
   octo_base serving; the wide sampler kernel, forced, in three dtypes and
   all three modes at (T, H, A) = (32, 768, 28), (32, 3072, 8),
   (100, 768, 8), (16, 768, 1400) and octo_base_chunk28's (100, 3072, 28),
   B = 1, 8, 37 (and 64 at the last), at the register kernel's gates, a
   loop that misses them held step by step from the kernel's own state
   beside the plain version's own movement under permuted sums; forced at
   octo_base's shape also against the register kernel; the rule that picks
   a kernel against the register kernel's own limits; a row's result bit
   for bit alone, in batches of 8 and 37 and in a graph replay; the wide
   kernel timed at octo_base_chunk28 (DDPM 100 and DDIM 10 steps, B = 1,
   8, 64) and in turns with the register kernel at octo_base's shape; the
   flash forward/dq/dk-dv kernels at octo_base training, at the 1024-token
   layout of bench.py's bench_flash and at octo_deep's three stages at its
   training batch, in three dtypes, with dropout 0 and 0.1, attention_delta
   timed beside dq and dk/dv; the three training kernels with a batch
   offset b0 (a data-parallel rank's first global row) in float32, bf16
   and bf16 with float32 outputs: b0=0 bit for bit with no offset, the
   offset launch bit for bit with those rows of the whole batch's and
   against its plain version, each timed with b0 beside b0=0; the same at
   head dims 128 (octo_deep_h128's three stages, B=32, 6 heads), 32 (B=32,
   24 heads) and 80 (B=8, 16 heads, which the wrapper runs zero-padded to
   128), with the head slices of P=2 (h0) in bf16 and with float32
   outputs bit for bit with the whole-head launch; the forward
   without LSE at octo_deep's three
   stages (serving batches 1 and 8, training batch 32), octo_deep_h128's
   (batches 1 and 8), head dims 32 and 80, octo_base_deep's
   first, the 1024-token layout and a mask with dead rows; the wide
   kernels (head dims above 256) at octo_deep_h512's stages and at D =
   320, 576, 768, 300 and 1152, the forwards' launch plan against its
   mirror and their cluster bit for bit (rows alone, a graph replay); what
   the padding costs at D=80 against D=128 (kernel and whole-call device
   times);
   the max-pool backward at octo_base training, bit for bit, on the layout
   the embedder hands it (x channels_last, g NCHW; checked again after
   phases 6 and 12), on NCHW and on channels_last, one call on the main
   path's layout running the kernel and no copy kernel), time kernel,
   plain version and the PyTorch library call computing the same function;
   the image tower's GroupNorm -> GELU pair (group_norm_gelu) at
   chunk28's B=1 and B=64 maps and octo_deep's B=8 map, bf16
   channels_last, both statistics scopes, against its plain version to a
   bf16 ulp of the normalised value, its training route's gradients at
   octo_base training's map against the plain chain's, each kernel timed
   at B=64 beside the plain chain, F.group_norm and the bytes bound (every
   replay profiled later counts the pair: one for each residual block a
   tower); and check that attention_impl='auto' takes the flash kernel at
   1024 tokens and not at 74;
3. serving: the full-width octo_base policy in bfloat16 (random weights
   from a seed) served through PolicyEngine with a cached instruction, at
   batch 1 and batch 8, counting every kernel launch of that run;
4. reference: octo_base in float32, CUDA (kernels) against CPU (plain
   versions) on the same weights, inputs and noise;
5. profile: device time by kernel over a few batch-1 requests;
6. training: octo_base in bfloat16 with attention_impl='flash' and
   pool_vjp='pallas', through make_optimizer, create_train_state and fit,
   at batch 32: ms per step and every kernel's launches per step;
7. training reference: one float32 training step, CUDA (kernels) against
   CPU (plain versions) on the same weights and draws: loss and gradients,
   and the same step in bfloat16 as a planted fault the limits must see;
8. training profile: device time by kernel and the idle share of a step;
9. ToMe serving: the full-width octo_deep policy in bfloat16 (12 blocks in 3
   stages of 224, 160 and 96 tokens, ToMe merging between them) with
   attention_impl='flash', flash_backward='xla', through PolicyEngine at
   batch 1 and batch 8: exactly 12 flash_fwd and 1 ddpm_sampler launches a
   request; the same model with compression_mode='none' is served in turns
   beside it, recorded only;
10. ToMe reference: octo_deep in float32, CUDA (kernels) against CPU (plain
    versions) on the same weights, inputs and noise, with every merge
    event's plan compared and its smallest score margin printed, and the
    same request in bfloat16 as the planted fault;
11. ToMe profile: device time by kernel over a few batch-1 requests;
12. ToMe training: octo_deep in bfloat16 at batch 32 through fit with the
    same pairing and pool_vjp='pallas' (12 flash_fwd launches a step), one
    float32 step CUDA against CPU, and the step's profile;
13. ToMe training as octo_deep's preset sets attention: flash_backward=
    'pallas' with attention dropout 0.1 (12 flash_fwd_lse, 12 flash_dq and
    12 flash_dkv launches a step), one 30-step fit window at batch 32 and
    its profile, logged beside phase 12;
14. octo_small in bfloat16 served with its continuous head (the embed text
    tower and the other head on the card);
15. compiled serving (after phase 5 for octo_base, after phase 11 for
    octo_deep beside its unmerged twin): PolicyEngine.compile at batch 1
    and 8, every replay equal to the eager call bit for bit (the same
    noise), latency eager and compiled in turns, and one profiled replay:
    its kernels (the sampler once a request, flash_fwd 12 times at
    octo_deep, read from the device records, as a replay makes no wrapper
    call), launches, device time and idle share;
16. compiled training (after phase 8 for octo_base, after phase 13 for
    octo_deep as its preset sets attention): make_train_step(jit=True)
    captured as a CUDA graph, equal to the eager step bit for bit after
    five steps from the same state, fit with each in turns, one profiled
    replay (flash_fwd_lse, flash_dq, flash_dkv and pool_bwd at 1, 1, 1, 1
    a step at octo_base and 12, 12, 12, 1 at octo_deep);
17. checkpoint on the card (after phase 16's octo_base), saves
    asynchronous: save at step 3 (its stall against the synchronous save's
    SYNC_SAVE_S), two more compiled steps while it is written, the time
    until it lands; a restore into a fresh state bit for bit with the
    state at step 3, two more compiled steps equal to the unbroken run's
    state after step 5;
18. configs and the CLI: ``python -m multi_modal_transformers_tokenmerge_torch
    info`` in a subprocess reports cuda and the card; load_config("octo_base",
    ["dtype=bfloat16"]) equals the preset, and builds the next phases' model;
19. PolicyServer around that model's compiled engine at batch 8 (diffusion
    head): the closed-loop service time of one client (100 requests), then
    open-loop Poisson arrivals of single uint8 observations at 0.3, 0.6 and
    0.9 of the batch capacity it gives (200 requests each, max_wait_ms=2),
    p50/p95/p99 and achieved requests/s; one profiled server batch (one
    ddpm_sampler launch); the server thread's replay equal to the main
    thread's bit for bit; the continuous head through the server against
    direct engine calls, and a two-instruction batch against the tokens
    path; an eager engine behind the server, its sampler launches counted;
20. the closed loop: ReachTask.rollout at batch 8 (up to 16 steps, 2 uint8
    frames of 280x280) through the compiled engine, ms per env step split
    into render and policy, the success rate printed (random weights);
21. octo_base bf16 with a three-block denoiser and GELU MLPs from
    load_config overrides: compiled serving at batch 1 and 8 (no sampler
    launch), float32 card against CPU (1e-3 on actions), one float32 train
    step against the CPU with its planted bfloat16 fault, and octo_deep's
    float32 attention probes against the CPU per stage;
22. the int8 and w8 serving towers (octo_base bf16, ``PolicyEngine(
    image_tower=m, text_tower=m)``): compiled serving at batch 1 and 8 as
    in phase 15; each tower against the bf16 tower (text embeddings within
    TEXT_REL_LIMIT, image-tower actions within the JAX tests' serving
    tolerance, text-tower actions reported against it); float32 card
    against CPU: the int8 products bit for bit at the towers' shapes, w8
    actions and int8 text embeddings each within its limit, the bf16 model
    the planted fault; the w8 towers in bf16 with their float32 products
    against the products upcast and, as the planted fault, rounded to
    bf16; each tower's device ms (image B=1/8/32, text B=1/8), the w8
    towers' beside their earlier reading, and the 28224x768 output dense as ``_int_mm`` against a bf16 matmul at
    50/400/1600 rows beside their bounds;
23. export: octo_base bf16's full and cached diffusion programs and
    octo_deep's cached one (``tokenmerge::flash_fwd`` and
    ``tokenmerge::ddpm_sampler`` in the graphs, launched through them),
    bytes, export and load seconds, the loaded programs and
    ``load_artifact`` against the eager calls on the same draws, bit for
    bit; a fresh process's first requests after ``load_artifact`` and after
    ``compile()``; the eager request through the custom ops against the
    bare wrappers, in turns;
24. the mixture-of-experts MLP: octo_base with ``mlp_type='moe'`` served
    compiled at batch 32 beside its dense twin (in turns), float32 against
    the CPU, one float32 train step (the balance loss in it) under
    TRAIN_REF_LIMITS, trained compiled at batch 32 (held against the eager
    step, then in turns with the dense twin); octo_deep with MoE at top_k=2
    served eagerly and trained compiled at batch 32 beside its dense twin;
25. ring attention (``parallel.ring_attention``) as a ring of P=4 shards of
    1024 tokens in one process (B=2, S=4096, H=12, D=64): the main path in
    bf16 (causal, forward and backward) with every count set to 0 before it
    and read after (16 launches each of flash_fwd_lse, flash_dq and
    flash_dkv, all with float32 outputs); in float32 and bf16, causal and a
    block-causal layout, the ring's output and dq/dk/dv against the
    whole-sequence flash_attention (rel_gate) and, in float32, against the
    plain whole-sequence attention at the JAX ring tests' tolerances; each
    float32-output kernel against its plain version on one ring step (a
    partly masked tile), its device time, bound and SDPA on the same tile;
    the ring, the whole-sequence kernels and SDPA timed at S=4096; the plain
    and the flash inner block timed at shards of 256-2048 tokens (the
    crossover 'auto' is set from);
26. distributed at world 1 on NCCL: ``initialize_multihost`` and
    ``make_mesh()``; three ``fit(mesh=)`` steps of octo_base bf16 (eager,
    captured, replayed) against ``fit()`` bit for bit, then both in turns
    for their step times; ``fit(mesh=, accum_steps=2)`` against
    ``fit(accum_steps=2)`` bit for bit; ``PolicyEngine(mesh=)`` eager, compiled and cached
    against the un-meshed engine bit for bit; ``ring_attention`` over the
    NCCL group at P=1 against ``flash_attention`` bit for bit;
27. the legacy families in float32, card against CPU within E2E_F32_TOL of
    the largest |output|: PointCloudTransformer at its default configuration
    on 8 clouds of 1024 points, GatoConceptLearner, SingleImageConceptLearner
    and ConceptPlanner's generation (its tokens equal) at
    ConceptLearnerConfig's defaults, each timed on the card;
28. rematerialization (``transformer.remat``) on octo_deep bf16 at batch
    32 as its preset sets attention: remat off and on, eager and captured,
    with the counts set to 0 before each and read after (remat: 24
    flash_fwd_lse, 12 flash_dq and 12 flash_dkv a step), peak memory above
    the state and ms a step in turns; the captured remat step within
    GRAPH_TRAIN_TOL of the eager one; a float32 step of the per-layer
    cadence whose every recompute merges as its forward did; one float32
    remat step against the CPU under TRAIN_REF_LIMITS;
29. the port's drives as subprocesses: ``python -m
    multi_modal_transformers_tokenmerge_torch.examples.train_octo`` on
    octo_deep bf16 at batch 32 (flash kernels, ``--remat``,
    ``--accum-steps 2``, ``--ckpt``, ``--recordio``) stopped by a SIGTERM
    (a last checkpoint, ``final:``, exit code 0), then ``--resume`` (both
    ``resumed ...`` lines); ``examples.serve_octo`` on octo_base bf16 at
    batch 8;
30. training on sharded parameters: the three training kernels on the
    head slices of a tensor-parallel attention (P = 2 and 4, rank k
    launching heads [k H/P, (k+1) H/P) with h0 = k H/P and heads_total =
    H) at octo_deep's three training shapes (bf16, B=32, r=0.1) and the
    float32-output ring tile: each slice bit for bit with those heads of
    the whole-head launch and against its plain version, the device ms of
    rank 1 of 2 beside the same heads without the offset, in turns; then
    octo_deep bf16 at batch 32 as its preset sets attention, through
    ``shard_params(make_mesh() on NCCL at world 1, model_parallel=True,
    fsdp=True)`` and ``fit(mesh=)``, eager (every count set to 0 before
    it and read after: 12 flash_fwd_lse, 12 flash_dq, 12 flash_dkv and 1
    pool_bwd a step) and captured, each against ``fit()`` without a mesh
    (and the eager one against a second ``fit()``, the run-to-run spread),
    the captured steps timed in turns and one replay's launches counted;
31. octo_deep_h128: octo_deep with ``transformer.attention.num_heads=6``
    (6 heads of 128 over its 768 features) from ``load_config``, on the
    head dim 128 kernels: served in bf16 through PolicyEngine at batch 1
    and 8 (every count set to 0 before and read after: 12 flash_fwd and 1
    ddpm_sampler launches a request), compiled (replays bit for bit with
    the eager calls), float32 against the CPU under phase 10's limit;
    trained in bf16 at batch 32 through fit with dropout 0.1 in the kernels
    (12 flash_fwd_lse, 12 flash_dq, 12 flash_dkv and 1 pool_bwd a step),
    captured against the eager step, one float32 step against the CPU
    under TRAIN_REF_LIMITS;
32. octo_base_chunk28: octo_base with a 28-wide action chunk, a 3072-wide
    denoiser and 100 DDPM steps from ``load_config`` (its sampler runs on
    the wide kernel): served in bf16 through PolicyEngine at batch 1, 8
    and 64 with DDPM and with DDIM (10 steps), eager (every count set to 0
    before and read after: one wide and no register sampler launch a
    request) and compiled (replays bit for bit with the eager calls, one
    wide sampler kernel a replay), float32 against the CPU under
    E2E_F32_TOL;
33. octo_deep_h512: octo_deep with 3 heads of 512 from ``load_config`` on
    the wide flash kernels: served (12 flash_fwd_wide and 1 ddpm_sampler
    launches a request), compiled in turns with octo_deep's engine, float32
    against the CPU; trained at batch 32 (12 of each wide training kernel
    and 1 pool_bwd a step), captured against the eager step, one float32
    step under TRAIN_REF_LIMITS.
34. octo_moonlight's grouped expert kernels (csrc/grouped_experts.cu)
    against their plain version at its widths (2048 -> 1408, 64 experts,
    top 6) at B=8's three stage sizes (1792, 1280, 768 tokens) under
    uniform, skewed and single-expert routing, a second call bit for bit;
    each kernel timed at each size beside the plain version,
    torch._grouped_mm and the bytes bound; a compiled octo_moonlight of 4
    blocks (3 routed) at B=8 whose profiled replay runs each of the three
    kernels once a routed layer.

    python3 chip_smoke.py --only grouped_experts

runs phase 1 and phase 34 alone.

Each phase logs its seconds when it ends ("phase N: ... done in X s").
Prints the card's name and power limit, a JSON ``kernels`` line, and as its
last line ``{"ok": true, "device": {...}}``.  Exits non-zero without a
result when no CUDA device is present.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import time
import types

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
E2E_F32_TOL = 1e-3      # CUDA vs CPU, float32 (see phases 4 and 10)
SERVE_REQUESTS = 200    # per batch size, after two warm-up requests
# octo_deep and its unmerged baseline, per batch size: enough for a median,
# few enough to keep the whole run inside its time budget
DEEP_REQUESTS = 60
OUT_DIR = "chiprun_out"


_LOG_FILE = None    # main() opens OUT_DIR/chip_smoke.log: the whole output


def log(*a):
    print(*a, flush=True)
    if _LOG_FILE is not None:
        print(*a, file=_LOG_FILE, flush=True)


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


# the open phase's label and start, and every finished phase's seconds
_PHASE = {"label": None, "t0": 0.0, "seconds": []}


def phase(label):
    """Log ``label`` ("phase N: ...") as that phase begins, after a line
    with the seconds of the phase before it ("phase M: ... done in X s");
    ``phase(None)`` ends the last one."""
    now = time.perf_counter()
    if _PHASE["label"] is not None:
        secs = now - _PHASE["t0"]
        log(f"{_PHASE['label']} done in {secs:.1f} s")
        _PHASE["seconds"].append((_PHASE["label"], round(secs, 1)))
    _PHASE.update(label=label, t0=now)
    if label is not None:
        log(label)


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


# one session on the H100 lost 199 guard records and kept the rest
GUARD_LAUNCHES = 256
# sessions run again when they lost every guard record (one H100 machine
# lost three whole sessions in a row in phase 2)
PROFILE_ATTEMPTS = 5
# 'key': the guard kernel's name; 'lost': records lost, per session;
# 'retries': the index of every session that lost them all and was run
# again; 'short': (kernel, records kept, calls) of every device_ms session
# run again for keeping fewer than half of its kernel's records
_GUARD = {"lost": [], "retries": [], "short": []}


class _ProfileLost(Exception):
    """A profiler session kept none of its guard records."""


def guard_launches(x):
    """GUARD_LAUNCHES launches of a small kernel that nothing else here
    runs (erfinv, in place on ``x``)."""
    for _ in range(GUARD_LAUNCHES):
        x.erfinv_()


def device_events(prof):
    """The key-averaged device-side events of a session, guard excluded."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0 and e.key != _GUARD.get("key")]


@contextlib.contextmanager
def profiled(with_host=False):
    """A profiler session over the block, behind a guard.

    The profiler was seen to lose device records (torch 2.11, CUDA 12.8,
    one H100), the launches being all recorded: none in a young process,
    then more as the process ages (after one to two minutes the first 1 to
    10 kernels of a session, whatever their length and whatever idle time
    surrounds them; once in 48 sessions one later kernel instead), and on
    some machines a whole session's records early in a run.  So every
    session starts with GUARD_LAUNCHES launches of a kernel of its own,
    which take the loss and count it; a session that lost all of them
    raises _ProfileLost (profile_session runs it again).  A time read from
    a session is a mean over the records it kept, never a sum over the
    launches made.  The first session of the process learns the guard
    kernel's name."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA]
    if with_host:
        acts.insert(0, ProfilerActivity.CPU)
    if "x" not in _GUARD:
        _GUARD["x"] = torch.zeros(8, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        guard_launches(_GUARD["x"])
        torch.cuda.synchronize()
        yield prof
        torch.cuda.synchronize()
    if "key" not in _GUARD:
        names = [e.key for e in device_events(prof)]
        if len(names) != 1:
            fail(f"the guard session saw the kernels {names}")
        _GUARD["key"] = names[0]
    kept = sum(e.count for e in prof.key_averages()
               if e.key == _GUARD["key"])
    _GUARD["lost"].append(GUARD_LAUNCHES - kept)
    if kept == 0:
        raise _ProfileLost


def profile_session(body, with_host=False):
    """``body()`` in a ``profiled`` session: (the profiler, what body
    returned).  A session that lost every guard record is logged and run
    again, body included, up to PROFILE_ATTEMPTS times; then the run
    fails."""
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        try:
            with profiled(with_host) as prof:
                out = body()
            return prof, out
        except _ProfileLost:
            _GUARD["retries"].append(len(_GUARD["lost"]) - 1)
            log(f"  (the profiler lost all {GUARD_LAUNCHES} guard records of "
                f"a session, attempt {attempt} of {PROFILE_ATTEMPTS})")
    fail(f"the profiler lost every guard record in {PROFILE_ATTEMPTS} "
         f"sessions running")


def device_ms(fn, kernel_name, iters=20, warmup=3):
    """Mean device time (ms) of the kernels named ``kernel_name`` that one
    profiler session kept of ``iters`` calls of ``fn`` (one launch each):
    the kernel alone, without the host time of its wrapper.  A session that
    kept fewer than half of them is logged and run again, up to
    PROFILE_ATTEMPTS sessions (one session kept all 256 guard records and 2
    of 20 kernel records); then, or when a session kept more than
    ``iters``, the run fails and what the last session held is written to
    OUT_DIR/profile_miss.txt."""
    for _ in range(warmup):
        fn()
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        prof, _ = profile_session(lambda: [fn() for _ in range(iters)])
        hits = [e for e in device_events(prof) if kernel_name in e.key]
        total = sum(e.self_device_time_total for e in hits)
        kept = sum(e.count for e in hits)
        if iters / 2 <= kept <= iters:
            break
        if kept < iters / 2 and attempt < PROFILE_ATTEMPTS:
            _GUARD["short"].append((kernel_name, kept, iters))
            log(f"  (the profiler kept {kept} records of {kernel_name} from "
                f"{iters} calls, attempt {attempt} of {PROFILE_ATTEMPTS})")
            continue
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "profile_miss.txt"), "w") as f:
            f.write(prof.key_averages().table(row_limit=100))
            f.write("\n\nstart us, end us, name\n")
            for e in sorted(prof.events(), key=lambda e: e.time_range.start):
                f.write(f"{e.time_range.start:14.1f} {e.time_range.end:14.1f} "
                        f"{e.name[:60]}\n")
        fail(f"the profiler kept {kept} records of {kernel_name} from "
             f"{iters} calls")
    if kept < iters:
        log(f"  (the profiler kept {kept} of {iters} {kernel_name} records; "
            f"the mean is over those)")
    return total / 1e3 / kept


# -- phase 1: the build -------------------------------------------------------

FLASH_KINDS = ("flash_fwd", "flash_dq", "flash_dkv")


def ptxas_entries(report, kinds=FLASH_KINDS):
    """{kernel: (registers, spill store bytes)} of every entry of a
    ``-Xptxas -v`` report whose name holds one of ``kinds``, demangled by
    c++filt where the toolkit's host has it and shortened to the name and
    template arguments."""
    try:
        r = subprocess.run(["c++filt"], input=report, capture_output=True,
                           text=True, timeout=60)
        if r.returncode == 0 and r.stdout:
            report = r.stdout
    except (OSError, subprocess.TimeoutExpired):
        pass
    found, entry = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1).replace("void (anonymous namespace)::", "")\
                .split("(")[0]
            entry = entry if any(k in entry for k in kinds) else None
            if entry:
                found[entry] = [0, 0]
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            found[entry][1] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found[entry][0] = int(m.group(1))
    return {e: tuple(v) for e, v in found.items()}


def flash_ptxas(report, strict=True):
    """Registers and spill stores of every flash forward, dq and dk/dv
    instantiation in a flash library's ``-Xptxas -v`` report, logged;
    fails the run if the report lacks the 16-bit instantiations of any of
    the three, and, when ``strict`` (csrc/flash_attention.cu), if a bf16 or
    fp16 instantiation spills (csrc/flash_attention_wide.cu's spills are
    logged).  Returns {entry: (registers, spill store bytes)}."""
    found = ptxas_entries(report)
    sixteen = dict.fromkeys(FLASH_KINDS, 0)
    for entry, (regs, spill) in sorted(found.items()):
        is16 = "f32" not in entry and ("bfloat16" in entry or "__half" in
                                       entry)
        for k in FLASH_KINDS:
            sixteen[k] += is16 and k in entry
        flag = (" FAIL" if strict else " (spills)") if is16 and spill else ""
        log(f"  ptxas {entry}: {regs} registers, {spill} bytes spill "
            f"stores{flag}")
        if strict and is16 and spill:
            fail(f"{entry} spills {spill} bytes")
    missing = [k for k, n in sixteen.items() if not n]
    if missing:
        fail(f"no bf16 / fp16 {missing} in the ptxas report (a library found "
             f"built without its report beside it reports nothing: remove "
             f"its _build/)")
    return found


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


def bound(nbytes, flops, dtype):
    """The least time (ms) of moving ``nbytes`` and doing ``flops`` of
    ``dtype`` on the card, and which of the two sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def sampler_bound_ms(batch, steps, hidden, adim, dtype, mode):
    e = torch.tensor([], dtype=dtype).element_size()
    ncoef = 3 if mode == "ddpm" else 4
    nbytes = (batch * adim * 4 + steps * batch * hidden * e
              + (steps * batch * adim * 4 if mode == "ddpm" else 0)
              + steps * ncoef * 4 + 2 * hidden * adim * e + (hidden + adim) * e
              + batch * adim * 4)
    return bound(nbytes, steps * batch * 4 * hidden * adim, dtype)


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


# -- phase 2: the wide sampler kernel ------------------------------------------

# (T, H, A) the wide kernel is held at, each at B = 1, 8 and 37 (and 64 at
# octo_base_chunk28's): a 28-wide action chunk (Octo's 4 x 7), a 3072-wide
# denoiser, 100 steps in float32 (past one block's shared memory), ACT's
# 1400-wide chunk (100 x 14), octo_base_chunk28's sampler, and Octo's 7-dim
# action alone (A * 4 bytes of noise a row off 16: in DDPM the ring's
# stages are copied by every thread, not in bulk)
WIDE_SHAPES = ((32, 768, 28), (32, 3072, 8), (100, 768, 8), (16, 768, 1400),
               (100, 3072, 28), (32, 768, 7))
CHUNK28 = (100, 3072, 28)
WIDE_BATCHES = (1, 8, 37)
CHUNK28_BATCHES = (1, 8, 64)     # phase 32's serving batches
DDIM_STEPS = 10          # Diffusion Policy's serving steps (phase 32 too)
# sum orders the plain version is run in where a loop misses its gate
SPREAD_ORDERS = 8


def sampler_head(steps, hidden, adim):
    """A diffusion head of T steps, width H and action dim A on the card:
    its schedules and the shapes of its denoiser."""
    from multi_modal_transformers_tokenmerge_torch.core.config import (
        DiffusionHeadConfig)
    from multi_modal_transformers_tokenmerge_torch.heads.diffusion import (
        DiffusionActionHead)
    return DiffusionActionHead(DiffusionHeadConfig(
        diffusion_steps=steps, action_space_dim=adim, mlp_dim=hidden),
        hidden, device="cuda")


def gate_units(got, want, dtype):
    """max |got - want| in units of the gate: F32_TOL (1 + |want|) in
    float32, LOW_ULPS eps(dtype) (1 + |want|) in bf16 / fp16."""
    tol = (F32_TOL if dtype == torch.float32
           else LOW_ULPS * torch.finfo(dtype).eps)
    return ((got - want).abs() / (tol * (1 + want.abs()))).max().item()


def permuted(x, g):
    """The same sampler inputs with the hidden units and the actions in
    another order (the same function, other sum orders), and the
    permutation that puts the actions back."""
    h, a = x["wn"].shape
    p = torch.randperm(h, generator=g, device="cpu").cuda()
    q = torch.randperm(a, generator=g, device="cpu").cuda()
    y = dict(noisy=x["noisy"][:, q], contexts=x["contexts"][:, :, p],
             noise=x["noise"][:, :, q], wn=x["wn"][p][:, q], bn=x["bn"][p],
             wo=x["wo"][q][:, p], bo=x["bo"][q])
    return y, torch.argsort(q)


def exact_step(state, x, t, coeffs, clip, mode):
    """Step t of the sampler from ``state`` in float64, with no rounding to
    a compute dtype: the step the float32 versions approximate."""
    d = {k: v.double() for k, v in x.items()}
    s = state.double()
    h = torch.relu(s @ d["wn"].T + d["bn"] + d["contexts"][t])
    eps = h @ d["wo"].T + d["bo"]
    c = coeffs[t].double()
    if mode == "ddpm":
        nx = c[0] * (s - c[1] * eps) + c[2] * d["noise"][t]
    else:
        x0 = torch.clamp(c[0] * s - c[1] * eps, -clip, clip)
        if mode == "ddim_recompute":
            eps = (c[0] * s - x0) / c[1]
        nx = c[2] * x0 + c[3] * eps
    return torch.clamp(nx, -clip, clip)


def truth_rule(got, plain, truth, slack):
    """The kernel's error against ``truth`` over 3 x the plain version's +
    ``slack`` (<= 1 passes)."""
    e_ker = (got.double() - truth).abs().max().item()
    e_plain = (plain.double() - truth).abs().max().item()
    return e_ker / (3 * e_plain + slack)


def stepwise_units(x, coeffs, clip, mode, dt):
    """Each step of the wide kernel against one step of the plain version
    from the kernel's own state: the kernel's loop cut after t + 1 steps
    against the plain step from its loop cut after t (the first t steps of
    either loop are the same bit for bit).  Returns the largest gate units
    over the steps and the largest truth rule: in float32 against the
    exact (float64) step, slack F32_TOL; in bf16 / fp16 against the
    float32 plain step, slack 0.05."""
    from multi_modal_transformers_tokenmerge_torch.ops.ddpm_sampler import (
        ddpm_sample_reference, ddpm_sampler)
    worst, rule = 0.0, 0.0
    state = x["noisy"]
    for t in range(coeffs.shape[0]):
        cut = dict(x, contexts=x["contexts"][:t + 1],
                   noise=x["noise"][:t + 1])
        ker = run_sampler(lambda *a, **k: ddpm_sampler(*a, **k,
                                                       _variant="wide"),
                          cut, coeffs[:t + 1], clip, mode, dt)
        one = dict(x, noisy=state, contexts=x["contexts"][t:t + 1],
                   noise=x["noise"][t:t + 1])
        plain = run_sampler(ddpm_sample_reference, one, coeffs[t:t + 1],
                            clip, mode, dt)
        worst = max(worst, gate_units(ker, plain, dt))
        if dt == torch.float32:
            truth = exact_step(state, x, t, coeffs, clip, mode)
            rule = max(rule, truth_rule(ker, plain, truth, F32_TOL))
        else:
            truth = run_sampler(ddpm_sample_reference, one, coeffs[t:t + 1],
                                clip, mode, torch.float32).double()
            rule = max(rule, truth_rule(ker, plain, truth, 0.05))
        state = ker
    return worst, rule


def hold_wide(x, coeffs, clip, mode, label):
    """The wide kernel (forced) against the plain version on ``x`` in
    float32, bf16 and fp16 at the register kernel's gates: F32_TOL in
    float32; in bf16 / fp16 LOW_ULPS against the plain version in the same
    dtype, and the truth rule (the kernel's error against the float32 plain
    version within 3 x the plain version's + 0.05).  Where a whole loop
    misses the F32_TOL or LOW_ULPS gate, the loop amplifies the rounding of
    any sum order past it: the plain version is run in SPREAD_ORDERS other
    sum orders (hidden units and actions permuted) to show how far it moves
    itself, and the kernel is held step by step from its own state at the
    truth rule: against the exact (float64) step with slack F32_TOL in
    float32, against the float32 plain step with slack 0.05 in bf16 / fp16
    (the rule the whole loop must meet there too).  Returns {dtype: (loop units, spread units
    or None, step units or None, max |kernel - plain|)}."""
    from multi_modal_transformers_tokenmerge_torch.ops.ddpm_sampler import (
        ddpm_sample_reference, ddpm_sampler)
    wide = lambda *a, **k: ddpm_sampler(*a, **k, _variant="wide")
    truth = run_sampler(ddpm_sample_reference, x, coeffs, clip, mode)
    out = {}
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        name = str(dt).split(".")[-1]
        low = dt != torch.float32
        before = ddpm_sampler.by_variant["wide"].launches
        ker = run_sampler(wide, x, coeffs, clip, mode, dt)
        if ddpm_sampler.by_variant["wide"].launches != before + 1:
            fail(f"{label} {name}: the wide kernel was not launched")
        plain = (run_sampler(ddpm_sample_reference, x, coeffs, clip, mode,
                             dt) if low else truth)
        units = gate_units(ker, plain, dt)
        rule = truth_rule(ker, plain, truth.double(), 0.05) if low else 0.0
        if not (torch.isfinite(ker).all() and rule <= 1):
            fail(f"{label} {name}: not finite, or the truth rule at "
                 f"{rule:.3f} (limit 1)")
        spread = steps = None
        if units <= 1:
            verdict = "within the gate"
        else:
            g = torch.Generator().manual_seed(len(label))
            spread = 0.0
            for _ in range(SPREAD_ORDERS):
                y, back = permuted(x, g)
                other = run_sampler(ddpm_sample_reference, y, coeffs, clip,
                                    mode, dt)[:, back]
                spread = max(spread, gate_units(other, plain, dt))
            step_units, steps = stepwise_units(x, coeffs, clip, mode, dt)
            verdict = (f"loop past the gate, the plain version moves "
                       f"{spread:.3f} gates under permuted sums; every step "
                       f"within the truth rule ({steps:.3f}; "
                       f"{step_units:.3f} gates)")
            if not steps <= 1:
                fail(f"{label} {name}: loop {units:.3f} gates, plain under "
                     f"permuted sums {spread:.3f}, steps {step_units:.3f} "
                     f"gates, truth rule {steps:.3f}")
        log(f"  wide {label} {name:8s}: |kernel-plain| {units:.3f} gates"
            + (f", truth rule {rule:.3f}" if low else "") + f": {verdict}")
        out[name] = (units, spread, steps, (ker - plain).abs().max().item())
    return out


def wide_kernel_phase(register_head):
    """The wide sampler kernel at every shape of WIDE_SHAPES, forced at
    octo_base's against the register kernel too, the rule that picks a
    kernel against the register kernel's own limits, a row's result
    against its batch and a graph replay, and the wide kernel's times at
    octo_base_chunk28's sampler (bf16, DDPM T=100 and DDIM 10, B = 1, 8,
    64) and at octo_base's beside the register kernel."""
    from multi_modal_transformers_tokenmerge_torch.ops import (
        ddpm_sampler as tds)
    from multi_modal_transformers_tokenmerge_torch.ops.ddpm_sampler import (
        ddpm_sample_reference, ddpm_sampler)
    lib = tds._library("ddpm_sampler")
    for a in range(1, tds.REGISTER_MAX_ACTION_DIM + 1):
        if lib.ddpm_sampler_max_hidden(a) != tds.register_max_hidden(a):
            fail(f"register_max_hidden({a}) disagrees with the kernel's")
        for t, h, e in ((1, 1, 2), (32, 768, 2), (74, 768, 4), (75, 768, 4),
                        (100, 1536, 2), (7, 200, 4)):
            if (lib.ddpm_sampler_smem_bytes(t, h, a, e)
                    != tds.register_smem_bytes(t, h, a, e)):
                fail(f"register_smem_bytes({t}, {h}, {a}, {e}) disagrees "
                     f"with the kernel's")
    # the wide kernel's plan against its mirror at every shape held below
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    wlib = tds._library("ddpm_sampler_wide")
    plans = [tds.wide_plan(wlib, t, batch, h, a, elem, mode, sms)
             for t, h, a in WIDE_SHAPES for batch in WIDE_BATCHES + (64,)
             for elem, mode in ((4, 0), (2, 0), (2, 1))]
    mirror = [tds.wide_sampler_plan(t, batch, h, a, elem, mode, sms)
              for t, h, a in WIDE_SHAPES for batch in WIDE_BATCHES + (64,)
              for elem, mode in ((4, 0), (2, 0), (2, 1))]
    for got, want in zip(plans, mirror):
        if got != want:
            fail(f"wide_sampler_plan gives {want}, the kernel's plan {got}")
    log(f"  wide sampler plans, C = Python at {len(plans)} shapes; st.async "
        f"exchange at {sum(q['expect_bytes'] > 0 for q in plans)}, "
        f"everything in shared memory at "
        f"{sum(q['flags'] == 63 for q in plans)}, bulk ring copies at "
        f"{sum(q['bulk'] for q in plans)}")
    clip = register_head.cfg.clip_value
    held = {}
    for t, h, a in WIDE_SHAPES:
        head = sampler_head(t, h, a)
        schedules = {"ddpm": head.schedule(None)[1],
                     "ddim_raw": head.schedule(DDIM_STEPS)[1],
                     "ddim_recompute": head.schedule(DDIM_STEPS)[1]}
        batches = WIDE_BATCHES + ((64,) if (t, h, a) == CHUNK28 else ())
        for batch in batches:
            x = sampler_inputs(head, batch, t, torch.float32, seed=batch)
            for mode, coeffs in schedules.items():
                xs = dict(x, contexts=x["contexts"][:coeffs.shape[0]],
                          noise=x["noise"][:coeffs.shape[0]])
                label = f"T={t} H={h} A={a} B={batch} {mode}"
                held[label] = hold_wide(xs, coeffs, clip, mode, label)
        del head

    # forced at octo_base's shape: against the register kernel too
    schedules = {"ddpm": register_head.schedule(None)[1],
                 "ddim_raw": register_head.schedule(8)[1],
                 "ddim_recompute": register_head.schedule(8)[1]}
    steps = register_head.cfg.diffusion_steps
    against_register = {}
    for batch in WIDE_BATCHES:
        x = sampler_inputs(register_head, batch, steps, torch.float32,
                           seed=batch)
        for mode, coeffs in schedules.items():
            xs = dict(x, contexts=x["contexts"][:coeffs.shape[0]],
                      noise=x["noise"][:coeffs.shape[0]])
            label = f"octo_base T={steps} H=768 A=8 B={batch} {mode}"
            held[label] = hold_wide(xs, coeffs, clip, mode, label)
            for dt in (torch.float32, torch.bfloat16, torch.float16):
                got = {v: run_sampler(
                    lambda *a, **k: ddpm_sampler(*a, **k, _variant=v), xs,
                    coeffs, clip, mode, dt) for v in ("wide", "register")}
                units = gate_units(got["wide"], got["register"], dt)
                against_register[f"{label} {dt}"] = units
                if not units <= 1:
                    fail(f"{label} {dt}: the wide kernel is {units:.3f} "
                         f"gates from the register kernel")
    log(f"  wide against register at octo_base's shape: largest "
        f"{max(against_register.values()):.3f} gates")

    # a row's result does not depend on the batch, its blocking or a replay
    head = sampler_head(*CHUNK28)
    coeffs = head.schedule(None)[1]
    x = sampler_inputs(head, 37, CHUNK28[0], torch.bfloat16, seed=9)
    call = lambda y: run_sampler(ddpm_sampler, y, coeffs, clip, "ddpm")
    whole = call(x)
    for b in (1, 8):
        part = call(dict(x, noisy=x["noisy"][:b],
                         contexts=x["contexts"][:, :b],
                         noise=x["noise"][:, :b]))
        if not torch.equal(part, whole[:b]):
            fail(f"the wide kernel's first {b} rows differ alone and in a "
                 f"batch of 37")
    static = call(x)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = call(x)
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(static, whole):
        fail("the wide kernel's graph replay differs from its eager call")
    log("  wide kernel at octo_base_chunk28 bf16: rows 0-7 alone, in a batch "
        "of 8 and of 37 and in a graph replay bit for bit")
    unaligned = unaligned_ring_check(head, clip)

    timings = {}
    for mode, coeffs in (("ddpm", head.schedule(None)[1]),
                         ("ddim_raw", head.schedule(DDIM_STEPS)[1])):
        t = coeffs.shape[0]
        for batch in CHUNK28_BATCHES:
            x = sampler_inputs(head, batch, t, torch.bfloat16,
                               seed=200 + batch)
            x.update({k: x[k].to(torch.bfloat16) for k in ("wn", "bn", "wo",
                                                           "bo")})
            call = lambda: run_sampler(ddpm_sampler, x, coeffs, clip, mode)
            call_ms = time_ms(call)
            ms = device_ms(call, "ddpm_sampler_wide_kernel")
            plain = time_ms(lambda: run_sampler(ddpm_sample_reference, x,
                                                coeffs, clip, mode), iters=10)
            bnd, by = sampler_bound_ms(batch, t, CHUNK28[1], CHUNK28[2],
                                       torch.bfloat16, mode)
            plan = tds.wide_plan(wlib, t, batch, CHUNK28[1], CHUNK28[2], 2,
                                 1 if mode == "ddim_raw" else 0, sms)
            key = f"{'DDPM' if mode == 'ddpm' else 'DDIM'} T={t} B={batch}"
            timings[key] = dict(ms=ms, call_ms=call_ms, plain_ms=plain,
                                bound_ms=bnd, bound_by=by, plan=plan)
            log(f"  wide bf16 octo_base_chunk28 {key}: kernel {ms:.4f} ms "
                f"on the device ({call_ms:.4f} ms a wrapper call), plain "
                f"{plain:.4f} ms, bound {bnd:.6f} ms ({by}); plan {plan}")

    # the two kernels at octo_base's shape, in turns
    versus = {}
    for batch in WIDE_BATCHES:
        x = sampler_inputs(register_head, batch, steps, torch.bfloat16,
                           seed=100 + batch)
        x.update({k: x[k].to(torch.bfloat16) for k in ("wn", "bn", "wo",
                                                       "bo")})
        coeffs = register_head.schedule(None)[1]
        calls = {v: (lambda v=v: run_sampler(
            lambda *a, **k: ddpm_sampler(*a, **k, _variant=v), x, coeffs,
            clip, "ddpm")) for v in ("register", "wide")}
        row = {}
        for v in ("register", "wide", "wide", "register"):
            name = ("ddpm_sampler_kernel" if v == "register" else
                    "ddpm_sampler_wide_kernel")
            row.setdefault(v, []).append(device_ms(calls[v], name))
        versus[batch] = {v: sum(r) / len(r) for v, r in row.items()}
        log(f"  octo_base bf16 DDPM T={steps} B={batch}, in turns: register "
            f"{versus[batch]['register']:.4f} ms, wide (forced) "
            f"{versus[batch]['wide']:.4f} ms on the device")
    errors = {k: max(r[0] for r in v.values()) for k, v in held.items()}
    return dict(held=held, largest_loop_units=max(errors.values()),
                f32_max_abs_err=max(v["float32"][3] for v in held.values()),
                against_register=max(against_register.values()),
                unaligned=unaligned, timings=timings, versus_register=versus)


def off_by_one(t):
    """``t``'s values in a contiguous view at storage offset 1 of a buffer
    one element longer: its data one element (2 or 4 bytes) off 16."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def unaligned_ring_check(head, clip):
    """The wide kernel's ring copied by every thread (cp.async in 4-byte
    pieces, or element by element) where the contexts and the noise lie
    off 16 bytes, as views at storage offset 1: bit for bit with the same
    call on aligned copies (the bulk copies, which hold_wide held against
    the plain version), at octo_base_chunk28's shape, float32 and bf16,
    DDPM and DDIM, B = 1 and 8; the distance to the plain version is
    logged."""
    from multi_modal_transformers_tokenmerge_torch.ops.ddpm_sampler import (
        ddpm_sample_reference, ddpm_sampler)
    wide = lambda *a, **k: ddpm_sampler(*a, **k, _variant="wide")
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        for mode, coeffs in (("ddpm", head.schedule(None)[1]),
                             ("ddim_raw", head.schedule(DDIM_STEPS)[1])):
            t = coeffs.shape[0]
            for batch in (1, 8):
                x = sampler_inputs(head, batch, CHUNK28[0], torch.float32,
                                   seed=300 + batch)
                x = dict(x, contexts=x["contexts"][:t].to(dt).contiguous(),
                         noise=x["noise"][:t].contiguous())
                y = dict(x, contexts=off_by_one(x["contexts"]),
                         noise=off_by_one(x["noise"]))
                if not (y["contexts"].data_ptr() % 16
                        and y["noise"].data_ptr() % 16):
                    fail("off_by_one gave a 16-byte aligned view")
                before = ddpm_sampler.by_variant["wide"].launches
                aligned = run_sampler(wide, x, coeffs, clip, mode)
                got = run_sampler(wide, y, coeffs, clip, mode)
                if ddpm_sampler.by_variant["wide"].launches != before + 2:
                    fail("the unaligned ring check did not launch the wide "
                         "kernel twice")
                plain = run_sampler(ddpm_sample_reference, x, coeffs, clip,
                                    mode)
                units = gate_units(got, plain, dt)
                same = torch.equal(got, aligned)
                label = f"{str(dt)[6:]} {mode} B={batch}"
                out[label] = units
                log(f"  wide T={t} H={CHUNK28[1]} A={CHUNK28[2]} {label}, "
                    f"contexts and noise off 16 bytes (per-thread ring "
                    f"copies): == the aligned call bit for bit: {same}; "
                    f"{units:.3f} gates from the plain version")
                if not same:
                    fail(f"wide kernel with unaligned contexts {label}")
    return out


# -- phase 2b: flash attention and max-pool backward kernels -----------------

OCTO_SPEC = "[TaskDescriptionPrefix{16}] [Image{25};Readout{4}]*2"
# bench.py:1056 bench_flash, the long-context layout where 'auto' picks
# the flash kernels
LONG_SPEC = ("[TaskDescriptionPrefix{16}] "
             "[Image{100};Image{100};Image{100};Image{100};Image{100};"
             "Readout{4}]*2")
DEEP_SPEC = ("[TaskDescriptionPrefix{16}] [Image{100};Readout{4}]*2",
             "[TaskDescriptionPrefix{0}] [Image{32};Readout{0}]*2")
# the wide kernels (csrc/flash_attention_wide.cu): octo_deep_h512's three
# stages at its training batch (phase 33), head dim 320 (8 heads), 576 (4
# heads: sarvam-105b's latent head width), 768 (one head of octo_deep's
# width) and 300 (run padded to 320) at its first stage; the forwards'
# cluster body up to 1024, and 1152 (one head), where they keep their
# chunked body (ops/flash_attention.py:wide_forward_plan)
WIDE_FLASH_SHAPES = {
    **{f"deep_h512_S{s}": (32, DEEP_SPEC, stage, 3, 512)
       for stage, s in enumerate((224, 160, 96))},
    "d320_S224": (8, DEEP_SPEC, 0, 8, 320),
    "d576_S224": (8, DEEP_SPEC, 0, 4, 576),
    "d768_S224": (8, DEEP_SPEC, 0, 1, 768),
    "d300_S224": (8, DEEP_SPEC, 0, 8, 300),
    "d1152_S224": (8, DEEP_SPEC, 0, 1, 1152)}
# name -> (batch, layout strings, stage, heads, head_dim): octo_base
# training, the 1024-token layout, octo_deep's three stages at its training
# batch (its blocks under flash_backward='pallas'); the same three with 6
# heads of 128 (octo_deep_h128, phase 31), head dim 32 at octo_deep's first
# stage (24 heads over its 768 features) and head dim 80, which the kernels
# run zero-padded to 128 (16 heads of 80, 1280 features: ViT-H/14's heads)
FLASH_SHAPES = {"octo_base_train": (32, (OCTO_SPEC,), 0, 3, 256),
                "long_context": (8, (LONG_SPEC,), 0, 12, 64),
                **{f"octo_deep_S{s}": (32, DEEP_SPEC, stage, 12, 64)
                   for stage, s in enumerate((224, 160, 96))},
                **{f"deep_h128_S{s}": (32, DEEP_SPEC, stage, 6, 128)
                   for stage, s in enumerate((224, 160, 96))},
                "d32_S224": (32, DEEP_SPEC, 0, 24, 32),
                "d80_S224": (8, DEEP_SPEC, 0, 16, 80),
                **WIDE_FLASH_SHAPES}
# head dims whose head slices (h0) phase 2 holds at P = 2, in bf16 and with
# float32 outputs (phase 30 holds D = 64's at P = 2 and 4)
HEAD_SLICE_DIMS = (32, 80, 128, 512)
TRAIN_DROPOUT = 0.1     # the attention.dropout_rate of octo_base and octo_deep


def layout_mask(spec):
    return stage_mask((spec,), 0)


def stage_mask(strings, stage):
    from multi_modal_transformers_tokenmerge_torch.sequence.layout import (
        SequenceLayout)
    return SequenceLayout.from_strings(*strings).attention_mask(stage)


def rel_gate(got, want, dtype):
    """(ok, max |got - want|, max |got - want| / (1 + |want|) in units of
    the tolerance's scale) under the dtype's rule."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    scale = F32_TOL if dtype == torch.float32 else torch.finfo(dtype).eps
    units = (diff / (scale * (1 + want.abs()))).max().item()
    limit = 1.0 if dtype == torch.float32 else LOW_ULPS
    ok = bool(torch.isfinite(got).all()) and units <= limit
    return ok, diff.max().item(), units


def plain_of(fa, d):
    """The plain versions the flash kernels at head dim ``d`` are held
    against, under the names of ``ops.flash_attention``'s
    (``flash_fwd_reference``, ...): above 256 the wide kernels' plain
    versions (``flash_*_wide_reference``, cut as those kernels cut D)."""
    if not fa.is_wide(d):
        return fa
    return types.SimpleNamespace(**{
        f"{k}_reference": getattr(fa, f"{k}_wide_reference")
        for k in ("flash_fwd", "flash_fwd_lse", "flash_dq", "flash_dkv")})


def kernel_key(kernel, d):
    """The device records' name of a flash kernel at head dim ``d``: above
    256 the wide family's (csrc/flash_attention_wide.cu)."""
    return f"{kernel}{'_wide' if d > 256 else ''}_kernel"


def flash_bytes_flops(b, s, h, d, nnz, dtype, kind):
    """Least bytes and matmul FLOPs of one flash pass: each input read once,
    each output written once; 2 FLOPs per multiply-add over the live
    (query, key) pairs of the mask (``nnz`` per batch and head)."""
    e = torch.tensor([], dtype=dtype).element_size()
    act = b * s * h * d * e
    stats = b * h * s * 4
    tensors, nstats, products = {"fwd_plain": (4, 0, 2), "fwd": (4, 1, 2),
                                 "dq": (5, 2, 3), "dkv": (6, 2, 4)}[kind]
    nbytes = tensors * act + nstats * stats + s * s
    return nbytes, 2 * products * b * h * d * nnz


def device_total_ms(fn, iters=20, warmup=3):
    """Device time of every kernel that one call of ``fn`` runs (ms), and
    the names of the three longest: the yardstick of a library call.  Each
    kernel name counts with the mean of the records kept, times its
    launches a call (the records kept over ``iters``, rounded up)."""
    for _ in range(warmup):
        fn()
    prof, _ = profile_session(lambda: [fn() for _ in range(iters)])
    events = device_events(prof)
    total = sum(e.self_device_time_total / e.count * -(-e.count // iters)
                for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:3]
    return total, [e.key[:80] for e in top]


def flash_case(fa, mask, b, h, d, dtype, seed):
    s = mask.shape[0]
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(b, s, h, d, generator=g, device="cuda")
                   .to(dtype) for _ in range(4))
    bq, bk = fa.kernel_tiles(d)
    tables = fa.device_tables(mask, bq, bk, "cuda")
    return mask, (q, k, v, do), tables, (bq, bk)


def flash_check(fa, name, mask, b, h, d):
    """Every flash kernel against its plain version at one shape, in three
    dtypes, with dropout 0 and 0.1 on the same seed words."""
    seed = torch.tensor([0x1234567, 0x89ABCDE], dtype=torch.int64,
                        device="cuda")
    owner = {"out": "flash_fwd_lse", "dq": "flash_dq", "dk": "flash_dkv",
             "dv": "flash_dkv"}
    f32_err = dict.fromkeys(owner.values(), 0.0)
    ref = plain_of(fa, d)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        mask, qkvd, tables, tiles = flash_case(fa, mask, b, h, d, dtype,
                                               seed=7)
        q, k, v, do = qkvd
        padded, k_hi, q_lo = tables
        for rate in (0.0, TRAIN_DROPOUT):
            kw = dict(block_q=tiles[0], block_k=tiles[1], dropout_rate=rate)
            sw = seed if rate else None
            out_p, lse_p = ref.flash_fwd_lse_reference(q, k, v, padded, k_hi,
                                                      sw, **kw)
            out, lse = fa.flash_fwd_lse(q, k, v, padded, k_hi, sw, **kw)
            delta = fa.attention_delta(do, out_p, padded.shape[0])
            got = dict(out=out,
                       dq=fa.flash_dq(q, k, v, do, lse_p, delta, padded,
                                      k_hi, sw, **kw))
            got["dk"], got["dv"] = fa.flash_dkv(q, k, v, do, lse_p, delta,
                                                padded, q_lo, sw, **kw)
            torch.cuda.synchronize()
            want = dict(out=out_p,
                        dq=ref.flash_dq_reference(q, k, v, do, lse_p, delta,
                                                 padded, k_hi, sw, **kw))
            want["dk"], want["dv"] = ref.flash_dkv_reference(
                q, k, v, do, lse_p, delta, padded, q_lo, sw, **kw)
            parts = []
            ok_all = True
            for key in ("out", "dq", "dk", "dv"):
                ok, err, units = rel_gate(got[key], want[key], dtype)
                ok_all &= ok
                if dtype == torch.float32:
                    f32_err[owner[key]] = max(f32_err[owner[key]], err)
                parts.append(f"{key} {err:.2e} ({units:.3f})")
            lse_err = ((lse - lse_p).abs() / (1 + lse_p.abs())).max().item()
            ok_all &= lse_err <= 1e-5
            parts.append(f"lse rel {lse_err:.1e}")
            log(f"  flash {name:15s} {str(dtype)[6:]:8s} r={rate:.1f}: "
                f"|kernel-plain| {', '.join(parts)} "
                f"{'ok' if ok_all else 'FAIL'}")
            if not ok_all:
                fail(f"flash {name} {dtype} r={rate}")
    return f32_err


def flash_timings(fa, name, mask, b, h, d):
    """bf16 device times of the three kernels with the training dropout,
    their plain versions, the bounds and SDPA with the boolean mask; and of
    attention_delta's kernels, which the pair needs beside it: SDPA's
    backward computes its own delta."""
    import torch.nn.functional as F
    dtype = torch.bfloat16
    mask, (q, k, v, do), (padded, k_hi, q_lo), tiles = flash_case(
        fa, mask, b, h, d, dtype, seed=9)
    ref = plain_of(fa, d)
    seed = torch.tensor([5, 6], dtype=torch.int64, device="cuda")
    kw = dict(block_q=tiles[0], block_k=tiles[1], dropout_rate=TRAIN_DROPOUT)
    out, lse = fa.flash_fwd_lse(q, k, v, padded, k_hi, seed, **kw)
    delta = fa.attention_delta(do, out, padded.shape[0])
    calls = {
        "flash_fwd_lse": (lambda: fa.flash_fwd_lse(q, k, v, padded, k_hi,
                                                   seed, **kw),
                          lambda: ref.flash_fwd_lse_reference(
                              q, k, v, padded, k_hi, seed, **kw), "fwd"),
        "flash_dq": (lambda: fa.flash_dq(q, k, v, do, lse, delta, padded,
                                         k_hi, seed, **kw),
                     lambda: ref.flash_dq_reference(q, k, v, do, lse, delta,
                                                   padded, k_hi, seed, **kw),
                     "dq"),
        "flash_dkv": (lambda: fa.flash_dkv(q, k, v, do, lse, delta, padded,
                                           q_lo, seed, **kw),
                      lambda: ref.flash_dkv_reference(
                          q, k, v, do, lse, delta, padded, q_lo, seed, **kw),
                      "dkv"),
    }
    s = mask.shape[0]
    nnz = int(mask.sum())
    # the library yardstick: SDPA on (B, H, S, D) with the boolean mask and
    # the same dropout rate; its backward computes dq, dk and dv together
    qh, kh, vh, doh = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    m = torch.as_tensor(mask, device="cuda")
    sdpa = lambda a, bb, c: F.scaled_dot_product_attention(
        a, bb, c, attn_mask=m, dropout_p=TRAIN_DROPOUT)
    lib_fwd, fwd_names = device_total_ms(lambda: sdpa(qh, kh, vh))
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (qh, kh, vh))
    lib_both, both_names = device_total_ms(
        lambda: torch.autograd.grad(sdpa(qg, kg, vg), (qg, kg, vg), doh))
    lib_bwd = max(lib_both - lib_fwd, 0.0)
    delta_ms, delta_names = device_total_ms(
        lambda: fa.attention_delta(do, out, padded.shape[0]))
    # the same launches with the batch offset of a data-parallel rank's
    # rows (b0 = B, the second of two ranks), timed in turns with b0 = 0
    offset = {
        "flash_fwd_lse": lambda: fa.flash_fwd_lse(q, k, v, padded, k_hi,
                                                  seed, b0=b, **kw),
        "flash_dq": lambda: fa.flash_dq(q, k, v, do, lse, delta, padded,
                                        k_hi, seed, b0=b, **kw),
        "flash_dkv": lambda: fa.flash_dkv(q, k, v, do, lse, delta, padded,
                                          q_lo, seed, b0=b, **kw)}
    rows = {}
    for kernel, (call, plain, kind) in calls.items():
        ms = device_ms(call, kernel_key(kernel, d))
        ms_b0 = device_ms(offset[kernel], kernel_key(kernel, d))
        ms_again = device_ms(call, kernel_key(kernel, d))
        call_ms = time_ms(call)
        plain_ms = time_ms(plain, iters=3, warmup=1)
        nbytes, flops = flash_bytes_flops(b, s, h, d, nnz, dtype, kind)
        bnd, by = bound(nbytes, flops, dtype)
        lib = lib_fwd if kind == "fwd" else lib_bwd
        rows[kernel] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                            bound_ms=bnd, bound_by=by, library_ms=lib,
                            ms_b0=ms_b0, ms_again=ms_again)
        log(f"  {kernel:13s} {name:15s} bf16 B={b} S={s} H={h} D={d} "
            f"r={TRAIN_DROPOUT}: kernel {ms:.4f} ms on the device "
            f"(b0={b}: {ms_b0:.4f} ms, then b0=0 again {ms_again:.4f} ms; "
            f"{call_ms:.4f} ms a wrapper call), plain {plain_ms:.3f} ms, "
            f"bound {bnd:.5f} ms ({by}; {nbytes / 1e6:.2f} MB, "
            f"{flops / 1e9:.3f} GFLOP), SDPA "
            f"{'forward' if kind == 'fwd' else 'backward (dq+dk+dv)'} "
            f"{lib:.4f} ms")
    pair = rows["flash_dq"]["ms"] + rows["flash_dkv"]["ms"] + delta_ms
    for kernel in ("flash_dq", "flash_dkv"):
        rows[kernel].update(delta_ms=delta_ms,
                            pair_and_delta_over_sdpa=pair / lib_bwd)
    log(f"  backward {name:15s}: dq + dk/dv + attention_delta "
        f"({delta_ms:.4f} ms, {delta_names}) = {pair:.4f} ms against SDPA's "
        f"backward {lib_bwd:.4f} ms: {pair / lib_bwd:.2f}x")
    log(f"  SDPA kernels, forward: {fwd_names}; forward+backward: "
        f"{both_names}")
    return rows, {"forward": fwd_names, "forward_backward": both_names}


def flash_offset_check(fa, name, mask, b, h, d):
    """The three training kernels with a batch offset ``b0`` (the rank's
    first global row of a data-parallel step), dropout 0.1, in float32,
    bf16 and bf16 with float32 outputs: the call with ``b0=0`` equals the
    call without it bit for bit; rows [b0, B) of the batch launched with
    ``b0`` equal those rows of the whole batch's launch bit for bit (the
    Philox counters count global rows); the offset launch against its
    plain version under ``rel_gate``.  Returns the largest float32 error
    of each kernel."""
    seed = torch.tensor([0x2468ACE, 0x13579BD], dtype=torch.int64,
                        device="cuda")
    f32_err = dict.fromkeys(("flash_fwd_lse", "flash_dq", "flash_dkv"), 0.0)
    b0 = b // 2
    ref = plain_of(fa, d)
    for dtype, out_dtype in ((torch.float32, None), (torch.bfloat16, None),
                             (torch.bfloat16, torch.float32)):
        mask, (q, k, v, do), (padded, k_hi, q_lo), tiles = flash_case(
            fa, mask, b, h, d, dtype, seed=8)
        kw = dict(block_q=tiles[0], block_k=tiles[1],
                  dropout_rate=TRAIN_DROPOUT, out_dtype=out_dtype)

        def launch(rows, **extra):
            sl = lambda t: t[rows].contiguous()
            out, lse = fa.flash_fwd_lse(sl(q), sl(k), sl(v), padded, k_hi,
                                        seed, **extra, **kw)
            delta = fa.attention_delta(sl(do), out, padded.shape[0])
            args = (sl(q), sl(k), sl(v), sl(do), lse, delta, padded)
            dq = fa.flash_dq(*args, k_hi, seed, **extra, **kw)
            dk, dv = fa.flash_dkv(*args, q_lo, seed, **extra, **kw)
            return dict(out=out, lse=lse, dq=dq, dk=dk, dv=dv, args=args)

        whole = launch(slice(None))
        zero = launch(slice(None), b0=0)
        part = launch(slice(b0, b), b0=b0)
        keys = ("out", "lse", "dq", "dk", "dv")
        same_zero = all(torch.equal(whole[key], zero[key]) for key in keys)
        same_rows = all(torch.equal(whole[key][b0:], part[key])
                        for key in keys)
        args = part["args"]
        want = dict(out=ref.flash_fwd_lse_reference(
            *args[:3], padded, k_hi, seed, b0=b0, **kw)[0],
            dq=ref.flash_dq_reference(*args, k_hi, seed, b0=b0, **kw))
        want["dk"], want["dv"] = ref.flash_dkv_reference(
            *args, q_lo, seed, b0=b0, **kw)
        owner = {"out": "flash_fwd_lse", "dq": "flash_dq", "dk": "flash_dkv",
                 "dv": "flash_dkv"}
        parts, ok_all = [], same_zero and same_rows
        for key, kernel in owner.items():
            ok, err, units = rel_gate(part[key], want[key], dtype)
            ok_all &= ok
            if dtype == torch.float32:
                f32_err[kernel] = max(f32_err[kernel], err)
            parts.append(f"{key} {err:.2e} ({units:.3f})")
        label = str(dtype)[6:] + ("->f32" if out_dtype else "")
        log(f"  flash {name:15s} {label:10s} r={TRAIN_DROPOUT} b0={b0}: "
            f"b0=0 bit for bit with no offset {same_zero}; rows {b0}.. "
            f"launched with b0={b0} bit for bit with the whole batch's "
            f"{same_rows}; |kernel-plain| {', '.join(parts)} "
            f"{'ok' if ok_all else 'FAIL'}")
        if not ok_all:
            fail(f"flash {name} {label} with a batch offset")
    return f32_err


def padding_cost(fa, b=8, h=16):
    """What running head dim 80 padded to 128 costs: at octo_deep's first
    stage (S=224, bf16, dropout 0.1 in the training kernels), B=b, H=h,
    D=80 beside D=128, each kernel's device time alone and one wrapper
    call's whole device time (the kernel, the zero-padded copies of its
    operands and the cut of its outputs at D=80), taken in turns (80, 128,
    128, 80), and the wrapper's host time."""
    mask = stage_mask(DEEP_SPEC, 0)
    seed = torch.tensor([7, 8], dtype=torch.int64, device="cuda")
    calls = {}
    for d in (80, 128):
        _, (q, k, v, do), (padded, k_hi, q_lo), tiles = flash_case(
            fa, mask, b, h, d, torch.bfloat16, seed=17)
        kw = dict(block_q=tiles[0], block_k=tiles[1],
                  dropout_rate=TRAIN_DROPOUT)
        out, lse = fa.flash_fwd_lse(q, k, v, padded, k_hi, seed, **kw)
        delta = fa.attention_delta(do, out, padded.shape[0])
        bind = lambda f, *a, **k: (lambda: f(*a, **k))
        calls[d] = {
            "flash_fwd": bind(fa.flash_fwd, q, k, v, padded, k_hi,
                              block_q=tiles[0], block_k=tiles[1]),
            "flash_fwd_lse": bind(fa.flash_fwd_lse, q, k, v, padded, k_hi,
                                  seed, **kw),
            "flash_dq": bind(fa.flash_dq, q, k, v, do, lse, delta, padded,
                             k_hi, seed, **kw),
            "flash_dkv": bind(fa.flash_dkv, q, k, v, do, lse, delta, padded,
                              q_lo, seed, **kw)}
    rows = {}
    for kernel in calls[80]:
        got = {80: [], 128: []}
        for d in (80, 128, 128, 80):
            call = calls[d][kernel]
            got[d].append((device_ms(call, kernel_key(kernel, d)),
                           device_total_ms(call)[0]))
        row = {f"d{d}_{what}_ms": statistics.mean(x[i] for x in got[d])
               for d in (80, 128) for i, what in enumerate(("kernel",
                                                            "call"))}
        row.update({f"d{d}_wrapper_ms": time_ms(calls[d][kernel])
                    for d in (80, 128)})
        rows[kernel] = row
        log(f"  padding {kernel:13s} bf16 B={b} S={mask.shape[0]} H={h}: "
            f"D=80 (run at 128) kernel {row['d80_kernel_ms']:.4f} ms, whole "
            f"call on the device {row['d80_call_ms']:.4f} ms, wrapper "
            f"{row['d80_wrapper_ms']:.4f} ms; D=128 kernel "
            f"{row['d128_kernel_ms']:.4f} ms, whole call "
            f"{row['d128_call_ms']:.4f} ms, wrapper "
            f"{row['d128_wrapper_ms']:.4f} ms")
    return rows


BASE_DEEP_SPEC = (OCTO_SPEC,
                  "[TaskDescriptionPrefix{0}] [Image{4};Readout{0}]*2")


def dead_row_mask(s=224):
    """A random blocky mask with dead query rows, one run of them filling a
    whole 64-row tile, and a live diagonal elsewhere."""
    rng = np.random.default_rng(0)
    mask = rng.random((s, s)) < 0.3
    mask[np.arange(s), np.arange(s)] = True
    mask[[5, 200]] = False
    mask[64:128] = False
    return mask


def fwd_shapes():
    """name -> (mask, batch, heads, head_dim) of the forward without LSE:
    octo_deep's three stages at the serving batches and at the training
    batch, and with 6 heads of 128 at the serving batches; head dims 32
    and 80 (padded to 128) at its first stage; octo_deep_h512's stages at
    the serving batches and head dims 320, 576, 768, 300 (padded to 320)
    and 1152 on the wide kernel; octo_base_deep's first stage, the 1024-token layout
    and dead rows (at D = 64 and 512)."""
    shapes = {}
    for stage, s in enumerate((224, 160, 96)):
        for b in (1, 8, TRAIN_BATCH):
            shapes[f"octo_deep_S{s}_B{b}"] = (stage_mask(DEEP_SPEC, stage),
                                              b, 12, 64)
    for stage, s in enumerate((224, 160, 96)):
        for b in (1, 8):
            shapes[f"deep_h128_S{s}_B{b}"] = (stage_mask(DEEP_SPEC, stage),
                                              b, 6, 128)
    shapes["d32_S224_B32"] = (stage_mask(DEEP_SPEC, 0), TRAIN_BATCH, 24, 32)
    shapes["d80_S224_B8"] = (stage_mask(DEEP_SPEC, 0), 8, 16, 80)
    for stage, s in enumerate((224, 160, 96)):
        for b in (1, 8):
            shapes[f"deep_h512_S{s}_B{b}"] = (stage_mask(DEEP_SPEC, stage),
                                              b, 3, 512)
    for d, h in ((320, 8), (576, 4), (768, 1), (300, 8), (1152, 1)):
        shapes[f"d{d}_S224_B8"] = (stage_mask(DEEP_SPEC, 0), 8, h, d)
    shapes["dead_rows_d512_S224_B2"] = (dead_row_mask(), 2, 3, 512)
    shapes["octo_base_deep_S74_B1"] = (stage_mask(BASE_DEEP_SPEC, 0), 1, 3,
                                       256)
    shapes["long_context_S1024_B8"] = (layout_mask(LONG_SPEC), 8, 12, 64)
    shapes["dead_rows_S224_B2"] = (dead_row_mask(), 2, 12, 64)
    return shapes


def fwd_case(fa, mask, b, h, d, dtype, seed):
    s = mask.shape[0]
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, s, h, d, generator=g, device="cuda").to(dtype)
               for _ in range(3))
    bq, bk = fa.kernel_tiles(d)
    padded, k_hi, _ = fa.device_tables(mask, bq, bk, "cuda")
    return (q, k, v, padded, k_hi), dict(block_q=bq, block_k=bk)


def flash_fwd_check(fa):
    """flash_fwd against flash_fwd_reference in three dtypes at every shape
    of fwd_shapes(), under the limits of the other flash kernels; dead rows
    must come out as zeros.  Returns each shape's largest float32 |kernel -
    plain|."""
    f32_err = {}
    for name, (mask, b, h, d) in fwd_shapes().items():
        parts, ok_all = [], True
        ref = plain_of(fa, d)
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            args, kw = fwd_case(fa, mask, b, h, d, dtype, seed=11)
            out = fa.flash_fwd(*args, **kw)
            torch.cuda.synchronize()
            want = ref.flash_fwd_reference(*args, **kw)
            ok, err, units = rel_gate(out, want, dtype)
            dead = torch.as_tensor(~mask.any(axis=1), device="cuda")
            ok &= not bool(out[:, dead].any())
            ok_all &= ok
            if dtype == torch.float32:
                f32_err[name] = err
            parts.append(f"{str(dtype)[6:]} {err:.2e} ({units:.3f})")
        log(f"  flash_fwd {name:22s} H={h} D={d}: |kernel-plain| "
            f"{', '.join(parts)}; dead rows {int((~mask.any(axis=1)).sum())} "
            f"{'ok' if ok_all else 'FAIL'}")
        if not ok_all:
            fail(f"flash_fwd {name}")
    return f32_err


def flash_fwd_timings(fa):
    """bf16 device time of flash_fwd at each shape, its plain version, the
    bound over the live pairs and SDPA's forward with the same boolean
    mask."""
    import torch.nn.functional as F
    dtype = torch.bfloat16
    rows = {}
    for name, (mask, b, h, d) in fwd_shapes().items():
        if name.startswith("dead_rows"):
            continue
        args, kw = fwd_case(fa, mask, b, h, d, dtype, seed=13)
        q, k, v = args[:3]
        ref = plain_of(fa, d)
        call = lambda: fa.flash_fwd(*args, **kw)
        ms = device_ms(call, kernel_key("flash_fwd", d))
        call_ms = time_ms(call)
        plain_ms = time_ms(lambda: ref.flash_fwd_reference(*args, **kw),
                           iters=3, warmup=1)
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        m = torch.as_tensor(mask, device="cuda")
        lib, lib_names = device_total_ms(
            lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=m))
        s = mask.shape[0]
        nbytes, flops = flash_bytes_flops(b, s, h, d, int(mask.sum()), dtype,
                                          "fwd_plain")
        bnd, by = bound(nbytes, flops, dtype)
        rows[name] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                          bound_ms=bnd, bound_by=by, library_ms=lib)
        log(f"  flash_fwd {name:22s} bf16 B={b} S={s} H={h} D={d}: kernel "
            f"{ms:.4f} ms on the device ({call_ms:.4f} ms a wrapper call), "
            f"plain {plain_ms:.3f} ms, bound {bnd:.5f} ms ({by}; "
            f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP), SDPA forward "
            f"{lib:.4f} ms ({lib_names[0]})")
    return rows


def wide_forward_check(fa):
    """The wide forwards' launch plan against its mirror (every multiple of
    64 from 320 to 2048), and the cluster body's agreement bit for bit
    (bf16, octo_deep_h512's first stage; at D = 512 and 576, a cluster of
    4 and of 5 with a 64-column last slice): a batch's first two rows
    launched alone against those rows of the batch of 8, with dropout 0.1
    in the LSE kernel, and a CUDA-graph replay of each kernel against its
    eager call.  Returns the plans and the checks."""
    lib = fa._library(True)
    lib.flash_wide_fwd_plan.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.flash_wide_fwd_plan.restype = ctypes.c_int
    got = (ctypes.c_int * 5)()
    plans = {}
    for d in range(320, 2049, 64):
        rc = lib.flash_wide_fwd_plan(d, ctypes.addressof(got))
        plan = fa.wide_forward_plan(d)
        want = [plan[k] for k in ("cluster", "slice", "last_slice", "smem",
                                  "chunk")]
        if rc != 0 or list(got) != want:
            fail(f"wide_forward_plan({d}) = {want}, the kernel's "
                 f"{list(got)} (rc {rc})")
        plans[d] = plan["body"], plan["cluster"]
    log(f"  wide forward plans, C = Python at D = 320..2048: "
        f"{sorted({v for v in plans.values()})}")
    seed = torch.tensor([0x2468ACE, 0x13579BD], dtype=torch.int64,
                        device="cuda")
    checks = {}
    for d, h in ((512, 3), (576, 4)):
        args, kw = fwd_case(fa, stage_mask(DEEP_SPEC, 0), 8, h, d,
                            torch.bfloat16, seed=21)
        lkw = dict(kw, dropout_rate=TRAIN_DROPOUT)
        rows = tuple(x[:2].contiguous() for x in args[:3]) + args[3:]
        calls = {"flash_fwd_wide": lambda a: (fa.flash_fwd(*a, **kw),),
                 "flash_fwd_lse_wide": lambda a: fa.flash_fwd_lse(
                     *a, seed, **lkw)}
        for name, call in calls.items():
            whole, alone = call(args), call(rows)
            same_rows = all(torch.equal(w[:2], x)
                            for w, x in zip(whole, alone))
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                call(args)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                captured = call(args)
            graph.replay()
            eager = call(args)
            torch.cuda.synchronize()
            same_replay = all(torch.equal(c, e)
                              for c, e in zip(captured, eager))
            checks[f"{name} D={d}"] = dict(rows_alone=same_rows,
                                           replay=same_replay)
            log(f"  {name} bf16 D={d} H={h} B=8: rows 0-1 alone bit for bit "
                f"with the batch's {same_rows}; graph replay bit for bit "
                f"with the eager call {same_replay}")
            if not (same_rows and same_replay):
                fail(f"{name} at D={d}: the cluster's blocks disagree")
    return {"plans": {str(d): v for d, v in plans.items()}, "agree": checks}


def wide_backward_check(fa):
    """The wide dq's and dk/dv's launch plans against their mirror (every
    multiple of 64 from 320 to 2048), and the cluster backward's agreement
    bit for bit (bf16, dropout 0.1, octo_deep_h512's first stage; at D =
    512 and 576, clusters of 4 and of 5 with a 64-column last slice): a
    batch's first two rows launched alone against those rows of the batch
    of 8, and a CUDA-graph replay of each kernel against its eager call.
    Returns the plans and the checks."""
    lib = fa._library(True)
    lib.flash_wide_bwd_plan.argtypes = [ctypes.c_int, ctypes.c_int,
                                        ctypes.c_void_p]
    lib.flash_wide_bwd_plan.restype = ctypes.c_int
    got = (ctypes.c_int * 5)()
    plans = {}
    for kind in ("dq", "dkv"):
        for d in range(320, 2049, 64):
            rc = lib.flash_wide_bwd_plan(int(kind == "dkv"), d,
                                         ctypes.addressof(got))
            plan = fa.wide_backward_plan(kind, d)
            want = [plan[k] for k in ("cluster", "slice", "last_slice",
                                      "smem", "chunk")]
            if rc != 0 or list(got) != want:
                fail(f"wide_backward_plan({kind!r}, {d}) = {want}, the "
                     f"kernel's {list(got)} (rc {rc})")
            plans[f"{kind} {d}"] = plan["body"], plan["cluster"]
    log(f"  wide backward plans, C = Python at D = 320..2048: "
        f"{sorted({v for v in plans.values()})}")
    seed = torch.tensor([0x2468ACE, 0x13579BD], dtype=torch.int64,
                        device="cuda")
    checks = {}
    for d, h in ((512, 3), (576, 4)):
        _, (q, k, v, do), (padded, k_hi, q_lo), tiles = flash_case(
            fa, stage_mask(DEEP_SPEC, 0), 8, h, d, torch.bfloat16, seed=22)
        kw = dict(block_q=tiles[0], block_k=tiles[1],
                  dropout_rate=TRAIN_DROPOUT)
        out, lse = fa.flash_fwd_lse(q, k, v, padded, k_hi, seed, **kw)
        delta = fa.attention_delta(do, out, padded.shape[0])
        rows = lambda x: x[:2].contiguous()
        ops = (q, k, v, do)
        calls = {
            "flash_dq_wide": lambda x, ls, dl: (fa.flash_dq(
                *x, ls, dl, padded, k_hi, seed, **kw),),
            "flash_dkv_wide": lambda x, ls, dl: fa.flash_dkv(
                *x, ls, dl, padded, q_lo, seed, **kw)}
        for name, call in calls.items():
            whole = call(ops, lse, delta)
            alone = call(tuple(map(rows, ops)), rows(lse), rows(delta))
            same_rows = all(torch.equal(w[:2], x)
                            for w, x in zip(whole, alone))
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                call(ops, lse, delta)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                captured = call(ops, lse, delta)
            graph.replay()
            eager = call(ops, lse, delta)
            torch.cuda.synchronize()
            same_replay = all(torch.equal(c, e)
                              for c, e in zip(captured, eager))
            checks[f"{name} D={d}"] = dict(rows_alone=same_rows,
                                           replay=same_replay)
            log(f"  {name} bf16 D={d} H={h} B=8 r={TRAIN_DROPOUT}: rows 0-1 "
                f"alone bit for bit with the batch's {same_rows}; graph "
                f"replay bit for bit with the eager call {same_replay}")
            if not (same_rows and same_replay):
                fail(f"{name} at D={d}: the cluster's blocks disagree")
    return {"plans": plans, "agree": checks}


# the layouts the pool backward is held in: (x, g); the first is the one the
# embedder hands it on the main path (its convolution's channels_last output
# and a contiguous cotangent), which main() checks after training
POOL_LAYOUTS = (("channels_last", "nchw"), ("nchw", "nchw"),
                ("channels_last", "channels_last"))


def layout_name(strides):
    """'channels_last', 'nchw' or 'other' for the strides of an NCHW-shaped
    tensor."""
    return ("channels_last" if strides[1] == 1 else
            "nchw" if strides[3] == 1 else "other")


def pool_check_and_time(pool, n):
    """pool_bwd against its plain version, bit for bit, at the embedder's
    shape (N, 64, 23, 23) with many ties and a NaN window, on each of
    POOL_LAYOUTS; one wrapper call on the main path's layout must launch
    the kernel and no copy kernel; bf16 times on that layout (and the
    kernel's on NCHW)."""
    import torch.nn.functional as F
    fmt = {"channels_last": torch.channels_last,
           "nchw": torch.contiguous_format}
    g = torch.Generator(device="cuda").manual_seed(3)
    base = (torch.randn(n, 64, 23, 23, generator=g, device="cuda") * 2
            ).round() / 2
    base[0, 0, 5, 5] = float("nan")
    gy32 = torch.randn(n, 64, 21, 21, generator=g, device="cuda")
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for xl, gl in POOL_LAYOUTS:
            x = base.to(dtype).contiguous(memory_format=fmt[xl])
            gy = gy32.to(dtype).contiguous(memory_format=fmt[gl])
            dx = pool.pool_bwd(x, gy, (3, 3))
            ref = pool.pool_bwd_reference(x, gy, (3, 3))
            torch.cuda.synchronize()
            same = torch.equal(dx, ref) and dx.stride() == x.stride()
            err = max(err, (dx.float() - ref.float()).abs().max().item())
            log(f"  pool_bwd {str(dtype)[6:]:8s} N={n} C=64 23x23, x {xl}, "
                f"g {gl}: kernel == plain bit for bit, dx in x's layout: "
                f"{same}")
            if not same:
                fail(f"pool_bwd {dtype} x {xl} g {gl}")
    dtype = torch.bfloat16
    xl, gl = POOL_LAYOUTS[0]
    x = base.to(dtype).contiguous(memory_format=fmt[xl])
    gy = gy32.to(dtype).contiguous(memory_format=fmt[gl])
    call = lambda: pool.pool_bwd(x, gy, (3, 3))
    call()
    prof, _ = profile_session(call)
    names = sorted({e.key for e in device_events(prof)})
    log(f"  one wrapper call on x {xl}, g {gl} runs: {names}")
    if len(names) != 1 or "pool_bwd_kernel" not in names[0]:
        fail(f"a pool_bwd call on the main path's layout ran {names}")
    ms = device_ms(call, "pool_bwd_kernel")
    x_nchw = x.contiguous()
    ms_nchw = device_ms(lambda: pool.pool_bwd(x_nchw, gy, (3, 3)),
                        "pool_bwd_kernel")
    call_ms = time_ms(call)
    plain_ms = time_ms(lambda: pool.pool_bwd_reference(x, gy, (3, 3)),
                       iters=5, warmup=1)
    xg = x.detach().requires_grad_(True)
    y = F.max_pool2d(xg, 3, 1)
    lib, lib_names = device_total_ms(
        lambda: torch.autograd.grad(y, xg, gy, retain_graph=True))
    e = x.element_size()
    nbytes = (2 * x.numel() + gy.numel()) * e
    # 9 compares for the max, 9 for the first match, 1 add per window
    flops = 19 * gy.numel()
    bnd, by = bound(nbytes, flops, torch.float32)
    log(f"  pool_bwd bf16 N={n}, x {xl}, g {gl}: kernel {ms:.4f} ms on the "
        f"device ({call_ms:.4f} ms a wrapper call; {ms_nchw:.4f} ms with x "
        f"and g NCHW), plain {plain_ms:.3f} ms, bound {bnd:.5f} ms ({by}; "
        f"{nbytes / 1e6:.1f} MB), autograd backward of F.max_pool2d on the "
        f"same layout {lib:.4f} ms ({lib_names})")
    return dict(max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=bnd, bound_by=by, library_ms=lib,
                ms_nchw=ms_nchw, layout={"x": xl, "g": gl})


# windows past the 8 a side of the pool backward's register body: they run
# on its second body (csrc/pool_bwd.cu: pool_bwd_wide_kernel)
POOL_WIDE_WINDOWS = ((9, 9), (3, 12), (16, 16))


def pool_windows_check(pool, n):
    """pool_bwd at windows above 8 a side against its plain version, bit
    for bit, on the embedder's plane (N, 64, 23, 23) of tie-heavy data with
    a NaN window, in float32, bf16 and fp16, x and g both NCHW and both
    channels_last; then each window's bf16 device time on the main path's
    layout beside its plain version, its bound and the autograd backward of
    F.max_pool2d."""
    import torch.nn.functional as F
    fmt = {"channels_last": torch.channels_last,
           "nchw": torch.contiguous_format}
    g = torch.Generator(device="cuda").manual_seed(5)
    base = (torch.randn(n, 64, 23, 23, generator=g, device="cuda") * 2
            ).round() / 2
    base[0, 0, 11, 11] = float("nan")
    dtype = torch.bfloat16
    rows = {}
    for window in POOL_WIDE_WINDOWS:
        oh, ow = 23 - window[0] + 1, 23 - window[1] + 1
        gy32 = torch.randint(1, 17, (n, 64, oh, ow), generator=g,
                             device="cuda").float()
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            for layout in ("nchw", "channels_last"):
                x = base.to(dt).contiguous(memory_format=fmt[layout])
                gy = gy32.to(dt).contiguous(memory_format=fmt[layout])
                dx = pool.pool_bwd(x, gy, window)
                ref = pool.pool_bwd_reference(x, gy, window)
                torch.cuda.synchronize()
                same = torch.equal(dx, ref) and dx.stride() == x.stride()
                log(f"  pool_bwd window {window} {str(dt)[6:]} N={n} C=64 "
                    f"23x23, x and g {layout}: kernel == plain bit for bit, "
                    f"dx in x's layout: {same}")
                if not same:
                    fail(f"pool_bwd window {window} {dt} {layout}")
        xl, gl = POOL_LAYOUTS[0]
        x = base.to(dtype).contiguous(memory_format=fmt[xl])
        gy = gy32.to(dtype).contiguous(memory_format=fmt[gl])
        call = lambda: pool.pool_bwd(x, gy, window)
        ms = device_ms(call, "pool_bwd_wide_kernel")
        plain_ms = time_ms(lambda: pool.pool_bwd_reference(x, gy, window),
                           iters=2, warmup=1)
        xg = x.detach().requires_grad_(True)
        y = F.max_pool2d(xg, window, 1)
        lib, lib_names = device_total_ms(
            lambda: torch.autograd.grad(y, xg, gy, retain_graph=True))
        nbytes = (2 * x.numel() + gy.numel()) * x.element_size()
        slots = window[0] * window[1]
        # the max and the first match over the slots, one add per window
        bnd, by = bound(nbytes, (2 * slots + 1) * gy.numel(), torch.float32)
        rows[f"{window[0]}x{window[1]}"] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
            library_ms=lib)
        log(f"  pool_bwd window {window} bf16 N={n}, x {xl}, g {gl}: kernel "
            f"{ms:.4f} ms on the device, plain {plain_ms:.3f} ms, bound "
            f"{bnd:.5f} ms ({by}), autograd backward of F.max_pool2d "
            f"{lib:.4f} ms ({lib_names[0]})")
    return rows


# (side, window): the largest square planes the pool backward's wide body
# takes at 9x9 and 16x16 (past what its row arrays fit beside: its direct
# search), and the largest that takes its separable search at 9x9
POOL_LARGE_PLANES = ((112, (9, 9)), (144, (9, 9)), (148, (16, 16)))


def pool_planes_check(pool):
    """The pool backward's plan mirror (ops/pool.py:kernel_plan) against
    the library's own cut at every square plane from the window up to past
    the largest that fits, and a band of rectangles, at windows 3x3 to
    16x16, 3 and 64 channels, three dtypes; then the kernel bit for bit
    against its plain version at POOL_LARGE_PLANES (N=2, C=64, tie-heavy
    data with a NaN window, float32, bf16 and fp16, both layouts): the wide
    body's direct search at the largest square planes it takes at 9x9 and
    16x16, and its separable search at the largest at 9x9."""
    fmt = {"channels_last": torch.channels_last,
           "nchw": torch.contiguous_format}
    shapes = 0
    for window in ((3, 3), (5, 7), (8, 8), (9, 9), (3, 12), (16, 16),
                   (23, 1)):
        sides = range(max(window), 200, 3)
        planes = ([(s, s) for s in sides]
                  + [(s, 2 * s) for s in sides if 2 * s >= window[1]]
                  + [(2 * s, s) for s in sides if s >= window[1]])
        for c in (3, 64):
            for h, w in planes:
                for dt in (torch.float32, torch.bfloat16, torch.float16):
                    want = pool.kernel_plan(c, h, w, window, dt)
                    got = pool.library_plan(c, h, w, window, dt)
                    if got != want:
                        fail(f"pool kernel_plan({c}, {h}, {w}, {window}, "
                             f"{dt}) gives {want}, the library {got}")
                    shapes += 1
    log(f"  pool_bwd plans, C = Python at {shapes} shapes")
    g = torch.Generator(device="cuda").manual_seed(6)
    held = {}
    for side, window in POOL_LARGE_PLANES:
        oh, ow = side - window[0] + 1, side - window[1] + 1
        base = (torch.randn(2, 64, side, side, generator=g, device="cuda")
                * 2).round() / 2
        base[1, 5, side // 2, side // 3] = float("nan")
        gy32 = torch.randint(1, 17, (2, 64, oh, ow), generator=g,
                             device="cuda").float()
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            plan = pool.kernel_plan(64, side, side, window, dt)
            search = "separable" if plan["rows"] else "direct"
            for layout in ("nchw", "channels_last"):
                x = base.to(dt).contiguous(memory_format=fmt[layout])
                gy = gy32.to(dt).contiguous(memory_format=fmt[layout])
                dx = pool.pool_bwd(x, gy, window)
                ref = pool.pool_bwd_reference(x, gy, window)
                torch.cuda.synchronize()
                same = torch.equal(dx, ref) and dx.stride() == x.stride()
                log(f"  pool_bwd {side}x{side} window {window} "
                    f"{str(dt)[6:]} {layout}, {search} search, cb "
                    f"{plan['cb']}, {plan['smem_bytes']} B: kernel == plain "
                    f"bit for bit, dx in x's layout: {same}")
                if not same:
                    fail(f"pool_bwd {side}x{side} window {window} {dt} "
                         f"{layout}")
            held[f"{side}x{side} {window[0]}x{window[1]} {str(dt)[6:]}"] = (
                search)
    if set(held.values()) != {"separable", "direct"}:
        fail(f"the large planes did not reach both searches: {held}")
    return dict(plans=shapes, large_planes=held)


# the image tower's GroupNorm -> GELU maps on the main paths: chunk28 at
# B=1 and B=64 (50 patches a robot), octo_deep at B=8 (200 patches)
GN_SHAPES = (((50, 64, 21, 21), 50), ((3200, 64, 21, 21), 50),
             ((1600, 64, 7, 7), 200))
GN_GROUPS, GN_EPS = 32, 1e-6
# the kernels' names, each counted by replay_profile; the main paths hand
# the kernels channels_last maps, so the NCHW pair must not run there
GN_KERNELS = ("gn_stats_nhwc", "gn_apply_gelu_nhwc", "gn_stats_nchw",
              "gn_apply_gelu_nchw")


# the quantized towers' norms are serve.quantize's plain chain
NO_NORM_KERNELS = {"gn_stats_nhwc": 0, "gn_apply_gelu_nhwc": 0}


def norm_kernels(cfg):
    """Launches a call of the GroupNorm kernels where the image tower runs
    once: a statistics and an apply kernel (channels_last) for each
    residual block's norm."""
    n = cfg.images.resnet.num_blocks
    return {"gn_stats_nhwc": n, "gn_apply_gelu_nhwc": n}


def gn_inputs(shape, seed):
    """A bf16 channels_last map shaped like the tower's (per-channel offsets
    and scales) and float32 weight and bias away from their start."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[1]
    off = torch.rand(c, generator=g, device="cuda")[:, None, None] * 0.8
    scale = torch.rand(c, generator=g, device="cuda")[:, None, None] + 0.5
    x = (torch.randn(shape, generator=g, device="cuda") * scale + off).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    w = torch.rand(c, generator=g, device="cuda") + 0.5
    b = torch.randn(c, generator=g, device="cuda") * 0.2
    return x, w, b


def group_norm_check(gn, it, shape, ppe):
    """The wrapper (as the embedder's custom op calls it) against the plain
    version at one map, bf16 channels_last: y equals the kernels' own y
    with their statistics; mean within 1e-5 of the group's RMS and variance
    within 1e-5 relative of the plain chain's; y bit for bit the plain
    chain's elementwise steps on the kernels' statistics; each normalised
    value z within one bf16 ulp of the plain chain's (2^-18 below 2^-10,
    where statistics apart in their last float32 bits move z by more).
    Returns the share of y and of z that differ from the plain chain."""
    import torch.nn.functional as F
    x, w, b = gn_inputs(shape, seed=shape[0] + ppe)
    bf = torch.bfloat16
    with torch.inference_mode():
        y = gn.group_norm_gelu(x, w, b, GN_GROUPS, GN_EPS, ppe, bf)
        y2, stats = gn._launch(x, w, b, GN_GROUPS, GN_EPS, ppe, bf,
                               with_stats=True)
        want = gn.group_norm_gelu_reference(x, w, b, GN_GROUPS, GN_EPS, ppe,
                                            bf)
        n, c, h, wd = shape
        f = x.float().reshape(n // ppe, ppe, GN_GROUPS, c // GN_GROUPS, h,
                              wd)
        rmu = f.mean((1, 3, 4, 5))
        rvar = ((f * f).mean((1, 3, 4, 5)) - rmu * rmu).clamp_min(0.0)
        mu, var = stats.unbind(-1)
        cpg = c // GN_GROUPS
        per_channel = lambda t: t.repeat_interleave(cpg, 1).repeat_interleave(
            ppe, 0)[:, :, None, None]
        z = ((x.float() - per_channel(mu)) * torch.rsqrt(per_channel(var)
                                                          + GN_EPS)
             * w[:, None, None] + b[:, None, None]).to(bf)
        z_plain = (it.group_norm_stats(x.float(), GN_GROUPS, GN_EPS, "image",
                                       ppe)
                   * w[:, None, None] + b[:, None, None]).to(bf)
        same_y = torch.equal(y, y2)
        elementwise = torch.equal(y, F.gelu(z, approximate="tanh"))
        rms = (rvar + rmu * rmu).sqrt()
        mu_err = float(((mu - rmu).abs() / rms).max())
        var_err = float(((var - rvar).abs() / rvar).max())
        mag = torch.maximum(z.abs(), z_plain.abs()).float()
        ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(2.0 ** -126)))
                         - 7).clamp_min(2.0 ** -18)
        z_units = float(((z.float() - z_plain.float()).abs() / ulp).max())
        y_share = float((y != want).float().mean())
        z_share = float((z != z_plain).float().mean())
        layout_kept = y.is_contiguous(memory_format=torch.channels_last)
    scope = "image" if ppe > 1 else "patch"
    log(f"  group_norm_gelu bf16 {shape} channels_last, {ppe} patches an "
        f"element ({scope} scope): wrapper == kernels {same_y}, y == the "
        f"plain elementwise steps on the kernels' statistics {elementwise}, "
        f"mean {mu_err:.2e} of the RMS, variance {var_err:.2e} relative, z "
        f"within {z_units:.3f} of its tolerance; {y_share:.2e} of y and "
        f"{z_share:.2e} of z differ from the plain chain; y channels_last "
        f"{layout_kept}")
    if not (same_y and elementwise and layout_kept and mu_err <= 1e-5
            and var_err <= 1e-5 and z_units <= 1.0):
        fail(f"group_norm_gelu at {shape}, {ppe} patches an element")
    return {"y_share_differs": y_share, "z_share_differs": z_share,
            "mean_err_of_rms": mu_err, "var_rel_err": var_err,
            "z_err_of_tol": z_units}


def group_norm_grad_check(gn, ppe=50):
    """The training route (GroupNormGelu: the kernels forward, plain PyTorch
    backward) at octo_base training's map, bf16 channels_last: the
    gradients of x, weight and bias no further from the plain chain in
    float64 than twice the plain chain's own autograd gradients (relative
    norm); the device time of a forward and backward of each."""
    import torch.nn.functional as F
    from multi_modal_transformers_tokenmerge_torch.modules.image_tokenizer \
        import group_norm_stats
    shape = (TRAIN_BATCH * 50, 64, 21, 21)
    x, w, b = gn_inputs(shape, seed=21)
    gy = torch.randn(shape, generator=torch.Generator(device="cuda")
                     .manual_seed(23), device="cuda").to(torch.bfloat16)
    args = (GN_GROUPS, GN_EPS, ppe)

    def chain(x, w, b, dtype, acc):
        f = group_norm_stats(x.to(acc), GN_GROUPS, GN_EPS, "image", ppe)
        f = f * w.to(acc)[:, None, None] + b.to(acc)[:, None, None]
        return F.gelu(f.to(dtype), approximate="tanh")

    def grads(route, x, w, b, gy, dtype, acc=torch.float32):
        leaves = [t.detach().requires_grad_(True) for t in (x, w, b)]
        y = (gn.GroupNormGelu.apply(*leaves, *args, dtype) if route
             else chain(*leaves, dtype, acc))
        return torch.autograd.grad(y, leaves, gy)

    got = grads(True, x, w, b, gy, torch.bfloat16)
    plain = grads(False, x, w, b, gy, torch.bfloat16)
    truth = grads(False, x.double(), w.double(), b.double(), gy.double(),
                  torch.float64, torch.float64)
    rel = lambda a, t: float((a.double() - t).norm() / t.norm())
    out = {}
    for name, a, p_, t in zip(("x", "weight", "bias"), got, plain, truth):
        out[name] = {"err": rel(a, t), "plain_err": rel(p_, t)}
    del truth
    log(f"  GroupNormGelu bf16 {shape} ({ppe} patches an element), "
        f"gradients against the plain chain in float64 (relative norm): "
        + ", ".join(f"d{k} {v['err']:.3e} (plain chain {v['plain_err']:.3e})"
                    for k, v in out.items()))
    for k, v in out.items():
        if v["err"] > 2 * v["plain_err"] + 1e-7:
            fail(f"GroupNormGelu's d{k} is {v['err']:.3e} from the float64 "
                 f"chain; the plain chain's {v['plain_err']:.3e}")
    out["fwd_bwd_ms"], out["fwd_bwd_top"] = device_total_ms(
        lambda: grads(True, x, w, b, gy, torch.bfloat16), iters=10)
    out["plain_fwd_bwd_ms"], out["plain_fwd_bwd_top"] = device_total_ms(
        lambda: grads(False, x, w, b, gy, torch.bfloat16), iters=5)
    log(f"  forward and backward on the device: training route "
        f"{out['fwd_bwd_ms']:.4f} ms, plain chain "
        f"{out['plain_fwd_bwd_ms']:.4f} ms")
    return out


def group_norm_check_and_time(gn):
    """group_norm_gelu (csrc/group_norm_gelu.cu) against its plain version
    at GN_SHAPES in bf16 channels_last, both statistics scopes
    (group_norm_check); the training route's gradients
    (group_norm_grad_check); at chunk28 B=64's map each kernel's device
    time, the pair's, the wrapper call's, the plain chain's, the library's
    (F.group_norm on the (E, C, P, H, W) view, which pools an element's
    patches as the image scope does, then F.gelu) and the bytes bound."""
    import torch.nn.functional as F
    from multi_modal_transformers_tokenmerge_torch.modules import (
        image_tokenizer as it)
    checks = {f"{shape}_{scope}": group_norm_check(
                  gn, it, shape, ppe if scope == "image" else 1)
              for shape, ppe in GN_SHAPES for scope in ("image", "patch")}
    grad = group_norm_grad_check(gn)
    shape, ppe = GN_SHAPES[1]
    x, w, b = gn_inputs(shape, seed=5)
    bf = torch.bfloat16
    call = lambda: gn.group_norm_gelu(x, w, b, GN_GROUPS, GN_EPS, ppe, bf)
    with torch.inference_mode():
        call()
        prof, _ = profile_session(call)
        names = sorted({e.key for e in device_events(prof)})
        log(f"  one group_norm_gelu call runs: {names}")
        if len(names) != 2 or not all(
                any(f"{k}_kernel" in n for n in names)
                for k in ("gn_stats_nhwc", "gn_apply_gelu_nhwc")):
            fail(f"a group_norm_gelu call on the main path's layout ran "
                 f"{names}")
        stats_ms = device_ms(call, "gn_stats_nhwc_kernel")
        apply_ms = device_ms(call, "gn_apply_gelu_nhwc_kernel")
        pair_ms, _ = device_total_ms(call)
        call_ms = time_ms(call)
        plain_ms, plain_top = device_total_ms(
            lambda: gn.group_norm_gelu_reference(x, w, b, GN_GROUPS, GN_EPS,
                                                 ppe, bf), iters=10)
        e, c = shape[0] // ppe, shape[1]
        wb, bb = w.to(bf), b.to(bf)
        library = lambda: F.gelu(F.group_norm(
            x.view(e, ppe, c, *shape[2:]).transpose(1, 2), GN_GROUPS, wb,
            bb, GN_EPS).transpose(1, 2).reshape(shape), approximate="tanh")
        lib_y = library()
        want = gn.group_norm_gelu_reference(x, w, b, GN_GROUPS, GN_EPS, ppe,
                                            bf)
        lib_rel = float((lib_y.float() - want.float()).norm()
                        / want.float().norm())
        lib_ms, lib_top = device_total_ms(library, iters=10)
    if lib_rel > 1e-2:
        fail(f"F.group_norm on the (E, C, P, H, W) view is {lib_rel:.2e} "
             f"from the plain chain: not the same function")
    nbytes = 3 * x.numel() * x.element_size()
    # statistics: an add and an FMA; apply: 4 for the norm and affine, some
    # 10 for the tanh GELU
    flops = 17 * x.numel()
    bnd, by = bound(nbytes, flops, torch.float32)
    log(f"  group_norm_gelu bf16 {shape} channels_last, {ppe} patches an "
        f"element: gn_stats {stats_ms:.4f} ms + gn_apply_gelu "
        f"{apply_ms:.4f} ms on the device (the call's device total "
        f"{pair_ms:.4f} ms, {call_ms:.4f} ms a wrapper call), plain chain "
        f"{plain_ms:.4f} ms ({plain_top}), F.group_norm on the (E, C, P, H, "
        f"W) view then F.gelu {lib_ms:.4f} ms ({lib_top}; {lib_rel:.2e} "
        f"from the plain chain, bf16 weight and bias), bound {bnd:.5f} ms "
        f"({by}; {nbytes / 1e6:.1f} MB)")
    return dict(ms=stats_ms + apply_ms, stats_ms=stats_ms, apply_ms=apply_ms,
                pair_device_ms=pair_ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=bnd, bound_by=by, library_ms=lib_ms,
                library_rel_err=lib_rel, checks=checks, training=grad)


# -- the grouped expert kernels (octo_moonlight's routed layers) ------------

# octo_moonlight's routed layer: hidden, expert width, experts, choices a token
GE_D, GE_F, GE_E, GE_K = 2048, 1408, 64, 6
# the tokens a routed layer sees at B=8: 8 x the stack's stages (224, 160, 96)
GE_TOKENS = (1792, 1280, 768)
GE_ROUTINGS = ("uniform", "skewed", "single")
# the kernels' names, each counted by replay_profile (one a routed layer)
GE_KERNELS = ("expert_gate_up", "expert_down", "expert_combine")
# relative norm of the kernels' output from the plain version's: both round
# at the same points (the SwiGLU rows, each weighted row, the sum) from
# float32 sums of the same bf16 products; they differ where a sum taken in
# another order lands on the other side of a bf16 rounding, one bf16 ulp
# (2^-8) of an intermediate, which the next product averages out
GE_TOL = 2.0 ** -10


def ge_case(G, tokens, routing, seed):
    """grouped_experts' arguments at octo_moonlight's widths.  Routing
    'uniform' as the benchmark's random weights route (top 6 of the sigmoid
    scores of a random router); 'skewed' (scores scaled down by up to
    1000x along the experts: a few take most tokens, most see few or none);
    'single' (every token the same 6 experts: six with every token, 58
    with none)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    bf = torch.bfloat16
    x = torch.randn(tokens, GE_D, generator=g, device="cuda").to(bf)
    wgu = (torch.randn(GE_E, 2 * GE_F, GE_D, generator=g, device="cuda")
           / GE_D ** 0.5).to(bf)
    wd = (torch.randn(GE_E, GE_D, GE_F, generator=g, device="cuda")
          / GE_F ** 0.5).to(bf)
    shared = torch.randn(tokens, GE_D, generator=g, device="cuda").to(bf)
    router = torch.randn(GE_E, GE_D, generator=g, device="cuda") / GE_D ** 0.5
    scores = torch.sigmoid(x.float() @ router.T)
    if routing == "skewed":
        scores = scores * torch.logspace(0, -3, GE_E, device="cuda")
    weights, experts = G.route(scores, torch.zeros(GE_E, device="cuda"),
                               GE_K, 2.446)
    if routing == "single":
        experts = torch.arange(GE_K, device="cuda").expand(
            tokens, GE_K).contiguous()
    return x, wgu, wd, weights, experts, shared


def ge_library(G, x, wgu, wd, weights, experts, shared):
    """The same function through PyTorch's grouped product
    (``torch._grouped_mm``) on the sorted rows, the SwiGLU and the weighting
    between, the combine by index_add_: the yardstick of a library call;
    None where this PyTorch has no such call."""
    import torch.nn.functional as F
    if not hasattr(torch, "_grouped_mm"):
        return None
    lay = G.sort_pairs(experts, GE_E)
    ends = lay.offsets[1:].contiguous()
    xs = x[lay.tokens.long()]
    w = weights.reshape(-1)[lay.order].float()[:, None]
    tok = lay.tokens.long()

    def run():
        h = torch._grouped_mm(xs, wgu.transpose(1, 2), offs=ends)
        h = (F.silu(h[:, :GE_F].float()) * h[:, GE_F:].float()).to(x.dtype)
        y = torch._grouped_mm(h, wd.transpose(1, 2), offs=ends)
        return shared.float().index_add_(0, tok, y.float() * w).to(x.dtype)
    return run


def grouped_experts_check_and_time():
    """grouped_experts (csrc/grouped_experts.cu) against its plain version at
    octo_moonlight's widths (2048 -> 1408, 64 experts, top 6) at the three
    stage sizes of B=8 (GE_TOKENS) under uniform, skewed and single-expert
    routing, to GE_TOL of the output's norm, and a second call equal to the
    first bit for bit; at each stage size under uniform routing each
    kernel's device time, the whole call's (sort, tile plan, the three
    kernels), the plain version's, the library's (torch._grouped_mm) and
    the products' bound from portbench/counts/moonlight.py's bytes and
    FLOPs."""
    from multi_modal_transformers_tokenmerge_torch.ops import (
        grouped_experts as G)
    from portbench.counts.moonlight import expert_bytes_flops
    checks, stages = {}, {}
    with torch.inference_mode():
        for tokens in GE_TOKENS:
            for routing in GE_ROUTINGS:
                args = ge_case(G, tokens, routing, seed=tokens)
                got = G.grouped_experts(*args)
                again = G.grouped_experts(*args)
                torch.cuda.synchronize()
                want = G.grouped_experts_reference(*args)
                err = float((got.float() - want.float()).norm()
                            / want.float().norm())
                same = torch.equal(got, again)
                counts = torch.bincount(args[4].reshape(-1),
                                        minlength=GE_E)
                checks[f"{tokens}_{routing}"] = {
                    "rel_err": err, "repeat_equal": same,
                    "rows_max": int(counts.max()),
                    "experts_empty": int((counts == 0).sum())}
                log(f"  grouped_experts bf16 T={tokens} {routing}: "
                    f"{err:.3e} of the plain version's norm (limit "
                    f"{GE_TOL:.3e}), a second call equal {same}; rows an "
                    f"expert at most {int(counts.max())}, "
                    f"{int((counts == 0).sum())} experts empty")
                if not (err <= GE_TOL and same):
                    fail(f"grouped_experts at T={tokens}, {routing} routing")
        for tokens in GE_TOKENS:
            args = ge_case(G, tokens, "uniform", seed=tokens)
            call = lambda: G.grouped_experts(*args)
            row = {k: device_ms(call, f"{k}_kernel") for k in GE_KERNELS}
            row["call_device_ms"], _ = device_total_ms(call)
            row["plain_ms"], row["plain_top"] = device_total_ms(
                lambda: G.grouped_experts_reference(*args), iters=5)
            lib = ge_library(G, *args)
            if lib is not None:
                want = G.grouped_experts_reference(*args).float()
                row["library_rel_err"] = float(
                    (lib().float() - want).norm() / want.norm())
                row["library_ms"], row["library_top"] = device_total_ms(
                    lib, iters=10)
            counts = expert_bytes_flops((tokens, GE_K, GE_E, GE_D, GE_F),
                                        "bfloat16")
            for kind in ("gate_up", "down"):
                row[f"{kind}_bound_ms"], row[f"{kind}_bound_by"] = bound(
                    *counts[kind], torch.bfloat16)
            row["bound_ms"] = row["gate_up_bound_ms"] + row["down_bound_ms"]
            row["products_ms"] = row["expert_gate_up"] + row["expert_down"]
            row["roofline_pct"] = 100 * row["bound_ms"] / row["products_ms"]
            stages[tokens] = row
            log(f"  grouped_experts bf16 T={tokens} uniform: gate_up "
                f"{row['expert_gate_up']:.4f} ms, down "
                f"{row['expert_down']:.4f} ms, combine "
                f"{row['expert_combine']:.4f} ms on the device (the whole "
                f"call {row['call_device_ms']:.4f} ms), plain "
                f"{row['plain_ms']:.4f} ms, torch._grouped_mm "
                f"{row.get('library_ms', float('nan')):.4f} ms "
                f"({row.get('library_rel_err', float('nan')):.2e} from the "
                f"plain version); the products' bound "
                f"{row['bound_ms']:.4f} ms ({row['gate_up_bound_by']}), "
                f"{row['roofline_pct']:.1f}% reached")
    return {"checks": checks, "stages": stages}


def moonlight_replay_check():
    """octo_moonlight at its widths and 4 blocks (1 dense, 3 routed, a merge
    after 2), served by the compiled engine at B=8: one profiled replay
    runs each grouped kernel once a routed layer, flash_fwd_lse once a
    block, the register sampler once and the tower's GroupNorm pair."""
    from multi_modal_transformers_tokenmerge_torch import load_config
    from multi_modal_transformers_tokenmerge_torch.models.octo import Octo
    from multi_modal_transformers_tokenmerge_torch.serve.policy import (
        PolicyEngine)
    cfg = load_config("octo_moonlight", ["transformer.num_blocks=4",
                                         "transformer.tome_merge_every=2"])
    t = cfg.transformer
    routed = t.num_blocks - t.first_k_dense_replace
    model = Octo(cfg, device="cuda", seed=0).eval()
    g = np.random.default_rng(11)
    eng = PolicyEngine(model, batch_size=8, seed=1)
    eng.compile((cfg.text.max_length,),
                (cfg.num_observation_blocks, *cfg.images.image_size))
    eng.set_instruction(g.integers(0, cfg.text.vocab_size,
                                   (cfg.text.max_length,)))
    images = random_images(cfg, 8, g)
    expected = {**norm_kernels(cfg), "flash_fwd_lse": t.num_blocks,
                "ddpm_sampler": 1, **{k: routed for k in GE_KERNELS}}
    prof = replay_profile(lambda: eng(images), 5, expected,
                          "octo_moonlight (4 blocks) B=8 compiled request")
    log(f"  compiled octo_moonlight (4 blocks, {routed} routed) B=8: one "
        f"replay: {prof['launches']:.0f} launches, device "
        f"{prof['device_ms']:.4f} ms, kernels "
        f"{ {k: v for k, v in prof['kernels'].items() if v} }")
    del eng, model
    torch.cuda.empty_cache()
    return prof


def grouped_experts_phase():
    """Phase 34: the kernels line's row of the grouped expert kernels."""
    phase("phase 34: octo_moonlight's grouped expert kernels")
    ge = grouped_experts_check_and_time()
    replay = moonlight_replay_check()
    first = ge["stages"][GE_TOKENS[0]]
    return {
        "name": "grouped_experts", "route": "cuda",
        "source": "multi_modal_transformers_tokenmerge_torch/csrc/"
                  "grouped_experts.cu",
        "replaces": None,
        "plain": "multi_modal_transformers_tokenmerge_torch/ops/"
                 "grouped_experts.py: grouped_experts_reference",
        "launches": {k: replay["kernels"][k] for k in GE_KERNELS},
        "ms": first["call_device_ms"],
        **{f"{k}_ms": first[k] for k in GE_KERNELS},
        **{k: first.get(k) for k in (
            "plain_ms", "bound_ms", "gate_up_bound_by", "library_ms",
            "library_rel_err", "roofline_pct")},
        "library": "torch._grouped_mm for both products on the sorted rows, "
                   "the SwiGLU and weighting between, index_add_",
        "shape": f"octo_moonlight serving bf16 B=8, T={GE_TOKENS[0]} "
                 f"tokens, {GE_D} -> {GE_F}, {GE_E} experts, top {GE_K}, "
                 f"uniform routing",
        "stages": ge["stages"], "checks": ge["checks"],
        "launches_per_compiled_request_octo_moonlight_4_blocks":
            replay["kernels"],
    }


def check_pool_layout(pool, label):
    """The layout the main path just handed the pool backward is the one
    phase 2 held and timed (POOL_LAYOUTS[0])."""
    strides = pool.pool_bwd.last_strides
    got = tuple(layout_name(s) for s in strides)
    log(f"  {label}: _MaxPool.backward received x strides {strides[0]} "
        f"({got[0]}), g strides {strides[1]} ({got[1]})")
    if got != POOL_LAYOUTS[0]:
        fail(f"{label} handed the pool backward x {got[0]}, g {got[1]}; "
             f"phase 2 held {POOL_LAYOUTS[0]}")
    return {"x": got[0], "g": got[1], "strides": strides}


def auto_gate_check(fa):
    """attention_impl='auto' runs the flash kernel from flash_min_seq
    (1024) tokens on, and the plain attention below."""
    from multi_modal_transformers_tokenmerge_torch.core.config import (
        TransformerConfig, AttentionConfig)
    from multi_modal_transformers_tokenmerge_torch.modules.attention import (
        MultiHeadAttention, select_attention_fn)
    g = torch.Generator(device="cuda").manual_seed(4)
    for spec, heads in ((LONG_SPEC, 12), (OCTO_SPEC, 3)):
        mask = layout_mask(spec)
        s = mask.shape[0]
        cfg = TransformerConfig(attention_impl="auto", attention=
                                AttentionConfig(num_heads=heads))
        fn = select_attention_fn(cfg, mask, s, "cuda")
        mha = MultiHeadAttention(cfg.attention, 768, fn,
                                 dtype=torch.bfloat16, device="cuda")
        for mod in mha.modules():
            if mod is not mha and hasattr(mod, "reset_parameters"):
                mod.reset_parameters(g)
        before = fa.flash_fwd_lse.launches
        with torch.no_grad():
            y = mha(torch.randn(1, s, 768, generator=g, device="cuda"),
                    torch.as_tensor(mask, device="cuda"))
        launched = fa.flash_fwd_lse.launches - before
        log(f"  attention_impl='auto' at S={s}: flash kernel launched "
            f"{launched} time(s), output finite "
            f"{bool(torch.isfinite(y).all())}")
        if launched != (1 if s >= cfg.flash_min_seq else 0) or \
                not torch.isfinite(y).all():
            fail(f"'auto' at S={s}")


# -- phase 3: serving --------------------------------------------------------

def random_images(cfg, batch, g):
    frames = cfg.num_observation_blocks
    return torch.from_numpy(g.integers(
        0, 256, (batch, frames, *cfg.images.image_size)).astype(
            np.float32)).cuda()


def timed_requests(eng, cfg, batch, n, g, check=None):
    """``n`` requests of random images through ``eng``, each timed on the
    host clock up to a synchronize; ``check(action)`` after each."""
    times = []
    for _ in range(n):
        images = random_images(cfg, batch, g)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        act = eng(images)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if check is not None:
            check(act)
    return times


def latency(times):
    return {"median_ms": statistics.median(times),
            "p90_ms": statistics.quantiles(times, n=10)[-1],
            "requests": len(times)}


def serve_phase(model, cfg, counters, label, requests, expected,
                head="diffusion", batches=(1, 8)):
    """``requests`` requests at each of ``batches`` through PolicyEngine
    with a cached instruction.  Every count is set to 0 before and read
    after; each request must advance every counter by ``expected`` (a
    kernel it does not name: by 0)."""
    from multi_modal_transformers_tokenmerge_torch.serve.policy import (
        PolicyEngine)
    g = np.random.default_rng(0)
    ids = g.integers(0, cfg.text.vocab_size, (cfg.text.max_length,))
    hc = getattr(cfg.heads, head)
    limit = hc.clip_value if head == "diffusion" else hc.max_action
    results = {}
    for c in counters.values():
        c.launches = 0
    served = 0
    for batch in batches:
        eng = PolicyEngine(model, head=head, batch_size=batch, seed=1)
        eng.set_instruction(ids)
        want_shape = ((batch, hc.action_space_dim) if head == "diffusion"
                      else (batch, 1, hc.action_space_dim))

        def check(act):
            nonlocal served
            served += 1
            for name, c in counters.items():
                if c.launches != served * expected.get(name, 0):
                    fail(f"{label}: after {served} requests {name} was "
                         f"launched {c.launches} times; expected "
                         f"{expected.get(name, 0)} a request")
            if tuple(act.shape) != want_shape:
                fail(f"{label}: action shape {tuple(act.shape)}")
            if not torch.isfinite(act).all() or act.abs().max() > limit:
                fail(f"{label}: action not finite or outside +-{limit}")

        times = timed_requests(eng, cfg, batch, requests + 2, g, check)
        steady = times[2:]
        results[batch] = latency(steady)
        log(f"  serve {label} B={batch}: {len(steady)} requests after "
            f"two warm-up ({times[0]:.1f}, {times[1]:.1f} ms): median "
            f"{results[batch]['median_ms']:.4f} ms/request, p90 "
            f"{results[batch]['p90_ms']:.4f}, min {min(steady):.4f}, "
            f"max {max(steady):.4f}")
    launches = {k: c.launches for k, c in counters.items()}
    log(f"  launches in {served} requests: {launches}")
    return results, launches


def merge_compare_phase(merged, baseline, cfg, requests):
    """The merged model and its unmerged baseline served in turns (merged,
    baseline, baseline, merged) at each batch size, so that both see the
    same machine: recorded, not gated."""
    from multi_modal_transformers_tokenmerge_torch.serve.policy import (
        PolicyEngine)
    g = np.random.default_rng(1)
    ids = g.integers(0, cfg.text.vocab_size, (cfg.text.max_length,))
    out = {}
    for batch in (1, 8):
        engines = {name: PolicyEngine(m, batch_size=batch, seed=1)
                   .set_instruction(ids)
                   for name, m in (("merged", merged), ("unmerged", baseline))}
        times = {name: [] for name in engines}
        for eng in engines.values():
            timed_requests(eng, cfg, batch, 2, g)
        for name in ("merged", "unmerged", "unmerged", "merged"):
            times[name] += timed_requests(engines[name], cfg, batch,
                                          requests // 2, g)
        out[batch] = {name: latency(t) for name, t in times.items()}
        log(f"  B={batch}, {requests} requests each in turns: merged median "
            f"{out[batch]['merged']['median_ms']:.4f} ms (p90 "
            f"{out[batch]['merged']['p90_ms']:.4f}), unmerged "
            f"(compression_mode='none', 12 blocks at 224 tokens) median "
            f"{out[batch]['unmerged']['median_ms']:.4f} ms (p90 "
            f"{out[batch]['unmerged']['p90_ms']:.4f})")
    return out


# -- phase 4: float32 CUDA vs CPU ----------------------------------------------

def reference_phase(cfg32, label="octo_base", sampler_launches=1,
                    variant="register"):
    """``cfg32`` in float32 on the card against the CPU, the same weights,
    inputs and noise; the card's request must launch the ``variant``
    sampler kernel ``sampler_launches`` times (0 for a multi-block
    denoiser, whose reverse loop is plain PyTorch on every device) and the
    other none."""
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
        before = {v: c.launches for v, c in ddpm_sampler.by_variant.items()}
        out_gpu = gpu.predict_diffusion_action(
            ids.cuda(), images.cuda(), noisy=noisy.cuda(),
            noise=noise.cuda()).cpu()
        launched = {v: c.launches - before[v]
                    for v, c in ddpm_sampler.by_variant.items()}
        if launched != {v: sampler_launches if v == variant else 0
                        for v in launched}:
            fail(f"the float32 CUDA run of {label} launched the sampler "
                 f"kernels {launched}; expected {sampler_launches} of the "
                 f"{variant} kernel")
        out_cpu = cpu.predict_diffusion_action(ids, images, noisy=noisy,
                                               noise=noise)
    err = (out_gpu - out_cpu).abs().max().item()
    log(f"  {label} f32 predict_diffusion_action B={b}: |cuda-cpu|="
        f"{err:.3e} (tol {E2E_F32_TOL:g}: cuDNN/cuBLAS sum in another order "
        f"than the CPU, and {t} sampling steps amplify it)")
    if not err <= E2E_F32_TOL:
        fail("float32 CUDA and CPU disagree")
    del gpu, cpu
    return err


# -- ToMe merge events: plans and score margins ---------------------------------

def match_margin(metric, r):
    """The smallest score margin behind one merge plan, over the batch: the
    gap between the last merged source's best score and the first kept
    one's, and each merged source's gap between its best and second-best
    partner.  A near-zero margin is where two devices may pick other
    tokens."""
    m = metric.float()
    m = m / torch.linalg.vector_norm(m, dim=-1, keepdim=True)
    scores = m[:, ::2] @ m[:, 1::2].transpose(-1, -2)
    top2 = scores.topk(2, dim=-1).values
    best, order = top2[..., 0].sort(dim=-1, descending=True)
    margin = torch.gather(top2[..., 0] - top2[..., 1], 1, order[:, :r]).min()
    if r < best.shape[1]:
        margin = torch.minimum(margin, (best[:, r - 1] - best[:, r]).min())
    return float(margin.detach())


@contextlib.contextmanager
def recorded_merge_events():
    """Within the block every merge event of the ToMe stack appends (merged
    sources, their destinations, smallest score margin) to the list
    yielded."""
    from multi_modal_transformers_tokenmerge_torch.modules import tome_stack
    original = tome_stack.bipartite_soft_matching
    events = []

    def recording(metric, r, **kw):
        plan = original(metric, r, **kw)
        events.append((plan.src_idx.cpu(), plan.dst_idx.cpu(),
                       match_margin(metric, r)))
        return plan

    tome_stack.bipartite_soft_matching = recording
    try:
        yield events
    finally:
        tome_stack.bipartite_soft_matching = original


@contextlib.contextmanager
def recorded_relu_signs(model):
    """Within the block every MLP of the transformer appends the signs of
    its ReLU inputs (the output of ``dense_in`` > 0, on the CPU) to the list
    yielded, in the order the blocks run."""
    signs = []
    hooks = [m.register_forward_hook(
                 lambda _m, _i, out: signs.append((out > 0).cpu()))
             for n, m in model.transformer.named_modules()
             if n.endswith("dense_in")]
    try:
        yield signs
    finally:
        for h in hooks:
            h.remove()


@contextlib.contextmanager
def fixed_keep_masks(masks):
    """Within the block the dropout sites take ``masks`` in turn instead of
    drawing their keep masks."""
    from multi_modal_transformers_tokenmerge_torch.modules import layers
    original = layers.keep_mask
    queue = list(masks)
    layers.keep_mask = lambda shape, p, g, device: queue.pop(0).to(device)
    try:
        yield
    finally:
        layers.keep_mask = original


def compare_merge_events(got, want, label):
    """Log each merge event's margins on both devices and whether both
    merged the same tokens; returns the number of events that differ."""
    if len(got) != len(want):
        fail(f"{label}: {len(got)} merge events on the card, {len(want)} on "
             f"the CPU")
    def pairs(src, dst):
        """(source, destination) pairs in source order: the rank of two
        merged sources among themselves changes nothing."""
        order = src.argsort(dim=1)
        return torch.cat([src.gather(1, order), dst.gather(1, order)], -1)

    flips = 0
    for i, ((s1, d1, m1), (s2, d2, m2)) in enumerate(zip(got, want)):
        same = torch.equal(pairs(s1, d1), pairs(s2, d2))
        flips += not same
        log(f"    merge event {i}: {s1.shape[1]} tokens merged in each of "
            f"{s1.shape[0]} examples, smallest score margin cuda {m1:.3e}, "
            f"cpu {m2:.3e}; same tokens merged on both devices: {same}")
    return flips


# -- phase 10: octo_deep float32, CUDA vs CPU ------------------------------------

def tome_reference_phase(cfg32, counters, label="octo_deep",
                         flash="flash_fwd"):
    """octo_deep (or another ToMe configuration, named ``label``) in
    float32 on the card (kernels) against the CPU (plain versions): the
    same weights, inputs and noise.  Which tokens merge is a
    discrete choice, so every event's plan is compared and its smallest
    score margin printed beside the output difference; the same request in
    bfloat16 is the planted fault the limit must see.  ``flash``: the
    forward kernel its blocks launch (one a block and request)."""
    from multi_modal_transformers_tokenmerge_torch.models.octo import Octo
    gpu = Octo(cfg32, device="cuda", seed=3).eval()
    cpu = Octo(cfg32, device="cpu", seed=None).eval()
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    fault = Octo(cfg32.replace(dtype="bfloat16"), device="cuda",
                 seed=None).eval()
    fault.load_state_dict(gpu.state_dict())
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
    outs, events = {}, {}
    for name, model in (("cuda", gpu), ("cuda_bf16_fault", fault),
                        ("cpu", cpu)):
        on = lambda x: x.to(model.device)
        before = {k: c.launches for k, c in counters.items()}
        with recorded_merge_events() as events[name], \
                torch.inference_mode():
            outs[name] = model.predict_diffusion_action(
                on(ids), on(images), noisy=on(noisy),
                noise=on(noise)).float().cpu()
        if name == "cuda":
            launched = {k: c.launches - before[k]
                        for k, c in counters.items() if c.launches
                        != before[k]}
    blocks = cfg32.transformer.num_blocks
    if launched != {flash: blocks, "ddpm_sampler": 1}:
        fail(f"the float32 CUDA request of {label} launched {launched}")
    flips = compare_merge_events(events["cuda"], events["cpu"],
                                 f"{label} f32 request")
    err = (outs["cuda"] - outs["cpu"]).abs().max().item()
    err_fault = (outs["cuda_bf16_fault"] - outs["cpu"]).abs().max().item()
    log(f"  {label} f32 predict_diffusion_action B={b}: |cuda-cpu|="
        f"{err:.3e} (tol {E2E_F32_TOL:g}), {flips} of "
        f"{len(events['cuda'])} merge events chose other tokens; the same "
        f"request in bfloat16 (planted fault): {err_fault:.3e}")
    if not err <= E2E_F32_TOL:
        fail(f"{label}: float32 CUDA and CPU disagree"
             + (f" ({flips} merge events chose other tokens; see their "
                f"margins)" if flips else ""))
    if not err_fault > E2E_F32_TOL:
        fail(f"the planted bfloat16 fault passes {label}'s float32 limit")
    del gpu, cpu, fault
    return dict(err=err, fault_err=err_fault, flipped_events=flips,
                merge_events=len(events["cuda"]),
                smallest_margin=min(m for _, _, m in events["cuda"]))


# -- phase 5: profile ----------------------------------------------------------

def profile_phase(model, cfg, request_ms, label="octo_base bf16",
                  fname="profile_b1.txt"):
    from multi_modal_transformers_tokenmerge_torch.serve.policy import (
        PolicyEngine)
    eng = PolicyEngine(model, batch_size=1, seed=2)
    eng.set_instruction(np.arange(cfg.text.max_length))
    images = torch.zeros(1, cfg.num_observation_blocks,
                         *cfg.images.image_size, device="cuda")
    for _ in range(3):
        eng(images)
    n = 5

    def requests():
        t0 = time.perf_counter()
        for _ in range(n):
            eng(images)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    prof, wall = profile_session(requests, with_host=True)
    # device-side events only: host ops also report the time of the
    # kernels they launched
    events = device_events(prof)
    busy = sum(e.self_device_time_total for e in events) / 1e3 / n
    log(f"  profile {label} B=1, {n} requests: device kernels "
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
    with open(os.path.join(OUT_DIR, fname), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=60))
    return {"device_ms": busy, "idle_share": max(0.0, 1 - busy / request_ms),
            "launches": sum(e.count for e in events) / n}


# -- phase 6: training -------------------------------------------------------

TRAIN_BATCH = 32
TRAIN_WARMUP = 3
TRAIN_STEPS = 60        # the timed window of fit
TRAIN_SYNCED = 60       # then steps that each end in a synchronize
DEEP_TRAIN_STEPS = 30   # octo_deep: window and synced steps


def train_config(dtype):
    from multi_modal_transformers_tokenmerge_torch.models.presets import (
        octo_base)
    cfg = octo_base(dtype=dtype)
    return cfg.replace(
        transformer=cfg.transformer.replace(attention_impl="flash"),
        images=cfg.images.replace(resnet=cfg.images.resnet.replace(
            pool_vjp="pallas")))


def device_batches(cfg, batch, count, seed):
    """``count`` synthetic batches made at once and moved to the card."""
    from multi_modal_transformers_tokenmerge_torch.utils.data import (
        synthetic_octo_batches)
    it = synthetic_octo_batches(
        batch, image_shape=(cfg.num_observation_blocks,
                            *cfg.images.image_size),
        text_length=cfg.text.max_length,
        action_dim=cfg.heads.diffusion.action_space_dim,
        vocab_size=cfg.text.vocab_size, seed=seed)
    return [tuple(torch.as_tensor(a).cuda() for a in next(it))
            for _ in range(count)]


def deep_config(dtype, **transformer):
    """octo_deep with the flash forward that saves no LSE and the recompute
    backward in every block of its three stages (attention dropout 0: the
    pairing refuses weight dropout), and the max-pool backward kernel."""
    from multi_modal_transformers_tokenmerge_torch.models.presets import (
        octo_deep)
    cfg = octo_deep(dtype=dtype)
    tr = cfg.transformer
    return cfg.replace(
        transformer=tr.replace(
            attention_impl="flash", flash_backward="xla",
            attention=tr.attention.replace(dropout_rate=0.0), **transformer),
        images=cfg.images.replace(resnet=cfg.images.resnet.replace(
            pool_vjp="pallas")))


def deep_pallas_config(dtype):
    """octo_deep as its preset sets attention: the flash forward with LSE
    and the dq and dk/dv kernels in every block of its three stages, with
    the preset's attention dropout (0.1) drawn in the kernels; and the
    max-pool backward kernel."""
    from multi_modal_transformers_tokenmerge_torch.models.presets import (
        octo_deep)
    cfg = octo_deep(dtype=dtype)
    return cfg.replace(
        transformer=cfg.transformer.replace(attention_impl="flash",
                                            flash_backward="pallas"),
        images=cfg.images.replace(resnet=cfg.images.resnet.replace(
            pool_vjp="pallas")))


def train_phase(cfg, train_counters, label="octo_base", per_step=None,
                window_steps=TRAIN_STEPS, synced_count=TRAIN_SYNCED):
    """A bf16 model through make_optimizer -> create_train_state -> fit
    at batch 32: ms/step, finite loss, every kernel's launches per step
    (``per_step``: kernel -> launches a step, 0 for one it does not name).

    ms/step is one window of fit timed as fit runs it, with a single
    synchronize at its end (fit waits for the device only when it logs);
    the median and p90 of single steps, each ending in a synchronize, are
    reported beside it."""
    import itertools
    from multi_modal_transformers_tokenmerge_torch.models.octo import Octo
    from multi_modal_transformers_tokenmerge_torch.train.loop import (
        fit, to_device)
    from multi_modal_transformers_tokenmerge_torch.train.optim import (
        make_optimizer)
    from multi_modal_transformers_tokenmerge_torch.train.state import (
        create_train_state)
    from multi_modal_transformers_tokenmerge_torch.train.steps import (
        make_train_step)
    model = Octo(cfg, device="cuda", seed=0)
    steps = TRAIN_WARMUP + window_steps + synced_count
    if per_step is None:
        per_step = {"flash_fwd_lse": cfg.transformer.num_blocks,
                    "flash_dq": cfg.transformer.num_blocks,
                    "flash_dkv": cfg.transformer.num_blocks, "pool_bwd": 1}
    tx = make_optimizer(peak_lr=3e-4, warmup_steps=10, total_steps=steps,
                        params=model, frozen_prefixes=("text_encoder",))
    state = create_train_state(model, tx, rngs=0)
    batches = itertools.cycle(device_batches(cfg, TRAIN_BATCH, 4, seed=1))
    logged = []

    class Logger:
        def log(self, metrics, step):
            logged.append((step, metrics))

    step = make_train_step("diffusion", jit=False)

    def synced_steps(count):
        out = []
        for _ in range(count):
            torch.cuda.synchronize()
            t = time.perf_counter()
            step(state, *to_device(next(batches), "cuda"))
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t) * 1e3)
        return np.array(out)

    torch.cuda.reset_peak_memory_stats()
    for c in train_counters.values():
        c.launches = 0
    warm = synced_steps(TRAIN_WARMUP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = fit(state, batches, "diffusion", window_steps, logger=Logger(),
                log_every=10, step_fn=step)
    torch.cuda.synchronize()
    window = (time.perf_counter() - t0) * 1e3
    synced = synced_steps(synced_count)
    launches = {k: c.launches for k, c in train_counters.items()}
    for k, count in launches.items():
        if count != steps * per_step.get(k, 0):
            fail(f"{label} training launched {k} {count} times in {steps} "
                 f"steps; expected {steps * per_step.get(k, 0)}")
    ms_per_step = window / window_steps
    mean = float(synced.mean())
    med = float(np.median(synced))
    p90 = float(np.percentile(synced, 90))
    losses = [m["loss"] for _, m in logged]
    if state.step != steps or not all(np.isfinite(losses)):
        fail(f"training: {state.step} steps, windowed losses {losses}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  train {label} bf16 B={TRAIN_BATCH}: warm-up "
        f"{[round(float(t), 1) for t in warm]} ms; fit, {window_steps} steps "
        f"in {window:.2f} ms: {ms_per_step:.4f} ms/step; then "
        f"{len(synced)} steps each ending in a synchronize: mean "
        f"{mean:.4f} ms, median {med:.4f}, p90 {p90:.4f}, min "
        f"{synced.min():.4f}, max "
        f"{synced.max():.4f}; peak memory {peak:.2f} GiB")
    log(f"  windowed loss {[round(x, 4) for x in losses]}; grad_norm "
        f"{[round(m['grad_norm'], 3) for _, m in logged]}")
    log(f"  launches in {steps} steps: {launches}")
    return state, dict(ms_per_step=ms_per_step, window_steps=window_steps,
                       synced_mean_ms=mean, synced_median_ms=med,
                       synced_p90_ms=p90,
                       synced_steps=len(synced), peak_gib=peak), launches


# -- phase 7: float32 training step, CUDA vs CPU --------------------------------

# |cuda - cpu| of each gradient leaf, in units of the leaf's largest |value|:
# downstream of the max-pool (flash kernels, heads) the sums only run in
# another order; the image tower's leaves also see the pool's argmax flip
# where the conv outputs of the two devices order a near-tie differently
# (1.3e-3 the most seen).  A planted fault, the same step computed in
# bfloat16, must read above every limit, or the limits could not see it.
# octo_deep, 12 blocks: its 16 million ReLU inputs a step (448 tokens x 3072
# units x 12 blocks) hold a few that sit within rounding of zero, where the
# two devices take other sides of the step: each such unit moves its row of
# dense_in's gradient by about one token's share (1.3e-2 of the leaf's
# largest value seen, with the loss equal to 1.7e-6 and every merge plan the
# same).  The phase counts the ReLU inputs whose sign differs between the
# devices and prints the count beside the errors.  The max-error limits are
# set between that and the planted fault (3.1e-1 in the image tower, 7.8e-1
# elsewhere); the relative L2 error of a leaf, which a few moved rows barely
# touch, is held beside them.
# model -> limits on a gradient leaf: max |cuda - cpu| over its largest
# |value| outside (rest) and inside (image) the image tower, and the relative
# L2 error (None: not held)
TRAIN_REF_LIMITS = {
    "octo_base": dict(rest=1e-3, image=3e-3, l2=None),
    "octo_deep": dict(rest=5e-2, image=1e-2, l2=5e-3),
    # phase 21: octo_base with a three-block denoiser and GELU MLPs; the
    # same image tower and pool as octo_base, smooth activations after it,
    # so octo_base's limits
    "octo_base_3block_gelu": dict(rest=1e-3, image=3e-3, l2=None),
    # phase 24: octo_base with MoE MLPs: the same image tower, pool and
    # inputs as octo_base, the same max-pool argmax near-ties (seen: 3.2e-3
    # on input_conv.weight, the leaf below the pool, 4.8e-5 above it; other
    # gradients reach the flipped positions than octo_base's), so octo_deep's
    # image limit, which answers the same flips; octo_base's for the rest
    "octo_base_moe": dict(rest=1e-3, image=1e-2, l2=None),
    # phase 31: octo_deep with 6 heads of 128: octo_deep's image tower,
    # blocks, MLPs and merges (the same ReLU near-ties), so its limits
    "octo_deep_h128": dict(rest=5e-2, image=1e-2, l2=5e-3),
    # phase 33: octo_deep with 3 heads of 512: the same image tower, MLPs
    # and merges, wider attention projections, so octo_deep's limits
    "octo_deep_h512": dict(rest=5e-2, image=1e-2, l2=5e-3),
}


class RecordingOptimizer:
    """Stands in for the optimizer in phase 7: records the gradients."""

    def __init__(self):
        self.grads = None

    def init(self, named_params):
        pass

    def step(self, params, grads):
        self.grads = {n: None if g is None else g.detach().float().cpu()
                      for n, g in grads.items()}


def train_reference_phase(cfg, counters, label, expected):
    """One float32 step of ``cfg`` with every configured dropout at 0: the
    CUDA kernels against the CPU plain versions on the same weights and
    draws (the time encoder's fixed 0.1 dropout gets the same keep masks).
    The same step in bfloat16 on the card is the planted fault.
    ``expected``: kernel -> launches of the CUDA step (0 where not named).
    Each run also records the plan of every ToMe merge event and the sign
    of every ReLU input of the transformer.  Each gradient leaf is held to
    ``TRAIN_REF_LIMITS[label]``."""
    from multi_modal_transformers_tokenmerge_torch.models.octo import Octo
    from multi_modal_transformers_tokenmerge_torch.ops.image_ops import (
        position_interval_bounds)
    from multi_modal_transformers_tokenmerge_torch.train.state import (
        create_train_state)
    from multi_modal_transformers_tokenmerge_torch.train.steps import (
        make_train_step)
    limits = TRAIN_REF_LIMITS[label]
    rest_tol, image_tol, l2_tol = (limits[k] for k in ("rest", "image", "l2"))
    tr = cfg.transformer
    cfg = cfg.replace(
        transformer=tr.replace(dropout_rate=0.0, attention=tr.attention
                               .replace(dropout_rate=0.0)),
        heads=cfg.heads.replace(diffusion=cfg.heads.diffusion.replace(
            dropout_rate=0.0)))
    gpu = Octo(cfg, device="cuda", seed=3)
    cpu = Octo(cfg, device="cpu", seed=None)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    fault = Octo(cfg.replace(dtype="bfloat16"), device="cuda", seed=None)
    fault.load_state_dict(gpu.state_dict())
    rng = np.random.default_rng(6)
    b = 2
    ids, images, actions = device_batches(cfg, b, 1, seed=6)[0]
    img, d = cfg.images, cfg.heads.diffusion
    rs, rp, cs, cp = position_interval_bounds(img.image_size[0],
                                              img.patch_size,
                                              img.position_interval)
    shape = (b, cfg.num_observation_blocks, rs.shape[0])
    draws = {"positions": tuple(torch.from_numpy(rng.integers(
                 lo, np.maximum(hi, lo + 1), shape)) for lo, hi in
                 ((rs, rp), (cs, cp))),
             "time": torch.from_numpy(rng.integers(0, d.diffusion_steps,
                                                   (b, 1))),
             "noise": torch.from_numpy(rng.normal(
                 size=(b, d.action_space_dim)).astype(np.float32))}
    # the dropout sites of fixed rate 0.1, in the order they run: the time
    # encoder's MLP, then each tail block of a multi-block denoiser
    sites = [d.mlp_dim, d.time_dim]
    for i in range(1, d.num_blocks):
        sites += [d.mlp_dim,
                  d.action_space_dim if i == d.num_blocks - 1 else d.mlp_dim]
    masks = [torch.from_numpy(rng.random((b, n)) < 0.9) for n in sites]
    results = {}
    launched = None
    plans, signs = {}, {}
    for name, model in (("cuda", gpu), ("cuda_bf16_fault", fault),
                        ("cpu", cpu)):
        dev = model.device
        rec = RecordingOptimizer()
        state = create_train_state(model, rec, rngs=0)
        on = lambda t: t.to(dev)
        step = make_train_step("diffusion", jit=False)
        before = {k: c.launches for k, c in counters.items()}
        with recorded_merge_events() as plans[name], \
                recorded_relu_signs(model) as signs[name], \
                fixed_keep_masks(masks):
            _, loss = step(state, on(ids), on(images), on(actions),
                           draws={"positions": tuple(map(
                               on, draws["positions"])),
                               "time": on(draws["time"]),
                               "noise": on(draws["noise"])})
        if name == "cuda":
            launched = {k: c.launches - before[k]
                        for k, c in counters.items()}
        results[name] = (float(loss), rec.grads)
    if launched != {k: expected.get(k, 0) for k in counters}:
        fail(f"the float32 CUDA step of {label} launched {launched}; "
             f"expected {expected}")
    flips = compare_merge_events(plans["cuda"], plans["cpu"],
                                 f"{label} f32 train step")
    relu_flips = {name: sum(int((a != b).sum()) for a, b in
                            zip(signs[name], signs["cpu"]))
                  for name in ("cuda", "cuda_bf16_fault")}
    relu_inputs = sum(a.numel() for a in signs["cpu"])
    if [a.shape for a in signs["cuda"]] != [a.shape for a in signs["cpu"]]:
        fail(f"{label}: the MLPs saw other shapes on the card than on the "
             f"CPU")
    l_cpu, g_cpu = results["cpu"]
    largest = max(float(g.abs().max()) for g in g_cpu.values()
                  if g is not None)

    def leaf_errors(g_gpu):
        """gradient name -> max |cuda - cpu| / the leaf's largest |value|,
        and the largest |cuda - cpu|_2 / |cpu|_2 over the leaves"""
        out = {}
        l2 = 0.0
        for n, want in g_cpu.items():
            got = g_gpu[n]
            if want is None or got is None:
                if (want is None) != (got is None):
                    fail(f"gradient {n} present on one device only")
                continue
            if n.endswith(".key.bias"):
                # mathematically zero: both hold rounding noise
                out[n] = max(float(want.abs().max()),
                             float(got.abs().max())) / largest
            else:
                out[n] = float((got - want).abs().max()) / max(
                    float(want.abs().max()), 1e-30)
                l2 = max(l2, float(torch.linalg.vector_norm(got - want))
                         / max(float(torch.linalg.vector_norm(want)), 1e-30))
        return out, l2

    report = {}
    for name in ("cuda", "cuda_bf16_fault"):
        l_gpu, g_gpu = results[name]
        errs, l2 = leaf_errors(g_gpu)
        image = max(v for n, v in errs.items()
                    if n.startswith("image_encoder."))
        rest = max(v for n, v in errs.items()
                   if not n.startswith("image_encoder."))
        top = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
        loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
        report[name] = dict(loss_rel=loss_rel, image_tower=image,
                            rest=rest, l2=l2, relu_sign_flips=relu_flips[name],
                            relu_inputs=relu_inputs)
        log(f"  {label} f32 train step B={b}, {name} vs cpu: loss "
            f"{l_gpu:.6f} vs {l_cpu:.6f} (rel {loss_rel:.2e}); largest "
            f"gradient error of a leaf, relative to its largest |value|: "
            f"image tower {image:.2e} (limit {image_tol:g}), the rest "
            f"{rest:.2e} (limit {rest_tol:g}); largest relative L2 error of "
            f"a leaf {l2:.2e}"
            + (f" (limit {l2_tol:g})" if l2_tol else "") + f"; "
            f"{relu_flips[name]} of {relu_inputs} MLP activation inputs "
            f"(dense_in outputs) of the transformer have another sign than "
            f"on the CPU; worst "
            f"{[(n, f'{v:.1e}') for n, v in top]}")
    r = report["cuda"]
    r["merge_events"] = len(plans["cuda"])
    r["flipped_events"] = flips
    if not (r["loss_rel"] <= 1e-4 and r["rest"] <= rest_tol
            and r["image_tower"] <= image_tol
            and (l2_tol is None or r["l2"] <= l2_tol)):
        fail(f"float32 CUDA and CPU training steps of {label} disagree"
             + (f" ({flips} merge events chose other tokens)" if flips
                else ""))
    r = report["cuda_bf16_fault"]
    if not (r["image_tower"] > image_tol and r["rest"] > rest_tol
            and (l2_tol is None or r["l2"] > l2_tol)):
        fail("the planted bfloat16 fault passes the float32 limits")
    del gpu, cpu, fault
    return report


# -- phase 8: training profile ---------------------------------------------------

def train_profile_phase(state, cfg, step_ms, kernel_names,
                        label="octo_base", fname="profile_train.txt"):
    import itertools
    from multi_modal_transformers_tokenmerge_torch.train.loop import fit
    from multi_modal_transformers_tokenmerge_torch.train.steps import (
        make_train_step)
    batches = itertools.cycle(device_batches(cfg, TRAIN_BATCH, 2, seed=2))
    step = make_train_step("diffusion", jit=False)
    fit(state, batches, "diffusion", 2, step_fn=step)
    n = 5
    prof, _ = profile_session(lambda: fit(state, batches, "diffusion", n,
                                          step_fn=step), with_host=True)
    events = device_events(prof)
    busy = sum(e.self_device_time_total for e in events) / 1e3 / n
    idle = max(0.0, 1 - busy / step_ms)
    ours = {k: sum(e.self_device_time_total for e in events
                   if f"{k}_kernel" in e.key) / 1e3 / n for k in kernel_names}
    log(f"  profile {label} bf16 train step B={TRAIN_BATCH}, {n} steps: "
        f"device kernels {busy:.4f} ms/step; against the unprofiled fit "
        f"window's {step_ms:.4f} ms/step the device idle share is "
        f"{idle:.3f}; "
        f"{sum(e.count for e in events) / n:.0f} kernel launches per step")
    log(f"  the port's kernels, ms/step on the device: "
        f"{ {k: round(v, 4) for k, v in ours.items()} } "
        f"({sum(ours.values()) / busy:.3f} of device time)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"    {e.self_device_time_total / 1e3 / n:8.4f} ms/step "
            f"x{e.count / n:5.1f}  {e.key[:90]}")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, fname), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=80))
    return dict(device_ms=busy, idle_share=idle, kernels_ms=ours,
                launches=sum(e.count for e in events) / n)


# -- phases 15-17: CUDA graphs ----------------------------------------------------

COMPILED_REQUESTS = 100     # per turn of the eager / compiled latency turns
COMPILED_TRAIN_CHECK = 5    # steps held captured against eager
COMPILED_TRAIN_WINDOW = 30  # steps per turn of the eager / compiled fit turns


WIDE_KERNELS = ("flash_fwd_wide", "flash_fwd_lse_wide", "flash_dq_wide",
                "flash_dkv_wide")


def replay_profile(fn, calls, expected, label):
    """One profiled session of ``calls`` calls of ``fn`` (graph replays: no
    wrapper runs, so the ``.launches`` counters cannot see them).  The
    device records give, per call, each named kernel's launches (which
    must equal ``expected``: kernel -> launches a call, 0 for a kernel it
    does not name; 'ddpm_sampler' is the register sampler kernel here and
    'ddpm_sampler_wide' the wide one; GN_KERNELS the GroupNorm pair, by
    layout; GE_KERNELS the grouped expert kernels), all launches and the
    device time.  A session that kept too few records of a named kernel is
    run again (PROFILE_ATTEMPTS)."""
    names = ("ddpm_sampler", "ddpm_sampler_wide", "flash_fwd",
             "flash_fwd_lse", "flash_dq", "flash_dkv", *WIDE_KERNELS,
             "pool_bwd", *GN_KERNELS, *GE_KERNELS)
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        prof, _ = profile_session(lambda: [fn() for _ in range(calls)])
        events = device_events(prof)
        counts = {k: sum(e.count for e in events
                         if re.search(rf"\b{k}_kernel\b", e.key)) / calls
                  for k in names}
        if all(counts[k] == expected.get(k, 0) for k in names):
            break
        if attempt < PROFILE_ATTEMPTS:
            _GUARD["short"].append((label, counts, expected))
            log(f"  (replay of {label}: kernel records {counts}, expected "
                f"{expected}; attempt {attempt} of {PROFILE_ATTEMPTS})")
            continue
        fail(f"{label}: one replay ran the kernels {counts}; expected "
             f"{expected} (a graph that lost or swapped a kernel)")
    busy = sum(e.self_device_time_total for e in events) / 1e3 / calls
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    kernel_ms = {k: sum(e.self_device_time_total for e in events
                        if re.search(rf"\b{k}_kernel\b", e.key)) / 1e3 / calls
                 for k in names if counts[k]}
    return {"kernels": counts, "device_ms": busy, "kernel_ms": kernel_ms,
            "launches": sum(e.count for e in events) / calls,
            "top": [(round(e.self_device_time_total / 1e3 / calls, 4),
                     e.count / calls, e.key[:70]) for e in top]}


def compiled_serve_phase(models, cfg, label, expected, requests=None,
                         batches=(1, 8), engine_kw=None,
                         second_expected=None):
    """``models``: name -> model (the first the one held and profiled).  At
    each of ``batches``: an eager engine and a compiled one on the same
    weights and seed (both built with ``engine_kw``, e.g. the quantized
    towers); the compiled replay must equal the eager call bit for bit
    (the first request also against the eager call handed the same noisy
    and noise explicitly); latency of eager and compiled in turns (eager,
    compiled, compiled, eager); one profiled replay for the kernels,
    launches and device time a request.  With two models their compiled
    engines are also served in turns (first, second, second, first), and
    the second one's replay is profiled too (its kernels
    ``second_expected``, by default ``expected``).  Both hold the image
    tower's GroupNorm kernels at ``norm_kernels(cfg)`` a replay where they
    do not name them."""
    from multi_modal_transformers_tokenmerge_torch.serve.policy import (
        PolicyEngine as _Engine)
    second_expected = {**norm_kernels(cfg), **(second_expected or expected)}
    expected = {**norm_kernels(cfg), **expected}
    engine_kw = engine_kw or {}
    PolicyEngine = lambda *a, **kw: _Engine(*a, **kw, **engine_kw)
    requests = requests or COMPILED_REQUESTS
    g = np.random.default_rng(7)
    ids = g.integers(0, cfg.text.vocab_size, (cfg.text.max_length,))
    image_shape = (cfg.num_observation_blocks, *cfg.images.image_size)
    hc = cfg.heads.diffusion
    steps = hc.ddim_steps or hc.diffusion_steps
    first = next(iter(models))
    out = {}
    for batch in batches:
        row = {}
        compiled = {}
        for name, model in models.items():
            t0 = time.perf_counter()
            eng = PolicyEngine(model, batch_size=batch, seed=1)
            eng.compile((cfg.text.max_length,), image_shape)
            eng.set_instruction(ids)
            torch.cuda.synchronize()
            compiled[name] = eng
            row[f"{name}_compile_s"] = time.perf_counter() - t0
        model = models[first]
        eager = PolicyEngine(model, batch_size=batch, seed=1)
        eager.set_instruction(ids)
        comp = compiled[first]
        gen = torch.Generator(device="cuda").manual_seed(1)
        noisy = torch.randn(batch, hc.action_space_dim, generator=gen,
                            device="cuda")
        noise = torch.randn(steps, batch, hc.action_space_dim,
                            generator=gen, device="cuda")
        diffs = []
        for i in range(3):
            images = random_images(cfg, batch, g)
            got = comp(images)
            want = eager(images) if i else eager(images, noisy=noisy,
                                                 noise=noise)
            if i == 0:
                eager(images)       # the eager engine's own first draw
            diffs.append(float((got - want).abs().max()))
            if not torch.equal(got, want):
                fail(f"{label} B={batch}: request {i} of the compiled "
                     f"engine differs from the eager call by {diffs[-1]}")
        # the full path (token ids) against the eager full path
        images = random_images(cfg, batch, g)
        fresh = PolicyEngine(model, batch_size=batch, seed=3)
        comp._generator.manual_seed(3)
        if not torch.equal(comp(images, text_tokens=ids),
                           fresh(images, text_tokens=ids)):
            fail(f"{label} B={batch}: the compiled full path differs from "
                 f"the eager one")
        times = {"eager": [], "compiled": []}
        timed_requests(eager, cfg, batch, 2, g)
        timed_requests(comp, cfg, batch, 2, g)
        for name in ("eager", "compiled", "compiled", "eager"):
            eng = eager if name == "eager" else comp
            times[name] += timed_requests(eng, cfg, batch, requests // 2, g)
        row.update({name: latency(t) for name, t in times.items()})
        images = random_images(cfg, batch, g)
        prof = replay_profile(lambda: comp(images), 5, expected,
                              f"{label} B={batch} compiled request")
        prof["idle_share"] = max(0.0, 1 - prof["device_ms"]
                                 / row["compiled"]["median_ms"])
        row["replay_profile"] = prof
        log(f"  compiled {label} B={batch}: compile "
            f"{row[f'{first}_compile_s']:.2f} s; replay equals the eager "
            f"call bit for bit (max |diff| {max(diffs)}); in turns, eager "
            f"median {row['eager']['median_ms']:.4f} ms (p90 "
            f"{row['eager']['p90_ms']:.4f}), compiled median "
            f"{row['compiled']['median_ms']:.4f} ms (p90 "
            f"{row['compiled']['p90_ms']:.4f}); one replay: "
            f"{prof['launches']:.0f} launches, device "
            f"{prof['device_ms']:.4f} ms, idle share "
            f"{prof['idle_share']:.3f}, kernels "
            f"{ {k: v for k, v in prof['kernels'].items() if v} }")
        for t in prof["top"]:
            log(f"    {t[0]:8.4f} ms/request x{t[1]:5.1f}  {t[2]}")
        if len(models) > 1:
            names = list(models)
            turns = {n: [] for n in names}
            for name in (names[0], names[1], names[1], names[0]):
                turns[name] += timed_requests(compiled[name], cfg, batch,
                                              requests // 2, g)
            row["in_turns"] = {n: latency(t) for n, t in turns.items()}
            second = replay_profile(lambda: compiled[names[1]](images), 5,
                                    second_expected,
                                    f"{label} B={batch} compiled "
                                    f"{names[1]} request")
            row["replay_profile_" + names[1]] = second
            log(f"  compiled, in turns: " + ", ".join(
                f"{n} median {row['in_turns'][n]['median_ms']:.4f} ms (p90 "
                f"{row['in_turns'][n]['p90_ms']:.4f})" for n in names)
                + f"; one {names[1]} replay: {second['launches']:.0f} "
                f"launches, device {second['device_ms']:.4f} ms")
        out[batch] = row
        del compiled, comp, eager, fresh
        torch.cuda.empty_cache()
    return out


def _fresh_train_state(cfg, model_seed=0, rng_seed=0):
    from multi_modal_transformers_tokenmerge_torch.models.octo import Octo
    from multi_modal_transformers_tokenmerge_torch.train.optim import (
        make_optimizer)
    from multi_modal_transformers_tokenmerge_torch.train.state import (
        create_train_state)
    model = Octo(cfg, device="cuda", seed=model_seed)
    tx = make_optimizer(peak_lr=3e-4, warmup_steps=10, total_steps=1000,
                        params=model, frozen_prefixes=("text_encoder",))
    return create_train_state(model, tx, rngs=rng_seed)


# the captured step against the eager one, each parameter and moment leaf:
# max |captured - eager| <= GRAPH_TRAIN_TOL * max |eager leaf|.  The same
# kernels run on the same inputs, so octo_base agrees bit for bit; in
# octo_deep's backward the scatter-adds of the ToMe merge run in an order
# that changes from run to run, so two eager runs from the same state differ
# too (2.8e-14 in a moment, parameters equal, on an H100 80GB HBM3 at
# 700 W).  The phase prints both differences.
GRAPH_TRAIN_TOL = 1e-5


def leaf_diffs(a, b):
    """(largest |a - b| of a parameter, of a moment; largest of either over
    its leaf's largest |value|), between two train states."""
    pairs = [(p, b.params[n]) for n, p in a.params.items()]
    moments = list(zip((*a.optimizer.mu, *a.optimizer.nu),
                       (*b.optimizer.mu, *b.optimizer.nu)))
    diff = lambda x, y: float((x.detach().float() - y.detach().float())
                              .abs().max())
    rel = max(diff(x, y) / max(float(x.detach().float().abs().max()), 1e-30)
              for x, y in pairs + moments)
    return (max(diff(x, y) for x, y in pairs),
            max(diff(x, y) for x, y in moments), rel)


def compiled_train_phase(cfg, label, expected, twin=None):
    """The captured step (make_train_step(jit=True): one eager warm-up,
    then a CUDA graph) against the eager step: COMPILED_TRAIN_CHECK steps
    from the same state, batches and generator seeds, held to
    GRAPH_TRAIN_TOL (a second eager run from the same state shows how far
    the eager step agrees with itself).  Then fit with each in turns
    (eager, compiled, compiled, eager; COMPILED_TRAIN_WINDOW steps a turn,
    ms/step on the host clock ending in a synchronize), and one profiled
    replay: the kernels, launches and device time a step.  ``twin``:
    (name, config, expected kernels) of a second model whose compiled step
    takes turns with this one's (this, twin, twin, this) and whose replay
    is profiled beside it.  Each step holds the image tower's GroupNorm
    kernels at ``norm_kernels`` of its config where ``expected`` does not
    name them."""
    import itertools
    expected = {**norm_kernels(cfg), **expected}
    from multi_modal_transformers_tokenmerge_torch.train.loop import fit
    from multi_modal_transformers_tokenmerge_torch.train.steps import (
        make_train_step)
    batches = device_batches(cfg, TRAIN_BATCH, 4, seed=11)
    states = {"eager": _fresh_train_state(cfg),
              "compiled": _fresh_train_state(cfg),
              "eager_again": _fresh_train_state(cfg)}
    eager_step = make_train_step("diffusion", jit=False)
    steps = {"eager": eager_step, "eager_again": eager_step,
             "compiled": make_train_step("diffusion")}
    for name, state in states.items():
        for i in range(COMPILED_TRAIN_CHECK):
            steps[name](state, *batches[i % len(batches)])
    torch.cuda.synchronize()
    a, b = states["eager"], states["compiled"]
    if "graph" not in next(iter(steps["compiled"]._graphs[b].values())):
        fail(f"{label}: the compiled step captured no graph")
    p_diff, m_diff, rel = leaf_diffs(a, b)
    p_self, m_self, rel_self = leaf_diffs(a, states.pop("eager_again"))
    exact = p_diff == 0 and m_diff == 0
    same = (rel <= GRAPH_TRAIN_TOL
            and torch.equal(a.optimizer.count, b.optimizer.count)
            and a.step == b.step)
    log(f"  compiled {label} step: after {COMPILED_TRAIN_CHECK} steps the "
        f"captured and eager runs differ by {p_diff} (parameters) and "
        f"{m_diff} (moments), {rel:.2e} of a leaf's largest value (limit "
        f"{GRAPH_TRAIN_TOL}); {'bit for bit' if exact else 'not bit for bit'}"
        f"; two eager runs differ by {p_self} and {m_self} ({rel_self:.2e})"
        f"; count {int(b.optimizer.count)}, step {b.step}")
    if not same:
        fail(f"{label}: the captured step's state differs from the eager "
             f"step's")
    cycle = itertools.cycle(batches)
    ms = {"eager": [], "compiled": []}
    for name in ("eager", "compiled", "compiled", "eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit(states[name], cycle, "diffusion", COMPILED_TRAIN_WINDOW,
            step_fn=steps[name], logger=_NullLogger(), log_every=10)
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t0) * 1e3
                        / COMPILED_TRAIN_WINDOW)
    batch = batches[0]
    prof = replay_profile(lambda: steps["compiled"](b, *batch), 3, expected,
                          f"{label} compiled train step")
    eager_prof = replay_profile(lambda: steps["eager"](a, *batch), 3,
                                expected, f"{label} eager train step")
    row = {"max_param_diff": p_diff, "max_moment_diff": m_diff,
           "max_leaf_rel_diff": rel, "bit_for_bit": exact,
           "eager_vs_eager": [p_self, m_self, rel_self],
           "eager_ms_per_step": ms["eager"],
           "compiled_ms_per_step": ms["compiled"],
           "replay_profile": prof, "eager_profile": eager_prof}
    c_ms = statistics.mean(ms["compiled"])
    e_ms = statistics.mean(ms["eager"])
    prof["idle_share"] = max(0.0, 1 - prof["device_ms"] / c_ms)
    eager_prof["idle_share"] = max(0.0, 1 - eager_prof["device_ms"] / e_ms)
    log(f"  {label} bf16 B={TRAIN_BATCH}, fit in turns ({COMPILED_TRAIN_WINDOW}"
        f" steps a turn): eager {[round(x, 4) for x in ms['eager']]} ms/step, "
        f"compiled {[round(x, 4) for x in ms['compiled']]} ms/step; one "
        f"replay: {prof['launches']:.0f} launches, device "
        f"{prof['device_ms']:.4f} ms, idle share {prof['idle_share']:.3f}, "
        f"kernels { {k: v for k, v in prof['kernels'].items() if v} }; "
        f"eager step: {eager_prof['launches']:.0f} launches, device "
        f"{eager_prof['device_ms']:.4f} ms, idle share "
        f"{eager_prof['idle_share']:.3f}")
    for t in prof["top"]:
        log(f"    {t[0]:8.4f} ms/step x{t[1]:5.1f}  {t[2]}")
    log(f"    the port's kernels, ms/step: "
        f"{ {k: round(v, 4) for k, v in prof['kernel_ms'].items()} }")
    if twin is not None:
        twin_name, twin_cfg, twin_expected = twin
        twin_expected = {**norm_kernels(twin_cfg), **twin_expected}
        del states["eager"]
        states[twin_name] = _fresh_train_state(twin_cfg)
        steps[twin_name] = make_train_step("diffusion")
        for i in range(2):      # warm-up, then the capture
            steps[twin_name](states[twin_name], *batches[i])
        turns = {"compiled": [], twin_name: []}
        for name in ("compiled", twin_name, twin_name, "compiled"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fit(states[name], cycle, "diffusion", COMPILED_TRAIN_WINDOW,
                step_fn=steps[name], logger=_NullLogger(), log_every=10)
            torch.cuda.synchronize()
            turns[name].append((time.perf_counter() - t0) * 1e3
                               / COMPILED_TRAIN_WINDOW)
        twin_prof = replay_profile(
            lambda: steps[twin_name](states[twin_name], *batch), 3,
            twin_expected, f"{twin_name} compiled train step")
        row["twin_turns_ms_per_step"] = turns
        row["twin_replay_profile"] = twin_prof
        log(f"  compiled, in turns with {twin_name}: {label} "
            f"{[round(x, 4) for x in turns['compiled']]} ms/step, {twin_name} "
            f"{[round(x, 4) for x in turns[twin_name]]} ms/step; one "
            f"{twin_name} replay: {twin_prof['launches']:.0f} launches, device "
            f"{twin_prof['device_ms']:.4f} ms")
    del states, steps
    torch.cuda.empty_cache()
    return row


class _NullLogger:
    def log(self, metrics, step):
        pass


# the synchronous save of the octo_base bf16 train state (0.72 GiB) that fit
# waited for at every save before saves were asynchronous (PERF.md section
# 5; NVIDIA H100 80GB HBM3, 700 W)
SYNC_SAVE_S = 1.33


def checkpoint_phase(cfg, k=3, batch=8):
    """On the card, with asynchronous saves: k captured steps, a save, and
    2 more captured steps run while the writer writes; the stall of
    ``save`` (what ``fit`` waits for at each save, against SYNC_SAVE_S) and
    the time until the save lands (``wait``).  The run then equals an
    unbroken run of k + 2 steps; a restore into a fresh state (other
    weights and generator seeds) equals a run of k steps (parameters,
    moments, count, generator states, bit for bit), and 2 more compiled
    steps of it (a warm-up, then a new capture and its replay) equal the
    unbroken run.  Then compiled ``fit`` with ``checkpoint_every=1``, whose
    first save's writer copies to the host while the step is captured,
    equals ``fit`` without saves bit for bit."""
    import tempfile
    from multi_modal_transformers_tokenmerge_torch.train.checkpoint import (
        CheckpointManager)
    from multi_modal_transformers_tokenmerge_torch.train.loop import fit
    from multi_modal_transformers_tokenmerge_torch.train.steps import (
        make_train_step)
    batches = device_batches(cfg, batch, k + 2, seed=13)
    step = make_train_step("diffusion")
    unbroken, at_k = _fresh_train_state(cfg, 0, 5), _fresh_train_state(cfg,
                                                                        0, 5)
    for i, bt in enumerate(batches):
        step(unbroken, *bt)
        if i < k:
            step(at_k, *bt)

    def equal(a, b):
        diff, moments, _ = leaf_diffs(a, b)
        return (diff == 0 and moments == 0 and a.step == b.step
                and torch.equal(a.optimizer.count, b.optimizer.count)
                and all(torch.equal(g.get_state(), b.rngs[n].get_state())
                        for n, g in a.rngs.items())), diff

    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, max_to_keep=1)
        first = _fresh_train_state(cfg, 0, 5)
        for bt in batches[:k]:
            step(first, *bt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(first.step, first)
        stall_s = time.perf_counter() - t0
        for bt in batches[k:]:
            step(first, *bt)
        in_flight = mgr._writer is not None and mgr._writer.is_alive()
        mgr.wait()
        landed_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)
                   if f.endswith(".pt"))
        fresh = _fresh_train_state(cfg, 9, 9)
        t0 = time.perf_counter()
        mgr.restore(fresh)
        restore_s = time.perf_counter() - t0
        mgr.close()
    torch.cuda.synchronize()
    restored_ok, restored_diff = equal(fresh, at_k)
    ran_on_ok, _ = equal(first, unbroken)
    del first, at_k
    for bt in batches[k:]:
        step(fresh, *bt)
    torch.cuda.synchronize()
    captured = "graph" in next(iter(step._graphs[fresh].values()))
    resumed_ok, diff = equal(fresh, unbroken)
    log(f"  asynchronous save at step {k} ({size / 2 ** 30:.2f} GiB): "
        f"save() returned in {stall_s:.4f} s (the synchronous save: "
        f"{SYNC_SAVE_S} s), landed {landed_s:.2f} s after it began, 2 "
        f"steps run meanwhile (the writer still busy after them: "
        f"{in_flight}); the run after them equals the unbroken run: "
        f"{ran_on_ok}; restored in {restore_s:.2f} s into a fresh state, "
        f"bit for bit with the state at step {k}: {restored_ok} (largest "
        f"parameter difference {restored_diff}); 2 more compiled steps "
        f"(captured anew: {captured}): max parameter difference from the "
        f"unbroken run {diff}")
    if not (restored_ok and ran_on_ok and resumed_ok and captured):
        fail("the checkpoint or the resumed compiled run differs")
    del fresh, unbroken
    torch.cuda.empty_cache()
    plain = _fresh_train_state(cfg, 0, 5)
    fit(plain, iter(batches), "diffusion", len(batches))
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, max_to_keep=1)
        saved = _fresh_train_state(cfg, 0, 5)
        t0 = time.perf_counter()
        fit(saved, iter(batches), "diffusion", len(batches),
            checkpointer=mgr, checkpoint_every=1)
        fit_saving_s = time.perf_counter() - t0
        saves = mgr.all_steps()
    torch.cuda.synchronize()
    fit_ok, fit_diff = equal(saved, plain)
    log(f"  compiled fit over {len(batches)} steps saving every step (the "
        f"first save's writer copying while the step is captured) in "
        f"{fit_saving_s:.2f} s, last save at step {saves}: equal to fit "
        f"without saves: {fit_ok} (largest parameter difference "
        f"{fit_diff})")
    if not fit_ok or saves != [len(batches)]:
        fail("compiled fit saving every step differs from fit without "
             "saves")
    return {"k": k, "batch": batch, "bytes": size, "save_stall_s": stall_s,
            "landed_s": landed_s, "in_flight_after_2_steps": in_flight,
            "sync_save_s": SYNC_SAVE_S, "restore_s": restore_s,
            "max_param_diff": diff, "fit_saving_every_step_equal": fit_ok,
            "fit_saving_every_step_s": fit_saving_s}


# -- phases 18-21: configs and the CLI, the server, the closed loop, and ----
# -- what the model refused before -------------------------------------------

SERVER_BATCH = 8
SERVER_WAIT_MS = 2.0
SERVER_CLOSED_REQUESTS = 100   # one client, after three warm-up requests
SERVER_LOAD_REQUESTS = 200     # per load point
SERVER_LOADS = (0.3, 0.6, 0.9)  # of the batch capacity the closed loop gives
CLOSED_LOOP_BATCH = 8
# octo_base as the YAML config gives it, and the configuration the port
# refused before: a three-block denoiser and GELU MLPs, from overrides
YAML_OVERRIDES = ["dtype=bfloat16"]
REFUSED_OVERRIDES = ["heads.diffusion.num_blocks=3",
                     "transformer.mlp_activation=gelu"]
# the attention probes of octo_deep, float32 on the card against the CPU:
# max |cuda - cpu| over every weight of a stage (softmax probabilities).
# Seen: 3.1e-5 at stage 0, 6.8e-6 at stage 2, every merge plan the same
# (H100 80GB HBM3, 700 W); the same forward in bfloat16, the planted fault,
# read 0.14-0.21, and must stay above the limit
PROBE_F32_TOL = 1e-4


def config_cli_phase():
    """Phase 18: the CLI's ``info`` in a subprocess reports the card, and
    load_config("octo_base", ["dtype=bfloat16"]) equals the preset."""
    import dataclasses
    from multi_modal_transformers_tokenmerge_torch import load_config
    from multi_modal_transformers_tokenmerge_torch.models.presets import (
        octo_base)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m",
                        "multi_modal_transformers_tokenmerge_torch", "info"],
                       capture_output=True, text=True, timeout=120)
    info_s = time.perf_counter() - t0
    if r.returncode != 0:
        fail(f"the CLI's info exited {r.returncode}: {r.stderr[-2000:]}")
    info = json.loads(r.stdout)
    name = torch.cuda.get_device_name(0)
    if info["backend"] != "cuda" or not any(name in d
                                            for d in info["devices"]):
        fail(f"the CLI's info reports {info['backend']} {info['devices']}; "
             f"expected cuda and {name}")
    cfg = load_config("octo_base", YAML_OVERRIDES)
    preset = octo_base(dtype="bfloat16")
    got, want = dataclasses.asdict(cfg), dataclasses.asdict(preset)
    if got != want:
        fail(f"load_config('octo_base', {YAML_OVERRIDES}) differs from the "
             f"preset")
    log(f"  python -m multi_modal_transformers_tokenmerge_torch info "
        f"({info_s:.2f} s in a subprocess): backend {info['backend']}, "
        f"devices {info['devices']}; load_config('octo_base', "
        f"{YAML_OVERRIDES}) equals octo_base(dtype='bfloat16') on every "
        f"field")
    return cfg, info


def _poisson_load(server, frames, rate, n, rng):
    """Open loop, as benchmarks/serving_load_r4.py drives it: requests fired
    at Poisson arrival times, each in its own thread, each timed from its
    call to its answer."""
    import threading
    lat, errors = [], []
    lock = threading.Lock()

    def one(img):
        t0 = time.perf_counter()
        try:
            act = server.predict(img, timeout=120.0)
            if not np.isfinite(act).all():
                raise ValueError("non-finite action")
        except Exception as e:  # noqa: BLE001 - the phase fails below
            errors.append(repr(e))
            return
        with lock:
            lat.append((time.perf_counter() - t0) * 1e3)

    gaps = rng.exponential(1.0 / rate, size=n)
    threads = []
    start = time.perf_counter()
    at = 0.0
    for i in range(n):
        at += gaps[i]
        delay = start + at - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        t = threading.Thread(target=one, args=(frames[i % len(frames)],),
                             daemon=True)
        t.start()
        threads.append(t)
    for t in threads:
        t.join(timeout=180.0)
    wall = time.perf_counter() - start
    if errors or len(lat) != n:
        fail(f"open-loop load at {rate:.1f} requests/s: {len(lat)} of {n} "
             f"answered, errors {errors[:3]}")
    lat = np.asarray(lat)
    return {"offered_rps": rate, "achieved_rps": n / wall,
            "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)),
            "p99_ms": float(np.percentile(lat, 99)),
            "max_ms": float(lat.max()), "requests": n}


class _Recording:
    """An engine that records, per call on the server's thread, the host
    milliseconds of the call (the input copies and the replay's launch) and,
    with ``keep``, the batch it was handed, the generator state before it
    and its output."""

    def __init__(self, eng, keep=True):
        self.eng = eng
        self.keep = keep
        self.calls = []
        self.call_ms = []

    def __getattr__(self, name):
        return getattr(self.eng, name)

    def __call__(self, images, **kw):
        t = time.perf_counter()
        state = self.eng._generator.get_state() if self.keep else None
        out = self.eng(images, **kw)
        self.call_ms.append((time.perf_counter() - t) * 1e3)
        if self.keep:
            self.calls.append((images.clone(), kw, state, out.clone()))
        return out


def _coalesced(server, frames, instructions=None):
    """One request per frame, started 2 ms apart so that they reach the
    server in order and fill one batch; each request's answer."""
    import threading
    out = [None] * len(frames)

    def call(i):
        out[i] = server.predict(frames[i], None if instructions is None
                                else instructions[i], timeout=120.0)

    threads = []
    for i in range(len(frames)):
        threads.append(threading.Thread(target=call, args=(i,)))
        threads[-1].start()
        time.sleep(0.002)
    for t in threads:
        t.join(timeout=120.0)
    return out


def _held(got, want, label):
    """Bit for bit, else within LOW_ULPS * eps(bf16) * (1 + |want|): which
    one held, and the largest difference."""
    got, want = torch.as_tensor(got).float(), torch.as_tensor(want).float()
    diff = float((got - want).abs().max())
    if torch.equal(got, want):
        return "bit for bit", diff
    gate = rel_gate(got, want, torch.bfloat16)
    if not gate[0]:
        fail(f"{label}: differs by {diff} (limit {LOW_ULPS} eps(bf16) "
             f"(1+|x|))")
    return f"within {LOW_ULPS} eps(bf16) (1+|x|)", diff


def server_phase(model, cfg, counters):
    """Phase 19: PolicyServer around the compiled octo_base bf16 engine at
    batch 8 (diffusion head), in the manner of benchmarks/serving_load_r4.py:
    the closed-loop service time of one client, then open-loop Poisson
    arrivals of single uint8 observations at 0.3, 0.6 and 0.9 of the batch
    capacity that service time gives (8 requests a service time), with
    max_wait_ms=2; one profiled server batch (one ddpm_sampler launch);
    the server thread's replay against a replay on the main thread, bit for
    bit; the continuous head through the server against direct engine calls
    on the same rows, and a mixed-instruction batch against the same rows
    and, in float32, against the tokens path; an eager server's counted
    sampler launches."""
    from multi_modal_transformers_tokenmerge_torch.models.octo import Octo
    from multi_modal_transformers_tokenmerge_torch.serve.policy import (
        PolicyEngine)
    from multi_modal_transformers_tokenmerge_torch.serve.server import (
        PolicyServer)
    g = np.random.default_rng(19)
    ids = g.integers(0, cfg.text.vocab_size, (cfg.text.max_length,))
    image_shape = (cfg.num_observation_blocks, *cfg.images.image_size)
    frames = [g.integers(0, 256, image_shape, dtype=np.uint8)
              for _ in range(16)]
    hc = cfg.heads.diffusion
    t0 = time.perf_counter()
    eng = PolicyEngine(model, batch_size=SERVER_BATCH, seed=1).compile(
        (cfg.text.max_length,), image_shape)
    eng.set_instruction(ids)
    compile_s = time.perf_counter() - t0
    out = {"batch": SERVER_BATCH, "max_wait_ms": SERVER_WAIT_MS,
           "compile_s": compile_s}

    class TimedServer(PolicyServer):
        """Times each batch on the server's thread: stack, copies, replay,
        the copy back and the hand-out."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.runs = []

        def _run(self, batch):
            t = time.perf_counter()
            super()._run(batch)
            self.runs.append((time.perf_counter() - t) * 1e3)

    timed = _Recording(eng, keep=False)
    with TimedServer(timed, max_wait_ms=SERVER_WAIT_MS) as server:
        for i in range(3):
            server.predict(frames[i])
        server.runs.clear()
        timed.call_ms.clear()
        times = []
        for i in range(SERVER_CLOSED_REQUESTS):
            t = time.perf_counter()
            act = server.predict(frames[i % len(frames)])
            times.append((time.perf_counter() - t) * 1e3)
            if act.shape != (hc.action_space_dim,) or not (
                    np.isfinite(act).all()
                    and np.abs(act).max() <= hc.clip_value):
                fail(f"server: action {act.shape} not finite or outside "
                     f"+-{hc.clip_value}")
        runs = list(server.runs)
    svc_ms = float(np.mean(times))
    capacity = SERVER_BATCH / (svc_ms / 1e3)
    out["closed_loop"] = {"service_ms": svc_ms, **latency(times),
                          "p99_ms": float(np.percentile(times, 99)),
                          "capacity_rps": capacity,
                          "batch_run_mean_ms": float(np.mean(runs)),
                          "engine_call_mean_ms": float(np.mean(
                              timed.call_ms))}
    cl = out["closed_loop"]
    log(f"  server, one client, {SERVER_CLOSED_REQUESTS} requests: service "
        f"time mean {svc_ms:.4f} ms (median {cl['median_ms']:.4f}, p99 "
        f"{cl['p99_ms']:.4f}; each waits max_wait_ms={SERVER_WAIT_MS} for "
        f"company first, then its batch runs in "
        f"{cl['batch_run_mean_ms']:.4f} ms on the server's thread, the "
        f"engine call {cl['engine_call_mean_ms']:.4f} of it); batch "
        f"capacity {SERVER_BATCH} a service time = {capacity:.1f} "
        f"requests/s")

    rng = np.random.default_rng(0)
    out["load"] = []
    for frac in SERVER_LOADS:
        timed = _Recording(eng, keep=False)
        with TimedServer(timed, max_wait_ms=SERVER_WAIT_MS) as server:
            server.predict(frames[0])
            server.runs.clear()
            timed.call_ms.clear()
            res = _poisson_load(server, frames, frac * capacity,
                                SERVER_LOAD_REQUESTS, rng)
            runs = list(server.runs)
        res.update(load=frac, batches=len(runs),
                   mean_batch_fill=SERVER_LOAD_REQUESTS / len(runs),
                   batch_run_mean_ms=float(np.mean(runs)),
                   batch_run_p99_ms=float(np.percentile(runs, 99)),
                   engine_call_mean_ms=float(np.mean(timed.call_ms)))
        out["load"].append(res)
        log(f"  server at {frac} of capacity ({res['offered_rps']:.1f} "
            f"requests/s offered, Poisson, {SERVER_LOAD_REQUESTS} requests):"
            f" achieved {res['achieved_rps']:.1f}/s; p50 {res['p50_ms']:.4f}"
            f" ms, p95 {res['p95_ms']:.4f}, p99 {res['p99_ms']:.4f}, max "
            f"{res['max_ms']:.4f}; {res['batches']} batches, "
            f"{res['mean_batch_fill']:.2f} requests a batch, each run in "
            f"{res['batch_run_mean_ms']:.4f} ms on the server's thread "
            f"(p99 {res['batch_run_p99_ms']:.4f}; of it the engine call, "
            f"input copies and replay launch, "
            f"{res['engine_call_mean_ms']:.4f})")

    with PolicyServer(eng, max_wait_ms=SERVER_WAIT_MS) as server:
        server.predict(frames[0])
        prof = replay_profile(lambda: server.predict(frames[1]), 5,
                              {"ddpm_sampler": 1, **norm_kernels(cfg)},
                              "one server batch")
    out["batch_profile"] = prof
    kernels = {k: v for k, v in prof["kernels"].items() if v}
    log(f"  one server batch (one request, padded to {SERVER_BATCH}): "
        f"{prof['launches']:.0f} launches, device {prof['device_ms']:.4f} "
        f"ms, kernels {kernels}")

    # the server thread's replay against the main thread's, bit for bit
    rec = _Recording(eng)
    with PolicyServer(rec, max_wait_ms=200.0) as server:
        answers = _coalesced(server, frames[:SERVER_BATCH])
    images, _, state, worker_out = rec.calls[-1]
    saved = eng._generator.get_state()
    eng._generator.set_state(state)
    main_out = eng(images)
    eng._generator.set_state(saved)
    if len(rec.calls) != 1 or not torch.equal(worker_out, main_out):
        fail(f"server: {len(rec.calls)} batches; the server thread's replay "
             f"differs from the main thread's by "
             f"{float((worker_out - main_out).abs().max())}")
    for i, a in enumerate(answers):
        if not np.array_equal(a, worker_out[i].cpu().numpy()):
            fail(f"server: request {i} got another row than its own")
    out["thread_replay"] = "bit for bit"

    # the deterministic continuous head: server rows against direct calls
    cont = PolicyEngine(model, head="continuous",
                        batch_size=SERVER_BATCH).compile(
        (cfg.text.max_length,), image_shape)
    cont.set_instruction(ids)
    rec = _Recording(cont)
    with PolicyServer(rec, max_wait_ms=200.0) as server:
        answers = _coalesced(server, frames[:SERVER_BATCH])
    direct = cont(torch.from_numpy(np.stack(frames[:SERVER_BATCH])))
    if len(rec.calls) != 1:
        fail(f"server: the continuous requests ran in {len(rec.calls)} "
             f"batches")
    held, diff = _held(np.stack(answers), direct.cpu(),
                       "continuous head through the server")
    out["continuous_vs_direct"] = {"held": held, "max_abs_diff": diff}

    # a mixed-instruction batch: against the same rows served directly, and
    # against the tokens path.  The tokens path runs the text tower at
    # batch 8 inside the graph, the mixed batch at batch 1 per instruction
    # (encode_instruction): other products, other bf16 roundings through
    # twelve T5 blocks.  So the tokens path is held in float32 (the same
    # weights), and the bfloat16 difference is recorded.
    other = (ids + 1) % cfg.text.vocab_size
    instr = [ids if i % 2 == 0 else other for i in range(SERVER_BATCH)]
    rows = torch.from_numpy(np.stack(frames[:SERVER_BATCH]))
    mixed = {}
    model32 = Octo(cfg.replace(dtype="float32"), device="cuda",
                   seed=None).eval()
    model32.load_state_dict(model.state_dict())
    for dtype, m in (("bfloat16", model), ("float32", model32)):
        e = cont
        if dtype == "float32":
            e = PolicyEngine(m, head="continuous",
                             batch_size=SERVER_BATCH).compile(
                (cfg.text.max_length,), image_shape)
            e.set_instruction(ids)
        with PolicyServer(e, max_wait_ms=200.0) as server:
            answers = torch.from_numpy(np.stack(_coalesced(
                server, frames[:SERVER_BATCH], instr)))
        emb = torch.stack([e.encode_instruction(i) for i in instr])
        held_rows, diff_rows = _held(
            answers, e(rows, text_embeddings=emb).cpu(),
            f"{dtype} mixed-instruction batch against the same rows")
        tokens = e(rows, text_tokens=np.stack(instr)).cpu().float()
        ok, diff_tokens, units = rel_gate(answers, tokens, torch.float32)
        mixed[dtype] = {"same_rows": held_rows,
                        "same_rows_max_abs_diff": diff_rows,
                        "vs_tokens_max_abs_diff": diff_tokens,
                        "vs_tokens_f32_units": units}
        if dtype == "float32" and not ok:
            fail(f"float32 mixed-instruction batch against the tokens path: "
                 f"{diff_tokens} ({units:.2f} units of {F32_TOL}(1+|x|))")
    out["mixed"] = mixed
    log(f"  server thread's replay equals the main thread's: bit for bit; "
        f"continuous head, {SERVER_BATCH} requests through the server "
        f"against one direct call on the same rows: {held} (max |diff| "
        f"{diff}); two instructions in one batch against the same rows "
        f"served directly: bf16 {mixed['bfloat16']['same_rows']}, f32 "
        f"{mixed['float32']['same_rows']}; against the tokens path (the "
        f"text tower at batch 8 in the graph): f32 "
        f"{mixed['float32']['vs_tokens_max_abs_diff']:.3e} (limit "
        f"{F32_TOL}(1+|x|)), bf16 "
        f"{mixed['bfloat16']['vs_tokens_max_abs_diff']:.3e} (recorded: "
        f"another text-tower batch, other roundings)")
    del model32

    # an eager engine behind the server: the counted sampler launches
    eager = PolicyEngine(model, batch_size=SERVER_BATCH, seed=1)
    eager.set_instruction(ids)
    for c in counters.values():
        c.launches = 0
    with PolicyServer(eager, max_wait_ms=SERVER_WAIT_MS) as server:
        for i in range(4):
            server.predict(frames[i])
    launched = {k: c.launches for k, c in counters.items()}
    if launched != {k: 4 if k == "ddpm_sampler" else 0 for k in counters}:
        fail(f"eager server: 4 batches launched {launched}")
    out["eager_server_launches"] = launched
    log(f"  eager engine behind the server, 4 batches: launches {launched}")
    del cont, eager
    return eng, out


def closed_loop_phase(eng, cfg):
    """Phase 20: ReachTask.rollout at batch 8, up to 16 steps, 2 uint8
    frames of 280x280 a request, through the compiled octo_base engine
    (per-row instructions from encode_instruction, cached path).  ms per
    env step split into render and policy; the success rate is printed,
    not held (the weights are random)."""
    from multi_modal_transformers_tokenmerge_torch.utils.sim import ReachTask
    spent = {"render": 0.0, "policy": 0.0, "steps": 0}

    class TimedTask(ReachTask):
        def render(self, state):
            t = time.perf_counter()
            img = super().render(state)
            spent["render"] += time.perf_counter() - t
            return img

    task = TimedTask(image_size=cfg.images.image_size[0])
    a = cfg.heads.diffusion.action_space_dim

    def policy(obs, text):
        t = time.perf_counter()
        emb = torch.stack([eng.encode_instruction(row) for row in text])
        act = eng(torch.from_numpy(obs), text_embeddings=emb).cpu().numpy()
        spent["policy"] += time.perf_counter() - t
        spent["steps"] += 1
        if act.shape != (CLOSED_LOOP_BATCH, a) or not np.isfinite(act).all():
            fail(f"closed loop: actions {act.shape} not finite")
        return act

    task.rollout(policy, np.random.default_rng(1), CLOSED_LOOP_BATCH,
                 frames=cfg.num_observation_blocks,
                 text_length=cfg.text.max_length)      # warm-up episode
    spent.update(render=0.0, policy=0.0, steps=0)
    t0 = time.perf_counter()
    res = task.rollout(policy, np.random.default_rng(20), CLOSED_LOOP_BATCH,
                       frames=cfg.num_observation_blocks,
                       text_length=cfg.text.max_length)
    wall = time.perf_counter() - t0
    n = spent["steps"]
    out = {"batch": CLOSED_LOOP_BATCH, "env_steps": n,
           "ms_per_step": wall * 1e3 / n,
           "render_ms_per_step": spent["render"] * 1e3 / n,
           "policy_ms_per_step": spent["policy"] * 1e3 / n, **res}
    log(f"  closed loop, {CLOSED_LOOP_BATCH} episodes of up to "
        f"{task.max_steps} steps, {cfg.num_observation_blocks} uint8 frames "
        f"of {task.image_size}x{task.image_size}: {n} env steps, "
        f"{out['ms_per_step']:.4f} ms a step (render "
        f"{out['render_ms_per_step']:.4f}, policy "
        f"{out['policy_ms_per_step']:.4f}); success rate "
        f"{res['success_rate']} (random weights: printed, not held), mean "
        f"final distance {res['mean_final_distance']:.4f}")
    return out


def probe_phase(cfg32, counters):
    """octo_deep's attention probes (capture_intermediates) in float32 on
    the card (flash_fwd in every block: the probes do not change the path)
    against the CPU, per stage, with every merge plan compared; the same
    forward in bfloat16 is the planted fault."""
    from multi_modal_transformers_tokenmerge_torch.models.octo import Octo
    from multi_modal_transformers_tokenmerge_torch.modules.attention import (
        capture_intermediates)
    gpu = Octo(cfg32, device="cuda", seed=3).eval()
    cpu = Octo(cfg32, device="cpu", seed=None).eval()
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    fault = Octo(cfg32.replace(dtype="bfloat16"), device="cuda",
                 seed=None).eval()
    fault.load_state_dict(gpu.state_dict())
    g = np.random.default_rng(21)
    b = 2
    ids = torch.from_numpy(g.integers(0, cfg32.text.vocab_size,
                                      (b, cfg32.text.max_length)))
    images = torch.from_numpy(g.integers(
        0, 256, (b, cfg32.num_observation_blocks,
                 *cfg32.images.image_size)).astype(np.float32))
    probes, events = {}, {}
    launched = None
    for name, model in (("cuda", gpu), ("cuda_bf16_fault", fault),
                        ("cpu", cpu)):
        on = lambda x: x.to(model.device)
        before = {k: c.launches for k, c in counters.items()}
        with recorded_merge_events() as events[name], \
                capture_intermediates(model) as probes[name], \
                torch.inference_mode():
            model.generate_readouts(on(ids), on(images))
        if name == "cuda":
            launched = {k: c.launches - before[k] for k, c in counters.items()
                        if c.launches != before[k]}
    blocks = cfg32.transformer.num_blocks
    if launched != {"flash_fwd": blocks}:
        fail(f"the probed float32 forward of octo_deep launched {launched}")
    flips = compare_merge_events(events["cuda"], events["cpu"],
                                 "octo_deep f32 probes")
    keys = sorted(probes["cpu"])
    if sorted(probes["cuda"]) != keys or len(keys) != 3:
        fail(f"probes: {sorted(probes['cuda'])} on the card, {keys} on the "
             f"CPU")
    per_stage = {}
    for key in keys:
        want = probes["cpu"][key][0]
        got = probes["cuda"][key][0].cpu()
        bf = probes["cuda_bf16_fault"][key][0].cpu()
        per_stage[key] = {
            "shape": list(want.shape),
            "max_abs_err": float((got - want).abs().max()),
            "bf16_max_abs_err": float((bf - want).abs().max())}
        log(f"    {key} {tuple(want.shape)}: |cuda-cpu| "
            f"{per_stage[key]['max_abs_err']:.3e} (tol {PROBE_F32_TOL:g}); "
            f"bfloat16 {per_stage[key]['bf16_max_abs_err']:.3e}")
    worst = max(v["max_abs_err"] for v in per_stage.values())
    if not worst <= PROBE_F32_TOL:
        fail("octo_deep's float32 attention probes differ between the card "
             "and the CPU" + (f" ({flips} merge events chose other tokens)"
                              if flips else ""))
    if not min(v["bf16_max_abs_err"] for v in per_stage.values()) \
            > PROBE_F32_TOL:
        fail("the planted bfloat16 fault passes the probes' float32 limit")
    del gpu, cpu, fault
    return {"stages": per_stage, "flipped_events": flips,
            "launches": launched}


def refused_phase(counters):
    """Phase 21: octo_base bf16 with a three-block denoiser and GELU MLPs
    (REFUSED_OVERRIDES through load_config): compiled serving at batch 1
    and 8 with no sampler launch, float32 on the card against the CPU, one
    float32 train step against the CPU (TRAIN_REF_LIMITS, with the planted
    bfloat16 fault), and octo_deep's attention probes against the CPU."""
    from multi_modal_transformers_tokenmerge_torch import load_config
    from multi_modal_transformers_tokenmerge_torch.models.octo import Octo
    cfg = load_config("octo_base", YAML_OVERRIDES + REFUSED_OVERRIDES)
    model = Octo(cfg, device="cuda", seed=0).eval()
    d = model.diffusion_action_head.denoiser
    log(f"  octo_base + {REFUSED_OVERRIDES}: denoiser blocks "
        f"{['first_out'] + [f'mlp_{i}' for i in range(1, d.num_blocks)]}, "
        f"transformer activation {cfg.transformer.mlp_activation}")
    label = "octo_base 3-block denoiser, GELU"
    served = compiled_serve_phase({"octo_base_3block_gelu": model}, cfg,
                                  label, {}, requests=COMPILED_REQUESTS // 2)
    del model
    torch.cuda.empty_cache()
    cfg32 = load_config("octo_base", ["dtype=float32"] + REFUSED_OVERRIDES)
    ref_err = reference_phase(cfg32, label, sampler_launches=0)
    train_ref = train_reference_phase(cfg32, counters,
                                      "octo_base_3block_gelu", {})
    log("  octo_deep float32 attention probes, card against CPU:")
    probes = probe_phase(deep_config("float32"), counters)
    return {"serving": served, "reference_err": ref_err,
            "train_reference": train_ref, "probes": probes}


# -- phase 22: the int8 and w8 serving towers --------------------------------------

QUANT_MODES = ("int8", "w8")
# float32 on the card against the CPU through the quantized towers.  The
# int8 products are exact: on the same float inputs the card's int8 values,
# int32 sums and scaled results equal the CPU's bit for bit (held at the
# towers' shapes).  Through a whole tower they are not: int8 quantizes
# activations that come out of float sums taken in another order on each
# device, and a value within an ulp of an int8 rounding boundary rounds one
# step apart.  Through T5-base's twelve layers of random weights such flips
# move the port's int8 text embeddings 6.8e-2 (relative L2) from the JAX
# package's, two correct towers (tests/quant_full_width.py, float32 on the
# CPU), and bf16 compute moves them 0.30: the int8 text embeddings are held
# to QUANT_INT8_TEXT_REL between the two, the bf16 model the planted fault.
# w8 is float arithmetic: its actions are held as phase 4's.
QUANT_W8_F32_TOL = E2E_F32_TOL
QUANT_INT8_TEXT_REL = 0.15
# the JAX package's serving tolerances (tests/test_quantize.py:110,225 for
# the text tower, rtol / atol; tests/test_quantize_image.py:117,189 for the
# image tower, max |diff|), on the continuous head's actions against the
# bf16 towers'.  They were set on micro towers.  At octo_base's width with
# random weights the JAX package's own T5 towers are 0.28 (int8) and 0.20
# (w8) off its float tower in relative L2, and the port's the same
# (tests/quant_full_width.py, float32 on the CPU): no correct tower meets
# the text tolerance there, so the text tower's actions are reported
# against it and its embeddings held to TEXT_REL_LIMIT, 1.5 times the JAX
# package's own error; the image towers (0.018 and 0.009 there) are held to
# theirs.
TEXT_SERVE_TOL = {"int8": (0.05, 0.02), "w8": (0.02, 0.01)}
IMAGE_SERVE_ATOL = {"int8": 0.1, "w8": 0.05}
TEXT_REL_LIMIT = {"int8": 0.42, "w8": 0.30}
DENSE_K, DENSE_N = 28224, 768   # octo_base's output dense
PEAK_INT8_OPS = 1979e12


def quantized_phase(counters):
    """Phase 22: octo_base bf16 served through the int8 and w8 towers
    (``PolicyEngine(image_tower=m, text_tower=m)``): compiled at batch 1
    and 8 (phase 15's checks: replays bit for bit with the eager call,
    latency in turns, one profiled replay); the continuous head's actions of
    each quantized tower against the bf16 tower's; float32 on the card
    against the CPU (``quantized_reference``) with the bf16 engine as the
    planted fault; each tower's device time (image tower at batch 1, 8, 32; text
    tower at batch 1, 8); and the output dense as ``_int_mm`` against a
    bf16 ``torch.matmul`` at 50, 400 and 1600 rows, each beside its
    bound."""
    from multi_modal_transformers_tokenmerge_torch.models.octo import Octo
    from multi_modal_transformers_tokenmerge_torch.models.presets import (
        octo_base)
    from multi_modal_transformers_tokenmerge_torch.serve import quantize as q
    from multi_modal_transformers_tokenmerge_torch.serve.policy import (
        PolicyEngine)
    cfg = octo_base(dtype="bfloat16")
    model = Octo(cfg, device="cuda", seed=0).eval()
    out = {}
    for mode in QUANT_MODES:
        out[f"serving_{mode}"] = compiled_serve_phase(
            {f"octo_base_{mode}": model}, cfg, f"octo_base bf16, {mode} "
            f"towers", {"ddpm_sampler": 1, **NO_NORM_KERNELS},
            requests=COMPILED_REQUESTS // 4,
            engine_kw=dict(image_tower=mode, text_tower=mode))

    g = np.random.default_rng(9)
    ids = g.integers(0, cfg.text.vocab_size, (cfg.text.max_length,))
    images = random_images(cfg, 8, g)
    base = PolicyEngine(model, head="continuous", batch_size=8)
    a_f = base.set_instruction(ids)(images)
    rel = lambda a, b: float(torch.linalg.vector_norm((a - b).float())
                             / torch.linalg.vector_norm(b.float()))
    with torch.inference_mode():
        text_f = base.encode_instruction(ids)
        image_f = model.image_encoder(images)
    track = {}
    for mode in QUANT_MODES:
        eng_t = PolicyEngine(model, head="continuous", batch_size=8,
                             text_tower=mode).set_instruction(ids)
        eng_i = PolicyEngine(model, head="continuous", batch_size=8,
                             image_tower=mode).set_instruction(ids)
        a_t, a_i = eng_t(images), eng_i(images)
        with torch.inference_mode():
            embed = q.image_embed_int8 if mode == "int8" \
                else q.image_embed_w8
            image_q = embed(eng_i._image_qp, images, cfg.images,
                            cfg.compute_dtype)
        rtol, atol = TEXT_SERVE_TOL[mode]
        row = {"text_rel": rel(eng_t.encode_instruction(ids), text_f),
               "image_rel": rel(image_q, image_f),
               "text_actions_max_abs": float((a_t - a_f).abs().max()),
               "text_actions_within_jax_tol": bool(
                   ((a_t - a_f).abs() <= atol + rtol * a_f.abs()).all()),
               "image_actions_max_abs": float((a_i - a_f).abs().max())}
        track[mode] = row
        log(f"  octo_base bf16 B=8, {mode} against the bf16 towers: text "
            f"embeddings relative error {row['text_rel']:.4f} (limit "
            f"{TEXT_REL_LIMIT[mode]}), continuous actions max |diff| "
            f"{row['text_actions_max_abs']:.3e} (the JAX tests' {atol} + "
            f"{rtol}|x|: {'met' if row['text_actions_within_jax_tol'] else 'not met'}"
            f"); image embeddings relative error {row['image_rel']:.4f}, "
            f"actions max |diff| {row['image_actions_max_abs']:.3e} (limit "
            f"{IMAGE_SERVE_ATOL[mode]})")
        if not (row["text_rel"] <= TEXT_REL_LIMIT[mode]
                and row["image_actions_max_abs"] < IMAGE_SERVE_ATOL[mode]):
            fail(f"the {mode} towers are further from the bf16 towers than "
                 f"their limits")
    out["against_bf16_towers"] = track
    out["f32_reference"] = quantized_reference(ids, g)
    out["w8_bf16_products"] = w8_product_check(model, cfg, g)
    out["tower_ms"] = tower_timings(model, cfg, g)
    for tower, rows in out["tower_ms"].items():
        log(f"  w8 {tower} tower, device ms against the earlier reading "
            f"with bf16-rounded products (the ratio to the bf16 tower "
            f"beside each): " + ", ".join(
                f"B={b} {row['w8']:.4f} ({row['w8'] / row['bf16']:.2f}x; "
                f"earlier {ROUNDED_W8_MS[tower][b]:.4f}, "
                f"{ROUNDED_W8_MS[tower][b] / ROUNDED_BF16_MS[tower][b]:.2f}x)"
                for b, row in rows.items()))
    out["dense_gemm"] = dense_gemm_timings(q.quantize_image_tower(model))
    del model, base
    torch.cuda.empty_cache()
    return out


def quantized_reference(ids, g):
    """float32 octo_base through the quantized towers, the card against the
    CPU on the same weights: the int8 products at the towers' shapes bit
    for bit (T5's fused qkv at 16 rows, the image tower's input conv, the
    output dense at 50 rows), the w8 towers' actions (diffusion head, the
    same noise) within QUANT_W8_F32_TOL, the int8 text embeddings within
    QUANT_INT8_TEXT_REL; the card's bf16 model through the same towers is
    the planted fault of both limits.  The int8 towers' actions are
    reported."""
    from multi_modal_transformers_tokenmerge_torch.models.octo import Octo
    from multi_modal_transformers_tokenmerge_torch.models.presets import (
        octo_base)
    from multi_modal_transformers_tokenmerge_torch.ops.ddpm_sampler import (
        ddpm_sampler)
    from multi_modal_transformers_tokenmerge_torch.serve.policy import (
        PolicyEngine)
    cfg32 = octo_base(dtype="float32")
    gpu = Octo(cfg32, device="cuda", seed=3).eval()
    cpu = Octo(cfg32, device="cpu", seed=None).eval()
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    fault = Octo(cfg32.replace(dtype="bfloat16"), device="cuda",
                 seed=None).eval()
    fault.load_state_dict(gpu.state_dict())
    out = {"int8_products_bit_for_bit": int8_exactness(gpu, cpu, g)}
    b = 2
    images = random_images(cfg32, b, g).cpu()
    hc = cfg32.heads.diffusion
    noisy = torch.from_numpy(g.normal(size=(b, hc.action_space_dim)).astype(
        np.float32))
    noise = torch.from_numpy(g.normal(size=(
        hc.diffusion_steps, b, hc.action_space_dim)).astype(np.float32))
    rel = lambda a, ref: float(torch.linalg.vector_norm(a - ref)
                               / torch.linalg.vector_norm(ref))
    for mode in QUANT_MODES:
        acts, text = {}, {}
        for name, m in (("cuda", gpu), ("cpu", cpu), ("fault", fault)):
            dev = m.device
            eng = PolicyEngine(m, batch_size=b, image_tower=mode,
                               text_tower=mode).set_instruction(ids)
            text[name] = eng.encode_instruction(ids).float().cpu()
            before = ddpm_sampler.launches
            acts[name] = eng(images.to(dev), noisy=noisy.to(dev),
                             noise=noise.to(dev)).float().cpu()
            if dev.type == "cuda" and ddpm_sampler.launches - before != 1:
                fail(f"the {mode} request did not launch the sampler once")
        row = {"actions_err": float((acts["cuda"] - acts["cpu"]).abs().max()),
               "actions_fault": float((acts["fault"] - acts["cpu"])
                                      .abs().max()),
               "text_rel": rel(text["cuda"], text["cpu"]),
               "text_rel_fault": rel(text["fault"], text["cpu"])}
        out[mode] = row
        log(f"  octo_base f32 {mode} towers B={b}, card against CPU: actions "
            f"max |diff| {row['actions_err']:.3e}, text embeddings relative "
            f"error {row['text_rel']:.3e}; planted fault (the card's bf16 "
            f"model, same towers) {row['actions_fault']:.3e} and "
            f"{row['text_rel_fault']:.3e}; limits: "
            + (f"actions {QUANT_W8_F32_TOL:g}" if mode == "w8" else
               f"text embeddings {QUANT_INT8_TEXT_REL:g}"))
        if mode == "w8":
            held, planted = row["actions_err"], row["actions_fault"]
            limit = QUANT_W8_F32_TOL
        else:
            held, planted = row["text_rel"], row["text_rel_fault"]
            limit = QUANT_INT8_TEXT_REL
        if not held <= limit:
            fail(f"float32 {mode} towers: CUDA and CPU disagree")
        if not planted > limit:
            fail(f"the planted bfloat16 fault passes the {mode} limit")
    del gpu, cpu, fault
    return out


def int8_exactness(gpu, cpu, g):
    """The int8 products on the card against the CPU on the same float
    inputs, at the towers' shapes: quantized weights, T5's fused qkv
    ``int8_matmul`` at 16 rows (padded on the card), the image tower's input
    conv ``int8_conv_hwcn`` at batch 1 (50 patches) and the output dense
    ``int8_matmul_tn`` at 50 rows: every result bit for bit, or the run
    fails."""
    from multi_modal_transformers_tokenmerge_torch.serve import quantize as q
    t_g = q.quantize_t5_params(gpu.text_encoder.t5_encoder)
    t_c = q.quantize_t5_params(cpu.text_encoder.t5_encoder)
    i_g, i_c = q.quantize_image_tower(gpu), q.quantize_image_tower(cpu)
    rcfg = gpu.config.images
    p = rcfg.patch_size
    pairs = [("qkv weights", t_g["layers"][0]["qkv"].q, t_c["layers"][0][
                 "qkv"].q),
             ("qkv scales", t_g["layers"][0]["qkv"].scale,
              t_c["layers"][0]["qkv"].scale),
             ("dense weights", i_g["dense"].q, i_c["dense"].q),
             ("input conv weights", i_g["input_conv"].q, i_c["input_conv"].q)]
    a = torch.from_numpy(g.normal(size=(1, 16, 768)).astype(np.float32))
    pairs.append(("T5 qkv int8_matmul, 16 rows",
                  q.int8_matmul(a.cuda(), t_g["layers"][0]["qkv"]),
                  q.int8_matmul(a, t_c["layers"][0]["qkv"])))
    x = torch.from_numpy(g.uniform(-1, 1, (p, p, 3, 50)).astype(np.float32))
    pairs.append(("input conv int8_conv_hwcn, 50 patches",
                  q.int8_conv_hwcn(x.cuda(), i_g["input_conv"],
                                   tuple(rcfg.resnet.input_stride), "VALID"),
                  q.int8_conv_hwcn(x, i_c["input_conv"],
                                   tuple(rcfg.resnet.input_stride), "VALID")))
    d = torch.from_numpy(g.normal(size=(DENSE_K, 50)).astype(np.float32))
    pairs.append(("output dense int8_matmul_tn, 50 rows",
                  q.int8_matmul_tn(d.cuda(), i_g["dense"]),
                  q.int8_matmul_tn(d, i_c["dense"])))
    for name, on_card, on_cpu in pairs:
        if not torch.equal(on_card.cpu(), on_cpu):
            fail(f"int8 on the card against the CPU: {name} differ")
    log(f"  int8 on the card against the CPU, bit for bit: "
        f"{[name for name, _, _ in pairs]}")
    return [name for name, _, _ in pairs]


# the towers' device ms read by this script when the w8 products were
# rounded to bf16 before the scale (PERF.md section 5; NVIDIA H100 80GB
# HBM3, 700 W)
ROUNDED_W8_MS = {"image": {1: 0.4793, 8: 2.1760, 32: 8.1804},
                 "text": {1: 1.4079, 8: 1.6117}}
ROUNDED_BF16_MS = {"image": {1: 0.4297, 8: 1.8651, 32: 7.1893},
                   "text": {1: 1.0722, 8: 1.2354}}


def w8_product_check(model, cfg, g):
    """The w8 towers in bf16 at batch 8, their products float32 on this
    torch's route (``quantize.W8_PRODUCT_ROUTE``: ``torch.mm(out_dtype=)``
    where it has a CUDA kernel), against the same towers with the products'
    operands upcast to float32 (the plain path) and with the products
    rounded to bf16 before the scale (as they were computed before, the
    planted fault).  The route's relative L2 distance from the plain path must be
    at most half the fault's, and the product float32."""
    from multi_modal_transformers_tokenmerge_torch.serve import quantize as q
    img_qp = q.quantize_image_tower(model)
    txt_qp = q.quantize_t5_params(model.text_encoder.t5_encoder)
    tc, dt = cfg.text, cfg.compute_dtype
    images = random_images(cfg, 8, g)
    ids = torch.from_numpy(g.integers(0, tc.vocab_size,
                                      (8, tc.max_length))).cuda()
    kw = dict(rel_pos_buckets=tc.t5_rel_pos_buckets,
              rel_pos_max_distance=tc.t5_rel_pos_max_distance, dtype=dt,
              mode="w8")

    def towers():
        with torch.inference_mode():
            return (q.image_embed_w8(img_qp, images, cfg.images, dt).float(),
                    q.t5_encode_int8(txt_qp, ids, **kw).float())

    a = torch.randn(16, 768, device="cuda", dtype=dt)
    product_dtype = q.float32_product(a, txt_qp["layers"][0]["qkv"].q.to(
        dt)).dtype
    route = towers()
    on_route, product = q._MM_OUT_DTYPE_ON_CUDA, q.float32_product
    try:
        q._MM_OUT_DTYPE_ON_CUDA = False
        plain = towers()
        q.float32_product = lambda x, w: torch.matmul(x, w).float()
        fault = towers()
    finally:
        q._MM_OUT_DTYPE_ON_CUDA, q.float32_product = on_route, product
    rel = lambda x, ref: float(torch.linalg.vector_norm(x - ref)
                               / torch.linalg.vector_norm(ref))
    out = {"route": q.W8_PRODUCT_ROUTE, "product_dtype": str(product_dtype)}
    for i, tower in enumerate(("image", "text")):
        out[tower] = {"route_rel": rel(route[i], plain[i]),
                      "fault_rel": rel(fault[i], plain[i])}
        log(f"  w8 {tower} tower bf16 B=8, products on the "
            f"{q.W8_PRODUCT_ROUTE} route ({product_dtype}) against the "
            f"float32 upcast: relative L2 {out[tower]['route_rel']:.3e}; the "
            f"bf16-rounded products (planted fault) "
            f"{out[tower]['fault_rel']:.3e}")
        if not (product_dtype == torch.float32
                and out[tower]["route_rel"] <= 0.5 * out[tower]["fault_rel"]):
            fail(f"the w8 {tower} tower's products are not the float32 "
                 f"products")
    return out


def tower_timings(model, cfg, g):
    """Device ms of one call of each tower (every kernel it runs, from the
    profiler): the image tower at batch 1, 8 and 32, the text tower at
    batch 1 and 8, in bf16 (the model's own), int8 and w8."""
    from multi_modal_transformers_tokenmerge_torch.serve import quantize as q
    img_qp = q.quantize_image_tower(model)
    txt_qp = q.quantize_t5_params(model.text_encoder.t5_encoder)
    tc = cfg.text
    dt = cfg.compute_dtype
    out = {"image": {}, "text": {}}
    with torch.inference_mode():
        for b in (1, 8, 32):
            images = random_images(cfg, b, g)
            fns = {"bf16": lambda: model.image_encoder(images),
                   "int8": lambda: q.image_embed_int8(img_qp, images,
                                                      cfg.images, dt),
                   "w8": lambda: q.image_embed_w8(img_qp, images,
                                                  cfg.images, dt)}
            out["image"][b] = {k: device_total_ms(f)[0]
                               for k, f in fns.items()}
        for b in (1, 8):
            ids = torch.from_numpy(g.integers(0, tc.vocab_size,
                                              (b, tc.max_length))).cuda()
            kw = dict(rel_pos_buckets=tc.t5_rel_pos_buckets,
                      rel_pos_max_distance=tc.t5_rel_pos_max_distance,
                      dtype=dt)
            fns = {"bf16": lambda: model.encode_text(ids),
                   "int8": lambda: q.t5_encode_int8(txt_qp, ids, mode="int8",
                                                    **kw),
                   "w8": lambda: q.t5_encode_int8(txt_qp, ids, mode="w8",
                                                  **kw)}
            out["text"][b] = {k: device_total_ms(f)[0]
                              for k, f in fns.items()}
    for tower, rows in out.items():
        for b, row in rows.items():
            log(f"  {tower} tower B={b}: device ms " + ", ".join(
                f"{k} {v:.4f}" for k, v in row.items()))
    return out


def dense_gemm_timings(img_qp):
    """octo_base's output dense (K=28224, N=768) at M = 50, 400 and 1600
    rows (batch 1, 8 and 32 of 50 patches): the int8 product as the int8
    tower runs it (``int_mm`` on the per-patch quantized activations and
    the stored kernel), a bf16 ``torch.matmul`` of the same shape, and the
    w8 tower's product (the kernel converted to bf16 at the call), each
    beside its bound (bytes: each operand read once, the result written
    once; operations at the H100's dense int8 or bf16 peak)."""
    from multi_modal_transformers_tokenmerge_torch.serve import quantize as q
    k, n = DENSE_K, DENSE_N
    w = img_qp["dense"]
    w_bf = q.dequant(w, torch.bfloat16)
    out = {}
    for m in (50, 400, 1600):
        a8 = torch.randint(-127, 128, (k, m), dtype=torch.int8,
                           device="cuda").t()
        a_bf = torch.randn(m, k, device="cuda", dtype=torch.bfloat16)
        a_f = torch.randn(k, m, device="cuda")
        t_int = device_total_ms(lambda: q.int_mm(a8, w.q))[0]
        t_bf = device_total_ms(lambda: torch.matmul(a_bf, w_bf))[0]
        t_w8 = device_total_ms(lambda: q.matmul_w8_tn(a_f, w))[0]
        ops = 2 * m * k * n
        b_int = max(((m * k + k * n) + 4 * m * n) / HBM_BYTES_PER_S,
                    ops / PEAK_INT8_OPS) * 1e3
        b_bf, by_bf = bound(2 * (m * k + k * n + m * n), ops, torch.bfloat16)
        row = {"int_mm_ms": t_int, "int_mm_bound_ms": b_int,
               "bf16_matmul_ms": t_bf, "bf16_bound_ms": b_bf,
               "bf16_bound_by": by_bf, "w8_matmul_ms": t_w8}
        out[m] = row
        log(f"  output dense M={m}: _int_mm {t_int:.4f} ms (bound "
            f"{b_int:.4f}), bf16 matmul {t_bf:.4f} ms (bound {b_bf:.4f}, "
            f"{by_bf}), w8 (convert + bf16 matmul) {t_w8:.4f} ms")
    return out


# -- phase 23: export and load_artifact ----------------------------------------------

EXPORT_DIR = os.path.join(OUT_DIR, "artifacts")
FIRST_REQUEST_CODE = r"""
import json, sys, time
import numpy as np, torch
from multi_modal_transformers_tokenmerge_torch.models.octo import Octo
from multi_modal_transformers_tokenmerge_torch.models.presets import octo_base
from multi_modal_transformers_tokenmerge_torch.serve.policy import PolicyEngine
how, full, cached = sys.argv[1:4]
t0 = time.perf_counter()
cfg = octo_base(dtype="bfloat16")
model = Octo(cfg, device="cuda", seed=0).eval()
torch.cuda.synchronize()
t_model = time.perf_counter() - t0
g = np.random.default_rng(0)
ids = g.integers(0, cfg.text.vocab_size, (cfg.text.max_length,))
shape = (cfg.num_observation_blocks, *cfg.images.image_size)
images = torch.from_numpy(g.integers(0, 256, (1, *shape)).astype(
    np.float32)).cuda()
eng = PolicyEngine(model, batch_size=1, seed=1)
t0 = time.perf_counter()
if how == "load":
    eng.load_artifact(full, cached)
else:
    eng.compile((cfg.text.max_length,), shape)
t_prepare = time.perf_counter() - t0
eng.set_instruction(ids)
times = []
for _ in range(3):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng(images)
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
print(json.dumps({"how": how, "model_s": t_model, "prepare_s": t_prepare,
                  "first_ms": times[0], "next_ms": times[1:]}))
"""


@contextlib.contextmanager
def raw_kernel_wrappers():
    """The model's paths call the kernel wrappers directly instead of
    through their custom ops (the eager path before the registration)."""
    from multi_modal_transformers_tokenmerge_torch.heads import diffusion
    from multi_modal_transformers_tokenmerge_torch.modules import (
        image_tokenizer as it)
    from multi_modal_transformers_tokenmerge_torch.ops import (
        flash_attention as fa, group_norm as gn)
    from multi_modal_transformers_tokenmerge_torch.ops.ddpm_sampler import (
        ddpm_sampler)
    saved = diffusion.ddpm_sampler_op, fa.flash_fwd_op, it.group_norm_gelu_op
    diffusion.ddpm_sampler_op = (
        lambda *a: ddpm_sampler(*a[:8], clip_value=a[8], ddim_x0clip=a[9],
                                ddim_eps_recompute=a[10]))
    fa.flash_fwd_op = lambda q, k, v, m, t, bq, bk: fa.flash_fwd(
        q, k, v, m, t, block_q=bq, block_k=bk)
    it.group_norm_gelu_op = gn.group_norm_gelu
    try:
        yield
    finally:
        (diffusion.ddpm_sampler_op, fa.flash_fwd_op,
         it.group_norm_gelu_op) = saved


def registration_cost(model, cfg, label, requests):
    """Eager batch-1 requests with the kernels reached through their custom
    ops (as shipped) and through the bare wrappers, in turns (ops, bare,
    bare, ops): host ms each."""
    from multi_modal_transformers_tokenmerge_torch.serve.policy import (
        PolicyEngine)
    g = np.random.default_rng(12)
    ids = g.integers(0, cfg.text.vocab_size, (cfg.text.max_length,))
    eng = PolicyEngine(model, batch_size=1, seed=1).set_instruction(ids)
    timed_requests(eng, cfg, 1, 2, g)
    times = {"custom_op": [], "wrapper": []}
    for name in ("custom_op", "wrapper", "wrapper", "custom_op"):
        with (raw_kernel_wrappers() if name == "wrapper"
              else contextlib.nullcontext()):
            times[name] += timed_requests(eng, cfg, 1, requests // 2, g)
    row = {k: latency(v) for k, v in times.items()}
    log(f"  {label} eager B=1 in turns: through the custom ops median "
        f"{row['custom_op']['median_ms']:.4f} ms (p90 "
        f"{row['custom_op']['p90_ms']:.4f}), bare wrappers median "
        f"{row['wrapper']['median_ms']:.4f} ms (p90 "
        f"{row['wrapper']['p90_ms']:.4f})")
    return row


def export_case(model, cfg, label, cached_only, expected):
    """Export ``model``'s diffusion programs at batch 1 (the cached path,
    and the full one unless ``cached_only``), load them, and hold the
    loaded engine against the eager one with the same seed (the same
    draws): every request bit for bit, each kernel launched through its
    custom op ``expected`` times a request."""
    from multi_modal_transformers_tokenmerge_torch.serve import export as ex
    from multi_modal_transformers_tokenmerge_torch.serve.policy import (
        PolicyEngine)
    os.makedirs(EXPORT_DIR, exist_ok=True)
    text_shape = (cfg.text.max_length,)
    image_shape = (cfg.num_observation_blocks, *cfg.images.image_size)
    row, paths = {}, {}
    for kind in (("cached",) if cached_only else ("full", "cached")):
        export = ex.export_cached_policy if kind == "cached" \
            else ex.export_policy
        paths[kind] = os.path.join(EXPORT_DIR, f"{label}_{kind}.pt2")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = export(model, "diffusion", 1, text_shape, image_shape,
                      path=paths[kind])
        t_export = time.perf_counter() - t0
        t0 = time.perf_counter()
        ex.load_policy(paths[kind])
        t_load = time.perf_counter() - t0
        ops = sorted({str(nd.target) for nd in torch.export.load(
            paths[kind]).graph.nodes if str(nd.target).startswith(
                "tokenmerge.")})
        want_ops = sorted(f"tokenmerge.{k}.default" for k in expected)
        if ops != want_ops:
            fail(f"{label} {kind} artifact holds the ops {ops}; expected "
                 f"{want_ops}")
        row[kind] = {"bytes": len(blob), "export_s": t_export,
                     "load_s": t_load, "ops": ops}
        log(f"  {label} {kind} artifact: {len(blob)} bytes, exported in "
            f"{t_export:.2f} s, loaded in {t_load:.3f} s, ops {ops}")
    g = np.random.default_rng(13)
    ids = torch.from_numpy(g.integers(0, cfg.text.vocab_size,
                                      (1, *text_shape))).cuda()
    with torch.inference_mode():
        emb = model.encode_text(ids)
    params = ex.parameters_of(model)
    gen = torch.Generator(device="cuda").manual_seed(5)
    from multi_modal_transformers_tokenmerge_torch.ops import (
        ddpm_sampler as sm, flash_attention as fa, group_norm as gn)
    counters = {"ddpm_sampler": sm.ddpm_sampler, "flash_fwd": fa.flash_fwd,
                "group_norm_gelu": gn.group_norm_gelu}
    diffs = []
    for kind, path in paths.items():
        fn = ex.load_policy(path)
        text = ids if kind == "full" else emb
        method = getattr(model, ex.PREDICT_METHODS["diffusion"]
                         if kind == "full" else
                         ex.CACHED_PREDICT_METHODS["diffusion"])
        for _ in range(2):
            images = random_images(cfg, 1, g)
            draws = [torch.randn(shape, generator=gen, device="cuda")
                     for shape in ex.draw_shapes(model, "diffusion",
                                                 1).values()]
            with torch.inference_mode():
                want = method(text, images, noisy=draws[0], noise=draws[1])
            before = {k: c.launches for k, c in counters.items()}
            got = fn(params, text, images, *draws)
            launched = {k: c.launches - before[k]
                        for k, c in counters.items()}
            if launched != {k: expected.get(k, 0) for k in counters}:
                fail(f"{label}: a request through the {kind} artifact "
                     f"launched {launched}; expected {expected}")
            diffs.append(float((got - want).abs().max()))
    row["launches_per_request"] = launched
    if not cached_only:
        # the engine: load_artifact against the eager engine, same seed
        eager = PolicyEngine(model, batch_size=1, seed=5).set_instruction(
            ids[0].cpu().numpy())
        loaded = PolicyEngine(model, batch_size=1, seed=5).load_artifact(
            paths["full"], paths["cached"]).set_instruction(
                ids[0].cpu().numpy())
        for tokens in (None, ids[0].cpu().numpy()):
            images = random_images(cfg, 1, g)
            diffs.append(float((loaded(images, text_tokens=tokens)
                                - eager(images, text_tokens=tokens))
                               .abs().max()))
    row["max_abs_diff_vs_eager"] = max(diffs)
    log(f"  {label}: the loaded programs against the eager calls on the "
        f"same draws: max |diff| {max(diffs)} over {len(diffs)} requests")
    if max(diffs) != 0.0:
        fail(f"{label}: the artifact's actions differ from the eager call's")
    row["paths"] = paths
    return row


def first_request(how, paths):
    """A fresh interpreter builds octo_base bf16, then loads the artifacts
    (``how='load'``) or compiles the engine (``'compile'``), and serves its
    first requests: (the JSON it prints)."""
    r = subprocess.run([sys.executable, "-c", FIRST_REQUEST_CODE, how,
                        paths["full"], paths["cached"]],
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        log(r.stdout[-3000:], r.stderr[-3000:])
        fail(f"the fresh process ({how}) failed")
    return json.loads(r.stdout.strip().splitlines()[-1])


def export_phase():
    """Phase 23: octo_base bf16 exported (full and cached diffusion
    programs) and octo_deep bf16's cached program (flash_fwd through its
    custom op; group_norm_gelu in both); bytes, export and load seconds; the loaded engine against
    the eager one; the first requests of a fresh process after
    ``load_artifact`` against those after ``compile()``; the eager
    request's host time through the custom ops and through the bare
    wrappers, in turns."""
    import shutil
    from multi_modal_transformers_tokenmerge_torch.models.octo import Octo
    from multi_modal_transformers_tokenmerge_torch.models.presets import (
        octo_base)
    cfg = octo_base(dtype="bfloat16")
    model = Octo(cfg, device="cuda", seed=0).eval()
    norms = cfg.images.resnet.num_blocks
    out = {"octo_base": export_case(model, cfg, "octo_base", False,
                                    {"ddpm_sampler": 1,
                                     "group_norm_gelu": norms})}
    out["registration_octo_base"] = registration_cost(
        model, cfg, "octo_base bf16", 100)
    paths = out["octo_base"].pop("paths")
    out["first_request"] = [first_request(how, paths)
                            for how in ("load", "compile")]
    for r in out["first_request"]:
        log(f"  fresh process, {r['how']}: model built in {r['model_s']:.2f} "
            f"s, {r['how']} {r['prepare_s']:.3f} s, first request "
            f"{r['first_ms']:.2f} ms, then "
            f"{[round(x, 3) for x in r['next_ms']]}")
    del model
    dcfg = deep_config("bfloat16")
    deep = Octo(dcfg, device="cuda", seed=0).eval()
    out["octo_deep"] = export_case(
        deep, dcfg, "octo_deep", True,
        {"ddpm_sampler": 1, "flash_fwd": dcfg.transformer.num_blocks,
         "group_norm_gelu": dcfg.images.resnet.num_blocks})
    out["octo_deep"].pop("paths")
    out["registration_octo_deep"] = registration_cost(
        deep, dcfg, "octo_deep bf16", 100)
    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    del deep
    torch.cuda.empty_cache()
    return out


# -- phase 24: the mixture-of-experts MLP ----------------------------------------------

def moe_config(cfg, **moe):
    """``cfg`` with mixture-of-experts MLPs (MoEConfig's defaults: 4
    experts, top-1, capacity 1.25; ``moe`` overrides)."""
    tr = cfg.transformer
    return cfg.replace(transformer=tr.replace(
        mlp_type="moe", moe=tr.moe.replace(**moe)))


def moe_phase(counters):
    """Phase 24: octo_base with ``transformer.mlp_type=moe`` (MoEConfig's
    defaults), bf16: served compiled at batch 32 beside its dense twin (in
    turns, both replays profiled) and trained compiled at batch 32 (the
    captured step held against the eager one, then in turns with the dense
    twin); float32 serving against the CPU (E2E_F32_TOL) and one float32
    train step under TRAIN_REF_LIMITS, the weighted balance loss in it;
    then octo_deep with MoE at top_k=2 served eagerly (12 flash_fwd and one
    sampler launch a request) and trained compiled at batch 32 beside its
    dense twin."""
    from multi_modal_transformers_tokenmerge_torch.models.octo import Octo
    from multi_modal_transformers_tokenmerge_torch.models.presets import (
        octo_base)
    base = octo_base(dtype="bfloat16")
    mcfg = moe_config(base)
    moe = Octo(mcfg, device="cuda", seed=0).eval()
    dense = Octo(base, device="cuda", seed=0).eval()
    out = {"serving_b32": compiled_serve_phase(
        {"moe": moe, "dense": dense}, mcfg, "octo_base+MoE bf16",
        {"ddpm_sampler": 1}, requests=COMPILED_REQUESTS // 2,
        batches=(32,))}
    del moe, dense
    torch.cuda.empty_cache()
    out["reference_err"] = reference_phase(
        moe_config(octo_base(dtype="float32")), "octo_base+MoE")
    train_expected = {"flash_fwd_lse": 1, "flash_dq": 1, "flash_dkv": 1,
                      "pool_bwd": 1}
    out["train_reference"] = train_reference_phase(
        moe_config(train_config("float32")), counters, "octo_base_moe",
        train_expected)
    out["training"] = compiled_train_phase(
        moe_config(train_config("bfloat16")), "octo_base+MoE",
        train_expected, twin=("dense", train_config("bfloat16"),
                              train_expected))
    blocks = 12
    dmoe = moe_config(deep_config("bfloat16"), top_k=2)
    deep = Octo(dmoe, device="cuda", seed=0).eval()
    ms, launches = serve_phase(deep, dmoe, counters,
                               "octo_deep+MoE top-2 bf16", 20,
                               {"flash_fwd": blocks, "ddpm_sampler": 1})
    out["deep_serving"] = {"ms": ms, "launches": launches}
    del deep
    torch.cuda.empty_cache()
    deep_expected = {"flash_fwd_lse": blocks, "flash_dq": blocks,
                     "flash_dkv": blocks, "pool_bwd": 1}
    out["deep_training"] = compiled_train_phase(
        moe_config(deep_pallas_config("bfloat16"), top_k=2),
        "octo_deep+MoE top-2", deep_expected,
        twin=("dense", deep_pallas_config("bfloat16"), deep_expected))
    return out


# -- phase 25: ring attention on the card ---------------------------------------

RING_P = 4
RING_B, RING_S, RING_H, RING_D = 2, 4096, 12, 64     # octo_deep's heads
RING_BLOCK_SPEC = "[TaskDescriptionPrefix{96}] [Image{980};Readout{20}]*4"
RING_SHARDS = (64, 128, 256, 512, 1024, 2048)   # the 'auto' crossover's
# float32 against the plain attention: the JAX ring tests' tolerances
# (tests/test_ring_attention.py:57, :76); 16-bit uses rel_gate
RING_FWD_TOL = 2e-5
RING_GRAD_RTOL, RING_GRAD_ATOL = 5e-4, 1e-6


def ring_masks():
    return {"causal": np.tril(np.ones((RING_S, RING_S), dtype=bool)),
            "block_causal": layout_mask(RING_BLOCK_SPEC)}


def fwd_bwd(fn, q, k, v):
    """fn's output and the gradients of mean(out^2) for q, k, v."""
    out = fn(q, k, v)
    grads = torch.autograd.grad(out.float().square().mean(), (q, k, v))
    return out.detach(), grads


def ring_inputs(dtype, seed, s=RING_S, b=RING_B, h=RING_H, d=RING_D):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(b, s, h, d, generator=g, device="cuda")
                 .to(dtype).requires_grad_(True) for _ in range(3))


def ring_step_bytes_flops(b, s, h, d, nnz, kind):
    """Least bytes and FLOPs of one ring step's kernel at shard length s:
    bf16 inputs read once, float32 outputs written once, the (s, s) int8
    tile, the float32 row statistics; 2 FLOPs a multiply-add over the tile's
    live pairs."""
    act = b * s * h * d
    stats = b * h * s * 4
    ins, outs, nstats, products = {"fwd": (3, 1, 1, 2), "dq": (4, 1, 2, 3),
                                   "dkv": (4, 2, 2, 4)}[kind]
    nbytes = ins * act * 2 + outs * act * 4 + nstats * stats + s * s
    return nbytes, 2 * products * b * h * d * nnz


def ring_step_check(fa, tables, mask, h=RING_H, d=RING_D):
    """Each float32-output kernel against its plain version on one ring
    step: query shard 1 against key shard 1 of the block-causal layout (a
    partly masked tile), bf16 inputs at shard length S/P, H heads of D;
    then their device times, plain times, bounds and SDPA on the same
    tile."""
    import torch.nn.functional as F
    tiles, khi, qlo = tables
    i = src = 1
    s = RING_S // RING_P
    tile, k_hi, q_lo = tiles[i, src], khi[i, src], qlo[i, src]
    dtype = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(251)
    q, k, v, do = (torch.randn(RING_B, s, h, d, generator=g,
                               device="cuda").to(dtype) for _ in range(4))
    bq, bk = fa.kernel_tiles(d)
    kw = dict(block_q=bq, block_k=bk, out_dtype=torch.float32)
    ref = plain_of(fa, d)
    out, lse = fa.flash_fwd_lse(q, k, v, tile, k_hi, **kw)
    out_p, lse_p = ref.flash_fwd_lse_reference(q, k, v, tile, k_hi, **kw)
    delta = fa.attention_delta(do, out_p, s)
    dq = fa.flash_dq(q, k, v, do, lse_p, delta, tile, k_hi, **kw)
    dk, dv = fa.flash_dkv(q, k, v, do, lse_p, delta, tile, q_lo, **kw)
    torch.cuda.synchronize()
    dq_p = ref.flash_dq_reference(q, k, v, do, lse_p, delta, tile, k_hi, **kw)
    dk_p, dv_p = ref.flash_dkv_reference(q, k, v, do, lse_p, delta, tile,
                                        q_lo, **kw)
    err = {}
    for kernel, pairs in (("flash_fwd_lse", [(out, out_p)]),
                          ("flash_dq", [(dq, dq_p)]),
                          ("flash_dkv", [(dk, dk_p), (dv, dv_p)])):
        worst = 0.0
        for got, want in pairs:
            if got.dtype != torch.float32:
                fail(f"{kernel} out_dtype=float32 wrote {got.dtype}")
            ok, e, units = rel_gate(got, want, dtype)
            rounded = bool((got != got.to(dtype).float()).any())
            log(f"  ring step {kernel:13s} bf16 in, float32 out, B={RING_B} "
                f"S={s} H={h} D={d}: |kernel-plain| {e:.2e} "
                f"({units:.3f} of {LOW_ULPS} eps(bf16)); bits below bf16 "
                f"{'kept' if rounded else 'LOST'}")
            if not ok or not rounded:
                fail(f"ring step {kernel} float32 output")
            worst = max(worst, e)
        err[kernel] = worst
    lse_err = ((lse - lse_p).abs() / (1 + lse_p.abs())).max().item()
    if not lse_err <= 1e-5:
        fail(f"ring step lse rel {lse_err:.2e}")
    nnz = int(tile.sum())
    calls = {
        "flash_fwd_lse": (lambda: fa.flash_fwd_lse(q, k, v, tile, k_hi, **kw),
                          lambda: ref.flash_fwd_lse_reference(
                              q, k, v, tile, k_hi, **kw), "fwd"),
        "flash_dq": (lambda: fa.flash_dq(q, k, v, do, lse, delta, tile, k_hi,
                                         **kw),
                     lambda: ref.flash_dq_reference(q, k, v, do, lse, delta,
                                                   tile, k_hi, **kw), "dq"),
        "flash_dkv": (lambda: fa.flash_dkv(q, k, v, do, lse, delta, tile,
                                           q_lo, **kw),
                      lambda: ref.flash_dkv_reference(q, k, v, do, lse, delta,
                                                     tile, q_lo, **kw),
                      "dkv"),
    }
    qh, kh, vh, doh = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    m = tile.bool()
    sdpa = lambda a, b, c: F.scaled_dot_product_attention(a, b, c,
                                                          attn_mask=m)
    lib_fwd, _ = device_total_ms(lambda: sdpa(qh, kh, vh))
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (qh, kh, vh))
    lib_both, _ = device_total_ms(
        lambda: torch.autograd.grad(sdpa(qg, kg, vg), (qg, kg, vg), doh))
    lib_bwd = max(lib_both - lib_fwd, 0.0)
    rows = {}
    for kernel, (call, plain, kind) in calls.items():
        ms = device_ms(call, kernel_key(kernel, d))
        plain_ms = time_ms(plain, iters=1, warmup=0)
        nbytes, flops = ring_step_bytes_flops(RING_B, s, h, d, nnz,
                                              kind)
        bnd, by = bound(nbytes, flops, dtype)
        lib = lib_fwd if kind == "fwd" else lib_bwd
        rows[kernel] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                            bound_by=by, library_ms=lib,
                            max_abs_err=err[kernel])
        log(f"  ring step {kernel:13s} float32 out: kernel {ms:.4f} ms on the "
            f"device, plain {plain_ms:.1f} ms, bound {bnd:.5f} ms ({by}; "
            f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP), SDPA "
            f"{'forward' if kind == 'fwd' else 'backward (dq+dk+dv)'} on the "
            f"tile {lib:.4f} ms")
    return rows


WIDE_RING_H, WIDE_RING_D = 3, 512   # octo_deep_h512's heads


def wide_ring_check(fa):
    """The ring at octo_deep_h512's heads: a LocalRing of P=4 shards of a
    bf16 block-causal 4096-token sequence (B=2, 3 heads of 512), forward
    and backward, against the whole-sequence flash_attention under
    rel_gate; then the wide kernels' float32-output variants on one ring
    step's tile against their plain versions, with their times."""
    from multi_modal_transformers_tokenmerge_torch.parallel import (
        ring_attention as ra)
    mask = ring_masks()["block_causal"]
    q, k, v = ring_inputs(torch.bfloat16, 256, h=WIDE_RING_H, d=WIDE_RING_D)
    r_out, r_g = fwd_bwd(
        lambda a, b, c: ra.ring_attention(a, b, c, mask, RING_P,
                                          impl="flash"), q, k, v)
    w_out, w_g = fwd_bwd(lambda a, b, c: fa.flash_attention(a, b, c, mask),
                         q, k, v)
    parts, ok_all, errs = [], True, {}
    for key, got, whole in zip(("out", "dq", "dk", "dv"), (r_out, *r_g),
                               (w_out, *w_g)):
        ok, e, units = rel_gate(got, whole, torch.bfloat16)
        ok_all &= ok
        errs[key] = [e, units]
        parts.append(f"{key} {e:.2e} ({units:.3f})")
    log(f"  ring bf16 block_causal P={RING_P} B={RING_B} S={RING_S} "
        f"H={WIDE_RING_H} D={WIDE_RING_D}: |ring - whole flash_attention| "
        f"{', '.join(parts)} {'ok' if ok_all else 'FAIL'}")
    if not ok_all:
        fail("ring attention at D=512")
    del q, k, v, r_out, r_g, w_out, w_g
    torch.cuda.empty_cache()
    tables = ra.ring_tables(mask, RING_P, *fa.kernel_tiles(WIDE_RING_D),
                            "cuda")
    rows = ring_step_check(fa, tables, mask, h=WIDE_RING_H, d=WIDE_RING_D)
    return {"ring_vs_whole": errs, "step": rows}


def ring_phase(fa, counters):
    """Ring attention as a LocalRing of P=4 shards of 1024 tokens on the
    card: the main path (bf16, causal, forward and backward) with every
    count set to 0 before it and read after (P^2 launches of flash_fwd_lse,
    flash_dq and flash_dkv); forward and dq/dk/dv against the whole-sequence
    flash_attention and, in float32, the plain whole-sequence attention;
    each float32-output kernel on one ring step; the times; the inner
    block's crossover."""
    from multi_modal_transformers_tokenmerge_torch.parallel import (
        ring_attention as ra)
    masks = ring_masks()
    ring = lambda mask, impl="flash": (
        lambda q, k, v: ra.ring_attention(q, k, v, mask, RING_P, impl=impl))
    for c in counters.values():
        c.launches = 0
    q, k, v = ring_inputs(torch.bfloat16, 250)
    out, grads = fwd_bwd(ring(masks["causal"]), q, k, v)
    torch.cuda.synchronize()
    launches = {n: c.launches for n, c in counters.items()}
    p2 = RING_P * RING_P
    want = {"flash_fwd_lse": p2, "flash_dq": p2, "flash_dkv": p2}
    log(f"  ring main path (bf16 causal, P={RING_P}, B={RING_B} S={RING_S} "
        f"H={RING_H} D={RING_D}, forward and backward): launches {launches}")
    if any(launches[n] != want.get(n, 0) for n in launches):
        fail(f"the ring launched {launches}; expected {want}")
    if not all(torch.isfinite(t.float()).all() for t in (out, *grads)):
        fail("ring outputs not finite")
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, mask in masks.items():
            q, k, v = ring_inputs(dtype, 252)
            r_out, r_g = fwd_bwd(ring(mask), q, k, v)
            w_out, w_g = fwd_bwd(lambda a, b, c: fa.flash_attention(a, b, c,
                                                                    mask),
                                 q, k, v)
            parts, ok_all = [], True
            for key, got, whole in zip(("out", "dq", "dk", "dv"),
                                       (r_out, *r_g), (w_out, *w_g)):
                ok, e, units = rel_gate(got, whole, dtype)
                ok_all &= ok
                parts.append(f"{key} {e:.2e}")
            if dtype == torch.float32:
                mb = torch.as_tensor(mask, device="cuda")
                p_out, p_g = fwd_bwd(
                    lambda a, b, c: fa.xla_reference_attention(a, b, c, mb),
                    q, k, v)
                e_out = (r_out - p_out).abs()
                ok = bool((e_out <= RING_FWD_TOL * (1 + p_out.abs())).all())
                plain = [f"out {e_out.max().item():.2e}"]
                for key, got, want_g in zip(("dq", "dk", "dv"), r_g, p_g):
                    e = (got - want_g).abs()
                    ok &= bool((e <= RING_GRAD_ATOL + RING_GRAD_RTOL *
                                want_g.abs()).all())
                    plain.append(f"{key} {e.max().item():.2e}")
                ok_all &= ok
                parts.append(f"against the plain attention {', '.join(plain)}")
                del p_out, p_g
            errs[f"{str(dtype)[6:]}_{name}"] = parts
            log(f"  ring {str(dtype)[6:]:8s} {name:12s}: |ring - whole "
                f"flash_attention| {', '.join(parts)} "
                f"{'ok' if ok_all else 'FAIL'}")
            if not ok_all:
                fail(f"ring attention {dtype} {name}")
            del r_out, r_g, w_out, w_g
    torch.cuda.empty_cache()
    tables = ra.ring_tables(masks["block_causal"], RING_P,
                            *fa.KERNEL_TILES[RING_D], "cuda")
    rows = ring_step_check(fa, tables, masks["block_causal"])
    import torch.nn.functional as F
    q, k, v = ring_inputs(torch.bfloat16, 253)
    causal = masks["causal"]
    qh, kh, vh = (x.detach().transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    mb = torch.as_tensor(causal, device="cuda")
    sdpa = lambda a, b, c: F.scaled_dot_product_attention(a, b, c,
                                                          attn_mask=mb)
    with torch.no_grad():
        times = {"ring_forward": time_ms(lambda: ring(causal)(q, k, v), 10, 2),
                 "whole_flash_forward": time_ms(
                     lambda: fa.flash_attention(q, k, v, causal), 10, 2),
                 "sdpa_forward": time_ms(lambda: sdpa(qh, kh, vh), 10, 2)}
    times.update(
        ring_forward_backward=time_ms(lambda: fwd_bwd(ring(causal), q, k, v),
                                      10, 2),
        whole_flash_forward_backward=time_ms(
            lambda: fwd_bwd(lambda a, b, c: fa.flash_attention(a, b, c,
                                                               causal),
                            q, k, v), 10, 2),
        sdpa_forward_backward=time_ms(lambda: fwd_bwd(sdpa, qh, kh, vh),
                                      10, 2))
    log(f"  bf16 causal B={RING_B} S={RING_S} H={RING_H} D={RING_D}, ms "
        f"(CUDA events, median): " + ", ".join(f"{k} {v:.4f}"
                                               for k, v in times.items()))
    # the same calls' device time (every kernel a call runs): the events
    # above also hold the host's work, the mask's digest among it
    dev = {"ring_forward_backward": device_total_ms(
               lambda: fwd_bwd(ring(causal), q, k, v), 5, 2)[0],
           "whole_flash_forward_backward": device_total_ms(
               lambda: fwd_bwd(lambda a, b, c: fa.flash_attention(
                   a, b, c, causal), q, k, v), 5, 2)[0],
           "sdpa_forward_backward": device_total_ms(
               lambda: fwd_bwd(sdpa, qh, kh, vh), 5, 2)[0]}
    log("  the same, device ms a call: " + ", ".join(
        f"{k} {v:.4f}" for k, v in dev.items()))
    crossover = {}
    for shard in RING_SHARDS:
        s = shard * RING_P
        mask = np.tril(np.ones((s, s), dtype=bool))
        q, k, v = ring_inputs(torch.bfloat16, 254, s=s)
        t = {impl: time_ms(lambda: fwd_bwd(ring(mask, impl), q, k, v), 5, 2)
             for impl in ("xla", "flash")}
        t.update({f"{impl}_device": device_total_ms(
            lambda: fwd_bwd(ring(mask, impl), q, k, v), 3, 1)[0]
            for impl in ("xla", "flash")})
        crossover[shard] = t
        log(f"  inner block at shard {shard} (S={s}, bf16 causal, forward "
            f"and backward of the ring): plain {t['xla']:.3f} ms, flash "
            f"{t['flash']:.3f} ms ({t['xla'] / t['flash']:.2f}x); device "
            f"plain {t['xla_device']:.3f} ms, flash {t['flash_device']:.3f} "
            f"ms")
        del q, k, v
        torch.cuda.empty_cache()
    wins = [sh for sh in RING_SHARDS
            if all(crossover[x]["flash"] < crossover[x]["xla"]
                   for x in RING_SHARDS if x >= sh)]
    measured = min(wins) if wins else None
    log(f"  flash wins from shard {measured}; 'auto' takes it at every "
        f"aligned shard" + ("" if measured == RING_SHARDS[0] else
                           " (the plain block won below: see PERF.md)"))
    return {"launches": launches, "errors": errs, "step": rows,
            "times_ms": times, "device_ms": dev, "crossover_ms": crossover,
            "flash_wins_from": measured}


# -- phase 26: distributed at world 1 -------------------------------------------

DIST_TRAIN_BATCH = 8
DIST_TRAIN_STEPS = 3
DIST_TIMED_STEPS = 20


def distributed_phase(fa):
    """initialize_multihost and make_mesh at world 1 on NCCL; fit(mesh=)
    against fit() bit for bit and their step times in turns;
    PolicyEngine(mesh=) eager, compiled and cached against the un-meshed
    engine; ring_attention over the NCCL group at P=1 against
    flash_attention."""
    import socket
    import torch.distributed as dist
    from multi_modal_transformers_tokenmerge_torch.models.octo import Octo
    from multi_modal_transformers_tokenmerge_torch.models.presets import (
        octo_base)
    from multi_modal_transformers_tokenmerge_torch.parallel import (
        distributed as pd, mesh as pm, ring_attention as ra)
    from multi_modal_transformers_tokenmerge_torch.serve.policy import (
        PolicyEngine)
    from multi_modal_transformers_tokenmerge_torch.train.loop import fit
    from multi_modal_transformers_tokenmerge_torch.train.steps import (
        make_train_step)
    torch.cuda.set_device(0)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    pd.initialize_multihost(f"tcp://localhost:{port}", 1, 0)
    out = {"backend": dist.get_backend(), "process_info": pd.process_info()}
    if out["backend"] != "nccl":
        fail(f"the process group runs {out['backend']}, not nccl")
    mesh = pm.make_mesh()
    log(f"  process group {out['backend']}, {out['process_info']}; mesh "
        f"{mesh.mesh_dim_names} {tuple(mesh.shape)} on {mesh.device_type}")
    try:
        cfg = train_config("bfloat16")
        batches = device_batches(cfg, DIST_TRAIN_BATCH, DIST_TRAIN_STEPS, 26)
        plain_state, mesh_state = _fresh_train_state(cfg), _fresh_train_state(
            cfg)
        steps = {"fit": make_train_step("diffusion"),
                 "fit_mesh": make_train_step("diffusion", mesh=mesh)}
        fit(plain_state, iter(batches), "diffusion", DIST_TRAIN_STEPS,
            step_fn=steps["fit"])
        fit(mesh_state, iter(batches), "diffusion", DIST_TRAIN_STEPS,
            mesh=mesh, step_fn=steps["fit_mesh"])
        torch.cuda.synchronize()
        diffs = leaf_diffs(plain_state, mesh_state)
        log(f"  fit(mesh=) against fit(), octo_base bf16 B="
            f"{DIST_TRAIN_BATCH}, {DIST_TRAIN_STEPS} steps (eager, capture, "
            f"replay): largest |difference| parameter {diffs[0]:.3e}, moment "
            f"{diffs[1]:.3e}")
        if diffs[2] > 1e-6:
            fail("fit(mesh=) at world 1 differs from fit()")
        out["fit_diffs"] = diffs
        # gradient accumulation under the mesh: the compiled step of each
        # (at a data size of one the mesh adds no collective)
        accum = {name: _fresh_train_state(cfg) for name in ("fit", "mesh")}
        fit(accum["fit"], iter(batches), "diffusion", DIST_TRAIN_STEPS,
            accum_steps=2)
        fit(accum["mesh"], iter(batches), "diffusion", DIST_TRAIN_STEPS,
            mesh=mesh, accum_steps=2)
        torch.cuda.synchronize()
        adiffs = leaf_diffs(accum["fit"], accum["mesh"])
        log(f"  fit(mesh=, accum_steps=2) against fit(accum_steps=2), "
            f"octo_base bf16 B={DIST_TRAIN_BATCH}, {DIST_TRAIN_STEPS} steps: "
            f"largest |difference| parameter {adiffs[0]:.3e}, moment "
            f"{adiffs[1]:.3e}")
        if adiffs[:2] != (0.0, 0.0):
            fail("fit(mesh=, accum_steps=2) at world 1 is not fit("
                 "accum_steps=2) bit for bit")
        out["fit_accum_diffs"] = adiffs
        del accum
        window = device_batches(cfg, DIST_TRAIN_BATCH, DIST_TIMED_STEPS, 27)
        times = {"fit": [], "fit_mesh": []}
        for _ in range(2):
            for name, state in (("fit", plain_state),
                                ("fit_mesh", mesh_state)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fit(state, iter(window), "diffusion", DIST_TIMED_STEPS,
                    mesh=mesh if name == "fit_mesh" else None,
                    step_fn=steps[name])
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3
                                   / DIST_TIMED_STEPS)
        out["ms_per_step"] = times
        log(f"  compiled steps in turns, {DIST_TIMED_STEPS} a window: fit "
            f"{times['fit']} ms/step, fit(mesh=) {times['fit_mesh']} ms/step")
        del plain_state, mesh_state, batches, window
        torch.cuda.empty_cache()

        scfg = octo_base(dtype="bfloat16")
        model = Octo(scfg, device="cuda", seed=0).eval()
        g = np.random.default_rng(26)
        ids = g.integers(0, scfg.text.vocab_size, (8, scfg.text.max_length))
        images = random_images(scfg, 8, g)
        engines = [PolicyEngine(model, batch_size=8, seed=1),
                   PolicyEngine(model, batch_size=8, seed=1, mesh=mesh)]
        same = {}
        for path in ("eager", "compiled", "cached"):
            if path == "compiled":
                for e in engines:
                    e.compile((scfg.text.max_length,),
                              tuple(images.shape[1:]))
            if path == "cached":
                for e in engines:
                    e.set_instruction(ids)
            acts = [e(images) if path == "cached" else
                    e(images, text_tokens=ids) for e in engines]
            same[path] = bool(torch.equal(acts[0], acts[1]))
        log(f"  PolicyEngine(mesh=) against the un-meshed engine, octo_base "
            f"bf16 B=8, the same seed: bit for bit {same}")
        if not all(same.values()):
            fail("PolicyEngine(mesh=) differs from the un-meshed engine")
        out["engine_equal"] = same
        del engines, model
        torch.cuda.empty_cache()

        mask = np.tril(np.ones((1024, 1024), dtype=bool))
        q, k, v = ring_inputs(torch.bfloat16, 260, s=1024)
        r_out, r_g = fwd_bwd(lambda a, b, c: ra.ring_attention(
            a, b, c, mask, None, impl="flash"), q, k, v)
        w_out, w_g = fwd_bwd(lambda a, b, c: fa.flash_attention(a, b, c,
                                                                mask),
                             q, k, v)
        ring_diff = max((x.float() - y.float()).abs().max().item()
                        for x, y in zip((r_out, *r_g), (w_out, *w_g)))
        log(f"  ring_attention over the NCCL group (P=1) against "
            f"flash_attention, bf16 B={RING_B} S=1024: largest |difference| "
            f"of out, dq, dk, dv {ring_diff:.3e}")
        if ring_diff != 0.0:
            fail("the ring of one differs from flash_attention")
        out["ring_p1_diff"] = ring_diff
    finally:
        dist.destroy_process_group()
    return out


# -- phase 27: the legacy model families ----------------------------------------

LEGACY_BATCH = 8
PCT_POINTS = 1024


def legacy_phase():
    """The legacy families in float32 on the card against the CPU (the same
    weights and inputs), each within E2E_F32_TOL of the CPU's largest
    |output|, and each one's time on the card."""
    from multi_modal_transformers_tokenmerge_torch.models import legacy as L
    g = np.random.default_rng(27)
    out = {}

    def held(label, gpu_fn, cpu_fn, iters=10):
        with torch.no_grad():
            want = cpu_fn()
            got = gpu_fn()
            ms = time_ms(gpu_fn, iters=iters, warmup=2)
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        err = max((a.detach().cpu().float() - b.float()).abs().max().item()
                  for a, b in zip(got, want))
        scale = max(1.0, max(b.float().abs().max().item() for b in want))
        ok = err <= E2E_F32_TOL * scale and all(
            torch.isfinite(a.float()).all() for a in got)
        log(f"  {label}: |cuda-cpu| {err:.3e} (tol {E2E_F32_TOL:g} x "
            f"{scale:.3g}), {ms:.3f} ms a call on the card "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{label}: float32 CUDA and CPU disagree")
        out[label] = {"err": err, "scale": scale, "ms": ms}

    def pair(make):
        cpu = make("cpu", 0).eval()
        gpu = make("cuda", None).eval()
        gpu.load_state_dict(cpu.state_dict())
        return gpu, cpu

    pcfg = L.PointCloudTransformerConfig()
    gpu, cpu = pair(lambda d, s: L.PointCloudTransformer(pcfg, 3, device=d,
                                                         seed=s))
    pts = torch.from_numpy(g.standard_normal(
        (LEGACY_BATCH, PCT_POINTS, 3)).astype(np.float32))
    pts_gpu = pts.cuda()
    starts = (5, 7)
    held(f"PointCloudTransformer (sample {pcfg.sample1}, {pcfg.sample2}, "
         f"{pcfg.attention_heads} heads x {pcfg.attention_layers}) B="
         f"{LEGACY_BATCH} N={PCT_POINTS}",
         lambda: gpu(pts_gpu, starts=starts), lambda: cpu(pts, starts=starts),
         iters=5)
    ccfg = L.ConceptLearnerConfig()
    b = LEGACY_BATCH
    text = torch.from_numpy(g.integers(1, ccfg.text.vocab_size,
                                       (b, ccfg.text.max_length)))
    images = torch.from_numpy(g.uniform(
        0, 255, (b, ccfg.max_seq_len, *ccfg.images.image_size)).astype(
            np.float32))
    actions = torch.from_numpy(g.integers(0, ccfg.num_actions,
                                          (b, ccfg.max_seq_len)))
    actions[:, 2:] = 0
    gpu, cpu = pair(lambda d, s: L.GatoConceptLearner(ccfg, device=d,
                                                      seed=s))
    held(f"GatoConceptLearner B={b}",
         lambda: gpu(text.cuda(), images.cuda(), actions.cuda()),
         lambda: cpu(text, images, actions))
    gpu, cpu = pair(lambda d, s: L.SingleImageConceptLearner(ccfg, device=d,
                                                             seed=s))
    held(f"SingleImageConceptLearner B={b}",
         lambda: gpu(text.cuda(), images[:, 0].cuda()),
         lambda: cpu(text, images[:, 0]))
    gpu, cpu = pair(lambda d, s: L.ConceptPlanner(ccfg, device=d, seed=s))
    gen_gpu = lambda: gpu.predict_concept_and_value(images[:, 0].cuda())
    gen_cpu = lambda: cpu.predict_concept_and_value(images[:, 0])
    held(f"ConceptPlanner generation (4 tokens) B={b}: log-probabilities "
         f"and value", lambda: gen_gpu()[1:], lambda: gen_cpu()[1:])
    with torch.no_grad():
        if not torch.equal(gen_gpu()[0].cpu(), gen_cpu()[0]):
            fail("ConceptPlanner's tokens differ between the card and the CPU")
    return out


# -- phase 28: rematerialization ------------------------------------------------

REMAT_CHECK_STEPS = 3   # captured remat steps held against eager remat
REMAT_WINDOW = 20       # steps a turn of the four variants
REMAT_LAYERS_BATCH = 8  # the per-layer compressed check's batch
# the per-layer cadence at octo_deep's width and depth: every block merges
# 6 image tokens of each frame (100 -> 28), so each block's recompute merges
PER_LAYER_COMPRESSION = "[TaskDescriptionPrefix{0}] [Image{6};Readout{0}]*2"


def remat_config(dtype, remat=True):
    cfg = deep_pallas_config(dtype)
    return cfg.replace(transformer=cfg.transformer.replace(remat=remat))


@contextlib.contextmanager
def recorded_merge_plans():
    """Within the block every merge plan the ToMe stack makes (unmerged,
    merged sources, their destinations) is appended to the list yielded,
    in the order made: a rematerialized block's forward, then its
    recompute."""
    from multi_modal_transformers_tokenmerge_torch.modules import tome_stack
    original = tome_stack.bipartite_soft_matching
    plans = []

    def recording(metric, r, **kw):
        plan = original(metric, r, **kw)
        plans.append(tuple(t.cpu() for t in (plan.unm_idx, plan.src_idx,
                                              plan.dst_idx)))
        return plan

    tome_stack.bipartite_soft_matching = recording
    try:
        yield plans
    finally:
        tome_stack.bipartite_soft_matching = original


def remat_phase(counters):
    """``transformer.remat`` on octo_deep bf16 at B=32 as its preset sets
    attention (the flash kernels with their dropout 0.1): remat off and on,
    each eager and captured, every block's recompute replaying the
    forward's draws.  Launches a step (remat: 24 flash_fwd_lse, 12 flash_dq
    and 12 flash_dkv, or the run fails; the captured step from one profiled
    replay), peak memory above the state and ms a step of the four, the
    step times in turns; the captured remat step against the eager one
    and the eager remat step against the eager step without remat after
    REMAT_CHECK_STEPS steps (each GRAPH_TRAIN_TOL); a float32 step of the per-layer
    cadence (``tome_merge_every=1``, ``attention_impl='auto'``, dropout
    0.1) whose recomputes must merge as their forwards did; one float32
    remat step against the CPU under TRAIN_REF_LIMITS."""
    import itertools
    from multi_modal_transformers_tokenmerge_torch.train.loop import fit
    from multi_modal_transformers_tokenmerge_torch.train.steps import (
        make_train_step)
    blocks = remat_config("bfloat16").transformer.num_blocks
    batches = device_batches(remat_config("bfloat16"), TRAIN_BATCH, 4,
                             seed=28)
    cycle = itertools.cycle(batches)
    variants = {"off_eager": (False, False), "on_eager": (True, False),
                "off_captured": (False, True), "on_captured": (True, True)}
    states, steps, out = {}, {}, {"variants": {}}
    flash = ("flash_fwd_lse", "flash_dq", "flash_dkv")
    for name, (remat, captured) in variants.items():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        states[name] = _fresh_train_state(remat_config("bfloat16", remat))
        state_bytes = torch.cuda.memory_allocated() - base
        steps[name] = make_train_step("diffusion", jit=captured)
        for c in counters.values():
            c.launches = 0
        for i in range(REMAT_CHECK_STEPS):
            steps[name](states[name], *batches[i])
        torch.cuda.synchronize()
        launched = {k: counters[k].launches / REMAT_CHECK_STEPS
                    for k in flash}
        peak = torch.cuda.max_memory_allocated() - base - state_bytes
        row = {"peak_gib_above_state": peak / 2 ** 30,
               "state_gib": state_bytes / 2 ** 30}
        want = {"flash_fwd_lse": 2 * blocks if remat else blocks,
                "flash_dq": blocks, "flash_dkv": blocks}
        if captured:
            # the warm-up is eager, the capture launches nothing; replays
            # are read from the device records
            row["replay_profile"] = replay_profile(
                lambda: steps[name](states[name], *batches[0]), 3,
                {**want, "pool_bwd": 1,
                 **norm_kernels(remat_config("bfloat16"))},
                f"octo_deep remat={remat} captured")
            launched = {k: row["replay_profile"]["kernels"][k] for k in flash}
        elif launched != want:
            fail(f"octo_deep remat={remat} eager step launched {launched} "
                 f"a step; expected {want}")
        row["launches_per_step"] = launched
        out["variants"][name] = row
    # the step times, in turns
    order = list(variants) + list(reversed(variants))
    ms = {name: [] for name in variants}
    for name in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit(states[name], cycle, "diffusion", REMAT_WINDOW,
            step_fn=steps[name], logger=_NullLogger(), log_every=10)
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t0) * 1e3 / REMAT_WINDOW)
    for name, row in out["variants"].items():
        row["ms_per_step"] = ms[name]
        log(f"  octo_deep bf16 B={TRAIN_BATCH} {name}: peak memory "
            f"{row['peak_gib_above_state']:.2f} GiB above the state "
            f"({row['state_gib']:.2f} GiB), {[round(x, 4) for x in ms[name]]}"
            f" ms/step in turns, launches a step {row['launches_per_step']}"
            + (f", one replay {row['replay_profile']['device_ms']:.4f} ms "
               f"on the device" if "replay_profile" in row else ""))
    del states, steps
    torch.cuda.empty_cache()

    # captured against eager with remat, and eager remat against no remat
    check = {name: _fresh_train_state(remat_config("bfloat16", remat))
             for name, remat in (("eager", True), ("captured", True),
                                 ("plain", False))}
    eager_step = make_train_step("diffusion", jit=False)
    capt_step = make_train_step("diffusion")
    for i in range(REMAT_CHECK_STEPS):
        for name, st in check.items():
            (capt_step if name == "captured" else eager_step)(st,
                                                              *batches[i])
    torch.cuda.synchronize()
    cap = leaf_diffs(check["eager"], check["captured"])
    plain = leaf_diffs(check["plain"], check["eager"])
    out["captured_vs_eager"], out["remat_vs_plain_eager"] = cap, plain
    log(f"  after {REMAT_CHECK_STEPS} steps: captured remat against eager "
        f"remat {cap[0]} (parameters), {cap[1]} (moments), {cap[2]:.2e} of a "
        f"leaf (limit {GRAPH_TRAIN_TOL}; bit for bit: "
        f"{cap[:2] == (0.0, 0.0)}); eager remat against eager without "
        f"remat {plain[0]}, {plain[1]}, {plain[2]:.2e}")
    if not cap[2] <= GRAPH_TRAIN_TOL:
        fail("the captured remat step differs from the eager remat step")
    if not plain[2] <= GRAPH_TRAIN_TOL:
        fail("the eager remat step differs from the eager step without "
             "remat")
    del check
    torch.cuda.empty_cache()

    # the per-layer cadence: every block merges inside its recompute
    base = remat_config("float32")
    lcfg = base.replace(
        compression_sequence=PER_LAYER_COMPRESSION,
        transformer=base.transformer.replace(tome_merge_every=1,
                                             attention_impl="auto"))
    state = _fresh_train_state(lcfg)
    lb = device_batches(lcfg, REMAT_LAYERS_BATCH, 1, seed=29)[0]
    with recorded_merge_plans() as plans:
        make_train_step("diffusion", jit=False)(state, *lb)
    torch.cuda.synchronize()
    n = lcfg.transformer.num_blocks
    # m plans a block (one a merged set): the forwards in block order, then
    # the recomputes in the backward's, the last block's first
    m = len(plans) // (2 * n)
    block = lambda i: plans[i * m:(i + 1) * m]
    same = [all(torch.equal(a, b) for pf, pr in zip(block(i),
                                                    block(2 * n - 1 - i))
                for a, b in zip(pf, pr)) for i in range(n)] if m else []
    out["per_layer_recompute_same_plans"] = same
    log(f"  per-layer cadence, float32 B={REMAT_LAYERS_BATCH}, {n} blocks "
        f"each merging {m} sets: {len(plans)} merge plans made (forward "
        f"and recompute); each recompute's plans equal to its forward's: "
        f"{same}")
    if not m or len(plans) != 2 * n * m or not all(same):
        fail("a rematerialized block merged other tokens in its recompute")
    del state
    torch.cuda.empty_cache()

    out["train_reference"] = train_reference_phase(
        remat_config("float32"), counters, "octo_deep",
        {"flash_fwd_lse": 2 * blocks, "flash_dq": blocks,
         "flash_dkv": blocks, "pool_bwd": 1})
    return out


# -- phase 29: the port's drives -------------------------------------------------

DRIVE_BATCH = 32
DRIVE_TIMEOUT = 420
DRIVE = "multi_modal_transformers_tokenmerge_torch.examples."
DRIVE_DEEP = ["--preset", "octo_deep", "--head", "diffusion", "--batch",
              str(DRIVE_BATCH), "--remat", "--accum-steps", "2",
              "--override", "dtype=bfloat16",
              "--override", "transformer.attention_impl=flash",
              "--override", "images.resnet.pool_vjp=pallas"]


def _drive(args, sigterm_after_metrics=False):
    """One drive as a user runs it (``python -m``, on the card); with
    ``sigterm_after_metrics`` a SIGTERM once its first metrics line shows
    fit running.  (exit code, output, seconds)."""
    import signal
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-u", "-m", *args],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    lines = []
    try:
        if sigterm_after_metrics:
            for line in proc.stdout:
                lines.append(line)
                if line.startswith("{") and '"loss"' in line:
                    proc.send_signal(signal.SIGTERM)
                    break
        rest, _ = proc.communicate(timeout=DRIVE_TIMEOUT)
        lines.append(rest)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return proc.returncode, "".join(lines), time.perf_counter() - t0


def drive_phase():
    """The train drive on octo_deep bf16 at batch 32 with its preset's
    attention in the flash kernels, ``--remat``, ``--accum-steps 2``,
    ``--ckpt`` and ``--recordio`` (in a temporary directory): a SIGTERM
    once it trains must give a last checkpoint, ``final:`` and exit code
    0; ``--resume`` must then print ``resumed train state from step N``
    and ``resumed data stream at batch N + 2`` and end as well.  Then the
    serve drive on octo_base bf16 at batch 8."""
    import tempfile
    out = {}
    with tempfile.TemporaryDirectory() as d:
        common = [*DRIVE_DEEP, "--ckpt", os.path.join(d, "ckpt"),
                  "--recordio", os.path.join(d, "data.rec")]
        rc, text, secs = _drive([DRIVE + "train_octo", "--steps", "100000",
                                 *common], sigterm_after_metrics=True)
        log("  train drive, SIGTERM once it trained: exit code "
            f"{rc} in {secs:.1f} s; its last lines:")
        for line in text.strip().splitlines()[-6:]:
            log(f"    {line[:200]}")
        saved = sorted(int(f[:-3]) for f in os.listdir(os.path.join(
            d, "ckpt")) if f.endswith(".pt"))
        if rc != 0 or "final:" not in text or not saved:
            fail("the train drive did not stop cleanly on SIGTERM")
        stopped = saved[-1]
        rc2, text2, secs2 = _drive([DRIVE + "train_octo", "--steps", "3",
                                    "--resume", *common])
        log(f"  train drive --resume --steps 3: exit code {rc2} in "
            f"{secs2:.1f} s; its last lines:")
        for line in text2.strip().splitlines()[-5:]:
            log(f"    {line[:200]}")
        want = (f"resumed train state from step {stopped}",
                f"resumed data stream at batch {stopped + 2}")
        if rc2 != 0 or "final:" not in text2 or not all(
                w in text2 for w in want):
            fail(f"the resumed train drive did not print {want} and end")
        out["train"] = {"stopped_at_step": stopped, "sigterm_run_s": secs,
                        "resume_run_s": secs2}
    rc, text, secs = _drive([DRIVE + "serve_octo", "--preset", "octo_base",
                             "--head", "diffusion", "--batch", "8",
                             "--requests", "32", "--override",
                             "dtype=bfloat16"])
    log(f"  serve drive, octo_base bf16 B=8, 32 requests: exit code {rc} in "
        f"{secs:.1f} s; {text.strip().splitlines()[-1][:200]}")
    if rc != 0 or "requests in" not in text:
        fail("the serve drive failed")
    out["serve"] = {"s": secs, "last_line": text.strip().splitlines()[-1]}
    return out


# -- phase 30: training on sharded parameters -----------------------------------

HEAD_SPLITS = (2, 4)        # P of a tensor-parallel attention's heads
SHARDED_CHECK_STEPS = 3     # fit steps held against fit() without a mesh
SHARDED_WINDOW = 10         # captured steps a turn, timed


def head_offset_check(fa, label, mask, b, h, d, dtype, out_dtype=None,
                      seed=30, splits=HEAD_SPLITS, timed=True):
    """The three training kernels, dropout 0.1, on the heads of each rank
    of a tensor-parallel attention (P of ``splits``; rank k holds heads
    [k H/P, (k+1) H/P) and launches with h0 = k H/P, heads_total = H):
    each slice's outputs bit for bit with those heads of the whole-head
    launch (dq and dk/dv handed those heads of its LSE and delta), and
    against its plain version under rel_gate.  Then, when ``timed``, the
    device ms of rank 1 of 2 beside the same heads launched without the
    offset (h0 = 0, heads_total = H/2), in turns.  Returns (each kernel's
    largest |kernel - plain| and rel_gate units, with the timings of rank
    1 of 2 when ``timed``; the operands of those timings)."""
    mask, (q, k, v, do), (padded, k_hi, q_lo), tiles = flash_case(
        fa, mask, b, h, d, dtype, seed)
    words = torch.tensor([0x5EED123, 0x0FF5E7], dtype=torch.int64,
                         device="cuda")
    kw = dict(block_q=tiles[0], block_k=tiles[1], dropout_rate=TRAIN_DROPOUT,
              out_dtype=out_dtype)
    out, lse = fa.flash_fwd_lse(q, k, v, padded, k_hi, words, **kw)
    delta = fa.attention_delta(do, out, padded.shape[0])
    whole = {"out": out, "lse": lse,
             "dq": fa.flash_dq(q, k, v, do, lse, delta, padded, k_hi, words,
                               **kw)}
    whole["dk"], whole["dv"] = fa.flash_dkv(q, k, v, do, lse, delta, padded,
                                            q_lo, words, **kw)
    owner = {"out": "flash_fwd_lse", "dq": "flash_dq", "dk": "flash_dkv",
             "dv": "flash_dkv"}
    worst = {kernel: [0.0, 0.0] for kernel in owner.values()}
    ref = plain_of(fa, d)

    def operands(heads):
        sl = lambda t: t[:, :, heads].contiguous()
        return (sl(q), sl(k), sl(v), sl(do), lse[:, heads].contiguous(),
                delta[:, heads].contiguous(), padded)

    for p in splits:
        for rank in range(p):
            heads = slice(rank * h // p, (rank + 1) * h // p)
            extra = dict(h0=heads.start, heads_total=h)
            args = operands(heads)
            got = {}
            got["out"], got["lse"] = fa.flash_fwd_lse(
                *args[:3], padded, k_hi, words, **extra, **kw)
            got["dq"] = fa.flash_dq(*args, k_hi, words, **extra, **kw)
            got["dk"], got["dv"] = fa.flash_dkv(*args, q_lo, words, **extra,
                                                **kw)
            torch.cuda.synchronize()
            same = all(torch.equal(
                got[key], whole[key][:, heads] if key == "lse"
                else whole[key][:, :, heads]) for key in got)
            want = {"out": ref.flash_fwd_lse_reference(
                *args[:3], padded, k_hi, words, **extra, **kw)[0],
                "dq": ref.flash_dq_reference(*args, k_hi, words, **extra,
                                            **kw)}
            want["dk"], want["dv"] = ref.flash_dkv_reference(
                *args, q_lo, words, **extra, **kw)
            parts, ok_all = [], same
            for key, kernel in owner.items():
                ok, err, units = rel_gate(got[key], want[key], dtype)
                ok_all &= ok
                worst[kernel] = [max(worst[kernel][0], err),
                                 max(worst[kernel][1], units)]
                parts.append(f"{key} {err:.2e} ({units:.3f})")
            log(f"  flash {label:15s} P={p} rank {rank} (heads "
                f"{heads.start}-{heads.stop - 1} of {h}): bit for bit with "
                f"the whole-head launch's heads {same}; |kernel-plain| "
                f"{', '.join(parts)} {'ok' if ok_all else 'FAIL'}")
            if not ok_all:
                fail(f"flash {label} P={p} rank {rank} with a head offset")
    if not timed:
        return {kernel: dict(max_abs_err=err, gate_units=units)
                for kernel, (err, units) in worst.items()}, None
    args = operands(slice(h // 2, h))
    calls = {"flash_fwd_lse": lambda **e: fa.flash_fwd_lse(
                 *args[:3], padded, k_hi, words, **e, **kw),
             "flash_dq": lambda **e: fa.flash_dq(*args, k_hi, words, **e,
                                                 **kw),
             "flash_dkv": lambda **e: fa.flash_dkv(*args, q_lo, words, **e,
                                                   **kw)}
    offset = dict(h0=h // 2, heads_total=h)
    rows = {}
    for kernel, call in calls.items():
        ms = device_ms(call, kernel_key(kernel, d))
        ms_h0 = device_ms(lambda: call(**offset), kernel_key(kernel, d))
        ms_again = device_ms(call, kernel_key(kernel, d))
        rows[kernel] = dict(ms_no_offset=ms, ms=ms_h0, ms_again=ms_again,
                            max_abs_err=worst[kernel][0],
                            gate_units=worst[kernel][1])
        log(f"  {kernel:13s} {label:15s} rank 1 of 2, B={b} H={h // 2} of "
            f"{h}: {ms_h0:.4f} ms on the device with h0={h // 2}, "
            f"{ms:.4f} / {ms_again:.4f} ms without (before / after)")
    return rows, (calls, offset, args, (padded, k_hi, q_lo), tiles)


def head_offset_yardsticks(fa, mask, b, h, d, rows, held):
    """For the kernels line: the plain versions' times, the bounds and
    SDPA on rank 1 of 2's heads (octo_deep S=224, bf16, r=0.1)."""
    import torch.nn.functional as F
    calls, offset, args, (padded, k_hi, q_lo), tiles = held
    kw = dict(block_q=tiles[0], block_k=tiles[1], dropout_rate=TRAIN_DROPOUT,
              **offset)
    words = torch.tensor([0x5EED123, 0x0FF5E7], dtype=torch.int64,
                         device="cuda")
    ref = plain_of(fa, d)
    plain = {"flash_fwd_lse": lambda: ref.flash_fwd_lse_reference(
                 *args[:3], padded, k_hi, words, **kw),
             "flash_dq": lambda: ref.flash_dq_reference(*args, k_hi, words,
                                                       **kw),
             "flash_dkv": lambda: ref.flash_dkv_reference(*args, q_lo, words,
                                                         **kw)}
    q, k, v, do = args[:4]
    qh, kh, vh, doh = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    m = torch.as_tensor(mask, device="cuda")
    sdpa = lambda a, bb, c: F.scaled_dot_product_attention(
        a, bb, c, attn_mask=m, dropout_p=TRAIN_DROPOUT)
    lib_fwd, _ = device_total_ms(lambda: sdpa(qh, kh, vh))
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (qh, kh, vh))
    lib_both, _ = device_total_ms(
        lambda: torch.autograd.grad(sdpa(qg, kg, vg), (qg, kg, vg), doh))
    s, nnz = mask.shape[0], int(mask.sum())
    for kernel, kind in (("flash_fwd_lse", "fwd"), ("flash_dq", "dq"),
                         ("flash_dkv", "dkv")):
        nbytes, flops = flash_bytes_flops(b, s, h // 2, d, nnz,
                                          torch.bfloat16, kind)
        bnd, by = bound(nbytes, flops, torch.bfloat16)
        rows[kernel].update(
            plain_ms=time_ms(plain[kernel], iters=3, warmup=1),
            bound_ms=bnd, bound_by=by,
            library_ms=lib_fwd if kind == "fwd" else max(lib_both - lib_fwd,
                                                         0.0))
        log(f"  {kernel:13s} rank 1 of 2 at S={s}: plain "
            f"{rows[kernel]['plain_ms']:.3f} ms, bound {bnd:.5f} ms ({by}), "
            f"SDPA {'forward' if kind == 'fwd' else 'backward'} on those "
            f"heads {rows[kernel]['library_ms']:.4f} ms")


def _nccl_world_of_one():
    """initialize_multihost at world 1 on NCCL (a free local port)."""
    import socket
    from multi_modal_transformers_tokenmerge_torch.parallel import (
        distributed as pd)
    torch.cuda.set_device(0)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    pd.initialize_multihost(f"tcp://localhost:{port}", 1, 0)


def sharded_state(cfg, mesh=None):
    """octo_deep's train state as _fresh_train_state makes it; with a
    ``mesh`` the model goes through shard_params(model_parallel=True,
    fsdp=True) first.  (state, how many parameters came out sharded)."""
    from multi_modal_transformers_tokenmerge_torch.models.octo import Octo
    from multi_modal_transformers_tokenmerge_torch.parallel.mesh import (
        shard_params)
    from multi_modal_transformers_tokenmerge_torch.train.optim import (
        make_optimizer)
    from multi_modal_transformers_tokenmerge_torch.train.state import (
        create_train_state)
    model = Octo(cfg, device="cuda", seed=0)
    if mesh is not None:
        shard_params(model, mesh, model_parallel=True, fsdp=True)
    sharded = sum(hasattr(p, "placements") for p in model.parameters())
    tx = make_optimizer(peak_lr=3e-4, warmup_steps=10, total_steps=1000,
                        params=model, frozen_prefixes=("text_encoder",))
    return create_train_state(model, tx, rngs=0), sharded


def sharded_phase(fa, counters):
    """The three kernels with a head offset (head_offset_check at
    octo_deep's training shapes and the ring tile), then octo_deep bf16 at
    B=32 as its preset sets attention through shard_params on a NCCL mesh
    of one rank and fit(mesh=), eager and captured, against fit()."""
    import itertools
    import torch.distributed as dist
    from multi_modal_transformers_tokenmerge_torch.parallel import mesh as pm
    from multi_modal_transformers_tokenmerge_torch.train.loop import fit
    from multi_modal_transformers_tokenmerge_torch.train.steps import (
        make_train_step)
    out = {"offset": {}}
    for stage, s in enumerate((224, 160, 96)):
        b, strings, st, h, d = FLASH_SHAPES[f"octo_deep_S{s}"]
        rows, held = head_offset_check(fa, f"octo_deep_S{s}",
                                       stage_mask(strings, st), b, h, d,
                                       torch.bfloat16)
        if s == 224:
            head_offset_yardsticks(fa, stage_mask(strings, st), b, h, d,
                                   rows, held)
        out["offset"][f"octo_deep_S{s}"] = rows
    ring_tile = layout_mask(RING_BLOCK_SPEC)[1024:2048, 1024:2048]
    out["offset"]["ring_tile_f32out"], _ = head_offset_check(
        fa, "ring tile", ring_tile, RING_B, RING_H, RING_D, torch.bfloat16,
        out_dtype=torch.float32)
    torch.cuda.empty_cache()

    _nccl_world_of_one()
    try:
        mesh = pm.make_mesh()
        cfg = deep_pallas_config("bfloat16")
        blocks = cfg.transformer.num_blocks
        per_step = {"flash_fwd_lse": blocks, "flash_dq": blocks,
                    "flash_dkv": blocks, "pool_bwd": 1}
        batches = device_batches(cfg, TRAIN_BATCH, SHARDED_CHECK_STEPS,
                                 seed=30)
        n = SHARDED_CHECK_STEPS
        # eager: the main path, every count set to 0 before it
        sharded, count = sharded_state(cfg, mesh)
        for c in counters.values():
            c.launches = 0
        fit(sharded, iter(batches), "diffusion", n, mesh=mesh,
            step_fn=make_train_step("diffusion", jit=False, mesh=mesh))
        torch.cuda.synchronize()
        launches = {k: counters[k].launches for k in per_step}
        out["launches"] = launches
        if launches != {k: v * n for k, v in per_step.items()}:
            fail(f"sharded fit at world 1 launched {launches} in {n} steps; "
                 f"expected {per_step} a step")
        eager = {}
        for name in ("fit", "fit_again"):
            eager[name] = sharded_state(cfg)[0]
            fit(eager[name], iter(batches), "diffusion", n,
                step_fn=make_train_step("diffusion", jit=False))
        torch.cuda.synchronize()
        out["eager_diffs"] = leaf_diffs(eager["fit"], sharded)
        out["eager_spread"] = leaf_diffs(eager["fit"], eager["fit_again"])
        del eager
        torch.cuda.empty_cache()
        # captured: the default step of fit at a mesh of one rank
        steps = {"fit": make_train_step("diffusion"),
                 "fit_mesh": make_train_step("diffusion", mesh=mesh)}
        states = {"fit": sharded_state(cfg)[0],
                  "fit_mesh": sharded_state(cfg, mesh)[0]}
        for name, st in states.items():
            fit(st, iter(batches), "diffusion", n,
                mesh=mesh if name == "fit_mesh" else None,
                step_fn=steps[name])
        torch.cuda.synchronize()
        out["captured_diffs"] = leaf_diffs(states["fit"], states["fit_mesh"])
        for key, label in (("eager_diffs", "eager"),
                           ("captured_diffs", "captured")):
            par, mom, rel = out[key]
            log(f"  octo_deep bf16 B={TRAIN_BATCH}, {count} parameters "
                f"sharded at world 1: fit(mesh=) {label} against fit() "
                f"after {n} steps: largest |difference| parameter {par}, "
                f"moment {mom} (bit for bit: {(par, mom) == (0.0, 0.0)}; "
                f"{rel:.2e} of a leaf, limit {GRAPH_TRAIN_TOL})")
            if count or not rel <= GRAPH_TRAIN_TOL:
                fail(f"the sharded fit at world 1 ({label}) differs from "
                     f"fit()")
        par, mom, rel = out["eager_spread"]
        log(f"  fit() against a second fit(), eager: parameter {par}, moment "
            f"{mom} (the run-to-run spread of octo_deep's backward sums)")
        out["replay_profile"] = replay_profile(
            lambda: steps["fit_mesh"](states["fit_mesh"], *batches[0]), 3,
            {**per_step, **norm_kernels(cfg)},
            "octo_deep sharded at world 1, captured")
        cycle = itertools.cycle(batches)
        ms = {"fit": [], "fit_mesh": []}
        for name in ("fit", "fit_mesh", "fit_mesh", "fit"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fit(states[name], cycle, "diffusion", SHARDED_WINDOW,
                mesh=mesh if name == "fit_mesh" else None,
                step_fn=steps[name])
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3
                            / SHARDED_WINDOW)
        out["ms_per_step"] = ms
        log(f"  captured steps in turns, {SHARDED_WINDOW} a window: fit "
            f"{[round(x, 4) for x in ms['fit']]} ms/step, fit(mesh=) on the "
            f"sharded model {[round(x, 4) for x in ms['fit_mesh']]} ms/step; "
            f"eager launches in {n} steps {launches}, one replay "
            f"{out['replay_profile']['kernels']} "
            f"({out['replay_profile']['device_ms']:.4f} ms on the device)")
        del states, steps, sharded
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return out


# -- phase 31: octo_deep with 6 heads of 128 -----------------------------------

# octo_deep_h128: octo_deep's 768 features split into 6 heads of 128, the
# most common head dim of public transformers, as a user builds it from the
# YAML config; the flash kernels in every block, the max-pool backward kernel
H128_OVERRIDES = ["transformer.attention.num_heads=6",
                  "transformer.attention_impl=flash",
                  "images.resnet.pool_vjp=pallas"]
H128_REQUESTS = 50      # eager requests a batch size; compiled: in turns
H128_TRAIN_STEPS = 10   # the fit window, then as many synced steps


def h128_config(dtype, serving):
    """octo_deep_h128 from ``load_config``: served as phase 9 serves
    octo_deep (``flash_backward='xla'``, attention dropout 0: the forward
    kernel without LSE), trained as its preset sets attention
    (``flash_backward='pallas'``, dropout 0.1 in the kernels)."""
    from multi_modal_transformers_tokenmerge_torch.core.yaml_loader import (
        load_config)
    extra = (["transformer.flash_backward=xla",
              "transformer.attention.dropout_rate=0.0"] if serving else
             ["transformer.flash_backward=pallas"])
    return load_config("octo_deep", [f"dtype={dtype}", *H128_OVERRIDES,
                                     *extra])


def head_dim_phase(counters):
    """octo_deep_h128 at full width on the D=128 kernels: served in bf16
    at batch 1 and 8 (every count set to 0 before and read after: 12
    flash_fwd and 1 ddpm_sampler launches a request), compiled (replays bit
    for bit with the eager calls, in turns with them, 12 flash_fwd a
    replay), in float32 against the CPU under phase 10's limit; trained in
    bf16 at batch 32 through fit (12 flash_fwd_lse, 12 flash_dq, 12
    flash_dkv and 1 pool_bwd launches a step, dropout 0.1 in the kernels),
    captured against the eager step, and one float32 step against the CPU
    under TRAIN_REF_LIMITS."""
    from multi_modal_transformers_tokenmerge_torch.models.octo import Octo
    scfg = h128_config("bfloat16", serving=True)
    att = scfg.transformer.attention
    if (att.num_heads, att.qkv_features // att.num_heads) != (6, 128):
        fail(f"octo_deep_h128 has {att.num_heads} heads of "
             f"{att.qkv_features // att.num_heads}")
    blocks = scfg.transformer.num_blocks
    serving = {"flash_fwd": blocks, "ddpm_sampler": 1}
    training = {"flash_fwd_lse": blocks, "flash_dq": blocks,
                "flash_dkv": blocks, "pool_bwd": 1}
    model = Octo(scfg, device="cuda", seed=0).eval()
    serve_ms, serve_launches = serve_phase(
        model, scfg, counters, "octo_deep_h128 bf16 (ToMe, flash/xla)",
        H128_REQUESTS, serving)
    compiled = compiled_serve_phase({"octo_deep_h128": model}, scfg,
                                    "octo_deep_h128 bf16", serving,
                                    requests=H128_REQUESTS)
    del model
    torch.cuda.empty_cache()
    reference = tome_reference_phase(h128_config("float32", serving=True),
                                     counters, "octo_deep_h128")
    tcfg = h128_config("bfloat16", serving=False)
    if tcfg.transformer.attention.dropout_rate != TRAIN_DROPOUT:
        fail(f"octo_deep_h128's attention dropout is "
             f"{tcfg.transformer.attention.dropout_rate}")
    state, train_ms, train_launches = train_phase(
        tcfg, counters, "octo_deep_h128 (flash/pallas)", training,
        H128_TRAIN_STEPS, H128_TRAIN_STEPS)
    del state
    torch.cuda.empty_cache()
    compiled_train = compiled_train_phase(
        tcfg, "octo_deep_h128 (flash/pallas)", training)
    train_ref = train_reference_phase(h128_config("float32", serving=False),
                                      counters, "octo_deep_h128", training)
    return dict(serve_ms_per_request=serve_ms, serve_launches=serve_launches,
                compiled_serving=compiled, reference=reference,
                train_ms_per_step=train_ms, train_launches=train_launches,
                compiled_training=compiled_train, train_reference=train_ref)


# -- phase 33: octo_deep with 3 heads of 512 -----------------------------------

# octo_deep_h512: octo_deep's 768 features with 3 heads of 512 (its
# projections 1536 wide: DeepSeek-V4-Flash's published head_dim), as a user
# builds it from the YAML config; the wide flash kernels in every block, the
# max-pool backward kernel
H512_OVERRIDES = ["transformer.attention.num_heads=3",
                  "transformer.attention.qkv_features=1536",
                  "transformer.attention_impl=flash",
                  "images.resnet.pool_vjp=pallas"]
H512_REQUESTS = 50      # eager requests a batch size; compiled: in turns
H512_TRAIN_STEPS = 10   # the fit window, then as many synced steps


def h512_config(dtype, serving):
    """octo_deep_h512 from ``load_config``, served and trained as
    :func:`h128_config` serves and trains octo_deep_h128."""
    from multi_modal_transformers_tokenmerge_torch.core.yaml_loader import (
        load_config)
    extra = (["transformer.flash_backward=xla",
              "transformer.attention.dropout_rate=0.0"] if serving else
             ["transformer.flash_backward=pallas"])
    return load_config("octo_deep", [f"dtype={dtype}", *H512_OVERRIDES,
                                     *extra])


def wide_head_phase(counters):
    """octo_deep_h512 at full width on the wide kernels: served in bf16 at
    batch 1 and 8 (every count set to 0 before and read after: 12
    flash_fwd_wide and 1 ddpm_sampler launches a request, no narrow flash
    kernel), compiled (replays bit for bit with the eager calls, 12
    flash_fwd_wide a replay) and in turns with octo_deep's compiled engine,
    in float32 against the CPU under phase 10's limit; trained in bf16 at
    batch 32 through fit (12 flash_fwd_lse_wide, 12 flash_dq_wide, 12
    flash_dkv_wide and 1 pool_bwd launches a step, dropout 0.1 in the
    kernels), captured against the eager step and in turns with octo_deep's
    captured step (phase 13's attention), and one float32 step against the
    CPU under TRAIN_REF_LIMITS."""
    from multi_modal_transformers_tokenmerge_torch.models.octo import Octo
    scfg = h512_config("bfloat16", serving=True)
    att = scfg.transformer.attention
    if (att.num_heads, att.qkv_features // att.num_heads) != (3, 512):
        fail(f"octo_deep_h512 has {att.num_heads} heads of "
             f"{att.qkv_features // att.num_heads}")
    blocks = scfg.transformer.num_blocks
    serving = {"flash_fwd_wide": blocks, "ddpm_sampler": 1}
    training = {"flash_fwd_lse_wide": blocks, "flash_dq_wide": blocks,
                "flash_dkv_wide": blocks, "pool_bwd": 1}
    model = Octo(scfg, device="cuda", seed=0).eval()
    log(f"  octo_deep_h512 bf16: "
        f"{sum(p.numel() for p in model.parameters())} parameters")
    serve_ms, serve_launches = serve_phase(
        model, scfg, counters, "octo_deep_h512 bf16 (ToMe, flash/xla)",
        H512_REQUESTS, serving)
    deep = Octo(deep_config("bfloat16"), device="cuda", seed=0).eval()
    compiled = compiled_serve_phase(
        {"octo_deep_h512": model, "octo_deep": deep}, scfg,
        "octo_deep_h512 bf16", serving, requests=H512_REQUESTS,
        second_expected={"flash_fwd": blocks, "ddpm_sampler": 1})
    del model, deep
    torch.cuda.empty_cache()
    reference = tome_reference_phase(h512_config("float32", serving=True),
                                     counters, "octo_deep_h512",
                                     flash="flash_fwd_wide")
    tcfg = h512_config("bfloat16", serving=False)
    if tcfg.transformer.attention.dropout_rate != TRAIN_DROPOUT:
        fail(f"octo_deep_h512's attention dropout is "
             f"{tcfg.transformer.attention.dropout_rate}")
    state, train_ms, train_launches = train_phase(
        tcfg, counters, "octo_deep_h512 (flash/pallas)", training,
        H512_TRAIN_STEPS, H512_TRAIN_STEPS)
    del state
    torch.cuda.empty_cache()
    compiled_train = compiled_train_phase(
        tcfg, "octo_deep_h512 (flash/pallas)", training,
        twin=("octo_deep", deep_pallas_config("bfloat16"),
              {"flash_fwd_lse": blocks, "flash_dq": blocks,
               "flash_dkv": blocks, "pool_bwd": 1}))
    train_ref = train_reference_phase(h512_config("float32", serving=False),
                                      counters, "octo_deep_h512", training)
    return dict(serve_ms_per_request=serve_ms, serve_launches=serve_launches,
                compiled_serving=compiled, reference=reference,
                train_ms_per_step=train_ms, train_launches=train_launches,
                compiled_training=compiled_train, train_reference=train_ref)


# -- phase 32: octo_base with a 28-wide action chunk ----------------------------

# octo_base_chunk28: octo_base with Octo's 4 x 7 action chunk, a denoiser of
# octo_deep's 4 x 768 MLP width and Diffusion Policy's 100 DDPM steps, as a
# user builds it from the YAML config; its sampler runs on the wide kernel
CHUNK28_OVERRIDES = ["heads.diffusion.action_space_dim=28",
                     "heads.diffusion.mlp_dim=3072",
                     "heads.diffusion.diffusion_steps=100"]
CHUNK28_REQUESTS = 20   # eager requests a batch size; compiled: in turns


def chunk28_config(dtype, ddim_steps=None):
    from multi_modal_transformers_tokenmerge_torch.core.yaml_loader import (
        load_config)
    extra = ([f"heads.diffusion.ddim_steps={ddim_steps}"] if ddim_steps
             else [])
    return load_config("octo_base", [f"dtype={dtype}", *CHUNK28_OVERRIDES,
                                     *extra])


def chunk28_phase(counters):
    """octo_base_chunk28 at full width: served in bf16 through PolicyEngine
    at batch 1, 8 and 64 with DDPM (100 steps) and with DDIM (10 steps),
    eager (every count set to 0 before and read after: one sampler launch
    a request, of the wide kernel, none of the register kernel) and
    compiled (replays bit for bit with the eager calls, one wide kernel
    and no register kernel a replay); in float32 against the CPU under
    E2E_F32_TOL."""
    from multi_modal_transformers_tokenmerge_torch.models.octo import Octo
    out = {}
    expected = {"ddpm_sampler": 1, "ddpm_sampler_wide": 1}
    for label, ddim in (("DDPM", None), ("DDIM", DDIM_STEPS)):
        cfg = chunk28_config("bfloat16", ddim)
        hc = cfg.heads.diffusion
        if ((hc.action_space_dim, hc.mlp_dim, hc.diffusion_steps,
             hc.ddim_steps) != (28, 3072, 100, ddim)):
            fail(f"octo_base_chunk28 {label}: head {hc}")
        model = Octo(cfg, device="cuda", seed=0).eval()
        name = f"octo_base_chunk28 bf16 {label}"
        serve_ms, launches = serve_phase(
            model, cfg, counters, name, CHUNK28_REQUESTS, expected,
            batches=CHUNK28_BATCHES)
        compiled = compiled_serve_phase(
            {"octo_base_chunk28": model}, cfg, name,
            {"ddpm_sampler_wide": 1}, requests=CHUNK28_REQUESTS,
            batches=CHUNK28_BATCHES)
        out[label] = dict(serve_ms_per_request=serve_ms,
                          serve_launches=launches, compiled_serving=compiled)
        del model
        torch.cuda.empty_cache()
    out["reference"] = reference_phase(chunk28_config("float32"),
                                       "octo_base_chunk28", variant="wide")
    return out


def main():
    if not torch.cuda.is_available():
        log("no CUDA device: chip_smoke.py runs on the card only")
        return 2
    t_start = time.perf_counter()
    from multi_modal_transformers_tokenmerge_torch import _build
    from multi_modal_transformers_tokenmerge_torch.models.octo import Octo
    from multi_modal_transformers_tokenmerge_torch.models.presets import (
        octo_base, octo_small)
    from multi_modal_transformers_tokenmerge_torch.ops import (
        flash_attention as fa, group_norm as gn, pool)
    from multi_modal_transformers_tokenmerge_torch.ops.ddpm_sampler import (
        ddpm_sampler)

    global _LOG_FILE
    os.makedirs(OUT_DIR, exist_ok=True)
    _LOG_FILE = open(os.path.join(OUT_DIR, "chip_smoke.log"), "w")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    profile_session(lambda: None)
    log(f"profiler guard: {GUARD_LAUNCHES} launches of "
        f"{_GUARD['key'][:100]}")
    phase("phase 1: build")
    t0 = time.perf_counter()
    reports = _build.build_all()
    for name in reports:
        _build.load_library(name)
    log(f"  built {sorted(reports)} in {time.perf_counter() - t0:.1f} s "
        f"(one nvcc each, in parallel)")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        for name, text in reports.items():
            f.write(f"== {name}\n{text}\n")
    for name, text in reports.items():
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", text)]
        spills = [int(w) for w in re.findall(r"(\d+) bytes spill stores",
                                             text)]
        log(f"  {name}: {len(regs)} kernels, registers {min(regs, default=0)}"
            f"-{max(regs, default=0)}, largest spill store "
            f"{max(spills, default=0)} bytes")
    flash_ptx = flash_ptxas(reports["flash_attention"])
    wide_ptx = flash_ptxas(reports["flash_attention_wide"], strict=False)
    counters = {"ddpm_sampler": ddpm_sampler,
                "ddpm_sampler_wide": ddpm_sampler.by_variant["wide"],
                "flash_fwd": fa.flash_fwd,
                "flash_fwd_lse": fa.flash_fwd_lse, "flash_dq": fa.flash_dq,
                "flash_dkv": fa.flash_dkv,
                **{name: getattr(fa, name) for name in WIDE_KERNELS},
                "pool_bwd": pool.pool_bwd}
    train_kernels = ["flash_fwd", "flash_fwd_lse", "flash_dq", "flash_dkv",
                     "pool_bwd"]
    if sys.argv[1:] == ["--only", "grouped_experts"]:
        grouped = grouped_experts_phase()
        phase(None)
        log(json.dumps({"kernels": [grouped]}))
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    cfg = octo_base(dtype="bfloat16")
    t0 = time.perf_counter()
    model = Octo(cfg, device="cuda", seed=0).eval()
    log(f"octo_base bf16 built on the card in "
        f"{time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in model.parameters())} parameters)")

    phase("phase 2: kernels")
    f32_err, timings = kernel_phase(model.diffusion_action_head)
    wide = wide_kernel_phase(model.diffusion_action_head)
    flash_err, flash_rows, sdpa_kernels, offset_err = {}, {}, {}, {}
    head_err = {}
    for name, (b, strings, stage, h, d) in FLASH_SHAPES.items():
        mask = stage_mask(strings, stage)
        flash_err[name] = flash_check(fa, name, mask, b, h, d)
        offset_err[name] = flash_offset_check(fa, name, mask, b, h, d)
        if d in HEAD_SLICE_DIMS:
            head_err[name] = {
                label: head_offset_check(fa, name, mask, b, h, d,
                                         torch.bfloat16, out_dtype,
                                         splits=(2,), timed=False)[0]
                for label, out_dtype in (("bf16", None),
                                         ("bf16_f32out", torch.float32))}
        flash_rows[name], sdpa_kernels[name] = flash_timings(
            fa, name, mask, b, h, d)
    # the backward at dead rows too (D = 512; the forward's in fwd_shapes)
    flash_err["dead_rows_d512"] = flash_check(fa, "dead_rows_d512",
                                              dead_row_mask(), 2, 3, 512)
    fwd_err = flash_fwd_check(fa)
    wide_fwd = wide_forward_check(fa)
    wide_bwd = wide_backward_check(fa)
    fwd_rows = flash_fwd_timings(fa)
    pad_cost = padding_cost(fa)
    pool_row = pool_check_and_time(pool, TRAIN_BATCH * 50)
    pool_row["windows_above_8"] = pool_windows_check(pool, TRAIN_BATCH * 50)
    pool_row["planes"] = pool_planes_check(pool)
    gn_row = group_norm_check_and_time(gn)
    wide_ring = wide_ring_check(fa)
    auto_gate_check(fa)

    phase("phase 3: serving")
    serve_ms, serve_launches = serve_phase(
        model, cfg, counters, "octo_base bf16", SERVE_REQUESTS,
        {"ddpm_sampler": 1})

    phase("phase 4: reference")
    reference_phase(octo_base(dtype="float32"))

    phase("phase 5: profile")
    profile_phase(model, cfg, serve_ms[1]["median_ms"])

    phase("phase 15: compiled serving, octo_base")
    compiled = {"octo_base_serving": compiled_serve_phase(
        {"octo_base": model}, cfg, "octo_base bf16", {"ddpm_sampler": 1})}
    del model
    torch.cuda.empty_cache()

    phase("phase 6: training")
    tcfg = train_config("bfloat16")
    state, train_ms, train_launches = train_phase(tcfg, counters)
    pool_row["main_path_layout"] = check_pool_layout(pool, "octo_base "
                                                     "training")

    phase("phase 7: training reference")
    blocks = tcfg.transformer.num_blocks
    train_ref = train_reference_phase(
        train_config("float32"), counters, "octo_base",
        {"flash_fwd_lse": blocks, "flash_dq": blocks, "flash_dkv": blocks,
         "pool_bwd": 1})

    phase("phase 8: training profile")
    train_prof = train_profile_phase(state, tcfg, train_ms["ms_per_step"],
                                     train_kernels)
    del state
    torch.cuda.empty_cache()

    phase("phase 16: compiled training, octo_base")
    compiled["octo_base_training"] = compiled_train_phase(
        tcfg, "octo_base", {"flash_fwd_lse": blocks, "flash_dq": blocks,
                            "flash_dkv": blocks, "pool_bwd": 1})
    phase("phase 17: checkpoint on the card")
    compiled["checkpoint"] = checkpoint_phase(tcfg)

    phase("phase 9: ToMe serving")
    dcfg = deep_config("bfloat16")
    t0 = time.perf_counter()
    deep = Octo(dcfg, device="cuda", seed=0).eval()
    stack = deep.transformer
    log(f"octo_deep bf16 built on the card in {time.perf_counter() - t0:.1f} "
        f"s ({sum(p.numel() for p in deep.parameters())} parameters; stages "
        f"of {[stack.get_buffer(f'mask_{i}').shape[0] for i in range(3)]} "
        f"tokens, 4 blocks each)")
    deep_blocks = dcfg.transformer.num_blocks
    deep_ms, deep_launches = serve_phase(
        deep, dcfg, counters, "octo_deep bf16 (ToMe, flash/xla)",
        DEEP_REQUESTS, {"flash_fwd": deep_blocks, "ddpm_sampler": 1})
    baseline = Octo(deep_config("bfloat16", compression_mode="none"),
                    device="cuda", seed=0).eval()
    merge_ms = merge_compare_phase(deep, baseline, dcfg, DEEP_REQUESTS)

    phase("phase 10: ToMe reference")
    deep_ref = tome_reference_phase(deep_config("float32"), counters)

    phase("phase 11: ToMe profile")
    deep_prof = profile_phase(deep, dcfg, deep_ms[1]["median_ms"],
                              "octo_deep bf16", "profile_deep_b1.txt")

    phase("phase 15: compiled serving, octo_deep beside its unmerged twin")
    compiled["octo_deep_serving"] = compiled_serve_phase(
        {"merged": deep, "unmerged": baseline}, dcfg, "octo_deep bf16",
        {"flash_fwd": deep_blocks, "ddpm_sampler": 1},
        requests=COMPILED_REQUESTS // 2)
    del deep, baseline
    torch.cuda.empty_cache()

    phase("phase 12: ToMe training")
    deep_steps = {"flash_fwd": deep_blocks, "pool_bwd": 1}
    state, deep_train_ms, deep_train_launches = train_phase(
        dcfg, counters, "octo_deep", deep_steps, DEEP_TRAIN_STEPS,
        DEEP_TRAIN_STEPS)
    check_pool_layout(pool, "octo_deep training")
    deep_train_prof = train_profile_phase(
        state, dcfg, deep_train_ms["ms_per_step"], train_kernels,
        "octo_deep", "profile_deep_train.txt")
    del state
    torch.cuda.empty_cache()
    deep_train_ref = train_reference_phase(
        deep_config("float32"), counters, "octo_deep", deep_steps)

    phase("phase 13: ToMe training, flash_backward='pallas'")
    pcfg = deep_pallas_config("bfloat16")
    if pcfg.transformer.attention.dropout_rate != TRAIN_DROPOUT:
        fail(f"octo_deep's attention dropout is "
             f"{pcfg.transformer.attention.dropout_rate}")
    state, deep_pallas_ms, deep_pallas_launches = train_phase(
        pcfg, counters, "octo_deep (flash/pallas)",
        {"flash_fwd_lse": deep_blocks, "flash_dq": deep_blocks,
         "flash_dkv": deep_blocks, "pool_bwd": 1}, DEEP_TRAIN_STEPS,
        DEEP_TRAIN_STEPS)
    deep_pallas_prof = train_profile_phase(
        state, pcfg, deep_pallas_ms["ms_per_step"], train_kernels,
        "octo_deep (flash/pallas)", "profile_deep_train_pallas.txt")
    del state
    torch.cuda.empty_cache()
    phase("phase 16: compiled training, octo_deep (flash/pallas)")
    compiled["octo_deep_training_pallas"] = compiled_train_phase(
        pcfg, "octo_deep (flash/pallas)",
        {"flash_fwd_lse": deep_blocks, "flash_dq": deep_blocks,
         "flash_dkv": deep_blocks, "pool_bwd": 1})
    log(f"  octo_deep bf16 B={TRAIN_BATCH}, fit window: flash_backward="
        f"'pallas' (attention dropout {TRAIN_DROPOUT}) "
        f"{deep_pallas_ms['ms_per_step']:.4f} ms/step, device "
        f"{deep_pallas_prof['device_ms']:.4f} ms/step; 'xla' (phase 12, "
        f"attention dropout 0) {deep_train_ms['ms_per_step']:.4f} ms/step, "
        f"device {deep_train_prof['device_ms']:.4f} ms/step")

    phase("phase 14: octo_small, continuous head")
    scfg = octo_small(dtype="bfloat16")
    small = Octo(scfg, device="cuda", seed=0).eval()
    small_ms, _ = serve_phase(small, scfg, counters,
                              "octo_small bf16 (ToMe, continuous head)", 50,
                              {}, head="continuous")
    del small

    phase("phase 18: configs and the CLI on the card")
    ycfg, cli_info = config_cli_phase()
    ymodel = Octo(ycfg, device="cuda", seed=0).eval()

    phase("phase 19: PolicyServer under load (compiled octo_base bf16, B=8)")
    server_eng, server = server_phase(ymodel, ycfg, counters)

    phase("phase 20: the closed loop (ReachTask through the compiled engine)")
    closed_loop = closed_loop_phase(server_eng, ycfg)
    del server_eng, ymodel
    torch.cuda.empty_cache()

    phase("phase 21: the configuration the port refused before")
    refused = refused_phase(counters)

    phase("phase 22: the int8 and w8 serving towers")
    quantized = quantized_phase(counters)
    phase("phase 23: export and load_artifact")
    exported = export_phase()
    phase("phase 24: the mixture-of-experts MLP")
    moe = moe_phase(counters)
    phase("phase 25: ring attention on the card")
    ring = ring_phase(fa, counters)
    phase("phase 26: distributed at world 1 on NCCL")
    distributed = distributed_phase(fa)
    phase("phase 27: the legacy model families, float32 against the CPU")
    legacy = legacy_phase()
    phase("phase 28: rematerialization, octo_deep bf16 B=32")
    remat = remat_phase(counters)
    phase("phase 29: the port's train and serve drives")
    drives = drive_phase()
    phase("phase 30: training on sharded parameters, octo_deep bf16 B=32")
    sharded = sharded_phase(fa, counters)
    phase("phase 31: octo_deep with 6 heads of 128 (octo_deep_h128)")
    h128 = head_dim_phase(counters)
    phase("phase 32: octo_base with a 28-wide action chunk "
          "(octo_base_chunk28)")
    chunk28 = chunk28_phase(counters)
    phase("phase 33: octo_deep with 3 heads of 512 (octo_deep_h512)")
    h512 = wide_head_phase(counters)
    grouped = grouped_experts_phase()
    phase(None)

    ms, call_ms, plain, bnd, by = timings[1]
    kernels = [{
        "name": "ddpm_sampler", "route": "cuda",
        "source": "multi_modal_transformers_tokenmerge_torch/csrc/"
                  "ddpm_sampler.cu",
        "replaces": "multi_modal_transformers_tokenmerge_tpu/ops/"
                    "ddpm_sampler.py:51",
        "launches": serve_launches["ddpm_sampler"], "max_abs_err": f32_err,
        "ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
        "library_ms": None, "call_ms": call_ms,
        "shape": "octo_base bf16 DDPM T=32 H=768 A=8 B=1",
        "launches_octo_deep_serving": deep_launches["ddpm_sampler"],
        "launches_per_compiled_request": compiled["octo_base_serving"][1][
            "replay_profile"]["kernels"]["ddpm_sampler"],
        "launches_per_server_batch": server["batch_profile"]["kernels"][
            "ddpm_sampler"],
        "launches_eager_server_4_batches": server["eager_server_launches"][
            "ddpm_sampler"],
        "launches_per_compiled_request_int8_w8_towers": [
            quantized[f"serving_{m}"][1]["replay_profile"]["kernels"][
                "ddpm_sampler"] for m in QUANT_MODES],
        "launches_per_exported_request": exported["octo_base"][
            "launches_per_request"]["ddpm_sampler"],
        "launches_per_compiled_request_moe_b32": moe["serving_b32"][32][
            "replay_profile"]["kernels"]["ddpm_sampler"],
    }]
    key = "DDPM T=100 B=1"
    kernels.append({
        "name": "ddpm_sampler_wide", "route": "cuda",
        "source": "multi_modal_transformers_tokenmerge_torch/csrc/"
                  "ddpm_sampler_wide.cu",
        "replaces": "multi_modal_transformers_tokenmerge_tpu/ops/"
                    "ddpm_sampler.py:51",
        "launches": chunk28["DDPM"]["serve_launches"]["ddpm_sampler_wide"],
        "max_abs_err": wide["f32_max_abs_err"],
        **{k: wide["timings"][key][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "call_ms")},
        "library_ms": None,
        "octo_base_chunk28_f32_cuda_vs_cpu": chunk28["reference"],
        "largest_loop_gate_units": wide["largest_loop_units"],
        "gate_units_against_register": wide["against_register"],
        "shape": "octo_base_chunk28 bf16 DDPM T=100 H=3072 A=28 B=1",
        "launches_ddim": chunk28["DDIM"]["serve_launches"][
            "ddpm_sampler_wide"],
        "launches_per_compiled_request": {
            label: {b: chunk28[label]["compiled_serving"][b][
                "replay_profile"]["kernels"]["ddpm_sampler_wide"]
                for b in CHUNK28_BATCHES} for label in ("DDPM", "DDIM")},
        "other_shapes": {k: v for k, v in wide["timings"].items()
                         if k != key},
        "versus_register_at_octo_base": wide["versus_register"],
    })
    tpu = "multi_modal_transformers_tokenmerge_tpu/ops/"
    flash_src = ("multi_modal_transformers_tokenmerge_torch/csrc/"
                 "flash_attention.cu")
    kernels.append({
        "name": "flash_fwd", "route": "cuda", "source": flash_src,
        "replaces": f"{tpu}flash_attention.py:60",
        "launches": deep_launches["flash_fwd"],
        "max_abs_err": max(fwd_err.values()),
        **fwd_rows["octo_deep_S224_B1"],
        "library": "SDPA forward, boolean mask",
        "shape": "octo_deep serving bf16 B=1 S=224 H=12 D=64 (stage 0 of 3)",
        "launches_octo_deep_training": deep_train_launches["flash_fwd"],
        "launches_per_compiled_request_octo_deep": compiled[
            "octo_deep_serving"][1]["replay_profile"]["kernels"]["flash_fwd"],
        "launches_per_exported_request_octo_deep": exported["octo_deep"][
            "launches_per_request"]["flash_fwd"],
        "launches_octo_deep_moe_serving": moe["deep_serving"]["launches"][
            "flash_fwd"],
        "other_shapes": {k: v for k, v in fwd_rows.items()
                         if k != "octo_deep_S224_B1"},
    })
    for kernel, line in (("flash_fwd_lse", 328), ("flash_dq", 383),
                         ("flash_dkv", 430)):
        row = flash_rows["octo_base_train"][kernel]
        kernels.append({
            "name": kernel, "route": "cuda", "source": flash_src,
            "replaces": f"{tpu}flash_attention.py:{line}",
            "launches": train_launches[kernel],
            "max_abs_err": max(e[kernel] for e in flash_err.values()),
            **row,
            "library": ("SDPA forward, boolean mask, dropout 0.1"
                        if kernel == "flash_fwd_lse" else
                        "SDPA backward (dq, dk and dv together)"),
            "shape": f"octo_base train bf16 B=32 S=74 H=3 D=256 "
                     f"r={TRAIN_DROPOUT}",
            "launches_octo_deep_training_pallas":
                deep_pallas_launches[kernel],
            "launches_per_compiled_step": compiled["octo_base_training"][
                "replay_profile"]["kernels"][kernel],
            "launches_per_compiled_step_octo_deep": compiled[
                "octo_deep_training_pallas"]["replay_profile"]["kernels"][
                kernel],
            "launches_per_compiled_step_moe": [
                moe[k]["replay_profile"]["kernels"][kernel]
                for k in ("training", "deep_training")],
            "launches_per_step_octo_deep_remat": remat["variants"][
                "on_eager"]["launches_per_step"][kernel],
            "launches_per_compiled_step_octo_deep_remat": remat["variants"][
                "on_captured"]["launches_per_step"][kernel],
            "max_abs_err_batch_offset": max(e[kernel]
                                            for e in offset_err.values()),
            "other_shapes": {name: rows[kernel]
                             for name, rows in flash_rows.items()
                             if name != "octo_base_train"},
        })
    kernels.append({
        "name": "pool_bwd", "route": "cuda",
        "source": "multi_modal_transformers_tokenmerge_torch/csrc/"
                  "pool_bwd.cu",
        "replaces": f"{tpu}pool.py:65",
        "launches": train_launches["pool_bwd"], **pool_row,
        "library": "autograd backward of F.max_pool2d",
        "shape": f"octo_base train bf16 N={TRAIN_BATCH * 50} C=64 23x23, "
                 f"x channels_last, g NCHW",
        "launches_octo_deep_training": deep_train_launches["pool_bwd"],
        "launches_per_compiled_step": compiled["octo_base_training"][
            "replay_profile"]["kernels"]["pool_bwd"],
        "launches_per_compiled_step_moe": [
            moe[k]["replay_profile"]["kernels"]["pool_bwd"]
            for k in ("training", "deep_training")],
    })
    gn_pair = lambda prof: {k: prof["kernels"][k] for k in GN_KERNELS
                            if prof["kernels"][k]}
    kernels.append({
        "name": "group_norm_gelu", "route": "cuda",
        "source": "multi_modal_transformers_tokenmerge_torch/csrc/"
                  "group_norm_gelu.cu",
        "replaces": None,
        "plain": "multi_modal_transformers_tokenmerge_torch/modules/"
                 "image_tokenizer.py: PatchGroupNorm.forward, then F.gelu",
        "launches": gn_pair(chunk28["DDPM"]["compiled_serving"][64][
            "replay_profile"]),
        **{k: gn_row[k] for k in (
            "ms", "stats_ms", "apply_ms", "pair_device_ms", "call_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_rel_err")},
        "library": "F.group_norm on the (E, C, P, H, W) view, bf16 weight "
                   "and bias, then F.gelu(approximate='tanh')",
        "shape": "octo_base_chunk28 serving bf16 B=64: (3200, 64, 21, 21) "
                 "channels_last, 50 patches an element",
        "launches_per_compiled_request_chunk28": {
            b: gn_pair(chunk28["DDPM"]["compiled_serving"][b][
                "replay_profile"]) for b in CHUNK28_BATCHES},
        "launches_per_compiled_request_octo_deep": gn_pair(compiled[
            "octo_deep_serving"][1]["replay_profile"]),
        "launches_per_compiled_step": gn_pair(compiled[
            "octo_base_training"]["replay_profile"]),
        "launches_per_exported_request": exported["octo_base"][
            "launches_per_request"]["group_norm_gelu"],
        "checks": gn_row["checks"], "training": gn_row["training"],
    })
    for kernel, line in (("flash_fwd_lse", 328), ("flash_dq", 383),
                         ("flash_dkv", 430)):
        kernels.append({
            "name": f"{kernel}_f32out", "route": "cuda", "source": flash_src,
            "replaces": f"{tpu}flash_attention.py:{line}",
            "launches": ring["launches"][kernel], **ring["step"][kernel],
            "library": ("SDPA forward" if kernel == "flash_fwd_lse" else
                        "SDPA backward (dq, dk and dv together)") +
                       ", boolean mask, on the same tile",
            "shape": f"one ring step, bf16 in, float32 out, B={RING_B} "
                     f"S={RING_S // RING_P} H={RING_H} D={RING_D}, query "
                     f"shard 1 x key shard 1 of the block-causal layout",
        })
    for kernel, line in (("flash_fwd_lse", 328), ("flash_dq", 383),
                         ("flash_dkv", 430)):
        row = sharded["offset"]["octo_deep_S224"][kernel]
        kernels.append({
            "name": f"{kernel}_head_offset", "route": "cuda",
            "source": flash_src,
            "replaces": f"{tpu}flash_attention.py:{line}",
            "launches": sharded["launches"][kernel],
            "max_abs_err": max(rows[kernel]["max_abs_err"]
                               for rows in sharded["offset"].values()),
            **{key: row[key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "ms_no_offset", "ms_again")},
            "library": ("SDPA forward" if kernel == "flash_fwd_lse" else
                        "SDPA backward (dq, dk and dv together)") +
                       ", boolean mask, dropout 0.1, on the same heads",
            "shape": "rank 1 of 2 of a tensor-parallel attention: octo_deep "
                     "train bf16 B=32 S=224, heads 6-11 of 12 (h0=6), D=64, "
                     f"r={TRAIN_DROPOUT}",
            "launches_from": "phase 30's eager fit(mesh=) of octo_deep bf16 "
                             "B=32 at world 1, 3 steps (h0=0, 12 of 12 "
                             "heads: nothing is sharded at one rank)",
            "launches_per_compiled_step_sharded_world_1": sharded[
                "replay_profile"]["kernels"][kernel],
            "other_shapes": {name: rows[kernel] for name, rows in
                             sharded["offset"].items()
                             if name != "octo_deep_S224"},
        })
    # the flash kernels at head dim 128 on octo_deep_h128's path (phase 31),
    # with head dims 32 and 80 (padded to 128) held and timed beside them
    new_dim = ("deep_h128", "d32_", "d80_")
    for kernel, line in (("flash_fwd", 60), ("flash_fwd_lse", 328),
                         ("flash_dq", 383), ("flash_dkv", 430)):
        if kernel == "flash_fwd":
            row, first = fwd_rows["deep_h128_S224_B1"], "deep_h128_S224_B1"
            others = fwd_rows
            err = max(e for n, e in fwd_err.items() if n.startswith(new_dim))
            extra = {
                "launches_per_compiled_request": h128["compiled_serving"][1][
                    "replay_profile"]["kernels"][kernel],
                "shape": "octo_deep_h128 serving bf16 B=1 S=224 H=6 D=128 "
                         "(stage 0 of 3)",
                "library": "SDPA forward, boolean mask"}
            launches = h128["serve_launches"][kernel]
        else:
            row, first = flash_rows["deep_h128_S224"][kernel], "deep_h128_S224"
            others = {n: rows[kernel] for n, rows in flash_rows.items()}
            err = max(e[kernel] for n, e in flash_err.items()
                      if n.startswith(new_dim))
            extra = {
                "launches_per_compiled_step": h128["compiled_training"][
                    "replay_profile"]["kernels"][kernel],
                "max_abs_err_batch_offset": max(
                    e[kernel] for n, e in offset_err.items()
                    if n.startswith(new_dim)),
                "bf16_err_head_offset": max(
                    rows[kernel]["max_abs_err"] for e in head_err.values()
                    for rows in e.values()),
                "shape": f"octo_deep_h128 train bf16 B=32 S=224 H=6 D=128 "
                         f"r={TRAIN_DROPOUT}",
                "library": ("SDPA forward, boolean mask, dropout 0.1"
                            if kernel == "flash_fwd_lse" else
                            "SDPA backward (dq, dk and dv together)")}
            launches = h128["train_launches"][kernel]
        kernels.append({
            "name": f"{kernel}_d128", "route": "cuda", "source": flash_src,
            "replaces": f"{tpu}flash_attention.py:{line}",
            "launches": launches, "max_abs_err": err, **row, **extra,
            "padding_d80_vs_d128": pad_cost[kernel],
            "other_shapes": {n: r for n, r in others.items()
                             if n.startswith(new_dim) and n != first},
        })
    # the wide kernels (head dims above 256) on octo_deep_h512's path (phase
    # 33), with head dims 320, 576, 768, 300 (padded to 320) and 1152 held
    # and timed beside them
    wide_src = ("multi_modal_transformers_tokenmerge_torch/csrc/"
                "flash_attention_wide.cu")
    wide_shape = lambda n: n.startswith(("deep_h512", "d320", "d576",
                                         "d768", "d300", "d1152",
                                         "dead_rows_d512"))
    for kernel, line in (("flash_fwd", 60), ("flash_fwd_lse", 328),
                         ("flash_dq", 383), ("flash_dkv", 430)):
        name = f"{kernel}_wide"
        if kernel == "flash_fwd":
            first = "deep_h512_S224_B1"
            row, others = fwd_rows[first], fwd_rows
            err = max(e for n, e in fwd_err.items() if wide_shape(n))
            extra = {
                "launches_per_compiled_request": h512["compiled_serving"][1][
                    "replay_profile"]["kernels"][name],
                "shape": "octo_deep_h512 serving bf16 B=1 S=224 H=3 D=512 "
                         "(stage 0 of 3)",
                "library": "SDPA forward, boolean mask"}
            launches = h512["serve_launches"][name]
        else:
            first = "deep_h512_S224"
            row = flash_rows[first][kernel]
            others = {n: rows[kernel] for n, rows in flash_rows.items()}
            err = max(e[kernel] for n, e in flash_err.items()
                      if wide_shape(n))
            extra = {
                "launches_per_compiled_step": h512["compiled_training"][
                    "replay_profile"]["kernels"][name],
                "max_abs_err_batch_offset": max(
                    e[kernel] for n, e in offset_err.items()
                    if wide_shape(n)),
                "bf16_err_head_offset": max(
                    e[label][kernel]["max_abs_err"]
                    for n, e in head_err.items() if wide_shape(n)
                    for label in e),
                "f32out_ring_step": wide_ring["step"][kernel],
                "shape": f"octo_deep_h512 train bf16 B=32 S=224 H=3 D=512 "
                         f"r={TRAIN_DROPOUT}",
                "library": ("SDPA forward, boolean mask, dropout 0.1"
                            if kernel == "flash_fwd_lse" else
                            "SDPA backward (dq, dk and dv together)")}
            launches = h512["train_launches"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": wide_src,
            "replaces": f"{tpu}flash_attention.py:{line}",
            "launches": launches, "max_abs_err": err, **row, **extra,
            "other_shapes": {n: r for n, r in others.items()
                             if wide_shape(n) and n != first},
        })
    log(json.dumps({"wide_heads": h512, "wide_ring": wide_ring,
                    "wide_ptxas": wide_ptx, "wide_forward": wide_fwd,
                    "wide_backward": wide_bwd,
                    "pool_windows": pool_row["windows_above_8"],
                    "pool_planes": pool_row["planes"],
                    "card": card}))
    log(json.dumps({"wide_sampler": {k: v for k, v in wide.items()
                                     if k != "held"},
                    "octo_base_chunk28": chunk28, "card": card}))
    with open(os.path.join(OUT_DIR, "wide_sampler_held.json"), "w") as f:
        json.dump(wide["held"], f, indent=1)
    log(json.dumps({"head_dims": h128, "head_offset_errors": head_err,
                    "padding_cost": pad_cost, "card": card}))
    log(json.dumps({"sharded": sharded, "phase_seconds": _PHASE["seconds"],
                    "card": card}))
    log(json.dumps({"ring": ring, "distributed": distributed,
                    "legacy": legacy, "card": card}))
    log(json.dumps({"remat": remat, "drives": drives,
                    "checkpoint": compiled["checkpoint"], "card": card}))
    log(json.dumps({"flash_ptxas": flash_ptx}))
    log(json.dumps({"serve_ms_per_request": serve_ms,
                    "train_ms_per_step": train_ms,
                    "train_profile": train_prof,
                    "train_reference": train_ref,
                    "sdpa_kernels": sdpa_kernels, "card": card}))
    log(json.dumps({"octo_deep": {
        "serve_ms_per_request": deep_ms, "serve_launches": deep_launches,
        "merged_vs_unmerged_ms": merge_ms, "reference": deep_ref,
        "serve_profile": deep_prof, "train_ms_per_step": deep_train_ms,
        "train_launches": deep_train_launches,
        "train_profile": deep_train_prof,
        "train_reference": deep_train_ref,
        "train_pallas_ms_per_step": deep_pallas_ms,
        "train_pallas_launches": deep_pallas_launches,
        "train_pallas_profile": deep_pallas_prof},
        "octo_small_continuous_ms_per_request": small_ms, "card": card}))
    log(json.dumps({"compiled": compiled, "card": card}))
    log(json.dumps({"cli_info": cli_info, "server": server,
                    "closed_loop": closed_loop, "refused": refused,
                    "card": card}))
    log(json.dumps({"quantized": quantized, "export": exported, "moe": moe,
                    "card": card}))
    log(json.dumps({"profiler": {
        "sessions": len(_GUARD["lost"]), "guard_launches": GUARD_LAUNCHES,
        "guard_records_lost": _GUARD["lost"],
        "sessions_run_again": _GUARD["retries"],
        "kernel_sessions_run_again": _GUARD["short"]}}))
    log(f"run: {time.perf_counter() - t_start:.1f} s")
    kernels.append(grouped)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
