#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card: the quickest proof that the port builds, starts, serves and trains
there.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases, each printed on its own lines; any failure raises, so the exit
code is not 0 and no result line is printed:

1. device — the card's name and power limit (``nvidia-smi``); TF32 off.
2. build — every hand-written kernel under ``src/repro_torch/csrc`` is
   compiled by ``nvcc`` for ``sm_90a`` into ``src/repro_torch/build/``,
   one ``nvcc`` per source, all started together.
3. kernels — each kernel against its plain PyTorch version on the card,
   at the CPU tests' shapes and at full model width (the SSD kernel also
   at head dims 96, 128 and 130, past its 64-column blocks).
4. slice 1 — the governed continuous-batching serving path at the full
   width of ``qwen3_4b`` (36 layers, random fp32 weights from a seeded
   ``torch.Generator``): 8 requests through the LogAct agent, one of them
   from a denylisted tenant; launch counts are zeroed just before and read
   just after. The governed kernel run is made four times, with the
   agent's log on the in-memory bus, in SQLite (group commit on), in
   the segmented KV store and (slice 11a) behind a bus server: a
   ``NetBus`` client of an in-process ``BusServer`` over SQLite with
   group commit (all in a temporary directory): the tokens and the paged
   launch counts must be equal, each durable log is closed (client,
   server, backing bus) and read back by a fresh instance (on the server's
   file a ``SqliteBus``), which must give, with dense positions, the
   entries the agent read and no committed-unexecuted intent; the
   ``NetBus`` must not reconnect. Each run prints its wall,
   the time inside ``PagedEngine.admit``/``step``, the governance time a
   ``serve_step`` intent (the rest), the log's entries and bytes, and the
   calls into the log (appends, reads, tail probes, waits, the seconds
   inside the bus; for the KV store its directory LISTs). The
   same requests are then served on the plain path on the card and the
   tokens compared. Then the prefill and decode step are
   timed on the engine, and paged attention is timed at the main path's
   shape beside its byte/operation bound, its plain version and a PyTorch
   library call.
4b. slice 9 — the port's ``AgentKernel``, its ``serving-continuous``
   spawn image and the swarm ``Supervisor`` on slice 1's full-width
   ``qwen3_4b`` parameters, through slice 1's ``serve``. 9a: one agent
   spawned on SQLite under a ``TrimPolicy``, run on its own threads with
   a reader thread following the tail, while the host loop calls
   ``maintain`` (checkpoint, trim, compact) until every request is done,
   then once more with ``force``; its tokens and paged launches must equal
   slice 1's, a maintain must trim mid-run, the reader must see every
   entry with no ``TrimmedError``, no committed-unexecuted intent may be
   left, a fresh ``SqliteBus`` on the file must read from the trim base
   what the live bus holds, and (broken control) a read of position 0
   must raise ``TrimmedError``. 9b: two agents spawned on memory buses
   serve the requests 4 and 4 (tokens equal slice 1's), a ``Supervisor``
   sweeps them (each worker's completed intents equal its executed
   ``serve_step`` intents; health verdicts printed), checkpoints, and a
   second supervisor's ``bootstrap`` must resume at the checkpoint. Wall,
   engine and governance times, each maintain's pause and the entries
   trimmed and compacted are printed.
4c. slice 10 — automatic failover (``core/failover.py``). 10b, here, on
   slice 1's parameters: an ``ElasticWorkerPool`` over the
   ``serving-continuous`` image scales to two workers, which serve slice
   1's requests 4 and 4; worker 1's executor gets, in a copy of its
   handler dict, a ``serve_step`` that raises. The sweep must replace
   worker 1 as failing, the replacement serves worker 1's requests, the
   tokens must equal slice 1's with the denylisted request rejected, each
   healthy run's paged launches must equal its decode steps x 36, and
   every launch is held to its plain version on its own inputs. Wall,
   engine and governance times per worker and the sweep's time are
   printed. 10a runs inside slice 4's crash drill (phase 7).
4d. slice 11 — the network shared log (``core/netbus.py``,
   ``launch/bus_server.py``) on slice 1's parameters. 11a is slice 1's run
   on ``net`` (above; its governance ms a ``serve_step`` intent printed
   beside SQLite's). 11b: the same run, with the server closed once the
   Result of the ceil(n/2)-th of 11a's n ``serve_step`` intents is
   acknowledged and a successor bound to its port over the same SQLite
   bus; 11c: the same run under the port's
   ``net.server.reply.drop_append`` at the middle one of 11a's appends
   (the append commits, its reply is lost, the retry is answered from
   the server's dedupe table). Each must give slice 1's tokens and paged
   launches (decode steps x 36), a reconnect, and a read-back of as many
   entries as 11a's log, dense, with no committed-unexecuted intent; 11b
   a new server epoch. Their launches, and 11a's, join the ``kernels``
   line.
4e. slice 12 — the components as OS processes (``launch/procs.py``) on
   slice 1's parameters. 12a: slice 1's run with its log on a bus-server
   process (the port's ``BusServerProcess("sqlite", ...)``, reached
   through a ``NetBus``); 12b: the same run with that process SIGKILLed
   (``BusServerProcess.kill``) once the Result of the ceil(n/2)-th
   ``serve_step`` intent is acknowledged, and a successor started on the
   same file and port through ``python -m repro_torch.launch.bus_server``.
   Each must give slice 1's tokens and paged launches, every launch held
   to its plain version, and, once the server processes are gone, a
   read-back by a fresh ``SqliteBus`` of as many entries as 11a's log,
   dense, with no ``_sched`` flag in the agent's view; 12b a reconnect
   and a new server epoch, so no acknowledged append was lost. 12c: the
   process failover drill of the reference's ``tests/test_netbus.py``
   with the port's ``procs``: a bus server, executor, voters, standby and
   driver as processes, the driver SIGKILLed after two results; the plan
   must complete with one InfOut and one execution a step, the lineage's
   intent ids and two elections one epoch apart. The seconds from the
   kill to the standby's election and from there to ``done`` are printed.
   12a's and 12b's launches join the ``kernels`` line.
5. slice 3 — the governed static-batching serving path at the full width
   of ``qwen3_4b``, on slice 1's parameters: the 8 requests of slice 2 in
   two ``serve_batch`` intents, each dense prefill running the
   flash-attention kernel once a layer; launch counts zeroed just before
   and read just after. A denylisted run must abort every intent with no
   launch, a plain run (``use_kernel=False``) must give the same tokens,
   and the (4, 675) prefill's last-position logits and every layer's K/V
   are held against the plain path's, beside two broken controls on the
   plain path (attention not causal; the last layer's attention output
   zeroed) that must break those limits. Then prefill, decode, memory,
   profiles, whether the prefill's q/k/v needed a copy for the kernel,
   and ``flash_mha`` at the slice's own inputs and at gemma2_9b's
   attention shape (head dim 256, softcap) beside its bound, its plain
   version and ``scaled_dot_product_attention``, with its blocks an SM.
   Slice 1's parameters are freed after it.
6. slice 2 — the governed static-batching serving path at the full width
   of ``mamba2_780m`` (48 layers, random fp32 weights): 8 requests in two
   ``serve_batch`` intents, each prefill running the SSD intra-chunk
   kernel once a layer; launch counts zeroed just before and read just
   after. A second run under a ``kind_denylist`` policy must abort every
   intent with no launch; a third on the plain path must give the same
   tokens, and the full-width prefill's logits are held against the plain
   path's. Then prefill, decode, memory, a profile, and ``ssd_intra`` at
   the slice's own inputs beside its bound, its plain version and a
   yardstick of library calls.
7. slice 4 — governed training, which runs none of the three kernels
   (the loss runs the plain attention and SSD under autograd, as the
   reference's does; their launch counts must stay 0 through the slice):
   a 2-layer ``qwen3_4b`` at full widths steps twice on the card and on
   the CPU from the same weights, with AdamW and with Adafactor, beside
   a broken control (the card's lr 1.5x); full-width ``qwen3_4b`` (36
   layers, fp32, Adafactor, remat full, 4 x 256 tokens a step from a
   4096-token data vocabulary) trains to step 8 under a RuleVoter on
   ``STANDARD_RULES``, with a checkpoint at step 4 and a final eval;
   step 4 is restored and steps 5-8 replayed (they must give the first
   run's losses; from cursor 5, the broken control, they must not);
   a ``StandbyExecutor`` on the governed run's healthy log must stay
   passive (10a); then the executor-crash drill on the same env, its log
   in SQLite, where a second ``SqliteBus`` on the file must see the
   agent's one pending ``train_chunk``, and (10a) a ``StandbyExecutor``
   reading the file through its own ``SqliteBus`` on the real clock must
   stay passive until the chunk is older than its timeout, then take over
   through an announced reboot and roll the agent forward to step 8 with
   one probe (the seconds from the crash to the takeover, the cost of a
   ``check()`` on the file and the roll-forward's wall are printed); then
   one full-width
   ``mamba2_780m`` step (two SSD chunks of 256) must give a finite grad
   norm, and the reference's ``where(exp)`` order a NaN one. Step time,
   tokens/s, peak memory and checkpoint I/O are printed; the checkpoint
   lives in a temporary directory removed afterwards.
8. slice 5 — three more configs at full width, one after another, each
   one's weights freed before the next and its peak memory printed, each
   with its ``wq``/``wk`` scaled so that its attention scores have std
   SCORE_STD: ``gemma2_9b`` (42 layers, local/global windows, softcaps)
   through the governed static agent with a 4,500-token prompt beside one
   of 600, so that the flash kernel's 4096 window masks keys;
   ``chatglm3_6b`` (32 heads on 2 kv heads) through the governed
   continuous agent on slice 1's request pattern; ``mixtral_8x7b`` at 8
   of its 32 layers through the governed static agent with prompts of
   4,500 and 1,000 tokens. Each runs twice, kernel (flash once a layer a
   prefill, or paged once a layer a step) then plain, and the tokens
   must be equal. Every kernel launch of the kernel run is held to its
   plain version on its own inputs under slice 3's rule, beside a broken
   control (plain without the window; plain with the kv heads rolled).
   The static prefills' logits and every layer's K/V are held to the
   plain path's; for mixtral up to the first layer where the two paths
   route a token otherwise, which must come after layer 0. Mixtral's
   capacity rule must drop (token, expert) pairs, and a no-drop control
   must move the logits; gemma2's window control must too. Then prefill
   and decode times and profiles, and flash at gemma2's windowed layer
   beside its bound and sdpa.
9. slice 6 — the last three families at full width through the governed
   static agent, one after another, each one's weights freed before the
   next, each with the ``wq``/``wk`` of every attention tree (the shared
   block's, the encoder's, the decoder's self and cross) scaled as in
   slice 5 (whisper's further, to score std WHISPER_SCORE_STD, with the
   cross keys scaled for the encoder output's RMS: at SCORE_STD its
   plain path moves by about the held limits when only the order of its
   attention sums changes; both noise floors are printed):
   ``zamba2_1p2b`` (38 mamba2 layers and one shared
   attention+MLP block after every 6th, windowed 4096) with prompts of
   4,500 and 600 tokens (38 ``ssd_intra`` and 6 flash launches a
   prefill); ``whisper_small`` (12 encoder layers over 1500 zero frames,
   12 decoder layers with cross-attention) with prompts of 40 and 24
   tokens (36 flash launches a prefill: encoder, decoder self and cross);
   ``internvl2_26b`` at 24 of its 48 layers behind 256 zero patch
   embeddings with prompts of 1,024 and 300 tokens (24 flash launches a
   prefill at 48/8 heads). Each runs twice, kernel then plain, with the
   same tokens. A further prefill of the served batch (on unit-normal
   frames or patch embeddings for whisper and internvl2) holds every
   kernel launch to its plain version on its own inputs, beside a broken
   control (plain without the window, or with ``causal`` flipped; for
   ``ssd_intra`` plain with each chunk's last x row zeroed), and the
   logits, every layer's K/V, zamba2's final SSM states and whisper's
   encoder K/V to the plain path's. Broken controls on the plain path
   must break those limits: zamba2 without the shared window, whisper
   with the encoder causal, internvl2 with the patch prefix dropped.
   Then prefill and decode times, peak memory and profiles, flash at
   zamba2's windowed shared block and at whisper's cross-attention, and
   ``ssd_intra`` at zamba2's layer 0, each beside its bound.
10. slice 7 — the entry points and the int8 KV cache at full width:
   ``repro_torch.launch.serve.main(["--full-config", "--arch", ...])``
   for ``qwen3_4b`` (one ``serve_batch`` of the launcher's 8 requests of
   3 tokens: 36 flash launches) and ``mamba2_780m`` (48 ``ssd_intra``
   launches), launch counts zeroed just before and read just after, each
   beside the same launcher on the plain path and the same parameters
   (equal tokens), and a held prefill of the served batch (every launch
   against its plain version beside its broken control; the logits and
   K/V or SSM states); ``Model(qwen3_4b, kv_quant=True)`` on slice 3's
   two batches, its int8 K/V against the plain path's, its bytes beside
   the fp32 cache's, 16 decode steps whose softmax must stay within 0.05
   of the fp32 cache's (a control with the ints rolled by one kv head
   must not); ``repro_torch.launch.train.main`` at full-width
   ``qwen3_4b`` (AdamW, remat dots) for 16 steps on a SQLite log that a
   second reader opens, its step time, peak memory and the step-8
   checkpoint's save seconds and bytes; the port's three examples
   (quickstart, fault-tolerant training, the supervised serving swarm) at
   smoke scale on the card with their own asserts.
11. slice 8 — the dry-run (``repro_torch.launch.dryrun``) on the card's
   machine: 8a traces all 40 (arch x shape) cells on the meta device at
   full depth (33 ok, 7 documented skips), and each decode cell of a
   family with attention caches again with the int8 cache, with nothing
   allocated on the card; 8b builds each decode cell whose
   ``argument_bytes`` is at most half the card (a decode step copies its
   cache) for real at full width, holds the bytes the card allocates to
   the record's (within 512 B a tensor; an int8 cell's allocation against
   its fp32 record is the broken control that must fail), runs one decode
   step at the last position the cache holds, holds the logits' and every
   cache leaf's shape and dtype to the meta trace's and the logits
   finite, and prints the peak memory over the arguments and the step's
   median time beside the roofline's (whose cache term counts K/V and
   conv state at bf16) and beside ``argument_bytes / HBM_BW``, the time to
   read every argument once. No kernel launches in this slice.
12. a ``{"kernels": [...]}`` JSON line (each kernel's launches are those
   of its governed kernel runs, named on the line before), the card's
   name and power limit, and last the ``{"ok": true, "device": ...}``
   line.
"""
from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the card's published peaks (H100 SXM data sheet, 700 W): bytes/s of HBM3
# and fp32 FLOP/s outside the tensor cores (the kernels do fp32 FMAs)
from repro_torch.distributed.roofline import HBM_BW, PEAK_FLOPS  # noqa: E402

SEED = 0
KERNEL_TOL = 1e-4  # unit-normal inputs, fp32; sums run in another order
# main-path geometry (qwen3_4b at full width)
MAX_BATCH, PAGE_SIZE, NUM_PAGES, MAX_PAGES_PER_SEQ = 4, 16, 257, 64
KERNELS = ("paged_attention", "ssd_scan", "flash_attention")  # csrc/
# flash attention vs its plain version: the reference's fp32 tolerance
# for its flash kernel against mha_ref (atol = rtol)
FLASH_TOL = 2e-5
# slices 2 and 3 (static discipline): requests, their tokens, batch size
STATIC_REQUESTS, STATIC_NEW_TOKENS, STATIC_MAX_BATCH = 8, 16, 4
# the full-width prefill's logits, kernel vs plain: 36-48 layers compound
# the kernels' ~1e-6 relative differences
LOGIT_RTOL = 1e-3
# what the prefill leaves in the cache (every layer's final SSM state, or
# every layer's K and V): atol CACHE_TOL x max|plain| plus rtol CACHE_TOL
CACHE_TOL = 1e-4
# slice 4 (training). The data: the pipeline's dense vocab x vocab table
# cannot be built at qwen3_4b's 151,936 (92 GB), so its tokens come from a
# 4096-token vocabulary; the model, its padded head and the loss keep full
# width.
TRAIN_DATA = dict(vocab=4096, seq_len=256, global_batch=4)
TRAIN_STEPS, TRAIN_CHUNK = 8, 4
# card vs CPU (fp32 on both, sums in another order): losses and grad norms
# to TRAIN_RTOL; each updated parameter leaf's distance from the CPU's
# within UPDATE_RTOL of the CPU's update of that leaf
TRAIN_RTOL, UPDATE_RTOL = 1e-4, 1e-3
# the replayed steps 5-8 against the first run's (bitwise where the card
# is deterministic)
REPLAY_RTOL = 1e-5
# slice 5: gemma2_9b's prompts pass its 4096 window; mixtral_8x7b's too
# (its ring-buffer cache wraps in decode), at 8 of its 32 layers (the
# whole model is 187 GB in fp32)
SLICE5_NEW_TOKENS = 8
GEMMA2_PROMPTS = (4500, 600)
MIXTRAL_PROMPTS = (4500, 1000)
MIXTRAL_LAYERS = 8
# slice 6: zamba2_1p2b's prompts pass its shared block's 4096 window;
# internvl2_26b runs 24 of its 48 layers (the whole model is ~79 GB in
# fp32, the card's whole memory), its prompts behind 256 patch tokens
ZAMBA2_PROMPTS = (4500, 600)
WHISPER_PROMPTS = (40, 24)
INTERNVL2_PROMPTS = (1024, 300)
INTERNVL2_LAYERS = 24
# whisper_small's attention scores in slice 6 (see _whisper_weights)
WHISPER_SCORE_STD = 1.0
# slice 7: the launchers' argument lists, and the int8 KV cache's decode
# (slice 3's batches, extra_cache and new tokens); its softmax against the
# exact fp32 cache's (tests/test_models.py:158-172)
SERVE_ARGV = ["--full-config", "--arch"]
# 16 steps: the launcher checkpoints every max(16 // 3, 8) = 8 steps, so
# its run saves the step-8 checkpoint (params and AdamW state) on the way
TRAIN_ARGV = ["--full-config", "--arch", "qwen3_4b", "--bus", "sqlite",
              "--steps", "16"]
TRAIN_CKPTS = [8]
EXAMPLES = (("quickstart_torch", []),
            ("fault_tolerant_train_torch", ["--steps", "48"]),
            ("swarm_serve_torch", []))
INT8_SOFTMAX_LIMIT = 0.05
# slice 8: the dry-run's cells (all, ok, skipped), the decode cells built
# on the card (argument_bytes at most half its memory: a decode step copies
# its cache), the caching allocator's rounding a tensor, and the decode
# step's timing (warm-ups, then the median of the timed runs)
DRYRUN_CELLS = (40, 33, 7)
ON_CARD_BYTES = 40e9
ALLOC_ROUND = 512
DECODE_WARMUP, DECODE_TIMED = 2, 5
# slice 1's governed kernel run is made once on each of these logs: the
# in-memory bus, SQLite with group commit, the segmented KV store, and
# (slice 11a) a NetBus to an in-process BusServer over SQLite
SERVE_BUSES = ("memory", "sqlite", "kv", "net")
# slice 11b: the deadline for a successor BusServer to bind its
# predecessor's port
REBIND_DEADLINE_S = 10.0
# slice 12c (and tests/test_torch_procs.py): the process failover drill of
# the reference's tests/test_netbus.py:277-342 at its sizes: a plan of six
# incr steps of 0.2 s each, the standby's 2 s of quiescence before it takes
# over, the driver SIGKILLed after two results, and the deadlines before
# and after the kill
PROC_STEPS, PROC_WORK_S, PROC_TAKEOVER_S = 6, 0.2, 2.0
PROC_KILL_AFTER = 2
PROC_DEADLINES_S = (60.0, 90.0)
PROC_DRIVER_ID = "driver-main"
# slice 9a's TrimPolicy (slice 1's run writes 239 entries, so a maintain
# falls mid-run; the entries kept below the low-water mark give the reader
# thread room), and the deadline of each of slice 9's waits
TRIM_EVERY, TRIM_RETAIN = 120, 32
SLICE9_DEADLINE_S = 300.0
# slice 10a: the standby's takeover timeout in slice 4's crash drill, on
# the real clock (the pending chunk's intent is two training steps, ~2 s,
# old at the crash)
TAKEOVER_TIMEOUT_S = 6.0
# slice 9's spawns: the full-width qwen3_4b on the card, with slice 1's
# engine sizes
SPAWN_IMAGE_KW = {"arch": "qwen3_4b", "smoke_cfg": False, "device": "cuda",
                  "max_batch": MAX_BATCH, "num_pages": NUM_PAGES,
                  "page_size": PAGE_SIZE,
                  "max_pages_per_seq": MAX_PAGES_PER_SEQ}
# slice 5's attention weights. init_params' rule (normal / sqrt(fan-in),
# and wq's fan-in is its head count) gives q and k entries of std
# sqrt(d_model / heads), so without qk norm these configs' scores
# q.k / sqrt(head_dim) have a std in the hundreds, where fp32 attention
# outputs turn on the order of their sums. wq and wk are scaled so that the
# scores have this std, of the order a trained checkpoint's have.
SCORE_STD = 4.0


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


# Timed runs must reach the card's queue faster than it runs them, or the
# time the host takes to launch them is timed too. So the card is first
# given SPIN_MATMULS products of two (SPIN_N, SPIN_N) fp32 matrices (a few
# ms each on an H100 with TF32 off), and the runs are queued behind them.
SPIN_N, SPIN_MATMULS = 4096, 32
_spin_mats = []


def _spin(n_matmuls: int) -> None:
    import torch
    if not _spin_mats:
        a = torch.randn((SPIN_N, SPIN_N), device="cuda")
        _spin_mats.extend((a, torch.empty_like(a)))
    a, out = _spin_mats
    for _ in range(n_matmuls):
        torch.mm(a, a, out=out)


def _time_ms(fn, flush, n: int = 30) -> float:
    """Mean device time of ``fn`` over ``n`` runs, each timed with CUDA
    events and each after a write of ``flush`` (larger than the 50 MB L2)
    so that every run finds its inputs in device memory, as a decode step
    finds another layer's K/V. The runs are queued behind a spin of the
    card. A run's events can hold a wait on the host only if the card
    reached its start event before the host had queued the whole run; if
    any run's start event had completed by then, the runs are timed again
    behind twice the spin."""
    import torch
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    spin = SPIN_MATMULS
    while True:
        torch.cuda.synchronize()
        _spin(spin)
        late = False
        for s, e in zip(starts, ends):
            flush.zero_()
            s.record()
            fn()
            e.record()
            late = late or s.query()
        torch.cuda.synchronize()
        if not late:
            return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / n
        if spin >= 16 * SPIN_MATMULS:
            raise RuntimeError("the host could not queue the timed runs "
                               "while the card was busy")
        spin *= 2


def _paged_case(rng, s_n, h, kv, dh, page, n_pages_pool, ctx_lens):
    """Random pool + disjoint shuffled block tables (page 0 = null)."""
    import numpy as np
    import torch
    kp = rng.standard_normal((n_pages_pool, page, kv, dh)).astype(np.float32)
    vp = rng.standard_normal((n_pages_pool, page, kv, dh)).astype(np.float32)
    q = rng.standard_normal((s_n, h, dh)).astype(np.float32)
    max_pages = -(-max(max(ctx_lens), 1) // page)
    avail = list(rng.permutation(np.arange(1, n_pages_pool)))
    bt = np.zeros((s_n, max_pages), np.int32)
    for i, cl in enumerate(ctx_lens):
        for j in range(-(-cl // page)):
            bt[i, j] = avail.pop()
    cl = np.asarray(ctx_lens, np.int32)
    return [torch.from_numpy(a).cuda() for a in (q, kp, vp, bt, cl)]


def check_paged_attention():
    """Phase 3: the CUDA kernel against its plain version on the card."""
    import numpy as np
    import torch
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.paged_attention import (_split_plan,
                                                     paged_attention,
                                                     paged_attention_plain)
    rng = np.random.default_rng(SEED)
    # a chunk of several 32-key tiles a block (its size chosen from shapes
    # by _split_plan): 24 lanes of 128 pages
    chunk = _split_plan(24, 8, 4, 128 * 16, cuda_lib.n_sm(0))[1]
    cases = [  # (label, shape, options)
        ("gqa 4/4", dict(s_n=3, h=4, kv=4, dh=32, page=8, n_pages_pool=16,
                         ctx_lens=[5, 16, 23]), {}),
        ("gqa 4/2", dict(s_n=3, h=4, kv=2, dh=32, page=8, n_pages_pool=16,
                         ctx_lens=[5, 16, 23]), {}),
        ("gqa 8/1", dict(s_n=3, h=8, kv=1, dh=32, page=8, n_pages_pool=16,
                         ctx_lens=[5, 16, 23]), {}),
        ("ragged", dict(s_n=5, h=4, kv=2, dh=16, page=8, n_pages_pool=24,
                        ctx_lens=[1, 7, 8, 17, 0]), {}),
        ("softcap+scale", dict(s_n=2, h=4, kv=2, dh=16, page=4,
                               n_pages_pool=12, ctx_lens=[6, 11]),
         dict(softcap=30.0, scale=0.25)),
        ("full width", dict(s_n=8, h=32, kv=8, dh=128, page=16,
                            n_pages_pool=520,
                            ctx_lens=[0, 1, 15, 16, 17, 300, 1000, 2047]),
         {}),
        ("full width softcap+scale",
         dict(s_n=8, h=32, kv=8, dh=128, page=16, n_pages_pool=520,
              ctx_lens=[0, 1, 15, 16, 17, 300, 1000, 2047]),
         dict(softcap=50.0, scale=0.05)),
        ("many splits", dict(s_n=2, h=32, kv=8, dh=128, page=16,
                             n_pages_pool=800, ctx_lens=[4096, 8191]), {}),
        ("split edges", dict(s_n=7, h=32, kv=8, dh=128, page=16,
                             n_pages_pool=64,
                             ctx_lens=[31, 32, 33, 63, 64, 65, 0]), {}),
        (f"long chunks ({chunk} keys)",
         dict(s_n=24, h=32, kv=8, dh=128, page=16, n_pages_pool=800,
              ctx_lens=[chunk - 1, chunk, chunk + 1, 2 * chunk + 1, 2047,
                        0] * 4), {}),
        ("page 256", dict(s_n=3, h=32, kv=8, dh=128, page=256,
                          n_pages_pool=12, ctx_lens=[255, 700, 257]), {}),
        ("page 64 head dim 256", dict(s_n=3, h=16, kv=8, dh=256, page=64,
                                      n_pages_pool=24,
                                      ctx_lens=[64, 600, 129]),
         dict(softcap=50.0)),
        ("chatglm3_6b heads 32/2 (16 a kv head)",
         dict(s_n=5, h=32, kv=2, dh=128, page=16, n_pages_pool=160,
              ctx_lens=[0, 1, 17, 556, 1023]), {}),
        ("codeqwen15_7b heads 32/32 (1 a kv head)",
         dict(s_n=5, h=32, kv=32, dh=128, page=16, n_pages_pool=160,
              ctx_lens=[0, 1, 17, 556, 1023]), {}),
    ]
    worst = 0.0
    for label, shape, kw in cases:
        case = _paged_case(rng, **shape)
        out = paged_attention(*case, **kw)
        torch.cuda.synchronize()
        ref = paged_attention_plain(*case, **kw)
        err = (out - ref).abs().max().item()
        zero_rows = out[case[4] == 0]
        same = torch.equal(out, paged_attention(*case, **kw))
        if not (err <= KERNEL_TOL and torch.all(zero_rows == 0)
                and torch.isfinite(out).all() and same):
            raise AssertionError(f"paged_attention {label}: max abs err "
                                 f"{err} > {KERNEL_TOL}, bad zero rows or "
                                 f"a second call not bitwise equal")
        print(f"  paged_attention {label}: q {tuple(case[0].shape)} "
              f"page {shape['page']} ctx {shape['ctx_lens']} {kw or ''}"
              f" max_abs_err {err:.3e} (tol {KERNEL_TOL}); a second call "
              f"bitwise equal")
        worst = max(worst, err)
        if label == "full width":
            control = case, out
    # broken control: the plain version one key short of every context
    # must miss the kernel by more than the tolerance
    (q, kp, vp, bt, cl), out = control
    short = paged_attention_plain(q, kp, vp, bt, (cl - 1).clamp(min=0))
    miss = (out - short).abs().max().item()
    print(f"  control, plain at context_lens - 1 (full width): max abs diff "
          f"{miss:.3e} from the kernel "
          f"({'over' if miss > KERNEL_TOL else 'within'} the tolerance)")
    if not miss > KERNEL_TOL:
        raise AssertionError("paged_attention: the check cannot see a "
                             "missing key")
    return worst


def time_paged_attention(case, flush):
    """Kernel, plain version, bound and library call at one input set."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.paged_attention import (_split_plan,
                                                     paged_attention,
                                                     paged_attention_plain)
    q, kp, vp, bt, cl = case
    s_n, h, dh = q.shape
    kv = kp.shape[2]
    # the kernel's split (from shapes) and the blocks that find keys
    hb, chunk, n_splits = _split_plan(s_n, kv, h // kv,
                                      bt.shape[1] * kp.shape[1],
                                      cuda_lib.n_sm(q.device))
    n_hg = -(-(h // kv) // hb)
    active = sum(-(-min(c, bt.shape[1] * kp.shape[1]) // chunk)
                 for c in cl.tolist()) * kv * n_hg
    blocks = (f"{n_splits} splits of {chunk} keys, {hb} query heads a "
              f"block: {active} of {n_splits * kv * n_hg * s_n} blocks "
              f"find keys")
    ms = _time_ms(lambda: paged_attention(*case), flush)
    plain_ms = _time_ms(lambda: paged_attention_plain(*case), flush)
    # the least work: q and the context's K/V rows read once, the block
    # table and lengths read, the output written; 2 FLOPs per MAC for
    # q.K and p.V over every context key of every query head
    ctx = int(cl.sum())
    n_bytes = 4 * (q.numel() + 2 * ctx * kv * dh + bt.numel() + cl.numel()
                   + q.numel())
    n_ops = 4 * ctx * h * dh
    bytes_ms = n_bytes / HBM_BW * 1e3
    ops_ms = n_ops / PEAK_FLOPS * 1e3
    # yardstick only: one library call on K/V gathered beforehand
    n_ctx = bt.shape[1] * kp.shape[1]
    kd = kp[bt.long()].reshape(s_n, n_ctx, kv, dh).repeat_interleave(
        h // kv, dim=2).transpose(1, 2).contiguous()
    vd = vp[bt.long()].reshape(s_n, n_ctx, kv, dh).repeat_interleave(
        h // kv, dim=2).transpose(1, 2).contiguous()
    mask = (torch.arange(n_ctx, device=q.device)[None]
            < cl[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        q4, kd, vd, attn_mask=mask), flush)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=library_ms, ctx=cl.tolist(), blocks=blocks)


def make_requests(cfg, rng, n: int = 8):
    """n requests: prompt lengths 16-700, 8-32 new tokens, one from the
    denylisted tenant ``blocked``."""
    blocked = int(rng.integers(0, n))
    reqs = []
    for i in range(n):
        plen = int(rng.integers(16, 701))
        reqs.append({"req_id": f"req-{i}",
                     "prompt_tokens": rng.integers(0, cfg.vocab,
                                                   size=plen).tolist(),
                     "max_new_tokens": int(rng.integers(8, 33)),
                     "tenant": "blocked" if i == blocked else "default"})
    return reqs


def _bus_meter(bus):
    """Counts and times the calls into ``bus`` over a run, through
    wrappers set on the instance: batches and entries appended, reads,
    tail probes, waits, the host seconds inside the bus (outermost calls
    only, so ``append`` over ``append_many`` counts once), and for a
    ``KvBus`` its ``_refresh`` calls (a directory LIST each, with the
    fetch of segments it had not seen) and their seconds. Returns the
    dict the wrappers fill."""
    meter = dict(appends=0, entries=0, reads=0, tails=0, waits=0,
                 lists=0, bus_s=0.0, list_s=0.0)
    depth = threading.local()

    def wrap(name, key):
        fn = getattr(bus, name)

        def counted(*args, **kw):
            meter[key] += 1
            if key == "appends":
                meter["entries"] += len(args[0])
            outer = not getattr(depth, "n", 0)
            depth.n = getattr(depth, "n", 0) + 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                depth.n -= 1
                dt = time.perf_counter() - t0
                if key == "lists":
                    meter["list_s"] += dt
                elif outer:
                    meter["bus_s"] += dt
        setattr(bus, name, counted)

    for name, key in (("append_many", "appends"), ("read", "reads"),
                      ("tail", "tails"), ("_wait_for_append", "waits")):
        wrap(name, key)
    if hasattr(bus, "_refresh"):
        wrap("_refresh", "lists")
    return meter


def serve(cfg, params, requests, use_kernel: bool, bus=None, agent=None,
          run=None):
    """Phase 4: one governed run of the serving agent on the card, on
    ``bus`` (a fresh MemoryBus by default), or of ``agent``, a continuous
    serving agent built elsewhere (an ``AgentKernel``'s spawn). The engine
    on ``params`` is set on the agent's env, the admission voter and the
    policies are added and the requests mailed; then ``run(agent)``
    drives it (``run_until_idle`` by default) and returns the entries it
    saw, or None for the log read from its trim base. Besides the wall,
    it reads the time inside ``PagedEngine.admit`` and
    ``PagedEngine.step`` (each ends in a host read of its tokens), the
    serve_step intents, what the agent's client reads off the log and the
    calls into the bus (``_bus_meter``)."""
    import torch
    from repro_torch.core.acl import BusClient
    from repro_torch.core.entries import PayloadType
    from repro_torch.core.voter import RuleVoter
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.serving.engine import PagedEngine
    from repro_torch.serving.server import (SERVE_ADMISSION_RULES,
                                            build_continuous_serving_agent)
    if agent is None:
        agent = build_continuous_serving_agent(
            cfg, max_batch=MAX_BATCH, num_pages=NUM_PAGES,
            page_size=PAGE_SIZE, max_pages_per_seq=MAX_PAGES_PER_SEQ,
            use_kernel=use_kernel, bus=bus, device="cuda")
    env = agent.executor.env
    env.engine = PagedEngine(cfg, max_batch=env.max_batch,
                             num_pages=env.num_pages,
                             page_size=env.page_size,
                             max_pages_per_seq=env.max_pages_per_seq,
                             use_kernel=env.use_kernel, params=params,
                             device=env.device)
    meter = _bus_meter(agent.bus)
    model_s = {}
    for name in ("admit", "step"):
        setattr(env.engine, name,
                _timed(getattr(env.engine, name), model_s, name))
    voter = RuleVoter(BusClient(agent.bus, "v-rule", "voter"),
                      rules=SERVE_ADMISSION_RULES)
    agent.add_voter(voter, from_tail=False)
    agent.set_policy("decider", {"mode": "first_voter"})
    agent.set_policy("voter:rule", {"tenant_denylist": ["blocked"]})
    for r in requests:
        agent.send_mail(f"request {r['req_id']}", **r)
    torch.cuda.synchronize()
    paged_attention.launches = 0
    t0 = time.perf_counter()
    log = (run or (lambda a: a.run_until_idle()))(agent)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = paged_attention.launches
    calls = dict(meter)
    if log is None:
        log = agent.external_client("smoke", "admin").read(
            agent.bus.trim_base())
    admit_steps = [e.body["value"]["step"] for e in log
                   if e.type == PayloadType.RESULT
                   and e.body["value"].get("admitted")]
    n_aborts = sum(e.type == PayloadType.ABORT for e in log)
    n_intents = sum(e.type == PayloadType.INTENT
                    and e.body["kind"] == "serve_step" for e in log)
    return dict(planner=agent.driver.planner, engine=env.engine, wall=wall,
                launches=launches, admit_steps=admit_steps,
                n_aborts=n_aborts, log=log, n_intents=n_intents,
                calls=calls, model_s=sum(sum(v) for v in model_s.values()))


def _ssd_case(rng, b, nc, q, h, p, g, n, a=None):
    """SSD inputs on the card: x, B, C normal; dt = softplus(normal), as
    the model draws it at dt_bias 0; A from the reference's tests or a
    constant (A = -1 is the model's, A_log = 0)."""
    import numpy as np
    import torch
    f = np.float32
    x = rng.standard_normal((b, nc, q, h, p)).astype(f)
    dt = np.logaddexp(rng.standard_normal((b, nc, q, h)), 0.0).astype(f)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(f) if a is None \
        else np.full(h, a, f)
    B = (rng.standard_normal((b, nc, q, g, n)) * 0.3).astype(f)
    C = (rng.standard_normal((b, nc, q, g, n)) * 0.3).astype(f)
    return [torch.from_numpy(t).cuda() for t in (x, dt, A, B, C)]


def check_ssd_intra():
    """Phase 3: the SSD kernel against its plain version on the card.
    Tolerance: atol = rtol = KERNEL_TOL at the test shapes (the
    reference's kernel-vs-oracle tolerance); at full width rtol =
    KERNEL_TOL with atol = KERNEL_TOL x max|plain| per output."""
    import numpy as np
    import torch
    from repro_torch.kernels.ssd_scan import ssd_intra, ssd_intra_plain
    rng = np.random.default_rng(SEED)
    cases = [  # (label, shape, A, full width)
        ("test b1", dict(b=1, nc=3, q=16, h=4, p=8, g=4, n=16), None, False),
        ("test b2", dict(b=2, nc=2, q=32, h=8, p=16, g=8, n=32), None, False),
        ("test q64", dict(b=1, nc=1, q=64, h=2, p=64, g=2, n=64), None,
         False),
        ("G<H 2/8", dict(b=2, nc=2, q=32, h=8, p=16, g=2, n=32), None, False),
        ("full width, A=-1", dict(b=4, nc=3, q=256, h=48, p=64, g=1, n=128),
         -1.0, True),
        ("48 heads share C B^T, A=-1", dict(b=2, nc=3, q=256, h=48, p=64,
                                            g=1, n=128), -1.0, True),
        ("G=2 of 8, Q=128", dict(b=2, nc=4, q=128, h=8, p=64, g=2, n=64),
         None, False),
        ("44 heads, a partial head block", dict(b=2, nc=8, q=256, h=44,
                                                p=64, g=1, n=128), -1.0,
         True),
        ("Q=1024, A=-1", dict(b=2, nc=4, q=1024, h=24, p=64, g=1, n=128),
         -1.0, True),
        ("P 20, N 36", dict(b=1, nc=2, q=96, h=6, p=20, g=3, n=36), None,
         False),
        ("P 6, N 10 (4-byte copies)", dict(b=1, nc=2, q=70, h=4, p=6, g=2,
                                           n=10), None, False),
        # head dims past the kernel's 64-column blocks
        ("P 128, A=-1", dict(b=2, nc=2, q=256, h=8, p=128, g=1, n=128),
         -1.0, True),
        ("P 96, G=2 of 6", dict(b=1, nc=3, q=160, h=6, p=96, g=2, n=64),
         None, False),
        ("P 130 (4-byte copies)", dict(b=1, nc=2, q=70, h=2, p=130, g=1,
                                       n=10), None, False),
    ]
    worst = 0.0
    for label, shape, a, full in cases:
        case = _ssd_case(rng, **shape, a=a)
        out = ssd_intra(*case)
        torch.cuda.synchronize()
        ref = ssd_intra_plain(*case)
        errs = []
        for name, got, want in zip(("y", "states", "decay"), out, ref):
            atol = KERNEL_TOL * (want.abs().max().item() if full else 1.0)
            err = (got - want).abs()
            errs.append(err.max().item())
            if not (torch.isfinite(got).all() and torch.all(
                    err <= atol + KERNEL_TOL * want.abs())):
                raise AssertionError(
                    f"ssd_intra {label} {name}: max abs err {errs[-1]} "
                    f"over atol {atol} + rtol {KERNEL_TOL}, or not finite")
        print(f"  ssd_intra {label}: x {tuple(case[0].shape)} b/c "
              f"{tuple(case[3].shape)} max abs err y/states/decay "
              + "/".join(f"{e:.3e}" for e in errs)
              + f" (rtol {KERNEL_TOL}, atol {KERNEL_TOL}"
              + (" x max|plain|)" if full else ")"))
        worst = max(worst, *errs)
        if label == "full width, A=-1":
            control = case, out[1]
    # broken control: the plain version with the last row of each chunk's
    # x zeroed must miss the kernel's states by more than the limit
    case, kstates = control
    x = case[0].clone()
    x[:, :, -1] = 0
    states = ssd_intra_plain(x, *case[1:])[1]
    miss = (kstates - states).abs()
    limit = KERNEL_TOL * (states.abs().max() + states.abs())
    over = bool(torch.any(miss > limit))
    print(f"  control, plain with each chunk's last row of x zeroed (full "
          f"width): states max abs diff {miss.max().item():.3e} from the "
          f"kernel ({'over' if over else 'within'} the limit)")
    if not over:
        raise AssertionError("ssd_intra: the check cannot see a missing row")
    return worst


def time_ssd_intra(case, flush):
    """Kernel, plain version, bound and a yardstick of library calls at
    one input set (x (B,NC,Q,H,P), dt, a, b/c (B,NC,Q,G,N)). No single
    PyTorch call computes ssd_intra, so ``library_ms`` is None."""
    import torch
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.ssd_scan import (_block_plan, ssd_intra,
                                              ssd_intra_plain)
    x, dt, a, b, c = case
    bsz, nc, q, h, p = x.shape
    g, n = b.shape[3], b.shape[4]
    # the kernel's blocks (from shapes): y-blocks of hb heads a 64-row query
    # tile, and one state block a head
    hb, _ = _block_plan(bsz * nc, q, h, g, p, n, cuda_lib.n_sm(x.device))
    n_y = -(-q // 64) * -(-(h // g) // hb) * g * bsz * nc
    blocks = (f"{n_y} y-blocks of {hb} heads and {h * bsz * nc} state "
              f"blocks")
    ms = _time_ms(lambda: ssd_intra(*case), flush)
    plain_ms = _time_ms(lambda: ssd_intra_plain(*case), flush)
    # the least work, 2 FLOPs per MAC: per (row, chunk) the lower triangle
    # (u <= t) of C B^T once per group (all the group's heads share it),
    # and per head the lower triangle of W x and the state product.
    # Bytes: every input read once (B/C once per group), every output
    # written once.
    tri_n = q * (q + 1) // 2
    n_ops = 2 * bsz * nc * (g * tri_n * n + h * (tri_n * p + q * p * n))
    n_bytes = 4 * (2 * x.numel() + dt.numel() + a.numel() + b.numel()
                   + c.numel() + bsz * nc * h * p * n + bsz * nc * h)
    bytes_ms = n_bytes / HBM_BW * 1e3
    ops_ms = n_ops / PEAK_FLOPS * 1e3
    # yardstick only (no single library call computes ssd_intra): the two
    # batched matmuls of the intra-chunk products with the mask, dt and
    # decay applied between them, on inputs laid out beforehand
    rep = h // g
    xt = x.permute(0, 1, 3, 2, 4).contiguous()             # (B,NC,H,Q,P)
    bt = b.permute(0, 1, 3, 4, 2).contiguous()             # (B,NC,G,N,Q)
    ct = c.permute(0, 1, 3, 2, 4).contiguous()             # (B,NC,G,Q,N)
    cs = torch.cumsum(dt * a, dim=2).permute(0, 1, 3, 2)   # (B,NC,H,Q)
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    mask = torch.where(tri, torch.exp(cs[..., :, None] - cs[..., None, :]),
                       0.0) * dt.permute(0, 1, 3, 2)[..., None, :]
    mask = mask.reshape(bsz, nc, g, rep, q, q).contiguous()
    xt = xt.reshape(bsz, nc, g, rep, q, p)

    def yardstick():
        cb = torch.matmul(ct, bt)                          # (B,NC,G,Q,Q)
        return torch.matmul(cb[:, :, :, None] * mask, xt)
    yardstick_ms = _time_ms(yardstick, flush)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=None, yardstick_ms=yardstick_ms, flop=n_ops,
                bytes=n_bytes, blocks=blocks)


def _wrappers():
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from repro_torch.kernels.flash_attention import flash_mha
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ssd_scan import ssd_intra
    return {"paged_attention": paged_attention, "ssd_intra": ssd_intra,
            "flash_attention": flash_mha}


def serve_static(cfg, params, requests, use_kernel: bool, policy=None,
                 new_tokens: int = STATIC_NEW_TOKENS):
    """Phases 5, 6 and 8: one governed run of the static serving agent on
    the card, a RuleVoter on STANDARD_RULES, ``policy`` on its scope.
    Every kernel's count is zeroed just before the run and read just
    after."""
    import torch
    from repro_torch.core.acl import BusClient
    from repro_torch.core.entries import PayloadType
    from repro_torch.core.voter import STANDARD_RULES, RuleVoter
    from repro_torch.serving.server import build_serving_agent
    agent = build_serving_agent(cfg, max_batch=STATIC_MAX_BATCH,
                                use_kernel=use_kernel, device="cuda")
    agent.executor.env.params = params
    agent.executor.env.max_new_tokens = new_tokens
    agent.add_voter(RuleVoter(BusClient(agent.bus, "v-rule", "voter"),
                              rules=STANDARD_RULES), from_tail=False)
    agent.set_policy("decider", {"mode": "first_voter"})
    if policy:
        agent.set_policy("voter:rule", policy)
    for r in requests:
        agent.send_mail(f"request {r['req_id']}", **r)
    torch.cuda.synchronize()
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    agent.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    log = agent.external_client("smoke", "admin").read(0)
    by = {t: [e.body for e in log if e.type == t] for t in PayloadType}
    intents = [b for b in by[PayloadType.INTENT]
               if b["kind"] == "serve_batch"]
    results = {b["intent_id"]: b for b in by[PayloadType.RESULT]}
    tokens, batches = {}, []
    for b in intents:  # the executed batches, in the planner's order
        r = results.get(b["intent_id"])
        if r and r["ok"]:
            tokens.update(zip(r["value"]["req_ids"],
                              r["value"]["generated"]))
            batches.append((r["value"]["req_ids"],
                            r["value"]["prefill_len"]))
    return dict(wall=wall, launches=launches,
                intents=intents, results=results, tokens=tokens,
                batches=batches,
                commits={b["intent_id"] for b in by[PayloadType.COMMIT]},
                aborts={b["intent_id"] for b in by[PayloadType.ABORT]})


def _batch_tokens(run, requests):
    """The governed run's batches, each as (req_ids, tokens): the req_ids
    and padded length come from the batch's Result, the tokens from the
    serving path's own padding."""
    from repro_torch.serving.server import pad_prompts
    prompts = {r["req_id"]: r["prompt_tokens"] for r in requests}
    out = []
    for rids, plen in run["batches"]:
        toks = pad_prompts([prompts[r] for r in rids])
        if toks.shape[1] != plen:
            raise AssertionError(f"batch {rids}: padded to {toks.shape[1]}"
                                 f", the Result says {plen}")
        out.append((rids, toks))
    return out


def _top2_margin(model, params, toks, row, pos, tokens_so_far):
    """Top-1 minus top-2 logit of ``row`` at decoded position ``pos`` on
    the plain path, feeding the plain path's own tokens."""
    import torch
    from repro_torch.serving.server import stub_batch
    batch, pos0 = stub_batch(model.cfg, torch.from_numpy(toks).cuda())
    logits, cache = model.prefill(params, batch,
                                  extra_cache=len(tokens_so_far[0]))
    for t in range(pos):
        tok = torch.tensor([[r[t]] for r in tokens_so_far], device="cuda")
        logits, cache = model.decode_step(params, cache, tok, pos0 + t)
    top = torch.topk(logits[row, -1], 2).values
    return (top[0] - top[1]).item()


def static_requests(cfg):
    """The static slices' requests: STATIC_REQUESTS prompts of 64-700
    tokens, from a numpy seed (the lengths come out the same for every
    vocab: 597, 377, 539, 345, 107, 675, 484, 444)."""
    import numpy as np
    rng = np.random.default_rng(SEED + 2)
    return [{"req_id": f"req-{i}",
             "prompt_tokens": rng.integers(
                 0, cfg.vocab, size=int(rng.integers(64, 701))).tolist()}
            for i in range(STATIC_REQUESTS)]


def _no_launches():
    return {name: 0 for name in _wrappers()}


def time_static(model, params, batches, smi):
    """A static slice's readings on the model itself (kernel path), at the
    slice's shapes: each batch's prefill, the decode step at the last
    batch's rows, peak memory, and profiles of one prefill and of three
    decode steps."""
    import torch
    from repro_torch.serving.server import stub_batch
    prefill_ms = []
    for _, bt in batches:
        batch, plen = stub_batch(model.cfg, torch.from_numpy(bt).cuda())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch,
                                      extra_cache=STATIC_NEW_TOKENS)
        torch.cuda.synchronize()
        prefill_ms.append((bt.shape, (time.perf_counter() - t0) * 1e3))
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    logits, cache = model.decode_step(params, cache, tok, plen)  # warm
    n_steps = 8
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_steps):
        logits, cache = model.decode_step(params, cache, tok, plen + 1 + i)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    rows = bt.shape[0]
    print(f"  prefill ms per batch ((rows, padded len), ms): "
          + ", ".join(f"({tuple(sh)}, {ms:.2f})" for sh, ms in prefill_ms)
          + f" | decode step {step_ms:.2f} ms for {rows} rows = "
          f"{rows * 1e3 / step_ms:.2f} tokens/s | peak memory "
          f"{torch.cuda.max_memory_allocated()} B | on {smi}")

    holder = {"cache": cache}

    def one_prefill():
        holder["cache"] = model.prefill(
            params, batch, extra_cache=STATIC_NEW_TOKENS)[1]

    def one_decode():
        holder["cache"] = model.decode_step(params, holder["cache"], tok,
                                            plen)[1]
    _profile(f"one prefill {tuple(bt.shape)}", [one_prefill], 1)
    _profile(f"three decode steps at {rows} rows", [one_decode] * 3, 3)
    del holder, cache


def governed_static(cfg, params, kernel: str, smi):
    """The governed static runs of a slice on the card: the kernel run (two
    committed ``serve_batch`` intents, every request served, ``kernel``
    launched once a layer in each prefill and no other kernel), a run
    whose policy denylists ``serve_batch`` (every intent aborted, no
    launch) and a plain run (no launch) whose tokens must equal the kernel
    run's. Returns the kernel run and its batches."""
    requests = static_requests(cfg)
    print(f"  requests (prompt len): " + ", ".join(
        f"{r['req_id']}({len(r['prompt_tokens'])})" for r in requests)
        + f"; {STATIC_NEW_TOKENS} new tokens each")
    run = serve_static(cfg, params, requests, use_kernel=True)
    batches = _batch_tokens(run, requests)
    print("  batches (req_ids, padded len): " + "; ".join(
        f"{','.join(rids)} ({t.shape[1]})" for rids, t in batches))
    ids = [b["intent_id"] for b in run["intents"]]
    want_launches = len(run["results"]) * cfg.n_layers
    print(f"  kernel run: serve_batch intents {len(ids)}, committed "
          f"{len(run['commits'] & set(ids))}, ok results "
          f"{sum(b['ok'] for b in run['results'].values())}, served "
          f"{len(run['tokens'])}; {kernel} launches "
          f"{run['launches'][kernel]} (want {len(run['results'])} "
          f"executed x {cfg.n_layers} = {want_launches}); all launches "
          f"{run['launches']}; wall {run['wall']:.3f} s")
    if len(ids) != 2 or not set(ids) <= run["commits"] or run["aborts"] \
            or set(run["results"]) != set(ids) \
            or not all(b["ok"] for b in run["results"].values()):
        raise AssertionError("want two serve_batch intents, both committed "
                             "with an ok Result")
    if sorted(run["tokens"]) != sorted(r["req_id"] for r in requests):
        raise AssertionError("not every request was served")
    if run["launches"] != dict(_no_launches(), **{kernel: want_launches}):
        raise AssertionError(f"the prefills did not each launch {kernel} "
                             f"once a layer, and no other kernel")
    for rid, toks in run["tokens"].items():
        if len(toks) != STATIC_NEW_TOKENS or not all(
                0 <= t < cfg.vocab for t in toks):
            raise AssertionError(f"{rid}: bad tokens {toks}")
    n_tokens = len(requests) * STATIC_NEW_TOKENS
    print(f"  governed kernel run: {n_tokens} tokens in {run['wall']:.3f} s "
          f"= {n_tokens / run['wall']:.2f} tokens/s end to end "
          f"(prefill + decode + governance) on {smi}")

    deny = serve_static(cfg, params, requests, use_kernel=True,
                        policy={"kind_denylist": ["serve_batch"]})
    dids = {b["intent_id"] for b in deny["intents"]}
    print(f"  denylisted run: serve_batch intents {len(dids)}, aborted "
          f"{len(deny['aborts'] & dids)}, committed "
          f"{len(deny['commits'] & dids)}, results {len(deny['results'])}, "
          f"launches {deny['launches']}")
    if not dids or deny["aborts"] != dids or deny["commits"] \
            or deny["results"] or deny["launches"] != _no_launches():
        raise AssertionError("the denylisted intents were not all stopped "
                             "before execution")

    ref = serve_static(cfg, params, requests, use_kernel=False)
    if ref["launches"] != _no_launches():
        raise AssertionError("the plain run launched a kernel")
    _same_tokens(cfg, params, run, ref, batches)
    print(f"  plain run on the card: identical tokens for all "
          f"{len(ref['tokens'])} requests; wall {ref['wall']:.3f} s; e.g. "
          + "; ".join(f"{r['req_id']} (last prompt token "
                      f"{r['prompt_tokens'][-1]}): {run['tokens'][r['req_id']]}"
                      for r in requests[:2]))
    return run, batches


def _same_tokens(cfg, params, run, ref, batches):
    """Raises if the kernel run's tokens are not the plain run's, with the
    plain path's top-2 logit margin where they first differ."""
    from repro_torch.models.model import Model
    for rids, toks in batches:
        for row, rid in enumerate(rids):
            got, want = run["tokens"][rid], ref["tokens"][rid]
            if got != want:
                pos = next(i for i, (u, v) in enumerate(zip(got, want))
                           if u != v)
                margin = _top2_margin(
                    Model(cfg, use_kernel=False), params, toks, row, pos,
                    [ref["tokens"][r] for r in rids])
                raise AssertionError(
                    f"kernel vs plain tokens differ: {rid} first at decoded "
                    f"position {pos} ({got[pos]} vs {want[pos]}); the plain "
                    f"path's top-2 logit margin there is {margin}")


def slice_mamba2(smi):
    """Phase 6: governed static serving of full-width mamba2_780m.
    Returns the SSD kernel's launch count of the governed kernel run and
    its timing at the slice's own inputs."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.ssd_scan import ssd_intra_plain
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.models.model import Model

    cfg = get_config("mamba2_780m")
    torch.cuda.reset_peak_memory_stats()
    params, n_params, secs = _fresh_params(cfg)
    s = cfg.ssm
    print(f"[slice 2] {cfg.arch_id}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, inner {s.expand * cfg.d_model}, "
          f"{s.expand * cfg.d_model // s.head_dim} heads x {s.head_dim}, "
          f"d_state {s.d_state}, groups {s.n_groups}, chunk {s.chunk}, "
          f"vocab {cfg.vocab}; {n_params} fp32 params ({cfg.n_params()} "
          f"by the config's count) from torch.Generator seed {SEED} in "
          f"{secs:.2f} s")
    run, batches = governed_static(cfg, params, "ssd_intra", smi)
    launches = run["launches"]["ssd_intra"]

    # the full-width prefill, kernel vs plain: the logits and every
    # layer's final SSM state. Two broken controls on the plain path (the
    # intra-chunk y zeroed; the chunk states zeroed) show that the limits
    # catch a wrong SSD path.
    kmodel, pmodel = Model(cfg), Model(cfg, use_kernel=False)
    rids, toks = max(batches, key=lambda bt: bt[1].shape[1])
    batch = {"tokens": torch.from_numpy(toks).cuda()}
    kernel = _prefill_outs(kmodel, params, batch)
    plain = _prefill_outs(pmodel, params, batch)

    def broken(out):
        def intra(*args):
            y, states, decay = ssd_intra_plain(*args)
            return ((torch.zeros_like(y), states, decay) if out == "y"
                    else (y, torch.zeros_like(states), decay))
        return intra
    kgap = _gaps(kernel, plain)
    controls = {}
    for out in ("y", "states"):
        ssm_lib.ssd_intra_plain = broken(out)
        try:
            controls[out] = _gaps(_prefill_outs(pmodel, params, batch),
                                  plain)
        finally:
            ssm_lib.ssd_intra_plain = ssd_intra_plain
    print(f"  prefill {tuple(toks.shape)}, max|logit| "
          f"{plain['logits'].abs().max().item():.4e}, max|state| "
          f"{plain['SSM states'].abs().max().item():.4e}; limits: logits "
          f"{LOGIT_RTOL} x max|logit|, states {CACHE_TOL} x max|state| + "
          f"rtol {CACHE_TOL}")
    _print_gaps("kernel", kgap)
    for o, g in controls.items():
        _print_gaps(f"control, plain with {o} zeroed", g)
    if not (torch.isfinite(kernel["logits"]).all()
            and torch.isfinite(kernel["SSM states"]).all()
            and all(ok for _, _, ok in kgap.values())):
        raise AssertionError("full-width prefill: kernel vs plain logits or "
                             "final states over the limit, or not finite")
    if any(g["SSM states"][2] for g in controls.values()):
        raise AssertionError("a broken SSD path passed the final states' "
                             "limit: the check has no power")
    del kernel, plain, run

    time_static(kmodel, params, batches, smi)

    # the kernel at the slice's own inputs: layer 0's SSD in the prefill
    # of the longest batch (captured from the path, launched outside the
    # counted run)
    case, _ = _capture(kmodel, params, batch, "ssd_intra",
                       lambda a, kw: True)
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    t = time_ssd_intra(case, flush)
    print(f"  ssd_intra at the slice's shape x {tuple(case[0].shape)} b/c "
          f"{tuple(case[3].shape)} (layer 0 of the {tuple(toks.shape)} "
          f"prefill): kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms,"
          f" bound {t['bound_ms']:.4f} ms ({t['bound_by']}: {t['flop']} "
          f"FLOP, {t['bytes']} B), yardstick (two batched matmuls with the "
          f"mask between) {t['yardstick_ms']:.4f} ms | kernel at "
          f"{t['flop'] / t['ms'] / 1e9:.2f} TFLOP/s | {t['blocks']} | on "
          f"{smi}")
    for k in ("flop", "bytes", "yardstick_ms", "blocks"):
        t.pop(k)
    return {"launches": launches, "timing": t}


def _mha_case(rng, b, sq, sk, h, kv, dh):
    """Unit-normal q (b,sq,h,dh), k/v (b,sk,kv,dh) on the card."""
    import numpy as np
    import torch
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                             ).cuda()
            for shape in ((b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh))]


def check_flash_attention():
    """Phase 3: the flash kernel against its plain version on the card, at
    the reference's test shapes and variants, the non-causal unaligned
    case (where the Pallas kernel lets pad keys in), Sq > Sk without and
    with a window (rows that see no key give 0 in both), the full
    qwen3_4b prefill's shape, head dim 256 (gemma2_9b's) with a window and
    softcap and at gemma2's heads, one query head a kv head, a head dim
    that is not a multiple of 4, and slice 5's windowed prefill layers of
    gemma2_9b and mixtral_8x7b (S = 4500 past the 4096 window). Tolerance
    atol = rtol = FLASH_TOL."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    cases = [  # (label, (B, Sq, Sk, H, Kv, Dh), options)
        ("test mha", (1, 128, 128, 2, 2, 64), {}),
        ("test gqa", (2, 256, 256, 4, 2, 128), {}),
        ("test mqa Sk>Sq", (1, 128, 384, 4, 1, 128), {}),
        ("test unaligned", (1, 200, 200, 2, 2, 80), {}),
        ("test non-causal", (2, 256, 256, 4, 2, 128), dict(causal=False)),
        ("test window", (2, 256, 256, 4, 2, 128), dict(window=64)),
        ("test softcap", (2, 256, 256, 4, 2, 128), dict(softcap=50.0)),
        ("test window+softcap", (2, 256, 256, 4, 2, 128),
         dict(window=128, softcap=30.0)),
        ("non-causal unaligned (Pallas pad keys)", (1, 200, 200, 2, 2, 64),
         dict(causal=False)),
        ("Sq>Sk non-causal", (1, 300, 130, 4, 2, 64), dict(causal=False)),
        ("Sq>Sk non-causal window (rows 179.. see no key: 0)",
         (1, 300, 130, 4, 2, 64), dict(causal=False, window=50)),
        ("full width", (4, 675, 675, 32, 8, 128), {}),
        ("head dim 256, window+softcap", (1, 300, 300, 4, 2, 256),
         dict(window=100, softcap=50.0)),
        ("gemma2_9b heads, head dim 256", (2, 256, 256, 16, 8, 256), {}),
        ("rep 1", (2, 200, 200, 4, 4, 128), {}),
        ("head dim 50 (4-byte copies), rep 3", (1, 150, 150, 6, 2, 50),
         dict(window=40)),
        ("gemma2_9b windowed layer, S past the window",
         (2, 4500, 4500, 16, 8, 256), dict(window=4096, softcap=50.0)),
        ("mixtral_8x7b layer, S past the window",
         (2, 4500, 4500, 32, 8, 128), dict(window=4096)),
    ]
    worst = 0.0
    for label, shape, kw in cases:
        err = _flash_err(label, _mha_case(rng, *shape), kw)
        print(f"  flash_mha {label}: (B,Sq,Sk,H,Kv,Dh) {shape} {kw or ''}"
              f" max abs err {err:.3e} (atol = rtol {FLASH_TOL})")
        worst = max(worst, err)
    return worst


def _flash_err(label, case, kw):
    """Max abs err of the flash kernel against its plain version on one
    input set; raises if over atol = rtol = FLASH_TOL or not finite."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_mha,
                                                     flash_mha_plain)
    q, k, v = case
    out = flash_mha(q, k, v, **kw)
    torch.cuda.synchronize()
    ref = flash_mha_plain(q, k, v, **kw)
    err = (out - ref).abs()
    if not (torch.isfinite(out).all()
            and torch.all(err <= FLASH_TOL + FLASH_TOL * ref.abs())):
        raise AssertionError(f"flash_mha {label}: max abs err "
                             f"{err.max().item()} over atol = rtol = "
                             f"{FLASH_TOL}, or not finite")
    return err.max().item()


def time_flash_attention(case, flush, softcap=None, window=None,
                         causal=True):
    """Kernel, plain version, bound and library call at one input set (q
    (B,Sq,H,Dh), k/v (B,Sk,Kv,Dh)), as a prefill calls it: causal with a
    window or without, or not causal without one (an encoder, a
    cross-attention). The library call has no softcap: with one, it is a
    yardstick of the same shapes only."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_mha,
                                                     flash_mha_plain)
    q, k, v = case
    bsz, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    kw = dict(softcap=softcap, window=window, causal=causal)
    ms = _time_ms(lambda: flash_mha(q, k, v, **kw), flush)
    plain_ms = _time_ms(lambda: flash_mha_plain(q, k, v, **kw), flush)
    # the least work: 2 FLOPs per MAC of q.k and of p.v over the visible
    # (q, k) pairs (k <= q, and k > q - window; every pair when not
    # causal) of every query head; q and K/V (once per kv head) read once,
    # the output written once
    visible = (sum(min(sk, i + 1, window or sk) for i in range(sq))
               if causal else sq * sk)
    n_ops = 4 * dh * visible * bsz * h
    n_bytes = 4 * (2 * q.numel() + k.numel() + v.numel())
    bytes_ms = n_bytes / HBM_BW * 1e3
    ops_ms = n_ops / PEAK_FLOPS * 1e3
    # yardstick only: one library call, on K/V repeated to H heads and all
    # three laid out (B, heads, S, Dh) beforehand
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(h // kv, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(h // kv, dim=2).transpose(1, 2).contiguous()
    if window is None:
        library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), flush)
    else:
        qi = torch.arange(sq, device=q.device)[:, None]
        ki = torch.arange(sk, device=q.device)[None]
        mask = (ki <= qi) & (ki > qi - window)
        library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask), flush)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=library_ms, flop=n_ops, bytes=n_bytes)


def _prefill_outs(model, params, batch):
    """Logits (real vocab) and what one prefill leaves in the cache, by
    name: every layer's (or shared-block application's) K and V, every
    layer's final SSM state, every decoder layer's encoder K and V."""
    logits, cache = model.prefill(params, batch)
    out = {"logits": logits[..., :model.cfg.vocab]}
    kv = cache.get("attn", cache.get("shared_attn"))
    if kv is not None:
        out["K"], out["V"] = kv["k"], kv["v"]
    if "ssm" in cache:
        out["SSM states"] = cache["ssm"]["state"]
    if "cross_k" in cache:
        out["cross K"], out["cross V"] = cache["cross_k"], cache["cross_v"]
    return out


def _prefill_with(model, params, batch, flash=None, ssd=None,
                  attention=None, routing=None):
    """``_prefill_outs`` with the model's ``flash_mha``, the SSD layer's
    ``ssd_intra`` or the model's plain ``attention`` replaced by the given
    stand-ins; with a list ``routing``, each moe layer's (top_e, keep)
    appended to it."""
    from repro_torch.models import model as model_lib
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import ssm as ssm_lib
    saved = (model_lib.flash_mha, ssm_lib.ssd_intra, model_lib.attention,
             moe_lib.dispatch_plan)

    def recording(top_e, n_experts, cap):
        out = saved[3](top_e, n_experts, cap)
        routing.append((top_e.clone(), out[3].clone()))
        return out
    model_lib.flash_mha = flash or saved[0]
    ssm_lib.ssd_intra = ssd or saved[1]
    model_lib.attention = attention or saved[2]
    if routing is not None:
        moe_lib.dispatch_plan = recording
    try:
        return _prefill_outs(model, params, batch)
    finally:
        (model_lib.flash_mha, ssm_lib.ssd_intra, model_lib.attention,
         moe_lib.dispatch_plan) = saved


def _gaps(got, want, layers=slice(None)):
    """Per output of ``_prefill_outs``: the max abs diff from the plain
    path's ``want``, the largest ratio of an element's diff to its limit
    (the logits LOGIT_RTOL x max|logit|; the cache outputs slice 3's rule,
    CACHE_TOL x (max + |plain|), the max over every layer, held over
    ``layers``) and whether that ratio is at most 1. A NaN fails."""
    out = {}
    for name, w in want.items():
        if name == "logits":
            err = (got[name] - w).abs()
            ratio = (err.max() / (LOGIT_RTOL * w.abs().max())).item()
        else:
            wl = w[layers]
            err = (got[name][layers] - wl).abs()
            ratio = (err / (CACHE_TOL * (w.abs().max() + wl.abs()))).max(
            ).item()
        out[name] = (err.max().item(), ratio, ratio <= 1.0)
    return out


def _print_gaps(label, gaps):
    print(f"    {label} vs plain: " + ", ".join(
        f"{n} {e:.4e} ({r:.3g} of the limit: "
        f"{'within' if ok else 'over'})"
        for n, (e, r, ok) in gaps.items()))


def _capture(model, params, batch, which, pick):
    """The inputs of the first call to ``which`` (``flash_mha`` or
    ``ssd_intra``) in one prefill of ``model`` for which ``pick(args,
    kw)`` holds, cloned, with its keyword arguments."""
    from repro_torch.kernels.flash_attention import flash_mha
    from repro_torch.kernels.ssd_scan import ssd_intra
    captured = []
    fn = flash_mha if which == "flash_mha" else ssd_intra

    def capture(*args, **kw):
        if not captured and pick(args, kw):
            captured.append(([t.clone() for t in args], kw))
        return fn(*args, **kw)
    _prefill_with(model, params, batch,
                  **{"flash" if which == "flash_mha" else "ssd": capture})
    return captured[0]


def slice_qwen3_static(smi, cfg, params):
    """Phase 5: governed static serving of full-width qwen3_4b, on slice
    1's parameters. Returns the flash kernel's launch count of the
    governed kernel run and its timing at the slice's own inputs."""
    import torch
    from repro_torch.kernels.flash_attention import flash_mha
    from repro_torch.models import model as model_lib
    from repro_torch.models.model import INF_WINDOW, Model

    torch.cuda.reset_peak_memory_stats()
    print(f"[slice 3] {cfg.arch_id} static: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} x "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; slice 1's "
          f"fp32 params (torch.Generator seed {SEED}); max_batch "
          f"{STATIC_MAX_BATCH}")
    run, batches = governed_static(cfg, params, "flash_attention", smi)
    launches = run["launches"]["flash_attention"]

    # the (4, 675) prefill, kernel vs plain: the last position's logits
    # and every layer's K and V. Layer i's attention reaches the K/V of
    # layers i+1.., the last layer's only the logits, so the two checks
    # together cover every launch. Two broken controls on the plain path
    # (attention not causal; the last layer's attention output zeroed)
    # show that the limits catch a wrong attention path.
    kmodel, pmodel = Model(cfg), Model(cfg, use_kernel=False)
    _, toks = max(batches, key=lambda bt: bt[1].shape[1])
    tok_t = torch.from_numpy(toks).cuda()
    batch = {"tokens": tok_t}
    kernel = _prefill_outs(kmodel, params, batch)
    plain = _prefill_outs(pmodel, params, batch)
    lmax, kmax, vmax = (t.abs().max().item() for t in plain.values())
    attention = model_lib.attention

    def not_causal(q, k, v, **kw):
        return attention(q, k, v, **dict(kw, causal=False))

    calls = []

    def last_layer_zeroed(q, k, v, **kw):
        calls.append(1)
        o = attention(q, k, v, **kw)
        return torch.zeros_like(o) if len(calls) == cfg.n_layers else o
    kgap = _gaps(kernel, plain)
    del kernel
    controls = {label: _gaps(_prefill_with(pmodel, params, batch,
                                           attention=fn), plain)
                for label, fn in (("attention not causal", not_causal),
                                  ("the last layer's attention output "
                                   "zeroed", last_layer_zeroed))}
    print(f"  prefill {tuple(toks.shape)}, max|logit| {lmax:.4e}, max|k| "
          f"{kmax:.4e}, max|v| {vmax:.4e}; limits: logits {LOGIT_RTOL} x "
          f"max|logit|, K and V {CACHE_TOL} x max + rtol {CACHE_TOL}")
    for label, g in [("kernel", kgap)] + [
            (f"control, plain with {c}", g) for c, g in controls.items()]:
        _print_gaps(label, g)
    if not (torch.isfinite(plain["logits"]).all()
            and all(ok for _, _, ok in kgap.values())):
        raise AssertionError("full-width prefill: kernel vs plain logits or "
                             "K/V over the limit")
    nc, lz = controls.values()
    if (nc["K"][2] and nc["V"][2]) or lz["logits"][2]:
        raise AssertionError("a broken attention path passed the limits: "
                             "not causal within the K/V limit, or the last "
                             "layer zeroed within the logits limit")
    del plain, run

    time_static(kmodel, params, batches, smi)

    # the kernel at the slice's own inputs: layer 0's q/k/v in the prefill
    # of the longest batch (captured from the path, launched outside the
    # counted run)
    captured = []

    def capture(q, k, v, **kw):
        if not captured:
            captured.append(([t.clone() for t in (q, k, v)], kw,
                             [t.stride(-1) != 1 for t in (q, k, v)]))
        return flash_mha(q, k, v, **kw)
    model_lib.flash_mha = capture
    try:
        kmodel.prefill(params, {"tokens": tok_t})
    finally:
        model_lib.flash_mha = flash_mha
    case, kw, copied = captured[0]
    del captured
    print(f"  the prefill's q/k/v needed a contiguous copy for the kernel "
          f"(head dim not unit-stride): "
          f"{dict(zip('qkv', copied)) if any(copied) else 'none'}")
    if not (kw["causal"] and kw["window"] == INF_WINDOW
            and kw["softcap"] is None and kw["scale"] is None):
        raise AssertionError(f"the prefill called flash_mha with {kw}, "
                             f"not causal without window, softcap or scale")
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    t = time_flash_attention(case, flush)
    print(f"  flash_mha at the slice's shape q {tuple(case[0].shape)} k/v "
          f"{tuple(case[1].shape)} causal (layer 0 of the "
          f"{tuple(toks.shape)} prefill): kernel {t['ms']:.4f} ms, plain "
          f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']}: {t['flop']} FLOP, {t['bytes']} B), sdpa on "
          f"K/V repeated to {cfg.n_heads} heads {t['library_ms']:.4f} ms | "
          f"kernel at {t['flop'] / t['ms'] / 1e9:.2f} TFLOP/s | on {smi}")
    for k in ("flop", "bytes"):
        t.pop(k)
    time_flash_gemma2(smi, flush)
    return {"launches": launches, "timing": t}


def time_flash_gemma2(smi, flush):
    """``flash_mha`` at gemma2_9b's attention shape (head dim 256, 16/8
    heads, softcap 50) at the slice's (4, 675) batch, on unit-normal
    inputs: kernel, plain, bound (visible pairs as above) and sdpa on the
    same shapes without the softcap, which sdpa lacks."""
    import numpy as np
    from repro_torch.kernels.flash_attention import blocks_per_sm
    case = _mha_case(np.random.default_rng(SEED), 4, 675, 675, 16, 8, 256)
    err = _flash_err("at gemma2_9b's shape", case, dict(softcap=50.0))
    t = time_flash_attention(case, flush, softcap=50.0)
    print(f"  flash_mha at gemma2_9b's shape q {tuple(case[0].shape)} k/v "
          f"{tuple(case[1].shape)} causal softcap 50: kernel "
          f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
          f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {t['flop']} FLOP, "
          f"{t['bytes']} B), sdpa (no softcap) on K/V repeated to 16 heads "
          f"{t['library_ms']:.4f} ms | kernel at "
          f"{t['flop'] / t['ms'] / 1e9:.2f} TFLOP/s | max abs err vs "
          f"plain {err:.3e} (atol = rtol {FLASH_TOL}) | on {smi}")
    print("  flash_mha blocks an SM by head dim: " + ", ".join(
        f"{dh}: {blocks_per_sm(dh)}" for dh in (64, 128, 256)))


def build_kernels():
    """Phase 2: one nvcc per source, all started together; then load."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.flash_attention import _kernel_fn as flash_fn
    from repro_torch.kernels.paged_attention import _kernel_fn as paged_fn
    from repro_torch.kernels.ssd_scan import _kernel_fn as ssd_fn
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        logs = dict(zip(KERNELS, pool.map(cuda_lib.build, KERNELS)))
    paged_fn()
    ssd_fn()
    flash_fn()
    print(f"[build] {', '.join(f'{k}.cu' for k in KERNELS)} built in "
          f"parallel and loaded in {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")


def main() -> None:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA card; the port's smoke run needs one")
    from repro_torch.device import resolve_device

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = _smi()
    resolve_device("cuda")  # also turns TF32 off for matmul and cuDNN
    print(f"[device] {name} | nvidia-smi: {smi} | torch {torch.__version__}"
          f" cuda {torch.version.cuda} | tf32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn "
          f"{torch.backends.cudnn.allow_tf32}")

    # 2. build
    build_kernels()

    # 3. each kernel against its plain version
    print("[kernels] paged_attention vs paged_attention_plain on the card")
    paged_err = check_paged_attention()
    print("[kernels] ssd_intra vs ssd_intra_plain on the card")
    ssd_err = check_ssd_intra()
    print("[kernels] flash_mha vs flash_mha_plain on the card")
    flash_err = check_flash_attention()

    # 4. slice 1: governed continuous serving at full qwen3_4b width
    paged = slice_qwen3(smi)

    # 4b. slice 9: the agent kernel's spawns and the supervisor, on slice
    # 1's parameters
    spawned = slice_agent_kernel(smi, paged)

    # 4c. slice 10b: the elastic pool replaces a failing serving worker,
    # on slice 1's parameters (10a runs inside slice 4's crash drill)
    pooled = slice_elastic_pool(smi, paged)

    # 4d. slice 11b and 11c: the log behind a server through a restart and
    # a lost append reply, on slice 1's parameters (11a ran in slice 1)
    netted = slice_netbus(smi, paged)

    # 4e. slice 12: the components as OS processes: slice 1's run with its
    # log on a bus-server process, that process SIGKILLed mid-run, and the
    # process failover drill
    proc = slice_procs(smi, paged)

    # 5. slice 3: governed static serving at full qwen3_4b width, on slice
    # 1's parameters, which are freed after it
    flash = slice_qwen3_static(smi, paged.pop("cfg"), paged.pop("params"))
    torch.cuda.empty_cache()

    # 6. slice 2: governed static serving at full mamba2_780m width
    ssd = slice_mamba2(smi)
    torch.cuda.empty_cache()

    # 7. slice 4: governed training at full qwen3_4b width
    slice_training(smi)
    torch.cuda.empty_cache()

    # 8. slice 5: gemma2_9b, chatglm3_6b and mixtral_8x7b at full width
    new = slice_new_configs(smi)
    torch.cuda.empty_cache()

    # 9. slice 6: zamba2_1p2b, whisper_small and internvl2_26b at full
    # width
    last = slice_last_families(smi)
    torch.cuda.empty_cache()

    # 10. slice 7: the launchers, the examples and the int8 KV cache
    entry = slice_entry_points(smi)
    torch.cuda.empty_cache()

    # 11. slice 8: the dry-run of every cell, and the decode cells that
    # fit half the card built and stepped on it
    slice_dryrun(smi)

    # 12. result lines; each kernel's launches are those of its governed
    # kernel runs on the main paths
    launches = {
        "paged_attention": paged["launches"] + spawned["9a"]
        + spawned["9b"] + pooled + netted + proc + new["paged_attention"],
        "ssd_intra": ssd["launches"] + last["ssd_intra"]
        + entry["ssd_intra"],
        "flash_attention": flash["launches"] + new["flash_attention"]
        + last["flash_attention"] + entry["flash_attention"]}
    print(f"[launches] paged_attention {launches['paged_attention']} = "
          f"{paged['launches']} (slice 1, qwen3_4b continuous) + "
          f"{spawned['9a']} (slice 9a, a kernel-spawned qwen3_4b agent on "
          f"SQLite) + {spawned['9b']} (slice 9b, two kernel-spawned "
          f"qwen3_4b agents) + {pooled} (slice 10b, the elastic pool's "
          f"healthy qwen3_4b worker and the failing one's replacement) + "
          f"{netted} (slice 11, qwen3_4b with its log behind a bus server: "
          f"11a, 11b across a restart, 11c with a lost append reply) + "
          f"{proc} (slice 12, qwen3_4b with its log on a bus-server "
          f"process: 12a, 12b across its SIGKILL) + "
          f"{new['paged_attention']} (slice 5, chatglm3_6b continuous); "
          f"ssd_intra {launches['ssd_intra']} = {ssd['launches']} (slice "
          f"2, mamba2_780m static) + {last['ssd_intra']} (slice 6, "
          f"zamba2_1p2b static) + {entry['ssd_intra']} (slice 7, "
          f"launch.serve mamba2_780m); "
          f"flash_attention {launches['flash_attention']} = "
          f"{flash['launches']} (slice 3, qwen3_4b static) + "
          + " + ".join(f"{n} (slice {sl}, {a} static)"
                       for sl, runs in ((5, new), (6, last))
                       for a, n in runs["flash_by_run"].items())
          + f" + {entry['flash_attention']} (slice 7, launch.serve "
          f"qwen3_4b)")
    kernels = [{"name": "paged_attention", "route": "cuda",
                "source": "src/repro_torch/csrc/paged_attention.cu",
                "replaces": "src/repro/kernels/paged_attention.py:45",
                "launches": launches["paged_attention"],
                "max_abs_err": paged_err, **paged["timing"]},
               {"name": "ssd_intra", "route": "cuda",
                "source": "src/repro_torch/csrc/ssd_scan.cu",
                "replaces": "src/repro/kernels/ssd_scan.py:27",
                "launches": launches["ssd_intra"], "max_abs_err": ssd_err,
                **ssd["timing"]},
               {"name": "flash_attention", "route": "cuda",
                "source": "src/repro_torch/csrc/flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention.py:26",
                "launches": launches["flash_attention"],
                "max_abs_err": flash_err, **flash["timing"]}]
    print(f"[wall] {time.perf_counter() - t_start:.1f} s from the start of "
          f"main to the result lines")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


def slice_qwen3(smi):
    """Phase 4: governed continuous serving of full-width qwen3_4b.
    Returns the paged-attention launch count of the governed kernel run,
    the kernel's timing at the main path's shape, the config and
    parameters (for slices 9 and 3), and for slice 9 the requests, the
    memory run's tokens and each log's wall and governance ms a
    serve_step intent."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import flash_mha
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ssd_scan import ssd_intra

    cfg = get_config("qwen3_4b")
    torch.cuda.reset_peak_memory_stats()
    params, n_params, secs = _fresh_params(cfg)
    print(f"[slice 1] {cfg.arch_id}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}; {n_params} fp32 params from "
          f"torch.Generator seed {SEED} in {secs:.2f} s")
    requests = make_requests(cfg, np.random.default_rng(SEED))
    blocked = [r["req_id"] for r in requests if r["tenant"] == "blocked"]
    served = {r["req_id"]: r for r in requests if r["tenant"] != "blocked"}
    print(f"  requests: " + ", ".join(
        f"{r['req_id']}({len(r['prompt_tokens'])}+{r['max_new_tokens']}"
        f"{', blocked' if r['tenant'] == 'blocked' else ''})"
        for r in requests))

    ssd_intra.launches = flash_mha.launches = 0
    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-bus-") as tmp:
        for backend in SERVE_BUSES:
            runs[backend] = _serve_on_bus(cfg, params, requests, served,
                                          blocked, backend, tmp, smi)
    run = runs["memory"]
    pl = run["planner"]
    for backend, other in runs.items():
        if other["planner"].outputs != pl.outputs \
                or other["launches"] != run["launches"]:
            raise AssertionError(f"the governed run on {backend} differs "
                                 f"from the one on memory in its tokens or "
                                 f"its paged launches")
    if ssd_intra.launches or flash_mha.launches:
        raise AssertionError("the continuous path launched the SSD or the "
                             "flash kernel (its prefill runs the plain "
                             "attention, as the reference's does)")
    print(f"  the governed kernel runs on {', '.join(SERVE_BUSES)}: equal "
          f"tokens for all {len(pl.outputs)} requests and equal paged "
          f"launches ({run['launches']}); the runs on the durable logs "
          f"(engine, agent, read-back) took "
          f"{sum(r['secs'] for b, r in runs.items() if b != 'memory'):.2f} "
          f"s, the one on memory {run['secs']:.2f} s")
    launches = run["launches"]
    gov_ms = {b: 1e3 * (r["wall"] - r["model_s"]) / r["n_intents"]
              for b, r in runs.items()}
    walls = {b: r["wall"] for b, r in runs.items()}
    outputs = dict(pl.outputs)
    net = runs["net"]
    if net["net"]["reconnects"] != 0 or net["net"]["flagged"] != 0:
        raise AssertionError(f"11a: the NetBus reconnected "
                             f"{net['net']['reconnects']} times, or its view "
                             f"held {net['net']['flagged']} _sched flags")
    print(f"[slice 11] 11a: slice 1's governed kernel run with its log "
          f"behind a BusServer (NetBus -> in-process server -> SqliteBus, "
          f"group commit): wall {walls['net']:.3f} s (sqlite "
          f"{walls['sqlite']:.3f} s, memory {walls['memory']:.3f} s); "
          f"governance {gov_ms['net']:.3f} ms a serve_step intent beside "
          f"sqlite's {gov_ms['sqlite']:.3f} ms, kv's {gov_ms['kv']:.3f} ms "
          f"and memory's {gov_ms['memory']:.3f} ms in this call; "
          f"{net['net']['requests']} requests, 0 reconnects; paged "
          f"launches {net['launches']} | on {smi}")
    net = dict(launches=net["launches"], entries=net["net"]["entries"],
               appends=net["calls"]["appends"], n_intents=net["n_intents"])
    del runs, run

    ref = serve(cfg, params, requests, use_kernel=False)
    if ref["launches"] != 0:
        raise AssertionError("the plain run launched the kernel")
    if ref["planner"].outputs != pl.outputs:
        diff = [r for r in pl.outputs
                if pl.outputs[r] != ref["planner"].outputs.get(r)]
        raise AssertionError(f"kernel vs plain tokens differ for {diff}")
    print(f"  plain run on the card: identical tokens for all "
          f"{len(pl.outputs)} requests; wall {ref['wall']:.3f} s")
    del ref

    eng = time_continuous(cfg, params, served, smi)

    # the kernel timed at this decode step's own inputs (layer 0's arena)
    lanes = list(eng.lanes)
    pool = eng.pool
    ctx = (pool.context_lens(lanes) + 1).astype(np.int32)
    q = torch.randn((MAX_BATCH, cfg.n_heads, cfg.head_dim), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    case = [q, pool.k[0], pool.v[0],
            torch.as_tensor(pool.block_table(lanes, eng.max_pages_per_seq),
                            device="cuda"),
            torch.as_tensor(ctx, device="cuda")]
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    t = time_paged_attention(case, flush)
    print(f"  paged_attention at the main path's shape q "
          f"{tuple(q.shape)} pages {tuple(pool.k[0].shape)} table "
          f"{tuple(case[3].shape)} ctx {t['ctx']}: kernel {t['ms']:.4f} ms,"
          f" plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']}), sdpa on pre-gathered K/V "
          f"{t['library_ms']:.4f} ms | {t['blocks']} | on {smi}")
    full = _paged_case(np.random.default_rng(SEED + 1), s_n=8, h=32, kv=8,
                       dh=128, page=16, n_pages_pool=520,
                       ctx_lens=[0, 1, 15, 16, 17, 300, 1000, 2047])
    tf = time_paged_attention(full, flush)
    print(f"  paged_attention at S=8 ctx {tf['ctx']}: kernel "
          f"{tf['ms']:.4f} ms, plain {tf['plain_ms']:.4f} ms, bound "
          f"{tf['bound_ms']:.4f} ms ({tf['bound_by']}), sdpa on "
          f"pre-gathered K/V {tf['library_ms']:.4f} ms | {tf['blocks']} | "
          f"on {smi}")
    t.pop("ctx")
    t.pop("blocks")
    return {"launches": launches, "timing": t, "cfg": cfg, "params": params,
            "requests": requests, "blocked": blocked, "outputs": outputs,
            "gov_ms": gov_ms, "walls": walls, "net": net}


def _row(entry):
    return (entry.position, entry.realtime_ts, entry.type.value, entry.body)


def _unsched(row):
    """``row`` without the ``_sched`` flags that the continuous planner
    sets on the driver's mail dicts after the driver logged them in an
    InfIn context: a bus that serves back the objects it was given (the
    memory bus, the KV store's segment cache) shows them to the agent,
    while the durable copy holds the body as it was appended."""
    if row[2] != "InfIn":
        return row
    body = json.loads(json.dumps(row[3]))
    for m in body["context"]["mail"]:
        m.pop("_sched", None)
    return row[:3] + (body,)


class _NetLog:
    """Slice 11's log behind a server: a ``NetBus`` client of an
    in-process ``BusServer`` (port 0) over a ``SqliteBus`` with group
    commit at ``path``. ``restart`` closes the server and binds a
    successor over the same bus to the same port; ``close`` closes the
    client, the server and the bus, in that order."""

    def __init__(self, path):
        from repro_torch.core import NetBus, SqliteBus
        from repro_torch.launch.bus_server import BusServer
        self._server_cls = BusServer
        self.backing = SqliteBus(path)
        self.server = BusServer(self.backing).start()
        self.epochs = [self.server.epoch]
        self.restarts, self.restart_s = 0, None
        self.restarted_at = self.reconnect_s = None
        host, self.port = self.server.address
        self.bus = NetBus(f"{host}:{self.port}", client_id="chip-smoke")

    def restart(self):
        host, port = self.server.address
        t0 = self.restarted_at = time.perf_counter()
        self.restarts += 1
        self.server.close()
        while True:
            try:
                self.server = self._server_cls(self.backing, host=host,
                                               port=port).start()
                break
            except OSError:
                if time.perf_counter() - t0 > REBIND_DEADLINE_S:
                    raise
                time.sleep(0.05)
        self.restart_s = time.perf_counter() - t0
        self.epochs.append(self.server.epoch)

    def close(self):
        self.bus.close()
        self.server.close()
        self.backing.close()


class _ProcLog:
    """Slice 12's log on a bus-server process: the port's
    ``BusServerProcess("sqlite", path, ...)`` (the server's own
    ``SqliteBus``, group commit on) and a ``NetBus`` client of it.
    ``restart`` SIGKILLs the server (``BusServerProcess.kill``) and starts
    a successor on the same file and port through the port's CLI
    (``_bus_server_cli``); ``close`` closes the client, then kills and
    waits for every server process. ``epochs`` holds the server epoch the
    client first saw."""

    def __init__(self, path):
        from repro_torch.core import NetBus
        from repro_torch.launch.procs import BusServerProcess
        self.path, self.workdir = path, path + ".run"
        os.makedirs(self.workdir)
        self.server = BusServerProcess("sqlite", path, self.workdir)
        self.successor, self.bus = None, None
        self.restarts, self.restart_s = 0, None
        self.restarted_at = self.reconnect_s = None
        try:
            self.port = int(self.server.address.rsplit(":", 1)[1])
            self.bus = NetBus(self.server.address, client_id="chip-smoke")
        except BaseException:
            self.server.kill()
            raise
        self.epochs = [self.bus.server_epoch]

    def restart(self):
        t0 = self.restarted_at = time.perf_counter()
        self.restarts += 1
        self.server.kill()
        self.successor = _bus_server_cli(self.path, self.port, self.workdir)
        self.restart_s = time.perf_counter() - t0

    def close(self):
        try:
            if self.bus is not None:
                self.bus.close()
        finally:
            self.server.kill()
            if self.successor is not None:
                self.successor.kill()
                self.successor.wait(timeout=REBIND_DEADLINE_S)


def _bus_server_cli(path, port, workdir):
    """A bus server over the SQLite file ``path`` on ``port``, started as
    ``python -m repro_torch.launch.bus_server --backend sqlite --path
    <path> --port <port> --port-file ...``, its output in a file in
    ``workdir``. Returns the process once it has published its port;
    raises if it exits first or REBIND_DEADLINE_S passes."""
    from repro_torch.launch.procs import _child_env
    port_file = os.path.join(workdir, f"successor-{port}.port")
    with open(os.path.join(workdir, "successor.log"), "wb") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.bus_server",
             "--backend", "sqlite", "--path", path, "--port", str(port),
             "--port-file", port_file],
            env=_child_env(), stdout=log, stderr=subprocess.STDOUT)
    deadline = time.perf_counter() + REBIND_DEADLINE_S
    while not os.path.exists(port_file):
        if proc.poll() is not None or time.perf_counter() > deadline:
            proc.kill()
            proc.wait(timeout=REBIND_DEADLINE_S)
            raise RuntimeError(f"the successor bus server did not bind port "
                               f"{port} (exit {proc.returncode}; its output "
                               f"in {workdir}/successor.log)")
        time.sleep(0.005)
    return proc


def _restart_mid_run(n_results, label="11b"):
    """11b's and 12b's drill: once the Result of the ``n_results``-th
    serve_step intent has been acknowledged, the server restarts (a
    wrapper on the client's ``append_many``, between two intents); the
    seconds from the restart to the first append acknowledged over a new
    connection go to ``net.reconnect_s``."""
    @contextlib.contextmanager
    def drill(net):
        from repro_torch.core.entries import PayloadType
        append_many, steps, done = net.bus.append_many, set(), []

        def append_then_restart(payloads):
            positions = append_many(payloads)
            if net.restarted_at is not None and net.reconnect_s is None \
                    and net.bus.n_reconnects:
                net.reconnect_s = time.perf_counter() - net.restarted_at
            for p in payloads:
                if p.type == PayloadType.INTENT \
                        and p.body["kind"] == "serve_step":
                    steps.add(p.body["intent_id"])
                elif p.type == PayloadType.RESULT \
                        and p.body["intent_id"] in steps:
                    done.append(p.body["intent_id"])
                    if len(done) == n_results:
                        net.restart()
            return positions
        net.bus.append_many = append_then_restart
        yield
        if net.restarts != 1 or net.reconnect_s is None:
            raise AssertionError(f"{label}: {len(done)} serve_step Results, "
                                 f"the server restarted {net.restarts} "
                                 f"times, want once after Result "
                                 f"{n_results}, and an append acknowledged "
                                 f"over a new connection after it")
    return drill


def _lost_append_reply(at_hit):
    """11c's drill: the port's ``net.server.reply.drop_append`` fires at
    the server's ``at_hit``-th append (the append commits, the reply is
    lost, the client's retry is answered from the dedupe table)."""
    @contextlib.contextmanager
    def drill(net):
        from repro_torch.core import faults
        point = "net.server.reply.drop_append"
        with faults.injected(faults.FaultPlan.single(
                point, "disconnect", at_hit=at_hit)) as inj:
            yield
        if [(a.point, a.at_hit) for a in inj.fired] != [(point, at_hit)]:
            raise AssertionError(f"11c: {point} did not fire at append "
                                 f"{at_hit}: {inj.hits.get(point)} hits")
    return drill


def _serve_on_bus(cfg, params, requests, served, blocked, backend, tmp,
                  smi, name=None, drill=None):
    """Slice 1's governed kernel run with the agent's log on ``backend``
    (``memory``, or ``sqlite`` with group commit, ``kv`` and ``net``, a
    ``_NetLog``, in ``tmp``), under ``drill(net)`` where one is given
    (slice 11b and 11c; ``name`` then labels the run and its file).
    Checks the run as the plan says; a durable log is closed (on net the
    client, the server, the bus behind it) and read back through a fresh
    instance (on net a ``SqliteBus`` on the file), which must give, with
    dense positions, the entries the agent's client read and no
    committed-unexecuted intent. Prints the wall, the time inside the
    engine, the governance time a serve_step intent, the log's entries
    and bytes, and the calls into the log; on net, the client's
    reconnects and the server epochs."""
    import torch
    from repro_torch.core import committed_unexecuted, make_bus
    t0 = time.perf_counter()
    label = name or backend
    # net, proc: SQLite behind the server
    sqlite = backend in ("sqlite", "net", "proc")
    path = None if backend == "memory" else os.path.join(
        tmp, f"serve-{label}" + (".db" if sqlite else ""))
    net = {"net": _NetLog, "proc": _ProcLog}.get(backend)
    net = net(path) if net else None
    bus = net.bus if net else make_bus(backend, path)
    try:
        with drill(net) if drill else contextlib.nullcontext():
            run = serve(cfg, params, requests, use_kernel=True, bus=bus)
    finally:
        if net:
            net.close()
    pl, eng = run["planner"], run["engine"]
    want_launches = eng.n_steps * cfg.n_layers
    print(f"  kernel run on {label}: served {sorted(pl.outputs)} rejected "
          f"{pl.rejected} aborts {run['n_aborts']} admit steps "
          f"{run['admit_steps']} decode steps {eng.n_steps} "
          f"paged_attention launches {run['launches']} (want "
          f"{eng.n_steps} x {cfg.n_layers} = {want_launches}) "
          f"wall {run['wall']:.3f} s")
    if set(pl.outputs) != set(served) or pl.rejected != blocked:
        raise AssertionError("served/rejected sets differ from the plan")
    if run["n_aborts"] == 0:
        raise AssertionError("the veto left no Abort entry on the log")
    if len(set(run["admit_steps"])) < 2:
        raise AssertionError("admissions were not staggered over steps")
    _check_launches(f"the kernel run on {label}", run, cfg)
    for rid, toks in pl.outputs.items():
        if len(toks) != served[rid]["max_new_tokens"] or not all(
                0 <= t < cfg.vocab for t in toks):
            raise AssertionError(f"{rid}: bad tokens {toks}")
    n_tokens = sum(len(t) for t in pl.outputs.values())
    log = run.pop("log")
    on_disk = "in memory"
    if path is not None:
        bus.close()
        files = [path] if sqlite else [
            os.path.join(path, f) for f in os.listdir(path)]
        files += [path + s for s in ("-wal", "-shm")
                  if sqlite and os.path.exists(path + s)]
        on_disk = f"{sum(os.path.getsize(f) for f in files)} B on disk"
        fresh = make_bus("sqlite" if sqlite else backend, path)
        back = [_row(e) for e in fresh.read(0)]
        seen = [_row(e) for e in log]
        flagged = sum(a != b for a, b in zip(back, seen))
        if [r[0] for r in back] != list(range(len(back))):
            raise AssertionError(f"the {label} log's positions read back "
                                 f"from disk are not dense")
        if len(back) != len(seen) or any(
                _unsched(a) != _unsched(b) for a, b in zip(back, seen)):
            raise AssertionError(f"the {label} log read back from disk "
                                 f"differs from what the agent read")
        if committed_unexecuted(fresh):
            raise AssertionError(f"the {label} log holds a committed, "
                                 f"unexecuted intent")
        fresh.close()
    gov_s = run["wall"] - run["model_s"]
    print(f"  governed kernel run on {label}: {n_tokens} tokens in "
          f"{run['wall']:.3f} s = {n_tokens / run['wall']:.2f} tokens/s end "
          f"to end; inside PagedEngine.admit/step {run['model_s']:.3f} s; "
          f"governance {gov_s:.3f} s = {1e3 * gov_s / run['n_intents']:.3f} "
          f"ms a serve_step intent ({run['n_intents']} intents); log "
          f"{len(log)} entries, {on_disk}"
          + ("" if path is None else "; read back from disk by a fresh "
             f"instance: equal entry for entry ({flagged} InfIn entries "
             "of the agent's view hold the planner's later _sched flags, "
             "which the durable copy does not), no committed-unexecuted "
             "intent")
          + f" | on {smi}")
    c = run["calls"]
    print(f"  calls into the {label} log over the run: {c['appends']} "
          f"appends ({c['entries']} entries), {c['reads']} reads, "
          f"{c['tails']} tail probes, {c['waits']} waits; inside the bus "
          f"{c['bus_s']:.3f} s = {100 * c['bus_s'] / gov_s:.1f}% of the "
          f"governance time"
          + ("" if backend != "kv" else f", of which {c['list_s']:.3f} s "
             f"in {c['lists']} _refresh calls (a directory LIST each, with "
             f"the fetch of segments not seen before)")
          + f" | on {smi}")
    if net:
        run["net"] = dict(reconnects=bus.n_reconnects,
                          requests=bus.n_requests, epochs=net.epochs,
                          client_epoch=bus.server_epoch,
                          restart_s=net.restart_s,
                          reconnect_s=net.reconnect_s, entries=len(log),
                          flagged=flagged)
        stop = "SIGKILL" if backend == "proc" else "close"
        print(f"  the {label} client over the run: {bus.n_requests} "
              f"requests, {bus.n_reconnects} reconnects; server epochs "
              f"{[e[:8] for e in net.epochs]}, the client's last "
              f"{bus.server_epoch[:8]}"
              + ("" if net.restart_s is None else
                 f"; the restart ({stop}, successor bound to port "
                 f"{net.port}) took {1e3 * net.restart_s:.3f} ms, and "
                 f"{1e3 * net.reconnect_s:.3f} ms from the {stop} to the "
                 f"first append acknowledged over a new connection")
              + f" | on {smi}")
    del eng, run["engine"]
    torch.cuda.empty_cache()
    run["secs"] = time.perf_counter() - t0
    return run


def time_continuous(cfg, params, served, smi):
    """A continuous slice's readings on the engine itself (kernel path):
    MAX_BATCH requests' prefills, the decode step over all lanes, peak
    memory, and a profile of three decode steps. Returns the engine, its
    lanes still full."""
    import torch
    from repro_torch.serving.engine import PagedEngine
    eng = PagedEngine(cfg, max_batch=MAX_BATCH, num_pages=NUM_PAGES,
                      page_size=PAGE_SIZE,
                      max_pages_per_seq=MAX_PAGES_PER_SEQ, params=params,
                      device="cuda")
    prefill_ms = []
    for r in list(served.values())[:MAX_BATCH]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        assert eng.admit(r["req_id"], r["prompt_tokens"], 64)
        torch.cuda.synchronize()
        prefill_ms.append((len(r["prompt_tokens"]),
                           (time.perf_counter() - t0) * 1e3))
    eng.step()  # warm
    n_steps = 16
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    print(f"  prefill ms per request (prompt len, ms): "
          + ", ".join(f"({n}, {ms:.2f})" for n, ms in prefill_ms)
          + f" | decode step {step_ms:.2f} ms for {MAX_BATCH} lanes = "
          f"{MAX_BATCH * 1e3 / step_ms:.2f} tokens/s | peak memory "
          f"{torch.cuda.max_memory_allocated()} B | on {smi}")

    # where a decode step's device time goes (torch.profiler, CUPTI)
    _profile("decode steps", [eng.step] * 3, 3)
    return eng


def _profile(label, calls, n_rep):
    """torch.profiler (CUPTI) over ``calls``: wall time, device busy time
    and the top kernels by device time per repetition."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for call in calls:
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side kernel events only: an aten op's device time repeats
    # the time of the kernels it launched
    rows = [(e.self_device_time_total, e.key, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy_ms = sum(r[0] for r in rows) / 1e3
    print(f"  profile of {label}: wall {wall_ms:.2f} ms (profiler on), "
          f"device busy {busy_ms:.2f} ms = {100 * busy_ms / wall_ms:.1f}% | "
          f"top kernels per {'repetition' if n_rep > 1 else 'run'}:")
    for dev_us, key, count in sorted(rows, reverse=True)[:10]:
        print(f"    {dev_us / 1e3 / n_rep:9.3f} ms  "
              f"x{max(count // n_rep, 1):<5d} {key[:90]}")


# ---------------------------------------------------------------------------
# slice 4: training
# ---------------------------------------------------------------------------

def _train_batches(data_kw, cursors, device):
    import torch
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    pipe = TokenPipeline(DataConfig(**data_kw))
    return [{k: torch.from_numpy(pipe.batch_at(c)[k]).to(device,
                                                         torch.int64)
             for k in ("tokens", "labels")} for c in cursors]


def _train_steps(cfg, opt_cfg, params, device, batches):
    """One step a batch through ``make_train_step`` (remat full) from a
    copy of ``params`` on ``device``. Returns (losses, grad norms, the
    final parameters)."""
    from repro_torch.models.model import Model
    from repro_torch.models.params import tree_map
    from repro_torch.train.train_step import StepConfig, make_train_step
    init_state, step = make_train_step(Model(cfg), opt_cfg,
                                       StepConfig(remat="full"))
    state = init_state(tree_map(lambda p: p.to(device, copy=True), params))
    losses, gns = [], []
    for b in batches:
        state, m = step(state, {k: v.to(device) for k, v in b.items()})
        losses.append(float(m["loss"]))
        gns.append(float(m["grad_norm"]))
    return losses, gns, state["params"]


def _train_errs(got, want, params0):
    """Card run against CPU run: the largest relative difference of the
    losses and of the grad norms, and of the leaves' updates
    (|p_card - p_cpu| / |p_cpu - p0|, the largest over the leaves)."""
    import torch
    from repro_torch.models.params import tree_leaves
    rel = lambda a, b: max(abs(x - y) / abs(y) for x, y in zip(a, b))
    upd = max(float(torch.linalg.vector_norm(g.cpu() - w)
                    / torch.linalg.vector_norm(w - p0))
              for g, w, p0 in zip(tree_leaves(got[2]), tree_leaves(want[2]),
                                  tree_leaves(params0)))
    return {"loss": rel(got[0], want[0]), "grad_norm": rel(got[1], want[1]),
            "update": upd}


def train_card_vs_cpu(smi):
    """qwen3_4b at full widths with 2 layers: two steps on the card and on
    the CPU from the same seeded weights and batches, with AdamW and with
    Adafactor, beside a broken control (the card's lr 1.5x)."""
    import dataclasses
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models.params import init_params
    from repro_torch.optim.optimizer import OptimizerConfig
    cfg = dataclasses.replace(get_config("qwen3_4b"), n_layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    data = dict(TRAIN_DATA, global_batch=2)
    batches = _train_batches(data, (0, 1), "cpu")
    print(f"  card vs CPU: {cfg.arch_id} widths, {cfg.n_layers} layers, "
          f"{sum(p.numel() for p in _leaves(params))} params, batches "
          f"(2, {data['seq_len']}) at cursors 0 and 1, remat full")
    for name in ("adamw", "adafactor"):
        opt = OptimizerConfig(name=name, lr=1e-3, warmup_steps=1,
                              total_steps=TRAIN_STEPS)
        t0 = time.perf_counter()
        cpu = _train_steps(cfg, opt, params, "cpu", batches)
        cpu_s = time.perf_counter() - t0
        card = _train_steps(cfg, opt, params, "cuda", batches)
        errs = _train_errs(card, cpu, params)
        broken = _train_errs(_train_steps(
            cfg, dataclasses.replace(opt, lr=1.5 * opt.lr), params, "cuda",
            batches), cpu, params)
        print(f"    {name}: losses card {card[0]} cpu {cpu[0]}, grad norms "
              f"card {card[1]} cpu {cpu[1]}; max rel diff loss "
              f"{errs['loss']:.3e} grad norm {errs['grad_norm']:.3e} "
              f"update {errs['update']:.3e} (limits {TRAIN_RTOL}, "
              f"{TRAIN_RTOL}, {UPDATE_RTOL}); broken control (card lr "
              f"1.5x): update {broken['update']:.3e}; CPU run "
              f"{cpu_s:.2f} s | on {smi}")
        if not all(map(math.isfinite, card[0] + card[1])):
            raise AssertionError(f"{name}: non-finite loss or grad norm")
        if errs["loss"] > TRAIN_RTOL or errs["grad_norm"] > TRAIN_RTOL \
                or errs["update"] > UPDATE_RTOL:
            raise AssertionError(f"{name}: card and CPU steps differ")
        if broken["update"] <= UPDATE_RTOL:
            raise AssertionError(f"{name}: the broken control met the "
                                 f"update limit")


def _timed(fn, log, key):
    """``fn`` that adds its wall seconds (card synchronised) to
    ``log[key]``."""
    import torch

    def run(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        log.setdefault(key, []).append(time.perf_counter() - t0)
        return out
    return run


def _governed_agent(env):
    """The training agent over ``env`` with a RuleVoter on
    STANDARD_RULES, a checkpoint every chunk."""
    from repro_torch.core import STANDARD_RULES, MemoryBus, RuleVoter
    from repro_torch.core.acl import BusClient
    from repro_torch.train.trainer import build_training_agent
    bus = MemoryBus()
    agent = build_training_agent(env, total_steps=TRAIN_STEPS, bus=bus,
                                 steps_per_intention=TRAIN_CHUNK,
                                 ckpt_every=TRAIN_CHUNK)
    agent.add_voter(RuleVoter(BusClient(bus, "rv", "voter"),
                              rules=STANDARD_RULES), from_tail=False)
    agent.set_policy("decider", {"mode": "first_voter"})
    agent.set_policy("voter:rule", {"lr_bounds": (0.0, 0.1)})
    return agent, bus


def train_governed(smi, root):
    """Full-width qwen3_4b (fp32, Adafactor, remat full): the governed run
    to step 8 with a checkpoint at step 4 and a final eval; restore step 4
    and replay steps 5-8 (and the broken control from cursor 5); a
    standby on the healthy log (10a); then the executor-crash drill on
    the same env, with 10a's standby takeover."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core import summarize_bus, trace_intents
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.optimizer import OptimizerConfig
    from repro_torch.train.train_step import StepConfig
    from repro_torch.train.trainer import (build_env, h_restore_checkpoint,
                                           h_train_chunk)
    cfg = get_config("qwen3_4b")
    opt = OptimizerConfig(name="adafactor", lr=1e-3, warmup_steps=2,
                          total_steps=TRAIN_STEPS)
    env = build_env(cfg, opt, StepConfig(remat="full"),
                    DataConfig(**TRAIN_DATA), root, device="cuda")
    log = {}
    env.train_step = _timed(env.train_step, log, "step")
    env.ckpts.save = _timed(env.ckpts.save, log, "save")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    env.ensure_initialized(SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(env.state["params"]))
    tokens = TRAIN_DATA["global_batch"] * TRAIN_DATA["seq_len"]
    print(f"  governed run: {cfg.arch_id} {cfg.n_layers} layers, "
          f"{n_params} fp32 params from torch.Generator seed {SEED} in "
          f"{time.perf_counter() - t0:.2f} s; Adafactor lr {opt.lr}, remat "
          f"full; data {TRAIN_DATA} ({tokens} tokens a step); "
          f"{TRAIN_STEPS} steps in chunks of {TRAIN_CHUNK}, checkpoint "
          f"every {TRAIN_CHUNK}; free disk for checkpoints "
          f"{shutil.disk_usage(root).free} B")
    agent, bus = _governed_agent(env)
    agent.send_mail(f"train {cfg.arch_id} to {TRAIN_STEPS} steps")
    t0 = time.perf_counter()
    agent.run_until_idle(max_rounds=100000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    trace = trace_intents(bus.read(0))
    kinds = [t.kind for t in trace]
    summ = summarize_bus(bus)
    chunks = [t.result["value"] for t in trace if t.kind == "train_chunk"]
    losses = [x for c in chunks for x in c["losses"]]
    gns = [c["grad_norm"] for c in chunks]
    evals = [t.result["value"]["eval_loss"] for t in trace
             if t.kind == "eval"]
    print(f"    intents {kinds} committed {summ['n_committed']} aborted "
          f"{summ['n_aborted']}; env.step {env.step} cursor "
          f"{env.data_cursor}; losses {losses}; chunk grad norms {gns}; "
          f"eval loss {evals}; wall {wall:.2f} s | on {smi}")
    if kinds != ["train_chunk", "save_checkpoint", "train_chunk", "eval"] \
            or summ["n_aborted"] or env.step != TRAIN_STEPS \
            or not all(map(math.isfinite, losses + gns + evals)):
        raise AssertionError("the governed training run did not reach its "
                             "target cleanly")
    _standby_passive(smi, bus, env, "the governed run's healthy log")
    step_s = log["step"][1:TRAIN_STEPS]
    step_ms = 1e3 * sum(step_s) / len(step_s)
    print(f"    step time {step_ms:.2f} ms (mean of steps 2-{TRAIN_STEPS}; "
          f"step 1 {1e3 * log['step'][0]:.2f} ms) = "
          f"{tokens * 1e3 / step_ms:.2f} training tokens/s | peak memory "
          f"{peak} B | on {smi}")

    ck = TRAIN_CHUNK
    npz = os.path.join(env.ckpts._dir(ck), "state.npz")
    t0 = time.perf_counter()
    ok = env.ckpts.verify(ck)
    verify_s = time.perf_counter() - t0
    if env.ckpts.list_steps() != [ck] or not ok:
        raise AssertionError(f"the step-{ck} checkpoint does not verify")

    def replay(start):
        t0 = time.perf_counter()
        r = _timed(h_restore_checkpoint, log, "restore")({"step": ck}, env)
        if (r["step"], r["data_cursor"]) != (ck, ck):
            raise AssertionError(f"restore gave {r}")
        return h_train_chunk({"steps": TRAIN_STEPS - ck, "data_start": start},
                             env)["losses"], time.perf_counter() - t0

    first = losses[ck:]
    again, again_s = replay(ck)
    broken, _ = replay(ck + 1)
    err = max(abs(a - b) / abs(b) for a, b in zip(again, first))
    berr = max(abs(a - b) / abs(b) for a, b in zip(broken, first))
    print(f"    checkpoint at step {ck}: {os.path.getsize(npz)} B; save "
          f"{log['save'][0]:.2f} s, verify {verify_s:.2f} s, restore "
          f"{log['restore'][0]:.2f} s (verify included) | on {smi}")
    print(f"    restore + replay of steps {ck + 1}-{TRAIN_STEPS} from cursor "
          f"{ck}: losses {again}, max rel diff from the first run "
          f"{err:.3e} (limit {REPLAY_RTOL}; bitwise {again == first}); "
          f"restore + replay {again_s:.2f} s; broken control from cursor "
          f"{ck + 1}: {berr:.3e} | on {smi}")
    if err > REPLAY_RTOL:
        raise AssertionError("the replay after restore differs")
    if berr <= REPLAY_RTOL:
        raise AssertionError("the broken replay control met the limit")

    # where a step's device time goes (torch.profiler, CUPTI)
    batch = env.batch(env.data_cursor)

    def one_step():
        env.state = env.train_step(env.state, batch)[0]
    _profile(f"one training step ({TRAIN_DATA['global_batch']}, "
             f"{TRAIN_DATA['seq_len']})", [one_step], 1)

    crash_drill(smi, env, root, losses[:ck])


def _standby_passive(smi, bus, env, label):
    """10a's check that a standby on a healthy log stays passive: on the
    real clock, and on a clock 1000 s ahead (no intent is left without a
    Result, however old)."""
    from repro_torch.core import StandbyExecutor
    from repro_torch.train.trainer import TRAIN_HANDLERS
    verdicts = []
    for clock in (time.time, lambda: time.time() + 1000.0):
        standby = StandbyExecutor(bus, env, TRAIN_HANDLERS,
                                  takeover_timeout=TAKEOVER_TIMEOUT_S,
                                  clock=clock)
        verdicts.append((standby.maybe_take_over(), standby.active,
                         standby.takeover_reason))
    print(f"    10a: a StandbyExecutor on {label} ({bus.tail()} entries): "
          f"maybe_take_over {[v[0] for v in verdicts]} on the real clock "
          f"and 1000 s ahead; reasons {[v[2] for v in verdicts]} | on {smi}")
    if any(v != (False, None, None) for v in verdicts):
        raise AssertionError(f"10a: a standby took over {label}: "
                             f"{verdicts}")


def crash_drill(smi, env, root, first_losses):
    """The crash drill of tests/test_recovery.py on slice 4's env: fresh
    weights, no voter, the agent's log in SQLite in the slice's root; a
    second SqliteBus on the same file, as a standby process would open
    it, must see the same pending train_chunk as the agent's bus. Then
    10a: a StandbyExecutor watching its own SqliteBus on the file, on the
    real clock, must stay passive until the pending chunk is older than
    TAKEOVER_TIMEOUT_S, then take over (a fenced, announced reboot), and
    the agent, with the standby as its executor, must roll forward to
    step 8 with one probe. ``first_losses`` are the governed run's first
    chunk's losses, which the drill's first chunk repeats."""
    import torch
    from repro_torch.core import (SqliteBus, StandbyExecutor,
                                  committed_unexecuted, trace_intents)
    from repro_torch.train.trainer import (TRAIN_HANDLERS, InjectedCrash,
                                           build_training_agent)
    env.state, env.step, env.data_cursor = None, 0, 0
    torch.cuda.empty_cache()
    db = os.path.join(root, "drill.db")
    bus = SqliteBus(db)
    agent = build_training_agent(env, total_steps=TRAIN_STEPS, bus=bus,
                                 steps_per_intention=TRAIN_CHUNK,
                                 ckpt_every=100)
    env.crash_after_steps = 6  # dies inside the 2nd train_chunk
    agent.send_mail("train")
    try:
        agent.run_until_idle(max_rounds=100000)
        raise AssertionError("the injected crash did not happen")
    except InjectedCrash:
        t_crash = time.monotonic()
        crash_wall = time.time()
    pend = committed_unexecuted(bus)
    second = SqliteBus(db)
    seen = committed_unexecuted(second)
    second.close()
    print(f"    crash drill on a SqliteBus: pending {pend}; a second "
          f"SqliteBus on the file sees {seen}")
    if [p["kind"] for p in pend] != ["train_chunk"] or env.step != 6:
        raise AssertionError(f"after the crash: pending {pend}, step "
                             f"{env.step}")
    if seen != pend:
        raise AssertionError("a second reader of the SQLite log sees "
                             "another pending set than the agent's bus")
    iid = pend[0]["intent_id"]
    pending_ts = next(t.intent_ts for t in trace_intents(bus.read(0))
                      if t.intent_id == iid)

    # 10a: the standby reads the file through its own SqliteBus
    watch = SqliteBus(db)
    standby = StandbyExecutor(watch, env, TRAIN_HANDLERS,
                              takeover_timeout=TAKEOVER_TIMEOUT_S)
    t0 = time.perf_counter()
    first = standby.check()
    first_s = time.perf_counter() - t0
    n_entries = watch.tail()
    if first is not None:
        raise AssertionError(f"10a, timing control: the standby's first "
                             f"check, {crash_wall - pending_ts:.3f} s after "
                             f"the chunk's intent, gave {first!r} inside "
                             f"its {TAKEOVER_TIMEOUT_S} s timeout")
    polls = []
    while True:
        t0 = time.perf_counter()
        took = standby.maybe_take_over()
        polls.append(time.perf_counter() - t0)
        if took:
            break
        if time.monotonic() - t_crash > TAKEOVER_TIMEOUT_S + 60:
            raise AssertionError("10a: the standby did not take over within "
                                 "60 s of its timeout")
        time.sleep(0.05)
    takeover_s = time.monotonic() - t_crash
    reason = standby.takeover_reason
    poll_ms = 1e3 * sum(polls[:-1]) / max(1, len(polls) - 1)
    print(f"    10a: StandbyExecutor(takeover_timeout="
          f"{TAKEOVER_TIMEOUT_S} s, real clock) on its own SqliteBus on "
          f"the file: the pending chunk's intent was "
          f"{crash_wall - pending_ts:.3f} s old at the crash; first check "
          f"None (the timing control) in {1e3 * first_s:.3f} ms over the "
          f"{n_entries} entries of the log; {len(polls)} polls of "
          f"maybe_take_over, {poll_ms:.3f} ms each while passive "
          f"(incremental); took over "
          f"{takeover_s:.3f} s after the crash: {reason!r} | on {smi}")
    if "no result" not in reason or iid not in reason:
        raise AssertionError(f"10a: the takeover reason {reason!r} does not "
                             f"name the pending train_chunk {iid}")
    agent.executor = standby
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    agent.run_until_idle(max_rounds=100000)
    torch.cuda.synchronize()
    roll_s = time.perf_counter() - t0
    trace = trace_intents(bus.read(0))
    probes = [t.decision for t in trace if t.kind == "probe_state"]
    starts = [t.args["data_start"] for t in trace
              if t.kind == "train_chunk" and t.result and t.result["ok"]]
    drill = [x for t in trace if t.kind == "train_chunk" and t.result
             and t.result["ok"] for x in t.result["value"]["losses"]]
    reboots = [e.body["executor_id"] for e in bus.read(0)
               if e.type.value == "Result" and e.body.get("recovered")]
    print(f"    crash drill: intents {[t.kind for t in trace]}; probes "
          f"{probes}; data starts {starts}; env.step {env.step}; reboot "
          f"Results from {reboots}; first chunk's losses equal the "
          f"governed run's: {drill[:len(first_losses)] == first_losses}; "
          f"10a's roll-forward (probe, the rest of the chunk, eval) "
          f"{roll_s:.3f} s, the agent's SqliteBus reading the standby's "
          f"Results | on {smi}")
    if probes != ["commit"] or env.step != TRAIN_STEPS \
            or any(b <= a for a, b in zip(starts, starts[1:])):
        raise AssertionError("the crash drill did not roll forward once")
    if reboots != [standby.standby_id]:
        raise AssertionError(f"10a: reboot Results from {reboots}, want "
                             f"one from {standby.standby_id}")
    watch.close()
    bus.close()


def _ssd_intra_reference_order(x, dt, a, b, c):
    """Broken control only: ``ssd_intra_plain`` with the reference's
    order, ``where(tri, exp(seg), 0)``, whose backward is NaN where the
    upper triangle's exp overflows."""
    import torch
    rep = x.shape[3] // b.shape[3]
    bh, ch = (t.repeat_interleave(rep, dim=3) for t in (b, c))
    q = x.shape[2]
    cs = torch.cumsum(dt * a, dim=2)
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    L = torch.where(tri[None, None, :, :, None], torch.exp(seg), 0.0)
    cb = torch.einsum("bcthn,bcuhn->bctuh", ch, bh)
    y = torch.einsum("bctuh,bcuh,bcuhp->bcthp", cb * L, dt, x)
    d_end = torch.exp(cs[:, :, -1:, :] - cs)
    states = torch.einsum("bcuh,bcuh,bcuhn,bcuhp->bchpn", d_end, dt, bh, x)
    return y, states, torch.exp(cs[:, :, -1, :])


def train_mamba2(smi):
    """One Adafactor step of full-width mamba2_780m over (2, 512) tokens
    (two SSD chunks of 256): finite loss and grad norm; the broken control
    (the reference's mask order) gives a NaN grad norm."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.models.params import init_params
    from repro_torch.optim.optimizer import OptimizerConfig
    cfg = get_config("mamba2_780m")
    opt = OptimizerConfig(name="adafactor", lr=1e-3, warmup_steps=1)
    batch = _train_batches(dict(TRAIN_DATA, seq_len=512, global_batch=2),
                           (0,), "cuda")

    def one_step():
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
            SEED), "cuda")
        t0 = time.perf_counter()
        out = _train_steps(cfg, opt, params, "cuda", batch)
        return out[0][0], out[1][0], time.perf_counter() - t0

    loss, gn, secs = one_step()
    plain = ssm_lib.ssd_intra_plain
    ssm_lib.ssd_intra_plain = _ssd_intra_reference_order
    try:
        bloss, bgn, _ = one_step()
    finally:
        ssm_lib.ssd_intra_plain = plain
    print(f"  {cfg.arch_id} ({cfg.n_layers} layers, chunk {cfg.ssm.chunk})"
          f": one Adafactor step over (2, 512): loss {loss} grad norm {gn} "
          f"in {secs:.2f} s (first step, with warm-up); broken control "
          f"(where(exp) order): loss {bloss} grad norm {bgn} | on {smi}")
    if not (math.isfinite(loss) and math.isfinite(gn)):
        raise AssertionError("the mamba2 step's loss or gradient is not "
                             "finite")
    if not math.isnan(bgn):
        raise AssertionError("the where(exp) control did not give a NaN "
                             "gradient")


def slice_training(smi):
    """Phase 7: governed training of full-width qwen3_4b, its checkpoint,
    restore, replay and crash drill, the card against the CPU, and one
    full-width mamba2_780m step; no serving kernel may launch."""
    import torch
    print(f"[slice 4] training (fp32, TF32 off) on {smi}")
    t0 = time.perf_counter()
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    train_card_vs_cpu(smi)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-ckpt-") as root:
        train_governed(smi, root)
    torch.cuda.empty_cache()
    train_mamba2(smi)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    print(f"  kernel launches through the training phase: {launches} "
          f"(the loss runs the plain paths) | slice 4 wall "
          f"{time.perf_counter() - t0:.2f} s | on {smi}")
    if any(launches.values()):
        raise AssertionError("a serving kernel launched during training")


# ---------------------------------------------------------------------------
# slice 5: the last dense configs and the moe family at full width
# ---------------------------------------------------------------------------

def _fresh_params(cfg):
    """``cfg``'s fp32 parameters on the card from torch.Generator seed SEED,
    with their count and the seconds they took."""
    import torch
    from repro_torch.models.params import init_params
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), "cuda")
    torch.cuda.synchronize()
    return params, sum(p.numel() for p in _leaves(params)), \
        time.perf_counter() - t0


def _attention_trees(params):
    """Every attention parameter tree of a model's parameters: the
    layers' ``attn``, the decoder's ``cross`` (audio), the shared block's
    ``attn`` (hybrid) and the encoder's ``attn`` (audio)."""
    return [tree[key] for tree in (params.get("layers", {}),
                                   params.get("shared", {}),
                                   params.get("enc_layers", {}))
            for key in ("attn", "cross") if key in tree]


def _slice5_params(cfg):
    """``_fresh_params`` with the ``wq`` and ``wk`` of every attention
    tree (``_attention_trees``) scaled so that, on the unit-RMS rows the
    pre-attention norm gives, each q and k entry has variance SCORE_STD
    and the scores q.k / sqrt(head_dim) have std SCORE_STD."""
    params, n_params, secs = _fresh_params(cfg)
    a = math.sqrt(SCORE_STD)
    for attn in _attention_trees(params):
        attn["wq"].mul_(a * math.sqrt(cfg.n_heads / cfg.d_model))
        attn["wk"].mul_(a * math.sqrt(cfg.n_kv_heads / cfg.d_model))
    return params, n_params, secs


def slice5_requests(cfg, lens):
    """One request a prompt length, the tokens from a numpy seed."""
    import numpy as np
    rng = np.random.default_rng(SEED + 5)
    return [{"req_id": f"req-{i}", "prompt_tokens": rng.integers(
        0, cfg.vocab, size=n).tolist()} for i, n in enumerate(lens)]


def governed_static_runs(cfg, params, requests, smi, per_prefill=None):
    """The governed static agent on the card, the kernel run then the plain
    run: one committed ``serve_batch`` intent each, the prefill's kernels
    launched ``per_prefill`` times ({kernel: launches}; by default flash
    once a layer) in the kernel run and no kernel in the plain run, and
    the same tokens. Returns the kernel run's launches and its
    batches."""
    import torch
    lens = [len(r["prompt_tokens"]) for r in requests]
    per_prefill = per_prefill or {"flash_attention": cfg.n_layers}
    runs = {}
    for label, use_kernel in (("kernel", True), ("plain", False)):
        torch.cuda.reset_peak_memory_stats()
        run = serve_static(cfg, params, requests, use_kernel=use_kernel,
                           new_tokens=SLICE5_NEW_TOKENS)
        ids = [b["intent_id"] for b in run["intents"]]
        want = dict(_no_launches(), **(per_prefill if use_kernel else {}))
        print(f"  {label} run: prompts {lens}, {SLICE5_NEW_TOKENS} new "
              f"tokens; serve_batch intents {len(ids)}, committed "
              f"{len(run['commits'] & set(ids))}; launches "
              f"{run['launches']} (want {want}); wall {run['wall']:.3f} s; "
              f"peak memory {torch.cuda.max_memory_allocated()} B | on {smi}")
        if len(ids) != 1 or not set(ids) <= run["commits"] \
                or run["aborts"] or not all(
                    b["ok"] for b in run["results"].values()) \
                or sorted(run["tokens"]) != sorted(
                    r["req_id"] for r in requests):
            raise AssertionError("want one committed serve_batch intent "
                                 "that serves every request")
        if run["launches"] != want:
            raise AssertionError("the prefill did not launch its kernels "
                                 f"{per_prefill} (kernel run) or the plain "
                                 "run launched a kernel")
        for rid, toks in run["tokens"].items():
            if len(toks) != SLICE5_NEW_TOKENS or not all(
                    0 <= t < cfg.vocab for t in toks):
                raise AssertionError(f"{rid}: bad tokens {toks}")
        runs[label] = run
    batches = _batch_tokens(runs["kernel"], requests)
    _same_tokens(cfg, params, runs["kernel"], runs["plain"], batches)
    print("  kernel and plain runs: identical tokens; " + "; ".join(
        f"{r}: {t}" for r, t in runs["kernel"]["tokens"].items()))
    return runs["kernel"]["launches"], batches


def _launch_check(out, ref, control=None):
    """One kernel launch against its plain version ``ref`` on the same
    inputs, under slice 3's rule (|out - ref| <= CACHE_TOL x (max|ref| +
    |ref|)): (max abs err, the largest ratio of an element's error to its
    limit, and that ratio for ``control``, a broken plain version, or
    None). A NaN anywhere makes a ratio NaN, which fails."""
    lim = CACHE_TOL * (ref.abs().max() + ref.abs())
    ratio = ((out - ref).abs() / lim).max().item()
    c = None if control is None else ((control - ref).abs() / lim
                                      ).max().item()
    return (out - ref).abs().max().item(), ratio, c


def _hold_launches(name, log, control, unit="launches"):
    """Every launch of a run within slice 3's rule of its plain version,
    and every broken control (one at least) beyond it."""
    worst = max(r for _, r, _ in log)
    ctl = [c for _, _, c in log if c is not None]
    print(f"  {name}: {len(log)} {unit}, each held to its plain version on "
          f"its own inputs (slice 3's rule): max abs err "
          f"{max(e for e, _, _ in log):.3e}, largest error / limit "
          f"{worst:.3g}; broken control ({control}) on {len(ctl)} of them, "
          f"least error / limit {min(ctl) if ctl else math.nan:.3g}")
    if not worst <= 1.0 or not ctl or not min(ctl) > 1.0:
        raise AssertionError(f"{name}: a launch missed its plain version, "
                             f"or a broken control met the limit")


def _flash_checker(log):
    """A stand-in for the model's ``flash_mha`` that launches the kernel
    and logs ``_launch_check`` of each batch row against
    ``flash_mha_plain``; the broken control is the plain version without
    the window where the window masks keys, else with ``causal``
    flipped."""
    from repro_torch.kernels.flash_attention import (flash_mha,
                                                     flash_mha_plain)

    def checked(q, k, v, **kw):
        o = flash_mha(q, k, v, **kw)
        windowed = kw.get("window") is not None \
            and kw["window"] < q.shape[1] + k.shape[1]
        broken = (dict(kw, window=None) if windowed else
                  dict(kw, causal=not kw.get("causal", True)))
        for i in range(q.shape[0]):
            args = (q[i:i + 1], k[i:i + 1], v[i:i + 1])
            ref = flash_mha_plain(*args, **kw)
            control = flash_mha_plain(*args, **broken)
            log.append(_launch_check(o[i:i + 1], ref, control))
            del ref, control
        return o
    return checked


def _ssd_checker(log):
    """A stand-in for the SSD layer's ``ssd_intra`` that launches the
    kernel and logs ``_launch_check`` of its y and states against
    ``ssd_intra_plain`` (the worse of the two), the broken control being
    the plain version with each chunk's last row of x that holds a token
    zeroed (the last row, but in a chunk that ``ssd_chunked`` padded,
    whose pad rows have dt 0)."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_intra, ssd_intra_plain

    def checked(x, dt, *rest):
        out = ssd_intra(x, dt, *rest)
        b, nc = x.shape[:2]
        last = (dt > 0).any(-1).int().cumsum(-1).argmax(-1)  # (b, nc)
        x0 = x.clone()
        x0[torch.arange(b, device=x.device)[:, None],
           torch.arange(nc, device=x.device)[None, :], last] = 0
        rest = (dt,) + rest
        checks = [_launch_check(o, r, c) for o, r, c in zip(
            out[:2], ssd_intra_plain(x, *rest)[:2],
            ssd_intra_plain(x0, *rest)[:2])]
        log.append(tuple(max(c[i] for c in checks) for i in range(3)))
        return out
    return checked


def _held_batch(cfg, toks):
    """The held prefill's batch of ``toks`` on the card: the server's, with
    the audio or vlm frontend's input drawn unit normal from a numpy seed
    in place of the server's zeros."""
    import numpy as np
    import torch
    from repro_torch.serving.server import stub_batch
    batch, _ = stub_batch(cfg, torch.from_numpy(toks).cuda())
    rng = np.random.default_rng(SEED + 6)
    for key in ("frame_embed", "patch_embed"):
        if key in batch:
            batch[key] = torch.from_numpy(rng.standard_normal(
                tuple(batch[key].shape)).astype(np.float32)).cuda()
    return batch


def hold_prefill(cfg, params, batch, per_prefill=None, routing=False):
    """One full-width prefill of ``batch`` (``_held_batch``), kernel path
    against plain path: every flash launch held to its plain version on
    the same q/k/v, a row of its batch at a time (``_flash_checker``);
    every ``ssd_intra`` launch held likewise (``_ssd_checker``). The
    prefill must launch ``per_prefill`` ({kernel: launches}; by default
    flash once a layer). Returns the kernel path's and the plain path's
    outputs (``_prefill_outs``) and, with ``routing``, both paths' routing
    logs (kernel, plain)."""
    from repro_torch.models.model import Model
    per_prefill = per_prefill or {"flash_attention": cfg.n_layers}
    krout, prout = ([], []) if routing else (None, None)
    plain = _prefill_with(Model(cfg, use_kernel=False), params, batch,
                          routing=prout)
    flog, slog = [], []
    kernel = _prefill_with(Model(cfg), params, batch,
                           flash=_flash_checker(flog),
                           ssd=_ssd_checker(slog), routing=krout)
    rows = batch["tokens"].shape[0]
    print(f"  prefill {tuple(batch['tokens'].shape)}"
          + "".join(f", {k} {tuple(v.shape)} unit normal (numpy seed "
                    f"{SEED + 6})" for k, v in batch.items()
                    if k != "tokens") + ":")
    if len(flog) != per_prefill.get("flash_attention", 0) * rows \
            or len(slog) != per_prefill.get("ssd_intra", 0):
        raise AssertionError(f"{cfg.arch_id}: {len(flog)} flash launch "
                             f"rows and {len(slog)} ssd_intra launches, "
                             f"not {per_prefill} a prefill")
    if flog:
        _hold_launches("flash_mha", flog, "plain without the window where "
                       "it masks keys, else with causal flipped", unit="launch"
                       " rows (a row of each launch's batch)")
    if slog:
        _hold_launches("ssd_intra", slog, "plain with each chunk's last "
                       "token's x row zeroed")
    return kernel, plain, (krout, prout)


def hold_outputs(cfg, kernel, plain, layers=slice(None), logits=True):
    """The kernel path's prefill outputs held to the plain path's
    (``_gaps``): every cache output over ``layers`` and, with ``logits``,
    the logits. Raises if one is over its limit or the plain logits are
    not finite."""
    import torch
    gaps = _gaps(kernel, plain, layers)
    if not logits:
        del gaps["logits"]
    rest = [n for n in gaps if n != "logits"]
    print(f"  held: " + (f"the logits (limit {LOGIT_RTOL} x max|logit|) "
                         f"and " if logits else "")
          + ", ".join(rest) + ("" if layers == slice(None) else
                               f" of layers {layers.start}-"
                               f"{layers.stop - 1}")
          + f" (limit {CACHE_TOL} x max + rtol {CACHE_TOL})")
    _print_gaps("kernel", gaps)
    if not (torch.isfinite(plain["logits"]).all()
            and all(ok for _, _, ok in gaps.values())):
        raise AssertionError(f"{cfg.arch_id} prefill: kernel vs plain over "
                             f"the limit")


def slice5_gemma2(smi):
    """gemma2_9b at full width through the governed static agent, with a
    prompt longer than its 4096 window: the flash kernel's window masks
    keys in every even layer. Returns the flash launches of the governed
    kernel run."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import INF_WINDOW, Model
    t_slice = time.perf_counter()
    cfg = get_config("gemma2_9b")
    torch.cuda.reset_peak_memory_stats()
    params, n_params, secs = _slice5_params(cfg)
    print(f"  {cfg.arch_id}: {cfg.n_layers} layers (even ones windowed "
          f"{cfg.window}), d_model {cfg.d_model}, heads {cfg.n_heads}/"
          f"{cfg.n_kv_heads} x {cfg.head_dim}, d_ff {cfg.d_ff} (gelu), "
          f"softcaps {cfg.attn_softcap}/{cfg.final_softcap}, vocab "
          f"{cfg.vocab}; {n_params} fp32 params in {secs:.2f} s")
    launches, batches = governed_static_runs(
        cfg, params, slice5_requests(cfg, GEMMA2_PROMPTS), smi)
    launches = launches["flash_attention"]

    # the (2, 4500) prefill, kernel vs plain: the logits and every layer's
    # K/V; the broken control runs the plain path with no window on any
    # layer (the even layers' 4096 replaced by INF_WINDOW)
    _, toks = batches[0]
    batch = _held_batch(cfg, toks)
    kernel, plain, _ = hold_prefill(cfg, params, batch)
    hold_outputs(cfg, kernel, plain)
    del kernel
    pmodel = Model(cfg, use_kernel=False)
    pmodel._window_array = lambda: [INF_WINDOW] * cfg.n_layers
    cgap = _gaps(_prefill_with(pmodel, params, batch), plain)
    _print_gaps("control, plain without the 4096 window (all layers)", cgap)
    if cgap["logits"][2]:
        raise AssertionError("the plain path without the window met the "
                             "logits limit: the window masks nothing here")
    del plain
    time_static(Model(cfg), params, batches, smi)

    # the kernel timed at layer 0's windowed shape in that prefill
    case, kw = _capture(Model(cfg), params, batch, "flash_mha",
                        lambda a, kw: True)
    if kw["window"] != cfg.window or kw["softcap"] != cfg.attn_softcap:
        raise AssertionError(f"layer 0 called flash_mha with {kw}")
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    t = time_flash_attention(case, flush, softcap=cfg.attn_softcap,
                             window=cfg.window)
    print(f"  flash_mha at gemma2_9b's layer 0 q {tuple(case[0].shape)} k/v "
          f"{tuple(case[1].shape)} causal window {cfg.window} softcap "
          f"{cfg.attn_softcap}: kernel {t['ms']:.4f} ms, plain "
          f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']}: {t['flop']} FLOP over the window's visible "
          f"pairs, {t['bytes']} B), sdpa (window mask, no softcap) on K/V "
          f"repeated to {cfg.n_heads} heads {t['library_ms']:.4f} ms | "
          f"kernel at {t['flop'] / t['ms'] / 1e9:.2f} TFLOP/s | on {smi}")
    print(f"  gemma2_9b peak memory {torch.cuda.max_memory_allocated()} B; "
          f"wall {time.perf_counter() - t_slice:.2f} s | on {smi}")
    return launches


def _paged_checker(log):
    """A stand-in for the engine's ``paged_attention`` that launches the
    kernel and logs ``_launch_check`` of each launch against
    ``paged_attention_plain``, the broken control being the plain version
    with the kv heads rolled by one, so that every query head reads
    another kv head's keys and values (a wrong GQA map)."""
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_plain)

    def checked(q, kp, vp, bt, cl, **kw):
        o = paged_attention(q, kp, vp, bt, cl, **kw)
        log.append(_launch_check(
            o, paged_attention_plain(q, kp, vp, bt, cl, **kw),
            paged_attention_plain(q, kp.roll(1, dims=2),
                                  vp.roll(1, dims=2), bt, cl, **kw)))
        return o
    return checked


def slice5_chatglm3(smi):
    """chatglm3_6b at full width (32 heads on 2 kv heads: 16 a kv head)
    through the governed continuous agent on slice 1's request pattern:
    the kernel run (each paged launch held to its plain version on its own
    inputs) and the plain run, with the same tokens. Returns the paged
    launches of the kernel run."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.serving import engine as engine_lib
    t_slice = time.perf_counter()
    cfg = get_config("chatglm3_6b")
    torch.cuda.reset_peak_memory_stats()
    params, n_params, secs = _slice5_params(cfg)
    print(f"  {cfg.arch_id}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads} x {cfg.head_dim}, rope "
          f"fraction {cfg.rope_fraction}, untied head, vocab {cfg.vocab}; "
          f"{n_params} fp32 params in {secs:.2f} s")
    requests = make_requests(cfg, np.random.default_rng(SEED))
    served = {r["req_id"]: r for r in requests if r["tenant"] != "blocked"}
    blocked = [r["req_id"] for r in requests if r["tenant"] == "blocked"]
    wrappers = _wrappers()
    checks, outs = [], {}
    kernel_fn = engine_lib.paged_attention
    for label, use_kernel in (("kernel", True), ("plain", False)):
        if use_kernel:
            engine_lib.paged_attention = _paged_checker(checks)
        for fn in wrappers.values():
            fn.launches = 0
        try:
            run = serve(cfg, params, requests, use_kernel=use_kernel)
        finally:
            engine_lib.paged_attention = kernel_fn
        pl, eng = run["planner"], run["engine"]
        launches = {name: fn.launches for name, fn in wrappers.items()}
        want = dict(_no_launches(), paged_attention=eng.n_steps
                    * cfg.n_layers if use_kernel else 0)
        print(f"  {label} run: served {len(pl.outputs)} rejected "
              f"{pl.rejected} decode steps {eng.n_steps}; launches "
              f"{launches} (want {want}: {eng.n_steps} steps x "
              f"{cfg.n_layers} layers); wall {run['wall']:.3f} s | on {smi}")
        if set(pl.outputs) != set(served) or pl.rejected != blocked:
            raise AssertionError("served/rejected sets differ from the plan")
        if launches != want or eng.n_steps == 0:
            raise AssertionError("the decode steps did not all go through "
                                 "the paged kernel, or another kernel ran")
        for rid, toks in pl.outputs.items():
            if len(toks) != served[rid]["max_new_tokens"] or not all(
                    0 <= t < cfg.vocab for t in toks):
                raise AssertionError(f"{rid}: bad tokens {toks}")
        outs[label] = (dict(pl.outputs), launches["paged_attention"])
        del run, pl, eng
    if len(checks) != outs["kernel"][1]:
        raise AssertionError("not every paged launch was held")
    _hold_launches("paged_attention", checks,
                   "plain with the kv heads rolled")
    got, want = outs["kernel"][0], outs["plain"][0]
    differ = {rid: next(i for i, (u, v) in enumerate(zip(got[rid], toks))
                        if u != v)
              for rid, toks in want.items() if got[rid] != toks}
    if differ:
        raise AssertionError(f"kernel vs plain tokens differ (request: "
                             f"first decoded position) {differ}")
    print(f"  kernel and plain runs: identical tokens for all "
          f"{len(outs['plain'][0])} served requests ("
          f"{sum(map(len, outs['plain'][0].values()))} tokens)")
    time_continuous(cfg, params, served, smi)
    print(f"  chatglm3_6b peak memory {torch.cuda.max_memory_allocated()} B;"
          f" wall {time.perf_counter() - t_slice:.2f} s | on {smi}")
    return outs["kernel"][1]


def slice5_mixtral(smi):
    """mixtral_8x7b at full width, depth cut to MIXTRAL_LAYERS layers,
    through the governed static agent with prompts longer than its 4096
    window (the prefill's flash launches mask by the window; decode writes
    the ring-buffer cache). The capacity rule drops pairs; a no-drop
    control must move the logits. Returns the flash launches of the
    governed kernel run."""
    import dataclasses
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Model
    from repro_torch.models.moe import capacity
    t_slice = time.perf_counter()
    full = get_config("mixtral_8x7b")
    cfg = dataclasses.replace(full, n_layers=MIXTRAL_LAYERS)
    m = cfg.moe
    torch.cuda.reset_peak_memory_stats()
    params, n_params, secs = _slice5_params(cfg)
    print(f"  {cfg.arch_id}: {cfg.n_layers} of {full.n_layers} layers "
          f"(depth cut: the {full.n_params()} fp32 params need "
          f"{4 * full.n_params() / 1e9:.1f} GB), d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} x {cfg.head_dim}, window "
          f"{cfg.window}, {m.n_experts} experts of {m.d_ff_expert}, top "
          f"{m.top_k}, capacity factor {m.capacity_factor}; {n_params} fp32 "
          f"params in {secs:.2f} s")
    launches, batches = governed_static_runs(
        cfg, params, slice5_requests(cfg, MIXTRAL_PROMPTS), smi)
    launches = launches["flash_attention"]

    # the (2, 4500) prefill, kernel vs plain, with every layer's routing
    # recorded: the K/V are held up to the first layer where the two paths
    # route a token otherwise (inclusive: its K/V come before its moe
    # block), and the logits only if no layer does; that must cover layer
    # 1, the first after an attention and a moe block
    _, toks = batches[0]
    n_tok = toks.size
    batch = _held_batch(cfg, toks)
    kernel, plain, (krout, prout) = hold_prefill(cfg, params, batch,
                                                 routing=True)
    differ = [int((ke != pe).any(-1).sum())
              for (ke, _), (pe, _) in zip(krout, prout)]
    first = next((i for i, d in enumerate(differ) if d), None)
    dropped = [int((~keep).sum()) for _, keep in krout]
    cap = capacity(n_tok, m.n_experts, m.top_k, m.capacity_factor)
    print(f"  capacity C = {cap} of {n_tok} tokens x top {m.top_k} over "
          f"{m.n_experts} experts; (token, expert) pairs dropped per prefill "
          f"layer {dropped} (of {n_tok * m.top_k}); tokens routed otherwise, "
          f"kernel vs plain, per layer {differ}")
    if not sum(dropped):
        raise AssertionError("mixtral: the capacity rule dropped no pair")
    upto = cfg.n_layers if first is None else first + 1
    if upto < 2:
        raise AssertionError("mixtral: layer 0 routes a token otherwise, so "
                             "no layer after a moe block can be held")
    print("  " + ("no routing decision differs: the logits are held" if
                  first is None else f"layer {first} routes {differ[first]} "
                  f"tokens otherwise: the logits are not held"))
    hold_outputs(cfg, kernel, plain, slice(0, upto), logits=first is None)
    del kernel

    # broken control: the plain path at a capacity factor that drops
    # nothing (C = N) must move the logits past the limit
    no_drop = dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))
    crout = []
    control = _prefill_with(Model(no_drop, use_kernel=False), params, batch,
                            routing=crout)
    cgap = _gaps(control, plain)
    c_dropped = sum(int((~keep).sum()) for _, keep in crout)
    _print_gaps(f"control, plain at capacity factor "
                f"{no_drop.moe.capacity_factor} ({c_dropped} dropped)", cgap)
    if c_dropped or cgap["logits"][2]:
        raise AssertionError("the no-drop control dropped pairs or met the "
                             "logits limit")
    del control, plain
    time_static(Model(cfg), params, batches, smi)
    print(f"  mixtral_8x7b peak memory {torch.cuda.max_memory_allocated()} "
          f"B; wall {time.perf_counter() - t_slice:.2f} s | on {smi}")
    return launches


def slice_new_configs(smi):
    """Phase 8: gemma2_9b (static), chatglm3_6b (continuous) and
    mixtral_8x7b (static, 8 layers) at full width, one after another,
    each run's weights freed before the next. Returns the flash and paged
    launches of their governed kernel runs."""
    import torch
    print(f"[slice 5] the last dense configs and the moe family at full "
          f"width, fp32 random weights (torch.Generator seed {SEED}) on "
          f"{smi}")
    t0 = time.perf_counter()
    flash = slice5_gemma2(smi)
    torch.cuda.empty_cache()
    paged = slice5_chatglm3(smi)
    torch.cuda.empty_cache()
    flash_moe = slice5_mixtral(smi)
    torch.cuda.empty_cache()
    print(f"  slice 5 wall {time.perf_counter() - t0:.2f} s | on {smi}")
    return {"flash_attention": flash + flash_moe, "paged_attention": paged,
            "flash_by_run": {"gemma2_9b": flash, "mixtral_8x7b": flash_moe}}


# ---------------------------------------------------------------------------
# slice 6: the hybrid, audio and vlm families at full width
# ---------------------------------------------------------------------------

def _print_flash_time(label, case, kw, t, smi):
    print(f"  flash_mha at {label} q {tuple(case[0].shape)} k/v "
          f"{tuple(case[1].shape)} {kw}: kernel {t['ms']:.4f} ms, plain "
          f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']}: {t['flop']} FLOP over the visible pairs, "
          f"{t['bytes']} B), sdpa on K/V repeated to the query heads "
          f"{t['library_ms']:.4f} ms | kernel at "
          f"{t['flop'] / t['ms'] / 1e9:.2f} TFLOP/s | on {smi}")


def _slice6_config(name, smi, cfg, per_prefill, prompts, describe,
                   adjust=None):
    """The common part of a slice-6 config: fresh scaled weights (then
    ``adjust(params)``, which returns what it did), the governed kernel
    and plain runs, the held prefill. Returns (params, the kernel run's
    launches, its batches, the held batch, the plain path's outputs)."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    params, n_params, secs = _slice5_params(cfg)
    print(f"  {name}: {describe}; {n_params} fp32 params in {secs:.2f} s; "
          f"wq/wk of {len(_attention_trees(params))} attention tree(s) "
          f"scaled to score std {SCORE_STD}")
    if adjust:
        print(f"  then {adjust(params)}")
    launches, batches = governed_static_runs(
        cfg, params, slice5_requests(cfg, prompts), smi,
        per_prefill=per_prefill)
    _, toks = batches[0]
    batch = _held_batch(cfg, toks)
    kernel, plain, _ = hold_prefill(cfg, params, batch, per_prefill)
    hold_outputs(cfg, kernel, plain)
    return params, launches, batches, batch, plain


def slice6_zamba2(smi):
    """zamba2_1p2b at full width (38 mamba2 layers, the shared block after
    every 6th) through the governed static agent, with a prompt past the
    shared block's 4096 window. Returns the kernel run's launches."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.models.model import Model
    t_slice = time.perf_counter()
    cfg = get_config("zamba2_1p2b")
    s, L, k = cfg.ssm, cfg.n_layers, cfg.hybrid_attn_every
    per = {"ssd_intra": L, "flash_attention": L // k}
    params, launches, batches, batch, plain = _slice6_config(
        "zamba2_1p2b", smi, cfg, per, ZAMBA2_PROMPTS,
        f"{L} mamba2 layers ({s.expand * cfg.d_model // s.head_dim} heads x"
        f" {s.head_dim}, d_state {s.d_state}, groups {s.n_groups}, chunk "
        f"{s.chunk}), the shared block after every {k}th ({L // k} "
        f"applications, {L % k} layers after the last), heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} x {cfg.head_dim}, window "
        f"{cfg.window}, d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}")

    # broken control: the plain path with no window on the shared block
    attention = model_lib.attention
    control = _prefill_with(Model(cfg, use_kernel=False), params, batch,
                            attention=lambda q, k_, v, **kw: attention(
                                q, k_, v, **dict(kw, window=None)))
    cgap = _gaps(control, plain)
    del control, plain
    _print_gaps(f"control, plain without the shared {cfg.window} window",
                cgap)
    if cgap["logits"][2] and cgap["K"][2] and cgap["V"][2]:
        raise AssertionError("the plain path without the window met the "
                             "K/V and logits limits")
    time_static(Model(cfg), params, batches, smi)

    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    case, kw = _capture(Model(cfg), params, batch, "flash_mha",
                        lambda a, kw: True)
    t = time_flash_attention(case, flush, window=kw["window"])
    _print_flash_time("zamba2_1p2b's shared block (its first application)",
                      case, kw, t, smi)
    case, _ = _capture(Model(cfg), params, batch, "ssd_intra",
                       lambda a, kw: True)
    t = time_ssd_intra(case, flush)
    print(f"  ssd_intra at zamba2_1p2b's layer 0 x {tuple(case[0].shape)} "
          f"b/c {tuple(case[3].shape)}: kernel {t['ms']:.4f} ms, plain "
          f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']}: {t['flop']} FLOP, {t['bytes']} B), "
          f"yardstick (two batched matmuls with the mask between) "
          f"{t['yardstick_ms']:.4f} ms | {t['blocks']} | on {smi}")
    print(f"  zamba2_1p2b peak memory {torch.cuda.max_memory_allocated()} B;"
          f" wall {time.perf_counter() - t_slice:.2f} s | on {smi}")
    return launches


def _order_readings(cfg, params, batch, score_std):
    """How far the held outputs of one prefill of ``batch`` move at these
    weights, each against the plain path: the kernel path (the held
    check); the kernel path with every launch replaced by its plain
    version ``flash_mha_plain`` (the same function at the same call
    sites); that path with seeded normal noise added to each launch's
    output, of the std of the kernel's own error at that launch (any
    perturbation of the kernel's size, in no direction of the kernel's);
    and the plain path with every attention summed by the online softmax
    over 64-key tiles (``attention_chunked``)."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_mha,
                                                     flash_mha_plain)
    from repro_torch.models import layers
    from repro_torch.models import model as model_lib
    from repro_torch.models.model import Model
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def noised(q, k, v, **kw):
        ref = flash_mha_plain(q, k, v, **kw)
        std = (flash_mha(q, k, v, **kw) - ref).std()
        return ref + std * torch.randn(ref.shape, generator=gen,
                                       device=ref.device)
    plain = _prefill_outs(Model(cfg, use_kernel=False), params, batch)
    readings = {
        "kernel path (the held check)": _prefill_outs(Model(cfg), params,
                                                      batch),
        "kernel path with flash_mha_plain at every launch": _prefill_with(
            Model(cfg), params, batch, flash=flash_mha_plain),
        "flash_mha_plain plus noise of the kernel's error std at every "
        "launch": _prefill_with(Model(cfg), params, batch, flash=noised)}
    saved = layers.attention, model_lib.attention
    layers.attention = model_lib.attention = (
        lambda q, k, v, **kw: layers.attention_chunked(
            q, k, v, **dict(kw, kv_chunk=64)))
    try:
        readings["plain summed in 64-key tiles"] = _prefill_outs(
            Model(cfg, use_kernel=False), params, batch)
    finally:
        layers.attention, model_lib.attention = saved
    print(f"  at score std {score_std}, the held outputs of other paths:")
    for label, out in readings.items():
        _print_gaps(label, _gaps(out, plain))


def _whisper_weights(cfg, params):
    """Conditions whisper's random weights for the held checks. First
    every decoder layer's cross ``wk`` is divided by the RMS of the
    encoder's output on the server's zero frames: ``_slice5_params``
    scales ``wk`` for unit-RMS rows, as the pre-attention norm leaves
    them, but the cross-attention's keys come from the encoder's output,
    which no norm follows (as in the reference), and at init_params'
    scale their scores have a std near 220, where rows whose top two
    scores lie within ~0.01 turn on the order of fp32 sums. Then every
    ``wq`` and ``wk`` is scaled by sqrt(WHISPER_SCORE_STD / SCORE_STD),
    so that the scores have std WHISPER_SCORE_STD: at SCORE_STD the
    outputs move by about the held limits under any perturbation of the
    kernel's size or another order of the attention sums
    (``_order_readings``, printed at both), so no limit could tell a
    wrong kernel from the order of sums. Returns what it did."""
    import torch
    from repro_torch.models.model import Model
    from repro_torch.serving.server import pad_prompts
    with torch.no_grad():
        rms = Model(cfg, use_kernel=False)._encode(params, torch.zeros(
            (1, cfg.enc_seq, cfg.d_model), device="cuda")).pow(2).mean(
        ).sqrt().item()
    params["layers"]["cross"]["wk"].div_(rms)
    batch = _held_batch(cfg, pad_prompts([
        r["prompt_tokens"] for r in slice5_requests(cfg, WHISPER_PROMPTS)]))
    _order_readings(cfg, params, batch, SCORE_STD)
    f = math.sqrt(WHISPER_SCORE_STD / SCORE_STD)
    for attn in _attention_trees(params):
        attn["wq"].mul_(f)
        attn["wk"].mul_(f)
    _order_readings(cfg, params, batch, WHISPER_SCORE_STD)
    return (f"the cross wk divided by the encoder output's RMS on zero "
            f"frames, {rms:.4f}, then every wq and wk by "
            f"{1 / f:.4f}: score std {WHISPER_SCORE_STD}")


def slice6_whisper(smi):
    """whisper_small at full width (12 encoder and 12 decoder layers, the
    encoder over 1500 frames) through the governed static agent on the
    server's zero frames; the held prefill on unit-normal frames. Returns
    the kernel run's launches."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.models.model import Model
    t_slice = time.perf_counter()
    cfg = get_config("whisper_small")
    per = {"flash_attention": cfg.n_enc_layers + 2 * cfg.n_layers}
    params, launches, batches, batch, plain = _slice6_config(
        "whisper_small", smi, cfg, per, WHISPER_PROMPTS,
        f"{cfg.n_enc_layers} encoder layers over {cfg.enc_seq} frames and "
        f"{cfg.n_layers} decoder layers with cross-attention, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} x {cfg.head_dim}, d_model "
        f"{cfg.d_model}, d_ff {cfg.d_ff} ({cfg.mlp_activation}, not "
        f"gated), learned positions, vocab {cfg.vocab}; flash a prefill: "
        f"{cfg.n_enc_layers} encoder (not causal), {cfg.n_layers} decoder "
        f"self (causal), {cfg.n_layers} cross (not causal)",
        adjust=lambda p: _whisper_weights(cfg, p))

    # broken control: the encoder causal on the plain path (the decoder's
    # self-attention is causal already; the cross-attention runs the
    # layers module's attention, which stays as it is)
    attention = model_lib.attention
    control = _prefill_with(Model(cfg, use_kernel=False), params, batch,
                            attention=lambda q, k, v, **kw: attention(
                                q, k, v, **dict(kw, causal=True)))
    cgap = _gaps(control, plain)
    del control, plain
    _print_gaps("control, plain with the encoder causal", cgap)
    if cgap["logits"][2]:
        raise AssertionError("the causal encoder met the logits limit")
    time_static(Model(cfg), params, batches, smi)

    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    case, kw = _capture(Model(cfg), params, batch, "flash_mha",
                        lambda a, kw: a[0].shape[1] != a[1].shape[1])
    t = time_flash_attention(case, flush, causal=False)
    _print_flash_time("whisper_small's cross-attention (decoder layer 0)",
                      case, kw, t, smi)
    print(f"  whisper_small peak memory {torch.cuda.max_memory_allocated()}"
          f" B; wall {time.perf_counter() - t_slice:.2f} s | on {smi}")
    return launches


def slice6_internvl2(smi):
    """internvl2_26b at full width, depth cut to INTERNVL2_LAYERS layers,
    through the governed static agent on the server's zero patch
    embeddings; the held prefill on unit-normal ones. Returns the kernel
    run's launches."""
    import dataclasses
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Model
    t_slice = time.perf_counter()
    full = get_config("internvl2_26b")
    cfg = dataclasses.replace(full, n_layers=INTERNVL2_LAYERS)
    params, launches, batches, batch, plain = _slice6_config(
        "internvl2_26b", smi, cfg, {"flash_attention": cfg.n_layers},
        INTERNVL2_PROMPTS,
        f"{cfg.n_layers} of {full.n_layers} layers (depth cut: the "
        f"{full.n_params()} fp32 params need "
        f"{4 * full.n_params() / 1e9:.1f} GB), d_model {cfg.d_model}, "
        f"heads {cfg.n_heads}/{cfg.n_kv_heads} x {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, {cfg.n_frontend_tokens} patch tokens prefixed, "
        f"untied head, vocab {cfg.vocab}")

    # broken control: the plain path with the patch prefix dropped
    control = _prefill_with(Model(cfg, use_kernel=False), params, dict(
        batch, patch_embed=batch["patch_embed"][:, :0]))
    lerr = (control["logits"] - plain["logits"]).abs().max().item()
    lok = lerr <= LOGIT_RTOL * plain["logits"].abs().max().item()
    del control, plain
    print(f"    control, plain with the patch prefix dropped vs plain: "
          f"logits {lerr:.4e} ({'within' if lok else 'over'})")
    if lok:
        raise AssertionError("the dropped prefix met the logits limit")
    time_static(Model(cfg), params, batches, smi)
    print(f"  internvl2_26b peak memory "
          f"{torch.cuda.max_memory_allocated()} B; wall "
          f"{time.perf_counter() - t_slice:.2f} s | on {smi}")
    return launches


def slice_last_families(smi):
    """Phase 9: zamba2_1p2b, whisper_small and internvl2_26b (24 layers)
    at full width through the governed static agent, one after another,
    each one's weights freed before the next. Returns the flash and SSD
    launches of their governed kernel runs."""
    import torch
    print(f"[slice 6] the hybrid, audio and vlm families at full width, "
          f"fp32 random weights (torch.Generator seed {SEED}) on {smi}")
    t0 = time.perf_counter()
    runs = {}
    for arch, fn in (("zamba2_1p2b", slice6_zamba2),
                     ("whisper_small", slice6_whisper),
                     ("internvl2_26b", slice6_internvl2)):
        runs[arch] = fn(smi)
        torch.cuda.empty_cache()
    print(f"  slice 6 wall {time.perf_counter() - t0:.2f} s | on {smi}")
    return {"flash_attention": sum(r["flash_attention"]
                                   for r in runs.values()),
            "ssd_intra": runs["zamba2_1p2b"]["ssd_intra"],
            "flash_by_run": {a: r["flash_attention"]
                             for a, r in runs.items()}}


# ---------------------------------------------------------------------------
# slice 7: the entry points and the int8 KV cache at full width
# ---------------------------------------------------------------------------

def _served(agent):
    """Each executed ``serve_batch`` of the agent's log: (prompts,
    generated tokens)."""
    from repro_torch.core import trace_intents
    return [(t.args["prompts"], t.result["value"]["generated"])
            for t in trace_intents(agent.bus.read(0))
            if t.kind == "serve_batch" and t.result and t.result["ok"]]


def _plain_agent(build, params):
    """``build`` (``build_serving_agent``) for the plain path
    (``use_kernel=False``), its env holding ``params``."""
    def plain(cfg, **kw):
        agent = build(cfg, use_kernel=False, **kw)
        agent.executor.env.params = params
        return agent
    return plain


def launch_serve(arch, per_prefill, smi):
    """Phase 7a: ``launch.serve.main`` at full width on the card (the
    launcher's 8 requests of 3 tokens in one ``serve_batch`` of 16 new
    tokens), every kernel's count zeroed just before and read just after;
    the same launcher with its agent's model on the plain path and the
    kernel run's parameters must serve the same tokens; then a held
    prefill of the served batch (``hold_prefill``: every kernel launch
    against its plain version, beside its broken control) and its
    outputs (``hold_outputs``). Returns the kernel run's launches and its
    config and parameters."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.serving.server import pad_prompts
    argv = SERVE_ARGV + [arch]
    wrappers = _wrappers()
    runs = {}
    for label in ("kernel", "plain"):
        print(f"  launch.serve.main({argv}), {label} run:")
        torch.cuda.reset_peak_memory_stats()
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        if label == "kernel":
            agent = serve.main(argv)
        else:
            with mock.patch.object(serve, "build_serving_agent", _plain_agent(
                    serve.build_serving_agent,
                    runs["kernel"][0].executor.env.params)):
                agent = serve.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in wrappers.items()}
        runs[label] = (agent, launches)
        print(f"    launches {launches}; wall {wall:.3f} s (the kernel run "
              f"draws the parameters); peak memory "
              f"{torch.cuda.max_memory_allocated()} B | on {smi}")
    agent, launches = runs["kernel"]
    cfg, params = agent.executor.env.model.cfg, agent.executor.env.params
    want = dict(_no_launches(), **per_prefill)
    got, ref = _served(agent), _served(runs["plain"][0])
    print(f"  {cfg.arch_id}: served batches {len(got)} of "
          f"{[len(pr) for pr, _ in got]} prompts; kernel tokens equal to the "
          f"plain run's: {got == ref}; e.g. {got[0][1][:2]}")
    if launches != want or runs["plain"][1] != _no_launches():
        raise AssertionError(f"the launcher's kernel run launched "
                             f"{launches}, not {want}, or its plain run "
                             f"launched a kernel")
    if len(got) != 1 or got != ref:
        raise AssertionError("the launcher's kernel and plain runs served "
                             "other tokens, or not in one batch")
    for _, gen in got:
        if not all(len(g) == 16 and all(0 <= t < cfg.vocab for t in g)
                   for g in gen):
            raise AssertionError(f"bad tokens {gen}")
    batch = _held_batch(cfg, pad_prompts(got[0][0]))
    kernel, plain, _ = hold_prefill(cfg, params, batch, per_prefill)
    hold_outputs(cfg, kernel, plain)
    del runs, kernel, plain
    return launches, cfg, params


def _int8_gap(got, want):
    """The int8 K or V of the kernel path's prefill against the plain
    path's: the largest difference of the ints and their share that
    differ."""
    d = (got.int() - want.int()).abs()
    return d.max().item(), (d > 0).float().mean().item()


def _decode_probs(model, params, cache, plen, fed):
    """STATIC_NEW_TOKENS decode steps from ``cache`` at positions ``plen``
    on, step t feeding ``fed[t]`` (B, 1); where ``fed`` runs out, the
    step's greedy token is appended to it. Returns each step's softmax of
    the last position, the ms a step and the peak memory."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    probs = []
    for t in range(STATIC_NEW_TOKENS):
        logits, cache = model.decode_step(params, cache, fed[t], plen + t)
        probs.append(torch.softmax(logits[:, -1], dim=-1))
        if len(fed) == t + 1:
            fed.append(torch.argmax(logits[:, -1], dim=-1)[:, None])
    torch.cuda.synchronize()
    return (probs, (time.perf_counter() - t0) * 1e3 / STATIC_NEW_TOKENS,
            torch.cuda.max_memory_allocated())


def int8_cache(cfg, params, smi):
    """Phase 7d: ``Model(cfg, kv_quant=True)`` at full width with the flash
    kernel on slice 3's two static batches (16 extra slots): the int8 K/V
    held to the plain path's prefill within 1 (the share that differ
    printed) and the scales to slice 3's rule, the cache's bytes beside
    the exact fp32 cache's; then 16 decode steps on the fp32 run's greedy
    tokens, the int8 run's softmax within INT8_SOFTMAX_LIMIT of the fp32
    run's at every step, beside a broken control (the ints rolled by one
    kv head) that must break it; decode step times and peak memory of
    both."""
    import torch
    from repro_torch.models.model import Model
    from repro_torch.serving.server import pad_prompts
    reqs = static_requests(cfg)
    n_new = STATIC_NEW_TOKENS
    exact = Model(cfg)
    quant, quant_plain = (Model(cfg, kv_quant=True),
                          Model(cfg, kv_quant=True, use_kernel=False))
    flash = _wrappers()["flash_attention"]
    for i in range(0, len(reqs), STATIC_MAX_BATCH):
        toks = pad_prompts([r["prompt_tokens"]
                            for r in reqs[i:i + STATIC_MAX_BATCH]])
        batch = {"tokens": torch.from_numpy(toks).cuda()}
        plen = toks.shape[1]
        logits, cache = exact.prefill(params, batch, extra_cache=n_new)
        f_bytes = {n: t.nbytes for n, t in cache["attn"].items()}
        fed = [torch.argmax(logits[:, -1], dim=-1)[:, None]]
        want, f_ms, f_peak = _decode_probs(exact, params, cache, plen, fed)
        del cache
        flash.launches = 0
        cq = quant.prefill(params, batch, extra_cache=n_new)[1]
        n_flash = flash.launches
        cp = quant_plain.prefill(params, batch, extra_cache=n_new)[1]
        gaps = {n: _int8_gap(cq["attn"][n], cp["attn"][n]) for n in "kv"}
        scale = {n: _launch_check(cq["attn"][f"{n}_scale"],
                                  cp["attn"][f"{n}_scale"])[1] for n in "kv"}
        del cp
        q_bytes = {n: t.nbytes for n, t in cq["attn"].items()}
        print(f"  prefill {tuple(toks.shape)} + {n_new} slots, int8 cache "
              f"(flash launches {n_flash}), K/V "
              f"{tuple(cq['attn']['k'].shape)} against the plain path's: K "
              f"ints differ by at most {gaps['k'][0]}, in a share "
              f"{gaps['k'][1]:.3e}; V at most {gaps['v'][0]}, in "
              f"{gaps['v'][1]:.3e}; the scales' largest error / limit "
              f"(slice 3's rule) K {scale['k']:.3g}, V {scale['v']:.3g}")
        print(f"    cache bytes (nbytes): int8 {sum(q_bytes.values())} "
              f"{q_bytes} vs fp32 {sum(f_bytes.values())} {f_bytes} = "
              f"{sum(q_bytes.values()) / sum(f_bytes.values()):.4f}")
        if n_flash != cfg.n_layers or max(g[0] for g in gaps.values()) > 1 \
                or not max(scale.values()) <= 1:
            raise AssertionError("int8 prefill: not one flash launch a "
                                 "layer, or an int off by more than 1 or a "
                                 "scale over the limit against plain")
        got, q_ms, q_peak = _decode_probs(quant, params, cq, plen, fed)
        broken = {"attn": {n: torch.roll(t, 1, dims=3) if n in ("k", "v")
                           else t for n, t in cq["attn"].items()}}
        del cq
        bad = _decode_probs(quant, params, broken, plen, fed)[0]
        del broken
        errs = [(a - b).abs().max().item() for a, b in zip(got, want)]
        berrs = [(a - b).abs().max().item() for a, b in zip(bad, want)]
        del got, bad, want
        print(f"    {n_new} decode steps on the fp32 run's greedy tokens: "
              f"max |softmax int8 - softmax fp32| a step "
              f"{[float(f'{e:.3g}') for e in errs]} (limit "
              f"{INT8_SOFTMAX_LIMIT}); broken control (ints rolled by one "
              f"kv head): largest {max(berrs):.3g}; decode step fp32 "
              f"{f_ms:.2f} ms, int8 {q_ms:.2f} ms; peak memory over the "
              f"decode fp32 {f_peak} B, int8 {q_peak} B | on {smi}")
        if not max(errs) < INT8_SOFTMAX_LIMIT:
            raise AssertionError("the int8 cache's softmax left the limit")
        if not max(berrs) > INT8_SOFTMAX_LIMIT:
            raise AssertionError("the broken int8 control met the limit")


def launch_train(n_params, smi):
    """Phase 7b: ``launch.train.main`` at full-width qwen3_4b (AdamW, remat
    dots, 8 x 64 tokens a step, the data vocabulary cut to 4096) for 16
    steps on a SQLite log in a temporary directory; its step time and
    peak memory beside the predicted peak, and the step-8 checkpoint's
    save seconds and bytes beside the free disk; the run must reach
    16/16 with finite losses, list the step-8 checkpoint and print the
    data-vocab line, and a second ``SqliteBus`` on the file must see the
    agent's tail and committed intents. No kernel may launch."""
    import torch
    from repro_torch.core import PayloadType, SqliteBus, trace_intents
    from repro_torch.launch import train
    steps = int(TRAIN_ARGV[TRAIN_ARGV.index("--steps") + 1])
    print(f"  predicted peak: 16 B x {n_params} params (fp32 params, grads, "
          f"AdamW m and v) = {16 * n_params} B, plus a few GB of remat "
          f"dots' saved matmul outputs and the optimizer's temporaries; "
          f"checkpoint 12 B x {n_params} = {12 * n_params} B (params, m, v)")
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    log = {}
    out = io.StringIO()
    build = train.build_env

    def timed_env(*args, **kw):
        env = build(*args, **kw)
        env.train_step = _timed(env.train_step, log, "step")
        env.ckpts.save = _timed(env.ckpts.save, log, "save")
        return env
    with tempfile.TemporaryDirectory(prefix="chip-smoke-launch-") as root, \
            mock.patch.object(train, "build_env", timed_env):
        argv = TRAIN_ARGV + ["--workdir", root]
        print(f"  launch.train.main({argv}); free disk under {root} "
              f"{shutil.disk_usage(root).free} B, host memory available "
              f"{_mem_available()} B:")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                agent = train.main(argv)
        finally:
            print(out.getvalue(), end="")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        env, bus = agent.executor.env, agent.bus
        ckpts = env.ckpts.list_steps()
        ckpt_bytes = sum(
            os.path.getsize(os.path.join(env.ckpts._dir(c), "state.npz"))
            for c in ckpts)
        trace = trace_intents(bus.read(0))
        losses = [x for t in trace if t.kind == "train_chunk" and t.result
                  and t.result["ok"] for x in t.result["value"]["losses"]]
        evals = [t.result["value"]["eval_loss"] for t in trace
                 if t.kind == "eval" and t.result and t.result["ok"]]

        def committed(b):
            return [e.body["intent_id"] for e in b.read(0)
                    if e.type == PayloadType.COMMIT]
        reader = SqliteBus(os.path.join(root, "bus.db"))
        try:
            seen = (reader.tail(), committed(reader))
        finally:
            reader.close()
        mine = (bus.tail(), committed(bus))
        bus.close()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    step_s = log["step"][1:]
    step_ms = 1e3 * sum(step_s) / len(step_s)
    save_s = log.get("save", [])
    tokens = 8 * 64  # the launcher's default global batch x seq len
    print(f"    intents {[t.kind for t in trace]}; env.step {env.step}; "
          f"losses {losses}; eval {evals}; a second SqliteBus on the file "
          f"sees tail {seen[0]} and {len(seen[1])} commits, the agent's "
          f"bus {mine[0]} and {len(mine[1])}; kernel launches {launches}")
    print(f"    step time {step_ms:.2f} ms (mean of steps 2-{steps}; step 1 "
          f"{1e3 * log['step'][0]:.2f} ms) = {tokens * 1e3 / step_ms:.2f} "
          f"training tokens/s; checkpoints {ckpts}: {ckpt_bytes} B saved "
          f"in {' + '.join(f'{x:.2f}' for x in save_s)} s (params and "
          f"AdamW state to host, npz, SHA-256); wall {wall:.2f} s "
          f"(parameters drawn); peak memory {peak} B | on {smi}")
    if env.step != steps or len(losses) != steps \
            or not all(map(math.isfinite, losses + evals)) \
            or f"data vocab cut to {train.DATA_VOCAB} from " \
            f"{env.model.cfg.vocab}" not in out.getvalue():
        raise AssertionError(f"the launcher's training run did not reach "
                             f"{steps}/{steps} with finite losses and the "
                             f"data-vocab line")
    if ckpts != TRAIN_CKPTS or len(save_s) != len(TRAIN_CKPTS):
        raise AssertionError(f"the launcher's training run listed "
                             f"checkpoints {ckpts}, not {TRAIN_CKPTS}")
    if seen != mine or not mine[1]:
        raise AssertionError("a second reader of the SQLite log sees "
                             "another tail or other commits")
    if any(launches.values()):
        raise AssertionError("a serving kernel launched during training")


def _mem_available():
    """The host's available memory in bytes (``MemAvailable``), or None
    where ``/proc/meminfo`` does not say."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def run_examples(smi):
    """Phase 7c: the port's three examples on the card at smoke scale,
    each with its own asserts (balance 135; the crash, recovery to step 48
    and a falling loss; 12 requests served by a supervised fleet of three
    static agents); the standby executor's reboot Result must be on the
    training example's log."""
    import torch
    from repro_torch.core import PayloadType
    for name, argv in EXAMPLES:
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        agents = []
        out = io.StringIO()
        t0 = time.perf_counter()
        with mock.patch.object(sys, "argv", [name] + argv), \
                contextlib.redirect_stdout(out):
            spec.loader.exec_module(module)  # the quickstart runs here
            if hasattr(module, "build_training_agent"):
                build = module.build_training_agent

                def recorded(*args, **kw):
                    agents.append(build(*args, **kw))
                    return agents[-1]
                module.build_training_agent = recorded
            if hasattr(module, "main"):
                module.main()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lines = out.getvalue().splitlines()
        print(f"  examples/{name}.py {' '.join(argv)}: {len(lines)} lines, "
              f"last {lines[-1]!r}; wall {wall:.2f} s | on {smi}")
        if name == "swarm_serve_torch":
            print("    " + "\n    ".join(lines[:-1]))
        if agents:
            reboots = [e.body["executor_id"] for e in agents[0].bus.read(0)
                       if e.type == PayloadType.RESULT
                       and e.body["intent_id"] == "__reboot__"]
            print("    " + "\n    ".join(lines[:2]) + f"\n    reboot "
                  f"Results from {reboots}; {lines[-3]}")
            if len(reboots) != 1 or \
                    not lines[0].startswith("!! executor died at step 27"):
                raise AssertionError("the training example did not crash at "
                                     "step 27 and reboot its standby once")


def slice_entry_points(smi):
    """Phase 10: slice 7, the entry points and the int8 KV cache at full
    width. Returns the launchers' kernel launches."""
    import torch
    print(f"[slice 7] the launchers, the examples and the int8 KV cache on "
          f"{smi}")
    t0 = time.perf_counter()
    q_launches, cfg, params = launch_serve(
        "qwen3_4b", {"flash_attention": 36}, smi)
    n_params = sum(p.numel() for p in _leaves(params))
    int8_cache(cfg, params, smi)
    del params
    torch.cuda.empty_cache()
    m_launches, _, params = launch_serve(
        "mamba2_780m", {"ssd_intra": 48}, smi)
    del params
    torch.cuda.empty_cache()
    launch_train(n_params, smi)
    torch.cuda.empty_cache()
    run_examples(smi)
    print(f"  slice 7 wall {time.perf_counter() - t0:.2f} s | on {smi}")
    return {"flash_attention": q_launches["flash_attention"],
            "ssd_intra": m_launches["ssd_intra"]}


# ---------------------------------------------------------------------------
# slice 8: the dry-run on the H100
# ---------------------------------------------------------------------------

def _alloc_stat(key):
    """One of the caching allocator's counters; an allocator that has not
    yet allocated reports none, which is 0."""
    import torch
    return torch.cuda.memory_stats().get(key, 0)


def dryrun_sweep():
    """8a: every (arch x shape) cell traced on the meta device at full
    depth (``launch.dryrun.main(["--all"])``), then every decode cell of a
    family with attention caches again with the int8 cache. Nothing may
    be allocated on the card. Returns the records by (arch, shape,
    kv_quant)."""
    import torch
    from repro_torch.configs.base import SHAPES, get_config
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    # the allocator's running count of allocations (frees of earlier
    # slices' tensors, collected meanwhile, do not move it)
    before = _alloc_stat("allocation.all.allocated")
    held = torch.cuda.memory_allocated()
    cells = dryrun.main(["--all"])
    records = {(a, s, False): c for (a, s), c in cells.items()}
    n_ok = sum(c["status"] == "ok" for c in cells.values())
    n_skip = sum(c["status"] == "skipped" for c in cells.values())
    if (len(cells), n_ok, n_skip) != DRYRUN_CELLS:
        raise AssertionError(f"dry-run: {len(cells)} cells, {n_ok} ok, "
                             f"{n_skip} skipped; want {DRYRUN_CELLS}")
    for (arch, shape), cell in cells.items():
        if cell["status"] == "ok" and SHAPES[shape].kind == "decode" \
                and get_config(arch).family != "ssm":
            rec = dryrun.run_cell(arch, shape, kv_quant=True,
                                  extra_tag="int8")
            if rec["status"] != "ok":
                raise AssertionError(f"dry-run {arch} {shape} int8: "
                                     f"{rec.get('error')}")
            records[arch, shape, True] = rec
    n_alloc = _alloc_stat("allocation.all.allocated") - before
    if n_alloc:
        raise AssertionError(f"the dry-run allocated on the card {n_alloc} "
                             f"times")
    wall = time.perf_counter() - t0
    print(f"  8a: {n_ok} ok + {len(records) - len(cells)} int8 decode "
          f"cells, {n_skip} skipped, 0 errors; sweep wall {wall:.2f} s "
          f"(host; no allocation on the card; memory_allocated moved "
          f"{torch.cuda.memory_allocated() - held} B meanwhile, by frees "
          f"alone)")
    return records


def _build_decode_cell(arch, shape, kv_quant):
    """A decode cell's arguments built for real on the card at full width:
    the parameters (seeded), the empty cache and the tokens, with what the
    caching allocator counted for them: ``requested`` (the bytes asked
    for) and ``allocated`` (its blocks) over what it held ``before``, and
    how many tensors were allocated."""
    import torch
    from repro_torch.configs.base import SHAPES, get_config
    from repro_torch.models.model import Model
    from repro_torch.models.params import init_params
    cfg, sh = get_config(arch), SHAPES[shape]
    model = Model(cfg, kv_quant=kv_quant)
    torch.cuda.synchronize()
    alloc0 = torch.cuda.memory_allocated()
    req0 = _alloc_stat("requested_bytes.all.current")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_params(cfg, g, "cuda")
    cache = model.init_cache(sh.global_batch, sh.seq_len)
    tokens = torch.randint(0, cfg.vocab, (sh.global_batch, 1),
                           dtype=torch.int32, device="cuda", generator=g)
    torch.cuda.synchronize()
    leaves = list(_leaves(params)) + list(_leaves(cache)) + [tokens]
    return {"model": model, "params": params, "cache": cache,
            "tokens": tokens, "before": alloc0,
            "allocated": torch.cuda.memory_allocated() - alloc0,
            "requested": _alloc_stat("requested_bytes.all.current") - req0,
            "tensors": len(leaves)}


def _held_bytes(built, rec):
    """The bytes requested on the card against the record's
    ``argument_bytes``, within ALLOC_ROUND a tensor. Returns (the gap,
    within)."""
    gap = built["requested"] - rec["argument_bytes"]
    return gap, 0 <= gap <= built["tensors"] * ALLOC_ROUND


def decode_cell_on_card(rec, fp32_rec, smi):
    """8b for one cell: build it, hold the bytes, run one decode step at
    the last position its cache holds, hold the outputs' shapes to the
    meta trace's, time it against the roofline."""
    import torch
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.dryrun import tree_specs
    arch, shape, q = rec["arch"], rec["shape"], rec["kv_quant"]
    label = f"{arch} {shape}{' int8' if q else ''}"
    built = _build_decode_cell(arch, shape, q)
    model, params, cache, tokens = (built[k] for k in ("model", "params",
                                                       "cache", "tokens"))
    gap, ok = _held_bytes(built, rec)
    print(f"  8b {label}: {built['tensors']} tensors requested "
          f"{built['requested']} B against argument_bytes "
          f"{rec['argument_bytes']} B: gap {gap} B (limit "
          f"{built['tensors'] * ALLOC_ROUND} B); the allocator's blocks "
          f"{built['allocated']} B (not held)")
    if not ok:
        raise AssertionError(f"{label}: the card holds {built['requested']}"
                             f" B requested; the meta reckoning "
                             f"{rec['argument_bytes']} B")
    if fp32_rec is not None:  # broken control: the fp32 record
        cgap, cok = _held_bytes(built, fp32_rec)
        print(f"    control: the same allocation against the fp32 record's "
              f"{fp32_rec['argument_bytes']} B: gap {cgap} B, within the "
              f"limit {cok}")
        if cok:
            raise AssertionError("the fp32 record passed the int8 check")
    cur = SHAPES[shape].seq_len - 1
    torch.cuda.reset_peak_memory_stats()
    logits, new_cache = model.decode_step(params, cache, tokens, cur)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - built["before"]
    want = rec["output_shapes"]
    got = tree_specs({"logits": logits, "cache": new_cache})
    if got != want:
        raise AssertionError(f"{label}: outputs {got} vs the meta trace's "
                             f"{want}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{label}: non-finite logits")
    del logits, new_cache
    times = []
    for _ in range(DECODE_WARMUP + DECODE_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.decode_step(params, cache, tokens, cur)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del out
    step = sorted(times[DECODE_WARMUP:])[DECODE_TIMED // 2]
    rl = rec["roofline"]
    # a decode step reads every argument at least once: a true lower bound,
    # where the analytic roofline counts K/V and conv state at bf16
    read_s = rec["argument_bytes"] / HBM_BW
    print(f"    decode step at cur {cur}: logits {want['logits'][0]} finite,"
          f" every cache leaf's shape and dtype as traced | the cell's peak "
          f"{peak} B, {peak - rec['argument_bytes']} B over argument_bytes"
          f" | step {step * 1e3:.3f} ms (median of "
          f"{DECODE_TIMED} after {DECODE_WARMUP}; all "
          f"{', '.join(f'{t * 1e3:.3f}' for t in times)}) | roofline "
          f"{rl['step_time_s'] * 1e3:.4f} ms ({rl['bottleneck']}) = "
          f"{100 * rl['step_time_s'] / step:.2f}% of the step (its cache "
          f"term is analytic.cache_bytes: bf16 K/V and conv state) | "
          f"argument_bytes / HBM_BW {read_s * 1e3:.4f} ms = "
          f"{100 * read_s / step:.2f}% of the step | on {smi}")
    del params, cache, tokens, built


def slice_dryrun(smi):
    """Phase 11: slice 8, the dry-run (8a) and the decode cells whose
    arguments fit half the card, built for real on it (8b). No kernel
    launches: the decode steps run the plain attention."""
    import torch
    from repro_torch.configs.base import SHAPES
    print(f"[slice 8] the dry-run on {smi}")
    t0 = time.perf_counter()
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    records = dryrun_sweep()
    # half the card: a decode step copies its cache (cache_update)
    on_card = [k for k, r in records.items()
               if r["status"] == "ok" and SHAPES[r["shape"]].kind == "decode"
               and r["argument_bytes"] <= ON_CARD_BYTES]
    print(f"  8b: the decode cells with argument_bytes <= "
          f"{ON_CARD_BYTES / 1e9:.0f} GB: "
          + ", ".join(f"{a} {s}{' int8' if q else ''} "
                      f"({records[a, s, q]['argument_bytes'] / 1e9:.2f} GB)"
                      for a, s, q in on_card))
    if not on_card:
        raise AssertionError("no decode cell fits half the card")
    for a, s, q in on_card:
        decode_cell_on_card(records[a, s, q],
                            records[a, s, False] if q else None, smi)
        torch.cuda.empty_cache()
    if not any(q for _, _, q in on_card):
        raise AssertionError("no int8 cell for the broken control")
    launches = {name: fn.launches for name, fn in wrappers.items()}
    if any(launches.values()):
        raise AssertionError(f"a kernel launched in slice 8: {launches}")
    print(f"  slice 8 wall {time.perf_counter() - t0:.2f} s | kernel "
          f"launches {launches} | on {smi}")


# ---------------------------------------------------------------------------
# slice 9: the agent kernel, its serving-continuous image and the supervisor
# ---------------------------------------------------------------------------

def _same_outputs(label, got, want):
    diff = sorted(r for r in set(got) | set(want)
                  if got.get(r) != want.get(r))
    if diff:
        raise AssertionError(f"{label}: tokens differ from slice 1's for "
                             f"{diff}")


def _check_launches(label, run, cfg):
    want = run["engine"].n_steps * cfg.n_layers
    if run["launches"] != want or want == 0:
        raise AssertionError(f"{label}: {run['launches']} paged launches, "
                             f"want {run['engine'].n_steps} decode steps x "
                             f"{cfg.n_layers} layers = {want}")


def agent_kernel_trim(smi, paged, tmp):
    """9a: one agent spawned by the kernel on SQLite, threaded, under a
    TrimPolicy, with a reader thread following the tail; the host loop
    calls ``maintain`` until the planner has every request. Returns the
    paged launches."""
    from repro_torch.core import (AgentKernel, SqliteBus, TrimmedError,
                                  TrimPolicy, committed_unexecuted)
    cfg, params = paged["cfg"], paged["params"]
    requests = paged["requests"]
    kernel = AgentKernel(workdir=tmp)
    policy = TrimPolicy(checkpoint_every=TRIM_EVERY,
                        retain_entries=TRIM_RETAIN, keep_snapshots=2)
    h = kernel.create_bus("serve", mode="spawn", backend="sqlite",
                          image="serving-continuous", image_kw=SPAWN_IMAGE_KW,
                          trim_policy=policy)
    seen, reader_errors, pauses = [], [], []
    stop = threading.Event()

    def reader():
        cur = h.bus.trim_base()
        while True:
            last = stop.is_set()
            try:
                es = h.bus.read(cur)
            except TrimmedError as exc:
                reader_errors.append(exc)
                cur = h.bus.trim_base()
                continue
            seen.extend(es)
            cur = es[-1].position + 1 if es else cur
            if last:
                return
            time.sleep(0.005)

    def drive(agent):
        planner = agent.driver.planner
        rt = threading.Thread(target=reader, daemon=True)
        rt.start()
        try:
            agent.start()
            deadline = time.monotonic() + SLICE9_DEADLINE_S
            while len(planner.outputs) + len(planner.rejected) \
                    < len(requests):
                if time.monotonic() > deadline:
                    raise AssertionError(
                        f"9a: the planner has {len(planner.outputs)} "
                        f"outputs and {len(planner.rejected)} rejections "
                        f"of {len(requests)} requests after "
                        f"{SLICE9_DEADLINE_S} s")
                t0 = time.perf_counter()
                out = kernel.maintain("serve")
                if out["maintained"]:
                    pauses.append((time.perf_counter() - t0, out))
                time.sleep(0.01)
            if not agent.wait_idle(timeout=SLICE9_DEADLINE_S):
                raise AssertionError("9a: the agent did not go idle")
            t0 = time.perf_counter()
            out = kernel.maintain("serve", force=True)
            pauses.append((time.perf_counter() - t0, out))
            if not agent.wait_idle(timeout=SLICE9_DEADLINE_S):
                raise AssertionError("9a: the agent did not go idle after "
                                     "the last maintain")
            agent.stop()
        finally:
            stop.set()
            rt.join(timeout=SLICE9_DEADLINE_S)
        if rt.is_alive():
            raise AssertionError("9a: the reader thread did not stop")
        return seen

    try:
        run = serve(cfg, params, requests, use_kernel=True, agent=h.agent,
                    run=drive)
        pl = run["planner"]
        _same_outputs("9a", pl.outputs, paged["outputs"])
        if pl.rejected != paged["blocked"]:
            raise AssertionError(f"9a: rejected {pl.rejected}, want "
                                 f"{paged['blocked']}")
        _check_launches("9a", run, cfg)
        if run["launches"] != paged["launches"]:
            raise AssertionError(f"9a: {run['launches']} paged launches, "
                                 f"slice 1's runs {paged['launches']}")
        if reader_errors:
            raise AssertionError(f"9a: the reader fell behind a trim: "
                                 f"{reader_errors}")
        tail = h.bus.tail()
        if [e.position for e in seen] != list(range(tail)):
            raise AssertionError("9a: the reader did not see every entry "
                                 "once, in order")
        base = h.bus.trim_base()
        if base <= 0 or not any(o["trim_base"] > 0 for _, o in pauses[:-1]):
            raise AssertionError(f"9a: no maintain trimmed mid-run "
                                 f"({[o['trim_base'] for _, o in pauses]})")
        live = [_unsched(_row(e)) for e in h.bus.read(base)]
        path = os.path.join(tmp, "buses", "serve.db")
        fresh = SqliteBus(path)
        try:
            if fresh.trim_base() != base or [
                    _unsched(_row(e)) for e in fresh.read(base)] != live:
                raise AssertionError("9a: a fresh SqliteBus on the file "
                                     "reads other entries from the trim "
                                     "base than the live bus holds")
            if committed_unexecuted(fresh):
                raise AssertionError("9a: a committed-unexecuted intent is "
                                     "left on the log")
            for bus, who in ((h.bus, "the live bus"), (fresh, "a fresh "
                                                       "SqliteBus")):
                try:
                    bus.read(0)
                except TrimmedError:
                    continue
                raise AssertionError(f"9a, broken control: {who} read "
                                     f"position 0 below trim base {base}")
        finally:
            fresh.close()
    finally:
        kernel.shutdown()
    gov_s = run["wall"] - run["model_s"]
    n_tokens = sum(len(t) for t in pl.outputs.values())
    c = run["calls"]
    print(f"  9a: AgentKernel spawn 'serving-continuous' on SQLite, "
          f"threaded, TrimPolicy(checkpoint_every={TRIM_EVERY}, "
          f"retain_entries={TRIM_RETAIN}, keep_snapshots=2), a reader "
          f"thread on the tail: served {sorted(pl.outputs)} rejected "
          f"{pl.rejected}, tokens equal to slice 1's, paged_attention "
          f"launches {run['launches']} (slice 1's {paged['launches']}); "
          f"{tail} entries, the reader saw all {len(seen)} in order with "
          f"no TrimmedError; a fresh SqliteBus reads the {len(live)} "
          f"entries from trim base {base} as the live bus does, no "
          f"committed-unexecuted intent; broken control: read(0) raises "
          f"TrimmedError on both | on {smi}")
    print(f"  9a: {n_tokens} tokens in {run['wall']:.3f} s = "
          f"{n_tokens / run['wall']:.2f} tokens/s end to end (the "
          f"threads' start, the maintains and the stop included); inside "
          f"PagedEngine.admit/step {run['model_s']:.3f} s; governance "
          f"{gov_s:.3f} s = {1e3 * gov_s / run['n_intents']:.3f} ms a "
          f"serve_step intent ({run['n_intents']} intents) beside slice "
          f"1's synchronous SQLite run {paged['gov_ms']['sqlite']:.3f} ms "
          f"(wall {paged['walls']['sqlite']:.3f} s) | on {smi}")
    prev = 0
    for i, (secs, out) in enumerate(pauses):
        force = " (force)" if i == len(pauses) - 1 else ""
        print(f"  9a: maintain {i + 1}{force} at tail {out['tail']}: paused "
              f"the threads {secs:.4f} s, trim base {out['trim_base']} "
              f"({out['trim_base'] - prev} entries trimmed), "
              f"{out['compacted']} compacted, checkpoints "
              f"{out['checkpoints']} | on {smi}")
        prev = out["trim_base"]
    print(f"  9a: calls into the SQLite log, summed over the agent's "
          f"{len(h.components())} threads, the reader and the host "
          f"loop: {c['appends']} appends ({c['entries']} entries), "
          f"{c['reads']} reads, {c['tails']} tail probes, {c['waits']} "
          f"waits; {c['bus_s']:.3f} thread-seconds inside the bus (the "
          f"threads' idle waits included) | on {smi}")
    return run["launches"]


def agent_kernel_fleet(smi, paged):
    """9b: two agents spawned by the kernel on memory buses, slice 1's
    requests split 4 and 4, swept by a Supervisor. Returns the paged
    launches."""
    from repro_torch.core import (AgentKernel, MemorySnapshotStore,
                                  PayloadType, Supervisor)
    cfg, params = paged["cfg"], paged["params"]
    requests = paged["requests"]
    kernel = AgentKernel()
    half = len(requests) // 2
    parts = {"worker-0": requests[:half], "worker-1": requests[half:]}
    runs = {}
    try:
        for name, part in parts.items():
            h = kernel.create_bus(name, mode="spawn",
                                  image="serving-continuous",
                                  image_kw=SPAWN_IMAGE_KW)
            runs[name] = serve(cfg, params, part, use_kernel=True,
                               agent=h.agent)
        sup = Supervisor({n: kernel.get(n).bus for n in parts})
        view = sup.sweep()
        store = MemorySnapshotStore()
        positions = sup.checkpoint(store)
        resumed = Supervisor({n: kernel.get(n).bus
                              for n in parts}).bootstrap(store)
    finally:
        kernel.shutdown()
    if resumed != positions:
        raise AssertionError(f"9b: a second supervisor resumed at "
                             f"{resumed}, the checkpoint is at {positions}")
    outputs, rejected = {}, []
    for name, run in runs.items():
        pl = run["planner"]
        outputs.update(pl.outputs)
        rejected += pl.rejected
        _check_launches(f"9b {name}", run, cfg)
        steps = {e.body["intent_id"] for e in run["log"]
                 if e.type == PayloadType.INTENT
                 and e.body["kind"] == "serve_step"}
        executed = sum(e.type == PayloadType.RESULT and e.body["ok"]
                       and e.body["intent_id"] in steps for e in run["log"])
        done = view["summaries"][name]["n_completed"]
        if done != executed:
            raise AssertionError(f"9b {name}: the supervisor counts {done} "
                                 f"completed intents, the log {executed} "
                                 f"executed serve_step intents")
        health = view["health"][name]
        print(f"  9b {name}: {[r['req_id'] for r in parts[name]]} served "
              f"{sorted(pl.outputs)} rejected {pl.rejected}; paged "
              f"launches {run['launches']} ({run['engine'].n_steps} steps "
              f"x {cfg.n_layers}); wall {run['wall']:.3f} s, inside "
              f"PagedEngine.admit/step {run['model_s']:.3f} s; supervisor: "
              f"{done} completed = {executed} executed serve_step intents,"
              f" health {health['verdict']} {health['reasons']} (a latency "
              f"verdict, printed, not held) | on {smi}")
    _same_outputs("9b", outputs, paged["outputs"])
    if sorted(rejected) != sorted(paged["blocked"]):
        raise AssertionError(f"9b: rejected {rejected}, want "
                             f"{paged['blocked']}")
    print(f"  9b: the fleet's tokens equal slice 1's for all "
          f"{len(outputs)} requests; supervisor mail sent "
          f"{view['mail_sent']}, checkpoint at {positions}, a second "
          f"supervisor's bootstrap resumed at the same positions | on "
          f"{smi}")
    return sum(run["launches"] for run in runs.values())


def slice_agent_kernel(smi, paged):
    """Slice 9: the port's AgentKernel, its serving-continuous image and
    the swarm Supervisor on slice 1's full-width qwen3_4b parameters.
    Returns the paged launches of 9a and 9b."""
    import torch
    print(f"[slice 9] AgentKernel / serving-continuous / Supervisor at "
          f"full qwen3_4b width on slice 1's parameters, on {smi}")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-kernel-") as tmp:
        trim = agent_kernel_trim(smi, paged, tmp)
    torch.cuda.empty_cache()
    fleet = agent_kernel_fleet(smi, paged)
    torch.cuda.empty_cache()
    print(f"  slice 9 wall {time.perf_counter() - t0:.2f} s; paged "
          f"launches {trim} (9a) + {fleet} (9b) | on {smi}")
    return {"9a": trim, "9b": fleet}


# ---------------------------------------------------------------------------
# slice 10: automatic failover (10a runs inside slice 4's crash drill)
# ---------------------------------------------------------------------------

def _bad_node(args, env):
    raise RuntimeError("bad node")


def slice_elastic_pool(smi, paged):
    """10b: an ElasticWorkerPool over the ``serving-continuous`` image at
    full qwen3_4b width on slice 1's parameters. Two workers, slice 1's
    requests split 4 and 4, each run through ``serve``; worker 1's
    executor gets, in a copy of its handler dict, a ``serve_step`` that
    raises. The sweep must replace worker 1 as failing, and the
    replacement serves worker 1's requests. Every paged launch is held to
    its plain version on its own inputs. Returns the paged launches."""
    from repro_torch.core import AgentKernel, ElasticWorkerPool
    from repro_torch.serving import engine as engine_lib
    cfg, params = paged["cfg"], paged["params"]
    requests = paged["requests"]
    print(f"[slice 10] 10b: ElasticWorkerPool over 'serving-continuous' at "
          f"full {cfg.arch_id} width on slice 1's parameters, on {smi}")
    t_slice = time.perf_counter()
    half = len(requests) // 2
    parts = [requests[:half], requests[half:]]
    kernel = AgentKernel()
    pool = ElasticWorkerPool(kernel, "serving-continuous",
                             image_kw_fn=lambda i: dict(SPAWN_IMAGE_KW))
    checks, runs = [], {}
    kernel_fn = engine_lib.paged_attention
    engine_lib.paged_attention = _paged_checker(checks)
    try:
        pool.scale_to(2)
        names = kernel.list_buses()
        if names != ["worker-0-0", "worker-0-1"]:
            raise AssertionError(f"10b: scale_to(2) gave {names}")
        failing = kernel.get("worker-0-1").agent.executor
        failing.handlers = dict(failing.handlers, serve_step=_bad_node)
        if kernel.get("worker-0-0").agent.executor.handlers["serve_step"] \
                is _bad_node:
            raise AssertionError("10b: the healthy worker shares the "
                                 "failing worker's handlers")
        for name, part in zip(names, parts):
            runs[name] = serve(cfg, params, part, use_kernel=True,
                               agent=kernel.get(name).agent)
        t0 = time.perf_counter()
        actions = pool.sweep()
        sweep_s = time.perf_counter() - t0
        repl = pool.replaced.get("worker-0-1")
        print(f"  10b: sweep {actions} in {1e3 * sweep_s:.3f} ms; "
              f"generation {pool.generation}; buses {kernel.list_buses()} "
              f"| on {smi}")
        if repl is None or actions["worker-0-1"] != \
                f"replaced_by:{repl} (failing)":
            raise AssertionError(f"10b: the sweep did not replace the "
                                 f"failing worker: {actions}")
        runs[repl] = serve(cfg, params, parts[1], use_kernel=True,
                           agent=kernel.get(repl).agent)
    finally:
        engine_lib.paged_attention = kernel_fn
        kernel.shutdown()
    outputs, rejected, launches = {}, [], 0
    for (name, run), part in zip(runs.items(), parts + [parts[1]]):
        pl = run["planner"]
        if name == "worker-0-1":
            if pl.outputs or sorted(pl.rejected) != sorted(
                    r["req_id"] for r in part) or run["launches"]:
                raise AssertionError(
                    f"10b: the failing worker served {sorted(pl.outputs)}, "
                    f"rejected {pl.rejected}, launched {run['launches']}")
            fails = sum(e.type.value == "Result" and not e.body["ok"]
                        for e in run["log"])
            print(f"  10b {name} (serve_step raises): "
                  f"{[r['req_id'] for r in part]} served none, rejected "
                  f"{pl.rejected}; {fails} failed Results, 0 paged "
                  f"launches; wall {run['wall']:.3f} s | on {smi}")
            continue
        outputs.update(pl.outputs)
        rejected += pl.rejected
        _check_launches(f"10b {name}", run, cfg)
        launches += run["launches"]
        gov_s = run["wall"] - run["model_s"]
        verdict = actions.get(name, "not swept (the replacement)")
        print(f"  10b {name}: {[r['req_id'] for r in part]} served "
              f"{sorted(pl.outputs)} rejected {pl.rejected}; paged "
              f"launches {run['launches']} ({run['engine'].n_steps} steps "
              f"x {cfg.n_layers}); wall {run['wall']:.3f} s, inside "
              f"PagedEngine.admit/step {run['model_s']:.3f} s, governance "
              f"{gov_s:.3f} s = {1e3 * gov_s / run['n_intents']:.3f} ms a "
              f"serve_step intent ({run['n_intents']} intents); sweep "
              f"verdict {verdict} (a latency verdict, printed, not held) | "
              f"on {smi}")
    _same_outputs("10b", outputs, paged["outputs"])
    if sorted(rejected) != sorted(paged["blocked"]):
        raise AssertionError(f"10b: rejected {rejected}, want "
                             f"{paged['blocked']}")
    if len(checks) != launches:
        raise AssertionError(f"10b: {len(checks)} launches held, "
                             f"{launches} counted")
    _hold_launches("10b paged_attention", checks,
                   "plain with the kv heads rolled")
    print(f"  10b: the pool's tokens equal slice 1's for all {len(outputs)} "
          f"served requests, {rejected} rejected; slice 10b wall "
          f"{time.perf_counter() - t_slice:.2f} s | on {smi}")
    return launches


# ---------------------------------------------------------------------------
# slice 11: the network shared log (11a is slice 1's run on net)
# ---------------------------------------------------------------------------

def slice_netbus(smi, paged):
    """11b and 11c: slice 1's governed kernel run with its log behind a
    ``BusServer`` (``_serve_on_bus`` on ``net``), once with the server
    restarted after the Result of the ceil(n/2)-th of 11a's n serve_step
    intents, once with the reply to the middle one of 11a's appends lost
    (``net.server.reply.drop_append``). Each must give the memory run's
    tokens and paged launches, every batch once (as many entries as
    11a's log, dense), and a reconnect; 11b a new server epoch. Returns
    the paged launches of 11a, 11b and 11c."""
    cfg, params, a = paged["cfg"], paged["params"], paged["net"]
    requests, blocked = paged["requests"], paged["blocked"]
    served = {r["req_id"]: r for r in requests if r["tenant"] != "blocked"}
    after, at_hit = math.ceil(a["n_intents"] / 2), a["appends"] // 2
    print(f"[slice 11] 11b: the server restarted after the Result of "
          f"serve_step intent {after} of {a['n_intents']}; 11c: the reply "
          f"to append {at_hit} of {a['appends']} lost; on {smi}")
    t0 = time.perf_counter()
    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-net-") as tmp:
        for key, name, drill in (
                ("11b", "net-restart", _restart_mid_run(after)),
                ("11c", "net-lost-reply", _lost_append_reply(at_hit))):
            runs[key] = _serve_on_bus(cfg, params, requests, served,
                                      blocked, "net", tmp, smi, name=name,
                                      drill=drill)
    for key, run in runs.items():
        n = run["net"]
        _same_outputs(key, run["planner"].outputs, paged["outputs"])
        if run["launches"] != a["launches"]:
            raise AssertionError(f"{key}: {run['launches']} paged "
                                 f"launches, 11a's run {a['launches']}")
        if n["entries"] != a["entries"]:
            raise AssertionError(f"{key}: the log holds {n['entries']} "
                                 f"entries, 11a's {a['entries']}: a batch "
                                 f"is missing or twice")
        if n["reconnects"] < 1:
            raise AssertionError(f"{key}: the client never reconnected")
    b = runs["11b"]["net"]
    if b["epochs"][0] == b["epochs"][1] or b["client_epoch"] != \
            b["epochs"][1]:
        raise AssertionError(f"11b: epochs {b['epochs']}, the client's "
                             f"{b['client_epoch']}")
    launches = a["launches"] + sum(r["launches"] for r in runs.values())
    print(f"  11b and 11c: slice 1's tokens for all {len(paged['outputs'])} "
          f"served requests and its {a['launches']} paged launches each; "
          f"{a['entries']} entries each, read back dense; reconnects "
          f"{runs['11b']['net']['reconnects']} (11b, a new epoch) and "
          f"{runs['11c']['net']['reconnects']} (11c); walls "
          f"{runs['11b']['wall']:.3f} s and {runs['11c']['wall']:.3f} s; "
          f"slice 11 paged launches {launches}; 11b and 11c took "
          f"{time.perf_counter() - t0:.2f} s | on {smi}")
    return launches


# ---------------------------------------------------------------------------
# slice 12: the components as OS processes (12a is slice 1's run on a
# bus-server process)
# ---------------------------------------------------------------------------

def process_failover(root, procs, core, standby_id=PROC_DRIVER_ID):
    """The process failover drill of the reference's
    ``tests/test_netbus.py:277-342``: a bus-server process over SQLite in
    ``root``, and executor, voters, standby and driver processes. Each
    role is spawned by ``procs[role]``, a package's ``launch.procs``
    (``procs["server"]`` spawns the server); the standby's driver id is
    ``standby_id``. A client of ``core`` (a namespace with a package's
    ``netbus``, ``acl`` and ``entries``) sets the ``first_voter`` policy
    and mails ``go``; once the primary's PROC_KILL_AFTER-th result is on
    the log the driver is SIGKILLed, and the plan must then complete. The
    standby is spawned once the primary's election is on the log (the
    reference's test spawns it just before the driver, so a primary that
    took longer than the standby's quiescence timeout to start would race
    it). Every wait is on the log up to a deadline, and every child is
    killed and waited for on the way out. Returns the record
    (``process_failover_want`` is what the reference's test asserts of it)
    and the seconds from the kill to the last driver election and from
    there to the ``done`` InfOut, on the server's clock."""
    E, T = core.entries, core.entries.PayloadType
    spec = {"driver_id": PROC_DRIVER_ID,
            "plans": procs["driver"].incr_plans(PROC_STEPS,
                                                work_s=PROC_WORK_S),
            "snapshot_dir": os.path.join(root, "snaps"),
            "takeover_after_s": PROC_TAKEOVER_S}
    children, cli = {}, None
    with procs["server"].BusServerProcess(
            "sqlite", os.path.join(root, "bus.db"), root) as srv:
        try:
            address = srv.address

            def spawn(role, role_spec):
                children[role] = procs[role].spawn_component(role, address,
                                                             role_spec)
            spawn("executor", {})
            spawn("voters", {})
            spawn("driver", spec)
            cli = core.netbus.NetBus(address, client_id="drill-cli")
            admin = core.acl.BusClient(cli, "admin", "admin")
            admin.append(E.policy("decider", {"mode": "first_voter"}))
            admin.append(E.mail("go"))

            def elections():
                return [e for e in cli.read(0, types=(T.POLICY,))
                        if e.body.get("scope") == "driver"]

            def results():
                return [e for e in cli.read(0, types=(T.RESULT,))
                        if not e.body.get("recovered")]

            def done():
                return [e for e in cli.read(0, types=(T.INF_OUT,))
                        if e.body["plan"].get("done")]

            def until(ready, deadline_s, what):
                deadline = time.monotonic() + deadline_s
                while not ready():
                    if time.monotonic() > deadline:
                        raise AssertionError(f"{what} in {deadline_s} s: "
                                             f"{len(results())} results")
                    cli.wait(cli.tail(), timeout=1.0)

            until(elections, PROC_DEADLINES_S[0], "the primary driver did "
                  "not elect itself")
            spawn("standby", dict(spec, driver_id=standby_id))
            until(lambda: len(results()) >= PROC_KILL_AFTER,
                  PROC_DEADLINES_S[0], "the primary driver made too few "
                  "results")
            killed_at = time.time()
            procs["driver"].sigkill(children["driver"])
            until(lambda: done() and len(results()) >= PROC_STEPS,
                  PROC_DEADLINES_S[1], "the plan did not complete after "
                  "the kill")
            infouts = cli.read(0, types=(T.INF_OUT,))
            elected = elections()
            epochs = [e.body["policy"]["epoch"] for e in elected]
            res = results()
            rec = {"infouts": len(infouts),
                   "intent ids": [e.body["intent_id"] for e in cli.read(
                       0, types=(T.INTENT,))],
                   "results": len(res),
                   "all ok": all(e.body["ok"] for e in res),
                   "values": sorted(e.body["value"]["value"] for e in res),
                   "elected": [e.body["policy"]["elect"]
                               for e in elected],
                   "epoch steps": [b - a for a, b in zip(epochs,
                                                         epochs[1:])]}
            t_elect, t_done = elected[-1].realtime_ts, done()[0].realtime_ts
        finally:
            if cli is not None:
                cli.close()
            for role, p in children.items():
                procs[role].sigkill(p)
    return rec, {"kill_to_election_s": t_elect - killed_at,
                 "election_to_done_s": t_done - t_elect}


def process_failover_want():
    """What the reference's test asserts of ``process_failover``'s record:
    one InfOut a step and one for ``done`` across both driver incarnations
    (the replay was silent), the lineage's intent ids with no gap or
    duplicate, every step executed once and ok, two elections of the one
    lineage at epochs one apart."""
    return {"infouts": PROC_STEPS + 1,
            "intent ids": [f"{PROC_DRIVER_ID}-i{i}"
                           for i in range(PROC_STEPS)],
            "results": PROC_STEPS, "all ok": True,
            "values": list(range(1, PROC_STEPS + 1)),
            "elected": [PROC_DRIVER_ID] * 2, "epoch steps": [1]}


def slice_procs(smi, paged):
    """Slice 12 on slice 1's parameters. 12a: slice 1's governed kernel run
    with its log on a bus-server process (``_serve_on_bus`` on ``proc``);
    12b: the same run with that process SIGKILLed after the Result of the
    ceil(n/2)-th of 11a's n serve_step intents and a successor started on
    the same file and port through the CLI. Each must give the memory
    run's tokens and paged launches, every launch held to its plain
    version (``_paged_checker``), and a read-back (by a fresh ``SqliteBus``
    once the server processes are gone) of as many entries as 11a's log,
    dense, with no ``_sched`` flag in the agent's view; 12b a reconnect
    and a new server epoch. 12c: the process failover drill with the
    port's ``procs`` for every role. Returns the paged launches of 12a and
    12b."""
    from types import SimpleNamespace
    from repro_torch.core import acl, entries, netbus
    from repro_torch.launch import procs
    from repro_torch.serving import engine as engine_lib
    cfg, params, a = paged["cfg"], paged["params"], paged["net"]
    requests, blocked = paged["requests"], paged["blocked"]
    served = {r["req_id"]: r for r in requests if r["tenant"] != "blocked"}
    after = math.ceil(a["n_intents"] / 2)
    print(f"[slice 12] 12a: slice 1's governed kernel run with its log on "
          f"a bus-server process (repro_torch.launch.procs."
          f"BusServerProcess over SQLite); 12b: that process SIGKILLed "
          f"after the Result of serve_step intent {after} of "
          f"{a['n_intents']}, a successor started through the CLI on the "
          f"same file and port; on {smi}")
    t0 = time.perf_counter()
    runs, checks = {}, {}
    kernel_fn = engine_lib.paged_attention
    try:
        with tempfile.TemporaryDirectory(prefix="chip-smoke-proc-") as tmp:
            for key, name, drill in (
                    ("12a", "proc", None),
                    ("12b", "proc-sigkill", _restart_mid_run(after, "12b"))):
                checks[key] = []
                engine_lib.paged_attention = _paged_checker(checks[key])
                runs[key] = _serve_on_bus(cfg, params, requests, served,
                                          blocked, "proc", tmp, smi,
                                          name=name, drill=drill)
    finally:
        engine_lib.paged_attention = kernel_fn
    for key, run in runs.items():
        n = run["net"]
        _same_outputs(key, run["planner"].outputs, paged["outputs"])
        if run["launches"] != a["launches"] or len(checks[key]) != \
                run["launches"]:
            raise AssertionError(f"{key}: {run['launches']} paged launches "
                                 f"({len(checks[key])} held), 11a's run "
                                 f"{a['launches']}")
        if n["entries"] != a["entries"] or n["flagged"] != 0:
            raise AssertionError(f"{key}: the log holds {n['entries']} "
                                 f"entries, 11a's {a['entries']}, and the "
                                 f"agent's view {n['flagged']} _sched "
                                 f"flags: a batch is missing or twice")
        _hold_launches(f"{key} paged_attention", checks[key],
                       "plain with the kv heads rolled")
    if runs["12a"]["net"]["reconnects"] != 0:
        raise AssertionError("12a: the client reconnected")
    b = runs["12b"]["net"]
    if b["reconnects"] < 1 or b["client_epoch"] == b["epochs"][0]:
        raise AssertionError(f"12b: {b['reconnects']} reconnects, the "
                             f"client's epoch {b['client_epoch']} after "
                             f"{b['epochs'][0]}")
    gov = {k: 1e3 * (r["wall"] - r["model_s"]) / r["n_intents"]
           for k, r in runs.items()}
    launches = sum(r["launches"] for r in runs.values())
    print(f"  12a and 12b: slice 1's tokens for all "
          f"{len(paged['outputs'])} served requests and its "
          f"{a['launches']} paged launches each, every launch held to "
          f"plain; {a['entries']} entries each read back dense after the "
          f"server processes were gone, 0 _sched flags; governance "
          f"{gov['12a']:.3f} ms a serve_step intent on the server process "
          f"beside 11a's in-process server's {paged['gov_ms']['net']:.3f} "
          f"ms, SQLite's {paged['gov_ms']['sqlite']:.3f} ms and memory's "
          f"{paged['gov_ms']['memory']:.3f} ms in this call (12b "
          f"{gov['12b']:.3f} ms); 12b: SIGKILL to successor bound "
          f"{1e3 * b['restart_s']:.3f} ms, to the first append acknowledged "
          f"over a new connection {1e3 * b['reconnect_s']:.3f} ms, "
          f"{b['reconnects']} reconnect, epochs {b['epochs'][0][:8]} -> "
          f"{b['client_epoch'][:8]}; walls {runs['12a']['wall']:.3f} s and "
          f"{runs['12b']['wall']:.3f} s | on {smi}")

    role = {r: procs for r in ("server", "executor", "voters", "standby",
                               "driver")}
    t_drill = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-drill-") as tmp:
        rec, times = process_failover(tmp, role, SimpleNamespace(
            acl=acl, entries=entries, netbus=netbus))
    if rec != process_failover_want():
        raise AssertionError(f"12c: the drill's record {rec}, want "
                             f"{process_failover_want()}")
    print(f"  12c: the process failover drill (bus server, executor, "
          f"voters, standby and driver as processes of the port's "
          f"launch.procs; the driver SIGKILLed after {PROC_KILL_AFTER} "
          f"results): {rec['infouts']} InfOuts, intent ids "
          f"{rec['intent ids'][0]}..{rec['intent ids'][-1]}, results "
          f"{rec['values']} each once, elections {rec['elected']} at "
          f"epochs one apart; SIGKILL to the standby's election "
          f"{times['kill_to_election_s']:.3f} s (its quiescence timeout "
          f"{PROC_TAKEOVER_S} s), election to the done InfOut "
          f"{times['election_to_done_s']:.3f} s; drill "
          f"{time.perf_counter() - t_drill:.2f} s | on {smi}")
    print(f"  slice 12 paged launches {launches}; slice 12 took "
          f"{time.perf_counter() - t0:.2f} s | on {smi}")
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    main()
