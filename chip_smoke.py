"""Smoke run of the PyTorch port (paddle_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--parent DIR]

``--parent DIR``: DIR is another checkout of the repository (a ``git
archive`` of the parent commit, say). Its decode-attention and rope
kernels are built alone and timed beside this tree's on the same inputs
in the same run (``parent_ms`` on their case lines). Without it, as the
smoke run is made, nothing else is built.

1. Prints the card (``nvidia-smi`` name and power limit) and the versions.
2. Builds the CUDA kernels from ``paddle_tpu_torch/csrc`` (one ``nvcc``
   per source, all started together, then one link) and prints the build
   seconds, and each flash kernel's registers, spills and shared memory
   (``-Xptxas -v`` in the build log, and the dynamic shared memory the
   launch asks for).
3. Kernel phase: each kernel against its plain PyTorch version at the
   serving and training paths' shapes (the UNet's GroupNorms and D-80
   flash attention, the Llama's rope among them), with times from CUDA
   events
   (kernel, plain version, and one PyTorch library call as a yardstick
   the port never makes) beside the least time the card could take.
   Microsecond kernels are timed as a CUDA graph of 100-200 calls (host
   enqueue excluded; the eager per-call wall time is printed beside as
   ``eager_ms``), over enough input copies to overflow the 50 MB L2, as
   the decode step finds them. The flash-attention kernels run for
   milliseconds and are timed in a host loop. A library backward (SDPA's,
   ``F.rms_norm``'s) counts the device time of its kernels under
   ``torch.profiler``, without the autograd engine's host cost.
   The int8 matmul, the RMSNorm backward, the GroupNorm and the
   decode-attention kernels must also repeat bit for bit over two runs on
   the same inputs (each decode-attention line names ``split``, the
   blocks of the cluster that share a cache row, from ``split_for``).
   Besides six GroupNorm cases with the plain version timed, each of the
   17 distinct (channels, HW, act) GroupNorm shapes of a bench_unet step
   (B 8, 32 groups, bf16) is checked and timed with the route it takes, and one
   line sums kernel, torch and bound ms over the step's 61 calls.
   Tolerances, per element: f32 |err| <= 1e-4 (outputs are O(1)); bf16
   |err| <= two bf16 spacings of the element's |ref|, floored at those of
   1e-3 of its row's largest |ref|. Kernel and plain version each round
   one f32 result of reassociated sums to bf16, so they differ by one
   spacing at most. bf16 flash attention rounds p (and ds) to bf16 per
   tile of keys against a running maximum where the plain version rounds
   them over the whole row, so its tolerance adds 2^-7 of the |terms|
   those roundings scale (``flash_bounds``); two backward runs must give
   dq within the bf16 tolerance of each other (its f32 sums land in
   another order each run). f32 GroupNorm dw and db are held at 1e-4 of
   their largest |ref|; the shifted 1000 +- 0.01 GroupNorm case must also be
   finite and no further from the f64 truth than the plain version.
   The RMSNorm forward's inv is held to the plain inv at the f32
   tolerance and its output to the plain output formed from the kernel's
   own inv (``rms_fwd_check``): the plain version rounds twice, so an inv
   one ulp off moves the output by up to about three spacings of the
   plain version's own output, whose ratio is printed beside.
   The threefry kernel (the sampler's counter hashing) must equal its
   plain version bit for bit at 8 keys x 32000 counters (one draw of a
   served sampling step) and 1 key x 2^20, and split and fold_in of the
   sampled line's 16 row keys on the card must equal the CPU's.
4. Serving phase: the GQA Llama of bench.py's decode-quant config (vocab
   32000, hidden 768, intermediate 2048, 12 layers, 12 heads, 4 KV heads,
   bf16, random weights from a seeded generator) behind ``ServingEngine``
   (8 slots, chunk 16, max_len 256) answering 16 mixed requests, once
   unquantized and once with ``quant="int8wk"``, admitting through the
   device admission ring, each chunk a replay of its CUDA graph and each
   prompt bucket's admission prefill a replay of its own (a key's first
   call eager, its second captured). Checks every request's length
   against its budget and eos, finite logits, the dispatch identity, one
   captured chunk graph, at most one captured prefill graph per bucket,
   the ring's accounting (16 rows staged and spliced, none host-
   scattered), the kernel launch counts the path implies, and
   teacher-forced top-1 agreement >= 0.99 between the
   served tokens and a plain re-score wherever the re-score's top-1 leads
   by more than 2 bf16 spacings of the logits (and every served token
   within 4 spacings of the re-score's best elsewhere). The requests are
   served again (timed), and again under ``torch.profiler``; then by an
   engine whose decoder runs its chunks eagerly (``eager_chunks``), timed
   and profiled: every drain must give the same tokens request by
   request, and the eager route the same launch counts. Each line prints
   both routes' tokens/s, ms a chunk and device busy share, with the
   costliest kernels and the int8 and decode-attention kernels' ms.
   Then the sampled line: the same 16 requests, unquantized, through
   ``ServingEngine(do_sample=True, top_k=50, top_p=0.9)`` with seeds
   1000 + j and temperatures 0.7-1.0 (request 0: 1e-4): lengths,
   dispatch identity, one captured chunk, the ring, two threefry
   launches a decode step; every sampled token inside the re-score's top
   50 or within 4 bf16 spacings of its 50th logit; request 0 equal to the
   greedy tokens up to a first difference where the re-score's top two
   logits are exactly equal (the gap is printed); the same tokens served
   again, under the profiler and by the eager-chunk engine. One more
   drain copies, before each chunk, the card's carry logits, keys and
   temperatures of the rows the chunk does not splice in, and redraws
   each such row's first token on the CPU from plain versions (threefry
   in int64, the uniform's mantissa trick, gumbel, the temperature /
   top-k / top-p filter): the served token must be the redraw's, or a
   near tie of it (within 4 f32 spacings of max(|best perturbed logit|,
   1)). Its
   line prints tokens/s, ms a chunk, the busy share and the threefry
   kernel's ms a decode step.
   The prefix line (``serve_prefix``, unquantized and int8wk):
   bench.py's ``--serve --prefix-mix`` traffic (3 shared 64-token
   prefixes with 16-token suffixes; phase A a leader a prefix and 4
   unique prompts, phase B 6 duplicates of leader 0, 12 suffix variants
   and 4 unique prompts; 32 new tokens; max_len 128, 8 slots, chunk 16)
   served cold (the ring) and cached (``prefix_cache=True``, block 32,
   ``batch_admission=True``: host row copies, one admission-prefill
   graph a (rows, bucket)). Full hits equal their leader bit for bit with
   no prefill dispatch, the dispatch ledger balances, the cached run
   prefills less than the cold one and its full hits admit faster (p50)
   than the cold run's admissions, partial hits and misses pass the
   decisive teacher-forced gate, each admission key has one graph and
   every prefill dispatch of the timed cached run replays one. It prints
   the hit classes, prefill tokens saved, bytes cached, admission p50 /
   p99 by class, tokens/s and ms a chunk against the cold run, and the
   decoder's graph keys and the allocator's reserved bytes (now and at
   the line's peak).
   The speculative line (``serve_spec``): bench_serve_spec's traffic (16
   prompts of 32 tokens, 8-96 new; 8 slots, chunk 16, max_len 256)
   through the plain engine, then ``draft_model="skip:3"`` with K 4,
   a separate draft holding the target's own weights, ``quant="int8w"``
   with an int8w draft, and sampled (top-k 50, top-p 0.9). Gates: the
   dispatch identity with draft prefills, no per-token steps,
   per-request acceptance counts summing to the engine's, every chunk
   of a key after its first a replay, the decode-attention and int8
   launches the rounds imply (the int8 kernel's counted by row count:
   the verify's 40-row launches apart from the draft's 8-row ones), the
   decisive teacher-forced gate for
   greedy tokens, acceptance >= 0.75 K with the own-weights draft, and
   sampled tokens in the re-score's top 50 and repeating. It prints the
   acceptance, tokens per chunk dispatch, tokens/s and ms a chunk against
   the plain engine, the busy share, and the graph keys and reserved
   bytes as the prefix line does.
   The LoRA line (``serve_lora``, unquantized with f32 stacks, then over
   ``int8wk`` with fp16 stacks; the serving model at 6 of its 12
   layers): bench_serve_http's tenant mix without the HTTP part, the
   serving line's 16 requests round-robin to base and three adapters of
   ranks 2 / 3 / 4 over all 24 projection matrices, through
   ``ServingEngine(adapter_store=)`` and the ring with graphed chunks and
   prefills. Base rows must equal a plain engine's tokens over the same
   model bit for bit; each tenant's rows pass the decisive teacher-forced
   gate against a dense decoder with its A @ B folded in; one prefill a
   request, no per-token step or host scatter, 4 rows a tenant, the chunk
   dispatches of a plain engine serving the same requests at the same
   lengths, the launches the decode steps imply, the same tokens every
   drain; a hot swap of one adapter under its in-flight rows is refused
   (pinned rev 0, store rev 1), those rows keep their tokens, queued rows
   of that adapter wait for the swap and pass the gate against the rev-1
   merged decoder, and the swapped stacks get a chunk graph of their own;
   unquantized, one prefix-cache drain with each prompt as base and as
   one adapter hits in full only for a prompt its own tenant served
   before. It prints tokens/s and ms a chunk beside the plain twin's,
   the device ms and launches a decode step the
   adapter path adds (its profile against the twin's), and the graph keys
   and reserved bytes before and after the swap.
   The snapshot line (``serve_snapshot``, unquantized and ``int8wk``):
   the serving line's 16 requests through 8-slot engines; a snapshot
   after the third chunk (in-flight and queued requests) restored over a
   new decoder, a 4-slot snapshot restored into 8 slots, two in-flight
   rows and two queued requests migrated between two engines (greedy,
   and the sampled line's requests unquantized), an expired submit, an
   in-flight row cut by its deadline, and a graceful drain that
   snapshots, then a restore. Tokens equal the plain and sampled lines'
   bit for bit, or else pass the decisive (or top-50) gate, with the
   divergences printed; it prints the snapshot's and the restore's ms
   and bytes, extract and absorb ms and bytes a row, the resumed drain's
   tokens/s beside the plain line's and the restored decoder's graphs.
   The fault line (``serve_faults``, unquantized and ``int8wk``): the
   serving line's 16 requests through 8-slot engines (chunk 16, the ring,
   graphed chunks and prefills) under fault plans of the port's injector,
   backoff 0: (a) one transient at the third chunk dispatch, retried:
   the rows that rode it record one retry, the dispatch counts and the
   kernels' launch identities are the plain line's; (b) every chunk from
   the third on fails for good: the per-token rung serves (16 one-step
   dispatches a failed chunk, ``status()`` on ``per_token``), with the
   launch identities counting rung steps as steps; (c) with obs on and
   the flight directory in a temporary folder, the chunks fail and the
   rung dies with INTERNAL after the steps that finish a row (2, where
   the plain line's lengths allow): ``DecodeFailedError``, every
   harvested request equal to the plain line's, the postmortem's
   ``lost_requests`` exactly the unfinished rows with their tokens;
   (d) unquantized, the speculative line's own-weights draft engine with
   its chunk site failing ``resilience_retries + 1`` times from its
   second call: one ``decode.spec_demote`` dispatch, ``active`` false,
   the tokens through the decisive gate (their bit-equality with the
   speculative line's plain engine printed); (e) the plain drain with obs
   on: span counts per site equal to the dispatch accounting, tokens/s
   with obs on and off in turn (two timed drains each, over the same
   graphs: the obs flags key none), a drain under ``DeviceTraceSession``
   (``decode.chunk`` spans with device time, the attribution coverage),
   the chunk's cost record (flops, bytes, measured MFU against the bf16
   peak) and an ``ObsExporter`` on port 0 serving ``/metrics``. (a), (b)
   and (c) are held to the plain line bit for bit or else by the decisive
   gate with the first divergence printed. Prints tokens/s of (a), (b)
   and (d) beside the plain lines', the time from the first failure to
   the first rung step, the postmortem's bytes and ms.
   The router line (``serve_router``, unquantized and ``int8wk``): the
   16 requests through ``Router(ReplicaSet.from_backends(3 decoders),
   breaker_threshold=2)`` under bench.py's router plan (replica1's chunk
   dies fatally from its second call, replica2's heartbeat skips 4
   beats): none lost, one death, a requeue, the suspect recovered;
   unmoved rows equal the plain line bit for bit, requeued rows pass the
   decisive gate; unquantized, the sampled requests under
   ``request_keyed_rng`` undisturbed and under the plan, requeued rows
   through the top-50 gate. The HTTP line (``serve_http``): the 16
   requests from 16 client threads at once to an ``HttpFrontend`` over a
   fresh graphed engine, every other one streamed, a scraper reading
   ``/metrics`` and ``/statusz`` every 20 ms through the first, capturing
   chunks; streams equal their results, tokens held to the plain line,
   refusals 404 / 429 / 400 / 400, a drain then 503. The cluster line
   (``serve_cluster``): ``launch_cluster(prefill=1, decode=2)`` on the
   card (the kernel library built before the spawn), a real SIGKILL of
   decode0, the dispatch split and each worker's kernel launches through
   its ``status``, the fleet ``/metrics``; then ``recover="restart"``
   and, side by side with it, the frontend failover drill (the 16
   requests on one 8-slot decode worker, a frontend SIGKILL, a WAL
   resume, a stale-epoch probe). These
   print tokens/s against the plain line, p99, the requeues, the
   streams' first-line p50, spawn s, each worker's reserved memory and
   the card's, the RPC round trip, the kill's times (to the verdict, the
   requeue, to the last replayed token), and how many rows were
   bit-equal.
   The bundle line (``serve_bundle``): the model exported as AOT
   bundles (``export_decoder_bundle``, five bundles side by side, one
   process each; each entry a ``torch.export`` program with the weights
   baked in, launching the kernels as registered custom ops) and served
   by a loaded ``AotPredictor``: the engine over a chunked bundle
   (unquantized and ``int8wk``; bit-equal to an in-process engine on the
   same host-copy admission route, the plain ring line through the
   decisive gate, one graph replay a dispatch once warm, the launch
   identities), ``generate`` under bench_decode_1b_served's interleaved
   protocol (unquantized and ``int8w``, bit-equal to the in-process fused
   loop, whose marginal ms is printed beside), a sampled and a
   speculative bundle bit-equal to the in-process ``generate`` (the
   speculative one's acceptance counts too, and its plain rung under a
   fault plan), and the refusals (a flipped byte, a recipe mismatch both
   ways, a pickled archive, a JAX entry). It prints export s and bytes an
   entry, load s, the first drain's s, ``memory_report()``, reserved
   memory and the bytes a step's cache writes move beyond the in-place
   ones.
5. Training phase: bench.py's bench_llama (the 134M Llama, vocab 32000,
   hidden 768, 12 layers, 12 heads, bf16) through ``ShardedTrainer`` with
   AdamW, B 8, S 1024, one fixed batch. First the Adam kernel against its
   plain version on fresh tensors of the model's 111 shapes (f32, bf16
   with bf16 moments, bf16 with ``multi_precision=True``; Adam and AdamW;
   three steps; bit for bit), and the main path's update (bf16, AdamW)
   timed: kernel, plain version and ``torch.optim.AdamW(fused=True)``,
   which the port never calls, beside the bound (14 bytes an element at
   3.35 TB/s).
   One backward with the kernels and one with their plain versions
   (swapped in here only) must agree: loss within two bf16 spacings,
   every gradient at cosine >= 0.99. Then 2 steps (the eager warm-up, the
   capture of the step's CUDA graph) and 6 timed replays: finite losses,
   the first within 0.5 of ln 32000, falling; per step 12 flash forward
   and 12 flash backward launches, 25 + 25 RMSNorm launches and 3 Adam
   launches. ``graph_vs_eager``: one replay against one eager forward and
   backward from the same weights and state (the loss bit-equal, every
   gradient at cosine >= 0.999, the eager update on the replay's
   gradients bit-equal to the replay's parameters and state), then 3
   replays against 3 eager steps (first loss bit-equal, later ones within
   two bf16 spacings, the same launches); each parameter's 3-step change
   is reported at its cosine to the eager change, not gated. 6 timed
   eager steps with the same launch counts. Its line prints both routes'
   step ms and tokens/s, MFU (``flops_per_token`` against the bf16 peak),
   the replay's host ms, peak memory and, from a profiled replay and a
   profiled eager step, each route's device busy share, the costliest
   kernels, and the flash, RMSNorm and Adam kernels' ms (from the replay
   where the profiler names kernels inside it).
   Then ``use_fused_rope`` on (a key of its own: warm-up, capture): the
   rope kernel against its plain version in one backward, 24 + 24 rope
   launches a step, ``graph_vs_eager`` again, the step ms with the flag on
   beside 6 more steps with it off, and one profiled step with the rope
   kernels' device ms.
6. UNet phase: bench.py's bench_unet (``UNetConfig()``, 748 M bf16
   parameters, AdamW(1e-4, multi_precision=False), B 8, 4 x 64 x 64
   latents, context 8 x 77 x 1024) through ``ShardedTrainer``: the Adam
   kernel against its plain version on the model's ten largest and ten
   smallest shapes and timed over all of them, kernel against plain
   backward as above, 2 steps and 5 timed replays with finite, falling
   losses and 61 + 61 GroupNorm, 5 + 5 flash and 11 Adam launches a step
   (``unet_census`` counts the first from the config),
   ``graph_vs_eager``, 5 timed eager steps. Its line prints both routes'
   step ms and images/s, MFU (the census's FLOPs), peak memory, the
   replay's host ms and the profiled routes' busy shares, kernel kinds and
   per-kernel ms.
7. Families phase (``train_families``): the JAX package's other
   single-card benches at their full width, B and S, each through
   ``ShardedTrainer(mesh=None)`` with AdamW(1e-4, multi_precision=False)
   over bf16 parameters from seed 0 and the fixed batch of numpy seed 0
   (``family_line``): ``train_gpt``, bench_ernie's GPT (vocab 30000,
   hidden 1024, 12 layers, 16 heads, intermediate 4096, dropout 0.1; B 8,
   S 1024), ``train_bert``, bench_bert's BERT-base MLM (B 16, S 512) and
   ``train_moe``, bench_moe's LM (d 1024, f 4096, 8 experts, top-2,
   ragged dispatch through ``torch._grouped_mm``, 4 blocks, V 32000,
   the fused CE; B 8, S 1024). Each: the eager warm-up, the capture, 5
   timed replays (finite losses that fall), ``graph_vs_eager`` (the
   first replayed loss bit-equal to the eager step's under the same step
   key), the flash, Adam (and GPT's threefry) kernels launched in every
   replay, the MoE's grouped products in its eager step (2 a block) and
   its grouped-GEMM kernels in a profiled replay; GPT's dropout
   (``dropout_checks``): two replays from one state at key counters c
   and c + 1 give different losses, an eager step at c the first one's
   loss bit for bit, and a mask at the activations' shape keeps a share
   within 4 sigma of 0.9. Each line prints step ms, tokens/s, MFU against
   the dense bf16 peak (GPT and BERT by the bench's 6 N B S; the MoE by
   6 N_active B S, the formula printed), peak memory and a profiled
   replay's busy share and costliest kernels. The kernel phase holds
   flash attention at their shapes (B 8, H 16, S 1024, D 64, causal;
   B 16, H 12, S 512, D 64, non-causal) against its plain version.
8. Prints ``{"kernels": [...]}`` (the nine TPU kernels' rows, the Adam
   kernel's at the Llama's and the UNet's tensors, the threefry
   kernel's, launched by the sampled line, two rows at the
   speculative shapes: decode attention at a draft's per-row lengths and
   the int8 matmul at a verify's 40 rows, and flash attention's at the
   GPT's and BERT's shapes; the decode-attention and int8
   rows count the LoRA, snapshot, fault, router, HTTP, cluster and
   bundle lines' launches too, the cluster's summed from its worker
   processes' counters, the bundle line's made inside its loaded
   programs, the threefry row the router's keyed sampled runs, the
   sampled bundle's and the GPT line's dropout, and the Adam row the
   three families' updates), the card line,
   and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises, and the exit code is not 0. Without a card the
script exits 2 before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
L2_BYTES = 50 * 2**20


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, sets, iters=200):
    """Device ms per call of ``fn(*set)``: ``iters`` calls cycling through
    ``sets`` captured into one CUDA graph, whose replay is timed with CUDA
    events — the host's enqueue cost is out of the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for s in sets[:3]:
            fn(*s)
    torch.cuda.current_stream().wait_stream(side)
    from paddle_tpu_torch.ops import kernels as K
    graph = torch.cuda.CUDAGraph()
    with K.capture(graph):
        for i in range(iters):
            fn(*sets[i % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    del graph
    return t0.elapsed_time(t1) / iters


def eager_ms(fn, sets, iters=200):
    """Wall ms per eager call (CUDA events around a host loop): the cost
    the serving path pays today, host enqueue included."""
    for s in sets[:3]:
        fn(*s)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def library_backward_ms(out, inputs, grad, iters=50):
    """Device ms per ``torch.autograd.grad(out, inputs, grad)``: the summed
    device time of the kernels it launches over ``iters`` eager calls
    under ``torch.profiler``. A library backward runs through the autograd
    engine, whose host cost a wall clock would add to short kernels."""
    def call():
        return torch.autograd.grad(out, inputs, grad, retain_graph=True)

    call()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    return device_profile(prof, 1.0)["device_busy_ms"] / iters


def n_copies(set_bytes: int) -> int:
    """Input copies whose total exceeds twice the L2."""
    return max(2, min(256, math.ceil(2 * L2_BYTES / max(set_bytes, 1))))


def bound(bytes_moved: float, flops: float, peak: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def err_and_tol(got, want, dtype, bound=None):
    """Max |err|, its largest ratio to the element's tolerance (the module
    docstring states the tolerances; the check is ratio <= 1) and that
    ratio without ``bound``. NaN counts as equal to NaN and as infinitely
    far from any number. ``bound`` (bf16 flash attention) is the sum of
    |terms| behind each element that a rounding of p or ds to bf16 at
    another point scales: it adds 2^-7 of itself (half a spacing on each
    side) and 2^-16 of the largest |ref| (f32 summation order)."""
    got, want = got.float(), want.float()
    nan = torch.isnan(want)
    if not torch.equal(nan, torch.isnan(got)):
        return math.inf, math.inf, math.inf
    got, want = got.masked_fill(nan, 0.0), want.masked_fill(nan, 0.0)
    diff = (got - want).abs()
    if dtype == torch.float32:
        tol = torch.full_like(want, 1e-4)
    else:
        a = want.abs()
        a = torch.maximum(a, 1e-3 * a.amax(-1, keepdim=True))
        a = a.clamp_min(torch.finfo(torch.float32).tiny)
        tol = 2 * torch.exp2(torch.floor(torch.log2(a)) - 7)
    strict = (diff / tol).max().item()
    if bound is not None and dtype != torch.float32:
        tol = tol + 2.0 ** -7 * bound.float() + 2.0 ** -16 * want.abs().max()
    return diff.max().item(), (diff / tol).max().item(), strict


def flash_bounds(q, k, v, lse, do, causal, scale):
    """Per element of out, dq, dk and dv: the sum of |terms| that the bf16
    rounding of p (out, dv) or of ds (dq, dk) scales, from the plain
    version's f32 attention weights A = exp(s - lse) and ds = A (dp -
    delta) scale. Layout (B, S, H, D) like the outputs."""
    from paddle_tpu_torch.ops.kernels.flash_attention import (_NEG_INF,
                                                              _scores)
    bh = lambda x: x.float().transpose(1, 2)      # noqa: E731
    back = lambda x: x.transpose(1, 2).contiguous()  # noqa: E731
    lse4 = lse[..., None]
    a = torch.where(lse4 <= _NEG_INF * 0.5, 0.0,
                    torch.exp(_scores(q, k, causal, scale) - lse4))
    dof = bh(do)
    delta = (dof * (a @ bh(v))).sum(-1, keepdim=True)
    ds = (a * (dof @ bh(v).transpose(-1, -2) - delta) * scale).abs()
    return dict(out=back(a @ bh(v).abs()), dq=back(ds @ bh(k).abs()),
                dk=back(ds.transpose(-1, -2) @ bh(q).abs()),
                dv=back(a.transpose(-1, -2) @ dof.abs()))


def flash_build_info():
    """Each flash kernel's registers and spills (``-Xptxas -v`` in the
    build log), its static shared memory and, for the wgmma kernels, the
    dynamic shared memory their launch asks for."""
    import re

    from paddle_tpu_torch.ops.kernels import _build
    lib = _build.library()
    lines = _build.build_log().read_text().splitlines()
    rows = []
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\w*flash_\w+)'", line)
        if not m:
            continue
        # the kernel's own name follows its length, after the namespace's
        name = re.search(r"\d(flash_[a-z0-9_]+?_kernel)[IE]",
                         m.group(1)).group(1)
        d = re.search(r"_kernelILi(\d+)E", m.group(1))
        t = re.search(r"_kernelI(f|13__nv_bfloat16)(?:Li(\d+)E)?",
                      m.group(1))
        row = dict(kernel=name + (f"<{d.group(1)}>" if d else "")
                   + (f"<{'f32' if t.group(1) == 'f' else 'bf16'}"
                      f"{', ' + t.group(2) if t.group(2) else ''}>"
                      if t else ""))
        for x in lines[i + 1:i + 5]:
            r = re.search(r"Used (\d+) registers", x)
            if r:
                row["registers"] = int(r.group(1))
                sm = re.search(r"(\d+) bytes smem", x)
                row["static_smem"] = int(sm.group(1)) if sm else 0
                break
            sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", x)
            if sp:
                row["spill_stores"] = int(sp.group(1))
                row["spill_loads"] = int(sp.group(2))
        if d and "wgmma" in name:
            fn = (lib.flash_attention_fwd_smem if "fwd" in name
                  else lib.flash_attention_bwd_smem)
            row["dynamic_smem"] = fn(int(d.group(1)))
        rows.append(row)
    return rows


def parent_kernels(root):
    """The decode-attention and rope kernels of the checkout at ``root``
    (``csrc/decode_attention.cu`` and ``csrc/rope.cu`` of its
    ``paddle_tpu_torch``), built alone by one nvcc into
    ``build/parent_kernels/`` and bound through their own C entry points.
    Returns callables on this tree's wrappers' arguments:
    ``decode_attention(q, kc, vc, lens, k_scale, v_scale)`` and
    ``rope(x, cos, sin, sign)``. A source whose decode-attention entry
    point takes no split (the kernel before clusters) is called without
    one."""
    import ctypes
    from pathlib import Path

    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.ops.kernels import rope as rp
    csrc = Path(root) / "paddle_tpu_torch" / "csrc"
    out = Path(__file__).resolve().parent / "build" / "parent_kernels"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libparent_kernels.so"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build._nvcc(), *flags, "-shared",
                    str(csrc / "decode_attention.cu"), str(csrc / "rope.cu"),
                    "-o", str(so)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    split = "int P," in (csrc / "decode_attention.cu").read_text()
    lib.decode_attention_launch.argtypes = (
        [P_] * 7 + [I_] * (8 if split else 7) + [P_])
    lib.rope_launch.argtypes = [P_] * 4 + [I_] * 6 + [P_]
    lib.decode_attention_launch.restype = lib.rope_launch.restype = I_

    def decode_attention(q, kc, vc, lt, ks=None, vs=None):
        B, H, D = q.shape
        KV, L = kc.shape[1], kc.shape[2]
        o = torch.empty_like(q)
        args = [q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                ks.data_ptr() if ks is not None else None,
                vs.data_ptr() if vs is not None else None, lt.data_ptr(),
                o.data_ptr(), B, H, KV, L, D]
        args += [da.split_for(B, KV, L)] if split else []
        rc = lib.decode_attention_launch(
            *args, da._CODES[q.dtype], da._CODES[kc.dtype],
            torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"parent decode_attention launch: {rc}")
        return o

    def rope(x, c, s, sign):
        o = torch.empty_like(x)
        rc = lib.rope_launch(x.data_ptr(), c.data_ptr(), s.data_ptr(),
                             o.data_ptr(), *x.shape, sign,
                             rp._CODES[x.dtype],
                             torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"parent rope launch: {rc}")
        return o

    return dict(decode_attention=decode_attention, rope=rope)


# -- kernel phase -------------------------------------------------------------

def same_bits(a, b) -> bool:
    """Equal bit for bit (NaN included)."""
    return torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                       b.contiguous().reshape(-1).view(torch.uint8))


def da_case(name, B, H, KV, L, D, lens, dtype, quant, g, parent=None):
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.quantization.kv_cache import (dequantize_kv,
                                                        quantize_kv_rows)
    esz = 1 if quant else torch.tensor([], dtype=dtype).element_size()
    qsz = torch.tensor([], dtype=dtype).element_size()
    set_bytes = 2 * B * KV * L * (D * esz + (4 if quant else 0))
    sets, lib_sets = [], []
    lt = torch.tensor(lens, dtype=torch.int32, device="cuda")
    rep = H // KV
    mask = (torch.arange(L, device="cuda")[None, :]
            < lt[:, None].long())[:, None, None, :]
    for _ in range(n_copies(set_bytes)):
        q = torch.randn(B, H, D, generator=g, device="cuda").to(dtype)
        kf = torch.randn(B, KV, L, D, generator=g, device="cuda")
        vf = torch.randn(B, KV, L, D, generator=g, device="cuda")
        if quant:
            k, v = quantize_kv_rows(kf), quantize_kv_rows(vf)
            sets.append((q, k["q"], v["q"], lt, k["s"], v["s"]))
            kd, vd = dequantize_kv(k, dtype), dequantize_kv(v, dtype)
        else:
            kd, vd = kf.to(dtype), vf.to(dtype)
            sets.append((q, kd, vd, lt, None, None))
        lib_sets.append((q[:, :, None], kd.repeat_interleave(rep, 1),
                             vd.repeat_interleave(rep, 1)))
        del kf, vf

    def kern(q, k, v, lt, ks, vs):
        return da.decode_attention(q, k, v, lt, k_scale=ks, v_scale=vs)

    def plain(q, k, v, lt, ks, vs):
        return da.decode_attention_ref(q, k, v, lt, k_scale=ks, v_scale=vs)

    def lib(q4, kr, vr):
        return F.scaled_dot_product_attention(q4, kr, vr, attn_mask=mask)

    got, again = kern(*sets[0]), kern(*sets[0])
    err, ratio, _ = err_and_tol(got, plain(*sets[0]), dtype)
    torch.cuda.synchronize()
    check(ratio <= 1, f"{name}: max |err| {err}, {ratio} x its tolerance")
    check(same_bits(got, again), f"{name}: two runs differ")
    extra = {}
    if parent is not None:
        pfn = parent["decode_attention"]
        _, p_ratio, _ = err_and_tol(pfn(*sets[0]), plain(*sets[0]), dtype)
        check(p_ratio <= 1, f"{name}: the parent kernel at {p_ratio} x its "
              f"tolerance")
        extra["parent_ms"] = time_ms(pfn, sets)
    n = int(sum(min(x, L) for x in lens))
    moved = (2 * n * KV * (D * esz + (4 if quant else 0))
             + 2 * B * H * D * qsz + 4 * B)
    b_ms, b_by = bound(moved, 4.0 * H * D * n, BF16_FLOPS
                       if dtype == torch.bfloat16 else F32_FLOPS)
    return dict(case=name, kernel="decode_attention", max_abs_err=err,
                err_over_tol=ratio, split=da.split_for(B, KV, L),
                ms=time_ms(kern, sets), eager_ms=eager_ms(kern, sets),
                plain_ms=time_ms(plain, sets, iters=100),
                library_ms=time_ms(lib, lib_sets), bound_ms=b_ms,
                bound_by=b_by, **extra)


def i8_case(name, B, K, N, dtype, g):
    from paddle_tpu_torch.ops.kernels import int8_matmul as i8
    from paddle_tpu_torch.quantization import weight_quantize
    esz = torch.tensor([], dtype=dtype).element_size()
    sets = []
    for _ in range(n_copies(K * N)):
        x = torch.randn(B, K, generator=g, device="cuda").to(dtype)
        w, s = weight_quantize(
            torch.randn(K, N, generator=g, device="cuda") * 0.02)
        sets.append((x, w, s))

    def lib(x, w, s):
        return torch.matmul(x, w.to(x.dtype)) * s

    got = i8.int8_matmul(*sets[0])
    again = i8.int8_matmul(*sets[0])
    err, ratio, _ = err_and_tol(got, i8.int8_matmul_ref(*sets[0]), dtype)
    torch.cuda.synchronize()
    check(ratio <= 1, f"{name}: max |err| {err}, {ratio} x its tolerance")
    check(torch.equal(got, again), f"{name}: two runs differ")
    moved = K * N + B * K * esz + 4 * N + B * N * esz
    b_ms, b_by = bound(moved, 2.0 * B * K * N, BF16_FLOPS
                       if dtype == torch.bfloat16 else F32_FLOPS)
    return dict(case=name, kernel="int8_matmul", max_abs_err=err,
                err_over_tol=ratio,
                ms=time_ms(i8.int8_matmul, sets),
                eager_ms=eager_ms(i8.int8_matmul, sets),
                plain_ms=time_ms(i8.int8_matmul_ref, sets, iters=100),
                library_ms=time_ms(lib, sets, iters=100), bound_ms=b_ms,
                bound_by=b_by)


def visible_pairs(Sq, Sk, causal):
    """(query, key) pairs a causal bottom-right mask leaves (all if not
    causal): what the kernels must compute."""
    if not causal:
        return Sq * Sk
    off = Sk - Sq
    return sum(min(Sk, max(0, i + off + 1)) for i in range(Sq))


def flash_case(name, B, Sq, Sk, H, D, causal, dtype, g, library=True):
    """Forward and backward of the flash kernels against their plain
    versions (the backward fed the plain forward's out and lse), and
    their times: kernel, plain and (Sq == Sk) torch's
    scaled_dot_product_attention forward and backward. These kernels run
    for milliseconds, so a host loop timed with CUDA events measures the
    device: the enqueue hides behind it."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    esz = torch.tensor([], dtype=dtype).element_size()
    scale = D ** -0.5
    q, k, v = (torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype)
               for S in (Sq, Sk, Sk))
    do = torch.randn(B, Sq, H, D, generator=g, device="cuda").to(dtype)
    out, lse = fa.flash_fwd(q, k, v, causal, scale)
    ref_out, ref_lse = fa.flash_fwd_ref(q, k, v, causal, scale)
    grads = fa.flash_bwd(q, k, v, ref_out, ref_lse, do, causal, scale)
    again = fa.flash_bwd(q, k, v, ref_out, ref_lse, do, causal, scale)
    refs = fa.flash_bwd_ref(q, k, v, ref_out, ref_lse, do, causal, scale)
    torch.cuda.synchronize()
    dq_rerun = err_and_tol(again[0], grads[0], dtype)
    check(dq_rerun[1] <= 1, f"{name} dq of two runs: max |diff| "
          f"{dq_rerun[0]}, {dq_rerun[1]} x its tolerance")
    del again
    bounds = (flash_bounds(q, k, v, ref_lse, do, causal, scale)
              if dtype == torch.bfloat16 else {})
    errs = {}
    for what, got, want in zip(("out", "dq", "dk", "dv"), (out, *grads),
                               (ref_out, *refs)):
        errs[what] = err_and_tol(got, want, dtype, bounds.get(what))
        check(errs[what][1] <= 1, f"{name} {what}: max |err| "
              f"{errs[what][0]}, {errs[what][1]} x its tolerance")
    lse_err = (lse - ref_lse).abs().max().item()
    check(lse_err <= 1e-4, f"{name} lse: max |err| {lse_err}")
    del bounds, out, grads, refs
    iters = 20 if Sq * Sk >= 2**20 else 50
    fwd = lambda: fa.flash_fwd(q, k, v, causal, scale)          # noqa: E731
    bwd = lambda: fa.flash_bwd(q, k, v, ref_out, ref_lse, do,   # noqa: E731
                               causal, scale)
    n_q, n_k = B * Sq * H * D, B * Sk * H * D
    pairs = B * H * visible_pairs(Sq, Sk, causal)
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    f_ms, f_by = bound(esz * (2 * n_q + 2 * n_k) + 4 * B * H * Sq,
                       4.0 * pairs * D, peak)
    b_ms, b_by = bound(esz * (4 * n_q + 4 * n_k) + 4 * B * H * Sq,
                       10.0 * pairs * D, peak)
    lib_f = lib_b = None
    if library:
        ql, kl, vl = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        lib_f = eager_ms(lambda *_: F.scaled_dot_product_attention(
            ql, kl, vl, is_causal=causal), [()], iters)
        ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
        lib_b = library_backward_ms(ol, (ql, kl, vl), do.transpose(1, 2),
                                    iters)
    common = dict(err_over_strict_tol=max(e[2] for e in errs.values()))
    rows = [dict(case=f"{name} fwd", kernel="flash_attention_fwd",
                 max_abs_err=errs["out"][0], err_over_tol=errs["out"][1],
                 lse_max_abs_err=lse_err,
                 ms=eager_ms(lambda *_: fwd(), [()], iters),
                 plain_ms=eager_ms(lambda *_: fa.flash_fwd_ref(
                     q, k, v, causal, scale), [()], max(5, iters // 4)),
                 library_ms=lib_f, bound_ms=f_ms, bound_by=f_by, **common),
            dict(case=f"{name} bwd", kernel="flash_attention_bwd",
                 max_abs_err=max(errs[x][0] for x in ("dq", "dk", "dv")),
                 err_over_tol=max(errs[x][1] for x in ("dq", "dk", "dv")),
                 dq_rerun_max_abs_diff=dq_rerun[0],
                 ms=eager_ms(lambda *_: bwd(), [()], iters),
                 plain_ms=eager_ms(lambda *_: fa.flash_bwd_ref(
                     q, k, v, ref_out, ref_lse, do, causal, scale), [()],
                     max(5, iters // 4)),
                 library_ms=lib_b, bound_ms=b_ms, bound_by=b_by, **common)]
    for r in rows:
        if r["library_ms"]:
            r["over_library"] = r["ms"] / r["library_ms"]
    return rows


def rms_fwd_check(x, w, eps, out, k_inv):
    """The RMSNorm forward kernel's ``(out, inv)`` against plain versions:
    ``inv`` against the plain ``inv`` at the f32 tolerance, and ``out``
    against the plain output formed from the KERNEL's ``inv`` (x * inv
    rounded to x's dtype, then times w, rounded) at x's dtype's
    tolerance. The plain version rounds twice, so an ``inv`` one ulp off
    (the kernel sums x^2 in another order) moves a normalized element by
    a spacing and its product with w by up to about three; holding the
    output to the kernel's own ``inv`` keeps the check at two spacings.
    Returns the err_and_tol triples of out and inv, and of out against the
    plain version's own output (printed, not gated)."""
    from paddle_tpu_torch.ops.kernels import rms_norm as rn
    H = x.shape[-1]
    ref_out, ref_inv = rn.rms_fwd_ref(x, w, eps)
    out_dtype = torch.promote_types(x.dtype, w.dtype)
    from_inv = ((x.reshape(-1, H).float() * k_inv).to(x.dtype).float()
                * w.float()).to(out_dtype).reshape(x.shape)
    return (err_and_tol(out, from_inv, x.dtype),
            err_and_tol(k_inv, ref_inv, torch.float32),
            err_and_tol(out, ref_out, x.dtype))


def rms_case(name, rows, H, dtype, g):
    """RMSNorm forward and backward kernels against their plain versions,
    timed through CUDA graphs (these kernels run for microseconds), with
    torch's F.rms_norm forward and backward as the yardstick."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.kernels import rms_norm as rn
    esz = torch.tensor([], dtype=dtype).element_size()
    eps = 1e-6
    sets = []
    for _ in range(n_copies(3 * rows * H * esz)):
        x = torch.randn(rows, H, generator=g, device="cuda").to(dtype)
        w = (1 + 0.1 * torch.randn(H, generator=g, device="cuda")).to(dtype)
        gy = torch.randn(rows, H, generator=g, device="cuda").to(dtype)
        sets.append((x, w, gy, rn.rms_fwd_ref(x, w, eps)[1]))
    x, w, gy, inv = sets[0]
    out, k_inv = rn.rms_fwd(x, w, eps)
    dx, dw = rn.rms_bwd(x, w, inv, gy)
    dx2, dw2 = rn.rms_bwd(x, w, inv, gy)
    ref_dx, ref_dw = rn.rms_bwd_ref(x, w, inv, gy)
    torch.cuda.synchronize()
    check(torch.equal(dx, dx2) and torch.equal(dw, dw2),
          f"{name}: two backward runs differ")
    e_out, e_inv, e_plain = rms_fwd_check(x, w, eps, out, k_inv)
    e_dx, e_dw = (err_and_tol(a, b, dtype) for a, b in
                  ((dx, ref_dx), (dw, ref_dw)))
    for what, e in (("out", e_out), ("dx", e_dx), ("dw", e_dw),
                    ("inv", e_inv)):
        check(e[1] <= 1, f"{name} {what}: max |err| {e[0]}, {e[1]} x its "
              f"tolerance")
    n = rows * H
    f_ms, f_by = bound(2 * n * esz + H * esz + 4 * rows, 4.0 * n, F32_FLOPS)
    b_ms, b_by = bound(3 * n * esz + 2 * H * esz + 4 * rows, 10.0 * n,
                       F32_FLOPS)
    xl = x.detach().requires_grad_()
    wl = w.detach().requires_grad_()
    yl = F.rms_norm(xl, (H,), wl, eps)
    return [
        dict(case=f"{name} fwd", kernel="rms_norm_fwd",
             max_abs_err=max(e_out[0], e_inv[0]),
             err_over_tol=max(e_out[1], e_inv[1]),
             max_abs_err_vs_plain_out=e_plain[0],
             err_over_tol_vs_plain_out=e_plain[1],
             ms=time_ms(lambda x, w, gy, inv: rn.rms_fwd(x, w, eps), sets),
             plain_ms=time_ms(lambda x, w, gy, inv: rn.rms_fwd_ref(x, w, eps),
                              sets, iters=100),
             library_ms=time_ms(lambda x, w, gy, inv: F.rms_norm(
                 x, (H,), w, eps), sets, iters=100),
             bound_ms=f_ms, bound_by=f_by),
        dict(case=f"{name} bwd", kernel="rms_norm_bwd",
             max_abs_err=max(e_dx[0], e_dw[0]),
             err_over_tol=max(e_dx[1], e_dw[1]),
             ms=time_ms(lambda x, w, gy, inv: rn.rms_bwd(x, w, inv, gy), sets),
             plain_ms=time_ms(lambda x, w, gy, inv: rn.rms_bwd_ref(
                 x, w, inv, gy), sets, iters=100),
             library_ms=library_backward_ms(yl, (xl, wl), gy, 100),
             bound_ms=b_ms, bound_by=b_by)]


def gn_case(name, shape, G, act, dtype, g, shift=None, plain=True):
    """GroupNorm forward and backward kernels against their plain versions
    (the backward fed the plain forward's statistics), timed through CUDA
    graphs, with torch's F.group_norm (then F.silu where act is silu)
    forward and the device time of its backward kernels as the yardstick.
    f32 dw and db are sums of B x HW products per channel in another
    order, held at 1e-4 of their largest |ref|. Two runs of each kernel
    must give the same bits (out, mean, rstd; dx, dw, db). The route each
    direction takes (``gn.route``: clusters of K blocks, or 0 for the
    streaming kernels) is printed as ``cluster_k``. ``shift``: x =
    shift + 0.01 N (f32 only), judged also against the f64 truth: finite,
    and the kernel no worse than the plain version. ``plain`` False skips
    timing the plain version (its ``plain_ms`` is None)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.kernels import group_norm as gn
    esz = torch.tensor([], dtype=dtype).element_size()
    C, eps = shape[1], 1e-5
    n = math.prod(shape)
    sets = []
    for _ in range(n_copies(3 * n * esz)):
        x = torch.randn(shape, generator=g, device="cuda")
        x = (shift + 0.01 * x if shift is not None else x).to(dtype)
        w = (1 + 0.1 * torch.randn(C, generator=g, device="cuda")).to(dtype)
        b = (0.1 * torch.randn(C, generator=g, device="cuda")).to(dtype)
        gy = torch.randn(shape, generator=g, device="cuda").to(dtype)
        _, mean, rstd = gn.gn_fwd_ref(x, w, b, G, eps, act)
        sets.append((x, w, b, gy, mean, rstd))
    x, w, b, gy, mean, rstd = sets[0]
    out, k_mean, k_rstd = gn.gn_fwd(x, w, b, G, eps, act)
    again = gn.gn_fwd(x, w, b, G, eps, act)
    ref_out, _, _ = gn.gn_fwd_ref(x, w, b, G, eps, act)
    dx, dw, db = gn.gn_bwd(x, w, b, mean, rstd, gy, G, act)
    again += gn.gn_bwd(x, w, b, mean, rstd, gy, G, act)
    ref_dx, ref_dw, ref_db = gn.gn_bwd_ref(x, w, b, mean, rstd, gy, G, act)
    torch.cuda.synchronize()
    for what, a, r in zip(("out", "mean", "rstd", "dx", "dw", "db"),
                          (out, k_mean, k_rstd, dx, dw, db), again):
        check(torch.equal(a, r), f"{name} {what}: two runs differ")
    if dtype == torch.float32:
        sc = [t.abs().max().clamp_min(1) for t in (ref_dw, ref_db)]
        dw, ref_dw, db, ref_db = (dw / sc[0], ref_dw / sc[0], db / sc[1],
                                  ref_db / sc[1])
    errs = {k: err_and_tol(a, r, dtype) for k, a, r in (
        ("out", out, ref_out), ("dx", dx, ref_dx), ("dw", dw, ref_dw),
        ("db", db, ref_db))}
    errs["mean"] = err_and_tol(k_mean, mean, torch.float32)
    errs["rstd"] = err_and_tol(k_rstd / rstd, torch.ones_like(rstd),
                               torch.float32)
    for what, e in errs.items():
        check(e[1] <= 1, f"{name} {what}: max |err| {e[0]}, {e[1]} x its "
              f"tolerance")
    extra = {}
    if shift is not None:
        x64 = x.double().reshape(shape[0], G, -1)
        aff = (1, C) + (1,) * (len(shape) - 2)
        true = ((x64 - x64.mean(-1, keepdim=True)) / torch.sqrt(
            x64.var(-1, correction=0, keepdim=True) + eps)).reshape(shape) \
            * w.double().reshape(aff) + b.double().reshape(aff)
        if act:
            true = true * torch.sigmoid(true)
        k_err = (out.double() - true).abs().max().item()
        p_err = (ref_out.double() - true).abs().max().item()
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        check(k_err <= p_err + 1e-3, f"{name}: kernel error {k_err} against "
              f"the f64 truth, plain {p_err}")
        extra = dict(err_vs_f64=k_err, plain_err_vs_f64=p_err)
    f_ms, f_by = bound(2 * n * esz + 2 * C * esz + 8 * shape[0] * G,
                       (12.0 if act else 8.0) * n, F32_FLOPS)
    b_ms, b_by = bound(3 * n * esz + 4 * C * esz + 8 * shape[0] * G,
                       (20.0 if act else 12.0) * n, F32_FLOPS)

    def lib_fwd(x, w, b, *_):
        y = F.group_norm(x, G, w, b, eps)
        return F.silu(y) if act else y

    xl, wl, bl = (t.detach().requires_grad_() for t in (x, w, b))
    yl = lib_fwd(xl, wl, bl)
    route = {d: gn.route(shape, G, dtype, d == "bwd") for d in ("fwd", "bwd")}
    common = dict(shape=list(shape), groups=G, act=act, **extra)
    return [
        dict(case=f"{name} fwd", kernel="group_norm_fwd",
             max_abs_err=max(errs[k][0] for k in ("out", "mean", "rstd")),
             err_over_tol=max(errs[k][1] for k in ("out", "mean", "rstd")),
             ms=time_ms(lambda x, w, b, *_: gn.gn_fwd(x, w, b, G, eps, act),
                        sets),
             plain_ms=time_ms(lambda x, w, b, *_: gn.gn_fwd_ref(
                 x, w, b, G, eps, act), sets, iters=20) if plain else None,
             library_ms=time_ms(lib_fwd, sets, iters=100), bound_ms=f_ms,
             bound_by=f_by, cluster_k=route["fwd"], **common),
        dict(case=f"{name} bwd", kernel="group_norm_bwd",
             max_abs_err=max(errs[k][0] for k in ("dx", "dw", "db")),
             err_over_tol=max(errs[k][1] for k in ("dx", "dw", "db")),
             ms=time_ms(lambda x, w, b, gy, m, r: gn.gn_bwd(
                 x, w, b, m, r, gy, G, act), sets),
             plain_ms=time_ms(lambda x, w, b, gy, m, r: gn.gn_bwd_ref(
                 x, w, b, m, r, gy, G, act), sets, iters=20) if plain
             else None,
             library_ms=library_backward_ms(yl, (xl, wl, bl), gy, 50),
             bound_ms=b_ms, bound_by=b_by, cluster_k=route["bwd"], **common)]


def rope_case(name, B, S, H, D, dtype, g, parent=None):
    """The rope kernel forward (the rotation) and backward (the same kernel
    with -sin) against the plain version, timed through CUDA graphs.
    PyTorch has no single call for rope, so there is no library time."""
    from paddle_tpu_torch.ops.kernels import rope as rp
    esz = torch.tensor([], dtype=dtype).element_size()
    n = B * S * H * D
    sets = []
    for _ in range(n_copies(2 * n * esz)):
        x = torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype)
        t = torch.randn(S, D // 2, generator=g, device="cuda")
        sets.append((x, t.cos().to(dtype), t.sin().to(dtype)))
    x, c, sn = sets[0]
    e_f = err_and_tol(rp.rope_fwd(x, c, sn), rp.rope_ref(x, c, sn), dtype)
    e_b = err_and_tol(rp.rope_bwd(x, c, sn), rp.rope_ref(x, c, sn, -1),
                      dtype)
    torch.cuda.synchronize()
    for what, e in (("fwd", e_f), ("bwd", e_b)):
        check(e[1] <= 1, f"{name} {what}: max |err| {e[0]}, {e[1]} x its "
              f"tolerance")
    r_ms, r_by = bound(2 * n * esz + S * D * esz, 3.0 * n, F32_FLOPS)
    rows = []
    for what, e, fn, sign in (("fwd", e_f, rp.rope_fwd, 1),
                              ("bwd", e_b, rp.rope_bwd, -1)):
        extra = {}
        if parent is not None:
            def pfn(x, c, s, sign=sign):
                return parent["rope"](x, c, s, sign)
            _, p_ratio, _ = err_and_tol(pfn(x, c, sn),
                                        rp.rope_ref(x, c, sn, sign), dtype)
            check(p_ratio <= 1, f"{name} {what}: the parent kernel at "
                  f"{p_ratio} x its tolerance")
            extra["parent_ms"] = time_ms(pfn, sets)
        rows.append(dict(
            case=f"{name} {what}", kernel=f"rope_{what}", max_abs_err=e[0],
            err_over_tol=e[1], ms=time_ms(fn, sets),
            plain_ms=time_ms(lambda x, c, s: rp.rope_ref(x, c, s, sign),
                             sets, iters=50),
            library_ms=None, bound_ms=r_ms, bound_by=r_by, **extra))
    return rows


def served_keys():
    """The 16 keys the sampled serving line's rows start from: request j
    has seed 1000 + j, and its row key is split(PRNGKey(seed), 1)[0],
    made on the CPU as the engine makes it."""
    from paddle_tpu_torch import random as rnd
    return torch.stack([rnd.split(rnd.PRNGKey(1000 + j, device="cpu"), 1)[0]
                        for j in range(16)])


def threefry_case(name, R, n):
    """The threefry kernel against its plain version, bit for bit, on R
    keys split from the served keys, timed as a CUDA graph beside its
    bound: 8 bytes written a counter (the integer operations are not
    counted). No single PyTorch call computes these bits."""
    from paddle_tpu_torch import random as rnd
    from paddle_tpu_torch.ops.kernels import threefry as tf
    base = served_keys().cuda()
    sets = [(rnd.split(base[j % 16], R).contiguous(), n) for j in range(4)]
    for keys, _ in sets:
        got = tf.threefry_words(keys, n)
        torch.cuda.synchronize()
        check(torch.equal(got, tf.threefry_words_ref(keys, n)),
              f"{name}: kernel and plain version differ")
    b_ms, b_by = bound(8.0 * R * n + 8 * R, 0.0, F32_FLOPS)
    iters = 200 if R * n <= 2**18 else 50
    return dict(case=name, kernel="threefry", max_abs_err=0.0,
                err_over_tol=0.0, ms=time_ms(tf.threefry_words, sets, iters),
                eager_ms=eager_ms(tf.threefry_words, sets, iters),
                plain_ms=time_ms(tf.threefry_words_ref, sets, iters=10),
                library_ms=None, bound_ms=b_ms, bound_by=b_by)


def threefry_cases():
    """R 8 x n 32000 (one draw of a served sampling step), R 1 x 2^20,
    and the served keys' split (the chunk's per-step split, two counters
    a key) and fold_in on the card against the CPU's plain version."""
    from paddle_tpu_torch import random as rnd
    keys = served_keys()
    got = rnd.split_rows(keys.cuda())
    check(torch.equal(got.cpu(), rnd.split_rows(keys)),
          "threefry: split of the served keys differs from the CPU's")
    for j in (0, 7, 15):
        check(torch.equal(rnd.fold_in(keys[j].cuda(), 31 * j).cpu(),
                          rnd.fold_in(keys[j], 31 * j)),
              "threefry: fold_in of a served key differs from the CPU's")
    return [threefry_case("threefry R8 n32000", 8, 32000),
            threefry_case("threefry R1 n1048576", 1, 2**20)]


def gn_census_cases(g):
    """One bf16 case (B 8, 32 groups) for each distinct (channels, HW, act)
    GroupNorm shape of a bench_unet step (``unet_census``), the plain
    version checked but not timed, then one line of the per-step sums over
    the census's 61 calls: kernel, torch and bound ms, forward and
    backward."""
    import collections

    from paddle_tpu_torch.flags import flags
    from paddle_tpu_torch.models.unet import UNetConfig
    census = unet_census(UNetConfig(), 8, 64, 77,
                         flags.flash_attention_min_seq)
    counts = collections.Counter(census["gn"])
    cases, sums = [], {}
    for (C, hw, act), calls in sorted(counts.items(),
                                      key=lambda kv: (kv[0][0], kv[0][1],
                                                      str(kv[0][2]))):
        side = math.isqrt(hw)
        for c in gn_case(f"group_norm census bf16 8x{C}x{side}x{side} G32 "
                         f"{act or 'none'}", (8, C, side, side), 32, act,
                         torch.bfloat16, g, plain=False):
            c["calls_per_step"] = calls
            d = c["case"].rsplit(" ", 1)[1]
            for k in ("ms", "library_ms", "bound_ms"):
                sums[f"{d}_{k}"] = sums.get(f"{d}_{k}", 0.0) + calls * c[k]
            cases.append(c)
    emit({"group_norm_census_per_step": dict(
        calls=sum(counts.values()), shapes=len(counts), **sums)})
    return cases


# per-row lengths of a speculative draft's decode-attention calls on the
# served path: prompts of 32 tokens plus 1-100 committed ones and the
# round's offset j <= K
DRAFT_LENS = [33, 36, 41, 50, 67, 90, 111, 133]


def kernel_phase(parent=None):
    g = torch.Generator(device="cuda").manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32
    lens = [1, 37, 256, 100, 200, 129, 64, 255]
    long_lens = [4096, 1, 3000, 2049, 4000, 17, 1024, 4095]
    cases = [
        da_case("decode_attention f32 B8 H12 KV4 D64 L256", 8, 12, 4, 256,
                64, lens, f32, False, g, parent),
        da_case("decode_attention bf16 B8 H12 KV4 D64 L256", 8, 12, 4, 256,
                64, lens, bf, False, g, parent),
        # a row of valid length 0: NaN (0 / 0) in kernel and plain alike
        da_case("decode_attention bf16 B8 H12 KV4 D64 L256 with an empty "
                "row", 8, 12, 4, 256, 64, [0] + lens[1:], bf, False, g,
                parent),
        da_case("decode_attention bf16 int8-KV B8 H12 KV4 D64 L256", 8, 12,
                4, 256, 64, lens, bf, True, g, parent),
        da_case("decode_attention f32 int8-KV B8 H12 KV4 D64 L256", 8, 12,
                4, 256, 64, lens, f32, True, g, parent),
        da_case("decode_attention bf16 B8 H12 KV4 D64 L4096", 8, 12, 4,
                4096, 64, long_lens, bf, False, g, parent),
        da_case("decode_attention bf16 int8-KV B8 H12 KV4 D64 L4096", 8, 12,
                4, 4096, 64, long_lens, bf, True, g, parent),
        i8_case("int8_matmul f32 B8 qkv 768x1280", 8, 768, 1280, f32, g),
    ]
    # every row count the serving path gives the kernel: 8 slots decoding,
    # and admission prefills of groups of 16-, 32- or 64-token buckets
    # that stay within 64 rows
    for B in (8, 16, 32, 48, 64):
        for what, K, N in (("qkv", 768, 1280), ("o_proj", 768, 768),
                           ("gate_up", 768, 4096), ("down", 2048, 768),
                           ("head", 768, 32000)):
            cases.append(i8_case(f"int8_matmul bf16 B{B} {what} {K}x{N}",
                                 B, K, N, bf, g))
    # the training path's shapes (bench_llama: B8 S1024, 12 heads of 64,
    # hidden 768), one f32 case and a ragged one (S not a multiple of the
    # 64-row tile, sq < sk causal)
    cases += flash_case("flash_attention bf16 B8 H12 S1024 D64 causal", 8,
                        1024, 1024, 12, 64, True, bf, g)
    cases += flash_case("flash_attention f32 B2 H4 S256 D64 causal", 2, 256,
                        256, 4, 64, True, f32, g)
    cases += flash_case("flash_attention bf16 B2 H3 Sq200 Sk333 D64 causal",
                        2, 200, 333, 3, 64, True, bf, g, library=False)
    cases += rms_case("rms_norm bf16 8192x768", 8192, 768, bf, g)
    cases += rms_case("rms_norm f32 8192x768", 8192, 768, f32, g)
    # the UNet's level-1 self-attention: 640 channels over 8 heads of 80
    cases += flash_case("flash_attention bf16 B8 H8 S1024 D80", 8, 1024,
                        1024, 8, 80, False, bf, g)
    # the UNet path's GroupNorms (B 8, 32 groups): the level-0 slab, the
    # largest slab (960 channels at 64 x 64), the narrowest maps, an
    # attention block's norm without SiLU, one f32 case and the shifted
    # 1000 +- 0.01 case
    for shape, act, dt, shift in (((8, 320, 64, 64), "silu", bf, None),
                                  ((8, 960, 64, 64), "silu", bf, None),
                                  ((8, 2560, 8, 8), "silu", bf, None),
                                  ((8, 640, 32, 32), None, bf, None),
                                  ((8, 640, 32, 32), "silu", f32, None),
                                  ((8, 320, 64, 64), None, f32, 1000.0)):
        tag = "bf16" if dt == bf else "f32"
        cases += gn_case(
            f"group_norm {tag} {'x'.join(map(str, shape))} G32 "
            f"{act or 'none'}{' shifted' if shift else ''}", shape, 32, act,
            dt, g, shift)
    cases += gn_census_cases(g)
    # the Llama trainer's q and k with use_fused_rope (B 8, S 1024, 12
    # heads of 64)
    cases += rope_case("rope bf16 B8 S1024 H12 D64", 8, 1024, 12, 64, bf, g,
                       parent)
    cases += rope_case("rope f32 B8 S1024 H12 D64", 8, 1024, 12, 64, f32, g,
                       parent)
    # the sampler's counter hashing (a served step: 8 rows x 32000)
    cases += threefry_cases()
    # the speculative slice's shapes, drawn after every earlier case so
    # that those keep their inputs: a draft's single-token forwards at
    # per-row lengths of served rows (32-token prompts, 8-96 new tokens,
    # K 4), and one verify forward's int8 matmuls at 8 x (K + 1) = 40
    # rows, then summed (row 2v)
    cases.append(da_case("decode_attention bf16 B8 H12 KV4 D64 L256 draft "
                         "rows", 8, 12, 4, 256, 64, DRAFT_LENS, bf, False,
                         g, parent))
    v40 = [i8_case(f"int8_matmul bf16 B40 {what} {K}x{N}", 40, K, N, bf, g)
           for what, K, N in (("qkv", 768, 1280), ("o_proj", 768, 768),
                              ("gate_up", 768, 4096), ("down", 2048, 768),
                              ("head", 768, 32000))]
    cases += v40 + [dict(
        case="int8_matmul bf16 B40 verify", kernel="int8_matmul",
        max_abs_err=max(c["max_abs_err"] for c in v40),
        err_over_tol=max(c["err_over_tol"] for c in v40),
        bound_by=("bytes" if all(c["bound_by"] == "bytes" for c in v40)
                  else "operations"),
        **{k: sum(c[k] for c in v40) for k in (
            "ms", "eager_ms", "plain_ms", "library_ms", "bound_ms")})]
    # the other model families' attention, drawn after every earlier case
    # so that those keep their inputs: bench_ernie's GPT (causal, 16 heads
    # of 64 at S 1024, B 8) and bench_bert's BERT-base (non-causal, 12
    # heads of 64 at S 512, B 16)
    cases += flash_case("flash_attention bf16 B8 H16 S1024 D64 causal", 8,
                        1024, 1024, 16, 64, True, bf, g)
    cases += flash_case("flash_attention bf16 B16 H12 S512 D64", 16, 512,
                        512, 12, 64, False, bf, g)
    for c in cases:
        c["bound_us"] = 1e3 * c["bound_ms"]
        c["share_of_bound"] = c["bound_ms"] / c["ms"]
        emit(c)
    return cases


# -- serving phase ------------------------------------------------------------

def kernel_events(prof):
    """(device us, name, count) of every CUDA kernel of a profiled window,
    costliest first; averaged once per profile (a drain holds some 10^5
    kernel events)."""
    if not hasattr(prof, "_kernel_events"):
        prof._kernel_events = sorted(
            ((e.self_device_time_total, e.key, e.count)
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and e.self_device_time_total > 0), reverse=True)
    return prof._kernel_events


def device_profile(prof, wall_s):
    """Device busy share of a profiled window and its costliest kernels:
    the summed device time of every CUDA kernel over the window's wall
    time (one stream, so kernels do not overlap)."""
    kern = kernel_events(prof)
    busy_us = sum(t for t, _, _ in kern)
    return dict(device_busy_share=busy_us / (wall_s * 1e6),
                device_busy_ms=busy_us / 1e3,
                top_kernels=[dict(name=k[:80], ms=t / 1e3, count=n)
                             for t, k, n in kern[:8]])


def eager_fused(dec):
    """Route ``dec``'s fused ``generate()`` loop through the eager loop
    body on every call (no graph is captured), still one counted dispatch
    through the decoder's dispatch guard: the route the graphed loop is
    held against. Only this script does this."""
    dec._fused_graph = lambda key: None
    return dec


def fused_graphs(dec):
    """(captured fused-loop graphs, their replays) of ``dec``."""
    gs = [g for g in dec._fused_graphs.values()
          if g is not None and g.graph is not None]
    return len(gs), sum(g.replays for g in gs)


def eager_chunks(dec):
    """Route ``dec``'s chunks through the eager chunk body
    (``_chunk_steps``, the ring's splice and the sampler included), still
    one counted dispatch each through the decoder's dispatch guard: the
    route the captured chunk is held against. Only this script does
    this."""
    dec._graphed_chunk = lambda key, st, body, fields, outs: body(st)
    return dec


def drain(eng, reqs, profile=False, sampling=None, adapters=None):
    """Submit ``reqs`` and drain: (served tokens per request, wall s,
    profiler or None). With ``profile`` only the device's kernels are
    traced (host ops untraced, so the drain keeps its pace).
    ``sampling``: a (seed, temperature) per request; ``adapters``: a LoRA
    adapter name (None = base) per request."""
    torch.cuda.synchronize()
    prof = (torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA]) if profile
        else None)
    if prof is not None:
        prof.__enter__()
    try:
        t0 = time.perf_counter()
        kws = ([{}] * len(reqs) if sampling is None else
               [dict(seed=sd, temperature=t) for sd, t in sampling])
        if adapters is not None:
            kws = [dict(kw, adapter=a) for kw, a in zip(kws, adapters)]
        ids = [eng.submit(p, n, eos_token_id=e, **kw)
               for (p, n, e), kw in zip(reqs, kws)]
        res = eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    outs = [np.asarray(res[rid])[0] for rid in ids]
    for (p, _, _), out in zip(reqs, outs):
        check(np.array_equal(out[:len(p)], p), "prompt echoed")
    return [out[len(p):] for (p, _, _), out in zip(reqs, outs)], wall, prof


def rescore(dec, reqs, gens):
    """Teacher-forced logits of each served sequence through the plain
    prefill path (S > 1: masked dense attention, > 64 rows: no int8
    kernel): per request, the (len(gen), V) f32 logits that predicted its
    served tokens."""
    from paddle_tpu_torch.serving import bucket_length
    seqs = [np.concatenate([p, g]) for (p, _, _), g in zip(reqs, gens)]
    W = bucket_length(max(len(s) for s in seqs))
    ids_np = np.zeros((len(seqs), W), np.int64)
    for j, s in enumerate(seqs):
        ids_np[j, :len(s)] = s
    logits, _, _ = dec.admit_prefill(ids_np, [len(s) for s in seqs],
                                     np.zeros(len(seqs), np.int64),
                                     return_all=True)
    return [logits[j, len(p) - 1:len(p) - 1 + len(g)]
            for j, ((p, _, _), g) in enumerate(zip(reqs, gens))]


def teacher_forced(tag, dec, reqs, gens, which=None):
    """The decisive teacher-forced gate of served greedy tokens (of the
    requests ``which``, default all) against a plain re-score: the
    logits are bf16 products, so where the re-score's top two sit within
    one bf16 spacing of each other which of them wins is rounding.
    Agreement >= 0.99 is required where the re-score is decisive (top-1
    ahead by more than 2 bf16 spacings), and every served token must be
    within 4 spacings of the re-score's best."""
    if which is not None:
        reqs = [reqs[j] for j in which]
        gens = [gens[j] for j in which]
    rows = torch.cat(rescore(dec, reqs, gens))
    served = torch.as_tensor(np.concatenate(gens), device=rows.device)
    top = rows.topk(2, dim=-1).values
    spacing = bf16_spacing(top[:, 0])
    hit = rows.argmax(-1) == served
    decisive = top[:, 0] - top[:, 1] > 2 * spacing
    deficit = (top[:, 0] - rows.gather(1, served[:, None])[:, 0]) / spacing
    rate = int(hit.sum()) / len(hit)
    rate_decisive = int(hit[decisive].sum()) / max(int(decisive.sum()), 1)
    check(rate_decisive >= 0.99, f"{tag}: teacher-forced top-1 agreement "
          f"{rate_decisive} at decisive positions")
    check(deficit.max().item() <= 4, f"{tag}: a served token trails the "
          f"re-score's best by {deficit.max().item()} bf16 spacings")
    return dict(teacher_forced_top1=rate,
                teacher_forced_top1_decisive=rate_decisive,
                decisive_positions=int(decisive.sum().item()),
                max_deficit_bf16_spacings=deficit.max().item())


def bf16_spacing(x):
    """One bf16 spacing at |x| (f32 tensor)."""
    return torch.exp2(torch.floor(torch.log2(x.abs())) - 7)


def check_lengths(tag, reqs, gens, V):
    for (p, n, e), gen in zip(reqs, gens):
        check(((gen >= 0) & (gen < V)).all(), f"{tag}: token ids in vocab")
        hit = np.flatnonzero(gen == e) if e is not None else []
        want = int(hit[0]) + 1 if len(hit) else n
        check(len(gen) == want, f"{tag}: a request produced {len(gen)} "
              f"tokens, its budget {n} and eos {e} allow {want}")


def check_ring(tag, m, n_reqs):
    """Every admission went through the device ring: staged and spliced
    in once each, none by host scatter."""
    ring = m["admission_ring"]
    check(ring["host_scattered"] == 0, f"{tag}: host-scattered admissions")
    check(ring["staged"] == ring["scattered"] == n_reqs,
          f"{tag}: ring staged {ring['staged']}, scattered "
          f"{ring['scattered']}, {n_reqs} requests")


def prefill_graph_widths(dec, reqs, tag):
    """The buckets of the decoder's captured admission-prefill graphs: at
    most one graph per bucket the requests use."""
    from paddle_tpu_torch.serving import bucket_length
    widths = [k[2] for k, g in dec._prefill_graphs.items()
              if g is not None and k[0] == "ring"]
    used = {bucket_length(len(p)) for p, _, _ in reqs}
    check(len(widths) == len(set(widths)) and set(widths) <= used,
          f"{tag}: captured prefill graphs at buckets {widths}, the "
          f"requests use {sorted(used)}")
    return sorted(widths)


def profiled_info(info, prof, wall, steps, names):
    info.update(device_profile(prof, wall))
    info["wall_s"] = wall
    k_ms = kernel_ms(prof, names)
    for k in names:
        info[f"{k}_ms"] = k_ms.get(k, 0.0)
        info[f"{k}_ms_per_step"] = k_ms.get(k, 0.0) / steps
    return info


def serve(model, quant, reqs, V, card):
    """The 16 requests through ``ServingEngine`` with the chunk and each
    prompt bucket's admission prefill as replayed CUDA graphs: the first
    drain (a key's first call eager, its second captured) checked as
    below, a second drain timed and a third profiled, all with the same
    tokens. Then the same requests through an engine whose decoder runs
    its chunks eagerly (``eager_chunks``; its prefills are graphed too):
    the same tokens request by request, its drain timed and profiled.
    Returns the line and the served tokens."""
    from paddle_tpu_torch.inference.generate import LlamaDecoder
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.ops.kernels import int8_matmul as i8
    from paddle_tpu_torch.serving import ServingEngine, bucket_length

    t_start = time.perf_counter()
    cfg = model.config
    dec = LlamaDecoder(model, max_len=256, quant=quant)
    eng = ServingEngine(dec, num_slots=8, chunk_size=16)
    d0 = dec.dispatch_count
    torch.cuda.synchronize()
    da.launches = i8.launches = 0
    gens, first_wall, _ = drain(eng, reqs)
    n_da, n_i8 = da.launches, i8.launches
    m = eng.metrics()
    tag = quant or "none"

    check_lengths(tag, reqs, gens, V)
    check(m["corrupt_rows"] == 0, f"{tag}: non-finite logits in a row")
    check(m["prefill_dispatches"] == len(reqs), f"{tag}: one prefill each")
    check(dec.dispatch_count - d0
          == m["prefill_dispatches"] + m["chunk_dispatches"],
          f"{tag}: dispatch identity")
    check(sum(g is not None for g in dec._chunk_graphs.values()) == 1,
          f"{tag}: one captured chunk")
    check_ring(tag, m, len(reqs))
    steps = m["chunk_dispatches"] * eng.chunk_size
    L = cfg.num_hidden_layers
    check(n_da == L * steps,
          f"{tag}: decode_attention launches {n_da} != {L} x {steps}")
    small = sum(1 for p, _, _ in reqs if bucket_length(len(p)) <= 64)
    want_i8 = (4 * L + 1) * (steps + small) if quant else 0
    check(n_i8 == want_i8,
          f"{tag}: int8_matmul launches {n_i8} != {want_i8}")

    tf = teacher_forced(tag, dec, reqs, gens)

    def same(a_gens, what):
        for j, (a, b) in enumerate(zip(a_gens, gens)):
            check(np.array_equal(a, b), f"{tag}: request {j} {what} gave "
                  f"other tokens")

    again, wall, _ = drain(eng, reqs)
    same(again, "served again")
    again, pwall, prof = drain(eng, reqs, profile=True)
    same(again, "served under the profiler")
    widths = prefill_graph_widths(dec, reqs, tag)
    edec = eager_chunks(LlamaDecoder(model, max_len=256, quant=quant))
    eeng = ServingEngine(edec, num_slots=8, chunk_size=16)
    da.launches = i8.launches = 0
    egens, ewall, _ = drain(eeng, reqs)
    same(egens, "with the eager chunk")
    check((da.launches, i8.launches) == (n_da, n_i8),
          f"{tag}: eager launches {da.launches} / {i8.launches} != the "
          f"graph route's {n_da} / {n_i8}")
    again, epwall, eprof = drain(eeng, reqs, profile=True)
    same(again, "with the eager chunk under the profiler")
    chunks = m["chunk_dispatches"]
    n_tok = int(sum(len(g) for g in gens))
    info = dict(phase="serve", quant=tag, card=card, requests=len(reqs),
                tokens=n_tok, wall_s=wall, tokens_per_s=n_tok / wall,
                ms_per_chunk_incl_admission=1e3 * wall / chunks,
                first_drain_wall_s=first_wall,
                eager_wall_s=ewall, eager_tokens_per_s=n_tok / ewall,
                eager_ms_per_chunk_incl_admission=1e3 * ewall / chunks,
                prefill_dispatches=m["prefill_dispatches"],
                chunk_dispatches=chunks, decode_steps=steps,
                admission_ring=m["admission_ring"],
                prefill_graph_buckets=widths,
                decode_attention_launches=n_da, int8_matmul_launches=n_i8,
                tokens_equal_eager=True, **tf)
    names = ("int8_matmul", "decode_attention")
    info["profiled"] = profiled_info({}, prof, pwall, steps, names)
    info["profiled_eager"] = profiled_info({}, eprof, epwall, steps, names)
    info["phase_s"] = time.perf_counter() - t_start
    emit(info)
    del eeng, edec, eng, dec
    torch.cuda.empty_cache()
    return info, gens


def redraw_chunks(eng, top_k, top_p):
    """Hook ``eng``'s chunk dispatch to redraw, on the CPU and from plain
    versions, the first token of every row the chunk does not splice in
    (live, not done, not staged in the ring): the row's key split once,
    the second half's threefry bits over the vocabulary, uniforms on
    [tiny, 1) by the mantissa trick, gumbel noise plus the filtered
    logits, argmax. The carry's logits, keys and temperatures are copied
    off the card just before the chunk. A served token must be the
    redraw's or within 4 f32 spacings of its best perturbed logit.
    Returns the tally it fills in."""
    from paddle_tpu_torch.inference.generate import _filter_logits
    from paddle_tpu_torch.ops.kernels.threefry import threefry_words_ref
    tiny = float(np.finfo(np.float32).tiny)
    tally = dict(rows=0, differ=0, max_near_tie=0)
    dispatch = eng._dispatch_chunk

    def redrawn(occupied):
        st = eng.state
        staged = {m["slot"] for m in eng._ring_meta if m is not None}
        done = st.done.cpu().numpy()
        rows = [i for i, _ in eng.scheduler.slots.occupied()
                if i not in staged and not done[i]]
        if not rows:
            return dispatch(occupied)
        idx = torch.as_tensor(rows, device=st.logits.device)
        lg, keys, temp = (t[idx].cpu() for t in (st.logits, st.keys,
                                                 st.temp))
        toks = dispatch(occupied)
        sub = threefry_words_ref(keys, 2)[:, 1].contiguous()
        w = threefry_words_ref(sub, lg.shape[-1])
        bits = w[..., 0] ^ w[..., 1]
        u = ((((bits >> 9) & 0x7FFFFF) | 0x3F800000).view(torch.float32)
             - 1.0 + tiny).clamp(min=tiny)
        pert = -torch.log(-torch.log(u)) + _filter_logits(
            lg, temp[:, None], top_k, top_p)
        served = torch.as_tensor(toks[rows, 0])
        best = pert.max(-1).values
        got = pert.gather(1, served[:, None])[:, 0]
        # the card's logs and the CPU's may differ by an ulp: a gap of an
        # ulp of 1 in the noise, so ties are measured in f32 spacings of
        # max(|best|, 1)
        ulps = (best - got) / torch.from_numpy(np.spacing(
            np.maximum(best.abs().numpy(), 1.0).astype(np.float32)))
        differ = pert.argmax(-1) != served
        tally["rows"] += len(rows)
        tally["differ"] += int(differ.sum())
        if differ.any():
            worst = ulps[differ].max().item()
            tally["max_near_tie"] = max(tally["max_near_tie"],
                                             worst)
            check(worst <= 4, f"sampled: a served token is not the plain "
                  f"redraw's ({worst} f32 spacings below its best "
                  f"perturbed logit)")
        return toks

    eng._dispatch_chunk = redrawn
    return tally


def top50_gate(tag, logits, gens):
    """The gate of sampled tokens against their teacher-forced re-score
    (``logits``, per request): every drawn token inside the re-score's
    top 50, or within 4 bf16 spacings of its 50th logit. Returns the
    worst gap in bf16 spacings."""
    worst = -math.inf
    for j, (rows, g) in enumerate(zip(logits, gens)):
        tok = torch.as_tensor(g, device=rows.device)
        kth = rows.topk(50, dim=-1).values[:, -1]
        gap = (kth - rows.gather(1, tok[:, None])[:, 0]) / bf16_spacing(kth)
        worst = max(worst, gap.max().item())
        check(gap.max().item() <= 4, f"{tag}: request {j} drew a token "
              f"{gap.max().item()} bf16 spacings below the re-score's "
              f"50th logit")
    return worst


def serve_sampled(model, reqs, greedy, V, card):
    """The 16 requests, unquantized, through ``ServingEngine(do_sample=True,
    top_k=50, top_p=0.9)``: request j has seed 1000 + j and temperature
    0.7-1.0, request 0 temperature 1e-4. The first drain is checked
    (lengths, dispatch identity, one captured chunk, the ring, launches:
    two threefry a decode step), then every sampled token against a
    teacher-forced re-score (inside its top 50, or within 4 bf16 spacings
    of its 50th logit) and request 0 against the greedy drain's tokens (at
    a first difference the re-score's top two logits must be exactly
    equal). Served again, under the profiler, with every chunk's first
    draws redrawn on the CPU (``redraw_chunks``) and by an eager-chunk
    engine: the same tokens request by request."""
    from paddle_tpu_torch.inference.generate import LlamaDecoder
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.ops.kernels import int8_matmul as i8
    from paddle_tpu_torch.ops.kernels import threefry as tf
    from paddle_tpu_torch.serving import ServingEngine

    t_start = time.perf_counter()
    tag = "sampled"
    sampling = [(1000 + j, 1e-4 if j == 0 else 0.7 + 0.3 * j / 15)
                for j in range(len(reqs))]
    kw = dict(num_slots=8, chunk_size=16, do_sample=True, top_k=50,
              top_p=0.9)
    dec = LlamaDecoder(model, max_len=256)
    eng = ServingEngine(dec, **kw)
    d0 = dec.dispatch_count
    torch.cuda.synchronize()
    da.launches = i8.launches = tf.launches = 0
    gens, first_wall, _ = drain(eng, reqs, sampling=sampling)
    n_da, n_tf = da.launches, tf.launches
    m = eng.metrics()
    check_lengths(tag, reqs, gens, V)
    check(m["corrupt_rows"] == 0, f"{tag}: non-finite logits in a row")
    check(dec.dispatch_count - d0
          == m["prefill_dispatches"] + m["chunk_dispatches"],
          f"{tag}: dispatch identity")
    check(sum(g is not None for g in dec._chunk_graphs.values()) == 1,
          f"{tag}: one captured chunk")
    check_ring(tag, m, len(reqs))
    steps = m["chunk_dispatches"] * eng.chunk_size
    L = model.config.num_hidden_layers
    check(n_tf == 2 * steps, f"{tag}: threefry launches {n_tf} != 2 x "
          f"{steps}")
    check(n_da == L * steps, f"{tag}: decode_attention launches {n_da}")

    logits = rescore(dec, reqs, gens)
    worst = top50_gate(tag, logits, gens)
    g0, s0 = greedy[0], gens[0]
    n = min(len(g0), len(s0))
    diff = np.flatnonzero(g0[:n] != s0[:n])
    first_diff = None
    if len(diff):
        i = int(diff[0])
        top, top_ids = logits[0][i].topk(2)
        gap = ((top[0] - top[1]) / bf16_spacing(top[0])).item()
        first_diff = dict(position=i, greedy=int(g0[i]), sampled=int(s0[i]),
                          rescore_top2=top_ids.tolist(),
                          rescore_gap_bf16_spacings=gap)
        check(top[0].item() == top[1].item(), f"{tag}: temperature 1e-4 "
              f"left the greedy tokens at position {i}, where the "
              f"re-score's top two logits differ ({gap} bf16 spacings)")
    else:
        check(len(g0) == len(s0), f"{tag}: temperature 1e-4 gave "
              f"{len(s0)} tokens, greedy {len(g0)}")
    del logits

    def same(a_gens, what):
        for j, (a, b) in enumerate(zip(a_gens, gens)):
            check(np.array_equal(a, b), f"{tag}: request {j} {what} gave "
                  f"other tokens")

    again, wall, _ = drain(eng, reqs, sampling=sampling)
    same(again, "served again")
    again, pwall, prof = drain(eng, reqs, profile=True, sampling=sampling)
    same(again, "served under the profiler")
    tally = redraw_chunks(eng, kw["top_k"], kw["top_p"])
    again, _, _ = drain(eng, reqs, sampling=sampling)
    same(again, "with its draws redrawn")
    check(tally["rows"] >= len(reqs), f"{tag}: only {tally['rows']} draws "
          f"were redrawn")
    edec = eager_chunks(LlamaDecoder(model, max_len=256))
    eeng = ServingEngine(edec, **kw)
    tf.launches = 0
    egens, ewall, _ = drain(eeng, reqs, sampling=sampling)
    same(egens, "with the eager chunk")
    check(tf.launches == n_tf, f"{tag}: eager threefry launches "
          f"{tf.launches} != the graph route's {n_tf}")
    chunks = m["chunk_dispatches"]
    n_tok = int(sum(len(g) for g in gens))
    info = dict(phase="serve_sampled", quant="none", card=card,
                requests=len(reqs), top_k=50, top_p=0.9, tokens=n_tok,
                wall_s=wall, tokens_per_s=n_tok / wall,
                ms_per_chunk_incl_admission=1e3 * wall / chunks,
                first_drain_wall_s=first_wall, eager_wall_s=ewall,
                eager_tokens_per_s=n_tok / ewall,
                prefill_dispatches=m["prefill_dispatches"],
                chunk_dispatches=chunks, decode_steps=steps,
                admission_ring=m["admission_ring"],
                threefry_launches=n_tf, decode_attention_launches=n_da,
                tokens_equal_eager=True,
                temp_1e4_equals_greedy=not len(diff),
                temp_1e4_first_difference=first_diff,
                max_top50_gap_bf16_spacings=worst,
                redrawn_draws=tally["rows"],
                redrawn_near_ties=tally["differ"],
                redrawn_max_near_tie_f32_spacings=tally["max_near_tie"])
    info["profiled"] = profiled_info({}, prof, pwall, steps,
                                     ("threefry", "decode_attention"))
    info["phase_s"] = time.perf_counter() - t_start
    emit(info)
    del eeng, edec, eng, dec
    torch.cuda.empty_cache()
    return info, gens


def serving_model(layers: int = 12):
    """The serving lines' model: the GQA Llama (vocab 32000, hidden 768,
    12 layers, 12 heads, 4 KV heads, bf16) with random weights from seed
    0, on the card; ``layers`` cuts its depth (the LoRA line's)."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(vocab_size=32000, hidden_size=768,
                      intermediate_size=2048, num_hidden_layers=layers,
                      num_attention_heads=12, num_key_value_heads=4,
                      max_position_embeddings=1024, dtype="bfloat16")
    return LlamaForCausalLM(cfg, seed=0)


def serving_inputs():
    """The serving lines' model (``serving_model``) and traffic: 16
    requests of 16-128 prompt tokens and 32-96 new ones (seed 0), every
    fourth stopping at an eos its greedy stream reaches. Returns
    ``(model, reqs)``, each request ``(prompt, budget, eos or None)``."""
    from paddle_tpu_torch.inference.generate import LlamaDecoder

    model = serving_model()
    cfg = model.config
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, cfg.vocab_size, int(rng.integers(16, 129))),
             int(rng.integers(32, 97)), None) for _ in range(16)]
    ref = LlamaDecoder(model, max_len=256)
    for j in range(1, 16, 4):
        p, n, _ = reqs[j]
        out = np.asarray(ref.generate(p[None], n))[0]
        reqs[j] = (p, n, int(out[len(p) + n // 2]))
    del ref
    return model, reqs


def serving_phase(card):
    """The serving lines on one model: greedy unquantized and int8wk,
    then sampled; ``serve_prefix``, unquantized and int8wk;
    ``serve_spec``; ``serve_lora``, unquantized and int8wk;
    ``serve_snapshot``, unquantized and int8wk; ``serve_faults``,
    unquantized and int8wk; the router, HTTP and cluster lines; and
    ``serve_bundle``."""
    model, reqs = serving_inputs()
    cfg = model.config
    runs, plain = [], {}
    for q in (None, "int8wk"):
        info, plain[q] = serve(model, q, reqs, cfg.vocab_size, card)
        runs.append(info)
    sampled, sampled_gens = serve_sampled(model, reqs, plain[None],
                                          cfg.vocab_size, card)
    prefix = [serve_prefix(model, q, card) for q in (None, "int8wk")]
    spec = serve_spec(model, card)
    # the LoRA line comes after every earlier line, so their inputs and
    # random streams are those they had before it; it runs at 6 of the
    # model's 12 layers (its own plain twin holds its base rows), for the
    # script's time
    lora_model = serving_model(layers=6)
    lora = [serve_lora(lora_model, q, reqs, card) for q in (None, "int8wk")]
    del lora_model
    # the snapshot line comes after the LoRA line, for the same reason
    snap = [serve_snapshot(model, q, reqs, plain[q], info,
                           sampled_gens if q is None else None, card)
            for q, info in zip((None, "int8wk"), runs)]
    # and the fault line after the snapshot line
    faults = [serve_faults(model, q, reqs, plain[q], info, spec, card)
              for q, info in zip((None, "int8wk"), runs)]
    # the router, HTTP and cluster lines last of all
    fleet = [serve_router(model, q, reqs, plain[q], info,
                          sampled_gens if q is None else None, card)
             for q, info in zip((None, "int8wk"), runs)]
    fleet.append(serve_http(model, reqs, plain[None], runs[0], card))
    fleet.append(serve_cluster(model, reqs, plain[None], runs[0], card))
    # and the bundle line after them
    bundle = serve_bundle(model, reqs, plain, dict(zip((None, "int8wk"),
                                                      runs)), card)
    return runs, sampled, prefix, spec, lora, snap, faults, fleet, bundle


# -- replicated serving, the HTTP front-end and the cluster --------------

# the router drill of bench.py:1634-1821 on the port's injector: replica1's
# chunk dies fatally from its second call (and its rung with it), and
# replica2's heartbeat misses a window of beats
ROUTER_PLAN = [
    {"kind": "dispatch_error", "site": "serving.replica1.chunk",
     "call": 2, "times": 10**9, "code": "INTERNAL"},
    {"kind": "dispatch_error", "site": "serving.replica1.step",
     "call": 1, "times": 10**9, "code": "INTERNAL"},
    {"kind": "delay_heartbeat", "node": "replica2", "after_beats": 2,
     "skip_beats": 4}]


def fleet_drain(router, reqs, kws=None, on_step=None):
    """Submit ``reqs`` to a ``Router`` or ``ClusterRouter`` and step it
    until nothing is in flight. Returns ``(rids, outcomes by rid, seconds
    from the first submit to each outcome, wall s)``; ``on_step(n, t0)``
    runs after step ``n``."""
    kws = kws or [{}] * len(reqs)
    t0 = time.perf_counter()
    rids = [router.submit(p, n, eos_token_id=e, **kw)
            for (p, n, e), kw in zip(reqs, kws)]
    outs, fin, n = {}, {}, 0
    while (router.in_flight() if hasattr(router, "in_flight") else
           any(r.has_work() for r in router.replicas.live())):
        for rid, res in router.step():
            outs[rid] = res
            fin[rid] = time.perf_counter() - t0
        n += 1
        if on_step is not None:
            on_step(n, t0)
    torch.cuda.synchronize()
    return rids, outs, fin, time.perf_counter() - t0


def fleet_tokens(tag, reqs, rids, outs, route_key):
    """Every request resolved to tokens (none lost, none a typed error):
    the served tokens per request and which rows were moved (requeued or
    replayed), from each result's record under ``route_key``."""
    gens, moved = [], []
    for j, ((p, _, _), rid) in enumerate(zip(reqs, rids)):
        out = outs.get(rid)
        check(out is not None, f"{tag}: request {j} lost")
        check(not isinstance(out, BaseException),
              f"{tag}: request {j} resolved to {out!r}")
        seq = np.asarray(out).reshape(-1)
        check(np.array_equal(seq[:len(p)], p), f"{tag}: prompt echoed")
        gens.append(seq[len(p):])
        rec = (getattr(out, "resilience", None) or {}).get(route_key) or {}
        if rec.get("requeues") or rec.get("replayed_tokens"):
            moved.append(j)
    return gens, moved


def hold_fleet(tag, dec, reqs, gens, want, moved, sampled=False):
    """The rows no fault moved ran the reference's route: bit for bit.
    The moved rows re-prefilled ``prompt + tokens so far`` (the S > 1
    route) and are held by ``hold_to``'s gates (ROADMAP §3 entry 32)."""
    for j, (a, b) in enumerate(zip(gens, want)):
        if j not in moved:
            check(np.array_equal(a, b), f"{tag}: request {j}, never "
                  f"moved, differs from the reference")
    rec = hold_to(tag, dec, [reqs[j] for j in moved],
                  [gens[j] for j in moved], [want[j] for j in moved],
                  sampled=sampled)
    rec.update(moved=len(moved), rows_bit_equal=sum(
        np.array_equal(a, b) for a, b in zip(gens, want)))
    return rec


def serve_router(model, quant, reqs, plain_gens, plain_info, sampled_gens,
                 card):
    """The router line: ``ReplicaSet.from_backends`` over 3 replicas
    (8 slots, chunk 16, max_len 256, graphed chunks and prefills) and
    ``Router(breaker_threshold=2)``, the 16 requests under ``ROUTER_PLAN``
    (backoff 0): no request lost, replica1 dead with one death, at least
    one requeue, replica2 suspect and recovered. Unmoved rows equal the
    plain line bit for bit; requeued rows pass the decisive gate.
    Unquantized it then runs the sampled line's 16 requests under
    ``request_keyed_rng`` twice, undisturbed and under the plan: the
    unmoved rows equal, the requeued ones pass the top-50 gate. Prints
    tokens/s against the plain line, p99 latency, the requeues and the ms
    of the step that opened the breaker and requeued."""
    from paddle_tpu_torch.inference.generate import LlamaDecoder
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.ops.kernels import int8_matmul as i8
    from paddle_tpu_torch.ops.kernels import threefry as tf
    from paddle_tpu_torch.runtime.resilience import fault_injector
    from paddle_tpu_torch.serving import ReplicaSet, Router

    t_start = time.perf_counter()
    tag = f"serve_router {quant or 'none'}"
    V = model.config.vocab_size

    def router(**kw):
        decs = [LlamaDecoder(model, max_len=256, quant=quant)
                for _ in range(3)]
        return decs, Router(ReplicaSet.from_backends(
            decs, num_slots=8, chunk_size=16, **kw), breaker_threshold=2)

    def drill(rt, kws=None, plan=ROUTER_PLAN):
        seen = {"suspect": False, "requeue_ms": None}
        last = {"t": time.perf_counter(), "requeued": 0}

        def on_step(n, t0):
            now = time.perf_counter()
            q = rt.metrics()["requeued"]
            if q > last["requeued"] and seen["requeue_ms"] is None:
                seen["requeue_ms"] = 1e3 * (now - last["t"])
            last.update(t=now, requeued=q)
            seen["suspect"] |= rt.replicas.replicas[2].state == "suspect"

        with flags_set({"resilience_backoff_s": 0.0}):
            fault_injector.configure(plan)
            try:
                rids, outs, fin, wall = fleet_drain(rt, reqs, kws, on_step)
                for _ in range(8):      # idle beats end the skip window
                    rt.step()
            finally:
                fault_injector.clear()
        return rids, outs, fin, wall, seen

    decs, rt = router()
    torch.cuda.synchronize()
    da.launches = i8.launches = tf.launches = 0
    rids, outs, fin, wall, seen = drill(rt)
    n_da, n_i8, n_tf = da.launches, i8.launches, tf.launches
    m = rt.metrics()
    gens, moved = fleet_tokens(tag, reqs, rids, outs, "router")
    check_lengths(tag, reqs, gens, V)
    check(m["states"]["replica1"] == "dead" and m["replica_deaths"] == 1,
          f"{tag}: replica states {m['states']}")
    check(m["requeued"] >= 1 and moved, f"{tag}: no requeue")
    check(seen["suspect"] and m["states"]["replica2"] == "healthy",
          f"{tag}: replica2 suspect {seen['suspect']}, then "
          f"{m['states']['replica2']}")
    check(m["submitted"] == m["completed"] == len(reqs)
          and m["dead_letter"] == 0, f"{tag}: accounting {m}")
    held = hold_fleet(tag, decs[0], reqs, gens, plain_gens, moved)
    n_tok = int(sum(len(g) for g in gens))
    info = dict(phase="serve_router", quant=quant or "none", card=card,
                replicas=3, requests=len(reqs), tokens=n_tok, wall_s=wall,
                tokens_per_s=n_tok / wall,
                plain_tokens_per_s=plain_info["tokens_per_s"],
                ratio_to_plain=n_tok / wall / plain_info["tokens_per_s"],
                latency_p99_s=float(np.percentile(list(fin.values()), 99)),
                requeued=m["requeued"], requeue_step_ms=seen["requeue_ms"],
                replica_deaths=m["replica_deaths"],
                heartbeat_suspects=m["heartbeat_suspects"],
                states=m["states"], held=held,
                decode_attention_launches=n_da, int8_matmul_launches=n_i8,
                threefry_launches=n_tf)
    del rt, decs
    torch.cuda.empty_cache()
    if quant is None and sampled_gens is not None:
        # sampled requeue: each row's key is derived from (seed, the
        # router's request id, the tokens it already emitted)
        sampling = [dict(seed=1000 + j, temperature=0.8)
                    for j in range(len(reqs))]
        kw = dict(do_sample=True, top_k=50, top_p=0.9,
                  request_keyed_rng=True)
        decs, rt = router(**kw)
        rrids, ref_outs, _, _, _ = drill(rt, sampling, plan=[])
        ref, _ = fleet_tokens(f"{tag} keyed", reqs, rrids, ref_outs,
                              "router")
        del rt
        decs, rt = router(**kw)
        da.launches = tf.launches = 0
        rids, outs, _, swall, _ = drill(rt, sampling)
        info["decode_attention_launches"] += da.launches
        info["threefry_launches"] += tf.launches
        sgens, smoved = fleet_tokens(f"{tag} keyed", reqs, rids, outs,
                                     "router")
        check(smoved, f"{tag} keyed: no requeue")
        info["sampled_keyed"] = dict(
            wall_s=swall, requeued=rt.metrics()["requeued"],
            held=hold_fleet(f"{tag} keyed", decs[0], reqs, sgens, ref,
                            smoved, sampled=True))
        del rt, decs
        torch.cuda.empty_cache()
    info["phase_s"] = time.perf_counter() - t_start
    emit(info)
    return info


def serve_http(model, reqs, plain_gens, plain_info, card):
    """The HTTP line: ``HttpFrontend`` on port 0 over a graphed 8-slot
    engine (chunk 16), the 16 requests sent at once from 16 client
    threads, every other one streamed, while a scraper thread reads
    ``/metrics`` and ``/statusz`` in a loop through the first, capturing
    chunks. Each stream's lines concatenate to its result's tokens bit
    for bit; the tokens are held to the plain line; the typed refusals
    answer 404 / 429 / 400 / 400 and a drain 503. Prints tokens/s against
    the plain line and the streams' first-line p50."""
    import threading
    import urllib.error
    import urllib.request

    from paddle_tpu_torch.inference.generate import LlamaDecoder
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.ops.kernels import int8_matmul as i8
    from paddle_tpu_torch.ops.kernels import threefry as tf
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.serving.http import HttpFrontend

    t_start = time.perf_counter()
    tag = "serve_http"
    dec = LlamaDecoder(model, max_len=256)
    eng = ServingEngine(dec, num_slots=8, chunk_size=16)
    fe = HttpFrontend(eng, port=0)
    base = f"http://127.0.0.1:{fe.start()}"

    def post(body):
        req = urllib.request.Request(
            base + "/v1/generate", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        t0 = time.perf_counter()
        try:
            r = urllib.request.urlopen(req, timeout=600)
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read() or b"{}"), None
        if not body.get("stream"):
            return r.status, json.loads(r.read()), None
        lines, first = [], None
        for ln in iter(r.readline, b""):
            if ln.strip():
                first = first or time.perf_counter() - t0
                lines.append(json.loads(ln))
        return r.status, lines, first

    stop, scrapes, errs = threading.Event(), [0], []

    def scrape():
        # every 20 ms, a far faster cadence than a fleet scraper's: the
        # point is to land scrapes inside the first chunks' captures
        while not stop.wait(0.02):
            for path in ("/metrics", "/statusz"):
                try:
                    urllib.request.urlopen(base + path, timeout=30).read()
                    scrapes[0] += 1
                except Exception as e:      # noqa: BLE001
                    errs.append(repr(e))

    scraper = threading.Thread(target=scrape, daemon=True)
    res = [None] * len(reqs)

    def client(j):
        p, n, e = reqs[j]
        res[j] = post({"prompt": p.tolist(), "max_new_tokens": int(n),
                       "eos_token_id": e, "stream": j % 2 == 0})

    torch.cuda.synchronize()
    da.launches = i8.launches = tf.launches = 0
    scraper.start()
    try:
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(j,))
                   for j in range(len(reqs))]
        for c in clients:
            c.start()
        for c in clients:
            c.join()
        wall = time.perf_counter() - t0
    finally:
        stop.set()
        scraper.join(timeout=60)
    n_da, n_i8, n_tf = da.launches, i8.launches, tf.launches
    check(not errs and scrapes[0] > 0, f"{tag}: scrapes {scrapes[0]}, "
          f"errors {errs[:3]}")
    gens, firsts = [], []
    for j, ((p, _, _), (code, doc, first)) in enumerate(zip(reqs, res)):
        check(code == 200, f"{tag}: request {j} answered {code}: {doc}")
        if j % 2 == 0:
            check(doc[-1].get("final") is True and "error" not in doc[-1],
                  f"{tag}: stream {j} trailer {doc[-1]}")
            streamed = sum((ln["tokens"] for ln in doc), [])
            out = np.asarray(eng.result(doc[-1]["request_id"])).reshape(-1)
            check(streamed == out[len(p):].tolist(), f"{tag}: stream {j}'s "
                  f"lines are not its result's tokens")
            gens.append(np.asarray(streamed, np.int64))
            firsts.append(first)
        else:
            gens.append(np.asarray(doc["generated"], np.int64))
    check_lengths(tag, reqs, gens, model.config.vocab_size)
    held = hold_to(tag, dec, reqs, gens, plain_gens)
    held["rows_bit_equal"] = sum(np.array_equal(a, b)
                                 for a, b in zip(gens, plain_gens))
    p = reqs[0][0].tolist()
    refusals = {
        "unknown_model": post({"prompt": p, "model": "nope"})[:2],
        "deadline": post({"prompt": p, "deadline_s": -1.0})[:2],
        "no_prompt": post({"max_new_tokens": 4})[:2],
        "unknown_adapter": post({"prompt": p, "adapter": "ghost"})[:2]}
    got = {k: (c, d.get("kind")) for k, (c, d) in refusals.items()}
    check(got == {"unknown_model": (404, "unknown_model"),
                  "deadline": (429, "shed"),
                  "no_prompt": (400, "bad_request"),
                  "unknown_adapter": (400, "unknown_adapter")},
          f"{tag}: refusals {got}")
    check(fe.drain(timeout_s=60), f"{tag}: drain")
    code, doc, _ = post({"prompt": p, "max_new_tokens": 4})
    check((code, doc.get("kind")) == (503, "draining"),
          f"{tag}: after the drain {code} {doc}")
    fe.stop()
    n_tok = int(sum(len(g) for g in gens))
    info = dict(phase="serve_http", card=card, requests=len(reqs),
                streams=len(firsts), tokens=n_tok, wall_s=wall,
                tokens_per_s=n_tok / wall,
                plain_tokens_per_s=plain_info["tokens_per_s"],
                ratio_to_plain=n_tok / wall / plain_info["tokens_per_s"],
                stream_first_line_p50_s=float(np.median(firsts)),
                scrapes_during_run=scrapes[0], refusals=got, held=held,
                chunk_graphs=sum(g is not None
                                 for g in dec._chunk_graphs.values()),
                decode_attention_launches=n_da, int8_matmul_launches=n_i8,
                threefry_launches=n_tf)
    check(info["chunk_graphs"] == 1, f"{tag}: no captured chunk")
    del fe, eng, dec
    torch.cuda.empty_cache()
    info["phase_s"] = time.perf_counter() - t_start
    emit(info)
    return info


def card_memory():
    """The card's total and used memory (MiB) from ``nvidia-smi``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.total,memory.used",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    total, used = (int(x) for x in out.split(","))
    return dict(total_mib=total, used_mib=used)


def worker_launches(status):
    """One worker's kernel launches from its ``status``, by kernel."""
    return {k: int(status["launches"].get(f"{k}.launches", 0))
            for k in ("decode_attention", "int8_matmul", "threefry")}


def wait_gone(router, name, timeout=30.0):
    """Block until ``name`` leaves the router's elastic membership (its
    heartbeat TTL lapsed)."""
    t0 = time.perf_counter()
    while name in router.elastic.members:
        check(time.perf_counter() - t0 < timeout,
              f"{name} still a member {timeout} s after its kill")
        time.sleep(0.01)


def kill_drill(cl, name, seen, at_step=2):
    """An ``on_step`` for ``fleet_drain``: after step ``at_step``, with
    more than one request in flight, read every worker's status, SIGKILL
    ``name`` and wait for its heartbeat to lapse. ``seen`` collects the
    kill's time on both clocks (perf_counter, monotonic), the lapse's and
    the statuses."""
    router = cl.router

    def on_step(n, t0):
        seen.setdefault("t0", t0)
        if "killed" not in seen and n >= at_step and router.in_flight() > 1:
            seen["pre_kill"] = {h.name: router._call(h, "status")
                                for h in router.workers}
            seen["killed"] = time.perf_counter()
            seen["killed_mono"] = time.monotonic()
            cl.kill(name)
            wait_gone(router, name)
            seen["ttl_lapsed"] = time.perf_counter()
    return on_step


def kill_times(tag, router, name, seen, fin, rids, moved):
    """Kill to TTL lapse; kill to the router's verdict, which
    ``_declare_dead`` stamps on the handle (monotonic) before it recovers
    anything; the recovery itself (the requeue of every row, or the
    restart); and the verdict to the last token of a moved request, in
    ms."""
    h = next(h for h in router.workers if h.name == name)
    check(h.dead_at is not None and h.recovery_s is not None
          and h.dead_at >= seen["killed_mono"],
          f"{tag}: the kill was never detected")
    detect = h.dead_at - seen["killed_mono"]
    done = seen["t0"] + max(fin[rids[j]] for j in moved)
    return dict(kill_to_ttl_lapse_ms=1e3 * (seen["ttl_lapsed"]
                                            - seen["killed"]),
                kill_to_detect_ms=1e3 * detect,
                recovery_ms=1e3 * h.recovery_s,
                detect_to_done_ms=1e3 * (done - seen["killed"] - detect))


def serve_cluster(model, reqs, plain_gens, plain_info, card):
    """The cluster line: ``launch_cluster(prefill=1, decode=2)`` on the
    card (8-slot decode engines with the prefix cache, chunk 16, max_len
    256, heartbeat 0.4 s, TTL 2 s), the 16 requests, and a real SIGKILL of
    decode0 after the second step with work in flight. Every worker is a
    distinct process, no request is lost, prefill dispatches run only on
    prefill0 and chunks only on the decode workers, both decode workers
    launched decode attention and prefill0 did not, and the fleet
    ``/metrics`` carries ``{worker=...}`` labels. Then ``recover=
    "restart"`` (one decode worker snapshotting every chunk, killed after
    two steps, respawned from its snapshot, 8 requests) and, in a thread
    beside it, ``run_frontend_failover_drill`` (the 16 requests on one
    8-slot decode worker, chunk 16, so 8 wait queued; the frontend
    SIGKILLed at its ready barrier, a WAL resume, a stale-epoch probe). A
    disaggregated or replayed row admits by slab, not through the plain
    line's ring: every row is held by ``hold_to`` (bit-equal rows
    counted). Prints the spawn s (the three workers start together),
    each worker's reserved memory and the card's with them alive, the RPC
    round trip, the kill's times (to the verdict stamped on the handle,
    the recovery, the verdict to the last moved token) and tokens/s."""
    import os
    import statistics
    import threading
    import urllib.request

    from paddle_tpu_torch.inference.generate import LlamaDecoder
    from paddle_tpu_torch.serving import launch_cluster
    from paddle_tpu_torch.serving.cluster.frontend_proc import \
        run_frontend_failover_drill

    t_start = time.perf_counter()
    tag = "serve_cluster"
    V = model.config.vocab_size
    ref_dec = LlamaDecoder(model, max_len=256)
    info = dict(phase="serve_cluster", card=card, requests=len(reqs),
                plain_tokens_per_s=plain_info["tokens_per_s"])
    kw = dict(max_len=256, engine_kw={"num_slots": 8, "chunk_size": 16},
              heartbeat_s=0.4, ttl_s=2.0, heartbeat_miss_threshold=1,
              rpc_timeout_s=120.0)

    t0 = time.perf_counter()
    with launch_cluster(model, snapshot_dir("cluster"), prefill=1,
                        decode=2, **kw) as cl:
        info["spawn_s"] = time.perf_counter() - t0
        router = cl.router
        pids = {h.name: h.pid for h in router.workers}
        check(len(set(pids.values())) == 3
              and os.getpid() not in pids.values(),
              f"{tag}: worker pids {pids}")
        for pid in pids.values():
            os.kill(pid, 0)
        rtt = []
        for _ in range(5):
            for h in router.workers:
                t1 = time.perf_counter()
                router._call(h, "ping")
                rtt.append(1e3 * (time.perf_counter() - t1))
        info["rpc_round_trip_ms"] = dict(
            p50=statistics.median(rtt), min=min(rtt), max=max(rtt),
            calls=len(rtt))
        for h in router.workers:
            router._call(h, "reset_launches")
        port = router.start_exporter(port=0)
        seen = {}
        kill = kill_drill(cl, "decode0", seen)

        def on_step(n, t0):
            if "fleet" not in seen and n >= 2:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/metrics",
                        timeout=30) as r:
                    seen["fleet"] = r.read().decode()
            kill(n, t0)

        rids, outs, fin, wall = fleet_drain(router, reqs, on_step=on_step)
        m, wm = router.metrics(), router.worker_metrics()
        post = {h.name: router._call(h, "status") for h in router.workers
                if h.state != "dead"}
        info["card_memory"] = card_memory()
        router.stop_exporter()
    gens, moved = fleet_tokens(tag, reqs, rids, outs, "cluster")
    check_lengths(tag, reqs, gens, V)
    check(m["states"]["decode0"] == "dead" and m["worker_deaths"] == 1
          and m["requeued"] >= 1 and moved, f"{tag}: {m}")
    check(wm["prefill0"]["chunk_dispatches"] == 0
          and wm["prefill0"]["prefill_dispatches"] > 0
          and wm["decode1"]["prefill_dispatches"] == 0
          and wm["decode1"]["chunk_dispatches"] > 0,
          f"{tag}: dispatch split {wm}")
    check(m["disaggregated_admissions"] >= len(reqs), f"{tag}: {m}")
    statuses = {"prefill0": post["prefill0"],
                "decode0": seen["pre_kill"]["decode0"],
                "decode1": post["decode1"]}
    lw = {n: worker_launches(st) for n, st in statuses.items()}
    check(lw["decode0"]["decode_attention"] > 0
          and lw["decode1"]["decode_attention"] > 0
          and lw["prefill0"]["decode_attention"] == 0,
          f"{tag}: decode-attention launches by worker {lw}")
    for name in pids:
        check(f'worker="{name}"' in seen["fleet"],
              f"{tag}: fleet /metrics has no {name} samples")
    held = hold_to(tag, ref_dec, reqs, gens, plain_gens)
    held.update(moved=len(moved), rows_bit_equal=sum(
        np.array_equal(a, b) for a, b in zip(gens, plain_gens)))
    n_tok = int(sum(len(g) for g in gens))
    info.update(
        workers={n: dict(pid=pids[n], role=st["role"],
                         memory_reserved_mib=st["memory_reserved"] / 2**20)
                 for n, st in statuses.items()},
        tokens=n_tok, wall_s=wall,
        tokens_per_s=n_tok / wall,
        ratio_to_plain=n_tok / wall / plain_info["tokens_per_s"],
        latency_p99_s=float(np.percentile(list(fin.values()), 99)),
        requeued=m["requeued"], states=m["states"],
        disaggregated_admissions=m["disaggregated_admissions"],
        worker_dispatches={n: {k: w.get(k) for k in (
            "prefill_dispatches", "chunk_dispatches")}
            for n, w in wm.items() if "error" not in w},
        launches_by_worker=lw, held=held,
        **kill_times(tag, router, "decode0", seen, fin, rids, moved))
    for k in ("decode_attention", "int8_matmul", "threefry"):
        info[f"{k}_launches"] = sum(x[k] for x in lw.values())

    # the frontend's own death, beside recover="restart" (each has its
    # own store daemon, workers and frontend, and both wait on RPCs, so
    # together they take about the longer one's time): the 16 requests on
    # one 8-slot decode worker (so 8 wait queued at the ready barrier),
    # the frontend SIGKILLed there, a WAL resume, the stale epoch fenced
    dreqs = [{"tag": f"req{j}", "prompt": p.tolist(),
              "max_new_tokens": int(n),
              "eos_token_id": None if e is None else int(e)}
             for j, (p, n, e) in enumerate(reqs)]
    drill = {}

    def failover():
        t1 = time.perf_counter()
        try:
            drill.update(run_frontend_failover_drill(
                model, snapshot_dir("frontend_failover"), kill=True,
                decode=1, num_slots=8, chunk_size=16, max_len=256,
                requests=dreqs))
        except BaseException as e:      # raised again after the join
            drill["error"] = e
        drill["wall_s"] = time.perf_counter() - t1

    side = threading.Thread(target=failover)
    side.start()
    # recover="restart": the killed rank respawns from its snapshot
    sub = reqs[:8]
    t0 = time.perf_counter()
    try:
        with launch_cluster(model, snapshot_dir("cluster_restart"),
                            prefill=0, decode=1, snapshot_every_chunks=1,
                            recover="restart", **kw) as cl:
            spawn = time.perf_counter() - t0
            seen = {}
            rids, outs, fin, wall = fleet_drain(
                cl.router, sub, on_step=kill_drill(cl, "decode0", seen))
            m = cl.router.metrics()
    finally:
        side.join()
    if "error" in drill:
        raise drill["error"]
    gens, moved = fleet_tokens(f"{tag} restart", sub, rids, outs,
                               "cluster")
    check(m["worker_restarts"] >= 1 and m["states"]["decode0"] ==
          "healthy", f"{tag} restart: {m}")
    held = hold_to(f"{tag} restart", ref_dec, sub, gens, plain_gens[:8])
    held["rows_bit_equal"] = sum(np.array_equal(a, b) for a, b in
                                 zip(gens, plain_gens))
    info["restart"] = dict(
        spawn_s=spawn, wall_s=wall, worker_restarts=m["worker_restarts"],
        requests_resumed=m["requests_resumed"], requeued=m["requeued"],
        held=held, **(kill_times(f"{tag} restart", cl.router, "decode0",
                                 seen, fin, rids, list(range(len(sub))))))

    ready, rep = drill["ready"], drill["recovery"]
    check(ready["occupied"] >= 2 and ready["queued"] >= 2,
          f"{tag}: the ready barrier held {ready}")
    check(drill["zombie_error"] == "StaleEpochError",
          f"{tag}: the stale epoch probe got {drill['zombie_error']}")
    check(drill["epoch"] > ready["epoch"], f"{tag}: epoch {drill['epoch']}")
    check(rep["finished_in_wal"] + rep["finished_in_gap"] + rep["resumed"]
          + rep["replayed"] == len(dreqs) and rep["resumed"] >= 1,
          f"{tag}: recovery {rep}")
    dgens = []
    for r in dreqs:
        out = drill["outcomes"][r["tag"]]
        check("tokens" in out, f"{tag}: {r['tag']} resolved to {out}")
        seq = np.asarray(out["tokens"]).reshape(-1)
        dgens.append(seq[len(r["prompt"]):])
    check_lengths(f"{tag} failover", reqs, dgens, V)
    held = hold_to(f"{tag} failover", ref_dec, reqs, dgens, plain_gens)
    held["rows_bit_equal"] = sum(np.array_equal(a, b)
                                 for a, b in zip(dgens, plain_gens))
    info["frontend_failover"] = dict(
        wall_s=drill["wall_s"], requests=len(dreqs), ready=ready,
        recovery=rep, epoch=drill["epoch"],
        zombie_error=drill["zombie_error"], held=held)
    del ref_dec
    torch.cuda.empty_cache()
    info["phase_s"] = time.perf_counter() - t_start
    emit(info)
    return info


# -- AOT bundles ------------------------------------------------------------

def bundle_dir(name):
    """A fresh directory for one exported bundle under the checkout's
    ``build/`` (``.gitignore`` lists it)."""
    import os
    import shutil
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "bundles", name)
    shutil.rmtree(d, ignore_errors=True)
    return d


def bundle_launches():
    """The three served kernels' launch counters, now."""
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.ops.kernels import int8_matmul as i8
    from paddle_tpu_torch.ops.kernels import threefry as tf
    return np.array([da.launches, i8.launches, tf.launches])


def timed_export(dec, d, **kw):
    """``export_decoder_bundle`` into ``d``: (seconds, bytes an entry)."""
    import os

    from paddle_tpu_torch.inference import export_decoder_bundle
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    export_decoder_bundle(dec, d, **kw)
    s = time.perf_counter() - t0
    sizes = {f: os.path.getsize(os.path.join(d, f))
             for f in sorted(os.listdir(d)) if f.endswith(".aot")}
    return s, sizes


def timed_load(pred):
    """Load and verify every entry of ``pred``'s bundle: seconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in pred.meta["manifest"]:
        pred._entry(f)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def functional_cache_bytes(program):
    """What a loaded step program's cache writes move beyond the eager
    decoder's in-place writes: ``torch.export`` may record an in-place
    write into an input as an out-of-place ``index_put`` / ``*_scatter``
    node plus a ``copy_`` back into the input, each reading and writing
    its whole output once. Returns (those bytes, the in-place writes the
    program kept), counted from the loaded program's graph."""
    functional = ("aten.index_put.default", "aten.select_scatter.default",
                  "aten.slice_scatter.default")
    total = in_place = 0
    for n in program.graph.nodes:
        val = n.meta.get("val")
        if n.op != "call_function" or not isinstance(val, torch.Tensor):
            continue
        target = str(n.target)
        if target in functional or (target == "aten.copy_.default"
                                    and n.args[0].op == "placeholder"):
            total += 2 * val.numel() * val.element_size()
        elif target == "aten.index_put_.default":
            in_place += 1
    return total, in_place


# the bundles of the bundle line: name -> (quant recipe, export arguments);
# serve_bundle exports them side by side, one process each
BUNDLE_JOBS = {
    "serve_none": (None, dict(prompt_lens=[128], decode_steps=[95, 31],
                              batch_sizes=[8], chunk_sizes=[16])),
    "serve_int8wk": ("int8wk", dict(prompt_lens=[128], decode_steps=[],
                                    batch_sizes=[8], chunk_sizes=[16])),
    "decode_int8w": ("int8w", dict(prompt_lens=[128], decode_steps=[95, 31],
                                   batch_sizes=[8])),
    "sampled": (None, dict(prompt_lens=[128], decode_steps=[31],
                           batch_sizes=[8], do_sample=True, top_k=50,
                           top_p=0.9)),
    "spec": (None, dict(prompt_lens=[128], decode_steps=[32],
                        batch_sizes=[8], draft_model="skip:3",
                        num_speculative_tokens=4)),
}


def export_job(job):
    """One bundle export of the serving lines' model (the same weights as
    the calling process's: the same seed on the same card) in a process
    of its own; prints one JSON line with its seconds and entry bytes."""
    from paddle_tpu_torch.inference.generate import LlamaDecoder
    dec = LlamaDecoder(serving_model(), max_len=256, quant=job["quant"])
    s, sizes = timed_export(dec, job["dir"], **job["kw"])
    print(json.dumps({"export_s": s, "entry_bytes": sizes}), flush=True)


def start_exports(jobs):
    """Start one export process a bundle of ``jobs``, all at once (an
    export is a single-threaded trace and a serialization); returns
    ``{name: (dir, process)}``."""
    import os
    root = os.path.dirname(os.path.abspath(__file__))
    code = ("import json, sys\nsys.path.insert(0, sys.argv[1])\n"
            "import chip_smoke\nchip_smoke.export_job(json.loads(sys.argv[2]))")
    procs = {}
    for name, (quant, kw) in jobs.items():
        d = bundle_dir(name)
        procs[name] = (d, subprocess.Popen(
            [sys.executable, "-c", code, root,
             json.dumps({"quant": quant, "kw": kw, "dir": d})],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def export_result(procs, name):
    """Wait for ``name``'s export process: ``{"dir", "export_s",
    "entry_bytes"}``."""
    d, p = procs[name]
    so, se = p.communicate(timeout=900)
    check(p.returncode == 0, f"export {name}: {se[-3000:]}")
    return dict(json.loads(so.strip().splitlines()[-1]), dir=d)


def serve_bundle(model, reqs, plain_gens, plain_info, card):
    """The bundle line (``inference/bundle.py``), on the serving line's
    model and 16 requests. The bundles of ``BUNDLE_JOBS`` are exported
    side by side, one process each, and each check below runs as soon as
    the bundles it needs exist. (a) For unquantized and
    ``int8wk`` decoders, a chunked bundle (batch 8, chunk 16 and the
    T = 1 rung; admission bucket 128) behind ``ServingEngine(AotPredictor(dir), num_slots=8,
    chunk_size=16)``: lengths, one prefill a request and all admitted by
    host row copy, on the third drain one graph replay a dispatch and
    the launch identities of the replayed chunks, the same tokens every
    drain and bit-equal to an in-process engine that admits by the same
    host route over the same buckets, and against the plain ring line by
    the decisive gate (the bit-equal count printed). (b)
    ``AotPredictor.generate`` greedy, unquantized and ``int8w``,
    bench_decode_1b_served's protocol at B 8, prompt 128, decode buckets
    95 and 31 (interleaved hi / lo rounds, 2 warm-up and 4 timed;
    marginal ms a token), each bit-equal to the in-process fused
    ``generate``, whose marginal ms is timed in the same rounds
    beside. (c) A sampled bundle (top-k 50, top-p 0.9) at a runtime
    temperature and seed bit-equal to the in-process sampled
    ``generate``; a ``skip:3`` K 4 speculative bundle with its plain
    fallback: tokens and ``last_spec_stats`` those of the in-process
    speculative ``generate``, and under a fault plan on
    ``bundle.spec_decode`` the plain rung, bit-equal to plain
    ``generate``. (d) Refusals on files: a flipped byte
    (``CorruptBundleError``), a recipe asked of the wrong bundle
    (``QuantMismatchError``, both ways), a pickled archive
    (``PickledArchiveError``) and a JAX-format entry
    (``ForeignProgramError``). (e) Export s and bytes an entry, load s,
    the first drain (eager calls and captures), ``memory_report()``, the
    reserved memory, and the bytes a chunk step's cache writes move
    beyond the eager decoder's in-place writes
    (``functional_cache_bytes``). Every kernel launch counted here is
    made inside a loaded bundle's program."""
    t_start = time.perf_counter()
    dev = next(model.parameters()).device
    procs = start_exports(BUNDLE_JOBS)
    try:
        info = _bundle_drills(model, reqs, plain_gens, plain_info, card,
                              procs, t_start, dev)
    finally:
        for _, p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    emit(info)
    return info


def _bundle_drills(model, reqs, plain_gens, plain_info, card, procs,
                   t_start, dev):
    """``serve_bundle``'s checks, each as soon as the export processes of
    the bundles it needs have ended, in the order they are expected to
    end (the smaller bundles first)."""
    import io
    import os
    import shutil
    import zipfile

    from paddle_tpu_torch.inference import AotPredictor, load_compiled
    from paddle_tpu_torch.inference.aot import (ForeignProgramError,
                                                PickledArchiveError,
                                                save_compiled)
    from paddle_tpu_torch.inference.generate import LlamaDecoder
    from paddle_tpu_torch.quantization.kv_cache import QuantMismatchError
    from paddle_tpu_torch.runtime.resilience import (CorruptBundleError,
                                                     fault_injector)
    from paddle_tpu_torch.serving import ServingEngine, bucket_length

    cfg = model.config
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    info = dict(phase="serve_bundle", card=card, exports={}, serve={},
                decode={})
    exports = {}

    def ready(name):
        """The export of ``name``, waited for, with its end time."""
        if name not in exports:
            exports[name] = export_result(procs, name)
            info["exports"][name] = dict(
                export_s=exports[name]["export_s"],
                ended_s=time.perf_counter() - t_start,
                entry_bytes=exports[name]["entry_bytes"])
        return exports[name]["dir"]

    launched = np.zeros(3, np.int64)

    def bundled(fn, *a, **k):
        """Run ``fn`` (bundle serving only) and count its launches."""
        nonlocal launched
        before = bundle_launches()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        launched += bundle_launches() - before
        return out

    def done(name):
        shutil.rmtree(exports[name]["dir"], ignore_errors=True)

    rng = np.random.default_rng(5)
    prompt = rng.integers(0, V, (8, 128))
    hi, lo = 96, 32
    decs = {q: LlamaDecoder(model, max_len=256, quant=q)
            for q in (None, "int8wk", "int8w")}

    def serve_line(quant):
        """(a) the engine over a chunked bundle; returns its predictor."""
        tag = quant or "none"
        job = f"serve_{tag}"
        buckets = BUNDLE_JOBS[job][1]["prompt_lens"]
        dec, d = decs[quant], ready(job)
        pred = AotPredictor(d)
        load_s = timed_load(pred)
        eng = ServingEngine(pred, num_slots=8, chunk_size=16)
        before = bundle_launches()
        gens, first_wall, _ = bundled(drain, eng, reqs)
        first = bundle_launches() - before
        check_lengths(f"bundle {tag}", reqs, gens, V)
        # a key's first call is eager, its second captures: after two
        # drains every key of the traffic has its graph
        second, second_wall, _ = bundled(drain, eng, reqs)
        m0 = eng.metrics()
        r0 = pred.graph_replays
        before = bundle_launches()
        again, wall, _ = bundled(drain, eng, reqs)
        n_da, n_i8, _ = bundle_launches() - before
        m = eng.metrics()
        chunks = m["chunk_dispatches"] - m0["chunk_dispatches"]
        prefills = m["prefill_dispatches"] - m0["prefill_dispatches"]
        for j, (a, b, x) in enumerate(zip(again, gens, second)):
            check(np.array_equal(a, b) and np.array_equal(x, b),
                  f"bundle {tag}: request {j} served again gave other "
                  f"tokens")
        check(prefills == len(reqs), f"bundle {tag}: one prefill each")
        check(m["step_dispatches"] == 0, f"bundle {tag}: per-token steps")
        check(m["admission_ring"] is None
              and eng.host_scattered == 3 * len(reqs),
              f"bundle {tag}: {eng.host_scattered} host row copies for "
              f"three drains of {len(reqs)} requests, ring "
              f"{m['admission_ring']}")
        steps = chunks * 16
        check(n_da == L * steps, f"bundle {tag}: decode_attention "
              f"launches {n_da} != {L} x {steps}")
        small = sum(1 for p, _, _ in reqs
                    if bucket_length(len(p), buckets) <= 64)
        want_i8 = (4 * L + 1) * (steps + small) if quant else 0
        check(n_i8 == want_i8, f"bundle {tag}: int8_matmul launches "
              f"{n_i8} != {want_i8}")
        replays = pred.graph_replays - r0
        check(replays == chunks + prefills, f"bundle {tag}: {replays} "
              f"graph replays, {chunks} chunks and {prefills} prefills")
        # the in-process engine over the same host route and buckets
        href = ServingEngine(dec, num_slots=8, chunk_size=16,
                             prefix_cache=True, prompt_buckets=buckets,
                             cache_aware_admission=False)
        hgens, hwall, _ = drain(href, reqs)
        for j, (a, b) in enumerate(zip(gens, hgens)):
            check(np.array_equal(a, b), f"bundle {tag}: request {j} != the "
                  f"in-process host-route engine's tokens")
        held = hold_to(f"bundle {tag}", dec, reqs, gens, plain_gens[quant])
        held["rows_bit_equal"] = sum(np.array_equal(a, b)
                                     for a, b in zip(gens, plain_gens[quant]))
        n_tok = int(sum(len(g) for g in gens))
        fbytes, n_in_place = functional_cache_bytes(
            pred._entry("decode_chunk_b8_t16.aot"))
        info["serve"][tag] = dict(
            buckets=buckets, load_s=load_s, first_drain_s=first_wall,
            first_drain_launches=first.tolist(), second_drain_s=second_wall,
            wall_s=wall, tokens_per_s=n_tok / wall,
            vs_plain=(n_tok / wall) / plain_info[quant]["tokens_per_s"],
            host_route_inprocess_tokens_per_s=n_tok / hwall,
            prefill_dispatches=prefills, chunk_dispatches=chunks,
            graph_replays=replays, decode_attention_launches=int(n_da),
            int8_matmul_launches=int(n_i8), rows_equal_host_route=True,
            held_to_plain=held, functional_cache_bytes_per_step=fbytes,
            in_place_cache_writes_per_step=n_in_place,
            memory_report=pred.memory_report(),
            memory_reserved_bytes=torch.cuda.memory_reserved())
        del eng, href
        return pred


    # (c) sampled: runtime temperature and seed
    dec = decs[None]
    ds = ready("sampled")
    preds_ = AotPredictor(ds)
    want = np.asarray(dec.generate(prompt, lo, do_sample=True, top_k=50,
                                   top_p=0.9, temperature=0.8, seed=7))
    for _ in range(3):         # eager, captured, replayed
        got = np.asarray(bundled(preds_.generate, prompt, lo, do_sample=True,
                                 temperature=0.8, seed=7))
        check(np.array_equal(got, want), "sampled bundle != the in-process "
              "sampled generate")
    info["sampled"] = dict(graph_replays=preds_.graph_replays)
    # (d) a flipped byte in an entry is refused at load
    f = next(b["file"] for b in preds_.meta["decode_buckets"])
    with open(os.path.join(ds, f), "r+b") as fh:
        fh.seek(os.path.getsize(os.path.join(ds, f)) // 2)
        byte = fh.read(1)
        fh.seek(-1, 1)
        fh.write(bytes([byte[0] ^ 0x10]))
    try:
        AotPredictor(ds)._entry(f)
        check(False, "a flipped byte loaded")
    except CorruptBundleError:
        pass
    del preds_
    done("sampled")

    # (a) unquantized; (b) marginal ms a token over the same bundle and
    # the int8w one, bench_decode_1b_served's interleaved A/B
    pred_none = serve_line(None)
    pred8 = AotPredictor(ready("decode_int8w"))
    info["decode"]["int8w_load_s"] = timed_load(pred8)
    bundles = {"none": (decs[None], pred_none),
               "int8w": (decs["int8w"], pred8)}
    reserved0 = torch.cuda.memory_reserved()
    for n in (hi, lo):
        for recipe, (dec_, pred_) in bundles.items():
            want = np.asarray(dec_.generate(prompt, n))
            for _ in range(3):       # eager, captured, replayed
                got = np.asarray(bundled(pred_.generate, prompt, n))
                check(np.array_equal(got, want), f"bundle {recipe}: {n} "
                      f"tokens != the in-process fused generate's")
    variants = [(f"{where} {recipe}", x)
                for recipe, pair in bundles.items()
                for where, x in zip(("bundle", "in-process"), pair[::-1])]
    samples = {name: [] for name, _ in variants}
    t0 = time.perf_counter()
    for rep in range(6):               # 2 warm-up rounds, 4 timed
        for name, x in variants:
            # the in-process fused loop: its captures in round 0, replays
            # of one graph a (recipe, tokens) key after
            bundle = name.startswith("bundle")
            run = (lambda n: bundled(x.generate, prompt, n)) if bundle \
                else (lambda n: x.generate(prompt, n))
            torch.cuda.synchronize()
            a = time.perf_counter()
            run(hi)
            torch.cuda.synchronize()
            b = time.perf_counter()
            run(lo)
            torch.cuda.synchronize()
            c = time.perf_counter()
            if rep >= 2:
                samples[name].append(((b - a) - (c - b)) / (hi - lo))
    for name, s in samples.items():
        q1, med, q3 = np.percentile(np.asarray(s), [25, 50, 75])
        info["decode"][name] = dict(ms_per_token=1e3 * med,
                                    iqr_ms=1e3 * (q3 - q1),
                                    tokens_per_s=8 / med, rounds=len(s))
    info["decode"]["ab_s"] = time.perf_counter() - t0
    info["decode"]["graph_replays"] = [pred_none.graph_replays,
                                       pred8.graph_replays]
    info["decode"]["fused_graphs"] = {
        r: dict(zip(("graphs", "replays"), fused_graphs(d_)))
        for r, (d_, _) in bundles.items()}
    info["decode"]["fused_graph_reserved_bytes"] = (
        torch.cuda.memory_reserved() - reserved0)
    info["decode"]["fused_vs_eager"] = fused_vs_eager(model, dec, prompt,
                                                      lo)
    # (d) a recipe asked of the wrong bundle, both ways
    for x, ask in ((pred8, "none"), (pred_none, "int8w")):
        try:
            x.generate(prompt, 8, quant=ask)
            check(False, f"quant={ask} served by the wrong bundle")
        except QuantMismatchError:
            pass
    del bundles, pred8, pred_none, x, variants, dec_, pred_
    done("serve_none")
    done("decode_int8w")
    torch.cuda.empty_cache()
    serve_line("int8wk")
    done("serve_int8wk")
    torch.cuda.empty_cache()

    # speculative: skip:3, K 4, with the plain fallback
    predsp = AotPredictor(ready("spec"))
    want = np.asarray(dec.generate(prompt, lo, draft_model="skip:3",
                                   num_speculative_tokens=4))
    want_stats = dict(dec.last_spec_stats)
    for _ in range(3):
        got = np.asarray(bundled(predsp.generate, prompt, lo))
        check(np.array_equal(got, want), "speculative bundle != the "
              "in-process speculative generate")
        check(predsp.last_spec_stats == want_stats,
              f"speculative stats {predsp.last_spec_stats} != {want_stats}")
    plain = np.asarray(dec.generate(prompt, lo))
    with flags_set({"resilience_backoff_s": 0.0}):
        fault_injector.configure([{"kind": "dispatch_error",
                                   "site": "bundle.spec_decode",
                                   "times": 10**9}])
        try:
            got = np.asarray(bundled(predsp.generate, prompt, lo))
        finally:
            fault_injector.clear()
    check(predsp.last_resilience["level"] == "fused",
          f"spec fault plan: level {predsp.last_resilience['level']}")
    check(np.array_equal(got, plain), "the plain rung != plain generate")
    info["speculative"] = dict(
        stats=want_stats, degraded_level=predsp.last_resilience["level"],
        degradations=len(predsp.last_resilience["degradations"]),
        graph_replays=predsp.graph_replays)
    del predsp, decs
    done("spec")
    torch.cuda.empty_cache()

    # (d) a pickled archive and a JAX-format entry, refused unloaded
    dd = bundle_dir("refusals")
    os.makedirs(dd)
    small = os.path.join(dd, "small.aot")
    save_compiled(torch.nn.Linear(4, 4).to(dev),
                  (torch.zeros(2, 4, device=dev),), small)
    with open(small, "rb") as fh:
        head, blob = fh.read().split(b"PK\x03\x04", 1)
    src = zipfile.ZipFile(io.BytesIO(b"PK\x03\x04" + blob))
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as out:
        for n in src.namelist():
            data = src.read(n)
            if n.endswith("weights_config.json"):
                data = data.replace(b'"use_pickle": false',
                                    b'"use_pickle": true')
            out.writestr(n, data)
    bad = os.path.join(dd, "pickled.aot")
    with open(bad, "wb") as fh:
        fh.write(head + buf.getvalue())
    foreign = os.path.join(dd, "stablehlo.aot")
    with open(foreign, "wb") as fh:
        fh.write(b"PTPU-AOT1\n" + b"\x10\x00\x00\x00ML\xefR" + bytes(64))
    refused = {}
    for path, err in ((bad, PickledArchiveError),
                      (foreign, ForeignProgramError)):
        try:
            load_compiled(path)
            check(False, f"{path} loaded")
        except err as e:
            refused[os.path.basename(path)] = type(e).__name__
    shutil.rmtree(dd, ignore_errors=True)
    info["refusals"] = dict(refused, corrupt="CorruptBundleError",
                            quant="QuantMismatchError")
    check(launched.min() > 0, f"bundle launches {launched.tolist()}: a "
          f"kernel never launched inside a bundle")
    info["decode_attention_launches"] = int(launched[0])
    info["int8_matmul_launches"] = int(launched[1])
    info["threefry_launches"] = int(launched[2])
    info["memory_reserved_bytes"] = torch.cuda.memory_reserved()
    info["phase_s"] = time.perf_counter() - t_start
    return info


def fused_vs_eager(model, dec, prompt, n):
    """``dec``'s graphed fused loop against the eager loop of a second
    decoder over the same model (``eager_fused``), greedy and sampled
    (top-k 50, top-p 0.9, temperature 0.8, seed 3): the tokens bit for
    bit at the prompt's length (the greedy key is captured by now; the
    sampled key's first call is its warm-up, the second its capture, the
    third a replay) and then at 96 tokens of it, which must replay the
    same graph (one more replay, no new graph); prefill + 1 dispatches a
    call. Returns each key's graph count and replays."""
    from paddle_tpu_torch.inference.generate import LlamaDecoder
    ref = eager_fused(LlamaDecoder(model, max_len=256))
    out = {}
    for mode, kw in (("greedy", {}),
                     ("sampled", dict(do_sample=True, top_k=50, top_p=0.9,
                                      temperature=0.8, seed=3))):
        for ids, calls in ((prompt, 1 if mode == "greedy" else 3),
                           (prompt[:, :96], 1)):
            want = np.asarray(ref.generate(ids, n, **kw))
            for _ in range(calls):
                graphs0 = fused_graphs(dec)
                d0 = dec.dispatch_count
                got = np.asarray(dec.generate(ids, n, **kw))
                check(dec.dispatch_count - d0 == 2, f"fused {mode}: "
                      f"{dec.dispatch_count - d0} dispatches a generate")
                check(np.array_equal(got, want), f"fused {mode} at prompt "
                      f"{ids.shape[1]}: the graph's tokens != the eager "
                      f"loop's")
            if ids.shape[1] == 96:
                graphs1 = fused_graphs(dec)
                check(graphs1[0] == graphs0[0]
                      and graphs1[1] == graphs0[1] + 1,
                      f"fused {mode}: prompt 96 did not replay the prompt "
                      f"{prompt.shape[1]} graph ({graphs0} -> {graphs1})")
        out[mode] = dict(zip(("graphs", "replays"), fused_graphs(dec)),
                         bit_equal=True)
    del ref
    return out


# -- prefix cache and speculative serving --------------------------------

def graph_replays(dec, kind):
    """(captured graphs, their replays) of the decoder's graphs of one
    kind: "admit" (the prefix cache's admission prefills), "ring",
    "draft" (staged prefills) or "spec" (speculative chunks)."""
    pool = dec._chunk_graphs if kind == "spec" else dec._prefill_graphs
    gs = [g for k, g in pool.items() if g is not None and k[0] == kind]
    return len(gs), sum(g.replays for g in gs)


def graph_memory(dec):
    """The decoder's graph keys (warm-up entries included) by kind, and
    the allocator's reserved bytes now and at their peak: the readings
    that size the decoder's graph LRUs."""
    kinds = {}
    for pool in (dec._prefill_graphs, dec._chunk_graphs):
        for k in pool:
            kind = k[0] if isinstance(k[0], str) else "chunk"
            kinds[kind] = kinds.get(kind, 0) + 1
    return dict(graph_keys=kinds,
                prefill_graph_keys=len(dec._prefill_graphs),
                chunk_graph_keys=len(dec._chunk_graphs),
                memory_reserved_bytes=torch.cuda.memory_reserved(),
                max_memory_reserved_bytes=torch.cuda.max_memory_reserved())


def prefix_mix(V, rng):
    """bench.py's ``--serve --prefix-mix`` traffic at its on-device sizes
    (bench.py:2450-2510): G 3 shared prefixes of 64 tokens, suffixes of
    16; phase A seeds the pool (a leader a prefix and 4 unique prompts),
    phase B is 6 exact duplicates of leader 0, 4 more suffix variants of
    each prefix and 4 unique prompts, shuffled. Returns the two phases'
    prompts."""
    G, prefix_len, suffix_len, per_group, n_dups, n_unique = 3, 64, 16, 5, \
        6, 4
    prefixes = [rng.integers(0, V, (prefix_len,)) for _ in range(G)]
    leader = [np.concatenate([pre, rng.integers(0, V, (suffix_len,))])
              for pre in prefixes]
    phase_a = list(leader) + [rng.integers(0, V, (prefix_len + suffix_len,))
                              for _ in range(n_unique)]
    phase_b = [leader[0]] * n_dups
    for g in range(G):
        phase_b += [np.concatenate([prefixes[g],
                                    rng.integers(0, V, (suffix_len,))])
                    for _ in range(per_group - 1)]
    phase_b += [rng.integers(0, V, (prefix_len + suffix_len,))
                for _ in range(n_unique)]
    rng.shuffle(phase_b)
    return phase_a, phase_b


def serve_prefix(model, quant, card):
    """The prefix-cache line: ``prefix_mix`` served by two engines over
    one decoder (8 slots, chunk 16, 32 new tokens each):
    COLD, the default ring route, and CACHED, ``prefix_cache=True`` (block
    32) with ``batch_admission=True``, which admits by host row copy and
    replays one admission-prefill graph a (rows, bucket), at max_len 128
    (the 80-token prompts' bucket). Both run to capture their graphs,
    then once more, cold then cached, each from a
    fresh engine with the kernel counts set to 0 before and read after
    (the cached route runs twice first, so that every admission key is
    captured before the timed run).
    Gates: full hits' tokens equal their leader's bit for bit and make no
    prefill dispatch (per request, and the dispatch ledger balances);
    the cached run prefills strictly less than the cold one, and its
    full hits' admission p50 is below the cold run's; partial hits and
    misses pass the decisive teacher-forced gate; at most one
    admission graph a (rows, bucket), every later admission of a key a
    replay; lengths, finite rows and the decoder's dispatch identity."""
    from paddle_tpu_torch.inference.generate import LlamaDecoder
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.ops.kernels import int8_matmul as i8
    from paddle_tpu_torch.serving import ServingEngine

    t_start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    V = model.config.vocab_size
    tag = f"prefix {quant or 'none'}"
    phase_a, phase_b = prefix_mix(V, np.random.default_rng(0))
    prompts = phase_a + phase_b
    n_new = 32
    # bench.py sizes the cache at 64 + 16 + 32 + 8 = 120; the 80-token
    # prompts' bucket is 128
    dec = LlamaDecoder(model, max_len=128, quant=quant)
    cached_kw = dict(prefix_cache=True, prefix_cache_bytes=1 << 30,
                     prefix_block_tokens=32, batch_admission=True)

    def run(cached):
        eng = ServingEngine(dec, num_slots=8, chunk_size=16,
                            **(cached_kw if cached else {}))
        d0 = dec.dispatch_count
        torch.cuda.synchronize()
        da.launches = i8.launches = 0
        t0 = time.perf_counter()
        ids = [eng.submit(p, n_new) for p in phase_a]
        eng.drain()
        ids += [eng.submit(p, n_new) for p in phase_b]
        eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        m = eng.metrics()
        res = [eng.result(r) for r in ids]
        gens = [np.asarray(r)[0, len(p):] for r, p in zip(res, prompts)]
        t = f"{tag} {'cached' if cached else 'cold'}"
        check(all(len(g) == n_new for g in gens), f"{t}: lengths")
        check(m["corrupt_rows"] == 0, f"{t}: non-finite logits in a row")
        check(dec.dispatch_count - d0
              == m["prefill_dispatches"] + m["chunk_dispatches"],
              f"{t}: dispatch identity")
        return dict(eng=eng, m=m, gens=gens, wall=wall,
                    recs=[r.resilience["serving"] for r in res],
                    launches=(da.launches, i8.launches))

    # the cached route's admission keys: eager, then captured; the cold
    # route's prefill buckets likewise
    run(True)
    run(True)
    run(False)
    cold = run(False)
    g0 = graph_replays(dec, "admit")
    hot = run(True)
    mc, mh = cold["m"], hot["m"]
    pc = mh["prefix_cache"]
    recs = hot["recs"]
    cls = [r["prefix_hit"] for r in recs]
    lead = hot["gens"][0]
    for j, r in enumerate(recs):
        if cls[j] != "full":
            continue
        check(np.array_equal(hot["gens"][j], lead),
              f"{tag}: full hit {j} differs from its leader")
        check(r["admission_dispatches"] == 0,
              f"{tag}: full hit {j} made a prefill dispatch")
    check(cls.count("full") >= 5 and cls.count("partial") >= 1,
          f"{tag}: hit classes {cls}")
    check(mh["prefill_dispatches"] == (
        pc["engine_misses"] + pc["engine_hits_partial"]
        + pc["engine_hits_full"] - mh["admission_dispatches_saved"]),
        f"{tag}: the admission ledger does not balance: {pc}, "
        f"{mh['admission_dispatches_saved']} saved")
    check(mh["prefill_dispatches"] < mc["prefill_dispatches"],
          f"{tag}: cached prefills {mh['prefill_dispatches']} not below "
          f"cold {mc['prefill_dispatches']}")
    # bench.py's admission check: a full hit (one host row copy) admits
    # faster than a cold admission (a prefill)
    check(mh["admission_p50_s"]["full"] < mc["admission_p50_s"]["miss"],
          f"{tag}: full-hit admission p50 {mh['admission_p50_s']['full']} "
          f"s not below the cold run's {mc['admission_p50_s']['miss']} s")
    reqs = [(p, n_new, None) for p in prompts]
    tf = teacher_forced(tag, dec, reqs, hot["gens"],
                        [j for j, c in enumerate(cls) if c != "full"])
    keys = [k[1:3] for k, g in dec._prefill_graphs.items()
            if g is not None and k[0] == "admit"]
    n_admit, admit_replays = graph_replays(dec, "admit")
    check(len(keys) == len(set(keys)), f"{tag}: admission graphs {keys}")
    # the earlier cached runs captured every key: each of the hot run's
    # prefill dispatches is a replay, and no graph is added or dropped
    check(n_admit == g0[0]
          and admit_replays - g0[1] == mh["prefill_dispatches"],
          f"{tag}: admission graphs {g0} -> {(n_admit, admit_replays)} "
          f"over {mh['prefill_dispatches']} prefill dispatches")
    n_tok = len(prompts) * n_new
    info = dict(
        phase="serve_prefix", quant=quant or "none", card=card,
        requests=len(prompts),
        hits={c: cls.count(c) for c in ("full", "partial", "miss")},
        hit_rate=(pc["engine_hits_full"] + pc["engine_hits_partial"])
        / len(prompts),
        prefill_tokens_saved=mh["prefill_tokens_saved"],
        bytes_cached=pc["bytes_cached"], slabs=pc["slabs"],
        prefill_dispatches=mh["prefill_dispatches"],
        cold_prefill_dispatches=mc["prefill_dispatches"],
        admission_dispatches_saved=mh["admission_dispatches_saved"],
        batched_admission_groups=mh["batched_admission_groups"],
        admission_cache_reordered=mh["admission_cache_reordered"],
        host_scattered=hot["eng"].host_scattered,
        admission_p50_s=mh["admission_p50_s"],
        admission_p99_s=mh["admission_p99_s"],
        cold_admission_p50_s=mc["admission_p50_s"]["miss"],
        tokens_per_s=n_tok / hot["wall"],
        cold_tokens_per_s=n_tok / cold["wall"],
        ms_per_chunk_incl_admission=1e3 * hot["wall"]
        / mh["chunk_dispatches"],
        cold_ms_per_chunk_incl_admission=1e3 * cold["wall"]
        / mc["chunk_dispatches"],
        chunk_dispatches=mh["chunk_dispatches"],
        cold_chunk_dispatches=mc["chunk_dispatches"],
        admission_graphs=n_admit,
        admission_graph_replays=admit_replays - g0[1],
        admission_graph_keys=sorted(keys), **graph_memory(dec),
        decode_attention_launches=hot["launches"][0],
        int8_matmul_launches=hot["launches"][1],
        full_hits_equal_leader=True, **tf)
    info["phase_s"] = time.perf_counter() - t_start
    emit(info)
    del cold, hot, dec
    torch.cuda.empty_cache()
    return info


def spec_requests(V):
    """bench_serve_spec's traffic (bench.py:1540-1546): 16 prompts of 32
    tokens, output lengths drawn from (8, 16, 32, 96)."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, V, (32,)) for _ in range(16)]
    lens = rng.choice((8, 16, 32, 96), 16)
    return [(p, int(n), None) for p, n in zip(prompts, lens)]


def serve_spec(model, card):
    """The speculative line, bench_serve_spec's (bench.py:1490-1633) on
    the GQA model: ``spec_requests`` through ``ServingEngine`` (8 slots,
    chunk 16, max_len 256): the plain engine; ``draft_model="skip:3"``,
    K 4, greedy; a separate draft holding the target's own weights
    (acceptance near K, the all-accepted and bonus path); ``quant="int8w"``
    with ``draft_quant="int8w"`` on that draft; sampled (top-k 50, top-p
    0.9, seeds 1000 + j, temperatures 0.7-1.0). Each speculative engine
    drains twice (a chunk key's first call eager, the second captured,
    the rest replays), the kernel counts read around the second. Gates:
    lengths; the dispatch identity (prefills + draft prefills + chunks);
    zero per-token steps; per-request acceptance counts summing to the
    engine's; every chunk of a key after its first a replay; the kernel
    launches the rounds imply; greedy tokens through the decisive
    teacher-forced gate; acceptance >= 0.75 K with the target's own
    weights as draft; sampled tokens in the re-score's top 50 (or within
    4 bf16 spacings of its 50th logit) and equal over two drains."""
    from paddle_tpu_torch.inference.generate import LlamaDecoder
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.ops.kernels import int8_matmul as i8
    from paddle_tpu_torch.ops.kernels import threefry as tf_k

    t_start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = model.config
    V, L, K, T = cfg.vocab_size, cfg.num_hidden_layers, 4, 16
    reqs = spec_requests(V)
    sampling = [(1000 + j, 0.7 + 0.3 * j / 15) for j in range(len(reqs))]
    dec = LlamaDecoder(model, max_len=256)

    def line(name, dec, kw, sampled=False):
        from paddle_tpu_torch.serving import ServingEngine
        t = f"spec {name}"
        eng = ServingEngine(dec, num_slots=8, chunk_size=T, **kw)
        smp = sampling if sampled else None
        first, first_wall, _ = drain(eng, reqs, sampling=smp)
        g0 = graph_replays(dec, "spec")
        d0 = dec.dispatch_count
        m0 = eng.metrics()
        torch.cuda.synchronize()
        da.launches = i8.launches = tf_k.launches = 0
        i8.launches_by_rows.clear()
        gens, wall, _ = drain(eng, reqs, sampling=smp)
        launches = (da.launches, i8.launches, tf_k.launches)
        i8_rows = dict(sorted(i8.launches_by_rows.items()))
        m = eng.metrics()
        check_lengths(t, reqs, gens, V)
        if sampled or "draft_model" in kw:
            for j, (a, b) in enumerate(zip(first, gens)):
                check(np.array_equal(a, b), f"{t}: request {j} gave other "
                      f"tokens in its second drain")
        d = {k: m[k] - m0[k] for k in ("prefill_dispatches",
                                       "draft_prefill_dispatches",
                                       "chunk_dispatches")}
        check(m["corrupt_rows"] == 0, f"{t}: non-finite logits in a row")
        check(m["step_dispatches"] == 0, f"{t}: per-token steps")
        check(dec.dispatch_count - d0 == sum(d.values()),
              f"{t}: dispatch identity {dec.dispatch_count - d0} != {d}")
        check_ring(t, {"admission_ring": {
            **m["admission_ring"],
            "staged": m["admission_ring"]["staged"] - len(reqs),
            "scattered": m["admission_ring"]["scattered"] - len(reqs)}},
            len(reqs))
        info = dict(phase="serve_spec", line=name, card=card,
                    requests=len(reqs), wall_s=wall,
                    first_drain_wall_s=first_wall, **d)
        n_tok = int(sum(len(g) for g in gens))
        info.update(tokens=n_tok, tokens_per_s=n_tok / wall,
                    ms_per_chunk_incl_admission=1e3 * wall
                    / d["chunk_dispatches"],
                    tokens_per_chunk_dispatch=n_tok / d["chunk_dispatches"],
                    decode_attention_launches=launches[0],
                    int8_matmul_launches=launches[1],
                    int8_matmul_launches_by_rows=i8_rows,
                    threefry_launches=launches[2], **graph_memory(dec))
        sp = m["speculative"]
        if sp is not None:
            res = eng.result
            rounds = sum(res(r).resilience["serving"]["speculative"]
                         ["rounds"] for r in range(len(reqs)))
            acc = sum(res(r).resilience["serving"]["speculative"]
                      ["accepted_drafts"] for r in range(len(reqs)))
            check(rounds == m0["speculative"]["rounds"] and acc
                  == m0["speculative"]["accepted_drafts"],
                  f"{t}: per-request acceptance counts {rounds} / {acc} != "
                  f"the engine's {m0['speculative']}")
            g1 = graph_replays(dec, "spec")
            check(g1[0] == g0[0] and g1[1] - g0[1] == d["chunk_dispatches"],
                  f"{t}: spec chunk graphs {g0} -> {g1} over "
                  f"{d['chunk_dispatches']} chunks")
            rounds2 = sp["rounds"] - m0["speculative"]["rounds"]
            acc2 = sp["accepted_drafts"] - m0["speculative"]["accepted_drafts"]
            info.update(acceptance_len_mean=acc2 / rounds2, rounds=rounds2,
                        accepted_drafts=acc2,
                        overflow_tokens=sp["overflow_tokens"],
                        spec_chunk_graphs=g1[0],
                        spec_chunk_replays=g1[1] - g0[1])
        return info, eng, gens

    plain, _, plain_gens = line("plain", dec, {})
    # skip:3, greedy: decode attention only in the draft's forwards
    skip, eng, gens = line("skip3", dec, dict(draft_model="skip:3",
                                              num_speculative_tokens=K))
    chunks = skip["chunk_dispatches"]
    check(skip["decode_attention_launches"] == chunks * T * (K + 1) * 3,
          f"spec skip3: decode_attention launches "
          f"{skip['decode_attention_launches']} != {chunks} x {T} x "
          f"{K + 1} x 3")
    skip.update(teacher_forced("spec skip3", dec, reqs, gens))
    torch.cuda.synchronize()
    _, pwall, prof = drain(eng, reqs, profile=True)
    skip["profiled"] = profiled_info({}, prof, pwall, chunks * T,
                                     ("decode_attention",))
    skip["plain_tokens_per_s"] = plain["tokens_per_s"]
    skip["plain_ms_per_chunk_incl_admission"] = \
        plain["ms_per_chunk_incl_admission"]
    skip["tokens_equal_plain"] = all(np.array_equal(a, b) for a, b
                                     in zip(gens, plain_gens))
    emit(skip)
    # the target's own weights as a separate draft: acceptance near K
    own, _, gens = line("own_weights", dec, dict(draft_model=model,
                                                 num_speculative_tokens=K))
    check(own["acceptance_len_mean"] >= 0.75 * K,
          f"spec own_weights: acceptance {own['acceptance_len_mean']} "
          f"< 0.75 K")
    own.update(teacher_forced("spec own_weights", dec, reqs, gens))
    emit(own)
    # int8w target and an int8w draft: the verify's int8 matmuls at
    # 8 x (K + 1) = 40 rows, the draft's at 8
    qdec = LlamaDecoder(model, max_len=256, quant="int8w")
    q8, _, gens = line("int8w", qdec, dict(draft_model=model,
                                           num_speculative_tokens=K,
                                           draft_quant="int8w"))
    chunks = q8["chunk_dispatches"]
    per_fwd = 4 * L + 1
    want = (chunks * T * ((K + 1) * per_fwd + per_fwd)
            + 2 * per_fwd * q8["prefill_dispatches"])
    check(q8["int8_matmul_launches"] == want,
          f"spec int8w: int8_matmul launches {q8['int8_matmul_launches']} "
          f"!= {want}")
    # the verify's launches, counted at the kernel by row count: 8 (K + 1)
    # rows, which no draft forward (8 rows) or prefill (a multiple of the
    # 32-token bucket) has
    by_rows = q8["int8_matmul_launches_by_rows"]
    q8["int8_matmul_verify_launches"] = by_rows.get(8 * (K + 1), 0)
    check(q8["int8_matmul_verify_launches"] == chunks * T * per_fwd
          and by_rows.get(8, 0) == chunks * T * (K + 1) * per_fwd,
          f"spec int8w: int8_matmul launches by rows {by_rows}: not "
          f"{chunks} x {T} x {per_fwd} verify launches of {8 * (K + 1)} "
          f"rows and {K + 1} x as many draft launches of 8")
    q8.update(teacher_forced("spec int8w", qdec, reqs, gens))
    emit(q8)
    del qdec
    # sampled
    smp, _, gens = line("sampled", dec, dict(
        draft_model="skip:3", num_speculative_tokens=K, do_sample=True,
        top_k=50, top_p=0.9), sampled=True)
    worst = -math.inf
    for j, (rows, g) in enumerate(zip(rescore(dec, reqs, gens), gens)):
        tok = torch.as_tensor(g, device=rows.device)
        kth = rows.topk(50, dim=-1).values[:, -1]
        gap = (kth - rows.gather(1, tok[:, None])[:, 0]) / bf16_spacing(kth)
        worst = max(worst, gap.max().item())
        check(gap.max().item() <= 4, f"spec sampled: request {j} drew a "
              f"token {gap.max().item()} bf16 spacings below the "
              f"re-score's 50th logit")
    smp["max_top50_gap_bf16_spacings"] = worst
    emit(smp)
    del eng, dec
    torch.cuda.empty_cache()
    return dict(skip3=skip, own_weights=own, int8w=q8, sampled=smp,
                plain=plain, plain_gens=plain_gens, requests=reqs,
                phase_s=time.perf_counter() - t_start)


# -- multi-tenant LoRA serving -------------------------------------------

LORA_TENANTS = ("ad0", "ad1", "ad2")


def lora_projections(dec):
    """(fused param name, d_in, d_out) of the model's projection matrices
    (4 a layer), bench_serve_http's list (bench.py:2685-2693)."""
    cfg = dec.cfg
    Hd, Fd = cfg.hidden_size, cfg.intermediate_size
    out = []
    for li in range(cfg.num_hidden_layers):
        pre = f"model.layers.{li}."
        qkv = dec.params.get(pre + "self_attn.qkv.weight")
        if qkv is None:
            qkv = dec.params[pre + "self_attn.qkv.weight:int8"]
        out += [(pre + "self_attn.qkv.weight", Hd, int(qkv.shape[-1])),
                (pre + "self_attn.o_proj.weight", Hd, Hd),
                (pre + "mlp.gate_up.weight", Hd, 2 * Fd),
                (pre + "mlp.down_proj.weight", Fd, Hd)]
    return out


def lora_deltas(proj, rng, ranks):
    """``{param: (A, B)}`` of 0.05 N(0, 1) entries at one rank, drawn in
    bench_serve_http's order."""
    return {pn: (0.05 * rng.standard_normal((din, ranks)),
                 0.05 * rng.standard_normal((ranks, dout)))
            for pn, din, dout in proj}


def lora_store(dec, dtype):
    """bench_serve_http's tenants (bench.py:2694-2703): ``ad0``-``ad2`` of
    ranks 2 / 3 / 4 (2 + j % 3) over every projection matrix, from
    ``numpy.random.default_rng(0)``, in ``dtype`` stacks."""
    from paddle_tpu_torch.serving import AdapterStore
    rng = np.random.default_rng(0)
    proj = lora_projections(dec)
    store = AdapterStore(dtype=dtype)
    for j, name in enumerate(LORA_TENANTS):
        store.register(name, lora_deltas(proj, rng, 2 + j % 3))
    return store


def merged_decoder(model, quant, deltas):
    """A dense decoder with one tenant's ``A @ B`` folded into each
    projection matrix it touches (over an int8 base: into the dequantized
    matrix, with the int8 K/V cache and head kept): the reference a LoRA
    row is held to."""
    from paddle_tpu_torch.inference.generate import LlamaDecoder
    dec = LlamaDecoder(model, max_len=256, quant=quant)
    p = dec.params
    for pn, (a, b) in deltas.items():
        ab = torch.from_numpy(a @ b).to(device=dec.device,
                                        dtype=torch.float32)
        if pn + ":int8" in p:
            w = p.pop(pn + ":int8").float() * p.pop(pn + ":scale").float()
        else:
            w = p[pn].float()
        p[pn] = (w + ab).to(dec.cfg.torch_dtype)
    return dec


def lora_added_kernels(prof, base_prof, steps):
    """The kernels a LoRA drain's profile holds beyond its plain twin's
    (same requests, lengths and schedule): per name, the device ms and
    launches a decode step that the adapter path adds, largest first, and
    their total."""
    def by_name(pr):
        out = {}
        for t, k, n in kernel_events(pr):
            ms, cnt = out.get(k, (0.0, 0))
            out[k] = (ms + t / 1e3, cnt + n)
        return out
    a, b = by_name(prof), by_name(base_prof)
    added = []
    for k, (ms, n) in a.items():
        bms, bn = b.get(k, (0.0, 0))
        if n > bn:
            added.append(dict(name=k[:80], ms_per_step=(ms - bms) / steps,
                              launches_per_step=(n - bn) / steps))
    added.sort(key=lambda r: -r["ms_per_step"])
    return dict(lora_kernels_ms_per_step=sum(r["ms_per_step"]
                                             for r in added),
                lora_kernels_launches_per_step=sum(
                    r["launches_per_step"] for r in added),
                lora_top_kernels=added[:8])


def serve_lora(model, quant, reqs, card):
    """The LoRA line: bench_serve_http's tenant mix (bench.py:2643-2715)
    without the HTTP part, at the serving line's widths and traffic, on
    ``model`` (the serving model at 6 of its 12 layers). The
    16 requests go round-robin to base, ``ad0``, ``ad1`` and ``ad2``
    (``lora_store``; f32 stacks, fp16 over the int8wk base), through
    ``ServingEngine(adapter_store=)`` (8 slots, chunk 16, max_len 256, the
    device ring, graphed chunks and prefills). Gates: (a) every base row's
    tokens equal a plain engine's over the same model (the twin of (c))
    bit for bit; (b) each adapter
    row passes the decisive teacher-forced gate against a dense decoder
    with its tenant's A @ B folded in (``merged_decoder``); (c) one
    prefill a request, no per-token step, no host scatter, 4 rows a
    tenant, and the chunk and prefill dispatches of a plain engine
    serving the same requests at the same lengths (its "twin"; the
    adapters change the rows that stop at an eos), with the launch counts
    the decode steps imply; every drain the same tokens; (d) a hot swap
    of ``ad1`` while its rows are in flight is ``AdapterVersionError``
    (pinned rev 0, store rev 1), those rows finish with their rev-0
    tokens, the swap applies after them, and a request sent after it
    passes the gate against the rev-1 merged decoder through a new chunk
    graph key; (e) unquantized only: one prefix-cache drain of
    ``prefix_mix`` with each prompt sent as base and as ``ad0``, where a
    full hit happens only for a prompt its own tenant served before, and
    equals that earlier request's tokens. Prints tokens/s and ms a chunk
    beside the twin's, the device ms and launches a
    decode step the adapter path adds (profiled, against the twin), and
    the graph keys and reserved bytes."""
    from paddle_tpu_torch.inference.generate import LlamaDecoder
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.ops.kernels import int8_matmul as i8
    from paddle_tpu_torch.serving import (AdapterVersionError,
                                          ServingEngine, bucket_length)

    t_start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = model.config
    V, L = cfg.vocab_size, cfg.num_hidden_layers
    tag = f"lora {quant or 'none'}"
    ads = [None if j % 4 == 0 else LORA_TENANTS[j % 4 - 1]
           for j in range(len(reqs))]
    dec = LlamaDecoder(model, max_len=256, quant=quant)
    store = lora_store(dec, "float16" if quant else "float32")
    eng = ServingEngine(dec, num_slots=8, chunk_size=16, adapter_store=store)
    d0 = dec.dispatch_count
    torch.cuda.synchronize()
    da.launches = i8.launches = 0
    gens, first_wall, _ = drain(eng, reqs, adapters=ads)
    n_da, n_i8 = da.launches, i8.launches
    m = eng.metrics()
    check_lengths(tag, reqs, gens, V)
    check(m["corrupt_rows"] == 0, f"{tag}: non-finite logits in a row")
    check(m["prefill_dispatches"] == len(reqs), f"{tag}: one prefill each")
    check(m["step_dispatches"] == 0, f"{tag}: per-token steps")
    check(dec.dispatch_count - d0
          == m["prefill_dispatches"] + m["chunk_dispatches"],
          f"{tag}: dispatch identity")
    check_ring(tag, m, len(reqs))
    rows = m["adapters"]["rows_by_adapter"]
    check(rows == {"base": 4, "ad0": 4, "ad1": 4, "ad2": 4},
          f"{tag}: rows by adapter {rows}")
    steps = m["chunk_dispatches"] * eng.chunk_size
    small = sum(1 for p, _, _ in reqs if bucket_length(len(p)) <= 64)
    want_i8 = (4 * L + 1) * (steps + small) if quant else 0
    check((n_da, n_i8) == (L * steps, want_i8),
          f"{tag}: decode_attention / int8_matmul launches {n_da} / "
          f"{n_i8} != {L * steps} / {want_i8}")
    def same(a_gens, what):
        for j, (a, b) in enumerate(zip(a_gens, gens)):
            check(np.array_equal(a, b), f"{tag}: request {j} {what} gave "
                  f"other tokens")

    # (b) adapter rows: the decisive gate against the merged tenants
    tf = {}
    for name in LORA_TENANTS:
        which = [j for j, a in enumerate(ads) if a == name]
        ref = merged_decoder(model, quant, store._adapters[name]["deltas"])
        tf[name] = teacher_forced(f"{tag} {name}", ref, reqs, gens, which)
        del ref
    # (c) the plain twin: the same requests at the LoRA rows' lengths
    twin_reqs = [(p, len(g), None) for (p, _, _), g in zip(reqs, gens)]
    tdec = LlamaDecoder(model, max_len=256, quant=quant)
    teng = ServingEngine(tdec, num_slots=8, chunk_size=16)
    tgens, _, _ = drain(teng, twin_reqs)
    tm = teng.metrics()
    check((m["prefill_dispatches"], m["chunk_dispatches"])
          == (tm["prefill_dispatches"], tm["chunk_dispatches"]),
          f"{tag}: prefill / chunk dispatches {m['prefill_dispatches']} / "
          f"{m['chunk_dispatches']} != the plain twin's "
          f"{tm['prefill_dispatches']} / {tm['chunk_dispatches']}")
    # (a) base rows: the plain twin's tokens
    for j, a in enumerate(ads):
        if a is None:
            check(np.array_equal(tgens[j], gens[j]),
                  f"{tag}: the twin's base request {j} differs")
    # timed and profiled drains, LoRA then twin
    again, wall, _ = drain(eng, reqs, adapters=ads)
    same(again, "served again")
    again, pwall, prof = drain(eng, reqs, profile=True, adapters=ads)
    same(again, "served under the profiler")
    _, twall, _ = drain(teng, twin_reqs)
    _, tpwall, tprof = drain(teng, twin_reqs, profile=True)
    chunk_keys = [k for k, g in dec._chunk_graphs.items() if g is not None]
    check(len(chunk_keys) == 1, f"{tag}: chunk graphs {len(chunk_keys)}")
    n_tok = int(sum(len(g) for g in gens))
    chunks = m["chunk_dispatches"]
    info = dict(phase="serve_lora", quant=quant or "none", card=card,
                requests=len(reqs), tenants={a or "base": ads.count(a)
                                             for a in (None,)
                                             + LORA_TENANTS},
                ranks=[2, 3, 4], stack_dtype=str(store.dtype),
                tokens=n_tok, wall_s=wall, tokens_per_s=n_tok / wall,
                ms_per_chunk_incl_admission=1e3 * wall / chunks,
                first_drain_wall_s=first_wall, layers=L,
                twin_tokens_per_s=n_tok / twall,
                twin_ms_per_chunk_incl_admission=1e3 * twall / chunks,
                prefill_dispatches=m["prefill_dispatches"],
                chunk_dispatches=chunks, decode_steps=steps,
                step_dispatches=m["step_dispatches"],
                admission_ring=m["admission_ring"],
                adapters=m["adapters"], decode_attention_launches=n_da,
                int8_matmul_launches=n_i8, base_rows_equal_twin=True,
                teacher_forced=tf)
    info["profiled"] = profiled_info({}, prof, pwall, steps,
                                     ("decode_attention", "int8_matmul"))
    info["profiled_twin"] = profiled_info({}, tprof, tpwall, steps,
                                          ("decode_attention",
                                           "int8_matmul"))
    info.update(lora_added_kernels(prof, tprof, steps))
    info["graph_keys_before_swap"] = graph_memory(dec)
    del teng, tdec, tprof

    # (d) the hot swap of ad1 under its in-flight rows
    torch.cuda.synchronize()
    ids = [eng.submit(p, n, eos_token_id=e, adapter=a)
           for (p, n, e), a in zip(reqs, ads)]
    eng.step()
    flight = {s.request.id for _, s in eng.scheduler.slots.occupied()
              if s.request.adapter == "ad1"}
    check(bool(flight), f"{tag}: no ad1 row in flight")
    rng = np.random.default_rng(1)
    new = lora_deltas(lora_projections(dec), rng, 3)
    check(store.update("ad1", new) == 1, f"{tag}: ad1 revision")
    err = None
    try:
        eng.apply_adapter_swap()
    except AdapterVersionError as e:
        err = e
    check(err is not None and (err.adapter, err.pinned_rev, err.store_rev)
          == ("ad1", 0, 1), f"{tag}: the swap under in-flight ad1 rows "
          f"gave {err!r}")
    check(eng.status()["adapters"]["swap_pending"],
          f"{tag}: the refused swap is not pending")
    # the rows in flight finish through rev 0 (their earlier tokens);
    # the queued ad1 requests wait for the swap, which applies once those
    # rows are done, and decode through rev 1
    eng.drain()
    swap_gens, rev1 = [], []
    for j, (rid, (p, n, e)) in enumerate(zip(ids, reqs)):
        res = eng.result(rid)
        g = np.asarray(res)[0, len(p):]
        rec = res.resilience["serving"]
        if ads[j] == "ad1" and rid not in flight:
            check(rec["adapter_rev"] == 1, f"{tag}: queued ad1 request "
                  f"{j} decoded through rev {rec['adapter_rev']}")
            rev1.append(j)
            swap_gens.append(g)
            continue
        check(np.array_equal(g, gens[j]), f"{tag}: request {j} gave other "
              f"tokens across the refused swap")
        swap_gens.append(g)
    ma = eng.metrics()["adapters"]
    check(ma["swaps"] == 1 and not eng.status()["adapters"]["swap_pending"]
          and not eng.apply_adapter_swap(),
          f"{tag}: the swap did not apply in the drain: {ma}")
    j2 = ads.index("ad1")
    p2, n2, _ = reqs[j2]
    post = []
    for _ in range(3):               # a graph replay of the new stacks
        rid = eng.submit(p2, n2, adapter="ad1")
        post.append(np.asarray(eng.drain()[rid])[0, len(p2):])
    for g in post[1:]:
        check(np.array_equal(g, post[0]), f"{tag}: the post-swap request "
              f"gave other tokens on a graph replay")
    check(not np.array_equal(post[0], gens[j2]),
          f"{tag}: the post-swap tokens equal rev 0's")
    ref = merged_decoder(model, quant, new)
    info["post_swap"] = teacher_forced(
        f"{tag} ad1 rev 1", ref, [reqs[j] for j in rev1] + [(p2, n2, None)],
        [swap_gens[j] for j in rev1] + post[:1])
    info["post_swap"]["requests"] = len(rev1) + 1
    del ref
    keys_after = [k for k, g in dec._chunk_graphs.items() if g is not None]
    check(len(set(keys_after) - set(chunk_keys)) == 1,
          f"{tag}: the swapped stacks did not get their own chunk graph")
    info["swap_refusal"] = dict(adapter=err.adapter,
                                pinned_rev=err.pinned_rev,
                                store_rev=err.store_rev)
    info["graph_keys_after_swap"] = graph_memory(dec)
    info["chunk_graph_keys_before_after_swap"] = [len(chunk_keys),
                                                  len(keys_after)]
    if quant is None:
        info["prefix"] = serve_lora_prefix(model, store, card)
    info["phase_s"] = time.perf_counter() - t_start
    emit(info)
    del eng, dec
    torch.cuda.empty_cache()
    return info


def serve_lora_prefix(model, store, card):
    """(e): ``prefix_mix`` (``serve_prefix``'s traffic) through one cached
    engine (block 32, batch admission, max_len 128) with ``store``, each
    prompt sent as base and as ``ad0``, phase A then phase B. A full hit
    is only for a (prompt, tenant) an earlier drain served (the tag is
    ``name@rev``), and its tokens equal that earlier request's."""
    from paddle_tpu_torch.inference.generate import LlamaDecoder
    from paddle_tpu_torch.serving import ServingEngine

    V = model.config.vocab_size
    phase_a, phase_b = prefix_mix(V, np.random.default_rng(0))
    dec = LlamaDecoder(model, max_len=128)
    eng = ServingEngine(dec, num_slots=8, chunk_size=16, prefix_cache=True,
                        prefix_cache_bytes=1 << 30, prefix_block_tokens=32,
                        batch_admission=True, adapter_store=store)
    seen, classes, t0 = {}, [], time.perf_counter()
    for phase in (phase_a, phase_b):
        sub = [(p, a, eng.submit(p, 32, adapter=a))
               for p in phase for a in (None, "ad0")]
        res = eng.drain()
        for p, a, rid in sub:
            cls = res[rid].resilience["serving"]["prefix_hit"]
            toks = np.asarray(res[rid])[0, len(p):]
            key = (p.tobytes(), a)
            check((cls == "full") == (key in seen),
                  f"lora prefix: a {cls} hit for tenant {a} with the "
                  f"prompt {'seen' if key in seen else 'unseen'} before")
            if cls == "full":
                check(np.array_equal(toks, seen[key]),
                      f"lora prefix: a full hit of tenant {a} differs from "
                      f"its earlier request")
            classes.append((a or "base", cls))
        for p, a, rid in sub:
            seen.setdefault((p.tobytes(), a),
                            np.asarray(res[rid])[0, len(p):])
    wall = time.perf_counter() - t0
    m = eng.metrics()
    hits = {f"{t} {c}": classes.count((t, c)) for t in ("base", "ad0")
            for c in ("full", "partial", "miss")}
    check(hits["base full"] > 0 and hits["ad0 full"] > 0,
          f"lora prefix: hit classes {hits}")
    out = dict(requests=len(classes), hits=hits,
               prefill_dispatches=m["prefill_dispatches"],
               chunk_dispatches=m["chunk_dispatches"],
               host_scattered=eng.host_scattered,
               rows_by_adapter=m["adapters"]["rows_by_adapter"],
               wall_s=wall, card=card)
    del eng, dec
    return out


# -- the multi-tensor Adam / AdamW kernel ------------------------------------

# -- snapshot/restore, row migration and deadlines ------------------------

def snapshot_dir(name):
    """A fresh directory for one snapshot under the checkout's ``build/``
    (``.gitignore`` lists it)."""
    import os
    import shutil
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "snapshots", name)
    shutil.rmtree(d, ignore_errors=True)
    return d


def collect(out, reqs, ids):
    """Served tokens per request (prompt stripped) from a result dict."""
    gens = []
    for (p, _, _), rid in zip(reqs, ids):
        res = np.asarray(out[rid])[0]
        check(np.array_equal(res[:len(p)], p), "prompt echoed")
        gens.append(res[len(p):])
    return gens


def hold_to(tag, dec, reqs, gens, want, sampled=False):
    """A resumed, remapped or migrated run's tokens against the run it
    stands in for: the record says whether every request is bit-equal and
    names the first divergent positions. A request that differs must
    pass the decisive teacher-forced gate (ROADMAP §3 entry 2), or, when
    ``sampled``, the top-50 gate; nothing wider."""
    differ = []
    for j, (a, b) in enumerate(zip(gens, want)):
        if not np.array_equal(a, b):
            n = min(len(a), len(b))
            d = np.flatnonzero(a[:n] != b[:n])
            differ.append(dict(request=j, position=int(d[0]) if len(d)
                               else n, lengths=[len(a), len(b)]))
    rec = dict(bit_equal=not differ, requests_differing=len(differ),
               first_divergence=differ[:4])
    if differ:
        which = [d["request"] for d in differ]
        if sampled:
            rec["top50_worst_gap_bf16_spacings"] = top50_gate(
                tag, rescore(dec, [reqs[j] for j in which],
                             [gens[j] for j in which]),
                [gens[j] for j in which])
        else:
            rec["gate"] = teacher_forced(tag, dec, reqs, gens, which)
    return rec


def serve_snapshot(model, quant, reqs, plain_gens, plain_info, sampled_gens,
                   card):
    """The snapshot line: the serving line's 16 requests through 8-slot
    engines (chunk 16, max_len 256, the ring, graphed chunks and
    prefills). (a) A snapshot after the third chunk, holding in-flight
    and queued requests, restored into a fresh engine over a NEW
    ``LlamaDecoder`` of the model (a restarted process), drained: every
    request's tokens against the plain line's (``hold_to``: bit for bit,
    else the decisive gate), and the kernels' launches of that drain. (b)
    A 4-slot engine's snapshot restored into an 8-slot one (row remap),
    held by the decisive gate, its bit-equality printed. (c) Two 8-slot
    engines over one decoder: after the second chunk two in-flight rows
    and two queued requests move from one to the other; every request
    against the plain line, and unquantized the same with the sampled
    line's requests against its tokens. (d) A submit with an expired
    budget is ``DeadlineExceededError``; an in-flight row whose deadline
    is moved into the past returns partial and flagged, its tokens a
    prefix of the plain line's; ``drain(deadline_s=0.0,
    snapshot_path=)`` after two chunks, then a restore, finishes against
    the plain line. Prints the snapshot's ms and bytes, the restore's ms,
    extract and absorb ms and payload bytes a row, the resumed drain's
    tokens/s beside the plain line's, and the restored decoder's graph
    keys and captures."""
    import os
    import shutil

    from paddle_tpu_torch.inference.generate import LlamaDecoder
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.ops.kernels import int8_matmul as i8
    from paddle_tpu_torch.runtime.resilience import DeadlineExceededError
    from paddle_tpu_torch.serving import ServingEngine, bucket_length

    t_start = time.perf_counter()
    cfg = model.config
    V = cfg.vocab_size
    tag = f"snapshot {quant or 'none'}"
    kw = dict(num_slots=8, chunk_size=16)
    dec = LlamaDecoder(model, max_len=256, quant=quant)

    def submit(eng, rs, sampling=None):
        kws = ([{}] * len(rs) if sampling is None else
               [dict(seed=sd, temperature=t) for sd, t in sampling])
        return [eng.submit(p, n, eos_token_id=e, **k)
                for (p, n, e), k in zip(rs, kws)]

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    info = dict(phase="serve_snapshot", quant=quant or "none", card=card,
                requests=len(reqs))
    # (a) snapshot after the third chunk, restore into a new decoder
    eng = ServingEngine(dec, **kw)
    ids = submit(eng, reqs)
    got = {}
    for _ in range(3):
        got.update(eng.step())
    sdir = snapshot_dir(f"a_{quant or 'none'}")
    _, snap_s = synced(lambda: eng.snapshot(sdir))
    n_bytes = sum(os.path.getsize(os.path.join(sdir, f))
                  for f in os.listdir(sdir))
    in_flight, queued = (len(eng.scheduler.slots.occupied()),
                         len(eng.scheduler))
    check(in_flight >= 1 and queued >= 1, f"{tag}: the snapshot holds "
          f"{in_flight} in-flight and {queued} queued requests")
    del eng
    rdec = LlamaDecoder(model, max_len=256, quant=quant)
    fresh = ServingEngine(rdec, **kw)
    rinfo, restore_s = synced(lambda: fresh.restore(sdir))
    check(rinfo == dict(in_flight=in_flight, queued=queued,
                        remapped_rows=0), f"{tag}: restore gave {rinfo}")
    before = sum(len(t) for _, s in fresh.scheduler.slots.occupied()
                 for t in s.tokens)
    # the restored queue's ring prefills of at most 64 rows run the int8
    # kernel, as on the serving line
    small = sum(1 for r in fresh.scheduler.queued()
                if bucket_length(len(r.prompt)) <= 64)
    d0 = rdec.dispatch_count
    da.launches = i8.launches = 0
    out, drain_s = synced(fresh.drain)
    n_da, n_i8 = da.launches, i8.launches
    got.update(out)
    gens = collect(got, reqs, ids)
    check_lengths(tag, reqs, gens, V)
    m = fresh.metrics()
    check(m["corrupt_rows"] == 0, f"{tag}: non-finite logits in a row")
    check(m["prefill_dispatches"] == queued,
          f"{tag}: one prefill each restored queued request")
    check(rdec.dispatch_count - d0
          == m["prefill_dispatches"] + m["chunk_dispatches"],
          f"{tag}: dispatch identity")
    check_ring(tag, m, queued)
    steps = m["chunk_dispatches"] * fresh.chunk_size
    L = cfg.num_hidden_layers
    check(n_da == L * steps, f"{tag}: decode_attention launches {n_da} != "
          f"{L} x {steps}")
    want_i8 = (4 * L + 1) * (steps + small) if quant else 0
    check(n_i8 == want_i8,
          f"{tag}: int8_matmul launches {n_i8} != {want_i8}")
    # the tokens the restored engine decoded
    resumed = sum(len(gens[ids.index(r)]) for r in out) - before
    info["restore"] = dict(
        hold_to(f"{tag} (a)", rdec, reqs, gens, plain_gens),
        in_flight=in_flight, queued=queued, snapshot_ms=1e3 * snap_s,
        snapshot_bytes=n_bytes, restore_ms=1e3 * restore_s,
        resumed_tokens=resumed,
        resumed_drain_s=drain_s, resumed_tokens_per_s=resumed / drain_s,
        plain_tokens_per_s=plain_info["tokens_per_s"],
        chunk_dispatches=m["chunk_dispatches"],
        chunk_graphs_captured=sum(g is not None
                                  for g in rdec._chunk_graphs.values()),
        chunk_graph_replays=sum(g.replays for g in rdec._chunk_graphs.values()
                                if g is not None),
        graphs=graph_memory(rdec))
    info["decode_attention_launches"] = n_da
    info["int8_matmul_launches"] = n_i8
    del fresh, rdec
    shutil.rmtree(sdir, ignore_errors=True)

    # (b) row remap: a 4-slot snapshot restored into an 8-slot engine
    small = ServingEngine(dec, num_slots=4, chunk_size=16)
    ids = submit(small, reqs)
    got = {}
    for _ in range(3):
        got.update(small.step())
    sdir = snapshot_dir(f"b_{quant or 'none'}")
    small.snapshot(sdir)
    big = ServingEngine(dec, **kw)
    rinfo = big.restore(sdir)
    check(rinfo["remapped_rows"] == 4 and rinfo["in_flight"] >= 1,
          f"{tag}: remap restore gave {rinfo}")
    got.update(big.drain())
    gens = collect(got, reqs, ids)
    check_lengths(f"{tag} (b)", reqs, gens, V)
    rec = hold_to(f"{tag} (b)", dec, reqs, gens, plain_gens)
    if rec["bit_equal"]:
        rec["gate"] = teacher_forced(f"{tag} (b)", dec, reqs, gens)
    info["remap"] = dict(rec, **rinfo)
    del small, big
    shutil.rmtree(sdir, ignore_errors=True)

    # (c) migration of two in-flight rows and two queued requests
    def migrate(ekw, sampling, want, sampled):
        src, dst = ServingEngine(dec, **kw, **ekw), \
            ServingEngine(dec, **kw, **ekw)
        ids = submit(src, reqs, sampling)
        done = {}
        for _ in range(2):
            done.update(src.step())
        occ = [s.request.id for _, s in src.scheduler.slots.occupied()]
        qd = [r.id for r in src.scheduler.queued()]
        check(len(occ) >= 2 and len(qd) >= 2, f"{tag} (c): {len(occ)} "
              f"in flight and {len(qd)} queued after two chunks")
        move = occ[:2] + qd[:2]
        payload, ext_s = synced(lambda: src.extract_rows(move))
        mapping, abs_s = synced(lambda: dst.absorb_rows(payload))
        done.update(src.drain())
        moved = dst.drain()
        gens = collect({r: (moved[mapping[r]] if r in mapping
                            else done[r]) for r in ids}, reqs, ids)
        t = f"{tag} (c{' sampled' if sampled else ''})"
        check_lengths(t, reqs, gens, V)
        check(src.metrics()["rows_migrated_out"] == 4
              and dst.metrics()["rows_migrated_in"] == 4,
              f"{t}: migration counters")
        # absorbed rows are copied into the carry, not admitted: only the
        # moved queued requests go through the destination's ring
        check_ring(f"{t} source", src.metrics(), len(reqs) - 2)
        check_ring(f"{t} destination", dst.metrics(), 2)
        return dict(hold_to(t, dec, reqs, gens, want, sampled),
                    extract_ms_per_row=1e3 * ext_s / 2,
                    absorb_ms_per_row=1e3 * abs_s / 2,
                    payload_bytes=len(payload["data"]),
                    payload_bytes_per_row=(len(payload["data"]) / 2))

    info["migrate"] = migrate({}, None, plain_gens, False)
    if sampled_gens is not None:
        sampling = [(1000 + j, 1e-4 if j == 0 else 0.7 + 0.3 * j / 15)
                    for j in range(len(reqs))]
        info["migrate_sampled"] = migrate(
            dict(do_sample=True, top_k=50, top_p=0.9), sampling,
            sampled_gens, True)

    # (d) deadlines, driven by budget values
    eng = ServingEngine(dec, **kw)
    p, n, e = reqs[0]
    try:
        eng.submit(p, n, eos_token_id=e, deadline_s=0.0)
        check(False, f"{tag}: an expired budget was accepted")
    except DeadlineExceededError:
        pass
    rid = eng.submit(p, n, eos_token_id=e, deadline_s=3600.0)
    eng.step()
    slot = next(s for _, s in eng.scheduler.slots.occupied())
    slot.request.deadline_at = time.monotonic() - 1.0
    res = dict(eng.step())[rid]
    part = np.asarray(res)[0, len(p):]
    check(res.resilience["serving"]["deadline_expired"] is True
          and 0 < len(part) < len(plain_gens[0])
          and np.array_equal(part, plain_gens[0][:len(part)]),
          f"{tag} (d): the expired row returned {len(part)} tokens, not a "
          f"flagged prefix of the plain line's {len(plain_gens[0])}")
    m = eng.metrics()
    check(m["shed_deadline"] == 1 and m["deadline_expired_rows"] == 1,
          f"{tag} (d): shed counters {m['shed_deadline']} / "
          f"{m['deadline_expired_rows']}")
    eng = ServingEngine(dec, **kw)
    ids = submit(eng, reqs)
    got = {}
    for _ in range(2):
        got.update(eng.step())
    sdir = snapshot_dir(f"d_{quant or 'none'}")
    got.update(eng.drain(deadline_s=0.0, snapshot_path=sdir))
    check(eng.scheduler.slots.occupied() and eng.metrics()["snapshots"] == 1,
          f"{tag} (d): the graceful drain did not snapshot its work")
    fresh = ServingEngine(dec, **kw)
    fresh.restore(sdir)
    got.update(fresh.drain())
    gens = collect(got, reqs, ids)
    check_lengths(f"{tag} (d)", reqs, gens, V)
    info["deadlines"] = dict(
        partial_tokens=len(part), plain_tokens=len(plain_gens[0]),
        graceful_drain=hold_to(f"{tag} (d)", dec, reqs, gens, plain_gens))
    shutil.rmtree(sdir, ignore_errors=True)
    info["phase_s"] = time.perf_counter() - t_start
    emit(info)
    del eng, fresh, dec
    torch.cuda.empty_cache()
    return info


# -- the degradation ladder and observability ---------------------------------

def ring_schedule(reqs, lens, slots, T):
    """The serving line's rows at each chunk, simulated from the plain
    line's token counts (FIFO admission into freed slots, every row +T a
    chunk): for chunk c (1-based), the tokens each occupied request still
    needs before it. What (c) picks its failing chunk from."""
    queue = list(range(len(reqs)))
    rows, out = {}, []
    while queue or rows:
        while queue and len(rows) < slots:
            rows[queue.pop(0)] = 0
        out.append({j: lens[j] - n for j, n in rows.items()})
        for j in list(rows):
            rows[j] += T
            if rows[j] >= lens[j]:
                del rows[j]
    return out


@contextlib.contextmanager
def flags_set(values):
    """Set the port's flags ``values`` for the block, then give each flag
    back the value it had (an environment's ``FLAGS_<name>`` included)."""
    from paddle_tpu_torch.flags import flags, set_flags
    old = {k: flags.get(k) for k in values}
    set_flags(values)
    try:
        yield
    finally:
        set_flags(old)


def serve_faults(model, quant, reqs, plain_gens, plain_info, spec, card):
    """The fault line (module docstring, step 4): drills (a)-(e) on the
    serving line's model and requests, each against the plain line, with
    no backoff between retries."""
    with flags_set({"resilience_backoff_s": 0.0}):
        return _fault_drills(model, quant, reqs, plain_gens, plain_info,
                             spec, card)


def _fault_drills(model, quant, reqs, plain_gens, plain_info, spec, card):
    import os
    import tempfile
    import urllib.request

    from paddle_tpu_torch import obs
    from paddle_tpu_torch.flags import flags, set_flags
    from paddle_tpu_torch.inference.generate import LlamaDecoder
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.ops.kernels import int8_matmul as i8
    from paddle_tpu_torch.runtime.resilience import (DecodeFailedError,
                                                     fault_injector)
    from paddle_tpu_torch.serving import ServingEngine, bucket_length

    t_start = time.perf_counter()
    cfg = model.config
    V, L, T = cfg.vocab_size, cfg.num_hidden_layers, 16
    tag = f"faults {quant or 'none'}"
    kw = dict(num_slots=8, chunk_size=T)
    dec = LlamaDecoder(model, max_len=256, quant=quant)
    small = sum(1 for p, _, _ in reqs if bucket_length(len(p)) <= 64)
    plain_tps = plain_info["tokens_per_s"]
    info = dict(phase="serve_faults", quant=quant or "none", card=card,
                requests=len(reqs), plain_tokens_per_s=plain_tps)

    def run(eng, plan, hook=None):
        """Drain ``reqs`` under ``plan``: (tokens, results, wall s, the
        decode-attention and int8 launches)."""
        torch.cuda.synchronize()
        da.launches = i8.launches = 0
        fault_injector.configure(plan)
        try:
            t0 = time.perf_counter()
            ids = [eng.submit(p, n, eos_token_id=e) for p, n, e in reqs]
            out = eng.drain()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            fault_injector.clear()
        return collect(out, reqs, ids), out, ids, wall, (da.launches,
                                                         i8.launches)

    def identities(t, m, launches):
        steps = m["chunk_dispatches"] * T + m["step_dispatches"]
        want = (L * steps, (4 * L + 1) * (steps + small) if quant else 0)
        check(launches == want, f"{t}: decode_attention / int8_matmul "
              f"launches {launches} != {want} ({steps} steps)")
        return steps

    # (a) one transient at the third chunk dispatch, retried
    eng = ServingEngine(dec, **kw)
    run(eng, [])                        # the keys' warm-up and capture
    riders = []
    inner = eng._dispatch_chunk

    def noted(occupied):
        riders.append([s.request.id for _, s in occupied])
        return inner(occupied)

    eng._dispatch_chunk = noted
    c0 = eng.metrics()
    gens, out, ids, wall, launches = run(eng, [
        {"kind": "dispatch_error", "site": "decode.chunk", "call": 3}])
    m = eng.metrics()
    d = {k: m[k] - c0[k] for k in ("prefill_dispatches", "chunk_dispatches",
                                   "step_dispatches", "degradations")}
    t = f"{tag} (a)"
    check(d["prefill_dispatches"] == plain_info["prefill_dispatches"]
          and d["chunk_dispatches"] == plain_info["chunk_dispatches"]
          and d["step_dispatches"] == d["degradations"] == 0,
          f"{t}: dispatches {d} against the plain line's "
          f"{plain_info['prefill_dispatches']} / "
          f"{plain_info['chunk_dispatches']}")
    retried = sorted(rid for rid in ids if out[rid].resilience["retries"])
    check(retried == sorted(riders[2]) and all(
        out[rid].resilience["retries"] in (0, 1) for rid in ids),
          f"{t}: records with a retry {retried}, rows of chunk 3 "
          f"{riders[2]}")
    identities(t, {"chunk_dispatches": d["chunk_dispatches"],
                   "step_dispatches": 0}, launches)
    n_tok = int(sum(len(g) for g in gens))
    info["retry"] = dict(hold_to(t, dec, reqs, gens, plain_gens),
                         tokens_per_s=n_tok / wall, wall_s=wall,
                         retried_requests=len(retried), **d,
                         decode_attention_launches=launches[0],
                         int8_matmul_launches=launches[1])
    eng._dispatch_chunk = inner

    # (b) every chunk from the third on fails for good: the per-token
    # rung, on the same warm engine (its first drain runs the rung key's
    # eager warm-up and capture, the second replays)
    stamps = {}
    fire = fault_injector._fire

    def fired(site, rule, detail):
        stamps.setdefault("fault", time.perf_counter())
        return fire(site, rule, detail)

    fault_injector._fire = fired
    rung = []
    step = eng._b.decode_step_ring

    def first_step(st, splice):
        stamps.setdefault("rung", time.perf_counter())
        return step(st, splice)

    eng._b.decode_step_ring = first_step
    for attempt in range(2):
        stamps.clear()
        c0 = eng.metrics()
        gens, out, ids, wall, launches = run(eng, [
            {"kind": "dispatch_error", "site": "decode.chunk", "call": 3,
             "times": 10 ** 6}])
        m = {k: eng.metrics()[k] - c0[k] for k in (
            "prefill_dispatches", "chunk_dispatches", "step_dispatches",
            "degradations")}
        t = f"{tag} (b) run {attempt}"
        check(m["degradations"] >= 1
              and m["step_dispatches"] == T * m["degradations"]
              and m["chunk_dispatches"] == 2
              and m["prefill_dispatches"] == len(reqs),
              f"{t}: chunks {m['chunk_dispatches']}, degradations "
              f"{m['degradations']}, steps {m['step_dispatches']}")
        st = eng.status()["resilience"]
        check(st == {"ladder_rung": "per_token",
                     "degradations": eng.metrics()["degradations"],
                     "step_dispatches": eng.step_dispatches},
              f"{t}: status {st}")
        check(all(out[rid].resilience["level"] == "per_token"
                  for rid in ids[len(ids) // 2:]),
              f"{t}: late requests' records not on the per-token rung")
        steps = identities(t, m, launches)
        n_tok = int(sum(len(g) for g in gens))
        rung.append(dict(hold_to(t, dec, reqs, gens, plain_gens),
                         tokens_per_s=n_tok / wall, wall_s=wall,
                         chunk_dispatches=m["chunk_dispatches"],
                         degradations=m["degradations"],
                         step_dispatches=m["step_dispatches"],
                         decode_steps=steps,
                         first_failure_to_rung_ms=1e3 * (
                             stamps["rung"] - stamps["fault"]),
                         decode_attention_launches=launches[0],
                         int8_matmul_launches=launches[1]))
    fault_injector._fire = fire
    del eng
    info["rung"] = rung[1]
    info["rung"]["first_run"] = {k: rung[0][k] for k in (
        "tokens_per_s", "first_failure_to_rung_ms", "bit_equal")}

    # (c) the ladder exhausted: harvest, then the postmortem
    lens = [len(g) for g in plain_gens]
    sched = ring_schedule(reqs, lens, kw["num_slots"], T)
    pick = next(((c, 2) for c, rows in enumerate(sched, 1)
                 if any(1 <= r <= 2 for r in rows.values())), None)
    if pick is None:
        pick = next((c, min(r for r in rows.values() if 0 < r % T))
                    for c, rows in enumerate(sched, 1)
                    if any(0 < r % T for r in rows.values()))
    fail_chunk, survive = pick
    flight = tempfile.mkdtemp(prefix="postmortem_")
    restore = {k: flags.get(k) for k in ("obs_enabled", "obs_flight_dir")}
    set_flags({"obs_enabled": True, "obs_flight_dir": flight})
    dump = obs.flight_recorder.dump
    dumped = {}

    def timed_dump(*a, **k):
        t0 = time.perf_counter()
        path = dump(*a, **k)
        dumped["ms"] = 1e3 * (time.perf_counter() - t0)
        return path

    obs.flight_recorder.dump = timed_dump
    eng = ServingEngine(dec, **kw)
    t = f"{tag} (c)"
    try:
        fault_injector.configure([
            {"kind": "dispatch_error", "site": "decode.chunk",
             "call": fail_chunk, "times": 10 ** 6},
            {"kind": "dispatch_error", "site": "decode.chunk_step",
             "call": survive + 1, "times": 10 ** 6, "code": "INTERNAL"}])
        ids = [eng.submit(p, n, eos_token_id=e) for p, n, e in reqs]
        try:
            eng.drain()
            raised = False
        except DecodeFailedError:
            raised = True
    finally:
        fault_injector.clear()
        obs.flight_recorder.dump = dump
        set_flags(restore)
    check(raised, f"{t}: no DecodeFailedError")
    path = obs.flight_recorder.last_path
    pm = json.load(open(path))
    extra = pm["extra"]
    done = {j: np.asarray(eng.result(rid))[0][len(reqs[j][0]):]
            for j, rid in enumerate(ids) if eng.result(rid) is not None}
    harvested = [ids.index(r) for r in extra["harvested_requests"]]
    check(harvested and set(harvested) <= set(done),
          f"{t}: harvested {extra['harvested_requests']}")
    for j, g in done.items():
        check(np.array_equal(g, plain_gens[j]), f"{t}: request {j} "
              f"finished with other tokens than the plain line's")
    live = {s.request.id: s for _, s in eng.scheduler.slots.occupied()}
    lost = {e["request"]: e["tokens_generated"]
            for e in extra["lost_requests"]}
    check(lost == {rid: int(sum(len(x) for x in s.tokens))
                   for rid, s in live.items()},
          f"{t}: lost_requests {lost} against the unfinished rows")
    for rid, n in lost.items():
        j = ids.index(rid)
        got = np.concatenate(live[rid].tokens) if n else np.zeros(0)
        check(n < len(plain_gens[j]) and np.array_equal(
            got, plain_gens[j][:n]), f"{t}: request {j}'s {n} tokens are "
            f"not a prefix of the plain line's")
    check(extra["site"] == "serve.chunk" and extra["replica"] is None
          and pm["reason"] == "serving.ladder_exhausted",
          f"{t}: postmortem {pm['reason']} {extra['site']}")
    info["exhausted"] = dict(
        fail_chunk=fail_chunk, rung_steps_survived=survive,
        harvested_requests=len(harvested),
        finished_requests=len(done), lost_requests=len(lost),
        postmortem_bytes=os.path.getsize(path),
        postmortem_ms=dumped["ms"])
    os.remove(path)
    os.rmdir(flight)
    del eng

    # (d) speculative -> chunked, unquantized, on the own-weights draft
    if quant is None:
        sreqs, K = spec["requests"], 4
        eng = ServingEngine(dec, draft_model=model,
                            num_speculative_tokens=K, **kw)
        d0 = dec.dispatch_count
        fault_injector.configure([{
            "kind": "dispatch_error", "site": "decode.chunk", "call": 2,
            "times": flags.resilience_retries + 1}])
        try:
            t0 = time.perf_counter()
            sids = [eng.submit(p, n, eos_token_id=e) for p, n, e in sreqs]
            out = eng.drain()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            fault_injector.clear()
        sgens = collect(out, sreqs, sids)
        m = eng.metrics()
        t = f"{tag} (d)"
        demotes = dec.dispatch_count - d0 - (
            m["prefill_dispatches"] + m["draft_prefill_dispatches"]
            + m["chunk_dispatches"])
        check(demotes == 1 and m["degradations"] == 1
              and eng.status()["speculative"]["active"] is False,
              f"{t}: {demotes} demotions, degradations "
              f"{m['degradations']}, status "
              f"{eng.status()['speculative']['active']}")
        check_lengths(t, sreqs, sgens, V)
        n_tok = int(sum(len(g) for g in sgens))
        info["spec_demote"] = dict(
            teacher_forced(t, dec, sreqs, sgens),
            bit_equal_plain=all(np.array_equal(a, b) for a, b in
                                zip(sgens, spec["plain_gens"])),
            tokens_per_s=n_tok / wall, wall_s=wall,
            plain_tokens_per_s=spec["plain"]["tokens_per_s"],
            plain_first_drain_tokens_per_s=spec["plain"]["tokens"]
            / spec["plain"]["first_drain_wall_s"],
            chunk_dispatches=m["chunk_dispatches"],
            draft_prefill_dispatches=m["draft_prefill_dispatches"])
        del eng

    # (e) obs on the served path
    eng = ServingEngine(dec, **kw)
    restore = {"obs_enabled": flags.obs_enabled}
    set_flags({"obs_enabled": True})
    try:
        obs.clear_cost_cache()
        m0 = obs.tracer.mark()
        gens, _, _, _, launches = run(eng, [])
        counts = obs.tracer.counts(m0)
        m = eng.metrics()
        t = f"{tag} (e)"
        check(counts.get("decode.admit_prefill") == m["prefill_dispatches"]
              and counts.get("decode.chunk") == m["chunk_dispatches"]
              and counts.get("serving.request") == len(reqs),
              f"{t}: spans {counts} against prefills "
              f"{m['prefill_dispatches']}, chunks {m['chunk_dispatches']}")
        obs_launches = launches
        # the second drain captures what the first warmed; the flags of
        # obs key no graph, so obs on and off replay the same graphs:
        # then on and off drains in turn, each timed
        run(eng, [])
        timed = {True: [], False: []}
        for on in (True, False, True, False):
            set_flags({"obs_enabled": on})
            g, _, _, w, _ = run(eng, [])
            timed[on].append((g, w))
        set_flags({"obs_enabled": True})
        cost = obs.site_costs().get("decode.chunk", {})
        check(cost.get("flops", 0) > 0 and cost.get("bytes_per_dispatch",
                                                    0) > 0,
              f"{t}: decode.chunk cost record {cost}")
        m1 = obs.tracer.mark()
        sess = obs.DeviceTraceSession().start()
        check(sess.active, f"{t}: the device trace did not start")
        traced, _, _, _, _ = run(eng, [])
        summary = sess.stop()
        chunks = [s for s in obs.tracer.spans_since(m1)
                  if s.name == "decode.chunk"]
        check(summary.get("coverage", 0) > 0 and chunks and all(
            s.attrs.get("device_ms", 0) > 0 for s in chunks),
              f"{t}: device attribution {summary}")
        exp = obs.ObsExporter(port=0).add_engine(eng)
        port = exp.start()
        try:
            txt = urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=10).read()
        finally:
            exp.stop()
        check(b"serving_chunk_dispatches" in txt,
              f"{t}: /metrics without serving_chunk_dispatches")
    finally:
        set_flags(restore)
    for g in [traced] + [g for on in timed for g, _ in timed[on]]:
        for j, (a, b) in enumerate(zip(g, gens)):
            check(np.array_equal(a, b), f"{t}: request {j} changed "
                  f"tokens between obs drains")
    n_tok = int(sum(len(g) for g in gens))
    tps = {on: [n_tok / w for _, w in timed[on]] for on in timed}
    chunk_ms = summary.get("by_site", {}).get("decode.chunk", {}).get(
        "device_ms_mean", 0.0)
    info["obs"] = dict(
        hold_to(t, dec, reqs, gens, plain_gens),
        spans=counts, tokens_per_s_obs_on=tps[True],
        tokens_per_s_obs_off=tps[False],
        chunk_flops=cost["flops"],
        chunk_bytes_per_dispatch=cost["bytes_per_dispatch"],
        chunk_peak_bytes=cost.get("peak_bytes"),
        chunk_peak_bytes_at_most=cost.get("peak_bytes_at_most"),
        chunk_device_ms_mean=chunk_ms,
        chunk_mfu=obs.mfu(cost["flops"], chunk_ms / 1e3, peak=BF16_FLOPS),
        coverage=summary.get("coverage"),
        device_total_ms=summary.get("device_total_ms"),
        attributed_ms=summary.get("attributed_ms"),
        device_ops=summary.get("device_ops"),
        by_site=summary.get("by_site"),
        decode_attention_launches=obs_launches[0],
        int8_matmul_launches=obs_launches[1])
    for k in ("decode_attention_launches", "int8_matmul_launches"):
        info[k] = (info["retry"][k] + info["obs"][k]
                   + sum(r[k] for r in rung))
    info["phase_s"] = time.perf_counter() - t_start
    emit(info)
    del eng, dec
    torch.cuda.empty_cache()
    return info


def _adam_lists(states):
    """The per-state lists ``adam_update`` takes after params and grads."""
    return ([st["moment1"] for st in states], [st["moment2"] for st in states],
            [st.get("master_weight") for st in states],
            [st["beta1_pow"] for st in states],
            [st["beta2_pow"] for st in states])


def adam_compare(params, mp, decoupled, steps=3, seed=0):
    """The Adam kernel (``update_many``) against its plain version
    (``adam_update_ref``) over ``params`` (CUDA tensors, updated in
    place) and clones of them, ``steps`` steps from fresh state with the
    same random gradients and an f32 device learning rate: every
    parameter, moment, master weight and beta pow must match bit for bit.
    Returns the kernel launches and the largest |difference| (0)."""
    from paddle_tpu_torch.ops.kernels import adam as ak
    from paddle_tpu_torch.optimizer import Adam, AdamW
    opt = (AdamW if decoupled else Adam)(1e-3, weight_decay=0.01,
                                          multi_precision=mp)
    kp = list(params)
    pp = [p.clone() for p in kp]
    ks = [opt.init_state(p) for p in kp]
    ps = [opt.init_state(p) for p in pp]
    lr = torch.full((), 1e-3, dtype=torch.float32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    n0 = ak.launches
    for _ in range(steps):
        grads = [torch.randn(p.shape, generator=g, device="cuda").to(p.dtype)
                 for p in kp]
        opt.update_many(grads, ks, kp, lr, 0.01)
        ak.adam_update_ref(pp, grads, *_adam_lists(ps), lr, opt._beta1,
                           opt._beta2, opt._epsilon, 0.01, decoupled)
    torch.cuda.synchronize()
    err = 0.0
    for i, (a, b, sa, sb) in enumerate(zip(kp, pp, ks, ps)):
        for what, x, y in [("param", a, b)] + [(k, sa[k], sb[k])
                                               for k in sa]:
            if x.numel():
                err = max(err, (x.float() - y.float()).abs().max().item())
            check(same_bits(x, y), f"adam ({'AdamW' if decoupled else 'Adam'}"
                  f", {a.dtype}, multi_precision={mp}): tensor {i} "
                  f"{tuple(a.shape)} {what} differs from the plain version")
    return dict(launches=ak.launches - n0, max_abs_err=err)


def adam_cases(tag, shapes):
    """``adam_compare`` over fresh tensors of ``shapes`` (x 0.02, bf16 or
    f32) for f32, bf16 with bf16 moments and bf16 with
    ``multi_precision=True``, Adam and AdamW, three steps each."""
    g = torch.Generator(device="cuda").manual_seed(1)
    out = []
    for dtype, mp in ((torch.float32, False), (torch.bfloat16, False),
                      (torch.bfloat16, True)):
        for decoupled in (False, True):
            params = [(0.02 * torch.randn(s, generator=g, device="cuda")
                       ).to(dtype) for s in shapes]
            r = adam_compare(params, mp, decoupled)
            del params
            out.append(dict(case=f"adam {tag} {str(dtype)[6:]} "
                            f"mp={mp} {'AdamW' if decoupled else 'Adam'}",
                            kernel="adam", tensors=len(shapes),
                            elements=sum(math.prod(s) for s in shapes),
                            steps=3, bit_equal=True, **r))
    torch.cuda.empty_cache()
    return out


def adam_case(name, shapes):
    """The main path's update over fresh bf16 tensors of ``shapes``: AdamW
    (lr 1e-4, weight decay 0.01) with bf16 moments, as the trainers run
    it. The kernel timed as a CUDA graph of 20 calls (and eagerly,
    ``eager_ms``), its plain version parameter by parameter, and
    ``torch.optim.AdamW(fused=True)`` on the same tensors, which the port
    never calls. The bound moves 14 bytes an element (p, g, m1, m2 read;
    p, m1, m2 written) at 3.35 TB/s."""
    from paddle_tpu_torch.ops.kernels import adam as ak
    from paddle_tpu_torch.optimizer import AdamW
    g = torch.Generator(device="cuda").manual_seed(2)
    bf = torch.bfloat16
    params = [(0.02 * torch.randn(s, generator=g, device="cuda")).to(bf)
              for s in shapes]
    grads = [torch.randn(s, generator=g, device="cuda").to(bf)
             for s in shapes]
    opt = AdamW(1e-4, weight_decay=0.01, multi_precision=False)
    states = [opt.init_state(p) for p in params]
    lr = torch.full((), 1e-4, dtype=torch.float32, device="cuda")

    def kern():
        opt.update_many(grads, states, params, lr, 0.01)

    def plain():
        ak.adam_update_ref(params, grads, *_adam_lists(states), lr,
                           opt._beta1, opt._beta2, opt._epsilon, 0.01, True)

    n0 = ak.launches
    kern()
    per_call = ak.launches - n0
    n = sum(math.prod(s) for s in shapes)
    b_ms, b_by = bound(14.0 * n, 20.0 * n, F32_FLOPS)
    row = dict(case=name, kernel="adam", tensors=len(shapes), elements=n,
               launches_per_call=per_call, ms=time_ms(kern, [()], iters=20),
               eager_ms=eager_ms(kern, [()], iters=20),
               plain_ms=eager_ms(plain, [()], iters=2))
    tp = [p.detach().clone().requires_grad_() for p in params]
    for t, gr in zip(tp, grads):
        t.grad = gr.clone()
    del params, grads, states
    lib = torch.optim.AdamW(tp, lr=1e-4, weight_decay=0.01, fused=True)
    row.update(library_ms=eager_ms(lambda: lib.step(), [()], iters=20),
               bound_ms=b_ms, bound_by=b_by)
    del lib, tp
    torch.cuda.empty_cache()
    row["bound_us"] = 1e3 * b_ms
    row["share_of_bound"] = b_ms / row["ms"]
    return row


# -- training phase -----------------------------------------------------------

class plain_kernels:
    """Inside the block the training wrappers run their plain versions on
    the card (module attributes swapped, restored on exit). Only this
    script does this: the port itself never routes a CUDA tensor to a
    plain version."""

    def __enter__(self):
        from paddle_tpu_torch.ops.kernels import flash_attention as fa
        from paddle_tpu_torch.ops.kernels import group_norm as gn
        from paddle_tpu_torch.ops.kernels import rms_norm as rn
        from paddle_tpu_torch.ops.kernels import rope as rp
        self.saved = [(fa, "flash_fwd", fa.flash_fwd_ref),
                      (fa, "flash_bwd", fa.flash_bwd_ref),
                      (rn, "rms_fwd", rn.rms_fwd_ref),
                      (rn, "rms_bwd", rn.rms_bwd_ref),
                      (gn, "gn_fwd", gn.gn_fwd_ref),
                      (gn, "gn_bwd", gn.gn_bwd_ref),
                      (rp, "rope_fwd", rp.rope_ref),
                      (rp, "rope_bwd", lambda g, c, s: rp.rope_ref(g, c, s,
                                                                   -1))]
        self.saved = [(m, a, getattr(m, a), f) for m, a, f in self.saved]
        for m, a, _, f in self.saved:
            setattr(m, a, f)

    def __exit__(self, *exc):
        for m, a, orig, _ in self.saved:
            setattr(m, a, orig)


def _grads(model, loss_fn, *batch):
    for p in model.parameters():
        p.grad = None
    loss = loss_fn(model, *batch)
    loss.backward()
    out = {n: p.grad.float().clone() for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    return loss.item(), out


def kernel_vs_plain(tag, model, loss_fn, *batch):
    """One backward with the kernels and one with their plain versions,
    from the same weights: the loss within two bf16 spacings of its value,
    each gradient at cosine >= 0.99."""
    loss_k, g_k = _grads(model, loss_fn, *batch)
    with plain_kernels():
        loss_p, g_p = _grads(model, loss_fn, *batch)
    spacing = 2.0 ** (math.floor(math.log2(abs(loss_p))) - 7)
    check(abs(loss_k - loss_p) <= 2 * spacing, f"{tag}: kernel loss "
          f"{loss_k} vs plain {loss_p}")
    cos = {n: torch.nn.functional.cosine_similarity(
        g_k[n].reshape(1, -1), g_p[n].reshape(1, -1)).item() for n in g_k}
    worst = min(cos, key=cos.get)
    check(cos[worst] >= 0.99, f"{tag}: gradient of {worst} at cosine "
          f"{cos[worst]} to the plain one")
    return dict(loss_kernel=loss_k, loss_plain=loss_p,
                min_grad_cosine=cos[worst], min_grad_cosine_param=worst)


def llama_loss(m, ids, labels):
    return m.loss(ids, labels)


def timed_steps(trainer, batch, timed, counters, eager=False):
    """``timed`` steps after every count in ``counters`` (module, attribute
    pairs) is set to 0; returns (losses, wall seconds, {name: launches}).
    The steps replay the trainer's CUDA graph, or with ``eager`` run the
    eager step (``_eager_step``)."""
    step = trainer._eager_step if eager else trainer.train_step
    torch.cuda.synchronize()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    t0 = time.perf_counter()
    losses = [step(*batch) for _ in range(timed)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return ([x.item() for x in losses], wall,
            {k: getattr(mod, attr) for k, (mod, attr) in counters.items()})


def profiled_step(trainer, batch, eager=False):
    """One more step under the profiler (device kernels only): a replay of
    the trainer's graph, or with ``eager`` an eager step."""
    step = trainer._eager_step if eager else trainer.train_step
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(*batch)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    info = device_profile(prof, pwall)
    info["wall_s"] = pwall
    return info, prof


def profiled_routes(trainer, batch, names):
    """A profiled replay and a profiled eager step: the busy share of
    each, and the named kernels' ms a step (with the Adam kernels') from
    the replay where the profiler names the kernels inside it, else from
    the eager step (``kernel_ms_from``)."""
    names = tuple(names) + ADAM_KERNELS
    g_info, g_prof = profiled_step(trainer, batch)
    e_info, e_prof = profiled_step(trainer, batch, eager=True)
    g_ms = kernel_ms(g_prof, names)
    named = "adam_kernel" in g_ms
    k_ms = g_ms if named else kernel_ms(e_prof, names)
    return dict(graph=g_info, eager=e_info, kernel_ms_per_step=k_ms,
                kernel_ms_from="graph replay" if named else "eager step",
                update_kernel_ms_per_step=sum(
                    v for k, v in k_ms.items() if k in ADAM_KERNELS)), \
        g_prof, e_prof, named


def saved_state(trainer):
    """A copy of the trainer's weights, optimizer state, step count and
    step key's counter (each route draws its dropout masks from it);
    returns ``restore(seed=True)``, which puts them back (the counter
    only with ``seed``)."""
    p0 = {n: p.detach().clone() for n, p in trainer.params.items()}
    s0 = {n: {k: v.clone() for k, v in st.items()}
          for n, st in trainer.opt_state.items()}
    c0, seed0 = trainer.optimizer._step_count, trainer._seed_dev.clone()

    def restore(seed=True):
        with torch.no_grad():
            for n, p in trainer.params.items():
                p.copy_(p0[n])
            for n, st in trainer.opt_state.items():
                for k, v in st.items():
                    v.copy_(s0[n][k])
            if seed:
                trainer._seed_dev.copy_(seed0)
        trainer.optimizer._step_count = c0

    return restore


def graph_vs_eager(tag, trainer, batch, steps=3, zero_grad=()):
    """The captured step against the eager step from the same weights and
    optimizer state (the graph for this batch is captured already; the
    weights, the state and the step key's counter are put back before
    each route, so both draw the same dropout masks). Gates:

    - one replay against one eager forward and backward: the loss bit for
      bit, every parameter's gradient at cosine >= 0.999;
    - the eager update (``update_many``) applied to the replay's own
      gradients gives the replay's parameters and optimizer state bit for
      bit;
    - ``steps`` replays against ``steps`` eager steps (``_eager_step``):
      the first loss bit-equal, later losses within two bf16 spacings, the
      same kernel launches a step.

    Each parameter's change over the ``steps`` steps is reported at its
    cosine to the eager change, beside the same cosine between two eager
    runs. The parameters named in ``zero_grad`` have a zero gradient in
    exact arithmetic (a key projection's bias: a shift shared by every
    key leaves the softmax as it is), so each route's gradient there is
    rounding noise and its cosine says nothing: each must instead be at
    most 1e-2 of the largest gradient norm of the other parameters. The flash backward sums dq in arrival order (ROADMAP.md section
    3), so the eager route does not repeat itself bit for bit, and bf16
    rounding of the small updates turns that into whole-spacing flips of
    a few per cent of the weights."""
    from paddle_tpu_torch.ops import kernels as K
    dev_batch = [trainer._put(b) for b in batch]
    graph = trainer._graphs.get(trainer._key(dev_batch))
    check(graph is not None, f"{tag}: no captured step for this batch")
    params = trainer.params
    p0 = {n: p.detach().clone() for n, p in params.items()}
    restore = saved_state(trainer)

    def state():
        return ({n: p.detach().clone() for n, p in params.items()},
                {n: {k: v.clone() for k, v in st.items()}
                 for n, st in trainer.opt_state.items()})

    # one replay, then one eager forward and backward from the same weights
    l_graph = trainer.train_step(*batch).item()
    g_graph = {n: g.clone() for n, g in graph.grads.items()}
    p_graph, s_graph = state()
    restore()
    for p in params.values():
        p.grad = None
    loss = trainer._loss(dev_batch)
    loss.backward()
    check(same_bits(loss.detach(), torch.tensor(l_graph, device="cuda")),
          f"{tag}: replay loss {l_graph} != eager {loss.item()}")
    g_cos = {}
    for n, p in params.items():
        # a parameter the loss does not reach has no eager gradient; the
        # trainer updates it with zeros (BERT's token types)
        gp = p.grad if p.grad is not None else torch.zeros_like(p)
        a, b = g_graph[n].float().reshape(-1), gp.float().reshape(-1)
        na, nb = a.norm().item(), b.norm().item()
        g_cos[n] = 1.0 if na == nb == 0 else (
            (a @ b).item() / (na * nb) if na and nb else 0.0)
    noise = {n: (g_graph[n].float().norm().item(),
                 (params[n].grad.float().norm().item()
                  if params[n].grad is not None else 0.0))
             for n in zero_grad}
    for n in zero_grad:
        g_cos.pop(n)
    worst_g = min(g_cos, key=g_cos.get)
    check(g_cos[worst_g] >= 0.999, f"{tag}: gradient of {worst_g} at "
          f"cosine {g_cos[worst_g]} to the eager one")
    scale = max(g_graph[n].float().norm().item() for n in g_cos)
    for n, (a, b) in noise.items():
        check(max(a, b) <= 1e-2 * scale, f"{tag}: gradient of {n}, zero "
              f"in exact arithmetic, has norms {a} / {b} against the "
              f"largest {scale}")
    # the eager update on the replay's gradients
    with torch.no_grad():
        for n, p in params.items():
            p.grad = g_graph[n]
        trainer._update(trainer._lr_tensor())
        for p in params.values():
            p.grad = None
    for n, p in params.items():
        check(same_bits(p.detach(), p_graph[n]), f"{tag}: the eager update "
              f"of {n} on the replay's gradients differs from the replay's")
        for k, v in trainer.opt_state[n].items():
            check(same_bits(v, s_graph[n][k]), f"{tag}: optimizer state "
                  f"{k} of {n} differs from the replay's")
    del g_graph, p_graph, s_graph

    def run(step):
        restore()
        torch.cuda.synchronize()
        before = K.launch_counts()
        losses = [step(*batch).item() for _ in range(steps)]
        after = K.launch_counts()
        moved = {n: (p.detach().float() - p0[n].float()).reshape(-1)
                 for n, p in params.items()}
        return losses, moved, {
            ".".join(map(str, k)): (n - before.get(k, 0)) / steps
            for k, n in after.items() if n != before.get(k, 0)}

    def change_cos(x, y):
        worst, name = 1.0, None
        for n in x:
            na, nb = x[n].norm().item(), y[n].norm().item()
            if na == nb == 0:
                continue
            c = (x[n] @ y[n]).item() / (na * nb) if na and nb else 0.0
            if c < worst:
                worst, name = c, n
        return worst, name

    g_losses, g_moved, g_launch = run(trainer.train_step)
    e_losses, e_moved, e_launch = run(trainer._eager_step)
    c_graph = change_cos(g_moved, e_moved)
    del g_moved
    e2_losses, e2_moved, _ = run(trainer._eager_step)
    c_eager = change_cos(e2_moved, e_moved)
    del e_moved, e2_moved, p0
    check(same_bits(torch.tensor(g_losses[0]), torch.tensor(e_losses[0])),
          f"{tag}: first loss of the graph {g_losses[0]} != eager "
          f"{e_losses[0]}")
    for i, (a, b) in enumerate(zip(g_losses, e_losses)):
        spacing = 2.0 ** (math.floor(math.log2(abs(b))) - 7)
        check(abs(a - b) <= 2 * spacing, f"{tag}: step {i} loss of the "
              f"graph {a} vs eager {b}")
    check(g_launch == e_launch, f"{tag}: launches a step, graph {g_launch} "
          f"vs eager {e_launch}")
    return dict(losses_graph=g_losses, losses_eager=e_losses,
                losses_eager_again=e2_losses,
                min_grad_cosine=g_cos[worst_g], min_grad_cosine_param=worst_g,
                zero_grad_norms=noise, update_on_replay_grads_bit_equal=True,
                min_change_cosine=c_graph[0],
                min_change_cosine_param=c_graph[1],
                min_change_cosine_eager_vs_eager=c_eager[0],
                min_change_cosine_eager_vs_eager_param=c_eager[1],
                launches_graph=g_launch, launches_eager=e_launch)


# the flash and RMSNorm kernels by name: the profiled steps report each
# one's ms
FLASH_KERNELS = ("flash_fwd_wgmma_kernel", "flash_bwd_prep_kernel",
                 "flash_bwd_wgmma_kernel", "flash_bwd_dq_convert_kernel")
RMS_KERNELS = ("rms_fwd_kernel", "rms_bwd_vec_kernel", "rms_dw_reduce_kernel")
ADAM_KERNELS = ("adam_kernel", "adam_pow_kernel")


def kernel_ms(prof, names):
    """Device ms of a profiled window per kernel whose name holds one of
    ``names``."""
    out = {}
    for t, key, _ in kernel_events(prof):
        for k in names:
            if k in key:
                out[k] = out.get(k, 0.0) + t / 1e3
    return out


def adam_launches_per_step(trainer) -> int:
    """Update-kernel launches one step makes: a launch for every 40 (the
    table's size) trainable tensors of one kind."""
    from paddle_tpu_torch.ops.kernels import _build
    cap = _build.library().adam_max_tensors()
    kinds = {}
    for n, p in trainer.params.items():
        st = trainer.opt_state[n]
        k = (p.dtype, st["moment1"].dtype, "master_weight" in st)
        kinds[k] = kinds.get(k, 0) + 1
    return sum(-(-c // cap) for c in kinds.values())


def train_phase(card):
    """bench.py's bench_llama on the card: the 134M Llama (vocab 32000,
    hidden 768, intermediate 2048, 12 layers, 12 heads, MHA, bf16) through
    ShardedTrainer with AdamW(1e-4, multi_precision=False), B 8, S 1024,
    the fixed batch of numpy seed 0, weights from a seeded generator. The
    Adam kernel against its plain version on the model's tensors; the
    step as a replayed CUDA graph against the eager step; the launches,
    times and profiles of both routes. Then the same with use_fused_rope
    on: the rope kernel against its plain version in one backward, the
    rope key's own graph against the eager step, and the step time with
    rope's kernel beside the step time without it, in this one run."""
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops.kernels import adam as ak
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import rms_norm as rn
    from paddle_tpu_torch.ops.kernels import rope as rp
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ShardedTrainer

    cfg = LlamaConfig(vocab_size=32000, hidden_size=768,
                      intermediate_size=2048, num_hidden_layers=12,
                      num_attention_heads=12, num_key_value_heads=12,
                      max_position_embeddings=1024, dtype="bfloat16")
    B, S = 8, 1024
    model = LlamaForCausalLM(cfg, seed=0)
    shapes = [tuple(p.shape) for p in model.parameters() if p.requires_grad]
    adam_rows = adam_cases("bench_llama", shapes)
    adam_rows.append(adam_case("adam bf16 AdamW bench_llama", shapes))
    for r in adam_rows:
        emit(r)
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                          device="cuda")
    labels = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                             device="cuda")
    batch = (ids, labels)
    vs_plain = kernel_vs_plain("train", model, llama_loss, *batch)

    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                multi_precision=False)
    trainer = ShardedTrainer(model, opt, llama_loss)
    # the eager warm-up step, then the capture and its first replay
    losses = [trainer.train_step(*batch).item() for _ in range(2)]
    timed = 6
    counters = dict(flash_attention_fwd=(fa, "fwd_launches"),
                    flash_attention_bwd=(fa, "bwd_launches"),
                    rms_norm_fwd=(rn, "fwd_launches"),
                    rms_norm_bwd=(rn, "bwd_launches"),
                    rope_fwd=(rp, "fwd_launches"),
                    rope_bwd=(rp, "bwd_launches"),
                    adam=(ak, "launches"))
    step_losses, wall, launches = timed_steps(trainer, batch, timed,
                                              counters)
    replay_host_ms = 1e3 * trainer.update_host_s
    losses += step_losses
    L = cfg.num_hidden_layers
    per_step = dict(flash_attention_fwd=L, flash_attention_bwd=L,
                    rms_norm_fwd=2 * L + 1, rms_norm_bwd=2 * L + 1,
                    rope_fwd=0, rope_bwd=0,
                    adam=adam_launches_per_step(trainer))
    for what, per in per_step.items():
        check(launches[what] == per * timed, f"train: {what} launches "
              f"{launches[what]} != {per} x {timed} steps")
    check(all(math.isfinite(x) for x in losses), f"train: losses {losses}")
    check(abs(losses[0] - math.log(cfg.vocab_size)) <= 0.5,
          f"train: first loss {losses[0]} not within 0.5 of ln V")
    check(losses[-1] < losses[0], f"train: loss did not fall over "
          f"{len(losses)} steps: {losses}")
    vs_eager = graph_vs_eager("train", trainer, batch)
    e_losses, e_wall, e_launches = timed_steps(trainer, batch, timed,
                                               counters, eager=True)
    eager_update_host_ms = 1e3 * trainer.update_host_s
    check(e_launches == launches, f"train: eager launches {e_launches} "
          f"!= the graph's {launches}")
    check(all(math.isfinite(x) for x in e_losses),
          f"train: eager losses {e_losses}")
    step_s = wall / timed
    flops = model.flops_per_token(S) * B * S
    info = dict(phase="train", card=card, batch=B, seq=S,
                params=model.num_params(), steps=len(losses),
                losses=losses, step_ms=1e3 * step_s,
                step_ms_eager=1e3 * e_wall / timed,
                tokens_per_s=B * S / step_s,
                tokens_per_s_eager=B * S * timed / e_wall,
                mfu=flops / step_s / BF16_FLOPS,
                replay_host_ms=replay_host_ms,
                eager_update_host_ms=eager_update_host_ms,
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                launches_per_step={k: v / timed for k, v in launches.items()},
                kernel_vs_plain=vs_plain, graph_vs_eager=vs_eager)
    info["profiled"] = profiled_routes(trainer, batch,
                                       FLASH_KERNELS + RMS_KERNELS)[0]
    emit(info)

    # use_fused_rope on: 24 rope forward and 24 backward launches a step,
    # under a graph of its own key
    set_flags({"use_fused_rope": True})
    try:
        rope_vs_plain = kernel_vs_plain("train rope", model, llama_loss,
                                        *batch)
        for _ in range(2):
            trainer.train_step(*batch)
        r_losses, r_wall, r_launches = timed_steps(trainer, batch, timed,
                                                   counters)
        r_vs_eager = graph_vs_eager("train rope", trainer, batch)
        r_prof, prof = profiled_step(trainer, batch)
        r_ms = kernel_ms(prof, ("rope_kernel",))
        if "rope_kernel" not in r_ms:
            r_prof["rope_kernel_ms_from"] = "eager step"
            r_ms = kernel_ms(profiled_step(trainer, batch, eager=True)[1],
                             ("rope_kernel",))
        r_prof["rope_kernel_ms_per_step"] = r_ms.get("rope_kernel", 0.0)
    finally:
        set_flags({"use_fused_rope": False})
    for what, per in (("rope_fwd", 2 * L), ("rope_bwd", 2 * L),
                      ("flash_attention_fwd", L),
                      ("adam", per_step["adam"])):
        check(r_launches[what] == per * timed, f"train rope: {what} "
              f"launches {r_launches[what]} != {per} x {timed} steps")
    check(all(math.isfinite(x) for x in r_losses),
          f"train rope: losses {r_losses}")
    # the same number of steps with the flag off again (its first graph),
    # in this run
    o_losses, o_wall, _ = timed_steps(trainer, batch, timed, counters)
    rope = dict(phase="train_rope", card=card, steps=timed,
                losses=r_losses, step_ms_rope_kernel=1e3 * r_wall / timed,
                step_ms_rope_plain=1e3 * o_wall / timed,
                launches_per_step={k: v / timed
                                   for k, v in r_launches.items()},
                kernel_vs_plain=rope_vs_plain, graph_vs_eager=r_vs_eager,
                profiled=r_prof)
    emit(rope)
    launches["rope_fwd"] = r_launches["rope_fwd"]
    launches["rope_bwd"] = r_launches["rope_bwd"]
    del trainer, opt, model
    torch.cuda.empty_cache()
    return info, launches, adam_rows


class dtype_launches:
    """Within the block, the flash and RMSNorm kernel launches by
    direction and dtype, tallied at their wrappers (``flash_fwd`` /
    ``flash_bwd`` / ``rms_fwd`` / ``rms_bwd``, which launch once a
    call), e.g. ``{"flash_fwd": {"bfloat16": 12}}``."""

    def __enter__(self):
        from paddle_tpu_torch.ops.kernels import flash_attention as fa
        from paddle_tpu_torch.ops.kernels import rms_norm as rn
        self.counts, self.saved = {}, []
        for mod, name in ((fa, "flash_fwd"), (fa, "flash_bwd"),
                          (rn, "rms_fwd"), (rn, "rms_bwd")):
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))

            def wrapped(x, *a, _fn=fn, _name=name, **k):
                d = self.counts.setdefault(_name, {})
                dt = str(x.dtype).replace("torch.", "")
                d[dt] = d.get(dt, 0) + 1
                return _fn(x, *a, **k)
            setattr(mod, name, wrapped)
        return self.counts

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def dir_bytes(d):
    import os
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))


def train_amp(card):
    """The JAX package's own training recipe (bench.py ``_trainer_for``)
    on the card: bench_llama's 134M Llama with f32 parameters through
    ``ShardedTrainer(amp_dtype="bfloat16")`` and ``AdamW(1e-4,
    multi_precision=True, grad_clip=ClipGradByGlobalNorm(1.0))`` over
    ``LinearWarmup`` (4 steps, 1e-5 to 1e-4) of ``CosineAnnealingDecay``,
    B 8, S 1024, the seed-0 batch, the scheduler stepped after every
    step. Gates: an eager warm-up, the capture, then timed replays in
    which the learning rate differs at every step while the step keeps
    its one graph; the captured step against the eager step
    (``graph_vs_eager``); under AMP the flash kernels launch in bf16 and
    the RMSNorm kernels in f32 (an eager step's launches by dtype), and
    flash, RMSNorm and Adam launch in every replay; ``save`` at step k,
    ``load`` into a second trainer whose step graph is captured already:
    its parameters and optimizer state bit-equal to the saved ones, its
    next step's loss bit-equal to the uninterrupted trainer's and the one
    after within two bf16 spacings (printed beside the uninterrupted
    trainer loaded back and run again, and whether each is bit-equal).
    Prints
    step ms, MFU against the dense bf16 peak, and the save and load
    seconds and bytes."""
    import os
    import shutil

    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops.kernels import adam as ak
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import rms_norm as rn
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import (CosineAnnealingDecay,
                                               LinearWarmup)
    from paddle_tpu_torch.parallel import ShardedTrainer

    t_start = time.perf_counter()
    cfg = LlamaConfig(vocab_size=32000, hidden_size=768,
                      intermediate_size=2048, num_hidden_layers=12,
                      num_attention_heads=12, num_key_value_heads=12,
                      max_position_embeddings=1024, dtype="float32")
    B, S = 8, 1024
    rng = np.random.default_rng(0)
    batch = tuple(torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                                  device="cuda") for _ in range(2))

    def make(seed):
        model = LlamaForCausalLM(cfg, seed=seed)
        sched = LinearWarmup(CosineAnnealingDecay(1e-4, T_max=50),
                             warmup_steps=4, start_lr=1e-5, end_lr=1e-4)
        opt = AdamW(sched, parameters=model.parameters(),
                    multi_precision=True,
                    grad_clip=ClipGradByGlobalNorm(1.0))
        return ShardedTrainer(model, opt, llama_loss,
                              amp_dtype="bfloat16"), sched

    trainer, sched = make(0)
    check(all(p.dtype == torch.float32 for p in trainer.params.values()),
          "train_amp: parameters not f32")

    def step(tr, sc):
        loss = tr.train_step(*batch)
        sc.step()
        return loss

    losses = [step(trainer, sched).item() for _ in range(2)]
    key = next(iter(trainer._graphs))
    graph = trainer._graphs[key]
    check(len(trainer._graphs) == 1 and graph is not None,
          "train_amp: no captured step after the warm-up")
    counters = dict(flash_attention_fwd=(fa, "fwd_launches"),
                    flash_attention_bwd=(fa, "bwd_launches"),
                    rms_norm_fwd=(rn, "fwd_launches"),
                    rms_norm_bwd=(rn, "bwd_launches"),
                    adam=(ak, "launches"))
    timed = 4
    torch.cuda.synchronize()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    lrs = []
    t0 = time.perf_counter()
    for _ in range(timed):
        losses.append(step(trainer, sched))
        lrs.append(trainer._lr[0])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses[2:] = [x.item() for x in losses[2:]]
    launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
    check(len(set(lrs)) == timed, f"train_amp: the learning rate did not "
          f"move at every step: {lrs}")
    check(list(trainer._graphs) == [key] and trainer._graphs[key] is graph,
          "train_amp: a learning-rate change captured a new step")
    for k, n in launches.items():
        check(n > 0, f"train_amp: {k} never launched in the replays")
    check(all(math.isfinite(x) for x in losses),
          f"train_amp: losses {losses}")
    check(abs(losses[0] - math.log(cfg.vocab_size)) <= 0.5,
          f"train_amp: first loss {losses[0]} not within 0.5 of ln V")
    with dtype_launches() as by_dtype:
        trainer._eager_step(*batch)
    sched.step()
    check(set(by_dtype.get("flash_fwd", {})) == {"bfloat16"}
          and set(by_dtype.get("flash_bwd", {})) == {"bfloat16"}
          and set(by_dtype.get("rms_fwd", {})) == {"float32"}
          and set(by_dtype.get("rms_bwd", {})) == {"float32"},
          f"train_amp: kernel dtypes under AMP {by_dtype}")
    vs_eager = graph_vs_eager("train_amp", trainer, batch, steps=2)

    # save at step k; a second trainer, its step graph captured on other
    # weights, loads it: every tensor bit-equal to the saved trainer's,
    # its first step's loss bit-equal to the uninterrupted trainer's, the
    # second within two bf16 spacings (ROADMAP.md section 3, entry 43:
    # the flash backward sums dq in arrival order), beside the
    # uninterrupted trainer loaded back and run again as the control
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "checkpoints", "train_amp")
    shutil.rmtree(d, ignore_errors=True)
    other, osched = make(1)
    for _ in range(2):
        step(other, osched)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.save(d)
    save_s = time.perf_counter() - t0
    saved_sched = sched.state_dict()
    nbytes = dir_bytes(d)
    t0 = time.perf_counter()
    other.load(d)
    osched.set_state_dict(saved_sched)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    for n, p in trainer.params.items():
        check(same_bits(p.detach(), other.params[n].detach()),
              f"train_amp: loaded {n} differs from the saved one")
        for k, v in trainer.opt_state[n].items():
            check(same_bits(v, other.opt_state[n][k]), f"train_amp: "
                  f"loaded optimizer state {k} of {n} differs")
    want = [step(trainer, sched) for _ in range(2)]
    got = [step(other, osched) for _ in range(2)]
    trainer.load(d)
    sched.set_state_dict(saved_sched)
    again = [step(trainer, sched) for _ in range(2)]
    shutil.rmtree(d, ignore_errors=True)
    check(same_bits(got[0], want[0]) and same_bits(again[0], want[0]),
          f"train_amp: the first resumed loss {got[0].item()} / "
          f"{again[0].item()} != uninterrupted {want[0].item()}")
    spacing = 2.0 ** (math.floor(math.log2(abs(want[1].item()))) - 7)
    check(abs(got[1].item() - want[1].item()) <= 2 * spacing,
          f"train_amp: second resumed loss {got[1].item()} vs "
          f"uninterrupted {want[1].item()}")
    check(len(other._graphs) == 1, "train_amp: the load captured anew")
    step_s = wall / timed
    flops = trainer.model.flops_per_token(S) * B * S
    info = dict(phase="train_amp", card=card, batch=B, seq=S,
                params=trainer.model.num_params(), losses=losses,
                learning_rates=lrs, step_ms=1e3 * step_s,
                tokens_per_s=B * S / step_s,
                mfu=flops / step_s / BF16_FLOPS,
                launches_per_step={k: v / timed
                                   for k, v in launches.items()},
                eager_launches_by_dtype=by_dtype,
                graph_vs_eager=vs_eager, save_s=save_s, load_s=load_s,
                checkpoint_bytes=nbytes,
                resumed_losses=[x.item() for x in got],
                uninterrupted_losses=[x.item() for x in want],
                reloaded_losses=[x.item() for x in again],
                resumed_bit_equal=[same_bits(a, b)
                                   for a, b in zip(got, want)],
                reloaded_bit_equal=[same_bits(a, b)
                                    for a, b in zip(again, want)],
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    del trainer, other, graph
    torch.cuda.empty_cache()
    info["phase_s"] = time.perf_counter() - t_start
    emit(info)
    return info


# -- the other model families: GPT, BERT, the MoE LM --------------------------

def _moe_lm(V, d, f, E, n_blocks, dev):
    """bench.py's bench_moe LM: an Embedding, ``n_blocks`` blocks of
    ``x + MoEMLP(LayerNorm(x))`` (top-2, ragged dispatch), the head tied
    to the embedding through the fused lm-head CE; bf16 parameters from
    seed 0."""
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.incubate.nn import MoEMLP
    from paddle_tpu_torch.ops.fused_ce import fused_lm_loss

    g = torch.Generator(device=dev).manual_seed(0)
    kw = dict(device=dev, dtype=torch.bfloat16)

    class Block(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.norm = tnn.LayerNorm(d, **kw)
            self.moe = MoEMLP(d, f, n_experts=E, top_k=2, dispatch="ragged",
                              generator=g, **kw)

        def forward(self, x):
            return x + self.moe(self.norm(x))

    class MoELM(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.embed = tnn.Embedding(V, d, generator=g, **kw)
            self.blocks = tnn.LayerList([Block() for _ in range(n_blocks)])

        def loss(self, ids, labels):
            h = self.embed(ids)
            for b in self.blocks:
                h = b(h)
            return fused_lm_loss(h, self.embed.weight.t(), labels)

    return MoELM()


def model_loss(m, ids, labels):
    return m.loss(ids, labels)


def dropout_checks(tag, trainer, batch, p):
    """The step key drives the masks: from one set of weights and state,
    two replays at counters c and c + 1 give different losses, an eager
    step at counter c gives the first replay's loss bit for bit, and a
    mask drawn at the activations' shape keeps a share of its elements
    within 4 sigma of 1 - p."""
    from paddle_tpu_torch.framework import random as rng_state
    from paddle_tpu_torch.nn import functional as F
    seed0 = trainer._seed_dev.clone()
    restore = saved_state(trainer)
    a = trainer.train_step(*batch)
    restore(seed=False)          # the counter moves on: c + 1
    b = trainer.train_step(*batch)
    restore()
    e = trainer._eager_step(*batch)
    check(not same_bits(a, b), f"{tag}: two replays at counters c and c + 1 "
          f"drew the same masks (loss {a.item()})")
    check(same_bits(a, e), f"{tag}: eager step at counter c {e.item()} != "
          f"the replay's {a.item()}")
    B, S = batch[0].shape
    ones = torch.ones(B, S, trainer.model.config.hidden_size,
                      device="cuda", dtype=torch.bfloat16)
    rng_state.push_trace_key(torch.stack([torch.zeros_like(seed0), seed0]))
    try:
        kept = (F.dropout(ones, p=p) != 0).sum().item() / ones.numel()
    finally:
        rng_state.pop_trace_key()
    sigma = math.sqrt(p * (1 - p) / ones.numel())
    check(abs(kept - (1 - p)) <= 4 * sigma, f"{tag}: keep rate {kept} not "
          f"within 4 sigma ({sigma}) of {1 - p}")
    restore()
    return dict(replay_losses=[a.item(), b.item()], eager_loss=e.item(),
                keep_rate=kept, keep_rate_sigma=sigma)


def family_line(tag, card, model, batch, flops_per_step, flops_formula,
                counters, dropout=0.0, timed=5, zero_grad=()):
    """One model family trained on the card as its bench trains it:
    ``ShardedTrainer(mesh=None)`` with AdamW(1e-4,
    multi_precision=False) over bf16 parameters, the fixed batch. The
    eager warm-up, the capture, ``timed`` timed replays (finite losses
    that fall), ``graph_vs_eager`` (the first replayed loss bit-equal to
    the eager step's under the same key), with dropout the key checks of
    ``dropout_checks``, every counted kernel launched in the replays,
    the step ms, tokens/s, MFU against the dense bf16 peak
    (``flops_per_step``, whose formula the line prints), peak memory
    and a profiled replay's busy share and costliest kernels."""
    from paddle_tpu_torch.incubate.nn import moe
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ShardedTrainer

    t_start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                multi_precision=False)
    trainer = ShardedTrainer(model, opt, model_loss, mesh=None)
    check(all(p.dtype == torch.bfloat16 for p in trainer.params.values()),
          f"{tag}: parameters not bf16")
    n_params = sum(p.numel() for p in model.parameters())
    moe.grouped_mm_calls = 0
    losses = [trainer.train_step(*batch).item()]      # the eager warm-up
    eager_grouped = moe.grouped_mm_calls
    losses.append(trainer.train_step(*batch).item())  # capture, replay
    key = next(iter(trainer._graphs))
    check(len(trainer._graphs) == 1 and trainer._graphs[key] is not None,
          f"{tag}: no captured step after the warm-up")
    step_losses, wall, launches = timed_steps(trainer, batch, timed,
                                              counters)
    losses += step_losses
    for k, n in launches.items():
        check(n > 0, f"{tag}: {k} never launched in {timed} replays")
    check(all(math.isfinite(x) for x in losses), f"{tag}: losses {losses}")
    check(losses[-1] < losses[0], f"{tag}: loss did not fall over "
          f"{len(losses)} steps: {losses}")
    vs_eager = graph_vs_eager(tag, trainer, batch, steps=2,
                              zero_grad=zero_grad)
    drop = (dropout_checks(tag, trainer, batch, dropout) if dropout
            else None)
    prof, pr = profiled_step(trainer, batch)
    step_s = wall / timed
    B, S = batch[0].shape
    info = dict(phase=tag, card=card, batch=B, seq=S, params=n_params,
                losses=losses, step_ms=1e3 * step_s,
                tokens_per_s=B * S / step_s,
                mfu=flops_per_step / step_s / BF16_FLOPS,
                mfu_formula=f"{flops_formula}, over the step's seconds "
                            f"and {BF16_FLOPS:.3g} FLOP/s (dense bf16)",
                replay_host_ms=1e3 * trainer.update_host_s,
                launches_per_step={k: v / timed
                                   for k, v in launches.items()},
                adam_launches_expected=adam_launches_per_step(trainer),
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                graph_vs_eager=vs_eager, dropout=drop,
                profiled=prof,
                kernel_ms_per_step=kernel_ms(pr, FLASH_KERNELS
                                             + ADAM_KERNELS
                                             + ("threefry",)))
    if eager_grouped:
        # torch._grouped_mm's kernels in the profiled replay: forward and
        # the two backward products of every expert FFN projection
        grouped = [dict(name=name[:120], ms=t / 1e3, count=c)
                   for t, name, c in kernel_events(pr)
                   if "GroupProblem" in name]
        check(sum(g["count"] for g in grouped) > 0, f"{tag}: no grouped "
              f"product kernel in a profiled replay: "
              f"{[k for _, k, _ in kernel_events(pr)][:40]}")
        info.update(grouped_mm_calls_eager_step=eager_grouped,
                    grouped_mm_kernels=grouped,
                    grouped_mm_kernel_launches_per_step=sum(
                        g["count"] for g in grouped),
                    grouped_mm_kernel_ms_per_step=sum(
                        g["ms"] for g in grouped))
    check(launches["adam"] == timed * info["adam_launches_expected"],
          f"{tag}: adam launches {launches['adam']}")
    del trainer, opt
    torch.cuda.empty_cache()
    info["phase_s"] = time.perf_counter() - t_start
    emit(info)
    return info, launches


def train_families(card):
    """The JAX package's other single-card benches on the card, each as
    ``family_line`` trains it, at the bench's full width, B and S:
    ``train_gpt`` (bench_ernie's GPT: vocab 30000, hidden 1024, 12
    layers, 16 heads, intermediate 4096, 1024 positions, dropout 0.1; B 8,
    S 1024), ``train_bert`` (bench_bert's BERT-base MLM: vocab 30522,
    hidden 768, 12 layers, 12 heads, intermediate 3072, dropout 0.0; B 16,
    S 512) and ``train_moe`` (bench_moe's LM: d 1024, f 4096, 8 experts,
    top-2, ragged dispatch, 4 blocks, V 32000, the fused CE; B 8, S 1024).
    Returns the three lines and the launches they counted."""
    from paddle_tpu_torch.models import (BertConfig, BertForMaskedLM,
                                         GPTConfig, GPTForCausalLM)
    from paddle_tpu_torch.ops.kernels import adam as ak
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import threefry as tf

    def batch(V, B, S):
        rng = np.random.default_rng(0)
        return tuple(torch.as_tensor(rng.integers(0, V, (B, S)),
                                     device="cuda") for _ in range(2))

    flash = dict(flash_attention_fwd=(fa, "fwd_launches"),
                 flash_attention_bwd=(fa, "bwd_launches"),
                 adam=(ak, "launches"))
    lines, launches = {}, {}
    cfg = GPTConfig(vocab_size=30000, hidden_size=1024, num_hidden_layers=12,
                    num_attention_heads=16, intermediate_size=4096,
                    max_position_embeddings=1024, dropout=0.1)
    model = GPTForCausalLM(cfg, seed=0, dtype=torch.bfloat16)
    n = model.num_params()
    B, S = 8, 1024
    lines["gpt"], launches["gpt"] = family_line(
        "train_gpt", card, model, batch(cfg.vocab_size, B, S),
        6 * n * B * S, f"6 N B S (bench.py bench_ernie), N = {n}",
        dict(flash, threefry=(tf, "launches")), dropout=cfg.dropout)
    del model
    cfg = BertConfig(dropout=0.0)
    model = BertForMaskedLM(cfg, seed=0, dtype=torch.bfloat16)
    n = model.num_params()
    B, S = 16, 512
    lines["bert"], launches["bert"] = family_line(
        "train_bert", card, model, batch(cfg.vocab_size, B, S),
        6 * n * B * S, f"6 N B S (bench.py bench_bert), N = {n}", flash,
        zero_grad=[n_ for n_, _ in model.named_parameters()
                   if n_.endswith("k_proj.bias")])
    del model
    V, d, f, E, L, k = 32000, 1024, 4096, 8, 4, 2
    model = _moe_lm(V, d, f, E, L, "cuda")
    B, S = 8, 1024
    # active parameters a token: the embedding (its head too), and a
    # block's LayerNorm, gate and top-k of its E expert FFNs
    active = V * d + L * (2 * d + d * E + k * (2 * d * f + f + d))
    lines["moe"], launches["moe"] = family_line(
        "train_moe", card, model, batch(V, B, S), 6 * active * B * S,
        f"6 N_active B S, N_active = V d + L (2 d + d E + k (2 d f + f + "
        f"d)) = {active} (V {V}, d {d}, f {f}, E {E}, k {k}, L {L})",
        dict(adam=(ak, "launches")))
    check(lines["moe"].get("grouped_mm_calls_eager_step") == 2 * L,
          f"train_moe: {lines['moe'].get('grouped_mm_calls_eager_step')} "
          f"grouped products in the eager step, not 2 x {L}")
    del model
    torch.cuda.empty_cache()
    return lines, launches


def unet_census(cfg, B, side, ctx_len, min_seq):
    """What one forward of the UNet does, counted from the config as the
    constructor builds it: multiply-adds of the convolutions and linears,
    of the attention products (q k^T and p v), the GroupNorm calls as
    (channels, HW, act), and the attention calls that take the flash
    kernels (key length >= min_seq)."""
    ch, tc = cfg.model_channels, 4 * cfg.model_channels
    c = dict(macs=B * (ch * tc + tc * tc), attn_macs=0, gn=[], flash=0)

    def conv(cin, cout, k, hw):
        c["macs"] += B * hw * cin * cout * k * k

    def res(cin, cout, s):
        c["gn"].append((cin, s * s, "silu"))
        conv(cin, cout, 3, s * s)
        c["macs"] += B * tc * cout
        c["gn"].append((cout, s * s, "silu"))
        conv(cout, cout, 3, s * s)
        if cin != cout:
            conv(cin, cout, 1, s * s)

    def attn(ch_, s):
        L = s * s
        c["gn"].append((ch_, L, None))
        c["macs"] += B * L * ch_ * 4 * ch_
        c["attn_macs"] += 2 * B * L * L * ch_
        c["flash"] += L >= min_seq
        if cfg.context_dim is not None:
            c["macs"] += (2 * B * L * ch_ * ch_
                          + B * ctx_len * cfg.context_dim * 2 * ch_)
            c["attn_macs"] += 2 * B * L * ctx_len * ch_
            c["flash"] += ctx_len >= min_seq

    s, cur, chans = side, ch, [ch]
    conv(cfg.in_channels, ch, 3, s * s)
    last = len(cfg.channel_mult) - 1
    for lvl, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            res(cur, ch * mult, s)
            cur = ch * mult
            if lvl in cfg.attention_levels:
                attn(cur, s)
            chans.append(cur)
        if lvl != last:
            s //= 2
            conv(cur, cur, 3, s * s)
            chans.append(cur)
    res(cur, cur, s)
    attn(cur, s)
    res(cur, cur, s)
    for lvl, mult in reversed(list(enumerate(cfg.channel_mult))):
        for _ in range(cfg.num_res_blocks + 1):
            res(cur + chans.pop(), ch * mult, s)
            cur = ch * mult
            if lvl in cfg.attention_levels:
                attn(cur, s)
        if lvl:
            s *= 2
            conv(cur, cur, 3, s * s)
    c["gn"].append((cur, s * s, "silu"))
    conv(cur, cfg.out_channels, 3, s * s)
    return c


# device kernels by kind, first match wins: cuDNN's NCHW <-> NHWC
# relayouts, convolution and GEMM kernels (cuDNN, cuBLAS), the port's
# own kernels, and PyTorch's elementwise, copy and reduction kernels
KINDS = (("layout", ("nchwToNhwc", "nhwcToNchw")),
         ("conv_gemm", ("cudnn", "xmma", "gemm", "nvjet", "cutlass",
                        "sm90_", "implicit_convolve", "wgrad", "dgrad")),
         ("port_kernels", ("gn_fwd_", "gn_bwd_", "gn_dwdb_", "flash_",
                           "rope_kernel", "rms_", "adam_")),
         ("elementwise_copy_reduce", ("at::native",)))


def kinds_ms(prof):
    """Device ms of a profiled window by kind of kernel (``KINDS``; the
    rest is ``other``)."""
    out = {}
    for t, key, _ in kernel_events(prof):
        kind = next((k for k, pats in KINDS
                     if any(p in key for p in pats)), "other")
        out[kind] = out.get(kind, 0.0) + t / 1e3
    return out


def unet_loss(m, x, t, ctx, tgt):
    """bench_unet's loss."""
    return ((m(x, t, ctx) - tgt).float() ** 2).mean()


def unet_phase(card):
    """bench.py's bench_unet on the card: UNetConfig() (model channels
    320, mult (1, 2, 4, 4), 2 res blocks, attention at levels 1-3, 8 heads,
    context 1024, 32 groups), bf16 parameters from a seeded generator,
    ShardedTrainer with AdamW(1e-4, multi_precision=False), B 8 latents
    4 x 64 x 64, timesteps in [0, 1000), context 8 x 77 x 1024, one batch
    from numpy seed 0 reused every step. The Adam kernel against its
    plain version on fresh tensors of the model's ten largest and ten
    smallest shapes, and timed over all its shapes; the step as a
    replayed CUDA graph against the eager step, and both routes' times
    and profiles."""
    from paddle_tpu_torch.flags import flags
    from paddle_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig
    from paddle_tpu_torch.ops.kernels import adam as ak
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import group_norm as gn
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ShardedTrainer

    cfg = UNetConfig()
    B, side, ctx_len = 8, 64, 77
    model = UNet2DConditionModel(cfg, dtype="bfloat16", seed=0)
    census = unet_census(cfg, B, side, ctx_len, flags.flash_attention_min_seq)
    n_gn, n_flash = len(census["gn"]), census["flash"]
    check((n_gn, n_flash) == (61, 5), f"unet: census {n_gn} GroupNorms, "
          f"{n_flash} flash calls")
    shapes = [tuple(p.shape) for p in model.parameters() if p.requires_grad]
    by_size = sorted(shapes, key=math.prod)
    adam_rows = adam_cases("bench_unet 10 largest + 10 smallest",
                           by_size[:10] + by_size[-10:])
    adam_rows.append(adam_case("adam bf16 AdamW bench_unet", shapes))
    for r in adam_rows:
        emit(r)
    rng = np.random.default_rng(0)
    bf = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                   device="cuda").to(torch.bfloat16)
    x = bf(rng.normal(size=(B, cfg.in_channels, side, side)))
    t = torch.as_tensor(rng.integers(0, 1000, (B,)).astype(np.int64),
                        device="cuda")
    ctx = bf(rng.normal(size=(B, ctx_len, cfg.context_dim)))
    tgt = bf(rng.normal(size=tuple(x.shape)))
    batch = (x, t, ctx, tgt)
    vs_plain = kernel_vs_plain("unet", model, unet_loss, *batch)

    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                multi_precision=False)
    trainer = ShardedTrainer(model, opt, unet_loss)
    torch.cuda.reset_peak_memory_stats()
    # the eager warm-up step, then the capture and its first replay
    losses = [trainer.train_step(*batch).item() for _ in range(2)]
    timed = 5
    counters = dict(group_norm_fwd=(gn, "fwd_launches"),
                    group_norm_bwd=(gn, "bwd_launches"),
                    flash_attention_fwd=(fa, "fwd_launches"),
                    flash_attention_bwd=(fa, "bwd_launches"),
                    adam=(ak, "launches"))
    step_losses, wall, launches = timed_steps(trainer, batch, timed,
                                              counters)
    replay_host_ms = 1e3 * trainer.update_host_s
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses += step_losses
    for what, per in (("group_norm_fwd", n_gn), ("group_norm_bwd", n_gn),
                      ("flash_attention_fwd", n_flash),
                      ("flash_attention_bwd", n_flash),
                      ("adam", adam_launches_per_step(trainer))):
        check(launches[what] == per * timed, f"unet: {what} launches "
              f"{launches[what]} != {per} x {timed} steps")
    check(all(math.isfinite(v) for v in losses), f"unet: losses {losses}")
    check(losses[-1] < losses[0], f"unet: loss did not fall over "
          f"{len(losses)} steps: {losses}")
    vs_eager = graph_vs_eager("unet", trainer, batch)
    e_losses, e_wall, e_launches = timed_steps(trainer, batch, timed,
                                               counters, eager=True)
    eager_update_host_ms = 1e3 * trainer.update_host_s
    check(e_launches == launches, f"unet: eager launches {e_launches} "
          f"!= the graph's {launches}")
    check(all(math.isfinite(v) for v in e_losses),
          f"unet: eager losses {e_losses}")
    step_s = wall / timed
    flops = 3 * 2 * (census["macs"] + census["attn_macs"])
    gn_elems = sum(B * ch_ * hw for ch_, hw, _ in census["gn"])
    esz = 2
    gn_bound = dict(
        fwd_ms=1e3 * 2 * gn_elems * esz / HBM_BYTES_PER_S,
        bwd_ms=1e3 * 3 * gn_elems * esz / HBM_BYTES_PER_S)
    info = dict(phase="unet_train", card=card, batch=B, latent=side,
                params=model.num_params(), steps=len(losses), losses=losses,
                step_ms=1e3 * step_s, step_ms_eager=1e3 * e_wall / timed,
                images_per_s=B / step_s, images_per_s_eager=B * timed / e_wall,
                step_tflop=flops / 1e12, mfu=flops / step_s / BF16_FLOPS,
                replay_host_ms=replay_host_ms,
                eager_update_host_ms=eager_update_host_ms,
                peak_memory_gb=peak,
                launches_per_step={k: v / timed for k, v in launches.items()},
                group_norm_elements_per_step=gn_elems,
                group_norm_bound_ms_per_step=gn_bound,
                kernel_vs_plain=vs_plain, graph_vs_eager=vs_eager)
    prof_info, g_prof, e_prof, named = profiled_routes(
        trainer, batch, ("gn_fwd_", "gn_bwd_", "gn_dwdb_") + FLASH_KERNELS)
    prof_info["ms_by_kind"] = kinds_ms(g_prof if named else e_prof)
    prof_info["ms_by_kind_eager"] = kinds_ms(e_prof)
    info["profiled"] = prof_info
    emit(info)
    del trainer, opt, model
    torch.cuda.empty_cache()
    return info, launches, adam_rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    parent = None
    if sys.argv[1:2] == ["--parent"] and len(sys.argv) == 3:
        parent = sys.argv[2]
    elif len(sys.argv) > 1:
        print("usage: python3 chip_smoke.py [--parent DIR]", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    from paddle_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{_build.build_seconds if _build.build_seconds is not None else 0:.2f} s)",
          flush=True)
    emit({"flash_build": flash_build_info()})
    if parent is not None:
        parent = parent_kernels(parent)
    t1 = time.perf_counter()
    cases = kernel_phase(parent)
    t2 = time.perf_counter()
    (runs, sampled, prefix, spec, lora, snap, faults, fleet,
     bundle) = serving_phase(card)
    t3 = time.perf_counter()
    _, launches, adam_llama = train_phase(card)
    amp = train_amp(card)
    t4 = time.perf_counter()
    _, unet_launches, adam_unet = unet_phase(card)
    t5 = time.perf_counter()
    families, fam_launches = train_families(card)
    fleet_s = " / ".join(f"{x['phase_s']:.1f}" for x in fleet)
    fam_s = " / ".join(f"{x['phase_s']:.1f}" for x in families.values())
    print(f"phases: build {t1 - t0:.1f} s, kernels {t2 - t1:.1f} s, "
          f"serving {t3 - t2:.1f} s (prefix "
          f"{sum(p['phase_s'] for p in prefix):.1f} s, speculative "
          f"{spec['phase_s']:.1f} s, lora "
          f"{sum(x['phase_s'] for x in lora):.1f} s, snapshot "
          f"{sum(x['phase_s'] for x in snap):.1f} s, faults "
          f"{sum(x['phase_s'] for x in faults):.1f} s, router / http / "
          f"cluster {fleet_s} s, bundle {bundle['phase_s']:.1f} s), "
          f"llama training "
          f"{t4 - t3:.1f} s (train_amp {amp['phase_s']:.1f} s), unet "
          f"training {t5 - t4:.1f} s, gpt / bert / moe training {fam_s} s",
          flush=True)
    served = runs + prefix + lora + snap + faults + fleet + [bundle]
    launches.update(
        decode_attention=sum(r["decode_attention_launches"] for r in served),
        decode_attention_draft=spec["skip3"]["decode_attention_launches"],
        threefry=sampled["threefry_launches"] + sum(
            r["threefry_launches"] for r in fleet + [bundle]),
        int8_matmul=sum(r["int8_matmul_launches"] for r in served),
        int8_matmul_verify=spec["int8w"]["int8_matmul_verify_launches"],
        group_norm_fwd=unet_launches["group_norm_fwd"],
        group_norm_bwd=unet_launches["group_norm_bwd"],
        flash_attention_fwd_d80=unet_launches["flash_attention_fwd"],
        flash_attention_bwd_d80=unet_launches["flash_attention_bwd"],
        adam_unet=unet_launches["adam"],
        flash_attention_fwd_gpt=fam_launches["gpt"]["flash_attention_fwd"],
        flash_attention_bwd_gpt=fam_launches["gpt"]["flash_attention_bwd"],
        flash_attention_fwd_bert=fam_launches["bert"]["flash_attention_fwd"],
        flash_attention_bwd_bert=fam_launches["bert"]["flash_attention_bwd"])
    # the same kernels on the families' paths: dropout's threefry, the
    # Adam update of their parameters
    launches["threefry"] += fam_launches["gpt"]["threefry"]
    launches["adam"] += sum(x["adam"] for x in fam_launches.values())
    for k, n in launches.items():
        check(n > 0, f"{k} never launched on its path")
    cases += adam_llama + adam_unet
    flash = "flash_attention bf16 B8 H12 S1024 D64 causal"
    flash80 = "flash_attention bf16 B8 H8 S1024 D80"
    flash_gpt = "flash_attention bf16 B8 H16 S1024 D64 causal"
    flash_bert = "flash_attention bf16 B16 H12 S512 D64"
    rms = "rms_norm bf16 8192x768"
    gn_case_ = "group_norm bf16 8x320x64x64 G32 silu"
    rope = "rope bf16 B8 S1024 H12 D64"
    fa_fwd_src = "paddle_tpu_torch/csrc/flash_fwd.cu"
    fa_bwd_src = "paddle_tpu_torch/csrc/flash_bwd.cu"
    fa_fwd = "paddle_tpu/ops/pallas/flash_attention.py:142 and :163"
    fa_bwd = "paddle_tpu/ops/pallas/flash_attention.py:304 and :325"
    # no pallas_call: the JAX trainer's jit fuses AdamW.update into the
    # step (paddle_tpu/parallel/train.py:234)
    adam_src = "paddle_tpu_torch/csrc/adam.cu"
    adam_jax = "paddle_tpu/optimizer/adam.py:116 (AdamW.update)"
    # no pallas_call: jax.random's threefry2x32_p, lowered by XLA, under
    # the sampler (paddle_tpu/inference/generate.py:2097 _sample_from)
    threefry_jax = ("paddle_tpu/inference/generate.py:2097 "
                    "(jax.random.categorical in _sample_from)")
    rows = []
    for name, kernel, src, replaces, case in (
            ("decode_attention", "decode_attention",
             "paddle_tpu_torch/csrc/decode_attention.cu",
             "paddle_tpu/ops/pallas/decode_attention.py:137",
             "decode_attention bf16 B8 H12 KV4 D64 L256"),
            ("decode_attention_draft", "decode_attention",
             "paddle_tpu_torch/csrc/decode_attention.cu",
             "paddle_tpu/ops/pallas/decode_attention.py:137",
             "decode_attention bf16 B8 H12 KV4 D64 L256 draft rows"),
            ("int8_matmul", "int8_matmul",
             "paddle_tpu_torch/csrc/int8_matmul.cu",
             "paddle_tpu/ops/pallas/int8_matmul.py:77",
             "int8_matmul bf16 B8 head 768x32000"),
            ("int8_matmul_verify", "int8_matmul",
             "paddle_tpu_torch/csrc/int8_matmul.cu",
             "paddle_tpu/ops/pallas/int8_matmul.py:77",
             "int8_matmul bf16 B40 verify"),
            ("flash_attention_fwd", "flash_attention_fwd", fa_fwd_src,
             fa_fwd, f"{flash} fwd"),
            ("flash_attention_bwd", "flash_attention_bwd", fa_bwd_src,
             fa_bwd, f"{flash} bwd"),
            ("flash_attention_fwd_d80", "flash_attention_fwd", fa_fwd_src,
             fa_fwd, f"{flash80} fwd"),
            ("flash_attention_bwd_d80", "flash_attention_bwd", fa_bwd_src,
             fa_bwd, f"{flash80} bwd"),
            ("flash_attention_fwd_gpt", "flash_attention_fwd", fa_fwd_src,
             fa_fwd, f"{flash_gpt} fwd"),
            ("flash_attention_bwd_gpt", "flash_attention_bwd", fa_bwd_src,
             fa_bwd, f"{flash_gpt} bwd"),
            ("flash_attention_fwd_bert", "flash_attention_fwd", fa_fwd_src,
             fa_fwd, f"{flash_bert} fwd"),
            ("flash_attention_bwd_bert", "flash_attention_bwd", fa_bwd_src,
             fa_bwd, f"{flash_bert} bwd"),
            ("rms_norm_fwd", "rms_norm_fwd",
             "paddle_tpu_torch/csrc/rms_norm.cu",
             "paddle_tpu/ops/pallas/rms_norm.py:75", f"{rms} fwd"),
            ("rms_norm_bwd", "rms_norm_bwd",
             "paddle_tpu_torch/csrc/rms_norm.cu",
             "paddle_tpu/ops/pallas/rms_norm.py:128", f"{rms} bwd"),
            ("rope_fwd", "rope_fwd", "paddle_tpu_torch/csrc/rope.cu",
             "paddle_tpu/ops/pallas/rope.py:70", f"{rope} fwd"),
            ("rope_bwd", "rope_bwd", "paddle_tpu_torch/csrc/rope.cu",
             "paddle_tpu/ops/pallas/rope.py:70", f"{rope} bwd"),
            ("group_norm_fwd", "group_norm_fwd",
             "paddle_tpu_torch/csrc/group_norm.cu",
             "paddle_tpu/ops/pallas/group_norm.py:139", f"{gn_case_} fwd"),
            ("group_norm_bwd", "group_norm_bwd",
             "paddle_tpu_torch/csrc/group_norm.cu",
             "paddle_tpu/ops/pallas/group_norm.py:196", f"{gn_case_} bwd"),
            ("adam", "adam", adam_src, adam_jax,
             "adam bf16 AdamW bench_llama"),
            ("adam_unet", "adam", adam_src, adam_jax,
             "adam bf16 AdamW bench_unet"),
            ("threefry", "threefry", "paddle_tpu_torch/csrc/threefry.cu",
             threefry_jax, "threefry R8 n32000")):
        c = next(c for c in cases if c["case"] == case)
        rows.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(x["max_abs_err"] for x in cases
                            if x["kernel"] == kernel
                            and "max_abs_err" in x),
            ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"], library_ms=c["library_ms"], case=case))
    emit({"kernels": rows})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
