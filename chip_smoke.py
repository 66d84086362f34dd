#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Drives the port's main paths and the nine hand-written CUDA kernels
they run (flash attention also at (hd, hdv) = (192, 128), DeepSeek-V2's
multi-head latent attention): the Faces 26-neighbour halo exchange through
``repro_torch``'s ST, host and fused executors (merged halo pack, merged
halo unpack with the per-rank max, counter bump, and the put that
carries its completion signal), the broadcast, ring and expert-parallel
a2a transports through the same three executors (the multicast put,
one launch a descriptor), granite-3-2b at full width served by the
port's continuous-batching engine (flash attention for prefill,
flash-decode), rwkv6-1.6b at full width served by the same engine (the
WKV6 recurrence), and jamba-1.5-large-398b at full width cut to 4
layers served by the same engine (the Mamba selective scan, flash
attention and flash-decode); granite and jamba also with ST-routed
decode, each decode step's collectives on the serve program through the
ST, host and fused executors (put_signal and the counter bump);
deepseek-v2-236b at full width cut to 4 layers (MLA: flash attention at
(192, 128) for prefill, absorbed products for decode) and
deepseek-moe-16b whole, served by the same engine; minitron-4b,
qwen3-32b and granite-34b (MQA: flash-decode at G = 48) served short at
full width; llama-3.2-vision-90b at full width cut to 20 layers (cross
attention over 1600 vision rows: flash attention not causal at prefill,
flash-decode over every vision row at decode) and musicgen-large whole
(MHA at hd 64; its frame frontend), served short; training: granite-3-2b
at full width, rwkv6-1.6b and a 3-layer jamba cut trained through the
train step, with flash attention, WKV6 and the selective scan under
autograd (the kernel forward, the plain version's VJP); the dry run's
accounting of each of those served and trained cells beside what the
card measured; and the static schedule verifier over every program the
run scheduled on the card.
Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each prints JSON lines; any failure exits non-zero):

  1. build    — nvcc builds every kernel library from ``src/repro_torch/
                 csrc`` into ``build/repro_torch/`` (seconds, ptxas report);
                 one line per attention library with the count of
                 tensor-core instructions (HMMA, HGMMA) in its SASS by
                 cuobjdump, or "not measured" and why (flash attention
                 must have some);
  2. kernels  — each kernel against its plain PyTorch version on the card:
                 the Faces kernels exactly, R=64: pack and unpack at
                 n=(64,64,64), (6,5,4), (6,5,3) and (1,3,2), the pack
                 also in bf16 and int32 at (64,64,64), the unpack
                 with and without the per-rank max and with a NaN in one
                 surface, and in bf16, int32 and float64 at each n
                 (split and flat; the max in the float types, an integer
                 max refused, as the plain norm refuses it); the pack in
                 uint8 and int8 and the unpack in uint8, int8 and int16
                 (wrapping adds) at (64,64,64) and (6,5,3);
                 the Faces increment in float32 and float64 at
                 (64,64,64), (128,128,128), (5,6,7), (4,4,4) and
                 (1,1,1) (both outputs; the inputs unchanged; bf16
                 refused);
                 put_signal (gather, and the zero-filled scatter
                 of a non-periodic grid; float32, bf16 and int32; rows of
                 1, 3, 64 and 4096 elements, each also one element off a
                 16-byte boundary; with and without the signal); the
                 attention kernels in bf16 and float32 at
                 granite's shapes (H=32, KV=8, hd=64) and jamba's (H=64,
                 KV=8, hd=128), a G=1 case, an hd=128 case, a ragged Sq of
                 1000 and kv_valid_len < Skv, q-tile and key-tile edges
                 and flash-decode's split edges; flash attention at
                 (hd, hdv) = (192, 128): deepseek-v2's prefill (4 x 1000
                 tokens, 128 heads, a 4096-row cache), a ragged case and
                 the tile edges (65 rows, 129 keys, kv_valid_len 64,
                 offset 64); flash-decode at granite-34b's G = 48 (8
                 slots, one KV head of 128); llama-3.2-vision's cross
                 layers (flash attention not causal, 8 x 1000 queries
                 against 1600 keys, no valid length; flash-decode of 8
                 slots over all 1600 keys, no position) and
                 musicgen-large's prefill and decode (MHA, hd 64, 32
                 heads); on unit-normal q, k, v:
                 within 2e-5 (float32) and within 2e-2 of the largest
                 |output| (bf16); the WKV6 kernel (staged from 32
                 steps, sequential below) in
                 float32 and bf16 at (B, S, H, hd) = (2,128,2,32),
                 (1,256,4,64), (8,1,32,64) (decode) and (3,1000,32,64)
                 (ragged prefill) with a nonzero s0, two 500-step
                 launches with the state carried against one of 1000,
                 and the state written in place: within 1e-5; the
                 selective-scan kernel (its decode kernel up to 4 steps)
                 in float32 and bf16 at (B, S, di,
                 ds) = (2,128,64,8), (1,64,128,16), (4,1000,16384,16)
                 (jamba prefill) and (8,1,16384,16) (decode), b and c
                 strided column slices (equal to contiguous copies), 500
                 + 500 steps carried against 1000, the state in place:
                 within 1e-5 of max(1, |value|) for the state and a
                 float32 y, 2e-2 for a bf16 y;
  2b. put_multicast — against its plain version, bit for bit: at the
                 broadcast's payload (8 ranks x 2048 x 2048 float32, 3
                 branches) and at rows of 1, 3, 64 and 4097 elements
                 (aligned and one off) in float32, bf16, int32 and uint8,
                 on the broadcast's branch tables (periodic, and with -1
                 entries) and a table with repeated sources and an empty
                 branch, with and without the signal;
  3. parity   — grid (2,2,2), n=(4,4,4), 3 iterations: ST x {adaptive,
                 static, none} x {merged, unmerged}, host x {merged,
                 unmerged}, fused, and packed (+ chunked) put schedules
                 on two nodes of four ranks; each against a numpy replay
                 of Faces with every post-counter slot (and, unpacked,
                 every completion slot) equal to the iteration count; st
                 and fused (CUDA graphs) also bit for bit the eager
                 emission of the same program, their second run (a
                 replay) under ``torch.cuda.set_sync_debug_mode("error")``
                 equal to the first and leaving it unchanged;
  4. full     — grid (4,4,4) = 64 ranks, n=(64,64,64) float32, 20
                 iterations in ST, host and fused modes: counters, bit-
                 identical state across modes and to the eager emission,
                 the last exchange against a numpy exchange of the final
                 blocks, every Faces kernel launched in the counted run
                 of every mode — per iteration one halo_pack, one
                 halo_unpack, one faces_increment, 26 put_signal and
                 one counter_bump (the
                 merged post) in st and fused, 27 counter_bump in host
                 (each completion its own bump). st and fused replay one
                 CUDA graph per program (fused: one per planned segment,
                 the simulator's host dispatch count): the first run
                 captures, outside the sync guard (``torch.cuda.graph``
                 synchronizes on entry); the counted run is a replay
                 under ``torch.cuda.set_sync_debug_mode("error")`` (no
                 hidden host synchronisation), equal to the first, whose
                 tensors it leaves unchanged;
  5. timing   — CUDA-event medians: per-iteration ms of each mode, st
                 and fused from graph replays, host eager, and the st
                 program's eager emission beside them, in turns; each
                 mode's first run (warm-up, capture, instantiation)
                 apart; from torch.profiler (full tables in
                 ``chiprun_out/``) the device's busy time and idle share,
                 the pack's, the unpack's and the increment's device
                 ms, the device ops
                 per iteration (the graphs' state copies apart: the
                 program's own ops equal the eager emission's) and the
                 host's launch calls (one cudaGraphLaunch per graph),
                 beside the cost simulator's dispatch units; peak device
                 memory of a run of each mode and the graphs' copies in
                 and out alone; a fetch-granularity probe
                 (1, 8 or 16 floats, or the first and last, read per
                 256-byte row of a cold 67 MB buffer); each kernel's
                 device time
                 (CUDA-graph replay) and eager call time beside its
                 bound, its plain version and the one-call PyTorch
                 yardstick (index_select, index_add, add); the pack
                 also cold (cold_ms, library_cold_ms: four fields in
                 turns, out of L2), its bound counted in distinct 32-byte
                 sectors of the field (bound_useful_bytes_ms beside it);
                 the unpack
                 with the max beside it (with_max_ms) and in bf16
                 (bf16_ms), an empty kernel's
                 time beside the bump (launch_floor_ms), put_signal
                 at Faces' face, edge and corner payloads beside the two
                 launches it replaces (index_select + add) and
                 index_select alone, and the increment at 64r (cold too)
                 and at n = 128^3 (at_n128) beside its bound, its plain
                 version (the four PyTorch kernels it replaced) and one
                 PyTorch pass (src + 1.0);
  5b. patterns — the broadcast, ring and a2a transports at full width,
                 each through st, host and fused (``run_pattern``): the
                 first run apart, a counted run whose put_multicast,
                 put_signal and counter_bump launches must equal the
                 emission's (``predicted_launches``), ms per iteration
                 (CUDA events around whole runs, median of 7), device
                 busy/idle share, device ops and host launch calls per
                 iteration (profiler), the graphs' copies in and out
                 (bytes; copy-in ms), every mode bit for bit the eager
                 emission. Broadcast: a (2, 4) grid, 2048 x 2048 float32
                 tiles (a 4096 x 8192 SUMMA operand), 4 iterations,
                 multicast and unicast, double-buffered or not; the
                 multicast bit for bit the unicast, the counters the
                 iteration count. Ring: jamba's attention width (64
                 heads of 128, KV expanded from 8), bf16, 4 ranks x 2048
                 tokens, causal: within the bf16 bound (2e-2 of the
                 largest |value|) of the direct rotation, and both of a
                 float32 plain attention; the sharded decode at 8 slots
                 over a 32768-token cache against the float32 plain
                 decode. a2a: one jamba MoE layer at full width (random
                 bf16, 19.3 GB) over 4 shards, 8 x 1000 tokens, the
                 weights in the window as views: within the bf16 bound of
                 the direct moe_a2a at 4 shards and at 1; its peak memory;
                 then the put_multicast kernels-line row (warm, cold, the
                 plain version, 3 put_signal launches, 3 index_select);
  6. serve    — granite-3-2b at full width (40 layers, d_model 2048, 32
                 heads, 8 KV heads, d_ff 8192, vocab 49155; random bf16
                 params from a seed, ~2.5 B), 8 slots, max_len 4096, 16
                 requests of seeded prompt lengths in {128, 256, 512,
                 1000}, 32 new tokens each, through ``ServingEngine``:
                 tokens/s, prefill ms per dispatch, decode ms per step
                 (the decode step replayed as one CUDA graph after its
                 first, eager, call), each attention kernel's launches
                 (must be 40 per prefill dispatch and 40 per decode
                 step, replays counted), the device idle share during
                 decode (profiler), the capture's ms, and the graph
                 against the eager step on the same engine state over 8
                 steps: ids equal bit for bit, the cache's largest
                 difference, host ms per step of each. The attention kernels'
                 kernels-line rows follow (time at the serving shapes,
                 bound, plain version, and SDPA on the valid keys as the
                 yardstick; flash-decode's split count; the kernel, SDPA
                 and bound at jamba's and musicgen-large's attention
                 shapes too);
  6b. st      — ST-routed decode: ``st_router``, the decode router alone
                 at 4 virtual ranks with MoE dispatch at granite's and
                 jamba's payload widths in st, host and fused mode (the
                 committed ids and KV rows equal the staged ones, the
                 hidden block the host's float32 sum in the reference's
                 order, bit for bit); then one ``st_serve`` line per
                 engine on granite's weights and 16 requests: a baseline
                 engine, then st, host and fused with st_config "auto"
                 (tuned afresh: the tuned cache is a file under
                 ``chiprun_out/`` removed first) at 4 ranks, each warmed
                 up through every slot bucket: served tokens equal to
                 the baseline's bit for bit, decode ms per step (counted
                 run and steady) and the router's host ms per step,
                 tokens/s, device busy/idle, ops and host calls per step
                 (profiler), exactly 2 put_signal and 1 counter_bump
                 launches per decode step (host: 3 counter_bump), the
                 model's kernels launched as in phase 6, and per slot
                 bucket the tuned label, dispatches, descriptors,
                 program graphs and tuning seconds; ``st_traffic``: 16
                 Poisson requests at 20/s over granite's st engine
                 (latency and TTFT p50/p99);
  7. replay   — the served tokens replayed teacher-forced (prompts of
                 one length prefilled together, as the engine's length
                 groups) through the kernel path and the plain path on
                 the card, in bf16 and (the same weights, upcast) in
                 float32: last-position
                 logits within the stated bf16 tolerance and within 1e-3
                 in float32; for every request, the bf16 kernel path no
                 farther from the float32 plain path than 1.25x the bf16
                 plain path (RMS over its steps and vocab); the greedy
                 ids equal the plain path's wherever its top-2 margin
                 exceeds twice the tolerance, and the served ids equal
                 the float32 plain path's wherever its margin exceeds
                 twice the bf16 plain path's largest distance from it;
  8. rwkv     — granite's weights freed, rwkv6-1.6b at full width (24
                 layers, d_model 2048, 32 heads of 64, d_ff 7168, vocab
                 65536; random bf16 params from a seed, the token-shift
                 mixes, decay base and bonus redrawn so that none is
                 inert, ~1.6 B) served as in phase 6: the WKV6 kernel must
                 launch 24 times in every prefill dispatch and in every
                 decode step; each profile's device ms per kernel
                 (prefill_kernel_device_ms: wkv6's share of the 8 x 1000
                 prefill); the wkv6 kernels-line row (time at the run's
                 largest prefill dispatch, at one 1000-token prompt
                 (at_b1) and at 8 slots decoding, bound, plain version;
                 no library call computes WKV6); then the replay of
                 phase 7 on rwkv's served tokens, with bf16_spread: how
                 far the bf16 plain path moves with its WKV sums in two
                 other orders (reported, not checked);
  9. jamba    — rwkv's weights freed, jamba-1.5-large-398b at full width
                 (d_model 8192, 64 heads, 8 KV heads of 128, d_ff 24576,
                 16 experts of 24576 top-2, d_state 16, expand 2) cut to
                 4 layers, (attn, dense), (mamba, moe), (mamba, dense),
                 (mamba, moe) (random bf16 params from a seed, the mamba
                 leaves redrawn, 23.0 B) served as in phase 6 with the
                 dense MoE: exactly 1 flash_attention and 3 mamba_scan
                 launches in every prefill dispatch, 1 decode_attention
                 and 3 mamba_scan in every decode step; its prefill
                 profiled at 4 x 1000; the mamba_scan kernels-line row
                 (with at_b1, as wkv6's);
                 ``st_serve`` as in phase 6b (baseline and st; 5
                 put_signal launches per decode step: the KV row, the
                 ids and the hidden block on three shifts);
                 the bf16 replay of phase 7 with every scan launch held
                 to the plain version (its float32 copy, 92 GB, does not
                 fit); then phase 7 in bf16 and float32 on a no-expert
                 cut, (attn, dense), (mamba, dense), (mamba, dense) at
                 full width with its own seeded weights, over the served
                 token sequences. Before the cut, jamba's weights are
                 served again with ``moe_impl="a2a"`` (one expert shard)
                 as in phase 6, and ``serve_a2a`` sets it beside the dense
                 engine: tokens/s, decode ms per step, requests served
                 dense's tokens, and the a2a-served tokens replayed
                 teacher-forced through the dense MoE, the a2a MoE and
                 the a2a MoE with a capacity that drops nothing (within
                 LOGITS_ATOL of dense; the real capacity's gap held there
                 only when its replay dropped nothing, its dropped
                 assignments printed).
 10. deepseek — jamba's weights freed, deepseek-v2-236b at full width
                 (d_model 5120, 128 heads, MLA q_lora 1536, kv_lora 512,
                 nope 128 + rope 64, v 128; 160 routed experts of 1536
                 top-6 and 2 shared; vocab 102400) cut to its first 4
                 layers, (mla, dense FFN 12288), then 3 x (mla, moe)
                 (random bf16 params from a seed, 13.30 B) served as in
                 phase 6 with the dense MoE: exactly 4 flash_attention
                 launches at (192, 128) in every prefill dispatch and no
                 attention kernel in a decode step (the absorbed decode
                 is plain products); its prefill profiled at 4 x 1000
                 (with its peak memory); the flash_attention_192x128
                 kernels-line row (4 x 1000 in a 4096-row cache: kernel,
                 plain version, bound, launches per prefill dispatch, and
                 SDPA on the backend that takes hd != hdv first, named);
                 the bf16 replay of phase 7 (dense MoE, at most 4 prompts
                 a prefill); then, its weights freed, phase 7 in bf16
                 and float32 on its first layer, (mla, dense), with its
                 own seeded weights (1.39 B), over the served tokens: the
                 float32 flash kernel at (192, 128) inside the model.
                 Then deepseek-moe-16b whole (28 layers, d_model 2048, 16
                 heads of 128, 64 routed experts of 1408 top-6 and 2
                 shared, a dense first FFN of 10944; 16.38 B) served as
                 in phase 6 (one flash attention launch per layer per
                 prefill dispatch, one flash-decode per layer per decode
                 step).
 11. short    — minitron-4b whole (32 layers, 5.10 B), qwen3-32b cut to
                 48 of 64 layers and granite-34b (MQA) cut to 64 of 88
                 (each cut so that its weights, its 8 x 4096 KV cache
                 and the decode check's two copies of it fit one 80 GB
                 card), each at full width and alone on the card, served
                 as in phase 6 without the profiles: the counted run's
                 launches, and the decode graph against the eager step;
                 granite-34b's decode_attention_g48 kernels-line row (8
                 slots, 48 query heads on one KV head).
 12. vision   — llama-3.2-vision-90b at full width (d_model 8192, 64
                 heads, 8 KV heads of 128, d_ff 28672, vocab 128256, a
                 vision stub of 1600 x 1280) cut to 20 layers, four
                 whole periods of 4 self and 1 cross layer (random bf16
                 params from a seed, 19.21 B), served as in phase 11
                 (granite's traffic, zero vision as the reference's
                 engine feeds): exactly 20 flash attention launches a
                 prefill dispatch, 4 of them cross (not causal), and 20
                 flash-decode launches a decode step, 4 of them cross
                 (counted by wrapping ``attention_core``: a launch with
                 ``causal=False`` adds to flash_attention_cross or
                 decode_attention_cross); the decode graph against the
                 eager step; the flash_attention_cross and
                 decode_attention_cross kernels-line rows (the run's
                 largest prefill dispatch against 1600 keys, 8 slots
                 decoding over them; SDPA not causal as the library;
                 the bound counts every key). Then the gates redrawn
                 nonzero (the init's 0 and zero vision make a cross
                 layer add exactly 0): 4 prompts of 1000 tokens
                 prefilled with seeded vision inputs (4 x 1600 x 1280)
                 and 8 decode steps below position 1600, kernel route
                 against plain route in bf16 (logits within 0.5, greedy
                 ids where the margin exceeds twice that; 16 causal and
                 4 cross flash launches, 20 decode launches a step, 4
                 cross; every cross layer's output nonzero), and the
                 decode graph against the eager step on an engine whose
                 prefills get seeded vision (its cross caches hold
                 nonzero K/V). musicgen-large whole (48 layers, 32 heads
                 of 64, MHA; 3.23 B) served as in phase 11 (token ids
                 below its vocab of 2048), then one forward of seeded
                 frame embeddings (4 x 1000 x 128) through its frontend,
                 kernel route against plain route (logits within 0.5, 48
                 flash launches).
 13. training — ``train_kernels``: flash attention, WKV6 and the
                 selective scan as autograd Functions at training shapes
                 (granite's attention at 2 x 1024 and 2 x 1023, jamba's
                 at 1 x 256, rwkv6's WKV6 at 2 x 512 and 2 x 511, jamba's
                 scan at 1 x 256 and 1 x 255): forward bit for bit the
                 bare kernel, gradients bit for bit autograd through the
                 plain version, one launch in the forward (the host's
                 launch calls under the Function) and a wrapper count of
                 1 over forward and backward. ``train``:
                 granite-3-2b at full width (random float32 masters from
                 a seed, bf16 compute, AdamW, grad_accum 4, remat dots),
                 6 steps of 8 x 1024 SyntheticTokens(seed=0) tokens, a
                 cosine LR with a one-step warmup: per step loss, aux,
                 LR, ms and flash launches (40 x 4 x 2 = 320: the block's
                 forward runs again in the backward); steady step ms,
                 tokens/s, peak GB, a step split into gradients and
                 optimizer, a profiled step (busy, idle, GEMM and flash
                 ms and device launches, top ops); gates: finite losses,
                 the last below the first, flash launched on the device
                 in the profiled step, a finite nonzero gradient for
                 every master.
                 ``train_route``: granite cut to 2 layers, one step's loss
                 and gradients through the kernels against the plain
                 versions (float32: 1e-5 relative and 1e-4 of the
                 largest |grad|; bf16 2e-2). ``train_restart`` (a
                 subprocess, deterministic algorithms): 6 steps against
                 3 + an async checkpoint + a restore into fresh tensors
                 + 3, params and optimizer state bit for bit, the 2.7 GB
                 checkpoint removed. rwkv6-1.6b (3 steps of 4 x 512,
                 grad_accum 2; 96 WKV6 launches a step) and jamba cut to
                 3 layers without experts (Adafactor, bf16 moments and
                 accumulator, 3 steps of 16 x 256, grad_accum 16; 64 scan
                 and 32 flash launches a step), with the same gates; of
                 these two one micro-batch's forward is profiled (a
                 step's ~10^6 device ops of the plain backwards take the
                 profiler minutes), and the device must have run their
                 kernels in it. The flash attention, WKV6 and scan rows
                 of the kernels line gain their launches per train
                 step.
 14. accounting — the dry run's accounting (``launch/dryrun_lib.account``,
                 one card, no mesh, on fake tensors on the host) of
                 every cell served or trained above, at its own shape:
                 a served cell's 8-slot, 4096-position cache and its
                 largest prefill dispatch of the counted run beside its
                 decode step, a train cell's batch, length and
                 micro-batches. Per cell the counted parameter,
                 optimizer-state and cache bytes, the predicted
                 activation bytes and peak, beside the live tensors'
                 summed nbytes and the measured peak
                 (``max_memory_allocated``: a served cell's from just
                 before its counted run, after the engine was built, its
                 ``serve_peak_gb``; a train cell's whole phase) and
                 their ratio, with the whole phase's peak beside them
                 (``peak_mem_gb``, weight drawing included). Gate: the
                 counted bytes equal the live bytes exactly; the ratio
                 is reported, not gated.
 15. verify   — the static schedule verifier over every program the run
                 scheduled on the card (each kept once, as it was first
                 scheduled, by wrapping ``STStream.scheduled_programs``):
                 the 64-rank Faces program (plain for st and host, and
                 fused), the parity grid's programs, the broadcast, ring
                 and a2a programs and the serve programs of every
                 ST-routed decode bucket, with 0 findings (programs,
                 nodes, events and conflict pairs checked);
                 ``schedule(verify=True)`` on a fresh lowering of the
                 64-rank Faces program; the seeded-defect corpus, its six
                 mutations each caught. Host only. Then a ``done`` line
                 with the run's seconds.

The last three lines are the kernels JSON (one row per kernel, and a
row each for flash attention at (192, 128), flash-decode at G = 48, and
both in llama-3.2-vision's cross layers: fourteen), the card's name and
power limit, and ``{"ok": true, "device": {...}}``.
Without a CUDA card the script exits non-zero before printing any
result.

    python3 chip_smoke.py --only faces

runs the build and the Faces phases alone: kernels (2), parity (3),
full (4) and timing (5, without the fetch probe), then one
``kernel_row`` line per Faces kernel and a ``done`` line with the
card's name and power limit. ``--only train`` runs the build and the
training phases.

    python3 chip_smoke.py --ab DIR

times the two recurrent kernels (WKV6, the selective scan) and the
Faces path of this tree against those of DIR, another checkout of the
repository (for a parent commit: ``git archive <commit> | tar -x -C
DIR``, DIR inside a directory that ``.gitignore`` lists). Each tree runs
in a worker process of its own, which builds that tree's kernels into
its own ``build/repro_torch/`` and prints one JSON line: each kernel
function's SASS opcode counts (cuobjdump); the device time per call
(``graph_ms`` of 5 calls, as the kernels-line rows) on the rows' bf16
inputs at rwkv6-1.6b's and jamba's widths, B x S in AB_CASES; halo_pack
at 64r warm and cold, halo_unpack at 64r and counter_bump; and the st
and fused Faces 64r programs' ms per iteration (CUDA-graph replays in
a tree that has them, the first run apart) with the device's busy ms,
ops, and pack and unpack ms per iteration (profiler); the unpack in
bf16 where the tree takes it; and granite-3-2b served at full width as
in phase 6 (decode ms per step, prefill ms per dispatch, tokens/s, peak
GB). The workers
go other, this, this, other, so that a drift of the card's clock falls
on both trees alike; the last JSON line holds each tree's median per
case.
"""
import argparse
import dataclasses
import gc
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
# operations bound: the attention kernels' bf16 products at the bf16
# tensor-core rate, wkv6's float32 state updates at the float32 rate
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor cores (same)
F32_FLOPS_PER_S = 67e12        # H100 SXM float32, CUDA cores (same)
GRID_SMALL, N_SMALL, NITER_SMALL = (2, 2, 2), (4, 4, 4), 3
GRID_FULL, N_FULL, NITER_FULL = (4, 4, 4), (64, 64, 64), 20
AXES = ("x", "y", "z")
MODES = ("st", "host", "fused")
OUT_DIR = os.path.join(ROOT, "chiprun_out")     # long outputs (profiles)
# serving cell: granite-3-2b at full width
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_REQUESTS, SERVE_NEW = 8, 4096, 16, 32
SERVE_LENGTHS = (128, 256, 512, 1000)
DECODE_PROFILE_STEPS = 8
# attention kernels against their plain versions, on unit-normal q, k, v
# (outputs up to ~3): the tolerances of tests/test_kernels.py, 2e-5
# absolute in float32 and, in bf16, 2e-2 of the largest |output|. A
# correct bf16 kernel sits at ~0.5 % of it: the plain version rounds its
# scores and normalised weights to bf16; the bf16 flash kernel keeps its
# scores float32 and rounds its unnormalised weights p <= 1 to bf16 for
# the tensor cores (the same ~2^-8 relative rounding), flash-decode keeps
# both float32. A wrong load, stride or head mapping moves outputs by
# O(1). flash attention's float32 kernel is another kernel than its bf16
# one (CUDA-core FMAs, exact to float32 rounding) but takes the same
# masks and key-loop bounds; flash-decode's two dtypes share one kernel.
ATTN_ATOL_F32 = 2e-5
ATTN_RTOL_BF16 = 2e-2
# kernel path against plain path, last-position logits of the full
# model (|logit| up to ~5, std ~0.9). In bf16 the two round attention at
# different points (the plain versions round scores and normalised
# weights to bf16, the kernels keep scores float32 and flash attention
# rounds unnormalised weights) in each of 40 layers of random weights,
# which carry a difference forward: the tolerance is 32 bf16 spacings at
# |logit| in [2, 4) (2^-6 each). It is loose, since bf16 rounding alone
# moves either path ~0.2 from the float32 path: the bf16 check with power
# is REPLAY_DIST_RATIO below. In float32 both paths agree per call to
# ~1e-7, and 1e-3 bounds the same carrying with a wide margin.
LOGITS_ATOL = 0.5
LOGITS_ATOL_F32 = 1e-3
# per request, the bf16 kernel path's RMS distance from the float32 plain
# path over the bf16 plain path's own (both ~0.2 at most per logit)
REPLAY_DIST_RATIO = 1.25
# WKV6 kernel against its plain version: both run the recurrence in
# float32 on the same values (bf16 r, k, v upcast), so only the order of
# the sums differs; 1e-5 absolute, tests/test_kernels.py's tolerance
# (relative to max(1, the largest |y| or |state|) on the served model's
# inputs, whose state sums up to ~700 decaying steps)
WKV_ATOL = 1e-5
# RWKV_F32: rwkv6-1.6b with random weights (rwkv_redraw) carries a
# float32 rounding difference through its 24 layers to ~6e-3 in the
# logits: the plain path against itself with only the WKV sums put in
# the kernel's order (wkv6_reordered) measured 6.0e-3 on an H100 at
# 700 W, the kernel path 6.7e-3 (1.11x), both above LOGITS_ATOL_F32. So
# for rwkv that bound is the spread the run measures: the float32 kernel
# path must stay within RWKV_F32_SPREAD times the reordered plain path's
# distance. Two orders of the same sums give distances of one size, but
# which sums round apart decides how far each layer carries them, so
# their ratio scatters around 1: 3 leaves 2.7x over the measured 1.11
# and still fails a wiring fault that moves the logits by ~2e-2. Each
# WKV6 launch of both kernel-path replays is also held to the plain
# version on its own inputs (1e-5 of max(1, |value|), SCAN_RTOL), and
# the launches are counted;
# the float32 greedy ids are compared where the margin exceeds twice
# the spread.
RWKV_F32_SPREAD = 3
# selective-scan kernel against its plain version: both run the
# recurrence in float32 on the same values (bf16 inputs upcast), so the
# state and a float32 y differ only by the order of the sums and the exp
# (the kernel's ex2.approx, 2 ulp): 1e-5 of max(1, the largest |value|),
# tests/test_kernels.py's tolerance. A bf16 y is that float32 value
# rounded once, where one rounding may land a spacing apart: 2e-2 of it.
SCAN_RTOL = 1e-5
SCAN_RTOL_BF16 = 2e-2
# the special-function units' rate of exp2 on an H100 SXM: 16 per clock
# per SM (NVIDIA's Hopper tuning guide), 132 SMs at the 1.98 GHz boost
# clock; the scan does one per (step, channel, state entry)
SFU_EXPS_PER_S = 16 * 132 * 1.98e9
# jamba-1.5-large-398b cut to 4 layers in depth (full width): (attn,
# dense), (mamba, moe), (mamba, dense), (mamba, moe), 23.0 B params, 46
# GB in bf16. Its standalone prefill profile takes 4 x 1000 tokens: the
# dense MoE's (16, tokens, 24576) bf16 intermediates are ~3.1 GB each
# there, and 8 x 1000 would put ~25 GB of them beside the weights.
JAMBA_LAYERS = 4
JAMBA_PROFILE_ROWS = 4
# deepseek-v2-236b at full width, cut to its first 4 layers: (mla, dense),
# then 3 x (mla, moe), 13.30 B params, 26.6 GB in bf16. The dense MoE of
# a 4 x 1000 prefill makes (160, 4000, 5120) bf16 slabs of 6.55 GB, so
# its prefill profile, its kernels-line row and its replays' prefills
# take at most JAMBA_PROFILE_ROWS prompts a dispatch.
DEEPSEEK_LAYERS = 4
# llama-3.2-vision-90b served cut to four whole 5-layer periods (16 self,
# 4 cross layers; 19.21 B params, 38.4 GB in bf16), over its 1600 vision
# rows; its model-level check prefills at most VISION_ROWS prompts
VISION_LAYERS, VISION_TOKENS, VISION_ROWS = 20, 1600, 4
VISION_DECODE_STEPS = 8
# the attention archs served short, (arch, layers or None for all): the
# cuts keep each model's weights, its 8 x 4096 KV cache and the decode
# check's two copies of that cache on one 80 GB card
SHORT_SERVES = (("minitron-4b", None), ("qwen3-32b", 48),
                ("granite-34b", 64))


def emit(obj):
    """One JSON line, with "t": seconds since the script started."""
    print(json.dumps(dict(obj, t=round(time.perf_counter() - T0, 1))),
          flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------
# numpy references
# ---------------------------------------------------------------------------

def numpy_oracle(halo, src0, grid=GRID_SMALL, n=N_SMALL, niter=NITER_SMALL):
    """src0: (R, nx,ny,nz) initial blocks. Replays ``niter`` iterations
    (the replay of scripts/dev_faces.py)."""
    px, py, pz = grid
    src = src0.copy()
    acc = None
    for it in range(niter):
        src = src + np.float32(1.0 + it % 3)
        acc = np.zeros_like(src)
        for d in halo.DIRECTIONS:
            for x in range(px):
                for y in range(py):
                    for z in range(pz):
                        srank = (x * py + y) * pz + z
                        tx, ty, tz = ((x + d[0]) % px, (y + d[1]) % py,
                                      (z + d[2]) % pz)
                        trank = (tx * py + ty) * pz + tz
                        sl = halo.surface_slices(n, d)
                        acc[(trank,) + sl] += src[(srank,) + sl]
    return src, acc


def numpy_exchange(halo, src, grid, n):
    """One periodic halo exchange of blocks ``src`` (R, *n): every rank's
    accumulator gets its 26 neighbours' surfaces, added in DIRECTIONS
    order (the order the unpack kernel adds in, so equality is exact)."""
    g = src.reshape(tuple(grid) + tuple(n))
    acc = np.zeros_like(g)
    for d in halo.DIRECTIONS:
        sl = (slice(None),) * 3 + halo.surface_slices(n, d)
        acc[sl] += np.roll(g[sl], shift=d, axis=(0, 1, 2))
    return acc.reshape(src.shape)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def event_ms(fn, reps=7, inner=1, warm=True):
    """Median over ``reps`` of the CUDA-event time of ``inner`` calls,
    per call, after one warm-up call (unless ``warm`` is False)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def graph_ms(fn, inner=20, reps=7):
    """Device time per call: ``inner`` calls captured in one CUDA graph,
    replayed ``reps`` times (median), so host overhead between launches
    is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return event_ms(graph.replay, reps=reps) / inner


def cold_ms(fn, inputs, inner=20):
    """``graph_ms`` with each call's input out of L2: call i runs on
    ``inputs[i % len(inputs)]`` and every call's output is kept (memory of
    its own), so the calls between two on one input, reading and writing
    more than the card's 50 MB L2 holds, have pushed it out."""
    kept, nxt = [], itertools.cycle(inputs).__next__
    return graph_ms(lambda: kept.append(fn(nxt())), inner=inner)


def device_profile(run, out_path):
    """One ``run()`` under torch.profiler: {"busy_ms": device time,
    "top": its largest entries, "device_ops": kernels, memsets and copies
    the device ran ("ops": by name), "host_calls": the CUDA
    launch/memset/copy API calls the host made, by name}; the full table
    goes to ``out_path``.
    ``busy_ms`` is None when the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    rows, device_ops, host_calls, ops = [], 0, {}, {}
    for e in avgs:
        if e.device_type != DeviceType.CUDA:
            if e.key.startswith("cu") and any(
                    w in e.key for w in ("Launch", "Memset", "Memcpy")):
                host_calls[e.key] = e.count
            continue            # host ops; their kernels are rows of their own
        if getattr(e, "is_user_annotation", False) \
                or e.key.startswith("repro_torch."):
            continue            # a program span's range, on the device
        device_ops += e.count
        ops[e.key] = ops.get(e.key, 0) + e.count
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((us / 1e3, e.key, e.count))
    rows.sort(reverse=True)
    with open(out_path, "w") as f:
        f.write(avgs.table(sort_by="self_cpu_time_total", row_limit=40))
    return {"busy_ms": sum(r[0] for r in rows) if rows else None,
            "top": rows[:6], "rows": rows, "device_ops": device_ops,
            "ops": ops, "host_calls": host_calls}


# the device functions each wrapper launches, as the profiler names them:
# the start of a function name (halo_pack's was pack_kernel before the
# redesign, which --ab reads in a parent tree)
KERNEL_FUNCS = {"flash_attention": ("flash_fwd_",),
                "decode_attention": ("decode_split_", "decode_merge"),
                "wkv6": ("wkv6_",), "mamba_scan": ("mamba_scan_",),
                "halo_pack": ("halo_pack_kernel", "pack_kernel"),
                "halo_unpack": ("unpack_kernel",),
                "faces_increment": ("faces_increment_kernel",)}


def kernel_ms(prof, names):
    """{wrapper: device ms of its kernels in the profile ``prof``}."""
    return {n: sum(ms for ms, key, _ in prof["rows"]
                   if any(re.search(r"(?<!\w)" + f, key)
                          for f in KERNEL_FUNCS[n]))
            for n in names}


def kernel_device_launches(prof, names):
    """{wrapper: launches of its kernels the device ran in the profile
    ``prof``}."""
    return {n: sum(c for key, c in prof["ops"].items()
                   if any(re.search(r"(?<!\w)" + f, key)
                          for f in KERNEL_FUNCS[n]))
            for n in names}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def disassembler():
    """cuobjdump from the CUDA toolkit, else the one Triton carries, else
    None."""
    import importlib.util
    import shutil
    cands = [os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                          "cuobjdump"), "/usr/local/cuda/bin/cuobjdump",
             shutil.which("cuobjdump") or ""]
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        cands.append(os.path.join(os.path.dirname(spec.origin), "backends",
                                  "nvidia", "bin", "cuobjdump"))
    return next((c for c in cands if c and os.path.isfile(c)), None)


def phase_build(_build):
    t0 = time.perf_counter()
    built = _build.build_all()
    secs = time.perf_counter() - t0
    ptxas = {}
    for name in _build.LIBRARIES:
        log = _build.library_path(name).with_suffix(".log")
        if log.exists():
            ptxas[name] = [ln.strip() for ln in log.read_text().splitlines()
                           if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": secs, "built": sorted(built),
          "ptxas": ptxas})
    # tensor-core instructions in each attention library's SASS: HMMA
    # (mma.sync) and HGMMA (wgmma); the bf16 flash kernel must have them
    tool = disassembler()
    for name in ("flash_attention", "decode_attention"):
        line = {"phase": "build", "library": name, "disassembler": tool}
        if tool is None:
            line["tensor_core_sass"] = ("not measured: no cuobjdump in the "
                                        "CUDA toolkit or Triton's package")
        else:
            out = subprocess.run([tool, "-sass",
                                  str(_build.library_path(name))],
                                 capture_output=True, text=True, timeout=120)
            if out.returncode != 0:
                line["tensor_core_sass"] = ("not measured: cuobjdump exit "
                                            f"{out.returncode}: "
                                            f"{out.stderr.strip()[-300:]}")
            else:
                line["tensor_core_sass"] = {
                    op: len(re.findall(rf"\b{op}\.", out.stdout))
                    for op in ("HMMA", "HGMMA")}
        emit(line)
        sass = line["tensor_core_sass"]
        if name == "flash_attention" and isinstance(sass, dict):
            check(sass["HMMA"] + sass["HGMMA"] > 0,
                  "flash_attention's SASS holds no tensor-core instruction")


# put_signal's cases: rows of these many elements, each also as a view
# one element off the row start (narrower vectors), in these dtypes
PUT_ROWS = (1, 3, 64, 4096)
PUT_DTYPES = (torch.float32, torch.bfloat16, torch.int32)
# the unpack's cases, beside R = 64: the main path's block, a tiny one,
# nz % 4 != 0 (scalar end cells), and a block smaller than a vector
UNPACK_SHAPES = (N_FULL, (6, 5, 4), (6, 5, 3), (1, 3, 2))
# the pack's other dtypes, at N_FULL (float32 at every UNPACK_SHAPES)
PACK_DTYPES = (torch.bfloat16, torch.int32)
# the unpack's other dtypes, at every UNPACK_SHAPES: it adds in the
# surfaces' dtype, each add rounded to it, as the plain version
UNPACK_DTYPES = (torch.bfloat16, torch.int32, torch.float64)
# the 1- and 2-byte integers, at these blocks: the pack in SMALL_PACK
# (1-byte moves), the unpack in SMALL_UNPACK (adds that wrap)
SMALL_SHAPES = (N_FULL, (6, 5, 3))
SMALL_PACK = (torch.uint8, torch.int8)
SMALL_UNPACK = (torch.uint8, torch.int8, torch.int16)
# the Faces increment's blocks, R = 64, in float32 and float64: the main
# paths' (the benchmark's n64 and n128), then blocks of 5 x 6 x 7 and 1
# cell (each rank's block off a 16-byte boundary: head and tail cells)
INCREMENT_SHAPES = (N_FULL, (128, 128, 128), (5, 6, 7), (4, 4, 4),
                    (1, 1, 1))
INCREMENT_DTYPES = (torch.float32, torch.float64)
# iteration counts dealt to the ranks in turn: each step, a count past 3,
# one near 2^24 and the remainder's sign rule
INCREMENT_ITS = (0.0, 1.0, 2.0, 3.0, float(2 ** 24 - 3), -1.0, 2.5)


def nan_equal(a, b):
    """Equal bit for bit up to NaN payloads, NaNs in the same places."""
    return bool(torch.equal(a.isnan(), b.isnan())) and torch.equal(
        torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))


def diff(a, b):
    """max |a - b| over the non-NaN entries (0.0 when there are none)."""
    d = (a.double() - b.double()).abs().nan_to_num(nan=0.0)
    return float(d.max().item()) if d.numel() else 0.0


def phase_kernels(dev, core, hp, hp_ref, cb, R=64):
    """Each kernel against its plain version on the same inputs (these
    launches are comparisons, made before the counted main-path runs)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    errs = {"halo_pack": 0.0, "halo_unpack": 0.0, "counter_bump": 0.0,
            "put_signal": 0.0, "faces_increment": 0.0}
    max_abs = core.halo._max_abs
    for n in UNPACK_SHAPES:
        field = torch.rand((R,) + n, generator=gen, device=dev)
        split, split_ref = hp.halo_pack_split(field), \
            hp_ref.halo_pack_split_ref(field)
        flat, flat_ref = hp.halo_pack(field), hp_ref.halo_pack_ref(field)
        ok = all(torch.equal(a, b) for a, b in zip(split, split_ref)) \
            and torch.equal(flat, flat_ref)
        errs["halo_pack"] = max(errs["halo_pack"], max(
            diff(a, b) for a, b in
            zip(split + (flat,), split_ref + (flat_ref,))))
        check(ok, f"halo pack != plain pack at n={n}")
        recv = torch.randn(flat.shape, generator=gen, device=dev)
        parts = torch.split(recv, [p.shape[1] for p in split], dim=1)
        parts = [p.contiguous() for p in parts]
        acc, acc_ref = hp.halo_unpack(recv, n), hp_ref.halo_unpack_ref(recv, n)
        acc2 = hp.halo_unpack_split(parts, n)
        acc2_ref = hp_ref.halo_unpack_split_ref(parts, n)
        errs["halo_unpack"] = max(errs["halo_unpack"], diff(acc, acc_ref),
                                  diff(acc2, acc2_ref))
        check(torch.equal(acc, acc_ref) and torch.equal(acc2, acc2_ref),
              f"halo unpack != plain unpack at n={n}")
        # with the per-rank max (Faces' unpack+compare), then with a NaN
        # in one surface of rank 5: NaN in that rank's cells and max only
        for nan in (False, True):
            if nan:
                parts[11] = parts[11].clone()
                parts[11][5, 0] = float("nan")
            want = hp_ref.halo_unpack_split_ref(parts, n)
            got = hp.halo_unpack_split(parts, n, with_max=True)
            gflat = hp.halo_unpack(torch.cat(parts, dim=1), n, with_max=True)
            for a, m in (got, gflat):
                errs["halo_unpack"] = max(errs["halo_unpack"], diff(a, want),
                                          diff(m, max_abs(want)))
                check(nan_equal(a, want) and nan_equal(m, max_abs(want)),
                      f"halo unpack with max != plain at n={n}, nan={nan}")
            check(bool(got[1][5].isnan()) == nan
                  and not got[1][:5].isnan().any(), "NaN not in its rank")
        emit({"phase": "kernels", "n": list(n), "R": R, "pack": "equal",
              "unpack": "equal", "unpack_with_max": "equal, NaN propagated"})
    # the pack is a pure copy of any 2-, 4- or 8-byte element: bf16 and
    # int32 at the main path's block
    for dtype in PACK_DTYPES:
        field = torch.randint(-1 << 20, 1 << 20, (R,) + N_FULL, generator=gen,
                              device=dev).to(dtype)
        want = hp_ref.halo_pack_split_ref(field)
        split, flat = hp.halo_pack_split(field), hp.halo_pack(field)
        check(all(torch.equal(a, b) for a, b in zip(split, want))
              and torch.equal(flat, torch.cat(want, dim=1))
              and flat.dtype == dtype, f"halo pack != plain pack in {dtype}")
    emit({"phase": "kernels", "n": list(N_FULL), "R": R,
          "pack_dtypes": [str(d) for d in PACK_DTYPES], "pack": "equal"})
    for n in UNPACK_SHAPES:
        errs["halo_unpack"] = max(errs["halo_unpack"], unpack_dtypes(
            hp, hp_ref, max_abs, gen, dev, R, n))
    emit({"phase": "kernels", "n": [list(n) for n in UNPACK_SHAPES], "R": R,
          "unpack_dtypes": [str(d) for d in UNPACK_DTYPES],
          "unpack": "equal, split and flat, with the max where a float",
          "integer_with_max": "refused, as the plain norm refuses it"})
    # 1- and 2-byte integers over their whole range (the unpack's adds
    # wrap, as torch's do)
    for n in SMALL_SHAPES:
        for dtype in SMALL_PACK:
            field = int_draw(gen, dev, (R,) + n, dtype)
            want = hp_ref.halo_pack_split_ref(field)
            split, flat = hp.halo_pack_split(field), hp.halo_pack(field)
            check(all(torch.equal(a, b) for a, b in zip(split, want))
                  and torch.equal(flat, torch.cat(want, dim=1))
                  and flat.dtype == dtype,
                  f"halo pack != plain pack in {dtype} at n={n}")
        errs["halo_unpack"] = max(errs["halo_unpack"], unpack_dtypes(
            hp, hp_ref, max_abs, gen, dev, R, n, SMALL_UNPACK))
    emit({"phase": "kernels", "n": [list(n) for n in SMALL_SHAPES], "R": R,
          "pack_dtypes": [str(d) for d in SMALL_PACK], "pack": "equal",
          "unpack_dtypes": [str(d) for d in SMALL_UNPACK],
          "unpack": "equal, split and flat, wrapping; with_max refused"})
    errs["faces_increment"] = increment_cases(hp, hp_ref, gen, dev, R)
    sig = torch.randint(0, 1 << 20, (R, 26), generator=gen, device=dev,
                        dtype=torch.int32)
    upd = torch.randint(0, 3, (R, 26), generator=gen, device=dev,
                        dtype=torch.int32)
    out = cb.counter_bump(sig, upd)
    errs["counter_bump"] = diff(out, sig + upd)
    check(torch.equal(out, sig + upd), "counter bump != sig + upd")
    # put_signal: gather (periodic) and zero-filled scatter (non-periodic
    # grid), a face, an edge and a corner direction
    cases = 0
    for periodic in (True, False):
        stream = core.STStream(dev, AXES, periodic=periodic,
                               grid_shape=GRID_FULL)
        for d in ((1, 0, 0), (-1, 1, 0), (1, 1, 1)):
            perm = core.engine._perm_index(stream, d)
            check(bool((perm < 0).any()) == (not periodic),
                  f"perm of {d}: scatter form on a periodic grid?")
            for dtype in PUT_DTYPES:
                for e in PUT_ROWS:
                    wide = torch.randint(-1 << 20, 1 << 20, (R, e + 1),
                                         generator=gen, device=dev
                                         ).to(dtype)
                    for x in (wide[:, :e].contiguous(), wide[:, 1:]):
                        want = cb.put_signal_ref(x, perm)
                        got = cb.put_signal(x, perm)
                        got2, cnt = cb.put_signal(x, perm, sig, upd)
                        errs["put_signal"] = max(
                            errs["put_signal"], diff(got, want),
                            diff(got2, want), diff(cnt, sig + upd))
                        check(torch.equal(got, want) and
                              torch.equal(got2, want) and
                              torch.equal(cnt, sig + upd),
                              f"put_signal != plain: periodic={periodic}, "
                              f"d={d}, {dtype}, row {e}, "
                              f"aligned={x.is_contiguous()}")
                        cases += 1
    emit({"phase": "kernels", "bump": "equal", "put_signal": "equal",
          "put_signal_cases": cases, "max_abs_err": errs})
    return errs


def increment_inputs(gen, dev, R, n, dtype=torch.float32):
    """Blocks of unit-normal values times 1000 and iteration counts dealt
    from INCREMENT_ITS."""
    src = (torch.randn((R,) + n, generator=gen, device=dev,
                       dtype=torch.float64) * 1000).to(dtype)
    it = torch.tensor([INCREMENT_ITS[r % len(INCREMENT_ITS)]
                       for r in range(R)], dtype=dtype,
                      device=dev).reshape(R, 1)
    return src, it


def increment_cases(hp, hp_ref, gen, dev, R):
    """The Faces increment at INCREMENT_SHAPES in INCREMENT_DTYPES: both
    outputs bit for bit the plain closure's, the inputs unchanged, a
    bfloat16 block refused. Returns the largest difference seen (0.0)."""
    err = 0.0
    for dtype in INCREMENT_DTYPES:
        for n in INCREMENT_SHAPES:
            src, it = increment_inputs(gen, dev, R, n, dtype)
            kept = (src.clone(), it.clone())
            got, got_it = hp.faces_increment(src, it)
            want, want_it = hp_ref.faces_increment_ref(src, it)
            err = max(err, diff(got, want), diff(got_it, want_it))
            check(torch.equal(got, want) and torch.equal(got_it, want_it)
                  and got.dtype == dtype,
                  f"faces increment != plain closure in {dtype} at n={n}")
            check(torch.equal(src, kept[0]) and torch.equal(it, kept[1]),
                  f"faces increment wrote into its inputs at n={n}")
            del src, it, kept, got, want
    try:
        hp.faces_increment(*(t.bfloat16() for t in increment_inputs(
            gen, dev, R, (4, 4, 4))))
    except TypeError:
        pass
    else:
        fail("faces increment took a bfloat16 block")
    emit({"phase": "kernels", "R": R,
          "increment_n": [list(n) for n in INCREMENT_SHAPES],
          "increment_dtypes": [str(d) for d in INCREMENT_DTYPES],
          "increment": "equal, inputs unchanged; bfloat16 refused"})
    return err


def int_draw(gen, dev, shape, dtype):
    """Uniform integers of ``dtype``: its whole range for 1 and 2 bytes,
    [-2^30, 2^30) for wider ones."""
    info = torch.iinfo(dtype)
    lo, hi = ((info.min, info.max + 1) if info.bits <= 16
              else (-1 << 30, 1 << 30))
    return torch.randint(lo, hi, shape, generator=gen, device=dev,
                         dtype=dtype)


def unpack_dtypes(hp, hp_ref, max_abs, gen, dev, R, n, dtypes=UNPACK_DTYPES):
    """The unpack in each of ``dtypes`` at block ``n``, split and flat,
    with and (floats) without the per-rank max, bit for bit against the
    plain version on the same surfaces; an integer ``with_max`` must be
    refused. Returns the largest difference seen (0.0)."""
    err = 0.0
    sizes, _, total = hp._geometry(tuple(n))
    for dtype in dtypes:
        if dtype.is_floating_point:
            flat = torch.randn((R, total), generator=gen, device=dev
                               ).to(dtype)
        else:
            flat = int_draw(gen, dev, (R, total), dtype)
        parts = [p.contiguous() for p in torch.split(flat, list(sizes),
                                                      dim=1)]
        want = hp_ref.halo_unpack_ref(flat, n)
        for got in (hp.halo_unpack(flat, n), hp.halo_unpack_split(parts, n)):
            err = max(err, diff(got, want))
            check(got.dtype == dtype and torch.equal(got, want),
                  f"halo unpack != plain unpack in {dtype} at n={n}")
        if not dtype.is_floating_point:
            try:
                hp.halo_unpack(flat, n, with_max=True)
            except TypeError:
                continue
            fail(f"halo unpack took with_max in {dtype}")
        for acc, m in (hp.halo_unpack(flat, n, with_max=True),
                       hp.halo_unpack_split(parts, n, with_max=True)):
            check(torch.equal(acc, want) and m.dtype == dtype
                  and torch.equal(m, max_abs(want)),
                  f"halo unpack with max != plain in {dtype} at n={n}")
    return err


def run_faces(core, dev, grid, n, niter, mode, src0, *, merged=True,
              throttle="adaptive", guard=False, ranks_per_node=None,
              **sched):
    """Build, allocate and run one Faces program through the port's entry
    points; returns (state, stream, the state handed in). With ``guard``
    (st and fused: CUDA graphs) it runs twice: the first run captures the
    program's graphs (``torch.cuda.graph`` synchronizes the device on
    entry, once per program), the second replays them under
    ``torch.cuda.set_sync_debug_mode("error")`` (no hidden host
    synchronisation) and must give the first run's state, leaving the
    first result's tensors as they were."""
    stream = core.STStream(dev, AXES, grid_shape=grid)
    core.halo.build_faces_program(stream, n, niter, merged=merged,
                                  ranks_per_node=ranks_per_node)
    state = stream.allocate()
    state["faces.src"] = src0
    torch.cuda.synchronize()

    def run():
        return stream.synchronize(state, mode=mode, throttle=throttle,
                                  resources=16, merged=merged, **sched)
    if not guard:
        return run(), stream, state
    first = run()
    kept = {k: v.clone() for k, v in first.items()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for k in first:
        check(torch.equal(out[k], first[k]) and torch.equal(first[k],
                                                            kept[k]),
              f"{mode}: a second run gave another {k}, or changed the "
              "first result's")
    return out, stream, state


def eager_emission(core, stream, mode, state, *, merged=True,
                   throttle="adaptive", **sched):
    """The st or fused program of ``stream`` emitted eagerly, descriptor
    by descriptor (what the graphs capture), from ``state``."""
    progs = stream.scheduled_programs(throttle=throttle, resources=16,
                                      merged=merged, fused=mode == "fused",
                                      **sched)
    emit_fn = (core.engine._emit_fused if mode == "fused"
               else core.backends._emit_st)
    for prog in progs:
        state = emit_fn(stream, prog, state)
    torch.cuda.synchronize()
    return state


def program_graphs(stream, mode):
    """The one ProgramGraph of a Faces stream's st or fused program."""
    cache = stream._fused_cache if mode == "fused" else stream._compiled_cache
    check(len(cache) == 1, f"{mode}: {len(cache)} program graphs, want 1")
    return next(iter(cache.values()))


def phase_parity(core, dev):
    halo = core.halo
    R = int(np.prod(GRID_SMALL))
    src0 = np.random.RandomState(0).rand(R, *N_SMALL).astype(np.float32)
    src_exp, acc_exp = numpy_oracle(halo, src0)
    cases = [("st", thr, merged, {}) for merged in (True, False)
             for thr in ("adaptive", "static", "none")]
    cases += [("host", "adaptive", True, {}), ("host", "adaptive", False, {}),
              ("fused", "adaptive", True, {})]
    # two nodes of four ranks: the off-node puts pack into multi-buffer
    # descriptors (their recv buffers arrive as views of one staging
    # buffer) and chunk; a packed descriptor lands ONE completion for its
    # group, so only the post counters must equal niter there
    node = dict(ranks_per_node=4, node_aware=True, pack=True)
    cases += [("st", "adaptive", True, node),
              ("fused", "adaptive", True, dict(node, chunk_bytes=32))]
    for mode, thr, merged, sched in cases:
        graphed = mode != "host"
        out, stream, state = run_faces(
            core, dev, GRID_SMALL, N_SMALL, NITER_SMALL, mode,
            torch.from_numpy(src0).to(dev), merged=merged, throttle=thr,
            guard=graphed, **sched)
        if graphed:
            opts = {k: v for k, v in sched.items() if k != "ranks_per_node"}
            eager = eager_emission(core, stream, mode, state, merged=merged,
                                   throttle=thr, **opts)
            check(all(torch.equal(out[k], eager[k]) for k in out),
                  f"{mode}/{thr}/merged={merged}/{sched}: the graph's state "
                  "differs from the eager emission's")
            stream.clear_graphs()
        np.testing.assert_allclose(out["faces.src"].cpu().numpy(), src_exp,
                                   rtol=1e-6)
        np.testing.assert_allclose(out["faces.acc"].cpu().numpy(), acc_exp,
                                   rtol=1e-5)
        counters = ("faces.post_sig",) if sched else ("faces.post_sig",
                                                      "faces.comp_sig")
        for c in counters:
            check((out[c].cpu().numpy() == NITER_SMALL).all(),
                  f"{mode}/{thr}/merged={merged}/{sched}: {c} != niter")
        emit({"phase": "parity", "mode": mode, "throttle": thr,
              "merged": merged, "sched": {k: v for k, v in sched.items()},
              "graphs": graphed, "ok": True})


FACES_KERNELS = ("halo_pack", "halo_unpack", "counter_bump", "put_signal",
                 "faces_increment")


def phase_full(core, _build, dev):
    """64 ranks x 64^3, 20 iterations in each mode. st and fused are CUDA
    graphs: their first run captures, and the counted run is a replay
    under sync-debug "error", which must equal the first run and the
    eager emission bit for bit and leave the first result unchanged;
    host mode stays eager. The kernels' launches are counted over the
    counted run alone."""
    halo = core.halo
    R = int(np.prod(GRID_FULL))
    gen = torch.Generator(device=dev).manual_seed(0)
    src0 = torch.rand((R,) + N_FULL, generator=gen, device=dev)
    outs, launches, dispatches = {}, {}, {}
    for mode in MODES:
        graphed = mode != "host"
        stream = core.STStream(dev, AXES, grid_shape=GRID_FULL)
        halo.build_faces_program(stream, N_FULL, NITER_FULL)
        state = stream.allocate()
        state["faces.src"] = src0

        def run(stream=stream, state=state, mode=mode):
            return stream.synchronize(state, mode=mode, resources=16)
        line = {}
        if graphed:
            t0 = time.perf_counter()
            first = run()                       # warm-up, capture, replay
            line["first_run_s"] = time.perf_counter() - t0
            kept = {k: v.clone() for k, v in first.items()}
        torch.cuda.synchronize()
        _build.reset_launches()                 # the counted run
        d0 = stream.dispatches
        if graphed:
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        launches[mode] = dict(_build.LAUNCHES)
        dispatches[mode] = stream.dispatches - d0
        progs = stream.scheduled_programs(resources=16,
                                          fused=mode == "fused")
        if mode == "fused":
            want = sum(core.host_dispatch_count(p) for p in progs)
            check(dispatches[mode] == want,
                  f"fused dispatches {dispatches[mode]} != {want}")
        if mode == "st":
            check(dispatches[mode] == sum(len(p.nodes) for p in progs),
                  "st dispatches != descriptor count")
        for k in FACES_KERNELS:
            check(_build.LAUNCHES[k] > 0,
                  f"{mode}: kernel {k} was not launched")
        # per iteration: one merged post bump and 26 puts carrying their
        # completion signals; host keeps each completion a bump of its own
        want = {"halo_pack": 1, "halo_unpack": 1, "put_signal": 26,
                "faces_increment": 1,
                "counter_bump": 27 if mode == "host" else 1}
        got = {k: _build.LAUNCHES[k] / NITER_FULL for k in want}
        check(got == want, f"{mode}: launches per iteration {got} != {want}")
        for c in ("faces.post_sig", "faces.comp_sig"):
            check(bool((out[c] == NITER_FULL).all()), f"{mode}: {c} != niter")
        if graphed:
            g = program_graphs(stream, mode)
            want = (sum(core.host_dispatch_count(p) for p in progs)
                    if mode == "fused" else 1)
            check(len(g.chain) == want, f"{mode}: {len(g.chain)} graphs "
                  f"per program, want {want}")
            for k in out:
                check(torch.equal(out[k], first[k])
                      and torch.equal(first[k], kept[k]),
                      f"{mode}: the replay gave another {k}, or changed "
                      "the first result's")
            eager = eager_emission(core, stream, mode, state)
            check(all(torch.equal(out[k], eager[k]) for k in out),
                  f"{mode}: the graph's state differs from the eager "
                  "emission's")
            line.update(graphs_per_program=len(g.chain),
                        warm_up_s=g.warm_up_seconds,
                        capture_s=g.capture_seconds,
                        equal_to_eager_emission=True,
                        replay_under_sync_debug_error=True,
                        first_result_unchanged=True)
            del first, kept, eager
            stream.clear_graphs()
        outs[mode] = out
        emit(dict({"phase": "full", "mode": mode, "grid": list(GRID_FULL),
                   "n": list(N_FULL), "niter": NITER_FULL,
                   "launches": launches[mode],
                   "sim_dispatch_units": dispatches[mode]}, **line))
    for mode in ("host", "fused"):
        for k in outs["st"]:
            check(torch.equal(outs[mode][k], outs["st"][k]),
                  f"{mode} differs from st on {k}")
    st = outs["st"]
    src = st["faces.src"].cpu().numpy()
    check(np.isfinite(src).all() and src.shape == (R,) + N_FULL,
          "src not finite / wrong shape")
    total = sum(1.0 + it % 3 for it in range(NITER_FULL))
    np.testing.assert_allclose(src, src0.cpu().numpy() + total, rtol=1e-6)
    acc = st["faces.acc"].cpu().numpy()
    check(np.array_equal(acc, numpy_exchange(halo, src, GRID_FULL, N_FULL)),
          "acc != numpy exchange of the final blocks")
    res = st["faces.res"].cpu().numpy()
    check(np.array_equal(res[:, 0], np.abs(acc).reshape(R, -1).max(1)),
          "res != per-rank max|acc|")
    emit({"phase": "full", "bit_identical_modes": ["st", "host", "fused"],
          "exchange_exact": True})
    return launches, dispatches


# the kernels that copy a program graph's state in and out (a foreach
# copy; a plain device-to-device copy where it splits), as the profiler
# names them
COPY_OPS = ("multi_tensor_apply", "Memcpy DtoD")


def faces_timing(core, dev, dispatches):
    """Per-iteration ms of the st, host and fused Faces 64r programs, as a
    user runs them: st and fused replay their CUDA graphs, host mode is
    eager; beside them the eager emission of the st program ("st_eager",
    what the graph captures). The runs take turns. Each mode's first run
    (for a graph: warm-up, capture, instantiation) is timed apart. From
    the profiler: the device's busy time and idle share, the device ops
    per iteration with the graphs' state copies apart (the program's own
    ops must equal the eager emission's), and the host's launch calls (one
    cudaGraphLaunch per program in st, one per segment in fused). Peak
    device memory of a run of each and what its first run leaves
    allocated (a graph's static inputs and pool), and the time of the
    copies in and out alone."""
    R = int(np.prod(GRID_FULL))
    gen = torch.Generator(device=dev).manual_seed(2)
    src0 = torch.rand((R,) + N_FULL, generator=gen, device=dev)
    runs, first_ms, kept_mb, streams = {}, {}, {}, {}
    for mode in MODES + ("st_eager",):
        stream = core.STStream(dev, AXES, grid_shape=GRID_FULL)
        core.halo.build_faces_program(stream, N_FULL, NITER_FULL)
        state = stream.allocate()
        state["faces.src"] = src0
        streams[mode] = (stream, state)
        if mode == "st_eager":
            prog, = stream.scheduled_programs(resources=16)
            runs[mode] = (lambda stream=stream, state=state, prog=prog:
                          core.backends._emit_st(stream, prog, state))
        else:
            runs[mode] = (lambda stream=stream, state=state, mode=mode:
                          stream.synchronize(state, mode=mode, resources=16))
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        runs[mode]()                                # warm-up / capture
        torch.cuda.synchronize()
        first_ms[mode] = 1e3 * (time.perf_counter() - t0)
        # what the first run leaves allocated: a graph's static inputs
        # and its pool; nothing for an eager run
        kept_mb[mode] = (torch.cuda.memory_allocated() - before) / 1e6
    # the modes take turns (order reversed every round), so a slow
    # stretch of the shared host does not land on one mode only
    order = list(runs)
    times = {m: [] for m in order}
    for rnd in range(7):
        for mode in (order if rnd % 2 == 0 else order[::-1]):
            times[mode].append(event_ms(runs[mode], reps=1, warm=False))
    program_ops = {}
    for mode in ("st_eager",) + MODES:
        ts = sorted(times[mode])
        ms = statistics.median(ts)
        # a trace can miss device events (the profiler's buffer): a graph
        # mode's trace that counts other ops than the eager emission's is
        # taken again, at most twice, before the check below holds it
        for _ in range(3):
            prof = device_profile(runs[mode], os.path.join(
                OUT_DIR, f"profile_faces_{mode}.txt"))
            copies = sum(c for k, c in prof["ops"].items()
                         if any(w in k for w in COPY_OPS))
            program_ops[mode] = (prof["device_ops"] - copies) / NITER_FULL
            if mode == "st_eager" or \
                    program_ops[mode] == program_ops["st_eager"]:
                break
        busy = prof["busy_ms"]
        faces_ms = kernel_ms(prof, ("halo_pack", "halo_unpack",
                                    "faces_increment"))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        runs[mode]()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        line = {"phase": "timing", "mode": mode,
                "graphs": mode in ("st", "fused"),
                "iter_ms": ms / NITER_FULL,
                "program_ms": ms, "program_ms_runs": ts, "niter": NITER_FULL,
                # warm-up + capture + instantiation + a replay for a graph
                "first_run_ms": first_ms[mode],
                "first_run_kept_mb": kept_mb[mode],
                "device_ops_per_iter": prof["device_ops"] / NITER_FULL,
                "state_copy_ops_per_program": copies,
                "program_device_ops_per_iter": program_ops[mode],
                # what the host really issued: one cudaGraphLaunch per
                # graph, or one launch per device op
                "host_calls_per_iter": {k: v / NITER_FULL for k, v in
                                        sorted(prof["host_calls"].items())},
                "host_calls_per_program": dict(sorted(
                    prof["host_calls"].items())),
                "device_busy_ms": busy,
                "device_busy_ms_per_iter": (None if busy is None
                                            else busy / NITER_FULL),
                "device_idle_share": (None if busy is None
                                      else 1 - busy / ms),
                "kernel_device_ms_per_iter": {k: v / NITER_FULL
                                              for k, v in faces_ms.items()},
                # peak above what was allocated before the run (the state
                # and, for a graph, its static inputs and pool)
                "run_peak_mem_gb": (peak - base) / 1e9,
                "resident_mem_gb": base / 1e9,
                "top_device_ms": [[round(t, 4), k, c]
                                  for t, k, c in prof["top"]]}
        if mode != "st_eager":
            # the cost simulator's accounting unit (one per descriptor,
            # one per segment in fused mode), not a launch count
            line["sim_dispatch_units_per_iter"] = (dispatches[mode]
                                                   / NITER_FULL)
        if mode in ("st", "fused"):
            stream, state = streams[mode]
            g = program_graphs(stream, mode)
            launched = prof["host_calls"].get("cudaGraphLaunch", 0)
            check(launched == len(g.chain), f"{mode}: the profiler saw "
                  f"{launched} graph launches per program, want "
                  f"{len(g.chain)}")
            check(program_ops[mode] == program_ops["st_eager"],
                  f"{mode}: {program_ops[mode]} device ops per iteration "
                  f"in the graph, {program_ops['st_eager']} eager")
            keys = list(g.out)
            fresh = [torch.empty_like(g.out[k]) for k in keys]
            line.update({
                "graphs_per_program": len(g.chain),
                "warm_up_ms": 1e3 * g.warm_up_seconds,
                "capture_ms": 1e3 * g.capture_seconds,
                "state_mb": sum(v.numel() * v.element_size()
                                for v in state.values()) / 1e6,
                # the copies in and out alone, per program
                "copy_in_ms": event_ms(lambda: core.graphs._copy(
                    [g.static[k] for k in state], list(state.values()))),
                "copy_out_ms": event_ms(lambda: core.graphs._copy(
                    fresh, [g.out[k] for k in keys]))})
            del fresh
        emit(line)
    for stream, _ in streams.values():
        stream.clear_graphs()


def phase_timing(core, hp, hp_ref, cb, lib_cb, dev, launches, dispatches,
                 errs):
    faces_timing(core, dev, dispatches)
    R = int(np.prod(GRID_FULL))
    gen = torch.Generator(device=dev).manual_seed(3)
    field = torch.rand((R,) + N_FULL, generator=gen, device=dev)
    _, total = core.halo.offsets_of(N_FULL)
    cells = field[0].numel()
    # the boundary shell: the distinct cells the 26 surfaces cover (an
    # edge cell is in 3 surfaces, a corner cell in 7), read once each
    shell = cells - int(np.prod([max(x - 2, 0) for x in N_FULL]))
    # the library yardsticks' index: flat cell of every surface element,
    # in offsets_of order (built once, like the kernels' geometry)
    grid = np.arange(cells).reshape(N_FULL)
    idx = torch.as_tensor(np.concatenate(
        [grid[core.halo.surface_slices(N_FULL, d)].ravel()
         for d in core.halo.DIRECTIONS]), device=dev)
    zero_acc = torch.zeros((R, cells), device=dev)
    recv = hp.halo_pack(torch.randn(field.shape, generator=gen, device=dev))
    recv16 = recv.to(torch.bfloat16)
    sig = torch.zeros((R, 26), dtype=torch.int32, device=dev)
    upd = torch.ones((R, 26), dtype=torch.int32, device=dev)
    max_abs = core.halo._max_abs

    def lib_pack():
        return field.view(R, cells).index_select(1, idx)

    def lib_unpack():
        return zero_acc.index_add(1, idx, recv)

    # each yardstick against the kernel on the same inputs: index_select
    # and add are exact; index_add adds with atomics in an unspecified
    # order, so it is held to float32 rounding of <= 7 adds
    # (rtol 1.3e-6, atol 1e-5)
    pairs = {"halo_pack": (lib_pack(), hp.halo_pack(field)),
             "halo_unpack": (lib_unpack().view(field.shape),
                             hp.halo_unpack(recv, N_FULL)),
             "counter_bump": (torch.add(sig, upd), cb.counter_bump(sig, upd))}
    check(torch.equal(*pairs["halo_pack"]), "index_select != halo_pack")
    check(torch.equal(*pairs["counter_bump"]), "torch.add != counter_bump")
    torch.testing.assert_close(*pairs["halo_unpack"], rtol=1.3e-6,
                               atol=1e-5)
    lib_err = {k: float((a - b).abs().max().item())
               for k, (a, b) in pairs.items()}
    # the increment's yardstick times a pass; it computes another function
    lib_err["faces_increment"] = None
    empty = lib_cb.empty_launch

    def launch_floor():
        check(empty(torch.cuda.current_stream().cuda_stream) == 0,
              "the empty kernel did not launch")

    # the pack cold: four fields (268 MB) in turns, beside the warm ms
    fields = [field] + [torch.rand(field.shape, generator=gen, device=dev)
                        for _ in range(3)]
    written = R * total * 4
    _, it = increment_inputs(gen, dev, R, (1, 1, 1))
    # the increment at the n128 cell's block too (537 MB a buffer)
    big, _ = increment_inputs(gen, dev, R, (128, 128, 128))
    rows = [
        # bound: the distinct 32-byte sectors of the field the shell covers
        # and the surfaces written; the useful bytes' bound beside it
        ("halo_pack", "src/repro_torch/csrc/halo_pack.cu",
         "src/repro/kernels/halo_pack/kernel.py:39",
         lambda: hp.halo_pack(field), lambda: hp_ref.halo_pack_ref(field),
         lib_pack, "torch.index_select",
         sector_bytes(N_FULL, R, 4) + written,
         {"bytes_counted_as": lambda: "distinct 32-byte sectors of the "
                                      "field read, plus the bytes written",
          "bound_useful_bytes_ms": lambda: (R * shell * 4 + written)
          / HBM_BYTES_PER_S * 1e3,
          "cold_ms": lambda: cold_ms(hp.halo_pack, fields),
          "library_cold_ms": lambda: cold_ms(
              lambda f: f.view(R, cells).index_select(1, idx), fields)}),
        # the time of the form without the max (what halo_unpack_fwd
        # computes); the main path's form, with the max, beside it
        ("halo_unpack", "src/repro_torch/csrc/halo_pack.cu",
         "src/repro/kernels/halo_pack/kernel.py:53",
         lambda: hp.halo_unpack(recv, N_FULL),
         lambda: hp_ref.halo_unpack_ref(recv, N_FULL),
         lib_unpack, "torch.index_add (zero base)",
         R * (total + cells) * 4,
         {"with_max_ms": lambda: graph_ms(
             lambda: hp.halo_unpack(recv, N_FULL, with_max=True)),
          "with_max_plain_ms": lambda: graph_ms(
              lambda: max_abs(hp_ref.halo_unpack_ref(recv, N_FULL))),
          # the dtypes the kernel adds since the repair, bf16 timed: the
          # same cells, half the bytes
          "dtypes": lambda: [str(d) for d in hp.UNPACK_DTYPES],
          "bf16_ms": lambda: graph_ms(
              lambda: hp.halo_unpack(recv16, N_FULL)),
          "bf16_plain_ms": lambda: graph_ms(
              lambda: hp_ref.halo_unpack_ref(recv16, N_FULL)),
          "bf16_bound_ms": lambda: R * (total + cells) * 2
          / HBM_BYTES_PER_S * 1e3}),
        # beside the bump, the launch floor: an empty kernel's time
        ("counter_bump", "src/repro_torch/csrc/counter_bump.cu",
         "src/repro/core/engine.py:67",
         lambda: cb.counter_bump(sig, upd),
         lambda: cb.counter_bump_ref(sig, upd),
         lambda: torch.add(sig, upd), "torch.add", 3 * sig.numel() * 4,
         {"launch_floor_ms": lambda: graph_ms(launch_floor)}),
        # no TPU kernel: the reference's jnp closure; its plain version is
        # the four PyTorch kernels it replaced, its yardstick one PyTorch
        # pass over the block (src + 1.0 alone); at n64 and n128, warm and
        # (n64) cold
        ("faces_increment", "src/repro_torch/csrc/halo_pack.cu",
         "none: the jnp closure at src/repro/core/halo.py:95-96",
         lambda: hp.faces_increment(field, it),
         lambda: hp_ref.faces_increment_ref(field, it),
         lambda: torch.add(field, 1.0), "torch.add (src + 1.0 alone)",
         2 * (field.numel() + it.numel()) * 4,
         {"cold_ms": lambda: cold_ms(lambda f: hp.faces_increment(f, it),
                                     fields),
          "at_n128": lambda: {
              "ms": graph_ms(lambda: hp.faces_increment(big, it)),
              "plain_ms": graph_ms(
                  lambda: hp_ref.faces_increment_ref(big, it)),
              "library_ms": graph_ms(lambda: torch.add(big, 1.0)),
              "bound_ms": 2 * (big.numel() + it.numel()) * 4
              / HBM_BYTES_PER_S * 1e3}}),
    ]
    kernels = []
    for (name, source, replaces, kern, plain, lib, lib_name, nbytes,
         extra) in rows:
        # ms/plain_ms/library_ms: device time per call (CUDA graph);
        # *call_ms: eager calls back to back, host overhead included.
        # Pack/unpack are timed in their flat forms, where the plain
        # version materializes the same bytes (its split pack returns
        # views); the main path's split forms run the same kernels.
        # bound: each input read once, each output written once.
        kernels.append(dict({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(launches[m][name] for m in launches),
            "launches_by_mode": {m: launches[m][name] for m in launches},
            "launches_per": {"per_iteration": launches["st"][name]
                             / NITER_FULL},
            "max_abs_err": errs[name], "ms": graph_ms(kern),
            "plain_ms": graph_ms(plain),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": nbytes,
            "library_ms": graph_ms(lib), "library": lib_name,
            "library_max_abs_err": lib_err[name],
            "call_ms": event_ms(kern, inner=20),
            "plain_call_ms": event_ms(plain, inner=20),
            "library_call_ms": event_ms(lib, inner=20)},
            **{k: f() for k, f in extra.items()}))
    kernels.append(put_signal_row(core, cb, dev, launches, errs))
    return kernels


def sector_bytes(n, R, nbytes_el):
    """Bytes of the distinct 32-byte sectors that hold the boundary shell
    of an (R, *n) field of ``nbytes_el``-byte elements: the least the card
    can read to pack it (a lone end cell of a row costs a whole sector)."""
    shell = np.ones(n, dtype=bool)
    shell[1:-1, 1:-1, 1:-1] = False
    cells = (np.arange(R)[:, None] * int(np.prod(n))
             + np.flatnonzero(shell)[None, :])
    return np.unique(cells * nbytes_el // 32).size * 32


def fetch_probe(dev, lib, reps=16):
    """Reads of a cold 67 MB float32 buffer (the 64r field's size) seen as
    256-byte rows: one thread a row reads its first 1, 8 or 16 floats, or
    its first and last float (the pack's end cells: "ends"), and writes
    their sum (the same output each way; ``fetch_probe_launch`` in
    csrc/halo_pack.cu). If a lone float costs what 8 do, the card fetches
    32-byte sectors; if it costs what 16 do, 64 bytes. ``reps`` such
    buffers in turns keep each cold (cold_ms)."""
    rows = int(np.prod(GRID_FULL)) * int(np.prod(N_FULL)) // 64
    bufs = torch.rand((reps, rows, 64), device=dev)

    def read(buf, k):
        out = torch.empty(rows, device=dev)
        check(lib.fetch_probe_launch(buf.data_ptr(), rows, k, out.data_ptr(),
                                     torch.cuda.current_stream().cuda_stream)
              == 0, "the fetch probe did not launch")
        return out
    ways = {"1_float": 1, "ends": 2, "8_floats": 8, "16_floats": 16}
    for k in ways.values():           # sums in another order: rounding
        want = bufs[0][:, [0, 63]] if k == 2 else bufs[0][:, :k]
        torch.testing.assert_close(read(bufs[0], k), want.sum(1))
    ms = {f"{w}_per_row_ms": cold_ms(lambda b, k=k: read(b, k), list(bufs))
          for w, k in ways.items()}
    emit({"phase": "timing", "probe": "fetch_granularity",
          "buffer_bytes": rows * 256, "rows": rows, **ms,
          "sectors_32B_ms": rows * 32 / HBM_BYTES_PER_S * 1e3,
          "fetches_64B_ms": rows * 64 / HBM_BYTES_PER_S * 1e3})
    del bufs


# put_signal at Faces' payloads (R = 64, n = 64^3, float32): a face, an
# edge and a corner, each with the direction it goes in
PUT_PAYLOADS = (("face", 64 * 64, (1, 0, 0)), ("edge", 64, (1, 1, 0)),
                ("corner", 1, (1, 1, 1)))


def put_signal_row(core, cb, dev, launches, errs):
    """put_signal's kernels-line row, timed at the face payload, with
    the edge and corner in ``at_payloads``. No one PyTorch call permutes
    rows and bumps a counter: its yardstick is the two launches the port
    made before it (index_select, then torch.add), and index_select alone
    beside it. Bound: the payload read and written once, the permutation
    table and the counters."""
    R = int(np.prod(GRID_FULL))
    gen = torch.Generator(device=dev).manual_seed(5)
    stream = core.STStream(dev, AXES, grid_shape=GRID_FULL)
    sig = torch.zeros((R, 26), dtype=torch.int32, device=dev)
    upd = torch.ones((R, 26), dtype=torch.int32, device=dev)
    at = {}
    for what, e, d in PUT_PAYLOADS:
        perm = core.engine._perm_index(stream, d)
        x = torch.randn((R, e), generator=gen, device=dev)
        got, cnt = cb.put_signal(x, perm, sig, upd)
        check(torch.equal(got, x.index_select(0, perm))
              and torch.equal(cnt, sig + upd), "index_select + add != "
              "put_signal")
        nbytes = 2 * x.numel() * 4 + perm.numel() * 8 + 3 * sig.numel() * 4
        kern = (lambda x=x, perm=perm: cb.put_signal(x, perm, sig, upd))
        two = (lambda x=x, perm=perm: (x.index_select(0, perm),
                                       torch.add(sig, upd)))
        at[what] = {
            "elements_per_rank": e, "ms": graph_ms(kern),
            "plain_ms": graph_ms(lambda x=x, perm=perm: cb.put_signal_ref(
                x, perm, sig, upd)),
            "index_select_add_ms": graph_ms(two),
            "index_select_ms": graph_ms(
                lambda x=x, perm=perm: x.index_select(0, perm)),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
            "call_ms": event_ms(kern, inner=20),
            "index_select_add_call_ms": event_ms(two, inner=20)}
    face = at["face"]
    return {"name": "put_signal", "route": "cuda",
            "source": "src/repro_torch/csrc/counter_bump.cu",
            # the chained completion signal's bump, now in the put's launch
            "replaces": "src/repro/core/engine.py:67",
            "launches": sum(launches[m]["put_signal"] for m in launches),
            "launches_by_mode": {m: launches[m]["put_signal"]
                                 for m in launches},
            "launches_per": {"per_iteration": launches["st"]["put_signal"]
                             / NITER_FULL},
            "max_abs_err": errs["put_signal"], "ms": face["ms"],
            "plain_ms": face["plain_ms"], "bound_ms": face["bound_ms"],
            "bound_by": "bytes", "bytes": face["bytes"],
            "library_ms": None,
            "library": "none: no one call permutes rows and bumps a "
                       "counter; index_select_add_ms is the two launches "
                       "it replaces",
            "index_select_add_ms": face["index_select_add_ms"],
            "index_select_ms": face["index_select_ms"],
            "at_payloads": at}


# ---------------------------------------------------------------------------
# attention kernels and the serving path
# ---------------------------------------------------------------------------

# (B, Sq, Skv, H, KV, hd, hdv, kv_valid_len per sequence, q offset,
# causal)
FLASH_CASES = [
    (2, 1000, SERVE_MAX_LEN, 32, 8, 64, 64, (1000, 1000), 0, True),  # granite
    (2, 1000, 1000, 32, 8, 64, 64, (700, 1000), 0, True),  # ragged, kvl < Skv
    (1, 256, 256, 8, 8, 64, 64, None, 0, True),            # G = 1
    (1, 200, 333, 8, 2, 128, 128, (333,), 133, True),      # hd 128
    (2, 1000, SERVE_MAX_LEN, 64, 8, 128, 128, (1000, 1000), 0, True),  # jamba
    # tile edges: 65 rows (a 1-row q-tile), 129 keys (a 1-key tile),
    # kv_valid_len 64 (a tile boundary), q offset 64
    (2, 65, 129, 16, 2, 128, 128, (129, 64), 64, True),
    # (hd, hdv) = (192, 128), deepseek-v2's MLA: its prefill (4 x 1000
    # tokens, 128 heads over 128 expanded KV heads, a 4096-row cache), a
    # ragged case and the tile edges
    (4, 1000, SERVE_MAX_LEN, 128, 128, 192, 128, (1000,) * 4, 0, True),
    (2, 1000, 1000, 16, 16, 192, 128, (700, 1000), 0, True),
    (2, 65, 129, 16, 16, 192, 128, (129, 64), 64, True),
    # llama-3.2-vision's cross prefill: 8 prompts of 1000 tokens against
    # all 1600 vision rows, not causal, no valid length
    (8, 1000, VISION_TOKENS, 64, 8, 128, 128, None, 0, False),
    # musicgen-large's prefill: MHA at hd 64
    (8, 1000, SERVE_MAX_LEN, 32, 32, 64, 64, (1000,) * 8, 0, True),
]
# the kernels-line row of each case: (hd, hdv) = (192, 128) has its own
MLA_HEAD_DIMS = (192, 128)
# (B, S, H, KV, hd, positions, causal); causal: valid length position
# + 1 <= S; not causal (a cross layer's decode): every key valid, no
# position passed
DECODE_CASES = [
    (8, SERVE_MAX_LEN, 32, 8, 64, (1016, 144, 528, 1016, 272, 1016, 528,
                                   144), True),    # granite decode
    (2, 512, 8, 8, 64, (100, 511), True),         # G = 1
    (3, 1024, 8, 2, 128, (5, 700, 1023), True),   # hd 128
    (8, SERVE_MAX_LEN, 64, 8, 128, (1016, 144, 528, 1016, 272, 1016, 528,
                                    144), True),   # jamba decode
    # split edges (16 splits of S = 1000 for 4 x 2 KV heads on 132 SMs):
    # 1 key (split 0 only), 15 keys (an empty split), 64 keys (16 equal
    # splits), all 1000 keys (no multiple of the split width or the tile)
    (4, 1000, 8, 2, 64, (0, 14, 63, 999), True),
    # granite-34b's decode: MQA, 48 query heads on one KV head (G = 48:
    # three 16-row head groups of the bf16 kernel)
    (8, SERVE_MAX_LEN, 48, 1, 128, (1016, 144, 528, 1016, 272, 1016, 528,
                                    144), True),
    # llama-3.2-vision's cross decode: 8 slots at positions below 1600
    # over all 1600 vision rows
    (8, VISION_TOKENS, 64, 8, 128, (1016, 144, 528, 1016, 272, 1016, 528,
                                    144), False),
    # musicgen-large's decode: MHA at hd 64
    (8, SERVE_MAX_LEN, 32, 32, 64, (1016, 144, 528, 1016, 272, 1016, 528,
                                    144), True),
]
# the G of the decode case with a kernels-line row of its own
MQA_GROUP = 48
# the attention kernels' kernels-line rows
ATTN_ROWS = ("flash_attention", "decode_attention", "flash_attention_192x128",
             "decode_attention_g48", "flash_attention_cross",
             "decode_attention_cross")


def attn_inputs(dev, dtype, B, Sq, Skv, H, KV, hd, seed, hdv=None):
    """Unit-normal q (B,Sq,H,hd), k (B,Skv,KV,hd), v (B,Skv,KV,hdv or
    hd) from ``seed``."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def mk(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    return mk(B, Sq, H, hd), mk(B, Skv, KV, hd), mk(B, Skv, KV, hdv or hd)


def attn_limit(dtype, ref):
    """The largest error allowed against ``ref`` (see ATTN_ATOL_F32)."""
    if dtype == torch.float32:
        return ATTN_ATOL_F32
    return ATTN_RTOL_BF16 * ref.float().abs().max().item()


def phase_attention(dev, fa, fa_ref, da, da_ref):
    """Each attention kernel against its plain version on the card, bf16
    and float32 (comparison launches, made before the counted runs).
    Returns the largest errors by kernels-line row and dtype: the
    (192, 128) cases, the G = 48 decode case and the cross (not causal)
    cases have rows of their own."""
    errs = {row: {} for row in ATTN_ROWS}
    for n, (B, Sq, Skv, H, KV, hd, hdv, kvl, off, causal) in enumerate(
            FLASH_CASES):
        row = ("flash_attention_192x128" if (hd, hdv) == MLA_HEAD_DIMS
               else "flash_attention" if causal else "flash_attention_cross")
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = attn_inputs(dev, dtype, B, Sq, Skv, H, KV, hd, n, hdv)
            pos = (off + torch.arange(Sq, device=dev,
                                      dtype=torch.int32)).expand(B, Sq)
            kv_len = None if kvl is None else torch.tensor(
                kvl, device=dev, dtype=torch.int32)
            out = fa(q, k, v, q_positions=pos, kv_valid_len=kv_len,
                     causal=causal)
            ref = fa_ref(q, k, v, q_offset=pos[:, 0], kv_valid_len=kv_len,
                         causal=causal)
            err = (out.float() - ref.float()).abs().max().item()
            limit = attn_limit(dtype, ref)
            check(out.shape == ref.shape and out.dtype == dtype,
                  f"flash attention: shape/dtype {out.shape} {out.dtype}")
            check(err <= limit, f"flash attention case {n} {dtype}: max "
                  f"abs err {err} > {limit}")
            d = errs[row]
            d[str(dtype)] = max(d.get(str(dtype), 0.0), err)
            emit({"phase": "kernels", "kernel": "flash_attention",
                  "shape": [B, Sq, Skv, H, KV, hd, hdv], "kv_valid_len": kvl,
                  "q_offset": off, "causal": causal, "dtype": str(dtype),
                  "max_abs_err": err,
                  "ref_abs_max": ref.float().abs().max().item(),
                  "limit": limit})
    for n, (B, S, H, KV, hd, positions, causal) in enumerate(DECODE_CASES):
        row = ("decode_attention_g48" if H // KV == MQA_GROUP
               else "decode_attention" if causal
               else "decode_attention_cross")
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = attn_inputs(dev, dtype, B, 1, S, H, KV, hd, 10 + n)
            pos = torch.tensor(positions, device=dev,
                               dtype=torch.int32)[:, None]
            # not causal: no position and no valid length, every key
            kw = (dict(q_positions=pos, kv_valid_len=pos[:, 0] + 1)
                  if causal else {})
            out = da(q, k, v, **kw)
            ref = da_ref(q, k, v, **kw)
            err = (out.float() - ref.float()).abs().max().item()
            limit = attn_limit(dtype, ref)
            check(out.shape == ref.shape and out.dtype == dtype,
                  f"decode attention: shape/dtype {out.shape} {out.dtype}")
            check(err <= limit, f"decode attention case {n} {dtype}: max "
                  f"abs err {err} > {limit}")
            d = errs[row]
            d[str(dtype)] = max(d.get(str(dtype), 0.0), err)
            emit({"phase": "kernels", "kernel": "decode_attention",
                  "shape": [B, S, H, KV, hd], "positions": positions,
                  "causal": causal, "dtype": str(dtype), "max_abs_err": err,
                  "ref_abs_max": ref.float().abs().max().item(),
                  "limit": limit})
    return errs


# (B, S, H, hd): test_kernels.py's shapes, rwkv6-1.6b's decode step and a
# ragged 1000-token prefill of 3 rows
WKV_CASES = [(2, 128, 2, 32), (1, 256, 4, 64), (8, 1, 32, 64),
             (3, 1000, 32, 64)]


def wkv_inputs(dev, dtype, B, S, H, hd, seed):
    """r, k, v at scale 0.3 in ``dtype``, logw = -exp(N(0,1)) float32, u
    and a nonzero s0 at scale 0.1 (tests/test_kernels.py's inputs)."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def mk(*shape, scale=0.3):
        return scale * torch.randn(shape, generator=gen, device=dev)
    r, k, v = (mk(B, S, H, hd).to(dtype) for _ in range(3))
    logw = -torch.exp(mk(B, S, H, hd, scale=1.0))
    return r, k, v, logw, mk(H, hd, scale=0.1), mk(B, H, hd, hd, scale=0.1)


def phase_wkv6(dev, wkv, wkv_ref):
    """The WKV6 kernel against its plain version on the card, float32
    and bf16 r, k, v (comparison launches, made before the counted
    runs): every case, two 500-step launches with the state carried
    against one of 1000, and the state written in place over a cache's
    rows. Both compute in float32 on the same values (bf16 upcast), so
    only the summation order differs: WKV_ATOL."""
    errs = {}

    def held(what, dtype, got, want):
        err = (got - want).abs().max().item()
        check(err <= WKV_ATOL, f"wkv6 {what} {dtype}: max abs err {err} > "
              f"{WKV_ATOL}")
        errs[str(dtype)] = max(errs.get(str(dtype), 0.0), err)
        return err

    for n, (B, S, H, hd) in enumerate(WKV_CASES):
        for dtype in (torch.bfloat16, torch.float32):
            ins = wkv_inputs(dev, dtype, B, S, H, hd, 20 + n)
            y, sT = wkv(*ins)
            yr, sTr = wkv_ref(*ins)
            check(y.shape == yr.shape and y.dtype == torch.float32
                  and sT.shape == sTr.shape, "wkv6: shape/dtype")
            emit({"phase": "kernels", "kernel": "wkv6",
                  "shape": [B, S, H, hd], "dtype": str(dtype),
                  "max_abs_err_y": held(f"case {n} y", dtype, y, yr),
                  "max_abs_err_state": held(f"case {n} state", dtype, sT,
                                            sTr),
                  "y_abs_max": yr.abs().max().item(), "limit": WKV_ATOL})
    B, S, H, hd = WKV_CASES[-1]
    for dtype in (torch.bfloat16, torch.float32):
        r, k, v, logw, u, s0 = wkv_inputs(dev, dtype, B, S, H, hd, 30)
        y, sT = wkv(r, k, v, logw, u, s0)
        h = S // 2
        y1, s1 = wkv(r[:, :h], k[:, :h], v[:, :h], logw[:, :h], u, s0)
        y2, s2 = wkv(r[:, h:], k[:, h:], v[:, h:], logw[:, h:], u, s1)
        cache = torch.zeros((B + 2,) + tuple(s0.shape[1:]), device=dev)
        cache[1:B + 1] = s0
        yi, si = wkv(r, k, v, logw, u, cache[1:B + 1], inplace=True)
        check(si.data_ptr() == cache[1].data_ptr()
              and not cache[0].any() and not cache[B + 1:].any(),
              "wkv6: in-place state not written over s0 alone")
        emit({"phase": "kernels", "kernel": "wkv6", "dtype": str(dtype),
              "carried": f"{h} + {S - h} steps against {S}",
              "max_abs_err_y": held("carried y", dtype,
                                    torch.cat([y1, y2], 1), y),
              "max_abs_err_state": held("carried state", dtype, s2, sT),
              "in_place_max_abs_err": max(
                  held("in place y", dtype, yi, y),
                  held("in place state", dtype, cache[1:B + 1], sT))})
    return errs


def rwkv_redraw(params, gen):
    """Redraw the rwkv leaves the init leaves constant (token-shift
    mixes 1, decay base w0 0, bonus 0), so that the token shift, the
    decay spread and the bonus all act: mixes U(0, 1), w0 U(-6, 1) (a
    decay of w = exp(-exp(w0 - 0.5)) in [0.07, 1)), bonus U(0, 0.5).
    The ranges of tests/_rwkv_draws.py, which the script cannot import;
    ``ln_x`` stays 1 here: the kernel and plain paths share its cast, so
    only the tests against the reference need it away from 1."""
    for layer in params["layers"]:
        for name, t in {**layer["mixer"], **layer["ffn"]}.items():
            if name.startswith("mix_"):
                t.uniform_(0, 1, generator=gen)
        layer["mixer"]["w0"].uniform_(-6, 1, generator=gen)
        layer["mixer"]["bonus"].uniform_(0, 0.5, generator=gen)


def wkv6_bound(B, S, H, hd, nbytes_el):
    """(bytes, flops) of one launch: r, k, v read once (``nbytes_el``
    each), logw read and y written as float32, u read, the state read
    and written once; per (b, t, h) 2 hd^2 flops for r S, 3 hd^2 for the
    update and ~5 hd for the bonus term."""
    nbytes = (B * S * H * hd * (3 * nbytes_el + 8) + H * hd * 4
              + 2 * B * H * hd * hd * 4)
    flops = B * S * H * (5 * hd * hd + 5 * hd)
    return nbytes, flops


def wkv6_row(dev, wkv, wkv_ref, cfg, d, per, groups, errs):
    """The WKV6 kernel's kernels-line row at the serving shapes (bf16 r,
    k, v): the run's largest prefill dispatch (its ``ms``) and 8 slots
    decoding (``at_decode``). Its operations are float32 multiply-adds
    on the state, so the bound takes them at the float32 rate outside
    the tensor cores (F32_FLOPS_PER_S). No single PyTorch call computes
    the WKV6 recurrence (a loop over time of several ops is the plain
    version itself), so the library time is null."""
    H, hd = cfg.num_heads, cfg.rwkv.head_size
    (n, L) = max(((n, L) for (_, L), n in groups.items()),
                 key=lambda t: t[0] * t[1])

    def timed(B, S, seed):
        ins = wkv_inputs(dev, torch.bfloat16, B, S, H, hd, seed)
        nbytes, flops = wkv6_bound(B, S, H, hd, 2)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_flops = flops / F32_FLOPS_PER_S * 1e3
        return {"shape": {"B": B, "S": S, "H": H, "hd": hd,
                          "dtype": "bfloat16"},
                "ms": graph_ms(lambda: wkv(*ins), inner=5),
                "plain_ms": graph_ms(lambda: wkv_ref(*ins), inner=1),
                "bound_ms": max(t_bytes, t_flops),
                "bound_by": "bytes" if t_bytes >= t_flops else "operations",
                "bytes": nbytes, "flops": flops,
                "call_ms": event_ms(lambda: wkv(*ins), inner=5)}

    prefill = timed(n, L, 40)
    return dict(
        prefill, at_b1=timed(1, L, 42), name="wkv6", route="cuda",
        source="src/repro_torch/csrc/"
        "wkv6.cu", replaces="src/repro/kernels/rwkv6/kernel.py:53",
        launches=sum(p["wkv6"] for kind in per for p in per[kind]),
        launches_per={"per_prefill_dispatch": sum(
            p["wkv6"] for p in per["prefill"]) / d["prefill_dispatches"],
            "per_decode_step": sum(p["wkv6"] for p in per["decode"])
            / d["decode_steps"]},
        max_abs_err=max(errs.values()), max_abs_err_by_dtype=errs,
        at_decode=timed(SERVE_SLOTS, 1, 41), library_ms=None,
        library="none: no single PyTorch call computes the WKV6 "
                "recurrence")


# (B, S, di, ds): test_kernels.py's shapes, jamba's 4 x 1000 prefill
# (S no multiple of the Pallas kernel's chunk) and its decode step
SCAN_CASES = [(2, 128, 64, 8), (1, 64, 128, 16), (4, 1000, 16384, 16),
              (8, 1, 16384, 16)]


def scan_inputs(dev, dtype, B, S, di, ds, seed, extra=32):
    """Mamba's init ranges (mamba_redraw): a_log = log U(1, 16), dt
    log-uniform in [1e-3, 1e-1]; unit-normal x, b, c and h0 at scale
    0.1. b and c are strided column slices of one (B, S, extra + 2 ds)
    tensor, as in the model (the x_proj output, extra = dt_rank)."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def u(*shape):
        return torch.rand(shape, generator=gen, device=dev)
    a_log = torch.log(1 + 15 * u(di, ds))
    dt = torch.exp(np.log(1e-3) + np.log(100.0) * u(B, S, di)).to(dtype)
    x = torch.randn((B, S, di), generator=gen, device=dev).to(dtype)
    xdb = torch.randn((B, S, extra + 2 * ds), generator=gen,
                      device=dev).to(dtype)
    h0 = 0.1 * torch.randn((B, di, ds), generator=gen, device=dev)
    return (a_log, dt, xdb[..., extra:extra + ds], xdb[..., extra + ds:], x,
            h0)


def scan_errs(y, hT, yr, hTr):
    """(error of y, error of the state), each relative to max(1, the
    plain version's largest |value|)."""
    return tuple((a.float() - b.float()).abs().max().item()
                 / max(1.0, b.float().abs().max().item())
                 for a, b in ((y, yr), (hT, hTr)))


def scan_limit(dtype):
    return SCAN_RTOL if dtype == torch.float32 else SCAN_RTOL_BF16


def phase_mamba_scan(dev, scan, scan_ref):
    """The selective-scan kernel against its plain version on the card,
    float32 and bf16 inputs (comparison launches, made before the counted
    runs): every case with strided b and c, the same launch with them
    contiguous (equal), two 500-step launches with the state carried
    against one of 1000, and the state written in place over a cache's
    rows. Tolerances SCAN_RTOL / SCAN_RTOL_BF16."""
    errs = {}

    def held(what, dtype, got, want):
        ey, es = scan_errs(*got, *want)
        check(ey <= scan_limit(dtype) and es <= SCAN_RTOL,
              f"mamba_scan {what} {dtype}: relative errors y {ey}, state "
              f"{es} > {scan_limit(dtype)}, {SCAN_RTOL}")
        d = errs.setdefault(str(dtype), {"y": 0.0, "state": 0.0,
                                         "abs": 0.0})
        d["y"], d["state"] = max(d["y"], ey), max(d["state"], es)
        d["abs"] = max([d["abs"]] + [(a.float() - b.float()).abs().max()
                                     .item() for a, b in zip(got, want)])
        return {"y": ey, "state": es}

    for n, (B, S, di, ds) in enumerate(SCAN_CASES):
        for dtype in (torch.bfloat16, torch.float32):
            ins = scan_inputs(dev, dtype, B, S, di, ds, 50 + n)
            y, hT = scan(*ins)
            yr, hTr = scan_ref(*ins)
            check(y.shape == yr.shape and y.dtype == dtype
                  and hT.dtype == torch.float32 and hT.shape == hTr.shape,
                  "mamba_scan: shape/dtype")
            yc, hc = scan(*ins[:2], ins[2].contiguous(), ins[3].contiguous(),
                          *ins[4:])
            check(torch.equal(yc, y) and torch.equal(hc, hT),
                  "mamba_scan: strided b, c differ from contiguous copies")
            emit({"phase": "kernels", "kernel": "mamba_scan",
                  "shape": [B, S, di, ds], "dtype": str(dtype),
                  "max_rel_err": held(f"case {n}", dtype, (y, hT),
                                      (yr, hTr)),
                  "y_abs_max": yr.float().abs().max().item(),
                  "limit": {"y": scan_limit(dtype), "state": SCAN_RTOL}})
    B, S, di, ds = SCAN_CASES[2]
    for dtype in (torch.bfloat16, torch.float32):
        a, dt, b, c, x, h0 = scan_inputs(dev, dtype, B, S, di, ds, 60)
        y, hT = scan(a, dt, b, c, x, h0)
        h = S // 2
        y1, h1 = scan(a, dt[:, :h], b[:, :h], c[:, :h], x[:, :h], h0)
        y2, h2 = scan(a, dt[:, h:], b[:, h:], c[:, h:], x[:, h:], h1)
        cache = torch.zeros((B + 2, di, ds), device=dev)
        cache[1:B + 1] = h0
        yi, hi = scan(a, dt, b, c, x, cache[1:B + 1], inplace=True)
        check(hi.data_ptr() == cache[1].data_ptr()
              and not cache[0].any() and not cache[B + 1:].any(),
              "mamba_scan: in-place state not written over h0 alone")
        emit({"phase": "kernels", "kernel": "mamba_scan", "dtype": str(dtype),
              "carried": f"{h} + {S - h} steps against {S}",
              "carried_max_rel_err": held("carried", dtype,
                                          (torch.cat([y1, y2], 1), h2),
                                          (y, hT)),
              "in_place_max_rel_err": held("in place", dtype,
                                           (yi, cache[1:B + 1]), (y, hT))})
    return errs


def mamba_redraw(params, gen):
    """Redraw the mamba leaves the init leaves constant (a_log 0: every
    A = -1, so every state channel decays alike; dt_bias 0: dt ~ 0.69,
    the state forgets in about two steps; d_skip 1, conv_b 0) from
    Mamba's init ranges (arXiv:2312.00752): a_log = log U(1, 16) (the
    S4D-real A_n = -(n+1)), dt_bias = softplus^-1(dt) with dt
    log-uniform in [1e-3, 1e-1] (dt_min, dt_max), d_skip U(0.5, 1.5),
    conv_b U(-0.1, 0.1); from the generator that drew the params. The
    ranges of tests/_mamba_draws.py, which the script cannot import."""
    for layer in params["layers"]:
        m = layer["mixer"]
        if "a_log" not in m:
            continue
        m["a_log"].uniform_(1, 16, generator=gen).log_()
        dt = m["dt_bias"].uniform_(np.log(1e-3), np.log(1e-1),
                                   generator=gen).exp_()
        dt.add_(torch.log(-torch.expm1(-dt)))           # softplus^-1
        m["d_skip"].uniform_(0.5, 1.5, generator=gen)
        m["conv_b"].uniform_(-0.1, 0.1, generator=gen)


def mamba_scan_bound(B, S, di, ds, nbytes_el):
    """(bytes, flops, exps) of one launch: dt and x read and y written
    (``nbytes_el`` each), b and c read, a_log read, the state read and
    written once as float32; per (b, t, d, state entry) ~6 float32
    flops (dt A, the update's multiply-add, dt x b, the output's
    multiply-add) and one exp."""
    nbytes = (3 * B * S * di * nbytes_el + 2 * B * S * ds * nbytes_el
              + di * ds * 4 + 2 * B * di * ds * 4)
    return nbytes, 6 * B * S * di * ds, B * S * di * ds


def mamba_scan_row(dev, scan, scan_ref, cfg, d, per, groups, errs):
    """The selective-scan kernel's kernels-line row at the serving shapes
    (bf16 inputs, b and c strided as in the model): the run's largest
    prefill dispatch (its ``ms``) and 8 slots decoding (``at_decode``).
    Its operations are float32, so the bound takes them at the float32
    rate (F32_FLOPS_PER_S); ``exp_ms`` is its exps at the special-
    function rate, a second floor beside the bound. No single PyTorch
    call computes a selective scan, so the library time is null."""
    mb = cfg.mamba
    di, ds = mb.expand * cfg.d_model, mb.d_state
    dtr = mb.dt_rank or -(-cfg.d_model // 16)
    (n, L) = max(((n, L) for (_, L), n in groups.items()),
                 key=lambda t: t[0] * t[1])

    def timed(B, S, seed):
        ins = scan_inputs(dev, torch.bfloat16, B, S, di, ds, seed, dtr)
        nbytes, flops, exps = mamba_scan_bound(B, S, di, ds, 2)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_flops = flops / F32_FLOPS_PER_S * 1e3
        return {"shape": {"B": B, "S": S, "di": di, "ds": ds,
                          "dtype": "bfloat16"},
                "ms": graph_ms(lambda: scan(*ins), inner=5),
                "plain_ms": graph_ms(lambda: scan_ref(*ins), inner=1),
                "bound_ms": max(t_bytes, t_flops),
                "bound_by": "bytes" if t_bytes >= t_flops else "operations",
                "bytes": nbytes, "flops": flops, "exps": exps,
                "exp_ms": exps / SFU_EXPS_PER_S * 1e3,
                "call_ms": event_ms(lambda: scan(*ins), inner=5)}

    prefill = timed(n, L, 70)
    launches = {kind: sum(p["mamba_scan"] for p in per[kind])
                for kind in per}
    return dict(
        prefill, at_b1=timed(1, L, 72), name="mamba_scan", route="cuda",
        source="src/repro_torch/csrc/mamba_scan.cu",
        replaces="src/repro/kernels/mamba_scan/kernel.py:51",
        launches=sum(launches.values()),
        launches_per={"per_prefill_dispatch": launches["prefill"]
                      / d["prefill_dispatches"],
                      "per_decode_step": launches["decode"]
                      / d["decode_steps"]},
        max_abs_err=max(e["abs"] for e in errs.values()),
        max_err_by_dtype=errs,
        at_decode=timed(SERVE_SLOTS, 1, 71), library_ms=None,
        library="none: no single PyTorch call computes a selective scan")


def replay_logits(serving, cfg, params, dev, reqs, moe_impl="gshard",
                  max_rows=None):
    """The engine's tokens fed back teacher-forced through ``cfg``'s
    kernel route, with a cache in the compute dtype: the prompts of one
    length prefilled together into their cache rows (as the engine's
    length groups; at most ``max_rows`` a dispatch, if given), then one
    batched decode step per generated token at ragged positions; MoE
    layers by ``moe_impl`` (the model's default, gshard, unless given).
    Returns (R, T, V) float32 last-position logits, where step t predicts
    token t of each request's output."""
    models = serving["models"]
    R, T = len(reqs), len(reqs[0].out_tokens)
    max_len = max(len(r.prompt) for r in reqs) + T
    cache = models.zeros_from_specs(models.cache_specs(
        cfg, R, max_len, getattr(torch, cfg.compute_dtype)), dev)
    out = torch.empty((R, T, cfg.padded_vocab), device=dev)
    by_len = {}
    for i, r in enumerate(reqs):
        by_len.setdefault(len(r.prompt), []).append(i)
    step = max_rows or len(reqs)
    for L, idx in [(L, idx[j:j + step]) for L, idx in by_len.items()
                   for j in range(0, len(idx), step)]:
        sel = torch.as_tensor(idx, device=dev)
        view = {"layers": [{k: c[k][sel] for k in c}
                           for c in cache["layers"]]}
        batch = {"tokens": torch.as_tensor(
                     np.stack([reqs[i].prompt for i in idx]), device=dev),
                 "positions": torch.arange(L, device=dev, dtype=torch.int32
                                           ).expand(len(idx), L)}
        x, _, _ = models.forward(cfg, params, batch, cache=view,
                                 moe_impl=moe_impl)
        for c, vc in zip(cache["layers"], view["layers"]):
            for k in c:
                c[k][sel] = vc[k]
        out[sel, 0] = models.logits_from_hidden(
            cfg, params, x, last_only=True)[:, 0].float()
    lens = torch.tensor([len(r.prompt) for r in reqs], device=dev,
                        dtype=torch.int32)
    for t in range(1, T):
        toks = torch.tensor([[r.out_tokens[t - 1]] for r in reqs],
                            device=dev, dtype=torch.int32)
        batch = {"tokens": toks, "positions": (lens + t - 1)[:, None]}
        x, _, _ = models.forward(cfg, params, batch, cache=cache,
                                 moe_impl=moe_impl)
        out[:, t] = models.logits_from_hidden(cfg, params, x,
                                              last_only=True)[:, 0].float()
    return out


def count_dispatches(eng, _build):
    """Wrap ``eng``'s prefill and decode steps so that each call records
    the kernel launches it made: returns {"prefill": [...], "decode":
    [...]}, one {kernel: launches} per dispatch."""
    per = {"prefill": [], "decode": []}

    def counted(kind, step):
        def call(*args):
            before = dict(_build.LAUNCHES)
            out = step(*args)
            per[kind].append({k: _build.LAUNCHES[k] - before[k]
                              for k in before})
            return out
        return call
    eng._prefill_sample = counted("prefill", eng._prefill_sample)
    eng._decode_sample = counted("decode", eng._decode_sample)
    return per


DECODE_COMPARE_STEPS = 8


def decode_graph_vs_eager(eng, graphed, new_requests,
                          steps=DECODE_COMPARE_STEPS):
    """The decode graph against the eager step on the same engine state:
    8 slots admitted, then per step the graph replays from the cache as
    it is, the cache is put back, and the eager step function runs the
    same batch. The ids must be equal bit for bit; the cache's largest
    difference after the two is reported (a cuBLAS product that picked
    another algorithm under capture would show there). Host ms per step
    of each, the ids on the host included."""
    for r in new_requests:
        eng.submit(r)
    eng.step()                                   # admission + a replay
    leaves = [t for layer in eng.cache["layers"] for t in layer.values()]
    t_graph, t_eager, cache_diff = [], [], 0.0
    for _ in range(steps):
        active = eng._active()
        check(len(active) == SERVE_SLOTS, "a slot went idle")
        batch = eng._decode_batch(active)
        saved = [t.clone() for t in leaves]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids_g = graphed(eng.params, batch, eng.cache)[0].cpu()
        t_graph.append(1e3 * (time.perf_counter() - t0))
        after = [t.clone() for t in leaves]
        for t, v in zip(leaves, saved):
            t.copy_(v)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids_e = graphed.fn(eng.params, batch, eng.cache)[0].cpu()
        t_eager.append(1e3 * (time.perf_counter() - t0))
        check(torch.equal(ids_g, ids_e), f"{eng.cfg.name}: the decode "
              f"graph's ids {ids_g.tolist()} != eager {ids_e.tolist()}")
        cache_diff = max(cache_diff, max(diff(a, b)
                                         for a, b in zip(after, leaves)))
        del saved, after
        eng._record_decode(active, ids_e.numpy())
    eng.run_until_drained()
    return {"steps": steps, "ids_equal": True,
            "cache_max_abs_diff": cache_diff,
            "graph_ms_per_step": statistics.median(t_graph),
            "eager_ms_per_step": statistics.median(t_eager)}


def layers_of(mixers, which):
    """How many of the layers' ``mixers`` are ``which`` (a mixer or a
    tuple of them)."""
    return sum(mixers.count(m) for m in
               (which if isinstance(which, tuple) else (which,)))


def serve_requests(Request, cfg, rng):
    """``requests(n, lengths=None, new=SERVE_NEW)``: ``n`` requests of
    prompts drawn from ``rng`` at ``lengths`` (by default drawn from
    SERVE_LENGTHS), ``new`` tokens each."""
    def requests(n, lengths=None, new=SERVE_NEW):
        lengths = (rng.choice(SERVE_LENGTHS, n) if lengths is None
                   else lengths)
        return [Request(prompt=rng.randint(1, cfg.vocab_size, int(L))
                        .astype(np.int32), max_new_tokens=new)
                for L in lengths]
    return requests


def serve_measured(eng, requests, before_run=lambda: None):
    """The serve measurement: a warm-up of two requests (the shortest
    and the longest length, 3 tokens each; cuBLAS handles and kernel
    libraries loaded, the decode graph captured), not counted; then
    SERVE_REQUESTS requests of seeded lengths submitted at once and
    drained, timed on the host clock with the device synchronised.
    ``before_run()`` runs just before the timed run. Returns (the
    requests, the engine's stats of the run with its ``wall_s`` and
    ``engine_steps``, what ``before_run`` returned)."""
    for r in requests(2, (SERVE_LENGTHS[0], SERVE_LENGTHS[-1]), 3):
        eng.submit(r)
    eng.run_until_drained()
    before = eng.stats()
    reqs = requests(SERVE_REQUESTS)
    hooked = before_run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    steps = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats()
    d = {k: st[k] - before[k] for k in ("prefill_dispatches", "decode_steps",
                                         "tokens_generated", "prefill_seconds",
                                         "decode_seconds")}
    d.update(wall_s=wall, engine_steps=steps)
    return reqs, d, hooked


SCOPED = {"phase_peak": 0}


def scope_peak():
    """Reset the card's peak so that it counts from here (a run inside a
    phase), keeping the phase's peak so far for :func:`phase_peak`."""
    SCOPED["phase_peak"] = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()


def phase_peak():
    """The phase's peak across a :func:`scope_peak` in it (a phase resets
    the card's peak at its start, before the scoped run)."""
    return max(SCOPED["phase_peak"], torch.cuda.max_memory_allocated())


def phase_serve(dev, _build, serving, cfg, dims, kernels, redraw=None,
                profile_rows=SERVE_SLOTS, moe_impl="dense", params=None,
                short=False, cut=None):
    """``cfg`` (a registered config, possibly cut in depth) at full width
    through the port's ServingEngine: ``dims`` ({config field: value})
    are checked; ``kernels`` = {"prefill": {kernel: mixer or a tuple of
    mixers}, "decode": {...}}: each kernel must launch once per layer of
    its mixers in every prefill dispatch and decode step of the counted
    run (and no other kernel of those lists). ``redraw`` (params, generator) may redraw
    leaves the init leaves constant. The standalone prefill profile
    takes ``profile_rows`` prompts of the longest length. ``moe_impl``
    is the engine's MoE implementation; ``params`` serves weights already
    drawn (by an earlier call) instead of drawing them. ``short`` leaves
    out the steady-decode and prefill profiles (the counted run and the
    decode graph against the eager step stay); ``cut`` describes a cut in
    depth, printed on the serve line."""
    models, eng_mod = serving["models"], serving["serving"]
    arch = cfg.name
    check(all(getattr(cfg, k) == v for k, v in dims.items()),
          f"{arch} is not at full width: want {dims}")
    mixers = [m for m, _ in cfg.layer_specs()]
    t0 = time.perf_counter()
    specs = models.model_specs(cfg)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        params = models.init_params(specs, gen, dev, torch.bfloat16)
        if redraw is not None:
            redraw(params, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = eng_mod.ServingEngine(cfg, params, batch_slots=SERVE_SLOTS,
                                max_len=SERVE_MAX_LEN, moe_impl=moe_impl,
                                device=dev)
    # the decode step, replayed from a CUDA graph after its first call
    graphed = eng._decode_sample
    check(isinstance(graphed, serving["graphs"].StepGraph),
          f"{arch}: the engine's decode step is not a graph")
    requests = serve_requests(eng_mod.Request, cfg, np.random.RandomState(0))
    names = sorted(set(kernels["prefill"]) | set(kernels["decode"]))

    def before_run():
        check(graphed.captures == 1, f"{arch}: {graphed.captures} decode "
              "graph captures in the warm-up, want 1")
        per = count_dispatches(eng, _build)
        _build.reset_launches()             # the counted main-path run
        return per

    torch.cuda.synchronize()
    scope_peak()                                # the serving run's peak
    allocated = torch.cuda.memory_allocated()
    reqs, d, per = serve_measured(eng, requests, before_run)
    serve_peak = torch.cuda.max_memory_allocated()
    wall, steps = d["wall_s"], d.pop("engine_steps")
    launches = dict(_build.LAUNCHES)
    per = {kind: list(v) for kind, v in per.items()}    # the counted run
    check(len({len(r.prompt) for r in reqs}) > 1, "one prompt length only")
    check(all(len(r.out_tokens) == SERVE_NEW for r in reqs),
          "a request did not get its 32 tokens")
    for kind, n in (("prefill", d["prefill_dispatches"]),
                    ("decode", d["decode_steps"])):
        check(len(per[kind]) == n, f"{n} {kind} dispatches, "
              f"{len(per[kind])} counted")
        want = {k: layers_of(mixers, kernels[kind][k])
                if k in kernels[kind] else 0 for k in names}
        for i, got in enumerate(per[kind]):
            check({k: got[k] for k in names} == want,
                  f"{kind} dispatch {i}: launches {got}, want {want}")
    for k in names:
        check(launches[k] == sum(p[k] for kind in per for p in per[kind]),
              f"{k}: launches outside the counted dispatches")
    # the prefill dispatches of the run: (rows, prompt length) per group
    groups = {}
    for r in reqs:
        key = (r.admitted_at, len(r.prompt))
        groups[key] = groups.get(key, 0) + 1
    check(len(groups) == d["prefill_dispatches"], "dispatch groups differ")
    ACCOUNTED.append({
        "cell": f"{arch} serve, {cfg.num_layers} layers, {moe_impl} MoE"
        if cfg.moe is not None else f"{arch} serve, {cfg.num_layers} layers",
        "kind": "serve", "cfg": cfg, "moe_impl": moe_impl,
        "prefill": max(((n, L) for (_, L), n in groups.items()),
                       key=lambda nl: nl[0] * nl[1]),
        "peak": serve_peak, "phase_peak": phase_peak(),
        "allocated_at_start": allocated,
        "live": {"params": live_bytes(params), "opt_state": 0,
                 "cache": live_bytes(eng.cache)}})
    lat = [r.done_at - r.submitted_at for r in reqs]
    ttft = [r.first_token_at - r.submitted_at for r in reqs]
    emit({"phase": "serve", "arch": cfg.name, "moe_impl": moe_impl,
          "layers": cfg.num_layers, "cut": cut,
          "params": models.param_count(specs), "init_s": init_s,
          "slots": SERVE_SLOTS,
          "max_len": SERVE_MAX_LEN, "requests": SERVE_REQUESTS,
          "new_tokens": SERVE_NEW,
          "prompt_lengths": [len(r.prompt) for r in reqs],
          "prefill_groups": sorted([n, L] for (_, L), n in groups.items()),
          "engine_steps": steps, "wall_s": wall,
          "tokens_per_s": d["tokens_generated"] / wall,
          "prefill_dispatches": d["prefill_dispatches"],
          "prefill_ms_per_dispatch": 1e3 * d["prefill_seconds"]
          / d["prefill_dispatches"],
          "decode_steps": d["decode_steps"],
          "decode_ms_per_step": 1e3 * d["decode_seconds"] / d["decode_steps"],
          "ttft_ms_p50": 1e3 * float(np.percentile(ttft, 50)),
          "latency_ms_p50": 1e3 * float(np.percentile(lat, 50)),
          "latency_ms_max": 1e3 * max(lat),
          "launches": {k: launches[k] for k in names},
          "launches_per_prefill_dispatch": {
              k: sum(p[k] for p in per["prefill"]) / d["prefill_dispatches"]
              for k in names},
          "launches_per_decode_step": {
              k: sum(p[k] for p in per["decode"]) / d["decode_steps"]
              for k in names},
          "peak_mem_gb": phase_peak() / 1e9,
          "serve_peak_gb": serve_peak / 1e9})
    if short:
        versus = decode_graph_vs_eager(
            eng, graphed, requests(SERVE_SLOTS,
                                   [len(r.prompt) for r in reqs[:8]],
                                   3 + DECODE_COMPARE_STEPS))
        check(graphed.captures == 1, f"{arch}: the decode step was "
              f"captured {graphed.captures} times")
        emit({"phase": "serve", "arch": cfg.name, "moe_impl": moe_impl,
              "decode_graph_captures": graphed.captures,
              "decode_capture_ms": 1e3 * graphed.capture_seconds,
              "decode_graph_vs_eager": versus,
              "peak_mem_gb": phase_peak() / 1e9})
        del eng
        torch.cuda.empty_cache()
        return cfg, launches, d, groups, per, params, reqs

    # decode in steady state: 8 slots at the run's prompt lengths
    for r in requests(SERVE_SLOTS, [len(r.prompt) for r in reqs[:8]],
                      2 + 2 * DECODE_PROFILE_STEPS):
        eng.submit(r)
    eng.step()                                   # admission + one decode
    t0 = time.perf_counter()
    for _ in range(DECODE_PROFILE_STEPS):
        eng.step()
    step_ms = 1e3 * (time.perf_counter() - t0) / DECODE_PROFILE_STEPS

    def decode_steps():
        for _ in range(DECODE_PROFILE_STEPS):
            eng.step()
    tag = ("" if arch == "granite-3-2b" else "_" + arch.split("-")[0]
           if arch.startswith(("rwkv", "jamba")) else "_" + arch)
    tag += "" if moe_impl == "dense" else "_" + moe_impl
    prof = device_profile(decode_steps, os.path.join(
        OUT_DIR, f"profile_serve{tag}_decode.txt"))
    eng.run_until_drained()
    busy = (None if prof["busy_ms"] is None
            else prof["busy_ms"] / DECODE_PROFILE_STEPS)
    versus = decode_graph_vs_eager(
        eng, graphed, requests(SERVE_SLOTS, [len(r.prompt) for r in reqs[:8]],
                               3 + DECODE_COMPARE_STEPS))
    check(graphed.captures == 1, f"{arch}: the decode step was captured "
          f"{graphed.captures} times")
    # one prefill dispatch alone: profile_rows prompts of the longest
    # length, one token each (they complete at admission, so no decode
    # step runs)
    for r in requests(profile_rows, [SERVE_LENGTHS[-1]] * profile_rows, 1):
        eng.submit(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pprof = device_profile(eng.step, os.path.join(
        OUT_DIR, f"profile_serve{tag}_prefill.txt"))
    prefill_peak = torch.cuda.max_memory_allocated() / 1e9
    emit({"phase": "serve", "arch": cfg.name, "moe_impl": moe_impl,
          "decode_ms_per_step_steady": step_ms,
          "decode_device_busy_ms_per_step": busy,
          "decode_device_idle_share": None if busy is None
          else 1 - busy / step_ms,
          "decode_device_ops_per_step": prof["device_ops"]
          / DECODE_PROFILE_STEPS,
          "decode_top_device_ms": [[round(t / DECODE_PROFILE_STEPS, 4), k,
                                    c] for t, k, c in prof["top"]],
          "decode_kernel_device_ms_per_step": {
              n: ms / DECODE_PROFILE_STEPS
              for n, ms in kernel_ms(prof, names).items()},
          "decode_host_calls_per_step": {
              k: v / DECODE_PROFILE_STEPS
              for k, v in sorted(prof["host_calls"].items())},
          "decode_graph_captures": graphed.captures,
          "decode_capture_ms": 1e3 * graphed.capture_seconds,
          "decode_graph_vs_eager": versus,
          "prefill_profiled": [profile_rows, SERVE_LENGTHS[-1]],
          "prefill_device_busy_ms": pprof["busy_ms"],
          "prefill_kernel_device_ms": kernel_ms(pprof, names),
          "prefill_profile_peak_mem_gb": prefill_peak,
          "prefill_top_device_ms": [[round(t, 4), k, c]
                                    for t, k, c in pprof["top"]]})

    eng.run_until_drained()
    del eng
    torch.cuda.empty_cache()
    return cfg, launches, d, groups, per, params, reqs


# ---------------------------------------------------------------------------
# ST-routed decode: the serve pattern through the ST, host and fused
# executors beside the decode step
# ---------------------------------------------------------------------------

ST_RANKS = 4                    # virtual ranks of the decode collective
ST_TUNED = os.path.join(OUT_DIR, "tuned_torch_smoke.json")


def phase_router(dev, serving):
    """The router alone on the card at ST_RANKS ranks with MoE dispatch,
    at granite's and jamba's payload widths (kv_dim, d_model), 8 slots:
    the committed ids and KV rows equal the staged payload, and the
    combined hidden block the host's float32 sum in the reference's order
    (h = hid; h = h + recvh_k for k = 1..R-1), bit for bit."""
    from repro_torch.core.autotune import ScheduleConfig
    gen = torch.Generator(device=dev).manual_seed(7)
    out = {}
    for arch, kv_dim, d_model in (("granite-3-2b", 512, 2048),
                                  ("jamba-1.5-large-398b", 1024, 8192)):
        for mode in MODES:
            router = serving["serving"].STDecodeRouter(
                kv_dim=kv_dim, d_model=d_model, moe=True,
                slot_cap=SERVE_SLOTS, mode=mode, config=ScheduleConfig(),
                ndev=ST_RANKS, device=dev)
            for A in (SERVE_SLOTS, 5):
                kv = torch.randn(A, kv_dim, generator=gen, device=dev)
                ids = torch.randint(0, 1 << 20, (A,), generator=gen,
                                    device=dev, dtype=torch.int32)
                hid = torch.randn(A, d_model, generator=gen, device=dev
                                  ).bfloat16()
                tok, mirror, hmir = router.dispatch(kv, ids, hid=hid)
                want = hid.float().cpu().numpy()
                h = want.copy()
                for _ in range(1, ST_RANKS):
                    h = h + want
                check(np.array_equal(tok, ids.cpu().numpy())
                      and np.array_equal(mirror, kv.cpu().numpy())
                      and np.array_equal(hmir, h),
                      f"router at {arch}'s widths, {mode}, A={A}: the "
                      "committed buffers differ from the staged payload")
            out[f"{arch}:{mode}"] = "equal"
            del router
    emit({"phase": "st_router", "ranks": ST_RANKS, "slots": SERVE_SLOTS,
          "payloads": {"granite-3-2b": [512, 2048],
                       "jamba-1.5-large-398b": [1024, 8192]},
          "committed_vs_staged": out})


def phase_st_serve(dev, _build, serving, cfg, params, reqs, kernels, modes):
    """ST-routed decode on ``cfg`` at full width, the weights and the 16
    requests of its ``phase_serve``: a baseline engine and one engine per
    mode of ``modes`` (st_config "auto", tuned afresh into ST_TUNED, at
    ST_RANKS ranks), each warmed up through every slot bucket (8 one-
    length requests finishing one after another), then the counted run
    (the 16 requests; launches zeroed before, read after), then 8 steady
    decode steps timed and 8 profiled. Every mode's served tokens must
    equal the baseline's bit for bit; every put of the serve program is
    one put_signal launch, every post signal one counter_bump (host mode:
    plus one a put), and the model's kernels launch as in phase_serve.
    Returns {mode: put_signal and counter_bump launches per decode
    step}."""
    models, eng_mod = serving["models"], serving["serving"]
    Request = eng_mod.Request
    mixers = [m for m, _ in cfg.layer_specs()]
    if os.path.exists(ST_TUNED):
        os.remove(ST_TUNED)
    rng = np.random.RandomState(11)
    lengths = [len(r.prompt) for r in reqs]
    base_tokens = None
    per_step, lines = {}, []
    for mode in (None,) + tuple(modes):
        eng = eng_mod.ServingEngine(
            cfg, params, batch_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
            st_mode=mode, st_config="auto", tuned_path=ST_TUNED,
            st_ranks=ST_RANKS, device=dev)
        tune = {}
        if mode is not None:
            router = eng._router
            resolve = router._resolve

            def timed(bucket, resolve=resolve):
                t0 = time.perf_counter()
                spec = resolve(bucket)
                tune[bucket] = time.perf_counter() - t0
                return spec
            router._resolve = timed
        # warm-up: every bucket's program captured, the decode step too
        for k in range(SERVE_SLOTS):
            eng.submit(Request(prompt=rng.randint(
                1, cfg.vocab_size, SERVE_LENGTHS[0]).astype(np.int32),
                max_new_tokens=2 + k))
        eng.run_until_drained()
        before = eng.stats()
        run = [Request(prompt=r.prompt, max_new_tokens=SERVE_NEW)
               for r in reqs]
        torch.cuda.synchronize()
        _build.reset_launches()                 # the counted main-path run
        t0 = time.perf_counter()
        for r in run:
            eng.submit(r)
        eng.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        st = eng.stats()
        d = {k: st[k] - before[k] for k in (
            "prefill_dispatches", "decode_steps", "tokens_generated",
            "decode_seconds")}
        tokens = [r.out_tokens for r in run]
        if mode is None:
            base_tokens = tokens
        check(tokens == base_tokens, f"{cfg.name}: st_mode={mode} served "
              "other tokens than the baseline engine")
        steps, pre = d["decode_steps"], d["prefill_dispatches"]
        for kind, want_per in (("prefill", pre), ("decode", steps)):
            for k, mixer in kernels[kind].items():
                want = mixers.count(mixer) * (
                    pre + steps if k in kernels["prefill"]
                    and k in kernels["decode"] else want_per)
                check(launches[k] == want, f"{cfg.name} st_mode={mode}: "
                      f"{launches[k]} {k} launches, want {want}")
        line = {"phase": "st_serve", "arch": cfg.name, "st_mode": mode,
                "ranks": ST_RANKS, "requests": len(run),
                "tokens_equal_baseline": True,
                "tokens_equal_serve_phase": tokens == [
                    r.out_tokens for r in reqs],
                "prompt_lengths": lengths, "engine_wall_s": wall,
                "tokens_per_s": d["tokens_generated"] / wall,
                "decode_steps": steps,
                "decode_ms_per_step": 1e3 * d["decode_seconds"] / steps}
        if mode is not None:
            rst = st["st"]
            puts = 2 + (ST_RANKS - 1 if rst["moe"] else 0)
            want = {"put_signal": puts,
                    "counter_bump": 1 + (puts if mode == "host" else 0)}
            for k, n in want.items():
                check(launches[k] == n * steps, f"{cfg.name} {mode}: "
                      f"{launches[k]} {k} launches over {steps} decode "
                      f"steps, want {n} a step")
            per_step[mode] = {k: launches[k] / steps for k in want}
            entries = eng._router._entries
            graphs_per = {}
            for b, e in entries.items():
                cache = {"st": e.stream._compiled_cache,
                         "fused": e.stream._fused_cache}.get(mode)
                graphs_per[b] = (0 if cache is None else
                                 sum(len(g.chain) for g in cache.values()))
            line.update({
                "st_dispatch_ms_per_step": 1e3 * (
                    st["st_dispatch_seconds"]
                    - before["st_dispatch_seconds"]) / steps,
                "moe_dispatch": rst["moe"],
                "launches_per_decode_step": per_step[mode],
                "buckets": {b: {"config": m["config"],
                                "dispatches": m["dispatches"],
                                "descriptors": m["descriptors"],
                                "puts": m["puts"],
                                "segments": m.get("segments"),
                                "program_graphs": graphs_per[b],
                                "tune_s": tune.get(b)}
                            for b, m in rst["buckets"].items()},
                "tune_s": sum(tune.values())})
        # steady decode: 8 slots at the run's first 8 lengths
        for L in lengths[:SERVE_SLOTS]:
            eng.submit(Request(prompt=rng.randint(1, cfg.vocab_size, L)
                               .astype(np.int32),
                               max_new_tokens=3 + 2 * DECODE_PROFILE_STEPS))
        eng.step()                              # admission + one decode
        s0 = eng.stats()
        t0 = time.perf_counter()
        for _ in range(DECODE_PROFILE_STEPS):
            eng.step()
        step_ms = 1e3 * (time.perf_counter() - t0) / DECODE_PROFILE_STEPS
        s1 = eng.stats()

        def decode_steps():
            for _ in range(DECODE_PROFILE_STEPS):
                eng.step()
        tag = cfg.name.split("-")[0]
        prof = device_profile(decode_steps, os.path.join(
            OUT_DIR, f"profile_st_serve_{tag}_{mode or 'baseline'}.txt"))
        check(len(eng._active()) == SERVE_SLOTS, "a steady slot went idle")
        eng.run_until_drained()
        busy = (None if prof["busy_ms"] is None
                else prof["busy_ms"] / DECODE_PROFILE_STEPS)
        line.update({
            "decode_ms_per_step_steady": step_ms,
            "decode_device_busy_ms_per_step": busy,
            "decode_device_idle_share": None if busy is None
            else 1 - busy / step_ms,
            "decode_device_ops_per_step": prof["device_ops"]
            / DECODE_PROFILE_STEPS,
            "decode_host_calls_per_step": {
                k: v / DECODE_PROFILE_STEPS
                for k, v in sorted(prof["host_calls"].items())}})
        if mode is not None:
            line["st_dispatch_ms_per_step_steady"] = 1e3 * (
                s1["st_dispatch_seconds"] - s0["st_dispatch_seconds"]
            ) / DECODE_PROFILE_STEPS
        emit(line)
        lines.append(line)
        if mode == "st" and cfg.name == "granite-3-2b":
            phase_traffic(eng)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return per_step


def phase_traffic(eng):
    """One short Poisson run over ``eng`` (granite's ST engine): 16
    requests at 20 requests/s, prompts of 128 to 1000 tokens, 8 to 32 new
    tokens (uniform), seed 0."""
    from repro_torch.launch.traffic import TrafficConfig, run_traffic
    tcfg = TrafficConfig(requests=16, rate=20.0, replicas=1,
                         batch_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                         prompt_len=(SERVE_LENGTHS[0], SERVE_LENGTHS[-1]),
                         max_new=(8, SERVE_NEW), seed=0,
                         arch=eng.cfg.name, st_mode=eng.st_mode,
                         st_ranks=ST_RANKS)
    s = run_traffic(tcfg, engines=[eng])
    check(s["queue_drained"] and s["completed"] == tcfg.requests,
          "the traffic run did not drain")
    emit({"phase": "st_traffic", "arch": eng.cfg.name,
          "st_mode": eng.st_mode, "requests": s["requests"],
          "rate_per_s": tcfg.rate, "slots": SERVE_SLOTS,
          "wall_s": s["wall_s"], "tokens": s["tokens"],
          "tokens_per_s": s["tokens_per_s"],
          "latency_p50_ms": s["latency_p50_ms"],
          "latency_p99_ms": s["latency_p99_ms"],
          "ttft_p50_ms": s["ttft_p50_ms"], "ttft_p99_ms": s["ttft_p99_ms"]})


def wkv6_reordered(r, k, v, logw, u, s0):
    """The plain WKV6 version with the kernel's order of the sums
    (y_t = r_t S + (sum_i r_t u k_t) v_t; S = w_t S + k_t^T v_t), in
    PyTorch: a second float32 evaluation of the same function. How far
    it moves the model from the plain version is the float32 spread of
    the model itself (see RWKV_F32 below)."""
    r, k, v, logw = (a.float() for a in (r, k, v, logw))
    w, s, ys = torch.exp(logw), s0.float(), []
    for t in range(r.shape[1]):
        bonus = (r[:, t] * u[None] * k[:, t]).sum(-1, keepdim=True)
        ys.append(torch.einsum("bhc,bhcv->bhv", r[:, t], s)
                  + bonus * v[:, t])
        s = w[:, t, :, :, None] * s + k[:, t, :, :, None] \
            * v[:, t, :, None, :]
    return torch.stack(ys, dim=1), s


def shadowed(kernel, ref, seen):
    """``kernel`` (a wrapper whose last argument is the state, written
    over when ``inplace``) that also runs ``ref`` on the same inputs (the
    state copied before the kernel writes it in place), counts its calls
    in ``seen["calls"]`` and keeps in ``seen["y"]`` and ``seen["state"]``
    the largest errors of y and the final state relative to max(1, their
    largest |value|)."""
    def call(*args, inplace=False):
        seen["calls"] += 1
        s_in = args[-1].clone()
        y, sT = kernel(*args, inplace=inplace)
        ey, es = scan_errs(y, sT, *ref(*args[:-1], s_in))
        seen["y"], seen["state"] = max(seen["y"], ey), max(seen["state"], es)
        seen["y_dtype"] = str(y.dtype)
        return y, sT
    return call


def phase_replay(dev, serving, cfg, params, reqs, shadow=None,
                 spread=None, f32=True, served=True, moe_impl="gshard",
                 max_rows=None):
    """The served tokens replayed teacher-forced through the kernel path
    and the plain path on the card (run after the arch's measurements),
    in bf16 and in float32 (the same weights, upcast, with a float32
    cache). The float32 plain path is the yardstick of the bf16 paths'
    rounding: the bf16 kernel path must stay as close to it as the bf16
    plain path does.

    ``shadow`` = (module, wrapper name, kernel wrapper, plain version,
    mixer): every launch of that kernel in the kernel-path replays is
    held to the plain version on its own inputs (SCAN_RTOL for the state
    and a float32 y, SCAN_RTOL_BF16 for a bf16 y) and counted (one per
    layer of ``mixer`` per length group's prefill and per decode step).
    ``spread`` = (module, plain name, reordered plain version, {name:
    plain version in another order}) changes the float32 checks
    (RWKV_F32): the float32 logits bound and the float32 id check's
    margin come from the float32 spread of the model (the plain path
    against itself with the kernel's order of sums), and the served ids
    are compared where the float32 margin exceeds twice the bf16 plain
    path's distance at that step. The bf16 plain path is also replayed
    with each of the other orders, and its largest logit distance from
    the plain path is reported (``bf16_spread``, no check): how far a
    kernel summing in that order would stand from the bf16 gate. ``f32=False`` skips
    every float32 replay (a model whose float32 copy does not fit the
    card; the checks that need it are reported as not run).
    ``served=False``: ``reqs``' tokens come from another model (a cut of
    this one), so the kernel path's own greedy ids stand in for the
    served ids and the served-ids check does not run. ``moe_impl``: the
    MoE layers' implementation in every replay (the model's default,
    gshard, unless given); ``max_rows``: the most prompts a replay's
    prefill dispatch takes (:func:`replay_logits`)."""
    from unittest import mock
    tree_map = serving["models"].params.tree_map
    plain = dict(attn_impl="plain")
    V = cfg.vocab_size
    replays = []          # the shadowed launches of each kernel-path replay
    want_calls = None
    if shadow:
        # one per layer of the mixer in each length group's prefill and
        # each decode step
        want_calls = sum(m == shadow[4] for m, _ in cfg.layer_specs()) * (
            len({len(r.prompt) for r in reqs}) + len(reqs[0].out_tokens)
            - 1)

    def kernel_replay(c, p):
        if not shadow:
            return replay_logits(serving, c, p, dev, reqs,
                                 moe_impl, max_rows)[..., :V]
        seen = {"calls": 0, "y": 0.0, "state": 0.0}
        with mock.patch.object(shadow[0], shadow[1],
                               shadowed(shadow[2], shadow[3], seen)):
            out = replay_logits(serving, c, p, dev, reqs,
                                moe_impl, max_rows)[..., :V]
        replays.append(seen)
        return out
    lk = kernel_replay(cfg, params)
    lp = replay_logits(serving, dataclasses.replace(cfg, **plain), params,
                       dev, reqs, moe_impl, max_rows)[..., :V]
    bf16_spread = {}
    for name, order in (spread[3].items() if spread else ()):
        with mock.patch.object(spread[0], spread[1], order):
            lr = replay_logits(serving, dataclasses.replace(cfg, **plain),
                               params, dev, reqs, moe_impl, max_rows)[..., :V]
        bf16_spread[name] = (lr - lp).abs().max().item()
        del lr
    spread32, atol32 = None, LOGITS_ATOL_F32
    lk32 = lp32 = None
    if f32:
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        p32 = tree_map(lambda t: t.float(), params)
        lk32 = kernel_replay(cfg32, p32)
        cfg32p = dataclasses.replace(cfg32, **plain)
        lp32 = replay_logits(serving, cfg32p, p32, dev, reqs,
                             moe_impl, max_rows)[..., :V]
        if spread:
            with mock.patch.object(spread[0], spread[1], spread[2]):
                lr32 = replay_logits(serving, cfg32p, p32, dev,
                                     reqs, moe_impl, max_rows)[..., :V]
            spread32 = (lr32 - lp32).abs().max().item()
            atol32 = RWKV_F32_SPREAD * spread32
            del lr32
        del p32
    check(all(bool(torch.isfinite(t).all()) for t in (lk, lp, lk32, lp32)
              if t is not None), "non-finite logits")
    err = (lk - lp).abs().amax(dim=-1)                 # (R, T)

    def decided(logits, tol):
        top2 = logits.topk(2, dim=-1).values
        return (top2[..., 0] - top2[..., 1] > 2 * tol).cpu().numpy()
    served_ids = np.asarray([r.out_tokens for r in reqs])
    ref_ids = served_ids if served else lk.argmax(dim=-1).cpu().numpy()
    plain_ids = lp.argmax(dim=-1).cpu().numpy()
    dec = decided(lp, LOGITS_ATOL)
    mismatched = int(((plain_ids != ref_ids) & dec).sum())
    out = {"phase": "serve", "arch": cfg.name, "replay": "teacher-forced",
           "layers": cfg.num_layers,
           "experts": any(f == "moe" for _, f in cfg.layer_specs()),
           "requests": len(reqs), "steps": served_ids.shape[1],
           "logits_max_abs_err": err.max().item(),
           "logits_err_p50": err.median().item(),
           "logits_abs_max": lp.abs().max().item(),
           "logits_std": lp.std().item(), "logits_atol": LOGITS_ATOL,
           "bf16_spread": bf16_spread or None,
           "ids_against": "served" if served else "bf16 kernel path",
           "ids_compared": int(dec.sum()), "ids_total": dec.size,
           "ids_mismatched": mismatched,
           "ids_equal_all": int((plain_ids == ref_ids).sum())}
    if shadow:
        out.update({
            f"{shadow[1]}_launch_max_rel_err": max(
                max(r["y"], r["state"]) for r in replays),
            f"{shadow[1]}_launch_max_rel_err_by_replay": [
                {k: r[k] for k in ("y", "state", "y_dtype")}
                for r in replays],
            f"{shadow[1]}_launches_per_replay": [r["calls"]
                                                 for r in replays],
            f"{shadow[1]}_launches_per_replay_expected": want_calls})
    if f32:
        err32 = (lk32 - lp32).abs().max().item()
        # per request: RMS distance from the float32 plain path
        dist_k = (lk - lp32).square().mean(dim=(1, 2)).sqrt()
        dist_p = (lp - lp32).square().mean(dim=(1, 2)).sqrt()
        ratio = (dist_k / dist_p).cpu().numpy()
        moved = (lp - lp32).abs().amax(dim=-1)         # (R, T)
        bf16_moved = moved.max().item()
        ids32 = lp32.argmax(dim=-1).cpu().numpy()
        tol32 = LOGITS_ATOL_F32 if not spread else max(LOGITS_ATOL_F32,
                                                       spread32)
        dec32 = decided(lp32, tol32)
        mismatched32 = int(((lk32.argmax(dim=-1).cpu().numpy() != ids32)
                            & dec32).sum())
        out.update({
            "f32_logits_max_abs_err": err32, "f32_logits_atol": atol32,
            "f32_spread_reordered_plain": spread32,
            "f32_ids_margin": 2 * tol32,
            "f32_ids_compared": int(dec32.sum()),
            "f32_ids_mismatched": mismatched32,
            "bf16_kernel_vs_f32_rms": dist_k.tolist(),
            "bf16_plain_vs_f32_rms": dist_p.tolist(),
            "rms_ratio_max": float(ratio.max()),
            "rms_ratio_limit": REPLAY_DIST_RATIO,
            "bf16_kernel_vs_f32_max": (lk - lp32).abs().max().item(),
            "bf16_plain_vs_f32_max": bf16_moved})
        if served:
            # the served (bf16 kernel) ids against the float32 plain
            # path's, where its margin exceeds twice what bf16 rounding
            # moved the plain path (over the run; with a spread, at that
            # step)
            dec16 = decided(lp32, moved if spread else bf16_moved)
            mismatched16 = int(((served_ids != ids32) & dec16).sum())
            out.update({"served_vs_f32_ids_compared": int(dec16.sum()),
                        "served_vs_f32_ids_mismatched": mismatched16})
    else:
        out["f32_not_run"] = ("the float32 copy of the served weights does "
                              "not fit the card")
    emit(out)
    check(err.max().item() <= LOGITS_ATOL,
          f"kernel path logits differ from the plain path by "
          f"{err.max().item()} > {LOGITS_ATOL} (bf16)")
    if shadow:
        check([r["calls"] for r in replays] == [want_calls] * len(replays),
              f"{shadow[1]} launches of the kernel-path replays "
              f"{[r['calls'] for r in replays]}, expected {want_calls} each")
        for r in replays:
            lim = (SCAN_RTOL if r["y_dtype"] == str(torch.float32)
                   else SCAN_RTOL_BF16)
            check(r["y"] <= lim and r["state"] <= SCAN_RTOL,
                  f"a {shadow[1]} launch of the replay differs from the "
                  f"plain version on its inputs by {r['y']} (y, {r['y_dtype']}"
                  f") / {r['state']} (state), relative, > {lim} / "
                  f"{SCAN_RTOL}")
    check(mismatched == 0, f"{mismatched} greedy ids differ from the plain "
          "path where its top-2 margin exceeds twice the tolerance")
    if not f32:
        return
    check(err32 <= atol32,
          f"kernel path logits differ from the plain path by {err32} > "
          f"{atol32} (float32)")
    check(bool((ratio <= REPLAY_DIST_RATIO).all()),
          f"bf16 kernel path farther from the float32 plain path than "
          f"{REPLAY_DIST_RATIO}x the bf16 plain path: ratios {ratio}")
    check(mismatched32 == 0, f"{mismatched32} float32 greedy ids differ "
          "from the plain path where its top-2 margin exceeds twice the "
          "tolerance")
    if served:
        check(dec16.sum() > 0 and mismatched16 == 0,
              f"{mismatched16} of {int(dec16.sum())} served ids differ "
              "from the float32 plain path where its margin exceeds twice "
              "the bf16 plain path's largest distance from it")


def phase_replay_cut(dev, serving, cut, label, reqs, shadow=None,
                     redraw=None, max_rows=None, seed=1):
    """The float32 checks a served model's weights cannot have (their
    float32 copy does not fit beside them): ``phase_replay`` in bf16 and
    float32 on ``cut``, a cut of the served config at full width
    (``label`` says which), with its own seeded weights (``redraw``
    applied), over the served token sequences. Jamba's is its no-expert
    cut, (attn, dense), (mamba, dense), (mamba, dense) (3.88 B params,
    15.5 GB in float32, mamba leaves redrawn); deepseek-v2's its first
    layer, (mla, dense) (1.39 B, 5.5 GB in float32), which holds the
    float32 flash kernel at (192, 128) inside the model."""
    models = serving["models"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    specs = models.model_specs(cut)
    params = models.init_params(specs, gen, dev, torch.bfloat16)
    if redraw is not None:
        redraw(params, gen)
    emit({"phase": "serve", "arch": cut.name, "cut": label,
          "layers": [list(sp) for sp in cut.layer_specs()],
          "params": models.param_count(specs)})
    phase_replay(dev, serving, cut, params, reqs, shadow=shadow,
                 served=False, max_rows=max_rows)


def flash_bound(B, Sq, H, KV, hd, hdv, kvl, nbytes_el, causal=True):
    """(bytes, flops) a prefill needs: q (hd wide) read, out (hdv)
    written, the valid K (hd) and V (hdv) rows read once; two products
    over each query's valid keys (causal: those up to its position; not
    causal: all of them), 2 hd and 2 hdv flops a key."""
    keys = (sum(min(L, i + 1) for L in kvl for i in range(Sq)) if causal
            else Sq * sum(kvl))
    flops = H * keys * 2 * (hd + hdv)
    nbytes = nbytes_el * (B * Sq * H * (hd + hdv)
                          + sum(kvl) * KV * (hd + hdv))
    return nbytes, flops


def kernel_us(fn, n=20):
    """Device µs per call of each kernel ``fn`` launches, by kernel name
    (torch.profiler over ``n`` calls after one warm-up)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            name = re.search(r"(\w+)(<|\()", e.key)
            out[name.group(1) if name else e.key] = (
                e.self_device_time_total / n)
    return out


def bound_ms(nbytes, flops):
    """(least time in ms, "bytes" or "operations"): the bytes over the HBM
    rate against the flops at the bf16 tensor-core rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / BF16_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_flops),
            "bytes" if t_bytes >= t_flops else "operations")


def flash_case(dev, fa, fa_ref, n, L, H, KV, hd, seed, hdv=None):
    """A causal prefill of n prompts of L tokens into a max_len cache, as
    the engine's length group runs it: (kernel call, plain call, library
    call, the library's description, (bytes, flops)). The library is
    SDPA on the backend that takes the shapes first, of flash, memory-
    efficient, cuDNN and math (the flash backend may refuse hd != hdv),
    named in the description."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    hdv = hdv or hd
    q, k, v = attn_inputs(dev, torch.bfloat16, n, L, SERVE_MAX_LEN, H, KV,
                          hd, seed, hdv)
    pos = torch.arange(L, device=dev, dtype=torch.int32).expand(n, L)
    kvl = torch.full((n,), L, device=dev, dtype=torch.int32)
    # the library computes the same function on the valid keys alone:
    # keys past kv_valid_len = L get weight 0, so a causal SDPA over the
    # cache's first L rows is exact (and may take its flash backend)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k[:, :L], v[:, :L]))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    def on(backend):
        def call():
            with sdpa_kernel([backend]):
                return sdpa()
        return call
    names = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
             "MATH")
    refused = []
    for name in names:                      # the fastest backend that runs
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        try:
            on(backend)()
            lib = on(backend)
            break
        except RuntimeError:
            refused.append(name.lower())
    else:
        fail(f"no SDPA backend takes {(n, L, H, KV, hd, hdv)}")
    torch.cuda.synchronize()
    note = f", refused by {', '.join(refused)}" if refused else ""
    return (lambda: fa(q, k, v, q_positions=pos, kv_valid_len=kvl),
            lambda: fa_ref(q, k, v, q_offset=pos[:, 0], kv_valid_len=kvl),
            lambda: lib().transpose(1, 2),
            f"causal, first kv_valid_len keys, enable_gqa, "
            f"{name.lower()} backend{note}",
            flash_bound(n, L, H, KV, hd, hdv, [L] * n, 2))


def decode_case(dev, da, da_ref, B, H, KV, hd, positions, seed):
    """B slots decoding at ``positions`` over a max_len cache: (kernel
    call, plain call, library call, the library's description, (bytes,
    flops))."""
    import torch.nn.functional as F
    q, k, v = attn_inputs(dev, torch.bfloat16, B, 1, SERVE_MAX_LEN, H, KV,
                          hd, seed)
    pos = torch.tensor(positions, device=dev, dtype=torch.int32)[:, None]
    kvl = pos[:, 0] + 1
    # valid lengths differ per row: a boolean mask over the longest one
    smax = max(positions) + 1
    mask = (torch.arange(smax, device=dev)[None, :]
            < kvl[:, None])[:, None, None, :]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k[:, :smax], v[:, :smax]))
    valid = sum(positions) + len(positions)
    return (lambda: da(q, k, v, q_positions=pos, kv_valid_len=kvl),
            lambda: da_ref(q, k, v, q_positions=pos, kv_valid_len=kvl),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True).transpose(1, 2),
            "bool mask over the longest valid length, enable_gqa",
            (2 * (2 * B * H * hd + valid * KV * 2 * hd),
             valid * H * 2 * (hd + hd)))


def attn_row(name, line, case, launches, per, shape, errs):
    """One attention kernel's kernels-line row from a case of
    :func:`flash_case` or :func:`decode_case`: ``name`` is the row's (the
    kernel's, or the kernel's at a shape of its own), ``line`` the TPU
    kernel's line in ``src/repro/kernels/<kernel>/kernel.py``,
    ``launches`` the counted run's launches of the kernel."""
    kernel = name.split("_")[0] + "_attention"
    kern, plain, lib, lib_name, (nbytes, flops) = case
    b_ms, b_by = bound_ms(nbytes, flops)
    return {
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/csrc/{kernel}.cu",
        "replaces": f"src/repro/kernels/{kernel}/kernel.py:{line}",
        "launches": launches, "launches_per": per,
        "shape": dict(shape, dtype="bfloat16"),
        "max_abs_err": max(errs[name].values()),
        "max_abs_err_by_dtype": errs[name],
        "ms": graph_ms(kern, inner=5), "plain_ms": graph_ms(plain, inner=5),
        "bound_ms": b_ms, "bound_by": b_by,
        "bytes": nbytes, "flops": flops,
        "library_ms": graph_ms(lib, inner=5),
        "library": "torch.nn.functional.scaled_dot_product_attention "
                   f"({lib_name})",
        "library_max_abs_err": (kern().float() - lib().float()
                                ).abs().max().item(),
        "call_ms": event_ms(kern, inner=5),
        "device_us_by_kernel": kernel_us(kern)}


def attention_rows(dev, fa, fa_ref, da, da_ref, cfg, launches, d, groups,
                   errs):
    """The two attention kernels' kernels-line rows, at the serving
    shapes: the run's largest prefill dispatch, and 8 slots decoding;
    each with ``at_jamba``, the kernel, SDPA and the bound at jamba's
    attention shapes (64 heads, 8 KV heads of 128: 4 x 1000 prefill, 8
    slots decoding), and ``at_musicgen``, the same at musicgen-large's
    (MHA, 32 heads of 64)."""
    from repro_torch.kernels import _attn
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    B, S, positions = SERVE_SLOTS, SERVE_MAX_LEN, DECODE_CASES[0][5]
    (n, L) = max(((n, L) for (_, L), n in groups.items()),
                 key=lambda t: t[0] * t[1] * t[1])
    nsplit = _attn.decode_splits(S, B, KV, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    Lj = SERVE_LENGTHS[-1]
    rows = []
    heads = {"at_jamba": (64, 8, 128), "at_musicgen": (32, 32, 64)}
    for name, line, case, other, per, shape, oshape in (
            ("flash_attention", 73,
             flash_case(dev, fa, fa_ref, n, L, H, KV, hd, 99),
             lambda h, seed: flash_case(dev, fa, fa_ref, JAMBA_PROFILE_ROWS,
                                        Lj, *h, seed),
             {"per_prefill_dispatch": launches["flash_attention"]
              / d["prefill_dispatches"]},
             {"B": n, "Sq": L, "Skv": S, "kv_valid_len": L},
             {"B": JAMBA_PROFILE_ROWS, "Sq": Lj, "Skv": S,
              "kv_valid_len": Lj}),
            ("decode_attention", 61,
             decode_case(dev, da, da_ref, B, H, KV, hd, positions, 98),
             lambda h, seed: decode_case(dev, da, da_ref, B, *h, positions,
                                         seed),
             {"per_decode_step": launches["decode_attention"]
              / d["decode_steps"]},
             {"B": B, "S": S, "positions": list(positions),
              "splits": nsplit, "split_pass_blocks": nsplit * KV * B},
             {"B": B, "S": S, "positions": list(positions)})):
        row = attn_row(name, line, case, launches[name], per,
                       dict(shape, H=H, KV=KV, hd=hd), errs)
        for seed, (key, h) in enumerate(heads.items(), start=96):
            ok, _, olib, _, obound = other(h, seed)
            ob_ms, ob_by = bound_ms(*obound)
            row[key] = {
                "shape": dict(oshape, H=h[0], KV=h[1], hd=h[2],
                              dtype="bfloat16"),
                "ms": graph_ms(ok, inner=5),
                "library_ms": graph_ms(olib, inner=5),
                "library_max_abs_err": (ok().float() - olib().float()
                                        ).abs().max().item(),
                "bound_ms": ob_ms, "bound_by": ob_by}
        rows.append(row)
    return rows


def mla_flash_row(dev, fa, fa_ref, cfg, launches, d, errs):
    """flash attention's kernels-line row at (hd, hdv) = (192, 128):
    deepseek-v2's profiled prefill dispatch (JAMBA_PROFILE_ROWS prompts
    of 1000 tokens, 128 heads on 128 expanded KV heads, a 4096-row
    cache), with the launches of deepseek-v2's counted serving run."""
    m, H = cfg.mla, cfg.num_heads
    hd, hdv = m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim
    check((hd, hdv) == MLA_HEAD_DIMS, f"MLA head dims {(hd, hdv)}")
    n, L = JAMBA_PROFILE_ROWS, SERVE_LENGTHS[-1]
    return attn_row(
        "flash_attention_192x128", 73,
        flash_case(dev, fa, fa_ref, n, L, H, H, hd, 95, hdv),
        launches["flash_attention"],
        {"per_prefill_dispatch": launches["flash_attention"]
         / d["prefill_dispatches"], "arch": cfg.name},
        {"B": n, "Sq": L, "Skv": SERVE_MAX_LEN, "kv_valid_len": L, "H": H,
         "KV": H, "hd": hd, "hdv": hdv}, errs)


def mqa_decode_row(dev, da, da_ref, cfg, launches, d, errs):
    """flash-decode's kernels-line row at G = 48: granite-34b's 8 slots
    decoding (48 query heads on one KV head of 128), with the launches of
    granite-34b's counted serving run."""
    from repro_torch.kernels import _attn
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    check(H // KV == MQA_GROUP, f"{cfg.name}: G = {H // KV}")
    B, S, positions = SERVE_SLOTS, SERVE_MAX_LEN, DECODE_CASES[0][5]
    nsplit = _attn.decode_splits(S, B, KV, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    return attn_row(
        "decode_attention_g48", 61,
        decode_case(dev, da, da_ref, B, H, KV, hd, positions, 94),
        launches["decode_attention"],
        {"per_decode_step": launches["decode_attention"]
         / d["decode_steps"], "arch": cfg.name},
        {"B": B, "S": S, "positions": list(positions), "H": H, "KV": KV,
         "hd": hd, "splits": nsplit,
         "split_pass_blocks": nsplit * KV * B * -(-H // KV // 16)}, errs)


def cross_flash_case(dev, fa, fa_ref, n, L, T, H, KV, hd, seed):
    """A cross layer's prefill: n prompts of L tokens against all T
    vision rows, not causal, no valid length: (kernel call, plain call,
    library call, the library's description, (bytes, flops)). The
    library is SDPA, not causal, on its default backend choice."""
    import torch.nn.functional as F
    q, k, v = attn_inputs(dev, torch.bfloat16, n, L, T, H, KV, hd, seed)
    pos = torch.arange(L, device=dev, dtype=torch.int32).expand(n, L)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return (lambda: fa(q, k, v, q_positions=pos, causal=False),
            lambda: fa_ref(q, k, v, q_offset=pos[:, 0], causal=False),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=True).transpose(1, 2),
            "not causal, every key, enable_gqa",
            flash_bound(n, L, H, KV, hd, hd, [T] * n, 2, causal=False))


def cross_decode_case(dev, da, da_ref, B, T, H, KV, hd, seed):
    """A cross layer's decode: B slots against all T cached vision rows
    (no position, no valid length): (kernel call, plain call, library
    call, the library's description, (bytes, flops))."""
    import torch.nn.functional as F
    q, k, v = attn_inputs(dev, torch.bfloat16, B, 1, T, H, KV, hd, seed)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return (lambda: da(q, k, v), lambda: da_ref(q, k, v),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=True).transpose(1, 2),
            "every key, enable_gqa",
            (2 * (2 * B * H * hd + B * T * KV * 2 * hd),
             B * T * H * 2 * (hd + hd)))


def cross_rows(dev, attn, cfg, launches, d, groups, errs):
    """flash attention's and flash-decode's kernels-line rows in a cross
    layer of llama-3.2-vision (not causal, over its 1600 vision rows): at
    the served run's largest prefill dispatch, and at 8 slots decoding;
    their launches are the counted run's cross launches."""
    from repro_torch.kernels import _attn
    fa, fa_ref, da, da_ref = attn
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    T, B = cfg.vision.num_tokens, SERVE_SLOTS
    (n, L) = max(((n, L) for (_, L), n in groups.items()),
                 key=lambda t: t[0] * t[1])
    nsplit = _attn.decode_splits(T, B, KV, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    return [
        attn_row("flash_attention_cross", 73,
                 cross_flash_case(dev, fa, fa_ref, n, L, T, H, KV, hd, 93),
                 launches["flash_attention_cross"],
                 {"per_prefill_dispatch": launches["flash_attention_cross"]
                  / d["prefill_dispatches"], "arch": cfg.name},
                 {"B": n, "Sq": L, "Skv": T, "kv_valid_len": None,
                  "causal": False, "H": H, "KV": KV, "hd": hd}, errs),
        attn_row("decode_attention_cross", 61,
                 cross_decode_case(dev, da, da_ref, B, T, H, KV, hd, 92),
                 launches["decode_attention_cross"],
                 {"per_decode_step": launches["decode_attention_cross"]
                  / d["decode_steps"], "arch": cfg.name},
                 {"B": B, "S": T, "positions": None, "causal": False,
                  "H": H, "KV": KV, "hd": hd, "splits": nsplit,
                  "split_pass_blocks": nsplit * KV * B}, errs)]


# --ab: B x S of the timed calls (jamba's and rwkv's 4 x 1000 prefill,
# one 1000-token prompt, 8 x 128, the scan's longest decode-kernel call,
# a decode step) and the opcodes a recurrent kernel's loop is made of
AB_CASES = ((4, 1000), (1, 1000), (8, 128), (8, 4), (8, 1))
AB_OPS = ("MUFU", "FFMA", "FMUL", "FADD", "LDS", "STS", "LDG", "STG",
          "SHFL", "BAR")


def sass_census(tool, lib):
    """{kernel function: {opcode: count, "total": n}} of a library's SASS
    (AB_OPS only, beside the total)."""
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    counts, func = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            func = counts.setdefault(m.group(1), Counter())
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                      r"([A-Z][A-Z0-9]*)", line)
        if m and func is not None:
            func[m.group(1)] += 1
    return {f: dict({op: c[op] for op in AB_OPS if c[op]},
                    total=sum(c.values())) for f, c in counts.items()}


def faces_ab(dev, core, hp, bump):
    """The Faces path of one tree: halo_pack at 64r warm (graph_ms) and
    cold (cold_ms, four fields in turns), halo_unpack at 64r (and in
    bf16 where the tree's unpack takes it) and the counter bump
    (graph_ms), and the st and fused Faces 64r programs' ms per iteration
    (event_ms; the first run, a graph's capture where the tree has
    graphs, timed apart), with the device's busy ms and ops per
    iteration and the pack's and unpack's device ms per iteration from
    the profiler. Only APIs the parent shares."""
    R = int(np.prod(GRID_FULL))
    gen = torch.Generator(device=dev).manual_seed(6)
    recv = hp.halo_pack(torch.randn((R,) + N_FULL, generator=gen,
                                    device=dev))
    sig = torch.zeros((R, 26), dtype=torch.int32, device=dev)
    upd = torch.ones((R, 26), dtype=torch.int32, device=dev)
    fields = [torch.rand((R,) + N_FULL, generator=gen, device=dev)
              for _ in range(4)]
    out = {"halo_pack 64r ms": graph_ms(lambda: hp.halo_pack(fields[0])),
           "halo_pack 64r cold ms": cold_ms(hp.halo_pack, fields),
           "halo_unpack 64r ms": graph_ms(lambda: hp.halo_unpack(recv,
                                                                 N_FULL)),
           "counter_bump ms": graph_ms(lambda: bump(sig, upd))}
    recv16 = recv.to(torch.bfloat16)
    try:                        # a tree whose unpack takes bf16
        hp.halo_unpack(recv16, N_FULL)
    except TypeError:
        pass
    else:
        out["halo_unpack 64r bf16 ms"] = graph_ms(
            lambda: hp.halo_unpack(recv16, N_FULL))
    del fields
    src0 = torch.rand((R,) + N_FULL, generator=gen, device=dev)
    for mode in ("st", "fused"):
        stream = core.STStream(dev, AXES, grid_shape=GRID_FULL)
        core.halo.build_faces_program(stream, N_FULL, NITER_FULL)
        state = stream.allocate()
        state["faces.src"] = src0

        def run(stream=stream, state=state, mode=mode):
            return stream.synchronize(state, mode=mode, resources=16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()                           # warm-up (a graph's capture)
        out[f"faces {mode} first run ms"] = 1e3 * (time.perf_counter() - t0)
        out[f"faces {mode} iter ms"] = event_ms(run, reps=5,
                                                warm=False) / NITER_FULL
        prof = device_profile(run, os.path.join(
            OUT_DIR, f"profile_ab_faces_{mode}.txt"))
        out[f"faces {mode} device busy ms/iter"] = (
            float("nan") if prof["busy_ms"] is None
            else prof["busy_ms"] / NITER_FULL)
        out[f"faces {mode} device ops/iter"] = prof["device_ops"] / NITER_FULL
        for k, v in kernel_ms(prof, ("halo_pack", "halo_unpack")).items():
            out[f"faces {mode} {k} device ms/iter"] = v / NITER_FULL
    return out


def ab_worker(tree):
    """Build ``tree``'s recurrent and Faces kernels; time the recurrent
    ones at AB_CASES on the kernels-line rows' inputs (wkv_inputs at 32
    heads of 64; scan_inputs at d_inner 16384, d_state 16, b and c
    strided after 512 columns), then the Faces path (faces_ab) and
    granite's serving (serve_ab)."""
    sys.path.insert(0, os.path.join(tree, "src"))
    from repro_torch.kernels import _build
    check(os.path.realpath(_build.__file__).startswith(tree + os.sep),
          f"{_build.__file__} is not {tree}'s")
    import repro_torch.core as core
    from repro_torch.kernels.counter_bump import counter_bump
    from repro_torch.kernels.halo_pack import ops as hp
    from repro_torch.kernels.mamba_scan import mamba_scan
    from repro_torch.kernels.rwkv6 import wkv6
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    os.makedirs(OUT_DIR, exist_ok=True)
    names = ("wkv6", "mamba_scan", "halo_pack", "counter_bump")
    _build.build_all(list(names))
    tool = disassembler()
    sass = {n: sass_census(tool, _build.library_path(n)) if tool else
            "not measured: no cuobjdump" for n in names}
    ms = {}
    for B, S in AB_CASES:
        ins = wkv_inputs(dev, torch.bfloat16, B, S, 32, 64, 40)
        ms[f"wkv6 {B}x{S}"] = graph_ms(lambda: wkv6(*ins), inner=5)
        ins = scan_inputs(dev, torch.bfloat16, B, S, 16384, 16, 70, 512)
        ms[f"mamba_scan {B}x{S}"] = graph_ms(lambda: mamba_scan(*ins),
                                             inner=5)
        del ins
    ms.update(faces_ab(dev, core, hp, counter_bump))
    torch.cuda.empty_cache()
    ms.update(serve_ab(dev))
    emit({"tree": tree, "sass": sass, "ms": ms})


def serve_ab(dev):
    """granite-3-2b at full width (random bf16 weights, seed 0) served as
    in phase 6 (:func:`serve_measured`, the same seeded requests)
    through the tree's ServingEngine: decode ms per step,
    prefill ms per dispatch, tokens/s (the counted run's host wall time)
    and peak GB (the units in the keys)."""
    import repro_torch.configs as cfgs
    from repro_torch.models import init_params, model_specs
    from repro_torch.serving import Request, ServingEngine
    cfg = cfgs.get_config("granite-3-2b")
    params = init_params(model_specs(cfg), torch.Generator(
        device=dev).manual_seed(0), dev, torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(cfg, params, batch_slots=SERVE_SLOTS,
                        max_len=SERVE_MAX_LEN, moe_impl="dense", device=dev)
    _, d, _ = serve_measured(eng, serve_requests(
        Request, cfg, np.random.RandomState(0)))
    out = {"serve granite tokens_per_s": d["tokens_generated"] / d["wall_s"],
           "serve granite decode_ms_per_step":
           d["decode_seconds"] * 1e3 / d["decode_steps"],
           "serve granite prefill_ms_per_dispatch":
           d["prefill_seconds"] * 1e3 / d["prefill_dispatches"],
           "serve granite peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del eng, params
    return out


def ab(other):
    """This tree's recurrent kernels, Faces path and granite serving
    against ``other``'s, one worker process per tree in turns other,
    this, this, other."""
    trees = {"other": os.path.realpath(other), "this": ROOT}
    runs = {"other": [], "this": []}
    for who in ("other", "this", "this", "other"):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--ab-worker", trees[who]],
                             capture_output=True, text=True, timeout=900)
        check(out.returncode == 0, f"the --ab worker of {trees[who]} "
              f"failed:\n{out.stderr[-4000:]}")
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        if runs[who]:
            rec.pop("sass")                 # the same build: counted once
        emit(dict(rec, who=who))
        runs[who].append(rec["ms"])
    # each key's median over the tree's two workers (ms, unless the key
    # names another unit)
    emit({"median": {who: {case: statistics.median(r[case] for r in recs)
                           for case in recs[0]}
                     for who, recs in runs.items()}})


# ---------------------------------------------------------------------------
# the broadcast, ring and expert-parallel a2a transports, and the
# multicast put
# ---------------------------------------------------------------------------

# the broadcast cell: a SUMMA operand of 4096 x 8192 float32 over a (2, 4)
# grid of virtual ranks, 2048 x 2048 tiles (16 MB a rank), 4 iterations
BCAST_GRID, BCAST_TILE, BCAST_NITER = (2, 4), 2048, 4
# the ring cell: jamba-1.5-large-398b's attention width (64 heads of 128,
# its 8 KV heads expanded to 64, as ring_attention_train takes equal
# heads), B = 1, bf16, 4 virtual ranks x 2048 tokens (an 8192-token
# causal context); the sharded decode: 8 slots over a 32768-token cache
RING_RANKS, RING_SEQ, RING_H, RING_KV, RING_HD = 4, 8192, 64, 8, 128
RING_DECODE_B, RING_DECODE_S = 8, 32768
# the a2a cell: one jamba-1.5-large-398b MoE layer at full width (d_model
# 8192, 16 experts of 24576, top-2, capacity factor 1.25; 19.3 GB of
# bf16 weights) over 4 virtual shards (4 experts each), granite's
# prefill traffic of 8 x 1000 tokens (capacity 1252 a expert)
A2A_RANKS, A2A_B, A2A_S = 4, 8, 1000
PATTERN_TIMING_REPS = 7
# the multicast put's odd cases: rows of these many elements, aligned
# and one element off a 16-byte boundary, in these dtypes
MCAST_ROWS = (1, 3, 64, 4097)
MCAST_DTYPES = (torch.float32, torch.bfloat16, torch.int32, torch.uint8)


def mcast_tables(core, dev):
    """{label: (nb, R) table}: the broadcast's three branches on the
    (2, 4) grid, periodic and not (-1 entries), and a hand-made table
    with repeated sources and an empty branch."""
    out = {}
    for periodic in (True, False):
        stream = core.STStream(dev, ("row", "col"), periodic=periodic,
                               grid_shape=BCAST_GRID)
        out["periodic" if periodic else "edges"] = core.engine._mcast_index(
            stream, [(0, k) for k in range(1, BCAST_GRID[1])])
    out["repeats"] = torch.tensor([[3, -1, 0, 7, 7, -1, 1, 2], [-1] * 8,
                                   [0, 1, 2, 3, 4, 5, 6, 7]], device=dev)
    return out


def phase_multicast(dev, core, cb):
    """put_multicast against its plain version, bit for bit: at the
    broadcast's payload (8 ranks x 16 MB float32, 3 branches) and at odd
    rows in float32, bf16, int32 and uint8, on every table of
    ``mcast_tables``, with and without the signal. Returns the largest
    difference (0.0 when equal)."""
    gen = torch.Generator(device=dev).manual_seed(11)
    tables = mcast_tables(core, dev)
    R, nb = 8, 3
    sig = torch.randint(0, 1 << 20, (R, nb), generator=gen, device=dev,
                        dtype=torch.int32)
    upd = torch.randint(0, 3, (R, nb), generator=gen, device=dev,
                        dtype=torch.int32)
    err, cases = 0.0, 0

    def hold(x, table, what):
        nonlocal err, cases
        want = cb.put_multicast_ref(x, table)
        got = cb.put_multicast(x, table)
        got2, cnt = cb.put_multicast(x, table, sig, upd)
        err = max([err, diff(cnt, sig + upd)]
                  + [diff(a, b) for a, b in zip(got + got2, want + want)])
        check(len(got) == len(want) and all(
            torch.equal(a, b) and a.dtype == b.dtype and a.is_contiguous()
            for a, b in zip(got + got2, want + want))
            and torch.equal(cnt, sig + upd), f"put_multicast != plain: {what}")
        cases += 1

    big = torch.randn((R, BCAST_TILE, BCAST_TILE), generator=gen, device=dev)
    for label, table in tables.items():
        hold(big, table, f"broadcast payload, {label}")
    del big
    for dtype in MCAST_DTYPES:
        for e in MCAST_ROWS:
            wide = int_draw(gen, dev, (R, e + 1), dtype) \
                if not dtype.is_floating_point else \
                torch.randn((R, e + 1), generator=gen, device=dev).to(dtype)
            for x in (wide[:, :e].contiguous(), wide[:, 1:]):
                for label, table in tables.items():
                    hold(x, table, f"{dtype}, row {e}, {label}, "
                         f"aligned={x.is_contiguous()}")
    emit({"phase": "kernels", "put_multicast": "equal", "cases": cases,
          "tables": {k: v.tolist() for k, v in tables.items()},
          "rows": list(MCAST_ROWS), "dtypes": [str(d) for d in MCAST_DTYPES],
          "broadcast_payload": [R, BCAST_TILE, BCAST_TILE]})
    return err


def multicast_row(core, cb, dev, launches, err):
    """put_multicast's kernels-line row at the broadcast's payload (8
    ranks x 16 MB float32 to 3 branches, with the completion tree's
    signal): warm (the payload stays partly in L2 between calls) and cold
    (two payloads in turns, 256 MB, each call's landing buffers kept);
    beside it the plain version, the 3 put_signal launches it replaces
    (the last with the signal) and one index_select a branch, the
    library's nearest call. Bound: the payload read once, written 3
    times, the table and the counters."""
    gen = torch.Generator(device=dev).manual_seed(12)
    table = mcast_tables(core, dev)["periodic"]
    R, nb = table.shape[1], table.shape[0]
    xs = [torch.randn((R, BCAST_TILE, BCAST_TILE), generator=gen,
                      device=dev) for _ in range(2)]
    x = xs[0]
    sig = torch.zeros((R, nb), dtype=torch.int32, device=dev)
    upd = torch.ones((R, nb), dtype=torch.int32, device=dev)

    def kern():
        return cb.put_multicast(x, table, sig, upd)

    def unicast():
        outs = [cb.put_signal(x, table[b]) for b in range(nb - 1)]
        return outs + [cb.put_signal(x, table[nb - 1], sig, upd)]

    def lib():
        return [x.index_select(0, table[b]) for b in range(nb)]

    got, _ = kern()
    check(all(torch.equal(a, b) for a, b in zip(got, lib())),
          "index_select != put_multicast")
    del got
    nbytes = (x.numel() * 4 * (1 + nb) + table.numel() * 8
              + 3 * sig.numel() * 4)
    row = {"name": "put_multicast", "route": "cuda",
           "source": "src/repro_torch/csrc/counter_bump.cu",
           # the multicast descriptor's branches and completion tree,
           # whose bump the TPU kernel ran on the counter arena
           "replaces": "src/repro/core/engine.py:67",
           "launches": sum(launches.values()),
           "launches_by_case": launches,
           "max_abs_err": err, "ms": graph_ms(kern, inner=5),
           "cold_ms": cold_ms(lambda t: cb.put_multicast(t, table, sig, upd),
                              xs, inner=4),
           "plain_ms": graph_ms(lambda: cb.put_multicast_ref(
               x, table, sig, upd), inner=5),
           "unicast_put_signal_ms": graph_ms(unicast, inner=5),
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "bytes": nbytes, "library_ms": graph_ms(lib, inner=5),
           "library": f"torch.index_select x {nb} (no signal)",
           "design": "source-major: each payload row read once and stored "
                     "to every branch it feeds",
           "payload": [R, BCAST_TILE, BCAST_TILE], "branches": nb,
           "call_ms": event_ms(kern, inner=5)}
    del xs, x
    return row


def predicted_launches(prog, mode):
    """The emission's kernel launches of one run of ``prog``: st and
    fused one put_multicast (with its signal) per multicast descriptor,
    one put_signal per unicast put, one counter_bump per post signal;
    host the puts without their signal and one counter_bump more per put
    (its completion, a multicast's whole tree in one)."""
    mputs = sum(1 for n in prog.puts() if n.mcast_dirs)
    puts = len(prog.puts()) - mputs
    posts = sum(1 for n in prog.nodes
                if n.kind == "signal" and n.role == "post")
    return {"put_multicast": mputs, "put_signal": puts,
            "counter_bump": posts + (mputs + puts if mode == "host" else 0)}


def run_pattern(core, _build, label, stream, state, niter):
    """One transport's program in st, host and fused mode: the first run
    (warm-up and capture) apart, a counted run (its launches against
    ``predicted_launches``), the ms per iteration (CUDA events around
    whole runs, median of PATTERN_TIMING_REPS, ending in the run's host
    sync), the device's busy and idle share and the host's launch calls
    per iteration (profiler), the graphs' copies; every mode bit for bit
    the eager emission. Returns ({mode: launches}, the eager result)."""
    from repro_torch.core.backends import _emit_st
    prog, = stream.scheduled_programs()
    eager = _emit_st(stream, prog, state)
    torch.cuda.synchronize()
    line = {"phase": "patterns", "case": label, "ranks": stream.num_ranks,
            "niter": niter, "descriptors": len(prog.nodes),
            "stats": {k: prog.stats()[k] for k in
                      ("puts", "multicast_puts", "epochs")},
            "modes": {}}
    launches = {}
    tag = label.replace(" ", "_")
    for mode in MODES:
        sched, = stream.scheduled_programs(fused=mode == "fused")
        want = predicted_launches(sched, mode)
        t0 = time.perf_counter()
        first = stream.synchronize(state, mode=mode)
        first_ms = 1e3 * (time.perf_counter() - t0)
        _build.reset_launches()
        out = stream.synchronize(state, mode=mode)
        got = {k: _build.LAUNCHES[k] for k in want}
        check(got == want, f"{label} {mode}: launches {got}, want {want}")
        for k, v in eager.items():
            check(torch.equal(out[k], v) and torch.equal(first[k], v),
                  f"{label} {mode}: {k} differs from the eager emission")
        del first, out
        ms = event_ms(lambda: stream.synchronize(state, mode=mode),
                      reps=PATTERN_TIMING_REPS, warm=False)
        prof = device_profile(lambda: stream.synchronize(state, mode=mode),
                              os.path.join(OUT_DIR,
                                           f"profile_{tag}_{mode}.txt"))
        cache = {"st": stream._compiled_cache, "fused": stream._fused_cache,
                 "host": {}}[mode]
        entry = {"ms_per_iter": ms / niter, "first_run_ms": first_ms,
                 "launches": got,
                 "device_busy_ms_per_iter": None if prof["busy_ms"] is None
                 else prof["busy_ms"] / niter,
                 "device_idle_share": None if prof["busy_ms"] is None
                 else 1 - prof["busy_ms"] / ms,
                 "device_ops_per_iter": prof["device_ops"] / niter,
                 "host_launch_calls_per_iter": sum(
                     prof["host_calls"].values()) / niter,
                 "host_calls": prof["host_calls"],
                 "graphs": sum(len(g.chain) for g in cache.values())}
        # (no name outlives the loop holding a graph and its static copy)
        for copies in [graph_copies(core, g, state) for g in cache.values()]:
            entry.update(copies)
        del cache
        line["modes"][mode] = entry
        launches[mode] = got
        stream.clear_graphs()
        gc.collect()
        torch.cuda.empty_cache()
    emit(line)
    return launches, eager


def graph_copies(core, g, state):
    """A program graph's copies: GB copied in and out a run, the keys
    handed back as given, and the copy-in's device ms (CUDA graph)."""
    copied = g.copied_bytes()
    static = list(g.static.values())
    srcs = [state[k] for k in g.static]
    return {"copy_in_gb": copied["in"] / 1e9,
            "copy_out_gb": copied["out"] / 1e9,
            "copy_in_ms": graph_ms(lambda: core.graphs._copy(static, srcs),
                                   inner=2, reps=3),
            "keys_returned_as_given": len(g.static) - len(g.written)}


def broadcast_cases(core, dev):
    """The broadcast cell, multicast and unicast, double-buffered or
    not: (label, stream, window, state) each."""
    from repro_torch.core.broadcast import build_broadcast_program
    gen = torch.Generator(device=dev).manual_seed(13)
    R = int(np.prod(BCAST_GRID))
    abase = torch.randn((R, BCAST_TILE, BCAST_TILE), generator=gen,
                        device=dev)
    b = torch.randn((R, BCAST_TILE, BCAST_TILE), generator=gen, device=dev)
    for db in (False, True):
        for mc in (True, False):
            stream = core.STStream(dev, ("row", "col"),
                                   grid_shape=BCAST_GRID)
            win, _ = build_broadcast_program(
                stream, BCAST_NITER, tile=BCAST_TILE, multicast=mc,
                double_buffer=db)
            state = stream.allocate({win.qual("abase"): abase,
                                     win.qual("b"): b})
            yield (f"broadcast {'mc' if mc else 'uni'}"
                   f"{' db' if db else ''}", stream, win, state)


def attention_f32(q, k, v, chunk=2048):
    """Plain causal softmax(QK^T/sqrt(hd)) V in float32, one query chunk
    at a time (the full float32 scores of 8192 tokens and 64 heads are
    17 GB). q, k, v: (B, S, H, hd) with equal heads."""
    B, S, H, hd = q.shape
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    out = torch.empty((B, H, S, hd), device=q.device)
    pos = torch.arange(S, device=q.device)
    for lo in range(0, S, chunk):
        s = qf[:, :, lo:lo + chunk] @ kf.transpose(2, 3) / hd ** 0.5
        s.masked_fill_(pos[None, :] > pos[lo:lo + chunk, None], float("-inf"))
        out[:, :, lo:lo + chunk] = torch.softmax(s, dim=-1) @ vf
        del s
    return out.transpose(1, 2)


def moe_layer(cfg, dev):
    """One MoE layer's weights at ``cfg``'s width, random bf16 from a
    seed (the router at scale 0.02, the experts at 1/sqrt(fan in), the
    port's init rules)."""
    mo, d = cfg.moe, cfg.d_model
    gen = torch.Generator(device=dev).manual_seed(14)

    def draw(shape, scale):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16).mul_(scale)
    return {"router": draw((d, mo.num_experts), 0.02),
            "w_gate": draw((mo.num_experts, d, mo.expert_ff), d ** -0.5),
            "w_up": draw((mo.num_experts, d, mo.expert_ff), d ** -0.5),
            "w_down": draw((mo.num_experts, mo.expert_ff, d),
                           mo.expert_ff ** -0.5)}


def bf16_limit(ref):
    """The bf16 bound of the transports' checks: 2e-2 of the largest
    |value| of the float32 (or wider) reference, the attention kernels'
    bf16 tolerance (ATTN_RTOL_BF16)."""
    return ATTN_RTOL_BF16 * ref.float().abs().max().item()


def phase_patterns(dev, core, _build, cfgs):
    """The broadcast (mc and uni, double-buffered or not), ring and a2a
    cells through st, host and fused (``run_pattern``), with each
    transport's checks: multicast bit for bit unicast, the counters the
    iteration count, ring within the bf16 bound of the direct rotation
    and both of a float32 plain causal attention, the sharded decode of
    the float32 plain decode, a2a within the bf16 bound of the direct
    moe_a2a at 4 shards and at 1. Returns {case: {mode: launches}}."""
    from repro_torch.core import ep_a2a, ring
    from repro_torch.kernels.decode_attention import decode_attention_ref
    launches = {}
    # broadcast: 4 cases, each mc against its uni bit for bit
    kept = {}
    for label, stream, win, state in broadcast_cases(core, dev):
        launches[label], out = run_pattern(core, _build, label, stream,
                                           state, BCAST_NITER)
        sets = {"": BCAST_NITER} if "db" not in label else \
            {"": BCAST_NITER // 2, "__pp": BCAST_NITER // 2}
        for suffix, n in sets.items():
            for c in ("post_sig", "comp_sig"):
                want = torch.as_tensor(core.counters_expected(
                    n, BCAST_GRID[1] - 1), device=dev)
                check(bool((out[f"bcast.{c}{suffix}"] == want).all()),
                      f"{label}: {c}{suffix} != counters_expected")
        key = label.replace(" mc", "").replace(" uni", "")
        if key in kept:
            other = kept.pop(key)
            check(other.keys() == out.keys() and all(
                torch.equal(v, other[k]) for k, v in out.items()),
                f"{key}: multicast != unicast")
            emit({"phase": "patterns", "case": key,
                  "multicast_vs_unicast": "equal, every buffer and counter",
                  "ctile_abs_max": out["bcast.ctile"].abs().max().item()})
        else:
            kept[key] = out
        del stream, state, out
        gc.collect()
        torch.cuda.empty_cache()
    # ring: the ST program, the direct rotation, float32 plain attention
    gen = torch.Generator(device=dev).manual_seed(15)
    shape = (1, RING_SEQ, RING_H, RING_HD)
    q = torch.randn(shape, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((1, RING_SEQ, RING_KV, RING_HD), generator=gen,
                        device=dev).bfloat16()
            .repeat_interleave(RING_H // RING_KV, dim=2) for _ in range(2))
    stream, win = ring.ring_stream(q, ranks=RING_RANKS)
    state = stream.allocate({win.qual(nm): ring._blocks(t, RING_RANKS)
                             .contiguous() for nm, t in
                             (("q", q), ("k", k), ("v", v))})
    launches["ring"], out = run_pattern(core, _build, "ring", stream, state,
                                        1)
    st_out = ring._unblocks(out[win.qual("out")])
    del stream, state, out
    direct_ms = event_ms(lambda: ring.ring_attention_train(
        q, k, v, ranks=RING_RANKS), reps=3)
    direct = ring.ring_attention_train(q, k, v, ranks=RING_RANKS)
    ref = attention_f32(q, k, v)
    lim = bf16_limit(ref)
    errs = {"st_vs_direct": diff(st_out, direct),
            "st_vs_f32": diff(st_out, ref), "direct_vs_f32": diff(direct, ref)}
    check(all(e <= lim for e in errs.values()),
          f"ring: {errs} beyond the bf16 bound {lim}")
    del direct, ref, st_out, q, k, v
    gc.collect()
    torch.cuda.empty_cache()
    # the sharded decode at the same width
    qd = torch.randn((RING_DECODE_B, 1, RING_H, RING_HD), generator=gen,
                     device=dev).bfloat16()
    kd, vd = (torch.randn((RING_DECODE_B, RING_DECODE_S, RING_KV, RING_HD),
                          generator=gen, device=dev).bfloat16()
              for _ in range(2))
    pos = torch.randint(RING_DECODE_S // 2, RING_DECODE_S,
                        (RING_DECODE_B,), generator=gen, device=dev,
                        dtype=torch.int32)
    dec = ring.sharded_decode_attention(qd, kd, vd, pos, ranks=RING_RANKS)
    dref = decode_attention_ref(qd.float(), kd.float(), vd.float(),
                                q_positions=pos[:, None])
    dlim = bf16_limit(dref)
    derr = diff(dec, dref)
    check(derr <= dlim, f"sharded decode: {derr} beyond {dlim}")
    dms = event_ms(lambda: ring.sharded_decode_attention(
        qd, kd, vd, pos, ranks=RING_RANKS), reps=5)
    emit({"phase": "patterns", "case": "ring", "shape": list(shape),
          "ranks": RING_RANKS, "kv_heads_expanded_from": RING_KV,
          "max_abs_err": errs, "bound": lim,
          "direct_ms": direct_ms,
          "sharded_decode": {"slots": RING_DECODE_B, "cache": RING_DECODE_S,
                             "max_abs_err_vs_f32": derr, "bound": dlim,
                             "ms": dms}})
    del qd, kd, vd, dec, dref
    gc.collect()
    torch.cuda.empty_cache()
    # a2a: one jamba MoE layer over 4 shards, the weights as views
    cfg = cfgs.get_config("jamba-1.5-large-398b")
    check((cfg.d_model, cfg.moe.num_experts, cfg.moe.expert_ff,
           cfg.moe.top_k, cfg.moe.capacity_factor) ==
          (8192, 16, 24576, 2, 1.25), "jamba's MoE is not at full width")
    params = moe_layer(cfg, dev)
    x = torch.randn((A2A_B, A2A_S, cfg.d_model), generator=gen,
                    device=dev).bfloat16()
    stream, win, state = ep_a2a.a2a_stream(cfg, params, x, ranks=A2A_RANKS)
    torch.cuda.reset_peak_memory_stats()
    launches["a2a"], out = run_pattern(core, _build, "a2a", stream, state, 1)
    peak = torch.cuda.max_memory_allocated() / 1e9
    st_out = out[win.qual("out")][0]
    del stream, state, out
    gc.collect()
    torch.cuda.empty_cache()
    errs, ms = {}, {}
    for n in (A2A_RANKS, 1):
        ms[n] = event_ms(lambda n=n: ep_a2a.moe_a2a(cfg, params, x,
                                                    n_shards=n), reps=3)
        want, _ = ep_a2a.moe_a2a(cfg, params, x, n_shards=n)
        errs[n] = (diff(st_out, want), bf16_limit(want))
        del want
    check(all(e <= lim for e, lim in errs.values()),
          f"a2a: ST against the direct moe_a2a {errs}")
    emit({"phase": "patterns", "case": "a2a", "tokens": [A2A_B, A2A_S],
          "shards": A2A_RANKS, "capacity": ep_a2a._capacity(
              cfg, A2A_B * A2A_S),
          "weights_gb": sum(p.numel() * 2 for p in params.values()) / 1e9,
          "peak_mem_gb": peak,
          "st_vs_direct": {f"{n}_shards": {"max_abs_err": e, "bound": b}
                           for n, (e, b) in errs.items()},
          "direct_ms": {f"{n}_shards": t for n, t in ms.items()}})
    del params, x, st_out
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def count_drops(ep_a2a):
    """Wrap ``ep_a2a._moe_shard`` (eager calls only: it reads the counts
    on the host) so that each call adds to the returned dict the (token,
    expert) assignments it was given and those its experts' capacity
    dropped, computed from the same router product, softmax and top-k;
    the second value restores the original."""
    from repro_torch.models.moe import _top_k
    counts = {"calls": 0, "assignments": 0, "dropped": 0}
    inner = ep_a2a._moe_shard

    def shard(cfg, xl, router, wg, wu, wd, shard_id, e_l):
        n, Bl, S, D = xl.shape
        T = Bl * S
        probs = torch.softmax(torch.matmul(xl.reshape(n, T, D), router)
                              .float(), dim=-1)
        _, sel = _top_k(probs, cfg.moe.top_k)
        load = torch.nn.functional.one_hot(
            sel.reshape(n, -1), cfg.moe.num_experts).sum(1)
        mine = load.reshape(n, -1, e_l)[torch.arange(n, device=load.device),
                                        shard_id]
        C = ep_a2a._capacity(cfg, max(T, 4))
        counts["calls"] += 1
        counts["assignments"] += int(mine.sum())
        counts["dropped"] += int((mine - C).clamp(min=0).sum())
        return inner(cfg, xl, router, wg, wu, wd, shard_id, e_l)

    ep_a2a._moe_shard = shard

    def restore():
        ep_a2a._moe_shard = inner
    return counts, restore


def phase_a2a_serve(dev, serving, cfg, params, dense, a2a):
    """jamba's a2a engine beside its dense one (``dense``/``a2a``: each
    phase_serve's (decode counts, requests)): tokens/s and decode ms per
    step of the counted runs, how many served requests got dense's tokens,
    and the served a2a tokens replayed teacher-forced (bf16, kernel path)
    through the dense MoE, the a2a MoE, and the a2a MoE with a capacity
    that drops nothing (capacity factor E / top_k: every expert can take
    every token). The last must lie within LOGITS_ATOL of dense (the same
    experts on the same tokens, rounded at other points); the a2a MoE at
    its real capacity is held there too when its replay dropped no
    assignment, and otherwise reported with how many it dropped."""
    from repro_torch.core import ep_a2a
    (dd, dreqs), (ad, areqs) = dense, a2a
    same = sum(a.out_tokens == b.out_tokens for a, b in zip(dreqs, areqs))
    logits = {"dense": replay_logits(serving, cfg, params, dev, areqs,
                                     moe_impl="dense")}
    wide = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    logits["a2a_no_drop"] = replay_logits(serving, wide, params, dev, areqs,
                                          moe_impl="a2a")
    counts, restore = count_drops(ep_a2a)
    try:
        logits["a2a"] = replay_logits(serving, cfg, params, dev, areqs,
                                      moe_impl="a2a")
    finally:
        restore()
    gap = {k: diff(v, logits["dense"]) for k, v in logits.items()
           if k != "dense"}
    check(gap["a2a_no_drop"] <= LOGITS_ATOL,
          f"jamba a2a (no drops) logits {gap['a2a_no_drop']} from dense")
    if counts["dropped"] == 0:
        check(gap["a2a"] <= LOGITS_ATOL,
              f"jamba a2a logits {gap['a2a']} from dense with no drop")
    ms = {k: 1e3 * d["decode_seconds"] / d["decode_steps"]
          for k, d in (("dense", dd), ("a2a", ad))}
    emit({"phase": "serve_a2a", "arch": cfg.name,
          "tokens_per_s": {"dense": dd["tokens_generated"] / dd["wall_s"],
                           "a2a": ad["tokens_generated"] / ad["wall_s"]},
          "decode_ms_per_step": ms,
          "prefill_ms_per_dispatch": {
              k: 1e3 * d["prefill_seconds"] / d["prefill_dispatches"]
              for k, d in (("dense", dd), ("a2a", ad))},
          "requests_with_dense_tokens": [same, len(areqs)],
          "replay_logits_gap": gap, "bound": LOGITS_ATOL,
          "replay_a2a_assignments": counts["assignments"],
          "replay_a2a_dropped": counts["dropped"],
          "a2a_gap_checked": counts["dropped"] == 0})


# ---------------------------------------------------------------------------
# DeepSeek-V2's MLA, deepseek-moe-16b, and the attention archs served short
# ---------------------------------------------------------------------------

def phase_deepseek(dev, _build, serving, cfgs, attn, attn_errs):
    """deepseek-v2-236b at full width cut to DEEPSEEK_LAYERS layers served
    as in phase 6 with the dense MoE (exactly DEEPSEEK_LAYERS flash
    attention launches at (192, 128) in every prefill dispatch, none of
    either attention kernel in a decode step: the absorbed decode is
    plain products); its flash_attention_192x128 kernels-line row; the
    served tokens replayed in bf16 (its float32 copy does not fit beside
    it); then, its weights freed, the bf16 and float32 replay of its
    first layer; then deepseek-moe-16b whole, served as in phase 6.
    Returns the new kernels-line rows."""
    MoE, MLA = cfgs.MoEConfig, cfgs.MLAConfig
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "serve", "arch": "deepseek-v2-236b",
          "allocated_before_gb": torch.cuda.memory_allocated() / 1e9})
    ds = dataclasses.replace(cfgs.get_config("deepseek-v2-236b"),
                             num_layers=DEEPSEEK_LAYERS)
    check(ds.layer_specs() == [("mla", "dense")] + [("mla", "moe")] * 3,
          f"deepseek-v2 cut layers {ds.layer_specs()}")
    mla_kernels = {"prefill": {"flash_attention": "mla"},
                   "decode": {"decode_attention": "attn"}}   # none
    cfg, launches, counts, _, _, params, reqs = phase_serve(
        dev, _build, serving, ds,
        dict(num_layers=DEEPSEEK_LAYERS, d_model=5120, num_heads=128,
             num_kv_heads=128, d_ff=1536, vocab_size=102400,
             first_dense_ff=12288,
             moe=MoE(num_experts=160, top_k=6, expert_ff=1536, num_shared=2,
                     shared_ff=3072),
             mla=MLA(kv_lora_rank=512, q_lora_rank=1536, qk_nope_head_dim=128,
                     qk_rope_head_dim=64, v_head_dim=128)),
        mla_kernels, profile_rows=JAMBA_PROFILE_ROWS,
        cut=f"depth: the first {DEEPSEEK_LAYERS} of 60 layers, (mla, dense) "
            "then 3 x (mla, moe)")
    rows = [mla_flash_row(dev, *attn[:2], cfg, launches, counts, attn_errs)]
    emit(dict(rows[-1], phase="kernel_row"))
    phase_replay(dev, serving, cfg, params, reqs, f32=False,
                 moe_impl="dense", max_rows=JAMBA_PROFILE_ROWS)
    del params                              # deepseek-v2's 26.6 GB go first
    torch.cuda.empty_cache()
    cut = dataclasses.replace(cfg, num_layers=1)
    check(cut.layer_specs() == [("mla", "dense")], "first-layer cut")
    phase_replay_cut(dev, serving, cut, "the first layer", reqs,
                     max_rows=JAMBA_PROFILE_ROWS)
    del reqs
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, _, _, _, _, params, reqs = phase_serve(
        dev, _build, serving, cfgs.get_config("deepseek-moe-16b"),
        dict(num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
             head_dim=128, d_ff=1408, vocab_size=102400,
             first_dense_ff=10944,
             moe=MoE(num_experts=64, top_k=6, expert_ff=1408, num_shared=2,
                     shared_ff=2816)),
        {"prefill": {"flash_attention": "attn"},
         "decode": {"decode_attention": "attn"}})
    del params, reqs
    torch.cuda.empty_cache()
    return rows


def phase_short_serves(dev, _build, serving, cfgs, attn, attn_errs,
                       kernels):
    """The attention archs of SHORT_SERVES at full width, each alone on
    the card (cut in depth where its weights, cache and the decode
    check's copies would not fit), served as in phase 6 without the
    profiles: the counted run (one flash attention launch per layer a
    prefill dispatch, one flash-decode launch per layer a decode step)
    and the decode graph against the eager step. granite-34b (MQA,
    G = 48) gives flash-decode's decode_attention_g48 row."""
    dims = {"minitron-4b": dict(d_model=3072, num_heads=24, num_kv_heads=8,
                                head_dim=128, d_ff=9216, vocab_size=256000),
            "qwen3-32b": dict(d_model=5120, num_heads=64, num_kv_heads=8,
                              head_dim=128, d_ff=25600, vocab_size=151936,
                              qk_norm=True),
            "granite-34b": dict(d_model=6144, num_heads=48, num_kv_heads=1,
                                head_dim=128, d_ff=24576,
                                vocab_size=49152)}
    rows = []
    for arch, layers in SHORT_SERVES:
        full = cfgs.get_config(arch)
        cfg = full if layers is None else dataclasses.replace(
            full, num_layers=layers)
        torch.cuda.reset_peak_memory_stats()
        cfg, launches, counts, _, _, params, reqs = phase_serve(
            dev, _build, serving, cfg, dims[arch], kernels, short=True,
            cut=None if layers is None else
            f"depth: the first {layers} of {full.num_layers} layers")
        del params, reqs
        torch.cuda.empty_cache()
        if cfg.num_heads // cfg.num_kv_heads == MQA_GROUP:
            rows.append(mqa_decode_row(dev, *attn[2:], cfg, launches,
                                       counts, attn_errs))
            emit(dict(rows[-1], phase="kernel_row"))
    check(len(rows) == 1, "no G = 48 decode row")
    return rows


# ---------------------------------------------------------------------------
# cross attention and the modality frontends: llama-3.2-vision, musicgen
# ---------------------------------------------------------------------------

CROSS_ROWS = ("flash_attention_cross", "decode_attention_cross")


def cross_counting(attention_core, _build):
    """``attention_core`` wrapped so that a kernel launch it makes for a
    cross layer (``causal=False``) also adds one to the kernel's cross
    count (``flash_attention_cross``, ``decode_attention_cross`` in
    ``_build.LAUNCHES``, so that a decode graph's capture records it and
    its replays add it, as they add the kernel's own)."""
    def call(cfg, q, k, v, *, causal=True, **kw):
        name = "decode_attention" if q.shape[1] == 1 else "flash_attention"
        before = _build.LAUNCHES[name]
        out = attention_core(cfg, q, k, v, causal=causal, **kw)
        if not causal:
            _build.LAUNCHES[name + "_cross"] += (_build.LAUNCHES[name]
                                                 - before)
        return out
    return call


def vision_inputs(gen, dev, cfg, n):
    """Seeded unit-normal (n, vision tokens, raw_dim) float32 patch
    embeddings."""
    return torch.randn((n, cfg.vision.num_tokens, cfg.vision.raw_dim),
                       generator=gen, device=dev)


def vision_replay(dev, _build, serving, cfg, params, gen):
    """The model-level check of llama-3.2-vision's cross path, with its
    gates redrawn nonzero: VISION_ROWS prompts of 1000 tokens prefilled
    with seeded vision inputs, then VISION_DECODE_STEPS decode steps
    (positions 1000.., below the 1600 vision rows) fed the kernel route's
    greedy ids, through the kernel route and the plain route in bf16
    (bf16 caches): logits within LOGITS_ATOL (the deepseek replay's
    bound), greedy ids equal where the plain route's top-2 margin exceeds
    twice it. In the kernel route's prefill 16 causal and 4 cross flash
    launches, at each decode step 20 decode launches of which 4 cross;
    every cross layer's output nonzero (its path did work)."""
    from unittest import mock
    models = serving["models"]
    attn_mod = models.attention
    n, L, T = VISION_ROWS, SERVE_LENGTHS[-1], VISION_DECODE_STEPS
    rng = np.random.RandomState(3)
    toks = torch.as_tensor(rng.randint(1, cfg.vocab_size, (n, L))
                           .astype(np.int32), device=dev)
    vis = vision_inputs(gen, dev, cfg, n)
    cross_out = []
    inner = attn_mod.cross_attention

    def recorded(*args, **kw):
        out, cache = inner(*args, **kw)
        cross_out.append(out.abs().amax())
        return out, cache

    def run(c, counts, feed=None):
        """(n, T + 1, V) float32 logits of the prefill and each decode
        step, and the ids fed to the steps: ``feed``'s, else the route's
        own greedy ids."""
        cache = models.zeros_from_specs(models.cache_specs(
            c, n, L + T, torch.bfloat16), dev)
        logits, fed = [], []
        for t in range(T + 1):
            if t == 0:
                batch = {"tokens": toks, "vision": vis,
                         "positions": torch.arange(
                             L, device=dev, dtype=torch.int32).expand(n, L)}
            else:
                batch = {"tokens": fed[-1][:, None], "positions": torch.full(
                    (n, 1), L + t - 1, device=dev, dtype=torch.int32)}
            _build.reset_launches()
            x, _, _ = models.forward(c, params, batch, cache=cache)
            lg = models.logits_from_hidden(c, params, x, last_only=True)[
                :, 0, :c.vocab_size].float()
            counts.append({k: _build.LAUNCHES[k] for k in
                           ("flash_attention", "flash_attention_cross",
                            "decode_attention", "decode_attention_cross")})
            logits.append(lg)
            fed.append(feed[t] if feed is not None
                       else lg.argmax(dim=-1).to(torch.int32))
        return torch.stack(logits, dim=1), fed
    kcounts, pcounts = [], []
    with mock.patch.object(attn_mod, "cross_attention", recorded):
        lk, fed = run(cfg, kcounts)
    lp, _ = run(dataclasses.replace(cfg, attn_impl="plain"), pcounts, fed)
    check(bool(torch.isfinite(lk).all() and torch.isfinite(lp).all()),
          "vision replay: non-finite logits")
    err = (lk - lp).abs().amax(dim=-1)
    top2 = lp.topk(2, dim=-1).values
    dec = (top2[..., 0] - top2[..., 1] > 2 * LOGITS_ATOL).cpu().numpy()
    ids_k = lk.argmax(dim=-1).cpu().numpy()
    ids_p = lp.argmax(dim=-1).cpu().numpy()
    mismatched = int(((ids_k != ids_p) & dec).sum())
    n_cross = sum(m == "cross" for m, _ in cfg.layer_specs())
    want_prefill = {"flash_attention": cfg.num_layers,
                    "flash_attention_cross": n_cross,
                    "decode_attention": 0, "decode_attention_cross": 0}
    want_decode = {"flash_attention": 0, "flash_attention_cross": 0,
                   "decode_attention": cfg.num_layers,
                   "decode_attention_cross": n_cross}
    cross_min = min(float(t) for t in cross_out)
    emit({"phase": "vision_replay", "arch": cfg.name,
          "layers": cfg.num_layers, "prompts": n, "prompt_len": L,
          "vision_shape": list(vis.shape), "decode_steps": T,
          "gates": [float(p["mixer"]["gate"]) for p, (m, _) in
                    zip(params["layers"], cfg.layer_specs())
                    if m == "cross"],
          "logits_max_abs_err": err.max().item(),
          "logits_err_p50": err.median().item(),
          "logits_abs_max": lp.abs().max().item(),
          "logits_atol": LOGITS_ATOL, "ids_compared": int(dec.sum()),
          "ids_total": dec.size, "ids_mismatched": mismatched,
          "kernel_launches_prefill": kcounts[0],
          "kernel_launches_per_decode_step": kcounts[1],
          "plain_launches": [sum(c.values()) for c in pcounts],
          "cross_out_abs_max_min": cross_min,
          "cross_calls": len(cross_out)})
    check(kcounts[0] == want_prefill, f"vision prefill launches "
          f"{kcounts[0]}, want {want_prefill}")
    check(all(c == want_decode for c in kcounts[1:]),
          f"vision decode launches {kcounts[1:]}, want {want_decode}")
    check(all(sum(c.values()) == 0 for c in pcounts),
          "the plain route launched a kernel")
    check(len(cross_out) == n_cross * (T + 1) and cross_min > 0,
          f"cross layers' outputs: {len(cross_out)} calls, smallest "
          f"largest |out| {cross_min}")
    check(err.max().item() <= LOGITS_ATOL, f"vision replay: kernel route "
          f"logits differ from the plain route by {err.max().item()} > "
          f"{LOGITS_ATOL} (bf16)")
    check(mismatched == 0, f"vision replay: {mismatched} greedy ids "
          "differ where the plain route's top-2 margin exceeds twice the "
          "tolerance")


def vision_graph_vs_eager(dev, serving, cfg, params, gen):
    """The decode graph against the eager step with vision cached: an
    engine whose prefill gets seeded vision inputs (its cross layers'
    caches hold their K/V), warmed up until its decode step is captured,
    then 8 slots compared as in phase 6."""
    eng_mod = serving["serving"]
    eng = eng_mod.ServingEngine(cfg, params, batch_slots=SERVE_SLOTS,
                                max_len=SERVE_MAX_LEN, device=dev)
    inner = eng._prefill_sample

    def prefill(p, batch, cache):
        n = batch["tokens"].shape[0]
        return inner(p, dict(batch, vision=vision_inputs(gen, dev, cfg, n)),
                     cache)
    eng._prefill_sample = prefill
    rng = np.random.RandomState(4)

    def requests(lengths, new):
        return [eng_mod.Request(prompt=rng.randint(1, cfg.vocab_size, int(L))
                                .astype(np.int32), max_new_tokens=new)
                for L in lengths]
    for r in requests((SERVE_LENGTHS[0], SERVE_LENGTHS[-1]), 3):
        eng.submit(r)
    eng.run_until_drained()
    graphed = eng._decode_sample
    check(graphed.captures == 1, f"{cfg.name} with vision: "
          f"{graphed.captures} decode graph captures in the warm-up")
    versus = decode_graph_vs_eager(
        eng, graphed, requests(np.resize(SERVE_LENGTHS, SERVE_SLOTS),
                               3 + DECODE_COMPARE_STEPS))
    check(graphed.captures == 1, f"{cfg.name} with vision: the decode "
          f"step was captured {graphed.captures} times")
    cross = [c for c, (m, _) in zip(eng.cache["layers"], cfg.layer_specs())
             if m == "cross"]
    ck_max = max(c["ck"].float().abs().max().item() for c in cross)
    emit({"phase": "serve", "arch": cfg.name, "vision": "seeded",
          "decode_graph_vs_eager": versus, "cross_ck_abs_max": ck_max})
    check(ck_max > 0, "the cross caches hold no vision K/V")
    del eng
    torch.cuda.empty_cache()


def phase_vision(dev, _build, serving, cfgs, attn, attn_errs):
    """llama-3.2-vision-90b at full width cut to VISION_LAYERS layers
    (four whole 5-layer periods: 16 self, 4 cross), served as in phase 6
    without the profiles (granite's traffic, zero vision as the
    reference's engine feeds, the dense FFN): exactly 20 flash attention
    launches a prefill dispatch, of which 4 cross (not causal), and 20
    flash-decode launches a decode step, of which 4 cross; the decode
    graph against the eager step. Its cross kernels-line rows; then, the
    gates redrawn nonzero, the model-level check (:func:`vision_replay`)
    and the decode graph against the eager step with vision cached
    (:func:`vision_graph_vs_eager`). Returns the new kernels-line
    rows."""
    from unittest import mock
    models = serving["models"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    full = cfgs.get_config("llama-3.2-vision-90b")
    cfg = dataclasses.replace(full, num_layers=VISION_LAYERS)
    check([m for m, _ in cfg.layer_specs()]
          == (["attn"] * 4 + ["cross"]) * (VISION_LAYERS // 5),
          f"llama-3.2-vision cut layers {cfg.layer_specs()}")
    both = ("attn", "cross")
    kernels = {"prefill": {"flash_attention": both,
                           "flash_attention_cross": "cross"},
               "decode": {"decode_attention": both,
                          "decode_attention_cross": "cross"}}
    for k in CROSS_ROWS:
        _build.LAUNCHES[k] = 0
    try:
        with mock.patch.object(models.attention, "attention_core",
                               cross_counting(models.attention.attention_core,
                                              _build)):
            cfg, launches, counts, groups, _, params, reqs = phase_serve(
                dev, _build, serving, cfg,
                dict(num_layers=VISION_LAYERS, d_model=8192, num_heads=64,
                     num_kv_heads=8, head_dim=128, d_ff=28672,
                     vocab_size=128256,
                     vision=cfgs.VisionStub(num_tokens=VISION_TOKENS,
                                            raw_dim=1280)),
                kernels, short=True,
                cut=f"depth: the first {VISION_LAYERS} of "
                    f"{full.num_layers} layers, 4 x (4 self, 1 cross)")
            rows = cross_rows(dev, attn, cfg, launches, counts, groups,
                              attn_errs)
            for row in rows:
                emit(dict(row, phase="kernel_row"))
            del reqs
            gen = torch.Generator(device=dev).manual_seed(2)
            for p, (m, _) in zip(params["layers"], cfg.layer_specs()):
                if m == "cross":
                    g = 0.5 + torch.rand((), generator=gen, device=dev)
                    sign = 1.0 if torch.rand((), generator=gen,
                                             device=dev) < 0.5 else -1.0
                    p["mixer"]["gate"].copy_(sign * g)
            vision_replay(dev, _build, serving, cfg, params, gen)
            vision_graph_vs_eager(dev, serving, cfg, params, gen)
    finally:
        for k in CROSS_ROWS:
            del _build.LAUNCHES[k]
    emit({"phase": "serve", "arch": cfg.name,
          "peak_mem_gb": phase_peak() / 1e9})
    del params
    torch.cuda.empty_cache()
    return rows


def phase_musicgen(dev, _build, serving, cfgs, kernels):
    """musicgen-large whole (48 layers, MHA at hd 64) served as in phase
    6 without the profiles (granite's traffic: token ids below its
    vocab of 2048): one flash attention launch per layer a prefill
    dispatch, one flash-decode per layer a decode step, the decode graph
    against the eager step. Then :func:`frames_check`."""
    models = serving["models"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, _, _, _, _, params, reqs = phase_serve(
        dev, _build, serving, cfgs.get_config("musicgen-large"),
        dict(num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
             head_dim=64, d_ff=8192, vocab_size=2048,
             vision=cfgs.VisionStub(num_tokens=0, raw_dim=128)),
        kernels, short=True)
    del reqs
    frames_check(dev, _build, models, cfg, params)
    del params
    torch.cuda.empty_cache()


def frames_check(dev, _build, models, cfg, params):
    """One forward of seeded frame embeddings (VISION_ROWS x 1000 x
    raw_dim) through ``cfg``'s frontend, kernel route against plain route
    in the params' dtype: logits within LOGITS_ATOL, one flash attention
    launch per layer on the kernel route, none on the plain one."""
    gen = torch.Generator(device=dev).manual_seed(5)
    B, S = VISION_ROWS, SERVE_LENGTHS[-1]
    frames = torch.randn((B, S, cfg.vision.raw_dim), generator=gen,
                         device=dev)
    batch = {"frames": frames, "positions": torch.arange(
        S, device=dev, dtype=torch.int32).expand(B, S)}
    out = {}
    for route in ("kernel", "plain"):
        c = dataclasses.replace(cfg, attn_impl=route)
        _build.reset_launches()
        x, _, _ = models.forward(c, params, batch)
        out[route] = models.logits_from_hidden(c, params, x)[
            ..., :c.vocab_size].float()
        out[route + "_launches"] = _build.LAUNCHES["flash_attention"]
    err = (out["kernel"] - out["plain"]).abs().max().item()
    emit({"phase": "frames", "arch": cfg.name,
          "frames_shape": [B, S, cfg.vision.raw_dim],
          "logits_max_abs_err": err, "logits_atol": LOGITS_ATOL,
          "logits_abs_max": out["plain"].abs().max().item(),
          "flash_launches": {"kernel": out["kernel_launches"],
                             "plain": out["plain_launches"]}})
    check(bool(torch.isfinite(out["kernel"]).all()), "musicgen frames: "
          "non-finite logits")
    check(out["kernel"].shape == (B, S, cfg.vocab_size), "musicgen frames: "
          f"logits shape {tuple(out['kernel'].shape)}")
    check(out["kernel_launches"] == cfg.num_layers
          and out["plain_launches"] == 0,
          f"musicgen frames: flash launches {out['kernel_launches']} "
          f"(kernel), {out['plain_launches']} (plain)")
    check(err <= LOGITS_ATOL, f"musicgen frames: kernel route logits "
          f"differ from the plain route by {err} > {LOGITS_ATOL}")


# ---------------------------------------------------------------------------
# the dry run's accounting against the card's measured memory
# ---------------------------------------------------------------------------

# one entry per cell the run measured (phase_serve, train_cell): the
# config, its shape, the peak since its state was built, the live bytes
ACCOUNTED = []


def live_bytes(tree):
    """Summed nbytes of a tree's tensors."""
    from repro_torch.models.params import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def phase_accounting():
    """The dry run's accounting of every cell in ACCOUNTED at its own
    shape, one card and no mesh (``launch/dryrun_lib.account``: the
    port's step on fake tensors on the host): the counted parameter,
    optimizer-state and cache bytes must equal the live tensors' bytes
    the phase summed; the predicted peak (those bytes plus the
    activations: a train step's, or the larger of the served cell's
    largest prefill dispatch and its decode step) is printed beside the
    measured one, not gated."""
    from repro_torch.launch.dryrun_lib import account
    t0 = time.perf_counter()
    for c in ACCOUNTED:
        t1 = time.perf_counter()
        cfg = c["cfg"]
        if c["kind"] == "train":
            a = account(cfg, "train", c["batch"], c["seq"])
            state, act = a["state"], {"train": a["activation_bytes"]}
            shape = {"batch": c["batch"], "seq": c["seq"],
                     "micro_batches": c["accum"]}
        else:
            n, L = c["prefill"]
            kw = dict(cache_len=SERVE_MAX_LEN, moe_impl=c["moe_impl"])
            pre = account(cfg, "prefill", n, L, **kw)
            dec = account(cfg, "decode", SERVE_SLOTS, 1, **kw)
            state = dec["state"]
            act = {"prefill": pre["activation_bytes"],
                   "decode": dec["activation_bytes"]}
            shape = {"slots": SERVE_SLOTS, "max_len": SERVE_MAX_LEN,
                     "largest_prefill": [n, L]}
        counted = {k: state[k] for k in ("params", "opt_state", "cache")}
        pred = sum(counted.values()) + max(act.values())
        emit({"phase": "accounting", "cell": c["cell"], "shape": shape,
              "counted_bytes": counted, "live_bytes": c["live"],
              "activation_bytes_pred": act, "peak_pred_gb": pred / 1e9,
              "peak_measured_gb": c["peak"] / 1e9,
              "phase_peak_gb": c["phase_peak"] / 1e9,
              "pred_over_measured": pred / c["peak"],
              "allocated_at_start_gb": c["allocated_at_start"] / 1e9,
              "count_s": time.perf_counter() - t1})
        check(counted == c["live"], f"accounting, {c['cell']}: counted "
              f"bytes {counted}, live {c['live']}")
    emit({"phase": "accounting", "cells": len(ACCOUNTED),
          "seconds": time.perf_counter() - t0})


# ---------------------------------------------------------------------------
# the static schedule verifier over every program the run scheduled
# ---------------------------------------------------------------------------

def collect_programs(core):
    """Wrap ``STStream.scheduled_programs`` so that every program a
    stream on the card schedules is kept for :func:`phase_verify`, once,
    as a copy without its kernel closures (which hold tensors; the
    verifier reads none of them), labelled by its windows, grid and
    schedule. Returns {label: [programs]}."""
    import weakref
    kept, seen = {}, {}
    inner = core.STStream.scheduled_programs

    def scheduled_programs(self, **kw):
        progs = inner(self, **kw)
        if self.device is None:
            return progs
        for prog in progs:
            ref = seen.get(id(prog))
            if ref is not None and ref() is prog:
                continue
            seen[id(prog)] = weakref.ref(prog)
            check(all(n.chained is None or n.chained.fn is None
                      for n in prog.nodes), "a chained signal with a fn")
            label = (f"{'+'.join(sorted(prog.windows))}"
                     f"@{'x'.join(map(str, self.grid_shape))}"
                     f":{'fused' if prog.meta.get('fused') else 'plain'}")
            kept.setdefault(label, []).append(core.TriggeredProgram(
                nodes=[dataclasses.replace(n, fn=None) for n in prog.nodes],
                windows=dict(prog.windows), meta=dict(prog.meta)))
        return progs
    core.STStream.scheduled_programs = scheduled_programs
    return kept


def phase_verify(core, kept):
    """The static verifier (``core.verify``) over every program the run
    scheduled on the card (``collect_programs``): the 64-rank Faces
    program (plain, run by st and host, and fused), the 8-rank parity
    programs, the broadcast, ring and a2a programs and the serve programs
    of every ST-routed decode bucket: 0 findings. Then
    ``schedule(verify=True)`` on a fresh lowering of the 64-rank Faces
    program (plain and fused), and the seeded-defect corpus, each of its
    six mutations caught with its kind. Host only."""
    from repro_torch.core.defects import run_corpus
    t0 = time.perf_counter()
    by_label, total = {}, core.VerifyReport()
    for label, progs in sorted(kept.items()):
        report = core.verify_programs(progs)
        by_label[label] = {"programs": len(progs),
                           "nodes": report.checked.get("nodes", 0),
                           "events": report.checked.get("events", 0),
                           "findings": len(report.findings)}
        total.merge(report)
        check(not report.findings, f"verify {label}: {report.summary()}")
    for want in ("faces@4x4x4:plain", "faces@4x4x4:fused", "bcast@",
                 "ring@", "a2a@", "serve@"):
        check(any(label.startswith(want) for label in kept),
              f"no {want} program was scheduled on the card")
    stream = core.STStream(None, AXES, grid_shape=GRID_FULL)
    core.halo.build_faces_program(stream, N_FULL, NITER_FULL)
    kwarg = {}
    for fused in (False, True):
        for seg in core.split_segments(stream.program):
            prog = core.schedule(core.lower_segment(stream, seg),
                                 resources=16, fused=fused, verify=True)
            kwarg["fused" if fused else "plain"] = len(prog.nodes)
    corpus = run_corpus()
    emit({"phase": "verify", "seconds": time.perf_counter() - t0,
          "programs": sum(v["programs"] for v in by_label.values()),
          "nodes": total.checked.get("nodes", 0),
          "events": total.checked.get("events", 0),
          "conflict_pairs": total.checked.get("conflict_pairs", 0),
          "findings": len(total.findings), "by_program": by_label,
          "schedule_verify_64r_nodes": kwarg,
          "mutations": {k: {"detected": v["detected"], "kinds": v["kinds"]}
                        for k, v in corpus.items()}})
    check(len(corpus) == 6 and all(v["detected"] for v in corpus.values()),
          f"seeded defects missed: "
          f"{[k for k, v in corpus.items() if not v['detected']]}")


# ---------------------------------------------------------------------------
# training: the kernels under autograd, granite-3-2b at full width, the
# kernel route against the plain one, a bit-exact restart, rwkv6, jamba
# ---------------------------------------------------------------------------

# granite-3-2b's train cell: float32 masters, bf16 compute, AdamW,
# grad_accum 4 (micro-batches of 2), remat "dots", 8 x 1024 tokens. The
# peak LR is small because the cells start from random weights with no
# long warmup: Adam's first steps move every weight by about the LR, and
# at full width 1e-4 (and 3e-5) made granite's loss swing by several
# nats from step to step, on the plain route as on the kernel route, on
# an H100 (1e-5 moved it down by ~0.9 in a step)
TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH = 6, 1024, 8
TRAIN_LR, TRAIN_WARMUP = 1e-5, 1
# the route check's bounds: float32, loss 1e-5 relative and gradients
# 1e-4 of the largest |grad| (the float32 flash kernel agrees with its
# plain version to ~1e-7 a call); bf16, 2e-2 of each (the kernel and the
# plain version round attention at other points, as in the serve replay)
ROUTE_LOSS_F32, ROUTE_GRAD_F32, ROUTE_BF16 = 1e-5, 1e-4, 2e-2
# the restart check's checkpoint: float32 masters and AdamW moments of
# the 2-layer cut, ~2.7 GB, written inside the checkout and removed
RESTART_DIR = os.path.join(ROOT, "build", "train_restart_ckpt")
# rwkv6-1.6b: 3 steps of 4 x 512 (grad_accum 2); the jamba cut: 3 steps
# of 16 x 256 (grad_accum 16, micro-batches of 1), Adafactor
SHORT_TRAIN_STEPS = 3
# train_kernels: forward calls in one profiled window
FWD_CALLS = 4


def remat_factor(cfg):
    """Forward launches of a kernel per layer and micro-batch: 2 where
    the block's forward is run again in the backward (remat dots, comm,
    full), else 1. The backward itself is the plain version's VJP."""
    return 1 if cfg.remat == "none" else 2


# the autograd Function each wrapper's calls with a gradient go through,
# as the profiler names its forward
TRAIN_FUNCTIONS = {"flash_attention": "FlashAttention", "wkv6": "WKV6",
                   "mamba_scan": "MambaScan"}


def function_launches(name, fn, leaves):
    """FWD_CALLS calls of ``fn`` under the profiler: the kernel launch
    calls the host made inside the Function's forward (the CUDA runtime
    calls the profiler records). The device's records of a window this
    short have gone missing late in a run, so the kernels' device
    launches are counted, and gated, in the train cells' longer profiled
    windows (:func:`train_cell`)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(FWD_CALLS):
            fn(*leaves)
        torch.cuda.synchronize()
    host = 0
    for e in prof.events():
        if "LaunchKernel" in e.name:
            p = e.cpu_parent
            while p is not None and p.name != TRAIN_FUNCTIONS[name]:
                p = p.cpu_parent
            host += p is not None
    return host


def train_kernel_case(name, _build, fn, bare, ref, args, grad_idx,
                      out_grads):
    """One autograd Function at one shape: its forward output against
    the bare kernel's (bit for bit), its gradients against autograd
    through the plain version on the same inputs, the kernel's launches
    in ``FWD_CALLS`` forward calls (:func:`function_launches`) and the
    wrapper's count over one forward and its backward (the backward
    launches none)."""
    leaves = [a.detach().clone().requires_grad_(i in grad_idx)
              if isinstance(a, torch.Tensor) else a
              for i, a in enumerate(args)]
    with torch.no_grad():
        want = bare(*args)
    host = function_launches(name, fn, leaves)
    _build.reset_launches()
    got = fn(*leaves)
    outs = got if isinstance(got, tuple) else (got,)
    torch.autograd.backward(outs[0], out_grads[0])
    torch.cuda.synchronize()
    counted = _build.LAUNCHES[name]
    wants = want if isinstance(want, tuple) else (want,)
    fwd_equal = all(torch.equal(a, b) for a, b in zip(outs, wants))
    plain = [a.detach().clone().requires_grad_(i in grad_idx)
             if isinstance(a, torch.Tensor) else a
             for i, a in enumerate(args)]
    r = ref(*plain)
    r = r if isinstance(r, tuple) else (r,)
    torch.autograd.backward(r[0], out_grads[0])
    gdiff = max(float((leaves[i].grad.float() - plain[i].grad.float())
                      .abs().max()) for i in grad_idx)
    gscale = max(float(plain[i].grad.float().abs().max()) for i in grad_idx)
    finite = all(bool(torch.isfinite(leaves[i].grad).all())
                 for i in grad_idx)
    return {"forward_equal": fwd_equal, "grad_max_abs_diff": gdiff,
            "grad_scale": gscale, "grads_finite": finite,
            "forward_calls_profiled": FWD_CALLS,
            "forward_host_launches": host,
            "wrapper_launches_forward_backward": counted}


def phase_train_kernels(dev, _build):
    """The three autograd Functions at the training shapes (granite's
    attention at 2 x 1024, jamba's at 1 x 256, rwkv6's WKV6 at 2 x 512,
    jamba's scan at 1 x 256) and at one odd S each: forward equal to the
    bare kernel, gradients equal to autograd through the plain version
    (bit for bit: the backward is that computation), one launch per
    forward on the host (:func:`function_launches`) and per forward +
    backward in the wrapper's count."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.kernels.rwkv6 import wkv6_ref
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.kernels.mamba_scan import mamba_scan_ref
    gen = torch.Generator(device=dev).manual_seed(11)
    bf = torch.bfloat16

    def randn(*shape, dtype=bf, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)
                ).to(dtype)
    cases = []
    for label, (B, S, H, KV, hd) in (("granite", (2, 1024, 32, 8, 64)),
                                     ("granite_odd", (2, 1023, 32, 8, 64)),
                                     ("jamba", (1, 256, 64, 8, 128))):
        q, k, v = randn(B, S, H, hd), randn(B, S, KV, hd), randn(B, S, KV,
                                                                 hd)
        pos = torch.arange(S, device=dev, dtype=torch.int32)[None].expand(
            B, S)
        g = randn(B, S, H, hd)
        res = train_kernel_case(
            "flash_attention", _build,
            lambda q_, k_, v_: fa_ops.flash_attention(q_, k_, v_,
                                                      q_positions=pos),
            lambda q_, k_, v_: fa_ops.flash_attention(q_, k_, v_,
                                                      q_positions=pos),
            lambda q_, k_, v_: flash_attention_ref(q_, k_, v_,
                                                   q_offset=pos[:, 0]),
            (q, k, v), (0, 1, 2), (g,))
        cases.append(dict(res, kernel="flash_attention", case=label,
                          shape=[B, S, H, KV, hd]))
    for label, (B, S, H, hd) in (("rwkv6", (2, 512, 32, 64)),
                                 ("rwkv6_odd", (2, 511, 32, 64))):
        r, k, v = randn(B, S, H, hd), randn(B, S, H, hd), randn(B, S, H, hd)
        logw = -torch.exp(randn(B, S, H, hd, dtype=torch.float32) - 2.0)
        u = randn(H, hd, dtype=torch.float32, scale=0.5)
        s0 = torch.zeros((B, H, hd, hd), device=dev)
        g = torch.randn((B, S, H, hd), generator=gen, device=dev)
        res = train_kernel_case("wkv6", _build, wkv_ops.wkv6,
                                wkv_ops.wkv6, wkv6_ref,
                                (r, k, v, logw, u, s0),
                                (0, 1, 2, 3, 4), (g,))
        cases.append(dict(res, kernel="wkv6", case=label,
                          shape=[B, S, H, hd]))
    for label, (B, S, di, ds) in (("jamba", (1, 256, 16384, 16)),
                                  ("jamba_odd", (1, 255, 16384, 16))):
        a_log = randn(di, ds, dtype=torch.float32, scale=0.5)
        dt = torch.nn.functional.softplus(randn(B, S, di, scale=1.0)
                                          .float() - 2.0).to(bf)
        bc = randn(B, S, 2 * ds + 8)          # b, c as column slices
        xc = randn(B, S, di)
        h0 = torch.zeros((B, di, ds), device=dev)
        g = randn(B, S, di)
        b_, c_ = bc[..., 8:8 + ds], bc[..., 8 + ds:]
        res = train_kernel_case("mamba_scan", _build, ms_ops.mamba_scan,
                                ms_ops.mamba_scan, mamba_scan_ref,
                                (a_log, dt, b_, c_, xc, h0),
                                (0, 1, 2, 3, 4), (g,))
        cases.append(dict(res, kernel="mamba_scan", case=label,
                          shape=[B, S, di, ds]))
    for c in cases:
        emit(dict(c, phase="train_kernels"))
    for c in cases:
        check(c["forward_equal"], f"train_kernels {c['kernel']} "
              f"{c['case']}: the Function's forward differs from the "
              "bare kernel")
        check(c["grad_max_abs_diff"] == 0.0, f"train_kernels "
              f"{c['kernel']} {c['case']}: gradients differ from the "
              f"plain version's by {c['grad_max_abs_diff']}")
        check(c["grads_finite"], f"train_kernels {c['kernel']} "
              f"{c['case']}: gradients not finite")
        check(c["forward_host_launches"] == FWD_CALLS
              and c["wrapper_launches_forward_backward"] == 1,
              f"train_kernels {c['kernel']} {c['case']}: "
              f"{c['forward_host_launches']} launches in {FWD_CALLS} "
              "forward calls, "
              f"{c['wrapper_launches_forward_backward']} in one forward "
              f"+ backward, expected {FWD_CALLS} and 1")
    return cases


def train_setup(dev, cfg, seed=0):
    from repro_torch.models import init_params, model_specs, trainable
    from repro_torch.optim import opt_init
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = trainable(init_params(model_specs(cfg), gen, device=dev))
    return params, opt_init(cfg, params)


def device_batch(ds, i, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in ds.batch_at(i).items()}


def grad_gate(cfg, params, batch, label):
    """Every float32 master gets a finite gradient that is not all zero
    (one micro-batch's gradients)."""
    from repro_torch.models.params import tree_paths
    from repro_torch.train.steps import _split, effective_accum, \
        value_and_grad
    mb = _split(batch, effective_accum(cfg))[0]
    _, _, grads = value_and_grad(cfg, "gshard", params, mb)
    paths = [p for p, _ in tree_paths(params)]
    bad_finite = [str(p) for p, g in zip(paths, grads)
                  if not bool(torch.isfinite(g).all())]
    zero = [str(p) for p, g in zip(paths, grads)
            if not bool((g != 0).any())]
    del grads
    check(not bad_finite, f"{label}: gradients not finite at "
          f"{bad_finite[:5]}")
    check(not zero, f"{label}: gradients all zero at {zero[:5]}")
    return len(paths)


# device operations counted as matrix products in a profile (cuBLAS's
# GEMM kernels, nvjet_* on Hopper, and CUTLASS's)
GEMM_KEYS = re.compile(r"gemm|nvjet|xmma|cutlass|sm90_|sm80_|cublas",
                       re.I)


def train_cell(dev, _build, cfg, label, *, steps, seq, batch, kernels,
               layers, warmup=0, profile=True):
    """``steps`` train steps of ``cfg`` (random float32 masters from seed
    0, the config's optimizer, grad_accum and remat) on
    SyntheticTokens(seed=0) batches of ``batch`` x ``seq``; per step its
    loss, aux, lr, ms and the kernels' launches, which must be
    ``layers[k]`` x micro-batches x :func:`remat_factor` for each kernel
    k; then steady step ms, tokens/s, peak GB, one step split into its
    gradients and its optimizer update (host clock, synchronised), and
    one profiled window: with ``profile`` a train step, else one
    micro-batch's forward (the loss, through the Functions), since a
    step of the plain recurrences' backward holds ~10^6 device ops and
    the profiler's own bookkeeping then takes minutes. Of the window:
    device busy ms, idle share against its host time, GEMM and kernel
    ms, the largest device operations, and each kernel's device
    launches. The gates: finite losses, the last below the first, the
    device ran every kernel of the cell in the window, finite nonzero
    gradients for every master."""
    from repro_torch.data import SyntheticTokens
    from repro_torch.optim import cosine_schedule, opt_update
    from repro_torch.models.params import tree_leaves, tree_unflatten
    from repro_torch.train.steps import (_loss_fn, _split, accumulate_grads,
                                         effective_accum, make_train_step)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    allocated = torch.cuda.memory_allocated()
    params, opt = train_setup(dev, cfg)
    n_params = sum(t.numel() for t in tree_leaves(params))
    sched = lambda s: cosine_schedule(s, peak_lr=TRAIN_LR, warmup=warmup,
                                      total=steps)
    step = make_train_step(cfg, schedule=sched)
    ds = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=seq,
                         global_batch=batch, seed=0)
    accum = effective_accum(cfg)
    want = {k: layers[k] * accum * remat_factor(cfg) for k in kernels}
    losses, times = [], []
    for i in range(steps):
        b = device_batch(ds, i, dev)
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = {k: _build.LAUNCHES[k] for k in kernels}
        m = {k: float(v) for k, v in m.items()}
        emit({"phase": "train", "cell": label, "step": i, "loss": m["loss"],
              "aux_loss": m["aux_loss"], "lr": m["lr"], "step_ms": ms,
              "launches": got})
        check(got == want, f"{label}: launches {got} in a train step, "
              f"expected {want} (layers x {accum} micro-batches x "
              f"{remat_factor(cfg)})")
        losses.append(m["loss"])
        times.append(ms)
    peak = torch.cuda.max_memory_allocated() / 1e9
    ACCOUNTED.append({"cell": f"{label} train", "kind": "train", "cfg": cfg,
                      "batch": batch, "seq": seq, "accum": accum,
                      "peak": torch.cuda.max_memory_allocated(),
                      "phase_peak": torch.cuda.max_memory_allocated(),
                      "allocated_at_start": allocated,
                      "live": {"params": live_bytes(params),
                               "opt_state": live_bytes(opt), "cache": 0}})
    steady = statistics.median(times[1:])
    b = device_batch(ds, steps, dev)
    acc_dtype = (torch.bfloat16 if cfg.opt_state_dtype == "bfloat16"
                 else torch.float32)
    t0 = time.perf_counter()
    _, _, grads = accumulate_grads(cfg, "gshard", params, b, accum,
                                   acc_dtype)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    opt_update(cfg, params, tree_unflatten(params, grads), opt,
               sched(opt["count"]))
    torch.cuda.synchronize()
    split = {"grads_ms": (t1 - t0) * 1e3,
             "optimizer_ms": (time.perf_counter() - t1) * 1e3}
    del grads
    if profile:
        window, run, window_ms = "train step", lambda: step(params, opt,
                                                            b), steady
        expect = want
    else:
        mb = _split(b, accum)[0]
        window, run = "micro-batch forward", lambda: _loss_fn(
            cfg, "gshard", params, mb)
        expect = {k: layers[k] for k in kernels}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    prof = device_profile(run, os.path.join(
        OUT_DIR, f"profile_train_{label}.txt"))
    busy = prof["busy_ms"]
    device_launches = kernel_device_launches(prof, kernels)
    line = {"phase": "train", "cell": label, "arch": cfg.name,
            "params": n_params, "layers": cfg.num_layers,
            "compute_dtype": cfg.compute_dtype, "optimizer": cfg.optimizer,
            "opt_state_dtype": cfg.opt_state_dtype, "remat": cfg.remat,
            "grad_accum": accum, "batch": [batch, seq],
            "losses": losses, "step_ms": times, "steady_step_ms": steady,
            "tokens_per_s": batch * seq / (steady / 1e3),
            "peak_gb": peak, "step_split": split,
            "launches_per_step": want,
            "profiled": window, "profiled_host_ms": window_ms,
            "device_busy_ms": busy,
            "idle_share": (None if busy is None
                           else max(0.0, 1 - busy / window_ms)),
            "gemm_device_ms": sum(ms for ms, key, _ in prof["rows"]
                                  if GEMM_KEYS.search(key)),
            "device_ops": prof["device_ops"],
            "top": [[round(ms, 3), key[:120], n]
                    for ms, key, n in prof["top"]],
            "kernel_device_ms": kernel_ms(prof, kernels),
            "kernel_device_launches": device_launches,
            "kernel_launches_in_window": expect,
            "profile_s": time.perf_counter() - t0}
    check(all(math.isfinite(x) for x in losses), f"{label}: a loss is "
          f"not finite: {losses}")
    check(all(device_launches[k] > 0 for k in kernels), f"{label}: the "
          f"device ran {device_launches} of the kernels in the profiled "
          f"{window}, which launched {expect}")
    check(losses[-1] < losses[0], f"{label}: the loss did not fall: "
          f"{losses}")
    line["masters_with_finite_nonzero_grads"] = grad_gate(cfg, params, b,
                                                          label)
    emit(line)
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return line


def phase_train_route(dev, cfg):
    """granite-3-2b cut to 2 layers at full width: one train step's loss
    and gradients (its grad_accum micro-batches of 8 x 1024) through the
    kernels against the plain versions, on the card, in float32 and in
    bf16 compute."""
    from repro_torch.data import SyntheticTokens
    from repro_torch.train.steps import accumulate_grads, effective_accum
    ds = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                         global_batch=TRAIN_BATCH, seed=0)
    b = device_batch(ds, 0, dev)
    out = {}
    for dtype, loss_tol, grad_tol in (("float32", ROUTE_LOSS_F32,
                                       ROUTE_GRAD_F32),
                                      ("bfloat16", ROUTE_BF16, ROUTE_BF16)):
        res = {}
        for route in ("kernel", "plain"):
            c = dataclasses.replace(cfg, num_layers=2, compute_dtype=dtype,
                                    attn_impl=route)
            params, _ = train_setup(dev, c)
            loss, _, g = accumulate_grads(c, "gshard", params, b,
                                          effective_accum(c))
            res[route] = (float(loss), [t.float() for t in g])
            del params
        (lk, gk), (lp, gp) = res["kernel"], res["plain"]
        scale = max(float(t.abs().max()) for t in gp)
        diff = max(float((a - c).abs().max()) for a, c in zip(gk, gp))
        line = {"phase": "train_route", "compute_dtype": dtype,
                "loss_kernel": lk, "loss_plain": lp,
                "loss_rel_diff": abs(lk - lp) / abs(lp),
                "grad_max_abs_diff": diff, "grad_scale": scale,
                "grad_rel_diff": diff / scale, "loss_tol": loss_tol,
                "grad_tol": grad_tol}
        emit(line)
        out[dtype] = line
        check(line["loss_rel_diff"] <= loss_tol, f"train_route {dtype}: "
              f"loss {lk} against {lp}")
        check(line["grad_rel_diff"] <= grad_tol, f"train_route {dtype}: "
              f"gradients {diff} of {scale}")
        del res, gk, gp
        gc.collect()
        torch.cuda.empty_cache()
    return out


def restart_worker():
    """The restart check, in a process of its own, since
    ``torch.use_deterministic_algorithms`` needs CUBLAS_WORKSPACE_CONFIG
    before CUDA starts: the 2-layer cut trained 6 steps, and 3 steps,
    an async Checkpointer save, a restore into fresh tensors and 3 more;
    params and optimizer state bit for bit. Prints one JSON line."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import shutil
    import repro_torch.configs as cfgs
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import SyntheticTokens
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.optim import cosine_schedule
    from repro_torch.train.steps import make_train_step
    torch.use_deterministic_algorithms(True)
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(cfgs.get_config("granite-3-2b"), num_layers=2)
    ds = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                         global_batch=TRAIN_BATCH, seed=0)
    step = make_train_step(cfg, schedule=lambda s: cosine_schedule(
        s, peak_lr=TRAIN_LR, warmup=TRAIN_WARMUP, total=6))

    def train(params, opt, start, n):
        for i in range(start, start + n):
            params, opt, _ = step(params, opt, device_batch(ds, i, dev))
        return params, opt

    pa, oa = train(*train_setup(dev, cfg), 0, 6)
    a = [t.detach().clone() for t in tree_leaves({"p": pa, "o": oa})]
    del pa, oa
    shutil.rmtree(RESTART_DIR, ignore_errors=True)
    pb, ob = train(*train_setup(dev, cfg), 0, 3)
    ck = Checkpointer(RESTART_DIR, keep=1, async_save=True)
    t0 = time.perf_counter()
    ck.save(3, {"p": pb, "o": ob}, {"note": "restart check"})
    save_return_s = time.perf_counter() - t0
    # what the caller does next does not reach the checkpoint
    for t in tree_leaves(pb):
        t.data.mul_(0.5)
    ck.wait()
    save_total_s = time.perf_counter() - t0
    like = tree_map(lambda t: torch.zeros_like(t).requires_grad_(
        t.requires_grad), {"p": pb, "o": ob})
    del pb, ob
    t0 = time.perf_counter()
    restored, at, extra = ck.restore(like, device=dev)
    restore_s = time.perf_counter() - t0
    pc, oc = train(restored["p"], restored["o"], 3, 3)
    c = [t.detach() for t in tree_leaves({"p": pc, "o": oc})]
    size = sum(os.path.getsize(os.path.join(dp, f))
               for dp, _, fs in os.walk(RESTART_DIR) for f in fs)
    shutil.rmtree(RESTART_DIR, ignore_errors=True)
    print(json.dumps({
        "phase": "train_restart", "leaves": len(a), "restored_step": at,
        "extra": extra,
        "bit_identical": all(torch.equal(x, y) for x, y in zip(a, c)),
        "unequal_leaves": sum(not torch.equal(x, y) for x, y in zip(a, c)),
        "checkpoint_gb": size / 1e9, "save_return_s": save_return_s,
        "save_total_s": save_total_s, "restore_s": restore_s,
        "deterministic": torch.are_deterministic_algorithms_enabled()}),
        flush=True)


def phase_train_restart():
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--restart-worker"], env=env, capture_output=True,
                       text=True, timeout=900)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    check(r.returncode == 0 and lines, "train_restart worker failed: "
          f"{r.stderr[-2000:]}")
    line = json.loads(lines[-1])
    emit(line)
    check(line["bit_identical"], f"train_restart: {line['unequal_leaves']}"
          " leaves differ after 3 + restore + 3 steps from 6 steps")
    check(not os.path.exists(RESTART_DIR), "the restart checkpoint was "
          "not removed")
    return line


def phase_training(dev, _build, cfgs, kernels):
    """The training phases; adds each kernel's launches per train step
    to its row of the kernels line. granite's train step is profiled,
    rwkv6's and jamba's micro-batch forward (:func:`train_cell`)."""
    t0 = time.perf_counter()
    phase_train_kernels(dev, _build)
    granite = cfgs.get_config("granite-3-2b")
    check((granite.grad_accum, granite.remat, granite.optimizer)
          == (4, "dots", "adamw"), "granite-3-2b's training knobs")
    g = train_cell(dev, _build, granite, "granite-3-2b",
                   steps=TRAIN_STEPS, seq=TRAIN_SEQ, batch=TRAIN_BATCH,
                   kernels=("flash_attention",),
                   layers={"flash_attention": granite.num_layers},
                   warmup=TRAIN_WARMUP)
    phase_train_route(dev, granite)
    phase_train_restart()
    rwkv = dataclasses.replace(cfgs.get_config("rwkv6-1.6b"))
    check((rwkv.grad_accum, rwkv.remat) == (2, "dots"), "rwkv6's knobs")
    r = train_cell(dev, _build, rwkv, "rwkv6-1.6b",
                   steps=SHORT_TRAIN_STEPS, seq=512, batch=4,
                   kernels=("wkv6",), layers={"wkv6": rwkv.num_layers},
                   profile=False)
    jamba = dataclasses.replace(cfgs.get_config("jamba-1.5-large-398b"),
                                num_layers=3, moe=None)
    specs = jamba.layer_specs()
    check(specs == [("attn", "dense"), ("mamba", "dense"),
                    ("mamba", "dense")], "the jamba cut's layers")
    check((jamba.optimizer, jamba.opt_state_dtype, jamba.grad_accum)
          == ("adafactor", "bfloat16", 16), "jamba's training knobs")
    j = train_cell(dev, _build, jamba, "jamba-3-layer-cut",
                   steps=SHORT_TRAIN_STEPS, seq=256, batch=16,
                   kernels=("mamba_scan", "flash_attention"),
                   layers={"mamba_scan": 2, "flash_attention": 1},
                   profile=False)
    per_step = {"flash_attention": {"granite-3-2b": g["launches_per_step"]
                                    ["flash_attention"],
                                    "jamba-3-layer-cut":
                                    j["launches_per_step"]
                                    ["flash_attention"]},
                "wkv6": {"rwkv6-1.6b": r["launches_per_step"]["wkv6"]},
                "mamba_scan": {"jamba-3-layer-cut":
                               j["launches_per_step"]["mamba_scan"]}}
    for row in kernels:
        if row["name"] in per_step:
            row["train_launches_per_step"] = per_step[row["name"]]
    emit({"phase": "training", "seconds": time.perf_counter() - t0})


def main():
    ap = argparse.ArgumentParser(description="Smoke test of the port on "
                                 "one NVIDIA card (see the docstring).")
    ap.add_argument("--ab", metavar="DIR", help="time the recurrent "
                    "kernels and the Faces path of this tree against "
                    "DIR's")
    ap.add_argument("--ab-worker", metavar="TREE", help=argparse.SUPPRESS)
    ap.add_argument("--restart-worker", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--only", choices=("train", "faces"), help="run the "
                    "build and only these phases: training (no result "
                    "lines), or the Faces kernels, parity, full and timing "
                    "phases (their kernel rows as result lines)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one "
              "NVIDIA card", file=sys.stderr)
        return 2
    if args.ab_worker:
        ab_worker(os.path.realpath(args.ab_worker))
        return 0
    if args.restart_worker:
        restart_worker()
        return 0
    if args.ab:
        ab(args.ab)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        print(smi.stdout.strip())
        return 0
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch.core as core
    from repro_torch.kernels import _build
    from repro_torch.kernels import counter_bump as cb
    from repro_torch.kernels.halo_pack import ops as hp
    from repro_torch.kernels.halo_pack import ref as hp_ref
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref)
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.rwkv6 import wkv6, wkv6_ref
    from repro_torch.kernels.rwkv6.ref import wkv6_chunked
    from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_ref
    import repro_torch.configs as cfgs
    import repro_torch.models as models
    import repro_torch.serving as serving_mod

    scheduled = collect_programs(core)      # for phase_verify, at the end
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    os.makedirs(OUT_DIR, exist_ok=True)
    emit({"phase": "start", "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})
    phase_build(_build)
    if args.only == "train":
        phase_training(dev, _build, cfgs, [])
        phase_accounting()
        emit({"phase": "done", "seconds": time.perf_counter() - t_start})
        return 0
    errs = phase_kernels(dev, core, hp, hp_ref, cb)
    if args.only == "faces":
        phase_parity(core, dev)
        launches, dispatches = phase_full(core, _build, dev)
        for row in phase_timing(core, hp, hp_ref, cb,
                                _build.load("counter_bump"), dev, launches,
                                dispatches, errs):
            emit(dict(row, phase="kernel_row"))
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        emit({"phase": "done", "seconds": time.perf_counter() - t_start,
              "card": smi.stdout.strip()})
        return 0
    mcast_err = phase_multicast(dev, core, cb)
    attn = (flash_attention, flash_attention_ref, decode_attention,
            decode_attention_ref)
    attn_errs = phase_attention(dev, *attn)
    wkv_errs = phase_wkv6(dev, wkv6, wkv6_ref)
    scan_kernel_errs = phase_mamba_scan(dev, mamba_scan, mamba_scan_ref)
    phase_parity(core, dev)
    launches, dispatches = phase_full(core, _build, dev)
    kernels = phase_timing(core, hp, hp_ref, cb, _build.load("counter_bump"),
                           dev, launches, dispatches, errs)
    fetch_probe(dev, _build.load("halo_pack"))
    gc.collect()                    # the Faces streams and their graphs
    torch.cuda.empty_cache()
    pattern_launches = phase_patterns(dev, core, _build, cfgs)
    kernels.append(multicast_row(core, cb, dev, {
        f"{case}:{m}": v["put_multicast"]
        for case, by_mode in pattern_launches.items()
        for m, v in by_mode.items() if v["put_multicast"]}, mcast_err))
    for row in kernels:             # the transports' launches too
        if row["name"] in ("counter_bump", "put_signal"):
            row["patterns_launches"] = {
                f"{case}:{m}": v[row["name"]]
                for case, by_mode in pattern_launches.items()
                for m, v in by_mode.items()}
    gc.collect()
    torch.cuda.empty_cache()
    serving = {"configs": cfgs, "models": models, "serving": serving_mod,
               "graphs": core.graphs}
    granite_kernels = {"prefill": {"flash_attention": "attn"},
                       "decode": {"decode_attention": "attn"}}
    cfg, serve_launches, counts, groups, _, params, reqs = phase_serve(
        dev, _build, serving, cfgs.get_config("granite-3-2b"),
        dict(num_layers=40, d_model=2048, num_heads=32, num_kv_heads=8,
             d_ff=8192, vocab_size=49155), granite_kernels)
    phase_router(dev, serving)
    st_launches = {cfg.name: phase_st_serve(
        dev, _build, serving, cfg, params, reqs, granite_kernels, MODES)}
    for row in kernels:             # the serve program's launches too
        if row["name"] in ("counter_bump", "put_signal"):
            row["st_serve_launches_per_decode_step"] = {
                f"{cfg.name}:{m}": v[row["name"]]
                for m, v in st_launches[cfg.name].items()}
    kernels += attention_rows(dev, *attn, cfg, serve_launches, counts,
                              groups, attn_errs)
    for row in kernels:
        emit(dict(row, phase="kernel_row"))
    phase_replay(dev, serving, cfg, params, reqs)
    del params, reqs                        # granite's weights go first
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, _, counts, groups, per, params, reqs = phase_serve(
        dev, _build, serving, cfgs.get_config("rwkv6-1.6b"),
        dict(num_layers=24, d_model=2048, num_heads=32, head_dim=64,
             d_ff=7168, vocab_size=65536, rwkv=cfgs.RWKVConfig(64)),
        {"prefill": {"wkv6": "rwkv"}, "decode": {"wkv6": "rwkv"}},
        redraw=rwkv_redraw)
    kernels.append(wkv6_row(dev, wkv6, wkv6_ref, cfg, counts, per, groups,
                            wkv_errs))
    emit(dict(kernels[-1], phase="kernel_row"))
    phase_replay(dev, serving, cfg, params, reqs,
                 shadow=(models.rwkv, "wkv6", wkv6, wkv6_ref, "rwkv"),
                 spread=(models.rwkv, "wkv6_ref", wkv6_reordered,
                         {"reordered": wkv6_reordered,
                          "chunked": wkv6_chunked}))
    del params, reqs                        # rwkv's weights go next
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    scan_shadow = (models.mamba, "mamba_scan", mamba_scan, mamba_scan_ref,
                   "mamba")
    jamba = dataclasses.replace(cfgs.get_config("jamba-1.5-large-398b"),
                                num_layers=JAMBA_LAYERS)
    jamba_kernels = {
        "prefill": {"flash_attention": "attn", "mamba_scan": "mamba"},
        "decode": {"decode_attention": "attn", "mamba_scan": "mamba"}}
    cfg, _, counts, groups, per, params, reqs = phase_serve(
        dev, _build, serving, jamba,
        dict(num_layers=JAMBA_LAYERS, d_model=8192, num_heads=64,
             num_kv_heads=8, head_dim=128, d_ff=24576, vocab_size=65536,
             moe=cfgs.MoEConfig(num_experts=16, top_k=2, expert_ff=24576),
             mamba=cfgs.MambaConfig(d_state=16, d_conv=4, expand=2)),
        jamba_kernels, redraw=mamba_redraw, profile_rows=JAMBA_PROFILE_ROWS)
    jamba_st = phase_st_serve(dev, _build, serving, cfg, params, reqs,
                              jamba_kernels, ("st",))
    for row in kernels:
        if row["name"] in ("counter_bump", "put_signal"):
            row["st_serve_launches_per_decode_step"][f"{cfg.name}:st"] = \
                jamba_st["st"][row["name"]]
    kernels.append(mamba_scan_row(dev, mamba_scan, mamba_scan_ref, cfg,
                                  counts, per, groups, scan_kernel_errs))
    emit(dict(kernels[-1], phase="kernel_row"))
    phase_replay(dev, serving, cfg, params, reqs, shadow=scan_shadow,
                 f32=False)
    torch.cuda.empty_cache()
    # the same weights and traffic with the expert-parallel MoE (one
    # shard), beside the dense MoE
    a2a_run = phase_serve(
        dev, _build, serving, jamba,
        dict(num_layers=JAMBA_LAYERS, d_model=8192), jamba_kernels,
        profile_rows=JAMBA_PROFILE_ROWS, moe_impl="a2a", params=params)
    phase_a2a_serve(dev, serving, cfg, params, (counts, reqs),
                    (a2a_run[2], a2a_run[6]))
    del params, a2a_run                     # jamba's 46 GB go first
    torch.cuda.empty_cache()
    cut = dataclasses.replace(cfg, num_layers=3, moe=None)
    check(cut.layer_specs() == [("attn", "dense"), ("mamba", "dense"),
                                ("mamba", "dense")], "no-expert cut layers")
    phase_replay_cut(dev, serving, cut, "no experts", reqs,
                     shadow=scan_shadow, redraw=mamba_redraw)
    del reqs
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels += phase_deepseek(dev, _build, serving, cfgs, attn, attn_errs)
    kernels += phase_short_serves(dev, _build, serving, cfgs, attn,
                                  attn_errs, granite_kernels)
    kernels += phase_vision(dev, _build, serving, cfgs, attn, attn_errs)
    phase_musicgen(dev, _build, serving, cfgs, granite_kernels)
    phase_training(dev, _build, cfgs, kernels)
    phase_accounting()
    phase_verify(core, scheduled)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "kernel_rows": [row["name"] for row in kernels]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(json.dumps({"kernels": kernels}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
