#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero without the
final line:
  1. device  — require CUDA; the card's name and power limit (nvidia-smi),
               torch and CUDA versions;
  2. build   — compile every kernel from ``src/repro_torch/kernels/*/csrc``
               with nvcc for sm_90a (one nvcc per source, K2a / K2b's as
               5 translation units linked into one library, all in
               parallel); prints each source's and unit's seconds, each to
               its own exit, and the slowest;
  3. kernels — each CUDA kernel against its plain PyTorch version on the
               card at the main path's full-width shapes and at edge shapes,
               with the tolerance stated; kernel / plain / library times
               (CUDA events, warmed up, L2 warm; K6 below) and the roofline
               bound;
               each K1 and K3 case names its variant ("tc": 3xTF32
               mma.sync — every K1 call, every K3 mask block of 128;
               "simt": K3's 64 and 48 edge cases), is bitwise equal on a
               repeat, and at the main shapes the distance of K1's output
               and K3's product from a float64 computation must be at most
               twice that of the fp32 plain version (torch.matmul for K3;
               allow_tf32 False); K1, K2a, K2b and K3 also print the bound
               of the 3xTF32 route (three TF32 passes);
  3b.        the paged decode attention K6 (its pages cut into
               ``pa_splits`` ranges merged in a fixed order) at the serve's
               decode shape (b 4, nq 15, nkv 5, hd 64, page 16, J 66),
               holes and an empty lane, page 4 / hd 16 fp32, page 64 /
               hd 128 (G 8), lanes shorter than the split count, bf16 q,
               and the long shape (every lane at 2048 tokens, J 128): each
               prints its split count and blocks, within 1e-4 of the plain
               version (bf16 out: one bf16 rounding), bitwise on a repeat,
               empty lanes exactly 0; the main shape must split and run at
               least 132 blocks.  Times by CUDA-graph replay: 32 launches
               over 32 distinct pools (~347 MB, past the 50 MB L2: cold)
               and over one pool (warm) at the main and the long shape,
               replay bitwise equal to eager; SDPA on pre-gathered pages
               graph-replayed (warm) as the library time; the eager times
               on a line of their own;
  3c.        the backward sweeps K2a (dq) and K2b (dk/dv) at the training
               shapes (dense causal, a 512-block mask with dead tiles,
               partial blocks, fully masked rows, d 128, bf16), both on
               the tensor cores (K2a names its variant, K2b runs over its
               work schedule), both bitwise equal on a repeat; at the main
               shape K2a's dq at most twice the fp32 plain version's
               distance from a float64 dq from the same lse and delta;
  3d.        K3's backward products (dx, dw for a mask over N and over K,
               dense and 87 % pruned) against torch.matmul, all on the
               tensor-core variant, bitwise on a repeat, within twice
               torch.matmul's distance from float64;
  3e.        the grouped expert matmul K4 (forward and as dx on a
               transposed weight view) and its weight gradient K5 at the
               Mixtral-8x7B training shapes (b 2, s 1024, cap 320, 16
               groups; K / N = 4096 / 14336 and 14336 / 4096; counts from
               a seeded router), at the serve prefill and decode shapes
               (cap 4, counts 0/1), and at edge cases (empty and full
               groups, cap off the row tile, a placement, garbage in dead
               rows), fp32 and bf16; each case names the variant that ran
               ("tc": wgmma on TMA-fed shared memory, every bf16 call with
               cap > 16 and K, N multiples of 8; "simt": the rest), and the
               bf16 edge cases (cap 200, K 328, N 392, the w^T view) reach
               the tensor-core variant; K5's time against its live rows
               (0 to 10 64-row chunks a tile, fp32 and bf16 out);
  3f.        every kernel at the block families' shapes, fp32 unless
               said: K1, K2a and K2b at whisper's encoder (non-causal
               1500, a ragged tail), its cross attention (448 x 1500) and
               its decoder (448 causal), the zamba2 shared block (32 heads
               of 64), InternVL2 (s 768, hd 128, GQA 48:8) and gpt-paper
               (s 2048, hd 32); K3 forward and backward at whisper's FFN
               (M 1500, d 1280, d_ff 5120, masks over N and over K); K6 at
               hd 128 (48 / 8 heads) and hd 32, split; K4 and K5 at
               Mixtral-8x22B's expert shape (d 6144, d_ff 16384, bf16);
               each within its plain version, on the tensor cores (K6:
               split), at most twice the plain version's distance from
               float64, with its time, plain and library times and bound;
  4. serve   — the port's serving path through its CLI entry point:
               full-width smollm-360m, one stage, paged KV + prefix cache,
               sparse attention, kernel_impl "pallas"; launch counters are
               zeroed just before and read just after, and every kernel of
               the path must have launched, every K1 and K3 launch on the
               tensor cores, every K6 launch cut into splits
               (``k6_split_launches``);
  4b. profile — device time by kernel over a shorter serve (4 requests)
               under torch.profiler (device activity only: 4b, 4d and 4g
               read the kernels' times alone), and the device's busy share
               against the same serve's wall time without the profiler;
  4c. train  — the port's training path through its CLI entry point:
               full-width smollm-360m (32 layers), two stage buffers, 4
               microbatches of 2 x 1024 tokens, 15 steps with the prune at
               step 10 and a rebalance cadence every 5 steps under a 2x
               straggler; counters zeroed just before and read just after:
               per step K1 128, K2a 128, K2b 128, K3 384 forward + 768
               backward launches, every K1, K2a, K2b and K3 launch on the
               tensor cores; a migration must move layers;
  4d. profile — two train steps under torch.profiler: busy share and
               device time by kernel;
  4e. moe train — the training CLI on full-width Mixtral-8x7B cut to 2
               layers (2 stage buffers of one layer, --slot-slack 0, bf16
               params, AdamW), 4 microbatches of 2 x 1024 tokens, 8 steps,
               --dynamism moe with live expert re-layout (watermark 1.01,
               min tokens 1, cadence 3); counters zeroed just before and
               read just after: per step K4 48 (24 forward + 24 as dx), K5
               24, K1 / K2 / K3 0 (the sliding window sends attention down
               the scan path), every K4 and K5 launch on the tensor-core
               variant; a re-layout must move experts;
  4f. moe serve — the serving CLI on full-width Mixtral-8x7B cut to 4
               layers, fp32, one stage, 2 x 4 lanes, 8 requests, prompts
               512–1024, up to 16 generated, contiguous KV (the sliding
               window forbids paging); K4 in every prefill and decode;
               moe_dropped_mean in [0, 1);
  4g. profile — two MoE train steps under torch.profiler;
  4h. elastic train — the training CLI on full-width smollm-360m with 4
               stage buffers of 16 slots (--slot-slack 8), 4 microbatches
               of 2 x 1024 tokens, 20 steps, the prune at step 10,
               --repack at the default memory cap and --grow-back 5;
               counters zeroed just before and read just after: the
               controller's own repack decision must shrink 4 -> 2 and the
               grow-back restore 4, the pool log release the tail workers
               and grant them back, every loss finite, every K1, K2a, K2b
               and K3 launch on the tensor cores at the 4c per-step counts;
               prints per resize its seconds (the card synchronized),
               ticks and torch.cuda.memory_allocated before and after
               (which must fall after the shrink), and the step ms in each
               world;
  4i. elastic serve — the serve CLI's server on full-width smollm-360m with
               4 stage buffers, paged KV (page 16), 8 requests with prompts
               of 512-1024 tokens, once fixed and once with resize_at
               {8: 2, 16: 4}: completions token-identical, the page pool
               bitwise equal after one more shrink / grow cycle on the live
               state (the trash block excluded), every K6 launch split;
  4j. early exit — the training CLI with --dynamism early_exit (2 stage
               buffers, 5 steps, the exited share printed every step; K1,
               K2a, K2b and K3 at the 4c per-step counts on the tensor
               cores) and the serve CLI with --dynamism early_exit
               --early-exit-frac 0.5 (K1 and K3 on the tensor cores, every
               K6 launch split), the counts zeroed just before each of the
               two and read just after;
  4k. safe points — the training CLI at 4h's flags without --grow-back,
               smollm-360m at its widths cut to 8 layers (CUT_LAYERS),
               17 steps, --ckpt-every 8 into a temporary directory (the
               roomier of TMPDIR and build/, deleted after phase 7): safe
               points after step 7 (4 buffers) and 15 (2, after the
               controller's shrink at 14); then resumed from 15 through
               Session.resume (the resumed RunSpec must equal the one that
               wrote the safe point): the tail's losses, resizes, pool
               log, final params and Adam moments bitwise the
               uninterrupted run's (its resume from 7, which must prune at
               10 and shrink at 14 on its own decision, reads 7f's
               rank-written safe point in phase 7) (on
               a difference the phase names the first differing step and
               the largest leaf difference, runs the uninterrupted run
               twice more and prints whether it repeats itself); prints
               each safe point's bytes and save seconds (device -> host,
               npz, sha256), each restore's seconds, memory_allocated after
               it and its growth over the phase's live state (the
               restored world alone); K1, K2a, K2b and K3 at the 4c counts
               a step over the 18 steps, all on the tensor cores;
  4l. control timing — (i) an engine with in-step timing (CUDA events
               around each stage's forward) on a [26, 2, 2, 2] split over
               4 buffers, 4 steps: the in-step times and the isolated probe
               must both rank stage 0 slowest, strictly above each 2-layer
               stage; (ii) the training CLI on 2 buffers, 8 steps, smollm
               at its widths cut to 8 layers (``CUT_LAYERS``; a 4x
               straggler, as at 8 layers a 2x one moves nothing),
               --straggler 1:4.0 --rebalance-every 4 --in-step-timing
               --measure-stage-times, inline and with --async-controller
               --async-drain (bitwise equal where their decisions agree:
               measured times differ from run to run), and the same flags
               untimed, inline and async + drain: losses, events and stage
               history bitwise equal; (iii) async without the drain must
               decide; the untimed inline run against the timed one is the
               events' overhead; the probe alone; prints per-stage in-step
               and probe seconds at each
               cadence beside the cost model's per-stage loads, step ms at
               the cadence steps and after them in each mode, the training
               thread's decide seconds; (ii), (iii) and the untimed run
               launch K1-K3 at a quarter of the 4c counts a step, all on
               the tensor cores;
  4m. sampling serve — phase 4's serve at temperature 0.8 (a Philox
               sampler per lane, Gumbel-max): counted and timed; two more
               runs with every draw recorded must give bitwise-equal ids and
               logprobs and the counted run's tokens; a plain-version run
               must give the same ids up to each request's first draw whose
               perturbed top-2 gap (read from the plain run) is <= 1e-3
               (prints the tokens compared and the requests that flip
               later); the streams must differ from phase 4's argmax
               streams except a full-length prompt's first token (the
               prefill's argmax); the sampler alone on [8192, 49152]
               logits: Philox words bitwise the CPU's (every 32nd lane), a
               chi-squared test over the 32 likeliest ids plus the rest
               against softmax(logits / T) at p >= 1e-4, and its ms per
               decode tick (CUDA events) beside the argmax head's;
  4n. autoscaled train — 4h's flags without --grow-back, 8 layers (as
               4k), 20 steps,
               --async-controller --async-drain --autoscale
               --simulate-recover 18: (i) the pool behind a file manager in
               its own process (the RPC round trip timed every step), (ii)
               the same flags in process, (iii) as (i) under RPC chaos — a
               pinned FaultSpec kills the manager after step 12 and
               respawns it after step 16, loses and duplicates 30 % of the
               messages, and the run is traced: (i) must shrink 4 -> 2
               releasing [2, 3] and grow them back at >= 18 with pool log
               release:2, release:3, grant:2, grant:3 and an autoscale grow
               naming {2, 3}; (i) and (ii) bitwise in losses, resizes,
               params and Adam moments; (iii) must defer the release and
               replay it, its losses, resizes, params and Adam moments
               bitwise (i)'s, its fault log holding rpc_loss and rpc_dup
               records (each lost request answered under its own sequence
               number unless the manager was down, the manager's journal
               and the client's pool log equal, no worker twice), its
               trace passing scripts/torch_check_trace.py, its step ms
               beside (i)'s and the respawned manager's first answer timed;
               K1-K3 at the 4c counts a step over the three runs, on the
               tensor cores;
  4o. autoscaled serve — 4i's server on two bursts of 16 requests 48
               ticks apart with the serving autoscaler (min 2 stages,
               queue watermark 2, occupancy 0.6, patience 2, cooldown 3):
               a load-driven shrink and grow, tokens identical to the fixed
               world's, the page pool bitwise through one more resize
               cycle, every K6 launch split;
  4p. two tenants — an HTTP manager over 6 workers, a trainer process
               (tenant train, priority 0, 4 buffers, 32 steps) and a
               server process (tenant serve, priority 10, 4o's trace and
               knobs) on the one card: serve steals, train is preempted
               and shrinks at a safe point, the lull yields and train
               absorbs (from both --events-out streams); the scheduler's
               metrics verb replays to its own books with no worker held
               twice; both tenants traced: the manager's GET /metrics,
               scraped before shutdown, counts exactly the events stream's
               (tenant, event) pairs, and the two traces hold the chain
               rpc.steal -> cluster.preempt -> resize.shrink
               (scripts/torch_check_trace.py); each process's launch
               counts (K1-K3 on the tensor cores, K6 split) and peak
               memory;
  4q. front door — (i) train_args()'s RunSpec written by the train CLI's
               --dump-config, 6 steps trained from it through the train
               CLI's --config: losses bitwise 4c's first 6, the same
               rebalance events, K1-K3 at 4c's counts a step on the tensor
               cores; (ii) phase 4's serve written the same way and served
               by Session(RunSpec.load(path)).serve(): tokens identical to
               phase 4's, K1, K3 and K6 launched, every K6 launch split;
               (iii) the one-shot run_serving at full width (1 stage,
               micro 2, mb 4, prompt 1024, gen 32) token-identical to
               ElasticServer on the same batch arriving at once, its
               tokens/s printed; (iv) the six configs/scenarios/*.json, 3
               steps each on the card (CPU scale, the scan path); (v)
               phase 4k resumed its safe point through Session.resume
               with the RunSpec that wrote it;
  4r. faults — (i) 4n (i)'s training with a pinned FaultSpec: worker 2
               crashes after step 4 (it stops beating), a 2.5x straggler
               spike after step 14; the heartbeat -> autoscaler -> evict
               path must evict it (an evict resize, fail:2 in the pool
               log), every loss finite and within 3e-3 (the reference
               soak's LOSS_TOL) of 4n (i)'s and bitwise up to the step at
               which the stage histories part; prints the time to recover
               (the crash to the first step on the smaller world, in steps
               and seconds); (ii) 4i's server with worker 2 crashing at
               tick 8 (one spare, no autoscale), /metrics on a free port
               and in-step timing: 4i's request set, requests requeued, an
               evict, every K6 launch split, each request's tokens 4i's
               fixed run's up to its first token whose fixed-run top-2 gap
               is <= 1e-3 (the flips and their gaps printed; a requeued
               request's replayed positions are decoded, not written by
               the prefill as the fixed run's prompt was, so a near-tie may
               flip), GET /metrics scraped before the session closes
               (dynmo_serve_tokens_total = the emitted positions = the
               completions' tokens + the positions requeued lanes
               replayed), the stage times
               from the in-step events and the tick p50 beside 4i's;
               K1-K3 at the 4c counts a step on the tensor cores;
  5. parity  — one prefill and 8 teacher-forced decode steps from one engine
               state, through the kernels and through the plain versions;
  5b. train parity — loss and every gradient of one training step (full
               widths, 4 layers, 2 stages, half the FFN blocks pruned)
               through the kernels and through the plain versions;
  5c. moe parity — full-width Mixtral-8x7B cut to 2 layers, fp32: one
               train step's loss and gradients, and one prefill plus 8
               teacher-forced decode steps, kernels vs plain versions; the
               same train step in bf16 (the tensor-core variant; loss
               within 1e-3 relative, each gradient leaf within 2e-2 of its
               largest entry); moe_ffn under the identity and two expert
               placements, fp32 and bf16, y, load and drop fraction bitwise
               equal;
  5d. ee / mod parity — one early-exit training step (32 layers, 2 stage
               buffers; every token exits at the default threshold 0.98,
               and a second case at 0.982 must leave some tokens live and
               exit others) through the kernels and the plain versions,
               each case: the loss within 1e-4 relative; the plain
               versions replaying the kernel run's exit marks (the same
               function) within 1e-4 (loss) and 1e-3 of each gradient
               leaf's largest entry; printed: the least |cos - threshold|
               of each run's exit decisions, how many exit marks the two
               free runs set differently and the free runs' worst leaf
               (a token within ~1e-7 of the threshold may exit a layer
               apart), the exited share and the exits by layer; one
               --dynamism mod step's loss and stage gradients bitwise the
               none step's from the same params; an early-exit prefill + 8
               decode steps, ids equal where the plain run's top-2 gap
               exceeds 1e-3;
  6a. whisper — whisper-large-v3 at its published widths cut to 8
               encoder + 8 decoder layers (32 + 32 at full size; 16 + 16
               in PR 26) trained through the train CLI: 2 stage buffers
               of 8 slots, 2 microbatches of one sample (1500 frames from
               the loader, 448 decoder tokens), fp32, block remat, 12
               steps with the prune at step 10 inside the run; K1 96,
               K2a / K2b 48, K3 256 launches a step, all on the tensor
               cores;
               tokens/s, step ms, peak memory, two
               profiled steps (busy share); one step's loss and gradients
               at full width cut to 4 + 4 layers through the kernels and
               the plain versions (1e-4, 1e-3); a full-size prefill (1500
               frames, a 432-token prompt) and 16 scalar-position decode
               steps through build_prefill_fn / build_decode_fn, ids equal
               to the plain run's where its top-2 gap exceeds 1e-3;
  6b. zamba2 — zamba2-1.2b at full size trained through the CLI (2
               buffers of 27 slots, 4 x 2 x 1024 tokens, 8 steps, a 2x
               straggler, the partition balancer every 4 steps): the net
               migration must move MAMBA and HYBRID_ATTN layers; K1 / K2a
               / K2b at the shared block's 32 heads of 64, on the tensor
               cores; two profiled steps; served with contiguous KV once
               fixed and once shrunk 2 -> 1 at tick 6, tokens identical;
  6c. xLSTM — xlstm-1.3b at published widths cut to 4 layers (sLSTM at
               3): 12 steps at seq 256 with the prune of the mLSTM
               up-projection at step 10, then a serve of 4 requests; no
               kernel runs on this path (every count 0), step time printed;
  6d. InternVL2 — internvl2-26b at published widths cut to 4 layers,
               bf16, the loader's 256 patch embeddings before 512 tokens:
               K1 at s 768 / hd 128 and K3 at d 6144 / d_ff 16384 on the
               tensor cores; cut to 8 layers, fp32, a text-only paged serve
               of 4 requests through K1, K3 and K6 at hd 128, every K6
               launch split;
  7d. ranks — full-width, full-depth smollm-360m trained as 4 processes
               (``--procs 4 --stages 4``, data 1), one stage each, all on
               the one card: gloo through pinned host copies (NCCL refuses
               two ranks on one device), phase 4h's flags and schedule:
               the controller's repack shrink 4 -> 2 at step 14 releases
               ranks 2 and 3 to the job manager (they hold nothing: each
               one's memory_allocated at most 64 MiB after it), the grow at
               step 19 binds them back; the resizes, pool log, stages and
               losses those of 4h's one process (bitwise, or the first
               differing step named and held to 1e-6), the launches summed
               over the ranks 4h's (all on the tensor cores, every rank
               launching); per rank memory_allocated / memory_reserved
               before the shrink, after it and after the grow, the
               nvidia-smi per-process memory, the rows and bytes each
               resize moved and its seconds, K1-K3 launches, peak memory
               and staging / send / receive seconds, beside the card's
               name and power limit (four processes time-slice one card:
               no speed-up is claimed); the hand-off's own ms (two ranks
               pass a 7.9 MB carry back and forth, both waiting);
  7e.        phase 4i's elastic paged serve as 4 ranks, one stage each,
               with its resize_at: tokens identical to 4i's, K6 launched
               in every rank on its own layers (every launch split) with
               sums equal to 4i's, the page pool gathered whole bitwise
               4i's (the trash block excluded), each rank's memory around
               the shrink, the tick p50 beside 4i's;
  7b.        smollm-360m at its published widths cut to 8 layers, 3 steps
               with a migration after step 1 (a 4x straggler), as 4 ranks
               and as one process with 4 stage buffers: the migration
               moves rows across ranks; losses, final params, Adam moments
               and dyn state bitwise (a difference is named and held to
               rtol 1e-6);
  7c.        the one-shot serve of full-width smollm-360m (8 prompts of
               1024 tokens, 16 generated) as 4 ranks, each holding its
               stage's rows and KV cache: tokens identical to the one
               process's, K1 and K3 summed over the ranks equal to its
               counts;
  7b async.  7b's flags with --async-controller and no drain as 4 ranks:
               every rank applies the same plans at the same steps (the
               agreement hash and each rank's applied list); where those
               are the inline run's steps, the losses bitwise its losses;
  7f.        4k's flags as 4 ranks writing their own safe points after
               steps 7 and 15 (each rank its stage's shard, rank 0 also
               common.npz): losses, resizes and pool log bitwise 4k's,
               both safe points' index and every array bitwise 4k's (the
               zip entries' timestamps aside); the ranks resume from their
               step 15 (the 2-buffer world: ranks 2 and 3 start released
               and read nothing) and from 4k's one-process step 7; 4k's
               one process resumes from 7f's step 7 (its RunSpec the
               ranks' writer's): each tail's losses, resizes, pool log and
               final params and moments (per-row sha256) bitwise 4k's,
               each rank of the safe point's world reading common.npz and
               its own shard only and holding less than the whole model
               after the restore; per rank the safe points' seconds, bytes
               and files, the restore's seconds, memory_allocated and
               files, beside 4k's one-process seconds;
  7g.        4r (ii)'s serve with worker 2 crashing at tick 8 as 4 ranks:
               tokens, requeues and the evict 4r's, K6 launched in every
               rank and split; 4n (iii)'s RPC-chaos training as 4 ranks
               (the status calls through rank 0's client): the losses and
               final state bitwise 4n (i)'s, the fault log, pool log,
               resizes and degraded-mode events (iii)'s; then 7b's flags
               with a safe point after step 1 and a trainer_kill after it:
               every rank of the launch SIGKILLed (the launch raises
               naming it, no rank process left), Session-resumed as 4
               ranks in a second launch, its tail and final state bitwise
               7b's one process, the kill not firing again; 7b prints
               [rank_step_parts]: a step's wall per rank cut into sends,
               waits for a peer's carry, staging copies, the replicated
               leaves' gradient sum, the data sums and the rest;
  7h.        every block family across ranks (PR 27), one launch of 2
               ranks (data 1 x model 2) after 7b-7g's has exited: 4e's
               Mixtral-8x7B training (2 layers at published widths, bf16,
               8192 tokens a step, live re-layout) as 2 ranks: losses,
               re-layouts, placements, each decision's skew and drop
               fraction and every rank's committed layout bitwise 4e's,
               the final rows and replicated leaves 4e's (``fingerprint``
               digests taken on the card), K4 and K5 summed over the ranks
               4e's counts a step, all on the tensor cores, both ranks
               launching both; per rank peak memory, step ms, hand-offs
               and their bytes, and [rank_step_parts];
  7i.        6b's zamba2-1.2b training at full size, its first 5 steps,
               as 2 ranks: losses, the migration after step 3 (rows moved
               across the ranks, sent = received), each step's split and
               the moved block types bitwise 6b's; K1 / K2a / K2b summed
               over the ranks 6b's counts a step, all on the tensor cores;
  7j.        4f's MoE serve (4 layers, fp32, contiguous KV) as the
               elastic server at 2 stages over the 2 ranks: tokens and the
               mean drop fraction equal 4f's (one stage; slot slack 0 gives
               both the same init), K4 launched in each rank, the tick p50
               beside 4f's;
  8a.        the dry run (``repro_torch.launch.dryrun``, no card): --all
               over both meshes (80 cells, 68 analysed, 12 skipped), and
               the counted probes of smollm-360m and mixtral-8x7b x
               train_4k at 16 x 16 (a summary line per mesh, the probes'
               terms);
  8b.        the dry run held against this card at 4c's and 4e's
               configurations: its parameter + optimizer + dyn bytes
               within 1 % of memory_allocated's growth when the engine
               builds that state here; its temp peak beside the phase's
               measured peak; its counted FLOPs a step over the phase's
               steady step ms as TFLOP/s and a share of the data-sheet
               peak, beside the card's name and power limit;
  8c.        the scan attention's flash backward at 4e's attention shape
               (b 2, s 1024, 32:8 heads, hd 128, window 4096): dq / dk /
               dv against autograd through the forward loop, both fp32,
               within FLASH_BWD_TOL of each leaf's largest entry; the
               peak memory of one bf16 forward + backward on each path,
               and the bytes its forward leaves for the backward;
               4e's peak beside the 57.88 GB it took with autograd
               through the scan's loop (4e's parity and 7h's
               bitwise checks run as before, now through the flash
               backward);
  9. the kernels line (JSON: per kernel its launches on the main paths
     and, as launches_tc, how many of them took a tensor-core variant; K6's
     ms is its cold graph-replay time at the main shape, its library_ms
     SDPA's graph-replay time, and "timing" holds both shapes' cold, warm
     and eager times and bounds, "launches_split" its split launches in
     the serve), the card line, and the last line {"ok": true, "device":
     {...}}; launches_sample_serve, launches_autoscale_train,
     launches_autoscale_serve, launches_tenants and launches_api are
     phases 4m-4q's, launches_chaos_train and launches_chaos_serve 4r's,
     launches_whisper, launches_zamba2, launches_xlstm and
     launches_internvl2 6a-6d's, launches_elastic_train_across,
     launches_serve_across and launches_elastic_serve_across 7d's, 7c's
     and 7e's, launches_async_across 7b async's, launches_safepoints_across
     7f's ranks' and launches_ckpt_cross its one process's,
     launches_chaos_serve_across, launches_chaos_train_across and
     launches_kill_resume_across 7g's, launches_moe_train_across,
     launches_zamba2_train_across and launches_moe_serve_across 7h's, 7i's
     and 7j's (summed over the ranks);
     family_cases holds 3f's cases of the kernel; before it,
     [phase_seconds]: the wall seconds of every phase (6a-6d, 7b-7g and
     7h-7j run after 4r, before 5; 8a-8c after 5d).

Every phase drives the port through its front door (``repro_torch.api``:
the CLIs resolve a RunSpec and run it through a Session).  The CLIs, like
the reference's, cut the arch to 8 layers unless told otherwise, so every
full-size phase passes ``--set model.layers=null`` (``FULL_SIZE``).

    python3 chip_smoke.py --k6-time ROOT

times the K6 of the port under ROOT/src by the same graph replay (and,
for a kernel that takes a split count, across split counts), so that two
versions can be compared on one card, each in its own process.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet) used for the roofline bound
PEAK_FP32_FLOPS = 67e12      # fp32 on the CUDA cores
PEAK_BF16_FLOPS = 989e12     # bf16 on the tensor cores (dense)
PEAK_TF32_FLOPS = 495e12     # TF32 on the tensor cores (dense)
PEAK_BYTES = 3.35e12         # HBM3

# the port's CLIs, like the reference's, cut the arch to 8 layers unless
# told otherwise: every full-size phase says so
FULL_SIZE = ["--set", "model.layers=null"]


def serve_args(requests: int):
    """The main path's CLI flags: full-width smollm-360m on one stage."""
    return FULL_SIZE + ["--elastic", "--stages", "1", "--micro", "2", "--mb-global", "4",
            "--prompt-len", "1024", "--gen", "32", "--requests",
            str(requests), "--kv-page-size", "16", "--prefix-cache",
            "--dynamism", "sparse_attention", "--kernel-impl", "pallas",
            "--param-dtype", "float32", "--seed", "0"]


def train_args(steps: int = 15):
    """The training path's CLI flags: full-width smollm-360m, two stage
    buffers on the card, the prune at step 10, a rebalance cadence every 5
    steps under a 2x straggler on stage 1."""
    return FULL_SIZE + ["--stages", "2", "--num-micro", "4", "--mb-global", "2",
            "--seq", "1024", "--steps", str(steps), "--rebalance-every", "5",
            "--straggler", "1:2.0", "--balancer", "diffusion",
            "--dynamism", "pruning", "--kernel-impl", "pallas",
            "--param-dtype", "float32", "--seed", "0", "--log-every", "5"]


# launches per train step at train_args(): 32 layers x 4 microbatches
TRAIN_LAUNCHES_PER_STEP = {"block_sparse_attention": 128,
                           "block_sparse_attention_bwd_dq": 128,
                           "block_sparse_attention_bwd_dkv": 128,
                           "pruned_matmul": 384 + 768}
TRAIN_K3_BWD_PER_STEP = 768

# launches per MoE train step at moe_train_args(): 2 layers x 4
# microbatches x 3 expert projections, each once forward (K4), once as dx
# (K4) and once as dw (K5); attention takes the scan path (sliding window)
MOE_TRAIN_LAUNCHES_PER_STEP = {"grouped_matmul": 48,
                               "grouped_matmul_dw": 24,
                               "block_sparse_attention": 0,
                               "block_sparse_attention_bwd_dq": 0,
                               "block_sparse_attention_bwd_dkv": 0,
                               "pruned_matmul": 0}
MOE_SERVE_PATH = ("grouped_matmul",)
# the kernels every launch of which on the smollm paths (phases 4, 4c) must
# take the 3xTF32 tensor-core variant
FP32_TC_PATH = ("block_sparse_attention", "block_sparse_attention_bwd_dq",
                "block_sparse_attention_bwd_dkv", "pruned_matmul")


def elastic_train_args(steps: int = 20):
    """Phase 4h's CLI flags: full-width smollm-360m on 4 stage buffers of
    16 slots (``--slot-slack 8``: two merged stages' 16 layers must fit one
    buffer, or the repack policy can merge none), the prune at step 10,
    ``--repack`` at the default memory cap and ``--grow-back 5`` (the
    controller shrinks at step 14 and the grow lands on step 19, the
    last)."""
    return FULL_SIZE + ["--stages", "4", "--slot-slack", "8", "--num-micro", "4",
            "--mb-global", "2", "--seq", "1024", "--steps", str(steps),
            "--rebalance-every", "5", "--dynamism", "pruning", "--repack",
            "--grow-back", "5", "--kernel-impl", "pallas", "--param-dtype",
            "float32", "--seed", "0", "--log-every", "5"]


def elastic_serve_args():
    """Phase 4i's serve flags: full-width smollm-360m on 4 stage buffers,
    paged KV (page 16), 8 requests with prompts of 512-1024 tokens."""
    return FULL_SIZE + ["--elastic", "--stages", "4", "--micro", "2", "--mb-global",
            "4", "--prompt-len", "1024", "--gen", "32", "--requests", "8",
            "--kv-page-size", "16", "--kernel-impl", "pallas",
            "--param-dtype", "float32", "--seed", "0"]


# phase 4i's scripted resizes: {tick: stage buffers}
ELASTIC_SERVE_RESIZE_AT = {8: 2, 16: 4}
# 4h's and 4i's results, which 7d and 7e are held to
ELASTIC_TRAIN = {}
ELASTIC_SERVE = {}
# a released rank's memory_allocated after the shrink (7d), at most
RELEASED_MAX_BYTES = 64 << 20


def ee_train_args(kind: str, steps: int = 5):
    """Phase 4j's training flags: full-width smollm-360m, 2 stage buffers,
    ``--dynamism early_exit`` (or mod), the exited share logged every
    step, one controller cadence (after step 4)."""
    return FULL_SIZE + ["--stages", "2", "--num-micro", "4", "--mb-global", "2",
            "--seq", "1024", "--steps", str(steps), "--rebalance-every",
            "5", "--dynamism", kind, "--kernel-impl", "pallas",
            "--param-dtype", "float32", "--seed", "0", "--log-every", "1"]


def ee_serve_args():
    """Phase 4j's serve flags: early exit in the prefill, half the
    requests tagged early_exit (short generations)."""
    return FULL_SIZE + ["--elastic", "--stages", "1", "--micro", "2", "--mb-global",
            "4", "--prompt-len", "1024", "--gen", "32", "--requests", "8",
            "--kv-page-size", "16", "--dynamism", "early_exit",
            "--early-exit-frac", "0.5", "--kernel-impl", "pallas",
            "--param-dtype", "float32", "--seed", "0"]


# phase 5d's second early-exit case: at the default 0.98 every token of
# the parity batch exits; at 0.982 most do, over the last ten layers, and
# the rest run to the head (5d prints the exits by layer of both cases)
EE_MIXED_THRESHOLD = 0.982


def moe_arch(layers: int) -> str:
    """Register full-width Mixtral-8x7B cut to ``layers`` layers (depth is
    the only cut: 32 layers are 93 GB in bf16) and return its name."""
    from repro_torch.configs import get_config, register
    name = f"mixtral-8x7b-{layers}l"
    register(dataclasses.replace(get_config("mixtral-8x7b"), name=name,
                                 num_layers=layers))
    return name


def moe_train_args(steps: int = 8):
    """The MoE training path's CLI flags: 2 layers, one per stage buffer,
    bf16 params, 8192 tokens a step, live expert re-layout."""
    return FULL_SIZE + ["--arch", moe_arch(2), "--stages", "2", "--slot-slack", "0",
            "--param-dtype", "bfloat16", "--num-micro", "4", "--mb-global",
            "2", "--seq", "1024", "--steps", str(steps), "--dynamism", "moe",
            "--dynamics.expert_relayout", "--dynamics.expert_watermark",
            "1.01", "--dynamics.expert_min_tokens", "1",
            "--rebalance-every", "3", "--kernel-impl", "pallas", "--seed",
            "0", "--log-every", "1"]


def moe_serve_args(requests: int = 8):
    """The MoE serving path's CLI flags: 4 layers, fp32, contiguous KV."""
    return FULL_SIZE + ["--elastic", "--arch", moe_arch(4), "--stages", "1",
            "--slot-slack", "0", "--micro", "2", "--mb-global", "4",
            "--prompt-len", "1024", "--gen", "16", "--requests",
            str(requests), "--kernel-impl", "pallas", "--param-dtype",
            "float32", "--seed", "0"]


def cli_spec(cli: str, argv):
    """The RunSpec the port's train or serve CLI resolves from ``argv``."""
    import importlib

    from repro_torch.api import cli as api_cli
    mod = importlib.import_module(f"repro_torch.launch.{cli}")
    table = cli.upper()
    return api_cli.build_spec(
        mod.build_parser().parse_args(argv),
        getattr(api_cli, f"{table}_ALIASES"),
        cli_defaults=getattr(api_cli, f"{table}_CLI_DEFAULTS"))


def serve_session(argv):
    """A ``Session`` over the serve CLI's spec of ``argv``, on the card."""
    from repro_torch.api import Session
    return Session(cli_spec("serve", argv))


def check_launches(label: str, launched, per_step, steps: int) -> None:
    """Every kernel of ``per_step`` launched exactly its count a step."""
    for name, n in per_step.items():
        got = launched.get(name, 0)
        if got != n * steps:
            raise AssertionError(f"{label}: {name} launched {got} times in "
                                 f"{steps} steps, expected {n} a step")


def check_k6_split(launched: int, split: int) -> None:
    """Phase 4: K6 launched, and every launch cut its pages into splits."""
    if launched <= 0 or split != launched:
        raise AssertionError(f"K6: {split} of {launched} serve launches cut "
                             f"the pages into splits")


# wall seconds of each phase ("[phase_seconds]" before the kernels line)
PHASE_SECONDS = {}


def timed(key: str, fn, *args, **kw):
    """Run one phase's function and add its wall seconds to ``key``."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kw)
    finally:
        PHASE_SECONDS[key] = (PHASE_SECONDS.get(key, 0.0)
                              + time.perf_counter() - t0)


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def cuda_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_FP32_FLOPS):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def check_close(name: str, got, want, atol: float, rtol: float) -> float:
    import torch
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs()
    lim = atol + rtol * want.abs()
    if not bool((err <= lim).all()):
        raise AssertionError(f"{name}: max |err| {float(err.max()):.3e} "
                             f"exceeds atol {atol} + rtol {rtol}")
    return float(err.max())


# ---------------------------------------------------------------------------
# phase 3: kernels vs their plain versions
# ---------------------------------------------------------------------------
def check_block_sparse_attention(torch, F):
    from repro_torch.kernels.block_sparse_attention import ops, ref
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1)

    def inputs(b, s, hq, hkv, d, dtype=torch.float32):
        q = torch.randn((b, s, hq, d), generator=g, device=dev) * 0.5
        k = torch.randn((b, s, hkv, d), generator=g, device=dev) * 0.5
        v = torch.randn((b, s, hkv, d), generator=g, device=dev) * 0.5
        return q.to(dtype), k.to(dtype), v.to(dtype)

    def mask(b, s, block, density):
        n = -(-s // block)
        return (torch.rand((b, 1, n, n), generator=g, device=dev)
                < density).to(torch.int32)

    # (label, b, s, hq, hkv, d, block, density, causal, dtype, atol, path)
    cases = [
        ("main s1024 blk512", 4, 1024, 15, 5, 64, 512, 1.0, True,
         torch.float32, 1e-4, True),
        ("nomask blk128", 4, 1024, 15, 5, 64, 128, 1.0, True,
         torch.float32, 1e-4, True),
        ("ragged s1000 half", 2, 1000, 15, 5, 64, 128, 0.5, True,
         torch.float32, 1e-4, True),
        ("noncausal s300", 2, 300, 15, 5, 64, 128, 0.5, False,
         torch.float32, 1e-4, True),
        ("blk32 per-elem", 2, 100, 4, 2, 32, 32, 0.5, True,
         torch.float32, 1e-4, True),
        ("d16 s77", 2, 77, 4, 2, 16, 64, 1.0, True, torch.float32, 1e-4,
         True),
        ("d128 s300", 2, 300, 4, 2, 128, 128, 0.7, True, torch.float32,
         1e-4, False),
        ("bf16 s256", 2, 256, 15, 5, 64, 128, 0.7, True, torch.bfloat16,
         2e-2, False),
    ]
    worst = 0.0
    timed = None
    for (label, b, s, hq, hkv, d, block, dens, causal, dt, atol,
         path) in cases:
        q, k, v = inputs(b, s, hq, hkv, d, dt)
        bm = mask(b, s, block, dens)
        if label.startswith("ragged"):
            bm[:, :, 1, :] = 0                  # fully masked q rows
        kw = dict(causal=causal, block=block)
        tc0 = ops.KERNEL.launches_tc
        out, lse = ops.block_sparse_attention_fwd(q, k, v, bm, **kw)
        out2, lse2 = ops.block_sparse_attention_fwd(q, k, v, bm, **kw)
        torch.cuda.synchronize()
        variant = tc_variant(f"K1 {label}", ops.KERNEL, tc0, 2, path)
        if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
            raise AssertionError(f"K1 {label}: a repeat is not bitwise "
                                 f"equal")
        del out2, lse2
        rout, rlse = ref.block_sparse_attention_ref(q, k, v, bm, **kw)
        e = check_close(f"K1 {label} out", out, rout, atol, atol)
        live = rlse > -1e29
        check_close(f"K1 {label} lse", lse[live], rlse[live], atol, atol)
        if not bool((lse[~live] < -1e29).all()):
            raise AssertionError(f"K1 {label}: masked rows lost the lse "
                                 f"sentinel")
        if label.startswith("ragged") and float(
                out[:, 128:256].abs().max()) != 0.0:
            raise AssertionError("K1 fully masked rows are not zero")
        extra = {}
        if label.startswith("main"):
            exact, _ = ref.block_sparse_attention_ref(
                q, k, v, bm, compute_dtype=torch.float64, **kw)
            extra = f64_distance(f"K1 {label}", out, rout, exact)
            del exact
        if path:
            worst = max(worst, e)
        say("kernels", kernel="K1", case=label.replace(" ", "_"),
            variant=variant, max_abs_err=f"{e:.3e}", tol=atol,
            repeat="bitwise", **extra)
        if timed is None:
            timed = (q, k, v, bm, block)
    q, k, v, bm, block = timed
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    ms = cuda_ms(lambda: ops.block_sparse_attention_fwd(q, k, v, bm,
                                                        block=block))
    plain_ms = cuda_ms(lambda: ref.block_sparse_attention_ref(q, k, v, bm,
                                                              block=block))
    # library yardstick: SDPA on the same inputs, kv heads repeated
    # beforehand (not timed)
    qt = q.transpose(1, 2)
    kt, vt = (t.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
              for t in (k, v))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    pairs = b * hq * s * (s + 1) / 2            # live causal (q, k) pairs
    flops = 4.0 * d * pairs
    nbytes = 4.0 * (2 * b * s * hq * d + 2 * b * s * hkv * d + b * hq * s)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                max_abs_err=worst, tol=1e-4, bound=bound(flops, nbytes),
                bound_tf32x3=tf32x3_bound(flops, nbytes),
                shape=f"b{b} s{s} hq{hq} hkv{hkv} d{d} block{block} fp32")


def tc_variant(name: str, kernel, before: int, launches: int,
               path: bool) -> str:
    """The variant ``launches`` calls of ``kernel`` ran, from its
    tensor-core launch count ("tc", "simt" or "mixed"); a main-path case
    (``path``) must have run "tc"."""
    ran = kernel.launches_tc - before
    got = "tc" if ran == launches else "simt" if ran == 0 else "mixed"
    if path and got != "tc":
        raise AssertionError(f"{name}: {ran} of {launches} launches took "
                             f"the tensor cores")
    return got


def f64_distance(name: str, got, plain, exact) -> dict:
    """The kernel's max distance from a float64 computation against the
    fp32 plain version's (allow_tf32 off); it must be at most 2x."""
    k_64 = float((got.double() - exact).abs().max())
    p_64 = float((plain.double() - exact).abs().max())
    if k_64 > 2 * p_64:
        raise AssertionError(f"{name}: {k_64:.3e} from float64, more than "
                             f"2x the fp32 plain version's {p_64:.3e}")
    return dict(f64_err=f"{k_64:.3e}", plain_f64_err=f"{p_64:.3e}")


def k3_variant(name: str, pm, before: int, x, w, axis: str, blk: int,
               launches: int = 1) -> str:
    """The variant a K3 call ran, from its tensor-core launch count: it
    must be the one ``ops.pm_variant`` chose for these strides."""
    decided = pm.pm_variant(x.dtype, axis, blk, x.stride(), w.stride(),
                            x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    ran = pm.KERNEL.launches_tc - before
    got = "tc" if ran == launches else "simt" if ran == 0 else "mixed"
    if got != decided:
        raise AssertionError(f"{name}: {ran} of {launches} launches took the "
                             f"tensor cores, dispatch chose {decided}")
    return got


def tf32x3_bound(flops: float, nbytes: float):
    """The bound of the 3xTF32 route: three TF32 passes at the tensor
    cores' TF32 rate, or the bytes."""
    return bound(3 * flops, nbytes, PEAK_TF32_FLOPS)


def check_pruned_matmul(torch, F):
    from repro_torch.kernels.pruned_matmul import ops, ref
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(2)

    def run_case(label, M, K, N, axis, blk, density, dt, atol, path):
        x = (torch.randn((M, K), generator=g, device=dev)).to(dt)
        w = (torch.randn((K, N), generator=g, device=dev) * K ** -0.5).to(dt)
        nb = (N if axis == "n" else K) // blk
        bm = (torch.rand((nb,), generator=g, device=dev) < density).to(
            torch.float32)
        if density < 1.0:
            bm[0] = 1.0
        kw = dict(mask_axis=axis, bn=blk, bk=blk)
        tc0 = ops.KERNEL.launches_tc
        out = ops.pruned_matmul(x, w, bm, **kw)
        again = ops.pruned_matmul(x, w, bm, **kw)
        torch.cuda.synchronize()
        variant = k3_variant(f"K3 {label}", ops, tc0, x, w, axis, blk, 2)
        if blk == 128 and variant != "tc":
            raise AssertionError(f"K3 {label}: a main-path mask block ran "
                                 f"{variant}")
        if not torch.equal(out, again):
            raise AssertionError(f"K3 {label}: a repeat is not bitwise "
                                 f"equal")
        want = ref.pruned_matmul_ref(x, w, bm, **kw)
        e = check_close(f"K3 {label}", out, want, atol, atol)
        extra = {}
        if label.startswith("main"):
            # K3 and torch.matmul (fp32, allow_tf32 False) against float64
            m = bm.repeat_interleave(blk)
            md = m.double()
            exact = ((x.double() * md) @ w.double() if axis == "k"
                     else (x.double() @ w.double()) * md)
            lib = (x * m) @ w if axis == "k" else (x @ w) * m
            k3_64 = float((out.double() - exact).abs().max())
            lib_64 = float((lib.double() - exact).abs().max())
            if k3_64 > 2 * lib_64:
                raise AssertionError(f"K3 {label}: {k3_64:.3e} from float64, "
                                     f"more than 2x torch.matmul's "
                                     f"{lib_64:.3e}")
            extra = dict(f64_err=f"{k3_64:.3e}",
                         matmul_f64_err=f"{lib_64:.3e}")
        say("kernels", kernel="K3", case=label.replace(" ", "_"),
            variant=variant, max_abs_err=f"{e:.3e}", tol=atol,
            repeat="bitwise", **extra)
        return (e if path else 0.0), (x, w, bm, kw)

    cases = [
        ("main up M4096 K960 N2560", 4096, 960, 2560, "n", 128, 1.0,
         torch.float32, 2e-4, True),
        ("main down M4096 K2560 N960", 4096, 2560, 960, "k", 128, 1.0,
         torch.float32, 2e-4, True),
        ("ragged n half", 1000, 960, 2560, "n", 128, 0.5, torch.float32,
         2e-4, True),
        ("ragged k half", 333, 2560, 960, "k", 128, 0.5, torch.float32,
         2e-4, True),
        ("bn64", 77, 100, 192, "n", 64, 0.6, torch.float32, 2e-4, True),
        ("bk48 per-elem", 50, 96, 70, "k", 48, 0.5, torch.float32, 2e-4,
         True),
        ("bf16", 256, 960, 512, "n", 128, 0.5, torch.bfloat16, 5e-2,
         False),
    ]
    worst, timed = 0.0, None
    for c in cases:
        e, inp = run_case(*c)
        worst = max(worst, e)
        timed = timed or inp
    x, w, bm, kw = timed
    M, K = x.shape
    N = w.shape[1]
    ms = cuda_ms(lambda: ops.pruned_matmul(x, w, bm, **kw))
    plain_ms = cuda_ms(lambda: ref.pruned_matmul_ref(x, w, bm, **kw))
    lib_ms = cuda_ms(lambda: torch.matmul(x, w))
    flops = 2.0 * M * K * N * float(bm.mean())
    nbytes = 4.0 * (M * K + K * N + M * N)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                max_abs_err=worst, tol=2e-4, bound=bound(flops, nbytes),
                bound_tf32x3=tf32x3_bound(flops, nbytes),
                shape=f"M{M} K{K} N{N} mask n all-live fp32")


# K6 timing: CUDA graphs, so the host's enqueue rate is not what is timed;
# "cold" replays one launch over each of K6_POOLS distinct pools (~10.8 MB
# each at the main shape, ~347 MB in all, past the 50 MB L2), as the serve
# meets a different layer's pool on every call; "warm" replays as many
# launches over one pool
K6_POOLS = 32
# (b lanes' cache lengths, n_q, n_kv, hd, page, J, pool blocks): the serve's
# decode shape (smollm-360m, 4 lanes, prompts 512-1024 + 32 generated) and
# every lane at smollm-360m's published context of 2048 tokens
K6_SHAPES = {"main": ([1056, 700, 1024, 513], 15, 5, 64, 16, 66, 528),
             "long": ([2048] * 4, 15, 5, 64, 16, 128, 512)}


def paged_inputs(torch, g, clens, n_q, n_kv, hd, page, J, pool, kv_dt,
                 holes=False, q_dt=None, pools=1):
    """Seeded K6 inputs on the card: q, ``pools`` (kp, vp) pairs that share
    one page table (each lane's pages at random blocks), cache_len."""
    dev = "cuda"
    b = len(clens)
    q = torch.randn((b, n_q, hd), generator=g, device=dev).to(
        q_dt or torch.float32)
    kvs = [tuple(torch.randn((pool + 1, page, n_kv, hd), generator=g,
                             device=dev).to(kv_dt) for _ in range(2))
           for _ in range(pools)]
    perm = torch.randperm(pool, generator=g, device=dev).cpu()
    pt = torch.full((b, J), -1, dtype=torch.int32)
    n = 0
    for i, cl in enumerate(clens):
        for j in range(-(-cl // page)):
            pt[i, j] = int(perm[n])
            n += 1
    if holes:
        pt[0, 1] = -1                         # an unmapped page inside clen
    cl = torch.tensor(clens, dtype=torch.int32, device=dev)
    return q, kvs, pt.to(dev), cl


def paged_bound(q, kp, pt, cl):
    """K6's least time (ms, "bytes"/"operations"): what the kernel must
    read once and write once at 3.35 TB/s -- the K/V rows below each lane's
    length in its mapped pages (the rows past it in the tail page are
    zero-filled, not read), the page-table entries of its live pages, the
    lengths, q and the output -- and 4 FLOPs a read position and head dim
    per q head at the fp32 peak."""
    b, n_q, hd = q.shape
    page, n_kv = kp.shape[1], kp.shape[2]
    rows = entries = 0
    for lane, c in zip(pt.tolist(), cl.tolist()):
        n = min(len(lane), -(-c // page))
        entries += n
        rows += sum(min(page, c - j * page) for j in range(n) if lane[j] >= 0)
    nbytes = (2.0 * rows * n_kv * hd * kp.element_size()
              + 2 * q.numel() * q.element_size() + 4.0 * (entries + b))
    return bound(4.0 * hd * n_q * rows, nbytes)


def graph_ms(torch, calls, reps: int = 20):
    """Device ms per call of ``calls`` (thunks) captured in order into one
    CUDA graph and replayed ``reps`` times between two CUDA events, after
    one eager run of each (builds the kernel, makes its split counters) and
    one warm-up replay; returns (ms, the captured calls' outputs)."""
    for c in calls:
        c()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [c() for c in calls]
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (reps * len(calls)), outs


def k6_graph_times(torch, fwd, shape: str) -> dict:
    """K6 (``fwd(q, kp, vp, pt, cl)``) at one of K6_SHAPES: graph replay
    over K6_POOLS pools (cold L2) and over one pool (warm), each replayed
    output bitwise equal to an eager call on the same pool."""
    clens, n_q, n_kv, hd, page, J, pool = K6_SHAPES[shape]
    g = torch.Generator(device="cuda").manual_seed(5)
    q, kvs, pt, cl = paged_inputs(torch, g, clens, n_q, n_kv, hd, page, J,
                                  pool, torch.bfloat16, pools=K6_POOLS)
    cold, outs_c = graph_ms(torch, [
        (lambda kp=kp, vp=vp: fwd(q, kp, vp, pt, cl)) for kp, vp in kvs])
    kp, vp = kvs[0]
    warm, outs_w = graph_ms(torch, [lambda: fwd(q, kp, vp, pt, cl)] *
                            K6_POOLS)
    for i in (0, K6_POOLS - 1):
        eager = fwd(q, kvs[i][0], kvs[i][1], pt, cl)
        if not torch.equal(outs_c[i], eager):
            raise AssertionError(f"K6 {shape}: graph replay differs from "
                                 f"eager (pool {i})")
    if not all(torch.equal(o, outs_c[0]) for o in outs_w):
        raise AssertionError(f"K6 {shape}: warm replay differs from eager")
    r = dict(cold_ms=cold, warm_ms=warm, eager_ms=cuda_ms(
        lambda: fwd(q, kp, vp, pt, cl)), bound=paged_bound(q, kp, pt, cl),
        shape=f"b{len(clens)} nq{n_q} nkv{n_kv} hd{hd} page{page} J{J} "
              f"q fp32 pool bf16, lengths {min(clens)}-{max(clens)}",
        inputs=(q, kp, vp, pt, cl))
    del kvs, outs_c, outs_w
    return r


def check_paged_attention(torch, F):
    from repro_torch.kernels.paged_attention import ops, ref
    g = torch.Generator(device="cuda").manual_seed(3)
    main_args = K6_SHAPES["main"]

    def run_case(label, clens, n_q, n_kv, hd, page, J, pool, kv_dt, holes,
                 q_dt=None):
        q, ((kp, vp),), pt, cl = paged_inputs(torch, g, clens, n_q, n_kv,
                                              hd, page, J, pool, kv_dt,
                                              holes, q_dt)
        b = len(clens)
        splits = ops.pa_splits(b, n_kv, J, page)
        n0, s0 = ops.KERNEL.launches, ops.KERNEL.launches_split
        out = ops.paged_attention_fwd(q, kp, vp, pt, cl)
        again = ops.paged_attention_fwd(q, kp, vp, pt, cl)
        torch.cuda.synchronize()
        if (ops.KERNEL.launches - n0, ops.KERNEL.launches_split - s0) != (
                2, 2 if splits > 1 else 0):
            raise AssertionError(f"K6 {label}: launch counts moved by "
                                 f"{ops.KERNEL.launches - n0} / "
                                 f"{ops.KERNEL.launches_split - s0}")
        if not torch.equal(out, again):
            raise AssertionError(f"K6 {label}: a repeat is not bitwise equal")
        # fp32 out: 1e-4; bf16 out: one bf16 rounding of the fp32 result
        want = ref.paged_attention_fwd_ref(q.float(), kp, vp, pt, cl)
        tol = (1e-4, 1e-4) if out.dtype == torch.float32 else (1e-4, 2**-8)
        e = check_close(f"K6 {label}", out, want, *tol)
        for i, c in enumerate(clens):
            if c == 0 and float(out[i].abs().max()) != 0.0:
                raise AssertionError("K6: a lane with no live page is not 0")
        blocks = ops.pa_blocks(b, n_q, n_kv, splits)
        say("kernels", kernel="K6", case=label.replace(" ", "_"),
            splits=splits, blocks=blocks, max_abs_err=f"{e:.3e}",
            tol=repr(tol), bitwise_repeat=True)
        return (e if out.dtype == torch.float32 else 0.0), splits, blocks

    bf = torch.bfloat16
    cases = [
        ("main b4 J66 page16", *main_args, bf, False),
        ("holes empty-lane", [37, 0, 1, 64], 15, 5, 64, 16, 66, 528, bf,
         True),
        ("page4 hd16 fp32", [4, 7, 13, 16], 4, 2, 16, 4, 4, 12,
         torch.float32, False),
        ("page64 hd128", [300, 129], 8, 1, 128, 64, 8, 16, bf, False),
        ("short lanes", [1056, 17, 1, 0], 15, 5, 64, 16, 66, 528, bf, False),
        ("bf16 q", *main_args, bf, False, bf),
        ("long b4 2048", *K6_SHAPES["long"], bf, False),
    ]
    worst = 0.0
    for c in cases:
        e, splits, blocks = run_case(*c)
        if c[0].startswith("main") and (splits <= 1 or blocks < 132):
            raise AssertionError(f"K6 main shape: {splits} splits, {blocks} "
                                 f"blocks (want > 1 and >= 132)")
        worst = max(worst, e)            # over the fp32-output cases
    times = {k: k6_graph_times(torch, ops.paged_attention_fwd, k)
             for k in K6_SHAPES}
    q, kp, vp, pt, cl = times["main"]["inputs"]
    n_q, n_kv = q.shape[1], kp.shape[2]
    plain_ms = cuda_ms(lambda: ref.paged_attention_fwd_ref(q, kp, vp, pt,
                                                           cl))
    # library yardstick: SDPA over the pages gathered beforehand (the
    # gather itself is not timed), lengths as a boolean mask
    kg, vg = (t.float().repeat_interleave(n_q // n_kv, dim=2).transpose(1, 2)
              for t in ref.gather_pages(kp, vp, pt))
    T = kg.shape[2]
    am = (torch.arange(T, device="cuda")[None, :] < cl[:, None])[:, None,
                                                                 None]
    qs = q[:, :, None, :]
    lib = lambda: F.scaled_dot_product_attention(qs, kg, vg, attn_mask=am)
    lib_eager = cuda_ms(lib)
    lib_graph, _ = graph_ms(torch, [lib] * K6_POOLS)
    for k, r in times.items():
        clens, _, n_kv_k, _, page, J, _ = K6_SHAPES[k]
        say("kernels", kernel="K6", timing="graph", shape_name=k,
            shape=repr(r["shape"]),
            splits=ops.pa_splits(len(clens), n_kv_k, J, page),
            cold_ms=f"{r['cold_ms']:.4f}", warm_ms=f"{r['warm_ms']:.4f}",
            eager_ms=f"{r['eager_ms']:.4f}",
            bound_ms=f"{r['bound'][0]:.4f}", bound_by=r["bound"][1],
            cold_over_bound=f"{r['cold_ms'] / r['bound'][0]:.2f}",
            graph_equals_eager=True)
    m = times["main"]
    say("kernels", kernel="K6", timing="eager", ms=f"{m['eager_ms']:.4f}",
        plain_ms=f"{plain_ms:.4f}", library_ms=f"{lib_eager:.4f}",
        library_graph_ms=f"{lib_graph:.4f}")
    timing = {k: {key: r[key] for key in ("cold_ms", "warm_ms", "eager_ms",
                                          "shape")}
              | {"bound_ms": r["bound"][0]} for k, r in times.items()}
    timing["library_eager_ms"] = lib_eager
    del times, kg, vg
    free_cuda(torch)
    return dict(ms=m["cold_ms"], plain_ms=plain_ms, library_ms=lib_graph,
                max_abs_err=worst, tol=1e-4, bound=m["bound"],
                shape=m["shape"] + " (graph replay, cold L2)",
                library_covers="SDPA on pre-gathered pages, graph replay, "
                               "warm", timing=timing)


def k6_time_only(root: str) -> int:
    """``--k6-time ROOT``: K6's graph-replay times (chip_smoke's method) for
    the port under ROOT/src, so that two versions of the kernel can be timed
    the same way on one card, each in its own process."""
    import hashlib
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA card", flush=True)
        return 1
    sys.path.insert(0, str(Path(root).resolve() / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention import ops
    _build.build([ops.KERNEL])
    src = hashlib.sha256(ops.KERNEL.source.read_bytes()).hexdigest()[:12]
    for k in K6_SHAPES:
        r = k6_graph_times(torch, ops.paged_attention_fwd, k)
        say("k6_time", root=root, source_sha=src, shape_name=k,
            cold_ms=f"{r['cold_ms']:.4f}", warm_ms=f"{r['warm_ms']:.4f}",
            eager_ms=f"{r['eager_ms']:.4f}",
            bound_ms=f"{r['bound'][0]:.4f}")
    # a kernel that splits its pages: its cold time across split counts,
    # each forced by replacing the wrapper's ``pa_splits``
    if hasattr(ops, "pa_splits"):
        chosen = ops.pa_splits
        for k in K6_SHAPES:
            cold = {}
            for sp in (1, 2, 4, 7, 10, 14, 20, 33):
                ops.pa_splits = lambda *shape, sp=sp: sp
                cold[sp] = k6_graph_times(torch, ops.paged_attention_fwd,
                                          k)["cold_ms"]
            ops.pa_splits = chosen
            say("k6_time", root=root, source_sha=src, shape_name=k,
                cold_ms_by_splits=json.dumps(
                    {sp: round(t, 4) for sp, t in cold.items()}
                ).replace(" ", ""))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


# ---------------------------------------------------------------------------
# phase 3c / 3d: the backward kernels vs their plain versions
# ---------------------------------------------------------------------------
def rel_err(name: str, got, want, rtol: float) -> float:
    """Max |got - want| after checking it against ``rtol`` x max|want| (the
    backward sums over up to 2048 rows; entries near 0 carry the absolute
    rounding of the large ones)."""
    import torch
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = float((got - want).abs().max())
    lim = rtol * float(want.abs().max())
    if err > lim:
        raise AssertionError(f"{name}: max |err| {err:.3e} exceeds "
                             f"{rtol} x max|plain| = {lim:.3e}")
    return err


def check_attention_backward(torch, F):
    """K2a and K2b at the training shapes (q [2, 1024, 15, 64], kv [2, 1024,
    5, 64]) and at edge cases, each against the plain backward."""
    from repro_torch.kernels.block_sparse_attention import ops, ref
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(4)
    # (label, b, s, hq, hkv, d, block, density, dtype, rtol, main path)
    cases = [
        ("main dense-causal blk128", 2, 1024, 15, 5, 64, 128, 1.0,
         torch.float32, 2e-4, True),
        ("blk512 dead-tiles", 2, 1024, 15, 5, 64, 512, 0.5, torch.float32,
         2e-4, True),
        ("partial s1000 masked-rows", 2, 1000, 15, 5, 64, 128, 0.6,
         torch.float32, 2e-4, True),
        ("d128 s300", 2, 300, 4, 2, 128, 128, 0.7, torch.float32, 2e-4,
         False),
        ("bf16 s1024", 2, 1024, 15, 5, 64, 128, 1.0, torch.bfloat16, 3e-2,
         False),
    ]
    worst = {"dq": 0.0, "dkv": 0.0}
    timed = None
    for label, b, s, hq, hkv, d, block, dens, dt, rtol, path in cases:
        q, k, v = (torch.randn((b, s, h, d), generator=g, device=dev)
                   .mul(0.5).to(dt) for h in (hq, hkv, hkv))
        n = -(-s // block)
        m = (torch.rand((b, 1, n, n), generator=g, device=dev)
             < dens).to(torch.int32)
        if dens < 1.0:
            m[..., 0, 0] = 1
        if label.startswith("partial"):
            m[:, :, 2, :] = 0                     # fully masked q rows
        out, lse = ops.block_sparse_attention_fwd(q, k, v, m, block=block)
        dout = torch.randn(out.shape, generator=g, device=dev).to(dt)
        delta = ((dout.float() * out.float()).sum(-1).transpose(1, 2)
                 .contiguous())
        dq_tc0 = ops.KERNEL_DQ.launches_tc
        dq = ops.block_sparse_attention_bwd_dq(q, k, v, m, dout, lse, delta,
                                               block=block)
        dq2 = ops.block_sparse_attention_bwd_dq(q, k, v, m, dout, lse, delta,
                                                block=block)
        tc0 = ops.KERNEL_DKV.launches_tc
        dk, dv = ops.block_sparse_attention_bwd_dkv(q, k, v, m, dout, lse,
                                                    delta, block=block)
        dk2, dv2 = ops.block_sparse_attention_bwd_dkv(q, k, v, m, dout, lse,
                                                      delta, block=block)
        torch.cuda.synchronize()
        if ops.KERNEL_DKV.launches_tc != tc0 + 2:
            raise AssertionError(f"K2b {label}: not on the tensor cores")
        if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
            raise AssertionError(f"K2b {label}: a repeat is not bitwise "
                                 f"equal")
        dq_variant = tc_variant(f"K2a {label}", ops.KERNEL_DQ, dq_tc0, 2,
                                path)
        if not torch.equal(dq, dq2):
            raise AssertionError(f"K2a {label}: a repeat is not bitwise "
                                 f"equal")
        del dk2, dv2, dq2
        rdq, rdk, rdv = ref.block_sparse_attention_bwd_ref(
            q, k, v, m, dout, lse, delta, block=block)
        e_dq = rel_err(f"K2a {label} dq", dq, rdq, rtol)
        extra = {}
        if label.startswith("main"):
            # dq from the same (lse, delta) in float64
            exact = ref.block_sparse_attention_bwd_dq_ref(
                q, k, v, m, dout, lse, delta, block=block,
                compute_dtype=torch.float64)
            extra = f64_distance(f"K2a {label}", dq, rdq, exact)
            del exact
        e_dkv = max(rel_err(f"K2b {label} dk", dk, rdk, rtol),
                    rel_err(f"K2b {label} dv", dv, rdv, rtol))
        if label.startswith("partial") and bool(
                dq[:, 256:384].abs().max() != 0):
            raise AssertionError("K2a: fully masked rows have nonzero dq")
        if path:
            worst["dq"] = max(worst["dq"], e_dq)
            worst["dkv"] = max(worst["dkv"], e_dkv)
        sch = ops.dkv_schedule(b, s, s, hq, hkv, True)
        steps = sch.items[:, 2] - sch.items[:, 1]
        say("kernels", kernel="K2a/K2b", case=label.replace(" ", "_"),
            dq_err=f"{e_dq:.3e}", dkv_err=f"{e_dkv:.3e}",
            tol=f"{rtol}*max|plain|", dq_variant=dq_variant,
            dkv_variant="tc", repeat="bitwise", dkv_items=len(steps),
            dkv_steps_max_over_mean=f"{steps.max() / steps.mean():.3f}",
            **extra)
        if timed is None:
            timed = (q, k, v, m, dout, lse, delta, block)
    q, k, v, m, dout, lse, delta, block = timed
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    args = (q, k, v, m, dout, lse, delta)
    ms_dq = cuda_ms(lambda: ops.block_sparse_attention_bwd_dq(
        *args, block=block))
    ms_dkv = cuda_ms(lambda: ops.block_sparse_attention_bwd_dkv(
        *args, block=block))
    plain_dq = cuda_ms(lambda: ref.block_sparse_attention_bwd_dq_ref(
        *args, block=block))
    plain_dkv = cuda_ms(lambda: ref.block_sparse_attention_bwd_dkv_ref(
        *args, block=block))
    # library yardstick: SDPA forward + backward through autograd minus its
    # forward, kv heads repeated beforehand (not timed); it computes dq,
    # dk and dv together, so it stands beside both sweeps
    qt = q.transpose(1, 2).detach().requires_grad_(True)
    kt, vt = (t.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
              .detach().requires_grad_(True) for t in (k, v))
    dot = dout.transpose(1, 2)

    def fwd_bwd():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        torch.autograd.grad(o, (qt, kt, vt), dot)

    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
    lib_ms = cuda_ms(fwd_bwd) - fwd_ms
    pairs = b * hq * s * (s + 1) / 2            # live causal (q, k) pairs
    flop = 2.0 * d * pairs                      # one d-long product
    # each sweep reads q, k, v, dout, lse, delta once and writes its output
    in_bytes = 4.0 * (2 * b * s * hq * d + 2 * b * s * hkv * d
                      + 2 * b * hq * s)
    shape = f"b{b} s{s} hq{hq} hkv{hkv} d{d} block{block} causal fp32"
    common = dict(library_ms=lib_ms, library_covers="K2a+K2b (SDPA bwd)",
                  tol="2e-4*max|plain|", shape=shape)
    return {
        # K2a needs s, dp and dq: three products per live pair
        "block_sparse_attention_bwd_dq": dict(
            ms=ms_dq, plain_ms=plain_dq, max_abs_err=worst["dq"],
            bound=bound(3 * flop, in_bytes + 4.0 * b * s * hq * d),
            bound_tf32x3=tf32x3_bound(3 * flop,
                                      in_bytes + 4.0 * b * s * hq * d),
            **common),
        # K2b needs s, dp, dk and dv: four
        "block_sparse_attention_bwd_dkv": dict(
            ms=ms_dkv, plain_ms=plain_dkv, max_abs_err=worst["dkv"],
            bound=bound(4 * flop, in_bytes + 8.0 * b * s * hkv * d),
            bound_tf32x3=tf32x3_bound(4 * flop,
                                      in_bytes + 8.0 * b * s * hkv * d),
            **common),
    }


def check_pruned_matmul_backward(torch):
    """K3's backward products at the training shapes (M = 2048 tokens per
    microbatch; the up projection masks N = 2560, the down projection K =
    2560), dense and 87 % pruned, against torch.matmul on the same inputs."""
    from repro_torch.kernels.pruned_matmul import ops
    from repro_torch.kernels.pruned_matmul.backward import pruned_matmul_bwd
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(5)
    M, D, FF = 2048, 960, 2560
    worst, times = 0.0, {}
    for axis in ("n", "k"):
        K, N = (D, FF) if axis == "n" else (FF, D)
        x = torch.randn((M, K), generator=g, device=dev)
        w = torch.randn((K, N), generator=g, device=dev) * K ** -0.5
        gr = torch.randn((M, N), generator=g, device=dev)
        for dens in (1.0, 0.13):
            m = (torch.rand((FF // 128,), generator=g, device=dev)
                 < dens).float()
            m[0] = 1.0
            b0, tc0 = ops.KERNEL.launches_bwd, ops.KERNEL.launches_tc
            dx, dw = pruned_matmul_bwd(x, w, m, gr, mask_axis=axis, blk=128)
            dx2, dw2 = pruned_matmul_bwd(x, w, m, gr, mask_axis=axis,
                                         blk=128)
            torch.cuda.synchronize()
            if ops.KERNEL.launches_bwd != b0 + 4:
                raise AssertionError("K3 backward did not launch twice")
            if ops.KERNEL.launches_tc != tc0 + 4:
                raise AssertionError(f"K3 backward {axis}: "
                                     f"{ops.KERNEL.launches_tc - tc0} of 4 "
                                     f"launches on the tensor cores")
            if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)):
                raise AssertionError(f"K3 backward {axis}: a repeat is not "
                                     f"bitwise equal")
            del dx2, dw2
            me = m.repeat_interleave(128)
            if axis == "n":
                wx, ww = (gr * me) @ w.T, x.T @ (gr * me)
            else:
                wx, ww = (gr @ w.T) * me, (x.T @ gr) * me[:, None]
            e = max(rel_err(f"K3 bwd {axis} {dens} dx", dx, wx, 2e-4),
                    rel_err(f"K3 bwd {axis} {dens} dw", dw, ww, 2e-4))
            worst = max(worst, e)
            extra = {}
            if dens == 1.0:
                # both products and torch.matmul against float64
                xd, wd, gd = x.double(), w.double(), gr.double()
                ex, ew = gd @ wd.T, xd.T @ gd
                k3_64 = max(float((dx.double() - ex).abs().max()),
                            float((dw.double() - ew).abs().max()))
                lib_64 = max(float(((gr @ w.T).double() - ex).abs().max()),
                             float(((x.T @ gr).double() - ew).abs().max()))
                if k3_64 > 2 * lib_64:
                    raise AssertionError(
                        f"K3 bwd {axis}: {k3_64:.3e} from float64, more "
                        f"than 2x torch.matmul's {lib_64:.3e}")
                extra = dict(f64_err=f"{k3_64:.3e}",
                             matmul_f64_err=f"{lib_64:.3e}")
            say("kernels", kernel="K3-bwd", case=f"mask_{axis}_keep{dens}",
                variant="tc", max_abs_err=f"{e:.3e}",
                tol="2e-4*max|plain|", repeat="bitwise", **extra)
            if axis == "n":
                kw = dict(mask_axis=axis, blk=128)
                keep = float(m.mean())
                times[dens] = dict(
                    ms=cuda_ms(lambda: pruned_matmul_bwd(x, w, m, gr, **kw)),
                    plain_ms=cuda_ms(lambda: ((gr * me) @ w.T,
                                              x.T @ (gr * me))),
                    library_ms=cuda_ms(lambda: (gr @ w.T, x.T @ gr)),
                    bound=bound(2 * 2.0 * M * K * N * keep,
                                4.0 * (2 * M * K + 2 * K * N + M * N)),
                    bound_tf32x3=tf32x3_bound(
                        2 * 2.0 * M * K * N * keep,
                        4.0 * (2 * M * K + 2 * K * N + M * N)),
                    keep=keep)
    dense, pruned = times[1.0], times[0.13]
    return dict(bwd_ms=dense["ms"], bwd_plain_ms=dense["plain_ms"],
                bwd_library_ms=dense["library_ms"],
                bwd_bound=dense["bound"],
                bwd_bound_tf32x3=dense["bound_tf32x3"],
                bwd_max_abs_err=worst,
                bwd_pruned_ms=pruned["ms"],
                bwd_pruned_bound=pruned["bound"],
                bwd_pruned_keep=pruned["keep"],
                bwd_shape=f"dx+dw M{M} K{D} N{FF} mask n fp32")


# ---------------------------------------------------------------------------
# phase 3e: the grouped expert matmul (K4) and its weight gradient (K5)
# ---------------------------------------------------------------------------
def route_counts(torch, g, b: int, s: int, E: int, K: int, cap: int):
    """Live rows per (batch row, expert) group from a seeded top-K router:
    each group keeps its first ``cap`` routed pairs."""
    import torch.nn.functional as F
    logits = torch.randn((b, s, E), generator=g, device="cuda")
    sel = logits.topk(K, dim=-1).indices
    load = F.one_hot(sel, E).sum(dim=(1, 2))                   # [b, E]
    return load.clamp(max=cap).reshape(b * E).to(torch.int32)


def gm_close(name: str, got, want) -> float:
    """fp32 outputs within 1e-4 of the plain version's largest entry (sums
    over up to 14336 terms); bf16 outputs within one bf16 rounding of it
    (both round the same fp32 sum once: 2^-7 relative, 1e-2 near 0)."""
    import torch
    if got.dtype == torch.float32:
        return rel_err(name, got, want, 1e-4)
    return check_close(name, got, want, 1e-2, 2 ** -7)


def variant_of(name: str, tc_launches: int, decided: str,
               expect_tc: bool) -> str:
    """The variant a K4 / K5 call ran, from its tensor-core launch count: it
    must be the one ``ops.gm_variant`` chose, and a call that meets the
    tensor-core conditions (``expect_tc``) must have taken the tensor
    cores."""
    ran = "tc" if tc_launches == 1 else "simt"
    if (tc_launches not in (0, 1) or ran != decided
            or (expect_tc and ran != "tc")):
        raise AssertionError(f"{name}: ran {ran} ({tc_launches} tensor-core "
                             f"launches), dispatch chose {decided}")
    return ran


def check_tensor_core(label: str, launched, launched_tc, names) -> None:
    """Every launch of each kernel in ``names`` went to its tensor-core
    variant."""
    for name in names:
        if launched_tc.get(name, 0) != launched.get(name, 0):
            raise AssertionError(f"{label}: {name} took the tensor cores "
                                 f"{launched_tc.get(name, 0)} of "
                                 f"{launched.get(name, 0)} launches")


def scan_grouped_work(torch, ops):
    """K5's time against its work at the train ewg shape (K 4096, N 14336,
    16 groups of cap 320): every group holding 0, 64, ..., 320 live rows,
    i.e. 0 to 10 live 64-row chunks a (k, n) tile, fp32 and bf16 out; a
    straight line through the points splits a call into what does not
    depend on the rows (the epilogue's dw stores, the launch) and the cost
    of one chunk across all tiles.  Returns {out dtype: {rows: ms}}."""
    g = torch.Generator(device="cuda").manual_seed(11)
    E, b, cap, K, N = 8, 2, 320, 4096, 14336
    G = b * E
    x = torch.randn((G * cap, K), generator=g, device="cuda").bfloat16()
    gr = torch.randn((G * cap, N), generator=g, device="cuda").bfloat16()
    scan = {}
    for out_dt in (torch.float32, torch.bfloat16):
        pts = {}
        for rows in range(0, cap + 1, 64):
            counts = torch.full((G,), rows, dtype=torch.int32, device="cuda")
            pts[rows] = cuda_ms(lambda: ops.grouped_product_dw(
                x, gr, counts, cap, E, out_dtype=out_dt), warmup=2, iters=10)
        n = [2 * r // 64 for r in pts]                 # chunks a tile
        chunk_flops = 2 * 128 * 256 * 64 * (N // 256) * (K // 128) * E
        t = list(pts.values())
        nm, tm = sum(n) / len(n), sum(t) / len(t)
        slope = (sum((a - nm) * (c - tm) for a, c in zip(n, t))
                 / sum((a - nm) ** 2 for a in n))
        name = str(out_dt)[6:]
        scan[name] = {str(r): v for r, v in pts.items()}
        say("kernels", kernel="K5", case=f"work_scan_{name}_out",
            ms_by_rows_per_group=json.dumps(
                {r: round(v, 4) for r, v in pts.items()}).replace(" ", ""),
            fit_zero_chunks_ms=f"{tm - slope * nm:.4f}",
            fit_ms_per_chunk=f"{slope:.4f}",
            chunk_tflops=f"{chunk_flops / slope / 1e9:.0f}")
    del x, gr
    return scan


def check_grouped_matmul(torch):
    """K4 and K5 against their plain versions at the MoE paths' shapes and
    at edge shapes, each case with its variant, its kernel / plain /
    library times and its bound: the train shapes (bf16, the 4e path: the
    tensor-core variant), the serve prefill and decode shapes (fp32, the 4f
    path: SIMT), edge cases (empty and full groups, cap off the row tile,
    K and N off the tile, a placement, the w^T view, garbage in dead
    rows)."""
    from repro_torch.kernels.grouped_matmul import ops, ref
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(8)
    E, TOPK, D, FF = 8, 2, 4096, 14336
    TOL = "1e-4*max|plain| fp32; 2^-7 rel + 1e-2 bf16"

    def live_mask(counts, cap):
        return (torch.arange(counts.numel() * cap, device=dev) % cap
                < counts.repeat_interleave(cap))

    def peak(dt):
        return PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_FP32_FLOPS

    def timed(fn, big):
        return cuda_ms(fn, warmup=2, iters=5) if big else cuda_ms(fn)

    def tc_shape(dt, cap, K, N):
        return (dt == torch.bfloat16 and cap > 16 and K % 8 == 0
                and N % 8 == 0)

    times, worst = {}, {"k4": 0.0, "k5": 0.0}

    # K4: (label, b, s, cap, K, N, dtype, placement, transposed w, path)
    k4_cases = [
        ("train ewg fwd", 2, 1024, 320, D, FF, torch.bfloat16, False, False,
         True),
        ("train ewo fwd", 2, 1024, 320, FF, D, torch.bfloat16, False, False,
         True),
        ("train ewg dx", 2, 1024, 320, FF, D, torch.bfloat16, False, True,
         True),
        ("serve prefill ewg fwd fp32", 4, 1024, 320, D, FF, torch.float32,
         False, False, True),
        ("decode fp32", 4, 1, 8, D, FF, torch.float32, False, False, True),
        ("train ewg fwd fp32 placement", 2, 1024, 320, D, FF,
         torch.float32, True, False, False),
        ("edges cap200 fp32 placement", 2, 640, 200, 512, 640,
         torch.float32, True, False, False),
        ("edges cap200 bf16 placement", 2, 640, 200, 328, 392,
         torch.bfloat16, True, False, False),
        ("edges cap200 bf16 placement w^T view", 2, 640, 200, 328, 392,
         torch.bfloat16, True, True, False),
    ]
    for label, b, s, cap, K, N, dt, placed, trans, path in k4_cases:
        counts = route_counts(torch, g, b, s, E, TOPK, cap)
        if label.startswith("edges"):
            counts[0], counts[1] = 0, cap          # empty and full groups
        G = b * E
        x = torch.randn((G * cap, K), generator=g, device=dev).to(dt)
        x[~live_mask(counts, cap)] = 1e3           # garbage in dead rows
        # dx reads w [E, D, FF] through its transposed view [E, FF, D]
        w = (torch.randn((E, N, K) if trans else (E, K, N), generator=g,
                         device=dev) * K ** -0.5).to(dt)
        if trans:
            w = w.transpose(1, 2)
        wmap = (torch.randperm(E, generator=g, device=dev).to(torch.int32)
                if placed else None)
        tc0 = ops.KERNEL.launches_tc
        out = ops.grouped_product(x, w, counts, cap, wmap)
        torch.cuda.synchronize()
        variant = variant_of(f"K4 {label}", ops.KERNEL.launches_tc - tc0,
                             ops.gm_variant(dt, cap, K, N, w.stride()),
                             tc_shape(dt, cap, K, N))
        want = ref.grouped_product_ref(x, w, counts, cap, wmap)
        e = gm_close(f"K4 {label}", out, want)
        if bool(out[~live_mask(counts, cap)].any()):
            raise AssertionError(f"K4 {label}: dead rows are not zero")
        if path:
            worst["k4"] = max(worst["k4"], e)
        del out, want
        big = K * N > 1 << 24
        # library yardstick: one bmm over [G, cap, K] x w[g % E], the
        # weights gathered beforehand (not timed); it pays full capacity
        idx = torch.arange(G, device=dev) % E
        wg = w[idx if wmap is None else wmap.long()[idx]]
        x3 = x.view(G, cap, K)
        live = float(counts.sum())
        elt = x.element_size()
        experts = int((counts.reshape(b, E).sum(0) > 0).sum())
        nbytes = (elt * (live * K + experts * K * N + G * cap * N)
                  + 4 * G)
        times["K4", label] = r = dict(
            ms=timed(lambda: ops.grouped_product(x, w, counts, cap, wmap),
                     big),
            plain_ms=timed(lambda: ref.grouped_product_ref(
                x, w, counts, cap, wmap), big),
            library_ms=timed(lambda: torch.bmm(x3, wg), big),
            bound=bound(2.0 * live * K * N, nbytes, peak(dt)),
            variant=variant,
            shape=f"G{G} cap{cap} K{K} N{N} live{int(live)} "
                  f"{str(dt)[6:]}" + (" w^T view" if trans else "")
                  + (" placement" if placed else ""))
        say("kernels", kernel="K4", case=label.replace(" ", "_"),
            variant=variant, shape=repr(r["shape"]), ms=f"{r['ms']:.4f}",
            plain_ms=f"{r['plain_ms']:.4f}",
            library_ms=f"{r['library_ms']:.4f}",
            bound_ms=f"{r['bound'][0]:.4f}", bound_by=r["bound"][1],
            max_abs_err=f"{e:.3e}", tol=repr(TOL))
        del x, w, wg, x3

    # K5: (label, b, s, cap, K, N, dtype, out dtype, placement, path)
    k5_cases = [
        ("train ewg dw", 2, 1024, 320, D, FF, torch.bfloat16,
         torch.float32, False, True),
        ("train ewo dw", 2, 1024, 320, FF, D, torch.bfloat16,
         torch.float32, False, True),
        ("train ewg dw bf16-out placement", 2, 1024, 320, D, FF,
         torch.bfloat16, torch.bfloat16, True, True),
        ("edges cap200 fp32 placement", 2, 640, 200, 512, 640,
         torch.float32, torch.float32, True, False),
        ("decode cap8 fp32", 4, 1, 8, 512, 640, torch.float32,
         torch.float32, False, False),
        ("edges cap200 bf16 placement", 2, 640, 200, 328, 392,
         torch.bfloat16, torch.float32, True, False),
        ("edges cap200 bf16-out placement", 2, 640, 200, 328, 392,
         torch.bfloat16, torch.bfloat16, True, False),
    ]
    for label, b, s, cap, K, N, dt, out_dt, placed, path in k5_cases:
        counts = route_counts(torch, g, b, s, E, TOPK, cap)
        if label.startswith("edges"):
            counts[0], counts[1] = 0, cap
        G = b * E
        dead = ~live_mask(counts, cap)
        x = torch.randn((G * cap, K), generator=g, device=dev).to(dt)
        gr = torch.randn((G * cap, N), generator=g, device=dev).to(dt)
        x[dead], gr[dead] = 1e3, -1e3              # garbage in dead rows
        gmap = (torch.randperm(E, generator=g, device=dev).to(torch.int32)
                if placed else None)
        tc0 = ops.KERNEL_DW.launches_tc
        dw = ops.grouped_product_dw(x, gr, counts, cap, E, gmap,
                                    out_dtype=out_dt)
        torch.cuda.synchronize()
        variant = variant_of(f"K5 {label}", ops.KERNEL_DW.launches_tc - tc0,
                             ops.gm_variant(dt, cap, K, N),
                             tc_shape(dt, cap, K, N))
        want = ref.grouped_product_dw_ref(x, gr, counts, cap, E, gmap,
                                          out_dtype=out_dt)
        e = gm_close(f"K5 {label}", dw, want)
        if not torch.equal(ops.grouped_product_dw(x, gr, counts, cap, E,
                                                  gmap, out_dtype=out_dt),
                           dw):
            raise AssertionError(f"K5 {label}: two runs differ")
        if path:
            worst["k5"] = max(worst["k5"], e)
        del dw, want
        big = K * N > 1 << 24
        # library yardstick: one bmm over the [E, b*cap, K]^T x [E, b*cap,
        # N] views, made beforehand with dead rows zeroed (not timed); it
        # pays full capacity
        xz = torch.where(dead[:, None], 0, x)
        gz = torch.where(dead[:, None], 0, gr)
        xe = (xz.view(b, E, cap, K).transpose(0, 1).reshape(E, b * cap, K)
              .transpose(1, 2))
        ge = gz.view(b, E, cap, N).transpose(0, 1).reshape(E, b * cap, N)
        live = float(counts.sum())
        nbytes = (x.element_size() * live * (K + N)
                  + (2 if out_dt == torch.bfloat16 else 4) * E * K * N)
        times["K5", label] = r = dict(
            ms=timed(lambda: ops.grouped_product_dw(
                x, gr, counts, cap, E, gmap, out_dtype=out_dt), big),
            plain_ms=timed(lambda: ref.grouped_product_dw_ref(
                x, gr, counts, cap, E, gmap, out_dtype=out_dt), big),
            library_ms=timed(lambda: torch.bmm(xe, ge), big),
            bound=bound(2.0 * live * K * N, nbytes, peak(dt)),
            variant=variant,
            shape=f"E{E} b{b} cap{cap} K{K} N{N} live{int(live)} "
                  f"{str(dt)[6:]} -> {str(out_dt)[6:]}"
                  + (" placement" if placed else ""))
        say("kernels", kernel="K5", case=label.replace(" ", "_"),
            variant=variant, shape=repr(r["shape"]), ms=f"{r['ms']:.4f}",
            plain_ms=f"{r['plain_ms']:.4f}",
            library_ms=f"{r['library_ms']:.4f}",
            bound_ms=f"{r['bound'][0]:.4f}", bound_by=r["bound"][1],
            max_abs_err=f"{e:.3e}", tol=repr(TOL), bitwise_repeat=True)
        del x, gr, xz, gz, xe, ge
    scan = scan_grouped_work(torch, ops)
    free_cuda(torch)

    def entry(kernel, main, worst_err, cases):
        # K4 and K5 share case labels: their times are keyed by both
        r = times[kernel, main]
        return dict(ms=r["ms"], plain_ms=r["plain_ms"],
                    library_ms=r["library_ms"], max_abs_err=worst_err,
                    tol=TOL, bound=r["bound"], shape=r["shape"],
                    library_covers="torch.bmm at full capacity",
                    cases={k: {"variant": c["variant"], "ms": c["ms"],
                               "plain_ms": c["plain_ms"],
                               "library_ms": c["library_ms"],
                               "bound_ms": c["bound"][0],
                               "bound_by": c["bound"][1],
                               "shape": c["shape"]}
                           for k in cases for c in [times[kernel, k]]})
    return {
        "grouped_matmul": entry(
            "K4", "train ewg fwd", worst["k4"], [c[0] for c in k4_cases]),
        "grouped_matmul_dw": dict(entry(
            "K5", "train ewg dw bf16-out placement", worst["k5"],
            [c[0] for c in k5_cases]), work_scan=scan),
    }


# ---------------------------------------------------------------------------
# phase 4b: device time by kernel over a short serve
# ---------------------------------------------------------------------------
# the port's CUDA kernels by profiler name, and the kernel id each is part of
PORT_KERNELS = {"bsa_fwd_tc_kernel": "K1", "bsa_dq_tc_kernel": "K2a",
                "bsa_dkv_tc_kernel": "K2b", "bsa_dkv_sum_kernel": "K2b",
                "pm_kernel": "K3", "pm_tc_kernel": "K3", "pm_sum_kernel": "K3",
                "gm_kernel": "K4", "gm_tc_kernel": "K4", "gm_dw_kernel": "K5",
                "gm_dw_tc_kernel": "K5", "paged_attn_kernel": "K6"}
OURS = re.compile(r"\b(" + "|".join(PORT_KERNELS) + r")<")


def port_kernel_ms(dev) -> str:
    """Device ms by port kernel id (K1 .. K6) from ``device_times``."""
    by_id = {}
    for name, ms in dev.items():
        m = OURS.search(name)
        if m:
            kid = PORT_KERNELS[m.group(1)]
            by_id[kid] = by_id.get(kid, 0.0) + ms
    return json.dumps({k: round(v, 2) for k, v in sorted(by_id.items())}
                      ).replace(" ", "")


def device_times(events):
    """{kernel name: device ms} over the DEVICE-side entries of a
    profiler's key averages.  A host op (``aten::mm``, an autograd
    Function such as ``_PrunedMatmul``) also carries the device time of the
    kernels it launched; counting it beside the kernels would count that
    time twice."""
    from torch.autograd import DeviceType
    dev = {}
    for e in events:
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if t > 0:
            dev[e.key] = dev.get(e.key, 0.0) + t / 1e3          # ms
    return dev


def profile_serve(torch):
    """Device time by kernel over a 4-request serve under torch.profiler,
    against the wall time of the same serve run without the profiler (whose
    own host overhead would otherwise swamp the busy share)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import run as serve_run
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve_run(serve_args(4))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    # device activity only: the kernels' times are all this reads, and the
    # host ops' records made the trace's post-processing most of the phase
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rep = serve_run(serve_args(4))
        torch.cuda.synchronize()
    dev = device_times(prof.key_averages())
    busy = sum(dev.values())
    if busy <= 0:
        raise AssertionError("the profiler saw no device time")
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:6]
    ours = sum(v for k, v in dev.items() if OURS.search(k))
    return {"requests": len(rep["completions"]),
            "wall_ms_unprofiled": f"{wall_ms:.1f}",
            "device_busy_ms": f"{busy:.1f}",
            "busy_share": f"{busy / wall_ms:.3f}",
            "port_kernels_ms": f"{ours:.1f}",
            "by_kernel_ms": port_kernel_ms(dev),
            "top": json.dumps([[k[:48], round(v, 2)] for k, v in top])
            .replace(" ", "")}


def first_two_ms(rep) -> float:
    """The wall ms of a training report's first two steps."""
    return sum(rep["step_times"][:2]) * 1e3


def profile_train(torch, args_fn=None, wall_ms=None):
    """Device time by kernel over two train steps (``args_fn(2)``'s flags,
    smollm's by default) under torch.profiler, against the wall time of
    the same two steps without the profiler: ``wall_ms``, the first two
    steps of the phase's own run of these flags (``first_two_ms``: the
    families, whose run is not the process's first training), or a
    two-step run of its own when None (4d and 4g: 4c's and 4e's first step
    also pays the process's first training calls)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.train import run as train_run
    args_fn = args_fn or train_args
    if wall_ms is None:
        rep = train_run(args_fn(2))
        torch.cuda.synchronize()
        wall_ms = rep["wall_s"] * 1e3
        del rep
        free_cuda(torch)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rep = train_run(args_fn(2))
        torch.cuda.synchronize()
    prof_wall_ms = rep["wall_s"] * 1e3
    del rep
    free_cuda(torch)
    dev = device_times(prof.key_averages())
    busy = sum(dev.values())
    if busy <= 0:
        raise AssertionError("the profiler saw no device time")
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    ours = sum(v for k, v in dev.items() if OURS.search(k))
    return {"steps": 2, "wall_ms_unprofiled": f"{wall_ms:.1f}",
            "wall_ms_profiled": f"{prof_wall_ms:.1f}",
            "device_busy_ms": f"{busy:.1f}",
            "busy_share": f"{busy / wall_ms:.3f}",
            "port_kernels_ms": f"{ours:.1f}",
            "by_kernel_ms": port_kernel_ms(dev),
            "top": json.dumps([[k[:48], round(v, 2)] for k, v in top])
            .replace(" ", "")}


def free_cuda(torch):
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5: one engine state through the kernels and through the plain
# versions
# ---------------------------------------------------------------------------
class PlainKernels:
    """Route every kernel launch of the model to its plain version on the
    card (for the parity phases only): K1's forward, the K2a / K2b backward,
    every K3 product (forward and backward), every K4 product (forward and
    as dx), K5 and K6."""

    def __enter__(self):
        from repro_torch.kernels.block_sparse_attention import ops as bsa
        from repro_torch.kernels.block_sparse_attention import ref as bsa_ref
        from repro_torch.kernels.grouped_matmul import ops as gm
        from repro_torch.kernels.grouped_matmul import ref as gm_ref
        from repro_torch.kernels.paged_attention import ops as pa
        from repro_torch.kernels.paged_attention import ref as pa_ref
        from repro_torch.kernels.pruned_matmul import ops as pm
        from repro_torch.kernels.pruned_matmul import ref as pm_ref

        def bsa_fwd(q, k, v, m, *, causal=True, block=128):
            return bsa_ref.block_sparse_attention_ref(
                q, k, v, m, causal=causal, block=block)

        def bsa_bwd(q, k, v, m, dout, lse, delta, *, causal=True,
                    block=128):
            return bsa_ref.block_sparse_attention_bwd_ref(
                q, k, v, m, dout.to(q.dtype), lse, delta, causal=causal,
                block=block)

        def pm_product(x, w, m, mask_axis, blk, *, bwd=False, out=None):
            res = pm_ref.pruned_matmul_ref(x, w, m, mask_axis=mask_axis,
                                           bn=blk, bk=blk)
            return res if out is None else out.copy_(res)

        def pa_plain(q, kp, vp, pt, cl):
            return pa_ref.paged_attention_fwd_ref(q[:, 0], kp, vp, pt,
                                                  cl)[:, None]

        def gm_product(x, w, counts, cap, wmap=None, *, bwd=False):
            return gm_ref.grouped_product_ref(x, w, counts, cap, wmap)

        def gm_product_dw(x, g, counts, cap, num_experts, gmap=None, *,
                          out_dtype=None):
            return gm_ref.grouped_product_dw_ref(x, g, counts, cap,
                                                 num_experts, gmap,
                                                 out_dtype=out_dtype)

        self._saved = [(bsa, "block_sparse_attention_fwd", bsa_fwd),
                       (bsa, "block_sparse_attention_bwd", bsa_bwd),
                       (pm, "product", pm_product),
                       (gm, "grouped_product", gm_product),
                       (gm, "grouped_product_dw", gm_product_dw),
                       (pa, "paged_attention", pa_plain)]
        self._orig = [getattr(mod, name) for mod, name, _ in self._saved]
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        return self

    def __exit__(self, *exc):
        for (mod, name, _), fn in zip(self._saved, self._orig):
            setattr(mod, name, fn)


class ExactKernels(PlainKernels):
    """PlainKernels with K4 and K5 summed in float64 and rounded once to
    their output type: the closest a bf16 result can come to the exact one
    (the yardstick of the bf16 train-step parity)."""

    def __enter__(self):
        import torch
        from repro_torch.kernels.grouped_matmul import ops as gm
        from repro_torch.kernels.grouped_matmul.ref import _live
        super().__enter__()

        def product(x, w, counts, cap, wmap=None, *, bwd=False):
            G, E = x.shape[0] // cap, w.shape[0]
            live = _live(counts, cap, x.device).reshape(-1, 1)
            xm = torch.where(live, x.double(), 0.0).reshape(G, cap, -1)
            out = x.new_empty((G, cap, w.shape[2]))
            for g in range(G):
                e = g % E if wmap is None else int(wmap[g % E])
                out[g] = (xm[g] @ w[e].double()).to(x.dtype)
            return out.reshape(G * cap, -1)

        def product_dw(x, g, counts, cap, num_experts, gmap=None, *,
                       out_dtype=None):
            G, E = x.shape[0] // cap, num_experts
            live = _live(counts, cap, x.device).reshape(-1, 1)
            xm = torch.where(live, x.double(), 0.0).reshape(G // E, E, cap, -1)
            gm_ = torch.where(live, g.double(), 0.0).reshape(G // E, E, cap,
                                                              -1)
            dw = torch.stack([torch.einsum("bck,bcn->kn", xm[:, q], gm_[:, q])
                              .to(out_dtype) for q in range(E)])
            return dw if gmap is None else dw[gmap.long()]

        self._exact = [(gm, "grouped_product", gm.grouped_product),
                       (gm, "grouped_product_dw", gm.grouped_product_dw)]
        gm.grouped_product, gm.grouped_product_dw = product, product_dw
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._exact:
            setattr(mod, name, fn)
        super().__exit__(*exc)


class EEMargin:
    """Record, over every early-exit decision of a run, the least
    |cos - ee_threshold| of a token that could exit (past the minimum
    depth, not exited yet), the number of exits and each call's exit marks
    (``decisions``, to count the tokens two runs decided differently): how
    far the run's decisions were from a flip; ``by_layer`` counts the exits
    at each layer.  With ``replay`` (another
    run's ``decisions``) the run takes those marks instead of its own, so
    it computes the same function as that run whatever a flip would do.  A
    no-op for the other dynamism kinds."""

    def __init__(self, replay=None):
        self.replay = replay

    def __enter__(self):
        import torch
        from repro_torch.models import model as M
        self.M, self.orig = M, M._ee_update
        self.margin, self.exits, self.decisions = math.inf, 0, []
        self.by_layer = {}

        def recording(cfg, dyncfg, carry_in, carry_out, depth_frac):
            out, frac = self.orig(cfg, dyncfg, carry_in, carry_out,
                                  depth_frac)
            ex = carry_in.get("exited")
            if ex is not None and depth_frac >= dyncfg.ee_min_layer_frac:
                xi = carry_in["x"].detach().float()
                xo = carry_out["x"].detach().float()
                cos = (xi * xo).sum(-1) / torch.clamp(
                    torch.linalg.vector_norm(xi, dim=-1)
                    * torch.linalg.vector_norm(xo, dim=-1), min=1e-6)
                live = ex == 0
                if bool(live.any()):
                    self.margin = min(self.margin, float(
                        (cos[live] - dyncfg.ee_threshold).abs().min()))
                if self.replay is not None:
                    marks = self.replay[len(self.decisions)]
                    out = {**out, "exited": marks.to(out["exited"])}
                new = int((out["exited"] - ex).sum())
                self.exits += new
                if new:
                    layer = int(round(depth_frac * cfg.num_layers))
                    self.by_layer[layer] = self.by_layer.get(layer, 0) + new
                self.decisions.append(out["exited"].detach().bool().cpu())
            return out, frac

        M._ee_update = recording
        return self

    def __exit__(self, *exc):
        self.M._ee_update = self.orig


def parity_run(torch, plain: bool, moe: bool = False,
               kind: str = "sparse_attention"):
    """Prefill [2, 4, 1024] tokens and 8 teacher-forced decode steps at
    full width — smollm-360m with paged KV under dynamism ``kind``, or
    (``moe``) Mixtral-8x7B cut to 2 layers with contiguous KV; returns
    (prefill ids, decode ids [8, m, B], decode logprobs, decode logits)."""
    from repro_torch import kernels
    from repro_torch.configs import DistConfig, get_config
    from repro_torch.dynamics.config import DynamicsConfig
    from repro_torch.launch.engine import ElasticEngine
    from repro_torch.models import model as M
    from repro_torch.pipeline.pipeline import PipelineShapes
    from repro_torch.serve.kv import PagedKVConfig

    cfg = get_config(moe_arch(2) if moe else "smollm-360m")
    dcfg = DistConfig(num_stages=1, slot_slack=0 if moe else 2,
                      remat="none", param_dtype="float32",
                      kernel_impl="pallas")
    m, B, s, gen, page = 2, 4, 1024, 8, 16
    shapes = PipelineShapes(m, B, s, cache_len=s + 32)
    J = shapes.cache_len // page
    paged = None if moe else PagedKVConfig(page_size=page,
                                           pool_pages=m * B * J)
    dyncfg = DynamicsConfig(kind="moe" if moe else kind)
    eng = ElasticEngine(cfg, dcfg, dyncfg, shapes, paged=paged,
                        device="cuda")
    st = eng.init_state(0, with_cache=True)
    g = torch.Generator(device="cpu").manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (m, B, s + gen), generator=g)
    table = torch.arange(m * B * J, dtype=torch.int32).reshape(m, B, J)
    logits = []
    orig = M.lm_logits

    def recording(params, cfg_, h):
        out = orig(params, cfg_, h)
        logits.append(out)
        return out

    M.lm_logits = recording
    before = [k.launches for k in kernels.KERNELS]
    try:
        if paged is None:
            pf_ids, _ = eng.prefill(st, {"tokens": toks[:, :, :s]})
        else:
            scratch = eng.make_dense_scratch(1)
            pf_ids, scratch = eng.prefill(st, {"tokens": toks[:, :, :s]},
                                          cache=scratch)
            eng.pack_pages(st, scratch, table,
                           torch.ones((m, B, J), dtype=torch.bool))
            del scratch
        ids, lps = [], []
        logits.clear()
        for i in range(gen):
            pos = torch.full((m, B), s + i, dtype=torch.int32)
            d_ids, d_lp = eng.decode(st, toks[:, :, s + i], pos,
                                     page_table=None if paged is None
                                     else table)
            ids.append(d_ids)
            lps.append(d_lp)
        torch.cuda.synchronize()
    finally:
        M.lm_logits = orig
    launched = [k.launches - b for k, b in zip(kernels.KERNELS, before)]
    if plain and any(launched):
        raise AssertionError(f"plain parity run launched kernels {launched}")
    serving = (MOE_SERVE_PATH if moe else
               ("block_sparse_attention", "pruned_matmul", "paged_attention"))
    if not plain and not all(n for k, n in zip(kernels.KERNELS, launched)
                             if k.name in serving):
        raise AssertionError(f"kernel parity run missed a kernel {launched}")
    dec_logits = torch.stack(logits).reshape(gen, m, B, -1)
    del eng, st
    return pf_ids, torch.stack(ids), torch.stack(lps), dec_logits


def train_parity_run(torch, plain: bool, moe: bool = False,
                     param_dtype: str = "float32", kind: str = "pruning",
                     layers: int = 4, ee_threshold: float = None):
    """Loss and gradients of one training step (value_and_grad of the
    pipelined loss) at full widths: smollm-360m with ``layers`` layers, 2
    stage buffers, 4 x 2 x 1024 tokens, half the FFN blocks pruned (early
    exit: at ``ee_threshold``, the config's default if None) — or
    (``moe``)
    Mixtral-8x7B cut to 2 layers, one per stage buffer, 2 x 2 x 1024
    tokens, params in ``param_dtype``; returns (loss, grads)."""
    from repro_torch import kernels
    from repro_torch.configs import DistConfig, get_config
    from repro_torch.data.loader import DataConfig, make_loader
    from repro_torch.dynamics.config import DynamicsConfig
    from repro_torch.launch.engine import ElasticEngine
    from repro_torch.pipeline.pipeline import (PipelineShapes,
                                               build_loss_fn,
                                               value_and_grad)
    if moe:
        cfg = get_config(moe_arch(2))
        dcfg = DistConfig(num_stages=2, slot_slack=0, remat="none",
                          param_dtype=param_dtype, kernel_impl="pallas")
        dyncfg = DynamicsConfig(kind="moe")
        shapes = PipelineShapes(2, 2, 1024)
    else:
        cfg = dataclasses.replace(get_config("smollm-360m"),
                                  num_layers=layers)
        dcfg = DistConfig(num_stages=2, slot_slack=2, remat="none",
                          param_dtype="float32", kernel_impl="pallas")
        dyncfg = DynamicsConfig(kind=kind)
        if ee_threshold is not None:
            dyncfg = dataclasses.replace(dyncfg, ee_threshold=ee_threshold)
        shapes = PipelineShapes(4, 2, 1024)
    eng = ElasticEngine(cfg, dcfg, dyncfg, shapes, device="cuda")
    st = eng.init_state(0)
    if not moe:
        g = torch.Generator(device="cpu").manual_seed(6)
        st.dyn["ff_mask"] = (torch.rand(st.dyn["ff_mask"].shape,
                                        generator=g) < 0.5).float().cuda()
    batch = eng._batch(next(make_loader(cfg, DataConfig(
        shapes.num_micro, shapes.mb_global, shapes.seq))))
    loss_fn = build_loss_fn(cfg, dcfg, dyncfg, shapes)
    before = [k.launches for k in kernels.KERNELS]
    before_tc = [k.launches_tc for k in kernels.KERNELS]
    loss, _, grads = value_and_grad(loss_fn, st.params, st.assignment,
                                    st.dyn, batch)
    torch.cuda.synchronize()
    launched = [k.launches - b for k, b in zip(kernels.KERNELS, before)]
    launched_tc = [k.launches_tc - b
                   for k, b in zip(kernels.KERNELS, before_tc)]
    if plain and any(launched):
        raise AssertionError(f"plain train parity run launched {launched}")
    if moe and not plain and param_dtype == "bfloat16":
        names = [k.name for k in kernels.KERNELS]
        check_tensor_core("moe bf16 train parity", dict(zip(names, launched)),
                          dict(zip(names, launched_tc)),
                          ("grouped_matmul", "grouped_matmul_dw"))
    want = ({"grouped_matmul", "grouped_matmul_dw"} if moe else
            {"block_sparse_attention", "block_sparse_attention_bwd_dq",
             "block_sparse_attention_bwd_dkv", "pruned_matmul"})
    missed = [k.name for k, n in zip(kernels.KERNELS, launched)
              if k.name in want and n == 0]
    if not plain and missed:
        raise AssertionError(f"train parity run missed {missed}")
    del eng, st, batch
    return float(loss), grads


def leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


# phase 4c's losses and rebalance events (iteration, layers moved)
TRAIN_4C = {}


def run_train_phase(torch, kernels):
    """Phase 4c: the training CLI's ``run`` at train_args(); returns the
    launch counts of the run ({name: n}, K3 backward launches)."""
    from repro_torch.configs import get_config
    from repro_torch.dynamics import pruning as prn
    from repro_torch.dynamics.config import DynamicsConfig
    from repro_torch.dynamics.trajectories import zhu_gupta_sparsity
    from repro_torch.kernels.pruned_matmul import ops as pm
    from repro_torch.launch.train import run as train_run
    free_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.KERNELS:
        k.reset()
    rep = train_run(train_args())
    torch.cuda.synchronize()
    launched = {k.name: k.launches for k in kernels.KERNELS}
    k3_bwd = pm.KERNEL.launches_bwd
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = rep["spec"]["steps"]
    losses = rep["losses"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if abs(losses[0] - math.log(49152)) > 1.0:
        raise AssertionError(f"step 0 loss {losses[0]:.3f} is not within 1 "
                             f"of ln(49152) = {math.log(49152):.3f}")
    missing = [n for n in TRAIN_LAUNCHES_PER_STEP if launched[n] <= 0]
    if missing:
        raise AssertionError(f"train never launched {missing}: {launched}")
    for name, per_step in TRAIN_LAUNCHES_PER_STEP.items():
        if launched[name] != per_step * steps:
            raise AssertionError(f"{name}: {launched[name]} launches in "
                                 f"{steps} steps, expected {per_step} a "
                                 f"step")
    if k3_bwd != TRAIN_K3_BWD_PER_STEP * steps:
        raise AssertionError(f"K3 backward launches {k3_bwd}, expected "
                             f"{TRAIN_K3_BWD_PER_STEP} a step")
    moved = [(e.iteration, e.moved_layers) for e in rep["events"]]
    if not any(m > 0 for _, m in moved):
        raise AssertionError(f"no rebalance moved layers: {moved}")
    # the prune at step 10 keeps the schedule's share of the FFN blocks
    cfg = get_config("smollm-360m")
    sp = zhu_gupta_sparsity(1000, dataclasses.replace(
        DynamicsConfig(kind="pruning"), prune_start_iter=0,
        prune_end_iter=steps * 100, prune_frequency=1))
    keep = prn.target_keep_blocks(cfg, cfg.total_blocks(), sp)
    active = rep["assignment"]["tags"].to("cuda") != 0
    ff = rep["dyn"]["ff_mask"][active]
    if abs(float(ff.mean()) - keep / ff.numel()) > 1e-6:
        raise AssertionError(f"ff_active {float(ff.mean()):.4f} != target "
                             f"{keep}/{ff.numel()}")
    st = rep["step_times"]
    say("train", steps=steps, tokens_per_step=rep["tokens_per_step"],
        tokens_per_s=f"{rep['steady_tokens_per_s']:.1f}",
        step_ms_1_9=f"{sum(st[1:10]) / 9 * 1e3:.1f}",
        step_ms_11_14=f"{sum(st[11:15]) / 4 * 1e3:.1f}",
        step0_ms=f"{st[0] * 1e3:.1f}", wall_s=f"{rep['wall_s']:.2f}",
        peak_mem_gb=f"{peak_gb:.2f}",
        loss_first=f"{losses[0]:.4f}", loss_last=f"{losses[-1]:.4f}",
        losses=json.dumps([round(x, 4) for x in losses]).replace(" ", ""),
        prune_keep=f"{keep}/{ff.numel()}",
        events=json.dumps([[e.iteration, e.moved_layers,
                            round(e.imbalance_before, 4),
                            round(e.imbalance_after, 4)]
                           for e in rep["events"]]).replace(" ", ""),
        final_lps=rep["final_lps"],
        launches=json.dumps(launched).replace(" ", ""),
        k3_bwd_launches=k3_bwd)
    # phase 4q trains the first steps of this run again from a config
    TRAIN_4C.update(losses=list(losses), events=[
        (e.iteration, e.moved_layers) for e in rep["events"]],
        step_ms=sum(st[1:10]) / 9 * 1e3, peak_gb=peak_gb)
    del rep
    free_cuda(torch)
    return launched, k3_bwd


def serve_parity(torch, moe: bool = False,
                 kind: str = "sparse_attention") -> None:
    """Phases 5 / 5c: decode ids equal wherever the plain run's top-2 gap
    exceeds 1e-3, logprobs within 1e-3 where the ids agree."""
    k_pf, k_ids, k_lp, _ = parity_run(torch, plain=False, moe=moe,
                                      kind=kind)
    free_cuda(torch)
    with PlainKernels():
        p_pf, p_ids, p_lp, p_logits = parity_run(torch, plain=True, moe=moe,
                                                 kind=kind)
    free_cuda(torch)
    top2 = p_logits.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 1e-3
    if not bool((k_ids == p_ids)[decided].all()):
        raise AssertionError("decode ids differ where the plain run's "
                             "top-2 gap exceeds 1e-3")
    same = k_ids == p_ids
    lp_err = float((k_lp - p_lp).abs()[same].max())
    if lp_err > 1e-3:
        raise AssertionError(f"decode logprobs differ by {lp_err:.3e}")
    say("moe_parity" if moe else
        ("parity" if kind == "sparse_attention" else f"parity_{kind}"),
        prefill_ids_equal=bool((k_pf == p_pf).all()),
        decode_ids_equal=f"{int(same.sum())}/{same.numel()}",
        decided=int(decided.sum()), max_logprob_err=f"{lp_err:.3e}",
        tol=1e-3)


def leaf_err(got, want) -> float:
    """max |got - want| over the largest |want|."""
    want = want.float()
    return float((got.float() - want).abs().max()) / (
        float(want.abs().max()) or 1.0)


def train_parity(torch, moe: bool = False, param_dtype: str = "float32",
                 kind: str = "pruning", layers: int = 4,
                 ee_threshold: float = None) -> None:
    """Phases 5b / 5c / 5d: one step's loss within 1e-4 relative and every
    gradient leaf within 1e-3 of its largest entry (fp32).

    bf16 (the MoE path on the tensor-core variant): the loss within 1e-3
    relative.  Kernel and plain version each round every expert
    projection's output to bf16 once, from fp32 sums taken in another
    order, so a product may land one bf16 step (2^-8 relative) apart, and
    that step propagates through SiLU, the next projection, the combine,
    the router's softmax and the whole backward.  The plain version is one
    such rounding, not the exact answer: a third run whose K4 / K5 sums are
    exact (float64, rounded once) lands about 3e-2 of a leaf's largest
    entry from it on the router and wk leaves (printed as
    worst_exact_vs_plain), so a fixed 2e-2 would fail a kernel that
    rounded every product exactly.  Each leaf is
    therefore held within max(2e-2, 1.5 x the exact run's distance from
    the plain version) of the plain version: two roundings that each sit
    about d from the exact result are typically about sqrt(2) d apart.

    Early exit at ``ee_threshold`` (set only for a case meant to mix exited
    and live tokens): the kernel run must leave some tokens live and exit
    others."""
    bf16 = param_dtype == "bfloat16"
    tol_loss, tol_grad = (1e-3, 2e-2) if bf16 else (1e-4, 1e-3)
    free_cuda(torch)
    with EEMargin() as k_margin:
        k_loss, k_grads = train_parity_run(torch, plain=False, moe=moe,
                                           param_dtype=param_dtype, kind=kind,
                                           layers=layers,
                                           ee_threshold=ee_threshold)
    free_cuda(torch)
    with PlainKernels(), EEMargin() as p_margin:
        p_loss, p_grads = train_parity_run(torch, plain=True, moe=moe,
                                           param_dtype=param_dtype, kind=kind,
                                           layers=layers,
                                           ee_threshold=ee_threshold)
    free_cuda(torch)
    ee = {}
    if kind == "early_exit":
        # how close the runs' exit decisions came to flipping (the least
        # |cos - threshold| of a token that could exit), the exits, and
        # how many exit marks the two free runs set differently: a token
        # within ~1e-7 of the threshold may exit a layer apart, and its
        # gradient then lands in another layer's weights
        tokens = 4 * 2 * 1024
        ee = dict(ee_threshold=ee_threshold or "default",
                  ee_share=f"{k_margin.exits / tokens:.6f}",
                  ee_exits_by_layer=json.dumps(dict(sorted(
                      k_margin.by_layer.items()))).replace(" ", ""),
                  ee_min_margin=f"{k_margin.margin:.3e}",
                  ee_plain_min_margin=f"{p_margin.margin:.3e}",
                  ee_exits=k_margin.exits, ee_plain_exits=p_margin.exits,
                  ee_marks_differ=sum(
                      int((a != b).sum()) for a, b in
                      zip(k_margin.decisions, p_margin.decisions)))
        if ee_threshold is not None and not 0 < k_margin.exits < tokens:
            raise AssertionError(f"early exit at {ee_threshold}: "
                                 f"{k_margin.exits} of {tokens} tokens "
                                 f"exited, not a mix {ee}")
        free_rel = abs(k_loss - p_loss) / abs(p_loss)
        if not (math.isfinite(k_loss) and free_rel <= tol_loss):
            raise AssertionError(f"train loss {k_loss} vs plain {p_loss} "
                                 f"{ee}")
        pg = dict(leaves(p_grads))
        free_leaf = max(leaf_err(g, pg[q]) for q, g in leaves(k_grads))
        ee.update(free_loss_rel_err=f"{free_rel:.3e}",
                  free_worst_leaf_rel_err=f"{free_leaf:.3e}")
        # the arithmetic: the plain versions replaying the kernel run's
        # exit marks compute the same function, held to the 4c tolerances
        del p_grads, pg
        free_cuda(torch)
        with PlainKernels(), EEMargin(replay=k_margin.decisions):
            p_loss, p_grads = train_parity_run(torch, plain=True, moe=moe,
                                               param_dtype=param_dtype,
                                               kind=kind, layers=layers,
                                               ee_threshold=ee_threshold)
        free_cuda(torch)
    x_grads = {}
    if bf16:
        with ExactKernels():
            x_loss, x_grads = train_parity_run(torch, plain=True, moe=moe,
                                               param_dtype=param_dtype)
        x_grads = dict(leaves(x_grads))
    loss_rel = abs(k_loss - p_loss) / abs(p_loss)
    if not (math.isfinite(k_loss) and loss_rel <= tol_loss):
        raise AssertionError(f"train loss {k_loss} vs plain {p_loss} {ee}")
    worst_leaf, worst_exact, n_leaves = 0.0, 0.0, 0
    pg = dict(leaves(p_grads))
    for path, kg in leaves(k_grads):
        err = leaf_err(kg, pg[path])
        tol = tol_grad
        if bf16:
            exact = leaf_err(x_grads[path], pg[path])
            tol = max(tol_grad, 1.5 * exact)
            worst_exact = max(worst_exact, exact)
        if not (err <= tol):
            raise AssertionError(f"grad {path}: max |err| / max |plain| = "
                                 f"{err:.3e} > {tol:.3e} {ee}")
        worst_leaf = max(worst_leaf, err)
        n_leaves += 1
    line = dict(layers=layers, loss=f"{k_loss:.6f}",
                plain_loss=f"{p_loss:.6f}",
                loss_rel_err=f"{loss_rel:.3e}", tol_loss=tol_loss,
                leaves=n_leaves, worst_leaf_rel_err=f"{worst_leaf:.3e}",
                tol_grad=f"{tol_grad}*max|plain|")
    if bf16:
        line.update(exact_loss=f"{x_loss:.6f}",
                    worst_exact_vs_plain=f"{worst_exact:.3e}",
                    tol_grad=f"max({tol_grad},1.5*exact_vs_plain)*max|plain|")
    line.update(ee)
    say(("moe_train_parity" if moe else "train_parity")
        + ("_bf16" if bf16 else "")
        + ("" if moe or kind == "pruning" else f"_{kind}")
        + ("" if ee_threshold is None else "_mixed"), **line)
    del k_grads, p_grads, pg, x_grads
    free_cuda(torch)


def moe_placement_neutrality(torch, dtype=None) -> None:
    """Phase 5c: moe_ffn through the kernels at full width under the
    identity placement and two permutations — y, load and the drop
    fraction bitwise equal; experts and activations in ``dtype`` (fp32 by
    default; bf16 runs the tensor-core variant), the router in fp32."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.grouped_matmul import ops as gm
    from repro_torch.models.blocks import moe_ffn
    dtype = dtype or torch.float32
    cfg = get_config("mixtral-8x7b")
    E, d, ff = cfg.num_experts, cfg.d_model, cfg.d_ff
    g = torch.Generator(device="cuda").manual_seed(9)
    p = {"router": torch.randn((d, E), generator=g, device="cuda") * d ** -.5,
         "ewi": torch.randn((E, d, ff), generator=g, device="cuda") * d ** -.5,
         "ewg": torch.randn((E, d, ff), generator=g, device="cuda") * d ** -.5,
         "ewo": torch.randn((E, ff, d), generator=g, device="cuda")
         * ff ** -.5}
    p.update({k: v.to(dtype) for k, v in p.items() if k != "router"})
    x = torch.randn((2, 1024, d), generator=g, device="cuda").to(dtype)
    n0, tc0 = gm.KERNEL.launches, gm.KERNEL.launches_tc
    with torch.no_grad():
        base = moe_ffn(p, x, cfg, kernel_impl="pallas")
        for perm in ([3, 1, 0, 2, 7, 5, 4, 6], [7, 6, 5, 4, 3, 2, 1, 0]):
            em = torch.tensor(perm, dtype=torch.float32, device="cuda")
            got = moe_ffn(p, x, cfg, kernel_impl="pallas", expert_map=em)
            for i, name in ((0, "y"), (1, "load"), (3, "dropped")):
                if not torch.equal(got[i], base[i]):
                    raise AssertionError(f"placement {perm} changed {name}")
    want_tc = gm.KERNEL.launches - n0 if dtype == torch.bfloat16 else 0
    if gm.KERNEL.launches_tc - tc0 != want_tc:
        raise AssertionError(f"placement run: {gm.KERNEL.launches_tc - tc0} "
                             f"tensor-core K4 launches, expected {want_tc}")
    say("moe_placement", dtype=str(dtype)[6:], placements=3,
        y_load_dropped_bitwise=True,
        dropped=f"{float(base[3]):.4f}",
        load=json.dumps(base[1].int().tolist()).replace(" ", ""))
    del p, x, base
    free_cuda(torch)


def run_moe_train_phase(torch, kernels):
    """Phase 4e: the training CLI's ``run`` at moe_train_args(); returns
    the launch counts of the run ({name: n})."""
    from repro_torch.kernels.grouped_matmul import ops as gm
    from repro_torch.launch.train import run as train_run
    free_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.KERNELS:
        k.reset()
    rep = train_run(moe_train_args())
    torch.cuda.synchronize()
    launched = {k.name: k.launches for k in kernels.KERNELS}
    launched_tc = {k.name: k.launches_tc for k in kernels.KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = rep["spec"]["steps"]
    losses = rep["losses"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite MoE training loss: {losses}")
    if abs(losses[0] - math.log(32000)) > 1.0:
        raise AssertionError(f"step 0 loss {losses[0]:.3f} is not within 1 "
                             f"of ln(32000) = {math.log(32000):.3f}")
    check_launches("moe train", launched, MOE_TRAIN_LAUNCHES_PER_STEP, steps)
    check_tensor_core("moe train", launched, launched_tc,
                      ("grouped_matmul", "grouped_matmul_dw"))
    rl = rep["relayouts"]
    if not any(r["moved_experts"] > 0 for r in rl):
        raise AssertionError(f"no expert re-layout moved experts: {rl}")
    if not (rep["expert_skew_last"] >= 1.0
            and 0.0 <= rep["moe_dropped_last"] < 1.0):
        raise AssertionError(f"skew {rep['expert_skew_last']} / dropped "
                             f"{rep['moe_dropped_last']} out of range")
    st = rep["step_times"]
    say("moe_train", steps=steps, tokens_per_step=rep["tokens_per_step"],
        tokens_per_s=f"{rep['steady_tokens_per_s']:.1f}",
        step_ms_1_7=f"{sum(st[1:]) / (len(st) - 1) * 1e3:.1f}",
        step0_ms=f"{st[0] * 1e3:.1f}", wall_s=f"{rep['wall_s']:.2f}",
        peak_mem_gb=f"{peak_gb:.2f}",
        losses=json.dumps([round(x, 4) for x in losses]).replace(" ", ""),
        expert_skew_last=f"{rep['expert_skew_last']:.4f}",
        moe_dropped_last=f"{rep['moe_dropped_last']:.4f}",
        relayouts=json.dumps([[r["step"], r["moved_experts"],
                               round(r["skew"], 4)] for r in rl])
        .replace(" ", ""),
        expert_layout=json.dumps(rep["expert_layout"]).replace(" ", ""),
        launches=json.dumps(launched).replace(" ", ""),
        launches_tc=json.dumps(launched_tc).replace(" ", ""),
        k4_dx_launches=gm.KERNEL.launches_bwd)
    # what 7h's ranks are held to
    MOE_TRAIN.update(
        losses=rep["losses"], relayouts=rep["relayouts"],
        moe_history=rep["moe_history"], expert_layout=rep["expert_layout"],
        digests=state_fingerprints(rep["params"], rep["opt_state"]),
        step_ms=sum(st[1:]) / (len(st) - 1) * 1e3, peak_gb=peak_gb)
    del rep
    free_cuda(torch)
    return launched


def run_moe_serve_phase(torch, kernels):
    """Phase 4f: the serving CLI's ``run`` at moe_serve_args(); returns
    the launch counts of the run ({name: n})."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run as serve_run
    from repro_torch.models.blocks import moe_capacity
    from repro_torch.serve.requests import make_trace
    free_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.KERNELS:
        k.reset()
    rep = serve_run(moe_serve_args())
    torch.cuda.synchronize()
    launched = {k.name: k.launches for k in kernels.KERNELS}
    # the serve spec's trace fields, and the seed the trace is drawn with
    args = {**rep["spec"]["serve"], "seed": rep["spec"]["seed"]}
    comps = rep["completions"]
    if len(comps) != args["requests"]:
        raise AssertionError(f"{len(comps)} of {args['requests']} MoE "
                             f"requests completed")
    cache_len = args["prompt_len"] + args["gen"]
    budget = {r.rid: min(r.gen, cache_len - r.plen + 1)
              for r in make_trace(args["requests"],
                                  prompt_len=args["prompt_len"],
                                  max_gen=args["gen"], vocab_size=32000,
                                  seed=args["seed"],
                                  min_prompt=args["prompt_len"] // 2)}
    for c in comps:
        if len(c["tokens"]) != budget[c["rid"]]:
            raise AssertionError(f"MoE request {c['rid']}: "
                                 f"{len(c['tokens'])} tokens, budget "
                                 f"{budget[c['rid']]}")
        if not all(0 <= t < 32000 for t in c["tokens"]):
            raise AssertionError(f"MoE request {c['rid']}: token out of "
                                 f"vocab")
    missing = [n for n in MOE_SERVE_PATH if launched[n] <= 0]
    if missing:
        raise AssertionError(f"MoE serve never launched {missing}: "
                             f"{launched}")
    drop = rep["moe_dropped_mean"]
    if drop is None or not 0.0 <= drop < 1.0:
        raise AssertionError(f"moe_dropped_mean {drop} not in [0, 1)")
    say("moe_serve", requests=len(comps), tokens=rep["total_tokens"],
        ticks=rep["ticks"], tokens_per_s=f"{rep['tokens_per_s']:.1f}",
        p50_ms=f"{rep['latency_p50_s'] * 1e3:.1f}",
        p95_ms=f"{rep['latency_p95_s'] * 1e3:.1f}",
        wall_s=f"{rep['wall_s']:.2f}",
        max_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        moe_dropped_mean=f"{drop:.5f}",
        decode_cap=moe_capacity(get_config(moe_arch(4)), 1),
        launches=json.dumps(launched).replace(" ", ""))
    # what 7j's ranks are held to
    MOE_SERVE.update(tokens={c["rid"]: c["tokens"] for c in comps},
                     drop=drop, tick_p50=_pct50(rep["tick_wall_s"]))
    del rep
    free_cuda(torch)
    return launched


# ---------------------------------------------------------------------------
# phases 4h / 4i / 4j: live resizes, early exit and MoD
# ---------------------------------------------------------------------------
def world_ms(step_times, stages_hist) -> dict:
    """Mean wall ms of the steps (ticks) spent in each world, the world's
    first step (its warm-up) and the run's first step excluded; keys
    ``S<stages>_<n>``, n counting the stretches of the run in order."""
    out, start = {}, 0
    for i in range(1, len(stages_hist) + 1):
        if i == len(stages_hist) or stages_hist[i] != stages_hist[start]:
            ts = step_times[start + 1:i]
            key = f"S{stages_hist[start]}_{len(out) + 1}"
            out[key] = (round(sum(ts) / len(ts) * 1e3, 1) if ts
                        else None)
            start = i
    return out


def run_elastic_train_phase(torch, kernels):
    """Phase 4h: the training CLI's ``run`` at elastic_train_args(): the
    controller's repack decision shrinks 4 -> 2 stage buffers after the
    prune, --grow-back restores 4; returns the launch counts ({name: n})."""
    from repro_torch.kernels.pruned_matmul import ops as pm
    from repro_torch.launch.train import run as train_run
    free_cuda(torch)
    for k in kernels.KERNELS:
        k.reset()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        rep = train_run(elastic_train_args())
    torch.cuda.synchronize()
    launched = {k.name: k.launches for k in kernels.KERNELS}
    launched_tc = {k.name: k.launches_tc for k in kernels.KERNELS}
    steps = rep["spec"]["steps"]
    losses = rep["losses"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite elastic training loss: {losses}")
    check_launches("elastic train", launched, TRAIN_LAUNCHES_PER_STEP, steps)
    if pm.KERNEL.launches_bwd != TRAIN_K3_BWD_PER_STEP * steps:
        raise AssertionError(f"elastic train: K3 backward launches "
                             f"{pm.KERNEL.launches_bwd}")
    check_tensor_core("elastic train", launched, launched_tc, FP32_TC_PATH)
    # phase 7d trains the same flags as 4 ranks and is held to this run
    ELASTIC_TRAIN.update(
        losses=list(losses), pool_log=list(rep["pool_log"]),
        stages=list(rep["stages_history"]), launches=dict(launched),
        launches_bwd={k.name: k.launches_bwd for k in kernels.KERNELS},
        resizes=[(r["kind"], r["step"], r["from_stages"], r["to_stages"],
                  list(r["workers"])) for r in rep["resizes"]],
        step_times=list(rep["step_times"]))
    rz = rep["resizes"]
    got = [(r["kind"], r["from_stages"], r["to_stages"]) for r in rz]
    if got != [("shrink", 4, 2), ("grow", 2, 4)]:
        raise AssertionError(f"elastic train resizes {got}: the controller "
                             f"must shrink 4 -> 2 and grow back to 4")
    if rep["pool_log"] != ["release:2", "release:3", "grant:2", "grant:3"]:
        raise AssertionError(f"pool log {rep['pool_log']}")
    if rep["final_stages"] != 4:
        raise AssertionError(f"final stages {rep['final_stages']}")
    mem = rep["resize_memory"]
    if not mem[0]["allocated_after"] < mem[0]["allocated_before"]:
        raise AssertionError(f"the shrink freed no memory: {mem[0]}")
    for r, m in zip(rz, mem):
        say("elastic_train_resize", kind=r["kind"], step=r["step"],
            stages=f"{r['from_stages']}->{r['to_stages']}",
            workers=r["workers"], seconds=f"{r['seconds']:.4f}",
            ticks=f"{r['ticks_before']}->{r['ticks_after']}",
            allocated_gb_before=f"{m['allocated_before'] / 1e9:.3f}",
            allocated_gb_after=f"{m['allocated_after'] / 1e9:.3f}")
    say("elastic_train", steps=steps,
        tokens_per_step=rep["tokens_per_step"],
        step_ms_by_world=json.dumps(world_ms(rep["step_times"],
                                             rep["stages_history"]))
        .replace(" ", ""),
        stages=json.dumps(rep["stages_history"]).replace(" ", ""),
        step_ms=json.dumps([round(t * 1e3, 1) for t in rep["step_times"]])
        .replace(" ", ""),
        wall_s=f"{rep['wall_s']:.2f}",
        losses=json.dumps([round(x, 4) for x in losses]).replace(" ", ""),
        pool_log=json.dumps(rep["pool_log"]).replace(" ", ""),
        launches=json.dumps(launched).replace(" ", ""))
    del rep
    free_cuda(torch)
    return launched


def run_elastic_serve_phase(torch, kernels):
    """Phase 4i: the serve CLI's server at elastic_serve_args(), once on a
    fixed world and once with ``resize_at`` (4 -> 2 -> 4): completions
    token-identical; the page pool bitwise equal after one more shrink /
    grow cycle on the live state (the trash block excluded); every K6
    launch split.  Returns the elastic serve's launch counts."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    free_cuda(torch)
    with serve_session(elastic_serve_args()) as s, RecordGaps() as gaps:
        fixed = s.serve()
    # phase 4r's crashed serve is held to this run
    ELASTIC_FIXED.update(
        tokens={c["rid"]: c["tokens"] for c in fixed["completions"]},
        gaps=gaps.gaps, ticks=fixed["ticks"], wall_s=fixed["wall_s"],
        tick_p50=_pct50(fixed["tick_wall_s"]))
    free_cuda(torch)
    sess = serve_session(elastic_serve_args())
    for k in kernels.KERNELS:
        k.reset()
    rep = sess.serve(resize_at=ELASTIC_SERVE_RESIZE_AT)
    srv = sess.server
    torch.cuda.synchronize()
    launched = {k.name: k.launches for k in kernels.KERNELS}
    launched_tc = {k.name: k.launches_tc for k in kernels.KERNELS}
    k6_split = pa_ops.KERNEL.launches_split
    check_k6_split(launched["paged_attention"], k6_split)
    check_tensor_core("elastic serve", launched, launched_tc,
                      ("block_sparse_attention", "pruned_matmul"))
    missing = [n for n in ("block_sparse_attention", "pruned_matmul",
                           "paged_attention") if launched[n] <= 0]
    if missing:
        raise AssertionError(f"elastic serve never launched {missing}")
    want = {c["rid"]: c["tokens"] for c in fixed["completions"]}
    got = {c["rid"]: c["tokens"] for c in rep["completions"]}
    if got != want or len(got) != sess.spec.serve.requests:
        raise AssertionError(f"resized serve differs from the fixed one: "
                             f"{got} != {want}")
    kinds = [(r["kind"], r["from_stages"], r["to_stages"])
             for r in rep["resizes"]]
    if kinds != [("shrink", 4, 2), ("grow", 2, 4)]:
        raise AssertionError(f"serve resizes {kinds}")
    # phase 7e serves the same trace as 4 ranks and is held to this run
    ELASTIC_SERVE.update(
        tokens=got, launches=dict(launched), split=k6_split,
        pool_digests=pool_digests(srv.state.cache),
        tick_p50=_pct50(rep["tick_wall_s"]),
        resizes=[(r["kind"], r["step"], r["from_stages"], r["to_stages"])
                 for r in rep["resizes"]])
    # one more shrink / grow cycle on the live state: the pool bitwise
    before = {k: v.clone() for k, v in srv.state.cache.items()}
    torch.cuda.synchronize()
    mem = [torch.cuda.memory_allocated()]
    srv.state = srv.engine.shrink(srv.state, 2, step=1000)
    mem.append(torch.cuda.memory_allocated())
    srv.state = srv.engine.grow(srv.state, 2, step=1001)
    mem.append(torch.cuda.memory_allocated())
    for k, v in before.items():
        if not torch.equal(srv.state.cache[k][:, :, :-1], v[:, :, :-1]):
            raise AssertionError(f"page pool leaf {k} changed through a "
                                 f"shrink / grow cycle")
    if not mem[1] < mem[0]:
        raise AssertionError(f"the serving shrink freed no memory: {mem}")
    for r in srv.engine.resizes:
        say("elastic_serve_resize", kind=r.kind, tick=r.step,
            stages=f"{r.from_stages}->{r.to_stages}", workers=r.workers,
            seconds=f"{r.seconds:.4f}",
            ticks=f"{r.ticks_before}->{r.ticks_after}")
    say("elastic_serve", requests=len(got), tokens=rep["total_tokens"],
        ticks=rep["ticks"], resize_at=json.dumps(ELASTIC_SERVE_RESIZE_AT)
        .replace(" ", ""), tokens_equal_fixed=True, pool_bitwise=True,
        tick_ms_by_world=json.dumps(world_ms(rep["tick_wall_s"],
                                             rep["stages_history"]))
        .replace(" ", ""),
        fixed_tokens_per_s=f"{fixed['tokens_per_s']:.1f}",
        tokens_per_s=f"{rep['tokens_per_s']:.1f}",
        allocated_gb_cycle=json.dumps([round(m / 1e9, 3) for m in mem])
        .replace(" ", ""),
        pool_log=json.dumps(rep["pool_log"]).replace(" ", ""),
        launches=json.dumps(launched).replace(" ", ""),
        k6_split_launches=k6_split)
    sess.close()
    del sess, srv, rep, fixed, before
    free_cuda(torch)
    return launched


def run_ee_train_phase(torch, kernels):
    """Phase 4j: train 2 stage buffers with --dynamism early_exit (the
    exited share of every step printed); returns the run's launch counts
    ({name: n})."""
    from repro_torch.kernels.pruned_matmul import ops as pm
    from repro_torch.launch.train import run as train_run
    free_cuda(torch)
    for k in kernels.KERNELS:
        k.reset()
    rep = train_run(ee_train_args("early_exit"))
    torch.cuda.synchronize()
    launched = {k.name: k.launches for k in kernels.KERNELS}
    launched_tc = {k.name: k.launches_tc for k in kernels.KERNELS}
    steps = rep["spec"]["steps"]
    if not all(math.isfinite(x) for x in rep["losses"]):
        raise AssertionError(f"non-finite EE loss: {rep['losses']}")
    frac = rep["exited_frac"]
    if sorted(frac) != list(range(steps)):
        raise AssertionError(f"exited share not logged every step: {frac}")
    # every block still runs on every token (exits are an output mask, as
    # in the reference), so the per-step counts are phase 4c's
    check_launches("ee train", launched, TRAIN_LAUNCHES_PER_STEP, steps)
    if pm.KERNEL.launches_bwd != TRAIN_K3_BWD_PER_STEP * steps:
        raise AssertionError(f"ee train: K3 backward launches "
                             f"{pm.KERNEL.launches_bwd}")
    check_tensor_core("ee train", launched, launched_tc, FP32_TC_PATH)
    st = rep["step_times"]
    say("ee_train", steps=steps, tokens_per_step=rep["tokens_per_step"],
        exited_frac=json.dumps([round(frac[i], 6) for i in range(steps)])
        .replace(" ", ""),
        step_ms_1_n=f"{sum(st[1:]) / (len(st) - 1) * 1e3:.1f}",
        losses=json.dumps([round(x, 4) for x in rep["losses"]])
        .replace(" ", ""),
        launches=json.dumps(launched).replace(" ", ""))
    del rep
    free_cuda(torch)
    return launched


def run_ee_serve_phase(torch, kernels):
    """Phase 4j: the serve CLI with --dynamism early_exit --early-exit-frac
    0.5; returns the run's launch counts ({name: n})."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.launch.serve import run as serve_run
    free_cuda(torch)
    for k in kernels.KERNELS:
        k.reset()
    srv = serve_run(ee_serve_args())
    torch.cuda.synchronize()
    launched = {k.name: k.launches for k in kernels.KERNELS}
    launched_tc = {k.name: k.launches_tc for k in kernels.KERNELS}
    k6_split = pa_ops.KERNEL.launches_split
    missing = [n for n in ("block_sparse_attention", "pruned_matmul",
                           "paged_attention") if launched[n] <= 0]
    if missing:
        raise AssertionError(f"EE serve never launched {missing}")
    check_tensor_core("ee serve", launched, launched_tc,
                      ("block_sparse_attention", "pruned_matmul"))
    check_k6_split(launched["paged_attention"], k6_split)
    comps = srv["completions"]
    kinds = sorted({c["kind"] for c in comps})
    if len(comps) != 8 or kinds != ["early_exit", "none"]:
        raise AssertionError(f"EE serve: {len(comps)} completions, kinds "
                             f"{kinds}")
    if not all(0 <= t < 49152 for c in comps for t in c["tokens"]):
        raise AssertionError("EE serve: token out of vocab")
    say("ee_serve", requests=len(comps), tokens=srv["total_tokens"],
        ticks=srv["ticks"], tokens_per_s=f"{srv['tokens_per_s']:.1f}",
        kinds=json.dumps({k: sum(c["kind"] == k for c in comps)
                          for k in kinds}).replace(" ", ""),
        launches=json.dumps(launched).replace(" ", ""),
        k6_split_launches=k6_split)
    del srv
    free_cuda(torch)
    return launched


# ---------------------------------------------------------------------------
# phases 4k / 4l: safe points and resume; the control plane's inputs
# ---------------------------------------------------------------------------
def ckpt_train_args(steps: int = 20, layers: int = None):
    """Phase 4k's flags: phase 4h's without --grow-back (4 stage buffers of
    16 slots, 8192 tokens a step, --repack, the prune at step 10), 20
    steps; the phase adds --ckpt-dir and --ckpt-every 8.  ``layers`` cuts
    smollm-360m at its published widths to that depth (phases 4k, 4n and
    4r: 8, in buffers of 4 slots)."""
    arch = [] if layers is None else ["--arch", cut_arch("smollm-360m",
                                                         layers)]
    # a buffer holds two stages' layers, not more: the repack merges
    # adjacent pairs, 4 -> 2
    slack = str((layers or 32) // 4)
    return FULL_SIZE + arch + ["--stages", "4", "--slot-slack", slack, "--num-micro", "4",
            "--mb-global", "2", "--seq", "1024", "--steps", str(steps),
            "--rebalance-every", "5", "--dynamism", "pruning", "--repack",
            "--kernel-impl", "pallas", "--param-dtype", "float32", "--seed",
            "0", "--log-every", "5"]


CKPT_EVERY = 8
# the depth of phases 4k, 4n and 4r: smollm-360m at its published widths
# cut to 8 layers (two a buffer; at 32, 4k alone was a quarter of the
# run's time)
CUT_LAYERS = 8
# K1-K3 launches a step at that depth: a quarter of 4c's
CUT_LAUNCHES_PER_STEP = {k: v * CUT_LAYERS // 32
                         for k, v in TRAIN_LAUNCHES_PER_STEP.items()}
CUT_K3_BWD_PER_STEP = TRAIN_K3_BWD_PER_STEP * CUT_LAYERS // 32
# phase 4k's steps: the prune at 10, the shrink at 14, safe points after 7
# and 15, one step after the last
CKPT_STEPS = 17
# the safe points phase 4k resumed through Session.resume whose RunSpec
# equalled the writer's (phase 4q (v) reads it)
RESUMED_SPECS = []
# the safe points of the 17-step run: after steps 7 (4 buffers) and 15
# (2, after the controller's shrink at step 14); 4k resumes from 15 (1
# step); its resume from 7 (9 steps: the prune at 10, the shrink at 14)
# reads phase 7f's rank-written safe point, and 7f's ranks resume from
# 4k's step 7 (CKPT_CROSS)
CKPT_RESUMES = ((15, 2),)
CKPT_CROSS = 7
# 4k's run, held for 7f: its safe points' directory (kept until phase 7
# ends), losses, resizes, pool log, stages, final state digests, and the
# seconds and bytes of its saves and restore
CKPT_RUN = {}


# phase 4l's steps: two controller decisions (after steps 3 and 7)
CTL_STEPS = 8


def ctl_train_args(steps: int = CTL_STEPS):
    """Phase 4l's flags: smollm-360m at its published widths cut to 8
    layers (``CUT_LAYERS``: at 32 its six runs took ~45 s) on 2 stage
    buffers, 8192 tokens a step, a cadence every 4 steps under a 4x
    straggler on worker 1 (at 8 layers a 2x one moves no layer); the phase
    adds the timing and controller flags."""
    return FULL_SIZE + ["--arch", cut_arch("smollm-360m", CUT_LAYERS),
                        "--stages", "2", "--num-micro", "4", "--mb-global", "2",
            "--seq", "1024", "--steps", str(steps), "--rebalance-every", "4",
            "--straggler", "1:4.0", "--dynamism", "pruning", "--kernel-impl",
            "pallas", "--param-dtype", "float32", "--seed", "0",
            "--log-every", "4"]


CTL_TIMED = ["--in-step-timing", "--measure-stage-times"]
CTL_ASYNC = ["--async-controller", "--async-drain"]
# phase 4l's skewed split of the 32 layers over 4 buffers (slot slack 18:
# 26 slots a buffer)
CTL_SKEW = [26, 2, 2, 2]


def _window(torch, kernels):
    torch.cuda.synchronize()
    return ({k.name: k.launches for k in kernels.KERNELS},
            {k.name: k.launches_tc for k in kernels.KERNELS})


def _dir_bytes(path: str) -> int:
    import os
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def _tree_diff(torch, got, want) -> tuple:
    """(largest |difference| over the leaves, its leaf)."""
    worst, where = 0.0, None
    for (path, a), (_, b) in zip(leaves(got), leaves(want)):
        if a is None or not a.is_floating_point():
            continue
        d = float((a.float() - b.float()).abs().max()) if a.numel() else 0.0
        if d > worst:
            worst, where = d, path
    return worst, where


def state_digests(params, opt_state) -> dict:
    """One process's final state as ``session.state_digest`` digests a
    rank's: {"rows": [sha256 of stage s's rows of the params and both
    moments, each s], "rest": sha256 of the replicated leaves and their
    moments}."""
    from repro_torch.launch.sharding import (leaves as tree_leaves,
                                             rebuild, split_stages,
                                             tree_digest)
    p_rows, p_rest = split_stages(params)
    o_rows, o_rest = split_stages(opt_state)
    S = next(t for _, t in tree_leaves(p_rows)).shape[0]
    return {"rows": [tree_digest({
        "params": rebuild(p_rows, lambda _, t: t[s:s + 1]),
        "opt": rebuild(o_rows, lambda _, t: t[s:s + 1])}) for s in range(S)],
        "rest": tree_digest({"params": p_rest, "opt": o_rest})}


def ranks_digests(ranks) -> dict:
    """The ranks' ``digest`` counters as ``state_digests`` gives them."""
    rows = {r["digest"]["stage"]: r["digest"]["rows"] for r in ranks
            if r["digest"]["rows"] is not None}
    rest = [r["digest"]["rest"] for r in ranks if r["digest"]["rest"]]
    return {"rows": [rows[s] for s in sorted(rows)],
            "rest": rest[0] if len(rest) == 1 else rest}


def _bitwise(torch, got, want) -> bool:
    return all(torch.equal(a, b) for (_, a), (_, b)
               in zip(leaves(got), leaves(want)))


def run_ckpt_phase(torch, kernels):
    """Phase 4k: a 17-step run of ckpt_train_args() at CUT_LAYERS layers
    writing safe points
    every 8 steps into a temporary directory, then resumed from step 15
    (2 buffers); the tail must equal the uninterrupted run's losses,
    resizes, pool log, final params and moments bitwise (it writes no
    safe point of its own).  The directory stays for phase 7f, whose ranks
    resume from its step 7 and whose step-7 safe point 4k's resume from 7
    reads (``run_ckpt_cross``).  Counts zeroed before the first run and
    read after the last (18 steps).  Returns the launch counts."""
    import os
    import shutil
    import tempfile
    from repro_torch.api import RunSpec, Session
    from repro_torch.kernels.pruned_matmul import ops as pm
    from repro_torch.launch.train import run as train_run
    free_cuda(torch)
    # the safe points take ~16 GB: the roomier of TMPDIR and build/
    roots = [tempfile.gettempdir(), str(ROOT / "build")]
    os.makedirs(roots[1], exist_ok=True)
    free = {r: shutil.disk_usage(r).free for r in roots}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_",
                           dir=max(roots, key=free.get))
    say("ckpt_disk", dir=tmp, free_gb=json.dumps(
        {r: round(f / 1e9, 1) for r, f in free.items()}).replace(" ", ""))
    ck = os.path.join(tmp, "ck")
    try:
        for k in kernels.KERNELS:
            k.reset()
        full = train_run(ckpt_train_args(CKPT_STEPS, CUT_LAYERS) + [
            "--ckpt-dir", ck, "--ckpt-every", str(CKPT_EVERY)])
        torch.cuda.synchronize()
        got = [(r["kind"], r["step"], r["from_stages"], r["to_stages"])
               for r in full["resizes"]]
        if got != [("shrink", 14, 4, 2)]:
            raise AssertionError(f"ckpt train resizes {got}: the controller "
                                 f"must shrink 4 -> 2 at step 14")
        if full["pool_log"] != ["release:2", "release:3"]:
            raise AssertionError(f"pool log {full['pool_log']}")
        saved = sorted(os.listdir(ck))
        if saved != ["step_00000007", "step_00000015"]:
            raise AssertionError(f"safe points {saved}")
        sizes = {d: _dir_bytes(os.path.join(ck, d)) for d in saved}
        CKPT_RUN.update(
            losses=list(full["losses"]), pool_log=list(full["pool_log"]),
            stages=list(full["stages_history"]), resizes=got,
            spec=full["spec"], bytes=sizes,
            save_s=list(full["timing"]["safepoint_s"]),
            digests=state_digests(full["params"], full["opt_state"]))
        for d, secs in zip(saved, full["timing"]["safepoint_s"]):
            with open(os.path.join(ck, d, "index.json")) as fh:
                idx = json.load(fh)
            say("ckpt_save", safepoint=d, stages=idx["num_stages"],
                lps=json.dumps(idx["layers_per_stage"]).replace(" ", ""),
                gb=f"{sizes[d] / 1e9:.3f}", seconds=f"{secs:.2f}",
                gb_per_s=f"{sizes[d] / 1e9 / secs:.2f}",
                epoch=idx["meta"]["epoch"],
                workers=json.dumps(idx["meta"]["stage_workers"])
                .replace(" ", ""))
        results = {}
        for at, stages in CKPT_RESUMES:
            free_cuda(torch)
            # the uninterrupted run's final state is still alive here: the
            # restore's memory is the growth over this
            base = torch.cuda.memory_allocated()
            # the safe point carries the RunSpec that wrote it: the
            # resumed Session must hold that spec exactly
            sess = Session.resume(ck, step=at)
            if sess.spec != RunSpec.from_dict(full["spec"]):
                raise AssertionError(f"safe point {at}: the resumed RunSpec "
                                     f"differs from the one that wrote it")
            RESUMED_SPECS.append(at)
            # the tails write no safe point: the uninterrupted run's two
            # were the saves measured (resuming from 7 would write step
            # 15's again, ~15 s); safe points take no part in the numbers
            sess.spec = sess.spec.override({"ckpt_every": 0,
                                            "ckpt_dir": None})
            with sess:
                rep = sess.train()
            torch.cuda.synchronize()
            restored = rep["timing"]["restore_allocated"] - base
            tail = full["losses"][at + 1:]
            rz = [(r["kind"], r["step"], r["from_stages"], r["to_stages"])
                  for r in rep["resizes"]]
            same = (rep["losses"] == tail and rz == [r for r in got
                                                     if r[1] > at]
                    and rep["pool_log"] == full["pool_log"]
                    and rep["stages_history"]
                    == full["stages_history"][at + 1:])
            params_same = _bitwise(torch, rep["params"], full["params"])
            opt_same = _bitwise(torch, rep["opt_state"], full["opt_state"])
            diff = [i for i, (a, b) in enumerate(zip(rep["losses"], tail))
                    if a != b]
            CKPT_RUN.setdefault("restore", {})[at] = (
                rep["timing"]["restore_s"], restored)
            say("ckpt_resume", from_step=at, stages=stages,
                restore_s=f"{rep['timing']['restore_s']:.2f}",
                allocated_gb_after_restore=(
                    f"{rep['timing']['restore_allocated'] / 1e9:.3f}"),
                restored_gb=f"{restored / 1e9:.3f}",
                losses_bitwise=rep["losses"] == tail,
                first_diff_step=(at + 1 + diff[0]) if diff else None,
                max_loss_diff=max([abs(a - b) for a, b in
                                   zip(rep["losses"], tail)] or [0.0]),
                params_bitwise=params_same, moments_bitwise=opt_same,
                resumed_spec_equal=True,
                resizes=json.dumps(rz).replace(" ", ""),
                pool_log=json.dumps(rep["pool_log"]).replace(" ", ""),
                wall_s=f"{rep['wall_s']:.2f}")
            if not (same and params_same and opt_same):
                worst = _tree_diff(torch, rep["params"], full["params"])
                results[at] = (diff, worst)
            del rep
        launched, launched_tc = _window(torch, kernels)
        k3_bwd = pm.KERNEL.launches_bwd
        say("ckpt_train", steps=CKPT_STEPS,
            step_ms=json.dumps([round(t * 1e3, 1)
                                for t in full["step_times"]])
            .replace(" ", ""),
            losses=json.dumps([round(x, 4) for x in full["losses"]])
            .replace(" ", ""), wall_s=f"{full['wall_s']:.2f}",
            launches=json.dumps(launched).replace(" ", ""))
        if results:
            # is the uninterrupted run itself repeatable?
            del full
            free_cuda(torch)
            again = train_run(ckpt_train_args(CKPT_STEPS, CUT_LAYERS))
            first = train_run(ckpt_train_args(CKPT_STEPS, CUT_LAYERS))
            same = again["losses"] == first["losses"]
            spread = max(abs(a - b) for a, b in zip(again["losses"],
                                                    first["losses"]))
            say("ckpt_repeat", runs_bitwise=same, loss_spread=spread,
                params_max_diff=_tree_diff(torch, again["params"],
                                           first["params"])[0])
            raise AssertionError(
                f"resumed runs differ from the uninterrupted one: "
                f"{ {a: (d[:3], w) for a, (d, w) in results.items()} }")
        steps = CKPT_STEPS + sum(CKPT_STEPS - at - 1
                                 for at, _ in CKPT_RESUMES)
        check_launches("ckpt train", launched, CUT_LAUNCHES_PER_STEP,
                       steps)
        if k3_bwd != CUT_K3_BWD_PER_STEP * steps:
            raise AssertionError(f"ckpt train: K3 backward launches {k3_bwd}")
        check_tensor_core("ckpt train", launched, launched_tc, FP32_TC_PATH)
        # phase 7f reads these safe points
        CKPT_RUN.update(dir=ck, tmp=tmp)
    finally:
        if "dir" not in CKPT_RUN:
            shutil.rmtree(tmp, ignore_errors=True)
    free_cuda(torch)
    return launched


def _stage_times(rep) -> str:
    return json.dumps([
        {"step": e["step"], "src": e["source"],
         "s": [round(x, 4) for x in e["seconds"]],
         "expected": ([round(x, 6) for x in e["expected"]]
                      if e.get("expected") else None)}
        for e in rep["stage_times"]]).replace(" ", "")


def run_ctl_phase(torch, kernels):
    """Phase 4l: (i) an engine with in-step timing on a [26, 2, 2, 2]
    split over 4 buffers, 4 steps, then the in-step times and the probe:
    both must rank stage 0 slowest, strictly above every 2-layer stage;
    (ii) ctl_train_args() with --in-step-timing --measure-stage-times
    inline and with --async-controller --async-drain: losses, events and
    stage history bitwise equal; (iii) async without the drain: it
    decides; the same flags untimed, inline and async + drain: bitwise
    equal (measured times are decision inputs that differ from run to run,
    so the timed pair must agree bitwise only where its decisions agree),
    and the untimed inline run beside the timed one is the events'
    overhead; the probe alone gives its times at each cadence.
    Returns the launch counts of (ii), (iii) and the untimed runs (40
    steps, exactly a quarter of the 4c counts a step at 8 layers) plus (i)
    and the probe run."""
    import numpy as np
    from repro_torch.configs import DistConfig, get_config
    from repro_torch.data.loader import DataConfig, make_loader
    from repro_torch.dynamics.config import DynamicsConfig
    from repro_torch.launch.engine import ElasticEngine
    from repro_torch.launch.train import run as train_run
    from repro_torch.pipeline.pipeline import PipelineShapes
    free_cuda(torch)
    # (i) the ranking on a skewed split
    for k in kernels.KERNELS:
        k.reset()
    cfg = get_config("smollm-360m")
    dcfg = DistConfig(num_stages=4, slot_slack=18, param_dtype="float32",
                      kernel_impl="pallas")
    shapes = PipelineShapes(num_micro=4, mb_global=2, seq=1024)
    eng = ElasticEngine(cfg, dcfg, DynamicsConfig(), shapes,
                        in_step_timing=True)
    state = eng.init_state(0, with_opt=True, lps=CTL_SKEW)
    batch = next(make_loader(cfg, DataConfig(4, 2, 1024)))
    if eng.in_step_stage_times(state) is not None:
        raise AssertionError("in-step times before any step")
    for _ in range(4):
        loss, _, _ = eng.step(state, batch, 1e-4)
        float(loss)
    in_step = eng.in_step_stage_times(state)
    probe = eng.measure_stage_times(state, batch)
    rank_launches, rank_tc = _window(torch, kernels)
    say("ctl_rank", lps=json.dumps(CTL_SKEW).replace(" ", ""),
        in_step_s=json.dumps([round(float(x), 5) for x in in_step])
        .replace(" ", ""),
        probe_s=json.dumps([round(float(x), 5) for x in probe])
        .replace(" ", ""),
        launches=json.dumps(rank_launches).replace(" ", ""))
    for name, t in (("in-step", in_step), ("probe", probe)):
        if not (int(np.argmax(t)) == 0
                and all(t[0] > t[i] for i in range(1, 4))):
            raise AssertionError(f"{name} times {list(t)} do not rank the "
                                 f"26-layer stage slowest")
    for name in ("block_sparse_attention", "pruned_matmul"):
        if rank_launches[name] <= 0:
            raise AssertionError(f"ranking never launched {name}")
    check_tensor_core("ctl rank", rank_launches, rank_tc, FP32_TC_PATH)
    del eng, state
    free_cuda(torch)

    # (ii) / (iii) / untimed: one window, no probe runs in it (the in-step
    # times are there at every cadence)
    for k in kernels.KERNELS:
        k.reset()
    runs = {}
    for label, extra in (("inline", CTL_TIMED),
                         ("async_drain", CTL_TIMED + CTL_ASYNC),
                         ("async", CTL_TIMED + ["--async-controller"]),
                         ("untimed", []),
                         ("untimed_async_drain", CTL_ASYNC)):
        rep = train_run(ctl_train_args() + extra)
        torch.cuda.synchronize()
        runs[label] = {
            "losses": rep["losses"], "step_times": rep["step_times"],
            "events": [(e.iteration, e.moved_layers) for e in rep["events"]],
            "stages_history": rep["stages_history"],
            "controller": rep["controller"],
            "decide_s": rep["timing"]["decide_s"],
            "steady_ms": rep["timing"]["steady_step_mean_s"] * 1e3,
            "stage_times": _stage_times(rep),
            "source": rep["stage_time_source"]}
        del rep
        free_cuda(torch)
    launched, launched_tc = _window(torch, kernels)
    for label, r in runs.items():
        say("ctl_train", run=label, mode=r["controller"]["mode"],
            decided=r["controller"]["decided"],
            dropped=r["controller"]["dropped"],
            stale_rejected=r["controller"]["stale_rejected"],
            decide_s=f"{r['decide_s']:.4f}",
            steady_step_ms=f"{r['steady_ms']:.1f}",
            step_ms=json.dumps([round(t * 1e3, 1) for t in r["step_times"]])
            .replace(" ", ""),
            events=json.dumps(r["events"]).replace(" ", ""),
            source=r["source"], stage_times=r["stage_times"])
    # measured stage times are decision inputs that differ from run to
    # run, so the bitwise pair is the untimed one (the straggler knob
    # alone is scale-free, hence deterministic); the timed pair must be
    # bitwise equal whenever its decisions agree
    a, b = runs["untimed"], runs["untimed_async_drain"]
    if not (a["losses"] == b["losses"] and a["events"] == b["events"]
            and a["stages_history"] == b["stages_history"] and a["events"]):
        raise AssertionError(f"async + drain differs from inline: "
                             f"{a['losses']} {b['losses']} {a['events']} "
                             f"{b['events']}")
    a, b = runs["inline"], runs["async_drain"]
    same_events = a["events"] == b["events"]
    if same_events and a["losses"] != b["losses"]:
        raise AssertionError(f"timed async + drain: the inline run's "
                             f"decisions, other losses: {a['losses']} "
                             f"{b['losses']}")
    say("ctl_timed_pair", same_events=same_events,
        losses_bitwise=a["losses"] == b["losses"])
    if a["source"] != "in_step":
        raise AssertionError(f"inline: source {a['source']}")
    if runs["async"]["controller"]["decided"] < 1:
        raise AssertionError("async without drain decided nothing")
    check_launches("ctl train", launched, CUT_LAUNCHES_PER_STEP,
                   CTL_STEPS * len(runs))
    check_tensor_core("ctl train", launched, launched_tc, FP32_TC_PATH)
    cad = [s for s in range(CTL_STEPS) if (s + 1) % 4 == 0]
    say("ctl_cadence", cadence_steps=cad,
        **{f"{k}_ms": json.dumps([round(r["step_times"][s] * 1e3, 1)
                                  for s in cad] + ["next:"] + [
            round(r["step_times"][s + 1] * 1e3, 1) for s in cad[:-1]])
           .replace(" ", "") for k, r in runs.items()},
        in_step_overhead_ms=(
            f"{runs['inline']['steady_ms'] - runs['untimed']['steady_ms']:.1f}"))
    # the probe alone: its times at each cadence (its extra forward
    # launches in a window of their own)
    for k in kernels.KERNELS:
        k.reset()
    rep = train_run(ctl_train_args() + ["--measure-stage-times"])
    probe_launches, probe_tc = _window(torch, kernels)
    say("ctl_probe", source=rep["stage_time_source"],
        steady_step_ms=f"{rep['timing']['steady_step_mean_s'] * 1e3:.1f}",
        stage_times=_stage_times(rep),
        launches=json.dumps(probe_launches).replace(" ", ""))
    if rep["stage_time_source"] != "probe":
        raise AssertionError(f"probe run source {rep['stage_time_source']}")
    for name, n in CUT_LAUNCHES_PER_STEP.items():
        if probe_launches[name] < n * CTL_STEPS:
            raise AssertionError(f"probe run: {name} {probe_launches[name]}")
    check_tensor_core("ctl probe", probe_launches, probe_tc, FP32_TC_PATH)
    del rep
    free_cuda(torch)
    return {n: launched[n] + rank_launches[n] + probe_launches[n]
            for n in launched}


# ---------------------------------------------------------------------------
# phases 4m / 4n / 4o / 4p: sampling and the cluster layer
# ---------------------------------------------------------------------------
SAMPLE_T = 0.8
# the sampler alone: one fixed row of logits (seeded, sigma 2) over the
# vocabulary, drawn with SAMPLE_LANES distinct lane seeds; its Philox words
# are compared with the CPU's on every SAMPLE_CPU_STRIDE-th lane
SAMPLE_LANES = 8192
SAMPLE_CPU_STRIDE = 32
SAMPLE_CHI2_TOP = 32


def sampling_serve_args(requests: int = 12):
    """Phase 4m's flags: phase 4's serve at temperature 0.8."""
    return serve_args(requests) + ["--temperature", str(SAMPLE_T)]


class RecordSamples:
    """Record every draw of the decode head: (lane seeds, ids, logprobs,
    perturbed top-2 gaps) per call of ``sampling.sample``.  The gap is
    computed beside the draw, from the same logits."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.pipeline import sampling
        self._mod, self._orig = sampling, sampling.sample

        def rec(logits, seeds, temperature):
            ids, lp = self._orig(logits, seeds, temperature)
            gap = sampling.top2_gap(logits, seeds, temperature)
            self.calls.append((seeds.cpu(), ids.cpu(), lp.cpu(), gap.cpu()))
            return ids, lp

        sampling.sample = rec
        return self

    def __exit__(self, *exc):
        self._mod.sample = self._orig

    def by_request(self, plens: dict, seed: int = 0) -> dict:
        """{rid: {token index: (id, logprob, gap)}}: a lane's seed is
        ``seed * 1000003 + rid * 8191 + pos`` (the scheduler's), and a
        decode at position ``pos`` emits token ``pos - plen + 1``."""
        key = {}
        for rid, plen in plens.items():
            for pos in range(plen, plen + 64):
                s = (seed * 1000003 + rid * 8191 + pos) & 0x7FFFFFFF
                if s in key:
                    raise AssertionError(f"seed collision at {rid}, {pos}")
                key[s] = (rid, pos - plen + 1)
        out = {rid: {} for rid in plens}
        for seeds, ids, lp, gap in self.calls:
            for s, i, l, g in zip(seeds.tolist(), ids.tolist(), lp.tolist(),
                                  gap.tolist()):
                if s in key:
                    rid, idx = key[s]
                    out[rid][idx] = (i, l, g)
        return out


def _recorded_serve(torch, args, plain: bool = False):
    """(report, draws by request) of one serve of ``args`` with the draws
    recorded, through the kernels or (``plain``) their plain versions."""
    from repro_torch.launch.serve import run as serve_run
    with RecordSamples() as rec:
        if plain:
            with PlainKernels():
                rep = serve_run(args)
        else:
            rep = serve_run(args)
    torch.cuda.synchronize()
    plens = {c["rid"]: c["plen"] for c in rep["completions"]}
    return rep, rec.by_request(plens)


def chi2_p(torch, counts, expected) -> float:
    """Upper tail of the chi-squared statistic (float64), df = bins - 1."""
    c = torch.as_tensor(counts, dtype=torch.float64)
    e = torch.as_tensor(expected, dtype=torch.float64)
    stat = float(((c - e) ** 2 / e).sum())
    df = len(c) - 1
    return float(torch.special.gammaincc(torch.tensor(df / 2.0,
                                                      dtype=torch.float64),
                                         torch.tensor(stat / 2.0,
                                                      dtype=torch.float64)))


def check_sampler(torch) -> dict:
    """The sampler alone on [SAMPLE_LANES, 49152] logits on the card: its
    Philox words bitwise the CPU's (every SAMPLE_CPU_STRIDE-th lane, whole
    rows), a chi-squared test of the draws over the SAMPLE_CHI2_TOP likeliest
    ids plus a rest bucket against softmax(logits / T), p >= 1e-4; and its
    time per decode tick at the serve's shape (2 microbatch rows of 4
    lanes) against the argmax head's."""
    from repro_torch.pipeline import sampling
    V = 49152
    g = torch.Generator(device="cpu").manual_seed(11)
    row = torch.randn(V, generator=g) * 2.0
    seeds = torch.arange(SAMPLE_LANES, dtype=torch.int32)
    words = sampling.philox_words(seeds.cuda(), V)
    sub = seeds[::SAMPLE_CPU_STRIDE]
    words_equal = bool(torch.equal(words[::SAMPLE_CPU_STRIDE].cpu(),
                                   sampling.philox_words(sub, V)))
    del words
    if not words_equal:
        raise AssertionError("sampler: Philox words differ between the card "
                             "and the CPU")
    logits = row.cuda().expand(SAMPLE_LANES, V)
    ids, lp = sampling.sample(logits, seeds.cuda(), SAMPLE_T)
    again = sampling.sample(logits, seeds.cuda(), SAMPLE_T)
    if not (torch.equal(ids, again[0]) and torch.equal(lp, again[1])):
        raise AssertionError("sampler: a repeat is not bitwise equal")
    probs = torch.softmax(row.double() / SAMPLE_T, -1)
    top = probs.topk(SAMPLE_CHI2_TOP).indices
    counts = torch.bincount(ids.long().cpu(), minlength=V).double()
    obs = torch.cat([counts[top], (counts.sum() - counts[top].sum())[None]])
    exp = torch.cat([probs[top], (1 - probs[top].sum())[None]]) * SAMPLE_LANES
    p = chi2_p(torch, obs, exp)
    if p < 1e-4:
        raise AssertionError(f"sampler: chi-squared p = {p:.3e} < 1e-4")
    lp_err = float((lp.cpu() - torch.log_softmax(row, -1)[ids.long().cpu()])
                   .abs().max())
    if lp_err > 1e-5:
        raise AssertionError(f"sampler: logprob off by {lp_err:.3e}")
    del logits, ids, lp, again
    # per decode tick at the serve's shape: 2 rows of 4 lanes
    lg = torch.randn(4, V, generator=g).cuda()
    sd = torch.arange(4, dtype=torch.int32).cuda()
    sample_ms = cuda_ms(lambda: sampling.sample(lg, sd, SAMPLE_T)) * 2

    def argmax_head():
        nid = torch.argmax(lg, dim=-1)
        return torch.log_softmax(lg, dim=-1).gather(-1, nid[:, None])

    argmax_ms = cuda_ms(argmax_head) * 2
    return {"words_bitwise": words_equal, "chi2_p": p,
            "chi2_bins": SAMPLE_CHI2_TOP + 1, "draws": SAMPLE_LANES,
            "top_mass": float(probs[top].sum()), "lp_err": lp_err,
            "sample_ms_per_tick": sample_ms,
            "argmax_ms_per_tick": argmax_ms}


def run_sampling_serve_phase(torch, kernels, argmax_tokens, argmax_rep):
    """Phase 4m: phase 4's serve at temperature 0.8 — counted and timed;
    then twice with the draws recorded (ids and logprobs bitwise equal, the
    tokens the counted run's) and once through the plain versions (the same
    ids before each request's first draw whose perturbed top-2 gap, read
    from the plain run, is <= 1e-3); the streams differ from phase 4's
    argmax streams but for the prefill's first token of a full-length
    prompt; the sampler alone (``check_sampler``).  Returns the counted
    run's launches."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.launch.serve import run as serve_run
    free_cuda(torch)
    for k in kernels.KERNELS:
        k.reset()
    rep = serve_run(sampling_serve_args())
    torch.cuda.synchronize()
    launched = {k.name: k.launches for k in kernels.KERNELS}
    launched_tc = {k.name: k.launches_tc for k in kernels.KERNELS}
    k6_split = pa_ops.KERNEL.launches_split
    missing = [n for n in ("block_sparse_attention", "pruned_matmul",
                           "paged_attention") if launched[n] <= 0]
    if missing:
        raise AssertionError(f"sampling serve never launched {missing}")
    check_k6_split(launched["paged_attention"], k6_split)
    check_tensor_core("sampling serve", launched, launched_tc,
                      ("block_sparse_attention", "pruned_matmul"))
    tokens = {c["rid"]: c["tokens"] for c in rep["completions"]}
    plens = {c["rid"]: c["plen"] for c in rep["completions"]}
    seq = rep["spec"]["serve"]["prompt_len"]
    if sorted(tokens) != sorted(argmax_tokens):
        raise AssertionError("sampling serve completed other requests")
    for rid, toks in tokens.items():
        want = argmax_tokens[rid]
        if len(toks) != len(want):
            raise AssertionError(f"request {rid}: {len(toks)} tokens, the "
                                 f"argmax serve {len(want)}")
        if plens[rid] == seq and toks[0] != want[0]:
            raise AssertionError(f"request {rid}: the first token is not "
                                 f"the prefill's argmax")
        if len(toks) > 1 and toks == want:
            raise AssertionError(f"request {rid}: sampling at T "
                                 f"{SAMPLE_T} reproduced the argmax stream")
    # determinism: two recorded runs, bitwise
    free_cuda(torch)
    rep_a, draws_a = _recorded_serve(torch, sampling_serve_args())
    free_cuda(torch)
    rep_b, draws_b = _recorded_serve(torch, sampling_serve_args())
    for r in (rep_a, rep_b):
        if {c["rid"]: c["tokens"] for c in r["completions"]} != tokens:
            raise AssertionError("a recorded sampling serve's tokens differ "
                                 "from the counted run's")
    if draws_a != draws_b:
        raise AssertionError("two sampling serves drew different ids or "
                             "logprobs")
    n_draws = sum(len(d) for d in draws_a.values())
    # the plain versions: equal ids up to the first small perturbed gap
    free_cuda(torch)
    rep_p, draws_p = _recorded_serve(torch, sampling_serve_args(),
                                     plain=True)
    plain_tokens = {c["rid"]: c["tokens"] for c in rep_p["completions"]}
    compared = flips = 0
    for rid, toks in tokens.items():
        small = [i for i, (_, _, gap) in sorted(draws_p[rid].items())
                 if gap <= 1e-3]
        f = min(small) if small else len(toks)
        if toks[:f] != plain_tokens[rid][:f]:
            raise AssertionError(f"request {rid}: the kernels' and the plain "
                                 f"versions' ids differ before the first "
                                 f"gap <= 1e-3 (token {f})")
        compared += f
        flips += int(toks != plain_tokens[rid])
    min_gap = min(g for d in draws_p.values() for (_, _, g) in d.values())
    sampler = check_sampler(torch)
    tick_p50 = float(sorted(rep["tick_wall_s"])[len(rep["tick_wall_s"])
                                                // 2])
    say("sampling_serve", temperature=SAMPLE_T,
        requests=len(tokens), tokens=rep["total_tokens"],
        ticks=rep["ticks"], tokens_per_s=f"{rep['tokens_per_s']:.1f}",
        p50_ms=f"{rep['latency_p50_s'] * 1e3:.1f}",
        p95_ms=f"{rep['latency_p95_s'] * 1e3:.1f}",
        argmax_tokens_per_s=f"{argmax_rep['tokens_per_s']:.1f}",
        argmax_p50_ms=f"{argmax_rep['latency_p50_s'] * 1e3:.1f}",
        argmax_p95_ms=f"{argmax_rep['latency_p95_s'] * 1e3:.1f}",
        tick_p50_ms=f"{tick_p50 * 1e3:.2f}",
        draws=n_draws, repeat_bitwise=True,
        plain_compared_tokens=compared, plain_flips=flips,
        plain_min_gap=f"{min_gap:.3e}",
        launches=json.dumps(launched).replace(" ", ""),
        k6_split_launches=k6_split)
    say("sampler", words_bitwise_cpu=sampler["words_bitwise"],
        lanes=SAMPLE_LANES, cpu_lanes=SAMPLE_LANES // SAMPLE_CPU_STRIDE,
        chi2_p=f"{sampler['chi2_p']:.4f}", chi2_bins=sampler["chi2_bins"],
        top_mass=f"{sampler['top_mass']:.4f}",
        lp_err=f"{sampler['lp_err']:.2e}",
        sample_ms_per_tick=f"{sampler['sample_ms_per_tick']:.4f}",
        argmax_ms_per_tick=f"{sampler['argmax_ms_per_tick']:.4f}",
        share_of_tick_p50=(
            f"{sampler['sample_ms_per_tick'] / (tick_p50 * 1e3):.4f}"))
    del rep, rep_a, rep_b, rep_p
    free_cuda(torch)
    return launched, launched_tc


def autoscale_train_args(job_manager: str, steps: int = 20):
    """Phase 4n's flags: phase 4h's without --grow-back (4 stage buffers of
    16 slots, the prune at step 10, --repack) at CUT_LAYERS layers, 20
    steps, the asynchronous
    controller waited for (so the decision lands on a fixed step),
    --autoscale --simulate-recover 18 and a job manager; a call's retries
    share 4 s (a manager answers ~0.5 s after its start, so (iii)'s call
    to the dead manager stalls the step by the whole budget)."""
    return ckpt_train_args(steps, CUT_LAYERS) + [
        "--async-controller", "--async-drain", "--autoscale",
        "--simulate-recover", "18", "--job-manager", job_manager,
        "--rpc-timeout-s", "4"]


# phase 4n (iii): the chaos plan kills the file manager after this step
# (before the controller's shrink at 14) and respawns it after the second;
# 30 % of the messages are lost and 30 % duplicated.  At fault seed 7 the
# first four status calls (steps 0-3) lose one request and duplicate two
# answers, and the replayed release and the grant after step 18 lose none
# (the rolls of scripts/torch_chaos_soak.py's transport, in call order)
AUTOSCALE_KILL, AUTOSCALE_RESPAWN = 12, 16
AUTOSCALE_CHAOS_SEED, AUTOSCALE_STATUS_STEPS = 7, 4


def autoscale_chaos_args(trace_out: Optional[str] = None):
    """Phase 4n (iii)'s flags: (i)'s under the pinned RPC-chaos plan,
    traced into ``trace_out`` (7g: untraced)."""
    trace = ([] if trace_out is None else
             ["--set", "obs.trace=true",
              "--set", f"obs.trace_out={trace_out}"])
    return autoscale_train_args("file") + [
        "--chaos", "--chaos-seed", str(AUTOSCALE_CHAOS_SEED),
        "--set", f"faults.manager_kill={AUTOSCALE_KILL}",
        "--set", f"faults.manager_respawn={AUTOSCALE_RESPAWN}",
        "--set", "faults.rpc_loss=0.3", "--set", "faults.rpc_dup=0.3"] + trace


def check_rpc_chaos(rep, journal, dead_seqs) -> dict:
    """4n (iii)'s fault log against the manager's journal: at least one
    lost request and one duplicated answer; every request lost while the
    manager ran (its sequence number not in ``dead_seqs``) answered under
    its own number; the journal's pool log the client's, no worker in it
    twice.  Returns the counts."""
    recs = [f for f in rep["faults"] if f["kind"] in ("rpc_loss",
                                                      "rpc_dup")]
    lost = [f["detail"]["seq"] for f in recs if f["kind"] == "rpc_loss"]
    dups = [f["detail"]["seq"] for f in recs if f["kind"] == "rpc_dup"]
    if not lost or not dups:
        raise AssertionError(f"no rpc_loss or no rpc_dup record: {recs}")
    answered = {int(k) for k in journal["answered"]}
    unanswered = [q for q in lost if q not in answered
                  and q not in dead_seqs]
    if unanswered:
        raise AssertionError(f"lost requests {unanswered} never answered")
    server_log = journal["pool"]["log"]
    if server_log != rep["pool_log"]:
        raise AssertionError(f"the manager's pool log {server_log} vs the "
                             f"client's {rep['pool_log']}")
    if len(set(server_log)) != len(server_log):
        raise AssertionError(f"a transition twice in the pool log "
                             f"{server_log}")
    if rep["rpc"]["stats"]["retries"] < len(lost):
        raise AssertionError(f"{len(lost)} losses, rpc stats "
                             f"{rep['rpc']['stats']}")
    return {"lost": lost, "duplicated": dups}


def run_autoscale_train_phase(torch, kernels):
    """Phase 4n: autoscaled training across the file RPC boundary — (i)
    with a file manager in its own process, (ii) the same flags in
    process, (iii) as (i) under the pinned RPC-chaos plan (the manager
    killed before the shrink and respawned after step 16, 30 % of the
    messages lost and 30 % duplicated), traced.  (i): shrink 4 -> 2
    releasing [2, 3], the heartbeat recovery grows [2, 3] back at or after
    step 18, pool log release:2, release:3, grant:2, grant:3, an autoscale
    grow naming {2, 3}; (i) and (ii) bitwise in losses, resizes, params
    and both Adam moments; (iii) defers the release and replays it, its
    losses, resizes, params and moments bitwise (i)'s, its fault log and
    the manager's journal as ``check_rpc_chaos`` requires, its trace valid.
    Counts zeroed before (i) and read after (iii)."""
    from repro_torch.cluster.rpc import FileJobManager
    from repro_torch.kernels.pruned_matmul import ops as pm
    from repro_torch.launch.train import run as train_run
    free_cuda(torch)
    for k in kernels.KERNELS:
        k.reset()
    rtt = []

    def time_rpc(step, sess):
        t0 = time.perf_counter()
        sess.job_manager._call("status")
        rtt.append(time.perf_counter() - t0)

    file_run = train_run(autoscale_train_args("file"), on_step=time_rpc)
    torch.cuda.synchronize()
    # phase 4r's crashed training is held to this run
    AUTOSCALE_FILE_RUN.update(
        losses=list(file_run["losses"]),
        stages_history=list(file_run["stages_history"]),
        step_times=list(file_run["step_times"]),
        pool_log=list(file_run["pool_log"]),
        digests=state_digests(file_run["params"], file_run["opt_state"]))
    rz = [(r["kind"], r["step"], r["from_stages"], r["to_stages"],
           r["workers"]) for r in file_run["resizes"]]
    if ([(k, a, b, w) for k, _, a, b, w in rz]
            != [("shrink", 4, 2, [2, 3]), ("grow", 2, 4, [2, 3])]
            or rz[1][1] < 18):
        raise AssertionError(f"autoscaled train resizes {rz}: the controller "
                             f"must shrink 4 -> 2 releasing [2, 3] and the "
                             f"heartbeat recovery grow them back at >= 18")
    if file_run["pool_log"] != ["release:2", "release:3", "grant:2",
                                "grant:3"]:
        raise AssertionError(f"pool log {file_run['pool_log']}")
    if not any(d["action"] == "grow" and set(d["ids"]) == {2, 3}
               for d in file_run["autoscale_decisions"]):
        raise AssertionError(f"no autoscale grow of {{2, 3}}: "
                             f"{file_run['autoscale_decisions']}")
    free_cuda(torch)
    inproc = train_run(autoscale_train_args("inproc"))
    torch.cuda.synchronize()
    rz_in = [(r["kind"], r["step"], r["from_stages"], r["to_stages"],
              r["workers"]) for r in inproc["resizes"]]
    same = (inproc["losses"] == file_run["losses"] and rz_in == rz
            and _bitwise(torch, inproc["params"], file_run["params"])
            and _bitwise(torch, inproc["opt_state"], file_run["opt_state"]))
    if not same:
        raise AssertionError(
            f"in-process and file manager runs differ: resizes {rz_in} vs "
            f"{rz}, worst leaf "
            f"{_tree_diff(torch, inproc['params'], file_run['params'])}")
    del inproc
    free_cuda(torch)
    import os
    import tempfile
    import threading
    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    trace_out = os.path.join(trace_dir, "train.json")
    seen = {"seqs": {}}

    def chaos_steps(step, sess):
        # status round trips while the manager runs (the chaos transport
        # rolls loss and duplication on each); the injector has already
        # fired this step's kill or respawn
        jm = sess.job_manager
        if step < AUTOSCALE_STATUS_STEPS:
            jm._call("status")
        if step in (AUTOSCALE_KILL, AUTOSCALE_RESPAWN):
            seen["seqs"][step] = jm._seq
            seen["jm_dir"] = sess.jm_dir
        if step == AUTOSCALE_RESPAWN:
            # time the respawned manager's first answer on a thread of its
            # own (a probe numbered far past the run's requests): the run
            # itself does not wait for it
            t_up = time.perf_counter()

            def probe():
                p = FileJobManager(sess.jm_dir, timeout_s=60.0,
                                   shutdown_on_close=False)
                p._seq = 10 ** 6
                p._call("status")
                seen["respawn_s"] = time.perf_counter() - t_up

            seen["probe"] = threading.Thread(target=probe, daemon=True)
            seen["probe"].start()

    degraded = train_run(autoscale_chaos_args(trace_out),
                         on_step=chaos_steps)
    torch.cuda.synchronize()
    seen["probe"].join(timeout=60)
    with open(os.path.join(seen["jm_dir"], "state.json")) as f:
        journal = json.load(f)
    dead = set(range(seen["seqs"][AUTOSCALE_KILL] + 1,
                     seen["seqs"][AUTOSCALE_RESPAWN] + 1))
    chaos = check_rpc_chaos(degraded, journal, dead)
    sys.path.insert(0, str(ROOT / "scripts"))
    import torch_check_trace
    if torch_check_trace.main([trace_out, "--expect-event", "train",
                               "--expect-event", "train.step",
                               "--expect-event", "controller.decide",
                               "--expect-event", "controlplane.decide",
                               "--expect-event", "rpc.release",
                               "--expect-event", "rpc.request"]) != 0:
        raise AssertionError("the chaos run's trace does not validate")
    with open(trace_out) as f:
        n_trace = len(json.load(f)["traceEvents"])
    import shutil
    shutil.rmtree(trace_dir, ignore_errors=True)
    if not (_bitwise(torch, degraded["params"], file_run["params"])
            and _bitwise(torch, degraded["opt_state"],
                         file_run["opt_state"])):
        raise AssertionError(
            f"the chaos run's state differs from the uninterrupted one: "
            f"{_tree_diff(torch, degraded['params'], file_run['params'])}")
    launched, launched_tc = _window(torch, kernels)
    k3_bwd = pm.KERNEL.launches_bwd
    want_events = ["release deferred: [2, 3]", "replayed release:[2, 3]"]
    if degraded["degraded_events"] != want_events:
        raise AssertionError(f"degraded events {degraded['degraded_events']}")
    if degraded["losses"] != file_run["losses"]:
        raise AssertionError("the run with the manager stopped differs from "
                             "the uninterrupted one")
    # phase 7g's ranks run (iii)'s plan and are held to its logs
    AUTOSCALE_FILE_RUN["chaos"] = {
        "faults": fault_log(degraded),
        "pool_log": list(degraded["pool_log"]),
        "resizes": [(r["kind"], r["step"], r["from_stages"], r["to_stages"],
                     list(r["workers"])) for r in degraded["resizes"]],
        "degraded_events": list(degraded["degraded_events"])}
    rz_d = [(r["kind"], r["step"], r["from_stages"], r["to_stages"],
             r["workers"]) for r in degraded["resizes"]]
    if rz_d != rz:
        raise AssertionError(f"degraded resizes {rz_d} vs {rz}")
    steps = 3 * file_run["spec"]["steps"]
    check_launches("autoscale train", launched, CUT_LAUNCHES_PER_STEP,
                   steps)
    if k3_bwd != CUT_K3_BWD_PER_STEP * steps:
        raise AssertionError(f"autoscale train: K3 backward launches "
                             f"{k3_bwd}")
    check_tensor_core("autoscale train", launched, launched_tc, FP32_TC_PATH)
    for name, rep in (("file", file_run), ("degraded", degraded)):
        for r in rep["resizes"]:
            say("autoscale_train_resize", run=name, kind=r["kind"],
                step=r["step"], stages=f"{r['from_stages']}->"
                f"{r['to_stages']}", workers=r["workers"],
                seconds=f"{r['seconds']:.4f}")
    rtt_ms = sorted(t * 1e3 for t in rtt)
    say("autoscale_train", steps=file_run["spec"]["steps"],
        resizes=json.dumps(rz).replace(" ", ""),
        pool_log=json.dumps(file_run["pool_log"]).replace(" ", ""),
        decisions=json.dumps([(d["step"], d["action"], d["ids"])
                              for d in file_run["autoscale_decisions"]])
        .replace(" ", ""),
        inproc_bitwise=True, degraded_bitwise=True,
        degraded_events=json.dumps(degraded["degraded_events"],
                                   separators=(",", ":")),
        killed_after=AUTOSCALE_KILL, respawned_after=AUTOSCALE_RESPAWN,
        respawn_answer_s=f"{seen.get('respawn_s', float('nan')):.2f}",
        rpc_lost=json.dumps(chaos["lost"]).replace(" ", ""),
        rpc_duplicated=json.dumps(chaos["duplicated"]).replace(" ", ""),
        trace_events=n_trace,
        steady_step_ms=f"{file_run['timing']['steady_step_mean_s'] * 1e3:.1f}",
        traced_steady_step_ms=(
            f"{degraded['timing']['steady_step_mean_s'] * 1e3:.1f}"),
        rpc_rtt_ms_p50=f"{rtt_ms[len(rtt_ms) // 2]:.3f}",
        rpc_rtt_ms_max=f"{rtt_ms[-1]:.3f}",
        rpc_stats=json.dumps(file_run["rpc"]["stats"]).replace(" ", ""),
        degraded_rpc=json.dumps(degraded["rpc"]).replace(" ", ""),
        step_ms_by_world=json.dumps(world_ms(file_run["step_times"],
                                             file_run["stages_history"]))
        .replace(" ", ""),
        losses=json.dumps([round(x, 4) for x in file_run["losses"]])
        .replace(" ", ""),
        launches=json.dumps(launched).replace(" ", ""))
    del file_run, degraded
    free_cuda(torch)
    return launched, launched_tc


def autoscale_serve_args(autoscale: bool = True):
    """Phase 4o's flags: phase 4i's serve (4 stage buffers, paged KV) on a
    trace of two bursts of 16 requests 48 ticks apart (nothing arrives in
    between, so the pipeline drains and then backs up again), with the
    reference's serving autoscale knobs (min 2 stages, queue watermark 2,
    occupancy 0.6, patience 2, cooldown 3)."""
    args = [a for a in elastic_serve_args()]
    args[args.index("--requests") + 1] = "32"
    args += ["--burst-period", "48", "--burst-len", "4", "--lull-rate", "0",
             "--min-stages", "2", "--queue-high", "2", "--occupancy-low",
             "0.6", "--patience", "2", "--cooldown", "3"]
    return args + (["--autoscale"] if autoscale else [])


def run_autoscale_serve_phase(torch, kernels):
    """Phase 4o: the serve CLI's server on autoscale_serve_args(): at least
    one load-driven shrink and one grow, tokens identical to the same trace
    served on a fixed world, the page pool bitwise through one more shrink
    / grow cycle on the live state (the trash block excluded), every K6
    launch split.  Returns the autoscaled serve's launch counts."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    free_cuda(torch)
    with serve_session(autoscale_serve_args(False)) as s:
        fixed = s.serve()
    free_cuda(torch)
    sess = serve_session(autoscale_serve_args())
    for k in kernels.KERNELS:
        k.reset()
    rep = sess.serve()
    srv = sess.server
    torch.cuda.synchronize()
    launched = {k.name: k.launches for k in kernels.KERNELS}
    launched_tc = {k.name: k.launches_tc for k in kernels.KERNELS}
    k6_split = pa_ops.KERNEL.launches_split
    check_k6_split(launched["paged_attention"], k6_split)
    check_tensor_core("autoscale serve", launched, launched_tc,
                      ("block_sparse_attention", "pruned_matmul"))
    kinds = [r["kind"] for r in rep["resizes"]]
    if "shrink" not in kinds or "grow" not in kinds:
        raise AssertionError(f"autoscaled serve resizes {kinds}: a "
                             f"load-driven shrink and grow are required")
    want = {c["rid"]: c["tokens"] for c in fixed["completions"]}
    got = {c["rid"]: c["tokens"] for c in rep["completions"]}
    if got != want or len(got) != sess.spec.serve.requests:
        raise AssertionError("the autoscaled serve's tokens differ from the "
                             "fixed world's")
    before = {k: v.clone() for k, v in srv.state.cache.items()}
    stages = srv.state.stages
    if stages > 2:                  # down to 2 and back
        srv.state = srv.engine.shrink(srv.state, 2, step=1000)
        srv.state = srv.engine.grow(srv.state, stages - 2, step=1001)
    else:                           # up to 4 and back
        srv.state = srv.engine.grow(srv.state, 2, step=1000)
        srv.state = srv.engine.shrink(srv.state, 2, step=1001)
    if srv.state.stages != stages:
        raise AssertionError(f"resize cycle ended on {srv.state.stages} "
                             f"stages, not {stages}")
    for k, v in before.items():
        if not torch.equal(srv.state.cache[k][:, :, :-1], v[:, :, :-1]):
            raise AssertionError(f"page pool leaf {k} changed through a "
                                 f"resize cycle")
    say("autoscale_serve", requests=len(got), tokens=rep["total_tokens"],
        ticks=rep["ticks"], tokens_equal_fixed=True, pool_bitwise=True,
        resizes=json.dumps([(r["kind"], r["step"], r["from_stages"],
                             r["to_stages"]) for r in rep["resizes"]])
        .replace(" ", ""),
        decisions=len(rep["autoscale_decisions"]),
        stages_hist=json.dumps(rep["stages_history"]).replace(" ", ""),
        tick_ms_by_world=json.dumps(world_ms(rep["tick_wall_s"],
                                             rep["stages_history"]))
        .replace(" ", ""),
        fixed_tokens_per_s=f"{fixed['tokens_per_s']:.1f}",
        tokens_per_s=f"{rep['tokens_per_s']:.1f}",
        p95_ms=f"{rep['latency_p95_s'] * 1e3:.1f}",
        fixed_p95_ms=f"{fixed['latency_p95_s'] * 1e3:.1f}",
        pool_log=json.dumps(rep["pool_log"]).replace(" ", ""),
        launches=json.dumps(launched).replace(" ", ""),
        k6_split_launches=k6_split)
    sess.close()
    del sess, srv, rep, fixed, before
    free_cuda(torch)
    return launched, launched_tc


# phase 4p: a child process runs a CLI's main, then prints its launch
# counts and peak memory on lines of their own
TENANT_CHILD = """
import json, sys, torch
sys.path.insert(0, {src!r})
from repro_torch import kernels
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.launch.{cli} import main
main({argv!r})
torch.cuda.synchronize()
print("LAUNCHES " + json.dumps({{k.name: [k.launches, k.launches_tc]
                                for k in kernels.KERNELS}}))
print("K6_SPLIT " + str(pa_ops.KERNEL.launches_split))
print("PEAK " + str(torch.cuda.max_memory_allocated()))
"""
TENANT_TRAIN_STEPS = 32


def _tenant(cli: str, argv, log_path: str):
    with open(log_path, "w") as log:
        return subprocess.Popen(
            [sys.executable, "-c", TENANT_CHILD.format(
                src=str(ROOT / "src"), cli=cli, argv=argv)],
            stdout=log, stderr=subprocess.STDOUT, text=True, cwd=str(ROOT))


def _child_report(log_path: str) -> dict:
    with open(log_path) as f:
        text = f.read()
    out = {"log": text}
    for line in text.splitlines():
        head, _, rest = line.partition(" ")
        if head == "LAUNCHES":
            out["launches"] = json.loads(rest)
        elif head == "K6_SPLIT":
            out["k6_split"] = int(rest)
        elif head == "PEAK":
            out["peak"] = int(rest)
    return out


def replay_scheduler_events(events, tenants) -> dict:
    """The scheduler's event stream (its ``metrics`` verb) must reproduce
    its books: replaying the grant / yield / fail records in order never
    grants a worker to a tenant while another holds it, never gives back a
    worker its tenant does not hold, and leaves each tenant exactly the
    workers the verb's tenant table lists.  Returns the per (tenant, event)
    counts."""
    holder, counts = {}, {}
    for e in events:
        t, ev, w = e["tenant"], e["ev"], e["worker"]
        counts[f"{t}:{ev}"] = counts.get(f"{t}:{ev}", 0) + 1
        if ev == "grant":
            if w in holder:
                raise AssertionError(f"worker {w} granted to {t} while "
                                     f"{holder[w]} holds it")
            holder[w] = t
        elif ev in ("yield", "fail"):
            if holder.get(w) != t:
                raise AssertionError(f"{t} gave back worker {w} it did not "
                                     f"hold")
            del holder[w]
    for tid in set(holder.values()) | set(tenants):
        held = sorted(w for w, h in holder.items() if h == tid)
        books = sorted(tenants.get(tid, {}).get("granted", []))
        if held != books:
            raise AssertionError(f"tenant {tid}: the events leave {held}, "
                                 f"the books {books}")
    return counts


def run_two_tenant_phase(torch, kernels):
    """Phase 4p: an HTTP manager over 6 workers in its own process, a
    trainer process (tenant train, priority 0, 4h's stage buffers and
    prune without --repack, --repack-target 2 as its floor, 32 steps) and a
    server process (tenant serve, priority 10, 4o's trace and autoscale
    knobs) sharing the card: serve's burst steals a training worker, train
    is preempted and shrinks at a safe point, the lull yields the workers
    back and train absorbs them; the scheduler's event stream reproduces
    its grant books and never grants a worker to two tenants; both traced,
    the manager's GET /metrics equal to the events stream and the traces
    holding the steal -> preempt -> shrink chain.  Returns the two
    processes' summed launch counts."""
    import os
    import shutil
    import tempfile
    from repro_torch.cluster.http_rpc import (HttpJobManager,
                                              spawn_http_manager)
    free_cuda(torch)
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_tenants_")
    mgr, url = spawn_http_manager(run_dir, 6, idle_timeout_s=900)
    train_events = os.path.join(run_dir, "train_events.json")
    serve_events = os.path.join(run_dir, "serve_events.json")
    logs = {n: os.path.join(run_dir, f"{n}.log") for n in ("train", "serve")}
    traces = {n: os.path.join(run_dir, f"{n}.trace.json")
              for n in ("train", "serve")}
    train_argv = [a for a in ckpt_train_args(TENANT_TRAIN_STEPS)
                  if a != "--repack"] + [
        "--repack-target", "2", "--log-every", "1000", "--job-manager",
        "http", "--manager-url", url, "--tenant-id", "train", "--priority",
        "0", "--events-out", train_events, "--set", "obs.trace=true",
        "--set", f"obs.trace_out={traces['train']}"]
    serve_argv = autoscale_serve_args() + [
        "--job-manager", "http", "--manager-url", url, "--tenant-id",
        "serve", "--priority", "10", "--events-out", serve_events,
        "--set", "obs.trace=true", "--set",
        f"obs.trace_out={traces['serve']}"]
    probe = HttpJobManager(url, client_id="chip-smoke-probe")
    children = {}
    t0 = time.perf_counter()
    try:
        children["train"] = _tenant("train", train_argv, logs["train"])
        # the trainer claims its 4 before the server joins, so the serve
        # burst has to steal
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            t = probe.cluster_metrics()["tenants"].get("train")
            if t and len(t["granted"]) == 4:
                break
            if children["train"].poll() is not None:
                break
            time.sleep(0.2)
        else:
            raise AssertionError("the trainer never registered")
        children["serve"] = _tenant("serve", serve_argv, logs["serve"])
        for name, proc in children.items():
            rc = proc.wait(timeout=900)
            if rc != 0:
                raise AssertionError(
                    f"tenant {name} exited {rc}:\n"
                    f"{_child_report(logs[name])['log'][-3000:]}")
        metrics = probe.cluster_metrics()
        # the Prometheus page, scraped while the manager still runs
        page = _scrape(url + "/metrics")
    finally:
        for proc in children.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        try:
            HttpJobManager(url, client_id="chip-smoke-stop", timeout_s=10,
                           shutdown_on_close=True).close()
        except (OSError, RuntimeError):
            pass
        probe.close()
        try:
            mgr.wait(timeout=20)
        except subprocess.TimeoutExpired:
            mgr.kill()
            mgr.wait()
    wall = time.perf_counter() - t0
    reports = {n: _child_report(p) for n, p in logs.items()}
    with open(train_events) as f:
        tev = json.load(f)
    with open(serve_events) as f:
        sev = json.load(f)
    scraped = check_scheduler_scrape(page, metrics["events"])
    sys.path.insert(0, str(ROOT / "scripts"))
    import torch_check_trace
    chain_ok = torch_check_trace.main(
        [traces["serve"], traces["train"], "--expect-chain",
         "rpc.steal,cluster.preempt,resize.shrink"]) == 0
    shutil.rmtree(run_dir, ignore_errors=True)
    tkinds = [e["kind"] for e in tev]
    skinds = [e["kind"] for e in sev]
    failures = []
    if "steal" not in skinds:
        failures.append("serve never stole")
    if "preempt" not in tkinds:
        failures.append("train never received a preemption")
    if not any(e["kind"] == "resize"
               and e["data"]["resize_kind"] == "shrink[preempt]"
               for e in tev):
        failures.append("train never shrank on the preemption")
    if "yield" not in skinds:
        failures.append("serve never yielded")
    if "absorb" not in tkinds:
        failures.append("train never absorbed the yielded workers")
    per_kind = replay_scheduler_events(metrics["events"],
                                       metrics["tenants"])
    if per_kind.get("train:preempt_due", 0) < 1:
        failures.append("the scheduler posted no preemption")
    if not chain_ok:
        failures.append("the traces hold no rpc.steal -> cluster.preempt "
                        "-> resize.shrink chain")
    if failures:
        raise AssertionError("; ".join(failures) + "\n" + "\n".join(
            reports[n]["log"][-2000:] for n in reports))
    launched, launched_tc = {}, {}
    for rep in reports.values():
        for name, (n, tc) in rep["launches"].items():
            launched[name] = launched.get(name, 0) + n
            launched_tc[name] = launched_tc.get(name, 0) + tc
    check_launches("tenant train", {k: v[0] for k, v in
                                    reports["train"]["launches"].items()},
                   TRAIN_LAUNCHES_PER_STEP, TENANT_TRAIN_STEPS)
    check_tensor_core("two tenants", launched, launched_tc, FP32_TC_PATH)
    serve_k6 = reports["serve"]["launches"]["paged_attention"][0]
    check_k6_split(serve_k6, reports["serve"]["k6_split"])
    t_rz = [(e["step"], e["data"]["resize_kind"], e["data"]["from_stages"],
             e["data"]["to_stages"], e["data"]["workers"])
            for e in tev if e["kind"] == "resize"]
    s_rz = [(e["step"], e["data"]["resize_kind"], e["data"]["from_stages"],
             e["data"]["to_stages"], e["data"]["workers"])
            for e in sev if e["kind"] == "resize"]
    say("two_tenants", wall_s=f"{wall:.1f}",
        train_resizes=json.dumps(t_rz).replace(" ", ""),
        serve_resizes=json.dumps(s_rz).replace(" ", ""),
        train_events=json.dumps(sorted(set(tkinds))).replace(" ", ""),
        serve_events=json.dumps(sorted(set(skinds))).replace(" ", ""),
        scheduler_events=json.dumps(per_kind).replace(" ", ""),
        metrics_page_equal_events=len(scraped), trace_chain=chain_ok,
        train_peak_gb=f"{reports['train']['peak'] / 1e9:.3f}",
        serve_peak_gb=f"{reports['serve']['peak'] / 1e9:.3f}",
        launches=json.dumps(launched).replace(" ", ""))
    free_cuda(torch)
    return launched, launched_tc


# ---------------------------------------------------------------------------
# phase 4q: the front door — RunSpec configs, Session, the one-shot serve,
# the scenarios and the resumed spec
FRONT_DOOR_STEPS = 6


def dump_config(cli: str, argv, path: str) -> None:
    """Write the RunSpec the CLI resolves from ``argv`` with its own
    ``--dump-config`` (in process) to ``path``."""
    import contextlib
    import importlib
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        importlib.import_module(f"repro_torch.launch.{cli}").main(
            argv + ["--dump-config"])
    with open(path, "w") as f:
        f.write(out.getvalue())


def one_shot_oracle(torch, kernels):
    """Phase 4q (iii): ``run_serving`` at full width (1 stage, micro 2, mb
    4, prompt 1024, gen 32, fp32, the kernels) against ``ElasticServer``
    serving the same 8 prompts arriving at once: the tokens must be equal
    (the reference's oracle).  Returns (tokens/s, launch window)."""
    import numpy as np
    from repro_torch.configs import DistConfig, get_config
    from repro_torch.dynamics.config import DynamicsConfig
    from repro_torch.launch.serve import run_serving
    from repro_torch.pipeline.pipeline import PipelineShapes
    from repro_torch.serve import ElasticServer
    from repro_torch.serve.requests import Request
    micro, mbg, plen, gen = 2, 4, 1024, 32
    free_cuda(torch)
    for k in kernels.KERNELS:
        k.reset()
    out = run_serving("smollm-360m", stages=1, micro=micro, mb_global=mbg,
                      prompt_len=plen, gen=gen, layers=None,
                      kernel_impl="pallas", param_dtype="float32", seed=0)
    window = _window(torch, kernels)
    cfg = get_config("smollm-360m")
    dcfg = DistConfig(num_stages=1, slot_slack=2, remat="none",
                      param_dtype="float32", kernel_impl="pallas")
    prompts = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                               (micro, mbg, plen))
    reqs = [Request(rid=i, arrival=0,
                    prompt=prompts[i // mbg, i % mbg].astype(np.int32),
                    gen=gen) for i in range(micro * mbg)]
    srv = ElasticServer(cfg, dcfg, DynamicsConfig(),
                        PipelineShapes(micro, mbg, plen,
                                       cache_len=plen + gen), seed=0)
    rep = srv.serve(reqs)
    srv.close()
    for i, c in enumerate(rep["completions"]):
        want = out["tokens"][i // mbg, i % mbg].tolist()
        if c["tokens"] != want:
            raise AssertionError(f"one-shot serve lane {i} differs from the "
                                 f"continuous server: {want[:8]} vs "
                                 f"{c['tokens'][:8]}")
    del srv, rep
    free_cuda(torch)
    return out, window


def run_front_door_phase(torch, kernels, serve_tokens):
    """Phase 4q: (i) train_args()'s RunSpec written by the train CLI's
    ``--dump-config`` and trained FRONT_DOOR_STEPS steps through
    ``python -m repro_torch.launch.train --config`` (in process): losses
    bitwise phase 4c's first steps, the same rebalance events, K1-K3 at
    4c's counts a step on the tensor cores; (ii) serve_args(12)'s RunSpec
    written by the serve CLI and served through
    ``Session(RunSpec.load(path)).serve()``: tokens identical to phase
    4's, K1, K3 and K6 launched, every K6 launch split; (iii) the one-shot
    ``run_serving`` equal to the continuous server; (iv) each of the six
    ``configs/scenarios/*.json`` trained 3 steps on the card (``--set
    steps=3``; CPU scale, the scan path); (v) phase 4k resumed both safe
    points through ``Session.resume`` with the writer's RunSpec.  Counts
    zeroed before and read after each of (i)-(iii); returns their sums."""
    import glob
    import os
    import tempfile
    from repro_torch.api import RunSpec, Session
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.pruned_matmul import ops as pm
    from repro_torch.launch import train as train_cli
    tmp = tempfile.mkdtemp(prefix="chip_smoke_api_")
    t_phase = time.perf_counter()
    total, total_tc = {}, {}

    def add(window):
        for n, v in window[0].items():
            total[n] = total.get(n, 0) + v
        for n, v in window[1].items():
            total_tc[n] = total_tc.get(n, 0) + v

    # (i) train from a config
    train_json = os.path.join(tmp, "train.json")
    dump_config("train", train_args(), train_json)
    spec = RunSpec.load(train_json)
    if spec.model.layers is not None or spec.parallel.seq != 1024:
        raise AssertionError(f"dumped train spec is not full size: "
                             f"{spec.model}, {spec.parallel}")
    free_cuda(torch)
    for k in kernels.KERNELS:
        k.reset()
    t0 = time.perf_counter()
    rep = train_cli.run(["--config", train_json, "--set",
                         f"steps={FRONT_DOOR_STEPS}"])
    train_s = time.perf_counter() - t0
    window = _window(torch, kernels)
    k3_bwd = pm.KERNEL.launches_bwd
    want = TRAIN_4C["losses"][:FRONT_DOOR_STEPS]
    if rep["losses"] != want:
        raise AssertionError(f"config-file train losses {rep['losses']} are "
                             f"not phase 4c's first {FRONT_DOOR_STEPS} "
                             f"{want}")
    events = [(e.iteration, e.moved_layers) for e in rep["events"]]
    want_events = [e for e in TRAIN_4C["events"]
                   if e[0] <= FRONT_DOOR_STEPS]
    if events != want_events:
        raise AssertionError(f"config-file train events {events} vs phase "
                             f"4c's {want_events}")
    check_launches("front door train", window[0], TRAIN_LAUNCHES_PER_STEP,
                   FRONT_DOOR_STEPS)
    if k3_bwd != TRAIN_K3_BWD_PER_STEP * FRONT_DOOR_STEPS:
        raise AssertionError(f"front door train: K3 backward launches "
                             f"{k3_bwd}")
    check_tensor_core("front door train", window[0], window[1],
                      FP32_TC_PATH)
    add(window)
    train_losses = rep["losses"]
    del rep
    # (ii) serve from a config
    serve_json = os.path.join(tmp, "serve.json")
    dump_config("serve", serve_args(12), serve_json)
    free_cuda(torch)
    for k in kernels.KERNELS:
        k.reset()
    t0 = time.perf_counter()
    with Session(RunSpec.load(serve_json)) as sess:
        rep = sess.serve()
    serve_s = time.perf_counter() - t0
    window = _window(torch, kernels)
    got = {c["rid"]: c["tokens"] for c in rep["completions"]}
    if got != serve_tokens:
        raise AssertionError("config-file serve tokens differ from phase 4's")
    missing = [n for n in ("block_sparse_attention", "pruned_matmul",
                           "paged_attention") if window[0][n] <= 0]
    if missing:
        raise AssertionError(f"config-file serve never launched {missing}")
    check_k6_split(window[0]["paged_attention"],
                   pa_ops.KERNEL.launches_split)
    check_tensor_core("front door serve", window[0], window[1],
                      FP32_TC_PATH)
    add(window)
    serve_tps = rep["tokens_per_s"]
    del rep
    # (iii) the one-shot serve
    t0 = time.perf_counter()
    one_shot, window = one_shot_oracle(torch, kernels)
    one_shot_s = time.perf_counter() - t0
    missing = [n for n in ("block_sparse_attention", "pruned_matmul")
               if window[0][n] <= 0]
    if missing:
        raise AssertionError(f"one-shot serve never launched {missing}")
    check_tensor_core("one-shot serve", window[0], window[1],
                      ("block_sparse_attention", "pruned_matmul"))
    add(window)
    # (iv) the six scenarios, 3 steps each
    scen = {}
    t0 = time.perf_counter()
    for path in sorted(glob.glob(str(ROOT / "configs" / "scenarios" /
                                     "*.json"))):
        name = os.path.basename(path)[:-5]
        free_cuda(torch)
        r = train_cli.run(["--config", path, "--set", "steps=3"])
        if (len(r["losses"]) != 3
                or not all(math.isfinite(x) for x in r["losses"])):
            raise AssertionError(f"scenario {name}: losses {r['losses']}")
        if r["device"] != "cuda" or r["spec"] != RunSpec.load(path).override(
                {"steps": 3}).to_dict():
            raise AssertionError(f"scenario {name} ran {r['device']} / "
                                 f"another spec")
        scen[name] = round(r["losses"][-1], 4)
    scen_s = time.perf_counter() - t0
    # (v) phase 4k's resumes
    if sorted(RESUMED_SPECS) != sorted(at for at, _ in CKPT_RESUMES):
        raise AssertionError(f"phase 4k resumed {RESUMED_SPECS} through "
                             f"Session.resume with the writer's RunSpec")
    say("front_door", train_steps=FRONT_DOOR_STEPS,
        train_bitwise_4c=True, train_s=f"{train_s:.2f}",
        losses=json.dumps([round(x, 4) for x in train_losses])
        .replace(" ", ""),
        events=json.dumps(events).replace(" ", ""),
        serve_tokens_equal_4=True, serve_s=f"{serve_s:.2f}",
        serve_tokens_per_s=f"{serve_tps:.1f}",
        one_shot_equal_server=True,
        one_shot_tokens_per_s=f"{one_shot['tokens_per_s']:.1f}",
        one_shot_wall_s=f"{one_shot['wall_s']:.2f}",
        one_shot_check_s=f"{one_shot_s:.2f}",
        scenarios=json.dumps(scen).replace(" ", ""),
        scenarios_s=f"{scen_s:.2f}",
        resumed_spec_equal=json.dumps(sorted(RESUMED_SPECS)),
        seconds=f"{time.perf_counter() - t_phase:.1f}",
        launches=json.dumps(total).replace(" ", ""))
    free_cuda(torch)
    return total, total_tc


# ---------------------------------------------------------------------------
# phase 4r: faults — a worker crash in training and in serving
# ---------------------------------------------------------------------------
# the reference chaos soak's loss tolerance (scripts/chaos_soak.py)
LOSS_TOL = 3e-3
# 4r (i): worker 2 crashes after this step (before the controller's
# shrink at 14), a 2.5x straggler spike lands after FAULT_SPIKE_STEP (the
# plan of tests/test_torch_faults.py)
FAULT_CRASH_STEP, FAULT_CRASH_WORKER, FAULT_SPIKE_STEP = 4, 2, 14
# 4r (ii): the serving worker 2 crashes after this tick
FAULT_SERVE_TICK = 8
# a near-tie: a token whose top-2 logit gap is at most this may flip
NEAR_TIE = 1e-3
# phase 4n (i)'s run (and under "chaos" (iii)'s logs) and phase 4i's
# fixed serve, held for 4r and 7g; 4r (ii)'s crashed serve, held for 7g
AUTOSCALE_FILE_RUN = {}
ELASTIC_FIXED = {}
CRASH_SERVE = {}


def fault_log(rep) -> list:
    """A report's fault records as (step, kind, detail)."""
    return [(f["step"], f["kind"], f["detail"]) for f in rep["faults"]]


class RecordGaps:
    """Record the top-2 logit gap behind every token a serve emits:
    ``gaps[rid][token index]``.  The gaps are read from the head's logits
    of each prefill and decode call (``models.model.lm_logits``) and
    paired with their requests when the scheduler records the call's ids;
    a requeued lane's replayed positions emit no token and are skipped."""

    def __enter__(self):
        import torch
        from repro_torch.models import model as M
        from repro_torch.serve import scheduler as S
        self.gaps = {}
        pending = []
        self._undo = [(M, "lm_logits", M.lm_logits),
                      (S.Scheduler, "note_prefill", S.Scheduler.note_prefill),
                      (S.Scheduler, "note_decode", S.Scheduler.note_decode)]
        lm_logits, note_prefill, note_decode = (u[2] for u in self._undo)

        def rec_logits(*a, **kw):
            out = lm_logits(*a, **kw)
            top2 = out.float().topk(2, dim=-1).values
            pending.append(top2[:, 0] - top2[:, 1])
            return out

        def take(sched, lanes):
            rows = torch.stack(pending).cpu() if pending else None
            pending.clear()
            for lane in lanes:
                if lane in sched.replay:
                    continue
                mi, bi = sched.slots.unravel(lane)
                r = sched.live[lane]
                self.gaps.setdefault(r.rid, {})[len(r.tokens)] = float(
                    rows[mi, bi])

        def rec_prefill(sched, plan, ids, tick):
            take(sched, plan.full_len_lanes)
            return note_prefill(sched, plan, ids, tick)

        def rec_decode(sched, plan, ids, tick):
            take(sched, plan.lanes)
            return note_decode(sched, plan, ids, tick)

        M.lm_logits = rec_logits
        S.Scheduler.note_prefill = rec_prefill
        S.Scheduler.note_decode = rec_decode
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._undo:
            setattr(owner, name, fn)


def first_parting(a, b) -> int:
    """The first index at which two histories differ (len if none)."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return min(len(a), len(b))


def check_crash_train(rep, worker: int, base) -> dict:
    """4r (i)'s checks of a chaos run ``rep`` against the fault-free run
    ``base`` ({losses, stages_history, step_times}): the crashed worker
    was evicted (an evict resize naming it, ``fail:<worker>`` in the pool
    log), every loss finite, within LOSS_TOL of the fault-free run's and
    bitwise up to the step at which the stage histories part.  Returns the
    largest difference, that step and the time to recover (the crash to
    the first step on the smaller world)."""
    evicts = [r for r in rep["resizes"] if r["kind"] == "evict"]
    if not any(worker in r["workers"] for r in evicts):
        raise AssertionError(f"no evict of worker {worker}: resizes "
                             f"{[(r['kind'], r['workers']) for r in rep['resizes']]}")
    if f"fail:{worker}" not in rep["pool_log"]:
        raise AssertionError(f"fail:{worker} not in the pool log "
                             f"{rep['pool_log']}")
    losses = rep["losses"]
    if len(losses) != len(base["losses"]) or not all(
            math.isfinite(x) for x in losses):
        raise AssertionError(f"chaos losses {losses}")
    diffs = [abs(a - b) for a, b in zip(losses, base["losses"])]
    if max(diffs) >= LOSS_TOL:
        raise AssertionError(f"chaos loss differs by {max(diffs):.3e} "
                             f"(tolerance {LOSS_TOL})")
    part = first_parting(rep["stages_history"], base["stages_history"])
    if losses[:part] != base["losses"][:part]:
        raise AssertionError(f"losses differ before the stage histories "
                             f"part at step {part}")
    crash = [f["step"] for f in rep["faults"] if f["kind"] == "worker_crash"]
    if not crash:
        raise AssertionError(f"no worker_crash fired: {rep['faults']}")
    ev = next(r for r in evicts if worker in r["workers"])
    times = rep["step_times"]
    return {"max_loss_diff": max(diffs), "part_step": part,
            "crash_step": crash[0], "evict_step": ev["step"],
            "recover_steps": ev["step"] + 1 - crash[0],
            "recover_s": (sum(times[crash[0] + 1:ev["step"] + 1])
                          + ev["seconds"]),
            "evict_s": ev["seconds"]}


def check_crash_serve(rep, fixed_tokens, fixed_gaps) -> list:
    """4r (ii)'s checks of a chaos serve ``rep`` against the fixed run
    (tokens and top-2 gaps by request and token index): the same request
    set, requests requeued, an evict, and each request's tokens the fixed
    run's up to its first token whose fixed-run gap is at most NEAR_TIE
    (a later token follows another context).  Returns the flips
    [(rid, token index, gap)]."""
    got = {c["rid"]: c["tokens"] for c in rep["completions"]}
    if set(got) != set(fixed_tokens):
        raise AssertionError(f"requests {sorted(got)} vs the fixed run's "
                             f"{sorted(fixed_tokens)}")
    if rep["requeued_total"] <= 0:
        raise AssertionError("the crash requeued no request")
    if not any(r["kind"] == "evict" for r in rep["resizes"]):
        raise AssertionError(f"no evict: resizes "
                             f"{[r['kind'] for r in rep['resizes']]}")
    flips = []
    for rid, want in fixed_tokens.items():
        i = first_parting(got[rid], want)
        if i == len(want) == len(got[rid]):
            continue
        gap = fixed_gaps.get(rid, {}).get(i)
        if gap is None or gap > NEAR_TIE:
            raise AssertionError(f"request {rid} differs at token {i}, "
                                 f"fixed-run top-2 gap {gap}")
        flips.append((rid, i, gap))
    return flips


_PROM_NUM = r"(-?\d+(?:\.\d+)?(?:e[-+]?\d+)?)"


def check_serve_scrape(page: str, rep) -> tuple:
    """A serve's GET /metrics page against its report: the emitted
    positions (``dynmo_serve_tokens_total``) are the ticks' tokens, which
    are the completions' tokens plus the positions requeued lanes replayed
    (none without a crash); the ticks are the report's.  Returns the
    scraped count and the replayed positions."""
    m = re.search(r"^dynmo_serve_tokens_total " + _PROM_NUM + "$", page,
                  re.M)
    t = re.search(r"^dynmo_serve_ticks_total " + _PROM_NUM + "$", page,
                  re.M)
    if m is None or t is None:
        raise AssertionError("the /metrics page has no serve counters")
    scraped = float(m.group(1))
    emitted = sum(rep["tick_tokens"])
    replayed = emitted - rep["total_tokens"]
    if scraped != emitted or replayed < 0:
        raise AssertionError(
            f"/metrics counts {scraped} tokens, the report {emitted} "
            f"emitted, {rep['total_tokens']} in the completions")
    if replayed and not rep["requeued_total"]:
        raise AssertionError(f"{replayed} positions replayed without a "
                             f"requeue")
    if float(t.group(1)) != rep["ticks"]:
        raise AssertionError(f"/metrics counts {t.group(1)} ticks, the "
                             f"report {rep['ticks']}")
    return int(scraped), replayed


def check_scheduler_scrape(page: str, events) -> dict:
    """The HTTP manager's GET /metrics against the scheduler's events
    stream: ``dynmo_scheduler_events_total`` per (tenant, event) equal to
    the stream's counts.  Returns the counts."""
    scraped = {}
    for m in re.finditer(r'^dynmo_scheduler_events_total\{event="([^"]*)",'
                         r'tenant="([^"]*)"\} ' + _PROM_NUM + "$", page,
                         re.M):
        scraped[f"{m.group(2)}:{m.group(1)}"] = float(m.group(3))
    want = {}
    for e in events:
        k = f"{e['tenant']}:{e['ev']}"
        want[k] = want.get(k, 0.0) + 1.0
    if not scraped or scraped != want:
        raise AssertionError(f"/metrics {scraped} vs the events stream "
                             f"{want}")
    return scraped


def _free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _scrape(url: str) -> str:
    import urllib.request
    with urllib.request.urlopen(url, timeout=30) as r:
        if "version=0.0.4" not in r.headers.get("Content-Type", ""):
            raise AssertionError(f"{url}: content type "
                                 f"{r.headers.get('Content-Type')}")
        return r.read().decode()


def _pct50(xs) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else float("nan")


def run_fault_phase(torch, kernels):
    """Phase 4r: (i) 4n (i)'s training with worker 2 crashing after step 4
    and a 2.5x straggler spike after step 14; (ii) 4i's server with worker
    2 crashing at tick 8, GET /metrics and in-step timing.  Each window's
    counts zeroed just before and read just after; returns ({"chaos_train":
    launches, "chaos_serve": launches}, summed tensor-core launches)."""
    from repro_torch.api import Session
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.pruned_matmul import ops as pm
    # (i) training
    free_cuda(torch)
    for k in kernels.KERNELS:
        k.reset()
    spec = cli_spec("train", autoscale_train_args("file")).override({
        "faults.enabled": True, "faults.seed": 1,
        "faults.worker_crash": {FAULT_CRASH_STEP: FAULT_CRASH_WORKER},
        "faults.straggler_spike": {FAULT_SPIKE_STEP: 2.5}})
    with Session(spec) as s:
        rep = s.train()
    train_launches, train_tc = _window(torch, kernels)
    k3_bwd = pm.KERNEL.launches_bwd
    steps = spec.steps
    check_launches("chaos train", train_launches, CUT_LAUNCHES_PER_STEP,
                   steps)
    if k3_bwd != CUT_K3_BWD_PER_STEP * steps:
        raise AssertionError(f"chaos train: K3 backward launches {k3_bwd}")
    check_tensor_core("chaos train", train_launches, train_tc, FP32_TC_PATH)
    got = check_crash_train(rep, FAULT_CRASH_WORKER, AUTOSCALE_FILE_RUN)
    say("chaos_train", steps=steps,
        faults=json.dumps([(f["step"], f["kind"], f["detail"])
                           for f in rep["faults"]]).replace(" ", ""),
        resizes=json.dumps([(r["kind"], r["step"], r["from_stages"],
                             r["to_stages"], r["workers"])
                            for r in rep["resizes"]]).replace(" ", ""),
        pool_log=json.dumps(rep["pool_log"]).replace(" ", ""),
        decisions=json.dumps([(d["step"], d["action"], d["ids"])
                              for d in rep["autoscale_decisions"]])
        .replace(" ", ""),
        max_loss_diff=f"{got['max_loss_diff']:.3e}", tol=LOSS_TOL,
        stages_part_at_step=got["part_step"],
        crash_step=got["crash_step"], evict_step=got["evict_step"],
        recover_steps=got["recover_steps"],
        recover_s=f"{got['recover_s']:.3f}", evict_s=f"{got['evict_s']:.4f}",
        step_ms_by_world=json.dumps(world_ms(rep["step_times"],
                                             rep["stages_history"]))
        .replace(" ", ""),
        losses=json.dumps([round(x, 4) for x in rep["losses"]])
        .replace(" ", ""),
        launches=json.dumps(train_launches).replace(" ", ""))
    del rep
    free_cuda(torch)
    # (ii) serving
    port = _free_port()
    spec = cli_spec("serve", elastic_serve_args()).override({
        "faults.enabled": True, "faults.seed": 1,
        "faults.worker_crash": {FAULT_SERVE_TICK: FAULT_CRASH_WORKER},
        "cluster.spares": 1, "obs.metrics_port": port,
        "obs.in_step_timing": True})
    for k in kernels.KERNELS:
        k.reset()
    with Session(spec) as s:
        rep = s.serve()
        torch.cuda.synchronize()
        page = _scrape(f"http://127.0.0.1:{port}/metrics")
    serve_launches, serve_tc = _window(torch, kernels)
    k6_split = pa_ops.KERNEL.launches_split
    check_k6_split(serve_launches["paged_attention"], k6_split)
    missing = [n for n in ("block_sparse_attention", "pruned_matmul",
                           "paged_attention") if serve_launches[n] <= 0]
    if missing:
        raise AssertionError(f"chaos serve never launched {missing}")
    check_tensor_core("chaos serve", serve_launches, serve_tc,
                      ("block_sparse_attention", "pruned_matmul"))
    flips = check_crash_serve(rep, ELASTIC_FIXED["tokens"],
                              ELASTIC_FIXED["gaps"])
    # phase 7g's ranks serve the same crash and are held to it
    CRASH_SERVE.update(
        tokens={c["rid"]: c["tokens"] for c in rep["completions"]},
        requeues={c["rid"]: c["requeues"] for c in rep["completions"]},
        requeued_total=rep["requeued_total"],
        resizes=[(r["kind"], r["step"], list(r["workers"]))
                 for r in rep["resizes"]])
    scraped, replayed = check_serve_scrape(page, rep)
    if rep["stage_time_source"] != "in_step" or not rep[
            "measured_stage_times"]:
        raise AssertionError(f"serve stage times from "
                             f"{rep['stage_time_source']}")
    say("chaos_serve", requests=len(rep["completions"]),
        requeued=rep["requeued_total"],
        resizes=json.dumps([(r["kind"], r["step"], r["workers"],
                             round(r["seconds"], 4))
                            for r in rep["resizes"]]).replace(" ", ""),
        flips=json.dumps(flips).replace(" ", ""),
        compared_tokens=sum(len(c["tokens"]) for c in rep["completions"]),
        scraped_tokens_total=scraped, total_tokens=rep["total_tokens"],
        replayed_positions=replayed,
        ticks=rep["ticks"], fixed_ticks=ELASTIC_FIXED["ticks"],
        wall_s=f"{rep['wall_s']:.2f}",
        fixed_wall_s=f"{ELASTIC_FIXED['wall_s']:.2f}",
        tick_p50_ms=f"{_pct50(rep['tick_wall_s']) * 1e3:.1f}",
        fixed_tick_p50_ms=f"{ELASTIC_FIXED['tick_p50'] * 1e3:.1f}",
        stage_times_ms=json.dumps([round(t * 1e3, 3) for t in
                                   rep["measured_stage_times"]])
        .replace(" ", ""),
        stage_time_source=rep["stage_time_source"],
        launches=json.dumps(serve_launches).replace(" ", ""),
        k6_split_launches=k6_split)
    del rep
    free_cuda(torch)
    return ({"chaos_train": train_launches, "chaos_serve": serve_launches},
            {n: train_tc[n] + serve_tc[n] for n in train_tc})


def mod_bitwise(torch) -> None:
    """Phase 4j: one training step's loss and gradients with --dynamism
    mod from the same params and batch as with none, through the kernels:
    the loss and every stage gradient bitwise equal (``mod_on`` is zero, as
    in the reference, so MoD's mix passes every block output unchanged).
    The embedding's gradient is a scatter-add over the batch's tokens whose
    order is not fixed (two "none" steps differ in it too), so it is held
    within 1e-6 of its largest entry."""
    from repro_torch.configs import DistConfig, get_config
    from repro_torch.data.loader import DataConfig, make_loader
    from repro_torch.dynamics.config import DynamicsConfig
    from repro_torch.launch.engine import ElasticEngine
    from repro_torch.models import model as M
    from repro_torch.pipeline.pipeline import (PipelineShapes,
                                               build_loss_fn,
                                               value_and_grad)
    free_cuda(torch)
    cfg = dataclasses.replace(get_config("smollm-360m"), num_layers=4)
    dcfg = DistConfig(num_stages=2, slot_slack=2, remat="none",
                      param_dtype="float32", kernel_impl="pallas")
    shapes = PipelineShapes(4, 2, 1024)
    eng = ElasticEngine(cfg, dcfg, DynamicsConfig(), shapes, device="cuda")
    st = eng.init_state(0)
    batch = eng._batch(next(make_loader(cfg, DataConfig(4, 2, 1024))))
    out = {}
    for kind in ("none", "mod"):
        dyncfg = DynamicsConfig(kind=kind)
        dyn = M.init_dyn(cfg, dcfg, dyncfg, "cuda")
        out[kind] = value_and_grad(build_loss_fn(cfg, dcfg, dyncfg, shapes),
                                   st.params, st.assignment, dyn, batch)
    (l0, _, g0), (l1, _, g1) = out["none"], out["mod"]
    if not torch.equal(l0, l1):
        raise AssertionError(f"mod loss {float(l1)} != none {float(l0)}")
    n, embed_err = 0, 0.0
    for (path, a), (_, b) in zip(leaves(g0), leaves(g1)):
        if path in ("/embed", "/head"):
            embed_err = max(embed_err, leaf_err(b, a))
            if embed_err > 1e-6:
                raise AssertionError(f"mod grad {path}: {embed_err:.3e}")
        elif not torch.equal(a, b):
            raise AssertionError(f"mod grad {path} differs from none")
        else:
            n += 1
    say("mod_bitwise", loss=f"{float(l0):.6f}", loss_equal=True,
        grad_leaves_equal=n, embed_grad_rel_err=f"{embed_err:.3e}")
    del eng, st, batch, out, g0, g1
    free_cuda(torch)


# ---------------------------------------------------------------------------
# phases 3f and 6a-6d: the remaining block families
# ---------------------------------------------------------------------------
def cut_arch(base: str, layers: int, encoder_layers: int = None) -> str:
    """Register ``base`` at its published widths cut to ``layers`` layers
    (and ``encoder_layers`` encoder layers) and return its name."""
    from repro_torch.configs import get_config, register
    cfg = get_config(base)
    name = f"{base}-{layers}l"
    kw = dict(name=name, num_layers=layers)
    if encoder_layers is not None:
        kw["num_encoder_layers"] = encoder_layers
        name = kw["name"] = f"{base}-{encoder_layers}e{layers}d"
    if cfg.slstm_positions:
        kw["slstm_positions"] = tuple(p for p in cfg.slstm_positions
                                      if p < layers)
    register(dataclasses.replace(cfg, **kw))
    return name


# (label, b, sq, sk, hq, hkv, d, causal): the attention shapes of the
# families' paths (whisper's encoder: 1500 = 11 x 128 + 92 frames, so every
# launch has a ragged tail; its cross attention 448 x 1500; the zamba2
# shared block; InternVL2 at seq + 256 patches, hd 128, GQA 6; gpt-paper
# at hd 32)
FAMILY_ATTN = [
    ("whisper-enc s1500 noncausal", 1, 1500, 1500, 20, 20, 64, False),
    ("whisper-cross 448x1500", 1, 448, 1500, 20, 20, 64, False),
    ("whisper-dec s448 causal", 1, 448, 448, 20, 20, 64, True),
    ("zamba2 s1024 32x64", 2, 1024, 1024, 32, 32, 64, True),
    ("internvl2 s768 hd128 48:8", 2, 768, 768, 48, 8, 128, True),
    ("gpt-paper s2048 hd32", 1, 2048, 2048, 32, 32, 32, True),
]


def _pairs(b, sq, sk, hq, causal):
    """Live (q, k) pairs of a dense mask."""
    if causal:
        return b * hq * sum(min(i + 1, sk) for i in range(sq))
    return b * hq * sq * sk


def check_family_attention(torch, F):
    """K1, K2a and K2b at FAMILY_ATTN's shapes, fp32, dense mask (block
    128): each against its plain version (K1 1e-4; K2 2e-4 of the largest
    entry), the kernel's distance from float64 at most twice the plain
    version's (K1's out, K2a's dq and K2b's dk / dv from the same lse and
    delta), all on the tensor cores; the kernel, plain and SDPA times and
    the bound.  Returns {kernel: {case: numbers}}."""
    from repro_torch.kernels.block_sparse_attention import ops, ref
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(23)
    out_cases = {"block_sparse_attention": {},
                 "block_sparse_attention_bwd_dq": {},
                 "block_sparse_attention_bwd_dkv": {}}
    for label, b, sq, sk, hq, hkv, d, causal in FAMILY_ATTN:
        q = torch.randn((b, sq, hq, d), generator=g, device=dev) * 0.5
        k, v = (torch.randn((b, sk, hkv, d), generator=g, device=dev) * 0.5
                for _ in range(2))
        block = 128
        m = torch.ones((1, 1, -(-sq // block), -(-sk // block)),
                       dtype=torch.int32, device=dev)
        kw = dict(causal=causal, block=block)
        trio = (ops.KERNEL, ops.KERNEL_DQ, ops.KERNEL_DKV)
        tc0 = [kk.launches_tc for kk in trio]
        out, lse = ops.block_sparse_attention_fwd(q, k, v, m, **kw)
        rout, _ = ref.block_sparse_attention_ref(q, k, v, m, **kw)
        e1 = check_close(f"K1 {label}", out, rout, 1e-4, 1e-4)
        exact, _ = ref.block_sparse_attention_ref(
            q, k, v, m, compute_dtype=torch.float64, **kw)
        f1 = f64_distance(f"K1 {label}", out, rout, exact)
        del exact, rout
        dout = torch.randn(out.shape, generator=g, device=dev)
        delta = ((dout * out).sum(-1).transpose(1, 2).contiguous())
        dq = ops.block_sparse_attention_bwd_dq(q, k, v, m, dout, lse, delta,
                                               **kw)
        dk, dv = ops.block_sparse_attention_bwd_dkv(q, k, v, m, dout, lse,
                                                    delta, **kw)
        torch.cuda.synchronize()
        ran = [kk.launches_tc - t for kk, t in zip(trio, tc0)]
        if ran != [1, 1, 1]:
            raise AssertionError(f"K1/K2 {label}: tensor-core launches "
                                 f"{ran}, want [1, 1, 1]")
        rdq, rdk, rdv = ref.block_sparse_attention_bwd_ref(
            q, k, v, m, dout, lse, delta, **kw)
        e2a = rel_err(f"K2a {label} dq", dq, rdq, 2e-4)
        e2b = max(rel_err(f"K2b {label} dk", dk, rdk, 2e-4),
                  rel_err(f"K2b {label} dv", dv, rdv, 2e-4))
        xq = ref.block_sparse_attention_bwd_dq_ref(
            q, k, v, m, dout, lse, delta, compute_dtype=torch.float64, **kw)
        f2a = f64_distance(f"K2a {label}", dq, rdq, xq)
        # dk / dv from the same lse and delta in float64
        p_, ds_, qf_, _, of_ = ref._recompute(q, k, v, m, dout, lse, delta,
                                              causal, block, torch.float64)
        xk = ref._group_sum(ds_.transpose(-1, -2) @ qf_, hkv)
        xv = ref._group_sum(p_.transpose(-1, -2) @ of_, hkv)
        del p_, ds_, qf_, of_
        f2b = f64_distance(f"K2b {label}",
                           torch.cat([dk.flatten(), dv.flatten()]),
                           torch.cat([rdk.flatten(), rdv.flatten()]),
                           torch.cat([xk.flatten(), xv.flatten()]))
        del xq, xk, xv, rdq, rdk, rdv
        # times: kernel, plain version, SDPA (kv heads repeated beforehand)
        args = (q, k, v, m, dout, lse, delta)
        t = dict(
            k1=cuda_ms(lambda: ops.block_sparse_attention_fwd(q, k, v, m,
                                                              **kw)),
            k1_plain=cuda_ms(lambda: ref.block_sparse_attention_ref(
                q, k, v, m, **kw), warmup=1, iters=5),
            k2a=cuda_ms(lambda: ops.block_sparse_attention_bwd_dq(*args,
                                                                  **kw)),
            k2b=cuda_ms(lambda: ops.block_sparse_attention_bwd_dkv(*args,
                                                                   **kw)),
            k2a_plain=cuda_ms(lambda: ref.block_sparse_attention_bwd_dq_ref(
                *args, **kw), warmup=1, iters=5),
            k2b_plain=cuda_ms(lambda: ref.block_sparse_attention_bwd_dkv_ref(
                *args, **kw), warmup=1, iters=5))
        qt = q.transpose(1, 2).detach().requires_grad_(True)
        kt, vt = (x.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
                  .detach().requires_grad_(True) for x in (k, v))
        dot = dout.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal)

        with torch.no_grad():
            t["sdpa"] = cuda_ms(sdpa)
        t["sdpa_bwd"] = cuda_ms(lambda: torch.autograd.grad(
            sdpa(), (qt, kt, vt), dot)) - t["sdpa"]
        pairs = _pairs(b, sq, sk, hq, causal)
        qb, kvb = 4.0 * b * sq * hq * d, 4.0 * b * sk * hkv * d
        shape = (f"b{b} sq{sq} sk{sk} hq{hq} hkv{hkv} d{d} "
                 f"{'causal' if causal else 'non-causal'} fp32")
        rows = (
            ("block_sparse_attention", t["k1"], t["k1_plain"], t["sdpa"],
             bound(4.0 * d * pairs, 2 * qb + 2 * kvb + 4.0 * b * hq * sq),
             e1, f1),
            ("block_sparse_attention_bwd_dq", t["k2a"], t["k2a_plain"],
             t["sdpa_bwd"], bound(6.0 * d * pairs, 3 * qb + 2 * kvb
                                  + 8.0 * b * hq * sq), e2a, f2a),
            ("block_sparse_attention_bwd_dkv", t["k2b"], t["k2b_plain"],
             t["sdpa_bwd"], bound(8.0 * d * pairs, 2 * qb + 4 * kvb
                                  + 8.0 * b * hq * sq), e2b, f2b))
        for name, ms, plain, lib, bd, err, f64 in rows:
            out_cases[name][label] = dict(
                shape=shape, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=bd[0], bound_by=bd[1], max_abs_err=err, **f64)
            say("kernels", kernel=name, case=label.replace(" ", "_"),
                shape=repr(shape), variant="tc", ms=f"{ms:.4f}",
                plain_ms=f"{plain:.4f}", library_ms=f"{lib:.4f}",
                bound_ms=f"{bd[0]:.4f}", bound_by=bd[1],
                max_abs_err=f"{err:.3e}", **f64)
        del q, k, v, out, lse, dout, delta, dq, dk, dv, qt, kt, vt
        free_cuda(torch)
    return out_cases


def check_family_ffn(torch):
    """K3 at whisper's FFN (M 1500 frames, d 1280, d_ff 5120, 40 blocks of
    128): the up-projection (mask over N, all live) and the down-projection
    (mask over K, half the blocks pruned), forward and the backward pair,
    fp32, on the tensor cores, against torch.matmul (allow_tf32 off), each
    at most twice torch.matmul's distance from float64; times beside
    torch.matmul's and the bound."""
    from repro_torch.kernels.pruned_matmul import ops
    from repro_torch.kernels.pruned_matmul.backward import pruned_matmul_bwd
    g = torch.Generator(device="cuda").manual_seed(24)
    M, D, FF, blk = 1500, 1280, 5120, 128
    cases = {}
    for axis, keep in (("n", 1.0), ("k", 0.5)):
        K, N = (D, FF) if axis == "n" else (FF, D)
        x = torch.randn((M, K), generator=g, device="cuda")
        w = torch.randn((K, N), generator=g, device="cuda") * K ** -0.5
        gr = torch.randn((M, N), generator=g, device="cuda")
        mask = (torch.rand((FF // blk,), generator=g, device="cuda")
                < keep).float()
        mask[0] = 1.0
        me = mask.repeat_interleave(blk)
        tc0 = ops.KERNEL.launches_tc
        y = ops.product(x, w, mask, axis, blk)
        dx, dw = pruned_matmul_bwd(x, w, mask, gr, mask_axis=axis, blk=blk)
        torch.cuda.synchronize()
        if ops.KERNEL.launches_tc - tc0 != 3:
            raise AssertionError(f"K3 whisper {axis}: "
                                 f"{ops.KERNEL.launches_tc - tc0} of 3 "
                                 f"launches on the tensor cores")
        # the plain versions: torch.matmul on the masked operands
        if axis == "n":
            def plain_fwd(x, w, gr, me):
                return (x @ w) * me

            def plain_bwd(x, w, gr, me):
                return (gr * me) @ w.T, x.T @ (gr * me)
        else:
            def plain_fwd(x, w, gr, me):
                return (x * me) @ w

            def plain_bwd(x, w, gr, me):
                return (gr @ w.T) * me, (x.T @ gr) * me[:, None]
        wy, (wx, ww) = plain_fwd(x, w, gr, me), plain_bwd(x, w, gr, me)
        xd, wd, gd, md = x.double(), w.double(), gr.double(), me.double()
        xy, (xx, xw) = plain_fwd(xd, wd, gd, md), plain_bwd(xd, wd, gd, md)
        e_f = rel_err(f"K3 whisper {axis} fwd", y, wy, 2e-4)
        e_b = max(rel_err(f"K3 whisper {axis} dx", dx, wx, 2e-4),
                  rel_err(f"K3 whisper {axis} dw", dw, ww, 2e-4))
        f_f = f64_distance(f"K3 whisper {axis} fwd", y, wy, xy)
        f_b = f64_distance(f"K3 whisper {axis} bwd",
                           torch.cat([dx.flatten(), dw.flatten()]),
                           torch.cat([wx.flatten(), ww.flatten()]),
                           torch.cat([xx.flatten(), xw.flatten()]))
        del xd, wd, gd, xy, xx, xw
        live = float(mask.mean())
        flops = 2.0 * M * K * N * live
        fb = 4.0 * (M * K + K * N + M * N)
        kw = dict(mask_axis=axis, blk=blk)
        for case, ms, plain, lib, bd, err, f64 in (
                (f"whisper {axis} fwd", cuda_ms(lambda: ops.product(
                    x, w, mask, axis, blk)),
                 cuda_ms(lambda: plain_fwd(x, w, gr, me)),
                 cuda_ms(lambda: x @ w), bound(flops, fb), e_f, f_f),
                (f"whisper {axis} bwd dx+dw", cuda_ms(
                    lambda: pruned_matmul_bwd(x, w, mask, gr, **kw)),
                 cuda_ms(lambda: plain_bwd(x, w, gr, me)),
                 cuda_ms(lambda: (gr @ w.T, x.T @ gr)),
                 bound(2 * flops, 4.0 * (2 * M * K + 2 * K * N + M * N)),
                 e_b, f_b)):
            shape = (f"M{M} K{K} N{N} mask {axis} blocks{FF // blk} "
                     f"keep{live:.2f} fp32")
            cases[case] = dict(shape=shape, ms=ms, plain_ms=plain,
                               library_ms=lib, bound_ms=bd[0],
                               bound_by=bd[1], max_abs_err=err, **f64)
            say("kernels", kernel="pruned_matmul",
                case=case.replace(" ", "_"), shape=repr(shape),
                variant="tc", ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}",
                library_ms=f"{lib:.4f}", bound_ms=f"{bd[0]:.4f}",
                bound_by=bd[1], max_abs_err=f"{err:.3e}", **f64)
        del x, w, gr, y, dx, dw
    free_cuda(torch)
    return cases


# (label, lengths, nq, nkv, hd, page, J): K6 at the families' decode heads
FAMILY_K6 = [
    ("internvl2 hd128 48:8", [528, 520, 515, 513], 48, 8, 128, 16, 34),
    ("gpt-paper hd32", [1500, 1040, 700, 2040], 32, 32, 32, 16, 128),
]


def paged_f64(torch, ref, q, kp, vp, pt, cl):
    """K6's function in float64 (the plain version's arithmetic)."""
    b, n_q, hd = q.shape
    page, n_kv = kp.shape[1], kp.shape[2]
    k, v = ref.gather_pages(kp, vp, pt)
    kf = k.double().repeat_interleave(n_q // n_kv, dim=2)
    vf = v.double().repeat_interleave(n_q // n_kv, dim=2)
    s = torch.einsum("bhd,bthd->bht", q.double(), kf) / math.sqrt(hd)
    t = torch.arange(k.shape[1], device=q.device)
    live = ((t[None, :] < cl.reshape(-1, 1))
            & (pt >= 0).repeat_interleave(page, dim=1))[:, None, :]
    p = torch.where(live, torch.exp(s - torch.where(live, s, -1e300).amax(
        -1, keepdim=True)), 0.0)
    return torch.einsum("bht,bthd->bhd", p, vf) / p.sum(-1, keepdim=True)


def check_family_paged(torch, F):
    """K6 at hd 128 (InternVL2's 48 / 8 heads) and hd 32 (gpt-paper's 32
    heads): q fp32, pool bf16, split; within 1e-4 of the plain version,
    at most twice its distance from float64; eager times beside the plain
    version's and SDPA's on pre-gathered pages, and the bound."""
    from repro_torch.kernels.paged_attention import ops, ref
    g = torch.Generator(device="cuda").manual_seed(25)
    cases = {}
    for label, clens, nq, nkv, hd, page, J in FAMILY_K6:
        pool = sum(-(-c // page) for c in clens)
        q, ((kp, vp),), pt, cl = paged_inputs(torch, g, clens, nq, nkv, hd,
                                              page, J, pool, torch.bfloat16)
        s0, n0 = ops.KERNEL.launches_split, ops.KERNEL.launches
        out = ops.paged_attention_fwd(q, kp, vp, pt, cl)
        torch.cuda.synchronize()
        if not (ops.KERNEL.launches - n0 == 1
                and ops.KERNEL.launches_split - s0 == 1):
            raise AssertionError(f"K6 {label}: not one split launch")
        want = ref.paged_attention_fwd_ref(q, kp, vp, pt, cl)
        e = check_close(f"K6 {label}", out, want, 1e-4, 1e-4)
        exact = paged_f64(torch, ref, q, kp, vp, pt, cl)
        f64 = f64_distance(f"K6 {label}", out, want, exact)
        kg, vg = (t.float().repeat_interleave(nq // nkv, dim=2)
                  .transpose(1, 2) for t in ref.gather_pages(kp, vp, pt))
        am = (torch.arange(kg.shape[2], device="cuda")[None, :]
              < cl[:, None])[:, None, None]
        qs = q[:, :, None, :]
        ms = cuda_ms(lambda: ops.paged_attention_fwd(q, kp, vp, pt, cl))
        plain = cuda_ms(lambda: ref.paged_attention_fwd_ref(q, kp, vp, pt,
                                                            cl))
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            qs, kg, vg, attn_mask=am))
        bd = paged_bound(q, kp, pt, cl)
        splits = ops.pa_splits(len(clens), nkv, J, page)
        shape = (f"b{len(clens)} nq{nq} nkv{nkv} hd{hd} page{page} J{J} "
                 f"q fp32 pool bf16 lengths {min(clens)}-{max(clens)}")
        cases[label] = dict(shape=shape, ms=ms, plain_ms=plain,
                            library_ms=lib, bound_ms=bd[0], bound_by=bd[1],
                            max_abs_err=e, splits=splits, **f64)
        say("kernels", kernel="paged_attention", case=label.replace(" ", "_"),
            shape=repr(shape), splits=splits, ms=f"{ms:.4f}",
            plain_ms=f"{plain:.4f}", library_ms=f"{lib:.4f}",
            bound_ms=f"{bd[0]:.4f}", bound_by=bd[1], max_abs_err=f"{e:.3e}",
            **f64)
        del q, kp, vp, kg, vg, out, want, exact
    free_cuda(torch)
    return cases


def check_family_grouped(torch):
    """K4 (forward) and K5 (the weight gradient, fp32 out) at
    Mixtral-8x22B's expert shape (8 experts top-2, d 6144, d_ff 16384; b 2
    x s 1024 tokens, cap 320, counts from a seeded router), bf16 on the
    tensor cores: against the plain version (one bf16 rounding for K4,
    1e-4 of the largest entry for K5's fp32 sums), each at most twice the
    plain version's distance from float64; times beside torch.bmm's at full
    capacity and the bound."""
    from repro_torch.kernels.grouped_matmul import ops, ref
    g = torch.Generator(device="cuda").manual_seed(26)
    E, TOPK, D, FF, b, s, cap = 8, 2, 6144, 16384, 2, 1024, 320
    G = b * E
    counts = route_counts(torch, g, b, s, E, TOPK, cap)
    live = (torch.arange(G * cap, device="cuda") % cap
            < counts.repeat_interleave(cap))
    x = torch.where(live[:, None], torch.randn(
        (G * cap, D), generator=g, device="cuda"), 0.0).bfloat16()
    w = (torch.randn((E, D, FF), generator=g, device="cuda")
         * D ** -0.5).bfloat16()
    gr = torch.where(live[:, None], torch.randn(
        (G * cap, FF), generator=g, device="cuda"), 0.0).bfloat16()
    tc4, tc5 = ops.KERNEL.launches_tc, ops.KERNEL_DW.launches_tc
    y = ops.grouped_product(x, w, counts, cap)
    dw = ops.grouped_product_dw(x, gr, counts, cap, E,
                                out_dtype=torch.float32)
    torch.cuda.synchronize()
    if (ops.KERNEL.launches_tc - tc4, ops.KERNEL_DW.launches_tc - tc5) != (
            1, 1):
        raise AssertionError("K4 / K5 at the 8x22B shape: not on the "
                             "tensor cores")
    py = ref.grouped_product_ref(x, w, counts, cap)
    pdw = ref.grouped_product_dw_ref(x, gr, counts, cap, E,
                                     out_dtype=torch.float32)
    e4 = gm_close("K4 8x22b", y, py)
    e5 = gm_close("K5 8x22b", dw, pdw)
    idx = torch.arange(G, device="cuda") % E
    xy = torch.bmm(x.double().view(G, cap, D), w.double()[idx]).view(
        G * cap, FF)
    f4 = f64_distance("K4 8x22b", y, py, xy)
    del xy
    xe = x.double().view(b, E, cap, D)
    ge = gr.double().view(b, E, cap, FF)
    xw = torch.einsum("beck,becn->ekn", xe, ge)
    f5 = f64_distance("K5 8x22b", dw, pdw, xw)
    del xe, ge, xw, py, pdw
    lv = float(counts.sum())
    experts = int((counts.reshape(b, E).sum(0) > 0).sum())
    wg = w[idx]
    x3 = x.view(G, cap, D)
    xt = x.view(b, E, cap, D).transpose(0, 1).reshape(E, b * cap, D) \
        .transpose(1, 2)
    gt = gr.view(b, E, cap, FF).transpose(0, 1).reshape(E, b * cap, FF)
    rows = (
        ("grouped_matmul", "8x22b ewg fwd",
         cuda_ms(lambda: ops.grouped_product(x, w, counts, cap), 2, 5),
         cuda_ms(lambda: ref.grouped_product_ref(x, w, counts, cap), 1, 3),
         cuda_ms(lambda: torch.bmm(x3, wg), 2, 5),
         bound(2.0 * lv * D * FF, 2.0 * (lv * D + experts * D * FF
                                         + G * cap * FF) + 4 * G,
               PEAK_BF16_FLOPS), e4, f4),
        ("grouped_matmul_dw", "8x22b ewg dw fp32-out",
         cuda_ms(lambda: ops.grouped_product_dw(
             x, gr, counts, cap, E, out_dtype=torch.float32), 2, 5),
         cuda_ms(lambda: ref.grouped_product_dw_ref(
             x, gr, counts, cap, E, out_dtype=torch.float32), 1, 3),
         cuda_ms(lambda: torch.bmm(xt, gt), 2, 5),
         bound(2.0 * lv * D * FF, 2.0 * lv * (D + FF) + 4.0 * E * D * FF,
               PEAK_BF16_FLOPS), e5, f5))
    cases = {}
    for name, label, ms, plain, lib, bd, err, f64 in rows:
        shape = (f"G{G} cap{cap} K{D} N{FF} live{int(lv)} bf16"
                 + (" -> fp32" if name.endswith("dw") else ""))
        cases[name] = {label: dict(shape=shape, ms=ms, plain_ms=plain,
                                   library_ms=lib, bound_ms=bd[0],
                                   bound_by=bd[1], max_abs_err=err, **f64)}
        say("kernels", kernel=name, case=label.replace(" ", "_"),
            shape=repr(shape), variant="tc", ms=f"{ms:.4f}",
            plain_ms=f"{plain:.4f}", library_ms=f"{lib:.4f}",
            bound_ms=f"{bd[0]:.4f}", bound_by=bd[1],
            max_abs_err=f"{err:.3e}", **f64)
    del x, w, gr, y, dw, wg, x3, xt, gt
    free_cuda(torch)
    return cases


def check_family_kernels(torch, F):
    """Phase 3f: every kernel at the families' shapes; returns {kernel
    name: {case: numbers}} for the kernels line's ``family_cases``."""
    out = check_family_attention(torch, F)
    out["pruned_matmul"] = check_family_ffn(torch)
    out["paged_attention"] = check_family_paged(torch, F)
    out.update(check_family_grouped(torch))
    return out


# ---------------------------------------------------------------------------
# 6a: whisper-large-v3 at full size (the main path of the families' slice)
# ---------------------------------------------------------------------------
WHISPER_STEPS = 12       # the prune at step 10 and one step after it
# 6a's encoder and decoder layers: whisper-large-v3 has 32 of each; cut in
# depth to a quarter (the full-size phases pay for 7f / 7g and 7h-7j)
WHISPER_LAYERS = 8


def whisper_train_args(steps: int = WHISPER_STEPS):
    """Phase 6a's flags: whisper-large-v3 at its published widths cut to
    WHISPER_LAYERS encoder + WHISPER_LAYERS decoder layers (32 + 32 at full
    size, ~47 GB of params, gradients and moments), 2 stage buffers of as
    many slots (slot slack 0), 2 microbatches of one sample: 1500 frames
    from the loader and 448 decoder tokens each; fp32 params with each
    block recomputed in the backward (``--remat block``); the prune at
    step 10."""
    arch = cut_arch("whisper-large-v3", WHISPER_LAYERS,
                    encoder_layers=WHISPER_LAYERS)
    return FULL_SIZE + ["--arch", arch, "--stages", "2",
                        "--slot-slack", "0", "--num-micro", "2",
                        "--mb-global", "1", "--seq", "448", "--steps",
                        str(steps), "--dynamism", "pruning", "--remat",
                        "block", "--kernel-impl", "pallas", "--param-dtype",
                        "float32", "--seed", "0", "--log-every", "1"]


def whisper_launches_per_step(enc: int = 32, dec: int = 32, micro: int = 2):
    """K1-K3 launches a step: an encoder layer runs one attention and two
    K3 products, a decoder layer two attentions (self, cross) and two
    products; block remat runs each forward twice; each product's
    backward is two K3 launches (dx, dw), each attention's K2a and K2b."""
    attn, prods = enc + 2 * dec, 2 * (enc + dec)
    return {"block_sparse_attention": 2 * attn * micro,
            "block_sparse_attention_bwd_dq": attn * micro,
            "block_sparse_attention_bwd_dkv": attn * micro,
            "pruned_matmul": (2 * prods + 2 * prods) * micro}


def _active_ff(rep):
    active = rep["assignment"]["tags"].to(rep["dyn"]["ff_mask"].device) != 0
    return float(rep["dyn"]["ff_mask"][active].mean())


def run_train_family(torch, kernels, label, argv, per_step, tc_path,
                     moved=False):
    """Train through the CLI; counts zeroed just before and read just
    after, ``per_step`` launches a step, every launch of ``tc_path`` on
    the tensor cores, finite losses; returns (report, launches, tensor-core
    launches, peak GB)."""
    from repro_torch.launch.train import run as train_run
    free_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.KERNELS:
        k.reset()
    rep = train_run(argv)
    launched, launched_tc = _window(torch, kernels)
    peak = torch.cuda.max_memory_allocated() / 1e9
    steps = rep["spec"]["steps"]
    if not all(math.isfinite(x) for x in rep["losses"]):
        raise AssertionError(f"{label}: non-finite loss {rep['losses']}")
    check_launches(label, launched, per_step, steps)
    check_tensor_core(label, launched, launched_tc, tc_path)
    st = rep["step_times"]
    say(label, steps=steps, tokens_per_step=rep["tokens_per_step"],
        tokens_per_s=f"{rep['steady_tokens_per_s']:.1f}",
        step_ms=f"{sum(st[1:]) / max(1, len(st) - 1) * 1e3:.1f}",
        step0_ms=f"{st[0] * 1e3:.1f}", peak_mem_gb=f"{peak:.2f}",
        wall_s=f"{rep['wall_s']:.2f}",
        losses=json.dumps([round(x, 4) for x in rep["losses"]])
        .replace(" ", ""),
        events=json.dumps([[e.iteration, e.moved_layers]
                           for e in rep["events"]]).replace(" ", ""),
        final_lps=rep["final_lps"],
        launches=json.dumps(launched).replace(" ", ""))
    return rep, launched, launched_tc, peak


def family_step(torch, cfg, dcfg, dyncfg, shapes, plain, prune=0.0):
    """Loss and gradients of one training step (value_and_grad of the
    pipelined loss) from seed-0 params and the loader's first batch,
    ``prune`` of the FFN blocks masked; the kernel run must launch K1-K3
    (those the arch has) and the plain run none."""
    from repro_torch import kernels
    from repro_torch.data.loader import DataConfig, make_loader
    from repro_torch.launch.engine import ElasticEngine
    from repro_torch.pipeline.pipeline import build_loss_fn, value_and_grad
    eng = ElasticEngine(cfg, dcfg, dyncfg, shapes, device="cuda")
    st = eng.init_state(0)
    if prune:
        g = torch.Generator(device="cpu").manual_seed(6)
        st.dyn["ff_mask"] = (torch.rand(st.dyn["ff_mask"].shape,
                                        generator=g) >= prune).float().cuda()
    batch = eng._batch(next(make_loader(cfg, DataConfig(
        shapes.num_micro, shapes.mb_global, shapes.seq))))
    loss_fn = build_loss_fn(cfg, dcfg, dyncfg, shapes)
    before = [k.launches for k in kernels.KERNELS]
    loss, _, grads = value_and_grad(loss_fn, st.params, st.assignment,
                                    st.dyn, batch)
    torch.cuda.synchronize()
    launched = [k.launches - b for k, b in zip(kernels.KERNELS, before)]
    if plain and any(launched):
        raise AssertionError(f"{cfg.name}: plain step launched {launched}")
    if not plain and not any(launched):
        raise AssertionError(f"{cfg.name}: kernel step launched nothing")
    del eng, st, batch
    return float(loss), grads


def family_train_parity(torch, label, cfg, dcfg, dyncfg, shapes,
                        prune=0.0):
    """One step's loss within 1e-4 relative and every gradient leaf within
    1e-3 of its largest entry, kernels against plain versions (fp32)."""
    free_cuda(torch)
    k_loss, k_grads = family_step(torch, cfg, dcfg, dyncfg, shapes, False,
                                  prune)
    free_cuda(torch)
    with PlainKernels():
        p_loss, p_grads = family_step(torch, cfg, dcfg, dyncfg, shapes,
                                      True, prune)
    rel = abs(k_loss - p_loss) / abs(p_loss)
    if not (math.isfinite(k_loss) and rel <= 1e-4):
        raise AssertionError(f"{label}: loss {k_loss} vs plain {p_loss}")
    pg = dict(leaves(p_grads))
    worst, n = 0.0, 0
    for path, kg in leaves(k_grads):
        if not bool(torch.isfinite(kg).all()):
            raise AssertionError(f"{label}: non-finite gradient {path}")
        err = leaf_err(kg, pg[path])
        if not err <= 1e-3:
            raise AssertionError(f"{label}: grad {path} {err:.3e} > 1e-3")
        worst, n = max(worst, err), n + 1
    say(label, arch=cfg.name, loss=f"{k_loss:.6f}", plain_loss=f"{p_loss:.6f}",
        loss_rel_err=f"{rel:.3e}", tol_loss=1e-4, leaves=n,
        worst_leaf_rel_err=f"{worst:.3e}", tol_grad="1e-3*max|plain|")
    del k_grads, p_grads, pg
    free_cuda(torch)


def whisper_serve_run(torch, plain: bool, prompt: int = 432, gen: int = 16):
    """Full-size whisper: one prefill of 2 lanes (1500 frames each, a
    ``prompt``-token decoder prompt) and ``gen`` scalar-position decode
    steps, teacher-forced, through build_prefill_fn / build_decode_fn (the
    engine's); returns (prefill ids, decode ids [gen, 1, 2], decode logits,
    launches, tensor-core launches)."""
    from repro_torch import kernels
    from repro_torch.configs import DistConfig, get_config
    from repro_torch.dynamics.config import DynamicsConfig
    from repro_torch.launch.engine import ElasticEngine
    from repro_torch.models import model as M
    from repro_torch.pipeline.pipeline import PipelineShapes
    cfg = get_config("whisper-large-v3")
    dcfg = DistConfig(num_stages=2, slot_slack=0, remat="none",
                      param_dtype="float32", kernel_impl="pallas")
    m, B = 1, 2
    shapes = PipelineShapes.for_model(cfg, m, B, prompt,
                                      cache_len=prompt + gen)
    eng = ElasticEngine(cfg, dcfg, DynamicsConfig(), shapes, device="cuda")
    st = eng.init_state(0, with_cache=True)
    g = torch.Generator(device="cpu").manual_seed(9)
    toks = torch.randint(0, cfg.vocab_size, (m, B, prompt + gen),
                         generator=g)
    frames = torch.randn((m, B, cfg.encoder_seq, cfg.d_model),
                         generator=g) * 0.05
    logits, orig = [], M.lm_logits

    def recording(params, cfg_, h):
        out = orig(params, cfg_, h)
        logits.append(out)
        return out

    before = [(k.launches, k.launches_tc) for k in kernels.KERNELS]
    M.lm_logits = recording
    try:
        with torch.no_grad():
            pf, _ = eng.prefill(st, {"tokens": toks[:, :, :prompt],
                                     "frames": frames})
            logits.clear()
            ids = []
            for i in range(gen):
                d_ids, _ = eng.decode(st, toks[:, :, prompt + i],
                                      torch.tensor(prompt + i))
                ids.append(d_ids)
        torch.cuda.synchronize()
    finally:
        M.lm_logits = orig
    launched = {k.name: k.launches - b[0]
                for k, b in zip(kernels.KERNELS, before)}
    launched_tc = {k.name: k.launches_tc - b[1]
                   for k, b in zip(kernels.KERNELS, before)}
    del eng, st
    return pf, torch.stack(ids), torch.stack(logits), launched, launched_tc


def whisper_serve_parity(torch):
    """6a's serve: the kernel run's decode ids equal the plain run's
    wherever the plain run's top-2 gap exceeds 1e-3 (the prefill's too);
    the kernel run launches K1 and K3, on the tensor cores, the plain run
    nothing.  Returns the kernel run's (launches, tensor-core launches)."""
    free_cuda(torch)
    k_pf, k_ids, _, k_launched, k_tc = whisper_serve_run(torch, plain=False)
    free_cuda(torch)
    with PlainKernels():
        p_pf, p_ids, p_logits, p_launched, _ = whisper_serve_run(torch,
                                                                 plain=True)
    free_cuda(torch)
    if any(p_launched.values()):
        raise AssertionError(f"plain whisper serve launched {p_launched}")
    for name in ("block_sparse_attention", "pruned_matmul"):
        if k_launched[name] <= 0:
            raise AssertionError(f"whisper serve never launched {name}")
    check_tensor_core("whisper serve", k_launched, k_tc,
                      ("block_sparse_attention", "pruned_matmul"))
    top2 = p_logits.float().topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]).reshape(k_ids.shape) > 1e-3
    if not bool((k_ids == p_ids)[decided].all()):
        raise AssertionError("whisper decode ids differ where the plain "
                             "run's top-2 gap exceeds 1e-3")
    say("whisper_serve_parity", prefill_ids_equal=bool((k_pf == p_pf).all()),
        decode_ids_equal=f"{int((k_ids == p_ids).sum())}/{k_ids.numel()}",
        decided=int(decided.sum()), frames=1500, prompt=432, decode_steps=16,
        launches=json.dumps(k_launched).replace(" ", ""))
    return k_launched, k_tc


def run_whisper_phase(torch, kernels):
    """Phase 6a: whisper-large-v3 trained at its published widths, cut to
    16 + 16 layers, through the train CLI (whisper_train_args), K1, K2a,
    K2b and K3 at whisper_launches_per_step() a step, all on the tensor
    cores, the prune
    at step 10 inside the run; two profiled steps (busy share); one step's
    loss and gradients through the kernels against the plain versions at
    full width cut to 4 + 4 layers; a full-size prefill with 1500 frames
    and 16 scalar-position decode steps against the plain versions.
    Returns (launches, tensor-core launches) of the training run and the
    serve."""
    from repro_torch.configs import DistConfig, get_config
    from repro_torch.dynamics.config import DynamicsConfig
    from repro_torch.pipeline.pipeline import PipelineShapes
    rep, launched, launched_tc, _ = run_train_family(
        torch, kernels, "whisper_train", whisper_train_args(),
        whisper_launches_per_step(WHISPER_LAYERS, WHISPER_LAYERS),
        FP32_TC_PATH)
    ff = _active_ff(rep)
    if not ff < 1.0:
        raise AssertionError(f"whisper: the prune at step 10 masked no "
                             f"block (ff_active {ff})")
    say("whisper_prune", ff_active=f"{ff:.4f}", pruned_at=10)
    wall2_ms = first_two_ms(rep)
    del rep
    say("profile_whisper_train", **profile_train(torch, whisper_train_args,
                                                 wall_ms=wall2_ms))
    cfg = get_config(cut_arch("whisper-large-v3", 4, encoder_layers=4))
    dcfg = DistConfig(num_stages=2, slot_slack=0, remat="none",
                      param_dtype="float32", kernel_impl="pallas")
    family_train_parity(torch, "whisper_train_parity", cfg, dcfg,
                        DynamicsConfig(kind="pruning"),
                        PipelineShapes.for_model(cfg, 2, 1, 448), prune=0.5)
    serve, serve_tc = whisper_serve_parity(torch)
    return ({k: launched[k] + serve[k] for k in launched},
            {k: launched_tc[k] + serve_tc[k] for k in launched_tc})


# ---------------------------------------------------------------------------
# 6b: zamba2-1.2b at full size (Mamba2 + the shared attention block)
# ---------------------------------------------------------------------------
# the cadences after steps 3 and 7 both migrate: the run ends with the
# second
ZAMBA_STEPS = 8


def zamba2_train_args(steps: int = ZAMBA_STEPS):
    """Phase 6b's flags: zamba2-1.2b at full size (38 layers, 6 of them
    HYBRID_ATTN), 2 stage buffers of 27 slots (slot slack 8: the default
    2 caps a buffer at 21 layers, and the move stops short of layer 21,
    the first HYBRID_ATTN past the split), 4 microbatches of 2 x 1024
    tokens, a 2x straggler on stage 1 and a cadence every 4 steps under
    the partition balancer (a migration moves MAMBA and HYBRID_ATTN
    slots), fp32, block remat."""
    return FULL_SIZE + ["--arch", "zamba2-1.2b", "--stages", "2",
                        "--slot-slack", "8", "--num-micro", "4",
                        "--mb-global", "2", "--seq", "1024", "--steps",
                        str(steps), "--rebalance-every", "4", "--straggler",
                        "1:2.0", "--balancer", "partition", "--dynamism",
                        "none", "--remat",
                        "block", "--kernel-impl", "pallas",
                        "--param-dtype", "float32", "--seed", "0",
                        "--log-every", "1"]


# 6 HYBRID_ATTN layers x 4 microbatches, each forward twice (block remat)
ZAMBA_LAUNCHES_PER_STEP = {"block_sparse_attention": 48,
                           "block_sparse_attention_bwd_dq": 24,
                           "block_sparse_attention_bwd_dkv": 24,
                           "pruned_matmul": 0}


def zamba2_serve_args():
    """Phase 6b's serve: full-size zamba2 on 2 stage buffers, contiguous
    KV (recurrent state cannot page), 8 requests of 256-512 tokens."""
    return FULL_SIZE + ["--elastic", "--arch", "zamba2-1.2b", "--stages",
                        "2", "--micro", "2", "--mb-global", "4",
                        "--prompt-len", "512", "--gen", "16", "--requests",
                        "8", "--kernel-impl", "pallas", "--param-dtype",
                        "float32", "--seed", "0"]


def _moved_types(cfg, events_lps):
    """The block types of the layers that changed stage between
    consecutive layer splits (``cfg``: a config, or its block pattern)."""
    pattern = cfg if isinstance(cfg, list) else cfg.block_pattern()
    moved = set()
    for a, b in zip(events_lps, events_lps[1:]):
        sa = [s for s, n in enumerate(a) for _ in range(n)]
        sb = [s for s, n in enumerate(b) for _ in range(n)]
        moved |= {pattern[i] for i in range(len(pattern)) if sa[i] != sb[i]}
    return moved


def run_zamba2_phase(torch, kernels):
    """Phase 6b: full-size zamba2 trained through the CLI (a migration must
    move MAMBA and HYBRID_ATTN layers; K1-K2 at 32 heads of 64 on the
    tensor cores, K3 none: Mamba2 has no pruned FFN), two profiled steps;
    then served with contiguous KV once fixed and once shrunk 2 -> 1 at
    tick 6: tokens identical.  Returns (launches, tensor-core launches)."""
    from repro_torch.configs import BLOCK_HYBRID_ATTN, BLOCK_MAMBA, get_config
    rep, launched, launched_tc, _ = run_train_family(
        torch, kernels, "zamba2_train", zamba2_train_args(),
        ZAMBA_LAUNCHES_PER_STEP, FP32_TC_PATH[:3])
    if not any(e.moved_layers > 0 for e in rep["events"]):
        raise AssertionError(f"zamba2: no migration moved layers "
                             f"{[(e.iteration, e.moved_layers) for e in rep['events']]}")
    cfg = get_config("zamba2-1.2b")
    # the net move: the layers whose stage differs between the uniform
    # split and the final one
    moved = _moved_types(cfg, [[19, 19], list(rep["final_lps"])])
    if not {BLOCK_MAMBA, BLOCK_HYBRID_ATTN} <= moved:
        raise AssertionError(f"zamba2: the migrations moved block types "
                             f"{moved}, not both MAMBA and HYBRID_ATTN")
    say("zamba2_migration", moved_types=sorted(moved),
        final_lps=rep["final_lps"])
    # what 7i's ranks are held to
    st = rep["step_times"]
    ZAMBA_TRAIN.update(
        losses=rep["losses"], lps_history=rep["lps_history"],
        events=[[e.iteration, e.moved_layers] for e in rep["events"]],
        step_ms=sum(st[1:]) / max(1, len(st) - 1) * 1e3)
    wall2_ms = first_two_ms(rep)
    del rep
    say("profile_zamba2_train", **profile_train(torch, zamba2_train_args,
                                                wall_ms=wall2_ms))
    free_cuda(torch)
    with serve_session(zamba2_serve_args()) as s:
        fixed = s.serve()
    free_cuda(torch)
    for k in kernels.KERNELS:
        k.reset()
    with serve_session(zamba2_serve_args()) as s:
        rep = s.serve(resize_at={6: 1})
    served, served_tc = _window(torch, kernels)
    want = {c["rid"]: c["tokens"] for c in fixed["completions"]}
    got = {c["rid"]: c["tokens"] for c in rep["completions"]}
    kinds = [(r["kind"], r["from_stages"], r["to_stages"])
             for r in rep["resizes"]]
    if kinds != [("shrink", 2, 1)]:
        raise AssertionError(f"zamba2 serve resizes {kinds}")
    if got != want or len(got) != 8:
        raise AssertionError("zamba2: the shrunk serve's tokens differ from "
                             "the fixed serve's")
    if served["block_sparse_attention"] <= 0:
        raise AssertionError("zamba2 serve never launched K1")
    check_tensor_core("zamba2 serve", served, served_tc,
                      ("block_sparse_attention",))
    say("zamba2_serve", requests=len(got), tokens=rep["total_tokens"],
        ticks=rep["ticks"], resizes=json.dumps(kinds).replace(" ", ""),
        tokens_equal_fixed=True,
        fixed_tokens_per_s=f"{fixed['tokens_per_s']:.1f}",
        tokens_per_s=f"{rep['tokens_per_s']:.1f}",
        launches=json.dumps(served).replace(" ", ""))
    del fixed, rep
    free_cuda(torch)
    return ({k: launched[k] + served[k] for k in launched},
            {k: launched_tc[k] + served_tc[k] for k in launched_tc})


# ---------------------------------------------------------------------------
# 6c: xlstm-1.3b at published widths, 4 layers (no kernel on this path)
# ---------------------------------------------------------------------------
# phase 6c's depth: three mLSTM layers and the sLSTM at layer 3
XLSTM_LAYERS = 4


def xlstm_train_args(steps: int = 12):
    """Phase 6c's flags: xlstm-1.3b at published widths cut to
    XLSTM_LAYERS layers (the sLSTM at 3), 2 stage buffers, 2 microbatches
    of 2 x 256 tokens, the prune of the mLSTM up-projection at step 10,
    fp32."""
    return FULL_SIZE + ["--arch", cut_arch("xlstm-1.3b", XLSTM_LAYERS),
                        "--stages",
                        "2", "--slot-slack", "0", "--num-micro", "2",
                        "--mb-global", "2", "--seq", "256", "--steps",
                        str(steps), "--dynamism", "pruning",
                        "--kernel-impl", "pallas", "--param-dtype",
                        "float32", "--seed", "0", "--log-every", "1"]


def xlstm_serve_args():
    return FULL_SIZE + ["--elastic", "--arch", cut_arch("xlstm-1.3b",
                                                         XLSTM_LAYERS),
                        "--stages", "2", "--slot-slack", "0", "--micro", "2",
                        "--mb-global", "2", "--prompt-len", "64", "--gen",
                        "16", "--requests", "4", "--kernel-impl", "pallas",
                        "--param-dtype", "float32", "--seed", "0"]


NO_LAUNCHES = {"block_sparse_attention": 0,
               "block_sparse_attention_bwd_dq": 0,
               "block_sparse_attention_bwd_dkv": 0, "pruned_matmul": 0,
               "grouped_matmul": 0, "grouped_matmul_dw": 0,
               "paged_attention": 0}


def run_xlstm_phase(torch, kernels):
    """Phase 6c: xLSTM trains (the prune must mask mLSTM up-projection
    blocks) and serves 4 requests; no kernel of the port runs on this path
    (mLSTM / sLSTM are plain PyTorch, their time loops on the host): every
    count must stay 0.  Returns (launches, tensor-core launches), all
    zero."""
    rep, launched, _, _ = run_train_family(
        torch, kernels, "xlstm_train", xlstm_train_args(), NO_LAUNCHES, ())
    ff = _active_ff(rep)
    if not ff < 1.0:
        raise AssertionError(f"xlstm: the prune masked nothing ({ff})")
    del rep
    free_cuda(torch)
    for k in kernels.KERNELS:
        k.reset()
    with serve_session(xlstm_serve_args()) as s:
        srv = s.serve()
    served, _ = _window(torch, kernels)
    if any(served.values()) or len(srv["completions"]) != 4:
        raise AssertionError(f"xlstm serve: {served}, "
                             f"{len(srv['completions'])} completions")
    say("xlstm_serve", requests=4, tokens=srv["total_tokens"],
        tokens_per_s=f"{srv['tokens_per_s']:.1f}", ff_active_after_prune=
        f"{ff:.4f}", kernels="none (mLSTM / sLSTM run as plain PyTorch)")
    del srv
    free_cuda(torch)
    return launched, {k: 0 for k in launched}


# ---------------------------------------------------------------------------
# 6d: internvl2-26b at published widths (the VLM prefix; hd 128)
# ---------------------------------------------------------------------------
def internvl2_train_args(steps: int = 6):
    """Phase 6d's training flags: InternVL2-26B at published widths cut to
    4 layers, bf16 params, 2 stage buffers of 2 slots, 2 microbatches of
    2 x 512 tokens behind the loader's 256 patch embeddings."""
    return FULL_SIZE + ["--arch", cut_arch("internvl2-26b", 4), "--stages",
                        "2", "--slot-slack", "0", "--num-micro", "2",
                        "--mb-global", "2", "--seq", "512", "--steps",
                        str(steps), "--dynamism", "none", "--kernel-impl",
                        "pallas", "--param-dtype", "bfloat16", "--seed",
                        "0", "--log-every", "1"]


# 4 layers x 2 microbatches: K1 once, K2a / K2b once, K3 three products
# forward and six backward per layer and microbatch
VLM_LAUNCHES_PER_STEP = {"block_sparse_attention": 8,
                         "block_sparse_attention_bwd_dq": 8,
                         "block_sparse_attention_bwd_dkv": 8,
                         "pruned_matmul": 72}


def internvl2_serve_args():
    """Phase 6d's serve: InternVL2-26B cut to 8 layers, text only, fp32,
    one stage, paged KV (page 16), 4 requests of 256-512 tokens."""
    return FULL_SIZE + ["--elastic", "--arch", cut_arch("internvl2-26b", 8),
                        "--stages", "1", "--slot-slack", "0", "--micro",
                        "2", "--mb-global", "2", "--prompt-len", "512",
                        "--gen", "16", "--requests", "4", "--kv-page-size",
                        "16", "--kernel-impl", "pallas", "--param-dtype",
                        "float32", "--seed", "0"]


def run_internvl2_phase(torch, kernels):
    """Phase 6d: InternVL2 trains behind its patch prefix (K1 at seq 768,
    hd 128, GQA 6; K3 at K 6144 / N 16384 in bf16, all on the tensor
    cores), then serves text through K1, K3 and K6 at hd 128, every K6
    launch split.  Returns (launches, tensor-core launches)."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    _, launched, launched_tc, _ = run_train_family(
        torch, kernels, "internvl2_train", internvl2_train_args(),
        VLM_LAUNCHES_PER_STEP, FP32_TC_PATH)
    free_cuda(torch)
    for k in kernels.KERNELS:
        k.reset()
    with serve_session(internvl2_serve_args()) as s:
        srv = s.serve()
    served, served_tc = _window(torch, kernels)
    check_k6_split(served["paged_attention"], pa_ops.KERNEL.launches_split)
    check_tensor_core("internvl2 serve", served, served_tc,
                      ("block_sparse_attention", "pruned_matmul"))
    missing = [n for n in ("block_sparse_attention", "pruned_matmul",
                           "paged_attention") if served[n] <= 0]
    if missing or len(srv["completions"]) != 4:
        raise AssertionError(f"internvl2 serve: missing {missing}")
    say("internvl2_serve", requests=4, tokens=srv["total_tokens"],
        tokens_per_s=f"{srv['tokens_per_s']:.1f}",
        k6_split_launches=pa_ops.KERNEL.launches_split,
        launches=json.dumps(served).replace(" ", ""))
    del srv
    free_cuda(torch)
    return ({k: launched[k] + served[k] for k in launched},
            {k: launched_tc[k] + served_tc[k] for k in launched_tc})


# ---------------------------------------------------------------------------
# phases 7b-7g: one process per pipeline stage (``launch.dist``): the
# ranks share the one card, so their carries and collectives go through
# host copies over gloo; these phases show correctness and the hand-off's
# cost, not a speed-up (four processes time-slice one card)
# ---------------------------------------------------------------------------
ACROSS_PROCS = 4
# phase 7b's steps and flags: a cadence every 2 steps under a 4x straggler
# on worker 1 migrates rows across ranks after step 1 (a straggler of 4 —
# not 3 — keeps the decision off a tie the wall clock's last bits could
# break either way; step 2 runs on the moved rows)
ACROSS_PARITY_STEPS = 3
# 7g's kill: 7b's flags with a safe point after this step, then a
# trainer_kill after it (the launch of 7b-7g ends there); the resume runs
# the last step
KILL_AFTER = 1
ACROSS_PATH = ("block_sparse_attention", "block_sparse_attention_bwd_dq",
               "block_sparse_attention_bwd_dkv", "pruned_matmul")


def across_train_args(steps: int, layers: int, every: int,
                      straggler: str):
    """Phase 7b's flags: smollm-360m at its published widths cut to
    ``layers``, 8192 tokens a step, a rebalance cadence every ``every``
    steps under a ``straggler`` (diffusion balancer), on 4 stages."""
    arch = [] if layers is None else ["--arch", cut_arch("smollm-360m",
                                                         layers)]
    return FULL_SIZE + arch + [
        "--stages", "4", "--num-micro", "4", "--mb-global", "2", "--seq",
        "1024", "--steps", str(steps), "--rebalance-every", str(every),
        "--straggler", straggler, "--balancer", "diffusion", "--dynamism",
        "pruning", "--kernel-impl", "pallas", "--param-dtype", "float32",
        "--seed", "0", "--log-every", "5"]


def summed_launches(ranks, key: str = "launches") -> dict:
    """{kernel: launches summed over the ranks} (``key``: launches, tc,
    bwd or split)."""
    names = ranks[0]["launches"]
    return {n: sum(r["launches"][n][key] for r in ranks) for n in names}


def say_ranks(label: str, ranks, smi: str) -> None:
    """One line per rank: its launches of K1-K3 (and how many took the
    tensor cores), its peak memory_allocated, the rows it sent and received
    in migrations and its hand-offs, beside the card's name and limit."""
    for r in ranks:
        c = r["comm"]
        own = {n: r["launches"][n]["launches"] for n in ACROSS_PATH}
        own_tc = {n: r["launches"][n]["tc"] for n in ACROSS_PATH}
        peak = r["peak_allocated"]
        # send_s and recv_wait_s include waiting for the peer (a blocking
        # send returns once the receiver has taken it); staging_copy_s
        # includes the wait for the stream's queued work before a copy
        say(label, rank=r["rank"], stage=r["stage"], replica=r["replica"],
            backend=r["backend"], device=r["device"],
            launches=json.dumps(own).replace(" ", ""),
            launches_tc=json.dumps(own_tc).replace(" ", ""),
            peak_mem_gb=("none" if peak is None else f"{peak / 1e9:.3f}"),
            rows_sent=c["rows_sent"], rows_recv=c["rows_recv"],
            handoffs=c["handoffs"], staging_copy_s=f"{c['copy_s']:.3f}",
            send_s=f"{c['send_s']:.3f}",
            recv_wait_s=f"{c['recv_wait_s']:.3f}", card=repr(smi))


class MemoryAt:
    """A ``train(on_step=...)`` hook (picklable: the ranks import this
    module): after each step of ``steps`` every rank notes its pid,
    memory_allocated and memory_reserved, and rank 0 the card's
    per-process memory as ``nvidia-smi --query-compute-apps`` gives it."""

    def __init__(self, steps):
        self.steps = tuple(steps)
        self.seen = []

    def __call__(self, step, session):
        import os

        import torch
        if step not in self.steps:
            return
        dev = session.device
        cuda = dev.type == "cuda"
        if cuda:
            torch.cuda.synchronize(dev)
        row = {"step": step, "pid": os.getpid(),
               "allocated": torch.cuda.memory_allocated(dev) if cuda
               else None,
               "reserved": torch.cuda.memory_reserved(dev) if cuda
               else None}
        if session._mesh.rank == 0 and cuda:
            row["smi"] = subprocess.run(
                ["nvidia-smi", "--query-compute-apps=pid,used_memory",
                 "--format=csv,noheader"], capture_output=True,
                text=True).stdout.strip().splitlines()
        self.seen.append(row)


# 7d's memory probes: before the shrink (step 13), after it (14), after the
# grow (19)
MEMORY_STEPS = (13, 14, 19)


class StatusCalls:
    """A ``train(on_step=...)`` hook (picklable: the ranks import this
    module): a status round trip to the job manager after each step below
    ``steps`` — phase 4n (iii)'s, on which the chaos transport rolls loss
    and duplication.  Across ranks the call runs on rank 0's client
    through ``launch.jm_proxy`` (every rank calls, rank 0's fault records
    reach every rank), so the rolls come in 4n's order."""

    def __init__(self, steps: int):
        self.steps = steps

    def __call__(self, step, session):
        jm = session.job_manager
        if step >= self.steps:
            return
        if hasattr(jm, "inner"):
            jm._call("_call", "status")
        else:
            jm._call("status")


def rank_phase7(mesh, elastic, parity, serve, elastic_serve, archs,
                parity_async, ckpt, chaos, kill, outdir):
    """Phases 7b-7g in one set of 4 ranks (launched by ``launch.dist``; the
    ranks import this module, which imports no jax): the 7d elastic
    training, the hand-off probe (ranks 0 and 1), the 7c one-shot serve,
    the 7e elastic serve, the 7b parity training and its asynchronous
    twin, 7f's safe points (4k's run as ranks, its resume from 15 and the
    resume from 4k's own step-7 safe point), 7g's crashed serve and RPC
    chaos training, each with the counters and transfer stats zeroed just
    before it and read just after.  Each rank then saves what it has under
    ``outdir`` and runs ``kill``, whose trainer_kill ends the launch: one
    launch pays the processes' start and the card's first-call costs once.
    Returns each part's result, the rank's, only when the kill did not
    fire."""
    import torch

    from repro_torch import kernels
    from repro_torch.api.session import rank_serve_elastic, rank_train
    from repro_torch.launch.dist import _to_device, ensure_arch, handoff_probe
    from repro_torch.launch.serve import rank_serve
    for cfg in archs:
        ensure_arch(cfg)
    probe = MemoryAt(MEMORY_STEPS)

    def elastic_serve_part():
        got = rank_serve_elastic(mesh, elastic_serve, gather=True,
                                 resize_at=ELASTIC_SERVE_RESIZE_AT)
        if "report" in got:          # the gathered pool, as its digests
            got["report"]["pool_digests"] = pool_digests(
                got["report"].pop("cache"))
        return got

    tail = ckpt["tail"]
    out = {"seconds": {}}
    for part, fn in (
            ("7d", lambda: rank_train(mesh, elastic, on_step=probe)),
            ("probe", lambda: handoff_probe(mesh)),
            ("7c", lambda: rank_serve(mesh, **serve)),
            ("7e", elastic_serve_part),
            ("7b", lambda: rank_train(mesh, parity, gather=True)),
            ("7b_async", lambda: rank_train(mesh, parity_async)),
            ("7f", lambda: rank_train(mesh, ckpt["spec"])),
            ("7f_r15", lambda: rank_train(mesh, tail, digest=True,
                                          resume=(ckpt["own"], 15))),
            ("7f_r7", lambda: rank_train(mesh, tail, digest=True,
                                         resume=(ckpt["cross"],
                                                 CKPT_CROSS))),
            ("7g_serve", lambda: rank_serve_elastic(mesh, chaos["serve"])),
            ("7g", lambda: rank_train(mesh, chaos["train"], digest=True,
                                      on_step=StatusCalls(
                                          AUTOSCALE_STATUS_STEPS)))):
        for k in kernels.KERNELS:
            k.reset()
        mesh.comm.stats = dict.fromkeys(mesh.comm.stats, 0)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        # the results (7b's gathered trees among them) leave the card: the
        # next part's memory is its own
        out[part] = _to_device(fn(), "cpu")
        out["seconds"][part] = time.perf_counter() - t0
    out["7d_memory"] = probe.seen
    import os
    torch.save(out, os.path.join(outdir, f"rank{mesh.rank}.pt"))
    mesh.comm.all_gather_object(None)    # every rank's result is on disk
    # 7g's kill: every rank SIGKILLs itself after the step-1 safe point
    rank_train(mesh, kill)
    return out


def rank_resume_killed(mesh, spec, resume, arch):
    """7g's resume of the killed launch's safe point as 4 ranks (``arch``:
    the cut arch's config, which the ranks register)."""
    from repro_torch.api.session import rank_train
    return rank_train(mesh, spec, resume=resume, digest=True, arch=arch)


ACROSS_SERVE = dict(arch="smollm-360m", stages=4, micro=2, mb_global=4,
                    prompt_len=1024, gen=16, layers=None,
                    kernel_impl="pallas", param_dtype="float32", seed=0)


def pool_digests(cache) -> list:
    """sha256 of each stage's rows of a page pool ({kp, vp: [S, L_max,
    pool+1, page, kv, hd]}), the trash block (the last: nothing reads it)
    excluded: equal lists mean bitwise equal pools."""
    import hashlib

    import torch
    S = next(iter(cache.values())).shape[0]
    out = []
    for s in range(S):
        h = hashlib.sha256()
        for k in sorted(cache):
            h.update(cache[k][s, :, :-1].contiguous().cpu().reshape(-1)
                     .view(torch.uint8).numpy().tobytes())
        out.append(h.hexdigest())
    return out


def _gb(x) -> str:
    return "none" if x is None else f"{x / 1e9:.3f}"


def check_elastic_across(rep, ranks, want) -> dict:
    """7d against 4h's one-process run (``want``: ``ELASTIC_TRAIN``): the
    same resizes, pool log and stages, the launches summed over the ranks
    equal to 4h's (backward launches too), every rank launching, each
    released rank holding at most ``RELEASED_MAX_BYTES`` after the shrink,
    the losses bitwise (else the first differing step, held to rtol 1e-6).
    Returns the summary."""
    got = [(r["kind"], r["step"], r["from_stages"], r["to_stages"],
            list(r["workers"])) for r in rep["resizes"]]
    if got != want["resizes"] or [g[0] for g in got] != ["shrink", "grow"]:
        raise AssertionError(f"7d: resizes {got} vs 4h's {want['resizes']}")
    if rep["pool_log"] != want["pool_log"] or \
            rep["stages_history"] != want["stages"]:
        raise AssertionError(f"7d: pool log {rep['pool_log']} / stages "
                             f"{rep['stages_history']} vs 4h's")
    launched = summed_launches(ranks)
    if launched != want["launches"]:
        raise AssertionError(f"7d: launches {launched} vs 4h's "
                             f"{want['launches']}")
    # the total alone would let forward and backward launches trade places
    bwd = summed_launches(ranks, "bwd")
    if bwd != want["launches_bwd"]:
        raise AssertionError(f"7d: backward launches {bwd} vs 4h's "
                             f"{want['launches_bwd']}")
    idle = [r["rank"] for r in ranks
            if r["launches"]["pruned_matmul"]["launches"] <= 0]
    if idle or len(ranks) != ACROSS_PROCS:
        raise AssertionError(f"7d: ranks {idle} launched no K3")
    shrink = rep["resize_memory"][0]
    released = [m for m in shrink["ranks"] if m["role"] == "released"]
    if [m["rank"] for m in released] != [2, 3]:
        raise AssertionError(f"7d: released ranks {released}")
    heavy = [(m["rank"], m["allocated_after"]) for m in released
             if m["allocated_after"] > RELEASED_MAX_BYTES
             or m["held_bytes"] != 0]
    if heavy:
        raise AssertionError(f"7d: released ranks still hold memory: "
                             f"{heavy}")
    losses, base = rep["losses"], want["losses"]
    first = next((i for i, (x, y) in enumerate(zip(losses, base))
                  if x != y), None)
    rel = max(abs(x - y) / abs(y) for x, y in zip(losses, base))
    if len(losses) != len(base) or rel > 1e-6:
        raise AssertionError(f"7d: losses differ from 4h's from step "
                             f"{first} (rel {rel:.3e})")
    return {"losses_bitwise": first is None, "first_differing_step": first,
            "loss_max_rel": rel, "launched": launched, "bwd": bwd}


def check_elastic_serve_across(rep, ranks, want) -> int:
    """7e against 4i's resized one-process serve (``want``:
    ``ELASTIC_SERVE``): tokens identical, the resizes 4i's, K6 launched in
    every rank (each rank was active before the shrink and after the
    grow), split every time, summed to 4i's count, the gathered page pool
    bitwise 4i's (``pool_digests``: each stage's rows, the trash block
    excluded).  Returns K6's launches."""
    got = {c["rid"]: c["tokens"] for c in rep["completions"]}
    if got != want["tokens"]:
        raise AssertionError("7e: the ranks' tokens differ from 4i's")
    kinds = [(r["kind"], r["step"], r["from_stages"], r["to_stages"])
             for r in rep["resizes"]]
    if kinds != want["resizes"]:
        raise AssertionError(f"7e: resizes {kinds} vs 4i's "
                             f"{want['resizes']}")
    k6 = summed_launches(ranks)["paged_attention"]
    split = summed_launches(ranks, "split")["paged_attention"]
    if k6 != want["launches"]["paged_attention"] or split != k6:
        raise AssertionError(f"7e: K6 {k6} ({split} split) vs 4i's "
                             f"{want['launches']['paged_attention']}")
    idle = [r["rank"] for r in ranks
            if r["launches"]["paged_attention"]["launches"] <= 0]
    if idle:
        raise AssertionError(f"7e: ranks {idle} launched no K6")
    differ = [s for s, (a, b) in enumerate(zip(rep["pool_digests"],
                                               want["pool_digests"]))
              if a != b]
    if differ or len(rep["pool_digests"]) != len(want["pool_digests"]):
        raise AssertionError(f"7e: the page pool's rows of stages {differ} "
                             f"differ from 4i's")
    return k6


def say_resize_memory(label: str, ranks, smi_rows, smi: str) -> None:
    """7d's per-rank memory through the resizes (from each rank's
    ``resize_memory``) and the card's per-process memory at the probes."""
    for r in ranks:
        shrink, grow = r["resize_memory"]
        say(label, rank=r["rank"], role_after_shrink=shrink["role"],
            allocated_gb=json.dumps([_gb(shrink["allocated_before"]),
                                     _gb(shrink["allocated_after"]),
                                     _gb(grow["allocated_after"])])
            .replace(" ", ""),
            reserved_gb=json.dumps([_gb(shrink["reserved_before"]),
                                    _gb(shrink["reserved_after"]),
                                    _gb(grow["reserved_after"])])
            .replace(" ", ""),
            shrink_rows=f"{shrink['rows_sent']}/{shrink['rows_recv']}",
            shrink_mb=f"{shrink['bytes_sent'] / 1e6:.1f}/"
                      f"{shrink['bytes_recv'] / 1e6:.1f}",
            grow_rows=f"{grow['rows_sent']}/{grow['rows_recv']}",
            grow_mb=f"{grow['bytes_sent'] / 1e6:.1f}/"
                    f"{grow['bytes_recv'] / 1e6:.1f}",
            shrink_s=f"{shrink['seconds']:.3f}",
            grow_s=f"{grow['seconds']:.3f}", card=repr(smi))
    for row in smi_rows:
        say(label + "_smi", step=row["step"], pid=row["pid"],
            allocated_gb=_gb(row["allocated"]),
            reserved_gb=_gb(row["reserved"]),
            **({"compute_apps": repr(";".join(row["smi"]))}
               if "smi" in row else {}))


# ---------------------------------------------------------------------------
# 7f / 7g: safe points, chaos and the asynchronous controller across ranks
# ---------------------------------------------------------------------------
def safepoint_members(ckdir: str) -> tuple:
    """A safe point's index without its checksums and the writer's
    directory, and its arrays as {(file, key): the .npy member's zip
    entry}: the member is the array's dtype, shape and bytes, the zip
    entry's timestamp aside."""
    import os
    import zipfile
    with open(os.path.join(ckdir, "index.json")) as fh:
        idx = json.load(fh)
    idx.pop("sha256")
    idx["meta"]["spec"].pop("ckpt_dir")
    members = {}
    for f in sorted(os.listdir(ckdir)):
        if f.endswith(".npz"):
            with zipfile.ZipFile(os.path.join(ckdir, f)) as z:
                for info in z.infolist():
                    members[(f, info.filename[:-len(".npy")])] = (
                        os.path.join(ckdir, f), info.filename,
                        info.file_size, info.CRC)
    return idx, members


def same_member(a, b) -> bool:
    """Whether two npz members hold the same bytes (streamed)."""
    import zipfile
    if a[2:] != b[2:]:                  # size and CRC-32
        return False
    with zipfile.ZipFile(a[0]) as za, zipfile.ZipFile(b[0]) as zb, \
            za.open(a[1]) as fa, zb.open(b[1]) as fb:
        while True:
            x, y = fa.read(1 << 24), fb.read(1 << 24)
            if x != y:
                return False
            if not x:
                return True


def check_safepoints_across(want_dir: str, got_dir: str, steps, ranks
                            ) -> dict:
    """7f: the ranks' safe points against 4k's one process's, step by
    step: the same index (checksums and the writer's directory aside) and
    every array of every file bitwise (each .npy member's bytes: its
    dtype, shape and data); each rank wrote its own stage's shard and
    rank 0 also ``common.npz`` (a released rank nothing).  Returns {step:
    arrays compared}."""
    import os
    compared = {}
    for at in steps:
        d = f"step_{at:08d}"
        want_idx, want = safepoint_members(os.path.join(want_dir, d))
        got_idx, got = safepoint_members(os.path.join(got_dir, d))
        if got_idx != want_idx:
            raise AssertionError(f"7f: safe point {at}'s index differs from "
                                 f"4k's")
        if sorted(got) != sorted(want) or not got:
            raise AssertionError(f"7f: safe point {at}'s arrays "
                                 f"{sorted(set(got) ^ set(want))[:4]}")
        for key in want:
            if not same_member(want[key], got[key]):
                raise AssertionError(f"7f: safe point {at}: "
                                     f"{key[0]}/{key[1]} differs from 4k's")
        compared[at] = len(got)
        stages = want_idx["num_stages"]
        files = [r["safepoint_writes"][list(steps).index(at)]["files"]
                 for r in ranks]
        expect = [(["common.npz"] if r == 0 else [])
                  + ([f"stage_{r:03d}.npz"] if r < stages else [])
                  for r in range(len(ranks))]
        if files != expect:
            raise AssertionError(f"7f: safe point {at}: the ranks wrote "
                                 f"{files}, not {expect}")
    return compared


def check_resume_across(label: str, rep, ranks, want, at: int, got_digests,
                        released=()) -> dict:
    """A resumed tail across ranks against 4k's uninterrupted run
    (``want``: ``CKPT_RUN``): losses, stages, resizes after ``at``, pool
    log and the final state's digests bitwise; each rank of the safe
    point's world read ``common.npz`` and its own stage's shard alone, a
    rank outside it (``released``) nothing, and no rank holds the whole
    model after the restore.  Returns the summary."""
    tail = want["losses"][at + 1:]
    if rep["losses"] != tail or rep["start_step"] != at + 1:
        first = next((i for i, (x, y) in enumerate(zip(rep["losses"],
                                                       tail)) if x != y),
                     None)
        raise AssertionError(f"{label}: the tail from {at} differs from "
                             f"4k's at step {at + 1 + (first or 0)}")
    rz = [tuple(r) for r in want["resizes"] if r[1] > at]
    got_rz = [(r["kind"], r["step"], r["from_stages"], r["to_stages"])
              for r in rep["resizes"]]
    if got_rz != rz or rep["pool_log"] != want["pool_log"] or \
            rep["stages_history"] != want["stages"][at + 1:]:
        raise AssertionError(f"{label}: resizes {got_rz} / pool log "
                             f"{rep['pool_log']} vs 4k's {rz} / "
                             f"{want['pool_log']}")
    if got_digests != want["digests"]:
        raise AssertionError(f"{label}: the final params or moments differ "
                             f"from 4k's")
    whole = want["bytes"][f"step_{at:08d}"]
    for r in ranks:
        files = r["restore"]["files"]
        mine = ([] if r["rank"] in released else
                ["common.npz", f"stage_{r['rank']:03d}.npz"])
        if files != mine:
            raise AssertionError(f"{label}: rank {r['rank']} read {files}, "
                                 f"not {mine}")
        held = r["held_bytes"][0]
        alloc = r["restore"]["allocated"]
        if (r["rank"] in released and held != 0) or held >= whole or (
                alloc is not None and alloc >= whole):
            raise AssertionError(f"{label}: rank {r['rank']} holds {held} "
                                 f"bytes ({alloc} allocated) of a {whole}-"
                                 f"byte safe point after the restore")
    return {"steps": len(rep["losses"]), "whole_bytes": whole}


def check_chaos_across(rep, ranks, want, got_digests,
                       kinds=("rpc_loss", "rpc_dup", "manager_kill",
                              "manager_respawn")) -> dict:
    """7g: 4n (iii)'s RPC-chaos training as 4 ranks against 4n: losses and
    final state bitwise 4n (i)'s (4n holds its chaos run to them), the
    fault log, pool log, resizes and degraded-mode events (iii)'s; every
    rank's own fault log agreed (the agreement hash covers it).  Returns
    the summary."""
    chaos = want["chaos"]
    if rep["losses"] != want["losses"] or got_digests != want["digests"]:
        raise AssertionError("7g: the chaos run as ranks differs from 4n's "
                             "losses or final state")
    got = fault_log(rep)
    if [list(f) for f in got] != [list(f) for f in chaos["faults"]]:
        raise AssertionError(f"7g: fault log {got} vs 4n's "
                             f"{chaos['faults']}")
    rz = [(r["kind"], r["step"], r["from_stages"], r["to_stages"],
           list(r["workers"])) for r in rep["resizes"]]
    if rz != [tuple(r) for r in chaos["resizes"]] or \
            rep["pool_log"] != chaos["pool_log"] or \
            rep["degraded_events"] != chaos["degraded_events"]:
        raise AssertionError(f"7g: resizes {rz} / pool log "
                             f"{rep['pool_log']} / degraded "
                             f"{rep['degraded_events']} vs 4n's")
    seen = {f[1] for f in got}
    if not set(kinds) <= seen:
        raise AssertionError(f"7g: fault kinds {seen}, not {kinds}")
    return {"faults": len(got), "kinds": sorted(seen)}


def check_crash_serve_across(rep, ranks, want) -> int:
    """7g: 4r (ii)'s serve with worker 2 crashing, as 4 ranks, against 4r
    (``want``: ``CRASH_SERVE``): tokens and requeues identical, the same
    evict, K6 launched in every rank (each decoded before the crash) and
    split every time.  Returns K6's launches."""
    got = {c["rid"]: c["tokens"] for c in rep["completions"]}
    if got != want["tokens"]:
        raise AssertionError("7g: the crashed serve's tokens differ from "
                             "4r's")
    req = {c["rid"]: c["requeues"] for c in rep["completions"]}
    if req != want["requeues"] or \
            rep["requeued_total"] != want["requeued_total"] or \
            rep["requeued_total"] <= 0:
        raise AssertionError(f"7g: requeues {rep['requeued_total']} vs "
                             f"4r's {want['requeued_total']}")
    rz = [(r["kind"], r["step"], list(r["workers"]))
          for r in rep["resizes"]]
    if rz != [tuple(r) for r in want["resizes"]]:
        raise AssertionError(f"7g: resizes {rz} vs 4r's {want['resizes']}")
    k6 = summed_launches(ranks)["paged_attention"]
    split = summed_launches(ranks, "split")["paged_attention"]
    idle = [r["rank"] for r in ranks
            if r["launches"]["paged_attention"]["launches"] <= 0]
    if idle or k6 <= 0 or split != k6:
        raise AssertionError(f"7g: K6 {k6} ({split} split), ranks {idle} "
                             f"launched none")
    return k6


def check_async_across(ranks, rep, one) -> dict:
    """7b's flags with the asynchronous controller and no drain, as 4
    ranks: every rank applied the same plans at the same steps; where the
    steps are the one-process inline run's (``one``), the losses are
    bitwise its losses."""
    applied = [r["applied"] for r in ranks]
    if any(a != applied[0] for a in applied) or \
            rep["controller"]["applied"] != applied[0]:
        raise AssertionError(f"7b async: the ranks applied {applied}")
    same = applied[0] == one["controller"]["applied"]
    if same and rep["losses"] != one["losses"]:
        raise AssertionError("7b async: the plans landed on the inline "
                             "run's steps, but the losses differ")
    if not rep["controller"]["decided"]:
        raise AssertionError("7b async: no decision")
    return {"applied": applied[0], "inline_applied":
            one["controller"]["applied"], "same_steps": same}


def rank_processes() -> list:
    """Pids of live rank processes (``python -m repro_torch.launch.dist``)
    of any launch."""
    import os
    found = []
    for pid in os.listdir("/proc"):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as fh:
                argv = fh.read().split(b"\0")
        except OSError:
            continue
        if b"repro_torch.launch.dist" in argv:
            found.append(int(pid))
    return found


def run_across_phases(torch, kernels, smi: str):
    """Phases 7b-7g: one launch of 4 ranks (``rank_phase7``) on the card —
    gloo through host copies, NCCL refuses two ranks on one device — that
    ends with 7g's trainer kill, a second launch that resumes the killed
    run, and the one-process runs they are held to.

    7d: full-width, full-depth smollm-360m trained as 4 ranks (``--procs
    4 --stages 4``) on phase 4h's flags: the repack shrink releases ranks 2
    and 3, the grow binds them back; held to 4h's one process
    (``check_elastic_across``); then the hand-off's own cost.
    7c: the one-shot serve of full-width smollm-360m as 4 ranks, each
    holding its stage's rows and KV cache, against one process with 4
    stage buffers: tokens identical at temperature 0, K1 and K3 launched
    in the ranks and their sums equal to the one process's counts.
    7e: 4i's elastic paged serve as 4 ranks, held to 4i
    (``check_elastic_serve_across``).
    7b: smollm-360m at its published widths cut to 8 layers, 3 steps with
    a migration after step 1: 4 ranks against one process with 4 stage
    buffers; the migration moves rows across ranks; losses, final params,
    Adam moments and dyn state bitwise (a difference is named: the first
    differing step, the largest leaf difference, and held to rtol 1e-6);
    7b async: the same flags, the controller on its thread without the
    drain (``check_async_across``).
    7f: 4k's run, safe points and resumes across ranks
    (``check_safepoints_across``, ``check_resume_across``) and 4k's
    one-process resume of 7f's safe point (``run_ckpt_cross``).
    7g: 4r (ii)'s crashed serve and 4n (iii)'s RPC chaos as 4 ranks
    (``check_crash_serve_across``, ``check_chaos_across``), the kill and
    its resume.

    Returns {part: (launches, tensor-core launches) summed over the
    ranks}."""
    import os
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch.dist import launch
    from repro_torch.launch.serve import run_serving
    from repro_torch.launch.train import run as train_run
    parity_args = across_train_args(ACROSS_PARITY_STEPS, CUT_LAYERS,
                                    every=2, straggler="1:4.0")
    elastic_spec = cli_spec("train", elastic_train_args())
    serve_spec = cli_spec("serve", elastic_serve_args())
    parity_spec = cli_spec("train", parity_args)
    # 7f: 4k's flags into a directory of their own (beside 4k's), the
    # tails without safe points; 7g: 4n (iii)'s chaos plan, untraced, and
    # 4r (ii)'s crashed serve without its metrics endpoint; the kill: 7b's
    # flags with a safe point after step 1 and a trainer_kill after it
    work = tempfile.mkdtemp(prefix="chip_smoke_ranks_",
                            dir=os.path.dirname(CKPT_RUN["tmp"]))
    ck7f = os.path.join(work, "ck")
    ckpt_spec = cli_spec("train", ckpt_train_args(CKPT_STEPS, CUT_LAYERS) + [
        "--ckpt-dir", ck7f, "--ckpt-every", str(CKPT_EVERY)])
    ckpt = {"spec": ckpt_spec, "own": ck7f, "cross": CKPT_RUN["dir"],
            "tail": ckpt_spec.override({"ckpt_every": 0, "ckpt_dir": None})}
    chaos = {"train": cli_spec("train", autoscale_chaos_args()),
             "serve": cli_spec("serve", elastic_serve_args()).override({
                 "faults.enabled": True, "faults.seed": 1,
                 "faults.worker_crash": {FAULT_SERVE_TICK:
                                         FAULT_CRASH_WORKER},
                 "cluster.spares": 1})}
    kill_dir = os.path.join(work, "killed")
    kill_spec = parity_spec.override({
        "ckpt_dir": kill_dir, "ckpt_every": KILL_AFTER + 1,
        "faults.enabled": True, "faults.kill_at": KILL_AFTER})
    outdir = os.path.join(work, "out")
    os.makedirs(outdir)
    free_cuda(torch)
    for k in kernels.KERNELS:
        k.reset()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            try:
                timed("7", launch, "chip_smoke:rank_phase7", ACROSS_PROCS,
                      kwargs=dict(
                          elastic=elastic_spec, parity=parity_spec,
                          serve=ACROSS_SERVE, elastic_serve=serve_spec,
                          archs=[get_config(parity_spec.model.arch)],
                          parity_async=parity_spec.override({
                              "controller.async_decide": True}),
                          ckpt=ckpt, chaos=chaos, kill=kill_spec,
                          outdir=outdir))
            except RuntimeError as e:
                killed = str(e)
            else:
                raise AssertionError("7g: the trainer_kill did not end the "
                                     "launch")
        want = (f"ranks {list(range(ACROSS_PROCS))} were killed by SIGKILL")
        alive = rank_processes()
        if want not in killed or alive:
            raise AssertionError(f"7g: the kill left ranks {alive}: "
                                 f"{killed[:2000]}")
        res = timed("7load", lambda: [
            torch.load(os.path.join(outdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(ACROSS_PROCS)])
        # the launch's parts, as rank 0 timed them
        for part, sec in res[0]["seconds"].items():
            PHASE_SECONDS[f"7:{part}"] = sec
        # the killed run resumed from its step-1 safe point as 4 ranks, in
        # a launch of its own beside the checks below (its ranks' counts
        # are their own; the card is shared, so the one-process runs'
        # times there are not the card's alone)
        import threading
        got = {}

        def resume_killed():
            t0 = time.perf_counter()
            try:
                got["res"] = launch(
                    "chip_smoke:rank_resume_killed", ACROSS_PROCS,
                    kwargs=dict(spec=kill_spec, resume=(kill_dir, KILL_AFTER),
                                arch=get_config(parity_spec.model.arch)))
            except BaseException as e:   # noqa: BLE001 — raised below
                got["err"] = e
            PHASE_SECONDS["7g_resume"] = time.perf_counter() - t0

        thread = threading.Thread(target=resume_killed, daemon=True)
        thread.start()

        def resumed():
            thread.join()
            if "err" in got:
                raise got["err"]
            return got["res"]

        try:
            return timed("7checks", across_checks, torch, kernels, smi, res,
                         resumed, ckpt, parity_args, train_run, run_serving)
        finally:
            thread.join()
    finally:
        shutil.rmtree(work, ignore_errors=True)
        shutil.rmtree(CKPT_RUN.pop("tmp"), ignore_errors=True)


def across_checks(torch, kernels, smi, res, resumed, ckpt, parity_args,
                  train_run, run_serving):
    """Phase 7's checks and lines, from the launch's results (``res``, each
    rank's) and the killed run's resume (``resumed``); the one-process
    runs they need run here."""
    out = {}
    # ---- 7d
    rep = res[0]["7d"]["report"]
    ranks = [r["7d"]["rank"] for r in res]
    got = check_elastic_across(rep, ranks, ELASTIC_TRAIN)
    launched, tc = got["launched"], summed_launches(ranks, "tc")
    steps = rep["spec"]["steps"]
    check_launches("elastic train across ranks", launched,
                   TRAIN_LAUNCHES_PER_STEP, steps)
    if got["bwd"]["pruned_matmul"] != TRAIN_K3_BWD_PER_STEP * steps:
        raise AssertionError(f"7d: K3 backward launches "
                             f"{got['bwd']['pruned_matmul']}, expected "
                             f"{TRAIN_K3_BWD_PER_STEP} a step")
    check_tensor_core("elastic train across ranks", launched, tc,
                      ACROSS_PATH)
    losses = rep["losses"]
    if not all(math.isfinite(x) for x in losses) or \
            abs(losses[0] - math.log(49152)) > 1.0:
        raise AssertionError(f"7d: losses {losses}")
    probe = res[0]["probe"]
    if not probe["equal"]:
        raise AssertionError("7d: the hand-off probe's carry came back "
                             "changed")
    t = rep["timing"]
    say_ranks("elastic_train_across_rank", ranks, smi)
    say_resize_memory("elastic_train_across_memory", ranks,
                      [row for r in res for row in r["7d_memory"]], smi)
    say("handoff_probe", bytes=probe["bytes"],
        one_way_ms=f"{probe['one_way_ms']:.3f}",
        staging_copy_ms=f"{probe['copy_ms']:.3f}",
        gbps=f"{probe['bytes'] / probe['one_way_ms'] / 1e6:.2f}",
        card=repr(smi))
    say("elastic_train_across", procs=ACROSS_PROCS, steps=steps,
        tokens_per_step=rep["tokens_per_step"],
        resizes=json.dumps([(r["kind"], r["step"], r["workers"],
                             round(r["seconds"], 4))
                            for r in rep["resizes"]]).replace(" ", ""),
        pool_log=json.dumps(rep["pool_log"]).replace(" ", ""),
        losses_bitwise=got["losses_bitwise"],
        first_differing_step=got["first_differing_step"],
        loss_max_rel=f"{got['loss_max_rel']:.3e}",
        step_ms_by_world=json.dumps(world_ms(rep["step_times"],
                                             rep["stages_history"]))
        .replace(" ", ""),
        one_process_step_ms_by_world=json.dumps(world_ms(
            ELASTIC_TRAIN["step_times"], ELASTIC_TRAIN["stages"]))
        .replace(" ", ""),
        steady_step_p50_ms=f"{t['steady_step_p50_s'] * 1e3:.1f}",
        step0_ms=f"{rep['step_times'][0] * 1e3:.1f}",
        wall_s=f"{rep['wall_s']:.2f}",
        loss_first=f"{rep['losses'][0]:.4f}",
        loss_last=f"{rep['losses'][-1]:.4f}",
        launches=json.dumps(launched).replace(" ", ""),
        k3_bwd_launches=got["bwd"]["pruned_matmul"], card=repr(smi))
    out["elastic_train_across"] = (launched, tc)

    # ---- 7e
    rep = res[0]["7e"]["report"]
    ranks = [r["7e"]["rank"] for r in res]
    launched, tc = summed_launches(ranks), summed_launches(ranks, "tc")
    k6 = check_elastic_serve_across(rep, ranks, ELASTIC_SERVE)
    check_tensor_core("elastic serve across ranks", launched, tc,
                      ("block_sparse_attention", "pruned_matmul"))
    for r in ranks:
        mem = {m["kind"]: m for m in r["resize_memory"]}
        say("elastic_serve_across_rank", rank=r["rank"],
            k6_launches=r["launches"]["paged_attention"]["launches"],
            k6_split=r["launches"]["paged_attention"]["split"],
            allocated_gb=json.dumps([
                _gb(mem["shrink"]["allocated_before"]),
                _gb(mem["shrink"]["allocated_after"]),
                _gb(mem["grow"]["allocated_after"])]).replace(" ", ""),
            reserved_gb=json.dumps([
                _gb(mem["shrink"]["reserved_before"]),
                _gb(mem["shrink"]["reserved_after"]),
                _gb(mem["grow"]["reserved_after"])]).replace(" ", ""),
            role_after_shrink=mem["shrink"]["role"],
            shrink_s=f"{mem['shrink']['seconds']:.3f}",
            grow_s=f"{mem['grow']['seconds']:.3f}",
            peak_mem_gb=_gb(r["peak_allocated"]), card=repr(smi))
    say("elastic_serve_across", procs=ACROSS_PROCS,
        requests=len(rep["completions"]), tokens=rep["total_tokens"],
        ticks=rep["ticks"], tokens_identical=True, pool_bitwise=True,
        k6_launches=k6, k6_split_launches=k6,
        tick_p50_ms=f"{_pct50(rep['tick_wall_s']) * 1e3:.1f}",
        one_process_tick_p50_ms=f"{ELASTIC_SERVE['tick_p50'] * 1e3:.1f}",
        tick_ms_by_world=json.dumps(world_ms(rep["tick_wall_s"],
                                             rep["stages_history"]))
        .replace(" ", ""),
        tokens_per_s=f"{rep['tokens_per_s']:.1f}",
        launches=json.dumps(launched).replace(" ", ""), card=repr(smi))
    out["elastic_serve_across"] = (launched, tc)

    # ---- 7c: the one process's serve, counters zeroed just before it
    free_cuda(torch)
    for k in kernels.KERNELS:
        k.reset()
    kw = {k: v for k, v in ACROSS_SERVE.items() if k != "arch"}
    one = timed("7c", run_serving, ACROSS_SERVE["arch"], **kw)
    torch.cuda.synchronize()
    want = {k.name: k.launches for k in kernels.KERNELS}
    across = res[0]["7c"]
    ranks = [r["7c"]["rank"] for r in res]
    launched, tc = summed_launches(ranks), summed_launches(ranks, "tc")
    if not np_equal(across["tokens"], one["tokens"]):
        raise AssertionError("7c: the ranks' tokens differ from one "
                             "process's")
    missing = [n for n in ("block_sparse_attention", "pruned_matmul")
               if launched[n] <= 0]
    if missing or launched != want:
        raise AssertionError(f"7c: launches {launched} vs one process's "
                             f"{want}")
    check_tensor_core("serve across ranks", launched, tc,
                      ("block_sparse_attention", "pruned_matmul"))
    say_ranks("serve_across_rank", ranks, smi)
    say("serve_across", procs=ACROSS_PROCS, tokens=across["tokens"].size,
        tokens_identical=True,
        tokens_per_s=f"{across['tokens_per_s']:.1f}",
        one_process_tokens_per_s=f"{one['tokens_per_s']:.1f}",
        wall_s=f"{across['wall_s']:.2f}",
        launches=json.dumps(launched).replace(" ", ""), card=repr(smi))
    out["serve_across"] = (launched, tc)
    del one

    # ---- 7b: the one process's training of the same flags
    free_cuda(torch)
    across = res[0]["7b"]["report"]
    ranks = [r["7b"]["rank"] for r in res]
    parts = {p: (res[0][p].get("report"), [r[p]["rank"] for r in res])
             for p in ("7b_async", "7f", "7f_r15", "7f_r7", "7g_serve",
                       "7g")}
    del res
    one = timed("7b", train_run, parity_args)
    moved = [(e.iteration, e.moved_layers) for e in across["events"]]
    if not any(m > 0 for _, m in moved) or moved != [
            (e.iteration, e.moved_layers) for e in one["events"]]:
        raise AssertionError(f"7b: events {moved} vs one process's")
    rows = sum(r["comm"]["rows_sent"] for r in ranks)
    if rows <= 0 or rows != sum(r["comm"]["rows_recv"] for r in ranks):
        raise AssertionError(f"7b: the migration moved no rows across "
                             f"ranks: {rows}")
    worst, differ = 0.0, []
    for tree in ("params", "opt_state", "dyn"):
        theirs = dict(leaves(one[tree]))
        for path, a in leaves(across[tree]):
            b = theirs[path]
            a = a.to(b.device)
            if not torch.equal(a, b):
                d = float((a.double() - b.double()).abs().max()
                          / b.double().abs().max().clamp(min=1e-30))
                differ.append(f"{tree}{path}")
                worst = max(worst, d)
    first = next((i for i, (x, y) in enumerate(zip(across["losses"],
                                                     one["losses"]))
                  if x != y), None)
    rel = max(abs(x - y) / abs(y) for x, y in zip(across["losses"],
                                                   one["losses"]))
    say("train_across_parity", layers=CUT_LAYERS, steps=len(one["losses"]),
        events=json.dumps(moved).replace(" ", ""), rows_moved=rows,
        losses_bitwise=first is None, first_differing_step=first,
        loss_max_rel=f"{rel:.3e}", leaves_differing=len(differ),
        first_leaf=(differ[0] if differ else "none"),
        worst_leaf_rel=f"{worst:.3e}", card=repr(smi))
    if rel > 1e-6 or worst > 1e-6:
        raise AssertionError(f"7b: 4 ranks vs one process: loss {rel:.3e}, "
                             f"leaf {worst:.3e} ({differ[:4]})")
    rank_step_parts("7b", ranks, smi)
    del across

    # ---- 7b async: the same flags, the controller on its thread, no drain
    rep, ranks = parts.pop("7b_async")
    got = check_async_across(ranks, rep, one)
    launched, tc = summed_launches(ranks), summed_launches(ranks, "tc")
    check_tensor_core("async train across ranks", launched, tc, ACROSS_PATH)
    say("async_across", steps=len(rep["losses"]),
        applied=json.dumps(got["applied"]).replace(" ", ""),
        inline_applied=json.dumps(got["inline_applied"]).replace(" ", ""),
        same_steps=got["same_steps"],
        losses_bitwise_inline=rep["losses"] == one["losses"],
        decided=rep["controller"]["decided"],
        dropped=rep["controller"]["dropped"],
        stale=rep["controller"]["stale_rejected"],
        launches=json.dumps(launched).replace(" ", ""), card=repr(smi))
    out["async_across"] = (launched, tc)

    # 7g's kill is held to this run (checked last: its resume runs beside)
    kill_want = {"losses": one["losses"][KILL_AFTER + 1:],
                 "digests": state_digests(one["params"], one["opt_state"])}
    del one
    free_cuda(torch)

    # ---- 7f: 4k's run as 4 ranks, its safe points, the resumes
    rep, ranks = parts.pop("7f")
    if rep["losses"] != CKPT_RUN["losses"] or \
            rep["pool_log"] != CKPT_RUN["pool_log"] or \
            [(r["kind"], r["step"], r["from_stages"], r["to_stages"])
             for r in rep["resizes"]] != CKPT_RUN["resizes"]:
        raise AssertionError("7f: the ranks' run differs from 4k's")
    compared = check_safepoints_across(CKPT_RUN["dir"], ckpt["own"],
                                       (CKPT_CROSS, 15), ranks)
    launched, tc = summed_launches(ranks), summed_launches(ranks, "tc")
    check_launches("7f", launched, CUT_LAUNCHES_PER_STEP, CKPT_STEPS)
    check_tensor_core("7f", launched, tc, ACROSS_PATH)
    for r in ranks:
        say("safepoint_across_rank", rank=r["rank"],
            seconds=json.dumps([round(w["seconds"], 3)
                                for w in r["safepoint_writes"]])
            .replace(" ", ""),
            gb=json.dumps([round(w["bytes"] / 1e9, 3)
                           for w in r["safepoint_writes"]]).replace(" ", ""),
            files=json.dumps([w["files"] for w in r["safepoint_writes"]])
            .replace(" ", ""), card=repr(smi))
    say("safepoint_across", steps=CKPT_STEPS, arrays_bitwise_4k=True,
        arrays=json.dumps(compared).replace(" ", ""),
        save_s=json.dumps([round(x, 3) for x in rep["timing"]
                           ["safepoint_s"]]).replace(" ", ""),
        one_process_save_s=json.dumps([round(x, 3) for x in
                                       CKPT_RUN["save_s"]]).replace(" ", ""),
        losses_bitwise=True, launches=json.dumps(launched).replace(" ", ""),
        card=repr(smi))
    total = dict(launched)
    total_tc = dict(tc)
    for part, at, released, src in (("7f_r15", 15, (2, 3), "own"),
                                    ("7f_r7", CKPT_CROSS, (), "4k")):
        rep, ranks = parts.pop(part)
        got = check_resume_across(f"7f resume from {at}", rep, ranks,
                                  CKPT_RUN, at, ranks_digests(ranks),
                                  released)
        launched, tc = summed_launches(ranks), summed_launches(ranks, "tc")
        check_launches(part, launched, CUT_LAUNCHES_PER_STEP, got["steps"])
        check_tensor_core(part, launched, tc, ACROSS_PATH)
        for r in ranks:
            say("restore_across_rank", from_step=at, safepoint=src,
                rank=r["rank"], role_after_restore=(
                    "released" if r["rank"] in released else "active"),
                restore_s=f"{r['restore']['seconds']:.3f}",
                allocated_gb=_gb(r["restore"]["allocated"]),
                held_gb=_gb(r["held_bytes"][0]),
                whole_gb=_gb(got["whole_bytes"]),
                files=json.dumps(r["restore"]["files"]).replace(" ", ""),
                card=repr(smi))
        say("resume_across", from_step=at, safepoint=src,
            steps=got["steps"], losses_bitwise=True, state_bitwise=True,
            one_process_restore_s=(f"{CKPT_RUN['restore'][at][0]:.3f}"
                                   if at in CKPT_RUN.get("restore", {})
                                   else "none"),
            launches=json.dumps(launched).replace(" ", ""), card=repr(smi))
        for n in total:
            total[n] += launched[n]
            total_tc[n] += tc[n]
    out["safepoints_across"] = (total, total_tc)
    out["ckpt_cross"] = run_ckpt_cross(torch, kernels, ckpt, smi)

    # ---- 7g: 4r (ii)'s crashed serve and 4n (iii)'s chaos run as ranks
    rep, ranks = parts.pop("7g_serve")
    k6 = check_crash_serve_across(rep, ranks, CRASH_SERVE)
    launched, tc = summed_launches(ranks), summed_launches(ranks, "tc")
    check_tensor_core("crashed serve across ranks", launched, tc,
                      ("block_sparse_attention", "pruned_matmul"))
    say("chaos_serve_across", requests=len(rep["completions"]),
        requeued=rep["requeued_total"], tokens_identical=True,
        resizes=json.dumps([(r["kind"], r["step"], r["workers"])
                            for r in rep["resizes"]]).replace(" ", ""),
        roles=json.dumps([r["role"] for r in ranks]).replace(" ", ""),
        k6_by_rank=json.dumps([r["launches"]["paged_attention"]["launches"]
                               for r in ranks]).replace(" ", ""),
        k6_launches=k6, k6_split_launches=k6,
        launches=json.dumps(launched).replace(" ", ""), card=repr(smi))
    out["chaos_serve_across"] = (launched, tc)
    rep, ranks = parts.pop("7g")
    got = check_chaos_across(rep, ranks, AUTOSCALE_FILE_RUN,
                             ranks_digests(ranks))
    launched, tc = summed_launches(ranks), summed_launches(ranks, "tc")
    check_launches("7g", launched, CUT_LAUNCHES_PER_STEP,
                   len(rep["losses"]))
    check_tensor_core("7g", launched, tc, ACROSS_PATH)
    say("chaos_train_across", steps=len(rep["losses"]),
        faults=got["faults"], kinds=json.dumps(got["kinds"])
        .replace(" ", ""), fault_log_equal_4n=True, losses_bitwise=True,
        state_bitwise=True,
        resizes=json.dumps([(r["kind"], r["step"], r["workers"])
                            for r in rep["resizes"]]).replace(" ", ""),
        pool_log=json.dumps(rep["pool_log"]).replace(" ", ""),
        degraded_events=json.dumps(rep["degraded_events"],
                                   separators=(",", ":")),
        wall_s=f"{rep['wall_s']:.2f}",
        launches=json.dumps(launched).replace(" ", ""), card=repr(smi))
    out["chaos_train_across"] = (launched, tc)

    # ---- 7g's kill: the launch ended, every rank gone; resumed as 4 ranks
    res = resumed()
    rep = res[0]["report"]
    ranks = [r["rank"] for r in res]
    if (rep["start_step"] != KILL_AFTER + 1
            or rep["losses"] != kill_want["losses"] or rep["faults"] != []
            or ranks_digests(ranks) != kill_want["digests"]):
        raise AssertionError(f"7g kill: the resume from step {KILL_AFTER} "
                             f"differs from the uninterrupted 7b run")
    launched, tc = summed_launches(ranks), summed_launches(ranks, "tc")
    check_tensor_core("killed train resumed across ranks", launched, tc,
                      ACROSS_PATH)
    say("kill_across", killed_after=KILL_AFTER, ranks_killed=ACROSS_PROCS,
        ranks_left=0, resumed_from=rep["resumed_from"],
        losses_bitwise=True, state_bitwise=True,
        restore_s=json.dumps([round(r["restore"]["seconds"], 3)
                              for r in ranks]).replace(" ", ""),
        launches=json.dumps(launched).replace(" ", ""), card=repr(smi))
    out["kill_resume_across"] = (launched, tc)
    free_cuda(torch)
    return out


def run_ckpt_cross(torch, kernels, ckpt, smi):
    """Phase 4k's one-process resume from step 7, reading 7f's
    rank-written safe point (the resumed Session's RunSpec must be the
    ranks' writer's): its tail held to 4k's uninterrupted run as 4k held
    its own.  Counts zeroed just before, read just after; returns them
    with the tensor-core ones."""
    from repro_torch.api import Session
    free_cuda(torch)
    for k in kernels.KERNELS:
        k.reset()
    t0 = time.perf_counter()
    sess = Session.resume(ckpt["own"], step=CKPT_CROSS)
    if sess.spec != ckpt["spec"]:
        raise AssertionError("7f: the resumed RunSpec differs from the "
                             "ranks' writer's")
    sess.spec = ckpt["tail"]
    with sess:
        rep = sess.train()
    launched, launched_tc = _window(torch, kernels)
    PHASE_SECONDS["7f_cross"] = time.perf_counter() - t0
    got = check_resume_across("4k resume from 7f's step 7", rep, [],
                              CKPT_RUN, CKPT_CROSS,
                              state_digests(rep["params"],
                                            rep["opt_state"]))
    check_launches("ckpt cross", launched, CUT_LAUNCHES_PER_STEP,
                   got["steps"])
    check_tensor_core("ckpt cross", launched, launched_tc, FP32_TC_PATH)
    say("ckpt_resume", from_step=CKPT_CROSS, stages=4,
        safepoint="7f_ranks",
        restore_s=f"{rep['timing']['restore_s']:.2f}",
        allocated_gb_after_restore=(
            f"{rep['timing']['restore_allocated'] / 1e9:.3f}"),
        losses_bitwise=True, params_bitwise=True, moments_bitwise=True,
        resumed_spec_equal=True,
        resizes=json.dumps([(r["kind"], r["step"], r["from_stages"],
                             r["to_stages"]) for r in rep["resizes"]])
        .replace(" ", ""),
        pool_log=json.dumps(rep["pool_log"]).replace(" ", ""),
        wall_s=f"{rep['wall_s']:.2f}", card=repr(smi))
    del rep, sess
    free_cuda(torch)
    return launched, launched_tc


# ---------------------------------------------------------------------------
# phases 7h-7j: the block families across ranks (2 ranks, data 1 x model 2)
# ---------------------------------------------------------------------------
# 2 ranks: 4e's Mixtral training takes 57.88 GB in one process, so neither
# 4 ranks nor data 2 hold it at full width on the one card
FAMILY_PROCS = 2
# 7i's prefix of 6b's steps: the cadence after step 3 migrates rows across
# the ranks and step 4 runs on them
ZAMBA_ACROSS_STEPS = 5
MOE_TRAIN = {}       # 4e's run, what 7h is held to
MOE_SERVE = {}       # 4f's serve, what 7j is held to
ZAMBA_TRAIN = {}     # 6b's run, what 7i is held to
MOE_PATH = ("grouped_matmul", "grouped_matmul_dw")


def fingerprint(tree) -> str:
    """A digest of a tree's bytes taken on the tensors' device: for each
    leaf (paths in order), three int64 sums of its words (plain, weighted
    by position, squared; wrapping), hashed with its path, shape and
    dtype.  Equal digests mean equal bytes unless all three sums collide;
    no host copy of the state is made (sha256 of 4e's ~28 GB of rows and
    moments on the host would take about a minute)."""
    import hashlib

    import torch

    from repro_torch.launch.sharding import leaves as tree_leaves
    words = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    h = hashlib.sha256()
    for path, t in tree_leaves(tree):
        v = t.detach().contiguous().reshape(-1).view(words[t.element_size()])
        acc = torch.zeros(3, dtype=torch.int64, device=v.device)
        chunk = 1 << 25
        for i in range(0, v.numel(), chunk):
            x = v[i:i + chunk].to(torch.int64)
            w = torch.arange(i, i + x.numel(), dtype=torch.int64,
                             device=x.device) % 65521 + 1
            acc += torch.stack([x.sum(), (x * w).sum(), (x * x).sum()])
        h.update(repr(("/".join(path), tuple(t.shape), str(t.dtype),
                       acc.tolist())).encode())
    return h.hexdigest()


def state_fingerprints(params, opt_state) -> dict:
    """``state_digests`` with ``fingerprint`` digests (on the card)."""
    from repro_torch.launch.sharding import (leaves as tree_leaves,
                                             rebuild, split_stages)
    p_rows, p_rest = split_stages(params)
    o_rows, o_rest = split_stages(opt_state)
    S = next(t for _, t in tree_leaves(p_rows)).shape[0]
    return {"rows": [fingerprint({
        "params": rebuild(p_rows, lambda _, t: t[s:s + 1]),
        "opt": rebuild(o_rows, lambda _, t: t[s:s + 1])}) for s in range(S)],
        "rest": fingerprint({"params": p_rest, "opt": o_rest})}


def rank_fingerprints(world, params, opt_state) -> dict:
    """A rank's ``session.state_digest`` fields with ``fingerprint``
    digests (``rank_train``'s ``digest``; picklable: the ranks import this
    module)."""
    from repro_torch.launch.sharding import split_stages
    out = {"stage": None, "rows": None, "rest": None}
    if world.member and world.replica == 0 and params is not None:
        p_rows, p_rest = split_stages(params)
        o_rows, o_rest = split_stages(opt_state)
        out.update(stage=world.stage,
                   rows=fingerprint({"params": p_rows, "opt": o_rows}))
        if world.rank == world.leader:
            out["rest"] = fingerprint({"params": p_rest, "opt": o_rest})
    return out


def _lean(got):
    """A rank part's result without the trees of its report (rank 0's
    rows and moments stay on the rank)."""
    rep = got.get("report")
    if rep is not None:
        for k in ("params", "opt_state", "dyn", "cache"):
            rep.pop(k, None)
    return got


def rank_families(mesh, moe, zamba, serve, archs):
    """Phases 7h-7j in one set of 2 ranks (launched by ``launch.dist``):
    4e's Mixtral training with its live expert re-layout, 6b's zamba2
    training (a prefix holding its first migration) and 4f's MoE serve at
    2 stages, each with the counters and transfer stats zeroed just before
    it and read just after.  Returns each part's result (rank 0's report,
    each rank's counters) and its seconds."""
    import torch

    from repro_torch import kernels
    from repro_torch.api.session import rank_serve_elastic, rank_train
    from repro_torch.launch.dist import _to_device, ensure_arch
    for cfg in archs:
        ensure_arch(cfg)
    out = {"seconds": {}}
    for part, fn in (
            ("7h", lambda: rank_train(mesh, moe, digest=rank_fingerprints)),
            ("7i", lambda: rank_train(mesh, zamba)),
            ("7j", lambda: rank_serve_elastic(mesh, serve))):
        for k in kernels.KERNELS:
            k.reset()
        mesh.comm.stats = dict.fromkeys(mesh.comm.stats, 0)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out[part] = _to_device(_lean(fn()), "cpu")
        out["seconds"][part] = time.perf_counter() - t0
    return out


def _first_parting(got, want):
    return next((i for i, (x, y) in enumerate(zip(got, want)) if x != y),
                None if len(got) == len(want) else min(len(got), len(want)))


def check_moe_across(rep, ranks, want) -> tuple:
    """7h against 4e (``want``: ``MOE_TRAIN``): the losses, the re-layouts
    (step, skew, tokens, experts moved, placement), the skew and drop
    fraction of every decision and every rank's committed layout bitwise;
    the final rows and replicated leaves 4e's (``fingerprint`` digests);
    K4 and K5 summed over the ranks 4e's counts a step, every launch on
    the tensor cores, each rank launching both.  Returns (launches,
    tensor-core launches) summed over the ranks."""
    first = _first_parting(rep["losses"], want["losses"])
    if first is not None:
        raise AssertionError(f"7h: the losses part from 4e's at step "
                             f"{first}")
    if rep["relayouts"] != want["relayouts"] or \
            rep["moe_history"] != want["moe_history"]:
        raise AssertionError(f"7h: re-layouts {rep['relayouts']} / skew "
                             f"and drops {rep['moe_history']} vs 4e's")
    if sum(1 for r in rep["relayouts"] if r["moved_experts"] > 0) < 1:
        raise AssertionError("7h: no re-layout moved experts")
    layouts = [r["expert_layout"] for r in ranks]
    if any(x != want["expert_layout"] for x in layouts):
        raise AssertionError(f"7h: the ranks' committed layouts {layouts} "
                             f"vs 4e's {want['expert_layout']}")
    if ranks_digests(ranks) != want["digests"]:
        raise AssertionError("7h: the final rows or replicated leaves "
                             "differ from 4e's")
    launched, tc = summed_launches(ranks), summed_launches(ranks, "tc")
    check_launches("7h", launched, MOE_TRAIN_LAUNCHES_PER_STEP,
                   len(rep["losses"]))
    check_tensor_core("7h", launched, tc, MOE_PATH)
    idle = [(r["rank"], n) for r in ranks for n in MOE_PATH
            if r["launches"][n]["launches"] <= 0]
    if idle:
        raise AssertionError(f"7h: (rank, kernel) {idle} launched nothing")
    return launched, tc


def check_zamba_across(rep, ranks, want) -> tuple:
    """7i against 6b (``want``: ``ZAMBA_TRAIN``), over the prefix's steps:
    the losses, the migrations (iteration, layers moved), each step's
    split and the block types the migration moved bitwise; rows moved
    across the ranks (sent = received > 0); K1 / K2a / K2b summed over the
    ranks ``ZAMBA_LAUNCHES_PER_STEP`` a step, all on the tensor cores.
    Returns (launches, tensor-core launches, the moved types)."""
    from repro_torch.configs import BLOCK_PAD
    n = len(rep["losses"])
    first = _first_parting(rep["losses"], want["losses"][:n])
    if first is not None or n > len(want["losses"]):
        raise AssertionError(f"7i: the losses part from 6b's at step "
                             f"{first}")
    events = [[e.iteration, e.moved_layers] for e in rep["events"]]
    if events != [e for e in want["events"] if e[0] <= n] or not events:
        raise AssertionError(f"7i: migrations {events} vs 6b's "
                             f"{want['events']}")
    if rep["lps_history"] != want["lps_history"][:n] or (
            n < len(want["lps_history"])
            and list(rep["final_lps"]) != want["lps_history"][n]):
        raise AssertionError(f"7i: splits {rep['lps_history']} -> "
                             f"{rep['final_lps']} vs 6b's")
    # the run's block pattern, from its final assignment (PAD slots out)
    pattern = [int(t) for row in rep["assignment"]["tags"].tolist()
               for t in row if t != BLOCK_PAD]
    moved = _moved_types(pattern, [rep["lps_history"][0], rep["final_lps"]])
    if not moved:
        raise AssertionError("7i: the migration moved no block")
    rows = [sum(r["comm"][k] for r in ranks)
            for k in ("rows_sent", "rows_recv")]
    if rows[0] <= 0 or rows[0] != rows[1]:
        raise AssertionError(f"7i: rows sent / received {rows}")
    launched, tc = summed_launches(ranks), summed_launches(ranks, "tc")
    check_launches("7i", launched, ZAMBA_LAUNCHES_PER_STEP, n)
    check_tensor_core("7i", launched, tc, FP32_TC_PATH[:3])
    return launched, tc, moved


def check_moe_serve_across(rep, ranks, want) -> tuple:
    """7j against 4f (``want``: ``MOE_SERVE``): every request's tokens
    identical, the mean drop fraction equal, each rank launching K4.
    Returns (launches, tensor-core launches) summed over the ranks."""
    got = {c["rid"]: c["tokens"] for c in rep["completions"]}
    if got != want["tokens"]:
        raise AssertionError("7j: the ranks' tokens differ from 4f's")
    if rep["moe_dropped_mean"] != want["drop"]:
        raise AssertionError(f"7j: drop {rep['moe_dropped_mean']} vs 4f's "
                             f"{want['drop']}")
    idle = [r["rank"] for r in ranks
            if r["launches"]["grouped_matmul"]["launches"] <= 0]
    if idle:
        raise AssertionError(f"7j: ranks {idle} launched no K4")
    return summed_launches(ranks), summed_launches(ranks, "tc")


def say_family_ranks(label: str, ranks, smi: str, names) -> None:
    """Per rank: its launches of ``names``, peak memory_allocated, mean
    step (tick) ms, hand-offs and their bytes, the gradient sums'
    seconds."""
    for r in ranks:
        c = r["comm"]
        times = r.get("step_times") or r.get("tick_wall_s") or []
        tail = times[1:] or times
        say(label, rank=r["rank"], stage=r["stage"],
            launches=json.dumps({n: r["launches"][n]["launches"]
                                 for n in names}).replace(" ", ""),
            peak_mem_gb=_gb(r["peak_allocated"]),
            peak_reserved_gb=_gb(r.get("peak_reserved")),
            mean_ms=f"{sum(tail) / max(1, len(tail)) * 1e3:.1f}",
            handoffs=c["handoffs"], handoff_bytes=c["handoff_bytes"],
            grad_ring_s=f"{c['grad_ring_s']:.3f}",
            rows_sent=c["rows_sent"], rows_recv=c["rows_recv"],
            card=repr(smi))


def rank_step_parts(label: str, ranks, smi: str) -> None:
    """``[rank_step_parts]``: a train step's wall per rank (the mean over
    its steps) cut into the hand-offs' sends, the waits for a peer's
    carry, the staging copies, the replicated leaves' gradient sum over
    the ring, the gradient sums over ``data``, and the rest (compute and
    host work)."""
    rows = []
    for r in ranks:
        c = r["comm"]
        n = max(1, len(r["step_times"]))
        part = {k: c[s] / n * 1e3 for k, s in (
            ("send_ms", "send_s"), ("recv_wait_ms", "recv_wait_s"),
            ("staging_copy_ms", "copy_s"), ("grad_ring_ms", "grad_ring_s"),
            ("grad_data_ms", "grad_data_s"))}
        step = sum(r["step_times"]) / n * 1e3
        rows.append({"rank": r["rank"], "steps": n, "step_ms": step,
                     **part, "rest_ms": step - sum(part.values())})
    print("[rank_step_parts] " + json.dumps(
        {"phase": label, "card": smi, "ranks": rows}), flush=True)


def run_family_ranks(torch, kernels, smi: str):
    """Phases 7h-7j: one launch of 2 ranks (``rank_families``), after
    phase 7's launch has exited and freed the card, held to the one-process
    runs 4e, 6b and 4f made.

    7h: full-width Mixtral-8x7B cut to 2 layers on 4e's flags (bf16, 8192
    tokens a step, live re-layout every 3 steps), one layer a rank
    (``check_moe_across``).  7i: full-size zamba2-1.2b on 6b's flags, the
    first ``ZAMBA_ACROSS_STEPS`` steps (``check_zamba_across``).  7j: 4f's
    MoE serve (4 layers, fp32, contiguous KV) as the elastic server at 2
    stages, one a rank (``check_moe_serve_across``).  Returns {part:
    (launches, tensor-core launches) summed over the ranks}."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dist import launch
    moe = cli_spec("train", moe_train_args())
    zamba = cli_spec("train", zamba2_train_args(ZAMBA_ACROSS_STEPS))
    serve = cli_spec("serve", moe_serve_args()).override(
        {"parallel.stages": FAMILY_PROCS})
    free_cuda(torch)
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    for k in kernels.KERNELS:
        k.reset()
    # the card's 80 GB hold 7h's two ranks (~32 GB each) with little to
    # spare: what this process still holds, and segments that grow in
    # place in the ranks (no reserved-but-unallocated tail)
    free, total = torch.cuda.mem_get_info()
    say("families_across_start",
        parent_allocated_gb=_gb(torch.cuda.memory_allocated()),
        parent_reserved_gb=_gb(torch.cuda.memory_reserved()),
        card_free_gb=_gb(free), card_total_gb=_gb(total), card=repr(smi))
    import os
    env = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        res = timed("7hij", launch, "chip_smoke:rank_families",
                    FAMILY_PROCS, kwargs=dict(
                        moe=moe, zamba=zamba, serve=serve,
                        archs=[get_config(moe.model.arch),
                               get_config(serve.model.arch)]))
    finally:
        if env is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = env
    for part, sec in res[0]["seconds"].items():
        PHASE_SECONDS[f"7:{part}"] = sec
    out = {}
    # ---- 7h
    rep = res[0]["7h"]["report"]
    ranks = [r["7h"]["rank"] for r in res]
    launched, tc = check_moe_across(rep, ranks, MOE_TRAIN)
    say_family_ranks("moe_train_across_rank", ranks, smi, MOE_PATH)
    rank_step_parts("7h", ranks, smi)
    st = rep["step_times"]
    say("moe_train_across", procs=FAMILY_PROCS, steps=len(st),
        losses_bitwise=True, relayouts_bitwise=True, state_bitwise=True,
        relayouts=json.dumps([[r["step"], r["moved_experts"],
                               r["placement"]] for r in rep["relayouts"]])
        .replace(" ", ""),
        step_ms=f"{sum(st[1:]) / max(1, len(st) - 1) * 1e3:.1f}",
        one_process_step_ms=f"{MOE_TRAIN['step_ms']:.1f}",
        one_process_peak_gb=f"{MOE_TRAIN['peak_gb']:.2f}",
        expert_skew_last=f"{rep['expert_skew_last']:.4f}",
        moe_dropped_last=f"{rep['moe_dropped_last']:.4f}",
        launches=json.dumps(launched).replace(" ", ""),
        launches_tc=json.dumps({n: tc[n] for n in MOE_PATH})
        .replace(" ", ""), card=repr(smi))
    out["moe_train_across"] = (launched, tc)
    # ---- 7i
    rep = res[0]["7i"]["report"]
    ranks = [r["7i"]["rank"] for r in res]
    launched, tc, moved = check_zamba_across(rep, ranks, ZAMBA_TRAIN)
    say_family_ranks("zamba2_train_across_rank", ranks, smi,
                     FP32_TC_PATH[:3])
    st = rep["step_times"]
    say("zamba2_train_across", procs=FAMILY_PROCS, steps=len(st),
        losses_bitwise=True, split_bitwise=True,
        events=json.dumps([[e.iteration, e.moved_layers]
                           for e in rep["events"]]).replace(" ", ""),
        moved_types=sorted(moved), final_lps=rep["final_lps"],
        rows_moved=sum(r["comm"]["rows_sent"] for r in ranks),
        step_ms=f"{sum(st[1:]) / max(1, len(st) - 1) * 1e3:.1f}",
        one_process_step_ms=f"{ZAMBA_TRAIN['step_ms']:.1f}",
        launches=json.dumps(launched).replace(" ", ""), card=repr(smi))
    out["zamba2_train_across"] = (launched, tc)
    # ---- 7j
    rep = res[0]["7j"]["report"]
    ranks = [r["7j"]["rank"] for r in res]
    launched, tc = check_moe_serve_across(rep, ranks, MOE_SERVE)
    say_family_ranks("moe_serve_across_rank", ranks, smi,
                     ("grouped_matmul",))
    say("moe_serve_across", procs=FAMILY_PROCS, stages=FAMILY_PROCS,
        requests=len(rep["completions"]), tokens=rep["total_tokens"],
        tokens_identical=True, moe_dropped_mean=f"{rep['moe_dropped_mean']}",
        one_process_moe_dropped_mean=f"{MOE_SERVE['drop']}",
        tick_p50_ms=f"{_pct50(rep['tick_wall_s']) * 1e3:.1f}",
        one_process_tick_p50_ms=f"{MOE_SERVE['tick_p50'] * 1e3:.1f}",
        launches=json.dumps(launched).replace(" ", ""), card=repr(smi))
    out["moe_serve_across"] = (launched, tc)
    free_cuda(torch)
    return out


# ---------------------------------------------------------------------------
# phase 8: the dry run without a card, held against this card, and the
# scan attention's flash backward
# ---------------------------------------------------------------------------
# 4e's peak allocated when autograd differentiated the scan's loop (an
# H100 80GB HBM3 at 700 W)
MOE_PEAK_GB_BEFORE = 57.88
# 8c's tolerance: the flash backward's grads against autograd through the
# forward loop, both fp32, within this share of each leaf's largest entry
FLASH_BWD_TOL = 1e-5


def run_dryrun_phase():
    """8a: ``repro_torch.launch.dryrun --all`` over both meshes (80 cells:
    68 analysed, 12 skipped with the reference's reasons), then the
    counted probes of smollm-360m and mixtral-8x7b x train_4k at 16 x 16;
    nothing runs on the card."""
    import tempfile

    from repro_torch.launch import dryrun as DR
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for mp in (False, True):
            argv = ["--all", "--out", tmp, "--force"]
            res = DR.main(argv + (["--multi-pod"] if mp else []))
            name = "2x16x16" if mp else "16x16"
            summ = DR.summary(res, name)
            if (summ["cells"], summ["analysed"], summ["skipped"]) != (
                    40, 34, 6):
                raise AssertionError(f"dry run {name}: {summ}")
            say("dryrun", **{k: json.dumps(v).replace(" ", "")
                             for k, v in summ.items()})
            out[name] = summ
    for arch in ("smollm-360m", "mixtral-8x7b"):
        r = DR.run_cell(arch, "train_4k", probes=True, verbose=False)
        pr = r["probe"]
        if "error" in pr:
            raise AssertionError(f"probe {arch}: {pr['error']}")
        rl, an = pr["roofline"], r["roofline"]
        say("dryrun_probe", arch=arch, shape="train_4k", mesh="16x16",
            flops_per_step=f"{pr['flops_per_step']:.4e}",
            flops_per_step_T_real=f"{pr['flops_per_step_T_real']:.4e}",
            analytic_flops=f"{an['flops_per_chip']:.4e}",
            counted_bytes=f"{rl['hbm_bytes_per_chip']:.4e}",
            temp_gib=f"{pr['temp_bytes'] / 2 ** 30:.2f}",
            temp_micro_gib=f"{pr['per_micro']['peak_bytes'] / 2 ** 30:.3f}",
            peak_gib=f"{r['memory']['peak_bytes_per_chip'] / 2 ** 30:.2f}",
            fits_80GB=r["memory"]["fits_80GB"],
            t_compute_s=f"{rl['t_compute_s']:.4f}",
            t_memory_s=f"{rl['t_memory_s']:.4f}",
            t_collective_s=f"{rl['t_collective_s']:.4f}",
            bottleneck=rl["bottleneck"],
            kernels=json.dumps({k: f"{v['flops']:.3e}" for k, v in
                                pr["kernels"].items()}).replace(" ", ""))
        out[arch] = pr
    return out


def held_to_card(torch, label, argv, measured, smi):
    """8b for one configuration: the dry run's state bytes against
    ``memory_allocated``'s growth when the engine builds the state on the
    card, its counted FLOPs a step (every stage, ``m`` microbatches each)
    over the phase's measured steady step, and its temp peak (every stage,
    ``m`` microbatches' forwards, then the backward) beside the measured
    one."""
    from repro_torch.configs.base import DistConfig, get_config
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import roofline as RL
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.engine import ElasticEngine
    from repro_torch.launch.mesh import LogicalMesh
    from repro_torch.pipeline.pipeline import PipelineShapes
    spec = cli_spec("train", argv)
    p = spec.parallel
    cfg = get_config(spec.model.arch)
    dcfg = DistConfig(num_stages=p.stages, slot_slack=p.slot_slack,
                      remat=p.remat, param_dtype=p.param_dtype,
                      kernel_impl=p.kernel_impl)
    dyncfg = spec.dynamics.to_config()
    shapes = PipelineShapes.for_model(cfg, p.num_micro, p.mb_global, p.seq)
    # one card holds every stage buffer: a 1 x 1 mesh places nothing
    cell = DR.config_cell(cfg, dcfg, "train", shapes,
                          LogicalMesh(("data", "model"), (1, 1)), dyncfg)
    predicted = (SH.tree_bytes(cell.args[0]) + SH.tree_bytes(cell.args[1])
                 + SH.tree_bytes(cell.args[3]))
    free_cuda(torch)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    engine = ElasticEngine(cfg, dcfg, dyncfg, shapes, device="cuda")
    state = engine.init_state(spec.seed, with_opt=True)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    del state, engine
    free_cuda(torch)
    if abs(grown - predicted) > 0.01 * predicted:
        raise AssertionError(f"{label}: predicted state {predicted} B, "
                             f"memory_allocated grew {grown} B")
    # every stage buffer on this card, as the one-process step runs them,
    # scaled to the run's m microbatches
    step = DR.scale_probe(*DR.probe_step(cfg, dcfg, dyncfg, "train", shapes,
                                         stages=range(dcfg.num_stages)),
                          shapes.num_micro)
    flops, temp = step["flops"], step["peak_bytes"]
    step_s = measured["step_ms"] / 1e3
    peak = RL.peak_flops(dcfg.param_dtype)
    meas_temp = measured["peak_gb"] * 1e9 - predicted
    say("dryrun_card", config=label, state_predicted_b=predicted,
        state_allocated_b=grown,
        state_ratio=f"{grown / predicted:.5f}",
        temp_predicted_gb=f"{temp / 1e9:.3f}",
        peak_measured_gb=f"{measured['peak_gb']:.2f}",
        temp_measured_gb=f"{meas_temp / 1e9:.3f}",
        temp_ratio=f"{meas_temp / temp:.3f}",
        counted_flops_step=f"{flops:.4e}",
        step_ms=f"{measured['step_ms']:.1f}",
        tflops=f"{flops / step_s / 1e12:.2f}",
        peak_share=f"{flops / step_s / peak:.4f}",
        peak_tflops=f"{peak / 1e12:.0f}", card=repr(smi))
    return {"predicted": predicted, "grown": grown, "flops": flops,
            "temp": temp}


def flash_backward_at_moe_shape(torch):
    """8c: ``_FlashScan``'s dq / dk / dv at 4e's attention shape (b 2,
    s 1024, 32:8 heads, hd 128, window 4096, bf16 in) against autograd
    through the forward loop (the old path), both in fp32, and the peak
    memory of one forward + backward on each path in bf16."""
    from repro_torch.models import layers as L
    g = torch.Generator(device="cuda").manual_seed(0)
    b, s, hq, hkv, hd = 2, 1024, 32, 8, 128
    kw = dict(causal=True, sliding_window=4096, kv_block=512)
    q, k, v, dout = (torch.randn(shape, generator=g, device="cuda")
                     .to(torch.bfloat16) for shape in (
                         (b, s, hq, hd), (b, s, hkv, hd), (b, s, hkv, hd),
                         (b, s, hq, hd)))

    def old(q, k, v, bm, causal, sliding_window, kv_block):
        return L._flash_fwd_impl(q, k, v, bm, causal, sliding_window, 0,
                                 kv_block)[0]

    def new(q, k, v, bm, **kw):
        return L.flash_attention(q, k, v, impl="scan", block_mask=bm, **kw)

    held = {}

    def grads(fn, dtype, name=None):
        ts = [t.to(dtype).requires_grad_(True) for t in (q, k, v)]
        base = torch.cuda.memory_allocated()
        out = fn(*ts, None, **kw)
        if name is not None:
            # what the forward leaves for the backward (with the output):
            # what a stack of layers holds per attention call
            held[name] = torch.cuda.memory_allocated() - base
        out.backward(dout.to(out.dtype))
        return [t.grad for t in ts]

    errs = {}
    want = grads(old, torch.float32)
    got = grads(new, torch.float32)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        top = float(w.abs().max())
        err = float((a - w).abs().max())
        if not (torch.isfinite(a).all() and err <= FLASH_BWD_TOL * top):
            raise AssertionError(f"8c {name}: max err {err:.3e} over "
                                 f"{FLASH_BWD_TOL} x {top:.3e}")
        errs[name] = err / top
    del want, got
    peaks = {}
    for name, fn in (("old", old), ("new", new)):
        free_cuda(torch)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grads(fn, torch.bfloat16, name)
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() - base
    free_cuda(torch)
    say("flash_bwd", shape=repr((b, s, hq, hkv, hd)), window=4096,
        tol=FLASH_BWD_TOL,
        rel_err=json.dumps({k: f"{v:.2e}" for k, v in errs.items()})
        .replace(" ", ""),
        peak_old_mb=f"{peaks['old'] / 2 ** 20:.1f}",
        peak_new_mb=f"{peaks['new'] / 2 ** 20:.1f}",
        held_old_mb=f"{held['old'] / 2 ** 20:.1f}",
        held_new_mb=f"{held['new'] / 2 ** 20:.1f}",
        moe_peak_gb=f"{MOE_TRAIN['peak_gb']:.2f}",
        moe_peak_gb_before=MOE_PEAK_GB_BEFORE)
    if peaks["new"] >= peaks["old"] or held["new"] >= held["old"]:
        raise AssertionError(f"8c: the flash backward's peak {peaks} or "
                             f"held bytes {held} are not below the old "
                             f"path's")
    return errs, peaks, held


def np_equal(a, b) -> bool:
    import numpy as np
    return a.shape == b.shape and bool(np.array_equal(a, b))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false — this smoke test "
              "needs a CUDA card", flush=True)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"FAIL: {ROOT / 'src' / 'repro_torch'} not found — run "
              f"chip_smoke.py from the repository root", flush=True)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F
    torch.backends.cuda.matmul.allow_tf32 = False    # fp32 means fp32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say("device", nvidia_smi=repr(smi),
        name=repr(torch.cuda.get_device_name(0)),
        torch=torch.__version__, cuda=torch.version.cuda,
        count=torch.cuda.device_count())

    # 2. build
    from repro_torch import kernels
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    took = timed("2", _build.build, kernels.KERNELS)
    # each source's seconds to its own library (its units' to their own
    # exits): the slowest sets the build's wall
    sources = {k: round(v, 1) for k, v in took.items() if "." not in k}
    say("build", seconds=f"{time.perf_counter() - t0:.1f}",
        per_source=json.dumps(sources).replace(" ", ""),
        units=json.dumps({k: round(v, 1) for k, v in took.items()
                          if "." in k}).replace(" ", ""),
        slowest=max(sources, key=sources.get) if sources else "none",
        card=repr(smi))

    # 3. kernels vs plain versions
    results = {
        "block_sparse_attention": timed(
            "3", check_block_sparse_attention, torch, F),
        "pruned_matmul": timed("3", check_pruned_matmul, torch, F),
        "paged_attention": timed("3b", check_paged_attention, torch, F),
    }
    # 3c / 3d. the backward kernels
    results.update(timed("3c", check_attention_backward, torch, F))
    results["pruned_matmul"].update(
        timed("3d", check_pruned_matmul_backward, torch))
    # 3e. the grouped expert matmul and its weight gradient
    results.update(timed("3e", check_grouped_matmul, torch))
    # 3f. every kernel at the block families' shapes
    family_cases = timed("3f", check_family_kernels, torch, F)
    for name, r in results.items():
        extra = ({"bound_tf32x3_ms": f"{r['bound_tf32x3'][0]:.4f}"}
                 if "bound_tf32x3" in r else {})
        say("kernels", kernel=name, shape=repr(r["shape"]),
            ms=f"{r['ms']:.4f}", plain_ms=f"{r['plain_ms']:.4f}",
            library_ms=f"{r['library_ms']:.4f}",
            bound_ms=f"{r['bound'][0]:.4f}", bound_by=r["bound"][1],
            **extra)
    r = results["pruned_matmul"]
    say("kernels", kernel="pruned_matmul(backward dx+dw)",
        shape=repr(r["bwd_shape"]), ms=f"{r['bwd_ms']:.4f}",
        plain_ms=f"{r['bwd_plain_ms']:.4f}",
        library_ms=f"{r['bwd_library_ms']:.4f}",
        bound_ms=f"{r['bwd_bound'][0]:.4f}", bound_by=r["bwd_bound"][1],
        bound_tf32x3_ms=f"{r['bwd_bound_tf32x3'][0]:.4f}",
        pruned_keep=f"{r['bwd_pruned_keep']:.3f}",
        pruned_ms=f"{r['bwd_pruned_ms']:.4f}",
        pruned_bound_ms=f"{r['bwd_pruned_bound'][0]:.4f}")

    # 4. serve: the main path, counters zeroed just before, read just after
    from repro_torch.launch.serve import run as serve_run
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.KERNELS:
        k.reset()
    rep = timed("4", serve_run, serve_args(12))
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    tc = {k.name: k.launches_tc for k in kernels.KERNELS}
    # the serve spec's trace fields, and the seed the trace is drawn with
    args = {**rep["spec"]["serve"], "seed": rep["spec"]["seed"]}
    comps = rep["completions"]
    if len(comps) != args["requests"]:
        raise AssertionError(f"{len(comps)} of {args['requests']} requests "
                             f"completed")
    cache_len = args["prompt_len"] + args["gen"]
    from repro_torch.serve.requests import make_trace
    budget = {r.rid: min(r.gen, cache_len - r.plen + 1)
              for r in make_trace(args["requests"],
                                  prompt_len=args["prompt_len"],
                                  max_gen=args["gen"], vocab_size=49152,
                                  seed=args["seed"],
                                  min_prompt=args["prompt_len"] // 2)}
    for c in comps:
        if len(c["tokens"]) != budget[c["rid"]]:
            raise AssertionError(f"request {c['rid']}: {len(c['tokens'])} "
                                 f"tokens, budget {budget[c['rid']]}")
        if not all(0 <= t < 49152 for t in c["tokens"]):
            raise AssertionError(f"request {c['rid']}: token out of vocab")
    serve_path = ("block_sparse_attention", "pruned_matmul",
                  "paged_attention")
    missing = [n for n in serve_path if launches[n] <= 0]
    if missing:
        raise AssertionError(f"serve never launched {missing}: {launches}")
    from repro_torch.kernels.paged_attention import ops as pa_ops
    k6_split = pa_ops.KERNEL.launches_split
    check_k6_split(launches["paged_attention"], k6_split)
    check_tensor_core("serve", launches, tc, FP32_TC_PATH)
    say("serve", requests=len(comps), tokens=rep["total_tokens"],
        ticks=rep["ticks"], tokens_per_s=f"{rep['tokens_per_s']:.1f}",
        p50_ms=f"{rep['latency_p50_s'] * 1e3:.1f}",
        p95_ms=f"{rep['latency_p95_s'] * 1e3:.1f}",
        wall_s=f"{rep['wall_s']:.2f}",
        max_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        launches=json.dumps(launches).replace(" ", ""),
        k6_split_launches=k6_split,
        tiles_live=f"{rep['page_tile_live']}/{rep['page_tile_total']}")
    # phase 4m samples the same trace: its streams are held to these
    argmax_tokens = {c["rid"]: c["tokens"] for c in comps}
    argmax_rep = {k: rep[k] for k in ("tokens_per_s", "latency_p50_s",
                                      "latency_p95_s")}
    del rep, comps

    # 4b. where the time goes: a shorter serve under torch.profiler (its
    # wall includes the profiler's own overhead)
    prof = timed("4b", profile_serve, torch)
    say("profile", **prof)

    # 4c. train: the training path, counters zeroed just before, read
    # just after
    train_launches, train_bwd = timed("4c", run_train_phase, torch, kernels)
    train_tc = {k.name: k.launches_tc for k in kernels.KERNELS}
    check_tensor_core("train", train_launches, train_tc, FP32_TC_PATH)
    for k in kernels.KERNELS:
        tc[k.name] += k.launches_tc

    # 4d. where the time goes in training: two steps under the profiler
    say("profile_train", **timed("4d", profile_train, torch))

    # 4e / 4f. the MoE paths, counters zeroed just before each and read
    # just after
    moe_train_launches = timed("4e", run_moe_train_phase, torch, kernels)
    for k in kernels.KERNELS:
        tc[k.name] += k.launches_tc
    moe_serve_launches = timed("4f", run_moe_serve_phase, torch, kernels)
    for k in kernels.KERNELS:
        tc[k.name] += k.launches_tc

    # 4g. where the time goes in MoE training
    say("profile_moe_train", **timed("4g", profile_train, torch,
                                     moe_train_args))

    # 4h / 4i / 4j. live resizes in training and serving, early exit and
    # MoD: counters zeroed just before each path and read just after
    elastic_train_launches = timed("4h", run_elastic_train_phase, torch,
                                   kernels)
    for k in kernels.KERNELS:
        tc[k.name] += k.launches_tc
    elastic_serve_launches = timed("4i", run_elastic_serve_phase, torch,
                                   kernels)
    for k in kernels.KERNELS:
        tc[k.name] += k.launches_tc
    ee_train_launches = timed("4j", run_ee_train_phase, torch, kernels)
    for k in kernels.KERNELS:
        tc[k.name] += k.launches_tc
    ee_serve_launches = timed("4j", run_ee_serve_phase, torch, kernels)
    for k in kernels.KERNELS:
        tc[k.name] += k.launches_tc

    # 4k / 4l. safe points and resume; async control plane and stage
    # timing: counters zeroed just before each path and read just after
    ckpt_launches = timed("4k", run_ckpt_phase, torch, kernels)
    for n in ckpt_launches:
        tc[n] += ckpt_launches[n]      # every launch checked on the TCs
    ctl_launches = timed("4l", run_ctl_phase, torch, kernels)
    for n in ctl_launches:
        tc[n] += ctl_launches[n]

    # 4m / 4n / 4o / 4p / 4q. sampling, autoscaled training over the file
    # RPC (its third run under RPC chaos), autoscaled serving, two tenants
    # on one HTTP manager and the front door (configs, Session, the
    # one-shot serve, the scenarios): counters zeroed just before each path
    # and read just after (4p: read in its two processes)
    new_phases = {}
    for ph, key, phase in (
            ("4m", "sample_serve", lambda: run_sampling_serve_phase(
                torch, kernels, argmax_tokens, argmax_rep)),
            ("4n", "autoscale_train", lambda: run_autoscale_train_phase(
                torch, kernels)),
            ("4o", "autoscale_serve", lambda: run_autoscale_serve_phase(
                torch, kernels)),
            ("4p", "tenants", lambda: run_two_tenant_phase(torch, kernels)),
            ("4q", "api", lambda: run_front_door_phase(torch, kernels,
                                                       argmax_tokens))):
        got, got_tc = timed(ph, phase)
        new_phases[key] = got
        for n in got_tc:
            tc[n] += got_tc[n]
    # 4r. a worker crash in training and in serving: each path's counters
    # zeroed just before it and read just after
    got, got_tc = timed("4r", run_fault_phase, torch, kernels)
    new_phases.update(got)
    for n in got_tc:
        tc[n] += got_tc[n]
    # 6a-6d. the remaining block families: whisper-large-v3 trained at full
    # size (the slice's main path), zamba2, xLSTM, InternVL2; counters
    # zeroed just before each path and read just after
    for ph, key, phase in (("6a", "whisper", run_whisper_phase),
                           ("6b", "zamba2", run_zamba2_phase),
                           ("6c", "xlstm", run_xlstm_phase),
                           ("6d", "internvl2", run_internvl2_phase)):
        got, got_tc = timed(ph, phase, torch, kernels)
        new_phases[key] = got
        for n in got_tc:
            tc[n] += got_tc[n]

    # 7b-7g. one process per pipeline stage: full-width smollm trained
    # with a shrink and a grow across ranks and served (one-shot and
    # elastic, paged) as 4 ranks, 4 ranks against one process at 8 layers
    # (inline and asynchronous), safe points, chaos and a kill across
    # ranks (each part's counters zeroed in the ranks just before it and
    # read just after)
    for key, (got, got_tc) in run_across_phases(torch, kernels,
                                                 smi).items():
        new_phases[key] = got
        for n in got_tc:
            tc[n] += got_tc[n]
    # 7h-7j. the block families across 2 ranks, after phase 7's launch has
    # exited: Mixtral trained with its live re-layout (K4 and K5 in each
    # rank), zamba2 trained through a migration across the ranks, the MoE
    # elastic serve at 2 stages (each part's counters zeroed in the ranks
    # just before it and read just after)
    for key, (got, got_tc) in run_family_ranks(torch, kernels,
                                                smi).items():
        new_phases[key] = got
        for n in got_tc:
            tc[n] += got_tc[n]

    # 5. parity of the path: kernels vs plain versions from one state
    timed("5", serve_parity, torch)

    # 5b. train parity: one step's loss and grads, kernels vs plain
    timed("5b", train_parity, torch)

    # 5c. the MoE path: train step, prefill + decode, placement neutrality
    timed("5c", train_parity, torch, moe=True)
    timed("5c", train_parity, torch, moe=True, param_dtype="bfloat16")
    timed("5c", serve_parity, torch, moe=True)
    timed("5c", moe_placement_neutrality, torch)
    timed("5c", moe_placement_neutrality, torch, torch.bfloat16)

    # 5d. early exit and MoD: a train step (all 32 layers: at 4 the
    # random-weight blocks stay too far from the identity for a token to
    # exit) and a prefill + decode with early exit, kernels vs plain
    # versions; MoD bitwise the none step
    timed("5d", train_parity, torch, kind="early_exit", layers=32)
    # ... and at a threshold where exited and live tokens sit side by side
    # from layer 22 on and some never exit
    timed("5d", train_parity, torch, kind="early_exit", layers=32,
          ee_threshold=EE_MIXED_THRESHOLD)
    timed("5d", mod_bitwise, torch)
    timed("5d", serve_parity, torch, kind="early_exit")

    # 8a-8c. the dry run over every cell without the card, its state
    # bytes, FLOPs and temp held against 4c's and 4e's runs on this card,
    # and the scan attention's flash backward at Mixtral's shape
    timed("8:8a", run_dryrun_phase)
    timed("8:8b", held_to_card, torch, "4c", train_args(), TRAIN_4C, smi)
    timed("8:8b", held_to_card, torch, "4e", moe_train_args(), MOE_TRAIN,
          smi)
    timed("8:8c", flash_backward_at_moe_shape, torch)

    # 9. the kernels line, the card line, the last line
    line = []
    for k in kernels.KERNELS:
        r = results[k.name]
        entry = {
            "name": k.name, "route": "cuda", "source": k.relpath(),
            "replaces": k.replaces, "tpu_kernel": k.replaces,
            "launches": (launches[k.name] + train_launches[k.name]
                         + moe_train_launches[k.name]
                         + moe_serve_launches[k.name]
                         + elastic_train_launches[k.name]
                         + elastic_serve_launches[k.name]
                         + ee_train_launches[k.name]
                         + ee_serve_launches[k.name]
                         + ckpt_launches[k.name] + ctl_launches[k.name]
                         + sum(v.get(k.name, 0)
                               for v in new_phases.values())),
            "launches_tc": tc[k.name],
            "launches_serve": launches[k.name],
            "launches_train": train_launches[k.name],
            "launches_moe_train": moe_train_launches[k.name],
            "launches_moe_serve": moe_serve_launches[k.name],
            "launches_elastic_train": elastic_train_launches[k.name],
            "launches_elastic_serve": elastic_serve_launches[k.name],
            "launches_ee_train": ee_train_launches[k.name],
            "launches_ee_serve": ee_serve_launches[k.name],
            "launches_ckpt_train": ckpt_launches[k.name],
            "launches_ctl_train": ctl_launches[k.name],
            **{f"launches_{key}": v.get(k.name, 0)
               for key, v in new_phases.items()},
            "max_abs_err": r["max_abs_err"], "max_err": r["max_abs_err"],
            "tolerance": r["tol"], "ms": r["ms"], "kernel_ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
            "shape": r["shape"]}
        for key in ("library_covers", "cases", "timing"):
            if key in r:
                entry[key] = r[key]
        if k.name in family_cases:
            entry["family_cases"] = family_cases[k.name]
        if "bound_tf32x3" in r:
            entry["bound_tf32x3_ms"] = r["bound_tf32x3"][0]
        if k.name == "paged_attention":
            entry["launches_split"] = k6_split
        if k.name == "pruned_matmul":
            entry.update(
                bwd_bound_tf32x3_ms=r["bwd_bound_tf32x3"][0],
                launches_train_bwd=train_bwd, bwd_ms=r["bwd_ms"],
                bwd_plain_ms=r["bwd_plain_ms"],
                bwd_library_ms=r["bwd_library_ms"],
                bwd_bound_ms=r["bwd_bound"][0],
                bwd_bound_by=r["bwd_bound"][1],
                bwd_max_abs_err=r["bwd_max_abs_err"],
                bwd_pruned_ms=r["bwd_pruned_ms"],
                bwd_pruned_bound_ms=r["bwd_pruned_bound"][0],
                bwd_shape=r["bwd_shape"])
        line.append(entry)
    total = time.perf_counter() - t_start
    say("done", seconds=f"{total:.1f}")
    print("[phase_seconds] " + json.dumps(
        {"total": round(total, 1),
         **{k: round(v, 1) for k, v in PHASE_SECONDS.items()}}), flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--k6-time":
        sys.exit(k6_time_only(sys.argv[2]))
    sys.exit(main())
