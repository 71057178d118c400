#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py        # one card

Phases, one summary line each:
  1. device   — the card's name and power limit, then the kernels' build;
  2. kernels  — each Hopper kernel against its plain PyTorch version on the
                card, at the main path's shapes and at edge shapes (integer
                outputs bitwise; attention within ATOL + RTOL*|ref| in
                float32, TF32 off, for every cluster split of the pages),
                with its device time per call (CUDA events, median of
                LAUNCHES graph replays, see time_ms; attention and its SDPA
                yardstick cold in L2, rotating over COLD_SETS input sets,
                with the warm figure printed beside), its bound, the plain
                version's and one library call's device time, and the host's
                wall time per eager call; the sketch update and histogram
                also at D=2, S=16 and W=16K and the paper's W=512K, cold
                (rotating over SKETCH_SETS input sets) and warm, the
                histogram also on rows shaped like the main path's; and
                update, mark and histogram at the simulator's blocks
                (S=2048 at W=16K, S=16384 at W=512K), bitwise and timed;
                attention also at kimi-k2's group of 8 query heads per kv
                head (PHASE moe's two ring shapes) and at PHASE dense's
                paged-arm ring (B 2, P 6, T 8) for stablelm-1.6b (group 1,
                dk 64), qwen1.5-4b (20 heads, group 1), gemma2-27b (group
                2, softcap 50, scale 144^-1/2) and llama-3.2-vision-11b
                (group 4: 32 heads over 8 kv heads), at zamba2-2.7b's
                shared-attention ring (group 1, 32 heads, dk = dv = 80) at
                PHASE ssm's two ring shapes (B 2, P 6, T 8 and B 4, P 8,
                T 16), checked and timed, and
                at deepseek-v3's MLA shape (128 query heads over one latent
                head, dk 576, dv 512: the head-tiled kernel; its registers
                and spills read from the build log) at edge shapes (some
                with +-1e30 in the K and V rows past the page lengths, one
                with 128-token pages) and at PHASE mla's two ring shapes,
                PHASE main's (also with every page masked: the fixed cost)
                and a 4,096-token context (B 8, P 64, T 64; held to the
                plain version one batch row at a time, whose time is not
                taken), checked and timed with its bound (bytes, or flops
                at the TF32 tensor-core rate) and SDPA's enable_gqa call,
                and the cluster size the launch takes at each timed shape
                with the clusters of each size that fit at once;
                the sketch kernels' library calls (index_put_ accumulate,
                out-of-place index_put, bucketize + bincount) at every
                shape they are timed at;
  2'. dist    — the distribution layer (repro_torch.dist, launch/mesh.py),
                right after PHASE kernels, while the card and the host hold
                no model yet (its pinned master vectors take 36 GiB of the
                machine's 96), in a process group of one rank over NCCL (a
                HashStore in process: no address) and its ("data",
                "model") 1 x 1 mesh, destroyed at the phase's end: (a)
                llama3.2-3b at full width and depth, DIST_STEPS steps of
                ZeRO-1 with its int8 delta, offload_master, local_grads and
                fsdp without a mesh and over the mesh from the same weights,
                deterministic algorithms on, the mesh arm partitioned over
                its one 'model' rank (the dense decoders' tensor-parallel
                forms): losses, gradient norms and params bitwise equal, m,
                v and ef pinned host tensors between steps over the mesh;
                prints the leaves computed split over 'model' and those
                gathered whole (none), the device-resident GiB
                between steps, each arm's peak and each step's fetch of the
                master vectors on the side stream (CUDA events: ms, the part
                before the update reached it, the stall); (b) its paged
                decode with the ring's slots split over both axes and the
                params partitioned over 'model' (``layout``) against the
                unsharded ring (B 4, 16 greedy steps): tokens equal,
                logits within 1e-3, page mass within 1e-5, pages, page_len
                and cur_slot bitwise (the attention launches counted); (c)
                kimi-k2 and deepseek-v3 at their smoke configs: one float32
                train step over the mesh, partitioned over 'model'
                (attention, dense prologue, shared expert, embedding and
                head, deepseek-v3's MTP head; the leaves split and gathered
                printed, none gathered) with the experts expert-parallel,
                deepseek-v3 under Adafactor's block update, against the
                CPU (loss within ATOL + RTOL*|ref|, router stream equal,
                sketch bitwise a CPU replay; the update and mark launches
                counted and required) and one ServeEngine(ep_axes=)
                request against the CPU engine fed its tokens; (d) right
                after (a), before any other model is drawn: deepseek-v3
                and kimi-k2 at full width and PHASE mla's and moe's depth
                (4 and 2, every expert on the card), each partitioned over
                the one 'model' rank with its experts expert-parallel and
                its ring's slots split over both axes, B 4, an 8-token
                prefill_paged and 16 greedy decode_step_paged steps
                against the meshless calls from the same weights: tokens
                equal, logits within 1e-3, page mass within 1e-5, every
                ring's pages, page_len and cur_slot bitwise; then a
                dense-cache arm (prefill_dense and greedy decode_step steps,
                the cache's sequence split over 'model', each block's core
                over the rank's block of it: tokens equal, logits within
                1e-3, every cache leaf bitwise); prints the leaves split
                and gathered, the attention-cache leaves attended split
                and gathered whole (none), and each arm's attention
                launches (head-tiled for deepseek-v3, grouped for
                kimi-k2); (e) then zamba2-2.7b and xlstm-1.3b at full width
                and PHASE ssm's depth (SSM_DEPTH), each partitioned over the
                one 'model' rank (the Mamba2, mLSTM and sLSTM mixers,
                zamba2's shared attention block, the embedding and head),
                the same prefill and greedy steps with deterministic
                algorithms on: tokens equal, logits and page mass 0 apart,
                every ring's pages and every recurrent state bitwise the
                meshless calls', then (d)'s dense-cache arm, bitwise;
                prints the leaves split and gathered, the attention-cache
                leaves attended split and gathered whole, and zamba2's
                grouped attention launches; (f) then
                llama-3.2-vision-11b (depth cut to 10: two cross blocks)
                and whisper-base (whole) at full width, each cross gate at
                0.5, partitioned over the one 'model' rank (self and cross
                attention, the cross step's projection of every patch or
                frame, MLPs, whisper's encoder, embedding and head) with
                deterministic algorithms on, over seeded aux embeddings:
                the dense-cache arm of (d) (whisper encoded first, its
                encoder output bitwise) and the paged arm of (e), tokens
                equal, logits 0 apart, every cache leaf and ring bitwise
                the meshless calls', grouped attention launches equal
                between the arms; (d)-(f) raise if a dense arm gathered an
                attention-cache leaf whole or attended none split;
  3. main     — ServeEngine on llama3.2-3b at full width (random weights
                from a seed) serving a batch of 4 random 1024-token prompts
                for 64 greedy tokens through the NeoMem loop; every kernel
                must have launched, logits finite, page mass summing to 1,
                migration and flush bytes > 0, and the sketch must replay
                bitwise through the plain CPU sketch; then 8 more decode
                steps under torch.profiler give the device's busy share,
                its launches per step, the kernels that fill it and paged
                attention's share, and
                decode steps alternate swiglu's activation between F.silu
                and the reference's op-by-op formula to time the two on
                one host;
  4. lanes    — the unified Scheduler over 4 continuous-batching lanes of
                the same model (traffic_bench.py's SERVE_KW shape at full
                width, the embeddings resource read in-step through its
                placement table) serving a seeded two-tenant zipf-hot mmpp
                trace to completion through all four kernels; every request
                must finish with its max_new tokens, the report must add
                up, a request must have been preempted and resumed, bytes
                must have moved for both resources, every step's logits
                must be finite and its active lanes' page mass sum to 1,
                both sketches must replay bitwise through the plain CPU
                sketch, and the schedule (steps, preemptions, each
                request's admission and finish) must equal the same trace's
                on the CPU at the smoke config;
  5. reuse    — traffic_bench.py's kv_reuse arm at full width: an agentic
                multi-turn trace over 4 lanes with the content-addressed KV
                pool (32 pages, substring matching, 8-token chunks) and
                every slow store int8 at rest, greedy; sampled int8 rows
                must equal their CPU encoding bitwise, every byte meter be
                whole wire rows (N + 4 B), the pool must hit and its
                refcounts drain, the logits, page mass and sketches pass
                as in PHASE lanes, and the schedule and reuse counters
                equal the CPU run's at the smoke config;
  6. disagg   — traffic_bench.py's disagg arm at full width: a prefill
                worker engine attached to a 2-lane decode engine serving a
                prefill-heavy mmpp trace, sampled at temperature 0.8 and
                top-p 0.9 on the card; every draw is recomputed on the CPU
                (keys and threefry bits bitwise, tokens equal except at a
                near-tie within 1e-5), no hand-off install may be refused,
                and the schedule and hand-offs must equal the CPU run's at
                the smoke config;
  7. fill     — ServeConfig.kv_mass_source="fill" at full width: one
                request (2 x 30 prompt tokens, 16 new) and the lane phase's
                configuration without embeddings over a 16-step cut of its
                trace, the kv stream fed each page's fill and no page mass
                exported; the kv integers (reads, promotions, rows migrated
                and flushed, placement table, θ trace) and the lane schedule
                must equal the CPU run's at the smoke config;
  8. dense    — the dense-cache serving mode (ServeConfig's default,
                paged=False) on llama3.2-3b (PHASE main's params),
                qwen1.5-4b, stablelm-1.6b and gemma2-27b at full width and
                depth (each drawn after the previous one is released), in
                two arms each: the full cache, then the paged ring
                (serve_bench.py's llama case, page_t 8, 6 hot slots) fed the
                dense arm's tokens, 2 x 32 prompt tokens and 16 greedy ones
                with the embeddings resource; the two arms' logits must
                agree within DECODE_PARITY at every step, their greedy picks
                but at near-ties (printed), the logits be finite (within the
                final softcap on gemma2), the dense arm launch the sketch
                kernels and no attention kernel, the ring's page mass sum
                to 1 and the embeddings sketch replay bitwise on the CPU;
                prints wall, prefill s, tokens/s, ms per step, peak memory
                per arm and a 4-step profile of the dense arm (busy share,
                launches a step, the plain dense attention's ms a step);
  9. ssm      — zamba2-2.7b (its depth cut from 54 to 18 layers: 15
                Mamba2 blocks and one shared attention block used at 3
                positions) and xlstm-1.3b (cut from 48 to 16: 14 mLSTM and
                2 sLSTM blocks, no attention) at full width (SSM_DEPTH), each
                drawn after the previous one is released: (c) one block of
                each recurrent kind at full width, SSM_LAYER_STEPS float32
                steps on the card against the CPU within ATOL + RTOL*|ref|;
                (a) PHASE dense's two arms with its checks, the paged arm
                launching the attention kernel only on zamba2 (xlstm's two
                arms bitwise equal, its kv resource never read); (b) the
                lane phase's drive over a cut of its trace (SSM_LANE_TRACE,
                PHASE fill's 16 arrival steps: 66 scheduler steps, the
                shortest cut that preempts and reuses a lane): the lane
                phase's checks, a preempted request's recurrent states bitwise
                after its resume, a lane serving a second request, the
                schedule equal to the CPU run at the arch's smoke config;
                prints per arm and arch the figures of PHASE dense (the
                profile's range around the recurrent blocks), each
                preemption's and resume's ms and the lanes' serving lines;
  10. cross   — llama-3.2-vision-11b (40 layers, a gated cross block every
                fifth over 1,601 patch embeddings) and whisper-base (a
                6-layer bidirectional encoder over 1,500 frame embeddings,
                6 dec blocks of self and cross attention) at full width and
                depth, each drawn after the previous one is released, the
                request's aux embeddings standard normal from seed 0: (c)
                the first cross or dec block at full width in float32,
                CROSS_LAYER_STEPS steps on the card against the CPU within
                ATOL + RTOL*|ref| (llama-3.2-vision's gate at CROSS_GATE, so
                that the image counts), and whisper's whole encoder;
                (a) llama-3.2-vision through PHASE dense's two arms and
                checks with the reference's init (gates at 0, so the paged
                arm, which has no cross step as the reference's has none,
                ROADMAP C6, serves the same logits); whisper's dense arm
                with PHASE dense's checks, then the same request on the CPU
                fed its tokens: the encoder's output and every step's logits
                within DECODE_PARITY, greedy picks equal but at near-ties;
                prints per arch and arm the figures of PHASE dense (the
                profile's range around the cross step);
  11. moe     — kimi-k2 at full width (d 7168, 64/8 heads, 384 experts
                top-8, vocab 163840), its depth cut to one dense prologue
                layer and one MoE layer (MOE_DEPTH), with the experts and
                embeddings resources: serve_bench.py's kimi-k2 case (2 x 16
                prompt tokens, 16 new, 96 of 384 experts on the card), then
                the lane phase's configuration over PHASE fill's 16-step cut
                of its trace; every kernel must launch in each, logits be
                finite and page mass sum to 1, router ids be experts or -1,
                the kv and embeddings sketches replay bitwise on the CPU,
                the experts' feed replay through a CPU daemon to the same
                promotion batches, placement table, θ trace and sketch, the
                bytes moved be those rows x 88,080,384 B, every resident
                expert's fast row equal its slow row, the MoE layer read
                through the tier agree with the dense one (MOE_TOL), and the
                lane schedule equal the CPU run's at the smoke config;
                prints wall, tokens/s, ms per step, hit rates and bytes, ms
                per slow expert row, a profile of 4 steps and the card's
                peak memory and pinned host bytes; then the dense arm of the
                single request (paged=False, experts and embeddings, built
                once the lane engine's pinned store is released): no
                attention launch, the embeddings sketch replayed bitwise and
                the experts' feed through a CPU daemon;
  11'. async  — inside PHASE moe, on its weights: the asynchronous data
                plane (DESIGN.md §15; epoch copies on a side CUDA stream, a
                CUDA event as the commit token) and the tiering checkpoint.
                (a) moe's single request with async_migration=True after
                its synchronous arm: tokens bitwise the synchronous arm's,
                finite logits and unit page mass every step, the daemon
                tick of every epoch's issue and commit recorded (commits
                at the first tick after the issue counted against deferred
                ones), no byte in flight after finalize, all three
                resources' feeds replayed through a CPU daemon committing
                at the recorded ticks (promotion batches, placement tables,
                θ traces, sketches, bytes and epochs equal), flush bytes
                equal to the synchronous arm's, resident expert rows equal
                their slow rows; per arm ms a step, tokens/s, stall_s and
                overlap bytes per decode second per resource, peak memory
                and a 4-step profile; (b) the lane configuration over a
                32-step cut of the lane trace (ASYNC_TRACE: the 16-step
                cut's one preemption lands between epochs) on both planes:
                every request's tokens equal, (a)'s replay, the schedule
                equal to the CPU run at the smoke config with async on, at
                least one preemption and one resume landing mid-epoch
                (counted); (c) on (a)'s engine save_tiering, 4 more steps,
                load_tiering: every resource's state bitwise the saved
                one, no epoch in flight, resident expert rows equal their
                slow rows, the refill's ms printed; (d) the side stream's
                hazards: 48 rows of 32 MB through HAZARD_TICKS epochs on each plane,
                a write and a copy landing during each epoch's copies,
                every tick's reads equal on the two planes;
  12. mla     — deepseek-v3 at full width (d 7168, 128 heads, MLA
                q_lora 1536 / kv_lora 512 / d_nope 128 / d_rope 64 / d_v
                128, 256 experts top-8, vocab 129280), its depth cut to its
                3 dense prologue layers and its first MoE layer (MLA_DEPTH),
                through PHASE moe's drives and checks with 64 of 256 experts
                on the card (its dense arm on mla_decode); every attention
                launch of the phase must be the head-tiled kernel's;
  12'. train  — the train step (train/step.py), after PHASE mla: (a)
                llama3.2-3b at full width and depth (3.213 B, bf16, seed
                0), AdamW, 2 strided microbatches of 2 x 1,024 SyntheticLM
                tokens, remat, TRAIN_STEPS steps: every loss and gradient
                norm finite, the last 3 steps' mean loss below the first
                3's, the parameters moved; prints ms a step, tokens/s, peak
                memory and the model FLOP/s share of the bf16 dense peak,
                then a profile of TRAIN_PROFILED steps (busy share,
                launches, the plain float32 attention's ms a step); (b) one
                float32 step of each of the ten archs at its smoke config
                (TRAIN_FAMILIES: AdamW, Adafactor, ZeRO-1 with and without
                its int8 delta and with offload_master, gradient
                compression, 2 microbatches, remat off, the cross gate at
                0.5, whisper's encoder) on the card against the CPU: loss, gradient norm
                and every updated leaf within ATOL + RTOL*|ref|, kimi-k2's
                and deepseek-v3's router streams equal to the CPU's and
                their in-step sketches bitwise a CPU replay of the card's
                stream (the update and mark kernels' launches are the
                phase's); (c) one full-width block of each training-only
                form (Mamba2, mLSTM, sLSTM, MLA) forward and backward over
                256 positions at chunk 128 on the card against the CPU,
                every gradient within ATOL*max(1, max|ref|) + RTOL*|ref|,
                and each of six blocks (Mamba2, mLSTM, sLSTM,
                deepseek-v3's MLA, llama-vision's gated cross block over
                its 1,601 patches, whisper's encoder block) through its
                partitioned form over a one-rank Part (a world of one rank
                over NCCL), its output and every gradient bitwise the
                unpartitioned block's;
  13. sim     — the paper's evaluation path: fig11_main_speedup.py's grid
                (8 workloads x 6 methods, benchmarks/common.py's scale, its
                240 blocks cut to 64)
                through the port's tiering simulator on the card, every
                result (counts, θ and error traces exactly; modeled runtime
                and bandwidth trace within SIM_RUNTIME_RTOL / SIM_BW_ATOL)
                equal to a CPU run of the port on the same blocks; prints
                the modeled geomean speedups, neomem's hit rates and the
                card's wall ms per block;
  14. sim-paper — gups at the paper's scale (4M pages, W=512K, blocks of
                16384) through all six methods on the card: hits must sum
                to the accesses, promotions stay within the quota, and
                neomem's sketch over the last PAPER_REPLAY blocks of its
                last clear interval (recorded in a second neomem run, equal
                to the timed one) must replay bitwise on the CPU from the
                sketch before them; prints ms per block, a profile of 16
                neomem blocks (device busy share, top kernels) and the
                cost of the sketch's O(S^2) first-occurrence dedup;
  15. examples — the four example twins (examples/*_torch.py) on the card
                through their main: (a) quickstart (8,192 pages, 128 steps)
                and profile_embeddings (256,000-row vocabulary, 96 steps of
                4,096 zipf tokens) at their own sizes, every integer (the
                printed records, placement tables, θ trace, counts) equal
                to a CPU run of the same twin; (b) serve_longctx at the
                reference's smoke shape (llama3.2-3b-smoke: the grouped
                attention kernel at group 2, dk 16, checked and timed in
                PHASE kernels), the kv and embeddings resources' feed
                replayed on the CPU (replay_feed); (c) train_tiered_moe at
                the reference's ~100M-parameter MoE CFG, batch 8, sequence
                256, EXAMPLE_STEPS steps: losses finite and falling, the
                router streams replayed through the twin's experts resource
                on the CPU, the step-EXAMPLE_CKPT checkpoint restored
                bitwise.
The line before the last is a JSON object with every kernel's numbers (its
launches in PHASE main, the head-tiled attention kernel's in PHASE mla, and
per phase, PHASE async's apart from moe's: the simulator phases launch no
attention); the last line is
{"ok": true, "device": {...}}.  Any failure
raises (exit != 0) and prints no result; with no CUDA device the script
exits 2.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

LAUNCHES = 100          # timed calls per measurement (median reported)
SPIN_CYCLES = 1 << 26   # card clock cycles the timed calls queue behind
ATOL, RTOL = 1e-4, 1e-4  # attention kernel vs plain version, float32
MLA_SCALE = (128 + 64) ** -0.5   # deepseek-v3's softmax scale, (d_nope + d_rope)^-1/2
COLD_SETS = 6           # attention input sets rotated through (101 MB of K/V > L2)
SKETCH_SETS = 24        # sketch input sets rotated through (151 MB at W=512K > L2)
PAPER_W = 1 << 19       # the paper's sketch width (Table III: W=512K, D=2)
# PHASE lanes: traffic_bench.py's SERVE_KW shape at llama3.2-3b full width
# (4 lanes, 6 KV segments, the embeddings resource; 128256 / 64 = 2004 vocab
# pages), a two-tenant zipf-hot mmpp trace cut from 48 to 32 arrival steps
# (95 scheduler steps against 113, two preemptions), 32-token prefill chunks
LANE_SERVE = dict(max_seq=256, paged=True, page_t=16, hot_slots=8,
                  migration_interval=8, resources=["embeddings"],
                  embed_hot_slots=64, embed_quota=64, kv_quota=16,
                  kv_tier_slots=16, kv_mass_threshold=0.01, lanes=4,
                  kv_segments=6)
LANE_SCHED = dict(prefill_chunk=32, preempt_patience=4)
LANE_TENANTS = (("interactive", 2.0, 0.22, (16, 49), (8, 33)),
                ("batch", 1.0, 0.12, (64, 161), (16, 49)))
LANE_TRACE = dict(kind="zipf-hot", n_steps=32, seed=0, arrival="mmpp")
# PHASE reuse: traffic_bench.py's kv_reuse arm (SERVE_KW, REUSE_TENANTS,
# REUSE_TRACE_KW, REUSE_PAGES, REUSE_CHUNK, REUSE_STEPS) at full width, the
# slow stores int8 at rest, greedy
REUSE_SERVE = dict(max_seq=64, paged=True, page_t=4, hot_slots=6,
                   migration_interval=4, resources=["embeddings"],
                   embed_hot_slots=6, embed_quota=8, embed_rows_per_page=8,
                   kv_quota=16, kv_tier_slots=12, kv_mass_threshold=0.01,
                   lanes=4, kv_segments=6, reuse_pages=32, slow_codec="int8")
REUSE_SCHED = dict(preempt_patience=24, seed=0, prefill_chunk=8,
                   reuse_match="substring")
REUSE_TENANTS = (("agent-a", 1.0, 0.2, (3, 6), (3, 5)),
                 ("agent-b", 1.0, 0.2, (3, 6), (3, 5)))
REUSE_TRACE = dict(kind="agentic", n_steps=224, seed=0, turn_gap=16, sys_len=12,
                   n_convs=2, work_len=4, max_total=56)
# PHASE disagg: traffic_bench.py's disagg arm (DISAGG_KW, 3 lanes of which
# 1 prefills, 6 segments, 16-token chunks) at full width over a prefill-heavy
# mmpp trace cut from DISAGG_STEPS = 240 to 50 arrival steps (97 scheduler
# steps, 16 hand-offs, two preemptions), sampled at temperature 0.8, top-p 0.9
DISAGG_SERVE = dict(max_seq=56, paged=True, page_t=4, hot_slots=6,
                    migration_interval=4, kv_quota=16, kv_tier_slots=12,
                    kv_mass_threshold=0.01, lanes=2, kv_segments=6)
DISAGG_SCHED = dict(preempt_patience=24, seed=0, prefill_chunk=16,
                    prefill_lanes=1, temperature=0.8, top_p=0.9)
DISAGG_TRACE = dict(kind="prefill-heavy", n_steps=50, seed=0, arrival="mmpp")
# PHASE fill: ServeConfig.kv_mass_source="fill" at full width, the kv stream
# fed each ring page's fill and the attention kernel's mass export off: one
# request of 2 x 30 prompt tokens and 16 new ones (test_torch_sched.py's
# single-request shape, kv alone), then the lane phase's configuration
# without the embeddings resource over a 16-step cut of its trace.  No kv
# decision reads a token's value, so every integer is the CPU's at the smoke
# config.
FILL_SINGLE = dict(paged=True, page_t=4, hot_slots=6, migration_interval=4,
                   kv_quota=16, max_seq=64, kv_mass_source="fill")
FILL_PROMPT = (2, 30, 16)          # batch, prompt tokens, new tokens
FILL_LANES = dict(LANE_SERVE, resources=[], kv_mass_source="fill")
FILL_TRACE = dict(LANE_TRACE, n_steps=16)
# PHASE moe: kimi-k2 at full width, depth cut to 1 dense prologue layer and
# 1 MoE layer (the 384 experts of one layer are 33.8 GB in bf16; a second
# MoE layer would not leave the fast tier room on the card), with the
# experts and embeddings resources.  (a) benchmarks/serve_bench.py's kimi-k2
# case, its 2 of 8 hot experts scaled to 96 of 384; (b) the lane phase's
# configuration over PHASE fill's 16-step cut of its trace.
MOE_DEPTH = 2
MOE_SINGLE = dict(max_seq=256, paged=True, page_t=8, hot_slots=6,
                  migration_interval=4, resources=["experts", "embeddings"],
                  expert_hot_slots=96, expert_quota=32, embed_hot_slots=2)
MOE_PROMPT = (2, 16, 16)           # batch, prompt tokens, new tokens
MOE_LANES = dict(LANE_SERVE, resources=["experts", "embeddings"],
                 expert_hot_slots=96, expert_quota=32)
MOE_TRACE = FILL_TRACE
# PHASE async: (a) PHASE moe (a) on the asynchronous plane; (b) the lane
# configuration over a 32-step cut of the lane trace, on both planes: the
# 16-step cut's one preemption falls at a tick where no epoch is in flight,
# this cut's first preemption and resume land mid-epoch
ASYNC_TRACE = dict(LANE_TRACE, n_steps=32)
# (d): 48 rows of 32 MB (bf16), HAZARD_TICKS epochs on each plane
HAZARD_SHAPE = (48, 4, 1 << 22)
HAZARD_TICKS = 8
# PHASE mla: deepseek-v3 at full width (MLA attention, 256 experts top-8),
# depth cut to its 3 dense prologue layers and its first MoE layer, with
# PHASE moe's drives: a quarter of the experts on the card in each
MLA_DEPTH = 4
MLA_SINGLE = dict(MOE_SINGLE, expert_hot_slots=64)
MLA_LANES = dict(MOE_LANES, expert_hot_slots=64)
# the two MoE phases: arch, depth cut, the single request's and the lane
# drive's engine configuration
MOE_PHASES = {
    "moe": dict(arch="kimi-k2-1t-a32b", depth=MOE_DEPTH, single=MOE_SINGLE,
                lanes=MOE_LANES),
    "mla": dict(arch="deepseek-v3-671b", depth=MLA_DEPTH, single=MLA_SINGLE,
                lanes=MLA_LANES),
}
# PHASE dense: the dense-cache serving mode (ServeConfig's default,
# paged=False) on llama3.2-3b (PHASE main's params), qwen1.5-4b,
# stablelm-1.6b and gemma2-27b at full width and depth, seed 0, each model
# in two arms in turn: the full cache, and serve_bench.py's llama case
# (page_t 8, 6 hot slots: the ring holds the whole 48-token context) fed the
# dense arm's tokens; 2 random 32-token prompts, 16 greedy tokens, the
# embeddings resource.
DENSE_ARCHS = ("llama3.2-3b", "qwen1.5-4b", "stablelm-1.6b", "gemma2-27b")
DENSE_SERVE = dict(max_seq=256, resources=["embeddings"], embed_hot_slots=4,
                   migration_interval=4)
DENSE_PAGED = dict(DENSE_SERVE, paged=True, page_t=8, hot_slots=6)
DENSE_PROMPT = (2, 32, 16)         # batch, prompt tokens, new tokens
DECODE_PARITY = 0.25    # the reference's decode-parity bound (tests/test_models.py:74)
# the paged arm's attention shapes (label, heads, kv heads, head dim,
# softcap, scale), checked and timed in PHASE kernels
DENSE_ATTN_SHAPES = (("group 1, dk 64 (stablelm-1.6b)", 32, 32, 64, 0.0, None),
                     ("group 1, 20 heads (qwen1.5-4b)", 20, 20, 128, 0.0, None),
                     ("group 2, softcap 50 (gemma2-27b)", 32, 16, 128, 50.0,
                      144.0 ** -0.5),
                     ("group 4 (llama-3.2-vision-11b)", 32, 8, 128, 0.0, None))
# PHASE ssm: zamba2-2.7b (Mamba2 blocks, one shared attention block every
# sixth layer) and xlstm-1.3b (mLSTM and sLSTM blocks, no attention) at full
# width, a third of their depth, seed 0, each drawn after the previous one is
# released:
# (a) PHASE dense's two arms, (b) the lane phase's drive over SSM_LANE_TRACE,
# (c) one layer of each recurrent kind on the card against the CPU
SSM_ARCHS = ("zamba2-2.7b", "xlstm-1.3b")
# their depth cut to a third, whole pattern groups (3 of 9, 2 of 6)
SSM_DEPTH = {"zamba2-2.7b": 18, "xlstm-1.3b": 16}
# (b)'s cut of the lane trace: the shortest (16 arrival steps, 66 scheduler
# steps against PHASE lanes' 95) that still preempts and resumes a
# request and serves a second request on a lane (PHASE fill's cut)
SSM_LANE_TRACE = FILL_TRACE
SSM_LAYER_STEPS = 8     # (c): float32 decode steps of one full-width layer
# zamba2's shared-attention ring (32 query heads over 32 kv heads of 80) at
# PHASE ssm's paged arm (B 2, P 6, T 8) and lanes (B 4, P 8, T 16)
SSM_ATTN_SHAPES = ((2, 6, 8), (4, 8, 16))
# PHASE cross: llama-3.2-vision-11b (a gated cross block every fifth layer
# over 1,601 patch embeddings) and whisper-base (a 6-layer bidirectional
# encoder over 1,500 frames, 6 dec blocks) at full width and depth, seed 0,
# each drawn after the previous one is released: (c) one cross or dec block
# (and whisper's encoder) on the card against the CPU, (a) PHASE dense's two
# arms on llama-3.2-vision with the reference's init (its gates at 0), the
# dense arm against a CPU run on whisper
CROSS_ARCHS = ("llama-3.2-vision-11b", "whisper-base")
CROSS_GATE = 0.5        # (c): the cross block's xgate, so that the image counts
CROSS_LAYER_STEPS = 4   # (c): float32 decode steps of one full-width block
# PHASE train: (a) llama3.2-3b at full width and depth trained TRAIN_STEPS
# steps, AdamW, TRAIN_MICRO microbatches of SyntheticLM's 1,024-token
# sequences; (b) one float32 step of each family at its smoke config on the
# card against the CPU; (c) one full-width block of each training-only form,
# forward and backward, on the card against the CPU
TRAIN_ARCH = "llama3.2-3b"
TRAIN_BATCH, TRAIN_SEQ = 4, 1024
TRAIN_MICRO = 2
TRAIN_STEPS = 8
TRAIN_PROFILED = 2      # steps in the profile, after the gated ones
TRAIN_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
# (b)'s archs (all ten) and options: between them every single-device
# TrainConfig option and both optimizers
TRAIN_FAMILIES = (("llama3.2-3b", {}, "adamw"),
                  ("kimi-k2-1t-a32b", dict(zero1=True, compress_collective=True,
                                           grad_compression=True, microbatches=2),
                   "adamw"),
                  ("deepseek-v3-671b", {}, "adafactor"),
                  ("qwen1.5-4b", dict(zero1=True, offload_master=True), "adamw"),
                  ("stablelm-1.6b", dict(grad_compression=True, microbatches=2,
                                         remat=False), "adamw"),
                  ("gemma2-27b", dict(microbatches=2), "adafactor"),
                  ("zamba2-2.7b", {}, "adamw"),
                  ("xlstm-1.3b", dict(remat=False), "adamw"),
                  ("llama-3.2-vision-11b", {}, "adamw"),
                  ("whisper-base", {}, "adamw"))
TRAIN_FORMS = (("zamba2-2.7b", "mamba"), ("xlstm-1.3b", "mlstm"),
               ("xlstm-1.3b", "slstm"), ("deepseek-v3-671b", "mla"))
# (c)'s partitioned forms: those blocks, llama-vision's gated cross block (over
# its 1,601 patch embeddings) and whisper's bidirectional encoder block
PART_FORMS = TRAIN_FORMS + (("llama-3.2-vision-11b", "cross"), ("whisper-base", "enc"))
TRAIN_FORM_SEQ, TRAIN_CHUNK = 256, 128
# (a)'s census gates: the card's census FLOPs against the census of the same
# step on meta tensors, and the census over analysis.model_flops (remat runs
# the forward twice, 4/3; the plain attention counts the full square)
CENSUS_RTOL = 1e-3
REMAT_FACTOR_MAX = 2.0
# PHASE sim: fig11_main_speedup.py's grid at benchmarks/common.py's scale
# (N_PAGES, BLOCK, FAST_RATIO, SIM_KW, METHODS; stream seed 11), its
# N_BLOCKS = 240 cut to 64 (four clear intervals, 16 threshold updates)
SIM_WORKLOADS = ("deathstar", "pagerank", "xsbench", "gups", "silo", "btree",
                 "bwaves", "roms")
SIM_METHODS = ("neomem", "pebs", "tpp", "autonuma", "pte-scan", "first-touch")
SIM_STREAM = dict(n_pages=4096, block=2048, n_blocks=64, seed=11)
SIM_KW = dict(fast_ratio=1 / 3, quota_pages=128, sketch_width=1 << 14,
              migration_interval=1, threshold_update_period=4, clear_interval=16)
SIM_RUNTIME_RTOL, SIM_BW_ATOL = 1e-12, 1e-6   # card vs CPU: modeled runtime, bw trace
# PHASE sim-paper: gups at the paper's scale, 4M pages of 4 KB and the sketch
# at D=2, W=512K (Table III), blocks of 16384 ids; run_sim's defaults
# otherwise (quota 256, Algorithm 1 every 8 blocks, a clear every 64)
PAPER_STREAM = dict(n_pages=1 << 22, block=1 << 14, n_blocks=256, seed=11)
PAPER_KW = dict(fast_ratio=1 / 3, sketch_width=PAPER_W, sketch_depth=2)
PAPER_QUOTA = 256
PAPER_REPLAY = 16       # blocks at the end of neomem's last clear interval replayed
# PHASE examples: the four example twins through their main; (c) takes the
# reference's 200 steps of batch 8 x 256 tokens and restores its step-100
# checkpoint; (b)'s ring is serve_longctx's (4 rows, 8 slots of 16 tokens),
# its attention the smoke config's group 2 at dk 16 (PHASE kernels)
EXAMPLE_STEPS = 200
EXAMPLE_CKPT = 100
EXAMPLE_REPLAY = 16     # (c): last steps' router streams replayed on the CPU
EXAMPLE_ATTN = (4, 4, 2, 16, 8, 16)      # B, H, Hkv, dk, P, T
# datasheet memory bandwidth (bytes/s), float32 non-tensor peak and dense
# TF32 tensor-core peak (flop/s)
CARDS = (("H200", 4.8e12, 67e12, 495e12), ("H100 NVL", 3.9e12, 60e12, 417e12),
         ("H100 PCIe", 2.0e12, 51e12, 378e12), ("H100", 3.35e12, 67e12, 495e12))


def card_rates(name: str) -> tuple[float, float, float]:
    for key, *rates in CARDS:
        if key in name:
            return tuple(rates)
    raise RuntimeError(f"no datasheet rates for card {name!r}")


def _graph(fn):
    """``fn`` captured once in a CUDA graph (after warm-up on a side
    stream); returns the graph's replay."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return g.replay


def time_ms(fn, n: int = LAUNCHES, graph: bool = True) -> float:
    """Median device time of one call of ``fn``, by CUDA events.

    The call is captured once in a CUDA graph; ``n`` replays, each between
    its own event pair, are queued behind a spin kernel, so the card runs
    them back to back and a pair brackets the call's device work, not the
    host's Python and launch path.  ``fn`` may be a list of calls over
    distinct inputs: one graph each, replayed round-robin, so that with
    more input bytes than the 50 MB L2 each call finds its inputs cold, as
    the main path's layers do.  ``graph=False`` queues ``fn`` itself, for a
    call that synchronises with the host and so cannot be captured (its
    time then includes the host's)."""
    import torch
    fns = list(fn) if isinstance(fn, (list, tuple)) else [fn]
    runs = [_graph(f) for f in fns] if graph else fns
    for run in runs:
        run()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    for i, (s, e) in enumerate(ev):
        s.record()
        runs[i % len(runs)]()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def host_ms(fn, n: int = LAUNCHES) -> float:
    """Wall time per eager call of ``fn`` over ``n`` calls back to back:
    the host's Python and launch path wherever it is slower than the card."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def bound_ms(nbytes: float, nops: float, rates) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / rates[0] * 1e3, nops / rates[1] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(outs, refs) -> float:
    return max(float((a.float() - b.float()).abs().max()) for a, b in zip(outs, refs))


# -- phase 2: kernels against their plain versions -----------------------------

def attention_case(torch, pa_ops, pa_ref, gen, b, h, hkv, dk, dv, p, t, dtype,
                   lens, softcap=0.0, scale=None, junk=False, ref_rows=None):
    """One call of the attention kernel on random inputs against its plain
    version (ATOL + RTOL*|ref| on every output) and its page mass.
    ``junk``: the K and V rows past each page's length hold +-1e30, which a
    kernel fails on if it lets them into the scores, the page stats or
    p @ V.  ``ref_rows``: run the plain version that many batch rows at a
    time (its kv-head expansion of a long context would not fit at once)."""
    scale = dk ** -0.5 if scale is None else scale
    q = torch.randn((b, h, dk), generator=gen, device="cuda")
    kp = torch.randn((b, p, t, hkv, dk), generator=gen, device="cuda").to(dtype)
    vp = torch.randn((b, p, t, hkv, dv), generator=gen, device="cuda").to(dtype)
    lens = torch.as_tensor(lens, dtype=torch.int32, device="cuda")
    if junk:
        tok = torch.arange(t, device="cuda")
        past = (tok[None, None, :] >= lens[:, :, None])[..., None, None]
        big = torch.where(tok % 2 == 0, 1e30, -1e30)[None, None, :, None, None]
        kp = torch.where(past, big.to(dtype), kp)
        vp = torch.where(past, big.to(dtype), vp)
    out = pa_ops.paged_attention_raw(q, kp, vp, lens, scale=scale, softcap=softcap,
                                     return_page_stats=True)
    rows = [slice(0, b)] if ref_rows is None else [
        slice(i, i + ref_rows) for i in range(0, b, ref_rows)]
    parts = [pa_ref.paged_attention_raw_ref(q[r], kp[r], vp[r], lens[r], scale=scale,
                                            softcap=softcap) for r in rows]
    ref = tuple(torch.cat(x) for x in zip(*parts))
    torch.cuda.synchronize()
    for name, a, r in zip(("m", "l", "acc", "page_m", "page_l"), out, ref):
        bad = ~((a - r).abs() <= ATOL + RTOL * r.abs())   # NaN is bad too
        if bool(bad.any()):
            raise AssertionError(
                f"paged_attn {name} differs at {(b, h, hkv, dk, dv, p, t, dtype)}"
                f"{' (junk past the lengths)' if junk else ''}:"
                f" max err {float((a - r).abs().max())}")
    mass = pa_ops.page_mass(*[out[i] for i in (0, 1, 3, 4)])
    valid_rows = (lens > 0).any(dim=1)
    sums = mass.sum(dim=1)[valid_rows]
    if not bool(((sums - 1).abs() < 1e-4).all()):
        raise AssertionError(f"page mass sums {sums.tolist()} != 1")
    if not bool((mass[lens == 0] == 0).all()):
        raise AssertionError("a masked page carries mass")
    return q, kp, vp, lens, out, ref


def check_attention(torch, pa_ops, pa_ref, rates, gen):
    """Edge shapes, then the main path's shape (timed)."""
    def case(*args, **kw):
        return attention_case(torch, pa_ops, pa_ref, gen, *args, **kw)

    rng = np.random.default_rng(0)
    bf16, f32 = torch.bfloat16, torch.float32
    edge = rng.integers(0, 17, (3, 5))
    edge[2] = 0                                  # a fully masked row
    case(3, 8, 2, 64, 64, 5, 16, f32, edge)      # P=5: cluster of 5, one page each
    case(1, 4, 4, 32, 32, 8, 32, f32, rng.integers(1, 33, (1, 8)), softcap=30.0)
    case(3, 8, 1, 72, 64, 2, 8, f32, rng.integers(0, 9, (3, 2)))  # dk != dv
    case(2, 24, 8, 72, 64, 4, 64, bf16, rng.integers(0, 65, (2, 4)))  # ... in bf16
    case(2, 8, 2, 64, 64, 4, 16, bf16, np.full((2, 4), 16))           # full pages
    case(2, 24, 8, 128, 128, 1, 64, bf16, [[64], [0]])          # P=1
    lens = rng.integers(0, 65, (3, 13))
    lens[1] = 0                                   # P=13: shares 2,2,2,2,2,1,1,1
    case(3, 24, 8, 128, 128, 13, 64, bf16, lens)
    # P=16: rank 3 (pages 6, 7) all masked in row 0; pages of 1 token in row 1
    lens = np.full((3, 16), 64)
    lens[0, 6:8] = 0
    lens[1, ::2] = 1
    lens[2, 1::3] = 1
    case(3, 24, 8, 128, 128, 16, 64, bf16, lens)
    case(2, 24, 8, 128, 128, 16, 64, f32, rng.integers(0, 65, (2, 16)))  # f32 K/V
    case(2, 8, 2, 36, 36, 6, 16, bf16, rng.integers(0, 17, (2, 6)))  # 72 B rows: plain loads
    case(4, 24, 8, 128, 128, 64, 64, bf16, rng.integers(0, 65, (4, 64)))  # P=64: max_seq 4096
    # the lane phase's shape: 4 lanes over 8 slots of 16 tokens — an empty
    # (reset or idle) lane, one with only a part-filled current slot, a
    # wrapped full ring, a ragged one
    lens = np.zeros((4, 8), int)
    lens[1, 5] = 7
    lens[2] = 16
    lens[2, 3] = 9
    lens[3] = rng.integers(0, 17, 8)
    case(4, 24, 8, 128, 128, 8, 16, bf16, lens)
    # the reuse and disagg phases' shape: 4 lanes over 6 slots of 4 tokens
    # (TMA boxes 4 rows high, a cluster of 6) — an empty lane, one with only
    # a part-filled current slot, a wrapped full ring, a ragged one; timed
    # cold over enough input sets to exceed the L2
    lens = np.zeros((4, 6), int)
    lens[1, 2] = 3
    lens[2] = 4
    lens[2, 4] = 1
    lens[3] = rng.integers(0, 5, 6)
    q, kp, vp, lt = case(4, 24, 8, 128, 128, 6, 4, bf16, lens)[:4]
    n_sets = -(-2 * 50 * 2 ** 20 // (2 * kp.numel() * kp.element_size()))
    t4_cold = time_ms([lambda x=(q, torch.randn_like(kp), torch.randn_like(vp), lt):
                       pa_ops.paged_attention_raw(*x, return_page_stats=True)
                       for _ in range(n_sets)])
    print(f"kernel paged_attn at P=6 T=4 (the reuse and disagg phases): device "
          f"{t4_cold:.4f} ms cold ({n_sets} input sets, round-robin)")
    # kimi-k2's shape (PHASE moe): 64 query heads over 8 kv heads, a group
    # of 8 (the kernel's MAX_GROUP), dk = dv = 128; the single request's
    # 2 rows over 6 slots of 8 tokens and the lanes' 4 over 8 slots of 16 —
    # a row with a part-filled current slot, a full ring, a ragged one and
    # an empty lane
    for b, p, t in ((2, 6, 8), (4, 8, 16)):
        lens = rng.integers(0, t + 1, (b, p))
        lens[0] = 0
        lens[0, 2] = t // 2
        lens[1] = t
        lens[3:] = 0
        time_attention(torch, pa_ops, pa_ref, rates,
                       case(b, 64, 8, 128, 128, p, t, bf16, lens), "paged_attn",
                       "paged_attn at group 8 (kimi-k2)")
    # main path: llama3.2-3b decode, B=4, 16 ring slots of 64 tokens, the
    # current slot part-filled
    b, h, hkv, d, p, t = 4, 24, 8, 128, 16, 64
    lens = np.full((b, p), t)
    lens[:, 5] = 37
    main = [case(b, h, hkv, d, d, p, t, bf16, lens) for _ in range(COLD_SETS)]
    err = max(max_err(out, ref) for *_, out, ref in main)
    sets = [x[:4] for x in main]
    q, kp, vp, lt = sets[0]
    calls = [lambda x=x: pa_ops.paged_attention_raw(*x, return_page_stats=True)
             for x in sets]
    warm, cold, host = time_ms(calls[0]), time_ms(calls), host_ms(calls[0])
    plain = time_ms(lambda: pa_ref.paged_attention_raw_ref(q, kp, vp, lt,
                                                           scale=d ** -0.5))

    # library yardstick: SDPA over the gathered pages with a token mask
    def sdpa_call(q, kp, vp, lt):
        qs = q.to(torch.bfloat16)[:, :, None, :]
        ks, vs = (x.repeat_interleave(h // hkv, dim=3).permute(0, 3, 1, 2, 4)
                  .reshape(b, h, p * t, d) for x in (kp, vp))
        mask = (torch.arange(t, device="cuda")[None, None] < lt[:, :, None]
                ).reshape(b, 1, 1, p * t)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        return lambda: sdpa(qs, ks, vs, attn_mask=mask)
    lib_calls = [sdpa_call(*x) for x in sets]
    lib_warm, lib_cold = time_ms(lib_calls[0]), time_ms(lib_calls)
    kv_mb = COLD_SETS * kp.numel() * kp.element_size() * 2 / 1e6
    print(f"kernel paged_attn: device {cold:.4f} ms cold ({COLD_SETS} input sets, "
          f"{kv_mb:.1f} MB of K/V, round-robin), {warm:.4f} ms warm (one set, L2-"
          f"resident); SDPA {lib_cold:.4f} ms cold, {lib_warm:.4f} ms warm")
    # what the time is made of: a graph replay of one tiny kernel (the timing
    # floor), and the call with every page masked (launch, cluster set-up and
    # combine, no K/V bytes)
    tiny = torch.zeros(1, device="cuda")
    masked = torch.zeros_like(lt)
    floor = time_ms(tiny.zero_)
    empty = time_ms(lambda: pa_ops.paged_attention_raw(q, kp, vp, masked,
                                                       return_page_stats=True))
    print(f"kernel paged_attn: timing floor {floor:.4f} ms (one tiny kernel per "
          f"graph replay); every page masked {empty:.4f} ms")
    n_tok = int(lens.sum())
    nbytes = (q.numel() * 4 + n_tok * hkv * 2 * d * 2 + lt.numel() * 4
              + b * h * (2 + d) * 4 + 2 * b * p * h * 4)
    nops = n_tok * h * 4 * d
    bms, by = bound_ms(nbytes, nops, rates)
    check_dense_arch_attention(torch, pa_ops, pa_ref, rates)
    check_ssm_attention(torch, pa_ops, pa_ref, rates)
    check_example_attention(torch, pa_ops, pa_ref, rates)
    return dict(name="paged_attn", route="cuda",
                source="src/repro_torch/csrc/paged_attn.cu",
                replaces="src/repro/kernels/paged_attn/paged_attn.py:34",
                max_abs_err=err, ms=cold, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib_cold, host_ms=host)


def check_dense_arch_attention(torch, pa_ops, pa_ref, rates) -> None:
    """PHASE dense's paged-arm ring shapes (B 2, P 6, T 8), checked and
    timed: stablelm-1.6b (group 1, dk 64), qwen1.5-4b (20 heads, group 1,
    dk 128) and gemma2-27b (group 2, dk 128, softcap 50, scale 144^-1/2).
    Row 0 holds full pages and a part-filled current slot, row 1 ragged
    lengths.  Inputs come from their own generators, so the other shapes'
    inputs are those of earlier runs."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rng = np.random.default_rng(1)
    for label, h, hkv, d, softcap, scale in DENSE_ATTN_SHAPES:
        lens = np.full((2, 6), 8)
        lens[0, 3:] = 0
        lens[0, 2] = 5
        lens[1] = rng.integers(0, 9, 6)
        checked = attention_case(torch, pa_ops, pa_ref, gen, 2, h, hkv, d, d, 6, 8,
                                 torch.bfloat16, lens, softcap=softcap, scale=scale)
        time_attention(torch, pa_ops, pa_ref, rates, checked, "paged_attn",
                       f"paged_attn at {label}", scale=scale, softcap=softcap)


def check_ssm_attention(torch, pa_ops, pa_ref, rates) -> None:
    """zamba2-2.7b's shared-attention ring (group 1, 32 heads, dk = dv = 80:
    160-byte rows, TMA boxes of 16-byte multiples) at PHASE ssm's paged arm
    and lane shapes, checked and timed.  Row 0 holds full pages and a
    part-filled current slot, the lanes' last row is an empty (reset) lane,
    the rest ragged."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    rng = np.random.default_rng(2)
    for b, p, t in SSM_ATTN_SHAPES:
        lens = rng.integers(0, t + 1, (b, p))
        lens[0] = t
        lens[0, p // 2:] = 0
        lens[0, p // 2 - 1] = t // 2 + 1
        if b > 2:
            lens[-1] = 0
        checked = attention_case(torch, pa_ops, pa_ref, gen, b, 32, 32, 80, 80, p, t,
                                 torch.bfloat16, lens)
        time_attention(torch, pa_ops, pa_ref, rates, checked, "paged_attn",
                       "paged_attn at group 1, dk 80 (zamba2-2.7b)")


def check_example_attention(torch, pa_ops, pa_ref, rates) -> None:
    """PHASE examples (b)'s ring (serve_longctx: llama3.2-3b-smoke's 4 query
    heads over 2 kv heads, dk = dv = 16: 32-byte rows, TMA boxes 32 bytes
    wide, one 16-byte chunk a lane of the score's 8 and 8 of the 32 column
    pairs of p @ V), checked and timed: an empty row, one with only a
    part-filled current slot, a ragged one and the prompt's 3 full pages
    with a part-filled fourth, also with junk past the lengths."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    b, h, hkv, d, p, t = EXAMPLE_ATTN
    lens = np.zeros((b, p), int)
    lens[1, 2] = 5
    lens[2] = np.random.default_rng(3).integers(0, t + 1, p)
    lens[3, :3] = t
    lens[3, 3] = 7
    attention_case(torch, pa_ops, pa_ref, gen, b, h, hkv, d, d, p, t,
                   torch.bfloat16, lens, junk=True)
    checked = attention_case(torch, pa_ops, pa_ref, gen, b, h, hkv, d, d, p, t,
                             torch.bfloat16, lens)
    time_attention(torch, pa_ops, pa_ref, rates, checked, "paged_attn",
                   "paged_attn at group 2, dk 16 (serve_longctx)")


def check_mla_attention(torch, pa_ops, pa_ref, _lib, rates, gen):
    """The head-tiled kernel at MLA's shape (deepseek-v3: 128 query heads over
    one latent head, dk 576, dv 512, scale (128 + 64)^-1/2): its registers
    and spills from the build log, edge shapes (K and V junk past the page
    lengths in some), then PHASE mla's two ring shapes (the single request's
    B 2, P 6, T 8 and the lanes' B 4, P 8, T 16), PHASE main's (B 4, P 16,
    T 64, with every page masked too: the fixed cost) and a 4,096-token
    context (B 8, P 64, T 64, all pages full; its plain version one batch
    row at a time and not timed), checked and timed cold and warm, with the
    host's time per call, the plain version's, the bound and a library
    call's.  Returns the kernel row of B 4, P 16, T 64."""
    def case(*args, **kw):
        return attention_case(torch, pa_ops, pa_ref, gen, *args, **kw)

    for line in ptxas_report(_lib, "paged_attn_tiled_kernel"):
        print(f"kernel paged_attn_mla: {line}")
    bf16, f32 = torch.bfloat16, torch.float32
    rng = np.random.default_rng(1)
    before = pa_ops.head_tiled.launches
    scale = MLA_SCALE
    edge = rng.integers(0, 9, (3, 9))
    edge[2] = 0                                   # a fully masked row
    edge[0, :4] = 8
    cases = [
        ((3, 48, 2, 576, 512, 9, 8, bf16, edge), {}),          # tiles of 32 + 16
        ((2, 128, 1, 576, 512, 3, 8, f32, rng.integers(0, 9, (2, 3))), {}),
        ((2, 128, 1, 576, 512, 3, 8, f32, [[8, 3, 0], [5, 8, 1]]), dict(junk=True)),
        ((1, 128, 1, 576, 512, 4, 16, bf16, rng.integers(1, 17, (1, 4))),
         dict(softcap=30.0)),
        ((2, 128, 1, 576, 512, 5, 6, bf16, rng.integers(0, 7, (2, 5))), {}),
        ((2, 128, 1, 576, 512, 1, 64, bf16, [[64], [0]]), {}),
        # a 37-token page among full, empty and 1-token ones
        ((2, 128, 1, 576, 512, 4, 64, bf16, [[64, 37, 0, 5], [1, 64, 63, 0]]),
         dict(junk=True)),
        # 128-token pages: two softmax segments a page
        ((1, 128, 1, 576, 512, 3, 128, bf16, [[128, 100, 64]]), dict(junk=True)),
    ]
    for args, kw in cases:
        case(*args, scale=scale, **kw)
    case(2, 32, 1, 24, 16, 3, 4, bf16, rng.integers(0, 5, (2, 3)))  # smoke widths
    case(2, 32, 1, 24, 16, 3, 4, bf16, [[4, 1, 0], [2, 3, 4]], junk=True)
    if pa_ops.head_tiled.launches - before != len(cases) + 2:
        raise AssertionError("a group above MAX_GROUP did not take the head-tiled "
                             "kernel")
    for b, p, t in ((2, 6, 8), (4, 8, 16), (4, 16, 64)):
        lens = rng.integers(0, t + 1, (b, p))
        lens[0] = t
        lens[0, p // 2] = t // 2                  # the part-filled current slot
        lens[1, :2] = 0
        checked = case(b, 128, 1, 576, 512, p, t, bf16, lens, scale=scale)
        row = time_attention(torch, pa_ops, pa_ref, rates, checked, "paged_attn_mla",
                             "paged_attn_mla (deepseek-v3)", scale=scale)
        print(f"kernel paged_attn_mla (deepseek-v3) at B={b} P={p} T={t}: "
              f"{tiled_plan(_lib, checked)}")
    q, kp, vp, lt = checked[:4]
    masked = torch.zeros_like(lt)
    empty = time_ms(lambda: pa_ops.paged_attention_raw(q, kp, vp, masked, scale=scale,
                                                       return_page_stats=True))
    print(f"kernel paged_attn_mla (deepseek-v3) at B=4 P=16 T=64, every page "
          f"masked: device {empty:.4f} ms (launch, q, the cluster's merge; no "
          f"K/V bytes)")
    # deepseek-v3 decoding 8 sequences at a 4,096-token context
    b, p, t = 8, 64, 64
    checked = case(b, 128, 1, 576, 512, p, t, bf16, np.full((b, p), t), scale=scale,
                   ref_rows=1)
    time_attention(torch, pa_ops, pa_ref, rates, checked, "paged_attn_mla",
                   "paged_attn_mla (deepseek-v3, 4,096 tokens)", scale=scale,
                   plain=False)
    print(f"kernel paged_attn_mla (deepseek-v3) at B={b} P={p} T={t}: "
          f"{tiled_plan(_lib, checked)}")
    return row


def tiled_plan(_lib, checked) -> str:
    """The cluster size the head-tiled kernel's launch takes at a checked
    shape, and the clusters of each size that fit on the card at once, from
    the launch's own query (``paged_attn_tiled_plan``)."""
    import ctypes
    q, kp, vp = checked[:3]
    b, h, dk = q.shape
    _, p, t, hkv, _ = kp.shape
    fits = (ctypes.c_int * 8)()
    bf16 = int(kp.element_size() == 2)          # bf16 or f32 pages reach it
    c = _lib.lib().paged_attn_tiled_plan(bf16, b, h, hkv, p, t, dk, vp.shape[-1], fits)
    if c < 0:
        raise RuntimeError(f"paged_attn_tiled_plan: CUDA error {-c}")
    return (f"cluster size {c} of the launch's choice; clusters of 1..8 blocks "
            f"that fit at once {list(fits)} (0: more than the pages)")


def ptxas_report(_lib, kernel: str) -> list:
    """Registers and spills of each instantiation of ``kernel``, from the
    build's -Xptxas -v log (``<lib>.log``)."""
    log = Path(str(_lib.library_path()) + ".log")
    if not log.exists():
        return [f"no build log at {log.name}"]
    out, name = [], None
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if kernel in line else None
        elif name and "spill stores" in line:
            spill = line.strip()
        elif name and "Used" in line and "registers" in line:
            pages = "bf16" if "bfloat16" in name else "f32"
            out.append(f"ptxas, {pages} pages: {line.split(':', 1)[1].strip()}; "
                       f"{spill}")
            name = None
    return out or [f"{kernel} not in {log.name}"]


def time_attention(torch, pa_ops, pa_ref, rates, checked, name, label,
                   scale=None, plain=True, softcap=0.0) -> dict:
    """Time attention at a checked shape: cold over enough input sets to
    exceed the L2, warm, the host's wall per call, the plain version (unless
    ``plain`` is False), the bound (bytes at the memory rate, flops at the
    TF32 tensor-core rate: bf16 pages are exact in TF32) and a library call:
    SDPA with enable_gqa over the masked pages, else with the kv heads
    expanded, else matmul-softmax-matmul in bf16, whichever a backend takes
    first (SDPA takes no softcap: with ``softcap`` the yardstick runs
    without it)."""
    q, kp, vp, lt, out, ref = checked
    b, h, dk = q.shape
    _, p, t, hkv, _ = kp.shape
    dv = vp.shape[-1]
    scale = dk ** -0.5 if scale is None else scale
    kv_bytes = (kp.numel() + vp.numel()) * kp.element_size()
    n_sets = max(2, -(-2 * 50 * 2 ** 20 // kv_bytes))
    sets = [(q, kp, vp, lt)] + [(q, torch.randn_like(kp), torch.randn_like(vp), lt)
                                for _ in range(n_sets - 1)]
    calls = [lambda x=x: pa_ops.paged_attention_raw(*x, scale=scale, softcap=softcap,
                                                    return_page_stats=True)
             for x in sets]
    warm, cold, host = time_ms(calls[0]), time_ms(calls), host_ms(calls[0])
    plain = time_ms(lambda: pa_ref.paged_attention_raw_ref(
        q, kp, vp, lt, scale=scale, softcap=softcap)) if plain else None
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library(q, kp, vp, lt, how):
        qs = q.to(torch.bfloat16)[:, :, None, :]
        ks, vs = (x.permute(0, 3, 1, 2, 4).reshape(b, hkv, p * t, x.shape[-1])
                  for x in (kp, vp))
        mask = (torch.arange(t, device="cuda")[None, None] < lt[:, :, None]
                ).reshape(b, 1, 1, p * t)
        if how == "SDPA, enable_gqa":
            return lambda: sdpa(qs, ks, vs, attn_mask=mask, scale=scale,
                                enable_gqa=True)
        if how == "SDPA, kv heads expanded":
            ke, ve = (x.repeat_interleave(h // hkv, dim=1) for x in (ks, vs))
            return lambda: sdpa(qs, ke, ve, attn_mask=mask, scale=scale)
        ke, ve = (x.repeat_interleave(h // hkv, dim=1) for x in (ks, vs))

        def mm():
            s = torch.matmul(qs, ke.transpose(-1, -2)) * scale
            return torch.matmul(torch.softmax(s.masked_fill(~mask, -1e30), -1), ve)
        return mm
    lib_cold, how = None, None
    for how in ("SDPA, enable_gqa", "SDPA, kv heads expanded",
                "matmul-softmax-matmul"):
        try:
            fns = [library(*x, how) for x in sets]
            fns[0]()
            torch.cuda.synchronize()
            lib_cold = time_ms(fns)
            break
        except RuntimeError as e:
            print(f"kernel {label}: library {how} refused ({str(e)[:120]})")
    n_tok = int(lt.sum())
    nbytes = (q.numel() * 4 + n_tok * hkv * (dk + dv) * kp.element_size()
              + lt.numel() * 4 + b * h * (2 + dv) * 4 + 2 * b * p * h * 4)
    nops = 2 * n_tok * h * (dk + dv)
    bms, by = bound_ms(nbytes, nops, (rates[0], rates[2]))
    print(f"kernel {label} (group {h // hkv}, dk {dk}, dv {dv}, B={b} P={p} T={t}"
          f"{f', softcap {softcap:g}' if softcap else ''}): "
          f"max_abs_err {max_err(out, ref):.3g}; device {cold:.4f} ms cold ({n_sets} "
          f"input sets, round-robin), {warm:.4f} ms warm, host {host:.4f} ms per "
          f"eager call; plain {'not timed' if plain is None else f'{plain:.4f} ms'}; "
          f"bound {bms:.5f} ms by {by} "
          f"({nbytes / 1e6:.2f} MB, {nops / 1e9:.3f} GFLOP at the TF32 tensor-core "
          f"rate; {nops / rates[1] * 1e3:.5f} ms at the float32 CUDA-core rate); "
          f"library ({how}{', no softcap' if softcap else ''}) "
          f"{'refused' if lib_cold is None else f'{lib_cold:.4f} ms cold'}")
    return dict(name=name, route="cuda", source="src/repro_torch/csrc/paged_attn.cu",
                replaces="src/repro/kernels/paged_attn/paged_attn.py:34",
                max_abs_err=max_err(out, ref), ms=cold, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib_cold, host_ms=host)


def check_sketch(torch, np_ops, np_ref, hist_ops, hist_ref, sk, rates, gen):
    """Update, mark and histogram kernels: edge cases, then the main path's
    shapes (timed) and the paper's W=512K (timed cold)."""
    cmax = sk.SketchParams().counter_max
    edges = torch.as_tensor(sk.hist_edges(), device="cuda")

    def state(d, w, kind="random", offset=0):
        """A (D, W) sketch on the card whose current epoch is 7.  ``kind``:
        random (counters 0..49), near_max (cmax-3..cmax), at_max (all cmax),
        zero (all 0), mixed (tags 6 or 7), stale (every tag 6), main (as
        the main path's row 0 looks: 94% of counters 0, the rest 1..8, a
        tenth of the tags stale).  ``offset`` > 0 shifts every plane off
        16-byte alignment."""
        def plane(dtype, fill):
            return torch.empty((d * w + offset,), dtype=dtype, device="cuda"
                               )[offset:].view(d, w).copy_(fill)
        counts = torch.randint(0, 50, (d, w), generator=gen, device="cuda",
                               dtype=torch.int32)
        tags = torch.full((d, w), 7, dtype=torch.uint8, device="cuda")
        if kind == "near_max":
            counts = counts % 4 + (cmax - 3)
        elif kind == "at_max":
            counts.fill_(cmax)
        elif kind == "zero":
            counts.zero_()
        elif kind == "main":
            counts = torch.where(torch.rand((d, w), generator=gen, device="cuda")
                                 < 0.06, counts % 8 + 1, 0)
        if kind == "mixed":
            tags = torch.randint(6, 8, (d, w), generator=gen, device="cuda"
                                 ).to(torch.uint8)
        elif kind == "stale":
            tags.fill_(6)
        elif kind == "main":
            tags[torch.rand((d, w), generator=gen, device="cuda") < 0.1] = 6
        hot = torch.rand((d, w), generator=gen, device="cuda") < 0.1
        seeds = torch.randint(0, w, (d, sk.PAGE_ID_BITS), generator=gen,
                              device="cuda", dtype=torch.int32)
        cur = torch.tensor(7, dtype=torch.uint8, device="cuda")
        return (plane(torch.int32, counts), plane(torch.uint8, tags),
                plane(torch.bool, hot), seeds, cur)

    def ids_for(s, hi, pad=True, dup=True):
        ids = torch.randint(-1 if pad else 0, hi, (s,), generator=gen,
                            device="cuda", dtype=torch.int32)
        if dup:
            ids[: s // 4] = ids[0].clamp_min(3)
        return ids

    def run(d, w, s, kind="random", ids=None, offset=0):
        counts, epochs, hot, seeds, cur = state(d, w, kind, offset)
        ids = ids_for(s, 1 << 18) if ids is None else ids
        out = np_ops.sketch_update_kernel(counts, epochs, hot, ids, seeds, cur, cmax)
        ref = np_ref.update_ref(counts, epochs, hot, ids, seeds, cur, cmax)
        is_hot = torch.rand((s,), generator=gen, device="cuda") < 0.3
        mk = np_ops.sketch_mark_hot_kernel(hot, ids, is_hot, seeds)
        mr = np_ref.mark_hot_ref(hot, ids, is_hot, seeds)
        hk = hist_ops.hist_kernel(counts[0], epochs[0], cur, edges)
        hr = hist_ref.hist_ref(counts[0], epochs[0], cur, edges)
        torch.cuda.synchronize()
        for name, a, r in zip(("counts", "epochs", "est", "hot_before", "mark",
                               "hist"), (*out, mk, hk), (*ref, mr, hr)):
            if a.dtype != r.dtype or not torch.equal(a, r):
                raise AssertionError(f"{name} differs at D={d} W={w} S={s} "
                                     f"{kind} offset={offset}")
        return (counts, epochs, hot, ids, seeds, cur, is_hot,
                max_err((*out, mk, hk), (*ref, mr, hr)))

    def mark_case(d, w, s, offset=0):
        """Mark alone (the update needs a power-of-two width): seeds below
        512 keep every hash inside a lane; ``offset`` shifts the plane off
        16-byte alignment.  The old plane must come back unchanged."""
        buf = torch.rand((d * w + offset,), generator=gen, device="cuda") < 0.1
        hot = buf[offset:].view(d, w)
        seeds = torch.randint(0, 512, (d, sk.PAGE_ID_BITS), generator=gen,
                              device="cuda", dtype=torch.int32)
        ids = ids_for(s, 1 << 18)
        is_hot = torch.rand((s,), generator=gen, device="cuda") < 0.5
        before = hot.clone()
        mk = np_ops.sketch_mark_hot_kernel(hot, ids, is_hot, seeds)
        mr = np_ref.mark_hot_ref(hot, ids, is_hot, seeds)
        torch.cuda.synchronize()
        if not (torch.equal(mk, mr) and torch.equal(hot, before)):
            raise AssertionError(f"mark differs at D={d} W={w} S={s} offset={offset}")

    mark_case(3, 1000, 64)                   # plane of 3000 B: a scalar tail
    mark_case(2, 1 << 14, 16, offset=1)      # unaligned plane: byte copies
    run(2, 4096, 256)                        # padding + duplicates
    run(3, 1024, 512, "mixed")               # W below one update segment
    run(2, 4096, 1)                          # one id
    run(2, 4096, 64, ids=torch.full((64,), -1, dtype=torch.int32, device="cuda"))
    run(2, 4096, 1024, "near_max")           # duplicates saturate at counter_max
    run(2, 1 << 14, 1024, "near_max")        # the same over several segments a lane
    run(2, 4096, 256, "at_max")              # every counter at counter_max
    run(2, 4096, 256, "stale")               # a fully stale sketch reads 0
    run(2, 4096, 256, "zero")                # an all-zero row
    run(2, 4096, 256, offset=1)              # planes off 16-byte alignment
    run(2, PAPER_W, 1024, "main")            # the paper's width
    for s_lane in (32, 128):                 # the lane phase's blocks: mostly padding
        ids = torch.randint(0, 2004, (s_lane,), generator=gen, device="cuda",
                            dtype=torch.int32)
        pad = torch.rand((s_lane,), generator=gen, device="cuda") < 0.75
        run(2, 1 << 14, s_lane, ids=torch.where(pad, -1, ids))
    # the ops-level verb against the core's plain sketch_update
    sp = sk.SketchParams(width=1 << 12)
    st = sk.sketch_init(sp, device="cuda")
    for theta in (0, 2):
        ids = ids_for(256, 4000)
        st_k, nh_k = np_ops.sketch_update(st, ids, torch.tensor(theta, device="cuda"), sp)
        st_c, nh_c = sk.sketch_update(st, ids, torch.tensor(theta, device="cuda"), sp)
        for a, r in zip((*st_k, nh_k), (*st_c, nh_c)):
            if not torch.equal(a, r):
                raise AssertionError("ops.sketch_update != core.sketch_update")
        st = st_k
    if not torch.equal(hist_ops.sketch_histogram(st, sp), sk.sketch_histogram(st, sp)):
        raise AssertionError("ops.sketch_histogram != core.sketch_histogram")

    # main path: D=2, W=16384, one ring's 16 page ids per block
    d, w, s = 2, 1 << 14, 16
    counts, epochs, hot, ids, seeds, cur, is_hot, err = run(d, w, s)
    rows = []
    args = (counts, epochs, hot, ids, seeds, cur, cmax)
    lane = torch.arange(d, device="cuda")[:, None].expand(d, s)
    h_idx = sk.h3_hash(torch.where(ids >= 0, ids, 0), seeds).long()
    acc_into = counts.clone()
    ones = (ids >= 0).to(torch.int32).expand(d, s)
    bms, by = bound_ms(*update_work(d, w, s, seeds), rates)
    launch = lambda: np_ops.sketch_update_kernel(*args)  # noqa: E731
    rows.append(dict(
        name="neoprof_update", route="cuda",
        source="src/repro_torch/csrc/neoprof_update.cu",
        replaces="src/repro/kernels/neoprof_update/neoprof_update.py:45",
        max_abs_err=err, ms=time_ms(launch), host_ms=host_ms(launch),
        plain_ms=time_ms(lambda: np_ref.update_ref(*args)), bound_ms=bms,
        bound_by=by,
        library_ms=time_ms(lambda: acc_into.index_put_((lane, h_idx), ones,
                                                       accumulate=True))))
    hot_into = hot.clone()
    sel = is_hot & (ids >= 0)
    mark_at = (lane[:, sel], h_idx[:, sel])
    true = torch.tensor(True, device="cuda")
    bms, by = bound_ms(*mark_work(d, w, s, seeds), rates)
    launch = lambda: np_ops.sketch_mark_hot_kernel(hot, ids, is_hot, seeds)  # noqa: E731
    # the library call for the same (out-of-place) function is index_put;
    # the in-place index_put_ skips the plane's copy and is shown only here
    in_place = time_ms(lambda: hot_into.index_put_(mark_at, true))
    print(f"kernel neoprof_mark: in-place index_put_ {in_place:.4f} ms "
          "(a different function: no copy of the plane)")
    rows.append(dict(
        name="neoprof_mark", route="cuda",
        source="src/repro_torch/csrc/neoprof_update.cu",
        replaces="src/repro/kernels/neoprof_update/neoprof_update.py:93",
        max_abs_err=err, ms=time_ms(launch), host_ms=host_ms(launch),
        plain_ms=time_ms(lambda: np_ref.mark_hot_ref(hot, ids, is_hot, seeds)),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(lambda: hot.index_put(mark_at, true))))
    bms, by = bound_ms(*hist_work(w, edges), rates)
    launch = lambda: hist_ops.hist_kernel(counts[0], epochs[0], cur, edges)  # noqa: E731
    rows.append(dict(
        name="cms_hist", route="cuda", source="src/repro_torch/csrc/cms_hist.cu",
        replaces="src/repro/kernels/cms_hist/cms_hist.py:22", max_abs_err=err,
        ms=time_ms(launch), host_ms=host_ms(launch),
        plain_ms=time_ms(lambda: hist_ref.hist_ref(counts[0], epochs[0], cur, edges)),
        bound_ms=bms, bound_by=by,
        library_ms=hist_library_ms(torch, counts[0], epochs[0], cur, edges)))
    floor = time_ms(torch.zeros(1, device="cuda").zero_)
    print(f"kernel sketch: timing floor {floor:.4f} ms (one tiny kernel per graph replay)")

    def block_ids(s, n_pages):
        """A neomem block of the simulator: the slow tier's misses (here
        two thirds of the block, uniform over ``n_pages``) first, -1 after."""
        ids = torch.full((s,), -1, dtype=torch.int32, device="cuda")
        n = 2 * s // 3
        ids[:n] = torch.randint(0, n_pages, (n,), generator=gen, device="cuda",
                                dtype=torch.int32)
        return ids

    def timed(w, d=2, s=16, make_ids=None):
        """Update, mark and histogram at D=2, width ``w``, ``s`` ids a block
        (``make_ids()``, default padded ids with duplicates), cold in L2
        (rotating over SKETCH_SETS input sets) and warm (one set), beside
        their bounds and library calls; the histogram also on rows shaped
        like the main path's."""
        sets = []
        for _ in range(SKETCH_SETS):
            c, e, h, sd, cu = state(d, w)
            ids = make_ids() if make_ids else ids_for(s, 1 << 18)
            sets.append((c, e, h, ids, sd, cu))
        mb = SKETCH_SETS * d * w * (4 + 1 + 1) / 1e6
        upd = [lambda x=x: np_ops.sketch_update_kernel(*x, cmax) for x in sets]
        flags = [torch.rand((s,), generator=gen, device="cuda") < 0.3 for _ in sets]
        mark = [lambda x=x, f=f: np_ops.sketch_mark_hot_kernel(x[2], x[3], f, x[4])
                for x, f in zip(sets, flags)]
        counts, epochs, hot, ids, seeds, cur = sets[0]
        lane = torch.arange(d, device="cuda")[:, None].expand(d, s)
        h_idx = sk.h3_hash(torch.where(ids >= 0, ids, 0), seeds).long()
        ones = (ids >= 0).to(torch.int32).expand(d, s)
        acc_into = counts.clone()
        lib = time_ms(lambda: acc_into.index_put_((lane, h_idx), ones, accumulate=True))
        bms, by = bound_ms(*update_work(d, w, s, seeds), rates)
        print(f"kernel neoprof_update at D={d} W={w} S={s}: device "
              f"{time_ms(upd):.4f} ms cold ({SKETCH_SETS} input sets, {mb:.1f} MB, "
              f"round-robin), {time_ms(upd[0]):.4f} ms warm; bound {bms:.6f} ms "
              f"by {by}; index_put_ accumulate {lib:.4f} ms warm")
        bms, by = bound_ms(*mark_work(d, w, s, seeds), rates)
        sel = flags[0] & (ids >= 0)
        mark_at = (lane[:, sel], h_idx[:, sel])
        true = torch.tensor(True, device="cuda")
        lib = time_ms(lambda: hot.index_put(mark_at, true))
        print(f"kernel neoprof_mark at D={d} W={w} S={s}: device "
              f"{time_ms(mark):.4f} ms cold, {time_ms(mark[0]):.4f} ms warm; "
              f"bound {bms:.6f} ms by {by}; out-of-place index_put {lib:.4f} ms warm")
        hist = [lambda x=x: hist_ops.hist_kernel(x[0][0], x[1][0], x[5], edges)
                for x in sets]
        main_like = [state(1, w, "main") for _ in range(SKETCH_SETS)]
        hist_main = [lambda x=x: hist_ops.hist_kernel(x[0][0], x[1][0], x[4], edges)
                     for x in main_like]
        bms, by = bound_ms(*hist_work(w, edges), rates)
        lib = hist_library_ms(torch, counts[0], epochs[0], cur, edges)
        print(f"kernel cms_hist at W={w}: device {time_ms(hist):.4f} ms cold, "
              f"{time_ms(hist[0]):.4f} ms warm (counters uniform in 0..49); "
              f"main-path-like rows (94% zero, 10% of tags stale) "
              f"{time_ms(hist_main):.4f} ms cold, {time_ms(hist_main[0]):.4f} ms "
              f"warm; bound {bms:.6f} ms by {by}; bucketize + bincount {lib:.4f} ms")

    timed(1 << 14)
    timed(PAPER_W)
    # the simulator's blocks, bitwise and timed: PHASE sim's S=2048 at
    # W=16K and PHASE sim-paper's S=16384 at the paper's W=512K
    for w, s, n_pages in ((1 << 14, SIM_STREAM["block"], SIM_STREAM["n_pages"]),
                          (PAPER_W, PAPER_STREAM["block"], PAPER_STREAM["n_pages"])):
        run(2, w, s, "main", ids=block_ids(s, n_pages))
        timed(w, s=s, make_ids=lambda s=s, n=n_pages: block_ids(s, n))
    return rows


def update_work(d, w, s, seeds):
    """Bytes and integer operations of one update call: every counter and
    tag read and written once, the hot bit read and est/hot_before written
    per (lane, id), the ids and seeds read; ~40 operations per (lane, id)."""
    return (d * w * (4 + 1) * 2 + d * s * (1 + 4 + 4) + s * 4 + seeds.numel() * 4,
            d * s * 40)


def mark_work(d, w, s, seeds):
    """Bytes and operations of one mark call: the hot plane read and written
    once, the ids, flags and seeds read; ~32 operations per (lane, id)."""
    return d * w * 2 + s * 5 + seeds.numel() * 4, d * s * 32


def hist_work(w, edges):
    """Bytes and operations of one histogram call: row 0's counters and tags
    read once, the edges read and 64 bins written; ~8 operations a counter."""
    return w * (4 + 1) + edges.numel() * 4 + 64 * 4, w * 8


def hist_library_ms(torch, counts_row0, epochs_row0, cur, edges):
    """``bucketize`` + ``bincount`` on the live row, eager: ``bincount`` sizes
    its output from the input's max, read on the host."""
    live = torch.where(epochs_row0 == cur, counts_row0, 0)
    return time_ms(lambda: torch.bincount(
        torch.bucketize(live, edges, right=True) - 1, minlength=64), graph=False)


# -- phase 3: the main path at full width -----------------------------------------

def draw_params(torch):
    """llama3.2-3b at full width, random bf16 weights from seed 0."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_params
    cfg = get_config("llama3.2-3b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    print(f"main: llama3.2-3b full width, {n_params / 1e9:.3f} B params bf16 "
          f"drawn in {time.perf_counter() - t0:.1f} s")
    return cfg, params


def record_blocks(h) -> list:
    """Record every block a resource's sketch takes: (ids, theta, epoch)."""
    blocks = []
    observe = h.mem.observe

    def recording(state, pages, **kw):
        blocks.append((pages.cpu(), int(state.prof.theta),
                       int(state.prof.sketch.cur_epoch)))
        return observe(state, pages, **kw)
    h.mem.observe = recording
    return blocks


def replay_sketch(torch, sp, blocks, end, start=None, what="sketch") -> None:
    """Replay recorded blocks (ids, θ, epoch) through the plain sketch on
    the CPU from ``start`` (default: a zeroed sketch on ``end``'s seeds);
    the card's sketch ``end`` must come out bitwise equal."""
    from repro_torch.core import sketch as sk
    st = (sk.sketch_init(sp, end.seeds.cpu(), device="cpu") if start is None
          else start._replace(**{f: getattr(start, f).cpu() for f in start._fields}))
    for ids, theta, epoch in blocks:
        while int(st.cur_epoch) != int(epoch):
            st = sk.sketch_clear(st)
        st, _ = sk.sketch_update(st, ids.cpu(),
                                 torch.tensor(int(theta), dtype=torch.int32), sp)
    while int(st.cur_epoch) != int(end.cur_epoch):
        st = sk.sketch_clear(st)
    for name in ("counts", "epochs", "hot", "cur_epoch", "n_seen"):
        if not torch.equal(getattr(st, name), getattr(end, name).cpu()):
            raise AssertionError(f"{what} replay: {name} differs")


def replay_resource(torch, h, blocks) -> None:
    """A resource's recorded blocks replayed from its zeroed sketch."""
    replay_sketch(torch, h.mem.pp.sketch, blocks, h.state.prof.sketch,
                  what=f"{h.name} sketch")


def main_path(torch, counters, cfg, params):
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    eng = ServeEngine(cfg, params, ServeConfig(
        max_seq=4096, paged=True, page_t=64, hot_slots=16, migration_interval=8))
    h = eng.daemon["kv"]
    blocks = record_blocks(h)

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (4, 1024))
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    tok = eng.prefill(prompts)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(63):
        tok = eng.step(tok)
        out.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    if not all(launches.values()):
        raise AssertionError(f"a kernel never launched on the main path: {launches}")
    tokens = np.stack(out, axis=1)
    assert tokens.shape == (4, 64) and (tokens >= 0).all() and (tokens < cfg.vocab).all()
    stats = eng.tier_stats()["kv"]
    logits = eng._advance(torch.as_tensor(tok, device="cuda")[:, None])
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits")
    sums = eng._last_kv_mass.sum(dim=1)
    if not bool(((sums - 1).abs() < 1e-4).all()):
        raise AssertionError(f"page mass sums {sums.tolist()} != 1")
    if not (stats["migration_bytes"] > 0 and stats["flush_bytes"] > 0):
        raise AssertionError(f"no bytes moved: {stats}")
    replay_resource(torch, h, blocks)
    print(f"main: sketch replay of {len(blocks)} blocks bitwise equal")
    print(f"main: prefill {prefill_s:.3f} s for 4x1024 tokens; decode "
          f"{4 * 63 / decode_s:.2f} tokens/s, {1e3 * decode_s / 63:.2f} ms/step")
    print("main: kv tier_stats " + json.dumps(stats))
    print("main: launches " + json.dumps(launches))
    tok = profile_decode(torch, eng, tok)
    silu_ab(torch, eng, tok)
    return launches, dict(prefill_s=prefill_s, decode_tokens_per_s=4 * 63 / decode_s,
                          ms_per_step=1e3 * decode_s / 63)


def device_rows(torch, prof) -> list:
    """A profile's device-side rows (kernels, copies) as (device us, name,
    count), largest first; the aten rows that launched them carry the same
    time again and are left out."""
    events = prof.key_averages()
    key = ("self_device_time_total" if hasattr(events[0], "self_device_time_total")
           else "self_cuda_time_total")
    return sorted(((getattr(e, key), e.key, e.count) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and getattr(e, key) > 0), reverse=True)


def profile_decode(torch, eng, tok, steps: int = 8):
    """torch.profiler over ``steps`` decode steps: the device's busy share
    of the wall time and the kernels that fill it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            tok = eng.step(tok)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = device_rows(torch, prof)
    busy_us = sum(t for t, _, _ in dev)
    launches = sum(count for _, _, count in dev)
    print(f"profile: {steps} decode steps, wall {wall_us / steps / 1e3:.2f} ms/step, "
          f"device busy {busy_us / steps / 1e3:.2f} ms/step "
          f"({100 * busy_us / wall_us:.1f}% of wall), "
          f"{launches / steps:.1f} device launches/step (kernels and copies)")
    for t, name, count in dev[:8]:
        print(f"profile:   {t / steps / 1e3:8.3f} ms/step  {count // steps:5d}/step  {name[:70]}")
    attn_us = sum(t for t, name, _ in dev if "paged_attn_" in name)
    attn_n = sum(count for _, name, count in dev if "paged_attn_" in name)
    print(f"profile: paged attention {attn_us / steps / 1e3:.3f} ms/step over "
          f"{attn_n / steps:.1f} launches/step, {100 * attn_us / busy_us:.1f}% of "
          "device busy time")
    return tok


def silu_ab(torch, eng, tok, steps: int = 8, rounds: int = 2):
    """Unprofiled decode ms/step with swiglu's activation as shipped
    (``F.silu``, one launch) and as the reference's formula written op by
    op (four launches), in ``2 * rounds`` pairs run A B B A on this host."""
    import torch.nn.functional as F
    shipped = F.silu

    def op_by_op(x):
        return x * (1 / (1 + torch.exp(-x)))

    times = {"F.silu": [], "op-by-op": []}
    try:
        for _ in range(rounds):
            for name in ("F.silu", "op-by-op", "op-by-op", "F.silu"):
                F.silu = shipped if name == "F.silu" else op_by_op
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(steps):
                    tok = eng.step(tok)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3 / steps)
    finally:
        F.silu = shipped
    wins = sum(a < b for a, b in zip(times["F.silu"], times["op-by-op"]))
    print("silu A/B: decode ms/step, median of {} runs of {} steps: {}; "
          "F.silu faster in {} of {} pairs".format(
              2 * rounds, steps, ", ".join(
                  f"{k} {statistics.median(v):.2f} ({', '.join(f'{x:.2f}' for x in v)})"
                  for k, v in times.items()), wins, 2 * rounds))


# -- phase 4: the lane substrate and the scheduler ------------------------------

def run_trace(cfg, params, device, serve, sched_kw, trace_kw, profiles=None,
              on_sched=None):
    """A seeded trace through the port's Scheduler on ``device``: ``serve``
    and ``sched_kw`` configure the engine and the scheduler, ``profiles``
    the tenants (None: the trace kind's own); ``on_sched(sched)`` runs
    between building the scheduler (and its engines) and the trace.  On the
    CPU (the smoke configs' reference runs) the replay takes one thread:
    at those widths threads only add their hand-offs.
    Returns (engine, scheduler, trace, wall seconds of the replay)."""
    import torch
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.serve.sched import SchedConfig, Scheduler, Tenant
    from repro_torch.workloads import TenantProfile, make_trace, play
    kw = dict(trace_kw)
    if profiles is not None:
        kw["tenants"] = tuple(TenantProfile(*p) for p in profiles)
    trace = make_trace(vocab=cfg.vocab, **kw)
    eng = ServeEngine(cfg, params, ServeConfig(
        **dict(serve, resources=tuple(serve.get("resources", ())))),
        device=device)
    sched = Scheduler(eng, [Tenant(t.name, t.weight) for t in trace.tenants],
                      SchedConfig(**sched_kw))
    if on_sched is not None:
        on_sched(sched)
    threads = torch.get_num_threads()
    if device == "cpu":
        torch.set_num_threads(1)
    t0 = time.perf_counter()
    try:
        play(trace, sched)
    finally:
        torch.set_num_threads(threads)
    return eng, sched, trace, time.perf_counter() - t0


def run_lanes(cfg, params, device, on_sched=None, trace=LANE_TRACE):
    """The lane phase's trace (or ``trace``, a cut of it) through the port's
    Scheduler on ``device``."""
    return run_trace(cfg, params, device, LANE_SERVE, LANE_SCHED, trace,
                     LANE_TENANTS, on_sched)


def lane_schedule(sched) -> dict:
    """What greedy scheduling decides, which no token value can change."""
    return {"steps": sched.step_count, "preemptions": sched.preemptions,
            "queued_peak": sched.queued_peak,
            "requests": [[r.rid, r.admitted_step, r.finished_step, r.preemptions]
                         for r in sorted(sched.finished, key=lambda r: r.rid)]}


def _smoke_cpu(arch: str = "llama3.2-3b"):
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models.transformer import init_params
    cfg = get_smoke_config(arch)
    return cfg, init_params(cfg, seed=0, device="cpu")


def cpu_lane_schedule(arch: str = "llama3.2-3b", trace=LANE_TRACE) -> dict:
    """The lane phase's schedule (over ``trace``) from the port on the CPU,
    at ``arch``'s smoke config (seconds); the trace's arrivals are drawn for
    the smoke vocabulary, the same steps, tenants and lengths as at full
    width."""
    _, sched, _, _ = run_lanes(*_smoke_cpu(arch), "cpu", trace=trace)
    return lane_schedule(sched)


def _pages(nbytes: int, row: int) -> int:
    """Bytes as whole wire rows (a width-free count)."""
    if nbytes % row:
        raise AssertionError(f"{nbytes} bytes are not whole rows of {row} B")
    return nbytes // row


def reuse_schedule(eng, sched) -> dict:
    """What the reuse phase's schedule is, which no token value changes:
    steps, each request's admission, finish and token steps, and the reuse
    store's integer counters; the pool's refcounts must have drained."""
    stats = eng.reuse_stats()
    if stats["shared_refs"] != 0 or any(eng.reuse.ref.values()):
        raise AssertionError(f"pool refcounts did not drain: {stats}")
    return {"steps": sched.step_count, "preemptions": sched.preemptions,
            "requests": [[r.rid, r.admitted_step, r.finished_step, r.preemptions,
                          r.token_steps]
                         for r in sorted(sched.finished, key=lambda r: r.rid)],
            "reuse": {k: v for k, v in stats.items() if isinstance(v, int)}}


def disagg_schedule(eng, sched) -> dict:
    """The disaggregation phase's schedule: steps, each request's steps,
    and the hand-offs, their bytes counted in wire rows (the row size
    depends on the width)."""
    row = eng.daemon["kv"].mem.row_bytes
    rep = sched.report()
    return {"steps": sched.step_count, "preemptions": sched.preemptions,
            "requests": [[r.rid, r.admitted_step, r.finished_step, r.preemptions,
                          r.token_steps]
                         for r in sorted(sched.finished, key=lambda r: r.rid)],
            "handoff": {"count": rep["handoff"]["count"],
                        "pages_out": _pages(rep["handoff"]["bytes_out"], row),
                        "pages_in": _pages(rep["handoff"]["bytes_in"], row),
                        "depth_peak": rep["handoff"]["depth_peak"]}}


def reuse_rows(eng) -> dict:
    """Rows each resource migrated and flushed (bytes over its wire row)."""
    stats = eng.tier_stats()
    return {name: {k: _pages(stats[name][k], h.mem.row_bytes)
                   for k in ("migration_bytes", "flush_bytes")}
            for name, h in eng.daemon.resources.items()}


def run_reuse(cfg, params, device, on_sched=None, codec="int8"):
    return run_trace(cfg, params, device, dict(REUSE_SERVE, slow_codec=codec),
                     REUSE_SCHED, REUSE_TRACE, REUSE_TENANTS, on_sched)


def run_disagg(cfg, params, device, on_sched=None, trace=DISAGG_TRACE):
    return run_trace(cfg, params, device, DISAGG_SERVE, DISAGG_SCHED,
                     trace, None, on_sched)


def cpu_reuse(codec: str = "int8") -> tuple[dict, dict]:
    """The reuse phase's trace through the port on the CPU at the smoke
    config under ``codec``: its schedule (admission matching reads only the
    trace's tokens) and the rows each resource moved."""
    eng, sched, _, _ = run_reuse(*_smoke_cpu(), "cpu", codec=codec)
    return reuse_schedule(eng, sched), reuse_rows(eng)


def cpu_reuse_schedule() -> dict:
    return cpu_reuse()[0]


def cpu_disagg_schedule(trace=DISAGG_TRACE) -> dict:
    """The disaggregation phase's schedule (over ``trace``) from the port
    on the CPU at the smoke config: no step depends on a sampled token's
    value."""
    eng, sched, _, _ = run_disagg(*_smoke_cpu(), "cpu", trace=trace)
    return disagg_schedule(eng, sched)


def kv_integers(eng) -> dict:
    """The kv resource's integer telemetry, bytes as wire rows, with its
    placement table and θ trace."""
    h = eng.daemon["kv"]
    row = eng.tier_stats()["kv"]
    out = {k: int(row[k]) for k in ("fast_reads", "slow_reads", "promoted",
                                    "demoted", "ping_pong", "migration_epochs")}
    out.update({k: _pages(int(row[k]), h.mem.row_bytes)
                for k in ("migration_bytes", "flush_bytes")})
    out["page_slot"] = h.state.tier.page_slot.cpu().tolist()
    out["theta"] = [int(t) for t in h.stats.theta_trace]
    return out


def run_fill(cfg, params, device) -> tuple:
    """PHASE fill's drive on ``device``: the single request, then the lane
    trace.  Returns ({"single": kv integers, "lanes": schedule and kv
    integers}, both engines, the lane scheduler, its trace)."""
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    eng = ServeEngine(cfg, params, ServeConfig(**FILL_SINGLE), device=device)
    b, n, new = FILL_PROMPT
    tokens = eng.generate(np.random.default_rng(0).integers(0, cfg.vocab, (b, n)),
                          new)
    if not (tokens.shape == (b, new) and (tokens >= 0).all()
            and (tokens < cfg.vocab).all()):
        raise AssertionError(f"fill: tokens of shape {tokens.shape} or out of "
                             f"the vocabulary")
    lane_eng, sched, trace, _ = run_trace(cfg, params, device, FILL_LANES, LANE_SCHED,
                                      FILL_TRACE, LANE_TENANTS)
    return ({"single": kv_integers(eng),
             "lanes": dict(lane_schedule(sched), kv=kv_integers(lane_eng))},
            [eng, lane_eng], sched, trace)


def cpu_fill() -> dict:
    """PHASE fill's integers from the port on the CPU at the smoke config."""
    return run_fill(*_smoke_cpu(), "cpu")[0]


def run_moe_lanes(cfg, params, device, on_sched=None, phase="moe", async_=False,
                  trace=MOE_TRACE):
    """PHASE moe's (or mla's) lane drive: the lane configuration with the
    experts and embeddings resources over PHASE fill's cut of the lane trace
    (or ``trace``); ``async_`` serves it on the asynchronous plane."""
    serve = dict(MOE_PHASES[phase]["lanes"], async_migration=async_)
    return run_trace(cfg, params, device, serve, LANE_SCHED, trace, LANE_TENANTS,
                     on_sched)


def cpu_moe_lane_schedule(phase="moe", async_=False, trace=MOE_TRACE) -> dict:
    """PHASE moe's (or mla's; with ``async_`` and ``ASYNC_TRACE``, PHASE
    async's) lane schedule from the port on the CPU at the arch's smoke
    config: no scheduling decision reads a token's value."""
    _, sched, _, _ = run_moe_lanes(*_smoke_cpu(MOE_PHASES[phase]["arch"]), "cpu",
                                   phase=phase, async_=async_, trace=trace)
    return lane_schedule(sched)


def check_lane_steps(eng, checked) -> None:
    """Every lane step of ``eng`` must return finite logits and, for its
    active lanes, page mass summing to 1 (no mass at all on an arch without
    a ring); every chunk finite logits."""
    advance, prefill_lane = eng.advance_lanes, eng.prefill_lane

    def checked_advance(tokens, active, segments):
        logits = advance(tokens, active, segments)
        act = np.asarray(active, bool)
        if eng._paged_entry() is None:
            sums, unit = [], eng._last_kv_mass is None
        else:
            sums = eng._last_kv_mass.sum(dim=1).cpu().numpy()[act]
            unit = bool((np.abs(sums - 1) < 1e-4).all())
        if not (np.isfinite(logits).all() and unit):
            raise AssertionError(f"lane step: non-finite logits, or page mass "
                                 f"sums {list(sums)} != 1 (or mass without a ring)")
        checked["steps"] += 1
        return logits

    def checked_prefill(lane, tokens, segment, chunk=None):
        logits = prefill_lane(lane, tokens, segment, chunk)
        if not np.isfinite(logits).all():
            raise AssertionError("lane chunk: non-finite logits")
        checked["chunks"] += 1
        return logits
    eng.advance_lanes, eng.prefill_lane = checked_advance, checked_prefill


def zero_counts(counters) -> None:
    for c in counters:
        c.launches = 0


def read_counts(torch, counters, phase: str, required=None) -> dict:
    """Every counter's launches; each kernel of ``required`` (default: all)
    must have launched."""
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    if not all(c.launches for c in (counters if required is None else required)):
        raise AssertionError(f"a kernel never launched in PHASE {phase}: {launches}")
    return launches


def print_serving(rep, wall_s, phase, smi) -> None:
    decode_s = rep["clock"]["decode_s"]
    print(f"{phase}: {rep['steps']} scheduler steps in {wall_s:.2f} s wall; "
          f"{rep['completed']} requests, {rep['tokens']} tokens, "
          f"{rep['tokens'] / decode_s:.2f} tokens/s on the decode clock "
          f"({decode_s:.2f} s; prefill clock {rep['clock']['prefill_s']:.2f} s, "
          f"hand-off clock {rep['clock']['handoff_s']:.2f} s) on {smi}")
    print(f"{phase}: TTFT p50 {rep['ttft_ms']['p50']:.1f} ms, p99 "
          f"{rep['ttft_ms']['p99']:.1f} ms; TPOT p50 {rep['tpot_ms']['p50']:.1f} ms, "
          f"p99 {rep['tpot_ms']['p99']:.1f} ms; {rep['preemptions']} preemption(s); "
          "kv hit rate " + ", ".join(f"{n} {t['kv_hit_rate']:.3f}"
                                     for n, t in rep["tenants"].items())
          + f" on {smi}")
    for name, row in rep["resources"].items():
        print(f"{phase}: {name} tier_stats " + json.dumps(
            {k: v for k, v in row.items() if isinstance(v, int)}) + f" on {smi}")


def check_report(rep, reqs, n_arrivals, vocab) -> None:
    if not (rep["completed"] == rep["submitted"] == n_arrivals
            and rep["tokens"] == sum(len(r.out) for r in reqs)):
        raise AssertionError(f"report does not add up: {rep}")
    for r in reqs:
        if len(r.out) != r.max_new or not all(0 <= t < vocab for t in r.out):
            raise AssertionError(f"request {r.rid}: {len(r.out)} tokens of "
                                 f"{r.max_new}, or one out of the vocabulary")


def lanes_path(torch, counters, cfg, params, smi):
    """PHASE lanes: the multi-tenant trace at full width on the card."""
    from repro_torch.models import decode as dec
    checked = {"steps": 0, "chunks": 0}
    blocks = {}

    def instrument(sched):
        for name in ("kv", "embeddings"):
            blocks[name] = record_blocks(sched.eng.daemon[name])
        check_lane_steps(sched.eng, checked)
        zero_counts(counters)

    eng, sched, trace, wall_s = run_lanes(cfg, params, "cuda", instrument)
    launches = read_counts(torch, counters, "lanes")
    rep = sched.report()
    reqs = sched.finished
    check_report(rep, reqs, len(trace.arrivals), cfg.vocab)
    if not (rep["preemptions"] >= 1 and any(r.preemptions for r in reqs)):
        raise AssertionError("no request was preempted and resumed")
    res = rep["resources"]
    if not (res["kv"]["migration_bytes"] > 0 and res["kv"]["flush_bytes"] > 0
            and res["embeddings"]["migration_bytes"] > 0):
        raise AssertionError(f"no bytes moved: {res}")
    for name, recorded in blocks.items():
        replay_resource(torch, eng.daemon[name], recorded)
    print(f"lanes: sketch replay of {len(blocks['kv'])} kv and "
          f"{len(blocks['embeddings'])} embeddings blocks bitwise equal; "
          f"{checked['steps']} lane steps with finite logits and unit page mass")
    t0 = time.perf_counter()
    cpu = cpu_lane_schedule()
    card = lane_schedule(sched)
    if card != cpu:
        raise AssertionError(f"the card's schedule differs from the CPU's:\n"
                             f"{card}\n{cpu}")
    print(f"lanes: schedule equal to the CPU run at the smoke config "
          f"({time.perf_counter() - t0:.1f} s): {len(reqs)} requests, "
          f"{rep['steps']} steps, {rep['preemptions']} preemption(s)")
    gather_ms, dense_ms = embed_gather_ms(torch, dec, eng, params)
    print_serving(rep, wall_s, "lanes", smi)
    print("lanes: launches " + json.dumps(launches) + f" on {smi}")
    print(f"lanes: embedding gather through the placement table {gather_ms:.3f} ms "
          f"per step (4 tokens, wall, synchronised; dense table gather "
          f"{dense_ms:.3f} ms) on {smi}")
    return launches, rep


def fill_path(torch, counters, cfg, params, smi):
    """PHASE fill: kv_mass_source="fill" at full width on the card, every
    integer held to the CPU run at the smoke config."""
    zero_counts(counters)
    t0 = time.perf_counter()
    card, engines, sched, trace = run_fill(cfg, params, "cuda")
    wall_s = time.perf_counter() - t0
    launches = read_counts(torch, counters, "fill")
    if any(e._last_kv_mass is not None for e in engines):
        raise AssertionError("fill: the attention kernel exported page mass")
    rep = sched.report()
    check_report(rep, sched.finished, len(trace.arrivals), cfg.vocab)
    for arm in ("single", "lanes"):
        kv = card[arm]["kv"] if arm == "lanes" else card[arm]
        if not (kv["migration_bytes"] > 0 and kv["flush_bytes"] > 0):
            raise AssertionError(f"fill {arm}: no rows moved: {kv}")
    t0 = time.perf_counter()
    cpu = cpu_fill()
    if card != cpu:
        raise AssertionError(f"fill: the card's integers differ from the CPU's:\n"
                             f"{card}\n{cpu}")
    one, lanes = card["single"], card["lanes"]
    print(f"fill: integers equal to the CPU run at the smoke config "
          f"({time.perf_counter() - t0:.1f} s): single request {one['promoted']} "
          f"promoted, {one['migration_bytes']} rows migrated, {one['flush_bytes']} "
          f"flushed, hits {one['fast_reads']}/{one['fast_reads'] + one['slow_reads']}; "
          f"lanes {len(lanes['requests'])} requests in {lanes['steps']} steps, "
          f"{lanes['kv']['promoted']} promoted, {lanes['kv']['migration_bytes']} "
          f"rows migrated, {lanes['kv']['flush_bytes']} flushed, theta "
          f"{lanes['kv']['theta']}; no page mass exported")
    print(f"fill: both arms in {wall_s:.2f} s wall on {smi}")
    print("fill: launches " + json.dumps(launches) + f" on {smi}")
    return launches, rep


# -- PHASE dense: the full-cache serving mode against the paged ring ------------

SKETCH_COUNTERS = slice(1, 4)   # update, mark and histogram among the counters


def draw_dense_params(torch, arch, phase="dense", depth=None):
    """An arch at full width and depth (gemma2-27b's 54.5 GB of bf16
    weights fit the card with no cut) or cut to ``depth`` layers, random
    bf16 weights from seed 0."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_params
    cfg = get_config(arch)
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    n_bytes = sum(x.numel() * x.element_size() for x in _leaves(params))
    print(f"{phase}: {arch} full width (d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
          f"heads of {cfg.head_dim}, ff {cfg.d_ff}, vocab {cfg.vocab}), "
          f"{cfg.n_layers} layers of pattern {cfg.pattern}: {n_params / 1e9:.3f} B "
          f"params ({n_bytes / 1e9:.3f} GB) drawn in {time.perf_counter() - t0:.1f} s")
    return cfg, params


def drive_arm(torch, eng, prompts, new: int, feed=None, aux=None) -> dict:
    """One arm's single request: prefill (with ``aux`` for the cross
    blocks), then ``new - 1`` decode steps, greedy or, with ``feed`` ((B,
    new) tokens), fed those tokens.  Keeps every step's (B, V) logits (the prompt's last from
    prefill) and, on the ring, checks every step's page mass sums to 1."""
    from repro_torch.models import decode as dec
    caught, saved = [], {n: getattr(dec, n) for n in ("prefill_dense", "prefill_paged")}

    def capture(fn):
        def run(*a, **kw):
            out = fn(*a, **kw)
            caught.append(out[0])
            return out
        return run
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        for name, fn in saved.items():
            setattr(dec, name, capture(fn))
        eng.prefill(prompts, aux)
    finally:
        for name, fn in saved.items():
            setattr(dec, name, fn)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    logits = [caught[-1]]
    if feed is not None:
        feed = feed.to(eng.device)
    toks = [logits[0].argmax(-1) if feed is None else feed[:, 0]]
    t0 = time.perf_counter()
    for i in range(new - 1):
        logits.append(eng._advance(toks[-1][:, None])[:, -1])
        if eng._last_kv_mass is not None:
            sums = eng._last_kv_mass.sum(dim=1)
            if not bool(((sums - 1).abs() < 1e-4).all()):
                raise AssertionError(f"page mass sums {sums.tolist()} != 1")
        toks.append(logits[-1].argmax(-1) if feed is None else feed[:, i + 1])
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    return dict(logits=torch.stack(logits), tokens=torch.stack(toks, dim=1),
                prefill_s=prefill_s, decode_s=decode_s)


def profile_dense(torch, eng, tok, steps: int = 4, ranged=None,
                  phase="dense") -> None:
    """torch.profiler over ``steps`` dense decode steps: the device's busy
    share, its launches a step and the device time of one function inside a
    profiler range: ``ranged`` (module, name, label), by default the plain
    full-cache attention (``attention.dense_attend``)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import attention as attn
    mod, name, label = ranged or (attn, "dense_attend", "plain dense attention")
    plain = getattr(mod, name)

    def in_range(*a, **kw):
        with record_function(name):
            return plain(*a, **kw)
    torch.cuda.synchronize()
    setattr(mod, name, in_range)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                tok = eng.step(tok)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        setattr(mod, name, plain)
    # the range shows twice: on the host (its kernels' device time, summed
    # over its ops) and as a device-side span, which holds the idle gaps
    # between those kernels and is left out
    dev = [r for r in device_rows(torch, prof) if r[1] != name]
    busy_us = sum(t for t, _, _ in dev)
    launches = sum(count for _, _, count in dev)
    rng = [e for e in prof.events() if e.name == name
           and e.device_type == torch.autograd.DeviceType.CPU]
    range_us = sum(e.device_time_total for e in rng)
    calls = len(rng)
    print(f"{phase} profile: {eng.cfg.name} {steps} steps, wall "
          f"{wall_us / steps / 1e3:.2f} ms/step, device busy "
          f"{busy_us / steps / 1e3:.2f} ms/step ({100 * busy_us / wall_us:.1f}"
          f"% of wall), {launches / steps:.1f} device launches/step; {label} "
          f"{range_us / steps / 1e3:.3f} ms/step over {calls / steps:.0f} "
          f"calls/step ({100 * range_us / max(busy_us, 1e-9):.1f}% of busy)")


# the function each phase's dense-arm profile times inside a profiler range
PROFILE_RANGES = {"ssm": ("_recurrent_block", "recurrent blocks"),
                  "cross": ("_cross_step", "cross step (cross_apply and its gate)")}


def serve_arm(torch, counters, cfg, params, smi, arm, serve, prompts, new,
              feed=None, device="cuda", phase="dense", aux=None) -> dict:
    """One arm of PHASE dense (or ssm, cross) on one model: a fresh engine
    of ``serve`` serves ``prompts`` (with ``aux`` for the cross blocks) for
    ``new`` tokens, greedy or fed ``feed``; the sketch kernels must launch,
    the attention kernel only on a paged arm of an arch with a ring (the
    kv resource of an arch without one moves nothing), and the embeddings
    sketch replay bitwise on the CPU.  Prints the arm's figures and, for a
    dense arm, a 4-step profile.  Returns the drive (logits on the CPU),
    its launches, peak memory and embeddings stats."""
    from repro_torch.models import decode as dec
    from repro_torch.models.transformer import RECURRENT_KINDS
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    ring = any(k not in RECURRENT_KINDS for k in cfg.pattern)
    gc.collect()                       # the previous arm's engine and stores
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(cfg, params, ServeConfig(
        **dict(serve, resources=tuple(serve["resources"]))), device=device)
    blocks = record_blocks(eng.daemon["embeddings"])
    zero_counts(counters)
    run = drive_arm(torch, eng, prompts, new, feed, aux)
    attends = arm == "paged" and ring
    run["launches"] = read_counts(
        torch, counters, f"{phase} {cfg.name} {arm}",
        required=None if attends else counters[SKETCH_COUNTERS])
    if not attends and run["launches"]["paged_attention_raw"]:
        raise AssertionError(f"{phase} {cfg.name}: the {arm} arm launched the "
                             f"attention kernel: {run['launches']}")
    replay_resource(torch, eng.daemon["embeddings"], blocks)
    run["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    run["stats"] = eng.tier_stats()["embeddings"]
    if arm == "paged" and not ring:
        kv = eng.tier_stats()["kv"]
        if kv["fast_reads"] + kv["slow_reads"] or kv["migration_bytes"] \
                or kv["flush_bytes"]:
            raise AssertionError(f"{phase} {cfg.name}: the kv resource of an "
                                 f"arch without a ring moved: {kv}")
    b, n = prompts.shape
    steps = new - 1
    print(f"{phase}: {cfg.name} {arm} arm, {b} x {n} prompt tokens and {new} new"
          f"{'' if aux is None else f' over {aux.shape[1]} aux embeddings'}: "
          f"wall {run['prefill_s'] + run['decode_s']:.3f} s, prefill "
          f"{run['prefill_s']:.3f} s, decode {b * steps / run['decode_s']:.2f} "
          f"tokens/s, {1e3 * run['decode_s'] / steps:.2f} ms/step, embeddings "
          f"hit rate {run['stats']['hit_rate']:.3f}, peak device memory "
          f"{run['peak_gib']:.2f} GiB, launches {json.dumps(run['launches'])} "
          f"on {smi}")
    if arm == "dense":
        name, label = PROFILE_RANGES.get(phase, (None, None))
        profile_dense(torch, eng, run["tokens"][:, -1].cpu().numpy(),
                      ranged=None if name is None else (dec, name, label),
                      phase=phase)
    run["logits"] = run["logits"].cpu()
    run["aux"] = eng.aux
    return run


def hold_logits(torch, cfg, d, p, phase, what, exact=False) -> None:
    """Two runs' per-step logits ``d``, ``p`` (new, B, V) on the CPU: finite
    (within the final softcap where there is one), within DECODE_PARITY of
    each other (bitwise with ``exact``), greedy picks equal but at
    near-ties (a top-2 margin under DECODE_PARITY in either)."""
    if not (bool(torch.isfinite(d).all()) and bool(torch.isfinite(p).all())):
        raise AssertionError(f"{phase} {cfg.name}: non-finite logits")
    if cfg.final_softcap and max(float(d.abs().max()), float(p.abs().max())) \
            > cfg.final_softcap:
        raise AssertionError(f"{phase} {cfg.name}: logits past the final softcap")
    gap = float((d - p).abs().max())
    if gap > DECODE_PARITY or (exact and gap):
        raise AssertionError(f"{phase} {cfg.name}: {what} logits {gap} apart"
                             + (" (must be bitwise equal)" if exact else ""))

    def margin(x):
        top = x.topk(2, dim=-1).values
        return top[..., 0] - top[..., 1]
    near = (margin(d) < DECODE_PARITY) | (margin(p) < DECODE_PARITY)
    parted = d.argmax(-1) != p.argmax(-1)
    if bool((parted & ~near).any()):
        raise AssertionError(f"{phase} {cfg.name}: greedy tokens part away from a "
                             f"near-tie at (step, row) {parted.nonzero().tolist()}")
    ties = (parted & near).nonzero().tolist()
    print(f"{phase}: {cfg.name} logits of {what} within {gap:.4f} (bound "
          f"{DECODE_PARITY}) over {d.shape[0]} steps; greedy tokens equal"
          + (f" but at near-ties (step, row) {ties}" if ties else "")
          + f"; {int(near.sum())} of {near.numel()} picks had a top-2 margin under "
          f"{DECODE_PARITY}")


def dense_model(torch, counters, cfg, params, smi, device="cuda",
                phase="dense", aux=None) -> dict:
    """PHASE dense (or ssm, cross) on one model: the dense arm, then the
    paged arm fed its tokens (:func:`serve_arm`); their per-step logits
    within DECODE_PARITY of each other (bitwise equal on an arch without
    attention, whose arms run the same ops) and greedy tokens equal but at
    near-ties (:func:`hold_logits`).  Returns each arm's launches."""
    from repro_torch.models.transformer import RECURRENT_KINDS
    ring = any(k not in RECURRENT_KINDS for k in cfg.pattern)
    b, n, new = DENSE_PROMPT
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (b, n))
    dense = serve_arm(torch, counters, cfg, params, smi, "dense", DENSE_SERVE,
                      prompts, new, None, device, phase, aux)
    paged = serve_arm(torch, counters, cfg, params, smi, "paged", DENSE_PAGED,
                      prompts, new, dense["tokens"], device, phase, aux)
    hold_logits(torch, cfg, dense["logits"], paged["logits"], phase,
                "the two arms", exact=not ring)
    print(f"{phase}: {cfg.name} embeddings sketches of both arms replayed bitwise")
    return {"dense": dense["launches"], "paged": paged["launches"]}


def dense_path(torch, counters, models: dict, smi) -> dict:
    """PHASE dense: each DENSE_ARCHS model in turn, its params released
    before the next is drawn; ``models`` holds those already on the card
    (PHASE main's llama3.2-3b), which this releases too."""
    total = {c.__name__: 0 for c in counters}
    for arch in DENSE_ARCHS:
        t0 = time.perf_counter()
        cfg, params = models.pop(arch) if arch in models \
            else draw_dense_params(torch, arch)
        launches = dense_model(torch, counters, cfg, params, smi)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        for arm in launches.values():
            for k, v in arm.items():
                total[k] += v
        print(f"dense: {arch} ok in {time.perf_counter() - t0:.1f} s")
    print("dense: launches " + json.dumps(total) + f" on {smi}")
    return total


# -- PHASE ssm: zamba2-2.7b and xlstm-1.3b at full width, a third of their depth -

def held(torch, got, want, what) -> float:
    """``got`` (any device) within ATOL + RTOL*|want| of ``want`` (CPU);
    returns the max abs error."""
    got = got.cpu()
    if bool((~((got - want).abs() <= ATOL + RTOL * want.abs())).any()):
        raise AssertionError(f"{what} on the card differs from the CPU: max err "
                             f"{float((got - want).abs().max())}")
    return float((got - want).abs().max())


def ssm_layer_check(torch, cfg, params, device="cuda") -> dict:
    """(c) One block of each recurrent kind of ``cfg`` at full width, its
    group-0 weights in float32: SSM_LAYER_STEPS decode steps from the
    initial state on seeded inputs, on the card (TF32 off) against the same
    port function on the CPU; every output and state within ATOL +
    RTOL*|ref|.  Returns each kind's max error."""
    from repro_torch.models import decode as dec
    from repro_torch.models.transformer import RECURRENT_KINDS
    gen = torch.Generator().manual_seed(3)
    errs = {}
    for kind in dict.fromkeys(k for k in cfg.pattern if k in RECURRENT_KINDS):
        card = _tree_map(lambda v: v[0].float(), params["blocks"][cfg.pattern.index(kind)])
        host = _tree_map(lambda v: v.cpu(), card)
        states = {side: dec.recurrent_cache(cfg, kind, 2, dtype=torch.float32,
                                            device=dev)
                  for side, dev in (("card", device), ("host", "cpu"))}
        err = 0.0
        for step in range(SSM_LAYER_STEPS):
            x = torch.randn((2, 1, cfg.d_model), generator=gen)
            got = dec._recurrent_block(card, cfg, kind, x.to(device), states["card"])
            want = dec._recurrent_block(host, cfg, kind, x, states["host"])
            pairs = [("y", got, want)] + [(k, states["card"][k], states["host"][k])
                                          for k in states["host"]]
            for name, a, r in pairs:
                err = max(err, held(torch, a, r,
                                    f"ssm {cfg.name}: {kind} {name} at step {step}"))
        errs[kind] = err
        print(f"ssm: {cfg.name} one {kind} block at full width, {SSM_LAYER_STEPS} "
              f"float32 steps on the card against the CPU: max abs err {err:.3g} "
              f"(within {ATOL} + {RTOL}*|ref|, TF32 off)")
    return errs


def instrument_lane_verbs(torch, eng, seen) -> None:
    """Time each preemption and resume (synchronised wall ms) and check that
    a resumed lane's recurrent states and ring bookkeeping are bitwise what
    they were at its preemption; count each lane's resets (admissions)."""
    preempt, resume, reset = eng.preempt_lane, eng.resume_lane, eng.reset_lane
    snaps = {}

    def timed_preempt(lane):
        snap = [{k: v[:, lane].clone() for k, v in e.items()
                 if k not in ("k_pages", "v_pages")} for e in eng.cache["blocks"]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        residual = preempt(lane)
        torch.cuda.synchronize()
        seen["preempt_ms"].append((time.perf_counter() - t0) * 1e3)
        snaps[id(residual)] = snap
        return residual

    def timed_resume(lane, residual):
        snap = snaps.pop(id(residual))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = resume(lane, residual)
        torch.cuda.synchronize()
        seen["resume_ms"].append((time.perf_counter() - t0) * 1e3)
        for i, (entry, leaves) in enumerate(zip(eng.cache["blocks"], snap)):
            for k, v in leaves.items():
                if not torch.equal(entry[k][:, lane], v):
                    raise AssertionError(f"resumed lane {lane}: block {i} {k} differs "
                                         "from its state at preemption")
        return n

    def counted_reset(lane):
        seen["resets"][lane] = seen["resets"].get(lane, 0) + 1
        return reset(lane)
    eng.preempt_lane, eng.resume_lane, eng.reset_lane = (
        timed_preempt, timed_resume, counted_reset)


def ssm_lanes(torch, counters, arch, cfg, params, smi, device="cuda") -> dict:
    """(b) The lane phase's drive over SSM_LANE_TRACE on one arch: the
    lane phase's checks (report, finite logits, unit page mass where there
    is a ring, sketches replayed bitwise, bytes moved), a preempted request
    resumed with its states bitwise, a lane serving a second request, and
    the schedule equal to the CPU run at the arch's smoke config."""
    from repro_torch.models.transformer import RECURRENT_KINDS
    ring = any(k not in RECURRENT_KINDS for k in cfg.pattern)
    checked = {"steps": 0, "chunks": 0}
    seen = {"preempt_ms": [], "resume_ms": [], "resets": {}}
    blocks = {}

    def instrument(sched):
        for name in ("kv", "embeddings"):
            blocks[name] = record_blocks(sched.eng.daemon[name])
        check_lane_steps(sched.eng, checked)
        instrument_lane_verbs(torch, sched.eng, seen)
        zero_counts(counters)

    eng, sched, trace, wall_s = run_lanes(cfg, params, device, instrument,
                                          SSM_LANE_TRACE)
    launches = read_counts(torch, counters, f"ssm {cfg.name} lanes",
                           required=None if ring else counters[SKETCH_COUNTERS])
    if not ring and launches["paged_attention_raw"]:
        raise AssertionError(f"ssm {cfg.name} lanes: attention launched without a "
                             f"ring: {launches}")
    rep = sched.report()
    reqs = sched.finished
    check_report(rep, reqs, len(trace.arrivals), cfg.vocab)
    if not (rep["preemptions"] >= 1 and any(r.preemptions for r in reqs)
            and seen["resume_ms"]):
        raise AssertionError(f"ssm {cfg.name} lanes: no request was preempted and "
                             "resumed")
    if max(seen["resets"].values()) < 2:
        raise AssertionError(f"ssm {cfg.name} lanes: no lane served a second "
                             f"request: {seen['resets']}")
    res = rep["resources"]
    kv = res["kv"]
    moved = kv["migration_bytes"] > 0 and kv["flush_bytes"] > 0
    idle = not (kv["fast_reads"] + kv["slow_reads"] or kv["migration_bytes"]
                or kv["flush_bytes"])
    if not (res["embeddings"]["migration_bytes"] > 0 and (moved if ring else idle)):
        raise AssertionError(f"ssm {cfg.name} lanes: bytes moved {res}")
    for name, recorded in blocks.items():
        replay_resource(torch, eng.daemon[name], recorded)
    t0 = time.perf_counter()
    cpu = cpu_lane_schedule(arch, SSM_LANE_TRACE)
    card = lane_schedule(sched)
    if card != cpu:
        raise AssertionError(f"ssm {cfg.name}: the card's schedule differs from the "
                             f"CPU's:\n{card}\n{cpu}")
    print(f"ssm: {cfg.name} lanes: sketch replay of {len(blocks['kv'])} kv and "
          f"{len(blocks['embeddings'])} embeddings blocks bitwise equal; "
          f"{checked['steps']} lane steps with finite logits"
          + (" and unit page mass" if ring else " and no page mass")
          + f"; schedule equal to the CPU run at the smoke config "
          f"({time.perf_counter() - t0:.1f} s): {len(reqs)} requests, "
          f"{rep['steps']} steps, {rep['preemptions']} preemption(s), lane "
          f"admissions {json.dumps(seen['resets'])}")
    print(f"ssm: {cfg.name} lanes: {len(seen['preempt_ms'])} preemption(s) "
          f"{', '.join(f'{t:.1f}' for t in seen['preempt_ms'])} ms, "
          f"{len(seen['resume_ms'])} resume(s) "
          f"{', '.join(f'{t:.1f}' for t in seen['resume_ms'])} ms (wall, "
          f"synchronised), every resumed lane's states bitwise; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
          f"on {smi}")
    print_serving(rep, wall_s, f"ssm {cfg.name} lanes", smi)
    return launches


def ssm_path(torch, counters, smi, device="cuda") -> dict:
    """PHASE ssm: each SSM_ARCHS model in turn at full width, SSM_DEPTH, its
    params released before the next is drawn: (c) one layer of each
    recurrent kind against the CPU, (a) the dense and paged arms, (b) the
    lane drive."""
    total = {c.__name__: 0 for c in counters}
    for arch in SSM_ARCHS:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        cfg, params = draw_dense_params(torch, arch, phase="ssm",
                                        depth=SSM_DEPTH[arch])
        ssm_layer_check(torch, cfg, params, device)
        arms = dense_model(torch, counters, cfg, params, smi, device, phase="ssm")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        lanes = ssm_lanes(torch, counters, arch, cfg, params, smi, device)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        for run in (*arms.values(), lanes):
            for k, v in run.items():
                total[k] += v
        print(f"ssm: {arch} ok in {time.perf_counter() - t0:.1f} s")
    print("ssm: launches " + json.dumps(total) + f" on {smi}")
    return total


# -- PHASE cross: llama-3.2-vision-11b and whisper-base at full width and depth --

def cross_aux(torch, cfg, batch: int, device="cuda"):
    """The request's (batch, n_aux_tokens, d) bf16 patch or frame
    embeddings, standard normal from seed 0 (the reference's frontends are
    stubs that hand over such embeddings)."""
    gen = torch.Generator(device=device).manual_seed(0)
    return torch.randn((batch, cfg.n_aux_tokens, cfg.d_model), generator=gen,
                       device=device).to(torch.bfloat16)


def cross_layer_check(torch, cfg, params, device="cuda") -> dict:
    """(c) At full width in float32, the card (TF32 off) against the same
    port function on the CPU, within ATOL + RTOL*|ref|: CROSS_LAYER_STEPS
    decode steps of the arch's first ``cross`` or ``dec`` block (group 0's
    weights; a ``cross`` block's gate set to CROSS_GATE, so that the image
    counts, which the card's step shows against the gate at 0) over a
    seeded (2, n_aux_tokens, d) stream and, for an encoder arch, the whole
    ``encode`` of a seeded (2, n_aux_tokens, d) input.  Returns the max
    errors."""
    from repro_torch.models import decode as dec
    from repro_torch.models.transformer import encode
    gen = torch.Generator().manual_seed(4)
    kind = next(k for k in cfg.pattern if k in ("cross", "dec"))
    card = _tree_map(lambda v: v[0].float(), params["blocks"][cfg.pattern.index(kind)])
    if kind == "cross":
        card["xgate"] = torch.full_like(card["xgate"], CROSS_GATE)
    host = _tree_map(lambda v: v.cpu(), card)
    src = torch.randn((2, cfg.n_aux_tokens, cfg.d_model), generator=gen)
    caches = {side: dec._block_cache(cfg, kind, 2, CROSS_LAYER_STEPS, torch.float32,
                                     dev) for side, dev in (("card", device), ("host", "cpu"))}
    errs = {kind: 0.0}
    for step in range(CROSS_LAYER_STEPS):
        x = torch.randn((2, 1, cfg.d_model), generator=gen)
        pos = torch.tensor(step, dtype=torch.int32)
        got = dec._decode_attn_block(card, cfg, kind, x.to(device), caches["card"],
                                     pos.to(device), kv_src=src.to(device))
        want = dec._decode_attn_block(host, cfg, kind, x, caches["host"], pos,
                                      kv_src=src)
        errs[kind] = max(errs[kind], held(torch, got, want,
                                          f"cross {cfg.name}: {kind} step {step}"),
                         *(held(torch, caches["card"][k], caches["host"][k],
                                f"cross {cfg.name}: {kind} cache {k}")
                           for k in ("k", "v")))
        if step == 0 and kind == "cross":
            shut = dict(card, xgate=torch.zeros_like(card["xgate"]))
            moved = float((got - dec._decode_attn_block(
                shut, cfg, kind, x.to(device), caches["card"], pos.to(device),
                kv_src=src.to(device))).abs().max())
            if not moved > 0:
                raise AssertionError(f"cross {cfg.name}: the gated image moved nothing")
    print(f"cross: {cfg.name} one {kind} block at full width over {cfg.n_aux_tokens} "
          f"aux embeddings, {CROSS_LAYER_STEPS} float32 steps on the card against the "
          f"CPU: max abs err {errs[kind]:.3g} (within {ATOL} + {RTOL}*|ref|, TF32 off)"
          + (f"; gate {CROSS_GATE}: the image moves the block's output by "
             f"{moved:.3g}" if kind == "cross" else ""))
    if cfg.encoder_layers:
        enc = {"encoder": [_tree_map(lambda v: v.float(), lp) for lp in params["encoder"]],
               "enc_norm": params["enc_norm"]}
        x = torch.randn((2, cfg.n_aux_tokens, cfg.d_model), generator=gen)
        errs["encode"] = held(torch, encode(cfg, enc, x.to(device)),
                              encode(cfg, _tree_map(lambda v: v.cpu(), enc), x),
                              f"cross {cfg.name}: encode")
        print(f"cross: {cfg.name} encode ({cfg.encoder_layers} layers) at full width "
              f"over {cfg.n_aux_tokens} frames in float32 on the card against the "
              f"CPU: max abs err {errs['encode']:.3g} (within {ATOL} + {RTOL}*|ref|)")
    return errs


def cpu_run(torch, cfg, params, prompts, new, feed, aux) -> dict:
    """The dense arm's request served by the port on the CPU (an engine of
    DENSE_SERVE over the weights copied there), fed the card's tokens."""
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    eng = ServeEngine(cfg, _tree_map(lambda v: v.cpu(), params), ServeConfig(
        **dict(DENSE_SERVE, resources=tuple(DENSE_SERVE["resources"]))), device="cpu")
    run = drive_arm(torch, eng, prompts, new, feed.cpu(), aux.cpu())
    run["aux"] = eng.aux
    return run


def encoder_model(torch, counters, cfg, params, smi, aux, device="cuda") -> dict:
    """PHASE cross (a) on an encoder arch: the dense arm on the card with
    :func:`serve_arm`'s checks, then the same request on the CPU fed its
    tokens (:func:`cpu_run`): the encoder's output and every step's logits
    within DECODE_PARITY, greedy tokens equal but at near-ties.  There is
    no paged arm: the reference's paged path drops cross attention
    (ROADMAP C6).  Returns the dense arm's launches."""
    b, n, new = DENSE_PROMPT
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (b, n))
    dense = serve_arm(torch, counters, cfg, params, smi, "dense", DENSE_SERVE,
                      prompts, new, None, device, "cross", aux)
    t0 = time.perf_counter()
    host = cpu_run(torch, cfg, params, prompts, new, dense["tokens"], aux)
    err = float((dense["aux"].cpu().float() - host["aux"].float()).abs().max())
    if not err <= DECODE_PARITY:
        raise AssertionError(f"cross {cfg.name}: the encoder's output on the card is "
                             f"{err} from the CPU's")
    print(f"cross: {cfg.name} encoder output {tuple(host['aux'].shape)} on the card "
          f"within {err:.4f} of the CPU's (bound {DECODE_PARITY}); CPU run "
          f"{time.perf_counter() - t0:.1f} s")
    hold_logits(torch, cfg, dense["logits"], host["logits"], "cross",
                "the card and the CPU")
    return {"dense": dense["launches"]}


def cross_path(torch, counters, smi, device="cuda") -> dict:
    """PHASE cross: each CROSS_ARCHS model in turn at full width and depth,
    its params released before the next is drawn: (c) the cross block (and
    the encoder) against the CPU, (a) PHASE dense's arms over the request's
    aux embeddings, or for whisper the dense arm against a CPU run."""
    total = {c.__name__: 0 for c in counters}
    for arch in CROSS_ARCHS:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        cfg, params = draw_dense_params(torch, arch, phase="cross")
        cross_layer_check(torch, cfg, params, device)
        aux = cross_aux(torch, cfg, DENSE_PROMPT[0], device)
        arms = (encoder_model(torch, counters, cfg, params, smi, aux, device)
                if cfg.encoder_layers else
                dense_model(torch, counters, cfg, params, smi, device, "cross", aux))
        del params, aux
        gc.collect()
        torch.cuda.empty_cache()
        for run in arms.values():
            for k, v in run.items():
                total[k] += v
        print(f"cross: {arch} ok in {time.perf_counter() - t0:.1f} s")
    print("cross: launches " + json.dumps(total) + f" on {smi}")
    return total


# -- PHASE moe: kimi-k2 with the experts resource -------------------------------

MOE_TOL = 2 ** -6       # tiered vs dense MoE layer: max |diff| <= this * max |dense|


def draw_moe_params(torch, phase="moe"):
    """The phase's arch at full width, depth cut to the phase's depth (its
    dense prologue layers and one MoE layer), random bf16 weights from
    seed 0 (deepseek-v3's multi-token head is drawn and never run)."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_params
    spec = MOE_PHASES[phase]
    cfg = dataclasses.replace(get_config(spec["arch"]), n_layers=spec["depth"])
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    attn = (f"MLA q_lora {cfg.mla.q_lora} / kv_lora {cfg.mla.kv_lora} / d_nope "
            f"{cfg.mla.d_nope} / d_rope {cfg.mla.d_rope} / d_v {cfg.mla.d_v}"
            if cfg.mla else f"heads of {cfg.head_dim}")
    print(f"{phase}: {cfg.name} full width (d {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads, {attn}, vocab {cfg.vocab}, {cfg.moe.n_experts} "
          f"experts top-{cfg.moe.top_k} of ff {cfg.moe.expert_ff}, prologue ff "
          f"{cfg.moe.dense_ff}), depth cut to {cfg.moe.n_dense_prologue} dense + "
          f"{cfg.n_groups} MoE layer(s): {n_params / 1e9:.3f} B params bf16 drawn "
          f"in {time.perf_counter() - t0:.1f} s")
    return cfg, params


def record_feed(daemon, names) -> list:
    """Record what the resources ``names`` of ``daemon`` take, in order:
    every observed block (resource, pages, touch pages) and every daemon
    tick's promotion batches."""
    log = []
    tick = daemon.tick

    def observing(name, observe):
        def recorded(state, pages, *, touch_pages=None, **kw):
            log.append(("observe", name, pages.cpu(),
                        None if touch_pages is None else touch_pages.cpu()))
            return observe(state, pages, touch_pages=touch_pages, **kw)
        return recorded

    def ticking():
        events = tick()
        log.append(("tick", {n: None if n not in events else
                             [x.cpu() for x in (events[n].promoted, events[n].victims,
                                                events[n].evicted)]
                             for n in names}))
        return events
    for name in names:
        daemon[name].mem.observe = observing(name, daemon[name].mem.observe)
    daemon.tick = ticking
    return log


def record_experts(eng, n_experts: int, names=("experts",)) -> list:
    """``record_feed`` of the engine's daemon; each raw router id must be an
    expert or -1."""
    h = eng.daemon["experts"]
    encode = h.resource.encode_stream

    def encoding(router):
        r = router.cpu()
        if not bool((((r >= 0) & (r < n_experts)) | (r == -1)).all()):
            raise AssertionError(f"router ids outside [0, {n_experts}) and -1")
        return encode(router)
    h.resource.encode_stream = encoding
    return record_feed(eng.daemon, names)


def record_epochs(eng) -> dict:
    """Record, per resource, the daemon tick at which each async epoch was
    issued and at which it committed (a commit at the COMMIT phase of a
    tick, when the card's token was ready; the forced commits of
    ``finalize`` are not ticks and are not recorded)."""
    epochs = {}
    for name, h in eng.daemon.resources.items():
        rec = epochs[name] = {"issued": [], "committed": []}
        issue, commit = h.mem.issue_migration, h.mem.commit_migration

        def issuing(state, event, stats, _issue=issue, _rec=rec):
            moved = _issue(state, event, stats)
            _rec["issued"].append(eng.daemon._tick)
            return moved

        def committing(stats, block=False, _mem=h.mem, _commit=commit, _rec=rec):
            was = _mem.busy
            moved = _commit(stats, block=block)
            if was and not _mem.busy and not block:
                _rec["committed"].append(eng.daemon._tick)
            return moved
        h.mem.issue_migration, h.mem.commit_migration = issuing, committing
    return epochs


def replay_feed(torch, daemon, log, names, epochs=None, reads=False):
    """The recorded feed (:func:`record_feed`) of the resources ``names``
    through a fresh CPU daemon of the port that holds them alone (placement
    only): every promotion batch, the placement tables, the θ traces, the
    promotion, demotion and ping-pong counts (with ``reads`` the hit counts
    too) and the sketches must equal the card's, and the card must have
    moved exactly the rows the batches name.  The daemon's budget is the sum
    of its resources' quotas, so each resource's share is its own demand
    capped by its quota whatever the others ask, and these resources alone
    replay a daemon of more.  Under the async plane (``epochs`` from
    :func:`record_epochs`, the card's daemon finalized) each replayed
    resource binds a payload of one-byte rows, so that it runs the async
    plane, and its commit probe is patched to commit each epoch at the tick
    at which the card's did.  Returns (the CPU daemon, rows moved up and
    down per resource, promotion batches per resource)."""
    import copy
    import dataclasses
    from repro_torch.tiering.daemon import NeoMemDaemon
    cpu = NeoMemDaemon(daemon.dp, device="cpu")
    for name in names:
        h = daemon[name]
        res = copy.copy(h.resource)
        res.spec = dataclasses.replace(res.spec, row_shape=None)
        ch = cpu.register(res, seeds=h.state.prof.sketch.seeds.cpu())
        if epochs is not None:
            ch.bind_data(torch.zeros((res.spec.n_pages, 1), dtype=torch.uint8))
            ready_at, commit = set(epochs[name]["committed"]), ch.mem.commit_migration

            def at_card_ticks(stats, block=False, _at=ready_at, _commit=commit):
                if block or cpu._tick in _at:
                    return _commit(stats, block=True)
                return 0
            ch.mem.commit_migration = at_card_ticks
    rows = {n: 0 for n in names}
    batches = {n: 0 for n in names}
    for kind, *rest in log:
        if kind == "observe":
            name, pages, touch = rest
            if name in names:
                ch = cpu[name]
                ch.state = ch.mem.observe(ch.state, pages, touch_pages=touch)
            continue
        events = cpu.tick()
        for name in names:
            ev, want = events.get(name), rest[0][name]
            got = None if ev is None else [ev.promoted, ev.victims, ev.evicted]
            if (got is None) != (want is None) or (got is not None and not all(
                    torch.equal(a.to(torch.int64), b.to(torch.int64))
                    for a, b in zip(got, want))):
                raise AssertionError(f"{name}: promotion batch at tick {cpu._tick} "
                                     f"differs from the CPU replay: {want} vs {got}")
            if got is not None:
                up = (ev.promoted >= 0) & (ev.victims >= 0)
                rows[name] += int(up.sum()) + int((up & (ev.evicted >= 0)).sum())
                batches[name] += 1
    cpu.finalize()
    card, replayed = daemon.snapshot(), cpu.snapshot()
    counts = ("promoted", "demoted", "ping_pong") + (
        ("fast_reads", "slow_reads") if reads else ())
    for name in names:
        h, ch = daemon[name], cpu[name]
        for field in ("page_slot", "slot_page"):
            if not torch.equal(getattr(ch.state.tier, field),
                               getattr(h.state.tier, field).cpu()):
                raise AssertionError(f"{name}: {field} differs from the CPU replay")
        if ch.stats.theta_trace != h.stats.theta_trace:
            raise AssertionError(f"{name}: θ trace {h.stats.theta_trace} vs "
                                 f"{ch.stats.theta_trace} on the CPU")
        got, want = ({k: row[name][k] for k in counts} for row in (card, replayed))
        if got != want:
            raise AssertionError(f"{name}: counts {got} vs {want} on the CPU")
        for field in ("counts", "epochs", "hot", "cur_epoch", "n_seen"):
            if not torch.equal(getattr(ch.state.prof.sketch, field),
                               getattr(h.state.prof.sketch, field).cpu()):
                raise AssertionError(f"{name}: sketch {field} differs from the CPU "
                                     "replay")
        moved = card[name]["migration_bytes"]
        if moved != rows[name] * h.mem.row_bytes or (
                epochs is not None and ch.stats.migration_epochs
                != card[name]["migration_epochs"]):
            raise AssertionError(f"{name}: {moved} B moved in "
                                 f"{card[name]['migration_epochs']} epochs for "
                                 f"{rows[name]} rows of {h.mem.row_bytes} B")
    return cpu, rows, batches


def replay_experts(torch, eng, log, names=("experts",), epochs=None) -> dict:
    """:func:`replay_feed` of the engine's daemon, whose expert rows must be
    the layer's [w_gate | w_in | w_out] in bf16."""
    cpu, rows, batches = replay_feed(torch, eng.daemon, log, names, epochs)
    h = eng.daemon["experts"]
    if h.mem.row_bytes != 3 * eng.cfg.d_model * eng.cfg.moe.expert_ff * 2:
        raise AssertionError(f"experts: rows of {h.mem.row_bytes} B")
    return {"blocks": sum(e[:2] == ("observe", "experts") for e in log),
            "epochs": batches["experts"], "rows": rows["experts"],
            "promoted": int((cpu["experts"].state.tier.slot_page >= 0).sum()),
            "theta": list(h.stats.theta_trace)}


def check_expert_rows(torch, eng) -> int:
    """Every resident expert's fast row equals its slow row bitwise (a page
    past the store holds the store's last row, ROADMAP C4)."""
    h = eng.daemon["experts"]
    buf, slot_page = h.mem.buffers, h.state.tier.slot_page.cpu()
    n = buf.slow.shape[0]
    resident = torch.nonzero(slot_page >= 0).reshape(-1).tolist()
    for slot in resident:
        page = min(int(slot_page[slot]), n - 1)
        if not torch.equal(buf.fast[slot], buf.slow[page].to(buf.fast.device)):
            raise AssertionError(f"experts: fast slot {slot} differs from slow "
                                 f"page {page}")
    return len(resident)


def check_tiered_layer(torch, eng, params, seeds=range(32)) -> tuple:
    """The MoE layer read through the placement table against the same
    layer over the dense weights, on an x whose top-8 reads both tiers."""
    from repro_torch.models import moe
    cfg = eng.cfg
    p = {k: v[0] for k, v in params["blocks"][0]["ffn"].items()}
    bias = params["blocks"][0]["router_bias"][0]
    view, e = eng._tier_reads()["experts"], cfg.moe.n_experts
    for seed in seeds:
        gen = torch.Generator(device=eng.device).manual_seed(seed)
        x = torch.randn((2, 1, cfg.d_model), generator=gen,
                        device=eng.device).to(torch.bfloat16)
        _, idx, _ = moe.router_topk(p, x, cfg.moe.top_k, bias=bias)
        hit = view["page_slot"][idx.long()] >= 0
        if bool(hit.any()) and not bool(hit.all()):
            break
    else:
        raise AssertionError("no x reads both tiers")
    tiered, ti, _ = moe.moe_apply_tiered(p, x, cfg.moe.top_k, bias=bias, tier=view,
                                         group_id=0)
    dense, di, _ = moe.moe_apply_ep(p, x, cfg.moe.top_k, bias=bias)
    err = float((tiered.float() - dense.float()).abs().max())
    scale = float(dense.float().abs().max())
    if not (torch.equal(ti, di) and err <= MOE_TOL * scale):
        raise AssertionError(f"tiered MoE layer differs from the dense one: max "
                             f"|diff| {err} against {MOE_TOL} * {scale}")
    return int(hit.sum()), int(hit.numel()), err, scale


def slow_row_ms(torch, eng, n: int = 8, reps: int = 5) -> float:
    """Wall ms per expert row read from the pinned slow store on a miss
    (one read of ``n`` distinct non-resident experts, synchronised)."""
    h = eng.daemon["experts"]
    cold = torch.nonzero(h.state.tier.page_slot < 0).reshape(-1)[:n]
    view = h.tier_view()
    from repro_torch.tiering.migrate import lookup_rows
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lookup_rows(view["fast"], view["slow"], view["page_slot"], cold)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / cold.numel())
    return statistics.median(times)


def pinned_bytes(eng) -> int:
    return sum(h.mem.buffers.slow.nbytes for h in eng.daemon.resources.values()
               if h.mem.buffers.slow.is_pinned())


def check_every_step(torch, eng, phase) -> None:
    """Every decode step of ``eng`` must return finite logits and page mass
    summing to 1."""
    advance = eng._advance

    def checked(tok):
        logits = advance(tok)
        sums = eng._last_kv_mass.sum(dim=1)
        if not (bool(torch.isfinite(logits).all())
                and bool(((sums - 1).abs() < 1e-4).all())):
            raise AssertionError(f"{phase}: non-finite logits or page mass sums "
                                 f"{sums.tolist()} != 1")
        return logits
    eng._advance = checked


def count_slow_rows(torch, eng, seen) -> callable:
    """Count in ``seen["rows"]`` the expert rows the engine reads from the
    slow tier (each distinct missed id of a read once, as ``read_rows``
    reads them); returns the function that stops the count."""
    from repro_torch.tiering import migrate
    fast, read = eng.daemon["experts"].mem.buffers.fast, migrate.read_rows

    def counting(f, slow, slots, page_ids, scale=None):
        if f is fast:
            miss = (slots.reshape(-1) < 0).to(page_ids.device)
            seen["rows"] += int(torch.unique(page_ids.reshape(-1)[miss]).numel())
        return read(f, slow, slots, page_ids, scale=scale)
    migrate.read_rows = counting

    def stop():
        migrate.read_rows = read
    return stop


def epoch_ticks(epochs) -> dict:
    """Per resource: epochs issued, committed at the first tick after their
    issue, committed later, and left to ``finalize``."""
    out = {}
    for name, rec in epochs.items():
        lags = [c - i for i, c in zip(rec["issued"], rec["committed"])]
        out[name] = {"issued": len(rec["issued"]), "first_tick": lags.count(1),
                     "deferred": sum(lag > 1 for lag in lags),
                     "finalized": len(rec["issued"]) - len(lags)}
    return out


def overlap_line(stats, decode_s) -> str:
    return "; ".join(
        f"{n} stall {1e3 * r['stall_s']:.1f} ms over {r['migration_epochs']} epochs, "
        f"overlap {r['overlap_bytes_per_decode_s'] / 1e9:.3f} GB per decode s"
        for n, r in stats.items()) + f" (decode clock {decode_s:.3f} s)"


def moe_single(torch, counters, cfg, params, smi, device="cuda", phase="moe",
               sync=None) -> dict:
    """PHASE moe (a), or mla's: serve_bench.py's kimi-k2 case at full width.
    With ``sync`` (this function's result for the synchronous plane) it is
    PHASE async's arm (a) on the asynchronous plane, held to it, and then
    its checkpoint round trip (c)."""
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    arm = phase if sync is None else "async"
    t0 = time.perf_counter()
    single = dict(MOE_PHASES[phase]["single"], async_migration=sync is not None)
    eng = ServeEngine(cfg, params, ServeConfig(
        **dict(single, resources=tuple(single["resources"]))), device=device)
    torch.cuda.synchronize()
    bind_s = time.perf_counter() - t0
    names = ("experts", "embeddings", "kv") if sync is not None else ("experts",)
    log = record_experts(eng, cfg.moe.n_experts, names)
    epochs = record_epochs(eng) if sync is not None else None
    blocks = {n: record_blocks(eng.daemon[n]) for n in ("kv", "embeddings")}
    check_every_step(torch, eng, arm)
    b, n, new = MOE_PROMPT
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (b, n))
    zero_counts(counters)
    t0 = time.perf_counter()
    tok = eng.prefill(prompts)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    out, slow_rows = [tok], {"rows": 0}
    stop = count_slow_rows(torch, eng, slow_rows)
    t0 = time.perf_counter()
    for _ in range(new - 1):
        tok = eng.step(tok)
        out.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    stop()
    tokens = np.stack(out, axis=1)
    if not (tokens.shape == (b, new) and (tokens >= 0).all()
            and (tokens < cfg.vocab).all()):
        raise AssertionError(f"{arm}: tokens of shape {tokens.shape} or out of the "
                             "vocabulary")
    if sync is not None and not np.array_equal(tokens, sync["tokens"]):
        raise AssertionError(f"async: tokens differ from the synchronous arm's:\n"
                             f"{tokens}\n{sync['tokens']}")
    # one more step (its logits and page mass checked as every step's): its
    # daemon tick is the drive's first Algorithm-1 update (the histogram's
    # launch)
    eng._advance(torch.as_tensor(tok, device=device)[:, None])
    launches = read_counts(torch, counters, arm)
    served = eng.tier_stats()
    if sync is not None:
        eng.daemon.finalize()          # the end-of-run accounting barrier
        left = {n: r["inflight_bytes"] for n, r in eng.tier_stats().items()}
        if any(left.values()):
            raise AssertionError(f"async: bytes in flight after finalize: {left}")
    for name, recorded in blocks.items():
        replay_resource(torch, eng.daemon[name], recorded)
    placement = replay_experts(torch, eng, log, names, epochs)
    resident = check_expert_rows(torch, eng)
    hits, reads, err, scale = check_tiered_layer(torch, eng, params)
    stats = eng.tier_stats()
    if sync is not None:
        flush = {k: (stats[k]["flush_bytes"], sync["stats"][k]["flush_bytes"])
                 for k in stats}
        if any(a != c for a, c in flush.values()):
            raise AssertionError(f"async: flush bytes differ from the synchronous "
                                 f"arm's: {flush}")
    print(f"{arm}: single request, {b} x {n} prompt tokens and {new} new: bound the "
          f"stores in {bind_s:.1f} s; prefill {prefill_s:.3f} s, decode "
          f"{b * (new - 1) / decode_s:.2f} tokens/s, {1e3 * decode_s / (new - 1):.2f} "
          f"ms/step on {smi}")
    what = ("experts'" if sync is None else
            "tokens equal to the synchronous arm's; every resource's")
    print(f"{arm}: sketches of kv and embeddings replayed bitwise; {what} "
          f"{placement['blocks']} blocks through a CPU daemon: {placement['epochs']} "
          f"promotion batches, {placement['rows']} rows moved, θ {placement['theta']} "
          f"all equal; {resident} resident expert rows equal their slow rows")
    if sync is not None:
        print(f"async: epochs issued and committed at the daemon's ticks "
              f"{json.dumps(epochs)}: {json.dumps(epoch_ticks(epochs))}; flush bytes "
              f"equal to the synchronous arm's; no byte in flight after finalize")
    print(f"{arm}: tiered MoE layer against the dense one: {hits} of {reads} reads "
          f"fast, max |diff| {err:.4g} (limit {MOE_TOL} x {scale:.4g})")
    for name in ("experts", "embeddings", "kv"):
        row = stats[name]
        print(f"{arm}: {name} hit rate {row['hit_rate']:.3f}, migration "
              f"{row['migration_bytes']} B, flush {row['flush_bytes']} B "
              f"on {smi}")
    print(f"{arm}: while serving, {overlap_line(served, eng._decode_s)}; the "
          f"{new - 1} decode steps read {slow_rows['rows']} expert rows from the "
          f"slow tier on {smi}")
    if sync is not None:
        print(f"async: after finalize, {overlap_line(stats, eng._decode_s)} on {smi}")
    print(f"{arm}: slow expert row read {slow_row_ms(torch, eng):.3f} ms per missed "
          f"row (88,080,384 B, pinned host to device, wall) on {smi}")
    tok = profile_decode(torch, eng, tok, steps=4)
    print(f"{arm}: peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
          f"GiB, pinned host stores {pinned_bytes(eng) / 2 ** 30:.2f} GiB on {smi}")
    if sync is not None:
        checkpoint_round_trip(torch, eng, tok, smi)
    return {"launches": launches, "tokens": tokens, "stats": stats}


def checkpoint_round_trip(torch, eng, tok, smi, steps: int = 4) -> None:
    """PHASE async (c): ``save_tiering``, ``steps`` more decode steps, then
    ``load_tiering``: every resource's state (placement tables, sketch,
    counters) comes back bitwise, no epoch is in flight and every resident
    expert row equals its slow row (the refill); prints the refill's wall
    ms per resource."""
    import tempfile
    from repro_torch.ckpt.manager import CheckpointManager, tree_leaves
    refill_ms = {}
    for name, h in eng.daemon.resources.items():
        refill = h.mem.refill_fast

        def timed(state, _refill=refill, _name=name):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _refill(state)
            torch.cuda.synchronize()
            refill_ms[_name] = 1e3 * (time.perf_counter() - t0)
        h.mem.refill_fast = timed

    def states():
        return {n: [x.cpu().clone() for x in tree_leaves(h.state)]
                for n, h in eng.daemon.resources.items()}

    def differ(now, then):
        return [n for n in then
                if not all(torch.equal(a, c) for a, c in zip(now[n], then[n]))]
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        mgr = CheckpointManager(d)
        t0 = time.perf_counter()
        eng.save_tiering(mgr, step=1)
        save_s = time.perf_counter() - t0
        saved = states()
        for _ in range(steps):
            tok = eng.step(tok)
        moved = differ(states(), saved)
        t0 = time.perf_counter()
        eng.load_tiering(mgr, step=1)
        load_s = time.perf_counter() - t0
    wrong = differ(states(), saved)
    if wrong:
        raise AssertionError(f"async (c): the restored state of {wrong} differs from "
                             "the saved one")
    busy = [n for n, h in eng.daemon.resources.items() if h.mem.busy]
    if busy:
        raise AssertionError(f"async (c): an epoch is in flight after the restore: "
                             f"{busy}")
    resident = check_expert_rows(torch, eng)
    print(f"async (c): save_tiering {1e3 * save_s:.1f} ms, {steps} more steps moved "
          f"the state of {moved or 'no resource'}, load_tiering {1e3 * load_s:.1f} ms: "
          f"every state leaf restored bitwise, no epoch in flight, {resident} "
          f"resident expert rows equal their slow rows; refill ms "
          + json.dumps({n: round(v, 3) for n, v in refill_ms.items()}) + f" on {smi}")


def stream_hazards(torch, smi, device="cuda", shape=HAZARD_SHAPE) -> None:
    """PHASE async (d): the side stream's hazards at the pinned store's scale.
    One resource of ``shape`` rows (48 of 32 MB on the card; 16 fast slots,
    16 promotions an epoch) ticks HAZARD_TICKS times on each plane, each
    tick followed at once by a write of two rows and a copy of two (distinct
    pages, landing while the epoch's copies run).  Every tick's reads of all
    pages (an int64 sum of each row's bits, on the device) must be equal on
    the two planes, some writes must have hit rows the epoch in flight
    promotes, and after ``finalize`` every resident fast row must equal its
    slow row."""
    from repro_torch.tiering.memory import DaemonParams, TieredMemory
    from repro_torch.tiering.resource import ResourceSpec
    from repro_torch.tiering.stats import TierStats
    gen = torch.Generator(device=device).manual_seed(0)
    rows = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16).cpu()
    n, slots = shape[0], shape[0] // 3
    spec = ResourceSpec("hazards", n_pages=n, hot_slots=slots, quota_pages=slots,
                        row_shape=tuple(shape[1:]), row_dtype="bfloat16")

    def bits(x):
        return x.view(torch.int16).reshape(x.shape[0], -1).sum(1, dtype=torch.int64).cpu()
    sums, hits = {}, 0
    for plane in (False, True):
        mem = TieredMemory.from_spec(spec, DaemonParams(migration_interval=1,
                                                        async_plane=plane), device=device)
        mem.bind_data(rows.clone())        # each plane writes its own store
        st, stats = mem.init(), TierStats("hazards")
        rng, wgen = np.random.default_rng(1), torch.Generator(device=device).manual_seed(2)
        sums[plane] = []
        t0 = time.perf_counter()
        for _ in range(HAZARD_TICKS):
            mem.enqueue(rng.integers(0, n, slots))
            st, _ = mem.tick(st, stats)
            pick = rng.choice(n, 6, replace=False)
            if plane and mem.busy:
                staged = (mem._inflight_slots(torch.as_tensor(pick[[0, 1, 4, 5]])) >= 0) \
                    & (mem.lookup_slots(st, torch.as_tensor(pick[[0, 1, 4, 5]])) < 0)
                hits += int(staged.sum())
            new = torch.randn((2,) + tuple(shape[1:]), generator=wgen,
                              device=device).to(torch.bfloat16)
            mem.write_rows(st, torch.as_tensor(pick[:2]), new)
            mem.copy_rows(st, pick[2:4], pick[4:6])
            sums[plane].append(bits(mem.read_rows(st, torch.arange(n))))
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        mem.finalize_epoch(stats)
        resident = torch.nonzero(st.tier.slot_page >= 0).reshape(-1)
        pages = st.tier.slot_page[resident].cpu()
        if not torch.equal(bits(mem.buffers.fast[resident.to(mem.buffers.fast.device)]),
                           bits(mem.buffers.slow[pages.long()])):
            raise AssertionError(f"async (d): a resident fast row differs from its slow "
                                 f"row (async plane {plane})")
        print(f"async (d): {'async' if plane else 'sync'} plane, {HAZARD_TICKS} ticks "
              f"of {slots} promotions of {rows[0].nbytes} B rows in {wall_ms:.1f} ms, "
              f"stall {1e3 * stats.stall_s:.1f} ms, {stats.migration_epochs} epochs, "
              f"{resident.numel()} resident rows equal their slow rows on {smi}")
    parted = [i for i, (a, b) in enumerate(zip(sums[False], sums[True]))
              if not torch.equal(a, b)]
    if parted or not hits:
        raise AssertionError(f"async (d): the planes' reads part at ticks {parted}, or "
                             f"no write hit a row in flight ({hits})")
    print(f"async (d): every tick's reads equal on the two planes; {hits} writes and "
          f"copies landed on rows the epoch in flight promotes on {smi}")


def moe_dense(torch, counters, cfg, params, smi, device="cuda", phase="moe") -> dict:
    """PHASE moe's (or mla's) dense arm: the single request of (a) on the
    full cache (``paged=False``: GQA MoE or ``mla_decode``, no kv resource)
    with the experts and embeddings resources.  Its experts' feed replays
    through a CPU daemon and its embeddings sketch bitwise; it launches the
    sketch kernels and no attention kernel."""
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    single = dict(MOE_PHASES[phase]["single"], paged=False)
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, params, ServeConfig(
        **dict(single, resources=tuple(single["resources"]))), device=device)
    torch.cuda.synchronize()
    bind_s = time.perf_counter() - t0
    log = record_experts(eng, cfg.moe.n_experts)
    blocks = record_blocks(eng.daemon["embeddings"])
    b, n, new = MOE_PROMPT
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (b, n))
    zero_counts(counters)
    t0 = time.perf_counter()
    tok = eng.prefill(prompts)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(new - 1):
        tok = eng.step(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    logits = eng._advance(torch.as_tensor(tok, device=device)[:, None])
    launches = read_counts(torch, counters, f"{phase} dense",
                           required=counters[SKETCH_COUNTERS])
    if launches["paged_attention_raw"] or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{phase} dense: an attention launch or non-finite "
                             f"logits: {launches}")
    replay_resource(torch, eng.daemon["embeddings"], blocks)
    placement = replay_experts(torch, eng, log)
    resident = check_expert_rows(torch, eng)
    stats = eng.tier_stats()
    print(f"{phase}: dense arm (paged=False), {b} x {n} prompt tokens and {new} new: "
          f"bound the stores in {bind_s:.1f} s; prefill {prefill_s:.3f} s, decode "
          f"{b * (new - 1) / decode_s:.2f} tokens/s, {1e3 * decode_s / (new - 1):.2f} "
          f"ms/step; embeddings sketch replayed bitwise; experts' "
          f"{placement['blocks']} blocks through a CPU daemon: {placement['epochs']} "
          f"promotion batches, {placement['rows']} rows moved, θ {placement['theta']} "
          f"all equal; {resident} resident expert rows equal their slow rows; experts "
          f"hit rate {stats['experts']['hit_rate']:.3f}, embeddings "
          f"{stats['embeddings']['hit_rate']:.3f}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches "
          f"{json.dumps(launches)} on {smi}")
    return launches


def count_mid_epoch(eng, seen) -> None:
    """Count the lane verbs (preemption, resume, hand-off) that land while
    an epoch of some resource is in flight."""
    def counted(verb, fn):
        def call(*args, **kw):
            if any(h.mem.busy for h in eng.daemon.resources.values()):
                seen[verb] += 1
            return fn(*args, **kw)
        return call
    for verb in ("preempt_lane", "resume_lane", "install_handoff"):
        seen.setdefault(verb, 0)
        setattr(eng, verb, counted(verb, getattr(eng, verb)))


def moe_lanes(torch, counters, cfg, params, smi, device="cuda", phase="moe",
              arm=None, trace_kw=MOE_TRACE, sync=None) -> dict:
    """PHASE moe (b), or mla's: the lane drive over ``trace_kw`` held to the
    CPU's schedule at the smoke config.  With ``sync`` (this function's
    result for the same trace on the synchronous plane) it is PHASE async's
    arm (b): the drive on the asynchronous plane, every request's tokens
    equal to the synchronous arm's, every resource's feed replayed at the
    card's commit ticks, and at least one preemption and one resume landing
    mid-epoch."""
    arm = arm or f"{phase} lanes"
    names = ("experts", "embeddings", "kv") if sync is not None else ("experts",)
    logs, blocks, checked, mid = {}, {}, {"steps": 0, "chunks": 0}, {}

    def instrument(sched):
        logs["feed"] = record_experts(sched.eng, cfg.moe.n_experts, names)
        if sync is not None:
            logs["epochs"] = record_epochs(sched.eng)
            count_mid_epoch(sched.eng, mid)
        for name in ("kv", "embeddings"):
            blocks[name] = record_blocks(sched.eng.daemon[name])
        check_lane_steps(sched.eng, checked)
        zero_counts(counters)
    eng, sched, trace, wall_s = run_moe_lanes(cfg, params, device, instrument,
                                              phase, async_=sync is not None,
                                              trace=trace_kw)
    launches = read_counts(torch, counters, arm)
    rep = sched.report()
    check_report(rep, sched.finished, len(trace.arrivals), cfg.vocab)
    served = eng.tier_stats()
    tokens = {r.rid: list(r.out) for r in sched.finished}
    if sync is not None:
        if tokens != sync["tokens"]:
            raise AssertionError("async lanes: tokens differ from the synchronous "
                                 "arm's")
        if not (mid["preempt_lane"] and mid["resume_lane"]):
            raise AssertionError(f"async lanes: no preemption or resume landed "
                                 f"mid-epoch: {mid}")
        eng.daemon.finalize()
        left = {n: r["inflight_bytes"] for n, r in eng.tier_stats().items()}
        if any(left.values()):
            raise AssertionError(f"async lanes: bytes in flight after finalize: "
                                 f"{left}")
    for name, recorded in blocks.items():
        replay_resource(torch, eng.daemon[name], recorded)
    placement = replay_experts(torch, eng, logs["feed"], names, logs.get("epochs"))
    resident = check_expert_rows(torch, eng)
    t0 = time.perf_counter()
    cpu = cpu_moe_lane_schedule(phase, async_=sync is not None, trace=trace_kw)
    card = lane_schedule(sched)
    if card != cpu:
        raise AssertionError(f"{arm}: the card's schedule differs from the CPU's:\n"
                             f"{card}\n{cpu}")
    what = ("experts'" if sync is None else "tokens equal to the synchronous arm's; "
            "every resource's")
    print(f"{arm}: schedule equal to the CPU run at the smoke config "
          f"({time.perf_counter() - t0:.1f} s): {len(sched.finished)} requests, "
          f"{rep['steps']} steps, {rep['preemptions']} preemption(s); {what} "
          f"{placement['blocks']} blocks replayed ({placement['epochs']} batches, "
          f"{placement['rows']} rows, θ {placement['theta']}); {resident} resident "
          f"expert rows equal their slow rows; {checked['steps']} lane steps and "
          f"{checked['chunks']} chunks with finite logits and unit page mass"
          if sync is None else
          f"{arm}: schedule equal to the CPU run at the smoke config with async "
          f"on ({time.perf_counter() - t0:.1f} s): {len(sched.finished)} requests, "
          f"{rep['steps']} steps, {rep['preemptions']} preemption(s); {what} "
          f"{placement['blocks']} "
          f"experts blocks replayed at the card's commit ticks "
          f"({placement['epochs']} experts batches, {placement['rows']} rows, θ "
          f"{placement['theta']}); {resident} resident expert rows equal their slow "
          f"rows; lane verbs landing mid-epoch {json.dumps(mid)}; epochs "
          f"{json.dumps(epoch_ticks(logs['epochs']))}")
    print_serving(rep, wall_s, arm, smi)
    print(f"{arm}: while serving, {overlap_line(served, eng._decode_s)} on {smi}")
    print(f"{arm}: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, pinned host "
          f"stores {pinned_bytes(eng) / 2 ** 30:.2f} GiB on {smi}")
    return {"launches": launches, "rep": rep, "tokens": tokens}


def release(torch) -> None:
    """Free what the last engine held (its pinned stores and rings)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def moe_path(torch, counters, smi, device="cuda", phase="moe"):
    """PHASE moe (kimi-k2) or mla (deepseek-v3): the arch at full width
    (depth cut), the single request, then the lane drive held to the CPU's
    schedule at the smoke config, then the single request's dense arm.
    PHASE moe also runs PHASE async: each of the first two on the
    asynchronous plane after its synchronous arm, and the checkpoint round
    trip.  Returns the launches of the synchronous single request and lanes,
    the lane report, and PHASE async's launches and seconds (None for
    mla)."""
    torch.cuda.reset_peak_memory_stats()
    cfg, params = draw_moe_params(torch, phase)
    arms = {"single": moe_single(torch, counters, cfg, params, smi, device, phase)}
    release(torch)                     # each engine's pinned expert store
    async_s = 0.0
    if phase == "moe":
        t0 = time.perf_counter()
        arms["async single"] = moe_single(torch, counters, cfg, params, smi, device,
                                          phase, sync=arms["single"])
        release(torch)
        async_s += time.perf_counter() - t0
    arms["lanes"] = moe_lanes(torch, counters, cfg, params, smi, device, phase)
    release(torch)
    if phase == "moe":
        t0 = time.perf_counter()
        arms["sync lanes"] = moe_lanes(torch, counters, cfg, params, smi, device,
                                       phase, "sync lanes", ASYNC_TRACE)
        release(torch)
        arms["async lanes"] = moe_lanes(torch, counters, cfg, params, smi, device,
                                        phase, "async lanes", ASYNC_TRACE,
                                        sync=arms["sync lanes"])
        release(torch)
        stream_hazards(torch, smi, device)
        release(torch)
        async_s += time.perf_counter() - t0
    launches = {arm: r["launches"] for arm, r in arms.items()}
    launches["dense"] = moe_dense(torch, counters, cfg, params, smi, device, phase)
    print(f"{phase}: launches " + json.dumps(launches) + f" on {smi}")

    def total(*keys):
        return {k: sum(launches[a][k] for a in keys) for k in launches[keys[0]]}
    phase_async = (total("async single", "sync lanes", "async lanes"), async_s) \
        if phase == "moe" else None
    return total("single", "lanes"), arms["lanes"]["rep"], phase_async


def check_int8_encoding(torch, eng, checked, n_embed: int = 64) -> None:
    """Hold the int8 slow stores to a CPU ``encode_rows("int8")`` of the same
    native rows, bitwise: a sample of the embedding store as bound (its
    table rows), and the first two rows of every KV flush as written."""
    from repro_torch.tiering import codec as codec_lib
    from repro_torch.tiering import migrate

    def same(mem, ids, rows, by_reciprocal):
        q, sc = codec_lib.encode_rows("int8", rows.cpu(), by_reciprocal=by_reciprocal)
        if not (torch.equal(mem.buffers.slow[ids], q)
                and torch.equal(mem.buffers.scale[ids], sc)):
            raise AssertionError(f"{mem.spec.name}: slow rows {ids.tolist()} differ "
                                 "from the CPU int8 encoding of their native rows")
        checked["encoded"] += len(ids)

    emb = eng.daemon["embeddings"].mem
    pages = np.random.default_rng(0).choice(emb.tp.num_pages,
                                            min(n_embed, emb.tp.num_pages), replace=False)
    same(emb, pages, eng._embed_payload(eng._embed_rpp)[torch.as_tensor(pages)], False)
    kv = eng.daemon["kv"].mem
    write_pages = kv.write_pages

    def checked_write(state, page_ids, k_pages, v_pages):
        ids = np.asarray(torch.as_tensor(page_ids).cpu()).reshape(-1)
        at = np.flatnonzero(ids >= 0)[:2]
        rows = migrate.pages_to_rows(k_pages, v_pages)[
            torch.as_tensor(at, device=k_pages.device)].cpu()
        n = write_pages(state, page_ids, k_pages, v_pages)
        if at.size:
            same(kv, ids[at], rows, True)       # the flush path's arithmetic
        return n
    kv.write_pages = checked_write


def reuse_path(torch, counters, cfg, params, smi):
    """PHASE reuse: the agentic multi-turn trace over the content-addressed
    KV pool, int8 slow stores, at full width on the card."""
    checked = {"steps": 0, "chunks": 0, "encoded": 0}
    blocks = {}

    def instrument(sched):
        eng = sched.eng
        for name in ("kv", "embeddings"):
            blocks[name] = record_blocks(eng.daemon[name])
        check_lane_steps(eng, checked)
        check_int8_encoding(torch, eng, checked)
        zero_counts(counters)

    eng, sched, trace, wall_s = run_reuse(cfg, params, "cuda", instrument)
    launches = read_counts(torch, counters, "reuse")
    rep = sched.report()
    check_report(rep, sched.finished, len(trace.arrivals), cfg.vocab)
    card = reuse_schedule(eng, sched)
    stats = eng.reuse_stats()
    if not (stats["page_hits"] > 0 and stats["tokens_saved"] > 0
            and stats["published"] > 0):
        raise AssertionError(f"the reuse pool was not used: {stats}")
    wire = {}
    for name, h in eng.daemon.resources.items():
        n = int(np.prod(h.mem.buffers.slow.shape[1:]))
        if not (h.mem.codec == "int8" and h.mem.row_bytes == n + 4):
            raise AssertionError(f"{name}: not an int8 store of {n} + 4 B rows")
        wire[name] = (n + 4, 2 * n)
    rows = reuse_rows(eng)            # raises unless bytes are whole wire rows
    for name, recorded in blocks.items():
        replay_resource(torch, eng.daemon[name], recorded)
    print(f"reuse: sketch replay of {len(blocks['kv'])} kv and "
          f"{len(blocks['embeddings'])} embeddings blocks bitwise equal; "
          f"{checked['steps']} lane steps and {checked['chunks']} chunks with finite "
          f"logits and unit page mass; {checked['encoded']} int8 slow rows equal "
          "to their CPU encoding")
    t0 = time.perf_counter()
    cpu, _ = cpu_reuse("int8")
    if card != cpu:
        raise AssertionError(f"the card's schedule differs from the CPU's:\n"
                             f"{card}\n{cpu}")
    _, none_rows = cpu_reuse("none")
    print(f"reuse: schedule and reuse counters equal to the CPU run at the smoke "
          f"config ({time.perf_counter() - t0:.1f} s with the none-codec CPU run): "
          f"{len(sched.finished)} requests, {rep['steps']} steps; reuse "
          + json.dumps({k: v for k, v in stats.items() if isinstance(v, int)})
          + f", shared mass share {stats['shared_mass_share']:.4f}")
    print_serving(rep, wall_s, "reuse", smi)
    for name, (int8_row, native_row) in wire.items():
        r, nr = rows[name], none_rows[name]
        print(f"reuse: {name} int8 wire rows of {int8_row} B (native {native_row} B): "
              f"{r['migration_bytes']} migrated, {r['flush_bytes']} flushed = "
              f"{rep['resources'][name]['migration_bytes']} + "
              f"{rep['resources'][name]['flush_bytes']} B on {smi}; the none codec on "
              f"the CPU run of the same trace: {nr['migration_bytes']} migrated, "
              f"{nr['flush_bytes']} flushed = "
              f"{(nr['migration_bytes'] + nr['flush_bytes']) * native_row} B at this "
              "width's native rows")
    print("reuse: launches " + json.dumps(launches) + f" on {smi}")
    return launches, rep


def check_draws(torch, draws, folds, sched) -> int:
    """Recompute every draw of the card on the CPU: the folded keys and the
    threefry bits bitwise, the tokens equal except where the top two
    perturbed scores lie within 1e-5 (CUDA's and the CPU's log may part by
    an ulp).  Returns the count of such near-ties."""
    from repro_torch.models import decode as dec
    from repro_torch.models import prng
    for keys, idx, out in folds:
        if not torch.equal(prng.fold_in(keys, idx), out):
            raise AssertionError("a key folded on the card differs from the CPU's")
    master = prng.prng_key(sched.scfg.seed)
    for r in sched.finished:
        if not torch.equal(r.key.cpu(), prng.fold_in(master, r.rid)):
            raise AssertionError(f"request {r.rid}: key differs from the CPU's")
    near = 0
    for logits, keys, bits, tokens in draws:
        if not torch.equal(prng.random_bits(keys, logits.shape[-1]), bits):
            raise AssertionError("threefry bits on the card differ from the CPU's")
        kw = dict(temperature=sched.scfg.temperature, top_p=sched.scfg.top_p)
        want = dec.sample_tokens(logits, keys, **kw)
        scores = prng.gumbel(keys, logits.shape[-1]) + dec.nucleus_logits(logits, **kw)
        top2 = scores.topk(2, dim=-1).values
        tie = (top2[:, 0] - top2[:, 1]) < 1e-5
        near += int(tie.sum())
        if not bool(((want == tokens) | tie).all()):
            raise AssertionError(f"sampled tokens {tokens.tolist()} differ from the "
                                 f"CPU's {want.tolist()} away from a near-tie")
    return near


def disagg_path(torch, counters, cfg, params, smi):
    """PHASE disagg: a prefill-heavy trace through a prefill worker engine
    attached to the decode engine, sampled at temperature 0.8 and top-p
    0.9, at full width on the card."""
    from repro_torch.models import decode as dec
    from repro_torch.models import prng
    checked = {"steps": 0, "chunks": 0, "refused": 0}
    blocks = {}
    draws, folds = [], []
    sample, fold = dec.sample_tokens, dec.fold_lane_keys

    def recorded_sample(logits, keys, **kw):
        out = sample(logits, keys, **kw)
        draws.append((logits.cpu(), keys.cpu(),
                      prng.random_bits(keys, logits.shape[-1]).cpu(), out.cpu()))
        return out

    def recorded_fold(keys, idx):
        out = fold(keys, idx)
        folds.append((keys.cpu(), torch.as_tensor(idx).cpu(), out.cpu()))
        return out

    def instrument(sched):
        blocks["kv"] = record_blocks(sched.eng.daemon["kv"])
        check_lane_steps(sched.eng, checked)
        check_lane_steps(sched.peng, checked)
        resident = sched.eng.segment_resident

        def counted(residual):
            ok = resident(residual)
            checked["refused"] += not ok
            return ok
        sched.eng.segment_resident = counted
        zero_counts(counters)

    dec.sample_tokens, dec.fold_lane_keys = recorded_sample, recorded_fold
    try:
        eng, sched, trace, wall_s = run_disagg(cfg, params, "cuda", instrument)
    finally:
        dec.sample_tokens, dec.fold_lane_keys = sample, fold
    launches = read_counts(torch, counters, "disagg")
    rep = sched.report()
    check_report(rep, sched.finished, len(trace.arrivals), cfg.vocab)
    if checked["refused"]:
        raise AssertionError(f"segment_resident refused {checked['refused']} "
                             "hand-off installs")
    card = disagg_schedule(eng, sched)
    replay_resource(torch, eng.daemon["kv"], blocks["kv"])
    t0 = time.perf_counter()
    near = check_draws(torch, draws, folds, sched)
    print(f"disagg: {len(draws)} sampling calls, {sum(d[3].numel() for d in draws)} "
          f"draws: keys and threefry bits bitwise the CPU's, tokens equal but at "
          f"{near} near-tie(s) within 1e-5 ({time.perf_counter() - t0:.1f} s); "
          f"sketch replay of {len(blocks['kv'])} kv blocks bitwise equal; "
          f"{checked['steps']} decode steps and {checked['chunks']} prefill chunks "
          "with finite logits and unit page mass")
    t0 = time.perf_counter()
    cpu = cpu_disagg_schedule()
    if card != cpu:
        raise AssertionError(f"the card's schedule differs from the CPU's:\n"
                             f"{card}\n{cpu}")
    ho = rep["handoff"]
    print(f"disagg: schedule and hand-offs equal to the CPU run at the smoke "
          f"config ({time.perf_counter() - t0:.1f} s): {len(sched.finished)} "
          f"requests, {rep['steps']} steps, {ho['count']} hand-offs, "
          f"{ho['bytes_out']} B out and {ho['bytes_in']} B in "
          f"({card['handoff']['pages_out']} and {card['handoff']['pages_in']} pages "
          f"of {eng.daemon['kv'].mem.row_bytes} B), depth peak {ho['depth_peak']}, "
          "no install refused")
    print_serving(rep, wall_s, "disagg", smi)
    print("disagg: launches " + json.dumps(launches) + f" on {smi}")
    return launches, rep


# -- phases 8 and 9: the paper's evaluation path (the tiering simulator) -------

def sim_blocks(workload: str, stream: dict) -> list:
    from repro_torch.core.simulator import WORKLOADS
    return list(WORKLOADS[workload](**stream))


def timed_stream(blocks, marks: dict):
    """Yield ``blocks``, noting in ``marks["first"]`` when the first is
    pulled: run_sim pulls it after its init sweep, which ends in a sync."""
    marks["first"] = time.perf_counter()
    yield from blocks


def sim_outcome(res) -> dict:
    """A SimResult as plain values: its counts, θ and error traces (which
    must match exactly on any device), modeled runtime and bandwidth trace."""
    return {"fast_hits": res.fast_hits, "slow_hits": res.slow_hits,
            "promoted": res.promoted, "ping_pong": res.ping_pong,
            "theta": [t["theta"] for t in res.trace if "theta" in t],
            "err": [t["err"] for t in res.trace if "err" in t],
            "runtime": res.runtime,
            "bw": [t["bw"] for t in res.trace if "bw" in t]}


def sim_mismatch(a: dict, b: dict) -> str | None:
    """What two outcomes disagree on (None if nothing): counts and traces
    exactly, runtime within SIM_RUNTIME_RTOL, bw within SIM_BW_ATOL."""
    for k in ("fast_hits", "slow_hits", "promoted", "ping_pong", "theta", "err"):
        if a[k] != b[k]:
            return f"{k}: {a[k]} != {b[k]}"
    if abs(a["runtime"] - b["runtime"]) > SIM_RUNTIME_RTOL * abs(b["runtime"]):
        return f"runtime: {a['runtime']!r} != {b['runtime']!r}"
    if len(a["bw"]) != len(b["bw"]) or any(
            abs(x - y) > SIM_BW_ATOL for x, y in zip(a["bw"], b["bw"])):
        return f"bw: {a['bw']} != {b['bw']}"
    return None


def run_sim_grid(device, stream=SIM_STREAM) -> dict:
    """fig11's grid through the port's run_sim on ``device``: {(workload,
    method): (SimResult, wall ms per block after the init sweep)}."""
    from repro_torch.core.simulator import run_sim
    out = {}
    for wl in SIM_WORKLOADS:
        blocks = sim_blocks(wl, stream)
        for m in SIM_METHODS:
            marks = {}
            res = run_sim(m, timed_stream(blocks, marks), n_pages=stream["n_pages"],
                          collect_trace=True, device=device, **SIM_KW)
            out[wl, m] = (res, (time.perf_counter() - marks["first"]) * 1e3
                          / len(blocks))
    return out


def cpu_sim_grid(n_blocks: int = SIM_STREAM["n_blocks"]) -> dict:
    """PHASE sim's grid from the port on the CPU at ``n_blocks`` blocks:
    {workload: {method: sim_outcome}}."""
    grid = run_sim_grid("cpu", dict(SIM_STREAM, n_blocks=n_blocks))
    return {wl: {m: sim_outcome(grid[wl, m][0]) for m in SIM_METHODS}
            for wl in SIM_WORKLOADS}


def sim_path(torch, counters, smi) -> dict:
    """PHASE sim: fig11's 8 workloads x 6 methods on the card, every
    result held to a CPU run of the port on the same blocks and seeds."""
    from repro_torch.core.simulator import geomean_speedup
    zero_counts(counters)
    grid = run_sim_grid("cuda")
    launches = read_counts(torch, counters, "sim", counters[1:])
    t0 = time.perf_counter()
    cpu = cpu_sim_grid()
    for (wl, m), (res, _) in grid.items():
        bad = sim_mismatch(sim_outcome(res), cpu[wl][m])
        if bad:
            raise AssertionError(f"sim {wl}/{m}: the card's run differs from the "
                                 f"CPU's: {bad}")
    print(f"sim: all {len(grid)} results equal to the CPU run of the same blocks "
          f"({time.perf_counter() - t0:.1f} s): counts and the theta/error traces "
          f"exactly, runtime within {SIM_RUNTIME_RTOL} relative, bw within "
          f"{SIM_BW_ATOL}")
    def runtimes(m):
        return [grid[wl, m][0].runtime for wl in SIM_WORKLOADS]
    print("sim: modeled (MemModel runtime, the same on any device) geomean "
          "speedup of neomem over " + ", ".join(
              f"{m} {geomean_speedup(runtimes(m), runtimes('neomem')):.3f}x"
              for m in SIM_METHODS if m != "neomem"))
    print("sim: neomem hit rate " + ", ".join(
        f"{wl} {grid[wl, 'neomem'][0].hit_rate:.3f}" for wl in SIM_WORKLOADS))
    ms = {m: [grid[wl, m][1] for wl in SIM_WORKLOADS] for m in SIM_METHODS}
    print("sim: wall ms per block on the card (mean over the 8 workloads, min-max) "
          + ", ".join(f"{m} {statistics.mean(v):.3f} ({min(v):.3f}-{max(v):.3f})"
                      for m, v in ms.items()) + f" on {smi}")
    print("sim: launches " + json.dumps(launches) + f" on {smi}")
    return launches


def record_sketch_intervals(tail: int) -> tuple[dict, callable]:
    """Record every TieredMemory's sketch between clears: the last ``tail``
    blocks of the interval (ids, θ, epoch, as device tensors, no host
    sync), the sketch before the first of them, and the sketch as the
    clear ends the interval.  Returns the record ({"last": (start, blocks,
    end)} of the latest complete interval) and a function that undoes the
    patch."""
    from repro_torch.tiering.memory import TieredMemory
    profile, clear = TieredMemory.profile, TieredMemory.clear
    rec = {"window": [], "last": None}

    def snap(sk):
        return sk._replace(**{f: getattr(sk, f).clone() for f in sk._fields})

    def recording_profile(self, state, pages, **kw):
        rec["window"].append((snap(state.prof.sketch),
                              (pages.clone(), state.prof.theta.clone(),
                               state.prof.sketch.cur_epoch.clone())))
        del rec["window"][:-tail]
        return profile(self, state, pages, **kw)

    def recording_clear(self, state):
        win = rec["window"]
        rec["last"] = (win[0][0] if win else None, [b for _, b in win],
                       snap(state.prof.sketch))
        out = clear(self, state)
        rec["window"] = []
        return out

    def undo():
        TieredMemory.profile, TieredMemory.clear = profile, clear
    TieredMemory.profile, TieredMemory.clear = recording_profile, recording_clear
    return rec, undo


def first_occurrence_ms(torch, s: int) -> float:
    """Device ms of the sketch's O(S^2) first-occurrence dedup (plain torch)
    on ``s`` ids, half of them padding."""
    from repro_torch.core.sketch import _first_occurrence
    ids = torch.randint(0, 1 << 22, (s,), device="cuda", dtype=torch.int32)
    valid = torch.arange(s, device="cuda") < s // 2
    return time_ms(lambda: _first_occurrence(ids, valid), n=20)


def profile_sim(torch, blocks, smi, n: int = 16) -> None:
    """torch.profiler over ``n`` neomem blocks at the paper's scale, from the
    first block on (the init sweep is not profiled): the device's busy
    share of the wall time and the kernels that fill it."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.simulator import run_sim
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    marks = {}

    def stream():
        prof.start()
        yield from timed_stream(blocks[:n], marks)
    run_sim("neomem", stream(), n_pages=PAPER_STREAM["n_pages"], device="cuda",
            **PAPER_KW)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - marks["first"]) * 1e6
    prof.stop()
    dev = device_rows(torch, prof)
    busy_us = sum(t for t, _, _ in dev)
    print(f"sim-paper: profile of {n} neomem blocks: wall {wall_us / n / 1e3:.3f} "
          f"ms/block, device busy {busy_us / n / 1e3:.3f} ms/block "
          f"({100 * busy_us / wall_us:.1f}% of wall), "
          f"{sum(c for _, _, c in dev) / n:.1f} device launches/block on {smi}")
    for t, name, count in dev[:8]:
        print(f"sim-paper:   {t / n / 1e3:8.3f} ms/block  {count / n:6.1f}/block  "
              f"{name[:70]}")


def sim_paper_path(torch, counters, smi) -> dict:
    """PHASE sim-paper: gups at the paper's scale through every method on
    the card; neomem's sketch over the last PAPER_REPLAY blocks of its last
    clear interval replayed bitwise on the CPU."""
    from repro_torch.core.simulator import run_sim
    from repro_torch.core.sketch import SketchParams
    n_pages, n_blocks = PAPER_STREAM["n_pages"], PAPER_STREAM["n_blocks"]
    blocks = sim_blocks("gups", PAPER_STREAM)
    accesses = n_pages + sum(b.size for b in blocks)
    zero_counts(counters)
    rows = {}
    for m in SIM_METHODS:
        marks = {}
        t0 = time.perf_counter()
        res = run_sim(m, timed_stream(blocks, marks), n_pages=n_pages,
                      device="cuda", **PAPER_KW)
        t1 = time.perf_counter()
        if res.fast_hits + res.slow_hits != accesses:
            raise AssertionError(f"sim-paper {m}: {res.fast_hits} + "
                                 f"{res.slow_hits} hits != {accesses} accesses")
        if not 0 <= res.promoted <= PAPER_QUOTA * n_blocks:
            raise AssertionError(f"sim-paper {m}: {res.promoted} promotions "
                                 f"over the quota of {PAPER_QUOTA} x {n_blocks}")
        rows[m] = dict(init_s=marks["first"] - t0,
                       ms=(t1 - marks["first"]) * 1e3 / n_blocks, res=res)
    launches = read_counts(torch, counters, "sim-paper", counters[1:])
    # the replay's record comes from a second neomem run, so the timed runs
    # above pay for no snapshot
    rec, undo = record_sketch_intervals(PAPER_REPLAY)  # only neomem profiles and clears
    try:
        res = run_sim("neomem", iter(blocks), n_pages=n_pages, device="cuda",
                      **PAPER_KW)
    finally:
        undo()
    bad = sim_mismatch(sim_outcome(res), sim_outcome(rows["neomem"]["res"]))
    if bad:
        raise AssertionError(f"sim-paper: the recorded neomem run differs: {bad}")
    if rec["last"] is None or not rec["last"][1]:
        raise AssertionError("sim-paper: no complete clear interval recorded")
    t0 = time.perf_counter()
    start, recorded, end = rec["last"]
    replay_sketch(torch, SketchParams(width=PAPER_W, depth=2), recorded, end,
                  start=start, what="sim-paper sketch")
    print(f"sim-paper: the last {len(recorded)} blocks of neomem's last clear "
          f"interval (of {PAPER_STREAM['block']} ids at W={PAPER_W}) replayed bitwise on the "
          f"CPU ({time.perf_counter() - t0:.1f} s) from a second, recorded run "
          f"equal to the timed one")
    for m, r in rows.items():
        res = r["res"]
        print(f"sim-paper: {m}: {r['ms']:.3f} ms per block on the card after a "
              f"{r['init_s']:.2f} s init sweep; hit rate {res.hit_rate:.4f}, "
              f"{res.promoted} promoted, {res.ping_pong} ping-pong, modeled "
              f"runtime {res.runtime:.6f} s on {smi}")
    profile_sim(torch, blocks, smi)
    print("sim-paper: first-occurrence dedup (O(S^2), plain torch) device "
          + ", ".join(f"{first_occurrence_ms(torch, s):.4f} ms at S={s}"
                      for s in (SIM_STREAM["block"], PAPER_STREAM["block"]))
          + f" on {smi}")
    print("sim-paper: launches " + json.dumps(launches) + f" on {smi}")
    return launches


def embed_gather_ms(torch, dec, eng, params, n: int = 50) -> tuple[float, float]:
    """Wall ms of one step's embedding read at the lane shape, through the
    tiered store (placement lookup, pinned-host staging copy for slow rows)
    and, beside it, the dense table gather; medians of ``n`` synchronised
    calls on the final placement."""
    tok = torch.as_tensor(np.arange(4) * 997 % eng.cfg.vocab, device=eng.device)[:, None]
    tiered = eng._tier_reads()
    if not torch.equal(dec._embed_tokens(params, tok, tiered),
                       dec._embed_tokens(params, tok, None)):
        raise AssertionError("the tiered embedding read differs from the table's")

    def wall(fn):
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    return (wall(lambda: dec._embed_tokens(params, tok, tiered)),
            wall(lambda: dec._embed_tokens(params, tok, None)))


# -- PHASE train: the train step (train/step.py) ---------------------------------

def _f32_tree(torch, tree):
    return _tree_map(lambda v: v.float() if v.is_floating_point() else v, tree)


def train_full(torch, smi, cfg=None, device="cuda", shape=(TRAIN_BATCH, TRAIN_SEQ),
               steps=TRAIN_STEPS) -> dict:
    """(a) TRAIN_ARCH at full width and depth (random bf16 weights from seed
    0), AdamW, TRAIN_MICRO strided microbatches, remat on: ``steps`` steps
    of SyntheticLM batches (vocab 128,256, seed 1,234).  Gates: every loss
    and global gradient norm finite, the mean loss of the last 3 steps below
    the first 3's, the parameters moved.  Prints ms a step, tokens/s, peak
    memory and the model FLOP/s share of the card's bf16 dense peak, then a
    profile of TRAIN_PROFILED more steps.  ``cfg`` (the smoke config) and
    ``device="cpu"`` rehearse it."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.roofline import analysis
    from repro_torch.train import step as ts
    cfg = cfg or get_config(TRAIN_ARCH)
    b, s = shape
    tcfg = ts.TrainConfig(opt=OptConfig(**TRAIN_OPT), microbatches=TRAIN_MICRO,
                          remat=True)
    print(f"train: {cfg.name}, {cfg.n_layers} layers at d {cfg.d_model}, "
          f"{tcfg.microbatches} microbatches of {b // tcfg.microbatches} x {s} "
          f"tokens, remat, {tcfg.opt}")
    release(torch)
    t0 = time.perf_counter()
    state = ts.init_state(cfg, tcfg, init_params(cfg, seed=0, device=device),
                          device=device)
    n_params = sum(x.numel() for x in _leaves(state["params"]))
    watch = {"embed": state["params"]["embed"]["table"][:4].clone(),
             "wq": state["params"]["blocks"][0]["attn"]["wq"][0, :4].clone(),
             "final_norm": state["params"]["final_norm"]["scale"].clone()}
    print(f"train: {n_params / 1e9:.3f} B params and AdamW state drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    data = SyntheticLM(DataConfig(seq_len=s, global_batch=b, vocab=cfg.vocab,
                                  seed=1234))
    fn = ts.build_train_step(cfg, None, tcfg)
    losses, gnorms, wall = [], [], []
    for i in range(steps):
        batch = ts.to_batch(data.batch(i, 0, 1), device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = fn(state, batch)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not (np.isfinite(losses).all() and np.isfinite(gnorms).all()):
        raise AssertionError(f"train: a loss or gradient norm is not finite: "
                             f"{losses} {gnorms}")
    if not np.mean(losses[-3:]) < np.mean(losses[:3]):
        raise AssertionError(f"train: the loss did not fall: {losses}")
    for k, v in watch.items():
        now = {"embed": state["params"]["embed"]["table"][:4],
               "wq": state["params"]["blocks"][0]["attn"]["wq"][0, :4],
               "final_norm": state["params"]["final_norm"]["scale"]}[k]
        if torch.equal(now, v):
            raise AssertionError(f"train: the {k} parameters did not move")
    step_s = statistics.median(wall[1:])
    tokens = b * s
    mf = analysis.model_flops(TRAIN_ARCH, "train_4k", cfg=cfg, batch=b, seq=s)
    # the inline formula this phase printed before roofline/analysis.py
    # was ported (n_params counts the embedding; attention by n_layers)
    inline = 6 * n_params * tokens + 6 * cfg.n_layers * b * s * s * cfg.n_heads * cfg.head_dim
    print(f"train: losses {[round(x, 4) for x in losses]}, gradient norms "
          f"{[round(x, 4) for x in gnorms]}")
    print(f"train: {step_s * 1e3:.1f} ms/step (median of steps 2-{steps}; step 1 "
          f"{wall[0] * 1e3:.1f} ms), {tokens / step_s:.0f} tokens/s, peak "
          f"{peak:.2f} GiB; model FLOPs (analysis.model_flops) {mf / 1e12:.2f} T a "
          f"step = {mf / step_s / 1e12:.1f} TFLOP/s, "
          f"{100 * mf / step_s / analysis.PEAK_FLOPS:.1f}% of the bf16 dense peak "
          f"(analysis.PEAK_FLOPS {analysis.PEAK_FLOPS:.3e}) on {smi}; the inline "
          f"formula this phase printed before (6 N tokens + 6 L B S^2 H dh) "
          f"{inline / 1e12:.2f} T, "
          f"{100 * inline / step_s / analysis.PEAK_FLOPS:.1f}%")
    prof = profile_train(torch, fn, state, data, steps, device, cfg, b, s)
    cen = census_train(torch, smi, fn, state, data, steps + TRAIN_PROFILED, device,
                       cfg, tcfg, b, s, step_s)
    return {"ms": step_s * 1e3, "tokens_per_s": tokens / step_s, "peak_gib": peak,
            "losses": losses, **prof, **cen}


def census_train(torch, smi, fn, state, data, start, device, cfg, tcfg, b, s,
                 step_s) -> dict:
    """(a)'s census: one more step on the card under
    ``repro_torch.roofline.census``, and the same step (``launch/specs.py``'s
    cell at PHASE train's batch, length, microbatches and optimizer) on
    meta tensors on the host.  Gates: the two FLOP counts within
    CENSUS_RTOL, and the census over ``analysis.model_flops`` (the remat
    factor) in [1, REMAT_FACTOR_MAX].  Prints the three-term row with the
    H100's rates at the step's measured ms, and the census's peak beside
    ``max_memory_allocated`` for the step (not gated)."""
    from repro_torch.launch.specs import cell_specs
    from repro_torch.roofline import analysis
    from repro_torch.roofline.census import census
    from repro_torch.train import step as ts
    batch = ts.to_batch(data.batch(start, 0, 1), device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (state, _), card = census(fn, state, batch)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    max_alloc = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    cell = cell_specs(TRAIN_ARCH, "train_4k", None, tcfg=tcfg, cfg=cfg, batch=b, seq=s)
    _, meta = census(cell["fn"], *cell["args"])
    meta_s = time.perf_counter() - t0
    mf = analysis.model_flops(TRAIN_ARCH, "train_4k", cfg=cfg, batch=b, seq=s)
    gap = card["flops_per_device"] - meta["flops_per_device"]
    remat = card["flops_per_device"] / mf
    row = analysis.row(TRAIN_ARCH, "train_4k", "card", card, n=1, mf=mf,
                       peak_bytes=card["peak_bytes"])
    print(f"train census: the card's step {card['flops_per_device']:.6e} FLOP, "
          f"{card['bytes_per_device']:.6e} B (aten ops' inputs and outputs, before "
          f"fusion), collectives {card['collective_bytes_per_device']} B; the same "
          f"step on meta (launch/specs.py, {b} x {s}, {tcfg.microbatches} "
          f"microbatches, {tcfg.opt.kind}) {meta['flops_per_device']:.6e} FLOP, "
          f"{meta['bytes_per_device']:.6e} B; gap {gap:.6e} FLOP "
          f"({gap / meta['flops_per_device']:.3e} of it); analysis.model_flops "
          f"{mf:.6e}, census / model {remat:.4f} (the remat factor); census step "
          f"{card_s * 1e3:.1f} ms on the card, meta census {meta_s:.1f} s on the host")
    print(f"train roofline (H100 rates: {analysis.PEAK_FLOPS:.3e} FLOP/s, "
          f"{analysis.HBM_BW:.3e} B/s): compute {row.compute_s * 1e3:.1f} ms, memory "
          f"{row.memory_s * 1e3:.1f} ms, collective {row.collective_s * 1e3:.1f} ms, "
          f"dominant {row.dominant}; measured {step_s * 1e3:.1f} ms a step, the "
          f"bound {100 * row.step_time_lower_bound / step_s:.1f}% of it, model "
          f"FLOPs {100 * mf / step_s / analysis.PEAK_FLOPS:.1f}% of the peak; "
          f"census peak {card['peak_bytes'] / 2 ** 30:.2f} GiB, max_memory_allocated "
          f"{max_alloc / 2 ** 30:.2f} GiB for the step, on {smi}")
    if abs(gap) > CENSUS_RTOL * meta["flops_per_device"]:
        raise AssertionError(f"train census: the card counts {card['flops_per_device']:.6e} "
                             f"FLOP, meta {meta['flops_per_device']:.6e}: a gap of "
                             f"{gap:.6e}")
    if not 1.0 <= remat <= REMAT_FACTOR_MAX:
        raise AssertionError(f"train census: census / model_flops {remat:.4f} is outside "
                             f"[1, {REMAT_FACTOR_MAX}]")
    return {"census_flops": card["flops_per_device"],
            "meta_census_flops": meta["flops_per_device"], "model_flops": mf,
            "remat_factor": remat, "census_bytes": card["bytes_per_device"],
            "compute_ms": row.compute_s * 1e3, "memory_ms": row.memory_s * 1e3,
            "census_peak_gib": card["peak_bytes"] / 2 ** 30,
            "max_alloc_gib": max_alloc / 2 ** 30}


def profile_train(torch, fn, state, data, start, device, cfg, b, s,
                  steps=TRAIN_PROFILED) -> dict:
    """torch.profiler over ``steps`` more train steps: the device's busy
    share, launches a step and the device time inside a profiler range
    around the plain attention (``attention.sdpa``: its forward, the remat
    recompute included); the backward of one call at the step's shape,
    timed apart with CUDA events, scales by the calls a step."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import attention as attn
    from repro_torch.train import step as ts
    plain = attn.sdpa

    def in_range(*a, **kw):
        with record_function("sdpa"):
            return plain(*a, **kw)
    batches = [ts.to_batch(data.batch(start + i, 0, 1), device) for i in range(steps)]
    torch.cuda.synchronize()
    attn.sdpa = in_range
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for bt in batches:
                state, m = fn(state, bt)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        attn.sdpa = plain
    dev = [r for r in device_rows(torch, prof) if r[1] != "sdpa"]
    busy_us = sum(t for t, _, _ in dev)
    launches = sum(c for _, _, c in dev)
    rng = [e for e in prof.events() if e.name == "sdpa"
           and e.device_type == torch.autograd.DeviceType.CPU]
    range_us = sum(e.device_time_total for e in rng)
    calls = len(rng) / steps
    # one attention call's forward and forward + backward at the step's shape
    mb = b // TRAIN_MICRO
    g = torch.Generator(device=device).manual_seed(5)
    q = torch.randn((mb, s, cfg.n_heads, cfg.head_dim), generator=g, device=device,
                    dtype=torch.bfloat16, requires_grad=True)
    k, v = (torch.randn((mb, s, cfg.n_kv_heads, cfg.head_dim), generator=g,
                        device=device, dtype=torch.bfloat16, requires_grad=True)
            for _ in range(2))
    ct = torch.randn((mb, s, cfg.n_heads, cfg.head_dim), generator=g, device=device,
                     dtype=torch.bfloat16)

    def fwd():
        with torch.no_grad():
            attn.sdpa_chunked(q, k, v, causal=True)

    def fwd_bwd():
        torch.autograd.grad(attn.sdpa_chunked(q, k, v, causal=True), (q, k, v), ct)
    t_f = time_ms(fwd, n=10, graph=False)
    t_fb = time_ms(fwd_bwd, n=10, graph=False)
    fwd_calls = calls            # per step, the remat recompute included
    bwd_calls = cfg.n_layers * TRAIN_MICRO
    attn_ms = range_us / steps / 1e3 + bwd_calls * (t_fb - t_f)
    top = ", ".join(f"{n[:48]} {t / steps / 1e3:.1f} ms" for t, n, _ in dev[:6])
    print(f"train profile: {steps} steps, wall {wall_us / steps / 1e3:.1f} ms/step, "
          f"device busy {busy_us / steps / 1e3:.1f} ms/step ({100 * busy_us / wall_us:.1f}% "
          f"of wall), {launches / steps:.0f} device launches/step; plain float32 "
          f"attention: {range_us / steps / 1e3:.1f} ms/step in its profiler range over "
          f"{fwd_calls:.0f} forward calls (remat's recompute included) + "
          f"{bwd_calls} backward calls x {t_fb - t_f:.2f} ms (one call's "
          f"forward+backward {t_fb:.2f} ms less its forward {t_f:.2f} ms, CUDA events) "
          f"= {attn_ms:.1f} ms/step ({100 * attn_ms * 1e3 / max(busy_us / steps, 1e-9):.1f}"
          f"% of busy); top kernels: {top}")
    return {"busy_share": busy_us / wall_us, "launches_per_step": launches / steps,
            "attn_ms": attn_ms}


def _family_params(torch, cfg):
    """An arch's smoke params from seed 0 on the CPU in float32, every
    ``cross`` gate at CROSS_GATE (drawn as zero, it would shut the image
    out)."""
    from repro_torch.models.transformer import init_params
    params = _f32_tree(torch, init_params(cfg, seed=0, device="cpu"))
    for blk in params["blocks"]:
        if "xgate" in blk:
            blk["xgate"] = torch.full_like(blk["xgate"], CROSS_GATE)
    return params


def train_family(torch, arch, kw, kind, device="cuda") -> dict:
    """(b) One train step of ``arch``'s smoke config in float32 on ``device``
    against the port on the CPU from the same params and batch: the loss,
    gradient norm and every updated leaf within ATOL + RTOL*|ref|; for a MoE
    arch the router stream fed to the sketch equal to the CPU's, and the
    card's NeoProf state bitwise a CPU replay of the card's stream."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.core import neoprof as npf
    from repro_torch.core import sketch as sk
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.train import step as ts
    cfg = get_smoke_config(arch)
    tcfg = ts.TrainConfig(opt=OptConfig(kind=kind), **kw)
    host = _family_params(torch, cfg)
    batch = SyntheticLM(DataConfig(seq_len=32, global_batch=4, vocab=cfg.vocab,
                                   seed=1234)).batch(0, 0, 1)
    if cfg.n_aux_tokens:
        batch["aux_embeds"] = np.random.default_rng(3).normal(
            0, 1, (4, cfg.n_aux_tokens, cfg.d_model)).astype(np.float32)
    streams = {}
    observe = ts.neoprof_observe

    def recorded(side):
        def fn(prof, ids, params):
            streams[side] = ids.cpu()
            return observe(prof, ids, params)
        return fn
    out = {}
    for side, dev in (("card", device), ("host", "cpu")):
        state = ts.init_state(cfg, tcfg, _tree_map(lambda v: v.to(dev, copy=True), host),
                              device=dev)
        ts.neoprof_observe = recorded(side)
        try:
            state, m = ts.build_train_step(cfg, None, tcfg)(state, ts.to_batch(batch, dev))
        finally:
            ts.neoprof_observe = observe
        out[side] = (state, m)
    (cs, cm), (hs, hm) = out["card"], out["host"]
    err = max(held(torch, cm[k].reshape(1), hm[k].reshape(1), f"train {arch}: {k}")
              for k in ("loss", "gnorm"))
    for a, r in zip(_leaves(cs["params"]), _leaves(hs["params"])):
        err = max(err, held(torch, a, r, f"train {arch}: a param"))
    line = ""
    if cfg.moe is not None:
        if not torch.equal(streams["card"], streams["host"]):
            raise AssertionError(f"train {arch}: the router stream differs from the CPU's")
        pp = ts.prof_params(tcfg)
        replay = npf.neoprof_observe(
            npf.neoprof_init(pp, sk.key_seeds(pp.sketch.depth, pp.sketch.width),
                             device="cpu"), streams["card"], pp)
        got = cs["prof"]
        for name, a, r in ((f, getattr(got.sketch, f), getattr(replay.sketch, f))
                           for f in ("counts", "epochs", "hot", "n_seen")):
            if not torch.equal(a.cpu(), r):
                raise AssertionError(f"train {arch}: sketch {name} differs from the "
                                     "CPU replay of the card's stream")
        for f in ("hot_buf", "hot_count"):
            if not torch.equal(getattr(got, f).cpu(), getattr(replay, f)):
                raise AssertionError(f"train {arch}: {f} differs from the CPU replay")
        line = (f"; router stream ({streams['card'].numel()} ids) equal to the CPU's, "
                f"sketch ({int(got.sketch.n_seen)} ids seen, {int(got.hot_count)} hot) "
                "bitwise a CPU replay of it")
    opts = "".join(f", {k}={v}" for k, v in kw.items())
    print(f"train: {arch} smoke, {kind}{opts}: one "
          f"float32 step on the card against the CPU, loss {float(cm['loss']):.6f}, "
          f"max abs err {err:.3g} over loss, gnorm and every updated leaf (within "
          f"{ATOL} + {RTOL}*|ref|, TF32 off){line}")
    return {"err": err}


def _form(torch, arch, kind, gen):
    """A full-width block of one training-only form: float32 weights drawn
    on the CPU, its forward ``fn(p, x, part=None)`` (``part`` partitions it
    over 'model') and its width."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import attention as attn, mamba2 as m2, xlstm as xl
    cfg = get_config(arch)
    d, f32 = cfg.d_model, torch.float32
    if kind == "mamba":
        sc = cfg.ssm
        p = m2.mamba2_init(gen, d, d_state=sc.d_state, expand=sc.expand,
                           headdim=sc.headdim, d_conv=sc.d_conv, n_groups=sc.n_groups,
                           device="cpu", dtype=f32)
        return p, lambda p, x, part=None: m2.mamba2_apply(
            p, x, headdim=sc.headdim, n_groups=sc.n_groups, d_state=sc.d_state,
            chunk=TRAIN_CHUNK, part=part), d
    if kind == "mlstm":
        p = xl.mlstm_init(gen, d, n_heads=cfg.mlstm_heads, device="cpu", dtype=f32)
        return p, lambda p, x, part=None: xl.mlstm_apply(
            p, x, n_heads=cfg.mlstm_heads, chunk=TRAIN_CHUNK, part=part), d
    if kind == "slstm":
        return xl.slstm_init(gen, d, device="cpu", dtype=f32), xl.slstm_apply, d
    if kind in ("cross", "enc"):
        # a whole attention block: llama-vision's gated cross block over a
        # seeded (1, n_aux_tokens, d) patch stream (its gate at CROSS_GATE),
        # whisper's bidirectional encoder block
        from repro_torch.models import transformer as tr
        p = _tree_map(lambda v: v.float(), tr._block(gen, cfg, kind, 0, "cpu"))
        aux = {}
        if kind == "cross":
            p["xgate"].fill_(CROSS_GATE)
            aux["aux_embeds"] = torch.randn((1, cfg.n_aux_tokens, d), generator=gen)
        name = "cross" if kind == "cross" else "enc_self"

        def block(p, x, part=None):
            parts = None if part is None else dict(attn=part, ffn=part, xattn=part)
            a = {k: v.to(x.device) for k, v in aux.items()}
            return tr._attn_block(p, cfg, name, x, a, parts=parts)[0]
        return p, block, d
    dims = dataclasses.asdict(cfg.mla)
    p = attn.mla_init(gen, d, cfg.n_heads, device="cpu", dtype=f32, **dims)
    return p, lambda p, x, part=None: attn.mla_apply(
        p, x, h=cfg.n_heads, rope_theta=cfg.rope_theta, part=part, **dims), d


def train_forms(torch, device="cuda", seq=TRAIN_FORM_SEQ) -> dict:
    """(c) One full-width block of each training-only form (Mamba2's chunked
    SSD, mLSTM's chunkwise form, sLSTM's scans, MLA's training attention),
    forward and backward over (1, ``seq``, d) at chunk TRAIN_CHUNK, so that
    the state crosses a chunk border, on the card against the CPU in
    float32: the output and every gradient (params and input, one seeded
    cotangent) within ATOL * max(1, max|ref|) + RTOL*|ref| of the leaf."""
    errs = {}
    for arch, kind in TRAIN_FORMS:
        gen = torch.Generator().manual_seed(6)
        p, fn, d = _form(torch, arch, kind, gen)
        x = torch.randn((1, seq, d), generator=gen) * 0.5
        res = {}
        for side, dev in (("card", device), ("host", "cpu")):
            pd = _tree_map(lambda v: v.to(dev).requires_grad_(), p)
            xd = x.to(dev).requires_grad_()
            y = fn(pd, xd)
            if side == "host":
                ct = torch.randn(y.shape, generator=gen)
            res[side] = (y, pd, xd)
        grads = {}
        for side, dev in (("card", device), ("host", "cpu")):
            y, pd, xd = res[side]
            leaves = list(_leaves(pd)) + [xd]
            grads[side] = [y.detach()] + list(torch.autograd.grad(
                y, leaves, ct.to(dev), allow_unused=True))
        err, scale = 0.0, 0.0
        for i, (a, r) in enumerate(zip(grads["card"], grads["host"])):
            if r is None:
                continue
            a, m = a.cpu(), float(r.abs().max())
            bad = (a - r).abs() > ATOL * max(1.0, m) + RTOL * r.abs()
            if bool(bad.any()):
                raise AssertionError(f"train {arch} {kind}: output/gradient {i} on the "
                                     f"card differs from the CPU: max err "
                                     f"{float((a - r).abs().max())}, max |ref| {m}")
            err, scale = max(err, float((a - r).abs().max())), max(scale, m)
        errs[kind] = err
        print(f"train: {arch} one {kind} block at full width (d "
              f"{d}), forward and backward over {seq} positions at chunk "
              f"{TRAIN_CHUNK} in float32 on the card against the CPU: max abs err "
              f"{err:.3g} (max |ref| {scale:.3g}; within {ATOL}*max(1, max|ref|) + "
              f"{RTOL}*|ref| per leaf, TF32 off)")
    return errs


def part_forms(torch, device="cuda", seq=TRAIN_FORM_SEQ) -> int:
    """(c) each PART_FORMS block (``_form``'s full-width weights and input:
    Mamba2, mLSTM, sLSTM, deepseek-v3's MLA, llama-vision's gated cross
    block, whisper's encoder block) through its partitioned form
    over the one-rank Part of a 1 x 1 mesh (a world of one rank over NCCL,
    made here and destroyed) against the unpartitioned block on the card,
    deterministic algorithms on: the output and every gradient (params and
    input, one seeded cotangent) bitwise.  Returns the tensors compared."""
    import torch.distributed as dist
    from repro_torch.dist.collectives import Part
    mesh = dist_world(torch)
    compared = 0
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        part = Part(mesh.group("model"), mesh.coord("model"), mesh.axis_size("model"))
        for arch, kind in PART_FORMS:
            gen = torch.Generator().manual_seed(6)
            p, fn, d = _form(torch, arch, kind, gen)
            x = torch.randn((1, seq, d), generator=gen) * 0.5
            ct = torch.randn((1, seq, d), generator=gen).to(device)
            outs = {}
            for arm, pt in (("whole", None), ("part", part)):
                pd = _tree_map(lambda v: v.to(device).requires_grad_(), p)
                xd = x.to(device).requires_grad_()
                y = fn(pd, xd, part=pt)
                outs[arm] = [y.detach()] + list(torch.autograd.grad(
                    y, list(_leaves(pd)) + [xd], ct))
            for i, (a, b) in enumerate(zip(outs["whole"], outs["part"])):
                if not torch.equal(a, b):
                    raise AssertionError(f"train {kind}: output/gradient {i} of the "
                                         f"partitioned block differs from the whole "
                                         f"block by {float((a - b).abs().max())}")
            compared += len(outs["part"])
            print(f"train: {arch} one {kind} block at full width through its "
                  f"partitioned form over a one-rank Part (NCCL), forward and backward "
                  f"over {seq} positions: the output and all {len(outs['part']) - 1} "
                  f"gradients bitwise the unpartitioned block's")
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
    return compared


def train_path(torch, counters, smi, device="cuda") -> tuple[dict, dict]:
    """PHASE train: (a) ``train_full``; (b) ``train_family`` over
    TRAIN_FAMILIES, whose MoE steps launch the sketch update and mark
    kernels (counted, and required); (c) ``train_forms`` and
    ``part_forms``.  Returns the launches and (a)'s figures."""
    torch.backends.cuda.matmul.allow_tf32 = False
    full = train_full(torch, smi, device=device)
    release(torch)
    zero_counts(counters)
    for arch, kw, kind in TRAIN_FAMILIES:
        train_family(torch, arch, kw, kind, device)
    launches = read_counts(torch, counters, "train", required=counters[1:3])
    train_forms(torch, device)
    part_forms(torch, device)
    return launches, full


# -- PHASE dist: the distribution layer at world size 1 over NCCL ---------------

DIST_STEPS = 2          # (a): steps of each arm
DIST_TRAIN = dict(zero1=True, compress_collective=True, offload_master=True,
                  local_grads=True, fsdp=True)
DIST_DECODE = (4, 16, 8, 4)        # (b): batch, steps, ring slots, page tokens
DIST_MOE = ("kimi-k2-1t-a32b", "deepseek-v3-671b")
DIST_PROMPT = (2, 12, 8)           # (c): batch, prompt tokens, new tokens
DIST_ADAFACTOR = ("deepseek-v3-671b",)   # (c): the dry run's optimizer for the MoE archs
DIST_SLICE = ("mla", "moe")        # (d): PHASE mla's and moe's arch and depth, in turn
DIST_SLICE_PROMPT = 8              # (d), (e): prompt tokens before the greedy steps
DIST_RECURRENT = SSM_ARCHS         # (e): PHASE ssm's archs at its depth, in turn
# (f): PHASE cross's archs at full width, llama-vision's depth cut to two
# patterns (two cross blocks), whisper's whole
DIST_CROSS = {"llama-3.2-vision-11b": 10, "whisper-base": None}


def dist_world(torch):
    """A process group of one rank over NCCL, in process (a HashStore: no
    address, no port), and its ("data", "model") 1 x 1 mesh, each of whose
    process groups (one axis, both) makes its NCCL communicator here, while
    the card is empty: NCCL allocates outside PyTorch's cache, and made
    lazily inside a full-width step it finds no memory left."""
    import torch.distributed as dist
    from repro_torch.dist import collectives as col
    from repro_torch.launch.mesh import backend_for, make_host_mesh
    torch.cuda.set_device(0)
    dist.init_process_group(backend_for("cuda"), store=dist.HashStore(), rank=0,
                            world_size=1)
    mesh = make_host_mesh(model=1)
    for axes in (("data",), ("model",), ("data", "model")):
        col.all_reduce(torch.zeros(1, device="cuda"), mesh.group(axes))
    return mesh


def dist_train(torch, mesh, smi, cfg=None, device="cuda", shape=(TRAIN_BATCH, TRAIN_SEQ),
               steps=DIST_STEPS) -> dict:
    """(a) TRAIN_ARCH at full width and depth (seed 0, PHASE train's batch):
    ``steps`` steps of ZeRO-1 with its int8 delta, the master vectors
    offloaded, local_grads and fsdp, without a mesh (where those options are
    no-ops) and over ``mesh``, in turn from the same weights; deterministic
    algorithms on, so that the arms' losses, gradient norms and params must
    be bitwise equal.  Over the mesh the dense decoder computes its share
    over 'model' (the partitioned embedding, attention, MLPs and head of
    ``models/layers.py`` and ``models/attention.py``, one rank of 'model'
    here); prints how many leaves computed split over 'model' and how many
    were gathered whole.  Over the mesh m, v and ef must be pinned host
    tensors between steps; prints the device-resident GiB between steps,
    each arm's peak, and each step's fetch of the master vectors
    (side-stream CUDA events: its ms, how much of it ran before the update
    reached it, the stall)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import zero1
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.train import step as ts
    cfg = cfg or get_config(TRAIN_ARCH)
    b, s = shape
    tcfg = ts.TrainConfig(opt=OptConfig(**TRAIN_OPT), microbatches=TRAIN_MICRO,
                          remat=True, **DIST_TRAIN)
    data = SyntheticLM(DataConfig(seq_len=s, global_batch=b, vocab=cfg.vocab, seed=1234))
    fetch = zero1.fetch_opt
    fetches, times = [], []

    def recorded(state, m):
        pre = fetch(state, m)
        fetches.append(pre)
        return pre
    arms = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for arm, msh in (("meshless", None), ("mesh", mesh)):
            release(torch)
            state = ts.init_state(cfg, tcfg, init_params(cfg, seed=0, device=device),
                                  device=device, mesh=msh)
            fn = ts.build_train_step(cfg, msh, tcfg)
            rec, resident, wall = [], [], []
            zero1.fetch_opt = recorded
            try:
                for i in range(steps):
                    batch = ts.to_batch(data.batch(i, 0, 1), device, mesh=msh)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state, m = fn(state, batch)
                    torch.cuda.synchronize()
                    wall.append(time.perf_counter() - t0)
                    times += _fetch_times(fetches)
                    rec.append((float(m["loss"]), float(m["gnorm"])))
                    resident.append(torch.cuda.memory_allocated() / 2 ** 30)
                    if msh is not None and device == "cuda":
                        for k in ("m", "v", "ef"):
                            t = state["opt"][k]
                            if t.device.type != "cpu" or not t.is_pinned():
                                raise AssertionError(f"dist: {k} is not a pinned host "
                                                     f"tensor between steps ({t.device})")
            finally:
                zero1.fetch_opt = fetch
            arms[arm] = dict(metrics=rec, resident=resident, wall=wall,
                             peak=torch.cuda.max_memory_allocated() / 2 ** 30,
                             dp_bytes=m.get("dp_psum_bytes"),
                             params=[p.cpu() for p in _leaves(state["params"])])
            del state, fn
    finally:
        torch.use_deterministic_algorithms(False)
    a, z = arms["meshless"], arms["mesh"]
    if a["metrics"] != z["metrics"]:
        raise AssertionError(f"dist: losses and norms differ: {a['metrics']} "
                             f"{z['metrics']}")
    for x, y in zip(a["params"], z["params"]):
        if not torch.equal(x, y):
            raise AssertionError("dist: the mesh arm's params differ from the meshless "
                                 "arm's")
    if device == "cuda" and len(times) != steps:
        raise AssertionError(f"dist: {len(times)} fetches timed in {steps} steps")
    n_split, n_gathered = split_leaves(cfg, mesh, fsdp=tcfg.fsdp)
    if n_split == 0 or n_gathered:
        raise AssertionError(f"dist (a): {n_split} leaves computed split over 'model', "
                             f"{n_gathered} gathered: not the partitioned path")
    print(f"dist (a): {cfg.name} at full width and depth, {steps} steps of "
          f"{', '.join(k for k in DIST_TRAIN)} without a mesh and over the 1 x 1 "
          f"NCCL mesh, bitwise equal (losses and gradient norms "
          f"{[(round(l, 6), round(g, 6)) for l, g in a['metrics']]}, every param); "
          f"dp_psum_bytes {z['dp_bytes']}; over the mesh {n_split} leaves computed "
          f"split over 'model', {n_gathered} gathered whole")
    print(f"dist (a): ms a step, meshless {[round(1e3 * x, 1) for x in a['wall']]}, "
          f"mesh {[round(1e3 * x, 1) for x in z['wall']]} (step 1 included), on {smi}")
    print(f"dist (a): device-resident GiB between steps: meshless "
          f"{[round(x, 2) for x in a['resident']]}, mesh (m, v, ef pinned on the host) "
          f"{[round(x, 2) for x in z['resident']]}; peak {a['peak']:.2f} / "
          f"{z['peak']:.2f} GiB, on {smi}")
    print(f"dist (a): the master vectors' fetch a step: "
          + "; ".join(f"{ms:.1f} ms, {before:.1f} ms of it before the update reached it, "
                      f"stall {stall:.1f} ms" for ms, before, stall in times)
          + f", on {smi}")
    return dict(peak=(a["peak"], z["peak"]), resident=(a["resident"][-1], z["resident"][-1]),
                fetch=times, step_ms=(1e3 * statistics.median(a["wall"]),
                                      1e3 * statistics.median(z["wall"])))


def split_leaves(cfg, mesh, fsdp: bool = False) -> tuple:
    """(leaves that compute their share over 'model', leaves gathered whole
    over 'model') of ``cfg``'s params stored over ``mesh``."""
    from repro_torch.dist.sharding import param_pspecs
    from repro_torch.models.transformer import init_params
    from repro_torch.train import step as ts
    specs = param_pspecs(init_params(cfg, device="meta"), mesh, fsdp=fsdp)
    return ts.split_counts(ts.compute_layout(cfg, mesh, specs), specs)


def _fetch_times(fetches: list) -> list:
    """(ms, ms before the update reached it, stall ms) of each timed
    prefetch, which the list then lets go of (a prefetch refers to the
    state it moved)."""
    out = []
    while fetches:
        pre = fetches.pop(0)
        if pre.start is not None:
            ms = pre.start.elapsed_time(pre.end)
            out.append((ms, min(ms, pre.start.elapsed_time(pre.waited)),
                        max(0.0, pre.waited.elapsed_time(pre.end))))
    return out


def dist_decode(torch, mesh, params, cfg, smi, device="cuda", dims=DIST_DECODE) -> dict:
    """(b) decode_step_paged with the ring's slots split over both mesh axes
    (one rank) and the params stored under ``param_pspecs``, each group
    gathered and partitioned over 'model' (``layout``), against the
    unsharded ring without a mesh, greedy from the same token: tokens
    equal, logits within 1e-3, page mass within 1e-5, pages, page_len and
    cur_slot bitwise."""
    from repro_torch.ckpt.manager import tree_leaves, tree_unflatten
    from repro_torch.dist.sharding import cache_pspecs, param_pspecs, shard, spec_leaves
    from repro_torch.models import decode as dec
    from repro_torch.train.step import compute_layout
    b, steps, n_slots, page_t = dims
    pspecs = param_pspecs(params, mesh)
    stored = tree_unflatten(params, [shard(x, sp, mesh) for x, sp in
                                     zip(tree_leaves(params), spec_leaves(pspecs))])
    layout = compute_layout(cfg, mesh, pspecs)
    arms = {}
    for arm, smesh in (("sharded", {"mesh": mesh, "axes": ("data", "model")}),
                       ("unsharded", None)):
        cache = dec.init_paged_cache(cfg, b, n_slots, page_t, device=device)
        if smesh is not None:
            specs = spec_leaves(cache_pspecs(cache, mesh, slot_axes=smesh["axes"]))
            cache = tree_unflatten(cache, [shard(x, sp, mesh) for x, sp in
                                           zip(tree_leaves(cache), specs)])
        tok = torch.zeros((b, 1), dtype=torch.int32, device=device)
        toks, logits, mass = [], [], []
        for _ in range(steps):
            lg, cache, st = dec.decode_step_paged(
                cfg, params if smesh is None else stored, cache, tok, page_t=page_t,
                return_streams=True, smesh=smesh, layout=None if smesh is None else layout)
            logits.append(lg[:, -1].float())
            mass.append(st["kv_mass"])
            tok = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            toks.append(tok)
        torch.cuda.synchronize()
        arms[arm] = dict(tokens=torch.cat(toks, 1), logits=torch.stack(logits),
                         mass=torch.stack(mass), cache=cache)
    sh, un = arms["sharded"], arms["unsharded"]
    if not torch.equal(sh["tokens"], un["tokens"]):
        raise AssertionError("dist (b): greedy tokens differ")
    gap = float((sh["logits"] - un["logits"]).abs().max())
    mgap = float((sh["mass"] - un["mass"]).abs().max())
    if gap > 1e-3 or mgap > 1e-5:
        raise AssertionError(f"dist (b): logits {gap} / mass {mgap} apart")
    for i, (x, y) in enumerate(zip(sh["cache"]["blocks"], un["cache"]["blocks"])):
        for k in ("k_pages", "v_pages", "page_len", "cur_slot"):
            if not torch.equal(x[k], y[k]):
                raise AssertionError(f"dist (b): {k} of pattern position {i} differs")
    cur = int(un["cache"]["blocks"][0]["cur_slot"].max())
    n_split, n_gathered = split_leaves(cfg, mesh)
    if n_split == 0 or n_gathered:
        raise AssertionError(f"dist (b): {n_split} leaves computed split over 'model', "
                             f"{n_gathered} gathered: not the partitioned path")
    print(f"dist (b): {cfg.name} at full width, B {b}, {steps} greedy steps over "
          f"{n_slots} slots of {page_t} tokens, the slots split over ('data', 'model'), "
          f"{n_split} leaves computed split over 'model' and {n_gathered} gathered: "
          f"tokens equal, logits {gap:.3g} apart (bound 1e-3), page mass {mgap:.3g} "
          f"(bound 1e-5), k/v pages, page_len and cur_slot bitwise (cur_slot {cur}), "
          f"on {smi}")
    return dict(logit_gap=gap, mass_gap=mgap)


def dist_moe(torch, mesh, arch, smi, device="cuda") -> dict:
    """(c) ``arch`` at its smoke config: one float32 train step over the
    mesh, partitioned over 'model' (attention, dense prologue, shared
    expert, embedding and head; deepseek-v3's MTP head) with the experts
    expert-parallel (``EPContext``), AdamW or, for DIST_ADAFACTOR,
    Adafactor's block update, on the card against the meshless step on the
    CPU from the same params and batch (the loss within ATOL + RTOL*|ref|,
    the router stream fed to the sketch equal, the card's NeoProf state
    bitwise a CPU replay of the card's stream); prints the leaves computed
    split over 'model' and those gathered whole (none); then one request
    through ``ServeEngine(ep_axes=)`` on the card against the meshless
    engine on the CPU fed the card's tokens (``hold_logits``)."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.core import neoprof as npf
    from repro_torch.core import sketch as sk
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.train import step as ts
    cfg = get_smoke_config(arch)
    opt = "adafactor" if arch in DIST_ADAFACTOR else "adamw"
    tcfg = ts.TrainConfig(opt=OptConfig(kind=opt), microbatches=2)
    n_split, n_gathered = split_leaves(cfg, mesh)
    if n_split == 0 or n_gathered:
        raise AssertionError(f"dist (c) {arch}: {n_split} leaves computed split over "
                             f"'model', {n_gathered} gathered: not the partitioned path")
    host = _family_params(torch, cfg)
    batch = SyntheticLM(DataConfig(seq_len=32, global_batch=4, vocab=cfg.vocab,
                                   seed=1234)).batch(0, 0, 1)
    streams, observe = {}, ts.neoprof_observe

    def recorded(side):
        def fn(prof, ids, params):
            streams[side] = ids.cpu()
            return observe(prof, ids, params)
        return fn
    out = {}
    for side, dev, msh in (("card", device, mesh), ("host", "cpu", None)):
        state = ts.init_state(cfg, tcfg, _tree_map(lambda v: v.to(dev, copy=True), host),
                              device=dev, mesh=msh)
        ts.neoprof_observe = recorded(side)
        try:
            state, m = ts.build_train_step(cfg, msh, tcfg)(
                state, ts.to_batch(batch, dev, mesh=msh))
        finally:
            ts.neoprof_observe = observe
        out[side] = (state, m)
    (cs, cm), (_, hm) = out["card"], out["host"]
    err = held(torch, cm["loss"].reshape(1), hm["loss"].reshape(1), f"dist {arch}: loss")
    if not torch.equal(streams["card"], streams["host"]):
        raise AssertionError(f"dist {arch}: the router stream differs from the CPU's")
    pp = ts.prof_params(tcfg)
    replay = npf.neoprof_observe(
        npf.neoprof_init(pp, sk.key_seeds(pp.sketch.depth, pp.sketch.width),
                         device="cpu"), streams["card"], pp)
    for f in ("counts", "epochs", "hot", "n_seen"):
        if not torch.equal(getattr(cs["prof"].sketch, f).cpu(), getattr(replay.sketch, f)):
            raise AssertionError(f"dist {arch}: sketch {f} differs from the CPU replay")
    ep = ts._ep_context(cfg, mesh)
    b, p_len, new = DIST_PROMPT
    prompts = np.random.default_rng(7).integers(0, cfg.vocab, (b, p_len)).astype(np.int32)
    serve = dict(max_seq=64, paged=True, page_t=4, hot_slots=6, resources=("experts",),
                 expert_hot_slots=4)
    eng = ServeEngine(cfg, _tree_map(lambda v: v.to(device), host), ServeConfig(**serve),
                      device=device, ep_axes=ep)
    if "experts" in eng._tier_reads():
        raise AssertionError(f"dist {arch}: the experts tier view reached the EP engine")
    card = drive_arm(torch, eng, prompts, new)
    cpu = drive_arm(torch, ServeEngine(cfg, host, ServeConfig(**serve), device="cpu"),
                    prompts, new, feed=card["tokens"].cpu())
    hold_logits(torch, cfg, card["logits"].float().cpu(), cpu["logits"].float(), "dist",
                "ServeEngine(ep_axes=) and the CPU engine")
    print(f"dist (c): {arch} smoke, one float32 {opt} train step over the mesh, "
          f"{n_split} leaves computed split over 'model', {n_gathered} gathered whole, "
          f"the experts expert-parallel: loss {float(cm['loss']):.6f} within {err:.3g} "
          f"of the CPU's (bound "
          f"{ATOL} + {RTOL}*|ref|), router stream ({streams['card'].numel()} ids) equal, "
          f"sketch bitwise a CPU replay; ServeEngine(ep_axes=) served {new} tokens "
          f"x {b} rows, on {smi}")
    return {"loss_err": err}


def paged_arms(torch, mesh, cfg, params, device="cuda", ep=None,
               dims=DIST_DECODE) -> tuple:
    """``cfg``'s paged serving over ``mesh`` and without one, from the same
    weights: over the mesh its params stored under ``param_pspecs`` and
    computing as the dry run's long_500k cell does (``layout``, partitioned
    over 'model'; ``ep`` runs the experts expert-parallel; the ring's slots
    split over both axes), ``prefill_paged`` of a seeded
    DIST_SLICE_PROMPT-token prompt, then greedy ``decode_step_paged`` steps.
    Returns ({arm: tokens, logits, page mass (None without a ring), the
    final cache, attention launches (all, head-tiled)}, (leaves computed
    split over 'model', leaves gathered whole))."""
    from repro_torch.ckpt.manager import tree_leaves, tree_unflatten
    from repro_torch.dist.sharding import cache_pspecs, param_pspecs, shard, spec_leaves
    from repro_torch.kernels.paged_attn import ops as pa_ops
    from repro_torch.models import decode as dec
    from repro_torch.train import step as ts
    b, steps, n_slots, page_t = dims
    pspecs = param_pspecs(params, mesh)
    stored = tree_unflatten(params, [shard(x, sp, mesh) for x, sp in
                                     zip(tree_leaves(params), spec_leaves(pspecs))])
    layout = ts.compute_layout(cfg, mesh, pspecs)
    prompt = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab, (b, DIST_SLICE_PROMPT)).astype(np.int32)).to(device)
    arms = {}
    for arm, smesh in (("mesh", {"mesh": mesh, "axes": ("data", "model")}),
                       ("meshless", None)):
        kw = {} if smesh is None else dict(smesh=smesh, layout=layout, ep_axes=ep)
        cache = dec.init_paged_cache(cfg, b, n_slots, page_t, device=device)
        if smesh is not None:
            specs = spec_leaves(cache_pspecs(cache, mesh, slot_axes=smesh["axes"]))
            cache = tree_unflatten(cache, [shard(x, sp, mesh) for x, sp in
                                           zip(tree_leaves(cache), specs)])
        p = params if smesh is None else stored
        torch.cuda.synchronize()
        raw, tiled = pa_ops.paged_attention_raw.launches, pa_ops.head_tiled.launches
        last, cache, _ = dec.prefill_paged(cfg, p, cache, prompt, page_t=page_t, **kw)
        tok = last.argmax(-1, keepdim=True).to(torch.int32)
        toks, logits, mass = [tok], [last.float()], []
        for _ in range(steps):
            lg, cache, st = dec.decode_step_paged(cfg, p, cache, tok, page_t=page_t,
                                                  return_streams=True, **kw)
            logits.append(lg[:, -1].float())
            mass.append(st["kv_mass"])
            tok = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            toks.append(tok)
        torch.cuda.synchronize()
        arms[arm] = dict(tokens=torch.cat(toks, 1), logits=torch.stack(logits),
                         mass=None if mass[0] is None else torch.stack(mass),
                         cache=cache,
                         launches=(pa_ops.paged_attention_raw.launches - raw,
                                   pa_ops.head_tiled.launches - tiled))
    return arms, ts.split_counts(layout, pspecs)


def dist_slice(torch, mesh, phase, smi, device="cuda", dims=DIST_DECODE) -> dict:
    """(d) PHASE ``phase``'s arch at full width and the phase's depth
    (``draw_moe_params``: every expert on the card) through ``paged_arms``
    (attention, dense prologue, shared expert, embedding and head
    partitioned over the one 'model' rank, the experts expert-parallel):
    tokens equal, logits within 1e-3, page mass within 1e-5, every ring's
    pages, page_len and cur_slot bitwise; then ``dense_arms`` (the dense
    cache's sequence split over the rank, ``hold_dense``: logits within
    1e-3, every cache leaf bitwise).  Prints the leaves split and gathered,
    the attention-cache leaves attended split and gathered whole, and each
    arm's attention launches (the head-tiled kernel's for MLA)."""
    from repro_torch.train import step as ts
    cfg, params = draw_moe_params(torch, phase)
    b, steps, n_slots, page_t = dims
    ep = ts._ep_context(cfg, mesh)
    arms, (n_split, n_gathered) = paged_arms(torch, mesh, cfg, params, device, ep, dims)
    dense, _, cache_leaves = dense_arms(torch, mesh, cfg, params, None, device, dims, ep)
    dgap, n_dense = hold_dense(torch, f"dist (d) {cfg.name}", cfg, dense, cache_leaves,
                               dims, logit_bound=1e-3)
    if n_split == 0 or n_gathered:
        raise AssertionError(f"dist (d) {cfg.name}: {n_split} leaves computed split over "
                             f"'model', {n_gathered} gathered: not the partitioned path")
    sh, un = arms["mesh"], arms["meshless"]
    if not torch.equal(sh["tokens"], un["tokens"]):
        raise AssertionError(f"dist (d) {cfg.name}: greedy tokens differ")
    gap = float((sh["logits"] - un["logits"]).abs().max())
    mgap = float((sh["mass"] - un["mass"]).abs().max())
    if gap > 1e-3 or mgap > 1e-5:
        raise AssertionError(f"dist (d) {cfg.name}: logits {gap} / mass {mgap} apart")
    rings = list(zip(sh["cache"]["blocks"], un["cache"]["blocks"]))
    rings += list(zip(sh["cache"].get("prologue", []), un["cache"].get("prologue", [])))
    for i, (x, y) in enumerate(rings):
        for k in ("k_pages", "v_pages", "page_len", "cur_slot"):
            if not torch.equal(x[k], y[k]):
                raise AssertionError(f"dist (d) {cfg.name}: {k} of ring {i} differs")
    tiled = sh["launches"][0] if cfg.mla is not None else 0
    if device == "cuda" and (sh["launches"] != un["launches"] or not sh["launches"][0]
                             or sh["launches"][1] != tiled):
        raise AssertionError(f"dist (d) {cfg.name}: attention launches (all, head-tiled) "
                             f"mesh {sh['launches']}, meshless {un['launches']}")
    form = "head-tiled" if cfg.mla is not None else "grouped"
    print(f"dist (d): {cfg.name} at full width, depth {cfg.n_layers} "
          f"({cfg.moe.n_dense_prologue} dense + {cfg.n_groups} MoE, {cfg.moe.n_experts} "
          f"experts on the card), B {b}, a {DIST_SLICE_PROMPT}-token prefill_paged and "
          f"{steps} greedy decode_step_paged steps over {n_slots} slots of {page_t} "
          f"tokens, partitioned over 'model' ({n_split} leaves computed split, "
          f"{n_gathered} gathered whole), the experts expert-parallel, the slots split "
          f"over ('data', 'model'), against the meshless calls: tokens equal, logits "
          f"{gap:.3g} apart (bound 1e-3), page mass {mgap:.3g} (bound 1e-5), every "
          f"ring's pages, page_len and cur_slot bitwise; attention launches "
          f"{sh['launches'][0]} an arm, all {form} (head-tiled {sh['launches'][1]}); "
          f"dense arm (prefill_dense and {steps - 1} greedy decode_step steps, "
          f"attention-cache leaves attended split {cache_leaves[0]}, gathered whole "
          f"{cache_leaves[1]}) tokens equal, logits {dgap:.3g} apart (bound 1e-3), all "
          f"{n_dense} cache leaves bitwise; on {smi}")
    return dict(logit_gap=gap, mass_gap=mgap, split=(n_split, n_gathered),
                cache_leaves=cache_leaves, launches=sh["launches"])


def dist_recurrent(torch, mesh, arch, smi, device="cuda", dims=DIST_DECODE) -> dict:
    """(e) ``arch`` (DIST_RECURRENT) at full width and PHASE ssm's depth
    through ``paged_arms``, deterministic algorithms on: the recurrent
    mixers (zamba2's Mamba2 by heads, in_proj gathered whole, B | C split
    and gathered; xlstm's mLSTM by heads and sLSTM by channels), zamba2's
    shared attention block, the embedding and the head partitioned over the
    one 'model' rank, against the meshless calls: tokens equal, logits 0
    apart, page mass 0 apart, every ring's pages and every recurrent state
    bitwise; then ``dense_arms`` (the dense cache's sequence split over the
    rank, ``hold_dense``, bitwise).  Prints the leaves split and gathered,
    the attention-cache leaves attended split and gathered whole, and the
    grouped attention launches of each arm."""
    cfg, params = draw_dense_params(torch, arch, phase="dist", depth=SSM_DEPTH[arch])
    b, steps, n_slots, page_t = dims
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        arms, (n_split, n_gathered) = paged_arms(torch, mesh, cfg, params, device,
                                                 dims=dims)
        dense, _, cache_leaves = dense_arms(torch, mesh, cfg, params, None, device, dims)
    finally:
        torch.use_deterministic_algorithms(False)
    _, n_dense = hold_dense(torch, f"dist (e) {cfg.name}", cfg, dense, cache_leaves, dims)
    if n_split == 0 or n_gathered:
        raise AssertionError(f"dist (e) {cfg.name}: {n_split} leaves computed split over "
                             f"'model', {n_gathered} gathered: not the partitioned path")
    sh, un = arms["mesh"], arms["meshless"]
    for key in ("tokens", "logits", "mass"):
        if (sh[key] is None) != (un[key] is None) or (
                sh[key] is not None and not torch.equal(sh[key], un[key])):
            raise AssertionError(f"dist (e) {cfg.name}: the arms' {key} differ")
    n_leaves = 0
    for i, (x, y) in enumerate(zip(sh["cache"]["blocks"], un["cache"]["blocks"])):
        for k in y:
            n_leaves += 1
            if not torch.equal(x[k], y[k]):
                raise AssertionError(f"dist (e) {cfg.name}: {k} of pattern position {i} "
                                     f"({cfg.pattern[i]}) differs")
    rings = sum("shared_attn" == k for k in cfg.pattern) * cfg.n_groups
    want = rings * (DIST_SLICE_PROMPT + steps)
    if device == "cuda" and (sh["launches"] != un["launches"]
                             or sh["launches"] != (want, 0)):
        raise AssertionError(f"dist (e) {cfg.name}: attention launches (all, head-tiled) "
                             f"mesh {sh['launches']}, meshless {un['launches']}, "
                             f"{want} grouped expected")
    print(f"dist (e): {cfg.name} at full width, depth {cfg.n_layers} (pattern "
          f"{cfg.pattern}), B {b}, a {DIST_SLICE_PROMPT}-token prefill_paged and {steps} "
          f"greedy decode_step_paged steps, partitioned over 'model' ({n_split} leaves "
          f"computed split, {n_gathered} gathered whole), the slots split over ('data', "
          f"'model'), against the meshless calls: tokens equal, logits and page mass 0 "
          f"apart, all {n_leaves} ring and recurrent-state leaves bitwise; grouped "
          f"attention launches {sh['launches'][0]} an arm; dense arm (prefill_dense "
          f"and {steps - 1} greedy decode_step steps, attention-cache leaves attended "
          f"split {cache_leaves[0]}, gathered whole {cache_leaves[1]}) tokens equal, "
          f"logits 0 apart, all {n_dense} cache leaves bitwise; on {smi}")
    return dict(split=(n_split, n_gathered), cache_leaves=cache_leaves,
                launches=sh["launches"])


def dense_arms(torch, mesh, cfg, params, aux, device="cuda", dims=DIST_DECODE,
               ep=None) -> tuple:
    """``cfg``'s dense-cache serving over ``mesh`` and without one, from the
    same weights and ``aux`` (an image's patches, or an encoder arch's
    frames, ``encode``d first in each arm; None for neither): over the mesh
    its params stored under ``param_pspecs`` and its cache under
    ``cache_pspecs``, computing as the dry run's decode_32k cell does
    (``layout``, partitioned over 'model'; ``ep`` runs the experts
    expert-parallel; ``cache_layout``, each block's core over the rank's
    block of the 'model'-split sequence), ``prefill_dense`` of a seeded
    DIST_SLICE_PROMPT-token prompt, then greedy ``decode_step`` steps.
    Returns ({arm: the encoder's output (None without an encoder), tokens,
    logits, the final cache}, (leaves computed split over 'model', leaves
    gathered whole), (attention-cache leaves the mesh arm's cores attended
    split, and whole: every leaf rests split, so a whole one was gathered;
    ``decode.CACHE_LEAVES``, a leaf a block and step))."""
    from repro_torch.ckpt.manager import tree_leaves, tree_unflatten
    from repro_torch.dist.sharding import (DP_AXES, Layout, cache_pspecs, drop_axes,
                                           param_pspecs, shard, spec_leaves,
                                           tree_map_with_path)
    from repro_torch.models import decode as dec
    from repro_torch.models.transformer import encode
    from repro_torch.train import step as ts
    b, steps, _, _ = dims
    pspecs = param_pspecs(params, mesh)
    stored = tree_unflatten(params, [shard(x, sp, mesh) for x, sp in
                                     zip(tree_leaves(params), spec_leaves(pspecs))])
    layout = ts.compute_layout(cfg, mesh, pspecs)
    prompt = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab, (b, DIST_SLICE_PROMPT)).astype(np.int32)).to(device)
    arms, counted = {}, None
    for arm in ("mesh", "meshless"):
        cache = dec.init_cache(cfg, b, DIST_SLICE_PROMPT + steps, device=device)
        p, kw = params, {}
        if arm == "mesh":
            cspecs = cache_pspecs(cache, mesh)
            cache = tree_unflatten(cache, [shard(x, sp, mesh) for x, sp in
                                           zip(tree_leaves(cache), spec_leaves(cspecs))])
            p, kw = stored, dict(layout=layout, ep_axes=ep, cache_layout=Layout(
                mesh, tree_map_with_path(lambda _, sp: drop_axes(sp, DP_AXES), cspecs)))
            counted = dict(dec.CACHE_LEAVES)
        src = aux
        if cfg.encoder_layers:
            src = encode(cfg, p, aux, **({} if arm == "meshless" else dict(layout=layout)))
        xkw = {} if aux is None else dict(aux_embeds=src)
        last, cache, _ = dec.prefill_dense(cfg, p, cache, prompt, **xkw, **kw)
        tok = last.argmax(-1, keepdim=True).to(torch.int32)
        toks, logits = [tok], [last.float()]
        for _ in range(steps - 1):
            lg, cache = dec.decode_step(cfg, p, cache, tok, **xkw, **kw)
            logits.append(lg[:, -1].float())
            tok = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            toks.append(tok)
        torch.cuda.synchronize()
        if arm == "mesh":
            counted = tuple(dec.CACHE_LEAVES[k] - counted[k] for k in ("split", "whole"))
        arms[arm] = dict(enc=src if cfg.encoder_layers else None,
                         tokens=torch.cat(toks, 1), logits=torch.stack(logits), cache=cache)
    return arms, ts.split_counts(layout, pspecs), counted


def hold_dense(torch, tag, cfg, arms, cache_leaves, dims=DIST_DECODE,
               logit_bound=0.0) -> tuple:
    """``dense_arms``' two arms held to each other: tokens equal, logits
    within ``logit_bound`` (0: equal), every cache leaf (the dense
    prologue's too) bitwise; the mesh arm's cores attended every
    attention-cache leaf split, once a block and step (two leaves a block:
    K and V, MLA's latent and rope key), and gathered none whole.  Returns
    (the logit gap, the cache leaves compared)."""
    from repro_torch.models.transformer import RECURRENT_KINDS
    sh, un = arms["mesh"], arms["meshless"]
    if not torch.equal(sh["tokens"], un["tokens"]):
        raise AssertionError(f"{tag}: the dense arms' tokens differ")
    gap = float((sh["logits"] - un["logits"]).abs().max())
    if gap > logit_bound:
        raise AssertionError(f"{tag}: the dense arms' logits {gap} apart (bound "
                             f"{logit_bound})")
    pairs = [(f"pattern position {i}", x, y) for i, (x, y) in
             enumerate(zip(sh["cache"]["blocks"], un["cache"]["blocks"]))]
    pairs += [(f"prologue {j}", x, y) for j, (x, y) in
              enumerate(zip(sh["cache"].get("prologue", []), un["cache"].get("prologue", [])))]
    n_leaves = 0
    for where, x, y in pairs:
        for k in y:
            n_leaves += 1
            if not torch.equal(x[k], y[k]):
                raise AssertionError(f"{tag}: dense cache {k} of {where} differs")
    blocks = sum(k not in RECURRENT_KINDS for k in cfg.pattern) * cfg.n_groups
    blocks += cfg.moe.n_dense_prologue if cfg.moe else 0
    want = 2 * blocks * (DIST_SLICE_PROMPT + dims[1] - 1)
    split, gathered = cache_leaves
    if split != want or gathered:
        raise AssertionError(f"{tag}: attention-cache leaves attended split {split} "
                             f"(want {want}), gathered whole {gathered}")
    return gap, n_leaves


def dist_cross(torch, mesh, arch, smi, device="cuda", dims=DIST_DECODE) -> dict:
    """(f) ``arch`` (DIST_CROSS) at full width and its depth there, each
    cross block's gate at CROSS_GATE (so that the image counts), with
    deterministic algorithms on: the self and cross attention (the cross
    step's projection of every patch or frame split over 'model'), MLPs,
    whisper's encoder, the embedding and the head partitioned over the one
    'model' rank, against the meshless calls, seeded (B, n_aux_tokens, d)
    ``aux_embeds``: ``dense_arms`` (whisper's encoder output bitwise,
    ``hold_dense``: tokens equal, logits 0 apart, every cache leaf bitwise,
    the self cores over the 'model'-split sequence) and ``paged_arms``
    (which has no cross step: ROADMAP C6; tokens equal, logits 0 apart,
    every ring bitwise, grouped attention launches equal between the arms
    and one a ring and token).  Prints the leaves split and gathered, the
    attention-cache leaves attended split and gathered whole, and the
    launches."""
    cfg, params = draw_dense_params(torch, arch, phase="dist", depth=DIST_CROSS[arch])
    for blk in params["blocks"]:
        if "xgate" in blk:
            blk["xgate"].fill_(CROSS_GATE)
    b, steps, n_slots, page_t = dims
    aux = cross_aux(torch, cfg, b, device)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        dense, (n_split, n_gathered), cache_leaves = dense_arms(
            torch, mesh, cfg, params, aux, device, dims)
        paged, split = paged_arms(torch, mesh, cfg, params, device, dims=dims)
    finally:
        torch.use_deterministic_algorithms(False)
    if n_split == 0 or n_gathered or split != (n_split, n_gathered):
        raise AssertionError(f"dist (f) {cfg.name}: {n_split} leaves computed split over "
                             f"'model', {n_gathered} gathered: not the partitioned path")
    sh, un = dense["mesh"], dense["meshless"]
    if cfg.encoder_layers and not torch.equal(sh["enc"], un["enc"]):
        raise AssertionError(f"dist (f) {cfg.name}: the encoder's output differs")
    _, n_leaves = hold_dense(torch, f"dist (f) {cfg.name}", cfg, dense, cache_leaves, dims)
    psh, pun = paged["mesh"], paged["meshless"]
    for key in ("tokens", "logits", "mass"):
        if not torch.equal(psh[key], pun[key]):
            raise AssertionError(f"dist (f) {cfg.name}: the paged arms' {key} differ")
    for i, (x, y) in enumerate(zip(psh["cache"]["blocks"], pun["cache"]["blocks"])):
        for k in ("k_pages", "v_pages", "page_len", "cur_slot"):
            if not torch.equal(x[k], y[k]):
                raise AssertionError(f"dist (f) {cfg.name}: {k} of ring {i} differs")
    want = len(cfg.pattern) * cfg.n_groups * (DIST_SLICE_PROMPT + steps)
    if device == "cuda" and (psh["launches"] != pun["launches"]
                             or psh["launches"] != (want, 0)):
        raise AssertionError(f"dist (f) {cfg.name}: attention launches (all, head-tiled) "
                             f"mesh {psh['launches']}, meshless {pun['launches']}, "
                             f"{want} grouped expected")
    enc = (f", the encoder's output {tuple(sh['enc'].shape)} bitwise"
           if cfg.encoder_layers else "")
    print(f"dist (f): {cfg.name} at full width, depth {cfg.n_layers} (pattern "
          f"{cfg.pattern}), B {b} over {cfg.n_aux_tokens} aux embeddings (gate "
          f"{CROSS_GATE}), partitioned over 'model' ({n_split} leaves computed split, "
          f"{n_gathered} gathered whole), against the meshless calls: dense arm "
          f"(prefill_dense of {DIST_SLICE_PROMPT} tokens and {steps - 1} greedy "
          f"decode_step steps; attention-cache leaves attended split {cache_leaves[0]}, "
          f"gathered whole {cache_leaves[1]}) tokens equal, logits 0 apart, all "
          f"{n_leaves} cache leaves bitwise{enc}; paged arm ({DIST_SLICE_PROMPT}-token prefill_paged, "
          f"{steps} greedy steps, no cross step) tokens equal, logits and page mass 0 "
          f"apart, every ring bitwise, grouped attention launches {psh['launches'][0]} "
          f"an arm; on {smi}")
    return dict(split=(n_split, n_gathered), cache_leaves=cache_leaves,
                launches=psh["launches"])


def dist_path(torch, counters, smi, device="cuda") -> tuple[dict, dict]:
    """PHASE dist: a world of one rank over NCCL and its 1 x 1 mesh; (a)
    ``dist_train``, then, counts at 0, (d) ``dist_slice`` on each
    DIST_SLICE phase's arch at full width (right after (a) let go of its
    pinned host vectors, before any other model is drawn), (e)
    ``dist_recurrent`` on each DIST_RECURRENT arch, (f) ``dist_cross`` on
    each DIST_CROSS arch, (b)
    ``dist_decode`` on (a)'s weights (the attention launches) and (c)
    ``dist_moe`` on each DIST_MOE arch (the sketch update and mark
    launches, required).  The process group is destroyed at the end,
    whatever happens."""
    import torch.distributed as dist
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_params
    mesh = dist_world(torch)
    try:
        full = dist_train(torch, mesh, smi)
        release(torch)
        zero_counts(counters)
        slices = {}
        for phase in DIST_SLICE:
            slices[phase] = dist_slice(torch, mesh, phase, smi, device)
            release(torch)
        for arch in DIST_RECURRENT:
            slices[arch] = dist_recurrent(torch, mesh, arch, smi, device)
            release(torch)
        for arch in DIST_CROSS:
            slices[arch] = dist_cross(torch, mesh, arch, smi, device)
            release(torch)
        cfg = get_config(TRAIN_ARCH)
        params = init_params(cfg, seed=0, device=device)
        dec = dist_decode(torch, mesh, params, cfg, smi, device)
        del params
        release(torch)
        for arch in DIST_MOE:
            dist_moe(torch, mesh, arch, smi, device)
        launches = read_counts(torch, counters, "dist", required=counters[:3])
    finally:
        dist.destroy_process_group()
    return launches, dict(full, **dec, slices=slices)


# -- PHASE examples: the four example twins on the card -------------------------

def load_twin(name: str):
    """``examples/<name>_torch.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch", ROOT / "examples" / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def hold_twin(name: str, card: dict, cpu: dict) -> None:
    """A tiering twin's results on the card equal to its CPU run's: the
    printed records, the placement tables, the θ trace and the counts."""
    for key in ("records", "resident", "theta_trace", "counters"):
        if card.get(key) != cpu.get(key):
            raise AssertionError(f"examples (a) {name}: {key} {card.get(key)} on the "
                                 f"card, {cpu.get(key)} on the CPU")
    for key in ("page_slot", "slot_page"):
        if not np.array_equal(card[key], cpu[key]):
            raise AssertionError(f"examples (a) {name}: {key} differs from the CPU")


def examples_tiering(torch, counters, smi, device="cuda") -> dict:
    """(a) quickstart and profile_embeddings at their own sizes, each on the
    card (update, mark and histogram launched) and on the CPU, equal."""
    out = {}
    for name in ("quickstart", "profile_embeddings"):
        mod = load_twin(name)
        zero_counts(counters)
        t0 = time.perf_counter()
        card = mod.main(device)
        card_s = time.perf_counter() - t0
        launches = read_counts(torch, counters, f"examples (a) {name}",
                               required=counters[SKETCH_COUNTERS])
        cpu = mod.main("cpu")
        hold_twin(name, card, cpu)
        out[name] = launches
        last = card["records"][-1]
        print(f"examples (a): {name} at its own size in {card_s:.2f} s on the card, "
              f"every integer equal to the CPU run (last record {last}, "
              f"{card['counters']}, θ trace of {len(card['theta_trace'])}); "
              f"launches {json.dumps(launches)} on {smi}")
    return out


def examples_serve(torch, counters, smi, device="cuda") -> dict:
    """(b) serve_longctx at the reference's smoke shape on the card: tokens
    of the expected shape in the vocabulary, logits-fed page mass summing to
    1, the grouped attention kernel launched at group 2 and dk 16, the kv
    and embeddings resources' feed replayed on the CPU (placement, θ,
    counts and hit counts, sketches, bytes moved)."""
    mod = load_twin("serve_longctx")
    feed = {}
    names = ("embeddings", "kv")

    def on_engine(eng):
        feed["log"] = record_feed(eng.daemon, names)
    zero_counts(counters)
    res = mod.main(device, on_engine=on_engine)
    launches = read_counts(torch, counters, "examples (b)")
    eng, tokens = res["engine"], res["tokens"]
    cfg = eng.cfg
    if tokens.shape != (mod.BATCH, mod.NEW) or not ((tokens >= 0) & (tokens < cfg.vocab)).all():
        raise AssertionError(f"examples (b): tokens {tokens.shape} outside the vocabulary")
    if (cfg.n_heads // cfg.n_kv_heads, cfg.head_dim) != (2, 16):
        raise AssertionError(f"examples (b): group {cfg.n_heads // cfg.n_kv_heads}, "
                             f"dk {cfg.head_dim}")
    sums = eng._last_kv_mass.sum(dim=1)
    if not bool(((sums - 1).abs() < 1e-4).all()):
        raise AssertionError(f"examples (b): page mass sums {sums.tolist()} != 1")
    _, rows, batches = replay_feed(torch, eng.daemon, feed["log"], names, reads=True)
    stats = res["tier_stats"]
    print(f"examples (b): serve_longctx (B {mod.BATCH}, {mod.PROMPT}-token prompts, "
          f"{mod.NEW} tokens) in {res['seconds']:.2f} s, "
          f"{mod.BATCH * mod.NEW / res['seconds']:.1f} tokens/s; feed of "
          f"{sum(e[0] == 'observe' for e in feed['log'])} blocks replayed on the CPU "
          f"(batches {batches}, rows {rows}); hit rates "
          f"{ {n: round(r['hit_rate'], 4) for n, r in stats.items()} }, bytes moved "
          f"{ {n: r['migration_bytes'] for n, r in stats.items()} }; launches "
          f"{json.dumps(launches)} on {smi}")
    return launches


def examples_train(torch, counters, smi, device="cuda", steps=EXAMPLE_STEPS,
                   shape=(8, 256)) -> dict:
    """(c) train_tiered_moe at the reference's CFG, batch 8, sequence 256,
    EXAMPLE_STEPS steps, in a fresh checkpoint directory under build/: every
    loss finite and the last 20 steps' mean below the first 20's; the last
    EXAMPLE_REPLAY steps' router streams, logged, replayed through the
    twin's experts resource on the CPU from the card's state before them
    (its tensors, pending queue, telemetry and the daemon's tick; the
    plain sketch's O(S^2) dedup takes ~0.5 s a step's 16,384 ids on the
    CPU): placement, θ, counts equal; the step-EXAMPLE_CKPT checkpoint
    restored bitwise equal to the params after that step."""
    import copy
    import shutil
    from repro_torch.ckpt.manager import CheckpointManager, tree_leaves, tree_unflatten
    mod = load_twin("train_tiered_moe")
    ckpt = ROOT / "build" / "examples_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    streams, snap, start = [], [], {}
    # the checkpoint restored: the twin's step-100 save (after step 100),
    # or in a shorter run its final one (after the last step)
    saved = EXAMPLE_CKPT if steps > EXAMPLE_CKPT else steps
    at = EXAMPLE_CKPT if steps > EXAMPLE_CKPT else steps - 1
    # the replay starts from the experts resource as the card left it
    # before the last EXAMPLE_REPLAY steps (the whole run if it is shorter)
    first = max(steps - EXAMPLE_REPLAY, 0)

    def on_step(s, params, loss, router, experts):
        if s >= first:
            streams.append(router.cpu())
        if s == first - 1:
            start.update(state=tree_unflatten(experts.state, [
                x.cpu().clone() for x in tree_leaves(experts.state)]),
                         pending=experts.mem._pending.copy(),
                         stats=copy.deepcopy(experts.stats), tick=s + 1)
        if s == at:
            snap.extend(x.detach().cpu().clone() for x in tree_leaves(params))
    zero_counts(counters)
    t0 = time.perf_counter()
    try:
        res = mod.main(steps=steps, batch=shape[0], seq=shape[1], ckpt=str(ckpt),
                       device=device, on_step=on_step)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(torch, counters, "examples (c)",
                               required=counters[SKETCH_COUNTERS])
        losses = np.asarray(res["losses"])
        if res["start"] != 0 or len(losses) != steps or not np.isfinite(losses).all():
            raise AssertionError(f"examples (c): {len(losses)} losses from step "
                                 f"{res['start']}, finite {np.isfinite(losses).all()}")
        w = min(20, steps // 2)
        if not losses[-w:].mean() < losses[:w].mean():
            raise AssertionError(f"examples (c): the loss did not fall: {losses[:w].mean()}"
                                 f" -> {losses[-w:].mean()}")
        daemon, experts = mod.tiered_experts("cpu")
        if start:
            experts.state, experts.stats = start["state"], start["stats"]
            experts.mem._pending, daemon._tick = start["pending"], start["tick"]
        for router in streams:
            experts.observe(router)
            daemon.tick()
        card, cpu = res["experts"], experts
        for field in ("page_slot", "slot_page"):
            if not torch.equal(getattr(card.state.tier, field).cpu(),
                               getattr(cpu.state.tier, field)):
                raise AssertionError(f"examples (c): experts {field} differs from the "
                                     "CPU replay")
        counts = ("fast_reads", "slow_reads", "promoted", "demoted", "ping_pong")
        got, want = ({k: h.snapshot()[k] for k in counts} for h in (card, cpu))
        if got != want or card.stats.theta_trace != cpu.stats.theta_trace:
            raise AssertionError(f"examples (c): experts {got}, θ {card.stats.theta_trace}"
                                 f" vs {want}, {cpu.stats.theta_trace} on the CPU")
        mgr = CheckpointManager(str(ckpt))
        restored = tree_leaves(mgr.restore(saved, res["params"]))
        if len(restored) != len(snap) or not all(
                torch.equal(a.cpu(), b) for a, b in zip(restored, snap)):
            raise AssertionError(f"examples (c): the step-{saved} checkpoint "
                                 "does not restore bitwise")
        kept = sorted(int(d.name.split("_")[1]) for d in ckpt.iterdir())
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    n_params = sum(x.numel() for x in snap)
    print(f"examples (c): train_tiered_moe, {n_params / 1e6:.1f} M params, "
          f"{steps} steps of {shape[0]} x {shape[1]} tokens in {wall:.1f} s "
          f"({steps * shape[0] * shape[1] / wall:,.0f} tokens/s with the daemon and "
          f"checkpoints), loss {losses[0]:.3f} -> {losses[-1]:.3f} (first / last "
          f"{w} steps' mean {losses[:w].mean():.3f} / {losses[-w:].mean():.3f}); the "
          f"experts resource's integers equal to the CPU replay of the last "
          f"{len(streams)} router streams from the card's state before them ({got}, "
          f"θ {card.stats.theta_trace[-3:]}), residency per "
          f"group {res['residency'].tolist()}; checkpoints {kept}, step "
          f"{saved} restored bitwise ({len(snap)} leaves); launches "
          f"{json.dumps(launches)} on {smi}")
    return launches


def examples_path(torch, counters, smi, device="cuda", **train_kw) -> dict:
    """PHASE examples: (a) ``examples_tiering``, (b) ``examples_serve``, (c)
    ``examples_train`` (``train_kw``: its steps and shape); the phase's
    launches are their sum."""
    parts = list(examples_tiering(torch, counters, smi, device).values())
    parts.append(examples_serve(torch, counters, smi, device))
    release(torch)
    parts.append(examples_train(torch, counters, smi, device, **train_kw))
    release(torch)
    return {k: sum(p[k] for p in parts) for k in parts[0]}


def _tree_map(fn, tree):
    """``fn`` over every tensor of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from repro_torch.core import sketch as sk
        from repro_torch.kernels import _lib
        from repro_torch.kernels.cms_hist import ops as hist_ops, ref as hist_ref
        from repro_torch.kernels.neoprof_update import ops as np_ops, ref as np_ref
        from repro_torch.kernels.paged_attn import ops as pa_ops, ref as pa_ref
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    rates = card_rates(name)
    t0 = time.perf_counter()
    _lib.lib()
    print(f"PHASE device: {name} ({smi}); kernels built in "
          f"{time.perf_counter() - t0:.1f} s into {_lib.library_path().name}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [check_attention(torch, pa_ops, pa_ref, rates, gen),
            check_mla_attention(torch, pa_ops, pa_ref, _lib, rates, gen)]
    rows += check_sketch(torch, np_ops, np_ref, hist_ops, hist_ref, sk, rates, gen)
    for r in rows:
        print(f"kernel {r['name']}: max_abs_err {r['max_abs_err']:.3g}, device "
              f"{r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
              f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms), "
              f"host {r['host_ms']:.4f} ms per eager call, on {smi}")
    print(f"PHASE kernels: all {len(rows)} match their plain versions "
          f"(integer outputs bitwise, attention within {ATOL}+{RTOL}*|ref|)")

    counters = (pa_ops.paged_attention_raw, np_ops.sketch_update_kernel,
                np_ops.sketch_mark_hot_kernel, hist_ops.hist_kernel)
    t0 = time.perf_counter()
    phases = {}
    mla_counters = counters + (pa_ops.head_tiled,)
    # PHASE dist (d) runs deepseek-v3's MLA through the head-tiled kernel
    phases["dist"], dres = dist_path(torch, mla_counters, smi)
    print(f"PHASE dist: ok in {time.perf_counter() - t0:.1f} s, world size 1 over NCCL: "
          f"(a) {TRAIN_ARCH}'s ZeRO-1 / offload / local_grads / fsdp step over the mesh, "
          f"partitioned over 'model', bitwise the meshless step, m, v and ef pinned on "
          f"the host between steps "
          f"(median {dres['step_ms'][0]:.1f} / {dres['step_ms'][1]:.1f} ms a step, peak "
          f"{dres['peak'][0]:.2f} / {dres['peak'][1]:.2f} GiB, fetch "
          f"{statistics.median(t[0] for t in dres['fetch']):.1f} ms a step); (b) the "
          f"slot-split, partitioned paged decode equal to the unsharded ring; (c) "
          f"{' and '.join(DIST_MOE)} partitioned, expert-parallel train step and "
          f"ServeEngine(ep_axes=) equal to the CPU; (d) "
          f"{' and '.join(MOE_PHASES[p]['arch'] for p in DIST_SLICE)} at full width, "
          f"partitioned prefill_paged and paged decode and the dense decode over the "
          f"'model'-split cache equal to the meshless calls; (e) "
          f"{' and '.join(DIST_RECURRENT)} at full width, partitioned paged and dense "
          f"serving bitwise the meshless calls; (f) {' and '.join(DIST_CROSS)} at "
          f"full width, partitioned dense (cross steps, encoder) and paged serving "
          f"bitwise the meshless calls; attention-cache leaves attended split / "
          f"gathered whole "
          f"{[dres['slices'][k]['cache_leaves'] for k in dres['slices']]}; "
          f"launches {json.dumps(phases['dist'])} on {smi}")
    release(torch)
    cfg, params = draw_params(torch)
    launches, e2e = main_path(torch, counters, cfg, params)
    print(f"PHASE main: ok, {e2e['decode_tokens_per_s']:.2f} decode tokens/s "
          f"on {smi}")
    phases["main"] = launches
    for phase, path in (("lanes", lanes_path), ("reuse", reuse_path),
                        ("disagg", disagg_path), ("fill", fill_path)):
        gc.collect()                   # the previous phase's rings and stores
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        phases[phase], rep = path(torch, counters, cfg, params, smi)
        print(f"PHASE {phase}: ok in {time.perf_counter() - t0:.1f} s, "
              f"{rep['completed']} requests, "
              f"{rep['tokens'] / rep['clock']['decode_s']:.2f} tokens/s on the "
              f"decode clock, launches {json.dumps(phases[phase])} on {smi}")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    models = {"llama3.2-3b": (cfg, params)}
    del params                         # PHASE dense releases llama3.2-3b's 6.4 GB
    phases["dense"] = dense_path(torch, counters, models, smi)
    print(f"PHASE dense: ok in {time.perf_counter() - t0:.1f} s, "
          f"{', '.join(DENSE_ARCHS)} at full width, dense and paged arms, "
          f"launches {json.dumps(phases['dense'])} on {smi}")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phases["ssm"] = ssm_path(torch, counters, smi)
    print(f"PHASE ssm: ok in {time.perf_counter() - t0:.1f} s, "
          f"{', '.join(SSM_ARCHS)} at full width, depth cut to a third, dense and paged arms "
          f"and lanes, launches {json.dumps(phases['ssm'])} on {smi}")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phases["cross"] = cross_path(torch, counters, smi)
    print(f"PHASE cross: ok in {time.perf_counter() - t0:.1f} s, "
          f"{', '.join(CROSS_ARCHS)} at full width and depth, dense and paged arms "
          f"(whisper: the dense arm against the CPU), launches "
          f"{json.dumps(phases['cross'])} on {smi}")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phases["moe"], rep, (phases["async"], async_s) = moe_path(torch, counters, smi)
    print(f"PHASE moe: ok in {time.perf_counter() - t0 - async_s:.1f} s, "
          f"{rep['completed']} lane requests, "
          f"{rep['tokens'] / rep['clock']['decode_s']:.2f} tokens/s on the "
          f"decode clock, launches {json.dumps(phases['moe'])} on {smi}")
    print(f"PHASE async: ok in {async_s:.1f} s, kimi-k2's single request and lane "
          f"drive on the asynchronous plane, equal to the synchronous arms, and the "
          f"tiering checkpoint round trip, launches {json.dumps(phases['async'])} "
          f"on {smi}")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phases["mla"], rep, _ = moe_path(torch, mla_counters, smi, phase="mla")
    if phases["mla"]["paged_attention_raw"] != phases["mla"]["paged_attention_head_tiled"]:
        raise AssertionError("PHASE mla: an attention call missed the head-tiled "
                             f"kernel: {phases['mla']}")
    print(f"PHASE mla: ok in {time.perf_counter() - t0:.1f} s, "
          f"{rep['completed']} lane requests, "
          f"{rep['tokens'] / rep['clock']['decode_s']:.2f} tokens/s on the "
          f"decode clock, launches {json.dumps(phases['mla'])} on {smi}")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phases["train"], full = train_path(torch, counters, smi)
    print(f"PHASE train: ok in {time.perf_counter() - t0:.1f} s, {TRAIN_ARCH} at full "
          f"width and depth {full['ms']:.1f} ms/step, {full['tokens_per_s']:.0f} "
          f"tokens/s, peak {full['peak_gib']:.2f} GiB, busy "
          f"{100 * full['busy_share']:.1f}% (profiled); every arch's smoke step and "
          f"every training-only form equal to the CPU's, launches "
          f"{json.dumps(phases['train'])} on {smi}")
    release(torch)
    for phase, path in (("sim", sim_path), ("sim-paper", sim_paper_path)):
        t0 = time.perf_counter()
        phases[phase] = path(torch, counters, smi)
        print(f"PHASE {phase}: ok in {time.perf_counter() - t0:.1f} s, launches "
              f"{json.dumps(phases[phase])} on {smi}")
    t0 = time.perf_counter()
    phases["examples"] = examples_path(torch, counters, smi)
    print(f"PHASE examples: ok in {time.perf_counter() - t0:.1f} s, the four example "
          f"twins on the card equal to their CPU runs and replays, launches "
          f"{json.dumps(phases['examples'])} on {smi}")
    by_name = {"paged_attn": "paged_attention_raw",
               "paged_attn_mla": "paged_attention_head_tiled",
               "neoprof_update": "sketch_update_kernel",
               "neoprof_mark": "sketch_mark_hot_kernel",
               "cms_hist": "hist_kernel"}
    for r in rows:
        # launches on the kernel's own main path: PHASE main's, and for the
        # head-tiled kernel PHASE mla's
        path = "mla" if r["name"] == "paged_attn_mla" else "main"
        r["launches"] = phases[path][by_name[r["name"]]]
        r["phase_launches"] = {p: n.get(by_name[r["name"]], 0)
                               for p, n in phases.items()}
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "phase_launches")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
