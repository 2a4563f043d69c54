"""Smoke run of the PyTorch port (``repro_torch``) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --phases 4,6     # the build and the phases named
    python3 chip_smoke.py --sharded-ranks 2  # phase 11's captured sharded
                                             # round at D = 2, on 2 cards
    python3 chip_smoke.py --mesh-ranks 4     # train(mesh=) at (2, 2) over
                                             # NCCL, one card a rank
    python3 chip_smoke.py --mesh-ranks 4 --against DIR  # and then DIR's
                                             # checkout and this one in
                                             # turns at full depth

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

1. device and build: the card's name and power limit, and the hand-written
   kernels built from ``src/repro_torch/kernels/*/csrc`` by ``nvcc``, one
   process per source, all at once (their ``-Xptxas -v`` register/spill
   report), and the count of ``HGMMA`` (wgmma) instructions in the flash
   library's SASS and of ``HMMA``/``HGMMA`` (mma.sync / wgmma) ones in the
   SSD library's, neither of which may be 0;
2. every kernel entry point against its plain PyTorch version on the card:
   the fused ZOO fan-out at the tabular main path's shapes and ragged
   ones, f32 (TF32 off, 1e-4) and bf16 (1.5e-1); flash attention (f32 on
   the CUDA cores, bf16 on the tensor cores) over head dims 48 to 128
   (Phi-3's 96, Zamba2's 80 and Qwen3's 128 with GQA 8:1 at both prefill
   chunks) and MLA's pair, q/k 192 and v 128 (DeepSeek-V3's prefill
   chunks, a ragged chunk, non-causal, serve magnitudes), causal, window 64,
   non-causal Sq != Skv, q_offset 0 and 576 over a 1152-slot cache, ragged
   Sq and Skv and GQA, Whisper's shapes (its encoder, non-causal over 1500
   frames; cross-attention at Sq = 1 and 128 against them; a ragged
   non-causal chunk) and InternVL2's GQA 6:1 at d = 128 (a non-causal
   case's keys are all random; a causal case's past the last query are
   zero, as an unwritten cache's), and RMSNorm (RMS_CASES: M = 8, 8192,
   4608, 3584, 50, 1; d = 3072, 2560, 2048, 5120, 6144, 7168 and 128 on
   the one-pass vector kernel,
   ragged d, d = 9000 and a misaligned x on the general kernel, each case
   held to its route), f32 (1e-4 / 1e-5) and bf16 (2e-2 plus a relative
   2e-2); the SSD chunked scan at the TPU test's shapes, at the
   hybrid serve path's (B = 8, H = 80, P = N = 64; 576 rows at chunk 96
   and 448 at chunk 112, from a non-zero initial state, y and the final
   state), at a ragged chunk of 7, at chunk 128 and at P or N below 64
   (20 x 12 at a chunk of 25 through plain loads), f32 (1e-4; y and the
   state f32 whatever x's type; bf16 y of the TPU contract 2e-2 plus a
   relative 2e-2), and in bf16 at serve magnitudes (|y| to 1e5, the serve
   tolerance), with the scan kernel's grid and resident blocks an SM;
   then each one's time, its plain version's, one PyTorch
   library call's where one exists, and the bound from its bytes and
   operations (flash attention at both serve paths' head dims, 96 and 80,
   at DeepSeek-V3's (192, 128) prefill chunk, at Whisper-medium's encoder
   layer and at InternVL2-26B's vision-prefill layer, the last two against
   SDPA at its best call: ``is_causal``, GQA in place),
   and each one's achieved TFLOP/s and share of its bound. RMSNorm is
   timed at both serve widths' prefill and decode rows from CUDA graphs
   over inputs rotated through more than 3 x the L2 (no host and no L2 in
   the reading), beside F.rms_norm, the general kernel, the time per
   Python call and, at M = 8, an empty kernel's; flash attention
   captured in a CUDA graph and replayed on fresh contents of the same
   buffers, bitwise its eager launch (Whisper's cross-attention decode
   call, a causal GQA chunk in bf16, f32);
3. the tabular main path at the paper's width: cascaded hybrid VFL (ZOO
   clients through the fused kernel, FOO server) over an MNIST-sized
   stand-in, 500 rounds through the captured round (round 0 eager, one
   CUDA graph replayed 499 times: ms a round of the replays, the capture
   seconds apart), with the kernel's launch count read around the run
   (one a round, 499 replayed); the same rounds bitwise (losses, params,
   table, delays) against the internal eager loop of the same body on
   the card; a profile of 50 rounds read over the replays (busy share,
   device events a round); agreement with the plain lanes on the CPU on
   the same draws; the other four methods, a q = 4, block = 3 cascaded
   run and the DP loss channel, each bitwise graph against eager; a
   reduced ``from_model_config`` Phi-3 round at ``bench_lm_async``'s
   shape (flash and RMSNorm under the capture, autograd in the server
   update) bitwise graph against eager, its launches held to their
   derivation; the quickstart's accuracy; a second ``Federation.run`` of
   the 500 rounds on the same session replays the session's kept round
   graph (capturing nothing: ``kept``, capture 0.0 s, all 500 rounds
   replayed) bitwise the first call (losses, params, table, delays), both
   calls' seconds logged;
4. the split serve path of two models at full width and depth (bf16,
   random weights from a seed), each through ``launch.serve.serve`` of
   8 requests of 1024 prompt + 128 generated tokens over 2 client parties:
   Phi-3-mini (32 layers, d_model 3072) and Zamba2-2.7B (54 Mamba2 layers
   and a shared attention block at 9 sites, d_model 2560), decoding
   through the captured step (a CUDA graph replayed once a token). For
   each, the launch counts of flash attention, RMSNorm and the SSD scan
   read around the run (the eager launches plus the captured ones times
   the replays) and held to the counts derived from the config (every
   RMSNorm launch on the vector kernel), the wire bytes
   against the serve ledger's formula, the kernels held to their plain
   versions on the inputs they saw in the first and last layer of both
   prefill chunks (and, for RMSNorm, the first decode step: the graph's
   warm-up, run eagerly), the greedy tokens and final logits against an
   eager ``use_scan=False`` decode of the same prompts (tokens equal,
   logits within 2 bf16 steps; capture seconds, graph nodes, tokens/s and
   peak memory of both), a profile of replays of the captured step (the
   device's busy share; the RMSNorm kernels a replay, by the kernel's
   name, equal to the launches the capture recorded) and, for Zamba2, a
   profile of one prefill split by kernel
   family, whose device kernels show every SSD call on the tensor cores
   (one pre-pass and one scan a call, and no f32-route kernel); a second
   ``Federation.decode`` of the same prompts and params tree replays the
   session's kept decode graph (the same graph, all 128 tokens replayed,
   ``compile_s`` 0.0) with the first call's tokens and final logits
   bitwise, both calls' seconds logged;
5. LM training on the card: each differentiable kernel's gradients (flash
   attention f32 and bf16, causal and window 64, d = 96 and 80; RMSNorm on
   both routes; the SSD scan f32 and bf16, at the training shapes) against
   autograd through its plain version, every output with a grad_fn; one
   step of the cascaded, first-order and full-ZOO factories on reduced
   phi3 in f32 against the same step on the CPU (1e-4); then
   ``launch.train.train`` of Phi-3-mini at full width and depth, 20
   cascaded steps of 8 x 128 tokens at the CLI's defaults (finite, falling
   loss; launch counts derived from the config; the wire formula; ms per
   step, peak memory and one step profiled by family); Zamba2-2.7B at full
   width cut to 6 layers (5 steps through ``Federation.sync_step``, the
   gradient reaching the first Mamba2 layer's in_proj); and Phi-3 at full
   width with 2 layers trained 4 steps, saved, resumed to 8, against 8
   without a break (bitwise equal losses and params);
6. continuous split serving through ``Federation.serve`` (the paged
   ``ServeScheduler``) at full width: 16 requests queued up front
   (prompts 1024, 1024, 768, 768, 512, 512, 256, 256 twice over,
   generations 128, 96, 64, 32 in turn, greedy) over 8 slots with 8-token
   pages and 2 client parties, seq_len 1152. Phi-3-mini at full depth
   with the worst-case pool (run A) and with half of it plus 2 pages and
   preemption (run B, which must preempt), Zamba2-2.7B cut to 12 layers
   (run A), every drain through the scheduler's CUDA graphs (one batched
   step replayed K times a block; a preempted request's replay through
   the captured B = 1 step). Each run holds every request's wire ledger to
   ``Transport.account_serve``'s formula (plus a preempted request's
   re-prefill), host transfers to one a retirement wave and one an
   eviction, the launch counts to their derivation from the scheduler's
   prefill chunks, decode steps and replayed tokens (counted through the
   replays, and the replayed share held to its own derivation), every
   serve kernel
   against its plain version on the drain's own inputs (the first and last
   site of each new chunk shape, offset and wave width, captured during
   the drain), and each request's tokens by a teacher-forced gap: re-run
   solo through ``server_prefill``, the reference's max logit minus its
   logit of the chosen token, at most 2 x the solo ``fed.decode`` path's
   worst gap on the longest and the shortest request (floored at 2e-2 x
   the largest |logit|). The requests of 32 tokens are also re-run through
   the B = 1 serve step on their own tokens: their gap at most 4 x and
   their final logits within 2 x the larger of one bf16 step at the
   largest |logit| and the solo path's B = 8 against B = 1 reading.
   Phi-3's run A is held to one eager drain (``use_scan=False``) of the
   same traffic: the same steps, launches and tokens, final logits within
   2 bf16 steps. It logs the graphs' captures and nodes, a replayed
   token's device time, decode tokens/s, peak pages and memory, a
   profile of one 8-step
   block (launches a step, the device's busy share, the paged gather's
   time a step), a sampled drain (temperature 0.8: its time, peak memory
   and noise table; seeds sharing a prompt must draw different streams),
   a sampled drain of mixed generation lengths (32 to 128 tokens, the
   noise table growing while the block graph exists, so the graph is
   captured again) held token for token to one eager drain of the same
   traffic and seeds, and the phase's time; Phi-3's run A drains under
   the analysis plane's sentinels (phase 11 (b) checks them);
7. asynchronous LM training over the wire plane: (a)
   ``launch.train.train_population`` of Phi-3-mini at full width and
   depth, 12 rounds at the population CLI's defaults (4 client parties
   behind loopback wires, batch 8 x 32 tokens, q = 1, cascaded): a
   finite, falling loss, no gradient on the wire, the ledger's serialized
   bytes equal to the emb/loss frames measured as sent (the f32 payload
   formula beside them), the flash-attention and RMSNorm launches equal
   to their derivation from the config, the rounds and the admitted
   clients, both kernels held to their plain versions on the first and
   last layer of round 0's server update and of its loss lanes, ms a
   round (and each round's, with the rounds in which a graph was
   captured and the mean of the timed rounds without one), peak memory
   and one round cycle profiled by kernel family (the
   host's ``cudaGraphLaunch`` and ``cudaLaunchKernel`` calls in it: the
   server's two functions and each worker's uplink and update replay
   from CUDA graphs), each worker's graphs logged, the same run with
   every one of those functions eager bitwise in every round's server
   loss and the final server; (b)
   at full width cut to 2 layers: ``run_population`` against
   ``Federation.run`` and against its own run with every function eager
   over 10 rounds (losses, params, table, delays bitwise), ``until=5`` +
   ``fed.save(async_state=)`` + ``Federation.restore`` + resume against
   10 unbroken rounds (bitwise),
   and party 2's ``ClientWorker`` in another process on the card behind
   a ``SocketBackend`` against the loopback run (bitwise, ledger
   included); (c) a run with drops, latency, jitter, straggler admission
   and staleness forcing whose counters and virtual clock equal the same
   plan's on the CPU, and a socket worker ``kill -9``'d at its 2nd frame
   (declared dead, the run completes); (d) one round on reduced phi3 in
   f32 on the card against the CPU;
8. the RWKV6 and MoE families and the paper's attacks: (a) phase 4's
   split serve path and its checks for Qwen3-30B-A3B at full width and
   depth (48 layers, d_model 2048, 128 experts top-8, 56.9 GiB of bf16
   weights; every cached prefill chunk and decode step on the MoE dense
   form; flash attention at head dim 128 with GQA 8:1, RMSNorm at d =
   2048) and (b) for RWKV6-7B (32 layers, d_model 4096; no kernel: it
   runs LayerNorm and the plain wkv6 form), then the MoE gather form
   captured as a CUDA graph and held bitwise to its eager steps; (c)
   phase 6's run A for RWKV6-7B at full width cut to 8 layers; (d)
   ``launch.train.train`` at full width, Qwen3 cut to 4 layers (server
   lr 1.0; its run at the CLI's 0.01, flat in 10 steps, logged beside)
   and RWKV6 to 8 (lr 0.01), 10 cascaded steps each (a finite, falling
   loss, launches
   derived from the config, the wire formula; for Qwen3 the gradient at
   the first block's experts and router, and the aux loss's own at the
   router), and one reduced f32 cascaded step of each on the card
   against the CPU; (e) Table I's label attack (2048 queries, 10
   classes; FOO 1.0 and 1.0, ZOO below 0.35 and within 0.05 of chance)
   and the feature attack on the card, each equal to the CPU's on the
   card's draws;
9. DeepSeek-V3 (MLA, ``first_k_dense``, MTP): (a) phase 4's split serve
   path and its checks at full width cut to 5 layers (3 dense, 2 MoE:
   25.7 B server parameters; flash attention at MLA's (192, 128) head
   dims on every prefill chunk, the MoE dense form at every cached chunk
   and step, the latent cache), the captured decode's final logits
   bitwise equal to the eager decode's; (b) the absorbed decode
   (``mla_absorb``) on the same weights and prompts, teacher-forced on
   (a)'s tokens (every step's logits within 2e-2 x the largest |logit|
   of the expanded form's), its tokens/s and replay profile; (c) phase
   6's run A at full width cut to 4 layers on the paged latent pool; (d)
   ``launch.train.train`` at full width cut to 4 layers and 16 routed
   experts (lr 1.0 gated, the CLI's 0.01 logged beside, and the share of
   bf16 SGD updates lost at each), flash and RMSNorm first held at its
   training shapes, one reduced f32 cascaded step and the reduced f32
   global loss with its MTP head on the card against the CPU (MLA's full
   head dims); phase 2 holds the flash kernel at (192, 128) and times it
   at DeepSeek-V3's prefill chunk against SDPA and its bound;
10. the multimodal (InternVL2-26B) and encoder-decoder (Whisper-medium)
   families, whose split plane refuses them as ``repro``'s does: (a)
   ``launch.serve.serve`` of Whisper at full width and depth (24 encoder
   and 24 decoder layers) with 2 client parties asked for, through the
   global fallback (its ``fallback`` note, mode "global"): 8 x (224 +
   224) greedy tokens, the encoder once on zero frames before the
   prefill, flash launches 24 + 24 cross calls a step over 448 steps and
   no RMSNorm; then on seeded N(0, 1) frames through ``decode_fn``: flash
   held to its plain version on the encoder's first and last layer and
   the first and last cross call, the decoded tokens teacher-forced
   through the full forward (each token's gap at most 2e-2 x the largest
   |logit|), a decode step's time and profile by kernel family and the
   share of it the cross-attention K and V projections take (recomputed
   from enc_out every step, as in ``repro``); (b) InternVL2 at full width
   and depth: the same fallback over 8 x (256 + 128) tokens (RMSNorm 97
   launches a step), then one ``forward_fn`` over seeded patch embeddings
   (8, 256, 3200) and 768 text tokens (flash at GQA 6:1, d = 128 and
   RMSNorm at (8192, 6144), each held on the first and last layer; its
   time), and the text-only decode teacher-forced through the text-only
   forward; (c) ``launch.train.train`` at the CLI's defaults (10
   cascaded steps of 8 x 128 tokens, zero frames or patch embeddings, as
   ``repro``'s driver feeds them) of Whisper at full depth and InternVL2
   at full width cut to 8 layers (a finite, falling loss, launches
   derived from the config, the wire formula, ms a step, peak memory),
   then one ``fed.sync_step`` of each on seeded inputs in which the
   projector ``proj.w`` moves; (d) one reduced f32 cascaded step of each
   and its global loss on the card against the CPU, and reduced Whisper's
   encoder and 8 decode steps against the CPU. Both serves run the
   global decode through two captured steps (prefill and decode, one
   graph pool; the first of each eager): their capture seconds, nodes
   and replays are logged and their launches, replays included, held to
   the derivation; on the checks' weights and prompts, ``global_decode``
   of 8 x (32 + 32) through the graphs gives bitwise the tokens and
   final logits of the eager loop the teacher-forcing check decodes
   from, and a profile of its decode replays gives the device's busy
   share;
11. the sharded engine and the analysis plane: (a) the tabular main
   path at the paper's width through ``Federation.build(...,
   EngineConfig(mesh_shards=1))`` on a one-rank NCCL group (the client
   block's ``("data",)`` ``DeviceMesh``), 500 rounds after 20 of warm-up,
   its round captured as a CUDA graph that holds the NCCL collectives,
   in turns (sharded, sharded eager, graph, eager, eager, graph, sharded
   eager, sharded) with its internal eager loop and the unsharded run
   through the captured round and through its eager loop: losses,
   params, table and delays bitwise equal to all three and to phase 3's,
   the fused kernel launched once a round (all but round 0 replayed; the
   second sharded and unsharded runs through the graph replay their
   session's kept graph, all 500 rounds, issuing no collective), the
   collectives recorded in the graph (the calls made under its capture)
   and those of 20 profiled eager rounds equal to their derivation (2
   all-gathers and 2 client leaves all-reduces a round), the graph's
   nodes by kind and its NCCL kernels by name, ms a round of all four,
   and vafl and zoo-vfl captured and eager bitwise over 25 rounds each
   (D > 1 needs a card a rank, NCCL refusing two ranks on one GPU:
   ``--sharded-ranks D`` below); (b) phase 6's
   run A of Phi-3-mini drains under ``analysis.runtime.strict``: its host
   reads equal the scheduler's ``host_transfers``, all at the retirement
   waves, its fresh compiles are the one graph capture of the warm-up
   block, and every later block step runs with no read, no compile and
   CUDA's sync debug mode at "error"; (c) ``python -m
   repro_torch.analysis --strict`` on this machine exits 0;
12. the boundary certifier: (a) ``python -m repro_torch.analysis certify
   --strict`` on the card in a child process exits 0 and its certificate
   (under ``build/``) equals the committed ``CERT_boundary.json`` in every
   configuration's status, findings, crossings, ``n_dp_eqns`` and
   ``out_taints``; (b) cascaded-lanes on the tabular main path at the
   paper's width (batch 64, phase 3's q) and the split serve of
   Phi-3-mini at full width and depth (bf16, 2 client parties, B = 2, 4
   decode steps) traced and certified, with one graph node of the fused
   ZOO kernel, and of RMSNorm, for each launch counted around the trace,
   the tabular crossings' elements equal to the ledger's formula and each
   decode step's crossings a (B,) int32 token down and a (B, 1, 3072)
   bf16 embedding up; (c) the phase's seconds;
13. the examples on the card: each of ``examples_torch/`` (``repro``'s
   six) loaded in this process and its ``main()`` called with
   ``sys.argv`` set and no ``--device``, its asserts holding and its
   lines and seconds logged (``paper_experiments.py`` at ``--steps 200``
   into ``build/``), every engine run of theirs through the captured
   round; around ``train_lm_cascaded.py`` and
   ``serve_decode.py`` the flash, RMSNorm and SSD launches held to their
   derivation from the configs they run;
14. the production mesh: (a) ``launch.train.train(mesh=)`` of Phi-3-mini
   at full width cut to 4 layers, 3 cascaded steps of 8 x 128 tokens, on
   a one-rank NCCL group at a (1, 1) ``("data", "model")`` mesh with
   DTensor parameters, through its captured step (step 0 eager, then one
   CUDA graph replayed), against the placed eager step and the unplaced
   captured step in turns (unplaced, placed, placed eager, placed eager,
   placed, unplaced): losses and parameters bitwise, flash and RMSNorm
   launches equal to the derivation (all but step 0's replayed),
   ``shard_constraint`` calls equal to theirs ((1 + 1) x a step's under
   capture: step 0 and the capture), the ms a step of all three; the
   placed run saved after step 1 (every placed leaf gathered whole) and
   resumed, placed, to 3, bitwise the straight placed run in losses and
   parameters, the save's and the restore's seconds logged; then
   the placed captured step at Phi-3-mini's full depth, 20 steps (steps
   3..18 timed, the last a profiled replay), with its peak memory;
   (b) ``python -m repro_torch.launch.dryrun --arch phi3-mini-3.8b
   --shape train_4k`` and phi3 cut to 4 layers with its full depth
   traced, in child processes on a fake 256-rank group with CUDA hidden,
   started before phase 13: the per-device parameter bytes equal the
   shards ``resolve_spec`` gives, the counted FLOPs at least 6·N·tokens
   (the ratio logged), the fit from 1 and 2 layers equal to the traced
   4-layer count in FLOPs, bytes and collective bytes, and the spec-peak
   terms, bound and peak GiB a device logged;
15. a ``{"kernels": [...]}`` line, and last ``{"ok": true, "device":
   ...}``.

It needs one card, and builds into ``build/`` at first use. It logs each
phase's time and its own; ``PERF.md`` keeps the readings. Phase 6's
modules have CPU tests of their own against the JAX package:
``tests/test_torch_paging.py``, ``tests/test_torch_serve_continuous.py``
and ``tests/test_torch_serve_scan.py``; phase 7's are
``tests/test_torch_wire.py`` and ``tests/test_torch_population.py``;
phase 8's ``tests/test_torch_rwkv.py``, ``tests/test_torch_moe.py`` and
``tests/test_torch_attacks.py`` and the families' cases of the serve and
training tests; phase 9's ``tests/test_torch_mla.py`` and the DeepSeek
cases of the serve, continuous, paging, training and checkpoint tests;
phase 10's ``tests/test_torch_encdec.py``, ``tests/test_torch_vlm.py`` and
the families' cases of the checkpoint tests; phase 11's
``tests/test_torch_engine_sharded.py`` (gloo ranks in child processes),
``tests/test_torch_sharding.py`` and ``tests/test_torch_analysis.py``.
Phase 13's are ``tests/test_torch_examples.py`` and
``tests/test_torch_examples_lm.py``; phase 14's
``tests/test_torch_production_mesh.py`` (4 gloo ranks),
``tests/test_torch_mesh_rules.py`` and ``tests/test_torch_dryrun.py``.
``--mesh-ranks D`` (:func:`mesh_ranks`) runs phase 14 (a)'s placed
training step across D cards, one NCCL rank a card (processes of this
script, ``--mesh-rank``), at (2, 2) for D = 4 and at (1, 2) and then
(2, 1) for D = 2: captured against eager bitwise, the ranks' losses equal,
f32 against the unplaced run, launches, one eager step's collectives
against the dry run's trace of it, the logged norms' collectives 0-dim
all-reduces only, NCCL in the graph, a placed checkpoint and full depth;
with ``--against DIR`` (another commit's checkout) it then runs DIR's
package and this one in turns at full depth, their losses bitwise equal
(:func:`mesh_against`); it prints no result line, and the default run is
as above. Phase 7 starts worker processes of this script (``--pop-worker``) and
stops them before it returns; phases 11 and 14 start and destroy a
one-rank process group, phase 11 runs the analysis CLI in a child
process, and phase 14's dry runs are child processes that are joined,
or killed if a phase fails.
"""
import contextlib
import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parent / "src"

# published peaks of one H100 SXM (dense): f32 on the CUDA cores, bf16 on
# the tensor cores, HBM3 bandwidth
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
TOL = {torch.float32: 1e-4, torch.bfloat16: 1.5e-1}
MU = 1e-3
# the main path's fan-out shapes: one activated client (R), a batch of 64
# rows (M), 784 / 4 features (K), client_embed 128 (N), q lanes
MAIN = dict(R=1, M=64, K=196, N=128, q=1)
CHECK_SHAPES = [dict(R=1, M=64, K=196, N=128, q=1),
                dict(R=3, M=64, K=196, N=128, q=1),
                dict(R=1, M=64, K=196, N=128, q=4),
                dict(R=3, M=64, K=196, N=128, q=4),
                dict(R=2, M=50, K=33, N=70, q=3),
                dict(R=1, M=64, K=1000, N=128, q=6),
                dict(R=2, M=40, K=196, N=64, q=9)]
# per-method learning rates: benchmarks/run.py's for the first-order
# servers; its 1e-3 for the ZOO servers (zoo-vfl, syn-zoo) is tuned for a
# 64-feature model and diverges at 784 features, where 1e-4 trains
LRS = {"cascaded": 0.05, "vafl": 0.05, "split": 0.05, "zoo-vfl": 1e-4,
       "syn-zoo": 1e-4}
KERNELS = {
    "zoo_dual_matmul_stacked_bias_relu":
        "src/repro/kernels/zoo_dual_matmul/kernel.py:121",
    "zoo_dual_matmul_stacked":
        "src/repro/kernels/zoo_dual_matmul/kernel.py:165",
    "zoo_dual_matmul": "src/repro/kernels/zoo_dual_matmul/kernel.py:38",
}
SOURCE = "src/repro_torch/kernels/zoo_dual_matmul/csrc/zoo_dual_matmul.cu"

# the serve path of each model in SERVE_ARCHS at full width: 8 requests of
# 1024 + 128 tokens over 2 client parties (seq_len 1152, span 576, prefill
# chunks of 576 and 448 query rows)
SERVE = dict(batch=8, prompt_len=1024, gen_len=128, n_clients=2)
SERVE_TOL = (2e-2, 2e-2)          # bf16 (atol, rtol): one bf16 step
SERVE_ROWS = {
    "flash_attention": (
        "src/repro/kernels/flash_attention/kernel.py:81",
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"),
    "rmsnorm": ("src/repro/kernels/rmsnorm/kernel.py:28",
                "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu"),
    "ssd_chunk": ("src/repro/kernels/ssd_chunk/kernel.py:64",
                  "src/repro_torch/kernels/ssd_chunk/csrc/ssd_chunk.cu"),
}
SERVE_ARCHS = ("phi3-mini-3.8b", "zamba2-2.7b")
# (B, Sq, Skv, Hq, Hkv, d, causal, window, q_offset)
FLASH_CASES = [(2, 576, 1152, 4, 4, 96, True, 0, 0),
               (2, 448, 1152, 4, 4, 96, True, 0, 576),
               (2, 576, 1152, 4, 4, 96, True, 0, 576),
               (2, 50, 1152, 4, 2, 64, True, 0, 576),
               (2, 448, 1152, 4, 2, 128, True, 64, 576),
               (2, 256, 256, 4, 4, 64, True, 64, 0),
               (2, 128, 256, 4, 4, 128, False, 0, 0),
               (2, 50, 50, 2, 2, 96, True, 0, 0),
               # Zamba2's head dim 80 (panels of 64 + 16) at both prefill
               # chunks and a ragged chunk
               (2, 576, 1152, 4, 4, 80, True, 0, 0),
               (2, 448, 1152, 4, 4, 80, True, 0, 576),
               (2, 37, 1152, 4, 4, 80, True, 0, 576),
               # Qwen3-30B-A3B's head dim 128 with GQA 8:1 (32:4) at
               # both prefill chunks
               (2, 576, 1152, 8, 1, 128, True, 0, 0),
               (2, 448, 1152, 8, 1, 128, True, 0, 576),
               # tile edges: Sq and Skv off the 128-row and 128-key tiles,
               # three d panels (64 + 32 + 16), 48 = 32 + 16, MQA
               (2, 300, 300, 2, 2, 96, True, 0, 0),
               (1, 200, 333, 4, 1, 112, False, 0, 0),
               (1, 130, 130, 2, 2, 48, True, 0, 0),
               # Whisper's encoder (non-causal over its 1500 frames, off
               # the 64- and 128-row tiles) and its cross-attention at a
               # decode step (Sq = 1) and over a training text (Sq = 128)
               # against the 1500 frames; InternVL2's GQA 6:1 (not a power
               # of two) at d = 128; a ragged non-causal chunk
               (2, 1500, 1500, 4, 4, 64, False, 0, 0),
               (2, 1, 1500, 4, 4, 64, False, 0, 0),
               (2, 128, 1500, 4, 4, 64, False, 0, 0),
               (2, 1024, 1024, 12, 2, 128, True, 0, 0),
               (1, 37, 1500, 2, 2, 64, False, 0, 0)]
# MLA's head-dim pair (q/k 192 = 128 nope + 64 rope, v 128) at DeepSeek-V3's
# two prefill chunks over its 1152-slot cache and a ragged chunk, f32 and
# bf16: (B, Sq, Skv, Hq, Hkv, d, d_v, causal, window, q_offset)
FLASH_MLA_CASES = [(2, 576, 1152, 4, 4, 192, 128, True, 0, 0),
                   (2, 448, 1152, 4, 4, 192, 128, True, 0, 576),
                   (2, 576, 1024, 4, 4, 192, 128, True, 0, 448),
                   (2, 37, 1152, 4, 4, 192, 128, True, 0, 576),
                   (1, 200, 333, 2, 2, 192, 128, False, 0, 0)]
# serve-like magnitudes (q and k x 3: peaked scores; v x 50: the Phi-3
# serve path's outputs reach 55), where rounding P to one bf16 would show;
# bf16 only: (B, Sq, Skv, H, d, d_v, q_offset), causal
FLASH_LARGE_CASES = [(2, 576, 1152, 4, 96, 96, 0),
                     (2, 448, 1152, 4, 80, 80, 576),
                     (2, 448, 1152, 4, 192, 128, 576)]
# DeepSeek-V3's timed prefill chunk at full width: q (8, 576, 128, 192), k
# (8, 1024, 128, 192), v (8, 1024, 128, 128), causal from q_offset 448
MLA_CHUNK = dict(B=8, Sq=576, Skv=1024, H=128, d=192, dv=128, q_offset=448)
FLASH_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: SERVE_TOL}
RMS_TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: SERVE_TOL}
# RMSNorm's timed shapes: the serve paths' prefill chunks (8 x 576 and
# 8 x 448 rows) and decode step (8 rows) at Phi-3's d_model 3072 and
# Zamba2's 2560 in bf16, and f32 at the first; the row's shape first
RMS_TIME_SHAPES = ([(M, 3072, torch.bfloat16) for M in (4608, 3584, 8)]
                   + [(M, 2560, torch.bfloat16) for M in (4608, 3584, 8)]
                   + [(4608, 3072, torch.float32)])
COLD_L2_TIMES = 3     # the rotated inputs total more than 3 x the L2
# RMSNorm's cases on the card: (M, d, x's offset into its buffer in
# elements, the route f32 and bf16 must take). The serve widths and the
# registry's d_model up to 7168 take the vector kernel; ragged d (d = 100
# is 16-byte whole in f32 only), d above 8192 and an x 1 element off a
# 16-byte boundary take the general one
V, G = "vector", "general"
RMS_CASES = [(8, 3072, 0, (V, V)), (4608, 3072, 0, (V, V)),
             # InternVL2's d_model 6144 over its 1024-position forward
             (8192, 6144, 0, (V, V)), (8, 6144, 0, (V, V)),
             (50, 3072, 0, (V, V)), (8, 128, 0, (V, V)),
             (4608, 128, 0, (V, V)), (50, 128, 0, (V, V)),
             (3584, 2560, 0, (V, V)), (8, 2560, 0, (V, V)),
             (64, 5120, 0, (V, V)), (64, 7168, 0, (V, V)),
             (50, 100, 0, (V, G)), (50, 130, 0, (G, G)),
             (16, 9000, 0, (G, G)), (1, 3072, 0, (V, V)),
             (1, 2560, 0, (V, V)), (64, 3072, 1, (G, G)),
             # Qwen3-30B-A3B's d_model 2048: a prefill chunk, a decode step
             (4608, 2048, 0, (V, V)), (8, 2048, 0, (V, V))]
# the SSD scan: repro's f32 tolerance (1e-4, absolute and relative); bf16
# outputs round separately on both sides: one bf16 step, SERVE_TOL
SSD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: SERVE_TOL}
# (BH, S, P, N, chunk): repro's kernel test shapes, the TPU contract
SSD_TPU_CASES = [(2, 64, 32, 16, 16), (3, 128, 32, 16, 32),
                 (1, 128, 64, 32, 64)]
# (B, S, H, P, N, chunk) in the model's layout, from a non-zero state: the
# hybrid serve path's two prefill chunks, a ragged chunk, the largest chunk,
# and P or N below 64 (the tensor-core route pads them; 20 x 12 at a chunk
# of 25 also takes plain loads)
SSD_MODEL_CASES = [(8, 576, 80, 64, 64, 96), (8, 448, 80, 64, 64, 112),
                   (2, 56, 4, 64, 64, 7), (2, 256, 4, 64, 64, 128),
                   (2, 224, 4, 32, 64, 112), (2, 192, 4, 64, 16, 96),
                   (1, 50, 3, 20, 12, 25)]
# bf16 at serve magnitudes (x x 16, B and C x 8, the state x 1e3: |y| to
# 1e5, as the serve path's outputs reach 2.5e7), where rounding M, S or
# x w to one bf16 would fail the serve tolerance (ssd_tol); (1e-4, 1e-4)
# absolute cannot hold there even for exact f32 sums, whose rounding at
# |y| ~ 1e5 is ~1e-2 where y cancels to near 0
SSD_LARGE_CASES = [(2, 576, 8, 64, 64, 96), (2, 448, 8, 64, 64, 112)]
SSD_LARGE_SCALE = dict(x=16.0, bc=8.0, state=1e3)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def graph_ms(fn, n: int = 200) -> float:
    """Device time per call: ``n`` calls captured in one CUDA graph,
    replayed between CUDA events (no host launch cost in the reading)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(5):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / n)
    return best


def eager_ms(fn, n: int = 200) -> float:
    """Time per call issued from Python (host launch cost included)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def kernel_inputs(R, M, K, N, q, dtype, seed=0):
    g = torch.Generator("cuda").manual_seed(seed)
    x = torch.randn(R, M, K, device="cuda", generator=g).to(dtype)
    w = (torch.randn(R, K, N, device="cuda", generator=g)
         / K ** 0.5).to(dtype)
    us = torch.randn(R, q, K, N, device="cuda", generator=g).to(dtype)
    us = us / us.float().square().sum((2, 3), keepdim=True).sqrt().to(dtype)
    b = torch.randn(R, N, device="cuda", generator=g) * 0.1
    ub = torch.randn(R, q, N, device="cuda", generator=g) * 0.1
    return x, w, us, b, ub


def entry_calls(ops, ref, x, w, us, b, ub):
    """name -> (kernel call, plain call) for the three entry points."""
    return {
        "zoo_dual_matmul_stacked_bias_relu": (
            lambda: ops.zoo_dual_matmul_stacked(x, w, us, MU, b=b, ub=ub),
            lambda: ref.zoo_dual_matmul_stacked_bias_relu_ref(x, w, us, b,
                                                              ub, MU)),
        "zoo_dual_matmul_stacked": (
            lambda: ops.zoo_dual_matmul_stacked(x, w, us, MU),
            lambda: ref.zoo_dual_matmul_stacked_ref(x, w, us, MU)),
        "zoo_dual_matmul": (
            lambda: ops.zoo_dual_matmul(x[0], w[0], us[0, 0], MU),
            lambda: ref.zoo_dual_matmul_ref(x[0], w[0], us[0, 0], MU)),
    }


def library_call(name, x, w, us, b, ub):
    """One PyTorch call computing the same function, its operands (the
    weight stack [W, W + μU_1..q]) formed outside the timed region."""
    if name == "zoo_dual_matmul":
        x, w, us, b, ub = x[:1], w[:1], us[:1, :1], b[:1], ub[:1, :1]
    R, M, K = x.shape
    q, N = us.shape[1], w.shape[-1]
    w_stack = torch.cat([w[:, None], w[:, None] + MU * us], 1)
    w_stack = w_stack.reshape(R * (1 + q), K, N).contiguous()
    x_rep = x[:, None].expand(R, 1 + q, M, K).reshape(R * (1 + q), M, K)
    x_rep = x_rep.contiguous()
    if name == "zoo_dual_matmul_stacked_bias_relu":
        bias = torch.cat([b[:, None], b[:, None] + MU * ub], 1)
        bias = bias.reshape(R * (1 + q), 1, N).to(x.dtype).contiguous()
        return lambda: torch.relu(torch.baddbmm(bias, x_rep, w_stack))
    return lambda: torch.bmm(x_rep, w_stack)


def bound(name, x, w, us, b, ub):
    """Least time for the work (ms) and what bounds it, and the operations
    counted: each input read once, each output written once, against the
    f32 (CUDA core) or bf16 (tensor core) peak."""
    if name == "zoo_dual_matmul":
        x, w, us = x[:1], w[:1], us[:1, :1]
    R, M, K = x.shape
    q, N = us.shape[1], w.shape[-1]
    epi = name == "zoo_dual_matmul_stacked_bias_relu"
    ins = [x, w, us] + ([b, ub] if epi else [])
    nbytes = (sum(t.numel() * t.element_size() for t in ins)
              + R * (1 + q) * M * N * x.element_size())
    ops = 2 * R * M * K * N * (1 + q) + 2 * R * q * M * N
    if epi:
        ops += 2 * R * M * N * (1 + q) + 2 * R * q * M * N
    t_ops = ops / PEAK_OPS[x.dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                 else "bytes"), ops


def check_kernels(ops, ref):
    """Phase 2: every entry point against its plain version, then times."""
    errs = {name: 0.0 for name in KERNELS}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in CHECK_SHAPES:
            args = kernel_inputs(**shape, dtype=dtype)
            for name, (kern, plain) in entry_calls(ops, ref, *args).items():
                got, want = kern(), plain()
                torch.cuda.synchronize()
                err = max(float((g.float() - wn.float()).abs().max())
                          for g, wn in zip(got, want))
                ok = all(torch.allclose(g.float(), wn.float(),
                                        atol=TOL[dtype], rtol=TOL[dtype])
                         for g, wn in zip(got, want))
                log(f"check {name} {str(dtype)[6:]} {shape}: max_abs_err "
                    f"{err:.3e} (tol {TOL[dtype]}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{name} disagrees with its plain "
                                         f"version at {shape}, {dtype}")
                if dtype == torch.float32:
                    errs[name] = max(errs[name], err)
    args = kernel_inputs(**MAIN, dtype=torch.float32, seed=1)
    rows = {}
    for name, (kern, plain) in entry_calls(ops, ref, *args).items():
        b_ms, b_by, n_ops = bound(name, *args)
        rows[name] = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": KERNELS[name], "launches": 0,
            "max_abs_err": errs[name], "ms": graph_ms(kern),
            "plain_ms": graph_ms(plain), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": graph_ms(library_call(name, *args)), "ops": n_ops,
        }
        log(f"time {name} at {MAIN} f32: kernel {rows[name]['ms']:.5f} ms "
            f"(per Python call {eager_ms(kern):.5f} ms), plain "
            f"{rows[name]['plain_ms']:.5f} ms, library "
            f"{rows[name]['library_ms']:.5f} ms, bound {b_ms:.6f} ms "
            f"({b_by})")
    return rows


def event_ms(fn, n: int = 20) -> float:
    """Device time per call for calls that each take long enough to keep
    the queue full: ``n`` eager calls between CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def flash_work(Sq, Skv, causal, window, q_offset):
    """(visible (query, key) pairs, KV rows read) of one (batch, head)."""
    qpos = q_offset + torch.arange(Sq)[:, None]
    kpos = torch.arange(Skv)[None, :]
    mask = torch.ones(Sq, Skv, dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return int(mask.sum()), int(mask.any(0).sum())


def flash_bound(q, k, causal, window, q_offset, dv=None):
    """Least time (ms) for one flash call, what bounds it, and its
    operations: q and o (v's head dim ``dv``, q's by default) once, the
    K and V rows the masks need once; 2 (d + dv) operations per visible
    pair (4 d where dv = d) at the dtype's peak."""
    B, Sq, Hq, d = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    dv = d if dv is None else dv
    pairs, kv_rows = flash_work(Sq, Skv, causal, window, q_offset)
    es = q.element_size()
    nbytes = (B * Sq * Hq * (d + dv) * es
              + B * kv_rows * Hkv * (d + dv) * es)
    ops = 2 * (d + dv) * pairs * B * Hq
    t_ops = ops / PEAK_OPS[q.dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops > t_bytes else "bytes", ops)


def rms_bound(x):
    """Least time (ms) for one RMSNorm call, what bounds it, and its
    operations: x and scale read, y written; 4 operations an element."""
    M, d = x.shape
    nbytes = 2 * x.numel() * x.element_size() + 4 * d
    ops = 4 * M * d
    t_ops = ops / PEAK_OPS[x.dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops > t_bytes else "bytes", ops)


def _err_ok(got, want, tol):
    err = float((got.float() - want.float()).abs().max())
    ok = torch.allclose(got.float(), want.float(), atol=tol[0], rtol=tol[1])
    return err, ok


def sdpa_call(q, k, v, causal, window, q_offset):
    """The library yardstick: scaled_dot_product_attention with the same
    (offset, window) mask given explicitly."""
    Sq, Skv = q.shape[1], k.shape[1]
    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones(Sq, Skv, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask)


def rms_library_call(scale, dtype):
    """x -> ``F.rms_norm`` of x with the same scale (cast to x's type
    outside the timed region), or None where this torch lacks it."""
    rms_norm = getattr(torch.nn.functional, "rms_norm", None)
    if rms_norm is None:
        return None
    w = scale.to(dtype)
    return lambda x: rms_norm(x, (x.shape[1],), weight=w, eps=1e-6)


def cold_inputs(g, M, d, dtype):
    """Distinct (M, d) inputs cut from one flat buffer of more than
    COLD_L2_TIMES x the card's L2, each at a 256-byte-aligned offset: a
    call that takes them in turn never finds its x in the L2."""
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    es = torch.empty((), dtype=dtype).element_size()
    stride = -(-M * d * es // 256) * 256 // es
    n = max(2, COLD_L2_TIMES * l2 // (M * d * es) + 1)
    pool = torch.randn(n * stride, device="cuda", generator=g).to(dtype)
    return [pool[i * stride:i * stride + M * d].view(M, d) for i in range(n)]


def cold_graph_times(fns, xs, min_calls: int = 40, replays: int = 5):
    """Device time per call of each ``fn(x)`` in ``fns``, with x taken in
    turn from ``xs`` (``cold_inputs``: L2-cold): each fn's calls captured in
    a CUDA graph of its own (no host time in the reading), the graphs
    replayed in turns between CUDA events, the best replay of each."""
    n = len(xs) * -(-min_calls // len(xs))
    graphs = {}
    for name, fn in fns.items():
        for x in xs[:2]:
            fn(x)
        torch.cuda.synchronize()
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name]):
            for i in range(n):
                fn(xs[i % len(xs)])
        graphs[name].replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = {name: float("inf") for name in fns}
    for _ in range(replays):
        for name, graph in graphs.items():
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            best[name] = min(best[name], start.elapsed_time(end) / n)
    del graphs
    torch.cuda.empty_cache()
    return best, n


def flash_layer_times(flash_ops, flash_ref, g, d):
    """The bf16 kernel, its plain version and SDPA over one layer's two
    prefill chunks at the serve shapes (B = 8, H = 32, head dim d, a
    1152-slot cache), summed over the chunks, with the bound."""
    bf = torch.bfloat16
    out = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, ops=0)
    ops_t = bytes_t = 0.0
    k = torch.randn(8, 1152, 32, d, device="cuda", generator=g).to(bf)
    v = torch.randn(8, 1152, 32, d, device="cuda", generator=g).to(bf)
    for Sq, off in [(576, 0), (448, 576)]:
        q = torch.randn(8, Sq, 32, d, device="cuda", generator=g).to(bf)
        kw = dict(causal=True, window=0, q_offset=off)
        km = event_ms(lambda: flash_ops.flash_attention_bshd(q, k, v, **kw))
        pm = event_ms(lambda: flash_ref.flash_attention_bshd_ref(q, k, v,
                                                                 **kw), 5)
        lm = event_ms(sdpa_call(q, k, v, True, 0, off))
        b_ms, b_by, n_ops = flash_bound(q, k, True, 0, off)
        log(f"time flash_attention bf16 chunk Sq={Sq} q_offset={off} "
            f"(B=8, H=32, d={d}, Skv=1152): kernel {km:.5f} ms "
            f"({n_ops / km / 1e9:.1f} TFLOP/s), plain {pm:.5f} ms, library "
            f"(SDPA, explicit mask) {lm:.5f} ms, bound {b_ms:.6f} ms "
            f"({b_by})")
        for key, val in (("ms", km), ("plain_ms", pm), ("library_ms", lm),
                         ("bound_ms", b_ms), ("ops", n_ops)):
            out[key] += val
        ops_t += b_ms if b_by == "operations" else 0.0
        bytes_t += b_ms if b_by == "bytes" else 0.0
    out["bound_by"] = "operations" if ops_t >= bytes_t else "bytes"
    log(f"time flash_attention bf16 layer at d={d}: kernel {out['ms']:.5f} "
        f"ms, library (SDPA) {out['library_ms']:.5f} ms, bound "
        f"{out['bound_ms']:.6f} ms: the kernel is "
        f"{out['library_ms'] / out['ms']:.2f}x SDPA's speed")
    return out


# flash attention under capture (tests/test_torch_kernels.py's gpu case):
# Whisper-medium's cross-attention decode call, a causal prefill chunk at
# GQA and d = 96 in bf16 (wgmma, TMA maps), and f32 (the CUDA cores);
# (B, Sq, Skv, Hq, Hkv, d, causal, dtype)
FLASH_CAPTURE_CASES = (
    (8, 1, 1500, 16, 16, 64, False, torch.bfloat16),
    (2, 64, 192, 8, 2, 96, True, torch.bfloat16),
    (2, 64, 128, 4, 4, 64, True, torch.float32),
)


def check_flash_capture(flash_ops) -> None:
    """Phase 2: flash attention captured in a CUDA graph
    (``graphs.StepGraph``) and replayed after fresh contents are copied
    into the same q, k and v buffers equals its eager launch on those
    contents, bitwise (the bf16 launch's TMA maps and the f32 launch's
    pointers, recorded at capture, still address the buffers); one
    launch a replay."""
    from repro_torch import graphs
    g = torch.Generator("cuda").manual_seed(12)
    for B, Sq, Skv, Hq, Hkv, d, causal, dtype in FLASH_CAPTURE_CASES:
        shapes = ((B, Sq, Hq, d), (B, Skv, Hkv, d), (B, Skv, Hkv, d))

        def fresh():
            return [torch.randn(s, generator=g, device="cuda").to(dtype)
                    for s in shapes]
        q, k, v = fresh()
        o = torch.empty((B, Sq, Hq, d), dtype=dtype, device="cuda")

        def body():
            o.copy_(flash_ops.flash_attention_bshd(q, k, v, causal=causal))
        graph = graphs.StepGraph(body, "cuda")
        if graph.launches() != {"flash_attention": 1}:
            raise AssertionError(f"a flash capture recorded "
                                 f"{graph.launches()}")
        for _ in range(3):
            for buf, new in zip((q, k, v), fresh()):
                buf.copy_(new)
            graph.replay()
            want = flash_ops.flash_attention_bshd(q, k, v, causal=causal)
            torch.cuda.synchronize()
            if not torch.equal(o, want):
                raise AssertionError(
                    f"flash replayed from a graph differs from its eager "
                    f"launch: {(o.float() - want.float()).abs().max()}")
        log(f"check flash_attention under capture {str(dtype)[6:]} B={B} "
            f"Sq={Sq} Skv={Skv} Hq={Hq} Hkv={Hkv} d={d} causal={causal}: 3 "
            f"replays on fresh buffer contents bitwise equal to the eager "
            f"launch ({graph.nodes} graph nodes, captured in "
            f"{graph.capture_s:.4f} s)")
        del graph


def check_flash_kernel(flash_ops, flash_ref):
    """Phase 2, flash attention against its plain version on the card;
    then its times at the serve paths' shapes. Returns its kernel row
    (launches filled in later)."""
    g = torch.Generator("cuda").manual_seed(2)
    err_max = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for B, Sq, Skv, Hq, Hkv, d, causal, window, off in FLASH_CASES:
            q = torch.randn(B, Sq, Hq, d, device="cuda", generator=g)
            k = torch.randn(B, Skv, Hkv, d, device="cuda", generator=g)
            v = torch.randn(B, Skv, Hkv, d, device="cuda", generator=g)
            if causal:                  # unwritten cache slots
                k[:, off + Sq:], v[:, off + Sq:] = 0, 0
            q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
            kw = dict(causal=causal, window=window, q_offset=off)
            got = flash_ops.flash_attention_bshd(q, k, v, **kw)
            want = flash_ref.flash_attention_bshd_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            err, ok = _err_ok(got, want, FLASH_TOL[dtype])
            log(f"check flash_attention {str(dtype)[6:]} B={B} Sq={Sq} "
                f"Skv={Skv} Hq={Hq} Hkv={Hkv} d={d} causal={causal} "
                f"window={window} q_offset={off}: max_abs_err {err:.3e} "
                f"(tol {FLASH_TOL[dtype]}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("flash_attention disagrees with its "
                                     "plain version")
            if dtype == torch.bfloat16:
                err_max = max(err_max, err)
        for B, Sq, Skv, Hq, Hkv, d, dv, causal, window, off in \
                FLASH_MLA_CASES:
            q = torch.randn(B, Sq, Hq, d, device="cuda", generator=g)
            k = torch.randn(B, Skv, Hkv, d, device="cuda", generator=g)
            v = torch.randn(B, Skv, Hkv, dv, device="cuda", generator=g)
            k[:, off + Sq:], v[:, off + Sq:] = 0, 0
            q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
            kw = dict(causal=causal, window=window, q_offset=off)
            got = flash_ops.flash_attention_bshd(q, k, v, **kw)
            want = flash_ref.flash_attention_bshd_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            err, ok = _err_ok(got, want, FLASH_TOL[dtype])
            log(f"check flash_attention {str(dtype)[6:]} MLA pair B={B} "
                f"Sq={Sq} Skv={Skv} Hq={Hq} Hkv={Hkv} d={d} d_v={dv} "
                f"causal={causal} window={window} q_offset={off}: out "
                f"{tuple(got.shape)}, max_abs_err {err:.3e} (tol "
                f"{FLASH_TOL[dtype]}) {'ok' if ok else 'FAIL'}")
            if not ok or got.shape != want.shape:
                raise AssertionError("flash_attention disagrees with its "
                                     "plain version at (192, 128)")
            if dtype == torch.bfloat16:
                err_max = max(err_max, err)
        large = FLASH_LARGE_CASES if dtype == torch.bfloat16 else []
        for B, Sq, Skv, H, d, dv, off in large:
            q = torch.randn(B, Sq, H, d, device="cuda", generator=g) * 3
            k = torch.randn(B, Skv, H, d, device="cuda", generator=g) * 3
            v = torch.randn(B, Skv, H, dv, device="cuda", generator=g) * 50
            k[:, off + Sq:], v[:, off + Sq:] = 0, 0
            q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
            got = flash_ops.flash_attention_bshd(q, k, v, q_offset=off)
            want = flash_ref.flash_attention_bshd_ref(q, k, v, q_offset=off)
            torch.cuda.synchronize()
            err, ok = _err_ok(got, want, FLASH_TOL[dtype])
            log(f"check flash_attention {str(dtype)[6:]} serve magnitudes "
                f"B={B} Sq={Sq} Skv={Skv} H={H} d={d} d_v={dv} "
                f"q_offset={off}: "
                f"max_abs_err {err:.3e}, max |want| "
                f"{float(want.float().abs().max()):.4g} (tol "
                f"{FLASH_TOL[dtype]}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("flash_attention disagrees with its "
                                     "plain version at serve magnitudes")
            if dtype == torch.bfloat16:
                err_max = max(err_max, err)
        # the (BH, S, d) entry point of the TPU kernel's layout
        q = torch.randn(6, 200, 64, device="cuda", generator=g).to(dtype)
        got = flash_ops.flash_attention(q, q, q, window=64)
        want = flash_ref.flash_attention_ref(q, q, q, window=64)
        torch.cuda.synchronize()
        err, ok = _err_ok(got, want, FLASH_TOL[dtype])
        log(f"check flash_attention (BH, S, d) {str(dtype)[6:]}: "
            f"max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("flash_attention (BH layout) disagrees")

    # times at the serve paths' shapes (bf16): one attention layer's two
    # prefill chunks, at Phi-3's head dim 96 (the row) and Zamba2's 80 (its
    # "at_d80")
    rows = {}
    for d in (96, 80):
        layer = flash_layer_times(flash_ops, flash_ref, g, d)
        if d == 96:
            rows["flash_attention"] = {
                **layer,
                "unit": "one layer's prefill: chunks of 576 (q_offset 0) "
                        "and 448 (q_offset 576) query rows, B=8, H=32, d=96, "
                        "Skv=1152, bf16"}
        else:
            rows["flash_attention"]["at_d80"] = {
                **layer,
                "unit": "one Zamba2 attention site's prefill: the same "
                        "chunks at d=80"}
    rows["flash_attention"]["at_mla_192_128"] = flash_mla_times(
        flash_ops, flash_ref, g)
    rows["flash_attention"].update(flash_family_times(flash_ops, flash_ref,
                                                      g))
    replaces, source = SERVE_ROWS["flash_attention"]
    rows["flash_attention"] = {
        "name": "flash_attention", "route": "cuda", "source": source,
        "replaces": replaces, "launches": 0,
        "max_abs_err": err_max, **rows["flash_attention"]}
    return rows


def flash_mla_times(flash_ops, flash_ref, g) -> dict:
    """The bf16 kernel at DeepSeek-V3's prefill chunk (MLA_CHUNK: (d_qk,
    d_v) = (192, 128), H = 128 after the latent's expansion), its plain
    version, SDPA with the same mask given explicitly (v's head dim its
    own) and the bound."""
    c, bf = MLA_CHUNK, torch.bfloat16
    q = torch.randn(c["B"], c["Sq"], c["H"], c["d"], device="cuda",
                    generator=g).to(bf)
    k = torch.randn(c["B"], c["Skv"], c["H"], c["d"], device="cuda",
                    generator=g).to(bf)
    v = torch.randn(c["B"], c["Skv"], c["H"], c["dv"], device="cuda",
                    generator=g).to(bf)
    kw = dict(causal=True, window=0, q_offset=c["q_offset"])
    km = event_ms(lambda: flash_ops.flash_attention_bshd(q, k, v, **kw))
    pm = event_ms(lambda: flash_ref.flash_attention_bshd_ref(q, k, v, **kw),
                  3)
    lm = event_ms(sdpa_call(q, k, v, True, 0, c["q_offset"]))
    b_ms, b_by, n_ops = flash_bound(q, k, True, 0, c["q_offset"], dv=c["dv"])
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v)) + \
        c["B"] * c["Sq"] * c["H"] * c["dv"] * 2
    log(f"time flash_attention bf16 MLA chunk (B={c['B']}, Sq={c['Sq']}, "
        f"Skv={c['Skv']}, H={c['H']}, d={c['d']}, d_v={c['dv']}, q_offset "
        f"{c['q_offset']}, causal): kernel {km:.5f} ms "
        f"({n_ops / km / 1e9:.1f} TFLOP/s, {b_ms / km:.2%} of the bound), "
        f"plain {pm:.5f} ms, library (SDPA, explicit mask) {lm:.5f} ms, "
        f"bound {b_ms:.6f} ms ({b_by}; {nbytes / 1e9:.4f} GB of q, k, v, o, "
        f"{n_ops / 1e12:.4f} TFLOP): the kernel is {lm / km:.2f}x SDPA's "
        f"speed")
    return dict(ms=km, plain_ms=pm, library_ms=lm, bound_ms=b_ms,
                bound_by=b_by, ops=n_ops,
                unit="DeepSeek-V3's prefill chunk: q (8, 576, 128, 192), k "
                     "(8, 1024, 128, 192), v (8, 1024, 128, 128), q_offset "
                     "448, causal, bf16")


# phase 10 (e)'s timed shapes, bf16: Whisper-medium's encoder layer (B 8,
# 1500 frames, 16 heads of 64, non-causal) and InternVL2-26B's
# vision-prefill layer (B 8, 1024 positions, 48 query and 8 KV heads of
# 128, causal); (name, B, S, Hq, Hkv, d, causal, what)
FLASH_FAMILY_TIMES = (
    ("at_whisper_encoder", 8, 1500, 16, 16, 64, False,
     "Whisper-medium's encoder layer: q, k, v (8, 1500, 16, 64), "
     "non-causal, bf16"),
    ("at_internvl2_prefill", 8, 1024, 48, 8, 128, True,
     "InternVL2-26B's vision-prefill layer: q (8, 1024, 48, 128), k and v "
     "(8, 1024, 8, 128), causal, bf16"))


def sdpa_best_call(q, k, v, causal):
    """The library yardstick at its best: scaled_dot_product_attention
    with ``is_causal`` (no explicit mask, so its flash backend may run)
    and, for GQA, ``enable_gqa`` (KV heads read in place); where this
    torch lacks ``enable_gqa``, the KV heads are repeated outside the
    timed call."""
    F = torch.nn.functional
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    G = q.shape[2] // k.shape[2]
    if G == 1:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=causal)
    try:
        F.scaled_dot_product_attention(qt[:, :, :1], kt[:, :, :1],
                                       vt[:, :, :1], enable_gqa=True)
    except TypeError:
        kt, vt = (t.repeat_interleave(G, dim=1) for t in (kt, vt))
        return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=causal)
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True)


def flash_family_times(flash_ops, flash_ref, g) -> dict:
    """The bf16 kernel at FLASH_FAMILY_TIMES' shapes, its plain version,
    SDPA (``sdpa_best_call``) and the bound (``flash_bound``: q and o
    once, the K and V rows once; 4 d operations a visible pair)."""
    out = {}
    bf = torch.bfloat16
    for name, B, S, Hq, Hkv, d, causal, what in FLASH_FAMILY_TIMES:
        q = torch.randn(B, S, Hq, d, device="cuda", generator=g).to(bf)
        k = torch.randn(B, S, Hkv, d, device="cuda", generator=g).to(bf)
        v = torch.randn(B, S, Hkv, d, device="cuda", generator=g).to(bf)
        km = event_ms(lambda: flash_ops.flash_attention_bshd(
            q, k, v, causal=causal))
        pm = event_ms(lambda: flash_ref.flash_attention_bshd_ref(
            q, k, v, causal=causal), 3)
        lm = event_ms(sdpa_best_call(q, k, v, causal))
        b_ms, b_by, n_ops = flash_bound(q, k, causal, 0, 0)
        nbytes = 2 * sum(t.numel() * t.element_size() for t in (q, k))
        log(f"time flash_attention bf16 {what}: kernel {km:.5f} ms "
            f"({n_ops / km / 1e9:.1f} TFLOP/s, {b_ms / km:.2%} of the "
            f"bound), plain {pm:.5f} ms, library (SDPA, is_causal, GQA in "
            f"place) {lm:.5f} ms, bound {b_ms:.6f} ms ({b_by}; "
            f"{n_ops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB of q, k, v, o "
            f"= {nbytes / PEAK_BYTES * 1e3:.6f} ms): the kernel is "
            f"{lm / km:.2f}x SDPA's speed")
        out[name] = dict(ms=km, plain_ms=pm, library_ms=lm, bound_ms=b_ms,
                         bound_by=b_by, ops=n_ops, unit=what)
        del q, k, v
    torch.cuda.empty_cache()
    return out


def check_rmsnorm(rms_ops, rms_ref, rms_kernel):
    """Phase 2, RMSNorm against its plain version on the card (each case
    held to the route it must take); then its times at RMS_TIME_SHAPES.
    Returns its kernel row (launches filled in later)."""
    g = torch.Generator("cuda").manual_seed(4)
    err_max = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for M, d, offset, want_routes in RMS_CASES:
            want_route = want_routes[dtype == torch.bfloat16]
            flat = torch.randn(offset + M * d, device="cuda", generator=g)
            x = flat.to(dtype)[offset:].view(M, d)
            sc = torch.randn(d, device="cuda", generator=g)
            before = dict(rms_ops.route_launches)
            got, want = rms_ops.rmsnorm(x, sc), rms_ref.rmsnorm_ref(x, sc)
            torch.cuda.synchronize()
            took = [r for r, n in rms_ops.route_launches.items()
                    if n != before[r]]
            err, ok = _err_ok(got, want, RMS_TOL[dtype])
            where = (f", x {offset} element(s) into its buffer" if offset
                     else "")
            log(f"check rmsnorm {str(dtype)[6:]} M={M} d={d}{where}: route "
                f"{took} (want {want_route}), max_abs_err {err:.3e} "
                f"(tol {RMS_TOL[dtype]}) {'ok' if ok else 'FAIL'}")
            if took != [want_route]:
                raise AssertionError(f"rmsnorm took route {took}, want "
                                     f"{want_route}")
            if not ok:
                raise AssertionError("rmsnorm disagrees with its plain "
                                     "version")
            if dtype == torch.bfloat16:
                err_max = max(err_max, err)
    shapes = {key: time_rmsnorm(rms_ops, rms_ref, rms_kernel, g, *key)
              for key in RMS_TIME_SHAPES}
    first = shapes[RMS_TIME_SHAPES[0]]
    replaces, source = SERVE_ROWS["rmsnorm"]
    return {"rmsnorm": {
        "name": "rmsnorm", "route": "cuda", "source": source,
        "replaces": replaces, "launches": 0, "max_abs_err": err_max,
        "ms": first["kernel"], "plain_ms": first["plain"],
        "library_ms": first["F.rms_norm"], "bound_ms": first["bound_ms"],
        "bound_by": first["bound_by"], "ops": first["ops"],
        "at_shapes": {f"M={M},d={d},{str(dt)[6:]}": t
                      for (M, d, dt), t in shapes.items()},
        "unit": "one call at the first prefill chunk's rows, M=4608, "
                "d=3072, bf16; device time from CUDA graphs over L2-cold "
                "inputs"}}


def rms_general_call(rms_kernel, sc):
    """x -> y through the RMSNorm library's general kernel (the first
    port's), not counted as a launch: timed beside the wrapper's vector
    route."""
    def call(x):
        y = torch.empty_like(x)
        rms_kernel.launch(x, sc, y, 1e-6, "general")
        return y
    return call


def time_rmsnorm(rms_ops, rms_ref, rms_kernel, g, M, d, dtype):
    """One shape's RMSNorm times (ms), graph-timed over L2-cold inputs in
    turns: the wrapper (the vector route), the general kernel (the first
    port's), F.rms_norm and the plain version.
    Beside them the time per Python call (eager_ms: the host's cost where
    it exceeds the device's) of the wrapper and of F.rms_norm; the former
    reading (event_ms over 20 eager calls on one x,
    which the L2 may hold), logged only; the vector kernel's launch shape
    and resident blocks an SM; at M = 8 the library's empty kernel at that
    launch shape, the launch floor."""
    xs = cold_inputs(g, M, d, dtype)
    sc = torch.randn(d, device="cuda", generator=g)
    lib = rms_library_call(sc, dtype)
    fns = {"kernel": lambda x: rms_ops.rmsnorm(x, sc),
           "general": rms_general_call(rms_kernel, sc),
           "F.rms_norm": lib,
           "plain": lambda x: rms_ref.rmsnorm_ref(x, sc)}
    if lib is None:
        del fns["F.rms_norm"]
    best, n = cold_graph_times(fns, xs)
    b_ms, b_by, n_ops = rms_bound(xs[0])
    threads, vecs, rows = rms_ops.launch_shape(xs[0])
    blocks = rms_kernel.occupancy(dtype, d, (threads, vecs, rows))
    out = {**best, "bound_ms": b_ms, "bound_by": b_by, "ops": n_ops,
           "eager_ms": eager_ms(lambda: rms_ops.rmsnorm(xs[0], sc)),
           "event_ms_warm": event_ms(lambda: rms_ops.rmsnorm(xs[0], sc)),
           "launch_shape": {
               "threads_a_row": threads, "vectors_a_thread": vecs,
               "rows_a_block": rows, "blocks_an_sm": blocks}}
    out.setdefault("F.rms_norm", None)
    out["library_eager_ms"] = (None if lib is None
                               else eager_ms(lambda: lib(xs[0])))
    grid = -(-M // rows)
    if M == 8:
        out["empty_kernel_ms"] = graph_ms(
            lambda: rms_kernel.launch_empty(grid, threads * rows))
    lm, le = out["F.rms_norm"], out["library_eager_ms"]
    log(f"time rmsnorm {str(dtype)[6:]} M={M} d={d}, L2-cold ({len(xs)} "
        f"inputs of {xs[0].numel() * xs[0].element_size()} B in turns, {n} "
        f"calls a graph, the best of 5 replays): kernel {best['kernel']:.5f} "
        f"ms ({b_ms / best['kernel']:.2%} of its bound; {grid} blocks of "
        f"{rows} x {threads} threads x {vecs} vectors, {blocks} an SM); "
        f"general (the first port's) kernel {best['general']:.5f} ms; "
        f"F.rms_norm {'none' if lm is None else f'{lm:.5f} ms'}; plain "
        f"{best['plain']:.5f} ms; bound {b_ms:.6f} ms ({b_by}); per Python "
        f"call (eager_ms) {out['eager_ms']:.5f} ms, F.rms_norm's "
        f"{'none' if le is None else f'{le:.5f} ms'}"
        f"; former reading (event_ms, 20 eager calls on one x) "
        f"{out['event_ms_warm']:.5f} ms"
        + (f"; empty kernel on {grid} x {threads * rows} threads (graph) "
           f"{out['empty_kernel_ms']:.5f} ms" if M == 8 else ""))
    del xs
    torch.cuda.empty_cache()
    return out


def ssd_inputs(g, B, S, H, P, N, dtype, x_scale=1.0, bc_scale=1.0,
               state_scale=1.0):
    """SSD operands in the model's layout as repro's kernel test draws
    them (x, B, C scaled by 0.5; a in (0.05, 0.95); dt softplus of a
    normal), and a non-zero f32 initial state; the scales multiply x, B
    and C, and the state."""
    x = (torch.randn(B, S, H, P, device="cuda", generator=g) * 0.5
         * x_scale).to(dtype)
    a = torch.sigmoid(torch.randn(B, S, H, device="cuda", generator=g))
    a = a * 0.9 + 0.05
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, H, device="cuda", generator=g))
    bm = (torch.randn(B, S, N, device="cuda", generator=g) * 0.5
          * bc_scale).to(dtype)
    cm = (torch.randn(B, S, N, device="cuda", generator=g) * 0.5
          * bc_scale).to(dtype)
    s0 = torch.randn(B, H, P, N, device="cuda", generator=g) * state_scale
    return x, a, dt, bm, cm, s0


def ssd_bound(x, bm, chunk, y_dtype, with_state):
    """Least time (ms) for one SSD call: x, a, dt, B, C and y once, the
    states in and out once; the multiply-adds of the lower-triangle chunk
    products, the inter-chunk term and the state update (2 operations
    each), 4 per visible pair for the decay weights, at x's dtype's peak."""
    B, S, H, P = x.shape
    N = bm.shape[-1]
    pairs = chunk * (chunk + 1) // 2
    n_chunks = S // chunk
    es, ys = x.element_size(), torch.empty((), dtype=y_dtype).element_size()
    nbytes = (x.numel() * es + 2 * B * S * H * 4 + 2 * B * S * N * es
              + x.numel() * ys + (2 if with_state else 0) * B * H * P * N * 4)
    ops = B * H * n_chunks * (2 * (pairs * (N + P) + 2 * chunk * P * N)
                              + 4 * pairs)
    t_ops = ops / PEAK_OPS[x.dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops > t_bytes else "bytes", ops)


def ssd_tol(want, tol):
    """SSD tolerance on the serve path's own tensors: its atol is taken
    relative to the largest |want| (at least 1): with full-width random
    weights the scan's outputs and states reach the thousands, and two f32
    sums in other orders differ there by a few 1e-7 of the largest term,
    also where terms cancel to a small value."""
    return (tol[0] * max(1.0, float(want.float().abs().max())), tol[1])


def check_ssd_kernel(ssd_ops, ssd_ref, ssd_kernel, build_report):
    """Phase 2, the SSD scan against its plain version (the per-token
    recurrence) on the card, the tensor-core route's launch shape, then its
    time at the serve path's shapes. Returns its kernel row (launches
    filled in later)."""
    g = torch.Generator("cuda").manual_seed(3)
    err_max = 0.0
    f32_tol = SSD_TOL[torch.float32]
    for dtype in (torch.float32, torch.bfloat16):
        for BH, S, P, N, chunk in SSD_TPU_CASES:
            x, a, dt, bm, cm, _ = ssd_inputs(g, BH, S, 1, P, N, dtype)
            x, a, dt = x[:, :, 0].contiguous(), a[:, :, 0].contiguous(), \
                dt[:, :, 0].contiguous()
            got = ssd_ops.ssd_chunk(x, a, dt, bm, cm, chunk=chunk)
            want = ssd_ref.ssd_chunk_ref(x, a, dt, bm, cm)
            torch.cuda.synchronize()
            err, ok = _err_ok(got, want, SSD_TOL[dtype])
            log(f"check ssd_chunk (BH, S, P) {str(dtype)[6:]} BH={BH} S={S} "
                f"P={P} N={N} chunk={chunk}: max_abs_err {err:.3e} (tol "
                f"{SSD_TOL[dtype]}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("ssd_chunk disagrees with its plain "
                                     "version")
            err_max = max(err_max, err)
        for B, S, H, P, N, chunk in SSD_MODEL_CASES:
            x, a, dt, bm, cm, s0 = ssd_inputs(g, B, S, H, P, N, dtype)
            y, s1 = ssd_ops.ssd_chunk_bshp(x, a, dt, bm, cm, chunk=chunk,
                                           state0=s0)
            yr, sr = ssd_ref.ssd_states_ref(x, a, dt, bm, cm, state0=s0)
            torch.cuda.synchronize()
            # y and the state are f32 whatever x's type: f32 tolerance
            (ey, oky), (es, oks) = (_err_ok(y, yr, f32_tol),
                                    _err_ok(s1, sr, f32_tol))
            log(f"check ssd_chunk (B, S, H, P) {str(dtype)[6:]} B={B} S={S} "
                f"H={H} P={P} N={N} chunk={chunk}, state in and out: y "
                f"max_abs_err {ey:.3e} (max |y| "
                f"{float(yr.abs().max()):.4g}), state max_abs_err {es:.3e} "
                f"(tol {f32_tol}) {'ok' if oky and oks else 'FAIL'}")
            if not (oky and oks):
                raise AssertionError("ssd_chunk (model layout) disagrees "
                                     "with its plain version")
            err_max = max(err_max, ey, es)
    for B, S, H, P, N, chunk in SSD_LARGE_CASES:
        x, a, dt, bm, cm, s0 = ssd_inputs(
            g, B, S, H, P, N, torch.bfloat16,
            x_scale=SSD_LARGE_SCALE["x"], bc_scale=SSD_LARGE_SCALE["bc"],
            state_scale=SSD_LARGE_SCALE["state"])
        y, s1 = ssd_ops.ssd_chunk_bshp(x, a, dt, bm, cm, chunk=chunk,
                                       state0=s0)
        yr, sr = ssd_ref.ssd_states_ref(x, a, dt, bm, cm, state0=s0)
        # the CUDA-core route on the same values in f32, for the record
        y32, _ = ssd_ops.ssd_chunk_bshp(x.float(), a, dt, bm.float(),
                                        cm.float(), chunk=chunk, state0=s0)
        torch.cuda.synchronize()
        (ey, oky), (es, oks) = (_err_ok(y, yr, ssd_tol(yr, f32_tol)),
                                _err_ok(s1, sr, ssd_tol(sr, f32_tol)))
        e32, ok32 = _err_ok(y32, yr, f32_tol)
        log(f"check ssd_chunk bf16 at serve magnitudes B={B} S={S} H={H} "
            f"chunk={chunk}: y max_abs_err {ey:.3e} (max |y| "
            f"{float(yr.abs().max()):.4g}), state max_abs_err {es:.3e} (max "
            f"|state| {float(sr.abs().max()):.4g}) (tol ssd_tol: "
            f"{f32_tol[0]} x max |want| plus {f32_tol[1]} x |want|) "
            f"{'ok' if oky and oks else 'FAIL'}; for the record, the f32 "
            f"CUDA-core route on the same values: y max_abs_err {e32:.3e}, "
            f"(1e-4, 1e-4) {'holds' if ok32 else 'does not hold'}")
        if not (oky and oks):
            raise AssertionError("ssd_chunk (bf16, serve magnitudes) "
                                 "disagrees with its plain version")
        err_max = max(err_max, ey, es)

    # the tensor-core route's launch shape, registers and spills
    lines = [ln.strip() for ln in build_report.splitlines()
             if re.search(r"registers|spill", ln)]
    log("ssd_chunk build report: " + " | ".join(lines))
    shapes = {}
    for B, S, H, P, N, chunk in SSD_MODEL_CASES[:2]:
        occ = ssd_kernel.occupancy(torch.bfloat16, B, H, chunk)
        nbytes = ssd_kernel.scratch_bytes(torch.bfloat16, B, S, H, chunk)
        log(f"ssd_chunk tensor-core route at S={S} chunk={chunk}: scan "
            f"kernel {occ}; pre-pass grid {B * (S // chunk)} x "
            f"{-(-H // 16) + 1}; scratch {nbytes} B")
        shapes[f"S={S},chunk={chunk}"] = {**occ, "scratch_bytes": nbytes}

    # times at the serve path's shapes: one Mamba2 layer's two prefill
    # chunks (bf16 x, B, C; f32 y; state in and out)
    kern_ms = plain_ms = bound_ms = ops_t = bytes_t = 0.0
    total_ops = 0
    for B, S, H, P, N, chunk in SSD_MODEL_CASES[:2]:
        x, a, dt, bm, cm, s0 = ssd_inputs(g, B, S, H, P, N, torch.bfloat16)
        km = event_ms(lambda: ssd_ops.ssd_chunk_bshp(x, a, dt, bm, cm,
                                                     chunk=chunk, state0=s0))
        pm = event_ms(lambda: ssd_ref.ssd_states_ref(x, a, dt, bm, cm,
                                                     state0=s0), 3)
        b_ms, b_by, n_ops = ssd_bound(x, bm, chunk, torch.float32, True)
        log(f"time ssd_chunk bf16 S={S} chunk={chunk} (B={B}, H={H}, P={P}, "
            f"N={N}, state in and out): kernel {km:.5f} ms, plain (per-token "
            f"recurrence) {pm:.5f} ms, library none (no single PyTorch call "
            f"computes the SSD scan), bound {b_ms:.6f} ms ({b_by})")
        kern_ms, plain_ms, bound_ms = kern_ms + km, plain_ms + pm, \
            bound_ms + b_ms
        total_ops += n_ops
        ops_t += b_ms if b_by == "operations" else 0.0
        bytes_t += b_ms if b_by == "bytes" else 0.0
    name = "ssd_chunk"
    replaces, source = SERVE_ROWS[name]
    return {name: {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": 0, "max_abs_err": err_max,
        "ms": kern_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if ops_t >= bytes_t else "bytes",
        "library_ms": None, "ops": total_ops, "launch_shapes": shapes,
        "unit": "one Mamba2 layer's prefill: chunks of 576 rows (chunk 96) "
                "and 448 rows (chunk 112), B=8, H=80, P=N=64, x/B/C bf16, y "
                "f32, state in and out; device_kernels_per_call is counted "
                "by the Zamba2 prefill profile; no PyTorch library call "
                "computes the SSD scan"}}


class Capture:
    """Wrap a kernel entry point (at the script's level, by replacing the
    ``ops`` module's attribute for one run) and keep copies of the inputs
    of the calls whose 0-based index is in ``keep``. Calls made while a
    CUDA graph is being captured are passed through and not counted: their
    inputs hold no values yet (the graph's warm-up step, made eagerly just
    before, is counted with its real inputs)."""

    def __init__(self, module, attr, keep):
        self.module, self.attr, self.keep = module, attr, set(keep)
        self.inner = getattr(module, attr)
        self.calls = 0
        self.inputs = {}

    def __call__(self, *args, **kw):
        if torch.cuda.is_current_stream_capturing():
            return self.inner(*args, **kw)
        if self.calls in self.keep:
            self.store(args, kw)
        self.calls += 1
        return self.inner(*args, **kw)

    def store(self, args, kw):
        self.inputs[self.calls] = (
            [a.clone() for a in args],
            {k: v.clone() if isinstance(v, torch.Tensor) else v
             for k, v in kw.items()})

    def __enter__(self):
        setattr(self.module, self.attr, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.inner)


# each serve kernel's entry point in its ops module
KERNEL_ENTRIES = {"flash_attention": "flash_attention_bshd",
                  "rmsnorm": "rmsnorm", "ssd_chunk": "ssd_chunk_bshp"}


def call_signature(args, kw):
    """A kernel call's shapes and options: tensors by shape and dtype."""
    def one(v):
        return (tuple(v.shape), str(v.dtype)) if isinstance(
            v, torch.Tensor) else v
    return (tuple(one(a) for a in args),
            tuple(sorted((k, one(v)) for k, v in kw.items())))


class GroupCapture(Capture):
    """Capture by the path's structure: the calls come in groups of
    ``per_group`` (one forward pass's calls of the kernel, site by site).
    At the first group of each new call signature (a new chunk shape,
    offset or wave width), keep copies of the calls at ``positions`` in
    that group."""

    def __init__(self, module, attr, per_group, positions):
        super().__init__(module, attr, ())
        self.per_group, self.positions = per_group, set(positions)
        self.seen, self.keeping = {}, False

    def __call__(self, *args, **kw):
        if torch.cuda.is_current_stream_capturing():
            return self.inner(*args, **kw)
        j = self.calls % self.per_group
        if j == 0:
            sig = call_signature(args, kw)
            self.keeping = sig not in self.seen
            self.seen.setdefault(sig, self.calls)
        if self.keeping and j in self.positions:
            self.store(args, kw)
        self.calls += 1
        return self.inner(*args, **kw)


def flash_f64(q, k, v, *, causal=True, window=0, q_offset=0, heads=8):
    """The plain version's function evaluated in f64 from the same (bf16)
    inputs, ``heads`` query heads at a time: the exact answer an f32
    evaluation is judged against where the scores are peaked enough that
    two f32 evaluations of them differ beyond the serve tolerance."""
    B, Sq, Hq, d = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones(Sq, Skv, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    out = torch.empty(B, Sq, Hq, v.shape[3], dtype=torch.float64,
                      device=q.device)
    for h0 in range(0, Hq, heads):
        hs = range(h0, min(h0 + heads, Hq))
        kv = [h // G for h in hs]
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, :, h0:hs[-1] + 1].double()
                         * d ** -0.5, k[:, :, kv].double())
        p = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
        del s
        out[:, :, h0:hs[-1] + 1] = torch.einsum("bhqk,bkhd->bqhd", p,
                                                v[:, :, kv].double())
    return out


def conditioned_flash(got, want, args, kw, tol):
    """For a flash call whose kernel and plain outputs differ beyond
    ``tol``: each one's worst deviation from the exact (f64) answer, as a
    multiple of the tolerance at the exact value. The call passes when the
    kernel's is at most 1, or at most twice the plain version's own (the
    repo's rule for two f32 evaluations of an ill-conditioned function:
    the training step's gate allows twice the f32 step's own error).
    Returns (kernel's, plain's, passes)."""
    exact = flash_f64(*args, **kw)
    scale = tol[0] + tol[1] * exact.abs()
    r_kernel = float(((got.double() - exact).abs() / scale).max())
    r_plain = float(((want.double() - exact).abs() / scale).max())
    return r_kernel, r_plain, r_kernel <= max(1.0, 2.0 * r_plain)


def hold_calls(name, ops, ref, inputs, where, what):
    """Re-run captured calls of kernel ``name`` through its wrapper and its
    plain version; log each error, raise on a disagreement, return the
    worst error. ``where(i, args, kw)`` describes call ``i``. A flash call
    outside the tolerance is judged against the exact answer
    (:func:`conditioned_flash`): DeepSeek-V3's random-weight scores spread
    to about 680 (its stacked leaves take the fan-in of their layer axis),
    where two f32 evaluations of a near-tied softmax row differ beyond
    the serve tolerance."""
    worst = 0.0
    for i, (args, kw) in sorted(inputs.items()):
        if name == "flash_attention":
            got = [ops.flash_attention_bshd(*args, **kw)]
            want = [ref.flash_attention_bshd_ref(*args, **kw)]
            tols = [SERVE_TOL]
        elif name == "rmsnorm":
            got = [ops.rmsnorm(*args, **kw)]
            want = [ref.rmsnorm_ref(*args, **kw)]
            tols = [SERVE_TOL]
        else:
            got = list(ops.ssd_chunk_bshp(*args, **kw))
            want = list(ref.ssd_states_ref(*args, state0=kw.get("state0")))
            tols = [ssd_tol(w, SSD_TOL[torch.float32]) for w in want]
        torch.cuda.synchronize()
        checks = [_err_ok(g, w, t) for g, w, t in zip(got, want, tols)]
        err = max(e for e, _ in checks)
        ok = all(o for _, o in checks)
        worst = max(worst, err)
        exact = ""
        if not ok and name == "flash_attention":
            r_kernel, r_plain, ok = conditioned_flash(got[0], want[0], args,
                                                      kw, tols[0])
            exact = (f"; against the exact (f64) answer, in multiples of the "
                     f"tolerance: kernel {r_kernel:.3f}, plain version "
                     f"{r_plain:.3f} (passes at most max(1, 2 x the plain's))")
        log(f"{what} tensors: {name} call {i} ({where(i, args, kw)}): "
            f"max_abs_err {err:.3e}, output max |.| "
            f"{max(float(w.float().abs().max()) for w in want):.4g} (tol "
            f"{tols}){exact} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees on the {what} path's "
                                 "tensors")
    return worst


# the RMSNorm library's device kernels, by name
RMS_DEVICE_KERNELS = r"rmsnorm_(?:vec|general)_kernel"
# kernel families of a replayed decode step's profile, by the kernel's
# name (the first family that matches)
DECODE_FAMILIES = (
    ("RMSNorm", r"rmsnorm"),
    ("weight products and GEMVs (cuBLAS)",
     r"gemm|gemv|nvjet|sm90_|cutlass|xmma|cublas|splitk"),
    ("casts and copies", r"copy"),
    ("softmax", r"softmax"),
    ("gathers, scatters and index ops", r"index|gather|scatter"),
)


# a zero-length profiler range marking where a timed window starts
BUSY_START = "busy window start"


def device_events(prof) -> list:
    """A profile's device events: each kernel's, copy's or fill's (not
    the GPU timeline's projections of the profiler ranges)."""
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def busy_window(prof, spans, wall_us, after=BUSY_START):
    """(start, end) of a profile's timed window in us (see
    ``busy_union``)."""
    from torch.autograd import DeviceType
    marks = [e.time_range.end for e in prof.events()
             if e.device_type == DeviceType.CPU and e.name == after]
    lo = max(marks) if marks else min(a for a, _ in spans)
    return lo, lo + wall_us


def busy_union(what, prof, wall_us, sum_us, after=BUSY_START) -> float:
    """The device's busy time in a profile's timed window, in us: the union
    of its device events' intervals (each kernel's, copy's or fill's device
    start and end; not the GPU timeline's projections of the profiler
    ranges, which span idle time too), clipped to the window, so kernels
    that overlap count once. The window
    starts at the end of the profile's last CPU range named ``after``
    (``BUSY_START`` just before the timed region, or the profiler's
    warm-up range), or, in a profile with no such range (a CUDA-only one,
    which holds the timed window alone), at its first device event; it
    lasts the host's ``wall_us``. Logs the union beside ``sum_us``, the
    old reading: the sum of the kernels' durations."""
    spans = [(e.time_range.start, e.time_range.end)
             for e in device_events(prof)]
    if not spans:
        return 0.0
    lo, hi = busy_window(prof, spans, wall_us, after)
    union, reach = 0.0, lo
    for a, b in sorted(spans):
        a, b = max(a, reach), min(b, hi)
        if b > a:
            union += b - a
            reach = b
    log(f"{what}: device busy {union:.1f} us as the union of {len(spans)} "
        f"device intervals in the {wall_us:.1f} us window "
        f"({union / wall_us:.2%}); the kernels' summed durations "
        f"{sum_us:.1f} us ({sum_us / wall_us:.2%})")
    return union


def profile_graph(what, graph, rewind, steps: int = 8,
                  traces: int = 5) -> dict:
    """``steps`` replays of a captured step under torch.profiler (the
    device's busy share, device events a replay, the top kernels), after
    one replay in the profiler's warm-up (traced and dropped: a trace can
    miss the first launches it sees), then ``steps`` more between CUDA
    events; ``rewind()`` sets back the position that the replays advance
    (the buffers hold ``steps + 1`` of them). Every node of the graph is
    one device event a replay, so a trace with fewer than ``graph.nodes``
    a replay lost records (the tracer drops a few now and then); it is
    logged and taken again, up to ``traces`` times. On a complete trace the profiler's count of RMSNorm kernels a
    replay, by the kernel's own name, must equal the launches the
    capture recorded; raises if the profiler saw no device time or no
    trace was complete."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    captured = graph.captured["rmsnorm"]["rmsnorm"]
    for attempt in range(1, traces + 1):
        rewind()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            graph.replay(1)
            torch.cuda.synchronize()
            prof.step()
            t0 = time.perf_counter()
            graph.replay(steps)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
            prof.step()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        busy_sum = sum(dev_us(e) for e in kernels)
        if not busy_sum:
            raise AssertionError(f"{what}: the profiler saw no CUDA kernel "
                                 "time in the graph's replays")
        events = sum(e.count for e in kernels)
        rms = sum(e.count for e in kernels
                  if re.search(RMS_DEVICE_KERNELS, e.key)) / steps
        if events >= graph.nodes * steps:
            break
        log(f"{what}: trace {attempt} of {traces} lost "
            f"{graph.nodes * steps - events} of {graph.nodes * steps} "
            f"device records ({rms} RMSNorm kernels a replay); traced "
            "again")
    else:
        raise AssertionError(f"{what}: each of {traces} traces lost device "
                             "records")
    busy = busy_union(f"{what} (trace {attempt})", prof, wall_us, busy_sum)
    rewind()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay(steps)
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / steps
    log(f"{what}: {steps} replays ({graph.nodes} graph nodes, "
        f"{graph.kernel_nodes} kernel nodes, captured in "
        f"{graph.capture_s:.4f} s) under torch.profiler (trace {attempt}): "
        f"wall {wall_us / steps:.1f} us a step, device busy "
        f"{busy / steps:.1f} us a step ({busy / wall_us:.2%} of wall), "
        f"{events / steps:.1f} device events a step, "
        f"{rms:.1f} RMSNorm kernels a step by name (the capture recorded "
        f"{captured}); CUDA events: {step_ms:.4f} ms a replay")
    split = {name: 0.0 for name, _ in DECODE_FAMILIES}
    split["the rest (elementwise f32 work, reductions)"] = 0.0
    for e in kernels:
        fam = next((name for name, pat in DECODE_FAMILIES
                    if re.search(pat, e.key, re.IGNORECASE)),
                   "the rest (elementwise f32 work, reductions)")
        split[fam] += dev_us(e)
    log(f"{what}: device time a step by kernel family (shares of the "
        "summed durations): " + "; ".join(
            f"{name} {us / steps:.1f} us ({us / busy_sum:.2%})"
            for name, us in split.items()))
    for e in sorted(kernels, key=dev_us, reverse=True)[:10]:
        log(f"  {dev_us(e) / steps:9.2f} us/step  x{e.count / steps:6.2f}"
            f"  {e.key[:90]}")
    if rms != captured:
        raise AssertionError(f"{what}: a replay ran {rms} RMSNorm kernels, "
                             f"the capture recorded {captured}")
    return dict(busy_share=busy / wall_us, step_ms=step_ms, traces=attempt)


def profile_decode(fed, params, serving, steps: int = 8) -> dict:
    """Where a full-width decode step's time goes once it is captured: the
    decode scan's step graph (B = 8 from position 1024, the 1152-slot
    cache) captured over ``steps + 1`` tokens, then profiled
    (:func:`profile_graph`)."""
    B, seq, P = SERVE["batch"], fed.seq_len, SERVE["prompt_len"]
    dtype = params["server"]["lm_head"]["table"].dtype
    logits = torch.zeros((B, 1, fed.model_cfg.padded_vocab), dtype=dtype,
                         device=fed.device)
    st = serving.decode_buffers(
        logits, serving.zero_caches(fed.adapter, B, seq, fed.device), P,
        steps + 1)
    graph = serving.make_decode_scan(
        fed.adapter, fed.n_clients, seq, P, steps + 1, 0.0,
        fed.model_cfg.vocab_size)(params, st)
    return profile_graph(f"decode profile of the captured step (B = {B}, "
                         f"cache {seq})", graph,
                         lambda: st["pos"].fill_(P), steps)


# the SSD library's device kernels: the bf16 route's pre-pass and scan on
# the tensor cores, the f32 route's scan on the CUDA cores
SSD_DEVICE_KERNELS = ("ssd_prep_kernel", "ssd_tc_kernel", "ssd_chunk_kernel")
# kernel families of a prefill profile, by the kernel's name
PREFILL_FAMILIES = (
    ("SSD scan (pre-pass and scan)", r"ssd_(?:prep|tc)_kernel"),
    ("flash attention", r"flash"),
    ("RMSNorm", r"rmsnorm"),
    ("weight products (cuBLAS)", r"gemm|nvjet|sm90_|cutlass|xmma|cublas"),
)


def profile_prefill(fed, params, serving, ssd_ops) -> dict:
    """Where one full-width prefill's device time goes: torch.profiler over
    the serve path's chunked prefill (8 x 1024 tokens in the party spans'
    chunks), after one warm-up prefill; device time by kernel family (the
    SSD scan, flash attention, RMSNorm, the weight products, and the rest:
    f32 elementwise work, casts, copies). Returns the profiled prefill's
    SSD wrapper calls and the device kernels of each SSD kernel the
    profiler saw: the pre-pass and scan of the bf16 route, the f32
    route's kernel. Raises if the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    B, P = SERVE["batch"], SERVE["prompt_len"]
    span = fed.seq_len // SERVE["n_clients"]
    g = torch.Generator("cuda").manual_seed(1)
    prompts = torch.randint(0, fed.model_cfg.vocab_size, (B, P),
                            device="cuda", generator=g).to(torch.int32)
    caches = serving.zero_caches(fed.adapter, B, P + SERVE["gen_len"],
                                 fed.device)

    def run():
        for t0, t1, m in serving.prefill_plan(P, span):
            serving.prefill_chunk(fed.adapter, params, prompts[:, t0:t1],
                                  caches, t0, m)
        torch.cuda.synchronize()
    run()
    calls0 = ssd_ops.launches["ssd_chunk"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(BUSY_START):
            pass
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    calls = ssd_ops.launches["ssd_chunk"] - calls0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    busy_sum = sum(dev_us(e) for e in kernels)
    if not busy_sum:
        raise AssertionError("prefill profile: the profiler saw no CUDA "
                             "kernel time, so the SSD route is not shown")
    busy = busy_union("prefill profile", prof, wall_us, busy_sum)
    split = {name: 0.0 for name, _ in PREFILL_FAMILIES}
    split["the rest (f32 elementwise, casts, copies)"] = 0.0
    for e in kernels:
        fam = next((name for name, pat in PREFILL_FAMILIES
                    if re.search(pat, e.key, re.IGNORECASE)),
                   "the rest (f32 elementwise, casts, copies)")
        split[fam] += dev_us(e)
    log(f"prefill profile, one full-width prefill (B={B}, {P} tokens in "
        f"chunks of {span} and {P - span}) under torch.profiler: wall "
        f"{wall_us:.1f} us, device busy {busy:.1f} us ({busy / wall_us:.2%} "
        f"of wall), {sum(e.count for e in kernels)} kernel launches")
    for name, us in split.items():
        log(f"  {us:11.1f} us  {us / busy_sum:7.2%}  {name}")
    for e in sorted(kernels, key=dev_us, reverse=True)[:12]:
        log(f"  {dev_us(e):11.1f} us  x{e.count:5d}  {e.key[:90]}")
    seen = {name: sum(e.count for e in kernels
                      if re.search(rf"\b{name}\b", e.key))
            for name in SSD_DEVICE_KERNELS}
    log(f"prefill profile: {calls} ssd_chunk wrapper calls, device kernels "
        f"{seen}")
    return {"calls": calls, **seen}


def kernel_sites(cfg):
    """(attention sites, Mamba2 layers, RMSNorm launches of the blocks, of
    the final norm) of one forward pass: dense, MoE and VLM, every layer
    is an attention block; encoder-decoder, a site a layer of the encoder
    and two (self and cross) a layer of the decoder; hybrid, n_layers // attn_every super-blocks of
    attn_every Mamba2 layers and one shared attention block; ssm (RWKV6),
    neither. RMSNorm configs norm ln1 and ln2 of each attention block,
    ln1 of each Mamba2 layer and the final hidden state; a LayerNorm
    config (RWKV6, Whisper) runs no RMSNorm kernel."""
    if cfg.family == "hybrid":
        sites = cfg.n_layers // cfg.attn_every
        mamba = sites * cfg.attn_every
    elif cfg.is_encoder_decoder:
        # each encoder layer's self-attention; each decoder layer's self-
        # and cross-attention
        sites, mamba = cfg.n_encoder_layers + 2 * cfg.n_layers, 0
    elif cfg.family == "ssm":
        sites, mamba = 0, 0
    else:
        sites, mamba = cfg.n_layers, 0
    rms = cfg.norm != "layernorm"
    return sites, mamba, (2 * sites + mamba) * rms, int(rms)


def serve_plan(cfg):
    """What one serve call launches, derived from the config
    (:func:`kernel_sites`). Each prefill chunk runs flash attention once
    per attention site and the SSD scan once per Mamba2 layer; decode
    steps run neither (plain decode attention; the S = 1 state step);
    every forward pass runs each RMSNorm once."""
    sites, mamba, block_norms, final_norm = kernel_sites(cfg)
    n_chunks = 2                    # prompt 1024 over spans of 576
    per_fwd = block_norms + final_norm
    n_fwd = n_chunks + SERVE["gen_len"]    # two prefill chunks + each step
    return dict(sites=sites, mamba=mamba, per_fwd=per_fwd, launches={
        "flash_attention": sites * n_chunks, "rmsnorm": per_fwd * n_fwd,
        "ssd_chunk": mamba * n_chunks})


def call_site(name, i, args, kw, plan):
    """Where call ``i`` of kernel ``name`` sits on a serve path: the
    forward pass (a prefill chunk; for norms, any forward) and the site
    in it."""
    if name == "flash_attention":
        return (f"site {i % plan['sites']}, chunk {i // plan['sites']}, q "
                f"{tuple(args[0].shape)}, q_offset {kw.get('q_offset')}")
    if name == "rmsnorm":
        per_fwd = plan["per_fwd"]
        return (f"forward {i // per_fwd}, norm {i % per_fwd}, x "
                f"{tuple(args[0].shape)}, input max |.| "
                f"{float(args[0].float().abs().max()):.4g}")
    return (f"Mamba2 layer {i % plan['mamba']}, chunk "
            f"{i // plan['mamba']}, x {tuple(args[0].shape)}, chunk length "
            f"{kw['chunk']}")


def serve_phase(rows, arch, zoo_ops, kernels, layers=0, bitwise=False,
                after=None, again=False):
    """Phase 4: the split serve path of ``arch`` at full width and depth
    (``layers`` > 0 cuts the depth: ``configs.cut_depth``), decoding
    through the captured step (``use_scan``, the default). ``kernels``
    maps each serve kernel's name to its (ops, ref) modules. ``bitwise``
    gates the captured decode's final logits on bitwise equality with the
    eager loop's; ``after(fed, params, cfg, eager)`` runs on the session
    of that comparison before it is freed; ``again`` decodes the same
    prompts a second time through the kept graph (:func:`decode_again`)."""
    from repro_torch import graphs
    from repro_torch.configs import cut_depth, get_config
    from repro_torch.federation import Transport, serving
    from repro_torch.launch import serve as serve_mod

    cfg = cut_depth(get_config(arch), layers)
    plan = serve_plan(cfg)
    A, M, per_fwd = plan["sites"], plan["mamba"], plan["per_fwd"]
    # the first and last attention site and Mamba2 layer of both prefill
    # chunks; the first two norms and the last two before the final norm
    # of both prefill chunks and the first decode step
    keep = {"flash_attention": [0, A - 1, A, 2 * A - 1],
            "rmsnorm": [f * per_fwd + j for f in (0, 1, 2)
                        for j in (0, 1, per_fwd - 3, per_fwd - 2)],
            "ssd_chunk": [0, M - 1, M, 2 * M - 1]}
    # a kernel the path never launches (RWKV6 runs none) is not captured
    keep = {name: at for name, at in keep.items()
            if plan["launches"][name]}
    for ops in [zoo_ops] + [ops for ops, _ in kernels.values()]:
        ops.reset_launches()
    graphs.reset_replayed()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as stack:
        caps = {name: stack.enter_context(
                    Capture(kernels[name][0], KERNEL_ENTRIES[name],
                            keep[name]))
                for name in keep}
        t0 = time.perf_counter()
        res = serve_mod.serve(arch, use_reduced=False, temperature=0.0,
                              n_layers=layers, **SERVE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(zoo_ops.launches)
    for ops, _ in kernels.values():
        launches.update(ops.launches)
    want = plan["launches"]
    # the launches through the graph: one capture recorded a decode
    # step's norms (its warm-up, the first token, ran eagerly) and the
    # other gen_len - 1 tokens replayed them
    dg = res["decode_graph"]
    replayed = {k: graphs.replayed[k][k] for k in want}
    want_replayed = {"flash_attention": 0, "ssd_chunk": 0,
                     "rmsnorm": per_fwd * (SERVE["gen_len"] - 1)}
    log(f"serve path: {arch} decode graph: captured in {dg['capture_s']:.4f}"
        f" s, {dg['nodes']} nodes ({dg['kernel_nodes']} kernel nodes), "
        f"{dg['replays']} replays of {dg['launches_a_replay']} launches: "
        f"launches replayed {replayed} (derived {want_replayed}), eager "
        f"{ {k: launches[k] - replayed[k] for k in want} }")
    if replayed != want_replayed or dg["launches_a_replay"] != (
            {"rmsnorm": per_fwd} if per_fwd else {}):
        raise AssertionError(f"serve launches through the graph "
                             f"{replayed}, want {want_replayed}")
    log(f"serve path: {arch} full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}), batch {SERVE['batch']}, prompt "
        f"{SERVE['prompt_len']} + {SERVE['gen_len']} generated, "
        f"{SERVE['n_clients']} client parties (seq_len {res['seq_len']}): "
        f"prefill {res['prefill_s']:.4f} s, decode {res['decode_s']:.4f} s "
        f"= {res['decode_tok_per_s']:.1f} tokens/s, first-use build "
        f"{res['compile_s']:.2f} s, whole call {wall:.2f} s (weights drawn "
        f"on the card included), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; final "
        f"logits max |.| {res['final_logits_absmax']:.4g} (finite); sample "
        f"{res['sample_output']}; launches {launches}, derived {want}")
    if {k: launches[k] for k in want} != want or any(
            launches[k] for k in zoo_ops.launches):
        raise AssertionError(f"serve launches {launches}, want {want} and "
                             "no ZOO kernel")
    # every RMSNorm launch of the serve path took the vector kernel
    rms_routes = dict(kernels["rmsnorm"][0].route_launches)
    log(f"serve path: RMSNorm launches by route {rms_routes}")
    if rms_routes != {"vector": want["rmsnorm"], "general": 0}:
        raise AssertionError(f"serve RMSNorm routes {rms_routes}, want all "
                             f"{want['rmsnorm']} on the vector kernel")
    rows["rmsnorm"].setdefault("route_launches_by_path", {})[arch] = \
        rms_routes
    B, d = SERVE["batch"], cfg.d_model
    steps = SERVE["prompt_len"] + SERVE["gen_len"]
    formula = steps * B * d * 4 + SERVE["gen_len"] * B * 4
    ledger = Transport().account_serve(batch=B, embed=d, n_steps=steps,
                                       n_gen=SERVE["gen_len"]).total_bytes
    log(f"serve wire: {res['wire_bytes']} B; formula {steps} steps x "
        f"{B} x {d} f32 up + {SERVE['gen_len']} x {B} int32 down = "
        f"{formula} B; Transport.account_serve {ledger} B; gradients on "
        f"the wire: {res['wire_has_gradients']}")
    if not res["wire_bytes"] == formula == ledger:
        raise AssertionError("serve wire bytes differ from the formula")

    # the kernels against their plain versions on the serve path's own
    # inputs (launches here come after the counts were read)
    serve_err = {}
    for name, cap in caps.items():
        if len(cap.inputs) != len(keep[name]):
            raise AssertionError(f"the serve run missed a captured {name} "
                                 "call")
        serve_err[name] = hold_calls(
            name, *kernels[name], cap.inputs,
            lambda i, args, kw: call_site(name, i, args, kw, plan),
            "serve")
    for name in kernels:
        if want[name]:
            rows[name]["launches"] += launches[name]
            rows[name].setdefault("launches_by_path", {})[arch] = \
                launches[name]
            rows[name].setdefault("serve_max_abs_err", {})[arch] = \
                serve_err[name]
    del caps

    fed, params = serve_mod.build_session(
        cfg, n_clients=SERVE["n_clients"], prompt_len=SERVE["prompt_len"],
        gen_len=SERVE["gen_len"], seed=0)
    fed_params = fed.params_from_global(params)
    if cfg.family == "hybrid":
        for trace in range(1, 4):
            seen = profile_prefill(fed, fed_params, serving,
                                   kernels["ssd_chunk"][0])
            # fewer device kernels than launches: the trace lost records
            # (see profile_graph); take it again
            if min(seen[k] for k in SSD_DEVICE_KERNELS[:2]) >= seen["calls"]:
                break
            log(f"prefill profile: trace {trace} of 3 lost SSD kernel "
                "records; traced again")
        # one prefill runs the SSD scan once per Mamba2 layer and chunk, as
        # the serve run did; every call takes the tensor cores: one
        # pre-pass and one scan kernel, and never the f32 route's kernel
        if not (seen["calls"] == want["ssd_chunk"]
                == seen["ssd_tc_kernel"] == seen["ssd_prep_kernel"]
                and seen["ssd_chunk_kernel"] == 0):
            raise AssertionError(f"the prefill's SSD calls ran {seen}, want "
                                 f"{want['ssd_chunk']} calls, each one "
                                 "pre-pass and one tensor-core scan")
        rows["ssd_chunk"]["device_kernels_per_call"] = (
            sum(seen[k] for k in SSD_DEVICE_KERNELS) / seen["calls"])
    eager = scan_vs_eager(fed, fed_params, cfg, bitwise, again)
    profile_decode(fed, fed_params, serving)
    if after is not None:
        after(fed, fed_params, cfg, eager)
    del fed, params, fed_params, eager
    gc.collect()
    torch.cuda.empty_cache()


def scan_vs_eager(fed, params, cfg, bitwise=False, again=False):
    """The serve traffic's prompts decoded eagerly (``use_scan=False``)
    and through the captured step (the default) on one session: the
    greedy tokens must be equal, and the final logits within 2 bf16 steps
    at their largest |.| (bitwise expected: the same kernels in the same
    order; with ``bitwise``, required); logs both decodes' tokens/s and
    peak memory. Returns the eager decode's result."""
    from repro_torch.launch import serve as serve_mod
    B, P, G = SERVE["batch"], SERVE["prompt_len"], SERVE["gen_len"]
    toks = serve_mod._prompts(cfg, B, P, 0, fed.device)
    out = {}
    for use_scan in (False, True):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated() / 2**30
        r = fed.decode(params, toks, gen_len=G, use_scan=use_scan)
        gc.collect()
        out[use_scan] = (r, before, torch.cuda.max_memory_allocated() / 2**30,
                         torch.cuda.memory_allocated() / 2**30)
    (eager, e0, epk, _), (scan, s0, spk, s1) = out[False], out[True]
    diff = float((eager.logits.float() - scan.logits.float()).abs().max())
    gate = 2 * bf16_ulp(float(eager.logits.float().abs().max()))
    log(f"decode, {cfg.arch_id}: eager loop {B * G / eager.decode_s:.1f} "
        f"tokens/s ({eager.decode_s:.4f} s), peak {epk:.3f} GiB from "
        f"{e0:.3f}; captured step {B * G / scan.decode_s:.1f} tokens/s "
        f"({scan.decode_s:.4f} s; capture {scan.graph.capture_s:.4f} s in "
        f"compile_s {scan.compile_s:.4f} s; {scan.graph.nodes} nodes), peak "
        f"{spk:.3f} GiB from {s0:.3f}; tokens equal: "
        f"{np.array_equal(eager.tokens, scan.tokens)}; final logits max "
        f"|diff| {diff:.5g} (bitwise: {torch.equal(eager.logits, scan.logits)}"
        f"; gate {gate:.5g})")
    if not np.array_equal(eager.tokens, scan.tokens) or not diff <= gate \
            or (bitwise and not torch.equal(eager.logits, scan.logits)):
        raise AssertionError(f"{cfg.arch_id}: the captured decode differs "
                             "from the eager loop")
    if again:
        decode_again(fed, params, cfg, toks, scan, s1 - s0)
    return eager


def decode_again(fed, params, cfg, toks, first, held):
    """Phase 4: a second ``Federation.decode`` of the same prompts, length
    and params tree on the session replays the kept decode graph
    (``graphs.Kept``, the counterpart of the JAX package's cached
    compiled scan): it captures nothing (``kept``, the same graph, all
    gen_len tokens replayed, ``compile_s`` 0.0) and its tokens and final
    logits are bitwise the first call's. ``held``: the GiB the first
    call left allocated, what the session's kept key holds (its KV
    caches, buffers and the graph pool's live blocks) while the params
    tree lives."""
    G = SERVE["gen_len"]
    before = first.graph.replays
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fed.decode(params, toks, gen_len=G)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    same = (np.array_equal(first.tokens, r.tokens)
            and torch.equal(first.logits, r.logits))
    log(f"decode, {cfg.arch_id}, a second call of the same shapes and "
        f"params: whole call {wall:.4f} s, prefill {r.prefill_s:.4f} s, "
        f"decode {r.decode_s:.4f} s ({SERVE['batch'] * G / r.decode_s:.1f} "
        f"tokens/s), compile_s {r.compile_s} against the first call's "
        f"prefill {first.prefill_s:.4f} s, decode {first.decode_s:.4f} s, "
        f"compile_s {first.compile_s:.4f} s (its capture "
        f"{first.graph.capture_s:.4f} s); kept {r.kept}, the same graph "
        f"{r.graph is first.graph}, replays {before} -> {r.graph.replays}; "
        f"tokens and final logits bitwise the first call's: {same}; the "
        f"kept key holds {held:.3f} GiB allocated (its caches, buffers "
        f"and graph pool's live blocks; {len(fed._kept_decodes)} key(s))")
    if not (r.kept and r.graph is first.graph and r.compile_s == 0.0
            and r.graph.replays == before + G and same):
        raise AssertionError(f"{cfg.arch_id}: the second decode captured "
                             "or differs from the first")


def profile_rounds(fed, params, x_parts, y) -> dict:
    """Where a main-path round's time goes once it is captured:
    torch.profiler over a run, read in the window of its replays alone
    (from ``graphs.REPLAYS_START``, lasting the replays' synchronised host
    seconds): the device's busy share there, its device events a round
    and the top kernels. Raises if the profiler saw no device time."""
    from repro_torch import graphs
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = fed.run(params, x_parts, y)
    rg = res.round_graph
    n, wall_us = rg["replays"], rg["replay_s"] * 1e6
    events = device_events(prof)
    if not events:
        raise AssertionError("profile: the profiler saw no device event in "
                             "the round replays")
    spans = [(e.time_range.start, e.time_range.end) for e in events]
    lo, hi = busy_window(prof, spans, wall_us, after=graphs.REPLAYS_START)
    inside = [e for e in events
              if e.time_range.start >= lo and e.time_range.end <= hi]
    sum_us = sum(e.time_range.elapsed_us() for e in inside)
    busy = busy_union("profile of main-path round replays", prof, wall_us,
                      sum_us, after=graphs.REPLAYS_START)
    log(f"profile, {n} replays of the captured main-path round under "
        f"torch.profiler: wall {wall_us / n:.1f} us a round, device busy "
        f"{busy / n:.1f} us a round ({busy / wall_us:.2%} of wall), "
        f"{len(inside) / n:.1f} device events a round ({rg['kernel_nodes']} "
        f"kernel nodes in the graph)")
    by_name: dict = {}
    for e in inside:
        c, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (c + 1, us + e.time_range.elapsed_us())
    for key, (c, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        log(f"  {us / n:8.2f} us/round  x{c / n:5.2f}  {key[:90]}")
    return dict(busy_share=busy / wall_us, round_us=wall_us / n,
                device_events_a_round=len(inside) / n)


class CpuDrawsOn:
    """A draw source on the CPU (the engine's ``TorchDraws``, the training
    step's ``StepDraws``) handed to a run on another device, so a card run
    and a CPU run consume the same random numbers."""

    def __init__(self, cpu_source, device):
        self.cpu, self.device = cpu_source, device

    def __getattr__(self, name):
        from repro_torch.tree import tree_map
        fn = getattr(self.cpu, name)

        def moved(*args):
            return tree_map(lambda t: t.to(self.device), fn(*args))
        return moved


def report_rates(rows) -> None:
    """Each kernel's achieved rate (the operations its bound counts, over
    its measured time) and the share of its bound it reaches, written into
    its row."""
    entries = [(row["name"], row) for row in rows.values()]
    entries.append(("flash_attention at d=80",
                    rows["flash_attention"]["at_d80"]))
    entries.append(("flash_attention at (192, 128), DeepSeek-V3's chunk",
                    rows["flash_attention"]["at_mla_192_128"]))
    for name, row in entries:
        row["tflops"] = row["ops"] / row["ms"] / 1e9
        row["bound_share"] = row["bound_ms"] / row["ms"]
        lib = row["library_ms"]
        log(f"rate {name}: {row['ms']:.5f} ms, {row['tflops']:.3f} TFLOP/s "
            f"achieved, {row['bound_share']:.2%} of its bound "
            f"({row['bound_ms']:.6f} ms, {row['bound_by']}); library "
            f"{'none' if lib is None else f'{lib:.5f} ms'}")


# ------------------------------------------------------ phase 5: training --

# the training shapes: 8 sequences of 128 tokens (the CLI's defaults), q = 1
TRAIN = dict(batch=8, seq=128)
TRAIN_STEPS, TRAIN_WARMUP = 20, 3
# per-kernel gradients: repro's f32 tolerance; bf16 at the forward's bf16
# tolerance (PERF.md §2). The wrapper's backward is autograd through the
# plain version on the saved inputs, so its gradient equals the plain
# one's by construction: the check holds the wiring (a grad_fn, the
# Function entered); the forward is held at FLASH_TOL, RMS_TOL and, for
# the SSD's f32 y and state, SSD_TOL[f32] scaled by ssd_tol
GRAD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: SERVE_TOL}
# one step on the card against the CPU (reduced phi3, f32): normal
# directions at μ = 0.1, so ĥ − h (about 1e-2) stands far above the lane
# losses' f32 rounding on either device, which the estimator divides by μ
STEP_VFL = dict(mu=0.1, zoo_dist="normal", lr_server=0.01, lr_client=0.01)
STEP_TOL = 1e-4
# device kernels of a training step, by family: the library's profiler
# ranges around the plain backward, the SGD update and the direction draws
# first, then the kernel's name
TRAIN_FAMILIES = (
    ("forward kernels (flash, RMSNorm, SSD)", r"flash|rmsnorm|ssd_"),
    ("cuBLAS products", r"gemm|nvjet|sm90_|cutlass|xmma|cublas"),
)


def train_plan(cfg, q: int = 1, steps: int = 1) -> dict:
    """Kernel launches of ``steps`` cascaded training steps, derived from
    the config: each step runs the clean lane's forward (with grad) and
    the q perturbed lanes' forwards (no grad, one pass each), and with
    ``cfg.remat`` the backward recomputes every checkpointed block (each
    attention block; each hybrid super-block of attn_every Mamba2 layers
    and the shared attention block) once; the final norm lies outside
    the checkpointed blocks. A forward runs flash attention once per
    attention site, the SSD scan once per Mamba2 layer, and RMSNorm at ln1
    and ln2 of each attention block, ln1 of each Mamba2 layer and the
    final norm. The global loss of a config with an MTP head (DeepSeek-V3)
    runs one more attention block (flash; ln1 and ln2) and the MTP norm a
    forward, outside remat."""
    sites, mamba, block_norms, final_norm = kernel_sites(cfg)
    fwd, remat = 1 + q, int(cfg.remat)
    mtp = int(bool(cfg.n_mtp))
    launches = {"flash_attention": steps * (sites * (fwd + remat)
                                            + mtp * fwd),
                "rmsnorm": steps * ((block_norms + final_norm + 3 * mtp)
                                    * fwd + block_norms * remat),
                "ssd_chunk": steps * mamba * (fwd + remat)}
    why = (f"{steps} steps x [{fwd} forwards (clean + {q} perturbed) + "
           f"{remat} remat recompute] x ({sites} attention sites -> flash; "
           f"{mamba} Mamba2 layers -> SSD; {block_norms} block norms, + "
           f"{final_norm} final norm a forward not recomputed -> RMSNorm)"
           + (f" + {fwd} forwards x the MTP head (1 flash; ln1, ln2 and "
              "its norm -> 3 RMSNorm), not recomputed" if mtp else ""))
    return dict(launches=launches, why=why)


class StepRecorder:
    """Wraps ``Federation.sync_step`` (at the script's level, for one
    ``with``) so every step a driver takes is recorded: a copy of its
    StepOutput (a replayed step's outputs are the graph's, overwritten by
    the next replay), and the host clock after a synchronise (the driver
    reads the loss right after, so the synchronise adds no wait). The
    recorder wraps the step the driver calls, graphed or not, so its
    synchronise never runs under a capture. ``profile_at`` runs that step
    (0-based) under torch.profiler; ``within`` maps a step (0-based) to a
    context it runs inside (a dispatch mode that records it).
    ``graph=False`` makes every step of the driver eager (the comparison
    runs). ``keep_steps`` keeps the steps built in ``steps`` (a
    compiled step's graphs, alive while the recorder is).
    ``Federation.save`` is timed too."""

    def __init__(self, profile_at=None, graph=None, within=None,
                 keep_steps=False):
        from repro_torch.federation import session
        self.session = session
        self.profile_at, self.graph = profile_at, graph
        self.within, self.keep_steps = within or {}, keep_steps
        self.outputs, self.ends, self.saves, self.steps = [], [], [], []
        self.profile = None

    def __enter__(self):
        Fed = self.session.Federation
        self.inner_step, self.inner_save = Fed.sync_step, Fed.save
        rec = self

        def sync_step(fed, optimizer, **kw):
            if rec.graph is not None:
                kw["graph"] = rec.graph
            step = rec.inner_step(fed, optimizer, **kw)
            if rec.keep_steps:
                rec.steps.append(step)

            def recorded(*args):
                i = len(rec.outputs)
                if i == rec.profile_at:
                    out, rec.profile = profile_train_step(step, args)
                elif i in rec.within:
                    with rec.within[i]:
                        out = step(*args)
                else:
                    out = step(*args)
                rec.outputs.append(type(out[2])(*(
                    getattr(out[2], f.name).detach().clone()
                    for f in dataclasses.fields(out[2]))))
                torch.cuda.synchronize()
                rec.ends.append(time.perf_counter())
                return out
            if hasattr(step, "stats"):       # the compiled step's readings
                recorded.stats = step.stats
            return recorded

        def save(fed, path, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = rec.inner_save(fed, path, *args, **kw)
            rec.saves.append(time.perf_counter() - t0)
            return out

        Fed.sync_step, Fed.save = sync_step, save
        return self

    def __exit__(self, *exc):
        Fed = self.session.Federation
        Fed.sync_step, Fed.save = self.inner_step, self.inner_save

    @property
    def losses(self):
        # a placed run's loss is a DTensor: its full value
        return [float(getattr(o.loss, "full_tensor", lambda: o.loss)())
                for o in self.outputs]

    @property
    def perturbed(self):
        """Each step's perturbed lane losses (ĥ), as floats."""
        return [getattr(o.loss_perturbed, "full_tensor",
                        lambda o=o: o.loss_perturbed)().float().tolist()
                for o in self.outputs]


def host_copy(tree):
    """A tree's leaves copied to the host."""
    from repro_torch.tree import tree_map
    return tree_map(lambda x: x.detach().cpu(), tree)


def same_on_host(tree, host) -> bool:
    """Every leaf of ``tree`` bitwise equal to ``host``'s (one leaf at a
    time on the host)."""
    from repro_torch.tree import tree_leaves
    return all(torch.equal(a.detach().cpu(), b)
               for a, b in zip(tree_leaves(tree), tree_leaves(host)))


PROFILE_WARMUP = "profiler warm-up"


def profile_train_step(step, args):
    """One training step under torch.profiler: its wall, the device's busy
    time, and the device time by family — each kernel goes to the first
    range it was launched under (the library's own ranges: plain
    backward, SGD update, direction draws), else to its name's family
    (the forward kernels, also when remat recomputes them in the
    backward; cuBLAS), else to the rest."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiler_warmup()
        t0 = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return out, dict(split_profile(prof, wall_us), t0=t0,
                     t1=t0 + wall_us * 1e-6)


def profiler_warmup() -> None:
    """The trace can miss a region's first launches (on an H100 it has
    dropped a step's first five, its direction draws): throwaway launches
    go first, in a range the split leaves out."""
    from torch.profiler import record_function
    with record_function(PROFILE_WARMUP):
        x = torch.zeros(1, device="cuda")
        for _ in range(32):
            x.add_(1)
        torch.cuda.synchronize()


def _train_family(name: str) -> str:
    return next((fam for fam, pat in TRAIN_FAMILIES
                 if re.search(pat, name, re.IGNORECASE)),
                "the rest (elementwise, softmax, casts, copies)")


def split_profile(prof, wall_us) -> dict:
    """A profile's device time by family (see ``profile_train_step``),
    the busy time, the kernels and the host's top events. The op walk
    finds the kernels that hang under a PyTorch op; the hand-written
    kernels launch through ``ctypes`` and hang under none, so after it
    every device event in the timed window that the walk did not count
    (matched by name and duration) goes to its name's family. The summed
    split is then never less than the busy union: it raises if it is."""
    from collections import Counter
    from torch.autograd import DeviceType
    ranges = ("plain backward", "SGD update", "direction draws",
              PROFILE_WARMUP)
    split, by_name, n_kernels = {}, {}, 0
    counted = Counter()
    launching = [e for e in prof.events() if getattr(e, "kernels", None)]
    # count each kernel once: at the innermost event that lists it
    outer = set()
    for e in launching:
        node = e.cpu_parent
        while node is not None:
            outer.add(id(node))
            node = node.cpu_parent
    for e in launching:
        if id(e) in outer:
            continue
        fam, node = None, e
        while node is not None and fam is None:
            if node.name.startswith(ranges):
                fam = node.name
            node = node.cpu_parent
        if fam == PROFILE_WARMUP:
            continue
        for k in e.kernels:
            f = fam or _train_family(k.name)
            split[f] = split.get(f, 0.0) + k.duration
            by_name[k.name] = by_name.get(k.name, 0.0) + k.duration
            counted[(k.name, round(k.duration, 3))] += 1
            n_kernels += 1
    # the device events no op lists (the ctypes launches), in the window
    walked, unlisted = n_kernels, 0
    events = device_events(prof)
    if events:
        lo, hi = busy_window(prof, [(e.time_range.start, e.time_range.end)
                                    for e in events], wall_us,
                             PROFILE_WARMUP)
        for e in events:
            if e.time_range.end <= lo or e.time_range.start >= hi:
                continue
            dur = e.time_range.end - e.time_range.start
            key = (e.name, round(dur, 3))
            if counted[key]:
                counted[key] -= 1
                continue
            f = _train_family(e.name)
            split[f] = split.get(f, 0.0) + dur
            by_name[e.name] = by_name.get(e.name, 0.0) + dur
            n_kernels += 1
            unlisted += 1
    busy = busy_union("profile", prof, wall_us, sum(split.values()),
                      after=PROFILE_WARMUP)
    log(f"profile split: {walked} kernels under PyTorch ops, {unlisted} "
        f"device events under none (ctypes launches, copies) added by "
        f"name; summed {sum(split.values()):.1f} us against the union "
        f"{busy:.1f} us")
    if sum(split.values()) + 1e-3 < busy:
        raise AssertionError(f"the split ({sum(split.values()):.1f} us) "
                             f"misses device time of the union "
                             f"({busy:.1f} us)")
    # where the host's time goes: CPU events by their own (self) time,
    # summed by name from the parsed events (``key_averages`` would parse
    # the trace a second time)
    host_time, host_count = {}, Counter()
    rms_fn, launch_api, gc_in = [], [], []
    for e in prof.events():
        if e.device_type == DeviceType.CPU:
            host_time[e.key] = host_time.get(e.key, 0.0) + \
                e.self_cpu_time_total
            host_count[e.key] += 1
            if e.key == "RMSNormFn":
                rms_fn.append((e.time_range.start, e.time_range.end,
                               e.self_cpu_time_total))
            elif e.key.startswith(GC_RANGE):
                parent = e.cpu_parent
                gc_in.append((e.key, e.time_range.end - e.time_range.start,
                              parent.key if parent is not None else None))
            elif "LaunchKernel" in e.key or "Command Buffer Full" in e.key:
                launch_api.append((e.time_range.start, e.time_range.end,
                                   e.key))
    host = sorted(((k, v, host_count[k]) for k, v in host_time.items()),
                  key=lambda kv: -kv[1])[:12]
    # the launch calls the host made: graph launches and kernel launches
    api = {k: sum(n for name, n in host_count.items() if name.startswith(k))
           for k in ("cudaGraphLaunch", "cudaLaunchKernel")}
    return dict(wall_us=wall_us, busy_us=busy,
                busy_sum_us=sum(split.values()), split=split,
                by_name=by_name, kernels=n_kernels, host=host,
                rms_fn=rms_fn, launch_api=launch_api, gc=gc_in, api=api)


def log_profile(what, prof) -> None:
    busy, busy_sum = prof["busy_us"], prof["busy_sum_us"]
    if busy:
        log(f"{what} under torch.profiler: wall {prof['wall_us']:.1f} us, "
            f"device busy {busy:.1f} us ({busy / prof['wall_us']:.2%} of "
            f"wall; the union of the device intervals), "
            f"{prof['kernels']} device kernels; by family (shares of their "
            f"summed durations, {busy_sum:.1f} us):")
        for name, us in sorted(prof["split"].items(), key=lambda kv: -kv[1]):
            log(f"  {us:11.1f} us  {us / busy_sum:7.2%}  {name}")
        for name, us in sorted(prof["by_name"].items(),
                               key=lambda kv: -kv[1])[:10]:
            log(f"  {us:11.1f} us  {name[:90]}")
    else:
        log(f"{what}: the profiler saw no CUDA kernel time; the split is "
            "not measured")
    log(f"{what}: host events by self CPU time (the profiler's own cost "
        f"included)")
    for name, us, count in prof["host"]:
        log(f"  {us:11.1f} us  x{count:6d}  {name[:80]}")


def train_kernel_cases(cfg):
    """(flash cases, RMSNorm cases) at ``cfg``'s training shapes (TRAIN's
    batch x seq): flash (dtype, query heads, KV heads, head dim, window,
    v head dim) in f32 and bf16, causal, at the config's window (MLA: its
    n_heads of (nope + rope, v) head dims after the latent's expansion);
    RMSNorm (rows, d, dtype, route) at d_model on the vector route."""
    M = TRAIN["batch"] * TRAIN["seq"]
    if cfg.use_mla:
        heads = (cfg.n_heads, cfg.n_heads,
                 cfg.qk_nope_dim + cfg.qk_rope_dim)
        dv = cfg.v_head_dim
    else:
        heads = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)
        dv = cfg.resolved_head_dim
    flash = tuple((dtype, *heads, cfg.window_size, dv)
                  for dtype in (torch.float32, torch.bfloat16))
    rms = tuple((M, cfg.d_model, dtype, "vector")
                for dtype in (torch.bfloat16, torch.float32))
    return flash, rms


# phase 5's: flash at Phi-3's d = 96 and Zamba2's 80, causal and window
# 64, 32 heads; RMSNorm on the vector route at both d_models and on the
# general one (d = 100)
TRAIN_FLASH_CASES = tuple((dtype, 32, 32, d, window)
                          for dtype in (torch.float32, torch.bfloat16)
                          for d in (96, 80) for window in (0, 64))
TRAIN_RMS_CASES = tuple((TRAIN["batch"] * TRAIN["seq"], d, dtype, route)
                        for d, dtype, route in (
                            (3072, torch.bfloat16, "vector"),
                            (2560, torch.bfloat16, "vector"),
                            (3072, torch.float32, "vector"),
                            (100, torch.bfloat16, "general")))


def check_kernel_grads(rows, flash_ops, flash_ref, rms_ops, rms_ref,
                       ssd_ops=None, ssd_ref=None,
                       flash_cases=TRAIN_FLASH_CASES,
                       rms_cases=TRAIN_RMS_CASES) -> None:
    """Each differentiable kernel at the training shapes: the wrapper's
    output carries a grad_fn, and its gradients (torch.autograd.grad of
    a fixed random weighting of the output) equal autograd through the
    plain version on the same inputs (equal by construction: the
    backward is that autograd, so this holds the wiring), and its forward
    output (the kernel's) equals the plain version's at the forward's
    tolerance. Flash attention at ``flash_cases`` (dtype, query heads,
    KV heads, head dim, window; causal), RMSNorm at ``rms_cases`` (rows,
    d, dtype, route), and where ``ssd_ops`` is given the SSD scan in f32
    and bf16 at the hybrid training shape."""
    g = torch.Generator("cuda").manual_seed(11)
    B, S = TRAIN["batch"], TRAIN["seq"]

    def rnd(*shape, dtype=torch.float32, scale=1.0):
        return (scale * torch.randn(*shape, generator=g, device="cuda")
                ).to(dtype)

    counts = {"flash_attention": flash_ops, "rmsnorm": rms_ops,
              "ssd_chunk": ssd_ops}

    def check(name, what, call, plain, operands, dtype, fwd_tol, route=None):
        leaves = [t.detach().requires_grad_(True) for t in operands]
        before = dict(rms_ops.route_launches)
        launched = counts[name].launches[name]
        outs = call(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        out = outs[0]
        if any(o.grad_fn is None for o in outs):
            raise AssertionError(f"{name} ({what}): the wrapper's output "
                                 "has no grad_fn")
        if counts[name].launches[name] != launched + 1:
            raise AssertionError(f"{name} ({what}): the forward did not "
                                 "launch the kernel once")
        if route is not None and rms_ops.route_launches[route] \
                == before[route]:
            raise AssertionError(f"{name} ({what}) did not take the "
                                 f"{route} route")
        w = rnd(*out.shape)
        got = torch.autograd.grad((out.float() * w).sum(), leaves)
        ref_leaves = [t.detach().requires_grad_(True) for t in operands]
        ref_outs = plain(*ref_leaves)
        ref_outs = ref_outs if isinstance(ref_outs, tuple) else (ref_outs,)
        want = torch.autograd.grad((ref_outs[0].float() * w).sum(),
                                   ref_leaves)
        torch.cuda.synchronize()
        fwd = [_err_ok(o.detach(), r.detach(), fwd_tol(r))
               for o, r in zip(outs, ref_outs)]
        fwd_err = max(e for e, _ in fwd)
        fwd_ok = all(o for _, o in fwd)
        log(f"forward {name} ({what}), the wrapper with grad on: "
            f"max_abs_err {fwd_err:.3e} over {len(outs)} outputs, max |out| "
            f"{max(float(r.float().abs().max()) for r in ref_outs):.4g} (tol "
            f"{[fwd_tol(r) for r in ref_outs]}) {'ok' if fwd_ok else 'FAIL'}")
        if not fwd_ok:
            raise AssertionError(f"{name} ({what}): the kernel's forward "
                                 "differs from the plain version")
        checks = [_err_ok(a, b, GRAD_TOL[dtype]) for a, b in zip(got, want)]
        err = max(e for e, _ in checks)
        ok = all(o for _, o in checks)
        log(f"grad {name} ({what}): max_abs_err {err:.3e} over "
            f"{len(leaves)} operand gradients, max |grad| "
            f"{max(float(b.float().abs().max()) for b in want):.4g} (tol "
            f"{GRAD_TOL[dtype]}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} ({what}): the gradient differs "
                                 "from autograd through the plain version")
        row = rows[name]
        row["grad_max_abs_err"] = max(row.get("grad_max_abs_err", 0.0), err)
        row["train_fwd_max_abs_err"] = max(
            row.get("train_fwd_max_abs_err", 0.0), fwd_err)

    for case in flash_cases:
        dtype, hq, hkv, d, window = case[:5]
        dv = case[5] if len(case) > 5 else d     # v's head dim (MLA's own)
        kw = dict(causal=True, window=window)
        check("flash_attention",
              f"{dtype}, q ({B}, {S}, {hq}, {d}), k ({B}, {S}, {hkv}, {d}), "
              f"v ({B}, {S}, {hkv}, {dv}), causal, window {window}",
              lambda q, k, v, kw=kw: flash_ops.flash_attention_bshd(
                  q, k, v, **kw),
              lambda q, k, v, kw=kw:
                  flash_ref.flash_attention_bshd_ref(q, k, v, **kw),
              [rnd(B, S, hq, d, dtype=dtype), rnd(B, S, hkv, d, dtype=dtype),
               rnd(B, S, hkv, dv, dtype=dtype)],
              dtype, lambda _, t=FLASH_TOL[dtype]: t)
    for M, d, dtype, route in rms_cases:
        check("rmsnorm", f"{dtype}, x ({M}, {d}), {route} route",
              lambda x, s: rms_ops.rmsnorm(x, s),
              lambda x, s: rms_ref.rmsnorm_ref(x, s),
              [rnd(M, d, dtype=dtype, scale=3.0), 1.0 + 0.1 * rnd(d)],
              dtype, lambda _, t=RMS_TOL[dtype]: t, route)
    if ssd_ops is None:
        return
    H, P, N, chunk = 80, 64, 64, 128
    for dtype in (torch.float32, torch.bfloat16):
        xh = rnd(B, S, H, P, dtype=dtype)
        dt = torch.nn.functional.softplus(rnd(B, S, H) - 1.0)
        a = torch.exp(-dt * 0.5)
        check("ssd_chunk", f"{dtype}, x ({B}, {S}, {H}, {P}), state {N}, "
              f"chunk {chunk}",
              lambda *t: ssd_ops.ssd_chunk_bshp(*t, chunk=chunk),
              lambda *t: ssd_ref.ssd_chunked_ref(*t, chunk),
              [xh, a, dt, rnd(B, S, N, dtype=dtype),
               rnd(B, S, N, dtype=dtype)], dtype,
              lambda want: ssd_tol(want, SSD_TOL[torch.float32]))


def step_card_vs_cpu(counters, arch="phi3-mini-3.8b",
                     methods=("cascaded", "vafl", "zoo-vfl"),
                     cfg_kw=None) -> None:
    """One step of the cascaded, first-order (vafl) and full-ZOO (zoo-vfl)
    factories (``methods``) on ``arch`` reduced, in f32 (flash attention
    on the CUDA cores, the RMSNorm vector kernel, where the family runs
    them), on the card and on the CPU from the same
    params, batch and draws: losses and gradient norms agree at 1e-4
    relative; every updated leaf at 1e-4 of max(its largest |entry|, 1);
    each beyond twice the CPU f32 value's own error against the same step
    from f64 params (nothing for a well-conditioned step; reduced
    Whisper's random-init LayerNorms cancel a residual stream many times
    their output, where that error reaches 1e-4 of a norm and 9e-2 of a
    leaf's step); and every leaf's step (new − old) entrywise, so an
    entrywise-wrong
    gradient that keeps its norm cannot pass. The step's gate is the one
    tests/test_torch_train_step.py holds the port's step to repro's with
    (1e-4 of the CPU step's largest entry in the leaf, plus one f32
    rounding of its largest param) plus twice the f32 step's own error
    in that leaf: the largest gap between the CPU's f32 step and the same
    step from f64 params (the card and the CPU are each an f32 evaluation
    that far from the more precise one). At this batch the embedding's
    step is 1e-4 to 1e-3 of its largest entry from the f64 one, below
    which no two f32 evaluations are bound to agree."""
    from repro_torch.configs import VFLConfig, get_config, reduced
    from repro_torch.core import cascade
    from repro_torch.core.draws import StepDraws
    from repro_torch.data import lm_token_batches
    from repro_torch.models import common
    from repro_torch.models.model_api import build_model
    from repro_torch.optim import sgd
    from repro_torch.tree import tree_leaves, tree_map
    cfg = reduced(get_config(arch), param_dtype="float32", **(cfg_kw or {}))
    model = build_model(cfg, max_seq=TRAIN["seq"])
    cpu = common.materialize(model.param_specs,
                             torch.Generator().manual_seed(0))
    card = tree_map(lambda t: t.to("cuda"), cpu)
    cpu64 = tree_map(lambda t: t.double(), cpu)
    nb = next(lm_token_batches(1, cfg.vocab_size, TRAIN["batch"],
                               TRAIN["seq"]))
    batches = {dev: {k: torch.from_numpy(v).to(dev) for k, v in nb.items()}
               for dev in ("cpu", "cuda")}
    if cfg.frontend_dim:
        # seeded N(0, 1) frames or patch embeddings, the same on both
        extra = modal_inputs(cfg, TRAIN["batch"],
                             torch.Generator().manual_seed(13), device="cpu")
        for dev, b in batches.items():
            b.update({k: v.to(dev) for k, v in extra.items()})
    for method in methods:
        outs = {}
        for dev, params in (("card", card), ("cpu", cpu), ("f64", cpu64)):
            step = cascade.make_step_for_method(
                method, model.loss_fn, model.client_keys,
                VFLConfig(**STEP_VFL), sgd(0.01), vocab=cfg.padded_vocab)
            for c in counters:
                c.reset_launches()
            where = "cuda" if dev == "card" else "cpu"
            new, _, out = step(params, sgd(0.01).init(params),
                               batches[where], 0,
                               CpuDrawsOn(StepDraws(0, "cpu"), where))
            outs[dev] = (new, out)
            if dev == "card":
                torch.cuda.synchronize()
                ran = _launches(counters)
        (g_new, g_out), (c_new, c_out) = outs["card"], outs["cpu"]
        (r_new, r_out) = outs["f64"]
        worst, own_fields = 0.0, 0.0
        for field in ("loss", "loss_perturbed", "grad_client_norm",
                      "grad_server_norm"):
            a, b = float(getattr(g_out, field)), float(getattr(c_out, field))
            r = float(getattr(r_out, field))
            rel = abs(a - b) / max(abs(b), 1e-12)
            # the CPU f32 field's own error against the step from f64
            # params, as each leaf's step below is allowed twice its own
            own = abs(b - r) / max(abs(r), 1e-12)
            worst, own_fields = max(worst, rel), max(own_fields, own)
            if not rel <= STEP_TOL + 2 * own:
                raise AssertionError(f"{method} step {field}: card {a} vs "
                                     f"CPU {b} (f64 params: {r})")
        # beyond twice the CPU f32 leaf's own error against f64 params
        leaf_err = max(float(((x.cpu() - y).abs().max()
                              - 2 * (r - y.double()).abs().max())
                             / max(float(y.abs().max()), 1.0))
                       for x, y, r in zip(tree_leaves(g_new),
                                          tree_leaves(c_new),
                                          tree_leaves(r_new)))
        step_err, worst_leaf, f32_err = 0.0, None, 0.0
        for x, y, r, p in zip(tree_leaves(g_new), tree_leaves(c_new),
                              tree_leaves(r_new), tree_leaves(cpu)):
            want = (y - p).double()
            gap = float(((x.cpu() - p).double() - want).abs().max())
            own = float(((r - p.double()) - want).abs().max())
            ulp = float(np.spacing(np.float32(p.abs().max())))
            big = max(float(want.abs().max()), 1e-30)
            # the gap beyond the f32 error allowance, over the step
            rel = (gap - ulp - 2 * own) / big
            f32_err = max(f32_err, (own - ulp) / big)
            if worst_leaf is None or rel > step_err:
                step_err, worst_leaf = rel, tuple(p.shape)
        log(f"step on the card vs the CPU, {method}, reduced {arch} f32, "
            f"batch {TRAIN['batch']} x {TRAIN['seq']}: loss "
            f"{float(g_out.loss):.6f} vs {float(c_out.loss):.6f}, "
            f"perturbed {float(g_out.loss_perturbed):.6f}, |g_c| "
            f"{float(g_out.grad_client_norm):.6g} vs "
            f"{float(c_out.grad_client_norm):.6g}, |g_s| "
            f"{float(g_out.grad_server_norm):.6g} vs "
            f"{float(c_out.grad_server_norm):.6g}; worst relative gap "
            f"{worst:.3e} (tol {STEP_TOL} + twice the CPU f32 field's own "
            f"error against f64 params, up to {own_fields:.3e}), updated "
            f"leaves' worst gap {leaf_err:.3e} (tol "
            f"{STEP_TOL}); steps' worst gap beyond one rounding and twice "
            f"the f32 step's own error {step_err:.3e} of the leaf's largest "
            f"step entry (leaf {worst_leaf}; tol {STEP_TOL}; the CPU f32 "
            f"step's error against f64 params, beyond one rounding, up to "
            f"{f32_err:.3e} of it); "
            f"card launches {ran}")
        if not (leaf_err <= STEP_TOL and step_err <= STEP_TOL):
            raise AssertionError(f"{method} step: updated leaves differ by "
                                 f"{leaf_err}, their steps by {step_err} of "
                                 "the largest step entry")
        want = train_plan(cfg)["launches"]
        if any(bool(ran[k]) != bool(n) for k, n in want.items()):
            raise AssertionError(f"{method} step on the card launched "
                                 f"{ran}, the family runs {want}")


def train_phase(rows, card, counters) -> None:
    """Phase 5: LM training on the card. Per-kernel gradients, one step
    against the CPU, then ``launch.train.train`` of Phi-3-mini at full
    width and depth (20 cascaded steps, the CLI's defaults), Zamba2-2.7B
    at full width cut to 6 layers (5 steps through
    ``Federation.sync_step(graph=True)``, held bitwise to the same 5
    steps eager), and resume-equivalence at full width with
    2 layers."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm import ref as rms_ref
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops
    from repro_torch.kernels.ssd_chunk import ref as ssd_ref
    check_kernel_grads(rows, flash_ops, flash_ref, rms_ops, rms_ref,
                       ssd_ops, ssd_ref)
    step_card_vs_cpu(counters)
    train_phi3(rows, card, counters)
    train_zamba2(rows, counters)
    train_resume(card)


def _launches(counters):
    return {k: v for c in counters for k, v in c.launches.items()}


class LaunchTimer:
    """Wraps a kernel module's ``launch`` (its ctypes call into the
    library, for one ``with``) and keeps each call's host interval on
    ``time.perf_counter``'s clock."""

    def __init__(self, module):
        self.module, self.calls = module, []

    def __enter__(self):
        self.inner = self.module.launch

        def launch(*args, **kw):
            t0 = time.perf_counter()
            try:
                return self.inner(*args, **kw)
            finally:
                self.calls.append((t0, time.perf_counter()))
        self.module.launch = launch
        return self

    def __exit__(self, *exc):
        self.module.launch = self.inner


GC_RANGE = "python gc, generation"


class GcTimer:
    """Keeps the host interval of every Python garbage collection (by
    ``gc.callbacks``, for one ``with``) with its generation."""

    def __init__(self):
        self.pauses, self._t0 = [], None

    def _callback(self, phase, info):
        from torch.profiler import record_function
        if phase == "start":
            self._t0 = time.perf_counter()
            # a profiler range around the pause, so a profile shows which
            # host event it fell inside (its parent)
            self._range = record_function(f"{GC_RANGE} {info['generation']}")
            self._range.__enter__()
        elif self._t0 is not None:
            self._range.__exit__(None, None, None)
            self.pauses.append((self._t0, time.perf_counter(),
                                info["generation"]))

    def __enter__(self):
        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._callback)


def log_rms_host(what, prof, timer, gct) -> None:
    """Where the host self time of the profiler's ``RMSNormFn`` events
    goes in a profiled eager step: the events' self time, the host time
    of the rmsnorm library's ctypes launch calls made in the step
    (``timer``), the launch API calls and the "Command Buffer Full" waits
    the profiler recorded, inside the RMSNormFn events and in the whole
    step, and the Python garbage collections in the step (``gct``)."""
    fn = prof["rms_fn"]
    if not fn:
        log(f"{what}: the profile holds no RMSNormFn event")
        return
    self_us = sorted(x[2] for x in fn)
    dur = sorted(e - b for b, e, _ in fn)
    calls = sorted((b - a) * 1e6 for a, b in timer.calls
                   if prof["t0"] <= a and b <= prof["t1"])
    api = prof["launch_api"]
    inside = sorted(e - b for b, e, _ in api
                    if any(fb <= b and e <= fe for fb, fe, _ in fn))
    every = sorted(e - b for b, e, _ in api)
    names = sorted({k for _, _, k in api})

    pauses = sorted((b - a) * 1e6 for a, b, _ in gct.pauses
                    if prof["t0"] <= a and b <= prof["t1"])
    gens = sorted({g for a, b, g in gct.pauses
                   if prof["t0"] <= a and b <= prof["t1"]})

    def spread(xs):
        if not xs:
            return "none"
        return (f"{len(xs)} x, sum {sum(xs):.1f} us, median "
                f"{xs[len(xs) // 2]:.1f} us, max {xs[-1]:.1f} us")
    log(f"{what}: RMSNormFn events: self time {spread(self_us)}; whole "
        f"duration {spread(dur)}. The rmsnorm library's ctypes launch "
        f"calls in the step (host clock): {spread(calls)}. Launch API "
        f"calls the profiler recorded ({names}): inside RMSNormFn events "
        f"{spread(inside)}; in the whole step {spread(every)}. Python "
        f"garbage collections in the step (host clock, generations "
        f"{gens}): {spread(pauses)}; in the profile, each over 1 ms with "
        f"the host event it fell inside: "
        f"{[(k, round(d, 1), p) for k, d, p in prof['gc'] if d > 1000]}")


def train_phi3(rows, card, counters) -> None:
    """Phi-3-mini at full width and depth, TRAIN_STEPS cascaded steps
    through ``launch.train.train``: through its captured step (step 0
    eager, then replays), then the same steps eagerly; losses and final
    parameters must be bitwise equal, the launches equal the derivation
    (the replayed share: every step but the first), and each run's last
    step is profiled (the graph's: a replay). The eager run's profile
    says where RMSNormFn's host self time goes (:func:`log_rms_host`)."""
    from repro_torch import graphs
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.launch import train as train_mod
    arch = "phi3-mini-3.8b"
    cfg = train_mod.get_config(arch)
    plan = train_plan(cfg, q=1, steps=TRAIN_STEPS)
    replay_plan = train_plan(cfg, q=1, steps=TRAIN_STEPS - 1)["launches"]
    runs = {}
    for graphed in (False, True):
        with StepRecorder(profile_at=TRAIN_STEPS - 1,
                          graph=None if graphed else False) as rec, \
                LaunchTimer(rms_kernel) as timer, GcTimer() as gct:
            for c in counters:
                c.reset_launches()
            graphs.reset_replayed()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = train_mod.train(arch, use_reduced=False, steps=TRAIN_STEPS,
                                  method="cascaded", log_every=5,
                                  keep_params=True, **TRAIN)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _launches(counters)
        timed = rec.ends[TRAIN_WARMUP - 1:TRAIN_STEPS - 1]
        runs[graphed] = dict(
            res=res, params=res.pop("params"), losses=rec.losses,
            ms=(timed[-1] - timed[0]) * 1e3 / (len(timed) - 1),
            peak=torch.cuda.max_memory_allocated() - held, held=held,
            wall=wall,
            launches=launches, profile=rec.profile, timer=timer, gc=gct,
            replayed={k: v for g, counts in graphs.replayed.items()
                      if g != "rmsnorm_routes" for k, v in counts.items()
                      if v})
        del res
        gc.collect()
        torch.cuda.empty_cache()
    g, e = runs[True], runs[False]
    losses = g["losses"]
    same_losses = losses == e["losses"]
    same_params = _same_trees(g["params"], e["params"])
    stats = g["res"]["step_graph"]
    for name, r in (("captured", g), ("eager", e)):
        log(f"train: {arch} full width and depth ({cfg.n_layers} layers, "
            f"d_model {cfg.d_model}, {cfg.param_count() / 1e9:.3f} B "
            f"params, bf16), cascaded, batch {TRAIN['batch']} x "
            f"{TRAIN['seq']}, SGD lr 0.01, mu 1e-3, q = 1, remat "
            f"{cfg.remat}, {name} step: {TRAIN_STEPS} steps, "
            f"{r['ms']:.3f} ms per step (host clock after a synchronise, "
            f"steps {TRAIN_WARMUP}..{TRAIN_STEPS - 2} after {TRAIN_WARMUP} "
            f"warm-up steps; step {TRAIN_STEPS - 1} profiled) on {card}; "
            f"peak memory {r['peak'] / 2**30:.2f} GiB above the "
            f"{r['held'] / 2**30:.2f} GiB held before the run; whole call "
            f"{r['wall']:.2f} s (weights drawn on the card included)")
    log(f"train graph: {arch}: one step captured after the eager first "
        f"step: capture {stats['capture_s'][0]:.3f} s, "
        f"{stats['nodes'][0]} nodes ({stats['kernel_nodes'][0]} kernel "
        f"nodes), {stats['replays'][0]} replays; launches replayed "
        f"{g['replayed']}, derived {replay_plan} ({TRAIN_STEPS - 1} steps)")
    log(f"train losses (captured): {[round(x, 4) for x in losses]}; the "
        f"eager run's bitwise equal {same_losses}; final parameters "
        f"bitwise equal {same_params}")
    if not (same_losses and same_params):
        raise AssertionError(f"the captured training step differs from the "
                             f"eager one: losses {losses} vs {e['losses']}")
    first, last5 = losses[0], float(np.mean(losses[-5:]))
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"training losses not finite: {losses}")
    if not last5 < first:
        raise AssertionError(f"training loss did not fall: first {first}, "
                             f"mean of the last 5 {last5}")
    for r in (g, e):
        log(f"train launches {r['launches']}, derived {plan['launches']}: "
            f"{plan['why']}")
        if {k: r["launches"][k] for k in plan["launches"]} != \
                plan["launches"] or any(r["launches"][k] for k in
                                        r["launches"]
                                        if k not in plan["launches"]):
            raise AssertionError(f"training launches {r['launches']}, want "
                                 f"{plan['launches']} and no ZOO kernel")
    if g["replayed"] != {k: n for k, n in replay_plan.items() if n} or \
            stats["replays"] != [TRAIN_STEPS - 1]:
        raise AssertionError(f"replayed launches {g['replayed']}, want "
                             f"{replay_plan}")
    check_train_wire(arch, cfg, g["res"], TRAIN_STEPS)
    log_profile(f"train profile, step {TRAIN_STEPS - 1} of {arch} (a "
                f"replay) on {card}", g["profile"])
    log_profile(f"train profile, step {TRAIN_STEPS - 1} of {arch} "
                f"(eager) on {card}", e["profile"])
    log_rms_host(f"train profile, step {TRAIN_STEPS - 1} of {arch} "
                 f"(eager)", e["profile"], e["timer"], e["gc"])
    for name, n in plan["launches"].items():
        if n:
            rows[name]["launches"] += g["launches"][name]
            rows[name].setdefault("launches_by_path", {})[
                f"train:{arch}"] = g["launches"][name]
            rows[name].setdefault("replayed_by_path", {})[
                f"train:{arch}"] = g["replayed"].get(name, 0)
    del runs, g, e
    gc.collect()
    torch.cuda.empty_cache()


def check_train_wire(arch, cfg, res, steps) -> None:
    """A training run's wire bytes a round (``res`` of
    ``launch.train.train``) against the formula and the ledger."""
    from repro_torch.federation import Transport
    B, d = TRAIN["batch"], cfg.d_model
    formula = 2 * (B * d * 4 + B * 4)
    ledger = Transport("cascaded").account(batch=B, embed=d, n_rounds=steps)
    log(f"train wire, {arch}: {res['wire_bytes_per_round']} B a round; "
        f"formula (1 + q) x ({B} x {d} f32 embeddings up + {B} f32 losses "
        f"down) = {formula} B; Transport.account {ledger.total_bytes} B "
        f"over {steps} rounds; gradients on the wire: "
        f"{res['wire_has_gradients']}")
    if not (res["wire_bytes_per_round"] == formula
            == ledger.total_bytes // steps) or res["wire_has_gradients"]:
        raise AssertionError(f"{arch} training wire differs from the "
                             "formula")


def train_zamba2(rows, counters) -> None:
    import dataclasses
    from repro_torch.configs import VFLConfig, get_config
    from repro_torch.core import cascade
    from repro_torch.core.async_engine import EngineConfig
    from repro_torch.core.draws import StepDraws
    from repro_torch.data import BatchIterator, lm_token_batches
    from repro_torch.federation import Federation
    from repro_torch.launch.train import _normalized_lr_client
    from repro_torch.models import common
    from repro_torch.optim import sgd
    arch, steps = "zamba2-2.7b", 5
    cfg = dataclasses.replace(get_config(arch), n_layers=6)
    plan = train_plan(cfg, q=1, steps=steps)
    fed = Federation.build(cfg, VFLConfig(mu=1e-3, lr_server=0.01),
                           EngineConfig(method="cascaded", steps=steps,
                                        batch_size=TRAIN["batch"]),
                           seq_len=TRAIN["seq"])
    fed.vfl = dataclasses.replace(
        fed.vfl, lr_client=_normalized_lr_client(fed, 0.01))

    def run(graph: bool):
        """``steps`` steps from the seed-0 weights over the batches of
        seed 1: (final params, losses, the step, the first batch)."""
        params = common.materialize(
            fed.model.param_specs, torch.Generator(fed.device).manual_seed(0),
            device=fed.device)
        opt = sgd(0.01)
        step, state = fed.sync_step(opt, graph=graph), opt.init(params)
        data = BatchIterator(lm_token_batches(1, cfg.vocab_size,
                                              TRAIN["batch"], TRAIN["seq"]),
                             fed.device)
        draws = StepDraws(0, fed.device)
        batches = [next(data) for _ in range(steps)]
        losses = []
        for t, batch in enumerate(batches):
            params, state, out = step(params, state, batch, t, draws)
            losses.append(float(out.loss))
        return params, losses, step, batches[0]

    for c in counters:
        c.reset_launches()
    params, losses, step, first = run(graph=True)
    launches = _launches(counters)
    stats = step.stats()
    log(f"train: {arch} full width cut to {cfg.n_layers} layers "
        f"({cfg.n_layers // cfg.attn_every} shared-attention site(s)), bf16, "
        f"{steps} cascaded steps through Federation.sync_step(graph=True) "
        f"(the SSD scan's forward under capture): losses "
        f"{[round(x, 4) for x in losses]}; launches {launches}, derived "
        f"{plan['launches']}: {plan['why']}; step graph: capture "
        f"{stats['capture_s'][0]:.3f} s, {stats['nodes'][0]} nodes "
        f"({stats['kernel_nodes'][0]} kernel nodes), {stats['replays'][0]} "
        f"replays")
    if stats["replays"] != [steps - 1]:
        raise AssertionError(f"zamba2's step graph: {stats}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"zamba2 training losses not finite: {losses}")
    if {k: launches[k] for k in plan["launches"]} != plan["launches"]:
        raise AssertionError(f"zamba2 training launches {launches}, want "
                             f"{plan['launches']}")
    # the same steps eagerly, from the same weights, batches and draws
    g_params = host_copy(params)
    del params, step
    gc.collect()
    params, e_losses, _, first = run(graph=False)
    same_losses = losses == e_losses
    same_params = same_on_host(params, g_params)
    log(f"train: {arch} {steps} captured steps against {steps} eager "
        f"steps: eager losses {[round(x, 4) for x in e_losses]}, bitwise "
        f"equal {same_losses}; final parameters bitwise equal {same_params}")
    if not (same_losses and same_params):
        raise AssertionError(f"{arch}: the captured training step differs "
                             f"from the eager one")
    del g_params
    # the server's gradient reaches in_proj of the first Mamba2 layer
    # (through the SSD scan's and the norms' plain backward)
    _, g = cascade._value_and_grad(fed.model.loss_fn, params, first,
                                   ["blocks"])
    w_in = g["blocks"]["ssm"]["w_in"][0, 0].float()
    norm = float(w_in.norm())
    log(f"train: {arch} gradient at in_proj (blocks/ssm/w_in) of the first "
        f"Mamba2 layer: norm {norm:.4g}, finite "
        f"{bool(torch.isfinite(w_in).all())}")
    if not (norm > 0 and bool(torch.isfinite(w_in).all())):
        raise AssertionError("the gradient does not reach the first Mamba2 "
                             "layer's in_proj")
    for name, n in plan["launches"].items():
        rows[name]["launches"] += launches[name]
        rows[name].setdefault("launches_by_path", {})[f"train:{arch}"] = \
            launches[name]
    del params, g
    gc.collect()
    torch.cuda.empty_cache()


def train_resume(card) -> None:
    """Phi-3-mini at full width with 2 layers (bf16): 4 steps saved, resumed
    to 8, against 8 without a break; the losses of every step and the final
    params must be bitwise equal (the step is deterministic on the card:
    no atomics in the kernels, fixed cuBLAS shapes, draws seeded by the
    step), and the saved ledger totals and step clocks equal."""
    import dataclasses
    import json
    import os
    import shutil
    import tempfile
    from repro_torch.checkpoint import load_tree
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_mod
    from repro_torch.tree import tree_leaves
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=build)
    kw = dict(use_reduced=False, method="cascaded", log_every=100, **TRAIN)
    inner_get = train_mod.get_config
    train_mod.get_config = lambda arch: dataclasses.replace(
        inner_get(arch), n_layers=2)
    try:
        with StepRecorder() as rec:
            train_mod.train("phi3-mini-3.8b", steps=4,
                            checkpoint_path=f"{root}/a", **kw)
            train_mod.train(steps=8, resume=f"{root}/a",
                            checkpoint_path=f"{root}/b", log_every=100)
            train_mod.train("phi3-mini-3.8b", steps=8,
                            checkpoint_path=f"{root}/c", **kw)
        losses = rec.losses
        split, straight = losses[:8], losses[8:]
        trees = {}
        for name in ("b", "c"):
            trees[name] = [load_tree(os.path.join(root, name, party))[0]
                           for party in ("server", "clients", "opt_server")]
        same = all(torch.equal(x, y) for tb, tc in zip(trees["b"],
                                                       trees["c"])
                   for x, y in zip(tree_leaves(tb), tree_leaves(tc)))
        manifests = [json.load(open(os.path.join(root, n, "session.json")))
                     for n in ("b", "c")]
        size = sum(f.stat().st_size for f in Path(root, "c").rglob("*")
                   if f.is_file())
        log(f"resume: phi3 full width, 2 layers, bf16: 4 steps saved + "
            f"resumed to 8 {[round(x, 5) for x in split]}; 8 without a "
            f"break {[round(x, 5) for x in straight]}; losses bitwise equal "
            f"{split == straight}; final params and optimizer state "
            f"bitwise equal {same}; ledger counts equal "
            f"{manifests[0]['ledger_counts'] == manifests[1]['ledger_counts']}"
            f"; checkpoint {size / 2**20:.1f} MiB, written in "
            f"{[round(s, 3) for s in rec.saves]} s on {card}")
        if not (split == straight and same
                and manifests[0]["ledger_counts"]
                == manifests[1]["ledger_counts"]
                and manifests[0]["step"] == manifests[1]["step"] == 8):
            raise AssertionError("the resumed run differs from the unbroken "
                                 "one")
    finally:
        train_mod.get_config = inner_get
        shutil.rmtree(root, ignore_errors=True)


# ----------------------------------------- phase 6: continuous serving --

# 16 requests queued before the drain: prompt lengths 1024 ... 256 twice
# over (waves of width 2), generation lengths 128, 96, 64, 32 in turn,
# greedy; 8 slots over a page pool of 8-token pages, 2 client parties,
# seq_len 1152 (the phase-4 window)
CONT_PROMPTS = (1024, 1024, 768, 768, 512, 512, 256, 256) * 2
CONT_GENS = (128, 96, 64, 32)
CONT = dict(max_batch=8, page_size=8)
CONT_GAP_FLOOR = 2e-2   # x the reference's largest |logit|
CONT_ZAMBA_LAYERS = 12  # two shared-attention sites
CONT_PROFILE_STEPS = 8
CONT_STEP_GEN = 32      # requests held to the B = 1 step reference
CONT_SAMPLED_T = 0.8


def cont_traffic(vocab: int, device):
    """[(prompt, gen_len)]: the prompts drawn in one call on the card from
    seed 1, fetched once."""
    g = torch.Generator(device).manual_seed(1)
    toks = torch.randint(0, vocab, (len(CONT_PROMPTS), max(CONT_PROMPTS)),
                         generator=g, device=device).cpu().numpy()
    return [(toks[i, :p].astype(np.int32), CONT_GENS[i % len(CONT_GENS)])
            for i, p in enumerate(CONT_PROMPTS)]


def cont_launch_plan(cfg, srv) -> dict:
    """The launches a drain makes, derived from the config and the
    scheduler's counters: each prefill chunk runs flash attention once an
    attention site and the SSD scan once a Mamba2 layer; every forward
    pass (a prefill chunk, a decode step of all slots, a replayed token)
    runs each norm once."""
    plan = serve_plan(cfg)
    fwd = srv.prefill_chunks + srv.steps + srv.replay_steps
    return {"flash_attention": plan["sites"] * srv.prefill_chunks,
            "rmsnorm": plan["per_fwd"] * fwd,
            "ssd_chunk": plan["mamba"] * srv.prefill_chunks}


def picked_gap(ref, tokens, vocab_size) -> float:
    """At each generated position, the reference's max logit minus its
    logit of the token chosen there; the worst. ``ref`` (G, vocab). The
    sampler clamps its argmax into the unpadded vocabulary, so the last
    id stands for every padded one too (Phi-3 pads 32064 to 32256)."""
    chosen = torch.from_numpy(tokens.astype(np.int64)).to(ref.device)
    last = vocab_size - 1
    picked = torch.where(chosen == last, ref[:, last:].max(-1).values,
                         ref.gather(1, chosen[:, None])[:, 0])
    return float((ref.max(-1).values - picked).max())


def teacher_forced_gap(fed, params, prompt, tokens):
    """Re-run ``prompt`` + ``tokens`` solo at B = 1 through
    ``client_embed`` and ``server_prefill`` over the span plan, keeping
    every position's logits; return (the worst :func:`picked_gap` over
    the generated positions, the reference's largest |logit|). The last
    token's own logits are not read: feeding it keeps every chunk at a
    length whose SSD chunk divisor is at least 32 (P + G - 1 can be
    prime)."""
    from repro_torch.federation import serving
    from repro_torch.tree import tree_map
    P, G = prompt.size, tokens.size
    seq = torch.from_numpy(np.concatenate([prompt, tokens])[None]).to(
        fed.device).long()
    caches = serving.zero_caches(fed.adapter, 1, P + G, fed.device)
    span = fed.seq_len // fed.n_clients
    rows = []
    with torch.no_grad():
        for t0, t1, m in serving.prefill_plan(P + G, span):
            e = fed.adapter.client_embed(
                tree_map(lambda a: a[m], params["clients"]), seq[:, t0:t1])
            lg, caches = fed.adapter.server_prefill(params["server"], e,
                                                    caches, t0)
            rows.append(lg[0, max(P - 1 - t0, 0):].float()
                        if t1 > P - 1 else None)
    ref = torch.cat([r for r in rows if r is not None])[:G]   # (G, vocab)
    return (picked_gap(ref, tokens, fed.model_cfg.vocab_size),
            float(ref.abs().max()))


def step_reference(fed, params, prompt, tokens, batch: int = 1,
                   prefill_batch: int = 0):
    """The solo serve path teacher-forced on ``prompt`` + ``tokens``, the
    row replicated: the prompt's chunked prefill at ``prefill_batch``
    rows (default ``batch``), then one ``fed.serve_step`` a token at
    ``batch`` rows, over a ``seq_len`` cache (the paged extent). Returns
    row 0's logits, (G + 1, vocab) f32: after the prompt, then after each
    token."""
    from repro_torch.federation import paging, serving
    from repro_torch.tree import tree_leaves, tree_unflatten
    P, w = prompt.size, prefill_batch or batch
    seq = torch.from_numpy(np.concatenate([prompt, tokens]).astype(
        np.int32)).to(fed.device)[None]
    caches = serving.zero_caches(fed.adapter, w, fed.seq_len, fed.device)
    step = fed.serve_step()
    out = []
    with torch.no_grad():
        for t0, t1, m in serving.prefill_plan(P, fed.seq_len
                                              // fed.n_clients):
            lg, caches = serving.prefill_chunk(
                fed.adapter, params, seq[:, t0:t1].expand(w, -1).contiguous(),
                caches, t0, m)
        out.append(lg[0, -1].float())
        if w != batch:      # row 0's caches, replicated to ``batch`` rows
            plans = tree_leaves(paging.leaf_plans(
                fed.adapter.cache_specs(1, fed.seq_len)))
            caches = tree_unflatten(caches, [
                torch.cat([leaf.narrow(p.batch_axis, 0, 1)] * batch,
                          dim=p.batch_axis)
                for leaf, p in zip(tree_leaves(caches), plans)])
        seq = seq.expand(batch, -1).contiguous()
        for i in range(tokens.size):
            lg, caches = step(params, seq[:, P + i:P + i + 1], caches, P + i)
            out.append(lg[0, -1].float())
    return torch.stack(out)


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def cont_drain(fed, params, traffic, counters, sentinel=False, **kw):
    """Queue every request, then drain them in one ``run()``; the launch
    counts are set to 0 just before the run and read just after. Returns
    (scheduler, results, launches, readings): the run's wall time, the
    memory allocated before it and its peak, in GiB, and the launches the
    graphs' replays made; with ``sentinel`` the drain runs under the
    analysis plane's sentinels (``sentinel_drain``) and the readings carry
    theirs."""
    from repro_torch import graphs
    srv = fed.serve(params, **CONT, **kw)
    for prompt, gen in traffic:
        srv.submit(prompt, gen)
    for ops in counters:
        ops.reset_launches()
    gc.collect()                # the references' caches, before the peak
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() / 2**30
    graphs.reset_replayed()
    t0 = time.perf_counter()
    if sentinel:
        results, sentinel = sentinel_drain(srv)
    else:
        results, sentinel = srv.run(), None
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return srv, results, _launches(counters), dict(
        wall=wall, before=before, sentinel=sentinel,
        peak=torch.cuda.max_memory_allocated() / 2**30,
        replayed={k: graphs.replayed[k][k] for k in graphs.replayed
                  if k in _launches(counters)})


def check_drain(what, cfg, fed, params, srv, results, traffic, launches,
                run, solo):
    """Hold one drain: statuses, the wire per request, host transfers,
    pages, launches, the teacher-forced gap against the chunked-prefill
    reference (every request) and against the B = 1 step reference (the
    requests of CONT_STEP_GEN tokens: their gaps and final logits); log
    its speed and memory. ``run`` holds :func:`cont_drain`'s readings
    and the bytes of the kernel inputs captured during the drain;
    ``solo`` is :func:`solo_baseline`'s reading."""
    from repro_torch.federation import Transport
    d = cfg.d_model
    if [r.status for r in results] != ["ok"] * len(traffic) or any(
            r.tokens.shape != (g,) for r, (_, g) in zip(results, traffic)):
        raise AssertionError(f"{what}: statuses "
                             f"{[r.status for r in results]}")
    replayed = 0
    for (prompt, gen), r in zip(traffic, results):
        base = Transport().account_serve(
            batch=1, embed=d, n_steps=prompt.size + gen,
            n_gen=gen).total_bytes
        extra, up = r.wire_bytes - base, d * 4
        # a preempted request re-uploads its prompt and its generated
        # tokens at each re-admission (the JAX package's metering)
        n_up, rest = divmod(extra, up)
        if rest or n_up < r.preemptions * prompt.size or (
                not r.preemptions and extra):
            raise AssertionError(f"{what}: request {r.rid} wire "
                                 f"{r.wire_bytes} B, formula {base} B, "
                                 f"{r.preemptions} preemptions")
        replayed += n_up - r.preemptions * prompt.size
    if replayed != srv.replay_steps:
        raise AssertionError(f"{what}: re-prefilled tokens {replayed}, "
                             f"replay steps {srv.replay_steps}")
    waves = len({r.finished_at for r in results})
    want = cont_launch_plan(cfg, srv)
    # through the graphs (use_scan on the card): every block step and
    # replayed token but each capture's warm-up, which ran eagerly,
    # replayed one decode forward's norms
    graphed = (srv.steps + srv.replay_steps - srv.graph_captures
               if srv.use_scan else 0)
    want_replayed = {k: 0 for k in want}
    want_replayed["rmsnorm"] = serve_plan(cfg)["per_fwd"] * graphed
    step_graph, replay_graph = srv._step_graph, srv._replay_graph
    worst_pages = srv.max_batch * srv.pages_per_seq
    gaps = [teacher_forced_gap(fed, params, p, r.tokens)
            for (p, _), r in zip(traffic, results)]
    gap, absmax = max(g for g, _ in gaps), max(a for _, a in gaps)
    gate = max(2 * solo["gap"], CONT_GAP_FLOOR * absmax)
    # the step reference: what the solo path computes at B = 1 along the
    # same tokens. The scheduler's logits may differ from it by 2 x the
    # solo path's own B = 8 against B = 1 reading (at least one bf16 step
    # at the largest |logit|), and its gap by twice that (an argmax can
    # flip only where two logits lie within their summed errors)
    held = [i for i, (_, g) in enumerate(traffic) if g == CONT_STEP_GEN]
    step_gap = step_err = ref_max = 0.0
    t_ref = time.perf_counter()
    for i in held:
        ref = step_reference(fed, params, traffic[i][0], results[i].tokens)
        step_gap = max(step_gap, picked_gap(ref[:-1], results[i].tokens,
                                            cfg.vocab_size))
        got = torch.from_numpy(results[i].logits[0]).to(ref.device)
        step_err = max(step_err, float((got - ref[-1]).abs().max()))
        ref_max = max(ref_max, float(ref.abs().max()))
    # the B = 1 references step eagerly, one token at a time
    ref_ms = ((time.perf_counter() - t_ref) * 1e3
              / (len(held) * (CONT_STEP_GEN + 1)))
    eps = max(solo["delta"], bf16_ulp(ref_max))
    # the replica reference: the scheduler's own shapes without the pages
    # (prefill at the request's wave width, steps at max_batch, the row
    # replicated). Every op is row-independent, so it should compute each
    # row as the scheduler does. Without preemption only: a resumed
    # request's last tenancy (its replay length) is not in its result
    replica = None
    if not srv.preemptions:
        width = {}
        for (p, _), r in zip(traffic, results):
            key = (r.admitted_at, p.size)
            width[key] = width.get(key, 0) + 1
        replica = [0.0, 0.0]
        for i in held:
            r = results[i]
            ref = step_reference(
                fed, params, traffic[i][0], r.tokens, batch=srv.max_batch,
                prefill_batch=width[(r.admitted_at, traffic[i][0].size)])
            got = torch.from_numpy(r.logits[0]).to(ref.device)
            replica = [max(replica[0], picked_gap(ref[:-1], r.tokens,
                                                  cfg.vocab_size)),
                       max(replica[1], float((got - ref[-1]).abs().max()))]
    log(f"{what}: {len(results)} requests, {srv.steps} scheduler steps, "
        f"{srv.generated_tokens} tokens in {srv.last_run_s:.4f} s = "
        f"{srv.generated_tokens / srv.last_run_s:.1f} decode tokens/s "
        f"(prefills included; whole run() {run['wall']:.4f} s), peak "
        f"memory {run['peak']:.2f} GiB from {run['before']:.2f} allocated "
        f"before the run (weights and the pool), the "
        f"{run['captured']:.2f} GiB of kernel inputs captured for the "
        f"checks included; "
        f"{srv.prefill_chunks} prefill chunks, {srv.replay_steps} replayed "
        f"tokens, {srv.preemptions} preemptions; host transfers "
        f"{srv.host_transfers} = {waves} retirement waves + "
        f"{srv.preemptions} evictions; pages peak "
        f"{srv.allocator.peak_in_use} of {srv.allocator.capacity} (worst "
        f"case {worst_pages}); launches {launches}, derived {want}; "
        f"graphs: {srv.graph_captures} captures, {srv.compile_s:.4f} s of "
        f"capture (step graph "
        + ("none" if step_graph is None else f"{step_graph.nodes} nodes, "
           f"{step_graph.replays} replays")
        + ", replay graph "
        + ("none" if replay_graph is None else f"{replay_graph.nodes} nodes"
           f", {replay_graph.replays} replays")
        + f"), launches replayed {run['replayed']} (derived "
        f"{want_replayed}); the B = 1 step reference {ref_ms:.2f} ms a token "
        f"(eager, prefill included); wire "
        f"{sum(r.wire_bytes for r in results)} B, every request at its "
        f"formula; teacher-forced worst gap {gap:.5g} (gate {gate:.5g}: "
        f"2 x the solo decode's {solo['gap']:.5g}, floor {CONT_GAP_FLOOR} "
        f"x max |logit| {absmax:.5g}); against the B = 1 step reference "
        f"on requests {held}: worst gap {step_gap:.5g} (gate "
        f"{4 * eps:.5g}), final logits max |err| {step_err:.5g} (gate "
        f"{2 * eps:.5g}; the solo path's B = 8 vs B = 1 reading "
        f"{solo['delta']:.5g}, a bf16 step at max |logit| {ref_max:.5g} "
        f"{bf16_ulp(ref_max):.5g}); against the replica reference (wave "
        f"width, then B = {srv.max_batch}): "
        + ("not run (requests were preempted)" if replica is None else
           f"worst gap {replica[0]:.5g} (gate {4 * bf16_ulp(ref_max):.5g}), "
           f"final logits max |err| {replica[1]:.5g} (gate "
           f"{2 * bf16_ulp(ref_max):.5g}: 2 bf16 steps)"))
    if srv.host_transfers != waves + srv.preemptions:
        raise AssertionError(f"{what}: host transfers are not one a wave "
                             "and one an eviction")
    if {k: launches[k] for k in want} != want or any(
            v for k, v in launches.items() if k not in want):
        raise AssertionError(f"{what}: launches {launches}, want {want}")
    outside = srv.use_scan and (
        step_graph is None
        or (srv.replay_steps > 0) != (replay_graph is not None))
    if outside or {k: run["replayed"].get(k, 0) for k in want} != \
            want_replayed or any(v for k, v in run["replayed"].items()
                                 if k not in want):
        raise AssertionError(f"{what}: launches replayed {run['replayed']}, "
                             f"want {want_replayed}; the drain ran "
                             "outside its graphs")
    if not gap <= gate:
        raise AssertionError(f"{what}: teacher-forced gap {gap} over "
                             f"{gate}")
    if not (step_gap <= 4 * eps and step_err <= 2 * eps):
        raise AssertionError(f"{what}: against the step reference, gap "
                             f"{step_gap} (gate {4 * eps}), final logits "
                             f"{step_err} (gate {2 * eps})")
    if replica is not None and not (replica[0] <= 4 * bf16_ulp(ref_max)
                                    and replica[1] <= 2 * bf16_ulp(ref_max)):
        raise AssertionError(f"{what}: against the replica reference, gap "
                             f"{replica[0]}, final logits {replica[1]}")
    return dict(launches=want, gap=gap, step_gap=step_gap,
                step_err=step_err, tok_s=srv.generated_tokens
                / srv.last_run_s, peak_pages=srv.allocator.peak_in_use,
                worst_pages=worst_pages)


def eager_drain(what, cfg, fed, params, traffic, counters, srv,
                results) -> None:
    """The drain of ``srv`` (through the graphs) run again with
    ``use_scan=False`` (eager steps): the same schedule, launches and
    tokens, and final logits within 2 bf16 steps at their largest |.|
    (bitwise expected: the same kernels in the same order)."""
    esrv, eres, elaunches, er = cont_drain(fed, params, traffic, counters,
                                           use_scan=False)
    same = all(np.array_equal(a.tokens, b.tokens)
               for a, b in zip(results, eres))
    diff = max(float(np.abs(a.logits - b.logits).max())
               for a, b in zip(results, eres))
    bitwise = all(np.array_equal(a.logits, b.logits)
                  for a, b in zip(results, eres))
    absmax = max(float(np.abs(b.logits).max()) for b in eres)
    gate = 2 * bf16_ulp(absmax)
    log(f"{what} against one eager drain (use_scan=False) of the same "
        f"traffic: eager {esrv.generated_tokens / esrv.last_run_s:.1f} "
        f"decode tokens/s (whole run() {er['wall']:.4f} s, peak "
        f"{er['peak']:.2f} GiB from {er['before']:.2f}), through the graphs "
        f"{srv.generated_tokens / srv.last_run_s:.1f}; {esrv.steps} steps "
        f"({srv.steps}), launches {elaunches}; tokens equal: {same}; final "
        f"logits max |diff| {diff:.5g} (bitwise: {bitwise}; gate "
        f"{gate:.5g})")
    want = cont_launch_plan(cfg, esrv)
    if (not same or not diff <= gate or esrv.steps != srv.steps
            or {k: elaunches[k] for k in want} != want
            or esrv.graph_captures or any(er["replayed"].values())):
        raise AssertionError(f"{what}: the drain through the graphs differs "
                             "from the eager drain")


def solo_baseline(fed, params, traffic) -> dict:
    """The existing solo ``fed.decode`` path under the same checks: its
    worst teacher-forced gap against the chunked-prefill reference on the
    longest and the shortest request, and on the shortest the bf16
    batch-invariance reading: the largest |logit| difference along its
    tokens between the step reference at B = 8 (the row replicated) and
    at B = 1."""
    sizes = [p.size + g for p, g in traffic]
    gap = 0.0
    for i in (sizes.index(max(sizes)), sizes.index(min(sizes))):
        prompt, gen = traffic[i]
        tokens = fed.decode(params, prompt[None], gen_len=gen).tokens[0]
        gap = max(gap, teacher_forced_gap(fed, params, prompt, tokens)[0])
    one = step_reference(fed, params, prompt, tokens)
    eight = step_reference(fed, params, prompt, tokens, batch=8)
    delta = float((eight - one).abs().max())
    log(f"solo baseline: worst gap {gap:.5g} against the prefill "
        f"reference; request {i} ({prompt.size} + {gen}) at B = 8 vs B = 1 "
        f"along its tokens: logits max |diff| {delta:.5g}; its own gap "
        f"under the B = 1 step reference "
        f"{picked_gap(one[:-1], tokens, fed.model_cfg.vocab_size):.5g}")
    return dict(gap=gap, delta=delta)


def sampled_drain(fed, params, traffic) -> None:
    """One drain at temperature CONT_SAMPLED_T: 8 requests of 256 + 32
    tokens (two prompts, seeds 0-7, one wave), on the same session. Logs
    its time, its peak memory and noise table, and the time to draw one
    request's noise rows at the traffic's largest admission (1024 + 128);
    requests that share a prompt must sample different streams."""
    from repro_torch.federation import serving
    reqs = [traffic[6 + i % 2][0] for i in range(8)]
    srv = fed.serve(params, temperature=CONT_SAMPLED_T, **CONT)
    for i, prompt in enumerate(reqs):
        srv.submit(prompt, CONT_STEP_GEN, seed=i)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    results = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    vocab = results[0].logits.shape[-1]
    draws, times = serving.PositionGumbel(0), []
    for _ in range(5):
        t1 = time.perf_counter()
        draws.rows(1024, 128, vocab, fed.device)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    streams = [r.tokens.tobytes() for r in results]
    log(f"sampled drain (temperature {CONT_SAMPLED_T}): 8 x (256 + "
        f"{CONT_STEP_GEN}) tokens in {srv.last_run_s:.4f} s = "
        f"{srv.generated_tokens / srv.last_run_s:.1f} decode tokens/s "
        f"(whole run() {wall:.4f} s), peak memory {peak:.2f} GiB ({before:.2f}"
        f" GiB allocated before the run: weights and the pool), noise "
        f"table {srv.max_batch} x {CONT_STEP_GEN} x {vocab} f32 = "
        f"{srv.max_batch * CONT_STEP_GEN * vocab * 4 / 2**20:.2f} MiB; one "
        f"request's 128 noise rows drawn in {min(times):.3f} ms (best of "
        f"5; {128 * vocab * 4 / 2**20:.2f} MiB)")
    if [r.status for r in results] != ["ok"] * 8 or any(
            r.tokens.shape != (CONT_STEP_GEN,) or r.tokens.min() < 0
            or r.tokens.max() >= fed.model_cfg.vocab_size for r in results):
        raise AssertionError("sampled drain: a request failed or sampled "
                             "outside the vocabulary")
    if len(set(streams)) != len(streams):
        raise AssertionError("sampled drain: two seeds drew one stream")


# the mixed sampled drain: 16 requests of 256-token prompts whose
# generation lengths rise through the drain (the first 8, admitted first,
# generate at most 64 tokens; later admissions up to 128), so the noise
# table grows while the block graph exists
CONT_MIXED_GENS = (32, 48, 64, 32, 48, 64, 32, 48,
                   128, 96, 128, 64, 112, 32, 80, 128)


def mixed_sampled_drain(fed, params, traffic) -> None:
    """A sampled drain (temperature CONT_SAMPLED_T) of mixed generation
    lengths through the scheduler's CUDA graphs, against one eager drain
    (``use_scan=False``) of the same traffic and seeds: the tokens of
    every request equal. The noise table grows when a longer generation
    is admitted, and the block graph, captured on the old table, is
    captured again: the graph drain must capture more than once."""
    prompts = [traffic[6 + i % 2][0] for i in range(len(CONT_MIXED_GENS))]
    out = {}
    for use_scan in (True, False):
        srv = fed.serve(params, temperature=CONT_SAMPLED_T,
                        use_scan=use_scan, **CONT)
        for i, (prompt, gen) in enumerate(zip(prompts, CONT_MIXED_GENS)):
            srv.submit(prompt, gen, seed=100 + i)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        results = srv.run()
        torch.cuda.synchronize()
        out[use_scan] = (srv, results, time.perf_counter() - t0,
                         torch.cuda.max_memory_allocated() / 2**30)
    (gsrv, gres, gwall, gpeak), (esrv, eres, ewall, epeak) = \
        out[True], out[False]
    table = tuple(gsrv._noise_st.shape)
    same = len(gres) == len(eres) == len(prompts) and all(
        a.rid == b.rid and np.array_equal(a.tokens, b.tokens)
        for a, b in zip(gres, eres))
    log(f"mixed sampled drain (temperature {CONT_SAMPLED_T}, {len(prompts)} "
        f"x 256-token prompts, generations {list(CONT_MIXED_GENS)}, seeds "
        f"100..{99 + len(prompts)}): through the graphs "
        f"{gsrv.generated_tokens / gsrv.last_run_s:.1f} decode tokens/s "
        f"(whole run() {gwall:.3f} s, peak {gpeak:.2f} GiB), "
        f"{gsrv.graph_captures} graph captures ({gsrv.compile_s:.3f} s), "
        f"noise table {table} f32 = "
        f"{np.prod(table) * 4 / 2**20:.2f} MiB at the end; eager "
        f"{esrv.generated_tokens / esrv.last_run_s:.1f} decode tokens/s "
        f"(whole run() {ewall:.3f} s, peak {epeak:.2f} GiB); "
        f"{gsrv.steps} steps ({esrv.steps} eager); tokens equal: {same}")
    if not same or [r.status for r in gres] != ["ok"] * len(prompts):
        raise AssertionError("mixed sampled drain: the graph drain's tokens "
                             "differ from the eager drain's")
    if not (gsrv.graph_captures >= 2 and esrv.graph_captures == 0
            and table[1] == max(CONT_MIXED_GENS)):
        raise AssertionError(f"mixed sampled drain: {gsrv.graph_captures} "
                             f"captures, table {table}: the re-capture "
                             "after the table grew was not exercised")


# the paged gather's device kernel (``flat[gather_rows]``: PyTorch's
# vectorized index gather), one for K and one for V a layer a step
PAGED_GATHER_KERNEL = r"vectorized_gather_kernel"


def profile_block(fed, params, cfg, traffic) -> dict:
    """One K-step block of 8 busy slots under torch.profiler (8 steps):
    launches a step, the device's busy share, and the paged gather's
    device time a step (K and V of every attention layer)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    srv = fed.serve(params, **CONT)
    for prompt, _ in traffic[6:8] * 4:            # 8 x (256 + 64)
        srv.submit(prompt, 4 * CONT_PROFILE_STEPS)
    srv.run(max_steps=CONT_PROFILE_STEPS)         # admission + a block
    torch.cuda.synchronize()
    # the device's activity only: the host's op events of a block (three
    # or more a launch) made the trace's processing take half a minute
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        srv.run(max_steps=CONT_PROFILE_STEPS)     # one block, no admission
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    srv.run()
    steps = CONT_PROFILE_STEPS

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_sum = sum(dev_us(e) for e in kernels)
    busy = busy_union("continuous profile", prof, wall_us, busy_sum)
    gather = [e for e in kernels if re.search(PAGED_GATHER_KERNEL, e.key)]
    out = dict(wall_us=wall_us / steps, busy_us=busy / steps,
               launches=sum(e.count for e in kernels) / steps,
               gather_us=(sum(dev_us(e) for e in gather) / steps
                          if gather else None),
               gathers=sum(e.count for e in gather) / steps)
    if not busy:
        log("continuous profile: the profiler saw no CUDA kernel time; "
            "device busy share not measured")
        return out
    log(f"continuous profile, one {steps}-step block of 8 busy slots "
        f"(cache extent {fed.seq_len}, {srv.n_pages} pages) under "
        f"torch.profiler: wall {out['wall_us']:.1f} us a step, device busy "
        f"{out['busy_us']:.1f} us a step ({busy / wall_us:.2%} of wall), "
        f"{out['launches']:.1f} kernel launches a step; the paged gather "
        + (f"{out['gather_us']:.1f} us a step ({out['gathers']:.1f} "
           f"gathers a step for {2 * serve_plan(cfg)['sites']} K and V "
           f"reads, {out['gather_us'] / (busy_sum / steps):.2%} of device "
           f"time)" if gather else "not found: not measured"))
    for e in sorted(kernels, key=dev_us, reverse=True)[:10]:
        log(f"  {dev_us(e) / steps:9.2f} us/step  x{e.count / steps:6.2f}"
            f"  {e.key[:90]}")
    return out


def cont_captures(stack, kernels, plan):
    """GroupCaptures on the serve kernels a drain of ``plan``'s model
    launches: the first and last attention site and Mamba2 layer of each
    new prefill chunk signature (shape, offset, wave width), and the first
    two norms and the last two before the final norm of each new forward
    signature (prefill chunks, batched decode steps, replayed tokens)."""
    groups = {"flash_attention": (plan["sites"], (0, plan["sites"] - 1)),
              "rmsnorm": (plan["per_fwd"], (0, 1, plan["per_fwd"] - 3,
                                            plan["per_fwd"] - 2)),
              "ssd_chunk": (plan["mamba"], (0, plan["mamba"] - 1))}
    return {name: stack.enter_context(GroupCapture(
                kernels[name][0], KERNEL_ENTRIES[name], *groups[name]))
            for name in kernels if groups[name][0]}


CONT_ARCHS = (("phi3-mini-3.8b", None), ("zamba2-2.7b", CONT_ZAMBA_LAYERS))


def continuous_phase(rows, card, counters, kernels, archs=CONT_ARCHS,
                     label="continuous phase", sentinel=False):
    """Phase 6: continuous split serving through ``Federation.serve`` at
    full width: Phi-3-mini at full depth with the worst-case pool (run A)
    and with half of it plus preemption (run B), and Zamba2-2.7B cut to
    12 layers (run A). Each drain holds the kernels against their plain
    versions on its own captured inputs. ``kernels`` maps each serve
    kernel's name to its (ops, ref) modules. ``archs`` lists (arch, layers
    or None for full depth); a cut model runs run A only. With
    ``sentinel`` the first model's run A drains under the analysis plane's
    sentinels (phase 11 (b)); their readings are returned."""
    from repro_torch.configs import cut_depth, get_config
    from repro_torch.launch import serve as serve_mod
    t_phase = time.perf_counter()
    spent = {}
    found = None

    def lap(name, t0):
        spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
        return time.perf_counter()

    for arch, layers in archs:
        t0 = time.perf_counter()
        cfg = cut_depth(get_config(arch), layers or 0)
        plan = serve_plan(cfg)
        fed, gp = serve_mod.build_session(
            cfg, n_clients=SERVE["n_clients"],
            prompt_len=SERVE["prompt_len"], gen_len=SERVE["gen_len"],
            seed=0)
        params = fed.params_from_global(gp)
        del gp
        traffic = cont_traffic(cfg.vocab_size, fed.device)
        torch.cuda.synchronize()
        t0 = lap(f"{arch} weights and traffic", t0)
        base = solo_baseline(fed, params, traffic)
        t0 = lap(f"{arch} solo baseline (2 decodes, 2 prefill and 2 step "
                 "references)", t0)
        runs = [("A", {})]
        if layers is None:
            runs.append(("B", dict(n_pages=CONT["max_batch"]
                                   * (fed.seq_len // CONT["page_size"])
                                   // 2 + 2, preempt=True)))
        for run, kw in runs:
            # its speed is not the plain continuous rate: the sentinels
            # patch torch.Tensor's host reads for the whole drain
            guarded = sentinel and found is None and run == "A"
            what = (f"continuous {arch} ({cfg.n_layers} layers) run {run}"
                    + (f", {kw['n_pages']} pages, preempt" if kw else
                       ", worst-case pool")
                    + (", under the analysis sentinels" if guarded else ""))
            with contextlib.ExitStack() as stack:
                caps = cont_captures(stack, kernels, plan)
                srv, results, launches, readings = cont_drain(
                    fed, params, traffic, counters, sentinel=guarded, **kw)
            if readings["sentinel"] is not None:
                found = readings["sentinel"]
            readings["captured"] = sum(
                t.numel() * t.element_size() for cap in caps.values()
                for args, kwargs in cap.inputs.values()
                for t in list(args) + list(kwargs.values())
                if isinstance(t, torch.Tensor)) / 2**30
            t0 = lap(f"{arch} run {run} drain", t0)
            got = check_drain(what, cfg, fed, params, srv, results, traffic,
                              launches, readings, base)
            t0 = lap(f"{arch} run {run} checks (16 prefill and "
                     f"{len([g for _, g in traffic if g == CONT_STEP_GEN])} "
                     "step references)", t0)
            if run == "A" and not got["peak_pages"] < got["worst_pages"]:
                raise AssertionError(f"{what}: the pool peaked at its worst "
                                     "case")
            if run == "B" and not srv.preemptions:
                raise AssertionError(f"{what}: no preemption happened")
            if run == "B":
                # after the drain: the prefill buffer's contents are spent
                profile_graph(f"{what}: replayed tokens through the "
                              "captured B = 1 step", srv._replay_graph,
                              lambda: srv._replay_st["pos"].fill_(
                                  SERVE["prompt_len"]))
                t0 = lap(f"{arch} run B replay profile", t0)
            if run == "A" and layers is None:
                eager_drain(what, cfg, fed, params, traffic, counters, srv,
                            results)
                t0 = lap(f"{arch} run A eager drain", t0)
            path = f"continuous {arch} run {run}"
            for name, cap in caps.items():
                n_sigs = len(cap.seen)
                if len(cap.inputs) != n_sigs * len(cap.positions):
                    raise AssertionError(f"{what}: a captured {name} group "
                                         "was cut short")
                log(f"{what}: {name} holds {len(cap.inputs)} captured calls "
                    f"of {cap.calls}, {n_sigs} call signatures")
                rows[name].setdefault("serve_max_abs_err", {})[path] = \
                    hold_calls(name, *kernels[name], cap.inputs,
                               lambda i, args, kw, name=name: call_site(
                                   name, i, args, kw, plan), path)
            t0 = lap(f"{arch} run {run} kernels on its tensors", t0)
            for name, n in got["launches"].items():
                if n:
                    rows[name]["launches"] += n
                    rows[name].setdefault("launches_by_path", {})[path] = n
            del srv, results, caps
        if layers is None:
            profile_block(fed, params, cfg, traffic)
            t0 = lap(f"{arch} block profile", t0)
            sampled_drain(fed, params, traffic)
            t0 = lap(f"{arch} sampled drain", t0)
            mixed_sampled_drain(fed, params, traffic)
            t0 = lap(f"{arch} mixed sampled drain and its eager drain", t0)
        del fed, params
        torch.cuda.empty_cache()
    log(f"{label} time: " + "; ".join(
        f"{name} {sec:.1f} s" for name, sec in spent.items()))
    log(f"{label}: {time.perf_counter() - t_phase:.1f} s on {card}")
    return found


# ---------------------------------- phase 7: population training ------

# the population CLI's defaults (launch/train.py --engine population): 4
# client parties over 128 rows, batch 8 x 32 tokens (span 8), q = 1,
# cascaded, block 1, lr 0.01, mu 1e-3; 12 rounds (the CLI's 40 cut to
# keep the phase under its 60 s: the falling-loss gate still holds)
POP = dict(steps=12, batch=8, seq=32, n_clients=4, rows=128,
           zoo_queries=1, lr=0.01, mu=1e-3)
POP_WARMUP = 3          # rounds before the timed ones
POP_PROFILE_ROUND = 9   # the round cycle under torch.profiler
# the bitwise and fault checks: Phi-3 full width cut to 2 layers, 10 rounds
POP_SMALL = dict(layers=2, rounds=10, until=5)
POP_FAULTS = dict(seed=7, drop=0.2, latency_ms=5.0, jitter_ms=3.0,
                  max_retries=1)
POP_ADMISSION = dict(admission_ms=8.0, staleness_bound=4)
POP_WORKER = "--pop-worker"   # argv[1] of the socket worker process


def pop_plan(cfg, q: int, rounds: int, admitted: int) -> dict:
    """Kernel launches of ``rounds`` population rounds with ``admitted``
    client activations admitted in all: each round's server update runs
    one forward with grad (and with ``cfg.remat`` the backward recomputes
    every block once; the final norm lies outside), and each admitted
    client's loss downlink runs 1 + q forwards without grad. A forward
    runs flash attention once a layer and RMSNorm at ln1 and ln2 of each
    layer and the final norm."""
    L, remat = cfg.n_layers, int(cfg.remat)
    fwd = rounds + admitted * (1 + q)
    launches = {"flash_attention": L * (fwd + rounds * remat),
                "rmsnorm": (2 * L + 1) * fwd + 2 * L * rounds * remat,
                "ssd_chunk": 0}
    why = (f"[{rounds} server-update forwards + {admitted} admitted x "
           f"{1 + q} lane forwards] x ({L} flash, {2 * L + 1} RMSNorm) + "
           f"{rounds} x {remat} remat recompute x ({L} flash, {2 * L} "
           f"RMSNorm)")
    return dict(launches=launches, why=why)


class RoundRecorder:
    """Wraps the population engine's server update (at the script's
    level, for one ``with``) to record the host clock at each round's
    server update after a synchronise — the loop reads each round's
    losses on the host anyway — and to run one round cycle (round
    ``profile_round``'s server update to the next round's) under
    torch.profiler. It wraps the functions the engine calls, graphed or
    not, so its synchronise never runs under a capture. It keeps each
    round's server loss h, the run's server tree (updated in place every
    round) and each call's key (``graphs.signature`` of its arguments):
    the admitted block's length sets the server update's; the loss
    downlink's client and row are device indices, so its calls share
    one. ``graph=False`` makes the engine run both functions, and each
    loopback worker its uplink and update, eagerly (the comparison
    runs)."""

    def __init__(self, profile_round=None, graph=True):
        from repro_torch import graphs
        from repro_torch.core import async_engine
        self.engine, self.profile_round = async_engine, profile_round
        self.graph, self.signature = graph, graphs.signature
        self.starts, self.profile, self._prof = [], None, None
        self.h, self.server = [], None
        self.update_keys, self.loss_keys = set(), set()
        self.lengths, self.downlinks = set(), 0
        # for each graph captured, the server updates recorded before it
        self.captured_in = []

    def __enter__(self):
        from repro_torch import graphs
        from repro_torch.wire import worker
        self.inner = self.engine._population_fns
        self.worker, self.worker_fns = worker, worker._worker_fns
        self.graphs, self.step_graph = graphs, graphs.StepGraph
        rec = self
        if not self.graph:
            worker._worker_fns = lambda up, upd, device, graph: \
                rec.worker_fns(up, upd, device, False)

        class Counted(graphs.StepGraph):
            """A capture, its round recorded (the rounds so far)."""
            def __init__(self, *a, **k):
                rec.captured_in.append(len(rec.starts))
                super().__init__(*a, **k)
        graphs.StepGraph = Counted

        def fns(*args, graph=True):
            server_update, losses_fn = rec.inner(*args,
                                                 graph=graph and rec.graph)

            def recorded(*a):
                torch.cuda.synchronize()
                now = time.perf_counter()
                n = len(rec.starts)
                rec.starts.append(now)
                if n == rec.profile_round:
                    from torch.profiler import ProfilerActivity, profile
                    rec._prof = profile(activities=[ProfilerActivity.CPU,
                                                    ProfilerActivity.CUDA])
                    rec._prof.__enter__()
                    profiler_warmup()
                    rec._t0 = time.perf_counter()
                elif rec._prof is not None and rec.profile is None:
                    rec.stop(now)
                rec.update_keys.add(rec.signature(a[:-2]))
                rec.lengths.add(a[3].shape[0])
                server, h = server_update(*a)
                rec.server = server
                rec.h.append(h.clone())
                return server, h

            def downlink(*a):
                rec.loss_keys.add(rec.signature(a[:-2]))
                rec.downlinks += 1
                return losses_fn(*a)
            if hasattr(server_update, "stats"):   # the graphs' readings
                recorded.stats = server_update.stats
                downlink.stats = losses_fn.stats
            return recorded, downlink

        self.engine._population_fns = fns
        return self

    def stop(self, now=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wall_us = ((now or t0) - self._t0) * 1e6
        self._prof.__exit__(None, None, None)
        self.profile = split_profile(self._prof, wall_us)
        self.profile_s = time.perf_counter() - t0

    def __exit__(self, *exc):
        self.engine._population_fns = self.inner
        self.worker._worker_fns = self.worker_fns
        self.graphs.StepGraph = self.step_graph

    def capture_free(self, lo: int, hi: int) -> list:
        """The rounds in lo..hi - 1 (each from its server update to the
        next) in which no graph was captured."""
        return [k for k in range(lo, hi) if k not in
                {n - 1 for n in self.captured_in}]


class FrameMeter:
    """Sums the sizes of the data-plane frames (``emb`` up, ``loss``
    down) every loopback endpoint sends, measured from the bytes the
    backend queues — independent of the engine's ledger."""

    def __init__(self):
        from repro_torch.wire import backend, codec
        self.backend, self.codec = backend, codec
        self.bytes = self.frames = 0

    def __enter__(self):
        be = self.backend.LoopbackBackend
        self.inner = be.send
        meter = self

        def send(endpoint, msg):
            n = meter.inner(endpoint, msg)
            if msg.tag in meter.codec.DATA_TAGS:
                meter.bytes += n
                meter.frames += 1
            return n
        be.send = send
        return self

    def __exit__(self, *exc):
        self.backend.LoopbackBackend.send = self.inner


class DetachedCapture(Capture):
    """A Capture keeping detached copies (the server update's inputs carry
    autograd history)."""

    def store(self, args, kw):
        self.inputs[self.calls] = (
            [a.detach().clone() if isinstance(a, torch.Tensor) else a
             for a in args],
            {k: v.detach().clone() if isinstance(v, torch.Tensor) else v
             for k, v in kw.items()})


def pop_keeps(cfg, q: int) -> dict:
    """Round 0's calls to hold: the first and last layer of the server
    update's forward, and of its first and last loss-downlink lane."""
    L, remat = cfg.n_layers, int(cfg.remat)
    f0 = L * (1 + remat)                   # the first lane's first call
    r0 = (2 * L + 1) + 2 * L * remat
    return {"flash_attention": {0: "server update, layer 0",
                                L - 1: f"server update, layer {L - 1}",
                                f0: "loss lane 0, layer 0",
                                f0 + (1 + q) * L - 1:
                                    f"loss lane {q}, layer {L - 1}"},
            "rmsnorm": {0: "server update, layer 0 ln1",
                        2 * L: "server update, final norm",
                        r0: "loss lane 0, layer 0 ln1",
                        r0 + (1 + q) * (2 * L + 1) - 1:
                            f"loss lane {q}, final norm"}}


def population_phase(rows, card, counters, kernels) -> None:
    """Phase 7: asynchronous LM training over the wire plane —
    ``launch.train.train_population`` of Phi-3-mini at full width and
    depth, the bitwise and fault checks at full width cut to 2 layers
    (with worker processes on the card behind sockets), and one round on
    reduced phi3 in f32 against the CPU. (a) runs 12 rounds where the
    CLI's default is 40 (PR 26's phase took 63.6–76.4 s against its
    60 s, (a) 29–35 s of it), and the socket worker's exit is read after
    (c), so its teardown overlaps (c); every check is kept, and (a), (b),
    (c) and (d) log their seconds apart."""
    t_phase = time.perf_counter()
    pop_full(rows, card, counters, kernels)
    t0 = time.perf_counter()
    log(f"population phase (a): {t0 - t_phase:.1f} s")
    spent = pop_small(counters)
    t1 = time.perf_counter()
    b = sum(v for k, v in spent.items() if not k.startswith(("faults",
                                                             "kill")))
    log(f"population phase (b): {b:.1f} s; (c): "
        f"{t1 - t0 - b:.1f} s; (b, c): {t1 - t0:.1f} s")
    pop_card_vs_cpu()
    log(f"population phase (d): {time.perf_counter() - t1:.1f} s")
    log(f"population phase: {time.perf_counter() - t_phase:.1f} s on {card}")


def pop_full(rows, card, counters, kernels) -> None:
    """(a) 12 rounds of Phi-3-mini at full width and depth through
    ``train_population`` at the CLI's defaults but its horizon (40 rounds
    cut to 12 to keep phase 7 under its 60 s; a finite, falling loss
    still gates it)."""
    from repro_torch.launch import train as train_mod
    arch = "phi3-mini-3.8b"
    cfg = train_mod.get_config(arch)
    q, T = POP["zoo_queries"], POP["steps"]
    keeps = pop_keeps(cfg, q)
    flash_ops, rms_ops = kernels["flash_attention"][0], \
        kernels["rmsnorm"][0]
    with contextlib.ExitStack() as stack:
        caps = {"flash_attention": stack.enter_context(DetachedCapture(
                    flash_ops, KERNEL_ENTRIES["flash_attention"],
                    keeps["flash_attention"])),
                "rmsnorm": stack.enter_context(DetachedCapture(
                    rms_ops, KERNEL_ENTRIES["rmsnorm"], keeps["rmsnorm"]))}
        rec = stack.enter_context(RoundRecorder(POP_PROFILE_ROUND))
        meter = stack.enter_context(FrameMeter())
        for c in counters:
            c.reset_launches()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = train_mod.train_population(
            arch, use_reduced=False, steps=T, batch=POP["batch"],
            seq=POP["seq"], n_clients=POP["n_clients"], rows=POP["rows"],
            zoo_queries=q, lr=POP["lr"], mu=POP["mu"], seed=0)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        wall = t_end - t0
        launches = _launches(counters)
    peak = torch.cuda.max_memory_allocated() / 2**30
    reserved = torch.cuda.max_memory_reserved() / 2**30
    starts = rec.starts
    head, tail = starts[0] - t0, t_end - starts[-1]
    span = starts[POP_WARMUP:POP_PROFILE_ROUND]
    ms = (span[-1] - span[0]) * 1e3 / (len(span) - 1)
    # each round's ms, server update to server update (the workers'
    # graphs are captured before round 0; a new admitted length captures
    # a server update graph in its round)
    each = [round((b - a) * 1e3, 3) for a, b in zip(starts, starts[1:])]
    free = rec.capture_free(POP_WARMUP, POP_PROFILE_ROUND - 1)
    steady = (float(np.mean([each[k] for k in free])) if free
              else float("nan"))
    in_rounds = sorted({n - 1 for n in rec.captured_in})
    log(f"population: ms from each round's server update to the next "
        f"(rounds 0..{T - 2}; round {POP_PROFILE_ROUND} profiled): {each}; "
        f"graphs captured in rounds {in_rounds} (-1: before round 0's "
        f"server update); rounds {POP_WARMUP}..{POP_PROFILE_ROUND - 2} "
        f"without a capture {free}: {steady:.3f} ms a round")
    log(f"population: {arch} full width and depth ({cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, bf16), cascaded, {POP['n_clients']} client "
        f"parties over loopback wires, batch {POP['batch']} x {POP['seq']} "
        f"(span {POP['seq'] // POP['n_clients']}), q = {q}, {T} rounds: "
        f"{ms:.3f} ms a round (host clock at each round's server update "
        f"after a synchronise, rounds {POP_WARMUP}..{POP_PROFILE_ROUND - 1}"
        f"; the cycle from round {POP_PROFILE_ROUND} profiled) on {card}; "
        f"peak memory {peak:.2f} GiB ({reserved:.2f} GiB reserved, the "
        f"graphs' pools in it); train_population {res['wall_s']} s "
        f"of run_population, whole call {wall:.2f} s: {head:.2f} s before "
        f"round 0's server update (the weights drawn on the card, the "
        f"table, round 0's uplink), {starts[-1] - starts[0]:.2f} s from it "
        f"to round {T - 1}'s, {tail:.2f} s after (round {T - 1}'s "
        f"downlink, the collect of {POP['n_clients']} client tables over "
        f"the wire, stop); the profiled cycle's trace processing "
        f"{rec.profile_s:.2f} s of it")
    log(f"population result: {json.dumps(res)}")
    pop_graphs(f"population (a), {arch}", res["graphs"], rec)
    admitted = round(res["participation"] * T)
    plan = pop_plan(cfg, q, T, admitted)
    log(f"population launches {launches}, derived {plan['launches']}: "
        f"{plan['why']}")
    if not (res["rounds"] == T and np.isfinite(res["loss_first"])
            and np.isfinite(res["loss_last"])):
        raise AssertionError(f"population run failed: {res}")
    if not res["loss_last"] < res["loss_first"]:
        raise AssertionError(f"population loss did not fall: {res}")
    if res["wire_has_gradients"]:
        raise AssertionError("gradients crossed the population's wire")
    if {k: launches[k] for k in plan["launches"]} != plan["launches"] or \
            any(launches[k] for k in launches if k not in plan["launches"]):
        raise AssertionError(f"population launches {launches}, want "
                             f"{plan['launches']} and no ZOO kernel")
    log(f"population wire: serialized {res['serialized_bytes']} B in the "
        f"ledger; {meter.frames} emb/loss frames measured as sent "
        f"{meter.bytes} B; formula {res['formula_bytes']} B (f32 payloads: "
        f"the bf16 embeddings cross at half); control {res['control_bytes']}"
        f" B")
    if res["serialized_bytes"] != meter.bytes or \
            meter.frames != 2 * (1 + q) * admitted:
        raise AssertionError("the ledger's serialized bytes differ from the "
                             "frames sent")
    log_profile(f"population profile, round cycle {POP_PROFILE_ROUND} of "
                f"{arch} on {card}", rec.profile)
    log(f"population profile, round cycle {POP_PROFILE_ROUND}: the host's "
        f"launch calls {rec.profile['api']} with the workers' uplinks and "
        f"updates from their graphs (the workers eager instead: 2 "
        f"cudaGraphLaunch, 63 cudaLaunchKernel)")
    t_checks = time.perf_counter()
    path = f"population:{arch}"
    for name, cap in caps.items():
        if sorted(cap.inputs) != sorted(keeps[name]):
            raise AssertionError(f"population: {name} captured "
                                 f"{sorted(cap.inputs)}")
        rows[name].setdefault("serve_max_abs_err", {})[path] = hold_calls(
            name, *kernels[name], cap.inputs,
            lambda i, args, kw, name=name: keeps[name][i], "population")
        rows[name]["launches"] += launches[name]
        rows[name].setdefault("launches_by_path", {})[path] = launches[name]
    log(f"population (a): the kernels held on the run's inputs "
        f"{time.perf_counter() - t_checks:.2f} s")
    del caps
    # the same run with the server's functions eager, bitwise
    h, server = rec.h, rec.server
    gc.collect()
    torch.cuda.empty_cache()
    with RoundRecorder(graph=False) as eager:
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        train_mod.train_population(
            arch, use_reduced=False, steps=T, batch=POP["batch"],
            seq=POP["seq"], n_clients=POP["n_clients"], rows=POP["rows"],
            zoo_queries=q, lr=POP["lr"], mu=POP["mu"], seed=0)
        torch.cuda.synchronize()
        t_eager = time.perf_counter() - t0
    span = eager.starts[POP_WARMUP:POP_PROFILE_ROUND]
    ms_eager = (span[-1] - span[0]) * 1e3 / (len(span) - 1)
    same = (len(h) == len(eager.h) == T
            and all(torch.equal(a, b) for a, b in zip(h, eager.h))
            and _same_trees(server, eager.server))
    log(f"population (a): the same {T} rounds with the server's functions "
        f"and the workers' uplinks and updates eager: {ms_eager:.3f} ms a "
        f"round (the same clock and rounds) "
        f"against {ms:.3f} ms from the graphs; peak memory "
        f"{(torch.cuda.max_memory_allocated() - held) / 2**30:.2f} GiB "
        f"eager above the {held / 2**30:.2f} GiB held before it (the "
        f"graphed run's server tree) against {peak:.2f} GiB from the "
        f"graphs; whole call {t_eager:.2f} s; every "
        f"round's server loss and the final server parameters bitwise "
        f"equal: {same}")
    if not same:
        raise AssertionError("the population run's graphs differ from "
                             "its eager functions")
    del rec, eager, h, server
    gc.collect()
    torch.cuda.empty_cache()


def pop_graphs(what, graphs_stats, rec) -> None:
    """A population run's server graphs: one captured per distinct key
    the run's calls had (``rec``'s), each replayed for the rest."""
    up, down = graphs_stats["server_update"], graphs_stats["losses_fn"]
    log(f"{what}: server_update {up['graphs']} graph(s) for "
        f"{len(rec.update_keys)} key(s), the admitted lengths "
        f"{sorted(rec.lengths)} (capture s {up['capture_s']}, nodes "
        f"{up['nodes']}, kernel nodes {up['kernel_nodes']}, replays "
        f"{up['replays']}); losses_fn {down['graphs']} graph(s) for "
        f"{len(rec.loss_keys)} key(s) over {rec.downlinks} downlinks "
        f"(capture s {down['capture_s']}, nodes {down['nodes']}, replays "
        f"{down['replays']})")
    if up["graphs"] != len(rec.update_keys) or \
            down["graphs"] != len(rec.loss_keys):
        raise AssertionError(f"{what}: graphs {graphs_stats} for keys "
                             f"{rec.update_keys}, {rec.loss_keys}")
    # each loopback worker's own uplink and update graphs: one key each
    # (its batch and draws keep their shapes), captured by the worker's
    # warm-up before round 0's server update, none in the rounds
    workers = graphs_stats.get("workers", {})
    for m, w in sorted(workers.items()):
        log(f"{what}: worker {m}: " + "; ".join(
            f"{name} {g['graphs']} graph(s) (capture s "
            f"{[round(c, 4) for c in g['capture_s']]}, nodes {g['nodes']}, "
            f"replays {g['replays']})" for name, g in sorted(w.items())))
    before = sum(1 for n in rec.captured_in if n == 0)
    log(f"{what}: graphs captured before round 0's server update: "
        f"{before}")
    if not workers or any(set(w) != {"uplink", "update"} or any(
            g["graphs"] != 1 for g in w.values())
            for w in workers.values()) or before != 2 * len(workers):
        raise AssertionError(f"{what}: the workers' graphs {workers}, "
                             f"{before} captured before round 0")


class CpuRowDraws:
    """``RowDraws`` drawn on the CPU and handed to a run on ``device``, so
    a card run and a CPU run draw the same numbers. ``directions=False``
    leaves the client directions to the card's own ``RowDraws`` (the
    fault check needs only the schedule to agree)."""

    def __init__(self, seed, device, directions=True):
        from repro_torch.core.draws import RowDraws
        self.cpu, self.dev = RowDraws(seed, "cpu"), torch.device(device)
        self.card = None if directions else RowDraws(seed, device)

    def schedule(self, *a):
        return self.cpu.schedule(*a).to(self.dev)

    def sample_indices(self, *a):
        return self.cpu.sample_indices(*a).to(self.dev)

    def row_key(self, t, r):
        return self.cpu.row_key(t, r)

    def directions(self, key, template, q):
        from repro_torch.core import draws
        from repro_torch.tree import tree_leaves, tree_map
        if self.card is not None:
            return self.card.directions(key, template, q)
        seed, t, row = (int(w) for w in np.asarray(key).reshape(-1))
        raw = draws._normals(draws._seeded((seed, draws._CLIENT, t, row),
                                           "cpu"), template, (q,))
        dev = tree_leaves(template)[0].device
        return tree_map(lambda x: x.to(dev), raw)

    def client_directions(self, t, template, n_rows, q):
        from repro_torch.tree import tree_map
        rows = [self.directions(self.row_key(t, r), template, q)
                for r in range(n_rows)]
        return tree_map(lambda *xs: torch.stack(xs), *rows)

    def noise(self, *a):
        return self.cpu.noise(*a).to(self.dev)


def _pop_session(cfg, device, rounds, vfl=None):
    """A population session of ``cfg`` at the CLI's shapes, its params
    (drawn on ``device`` from seed 0) and its data."""
    from repro_torch.configs import VFLConfig
    from repro_torch.core.async_engine import EngineConfig
    from repro_torch.data import lm_token_batches, vertical_partition
    from repro_torch.federation import Federation
    fed = Federation.build(
        cfg, vfl or VFLConfig(mu=POP["mu"], lr_server=POP["lr"],
                              lr_client=1e-5),
        EngineConfig(method="cascaded", steps=rounds,
                     batch_size=POP["batch"], seed=0),
        n_clients=POP["n_clients"], seq_len=POP["seq"], device=device)
    params = fed.init_params(torch.Generator(fed.device).manual_seed(0))
    toks = next(lm_token_batches(1, cfg.vocab_size, POP["rows"],
                                 POP["seq"]))["tokens"]
    return fed, params, vertical_partition(toks, POP["n_clients"]), toks


def _small_cfg():
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("phi3-mini-3.8b"),
                               n_layers=POP_SMALL["layers"])


def pop_worker(argv) -> int:
    """The socket worker process: ``chip_smoke.py --pop-worker PORT PARTY
    [KILL_AT_FRAME]`` rebuilds the 2-layer session's party row on the card
    (the same seeds as the engine) and serves it until the engine says
    stop; KILL_AT_FRAME > 0 ``kill -9``'s it as it sends that frame."""
    sys.path.insert(0, str(SRC))
    from repro_torch.tree import tree_map
    from repro_torch.wire import (ChaosBackend, ChaosPlan, ClientWorker,
                                  SocketBackend)
    port, party = int(argv[0]), int(argv[1])
    kill = int(argv[2]) if len(argv) > 2 else 0
    fed, params, xp, _ = _pop_session(_small_cfg(), "cuda",
                                      POP_SMALL["rounds"])
    row = tree_map(lambda a: a[party].clone(), params["clients"])
    del params
    backend = SocketBackend.connect("127.0.0.1", port)
    if kill:
        backend = ChaosBackend(backend, ChaosPlan(kill_at_frame=kill))
    ClientWorker(fed.adapter, fed.vfl, row, xp[party], party,
                 backend).serve(timeout=900.0)
    print("POP_WORKER_OK", flush=True)
    return 0


def _start_worker(party, kill=0):
    from repro_torch.wire import listen
    listener, port = listen()
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), POP_WORKER,
         str(port), str(party), str(kill)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return listener, proc


def _stop_worker(listener, proc):
    listener.close()
    try:
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return proc.returncode, out, err


def _same_trees(a, b) -> bool:
    from repro_torch.tree import tree_leaves
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def _same_pop(a, b) -> bool:
    """Two population results' losses, params, table and delays bitwise
    equal."""
    return (np.array_equal(a.losses, b.losses)
            and _same_trees(a.params, b.params)
            and torch.equal(a.state.table, b.state.table)
            and np.array_equal(a.state.delays, b.state.delays))


def _tabular_faults(plan, admission):
    """The fault check's CPU counterpart: the same plan, admission and
    schedule (``RowDraws(0)`` over the same parties, rounds and rows) on a
    small tabular model. The counters and the virtual clock depend on the
    schedule and the plan's deliveries, never on the model or its frame
    sizes, so they must equal the LM run's on the card."""
    from repro_torch.configs import VFLConfig
    from repro_torch.configs.paper_mlp import PaperMLPConfig
    from repro_torch.core.async_engine import EngineConfig
    from repro_torch.federation import Federation
    M, n = POP["n_clients"], POP["rows"]
    fed = Federation.build(
        PaperMLPConfig(n_features=4 * M, n_classes=2, n_clients=M,
                       client_embed=2, server_embed=4),
        VFLConfig(), EngineConfig(method="cascaded",
                                  steps=POP_SMALL["rounds"],
                                  batch_size=POP["batch"], seed=0),
        device="cpu")
    rng = np.random.default_rng(0)
    return fed.run_population(
        fed.init_params(torch.Generator().manual_seed(0)),
        rng.standard_normal((M, n, 4)).astype(np.float32),
        rng.integers(0, 2, n), fault_plan=plan, population=admission)


def pop_small(counters) -> dict:
    """(b) and (c) at Phi-3 full width cut to 2 layers on the card;
    returns the seconds of each piece."""
    import shutil
    import tempfile
    from repro_torch.core import async_engine
    from repro_torch.core.async_engine import PopulationConfig
    from repro_torch.core.draws import RowDraws
    from repro_torch.federation import Federation
    from repro_torch.wire import FaultPlan, accept
    spent = {}

    def lap(name, t0):
        spent[name] = time.perf_counter() - t0
        return time.perf_counter()

    # the worker processes start first: they take seconds to reach the card
    t0 = time.perf_counter()
    sock_l, sock_p = _start_worker(2)
    kill_l, kill_p = _start_worker(1, kill=2)
    try:
        cfg = _small_cfg()
        R, until = POP_SMALL["rounds"], POP_SMALL["until"]
        fed, params, xp, toks = _pop_session(cfg, "cuda", R)
        t0 = lap("session", t0)
        x_d = torch.from_numpy(xp).to("cuda", torch.int64)
        y_d = torch.from_numpy(toks).to("cuda", torch.int64)

        # ---- (b) population == run, bitwise ---------------------------
        t0 = time.perf_counter()
        pop = fed.run_population(params, xp, toks)
        t_pop = time.perf_counter() - t0
        runner = async_engine._make_runner(fed.adapter, fed.transport,
                                           fed.vfl, False, 1, False)
        draws = RowDraws(0, "cuda")
        M, n = x_d.shape[:2]
        (p, table, delays), (losses, _) = runner(
            params, fed.adapter.client_forward(params["clients"], x_d),
            torch.zeros((M, n), dtype=torch.int32, device="cuda"),
            draws.schedule(R, M, None, 1),
            draws.sample_indices(R, POP["batch"], n), draws, x_d, y_d)
        whole = fed.run(params, xp, toks, draws=RowDraws(0, "cuda"))
        eager = fed.run_population(params, xp, toks, use_graph=False)
        same = (_same_pop(pop, eager)
                and np.array_equal(pop.losses, losses.cpu().numpy())
                and np.array_equal(pop.losses, whole.losses)
                and _same_trees(pop.params, p)
                and _same_trees(pop.params, whole.params)
                and torch.equal(pop.state.table, table.cpu())
                and np.array_equal(pop.state.delays, delays.cpu().numpy()))
        log(f"population == run: Phi-3 full width, {cfg.n_layers} layers, "
            f"{R} rounds, FaultPlan.none(), RowDraws(0) on the card: "
            f"losses {[round(float(x), 5) for x in pop.losses]}; losses, "
            f"params, table and delays bitwise equal to run()'s, the "
            f"captured round's, and the population run's with its server "
            f"functions and its workers' uplinks and updates eager: {same} "
            f"(population {t_pop:.2f} s; graphs {pop.stats['graphs']})")
        if not same:
            raise AssertionError("the population run differs from run()")
        t0 = lap("population == run (4 runs)", t0)

        # ---- (b) until=5, save, restore, resume -------------------------
        build = Path(__file__).resolve().parent / "build"
        build.mkdir(exist_ok=True)
        root = tempfile.mkdtemp(prefix="chip_smoke_pop_", dir=build)
        try:
            half = fed.run_population(params, xp, toks, until=until)
            path = fed.save(f"{root}/ck", half.params, step=until,
                            ledger=half.ledger, async_state=half.state)
            fed2, params2, state = Federation.restore(
                path, device=fed.device)
            cont = fed2.run_population(params2, xp, toks,
                                       state=state.async_state,
                                       ledger=state.ledger)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        resumed = (np.array_equal(cont.losses, pop.losses[until:])
                   and _same_trees(cont.params, pop.params)
                   and torch.equal(cont.state.table, pop.state.table)
                   and np.array_equal(cont.state.delays, pop.state.delays)
                   and cont.serialized_bytes == pop.serialized_bytes)
        log(f"population resume: until={until}, fed.save(async_state=), "
            f"Federation.restore, resumed to {R}: losses, params, table, "
            f"delays and serialized bytes bitwise equal to the unbroken "
            f"run: {resumed}")
        if not resumed:
            raise AssertionError("the resumed population run differs")
        t0 = lap("until, save, restore, resume", t0)

        # ---- (b) party 2 behind a socket, its worker on the card --------
        chan = accept(sock_l, timeout=300.0)
        t0 = lap("socket party: waiting for its worker", t0)
        sock = fed.run_population(params, xp, toks, channels={2: chan})
        over = (np.array_equal(sock.losses, pop.losses)
                and _same_trees(sock.params, pop.params)
                and sock.ledger.messages == pop.ledger.messages)
        log(f"population over a socket: party 2's ClientWorker in another "
            f"process on the card; losses, params and ledger messages "
            f"(measured bytes included) equal to the loopback run: {over}; "
            f"control bytes {sock.control_bytes} vs {pop.control_bytes}")
        if not over:
            raise AssertionError("the socket run differs")
        # the worker's exit is read after (c): its teardown overlaps it
        t0 = lap("socket party: the run", t0)

        # ---- (c) faults: card against the CPU ----------------------------
        plan = FaultPlan(**POP_FAULTS)
        admission = PopulationConfig(**POP_ADMISSION)
        with RoundRecorder() as rec:
            faulty = fed.run_population(
                params, xp, toks, fault_plan=plan, population=admission,
                draws=CpuRowDraws(0, "cuda", directions=False))
        faulty_eager = fed.run_population(
            params, xp, toks, fault_plan=plan, population=admission,
            draws=CpuRowDraws(0, "cuda", directions=False),
            use_graph=False)
        pop_graphs("population faults", faulty.stats["graphs"], rec)
        same = _same_pop(faulty, faulty_eager)
        log(f"population faults: the run from its server graphs against "
            f"the same run with the functions eager: losses, params, table "
            f"and delays bitwise equal {same}")
        if not same or len(rec.lengths) < 2:
            raise AssertionError(f"the faulty run's server graphs differ "
                                 f"from the eager functions, or it "
                                 f"captured one server_update key "
                                 f"({rec.lengths})")
        t1 = time.perf_counter()
        cpu = _tabular_faults(plan, admission)
        t_cpu = time.perf_counter() - t1
        keys = ("uplink_drops", "stragglers", "downlink_drops", "forced",
                "degraded_rounds", "retransmit_frames", "virtual_ms")
        got = {k: faulty.stats[k] for k in keys}
        want = {k: cpu.stats[k] for k in keys}
        log(f"population faults: {POP_FAULTS}, {POP_ADMISSION}: card "
            f"{got}; the same plan and schedule on the CPU (a tabular "
            f"model: the counters and the clock do not depend on the "
            f"model; {t_cpu:.2f} s) {want}; losses finite "
            f"{bool(np.isfinite(faulty.losses).all())}")
        if got != want or len(faulty.losses) != R or \
                not np.isfinite(faulty.losses).all():
            raise AssertionError("the faulty run's counters differ from "
                                 "the CPU's")
        # dropped attempts show as lost deliveries or as retransmits
        if not (got["uplink_drops"] + got["downlink_drops"]
                + got["retransmit_frames"]
                and got["stragglers"] and got["forced"]):
            raise AssertionError(f"the fault plan exercised nothing: {got}")
        t0 = lap("faults", t0)

        # ---- (c) kill -9 a socket worker mid-run ---------------------------
        chan = accept(kill_l, timeout=300.0)
        t0 = lap("kill -9: waiting for its worker", t0)
        killed = fed.run_population(params, xp, toks, channels={1: chan},
                                    wire_timeout_s=120.0)
        rc, out, err = _stop_worker(kill_l, kill_p)
        log(f"population kill -9: party 1's worker process exit {rc} at its "
            f"2nd frame; {len(killed.losses)} rounds completed, dead "
            f"parties {killed.stats['dead_parties']}, uplink drops "
            f"{killed.stats['uplink_drops']}, participation "
            f"{killed.stats['participation']:.3f}")
        if not (rc == 9 and killed.stats["dead_parties"] == 1
                and len(killed.losses) == R
                and np.isfinite(killed.losses).all()
                and _same_trees({k: v[1] for k, v in
                                 killed.params["clients"]["embed"].items()},
                                {k: v[1] for k, v in
                                 params["clients"]["embed"].items()})):
            raise AssertionError(f"the killed worker's run failed (exit "
                                 f"{rc}): {err[-2000:]}")
        t0 = lap("kill -9: the run and the worker's exit", t0)
        rc, out, err = _stop_worker(sock_l, sock_p)
        log(f"population over a socket: the worker exited {rc}")
        if rc != 0 or "POP_WORKER_OK" not in out:
            raise AssertionError(f"the socket worker failed (exit {rc}): "
                                 f"{err[-2000:]}")
        lap("socket party: the worker's exit", t0)
        log("population phase (b, c) time: " + "; ".join(
            f"{k} {v:.1f} s" for k, v in spent.items()))
    finally:
        for listener, proc in ((sock_l, sock_p), (kill_l, kill_p)):
            if proc.poll() is None:
                _stop_worker(listener, proc)
    del fed, params
    gc.collect()
    torch.cuda.empty_cache()
    return spent


def pop_card_vs_cpu() -> None:
    """(d) One population round on reduced phi3 in f32, on the card and on
    the CPU from the same params and draws (drawn on the CPU), held as
    phase 5 holds a step (``step_card_vs_cpu``): the loss at 1e-5, and
    each leaf's step (new - old) entrywise within the rule
    tests/test_torch_train_step.py holds a step to the JAX package's with
    — 1e-4 (FOO server leaves) or 1e-2 (ZOO client leaves) of the CPU
    step's largest entry, plus one f32 rounding of the leaf's largest
    param — plus twice the f32 step's own error in that leaf (the CPU's
    f32 step against the same round from f64 params)."""
    from repro_torch.configs import VFLConfig, get_config, reduced
    from repro_torch.tree import tree_leaves, tree_map
    cfg = reduced(get_config("phi3-mini-3.8b"), param_dtype="float32",
                  dtype="float32")
    vfl = VFLConfig(**STEP_VFL)
    cpu_fed, cpu_params, xp, toks = _pop_session(cfg, "cpu", 1, vfl)
    card_fed, _, _, _ = _pop_session(cfg, "cuda", 1, vfl)
    outs = {}
    for name, fed, params, dev in (
            ("card", card_fed, tree_map(lambda t: t.to("cuda"), cpu_params),
             "cuda"),
            ("cpu", cpu_fed, cpu_params, "cpu"),
            ("f64", cpu_fed, tree_map(torch.Tensor.double, cpu_params),
             "cpu")):
        outs[name] = fed.run_population(params, xp, toks,
                                        draws=CpuRowDraws(0, dev))
    g, c, r = outs["card"], outs["cpu"], outs["f64"]
    loss_rel = abs(float(g.losses[0]) - float(c.losses[0])) / abs(
        float(c.losses[0]))
    worst = f32_err = 0.0
    bare = whole = -math.inf
    worst_leaf = None
    for part in ("server", "clients"):
        tol = 1e-2 if part == "clients" else 1e-4
        for x, y, z, p in zip(tree_leaves(g.params[part]),
                              tree_leaves(c.params[part]),
                              tree_leaves(r.params[part]),
                              tree_leaves(cpu_params[part])):
            want = (y - p).double()
            gap = float(((x.cpu() - p).double() - want).abs().max())
            own = float(((z - p.double()) - want).abs().max())
            ulp = float(np.spacing(np.float32(p.abs().max())))
            big = max(float(want.abs().max()), 1e-30)
            rel = (gap - ulp - 2 * own) / (tol * big)
            bare = max(bare, (gap - ulp) / (tol * big))
            whole = max(whole, gap / (tol * big + ulp))
            f32_err = max(f32_err, (own - ulp) / big)
            if worst_leaf is None or rel > worst:
                worst, worst_leaf = rel, (part, tuple(p.shape))
    log(f"population round on the card vs the CPU, reduced phi3 f32 "
        f"({STEP_VFL}): loss {float(g.losses[0]):.7f} vs "
        f"{float(c.losses[0]):.7f} (relative {loss_rel:.3e}, tol 1e-5); "
        f"worst leaf step gap beyond one rounding and twice the f32 step's "
        f"own error {worst:.3f} of its allowance (leaf {worst_leaf}; 1e-4 "
        f"x the server step's or 1e-2 x the client step's largest entry), "
        f"{bare:.3f} of it without the own-error term (the gap over the "
        f"allowance plus the rounding {whole:.3f}); the CPU f32 step's "
        f"error against f64 params up to {f32_err:.3e} of the step")
    if not (loss_rel <= 1e-5 and worst <= 1.0):
        raise AssertionError("the population round on the card differs "
                             "from the CPU's")


# ------------------------------- phase 8: the RWKV6 and MoE families ----

# (a, b) the split serve path of both families at full width and depth
FAMILY_SERVE_ARCHS = ("qwen3-moe-30b-a3b", "rwkv6-7b")
# (c) continuous serving of RWKV6 at full width, cut to this many layers
CONT_RWKV_LAYERS = 8
# (d) training at full width, cut to (arch, layers), at the server lr
# whose run is gated; 10 cascaded steps. At the CLI's lr 0.01 Qwen3's
# bf16 SGD moves its loss by less than the batches' spread in 10 steps
# (most updates fall below half a bf16 step of the weights they land on;
# train_family logs the share at both lrs): that run is logged, and the
# gated one takes lr 1.0
FAMILY_TRAIN = (("qwen3-moe-30b-a3b", 4, 1.0), ("rwkv6-7b", 8, 0.01))
FAMILY_TRAIN_STEPS, FAMILY_TRAIN_WARMUP = 10, 3
# steps of a captured run held bitwise to an eager run of as many
EAGER_STEPS = 3
CLI_LR = 0.01
# the MoE gather form under capture: batch 2 (B·k = 16 <= 128 experts)
GATHER_CASE = dict(batch=2, layers=2, steps=4)
# (e) the attacks at Table I's size; the feature attack at repro's
ATTACK = dict(n_classes=10, n_samples=2048)
# the second draw of each attack, beside the entry points' defaults (0, 1)
ATTACK_SEEDS = dict(label=2, feature=3)
ATTACK_MSE_RTOL = 1e-4


def train_run(arch, layers, lr, counters, cfg=None, profile=False,
              graph=None, steps=FAMILY_TRAIN_STEPS, keep_params=False,
              warmup=FAMILY_TRAIN_WARMUP):
    """One ``launch.train.train`` run of ``steps`` steps at full width cut
    to ``layers`` (of ``cfg`` where given: a registry entry with its
    experts cut), through the captured step (``graph=False``: eager):
    (result, losses, ms a step after ``warmup`` steps, peak bytes, wall s,
    launches, the last step's profile where ``profile``: that step is
    then left out of the timed ones). ``keep_params`` leaves the final
    parameters in the result."""
    from repro_torch.launch import train as train_mod
    gc.collect()
    torch.cuda.empty_cache()
    last = steps - 1 if profile else None
    with StepRecorder(profile_at=last, graph=graph) as rec:
        for c in counters:
            c.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = train_mod.train(cfg or arch, use_reduced=False,
                              n_layers=layers, steps=steps,
                              method="cascaded", lr=lr, log_every=5,
                              keep_params=keep_params, **TRAIN)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launches(counters)
    timed = rec.ends[warmup - 1:last]
    ms = (timed[-1] - timed[0]) * 1e3 / (len(timed) - 1)
    return (res, rec.losses, ms, torch.cuda.max_memory_allocated(), wall,
            launches, rec.profile)


@contextlib.contextmanager
def deterministic(on: bool):
    """``torch.use_deterministic_algorithms`` for the block where ``on``
    (warn-only: cuBLAS, whose calls at fixed shapes repeat their bits
    anyway, would raise without ``CUBLAS_WORKSPACE_CONFIG``)."""
    if not on:
        yield
        return
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def graph_vs_eager_steps(arch, layers, lr, counters, base, cfg,
                         depth) -> None:
    """EAGER_STEPS steps through the captured step against as many eager
    steps, from the same weights and batches: losses and final parameters
    bitwise. A config with routed experts runs both under
    :func:`deterministic`: the gathers of its dispatch
    (``models/moe.py::moe_apply_dispatch``) scatter-add their gradients
    with atomics, whose order changes from run to run, eager or captured
    (step 0, eager in every run, gave three different server gradient
    norms in three Qwen3 runs of one call: PERF.md §6)."""
    n, det = EAGER_STEPS, bool(cfg.n_experts)
    runs = {}
    with deterministic(det):
        for graph in (None, False):
            res, losses, ms, peak, wall, _, _ = train_run(
                arch, layers, lr, counters, base, graph=graph, steps=n,
                keep_params=True, warmup=1)
            runs[graph] = (losses, host_copy(res.pop("params")), ms, peak,
                           wall)
            del res
    (g_losses, g_params, g_ms, g_peak, g_wall), (
        e_losses, e_params, e_ms, e_peak, e_wall) = runs[None], runs[False]
    same_losses = g_losses == e_losses
    same_params = same_on_host(g_params, e_params)
    log(f"train: {arch} {depth}, {n} steps through the captured step "
        f"({g_ms:.3f} ms a step over steps 1..{n - 1}, the replays; call "
        f"{g_wall:.2f} s, peak {g_peak / 2**30:.2f} GiB) against {n} eager "
        f"steps ({e_ms:.3f} ms a step over steps 1..{n - 1}; call "
        f"{e_wall:.2f} s, peak {e_peak / 2**30:.2f} GiB)"
        + (", both under torch.use_deterministic_algorithms" if det else "")
        + f": losses {[round(x, 4) for x in g_losses]}, bitwise equal "
        f"{same_losses}; final parameters bitwise equal {same_params}")
    if not (same_losses and same_params):
        raise AssertionError(f"{arch}: the captured training step differs "
                             f"from the eager one")


def lost_updates(w, g, lr, chunk=1 << 26) -> int:
    """Entries of ``w`` whose SGD step lr·|g| is under half of the step
    between ``w``'s neighbours in its own type (2^(e - 1 - mantissa bits)
    for |w| in [2^(e-1), 2^e)): rounded to the nearest, the update leaves
    the entry where it was. An entry at 0 loses no update."""
    # eps = 2^-(mantissa bits)
    half_exp = -2 + round(math.log2(torch.finfo(w.dtype).eps))
    wf, gf = w.reshape(-1), g.reshape(-1)
    lost = 0
    for i in range(0, wf.numel(), chunk):
        wa = wf[i:i + chunk].float().abs()
        half = torch.ldexp(torch.ones_like(wa), torch.frexp(wa)[1] + half_exp)
        lost += int(((lr * gf[i:i + chunk].float().abs() < half)
                     & (wa > 0)).sum())
    return lost


def log_lost_updates(arch, params, grads, keys, lrs) -> None:
    """Log, for each server lr in ``lrs``, the share of the server's
    entries (the leaves under ``keys``) whose first SGD update is lost to
    rounding (:func:`lost_updates`), over all of them, over lm_head and
    over the experts, and the median |w| and lr·|g| of lm_head."""
    def walk(path, w, gr):
        if isinstance(w, dict):
            for k in w:
                yield from walk(path + (k,), w[k], gr[k])
        else:
            yield path, w, gr
    leaves = [leaf for k in keys for leaf in walk((k,), params[k], grads[k])]
    head = [(w, gr) for path, w, gr in leaves if path[0] == "lm_head"]
    med_w, med_g = (float(torch.cat([t[i].float().abs().flatten()[::97]
                                     for t in head]).median())
                    for i in (0, 1))
    for lr in lrs:
        lost = {"all": [0, 0], "lm_head": [0, 0], "experts": [0, 0]}
        for path, w, gr in leaves:
            n = lost_updates(w, gr, lr)
            groups = ["all"] + (["lm_head"] if path[0] == "lm_head" else []) \
                + (["experts"] if "moe" in path and path[-1] in
                   ("w_up", "w_gate", "w_down") else [])
            for name in groups:
                lost[name][0] += n
                lost[name][1] += w.numel()
        share = {k: n / max(total, 1) for k, (n, total) in lost.items()}
        log(f"train: {arch} at server lr {lr}: the first SGD step loses "
            f"{share['all']:.4f} of the server's "
            f"{lost['all'][1]:,} entries to rounding (lr·|g| under half "
            f"the step to the weight's neighbour in its type), "
            f"{share['lm_head']:.4f} of lm_head's, "
            f"{share['experts']:.4f} of the experts'; lm_head median "
            f"|w| {med_w:.4g}, median lr·|g| {lr * med_g:.4g}")


def train_family(rows, card, counters, arch, layers, lr, base=None,
                 profile=False) -> None:
    """``launch.train.train`` of ``arch`` (of ``base``, its config with a
    cut, where given) at full width cut to ``layers``:
    FAMILY_TRAIN_STEPS cascaded steps of 8 x 128 tokens at server lr
    ``lr`` (a run at the CLI's lr first, logged, where ``lr`` is another).
    First the family's kernels at its training shapes
    (:func:`check_kernel_grads`); then a finite, falling loss, the
    launches derived from the config, the wire formula, ms a step and
    peak memory; for the MoE family the server gradient reaching the
    first block's experts and router, the aux loss's own gradient
    reaching the router, and the share of SGD updates a bf16 weight
    loses at each lr (:func:`log_lost_updates`). ``profile`` profiles the
    last step by kernel family (left out of the timed steps)."""
    from repro_torch.configs import VFLConfig, cut_depth, get_config
    from repro_torch.core import cascade
    from repro_torch.core.partition import LM_CLIENT_KEYS
    from repro_torch.data import BatchIterator, lm_token_batches
    from repro_torch.federation import Federation
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm import ref as rms_ref
    from repro_torch.models import common
    steps = FAMILY_TRAIN_STEPS
    cfg = cut_depth(base or get_config(arch), layers)
    sites, _, block_norms, _ = kernel_sites(cfg)
    if sites or block_norms:
        flash_cases, rms_cases = train_kernel_cases(cfg)
        check_kernel_grads(rows, flash_ops, flash_ref, rms_ops, rms_ref,
                           flash_cases=flash_cases if sites else (),
                           rms_cases=rms_cases if block_norms else ())
    plan = train_plan(cfg, q=1, steps=steps)
    if lr != CLI_LR:
        _, at_cli, ms, _, _, _, _ = train_run(arch, layers, CLI_LR,
                                              counters, base)
        log(f"train: {arch} at {layers} layers at the CLI's lr {CLI_LR} "
            f"(logged, not gated but finite): {ms:.3f} ms per step, losses "
            f"{[round(x, 4) for x in at_cli]}; first {at_cli[0]:.4f}, mean "
            f"of the last 5 {float(np.mean(at_cli[-5:])):.4f}")
        if not np.isfinite(at_cli).all():
            raise AssertionError(f"{arch} losses at lr {CLI_LR} not "
                                 f"finite: {at_cli}")
    res, losses, ms, peak, wall, launches, prof = train_run(
        arch, layers, lr, counters, base, profile)
    stats = res["step_graph"]
    depth = (f"cut to {layers} layers" if 0 < layers < get_config(
        arch).n_layers else "at full depth")
    log(f"train: {arch} full width {depth} (d_model "
        f"{cfg.d_model}, {cfg.param_count() / 1e9:.3f} B params, bf16"
        + (f"; {cfg.first_k_dense} dense layers, {cfg.n_experts} routed "
           f"experts top-{cfg.top_k}" if cfg.n_experts else "") + "), "
        f"cascaded through launch.train.train, batch {TRAIN['batch']} x "
        f"{TRAIN['seq']}, SGD lr {lr}, mu 1e-3, q = 1: {steps} steps, "
        f"{ms:.3f} ms per step (host clock after a synchronise, steps "
        f"{FAMILY_TRAIN_WARMUP}..{steps - 1 - profile} after "
        f"{FAMILY_TRAIN_WARMUP} warm-up steps) on {card}; peak memory "
        f"{peak / 2**30:.2f} GiB; "
        f"whole call {wall:.2f} s (weights drawn on the card included); "
        f"losses {[round(x, 4) for x in losses]}; launches {launches}, "
        f"derived {plan['launches']}: {plan['why']}; step graph: capture "
        f"{stats['capture_s'][0]:.3f} s, {stats['nodes'][0]} nodes "
        f"({stats['kernel_nodes'][0]} kernel nodes), {stats['replays'][0]} "
        f"replays")
    first, last5 = losses[0], float(np.mean(losses[-5:]))
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"{arch} training losses not finite: {losses}")
    if not last5 < first:
        raise AssertionError(f"{arch} training loss did not fall: first "
                             f"{first}, mean of the last 5 {last5}")
    if {k: launches[k] for k in plan["launches"]} != plan["launches"] or \
            any(launches[k] for k in launches if k not in plan["launches"]):
        raise AssertionError(f"{arch} training launches {launches}, want "
                             f"{plan['launches']} and no ZOO kernel")
    check_train_wire(arch, cfg, res, steps)
    if stats["replays"] != [steps - 1]:
        raise AssertionError(f"{arch}'s step graph: {stats}")
    if profile:
        log_profile(f"train profile, step {steps - 1} of {arch} (a replay) "
                    f"on {card}", prof)
    graph_vs_eager_steps(arch, layers, lr, counters, base, cfg, depth)
    for name, n in plan["launches"].items():
        if n:
            rows[name]["launches"] += launches[name]
            rows[name].setdefault("launches_by_path", {})[
                f"train:{arch}"] = launches[name]
    if not cfg.n_experts:
        return
    # the run's own first step: seed-0 weights, the batch of seed 1
    fed = Federation.build(cfg, VFLConfig(), seq_len=TRAIN["seq"])
    params = common.materialize(fed.model.param_specs,
                                torch.Generator(fed.device).manual_seed(0),
                                device=fed.device)
    batch = next(iter(BatchIterator(lm_token_batches(
        1, cfg.vocab_size, TRAIN["batch"], TRAIN["seq"]), fed.device)))
    server_keys = [k for k in params if k not in LM_CLIENT_KEYS]
    _, g = cascade._value_and_grad(fed.model.loss_fn, params, batch,
                                   server_keys)
    log_lost_updates(arch, params, g, server_keys,
                     tuple(dict.fromkeys((CLI_LR, lr))))
    aux_of = (lambda p, b: (fed.model.loss_fn(p, b)[1]["aux"],))
    aux, g_aux = cascade._value_and_grad(aux_of, params, batch, ["blocks"])
    moe = g["blocks"]["moe"]
    norms = {k: float(moe[k][0].float().norm()) for k in
             ("w_up", "w_gate", "w_down", "router")}
    aux_router = float(g_aux["blocks"]["moe"]["router"][0].norm())
    finite = all(bool(torch.isfinite(moe[k][0]).all()) for k in norms)
    log(f"train: {arch} gradient of the loss at the first MoE block: "
        f"norms {norms}, finite {finite}; aux loss {float(aux):.6g}, its "
        f"own gradient at the first block's router: norm {aux_router:.4g}")
    if not (finite and min(norms.values()) > 0 and float(aux) > 0
            and aux_router > 0):
        raise AssertionError(f"{arch}: the gradient does not reach the first "
                             "block's experts, router and aux loss")
    del fed, params, g, g_aux
    torch.cuda.empty_cache()


def gather_under_capture() -> None:
    """The MoE gather form (``gather_experts``: a decode batch reads only
    its routed experts' weights) captured as a CUDA graph: Qwen3 at full
    width cut to GATHER_CASE's layers, B = 2, one token a step at a device
    position through ``backbone_apply``; the replays must equal the same
    steps run eagerly on copies of the caches (bitwise: the same kernels
    on the same inputs)."""
    import dataclasses
    from repro_torch import graphs
    from repro_torch.configs import get_config
    from repro_torch.models import common, moe, transformer
    from repro_torch.models.model_api import build_cache_specs, build_model
    from repro_torch.tree import tree_map
    B, steps = GATHER_CASE["batch"], GATHER_CASE["steps"]
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b"),
                              n_layers=GATHER_CASE["layers"])
    if B * cfg.top_k > cfg.n_experts:
        raise AssertionError("the gather case does not take the gather form")
    model = build_model(cfg, max_seq=16, gather_experts=True)
    params = common.materialize(model.param_specs,
                                torch.Generator("cuda").manual_seed(0),
                                device="cuda")
    g = torch.Generator("cuda").manual_seed(3)
    xs = torch.randn(steps + 1, B, 1, cfg.d_model, device="cuda",
                     generator=g).to(torch.bfloat16)

    def zero():
        return tree_map(lambda s: torch.zeros(
            s.shape, dtype=common.torch_dtype(s.dtype), device="cuda"),
            build_cache_specs(cfg, B, 16))

    calls = {"gather": 0}
    inner = moe.moe_apply_gather

    def counted(*a, **k):
        calls["gather"] += 1
        return inner(*a, **k)

    def body_of(st):
        def body():
            h, _, _ = transformer.backbone_apply(
                cfg, params, st["x"].index_select(0, st["pos"])[0],
                positions=st["pos"], caches=st["caches"],
                cur_pos=st["pos"], gather_experts=True)
            st["out"].index_copy_(0, st["pos"], h[None])
            st["pos"].add_(1)
        return body

    def state():
        return {"x": xs, "caches": zero(),
                "pos": torch.zeros(1, dtype=torch.int64, device="cuda"),
                "out": torch.zeros(steps + 1, B, 1, cfg.d_model,
                                   dtype=torch.bfloat16, device="cuda")}
    moe.moe_apply_gather = counted
    try:
        eager = state()
        with torch.no_grad():
            for _ in range(steps + 1):
                body_of(eager)()
        n_eager = calls["gather"]
        cap = state()
        with torch.no_grad():
            graph = graphs.StepGraph(body_of(cap), "cuda")
            graph.replay(steps)
        torch.cuda.synchronize()
    finally:
        moe.moe_apply_gather = inner
    same = torch.equal(eager["out"], cap["out"])
    diff = float((eager["out"].float() - cap["out"].float()).abs().max())
    log(f"MoE gather form under capture: {cfg.arch_id} full width cut to "
        f"{cfg.n_layers} layers, B = {B}, {steps + 1} steps ({n_eager} "
        f"gather calls eagerly; the warm-up and the capture through the "
        f"gather form too): {graph.nodes} graph nodes, replays equal the "
        f"eager steps: {same} (max |diff| {diff:.3g})")
    if not same or n_eager != (steps + 1) * cfg.n_layers:
        raise AssertionError("the captured gather form differs from its "
                             "eager steps")
    del params, eager, cap, graph
    torch.cuda.empty_cache()


class FixedAttackDraws:
    """An attack draw source that hands back the given draws of one
    attack, moved to ``device``: the card's draws replayed on the CPU."""

    def __init__(self, draws, device):
        self.draws = tuple(t.to(device) for t in draws)

    def label_draws(self, n_samples, n_classes):
        return self.draws

    def feature_draws(self, n, f, e):
        return self.draws


def attacks_on_card(card) -> None:
    """(e) The paper's Table I attacks on the card at its size (2048
    queries, 10 classes), through the entry points with their default
    draws (a generator on the card: seed 0 for the label attack, 1 for
    the feature attack) and with a second draw (ATTACK_SEEDS) replayed on
    the CPU: FOO leaks (1.0 and 1.0), ZOO defends (the curious client
    below 0.35, the eavesdropper within 0.05 of chance), the black-box
    feature attack at chance; on the second draw each accuracy equal to
    the CPU's, each MSE within ATTACK_MSE_RTOL of it."""
    from repro_torch.core import attacks
    n, C = ATTACK["n_samples"], ATTACK["n_classes"]
    label = attacks.TorchAttackDraws(ATTACK_SEEDS["label"],
                                     "cuda").label_draws(n, C)
    feature = attacks.TorchAttackDraws(ATTACK_SEEDS["feature"],
                                       "cuda").feature_draws(512, 16, 32)
    out = {}
    t0 = time.perf_counter()
    for framework in ("foo", "zoo"):
        out[framework] = tuple(
            attacks.run_label_inference(C, n, framework=framework, draws=d)
            for d in (None, FixedAttackDraws(label, "cuda"),
                      FixedAttackDraws(label, "cpu")))
    feat = tuple(attacks.run_feature_inference(draws=d)
                 for d in (None, FixedAttackDraws(feature, "cuda"),
                           FixedAttackDraws(feature, "cpu")))
    wall = time.perf_counter() - t0
    for framework, (default, card_r, cpu_r) in out.items():
        log(f"attack: label inference, {framework.upper()}, {n} queries, "
            f"{C} classes on the card, seed {ATTACK_SEEDS['label']}: "
            f"curious client "
            f"{card_r.curious_client_acc:.6f}, eavesdropper "
            f"{card_r.eavesdropper_acc:.6f} (the CPU on the same draws: "
            f"{cpu_r.curious_client_acc:.6f}, {cpu_r.eavesdropper_acc:.6f};"
            f" the entry point's default draws, seed 0: "
            f"{default.curious_client_acc:.6f}, "
            f"{default.eavesdropper_acc:.6f})")
        for r in (default, card_r):
            if framework == "foo":
                ok = r.curious_client_acc == 1.0 == r.eavesdropper_acc
            else:
                ok = (r.curious_client_acc < 0.35
                      and abs(r.eavesdropper_acc - 0.10) < 0.05)
            if not ok:
                raise AssertionError(f"the {framework} label attack reads "
                                     f"{r} on the card")
        if not (abs(card_r.curious_client_acc - cpu_r.curious_client_acc)
                <= 1e-5 and abs(card_r.eavesdropper_acc
                                - cpu_r.eavesdropper_acc) <= 1e-5):
            raise AssertionError(f"the {framework} label attack differs on "
                                 f"the card ({card_r}) and the CPU "
                                 f"({cpu_r})")
    default, card_f, cpu_f = feat
    gaps = {k: abs(getattr(card_f, k) - getattr(cpu_f, k))
            / max(abs(getattr(cpu_f, k)), 1e-12)
            for k in ("mse_with_model_access", "mse_black_box", "mse_chance")}
    log(f"attack: feature inference on the card, seed "
        f"{ATTACK_SEEDS['feature']}: {card_f}; the CPU on the "
        f"same draws {cpu_f} (relative gaps {gaps}, tol {ATTACK_MSE_RTOL}); "
        f"the entry point's default draws (seed 1) {default}; all attacks "
        f"{wall:.2f} s on {card}")
    for r in (default, card_f):
        if not (r.mse_with_model_access < 0.2 * r.mse_black_box
                and r.mse_black_box > 0.9 * r.mse_chance):
            raise AssertionError(f"the feature attack reads {r} on the card")
    if max(gaps.values()) > ATTACK_MSE_RTOL:
        raise AssertionError(f"the feature attack differs on the card and "
                             f"the CPU: {gaps}")


def families_phase(rows, card, counters, kernels) -> None:
    """Phase 8: the RWKV6 and MoE families and the attacks. (a) the split
    serve path of Qwen3-30B-A3B and (b) of RWKV6-7B at full width and
    depth (phase 4's checks); the MoE gather form under capture; (c)
    continuous serving of RWKV6-7B at full width cut to 8 layers (phase
    6's run A); (d) training of both at full width, cut to 4 and 8
    layers, and a reduced f32 step of each on the card against the CPU;
    (e) the attacks of Table I."""
    t_phase = time.perf_counter()
    spent = {}

    def lap(name, t0):
        spent[name] = time.perf_counter() - t0
        return time.perf_counter()

    t0 = time.perf_counter()
    for arch, what in zip(FAMILY_SERVE_ARCHS, "ab"):
        serve_phase(rows, arch, counters[0], kernels)
        t0 = lap(f"({what}) serve {arch}", t0)
    gather_under_capture()
    t0 = lap("the gather form under capture", t0)
    continuous_phase(rows, card, counters, kernels,
                     archs=(("rwkv6-7b", CONT_RWKV_LAYERS),),
                     label="phase 8 (c) continuous rwkv6-7b")
    t0 = lap("(c) continuous rwkv6-7b", t0)
    for arch, layers, lr in FAMILY_TRAIN:
        train_family(rows, card, counters, arch, layers, lr)
        step_card_vs_cpu(counters, arch=arch, methods=("cascaded",))
        t0 = lap(f"(d) train {arch}", t0)
    attacks_on_card(card)
    lap("(e) attacks", t0)
    log("phase 8 time: " + "; ".join(f"{name} {sec:.1f} s"
                                     for name, sec in spent.items()))
    log(f"phase 8: {time.perf_counter() - t_phase:.1f} s on {card}")


# ------------------------------------------- phase 9: DeepSeek-V3 ------

DEEPSEEK = "deepseek-v3-671b"
# (a), (b) serving at full width cut to its 3 dense and 2 MoE layers
# (25.7 B server parameters, 51.4 GB in bf16, and two client tables of
# 1.85 GB); (c) continuous serving cut to 3 dense and 1 MoE layer
DEEPSEEK_SERVE_LAYERS = 5
DEEPSEEK_CONT_LAYERS = 4
# (d) training at every full per-matrix width, cut to 4 layers (3 dense,
# 1 MoE) and from 256 routed experts to 16 (top-8 kept): the functional
# bf16 SGD holds an f32 copy of a leaf and of its update at once, 45 GB
# for one stacked leaf of 256 experts. The gated run's server lr is the
# CLI's 0.01, at which the loss falls (at 1.0 it diverges)
DEEPSEEK_TRAIN = dict(layers=4, n_experts=16, lr=0.01)
# (b) the absorbed attention's f32 output against the exact (f64)
# attention from the same weights, queries and latent cache: repro's own
# absorbed-vs-expanded tolerance (tests/test_perf_variants.py) plus the
# first-order bound of the absorbed form's f32 rounding carried through
# the softmax (absorbed_bound), at these decode steps (0-based, of the
# teacher-forced run) and layers
ABSORB_TOL = (2e-3, 1e-3)
ABSORB_STEPS = (0, 63, 127)
# (b) logs the teacher-forced logits gap against this share of the
# expanded form's largest |logit|; it is no gate, as it cannot hold on
# these weights: DeepSeek-V3's random scores spread to about 680, so the
# expanded form's bf16 rounding of k and v (about 0.45 in score units)
# moves near-tied softmax rows
LOGITS_GAP_SHARE = 2e-2
# the reduced f32 checks at MLA's full head dims, so that the card runs
# the kernel's (192, 128) pair (reduced() alone gives 32 and 32)
MLA_FULL_HEADS = dict(qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128)


def mla_exact(cfg, p, q_nope, q_rope, lat, kr, cur_pos, window, scale):
    """One-token MLA attention in f64 from the same (bf16) weights,
    queries and latent cache: the latent expanded per head in f64, the
    masked softmax and the weighted sum. The exact answer both decode
    forms are held to. Returns (o (B, 1, H, vd), the weights (B, H, 1,
    S), v (B, S, H, vd), the key mask (S,))."""
    r, H = cfg.kv_lora_rank, cfg.n_heads
    nd, vd = cfg.qk_nope_dim, cfg.v_head_dim
    w = p["wkv_b"].double().reshape(r, H, nd + vd)
    lat64 = lat.double()
    k_nope = torch.einsum("bkr,rhn->bkhn", lat64, w[..., :nd])
    s = (torch.einsum("bshn,bkhn->bhsk", q_nope.double(), k_nope)
         + torch.einsum("bshd,bkd->bhsk", q_rope.double(), kr.double()))
    del k_nope
    kpos = torch.arange(lat.shape[1], device=lat.device)
    mask = kpos <= cur_pos
    if window > 0:
        mask &= kpos > cur_pos - window
    pr = torch.softmax((s * scale).masked_fill(~mask, -1e30), dim=-1)
    v = torch.einsum("bkr,rhv->bkhv", lat64, w[..., nd:])
    return torch.einsum("bhsk,bkhv->bshv", pr, v), pr, v, mask


def absorbed_bound(cfg, p, q_nope, q_rope, lat, kr, exact, pr, v, mask,
                   scale):
    """Per output entry (B, 1, H, vd), the first-order bound of what the
    absorbed decode's f32 arithmetic may move it from the exact answer
    (Higham's gamma_n = n u / (1 - n u) for a sum of n products, u =
    2^-24): each visible score's error D_j (q_lat = q_nope W_uk over nd,
    then q_lat . latent over r, plus q_rope . kr over rd, the sum and the
    scale) moves the output by at most 2 max_j D_j x sum_j p_j |v_j - o|
    through the softmax, whose derivative is p (dS - p . dS); the weighted
    sums (ctx over S keys, then ctx W_uv over r) add gamma_S + gamma_r of
    sum_r (sum_j p_j |lat_j|) |W_uv|. A row whose softmax picks one key
    has sum_j p_j |v_j - o| near 0, so the bound is tight there; a
    near-tied row of these peaked scores (about 680 wide) gets the room
    its f32 rounding needs."""
    u = 2.0 ** -24

    def gamma(n):
        return n * u / (1.0 - n * u)
    r, H = cfg.kv_lora_rank, cfg.n_heads
    nd, rd = cfg.qk_nope_dim, cfg.qk_rope_dim
    w = p["wkv_b"].double().reshape(r, H, -1).abs()
    a_lat = torch.einsum("bshn,rhn->bshr", q_nope.double().abs(),
                         w[..., :nd])                     # bounds |q_lat|
    lat_abs = lat.double().abs()
    n_part = torch.einsum("bshr,bkr->bhsk", a_lat, lat_abs)
    r_part = torch.einsum("bshd,bkd->bhsk", q_rope.double().abs(),
                          kr.double().abs())
    d_key = scale * ((gamma(r) + gamma(nd) + 2 * u) * n_part
                     + (gamma(rd) + 2 * u) * r_part)
    d_max = d_key.masked_fill(~mask, 0.0).amax(-1, keepdim=True)
    spread = torch.einsum("bhsk,bkhv->bhsv", pr, (v - exact).abs())
    mags = torch.einsum("bhsr,rhv->bhsv",
                        torch.einsum("bhsk,bkr->bhsr", pr, lat_abs),
                        w[..., nd:])
    bound = (2 * d_max * (1 + d_max) * spread
             + (gamma(lat.shape[1]) + gamma(r) + 4 * u) * mags)
    return bound.transpose(1, 2), float(d_max.max())


def absorbed_decode(fed, params, cfg, eager) -> None:
    """Phase 9 (b): the weight-absorbed MLA decode (``mla_absorb``) on
    (a)'s weights and prompts. Both forms are teacher-forced on (a)'s
    greedy tokens (eager steps, each form on its own latent cache). The
    gate: at ABSORB_STEPS in the first and last layer, the absorbed
    attention's f32 output on the path's own queries and latent cache is
    within ABSORB_TOL of the exact (f64) attention (``mla_exact``); the
    expanded form's bf16 output's distance from it is logged beside, and
    the teacher-forced logits gap between the two forms is logged
    (LOGITS_GAP_SHARE). Then the absorbed decode through the captured
    step, its tokens/s and the profile of its replays, beside (a)'s."""
    import dataclasses
    from repro_torch.federation import Federation, serving
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import attention
    B, P, G = SERVE["batch"], SERVE["prompt_len"], SERVE["gen_len"]
    toks = serve_mod._prompts(cfg, B, P, 0, fed.device)
    fed_abs = Federation.build(dataclasses.replace(cfg, mla_absorb=True),
                               n_clients=fed.n_clients, seq_len=fed.seq_len)
    gen = torch.from_numpy(eager.tokens.astype(np.int32)).to(fed.device)
    span = fed.seq_len // fed.n_clients
    # the absorbed form's attention inputs at ABSORB_STEPS, layers 0 and
    # L - 1 (a call a layer a step; the prefill chunks make none)
    inner, kept, calls = attention._mla_absorbed_decode, [], [0]

    def spy(c, p, q_nope, q_rope, lat, kr, cur_pos, **kw):
        step, layer = divmod(calls[0], cfg.n_layers)
        if step in ABSORB_STEPS and layer in (0, cfg.n_layers - 1):
            kept.append((step, layer, p, q_nope.clone(), q_rope.clone(),
                         lat.clone(), kr.clone(), cur_pos, kw))
        calls[0] += 1
        return inner(c, p, q_nope, q_rope, lat, kr, cur_pos, **kw)
    t0 = time.perf_counter()
    forms = []
    attention._mla_absorbed_decode = spy
    try:
        with torch.no_grad():
            for f in (fed, fed_abs):
                caches = serving.zero_caches(f.adapter, B, f.seq_len, f.device)
                for c0, c1, m in serving.prefill_plan(P, span):
                    logits, caches = serving.prefill_chunk(
                        f.adapter, params, toks[:, c0:c1], caches, c0, m)
                step = serving.make_serve_step(f.adapter, f.n_clients,
                                               f.seq_len)
                forms.append([step, caches, logits])
            diffs, bigs, agree = [], [], 0
            for i in range(G + 1):
                want, got = forms[0][2].float(), forms[1][2].float()
                diffs.append(float((got - want).abs().max()))
                bigs.append(float(want.abs().max()))
                if i < G:
                    agree += int((got[:, -1].argmax(-1) == gen[:, i]).sum())
                    for form in forms:
                        form[2], form[1] = form[0](params, gen[:, i:i + 1],
                                                   form[1], P + i)
    finally:
        attention._mla_absorbed_decode = inner
    torch.cuda.synchronize()
    tf_s = time.perf_counter() - t0
    worst = max(diffs)
    gate = LOGITS_GAP_SHARE * max(bigs)
    log(f"absorbed MLA decode, {cfg.arch_id} ({cfg.n_layers} layers), "
        f"teacher-forced on (a)'s {G} greedy tokens (B = {B}, from position "
        f"{P}; {tf_s:.2f} s for both forms, eager): the absorbed logits' "
        f"largest |diff| from the expanded form's {worst:.5g} over {G + 1} "
        f"steps ({LOGITS_GAP_SHARE} x the largest |logit| {max(bigs):.5g} = "
        f"{gate:.5g}); the worst step's |diff| / its largest |logit| "
        f"{max(d / b for d, b in zip(diffs, bigs)):.4g}, the median step's "
        f"{float(np.median([d / b for d, b in zip(diffs, bigs)])):.4g}; "
        f"steps within it {sum(d <= gate for d in diffs)} of {G + 1} "
        f"(logged: near-tied rows of these peaked scores move with the "
        f"expanded form's bf16 k and v; the prefill's logits, where both "
        f"forms run the same chunks: |diff| {diffs[0]:.3g}); the absorbed "
        f"argmax picks (a)'s token {agree} of {B * G} times")
    if diffs[0] != 0.0 or len(kept) != 2 * len(ABSORB_STEPS):
        raise AssertionError(f"the absorbed run's prefill logits differ "
                             f"({diffs[0]}) or it kept {len(kept)} calls")
    del forms
    gc.collect()
    with torch.no_grad():
        for step, layer, p, q_nope, q_rope, lat, kr, cur_pos, kw in kept:
            exact, pr, v, mask = mla_exact(cfg, p, q_nope, q_rope, lat, kr,
                                           cur_pos, **kw)
            bound, d_max = absorbed_bound(cfg, p, q_nope, q_rope, lat, kr,
                                          exact, pr, v, mask, kw["scale"])
            del pr, v
            absorbed = inner(cfg, p, q_nope.float(), q_rope.float(), lat, kr,
                             cur_pos, **kw)
            k, v = attention._mla_expand(cfg, p, lat, kr, lat.dtype)
            expanded = attention.decode_attend(
                torch.cat([q_nope, q_rope], dim=-1), k, v, cur_pos,
                window=kw["window"], scale=kw["scale"])
            del k, v
            tol = ABSORB_TOL[0] + ABSORB_TOL[1] * exact.abs()
            err_abs = (absorbed.double() - exact).abs()
            err_exp = (expanded.double() - exact).abs()
            r_tol = float((err_abs / tol).max())
            r_gate = float((err_abs / (tol + bound)).max())
            log(f"absorbed MLA attention at teacher-forced step {step}, "
                f"layer {layer} (q {tuple(q_nope.shape)}, latent cache "
                f"{tuple(lat.shape)}, position {cur_pos}): against the exact "
                f"(f64) attention: absorbed (f32) |diff| "
                f"{float(err_abs.max()):.3e}, {r_tol:.4f} x repro's "
                f"tolerance {ABSORB_TOL}, {r_gate:.4f} x that plus its f32 "
                f"rounding bound (largest score bound {d_max:.3g}; entries "
                f"whose bound exceeds the tolerance "
                f"{float((bound > tol).double().mean()):.3%}); expanded (bf16 "
                f"k, v and output; logged) |diff| {float(err_exp.max()):.3e}, "
                f"{float((err_exp / tol).max()):.2f} x the tolerance; |exact| "
                f"up to {float(exact.abs().max()):.4g}")
            if not r_gate <= 1.0:
                raise AssertionError(f"the absorbed MLA attention differs "
                                     f"from the exact one at step {step}, "
                                     f"layer {layer}: {r_gate} x the "
                                     "tolerance and its rounding bound")
    del kept
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    r = fed_abs.decode(params, toks, gen_len=G)
    log(f"absorbed MLA decode through the captured step: "
        f"{B * G / r.decode_s:.1f} tokens/s ({r.decode_s:.4f} s; prefill "
        f"{r.prefill_s:.4f} s; capture {r.graph.capture_s:.4f} s, "
        f"{r.graph.nodes} nodes), peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; tokens equal "
        f"to (a)'s eager decode: "
        f"{int((r.tokens == eager.tokens).sum())} of {B * G}")
    profile_decode(fed_abs, params, serving)
    del r, fed_abs


def mtp_loss_card_vs_cpu(counters) -> None:
    """Phase 9 (d): the global ``lm_loss`` of reduced DeepSeek-V3 in f32
    at MLA's full head dims (the flash kernel's (192, 128) pair on the
    CUDA cores): next-token CE + the MoE aux + 0.3 x the MTP head's loss,
    on the card against the CPU from the same params and batch (1e-4
    relative, the MTP term on its own too); the card's launches: flash at
    each layer and the MTP block, RMSNorm at their ln1 and ln2, the final
    norm and the MTP norm."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import lm_token_batches
    from repro_torch.models import common, transformer
    from repro_torch.models.model_api import build_model
    from repro_torch.tree import tree_map
    cfg = reduced(get_config(DEEPSEEK), param_dtype="float32",
                  dtype="float32", **MLA_FULL_HEADS)
    model = build_model(cfg, max_seq=TRAIN["seq"])
    cpu = common.materialize(model.param_specs,
                             torch.Generator().manual_seed(0))
    card = tree_map(lambda t: t.to("cuda"), cpu)
    nb = next(lm_token_batches(1, cfg.vocab_size, TRAIN["batch"],
                               TRAIN["seq"]))
    batches = {dev: {k: torch.from_numpy(v).to(dev) for k, v in nb.items()}
               for dev in ("cpu", "cuda")}
    with torch.no_grad():
        for c in counters:
            c.reset_launches()
        loss_card, aux_card = model.loss_fn(card, batches["cuda"])
        torch.cuda.synchronize()
        ran = _launches(counters)
        mtp_card = transformer._mtp_loss(cfg, card, batches["cuda"])
        loss_cpu, aux_cpu = model.loss_fn(cpu, batches["cpu"])
        mtp_cpu = transformer._mtp_loss(cfg, cpu, batches["cpu"])
    pairs = {"loss": (loss_card, loss_cpu), "mtp": (mtp_card, mtp_cpu),
             "aux": (aux_card["aux"], aux_cpu["aux"])}
    rel = {k: abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)
           for k, (a, b) in pairs.items()}
    want = {"flash_attention": cfg.n_layers + 1,
            "rmsnorm": 2 * cfg.n_layers + 1 + 3}
    log(f"global lm_loss with MTP, reduced {DEEPSEEK} f32 (d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads, q/k head dim "
        f"{cfg.qk_nope_dim + cfg.qk_rope_dim}, v {cfg.v_head_dim}, "
        f"{cfg.first_k_dense} dense + {cfg.n_layers - cfg.first_k_dense} "
        f"MoE layers), batch {TRAIN['batch']} x {TRAIN['seq']}: card "
        f"{float(loss_card):.6f} vs CPU {float(loss_cpu):.6f}, MTP term "
        f"{float(mtp_card):.6f} vs {float(mtp_cpu):.6f}, aux "
        f"{float(aux_card['aux']):.6g}; relative gaps "
        f"{ {k: f'{v:.3e}' for k, v in rel.items()} } (tol {STEP_TOL}); "
        f"card launches {ran}, derived {want}")
    if not all(v <= STEP_TOL for v in rel.values()):
        raise AssertionError(f"the global loss with MTP differs on the card: "
                             f"{rel}")
    if {k: ran[k] for k in want} != want:
        raise AssertionError(f"the global loss launched {ran}, want {want}")


def deepseek_phase(rows, card, counters, kernels) -> None:
    """Phase 9: DeepSeek-V3 (MLA, first_k_dense, MTP). (a) phase 4's split
    serve path and its checks at full width cut to 5 layers, the captured
    decode held bitwise to the eager one; (b) the absorbed decode on the
    same weights; (c) phase 6's run A at full width cut to 4 layers on
    the paged latent pool; (d) training at full width cut to 4 layers
    and 16 experts, a reduced f32 cascaded step and the reduced f32
    global loss with MTP on the card against the CPU."""
    import dataclasses
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    spent = {}

    def lap(name, t0):
        spent[name] = time.perf_counter() - t0
        return time.perf_counter()

    t0 = time.perf_counter()
    bt, failed = {}, []

    def after(fed, params, cfg, eager):
        # (b) runs on (a)'s session; a failure of its gate is raised at
        # the end of the phase, after (c) and (d) have run and logged.
        # Only its message is kept: the exception's traceback would keep
        # (a)'s session alive
        bt["t"] = time.perf_counter()
        try:
            absorbed_decode(fed, params, cfg, eager)
        except AssertionError as e:
            failed.append(str(e))
            log(f"phase 9 (b) FAILED: {e}")
        bt["s"] = time.perf_counter() - bt["t"]
    serve_phase(rows, DEEPSEEK, counters[0], kernels,
                layers=DEEPSEEK_SERVE_LAYERS, bitwise=True, after=after)
    t0 = lap(f"(a) serve {DEEPSEEK} at {DEEPSEEK_SERVE_LAYERS} layers, with "
             f"(b) the absorbed decode ({bt['s']:.1f} s of it)", t0)
    continuous_phase(rows, card, counters, kernels,
                     archs=((DEEPSEEK, DEEPSEEK_CONT_LAYERS),),
                     label=f"phase 9 (c) continuous {DEEPSEEK}")
    t0 = lap(f"(c) continuous {DEEPSEEK}", t0)
    base = dataclasses.replace(get_config(DEEPSEEK),
                               n_experts=DEEPSEEK_TRAIN["n_experts"])
    train_family(rows, card, counters, DEEPSEEK, DEEPSEEK_TRAIN["layers"],
                 DEEPSEEK_TRAIN["lr"], base=base)
    step_card_vs_cpu(counters, arch=DEEPSEEK, methods=("cascaded",),
                     cfg_kw=MLA_FULL_HEADS)
    mtp_loss_card_vs_cpu(counters)
    lap(f"(d) train {DEEPSEEK}", t0)
    log("phase 9 time: " + "; ".join(f"{name} {sec:.1f} s"
                                     for name, sec in spent.items()))
    log(f"phase 9: {time.perf_counter() - t_phase:.1f} s on {card}")
    if failed:
        raise AssertionError(f"phase 9 (b): {failed[0]}")


# ---------------- phase 10: the multimodal and encoder-decoder families --

WHISPER = "whisper-medium"
INTERNVL = "internvl2-26b"
# (a) Whisper-medium at full width and depth through launch.serve's global
# fallback: 8 requests of 224 prompt + 224 greedy tokens (448, Whisper's
# decoder context), 2 client parties asked for; the encoder runs once, on
# zero frames, before the prefill
WHISPER_SERVE = dict(batch=8, prompt_len=224, gen_len=224, n_clients=2)
# (b) InternVL2-26B at full width and depth: 8 x (256 + 128), text only
INTERNVL_SERVE = dict(batch=8, prompt_len=256, gen_len=128, n_clients=2)
# the checks' own greedy decode through build_model(...).decode_fn (seeded
# N(0, 1) frames for Whisper; text only for InternVL2): prompt, generated
MODAL_CHECK = dict(prompt_len=32, gen_len=32)
# (b) one forward over [256 vision; 768 text] positions
VLM_TEXT = 768
# a teacher-forced decoded token's gap (the full forward's max logit
# minus its logit of the chosen token), as a share of the largest |logit|
GAP_SHARE = 2e-2
# (c) training at full width through launch.train.train at the CLI's
# defaults (8 x 128 tokens, cascaded, q = 1, 10 steps): Whisper at full
# depth, InternVL2 cut to 8 layers (the functional SGD's f32 copies of a
# stacked leaf: 120 GB at 48 layers); (arch, layers, gated server lr)
MODAL_TRAIN = ((WHISPER, 0, 0.01), (INTERNVL, 8, 0.01))
# (d) the reduced Whisper decode held card against CPU, tokens
MODAL_DECODE_STEPS = 8
# (a) the f32 teacher-forced check's encoder and decoder depth
WHISPER_F32_LAYERS = 4


def modal_inputs(cfg, batch: int, g, device="cuda"):
    """Seeded N(0, 1) stub-frontend inputs in bf16: ``frames`` for an
    encoder-decoder, ``patch_embeds`` for a VLM (never the launchers'
    zeros, which leave the projector's input zero and hide it)."""
    if cfg.is_encoder_decoder:
        shape, key = (batch, cfg.encoder_seq, cfg.frontend_dim), "frames"
    else:
        shape, key = (batch, cfg.n_vision_tokens, cfg.frontend_dim), \
            "patch_embeds"
    return {key: torch.randn(shape, generator=g, device=device).to(
        torch.bfloat16)}


def modal_serve_plan(cfg, steps: int) -> dict:
    """Launches of one global serve call of ``steps`` decode_fn calls
    (prompt + generated, token by token): Whisper's encoder runs flash
    once a layer, and every step each decoder layer's cross-attention
    (its self-attention takes the plain decode attention); it runs
    LayerNorm (no RMSNorm kernel). InternVL2's steps run RMSNorm at ln1
    and ln2 of each layer and the final norm, and no flash (S = 1)."""
    if cfg.is_encoder_decoder:
        return {"flash_attention": cfg.n_encoder_layers
                + cfg.n_layers * steps, "rmsnorm": 0, "ssd_chunk": 0}
    return {"flash_attention": 0, "rmsnorm": (2 * cfg.n_layers + 1) * steps,
            "ssd_chunk": 0}


def modal_serve(rows, counters, arch, traffic) -> dict:
    """``launch.serve.serve`` of ``arch`` at full width and depth with
    n_clients >= 1: the global fallback with ``repro``'s note, launches
    equal to their derivation, prefill s, decode tokens/s, the encoder's
    time, peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_mod
    cfg = get_config(arch)
    for c in counters:
        c.reset_launches()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = serve_mod.serve(arch, use_reduced=False, temperature=0.0,
                          **traffic)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches(counters)
    steps = traffic["prompt_len"] + traffic["gen_len"]
    want = modal_serve_plan(cfg, steps)
    log(f"serve {arch} full width and depth ({cfg.n_layers} layers"
        + (f" + {cfg.n_encoder_layers} encoder layers over "
           f"{cfg.encoder_seq} frames" if cfg.is_encoder_decoder else "")
        + f", d_model {cfg.d_model}, {cfg.param_count() / 1e9:.3f} B "
        f"params, bf16), batch {traffic['batch']}, prompt "
        f"{traffic['prompt_len']} + {traffic['gen_len']} greedy, "
        f"{traffic['n_clients']} client parties asked: mode {res['mode']}, "
        f"fallback {res.get('fallback')!r}; "
        + (f"encoder {res['encode_s']:.4f} s (on its own, before the "
           f"prefill), " if cfg.is_encoder_decoder else "")
        + f"prefill {res['prefill_s']:.4f} s (token by token), "
        f"decode {res['decode_s']:.4f} s = {res['decode_tok_per_s']:.1f} "
        f"tokens/s; whole call {wall:.2f} s (weights drawn on the card "
        f"included); peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB; final logits max |.| {res['final_logits_absmax']:.4g}; "
        f"launches {launches}, derived {want}")
    pg, dg = res["prefill_graph"], res["decode_graph"]
    if pg is None or dg is None:
        raise AssertionError(f"{arch}: the global serve captured no graph")
    log(f"serve {arch}: prefill through {pg['replays']} replays of the "
        f"captured step (capture {pg['capture_s']:.4f} s, {pg['nodes']} "
        f"nodes, {pg['kernel_nodes']} kernel nodes; {pg['replay_s']:.4f} s "
        f"of replays), decode through {dg['replays']} replays (capture "
        f"{dg['capture_s']:.4f} s, {dg['nodes']} nodes, "
        f"{dg['kernel_nodes']} kernel nodes; "
        f"{dg['replay_s'] * 1e3 / dg['replays']:.4f} ms a step); a decode "
        f"replay launches {dg['launches_a_replay']}")
    if res["mode"] != "global" or "fallback" not in res:
        raise AssertionError(f"{arch} did not take the global fallback: "
                             f"{res}")
    if {k: launches[k] for k in want} != want or any(
            launches[k] for k in launches if k not in want):
        raise AssertionError(f"{arch} serve launches {launches}, want "
                             f"{want}")
    for name, n in want.items():
        if n:
            rows[name]["launches"] += n
            rows[name].setdefault("launches_by_path", {})[
                f"serve:{arch}"] = n
    return res


def decode_graph_vs_eager(what, model, params, cfg, toks, extra, eager,
                          counters) -> dict:
    """``launch.serve.global_decode`` of ``toks`` for MODAL_CHECK's
    generation through the captured prefill and decode steps against
    ``eager``, :func:`greedy_decode`'s result on the same weights, prompts
    and ``extra``: greedy tokens and final logits bitwise equal; the graph
    run's flash and RMSNorm launches (replays included) equal to their
    derivation; then the graph run again under torch.profiler, the
    device's busy share read over the decode replays alone."""
    from repro_torch import graphs
    from repro_torch.launch import serve as serve_mod
    from torch.profiler import ProfilerActivity, profile
    B, P = toks.shape
    G = MODAL_CHECK["gen_len"]

    def run():
        caches = serve_mod._zero_caches(cfg, B, P + G, "cuda")
        return serve_mod.global_decode(
            model, params, toks, caches, extra, gen_len=G, temperature=0.0,
            vocab_size=cfg.vocab_size)
    eager_toks, eager_logits, eager_s = eager
    for c in counters:
        c.reset_launches()
    got = run()
    ran = _launches(counters)
    want = modal_serve_plan(cfg, P + G)
    if cfg.is_encoder_decoder:
        want["flash_attention"] -= cfg.n_encoder_layers   # no encoder here
    same = (torch.equal(got["tokens"], eager_toks)
            and torch.equal(got["logits"], eager_logits))
    pg, dg = got["prefill_graph"], got["decode_graph"]
    log(f"{what}: {B} x ({P} + {G}) greedy through the captured steps "
        f"against the eager loop: tokens and final logits bitwise equal "
        f"{same}; prefill {got['prefill_s']:.4f} s (eager "
        f"{eager_s[0]:.4f} s), decode "
        f"{B * G / got['decode_s']:.1f} tokens/s (eager "
        f"{B * G / eager_s[1]:.1f}); captures {pg['capture_s']:.4f} "
        f"+ {dg['capture_s']:.4f} s ({pg['nodes']} and {dg['nodes']} "
        f"nodes); launches {ran}, derived {want}")
    if not same:
        raise AssertionError(f"{what}: the captured decode differs from the "
                             "eager loop")
    if {k: ran[k] for k in want} != want:
        raise AssertionError(f"{what}: launches {ran}, want {want}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_res = run()
    dg = prof_res["decode_graph"]
    wall_us, n = dg["replay_s"] * 1e6, dg["replays"]
    events = device_events(prof)
    spans = [(e.time_range.start, e.time_range.end) for e in events]
    if not spans:
        raise AssertionError(f"{what}: the profiler saw no device event")
    lo, hi = busy_window(prof, spans, wall_us, after=graphs.REPLAYS_START)
    inside = [e for e in events
              if e.time_range.start >= lo and e.time_range.end <= hi]
    busy = busy_union(f"{what}: decode replays", prof, wall_us,
                      sum(e.time_range.elapsed_us() for e in inside),
                      after=graphs.REPLAYS_START)
    log(f"{what}: {n} decode replays under torch.profiler: wall "
        f"{wall_us / n / 1e3:.4f} ms a step, device busy "
        f"{busy / n / 1e3:.4f} ms a step ({busy / wall_us:.2%}), "
        f"{len(inside) / n:.1f} device events a step "
        f"({dg['kernel_nodes']} kernel nodes)")
    return dict(prefill_s=got["prefill_s"],
                decode_tok_per_s=B * G / got["decode_s"],
                eager_decode_tok_per_s=B * G / eager_s[1],
                capture_s=[pg["capture_s"], dg["capture_s"]],
                busy_share=busy / wall_us)


def greedy_decode(model, params, cfg, toks, gen_len, extra,
                  cache_dtype=None):
    """Token-by-token greedy decode through ``decode_fn`` over zero caches
    (bf16, the global serve path's, unless ``cache_dtype``), at Python-int
    positions: (generated (B, G), the last step's logits, (prefill s,
    decode s) synchronised)."""
    from repro_torch.federation import serving
    from repro_torch.models.model_api import build_cache_specs
    from repro_torch.tree import tree_map
    B, P = toks.shape
    caches = tree_map(lambda s: torch.zeros(s.shape, device="cuda",
                                            dtype=getattr(
                                                torch, cache_dtype or s.dtype)),
                      build_cache_specs(cfg, B, P + gen_len))
    logits = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(P):
        logits, caches = model.decode_fn(
            params, {"tokens": toks[:, t:t + 1], **extra}, caches, t)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    gen = torch.empty((B, gen_len), dtype=torch.int32, device="cuda")
    for i in range(gen_len):
        gen[:, i] = serving.sample_token(logits, P + i, 0.0, cfg.vocab_size)
        logits, caches = model.decode_fn(
            params, {"tokens": gen[:, i:i + 1], **extra}, caches, P + i)
    torch.cuda.synchronize()
    return gen, logits, (t1 - t0, time.perf_counter() - t1)


@contextlib.contextmanager
def plain_kernels(kernels):
    """Inside the ``with``, the models' flash-attention and RMSNorm calls
    go to the plain versions (the wrappers' module attributes replaced,
    as ``Capture`` does): the same function evaluated another way."""
    (fo, fr), (ro, rr) = kernels["flash_attention"], kernels["rmsnorm"]
    inner = fo.flash_attention_bshd, ro.rmsnorm
    fo.flash_attention_bshd = fr.flash_attention_bshd_ref
    ro.rmsnorm = lambda x, scale, *, eps=1e-6: rr.rmsnorm_ref(x, scale, eps)
    try:
        yield
    finally:
        fo.flash_attention_bshd, ro.rmsnorm = inner


def forced_logits(model, params, toks, gen, extra):
    """The full forward on prompt + decoded tokens: the (B x G, vocab)
    logits at the positions that predict the decoded tokens."""
    P, G = toks.shape[1], gen.shape[1]
    full = model.forward_fn(params, {"tokens": torch.cat(
        [toks, gen.to(toks.dtype)], 1), **extra})
    return full[:, P - 1:P + G - 1].float().reshape(-1, full.shape[-1])


def teacher_forced(what, model, params, cfg, toks, gen, extra,
                   kernels=None) -> None:
    """The full forward (flash and RMSNorm on the card) on prompt + the
    decoded tokens: each decoded token's gap (the forward's max logit
    minus its logit of the chosen token, at the position before it) at
    most GAP_SHARE x the largest |logit|. With ``kernels``, the gate is
    the larger of that and twice the same gap that the forward's own bf16
    rounding gives: the forward through the plain versions and the
    kernels' forward, each one's greedy picks judged by the other's
    logits (the worse of the two). On random weights
    whose residual stream dwarfs what its norms keep, bf16 evaluations in
    another order move near-tied logits that far (the repo's rule for an
    ill-conditioned function: twice the reference's own error)."""
    ref = forced_logits(model, params, toks, gen, extra)
    gap = picked_gap(ref, gen.reshape(-1).cpu().numpy(), cfg.vocab_size)
    big = float(ref.abs().max())
    gate, own = GAP_SHARE * big, ""
    if kernels is not None:
        with plain_kernels(kernels):
            plain = forced_logits(model, params, toks, gen, extra)
        # each forward's greedy picks judged by the other's logits
        picks = plain.argmax(-1).clamp(max=cfg.vocab_size - 1)
        noise = max(picked_gap(ref, picks.cpu().numpy(), cfg.vocab_size),
                    picked_gap(plain, ref.argmax(-1).clamp(
                        max=cfg.vocab_size - 1).cpu().numpy(),
                        cfg.vocab_size))
        diff = float((plain - ref).abs().max())
        agree = float((picks == ref.argmax(-1).clamp(
            max=cfg.vocab_size - 1)).float().mean())
        gate = max(gate, 2.0 * noise)
        own = (f"; the kernels' and the plain versions' forwards, each "
               f"one's picks under the other's logits: gap {noise:.5g} "
               f"({noise / big:.4g}), logits "
               f"|diff| {diff:.4g}, argmax agreeing {agree:.2%}; gate max("
               f"{GAP_SHARE} x the largest |logit|, 2 x that gap) = "
               f"{gate:.5g}")
        del plain
    log(f"{what}: {gen.numel()} greedy tokens teacher-forced through the "
        f"full forward: worst gap {gap:.5g} ({gap / big:.4g} of the largest "
        f"|logit| {big:.5g}){own}")
    if not gap <= gate:
        raise AssertionError(f"{what}: the decoded tokens' teacher-forced "
                             f"gap {gap} exceeds {gate}")


def profile_eager(what, fn) -> None:
    """One eager call of ``fn`` under torch.profiler, its device time by
    family (``split_profile``)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiler_warmup()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    log_profile(what, split_profile(prof, wall_us))


def whisper_checks(rows, counters, kernels) -> None:
    """Phase 10 (a)'s checks on seeded N(0, 1) frames through
    ``build_model(...).decode_fn`` at full width and depth: flash held to
    its plain version on the encoder's first and last layer and the
    first and last cross-attention call; the encoder's and a decode
    step's time and profile by kernel family, and the share of a step the
    cross-attention K and V projections take (recomputed from enc_out
    every step, as in ``repro``); the decode teacher-forced through the
    full forward (``teacher_forced``'s rule), in bf16 at full depth and on
    an f32 copy of the weights cut to WHISPER_F32_LAYERS encoder and
    decoder layers over f32 caches."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import common, encdec
    from repro_torch.models.model_api import build_cache_specs, build_model
    from repro_torch.tree import tree_map
    flash_ops, flash_ref = kernels["flash_attention"]
    cfg = get_config(WHISPER)
    B, P, G = WHISPER_SERVE["batch"], MODAL_CHECK["prompt_len"], \
        MODAL_CHECK["gen_len"]
    Le, L = cfg.n_encoder_layers, cfg.n_layers
    model = build_model(cfg, max_seq=P + G)
    params = common.materialize(model.param_specs,
                                torch.Generator("cuda").manual_seed(0),
                                device="cuda")
    g = torch.Generator("cuda").manual_seed(10)
    frames = modal_inputs(cfg, B, g)
    toks = serve_mod._prompts(cfg, B, P, 0, "cuda")
    n_cross = L * (P + G)
    keep = [0, Le - 1, Le, Le + n_cross - 1]
    for c in counters:
        c.reset_launches()
    with torch.no_grad(), Capture(flash_ops, KERNEL_ENTRIES[
            "flash_attention"], keep) as cap:
        enc_out = encdec.encode(cfg, params, frames["frames"])
        eager = greedy_decode(model, params, cfg, toks, G,
                              {"enc_out": enc_out})
        gen = eager[0]
    torch.cuda.synchronize()
    ran = _launches(counters)["flash_attention"]
    log(f"whisper decode on seeded frames ({B} x ({P} + {G})): flash "
        f"launches {ran}, derived {Le + n_cross} (encoder {Le} + {L} cross "
        f"calls x {P + G} steps)")
    if ran != Le + n_cross or len(cap.inputs) != len(keep):
        raise AssertionError(f"whisper decode launched flash {ran} times, "
                             f"want {Le + n_cross}")
    names = {0: "encoder layer 0", Le - 1: f"encoder layer {Le - 1}",
             Le: "cross call 0 (step 0, layer 0)",
             Le + n_cross - 1: f"cross call {n_cross - 1} (step "
                               f"{P + G - 1}, layer {L - 1})"}
    err = hold_calls(
        "flash_attention", flash_ops, flash_ref, cap.inputs,
        lambda i, args, kw: f"{names[i]}, q {tuple(args[0].shape)}, k "
                            f"{tuple(args[1].shape)}, causal "
                            f"{kw.get('causal')}", "whisper decode")
    rows["flash_attention"].setdefault("serve_max_abs_err", {})[WHISPER] = err
    del cap
    with torch.no_grad():
        # the encoder's and one decode step's device time, and the cross
        # K/V projections' share of the step
        enc_ms = event_ms(lambda: encdec.encode(cfg, params,
                                                frames["frames"]), 5)
        caches = tree_map(lambda s: torch.zeros(s.shape, device="cuda",
                                                dtype=getattr(torch,
                                                              s.dtype)),
                          build_cache_specs(cfg, B, P + G))
        one = toks[:, :1]

        def step():
            return model.decode_fn(params, {"tokens": one,
                                            "enc_out": enc_out}, caches, P)
        step_ms = event_ms(step, 20)
        wk, wv = (params["blocks"]["xattn"][w] for w in ("wk", "wv"))

        def kv():
            for i in range(L):
                enc_out @ wk[i]
                enc_out @ wv[i]
        kv_ms = event_ms(kv, 20)
        kv_flop = 2 * 2 * B * cfg.encoder_seq * cfg.d_model ** 2 * L
        log(f"whisper encoder (B = {B}, {Le} layers over {cfg.encoder_seq} "
            f"frames, warm): {enc_ms:.4f} ms; decode step (B = {B}, eager, "
            f"{L} layers): {step_ms:.4f} ms; the cross-attention K and V "
            f"projections from enc_out alone ({L} x 2 GEMMs of "
            f"({B * cfg.encoder_seq}, {cfg.d_model}) x ({cfg.d_model}, "
            f"{cfg.d_model}), {kv_flop / 1e12:.4f} TFLOP) {kv_ms:.4f} ms = "
            f"{kv_ms / step_ms:.2%} of the step "
            f"({kv_flop / kv_ms / 1e9:.1f} TFLOP/s; at 989 TFLOP/s "
            f"{kv_flop / 989e12 * 1e3:.4f} ms)")
        rows["flash_attention"].setdefault("whisper_decode", {}).update(
            encoder_ms=enc_ms, step_ms=step_ms, cross_kv_ms=kv_ms,
            cross_kv_share=kv_ms / step_ms)
        profile_eager(f"whisper encoder (B = {B})",
                      lambda: encdec.encode(cfg, params, frames["frames"]))
        profile_eager(f"whisper decode step (eager, B = {B})", step)
        del caches
        teacher_forced(f"serve {WHISPER} (seeded frames, bf16)", model,
                       params, cfg, toks, gen, frames, kernels)
    rows["flash_attention"].setdefault("whisper_decode", {})["graph"] = \
        decode_graph_vs_eager(f"global decode {WHISPER}", model, params,
                              cfg, toks, {"enc_out": enc_out}, eager,
                              counters)
    del params, enc_out, model
    gc.collect()
    torch.cuda.empty_cache()
    # the same check in f32 (weights and caches) at full width cut to
    # WHISPER_F32_LAYERS encoder and decoder layers: at full depth two f32
    # evaluations of this random-weight model pick the same greedy token
    # under 4% of the time (PERF.md), so only a shallower stack tells a
    # path fault from rounding
    import dataclasses
    cut = dataclasses.replace(cfg, n_layers=WHISPER_F32_LAYERS,
                              n_encoder_layers=WHISPER_F32_LAYERS)
    model = build_model(cut, max_seq=P + G)
    params = common.materialize(model.param_specs,
                                torch.Generator("cuda").manual_seed(0),
                                device="cuda", dtype_override="float32")
    frames32 = {"frames": frames["frames"].float()}
    with torch.no_grad():
        enc_out = encdec.encode(cut, params, frames32["frames"])
        gen = greedy_decode(model, params, cut, toks, G,
                            {"enc_out": enc_out}, cache_dtype="float32")[0]
        teacher_forced(f"serve {WHISPER} (seeded frames, f32 weights and "
                       f"caches, {WHISPER_F32_LAYERS} + {WHISPER_F32_LAYERS} "
                       f"layers)", model, params, cut, toks, gen, frames32,
                       kernels)
    del params, enc_out, model
    gc.collect()
    torch.cuda.empty_cache()


def internvl_checks(rows, counters, kernels) -> None:
    """Phase 10 (b)'s checks at full width and depth: one ``forward_fn``
    over seeded patch embeddings (8, 256, 3200) and 768 text tokens (1024
    positions: flash at GQA 6:1 and d = 128 a layer, RMSNorm at (8192,
    6144)), both kernels held on its first and last layer, its time; then
    the text-only decode teacher-forced through the text-only forward
    (``teacher_forced``'s rule), in bf16 at full depth and on an f32 copy
    of the weights cut to MODAL_TRAIN's 8 layers (80 GB at 48) over f32
    caches."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import common
    from repro_torch.models.model_api import build_model
    cfg = get_config(INTERNVL)
    B, L = INTERNVL_SERVE["batch"], cfg.n_layers
    Nv = cfg.n_vision_tokens
    model = build_model(cfg, max_seq=Nv + VLM_TEXT)
    params = common.materialize(model.param_specs,
                                torch.Generator("cuda").manual_seed(0),
                                device="cuda")
    g = torch.Generator("cuda").manual_seed(11)
    patches = modal_inputs(cfg, B, g)
    text = serve_mod._prompts(cfg, B, VLM_TEXT, 1, "cuda")
    inputs = {"tokens": text, **patches}
    keep = {"flash_attention": [0, L - 1],
            "rmsnorm": [0, 1, 2 * L - 2, 2 * L - 1]}
    for c in counters:
        c.reset_launches()
    before = dict(kernels["rmsnorm"][0].route_launches)
    with torch.no_grad(), contextlib.ExitStack() as stack:
        caps = {name: stack.enter_context(Capture(
            kernels[name][0], KERNEL_ENTRIES[name], at))
            for name, at in keep.items()}
        logits = model.forward_fn(params, inputs)
        torch.cuda.synchronize()
    ran = _launches(counters)
    routes = {k: v - before[k] for k, v in
              kernels["rmsnorm"][0].route_launches.items()}
    want = {"flash_attention": L, "rmsnorm": 2 * L + 1}
    finite = bool(torch.isfinite(logits.float()).all())
    log(f"forward {INTERNVL} full width and depth over [{Nv} vision; "
        f"{VLM_TEXT} text] positions, B = {B}: logits "
        f"{tuple(logits.shape)}, finite {finite}, max |.| "
        f"{float(logits.float().abs().max()):.4g}; launches "
        f"{ {k: ran[k] for k in want} }, derived {want}; RMSNorm routes "
        f"{routes}")
    if (logits.shape[:2] != (B, Nv + VLM_TEXT) or not finite
            or {k: ran[k] for k in want} != want
            or routes != {"vector": want["rmsnorm"], "general": 0}):
        raise AssertionError(f"the {INTERNVL} vision forward gave "
                             f"{tuple(logits.shape)} (finite {finite}) with "
                             f"launches {ran}, routes {routes}")
    del logits
    for name, cap in caps.items():
        rows[name].setdefault("serve_max_abs_err", {})[
            f"{INTERNVL}:vision_forward"] = hold_calls(
            name, *kernels[name], cap.inputs,
            lambda i, args, kw: (f"layer {i // 2 if name == 'rmsnorm' else i}"
                                 f", {tuple(args[0].shape)}"
                                 + (f", k {tuple(args[1].shape)}"
                                    if name == "flash_attention" else "")),
            "vision forward")
    del caps
    with torch.no_grad():
        fwd_ms = event_ms(lambda: model.forward_fn(params, inputs), 2)
    log(f"forward {INTERNVL} over 1024 positions (B = {B}): {fwd_ms:.2f} ms "
        f"a call (CUDA events, 2 calls after 3 warm-up)")
    rows["flash_attention"].setdefault("internvl2_vision_forward", {})[
        "ms"] = fwd_ms
    del inputs, patches
    gc.collect()
    P, G = MODAL_CHECK["prompt_len"], MODAL_CHECK["gen_len"]
    toks = serve_mod._prompts(cfg, B, P, 0, "cuda")
    with torch.no_grad():
        eager = greedy_decode(model, params, cfg, toks, G, {})
        gen = eager[0]
        teacher_forced(f"serve {INTERNVL} (text only, bf16)", model, params,
                       cfg, toks, gen, {}, kernels)
    rows["rmsnorm"].setdefault("internvl2_decode", {})["graph"] = \
        decode_graph_vs_eager(f"global decode {INTERNVL}", model, params,
                              cfg, toks, {}, eager, counters)
    with torch.no_grad():
        # one decode step's device time and profile by kernel family
        from repro_torch.models.model_api import build_cache_specs
        from repro_torch.tree import tree_map
        caches = tree_map(lambda s: torch.zeros(
            s.shape, device="cuda", dtype=getattr(torch, s.dtype)),
            build_cache_specs(cfg, B, INTERNVL_SERVE["prompt_len"]
                              + INTERNVL_SERVE["gen_len"]))
        one = toks[:, :1]

        def step():
            return model.decode_fn(params, {"tokens": one}, caches,
                                   INTERNVL_SERVE["prompt_len"])
        step_ms = event_ms(step, 10)
        log(f"{INTERNVL} decode step (B = {B}, eager, {L} layers, cache of "
            f"{INTERNVL_SERVE['prompt_len'] + INTERNVL_SERVE['gen_len']}): "
            f"{step_ms:.4f} ms (CUDA events; {cfg.param_count() * 2 / 1e9:.1f}"
            f" GB of bf16 weights read at 3.35 TB/s: "
            f"{cfg.param_count() * 2 / PEAK_BYTES * 1e3:.2f} ms)")
        rows["rmsnorm"].setdefault("internvl2_decode", {})["step_ms"] = \
            step_ms
        profile_eager(f"{INTERNVL} decode step (eager, B = {B})", step)
        del caches
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.configs import cut_depth
    layers = dict((a, n) for a, n, _ in MODAL_TRAIN)[INTERNVL]
    cut = cut_depth(cfg, layers)
    model = build_model(cut, max_seq=P + G)
    params = common.materialize(model.param_specs,
                                torch.Generator("cuda").manual_seed(0),
                                device="cuda", dtype_override="float32")
    with torch.no_grad():
        gen = greedy_decode(model, params, cut, toks, G, {},
                            cache_dtype="float32")[0]
        teacher_forced(f"serve {INTERNVL} (text only, f32 weights and "
                       f"caches, {layers} layers)", model, params, cut,
                       toks, gen, {}, kernels)
    del params, model
    gc.collect()
    torch.cuda.empty_cache()


def modal_projector_step(arch, layers) -> None:
    """Phase 10 (c): one ``fed.sync_step`` of ``arch`` at full width cut
    to ``layers`` on seeded N(0, 1) frames or patch embeddings, with
    normal directions at μ = 0.1 (a sphere perturbation over the client's
    tens of millions of entries is below half a bf16 step of each, so
    its lanes would round to the clean one): the perturbed loss differs
    from the clean one and the projector's weights move."""
    from repro_torch.configs import VFLConfig, cut_depth, get_config
    from repro_torch.core.draws import StepDraws
    from repro_torch.data import BatchIterator, lm_token_batches
    from repro_torch.federation import Federation
    from repro_torch.models import common
    from repro_torch.optim import sgd
    cfg = cut_depth(get_config(arch), layers)
    fed = Federation.build(cfg, VFLConfig(**STEP_VFL), seq_len=TRAIN["seq"])
    params = common.materialize(fed.model.param_specs,
                                torch.Generator("cuda").manual_seed(0),
                                device="cuda")
    batch = next(iter(BatchIterator(lm_token_batches(
        1, cfg.vocab_size, TRAIN["batch"], TRAIN["seq"]), "cuda")))
    batch.update(modal_inputs(cfg, TRAIN["batch"],
                              torch.Generator("cuda").manual_seed(12)))
    opt = sgd(STEP_VFL["lr_server"])
    w0 = params["proj"]["w"].clone()
    new, _, out = fed.sync_step(opt)(params, opt.init(params), batch, 0,
                                     StepDraws(0, "cuda"))
    moved = float((new["proj"]["w"].float() - w0.float()).abs().max())
    share = float((new["proj"]["w"] != w0).float().mean())
    log(f"train {arch} ({cfg.n_layers} layers): one sync_step on seeded "
        f"N(0, 1) {list(batch)[-1]} ({STEP_VFL}): loss {float(out.loss):.6f},"
        f" perturbed {float(out.loss_perturbed):.6f}, |g_c| "
        f"{float(out.grad_client_norm):.4g}; proj.w moved by up to "
        f"{moved:.4g} in {share:.2%} of its entries")
    if not (moved > 0 and float(out.loss_perturbed) != float(out.loss)):
        raise AssertionError(f"{arch}: the projector did not move in a "
                             "sync step on seeded inputs")
    del fed, params, new
    gc.collect()
    torch.cuda.empty_cache()


def modal_loss_card_vs_cpu(counters, arch) -> None:
    """Phase 10 (d): the global loss of reduced ``arch`` in f32 on seeded
    N(0, 1) frames or patch embeddings, on the card against the CPU from
    the same params and batch (1e-4 relative), with the card's launches
    against their derivation."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import lm_token_batches
    from repro_torch.models import common
    from repro_torch.models.model_api import build_model
    from repro_torch.tree import tree_map
    cfg = reduced(get_config(arch), param_dtype="float32", dtype="float32")
    model = build_model(cfg, max_seq=TRAIN["seq"])
    cpu = common.materialize(model.param_specs,
                             torch.Generator().manual_seed(0))
    card = tree_map(lambda t: t.to("cuda"), cpu)
    nb = next(lm_token_batches(1, cfg.vocab_size, TRAIN["batch"],
                               TRAIN["seq"]))
    extra = modal_inputs(cfg, TRAIN["batch"],
                         torch.Generator().manual_seed(13), device="cpu")
    batches = {dev: {**{k: torch.from_numpy(v).to(dev)
                        for k, v in nb.items()},
                     **{k: v.to(dev) for k, v in extra.items()}}
               for dev in ("cpu", "cuda")}
    with torch.no_grad():
        for c in counters:
            c.reset_launches()
        loss_card, _ = model.loss_fn(card, batches["cuda"])
        torch.cuda.synchronize()
        ran = _launches(counters)
        loss_cpu, _ = model.loss_fn(cpu, batches["cpu"])
    rel = abs(float(loss_card) - float(loss_cpu)) / abs(float(loss_cpu))
    sites, _, block_norms, final_norm = kernel_sites(cfg)
    want = {"flash_attention": sites, "rmsnorm": block_norms + final_norm}
    log(f"global loss, reduced {arch} f32 on seeded inputs, batch "
        f"{TRAIN['batch']} x {TRAIN['seq']}: card {float(loss_card):.7f} vs "
        f"CPU {float(loss_cpu):.7f}, relative gap {rel:.3e} (tol "
        f"{STEP_TOL}); card launches {ran}, derived {want}")
    if not rel <= STEP_TOL or {k: ran[k] for k in want} != want:
        raise AssertionError(f"reduced {arch}'s global loss on the card: "
                             f"gap {rel}, launches {ran}")


def whisper_decode_card_vs_cpu(counters) -> None:
    """Phase 10 (d): reduced Whisper in f32 on seeded frames, the encoder
    and MODAL_DECODE_STEPS decode steps over f32 caches (the same tokens
    fed on both sides) on the card (flash f32: the encoder non-causal at
    Se x Se, each cross call at Sq = 1) against the CPU: every step's
    logits within 1e-4 of the CPU's largest |logit| plus twice the CPU
    run's own f32 error there, read as what the same CPU run moves by
    when every weight is perturbed by a relative N(0, sqrt(K) 2^-24),
    K = d_ff the longest reduction of a layer (one f32 dot product of K
    terms rounds about sqrt(K) times the unit roundoff: the backward
    error of one f32 evaluation). This random-init model is that
    sensitive: a relative 1e-7 nudge moves its logits by about 4e-3 of
    2.3 on the CPU, where its decode equals its full forward bitwise."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import common, encdec
    from repro_torch.models.model_api import build_cache_specs, build_model
    from repro_torch.tree import tree_map
    cfg = reduced(get_config(WHISPER), param_dtype="float32",
                  dtype="float32")
    n, B = MODAL_DECODE_STEPS, TRAIN["batch"]
    model = build_model(cfg, max_seq=n)
    cpu = common.materialize(model.param_specs,
                             torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(16)
    rel = math.sqrt(cfg.d_ff) * 2.0 ** -24
    nudged = tree_map(lambda t: t * (1 + rel * torch.randn(
        t.shape, generator=g)), cpu)
    frames = modal_inputs(cfg, B, torch.Generator().manual_seed(14),
                          device="cpu")["frames"]
    toks = torch.randint(0, cfg.vocab_size, (B, n),
                         generator=torch.Generator().manual_seed(15))
    logits = {}
    for name, dev, weights in (("cuda", "cuda", cpu), ("cpu", "cpu", cpu),
                               ("nudged", "cpu", nudged)):
        params = tree_map(lambda t: t.to(dev), weights)
        caches = tree_map(lambda s: torch.zeros(s.shape, device=dev),
                          build_cache_specs(cfg, B, n))
        for c in counters:
            c.reset_launches()
        with torch.no_grad():
            enc = encdec.encode(cfg, params, frames.to(dev))
            steps = []
            for t in range(n):
                lg, caches = model.decode_fn(
                    params, {"tokens": toks[:, t:t + 1].to(dev),
                             "enc_out": enc}, caches, t)
                steps.append(lg.cpu())
        if dev == "cuda":
            torch.cuda.synchronize()
            ran = _launches(counters)
        logits[name] = torch.stack(steps)
    big = float(logits["cpu"].abs().max())
    worst = float((logits["cuda"] - logits["cpu"]).abs().max())
    own = float((logits["nudged"] - logits["cpu"]).abs().max())
    tol = 1e-4 * max(big, 1.0) + 2 * own
    want = cfg.n_encoder_layers + cfg.n_layers * n
    log(f"decode, reduced {WHISPER} f32 on seeded frames, B = {B}, {n} "
        f"steps: card vs CPU logits |diff| {worst:.3e} (tol 1e-4 x "
        f"{big:.4g} + 2 x {own:.3e}, the CPU logits' move under a "
        f"relative {rel:.3g} nudge of every weight = {tol:.3e}); card flash "
        f"launches "
        f"{ran['flash_attention']}, derived {want}")
    if not worst <= tol or ran["flash_attention"] != want:
        raise AssertionError(f"reduced {WHISPER}'s decode on the card: "
                             f"|diff| {worst} (tol {tol}), flash "
                             f"{ran['flash_attention']}")


def modal_phase(rows, card, counters, kernels) -> None:
    """Phase 10: the multimodal (InternVL2-26B) and encoder-decoder
    (Whisper-medium) families. (a) Whisper serving at full width and
    depth; (b) InternVL2 serving at full width and depth and its vision
    forward; (c) training through launch.train.train (Whisper at full
    depth, InternVL2 cut to 8 layers) and the projector moving in a sync
    step on seeded inputs; (d) the reduced configs in f32 on the card
    against the CPU. (e), the flash kernel at these families' shapes, is
    in phase 2."""
    t_phase = time.perf_counter()
    spent = {}

    def lap(name, t0):
        spent[name] = time.perf_counter() - t0
        return time.perf_counter()

    t0 = time.perf_counter()
    res = modal_serve(rows, counters, WHISPER, WHISPER_SERVE)
    rows["flash_attention"].setdefault("whisper_serve", {}).update(
        prefill_s=res["prefill_s"], encode_s=res["encode_s"],
        decode_tok_per_s=res["decode_tok_per_s"])
    whisper_checks(rows, counters, kernels)
    t0 = lap(f"(a) serve {WHISPER}", t0)
    modal_serve(rows, counters, INTERNVL, INTERNVL_SERVE)
    internvl_checks(rows, counters, kernels)
    t0 = lap(f"(b) serve {INTERNVL}", t0)
    for arch, layers, lr in MODAL_TRAIN:
        train_family(rows, card, counters, arch, layers, lr, profile=True)
        modal_projector_step(arch, layers)
    t0 = lap("(c) train", t0)
    for arch in (WHISPER, INTERNVL):
        step_card_vs_cpu(counters, arch=arch, methods=("cascaded",))
        modal_loss_card_vs_cpu(counters, arch)
    whisper_decode_card_vs_cpu(counters)
    lap("(d) reduced f32 card vs CPU", t0)
    log("phase 10 time: " + "; ".join(f"{name} {sec:.1f} s"
                                      for name, sec in spent.items()))
    log(f"phase 10: {time.perf_counter() - t_phase:.1f} s on {card}")


def count_mma(build, name: str, pattern: str) -> int:
    """Tensor-core instructions (``pattern``: HGMMA for wgmma, HMMA for
    mma.sync) in the built library ``name``'s SASS."""
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    out = subprocess.run(
        [str(cuobjdump), "--dump-sass", str(build.library_path(name))],
        capture_output=True, text=True, timeout=300, check=True).stdout
    return len(re.findall(pattern, out))


# ------------------ phase 11: the sharded engine and the analysis plane --

SHARD = dict(rounds=500, warm=20, profile=20, methods=25)
# the methods held bitwise sharded vs unsharded besides cascaded: (method,
# fused lanes, lr); zoo-vfl's server takes LRS' 1e-4 at 784 features
SHARD_METHODS = (("vafl", False, 0.05), ("zoo-vfl", True, LRS["zoo-vfl"]))


def engine_rounds(fed, params, x_parts, y, graph=True) -> dict:
    """``Federation.run``'s rounds through the engine's round loop, on
    the run's default draws: the params, table, delays, losses and
    per-round max delays the result does not all carry (a sharded run's
    table is this rank's rows: all of them at one shard), and ``graph``,
    the captured round's readings (None where the body looped: with
    ``graph=False``, the internal eager loop)."""
    from repro_torch.core import async_engine
    from repro_torch.core.draws import TorchDraws
    stats = {}
    (p, table, delays), (losses, maxd) = async_engine._rounds(
        fed.adapter, fed.transport, fed.vfl, fed.engine, params, x_parts, y,
        draws=TorchDraws(fed.engine.seed, fed.device), mesh=fed.mesh,
        graph=graph, stats=stats)
    return dict(params=p, table=table, delays=delays, losses=losses,
                maxd=maxd, graph=stats or None)


def _leaves(tree, prefix="params"):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def unequal(a: dict, b: dict) -> list:
    """The keys (and param leaves) where two ``engine_rounds`` differ."""
    out = [k for k in ("table", "delays", "losses", "maxd")
           if not torch.equal(a[k], b[k])]
    return out + [k for (k, x), (_, y) in zip(_leaves(a["params"]),
                                              _leaves(b["params"]))
                  if not torch.equal(x, y)]


def graph_vs_eager(what, fed, params, x_parts, y) -> dict:
    """The same run's rounds through the captured round (replays of one
    CUDA graph) and through the internal eager loop of the same body on
    the card, on the same draws: losses, params, table, delays and max
    delays must be bitwise equal. Logs both runs' ms a round end to end
    (each run's whole wall, the graph run's round 0 and capture included)
    and their ratio, and the graph run's capture seconds and replays
    alone; returns the graph run's ``engine_rounds``."""
    out, wall = {}, {}
    for graph in (False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[graph] = engine_rounds(fed, params, x_parts, y, graph=graph)
        torch.cuda.synchronize()
        wall[graph] = time.perf_counter() - t0
    g, T = out[True]["graph"], fed.engine.steps
    if g is None:
        raise AssertionError(f"{what}: the rounds were not captured")
    diffs = unequal(out[True], out[False])
    if diffs:
        raise AssertionError(f"{what}: the captured rounds differ from the "
                             f"eager loop in {diffs}")
    log(f"{what}: {T} rounds through the graph bitwise equal to the eager "
        f"loop (losses, params, table, delays, max delays); the whole run "
        f"eager {wall[False] * 1e3 / T:.4f} ms a round, through the graph "
        f"{wall[True] * 1e3 / T:.4f} ({wall[False] / wall[True]:.2f}x); "
        f"graph: capture {g['capture_s']:.4f} s ({g['nodes']} nodes, "
        f"{g['kernel_nodes']} kernel nodes), {g['replays']} replays at "
        f"{g['replay_s'] * 1e3 / g['replays']:.4f} ms a round")
    return out[True]


def collective_counts(prof) -> dict:
    """{family: {"all_gather": n, "all_reduce": n}} of a profile's events:
    the dispatcher's ``c10d::`` ops, the process group's ``nccl:``
    ranges, and the device's NCCL kernels."""
    from torch.autograd import DeviceType
    fams: dict = {}
    for e in prof.events():
        low = e.name.lower().replace("_", "")
        kind = ("all_gather" if "allgather" in low else
                "all_reduce" if "allreduce" in low else None)
        if kind is None:
            continue
        fam = ("device" if e.device_type == DeviceType.CUDA else
               e.name.split(":")[0] if ":" in e.name else "other")
        fams.setdefault(fam, {"all_gather": 0, "all_reduce": 0})[kind] += 1
    return fams


class CollectiveCounter:
    """Counts the engine's ``torch.distributed`` collective calls inside
    a ``with``, apart for the calls made while a CUDA graph is being
    captured (each recorded once in the graph and run by every replay)
    and the calls that ran eagerly."""

    NAMES = {"all_gather_into_tensor": "all_gather",
             "all_reduce": "all_reduce"}

    def __enter__(self):
        import torch.distributed as dist
        self.dist, self.inner = dist, {}
        self.reset()
        for name, kind in self.NAMES.items():
            inner = self.inner[name] = getattr(dist, name)

            def counted(*args, _inner=inner, _kind=kind, **kw):
                where = (self.captured
                         if torch.cuda.is_current_stream_capturing()
                         else self.eager)
                where[_kind] = where.get(_kind, 0) + 1
                return _inner(*args, **kw)
            setattr(dist, name, counted)
        return self

    def reset(self):
        self.captured, self.eager = {}, {}

    def __exit__(self, *exc):
        for name, inner in self.inner.items():
            setattr(self.dist, name, inner)


def sharded_tabular(rows, ops, card, base=None) -> dict:
    """Phase 11 (a): the tabular main path through ``Federation.build(...,
    EngineConfig(mesh_shards=1))`` on a one-rank NCCL process group: its
    round captured as a CUDA graph that holds the collectives, held
    bitwise to its eager loop and to the unsharded run through its graph
    on the same draws, with its kernel launches (the replayed share), its
    collectives a round (those recorded in the graph, and those of a
    profiled eager loop) against their derivation, its graph's nodes by
    kind and its ms a round beside the other runs', in turns. ``base`` is
    phase 3's result when phase 3 ran."""
    import tempfile
    import torch.distributed as dist
    from repro_torch import graphs
    from repro_torch.configs.base import VFLConfig
    from repro_torch.configs.paper_mlp import PaperMLPConfig
    from repro_torch.core.adapters import tabular_adapter
    from repro_torch.core.async_engine import EngineConfig
    from repro_torch.data import make_classification, vertical_partition
    from repro_torch.federation import Federation
    from torch.profiler import ProfilerActivity, profile
    cfg, rounds = PaperMLPConfig(), SHARD["rounds"]
    X, y = make_classification(seed=0, n=60000, n_features=cfg.n_features,
                               n_classes=cfg.n_classes)
    x_parts = torch.from_numpy(vertical_partition(X, cfg.n_clients)).cuda()
    y_dev = torch.from_numpy(y).long().cuda()
    kernel_ad = tabular_adapter(cfg, use_kernel_lanes=True)

    def build(steps, shards, method="cascaded", lanes=True, lr=0.05):
        return Federation.build(
            kernel_ad if lanes else cfg,
            VFLConfig(mu=MU, lr_server=lr, lr_client=lr),
            EngineConfig(method=method, steps=steps, batch_size=64,
                         use_lanes=lanes, mesh_shards=shards),
            n_clients=cfg.n_clients, device="cuda")

    def timed(fed, params, use_graph=True):
        """(result, ms a round) of one synchronised run: through the
        captured round by default, the body looped with
        ``use_graph=False``."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fed.run(params, x_parts, y_dev, use_graph=use_graph)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3 / rounds

    t_phase = time.perf_counter()
    # the unsharded engine's eager loop before any process group exists,
    # for the group's own cost to the host (its threads) beside the
    # collectives'
    plain = build(rounds, 0)
    params = plain.init_params(torch.Generator().manual_seed(0))
    build(SHARD["warm"], 0).run(params, x_parts, y_dev)
    build(SHARD["warm"], 0).run(params, x_parts, y_dev, use_graph=False)
    no_group = timed(plain, params, use_graph=False)[1]
    # the group meets through a file, so no port is raced for
    tmp = tempfile.TemporaryDirectory()
    dist.init_process_group("nccl", store=dist.FileStore(
        f"{tmp.name}/store", 1), rank=0, world_size=1)
    try:
        sharded = build(rounds, 1)
        mesh = sharded.mesh
        if (mesh.device_type, mesh.size(0)) != ("cuda", 1):
            raise AssertionError(f"client mesh {mesh} is not one cuda "
                                 "shard")
        log(f"phase 11 (a): one-rank {dist.get_backend()} group, client "
            f"mesh {mesh}; D > 1 needs one card a rank (NCCL refuses two "
            f"ranks on one GPU): {SHARDED_RANKS} D runs it on D cards")
        build(SHARD["warm"], 1).run(params, x_parts, y_dev)
        build(SHARD["warm"], 1).run(params, x_parts, y_dev, use_graph=False)
        # the four runs in turns in this one process: the sharded D = 1
        # run through its captured round and through its eager loop, and
        # the unsharded run through its captured round and its eager loop
        kinds = {"sharded": (sharded, True), "sharded_eager": (sharded, False),
                 "graph": (plain, True), "eager": (plain, False)}
        ms = {kind: [] for kind in kinds}
        res, replay_ms = {}, {"sharded": [], "graph": []}
        capture_s = {"sharded": [], "graph": []}
        kept = {"sharded": [], "graph": []}
        name = "zoo_dual_matmul_stacked_bias_relu"
        with CollectiveCounter() as calls:
            for kind in ("sharded", "sharded_eager", "graph", "eager",
                         "eager", "graph", "sharded_eager", "sharded"):
                fed, use_graph = kinds[kind]
                ops.reset_launches()
                graphs.reset_replayed()
                calls.reset()
                res[kind], t = timed(fed, params, use_graph)
                ms[kind].append(t)
                if kind in replay_ms:
                    rg = res[kind].round_graph
                    replay_ms[kind].append(rg["replay_s"] * 1e3
                                           / rg["replays"])
                    capture_s[kind].append(rg["capture_s"])
                    kept[kind].append(rg["kept"])
                if kind == "sharded" and not rg["kept"]:
                    # the first sharded run captures; the second replays
                    # the session's kept graph, issuing no collective
                    launches = dict(ops.launches)
                    replayed = graphs.replayed["zoo_dual_matmul"][name]
                    in_graph = dict(calls.captured)
                    eager_calls = dict(calls.eager)
                elif kind == "sharded":
                    again = (dict(ops.launches),
                             graphs.replayed["zoo_dual_matmul"][name],
                             dict(calls.captured), dict(calls.eager))
        if launches[name] != rounds or replayed != rounds - 1:
            raise AssertionError(f"sharded run launched {launches} "
                                 f"({replayed} replayed), not the fused "
                                 f"kernel {rounds} times ({rounds - 1} "
                                 f"replayed)")
        log(f"phase 11 (a): the second run of each session through the "
            f"graph replays its kept graph: kept {kept}; the second sharded "
            f"run's launches {again[0]} ({again[1]} replayed), collectives "
            f"recorded {again[2] or 'none'}, issued {again[3] or 'none'}")
        if kept != {"sharded": [False, True], "graph": [False, True]} or \
                again[0][name] != rounds or again[1] != rounds or \
                any(again[2].values()) or any(again[3].values()):
            raise AssertionError(f"phase 11 (a): the second runs captured: "
                                 f"kept {kept}, {again}")
        main = rows.get(name, {})
        base_ms = ("" if base is None or "round_ms" not in main else
                   f"; phase 3's captured run {main['round_ms']:.4f} ms a "
                   f"round end to end")

        def fmt(ts):
            return ", ".join(f"{t:.4f}" for t in ts)
        log(f"phase 11 (a): {rounds} cascaded rounds at {cfg}, in turns "
            f"(sharded, sharded eager, graph, eager, eager, graph, sharded "
            f"eager, sharded), each the whole Federation.run: sharded (D = "
            f"1) through the graph {fmt(ms['sharded'])} ms a round (replays "
            f"alone {fmt(replay_ms['sharded'])}); sharded eager loop "
            f"{fmt(ms['sharded_eager'])}; unsharded through the graph "
            f"{fmt(ms['graph'])} (replays alone {fmt(replay_ms['graph'])}); "
            f"unsharded eager loop {fmt(ms['eager'])}; the eager loop before "
            f"the group existed {no_group:.4f}{base_ms} on {card}; kernel "
            f"launches {launches}, {replayed} of them replayed")
        sg, ug = res["sharded"].round_graph, res["graph"].round_graph
        nccl = {k: n for k, n in sg["kernels"].items()
                if "nccl" in k.lower()}
        log(f"phase 11 (a): the sharded round's graph: capture "
            f"{fmt(capture_s['sharded'])} s, {sg['nodes']} nodes "
            f"{sg['node_kinds']} ({sg['kernel_nodes']} kernel nodes; NCCL "
            f"kernels among them {nccl or 'none'}); the unsharded round's "
            f"{ug['nodes']} nodes {ug['node_kinds']}, capture "
            f"{fmt(capture_s['graph'])} s")
        if name in rows:
            rows[name]["launches"] += launches[name]
            rows[name].setdefault("launches_by_path", {})[
                "sharded engine, one NCCL rank"] = launches[name]
            rows[name].setdefault("replayed_by_path", {})[
                "sharded engine, one NCCL rank"] = replayed
        a = res["graph"]
        for kind in ("eager", "sharded", "sharded_eager"):
            b = res[kind]
            if not (np.array_equal(a.losses, b.losses)
                    and a.max_delay_seen == b.max_delay_seen
                    and a.mean_delay == b.mean_delay
                    and all(torch.equal(p, q) for p, q in zip(
                        [t for v in a.params.values() for t in v.values()],
                        [t for v in b.params.values() for t in v.values()]))):
                raise AssertionError(f"{kind} run != the unsharded run "
                                     "through the graph")
        if base is not None and not np.array_equal(
                base.losses, res["sharded"].losses):
            raise AssertionError("sharded run's losses != phase 3's")
        want = engine_rounds(plain, params, x_parts, y_dev)
        for graph in (True, False):
            diffs = unequal(want, engine_rounds(sharded, params, x_parts,
                                                y_dev, graph=graph))
            if diffs:
                raise AssertionError(f"sharded round loop (graph={graph}) "
                                     f"differs: {diffs}")
        log(f"phase 11 (a): losses, params, table and delays of the sharded "
            f"run through the graph bitwise equal to its eager loop and to "
            f"the unsharded run through the graph and its eager loop"
            f"{' and phase 3' if base else ''} ({rounds} rounds; final loss "
            f"{float(res['sharded'].losses[-1]):.6f})")

        # the collectives a round: recorded in the sharded round's graph
        # (the calls made under its capture; a replay issues none on the
        # host), issued by its eager round 0, and counted from a profile
        # of the sharded eager loop
        leaves = len(params["clients"])
        a_round = {"all_gather": 2, "all_reduce": leaves}
        log(f"phase 11 (a): collectives recorded in the sharded round's "
            f"graph {in_graph} and issued eagerly by its run {eager_calls} "
            f"(round 0, the capture's warm-up); derived {a_round} a round (2 "
            f"all-gathers and {leaves} client leaves all-reduces)")
        if in_graph != a_round or eager_calls != a_round:
            raise AssertionError(f"collectives in the graph {in_graph}, "
                                 f"eager {eager_calls}, want {a_round}")
        prof_fed = build(SHARD["profile"], 1)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            prof_fed.run(params, x_parts, y_dev, use_graph=False)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        fams = collective_counts(prof)
        R = SHARD["profile"]
        derived = {k: n * R for k, n in a_round.items()}
        log(f"phase 11 (a): collectives in {R} profiled rounds of the "
            f"sharded eager loop by family {fams}; derived {derived}")
        fam = next((f for f in ("c10d", "nccl") if f in fams), None)
        if fam is None or fams[fam] != derived:
            raise AssertionError(f"collectives {fams} != {derived}")
        coll = [e for e in prof.key_averages()
                if "allgather" in e.key.lower().replace("_", "")
                or "allreduce" in e.key.lower().replace("_", "")]
        host_us = sum(e.cpu_time_total for e in coll
                      if e.key.startswith(fam + ":"))
        dev_us = sum(getattr(e, "self_device_time_total", 0.0) for e in coll)
        log(f"phase 11 (a): collectives' share of a profiled eager round: "
            f"host {host_us / R:.1f} us of {wall_us / R:.1f} us "
            f"({host_us / wall_us:.2%}); device {dev_us / R:.2f} us a round")
        for e in sorted(coll, key=lambda e: e.cpu_time_total, reverse=True):
            log(f"  {e.key}: x{e.count / R:.2f} a round, "
                f"{e.cpu_time_total / e.count:.1f} us host a call")

        for method, lanes, lr in SHARD_METHODS:
            p, s = (build(SHARD["methods"], shards, method, lanes, lr)
                    for shards in (0, 1))
            want = engine_rounds(p, params, x_parts, y_dev)
            for graph in (True, False):
                got = engine_rounds(s, params, x_parts, y_dev, graph=graph)
                if graph and got["graph"] is None:
                    raise AssertionError(f"sharded {method}: the rounds "
                                         "were not captured")
                diffs = unequal(want, got)
                if diffs:
                    raise AssertionError(f"sharded {method} (graph={graph}) "
                                         f"differs: {diffs}")
        log(f"phase 11 (a): vafl and zoo-vfl, {SHARD['methods']} rounds "
            "each: sharded through the graph and its eager loop bitwise "
            "equal to unsharded through the graph")
    finally:
        dist.destroy_process_group()
        tmp.cleanup()
    spent = time.perf_counter() - t_phase
    log(f"phase 11 (a): {spent:.1f} s")
    return dict(ms=ms, replay_ms=replay_ms, no_group=no_group,
                launches=launches, collectives=fams, in_graph=in_graph,
                seconds=spent)


class Children:
    """The child processes of a multi-card mode, for one ``with``: each
    writes its output to a log file (a full pipe would stall a rank
    mid-collective); on leaving, any still running is killed and every
    log closed."""

    def __init__(self):
        self.procs, self.files = [], []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in self.files:
            f.close()

    def start(self, cmd, log_path, **kw):
        f = open(log_path, "w")
        self.files.append(f)
        self.procs.append(subprocess.Popen(cmd, stdout=f,
                                           stderr=subprocess.STDOUT, **kw))
        return self.procs[-1]

    @staticmethod
    def wait(ps, logs, what, timeout) -> None:
        """Until every process of ``ps`` has exited, one has failed or
        ``timeout`` s have passed; raises with the logs' tails unless all
        exited 0."""
        t0 = time.perf_counter()
        while any(p.poll() is None for p in ps) and not any(
                p.poll() for p in ps) and time.perf_counter() - t0 < timeout:
            time.sleep(1)
        bad = [(i, p.poll(), Path(lp).read_text()[-3000:])
               for i, (p, lp) in enumerate(zip(ps, logs)) if p.poll() != 0]
        if bad:
            raise AssertionError(f"{what}: failed or still running "
                                 f"(index, exit code, log tail): {bad}")

    def ranks(self, flag, world, d, *extra, timeout, what, show=None):
        """``world`` processes of this script, ``flag RANK WORLD STORE OUT
        *extra``, one card each, joined through the ``FileStore`` STORE in
        the directory ``d``; waits for them (:meth:`wait`) and returns
        each rank's OUT (JSON). ``show`` is a rank whose log is logged
        after, whether the ranks passed or not."""
        outs = [d / f"rank{r}.json" for r in range(world)]
        logs = [d / f"rank{r}.log" for r in range(world)]
        ps = [self.start([sys.executable, str(Path(__file__).resolve()),
                          flag, str(r), str(world), str(d / "store"),
                          str(outs[r]), *map(str, extra)], logs[r])
              for r in range(world)]
        try:
            self.wait(ps, logs, what, timeout)
        finally:
            if show is not None:
                log(f"---- {what}, rank {show}'s log ----")
                for line in logs[show].read_text().splitlines():
                    log(f"  {line}")
        return [json.loads(o.read_text()) for o in outs]


SHARDED_RANK = "--sharded-rank"      # argv[1] of one rank's process
SHARDED_RANKS = "--sharded-ranks"    # argv[1] of the D-card run
# block 4 (every client each round, so D = 2 and 4 divide it) at lr 0.01:
# at the main path's 0.05 a block of 4 spikes to losses near 28 in its
# first rounds, where the ranks' rounding grows into a divergence
SHARDED_D = dict(rounds=500, block=4, lr=0.01)


def sharded_rank(argv) -> int:
    """One rank of :func:`sharded_ranks`: ``RANK WORLD STORE OUT``. On
    ``cuda:RANK`` in a WORLD-rank NCCL group (joined through the
    ``FileStore`` STORE), the paper-width tabular path with
    ``mesh_shards=WORLD`` and block 4: its captured run and its eager
    loop in turns (captured, eager, eager, captured), both held bitwise
    (losses, params, this rank's table rows, delays) to each other and
    compared with the unsharded captured run on this card; the
    collectives recorded in the graph; its nodes by kind and NCCL kernels
    by name. Writes its readings to OUT (JSON)."""
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    from repro_torch import graphs
    from repro_torch.configs.base import VFLConfig
    from repro_torch.configs.paper_mlp import PaperMLPConfig
    from repro_torch.core.adapters import tabular_adapter
    from repro_torch.core.async_engine import EngineConfig
    from repro_torch.data import make_classification, vertical_partition
    from repro_torch.federation import Federation
    from repro_torch.kernels.zoo_dual_matmul import ops
    rank, world, store, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        cfg, rounds = PaperMLPConfig(), SHARDED_D["rounds"]
        X, y = make_classification(seed=0, n=60000,
                                   n_features=cfg.n_features,
                                   n_classes=cfg.n_classes)
        x_parts = torch.from_numpy(vertical_partition(X, cfg.n_clients)
                                   ).cuda()
        y_dev = torch.from_numpy(y).long().cuda()
        ad = tabular_adapter(cfg, use_kernel_lanes=True)

        def build(steps, shards):
            return Federation.build(
                ad, VFLConfig(mu=MU, lr_server=SHARDED_D["lr"],
                              lr_client=SHARDED_D["lr"]),
                EngineConfig(method="cascaded", steps=steps, batch_size=64,
                             use_lanes=True, block_size=SHARDED_D["block"],
                             mesh_shards=shards),
                n_clients=cfg.n_clients, device="cuda")
        plain, sharded = build(rounds, 0), build(rounds, world)
        params = plain.init_params(torch.Generator().manual_seed(0))
        build(SHARD["warm"], world).run(params, x_parts, y_dev)
        build(SHARD["warm"], world).run(params, x_parts, y_dev,
                                        use_graph=False)
        ms = {True: [], False: []}
        name = "zoo_dual_matmul_stacked_bias_relu"
        with CollectiveCounter() as calls:
            for graph in (True, False, False, True):
                ops.reset_launches()
                graphs.reset_replayed()
                calls.reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = sharded.run(params, x_parts, y_dev, use_graph=graph)
                torch.cuda.synchronize()
                ms[graph].append((time.perf_counter() - t0) * 1e3 / rounds)
                # the first run through the graph captures; the second
                # replays the session's kept graph
                if graph and not res.round_graph["kept"]:
                    rg, in_graph = res.round_graph, dict(calls.captured)
                    launches = (ops.launches[name],
                                graphs.replayed["zoo_dual_matmul"][name])
        got = {g: engine_rounds(sharded, params, x_parts, y_dev, graph=g)
               for g in (True, False)}
        want = engine_rounds(plain, params, x_parts, y_dev)
        rows = want["table"].shape[0] // world
        want["table"] = want["table"][rank * rows:(rank + 1) * rows]
        vs_unsharded = {k: (float((got[True][k].float()
                                   - want[k].float()).abs().max())
                            if k in ("table", "losses")
                            else int(not torch.equal(got[True][k], want[k])))
                        for k in ("table", "delays", "losses", "maxd")}
        vs_unsharded["params"] = max(
            float((a.float() - b.float()).abs().max()) for (_, a), (_, b)
            in zip(_leaves(got[True]["params"]), _leaves(want["params"])))
        differ = (got[True]["losses"] != want["losses"]).nonzero()
        vs_unsharded["first_round_apart"] = (int(differ[0]) if len(differ)
                                             else None)
        vs_unsharded["losses_first_5"] = [
            got[True]["losses"][:5].tolist(), want["losses"][:5].tolist()]
        result = dict(
            rank=rank, world=world, device=torch.cuda.get_device_name(rank),
            ms_graph=ms[True], ms_eager=ms[False],
            replay_ms=rg["replay_s"] * 1e3 / rg["replays"],
            capture_s=rg["capture_s"], nodes=rg["nodes"],
            node_kinds=rg["node_kinds"],
            nccl_kernels={k: n for k, n in rg["kernels"].items()
                          if "nccl" in k.lower()},
            in_graph=in_graph, launches=launches,
            derived={"all_gather": 2, "all_reduce": len(params["clients"])},
            graph_vs_eager=unequal(got[True], got[False]),
            vs_unsharded=vs_unsharded,
            losses_sum=float(got[True]["losses"].double().sum()))
        with open(out, "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()
    return 0


def sharded_ranks(world: int) -> int:
    """``python3 chip_smoke.py --sharded-ranks D``: the captured sharded
    round at D > 1, one card a rank (NCCL refuses two ranks on one GPU;
    this run needs D cards, the default run one): builds the kernels,
    starts D processes of :func:`sharded_rank` and holds what they
    report: on every rank the captured run bitwise to its eager loop,
    the collectives in its graph equal to the derivation (2 all-gathers
    and one all-reduce a client leaf), the fused kernel once a round (all
    but round 0 replayed), the losses finite and every rank's the same;
    logs the ms a round, the graph's nodes by kind and its NCCL kernels,
    and how far each rank's results lie from the unsharded run's (from
    which round on)."""
    import tempfile
    if torch.cuda.device_count() < world:
        print(f"chip_smoke {SHARDED_RANKS} {world}: needs {world} cards, "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build
    card = nvidia_smi()
    t0 = time.perf_counter()
    _build.build_all(["zoo_dual_matmul"])
    log(f"D = {world}: build {time.perf_counter() - t0:.1f} s; cards: "
        f"{card}; torch {torch.__version__}, NCCL "
        f"{'.'.join(map(str, torch.cuda.nccl.version()))}")
    with tempfile.TemporaryDirectory() as tmp, Children() as children:
        res = children.ranks(SHARDED_RANK, world, Path(tmp), timeout=600,
                             what=f"D = {world}: ranks")
    rounds = SHARDED_D["rounds"]
    for r in res:
        log(f"D = {world}, rank {r['rank']} on {r['device']}: "
            f"{rounds} cascaded rounds, block {SHARDED_D['block']}, through "
            f"the graph {', '.join(f'{t:.4f}' for t in r['ms_graph'])} ms a "
            f"round (replays alone {r['replay_ms']:.4f}), the eager loop "
            f"{', '.join(f'{t:.4f}' for t in r['ms_eager'])} (turns: graph, "
            f"eager, eager, graph); capture {r['capture_s']:.4f} s, "
            f"{r['nodes']} nodes {r['node_kinds']}, NCCL kernels "
            f"{r['nccl_kernels'] or 'none'}; collectives in the graph "
            f"{r['in_graph']} (derived {r['derived']}: 2 all-gathers and "
            f"one all-reduce a client leaf); the fused kernel "
            f"{r['launches'][0]} launches, {r['launches'][1]} replayed; the "
            f"graph against the eager loop differs in "
            f"{r['graph_vs_eager'] or 'nothing (bitwise)'}; against the "
            f"unsharded run: {r['vs_unsharded']} (max |diff| of the table, "
            f"losses and params; 1 where delays or max delays differ; the "
            f"first round whose loss differs; the first 5 losses of both)")
    log(f"D = {world} on {card}")
    for r in res:
        if r["graph_vs_eager"] or r["in_graph"] != r["derived"] or \
                tuple(r["launches"]) != (rounds, rounds - 1) or \
                not math.isfinite(r["losses_sum"]):
            raise AssertionError(f"D = {world}, rank {r['rank']}: {r}")
    if len({r["losses_sum"] for r in res}) != 1:
        raise AssertionError(f"D = {world}: the ranks' losses differ")
    return 0


def sentinel_drain(srv):
    """Phase 11 (b), run inside phase 6's run A: the drain under
    ``analysis.runtime.strict(check=False)`` (its host reads and fresh
    compiles counted), and every block step after the step graph's
    capture under ``strict(sync_debug="error")``: zero reads, zero
    compiles, and no synchronizing CUDA call the sentinel does not count.
    Returns (results, readings)."""
    from repro_torch.analysis import runtime
    block_step = srv._block_step
    guarded = [0]

    def step(budget=None):
        if srv._step_graph is None:     # the warm-up block: the capture
            return block_step(budget)
        with runtime.strict(sync_debug="error"):
            block_step(budget)
        guarded[0] += 1

    srv._block_step = step
    try:
        with runtime.strict(check=False) as rep:
            results = srv.run()
    finally:
        del srv._block_step
    return results, dict(reads=rep.d2h, sites=dict(rep.d2h_sites),
                         compiles=rep.compiles, names=rep.compiled_names,
                         guarded_blocks=guarded[0],
                         host_transfers=srv.host_transfers,
                         captures=srv.graph_captures)


def check_sentinel(what, got) -> None:
    """Phase 11 (b)'s checks on run A's readings."""
    log(f"phase 11 (b), {what} under the sentinels: {got['reads']} host "
        f"reads (sites {got['sites']}), scheduler host_transfers "
        f"{got['host_transfers']}; {got['compiles']} fresh compiles "
        f"({got['names']}), scheduler captures {got['captures']}; "
        f"{got['guarded_blocks']} block steps under sync debug mode "
        "'error' after the warm-up, each with no read and no compile")
    if got["reads"] != got["host_transfers"] or not got["reads"]:
        raise AssertionError("the sentinel's host reads != the scheduler's "
                             "host_transfers")
    if any("federation/scheduler.py" not in s for s in got["sites"]):
        raise AssertionError(f"a host read outside the scheduler: "
                             f"{got['sites']}")
    if got["compiles"] != got["captures"] or not got["guarded_blocks"]:
        raise AssertionError("the block loop compiled after its warm-up, "
                             "or no block ran after it")


def analysis_cli() -> None:
    """Phase 11 (c): ``python -m repro_torch.analysis --strict`` over the
    port's source on this machine (no JAX here) exits 0."""
    env = dict(__import__("os").environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          "--strict"], env=env, capture_output=True,
                         text=True, timeout=300)
    log(f"phase 11 (c): python -m repro_torch.analysis --strict: exit "
        f"{out.returncode} in {time.perf_counter() - t0:.1f} s: "
        f"{(out.stdout + out.stderr).strip()[-300:]}")
    if out.returncode != 0:
        raise AssertionError("the analysis gate failed on the port's tree")


# ------------------------------------ phase 12: the boundary certifier ----

CERT_REFERENCE = Path(__file__).resolve().parent / "CERT_boundary.json"
CERT_OUT = Path(__file__).resolve().parent / "build" / "CERT_boundary.json"
# the full-width split-serve trace: Phi-3-mini, 2 client parties, B = 2,
# 4 decode steps after phase 4's 1024-token prompt
CERT_SERVE = dict(batch=2, prompt_len=1024, gen_len=4, n_clients=2)


def cert_mismatches(got: dict, want: dict) -> list:
    """Where a certificate's inventory differs from the JAX package's
    committed one: status, findings, crossings, ``n_dp_eqns`` and
    ``out_taints`` of every configuration (the serve plane's decode steps
    each against the JSON's one step)."""
    bad = []
    if sorted(got["methods"]) != sorted(want["methods"]):
        return [f"configurations {sorted(got['methods'])}"]
    for name, w in want["methods"].items():
        g = got["methods"][name]
        for key in ("status", "findings", "tripped"):
            if g.get(key) != w.get(key):
                bad.append(f"{name}: {key} {g.get(key)} != {w.get(key)}")
        gr, wr = g["report"], w["report"]
        for key in ("n_dp_eqns", "out_taints"):
            if gr[key] != wr[key]:
                bad.append(f"{name}: {key} {gr[key]} != {wr[key]}")
        steps = g.get("per_step", [gr["crossings"]])
        if not steps or any(s != wr["crossings"] for s in steps):
            bad.append(f"{name}: crossings {steps} != {wr['crossings']}")
    return bad


def certify_cli() -> float:
    """Phase 12 (a): ``python -m repro_torch.analysis certify --strict`` on
    the card in a child process exits 0, and its certificate's inventory
    equals the committed ``CERT_boundary.json``'s."""
    env = dict(__import__("os").environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          "certify", "--strict", "--out", str(CERT_OUT)],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    sec = time.perf_counter() - t0
    log(f"phase 12 (a): python -m repro_torch.analysis certify --strict: "
        f"exit {out.returncode} in {sec:.1f} s: "
        f"{out.stdout.strip()[-600:]}")
    if out.returncode != 0:
        log(f"phase 12 (a): its errors: {out.stderr.strip()[-6000:]}")
        raise AssertionError("the certifier found a violation on the card")
    got = json.loads(CERT_OUT.read_text())
    bad = cert_mismatches(got, json.loads(CERT_REFERENCE.read_text()))
    if got["device"] != "cuda" or bad:
        raise AssertionError(f"the card's certificate ({got['device']}) "
                             f"differs from CERT_boundary.json: {bad}")
    log(f"phase 12 (a): the card's certificate equals CERT_boundary.json in "
        f"all {len(got['methods'])} configurations")
    return sec


def certify_tabular(zoo_ops) -> float:
    """Phase 12 (b): cascaded-lanes on the tabular main path at the paper's
    width (phase 3's batch 64 and q) through the fused kernel, certified:
    one graph node of the kernel for each launch its counter reads around
    the trace, and the crossings' elements equal to the ledger's
    ``round_messages`` at that width."""
    from repro_torch.analysis import certify, ifc
    from repro_torch.configs.base import VFLConfig
    from repro_torch.configs.paper_mlp import PaperMLPConfig
    from repro_torch.core import adapters, privacy
    from repro_torch.core.async_engine import EngineConfig
    from repro_torch.federation import Federation
    t0 = time.perf_counter()
    cfg = PaperMLPConfig()
    vfl = VFLConfig(mu=MU, lr_server=0.05, lr_client=0.05)
    fed = Federation.build(
        adapters.tabular_adapter(cfg, use_kernel_lanes=True), vfl,
        EngineConfig(method="cascaded", batch_size=64, use_lanes=True))
    meta = fed.boundary_meta()
    g = torch.Generator("cuda").manual_seed(0)
    args = list(adapters.example_engine_args(
        fed.adapter, cfg, n_rows=60000, batch=64, block=1,
        q=vfl.zoo_queries, device="cuda"))
    args[0] = fed.init_params(torch.Generator().manual_seed(0))
    args[3] = torch.randint(0, 60000, (64,), generator=g, device="cuda")
    args[6] = torch.randn(args[6].shape, generator=g, device="cuda")
    name = "zoo_dual_matmul_stacked_bias_relu"
    zoo_ops.reset_launches()
    report, meta = certify.trace_train(fed, cfg, args=tuple(args))
    torch.cuda.synchronize()
    launches = zoo_ops.launches[name]
    nodes = ifc.count_nodes(report, name)
    f = certify.certify_train("cascaded-lanes (paper width)", report, meta,
                              cfg.client_embed)
    msgs = privacy.round_messages("cascaded", 64, cfg.client_embed,
                                  zoo_queries=vfl.zoo_queries)
    want = {"emb": sum(math.prod(m.shape) for m in msgs
                       if m.kind == "embedding"),
            "loss": sum(1 for m in msgs if m.kind == "loss")}
    got = {"emb": sum(c.size for c in report.up()),
           "loss": sum(c.size for c in report.down("loss"))}
    sec = time.perf_counter() - t0
    log(f"phase 12 (b): cascaded-lanes at paper width ({cfg}, batch 64, "
        f"q {vfl.zoo_queries}): {len(report.graph.graph.nodes)} graph nodes, "
        f"{nodes} {name} nodes for {launches} launches; crossings "
        f"{[c.to_json() for c in report.crossings]}; elements {got} "
        f"(ledger {want}); findings {[x.rule for x in f]}; {sec:.1f} s")
    if nodes != launches or nodes < 1:
        raise AssertionError(f"{nodes} kernel nodes for {launches} launches")
    if f or got != want or report.out_taints != [frozenset()] * 2:
        raise AssertionError("the paper-width tabular step is not certified")
    return sec


def certify_serve(rms_ops, flash_ops) -> float:
    """Phase 12 (b): split-serve of Phi-3-mini at full width and depth
    (bf16, random weights from a seed) traced over 4 decode steps and
    certified: as many RMSNorm nodes as launches around the trace (the
    decode steps take the plain decode attention: no flash node), and per
    step a (B,) int32 token downlink and a (B, 1, 3072) bf16 embedding
    uplink."""
    from repro_torch.analysis import certify, ifc
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_mod
    t0 = time.perf_counter()
    cfg = get_config("phi3-mini-3.8b")
    B = CERT_SERVE["batch"]
    fed, params = serve_mod.build_session(
        cfg, n_clients=CERT_SERVE["n_clients"],
        prompt_len=CERT_SERVE["prompt_len"],
        gen_len=CERT_SERVE["gen_len"], seed=0)
    params = fed.params_from_global(params)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rms_ops.reset_launches()
    flash_ops.reset_launches()
    report, steps = certify.trace_serve(
        fed, params, batch=B, prompt_len=CERT_SERVE["prompt_len"],
        gen_len=CERT_SERVE["gen_len"])
    torch.cuda.synchronize()
    launches = (rms_ops.launches["rmsnorm"],
                flash_ops.launches["flash_attention"])
    nodes = (ifc.count_nodes(report, "rmsnorm"),
             ifc.count_nodes(report, "flash_attention"))
    name = "split-serve (phi3-mini-3.8b, full width)"
    f = ifc.check_flows(report, name=name, dp_configured=False,
                        down_limits={"token": B})
    f += certify.serve_if304(name, steps, batch=B, d_model=cfg.d_model)
    want_step = [("token", "down", (B,), "int32"),
                 ("emb", "up", (B, 1, cfg.d_model), "bfloat16")]
    got_steps = [[(c.kind, c.direction, c.shape, c.dtype) for c in st]
                 for st in steps]
    per_fwd = serve_plan(cfg)["per_fwd"]
    sec = time.perf_counter() - t0
    log(f"phase 12 (b): {name}: weights {t1 - t0:.1f} s, trace and walk "
        f"{sec - (t1 - t0):.1f} s, {len(report.graph.graph.nodes)} graph "
        f"nodes, RMSNorm nodes {nodes[0]} for {launches[0]} launches "
        f"({per_fwd} a decode step), flash nodes {nodes[1]} for "
        f"{launches[1]} launches; {len(steps)} steps of crossings "
        f"{got_steps[0] if got_steps else None}; out taints "
        f"{[sorted(t) for t in report.out_taints]}; findings "
        f"{[x.rule for x in f]}")
    if nodes != launches or nodes != (per_fwd * CERT_SERVE["gen_len"], 0):
        raise AssertionError(f"serve trace nodes {nodes}, launches "
                             f"{launches}")
    if f or got_steps != [want_step] * CERT_SERVE["gen_len"] \
            or report.out_taints != [frozenset()]:
        raise AssertionError("the full-width serve step is not certified")
    del fed, params, report
    gc.collect()
    torch.cuda.empty_cache()
    return sec


def certifier_phase(card, zoo_ops, rms_ops, flash_ops) -> None:
    """Phase 12: the boundary certifier on the card: (a) the CLI over the
    11 toy configurations against ``CERT_boundary.json``; (b) the tabular
    main path at the paper's width and Phi-3-mini's split serve at full
    width and depth, certified with one graph node a kernel launch; (c)
    the phase's seconds."""
    t0 = time.perf_counter()
    parts = {"(a) certify CLI": certify_cli(),
             "(b) tabular": certify_tabular(zoo_ops),
             "(b) phi3 serve": certify_serve(rms_ops, flash_ops)}
    log("phase 12 (c): " + "; ".join(f"{k} {v:.1f} s"
                                     for k, v in parts.items())
        + f"; the phase {time.perf_counter() - t0:.1f} s on {card}")


# ----------------------------- phase 13: the examples on the card ------

EXAMPLES_DIR = Path(__file__).resolve().parent / "examples_torch"
EXAMPLES = ("quickstart", "async_adapters", "paper_experiments",
            "attack_demo", "train_lm_cascaded", "serve_decode")
EXAMPLE_ARGS = {"paper_experiments": ("--steps", "200")}
# serve_decode.py's calls of launch.serve.serve
SERVE_DECODE = dict(batch=4, prompt_len=12, gen_len=12, n_clients=2)


def load_example(name):
    """An example file of ``examples_torch/`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", EXAMPLES_DIR / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(name, mod):
    """``mod.main()`` with ``sys.argv`` set as the command line would
    (no ``--device``: the card); its printed lines are logged. Returns
    (its return value, seconds)."""
    import io
    argv, buf = sys.argv, io.StringIO()
    sys.argv = [str(EXAMPLES_DIR / f"{name}.py"), *EXAMPLE_ARGS.get(name,
                                                                    ())]
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            out = mod.main()
        torch.cuda.synchronize()
    finally:
        sys.argv = argv
    secs = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        if line.strip():
            log(f"  {name}: {line[:300]}")
    log(f"example {name}: {secs:.1f} s on the card")
    return out, secs


def split_serve_plan(cfg, prompt_len, gen_len, n_clients) -> dict:
    """Launches of one split ``serve`` call (``serve_plan`` at any
    prompt): the prompt's span-aligned prefill chunks (the spans of
    ``seq_len / n_clients``, seq_len rounded up to a multiple of the
    parties) run flash once an attention site and the SSD scan once a
    Mamba2 layer; every forward (a chunk, a decode step) runs each norm."""
    from repro_torch.federation.serving import prefill_plan
    sites, mamba, block_norms, final_norm = kernel_sites(cfg)
    seq = -(-(prompt_len + gen_len) // n_clients) * n_clients
    chunks = len(prefill_plan(prompt_len, seq // n_clients))
    return {"flash_attention": sites * chunks,
            "rmsnorm": (block_norms + final_norm) * (chunks + gen_len),
            "ssd_chunk": mamba * chunks}


def serve_decode_plan(servers) -> dict:
    """serve_decode.py's launches: split serves of granite (LayerNorm),
    rwkv6 (no kernel) and zamba2, the continuous granite drain (from its
    scheduler's prefill chunks, steps and replays) and whisper's global
    decode, each reduced as ``serve`` runs them."""
    from repro_torch.configs import get_config, reduced
    total = {"flash_attention": 0, "rmsnorm": 0, "ssd_chunk": 0}

    def add(plan):
        for k in total:
            total[k] += plan[k]
    for arch in ("granite-20b", "rwkv6-7b", "zamba2-2.7b"):
        add(split_serve_plan(reduced(get_config(arch)),
                             SERVE_DECODE["prompt_len"],
                             SERVE_DECODE["gen_len"],
                             SERVE_DECODE["n_clients"]))
    if len(servers) != 1:
        raise AssertionError(f"serve_decode built {len(servers)} "
                             "schedulers, want 1")
    add(cont_launch_plan(reduced(get_config("granite-20b")), servers[0]))
    add(modal_serve_plan(reduced(get_config("whisper-medium")),
                         SERVE_DECODE["prompt_len"]
                         + SERVE_DECODE["gen_len"]))
    return total


class ServeRecorder:
    """Keeps every scheduler ``Federation.serve`` builds inside one
    ``with``."""

    def __enter__(self):
        from repro_torch.federation import session
        self.Fed, self.servers = session.Federation, []
        self.inner = self.Fed.serve
        rec = self

        def serve(fed, *args, **kw):
            srv = rec.inner(fed, *args, **kw)
            rec.servers.append(srv)
            return srv
        self.Fed.serve = serve
        return self

    def __exit__(self, *exc):
        self.Fed.serve = self.inner


class EngineRecorder:
    """Keeps every engine run's (rounds, sharded, ``round_graph``) inside
    one ``with`` (``Federation.run`` and ``async_engine.run`` both go
    through ``async_engine._session_run``)."""

    def __enter__(self):
        from repro_torch.core import async_engine
        self.mod, self.runs = async_engine, []
        self.inner = async_engine._session_run
        rec = self

        def session_run(*args, **kw):
            res = rec.inner(*args, **kw)
            rec.runs.append((len(res.losses), kw.get("mesh") is not None,
                             res.round_graph))
            return res
        async_engine._session_run = session_run
        return self

    def __exit__(self, *exc):
        self.mod._session_run = self.inner


def examples_phase(rows, card, counters) -> None:
    """Phase 13: each example of ``examples_torch/`` run in this process
    on the card, its own asserts holding, every engine run of theirs
    (quickstart.py, async_adapters.py, paper_experiments.py) through the
    captured round; the kernel launches of train_lm_cascaded.py and
    serve_decode.py held to their derivation."""
    t_phase = time.perf_counter()
    for name in EXAMPLES:
        mod = load_example(name)
        if name == "paper_experiments":
            mod.OUT = str(Path(__file__).resolve().parent / "build"
                          / "experiments_torch")
        for c in counters:
            c.reset_launches()
        with ServeRecorder() as rec, EngineRecorder() as eng:
            out, _ = run_example(name, mod)
        launches = _launches(counters)
        if eng.runs:
            # every unsharded run of more than one round replays the
            # captured round
            eager = [T for T, sharded, g in eng.runs
                     if T > 1 and not sharded and g is None]
            log(f"example {name}: {len(eng.runs)} engine runs, rounds "
                f"{[T for T, _, _ in eng.runs]}, replays "
                f"{[g and g['replays'] for _, _, g in eng.runs]}")
            if eager:
                raise AssertionError(f"example {name}: engine runs of "
                                     f"{eager} rounds were not captured")
        if name == "train_lm_cascaded":
            from repro_torch.configs import ARCH_REGISTRY
            cfg = ARCH_REGISTRY["lm-ci"]
            plan = train_plan(cfg, q=1, steps=out["steps"])
            want, why = plan["launches"], plan["why"]
        elif name == "serve_decode":
            want = serve_decode_plan(rec.servers)
            why = ("split serves of reduced granite, rwkv6 and zamba2, the "
                   "continuous granite drain and whisper's global decode")
        else:
            continue
        got = {k: launches[k] for k in want}
        log(f"example {name}: launches {got}, derived {want}: {why}")
        if got != want:
            raise AssertionError(f"example {name} launched {got}, want "
                                 f"{want}")
        path = f"example:{name}"
        for k, n in got.items():
            rows[k]["launches"] += n
            rows[k].setdefault("launches_by_path", {})[path] = n
    log(f"examples phase: {time.perf_counter() - t_phase:.1f} s on {card}")


# ------------------------------ phase 14: the production mesh ------------

MESH_TRAIN = dict(arch="phi3-mini-3.8b", layers=4, steps=3, batch=8,
                  seq=128)
# the step phase 14 (a)'s placed run is saved at, then resumed to steps
MESH_RESUME_AT = 1
DRYRUN_OUT = Path(__file__).resolve().parent / "build" / "dryrun"
DRYRUN_FIT_LAYERS = 4
DRYRUN_FIT = """
import json, sys
from repro_torch.configs import cut_depth, get_config
from repro_torch.launch import dryrun
res = dryrun.run_one(cut_depth(get_config("phi3-mini-3.8b"), {layers}),
                     "train_4k", trace_full=True, verbose=False)
json.dump(res, open(sys.argv[1], "w"))
"""


def start_dryruns():
    """The dry run's child processes, started early (they need no card,
    and are kept off it): the CLI at Phi-3-mini's full depth, and Phi-3
    cut to 4 layers with the full depth traced beside the fit."""
    DRYRUN_OUT.mkdir(parents=True, exist_ok=True)
    env = dict(__import__("os").environ, PYTHONPATH=str(SRC),
               CUDA_VISIBLE_DEVICES="")
    cli = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           "phi3-mini-3.8b", "--shape", "train_4k", "--out",
           str(DRYRUN_OUT)]
    fit = [sys.executable, "-c", DRYRUN_FIT.format(
        layers=DRYRUN_FIT_LAYERS), str(DRYRUN_OUT / "fit.json")]
    t0 = time.perf_counter()
    return t0, [subprocess.Popen(c, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
                for c in (cli, fit)]


def join_dryruns(procs) -> list:
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=900)
        finally:
            if p.poll() is None:
                p.kill()
                p.communicate()
        if p.returncode != 0:
            raise AssertionError(f"dry run exited {p.returncode}: "
                                 f"{out[-3000:]}")
        outs.append(out)
    return outs


def mesh_constraint_plan(cfg, steps: int, q: int = 1,
                         captured: bool = False) -> int:
    """``shard_constraint`` calls of ``steps`` cascaded steps: a forward
    constrains the embeddings and the logits, and in every block its input
    (``seq_shard_acts``), q and the attention output, then the MLP's
    hidden or the MoE dispatch's five (groups, dispatch, expert hidden,
    expert output, return), and the two output projections with
    ``rs_outputs``; a step runs the clean forward, q perturbed ones, and
    recomputes each block in the backward (remat). The CPU test of the
    (2, 2) mesh holds the count to this derivation too (the step's loop
    form runs its body every step). ``captured``: the step on the card,
    whose body runs at step 0 (eager) and at the capture only, so any
    number of steps makes (1 + 1) x a step's calls (a replay runs
    none)."""
    block = ((1 if cfg.seq_shard_acts else 0) + 2
             + (5 if cfg.n_experts else 1) + (2 if cfg.rs_outputs else 0))
    fwd = 2 + cfg.n_layers * block
    recompute = cfg.n_layers * block if cfg.remat else 0
    return (1 + 1 if captured else steps) * ((1 + q) * fwd + recompute)


def mesh_run(cfg, mesh, counters, graph=None, profile_at=None, within=None,
             detail=False, **kw):
    """One ``train(cfg, mesh=mesh)`` call, recorded: its losses, the
    host clock after each step, its launches (the replayed share), its
    ``shard_constraint`` calls and its peak memory; ``graph=False`` steps
    eagerly, ``within`` runs chosen steps inside a context
    (:class:`StepRecorder`); ``detail`` adds each captured graph's nodes
    by kind and its NCCL kernels by name."""
    from repro_torch import graphs
    from repro_torch.launch import train as train_mod
    from repro_torch.sharding import rules
    for c in counters:
        c.reset_launches()
    graphs.reset_replayed()
    rules.reset_calls()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with StepRecorder(profile_at=profile_at, graph=graph, within=within,
                      keep_steps=detail) as rec:
        res = train_mod.train(cfg, mesh=mesh, **kw)
    torch.cuda.synchronize()
    detail = [dict(capture_s=g.capture_s, node_kinds=g.node_kinds,
                   nccl={k: n for k, n in g.kernel_names().items()
                         if "nccl" in k.lower()})
              for s in rec.steps for g in getattr(s, "graphs", {}).values()
              if g is not None] if detail else None
    return dict(res=res, losses=rec.losses, perturbed=rec.perturbed,
                ends=rec.ends, graphs=detail,
                launches=_launches(counters), profile=rec.profile,
                replayed={k: v for g, counts in graphs.replayed.items()
                          if g != "rmsnorm_routes"
                          for k, v in counts.items() if v},
                calls=rules.calls["shard_constraint"],
                peak=torch.cuda.max_memory_allocated() - held,
                saves=rec.saves)


def _full_params(res):
    """A result's final parameters, each whole (a DTensor's
    ``full_tensor()``)."""
    from repro_torch.tree import tree_leaves
    return [getattr(p, "full_tensor", lambda p=p: p)()
            for p in tree_leaves(res["params"])]


def _full_by_path(res) -> dict:
    """A result's final parameters, each whole, by path (``_leaves``)."""
    return {k: getattr(p, "full_tensor", lambda p=p: p)()
            for k, p in _leaves(res["params"])}


def check_capture_gc() -> None:
    """A capture during which dead graphs become garbage in a reference
    cycle, and a collection runs wherever the collector is on: it stays
    off inside a capture (``graphs._no_collection``), so the capture
    holds. A collection inside it would destroy the dead graphs there,
    which CUDA forbids: an automatic one ended a captured placed step's
    capture before the collector was switched off."""
    from repro_torch import graphs
    x = torch.zeros(1024, device="cuda")
    junk = [graphs.StepGraph(lambda: x.add_(1), "cuda") for _ in range(2)]
    junk.append(junk)
    holder = [junk]
    del junk

    def body():
        x.add_(1)
        if torch.cuda.is_current_stream_capturing():
            holder.clear()              # the dead graphs become garbage
            if gc.isenabled():          # a collection, where one may run
                gc.collect()
    g = graphs.StepGraph(body, "cuda")
    g.replay(3)
    torch.cuda.synchronize()
    gc.collect()
    log(f"phase 14 (a): a capture during which dead graphs become cyclic "
        f"garbage holds ({g.nodes} nodes; the buffer after 3 warm-ups and "
        f"3 replays reads {float(x[0]):.0f})")
    if float(x[0]) != 6:
        raise AssertionError(f"the graph's buffer reads {float(x[0])}, not 6")


def mesh_train(rows, card, counters) -> None:
    """(a) ``train(mesh=)`` on a one-rank NCCL group at a (1, 1) mesh,
    placement forced: its captured step (step 0 eager through DTensor,
    then replays) against the placed eager step and the unplaced
    captured step, in turns, bitwise; then once at Phi-3-mini's full
    depth, captured, with a profiled replay."""
    import tempfile
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs import cut_depth, get_config
    cfg = cut_depth(get_config(MESH_TRAIN["arch"]), MESH_TRAIN["layers"])
    steps = MESH_TRAIN["steps"]
    kw = dict(steps=steps, batch=MESH_TRAIN["batch"],
              seq=MESH_TRAIN["seq"], use_reduced=False, log_every=1000,
              keep_params=True)
    tmp = tempfile.TemporaryDirectory()
    dist.init_process_group("nccl", store=dist.FileStore(
        f"{tmp.name}/store", 1), rank=0, world_size=1)
    runs = {}
    check_capture_gc()
    try:
        mesh = DeviceMesh("cuda", torch.zeros((1, 1), dtype=int),
                          mesh_dim_names=("data", "model"))
        kinds = {"placed": (mesh, None), "placed_eager": (mesh, False),
                 "unplaced": (None, None)}
        for kind in ("unplaced", "placed", "placed_eager", "placed_eager",
                     "placed", "unplaced"):
            m, graph = kinds[kind]
            r = mesh_run(cfg, m, counters, graph=graph, **kw)
            ends = r["ends"]
            r["ms"] = (ends[-1] - ends[0]) * 1e3 / (len(ends) - 1)
            res = r.pop("res")
            r["graph"] = res.get("step_graph")
            if kind not in runs:        # the first run of a kind is compared
                r["params"] = _full_params(res)
            del res
            runs.setdefault(kind, []).append(r)
        want = check_mesh_turns(runs, cfg, steps, card)
        mesh_resume(cfg, mesh, counters, kw, runs["placed"][0], card)
        full = mesh_full_depth(mesh, card, counters)
    finally:
        dist.destroy_process_group()
        tmp.cleanup()
    for k, n in want.items():
        rows[k]["launches"] += 2 * n + full["launches"][k]
        rows[k].setdefault("launches_by_path", {})[
            "production mesh (1, 1), 2 placed captured runs"] = 2 * n
        rows[k]["launches_by_path"][
            "production mesh (1, 1), full depth"] = full["launches"][k]
        rows[k].setdefault("replayed_by_path", {})[
            "production mesh (1, 1), full depth"] = full["replayed"].get(k, 0)


def check_mesh_turns(runs, cfg, steps, card) -> dict:
    """Phase 14 (a)'s turns at 4 layers, logged and held: the placed
    captured run bitwise to the placed eager run and to the unplaced
    captured run; every run's launches (the replayed share) and
    ``shard_constraint`` calls equal to their derivation. Returns the
    derived launches of one run."""
    placed = runs["placed"][0]
    same = {kind: runs[kind][0]["losses"] == placed["losses"] and all(
        torch.equal(a, b) for a, b in zip(runs[kind][0]["params"],
                                          placed["params"]))
        for kind in ("placed_eager", "unplaced")}
    want = train_plan(cfg, q=1, steps=steps)["launches"]
    replay_want = {k: n for k, n in train_plan(
        cfg, q=1, steps=steps - 1)["launches"].items() if n}
    calls = {"placed": mesh_constraint_plan(cfg, steps, captured=True),
             "placed_eager": mesh_constraint_plan(cfg, steps),
             "unplaced": 0}
    log(f"phase 14 (a): {MESH_TRAIN['arch']} full width cut to "
        f"{cfg.n_layers} layers, {steps} cascaded steps of "
        f"{MESH_TRAIN['batch']} x {MESH_TRAIN['seq']} tokens on a one-rank "
        f"NCCL (1, 1) mesh, DTensor parameters, through the captured step: "
        f"losses {placed['losses']}; losses and params bitwise equal to the "
        f"placed eager run's {same['placed_eager']} and to the unplaced "
        f"captured run's {same['unplaced']}")
    for kind in ("placed", "unplaced"):
        g = runs[kind][0]["graph"]
        log(f"phase 14 (a): the {kind} step's graph: capture "
            f"{g['capture_s'][0]:.3f} s, {g['nodes'][0]} nodes "
            f"({g['kernel_nodes'][0]} kernel nodes), {g['replays'][0]} "
            f"replays")
    log(f"phase 14 (a): launches placed captured {placed['launches']} "
        f"({placed['replayed']} replayed), placed eager "
        f"{runs['placed_eager'][0]['launches']}, unplaced "
        f"{runs['unplaced'][0]['launches']}; derived {want} ({replay_want} "
        f"replayed); shard_constraint calls placed captured "
        f"{placed['calls']} (derived {calls['placed']}: (1 + 1) x [2 "
        f"forwards x (2 + 4 a layer) + 4 a layer recomputed], step 0 and "
        f"the capture), placed eager {runs['placed_eager'][0]['calls']} "
        f"(derived {calls['placed_eager']}: {steps} steps), unplaced "
        f"{runs['unplaced'][0]['calls']}")
    log(f"phase 14 (a): ms a step (host clock after a synchronise, steps "
        f"1..{steps - 1}) placed captured "
        f"{[round(r['ms'], 3) for r in runs['placed']]}, placed eager "
        f"{[round(r['ms'], 3) for r in runs['placed_eager']]}, unplaced "
        f"captured {[round(r['ms'], 3) for r in runs['unplaced']]} (in "
        f"turns: unplaced, placed, placed eager, placed eager, placed, "
        f"unplaced) on {card}")
    if not all(same.values()):
        raise AssertionError(f"the placed captured run differs: {same}")
    for kind, rs in runs.items():
        for r in rs:
            if {k: r["launches"][k] for k in want} != want:
                raise AssertionError(f"phase 14 (a) {kind} launches "
                                     f"{r['launches']}, want {want}")
            if r["calls"] != calls[kind]:
                raise AssertionError(f"phase 14 (a) {kind} shard_constraint "
                                     f"calls {r['calls']}, want "
                                     f"{calls[kind]}")
            if r["replayed"] != ({} if kind == "placed_eager"
                                 else replay_want):
                raise AssertionError(f"phase 14 (a) {kind} replayed "
                                     f"{r['replayed']}, want {replay_want}")
    return want


def mesh_resume(cfg, mesh, counters, kw, straight, card, root=None,
                what="phase 14 (a)") -> dict:
    """Phase 14 (a): the placed run saved and resumed, captured: 1 step
    saved (every leaf gathered whole, the checkpoint in ``checkpoint/io``'s
    format), then ``train(mesh=, resume=)`` to the run's 3 steps (the
    restored trees placed again). Its losses and final parameters must be
    bitwise the straight placed run's (``straight``, the first placed run
    of the turns); logs the save's and the restore's seconds (the mesh's
    first rank saves, the others gather and wait). ``root``: a
    directory every rank of the mesh sees, which the caller removes (by
    default one of this process's own, removed here). Returns the
    checkpoint's path, the saved run's parameters gathered whole, by path,
    and the seconds."""
    import shutil
    import tempfile
    import torch.distributed as dist
    from repro_torch.federation import session
    writer = dist.get_rank() == int(mesh.mesh.flatten()[0])
    own = root is None
    if own:
        build = Path(__file__).resolve().parent / "build"
        build.mkdir(exist_ok=True)
        root = tempfile.mkdtemp(prefix="chip_smoke_mesh_", dir=build)
    inner, restores = session.Federation.restore, []

    def timed_restore(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*a, **k)
        torch.cuda.synchronize()
        restores.append(time.perf_counter() - t0)
        return out
    session.Federation.restore = timed_restore
    try:
        first = mesh_run(cfg, mesh, counters, **dict(
            kw, steps=MESH_RESUME_AT, checkpoint_path=f"{root}/ck"))
        rest = mesh_run(cfg, mesh, counters,
                        **dict(kw, resume=f"{root}/ck"))
    finally:
        session.Federation.restore = inner
        if own:
            shutil.rmtree(root, ignore_errors=True)
    saved = _full_by_path(first["res"])
    params = _full_params(rest["res"])
    losses = first["losses"] + rest["losses"]
    same = losses == straight["losses"] and all(
        torch.equal(a, b) for a, b in zip(params, straight["params"]))
    graph = rest["res"].get("step_graph") or {}
    log(f"{what}: the placed run saved after step {MESH_RESUME_AT} "
        f"(fed.save {[round(t, 3) for t in first['saves']]} s) and "
        f"resumed (Federation.restore {[round(t, 3) for t in restores]} s) "
        f"to {kw['steps']} steps, its resumed steps captured "
        f"({graph.get('graphs')} graph, replays {graph.get('replays')}): "
        f"losses {losses}; losses and params bitwise the straight placed "
        f"run's: {same} on {card}")
    if not (same and len(first["saves"]) == int(writer)
            and len(restores) == 1):
        raise AssertionError(f"the resumed placed run differs: {losses} "
                             f"against {straight['losses']}")
    return dict(ck=f"{root}/ck", saved=saved, save_s=first["saves"],
                restore_s=restores, capture_s=graph.get("capture_s"))


def mesh_full_depth(mesh, card, counters, what="phase 14 (a)",
                    keep=False) -> dict:
    """``train(mesh=)`` at Phi-3-mini's full width and depth on the (1,
    1) mesh (or ``mesh``), through the captured step, as phase 5 times
    the unplaced step: TRAIN_STEPS steps of TRAIN's batch, steps
    TRAIN_WARMUP .. TRAIN_STEPS - 2 timed, the last a profiled replay;
    losses finite and falling, launches and ``shard_constraint`` calls
    equal to their derivation. ``keep``: the result also holds the run's
    losses and a copy of each parameter's local shard, by path."""
    from repro_torch.configs import get_config
    cfg = get_config(MESH_TRAIN["arch"])
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    r = mesh_run(cfg, mesh, counters, profile_at=TRAIN_STEPS - 1,
                 steps=TRAIN_STEPS, use_reduced=False, log_every=1000,
                 keep_params=keep, **TRAIN)
    wall = time.perf_counter() - t0
    timed = r["ends"][TRAIN_WARMUP - 1:TRAIN_STEPS - 1]
    ms = (timed[-1] - timed[0]) * 1e3 / (len(timed) - 1)
    stats = r["res"]["step_graph"]
    want = train_plan(cfg, q=1, steps=TRAIN_STEPS)["launches"]
    replay_want = {k: n for k, n in train_plan(
        cfg, q=1, steps=TRAIN_STEPS - 1)["launches"].items() if n}
    calls = mesh_constraint_plan(cfg, TRAIN_STEPS, captured=True)
    losses = r["losses"]
    shape = tuple(mesh.shape)
    log(f"{what}: {MESH_TRAIN['arch']} at full width and depth "
        f"({cfg.n_layers} layers) on the {shape} mesh, placed, through the "
        f"captured step: {TRAIN_STEPS} steps of {TRAIN['batch']} x "
        f"{TRAIN['seq']} tokens, {ms:.3f} ms a step (host clock after a "
        f"synchronise, steps {TRAIN_WARMUP}..{TRAIN_STEPS - 2}; step "
        f"{TRAIN_STEPS - 1} profiled) on {card}; peak memory "
        f"{r['peak'] / 2**30:.2f} GiB above what was held; whole call "
        f"{wall:.2f} s (weights drawn and placed included); capture "
        f"{stats['capture_s'][0]:.3f} s, {stats['nodes'][0]} nodes "
        f"({stats['kernel_nodes'][0]} kernel nodes), "
        f"{stats['replays'][0]} replays; launches {r['launches']} "
        f"({r['replayed']} replayed), derived {want} ({replay_want}); "
        f"shard_constraint calls {r['calls']} (derived {calls}); losses "
        f"{[round(x, 4) for x in losses]}")
    log_profile(f"{what} profile, step {TRAIN_STEPS - 1} of the "
                f"placed {MESH_TRAIN['arch']} (a replay) on {card}",
                r["profile"])
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all() or \
            not float(np.mean(losses[-5:])) < losses[0]:
        raise AssertionError(f"placed full-depth losses {losses}")
    if {k: r["launches"][k] for k in want} != want or \
            r["replayed"] != replay_want or r["calls"] != calls:
        raise AssertionError(f"placed full depth: launches {r['launches']} "
                             f"({r['replayed']} replayed), calls "
                             f"{r['calls']}; want {want} ({replay_want}), "
                             f"{calls}")
    out = dict(ms=ms, peak=r["peak"], wall=wall, launches=r["launches"],
               replayed=r["replayed"], busy=r["profile"]["busy_us"]
               / r["profile"]["wall_us"], capture_s=stats["capture_s"])
    if keep:
        out["losses"] = losses
        out["local"] = _local_by_path(r["res"])
    del r
    gc.collect()
    torch.cuda.empty_cache()
    return out


def local_param_bytes(cfg, seq_len) -> int:
    """One rank's parameter bytes on the (16, 16) mesh: each leaf's shard
    as ``resolve_spec`` gives it under ``PARAM_RULES``."""
    from repro_torch.models.common import torch_dtype
    from repro_torch.models.model_api import build_model
    from repro_torch.sharding.rules import PARAM_RULES, resolve_spec
    from repro_torch.tree import tree_leaves
    axes = {"data": 16, "model": 16}
    total = 0
    for s in tree_leaves(build_model(cfg, max_seq=seq_len).param_specs):
        logical = s.logical or (None,) * len(s.shape)
        spec = resolve_spec(axes, s.shape, logical, PARAM_RULES)
        n = math.prod(s.shape)
        for entry in spec:
            for a in (() if entry is None else
                      (entry,) if isinstance(entry, str) else entry):
                n //= axes[a]
        total += n * torch_dtype(s.dtype).itemsize
    return total


def dryrun_checks(t0, procs, card) -> None:
    """(b) the dry runs' results: parameter bytes, FLOPs against 6·N·D,
    the fit against the traced 4-layer count, and the roofline terms."""
    from repro_torch.configs import get_config
    outs = join_dryruns(procs)
    t_dry = time.perf_counter() - t0
    for line in outs[0].splitlines():
        if line.startswith("[dryrun]"):
            log(f"  {line}")
    res = json.loads((DRYRUN_OUT / "phi3-mini-3.8b_train_4k_16x16_"
                      "baseline.json").read_text())
    fit = json.loads((DRYRUN_OUT / "fit.json").read_text())
    cfg = get_config("phi3-mini-3.8b")
    mem, r = res["memory"], res["roofline"]
    want_bytes = local_param_bytes(cfg, 4096)
    ratio = r["flops_per_dev"] * r["n_devices"] / r["model_flops"]
    log(f"phase 14 (b): dry run of phi3-mini-3.8b train_4k at (16, 16) on "
        f"a fake 256-rank group (no card), {res['trace_s']} s of probe "
        f"traces, both children {t_dry:.1f} s: per-device parameter bytes "
        f"{mem['param_bytes_per_dev']} (the shards resolve_spec gives: "
        f"{want_bytes}); counted FLOPs x 256 / 6·N·tokens = {ratio:.4f} "
        f"(the cascaded step runs the clean forward, its backward (2x), "
        f"remat's second forward and the ZOO lane's forward: 10·N·tokens "
        f"against 6, 1.67, plus attention, which 6·N leaves out, and "
        f"minus the embedding's N, which runs no product)")
    log(f"phase 14 (b): spec-peak arithmetic (H100 SXM datasheet: 989 "
        f"TFLOP/s bf16, 3.35 TB/s HBM, 450 GB/s NVLink within 8 GPUs, "
        f"50 GB/s a NIC across; not measured): compute "
        f"{r['compute_s'] * 1e3:.3f} ms, memory {r['memory_s'] * 1e3:.3f} "
        f"ms (eager bytes, no fusion), collective "
        f"{r['collective_s'] * 1e3:.3f} ms ({r['coll_by_axis']}), bound "
        f"{r['bottleneck']}, peak "
        f"{mem['peak_hbm_estimate_per_dev'] / 2**30:.2f} GiB a device")
    log_collective_sites(res)
    traced, fr, fm = fit["traced"], fit["roofline"], fit["memory"]
    exact = (fr["flops_per_dev"] == traced["flops"]
             and fr["bytes_per_dev"] == traced["bytes"]
             and fr["coll_bytes_per_dev"] == traced["coll_bytes"]
             and fit["coll_by_site"] == traced["coll_by_site"]
             and fm["output_bytes_per_dev"] == traced["output_bytes"]
             and fm["temp_bytes_per_dev"] == traced["peak_bytes"])
    log(f"phase 14 (b): phi3 cut to {DRYRUN_FIT_LAYERS} layers: the fit "
        f"from 1 and 2 layers (FLOPs {fr['flops_per_dev']:.6e}, bytes "
        f"{fr['bytes_per_dev']:.6e}, collective bytes "
        f"{fr['coll_bytes_per_dev']:.6e} and by site, output bytes "
        f"{fm['output_bytes_per_dev']}) and from 2 and 3 (peak "
        f"{fm['temp_bytes_per_dev']} B) equals the traced count (FLOPs "
        f"{traced['flops']:.6e}, bytes {traced['bytes']:.6e}, collective "
        f"bytes {traced['coll_bytes']:.6e}, output bytes "
        f"{traced['output_bytes']:.0f}, peak {traced['peak_bytes']:.0f} "
        f"B): {exact}")
    if mem["param_bytes_per_dev"] != want_bytes:
        raise AssertionError("the dry run's parameter bytes differ from "
                             "the resolved shards")
    if ratio < 1.0:
        raise AssertionError(f"the dry run counted fewer FLOPs than "
                             f"6·N·tokens ({ratio:.4f})")
    if not exact:
        raise AssertionError("the cost fit differs from the traced count")


def log_collective_sites(res, top: int = 12) -> None:
    """The dry run's collective bytes by mesh axis and kind, and its
    largest sites (``utils/comms.py``: axis, kind, the port's line)."""
    sites = res["coll_by_site"]
    total = sum(sites.values())
    by = {}
    for key, n in sites.items():
        axis, kind = key.split(" ")[:2]
        by[f"{axis} {kind}"] = by.get(f"{axis} {kind}", 0) + n
    log("phase 14 (b): collective bytes by axis and kind: " + ", ".join(
        f"{k} {int(v)} B ({100 * v / total:.2f}%)"
        for k, v in sorted(by.items(), key=lambda kv: -kv[1])))
    for key, n in sorted(sites.items(), key=lambda kv: -kv[1])[:top]:
        log(f"  {int(n):>15d} B {100 * n / total:6.2f}%  {key}")


def mesh_phase(rows, card, counters, dry) -> None:
    """Phase 14: the production mesh."""
    t_phase = time.perf_counter()
    mesh_train(rows, card, counters)
    t1 = time.perf_counter()
    log(f"phase 14 (a): {t1 - t_phase:.1f} s")
    dryrun_checks(*dry, card)
    log(f"phase 14 (b): {time.perf_counter() - t1:.1f} s (waiting for the "
        f"children included)")
    log(f"mesh phase: {time.perf_counter() - t_phase:.1f} s on {card}")


MESH_RANK = "--mesh-rank"        # argv[1] of one rank's process
MESH_RANKS = "--mesh-ranks"      # argv[1] of the D-card run
MESH_TURN = "--mesh-turn"        # argv[1] of one rank's process of a turn
AGAINST = "--against"            # --mesh-ranks D --against DIR
# the turns of ``--against DIR`` at full depth: DIR's tree ("against")
# and this one in turns on every card, then this one at (1, 1) on one
MESH_TURNS = ("against", "this", "this", "against")
# the ("data", "model") meshes of a D-card run: both axes at D = 4; at
# D = 2 each axis alone, the model axis first; (1, 1) at D = 1
MESH_SHAPES = {1: ((1, 1),), 2: ((1, 2), (2, 1)), 4: ((2, 2),)}
# the placed f32 run against the unplaced one, as
# tests/test_torch_production_mesh.py holds them on gloo: the loss and the
# server's leaves after one step and the second step alone; the client's
# ZOO-updated leaves at repro's fused-vs-unrolled ZOO tolerance
MESH_SERVER_TOL = dict(rtol=1e-5, atol=1e-5)
MESH_ZOO_TOL = dict(rtol=2e-3, atol=5e-4)
# a server leaf's placed update, fitted as a scalar times the unplaced
# one, within 1 ± this: a dropped (0) or doubled (2) update fails
MESH_UPDATE_SCALE = 0.5
# the client's placed update scale against its own run's ĥ − h, in f32
# spacings of the loss: the ranks' partial losses round ĥ − h by at most
# one
MESH_CLIENT_SPACINGS = 2
# the seeds of the starts one ulp away whose runs set the f32 floor
MESH_FLOOR_SEEDS = (1, 2, 3)
# the dry run's trace of the step at each mesh of a D-card run, on a fake
# group of D (argv: OUT WORLD SHAPES ARCH LAYERS BATCH SEQ)
MESH_TRACE = """
import json, sys
import torch
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.configs import cut_depth, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import costmodel
from repro_torch.launch.dryrun import fake_group
out, world, shapes = sys.argv[1], int(sys.argv[2]), json.loads(sys.argv[3])
cfg = cut_depth(get_config(sys.argv[4]), int(sys.argv[5]))
step = ShapeConfig("train", int(sys.argv[7]), int(sys.argv[6]), "train")
fake_group(world)
res = {}
for data, model in shapes:
    mesh = DeviceMesh("cpu", torch.arange(world).reshape(data, model),
                      mesh_dim_names=("data", "model"))
    # the training CLI's cascaded step: the fused lanes
    r = costmodel.measure(cfg, step, mesh, fused_dual=True)
    res[f"{data}x{model}"] = dict(
        by_axis_kind=r["coll_by_axis_kind"], by_kind=r["coll_by_kind"],
        by_axis=r["coll_by_axis"], by_site=r["coll_by_site"],
        shapes_by_site=r["coll_shapes_by_site"], trace_s=r["trace_s"])
json.dump(res, open(out, "w"))
"""


def _local_by_path(res) -> dict:
    """A copy of each of a result's final parameters' local shard (a
    DTensor's ``to_local()``), by path (``_leaves``)."""
    return {k: getattr(p, "to_local", lambda p=p: p)().clone()
            for k, p in _leaves(res["params"])}


SITE_RANGE = "collective at "    # a profiler range around one collective


def _kernels_below(event) -> list:
    """The device kernels a profiler event and the events under it
    launched, by name."""
    names = [k.name for k in event.kernels]
    for child in event.cpu_children:
        names += _kernels_below(child)
    return names


def step_probe(mesh, vocab: int):
    """A ``utils.comms.CommRecorder`` for one step on ``mesh`` that also
    keeps the step's four largest local tensors (bytes, op, shape, dtype,
    site), by shape the tensors the backward makes whose last dim is the
    padded vocabulary, whole or a model shard of it (the loss gradient
    DTensor expands to the logits), and, from a profile of the step with
    each collective in a range named by its axis, kind and site, the
    NCCL kernels each site launched (``site_kernels``: {"axis kind site":
    {kernel: count}})."""
    from torch.distributed.tensor import DTensor
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.utils import comms
    from repro_torch.utils.comms import CommRecorder, _site
    model = dict(zip(mesh.mesh_dim_names, mesh.shape))["model"]

    class Probe(CommRecorder):
        def __init__(self):
            super().__init__(mesh)
            self.largest, self.vocab_grads = [], {}
            self.site_kernels, self._prof = {}, None

        def __enter__(self):
            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.__enter__()
            return super().__enter__()

        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            torch.cuda.synchronize()
            self._prof.__exit__(*exc)
            for e in self._prof.events():
                if e.name.startswith(SITE_RANGE):
                    named = self.site_kernels.setdefault(
                        e.name[len(SITE_RANGE):], {})
                    for k in _kernels_below(e):
                        named[k] = named.get(k, 0) + 1
            self._prof = None
            return out

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = getattr(func, "_overloadpacket", func).__name__
            kind = comms._KINDS.get(name.split(".")[-1])
            if kind is not None and not any(t == DTensor for t in types):
                group = args[-1] if args and isinstance(args[-1], str) \
                    else None
                axis = self._axes.get(group, "?")
                with record_function(f"{SITE_RANGE}{axis} {kind} {_site()}"):
                    return self._looked_at(func, types, args, kwargs)
            return self._looked_at(func, types, args, kwargs)

        def _looked_at(self, func, types, args, kwargs):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is NotImplemented or any(t == DTensor for t in types) \
                    or func.is_view:
                return out
            backward = torch._C._current_graph_task_id() != -1
            for t in torch.utils._pytree.tree_leaves(out):
                if not isinstance(t, torch.Tensor):
                    continue
                n = t.numel() * t.element_size()
                if backward and t.ndim and t.shape[-1] in (vocab,
                                                           vocab // model):
                    e = self.vocab_grads.setdefault(
                        f"{tuple(t.shape)} {t.dtype}", [0, 0])
                    e[0] += 1
                    e[1] = max(e[1], n)
                if len(self.largest) < 4 or n > self.largest[-1][0]:
                    self.largest.append((n, str(func), tuple(t.shape),
                                         str(t.dtype), _site()))
                    self.largest.sort(key=lambda e: -e[0])
                    del self.largest[4:]
            return out
    return Probe()


def _fail(res, what, msg) -> None:
    """A failed gate of a rank: recorded, and the rank goes on, so every
    rank keeps issuing the same collectives."""
    log(f"{what}: FAILED: {msg}")
    res["failures"].append(f"{what}: {msg}")


def rank_turns(res, what, cfg, mesh, counters, kw) -> dict:
    """Gates 1, 4, 5 and 6 of :func:`mesh_ranks` at 4 layers: the placed
    captured run and the placed eager run in turns (captured, eager,
    eager, captured). Each rank holds the first two bitwise (losses and
    every leaf's local shard) and every run's losses equal to the first's;
    each run's flash and RMSNorm launches, their replayed share and its
    ``shard_constraint`` calls equal to their derivation; the flash
    kernel's query shard at this mesh's heads. The first eager run's step
    0 runs under :func:`step_probe` (its collectives by axis, kind and
    bytes, for the parent to hold to the dry run's trace). Returns the
    first captured run as :func:`mesh_resume` takes its straight run."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.utils import comms
    steps, data, model = kw["steps"], *mesh.shape
    runs = {"captured": [], "eager": []}
    probe = step_probe(mesh, cfg.padded_vocab)
    for graph in (None, False, False, None):
        kind = "captured" if graph is None else "eager"
        first = not runs[kind]
        probed = first and kind == "eager"
        with contextlib.ExitStack() as stack:
            caps = [stack.enter_context(Capture(m, a, [0])) for m, a in (
                (flash_ops, "flash_attention_bshd"), (rms_ops, "rmsnorm"))
                    ] if probed else []
            r = mesh_run(cfg, mesh, counters, graph=graph,
                         within={0: probe} if probed else None,
                         detail=first and kind == "captured", **kw)
        ends = r["ends"]
        r["ms"] = (ends[-1] - ends[0]) * 1e3 / (len(ends) - 1)
        result = r.pop("res")
        r["capture_s"] = (result.get("step_graph") or {}).get("capture_s")
        if first:
            r["local"] = _local_by_path(result)
            if kind == "captured":
                r["params"] = _full_params(result)
        if caps:
            r["kernel_shapes"] = {c.attr: tuple(c.inputs[0][0][0].shape)
                                  for c in caps}
        del result
        runs[kind].append(r)
    cap, eag = runs["captured"][0], runs["eager"][0]
    same = cap["losses"] == eag["losses"] and all(
        torch.equal(v, eag["local"][k]) for k, v in cap["local"].items())
    losses_same = all(r["losses"] == cap["losses"]
                      for rs in runs.values() for r in rs)
    want = {k: n for k, n in train_plan(cfg, q=1, steps=steps)[
        "launches"].items() if n}
    replay_want = {k: n for k, n in train_plan(
        cfg, q=1, steps=steps - 1)["launches"].items() if n}
    calls = {"captured": mesh_constraint_plan(cfg, steps, captured=True),
             "eager": mesh_constraint_plan(cfg, steps)}
    shapes = eag["kernel_shapes"]
    q_want = (kw["batch"] // data, kw["seq"], cfg.n_heads // model,
              cfg.resolved_head_dim)
    log(f"{what}: {MESH_TRAIN['arch']} at full width cut to {cfg.n_layers} "
        f"layers, {steps} cascaded steps of {kw['batch']} x {kw['seq']} "
        f"tokens, in turns (captured, eager, eager, captured): losses "
        f"{cap['losses']}; captured == eager bitwise (losses and every "
        f"local shard): {same}; every run's losses the same: "
        f"{losses_same}; ms a step (steps 1..{steps - 1}) captured "
        f"{[round(r['ms'], 3) for r in runs['captured']]}, eager "
        f"{[round(r['ms'], 3) for r in runs['eager']]}; capture s "
        f"{[r['capture_s'] for r in runs['captured']]}")
    log(f"{what}: launches captured "
        f"{[r['launches'] for r in runs['captured']]} (replayed "
        f"{[r['replayed'] for r in runs['captured']]}), eager "
        f"{[r['launches'] for r in runs['eager']]}; derived {want} "
        f"({replay_want} replayed); shard_constraint calls captured "
        f"{[r['calls'] for r in runs['captured']]}, eager "
        f"{[r['calls'] for r in runs['eager']]} (derived {calls}); the "
        f"kernels' local operands: flash q {shapes['flash_attention_bshd']} "
        f"(want {q_want}: {cfg.n_heads // model} of {cfg.n_heads} heads), "
        f"RMSNorm x {shapes['rmsnorm']}")
    g = cap["graphs"][0]
    log(f"{what}: the captured step's graph: capture {g['capture_s']:.4f} "
        f"s, nodes {g['node_kinds']}, NCCL kernels {g['nccl'] or 'none'}")
    log(f"{what}: the eager step 0's largest local tensors "
        f"{probe.largest}; backward tensors over the vocabulary (shape: "
        f"count, largest bytes) {probe.vocab_grads}")
    if not same:
        _fail(res, what, "the captured run differs from the eager run")
    if not losses_same:
        _fail(res, what, "the turns' losses differ")
    for kind, rs in runs.items():
        for r in rs:
            if {k: r["launches"].get(k, 0) for k in want} != want or \
                    r["replayed"] != ({} if kind == "eager"
                                      else replay_want) or \
                    r["calls"] != calls[kind]:
                _fail(res, what, f"{kind} launches {r['launches']} "
                      f"(replayed {r['replayed']}), calls {r['calls']}")
    if shapes["flash_attention_bshd"] != q_want:
        _fail(res, what, f"flash q {shapes['flash_attention_bshd']}")
    res.update(
        losses=cap["losses"], turn_losses=[r["losses"] for rs in
                                           runs.values() for r in rs],
        ms={k: [r["ms"] for r in rs] for k, rs in runs.items()},
        capture_s=[r["capture_s"] for r in runs["captured"]],
        graph=g, comms=comms.summary(probe.records), largest=probe.largest,
        vocab_grads=probe.vocab_grads, site_kernels=probe.site_kernels,
        kernel_shapes=shapes,
        launches=cap["launches"], replayed=cap["replayed"])
    return cap


def rank_resume(res, what, cfg, mesh, counters, kw, straight, root,
                card) -> None:
    """Gate 7: :func:`mesh_resume` at a directory every rank sees (saved
    at step 1 and resumed to 3, bitwise the straight run on every rank),
    then the checkpoint restored unplaced on the mesh's first rank,
    parameters bitwise the saved run's gathered whole."""
    import torch.distributed as dist
    from repro_torch.federation import Federation
    out = None
    try:
        out = mesh_resume(cfg, mesh, counters, kw, straight, card,
                          root=str(root), what=what)
    except AssertionError as e:
        _fail(res, what, f"resume: {e}")
    res["resume"] = out and {k: out[k] for k in ("save_s", "restore_s",
                                                   "capture_s")}
    dist.barrier()
    if dist.get_rank() == 0 and out is not None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, params, _ = Federation.restore(out["ck"], device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        loaded = dict(_leaves(params))
        same = loaded.keys() == out["saved"].keys() and all(
            torch.equal(v, out["saved"][k]) for k, v in loaded.items())
        log(f"{what}: the checkpoint of step {MESH_RESUME_AT} restored "
            f"unplaced on one card ({load_s:.3f} s): parameters bitwise "
            f"the placed run's gathered whole: {same}")
        res["unplaced_load"] = dict(same=same, restore_s=load_s)
        if not same:
            _fail(res, what, "the unplaced load differs")
        del params, loaded
    del out
    dist.barrier()


def _allclose_worst(got, want, rtol, atol):
    """(within, worst |got - want| over atol + rtol·|want|) in f32, as
    ``numpy.testing.assert_allclose`` holds it."""
    ratio = float(((got - want).abs() / (atol + rtol * want.abs())).max())
    return ratio <= 1.0, ratio


def one_ulp(tree, seed: int = 1):
    """``tree`` with every entry moved one f32 ulp, up or down at random
    (a seeded draw on the card): one rounding of a run's inputs."""
    from repro_torch.tree import tree_map
    g = torch.Generator("cuda").manual_seed(seed)

    def move(t):
        up = torch.rand(t.shape, generator=g, device=t.device) < 0.5
        return torch.nextafter(t, torch.where(up, torch.inf, -torch.inf))
    return tree_map(move, tree)


def _fit(dg, dw) -> float:
    """The scalar c that best fits ``dg ≈ c·dw`` (least squares, in
    f64); nan where ``dw`` is 0."""
    dg, dw = dg.double(), dw.double()
    n = float((dw * dw).sum())
    return float((dg * dw).sum()) / n if n else math.nan


def f32_leaf(path, g, w, start, client, floor, signal, spacing) -> list:
    """The parts of :func:`f32_check` for one leaf: the placed value ``g``
    and the unplaced ``w``, both one step from ``start``, as
    ``[(name, share of its tolerance)]`` (1 is the limit). A client leaf
    (q = 1: its update is φ/μ·(ĥ − h)·u, u the same draws in both runs):
    "client", the value at MESH_ZOO_TOL; "update x scalar", the update
    the unplaced one times the fitted scalar c within two f32 roundings
    of the start; "client scale", c times the unplaced run's ĥ − h
    (``signal[1]``) the placed run's own (``signal[0]``) within
    MESH_CLIENT_SPACINGS of the loss's f32 spacing; "update 1%", logged.
    A server leaf: "server", the value within MESH_SERVER_TOL or within
    twice ``floor``; "server update", the update's fitted scalar within
    1 ± MESH_UPDATE_SCALE; "server 1e-5", logged."""
    dg, dw = g - start, w - start
    c = _fit(dg, dw)
    if client:
        step = float(dw.abs().max())
        ulp = float(torch.finfo(torch.float32).eps * start.abs().max())
        return [("client", _allclose_worst(g, w, **MESH_ZOO_TOL)[1]),
                ("update 1%", float((dg - dw).abs().max())
                 / (1e-2 * step + ulp)),
                ("update x scalar", float((dg - c * dw).abs().max())
                 / (2 * ulp)),
                ("client scale", abs(c * signal[1] - signal[0])
                 / (MESH_CLIENT_SPACINGS * spacing))]
    strict = _allclose_worst(g, w, **MESH_SERVER_TOL)[1]
    return [("server 1e-5", strict),
            ("server", min(strict, float((g - w).abs().max())
                           / max(2 * floor, 1e-30))),
            ("server update", abs(c - 1) / MESH_UPDATE_SCALE)]


# the parts of f32_check that are logged, not held: the test's own forms,
# which rounding alone exceeds here (PERF.md §6)
F32_LOGGED = ("update 1%", "server 1e-5")


def f32_check(got_loss, got, want_loss, want, clients, start, floor,
              signal, spacing) -> dict:
    """``tests/test_torch_production_mesh.py``'s ``_check`` of a placed
    f32 step (``got``) against the unplaced one (``want``), both from
    ``start``, in the forms a full-width f32 step can meet: the loss at
    rtol 1e-5 and each leaf by :func:`f32_leaf`, the value and the
    update both. At full width the gradients of the query and key
    projections and the norm scales run through the softmax's backward,
    whose cancellation turns a rounding of its inputs into a change of
    10–20% of the update (``PERF.md`` §6), so sums split across
    ranks cannot meet the test's 1e-5 there: a server leaf's value is
    held within twice ``floor`` (the largest change of the unplaced
    update when its start moves one f32 ulp, MESH_FLOOR_SEEDS, or when
    the host's CPU computes it), and its update, which that floor alone
    would not hold, by its fitted scalar. The ZOO lane's ĥ − h is a few
    f32 spacings of the loss, so the ranks' rounding of the loss moves
    the client's update scale by more than the test's 1%: the client's
    update is held to its direction and to the scale its own run's ĥ − h
    gives. The controls: every leaf's update zeroed, and doubled, in
    the placed run, each of which must fail its leaf's parts (a gate
    that cannot see a dropped update holds nothing). Returns the worst
    share of its tolerance of each part, its leaf, the fitted scalars,
    and the leaves whose control passed."""
    worst = {"loss": abs(got_loss - want_loss) / (1e-5 * abs(want_loss))}
    where, scalars, blind = {}, {}, []
    for path, w in want.items():
        g, s0 = got[path], start[path]
        args = (path in clients, floor[path], signal, spacing)
        scalars[path] = _fit(g - s0, w - s0)
        for name, ratio in f32_leaf(path, g, w, s0, *args):
            if ratio > worst.get(name, -1.0):
                worst[name], where[name] = ratio, path
        for control, moved in (("zeroed", s0), ("doubled", 2 * g - s0)):
            if all(r <= 1.0 for n, r in f32_leaf(path, moved, w, s0, *args)
                   if n not in F32_LOGGED):
                blind.append(f"{path} {control}")
    server = [c for p, c in scalars.items() if p not in clients]
    return dict(worst=worst, where=where, blind=blind,
                scalars={p: c for p, c in scalars.items() if p in clients},
                server_scalars=(min(server), max(server)),
                held=not blind and all(v <= 1.0 for k, v in worst.items()
                                       if k not in F32_LOGGED))


def rank_f32(res, what, cfg, mesh, counters, kw, root) -> None:
    """Gate 3: Phi-3 at 4 layers in f32 (``param_dtype``; TF32 off),
    placed: 1 and 2 captured steps, every leaf gathered whole. On the
    mesh's first rank, against the unplaced f32 run on its card, as
    ``tests/test_torch_production_mesh.py`` holds them at :196-221 (the
    second step alone: the unplaced run resumed from the placed run's own
    first step, its checkpoint's parameters swapped), by
    :func:`f32_check`, each leaf's value and update, whose floor comes
    from the same unplaced steps taken again from starts moved one ulp
    (:func:`one_ulp`, a seed of MESH_FLOOR_SEEDS each) and on the host's
    CPU from the same starts (two valid evaluations, as phases 9 and 10
    judge random weights), and whose client scale comes from each run's
    own ĥ − h; logs each leaf's difference beside its update, its fitted
    scalar and its floors for both steps, the largest difference from
    the unplaced 2 steps, and the first step whose loss differs."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.federation import Federation
    from repro_torch.models import common, model_api
    from repro_torch.tree import tree_map
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    placed = {}
    for steps in (1, 2):
        r = mesh_run(cfg32, mesh, counters, **dict(kw, steps=steps))
        placed[steps] = dict(losses=r["losses"], pert=r["perturbed"],
                             params=tree_map(
            lambda t: t.full_tensor() if isinstance(t, DTensor) else t,
            r["res"]["params"]))
        del r
    res["f32_losses"] = placed[2]["losses"]
    if dist.get_rank() == 0:
        model = model_api.build_model(cfg32, max_seq=kw["seq"])
        p0 = common.materialize(model.param_specs,
                                torch.Generator("cuda").manual_seed(0),
                                device="cuda")
        clients = {p for p, _ in _leaves(p0)
                   if p.split("/")[1] in model.client_keys}

        def unplaced(steps, start=None, device="cuda", **more):
            """The unplaced run on ``device``, from ``start`` (swapped
            into a one-step checkpoint and resumed) where given."""
            if start is not None:
                fed, _, state = Federation.restore(f"{root}/f32_one",
                                                   device=device)
                fed.save(f"{root}/f32_swapped",
                         tree_map(lambda t: t.to(device), start),
                         step=state.step, opt_state=state.opt_state,
                         ledger=state.ledger, dp_releases=state.dp_releases,
                         metadata=state.metadata)
                more["resume"] = f"{root}/f32_swapped"
            r = mesh_run(cfg32, None, counters, **dict(
                kw, steps=steps, device=device, **more))
            return dict(r, params=dict(_leaves(r.pop("res")["params"])))
        u1 = unplaced(1, checkpoint_path=f"{root}/f32_one")
        u2 = unplaced(2)
        alone = unplaced(2, start=placed[1]["params"])
        g1, g2 = (dict(_leaves(placed[s]["params"])) for s in (1, 2))
        w1, w2, a2 = u1["params"], u2["params"], alone["params"]
        # the floor: the largest change of each leaf's update over the
        # same steps taken from starts moved one ulp, seed by seed
        inner, start0 = common.materialize, p0
        p0 = dict(_leaves(p0))
        floor1, floor2 = {}, {}
        for seed in MESH_FLOOR_SEEDS:
            common.materialize = (lambda *a, seed=seed, **k:
                                  one_ulp(inner(*a, **k), seed))
            try:
                u1m = unplaced(1)["params"]
            finally:
                common.materialize = inner
            g1m = one_ulp(placed[1]["params"], seed)
            a2m = unplaced(2, start=g1m)["params"]
            p0m, g1m = (dict(_leaves(t)) for t in (one_ulp(start0, seed),
                                                   g1m))
            for floor, got, start, ref, ref_start in (
                    (floor1, u1m, p0m, w1, p0), (floor2, a2m, g1m, a2, g1)):
                for k, w in ref.items():
                    floor[k] = max(floor.get(k, 0.0), float(
                        ((got[k] - start[k]) - (w - ref_start[k]))
                        .abs().max()))
            del u1m, a2m, p0m, g1m
        # and a second valid evaluation: the same unplaced steps from the
        # same starts on the host's CPU, whose BLAS rounds otherwise
        common.materialize = lambda *a, **k: tree_map(torch.Tensor.cpu,
                                                      start0)
        try:
            c1 = unplaced(1, device="cpu")["params"]
        finally:
            common.materialize = inner
        c2 = unplaced(2, start=placed[1]["params"], device="cpu")["params"]
        spread1, spread2 = ({k: float((got[k] - w.cpu()).abs().max())
                             for k, w in ref.items()}
                            for got, ref in ((c1, w1), (c2, a2)))
        ulp1, ulp2 = dict(floor1), dict(floor2)
        for floor, spread in ((floor1, spread1), (floor2, spread2)):
            for k, v in spread.items():
                floor[k] = max(floor[k], v)
        del c1, c2

        def lane(r, i):
            """Step ``i``'s ĥ − h of a run, and the larger f32 spacing
            of the two losses."""
            h, hh = r["losses"][i], float(np.mean(r["perturbed"][i]))
            return hh - h, float(max(np.spacing(np.float32(h)),
                                     np.spacing(np.float32(hh))))
        p2 = dict(placed[2], perturbed=placed[2]["pert"])
        (sp1, _), (su1, space1) = lane(p2, 0), lane(u1, 0)
        (sp2, _), (su2, space2) = lane(p2, 1), lane(alone, 0)
        first = f32_check(placed[1]["losses"][0], g1, u1["losses"][0], w1,
                          clients, p0, floor1, (sp1, su1), space1)
        second = f32_check(placed[2]["losses"][1], g2, alone["losses"][0],
                           a2, clients, g1, floor2, (sp2, su2), space2)
        # each leaf's largest difference after the step beside its largest
        # update, the update's fitted scalar and its floors, the leaves
        # furthest apart first
        leaves = {n: sorted(((k, float((g[k] - w).abs().max()),
                              float((w - s0[k]).abs().max()), ck["scalars"]
                              .get(k, _fit(g[k] - s0[k], w - s0[k])),
                              ulp[k], spread[k]) for k, w in ref.items()),
                            key=lambda e: -e[1] / max(e[2], 1e-30))
                  for n, g, ref, s0, ck, ulp, spread in (
                      ("first", g1, w1, p0, first, ulp1, spread1),
                      ("second", g2, a2, g1, second, ulp2, spread2))}
        diffs = {s: max(float((g[k] - w[k]).abs().max()) for k in w)
                 for s, g, w in ((1, g1, w1), (2, g2, w2))}
        apart = [i for i, (a, b) in enumerate(zip(placed[2]["losses"],
                                                  u2["losses"])) if a != b]
        signal = {"placed": [sp1, sp2], "unplaced": [su1],
                  "unplaced from the placed first step": [su2]}
        log(f"{what}: f32 (TF32 off) placed against unplaced on one card: "
            f"the ZOO lane's ĥ − h a step {signal} (the loss's f32 spacing "
            f"{space1:.3e}, {space2:.3e}); losses {placed[2]['losses']} "
            f"against {u2['losses']} (first step whose loss differs: "
            f"{apart[0] if apart else None}); largest |param diff| after "
            f"step 1 {diffs[1]:.3e}, after step 2 {diffs[2]:.3e}")
        for n, ck in (("one step", first),
                      ("the second step alone from the placed first step",
                       second)):
            key = "first" if ck is first else "second"
            log(f"{what}: {n}: (leaf, |diff|, |update|, the update's "
                f"fitted scalar, the update's largest change from starts "
                f"one ulp away (seeds {MESH_FLOOR_SEEDS}), its distance "
                f"from the CPU's) "
                f"{[(k, *(f'{x:.4g}' for x in xs)) for k, *xs in leaves[key]]}"
                f"; the client's update the unplaced one x {ck['scalars']}, "
                f"the server's x {ck['server_scalars']}; worst share of its "
                f"tolerance {ck['worst']} at {ck['where']} (logged only: "
                f"{F32_LOGGED}); controls (each leaf's update zeroed, "
                f"doubled) that passed: {ck['blind'] or 'none'}; held "
                f"{ck['held']}")
        res["f32"] = dict(first=first, second=second, leaves=leaves,
                          diffs=diffs, first_apart=apart[0] if apart else None,
                          unplaced_losses=u2["losses"], signal=signal)
        if not (first["held"] and second["held"]):
            _fail(res, what, "f32 placed against unplaced")
        del u1, u2, alone, start0, p0, g1, g2, w1, w2, a2
    del placed
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()


def rank_full_depth(res, what, mesh, counters, card) -> None:
    """Gate 8: :func:`mesh_full_depth` on this mesh (Phi-3-mini at full
    depth, bf16, the CLI's defaults: 20 captured steps timed, the last a
    profiled replay, the peak), then the same 20 steps eager: losses and
    every local shard bitwise; the eager ms a step and peak logged."""
    from repro_torch.configs import get_config
    out = None
    try:
        out = mesh_full_depth(mesh, card, counters, what=what, keep=True)
    except AssertionError as e:
        _fail(res, what, f"full depth: {e}")
    eager = mesh_run(get_config(MESH_TRAIN["arch"]), mesh, counters,
                     graph=False, steps=TRAIN_STEPS, use_reduced=False,
                     log_every=1000, keep_params=True, **TRAIN)
    timed = eager["ends"][TRAIN_WARMUP - 1:TRAIN_STEPS - 1]
    eager_ms = (timed[-1] - timed[0]) * 1e3 / (len(timed) - 1)
    local = _local_by_path(eager.pop("res"))
    same = out is not None and eager["losses"] == out["losses"] and all(
        torch.equal(v, out["local"][k]) for k, v in local.items())
    log(f"{what}: full depth eager {eager_ms:.3f} ms a step, peak "
        f"{eager['peak'] / 2**30:.2f} GiB; the captured run bitwise its "
        f"eager steps (losses and every local shard): {same}")
    if not same:
        _fail(res, what, "full depth: captured differs from eager")
    res["full"] = dict(eager_ms=eager_ms, eager_peak=eager["peak"],
                       same=same, eager_losses=eager["losses"])
    if out is not None:
        res["full"].update({k: out[k] for k in ("ms", "peak", "busy",
                                                 "capture_s", "losses")})
    del out, eager, local
    gc.collect()
    torch.cuda.empty_cache()


def mesh_rank(argv) -> int:
    """One rank of :func:`mesh_ranks`: ``RANK WORLD STORE OUT DATA``. On
    ``cuda:RANK`` in a WORLD-rank NCCL group (joined through the
    ``FileStore`` STORE) at the (DATA, WORLD / DATA) ``("data", "model")``
    mesh, TF32 off: :func:`rank_turns`, :func:`rank_resume` (its
    checkpoints beside STORE), :func:`rank_f32` and
    :func:`rank_full_depth`. Writes its readings and its failed gates to
    OUT (JSON)."""
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs import cut_depth, get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops
    rank, world, store, out, data = (int(argv[0]), int(argv[1]), argv[2],
                                     argv[3], int(argv[4]))
    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("nccl", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    shape = (data, world // data)
    what = f"mesh {shape} rank {rank}"
    card = nvidia_smi()
    res = dict(rank=rank, device=torch.cuda.get_device_name(rank),
               failures=[])
    root = Path(store).parent
    t0 = time.perf_counter()
    try:
        mesh = DeviceMesh("cuda", torch.arange(world).reshape(shape),
                          mesh_dim_names=("data", "model"))
        counters = (flash_ops, rms_ops, ssd_ops)
        cfg = cut_depth(get_config(MESH_TRAIN["arch"]), MESH_TRAIN["layers"])
        kw = dict(steps=MESH_TRAIN["steps"], batch=MESH_TRAIN["batch"],
                  seq=MESH_TRAIN["seq"], use_reduced=False, log_every=1000,
                  keep_params=True)
        straight = rank_turns(res, what, cfg, mesh, counters, kw)
        rank_resume(res, what, cfg, mesh, counters, kw, straight, root,
                    card)
        del straight
        gc.collect()
        torch.cuda.empty_cache()
        rank_f32(res, what, cfg, mesh, counters, kw, root)
        rank_full_depth(res, what, mesh, counters, card)
    finally:
        dist.destroy_process_group()
    res["seconds"] = time.perf_counter() - t0
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def norm_sites(summary) -> dict:
    """A ``comms.summary``'s collectives at the lines of
    ``core/cascade.py``, where the step factories log their gradient
    norms (a backward collective's site reads "backward ...", the frame
    autograd runs the model's backward from): {"axis kind site": [bytes,
    operand shapes]}."""
    shapes = summary.get("shapes_by_site", {})
    return {k: [n, shapes.get(k)] for k, n in summary["by_site"].items()
            if k.split(" ", 2)[2].startswith("core/cascade.py")}


def beyond_scalars(sites) -> list:
    """The sites of :func:`norm_sites` that carry more than all-reduces
    of 0-dim tensors."""
    return [k for k, (_, shapes) in sites.items()
            if k.split(" ")[1] != "all-reduce" or shapes != [[]]]


def mesh_turn(argv) -> int:
    """One rank of a turn of ``--mesh-ranks D --against DIR``: ``RANK
    WORLD STORE OUT DATA SRC``. On ``cuda:RANK`` in a WORLD-rank NCCL
    group at the (DATA, WORLD / DATA) mesh, TF32 off, the package under
    SRC (this checkout's or DIR's): one eager placed step at MESH_TRAIN's
    depth under :func:`step_probe` (one rank's collective bytes a step;
    the norms' sites with their NCCL kernels), then :func:`mesh_full_depth`
    (ms a step, the busy share of a profiled replay, peak, losses).
    Writes its readings to OUT (JSON)."""
    import torch.distributed as dist
    rank, world, store, out, data, src = (int(argv[0]), int(argv[1]),
                                          argv[2], argv[3], int(argv[4]),
                                          argv[5])
    sys.path.insert(0, src)
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs import cut_depth, get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops
    from repro_torch.utils import comms
    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("nccl", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    shape = (data, world // data)
    card = nvidia_smi()
    res = dict(rank=rank, src=src)
    t0 = time.perf_counter()
    try:
        mesh = DeviceMesh("cuda", torch.arange(world).reshape(shape),
                          mesh_dim_names=("data", "model"))
        counters = (flash_ops, rms_ops, ssd_ops)
        cfg = cut_depth(get_config(MESH_TRAIN["arch"]), MESH_TRAIN["layers"])
        probe = step_probe(mesh, cfg.padded_vocab)
        mesh_run(cfg, mesh, counters, graph=False, within={0: probe},
                 steps=1, batch=MESH_TRAIN["batch"], seq=MESH_TRAIN["seq"],
                 use_reduced=False, log_every=1000)
        summary = comms.summary(probe.records)
        res.update(bytes=summary["by_kind"]["total"],
                   norm_sites=norm_sites(summary),
                   site_kernels=probe.site_kernels)
        del probe
        full = mesh_full_depth(mesh, card, counters,
                               what=f"{src} at {shape}, rank {rank}",
                               keep=True)
        res.update({k: full[k] for k in ("ms", "busy", "peak", "losses",
                                         "capture_s")})
        del full
    finally:
        dist.destroy_process_group()
    res["seconds"] = time.perf_counter() - t0
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def mesh_against(children, shape, against, tmp, card) -> list:
    """``--against DIR``'s turns (MESH_TURNS): one process of
    :func:`mesh_turn` a card on DIR's package and on this one in turns at
    ``shape``, then this one at (1, 1) on one card. Logs each turn's ms a
    step, busy share, peak, bytes a rank and the norms' sites with their
    NCCL kernels; returns its failed gates: a rank's full-depth losses
    not those of every rank of every turn at ``shape`` (bitwise), or a
    norm site of this tree carrying more than 0-dim all-reduces."""
    srcs = {"against": str(Path(against).resolve() / "src"),
            "this": str(SRC)}
    t0 = time.perf_counter()
    # the other tree's kernels, built before its ranks import them
    subprocess.run([sys.executable, "-c", "import sys; sys.path.insert(0, "
                    f"{srcs['against']!r}); from repro_torch.kernels import "
                    "_build; _build.build_all(['flash_attention', "
                    "'rmsnorm'])"], check=True)
    log(f"{AGAINST} {against}: its kernels built in "
        f"{time.perf_counter() - t0:.1f} s")
    turns = [(name, shape) for name in MESH_TURNS] + [("this", (1, 1))]
    failures, firsts = [], {}
    for i, (name, (data, model)) in enumerate(turns):
        t1 = time.perf_counter()
        d = Path(tmp) / f"turn{i}"
        d.mkdir()
        what = f"turn {i} ({name}, ({data}, {model}))"
        res = children.ranks(MESH_TURN, data * model, d, data, srcs[name],
                             timeout=900, what=what)
        r0 = res[0]
        kernels = {k: v for k, v in r0["site_kernels"].items() if v}
        log(f"{what} on {card}, {srcs[name]}: "
            f"{time.perf_counter() - t1:.1f} s; full depth ms a step "
            f"{[round(r['ms'], 3) for r in res]}, busy "
            f"{[round(100 * r['busy'], 2) for r in res]}%, peak "
            f"{[round(r['peak'] / 2**30, 2) for r in res]} GiB, capture "
            f"{[r['capture_s'] for r in res]} s; losses {r0['losses']}")
        log(f"{what}: one eager step at {MESH_TRAIN['layers']} layers, "
            f"collective bytes a rank {[r['bytes'] for r in res]}; rank "
            f"0's norm sites [bytes, operand shapes] {r0['norm_sites']}, "
            f"their NCCL kernels "
            f"{ {k: kernels.get(k) for k in r0['norm_sites']} }")
        log(f"{what}: rank 0's NCCL kernels by site {kernels}")
        first = firsts.setdefault((data, model), r0["losses"])
        for r in res:
            if r["losses"] != first:
                failures.append(f"{what} rank {r['rank']}: full-depth "
                                f"losses {r['losses']} against {first}")
            bad = beyond_scalars(r["norm_sites"])
            if name == "this" and bad:
                failures.append(f"{what} rank {r['rank']}: norm sites "
                                f"beyond 0-dim all-reduces {bad}")
    return failures


def _rank_line(shape, r) -> str:
    full = r.get("full", {})
    return (f"mesh {shape} rank {r['rank']} on {r['device']}: losses "
            f"{r['losses']}; ms a step at 4 layers captured "
            f"{[round(t, 3) for t in r['ms']['captured']]}, eager "
            f"{[round(t, 3) for t in r['ms']['eager']]}; captures "
            f"{r['capture_s']} s; resume {r['resume']}; full depth "
            f"{full.get('ms', float('nan')):.3f} ms a step captured "
            f"(eager {full.get('eager_ms', float('nan')):.3f}), peak "
            f"{full.get('peak', float('nan')) / 2**30:.2f} GiB (eager "
            f"{full.get('eager_peak', float('nan')) / 2**30:.2f}), busy "
            f"{100 * full.get('busy', float('nan')):.2f}%, capture "
            f"{full.get('capture_s')} s; the graph's NCCL kernels "
            f"{r['graph']['nccl'] or 'none'}; {r['seconds']:.1f} s")


def mesh_ranks(world: int, against=None) -> int:
    """``python3 chip_smoke.py --mesh-ranks D``: ``train(mesh=)`` of
    Phi-3-mini across D cards, one NCCL rank a card (NCCL refuses two
    ranks on one GPU; this run needs D cards, the default run one), at
    each mesh of MESH_SHAPES[D]: (2, 2) at D = 4; (1, 2), then (2, 1) at
    D = 2. Builds the flash and RMSNorm kernels, starts the dry run's
    trace of the placed step at each mesh (``costmodel.measure`` on a fake
    group of D, in a child kept off the cards), then for each mesh D
    processes of :func:`mesh_rank`, and holds what they report:
    (1) on every rank the placed captured run bitwise the placed eager
    run; (2) every rank's losses the same; (3) in f32 the placed run
    against the unplaced run, each leaf's value and update
    (:func:`f32_check`); (4) the kernels' launches (the replayed share) equal to
    their derivation, flash on this mesh's heads; (5) one eager placed
    step's collectives equal to the dry run's trace by axis and kind
    (count and bytes), by kind and by axis (by site logged); (6) NCCL's
    kernels in the step's graph wherever the eager step issues a
    collective on an axis of more than one rank; (7) the placed run saved
    and resumed bitwise, its checkpoint loaded unplaced bitwise; (8) at
    full depth the captured run bitwise its eager steps, its ms a step,
    each rank's peak and rank 0's busy share logged; (9) every collective
    at a line of ``core/cascade.py`` (the logged gradient norms, read
    from the placed gradients) an all-reduce of 0-dim tensors, on every
    rank and in the trace (the norms' sites, their bytes and rank 0's
    NCCL kernels for them logged). ``against`` (``--against DIR``, a
    checkout of another commit) then runs :func:`mesh_against`: DIR's
    package and this one in turns at full depth on the last mesh, whose
    losses must be bitwise equal."""
    import tempfile
    shapes = MESH_SHAPES.get(world)
    if shapes is None:
        print(f"chip_smoke {MESH_RANKS} D: D is one of "
              f"{sorted(MESH_SHAPES)}", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < world:
        print(f"chip_smoke {MESH_RANKS} {world}: needs {world} cards, "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build
    card = nvidia_smi()
    t_start = time.perf_counter()
    _build.build_all(["flash_attention", "rmsnorm"])
    log(f"{MESH_RANKS} {world}: build {time.perf_counter() - t_start:.1f} "
        f"s; cards: {card}; torch {torch.__version__}, NCCL "
        f"{'.'.join(map(str, torch.cuda.nccl.version()))}; meshes {shapes}")
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    env = dict(__import__("os").environ, PYTHONPATH=str(SRC),
               CUDA_VISIBLE_DEVICES="")
    results = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_",
                                     dir=build) as tmp, \
            Children() as children:
        trace_out, trace_log = f"{tmp}/trace.json", f"{tmp}/trace.log"
        trace = children.start(
            [sys.executable, "-c", MESH_TRACE, trace_out, str(world),
             json.dumps(shapes), MESH_TRAIN["arch"],
             str(MESH_TRAIN["layers"]), str(MESH_TRAIN["batch"]),
             str(MESH_TRAIN["seq"])], trace_log, env=env)
        for data, model in shapes:
            t0 = time.perf_counter()
            d = Path(tmp) / f"{data}x{model}"
            d.mkdir()
            results[(data, model)] = children.ranks(
                MESH_RANK, world, d, data, timeout=900, show=0,
                what=f"mesh ({data}, {model}): ranks")
            log(f"mesh ({data}, {model}): {time.perf_counter() - t0:.1f} s")
        children.wait([trace], [trace_log], "the dry run's trace", 900)
        traced = json.loads(Path(trace_out).read_text())
        failures = [] if against is None else mesh_against(
            children, shapes[-1], against, tmp, card)
    for (data, model), res in results.items():
        shape = (data, model)
        want = traced[f"{data}x{model}"]
        sizes = {"data": data, "model": model}
        for r in res:
            log(_rank_line(shape, r))
            failures += r["failures"]
            got = r["comms"]
            for key in ("by_axis_kind", "by_kind", "by_axis"):
                if got[key] != want[key]:
                    failures.append(f"mesh {shape} rank {r['rank']}: "
                                    f"collectives {key} {got[key]} against "
                                    f"the dry run's {want[key]}")
            bad = beyond_scalars(norm_sites(got))
            if bad:
                failures.append(f"mesh {shape} rank {r['rank']}: norm "
                                f"sites beyond 0-dim all-reduces {bad}")
            moved = [a for a, n in got["by_axis"].items()
                     if n and sizes.get(a, 1) > 1]
            if moved and not r["graph"]["nccl"]:
                failures.append(f"mesh {shape} rank {r['rank']}: no NCCL "
                                f"kernel in the graph, though the step "
                                f"moves bytes over {moved}")
        r0 = res[0]
        norms, bad = norm_sites(r0["comms"]), beyond_scalars(norm_sites(want))
        if bad:
            failures.append(f"mesh {shape}: the dry run's trace has norm "
                            f"sites beyond 0-dim all-reduces {bad}")
        log(f"mesh {shape}: one eager placed step's collectives at the "
            f"norms' sites (core/cascade.py) on rank 0 [bytes, operand "
            f"shapes] {norms}, their NCCL kernels "
            f"{ {k: r0['site_kernels'].get(k) for k in norms} }; in the "
            f"trace {norm_sites(want)}; collective bytes a rank a step "
            f"{[r['comms']['by_kind']['total'] for r in res]} (the trace's "
            f"{want['by_kind']['total']})")
        log(f"mesh {shape}: rank 0's NCCL kernels by site "
            f"{ {k: v for k, v in r0['site_kernels'].items() if v} }")
        sites = sorted(set(r0["comms"]["by_site"]) ^ set(want["by_site"]))
        site_diff = {k: (r0["comms"]["by_site"].get(k),
                         want["by_site"].get(k)) for k in sites} or "none"
        log(f"mesh {shape}: one eager placed step's collectives on rank 0 "
            f"(utils.comms.CommRecorder over NCCL) by axis and kind [count, "
            f"bytes] {r0['comms']['by_axis_kind']}; the dry run's trace "
            f"(costmodel.measure, a fake group of {world}, "
            f"{want['trace_s']:.1f} s) {want['by_axis_kind']}; sites that "
            f"differ {site_diff}")
        top = sorted(r0["comms"]["by_site"].items(), key=lambda kv: -kv[1])
        log(f"mesh {shape}: rank 0's collective bytes by site, the largest "
            f"first: " + "; ".join(f"{k} {n}" for k, n in top[:10]))
        log(f"mesh {shape}: rank 0's eager step 0, its largest tensors "
            f"{r0['largest']}; backward tensors over the vocabulary "
            f"{r0['vocab_grads']}; the graph's nodes "
            f"{r0['graph']['node_kinds']}")
        for key in ("losses", "turn_losses", "f32_losses"):
            if len({json.dumps(r[key]) for r in res}) != 1:
                failures.append(f"mesh {shape}: the ranks' {key} differ: "
                                f"{[r[key] for r in res]}")
        full = [json.dumps(r.get("full", {}).get("losses")) for r in res]
        if len(set(full)) != 1:
            failures.append(f"mesh {shape}: the ranks' full-depth losses "
                            f"differ")
        if "f32" not in r0:
            failures.append(f"mesh {shape}: rank 0 made no f32 comparison")
    log(f"{MESH_RANKS} {world} on {card}: {time.perf_counter() - t_start:.1f}"
        f" s; gates held: {not failures}")
    if failures:
        raise AssertionError("; ".join(failures))
    return 0


def parse_phases(argv) -> set:
    """``--phases 4,6`` runs the build (phase 1) and the phases named, for
    work on one path; with no arguments every phase runs, and only then
    is the result printed."""
    if not argv:
        return set(range(1, 16))
    if len(argv) != 2 or argv[0] != "--phases":
        raise SystemExit("usage: python3 chip_smoke.py [--phases N,N,...] "
                         f"| {SHARDED_RANKS} D | {MESH_RANKS} D "
                         f"[{AGAINST} DIR]")
    return {1} | {int(n) for n in argv[1].split(",")}


def main() -> int:
    t_start = time.perf_counter()
    if sys.argv[1:2] == [POP_WORKER]:
        return pop_worker(sys.argv[2:])
    if sys.argv[1:2] == [SHARDED_RANK]:
        return sharded_rank(sys.argv[2:])
    if sys.argv[1:2] == [MESH_RANK]:
        return mesh_rank(sys.argv[2:])
    if sys.argv[1:2] == [MESH_TURN]:
        return mesh_turn(sys.argv[2:])
    ranks = {SHARDED_RANKS: sharded_ranks, MESH_RANKS: mesh_ranks}
    if len(sys.argv) == 3 and sys.argv[1] in ranks or (
            len(sys.argv) == 5 and sys.argv[1] == MESH_RANKS
            and sys.argv[3] == AGAINST):
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            return 1
        return ranks[sys.argv[1]](int(sys.argv[2]), *sys.argv[4:])
    phases = parse_phases(sys.argv[1:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one "
              "card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm import ref as rms_ref
    from repro_torch.kernels.ssd_chunk import kernel as ssd_kernel
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops
    from repro_torch.kernels.ssd_chunk import ref as ssd_ref
    from repro_torch.kernels.zoo_dual_matmul import ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = nvidia_smi()
    log(f"device: {kind} (count {torch.cuda.device_count()}); nvidia-smi: "
        f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"allow_tf32 = False (matmul and cuDNN)")

    # ---- phase 1: build -------------------------------------------------
    t0 = time.perf_counter()
    reports = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, text in reports.items():
        for line in text.splitlines():
            if re.search(r"Compiling entry|registers|spill", line):
                log(f"  {name}: {line.strip()}")
    hgmma = count_mma(_build, "flash_attention", r"\bHGMMA\b")
    log(f"flash library SASS: {hgmma} HGMMA (wgmma) instructions")
    if not hgmma:
        raise AssertionError("the flash library's SASS has no HGMMA: the "
                             "bf16 kernel does not run on the tensor cores")
    ssd_mma = count_mma(_build, "ssd_chunk", r"\bH(?:G)?MMA\b")
    log(f"ssd_chunk library SASS: {ssd_mma} HMMA/HGMMA (mma.sync / wgmma) "
        f"instructions")
    if not ssd_mma:
        raise AssertionError("the SSD library's SASS has no HMMA or HGMMA: "
                             "the bf16 scan does not run on the tensor cores")

    spent = {"build": time.perf_counter() - t_start}

    def lap(phase, t0):
        spent[phase] = time.perf_counter() - t0
        log(f"phase {phase}: {spent[phase]:.1f} s")
        return time.perf_counter()

    # ---- phase 2: kernels against their plain versions -----------------
    t0 = time.perf_counter()
    if 2 in phases:
        rows = check_kernels(ops, ref)
        rows.update(check_flash_kernel(flash_ops, flash_ref))
        check_flash_capture(flash_ops)
        rows.update(check_rmsnorm(rms_ops, rms_ref, rms_kernel))
        rows.update(check_ssd_kernel(ssd_ops, ssd_ref, ssd_kernel,
                                     reports["ssd_chunk"]))
        t0 = lap(2, t0)
    else:
        rows = {name: {"name": name, "launches": 0}
                for name in list(KERNELS) + list(KERNEL_ENTRIES)}
    base = sentinel = None
    if 3 in phases:
        base = tabular_phase(rows, ops, flash_ops, rms_ops, ssd_ops, kind,
                             card)
        t0 = lap(3, t0)

    # ---- phase 4: the split serve path at full width -------------------
    serve_kernels = {"flash_attention": (flash_ops, flash_ref),
                     "rmsnorm": (rms_ops, rms_ref),
                     "ssd_chunk": (ssd_ops, ssd_ref)}
    if 4 in phases:
        for arch in SERVE_ARCHS:
            serve_phase(rows, arch, ops, serve_kernels, again=True)
        t0 = lap(4, t0)

    # ---- phase 5: LM training on the card --------------------------------
    if 5 in phases:
        train_phase(rows, card, (ops, flash_ops, rms_ops, ssd_ops))
        t0 = lap(5, t0)

    # ---- phase 6: continuous split serving at full width ---------------
    if 6 in phases:
        sentinel = continuous_phase(rows, card,
                                    (ops, flash_ops, rms_ops, ssd_ops),
                                    serve_kernels, sentinel=True)
        t0 = lap(6, t0)

    # ---- phase 7: asynchronous LM training over the wire plane ---------
    if 7 in phases:
        population_phase(rows, card, (ops, flash_ops, rms_ops, ssd_ops),
                         serve_kernels)
        t0 = lap(7, t0)

    # ---- phase 8: the RWKV6 and MoE families, and the attacks ----------
    if 8 in phases:
        families_phase(rows, card, (ops, flash_ops, rms_ops, ssd_ops),
                       serve_kernels)
        t0 = lap(8, t0)

    # ---- phase 9: DeepSeek-V3 (MLA, first_k_dense, MTP) ----------------
    if 9 in phases:
        deepseek_phase(rows, card, (ops, flash_ops, rms_ops, ssd_ops),
                       serve_kernels)
        t0 = lap(9, t0)

    # ---- phase 10: the multimodal and encoder-decoder families ---------
    if 10 in phases:
        modal_phase(rows, card, (ops, flash_ops, rms_ops, ssd_ops),
                    serve_kernels)
        t0 = lap(10, t0)

    # ---- phase 11: the sharded engine and the analysis plane -----------
    if 11 in phases:
        sharded_tabular(rows, ops, card, base=base)
        if sentinel is None:
            log("phase 11 (b): not run (it runs inside phase 6's run A)")
        else:
            check_sentinel("phase 6 run A (phi3-mini-3.8b)", sentinel)
        analysis_cli()
        t0 = lap(11, t0)

    # ---- phase 12: the boundary certifier ------------------------------
    if 12 in phases:
        certifier_phase(card, ops, rms_ops, flash_ops)
        t0 = lap(12, t0)

    # ---- phase 13: the examples on the card ----------------------------
    # phase 14's dry runs need no card: they run beside phase 13
    dry = start_dryruns() if 14 in phases else None
    try:
        if 13 in phases:
            examples_phase(rows, card, (ops, flash_ops, rms_ops, ssd_ops))
            t0 = lap(13, t0)

        # ---- phase 14: the production mesh -----------------------------
        if 14 in phases:
            mesh_phase(rows, card, (ops, flash_ops, rms_ops, ssd_ops), dry)
            t0 = lap(14, t0)
    finally:
        for p in (dry[1] if dry else ()):
            if p.poll() is None:
                p.kill()
                p.communicate()

    wall = time.perf_counter() - t_start
    log(f"chip_smoke wall time: {wall:.1f} s (" + "; ".join(
        f"phase {k} {v:.1f} s" for k, v in spent.items()) + f") on {card}")
    if phases != set(range(1, 16)):
        log(f"partial run (phases {sorted(phases)}): no result line")
        return 0

    # ---- phase 15: the record ------------------------------------------
    report_rates(rows)
    log(card)
    log(json.dumps({"kernels": list(rows.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def tabular_phase(rows, ops, flash_ops, rms_ops, ssd_ops, kind, card):
    """Phase 3: the tabular main path at the paper's width, through the
    captured round; returns the 500-round run's result (phase 11 holds
    the sharded run to it)."""
    from repro_torch import graphs
    from repro_torch.configs.base import VFLConfig
    from repro_torch.configs.paper_mlp import PaperMLPConfig
    from repro_torch.core.adapters import tabular_adapter
    from repro_torch.core.async_engine import EngineConfig
    from repro_torch.core.draws import TorchDraws
    from repro_torch.core.privacy import GaussianLossChannel
    from repro_torch.data import make_classification, vertical_partition
    from repro_torch.federation import Federation
    from repro_torch.models import tabular
    t_phase = time.perf_counter()
    cfg = PaperMLPConfig()
    X, y = make_classification(seed=0, n=60000, n_features=cfg.n_features,
                               n_classes=cfg.n_classes)
    x_parts = torch.from_numpy(vertical_partition(X, cfg.n_clients)).cuda()
    y_dev = torch.from_numpy(y).long().cuda()
    vfl = VFLConfig(mu=MU, lr_server=0.05, lr_client=0.05)
    kernel_ad = tabular_adapter(cfg, use_kernel_lanes=True)

    def build(method, steps, vfl=vfl, noise=None, **kw):
        return Federation.build(
            kernel_ad if kw.get("use_lanes") else cfg, vfl,
            EngineConfig(method=method, steps=steps, batch_size=64, **kw),
            noise=noise)

    fed = build("cascaded", 500, use_lanes=True)
    params = fed.init_params(torch.Generator().manual_seed(0))
    fed_warm = build("cascaded", 20, use_lanes=True)
    fed_warm.run(params, x_parts, y_dev)               # cuBLAS/allocator warm-up
    fed_warm.run(params, x_parts, y_dev, use_graph=False)

    name = "zoo_dual_matmul_stacked_bias_relu"
    for counter in (ops, flash_ops, rms_ops, ssd_ops):
        counter.reset_launches()
    graphs.reset_replayed()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fed.run(params, x_parts, y_dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    replayed = graphs.replayed["zoo_dual_matmul"][name]
    rg = res.round_graph
    if rg is None:
        raise AssertionError("the main path's rounds were not captured")
    replay_ms = rg["replay_s"] * 1e3 / rg["replays"]
    log(f"main path: cascaded, {cfg}, n = 60000, 500 rounds of batch 64 "
        f"through the captured round on {kind} ({card}): "
        f"{wall * 1e3 / 500:.4f} ms a round end to end (the whole "
        f"Federation.run, round 0 and the capture included); the replays "
        f"{replay_ms:.4f} ms a round over {rg['replays']}; capture "
        f"{rg['capture_s']:.4f} s ({rg['nodes']} graph nodes, "
        f"{rg['kernel_nodes']} kernel nodes; round 0 eager as the warm-up);"
        f" kernel launches {launches} ({replayed} of them replayed)")
    rows[name]["round_ms"] = wall * 1e3 / 500
    rows[name]["round_replay_ms"] = replay_ms
    rows[name]["round_capture_s"] = rg["capture_s"]
    losses = res.losses
    if losses.shape != (500,) or not np.isfinite(losses).all():
        raise AssertionError(f"main path losses not finite: {losses}")
    first, last = float(losses[:50].mean()), float(losses[-50:].mean())
    log(f"main path loss: first 50 mean {first:.4f}, last 50 mean "
        f"{last:.4f}; max delay {res.max_delay_seen}, mean delay "
        f"{res.mean_delay:.3f}, wire {res.wire_bytes} B")
    if not last < first:
        raise AssertionError("main path loss did not fall")
    if launches != {name: 500, "zoo_dual_matmul_stacked": 0,
                    "zoo_dual_matmul": 0} or replayed != 499:
        raise AssertionError(f"kernel launches {launches} ({replayed} "
                             f"replayed) != one per round")
    if (flash_ops.launches["flash_attention"] or rms_ops.launches["rmsnorm"]
            or ssd_ops.launches["ssd_chunk"]):
        raise AssertionError("the tabular path launched an LM kernel")
    for kname in KERNELS:
        rows[kname]["launches"] = launches[kname]
    tabular_again(fed, params, x_parts, y_dev, res, wall, ops, name)
    main = graph_vs_eager("main path (cascaded lanes)", fed, params, x_parts,
                          y_dev)
    if not np.array_equal(main["losses"].cpu().numpy(), res.losses):
        raise AssertionError("the engine's captured rounds differ from "
                             "Federation.run's")
    rows[name]["round_profile"] = profile_rounds(
        build("cascaded", 50, use_lanes=True), params, x_parts, y_dev)

    # the same rounds on the card (kernel lanes) and on the CPU (plain
    # lanes), from the same params on one CPU draw stream. φ/μ (d/μ =
    # 2.5e7 for a sphere client here) carries f32 rounding into every
    # client step: f32 against f64 on the CPU drifts 9e-3 over 25 sphere
    # rounds but 1.2e-5 over 25 normal (φ = 1) rounds and 2e-6 over 3
    # sphere rounds. So: 25 normal rounds at repro's trajectory atol 1e-3,
    # and 3 sphere rounds at 1e-4.
    cpu_params = {k: {n: t.cpu() for n, t in v.items()}
                  for k, v in params.items()}
    sub = slice(0, 4096)
    for dist, steps, atol in (("normal", 25, 1e-3), ("sphere", 3, 1e-4)):
        v = VFLConfig(mu=MU, lr_server=0.05, lr_client=0.05, zoo_dist=dist)
        ec = EngineConfig(method="cascaded", steps=steps, batch_size=64,
                          use_lanes=True)
        gpu = Federation.build(kernel_ad, v, ec).run(
            params, x_parts[:, sub], y_dev[sub],
            draws=CpuDrawsOn(TorchDraws(0, "cpu"), "cuda"))
        cpu = Federation.build(tabular_adapter(cfg), v, ec,
                               device="cpu").run(
            cpu_params, x_parts[:, sub].cpu(), y_dev[sub].cpu(),
            draws=CpuDrawsOn(TorchDraws(0, "cpu"), "cpu"))
        gap = float(np.abs(gpu.losses - cpu.losses).max())
        log(f"card (kernel lanes, captured rounds) vs CPU (plain lanes), "
            f"{dist}, {steps} rounds at paper width: max loss gap {gap:.3e} "
            f"(atol {atol})")
        if gpu.round_graph is None or not gap <= atol:
            raise AssertionError(f"card and CPU trajectories differ by {gap}")

    for method in ("vafl", "zoo-vfl", "split", "syn-zoo"):
        lr = LRS[method]
        mfed = build(method, 50, VFLConfig(mu=MU, lr_server=lr, lr_client=lr))
        r = mfed.run(params, x_parts, y_dev)
        log(f"{method}: 50 rounds, loss {r.losses[0]:.4f} -> "
            f"{r.losses[-1]:.4f}, gradients on the wire: "
            f"{r.transmits_gradients}")
        if not np.isfinite(r.losses).all():
            raise AssertionError(f"{method} losses not finite")
        graph_vs_eager(method, mfed, params, x_parts, y_dev)
    before = ops.launches[name]
    bfed = build("cascaded", 50, VFLConfig(mu=MU, lr_server=0.05,
                                           lr_client=0.05, zoo_queries=4),
                 block_size=3, use_lanes=True)
    r = bfed.run(params, x_parts, y_dev)
    blk = ops.launches[name] - before
    log(f"cascaded q=4 block=3: 50 rounds, loss {r.losses[0]:.4f} -> "
        f"{r.losses[-1]:.4f}, kernel launches {blk}")
    if not np.isfinite(r.losses).all() or blk != 50:
        raise AssertionError("q=4 block=3 run failed")
    graph_vs_eager("cascaded q=4 block=3", bfed, params, x_parts, y_dev)
    # the DP loss channel: normal directions at μ = 0.1 and client lr 1e-4
    # keep the noised client steps (σ/μ ≈ 480) finite over 25 rounds
    dfed = build("cascaded", 25, VFLConfig(
        mu=0.1, lr_server=0.05, lr_client=1e-4, zoo_queries=2,
        zoo_dist="normal"), noise=GaussianLossChannel(
        clip=10.0, epsilon=1.0, delta=1e-5), block_size=3, use_lanes=True)
    dp = graph_vs_eager("cascaded under the DP loss channel (q=2 block=3)",
                        dfed, params, x_parts, y_dev)
    if not torch.isfinite(dp["losses"]).all():
        raise AssertionError("the DP run's losses are not finite")
    lm_round_graph(rows, (ops, flash_ops, rms_ops, ssd_ops))

    # the quickstart's width and outcome (examples/quickstart.py)
    qcfg = PaperMLPConfig(n_features=64, n_classes=10, n_clients=4,
                          client_embed=32, server_embed=128)
    Xq, yq = make_classification(seed=0, n=2048, n_features=64,
                                 n_classes=10)
    xq = torch.from_numpy(vertical_partition(Xq, 4)).cuda()
    yq = torch.from_numpy(yq).long().cuda()
    qfed = Federation.build(tabular_adapter(qcfg, use_kernel_lanes=True),
                            vfl, EngineConfig(method="cascaded", steps=800,
                                              batch_size=64, use_lanes=True))
    qres = qfed.run(qfed.init_params(torch.Generator().manual_seed(0)), xq,
                    yq)
    acc = float(tabular.accuracy(qres.params, xq, yq))
    log(f"quickstart through the kernel lanes (captured rounds): acc "
        f"{acc:.4f}, final loss {qres.losses[-25:].mean():.4f}")
    if not acc > 0.9:
        raise AssertionError(f"quickstart accuracy {acc} <= 0.9")
    log(f"phase 3: {time.perf_counter() - t_phase:.1f} s")
    return res


def tabular_again(fed, params, x_parts, y, first, first_s, ops, name):
    """Phase 3: a second ``Federation.run`` of the same shapes on the same
    session replays the kept round graph (``graphs.Kept`` on the session,
    the counterpart of the JAX engine's cached runner): it captures
    nothing (``kept``, ``capture_s`` 0.0, all 500 rounds replayed) and
    its losses, params, table and delays are bitwise the first call's
    (the table and delays read from the key's buffers after each call)."""
    from repro_torch import graphs
    (key,) = fed._kept_rounds.keys()
    st = fed._kept_rounds.get(key)["st"]
    table, delays = st["table"].clone(), st["delays"].clone()
    ops.reset_launches()
    graphs.reset_replayed()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fed.run(params, x_parts, y)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rg = res.round_graph
    launches = (ops.launches[name], graphs.replayed["zoo_dual_matmul"][name])
    same = (np.array_equal(first.losses, res.losses)
            and _same_trees(first.params, res.params)
            and torch.equal(table, st["table"])
            and torch.equal(delays, st["delays"])
            and (first.max_delay_seen, first.mean_delay)
            == (res.max_delay_seen, res.mean_delay))
    log(f"main path, a second Federation.run of the same shapes: "
        f"{wall:.4f} s ({wall * 1e3 / 500:.4f} ms a round) against the "
        f"first call's {first_s:.4f} s ({first_s * 1e3 / 500:.4f}; its "
        f"capture {first.round_graph['capture_s']:.4f} s); kept "
        f"{rg['kept']}, capture {rg['capture_s']} s, {rg['replays']} "
        f"replays ({rg['replay_s'] * 1e3 / rg['replays']:.4f} ms each), "
        f"kernel launches {launches[0]} ({launches[1]} replayed); "
        f"{len(fed._kept_rounds)} key kept; losses, params, table and "
        f"delays bitwise the first call's: {same}")
    if not (rg["kept"] and rg["capture_s"] == 0.0 and rg["replays"] == 500
            and launches == (500, 500) and len(fed._kept_rounds) == 1
            and same):
        raise AssertionError(f"the second run captured or differs: {rg}, "
                             f"launches {launches}, bitwise {same}")


# the reduced LM round held graph against eager: benchmarks/lm_async.py's
# shape (phi3 reduced to d_model 64, 2 heads of 32 and 1 KV head, d_ff
# 128, vocab 256, its 2 layers; 4 client parties over 32 tokens, batch 8,
# cascaded with the fused lanes over the active rows), at its larger q
LM_ROUND = dict(queries=4, rounds=20, batch=8, seq=32, n_clients=4, rows=128)


def lm_round_graph(rows, counters) -> None:
    """Phase 3: ``from_model_config``'s reduced Phi-3 through the captured
    round (flash attention and RMSNorm under the capture, with autograd
    in the server update) bitwise to its eager loop, its flash and
    RMSNorm launches through the replays equal to their derivation."""
    from repro_torch.configs import VFLConfig, get_config, reduced
    from repro_torch.core.async_engine import EngineConfig
    from repro_torch.data import lm_token_batches, vertical_partition
    from repro_torch.federation import Federation
    cfg = reduced(get_config("phi3-mini-3.8b"), d_model=64, n_heads=2,
                  n_kv_heads=1, d_ff=128, vocab_size=256)
    q, T = LM_ROUND["queries"], LM_ROUND["rounds"]
    toks = next(lm_token_batches(0, cfg.vocab_size, LM_ROUND["rows"],
                                 LM_ROUND["seq"]))["tokens"]
    fed = Federation.build(
        cfg, VFLConfig(mu=1e-3, lr_server=0.05, lr_client=1e-4,
                       zoo_queries=q, active_rows_only=True),
        EngineConfig(method="cascaded", steps=T,
                     batch_size=LM_ROUND["batch"], use_lanes=True),
        n_clients=LM_ROUND["n_clients"], seq_len=LM_ROUND["seq"])
    params, x, y = fed._engine_inputs(
        fed.init_params(torch.Generator(fed.device).manual_seed(0)),
        vertical_partition(toks, LM_ROUND["n_clients"]), toks)
    engine_rounds(fed, params, x, y, graph=False)          # warm-up
    for c in counters:
        c.reset_launches()
    out = graph_vs_eager(f"engine round, reduced phi3 at lm_async's shape "
                         f"(q = {q})", fed, params, x, y)
    ran = _launches(counters)
    plan = pop_plan(cfg, q, 2 * T, 2 * T)    # the eager run and the graph's
    want = plan["launches"]
    log(f"engine round, reduced phi3: launches over the eager and the "
        f"captured run {ran}, derived {want} ({plan['why']}); a replay "
        f"{out['graph']['launches_a_replay']}")
    if {k: ran[k] for k in want} != want:
        raise AssertionError(f"the LM round launched {ran}, want {want}")
    if not torch.isfinite(out["losses"]).all():
        raise AssertionError("the LM round's losses are not finite")
    for kname in ("flash_attention", "rmsnorm"):
        rows[kname]["launches"] += want[kname]
        rows[kname].setdefault("launches_by_path", {})[
            "engine round: reduced phi3 (lm_async shape), eager + graph"] = \
            want[kname]


if __name__ == "__main__":
    sys.exit(main())
