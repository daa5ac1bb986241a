#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failed check exits non-zero and prints no result):

1. Device line: the card's name and power limit from ``nvidia-smi``; then
   the hand-written kernels are built from ``src/repro_torch/kernels/csrc``.
2. Kernel phase: K3 ``flash_attention`` and K4 ``decode_attention`` at the
   dense serving chain's shapes and at zamba2-7b's shared block (32 heads of
   112), then at fixed lengths a later change can compare with (K3 at a
   causal T = 1024; K4 over a full cache of 512 rows at both shapes and of
   4096 rows, where the bytes set the time: ``bound_share`` is bound_ms / ms,
   and every timed call reads the next of enough copies of the cache to
   exceed the L2 four times over), then at qwen3-moe-30b-a3b's attention
   (32 query heads over 4 kv heads of 128) and at the groups of starcoder2-3b
   (24/2 heads of 128) and granite-34b (48/1), wider than one head slice of
   the kernel, then the served decoders' own shapes (K3 at T = 300 for
   stablelm-1.6b's 32/32 heads of 64, starcoder2-3b's 24/2, granite-34b's
   48/1 and chameleon-34b's 64/8 of 128; K4 at stablelm's and chameleon's at
   the serve's cur_len; seamless-m4t-medium's: K3 non-causal at T = S = 300,
   16/16 heads of 64, the encoder's, and K4 over 300 source rows, all valid,
   the decoder's cross-attention; every K4 case also with ``return_lse``:
   the same output bits, each head's logsumexp within LSE_TOL of the plain
   one's, -inf at cur_len 0); K1 ``paged_decode_attention`` (the paged serve
   path's shape, B = 1, MQA, qwen3's 32/4 heads of 128, the two wide groups
   and chameleon's 64/8 of 128) and K2 ``paged_chunk_attention`` at the
   paged serve paths' (llama's 32/8 heads of 64, qwen3's 32/4 of 128,
   granite's 48/1 of 128: the 512-row chunk); K5 ``moe_gmm`` at the
   MoE serve path's (E = 128): every row kept at C = 8, 24, 40, and ``rows``
   from a top-8 routing through the layer's own ``route`` (a decode step's
   gate/up and down, 8 paged sequences' gate/up: skipped rows exact zeros,
   equal to the kernel without ``rows``, timed over copies of w that exceed
   the L2, the bound counting the active experts' bytes; the dense bound
   beside it); K6 ``ssd_scan`` at the SSM and hybrid paths' (T = 300 for
   each model, T = 37, T = 512, G = 2; y and the final state), each held
   against its plain PyTorch version at rtol = atol = 2e-2 and timed with
   CUDA events (median of 21 samples of 10 back-to-back calls, after
   warm-up) beside its plain version, one library call on the same inputs (a
   yardstick only; the port never calls it: ``scaled_dot_product_attention``
   — for K1 and K2 on the pre-gathered contiguous cache, the gather timed
   apart — ``torch.bmm`` for K5; none computes K6) and the least time the
   card could take (``bound_ms``). Every kernel must give equal bits on two
   launches. A ``ptxas`` line gives every kernel's registers and spills, per
   head dim for K3 and K4. K3's gradient (``csrc/flash_attention_bwd.cu``:
   prep, the sweep on wgmma fed by TMA, post) at seven shapes
   (``FLASH_GRAD_CASES``: the train shape B = 2, T = S = 4096, 32/8 heads of
   64; T = 300; 48/1 at B = 1 and 2 and 64/8 of 128, whose query heads the
   sweep splits over blocks; 32/32 of 112; T = 300 non-causal; and
   seamless-m4t-medium's train shape, one row at T = S = 4096, 16/16 of
   64, non-causal): dq, dk and
   dv against ``mha_ref_bwd`` within 2e-2 of each tensor's max |g|, equal
   bits on two launches and through autograd, one launch of each kernel a
   call, the forward with lse equal in bits to the forward without it;
   timed (the three kernels together and each alone, TFLOP/s, the share of
   the bound) beside the plain backward and SDPA's backward. K5's gradient
   (``csrc/moe_gmm_bwd.cu``: dxe and dw) at qwen3-moe-30b-a3b's train shape
   (E = 128, C = 640 from ``capacity`` at 2 x 4096 tokens, ``rows`` from a
   top-8 routing; gate/up, the down-projection, a ragged ``rows`` with
   experts at 0, at full C and between) and K6's gradient
   (``csrc/ssd_scan_bwd.cu``: the walks, then the chunks; SSD_GRAD_CASES)
   at T <= 512 (mamba2's and zamba2's heads, T = 300, two groups, a
   final-state cotangent) and at the train shapes (B = 2, T = 4096, where
   the plain backward runs in fp32 over slices of 8 heads; dt at the model's
   scale and at a slow decay whose states reach across tens of chunks):
   each output within 2e-2 of
   its max |g| against ``gmm_ref_bwd`` / ``ssd_ref_bwd``, equal bits on two
   calls and through autograd, one launch of each kernel a call; timed
   beside the plain backward and, for K5, two ``torch.bmm``, with each of
   the two kernels' own ms (``kernel_ms``, torch.profiler) and, for K6, the
   split of a group's heads and the bytes of its state workspace. A
   ``grad_refusal`` line: each of the three wrappers without a backward (K4,
   K1, K2), given a CUDA input that requires grad under grad mode, raises
   before its launch; K3, K5 and K6 under grad launch their forward and each
   backward kernel once, no plain version.
2b. Dry-run phase: ``long_kernels`` — K3, K4 and K6 at the 32k cells'
   32,768 positions (K3 causal at T = S = 32768 with llama3.2-1b's heads,
   its first 4096 rows against the plain version on the prefix and its last
   256 against ``mha_ref(..., q_offset=)``; K4 over a 32768-row cache, whole;
   each (row, head) of both within RTOL of its own max, and the same check
   must refuse a version that drops an eighth of the keys; K6 with
   mamba2-370m's heads, y whole and the final state against
   ``models/ssm.ssd_chunked`` in fp32 within RTOL of their max, and the same
   check must refuse that scan with the state dropped every 4096
   positions; its first 4096 positions elementwise against the plain
   version), K3 and K4 also within RTOL / ATOL elementwise, equal bits on two
   launches, timed beside its bound; then ``dryrun``: the port's dry run
   (``repro_torch.launch.dryrun``) at DRYRUN_CELLS, each reckoned on meta
   tensors (FLOPs, bytes and peak of a step, the batch per step that fits
   the card, the roofline bound from the H100's datasheet peaks). The four
   DRYRUN_EXECUTED cells (llama3.2-1b's train_4k, prefill_32k and
   decode_32k, mamba2-370m's prefill_32k) then run on the card at that
   batch, a step under the cost analysis and a bare timed step each: the
   predicted peak within 10 % of the allocator's, the
   card's FLOP count equal to the meta count, each kernel's launches equal
   to the calls the meta run recorded; zamba2-7b's long_500k and
   phi3.5-moe-42b-a6.6b's decode_32k must not fit. Each cell prints its step
   ms against its step's bound; the records go to
   ``chiprun_out/dryrun_torch.jsonl``.
3. Serve phase: full-width ``llama3.2-1b`` (16 layers, random bf16 weights
   from a fixed seed) deployed as the six-function chain on an unfused and a
   fusing ``TinyTorchBackend`` sharing the same weights; three prompts
   (37, 128, 300 tokens) generate 16 greedy tokens each, the two platforms
   taking turns; the first prompt (warm-up and the merges) is not timed.
   Checks: 6 live instances unfused, 1 fused with a healthy merge, identical
   tokens on both platforms and against the model run without the
   platform, and that the main path launched K3 once per layer of each
   prefill and K4 once per layer of each decode step (the merges' canary
   replays counted) and never called their plain versions. ``ram_bytes``
   counts, per live instance, the 32 MiB runtime constant, the weights and
   the largest recorded workspace + output bytes of its compiled entries
   (``footprints`` lists each instance's entries); fused must stay below
   unfused. (A unit's first run resets the device's peak-memory counter to
   measure its workspace, so a phase's ``peak_allocated_gb`` is the peak
   since the last such run.) Every compiled entry is captured as a CUDA
   graph at its second run and replayed from then on: ``graphs`` lists each
   live instance's captured entries, and every decode entry that ran twice
   must have been captured and one replayed (every serve and paged phase
   checks it); the launch counts stay exact, ``launch_parts`` giving the
   eager and the replayed part (a capture records its launches, each replay
   adds them once). Per-token p50 fused / unfused is reported. Every
   platform traces (``repro_torch.obs``); a ``trace_serve`` line checks
   that every trace conserves (its phases sum to its wall time within
   1e-9 s), that each unfused ``invoke`` trace holds the chain's 5
   ``cross-function-sync`` spans and each fused one after the merge none,
   and that the control timeline holds the fused unit's ``fused-inline:``
   events and one ``merge:`` span per healthy merge whose seconds are its
   ``build_s``; it gives the decode steps' phase shares. The fused
   platforms of the serve, paged and profile phases turn the reference's
   promotion of a cold edge off (``SERVE_POLICY``: their traffic is serial
   ``invoke``, which gives the scheduler no tail).
4. Paged serve phase: full-width ``llama3.2-1b`` served from the paged KV
   arena (321 pages of 16 tokens) by the continuous batcher at capacity 8:
   24 requests of 37, 128 and 300 prompt tokens (8 sharing a 128-token
   prefix, 2 exact repeats) generating 18-30 tokens each, fused (the chain
   fused on dense traffic first) and then unfused. Checks: every request
   completes, K1 and K2 launched and no plain version ran, the arena is
   consistent and empty afterwards, 1 live instance fused with a healthy
   merge and less ``ram_bytes``, one batched paged decode step against the
   dense one block by block within 5e-2, and a small model served by the
   batcher gives per-request generate's tokens; every ``serve`` trace
   conserves (chunked prefill and copy-on-write included).
5. Reference phase: the card against the host's CPU (plain versions, the
   same bf16 weights). A small input — llama3.2-1b cut to 2 layers of width
   256 (head dim 64, which the kernels take) — must give the same prefill
   and decode logits within 2e-2 of max |logit|; at full width each
   block's contribution on the same input must agree within 5e-2, and how
   far bf16 rounding alone carries the end-to-end logits is reported.
6. Profile phase: where a fused decode step's time goes — the host's wall
   clock against the device's kernel time (``torch.profiler``) — its ten
   costliest kernels and the device time of each hand-written kernel; the
   step is a replay of the fused unit's captured CUDA graph. ``step_gap``
   (here and in the MoE profile) splits a step's wall time beyond its
   kernels into the copy-in, the host's replay call, the gaps between the
   graph's nodes and the copy-out (host clocks and CUDA events around each;
   the graph's kernels from ``torch.profiler`` over bare replays).
6b. Batched phase: ``load_bench``'s closed-loop main path driven against the
   port on full-width ``llama3.2-1b``: 8 client threads, each prefilled
   once with a random 8-token prompt and its own max_len caches, feeding a
   constant token; one fused platform with ``max_batch`` 8 and
   ``max_delay_ms`` 2; 8 warm-up then 48 timed decode steps per client,
   first ``fused-serial`` (``invoke``), then ``fused-batched``
   (``decode_step_async`` -> ``invoke_async`` -> the scheduler -> one
   vmapped program per power-of-two bucket, captured at its second run).
   Checks: a batch of 2 or more formed, no request of the decode entry fell
   back to per-request execution, K4 launched exactly once per layer of each
   program run, a bucket program was captured, and one batched step's lanes
   against the same requests' ``invoke`` (logits and caches within 2e-2 of
   max |value|; K4 under vmap at the lanes' own caches equal in bits to K4
   per lane). Prints requests/s and p50/p95/p99 of both modes. A
   ``trace_batched`` line: every ``invoke_async`` trace tiles its wall time
   exactly (residual 0.0), its members reference exactly the batch traces,
   and the tracing-overhead gate of ``load_bench``: requests/s of
   ``fused-batched`` with tracing on over off at least 0.97, in 32
   interleaved rounds of 48 timed steps per client (after 4 untimed ones)
   on the warm platform, each attempt after a full collection and one
   untimed round, one retry.
6c. Dispatch and export: a ``dispatch`` line — the dispatch tracer armed
   over the steady state of the serve phase (the first prompt served a
   third time on each platform), the paged serve phase (its requests a
   third time, fused) and the batched phase (24 more batched steps): no
   new program (entry, capture or bucket), host fetches within decode steps
   + 2 x requests + capacity, and the sync-debug count beside them; a
   ``chrome_trace`` line — the llama phases' traces written to
   ``chiprun_out/trace_llama.json`` (Chrome ``trace_event``) and parsed back.
6d. Cold-start phase (``coldstart``): scale-to-zero of the full-width
   ``llama3.2-1b`` chain on one engine, snapshots in a temporary directory.
   The serve phase's prompts with ``SERVE_POLICY`` until the chain is one
   instance (the cold start: deploy plus the first token, the executable
   index emptied first; beside it the same start with the weights' copy
   from host memory to the card timed before it); then two cycles of ``engine.scale_to_zero()`` and
   the prompts again. Checks at each park: all 6 functions parked and
   resolving nowhere, ``ram_bytes`` 0, the allocated device memory down by at
   least 99 % of the weights' bytes (the tied table once). After each: the
   same tokens bit for bit, 6 billed and warm resurrects, the chain fused
   to one instance again, launches exactly as the prefills, decode steps,
   merge canaries (twice) and resurrect health checks (once) make them; in
   the second cycle no new entry or bucket (the dispatch tracer) and every
   merge warm (the first re-fusion merges at its first request, on prefill
   canaries, so it may build entries once). Reported: the park's seconds,
   puts, dedup hits and bytes on disk; each resurrect's seconds (read,
   verify hash, copy to the device, health check, publish); the time to
   first token after a park against the cold start; captures; per-token
   p50 re-fused; the allocated memory after the resurrect. Then the paged
   route: the first 8 paged requests (K1, K2) through the continuous
   batcher over a fresh arena before and after a third park give the same
   tokens. The ``chrome_trace`` line follows it.
6e. Control-plane phases, full-width ``llama3.2-1b`` (weights from seed 0)
   unless said otherwise. ``orchestrated_serve``: the serve phase (3) on
   ``OrchestratedBackend`` (a pod per unit: a queue and a thread), the
   executable index emptied first, unfused then fused: its checks, tokens
   identical to the ``TinyTorchBackend`` serve phase's, the live pods the
   live instances (6 unfused, 1 fused), every retired unit's pod thread
   exited, every graph capture on a pod's thread; per-token p50s beside the
   serve phase's; then the batched phase (6b) through the pods, without the
   tracing gate. ``replicas``: ``load_bench``'s replicas gate (hot handler:
   eager compute on the card, a 5 ms host wait, a boundary call; 8
   shape-distinct closed-loop clients and a strict class at 250 ms; one
   instance, then the autoscaler): at least 1.5x the requests/s, the strict
   p95 in target in both runs, warm scale-outs with no new entry, capture or
   bucket, picks on at least 2 replicas, scale-in back to 1 replica once the
   load stops, every future resolved; then the fused llama unit with a
   second replica (``request_replica``): no demand stamped or invocation
   billed by the spin-up, no new entry, identical tokens on each replica,
   exact launches, less than 0.5 GB of device memory added; the spin-up
   seconds beside the merge seconds. ``churn``: ``load_bench``'s churn on
   the pods (H's loop on the card, 2048 wide, calibrated to 80 ms per batch
   of 4): the merge and the split with its regret reason, every future
   resolved, L's requests/s at least 1.3x after the split. ``split``: the
   fused unit split into ``{embed, g0, g1}`` and ``{g2, g3, head}``, served,
   re-merged after ``remerge_backoff_s`` (the policy's virtual clock): a
   healthy split, identical tokens before, after and re-merged, a re-merge
   inside the backoff refused as "recently split", allocated memory within
   0.5 GB of the cells' count, no segment of the fused unit's graph pool
   left, a warm re-merge with no new entry, exact launches.
6f. Training phases, after the control plane, the earlier tensors freed:
   ``train`` — full-width ``llama3.2-1b`` (remat as its config has it)
   trained 16 steps through ``TrainLoop`` at T = 4096 with a batch of 4 as
   2 microbatches (bf16 params, fp32 moments, AdamW at lr 1e-2 with the
   launcher's cosine schedule, the affine stream, seed 0; the state handed
   to the loop, AdamW in place): every loss and
   grad_norm finite, the last 4 losses' mean below the first 4's, K3's
   forward launched exactly twice (remat) and each backward kernel once per
   layer of each microbatch, no plain version; step ms, tokens/s, peak
   memory, the state's bytes, one profiled step's busy share and K3's
   share, and where a step peaks. ``train_card_vs_host`` — a small model's
   step (loss, grad_norm within 2e-2; every gradient within 5e-2 of its
   max), its donated step equal bit for bit to its functional one, and the
   first and last full-width block's forward and backward at T = 512 (dx
   and every parameter gradient within 5e-2 of its max), attention at
   fan-in d.
   ``train_restart`` — the reference's restart (12 steps, a checkpoint
   every 4, failures at 5 and 9) bit-exact under
   ``torch.use_deterministic_algorithms``. ``launch_train`` —
   ``python -m repro_torch.launch.train`` at full width with no
   ``--device``: it runs on ``cuda``. ``train_seconds`` gives each part's
   seconds and the build's.
7. MoE serve phase: the llama tensors freed, full-width
   ``qwen3-moe-30b-a3b`` at 24 of its 48 layers (MOE_SERVE_LAYERS; 128
   experts, top 8, random bf16 weights from seed 0, about 31 GB) as the
   eight-function chain, unfused and fused, with the serve phase's prompts and checks
   (8 live instances unfused, 1 fused, less ``ram_bytes``, identical tokens
   fused, unfused and without the platform), and K5 launched exactly three
   times per MoE layer applied, the merges' canary replays counted.
8. Paged MoE phase: the same weights served by the continuous batcher over
   the 321-page arena, the first 8 of the paged phase's requests, fused and
   then unfused, with the paged phase's checks (K1, K2 and K5 launched).
9. MoE block check: one full-width MoE layer on the same bf16 input on the
   card (K5) and on the host's CPU: at least 99 % of the tokens' top-8
   expert sets agree, and the outputs on those tokens within 2e-2 of max |y|.
10. MoE profile: phase 6 for a fused MoE decode step; then peak device
   memory (``torch.cuda.max_memory_allocated``).
11. SSM phases: the qwen3 tensors freed, full-width ``mamba2-370m`` at full
   depth (48 layers, 0.74 GB) as the six-function chain, unfused and fused,
   with the serve phase's prompts and checks, every kernel's launches
   exactly as the run's prefills, decode steps and canary replays make them
   (K6 once per SSM layer of each prefill, none in a decode step: that is
   the recurrent form); K6 on the inputs the first layer gives it (held at
   2e-2 of max |y|); the first block card vs host, every block's prefill +
   one decode step against its longer prefill, a small model card vs host;
   a profiled fused decode step and prefill.
11b. SSM cold-start phase (``ssm_coldstart``): full-width ``mamba2-370m``
   on a fusing platform with ``idle_park_s`` 1.0 on the real clock: the
   prompts served, the reconciler thread itself parks the idle chain
   (within 10 s), and the prompts again give the same tokens with K6
   launched exactly as the prefills, merge canaries and resurrect health
   checks make it.
12. Hybrid phases: the same for full-width ``zamba2-7b`` (81 layers: 13
   groups of 6 Mamba layers each followed by the shared attention block,
   and a tail of 3; 13.5 GB) as the three-function chain
   ``embed -> core -> head``; K3 once per shared-block application of each
   prefill, K4 once per application of each decode step, K6 as above.
13. Decoder phases (``DECODERS``): the hybrid's tensors freed, full-width
   ``stablelm-1.6b`` (24 layers, 32/32 heads of 64, LayerNorm; 6 functions),
   ``starcoder2-3b`` (30 layers, 24/2 heads of 128, LayerNorm and tanh GELU;
   5), ``granite-34b`` (24 of its 88 layers, ``DECODER_LAYERS``: the run's
   time; 48/1 heads of 128, a tied head; 10, 18.8 GB) and ``chameleon-34b``
   (24 of its 48 layers, 64/8 heads of 128, QK-norm; 8, 35.4 GB), each made
   once from seed 0 and shared by every platform of its
   phases: the serve phase with its checks (N -> 1 instances, identical
   tokens fused, unfused and without the platform, less ``ram_bytes``,
   exact launches with ``launch_parts``, decode entries captured and
   replayed; chameleon serves one more prompt, 300 rows of ``embeds``);
   for granite and chameleon the paged serve phase over the 321-page arena
   at capacity 8 with 8 requests (granite's token prompts share a prefix:
   K1 and K2 at 48/1; chameleon's are the ``embeds`` of theirs, admitted by
   the batcher's serialized dense prefill: K1 and K3, no K2, no page shared
   or copied on write) with the paged phase's checks (K1 against K4 block by
   block within 5e-2); the first and last block card vs host within 5e-2 of
   the block's contribution; the memory record (parameter bytes, peak
   allocated, their shares of the device; a phase that runs out of memory
   fails the run).
14. Launcher phase (``launch_serve``): ``python -m repro_torch.launch.serve``
   in a process of its own, twice (``LAUNCH_RUNS``): full-width
   ``stablelm-1.6b`` with its defaults, and ``--arch chameleon-34b
   --reduced --backend orchestrated`` (its ``embeds`` through pods); each
   run's JSON shows one healthy merge of the whole chain, 1 instance left
   and the device ``cuda``, with no ``--device`` given.
15. Enc-dec phases (``encdec_phases``), the earlier tensors freed:
   ``encdec_serve`` — full-width ``seamless-m4t-medium`` (12 encoder and 12
   decoder layers, d 1024, 16/16 heads of 64, vocab 256,206; 1.75 GB) as
   the two-function app ``embed`` (the encoder) -> ``decoder``, source
   prompts of 37, 128 and 300 frame rows (stub frontend frames, drawn by
   the model's ``make_inputs``) and a first token,
   16 greedy tokens each, unfused then fused (a decode step invokes the
   decoder itself, entering the fused unit at its second member): 2 -> 1
   instances, the same tokens fused, unfused and without the platform,
   less ``ram_bytes``, decode entries captured and replayed, K3
   (non-causal) and K4 launched exactly as ``expected_launches`` predicts
   for the chain, no plain version; per-token p50s and peak memory.
   ``encdec_card_vs_host`` — the small model (2 + 2 layers, d 256) card vs
   host: the prefill and 3 decode steps within 2e-2 of max |logit|, one
   train step's loss, grad_norm and gradients as ``train_card_vs_host``
   holds them, attention at fan-in d and the cross-attention over
   unit-scale states (``encdec_unit_cross_keys``). ``encdec_train`` — 6
   AdamW steps of the full-width model at T = 4096 (source frames and
   target tokens), a batch of 4 as its 4 microbatches: finite losses, K3's
   forward twice (remat) and each backward kernel once per attention of
   each microbatch, no K4; step p50 and peak memory. ``kvpool_stress`` —
   the KV arena's three-thread sharing fuzz (``kvpool_stress``) on CUDA
   pools for about 10 s, its data and bookkeeping checked as on the host.

16. Family training phases (``family_training_phases``), the earlier tensors
   freed: ``moe_train`` (qwen3-moe-30b-a3b at full width, 4 of its 48
   layers), ``ssm_train`` (mamba2-370m, full width and depth) and
   ``hybrid_train`` (zamba2-7b at full width, 14 of its 81 layers: two groups
   of 6, the shared block applied twice, and a tail of 2), each 8 AdamW steps
   (lr 5e-4, 1e-3, 3e-4) at T = 4096, a batch of 4 as 2 microbatches, remat,
   the state handed to the loop (``donate.donating()``: AdamW in place, one
   training state on the card): losses, moe_aux and
   grad_norm finite, the last 3 losses' mean below the first 3's, every
   kernel's launches exact
   (``family_expected_launches``: the forward kernels twice a layer under
   remat, K5 3 and its two gradient kernels 3 per MoE layer, K6 and its two
   gradient kernels 1 per Mamba layer, K3 and its gradient per attention),
   no plain version; step ms, tokens/s, peak memory, moe_dropped, a
   profiled step's busy share and where a step peaks (``step_memory``: the
   peak inside each microbatch's forward and backward and inside the
   update). Each family's ``<key>_train_card_vs_host``: a small model's
   step (``train_card_vs_host``), its donated step against its functional
   step bit for bit (``donated_step_check``) and the full-width first
   and last block (the hybrid's shared block too; its last is a tail block) at T = 512
   (``family_block_check``); an MoE model's host pass takes the card's
   routing (``RoutingReplay``: routing is discontinuous, and the two sides'
   bf16 roundings move near-tie tokens; the tokens the host would have
   routed otherwise are counted). ``moe_train_restart`` and
   ``ssm_train_restart``: the bit-exact restart on a small MoE and SSM
   model. ``launch_train_ssm``: the launcher on full-width mamba2-370m with
   no ``--device``. ``family_train_seconds``: each part's seconds.

17. Mesh phase (``mesh_phase``): (a) ``mesh_dryrun``: the dry run
   (``launch/dryrun.py --mesh``) of ``llama3.2-1b decode_32k`` on the
   reference's (16, 16) and (2, 16, 16) meshes and of ``qwen3-moe-30b-a3b
   train_4k`` on (16, 16) (its expert-parallel schedule), rank 0's program
   on meta tensors in a fake group of 512 ranks: the llama cells'
   ``params_bytes_per_device`` and ``model_flops_per_device`` equal the
   reference's record (``results/dryrun.jsonl``), each collective kind's
   count and bytes printed beside the reference's (no limit: GSPMD and the
   port choose their collectives differently); every K5 call of the qwen3
   cell at E/16 = 8 experts, its reduce-scatter or all-reduce bytes
   non-zero. (b) ``mesh_nccl``: one process per card over NCCL
   (``make_smoke_mesh``: (1, 1) on one card, (2, 2) on four); full-width
   llama3.2-1b takes MESH_TRAIN_STEPS AdamW steps under ``train_rules`` at
   B = 2, T = 4096 (one microbatch of the train phase's shape), and the same
   steps with no mesh: every forward and backward kernel launched as often,
   no plain version; then full-width qwen3-moe-30b-a3b's MoE layer on the
   same mesh against the layer with no mesh, K5 launched. On (1, 1) every
   collective is the identity and the two runs are one program, so the
   losses, the MoE layer's y and its metrics must be equal bit for bit, and
   the layer runs ``dropping`` (the expert-parallel schedule needs 'model'
   over more than one rank): on one card only (c) runs EP. On a larger
   mesh each loss must be within 2e-2 relative and y within 2e-2 of max
   |y|, and the layer runs ``dropping_ep``. (c) ``mesh_ep_ranks``: what each
   rank of a 4-way expert-parallel MoE layer computes, run one rank after
   the other on this card (one card is all there is): full-width qwen3's
   layer, each rank's dispatch, K5 on its 32 of the 128 experts and its
   combine's partial sum; the partials' sum within 2e-2 of max |y| of the
   unsharded layer (K5 on all 128), the dropped share equal. What a mesh
   costs in time, and NCCL across cards, need a machine with four.

Standard output opens with the device line and the ``ptxas`` line; its
last lines are the ``grad_refusal``, ``long_kernels``, ``dryrun``,
``serve``, ``trace_serve``, ``paged_serve``,
``reference``, ``profile``, ``batched``, ``trace_batched``, ``dispatch``,
``coldstart``, ``chrome_trace``, ``orchestrated_serve``, ``replicas``,
``churn``, ``split``, ``train``, ``train_card_vs_host``, ``train_restart``,
``launch_train``, ``train_seconds``, ``moe_serve``, ``moe_paged_serve``,
``moe_block``, ``moe_profile``, ``moe_memory``,
``ssm_serve``, ``ssm_block``, ``ssm_profile``, ``ssm_memory``,
``ssm_coldstart``, ``hybrid_serve``, ``hybrid_block``, ``hybrid_profile``, ``hybrid_memory``,
``<key>_serve``, ``<key>_block`` and ``<key>_memory`` for ``stablelm``, ``starcoder2``,
``granite`` and ``chameleon`` (``granite_paged_serve`` and ``chameleon_paged_serve``
after their serve lines), ``launch_serve``, ``encdec_serve``, ``encdec_card_vs_host``,
``encdec_train``, ``kvpool_stress``, ``moe_train``, ``moe_train_card_vs_host``, ``moe_train_restart``,
``ssm_train``, ``ssm_train_card_vs_host``, ``ssm_train_restart``, ``hybrid_train``,
``hybrid_train_card_vs_host``, ``launch_train_ssm``, ``family_train_seconds``, ``mesh_dryrun``,
``mesh_nccl``, ``mesh_ep_ranks``, ``mesh_seconds`` and ``kernels`` JSON
lines and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

RTOL = ATOL = 2e-2  # tests/test_kernels.py bf16 tolerance
REF_TOL = 2e-2  # bf16 logits, card vs host, over max |logit| (tests/test_torch_model.py)
LSE_TOL = 1e-3  # K4's fp32 logsumexp against its plain version's, absolute (values of ~log S)
# A full-width block's output, card vs host, over its max. The JAX init rule
# draws wq and wk with fan-in H = 32 and KV = 8, not d_model = 2048, so with
# random weights q and k entries have variances 64 and 256, the attention
# scores a std of about 128, and attention is nearly hard: rounding alone
# moves a block by up to ~2 %.
BLOCK_TOL = 5e-2
TIMED_SAMPLES = 21  # CUDA-event samples per timing, of REPS calls each
REPS = 10
SLEEP_CYCLES = 2_000_000  # ~1 ms of device sleep ahead of each sample
# K/V bytes a cold K4 case rotates through: four times the H100's 50 MB L2
COLD_BYTES = 4 * 50 * 2**20


# the plain versions' call counters (repro_torch.kernels.ref.CALLS)
PLAIN = ("mha_ref", "mha_ref_bwd", "decode_attn_ref", "paged_decode_attn_ref", "paged_chunk_attn_ref", "gmm_ref",
         "gmm_ref_bwd", "ssd_ref", "ssd_ref_bwd")
# each kernel of a serve phase and the plain version that stands in for it on
# the CPU (the CPU's SSM prefill runs the chunked scan, not the plain K6)
STAND_INS = {"flash_attention": "mha_ref", "decode_attention": "decode_attn_ref", "moe_gmm": "gmm_ref"}


# the device-side names of the hand-written kernels (csrc/*.cu)
PORT_KERNELS = ("flash_attention_kernel", "flash_bwd_prep_kernel", "flash_bwd_kernel", "flash_bwd_post_kernel",
                "decode_attention_kernel",
                "paged_decode_kernel",
                "paged_chunk_kernel", "moe_gmm_kernel", "ssd_scan_kernel", "moe_gmm_bwd_dx_kernel",
                "moe_gmm_bwd_dw_kernel", "ssd_bwd_walk_kernel", "ssd_bwd_chunk_kernel")


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def time_ms(torch, fn, samples: int = TIMED_SAMPLES, reps: int = REPS) -> float:
    """Median device time of one ``fn()`` in ms, after warm-up: CUDA events
    around ``reps`` back-to-back calls, queued behind a short device sleep
    so that the host's cost of issuing them does not show."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least ms of ``flops`` and ``nbytes`` at the H100 SXM's datasheet
    peaks (dense bf16 tensor-core rate, HBM3 rate: the dry run's ``HW``), and
    which of the two sets it."""
    from repro_torch.launch.dryrun import HW

    t_ops = flops / HW["peak_flops_bf16"] * 1e3
    t_bytes = nbytes / HW["hbm_bw"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(torch, got, want) -> float:
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), "kernel output has non-finite values")
    excess = (got - want).abs() - (ATOL + RTOL * want.abs())
    check(float(excess.max()) <= 0.0, f"kernel disagrees with its plain version beyond {RTOL}")
    return float((got - want).abs().max())


def row_rel_err(torch, got, want) -> float:
    """The largest of each row's max |got - want| over its max |want| (a row:
    the last dimension, one query head's output or one head's P values), so
    that a row that averages tens of thousands of values, and is small for
    it, is held to its own scale."""
    got, want = got.float(), want.float()
    err = (got - want).abs().amax(dim=-1)
    return float((err / want.abs().amax(dim=-1).clamp_min(1e-30)).max())


# --------------------------------------------------------------- kernel phase


def flash_case(torch, F, t, H, KV, HD, rng, causal: bool = True) -> dict:
    """K3 at B = 1, T = S = ``t``, causal unless ``causal`` is false, on
    inputs drawn from ``rng``: against its plain version, two launches for
    equal bits, timed beside the plain version and SDPA on the same
    inputs."""
    from repro_torch.kernels import cost as kc
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    G = H // KV
    q = torch.randn(1, t, H, HD, generator=rng, device=dev).to(torch.bfloat16)
    k = torch.randn(1, t, KV, HD, generator=rng, device=dev).to(torch.bfloat16)
    v = torch.randn(1, t, KV, HD, generator=rng, device=dev).to(torch.bfloat16)
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    err = max_err(torch, got, fa.plain(q, k, v, causal=causal))
    check(torch.equal(got, fa.flash_attention(q, k, v, causal=causal)), f"flash_attention T={t} is not deterministic")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kr, vr = kt.repeat_interleave(G, dim=1), vt.repeat_interleave(G, dim=1)
    c = kc.flash_attention(1, t, t, H, KV, HD, causal=causal)
    b_ms, b_by = bound(c.flops, c.bytes)
    ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, causal=causal))
    return {
        "shape": f"B=1 T=S={t} H={H} KV={KV} hd={HD} {'causal' if causal else 'non-causal'} bf16",
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": time_ms(torch, lambda: fa.plain(q, k, v, causal=causal)),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kr, vr, is_causal=causal)),
        "bound_ms": b_ms,
        "bound_by": b_by,
        "bound_share": b_ms / ms,
    }


def rotating(fn, n: int):
    """A call that passes 0, 1, ..., n - 1, 0, ... to ``fn`` in turn."""
    calls = itertools.count()
    return lambda: fn(next(calls) % n)


def decode_case(torch, F, b, S, H, KV, HD, rng, lens=None, cold: bool = False) -> dict:
    """K4 at batch ``b`` over a cache of ``S`` rows on inputs drawn from
    ``rng`` (cur_len ``lens``, else drawn from ``rng`` too: random in [1, S],
    the edges 1 and S where b > 1): against its plain version, exact zeros
    at cur_len 0, two launches for equal bits, timed beside the plain version
    and SDPA with the cur_len mask on the same inputs. ``cold``: every timed
    call (kernel, plain version and SDPA alike) reads the next of ``copies``
    copies of K and V, together at least COLD_BYTES, so that the cache comes
    from device memory and not from the L2, as in a decode step, where each
    layer's cache is read once between the other layers' weights."""
    from repro_torch.kernels import cost as kc
    from repro_torch.kernels import decode_attention as dec

    dev = torch.device("cuda")
    G = H // KV
    q = torch.randn(b, H, HD, generator=rng, device=dev).to(torch.bfloat16)
    k = torch.randn(b, S, KV, HD, generator=rng, device=dev).to(torch.bfloat16)
    v = torch.randn(b, S, KV, HD, generator=rng, device=dev).to(torch.bfloat16)
    if lens is None:
        cur = torch.randint(1, S + 1, (b,), generator=rng, device=dev, dtype=torch.int32)
        if b > 1:  # the edges: one visible row, every row
            cur[0] = 1
            cur[-1] = S
    else:
        cur = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = dec.decode_attention(q, k, v, cur)
    torch.cuda.synchronize()
    err = max_err(torch, got, dec.plain(q, k, v, cur))
    check(torch.equal(got, dec.decode_attention(q, k, v, cur)), f"decode_attention S={S} is not deterministic")
    zeros = dec.decode_attention(q, k, v, torch.zeros_like(cur))
    check(bool((zeros == 0).all()), "decode_attention must give exact zeros at cur_len == 0")
    # the logsumexp that a sequence-split cache's combine weighs with: the
    # same output bits beside it, the heads' lse against the plain one's
    got_lse, lse = dec.decode_attention(q, k, v, cur, return_lse=True)
    lse_err = (lse - dec.plain_lse(q, k, v, cur)[1]).abs().max().item()
    check(torch.equal(got_lse, got) and lse_err <= LSE_TOL,
          f"decode_attention S={S} with its lse: output equal {torch.equal(got_lse, got)}, lse off by {lse_err}")
    zero_lse = dec.decode_attention(q, k, v, torch.zeros_like(cur), return_lse=True)[1]
    check(bool(torch.isneginf(zero_lse).all()), "decode_attention's lse must be -inf at cur_len == 0")
    mask = (torch.arange(S, device=dev)[None, :] < cur[:, None])[:, None, None, :]
    qt = q[:, :, None, :]
    copies = -(-COLD_BYTES // (2 * k.numel() * k.element_size())) if cold else 1
    ks = [k] + [k.clone() for _ in range(copies - 1)]
    vs = [v] + [v.clone() for _ in range(copies - 1)]
    krs = [x.transpose(1, 2).repeat_interleave(G, dim=1) for x in ks]
    vrs = [x.transpose(1, 2).repeat_interleave(G, dim=1) for x in vs]
    c = kc.decode_attention(b, S, H, KV, HD, rows=int(cur.clamp(max=S).sum()))
    b_ms, b_by = bound(c.flops, c.bytes)
    ms = time_ms(torch, rotating(lambda i: dec.decode_attention(q, ks[i], vs[i], cur), copies))
    return {
        "shape": f"B={b} S={S} H={H} KV={KV} hd={HD} cur_len={cur.tolist()} bf16",
        "copies": copies,
        "max_abs_err": err,
        "lse_max_abs_err": lse_err,
        "ms": ms,
        "plain_ms": time_ms(torch, rotating(lambda i: dec.plain(q, ks[i], vs[i], cur), copies)),
        "library_ms": time_ms(torch, rotating(
            lambda i: F.scaled_dot_product_attention(qt, krs[i], vrs[i], attn_mask=mask), copies)),
        "bound_ms": b_ms,
        "bound_by": b_by,
        "bound_share": b_ms / ms,
    }


def kernel_phase(torch, F) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    # zamba2-7b's shared-block cases, and the fixed-length and long cases
    # after them, draw from generators of their own, so that every earlier
    # case draws the inputs it drew before they were added
    gen112 = torch.Generator(device=dev).manual_seed(112)
    gen_fixed = torch.Generator(device=dev).manual_seed(15)
    gen128 = torch.Generator(device=dev).manual_seed(128)
    gen_wide = torch.Generator(device=dev).manual_seed(16)
    gen_dec = torch.Generator(device=dev).manual_seed(23)
    gen_ed = torch.Generator(device=dev).manual_seed(26)
    out = {}
    # the dense chain's prompts (llama3.2-1b), zamba2-7b's shared block, a
    # long causal prompt, and qwen3-moe-30b-a3b's attention (32/4 heads of 128)
    out["flash_attention"] = [flash_case(torch, F, *args) for args in (
        (37, 32, 8, 64, gen), (128, 32, 8, 64, gen), (300, 32, 8, 64, gen), (300, 32, 32, 112, gen112),
        (1024, 32, 8, 64, gen_fixed), (300, 32, 4, 128, gen128))] + [
        # the served decoders' prompts of 300: stablelm-1.6b (32/32 heads of
        # 64), starcoder2-3b (24/2 of 128), granite-34b (48/1), chameleon-34b (64/8)
        flash_case(torch, F, 300, h, kv, hd, gen_dec) for h, kv, hd in ((32, 32, 64), (24, 2, 128), (48, 1, 128),
                                                                         (64, 8, 128))] + [
        # seamless-m4t-medium's encoder over a source of 300 frames: 16/16
        # heads of 64, non-causal
        flash_case(torch, F, 300, 16, 16, 64, gen_ed, causal=False)]
    # the dense chain's decode (B = 1, 4; llama3.2-1b), zamba2-7b's shared
    # block; then fixed lengths that a later change can compare with: the
    # full S = 512 cache at both shapes, and a long cache of 4096 rows, where
    # the bytes, not the launch, set the time (read cold: see decode_case);
    # then qwen3-moe-30b-a3b's decode at the main case's cur_len
    out["decode_attention"] = [decode_case(torch, F, *args) for args in (
        (1, 512, 32, 8, 64, gen), (4, 512, 32, 8, 64, gen), (1, 512, 32, 32, 112, gen112))] + [
        decode_case(torch, F, 1, S, H, KV, HD, gen_fixed, lens=[S], cold=S > 512)
        for S, H, KV, HD in ((512, 32, 8, 64), (512, 32, 32, 112), (4096, 32, 8, 64), (4096, 32, 32, 112))] + [
        decode_case(torch, F, 1, 512, 32, 4, 128, gen128, lens=[406])] + [
        # starcoder2-3b's and granite-34b's groups (G * hd 1536 and 6144),
        # wider than one head slice of the kernel
        decode_case(torch, F, 2, 512, h, kv, 128, gen_wide) for h, kv in ((24, 2), (48, 1))] + [
        # stablelm-1.6b's and chameleon-34b's decode at the serve's cur_len
        decode_case(torch, F, 1, 512, h, kv, hd, gen_dec, lens=[406]) for h, kv, hd in ((32, 32, 64), (64, 8, 128))] + [
        # seamless-m4t-medium's decoder cross-attention over the 300 source
        # rows, all valid
        decode_case(torch, F, 1, 300, 16, 16, 64, gen_ed, lens=[300])]
    out.update(paged_kernel_cases(torch, F, gen))
    out["moe_gmm"] = moe_kernel_cases(torch, gen)
    out["ssd_scan"] = ssd_kernel_cases(torch, gen)
    return out


def grad_refusal_check(torch) -> dict:
    """Each of the three kernel wrappers without a backward (K4, K1, K2),
    given a CUDA input that requires grad under grad mode, raises before its
    launch (an output filled by its kernel would carry no gradient). K3
    (``flash_attention``), K5 (``moe_gmm``) and K6 (``ssd_scan``) under grad
    return gradients from their backward kernels: one launch of the forward
    and of each backward kernel, no plain version."""
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gm
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as sd

    dev = torch.device("cuda")
    bf = dict(device=dev, dtype=torch.bfloat16)
    one = torch.ones(1, dtype=torch.int32, device=dev)
    pages = torch.zeros(3, 16, 2, 64, **bf)
    table = torch.ones(1, 2, dtype=torch.int32, device=dev)
    x = lambda *shape: torch.zeros(*shape, **bf).requires_grad_()  # noqa: E731
    calls = {
        "decode_attention": lambda: dec.decode_attention(x(1, 4, 64), torch.zeros(1, 16, 2, 64, **bf),
                                                         torch.zeros(1, 16, 2, 64, **bf), one),
        "paged_decode_attention": lambda: pa.paged_decode_attention(x(1, 4, 64), pages, pages, table, one),
        "paged_chunk_attention": lambda: pa.paged_chunk_attention(x(1, 4, 4, 64), pages, pages, table, one),
    }
    out = {}
    with torch.enable_grad():
        for name, call in calls.items():
            try:
                call()
            except RuntimeError as exc:
                check("no backward" in str(exc), f"{name}: raised, but not the refusal: {exc}")
                out[name] = "raises"
            else:
                raise SmokeFailure(f"{name}: launched on a requires-grad input under grad mode")
        names = ("flash_attention", *GRAD_KERNELS)
        before = {n: build.launches(n) for n in names}
        plain = ref.CALLS["mha_ref"] + ref.CALLS["mha_ref_bwd"]
        q = torch.randn(1, 70, 4, 64, **bf).requires_grad_()
        kv = torch.randn(1, 70, 2, 64, **bf).requires_grad_()
        grads = torch.autograd.grad(fa.flash_attention(q, kv, kv).float().square().sum(), (q, kv))
        torch.cuda.synchronize()
        check({n: build.launches(n) - before[n] for n in names} == dict.fromkeys(names, 1),
              "flash_attention under grad: not one launch of the forward and of each backward kernel")
        check(ref.CALLS["mha_ref"] + ref.CALLS["mha_ref_bwd"] == plain, "flash_attention under grad ran a plain version")
        check(all(bool(torch.isfinite(g.float()).all()) and bool(g.any()) for g in grads),
              "flash_attention under grad: non-finite or all-zero gradients")
        out["flash_attention"] = "gradient from the kernel"
        r = lambda *shape: torch.randn(*shape, device=dev).to(torch.bfloat16).requires_grad_()  # noqa: E731
        f32 = lambda *shape: torch.randn(*shape, device=dev).requires_grad_()  # noqa: E731
        rows = torch.tensor([0, 8, 3], dtype=torch.int32, device=dev)
        backed = {
            "moe_gmm": (("moe_gmm", *MOE_GRAD_KERNELS), lambda: (lambda a: (gm.moe_gmm(*a, rows), a))(
                [r(3, 8, 64), r(3, 64, 32)])),
            "ssd_scan": (("ssd_scan", *SSD_GRAD_KERNELS), lambda: (lambda a: (sd.ssd_scan(*a), a))(
                [r(1, 70, 2, 64), r(1, 70, 1, 64), r(1, 70, 1, 64),
                 torch.nn.functional.softplus(torch.randn(1, 70, 2, device=dev)).requires_grad_(),
                 f32(2), f32(2)])),
        }
        for name, (names, call) in backed.items():
            before = {n: build.launches(n) for n in names}
            plain = sum(ref.CALLS[k] for k in PLAIN)
            y, ins = call()
            grads = torch.autograd.grad(y.float().square().sum(), ins)
            torch.cuda.synchronize()
            check({n: build.launches(n) - before[n] for n in names} == dict.fromkeys(names, 1),
                  f"{name} under grad: not one launch of the forward and of each backward kernel")
            check(sum(ref.CALLS[k] for k in PLAIN) == plain, f"{name} under grad ran a plain version")
            check(all(bool(torch.isfinite(g.float()).all()) and bool(g.any()) for g in grads),
                  f"{name} under grad: non-finite or all-zero gradients")
            out[name] = "gradient from the kernel"
    return out


# (label, B, T, H, KV, hd, causal) of K3's gradient: (a) the train phase's
# shape, (b) T = 300, (c) the widest groups at heads of 128 (granite-34b's
# 48/1 at B = 1 and 2, chameleon-34b's 64/8: the sweep splits their query
# heads over blocks), (d) MHA at 112 (zamba2-7b's shared block), (e) (b)
# non-causal
FLASH_GRAD_CASES = (
    ("a", 2, 4096, 32, 8, 64, True),
    ("b", 1, 300, 32, 8, 64, True),
    ("c", 1, 512, 48, 1, 128, True),
    ("c", 2, 512, 48, 1, 128, True),
    ("c", 1, 512, 64, 8, 128, True),
    ("d", 1, 512, 32, 32, 112, True),
    ("e", 1, 300, 32, 8, 64, False),
    # seamless-m4t-medium's train shape: one microbatch row at T = S = 4096,
    # 16/16 heads of 64, non-causal (the encoder and the cross-attention)
    ("f", 1, 4096, 16, 16, 64, False),
)
# K3's gradient: prep (D = rowsum(dO * o), the dQ counters), the sweep, post
GRAD_KERNELS = ("flash_attention_bwd_prep", "flash_attention_bwd", "flash_attention_bwd_post")
GRAD_TOL = 2e-2  # of each gradient's max |g|: bf16 inputs, sums in another order
# the plain backward at case (a) holds ~20 GB of fp32 scores and their
# gradients: it is timed in fewer samples of one call
PLAIN_GRAD_SAMPLES, PLAIN_GRAD_REPS = 5, 1


def flash_grad_case(torch, F, label, b, t, h, kv, hd, causal, gen) -> dict:
    """K3's gradient at one shape on inputs drawn from ``gen``: the forward
    with lse (equal in bits to the serve path's forward without it), then
    dq, dk and dv from the three backward kernels against ``mha_ref_bwd``
    within GRAD_TOL of each tensor's max |g|, equal bits on two launches and
    through autograd, exactly one launch of each kernel a call; timed (the
    three together and each alone) beside the plain backward and SDPA's
    backward on the same inputs (a yardstick only:
    ``scaled_dot_product_attention(..., enable_gqa=True)``'s graph, its
    backward alone). The sweep alone is timed with the memset that re-zeroes
    its dQ counters (prep zeroes them in a whole call), and the memset apart."""
    from repro_torch.kernels import build
    from repro_torch.kernels import cost as kc
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    q, dout = (torch.randn(b, t, h, hd, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(b, t, kv, hd, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    lse = torch.empty(b, h, t, dtype=torch.float32, device=dev)
    out32 = torch.empty(q.shape, dtype=torch.float32, device=dev)
    out = fa._forward(q, k, v, causal, lse, out32)
    check(torch.equal(out, fa.flash_attention(q, k, v, causal=causal)),
          f"K3 gradient {label}: the forward with lse differs in bits from the forward without it")
    check(torch.equal(out32.to(torch.bfloat16), out), f"K3 gradient {label}: the fp32 output does not round to out")
    check(bool(torch.isfinite(lse).all()), f"K3 gradient {label}: non-finite lse")
    before = {n: build.launches(n) for n in GRAD_KERNELS}
    got = fa.backward(q, k, v, out32, lse, dout, causal)
    torch.cuda.synchronize()
    check({n: build.launches(n) - before[n] for n in GRAD_KERNELS} == dict.fromkeys(GRAD_KERNELS, 1),
          f"K3 gradient {label}: not one launch of each backward kernel")
    check(all(torch.equal(a, c) for a, c in zip(got, fa.backward(q, k, v, out32, lse, dout, causal))),
          f"K3 gradient {label}: two launches differ in bits")
    x = [a.clone().requires_grad_() for a in (q, k, v)]
    auto = torch.autograd.grad(fa.flash_attention(*x, causal=causal), x, dout)
    check(all(torch.equal(a, c) for a, c in zip(got, auto)), f"K3 gradient {label}: autograd's differ in bits")
    want = fa.plain_bwd(q, k, v, dout, causal=causal)
    errs, abs_errs = {}, {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        check(bool(torch.isfinite(g.float()).all()), f"K3 gradient {label}: non-finite {name}")
        abs_errs[name] = float((g.float() - w).abs().max())
        errs[name] = abs_errs[name] / float(w.abs().max())
    del want, auto, x
    check(max(errs.values()) <= GRAD_TOL, f"K3 gradient {label}: beyond {GRAD_TOL} of max |g|: {errs}")
    flops, nbytes, _ = kc.flash_attention_grad(b, t, t, h, kv, hd, causal)
    b_ms, b_by = bound(flops, nbytes)
    ms = time_ms(torch, lambda: fa.backward(q, k, v, out32, lse, dout, causal))
    dsum, lse2, sem = fa.backward_prep(out32, dout, lse)
    dq_acc, dk, dv, ws, splits = fa.backward_sweep(q, k, v, dout, lse2, dsum, sem, causal)
    split = {"prep_ms": time_ms(torch, lambda: fa.backward_prep(out32, dout, lse)),
             "sweep_ms": time_ms(torch, lambda: (sem.zero_(), fa.backward_sweep(q, k, v, dout, lse2, dsum, sem, causal))),
             "counter_zero_ms": time_ms(torch, sem.zero_),
             "post_ms": time_ms(torch, lambda: fa.backward_post(dq_acc, ws, splits, q, dk, dv))}
    del dsum, lse2, sem, dq_acc, dk, dv, ws
    big = b * h * t * t >= 2**28
    plain_ms = time_ms(torch, lambda: fa.plain_bwd(q, k, v, dout, causal=causal),
                       *((PLAIN_GRAD_SAMPLES, PLAIN_GRAD_REPS) if big else ()))
    qt, kt, vt = (a.transpose(1, 2).detach().requires_grad_() for a in (q, k, v))
    o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)
    dot = dout.transpose(1, 2)
    library_ms = time_ms(torch, lambda: torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True))
    return {
        "case": label,
        "shape": f"B={b} T=S={t} H={h} KV={kv} hd={hd} {'causal' if causal else 'non-causal'} bf16",
        "head_splits": splits,
        "max_abs_err": max(abs_errs.values()),
        "rel_err": errs,
        "ms": ms, **split, "plain_ms": plain_ms, "library_ms": library_ms,
        "library": "scaled_dot_product_attention backward", "vs_library": ms / library_ms,
        "gflop": flops / 1e9, "tflops": flops / (ms * 1e-3) / 1e12,
        "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
    }


def flash_grad_cases(torch, F) -> list:
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(24)
    out = []
    for case in FLASH_GRAD_CASES:
        t0 = time.perf_counter()
        out.append({**flash_grad_case(torch, F, *case, gen), "seconds": time.perf_counter() - t0})
    return out


# K5's gradient (csrc/moe_gmm_bwd.cu: dxe and dw, two kernels) at
# qwen3-moe-30b-a3b's train shape: E = 128, C = capacity(2 x 4096 tokens),
# rows from a top-8 routing of that many tokens through the layer's own
# route() (gate/up, w (E, d, f)), the down-projection (w (E, f, d)), and a
# ragged rows vector with experts at 0, at full C and in between
MOE_GRAD_TOKENS = 2 * 4096
MOE_GRAD_KERNELS = ("moe_gmm_bwd_dx", "moe_gmm_bwd_dw")
# K6's gradient (csrc/ssd_scan_bwd.cu: the walks, then the chunks): (label,
# B, T, H, G, N, state cotangent, the plain backward's slice of heads, dt's
# scale). The plain backward holds (B, T, T, H) fp32 tensors: at T = 4096 tens
# of GB, so at the train shapes it runs over slices of 8 of a group's heads at
# once (None: whole), in fp32, the slices' dB and dC summed
# (ssd_plain_bwd_by_heads). dt's scale "model" is the recipe's softplus of a
# unit normal, ~0.8 (the ports' SSM layers give ~0.7: dt_bias 0, A_log 0):
# a state decays by ~e^-50 over a chunk, so the walks' states add little.
# "slow" draws dt ~0.02 and A_log ~ -2 (a ~ -0.14): a state keeps ~e^-0.2 of
# itself over a chunk and reaches across tens of the 64 chunks, so the
# gradient leans on the bf16 states of long walks.
SSD_GRAD_CASES = (
    ("mamba2-370m T=512", 1, 512, 32, 1, 128, False, None, "model"),
    ("zamba2-7b T=512, dS", 1, 512, 112, 1, 64, True, None, "model"),
    ("T=300, dS", 1, 300, 32, 1, 128, True, None, "model"),
    ("G=2", 2, 130, 8, 2, 64, True, None, "model"),
    ("mamba2-370m train B=2 T=4096", 2, 4096, 32, 1, 128, False, 8, "model"),
    ("zamba2-7b train B=2 T=4096", 2, 4096, 112, 1, 64, False, 8, "model"),
    ("mamba2-370m train B=2 T=4096, slow decay", 2, 4096, 32, 1, 128, False, 8, "slow"),
    ("zamba2-7b train B=2 T=4096, slow decay", 2, 4096, 112, 1, 64, False, 8, "slow"),
)
SSD_GRAD_KERNELS = ("ssd_scan_bwd_walk", "ssd_scan_bwd_chunk")


def kernel_ms(torch, fn, names, calls: int = 5) -> dict:
    """Each named kernel's device time per call of ``fn`` (ms, averaged over
    ``calls`` calls under torch.profiler, after one untimed call): how a
    function's time splits between its kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for name in names:
                if name in e.name:
                    out[name] += e.time_range.elapsed_us() / 1e3 / calls
    return out


def dev_err(a, b) -> tuple[float, float]:
    """(max |a - b|, that over max |b|), in float32 on the card: the
    gradient cases' outputs are too large to copy to the host."""
    diff = float((a.float() - b.float()).abs().max())
    return diff, diff / float(b.float().abs().max())


def moe_grad_cases(torch) -> list:
    """K5's gradient against ``gmm_ref_bwd`` (each output within GRAD_TOL of
    its max |g|), equal bits on two calls and through autograd, one launch
    of each kernel a call, dxe zero past rows[e] and dw zero for an expert
    with no row; timed beside the plain backward and the library yardstick,
    two ``torch.bmm`` on the full buffers. The bound counts the kept rows:
    2 x 2 rows d f flop, and the kept rows of xe and dy, the active experts'
    w, dxe and dw (every row written) in bytes."""
    from repro_torch.kernels import build
    from repro_torch.kernels import cost as kc
    from repro_torch.kernels import moe_gmm as gm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(27)
    rows_routed, c, _ = moe_routing(torch, gen, MOE_GRAD_TOKENS)
    e = MOE_EXPERTS
    ragged = torch.randint(1, c, (e,), generator=gen, device=dev, dtype=torch.int32)
    ragged[:8], ragged[8:16] = 0, c
    cases = []
    for label, rows, d, f in (("train gate/up", rows_routed, 2048, 768), ("train down", rows_routed, 768, 2048),
                              ("ragged 0 / C / between", ragged, 2048, 768)):
        t0 = time.perf_counter()
        keep = (torch.arange(c, device=dev)[None] < rows[:, None])[..., None]
        xe = torch.randn(e, c, d, generator=gen, device=dev).to(torch.bfloat16).masked_fill(~keep, 0)
        w = (torch.randn(e, d, f, generator=gen, device=dev) * d ** -0.5).to(torch.bfloat16)
        dy = torch.randn(e, c, f, generator=gen, device=dev).to(torch.bfloat16).masked_fill(~keep, 0)
        before = {n: build.launches(n) for n in MOE_GRAD_KERNELS}
        got = gm.backward(xe, w, rows, dy)
        torch.cuda.synchronize()
        check({n: build.launches(n) - before[n] for n in MOE_GRAD_KERNELS} == dict.fromkeys(MOE_GRAD_KERNELS, 1),
              f"K5 gradient {label}: not one launch of each kernel")
        want = gm.plain_bwd(xe, w, rows, dy)
        both = {n: dev_err(a, b) for n, a, b in zip(("dxe", "dw"), got, want)}
        errs = {n: v[1] for n, v in both.items()}
        abs_err = max(v[0] for v in both.values())
        check(all(bool(torch.isfinite(a.float()).all()) for a in got), f"K5 gradient {label}: non-finite output")
        check(max(errs.values()) <= GRAD_TOL, f"K5 gradient {label}: beyond {GRAD_TOL} of max |g|: {errs}")
        check(bool((got[0].masked_select(~keep) == 0).all()), f"K5 gradient {label}: dxe past rows[e] is not 0")
        empty = rows == 0
        check(not bool(got[1][empty].any()), f"K5 gradient {label}: dw of an expert with no row is not 0")
        check(all(torch.equal(a, b) for a, b in zip(got, gm.backward(xe, w, rows, dy))),
              f"K5 gradient {label}: two calls differ in bits")
        x = [xe.clone().requires_grad_(), w.clone().requires_grad_()]
        auto = torch.autograd.grad(gm.moe_gmm(x[0], x[1], rows), x, dy)
        check(all(torch.equal(a, b) for a, b in zip(got, auto)), f"K5 gradient {label}: autograd's differ in bits")
        del want, auto, x
        kept, active = int(rows.sum()), int((rows > 0).sum())
        flops, nbytes, _ = kc.moe_gmm_grad(e, c, d, f, rows=kept, active=active)
        b_ms, b_by = bound(flops, nbytes)
        ms = time_ms(torch, lambda: gm.backward(xe, w, rows, dy))
        cases.append({
            "shape": f"{label}: E={e} C={c} d={d} f={f} active={active} rows={kept} bf16",
            "max_abs_err": abs_err, "rel_err": errs, "ms": ms,
            "kernel_ms": kernel_ms(torch, lambda: gm.backward(xe, w, rows, dy),
                                   ("moe_gmm_bwd_dx_kernel", "moe_gmm_bwd_dw_kernel")),
            "plain_ms": time_ms(torch, lambda: gm.plain_bwd(xe, w, rows, dy), PLAIN_GRAD_SAMPLES, REPS),
            "library_ms": time_ms(torch, lambda: (torch.bmm(dy, w.transpose(1, 2)), torch.bmm(xe.transpose(1, 2), dy))),
            "library": "two torch.bmm on the full buffers (dy w^T, xe^T dy)",
            "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms, "tflops": flops / (ms * 1e-3) / 1e12,
            "seconds": time.perf_counter() - t0,
        })
        del xe, w, dy, got
    return cases


def ssd_grad_bound(b, t, h, g, p, n, with_state: bool = False) -> tuple[float, str]:
    """K6's gradient's least time (``kernels/cost.py: ssd_scan_grad``: the
    inputs read and the gradients written once, the backward's products
    over chunks of SSD_CHUNK rows; its state workspace is the kernel's own)."""
    from repro_torch.kernels import cost as kc

    c = kc.ssd_scan_grad(b, t, h, g, p, n, with_state)
    return bound(c.flops, c.bytes)


def ssd_plain_bwd_by_heads(torch, sd, ins, dy, ds, k: int):
    """K6's plain backward (``sd.plain_bwd``) over slices of ``k`` of each
    group's heads, its inputs cast to fp32 (so its outputs stay fp32); the
    per-head outputs put in place and the slices' dB and dC summed in
    slice order: the plain backward where its (B, T, T, H) tensors do not fit
    at once."""
    x, bm, cm, dt, a_log, d_skip = ins
    h, g = x.shape[2], bm.shape[2]
    hpg = h // g
    f32 = torch.float32
    dx, ddt = torch.empty(x.shape, dtype=f32, device=x.device), torch.empty(dt.shape, dtype=f32, device=x.device)
    da, dd = torch.empty(h, dtype=f32, device=x.device), torch.empty(h, dtype=f32, device=x.device)
    dbm, dcm = torch.zeros(bm.shape, dtype=f32, device=x.device), torch.zeros(cm.shape, dtype=f32, device=x.device)
    for j0 in range(0, hpg, k):
        idx = torch.tensor([gi * hpg + j for gi in range(g) for j in range(j0, min(j0 + k, hpg))], device=x.device)
        out = sd.plain_bwd(x[:, :, idx].float(), bm.float(), cm.float(), dt[:, :, idx].float(), a_log[idx].float(),
                           d_skip[idx].float(), dy[:, :, idx].float(), None if ds is None else ds[:, idx].float())
        dx[:, :, idx], ddt[:, :, idx], da[idx], dd[idx] = out[0], out[3], out[4], out[5]
        dbm += out[1]
        dcm += out[2]
        del out
    return dx, dbm, dcm, ddt, da, dd


def ssd_grad_cases(torch) -> list:
    """K6's gradient at SSD_GRAD_CASES on unit-scale inputs (ssd_kernel_cases'
    recipe, dy of std 1; dt and A_log as the case's scale says): each output
    (dx, dB, dC summed over a group's heads, ddt, dA_log, dD) within GRAD_TOL
    of its max |g| of ``ssd_ref_bwd`` (whole, or over slices of heads at the
    train shapes), equal bits on two calls and through autograd, one launch
    of each kernel a call; timed beside the whole plain backward where it
    runs (no single PyTorch call computes it: library "none")."""
    from repro_torch.kernels import build
    from repro_torch.kernels import ssd_scan as sd

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(28)
    cases = []
    for label, b, t, h, g, n, with_state, slice_heads, scale in SSD_GRAD_CASES:
        t0 = time.perf_counter()
        p = 64
        x = torch.randn(b, t, h, p, generator=gen, device=dev).to(torch.bfloat16)
        bm, cm = ((torch.randn(b, t, g, n, generator=gen, device=dev) * 0.5).to(torch.bfloat16) for _ in range(2))
        shift = 0.0 if scale == "model" else -4.0
        dt = torch.nn.functional.softplus(torch.randn(b, t, h, generator=gen, device=dev) + shift)
        a_log = torch.randn(h, generator=gen, device=dev) * 0.3 + (0.0 if scale == "model" else -2.0)
        d_skip = torch.ones(h, device=dev)
        dy = torch.randn(b, t, h, p, generator=gen, device=dev).to(torch.bfloat16)
        ds = torch.randn(b, h, p, n, generator=gen, device=dev) if with_state else None
        ins = (x, bm, cm, dt, a_log, d_skip)
        before = {k: build.launches(k) for k in SSD_GRAD_KERNELS}
        got = sd.backward(*ins, dy, ds)
        torch.cuda.synchronize()
        check({k: build.launches(k) - before[k] for k in SSD_GRAD_KERNELS} == dict.fromkeys(SSD_GRAD_KERNELS, 1),
              f"K6 gradient {label}: not one launch of each kernel")
        check(all(bool(torch.isfinite(a.float()).all()) for a in got), f"K6 gradient {label}: non-finite output")
        check(all(torch.equal(a, c) for a, c in zip(got, sd.backward(*ins, dy, ds))),
              f"K6 gradient {label}: two calls differ in bits")
        live = [v.clone().requires_grad_() for v in ins]
        y, state = sd.ssd_scan(*live, return_state=True)
        outs, cot = ((y, state), (dy, ds)) if with_state else ((y,), (dy,))
        auto = torch.autograd.grad(outs, live, cot)
        check(all(torch.equal(a, c) for a, c in zip(got, auto)), f"K6 gradient {label}: autograd's differ in bits")
        del live, y, state, auto
        plain_ms = None
        want = (sd.plain_bwd(*ins, dy, ds) if slice_heads is None
                else ssd_plain_bwd_by_heads(torch, sd, ins, dy, ds, slice_heads))
        names = ("dx", "dbm", "dcm", "ddt", "da_log", "dd_skip")
        both = {k: dev_err(a, w) for k, a, w in zip(names, got, want)}
        errs = {k: v[1] for k, v in both.items()}
        abs_err = max(v[0] for v in both.values())
        check(max(errs.values()) <= GRAD_TOL, f"K6 gradient {label}: beyond {GRAD_TOL} of max |g|: {errs}")
        del want
        torch.cuda.empty_cache()
        if slice_heads is None:
            plain_ms = time_ms(torch, lambda: sd.plain_bwd(*ins, dy, ds), PLAIN_GRAD_SAMPLES, PLAIN_GRAD_REPS)
            torch.cuda.empty_cache()
        b_ms, b_by = ssd_grad_bound(b, t, h, g, p, n, with_state)
        ms = time_ms(torch, lambda: sd.backward(*ins, dy, ds))
        nc = -(-t // SSD_CHUNK)
        states = 2 * 2 * b * h * nc * p * n  # S_c and Z_c in bf16, written once and read once
        splits = sd.grad_splits(b, nc, g, h // g, torch.cuda.get_device_properties(dev).multi_processor_count)
        cases.append({
            "shape": f"{label}: B={b} T={t} H={h} G={g} P={p} N={n} x/dy/B/C bf16, dt fp32"
                     f"{', dstate fp32' if with_state else ''}",
            "plain": "whole" if slice_heads is None else f"fp32, slices of {slice_heads} heads", "dt_scale": scale,
            "max_abs_err": abs_err, "rel_err": errs, "ms": ms, "plain_ms": plain_ms,
            "kernel_ms": kernel_ms(torch, lambda: sd.backward(*ins, dy, ds),
                                   ("ssd_bwd_walk_kernel", "ssd_bwd_chunk_kernel")),
            "library_ms": None, "library": "none", "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
            "splits": splits, "workspace_bytes": states,
            "workspace_floor_ms": bound(0, 2 * states)[0],
            "partials_bytes": 4 * splits * b * g * nc * 2 * SSD_CHUNK * n, "seconds": time.perf_counter() - t0,
        })
    return cases


def ptxas_report(report: str) -> dict:
    """Registers, spills and shared memory of each hand-written kernel's
    instantiations (``name<template ints>``), from the compiler's
    ``-Xptxas -v`` report of this run's build."""
    out, entry = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            args = ",".join(re.findall(r"Li(\d+)E", mangled))
            entry = next((f"{k}<{args}>" if args else k for k in PORT_KERNELS if k in mangled), None)
        elif entry and ("registers" in line or "spill" in line):
            out.setdefault(entry, []).append(line.split("ptxas info    :")[-1].strip())
    return out


# (label, B, T, H, G, P, N) of K6: each model's prompt of 300 tokens
# (mamba2-370m: 32 heads of 64 over a state of 128; zamba2-7b: 112 heads of 64
# over 64), one partial chunk, two full chunks of the configured 256, groups
SSD_CASES = (
    ("mamba2-370m T=300", 1, 300, 32, 1, 64, 128),
    ("zamba2-7b T=300", 1, 300, 112, 1, 64, 64),
    ("T=37", 1, 37, 32, 1, 64, 128),
    ("T=512", 1, 512, 112, 1, 64, 64),
    ("G=2", 2, 300, 8, 2, 64, 64),
)
SSD_CHUNK = 64  # the kernel's own chunk (csrc/ssd_scan.cu: kQ)


def ssd_bound(b, t, h, g, p, n) -> tuple[float, str]:
    """K6's least time (``kernels/cost.py: ssd_scan``: the inputs read, y
    and the final state written once, the dual form's products over chunks
    of SSD_CHUNK rows)."""
    from repro_torch.kernels import cost as kc

    c = kc.ssd_scan(b, t, h, g, p, n)
    return bound(c.flops, c.bytes)


def ssd_case(torch, label, x, bm, cm, dt, a_log, d_skip, captured: bool = False) -> dict:
    """K6 against its plain version on the same inputs, y and the final
    state, timed beside it (no single PyTorch call computes the SSD scan:
    library "none"). A captured case is held at 2e-2 of max |y| and of max
    |state| (its outputs reach ~1e6, where the two summation orders differ
    by more than the elementwise atol near 0); every other case elementwise
    at rtol = atol = 2e-2."""
    from repro_torch.kernels import ssd_scan as sd

    b, t, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    got, state = sd.ssd_scan(x, bm, cm, dt, a_log, d_skip, return_state=True)
    torch.cuda.synchronize()
    want, want_state = sd.plain(x, bm, cm, dt, a_log, d_skip)
    check(bool(torch.isfinite(got).all()) and bool(torch.isfinite(state).all()), f"ssd_scan {label}: non-finite output")
    rel, rel_state = rel_err(got, want), rel_err(state, want_state)
    if captured:
        check(rel <= RTOL, f"ssd_scan {label}: {rel} of max |y| from its plain version")
        check(rel_state <= RTOL, f"ssd_scan {label}: state {rel_state} of max |state| from its plain version")
        err = float((got.float() - want).abs().max())
        state_err = float((state - want_state).abs().max())
    else:
        err = max_err(torch, got, want)
        state_err = max_err(torch, state, want_state)
    again, again_state = sd.ssd_scan(x, bm, cm, dt, a_log, d_skip, return_state=True)
    check(torch.equal(got, again) and torch.equal(state, again_state), f"ssd_scan {label} is not deterministic")
    b_ms, b_by = ssd_bound(b, t, h, g, p, n)
    ms = time_ms(torch, lambda: sd.ssd_scan(x, bm, cm, dt, a_log, d_skip, return_state=True))
    return {
        "shape": f"{label}: B={b} T={t} H={h} G={g} P={p} N={n} x/B/C bf16, dt fp32",
        "max_abs_err": err,
        "state_max_abs_err": state_err,
        "rel_err_of_max": rel,
        "state_rel_err_of_max": rel_state,
        "max_abs_y": float(want.abs().max()),
        "ms": ms,
        "plain_ms": time_ms(torch, lambda: sd.plain(x, bm, cm, dt, a_log, d_skip)),
        "library_ms": None,
        "library": "none",
        "bound_ms": b_ms,
        "bound_by": b_by,
        "bound_share": b_ms / ms,
    }


def ssd_kernel_cases(torch, gen) -> list:
    """K6 at the SSM and hybrid serve paths' shapes on unit-scale inputs
    (tests/test_kernels.py's recipe: B, C of std 0.5, dt = softplus(N(0, 1)),
    A_log of std 0.3, D = 1)."""
    dev = torch.device("cuda")
    cases = []
    for label, b, t, h, g, p, n in SSD_CASES:
        x = torch.randn(b, t, h, p, generator=gen, device=dev).to(torch.bfloat16)
        bm = (torch.randn(b, t, g, n, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
        cm = (torch.randn(b, t, g, n, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
        dt = torch.nn.functional.softplus(torch.randn(b, t, h, generator=gen, device=dev))
        a_log = torch.randn(h, generator=gen, device=dev) * 0.3
        cases.append(ssd_case(torch, label, x, bm, cm, dt, a_log, torch.ones(h, device=dev)))
    return cases


# (C, d, f) of the MoE serve path's expert products, E = 128 (qwen3-moe-30b-a3b):
# gate/up and down at a decode step (C = 8), gate/up at a 300-token dense
# prefill (C = 24) and at a 512-row paged chunk (C = 40); every row kept
MOE_CASES = ((8, 2048, 768), (8, 768, 2048), (24, 2048, 768), (40, 2048, 768))
MOE_EXPERTS = 128
# (label, tokens routed, d, f) of the routed cases: rows from a top-8 routing
# of that many tokens through the MoE layer's own route() and capacity
MOE_ROUTED = (("decode gate/up", 1, 2048, 768), ("decode down", 1, 768, 2048),
              ("paged decode gate/up", 8, 2048, 768))
MOE_MAIN_CASE = len(MOE_CASES)  # the main path's shape: the routed decode gate/up


def moe_routing(torch, gen, tokens: int):
    """Each expert's kept rows (min(count, capacity)) and the capacity C for
    ``tokens`` tokens routed by qwen3-moe-30b-a3b's own ``route`` (a random
    fp32 router on random hidden states), as ``apply_moe`` computes them."""
    from repro_torch.configs import get_arch
    from repro_torch.models import moe

    dev = torch.device("cuda")
    cfg = get_arch("qwen3-moe-30b-a3b")
    router = torch.randn(cfg.d_model, cfg.num_experts, generator=gen, device=dev) * cfg.d_model ** -0.5
    x = torch.randn(1, tokens, cfg.d_model, generator=gen, device=dev).to(torch.bfloat16)
    _, e_flat, _, pos = moe.route({"router": router}, x, cfg)
    cap = moe.capacity(tokens, cfg)
    rows = torch.zeros(cfg.num_experts, dtype=torch.int32, device=dev).index_add_(0, e_flat, (pos < cap).int())
    return rows, cap, min(cfg.num_experts, tokens * cfg.num_experts_per_tok)


def moe_kernel_cases(torch, gen) -> list:
    """K5 at the MoE serve path's shapes against its plain version, timed
    beside it and beside the library yardstick ``torch.bmm`` on the same full
    buffers (the port never calls it). The dense cases keep every row of
    every expert; the routed cases take ``rows`` from a real top-8 routing
    (:func:`moe_routing`), zero xe's rows past them (as the layer's scatter
    leaves them) and check the outputs' skipped rows are exact zeros, equal
    bits on two launches, and equality with the kernel without ``rows`` on
    the same input. A routed call reads only its active experts' weights, so
    it is timed reading the next of ``copies`` copies of w each call, together
    at least COLD_BYTES of active weights (a decode step reads each layer's
    experts once, between the other layers' weights), and its bound counts
    the active experts' bytes; the dense bound is printed beside it."""
    from repro_torch.kernels import cost as kc
    from repro_torch.kernels import moe_gmm as gm

    dev = torch.device("cuda")
    e = MOE_EXPERTS
    cases = []
    routings = {}
    # the routed cases draw from a generator of their own, so that the dense
    # cases (and the cases after K5) draw the inputs they drew before
    gen_routed = torch.Generator(device=dev).manual_seed(5)
    for label, c, d, f, tokens in ([(f"dense C={c}", c, d, f, None) for c, d, f in MOE_CASES] +
                                   [(label, None, d, f, tokens) for label, tokens, d, f in MOE_ROUTED]):
        if tokens is None:
            rows, active = torch.full((e,), c, dtype=torch.int32, device=dev), e
        else:
            if tokens not in routings:
                routings[tokens] = moe_routing(torch, gen_routed, tokens)
            rows, c, active = routings[tokens]
        g_case = gen if tokens is None else gen_routed
        keep = torch.arange(c, device=dev)[None, :] < rows[:, None]  # (E, C)
        xe = torch.randn(e, c, d, generator=g_case, device=dev).to(torch.bfloat16).masked_fill(~keep[..., None], 0)
        w = (torch.randn(e, d, f, generator=g_case, device=dev) * d ** -0.5).to(torch.bfloat16)
        got = gm.moe_gmm(xe, w, rows, active)
        torch.cuda.synchronize()
        err = max_err(torch, got, gm.plain(xe, w, rows))
        check(bool((got.masked_select(~keep[..., None]) == 0).all()), f"moe_gmm {label}: a skipped row is not 0")
        check(torch.equal(got, gm.moe_gmm(xe, w, rows, active)), f"moe_gmm {label} is not deterministic")
        check(torch.equal(got, gm.moe_gmm(xe, w)), f"moe_gmm {label}: differs from the kernel without rows")
        n_active = int((rows > 0).sum())
        kept_rows = int(rows.sum())
        flops, nbytes, _ = kc.moe_gmm(e, c, d, f, rows=kept_rows, active=n_active)
        b_ms, b_by = bound(flops, nbytes)
        dense_ms, _ = bound(*kc.moe_gmm(e, c, d, f)[:2])
        copies = min(16, -(-COLD_BYTES // (2 * n_active * d * f)))
        ws = [w] + [w.clone() for _ in range(copies - 1)]
        ms = time_ms(torch, rotating(lambda i: gm.moe_gmm(xe, ws[i], rows, active), copies))
        cases.append({
            "shape": f"{label}: E={e} C={c} d={d} f={f} active={n_active} rows={kept_rows} bf16",
            "copies": copies,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": time_ms(torch, rotating(lambda i: gm.plain(xe, ws[i], rows), copies)),
            "library_ms": time_ms(torch, rotating(lambda i: torch.bmm(xe, ws[i]), copies)),
            "library": "torch.bmm on the full buffers",
            "bound_ms": b_ms,
            "bound_by": b_by,
            "bound_share": b_ms / ms,
            "dense_bound_ms": dense_ms,
            "achieved_gb_s": nbytes / ms / 1e6,
        })
        del ws, w
    return cases


def _paged_inputs(torch, gen, b, n, page, p, kv, hd):
    """Random bf16 pages and a block table of distinct live pages per
    sequence (page 0 is the arena's scratch page)."""
    dev = torch.device("cuda")
    kp = torch.randn(p, page, kv, hd, generator=gen, device=dev).to(torch.bfloat16)
    vp = torch.randn(p, page, kv, hd, generator=gen, device=dev).to(torch.bfloat16)
    perm = torch.randperm(p - 1, generator=gen, device=dev)[: b * n] + 1
    return kp, vp, perm.reshape(b, n).to(torch.int32).contiguous()


def paged_kernel_cases(torch, F, gen) -> dict:
    """K1 and K2 at the paged serve path's shapes (and an MQA one), each
    against its plain version, timed beside it and beside the library
    yardstick: ``scaled_dot_product_attention`` on the PRE-GATHERED
    contiguous cache (no single PyTorch call computes the paged function;
    the gather's own time is reported apart, as ``gather_ms``)."""
    from repro_torch.kernels import cost as kc
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import gather_pages

    dev = torch.device("cuda")
    # the cases added after the first three draw from a generator of their
    # own (chameleon-34b's from one more), so that every other case draws the
    # inputs it drew before
    gen_added = torch.Generator(device=dev).manual_seed(16)
    gen_chameleon = torch.Generator(device=dev).manual_seed(19)
    out = {}
    cases = []
    # (label, B, n, page, P, H, KV, hd, cur_len): the serve shape (capacity
    # 8, 32 pages of 16 per sequence, the arena of 321 pages), B = 1, MQA;
    # qwen3-moe-30b-a3b's paged shape (32/4 heads of 128); the groups of
    # starcoder2-3b (24/2 heads of 128: G * hd = 1536) and granite-34b (48/1:
    # 6144), wider than one head slice of the kernel (1024 outputs);
    # chameleon-34b's paged shape (64/8 heads of 128)
    for label, b, n, page, p, h, kv, hd, lens in (
        ("serve", 8, 32, 16, 321, 32, 8, 64, [0, 37, 129, 300, 406, 511, 150, 64]),
        ("B=1", 1, 32, 16, 321, 32, 8, 64, [406]),
        ("MQA", 4, 32, 16, 321, 16, 1, 64, [37, 128, 300, 500]),
        ("qwen3", 8, 32, 16, 321, 32, 4, 128, [0, 37, 129, 300, 406, 511, 150, 64]),
        ("G*hd=1536", 4, 32, 16, 321, 24, 2, 128, [0, 37, 300, 512]),
        ("G*hd=6144", 4, 32, 16, 321, 48, 1, 128, [1, 64, 300, 511]),
        ("chameleon", 8, 32, 16, 321, 64, 8, 128, [0, 37, 129, 300, 406, 511, 150, 64]),
    ):
        g_case = gen if label in ("serve", "B=1", "MQA") else gen_chameleon if label == "chameleon" else gen_added
        kp, vp, bt = _paged_inputs(torch, g_case, b, n, page, p, kv, hd)
        q = torch.randn(b, h, hd, generator=g_case, device=dev).to(torch.bfloat16)
        cur = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = pa.paged_decode_attention(q, kp, vp, bt, cur)
        torch.cuda.synchronize()
        err = max_err(torch, got, pa.plain_decode(q, kp, vp, bt, cur))
        check(torch.equal(got, pa.paged_decode_attention(q, kp, vp, bt, cur)),
              f"paged_decode_attention {label} is not deterministic")
        for i, n_valid in enumerate(lens):
            if n_valid == 0:
                check(bool((got[i] == 0).all()), "paged_decode_attention must give exact zeros at cur_len 0")
        g = h // kv
        kr = gather_pages(kp, bt).transpose(1, 2).repeat_interleave(g, dim=1)
        vr = gather_pages(vp, bt).transpose(1, 2).repeat_interleave(g, dim=1)
        mask = (torch.arange(n * page, device=dev)[None, :] < cur[:, None])[:, None, None, :]
        qt = q[:, :, None, :]
        b_ms, b_by = bound(*kc.paged_decode_attention(b, n, page, h, kv, hd, rows=sum(lens))[:2])
        cases.append({
            "shape": f"{label}: B={b} n={n} page={page} P={p} H={h} KV={kv} hd={hd} cur_len={lens} bf16",
            "max_abs_err": err,
            "ms": time_ms(torch, lambda: pa.paged_decode_attention(q, kp, vp, bt, cur)),
            "plain_ms": time_ms(torch, lambda: pa.plain_decode(q, kp, vp, bt, cur)),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kr, vr, attn_mask=mask)),
            "library": "scaled_dot_product_attention on the pre-gathered contiguous cache",
            "gather_ms": time_ms(torch, lambda: (gather_pages(kp, bt), gather_pages(vp, bt))),
            "bound_ms": b_ms,
            "bound_by": b_by,
        })
    out["paged_decode_attention"] = cases

    cases = []
    # qwen3-moe-30b-a3b's paged chunk (32/4 heads of 128) and granite-34b's
    # (48/1) each draw from a generator of their own, so that every other
    # case draws what it drew before
    gen_qwen3 = torch.Generator(device=dev).manual_seed(17)
    gen_granite = torch.Generator(device=dev).manual_seed(18)
    # (C, start, valid rows, H, KV, hd, generator): a 37-token prompt padded
    # to 64, a chunk from 192, a 300-token prompt padded to 512, a 5-row
    # chunk from 37 (llama3.2-1b, 32/8 heads of 64); qwen3's 512-row chunk;
    # granite-34b's (48/1 heads of 128)
    for c, start, valid, h, kv, hd, g_case in (
        (64, 0, 37, 32, 8, 64, gen), (64, 192, 64, 32, 8, 64, gen), (512, 0, 300, 32, 8, 64, gen),
        (5, 37, 5, 32, 8, 64, gen), (512, 0, 300, 32, 4, 128, gen_qwen3), (512, 0, 300, 48, 1, 128, gen_granite),
    ):
        n, page, p = 32, 16, 321
        kp, vp, bt = _paged_inputs(torch, g_case, 1, n, page, p, kv, hd)
        q = torch.randn(1, c, h, hd, generator=g_case, device=dev).to(torch.bfloat16)
        st = torch.tensor([start], dtype=torch.int32, device=dev)
        got = pa.paged_chunk_attention(q, kp, vp, bt, st)
        torch.cuda.synchronize()
        err = max_err(torch, got, pa.plain_chunk(q, kp, vp, bt, st))
        check(torch.equal(got, pa.paged_chunk_attention(q, kp, vp, bt, st)),
              f"paged_chunk_attention C={c} start={start} H={h}/{kv} is not deterministic")
        g = h // kv
        qt = q.transpose(1, 2)
        kr = gather_pages(kp, bt).transpose(1, 2).repeat_interleave(g, dim=1)
        vr = gather_pages(vp, bt).transpose(1, 2).repeat_interleave(g, dim=1)
        limit = start + torch.arange(c, device=dev)
        mask = (torch.arange(n * page, device=dev)[None, :] <= limit[:, None])[None, None]
        b_ms, b_by = bound(*kc.paged_chunk_attention(1, c, n, page, h, kv, hd, start=start)[:2])
        ms = time_ms(torch, lambda: pa.paged_chunk_attention(q, kp, vp, bt, st))
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kr, vr, attn_mask=mask))
        gather_ms = time_ms(torch, lambda: (gather_pages(kp, bt), gather_pages(vp, bt)))
        cases.append({
            "shape": f"B=1 C={c} start={start} valid={valid} n={n} page={page} P={p} H={h} KV={kv} hd={hd} bf16",
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": time_ms(torch, lambda: pa.plain_chunk(q, kp, vp, bt, st)),
            "library_ms": library_ms,
            "library": "scaled_dot_product_attention on the pre-gathered contiguous cache",
            "gather_ms": gather_ms,
            "vs_library": ms / library_ms,
            "vs_library_and_gather": ms / (library_ms + gather_ms),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "bound_share": b_ms / ms,
        })
    out["paged_chunk_attention"] = cases
    return out


# --------------------------------------------------------------- serve phase

PROMPT_LENS = (37, 128, 300)
NEW_TOKENS = 16
MAX_LEN = 512
# The fused platforms of the phases whose chain fuses on serial ``invoke``
# traffic (the dense and paged serve phases, the profile phases, the batched
# phase's warm-up, the cold-start phases). Such traffic gives the scheduler
# no tail (its p95 reads 0), and an edge's first sync wait there holds the
# callee's cold first run on the card, so the reference's default promotion
# (``promote_wait_s`` 50 ms) would merge edges at their first observation,
# before the leaf edge has been seen twice, and the measured merge costs then
# outgrow what the leaf edge's short waits save: the chain stops short
# (qwen3-moe-30b-a3b at 2 instances; llama3.2-1b's batched warm-up, once,
# its leaf edge's saving at the margin of the merge cost). Promotion is
# turned off here, beside load_bench's knobs.
SERVE_POLICY = {"min_observations": 2, "merge_cost_s": 0.0, "promote_wait_s": float("inf")}
TRACE_TOL = 1e-9  # |residual| of a conserved trace, seconds
OVERHEAD_MIN = 0.97  # tracing on / off requests/s of fused-batched (load_bench.py:1464-1478)


def pad_caches(torch, cache: dict, pad: int) -> dict:
    """A prefill's cache with its attention caches ((layers, B, S, KV, hd))
    grown by ``pad`` sequence slots; SSM states are not length-indexed."""
    if "attn" in cache:  # the hybrid
        return {**cache, "attn": pad_caches(torch, cache["attn"], pad)}
    if "k" in cache:
        return {n: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, pad)) for n, c in cache.items()}
    return cache


def direct_generate(torch, model, params, tokens, steps: int, max_len: int):
    """The model without the platform: prefill_fn + decode_fn in a loop."""
    t = tokens.shape[1]
    logits, cache = model.prefill_fn(params, {"tokens": tokens})
    cache = pad_caches(torch, cache, max_len - t)
    cur = torch.full((tokens.shape[0],), t, dtype=torch.int32, device=tokens.device)
    out = [torch.argmax(logits, -1)[:, None].to(torch.int32)]
    for _ in range(steps - 1):
        logits, cache = model.decode_fn(params, {"tokens": out[-1], "cur_len": cur}, cache)
        cur = cur + 1
        out.append(torch.argmax(logits, -1)[:, None].to(torch.int32))
    return torch.cat(out, dim=1)


def layers_below(cfg, engine) -> dict:
    """For each member of ``engine``'s chain, the attention, SSM and MoE
    layers that one invocation entering there applies (it runs the chain
    from that member down)."""
    names = engine.chain_names()
    if cfg.family == "hybrid":  # embed -> core -> head: the core holds every layer
        every = {"attn": cfg.num_layers // cfg.shared_attn_every, "ssm": cfg.num_layers, "moe": 0}
        none = {"attn": 0, "ssm": 0, "moe": 0}
        return {n: none if n == names[-1] else every for n in names}
    per = cfg.num_layers // len(engine.group_names)
    out = {}
    for i, n in enumerate(names):
        layers = per * sum(1 for m in names[i:] if m in engine.group_names)
        out[n] = {"attn": 0 if cfg.family == "ssm" else layers, "ssm": layers if cfg.family == "ssm" else 0,
                  "moe": layers if cfg.family == "moe" else 0}
    return out


def moe_layer_runs(cfg, engine, client_invocations: int, checked_members) -> int:
    """How many MoE layers a run applied: each client invocation runs the
    whole chain; each canary a merge's health check replayed runs the chain
    from its member down, twice (through the live path and the new unit)."""
    if cfg.family != "moe":
        return 0
    below = layers_below(cfg, engine)
    return client_invocations * cfg.num_layers + sum(2 * below[m]["moe"] for m in checked_members)


def expected_launches(cfg, engine, prefills: int, decodes: int, replays) -> dict:
    """The attention and SSD launches a run makes: K3 once per attention
    layer and K6 once per SSM layer of each prefill, K4 once per attention
    layer of each decode step (an SSM decode step is the recurrent form, no
    kernel); ``prefills`` and ``decodes`` client invocations run the whole
    chain, and each replayed canary ``(member, is_prefill, runs)`` runs it
    from its member down ``runs`` times (:func:`record_replays`). The
    enc-dec chain: K3 once per encoder layer of each prefill (non-causal),
    K4 twice per decoder layer of each prefill (its BOS step) and decode
    step (self and cross); a canary replayed at the entry runs both, one at
    the decoder (either form) K4 alone."""
    if cfg.family == "audio":
        enc, dec = cfg.num_layers, cfg.num_decoder_layers
        exp = {"flash_attention": prefills * enc, "decode_attention": (prefills + decodes) * 2 * dec, "ssd_scan": 0}
        for member, _, runs in replays:
            if member == engine.entry:
                exp["flash_attention"] += runs * enc
            exp["decode_attention"] += runs * 2 * dec
        return exp
    below = layers_below(cfg, engine)
    entry = below[engine.entry]
    exp = {"flash_attention": prefills * entry["attn"], "decode_attention": decodes * entry["attn"],
           "ssd_scan": prefills * entry["ssm"]}
    for member, is_prefill, runs in replays:
        layers = below[member]
        if is_prefill:
            exp["flash_attention"] += runs * layers["attn"]
            exp["ssd_scan"] += runs * layers["ssm"]
        else:
            exp["decode_attention"] += runs * layers["attn"]
    return exp


def prompt_rows(inputs):
    """A request's prompt rows: an enc-dec request's ``src_embeds`` (B, S,
    d), its token ids (B, T) or its ``embeds`` (B, T, d)."""
    for key in ("src_embeds", "tokens", "embeds"):
        if key in inputs:
            return inputs[key]
    raise KeyError(sorted(inputs))


def frontend_embeds(torch, params, tokens) -> dict:
    """A token prompt ((1, T) int32, on the host or the card) as a vlm
    request's ``embeds``: 0.02 x the table rows of its tokens, drawn like the
    launcher's 0.02 x N(0, 1) (the table is unit normal), so that repeated
    prompts and a shared prefix carry identical embeds rows."""
    table = params["embed"]["table"]
    rows = table[torch.as_tensor(tokens, device=table.device).long()]
    return {"embeds": (0.02 * rows.float()).to(torch.bfloat16)}


def record_replays(platform) -> list:
    """Record every canary the platform fetches to replay: its member,
    whether it was a prefill (T > 1) or a decode step, and how often the
    replay runs the chain from that member down — twice for a merge's
    health check (the live path and the new unit), once for a resurrect's
    (the restored instance, before it is routed; an unfused member's glue
    dispatches the members below it, whose own resurrects are recorded
    apart)."""
    replays = []
    fetch = platform.handler.canary
    resurrect = platform._resurrect_impl
    restoring = threading.local()  # the member whose resurrect fetches next

    def resurrect_impl(name, t0):
        restoring.name = name
        return resurrect(name, t0)

    def canary(name):
        args = fetch(name)
        runs = 2
        if getattr(restoring, "name", None) == name:
            restoring.name, runs = None, 1
        if args is not None:
            x = prompt_rows(args[0]) if isinstance(args[0], dict) else args[0]
            replays.append((name, x.shape[1] > 1, runs))
        return args

    platform.handler.canary = canary
    platform._resurrect_impl = resurrect_impl
    return replays


def footprints(platform) -> list:
    """Each live instance's counted footprint (``resident_bytes``), its eager
    compiled entries' recorded workspace and output bytes (the largest of
    each entry's sum is what is counted) and its graphs' shared pool (the
    graphs' static bytes are in ``graphs``)."""
    out = []
    for inst in platform.registry.live_instances():
        entries = inst.entry_bytes()
        out.append({"instance": inst.instance_id, "resident_bytes": inst.resident_bytes(),
                    "entries": len(entries), "workspace_bytes": [w for w, _ in entries],
                    "output_bytes": [o for _, o in entries], "graph_pool_bytes": inst.graph_pool_bytes()})
    return out


def graph_summary(platform, label: str) -> dict:
    """The live instances' compiled entries (``FunctionInstance.graph_stats``),
    checked: a decode entry (its first argument holds one token per
    sequence: (B, 1, ...)) that ran twice is captured, and at least one is
    replayed. A key seen once (a prompt length, a frozen prefix-hit step)
    stays eager: it is captured at its second run."""
    entries = [dict(g, instance=inst.instance_id) for inst in platform.registry.live_instances()
               for g in inst.graph_stats()]
    decode = [g for g in entries if g["bucket"] is None and len(g["arg_shape"]) >= 2 and g["arg_shape"][1] == 1]
    eager = [g for g in decode if g["runs"] >= 2 and not g["captured"]]
    check(not eager, f"{label}: decode entries that ran twice and were not captured: {eager}")
    check(any(g["replays"] for g in decode), f"{label}: no decode entry was replayed from a graph: {decode}")
    captured = [g for g in entries if g["captured"]]
    return {"entries": len(entries), "captured": len(captured),
            "decode_replays": sum(g["replays"] for g in decode),
            "captured_entries": [{k: g[k] for k in ("entry", "bucket", "arg_shape", "replays", "static_bytes",
                                                   "pool_bytes", "launches_per_replay")} for g in captured]}


def serve_phase(torch, dev, cfg, prompt_lens=PROMPT_LENS, new_tokens=NEW_TOKENS,
                max_len=MAX_LEN, params=None, dispatch_window: bool = False,
                backend: str = "tinytorch", tokens_out: list | None = None, embeds_len: int = 0) -> dict:
    """Drive the serving chain unfused and fused on ``dev`` (``params``:
    the model's weights, made from seed 0 when not given). On the card it
    also checks that the kernels, and never their plain versions, ran, each
    exactly as often as the run's prefills, decode steps and canary replays
    make it (:func:`expected_launches`; K5 three times per MoE layer
    applied); on the CPU the plain attention versions stand in. Every
    platform traces (:func:`serve_traces`); with ``dispatch_window`` each
    platform then serves the first prompt twice more and a third time with
    the dispatch tracer armed (:func:`dispatch_window`). ``backend``:
    ``tinytorch`` or ``orchestrated`` (:data:`BACKENDS`); on the
    orchestrated backend the live pods must be the live instances, every
    retired unit's pod thread must have exited, and every graph capture
    must have run on a pod's thread (:func:`pod_check`). ``tokens_out``
    (a list) receives each prompt's fused tokens. ``embeds_len``: one more
    prompt of that many ``embeds`` rows (:func:`frontend_embeds`), the vlm
    family's input, served after the token prompts."""
    from repro_torch.core import FusionPolicy
    from repro_torch.kernels import build, ops
    from repro_torch.models.model import build_model
    from repro_torch.obs import prometheus_text
    from repro_torch.serving.engine import ServingEngine

    model = build_model(cfg)
    t0 = time.perf_counter()
    if params is None:
        params = model.init(0, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(7)
    prompts = [{"tokens": torch.randint(0, cfg.vocab_size, (1, t), generator=gen, device=dev, dtype=torch.int32)}
               for t in prompt_lens]
    labels = [str(t) for t in prompt_lens]
    if embeds_len:
        toks = torch.randint(0, cfg.vocab_size, (1, embeds_len), generator=gen, device=dev, dtype=torch.int32)
        prompts.append(frontend_embeds(torch, params, toks))
        labels.append(f"embeds {embeds_len}")

    Backend = backend_class(backend)
    platforms = {
        "unfused": Backend(FusionPolicy(enabled=False)),
        "fused": Backend(FusionPolicy(**SERVE_POLICY)),
    }
    results = {}
    replays = {label: record_replays(p) for label, p in platforms.items()}
    pods = {label: watch_pods(p) for label, p in platforms.items()}
    captures = CaptureThreads()
    ops.reset_counts()
    try:
        engines = {label: ServingEngine(model, p, max_len=max_len, params=params, device=dev)
                   for label, p in platforms.items()}
        tokens = {label: [] for label in platforms}
        lats = {label: [] for label in platforms}
        for i, prompt in enumerate(prompts):
            # the two platforms take turns (fused first on even prompts), so
            # that neither is always the one that runs first
            for label in ("fused", "unfused") if i % 2 == 0 else ("unfused", "fused"):
                toks, lat = engines[label].generate(prompt, steps=new_tokens)
                if i == 0:
                    platforms[label].merger.wait_idle()
                else:  # the first request carries warm-up and, fused, the merges
                    lats[label].extend(lat)
                tokens[label].append(toks)
        for label, platform in platforms.items():
            platform.merger.wait_idle()  # no merge (and no canary replay) still in flight
            results[label] = {
                "tokens": tokens[label],
                "p50_token_ms": statistics.median(lats[label]) * 1e3,
                "tokens_per_s": len(lats[label]) / sum(lats[label]),
                "ram_bytes": platform.ram_bytes(),
                "footprints": footprints(platform),
                "live_instances": len(platform.registry.live_instances()),
                "merges": [(m.members, m.healthy) for m in platform.merger.merge_log],
                "replayed": [n for m in platform.merger.merge_log for n in m.checked_members],
                "graphs": graph_summary(platform, label) if dev.type == "cuda" else None,
            }
            check([n for n, _, runs in replays[label] if runs == 2] == results[label]["replayed"],
                  f"{label}: replayed canaries {replays[label]} against the merge log's {results[label]['replayed']}")
        counts, parts = ops.counts(), build.LAUNCHES.parts()
        dispatch = None
        if dispatch_window:
            dispatch = {label: serve_dispatch(torch, engines[label], prompts[0], new_tokens)
                        for label in platforms}
        traces = {label: serve_traces(p, label, len(engines[label].chain_names()), new_tokens)
                  for label, p in platforms.items()}
        traces["prometheus_lines"] = len(prometheus_text(platforms["fused"]).splitlines())
        pod_lines = {label: pod_check(p, pods[label], label, captures) for label, p in platforms.items()}
    finally:
        captures.close()
        for platform in platforms.values():
            platform.shutdown()

    chain = set(engines["fused"].chain_names())  # embed, g0..g{G-1}, head
    check(results["unfused"]["live_instances"] == len(chain),
          f"unfused chain should hold {len(chain)} instances, has {results['unfused']['live_instances']}")
    check(results["fused"]["live_instances"] == 1,
          f"fused chain should hold 1 instance, has {results['fused']['live_instances']}")
    check(any(ok and set(m) == chain for m, ok in results["fused"]["merges"]),
          "no healthy merge of the whole chain in merge_log")
    check(results["fused"]["ram_bytes"] < results["unfused"]["ram_bytes"],
          f"fused ram_bytes is not below unfused: {results['fused']['ram_bytes']} vs "
          f"{results['unfused']['ram_bytes']}; fused {results['fused']['footprints']}, "
          f"{results['fused']['graphs']}; unfused {results['unfused']['footprints']}, {results['unfused']['graphs']}")
    invocations = len(prompts) * new_tokens  # per platform: a prefill and new_tokens - 1 steps
    moe_runs = sum(moe_layer_runs(cfg, engines[label], invocations, results[label]["replayed"])
                   for label in platforms)
    expected = {"moe_gmm": 3 * moe_runs}
    for label in platforms:
        for k, n in expected_launches(cfg, engines[label], len(prompts), len(prompts) * (new_tokens - 1),
                                      replays[label]).items():
            expected[k] = expected.get(k, 0) + n
    for i, t in enumerate(labels):
        a, b = results["unfused"]["tokens"][i], results["fused"]["tokens"][i]
        check(a.shape == (1, new_tokens), f"prompt {t}: tokens of shape {tuple(a.shape)}")
        check(torch.equal(a, b), f"prompt {t}: greedy tokens differ fused vs unfused")
    for k, want in expected.items():
        if dev.type == "cuda":
            check(counts[k] == want, f"{k} launched {counts[k]} times, the run makes {want} ({counts})")
        elif k in STAND_INS:
            check(counts[STAND_INS[k]] == want, f"{STAND_INS[k]} ran {counts[STAND_INS[k]]} times for {want}")
    if dev.type == "cuda":
        check(all(counts[k] == 0 for k in PLAIN), f"the main path called a plain version on the card: {counts}")

    if tokens_out is not None:
        tokens_out.extend(results["fused"]["tokens"])
    # the chain computes what the model computes without the platform
    ref = direct_generate(torch, model, params, prompts[0]["tokens"], new_tokens, max_len)
    check(torch.equal(ref, results["unfused"]["tokens"][0]),
          "chain tokens differ from the model run without the platform")

    prefills = 2 * len(prompts)  # client requests; the merges' canary replays come on top
    decode_steps = prefills * (new_tokens - 1)
    return {
        "backend": Backend.backend_name,
        "pods": pod_lines if backend == "orchestrated" else None,
        "arch": cfg.name,
        "layers": cfg.num_layers,
        "d_model": cfg.d_model,
        "params_init_s": init_s,
        "prompts": list(prompt_lens),
        "embeds_prompt": embeds_len or None,
        "new_tokens": new_tokens,
        "max_len": max_len,
        "p50_token_ms": {k: r["p50_token_ms"] for k, r in results.items()},
        "tokens_per_s": {k: r["tokens_per_s"] for k, r in results.items()},
        "ram_bytes": {k: r["ram_bytes"] for k, r in results.items()},
        "footprints": {k: r["footprints"] for k, r in results.items()},
        "live_instances": {k: r["live_instances"] for k, r in results.items()},
        "tokens_identical": True,
        "launches": {k: counts[k] for k in ("flash_attention", "decode_attention", "moe_gmm", "ssd_scan")},
        "launch_parts": {part: {k: n[k] for k in ("flash_attention", "decode_attention", "moe_gmm", "ssd_scan")}
                         for part, n in parts.items()},
        "expected_launches": expected,
        "graphs": {k: r["graphs"] for k, r in results.items()},
        "p50_fused_over_unfused": results["fused"]["p50_token_ms"] / results["unfused"]["p50_token_ms"],
        "plain_calls": {k: counts[k] for k in PLAIN},
        "moe_layers_applied": moe_runs,
        "canary_replays": {label: len(r["replayed"]) for label, r in results.items()},
        "prefill_replays": {label: sum(p for _, p, _ in replays[label]) for label in platforms},
        "prefills": prefills,
        "decode_steps": decode_steps,
        "launches_per_request": {
            "flash_attention_per_prefill": counts["flash_attention"] / prefills,
            "decode_attention_per_decode_step": counts["decode_attention"] / decode_steps,
            "ssd_scan_per_prefill": counts["ssd_scan"] / prefills,
        },
        "first_tokens": results["fused"]["tokens"][0][0, :8].tolist(),
        "distinct_tokens": len(set(torch.cat(results["fused"]["tokens"], dim=1).flatten().tolist())),
        "trace": traces,
        "dispatch": dispatch,
    }


def serve_traces(platform, label: str, chain_len: int, new_tokens: int) -> dict:
    """The serve phase's traces on one platform, checked: the recorder
    dropped nothing and every finished trace conserves (|residual| <=
    TRACE_TOL); every unfused ``invoke`` trace holds the chain's
    ``chain_len - 1`` cross-function-sync spans, every fused one that began
    after the last healthy merge none; the control timeline holds the
    fused-inline events of the fused unit's programs and one merge span per
    healthy merge, its seconds its ``MergeEvent.build_s``. Returns the
    counts and the decode steps' phase shares (``execute``,
    ``cross-function-sync``, ``unattributed``; a generate is a prefill and
    ``new_tokens - 1`` decode steps)."""
    from repro_torch.obs import CONTROL_TRACE_ID, attribute, build_trees, summarize

    recorder = platform.tracer.recorder
    records = recorder.snapshot()
    check(recorder.dropped() == 0, f"{label}: the flight recorder dropped {recorder.dropped()} records")
    results = attribute(records)
    bad = [r for r in results if not r["conserved"] or abs(r["residual_s"]) > TRACE_TOL]
    check(not bad, f"{label}: {len(bad)} traces do not conserve: {bad[:2]}")
    trees = build_trees(records)
    invokes = [r for r in results if r["kind"] == "invoke"]
    merges = [m for m in platform.merger.merge_log if m.healthy]
    after = merges[-1].t_completed if merges else float("inf")
    hops = [sum(1 for s in trees[r["trace_id"]].values() if s.cat == "cross-function-sync") for r in invokes]
    fused_after = [h for r, h in zip(invokes, hops) if trees[r["trace_id"]][1].t0 > after]
    if label == "unfused":
        check(set(hops) == {chain_len - 1}, f"unfused traces hold {set(hops)} sync spans, not {chain_len - 1}")
    else:
        check(fused_after and set(fused_after) == {0},
              f"fused traces after the merge hold {set(fused_after)} sync spans ({len(fused_after)} traces)")
    control = [r for r in records if r.trace_id == CONTROL_TRACE_ID]
    spans = [r for r in control if r.ph == "X" and r.name.startswith("merge:")]
    inline = sum(1 for r in control if r.name.startswith("fused-inline:"))
    check(len(spans) == len(merges), f"{label}: {len(spans)} merge spans for {len(merges)} healthy merges")
    check(all(r.args["seconds"] == m.build_s and abs(r.dur_s - m.build_s) <= TRACE_TOL
              for r, m in zip(spans, merges)), f"{label}: merge spans differ from build_s")
    check(label == "unfused" or inline > 0, f"{label}: no fused-inline event on the control timeline")
    steps = [r for i, r in enumerate(invokes) if i % new_tokens
             and (label == "unfused" or trees[r["trace_id"]][1].t0 > after)]
    shares = summarize(steps)["phase_share"]
    return {"traces": len(results), "invokes": len(invokes), "conserved": True,
            "max_abs_residual_s": max((abs(r["residual_s"]) for r in results), default=0.0),
            "sync_spans_per_invoke": sorted(set(hops)), "fused_invokes_after_merge": len(fused_after),
            "merge_spans_s": [r.args["seconds"] for r in spans], "fused_inline_events": inline,
            "decode_steps": len(steps),
            "decode_phase_share": {k: shares.get(k, 0.0) for k in ("execute", "cross-function-sync",
                                                                    "unattributed")}}


def dispatch_window(torch, run, requests: int, capacity: int) -> dict:
    """``run()`` with the dispatch tracer armed, checked as the reference's
    serve gate (load_bench.py:1194-1208): no new program (compiled entry,
    graph capture or batched bucket), and host syncs within one batched
    fetch per decode step plus seating and finishing per request plus the
    batch's capacity. ``cuda_syncs`` counts every synchronizing CUDA call
    (``torch.cuda.set_sync_debug_mode``), the syncs that end each execution
    included; reported beside the budget."""
    from repro_torch.analysis.dispatch import TRACER

    base = TRACER.snapshot()
    TRACER.arm()
    try:
        run()
    finally:
        TRACER.disarm()
    d = TRACER.delta(base)
    budget = d.decode_steps + 2 * requests + capacity
    check(d.decode_steps > 0, "dispatch: the window took no decode step")
    check(d.compiles == 0, f"dispatch: the steady state made new programs: {d}")
    check(d.host_syncs <= budget, f"dispatch: {d.host_syncs} host syncs over the budget {budget}: {d}")
    return {"decode_steps": d.decode_steps, "requests": requests, "capacity": capacity,
            "host_syncs": d.host_syncs, "budget": budget, "entries": d.entries, "captures": d.captures,
            "buckets": d.buckets, "cuda_syncs": d.cuda_syncs, "eager_kernel_calls": d.kernel_calls}


def serve_dispatch(torch, engine, prompt: dict, new_tokens: int) -> dict:
    """The serve phase's steady state: the prompt served twice more (every
    entry of the window has then run twice: its graph is captured), then a
    third time with the dispatch tracer armed."""
    for _ in range(2):
        engine.generate(prompt, steps=new_tokens)
    return dispatch_window(torch, lambda: engine.generate(prompt, steps=new_tokens), 1, 1)


# ---------------------------------------------------------- paged serve phase

PAGED_REQUESTS = 24
PAGED_STEPS = 24  # load_bench's --steps: generation lengths 18-30
PAGE = 16
CAPACITY = 8
SHARED_PREFIX = 128


def paged_requests(cfg, prompt_lens=PROMPT_LENS, n_requests=PAGED_REQUESTS, steps=PAGED_STEPS,
                   prefix_len=SHARED_PREFIX, seed=0):
    """The paged serve phase's requests, made on the host from ``seed``:
    prompts of ``prompt_lens`` in turn; request 3 repeats request 0 and
    request 4 repeats request 1 (whole-prompt hits: the frozen K1 step, and
    copy-on-write of a shared partial tail page); the (up to 8) prompts
    longer than the prefix begin with one shared ``prefix_len``-token
    prefix (shared pages, K2 from ``start > 0``). Generation lengths follow
    load_bench's formula (``run_serve``)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, cfg.vocab_size, prefix_len)
    prompts, shared = [], 0
    for i in range(n_requests):
        t = prompt_lens[i % len(prompt_lens)]
        if i in (3, 4):
            p = prompts[i - 3][0]
        elif t > prefix_len and shared < 8:
            p = np.concatenate([prefix, rng.integers(0, cfg.vocab_size, t - prefix_len)])
            shared += 1
        else:
            p = rng.integers(0, cfg.vocab_size, t)
        prompts.append(np.asarray(p, np.int32)[None, :])
    gens = [max(6, steps + ((i * 7) % 13) - 6) for i in range(n_requests)]
    return prompts, gens


def serve_paged(torch, engine, prompts, gens, capacity, warm_prompts) -> dict:
    """One run of the continuous batcher over ``engine``'s arena: warm-up
    (one request per prompt shape and one whole-prompt repeat), then the
    measured requests, all submitted at once (``prompts`` and
    ``warm_prompts``: the requests' input dicts). The kernel counts are set to
    0 just before the measured requests and read just after them."""
    from repro_torch.kernels import build, ops
    from repro_torch.scheduler.metrics import percentiles_ms
    from repro_torch.serving.continuous import ContinuousBatcher

    arena, platform = engine.arena, engine.platform
    cb = ContinuousBatcher(engine, capacity=capacity)
    try:
        for f in [cb.submit(w, 3) for w in warm_prompts]:
            f.result(timeout=600)
        cb.submit(warm_prompts[0], 3).result(timeout=600)
        platform.meter.reset()
        cb.reset_stats()
        hits0, cow0 = arena.shared_hits, arena.cow_copies
        if engine.device.type == "cuda":
            torch.cuda.synchronize()
        ops.reset_counts()
        t0 = time.perf_counter()
        futs = [cb.submit(p, g) for p, g in zip(prompts, gens)]
        results = [f.result(timeout=600) for f in futs]
        elapsed = time.perf_counter() - t0
        counts, parts = ops.counts(), build.LAUNCHES.parts()
        stats = cb.stats()
    finally:
        cb.shutdown()
    traces = conserved_traces(platform, "paged")
    for r, g in zip(results, gens):
        check(r["tokens"].shape == (1, g), f"a request returned {r['tokens'].shape[1]} of {g} tokens")
    arena.check_consistency()
    check(arena.used_pages() == 0, f"{arena.used_pages()} pages still held after the run")
    itl = [x for r in results for x in r["step_s"]]
    pct = percentiles_ms(itl, points=(50, 95))
    bill = platform.meter.arena_summary()
    n_tokens = sum(r["tokens"].shape[1] for r in results)
    return {
        "tokens": [r["tokens"] for r in results],
        "tokens_per_s": n_tokens / elapsed,
        "elapsed_s": elapsed,
        "itl_p50_ms": pct["p50_ms"],
        "itl_p95_ms": pct["p95_ms"],
        "mean_occupancy": stats["mean_occupancy"],
        "decode_steps": stats["steps"],
        "prefill_chunks": stats["prefill_chunks"],
        "mean_pages_per_request": bill["mean_pages"],
        "mean_billed_pages_per_request": bill["mean_billed_pages"],
        "arena_gb_s": bill["gb_s"],
        "shared_hits": arena.shared_hits - hits0,
        "cow_copies": arena.cow_copies - cow0,
        "live_instances": len(platform.registry.live_instances()),
        "ram_bytes": platform.ram_bytes(),
        "footprints": footprints(platform),
        "counts": counts,
        "launch_parts": parts,
        "graphs": graph_summary(platform, "paged") if engine.device.type == "cuda" else None,
        "traces": traces,
    }


def conserved_traces(platform, label: str) -> dict:
    """Every finished trace of the platform conserves (the batcher's
    ``serve`` traces through chunked prefill and copy-on-write included) and
    the recorder dropped nothing; returns the traces by kind."""
    from repro_torch.obs import attribute

    recorder = platform.tracer.recorder
    check(recorder.dropped() == 0, f"{label}: the flight recorder dropped {recorder.dropped()} records")
    results = attribute(recorder.snapshot())
    bad = [r for r in results if not r["conserved"] or abs(r["residual_s"]) > TRACE_TOL]
    check(not bad, f"{label}: {len(bad)} traces do not conserve: {bad[:2]}")
    kinds: dict[str, int] = {}
    for r in results:
        kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
    return kinds


def paged_dispatch(torch, engine, prompts, gens, capacity: int) -> dict:
    """The paged serve path's steady state: the measured requests served
    once more by a new batcher (every entry of the window has then run
    twice: its graph is captured), then again with the dispatch tracer
    armed."""
    from repro_torch.serving.continuous import ContinuousBatcher

    cb = ContinuousBatcher(engine, capacity=capacity)

    def serve():
        for f in [cb.submit(p, g) for p, g in zip(prompts, gens)]:
            f.result(timeout=600)

    try:
        serve()
        return dispatch_window(torch, serve, len(prompts), capacity)
    finally:
        cb.shutdown()


def paged_block_check(torch, engine, lens, seed=3) -> list:
    """One batched paged decode step against the dense decode step from the
    same prompt state, block by block on the same input: each prompt's
    dense prefill cache is both kept (K4's side) and scattered into the
    arena (K1's side). Returns each block's contribution's difference over
    its max."""
    import numpy as np

    from repro_torch import tree
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import embed_tokens

    cfg, arena, dev = engine.cfg, engine.arena, engine.device
    rng = np.random.default_rng(seed)
    kind = tfm.layer_kind(cfg)
    per = cfg.num_layers // len(engine.group_names)
    dense, sids, first = [], [], []
    for i, t in enumerate(lens):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, t)).astype(np.int32)).to(dev)
        logits, caches, _ = engine.prefill({"tokens": toks})
        sid = ("block-check", i)
        arena.alloc(sid, t)
        arena.write_prefill(sid, caches, t)
        arena.extend(sid, t + 1)
        dense.append(caches)
        sids.append(sid)
        first.append(torch.argmax(logits, -1).to(torch.int32))
    errs = []
    try:
        with torch.no_grad():
            bt = torch.from_numpy(np.stack([arena.block_row(s, engine.block_width) for s in sids])).to(dev)
            cur = torch.tensor(lens, dtype=torch.int32, device=dev)
            x = embed_tokens(engine.params["embed"], torch.stack(first))  # (B, 1, d)
            for layer in range(cfg.num_layers):
                lp = tree.map(lambda a: a[layer], engine.params["blocks"])
                stage, j = f"g{layer // per}", layer % per
                cache = {kv: torch.cat([c[stage][kv][j] for c in dense]) for kv in ("k", "v")}
                y_dense, _ = tfm.apply_block_decode(lp, x, cache, cfg, kind, cur)
                pages = arena.data[stage]
                y_paged, _, _ = tfm.apply_block_decode_paged(lp, x, pages["k"][j], pages["v"][j], bt, cfg,
                                                             kind, cur)
                errs.append(rel_err(y_paged - x, y_dense - x))
                x = y_dense
    finally:
        for sid in sids:
            arena.free(sid)
    return errs


def paged_serve_phase(torch, dev, cfg, prompt_lens=PROMPT_LENS, n_requests=PAGED_REQUESTS,
                      steps=PAGED_STEPS, max_len=MAX_LEN, page=PAGE, capacity=CAPACITY,
                      prefix_len=SHARED_PREFIX, small_cfg=None, params=None,
                      dispatch: bool = False, embeds: bool = False) -> dict:
    """The paged continuous-batching serve path: ``ServingEngine(...,
    kv_pages=(capacity + 2) * max_len / page + 1)`` (load_bench's arena
    size) and ``ContinuousBatcher(engine, capacity)`` with the default chunk
    budget, fused (the chain fused on dense traffic first, as load_bench's
    ``run_serve`` warms it) and then unfused, with the same requests. On
    the card it also checks that K1 and K2, and never a plain version, ran.
    Then one batched paged decode step against the dense one, block by
    block, and a small model (``small_cfg``) served by the batcher against
    per-request generate. ``params``: the model's weights, made from seed 0
    when not given. With ``dispatch``, the fused run ends with the dispatch
    tracer armed over its steady state (:func:`paged_dispatch`). With
    ``embeds`` (the vlm family) every request, the warm-up and the small
    model's included, is the ``embeds`` of its token prompt
    (:func:`frontend_embeds`): the batcher admits it through the serialized
    dense prefill (K3), raw embeds have no content hash, so no page is
    shared and none copied on write, and K2 never runs."""
    import numpy as np

    from repro_torch.core import FusionPolicy, TinyTorchBackend
    from repro_torch.models.model import build_model
    from repro_torch.serving.continuous import ContinuousBatcher
    from repro_torch.serving.engine import ServingEngine

    model = build_model(cfg)
    if params is None:
        params = model.init(0, device=dev)
    prompts, gens = paged_requests(cfg, prompt_lens, n_requests, steps, prefix_len)
    warm_rng = np.random.default_rng(1)
    warm = [warm_rng.integers(0, cfg.vocab_size, (1, t)).astype(np.int32) for t in prompt_lens]
    kv_pages = (capacity + 2) * (max_len // page) + 1
    if embeds:
        requests = [frontend_embeds(torch, params, p) for p in prompts]
        warm_in = [frontend_embeds(torch, params, w) for w in warm]
        dense_warm = warm_in[0]
    else:
        requests = [{"tokens": p} for p in prompts]
        warm_in = [{"tokens": w} for w in warm]
        dense_warm = {"tokens": torch.from_numpy(warm[0]).to(dev)}
    runs, block_errs = {}, None
    for label, policy in (("fused", FusionPolicy(**SERVE_POLICY)),
                          ("unfused", FusionPolicy(enabled=False))):
        platform = TinyTorchBackend(policy)
        try:
            engine = ServingEngine(model, platform, max_len=max_len, params=params, device=dev,
                                   kv_pages=kv_pages, kv_page_size=page)
            # dense traffic first: the fusing platform merges the chain here
            engine.generate(dense_warm, steps=6)
            platform.merger.wait_idle()
            run = serve_paged(torch, engine, requests, gens, capacity, warm_in)
            run["merges"] = [(m.members, m.healthy) for m in platform.merger.merge_log]
            run["chain"] = set(engine.chain_names())
            runs[label] = run
            if label == "fused" and dispatch:
                run["dispatch"] = paged_dispatch(torch, engine, requests, gens, capacity)
            if label == "fused":
                block_errs = paged_block_check(torch, engine, [t + 5 * i for i, t in
                                                                enumerate(prompt_lens * 3)][:capacity])
        finally:
            platform.shutdown()

    fused, unfused = runs["fused"], runs["unfused"]
    check(unfused["live_instances"] == len(unfused["chain"]),
          f"unfused chain should hold {len(unfused['chain'])} instances, has {unfused['live_instances']}")
    check(fused["live_instances"] == 1, f"fused chain should hold 1 instance, has {fused['live_instances']}")
    check(any(ok and set(m) == fused["chain"] for m, ok in fused["merges"]),
          "no healthy merge of the whole chain in merge_log")
    check(fused["ram_bytes"] < unfused["ram_bytes"],
          f"paged: fused ram_bytes is not below unfused: {fused['ram_bytes']} vs {unfused['ram_bytes']}; "
          f"fused {fused['footprints']}, {fused['graphs']}; unfused {unfused['footprints']}, {unfused['graphs']}")
    if embeds:
        check(all(r["shared_hits"] == 0 and r["cow_copies"] == 0 for r in runs.values()),
              f"embeds requests shared pages: {[(r['shared_hits'], r['cow_copies']) for r in runs.values()]}")
    else:
        check(fused["shared_hits"] > 0, "no request hit the shared-prefix cache")
    check(max(block_errs) <= BLOCK_TOL,
          f"a block's paged decode step differs from its dense one beyond {BLOCK_TOL}: {block_errs}")
    prefill = "flash_attention" if embeds else "paged_chunk_attention"
    kernels = ("paged_decode_attention", prefill) + (("moe_gmm",) if cfg.family == "moe" else ())
    if dev.type == "cuda":
        for label, run in runs.items():
            c = run["counts"]
            check(all(c[k] > 0 for k in kernels), f"{label}: the paged serve path did not launch {kernels}: {c}")
            check(all(c[k] == 0 for k in PLAIN), f"{label}: a plain version ran on the card: {c}")
            check(not embeds or c["paged_chunk_attention"] == 0, f"{label}: an embeds prompt ran K2: {c}")

    # a small model served by the batcher gives per-request generate's tokens
    small = build_model(small_cfg or cfg)
    rng = np.random.default_rng(2)
    small_prompts = [rng.integers(0, small.cfg.vocab_size, (1, t)).astype(np.int32) for t in (9, 23, 40)]
    platform = TinyTorchBackend(FusionPolicy(min_observations=2, merge_cost_s=0.0))
    try:
        engine = ServingEngine(small, platform, max_len=64, device=dev, kv_pages=25, kv_page_size=16)
        small_in = [frontend_embeds(torch, engine.params, p) if embeds else {"tokens": torch.from_numpy(p).to(dev)}
                    for p in small_prompts]
        refs = [engine.generate(p, steps=8)[0].cpu().numpy() for p in small_in]
        cb = ContinuousBatcher(engine, capacity=4)
        try:
            got = [f.result(timeout=600)["tokens"] for f in [cb.submit(p, 8) for p in small_in]]
        finally:
            cb.shutdown()
    finally:
        platform.shutdown()
    for t, (a, b) in zip((9, 23, 40), zip(got, refs)):
        check(np.array_equal(a, b), f"small model, prompt {t}: batcher tokens {a} != generate {b}")

    agree = [bool(np.array_equal(a, b)) for a, b in zip(fused["tokens"], unfused["tokens"])]
    check(all(agree), f"fused and unfused tokens differ in {agree.count(False)} of {len(agree)} requests")
    keys = ("tokens_per_s", "itl_p50_ms", "itl_p95_ms", "mean_occupancy", "decode_steps",
            "prefill_chunks", "mean_pages_per_request", "mean_billed_pages_per_request",
            "arena_gb_s", "shared_hits", "cow_copies", "live_instances", "ram_bytes", "footprints", "elapsed_s",
            "graphs", "traces")
    return {
        "arch": cfg.name,
        "layers": cfg.num_layers,
        "d_model": cfg.d_model,
        "requests": n_requests,
        "embeds": embeds,
        "prompt_lens": list(prompt_lens),
        "gen_lens": gens,
        "capacity": capacity,
        "max_len": max_len,
        "page": page,
        "kv_pages": kv_pages,
        **{k: {label: run[k] for label, run in runs.items()} for k in keys},
        "launches": {label: {k: run["counts"][k] for k in kernels} for label, run in runs.items()},
        "launch_parts": {label: {part: {k: n[k] for k in kernels} for part, n in run["launch_parts"].items()}
                         for label, run in runs.items()},
        "plain_calls": {label: {k: run["counts"][k] for k in PLAIN} for label, run in runs.items()},
        "block_rel_err": block_errs,
        "small_model_tokens_identical": True,
        "fused_vs_unfused_identical_requests": sum(agree),
        "dispatch": fused.get("dispatch"),
    }


# ------------------------------------------------------------- batched phase

BATCH_CLIENTS = 8  # load_bench's closed loop (benchmarks/load_bench.py:1497-1504)
BATCH_PROMPT = 8
BATCH_WARMUP = 8
BATCH_STEPS = 48
BATCH_MAX = 8
BATCH_DELAY_MS = 2.0
# The overhead gate's rounds (on, off, off, on, ...) and steps per client
# and round: enough to resolve the gate's 3 %. A round's requests/s spreads
# widely on the card's host (the client threads share its cores); 8 rounds
# of 24 steps read 1.005 in one run of the same tree and 0.933 and 0.949 in
# the next.
GATE_ROUNDS = 32
GATE_STEPS = 48
GATE_WARMUP = 4  # untimed steps per client opening each round, as load_bench's closed loop has
LANE_TOL = 2e-2  # a lane's logits and caches vs the same request's invoke, over max |value|


def closed_loop(torch, engine, clients, batched: bool, warmup: int, steps: int) -> dict:
    """load_bench's closed loop: one thread per client, each taking
    ``warmup`` then ``steps`` decode steps (``decode_step_async`` and the
    future's result when ``batched``, else ``decode_step``) with a constant
    fed token; returns requests/s and the timed steps' percentiles."""
    import threading

    from repro_torch.scheduler.metrics import percentiles_ms

    lats = [[] for _ in clients]

    def drive(i: int, n: int, barrier, timed: bool) -> None:
        c = clients[i]
        barrier.wait()
        for _ in range(n):
            t0 = time.perf_counter()
            if batched:
                _, c["caches"] = engine.decode_step_async(c["token"], c["cur_len"], c["caches"]).result()
            else:
                _, c["caches"] = engine.decode_step(c["token"], c["cur_len"], c["caches"])
            if timed:
                lats[i].append(time.perf_counter() - t0)
            c["cur_len"] = c["cur_len"] + 1

    elapsed = 0.0
    for n, timed in ((warmup, False), (steps, True)):
        barrier = threading.Barrier(len(clients))
        threads = [threading.Thread(target=drive, args=(i, n, barrier, timed)) for i in range(len(clients))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        elapsed = time.perf_counter() - t0
    flat = [x for lat in lats for x in lat]
    check(len(flat) == steps * len(clients), f"{len(flat)} timed steps of {steps * len(clients)}")
    return {"requests": len(flat), "elapsed_s": elapsed, "requests_per_s": len(flat) / elapsed,
            **percentiles_ms(flat)}


def batched_phase(torch, dev, cfg, clients=BATCH_CLIENTS, prompt_len=BATCH_PROMPT, warmup=BATCH_WARMUP,
                  steps=BATCH_STEPS, max_len=MAX_LEN, params=None, backend: str = "tinytorch",
                  overhead: bool = True) -> dict:
    """The main path's two modes on one fused platform (``max_batch`` 8,
    ``max_delay_ms`` 2): ``clients`` closed-loop clients, each prefilled
    once with a random prompt and its own max_len caches, feeding a constant
    token; first ``fused-serial`` (``invoke``), then ``fused-batched``
    (``invoke_async`` -> the scheduler -> one vmapped program per
    power-of-two bucket, captured at its second run). Checks: batches of 2
    or more formed, the decode entry never fell back to per-request
    execution, K4 launched exactly once per layer of each program run, K4
    at the lanes' own caches under vmap equal in bits to K4 per lane, and
    each lane of a batched step that the captured bucket programs served
    against the same request's ``invoke`` (:func:`lane_check`). ``backend``
    as :func:`serve_phase`'s; ``overhead``: run the tracing-overhead gate."""
    from repro_torch.core import FusionPolicy
    from repro_torch.core.function import _capture_device
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import decode_attention as k4
    from repro_torch.models.model import build_model
    from repro_torch.obs import prometheus_text
    from repro_torch.serving.engine import ServingEngine, _greedy_token

    model = build_model(cfg)
    if params is None:
        params = model.init(0, device=dev)
    captures = _capture_device(params) is not None  # the card captures; the CPU runs every program eagerly
    gen = torch.Generator(device=dev).manual_seed(13)
    platform = backend_class(backend)(FusionPolicy(**SERVE_POLICY), max_batch=BATCH_MAX,
                                      max_delay_ms=BATCH_DELAY_MS)
    try:
        engine = ServingEngine(model, platform, max_len=max_len, params=params, device=dev)
        warm = torch.randint(0, cfg.vocab_size, (1, prompt_len), generator=gen, device=dev, dtype=torch.int32)
        engine.generate({"tokens": warm}, steps=6)  # observe, fuse, warm up (load_bench's warm())
        platform.merger.wait_idle()
        check(len(platform.registry.live_instances()) == 1, "batched: the chain did not fuse")
        state = []
        for _ in range(clients):
            prompt = torch.randint(0, cfg.vocab_size, (1, prompt_len), generator=gen, device=dev,
                                   dtype=torch.int32)
            logits, caches, cur = engine.prefill({"tokens": prompt})
            state.append({"token": _greedy_token(logits), "cur_len": cur, "caches": caches})

        # K4 under vmap at the main path's shape and layout: layer 0 of the
        # lanes' stacked layer-first caches (lanes, L, B, S, KV, hd), read in place
        k, v = (torch.stack([c["caches"]["g0"][n] for c in state]) for n in ("k", "v"))
        q = torch.randn(clients, 1, cfg.num_heads, cfg.head_dim, generator=gen, device=dev).to(k.dtype)
        cur = torch.stack([c["cur_len"] for c in state]) + 1
        with torch.no_grad():
            lanes = torch.func.vmap(lambda q, k, v, c: k4.decode_attention(q, k[0], v[0], c))(q, k, v, cur)
            loop = torch.stack([k4.decode_attention(q[i], k[i, 0], v[i, 0], cur[i]) for i in range(clients)])
        check(torch.equal(lanes, loop), "K4 under vmap differs in bits from K4 per lane")

        start = [c["cur_len"] for c in state]

        def window(n: int, warmup: int = 0) -> dict:
            """``n`` more batched steps per client (after ``warmup`` untimed
            ones) from the prefilled length (the caches' rows there are
            rewritten), so that the extra windows stay inside max_len and
            each does the same work."""
            for c, cur in zip(state, start):
                c["cur_len"] = cur
            return closed_loop(torch, engine, state, True, warmup, n)


        batches0 = platform.scheduler.stats()["batches"]
        ops.reset_counts()
        serial = closed_loop(torch, engine, state, False, warmup, steps)
        batched = closed_loop(torch, engine, state, True, warmup, steps)
        counts, parts = ops.counts(), build.LAUNCHES.parts()
        sched = platform.scheduler.stats()
        fallbacks = platform.batching_stats()
        traces = batched_traces(platform, clients * (warmup + steps))
        gate_steps = min(GATE_STEPS, steps)
        dispatch = dispatch_window(torch, lambda: window(gate_steps), clients * gate_steps, BATCH_MAX)
        traces["overhead"] = overhead_gate(platform, window, gate_steps, dev.type == "cuda") if overhead else None
        traces["prometheus_lines"] = len(prometheus_text(platform).splitlines())
        lane_err, lane_replays = lane_check(torch, engine, platform, state, captures)
        graphs = graph_summary(platform, "batched") if captures else None
    finally:
        platform.shutdown()
    runs = clients * (warmup + steps) + sched["batches"] - batches0  # decode program runs
    check(sched["max_batch_seen"] >= 2, f"batched: no batch of 2 or more formed ({sched})")
    check(all(not f["fallback_requests"] for f in fallbacks.values()),
          f"batched: requests fell back to per-request execution: {fallbacks}")
    k3_name, k4_name = (k if dev.type == "cuda" else STAND_INS[k] for k in ("flash_attention", "decode_attention"))
    check(counts[k4_name] == cfg.num_layers * runs,
          f"{k4_name} ran {counts[k4_name]} times, {runs} decode program runs make {cfg.num_layers * runs}")
    check(counts[k3_name] == 0, f"batched: {k3_name} ran {counts[k3_name]} times in a window of decode steps only")
    buckets = None
    if captures:
        buckets = sorted({g["bucket"] for g in graphs["captured_entries"] if g["bucket"] is not None})
        check(buckets, "batched: no bucket program was captured")
    return {
        "backend": platform.backend_name,
        "arch": cfg.name, "layers": cfg.num_layers, "clients": clients, "prompt_len": prompt_len,
        "warmup_steps": warmup, "steps": steps, "max_batch": BATCH_MAX, "max_delay_ms": BATCH_DELAY_MS,
        "fused_serial": serial, "fused_batched": batched,
        "batched_over_serial_requests_per_s": batched["requests_per_s"] / serial["requests_per_s"],
        "max_batch_seen": sched["max_batch_seen"], "mean_batch": sched["mean_batch"],
        "batches": sched["batches"] - batches0, "buckets_captured": buckets,
        "decode_program_runs": runs, "decode_attention_launches": counts[k4_name],
        "launches": {"flash_attention": counts[k3_name], "decode_attention": counts[k4_name]},
        "launch_parts": {part: n["decode_attention"] for part, n in parts.items()},
        "lane_rel_err": lane_err, "lane_check_bucket_replays": lane_replays, "k4_vmap_bits_equal": True,
        "batch_fallbacks": fallbacks,
        "graphs": graphs,
        "trace": traces,
        "dispatch": dispatch,
    }


def batched_traces(platform, requests: int) -> dict:
    """The batched mode's traces, checked: the recorder dropped nothing;
    each of the ``requests`` ``invoke_async`` traces tiles its wall time
    exactly (queue-wait, window-wait, batch-compute: residual 0.0); the
    batch traces its members reference are exactly the batch traces."""
    from repro_torch.obs import attribute, summarize

    recorder = platform.tracer.recorder
    records = recorder.snapshot()
    check(recorder.dropped() == 0, f"batched: the flight recorder dropped {recorder.dropped()} records")
    results = attribute(records)
    reqs = [r for r in results if r["kind"] == "invoke_async"]
    check(len(reqs) == requests, f"batched: {len(reqs)} invoke_async traces for {requests} requests")
    bad = [r for r in reqs if not r["conserved"] or r["residual_s"] != 0.0]
    check(not bad, f"batched: {len(bad)} invoke_async traces do not tile their wall time: {bad[:2]}")
    batches = {r["trace_id"] for r in results if r["kind"] == "batch"}
    refs = {r.args["batch_trace"] for r in records
            if r.cat == "batch-compute" and r.args and "batch_trace" in r.args}
    check(batches and refs == batches, f"batched: {len(refs)} referenced batch traces, {len(batches)} minted")
    return {"invoke_async_traces": len(reqs), "batch_traces": len(batches), "residual_s": 0.0,
            "phase_share": summarize(reqs)["phase_share"]}


def overhead_gate(platform, window, steps: int, gate: bool, rounds: int = GATE_ROUNDS) -> dict:
    """load_bench's tracing-overhead gate (load_bench.py:1464-1478) on the
    batched mode: requests/s with tracing on over requests/s with it off
    (``Tracer.enabled``, which ``tracing=False`` sets) must be at least
    OVERHEAD_MIN. Interleaved rounds on one warm platform (on, off, off,
    on, ...), ``window(steps)`` each; one retry, as the reference has it.
    Each attempt starts after a full collection and one untimed round: the
    garbage of the earlier phases otherwise owes the collector a full pass
    (0.4-0.7 s over the process's heap on the card's host), and an
    attempt's first round runs slower than the next (0.87 against 0.95 of
    the attempt's median on the card's host), and that round is always an
    "on" round. Checked where ``gate`` (on the card); the CPU reports the
    ratio only."""
    import gc

    order = [True, False, False, True] * (rounds // 4)
    formed = {True: [0, 0], False: [0, 0]}  # requests and batches per mode, all attempts
    # the collector's passes while each mode's rounds ran, per attempt:
    # passes by generation and their seconds (a pass holds every thread)
    collector = []
    per_round = []  # each attempt's rounds: [on, requests/s]
    mode, started = [None], [0.0]

    def on_collect(phase: str, info: dict) -> None:
        if mode[0] is None:
            return
        if phase == "start":
            started[0] = time.perf_counter()
            return
        tally = collector[-1][mode[0]]
        tally["passes"][info["generation"]] += 1
        tally["seconds"] += time.perf_counter() - started[0]

    def attempt() -> float:
        done = {True: [0, 0.0], False: [0, 0.0]}
        collector.append({on: {"passes": [0, 0, 0], "seconds": 0.0} for on in (True, False)})
        per_round.append([])
        gc.collect()
        window(steps, GATE_WARMUP)  # untimed, tracing on as it was
        gc.callbacks.append(on_collect)
        try:
            for on in order:
                platform.tracer.enabled = on
                b0 = platform.scheduler.stats()["batches"]
                mode[0] = on
                r = window(steps, GATE_WARMUP)
                mode[0] = None
                formed[on][0] += r["requests"] * (steps + GATE_WARMUP) // steps  # the warm-up's batches formed too
                formed[on][1] += platform.scheduler.stats()["batches"] - b0
                done[on][0] += r["requests"]
                done[on][1] += r["elapsed_s"]
                per_round[-1].append([on, r["requests_per_s"]])
        finally:
            mode[0] = None
            gc.callbacks.remove(on_collect)
            platform.tracer.enabled = True
        return (done[True][0] / done[True][1]) / (done[False][0] / done[False][1])

    ratios = [attempt()]
    if ratios[0] < OVERHEAD_MIN:
        ratios.append(attempt())
    out = {"on_over_off_requests_per_s": ratios, "rounds": rounds, "steps_per_round": steps,
           "mean_batch": {"on": formed[True][0] / formed[True][1], "off": formed[False][0] / formed[False][1]},
           "collector": [{"on" if on else "off": t for on, t in a.items()} for a in collector],
           "rounds_requests_per_s": per_round}
    if gate:
        check(ratios[-1] >= OVERHEAD_MIN,
              f"batched: tracing on / off requests/s {ratios} < {OVERHEAD_MIN} (collector: {out['collector']})")
    return out


def lane_check(torch, engine, platform, state, captures: bool, attempts: int = 4):
    """Each lane of one batched decode step against the same request's
    ``invoke``: logits and caches within LANE_TOL of max |value| (the
    batched einsums may choose other cuBLAS algorithms). Where programs are
    captured, the lanes are taken from a step whose every batch was a
    replay of a captured bucket program (a bucket's first run is eager and
    its second captures it; the timed loop has run both), so the replayed
    graph itself is held against ``invoke``: its stacked static inputs, the
    caches donated under vmap, the split of its pool into lanes. Returns
    (each lane's error, the bucket replays of the checked step)."""
    import threading

    from repro_torch import tree

    (unit,) = platform.registry.live_instances()

    def bucket_replays() -> int:
        return sum(g["replays"] for g in unit.graph_stats() if g["bucket"] is not None)

    want = [engine.decode_step(c["token"], c["cur_len"], c["caches"]) for c in state]
    for _ in range(attempts):
        batches0, replays0 = platform.scheduler.stats()["batches"], bucket_replays()
        barrier = threading.Barrier(len(state))
        got = [None] * len(state)

        def one(i):
            barrier.wait()
            got[i] = engine.decode_step_async(state[i]["token"], state[i]["cur_len"], state[i]["caches"]).result()

        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(state))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        batches, replays = platform.scheduler.stats()["batches"] - batches0, bucket_replays() - replays0
        if not captures or replays == batches:
            break
    check(not captures or replays == batches > 0,
          f"batched: no step in {attempts} was served by captured bucket programs alone "
          f"(last: {batches} batches, {replays} bucket replays)")
    lane_err = [max(rel_err(a, b) for a, b in zip(tree.leaves(g), tree.leaves(w))) for g, w in zip(got, want)]
    check(max(lane_err) <= LANE_TOL, f"batched lanes differ from invoke beyond {LANE_TOL}: {lane_err}")
    return lane_err, replays


def rel_err(a, b) -> float:
    """max |a - b| over max |b|, in float32 on the host."""
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).abs().max() / b.abs().max())


def small_config(cfg):
    """``cfg`` reduced (2 layers; the hybrid 5) at width 256 with the head
    dims the kernels take (attention heads of 64; SSM heads of 64 over a
    state of 64): the small model of the card-vs-host and batcher checks."""
    import dataclasses

    from repro_torch.configs import reduced_config

    changes: dict = {"d_model": 256}
    if cfg.num_heads:
        changes["d_head"] = 64
    if cfg.ssm_state:
        changes.update(ssm_head_dim=64, ssm_state=64)
    return dataclasses.replace(reduced_config(cfg), **changes)


def attention_fan_in_d(params, cfg) -> None:
    """Rescale, in place, every attention block's wq and wk as if drawn with
    the fan-in d_model instead of the JAX init rule's H and KV (axis -2 of
    (d, H, hd)). Under the JAX rule a small model's attention is near-hard
    (scores of std ~100), and a hybrid's prefill logits move by 20-54 % of
    max |logit| when K6's output is rounded once instead of twice (6 of 8
    seeds on the host); with fan-in d, by at most 1 %."""
    import math

    for key, sub in params.items():
        if key in ("attn", "cross"):  # the enc-dec decoder's cross-attention too
            sub["wq"].mul_(math.sqrt(cfg.num_heads / cfg.d_model))
            sub["wk"].mul_(math.sqrt(cfg.num_kv_heads / cfg.d_model))
        elif isinstance(sub, dict):
            attention_fan_in_d(sub, cfg)


def encdec_unit_cross_keys(torch, params, cfg, src) -> float:
    """Rescale, in place, the enc-dec decoder's cross-attention wk and wv by
    the RMS of the encoder states of ``src`` (returned), so that its keys
    and values are those of unit-scale states. The reference's encoder
    returns its residual stream with no final norm, and in a small random
    model that stream's RMS is ~13: the cross scores are ~13 times those of
    unit-scale states, the cross-attention near-hard, and bf16 rounding
    alone moves the small model's gradients on the host by up to 5.4 % of
    their max against fp32 (attention at fan-in d); over unit-scale states,
    by up to 2.0 %."""
    from repro_torch.models import encdec as ed

    with torch.no_grad():
        rms = float(ed.encode(params["encdec"], src, cfg).float().pow(2).mean().sqrt())
        params["encdec"]["decoder"]["cross"]["wk"].div_(rms)
        params["encdec"]["decoder"]["cross"]["wv"].div_(rms)
    return rms


def small_model_check(torch, dev, small_cfg, prompt_len: int = 37, fan_in_d: bool = False) -> dict:
    """The small model on ``dev`` against the same bf16 weights on the
    host's CPU (the plain versions): prefill and one decode step, end to end,
    within REF_TOL of max |logit|; ``fan_in_d``: its attention projections
    rescaled by :func:`attention_fan_in_d`."""
    from repro_torch import tree
    from repro_torch.models.model import build_model

    def prefill_and_decode(model, p, toks, nxt):
        logits, cache = model.prefill_fn(p, {"tokens": toks})
        cache = pad_caches(torch, cache, 1)
        cur = torch.full((toks.shape[0],), toks.shape[1], dtype=torch.int32, device=toks.device)
        step, _ = model.decode_fn(p, {"tokens": nxt, "cur_len": cur}, cache)
        return logits, step

    gen = torch.Generator(device=dev).manual_seed(5)
    with torch.no_grad():
        small = build_model(small_cfg)
        params = small.init(0, device=dev)
        if fan_in_d:
            attention_fan_in_d(params, small_cfg)
        toks = torch.randint(0, small.cfg.vocab_size, (1, prompt_len), generator=gen, device=dev,
                             dtype=torch.int32)
        nxt = torch.argmax(small.prefill_fn(params, {"tokens": toks})[0], -1)[:, None].to(torch.int32)
        here = prefill_and_decode(small, params, toks, nxt)
        host = prefill_and_decode(small, tree.map(lambda x: x.cpu(), params), toks.cpu(), nxt.cpu())
    for a in here:
        check(tuple(a.shape) == (1, small.cfg.vocab_size), f"logits of shape {tuple(a.shape)}")
        check(bool(torch.isfinite(a).all()), "non-finite logits")
    out = {"arch": small.cfg.name, "d_model": small.cfg.d_model, "layers": small.cfg.num_layers,
           "attention_fan_in_d": fan_in_d, "rel_err": [rel_err(a, b) for a, b in zip(here, host)]}
    check(max(out["rel_err"]) <= REF_TOL, f"small-input logits differ from the host's beyond {REF_TOL}: {out}")
    return out


def reference_phase(torch, dev, cfg, prompt_len: int = 37) -> dict:
    """The model on ``dev`` against the same bf16 weights on the host's CPU
    (the plain versions): a small input end to end, and the full width
    block by block."""
    import dataclasses

    from repro_torch import tree
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import embed_tokens
    from repro_torch.models.model import build_model

    gen = torch.Generator(device=dev).manual_seed(5)
    out = {"small": small_model_check(torch, dev, small_config(cfg), prompt_len)}
    with torch.no_grad():
        model = build_model(cfg)
        params = model.init(0, device=dev)
        host_params = tree.map(lambda x: x.cpu(), params)
        toks = torch.randint(0, cfg.vocab_size, (1, prompt_len), generator=gen, device=dev,
                             dtype=torch.int32)
        kind = tfm.layer_kind(cfg)
        x = embed_tokens(params["embed"], toks)
        pos = torch.arange(prompt_len, device=dev)[None]
        blocks = []
        for i in range(cfg.num_layers):
            y, _, _ = tfm.apply_block_full(tree.map(lambda a: a[i], params["blocks"]), x, cfg, kind, pos)
            y_host, _, _ = tfm.apply_block_full(tree.map(lambda a: a[i], host_params["blocks"]),
                                             x.cpu(), cfg, kind, pos.cpu())
            blocks.append(rel_err(y - x, y_host - x.cpu()))  # the block's own contribution
            x = y
        out["full_width_blocks_rel_err"] = blocks
        check(max(blocks) <= BLOCK_TOL, f"a full-width block differs from the host's beyond {BLOCK_TOL}")
        logits = model.prefill_fn(params, {"tokens": toks})[0]
        host_logits = model.prefill_fn(host_params, {"tokens": toks.cpu()})[0]
        fp32 = dataclasses.replace(cfg, kv_cache_dtype="float32")
        host_fp32 = build_model(fp32).prefill_fn(tree.map(lambda x: x.float(), host_params),
                                                 {"tokens": toks.cpu()})[0]
        out["full_width_logits_rel_err"] = {"card_vs_host": rel_err(logits, host_logits),
                                            "host_bf16_vs_host_fp32": rel_err(host_logits, host_fp32)}
    return out


def device_profile(torch, run, steps: int) -> dict:
    """Where the time of ``run()`` (``steps`` invocations, ending in a
    device sync; returns its wall ms) goes: one run timed on the host clock,
    then one under torch.profiler for the device's kernel time, the host's
    top-level ops and the kernels that take most of it, per invocation."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    wall_ms = run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_wall_ms = run()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict[str, list] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    device_ms = sum(sum(v) for v in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:10]
    return {
        "steps": steps,
        "wall_ms_per_step": wall_ms / steps,
        "profiled_wall_ms_per_step": profiled_wall_ms / steps,
        "device_kernel_ms_per_step": device_ms / steps,
        "device_busy_share": device_ms / wall_ms,
        "kernels_per_step": len(kernels) / steps,
        "host_ops_per_step": sum(1 for e in prof.events()
                                 if e.device_type == DeviceType.CPU and e.name.startswith("aten::")
                                 and e.cpu_parent is None) / steps,
        "top_kernels": [{"name": n[:80], "calls_per_step": len(v) / steps,
                         "ms_per_step": sum(v) / 1e3 / steps} for n, v in top],
        # the port's own kernels, wherever they rank
        "port_kernels": {k: {"calls_per_step": sum(len(v) for n, v in by_name.items() if k in n) / steps,
                             "ms_per_step": sum(sum(v) for n, v in by_name.items() if k in n) / 1e3 / steps}
                         for k in PORT_KERNELS if any(k in n for n in by_name)},
    }


def profile_phase(torch, dev, cfg, prompt_len: int = 128, steps: int = 8,
                  max_len: int = MAX_LEN, params=None, prefill: bool = False, gap: bool = False) -> dict:
    """Where a fused decode step's time goes (:func:`device_profile` over
    ``steps`` decode steps) and, with ``prefill``, a fused prefill's (over
    ``steps`` prefills of the prompt, under "prefill"); with ``gap``, the
    split of a step's wall time beyond its kernels (:func:`step_gap`, under
    "step_gap"). ``params``: the model's weights, made from seed 0 when not
    given."""
    from repro_torch.core import FusionPolicy, TinyTorchBackend
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ServingEngine, _greedy_token

    model = build_model(cfg)
    if params is None:
        params = model.init(0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    prompt = torch.randint(0, cfg.vocab_size, (1, prompt_len), generator=gen, device=dev,
                           dtype=torch.int32)
    platform = TinyTorchBackend(FusionPolicy(**SERVE_POLICY))
    try:
        engine = ServingEngine(model, platform, max_len=max_len, params=params, device=dev)
        engine.generate({"tokens": prompt}, steps=6)  # observe, fuse, warm up
        platform.merger.wait_idle()
        check(len(platform.registry.live_instances()) == 1, "profile: the chain did not fuse")
        logits, caches, cur = engine.prefill({"tokens": prompt})
        tok = _greedy_token(logits)

        def run_steps() -> float:
            nonlocal logits, caches, cur, tok
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                logits, caches = engine.decode_step(tok, cur, caches)
                cur = cur + 1
                tok = _greedy_token(logits)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        def run_prefills() -> float:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                engine.prefill({"tokens": prompt})
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        out = {"prompt_len": prompt_len, **device_profile(torch, run_steps, steps)}
        if prefill:
            out["prefill"] = device_profile(torch, run_prefills, steps)
        if gap:
            def step() -> None:
                nonlocal logits, caches, cur, tok
                logits, caches = engine.decode_step(tok, cur, caches)
                cur = cur + 1
                tok = _greedy_token(logits)

            out["step_gap"] = step_gap(torch, platform, step, 4 * steps)
    finally:
        platform.shutdown()
    return out


def step_gap(torch, platform, step, steps: int) -> dict:
    """Split a captured fused decode step's wall time beyond its kernel time
    (PERF.md's open question) into the copy-in of the arguments, the host's
    replay call, the gaps between the graph's nodes and the copy-out of the
    returned tree, and what is left (the platform's host code around the
    replay and the wait for the device). The decode entry's graph (the
    fused unit's most replayed one) is instrumented for ``steps`` calls of
    ``step()``: host clocks and CUDA events around the copy-in, the replay
    call and the copy-out. Its kernels (count and time per replay, from
    ``torch.profiler``) and its device time (``steps`` replays back to back,
    CUDA events, so the host's launch is hidden) come from bare replays of
    the graph, which touch only the graph's own static inputs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import function as fn_mod

    (unit,) = platform.registry.live_instances()
    graphs = [ce.graph for ce in list(unit._compiled.values()) if ce.graph is not None]
    cg = max(graphs, key=lambda g: g.replays)
    real, orig_sync, marks = cg.graph, fn_mod._synchronize, []

    def mark(name: str) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks[-1][name] = (time.perf_counter(), ev)

    class TimedGraph:  # stands in for the torch.cuda.CUDAGraph while measured
        def replay(self):
            mark("graph")
            real.replay()
            mark("copy_out")

    def replay(leaves, lanes=None):
        marks.append({})
        mark("copy_in")
        out = fn_mod.CapturedGraph.replay(cg, leaves, lanes)
        marks[-1]["done"] = (time.perf_counter(), None)
        return out

    def synchronize(dev) -> None:
        mark("sync")
        orig_sync(dev)

    walls = []
    cg.replay, cg.graph, fn_mod._synchronize = replay, TimedGraph(), synchronize
    try:
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            walls.append((time.perf_counter() - t0) * 1e3)
    finally:
        del cg.replay
        cg.graph, fn_mod._synchronize = real, orig_sync
    check(len(marks) == steps, f"step_gap: {len(marks)} replays of the decode graph in {steps} steps")

    def ms(a: str, b: str, device: bool) -> float:
        return statistics.median(m[a][1].elapsed_time(m[b][1]) if device else (m[b][0] - m[a][0]) * 1e3
                                 for m in marks)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            real.replay()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernel_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / steps
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(steps):
        real.replay()
    e1.record()
    torch.cuda.synchronize()
    graph_ms = e0.elapsed_time(e1) / steps
    wall = statistics.median(walls)
    parts = {
        "copy_in_ms": ms("copy_in", "graph", True),
        "replay_call_ms": ms("graph", "copy_out", False),
        "node_gaps_ms": graph_ms - kernel_ms if kernels else None,
        "copy_out_ms": ms("copy_out", "sync", True),
    }
    beyond = wall - kernel_ms
    return {
        "steps": steps, "wall_ms": wall, "kernel_ms": kernel_ms if kernels else None,
        "graph_nodes": len(kernels) / steps, "graph_device_ms": graph_ms, "beyond_kernels_ms": beyond,
        **parts,
        "rest_ms": beyond - sum(v for v in parts.values() if v is not None),
        "copy_in_host_ms": ms("copy_in", "graph", False), "copy_out_host_ms": ms("copy_out", "sync", False),
        "graph_in_step_device_ms": ms("graph", "copy_out", True), "sync_wait_ms": ms("sync", "done", False),
        "outside_replay_ms": wall - ms("copy_in", "done", False),
    }


MOE_AGREE = 0.99  # share of tokens whose top-k expert sets must agree, card vs host


def moe_block_phase(torch, dev, cfg, params, prompt_len: int = 37) -> dict:
    """One full-width MoE layer (``apply_moe`` with layer 0's weights) on the
    same bf16 input on ``dev`` (K5) and on the host's CPU (the plain
    version): how many tokens' top-k expert sets agree (a flip needs an fp32
    near-tie), and the outputs on the tokens that agree."""
    from repro_torch import tree
    from repro_torch.models import moe
    from repro_torch.models.layers import apply_norm, embed_tokens

    gen = torch.Generator(device=dev).manual_seed(13)
    toks = torch.randint(0, cfg.vocab_size, (1, prompt_len), generator=gen, device=dev, dtype=torch.int32)
    layer = tree.map(lambda a: a[0], params["blocks"])
    host = tree.map(lambda a: a.cpu(), layer["moe"])
    k = cfg.num_experts_per_tok
    with torch.no_grad():
        x = apply_norm(layer["ln2"], embed_tokens(params["embed"], toks), cfg)
        y, metrics = moe.apply_moe(layer["moe"], x, cfg)
        y_host, metrics_host = moe.apply_moe(host, x.cpu(), cfg)
        sets = moe.route(layer["moe"], x, cfg)[1].reshape(-1, k).sort(dim=-1).values.cpu()
        sets_host = moe.route(host, x.cpu(), cfg)[1].reshape(-1, k).sort(dim=-1).values
    agree = (sets == sets_host).all(dim=-1)
    y, y_host = y.float().cpu()[0], y_host.float()[0]
    check(bool(torch.isfinite(y).all()), "MoE layer output has non-finite values")
    err = float((y - y_host)[agree].abs().max() / y_host.abs().max())
    check(int(agree.sum()) >= MOE_AGREE * prompt_len,
          f"top-{k} expert sets agree for {int(agree.sum())} of {prompt_len} tokens only")
    check(err <= REF_TOL, f"MoE layer output, card vs host, differs by {err} of max |y| (limit {REF_TOL})")
    return {
        "tokens": prompt_len,
        "topk_sets_agree": int(agree.sum()),
        "rel_err_on_agreeing_tokens": err,
        "moe_dropped": {"card": float(metrics["moe_dropped"]), "host": float(metrics_host["moe_dropped"])},
        "moe_aux": {"card": float(metrics["moe_aux"]), "host": float(metrics_host["moe_aux"])},
    }


def model_blocks(cfg, params) -> list:
    """The SSM or hybrid model's blocks in the order a forward applies them:
    (name, kind, the block's weights)."""
    from repro_torch import tree

    layer = lambda stack, i: tree.map(lambda a: a[i], stack)  # noqa: E731
    if cfg.family == "ssm":
        return [(f"ssm_{i}", "ssm", layer(params["blocks"], i)) for i in range(cfg.num_layers)]
    hyb, every = params["hybrid"], cfg.shared_attn_every
    n_groups = cfg.num_layers // every
    out = []
    for g in range(n_groups):
        group = layer(hyb["groups"], g)
        out += [(f"ssm_{g * every + j}", "ssm", layer(group, j)) for j in range(every)]
        out.append((f"shared_{g}", "dense", hyb["shared"]))
    if "tail" in hyb:
        out += [(f"ssm_{n_groups * every + j}", "ssm", layer(hyb["tail"], j))
                for j in range(cfg.num_layers - n_groups * every)]
    return out


def ssm_block_phase(torch, dev, cfg, params, small_cfg, prompt_len: int = 37) -> dict:
    """The SSM and hybrid models' block checks on a random prompt of
    ``prompt_len`` + 1 tokens, each block on the input the previous ones
    give it: (1) the first SSM block and the first application of the
    shared block, full width on ``dev`` against the same bf16 weights on the
    host's CPU (the chunked scan and the plain attention there), relative to
    the block's own largest contribution, within BLOCK_TOL; (2) every
    block's prefill of T tokens plus one decode step against its prefill of
    T + 1 tokens (the recurrent step against K6's dual form; K4 against K3),
    relative to the block output's max |y| at row T (a contribution that is
    small beside the residual stream is rounded at the stream's scale in
    bf16, so its own max is no yardstick there), within BLOCK_TOL; (3) the
    small model end to end, card against host (:func:`small_model_check`,
    the hybrid's shared attention drawn with fan-in d so that rounding is
    not amplified)."""
    from repro_torch import tree
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import embed_tokens

    t = prompt_len
    gen = torch.Generator(device=dev).manual_seed(17)
    toks = torch.randint(0, cfg.vocab_size, (1, t + 1), generator=gen, device=dev, dtype=torch.int32)
    pos = torch.arange(t + 1, device=dev)[None]
    cur = torch.full((1,), t, dtype=torch.int32, device=dev)
    host, consistency = {}, {}
    with torch.no_grad():
        x = embed_tokens(params["embed"], toks)
        for name, kind, lp in model_blocks(cfg, params):
            y, _, _ = tfm.apply_block_full(lp, x, cfg, kind, pos)
            label = "ssm_block_0" if kind == "ssm" else "shared_block"
            if label not in host:
                y_host, _, _ = tfm.apply_block_full(tree.map(lambda a: a.cpu(), lp), x.cpu(), cfg, kind, pos.cpu())
                host[label] = rel_err(y - x, y_host - x.cpu())
            _, cache, _ = tfm.apply_block_full(lp, x[:, :t], cfg, kind, pos[:, :t], collect_cache=True)
            if kind != "ssm":  # (k, v) of (B, T, KV, hd): one more slot for the step's write
                cache = {n: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, 1)) for n, c in zip("kv", cache)}
            step, _ = tfm.apply_block_decode(lp, x[:, t:], cache, cfg, kind, cur)
            consistency[name] = rel_err(step[:, 0], y[:, t])
            x = y
    check(bool(torch.isfinite(x).all()), "non-finite hidden state after the last block")
    check(max(host.values()) <= BLOCK_TOL, f"a full-width block differs from the host's beyond {BLOCK_TOL}: {host}")
    worst = max(consistency, key=consistency.get)
    check(consistency[worst] <= BLOCK_TOL,
          f"block {worst}: prefill + decode differs from the longer prefill by {consistency[worst]}")
    return {
        "prompt_len": t,
        "card_vs_host_rel_err": host,
        "prefill_decode_rel_err": consistency,
        "prefill_decode_worst": [worst, consistency[worst]],
        "small": small_model_check(torch, dev, small_cfg, fan_in_d=True),
    }


def ssd_captured_case(torch, dev, cfg, params, prompt_len: int = 300) -> dict:
    """K6 against its plain version on the inputs the model's first SSM
    layer gives it for a random prompt (:func:`ssd_case`, captured): at full
    width with the JAX init rule, in_B and in_C have a fan-in of G = 1, so
    B and C reach a std of about sqrt(d_model) and the scores the thousands."""
    from repro_torch.models import ssm
    from repro_torch.models.layers import apply_norm, embed_tokens

    _, _, layer = model_blocks(cfg, params)[0]
    gen = torch.Generator(device=dev).manual_seed(19)
    toks = torch.randint(0, cfg.vocab_size, (1, prompt_len), generator=gen, device=dev, dtype=torch.int32)
    with torch.no_grad():
        u = apply_norm(layer["ln1"], embed_tokens(params["embed"], toks), cfg)
        *_, xh, bm, cm, dt = ssm.ssd_inputs(layer["ssm"], u, cfg)
        return ssd_case(torch, f"captured: {cfg.name} layer 0, T={prompt_len}", xh.contiguous(),
                        bm.contiguous(), cm.contiguous(), dt.contiguous(), layer["ssm"]["A_log"],
                        layer["ssm"]["D"], captured=True)


# ------------------------------------------------------------ cold-start phases

PARK_WAIT_S = 10.0  # the reconciler must park an idle chain within this
MEMORY_FREED_MIN = 0.99  # of the weights' bytes, at a park


def timed_generate(torch, engine, prompt, steps: int):
    """``engine.generate``'s greedy loop, timed: (tokens (B, steps), seconds
    to the first token, per-token seconds of the decode steps)."""
    from repro_torch.serving.engine import _greedy_token

    t0 = time.perf_counter()
    logits, caches, cur = engine.prefill({"tokens": prompt})
    tokens = _greedy_token(logits)
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    ttft = time.perf_counter() - t0
    out, lat = [tokens], []
    for _ in range(steps - 1):
        t1 = time.perf_counter()
        logits, caches = engine.decode_step(tokens, cur, caches)
        lat.append(time.perf_counter() - t1)
        cur = cur + 1
        tokens = _greedy_token(logits)
        out.append(tokens)
    return torch.cat(out, dim=1), ttft, lat


def serve_prompts(torch, engine, prompts, new_tokens: int) -> dict:
    """The serve phase's prompts through ``engine`` one after another, the
    merges waited for after the first (as the serve phase does): tokens,
    the first request's time to first token, the later requests' per-token
    latencies."""
    tokens, lats, ttft = [], [], None
    for i, prompt in enumerate(prompts):
        toks, first, lat = timed_generate(torch, engine, prompt, new_tokens)
        if i == 0:
            ttft = first
            engine.platform.merger.wait_idle()
        else:
            lats.extend(lat)
        tokens.append(toks)
    return {"tokens": tokens, "ttft_s": ttft, "lat": lats}


def dir_bytes(path: str) -> int:
    import os

    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path) for f in files)


def park_engine(torch, engine, weight_bytes: int) -> dict:
    """``engine.scale_to_zero()``, checked: every chain function parked and
    resolving nowhere, ``ram_bytes`` 0, and on the card the allocated memory
    down by at least ``MEMORY_FREED_MIN`` of the weights' bytes."""
    platform, cuda = engine.platform, engine.device.type == "cuda"
    names = engine.chain_names()
    if cuda:
        torch.cuda.synchronize()
    before = torch.cuda.memory_allocated() if cuda else 0
    t0 = time.perf_counter()
    parked = engine.scale_to_zero()
    park_s = time.perf_counter() - t0
    after = torch.cuda.memory_allocated() if cuda else 0
    check(sorted(parked) == sorted(names), f"parked {parked}, not the chain {names}")
    check(platform.provisioning_stats()["parked"] == sorted(names), "a chain function is not parked")
    check(all(platform.registry.get(n) is None for n in names), "a parked function still resolves")
    check(platform.ram_bytes() == 0, f"ram_bytes {platform.ram_bytes()} with the chain parked")
    if cuda:
        check(before - after >= MEMORY_FREED_MIN * weight_bytes,
              f"the park freed {before - after} B of device memory, under {MEMORY_FREED_MIN} of the "
              f"weights' {weight_bytes} B")
    snaps = platform.snapshots.stats()
    return {"parked": len(parked), "park_s": park_s, "allocated_before_gb": before / 1e9,
            "allocated_after_gb": after / 1e9, "freed_bytes": before - after, "weight_bytes": weight_bytes,
            "puts": snaps["puts"], "dedup_hits": snaps["dedup_hits"], "put_s": snaps["put_s"],
            "bytes_on_disk": dir_bytes(platform.snapshots.directory)}


def resurrect_cycle(torch, engine, replays, prompts, new_tokens: int, want_tokens, weight_bytes: int) -> dict:
    """Park the chain, serve the prompts again and check: the same tokens
    bit for bit, one billed resurrect per chain function, all warm, the
    chain fused to one instance again, and (on the card) each kernel
    launched exactly as the run's prefills, decode steps, merge canaries and
    resurrect health checks make it. The counts are set to 0 just before
    the serving and read just after it."""
    from repro_torch.analysis.dispatch import TRACER
    from repro_torch.kernels import build, ops

    platform, cfg, cuda = engine.platform, engine.cfg, engine.device.type == "cuda"
    names = engine.chain_names()
    park = park_engine(torch, engine, weight_bytes)
    n_prov, n_merges, n_rez = (len(platform.meter.provisioning), len(platform.merger.merge_log),
                               len(platform.provisioning_stats()["resurrects"]))
    replays.clear()
    base = TRACER.snapshot()
    TRACER.arm()
    try:
        ops.reset_counts()
        run = serve_prompts(torch, engine, prompts, new_tokens)
        counts, parts = ops.counts(), build.LAUNCHES.parts()
    finally:
        TRACER.disarm()
    d = TRACER.delta(base)
    allocated = torch.cuda.memory_allocated() if cuda else 0
    for i, (a, b) in enumerate(zip(want_tokens, run["tokens"])):
        check(torch.equal(a, b), f"prompt {i}: tokens after the park differ from those before it")
    records = [r for r in platform.meter.provisioning[n_prov:] if r.kind == "resurrect"]
    check(sorted(f for r in records for f in r.functions) == sorted(names),
          f"resurrects {[r.functions for r in records]} against the chain {names}")
    check(all(r.warm and r.billed for r in records), f"a resurrect is not warm and billed: {records}")
    check(len(platform.registry.live_instances()) == 1, "the chain did not re-fuse to one instance")
    merges = [m for m in platform.merger.merge_log[n_merges:] if m.healthy]
    check(merges and set(merges[-1].members) == set(names), "no healthy merge of the whole chain after the park")
    expected = expected_launches(cfg, engine, len(prompts), len(prompts) * (new_tokens - 1), replays)
    for k, want in expected.items():
        if cuda:
            check(counts[k] == want, f"coldstart: {k} launched {counts[k]} times, the run makes {want} ({counts})")
        elif k in STAND_INS:
            check(counts[STAND_INS[k]] == want, f"coldstart: {STAND_INS[k]} ran {counts[STAND_INS[k]]} times for {want}")
    if cuda:
        check(all(counts[k] == 0 for k in PLAIN), f"coldstart: a plain version ran on the card: {counts}")
    rez = platform.provisioning_stats()["resurrects"][n_rez:]
    kernels = ("flash_attention", "decode_attention", "ssd_scan")
    return {
        **park,
        "ttft_s": run["ttft_s"],
        "p50_token_ms": statistics.median(run["lat"]) * 1e3,
        "resurrects": [{k: r[k] for k in ("function", "wall_s", "restore_s", "read_s", "verify_s", "copy_s",
                                          "health_s", "publish_s")} for r in rez],
        "resurrects_warm": all(r.warm for r in records),
        "merges": [{"members": len(m.members), "warm": m.warm, "build_s": m.build_s} for m in merges],
        "last_merge_warm": merges[-1].warm,
        "new_entries": d.entries, "new_buckets": d.buckets, "captures": d.captures,
        "launches": {k: counts[k] for k in kernels}, "expected_launches": expected,
        "launch_parts": {part: {k: n[k] for k in kernels} for part, n in parts.items()},
        "health_check_replays": sum(1 for _, _, r in replays if r == 1),
        "merge_canary_replays": sum(1 for _, _, r in replays if r == 2),
        "allocated_after_resurrect_gb": allocated / 1e9,
        "allocated_over_before_park_gb": (allocated - park["allocated_before_gb"] * 1e9) / 1e9,
    }


def paged_run(torch, engine, prompts, gens, capacity: int, page: int, kv_pages: int) -> dict:
    """The requests through the continuous batcher over a fresh arena (so a
    run after a park meets the arena a run before it met): tokens and
    launches (set to 0 just before the requests, read just after)."""
    from repro_torch.kernels import ops
    from repro_torch.serving.continuous import ContinuousBatcher

    engine.enable_paging(kv_pages, page)
    cb = ContinuousBatcher(engine, capacity=capacity)
    try:
        ops.reset_counts()
        results = [f.result(timeout=600) for f in [cb.submit({"tokens": p}, g) for p, g in zip(prompts, gens)]]
        counts = ops.counts()
    finally:
        cb.shutdown()
    engine.arena.check_consistency()
    return {"tokens": [r["tokens"] for r in results], "counts": counts}


def coldstart_phase(torch, dev, cfg, prompt_lens=PROMPT_LENS, new_tokens=NEW_TOKENS, max_len=MAX_LEN,
                    n_paged: int = 8, capacity: int = CAPACITY, page: int = PAGE) -> dict:
    """Scale-to-zero of the serving chain (``cfg`` at full width and depth,
    random bf16 weights from seed 0; one engine with a KV arena, snapshots
    in a temporary directory removed at the end). The serve phase's prompts
    with ``SERVE_POLICY`` until the chain is one instance (the cold start:
    deploy plus the first request's first token, the kernels built and the
    executable index emptied first, as ``load_bench``'s coldstart mode
    does; the loaded cold start adds the copy of every weight from host
    memory to the device before the deploy, as a start that loads its
    weights makes it); then
    two park cycles (:func:`resurrect_cycle`): the first re-fusion merges at
    the chain's first request, on prefill canaries (the edges' observations
    outlive a park, as in the JAX package:
    ``tests/test_torch_coldstart.py``), so it may build entries the chain
    never built; the second must build none and merge warm
    throughout. Then the paged route: the first ``n_paged`` paged requests
    (K1, K2) before and after a third park give identical tokens."""
    import shutil
    import tempfile

    from repro_torch import tree
    from repro_torch.core import FusionPolicy, TinyTorchBackend
    from repro_torch.core.function import tree_bytes
    from repro_torch.launch.compile_cache import EXECUTABLE_INDEX
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ServingEngine

    EXECUTABLE_INDEX.clear()  # the earlier phases served this chain's entries
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(7)
    prompts = [torch.randint(0, cfg.vocab_size, (1, t), generator=gen, device=dev, dtype=torch.int32)
               for t in prompt_lens]
    paged_prompts, gens = paged_requests(cfg, prompt_lens, n_paged, steps=min(PAGED_STEPS, max_len // 4),
                                         prefix_len=min(SHARED_PREFIX, max_len // 4))
    kv_pages = (capacity + 2) * (max_len // page) + 1
    snap_dir = tempfile.mkdtemp(prefix="coldstart-")
    platform = TinyTorchBackend(FusionPolicy(**SERVE_POLICY), snapshot_dir=snap_dir)
    replays = record_replays(platform)
    try:
        params = model.init(0, device=dev)
        weight_bytes = tree_bytes(params)  # the tied table once
        host = tree.map(lambda t: t.cpu(), params)  # the weights as a loader holds them, in host memory
        del params
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = tree.map(lambda t: t.to(dev), host)  # the load: one copy of every weight to the device
        if dev.type == "cuda":
            torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        del host
        t0 = time.perf_counter()
        engine = ServingEngine(model, platform, max_len=max_len, params=params, device=dev)
        deploy_s = time.perf_counter() - t0
        del params  # the engine and its stages hold the weights now
        cold = serve_prompts(torch, engine, prompts, new_tokens)
        check(len(platform.registry.live_instances()) == 1, "the chain did not fuse to one instance")
        cycles = [resurrect_cycle(torch, engine, replays, prompts, new_tokens, cold["tokens"], weight_bytes)
                  for _ in range(2)]
        check(cycles[1]["new_entries"] == 0 and cycles[1]["new_buckets"] == 0,
              f"the second cycle after a park built new entries: {cycles[1]['new_entries']}")
        check(all(m["warm"] for m in cycles[1]["merges"]), f"a merge of the second cycle is cold: "
              f"{cycles[1]['merges']}")
        before = paged_run(torch, engine, paged_prompts, gens, capacity, page, kv_pages)
        paged_park = park_engine(torch, engine, weight_bytes)
        after = paged_run(torch, engine, paged_prompts, gens, capacity, page, kv_pages)
        stats = platform.provisioning_stats()
        traces = conserved_traces(platform, "coldstart")
        spans = [r for r in platform.tracer.recorder.snapshot() if r.cat == "cold-provision"]
        # the dense cycles' resurrects run inside an invoke's trace; the
        # batcher's (after the third park) inside none
        check(len(spans) == 2 * len(engine.chain_names()),
              f"coldstart: {len(spans)} cold-provision spans for 2 cycles of {len(engine.chain_names())} resurrects")
    finally:
        platform.shutdown()
        shutil.rmtree(snap_dir, ignore_errors=True)
    import numpy as np

    for i, (a, b) in enumerate(zip(before["tokens"], after["tokens"])):
        check(np.array_equal(a, b), f"paged request {i}: tokens after the park differ from those before it")
    paged_kernels = ("paged_decode_attention", "paged_chunk_attention")
    if dev.type == "cuda":
        for label, run in (("before", before), ("after", after)):
            c = run["counts"]
            check(all(c[k] > 0 for k in paged_kernels), f"coldstart paged {label}: K1/K2 not launched: {c}")
            check(all(c[k] == 0 for k in PLAIN), f"coldstart paged {label}: a plain version ran: {c}")
    cold_start_s = deploy_s + cold["ttft_s"]
    loaded_cold_start_s = load_s + cold_start_s
    return {
        "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "chain": engine.chain_names(), "prompts": list(prompt_lens), "new_tokens": new_tokens,
        "weight_bytes": weight_bytes,
        "cold_start_s": cold_start_s, "deploy_s": deploy_s, "cold_ttft_s": cold["ttft_s"],
        "load_s": load_s, "loaded_cold_start_s": loaded_cold_start_s,
        "cold_p50_token_ms": statistics.median(cold["lat"]) * 1e3,
        "cycles": cycles,
        "ttft_after_park_over_cold_start": [c["ttft_s"] / cold_start_s for c in cycles],
        "ttft_after_park_over_loaded_cold_start": [c["ttft_s"] / loaded_cold_start_s for c in cycles],
        "tokens_identical": True,
        "parked": cycles[-1]["parked"], "ram_bytes_parked": 0,
        "resurrects": len(cycles[-1]["resurrects"]), "resurrects_warm": cycles[-1]["resurrects_warm"],
        "last_merge_warm": cycles[-1]["last_merge_warm"],
        "new_entries_after_park": cycles[-1]["new_entries"],
        "captures_after_park": [c["captures"] for c in cycles],
        "launches": cycles[-1]["launches"],
        "paged_requests": n_paged, "paged_tokens_identical": True, "paged_park": paged_park,
        "paged_launches": {label: {k: run["counts"][k] for k in paged_kernels}
                           for label, run in (("before", before), ("after", after))},
        "executable_index": stats["executable_index"], "compile_cache": stats["compile_cache"],
        "snapshots": stats["snapshots"],
        "traces": traces, "cold_provision_spans": len(spans),
        "cold_provision_span_s": [r.t1 - r.t0 for r in spans],
    }


def ssm_coldstart_phase(torch, dev, cfg, prompt_lens=PROMPT_LENS, new_tokens=NEW_TOKENS, max_len=MAX_LEN,
                        idle_park_s: float = 1.0, params=None) -> dict:
    """Scale-to-zero on the reconciler's path (``cfg`` at full width and
    depth, an SSM chain): a fusing platform with ``idle_park_s`` on the real
    clock serves the prompts, the reconciler thread itself parks the idle
    chain (within ``PARK_WAIT_S``), and the prompts served again give the
    same tokens, with K6 launched exactly as the prefills, the merges'
    canaries and the resurrects' health checks make it."""
    import shutil
    import tempfile

    from repro_torch.core import FusionPolicy, TinyTorchBackend
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ServingEngine

    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(7)
    prompts = [torch.randint(0, cfg.vocab_size, (1, t), generator=gen, device=dev, dtype=torch.int32)
               for t in prompt_lens]
    snap_dir = tempfile.mkdtemp(prefix="ssm-coldstart-")
    platform = TinyTorchBackend(FusionPolicy(**SERVE_POLICY), snapshot_dir=snap_dir, idle_park_s=idle_park_s)
    replays = record_replays(platform)
    try:
        engine = ServingEngine(model, platform, max_len=max_len, params=params, device=dev)
        names = sorted(engine.chain_names())
        first = serve_prompts(torch, engine, prompts, new_tokens)
        t0 = time.perf_counter()
        while platform.provisioning_stats()["parked"] != names and time.perf_counter() - t0 < PARK_WAIT_S:
            time.sleep(0.01)
        waited_s = time.perf_counter() - t0
        parked = platform.provisioning_stats()["parked"]
        check(parked == names, f"the reconciler parked {parked} of {names} within {PARK_WAIT_S} s")
        replays.clear()
        ops.reset_counts()
        again = serve_prompts(torch, engine, prompts, new_tokens)
        counts = ops.counts()
        stats = platform.provisioning_stats()
    finally:
        platform.shutdown()
        shutil.rmtree(snap_dir, ignore_errors=True)
    for i, (a, b) in enumerate(zip(first["tokens"], again["tokens"])):
        check(torch.equal(a, b), f"prompt {i}: tokens after the reconciler's park differ")
    want = expected_launches(cfg, engine, len(prompts), len(prompts) * (new_tokens - 1), replays)["ssd_scan"]
    if dev.type == "cuda":
        check(counts["ssd_scan"] == want, f"ssm coldstart: K6 launched {counts['ssd_scan']} times for {want}")
        check(all(counts[k] == 0 for k in PLAIN), f"ssm coldstart: a plain version ran on the card: {counts}")
    parks = [e for e in stats["events"] if e["kind"] == "park"]
    return {
        "arch": cfg.name, "layers": cfg.num_layers, "idle_park_s": idle_park_s,
        "parked_by_reconciler": True, "park_wait_s": waited_s, "parks": len(parks),
        "park_s": [e["seconds"] for e in parks], "tokens_identical": True,
        "ttft_s": {"before": first["ttft_s"], "after_park": again["ttft_s"]},
        "resurrects": [{k: r[k] for k in ("function", "wall_s", "read_s", "verify_s", "copy_s", "health_s")}
                       for r in stats["resurrects"]],
        "launches": {"ssd_scan": counts["ssd_scan"]}, "expected_launches": {"ssd_scan": want},
        "health_check_replays": sum(1 for _, _, r in replays if r == 1),
        "merge_canary_replays": sum(1 for _, _, r in replays if r == 2),
    }


# ------------------------------------------------ the control plane on the card

BACKENDS = {"tinytorch": "TinyTorchBackend", "orchestrated": "OrchestratedBackend"}
POD_JOIN_S = 10.0  # a retired unit's pod thread must have exited within this


def backend_class(name: str):
    """The port's platform backend called ``name`` (:data:`BACKENDS`)."""
    import repro_torch.core as core

    return getattr(core, BACKENDS[name])


def watch_pods(platform) -> dict:
    """Every pod the platform starts, recorded at attach (instance id -> its
    thread); stays empty on a backend without pods."""
    seen: dict = {}
    if not hasattr(platform, "pods"):
        return seen
    attach = platform.attach_instance

    def attach_instance(instance):
        attach(instance)
        seen.update(platform.pods())

    platform.attach_instance = attach_instance
    return seen


class GCPauses:
    """While open, every pass of the cyclic collector: its generation and
    how long it held the interpreter (a pause every thread waits out)."""

    def __init__(self):
        self.pauses: list = []
        self._t0 = None

    def _note(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.pauses.append((info["generation"], time.perf_counter() - self._t0))

    def __enter__(self):
        import gc

        gc.callbacks.append(self._note)
        return self

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._note)

    def summary(self) -> dict:
        return {"passes": len(self.pauses), "gen2_passes": sum(1 for g, _ in self.pauses if g == 2),
                "max_pause_ms": max((p for _, p in self.pauses), default=0.0) * 1e3,
                "total_pause_ms": sum(p for _, p in self.pauses) * 1e3}


class CaptureThreads:
    """While open, record the platform and the thread of every CUDA-graph
    capture (``FunctionInstance._capture``)."""

    def __init__(self):
        from repro_torch.core.function import FunctionInstance

        self.records: list = []
        self._cls, self._orig = FunctionInstance, FunctionInstance._capture
        orig, records = self._orig, self.records

        def capture(inst, ce, args):
            records.append((id(inst.platform), threading.current_thread().name))
            return orig(inst, ce, args)

        FunctionInstance._capture = capture

    def close(self) -> None:
        self._cls._capture = self._orig


def pod_check(platform, seen: dict, label: str, captures: CaptureThreads | None = None) -> dict | None:
    """On the orchestrated backend (None elsewhere): the live pods are the
    live instances, every pod of a unit no longer live (a merge's or a
    split's originals, a scaled-in replica, an aborted build) has exited
    within POD_JOIN_S, and (with ``captures``) every graph capture of the
    platform's units ran on a pod's thread."""
    if not hasattr(platform, "pods"):
        return None
    live = {inst.instance_id for inst in platform.registry.live_instances()}
    pods = platform.pods()
    check(set(pods) == live, f"{label}: pods {sorted(pods)} are not the live instances {sorted(live)}")
    retired = [th for iid, th in seen.items() if iid not in live]
    for th in retired:
        th.join(timeout=POD_JOIN_S)
    alive = [th.name for th in retired if th.is_alive()]
    check(not alive, f"{label}: pods of retired units still running: {alive}")
    mine = [name for pid, name in (captures.records if captures else ()) if pid == id(platform)]
    off = [name for name in mine if not name.startswith("worker-")]
    check(not off, f"{label}: graphs captured off the pods, on {off}")
    return {"pods": len(pods), "live_instances": len(live), "pods_started": len(seen),
            "retired_pods_exited": len(retired), "captures_on_pods": len(mine)}


def orchestrated_phase(torch, dev, cfg, params, tiny_serve: dict, tiny_tokens: list, serve_kw=None,
                       batched_kw=None) -> dict:
    """The serve phase on ``OrchestratedBackend`` (a pod per unit: a queue
    and a thread), unfused and then fused, with the serve phase's checks
    and :func:`pod_check`; its tokens identical to ``TinyTorchBackend``'s
    (``tiny_tokens``) for the same prompts, and on the card graphs captured
    (from the pods) and replayed. Then the batched phase's main path
    through the pods (8 closed-loop clients, ``max_batch`` 8), with its
    checks but the tracing-overhead gate. Returns the two phases' lines,
    the serve line holding ``tiny_serve``'s per-token p50s beside its own."""
    from repro_torch.launch.compile_cache import EXECUTABLE_INDEX

    # the index is process-wide: emptied, the fused unit's entries are built
    # by inlining here, as the trace checks expect, not taken from the
    # TinyTorchBackend serve phase's
    EXECUTABLE_INDEX.clear()
    tokens: list = []
    serve = serve_phase(torch, dev, cfg, params=params, backend="orchestrated", tokens_out=tokens,
                        **(serve_kw or {}))
    check(len(tokens) == len(tiny_tokens) and all(torch.equal(a, b) for a, b in zip(tokens, tiny_tokens)),
          "orchestrated: tokens differ from TinyTorchBackend's for the same prompts")
    pods = serve["pods"]
    if dev.type == "cuda":
        check(pods["fused"]["captures_on_pods"] > 0 and pods["unfused"]["captures_on_pods"] > 0,
              f"orchestrated: no graph was captured on a pod: {pods}")
    serve["tokens_identical_to_tinytorch"] = True
    serve["p50_token_ms_tinytorch"] = tiny_serve["p50_token_ms"]
    serve.pop("dispatch", None)
    batched = batched_phase(torch, dev, cfg, params=params, backend="orchestrated", overhead=False,
                            **(batched_kw or {}))
    return {"serve": serve, "batched": batched, "hop": hop_cost(torch, dev)}


HOP_CALLS = 2000


def hop_cost(torch, dev) -> dict:
    """What a pod hop adds on this host: the p50 of ``invoke`` of a one-op
    function on a 4-element tensor on ``dev`` (its run ends in a device
    sync) on each backend, after 50 untimed calls (host clock)."""
    from repro_torch.core import FunctionSpec, FusionPolicy

    x = torch.ones(4, device=dev)
    out = {}
    for name in BACKENDS:
        platform = backend_class(name)(FusionPolicy(enabled=False))
        try:
            platform.deploy(FunctionSpec("f", lambda ctx, params, v: v + 1, None))
            lat = []
            for i in range(50 + HOP_CALLS):
                t0 = time.perf_counter()
                platform.invoke("f", x)
                if i >= 50:
                    lat.append(time.perf_counter() - t0)
        finally:
            platform.shutdown()
        out[name] = statistics.median(lat) * 1e3
    return {"invoke_p50_ms": out, "hop_ms": out["orchestrated"] - out["tinytorch"], "calls": HOP_CALLS}


# The replicas scenario: benchmarks/load_bench.py's run_replicas (:691).
REPLICA_IO_WAIT_S = 0.005  # the hot handler's downstream wait, on the host
REPLICA_CLIENTS = 8
REPLICA_STRICT_MS = 250.0
REPLICA_STRICT_RPS = 10.0
REPLICA_SPEEDUP_MIN = 1.5
REPLICA_AUTOSCALE = dict(rho_high=0.35, rho_low=0.05, sustain=2, max_replicas=3, cooldown_s=0.25,
                         eval_interval_s=0.05)
REPLICA_IDLE_S = 1.0  # lanes retire after this long idle, so rho falls to 0 once the load stops
SCALE_IN_WAIT_S = 20.0
REPLICA_GROWTH_MAX = 0.5e9  # bytes of device memory a replica of the fused llama unit may add


def replica_scenario(torch, dev, duration: float = 4.0, ramp: float = 1.5, gate: bool = True) -> dict:
    """``load_bench``'s replicas gate through the port on ``dev``: a hot
    handler of eager compute on the device, a host wait (the downstream RPC)
    and a boundary call; 8 shape-distinct closed-loop clients and a strict
    class (250 ms p95, 10 requests/s) on one ``OrchestratedBackend``. Run A:
    one instance; run B: ``autoscale_config``. Checks: every future
    resolves; the strict class meets its target in both runs; in run B a
    scale-out happened, every scale-out is warm, the dispatch tracer (armed
    through run B) saw no new entry, capture or bucket, spread picks landed
    on at least 2 replicas; once the load stops, scale-in returns the set to
    1 replica and the retired replicas' pods exit; with ``gate``, run B
    delivers at least 1.5x run A's requests/s."""
    import numpy as np

    from repro_torch.analysis.dispatch import TRACER
    from repro_torch.core import FunctionSpec, FusionPolicy
    from repro_torch.scheduler.adaptive import AdaptiveConfig
    from repro_torch.scheduler.metrics import percentiles_ms
    from repro_torch.scheduler.slo import SLOClass

    Backend = backend_class("orchestrated")
    strict = SLOClass("gold", REPLICA_STRICT_MS)
    w = torch.from_numpy(np.random.RandomState(0).randn(64, 64).astype(np.float32) * 0.05).to(dev)
    lane_xs = [torch.ones(4 + lane, 64, device=dev) for lane in range(REPLICA_CLIENTS)]
    x_strict = torch.ones(3, 64, device=dev)

    def fn_hot(ctx, params, x):
        y = torch.tanh(x @ params)  # eager local compute on the device
        time.sleep(REPLICA_IO_WAIT_S)  # the downstream RPC's network wait
        return ctx.call("downstream", y)  # boundary: keeps the entry eager

    def fn_downstream(ctx, params, x):
        return x + 1.0

    def build(autoscale: bool):
        platform = Backend(FusionPolicy(enabled=False), max_batch=4, max_delay_ms=2.0, adaptive=True,
                           adaptive_config=AdaptiveConfig(max_delay_s=0.002), be_shed_depth=10**6,
                           autoscale=autoscale, autoscale_config=REPLICA_AUTOSCALE if autoscale else None)
        platform.scheduler.idle_timeout_s = REPLICA_IDLE_S
        platform.deploy(FunctionSpec("downstream", fn_downstream, None))
        platform.deploy(FunctionSpec("hot", fn_hot, w))
        # every program the run touches: each shape's downstream entry run
        # twice (its first run eager, its second captured on the card)
        for _ in range(2):
            for x in (*lane_xs, x_strict):
                platform.invoke("hot", x)
        return platform

    def drive(platform, span_s: float) -> dict:
        strict_lats: list = []
        lock = threading.Lock()
        counts = [0] * REPLICA_CLIENTS
        errors: list = []
        t_end = time.perf_counter() + span_s

        def be_client(cid: int):
            try:
                while time.perf_counter() < t_end:
                    platform.invoke_async("hot", lane_xs[cid]).result(timeout=120)
                    counts[cid] += 1
            except Exception as exc:  # noqa: BLE001 — reported through the check below
                errors.append(exc)

        def strict_client():
            futs = []
            while time.perf_counter() < t_end:
                t_s = time.perf_counter()
                fut = platform.invoke_async("hot", x_strict, slo=strict)

                def cb(_fut, t_submit=t_s):
                    with lock:
                        strict_lats.append(time.perf_counter() - t_submit)

                fut.add_done_callback(cb)
                futs.append(fut)
                time.sleep(1.0 / REPLICA_STRICT_RPS)
            try:
                for f in futs:
                    f.result(timeout=120)
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)

        threads = [threading.Thread(target=be_client, args=(i,)) for i in range(REPLICA_CLIENTS)]
        threads.append(threading.Thread(target=strict_client))
        t0 = time.perf_counter()
        with GCPauses() as pauses:
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        elapsed = time.perf_counter() - t0
        check(not errors, f"replicas: requests failed: {errors[:3]}")
        return {"requests": sum(counts), "elapsed_s": elapsed, "requests_per_s": sum(counts) / elapsed,
                "strict_requests": len(strict_lats),
                "strict_p95_ms": percentiles_ms(strict_lats)["p95_ms"] if strict_lats else 0.0,
                "strict_slowest_ms": sorted(x * 1e3 for x in strict_lats)[-3:], "gc": pauses.summary()}

    heap = {"single_instance": collected_heap()}
    platform = build(autoscale=False)
    try:
        base = drive(platform, duration)
        check(platform.registry.replica_count("hot") == 1, "replicas: run A grew a replica")
    finally:
        platform.shutdown()

    heap["autoscaled"] = collected_heap()
    platform = build(autoscale=True)
    pods = watch_pods(platform)
    armed = False
    try:
        tr0 = TRACER.snapshot()
        TRACER.arm()
        armed = True
        drive(platform, ramp)  # unmeasured: the autoscaler acts in here
        peak = platform.registry.replica_count("hot")
        check(peak >= 2, f"replicas: the autoscaler never scaled out (replicas {peak})")
        auto = drive(platform, duration)
        spin = TRACER.delta(tr0)
        TRACER.disarm()
        armed = False
        info = platform.stats()["replicas"]["functions"]["hot"]
        scale_outs = [e for e in platform.provisioning_stats()["events"] if e["kind"] == "scale-out"]
        peak = max(peak, len(info["replicas"]))
        t0 = time.perf_counter()
        while platform.registry.replica_count("hot") > 1 and time.perf_counter() - t0 < SCALE_IN_WAIT_S:
            time.sleep(0.05)
        scale_in_s = time.perf_counter() - t0
        check(platform.registry.replica_count("hot") == 1,
              f"replicas: scale-in left {platform.registry.replica_count('hot')} replicas after {scale_in_s:.1f} s")
        platform.lifecycle.wait_idle(10.0)
        scale_ins = [e for e in platform.lifecycle.events if e.kind == "scale-in"]
        pod_line = pod_check(platform, pods, "replicas")
        spinup_s = platform.replica_spinup_estimate()
    finally:
        if armed:
            TRACER.disarm()
        platform.shutdown()
    check(scale_outs and all(e["warm"] for e in scale_outs), f"replicas: a scale-out was not warm: {scale_outs}")
    check(spin.entries == 0 and spin.captures == 0 and spin.buckets == 0,
          f"replicas: the scale-outs made new programs: {spin}")
    busy = [iid for iid, n in info["picks"].items() if n > 0]
    check(len(busy) >= 2, f"replicas: spread never fanned out: picks {info['picks']}")
    for label, res in (("single instance", base), ("autoscaled", auto)):
        check(res["strict_p95_ms"] <= REPLICA_STRICT_MS,
              f"replicas: {label} strict p95 {res['strict_p95_ms']:.1f} ms over {REPLICA_STRICT_MS} ms")
    ratio = auto["requests_per_s"] / base["requests_per_s"]
    if gate:
        check(ratio >= REPLICA_SPEEDUP_MIN, f"replicas: autoscaled {ratio:.2f}x the single instance, "
              f"under {REPLICA_SPEEDUP_MIN}x")
    return {"single_instance": base, "autoscaled": auto, "speedup": ratio, "peak_replicas": peak,
            "picks": info["picks"], "scale_outs": len(scale_outs), "scale_outs_warm": True,
            "scale_out_s": [e["seconds"] for e in scale_outs], "spinup_estimate_s": spinup_s,
            "dispatch_window": {"entries": spin.entries, "captures": spin.captures, "buckets": spin.buckets,
                                "cuda_syncs": spin.cuda_syncs},
            "scale_ins": len(scale_ins), "scale_in_s": scale_in_s, "pods": pod_line,
            "strict_target_ms": REPLICA_STRICT_MS, "io_wait_s": REPLICA_IO_WAIT_S,
            "autoscale_config": REPLICA_AUTOSCALE, "heap": heap}


def pinned_spread():
    """A spread policy whose every pick is replica ``index`` of the set (so
    that each replica of a unit can be driven on its own)."""
    from repro_torch.core.registry import SpreadPolicy

    class Pinned(SpreadPolicy):
        name = "pinned"
        index = 0

        def select(self, name, replicas):
            return replicas[min(self.index, len(replicas) - 1)]

    return Pinned()


def chain_prompts(torch, dev, cfg, prompt_lens):
    """The serve phase's prompts (seed 7)."""
    gen = torch.Generator(device=dev).manual_seed(7)
    return [torch.randint(0, cfg.vocab_size, (1, t), generator=gen, device=dev, dtype=torch.int32)
            for t in prompt_lens]


def allocated(torch, dev) -> int:
    """Device bytes allocated once the cyclic collector ran and the cache
    let go of free segments (0 on the CPU)."""
    import gc

    gc.collect()  # the platforms of earlier phases hold reference cycles
    if dev.type != "cuda":
        return 0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def fuse_chain(torch, engine, prompts, new_tokens: int, label: str) -> dict:
    """The serve phase's prompts until the chain is one unit, then the first
    prompt once more: the chain fuses during the first prompt's decode
    steps, so only then has every request shape of the prompts run on the
    fused unit (and its entries are in the executable index). Returns
    :func:`serve_prompts`'s result."""
    run = serve_prompts(torch, engine, prompts, new_tokens)
    check(len(engine.platform.registry.live_instances()) == 1, f"{label}: the chain did not fuse to one instance")
    check(torch.equal(timed_generate(torch, engine, prompts[0], new_tokens)[0], run["tokens"][0]),
          f"{label}: the fused unit's tokens differ from the fusing run's")
    return run


def replicated_unit(torch, dev, cfg, params, prompt_lens=PROMPT_LENS, new_tokens=NEW_TOKENS,
                    max_len=MAX_LEN) -> dict:
    """The fused llama unit replicated on ``OrchestratedBackend``: the chain
    fused by the serve phase's prompts, then ``request_replica`` (the policy's
    replicate arm's hint) and one autoscaler scale-out of the whole unit; a
    pinned spread then drives each replica alone through the same prompts.
    Checks: the replica serves every name of the chain; its spin-up stamped
    no demand and billed no invocation; no new entry or bucket from the
    spin-up on (the replica's own captures counted and reported); both
    replicas' tokens identical to the unreplicated unit's; each kernel
    launched exactly as the prefills, decode steps and the spin-up's canary
    runs (once each, from the member down) make it; on the card allocated
    memory grew by less than REPLICA_GROWTH_MAX (the weights are the
    specs' own tensors, never copied; measured after the spin-up and after
    both replicas served, their own graphs captured). Reports the spin-up
    seconds beside the merge seconds (the replicate arm's two inputs) and
    ``ram_bytes``, which counts a replica's weights again, as the
    reference's ``resident_bytes`` does, beside the device's bytes."""
    from repro_torch.analysis.dispatch import TRACER
    from repro_torch.core import FusionPolicy
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ServingEngine

    cuda = dev.type == "cuda"
    model = build_model(cfg)
    prompts = chain_prompts(torch, dev, cfg, prompt_lens)
    spread = pinned_spread()
    platform = backend_class("orchestrated")(
        FusionPolicy(**SERVE_POLICY), spread=spread, autoscale=True,
        # no organic scaling: only the hint below scales out
        autoscale_config=dict(rho_high=float("inf"), rho_low=-1.0, max_replicas=2, cooldown_s=0.0))
    replays = record_replays(platform)
    pods = watch_pods(platform)
    try:
        engine = ServingEngine(model, platform, max_len=max_len, params=params, device=dev)
        names = engine.chain_names()
        before = fuse_chain(torch, engine, prompts, new_tokens, "replica")
        (unit,) = platform.registry.live_instances()
        merges = [m for m in platform.merger.merge_log if m.healthy]
        demand: list = []
        note = platform.handler.note_demand

        def note_demand(fn):
            demand.append(fn)
            note(fn)

        platform.handler.note_demand = note_demand
        records0 = len(platform.meter.records)
        alloc0 = allocated(torch, dev)
        n_rep = len(replays)
        ops.reset_counts()
        base = TRACER.snapshot()
        TRACER.arm()
        try:
            platform.request_replica(engine.entry, reason="replicate the fused unit")
            t0 = time.perf_counter()
            while platform.registry.replica_count(engine.entry) < 2 and time.perf_counter() - t0 < 120.0:
                time.sleep(0.01)
            check(all(platform.registry.replica_count(n) == 2 for n in names),
                  f"replica: the scale-out did not reach every name: {platform.registry.replica_summary()}")
            replica = platform.registry.replicas(engine.entry)[1]
            spawn = TRACER.delta(base)
            alloc_spawned = allocated(torch, dev)
            ram = {"one_unit": unit.resident_bytes(), "two_units": platform.ram_bytes()}
            check(not demand and len(platform.meter.records) == records0,
                  f"replica: the spin-up stamped demand {demand} or billed {len(platform.meter.records) - records0}")
            replays[n_rep:] = [(m, p, 1) for m, p, _ in replays[n_rep:]]  # a spin-up canary runs once
            tokens = {}
            for i in (0, 1):
                spread.index = i
                tokens[i] = [timed_generate(torch, engine, p, new_tokens)[0] for p in prompts]
        finally:
            TRACER.disarm()
        window = TRACER.delta(base)
        counts = ops.counts()
        alloc1 = allocated(torch, dev)
        picks = platform.registry.replica_summary()[engine.entry]["picks"]
        prov = [r for r in platform.meter.provisioning if r.kind == "scale-out"]
        replica_graphs = sum(g["captured"] for g in replica.graph_stats())
        spinup_s = platform.replica_spinup_estimate()
        pod_line = pod_check(platform, pods, "replica")
    finally:
        platform.shutdown()
    for i in (0, 1):
        check(all(torch.equal(a, b) for a, b in zip(before["tokens"], tokens[i])),
              f"replica: replica {i}'s tokens differ from the unreplicated unit's")
    check(picks.get(unit.instance_id, 0) > 0 and picks.get(replica.instance_id, 0) > 0,
          f"replica: the picks did not reach both replicas: {picks}")
    check(len(prov) == 1 and prov[0].warm, f"replica: the spin-up is not one warm scale-out: {prov}")
    check(spawn.entries == 0 and spawn.buckets == 0 and window.entries == 0 and window.buckets == 0,
          f"replica: new entries or buckets from the spin-up on: {window}")
    runs = len(prompts) * 2
    expected = expected_launches(cfg, engine, runs, runs * (new_tokens - 1), replays[n_rep:])
    for k, want in expected.items():
        if cuda:
            check(counts[k] == want, f"replica: {k} launched {counts[k]} times, the run makes {want}")
        elif k in STAND_INS:
            check(counts[STAND_INS[k]] == want, f"replica: {STAND_INS[k]} ran {counts[STAND_INS[k]]} times for {want}")
    if cuda:
        check(all(counts[k] == 0 for k in PLAIN), f"replica: a plain version ran on the card: {counts}")
        check(alloc1 - alloc0 < REPLICA_GROWTH_MAX,
              f"replica: allocated memory grew by {alloc1 - alloc0} B with the replica")
    merge_s = [m.build_s for m in merges]
    return {"chain": names, "replicas": 2, "picks": picks, "tokens_identical": True,
            "spinup_s": spinup_s, "merge_s": merge_s, "spinup_over_merge_s": spinup_s / sum(merge_s),
            "spinup_demand": 0, "spinup_billed_invocations": 0, "scale_out_warm": prov[0].warm,
            "spinup_canary_runs": len(replays) - n_rep, "spinup_window": {"entries": spawn.entries,
                                                                          "captures": spawn.captures},
            "replica_captures": replica_graphs, "window_captures": window.captures,
            "launches": {k: counts[k] for k in ("flash_attention", "decode_attention")},
            "expected_launches": expected, "allocated_growth_bytes": alloc1 - alloc0,
            "allocated_growth_at_spinup_bytes": alloc_spawned - alloc0, "ram_bytes": ram,
            "pods": pod_line}


def replicas_phase(torch, dev, cfg, params, scenario_kw=None, unit_kw=None) -> dict:
    """The ``replicas`` line: :func:`replica_scenario` (``load_bench``'s
    replicas gate through the port) and :func:`replicated_unit` (the fused
    llama unit with a second replica)."""
    return {"scenario": replica_scenario(torch, dev, **(scenario_kw or {})),
            "fused_unit": replicated_unit(torch, dev, cfg, params, **(unit_kw or {}))}


def collected_heap() -> dict:
    """One full pass of the cyclic collector, which frees the earlier runs'
    shut-down platforms (each is a web of reference cycles, as in the
    reference: its instances, merger, control plane and scheduler point
    back at it), then a second, timed pass over what is left. Nothing is
    frozen: a pass of the oldest generation during the next run traverses
    this whole heap, and :class:`GCPauses` reports it."""
    import gc

    t0 = time.perf_counter()
    freed = gc.collect()
    t1 = time.perf_counter()
    gc.collect()
    t2 = time.perf_counter()
    return {"garbage_objects": freed, "garbage_pass_ms": (t1 - t0) * 1e3, "live_objects": len(gc.get_objects()),
            "full_pass_ms": (t2 - t1) * 1e3}


# The churn scenario: benchmarks/load_bench.py's run_churn (:292).
CHURN_TARGET_BATCH_S = 0.080  # H's batch of 4 on the device, as the reference calibrates it
CHURN_RATE_L = 100.0
CHURN_RECOVERY_MIN = 1.3  # the reference's full-run gate
CHURN_SETTLE_S = 0.5
CHURN_POLICY = dict(min_observations=2, merge_cost_s=0.0, split_occupancy=0.3, split_depth=10, split_sustain=3,
                    min_group_age_s=0.5, remerge_backoff_s=300.0)


def churn_phase(torch, dev, width: int = 2048, rows: int = 512, duration: float = 4.0,
                target_batch_s: float = CHURN_TARGET_BATCH_S, gate: bool = True) -> dict:
    """``load_bench``'s churn scenario on ``OrchestratedBackend``: a chain H
    -> L fused on serial traffic (the merge queued on the reconciler), then
    open-loop direct traffic on both: H at 1.6x the fused pod's measured
    capacity, L at 100 requests/s starving behind it, until the regret check
    splits the group (or a bound). H's loop runs on the device, calibrated to
    ``target_batch_s`` per batch of 4 as the reference does. Its width: the
    reference's 256-wide body needs some 20,000 graph nodes for 80 ms on the
    card, so the card runs 2048 wide over 512 rows (a few hundred
    iterations). Checks: the merge and the split both happened and the
    split's regret reason is recorded, every future resolved (none failed or
    hung), the split landed while traffic was still offered, the pods match
    the units; with ``gate``, L's delivered requests/s after the split at
    least 1.3x before it."""
    from concurrent.futures import TimeoutError as FuturesTimeout

    import numpy as np

    from repro_torch.core import FunctionSpec, FusionPolicy

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    scale = 0.05 * (256 / width) ** 0.5  # the reference's gain at its width
    wh = torch.from_numpy(np.random.RandomState(0).randn(width, width).astype(np.float32) * scale).to(dev)
    wl = torch.from_numpy(np.random.RandomState(1).randn(width, width).astype(np.float32) * scale).to(dev)
    probe_iters = 20
    xb = torch.ones(4, rows, width, device=dev)

    def probe():
        h = xb
        for _ in range(probe_iters):
            h = torch.tanh(h @ wh)
        sync()

    probe()
    trials = []
    for _ in range(3):  # best of 3: contention only ever adds time
        t0 = time.perf_counter()
        probe()
        trials.append(time.perf_counter() - t0)
    probe_s = max(min(trials), 1e-4)
    heavy_iters = max(4, int(probe_iters * target_batch_s / probe_s))

    def fn_h(ctx, params, x):
        for _ in range(heavy_iters):
            x = torch.tanh(x @ params)
        return ctx.call("L", x)

    def fn_l(ctx, params, x):
        return torch.tanh(x @ params)

    platform = backend_class("orchestrated")(
        FusionPolicy(**CHURN_POLICY), max_batch=4, max_delay_ms=2.0, adaptive=True,
        fission=True, fission_interval_s=0.1, trough_merges=True, max_defer_s=1.0)
    pods = watch_pods(platform)
    try:
        platform.deploy(FunctionSpec("H", fn_h, wh))
        platform.deploy(FunctionSpec("L", fn_l, wl))
        x = torch.ones(rows, width, device=dev)
        # --- phase 1: a hot sync chain; the reconciler lands the merge
        for _ in range(4):
            platform.invoke("H", x)
        platform.merger.wait_idle()
        merges = [m for m in platform.merger.merge_log if m.healthy]
        check(merges and set(merges[-1].members) == {"H", "L"}, f"churn: phase 1 did not fuse H and L: {merges}")
        # warm the fused unit's buckets (a bucket's first run is eager, its
        # second captured), then size the overload on warm batches
        for _ in range(2):
            for name in ("H", "L"):
                for f in [platform.invoke_async(name, x) for _ in range(4)]:
                    f.result(timeout=120)
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            for f in [platform.invoke_async("H", x) for _ in range(4)]:
                f.result(timeout=120)
            walls.append(time.perf_counter() - t0)
        capacity_rps = 4.0 / max(min(walls), 1e-3)
        rate_h = min(300.0, max(20.0, 1.6 * capacity_rps))
        platform.scheduler.reset_stats()

        # --- phase 2: concurrent direct traffic; H oversubscribes the fused pod
        done: list = []
        done_lock = threading.Lock()
        failures: list = []

        def stamp(name):
            def cb(fut):
                exc = fut.exception()
                t = time.perf_counter()
                with done_lock:
                    (failures.append(exc) if exc is not None else done.append((name, t)))
            return cb

        pending = []
        t0 = time.perf_counter()
        next_h = next_l = 0.0
        hard_cap = duration + 4.0
        split_seen_at = None
        while True:
            now = time.perf_counter() - t0
            if split_seen_at is None and any(e.healthy for e in platform.merger.split_log):
                split_seen_at = now
            if now >= hard_cap or (split_seen_at is not None and now >= max(duration, split_seen_at + 1.5)):
                break
            if now >= next_h:
                fut = platform.invoke_async("H", x)
                fut.add_done_callback(stamp("H"))
                pending.append(fut)
                next_h += 1.0 / rate_h
            if now >= next_l:
                fut = platform.invoke_async("L", x)
                fut.add_done_callback(stamp("L"))
                pending.append(fut)
                next_l += 1.0 / CHURN_RATE_L
            time.sleep(max(0.0, min(next_h, next_l) - (time.perf_counter() - t0)))
        t_submit_end = time.perf_counter()
        hung = 0
        wait_deadline = time.perf_counter() + 120.0
        for fut in pending:
            try:
                fut.result(timeout=max(0.0, wait_deadline - time.perf_counter()))
            except FuturesTimeout:
                hung += 1
            except Exception:  # noqa: BLE001 — counted by the done-callback
                pass
        deadline = time.perf_counter() + 5.0
        while time.perf_counter() < deadline:
            with done_lock:
                if len(done) + len(failures) >= len(pending):
                    break
            time.sleep(0.001)
        splits = [e for e in platform.merger.split_log if e.healthy]
        epoch = platform.lifecycle.epoch
        platform.lifecycle.wait_idle(10.0)
        pod_line = pod_check(platform, pods, "churn")
    finally:
        platform.shutdown()
    check(splits, "churn: phase 2 did not split the saturated fused group")
    check(not failures, f"churn: requests failed across epoch transitions: {failures[:3]}")
    check(hung == 0, f"churn: {hung} requests hung across epoch transitions")
    split_t = splits[0].t_completed
    check(split_t < t_submit_end, "churn: the split landed after the traffic ended")
    l_pre = [t for n, t in done if n == "L" and t0 <= t < split_t]
    l_post = [t for n, t in done if n == "L" and split_t + CHURN_SETTLE_S <= t <= t_submit_end]
    pre_rate = len(l_pre) / max(split_t - t0, 1e-9)
    post_rate = len(l_post) / max(t_submit_end - (split_t + CHURN_SETTLE_S), 1e-9)
    recovery = post_rate / max(pre_rate, 1.0)
    if gate:
        check(recovery >= CHURN_RECOVERY_MIN, f"churn: L recovered {recovery:.2f}x, under {CHURN_RECOVERY_MIN}x")
    return {"width": width, "rows": rows, "heavy_iters": heavy_iters, "probe_s": probe_s,
            "capacity_rps": capacity_rps, "rate_h": rate_h, "rate_l": CHURN_RATE_L,
            "requests": len(pending), "failed": 0, "hung": 0,
            "merge_epoch": merges[-1].epoch, "split_epoch": splits[0].epoch, "split_reason": splits[0].reason,
            "split_build_s": splits[0].build_s, "split_at_s": split_t - t0, "epoch": epoch,
            "l_rate_pre_split": pre_rate, "l_rate_post_split": post_rate, "recovery": recovery,
            "pods": pod_line}


def manual_generate(torch, engine, prompt, steps: int, between=None):
    """``engine.generate``'s greedy loop with ``between()`` run after the
    prefill, before the decode steps: (tokens (B, steps))."""
    from repro_torch.serving.engine import _greedy_token

    logits, caches, cur = engine.prefill({"tokens": prompt})
    out = [_greedy_token(logits)]
    if between is not None:
        between()
    for _ in range(steps - 1):
        logits, caches = engine.decode_step(out[-1], cur, caches)
        cur = cur + 1
        out.append(_greedy_token(logits))
    return torch.cat(out, dim=1)


SPLIT_BACKOFF_S = 10.0  # remerge_backoff_s, on the policy's own virtual clock
SPLIT_MEMORY_TOL = 0.5e9  # bytes: allocated after the split vs the two cells' footprint


def split_phase(torch, dev, cfg, params, prompt_lens=PROMPT_LENS, new_tokens=NEW_TOKENS,
                max_len=MAX_LEN) -> dict:
    """Fission of the fused llama unit on ``OrchestratedBackend``: the chain
    fused by the serve phase's prompts, split with ``Merger.split`` into
    ``{embed, g0, g1}`` and ``{g2, g3, head}`` (the first half of the chain
    and the rest), served, then re-merged once ``remerge_backoff_s`` has
    passed on the policy's virtual clock. Checks: the split is healthy and
    the tail cell's self-contained entries passed their health checks
    against the fused unit's canaries (the head cell's entries all call
    across the cells, so, as in the reference, there is nothing of it to
    replay); the fused unit retired and its pod exited; tokens identical
    before the split, after it and after the re-merge; a re-merge decision
    inside the backoff is refused as "recently split" and traffic there
    fuses nothing; on the card, after the split, allocated memory within
    SPLIT_MEMORY_TOL of the two cells' footprint and no segment of the
    fused unit's graph pool left (``torch.cuda.memory_snapshot``); the
    re-merge warm with no new entry or bucket; each kernel launched exactly
    as the run's prefills, decode steps, merge canaries and the split's
    health checks (twice each) make it."""
    from repro_torch.analysis.dispatch import TRACER
    from repro_torch.core import FusionPolicy, InstanceState
    from repro_torch.core.function import INSTANCE_RUNTIME_OVERHEAD_BYTES, tree_bytes
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.scheduler.clock import VirtualClock
    from repro_torch.serving.engine import ServingEngine

    cuda = dev.type == "cuda"
    model = build_model(cfg)
    prompts = chain_prompts(torch, dev, cfg, prompt_lens)
    policy_clock = VirtualClock()
    platform = backend_class("orchestrated")(
        FusionPolicy(**SERVE_POLICY, remerge_backoff_s=SPLIT_BACKOFF_S, clock=policy_clock))
    replays = record_replays(platform)
    pods = watch_pods(platform)
    base_alloc = allocated(torch, dev)
    ops.reset_counts()
    try:
        engine = ServingEngine(model, platform, max_len=max_len, params=params, device=dev)
        names = engine.chain_names()
        fused_run = fuse_chain(torch, engine, prompts, new_tokens, "split")
        (fused,) = platform.registry.live_instances()
        pool = fused._graph_pool
        n = len(names) // 2
        cells = [frozenset(names[:n]), frozenset(names[n:])]
        n_rep = len(replays)
        prefill_canary = {m: canary_is_prefill(platform.handler.canary(m)) for m in names}
        t0 = time.perf_counter()
        event = platform.merger.split(frozenset(names), cells, reason="split the fused llama unit")
        split_s = time.perf_counter() - t0
        del replays[n_rep:]  # the fetches above and the split's: counted from its event
        check(event is not None and event.healthy, f"split: the split is not healthy: {event}")
        check(fused.state == InstanceState.RETIRED, f"split: the fused unit is {fused.state.value}")
        live = platform.registry.live_instances()
        check(sorted(sorted(i.members) for i in live) == sorted(sorted(c) for c in cells),
              f"split: live units {[sorted(i.members) for i in live]} are not the cells")
        split_tokens = [timed_generate(torch, engine, p, new_tokens)[0] for p in prompts]
        check(len(platform.registry.live_instances()) == 2, "split: traffic inside the backoff re-merged")
        a, b = names[n - 1], names[n]  # the edge across the cells
        refused = platform.policy.decide(a, b, platform.handler.edges[(a, b)], platform.spec_of(a).trust_domain,
                                         platform.spec_of(b).trust_domain)
        check(not refused.fuse and "recently split" in refused.reason,
              f"split: a re-merge inside the backoff was not refused as recently split: {refused}")
        split_alloc = allocated(torch, dev)
        cells_bytes = sum(inst.resident_bytes() - INSTANCE_RUNTIME_OVERHEAD_BYTES - tree_bytes(inst.params)
                          for inst in live)
        pool_left = [seg["total_size"] for seg in torch.cuda.memory_snapshot()
                     if pool is not None and tuple(seg.get("segment_pool_id") or ()) == tuple(pool)] if cuda else []
        n_merges = len(platform.merger.merge_log)
        base = TRACER.snapshot()
        TRACER.arm()
        try:
            # the re-merge: a prefill inside the backoff, then the decode
            # steps once it has passed (the merge's canaries are decode
            # steps, as the first fusion's were)
            remerge_tokens = [manual_generate(torch, engine, prompts[0], new_tokens,
                                              between=lambda: policy_clock.advance(SPLIT_BACKOFF_S + 1.0))]
            platform.merger.wait_idle()
            remerge_tokens += [timed_generate(torch, engine, p, new_tokens)[0] for p in prompts]
        finally:
            TRACER.disarm()
        d = TRACER.delta(base)
        counts = ops.counts()
        remerges = [m for m in platform.merger.merge_log[n_merges:] if m.healthy]
        live_after = len(platform.registry.live_instances())
        pod_line = pod_check(platform, pods, "split")
    finally:
        platform.shutdown()
    want = fused_run["tokens"]
    check(all(torch.equal(x, y) for x, y in zip(want, split_tokens)), "split: tokens after the split differ")
    check(torch.equal(want[0], remerge_tokens[0]) and all(torch.equal(x, y) for x, y in zip(want, remerge_tokens[1:])),
          "split: tokens after the re-merge differ")
    check(live_after == 1 and remerges and set(remerges[-1].members) == set(names),
          f"split: the chain did not re-merge after the backoff: {remerges}")
    check(all(m.warm for m in remerges) and d.entries == 0 and d.buckets == 0,
          f"split: the re-merge is not warm or made new entries: {[m.warm for m in remerges]}, {d}")
    prefills = 3 * len(prompts) + 2  # fusing, the split, the re-merge; prompt 0 twice more
    expected = expected_launches(cfg, engine, prefills, prefills * (new_tokens - 1),
                                 replays + [(m, prefill_canary[m], 2) for m in event.checked_members])
    for k, want_n in expected.items():
        if cuda:
            check(counts[k] == want_n, f"split: {k} launched {counts[k]} times, the run makes {want_n}")
        elif k in STAND_INS:
            check(counts[STAND_INS[k]] == want_n, f"split: {STAND_INS[k]} ran {counts[STAND_INS[k]]} times for {want_n}")
    held = split_alloc - base_alloc
    if cuda:
        check(all(counts[k] == 0 for k in PLAIN), f"split: a plain version ran on the card: {counts}")
        check(not pool_left, f"split: segments of the fused unit's graph pool are left: {pool_left}")
        check(abs(held - cells_bytes) <= SPLIT_MEMORY_TOL,
              f"split: {held} B allocated beside the weights after the split, the cells count {cells_bytes} B")
    return {"chain": names, "cells": [sorted(c) for c in cells], "healthy": True,
            "checked_members": list(event.checked_members), "split_s": split_s, "split_build_s": event.build_s,
            "split_warm": event.warm, "tokens_identical": True, "refused_reason": refused.reason,
            "allocated_beside_weights_bytes": held, "cells_counted_bytes": cells_bytes,
            "fused_pool_segments_left": len(pool_left),
            "remerge_build_s": [m.build_s for m in remerges], "remerge_warm": True,
            "remerge_window": {"entries": d.entries, "captures": d.captures, "buckets": d.buckets},
            "launches": {k: counts[k] for k in ("flash_attention", "decode_attention")},
            "expected_launches": expected, "pods": pod_line}


# -------------------------------------------------------------- KV arena stress

KV_STRESS_PROMPTS = ((0, 9), (0, 12), (100, 6), (100, 17), (200, 4))  # tests/test_kvpool.py:310-311
KV_STRESS_JOIN_S = 60.0  # a stress thread must have finished within this
KV_STRESS_BUDGET_S = 10.0  # the card's stress runs rounds for about this long


def _kv_value(tok: int, pos: int) -> float:
    """The K value a prefill writes at ``pos`` for prompt token ``tok`` (V is
    its negative): a function of the token and the position only, so that
    every prompt sharing a prefix writes the same values into the pages it
    shares, and a page served from the prefix cache holds what its holder
    would have written."""
    return float(tok + 1000 * pos)


def _kv_decode_value(tid: int, op: int, pos: int) -> float:
    """The K value a decode write of thread ``tid``'s op ``op`` puts at
    ``pos`` (exact in float32; no prefill writes it)."""
    return float(1_000_000 + 100_000 * tid + 1000 * op + pos)


def kvpool_stress(torch, dev, rounds: int = 3, ops: int = 40, threads: int = 3, budget_s: float = 0.0) -> dict:
    """The reference's concurrent sharing fuzz (``tests/test_kvpool.py:296``)
    on a float32 ``KVArena`` on ``dev``, made under ``patched_locks``, so its
    two locks record their acquisition order. ``threads`` threads storm the
    arena for ``rounds`` rounds (more while ``budget_s`` seconds have not
    passed) of ``ops`` operations each: content-aware ``alloc_prefill`` of a
    shared prompt pool with ``write_prefill`` and ``commit_prefill``,
    ``extend`` followed by decode writes (``make_private`` of the position,
    then the row written in place through the block table, as a decode
    step writes it), ``gather``, ``make_private`` and ``free``. The arena's
    pages are written in place, so the data is checked too: every gather
    of a live sequence (during the storm, and at each thread's end before
    and after all threads finish their operations) equals what a replay of
    that sequence's own writes gives — its prompt's values below its prompt
    length, whoever wrote the shared pages, and its own decode writes past
    it. After each round: every thread joined within KV_STRESS_JOIN_S, no
    error, ``check_consistency``, an acyclic lock graph; after all, no page
    held and every page but the scratch page free."""
    import random

    from repro_torch.analysis.lockorder import LockGraph, patched_locks
    from repro_torch.serving.kvpool import ArenaFull, KVArena

    graph = LockGraph()
    with patched_locks(graph):
        arena = KVArena({"g0": 2, "g1": 2}, num_pages=32, page_size=4, kv_heads=2, head_dim=4,
                        dtype=torch.float32, device=dev)
    prompts = [list(range(s, s + n)) for s, n in KV_STRESS_PROMPTS]
    ps = arena.page_size
    errors: list = []
    verified = [0] * threads

    def verify(tid: int, sid, expect: dict) -> None:
        for stage in arena.data:
            got = arena.gather(sid, stage)
            k, v = got["k"].cpu(), got["v"].cpu()
            for pos, val in expect.items():
                check(bool((k[:, pos] == val).all()) and bool((v[:, pos] == -val).all()),
                      f"kvpool_stress: {sid} stage {stage} position {pos}: K {k[:, pos].flatten()[:4].tolist()} "
                      f"V {v[:, pos].flatten()[:4].tolist()}, want +-{val}")
        verified[tid] += len(expect)

    def decode_write(sid, pos: int, val: float) -> bool:
        try:
            arena.make_private(sid, pos)
        except ArenaFull:
            return False
        page = int(arena.block_row(sid, arena.pages_held(sid))[pos // ps])
        for stage in arena.data.values():
            stage["k"][:, page, pos % ps] = val
            stage["v"][:, page, pos % ps] = -val
        return True

    def worker(tid: int, rnd: int, done: threading.Barrier) -> None:
        rng = random.Random(1000 + tid + 100 * rnd)
        live: dict = {}  # seq id -> (length, {position: K value}); only this thread touches its ids
        try:
            for i in range(ops):
                op = rng.random()
                if op < 0.35 and len(live) < 4:
                    sid = (rnd, tid, i)
                    prompt = rng.choice(prompts)
                    try:
                        arena.alloc_prefill(sid, prompt)
                    except ArenaFull:
                        continue
                    span = arena.pages_for(len(prompt)) * ps
                    col = torch.tensor([_kv_value(t, p) for p, t in enumerate(prompt)] + [0.0] * (span - len(prompt)),
                                       dtype=torch.float32, device=dev)
                    src = col[None, None, :, None, None].expand(2, 1, span, 2, 4)
                    arena.write_prefill(sid, {s: {"k": src, "v": -src} for s in arena.data}, len(prompt))
                    arena.commit_prefill(sid)
                    live[sid] = (len(prompt), {p: _kv_value(t, p) for p, t in enumerate(prompt)})
                elif op < 0.55 and live:
                    sid = rng.choice(list(live))
                    length, expect = live[sid]
                    new_len = length + rng.randint(1, 6)
                    try:
                        arena.extend(sid, new_len)
                    except ArenaFull:
                        continue
                    for pos in range(length, new_len):
                        val = _kv_decode_value(tid, i, pos)
                        if decode_write(sid, pos, val):
                            expect[pos] = val
                    live[sid] = (new_len, expect)
                elif op < 0.7 and live:
                    sid = rng.choice(list(live))
                    verify(tid, sid, live[sid][1])
                elif op < 0.85 and live:
                    sid = rng.choice(list(live))
                    try:
                        arena.make_private(sid, live[sid][0] - 1)
                    except ArenaFull:
                        pass
                elif live:
                    sid = rng.choice(list(live))
                    live.pop(sid)
                    arena.free(sid)
            for sid, (_, expect) in live.items():
                verify(tid, sid, expect)
            done.wait(timeout=KV_STRESS_JOIN_S)  # every thread's operations are over
            for sid, (_, expect) in live.items():
                verify(tid, sid, expect)
        except BaseException as exc:  # noqa: BLE001 — surfaced by the main thread
            errors.append(exc)
            done.abort()
        finally:
            for sid in live:
                arena.free(sid)

    t0 = time.perf_counter()
    done_rounds = 0
    while done_rounds < rounds or time.perf_counter() - t0 < budget_s:
        done = threading.Barrier(threads)
        pool = [threading.Thread(target=worker, args=(t, done_rounds, done), daemon=True) for t in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=KV_STRESS_JOIN_S)
            check(not t.is_alive(), f"kvpool_stress: a thread did not finish within {KV_STRESS_JOIN_S} s")
        check(not errors, f"kvpool_stress round {done_rounds}: {errors[:3]!r}")
        arena.check_consistency()
        graph.assert_acyclic()
        done_rounds += 1
    edges = graph.edges()
    locks = {n for n in edges if n.startswith("kvpool.py:")}
    check(len(locks) == 2, f"kvpool_stress: the arena's two locks did not both record: {sorted(edges)}")
    check(arena.used_pages() == 0 and arena.free_pages() == arena.num_pages - 1,
          f"kvpool_stress: {arena.used_pages()} pages still used, {arena.free_pages()} free")
    return {"device": str(dev), "threads": threads, "rounds": done_rounds, "ops_per_round": ops,
            "seconds": time.perf_counter() - t0, "positions_verified": sum(verified),
            "cow_copies": arena.cow_copies, "shared_hits": arena.shared_hits,
            "lock_edges": {n: sorted(v) for n, v in edges.items() if n in locks}}


# ------------------------------------------------------------------ enc-dec

ENCDEC_ARCH = "seamless-m4t-medium"
ENCDEC_TRAIN_STEPS = 6
ENCDEC_TRAIN_BATCH = 4  # as the config's 4 microbatches of one row (train_4k's global batch cut to the card)
ENCDEC_DECODE_STEPS = 3  # decode steps of the small model, card vs host


def encdec_prompts(model, dev, src_lens) -> list:
    """An enc-dec request per source length, drawn by the model's own
    ``make_inputs`` at a ``prefill`` shape of batch 1: ``src_embeds`` (1, S,
    d) of 0.02 x N(0, 1) frames in bf16 (the stub frontend's) and the
    decoder's first token."""
    from repro_torch.configs.base import ShapeConfig

    return [model.make_inputs(ShapeConfig("source", s, 1, "prefill"), 7 + i, device=dev)
            for i, s in enumerate(src_lens)]


def encdec_model_logits(torch, model, params, prompt, steps: int, fed=None) -> list:
    """The enc-dec model without the platform: ``prefill_fn``, then ``steps``
    ``decode_fn`` steps, each fed ``fed[i]`` or, without ``fed``, the last
    logits' greedy token. Returns every call's logits (steps + 1)."""
    logits, cache = model.prefill_fn(params, prompt)
    out = [logits]
    for i in range(steps):
        tok = fed[i] if fed is not None else torch.argmax(logits, -1)[:, None].to(torch.int32)
        cur = torch.full((tok.shape[0],), i + 1, dtype=torch.int32, device=tok.device)
        logits, cache = model.decode_fn(params, {"tokens": tok, "cur_len": cur}, cache)
        out.append(logits)
    return out


def encdec_serve_phase(torch, dev, cfg, params, src_lens=PROMPT_LENS, new_tokens=NEW_TOKENS,
                       max_len=MAX_LEN) -> dict:
    """Full-width ``seamless-m4t-medium`` served as the two-function app
    (``embed`` = the encoder -> ``decoder``) on an unfused and a fusing
    platform (``SERVE_POLICY``: the edge is observed once per prefill, so
    the chain fuses at the second prompt), source prompts of ``src_lens``
    frame rows at batch 1, ``new_tokens`` greedy tokens each, the platforms
    taking turns; the first prompt is served twice first (warm-up and, at
    its second prefill, the merge) and not timed.
    Checks: 2 live instances unfused, 1 fused by a healthy merge of both,
    the same tokens fused and unfused and as the model computes them
    without the platform, ``ram_bytes`` fused below unfused, the decode
    entries captured and replayed, and K3 (non-causal, the encoder) and K4
    (the decoder's self and cross attention) launched exactly as
    :func:`expected_launches` predicts for the chain, no plain version."""
    from repro_torch.core import FusionPolicy
    from repro_torch.kernels import build, ops
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ServingEngine

    model = build_model(cfg)
    prompts = encdec_prompts(model, dev, src_lens)
    prompts = prompts[:1] + prompts  # the warm-up: the edge is observed once per prefill
    Backend = backend_class("tinytorch")
    platforms = {"unfused": Backend(FusionPolicy(enabled=False)), "fused": Backend(FusionPolicy(**SERVE_POLICY))}
    replays = {label: record_replays(p) for label, p in platforms.items()}
    results = {}
    ops.reset_counts()
    try:
        engines = {label: ServingEngine(model, p, max_len=max_len, params=params, device=dev)
                   for label, p in platforms.items()}
        ram_before = {label: p.ram_bytes() for label, p in platforms.items()}
        tokens = {label: [] for label in platforms}
        lats = {label: [] for label in platforms}
        for i, prompt in enumerate(prompts):
            for label in ("fused", "unfused") if i % 2 == 0 else ("unfused", "fused"):
                toks, lat = engines[label].generate(prompt, steps=new_tokens)
                if i <= 1:
                    platforms[label].merger.wait_idle()
                else:
                    lats[label].extend(lat)
                tokens[label].append(toks)
        for label, platform in platforms.items():
            platform.merger.wait_idle()
            results[label] = {
                "tokens": tokens[label], "p50_token_ms": statistics.median(lats[label]) * 1e3,
                "ram_bytes": platform.ram_bytes(), "footprints": footprints(platform),
                "live_instances": len(platform.registry.live_instances()),
                "merges": [(m.members, m.healthy) for m in platform.merger.merge_log],
                "graphs": graph_summary(platform, f"encdec {label}") if dev.type == "cuda" else None,
            }
        counts, parts = ops.counts(), build.LAUNCHES.parts()
    finally:
        for platform in platforms.values():
            platform.shutdown()
    chain = set(engines["fused"].chain_names())
    check(chain == {f"{cfg.name}/embed", f"{cfg.name}/decoder"}, f"encdec: chain {chain}")
    check(results["unfused"]["live_instances"] == 2 and results["fused"]["live_instances"] == 1,
          f"encdec: live instances {results['unfused']['live_instances']} unfused, "
          f"{results['fused']['live_instances']} fused")
    check(any(ok and set(m) == chain for m, ok in results["fused"]["merges"]),
          f"encdec: no healthy merge of the chain: {results['fused']['merges']}")
    check(results["fused"]["ram_bytes"] < results["unfused"]["ram_bytes"],
          f"encdec: fused ram_bytes {results['fused']['ram_bytes']} not below unfused "
          f"{results['unfused']['ram_bytes']}: {results['fused']['footprints']} {results['unfused']['footprints']}")
    for i, s in enumerate([src_lens[0], *src_lens]):
        a, b = results["unfused"]["tokens"][i], results["fused"]["tokens"][i]
        check(a.shape == (1, new_tokens) and torch.equal(a, b), f"encdec source {s}: tokens differ fused vs unfused")
    expected: dict = {}
    for label in platforms:
        for k, n in expected_launches(cfg, engines[label], len(prompts), len(prompts) * (new_tokens - 1),
                                      replays[label]).items():
            expected[k] = expected.get(k, 0) + n
    for k, want in expected.items():
        if dev.type == "cuda":
            check(counts[k] == want, f"encdec: {k} launched {counts[k]} times, the run makes {want} ({counts})")
        elif k in STAND_INS:
            check(counts[STAND_INS[k]] == want, f"encdec: {STAND_INS[k]} ran {counts[STAND_INS[k]]} times for {want}")
    if dev.type == "cuda":
        check(all(counts[k] == 0 for k in PLAIN), f"encdec: the chain called a plain version on the card: {counts}")
    with torch.no_grad():
        ref = torch.stack([torch.argmax(x, -1) for x in encdec_model_logits(torch, model, params, prompts[0],
                                                                        new_tokens - 1)], 1).to(torch.int32)
    check(torch.equal(ref, results["unfused"]["tokens"][0]), "encdec: chain tokens differ from the model's own")
    total = torch.cuda.get_device_properties(dev).total_memory if dev.type == "cuda" else 1
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    prefills = 2 * len(prompts)
    return {
        "arch": cfg.name, "encoder_layers": cfg.num_layers, "decoder_layers": cfg.num_decoder_layers,
        "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads], "head_dim": cfg.head_dim,
        "source_frames": list(src_lens), "new_tokens": new_tokens, "max_len": max_len,
        "chain": sorted(chain), "live_instances": {k: r["live_instances"] for k, r in results.items()},
        "p50_token_ms": {k: r["p50_token_ms"] for k, r in results.items()},
        "p50_fused_over_unfused": results["fused"]["p50_token_ms"] / results["unfused"]["p50_token_ms"],
        "ram_bytes": {k: r["ram_bytes"] for k, r in results.items()}, "ram_bytes_deployed": ram_before,
        "ram_bytes_unfused_minus_fused": results["unfused"]["ram_bytes"] - results["fused"]["ram_bytes"],
        "footprints": {k: r["footprints"] for k, r in results.items()},
        "tokens_identical": True, "first_tokens": results["fused"]["tokens"][0][0, :8].tolist(),
        "launches": {k: counts[k] for k in ("flash_attention", "decode_attention")},
        "launch_parts": {part: {k: n[k] for k in ("flash_attention", "decode_attention")}
                         for part, n in parts.items()},
        "expected_launches": expected, "plain_calls": {k: counts[k] for k in PLAIN},
        "canary_replays": {label: len(r) for label, r in replays.items()},
        "prefills": prefills, "decode_steps": prefills * (new_tokens - 1),
        "graphs": {k: r["graphs"] for k, r in results.items()},
        "peak_allocated_gb": peak / 1e9, "peak_share": peak / total, "device_gb": total / 1e9,
    }


def encdec_card_vs_host(torch, dev, cfg, src_len: int = 37) -> dict:
    """``small_config(cfg)`` (2 + 2 layers, d 256, heads of 64), attention at
    fan-in d (:func:`attention_fan_in_d`) and the cross keys over unit-scale
    states (:func:`encdec_unit_cross_keys`), on the card and on the host's CPU
    (the plain versions) from the same bf16 weights and frames: the prefill
    (encoder, cross K/V, the first token) and ENCDEC_DECODE_STEPS decode
    steps, each step's logits within REF_TOL of max |logit|."""
    from repro_torch import tree
    from repro_torch.models.model import build_model

    small = small_config(cfg)
    model = build_model(small)
    with torch.no_grad():
        params = model.init(0, device=dev)
        attention_fan_in_d(params, small)
        prompt = encdec_prompts(model, dev, [src_len])[0]
        rms = encdec_unit_cross_keys(torch, params, small, prompt["src_embeds"])
        nxt = torch.randint(0, small.vocab_size, (ENCDEC_DECODE_STEPS, 1, 1),
                            generator=torch.Generator(device=dev).manual_seed(9), device=dev, dtype=torch.int32)
        here = encdec_model_logits(torch, model, params, prompt, ENCDEC_DECODE_STEPS, nxt)
        host = encdec_model_logits(torch, model, tree.map(lambda x: x.cpu(), params),
                                   tree.map(lambda x: x.cpu(), prompt), ENCDEC_DECODE_STEPS, nxt.cpu())
    errs = [rel_err(a, b) for a, b in zip(here, host)]
    for a in here:
        check(tuple(a.shape) == (1, small.vocab_size) and bool(torch.isfinite(a).all()), "encdec small: bad logits")
    check(max(errs) <= REF_TOL, f"encdec small: card vs host beyond {REF_TOL} of max |logit|: {errs}")
    return {"arch": small.name, "d_model": small.d_model, "layers": [small.num_layers, small.num_decoder_layers],
            "source_frames": src_len, "decode_steps": ENCDEC_DECODE_STEPS, "attention_fan_in_d": True,
            "encoder_states_rms": rms, "rel_err": errs}


def encdec_train_phase(torch, dev, cfg) -> dict:
    """Full-width ``seamless-m4t-medium`` trained ENCDEC_TRAIN_STEPS steps
    through TrainLoop at T = 4096 (``train_4k``: source frames and target
    tokens of 4096), a batch of ENCDEC_TRAIN_BATCH as the config's 4
    microbatches, bf16 params, fp32 moments, AdamW at TRAIN_LR, remat as the
    config has it. Checks: every loss and grad_norm finite; K3's forward
    launched 2 x (remat) and each backward kernel once per attention of each
    microbatch (the encoder's self-attention, the decoder's self- and
    cross-attention), no K4 and no plain version. Reports step ms (p50),
    tokens/s and peak memory."""
    import gc

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.training.train_step import init_train_state

    card = dev.type == "cuda"
    gc.collect()
    if card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    state = init_train_state(build_model(cfg), 0, device=dev)
    shape = ShapeConfig("train_4k on one card", TRAIN_SEQ, ENCDEC_TRAIN_BATCH, "train")
    ops.reset_counts()
    _, state, hist, _ = train_loop_run(torch, dev, cfg, state, ENCDEC_TRAIN_STEPS, shape, TRAIN_LR)
    counts = ops.counts()
    del state
    losses, norms = [h["loss"] for h in hist], [h["grad_norm"] for h in hist]
    check(all(map(math.isfinite, losses + norms)), f"encdec train: a non-finite loss or grad_norm: {losses} {norms}")
    applied = ENCDEC_TRAIN_STEPS * cfg.microbatches * (cfg.num_layers + 2 * cfg.num_decoder_layers)
    want = {"flash_attention": applied * (2 if cfg.remat else 1), **dict.fromkeys(GRAD_KERNELS, applied)}
    if card:
        check(all(counts[k] == n for k, n in want.items()) and counts["decode_attention"] == 0,
              f"encdec train: launches {counts}, expected {want}")
        check(all(counts[k] == 0 for k in PLAIN), f"encdec train: a plain version ran on the card: {counts}")
    else:
        check(counts["mha_ref"] == want["flash_attention"], f"encdec train on the host: {counts}, expected {want}")
    step_ms = [h["seconds"] * 1e3 for h in hist]
    p50 = statistics.median(step_ms[1:])
    peak = torch.cuda.max_memory_allocated(dev) if card else 0
    total = torch.cuda.get_device_properties(dev).total_memory if card else 1
    return {"arch": cfg.name, "seq": TRAIN_SEQ, "batch": ENCDEC_TRAIN_BATCH, "microbatches": cfg.microbatches,
            "steps": ENCDEC_TRAIN_STEPS, "lr": TRAIN_LR, "remat": cfg.remat, "losses": losses, "grad_norms": norms,
            "step_ms": step_ms, "step_ms_p50": p50,
            "tokens_per_s": ENCDEC_TRAIN_BATCH * TRAIN_SEQ / (p50 / 1e3),
            "peak_allocated_gb": peak / 1e9, "peak_share": peak / total,
            "launches": {k: counts[k] for k in want}, "expected_launches": want}


def encdec_phases(torch, dev) -> dict:
    """The enc-dec family, after the earlier phases' tensors are freed:
    ``encdec_serve`` (full width, unfused then fused), ``encdec_card_vs_host``
    (the small model's serve and train step), ``encdec_train`` (full width)
    and ``kvpool_stress`` (the arena's sharing fuzz on CUDA pools), each
    printed as its JSON line. Returns the launches of the serve and train
    runs."""
    import gc

    t0 = time.perf_counter()
    cfg, params, memory = fresh_model(torch, dev, ENCDEC_ARCH)
    serve = encdec_serve_phase(torch, dev, cfg, params)
    serve.update(param_bytes=memory["param_bytes"], params_init_s=memory["params_init_s"])
    print(json.dumps({"encdec_serve": serve}), flush=True)
    del params
    gc.collect()
    t1 = time.perf_counter()
    print(json.dumps({"encdec_card_vs_host": {"serve": encdec_card_vs_host(torch, dev, cfg),
                                              "train": train_card_vs_host(torch, dev, cfg)}}), flush=True)
    t2 = time.perf_counter()
    train = encdec_train_phase(torch, dev, cfg)
    print(json.dumps({"encdec_train": train}), flush=True)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t3 = time.perf_counter()
    print(json.dumps({"kvpool_stress": kvpool_stress(torch, dev, budget_s=KV_STRESS_BUDGET_S)}), flush=True)
    t4 = time.perf_counter()
    print(f"encdec serve {t1 - t0:.1f} s, card vs host {t2 - t1:.1f} s, train {t3 - t2:.1f} s, "
          f"kvpool_stress {t4 - t3:.1f} s", file=sys.stderr)
    return {"launches": serve["launches"], "parts": serve["launch_parts"], "train_launches": train["launches"],
            "seconds": {"serve": t1 - t0, "card_vs_host": t2 - t1, "train": t3 - t2, "kvpool_stress": t4 - t3}}


def canary_is_prefill(args) -> bool:
    """Whether a recorded chain request is a prefill (T > 1) or a decode step."""
    x = prompt_rows(args[0]) if isinstance(args[0], dict) else args[0]
    return x.shape[1] > 1


def kernels_line(kern: dict, launches: dict, by_path: dict, captured: dict, parts: dict) -> dict:
    """One entry per kernel: its source, the TPU kernel it replaces, its
    launches on the main path that runs it (``launch_parts``: made by eager
    runs and replayed from captured graphs; on every path of the run,
    ``launches_by_path``), and the kernel phase's figures at that path's
    shape (``main_case``: the serve shape of each); ``captured``: cases on
    a model's own inputs, held relative to max |y| (K6)."""
    paged = "src/repro_torch/kernels/csrc/paged_attention.cu"
    meta = {  # source, TPU kernel, index of the main path's case
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:73", 2),
        # K3's gradient: the Pallas kernel has no VJP; its three kernels, timed together
        "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                                "src/repro/kernels/flash_attention.py:73", 0),
        "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention.py:59", 0),
        "paged_decode_attention": (paged, "src/repro/kernels/paged_attention.py:86", 0),
        "paged_chunk_attention": (paged, "src/repro/kernels/paged_attention.py:178", 2),
        "moe_gmm": ("src/repro_torch/kernels/csrc/moe_gmm.cu", "src/repro/kernels/moe_gmm.py:39", MOE_MAIN_CASE),
        "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu", "src/repro/kernels/ssd_scan.py:63", 0),
        # K5's and K6's gradients: the Pallas kernels have no VJP; two kernels
        # each, timed together (K6's checked case is its main case: its plain
        # backward does not fit the train shape, timed apart in its cases)
        "moe_gmm_bwd": ("src/repro_torch/kernels/csrc/moe_gmm_bwd.cu", "src/repro/kernels/moe_gmm.py:39", 0),
        "ssd_scan_bwd": ("src/repro_torch/kernels/csrc/ssd_scan_bwd.cu", "src/repro/kernels/ssd_scan.py:63", 0),
    }
    entries = []
    for name, cases in kern.items():
        source, replaces, main_case = meta[name]
        main = cases[main_case]
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "launch_parts": parts[name], "launches_by_path": by_path.get(name, {}),
            "max_abs_err": max(c["max_abs_err"] for c in cases if c["max_abs_err"] is not None),
            "ms": main["ms"], "kernel_ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "library": main.get("library", "scaled_dot_product_attention"),
            "shape": main["shape"], "cases": cases, "captured_cases": captured.get(name, []),
        })
    return {"kernels": entries}


def fresh_model(torch, dev, arch: str, layers: int | None = None):
    """Free the earlier phases' tensors, then make ``arch`` at full width and
    depth (``layers``: that many layers) with random bf16 weights from seed
    0. Returns (cfg, params, the memory record: parameter bytes, init
    seconds, allocated GB after it)."""
    import dataclasses
    import gc

    from repro_torch.configs import get_arch
    from repro_torch.models.model import build_model
    from repro_torch.models.params import param_bytes

    gc.collect()  # the platforms of earlier phases hold reference cycles
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device=dev)
    torch.cuda.synchronize()
    memory = {"param_bytes": param_bytes(model.param_defs), "params_init_s": time.perf_counter() - t0,
              "after_init_gb": torch.cuda.memory_allocated() / 1e9, "layers": cfg.num_layers}
    return cfg, params, memory


# qwen3-moe-30b-a3b's serve phases run 24 of its 48 layers at full width
# (the chain keeps its 8 functions, 4 layers each): at 48 they took 145 s of
# the run (serve 44.5, paged 53.4, block and profile 47.0 s), and the family
# training phases added 148 s, which would take a run on the slowest host
# seen (1,021 s before them) to ~1,170 s of the 1,200 s limit.
MOE_SERVE_LAYERS = 24


def moe_phases(torch, dev) -> dict:
    """Full-width qwen3-moe-30b-a3b at MOE_SERVE_LAYERS of its layers
    (random bf16 weights from seed 0, made once after the llama phases'
    tensors are freed): the dense serve phase, the paged serve phase (the
    first 8 requests), the MoE block check and a profiled decode step."""
    import dataclasses

    cfg, params, memory = fresh_model(torch, dev, "qwen3-moe-30b-a3b", MOE_SERVE_LAYERS)
    t0 = time.perf_counter()
    serve = serve_phase(torch, dev, cfg, params=params)
    serve["params_init_s"] = memory["params_init_s"]
    serve["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(json.dumps({"moe_serve": serve}), flush=True)
    print(f"moe serve phase {time.perf_counter() - t0:.1f} s", file=sys.stderr)

    t0 = time.perf_counter()
    # the small model of the batcher-vs-generate check: capacity factor E / k,
    # so that no prompt drops a token (a drop depends on the call's row count)
    small = small_config(cfg)
    small = dataclasses.replace(small, capacity_factor=small.num_experts / small.num_experts_per_tok)
    paged = paged_serve_phase(torch, dev, cfg, n_requests=8, small_cfg=small, params=params)
    print(json.dumps({"moe_paged_serve": paged}), flush=True)
    print(f"moe paged serve phase {time.perf_counter() - t0:.1f} s", file=sys.stderr)

    t0 = time.perf_counter()
    print(json.dumps({"moe_block": moe_block_phase(torch, dev, cfg, params)}), flush=True)
    print(json.dumps({"moe_profile": profile_phase(torch, dev, cfg, params=params, gap=True)}), flush=True)
    memory["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(json.dumps({"moe_memory": memory}), flush=True)
    print(f"moe block and profile phases {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return {"launches": serve["launches"], "paged_launches": paged["launches"]["fused"],
            "parts": serve["launch_parts"]}


def ssm_phases(torch, dev, arch: str, key: str) -> dict:
    """Full-width ``arch`` (mamba2-370m or zamba2-7b) at full depth, random
    bf16 weights from seed 0, made after the earlier phases' tensors are
    freed: the serve phase (unfused, then fused to one instance; K6 once per
    SSM layer of each prefill), K6 on the inputs the first layer gives it,
    the block checks and a profiled fused decode step and prefill. Prints the
    ``<key>_serve``, ``<key>_block``, ``<key>_profile`` and ``<key>_memory``
    lines."""
    cfg, params, memory = fresh_model(torch, dev, arch)
    t0 = time.perf_counter()
    serve = serve_phase(torch, dev, cfg, params=params)
    serve["params_init_s"] = memory["params_init_s"]
    serve["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(json.dumps({f"{key}_serve": serve}), flush=True)
    print(f"{key} serve phase {time.perf_counter() - t0:.1f} s", file=sys.stderr)

    t0 = time.perf_counter()
    captured = ssd_captured_case(torch, dev, cfg, params)
    block = ssm_block_phase(torch, dev, cfg, params, small_config(cfg))
    print(json.dumps({f"{key}_block": {**block, "ssd_captured": captured}}), flush=True)
    print(json.dumps({f"{key}_profile": profile_phase(torch, dev, cfg, params=params, prefill=True)}),
          flush=True)
    memory["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(json.dumps({f"{key}_memory": memory}), flush=True)
    print(f"{key} block and profile phases {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return {"launches": serve["launches"], "captured": captured, "parts": serve["launch_parts"]}


# The dense and vlm decoders served after the hybrid: (architecture, line
# key, whether the paged route runs too). granite-34b's paged requests are
# token prompts with a shared prefix (K1 and K2 at its 48/1 group),
# chameleon-34b's the embeds of theirs (K1, and K3 through the batcher's
# serialized prefill).
DECODERS = (("stablelm-1.6b", "stablelm", False), ("starcoder2-3b", "starcoder2", False),
            ("granite-34b", "granite", True), ("chameleon-34b", "chameleon", True))
DECODER_PAGED_REQUESTS = 8
# The decoders' depth where it is cut to keep the run inside its time limit:
# granite-34b's serve and paged phases took 190-237 s of the run at its 88
# layers and 124 s at 40, chameleon-34b's 78 s at its 48; 24 keep granite's
# chain of 10 functions (3 layers each) and chameleon's of 8 (4 each), and
# both attentions at full width.
DECODER_LAYERS = {"granite-34b": 24, "chameleon-34b": 24}
VLM_EMBEDS_LEN = 300  # the vlm serve phase's embeds prompt


def decoder_block_phase(torch, dev, cfg, params, prompt_len: int = 37) -> dict:
    """The decoder's first and last block at full width on ``dev`` against
    the same bf16 weights on the host's CPU (the plain versions), each on the
    input that the blocks before it give it on ``dev`` for a random prompt
    (token ids; ``embeds`` for vlm), relative to the block's own largest
    contribution, within BLOCK_TOL (as :func:`moe_block_phase` holds an MoE
    layer)."""
    from repro_torch import tree
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import embed_tokens

    gen = torch.Generator(device=dev).manual_seed(23)
    kind = tfm.layer_kind(cfg)
    pos = torch.arange(prompt_len, device=dev)[None]
    checked = (0, cfg.num_layers - 1)
    errs = {}
    with torch.no_grad():
        toks = torch.randint(0, cfg.vocab_size, (1, prompt_len), generator=gen, device=dev, dtype=torch.int32)
        if cfg.family == "vlm":
            x = frontend_embeds(torch, params, toks)["embeds"]
        else:
            x = embed_tokens(params["embed"], toks)
        for i in range(cfg.num_layers):
            lp = tree.map(lambda a: a[i], params["blocks"])
            y, _, _ = tfm.apply_block_full(lp, x, cfg, kind, pos)
            if i in checked:
                y_host, _, _ = tfm.apply_block_full(tree.map(lambda a: a.cpu(), lp), x.cpu(), cfg, kind, pos.cpu())
                errs[f"block_{i}"] = rel_err(y - x, y_host - x.cpu())  # the block's own contribution
            x = y
    check(bool(torch.isfinite(x).all()), "non-finite hidden state after the last block")
    check(max(errs.values()) <= BLOCK_TOL, f"a full-width block differs from the host's beyond {BLOCK_TOL}: {errs}")
    return {"prompt_len": prompt_len, "input": "embeds" if cfg.family == "vlm" else "tokens",
            "card_vs_host_rel_err": errs}


def decoder_phases(torch, dev, arch: str, key: str, paged: bool) -> dict:
    """Full-width ``arch`` at full depth (DECODER_LAYERS: a cut), random bf16 weights from seed 0,
    made after the earlier phases' tensors are freed, one params tree for
    every platform of its phases: the serve phase (the vlm family with one
    more prompt of ``embeds`` rows), with ``paged`` the paged serve phase
    (DECODER_PAGED_REQUESTS requests; the vlm's as ``embeds``), the block
    check and the memory record. Prints the ``<key>_serve``,
    ``<key>_paged_serve``, ``<key>_block`` and ``<key>_memory`` lines; a
    phase that runs out of device memory fails the run."""
    cfg, params, memory = fresh_model(torch, dev, arch, DECODER_LAYERS.get(arch))
    vlm = cfg.family == "vlm"
    t0 = time.perf_counter()
    serve = serve_phase(torch, dev, cfg, params=params, embeds_len=VLM_EMBEDS_LEN if vlm else 0)
    serve["params_init_s"] = memory["params_init_s"]
    serve["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(json.dumps({f"{key}_serve": serve}), flush=True)
    print(f"{key} serve phase {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    out = {"launches": serve["launches"], "parts": serve["launch_parts"]}
    if paged:
        t0 = time.perf_counter()
        run = paged_serve_phase(torch, dev, cfg, n_requests=DECODER_PAGED_REQUESTS, small_cfg=small_config(cfg),
                                params=params, embeds=vlm)
        print(json.dumps({f"{key}_paged_serve": run}), flush=True)
        print(f"{key} paged serve phase {time.perf_counter() - t0:.1f} s", file=sys.stderr)
        out["paged_launches"] = run["launches"]["fused"]
    t0 = time.perf_counter()
    print(json.dumps({f"{key}_block": decoder_block_phase(torch, dev, cfg, params)}), flush=True)
    total = torch.cuda.get_device_properties(dev).total_memory
    memory["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    memory.update(device_gb=total / 1e9, peak_share=torch.cuda.max_memory_allocated() / total,
                  param_share=memory["param_bytes"] / total,
                  beside_weights_gb=(total - memory["param_bytes"]) / 1e9)
    print(json.dumps({f"{key}_memory": memory}), flush=True)
    print(f"{key} block phase {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return out


# The launcher's runs (``python -m repro_torch.launch.serve``): full-width
# stablelm-1.6b with its defaults; the reduced chameleon-34b through pods,
# its prompt of embeds. Neither names a device: both must run on the card.
LAUNCH_RUNS = (("stablelm-1.6b", ()), ("chameleon-34b", ("--reduced", "--backend", "orchestrated")))
LAUNCH_TIMEOUT_S = 600


def launch_serve_phase(torch, dev) -> dict:
    """Start the system as a user would: each of LAUNCH_RUNS as
    ``python -m repro_torch.launch.serve`` in a process of its own (the
    earlier phases' device memory freed first), its JSON parsed: one healthy
    merge of every chain member, 1 instance left, the device ``cuda``."""
    import gc
    import os

    from repro_torch.launch.serve import resolve_arch
    from repro_torch.serving.engine import _pick_groups

    gc.collect()
    torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [str(SRC), os.environ.get("PYTHONPATH")])))
    runs = []
    for arch, extra in LAUNCH_RUNS:
        cfg = resolve_arch(arch, "--reduced" in extra)
        groups = _pick_groups(cfg.num_layers, cfg.num_function_groups)
        chain = {f"{arch}/embed", *(f"{arch}/g{i}" for i in range(groups)), f"{arch}/head"}
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch, *extra],
                              cwd=ROOT, env=env, capture_output=True, text=True, timeout=LAUNCH_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        check(proc.returncode == 0, f"launch_serve {arch}: exit {proc.returncode}: {proc.stderr[-3000:]}")
        rec = json.loads(proc.stdout)
        check(any(set(m) == chain for m in rec["merges"]),
              f"launch_serve {arch}: no healthy merge of the whole chain {sorted(chain)}: {rec['merges']}")
        check(rec["instances_left"] == 1, f"launch_serve {arch}: {rec['instances_left']} instances left")
        check(rec["device"] == dev.type, f"launch_serve {arch}: ran on {rec['device']}, not {dev.type}")
        runs.append({"args": ["--arch", arch, *extra], "chain": len(chain), "seconds": seconds, **rec})
    return {"runs": runs}


# The train phase: full-width llama3.2-1b at train_4k's length
# (src/repro/configs/base.py: SHAPES["train_4k"], 4096 tokens) with a card's
# batch of 4 as 2 microbatches of 2, bf16 params and fp32 moments from seed 0,
# the affine stream from seed 0, the launcher's default learning rate (1e-2,
# cosine after one warm-up step).
TRAIN_STEPS = 16
TRAIN_SEQ = 4096
TRAIN_BATCH = 4
TRAIN_MICRO = 2
TRAIN_LR = 1e-2
TRAIN_TOL = 2e-2  # a small model's loss and grad_norm, card vs host, relative
TRAIN_GRAD_TOL = 5e-2  # each gradient, card vs host, over its max |g| (the block checks' limit)
TRAIN_BLOCK_T = 512
RESTART_STEPS = 12
RESTART_FAILS = (5, 9)
LAUNCH_TRAIN = ("--arch", "llama3.2-1b", "--steps", "6", "--batch", "2", "--seq", "2048", "--ckpt-every", "0")


def train_loop_run(torch, dev, cfg, state, steps: int, shape, lr: float, ckpt_every: int = 0, seed: int = 0,
                   injector=None, donate: bool = False):
    """``steps`` steps of ``cfg`` from ``state`` through the port's
    TrainLoop (AdamW, the launcher's cosine schedule, the affine stream of
    ``seed`` on ``dev``; checkpoints in a temporary directory); with
    ``donate`` the loop is handed ``state`` and updates it in place from the
    first step (else from the second). Returns (loop, final state, history,
    the step function)."""
    import tempfile

    from repro_torch import donate as donation
    from repro_torch.checkpointing import CheckpointManager
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamWConfig, cosine_schedule
    from repro_torch.training import TrainLoop
    from repro_torch.training.train_step import make_train_step

    step_fn = make_train_step(build_model(cfg), AdamWConfig(lr=lr), cosine_schedule(lr, max(1, steps // 10), steps))
    with tempfile.TemporaryDirectory() as d:
        loop = TrainLoop(step_fn, lambda start: SyntheticTokenPipeline(cfg, shape, seed=seed, mode="affine",
                                                                      start_batch=start, device=dev),
                         CheckpointManager(d), ckpt_every=ckpt_every)
        with donation.donating(donate):
            state, history = loop.run(state, steps, injector)
    return loop, state, history, step_fn


def train_phase(torch, dev, cfg) -> tuple[dict, dict]:
    """Full-width ``cfg`` (llama3.2-1b: 16 layers, d 2048, 32/8 heads of 64,
    the tied table of 128,256 rows, remat as its config has it) trained for
    TRAIN_STEPS steps through TrainLoop at T = 4096, a batch of 4 as 2
    microbatches. Checks: every loss and grad_norm finite, the mean of the
    last 4 losses below the first 4's, K3's forward launched 2 x (1 with no
    remat) and each backward kernel once per layer of each microbatch, no
    plain version called. Reports step ms (p50), tokens/s, peak allocated
    memory and its share of the card, the state's bytes and, from one more
    step under torch.profiler, the device's busy share and K3's. Returns
    (the ``train`` line, the final params for the block check)."""
    import dataclasses
    import gc

    from repro_torch import donate as donation
    from repro_torch import tree
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.training.train_step import init_train_state

    card = dev.type == "cuda"
    gc.collect()
    if card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    tcfg = dataclasses.replace(cfg, microbatches=TRAIN_MICRO)
    t0 = time.perf_counter()
    state = init_train_state(build_model(tcfg), 0, device=dev)
    if card:
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nbytes = lambda t: sum(x.numel() * x.element_size() for x in tree.leaves(t))  # noqa: E731
    state_bytes = {"params": nbytes(state["params"]), "moments": nbytes(state["opt"]["m"]) + nbytes(state["opt"]["v"])}
    shape = ShapeConfig("train_4k on one card", TRAIN_SEQ, TRAIN_BATCH, "train")
    ops.reset_counts()
    _, state, hist, step_fn = train_loop_run(torch, dev, tcfg, state, TRAIN_STEPS, shape, TRAIN_LR, donate=True)
    counts = ops.counts()
    losses, norms = [h["loss"] for h in hist], [h["grad_norm"] for h in hist]
    check(all(map(math.isfinite, losses + norms)), f"train: a non-finite loss or grad_norm: {losses} {norms}")
    first, last = statistics.mean(losses[:4]), statistics.mean(losses[-4:])
    check(last < first, f"train: the loss did not fall: first 4 {first}, last 4 {last}")
    applied = TRAIN_STEPS * TRAIN_MICRO * cfg.num_layers
    want = {"flash_attention": applied * (2 if cfg.remat else 1), **dict.fromkeys(GRAD_KERNELS, applied)}
    if card:
        check(all(counts[k] == n for k, n in want.items()) and
              all(counts[k] == 0 for k in ("decode_attention", "paged_decode_attention", "paged_chunk_attention",
                                           "moe_gmm", "ssd_scan")),
              f"train: launches {counts}, expected {want}")
        check(all(counts[k] == 0 for k in PLAIN), f"train: a plain version ran on the card: {counts}")
    else:  # the host: the plain forward stands in, and autograd differentiates it
        check(counts["mha_ref"] == want["flash_attention"] and counts["mha_ref_bwd"] == 0,
              f"train on the host: plain calls {counts}, expected {want}")
    peak = torch.cuda.max_memory_allocated() if card else 0
    total = torch.cuda.get_device_properties(dev).total_memory if card else 1
    step_ms = [h["seconds"] * 1e3 for h in hist]
    p50 = statistics.median(step_ms[1:])

    data = SyntheticTokenPipeline(tcfg, shape, seed=0, start_batch=TRAIN_STEPS, device=dev)
    batch = next(data)
    data.close()

    def one_step() -> float:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with donation.donating():
            step_fn(state, batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t1) * 1e3

    profile = None
    if card:
        prof = device_profile(torch, one_step, 1)
        k3 = prof["port_kernels"]
        dev_ms = prof["device_kernel_ms_per_step"]
        profile = {"wall_ms": prof["wall_ms_per_step"], "profiled_wall_ms": prof["profiled_wall_ms_per_step"],
                   "device_kernel_ms": dev_ms, "device_busy_share": prof["device_busy_share"],
                   "k3_forward_share": k3.get("flash_attention_kernel", {}).get("ms_per_step", 0.0) / dev_ms,
                   "k3_backward_share": sum(k3.get(n, {}).get("ms_per_step", 0.0)
                                            for n in ("flash_bwd_prep_kernel", "flash_bwd_kernel",
                                                      "flash_bwd_post_kernel")) / dev_ms,
                   "port_kernels": k3, "top_kernels": prof["top_kernels"], "kernels": prof["kernels_per_step"],
                   "step_memory": step_memory(torch, tcfg, state, batch, TRAIN_LR)}
    out = {
        "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads],
        "head_dim": cfg.head_dim, "vocab": cfg.vocab_size, "remat": cfg.remat, "seq": TRAIN_SEQ,
        "batch": TRAIN_BATCH, "microbatches": TRAIN_MICRO, "steps": TRAIN_STEPS, "lr": TRAIN_LR,
        "lr_schedule": f"cosine_schedule({TRAIN_LR}, {max(1, TRAIN_STEPS // 10)}, {TRAIN_STEPS})",
        "params_dtype": "bfloat16", "moments_dtype": "float32", "data": "affine, seed 0",
        "losses": losses, "grad_norms": norms, "first4_mean_loss": first, "last4_mean_loss": last,
        "step_ms": step_ms, "step_ms_p50": p50, "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (p50 / 1e3),
        "state_bytes": {**state_bytes, "grads": state_bytes["params"],
                        "total": 2 * state_bytes["params"] + state_bytes["moments"]},
        "peak_allocated_gb": peak / 1e9, "peak_share": peak / total, "device_gb": total / 1e9,
        "params_init_s": init_s, "launches": {k: counts[k] for k in want}, "expected_launches": want,
        "plain_calls": {k: counts[k] for k in PLAIN}, "profile": profile,
    }
    return out, state["params"]


def grads_of(torch, model, params, batch) -> list:
    """The gradient leaves of one step's objective."""
    from repro_torch import tree
    from repro_torch.training.train_step import value_and_grad

    return tree.leaves(value_and_grad(model, params, batch)[2])


def train_block_check(torch, dev, cfg, params, t: int = TRAIN_BLOCK_T) -> dict:
    """The first and last full-width block, forward and backward at B = 1,
    T = ``t``, on the card and on the host's CPU (the plain versions) from
    the same bf16 weights, input (the hidden state the blocks before it give
    on the card for a random prompt) and output gradient: dx and every
    parameter gradient within TRAIN_GRAD_TOL of its max |g|. The checked
    block's wq and wk are rescaled to fan-in d (:func:`attention_fan_in_d`):
    under the JAX init rule its scores have a std of ~128, q and k round
    differently in bf16 on the two sides, and the gradients through the
    softmax (dx, dwq, dwk) move on rounding alone; the same comparison on
    the block's own weights is reported beside it (``jax_init_rel_err``),
    not held."""
    from repro_torch import tree
    from repro_torch.checkpointing.manager import _flatten_with_paths
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import embed_tokens

    gen = torch.Generator(device=dev).manual_seed(31)
    kind = tfm.layer_kind(cfg)
    pos = torch.arange(t, device=dev)[None]
    toks = torch.randint(0, cfg.vocab_size, (1, t), generator=gen, device=dev, dtype=torch.int32)
    errs, jax_rule = {}, {}

    def block_grads(lp, x, dy, p):
        leaves, struct = tree.flatten(lp)
        live = [a.detach().requires_grad_() for a in leaves]
        xi = x.detach().requires_grad_()
        y, _, _ = tfm.apply_block_full(tree.unflatten(struct, live), xi, cfg, kind, p)
        return torch.autograd.grad(y, [xi, *live], dy)

    with torch.no_grad():
        x = embed_tokens(params["embed"], toks)
    for i in range(cfg.num_layers):
        lp = tree.map(lambda a: a[i], params["blocks"])
        if i in (0, cfg.num_layers - 1):
            dy = torch.randn(x.shape, generator=gen, device=dev).to(x.dtype)
            soft = tree.map(torch.clone, lp)
            attention_fan_in_d(soft, cfg)
            names = ["dx"] + ["d" + k for k in _flatten_with_paths(lp)]
            for out, weights in ((errs, soft), (jax_rule, lp)):
                here = block_grads(weights, x, dy, pos)
                host = block_grads(tree.map(lambda a: a.cpu(), weights), x.cpu(), dy.cpu(), pos.cpu())
                out[f"block_{i}"] = {n: rel_err(a, b) for n, a, b in zip(names, here, host)}
        with torch.no_grad():
            x, _, _ = tfm.apply_block_full(lp, x, cfg, kind, pos)
    worst = max(max(e.values()) for e in errs.values())
    check(worst <= TRAIN_GRAD_TOL, f"train block gradients differ from the host's beyond {TRAIN_GRAD_TOL}: {errs}")
    return {"batch": 1, "seq": t, "attention_fan_in_d": True, "rel_err": errs, "worst": worst,
            "jax_init_rel_err": jax_rule}


# The small hybrid of the training card-vs-host step: 2 layers, the shared
# block after each (applied twice, as in hybrid_train). small_config's 5
# layers (2 groups of 2 and a tail) are too noisy in bf16 to be read at
# TRAIN_GRAD_TOL: on the host alone their bf16 gradients differ from the
# same step's fp32 gradients by up to 8-11 % of max on in_B, in_C and the
# tail's conv_C (the card's from the host's by 5.3 %); at 2 layers by 2.5 %.
# The tail is compared at full width instead: hybrid_train's 14 layers end in
# a tail of 2, and family_block_check holds its last block card vs host.
TRAIN_SMALL_HYBRID = {"num_layers": 2, "shared_attn_every": 1}


def train_card_vs_host(torch, dev, cfg, seq: int = 256, batch: int = 2) -> dict:
    """One train step of ``small_config(cfg)`` on the card and on the host's
    CPU from the same bf16 params and batch: the step's loss and grad_norm
    within TRAIN_TOL relative, every gradient leaf within TRAIN_GRAD_TOL of
    its max |g|. Its attention is drawn at fan-in d
    (:func:`attention_fan_in_d`), as :func:`train_block_check`'s, an
    enc-dec's cross-attention reads unit-scale states
    (:func:`encdec_unit_cross_keys`), an MoE model's host step routes
    every token to the experts the card's chose (:class:`RoutingReplay`),
    and a hybrid runs TRAIN_SMALL_HYBRID's depth."""
    import dataclasses

    from repro_torch import tree
    from repro_torch.checkpointing.manager import _flatten_with_paths
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamWConfig, cosine_schedule
    from repro_torch.training.train_step import init_train_state, make_train_step

    small = small_config(cfg)
    if small.family == "hybrid":  # see TRAIN_SMALL_HYBRID
        small = dataclasses.replace(small, **TRAIN_SMALL_HYBRID)
    model = build_model(small)
    state = init_train_state(model, 0, device=dev)
    data = SyntheticTokenPipeline(small, ShapeConfig("small", seq, batch, "train"), seed=0, device=dev)
    b = next(data)
    data.close()
    attention_fan_in_d(state["params"], small)
    if small.family == "audio":
        encdec_unit_cross_keys(torch, state["params"], small, b["src_embeds"])
    host_state = tree.map(lambda x: x.cpu(), state)
    host_b = tree.map(lambda x: x.cpu(), b)
    step = make_train_step(model, AdamWConfig(lr=TRAIN_LR), cosine_schedule(TRAIN_LR, 1, 10))
    routing = RoutingReplay()
    with routing.recording():
        _, m_card = step(state, b)
        g_card = grads_of(torch, model, state["params"], b)
    with routing.replaying():
        _, m_host = step(host_state, host_b)
        g_host = grads_of(torch, model, host_state["params"], host_b)
    names = list(_flatten_with_paths(state["params"]))
    out = {"arch": small.name, "d_model": small.d_model, "layers": small.num_layers, "seq": seq, "batch": batch,
           "attention_fan_in_d": True,
           "loss": {"card": float(m_card["loss"]), "host": float(m_host["loss"])},
           "grad_norm": {"card": float(m_card["grad_norm"]), "host": float(m_host["grad_norm"])},
           "grad_rel_err": {n: rel_err(a, c) for n, a, c in zip(names, g_card, g_host)}}
    if small.family == "moe":
        out.update(routing_replayed=True, tokens_routed_otherwise_on_the_host=routing.differed,
                   moe_aux={"card": float(m_card["moe_aux"]), "host": float(m_host["moe_aux"])},
                   moe_dropped={"card": float(m_card["moe_dropped"]), "host": float(m_host["moe_dropped"])})
    for key in ("loss", "grad_norm"):
        c, h = out[key]["card"], out[key]["host"]
        check(math.isfinite(c) and abs(c - h) <= TRAIN_TOL * abs(h), f"train small {key}: card {c}, host {h}")
    check(max(out["grad_rel_err"].values()) <= TRAIN_GRAD_TOL,
          f"train small: a gradient differs from the host's beyond {TRAIN_GRAD_TOL}: {out['grad_rel_err']}")
    return out


def train_restart_phase(torch, dev, cfg) -> dict:
    """The reference's bit-exact restart on the card: ``small_config(cfg)``
    for RESTART_STEPS steps with a checkpoint every 4, once without failures
    and once with failures at RESTART_FAILS; the final params must be equal
    bit for bit. The steps run under torch.use_deterministic_algorithms
    (the CE's gather backward sums with atomics otherwise; cuBLAS needs
    CUBLAS_WORKSPACE_CONFIG, set by main before the first handle)."""
    from repro_torch import tree
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.model import build_model
    from repro_torch.training import FailureInjector
    from repro_torch.training.train_step import init_train_state

    small = small_config(cfg)
    shape = ShapeConfig("restart", 128, 4, "train")
    state0 = init_train_state(build_model(small), 0, device=dev)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        _, state_a, hist_a, _ = train_loop_run(torch, dev, small, state0, RESTART_STEPS, shape, 1e-2, ckpt_every=4,
                                               seed=7)
        injector = FailureInjector(list(RESTART_FAILS))
        loop_b, state_b, hist_b, _ = train_loop_run(torch, dev, small, state0, RESTART_STEPS, shape, 1e-2,
                                                    ckpt_every=4, seed=7, injector=injector)
    finally:
        torch.use_deterministic_algorithms(prev)
    check(loop_b.restarts == len(RESTART_FAILS) and injector.fired == list(RESTART_FAILS),
          f"restart: {loop_b.restarts} restarts, fired {injector.fired}")
    same = [torch.equal(a, b) for a, b in zip(tree.leaves(state_a["params"]), tree.leaves(state_b["params"]))]
    check(all(same), f"restart: {same.count(False)} of {len(same)} param leaves differ from the run without failures")
    return {"arch": small.name, "steps": RESTART_STEPS, "ckpt_every": 4, "failures": list(RESTART_FAILS),
            "restarts": loop_b.restarts, "bit_exact_leaves": len(same), "deterministic_algorithms": True,
            "final_loss": {"no_failures": hist_a[-1]["loss"], "with_failures": hist_b[-1]["loss"]}}


def launch_train_phase(torch, dev, args=None) -> dict:
    """``python -m repro_torch.launch.train`` (LAUNCH_TRAIN: full-width
    llama3.2-1b, 6 steps of 2 x 2048 tokens, no checkpoint; LAUNCH_TRAIN_SSM:
    full-width mamba2-370m) in a process of its own with no ``--device``: it
    must run on the card, exit 0 and print its JSON line with finite losses."""
    import gc
    import os
    import tempfile

    args = LAUNCH_TRAIN if args is None else args
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [str(SRC), os.environ.get("PYTHONPATH")])))
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args, "--ckpt-dir", d],
                              cwd=ROOT, env=env, capture_output=True, text=True, timeout=LAUNCH_TIMEOUT_S)
        seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"launch_train: exit {proc.returncode}: {proc.stderr[-3000:]}")
    lines = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    check(len(lines) == 1, f"launch_train: {len(lines)} JSON lines: {proc.stdout[-2000:]}")
    rec = lines[0]
    check(rec["device"] == dev.type, f"launch_train: ran on {rec['device']}, not {dev.type}")
    check(math.isfinite(rec["first_loss"]) and math.isfinite(rec["final_loss"]), f"launch_train: {rec}")
    return {"args": list(args), "seconds": seconds, **rec}


def training_phases(torch, dev, cfg) -> dict:
    """The train phase, card vs host (a small model's step, two full-width
    blocks), the restart on the card and the launcher, each printed as its
    JSON line; the earlier phases' memory freed first and this phase's after.
    Returns the train line's launches."""
    import gc

    t0 = time.perf_counter()
    train, params = train_phase(torch, dev, cfg)
    print(json.dumps({"train": train}), flush=True)
    t1 = time.perf_counter()
    blocks = train_block_check(torch, dev, cfg, params)
    del params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    print(json.dumps({"train_card_vs_host": {"small": train_card_vs_host(torch, dev, cfg), "blocks": blocks,
                                             "donated_step": donated_step_check(torch, dev, cfg)}}), flush=True)
    t2 = time.perf_counter()
    print(json.dumps({"train_restart": train_restart_phase(torch, dev, cfg)}), flush=True)
    t3 = time.perf_counter()
    print(json.dumps({"launch_train": launch_train_phase(torch, dev)}), flush=True)
    t4 = time.perf_counter()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    print(f"train phase {t1 - t0:.1f} s, card vs host {t2 - t1:.1f} s, restart {t3 - t2:.1f} s, "
          f"launch_train {t4 - t3:.1f} s", file=sys.stderr)
    return {"launches": train["launches"], "seconds": {"train": t1 - t0, "card_vs_host": t2 - t1,
                                                        "restart": t3 - t2, "launch_train": t4 - t3}}


# The MoE, SSM and hybrid families trained on the card: (architecture, line
# key, layers, AdamW's rate). qwen3-moe-30b-a3b at full width with 4 of its 48
# layers (6.23 GB of bf16 params, 31 GB of training state; the whole model's
# would be ~367 GB): each loop and profile step is donated, so the update is
# AdamW in place (one state, its fp32 temporaries one piece of 2^24 elements
# at a time) and the microbatches' gradients add into one accumulator. Until
# the port updated in place, its functional update held the old and the new
# state at once beside two gradient trees and the fp32 temporaries of a
# whole stacked expert leaf, and at 4 and 3 layers the first update ran out
# of the card's 79 GiB (2 layers ran). mamba2-370m at full width and
# depth (~4.4 GB of state). zamba2-7b at full width with 14 of its 81 layers:
# two groups of 6, so that the shared attention block is applied twice, and a
# tail of 2, so that the tail's blocks train on the card and the block check
# (:func:`family_block_check`: the last SSM block) compares a tail block. The
# rates: at llama's 1e-2 (TRAIN_LR) the MoE model's gradients are small
# (grad_norm 0.4-22, not clipped), each step moved the weights by half their
# scale, the routers collapsed onto few experts (moe_aux 3.4 -> 19.6, 70 % of
# the tokens dropped) and the loss rose from 12.5 to 31; at 2 layers it fell
# at 1e-3, at 4 it rose there (12.46 -> 12.52 over the first and last 3 of 8
# steps) and fell at 1e-4, 3e-4 and 5e-4 (12.49 -> 12.45). The in-place step
# is not the cause: at 2 layers and 1e-3 its 8 losses and final state equal
# the functional step's bit for bit (tools/probes/moe_donated.py). zamba2-7b's loss
# rose at 1e-3 (10.90 -> 11.06) and fell at 3e-4 and 1e-4 (on an NVIDIA H100
# 80GB HBM3 at 700.00 W).
FAMILY_TRAIN = (("qwen3-moe-30b-a3b", "moe", 4, 5e-4), ("mamba2-370m", "ssm", None, 1e-3),
                ("zamba2-7b", "hybrid", 14, 3e-4))
FAMILY_TRAIN_STEPS = 8
FAMILY_TRAIN_BATCH = 4  # train_4k's rows on one card: 2 microbatches of 2 x 4096 tokens
FAMILY_TRAIN_MICRO = 2
FAMILY_RESTART = ("moe", "ssm")  # the bit-exact restart on a small MoE and a small SSM model
LAUNCH_TRAIN_SSM = ("--arch", "mamba2-370m", "--steps", "4", "--batch", "2", "--seq", "1024", "--ckpt-every", "0")


def family_expected_launches(cfg, applied: int) -> dict:
    """Each kernel's launches in ``applied`` microbatch steps of ``cfg``
    (full width, its remat): the forward kernels twice per layer under remat
    (torch.utils.checkpoint re-runs the forward), each backward kernel once."""
    r = 2 if cfg.remat else 1
    if cfg.family == "moe":
        n = cfg.num_layers * applied
        return {"moe_gmm": 3 * n * r, **dict.fromkeys(MOE_GRAD_KERNELS, 3 * n), "flash_attention": n * r,
                **dict.fromkeys(GRAD_KERNELS, n)}
    n = cfg.num_layers * applied
    want = {"ssd_scan": n * r, **dict.fromkeys(SSD_GRAD_KERNELS, n)}
    if cfg.family == "hybrid":
        shared = cfg.num_layers // cfg.shared_attn_every * applied
        want.update({"flash_attention": shared * r, **dict.fromkeys(GRAD_KERNELS, shared)})
    return want


def family_config(arch: str, layers: int | None):
    """``arch`` at full width with ``layers`` of its layers (None: all)."""
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = get_arch(arch)
    return cfg if layers is None else dataclasses.replace(cfg, num_layers=layers)


def family_train_phase(torch, dev, arch: str, layers: int | None, lr: float) -> tuple[dict, object, object]:
    """Full-width ``arch`` (``layers`` of its layers, None: all) trained for
    FAMILY_TRAIN_STEPS steps through TrainLoop at T = 4096, a batch of 4 as 2
    microbatches, remat as its config has it. Checks: every loss, moe_aux and
    grad_norm finite, the mean of the last 3 losses below the first 3's, each
    kernel launched exactly as :func:`family_expected_launches` counts, no
    other kernel and no plain version. Reports step ms (p50), tokens/s, peak
    allocated memory and its share of the card, the state's bytes,
    moe_dropped and moe_aux, and from one more step under torch.profiler the
    device's busy share and the hand-written kernels' device time. Returns
    (the line, the final params, the config)."""
    import dataclasses
    import gc

    from repro_torch import donate as donation
    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.kernels import build, ops
    from repro_torch.models.model import build_model
    from repro_torch.training.train_step import init_train_state

    card = dev.type == "cuda"
    gc.collect()
    if card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    cfg = family_config(arch, layers)
    tcfg = dataclasses.replace(cfg, microbatches=FAMILY_TRAIN_MICRO)
    t0 = time.perf_counter()
    state = init_train_state(build_model(tcfg), 0, device=dev)
    if card:
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nbytes = lambda t: sum(x.numel() * x.element_size() for x in tree.leaves(t))  # noqa: E731
    state_bytes = {"params": nbytes(state["params"]), "moments": nbytes(state["opt"]["m"]) + nbytes(state["opt"]["v"])}
    shape = ShapeConfig("train_4k on one card", TRAIN_SEQ, FAMILY_TRAIN_BATCH, "train")
    ops.reset_counts()
    _, state, hist, step_fn = train_loop_run(torch, dev, tcfg, state, FAMILY_TRAIN_STEPS, shape, lr, donate=True)
    counts = ops.counts()
    losses, norms = [h["loss"] for h in hist], [h["grad_norm"] for h in hist]
    aux, dropped = [h["moe_aux"] for h in hist], [h["moe_dropped"] for h in hist]
    check(all(map(math.isfinite, losses + norms + aux + dropped)),
          f"{arch} train: a non-finite loss, grad_norm or MoE metric: {losses} {norms} {aux} {dropped}")
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    check(last < first, f"{arch} train: the loss did not fall: first 3 {first}, last 3 {last}")
    if cfg.family == "moe":
        check(all(a > 0 for a in aux), f"{arch} train: moe_aux not positive: {aux}")
    want = family_expected_launches(cfg, FAMILY_TRAIN_STEPS * FAMILY_TRAIN_MICRO)
    if card:
        check(all(counts[k] == want.get(k, 0) for k in build.KERNELS),
              f"{arch} train: launches {counts}, expected {want}")
        check(all(counts[k] == 0 for k in PLAIN), f"{arch} train: a plain version ran on the card: {counts}")
    elif cfg.family == "moe":  # the host: the plain versions stand in for K5 and its gradient
        check(counts["gmm_ref"] == want["moe_gmm"] and counts["gmm_ref_bwd"] == want["moe_gmm_bwd_dx"],
              f"{arch} train on the host: plain calls {counts}, expected {want}")
    peak = torch.cuda.max_memory_allocated() if card else 0
    total = torch.cuda.get_device_properties(dev).total_memory if card else 1
    step_ms = [h["seconds"] * 1e3 for h in hist]
    p50 = statistics.median(step_ms[1:])

    profile = None
    if card:
        data = SyntheticTokenPipeline(tcfg, shape, seed=0, start_batch=FAMILY_TRAIN_STEPS, device=dev)
        batch = next(data)
        data.close()

        def one_step() -> float:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with donation.donating():
                step_fn(state, batch)
            torch.cuda.synchronize()
            return (time.perf_counter() - t1) * 1e3

        prof = device_profile(torch, one_step, 1)
        dev_ms = prof["device_kernel_ms_per_step"]
        profile = {"wall_ms": prof["wall_ms_per_step"], "device_kernel_ms": dev_ms,
                   "device_busy_share": prof["device_busy_share"],
                   "port_kernel_share": sum(v["ms_per_step"] for v in prof["port_kernels"].values()) / dev_ms,
                   "port_kernels": prof["port_kernels"], "top_kernels": prof["top_kernels"],
                   "step_memory": step_memory(torch, tcfg, state, batch, lr)}
    out = {
        "arch": cfg.name, "layers": cfg.num_layers, "full_layers": get_arch(arch).num_layers,
        "reduced": layers is not None,
        "d_model": cfg.d_model, "remat": cfg.remat, "seq": TRAIN_SEQ, "batch": FAMILY_TRAIN_BATCH,
        "microbatches": FAMILY_TRAIN_MICRO, "steps": FAMILY_TRAIN_STEPS, "lr": lr,
        "params_dtype": "bfloat16", "moments_dtype": "float32", "data": "affine, seed 0",
        "losses": losses, "grad_norms": norms, "moe_aux": aux, "moe_dropped": dropped,
        "first3_mean_loss": first, "last3_mean_loss": last,
        "step_ms": step_ms, "step_ms_p50": p50, "tokens_per_s": FAMILY_TRAIN_BATCH * TRAIN_SEQ / (p50 / 1e3),
        "state_bytes": {**state_bytes, "grads": state_bytes["params"],
                        "total": 2 * state_bytes["params"] + state_bytes["moments"]},
        "peak_allocated_gb": peak / 1e9, "peak_share": peak / total, "device_gb": total / 1e9,
        "params_init_s": init_s, "launches": {k: counts[k] for k in want}, "expected_launches": want,
        "plain_calls": {k: counts[k] for k in PLAIN}, "profile": profile,
    }
    return out, state["params"], cfg


def step_memory(torch, cfg, state, batch, lr: float) -> dict:
    """Where one donated train step of ``state`` peaks on the card, its
    parts run here one by one as ``training/train_step.py`` runs them: the
    memory allocated when the step starts (the training state and what the
    phase holds beside it), the peak allocated inside each microbatch's
    forward and backward (``value_and_grad``, the gradient accumulator live
    beside it) and inside the in-place AdamW update (``adamw_update_``,
    which advances ``state`` by one step), in GB."""
    from repro_torch import tree
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamWConfig, adamw_update_
    from repro_torch.training.train_step import value_and_grad

    model, n = build_model(cfg), max(1, cfg.microbatches)
    parts: list = []

    def measured(part, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        parts.append({"part": part, "allocated_before_gb": before / 1e9,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        return out

    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    params = state["params"]
    micro = tree.map(lambda x: x.reshape(n, x.shape[0] // n, *x.shape[1:]), batch)
    acc = tree.map(lambda p: torch.zeros(p.shape, dtype=p.dtype, device=p.device), params) if n > 1 else None
    for i in range(n):
        _, _, g = measured("microbatch forward + backward",
                           lambda: value_and_grad(model, params, tree.map(lambda x: x[i], micro)))
        if acc is None:
            acc = g
        else:
            for a, b in zip(tree.leaves(acc), tree.leaves(g)):
                a.add_(b.to(a.dtype))
        del g
    for a in tree.leaves(acc) if n > 1 else ():
        a.div_(n)
    measured("AdamW update in place", lambda: adamw_update_(params, acc, state["opt"], AdamWConfig(lr=lr)))
    del acc
    top = max(parts, key=lambda x: x["peak_gb"])
    total = torch.cuda.get_device_properties(0).total_memory
    return {"allocated_at_start_gb": start / 1e9, "parts": parts, "peaks_in": top["part"],
            "peak_gb": top["peak_gb"], "peak_share": top["peak_gb"] * 1e9 / total}


def donated_step_check(torch, dev, cfg) -> dict:
    """One train step of ``small_config(cfg)`` (2 microbatches) on the card
    from one state, functional and donated (``donate.donating()``: the
    in-place AdamW, the state's own tensors returned): every param, moment,
    the step and every metric equal bit for bit. Both run under
    torch.use_deterministic_algorithms, so that their gradients sum in one
    order (the CE's gather backward sums with atomics otherwise)."""
    import dataclasses

    from repro_torch import donate, tree
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamWConfig, cosine_schedule
    from repro_torch.training.train_step import init_train_state, make_train_step

    small = dataclasses.replace(small_config(cfg), microbatches=2)
    if small.family == "hybrid":
        small = dataclasses.replace(small, **TRAIN_SMALL_HYBRID)
    model = build_model(small)
    data = SyntheticTokenPipeline(small, ShapeConfig("donated", 128, 4, "train"), seed=0, device=dev)
    batch = next(data)
    data.close()
    step = make_train_step(model, AdamWConfig(lr=TRAIN_LR), cosine_schedule(TRAIN_LR, 1, 10))
    state = init_train_state(model, 0, device=dev)
    given = tree.map(torch.clone, state)
    ptrs = [x.data_ptr() for x in tree.leaves(given)]
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        want, m_want = step(state, batch)
        with donate.donating():
            got, m_got = step(given, batch)
    finally:
        torch.use_deterministic_algorithms(prev)
    same = [torch.equal(a, b) for a, b in zip(tree.leaves(got), tree.leaves(want))]
    in_place = got is given and ptrs == [x.data_ptr() for x in tree.leaves(got)]
    metrics = all(torch.equal(m_got[k], m_want[k]) for k in m_want)
    check(all(same) and in_place and metrics,
          f"{small.name}: the donated step differs from the functional one: {same.count(False)} of {len(same)} "
          f"leaves, in place {in_place}, metrics equal {metrics}")
    return {"arch": small.name, "microbatches": 2, "leaves": len(same), "bit_exact": True, "in_place": True}


class RoutingReplay:
    """Routing is discontinuous: the card's and the host's bf16 roundings
    of a router's input differ, and a token whose top-k choice is a near-tie
    goes to other experts on the two sides, so no gradient compares. Inside
    ``recording()`` every ``moe.choose_experts`` call (the router of every
    MoE layer, on one device or a mesh) keeps its experts; inside
    ``replaying()`` each call, in the same order, takes the recorded experts
    in place of its own top-k (its probabilities, and the weights gathered
    from them at those experts, are its own: the gradient flows as in
    ``choose_experts``) and counts the tokens whose own top-k set
    differed."""

    def __init__(self):
        self.experts: list = []
        self.calls = 0
        self.differed: list[int] = []

    def _patched(self, replay: bool):
        import contextlib

        from repro_torch.models import moe

        real = moe.choose_experts

        def choose(router, x, k):
            probs, idx, w = real(router, x, k)
            if not replay:
                self.experts.append(idx)
                return probs, idx, w
            e_card = self.experts[self.calls].to(x.device)
            self.calls += 1
            own = idx.reshape(-1, k).sort(-1).values
            self.differed.append(int((own != e_card.reshape(-1, k).sort(-1).values).any(-1).sum()))
            w = probs.gather(-1, e_card)
            return probs, e_card, w / w.sum(dim=-1, keepdim=True).clamp(min=1e-9)

        @contextlib.contextmanager
        def patched():
            moe.choose_experts = choose
            try:
                yield self
            finally:
                moe.choose_experts = real

        return patched()

    def recording(self):
        return self._patched(replay=False)

    def replaying(self):
        self.calls = 0
        return self._patched(replay=True)


def family_block_check(torch, dev, cfg, params, t: int | None = None) -> dict:
    """The full-width model's first and last block (the hybrid: the first
    and last SSM block and the shared block's first application), forward
    and backward at B = 1, T = ``t``, on the card and on the host's CPU (the
    plain versions) from the same bf16 weights, input (the hidden state the
    blocks before give on the card for a random prompt) and output gradient:
    dx and every parameter gradient within TRAIN_GRAD_TOL of its max |g|.
    Attention's wq and wk are rescaled to fan-in d (:func:`attention_fan_in_d`);
    an MoE block's host pass routes every token to the experts the card's
    chose (:class:`RoutingReplay`)."""
    from repro_torch import tree
    from repro_torch.checkpointing.manager import _flatten_with_paths
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import embed_tokens

    t = TRAIN_BLOCK_T if t is None else t
    gen = torch.Generator(device=dev).manual_seed(37)
    pos = torch.arange(t, device=dev)[None]
    toks = torch.randint(0, cfg.vocab_size, (1, t), generator=gen, device=dev, dtype=torch.int32)
    if cfg.family == "moe":
        blocks = [(f"block_{i}", "moe", tree.map(lambda a, i=i: a[i], params["blocks"])) for i in range(cfg.num_layers)]
        checked = {blocks[0][0], blocks[-1][0]}
    else:
        blocks = model_blocks(cfg, params)
        ssm_names = [name for name, kind, _ in blocks if kind == "ssm"]
        checked = {ssm_names[0], ssm_names[-1]} | ({"shared_0"} if cfg.family == "hybrid" else set())
    errs, rerouted = {}, {}

    def block_grads(lp, x, dy, kind, p):
        leaves, struct = tree.flatten(lp)
        live = [a.detach().requires_grad_() for a in leaves]
        xi = x.detach().requires_grad_()
        y, _, _ = tfm.apply_block_full(tree.unflatten(struct, live), xi, cfg, kind, p)
        return torch.autograd.grad(y, [xi, *live], dy)

    with torch.no_grad():
        x = embed_tokens(params["embed"], toks)
    for name, kind, lp in blocks:
        if name in checked:
            dy = torch.randn(x.shape, generator=gen, device=dev).to(x.dtype)
            soft = tree.map(torch.clone, lp)
            attention_fan_in_d(soft, cfg)
            routing = RoutingReplay()
            with routing.recording():
                here = block_grads(soft, x, dy, kind, pos)
            with routing.replaying():
                host = block_grads(tree.map(lambda a: a.cpu(), soft), x.cpu(), dy.cpu(), kind, pos.cpu())
            names = ["dx"] + ["d" + k for k in _flatten_with_paths(lp)]
            errs[name] = {n: rel_err(a, b) for n, a, b in zip(names, here, host)}
            if kind == "moe":
                rerouted[name] = routing.differed
        with torch.no_grad():
            x, _, _ = tfm.apply_block_full(lp, x, cfg, kind, pos)
    worst = max(max(e.values()) for e in errs.values())
    check(worst <= TRAIN_GRAD_TOL, f"{cfg.name} block gradients differ from the host's beyond {TRAIN_GRAD_TOL}: {errs}")
    return {"batch": 1, "seq": t, "attention_fan_in_d": True, "rel_err": errs, "worst": worst,
            **({"routing_replayed": True, "tokens_routed_otherwise_on_the_host": rerouted}
               if cfg.family == "moe" else {})}


def family_training_phases(torch, dev) -> dict:
    """The MoE, SSM and hybrid families trained on the card (FAMILY_TRAIN):
    for each, the ``<key>_train`` line (:func:`family_train_phase`) and the
    ``<key>_train_card_vs_host`` line (a small model's step, as
    ``train_card_vs_host``, and the full-width blocks,
    :func:`family_block_check`: an MoE model's host pass routed as the
    card's, :class:`RoutingReplay`); the bit-exact restart on a small MoE and a
    small SSM model (``<key>_train_restart``); and the launcher on full-width
    mamba2-370m (``launch_train_ssm``). Returns each family's launches and
    the phases' seconds."""
    import gc

    launches, seconds = {}, {}
    for arch, key, layers, lr in FAMILY_TRAIN:
        t0 = time.perf_counter()
        train, params, cfg = family_train_phase(torch, dev, arch, layers, lr)
        print(json.dumps({f"{key}_train": train}), flush=True)
        t1 = time.perf_counter()
        blocks = family_block_check(torch, dev, cfg, params)
        del params
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        small = train_card_vs_host(torch, dev, cfg)
        donated = donated_step_check(torch, dev, cfg)
        print(json.dumps({f"{key}_train_card_vs_host": {"small": small, "blocks": blocks, "donated_step": donated}}),
              flush=True)
        t2 = time.perf_counter()
        launches[key] = train["launches"]
        seconds[f"{key}_train"], seconds[f"{key}_card_vs_host"] = t1 - t0, t2 - t1
        if key in FAMILY_RESTART:
            print(json.dumps({f"{key}_train_restart": train_restart_phase(torch, dev, cfg)}), flush=True)
            seconds[f"{key}_restart"] = time.perf_counter() - t2
        print(f"{key} training phases {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    t0 = time.perf_counter()
    print(json.dumps({"launch_train_ssm": launch_train_phase(torch, dev, LAUNCH_TRAIN_SSM)}), flush=True)
    seconds["launch_train_ssm"] = time.perf_counter() - t0
    return {"launches": launches, "seconds": seconds}


def control_plane_phases(torch, dev, cfg, serve: dict, serve_tokens: list) -> dict:
    """The control plane's four phases on full-width ``cfg`` (weights from
    seed 0, made once for all four): ``orchestrated_serve``, ``replicas``,
    ``churn`` and ``split``, each printed as its JSON line with its seconds
    on stderr. Returns their K3/K4 launches by path."""
    from repro_torch.models.model import build_model

    params = build_model(cfg).init(0, device=dev)
    launches = {}
    t0 = time.perf_counter()
    orch = orchestrated_phase(torch, dev, cfg, params, serve, serve_tokens)
    print(json.dumps({"orchestrated_serve": orch}), flush=True)
    print(f"orchestrated serve phase {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    launches["orchestrated"] = orch["serve"]["launches"]
    launches["orchestrated batched"] = orch["batched"]["launches"]
    t0 = time.perf_counter()
    replicas = replicas_phase(torch, dev, cfg, params)
    print(json.dumps({"replicas": replicas}), flush=True)
    print(f"replicas phase {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    launches["replica"] = replicas["fused_unit"]["launches"]
    t0 = time.perf_counter()
    print(json.dumps({"churn": churn_phase(torch, dev)}), flush=True)
    print(f"churn phase {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    t0 = time.perf_counter()
    split = split_phase(torch, dev, cfg, params)
    print(json.dumps({"split": split}), flush=True)
    print(f"split phase {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    launches["split"] = split["launches"]
    return launches


# the dry run's cells (repro_torch.launch.dryrun): reckoned on meta tensors,
# the first four also run on the card (at the dry run's batch per step);
# zamba2-7b's long_500k (13 shared-attention caches of 524,288 rows) and
# phi3.5-moe-42b-a6.6b's decode_32k (83.7 GB of bf16 weights) do not fit
DRYRUN_CELLS = (("llama3.2-1b", "train_4k"), ("llama3.2-1b", "prefill_32k"), ("llama3.2-1b", "decode_32k"),
                ("mamba2-370m", "prefill_32k"), ("zamba2-7b", "long_500k"), ("phi3.5-moe-42b-a6.6b", "decode_32k"))
DRYRUN_EXECUTED = DRYRUN_CELLS[:4]
DRYRUN_PEAK_TOL = 0.10  # predicted peak against the allocator's, relative
LONG_T = 32768  # the 32k cells' positions: K3's T and S, K4's S, K6's T
LONG_HEAD = 4096  # K3's rows and K6's positions checked against the plain version on the prefix
LONG_TAIL = 256  # K3's last rows checked against mha_ref(..., q_offset=)
LONG_FAULT = 4096  # the faults the long checks must refuse: an eighth of 32768 keys or positions


def long_kernel_cases(torch, F) -> dict:
    """K3, K4 and K6 at the 32k cells' lengths, B = 1 (K4: B = 4), on
    unit-scale inputs. K3 causal at T = S = 32768 with llama3.2-1b's 32/8
    heads of 64: its first LONG_HEAD rows against the plain version on the
    prefix, its last LONG_TAIL rows against ``mha_ref(..., q_offset=)`` over
    every column. K4 over a cache of 32768 rows (cur_len 32767, every row,
    one and a random length), whole. K3's and K4's outputs average up to
    32768 values rows of ~0.01: each (row, head) is held within RTOL of its
    own max |want| (``row_rel_err``), and the same check must refuse a
    faulty version (K3's tail over keys[: S - LONG_FAULT], K4 over its
    first 7/8 of each cache: one of its 8 splits dropped; K3's head over
    its first LONG_HEAD / 2 keys). K6 at T = 32768
    with mamba2-370m's 32 heads of 64 over a state of 128: y whole and the
    final state against the chunked scan of ``models/ssm.ssd_chunked`` in
    fp32 on the card (linear in T, the state carried chunk to chunk), each
    within RTOL of its max |want|; the same check must refuse that scan with
    the state dropped at every LONG_FAULT-th position; y's first LONG_HEAD
    positions also elementwise against the plain version on the prefix (y
    reaches ~100, where the two summation orders differ by more than the
    elementwise atol near 0 further on, as in ``ssd_case``'s captured
    cases). K3 and K4 also within RTOL / ATOL elementwise (``max_err``).
    Each: equal bits on two launches, timed beside SDPA where one computes it, bounds from
    ``kernels/cost.py``."""
    from repro_torch.kernels import cost as kc
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as sd
    from repro_torch.models import ssm

    def held(label, got, want, fault):
        err, fault_err = row_rel_err(torch, got, want), row_rel_err(torch, fault, want)
        check(err <= RTOL, f"{label}: a row differs from its plain version by {err} of its max (limit {RTOL})")
        check(fault_err > RTOL, f"{label}: the check cannot see a faulty version ({fault_err} <= {RTOL})")
        return err, fault_err

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(32768)
    t, h, kv, hd = LONG_T, 32, 8, 64
    q = torch.randn(1, t, h, hd, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(1, t, kv, hd, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(1, t, kv, hd, generator=gen, device=dev).to(torch.bfloat16)
    got = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    want = fa.plain(q[:, :LONG_HEAD], k[:, :LONG_HEAD], v[:, :LONG_HEAD])
    head = max_err(torch, got[:, :LONG_HEAD], want)
    head_rel, head_fault = held("flash_attention head", got[:, :LONG_HEAD], want,
                                fa.plain(q[:, :LONG_HEAD], k[:, :LONG_HEAD // 2], v[:, :LONG_HEAD // 2]))
    off = t - LONG_TAIL
    want = ref.mha_ref(q[:, off:], k, v, q_offset=off)
    tail = max_err(torch, got[:, off:], want)
    tail_rel, tail_fault = held("flash_attention tail", got[:, off:], want,
                                ref.mha_ref(q[:, off:], k[:, :t - LONG_FAULT], v[:, :t - LONG_FAULT], q_offset=off))
    del want
    check(torch.equal(got, fa.flash_attention(q, k, v, causal=True)), f"flash_attention T={t} is not deterministic")
    c = kc.flash_attention(1, t, t, h, kv, hd, causal=True)
    b_ms, b_by = bound(c.flops, c.bytes)
    ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True), 5, 2)
    kr, vr = (x.transpose(1, 2).repeat_interleave(h // kv, dim=1) for x in (k, v))
    qt = q.transpose(1, 2)
    flash = {"shape": f"B=1 T=S={t} H={h} KV={kv} hd={hd} causal bf16", "checked": f"rows [0, {LONG_HEAD}) "
             f"against the plain version on the prefix, the last {LONG_TAIL} against mha_ref(q_offset={off}), "
             f"each (row, head) within {RTOL} of its max; faults: the head over keys[:{LONG_HEAD // 2}], the "
             f"tail over keys[:{t - LONG_FAULT}]",
             "max_abs_err": max(head, tail), "max_row_rel_err": max(head_rel, tail_rel),
             "fault_row_rel_err": min(head_fault, tail_fault), "ms": ms, "plain_ms": None,
             "plain_prefix_ms": time_ms(torch, lambda: fa.plain(q[:, :LONG_HEAD], k[:, :LONG_HEAD],
                                                                v[:, :LONG_HEAD]), 5, 2),
             "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kr, vr, is_causal=True), 5, 2),
             "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms}
    del q, k, v, got, kr, vr, qt

    b = 4
    q = torch.randn(b, h, hd, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(b, t, kv, hd, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(b, t, kv, hd, generator=gen, device=dev).to(torch.bfloat16)
    lens = [t - 1, t, 1, int(torch.randint(1, t + 1, (1,), generator=gen, device=dev))]
    cur = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = dec.decode_attention(q, k, v, cur)
    torch.cuda.synchronize()
    want = dec.plain(q, k, v, cur)
    err = max_err(torch, got, want)
    rel, fault = held("decode_attention", got, want, dec.plain(q, k, v, cur - cur // 8))
    check(torch.equal(got, dec.decode_attention(q, k, v, cur)), f"decode_attention S={t} is not deterministic")
    c = kc.decode_attention(b, t, h, kv, hd, rows=sum(lens))
    b_ms, b_by = bound(c.flops, c.bytes)
    ms = time_ms(torch, lambda: dec.decode_attention(q, k, v, cur))
    mask = (torch.arange(t, device=dev)[None, :] < cur[:, None])[:, None, None, :]
    kr, vr = (x.transpose(1, 2).repeat_interleave(h // kv, dim=1) for x in (k, v))
    decode = {"shape": f"B={b} S={t} H={h} KV={kv} hd={hd} cur_len={lens} bf16",
              "checked": f"whole, each (row, head) within {RTOL} of its max; fault: cur_len - cur_len // 8",
              "max_abs_err": err, "max_row_rel_err": rel, "fault_row_rel_err": fault, "ms": ms,
              "plain_ms": time_ms(torch, lambda: dec.plain(q, k, v, cur)),
              "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(q[:, :, None], kr, vr,
                                                                                  attn_mask=mask)),
              "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms}
    del q, k, v, got, want, kr, vr, mask

    h, g, p, n = 32, 1, 64, 128
    x = torch.randn(1, t, h, p, generator=gen, device=dev).to(torch.bfloat16)
    bm = (torch.randn(1, t, g, n, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    cm = (torch.randn(1, t, g, n, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(torch.randn(1, t, h, generator=gen, device=dev))
    a_log = torch.randn(h, generator=gen, device=dev) * 0.3
    d_skip = torch.ones(h, device=dev)
    y, state = sd.ssd_scan(x, bm, cm, dt, a_log, d_skip, return_state=True)
    torch.cuda.synchronize()

    def chunked(lo, hi):  # the fp32 chunked scan of positions [lo, hi) from a zero state
        zero = torch.zeros(1, h, p, n, dtype=torch.float32, device=dev)
        return ssm.ssd_chunked(x[:, lo:hi].float(), bm[:, lo:hi].float(), cm[:, lo:hi].float(), dt[:, lo:hi],
                               a_log, d_skip, kc.SSD_CHUNK, init_state=zero)

    pre = (x[:, :LONG_HEAD], bm[:, :LONG_HEAD], cm[:, :LONG_HEAD], dt[:, :LONG_HEAD])
    head = max_err(torch, y[:, :LONG_HEAD], sd.plain(*pre, a_log, d_skip)[0])
    y_want, state_want = chunked(0, t)
    err = max(float((y.float() - y_want).abs().max()), float((state - state_want).abs().max()))
    y_rel, state_rel = rel_err(y, y_want), rel_err(state, state_want)
    check(max(y_rel, state_rel) <= RTOL, f"ssd_scan T={t}: y {y_rel}, state {state_rel} of max |want| (limit {RTOL})")
    fault = rel_err(torch.cat([chunked(lo, lo + LONG_FAULT)[0] for lo in range(0, t, LONG_FAULT)], 1), y_want)
    check(fault > RTOL, f"ssd_scan T={t}: the check cannot see a state dropped every {LONG_FAULT} ({fault})")
    check(torch.equal(y, sd.ssd_scan(x, bm, cm, dt, a_log, d_skip)), f"ssd_scan T={t} is not deterministic")
    c = kc.ssd_scan(1, t, h, g, p, n)
    b_ms, b_by = bound(c.flops, c.bytes)
    ms = time_ms(torch, lambda: sd.ssd_scan(x, bm, cm, dt, a_log, d_skip), 5, 2)
    ssd = {"shape": f"B=1 T={t} H={h} G={g} P={p} N={n} bf16, dt fp32",
           "checked": f"y's first {LONG_HEAD} positions elementwise against the plain version on the prefix; y "
                      f"whole and the final state against models/ssm.ssd_chunked in fp32 (chunks of {kc.SSD_CHUNK}), "
                      f"each within {RTOL} of its max; fault: the state dropped every {LONG_FAULT}",
           "max_abs_err": err, "head_max_abs_err": head, "y_rel_err": y_rel, "state_rel_err": state_rel, "fault_rel_err": fault, "ms": ms,
           "plain_ms": None, "plain_chunked_ms": time_ms(torch, lambda: chunked(0, t), 3, 1), "library_ms": None,
           "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms}
    del x, bm, cm, dt, y, state, y_want, state_want
    torch.cuda.empty_cache()
    return {"flash_attention": flash, "decode_attention": decode, "ssd_scan": ssd}


def dryrun_phase(torch, dev) -> dict:
    """The dry run (``repro_torch.launch.dryrun.run_cell``) at DRYRUN_CELLS:
    each cell reckoned on meta tensors (FLOPs, bytes, peak, the batch per
    step that fits the card, the roofline bound from the datasheet peaks);
    the DRYRUN_EXECUTED cells then run on the card at that batch (a step
    under the cost analysis, then a bare one), where the predicted peak
    must be within DRYRUN_PEAK_TOL of the
    allocator's (``measured.peak_bytes``: the peak since a reset, less what
    was allocated before the cell's weights and inputs), the card's own cost
    analysis must count the meta run's FLOPs, and each kernel must have
    launched as often as the meta run recorded its calls. The other cells
    must not fit, and no plain version may run. Records go to
    chiprun_out/dryrun_torch.jsonl."""
    from repro_torch.launch import dryrun

    out_path = ROOT / "chiprun_out" / "dryrun_torch.jsonl"
    out_path.parent.mkdir(exist_ok=True)
    if out_path.exists():
        out_path.unlink()
    cells, launches = [], {}  # launches: by executed cell
    for arch, shape in DRYRUN_CELLS:
        t0 = time.perf_counter()
        gc_collect(torch)
        executed = (arch, shape) in DRYRUN_EXECUTED
        r = dryrun.run_cell(arch, shape, str(out_path), execute=executed, device="cuda")
        label = f"{arch} {shape}"
        check(r["status"] == "ok", f"dryrun {label}: {r.get('status')} {r.get('reason', '')}")
        check(r["flops_per_device"] > 0 and r["bytes_per_device"] > 0 and r["memory"]["peak_bytes"] > 0,
              f"dryrun {label}: a zero count")
        row = {"cell": label, "batch_per_step": r["batch_per_step"], "steps": r["steps"], "fits_card": r["fits_card"],
               "flops_per_step": r["flops_per_step"], "bytes_per_step": r["bytes_per_step"],
               "predicted_peak_bytes": r["memory"]["peak_bytes"], "kernel_calls": r["kernel_calls_per_step"],
               "step_bound_ms": r["roofline"]["step_bound_s"] * 1e3, "bound_s": r["roofline"]["bound_s"],
               "dominant": r["roofline"]["dominant"], "useful_flops_ratio": r["useful_flops_ratio"],
               "trace_s": r["trace_s"]}
        if executed:
            check(r["fits_card"], f"dryrun {label}: predicted not to fit the card")
            m = r["measured"]
            row.update(step_ms=m["step_ms"], measured_peak_bytes=m["peak_bytes"], peak_ratio=m["peak_ratio"],
                       card_flops=m["flops"], launches=m["launches"], bound_share=row["step_bound_ms"] / m["step_ms"])
            check(abs(m["peak_ratio"] - 1) <= DRYRUN_PEAK_TOL,
                  f"dryrun {label}: predicted peak {r['memory']['peak_bytes']} against {m['peak_bytes']} measured")
            check(m["flops"] == r["flops_per_step"], f"dryrun {label}: {m['flops']} FLOPs on the card, "
                                                     f"{r['flops_per_step']} on meta")
            check(m["kernel_calls"] == r["kernel_calls_per_step"] == m["launches"] and not m["plain_calls"],
                  f"dryrun {label}: launches {m['launches']}, calls on the card {m['kernel_calls']}, "
                  f"on meta {r['kernel_calls_per_step']}, plain versions {m['plain_calls']}")
            launches[label] = m["launches"]
        else:
            check(not r["fits_card"], f"dryrun {label}: predicted to fit the card")
        row["seconds"] = time.perf_counter() - t0
        cells.append(row)
    return {"cells": cells, "launches": launches}


# ------------------------------------------------------------------ mesh

MESH_DRYRUN = (("llama3.2-1b", "decode_32k", "pod16x16"), ("llama3.2-1b", "decode_32k", "pod2x16x16"),
               ("qwen3-moe-30b-a3b", "train_4k", "pod16x16"))
MESH_TRAIN_STEPS = 4
MESH_TRAIN_BATCH = 2  # one microbatch of the train phase: B = 2, T = TRAIN_SEQ
MESH_TRAIN_LR = 1e-3
MESH_LOSS_TOL = 2e-2  # the mesh's losses against the same steps with no mesh, relative (more than one rank)
MESH_MOE_TOKENS = (2, 1024)  # the MoE layer's (B, T) on the NCCL mesh (no token dropped)
MESH_EP_RANKS = 4
MESH_EP_TOKENS = (2, 2048)  # the EP rank programs' (B, T)
MESH_EP_TOL = 2e-2  # the partials' sum against the unsharded layer, over max |y|


def mesh_dryrun_cells(torch) -> list:
    """(a): MESH_DRYRUN through ``dryrun.run_cell(..., mesh=)``, every K5
    call's expert count recorded; the fake group is destroyed after."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    from repro_torch.models import moe as moe_mod

    ref = {}
    with open(ROOT / "results" / "dryrun.jsonl") as f:
        for line in f:
            r = json.loads(line)
            ref.setdefault((r["arch"], r["shape"], r["mesh"]), r)
    out_path = ROOT / "chiprun_out" / "dryrun_torch.jsonl"
    out_path.parent.mkdir(exist_ok=True)
    experts: list = []
    gmm = moe_mod.kops.gmm

    def recording_gmm(xe, w, rows=None, active=None):
        experts.append(int(xe.shape[0]))
        return gmm(xe, w, rows, active)

    rows = []
    moe_mod.kops.gmm = recording_gmm
    try:
        for arch, shape, mesh in MESH_DRYRUN:
            t0 = time.perf_counter()
            experts.clear()
            r = dryrun.run_cell(arch, shape, str(out_path), mesh=mesh)
            label = f"{arch} {shape} {mesh}"
            check(r["status"] == "ok", f"mesh dryrun {label}: {r.get('status')} {r.get('reason', '')}")
            theirs = ref.get((arch, shape, mesh))
            coll = r["collectives"]
            row = {"cell": label, "n_chips": r["n_chips"], "params_bytes_per_device": r["params_bytes_per_device"],
                   "model_flops_per_device": r["model_flops_per_device"], "flops_per_device": r["flops_per_device"],
                   "bytes_per_device": r["bytes_per_device"], "hbm_per_device_gb": r["hbm_per_device_gb"],
                   "useful_flops_ratio": r["useful_flops_ratio"], "roofline": r["roofline"],
                   "kernel_calls": r["kernel_calls_per_device"],
                   "collectives": {k: v for k, v in coll.items() if k != "total_bytes"},
                   "collective_bytes": coll["total_bytes"], "trace_s": r["trace_s"]}
            if theirs is not None:
                row["reference"] = {k: theirs[k] for k in ("params_bytes_per_device", "model_flops_per_device",
                                                           "flops_per_device", "bytes_per_device", "collectives")}
                check(r["params_bytes_per_device"] == theirs["params_bytes_per_device"]
                      and r["model_flops_per_device"] == theirs["model_flops_per_device"],
                      f"mesh dryrun {label}: params {r['params_bytes_per_device']} and model FLOPs "
                      f"{r['model_flops_per_device']} per device, the reference's {theirs['params_bytes_per_device']} "
                      f"and {theirs['model_flops_per_device']}")
            check(coll["total_bytes"] > 0, f"mesh dryrun {label}: no collective")
            if arch.startswith("qwen3"):
                per_rank = 128 // 16
                row["k5_experts"] = sorted(set(experts))
                check(experts and all(e == per_rank for e in experts),
                      f"mesh dryrun {label}: K5 calls at {sorted(set(experts))} experts, want {per_rank}")
                check(coll["reduce-scatter"]["bytes"] > 0 or coll["all-reduce"]["bytes"] > 0,
                      f"mesh dryrun {label}: no reduce-scatter or all-reduce bytes")
            row["seconds"] = time.perf_counter() - t0
            rows.append(row)
    finally:
        moe_mod.kops.gmm = gmm
        if dist.is_initialized():
            dist.destroy_process_group()
    return rows


def _mesh_state(torch, model, rules, mesh, dev):
    """``model``'s train state from seed 0 on ``dev``; on ``mesh`` each
    rank's shards with the strict placements."""
    from repro_torch import tree
    from repro_torch.sharding import spmd
    from repro_torch.training.train_step import init_train_state, make_train_state_defs

    state = init_train_state(model, 0, device=dev)
    if rules is None:
        return state
    return tree.map(lambda x, d: spmd.distribute(x, mesh, spmd.strict_placements(d.shape, d.logical, rules, mesh)),
                    state, make_train_state_defs(model))


def mesh_rank_train(torch, dev, mesh, rules) -> dict:
    """MESH_TRAIN_STEPS steps of full-width llama3.2-1b with no mesh and on
    ``mesh``: losses, launches, step ms (in this rank's process)."""
    import dataclasses

    from repro_torch import donate
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.training.train_step import make_train_step

    cfg = dataclasses.replace(get_arch("llama3.2-1b"), microbatches=1)
    shape = ShapeConfig("train_4k rows on the mesh", TRAIN_SEQ, MESH_TRAIN_BATCH, "train")
    out = {}
    for name, r in (("no_mesh", None), ("mesh", rules)):
        gc_collect(torch)
        model = build_model(cfg, r)
        state = _mesh_state(torch, model, r, mesh, dev)
        step = make_train_step(model, AdamWConfig(lr=MESH_TRAIN_LR))
        pipe = SyntheticTokenPipeline(cfg, shape, seed=0, device=dev, mesh=mesh if r else None, rules=r)
        losses, ms = [], []
        torch.cuda.synchronize(dev)
        ops.reset_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        with donate.donating():
            for _ in range(MESH_TRAIN_STEPS):
                batch = next(pipe)
                t0 = time.perf_counter()
                state, m = step(state, batch)
                losses.append(float(m["loss"]))  # a host sync: the step's time ends here
                ms.append((time.perf_counter() - t0) * 1e3)
        counts = ops.counts()
        pipe.close()
        out[name] = {"losses": losses, "step_ms": ms, "counts": counts,
                     "peak_allocated_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
        del state
    return out


def mesh_rank_moe(torch, dev, mesh, rules) -> dict:
    """Full-width qwen3-moe-30b-a3b's MoE layer on ``mesh`` and with no
    mesh, on the same weights and input, at capacity factor E / k: no token
    drops, so the mesh's G groups (one per data rank) compute what one group
    does. Its schedule: ``dropping_ep`` where 'model' spans more than one
    rank, ``dropping`` on (1, 1)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models.params import init_params
    from repro_torch.sharding import spmd
    from repro_torch.sharding.specs import to_placements, to_pspec

    gc_collect(torch)
    cfg = get_arch("qwen3-moe-30b-a3b")
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.num_experts_per_tok)
    defs = moe.moe_defs(cfg)
    params = init_params(defs, 0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    x = torch.randn(*MESH_MOE_TOKENS, cfg.d_model, generator=gen, device=dev).to(torch.bfloat16)
    with torch.no_grad():
        ops.reset_counts()
        want, wm = moe.apply_moe(params, x, cfg)
        plain_counts = ops.counts()
        dparams = {k: spmd.distribute(v, mesh, spmd.strict_placements(defs[k].shape, defs[k].logical, rules, mesh))
                   for k, v in params.items()}
        dx = spmd.distribute(x, mesh, to_placements(to_pspec(x.shape, ("batch", "seq", None), rules), mesh))
        ops.reset_counts()
        got, gm = moe.apply_moe(dparams, dx, cfg, rules)
        counts = ops.counts()
        got = got.full_tensor()
    schedule = cfg.moe_impl if mesh.shape[mesh.mesh_dim_names.index("model")] > 1 else "dropping"
    return {"tokens": list(MESH_MOE_TOKENS), "schedule": schedule,
            "max_abs_err": (got.float() - want.float()).abs().max().item(),
            "max_abs_y": want.float().abs().max().item(), "bits_equal": bool(torch.equal(got, want)),
            "metrics_bits_equal": all(torch.equal(gm[k], wm[k]) for k in wm),
            "dropped": [gm["moe_dropped"].item(), wm["moe_dropped"].item()],
            "aux": [gm["moe_aux"].item(), wm["moe_aux"].item()], "counts": counts, "no_mesh_counts": plain_counts}


def _mesh_rank(rank: int, world: int, out_dir: str) -> None:
    """(b) in one rank's process (``launch.mesh.spawn``, NCCL, one card a
    rank): its results to ``out_dir``/rank<r>.json."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.sharding.specs import train_rules

    torch.backends.cuda.matmul.allow_tf32 = False
    build.load()  # the kernels the parent built, from their cache
    dev = torch.device("cuda", rank)
    mesh = make_smoke_mesh()
    rules = train_rules(mesh)
    t0 = time.perf_counter()
    train = mesh_rank_train(torch, dev, mesh, rules)
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    moe_out = mesh_rank_moe(torch, dev, mesh, rules)
    out = {"rank": rank, "world": world, "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "train": train,
           "train_s": train_s, "moe": moe_out, "moe_s": time.perf_counter() - t0}
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(out, f)


def mesh_nccl(torch) -> dict:
    """(b): spawn one rank per card over NCCL and check what they report."""
    import tempfile

    from repro_torch.launch.mesh import spawn

    gc_collect(torch)
    world = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as d:
        spawn(_mesh_rank, world, d, backend="nccl")
        ranks = [json.loads((Path(d) / f"rank{r}.json").read_text()) for r in range(world)]
    r0 = ranks[0]
    tr = r0["train"]
    fwd_bwd = ("flash_attention", *GRAD_KERNELS)
    for rk in ranks:
        a, b = rk["train"]["no_mesh"], rk["train"]["mesh"]
        rel = [abs(x - y) / abs(y) for x, y in zip(b["losses"], a["losses"])]
        # one rank: one program, every collective the identity, so equal bits
        ok = a["losses"] == b["losses"] if world == 1 else max(rel) <= MESH_LOSS_TOL
        check(all(map(math.isfinite, a["losses"] + b["losses"])) and ok,
              f"mesh_nccl rank {rk['rank']}: losses {b['losses']} on the mesh, {a['losses']} without")
        check(all(b["counts"][k] == a["counts"][k] > 0 for k in fwd_bwd),
              f"mesh_nccl rank {rk['rank']}: launches {b['counts']} on the mesh, {a['counts']} without")
        check(all(b["counts"][k] == a["counts"][k] for k in a["counts"] if k not in PLAIN),
              f"mesh_nccl rank {rk['rank']}: a kernel launched apart: {b['counts']} against {a['counts']}")
        check(not any(b["counts"][k] or a["counts"][k] for k in PLAIN),
              f"mesh_nccl rank {rk['rank']}: a plain version ran on the card: {b['counts']} {a['counts']}")
        m = rk["moe"]
        check(m["counts"]["moe_gmm"] > 0 and not any(m["counts"][k] for k in PLAIN),
              f"mesh_nccl rank {rk['rank']}: the MoE layer's launches {m['counts']}")
        ok = m["bits_equal"] and m["metrics_bits_equal"] if world == 1 else m["max_abs_err"] <= RTOL * m["max_abs_y"]
        check(ok, f"mesh_nccl rank {rk['rank']}: the MoE layer ({m['schedule']}) off by {m['max_abs_err']} "
                  f"(max |y| {m['max_abs_y']}), metrics {m['dropped']} {m['aux']}")
    mesh_launches = {k: tr["mesh"]["counts"][k] for k in fwd_bwd}
    return {"world": world, "mesh": r0["mesh"], "arch": "llama3.2-1b", "steps": MESH_TRAIN_STEPS,
            "batch": MESH_TRAIN_BATCH, "seq": TRAIN_SEQ, "lr": MESH_TRAIN_LR,
            "losses": {k: tr[k]["losses"] for k in ("no_mesh", "mesh")},
            "loss_rel_err": max(abs(x - y) / abs(y) for x, y in zip(tr["mesh"]["losses"], tr["no_mesh"]["losses"])),
            "step_ms": {k: tr[k]["step_ms"] for k in ("no_mesh", "mesh")},
            "step_ms_p50": {k: statistics.median(tr[k]["step_ms"][1:]) for k in ("no_mesh", "mesh")},
            "peak_allocated_gb": {k: tr[k]["peak_allocated_gb"] for k in ("no_mesh", "mesh")},
            "launches": mesh_launches, "no_mesh_launches": {k: tr["no_mesh"]["counts"][k] for k in fwd_bwd},
            "moe_layer": {k: r0["moe"][k] for k in ("tokens", "schedule", "max_abs_err", "max_abs_y", "bits_equal",
                                                    "metrics_bits_equal", "dropped", "aux")},
            "moe_launches": r0["moe"]["counts"]["moe_gmm"], "train_s": r0["train_s"], "moe_s": r0["moe_s"]}


def mesh_ep_ranks(torch, dev) -> dict:
    """(c): the MESH_EP_RANKS ranks' programs of a 4-way expert-parallel
    full-width qwen3 MoE layer, one after the other on this card, each
    with its combine's reduction left out (its partial sum); their sum
    against the layer with no mesh."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models.params import init_params
    from repro_torch.sharding import spmd
    from repro_torch.sharding.specs import train_rules

    class RankCtx(spmd.Ctx):
        """Rank ``r`` of a (1, m) mesh seen from one process: the only
        collective of the layer's program here (its tokens whole, one
        group) is the combine's reduction over 'model', left out."""

        def __init__(self, sizes: dict, coord: dict):
            self.mesh, self.names, self.sizes, self.coord = None, tuple(sizes), sizes, coord

        def reduce(self, x, axes):
            if not self.live(axes):
                return x
            check(tuple(axes) == ("model",), f"mesh_ep_ranks: a reduction over {axes}")
            return x

    gc_collect(torch)
    cfg = get_arch("qwen3-moe-30b-a3b")
    check(cfg.moe_impl == "dropping_ep", f"mesh_ep_ranks: {cfg.name} runs {cfg.moe_impl}")
    m, e = MESH_EP_RANKS, cfg.num_experts
    sizes = {"data": 1, "model": m}
    rules = train_rules(sizes)
    defs = moe.moe_defs(cfg)
    params = init_params(defs, 0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    x = torch.randn(*MESH_EP_TOKENS, cfg.d_model, generator=gen, device=dev).to(torch.bfloat16)
    specs = {k: spmd.spec_from_rules(d.shape, d.logical, rules, strict=True) for k, d in defs.items()}
    check(specs["wi_gate"][0] == ("model",) and not specs["router"].axes(), f"mesh_ep_ranks: specs {specs}")
    with torch.no_grad():
        ops.reset_counts()
        want, wm = moe.apply_moe(params, x, cfg)
        full_counts = ops.counts()
        total = torch.zeros_like(want, dtype=torch.float32)
        ranks = []
        for r in range(m):
            e_loc = e // m
            local = {k: (v if k == "router" else v[r * e_loc:(r + 1) * e_loc]) for k, v in params.items()}
            ops.reset_counts()
            rank = spmd.Rank(RankCtx(sizes, {"model": r}), rules, spmd.Act(), tuple(x.shape))
            part, pm = moe.apply_moe_local(local, specs, x, cfg, rank)
            counts = ops.counts()
            total += part.float()
            launched = counts["moe_gmm"] if dev.type == "cuda" else counts["gmm_ref"]  # the host: the plain K5
            check(launched == 3 and (dev.type != "cuda" or not any(counts[k] for k in PLAIN)),
                  f"mesh_ep_ranks rank {r}: launches {counts}")
            check(pm["moe_dropped"].item() == wm["moe_dropped"].item(),
                  f"mesh_ep_ranks rank {r}: dropped {pm['moe_dropped'].item()}, unsharded {wm['moe_dropped'].item()}")
            ranks.append({"rank": r, "experts": [r * e_loc, (r + 1) * e_loc], "moe_gmm": launched,
                          "partial_max_abs": part.float().abs().max().item()})
    err = (total - want.float()).abs().max().item()
    ymax = want.float().abs().max().item()
    check(err <= MESH_EP_TOL * ymax, f"mesh_ep_ranks: the partials' sum off by {err} (max |y| {ymax})")
    return {"what": "each rank's program of a 4-way EP MoE layer, run one after the other on one card",
            "arch": cfg.name, "tokens": list(MESH_EP_TOKENS), "ranks": ranks, "max_abs_err": err,
            "max_abs_y": ymax, "rel_err": err / ymax, "dropped": wm["moe_dropped"].item(),
            "unsharded_moe_gmm": full_counts["moe_gmm"]}


def mesh_phase(torch, dev) -> dict:
    """Phase 17 (see the module docstring): its lines, and the launches of
    each of its paths for the kernels line."""
    seconds = {}
    t0 = time.perf_counter()
    ep = mesh_ep_ranks(torch, dev)
    print(json.dumps({"mesh_ep_ranks": ep}), flush=True)
    seconds["ep_ranks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    nccl = mesh_nccl(torch)
    print(json.dumps({"mesh_nccl": nccl}), flush=True)
    seconds["nccl"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cells = mesh_dryrun_cells(torch)
    print(json.dumps({"mesh_dryrun": cells}), flush=True)
    seconds["dryrun"] = time.perf_counter() - t0
    print(json.dumps({"mesh_seconds": {**seconds, "total": sum(seconds.values())}}), flush=True)
    print(f"mesh phase {sum(seconds.values()):.1f} s", file=sys.stderr)
    return {"launches": {"llama3.2-1b mesh train": nccl["launches"],
                         f"qwen3-moe-30b-a3b mesh ({nccl['moe_layer']['schedule']})": {"moe_gmm": nccl["moe_launches"]},
                         "qwen3-moe-30b-a3b EP rank programs": {"moe_gmm": sum(r["moe_gmm"] for r in ep["ranks"])}}}


def gc_collect(torch) -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def chrome_export(path: Path) -> dict:
    """Every live tracer's records (the llama phases') as one Chrome
    ``trace_event`` file at ``path``, parsed back."""
    from repro_torch.obs import export_all_chrome

    path.parent.mkdir(parents=True, exist_ok=True)
    written = export_all_chrome(str(path))
    doc = json.loads(path.read_text())
    events = doc["traceEvents"]
    check(len(events) == written and all(ev["ph"] in ("X", "i", "M") for ev in events),
          f"chrome trace: {len(events)} events parsed back of {written} written")
    return {"path": str(path.relative_to(ROOT)), "events": len(events), "bytes": path.stat().st_size,
            "tracers": len({ev["pid"] for ev in events}),
            "spans": sum(1 for ev in events if ev["ph"] == "X")}


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        raise SmokeFailure(f"{SRC / 'repro_torch'} is missing: run from a checkout of the repository")
    sys.path.insert(0, str(SRC))
    import os

    # the train restart phase runs under torch.use_deterministic_algorithms,
    # which needs cuBLAS's workspace fixed before the first handle is made
    # (":4096:8" is PyTorch's default size on Hopper, so nothing else changes)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device is available")
    # full float32 matmuls wherever fp32 appears (norms, RoPE, logits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device_kind = torch.cuda.get_device_name(0)
    dev_line = device_line()
    print(dev_line, flush=True)

    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.load()
    build_s = time.perf_counter() - t0
    print(f"kernels built in {build_s:.1f} s", file=sys.stderr)
    ptxas = ptxas_report(build.build_report())
    print(json.dumps({"ptxas": ptxas}), flush=True)
    grad_ptxas = {k: v for k, v in ptxas.items() if k.startswith("flash_bwd")}
    check(len(grad_ptxas) == 9 and all(any(" 0 bytes spill stores, 0 bytes spill loads" in line for line in lines)
                                       for lines in grad_ptxas.values()),
          f"K3's gradient: an instantiation spills or is missing from the ptxas report: {grad_ptxas}")

    from repro_torch.configs import get_arch

    from repro_torch.obs import retain_tracers

    cfg, dev = get_arch("llama3.2-1b"), torch.device("cuda")
    t0 = time.perf_counter()
    kern = kernel_phase(torch, F)
    t1 = time.perf_counter()
    kern["flash_attention_bwd"] = flash_grad_cases(torch, F)
    torch.cuda.empty_cache()  # the plain backward's fp32 scores
    grad_cases_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    kern["moe_gmm_bwd"] = moe_grad_cases(torch)
    kern["ssd_scan_bwd"] = ssd_grad_cases(torch)
    torch.cuda.empty_cache()
    family_grad_cases_s = time.perf_counter() - t1
    print(json.dumps({"grad_refusal": grad_refusal_check(torch)}), flush=True)
    print(f"kernel phase {time.perf_counter() - t0:.1f} s (K3's gradient cases {grad_cases_s:.1f} s, K5's and "
          f"K6's {family_grad_cases_s:.1f} s)", file=sys.stderr)
    t0 = time.perf_counter()
    print(json.dumps({"long_kernels": long_kernel_cases(torch, F)}), flush=True)
    dry = dryrun_phase(torch, dev)
    print(json.dumps({"dryrun": dry["cells"]}), flush=True)
    print(f"dryrun phase {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    retain_tracers(True)  # the llama phases' traces outlive their platforms, for the export
    t0 = time.perf_counter()
    serve_tokens: list = []
    serve = serve_phase(torch, dev, cfg, dispatch_window=True, tokens_out=serve_tokens)
    trace_serve, dispatch = serve.pop("trace"), {"serve": serve.pop("dispatch")}
    print(json.dumps({"serve": serve}), flush=True)
    print(json.dumps({"trace_serve": trace_serve}), flush=True)
    print(f"serve phase {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    t0 = time.perf_counter()
    paged = paged_serve_phase(torch, dev, cfg, small_cfg=small_config(cfg), dispatch=True)
    dispatch["paged_serve"] = paged.pop("dispatch")
    print(json.dumps({"paged_serve": paged}), flush=True)
    print(f"paged serve phase {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    t0 = time.perf_counter()
    print(json.dumps({"reference": reference_phase(torch, dev, cfg)}), flush=True)
    print(f"reference phase {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    t0 = time.perf_counter()
    print(json.dumps({"profile": profile_phase(torch, dev, cfg, gap=True)}), flush=True)
    print(f"profile phase {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    t0 = time.perf_counter()
    batched = batched_phase(torch, dev, cfg)
    trace_batched, dispatch["batched"] = batched.pop("trace"), batched.pop("dispatch")
    print(json.dumps({"batched": batched}), flush=True)
    print(json.dumps({"trace_batched": trace_batched}), flush=True)
    print(json.dumps({"dispatch": dispatch}), flush=True)
    print(f"batched phase {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    t0 = time.perf_counter()
    coldstart = coldstart_phase(torch, dev, cfg)
    print(json.dumps({"coldstart": coldstart}), flush=True)
    print(f"coldstart phase {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    print(json.dumps({"chrome_trace": chrome_export(ROOT / "chiprun_out" / "trace_llama.json")}), flush=True)
    retain_tracers(False)

    control = control_plane_phases(torch, dev, cfg, serve, serve_tokens)
    training = training_phases(torch, dev, cfg)
    training["seconds"]["grad_cases"] = grad_cases_s
    print(json.dumps({"train_seconds": {**training["seconds"], "build": build_s,
                                        "total": sum(training["seconds"].values())}}), flush=True)

    moe = moe_phases(torch, dev)
    ssm = ssm_phases(torch, dev, "mamba2-370m", "ssm")
    t0 = time.perf_counter()
    ssm_cfg, ssm_params, _ = fresh_model(torch, dev, "mamba2-370m")
    ssm_cold = ssm_coldstart_phase(torch, dev, ssm_cfg, params=ssm_params)
    del ssm_params
    print(json.dumps({"ssm_coldstart": ssm_cold}), flush=True)
    print(f"ssm coldstart phase {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    hybrid = ssm_phases(torch, dev, "zamba2-7b", "hybrid")
    decoders = {arch: decoder_phases(torch, dev, arch, key, paged) for arch, key, paged in DECODERS}
    t0 = time.perf_counter()
    print(json.dumps({"launch_serve": launch_serve_phase(torch, dev)}), flush=True)
    print(f"launch_serve phase {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    encdec = encdec_phases(torch, dev)
    family = family_training_phases(torch, dev)
    family["seconds"]["grad_cases"] = family_grad_cases_s
    print(json.dumps({"family_train_seconds": {**family["seconds"], "total": sum(family["seconds"].values())}}),
          flush=True)
    mesh = mesh_phase(torch, dev)
    fam = family["launches"]
    train_launches = training["launches"]
    check(len({train_launches[k] for k in GRAD_KERNELS}) == 1,
          f"train: the three backward kernels launched apart: {train_launches}")
    launches = {**serve["launches"], **paged["launches"]["fused"], "moe_gmm": moe["launches"]["moe_gmm"],
                "ssd_scan": ssm["launches"]["ssd_scan"] + hybrid["launches"]["ssd_scan"],
                "flash_attention_bwd": train_launches["flash_attention_bwd"],
                "moe_gmm_bwd": fam["moe"]["moe_gmm_bwd_dx"],
                "ssd_scan_bwd": fam["ssm"]["ssd_scan_bwd_walk"] + fam["hybrid"]["ssd_scan_bwd_walk"]}
    check(launches["moe_gmm_bwd"] > 0 and launches["ssd_scan_bwd"] > 0,
          f"the families' training ran no K5 or K6 gradient: {fam}")
    by_path = {name: {"llama3.2-1b": serve["launches"][name], "qwen3-moe-30b-a3b": moe["launches"][name],
                      "zamba2-7b": hybrid["launches"][name],
                      "llama3.2-1b coldstart": coldstart["launches"][name],
                      **{f"llama3.2-1b {path}": n[name] for path, n in control.items()}}
               for name in ("flash_attention", "decode_attention")}
    by_path["ssd_scan"] = {"mamba2-370m": ssm["launches"]["ssd_scan"], "zamba2-7b": hybrid["launches"]["ssd_scan"],
                           "mamba2-370m coldstart": ssm_cold["launches"]["ssd_scan"]}
    for kernel in ("paged_decode_attention", "paged_chunk_attention"):
        by_path[kernel] = {"llama3.2-1b paged": paged["launches"]["fused"][kernel],
                           "qwen3-moe-30b-a3b paged": moe["paged_launches"][kernel],
                           "llama3.2-1b coldstart paged": coldstart["paged_launches"]["after"][kernel]}
    for arch, run in decoders.items():  # each count from that phase's own counters
        for kernel in ("flash_attention", "decode_attention"):
            by_path[kernel][arch] = run["launches"][kernel]
        for kernel, n in run.get("paged_launches", {}).items():
            by_path[kernel][f"{arch} paged"] = n
    for kernel in ("flash_attention", "decode_attention"):
        by_path[kernel][ENCDEC_ARCH] = encdec["launches"][kernel]
    by_path["flash_attention"]["llama3.2-1b train"] = train_launches["flash_attention"]
    by_path["flash_attention"][f"{ENCDEC_ARCH} train"] = encdec["train_launches"]["flash_attention"]
    by_path["flash_attention_bwd"] = {"llama3.2-1b train": {k: train_launches[k] for k in GRAD_KERNELS},
                                      f"{ENCDEC_ARCH} train": {k: encdec["train_launches"][k] for k in GRAD_KERNELS}}
    by_path["moe_gmm"] = {"qwen3-moe-30b-a3b": moe["launches"]["moe_gmm"],
                          "qwen3-moe-30b-a3b paged": moe["paged_launches"]["moe_gmm"],
                          "qwen3-moe-30b-a3b train": fam["moe"]["moe_gmm"]}
    by_path["ssd_scan"].update({"mamba2-370m train": fam["ssm"]["ssd_scan"],
                                "zamba2-7b train": fam["hybrid"]["ssd_scan"]})
    for key, arch in (("moe", "qwen3-moe-30b-a3b"), ("hybrid", "zamba2-7b")):
        by_path["flash_attention"][f"{arch} train"] = fam[key]["flash_attention"]
        by_path["flash_attention_bwd"][f"{arch} train"] = {k: fam[key][k] for k in GRAD_KERNELS}
    by_path["moe_gmm_bwd"] = {"qwen3-moe-30b-a3b train": {k: fam["moe"][k] for k in MOE_GRAD_KERNELS}}
    by_path["ssd_scan_bwd"] = {f"{arch} train": {k: fam[key][k] for k in SSD_GRAD_KERNELS}
                               for key, arch in (("ssm", "mamba2-370m"), ("hybrid", "zamba2-7b"))}
    for label, n in dry["launches"].items():  # the dry run's executed steps
        for kernel in ("flash_attention", "decode_attention", "ssd_scan"):
            if n.get(kernel):
                by_path[kernel][f"{label} dryrun"] = n[kernel]
        if n.get("flash_attention_bwd"):
            by_path["flash_attention_bwd"][f"{label} dryrun"] = {k: n[k] for k in GRAD_KERNELS}
    mesh_train = mesh["launches"]["llama3.2-1b mesh train"]
    by_path["flash_attention"]["llama3.2-1b mesh train"] = mesh_train["flash_attention"]
    by_path["flash_attention_bwd"]["llama3.2-1b mesh train"] = {k: mesh_train[k] for k in GRAD_KERNELS}
    for label, n in mesh["launches"].items():
        if label.startswith("qwen3-moe-30b-a3b"):
            by_path["moe_gmm"][label] = n["moe_gmm"]
    captured = {"ssd_scan": [ssm["captured"], hybrid["captured"]]}
    part_src = {"flash_attention": serve["launch_parts"], "decode_attention": serve["launch_parts"],
                "paged_decode_attention": paged["launch_parts"]["fused"],
                "paged_chunk_attention": paged["launch_parts"]["fused"], "moe_gmm": moe["parts"]}
    parts = {k: {p: src[p][k] for p in ("eager", "replayed")} for k, src in part_src.items()}
    parts["ssd_scan"] = {p: ssm["parts"][p]["ssd_scan"] + hybrid["parts"][p]["ssd_scan"]
                         for p in ("eager", "replayed")}
    for kernel in ("flash_attention_bwd", "moe_gmm_bwd", "ssd_scan_bwd"):  # training: eager
        parts[kernel] = {"eager": launches[kernel], "replayed": 0}
    print(json.dumps(kernels_line(kern, launches, by_path, captured, parts)), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_kind,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
