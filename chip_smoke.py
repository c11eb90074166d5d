#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; the first failure ends the run with a non-zero exit:

1. torch / CUDA versions and the card's name and power limit.
2. Build every CUDA kernel of the port from `src/repro_torch/kernels/csrc`
   (one nvcc per source, started together); ptxas' registers, stack frame
   and spills of every rowcol_fold_kernel instantiation are logged, and a
   stack frame or a spill fails the run.
3. Each kernel against its plain PyTorch version on the card, bit for bit,
   with the median time of each over CUDA-event-timed runs beside the least
   time the card could take for the same work:
   - first, each instruction sequence of the int8-m rowcol fold's design
     against the expression it replaces (fused_step.fold_exactness), bit
     for bit, the inputs compared logged: the pair decode of every e4m3
     code; the hardware flush of all 2^32 floats; flushed adds around
     +-2^-126; the flushed square of all 2^32 floats; and the int8 m codes
     through the row's reciprocal against the divide's, for every x of 9
     binades of a grid of divisors, edges and row maxima. The card's own
     flushed product and fma around +-2^-126 (ties included), which part
     from fl and which the kernel therefore does not use, are logged with
     the count of results that differ;
   - arena_fold / arena_apply at the full bert-large arena (357,888 x 1024)
     and at a ragged 8-row arena;
   - arena_fold_slice on the full arena, for layer 0, layer 23 and the rest
     region, with and without the fused decay; every row outside the slice
     must be unchanged;
   - adama_accum_2d / adam_apply_2d at the bert-large embedding leaf, one
     layer's wq (a view into a stacked leaf; the stacked wq for the apply),
     a 1024-element norm view inside a stacked leaf, and a ragged odd size
     at a pointer that is not 16-byte aligned; the apply with and without
     weight decay.
   - rwkv6_chunk_scan (forward) and rwkv6_chunk_scan_bwd (backward) at
     the rwkv6-7b training shape (BH 128, S 4096, K = V = 64), at one
     chunk (BH 3, S 64), and at BH 4, S 512, where two halves run with the
     carried state must equal one run; nonzero s0 and ds_final, each
     output within 2e-5 of its largest |value| of the plain version's; the
     backward also through the torch.autograd.Function; both also at BH
     3, S 96 with each other chunk, K and V the kernels take (chunk 32,
     K 16, V 48; chunk 48, K 48, V 32; chunk 16, K 32, V 16). Forward
     and backward also at BH 4, S 512 with logw at both ends of the
     model's clip (-e^8, -e^-20): finite and within the same 2e-5. The
     forward's bound is a tensor-core design's (products at the TF32
     rate), the fp32-core figure logged beside it; torch.profiler counts
     the kernels one forward call and one backward call run.
   - the codec forms of arena_fold, arena_fold_slice and arena_apply, all
     eight (m, v) pairs (m fp32/int8, v fp32/int8/factored/rowcol), on a
     64-row arena whose first rows are edge cases (a zero row, rows whose
     max/127 is subnormal, subnormal g^2 terms, values on code
     boundaries, a row of one sign, -0.0 in m), bit for bit: a first
     fold with the decay, a later fold at scale 0.25, the slice fold of
     rows [16, 48) (rows outside unchanged) and the apply with and
     without weight decay; the rowcol pairs also on a 1,000-row arena
     (16 ranges of rowcol's partition, the last one short): a fold with
     the decay, three slice folds in a row and the apply. Then int8/int8,
     int8/factored, fp32/rowcol and int8/rowcol at the full stablelm-1.6b
     arena (1,607,424 rows): the fold, one layer slice, the rest slice at
     its real row offset and the apply, each bit for bit (every column of
     the arena) against its plain version, then timed; torch.profiler
     counts the device kernels of one rowcol fold, slice fold and apply.
   - the guarded forms of arena_fold, arena_fold_slice and arena_apply
     (the guard vector [dm, dv, ok, scale] on the card), all eight pairs
     on the 64-row edge arena and the rowcol pairs on 1,000 rows, bit for
     bit against their plain versions: ok = 1 at the traced scale
     f32(1/8) / f32(3), ok = 0 leaving every byte (rowcol's column sums
     and p, at bc1 = 0 too), and ok = 1 at f32(1/8) equal to the
     unguarded kernels; finite_and on fp32 and bf16 (one NaN, +Inf or
     -Inf at the first or the last element, also at a view off 16-byte
     alignment; rows of subnormals and of the largest values). Then the
     guarded fp32/fp32 and int8/rowcol fold, layer and rest slices and
     apply at the stablelm arena, bit for bit against the plain versions
     and the unguarded kernels, timed in turns beside the unguarded ones;
     torch.profiler counts finite_and + one guarded fold as two device
     kernels; finite_and at the stablelm arena's, a layer's, the rest's
     and the bert-large arena's slab, timed beside torch.isfinite(x).all()
     and torch.isfinite(torch.aminmax(x)), allocating nothing.
   - the bf16 gradient wire of arena_fold and arena_fold_slice: every
     pair's fold (with the decay; at scale 0.25), slice fold and both
     guarded (ok = 1 at the traced scale, ok = 0 on a slab holding a NaN)
     on a bf16 slab, on the 64-row edge arena and for the rowcol pairs on
     1,000 rows, bit for bit against the plain versions and against the
     fp32-wire kernels fed the same slab upcast; then fp32/fp32, int8/int8
     and int8/rowcol at the stablelm arena (fold, layer and rest slices),
     bit for bit both ways over the whole arena, timed in turns beside the
     fp32-wire kernel against the bound of a 2-byte g; finite_and on the
     bf16 slab, timed beside torch.isfinite(x).all().
   - the master form of arena_apply (master params: p the fp32 master, a
     bf16 work output): every pair, unguarded, guarded ok = 1 and ok = 0
     at bc1 = 0, weight decay 0 and 0.01, on the 64-row edge arena whose p
     holds bf16 rounding edges (ties of both parities, carries, values
     rounding past bf16's largest finite value, subnormals, zeros) and for
     the rowcol pairs on 1,000 rows: the master against the plain-form
     kernel and the plain version, the work against torch's cast of the
     master on the card and the plain version's work, bit for bit; with
     ok = 0 the master keeps every byte and the work is bf16 of it. Then
     fp32/fp32 and int8/rowcol at the stablelm arena, bit for bit over the
     whole arena, timed in turns beside the plain-form apply.
   - the fp8 (e4m3) gradient wire: fp8_encode (the error-feedback residual
     injected at S = 1, 2^15 and 1000, and without it) on 64-row slabs with
     the codec edge rows, a row whose max is 1e-37 (the scale's fallback),
     a row of e4m3 ties +-1 ulp whose max lands on 448 (scale 1.0), a NaN
     row beside a finite 1000 and +inf and -inf rows, codes (NaN codes
     compared as NaN), scales and the finite flag bit for bit against the
     plain version; the kernel's conversion against the card's torch cast
     on the tie row; fp8_ef_update with ok = 1 and ok = 0; every pair's
     e4m3 fold and slice fold of those codes (zero, subnormal and +-448
     codes, scales 1.0 and 1e-37), unguarded, guarded ok = 1 at the traced
     scale and ok = 0 on NaN codes, on the 64-row edge arena and for the
     rowcol pairs on 1,000 rows, bit for bit. Then at the stablelm arena:
     fp8_encode with the residual and fp8_ef_update, bit for bit over the
     whole arena and timed; the e4m3 fold, a layer slice and the rest slice
     for fp32/fp32 and int8/rowcol, bit for bit and timed in turns beside
     the bf16 wire; torch.profiler counts one device kernel per call of the
     encode, the update and each pair's e4m3 fold.
4. A small-input check. First ga's accumulation step (acc + pack / N as
   the reference's XLA CPU computes it: a fused multiply-add by f32(1/3),
   two roundings on the padded leaves whose pad XLA fuses into the sum,
   `uncontracted_rows`) on the card against the CPU, bit for bit, on the
   arena layouts of the reduced models (reduced whisper-base and
   internvl2-26b too), of a deepseek-v2-lite-16b at d_model 1024 whose
   only padded stacked leaf is kv_norm and of a whisper-base at its own
   widths with one layer a stack (its two stacked regions and six rest
   leaves, four of them half-row norms, past XLA CPU's fusion limit of 8
   concatenate operands: no row uncontracted). Then
   rope_freqs on the card against the CPU, bit for bit, at head_dim 64
   and 128 and theta 1e4 and 1e6 (how many frequencies torch's float32
   pow on the card would give otherwise is logged). Then the hybrid
   block's Mamba heads (mamba_mix) and the hybrid block at the reduced
   hymba-1.5b (d_model 256, d_inner 512, seq 80, past the window of 64),
   fp32, on the card against the CPU: the output and the gradients of
   every leaf and of x, each within 5e-6 of its largest |value| on the
   CPU. Then
   reduced bert-large trained 2 steps on the card
   (kernels) and on the CPU (plain versions) from the same params agree,
   for adama, adama_layerwise (arena and per-leaf state) and per-leaf
   adama; so does reduced rwkv6-7b for adama and adama_layerwise, and
   reduced stablelm-1.6b (3 steps) for adama with int8/int8 state and
   adama_layerwise with int8/factored and int8/rowcol state, the last
   also guarded with a NaN at micro-batch 1 of step 1 (one skip on both
   sides), reduced mistral-nemo-12b (swa, window 64) and minicpm3-4b
   (mla, with a q low-rank projection) at seq 128 and reduced
   deepseek-v2-lite-16b (MoE, 3 layers: 2 MoE, 1 dense) at seq 32 and
   reduced hymba-1.5b (hybrid) at seq 128 for adama, adama_layerwise and
   ga at 3 micro-batches, and reduced whisper-base (enc-dec: one encoder
   and one decoder layer over 64 frames) and internvl2-26b (vlm: 16
   patches before the text) at seq 32, adama, adama_layerwise and ga,
   all three at 3 micro-batches: every param within 2e-5, or within the
   codecs' declared drift for at most 15% of them.
5. The main paths: bert-large at full width and depth, bf16 compute, fp32
   params and state, seq 128, global batch 256, 8 micro-batches: 3 steps of
   `adama`, of the `ga` baseline and of `adama_layerwise` (Algorithm 2,
   arena state), and 2 steps each of the per-leaf forms of
   `adama_layerwise` and `adama`, with per-step loss, step time and peak
   device memory. Then the data-parallel phase (core/dp_shardmap.py) on
   a one-rank NCCL group opened in this process (`file://` rendezvous):
   `dp_ga`, `dp_adama` (replicated, arena), `zero1_adama` (row-range
   ZeRO-1, full pack), `zero1_adama_bucketed` (the bucketed schedule)
   and `zero1_adama_layerwise` (Algorithm 2's ZeRO-1 stream) in
   bert-large's setting, 2 steps each, with every launch and collective
   count set to 0 just before each and read just after (8 folds + 1
   apply a step, none for ga's plain Adam; bucketed and streamed, 8 x 39
   slice folds + 1 apply; the collectives' calls and bytes as the
   schedule gives them: 312 reduce-scatters of 11,720,982,528 B a step
   bucketed, the padding bucket never sent): `dp_adama`, `zero1_adama`
   and `zero1_adama_bucketed` must end on `adama`'s params, m and v after
   2 steps bit for bit (digests) with its losses, `zero1_adama_layerwise`
   on `adama_layerwise`'s; guarded `zero1_adama` and the guarded stream
   with a NaN on rank 0's gradient (its backward's seed) at micro-batch 1
   (`nan@micro=1,device=0`) must equal their `skip@micro=1` twins bit for
   bit, ZeRO-1 int8/rowcol runs, and bucketed int8/rowcol after one step
   must equal the full pack's in every row-indexed column (digests), its
   column sums within the float32 bound of the two orders, all at 8 of 24
   layers; `zero1_adama` must peak at most the owned gradient rows + 2
   MiB above `adama`, `zero1_adama_bucketed` at most 2 MiB above
   `zero1_adama`, `zero1_adama_layerwise` at most the owned rows + 2 MiB
   above `adama_layerwise` and at least two fp32 arenas below both
   ZeRO-1 `adama` paths (the bucketed pair's and the stream's peak sites,
   from the allocator's history, logged), and `dp_ga` (in requested
   bytes) at least one fp32 gradient tree less twice the arena's row
   padding above `zero1_adama` (ga's m and v are per-leaf trees, the
   arenas' rows padded; the one-tree claim is logged beside it). Then
   ZeRO-1 emulated at 4 ranks over bert-large's arena laid out for 4
   ranks (358,400 rows): for fp32/fp32, int8/int8, int8/factored,
   fp32/rowcol and int8/rowcol, the first fold of a mini-batch and the
   apply on every rank's row-range view, and on its owned rows of the
   bucketed schedule (its slice of every bucket folded at its
   own_offset, then unpermuted), against the whole arena's, bit for bit
   on every row-indexed column and p, rowcol's column sums (the ranks'
   partials summed in rank order) within the float32 bound of the two
   summation orders (queue 3 (j)'s 1e-6 logged beside it); each rank's
   fold and apply timed beside the whole arena's, and the slice fold on
   a 4,096-row rest bucket, a 12,352-row layer bucket and their 4-rank
   slices (1,024 and 3,088 rows). ROADMAP 10.2's second half, at 8
   layers (`DP_WIRE_MASTER`): bucketed ZeRO-1 on the bf16 wire with
   master params, beside the fp32-wire bucketed path, and the guarded
   stream on the bf16 wire with a master and dynamic scaling (a NaN on
   rank 0 in step 1), each ending on its single-device twin (`adama` /
   `adama_layerwise` with the same fields) bit for bit (params, master,
   m and v by digests; losses), peaking at most its fp32-wire DP twin
   without a master + the owned master rows + 1 MiB, its gradient
   reduce-scatters and param all-gather moving exactly half its DP
   twin's bytes (the step at most 0.55x); then the bucketed master path
   crashed after step 2's update (`crash@step=1`) and resumed from its
   step-1 checkpoint over the group, ending on the clean run bit for
   bit, at most 1 MiB above its peak. Then rwkv6-7b at full width
   (d_model 4096, 64 heads of 64, d_ff 14336, vocab 65536) with its
   depth cut from 32 to 4 layers,
   seq 4096 (train_4k) and global batch 16 (cut from 256), 8 micro-batches:
   3 steps each of `adama`, `ga` and `adama_layerwise`. Then stablelm-1.6b
   at full width and depth (24 layers, d_model 2048), seq 1024 (cut from
   4096), global batch 16, 8 micro-batches: 3 steps each of `adama`, `ga`
   and `adama_layerwise` with fp32 state, `adama` with int8/int8, with
   int8/factored, with fp32/rowcol and with int8/rowcol state, and
   `adama_layerwise` with int8/int8 and with int8/rowcol state; then the
   guarded paths (finite_guard): `adama` fp32 clean, with a NaN and with
   a forced skip at micro-batch 3 of step 1, `adama_layerwise` int8/rowcol
   the same three ways, and `ga` fp32 with a NaN at micro-batch 0 of step
   0 (2 steps). Each path runs with every launch count set to 0 just
   before it and read just after: every fold, apply, scan and finite flag
   must have gone through the kernels, as many times as the path's
   schedule says. `adama` and `adama_layerwise` on the same arena state
   must agree in every step's loss. The compressed state must lower each
   peak by at least its exact bytes. A digest of the params, m and v
   computed on the card holds the guard bitwise: a clean guarded path
   equals its unguarded twin, a caught NaN equals a forced skip and
   differs from the clean run; guarded ga leaves the params as they were,
   its step at 0; every guarded path peaks at most 1 MiB above its twin.
   Last, the bf16 gradient wire (grad_dtype="bf16"), 3 steps each:
   `adama` fp32 and `adama_layerwise` int8/rowcol, and guarded `adama`
   fp32 with dynamic loss scaling and a NaN at micro-batch 3 of step 1,
   each beside its fp32-wire twin: a peak at most 1 MiB above the
   twin's, the twin's launches per step, the twin's step-1 loss bit for
   bit, params after step 1 within the pair's declared bf16_wire_lr x lr
   of the twin's and at most CODE_FLIP_FRAC of them beyond
   SMALL_PARAM_TOL (compared against a host copy), and the dynamic scale
   at 2^14 after the skip with the step counter full.
   Then master params (master_params=True), each beside its twin without
   them: `adama` fp32 (3 steps; its step-1 loss and its master after step
   1 the twin's, bit for bit, by a digest on the card), `adama_layerwise`
   int8/rowcol on the bf16 wire with the bf16 working-param cache (3
   steps; the apply writes into the cache and allocates nothing), and
   guarded `ga` with a NaN at micro-batch 0 of step 0 (2 steps, both
   skipped: the master stays pack(initial params), the leaves become
   bf16(initial params)). After every step the param leaves are exactly
   bf16(master), and the cache too; each path launches its twin's kernels
   per step and peaks at most its twin's peak + its new regions' bytes
   (as the caching allocator holds them: rounded up to 2 MiB) + 1 MiB.
   Last, the fp8 e4m3 gradient wire with its error-feedback residual
   (grad_dtype="fp8_e4m3", guarded), 3 steps each: `adama` fp32 clean,
   with a NaN and with a forced skip at micro-batch 3 of step 1, and
   `adama_layerwise` int8/rowcol with dynamic loss scaling and a NaN there,
   each beside its fp32-wire guarded twin: the twin's step-1 loss bit for
   bit; per micro-batch an encode, a fold and a residual update per slab
   (and the layer-wise pre-backward finite_and); params after step 1
   within the pair's declared fp8_wire_lr x lr of the twin's, the update's
   sign the twin's on at least 99% of the params whose twin update exceeds
   lr / 2; NaN == skip bit for bit on params, m, v and ef (digests); a
   finite, non-zero residual; the dynamic scale at 2^14; a peak at most the
   twin's + the residual + the largest codes buffer (each as allocated) +
   1 MiB.
   Then mistral-nemo-12b (swa: 32 heads on 8 kv heads, head_dim 128,
   window 4096, rope theta 1e6) at full width with its depth cut from 40
   to 2 layers, seq 8192 (past the window) in 8 micro-batches of 1: `ga`
   and `adama` with remat and `adama_layerwise`, 2 steps each: finite
   losses, step-1 losses within 10% of ln(V_pad) + d_model x 0.02^2 / 2
   (`first_step_loss`: the cross entropy of the init's logits) and within
   1e-4 of each
   other, the launches per step, ga + remat at least one fp32 arena and
   at most that arena as allocated + 2 MiB above adama + remat (in the
   bytes their tensors request at the peak, beside the allocated peaks),
   adama_layerwise below adama + remat; and micro-batch 0's loss under
   the same params with window=None (a no-grad forward) differs from
   its loss with the window. Then minicpm3-4b (mla: q low rank 768, kv
   latent 256, q/k heads of 64 + 32, v of 64) at full width with its
   depth cut from 62 to 24 layers, seq 1024, 8 micro-batches of 2:
   `adama`, `ga` and `adama_layerwise`, 2 steps each, held to the claims
   of the other models. Last, deepseek-v2-lite-16b (MoE: 64 routed
   experts of 1408 + 2 shared, top-6, capacity 120 a row; mla without a
   q low-rank projection) at full width with its depth cut from 27 to 4
   layers (the dense prefix layer and 3 MoE layers), seq 1024, 8
   micro-batches of 2: `adama`, `ga` and `adama_layerwise`, 3 steps each,
   held to the other models' claims but Algorithm 2's, which is the
   whole-model fp32 gradient below adama here (its MAIN entry's
   layerwise_gap: both peak at a pack, Algorithm 2 at the apply's of the
   params, adama at its gradient's, with the tree beside it); the three
   step-1 losses
   equal bit for bit; step 1 of `adama` run again from the seed ending on
   the same params, m and v (digests); and on micro-batch 0 the first MoE
   layer's routing, top-k and route_row, on the card and on the CPU: the
   same ids and gates, buffers bit for bit, the same token and gate maps,
   the copies dropped past each expert's capacity logged; and rows 1-3
   at its arena of 2.26e9 elements, past 2^31 (the fold and the apply of
   the whole arena, the slice folds of an MoE layer, the dense layer and
   the rest at their offsets), each bit for bit against its plain
   version on the same m, v (and p), then timed beside it and its bound.
   Last, hymba-1.5b (hybrid: sliding-window attention, 25 heads on 5 kv
   heads of 64, window 1024, and Mamba heads, d_inner 3200, state 16, side
   by side in every block) at full width with its depth cut from 32 to 8
   layers, seq 2048 (past the window) in 8 micro-batches of 1: `ga` and
   `adama` with remat and `adama_layerwise`, 2 steps each, held to
   mistral-nemo-12b's claims (and its window check).
   Then whisper-base (enc-dec: 6 encoder and 6 decoder layers, d_model
   512, 8 heads of 64, d_ff 2048, vocab 51865 padded to 51968, 1500 stub
   frames) at full size, its decoder at its published context of 448,
   global batch 16 (cut from 256) in 8 micro-batches of 2: `adama`, `ga`
   and `adama_layerwise` (Algorithm 2's enc-dec form: 8 x (6 decoder + 6
   encoder + 1 rest) = 104 slice folds a step), 2 steps each, held to
   bert-large's claims (ga at least one fp32 arena above adama, Algorithm
   2 at least two below it, equal step-1 losses, launches per step), then
   rows 1-3 at its arena as at the MoE arch's (a decoder layer's, an
   encoder layer's and the rest's slices). Last, internvl2-26b (vlm:
   48 heads on 8 kv heads of 128, d_ff 16384 gated, vocab 92553 padded
   to 92672) at full width with its depth cut from 48 to 4 layers, 1024
   text tokens (cut from 32,768) after its 256 stub patches, in 8
   micro-batches of 1: `ga` and `adama` with remat and `adama_layerwise`,
   2 steps each, held to mistral-nemo-12b's claims, Algorithm 2 at least
   the fp32 gradient below adama + remat (MAIN's layerwise_gap, as
   deepseek's), then rows 1-3 at its arena (2.70e9 elements: a layer's
   and the rest's slices).

6. Activation checkpointing (RunConfig.remat: each layer under
   torch.utils.checkpoint, recomputed in the backward), each path with
   every launch count set to 0 just before it: bert-large `adama` and `ga`
   with remat (3 steps) and rwkv6-7b `adama` with remat (3 steps), as in
   phase 5, each equal to its phase-5 twin bit for bit (losses; params, m
   and v by digests on the card), launching its twin's kernels per step
   (rwkv6: the forward scan twice per layer and micro-batch, the backward
   scan once) and peaking below it; then stablelm-1.6b at its published
   max_seq_len 4096 (the cut to 1024 lifted) with its depth cut to 16 of
   24 layers, global batch 16, 8
   micro-batches: `ga` and `adama` with remat and `adama_layerwise`, 2
   steps each: finite losses, each step-1 loss within 10% of
   `first_step_loss` and
   the three within 1e-4 relative. ga + remat peaks at least one fp32
   arena (of the path's own arena), and at most that arena as allocated +
   2 MiB, above adama + remat on bert-large and on stablelm-1.6b (in the
   bytes their tensors request at the peak), and
   adama_layerwise below adama + remat (by less than an arena at seq
   4096, where both peaks lie in the backward's activations). Last,
   launch.memory_split (one micro-batch: full, every layer checkpointed,
   Algorithm 2) on bert-large and on rwkv6-7b cut to 4 layers. Each path's
   peak, launches and step seconds and the phase's seconds are logged.

7. Checkpoints (train/checkpoint.py) on bert-large at full width cut to 8
   of its 24 layers (CKPT_LAYERS), otherwise as in phase 5:
   `adama` fp32/fp32 and `adama_layerwise` int8/rowcol on the fp8 wire
   with its residual, dynamic loss scaling, master params and the cache
   (a NaN at micro-batch 3 of step 3). Each runs 3 steps clean, then
   crashed by crash@step=1 between step 2's update and its save (saving
   every step, keeping one: step 1 must be the newest), then resumed from
   that directory for steps 2-3: the resumed run must log its restore of
   step 1, equal the clean run's losses of steps 2-3, end on its params, m
   and v columns, p, wp, ef, scaler (16384, one skip) and step bit for bit
   (digests on the card), launch its kernels in each step, and peak at
   most 1 MiB above it. On the adama path a bit flipped mid-file in the
   step-1 checkpoint must be refused (CheckpointCorruptError naming
   arrays.npz) with the live state's digest unchanged, and flipped back.
   The free disk space, each save's and restore's bytes, seconds and
   GB/s, and the phase's seconds are logged; the directory
   (`chip_smoke_ckpt/` in the checkout) is deleted at the end.

The last three lines are a JSON object with every kernel's numbers, the
card's name and power limit, and the JSON result line
`{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
FP32_OPS_PER_S = 67e12           # H100 SXM data sheet, non-tensor fp32
TF32_OPS_PER_S = 495e12          # H100 SXM data sheet, dense TF32 tensor
LANES = 1024                     # arena row width
SMALL_ROWS = 8
# timed runs of a kernel (cut from 25 to 12 for the dp phase, and to 10
# for its bucketed paths, to keep the script's time; ROADMAP queue 3 (w))
TIMED_RUNS = 10
# runs of phase 3's plain versions, each 1-2 orders of magnitude slower
# than its kernel (cut with TIMED_RUNS, from 25)
PLAIN_TIMED_RUNS = 5
KERNEL_REPS = 20                 # back-to-back launches per timed kernel run
# each arch's main-path settings and the rows of its arena; the cuts of
# the published configs and of their batches are listed in `reduced`.
# Arena rows: each leaf takes ceil(numel / 1024) rows, a layer's and the
# rest region's rows are aligned to 64, the whole to 256. bert-large: 24 x
# 12,352 block rows + 61,248 rest = 357,696 -> 357,888; rwkv6-7b at 4
# layers: 4 x 213,312 + 524,352 rest (embed and lm_head 262,144 each, the
# final norm 4, aligned) = 1,377,600 -> 1,377,792; stablelm-1.6b: 24 x
# 50,240 block rows + 401,472 rest (embed and lm_head 200,704 each, the
# final norm's two leaves 2 rows each, 8-row aligned) = 1,607,232 ->
# 1,607,424
MAIN = {"bert_large": dict(seq_len=128, global_batch=256, micro_batches=8,
                           seed=0, arena_rows=357_888),
        "rwkv6_7b": dict(seq_len=4096, global_batch=16, micro_batches=8,
                         seed=0, num_layers=4, arena_rows=1_377_792,
                         reduced={"num_layers": [32, 4],
                                  "global_batch": [256, 16]}),
        "stablelm_1_6b": dict(seq_len=1024, global_batch=16, micro_batches=8,
                              seed=0, arena_rows=1_607_424,
                              reduced={"seq_len": [4096, 1024]}),
        # swa: seq 8192, past the window of 4096 (at seq <= 4096 no causal
        # position reaches it), micro-batches of 1, ga and adama with
        # remat. 2 of 40 layers: at 4, ga + remat was predicted at ~77 GB
        # (a layer's recompute holds ~28 GB of fp32 attention tensors at
        # seq 8192). 2 x 266,304 block rows + 1,310,784 rest (embed and
        # lm_head 655,360 each, the final norm 5) = 1,843,392 -> 1,843,456
        "mistral_nemo_12b": dict(seq_len=8192, global_batch=8,
                                 micro_batches=8, seed=0, num_layers=2,
                                 remat=True, arena_rows=1_843_456,
                                 reduced={"num_layers": [40, 2],
                                          "seq_len": [131072, 8192],
                                          "global_batch": [256, 8]}),
        # mla at stablelm-1.6b's main-path setting: 24 of 62 layers (at 62
        # the fp32 params, m and v alone take 51 GB, ga ~85 GB). 24 x
        # 61,248 block rows + 367,424 rest (embed and lm_head 183,680 each,
        # the final norm 3) = 1,837,376 -> 1,837,568
        "minicpm3_4b": dict(seq_len=1024, global_batch=16, micro_batches=8,
                            seed=0, num_layers=24, arena_rows=1_837_568,
                            reduced={"num_layers": [62, 24],
                                     "seq_len": [32768, 1024],
                                     "global_batch": [256, 16]}),
        # MoE (64 routed experts of 1408 + 2 shared, top-6; mla) at full
        # width: 4 of 27 layers, the dense prefix layer and 3 MoE layers.
        # At 27 the fp32 arena alone is 62.8 GB. At 3 layers (2 MoE)
        # Algorithm 2's saving, 2 arenas less one MoE layer's gradient and
        # its slab (2 x 2.34 GB) and the head's logits, was reckoned at
        # about 6.7 GB against an arena of 6.68: too close to assert one
        # arena; at 4, about 10-11 GB against 9.02. 3 x 571,200 MoE block
        # rows + 79,168 dense block rows + 409,664 rest (embed and lm_head
        # 204,800 each, the final norm 2, aligned) = 2,202,624 rows.
        # layerwise_gap="gradient": Algorithm 2's claim below adama's peak
        # is the whole-model fp32 gradient (n_params x 4 B), not two
        # arenas. Each layer is a quarter of this arena, so Algorithm 2
        # peaks at the apply's pack of the params (params, m, v and the
        # pack: 4 arenas) and adama at its pack of a micro-batch's
        # gradient (those and the gradient tree): the gap is the gradient
        # tree exactly, one arena less its 2,015,232 B of row padding
        "deepseek_v2_lite_16b": dict(seq_len=1024, global_batch=16,
                                     micro_batches=8, seed=0, num_layers=4,
                                     arena_rows=2_202_624,
                                     layerwise_gap="gradient",
                                     reduced={"num_layers": [27, 4],
                                              "seq_len": [32768, 1024],
                                              "global_batch": [256, 16]}),
        # hybrid (swa attention and Mamba heads side by side) at full
        # width: 8 of 32 layers, for the script's time (at 32 the arena is
        # 1,624,320 rows, 6.65 GB, and fits with remat); seq 2048, past
        # the window of 1024; ga and adama with remat, as mistral-nemo's.
        # 8 x 47,616 block rows + 100,416 rest (embed and lm_head 50,200
        # each, the final norm 2, aligned) = 481,344 -> 481,536
        "hymba_1_5b": dict(seq_len=2048, global_batch=8, micro_batches=8,
                           seed=0, num_layers=8, remat=True,
                           arena_rows=481_536,
                           reduced={"num_layers": [32, 8],
                                    "seq_len": [8192, 2048],
                                    "global_batch": [256, 8]}),
        # enc-dec at full size: 6 encoder and 6 decoder layers over 1500
        # stub frames, the decoder at its published context of 448; only
        # the batch cut (256 -> 16, 8 micro-batches of 2, for the script's
        # time: at 64 a run on a slow host came to ~1,165 s). 6 x 4,160
        # decoder block rows + 6 x 3,136 encoder block rows + 52,032 rest
        # (embed and lm_head 25,984 each, the encoder's and the final
        # norms' four leaves 1 row each, aligned) = 95,808 -> 96,000
        "whisper_base": dict(seq_len=448, global_batch=16, micro_batches=8,
                             seed=0, arena_rows=96_000,
                             reduced={"global_batch": [256, 16]}),
        # vlm at full width: 4 of 48 layers (ga + remat peaks at 64.9 GB,
        # six arenas of 10.8 GB); 1024 text tokens after the 256 stub
        # patches; ga and adama with remat, as mistral-nemo's. 4 x 380,992
        # block rows + 1,112,128 rest (embed and lm_head 556,032 each, the
        # final norm 6, aligned) = 2,636,096 -> 2,636,288.
        # layerwise_gap="gradient", as deepseek's: each layer is a seventh
        # of this arena, so Algorithm 2 peaks at the apply's pack of the
        # params and adama + remat at its pack of a micro-batch's gradient,
        # the tree beside it: the gap is the tree. Not cut to 2 layers for
        # the script's time: there the rest region is 59% of the arena and
        # Algorithm 2 peaks at its fold (the rest's gradients as a tree and
        # a slab), 6.21 GB below adama + remat, under the 7.68 GB gradient
        "internvl2_26b": dict(seq_len=1024, global_batch=8, micro_batches=8,
                              seed=0, num_layers=4, remat=True,
                              arena_rows=2_636_288,
                              layerwise_gap="gradient",
                              reduced={"num_layers": [48, 4],
                                       "seq_len": [32768, 1024],
                                       "global_batch": [256, 8]})}
FP32 = ("fp32", "fp32")
# main paths: name -> (arch, engine, arena state, steps, (m codec, v codec))
# (bert-large's paths cut from 5 steps to 3, the per-leaf ones, minicpm3's
# and whisper's from 3 to 2, for the time of the data-parallel phase's
# bf16-wire, master and checkpoint paths: no check reads a step past 2)
PATHS = {"adama": ("bert_large", "adama", True, 3, FP32),
         "ga": ("bert_large", "ga", True, 3, FP32),
         "adama_layerwise": ("bert_large", "adama_layerwise", True, 3, FP32),
         "adama_layerwise_per_leaf": ("bert_large", "adama_layerwise", False,
                                      2, FP32),
         "adama_per_leaf": ("bert_large", "adama", False, 2, FP32),
         "rwkv6_adama": ("rwkv6_7b", "adama", True, 3, FP32),
         "rwkv6_ga": ("rwkv6_7b", "ga", True, 3, FP32),
         "rwkv6_adama_layerwise": ("rwkv6_7b", "adama_layerwise", True, 3,
                                   FP32),
         "stablelm_adama": ("stablelm_1_6b", "adama", True, 3, FP32),
         "stablelm_ga": ("stablelm_1_6b", "ga", True, 3, FP32),
         "stablelm_adama_layerwise": ("stablelm_1_6b", "adama_layerwise",
                                      True, 3, FP32),
         "stablelm_adama_int8": ("stablelm_1_6b", "adama", True, 3,
                                 ("int8", "int8")),
         "stablelm_adama_int8_factored": ("stablelm_1_6b", "adama", True, 3,
                                          ("int8", "factored")),
         "stablelm_adama_layerwise_int8": ("stablelm_1_6b",
                                           "adama_layerwise", True, 3,
                                           ("int8", "int8")),
         "stablelm_adama_rowcol": ("stablelm_1_6b", "adama", True, 3,
                                   ("fp32", "rowcol")),
         "stablelm_adama_int8_rowcol": ("stablelm_1_6b", "adama", True, 3,
                                        ("int8", "rowcol")),
         "stablelm_adama_layerwise_int8_rowcol": ("stablelm_1_6b",
                                                  "adama_layerwise", True, 3,
                                                  ("int8", "rowcol")),
         "stablelm_adama_guarded": ("stablelm_1_6b", "adama", True, 3, FP32),
         "stablelm_adama_guarded_nan": ("stablelm_1_6b", "adama", True, 3,
                                        FP32),
         "stablelm_adama_guarded_skip": ("stablelm_1_6b", "adama", True, 3,
                                         FP32),
         "stablelm_adama_layerwise_int8_rowcol_guarded": (
             "stablelm_1_6b", "adama_layerwise", True, 3, ("int8", "rowcol")),
         "stablelm_adama_layerwise_int8_rowcol_guarded_nan": (
             "stablelm_1_6b", "adama_layerwise", True, 3, ("int8", "rowcol")),
         "stablelm_adama_layerwise_int8_rowcol_guarded_skip": (
             "stablelm_1_6b", "adama_layerwise", True, 3, ("int8", "rowcol")),
         "stablelm_ga_guarded_nan": ("stablelm_1_6b", "ga", True, 2, FP32),
         "stablelm_adama_bf16": ("stablelm_1_6b", "adama", True, 3, FP32),
         "stablelm_adama_layerwise_int8_rowcol_bf16": (
             "stablelm_1_6b", "adama_layerwise", True, 3, ("int8", "rowcol")),
         "stablelm_adama_guarded_bf16_dynamic_nan": (
             "stablelm_1_6b", "adama", True, 3, FP32),
         "stablelm_adama_master": ("stablelm_1_6b", "adama", True, 3, FP32),
         "stablelm_adama_layerwise_int8_rowcol_bf16_master_wp": (
             "stablelm_1_6b", "adama_layerwise", True, 3, ("int8", "rowcol")),
         "stablelm_ga_guarded_master_nan": ("stablelm_1_6b", "ga", True, 2,
                                            FP32),
         "stablelm_adama_guarded_fp8": ("stablelm_1_6b", "adama", True, 3,
                                        FP32),
         "stablelm_adama_guarded_fp8_nan": ("stablelm_1_6b", "adama", True,
                                            3, FP32),
         "stablelm_adama_guarded_fp8_skip": ("stablelm_1_6b", "adama", True,
                                             3, FP32),
         "stablelm_adama_layerwise_int8_rowcol_guarded_fp8_dynamic_nan": (
             "stablelm_1_6b", "adama_layerwise", True, 3, ("int8", "rowcol")),
         # MAIN["mistral_nemo_12b"]["remat"]: ga and adama with remat
         "mistral_ga_remat": ("mistral_nemo_12b", "ga", True, 2, FP32),
         "mistral_adama_remat": ("mistral_nemo_12b", "adama", True, 2, FP32),
         "mistral_adama_layerwise": ("mistral_nemo_12b", "adama_layerwise",
                                     True, 2, FP32),
         "minicpm_adama": ("minicpm3_4b", "adama", True, 2, FP32),
         "minicpm_ga": ("minicpm3_4b", "ga", True, 2, FP32),
         "minicpm_adama_layerwise": ("minicpm3_4b", "adama_layerwise", True,
                                     2, FP32),
         "deepseek_adama": ("deepseek_v2_lite_16b", "adama", True, 3, FP32),
         "deepseek_ga": ("deepseek_v2_lite_16b", "ga", True, 3, FP32),
         "deepseek_adama_layerwise": ("deepseek_v2_lite_16b",
                                      "adama_layerwise", True, 3, FP32),
         # MAIN["hymba_1_5b"]["remat"]: ga and adama with remat
         "hymba_ga_remat": ("hymba_1_5b", "ga", True, 2, FP32),
         "hymba_adama_remat": ("hymba_1_5b", "adama", True, 2, FP32),
         "hymba_adama_layerwise": ("hymba_1_5b", "adama_layerwise", True, 2,
                                   FP32),
         "whisper_adama": ("whisper_base", "adama", True, 2, FP32),
         "whisper_ga": ("whisper_base", "ga", True, 2, FP32),
         "whisper_adama_layerwise": ("whisper_base", "adama_layerwise", True,
                                     2, FP32),
         # MAIN["internvl2_26b"]["remat"]: ga and adama with remat
         "internvl_ga_remat": ("internvl2_26b", "ga", True, 2, FP32),
         "internvl_adama_remat": ("internvl2_26b", "adama", True, 2, FP32),
         "internvl_adama_layerwise": ("internvl2_26b", "adama_layerwise",
                                      True, 2, FP32)}
# the MoE phase: the main path whose step 1 is run again from the same
# seed and must end on the same params, m and v (digests on the card)
MOE_RERUN = "deepseek_adama"
# CUDA-event-timed runs of rows 1-3 at the arenas of the MoE, enc-dec and
# vlm archs, and of their plain versions there (about 0.3-0.8 s a call at
# the largest)
ARENA_TIMED_RUNS = 8
ARENA_PLAIN_RUNS = 3
# the slices rows 1-3 are timed on at each arch's arena: (label, the
# stacked region whose layer 0 it is, or None for the rest region)
ARENA_SLICES = {
    "deepseek_v2_lite_16b": (("moe layer 0", "blocks"),
                             ("dense layer 0", "dense_blocks"),
                             ("rest", None)),
    "whisper_base": (("decoder layer 0", "blocks"),
                     ("encoder layer 0", "enc_blocks"), ("rest", None)),
    "internvl2_26b": (("layer 0", "blocks"), ("rest", None))}
# each arch's arena layout, recorded by its first arena main path
LAYOUTS = {}
# the master-param paths (master_params=True): path -> (work_param_cache,
# gradient wire, its twin without master params). Each must launch what its
# twin launches per step, hold its param leaves at exactly bf16(master)
# after every step (and the cache at it too), and peak at most its twin's
# peak + the bytes of its new regions (MASTER_REGION_BYTES) as the caching
# allocator holds them (`_allocator_bytes`) + MASTER_PEAK_SLACK. The fp32
# adama path's master after step 1 must be its twin's
# params after step 1 bit for bit (a digest on the card), and its step-1
# loss the twin's; the guarded ga path, every step skipped, must keep the
# master at pack(initial params) and the leaves at bf16(initial params)
MASTER = {"stablelm_adama_master": (False, "fp32", "stablelm_adama"),
          "stablelm_adama_layerwise_int8_rowcol_bf16_master_wp": (
              True, "bf16", "stablelm_adama_layerwise_int8_rowcol_bf16"),
          "stablelm_ga_guarded_master_nan": (False, "fp32",
                                             "stablelm_ga_guarded_nan")}
MASTER_PEAK_SLACK = 1 << 20
# the stablelm arena's fp32 master (1,607,424 x 1024 x 4 B) and bf16 cache
MASTER_REGION_BYTES = {"p": 6_584_008_704, "wp": 3_292_004_352}
# PyTorch's CUDA caching allocator cuts a large block from a segment it
# rounds to 2 MiB and leaves a tail of at most 1 MiB unsplit, in the block:
# the fp32 arena is held as 6,585,057,280 B (ga's accumulator too: ga peaks
# one arena + 1 MiB above adama on stablelm-1.6b)
ALLOCATOR_SEGMENT = 2 << 20


def _allocator_bytes(n: int) -> int:
    """The bytes a fresh block of n bytes counts in
    torch.cuda.max_memory_allocated: n rounded up to the segment
    granularity."""
    return -(-n // ALLOCATOR_SEGMENT) * ALLOCATOR_SEGMENT
# the bf16-wire paths: path -> (loss_scale, its fp32-wire twin). Each must
# peak at most WIRE_PEAK_SLACK above its twin, launch what it launches,
# reach its step-1 loss bit for bit (the forward never sees the wire) and
# hold its params after step 1 within the pair's declared bf16_wire_lr x
# lr of the twin's, at most CODE_FLIP_FRAC of them beyond SMALL_PARAM_TOL
# (the card-vs-CPU rule: a missing or wrong update moves nearly every
# param by ~lr, more than the declared bound allows on few of them)
WIRE = {"stablelm_adama_bf16": ("off", "stablelm_adama"),
        "stablelm_adama_layerwise_int8_rowcol_bf16": (
            "off", "stablelm_adama_layerwise_int8_rowcol"),
        "stablelm_adama_guarded_bf16_dynamic_nan": (
            "dynamic", "stablelm_adama_guarded_nan")}
WIRE_PEAK_SLACK = 1 << 20
# the dynamic path's loss scale after its steps: DYNAMIC_INIT 2^15, halved
# once by the skipped micro-batch, and no growth in the step after it
# (scaler_growth_interval 200 good micro-batches)
WIRE_LOSS_SCALE = {"stablelm_adama_guarded_bf16_dynamic_nan": 2.0 ** 14}
# the fp8-wire paths (grad_dtype="fp8_e4m3" with error feedback, guarded):
# path -> (loss_scale, its fp32-wire twin). Each must reach its twin's
# step-1 loss bit for bit (the forward never sees the wire), launch per
# step an encode, a fold and a residual update per slab where the twin
# launches finite_and and a fold (`_expected_launches`), hold its params
# after step 1 within the pair's declared (fp8_wire_lr of m + of v) x lr
# of the twin's and agree with the sign of the twin's step-1 update on at
# least FP8_SIGN_SHARE of the params whose twin update exceeds lr / 2 (a
# missing, doubled or unscaled grad_scale moves the update by a factor, so
# the bound alone would not catch it), keep a finite, non-zero residual,
# and peak at most its twin's peak + the residual (FP8_EF_BYTES) + the
# largest codes buffer (FP8_CODES_BYTES: the whole arena's codes for
# adama, the rest slab's for adama_layerwise), each as the caching
# allocator holds it (`_allocator_bytes`), + FP8_PEAK_SLACK
FP8 = {"stablelm_adama_guarded_fp8": ("off", "stablelm_adama_guarded"),
       "stablelm_adama_guarded_fp8_nan": ("off",
                                          "stablelm_adama_guarded_nan"),
       "stablelm_adama_guarded_fp8_skip": ("off",
                                           "stablelm_adama_guarded_skip"),
       "stablelm_adama_layerwise_int8_rowcol_guarded_fp8_dynamic_nan": (
           "dynamic", "stablelm_adama_layerwise_int8_rowcol_guarded_nan")}
FP8_PEAK_SLACK = 1 << 20
FP8_SIGN_SHARE = 0.99
# the stablelm arena's fp32 residual (1,607,424 x 1024 x 4 B), and the
# largest e4m3 codes buffer of each engine: the whole arena's (adama), the
# rest region's slab of 401,472 rows (adama_layerwise)
FP8_EF_BYTES = 6_584_008_704
FP8_CODES_BYTES = {"adama": 1_646_002_176, "adama_layerwise": 411_107_328}
# the dynamic path's loss scale after its steps (2^15 halved once)
FP8_LOSS_SCALE = {
    "stablelm_adama_layerwise_int8_rowcol_guarded_fp8_dynamic_nan": 2.0 ** 14}
# the guarded paths (finite_guard=True): path -> (the fault injected, its
# unguarded twin); each must peak at most GUARD_PEAK_SLACK above its twin
# (the master and fp8 paths excepted: MASTER and FP8 hold theirs).
# The faults fire in step 1 (0-based) of 3, so a step runs after each skip
# and the digests see what the guard left for it (the good count moving
# the decay, the step counter)
GUARDED = {
    "stablelm_adama_guarded": (None, "stablelm_adama"),
    "stablelm_adama_guarded_nan": ("nan@micro=3,step=1", "stablelm_adama"),
    "stablelm_adama_guarded_skip": ("skip@micro=3,step=1", "stablelm_adama"),
    "stablelm_adama_layerwise_int8_rowcol_guarded": (
        None, "stablelm_adama_layerwise_int8_rowcol"),
    "stablelm_adama_layerwise_int8_rowcol_guarded_nan": (
        "nan@micro=3,step=1", "stablelm_adama_layerwise_int8_rowcol"),
    "stablelm_adama_layerwise_int8_rowcol_guarded_skip": (
        "skip@micro=3,step=1", "stablelm_adama_layerwise_int8_rowcol"),
    "stablelm_ga_guarded_nan": ("nan@micro=0,step=0", "stablelm_ga"),
    "stablelm_adama_guarded_bf16_dynamic_nan": (
        "nan@micro=3,step=1", "stablelm_adama_guarded_nan"),
    # its peak is held by MASTER, against stablelm_ga_guarded_nan's
    "stablelm_ga_guarded_master_nan": ("nan@micro=0,step=0", "stablelm_ga"),
    **{p: (f"{'skip' if p.endswith('skip') else 'nan'}@micro=3,step=1"
           if p.endswith(("nan", "skip")) else None, twin)
       for p, (_, twin) in FP8.items()}}
GUARD_PEAK_SLACK = 1 << 20
# the bitwise claims on the guarded paths, over a digest of the params, m
# and v bytes computed on the card: (path, path, equal?)
GUARD_DIGESTS = (
    ("stablelm_adama_guarded", "stablelm_adama", True),
    ("stablelm_adama_guarded_nan", "stablelm_adama_guarded_skip", True),
    ("stablelm_adama_guarded_nan", "stablelm_adama", False),
    ("stablelm_adama_layerwise_int8_rowcol_guarded",
     "stablelm_adama_layerwise_int8_rowcol", True),
    ("stablelm_adama_layerwise_int8_rowcol_guarded_nan",
     "stablelm_adama_layerwise_int8_rowcol_guarded_skip", True),
    ("stablelm_adama_layerwise_int8_rowcol_guarded_nan",
     "stablelm_adama_layerwise_int8_rowcol", False),
    # the fp8 wire: the digest covers the residual "ef" too
    ("stablelm_adama_guarded_fp8_nan", "stablelm_adama_guarded_fp8_skip",
     True),
    ("stablelm_adama_guarded_fp8_nan", "stablelm_adama_guarded_fp8", False))
# skipped micro-batches each guarded path must report after its steps, and
# its final step counter
GUARD_SKIPS = {"stablelm_adama_guarded": (0, 3),
               "stablelm_adama_guarded_nan": (1, 3),
               "stablelm_adama_guarded_skip": (1, 3),
               "stablelm_adama_layerwise_int8_rowcol_guarded": (0, 3),
               "stablelm_adama_layerwise_int8_rowcol_guarded_nan": (1, 3),
               "stablelm_adama_layerwise_int8_rowcol_guarded_skip": (1, 3),
               # ga's one verdict per step; its step counter stays, so the
               # fault fires again
               "stablelm_ga_guarded_nan": (2, 0),
               "stablelm_adama_guarded_bf16_dynamic_nan": (1, 3),
               "stablelm_ga_guarded_master_nan": (2, 0),
               "stablelm_adama_guarded_fp8": (0, 3),
               "stablelm_adama_guarded_fp8_nan": (1, 3),
               "stablelm_adama_guarded_fp8_skip": (1, 3),
               "stablelm_adama_layerwise_int8_rowcol_guarded_fp8_dynamic_nan":
                   (1, 3)}
# the compressed-state pairs timed at the full stablelm arena, and the main
# path each one's launches are read from
TIMED_CODEC_PAIRS = {("int8", "int8"): "stablelm_adama_int8",
                     ("int8", "factored"): "stablelm_adama_int8_factored",
                     ("fp32", "rowcol"): "stablelm_adama_rowcol",
                     ("int8", "rowcol"): "stablelm_adama_int8_rowcol"}
# the codec forms' plain versions take seconds a call at that arena
CODEC_PLAIN_RUNS = 3
# the scan at the rwkv6-7b main path's shape: BH = micro-batch 2 x 64 heads
SCAN_SHAPE = dict(bh=128, s=4096, k=64, v=64, chunk=64)
SCAN_REL_TOL = 2e-5      # largest |kernel - plain| / largest |plain|
# torch.profiler sessions: in a process that had run for a minute or more,
# the first records of a session went missing on the H100 (neither a host
# wait nor a 57 ms spin kernel ahead of them helped), so a session traces
# one warm-up step, whose records it drops, before the step it counts, and
# a session whose records fall short is run again, up to PROFILE_ATTEMPTS
# times in all
PROFILE_ATTEMPTS = 3
# each kernel: (module, source, the TPU kernel it replaces, its main path)
KERNELS = {
    "arena_fold": ("fused_step", "src/repro_torch/kernels/csrc/fused_step.cu",
                   "src/repro/kernels/fused_step.py:406", "adama"),
    "arena_apply": ("fused_step",
                    "src/repro_torch/kernels/csrc/fused_step.cu",
                    "src/repro/kernels/fused_step.py:552", "adama"),
    "arena_fold_slice": ("fused_step",
                         "src/repro_torch/kernels/csrc/fused_step.cu",
                         "src/repro/kernels/fused_step.py:467",
                         "adama_layerwise"),
    "adama_accum_2d": ("adama_accum",
                       "src/repro_torch/kernels/csrc/adama_accum.cu",
                       "src/repro/kernels/adama_accum.py:177",
                       "adama_layerwise_per_leaf"),
    "adam_apply_2d": ("adam_apply",
                      "src/repro_torch/kernels/csrc/adam_apply.cu",
                      "src/repro/kernels/adam_apply.py:36",
                      "adama_layerwise_per_leaf"),
    # the TPU kernel has no backward (XLA differentiates the model's scan);
    # the backward kernel is the gradient of the same kernel
    "rwkv6_chunk_scan": ("rwkv6_chunk",
                         "src/repro_torch/kernels/csrc/rwkv6_chunk.cu",
                         "src/repro/kernels/rwkv6_chunk.py:73",
                         "rwkv6_adama"),
    "rwkv6_chunk_scan_bwd": ("rwkv6_chunk",
                             "src/repro_torch/kernels/csrc/rwkv6_chunk.cu",
                             "src/repro/kernels/rwkv6_chunk.py:73",
                             "rwkv6_adama"),
    # the guarded folds' finite flag; the TPU package computes it with
    # jnp.isfinite(g).all() outside its kernels, in the fold's guard setup
    "finite_and": ("fused_step", "src/repro_torch/kernels/csrc/fused_step.cu",
                   "src/repro/kernels/fused_step.py:396",
                   "stablelm_adama_guarded"),
    # the fp8 wire's encode (the residual injected first) and the
    # residual's update; the TPU package computes both in plain jnp
    "fp8_encode": ("fp8_wire", "src/repro_torch/kernels/csrc/fp8_wire.cu",
                   "src/repro/kernels/adama_accum.py:99",
                   "stablelm_adama_guarded_fp8"),
    "fp8_ef_update": ("fp8_wire", "src/repro_torch/kernels/csrc/fp8_wire.cu",
                      "src/repro/core/accumulation.py:340",
                      "stablelm_adama_guarded_fp8"),
}

# the checkpoint phase (bert-large at CKPT_LAYERS layers): path ->
# (engine, (m codec, v codec), further OptimizerConfig fields, the fault of
# its clean and resumed runs). Each path runs clean for CKPT_STEPS steps,
# then crashed by CKPT_CRASH between step 2's update and its save (saving
# every step, keeping one), then resumed from that directory; the resumed
# run must end on the clean run's params and state bit for bit (digests on
# the card), launch the clean run's kernels in each step it runs, and peak
# at most CKPT_PEAK_SLACK above the clean run. Path A is the main path; path B
# carries every region (int8 m, rowcol v, p, wp, ef, the scaler), and its
# NaN on step 3 lands after the resume, so the scaler's state has to come
# back: scale and skips CKPT_SCALER after step 3 in both runs
CKPT_PATHS = {
    "checkpoint_adama": ("adama", FP32, {}, None),
    "checkpoint_adama_layerwise_int8_rowcol_fp8_master_wp": (
        "adama_layerwise", ("int8", "rowcol"),
        dict(grad_dtype="fp8_e4m3", finite_guard=True, loss_scale="dynamic",
             master_params=True, work_param_cache=True),
        "nan@micro=3,step=2")}
CKPT_STEPS = 3
CKPT_CRASH = "crash@step=1"
CKPT_PEAK_SLACK = 1 << 20
CKPT_SCALER = {"checkpoint_adama_layerwise_int8_rowcol_fp8_master_wp":
               (16384.0, 1)}
# the path whose step-1 checkpoint is corrupted, refused and repaired
CKPT_CORRUPT = "checkpoint_adama"
# the phase's model: bert-large cut to 8 of its 24 layers (recorded as
# `reduced` in its log lines). Its checks (the format, the resume bit for
# bit, the refused corruption) do not depend on depth; full depth spent
# 179 s of the script's time limit, most of it in ten saves and restores
# of 4.4-5.5 GB
CKPT_LAYERS = 8
# written under the checkout (listed in .gitignore), deleted after the phase
CKPT_DIR = "chip_smoke_ckpt"
# the activation-checkpointing phase (RunConfig.remat): path -> (the main
# path whose arch, engine, arena state and codecs it runs, remat, seq_len
# and num_layers (None: the main path's), steps). A path at its main
# path's seq_len is that path's remat twin: its losses, params, m and v
# must be the main path's bit for bit (digests on the card), its launches
# per step the main path's (an rwkv6 model's forward scan twice: forward
# and recompute) and its peak below the main path's. The stablelm-1.6b
# paths run at its published max_seq_len 4096 (the main paths' cut to
# 1024 is lifted for them), cut to 16 of its 24 layers: device-bound at
# 24 s a step, the three took 147 s of the script's time limit at full
# depth. At 24 layers adama_layerwise peaked 3.06 GB below adama + remat
# (its head's cross-entropy backward against layer 0's recompute beside
# the gradient tree); the 8 layers cut take 1.65 GB of gradient from that
# gap, at 12 they would take 2.47. adama_layerwise recomputes every layer
# without remat
REMAT = {"adama_remat": ("adama", True, None, None, 3),
         "ga_remat": ("ga", True, None, None, 3),
         "stablelm_4096_ga_remat": ("stablelm_ga", True, 4096, 16, 2),
         "stablelm_4096_adama_remat": ("stablelm_adama", True, 4096, 16,
                                       2),
         "stablelm_4096_adama_layerwise": ("stablelm_adama_layerwise",
                                           False, 4096, 16, 2),
         "rwkv6_adama_remat": ("rwkv6_adama", True, None, None, 3)}
# ga + remat against adama + remat: at least one fp32 arena apart (ga's
# accumulator) and at most that arena as the caching allocator holds it +
# this slack: ga packs each micro-batch's tree and drops it before adding
# the pack in, so nothing else of ga's is live beside adama's peak
REMAT_GAP_SLACK = 2 << 20
# launch.memory_split's runs in the phase: arch -> its arguments (one
# micro-batch of the main path)
REMAT_SPLIT = {"bert-large": dict(seq_len=128, micro_batch=32),
               "rwkv6-7b": dict(seq_len=4096, micro_batch=2, num_layers=4)}
# the data-parallel phase (core/dp_shardmap.py), after bert-large's main
# paths, on a one-rank NCCL group opened in this process: path -> (the DP
# variant, further OptimizerConfig fields, layers (None: all 24), fault).
# Each runs MAIN's bert-large setting for DP_STEPS steps. At M = 1 every
# collective still runs (the scatter and the gather copy, the all-reduces
# sum one rank), so dp_adama and zero1_adama must end on the DP_TWIN main
# path's params, m and v after DP_STEPS steps bit for bit (digests), with
# its losses and its launches. The guarded pair and the codec path run at
# CKPT_LAYERS layers, for time: a NaN on rank 0's gradient at micro-batch
# 1 of every step must equal a forced skip there bit for bit
DP_ARCH = "bert_large"
DP_STEPS = 2
DP_TWIN = "adama"
# the main paths whose params, m and v after DP_STEPS steps the DP paths
# must end on (digests): adama's, and adama_layerwise's for the stream
DP_TWINS = (DP_TWIN, "adama_layerwise")
DP_ZERO1 = dict(zero_stage=1, zero_bucketed=False)
# the bucketed ZeRO-1 schedule (the default) and Algorithm 2's stream
DP_BUCKETED = dict(zero_stage=1)
DP_INT8_ROWCOL = dict(m_codec="int8", state_codec="rowcol")
# the bf16 gradient wire with master params (ROADMAP 10.2, second half)
DP_BF16_MASTER = dict(grad_dtype="bf16", master_params=True)
# DP path -> (its fp32-wire DP twin without a master, its single-device
# twin: engine and fault). At M = 1 each ends on its single-device twin's
# params, master, m and v (digests) with its losses; it peaks at most its
# DP twin's peak + its owned master rows (one arena at M = 1, as the
# allocator holds it) + DP_PEAK_SLACK / 2 (the bf16 wire costs nothing),
# its gradient reduce-scatters move exactly half the DP twin's bytes and
# its param all-gather half, the step's collectives at most
# DP_WIRE_BYTES_RATIO of the twin's (the reference's bound); the guarded
# stream's NaN backs the dynamic scale off once (2^15 -> 2^14)
DP_WIRE_MASTER = {
    "zero1_bucketed_bf16_master": ("zero1_bucketed_8l", "adama", None),
    "zero1_layerwise_bf16_master_guarded_nan": (
        "zero1_adama_layerwise_guarded_nan", "adama_layerwise",
        "nan@micro=1,step=0")}
DP_WIRE_BYTES_RATIO = 0.55
DP_WIRE_LOSS_SCALE = 2.0 ** 14
# the crash and resume of the bucketed bf16-wire master path: crashed by
# CKPT_CRASH after step 2's update (its step-1 checkpoint kept), resumed
# from it, it must end on the run that never stopped (digests, losses)
# and peak at most DP_PEAK_SLACK / 2 above it
DP_RESUMED = "zero1_bucketed_bf16_master"
DP_PATHS = {
    "dp_ga": ("ga", {}, None, None),
    "dp_adama": ("adama", {}, None, None),
    "zero1_adama": ("adama", DP_ZERO1, None, None),
    "zero1_adama_guarded_nan": ("adama", dict(DP_ZERO1, finite_guard=True),
                                CKPT_LAYERS, "nan@micro=1,device=0"),
    "zero1_adama_guarded_skip": ("adama", dict(DP_ZERO1, finite_guard=True),
                                 CKPT_LAYERS, "skip@micro=1"),
    "zero1_adama_int8_rowcol": ("adama", dict(DP_ZERO1, **DP_INT8_ROWCOL),
                                CKPT_LAYERS, None),
    "zero1_adama_bucketed": ("adama", DP_BUCKETED, None, None),
    "zero1_adama_layerwise": ("adama_layerwise", DP_BUCKETED, None, None),
    "zero1_adama_layerwise_guarded_nan": (
        "adama_layerwise", dict(DP_BUCKETED, finite_guard=True), CKPT_LAYERS,
        "nan@micro=1,device=0"),
    "zero1_adama_layerwise_guarded_skip": (
        "adama_layerwise", dict(DP_BUCKETED, finite_guard=True), CKPT_LAYERS,
        "skip@micro=1"),
    # one step each: after it the rowcol params differ by the column sums'
    # order, and so would every column after a second step
    "zero1_adama_int8_rowcol_step1": ("adama", dict(DP_ZERO1,
                                                    **DP_INT8_ROWCOL),
                                      CKPT_LAYERS, None),
    "zero1_adama_bucketed_int8_rowcol": ("adama", dict(DP_BUCKETED,
                                                       **DP_INT8_ROWCOL),
                                         CKPT_LAYERS, None),
    # ROADMAP 10.2's second half (DP_WIRE_MASTER): the fp32-wire bucketed
    # schedule at 8 layers, the twin of the bf16-wire master path beside it
    "zero1_bucketed_8l": ("adama", DP_BUCKETED, CKPT_LAYERS, None),
    "zero1_bucketed_bf16_master": ("adama", dict(DP_BUCKETED,
                                                 **DP_BF16_MASTER),
                                   CKPT_LAYERS, None),
    "zero1_layerwise_bf16_master_guarded_nan": (
        "adama_layerwise", dict(DP_BUCKETED, finite_guard=True,
                                loss_scale="dynamic", **DP_BF16_MASTER),
        CKPT_LAYERS, "nan@micro=1,step=0,device=0")}
DP_ONE_STEP = ("zero1_adama_int8_rowcol_step1",
               "zero1_adama_bucketed_int8_rowcol")
# the paths whose allocator history is kept, to name where each peaks
# (launch/memory_split.py `peak_sites`)
DP_PEAK_SITES = ("zero1_adama_bucketed", "zero1_adama_layerwise")
DP_PEAK_SITES_TOP = 6
# zero1_adama's peak over DP_TWIN's: at most the owned gradient rows
# (rows / M x 4,096 B; the scatter's output beside the packed slab) + this;
# the bucketed schedule's over the full pack's: at most this; the stream's
# over adama_layerwise's: at most the owned rows + this
DP_PEAK_SLACK = 2 << 20
# the stream's peak under zero1_adama's: at least two fp32 arenas
# (Algorithm 2's claim under ZeRO-1)
DP_STREAM_ARENAS = 2
# ZeRO-1 emulated at M = DP_SHARDS over bert-large's full arena (laid out
# for DP_SHARDS row ranges): each pair's fold and apply on every rank's
# row-range view against the whole-arena kernels
DP_SHARDS = 4
DP_SHARD_PAIRS = (FP32, ("int8", "int8"), ("int8", "factored"),
                  ("fp32", "rowcol"), ("int8", "rowcol"))
# rowcol's column sums: the ranks' partials, summed in rank order, against
# the whole arena's. Queue 3 (j)'s 1e-6 relative (the reference's order
# against the port's, on the CPU tests' small arenas) is logged; the
# assert is the float32 bound of the two orders (`_colsum_bound`), since
# at 358,400 rows the ordered chains run 830 additions long and the card
# measured 1.23e-6 (ROADMAP queue 3 (aa))
DP_COLSUM_REL = 1e-6
# the bucketed schedule emulated at DP_SHARDS ranks over the same arena:
# each rank's slice of every bucket folded at its own_offset, and the
# slice fold timed on a rest bucket (4,096 rows) and a layer bucket
# (12,352) and on their slices at DP_SHARDS ranks (1,024 and 3,088 rows)
DP_BUCKET_TIMED = (("rest bucket", "rest", 1), ("layer bucket", "stack", 1),
                   ("rest bucket slice", "rest", DP_SHARDS),
                   ("layer bucket slice", "stack", DP_SHARDS))


def log(msg) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def timed_ms(torch, fn, runs=TIMED_RUNS, warmup=2, reps=1):
    """Median milliseconds per call of `fn()` over `runs` CUDA-event-timed
    runs of `reps` calls each. A kernel is timed over KERNEL_REPS
    back-to-back launches, so the host's time between the start event and
    the first launch is spread over many calls; where one launch takes
    longer on the host than on the card, the figure is the host's launch
    interval."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound_ms(n_bytes: int, n_ops: int, tf32_ops: int = 0):
    """The larger of the bytes over the memory rate and the operations'
    time: n_ops on fp32 cores, tf32_ops (products) on tensor cores."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (n_ops / FP32_OPS_PER_S + tf32_ops / TF32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(torch, fused_step, dev="cuda",
                  sizes=(SMALL_ROWS, MAIN["bert_large"]["arena_rows"])):
    """Phase 3: each kernel bitwise against its plain version; times."""
    dev = torch.device(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    lanes = fused_step.LANES
    result = {}
    for rows in sizes:
        def rand(scale, positive=False):
            x = torch.randn((rows, lanes), generator=gen, device=dev) * scale
            return x.abs() if positive else x
        m, v, g, p = rand(1e-3), rand(1e-6, True), rand(1.0), rand(0.02)
        n = rows * lanes
        err = {"arena_fold": 0.0, "arena_apply": 0.0}
        for decay, scale in (((0.9, 0.999), 1.0 / 8), (None, 1.0 / 8)):
            kw = dict(beta1=0.9, beta2=0.999, scale=scale, decay=decay)
            mk, vk, mr, vr = m.clone(), v.clone(), m.clone(), v.clone()
            fused_step.arena_fold(mk, vk, g, **kw)
            fused_step.arena_fold_ref(mr, vr, g, **kw)
            for a, b in ((mk, mr), (vk, vr)):
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"arena_fold rows={rows} decay={decay}: kernel != "
                        f"plain at {int((a != b).sum())} elements, max |d| "
                        f"{float((a - b).abs().max())}")
                err["arena_fold"] = max(err["arena_fold"],
                                        float((a - b).abs().max()))
            del mk, vk, mr, vr
        for wd in (0.0, 0.01):
            kw = dict(lr=1e-3, bc1=0.1, bc2=0.001, eps=1e-8, weight_decay=wd)
            pk, pr = p.clone(), p.clone()
            fused_step.arena_apply(pk, m, v, **kw)
            fused_step.arena_apply_ref(pr, m, v, **kw)
            if not torch.equal(pk, pr):
                raise AssertionError(
                    f"arena_apply rows={rows} wd={wd}: kernel != plain at "
                    f"{int((pk != pr).sum())} elements, max |d| "
                    f"{float((pk - pr).abs().max())}")
            err["arena_apply"] = max(err["arena_apply"],
                                     float((pk - pr).abs().max()))
            del pk, pr
        fold_kw = dict(beta1=0.9, beta2=0.999, scale=1.0 / 8, decay=None)
        apply_kw = dict(lr=1e-3, bc1=0.1, bc2=0.001, eps=1e-8)
        timings = {
            "arena_fold": (
                timed_ms(torch, lambda: fused_step.arena_fold(m, v, g,
                                                              **fold_kw),
                         reps=KERNEL_REPS),
                timed_ms(torch, lambda: fused_step.arena_fold_ref(
                    m, v, g, **fold_kw), runs=PLAIN_TIMED_RUNS, warmup=1),
                # m, v, g read once, m, v written once; 8 fp32 ops each
                bound_ms(5 * 4 * n, 8 * n)),
            "arena_apply": (
                timed_ms(torch, lambda: fused_step.arena_apply(p, m, v,
                                                               **apply_kw),
                         reps=KERNEL_REPS),
                timed_ms(torch, lambda: fused_step.arena_apply_ref(
                    p, m, v, **apply_kw), runs=PLAIN_TIMED_RUNS, warmup=1),
                # p, m, v read once, p written once; 7 fp32 ops each
                bound_ms(4 * 4 * n, 7 * n)),
        }
        for name, (ms, plain_ms, (bnd, by)) in timings.items():
            log(json.dumps({"phase": "kernel", "name": name, "rows": rows,
                            "max_abs_err": err[name], "ms": ms,
                            "plain_ms": plain_ms, "bound_ms": bnd,
                            "bound_by": by, "library_call": "none"}))
            if rows == sizes[-1]:
                result[name] = dict(max_abs_err=err[name], ms=ms,
                                    plain_ms=plain_ms, bound_ms=bnd,
                                    bound_by=by, library_ms=None)
        for x in (m, v, p):
            if not torch.isfinite(x).all():
                raise AssertionError(f"rows={rows}: non-finite state after "
                                     f"the timed runs")
        del m, v, g, p
        torch.cuda.empty_cache()
    return result


def _compare(name, label, pairs):
    """Raise unless each (kernel result, plain result) pair is equal bit
    for bit; return the largest |difference| (0.0)."""
    for a, b in pairs:
        if not a.equal(b):
            raise AssertionError(
                f"{name} {label}: kernel != plain at {int((a != b).sum())} "
                f"elements, max |d| {float((a - b).abs().max())}")
    return max(float((a - b).abs().max()) for a, b in pairs)


def _kernel_entry(name, label, ms, plain_ms, bound, shape_info,
                  logged=None):
    """The kernel's entry for one case; `logged` goes into the logged line
    only."""
    bnd, by = bound
    line = {"phase": "kernel", "name": name, "case": label, **shape_info,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "library_call": "none", **(logged or {})}
    log(json.dumps(line))
    return {"case": label, **shape_info, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": by}


def full_layout(torch, arch="bert_large", n_shards=1):
    """An arch's arena layout, built from a param tree on the card (for
    `n_shards` ZeRO-1 row ranges)."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.arena import build_layout
    from repro_torch.models.model import init_params
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = init_params(get_config(arch), gen)
    layout = build_layout(params, n_shards=n_shards)
    del params
    torch.cuda.empty_cache()
    return layout


def check_slice_fold(torch, fused_step, layout):
    """Phase 3, arena_fold_slice: on the full arena, slices for layer 0,
    the last layer and the rest region, with and without the fused decay,
    bitwise against the plain version; rows outside the slice unchanged.
    Timed on a layer slice (24 of the 25 launches per micro-batch) and on
    the rest slice."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    lanes = fused_step.LANES
    m = torch.randn((layout.rows, lanes), generator=gen, device="cuda") * 1e-3
    v = (torch.randn((layout.rows, lanes), generator=gen, device="cuda")
         * 1e-6).abs()
    spec, rest = layout.stack("blocks"), layout.rest
    last = spec.n_layers - 1
    slices = {
        "layer 0": (spec.row, spec.layer_rows, layout.slice_block(spec)),
        f"layer {last}": (spec.row + last * spec.layer_rows, spec.layer_rows,
                          layout.slice_block(spec)),
        "rest": (rest.row, rest.rows, layout.slice_block(rest)),
    }
    err = 0.0
    slabs = {}
    for label, (off, rows_g, block) in slices.items():
        g = torch.randn((rows_g, lanes), generator=gen, device="cuda")
        slabs[label] = g
        for decay in ((0.9, 0.999), None):
            kw = dict(beta1=0.9, beta2=0.999, block=block, scale=1.0 / 8,
                      decay=decay)
            mk, vk, mr, vr = m.clone(), v.clone(), m.clone(), v.clone()
            fused_step.arena_fold_slice(mk, vk, g, off, **kw)
            fused_step.arena_fold_slice_ref(mr, vr, g, off, **kw)
            torch.cuda.synchronize()
            err = max(err, _compare("arena_fold_slice",
                                    f"{label} decay={decay}",
                                    [(mk, mr), (vk, vr)]))
            hi = off + rows_g
            for k, x in (("m", mk), ("v", vk)):
                x0 = m if k == "m" else v
                if not (torch.equal(x[:off], x0[:off])
                        and torch.equal(x[hi:], x0[hi:])):
                    raise AssertionError(f"arena_fold_slice {label}: {k} "
                                         f"changed outside rows "
                                         f"[{off}, {hi})")
                if torch.equal(x[off:hi], x0[off:hi]):
                    raise AssertionError(f"arena_fold_slice {label}: {k} "
                                         f"unchanged inside the slice")
            del mk, vk, mr, vr
    cases = []
    for label in ("layer 0", "rest"):
        off, rows_g, block = slices[label]
        g = slabs[label]
        kw = dict(beta1=0.9, beta2=0.999, block=block, scale=1.0 / 8)
        n = rows_g * lanes
        cases.append(_kernel_entry(
            "arena_fold_slice", label,
            timed_ms(torch, lambda: fused_step.arena_fold_slice(
                m, v, g, off, **kw), reps=KERNEL_REPS),
            timed_ms(torch, lambda: fused_step.arena_fold_slice_ref(
                m, v, g, off, **kw), runs=PLAIN_TIMED_RUNS, warmup=1),
            # slab g read once, the slice's m, v read and written once
            bound_ms(5 * 4 * n, 8 * n),
            {"rows": rows_g, "row_offset": off}))
    if not (torch.isfinite(m).all() and torch.isfinite(v).all()):
        raise AssertionError("arena_fold_slice: non-finite state after the "
                             "timed runs")
    del m, v, slabs
    torch.cuda.empty_cache()
    return dict(cases[0], max_abs_err=err, library_ms=None, by_case=cases)


CODEC_SMALL_ROWS = 64
CODEC_FORMS = ("arena_fold", "arena_fold_slice", "arena_apply")


def _edge_arenas(torch, rows, seed):
    """m, v (fp32), g and p on the card, their first rows the codecs' edge
    cases as tests/test_torch_codecs.py builds them: 0 a zero row; 1 rows
    whose max/127 is subnormal before and after a fold; 2 subnormal g^2
    terms and subnormal state entries; 3 values on exact code boundaries
    (k * s) with a zero gradient; 4 a row of one sign; 5 -0.0 in m beside
    zero gradients of both signs."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def n(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    tiny = torch.finfo(torch.float32).tiny
    m, v, g, p = n(rows, LANES) * 1e-3, (n(rows, LANES) * 1e-6).abs(), \
        n(rows, LANES), n(rows, LANES) * 0.02
    for x in (m, v, g):
        x[0] = 0.0
    u = torch.rand(LANES, generator=gen, device="cuda")
    m[1] = (u - 0.5) * 100.0 * tiny
    v[1] = u * 60.0 * tiny
    g[1] = n(LANES) * 1e-35
    g[2, ::3] = 1e-20
    g[2, 1::3] = -3e-21
    m[2, ::5] = 3e-40
    v[2, ::7] = 2e-41
    k = torch.randint(0, 128, (LANES,), generator=gen, device="cuda").float()
    k[0] = 127.0
    v[3] = k * 3e-5
    m[3] = (k - 64.0) * 3e-5
    g[3] = 0.0
    m[4] = -m[4].abs()
    g[4] = -g[4].abs()
    m[5, ::2] = -0.0
    g[5, ::4] = 0.0
    g[5, 2::8] = -0.0
    return m, v, g, p


def _encode(adama_accum, moment, codec, x):
    """An fp32 moment in a codec's columns (the plain helpers)."""
    if codec == "fp32":
        return x.clone()
    if codec == "int8":
        return (adama_accum.q8s_encode_rows if moment == "m"
                else adama_accum.q8_encode_rows)(x)
    if codec == "rowcol":
        return (x.sum(1, keepdim=True), x.sum(0, keepdim=True))
    return (adama_accum.fac_row_stat(x),)


def _clone(state):
    return tuple(x.clone() for x in state) if isinstance(state, tuple) \
        else state.clone()


def _cols(state):
    return state if isinstance(state, tuple) else (state,)


def _compare_bits(torch, name, label, pairs):
    """Raise unless each (kernel, plain) pair of columns is equal bit for
    bit (signed zeros included); return the largest |difference| over
    every column (0.0)."""
    err = 0.0
    for a, b in pairs:
        for x, y in zip(_cols(a), _cols(b)):
            if not x.view(torch.uint8).equal(y.view(torch.uint8)):
                raise AssertionError(
                    f"{name} {label}: kernel != plain at "
                    f"{int((x != y).sum())} elements ({x.dtype})")
            err = max(err, float((x.float() - y.float()).abs().max()))
    return err


def _row_cols(fused_step, m_codec, v_codec, m, v):
    """The row-indexed columns of both moments (rowcol's shared column
    sums excepted)."""
    return [x for name, moment, st in ((m_codec, "m", m), (v_codec, "v", v))
            for x, c in zip(_cols(st),
                            fused_step.kernel_codec(moment, name).cols)
            if c.row_indexed]


# rowcol's partition of this many rows: 16 ranges of 64 rows, the last 40
RC_RANGE_ROWS = 1000


def _check_rowcol_ranges(torch, fused_step, adama_accum, m_codec, checked):
    """A rowcol pair on an arena of RC_RANGE_ROWS rows, whose fold spans
    several ranges and so the kernel's ordered pass over their partial sums:
    a fold with the decay, three slice folds in a row (the column sums take
    each one's, undecayed) and the apply, bit for bit."""
    pair = f"{m_codec}/rowcol"
    codecs = dict(m_codec=m_codec, v_codec="rowcol")
    m, v, g, p = _edge_arenas(torch, RC_RANGE_ROWS, 7)
    mk, vk = _encode(adama_accum, "m", m_codec, m), \
        _encode(adama_accum, "v", "rowcol", v)
    mr, vr = _clone(mk), _clone(vk)
    kw = dict(beta1=0.9, beta2=0.999, scale=1.0 / 8, **codecs)
    fused_step.arena_fold(mk, vk, g, decay=(0.9, 0.999), **kw)
    fused_step.arena_fold_ref(mr, vr, g, decay=(0.9, 0.999), **kw)
    torch.cuda.synchronize()
    _compare_bits(torch, "arena_fold", f"{pair} {RC_RANGE_ROWS} rows",
                  [(mk, mr), (vk, vr)])
    checked.append(("arena_fold", pair, f"{RC_RANGE_ROWS} rows"))
    for off, rows_g in ((600, 400), (8, 592), (0, 8)):
        gs = g[:rows_g].flip(0).contiguous()
        fused_step.arena_fold_slice(mk, vk, gs, off, block=8, **kw)
        fused_step.arena_fold_slice_ref(mr, vr, gs, off, block=8, **kw)
        torch.cuda.synchronize()
        _compare_bits(torch, "arena_fold_slice",
                      f"{pair} rows [{off}, {off + rows_g})",
                      [(mk, mr), (vk, vr)])
        checked.append(("arena_fold_slice", pair,
                        f"{RC_RANGE_ROWS} rows, [{off}, {off + rows_g})"))
    kw = dict(lr=1e-3, bc1=0.19, bc2=0.001999, eps=1e-8, **codecs)
    pk, pr = p.clone(), p.clone()
    fused_step.arena_apply(pk, mk, vk, **kw)
    fused_step.arena_apply_ref(pr, mr, vr, **kw)
    torch.cuda.synchronize()
    _compare_bits(torch, "arena_apply", f"{pair} {RC_RANGE_ROWS} rows",
                  [(pk, pr)])
    checked.append(("arena_apply", pair, f"{RC_RANGE_ROWS} rows"))


def check_ptxas(text: str):
    """Registers, stack frame and spills of each rowcol_fold_kernel
    instantiation from the build's ptxas lines; raise on a stack frame or
    a spill. Returns {kernel: {...}} ({} when the library was already
    built, so no lines came)."""
    from repro_torch.launch.fold_ab import ptxas_lines
    if not text:
        log(json.dumps({"phase": "ptxas", "note": "fused_step was already "
                        "built: no ptxas lines"}))
        return {}
    lines = {k: v for k, v in ptxas_lines(text).items()
             if k.startswith("rowcol")}
    if len(lines) != 12:
        raise AssertionError(f"ptxas: {len(lines)} rowcol_fold_kernel "
                             f"instantiations found, 12 expected")
    for name, info in sorted(lines.items()):
        log(json.dumps({"phase": "ptxas", "kernel": name, **info}))
        if info.get("stack_frame") or info.get("spill_stores") or \
                info.get("spill_loads"):
            raise AssertionError(f"ptxas: {name} has a stack frame or "
                                 f"spills: {info}")
    return lines


def check_fold_exactness(torch, fused_step):
    """Phase 3's first check: each of fused_step.EXACTNESS_CHECKS on the
    card, logged with the inputs it compared; raise if a substitution the
    kernel makes (EXACTNESS_USED) differs anywhere. The card's own flushed
    product and fma, which the kernel does not use, are logged with the
    count where they part from fl. Returns {check: counts}."""
    out = {}
    for check in fused_step.EXACTNESS_CHECKS:
        t0 = time.perf_counter()
        r = fused_step.fold_exactness(check)
        r["seconds"] = time.perf_counter() - t0
        r["used_by_the_kernel"] = check in fused_step.EXACTNESS_USED
        log(json.dumps({"phase": "fold_exactness", **r}))
        if not r["compared"] or (r["used_by_the_kernel"] and r["differing"]):
            raise AssertionError(f"fold_exactness {check}: {r}")
        out[check] = {k: r[k] for k in ("compared", "differing",
                                        "nan_payloads_differing",
                                        "used_by_the_kernel")}
    return out


def check_codec_small(torch, fused_step, adama_accum):
    """Phase 3, the codec forms: every (m, v) pair through the fold, the
    slice fold and the apply on a 64-row arena with the edge rows, bit for
    bit against the plain versions (the rowcol pairs also on a
    RC_RANGE_ROWS-row arena). Returns the checked cases."""
    from repro_torch.core import state_store
    b1, b2 = 0.9, 0.999
    checked = []
    for m_codec, v_codec in state_store.registered_combinations():
        pair = f"{m_codec}/{v_codec}"
        m, v, g, p = _edge_arenas(torch, CODEC_SMALL_ROWS, 5)
        codecs = dict(m_codec=m_codec, v_codec=v_codec)
        mk, vk = _encode(adama_accum, "m", m_codec, m), \
            _encode(adama_accum, "v", v_codec, v)
        mr, vr = _clone(mk), _clone(vk)
        for grad, kw in ((g, dict(scale=1.0, decay=(b1, b2))),
                         (g.flip(0).contiguous(),
                          dict(scale=0.25, decay=None))):
            fused_step.arena_fold(mk, vk, grad, beta1=b1, beta2=b2, **kw,
                                  **codecs)
            fused_step.arena_fold_ref(mr, vr, grad, beta1=b1, beta2=b2,
                                      **kw, **codecs)
            torch.cuda.synchronize()
            _compare_bits(torch, "arena_fold", f"{pair} {kw}",
                          [(mk, mr), (vk, vr)])
            checked.append(("arena_fold", pair, str(kw)))
        rows_of = _row_cols(fused_step, m_codec, v_codec, mk, vk)
        before = [x.clone() for x in rows_of]
        kw = dict(beta1=b1, beta2=b2, block=16, scale=1.0 / 8,
                  decay=(b1, b2), **codecs)
        fused_step.arena_fold_slice(mk, vk, g[8:40], 16, **kw)
        fused_step.arena_fold_slice_ref(mr, vr, g[8:40], 16, **kw)
        torch.cuda.synchronize()
        _compare_bits(torch, "arena_fold_slice", f"{pair} rows [16, 48)",
                      [(mk, mr), (vk, vr)])
        for x, x0 in zip(rows_of, before):
            if not (x[:16].equal(x0[:16]) and x[48:].equal(x0[48:])):
                raise AssertionError(f"arena_fold_slice {pair}: a row "
                                     f"outside [16, 48) changed")
        checked.append(("arena_fold_slice", pair, "rows [16, 48)"))
        for wd in (0.0, 0.01):
            kw = dict(lr=1e-3, bc1=0.19, bc2=0.001999, eps=1e-8,
                      weight_decay=wd, **codecs)
            pk, pr = p.clone(), p.clone()
            fused_step.arena_apply(pk, mk, vk, **kw)
            fused_step.arena_apply_ref(pr, mr, vr, **kw)
            torch.cuda.synchronize()
            _compare_bits(torch, "arena_apply", f"{pair} wd={wd}",
                          [(pk, pr)])
            if not torch.isfinite(pk).all():
                raise AssertionError(f"arena_apply {pair}: non-finite p")
            checked.append(("arena_apply", pair, f"wd={wd}"))
        if v_codec == "rowcol":
            _check_rowcol_ranges(torch, fused_step, adama_accum, m_codec,
                                 checked)
    log(json.dumps({"phase": "kernel", "case": "codec forms, 64-row arena "
                    "with edge rows (rowcol also at "
                    f"{RC_RANGE_ROWS} rows), bit for bit",
                    "checked": len(checked),
                    "pairs": [f"{a}/{b}" for a, b in
                              state_store.registered_combinations()]}))
    return checked


def _codec_bytes(m_codec, v_codec, rows):
    """Bytes of the (m, v) state columns over `rows` arena rows (a shared
    column, rowcol's column sums, once)."""
    from repro_torch.core import state_store
    total = 0
    for moment, name in (("m", m_codec), ("v", v_codec)):
        for c in state_store.get_codec(name, moment).kernel.cols:
            total += ((rows if c.row_indexed else 1) * c.width
                      * (1 if "int8" in str(c.dtype) else 4))
    return total


# fp32 operations per element, counted from the codec forms' arithmetic (a
# fused multiply-add counts two; flushes and conversions not counted). The
# fold: s*g and (s*g)^2, then per moment fp32 c*x and the fma (3); int8 the
# decode, one product, the fma, the row max, the divide, the rounding and
# the clip (9); factored the row max (1); rowcol the row sum and the column
# sum (2). The apply: each int8 moment's decode (1), rowcol's vr * column
# (1), the divide and the final fma (3), and unless v is factored (one root
# per row) v/bc2, sqrt, +eps and bc1* (4).
_FOLD_OPS = {"fp32": 3, "int8": 9, "factored": 1, "rowcol": 2}
_DECODE_OPS = {"fp32": 0, "int8": 1, "factored": 0, "rowcol": 1}
# the device kernel each rowcol form runs, by the name torch.profiler gives
_RC_KERNELS = {"arena_fold": "rowcol_fold_kernel",
               "arena_fold_slice": "rowcol_fold_kernel",
               "arena_apply": "arena_apply_kernel"}


def check_codec_timed(torch, fused_step, layout):
    """Phase 3, the codec forms at the full stablelm-1.6b arena: int8/int8
    and int8/factored, the fold, one layer slice, the rest slice (at its
    real row offset) and the apply, each run once on clones of the same
    state beside its plain version and compared bit for bit (every column
    of the whole arena, so rows outside a slice are held too), then timed
    beside its bound. Returns {kernel: {pair: [entry per case]}}."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    rows = layout.rows
    spec, rest = layout.stack("blocks"), layout.rest
    g = torch.randn((rows, LANES), generator=gen, device="cuda")
    p = torch.randn((rows, LANES), generator=gen, device="cuda") * 0.02

    def codes(lo):
        return torch.randint(lo, 128, (rows, LANES), generator=gen,
                             device="cuda", dtype=torch.int8)

    def col(scale, n=rows, width=1):
        return torch.rand((n, width), generator=gen, device="cuda") * scale
    out = {name: {} for name in CODEC_FORMS}
    per_call = {}
    for (m_codec, v_codec) in TIMED_CODEC_PAIRS:
        pair = f"{m_codec}/{v_codec}"
        m = ((codes(-127), col(1e-5)) if m_codec == "int8" else
             torch.randn((rows, LANES), generator=gen, device="cuda") * 1e-3)
        v = {"int8": lambda: (codes(0), col(1e-8)),
             "factored": lambda: (col(1e-6),),
             "rowcol": lambda: (col(1e-3), col(1.0, 1, LANES))}[v_codec]()
        codecs = dict(m_codec=m_codec, v_codec=v_codec)
        fold_kw = dict(beta1=0.9, beta2=0.999, scale=1.0 / 8, decay=None,
                       **codecs)
        ops = 2 + _FOLD_OPS[m_codec] + _FOLD_OPS[v_codec]
        cases = [("arena_fold", "whole arena", rows, 0, None)]
        for name, label, n_rows, off, block in (
                ("arena_fold_slice", "layer 0", spec.layer_rows, spec.row,
                 layout.slice_block(spec)),
                ("arena_fold_slice", "rest", rest.rows, rest.row,
                 layout.slice_block(rest))):
            cases.append((name, label, n_rows, off, block))
        for name, label, n_rows, off, block in cases:
            gs = g[:n_rows]
            if name == "arena_fold":
                def run(fn, m, v, gs=gs):
                    fn(m, v, gs, **fold_kw)
                kern, plain = fused_step.arena_fold, fused_step.arena_fold_ref
            else:
                def run(fn, m, v, gs=gs, off=off, block=block):
                    fn(m, v, gs, off, block=block, **fold_kw)
                kern, plain = (fused_step.arena_fold_slice,
                               fused_step.arena_fold_slice_ref)
            mk, vk, mr, vr = _clone(m), _clone(v), _clone(m), _clone(v)
            run(kern, mk, vk)
            run(plain, mr, vr)
            torch.cuda.synchronize()
            err = _compare_bits(torch, name, f"{pair} {label}",
                                [(mk, mr), (vk, vr)])
            del mk, vk, mr, vr
            n = n_rows * LANES
            entry = _kernel_entry(
                name, f"{pair} {label}",
                timed_ms(torch, lambda: run(kern, m, v), runs=WIRE_TIMED_RUNS,
                         reps=KERNEL_REPS),
                timed_ms(torch, lambda: run(plain, m, v),
                         runs=CODEC_PLAIN_RUNS, warmup=1),
                # g read once; the slice's state columns read and written
                bound_ms(4 * n + 2 * _codec_bytes(m_codec, v_codec, n_rows),
                         ops * n),
                {"pair": pair, "rows": n_rows, "row_offset": off,
                 "max_abs_err": err})
            out[name].setdefault(pair, []).append(entry)
        apply_kw = dict(lr=1e-3, bc1=0.19, bc2=0.001999, eps=1e-8, **codecs)
        pk, pr = p.clone(), p.clone()
        fused_step.arena_apply(pk, m, v, **apply_kw)
        fused_step.arena_apply_ref(pr, m, v, **apply_kw)
        torch.cuda.synchronize()
        err = _compare_bits(torch, "arena_apply", f"{pair} whole arena",
                            [(pk, pr)])
        del pk, pr
        n = rows * LANES
        apply_ops = _DECODE_OPS[m_codec] + _DECODE_OPS[v_codec] + 3 + (
            0 if v_codec == "factored" else 4)
        out["arena_apply"][pair] = [_kernel_entry(
            "arena_apply", f"{pair} whole arena",
            timed_ms(torch, lambda: fused_step.arena_apply(p, m, v,
                                                           **apply_kw),
                     runs=WIRE_TIMED_RUNS, reps=KERNEL_REPS),
            timed_ms(torch, lambda: fused_step.arena_apply_ref(p, m, v,
                                                               **apply_kw),
                     runs=CODEC_PLAIN_RUNS, warmup=1),
            # p read and written once; the state columns read once
            bound_ms(8 * n + _codec_bytes(m_codec, v_codec, rows),
                     apply_ops * n),
            {"pair": pair, "rows": rows, "max_abs_err": err})]
        if v_codec == "rowcol":
            calls = [(f"{name} {pair} {label}", name,
                      lambda name=name, off=off, block=block, gs=g[:n_rows]:
                      (fused_step.arena_fold(m, v, gs, **fold_kw)
                       if name == "arena_fold" else
                       fused_step.arena_fold_slice(m, v, gs, off, block=block,
                                                   **fold_kw)))
                     for name, label, n_rows, off, block in cases]
            calls.append((f"arena_apply {pair} whole arena", "arena_apply",
                          lambda: fused_step.arena_apply(p, m, v,
                                                         **apply_kw)))
            per_call.update(_kernels_of_calls(torch, calls))
        for x in (*_cols(m), *v, p):
            if x.is_floating_point() and not torch.isfinite(x).all():
                raise AssertionError(f"{pair}: non-finite state or params "
                                     f"after the timed runs")
        del m, v
    del g, p
    torch.cuda.empty_cache()
    return out, per_call


# ---------------------------------------------------------------------------
# The guarded forms and the finite flag
# ---------------------------------------------------------------------------

# the guard's traced scale: f32(1/8) / f32(3), not a power of two, formed by
# a division on the card
GUARD_SCALE = (0.125, 3.0)


def _guard_vec(torch, decay, ok, scale=None):
    """A guard vector [dm, dv, ok, scale] on the card; scale None is
    GUARD_SCALE's quotient, divided there."""
    dm, dv = (1.0, 1.0) if decay is None else decay
    head = torch.tensor([dm, dv, 1.0 if ok else 0.0], device="cuda")
    if scale is None:
        num, den = (torch.tensor(x, device="cuda") for x in GUARD_SCALE)
        scale = (num / den).reshape(1)
    else:
        scale = torch.tensor([scale], device="cuda")
    return torch.cat([head, scale])


def _bits_equal(torch, a, b):
    return all(x.view(torch.uint8).equal(y.view(torch.uint8))
               for x, y in zip(_cols(a), _cols(b)))


def _guard_case(torch, fused_step, name, pair, label, state, run, checked):
    """One guarded call on `state` (a tuple of tensors or column tuples):
    ok = 1 at the traced scale, kernel against plain version, bit for bit;
    ok = 0, every byte of `state` unchanged by kernel and plain version."""
    for ok in (True, False):
        sk, sr = (tuple(_clone(x) for x in state) for _ in range(2))
        run(True, sk, ok)
        run(False, sr, ok)
        torch.cuda.synchronize()
        _compare_bits(torch, name, f"guarded {pair} {label} ok={int(ok)}",
                      list(zip(sk, sr)))
        if not ok and not all(_bits_equal(torch, x, y)
                              for x, y in zip(sk, state)):
            raise AssertionError(f"{name} guarded {pair} {label}: ok = 0 "
                                 f"changed the state")
        checked.append((name, pair, f"{label} ok={int(ok)}"))


def _check_guard_arena(torch, fused_step, adama_accum, m_codec, v_codec,
                       rows, seed, checked):
    """A pair's guarded fold (with and without the decay), slice fold and
    apply (with and without weight decay; ok = 0 also at bc1 = 0) on an
    arena of `rows` rows with the edge rows; then ok = 1 at scale f32(1/8)
    against the unguarded kernels, bit for bit."""
    pair = f"{m_codec}/{v_codec}"
    codecs = dict(m_codec=m_codec, v_codec=v_codec)
    m, v, g, p = _edge_arenas(torch, rows, seed)
    gbad = g.clone()                  # ok = 0 must keep its NaN out
    gbad[rows // 2, 7] = float("nan")
    mk, vk = _encode(adama_accum, "m", m_codec, m), \
        _encode(adama_accum, "v", v_codec, v)
    b1, b2 = 0.9, 0.999
    kw = dict(beta1=b1, beta2=b2, **codecs)
    block = 8
    lo, hi = block * (rows // (4 * block)), block * (3 * rows // (4 * block))

    def mv(state):
        return state if len(state) == 2 else state[:2]
    for decay in ((b1, b2), None):
        def fold(kern, st, ok, decay=decay):
            fn = fused_step.arena_fold if kern else fused_step.arena_fold_ref
            fn(*st, g if ok else gbad, guard=_guard_vec(torch, decay, ok),
               **kw)
        _guard_case(torch, fused_step, "arena_fold", pair,
                    f"{rows} rows decay={decay}", (mk, vk), fold, checked)

    def slice_fold(kern, st, ok):
        fn = (fused_step.arena_fold_slice if kern
              else fused_step.arena_fold_slice_ref)
        fn(*st, (g if ok else gbad)[:hi - lo].flip(0).contiguous(), lo,
           block=block, guard=_guard_vec(torch, (b1, b2), ok), **kw)
    _guard_case(torch, fused_step, "arena_fold_slice", pair,
                f"{rows} rows [{lo}, {hi})", (mk, vk), slice_fold, checked)
    # the apply reads a state folded once (unguarded) from the edge arena
    fused_step.arena_fold(mk, vk, g, decay=(b1, b2), **kw)
    for wd, bc1 in ((0.0, 0.19), (0.01, 0.19), (0.01, 0.0)):
        def apply(kern, st, ok, wd=wd, bc1=bc1):
            fn = fused_step.arena_apply if kern else fused_step.arena_apply_ref
            fn(st[0], mk, vk, lr=1e-3, bc1=bc1, bc2=0.001999, eps=1e-8,
               weight_decay=wd, guard=torch.tensor(
                   [1.0 if ok else 0.0], device="cuda"), **codecs)
        if bc1 == 0.0:               # only the skipped apply may see bc1 = 0
            pk = p.clone()
            apply(True, (pk,), False)
            torch.cuda.synchronize()
            if not _bits_equal(torch, pk, p):
                raise AssertionError(f"arena_apply guarded {pair}: ok = 0 "
                                     f"at bc1 = 0 changed p")
            checked.append(("arena_apply", pair, f"{rows} rows ok=0 bc1=0"))
            continue
        _guard_case(torch, fused_step, "arena_apply", pair,
                    f"{rows} rows wd={wd}", (p,), apply, checked)
    # ok = 1 at a static scale: the guarded kernels are the unguarded ones
    sg, su = ((_clone(mk), _clone(vk)) for _ in range(2))
    fused_step.arena_fold(*sg, g, guard=_guard_vec(torch, (b1, b2), True,
                                                   0.125), **kw)
    fused_step.arena_fold(*su, g, scale=0.125, decay=(b1, b2), **kw)
    fused_step.arena_fold_slice(*sg, g[:hi - lo], lo, block=block,
                                guard=_guard_vec(torch, None, True, 0.125),
                                **kw)
    fused_step.arena_fold_slice(*su, g[:hi - lo], lo, block=block,
                                scale=0.125, **kw)
    pg, pu = p.clone(), p.clone()
    akw = dict(lr=1e-3, bc1=0.19, bc2=0.001999, eps=1e-8, weight_decay=0.01,
               **codecs)
    fused_step.arena_apply(pg, *sg, guard=torch.ones(1, device="cuda"),
                           **akw)
    fused_step.arena_apply(pu, *su, **akw)
    torch.cuda.synchronize()
    _compare_bits(torch, "guarded vs unguarded", f"{pair} {rows} rows",
                  [(sg[0], su[0]), (sg[1], su[1]), (pg, pu)])
    checked.append(("guarded = unguarded", pair, f"{rows} rows"))


def _finite_cases(torch, dtype):
    """finite_and's edge cases: one NaN, +Inf and -Inf at the first and at
    the last element (of a length whose bytes are no multiple of 16, and of
    a view one element off 16-byte alignment), a finite row of subnormals
    and a finite row of the largest values."""
    n = 1_000_003
    base = torch.linspace(-3.0, 3.0, n, device="cuda").to(dtype)
    cases = {}
    for bad in ("nan", "inf", "-inf"):
        for at in (0, n - 1):
            x = base.clone()
            x[at] = float(bad)
            cases[f"{bad} at {at}"] = x
            cases[f"{bad} at {at}, view [1:]"] = x[1:]
    fin = torch.finfo(dtype)
    cases["subnormals"] = torch.full((LANES,), fin.tiny / 4, device="cuda",
                                     dtype=dtype)
    cases["largest finite"] = torch.full((n,), fin.max, device="cuda",
                                         dtype=dtype)
    cases["finite"] = base
    return cases


def check_guard_small(torch, fused_step, adama_accum):
    """Phase 3, the guarded forms: every (m, v) pair on a 64-row edge arena,
    the rowcol pairs also on RC_RANGE_ROWS rows, ok = 1 at the traced scale
    and ok = 0, kernel against plain version bit for bit, ok = 0 a no-op,
    ok = 1 at f32(1/8) equal to the unguarded kernels; finite_and on fp32
    and bf16 edge cases against its plain version. Returns the checked
    cases."""
    from repro_torch.core import state_store
    checked = []
    for m_codec, v_codec in state_store.registered_combinations():
        _check_guard_arena(torch, fused_step, adama_accum, m_codec, v_codec,
                           CODEC_SMALL_ROWS, 21, checked)
        if v_codec == "rowcol":
            _check_guard_arena(torch, fused_step, adama_accum, m_codec,
                               v_codec, RC_RANGE_ROWS, 22, checked)
    for dtype in (torch.float32, torch.bfloat16):
        for label, x in _finite_cases(torch, dtype).items():
            for start in (1.0, 0.0):
                ok, okr = (torch.tensor([start], device="cuda")
                           for _ in range(2))
                fused_step.finite_and(x, ok)
                fused_step.finite_and_ref(x, okr)
                torch.cuda.synchronize()
                if not ok.equal(okr):
                    raise AssertionError(f"finite_and {dtype} {label} "
                                         f"from {start}: {ok.item()} != "
                                         f"plain {okr.item()}")
                checked.append(("finite_and", str(dtype), label))
    log(json.dumps({"phase": "kernel", "case": "guarded forms (ok = 1 at "
                    "f32(1/8)/f32(3), ok = 0), every pair on the 64-row "
                    f"edge arena, rowcol also at {RC_RANGE_ROWS} rows; "
                    "finite_and edge cases; bit for bit",
                    "checked": len(checked)}))
    return checked


def _digest(torch, tensors):
    """A digest of the tensors' bytes, computed on the card: each one's
    int32 words times fixed odd int64 weights, summed modulo 2^64 (an odd
    weight times a nonzero word difference is never 0 modulo 2^64), chunk
    by chunk, folded in order."""
    chunk = 1 << 26
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20)
    w = torch.randint(-2 ** 62, 2 ** 62, (chunk,), generator=gen,
                      device="cuda", dtype=torch.int64) * 2 + 1
    total = 0
    for t in tensors:
        b = t.detach().contiguous().view(-1).view(torch.uint8)
        if b.numel() % 4:
            b = torch.cat([b, b.new_zeros(4 - b.numel() % 4)])
        words = b.view(torch.int32)
        for lo in range(0, words.numel(), chunk):
            c = words[lo:lo + chunk].to(torch.int64)
            term = int((c * w[:c.numel()]).sum()) % 2 ** 64
            total = (total * 1_000_003 + term) % 2 ** 64
    return total


def _tree_leaves(tree):
    from repro_torch.core import arena as arena_mod
    return arena_mod.tree_flatten(tree)[0]


def _state_tensors(out):
    """The tensors a run's digest covers: the param leaves (sorted paths),
    then every column of m and v, then the fp8 wire's residual where the
    state has one."""
    return _tree_leaves(out["params"]) + _moment_tensors(out["opt_state"])


def _moment_tensors(state):
    """Every column of an arena state's m and v, then its fp8 residual."""
    from repro_torch.core import state_store
    cols = [x for mo in ("m", "v")
            for x in state_store.codec_of(state[mo], mo).parts_of(state[mo])]
    return cols + ([state["ef"].data] if "ef" in state else [])


# the guarded forms timed at the stablelm-1.6b arena beside the unguarded
GUARD_TIMED_PAIRS = (FP32, ("int8", "rowcol"))


def check_guard_timed(torch, fused_step, layout):
    """Phase 3, the guarded forms at the full stablelm-1.6b arena: for
    fp32/fp32 and int8/rowcol, the fold, a layer slice, the rest slice and
    the apply, guarded (ok = 1, the traced scale) against its plain
    version bit for bit, guarded at f32(1/8) against the unguarded kernel
    bit for bit, then timed in turns beside the unguarded kernel (unguarded,
    guarded, guarded, unguarded). Then finite_and at the arena's slab, a
    layer slab, the rest slab and the bert-large slab, against its plain
    version and timed beside two PyTorch calls of the same function.
    Returns ({kernel: {pair: [entry per case]}}, finite_and's entry)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    rows = layout.rows
    spec, rest = layout.stack("blocks"), layout.rest
    g = torch.randn((rows, LANES), generator=gen, device="cuda")
    p = torch.randn((rows, LANES), generator=gen, device="cuda") * 0.02
    out = {name: {} for name in CODEC_FORMS}
    for m_codec, v_codec in GUARD_TIMED_PAIRS:
        pair = f"{m_codec}/{v_codec}"
        codecs = dict(m_codec=m_codec, v_codec=v_codec)
        if m_codec == "int8":
            m = (torch.randint(-127, 128, (rows, LANES), generator=gen,
                               device="cuda", dtype=torch.int8),
                 torch.rand((rows, 1), generator=gen, device="cuda") * 1e-5)
            v = (torch.rand((rows, 1), generator=gen, device="cuda") * 1e-3,
                 torch.rand((1, LANES), generator=gen, device="cuda"))
        else:
            m = torch.randn((rows, LANES), generator=gen,
                            device="cuda") * 1e-3
            v = (torch.randn((rows, LANES), generator=gen,
                             device="cuda") * 1e-6).abs()
        vec = _guard_vec(torch, None, True)
        vec8 = _guard_vec(torch, None, True, 0.125)
        ops = 2 + _FOLD_OPS[m_codec] + _FOLD_OPS[v_codec]
        cases = [("arena_fold", "whole arena", rows, 0, None),
                 ("arena_fold_slice", "layer 0", spec.layer_rows, spec.row,
                  layout.slice_block(spec)),
                 ("arena_fold_slice", "rest", rest.rows, rest.row,
                  layout.slice_block(rest))]
        for name, label, n_rows, off, block in cases:
            gs = g[:n_rows]
            base = dict(beta1=0.9, beta2=0.999, **codecs)
            if name == "arena_fold":
                def run(fn, mm, vv, gs=gs, **kw):
                    fn(mm, vv, gs, **base, **kw)
                kern, plain = fused_step.arena_fold, fused_step.arena_fold_ref
            else:
                def run(fn, mm, vv, gs=gs, off=off, block=block, **kw):
                    fn(mm, vv, gs, off, block=block, **base, **kw)
                kern, plain = (fused_step.arena_fold_slice,
                               fused_step.arena_fold_slice_ref)
            mk, vk, mr, vr = _clone(m), _clone(v), _clone(m), _clone(v)
            run(kern, mk, vk, guard=vec)
            run(plain, mr, vr, guard=vec)
            torch.cuda.synchronize()
            err = _compare_bits(torch, name, f"guarded {pair} {label}",
                                [(mk, mr), (vk, vr)])
            del mk, vk, mr, vr
            mk, vk, mu, vu = _clone(m), _clone(v), _clone(m), _clone(v)
            run(kern, mk, vk, guard=vec8)
            run(kern, mu, vu, scale=0.125)
            torch.cuda.synchronize()
            _compare_bits(torch, name, f"guarded {pair} {label} at f32(1/8) "
                          "vs unguarded", [(mk, mu), (vk, vu)])
            del mk, vk, mu, vu
            n = n_rows * LANES
            t_u1 = timed_ms(torch, lambda: run(kern, m, v, scale=0.125),
                            runs=WIRE_TIMED_RUNS, reps=KERNEL_REPS)
            t_g1 = timed_ms(torch, lambda: run(kern, m, v, guard=vec),
                            runs=WIRE_TIMED_RUNS, reps=KERNEL_REPS)
            t_g2 = timed_ms(torch, lambda: run(kern, m, v, guard=vec),
                            runs=WIRE_TIMED_RUNS, reps=KERNEL_REPS)
            t_u2 = timed_ms(torch, lambda: run(kern, m, v, scale=0.125),
                            runs=WIRE_TIMED_RUNS, reps=KERNEL_REPS)
            entry = _kernel_entry(
                name, f"guarded {pair} {label}", statistics.median(
                    [t_g1, t_g2]),
                timed_ms(torch, lambda: run(plain, m, v, guard=vec),
                         runs=CODEC_PLAIN_RUNS, warmup=1),
                # the unguarded form's bytes and the vector's 16
                bound_ms(4 * n + 2 * _codec_bytes(m_codec, v_codec, n_rows)
                         + 16, ops * n),
                {"pair": pair, "rows": n_rows, "row_offset": off,
                 "max_abs_err": err},
                logged={"unguarded_ms_in_turns": [t_u1, t_u2],
                        "guarded_ms_in_turns": [t_g1, t_g2]})
            entry.update(unguarded_ms=statistics.median([t_u1, t_u2]),
                         guarded_over_unguarded=statistics.median(
                             [t_g1, t_g2]) / statistics.median([t_u1, t_u2]))
            out[name].setdefault(pair, []).append(entry)
        akw = dict(lr=1e-3, bc1=0.19, bc2=0.001999, eps=1e-8, **codecs)
        ok1 = torch.ones(1, device="cuda")
        pk, pr, pu = p.clone(), p.clone(), p.clone()
        fused_step.arena_apply(pk, m, v, guard=ok1, **akw)
        fused_step.arena_apply_ref(pr, m, v, guard=ok1, **akw)
        fused_step.arena_apply(pu, m, v, **akw)
        torch.cuda.synchronize()
        err = _compare_bits(torch, "arena_apply", f"guarded {pair}",
                            [(pk, pr), (pk, pu)])
        del pk, pr, pu
        n = rows * LANES
        apply_ops = _DECODE_OPS[m_codec] + _DECODE_OPS[v_codec] + 7
        t = [timed_ms(torch, lambda g_=gd: fused_step.arena_apply(
                 p, m, v, guard=g_, **akw), runs=WIRE_TIMED_RUNS,
                 reps=KERNEL_REPS)
             for gd in (None, ok1, ok1, None)]
        entry = _kernel_entry(
            "arena_apply", f"guarded {pair} whole arena",
            statistics.median(t[1:3]),
            timed_ms(torch, lambda: fused_step.arena_apply_ref(
                p, m, v, guard=ok1, **akw), runs=CODEC_PLAIN_RUNS, warmup=1),
            bound_ms(8 * n + _codec_bytes(m_codec, v_codec, rows) + 4,
                     apply_ops * n),
            {"pair": pair, "rows": rows, "max_abs_err": err},
            logged={"unguarded_ms_in_turns": [t[0], t[3]],
                    "guarded_ms_in_turns": t[1:3]})
        entry.update(unguarded_ms=statistics.median([t[0], t[3]]),
                     guarded_over_unguarded=statistics.median(t[1:3])
                     / statistics.median([t[0], t[3]]))
        out["arena_apply"][pair] = [entry]
        for x in (*_cols(m), *_cols(v), p):
            if x.is_floating_point() and not torch.isfinite(x).all():
                raise AssertionError(f"guarded {pair}: non-finite state or "
                                     f"params after the timed runs")
        del m, v
    del p
    torch.cuda.empty_cache()
    fin = _time_finite_and(torch, fused_step, g, layout)
    del g
    torch.cuda.empty_cache()
    return out, fin


PROFILE_FLAG = "--profile-kernels"
# the child's exit code when a session's records fell short: the parent
# starts a fresh process at that case
PROFILE_SHORT = 3


def _profile_cases(torch, fused_step, fp8_wire):
    """The calls counted in a fresh process (profile_child), in order:
    (group, key, label, make, want), where make() sets up the case's state
    on the card and returns the call to profile, and want is {kernel base
    name: count}. Each case draws its data from its own seed, so a case
    gives the same inputs whichever case a process starts at."""
    rows = MAIN["bert_large"]["arena_rows"]

    def gen_of(seed):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        return gen

    def slab():
        return torch.randn((rows, LANES), generator=gen_of(24),
                           device="cuda")

    def fp8_inputs():
        g = slab()
        ef = torch.randn((rows, LANES), generator=gen_of(25),
                         device="cuda") * 1e-5
        s = torch.tensor([2.0 ** 15], device="cuda")
        ok = torch.ones(1, device="cuda")
        q, gs = fp8_wire.fp8_encode(g, ef=ef.clone(), scale=s, ok=ok)
        return g, ef, s, ok, q, gs

    def fold_kernel(v_codec):
        return ("rowcol_fold_kernel" if v_codec == "rowcol"
                else "arena_fold_kernel")
    cases = []
    for m_codec, v_codec in GUARD_TIMED_PAIRS:
        def make(m_codec=m_codec, v_codec=v_codec):
            g, vec = slab(), _guard_vec(torch, None, True)
            if m_codec == "int8":
                m = (torch.zeros((rows, LANES), dtype=torch.int8,
                                 device="cuda"),
                     torch.zeros((rows, 1), device="cuda"))
                v = (torch.zeros((rows, 1), device="cuda"),
                     torch.zeros((1, LANES), device="cuda"))
            else:
                m, v = (torch.zeros((rows, LANES), device="cuda")
                        for _ in range(2))

            def guarded_fold():
                fused_step.finite_and(g, vec[2:3])
                fused_step.arena_fold(m, v, g, beta1=0.9, beta2=0.999,
                                      guard=vec, m_codec=m_codec,
                                      v_codec=v_codec)
            return guarded_fold
        cases.append(("guard_kernels", f"{m_codec}/{v_codec}",
                      f"finite_and + guarded fold {m_codec}/{v_codec}", make,
                      {"finite_and_kernel": 1, fold_kernel(v_codec): 1}))

    def make_encode():
        g, ef, s, ok, _, _ = fp8_inputs()
        return lambda: fp8_wire.fp8_encode(g, ef=ef, scale=s, ok=ok)

    def make_update():
        g, ef, s, ok, q, gs = fp8_inputs()
        return lambda: fp8_wire.fp8_ef_update(ef, g, q, gs, scale=s, ok=ok)
    cases += [("fp8_kernels", "fp8_encode", "fp8_encode", make_encode,
               {"fp8_encode_kernel": 1}),
              ("fp8_kernels", "fp8_ef_update", "fp8_ef_update", make_update,
               {"fp8_ef_update_kernel": 1})]
    for i, (m_codec, v_codec) in enumerate(FP8_TIMED_PAIRS):
        def make(m_codec=m_codec, v_codec=v_codec, seed=26 + i):
            _, _, _, _, q, gs = fp8_inputs()
            m, v = _wire_state(torch, gen_of(seed), m_codec, v_codec, rows)
            return lambda: fused_step.arena_fold(
                m, v, q, beta1=0.9, beta2=0.999, scale=0.125, grad_scale=gs,
                m_codec=m_codec, v_codec=v_codec)
        cases.append(("fp8_kernels", f"arena_fold e4m3 {m_codec}/{v_codec}",
                      f"e4m3 fold {m_codec}/{v_codec}", make,
                      {fold_kernel(v_codec): 1}))
    return cases


def profile_child(torch, fused_step, fp8_wire, start):
    """(Run by child_kernels_per_call in a fresh process.) From case
    `start` of _profile_cases on, the device kernels of one call of each,
    at the bert-large arena's rows, one torch.profiler session a case; a
    JSON line for each case that ran what it should. A session short of
    records ends the process with PROFILE_SHORT after its line: on the
    H100, a process whose sessions had begun to come back empty went on
    returning none (three sessions in a row, in a child that had run two
    full ones), while the first session of a process has always been
    whole."""
    for i, (group, key, label, make, want) in enumerate(
            _profile_cases(torch, fused_step, fp8_wire)):
        if i < start:
            continue
        fn = make()
        found = profile_kernels(torch, fn)
        del fn
        torch.cuda.empty_cache()
        got = {}
        for name, (n, _) in found.items():
            got[name.split("<")[0]] = got.get(name.split("<")[0], 0) + n
        print(json.dumps({"profile_case": i, "group": group, "key": key,
                          "label": label, "kernels": found,
                          "ok": got == want, "want": want}), flush=True)
        if got != want:
            return PROFILE_SHORT
    return 0


def child_kernels_per_call():
    """finite_and + one guarded fold run two device kernels (the guard adds
    none to the fold), and fp8_encode, fp8_ef_update and an e4m3 fold one
    each, counted by torch.profiler in fresh processes (profile_child): a
    case whose session falls short is run again at the start of a new
    process, up to PROFILE_ATTEMPTS processes for the case. Returns
    ({pair: {kernel: device ms}}, {call: {kernel: device ms}})."""
    out = {"guard_kernels": {}, "fp8_kernels": {}}
    attempts = {}
    start = 0
    while True:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               PROFILE_FLAG, str(start)], capture_output=True,
                              text=True, timeout=600)
        lines = [json.loads(x) for x in proc.stdout.splitlines()
                 if x.startswith('{"profile_case"')]
        for case in lines:
            i = case["profile_case"]
            attempts[i] = attempts.get(i, 0) + 1
            log(json.dumps({"phase": "kernel", "case": f"{case['label']}: "
                            "device kernels of one call, torch.profiler",
                            "kernels": case["kernels"],
                            "attempts": attempts[i]}))
            if case["ok"]:
                out[case["group"]][case["key"]] = {
                    name: ms for name, (_, ms) in case["kernels"].items()}
        if proc.returncode == 0:
            return out["guard_kernels"], out["fp8_kernels"]
        last = lines[-1] if lines else None
        if (proc.returncode != PROFILE_SHORT or last is None or last["ok"]
                or attempts[last["profile_case"]] >= PROFILE_ATTEMPTS):
            raise AssertionError(
                f"the profiler check failed (exit {proc.returncode}"
                + (f"; {last['label']} ran the device kernels "
                   f"{last['kernels']}, expected {last['want']}, in "
                   f"{attempts[last['profile_case']]} processes"
                   if last and not last["ok"] else "")
                + f"):\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        start = last["profile_case"]


# finite_and's slabs: the stablelm-1.6b arena (its first), a layer's and the
# rest region's rows of it, and the bert-large arena's rows
def _time_finite_and(torch, fused_step, g, layout):
    """finite_and against its plain version and timed beside the two
    PyTorch calls of the same function (torch.isfinite(x).all(), which
    allocates a bool the size of x, and torch.isfinite(torch.aminmax(x))),
    at each slab: each returns the same verdict, clean and with a NaN."""
    spec, rest = layout.stack("blocks"), layout.rest
    slabs = {"stablelm arena slab": layout.rows,
             "stablelm layer slab": spec.layer_rows,
             "stablelm rest slab": rest.rows,
             "bert-large arena slab": MAIN["bert_large"]["arena_rows"]}
    ok = torch.ones(1, device="cuda")

    def library_aminmax(x):
        return torch.isfinite(torch.stack(torch.aminmax(x))).all()
    entries = []
    for label, n_rows in slabs.items():
        x = g[:n_rows]
        for poison in (False, True):
            if poison:
                x[n_rows // 3, 5] = float("nan")
            ok.fill_(1.0)
            okr = torch.ones(1, device="cuda")
            fused_step.finite_and(x, ok)
            fused_step.finite_and_ref(x, okr)
            want = bool(torch.isfinite(x).all())
            if (ok.item() != okr.item() or bool(ok.item()) != want
                    or bool(library_aminmax(x)) != want):
                raise AssertionError(f"finite_and {label} nan={poison}: "
                                     f"{ok.item()}, plain {okr.item()}, "
                                     f"library {want}")
        x[n_rows // 3, 5] = 0.0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        for _ in range(3):
            fused_step.finite_and(x, ok)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - before
        t_isfinite = timed_ms(torch, lambda: torch.isfinite(x).all(),
                              reps=KERNEL_REPS)
        t_aminmax = timed_ms(torch, lambda: library_aminmax(x),
                             reps=KERNEL_REPS)
        entry = _kernel_entry(
            "finite_and", label,
            timed_ms(torch, lambda: fused_step.finite_and(x, ok),
                     reps=KERNEL_REPS),
            timed_ms(torch, lambda: fused_step.finite_and_ref(x, ok),
                     runs=PLAIN_TIMED_RUNS, warmup=1),
            # x read once; the flag's 4 bytes; one comparison per element
            bound_ms(4 * n_rows * LANES + 4, n_rows * LANES),
            {"rows": n_rows, "dtype": "float32", "max_abs_err": 0.0},
            logged={"library_calls": {"torch.isfinite(x).all()": t_isfinite,
                                      "torch.isfinite(torch.aminmax(x))":
                                          t_aminmax}})
        if extra:
            raise AssertionError(f"finite_and {label} allocated {extra} B")
        entry.update(library_ms=t_isfinite, library_ms_aminmax=t_aminmax,
                     extra_bytes=extra)
        entries.append(entry)
    return dict({k: x for k, x in entries[0].items() if k != "case"},
                by_case=entries)


def _kernels_of_calls(torch, calls):
    """The device kernels each of `calls` ((case, form, fn)) runs, from
    one torch.profiler session over one call of each: every call must run
    exactly one kernel, its form's (rowcol's fold makes its ordered pass
    over the ranges' sums in the same launch; the memset of its ticket is
    no kernel). A session whose records differ from that is run again, up
    to PROFILE_ATTEMPTS times, and the attempts and each kernel's device ms
    are logged. Returns {case: kernels per call}."""
    want = {}
    for _, form, _ in calls:
        want[_RC_KERNELS[form]] = want.get(_RC_KERNELS[form], 0) + 1
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        found = profile_kernels(torch, lambda: [fn() for _, _, fn in calls])
        got = {}
        for name, (n, _) in found.items():
            base = name.split("<")[0]
            got[base] = got.get(base, 0) + n
        if got == want:
            break
    log(json.dumps({"phase": "kernel", "case": "rowcol forms: device "
                    "kernels of one call each, torch.profiler",
                    "calls": [c for c, _, _ in calls], "kernels": found,
                    "attempts": attempt}))
    if got != want:
        raise AssertionError(f"the rowcol calls {[c for c, _, _ in calls]} "
                             f"ran the device kernels {found}; expected "
                             f"{want}, one per call")
    return {case: 1 for case, _, _ in calls}


# ---------------------------------------------------------------------------
# The bf16 gradient wire
# ---------------------------------------------------------------------------


def _wire_cases(torch, rows, b1, b2):
    """The calls each pair runs on the bf16 or the e4m3 wire: (form, label,
    guarded ok or None, call(fn, state, slab, scales=None)) for the
    whole-arena fold (with the decay at scale 1, and at scale 0.25), the
    slice fold of rows [lo, hi) (decay, scale 1/8) and both guarded at the
    traced scale, ok = 1 and ok = 0; `scales`, the e4m3 slab's scale
    column, goes in as grad_scale (its rows taken as the slab's are)."""
    block = 8
    lo, hi = block * (rows // (4 * block)), block * (3 * rows // (4 * block))

    def gs(scales, rows_of=lambda x: x):
        return {} if scales is None else {"grad_scale": rows_of(scales)}

    def flipped(x):
        return x[:hi - lo].flip(0).contiguous()

    def fold(**kw):
        return lambda fn, st, gg, scales=None: fn(*st, gg, **gs(scales),
                                                  **kw)

    def slice_fold(**kw):
        return lambda fn, st, gg, scales=None: fn(
            *st, flipped(gg), lo, block=block, **gs(scales, flipped), **kw)
    cases = [("arena_fold", "decay, scale 1", None,
              fold(scale=1.0, decay=(b1, b2))),
             ("arena_fold", "scale 0.25", None, fold(scale=0.25)),
             ("arena_fold_slice", f"rows [{lo}, {hi}) decay, scale 1/8",
              None, slice_fold(scale=0.125, decay=(b1, b2)))]
    for ok in (True, False):
        cases.append(("arena_fold", f"guarded ok={int(ok)}", ok, fold(
            guard=_guard_vec(torch, (b1, b2), ok))))
        cases.append(("arena_fold_slice", f"rows [{lo}, {hi}) guarded "
                      f"ok={int(ok)}", ok, slice_fold(
                          guard=_guard_vec(torch, None, ok))))
    return cases


def _check_wire_arena(torch, fused_step, adama_accum, m_codec, v_codec,
                      rows, seed, checked):
    """A pair's folds of a bf16 slab (`_wire_cases`) on an arena of `rows`
    rows with the edge rows, each from the same state: the kernel against
    its plain version bit for bit, and against the fp32-wire kernel fed the
    same slab upcast outside the kernel, bit for bit (the reference's
    test_in_kernel_upcast_bitwise_vs_preupcast_reference, on the card);
    ok = 0 (the slab holding a NaN) writes nothing."""
    pair = f"{m_codec}/{v_codec}"
    b1, b2 = 0.9, 0.999
    m, v, g, _ = _edge_arenas(torch, rows, seed)
    g16 = g.to(torch.bfloat16)
    bad16 = g16.clone()
    bad16[rows // 2, 7] = float("nan")
    mk, vk = _encode(adama_accum, "m", m_codec, m), \
        _encode(adama_accum, "v", v_codec, v)
    kw = dict(beta1=b1, beta2=b2, m_codec=m_codec, v_codec=v_codec)
    fns = {"arena_fold": (fused_step.arena_fold, fused_step.arena_fold_ref),
           "arena_fold_slice": (fused_step.arena_fold_slice,
                                fused_step.arena_fold_slice_ref)}
    for name, label, ok, call in _wire_cases(torch, rows, b1, b2):
        kern, plain = fns[name]
        slab = g16 if ok is not False else bad16
        sk, sr, su = ((_clone(mk), _clone(vk)) for _ in range(3))
        call(functools.partial(kern, grad_dtype=torch.bfloat16, **kw), sk,
             slab)
        call(functools.partial(plain, **kw), sr, slab)
        call(functools.partial(kern, **kw), su, slab.float())
        torch.cuda.synchronize()
        _compare_bits(torch, name, f"bf16 {pair} {rows} rows {label}",
                      list(zip(sk, sr)))
        _compare_bits(torch, name, f"bf16 {pair} {rows} rows {label} vs the "
                      "fp32 wire on the upcast slab", list(zip(sk, su)))
        if ok is False and not all(_bits_equal(torch, x, y)
                                   for x, y in zip(sk, (mk, vk))):
            raise AssertionError(f"{name} bf16 {pair} {label}: ok = 0 "
                                 f"changed the state")
        checked.append((name, pair, f"{rows} rows {label}"))


def check_wire_small(torch, fused_step, adama_accum):
    """Phase 3, the bf16 wire: every (m, v) pair on the 64-row edge arena,
    the rowcol pairs also on RC_RANGE_ROWS rows (`_check_wire_arena`).
    Returns the checked cases."""
    from repro_torch.core import state_store
    checked = []
    for m_codec, v_codec in state_store.registered_combinations():
        _check_wire_arena(torch, fused_step, adama_accum, m_codec, v_codec,
                          CODEC_SMALL_ROWS, 31, checked)
        if v_codec == "rowcol":
            _check_wire_arena(torch, fused_step, adama_accum, m_codec,
                              v_codec, RC_RANGE_ROWS, 32, checked)
    log(json.dumps({"phase": "kernel", "case": "bf16 wire: every pair's "
                    "folds and slice folds, unguarded and guarded (ok = 1 "
                    "at f32(1/8)/f32(3), ok = 0), on the 64-row edge arena "
                    f"(rowcol also at {RC_RANGE_ROWS} rows), bit for bit "
                    "against the plain versions and against the fp32-wire "
                    "kernels on the upcast slab", "checked": len(checked)}))
    return checked


# the pairs whose bf16-wire folds are timed at the stablelm-1.6b arena
WIRE_TIMED_PAIRS = (FP32, ("int8", "int8"), ("int8", "rowcol"))
# CUDA-event-timed runs (of KERNEL_REPS launches each) per figure of the
# stablelm-arena phases (codec, guarded, wire and master forms), which
# time many cases, most in turns four times over: their runs spread by
# under 0.1% on an H100, and TIMED_RUNS' 25 cost up to a minute a phase
WIRE_TIMED_RUNS = 8


def _wire_state(torch, gen, m_codec, v_codec, rows):
    """Random (m, v) state of a pair over `rows` rows on the card."""
    def col(scale, n=rows, width=1):
        return torch.rand((n, width), generator=gen, device="cuda") * scale
    if m_codec == "int8":
        m = (torch.randint(-127, 128, (rows, LANES), generator=gen,
                           device="cuda", dtype=torch.int8), col(1e-5))
    else:
        m = torch.randn((rows, LANES), generator=gen, device="cuda") * 1e-3
    if v_codec == "int8":
        v = (torch.randint(0, 128, (rows, LANES), generator=gen,
                           device="cuda", dtype=torch.int8), col(1e-8))
    elif v_codec == "rowcol":
        v = (col(1e-3), col(1.0, 1, LANES))
    else:
        v = (torch.randn((rows, LANES), generator=gen, device="cuda")
             * 1e-6).abs()
    return m, v


def check_wire_timed(torch, fused_step, layout):
    """Phase 3, the bf16 wire at the full stablelm-1.6b arena: for each of
    WIRE_TIMED_PAIRS, the fold, a layer slice and the rest slice of a bf16
    slab, once on clones of the same state against the plain version and
    against the fp32-wire kernel on the upcast slab (every column of the
    arena bit for bit), then timed in turns beside the fp32-wire kernel
    (fp32, bf16, bf16, fp32) against the bound a 2-byte g gives; then
    finite_and on the bf16 slab. Returns ({kernel: {pair: [entry per
    case]}}, finite_and's bf16 entry)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(33)
    rows = layout.rows
    spec, rest = layout.stack("blocks"), layout.rest
    g16 = torch.randn((rows, LANES), generator=gen,
                      device="cuda").to(torch.bfloat16)
    gup = g16.float()
    out = {"arena_fold": {}, "arena_fold_slice": {}}
    for m_codec, v_codec in WIRE_TIMED_PAIRS:
        pair = f"{m_codec}/{v_codec}"
        m, v = _wire_state(torch, gen, m_codec, v_codec, rows)
        kw = dict(beta1=0.9, beta2=0.999, scale=1.0 / 8, m_codec=m_codec,
                  v_codec=v_codec)
        ops = 2 + _FOLD_OPS[m_codec] + _FOLD_OPS[v_codec]
        cases = [("arena_fold", "whole arena", rows, 0, None),
                 ("arena_fold_slice", "layer 0", spec.layer_rows, spec.row,
                  layout.slice_block(spec)),
                 ("arena_fold_slice", "rest", rest.rows, rest.row,
                  layout.slice_block(rest))]
        for name, label, n_rows, off, block in cases:
            if name == "arena_fold":
                def run(fn, mm, vv, gg, n_rows=n_rows):
                    fn(mm, vv, gg[:n_rows], **kw)
                kern, plain = fused_step.arena_fold, fused_step.arena_fold_ref
            else:
                def run(fn, mm, vv, gg, n_rows=n_rows, off=off, block=block):
                    fn(mm, vv, gg[:n_rows], off, block=block, **kw)
                kern, plain = (fused_step.arena_fold_slice,
                               fused_step.arena_fold_slice_ref)
            mk, vk, mr, vr = _clone(m), _clone(v), _clone(m), _clone(v)
            run(kern, mk, vk, g16)
            run(plain, mr, vr, g16)
            torch.cuda.synchronize()
            err = _compare_bits(torch, name, f"bf16 {pair} {label}",
                                [(mk, mr), (vk, vr)])
            del mr, vr
            mu, vu = _clone(m), _clone(v)
            run(kern, mu, vu, gup)
            torch.cuda.synchronize()
            _compare_bits(torch, name, f"bf16 {pair} {label} vs the fp32 "
                          "wire on the upcast slab", [(mk, mu), (vk, vu)])
            del mk, vk, mu, vu
            n = n_rows * LANES
            t = [timed_ms(torch, lambda gg=gg: run(kern, m, v, gg),
                          runs=WIRE_TIMED_RUNS, reps=KERNEL_REPS)
                 for gg in (gup, g16, g16, gup)]
            state_bytes = 2 * _codec_bytes(m_codec, v_codec, n_rows)
            entry = _kernel_entry(
                name, f"bf16 {pair} {label}", statistics.median(t[1:3]),
                timed_ms(torch, lambda: run(plain, m, v, g16),
                         runs=CODEC_PLAIN_RUNS, warmup=1),
                # g read once at 2 B; the slice's state read and written
                bound_ms(2 * n + state_bytes, ops * n),
                {"pair": pair, "wire": "bf16", "rows": n_rows,
                 "row_offset": off, "max_abs_err": err},
                logged={"fp32_wire_ms_in_turns": [t[0], t[3]],
                        "bf16_ms_in_turns": t[1:3]})
            fp32_ms = statistics.median([t[0], t[3]])
            entry.update(fp32_wire_ms=fp32_ms,
                         fp32_wire_bound_ms=bound_ms(4 * n + state_bytes,
                                                     ops * n)[0],
                         bf16_over_fp32_wire=entry["ms"] / fp32_ms)
            if name == "arena_fold":
                entry.update(_time_guarded_bf16(torch, kern, plain, m, v,
                                                g16, kw, pair))
            out[name].setdefault(pair, []).append(entry)
        for x in (*_cols(m), *_cols(v)):
            if x.is_floating_point() and not torch.isfinite(x).all():
                raise AssertionError(f"bf16 {pair}: non-finite state after "
                                     f"the timed runs")
        del m, v
    del gup
    torch.cuda.empty_cache()
    fin = _time_finite_and_bf16(torch, fused_step, g16)
    del g16
    torch.cuda.empty_cache()
    return out, fin


def _time_guarded_bf16(torch, kern, plain, m, v, g16, kw, pair):
    """The guarded whole-arena fold of the bf16 slab (ok = 1, the traced
    scale) against its plain version bit for bit, timed in turns beside
    the unguarded one (unguarded, guarded, guarded, unguarded)."""
    vec = _guard_vec(torch, None, True)
    base = {k: x for k, x in kw.items() if k not in ("scale",)}
    mk, vk, mr, vr = _clone(m), _clone(v), _clone(m), _clone(v)
    kern(mk, vk, g16, guard=vec, **base)
    plain(mr, vr, g16, guard=vec, **base)
    torch.cuda.synchronize()
    _compare_bits(torch, "arena_fold", f"guarded bf16 {pair} whole arena",
                  [(mk, mr), (vk, vr)])
    del mk, vk, mr, vr
    t = [timed_ms(torch, lambda gd=gd: kern(m, v, g16, **gd, **base),
                  runs=WIRE_TIMED_RUNS, reps=KERNEL_REPS)
         for gd in ({"scale": kw["scale"]}, {"guard": vec}, {"guard": vec},
                    {"scale": kw["scale"]})]
    log(json.dumps({"phase": "kernel", "name": "arena_fold",
                    "case": f"guarded bf16 {pair} whole arena",
                    "unguarded_ms_in_turns": [t[0], t[3]],
                    "guarded_ms_in_turns": t[1:3]}))
    return {"guarded_ms": statistics.median(t[1:3]),
            "guarded_over_unguarded": statistics.median(t[1:3])
            / statistics.median([t[0], t[3]])}


def _time_finite_and_bf16(torch, fused_step, x):
    """finite_and on the stablelm arena's bf16 slab: the same verdict as
    its plain version and torch.isfinite(x).all(), clean and with a NaN;
    timed beside that call; allocates nothing."""
    n = x.numel()
    ok, okr = torch.ones(1, device="cuda"), torch.ones(1, device="cuda")
    for poison in (False, True):
        if poison:
            x[x.shape[0] // 3, 5] = float("nan")
        ok.fill_(1.0)
        okr.fill_(1.0)
        fused_step.finite_and(x, ok)
        fused_step.finite_and_ref(x, okr)
        want = bool(torch.isfinite(x).all())
        if ok.item() != okr.item() or bool(ok.item()) != want:
            raise AssertionError(f"finite_and bf16 nan={poison}: "
                                 f"{ok.item()}, plain {okr.item()}, "
                                 f"library {want}")
    x[x.shape[0] // 3, 5] = 0.0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    fused_step.finite_and(x, ok)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - before
    if extra:
        raise AssertionError(f"finite_and bf16 allocated {extra} B")
    t_lib = timed_ms(torch, lambda: torch.isfinite(x).all(),
                     reps=KERNEL_REPS)
    entry = _kernel_entry(
        "finite_and", "stablelm arena slab, bf16",
        timed_ms(torch, lambda: fused_step.finite_and(x, ok),
                 reps=KERNEL_REPS),
        timed_ms(torch, lambda: fused_step.finite_and_ref(x, ok),
                 runs=PLAIN_TIMED_RUNS, warmup=1),
        # x read once at 2 B; the flag's 4 bytes; one test per element
        bound_ms(2 * n + 4, n),
        {"rows": x.shape[0], "dtype": "bfloat16", "max_abs_err": 0.0},
        logged={"library_calls": {"torch.isfinite(x).all()": t_lib}})
    entry.update(library_ms=t_lib, extra_bytes=extra)
    return entry


def _wire_forms(name, checked, timed, counts, wire="bf16", paths=WIRE):
    """The `kernels` line's forms of one fold kernel on a narrower wire
    (bf16: WIRE's paths; e4m3: FP8's): the pairs and cases checked bit for
    bit on the small arenas; the timed pairs' numbers at the stablelm arena
    beside the wider wire's; the launches of the wire's main paths."""
    return {"wire": wire,
            "bitwise_pairs": sorted({pr for k, pr, _ in checked
                                     if k == name}),
            "bitwise_cases": sum(k == name for k, _, _ in checked),
            "timed": [dict({k: x for k, x in entries[0].items()
                            if k != "case"}, pair=pair, library_ms=None,
                           by_case=entries)
                      for pair, entries in timed.items()],
            "launches_by_wire_path": {p: counts[p][name]
                                      for p in paths if p in counts}}


# ---------------------------------------------------------------------------
# The master form of the apply (master params, bf16 working params)
# ---------------------------------------------------------------------------


def _edge_p(torch):
    """float32 values at bf16's rounding edges, both signs: exact ties (low
    half 0x8000) on even and odd bf16 mantissas, one ulp either side of a
    tie, carries into the exponent, values that round past bf16's largest
    finite value, the largest finite bf16, subnormals and zeros
    (tests/test_torch_master.py's)."""
    bits = []
    for hi in (0x3F80, 0x3F81, 0x3C23, 0x3C24, 0x3FFF, 0x3C7F, 0x7F7F):
        bits += [(hi << 16) | lo for lo in (0x8000, 0x7FFF, 0x8001, 0x0000,
                                            0xFFFF)]
    bits += [0x7F7FFFFF, 0x7F7F0000, 0x00000000, 0x00008000, 0x00408000,
             0x00018000, 0x00000001, 0x007FFFFF]
    bits += [b | 0x80000000 for b in bits]
    return torch.tensor([b - (1 << 32) if b >= 1 << 31 else b for b in bits],
                        dtype=torch.int32, device="cuda").view(torch.float32)


# the master form's cases: (label, guarded ok or None, bc1)
MASTER_FORMS = (("unguarded", None, 0.19), ("ok=1", True, 0.19),
                ("ok=0, bc1=0", False, 0.0))


def _check_master_arena(torch, fused_step, adama_accum, m_codec, v_codec,
                        rows, seed, checked):
    """A pair's master-form apply on an arena of `rows` rows with the edge
    rows, p's row 0 (where m = v = 0, so the update is 0) holding
    `_edge_p`: each form of MASTER_FORMS with weight decay 0 and 0.01, the
    master against the plain-form kernel's p and the plain version's p,
    the work against torch's cast of the master on the card and the plain
    version's work, bit for bit; with ok = 0 the master keeps every byte
    and the work is bf16 of it."""
    pair = f"{m_codec}/{v_codec}"
    m, v, _, p = _edge_arenas(torch, rows, seed)
    edge = _edge_p(torch)
    p[0, :edge.numel()] = edge
    mk, vk = _encode(adama_accum, "m", m_codec, m), \
        _encode(adama_accum, "v", v_codec, v)
    bf16 = torch.bfloat16
    for label, ok, bc1 in MASTER_FORMS:
        for wd in (0.0, 0.01):
            guard = ({} if ok is None else dict(guard=torch.tensor(
                [1.0 if ok else 0.0], device="cuda")))
            kw = dict(lr=1e-3, bc1=bc1, bc2=0.001999, eps=1e-8,
                      weight_decay=wd, m_codec=m_codec, v_codec=v_codec,
                      **guard)
            pk, pp, pr = p.clone(), p.clone(), p.clone()
            _, wk = fused_step.arena_apply(pk, mk, vk, work_dtype=bf16, **kw)
            fused_step.arena_apply(pp, mk, vk, **kw)
            _, wr = fused_step.arena_apply_ref(pr, mk, vk, work_dtype=bf16,
                                               **kw)
            torch.cuda.synchronize()
            case = f"{pair} {rows} rows {label} wd={wd}"
            _compare_bits(torch, "arena_apply master", case,
                          [(pk, pp), (pk, pr), (wk, pk.to(bf16)), (wk, wr)])
            if ok is False and not (_bits_equal(torch, pk, p) and
                                    _bits_equal(torch, wk, p.to(bf16))):
                raise AssertionError(f"arena_apply master {case}: ok = 0 "
                                     f"changed the master or its work is "
                                     f"not bf16 of it")
            checked.append(("arena_apply", pair, case))


def check_master_small(torch, fused_step, adama_accum):
    """Phase 3, the master form of arena_apply: every (m, v) pair on the
    64-row edge arena, the rowcol pairs also on RC_RANGE_ROWS rows
    (`_check_master_arena`). Returns the checked cases."""
    from repro_torch.core import state_store
    checked = []
    for m_codec, v_codec in state_store.registered_combinations():
        _check_master_arena(torch, fused_step, adama_accum, m_codec, v_codec,
                            CODEC_SMALL_ROWS, 41, checked)
        if v_codec == "rowcol":
            _check_master_arena(torch, fused_step, adama_accum, m_codec,
                                v_codec, RC_RANGE_ROWS, 42, checked)
    log(json.dumps({"phase": "kernel", "case": "master form of arena_apply "
                    "(bf16 work): every pair, unguarded, ok = 1 and ok = 0 "
                    "at bc1 = 0, weight decay 0 and 0.01, on the 64-row edge "
                    f"arena (rowcol also at {RC_RANGE_ROWS} rows) with bf16 "
                    "rounding edges in p, bit for bit against the plain-form "
                    "kernel, torch's cast and the plain version",
                    "checked": len(checked)}))
    return checked


# the pairs whose master form is timed at the stablelm-1.6b arena
MASTER_TIMED_PAIRS = (FP32, ("int8", "rowcol"))


def check_master_timed(torch, fused_step, layout):
    """Phase 3, the master form at the full stablelm-1.6b arena: for each of
    MASTER_TIMED_PAIRS, the master-form apply against the plain-form kernel
    (p) and the plain version (p and work), and its work against torch's
    cast of its master, over the whole arena bit for bit; then timed in
    turns beside the plain-form apply (plain, master, master, plain), the
    work written into one buffer, against the bound of 2 more bytes an
    element. Returns {pair: entry}."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(43)
    rows = layout.rows
    bf16 = torch.bfloat16
    p = torch.randn((rows, LANES), generator=gen, device="cuda") * 0.02
    work = torch.empty((rows, LANES), dtype=bf16, device="cuda")
    out = {}
    for m_codec, v_codec in MASTER_TIMED_PAIRS:
        pair = f"{m_codec}/{v_codec}"
        m, v = _wire_state(torch, gen, m_codec, v_codec, rows)
        kw = dict(lr=1e-3, bc1=0.19, bc2=0.001999, eps=1e-8,
                  m_codec=m_codec, v_codec=v_codec)
        pk, pp = p.clone(), p.clone()
        fused_step.arena_apply(pk, m, v, work_dtype=bf16, work=work, **kw)
        fused_step.arena_apply(pp, m, v, **kw)
        torch.cuda.synchronize()
        err = _compare_bits(torch, "arena_apply master", f"{pair} whole "
                            "arena vs plain form", [(pk, pp)])
        del pp
        for lo in range(0, rows, 1 << 16):
            _compare_bits(torch, "arena_apply master", f"{pair} work vs "
                          "torch's cast", [(work[lo:lo + (1 << 16)],
                                            pk[lo:lo + (1 << 16)].to(bf16))])
        pr = p.clone()
        _, wr = fused_step.arena_apply_ref(pr, m, v, work_dtype=bf16, **kw)
        torch.cuda.synchronize()
        _compare_bits(torch, "arena_apply master", f"{pair} whole arena vs "
                      "the plain version", [(pk, pr), (work, wr)])
        del pk, pr, wr
        n = rows * LANES
        apply_ops = _DECODE_OPS[m_codec] + _DECODE_OPS[v_codec] + 7
        master = dict(work_dtype=bf16, work=work)
        t = [timed_ms(torch, lambda wd=wd: fused_step.arena_apply(
                 p, m, v, **wd, **kw), runs=WIRE_TIMED_RUNS,
                 reps=KERNEL_REPS)
             for wd in ({}, master, master, {})]
        plain_bytes = 8 * n + _codec_bytes(m_codec, v_codec, rows)
        entry = _kernel_entry(
            "arena_apply", f"master {pair} whole arena",
            statistics.median(t[1:3]),
            timed_ms(torch, lambda: fused_step.arena_apply_ref(
                p, m, v, work_dtype=bf16, work=work, **kw),
                runs=CODEC_PLAIN_RUNS, warmup=1),
            # p read and written, the state read, the bf16 work written
            bound_ms(plain_bytes + 2 * n, apply_ops * n),
            {"pair": pair, "rows": rows, "work_dtype": "bfloat16",
             "max_abs_err": err},
            logged={"plain_form_ms_in_turns": [t[0], t[3]],
                    "master_ms_in_turns": t[1:3]})
        plain_ms = statistics.median([t[0], t[3]])
        entry.update(plain_form_ms=plain_ms,
                     plain_form_bound_ms=bound_ms(plain_bytes,
                                                  apply_ops * n)[0],
                     master_over_plain_form=entry["ms"] / plain_ms)
        out[pair] = entry
        for x in (*_cols(m), *_cols(v), p):
            if x.is_floating_point() and not torch.isfinite(x).all():
                raise AssertionError(f"master {pair}: non-finite state or "
                                     f"master after the timed runs")
        del m, v
    del p, work
    torch.cuda.empty_cache()
    return out


def _master_forms(checked, timed, counts, transient):
    """The `kernels` line's master form of arena_apply: the pairs and cases
    checked bit for bit on the small arenas; the timed pairs' numbers at
    the stablelm arena beside the plain-form apply's; the launches of the
    master paths, and the bytes one apply allocates for its work on each
    (0 where the cache receives it)."""
    return {"work_dtype": "bfloat16",
            "bitwise_pairs": sorted({pr for k, pr, _ in checked
                                     if k == "arena_apply"}),
            "bitwise_cases": len(checked),
            "timed": [dict({k: x for k, x in e.items() if k != "case"},
                           library_ms=None, by_case=[e])
                      for e in timed.values()],
            "launches_by_master_path": {p: counts[p]["arena_apply"]
                                        for p in MASTER if p in counts},
            "work_bytes_allocated_per_apply": transient}


# ---------------------------------------------------------------------------
# The fp8 (e4m3) gradient wire
# ---------------------------------------------------------------------------

FP8_MAX = 448.0
# the residual's injection scales of the encode and update checks: none,
# the dynamic scaler's start, a static scale that is no power of two
FP8_SCALES = (1.0, 2.0 ** 15, 1000.0)


def _e4m3_row(torch):
    """A row of LANES float32 values at e4m3's rounding edges: 448 first
    (so that the row's scale is 448 * f32(1/448) = 1.0 exactly and x / s is
    x), then the midpoint of every two neighbouring finite e4m3 values (0
    and the least subnormal code included) and one float32 ulp either side
    of it, both signs; zeros after them."""
    v = torch.arange(0x7f, dtype=torch.uint8, device="cuda").view(
        torch.float8_e4m3fn).float()
    mid = (v[:-1] + v[1:]) / 2                  # exact: 4 significant bits
    pos = torch.cat([mid, torch.nextafter(mid, mid + 1.0),
                     torch.nextafter(mid, mid - 1.0)])
    row = torch.zeros(LANES, device="cuda")
    row[0] = FP8_MAX
    row[1:1 + 2 * pos.numel()] = torch.cat([pos, -pos])
    return row


def _fp8_slabs(torch, rows, seed):
    """A finite fp32 slab of `rows` rows and its copy with non-finite rows:
    rows 0-5 the codec edge rows of `_edge_arenas` (row 0 zero: scale 1.0),
    row 6 a row whose max is 1e-37 (its max / 448 is subnormal: the scale
    falls back to the max), row 7 `_e4m3_row` (ties +-1 ulp, the max on
    448, subnormal codes); in the copy, row 8 holds a NaN and a finite
    1000.0 (scale 1.0, the code saturates at 448), rows 9 and 10 a +inf
    and a -inf."""
    _, _, g, _ = _edge_arenas(torch, rows, seed)
    g[6] = g[6].clamp(-1.0, 1.0) * 1e-37
    g[6, 0] = 1e-37
    g[7] = _e4m3_row(torch)
    bad = g.clone()
    bad[8, 5] = float("nan")
    bad[8, 9] = 1000.0
    bad[9, 3] = float("inf")
    bad[10, 700] = -float("inf")
    return g, bad


def _codes_equal(torch, a, b):
    """e4m3 codes equal bit for bit, or both NaN (a NaN's sign bit is the
    divide's on each side)."""
    x, y = a.view(torch.uint8), b.view(torch.uint8)
    nan_x, nan_y = (x & 0x7F) == 0x7F, (y & 0x7F) == 0x7F
    return bool(nan_x.equal(nan_y)) and bool(x[~nan_x].equal(y[~nan_y]))


def _check_encode(torch, fp8_wire, label, slab, ef, s, checked):
    """fp8_encode against its plain version on `slab` (the residual `ef`
    injected at the scale s, or none): codes (NaN-aware), scales and the
    flag bit for bit; the flag clear exactly where the slab or the
    injection holds a non-finite value. Returns (codes, scales)."""
    scale = torch.tensor([s], device="cuda")
    ok, okr = torch.ones(1, device="cuda"), torch.ones(1, device="cuda")
    qk, sk = fp8_wire.fp8_encode(slab, ef=ef, scale=scale, ok=ok)
    qr, sr = fp8_wire.fp8_encode_ref(slab, ef=ef, scale=scale, ok=okr)
    torch.cuda.synchronize()
    if not _codes_equal(torch, qk, qr):
        diff = int((qk.view(torch.uint8) != qr.view(torch.uint8)).sum())
        raise AssertionError(f"fp8_encode {label}: codes differ at {diff} "
                             f"elements")
    _compare_bits(torch, "fp8_encode", f"{label} scales", [(sk, sr)])
    x = slab if ef is None else torch.addcmul(slab, ef, scale)
    want = float(bool(torch.isfinite(x).all()))
    if ok.item() != okr.item() or ok.item() != want:
        raise AssertionError(f"fp8_encode {label}: flag {ok.item()}, plain "
                             f"{okr.item()}, expected {want}")
    checked.append(("fp8_encode", label))
    return qk, sk


def _check_ef_update(torch, fp8_wire, label, slab, ef, codes, gs, s, ok,
                     checked):
    """fp8_ef_update against its plain version, bit for bit; with ok = 0
    the residual keeps every byte."""
    scale = torch.tensor([s], device="cuda")
    flag = torch.tensor([1.0 if ok else 0.0], device="cuda")
    ek, er = ef.clone(), ef.clone()
    fp8_wire.fp8_ef_update(ek, slab, codes, gs, scale=scale, ok=flag)
    fp8_wire.fp8_ef_update_ref(er, slab, codes, gs, scale=scale, ok=flag)
    torch.cuda.synchronize()
    _compare_bits(torch, "fp8_ef_update", label, [(ek, er)])
    if not ok and not _bits_equal(torch, ek, ef):
        raise AssertionError(f"fp8_ef_update {label}: ok = 0 changed ef")
    checked.append(("fp8_ef_update", label))


def check_fp8_encode_small(torch, fp8_wire, checked):
    """The encode with and without the residual at each of FP8_SCALES and
    the residual's update with ok = 1 and ok = 0, on the 64-row edge slabs
    (`_fp8_slabs`); and the kernel's conversion against the card's own
    torch cast on `_e4m3_row`."""
    g, bad = _fp8_slabs(torch, CODEC_SMALL_ROWS, 51)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(52)
    ef = torch.randn(g.shape, generator=gen, device="cuda") * 1e-3
    ef[0] = 0.0
    q, s = _check_encode(torch, fp8_wire, "no residual", g, None, 1.0,
                         checked)
    _check_encode(torch, fp8_wire, "no residual, non-finite rows", bad, None,
                  1.0, checked)
    want = [1.0, g[6].abs().max().item(), 1.0]
    if [s[0].item(), s[6].item(), s[7].item()] != want:
        raise AssertionError(f"fp8_encode: the zero, 1e-37 and tie rows' "
                             f"scales are {s[0].item()}, {s[6].item()}, "
                             f"{s[7].item()}; expected {want} (1.0, the "
                             f"row's max, 1.0)")
    cast = g[7].to(torch.float8_e4m3fn)
    if not q[7].view(torch.uint8).equal(cast.view(torch.uint8)):
        raise AssertionError("fp8_encode: the kernel's conversion != torch's "
                             "cast on the card at e4m3's rounding edges")
    checked.append(("fp8_encode", "tie sweep vs torch's cast on the card"))
    for sc in FP8_SCALES:
        qe, se = _check_encode(torch, fp8_wire, f"residual at S={sc:g}", g,
                               ef, sc, checked)
        qb, sb = _check_encode(torch, fp8_wire, f"residual at S={sc:g}, "
                               "non-finite rows", bad, ef, sc, checked)
        _check_ef_update(torch, fp8_wire, f"S={sc:g} ok=1", g, ef, qe, se,
                         sc, True, checked)
        _check_ef_update(torch, fp8_wire, f"S={sc:g} ok=0, non-finite rows",
                         bad, ef, qb, sb, sc, False, checked)


def _check_fp8_fold_arena(torch, fused_step, fp8_wire, adama_accum, m_codec,
                          v_codec, rows, seed, checked):
    """A pair's folds of e4m3 codes (`_wire_cases`) on an arena of
    `rows` rows with the edge rows, each from the same state, the kernel
    against its plain version bit for bit; ok = 0 (codes holding NaN codes)
    writes nothing. The codes are the encode of `_fp8_slabs`' slabs: zero
    codes, subnormal codes, +-448, the scale 1.0 of the zero and tie rows
    and the 1e-37 of the fallback row."""
    pair = f"{m_codec}/{v_codec}"
    b1, b2 = 0.9, 0.999
    m, v, _, _ = _edge_arenas(torch, rows, seed)
    g, bad = _fp8_slabs(torch, rows, seed + 1)
    q, s = fp8_wire.fp8_encode(g)
    qb, sb = fp8_wire.fp8_encode(bad)
    mk, vk = _encode(adama_accum, "m", m_codec, m), \
        _encode(adama_accum, "v", v_codec, v)
    kw = dict(beta1=b1, beta2=b2, m_codec=m_codec, v_codec=v_codec)
    fns = {"arena_fold": (fused_step.arena_fold, fused_step.arena_fold_ref),
           "arena_fold_slice": (fused_step.arena_fold_slice,
                                fused_step.arena_fold_slice_ref)}
    for name, label, ok, call in _wire_cases(torch, rows, b1, b2):
        kern, plain = fns[name]
        codes, scales = (q, s) if ok is not False else (qb, sb)
        sk, sr = ((_clone(mk), _clone(vk)) for _ in range(2))
        call(functools.partial(kern, grad_dtype=torch.float8_e4m3fn, **kw),
             sk, codes, scales)
        call(functools.partial(plain, **kw), sr, codes, scales)
        torch.cuda.synchronize()
        _compare_bits(torch, name, f"e4m3 {pair} {rows} rows {label}",
                      list(zip(sk, sr)))
        if ok is False and not all(_bits_equal(torch, x, y)
                                   for x, y in zip(sk, (mk, vk))):
            raise AssertionError(f"{name} e4m3 {pair} {label}: ok = 0 "
                                 f"changed the state")
        checked.append((name, pair, f"e4m3 {rows} rows {label}"))


def check_fp8_small(torch, fused_step, fp8_wire, adama_accum):
    """Phase 3, the fp8 wire: the encode and the residual's update
    (`check_fp8_encode_small`), then every (m, v) pair's e4m3 folds on the
    64-row edge arena, the rowcol pairs also on RC_RANGE_ROWS rows
    (`_check_fp8_fold_arena`). Returns the checked cases."""
    from repro_torch.core import state_store
    wire_checked, checked = [], []
    check_fp8_encode_small(torch, fp8_wire, wire_checked)
    for m_codec, v_codec in state_store.registered_combinations():
        _check_fp8_fold_arena(torch, fused_step, fp8_wire, adama_accum,
                              m_codec, v_codec, CODEC_SMALL_ROWS, 53, checked)
        if v_codec == "rowcol":
            _check_fp8_fold_arena(torch, fused_step, fp8_wire, adama_accum,
                                  m_codec, v_codec, RC_RANGE_ROWS, 55,
                                  checked)
    log(json.dumps({"phase": "kernel", "case": "fp8 wire: fp8_encode (with "
                    "and without the residual at S = 1, 2^15, 1000; zero, "
                    "1e-37, tie, NaN and +-inf rows) and fp8_ef_update (ok "
                    "= 1, ok = 0) bit for bit against their plain versions, "
                    "the conversion against torch's cast on the card; every "
                    "pair's e4m3 folds and slice folds, unguarded and "
                    "guarded (ok = 1 at f32(1/8)/f32(3), ok = 0 on NaN "
                    "codes), on the 64-row edge arena (rowcol also at "
                    f"{RC_RANGE_ROWS} rows), bit for bit against the plain "
                    "versions", "checked_wire": len(wire_checked),
                    "checked_folds": len(checked)}))
    return wire_checked, checked


# the pairs whose e4m3 folds are timed at the stablelm-1.6b arena
FP8_TIMED_PAIRS = (FP32, ("int8", "rowcol"))
# the encode's and the update's operations per element, each value formed
# once: the encode an FMA (2), |x| and its max (2), the divide and the
# conversion (2), the finite test (1); the update the same FMA (2), the
# decode (1), an FMA (2) and a divide (1)
FP8_ENCODE_OPS, FP8_UPDATE_OPS = 7, 6


def _time_fp8_pass(torch, name, label, kern, plain, n, n_bytes, ops,
                   err, info):
    """One fp8 pass timed (KERNEL_REPS launches, WIRE_TIMED_RUNS runs)
    beside its plain version; its entry."""
    return _kernel_entry(
        name, label, timed_ms(torch, kern, runs=WIRE_TIMED_RUNS,
                              reps=KERNEL_REPS),
        timed_ms(torch, plain, runs=CODEC_PLAIN_RUNS, warmup=1),
        bound_ms(n_bytes, ops * n), dict(info, max_abs_err=err))


def check_fp8_timed(torch, fused_step, fp8_wire, layout):
    """Phase 3, the fp8 wire at the full stablelm-1.6b arena: fp8_encode
    with the residual at S = 2^15 and fp8_ef_update, each once against its
    plain version over the whole arena (bit for bit), then timed; then for
    each of FP8_TIMED_PAIRS the e4m3 fold, a layer slice and the rest slice
    of the encoded slab, bit for bit against the plain version and timed in
    turns beside the bf16 wire (bf16, e4m3, e4m3, bf16) (torch.profiler
    counts one device kernel per call of each in `profile_child`). Returns
    ({kernel: entry} of the two passes, {fold kernel: {pair: [entry per
    case]}})."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(57)
    rows = layout.rows
    n = rows * LANES
    g = torch.randn((rows, LANES), generator=gen, device="cuda")
    ef = torch.randn((rows, LANES), generator=gen, device="cuda") * 1e-5
    s = torch.tensor([2.0 ** 15], device="cuda")
    ok, okr = torch.ones(1, device="cuda"), torch.ones(1, device="cuda")
    q, gs = fp8_wire.fp8_encode(g, ef=ef, scale=s, ok=ok)
    qr, gsr = fp8_wire.fp8_encode_ref(g, ef=ef, scale=s, ok=okr)
    torch.cuda.synchronize()
    if not _codes_equal(torch, q, qr) or ok.item() != 1.0 or \
            okr.item() != 1.0:
        raise AssertionError("fp8_encode at the stablelm arena: codes or "
                             "flag differ from the plain version's")
    err = _compare_bits(torch, "fp8_encode", "stablelm arena scales",
                        [(gs, gsr)])
    del qr, gsr
    info = {"rows": rows, "scale": 2.0 ** 15}
    passes = {"fp8_encode": _time_fp8_pass(
        torch, "fp8_encode", "stablelm arena, with the residual",
        lambda: fp8_wire.fp8_encode(g, ef=ef, scale=s, ok=ok),
        lambda: fp8_wire.fp8_encode_ref(g, ef=ef, scale=s, ok=ok), n,
        # slab and ef read (4 + 4 B), a code written (1 B), the scales
        9 * n + 4 * rows, FP8_ENCODE_OPS, err, info)}
    ek, er = ef.clone(), ef.clone()
    fp8_wire.fp8_ef_update(ek, g, q, gs, scale=s, ok=ok)
    fp8_wire.fp8_ef_update_ref(er, g, q, gs, scale=s, ok=ok)
    torch.cuda.synchronize()
    err = _compare_bits(torch, "fp8_ef_update", "stablelm arena", [(ek, er)])
    if not torch.isfinite(ek).all() or ek.equal(ef):
        raise AssertionError("fp8_ef_update at the stablelm arena: the "
                             "residual is not finite or did not move")
    del ek, er
    passes["fp8_ef_update"] = _time_fp8_pass(
        torch, "fp8_ef_update", "stablelm arena",
        lambda: fp8_wire.fp8_ef_update(ef, g, q, gs, scale=s, ok=ok),
        lambda: fp8_wire.fp8_ef_update_ref(ef, g, q, gs, scale=s, ok=ok),
        n,
        # slab, ef and a code read (4 + 4 + 1 B), ef written (4 B)
        13 * n + 4 * rows, FP8_UPDATE_OPS, err, info)
    for entry in passes.values():
        entry["library_ms"] = None
    g16 = g.to(torch.bfloat16)
    del g, ef
    torch.cuda.empty_cache()
    folds = _time_fp8_folds(torch, fused_step, layout, q, gs, g16, gen)
    del q, gs, g16
    torch.cuda.empty_cache()
    return passes, folds


def _time_fp8_folds(torch, fused_step, layout, q, gs, g16, gen):
    """`check_fp8_timed`'s e4m3 folds (see there)."""
    rows = layout.rows
    spec, rest = layout.stack("blocks"), layout.rest
    out = {"arena_fold": {}, "arena_fold_slice": {}}
    for m_codec, v_codec in FP8_TIMED_PAIRS:
        pair = f"{m_codec}/{v_codec}"
        m, v = _wire_state(torch, gen, m_codec, v_codec, rows)
        kw = dict(beta1=0.9, beta2=0.999, scale=1.0 / 8, m_codec=m_codec,
                  v_codec=v_codec)
        ops = 3 + _FOLD_OPS[m_codec] + _FOLD_OPS[v_codec]
        cases = [("arena_fold", "whole arena", rows, 0, None),
                 ("arena_fold_slice", "layer 0", spec.layer_rows, spec.row,
                  layout.slice_block(spec)),
                 ("arena_fold_slice", "rest", rest.rows, rest.row,
                  layout.slice_block(rest))]
        for name, label, n_rows, off, block in cases:
            if name == "arena_fold":
                def run(fn, mm, vv, gg, sc, n_rows=n_rows):
                    fn(mm, vv, gg[:n_rows], grad_scale=sc, **kw)
                kern, plain = fused_step.arena_fold, fused_step.arena_fold_ref
            else:
                def run(fn, mm, vv, gg, sc, n_rows=n_rows, off=off,
                        block=block):
                    fn(mm, vv, gg[:n_rows], off, block=block, grad_scale=sc,
                       **kw)
                kern, plain = (fused_step.arena_fold_slice,
                               fused_step.arena_fold_slice_ref)
            sc = gs[:n_rows]
            mk, vk, mr, vr = _clone(m), _clone(v), _clone(m), _clone(v)
            run(kern, mk, vk, q, sc)
            run(plain, mr, vr, q, sc)
            torch.cuda.synchronize()
            err = _compare_bits(torch, name, f"e4m3 {pair} {label}",
                                [(mk, mr), (vk, vr)])
            del mk, vk, mr, vr
            n = n_rows * LANES
            args = ((g16, None), (q, sc), (q, sc), (g16, None))
            t = [timed_ms(torch, lambda a=a: run(kern, m, v, *a),
                          runs=WIRE_TIMED_RUNS, reps=KERNEL_REPS)
                 for a in args]
            state_bytes = 2 * _codec_bytes(m_codec, v_codec, n_rows)
            entry = _kernel_entry(
                name, f"e4m3 {pair} {label}", statistics.median(t[1:3]),
                timed_ms(torch, lambda: run(plain, m, v, q, sc),
                         runs=CODEC_PLAIN_RUNS, warmup=1),
                # the codes read once at 1 B and the scales; the slice's
                # state read and written
                bound_ms(n + 4 * n_rows + state_bytes, ops * n),
                {"pair": pair, "wire": "e4m3", "rows": n_rows,
                 "row_offset": off, "max_abs_err": err},
                logged={"bf16_wire_ms_in_turns": [t[0], t[3]],
                        "e4m3_ms_in_turns": t[1:3]})
            bf16_ms = statistics.median([t[0], t[3]])
            entry.update(bf16_wire_ms=bf16_ms,
                         e4m3_over_bf16_wire=entry["ms"] / bf16_ms)
            out[name].setdefault(pair, []).append(entry)
        for x in (*_cols(m), *_cols(v)):
            if x.is_floating_point() and not torch.isfinite(x).all():
                raise AssertionError(f"e4m3 {pair}: non-finite state after "
                                     f"the timed runs")
        del m, v
    return out


def _leaf_cases(cfg):
    """name -> (whole tensor shape, which part the kernel gets): None is
    the whole tensor, an int j the view [j] (a layer's row of a stacked
    leaf), "offset1" the view [1:] (a pointer 4 bytes off 16-byte
    alignment, so the kernel's one-float path runs)."""
    L, d, h = cfg.num_layers, cfg.d_model, cfg.n_heads
    hd = cfg.resolved_head_dim
    return {"accum": {"embed leaf": ((cfg.padded_vocab(), d), None),
                      "wq of one layer": ((L, d, h, hd), L // 2),
                      "norm view": ((L, d), L - 1),
                      "ragged odd size, unaligned": ((1_000_004,),
                                                     "offset1")},
            "apply": {"embed leaf": ((cfg.padded_vocab(), d), None),
                      "stacked wq": ((L, d, h, hd), None),
                      "norm view": ((L, d), L - 1),
                      "ragged odd size, unaligned": ((1_000_004,),
                                                     "offset1")}}


def _part(x, which):
    if which is None:
        return x
    return x[1:] if which == "offset1" else x[which]


def check_leaf_kernels(torch, adama_accum, adam_apply):
    """Phase 3, adama_accum_2d and adam_apply_2d at the main path's leaf
    shapes: bitwise against the plain version (over the whole tensor, so
    a view's neighbours must be untouched too), then timed."""
    from repro_torch.configs.base import get_config
    cfg = get_config("bert_large")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)

    def rand(shape, scale, positive=False):
        x = torch.randn(shape, generator=gen, device="cuda") * scale
        return x.abs() if positive else x
    out = {}
    cases = _leaf_cases(cfg)
    acc_kw = dict(beta1=0.9, beta2=0.999, scale=1.0)
    err, timed = 0.0, []
    for label, (shape, which) in cases["accum"].items():
        m, v = rand(shape, 1e-3), rand(shape, 1e-6, True)
        g = rand(_part(m, which).shape, 1.0 / 8)
        mk, vk, mr, vr = m.clone(), v.clone(), m.clone(), v.clone()
        adama_accum.adama_accum_2d(_part(mk, which), _part(vk, which), g,
                                   **acc_kw)
        adama_accum.adama_accum_2d_ref(_part(mr, which), _part(vr, which), g,
                                       **acc_kw)
        torch.cuda.synchronize()
        err = max(err, _compare("adama_accum_2d", label,
                                [(mk, mr), (vk, vr)]))
        mp, vp = _part(m, which), _part(v, which)
        n = mp.numel()
        timed.append(_kernel_entry(
            "adama_accum_2d", label,
            timed_ms(torch, lambda: adama_accum.adama_accum_2d(
                mp, vp, g, **acc_kw), reps=KERNEL_REPS),
            timed_ms(torch, lambda: adama_accum.adama_accum_2d_ref(
                mp, vp, g, **acc_kw), runs=PLAIN_TIMED_RUNS, warmup=1),
            # g read once, m and v read and written once; 5 fp32 ops each
            bound_ms(5 * 4 * n, 5 * n),
            {"elements": n, "aligned16": mp.data_ptr() % 16 == 0}))
        del m, v, g, mk, vk, mr, vr, mp, vp
    out["adama_accum_2d"] = dict(timed[0], max_abs_err=err, library_ms=None,
                                 by_case=timed)
    err, timed = 0.0, []
    for label, (shape, which) in cases["apply"].items():
        p, m, v = rand(shape, 0.02), rand(shape, 1e-3), rand(shape, 1e-6,
                                                            True)
        mp, vp = _part(m, which), _part(v, which)
        for wd in (0.0, 0.01):
            kw = dict(lr=1e-3, bc1=0.1, bc2=0.001, eps=1e-8, weight_decay=wd)
            pk, pr = p.clone(), p.clone()
            adam_apply.adam_apply_2d(_part(pk, which), mp, vp, **kw)
            adam_apply.adam_apply_2d_ref(_part(pr, which), mp, vp, **kw)
            torch.cuda.synchronize()
            err = max(err, _compare("adam_apply_2d", f"{label} wd={wd}",
                                    [(pk, pr)]))
            del pk, pr
        pp = _part(p, which)
        kw = dict(lr=1e-3, bc1=0.1, bc2=0.001, eps=1e-8)
        n = pp.numel()
        timed.append(_kernel_entry(
            "adam_apply_2d", label,
            timed_ms(torch, lambda: adam_apply.adam_apply_2d(pp, mp, vp,
                                                             **kw),
                     reps=KERNEL_REPS),
            timed_ms(torch, lambda: adam_apply.adam_apply_2d_ref(pp, mp, vp,
                                                                 **kw),
                     runs=PLAIN_TIMED_RUNS, warmup=1),
            # p, m, v read once, p written once; 7 fp32 ops each
            bound_ms(4 * 4 * n, 7 * n),
            {"elements": n, "aligned16": pp.data_ptr() % 16 == 0}))
        if not torch.isfinite(p).all():
            raise AssertionError(f"adam_apply_2d {label}: non-finite params "
                                 f"after the timed runs")
        del p, m, v, mp, vp, pp
    out["adam_apply_2d"] = dict(timed[0], max_abs_err=err, library_ms=None,
                                by_case=timed)
    torch.cuda.empty_cache()
    return out


def scan_fwd_work(bh, s, c, k, v):
    """(bytes, products, elementwise operations) that one forward scan must
    do: r, k, logw, v, u, s0 read once, y and s_final written once (the
    chunk-start states the kernels also write, for the output pass and the
    backward, are the design's intermediate, not counted); each pair decay
    e^{cx[t]-cw[i]} formed once. A fused multiply-add counts two
    operations, an exponential one. Products are the sums of products a
    tensor core can take: A's pair sums, (r e^{cx}) S, A v and the bonus
    times v, and the state carry (k e^{T-cw})^T v."""
    pairs = c * (c - 1) // 2
    products = (2 * pairs * k                 # A's sums over k
                + 2 * c * v * k + 2 * pairs * v + 2 * c * v    # y
                + 2 * k * v * c)              # state carry
    elementwise = (2 * c * k                  # cumsums
                   + 3 * pairs * k            # pair decays (sub, exp, mul)
                   + 3 * c * k                # bonus
                   + 5 * c * k                # r e^{cx}, k e^{T-cw}
                   + 2 * k * v)               # diag(e^T) S
    n_bytes = 4 * (3 * bh * s * k + 2 * bh * s * v + bh * k + 2 * bh * k * v)
    n = bh * (s // c)
    return n_bytes, n * products, n * elementwise


def scan_bwd_work(bh, s, c, k, v):
    """(bytes, operations) that the gradient of one scan must do, counted
    from its arithmetic, not from the kernel's loops: r, k, logw, v, dy,
    u and ds_final read once, dr, dk, dlogw, dv, du and ds0 written once
    (the forward's saved chunk-start states are this design's
    intermediate, not counted). Per chunk, with E = e^{cx[t]-cw[i]} formed
    once per (t, i, k), i < t: sub and exp, r E, A += (r E) k, p_k +=
    dA (r E), p_r += (dA E) k: 10 operations. Per (t, i, v): dA = dy v and
    dv += A dy. Per (t, k, v): dv += (k e^{T-cw}) dS, S dy (dr), v dS
    (dk), dS += (r e^{cx}) dy. Per (t, k): 29 (cumsums, bonus, the decays
    e^{cx} and e^{T-cw}, dr, dk, dcx, dcw, du, the dT sum and dlogw's
    reverse cumsum); per (k, v): 3; per k: 4 (e^T, dT)."""
    pairs = c * (c - 1) // 2
    per_chunk = (10 * pairs * k + 4 * pairs * v + 8 * c * k * v
                 + 4 * c * v + 29 * c * k + 3 * k * v + 4 * k)
    n_bytes = 4 * (6 * bh * s * k + 3 * bh * s * v + 2 * bh * k
                   + 2 * bh * k * v)
    return n_bytes, bh * (s // c) * per_chunk


def _scan_inputs(torch, bh, s, k, v, seed):
    """The distributions of tests/test_rwkv6_kernel.py, with a nonzero s0,
    and output gradients dy, ds_final."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def n(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    args = (n(bh, s, k) * 0.5, n(bh, s, k) * 0.5, n(bh, s, v) * 0.5,
            -torch.exp(n(bh, s, k) - 1.0), n(bh, k) * 0.5, n(bh, k, v) * 0.3)
    return args, n(bh, s, v), n(bh, k, v)


def _scan_rel(label, names, got, want):
    """Largest |got - want| / largest |want| per output; raise above the
    tolerance. Returns the largest relative and absolute errors."""
    worst_rel, worst_abs = 0.0, 0.0
    for name, a, b in zip(names, got, want):
        if not bool(a.isfinite().all()):
            raise AssertionError(f"rwkv6 scan {label}: {name} not finite")
        err = float((a - b).abs().max())
        rel = err / max(float(b.abs().max()), 1e-30)
        if rel > SCAN_REL_TOL:
            raise AssertionError(f"rwkv6 scan {label}: {name} differs from "
                                 f"the plain version by {err} ({rel:.3g} of "
                                 f"its largest value; tolerance "
                                 f"{SCAN_REL_TOL})")
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, err)
    return worst_rel, worst_abs


GRAD_NAMES = ("dr", "dk", "dv", "dlogw", "du", "ds0")


def _check_scan_case(torch, rc, label, bh, s, seed, k=SCAN_SHAPE["k"],
                     v=SCAN_SHAPE["v"], c=SCAN_SHAPE["chunk"]):
    """Forward and backward kernels against the plain versions at one
    shape (the plain backward is torch.autograd.grad through the plain
    forward), the backward also through the autograd.Function; then
    timed."""
    args, dy, dsf = _scan_inputs(torch, bh, s, k, v, seed)
    y, sf, states = rc.scan_forward(*args, chunk=c, save_states=True)
    yr, sr, str_ = rc.rwkv6_chunk_scan_ref(*args, chunk=c, states=True)
    torch.cuda.synchronize()
    fwd_err = _scan_rel(f"{label} forward", ("y", "s_final", "states"),
                        (y, sf, states), (yr, sr, str_))
    del yr, sr, str_
    want = rc.rwkv6_chunk_scan_bwd_ref(*args, dy, dsf, chunk=c)
    got = rc.rwkv6_chunk_scan_bwd(*args[:5], states, dy, dsf, chunk=c)
    torch.cuda.synchronize()
    bwd_err = _scan_rel(f"{label} backward", GRAD_NAMES, got, want)
    leaves = [x.clone().requires_grad_(True) for x in args]
    ya, sa = rc.rwkv6_chunk_scan(*leaves, chunk=c)
    auto = torch.autograd.grad((ya, sa), leaves, (dy, dsf))
    torch.cuda.synchronize()
    bwd_err = max(bwd_err, _scan_rel(f"{label} autograd", GRAD_NAMES, auto,
                                     want))
    del got, want, auto, leaves, ya, sa, y, sf
    info = {"bh": bh, "s": s, "k": k, "v": v, "chunk": c}
    n_bytes, products, elementwise = scan_fwd_work(bh, s, c, k, v)
    fp32_ms, fp32_by = bound_ms(n_bytes, products + elementwise)
    fwd = _kernel_entry(
        "rwkv6_chunk_scan", label,
        timed_ms(torch, lambda: rc.scan_forward(*args, chunk=c,
                                                save_states=True),
                 reps=KERNEL_REPS),
        timed_ms(torch, lambda: rc.rwkv6_chunk_scan_ref(*args, chunk=c,
                                                         states=True),
                 runs=PLAIN_TIMED_RUNS, warmup=1),
        bound_ms(n_bytes, elementwise, tf32_ops=products),
        dict(info, saves_states=True, max_rel_err=fwd_err[0],
             max_abs_err=fwd_err[1]),
        # the bound of a design on fp32 cores alone
        logged={"bound_fp32_ms": fp32_ms, "bound_fp32_by": fp32_by})
    bwd = _kernel_entry(
        "rwkv6_chunk_scan_bwd", label,
        timed_ms(torch, lambda: rc.rwkv6_chunk_scan_bwd(
            *args[:5], states, dy, dsf, chunk=c), reps=KERNEL_REPS),
        # the plain backward: autograd through the plain forward, whose
        # forward pass is part of its time
        timed_ms(torch, lambda: rc.rwkv6_chunk_scan_bwd_ref(
            *args, dy, dsf, chunk=c), runs=PLAIN_TIMED_RUNS, warmup=1),
        bound_ms(*scan_bwd_work(bh, s, c, k, v)),
        dict(info, max_rel_err=bwd_err[0], max_abs_err=bwd_err[1]))
    return fwd, bwd


def _check_state_carry(torch, rc, bh, s, seed):
    """Two halves run with the carried state equal one full run (kernel
    against kernel, as tests/test_rwkv6_kernel.py does for Pallas)."""
    k, v, c = SCAN_SHAPE["k"], SCAN_SHAPE["v"], SCAN_SHAPE["chunk"]
    (r, kk, vv, w, u, s0), _, _ = _scan_inputs(torch, bh, s, k, v, seed)
    y_full, s_full, _ = rc.scan_forward(r, kk, vv, w, u, s0, chunk=c)
    h = s // 2
    halves = [tuple(x[:, sl].contiguous() for x in (r, kk, vv, w))
              for sl in (slice(0, h), slice(h, s))]
    y1, s1, _ = rc.scan_forward(*halves[0], u, s0, chunk=c)
    y2, s2, _ = rc.scan_forward(*halves[1], u, s1, chunk=c)
    torch.cuda.synchronize()
    return _scan_rel("state carry", ("y", "s_final"),
                     (torch.cat([y1, y2], 1), s2), (y_full, s_full))


def _check_large_decays(torch, rc, bh, s, seed):
    """logw at both ends of the model's clip (-e^8 on every 7th token,
    -e^-20 on every 5th from the 3rd), where a wrongly factored decay
    would overflow or lose terms: the forward kernel's y, s_final and
    states, and the backward kernels' gradients (from those states),
    finite and within SCAN_REL_TOL of the plain versions' (the kernels
    take their cumsums in the plain version's order). Returns the
    forward's and the backward's largest errors."""
    k, v, c = SCAN_SHAPE["k"], SCAN_SHAPE["v"], SCAN_SHAPE["chunk"]
    args, dy, dsf = _scan_inputs(torch, bh, s, k, v, seed)
    args[3][:, ::7] = -math.exp(8.0)
    args[3][:, 3::5] = -math.exp(-20.0)
    got = rc.scan_forward(*args, chunk=c, save_states=True)
    want = rc.rwkv6_chunk_scan_ref(*args, chunk=c, states=True)
    torch.cuda.synchronize()
    fwd = _scan_rel("large decays forward", ("y", "s_final", "states"), got,
                    want)
    grads = rc.rwkv6_chunk_scan_bwd(*args[:5], got[2], dy, dsf, chunk=c)
    want = rc.rwkv6_chunk_scan_bwd_ref(*args, dy, dsf, chunk=c)
    torch.cuda.synchronize()
    return fwd, _scan_rel("large decays backward", GRAD_NAMES, grads, want)


def profile_kernels(torch, fn, prefix=""):
    """{kernel: (launches, device ms)} of the kernels whose name holds
    `prefix` that one call of fn() runs on the card, as torch.profiler
    records them (memsets, copies and the step's own range are no
    kernels)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    events = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: events.extend(p.key_averages())
                 ) as prof:
        for _ in range(2):               # the warm-up step, the counted one
            fn()
            torch.cuda.synchronize()
            prof.step()
    found = {}
    for e in events:
        if (str(getattr(e, "device_type", "")).endswith("CUDA")
                and prefix in e.key
                and not e.key.startswith(("Memset", "Memcpy",
                                          "ProfilerStep"))):
            # "void (anonymous namespace)::rwkv6_grad_kernel(float const*,
            # ...)" -> "rwkv6_grad_kernel"
            name = e.key.split("::")[-1].split("(")[0].replace("void ",
                                                                "").strip()
            n, ms = found.get(name, (0, 0.0))
            found[name] = (n + e.count, ms + getattr(
                e, "self_device_time_total",
                getattr(e, "self_cuda_time_total", 0.0)) / 1e3)
    return found


def device_kernels_per_call(torch, fn, prefix):
    """How many kernels whose name holds `prefix` one call of fn() runs on
    the card, and each one's device milliseconds. A session that records
    none is run again, up to PROFILE_ATTEMPTS times."""
    for _ in range(PROFILE_ATTEMPTS):
        found = profile_kernels(torch, fn, prefix)
        if found:
            break
    else:
        raise AssertionError(f"torch.profiler recorded no {prefix}* kernel "
                             f"on the card in {PROFILE_ATTEMPTS} sessions")
    return (sum(n for n, _ in found.values()),
            {name: ms for name, (_, ms) in found.items()})


def check_rwkv_scan(torch, rc):
    """Phase 3, the RWKV-6 scan kernels at six shapes and at the decay
    clip's ends; the device kernels per call of each."""
    sh = SCAN_SHAPE
    cases = [("rwkv6-7b training shape", sh["bh"], sh["s"], 10, {}),
             ("one chunk", 3, sh["chunk"], 11, {}),
             ("state carry", 4, 512, 12, {}),
             # the other chunk, K and V that check_inputs admits on the card
             ("chunk 32, K 16, V 48", 3, 96, 15, dict(c=32, k=16, v=48)),
             ("chunk 48, K 48, V 32", 3, 96, 16, dict(c=48, k=48, v=32)),
             ("chunk 16, K 32, V 16", 3, 96, 17, dict(c=16, k=32, v=16))]
    fwd, bwd = [], []
    for label, bh, s, seed, shape in cases:
        f, b = _check_scan_case(torch, rc, label, bh, s, seed, **shape)
        fwd.append(f)
        bwd.append(b)
        torch.cuda.empty_cache()
    carry = _check_state_carry(torch, rc, 4, 512, 13)
    log(json.dumps({"phase": "kernel", "name": "rwkv6_chunk_scan",
                    "case": "two halves with the carried state vs one run",
                    "max_rel_err": carry[0], "max_abs_err": carry[1]}))
    large = dict(zip(("rwkv6_chunk_scan", "rwkv6_chunk_scan_bwd"),
                     _check_large_decays(torch, rc, 4, 512, 14)))
    for name, err in large.items():
        log(json.dumps({"phase": "kernel", "name": name,
                        "case": "large decays (logw -e^8 and -e^-20)",
                        "bh": 4, "s": 512, "max_rel_err": err[0],
                        "max_abs_err": err[1],
                        "tolerance_rel": SCAN_REL_TOL}))
    # the kernels one call runs, at the training shape: the forward's state
    # and output passes; the backward's reverse state pass, gradient pass
    # and du reduction
    args, dy, dsf = _scan_inputs(torch, sh["bh"], sh["s"], sh["k"], sh["v"],
                                 10)
    states = rc.scan_forward(*args, chunk=sh["chunk"], save_states=True)[2]
    per_call = {
        "rwkv6_chunk_scan": device_kernels_per_call(
            torch, lambda: rc.scan_forward(*args, chunk=sh["chunk"],
                                           save_states=True), "rwkv6_"),
        "rwkv6_chunk_scan_bwd": device_kernels_per_call(
            torch, lambda: rc.rwkv6_chunk_scan_bwd(
                *args[:5], states, dy, dsf, chunk=sh["chunk"]), "rwkv6_")}
    del args, dy, dsf, states
    for name, (n, ms) in per_call.items():
        log(json.dumps({"phase": "kernel", "name": name,
                        "case": "device kernels of one call, torch.profiler",
                        "device_kernels_per_call": n, "device_ms": ms}))
    out = {}
    for name, entries in (("rwkv6_chunk_scan", fwd),
                          ("rwkv6_chunk_scan_bwd", bwd)):
        main = {k: x for k, x in entries[0].items()
                if k not in ("max_rel_err", "max_abs_err")}
        out[name] = dict(main, max_abs_err=max(e["max_abs_err"]
                                               for e in entries),
                         max_rel_err=max(e["max_rel_err"] for e in entries),
                         tolerance_rel=SCAN_REL_TOL, library_ms=None,
                         by_case=entries)
    for name in out:
        out[name].update(large_decay_max_rel_err=large[name][0],
                         device_kernels_per_call=per_call[name][0],
                         device_ms_by_kernel=per_call[name][1])
    return out


# reduced models checked card against CPU: arch -> (steps, ((engine, arena
# state, (m codec, v codec)[, fault[, micro-batches]]), ...))
SMALL_PATHS = {"bert_large": (2, (("adama", True, FP32),
                                  ("adama_layerwise", True, FP32),
                                  ("adama_layerwise", False, FP32),
                                  ("adama", False, FP32))),
               "rwkv6_7b": (2, (("adama", True, FP32),
                                ("adama_layerwise", True, FP32))),
               "stablelm_1_6b": (3, (("adama", True, ("int8", "int8")),
                                     ("adama_layerwise", True,
                                      ("int8", "factored")),
                                     ("adama_layerwise", True,
                                      ("int8", "rowcol")),
                                     # guarded, a NaN caught at micro-batch
                                     # 1 of step 1
                                     ("adama_layerwise", True,
                                      ("int8", "rowcol"),
                                      "nan@micro=1,step=1"))),
               # swa and mla at seq 128, past the reduced window of 64; mla
               # with a q low-rank projection (the reduced config drops
               # it); ga at 3 micro-batches, where f32(1/3) is inexact
               "mistral_nemo_12b": (2, (("adama", True, FP32),
                                        ("adama_layerwise", True, FP32),
                                        ("ga", True, FP32, None, 3))),
               "minicpm3_4b": (2, (("adama", True, FP32),
                                   ("adama_layerwise", True, FP32),
                                   ("ga", True, FP32, None, 3))),
               # MoE at 3 layers (2 MoE, 1 dense): 4 experts, top-2,
               # capacity 20 at seq 32 (some copies dropped)
               "deepseek_v2_lite_16b": (2, (("adama", True, FP32),
                                            ("adama_layerwise", True, FP32),
                                            ("ga", True, FP32, None, 3))),
               # hybrid at seq 128, past the reduced window of 64
               "hymba_1_5b": (2, (("adama", True, FP32),
                                  ("adama_layerwise", True, FP32),
                                  ("ga", True, FP32, None, 3))),
               # enc-dec (one encoder and one decoder layer over 64 frames)
               # and vlm (16 patches before the text), every engine at 3
               # micro-batches
               "whisper_base": (2, (("adama", True, FP32, None, 3),
                                    ("adama_layerwise", True, FP32, None, 3),
                                    ("ga", True, FP32, None, 3))),
               "internvl2_26b": (2, (("adama", True, FP32, None, 3),
                                     ("adama_layerwise", True, FP32, None,
                                      3),
                                     ("ga", True, FP32, None, 3)))}
# the small-input runs' config changes and sizes, by arch (default: seq 32,
# 2 micro-batches of 2, a constant lr). `first_step_lr_0`: step 1 applies
# lr 0, as the CPU parity tests of ga do (ROADMAP queue 3 (f)). Adam's
# first update is lr * g / (|g| + eps), so an element whose gradient
# cancels to the noise of two summation orders moves by a noise-decided
# share of lr: one element of reduced mistral-nemo's 1,115,392 moved
# 3.2e-5 apart on the card and the CPU at a constant lr (losses equal to
# 1e-7). Step 2 then updates from m and v of two gradients
SMALL_SETTINGS = {"mistral_nemo_12b": dict(seq_len=128,
                                           first_step_lr_0=True),
                  "minicpm3_4b": dict(seq_len=128, first_step_lr_0=True,
                                      overrides={"q_lora_rank": 96}),
                  "deepseek_v2_lite_16b": dict(first_step_lr_0=True,
                                               overrides={"num_layers": 3}),
                  "hymba_1_5b": dict(seq_len=128, first_step_lr_0=True),
                  "whisper_base": dict(first_step_lr_0=True),
                  "internvl2_26b": dict(first_step_lr_0=True)}
SMALL_PARAM_TOL = 2e-5
# the largest share of params beyond SMALL_PARAM_TOL after the steps, from
# int8 codes that a matmul's other rounding order flipped
# (tests/test_torch_codecs.py measures up to 7.4% port vs reference after
# 3 int8/int8 steps on the CPU); a wrong or missing update moves nearly
# every param by ~lr
CODE_FLIP_FRAC = 0.15


def small_param_tol(codecs, lr):
    """Card vs CPU params: SMALL_PARAM_TOL, plus the pair's declared drift
    (the sum of its codecs' drift_lr x lr, tests/test_torch_codecs.py) for
    at most CODE_FLIP_FRAC of them: a matmul's other rounding order can
    move a value across an int8 code boundary. fp32 and factored declare
    none (0 and None)."""
    from repro_torch.core import state_store
    drift = sum(state_store.get_codec(name, moment).conformance.drift_lr
                or 0.0 for moment, name in zip(("m", "v"), codecs))
    return SMALL_PARAM_TOL + drift * lr


def check_small_input(torch):
    """Phase 4: the CUDA path agrees with the CPU path (plain versions) on
    a reduced run from identical params and data, for each engine and
    state form the kernels serve: bert-large and rwkv6-7b (whose scan is
    not bitwise, so its losses and params agree to the same tolerances)."""
    import dataclasses

    from repro_torch.configs.base import OptimizerConfig, RunConfig, get_config
    from repro_torch.models.model import init_params
    from repro_torch.train.loop import train

    def copy_to(tree, device):
        return {k: copy_to(x, device) if isinstance(x, dict)
                else x.clone().to(device) for k, x in tree.items()}

    for arch, (steps, paths) in SMALL_PATHS.items():
        settings = SMALL_SETTINGS.get(arch, {})
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  compute_dtype="float32",
                                  **settings.get("overrides", {}))
        gen = torch.Generator()
        gen.manual_seed(0)
        base = init_params(cfg, gen)
        for engine, arena, codecs, *rest in paths:
            fault = rest[0] if rest else None
            n_micro = rest[1] if len(rest) > 1 else 2
            opt = OptimizerConfig(accumulation=engine, micro_batches=n_micro,
                                  arena=arena, m_codec=codecs[0],
                                  state_codec=codecs[1],
                                  finite_guard=fault is not None)
            tol = small_param_tol(codecs, opt.lr)
            run = RunConfig(model=cfg, optimizer=opt,
                            seq_len=settings.get("seq_len", 32),
                            global_batch=2 * n_micro, steps=steps,
                            log_every=10**9, inject_fault=fault)
            sched = None
            if settings.get("first_step_lr_0"):
                # ga reads the schedule at the step before the update, the
                # AdamA engines at the step after it
                first = 0 if engine == "ga" else 1
                sched = functools.partial(
                    lambda lr, first, step: 0.0 if step == first else lr,
                    opt.lr, first)
            outs = {dev: train(run, params=copy_to(base, dev), device=dev,
                               lr_schedule=sched, log_fn=lambda s: None)
                    for dev in ("cuda", "cpu")}
            lc, lg = outs["cpu"]["losses"], outs["cuda"]["losses"]
            label = (f"{arch} {engine} {'arena' if arena else 'per-leaf'} "
                     f"{codecs[0]}/{codecs[1]} N={n_micro}"
                     + (f" guarded {fault}" if fault else ""))
            skips = [outs[d]["metrics"].get("skipped_micro_batches")
                     for d in ("cpu", "cuda")]
            if fault and not skips[0] == skips[1] == 1:
                raise AssertionError(f"small-input {label}: skipped "
                                     f"micro-batches cpu, cuda {skips}; "
                                     f"expected 1 each")
            worst, worst_leaf, beyond, total = 0.0, None, 0, 0
            pc = dict(outs["cpu"]["model"].named_parameters())
            for name, x in outs["cuda"]["model"].named_parameters():
                d = (x.detach().cpu() - pc[name].detach()).abs()
                if float(d.max()) > worst:
                    worst, worst_leaf = float(d.max()), name
                beyond += int((d > SMALL_PARAM_TOL).sum())
                total += d.numel()
            log(json.dumps({"phase": "small_input", "arch": arch,
                            "config_overrides": settings.get("overrides"),
                            "seq_len": run.seq_len, "micro_batches": n_micro,
                            "engine": engine, "arena": arena,
                            "m_codec": codecs[0], "v_codec": codecs[1],
                            "fault": fault, "skipped_cpu_cuda": skips,
                            "steps": steps, "losses_cpu": lc,
                            "losses_cuda": lg, "max_param_abs_diff": worst,
                            "max_diff_leaf": worst_leaf,
                            "first_step_lr_0": bool(sched),
                            "param_tolerance": tol,
                            "share_beyond_fp32_tolerance": beyond / total,
                            "share_tolerance": CODE_FLIP_FRAC}))
            for a, b in zip(lc, lg):
                if not (math.isfinite(b) and abs(a - b) <= 1e-5 * abs(a)):
                    raise AssertionError(f"small-input {label}: losses "
                                         f"differ: cpu {lc} cuda {lg}")
            if worst > tol or beyond > CODE_FLIP_FRAC * total:
                raise AssertionError(f"small-input {label}: params differ "
                                     f"by up to {worst} (tolerance {tol}), "
                                     f"{beyond} of {total} beyond "
                                     f"{SMALL_PARAM_TOL}")


# whisper-base's own widths at one encoder and one decoder layer, its vocab
# cut to 1024: four half-row norm leaves among six rest leaves and two
# stacked regions, at XLA CPU's fusion limit
WHISPER_WIDTH = dict(d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
                     d_ff=2048, vocab_size=1024)


def check_ga_accumulate(torch):
    """ga's accumulation step (core/accumulation.py `_ga_accumulate`: acc
    + pack / N as the reference's XLA CPU computes it, a fused
    multiply-add by f32(1/N) but two roundings on the padded leaves whose
    pad XLA fuses into the sum, `uncontracted_rows`) on the card against
    the CPU, bit for bit, at N = 3 on the arena layouts of the reduced
    models (minicpm3 with and without its q low-rank projection), of a
    deepseek at d_model 1024 whose only padded stacked leaf is kv_norm and
    of a whisper at its own widths (WHISPER_WIDTH):
    the card's `addcmul_` must be the fused multiply-add that the CPU
    forms exactly."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.core import accumulation as acc_mod
    from repro_torch.core import arena as arena_mod
    from repro_torch.models.model import init_params

    for arch, over in (("bert_large", {}), ("stablelm_1_6b", {}),
                       ("rwkv6_7b", {}), ("mistral_nemo_12b", {}),
                       ("minicpm3_4b", {}),
                       ("minicpm3_4b", {"q_lora_rank": 96}),
                       ("deepseek_v2_lite_16b", {}),
                       ("deepseek_v2_lite_16b", {"d_model": 1024,
                                                 "kv_lora_rank": 512}),
                       ("hymba_1_5b", {}), ("whisper_base", {}),
                       ("whisper_base", WHISPER_WIDTH),
                       ("internvl2_26b", {})):
        cfg = dataclasses.replace(get_config(arch).reduced(), **over)
        gen = torch.Generator()
        gen.manual_seed(0)
        layout = arena_mod.build_layout(init_params(cfg, gen))
        shape = (layout.rows, LANES)
        acc = torch.randn(shape, generator=gen) * 1e-2
        slab = torch.randn(shape, generator=gen) * 1e-3
        rows = acc_mod.uncontracted_rows(layout)
        out = {}
        for dev in ("cpu", "cuda"):
            a = acc.to(dev, copy=True)
            acc_mod._ga_accumulate(a, slab.to(dev, copy=True),
                                   acc_mod.inv_n(3, dev), rows)
            out[dev] = a.cpu()
        two_roundings = acc + slab * acc_mod.inv_n(3, "cpu")
        fused = int((out["cuda"] != two_roundings).sum())
        differ = int((out["cuda"].view(torch.int32)
                      != out["cpu"].view(torch.int32)).sum())
        log(json.dumps({"phase": "ga_accumulate", "arch": cfg.name,
                        "config_overrides": over, "rows": layout.rows,
                        "uncontracted_rows": rows,
                        "elements_differing_cpu_cuda": differ,
                        "elements_where_one_rounding_differs_from_two":
                            fused}))
        if differ or not fused:
            raise AssertionError(f"ga accumulate {cfg.name}: {differ} "
                                 f"elements differ between the card and the "
                                 f"CPU ({fused} where the fused multiply-add "
                                 f"differs from two roundings)")


ROPE_CASES = ((64, 1e4), (64, 1e6), (128, 1e4), (128, 1e6))


def check_rope(torch):
    """rope_freqs on the card bit for bit against the CPU (both form the
    power in float64 and round it once, as XLA's float32 pow): head_dim 64
    (bert-large, stablelm-1.6b, hymba-1.5b, mla's rotary part) and 128
    (mistral-nemo-12b). Logs on how many frequencies torch's float32 pow
    on the card, which the port used before, differs from that."""
    from repro_torch.models.modules import rope_freqs
    for hd, theta in ROPE_CASES:
        cpu = rope_freqs(hd, theta)
        card = rope_freqs(hd, theta, "cuda").cpu()
        f32_pow = (1.0 / (theta ** (torch.arange(
            0, hd, 2, dtype=torch.float32, device="cuda") / hd))).cpu()
        differ = int((card.view(torch.int32) != cpu.view(torch.int32)).sum())
        log(json.dumps({"phase": "rope", "head_dim": hd, "theta": theta,
                        "frequencies": hd // 2,
                        "differing_cpu_cuda": differ,
                        "float32_pow_differing_on_the_card": int(
                            (f32_pow.view(torch.int32)
                             != cpu.view(torch.int32)).sum())}))
        if differ:
            raise AssertionError(f"rope_freqs({hd}, {theta}): {differ} "
                                 f"frequencies differ between the card and "
                                 f"the CPU")


# the hybrid block's Mamba heads on the card against the CPU, in fp32 at the
# reduced hymba-1.5b: each output and gradient within this share of its
# largest |value| on the CPU (tests/test_torch_hybrid.py's MAMBA_REL, the
# port's CPU against the reference)
MAMBA_REL = 5e-6
MAMBA_SEQ = 80
MAMBA_LEAVES = ("A_log", "D_skip", "conv_b", "conv_w", "dt_bias", "w_B",
                "w_C", "w_dt_a", "w_dt_b", "w_in", "w_out")


def check_mamba(torch):
    """mamba_mix and the hybrid block (apply_block, kind "hybrid") at the
    reduced hymba-1.5b in fp32, seq 80 (past the window of 64), on the
    card and on the CPU from the same inputs: the output and the gradients
    of every leaf and of x within MAMBA_REL of the CPU's largest |value|
    in each."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models import model as model_mod
    from repro_torch.models import modules as md
    cfg = dataclasses.replace(get_config("hymba_1_5b").reduced(),
                              compute_dtype="float32")
    gen = torch.Generator()
    gen.manual_seed(0)
    block = {k: x[0] for k, x in model_mod.init_params(
        cfg, gen)["blocks"].items()}
    for k in ("fuse_norm_a", "fuse_norm_m"):
        block[k] = 1.0 + 0.1 * torch.randn(block[k].shape, generator=gen)
    shape = (2, MAMBA_SEQ, cfg.d_model)
    x = torch.randn(shape, generator=gen)
    dy = 0.1 * torch.randn(shape, generator=gen)
    pos = torch.arange(MAMBA_SEQ, dtype=torch.int32).expand(2, MAMBA_SEQ)

    def run(dev, which):
        p = {k: v.to(dev).requires_grad_(True) for k, v in block.items()}
        xd = x.to(dev).requires_grad_(True)
        if which == "mamba_mix":
            keys = list(MAMBA_LEAVES)
            y = md.mamba_mix(cfg, p, xd)[0]
        else:
            keys = sorted(p)
            y = model_mod.apply_block(cfg, p, xd, pos.to(dev),
                                      kind="hybrid")[0]
        grads = torch.autograd.grad(y, [p[k] for k in keys] + [xd],
                                    dy.to(dev))
        return dict(zip(["y"] + keys + ["x"], [y.detach().cpu()] + [
            g.cpu() for g in grads]))
    for which in ("mamba_mix", "hybrid_block"):
        cpu, card = run("cpu", which), run("cuda", which)
        rel = {k: float((card[k] - cpu[k]).abs().max()
                        / cpu[k].abs().max().clamp(min=1e-30))
               for k in cpu}
        worst = max(rel, key=rel.get)
        log(json.dumps({"phase": "mamba", "module": which,
                        "d_model": cfg.d_model,
                        "d_inner": cfg.ssm.expand * cfg.d_model,
                        "seq_len": MAMBA_SEQ, "tolerance": MAMBA_REL,
                        "worst": worst, "rel_diff": rel}))
        if rel[worst] > MAMBA_REL:
            raise AssertionError(f"{which}: card vs CPU {worst} differs by "
                                 f"{rel[worst]} of its largest value "
                                 f"(tolerance {MAMBA_REL})")


def check_window(torch, arch="mistral_nemo_12b"):
    """The sliding window reaches the swa main path: micro-batch 0 of step
    1 under the main path's params (its seed), one no-grad forward with
    the config's window and one with window=None; both losses finite, and
    different."""
    import dataclasses

    from repro_torch.data import make_data
    from repro_torch.models.model import init_params, loss_fn
    cfg, main = _main_config(arch), MAIN[arch]
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(main["seed"])
    params = init_params(cfg, gen)
    mb = main["global_batch"] // main["micro_batches"]
    batch = {k: torch.from_numpy(v[:mb]).to("cuda") for k, v in make_data(
        cfg, main["seq_len"], main["global_batch"],
        seed=main["seed"]).batch(0).items()}
    with torch.no_grad():
        losses = [float(loss_fn(c, params, batch)) for c in
                  (cfg, dataclasses.replace(cfg, window=None))]
    del params
    log(json.dumps({"phase": "window", "arch": cfg.name,
                    "window": cfg.window, "seq_len": main["seq_len"],
                    "micro_batch_0_loss": losses[0],
                    "micro_batch_0_loss_without_window": losses[1]}))
    if not all(math.isfinite(x) for x in losses) or losses[0] == losses[1]:
        raise AssertionError(f"{arch}: micro-batch 0's loss {losses[0]} with "
                             f"the window, {losses[1]} without: the window "
                             f"does not reach the path")


def _moe_input(torch, cfg, params, batch):
    """The input of the first MoE layer's FFN on a batch, and that layer's
    router, as the model's own no-grad forward hands them to `moe_ffn`."""
    from repro_torch.models import modules as md
    from repro_torch.models.model import loss_fn

    seen = []
    moe_ffn = md.moe_ffn

    def capture(cfg, p, x):
        if not seen:
            seen.append((x, p["router"]))
        return moe_ffn(cfg, p, x)

    md.moe_ffn = capture
    try:
        with torch.no_grad():
            loss_fn(cfg, params, batch)
    finally:
        md.moe_ffn = moe_ffn
    return seen[0]


def check_moe(torch, arch, digests, all_losses):
    """The MoE main paths' own claims. Their step-1 losses are equal bit
    for bit. Step 1 of MOE_RERUN, run again from the same seed, ends on
    the same params, m and v (digests on the card). Routing on the card:
    on micro-batch 0 of step 1 at full width, the first MoE layer's
    router top-k taken on the card, the same probs' top-k on the CPU picks
    the same ids and gates, and route_row on the card and on the CPU from
    those ids, gates and the layer's input gives the same buffers bit for
    bit and the same token and gate maps; the copies dropped past each
    expert's capacity are counted and logged. Returns rows 1-3's times at
    the arch's arena (`time_arena`)."""
    from repro_torch.configs.base import OptimizerConfig, RunConfig
    from repro_torch.data import make_data
    from repro_torch.models import modules as md
    from repro_torch.models.model import init_params
    from repro_torch.train.loop import train

    t0 = time.perf_counter()
    cfg, main = _main_config(arch), MAIN[arch]
    paths = [p for p, spec in PATHS.items() if spec[0] == arch]
    first = {p: all_losses[p][0] for p in paths}
    if len(set(first.values())) != 1:
        raise AssertionError(f"{arch}: step-1 losses {first} are not equal "
                             f"bit for bit")
    _, engine, arena, _, codecs = PATHS[MOE_RERUN]
    run = RunConfig(model=cfg,
                    optimizer=OptimizerConfig(
                        accumulation=engine, arena=arena,
                        micro_batches=main["micro_batches"],
                        m_codec=codecs[0], state_codec=codecs[1]),
                    seq_len=main["seq_len"],
                    global_batch=main["global_batch"], seed=main["seed"],
                    steps=1, log_every=1)
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(main["seed"])
    params = init_params(cfg, gen)
    held = {"leaves": _tree_leaves(params)}
    with _holding_state(held):
        out = train(run, device="cuda", log_fn=log, params=params)
    again = _digest(torch, _held_state_tensors(held))
    rerun_loss = out["losses"][0]
    held.clear()
    del out, params
    timed = time_arena(torch, arch)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(main["seed"])
    params = init_params(cfg, gen)
    mb = main["global_batch"] // main["micro_batches"]
    batch = {k: torch.from_numpy(v[:mb]).to("cuda") for k, v in make_data(
        cfg, main["seq_len"], main["global_batch"],
        seed=main["seed"]).batch(0).items()}
    x, router = _moe_input(torch, cfg, params, batch)
    del params
    mc = cfg.moe
    e, k = mc.n_experts, mc.top_k
    s = main["seq_len"]
    capacity = md.moe_capacity(mc, s)
    with torch.no_grad():
        probs = torch.softmax((x @ router.to(x.dtype)).float(), dim=-1)
        gates, ids = md.moe_top_k(probs, k)
        cpu_gates, cpu_ids = md.moe_top_k(probs.cpu(), k)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        card = md.route_row(ids, gates, x, e, capacity)
        cpu = md.route_row(ids.cpu(), gates.cpu(), x.cpu(), e, capacity)
    load = torch.stack([torch.bincount(r.reshape(-1), minlength=e)
                        for r in ids.cpu()])
    dropped = (load - capacity).clamp(min=0).sum(-1)
    filled = (card[2] != 0).sum(-1).cpu()
    same = {"top_k_ids": torch.equal(ids.cpu(), cpu_ids),
            "top_k_gates": torch.equal(
                probs.gather(-1, ids).cpu().view(torch.int32),
                cpu_gates.view(torch.int32)),
            "buf_bits": torch.equal(card[0].cpu().view(torch.int16),
                                    cpu[0].view(torch.int16)),
            "tok_slot": torch.equal(card[1].cpu(), cpu[1]),
            "gate_slot_bits": torch.equal(card[2].cpu().view(torch.int32),
                                          cpu[2].view(torch.int32)),
            "filled_slots_are_copies_kept": torch.equal(
                filled, s * k - dropped)}
    info = {"phase": "moe", "arch": cfg.name,
            "step1_losses": first, "rerun_path": MOE_RERUN,
            "rerun_step1_loss": rerun_loss,
            "step1_digest": digests[MOE_RERUN + ":step1"],
            "rerun_step1_digest": again,
            "routing": {"rows": mb, "seq_len": s, "experts": e, "top_k": k,
                        "capacity": capacity, "buf_dtype": str(x.dtype),
                        "copies_per_row": s * k,
                        "dropped_per_row": dropped.tolist(),
                        "largest_expert_load": int(load.max()),
                        "equal_card_cpu": same},
            "seconds": time.perf_counter() - t0}
    log(json.dumps(info))
    if again != digests[MOE_RERUN + ":step1"] or \
            rerun_loss != all_losses[MOE_RERUN][0]:
        raise AssertionError(f"{MOE_RERUN}: step 1 run again from seed "
                             f"{main['seed']} ends on digest {again}, loss "
                             f"{rerun_loss}; the main path on "
                             f"{digests[MOE_RERUN + ':step1']}, "
                             f"{all_losses[MOE_RERUN][0]}")
    if not all(same.values()):
        raise AssertionError(f"{arch}: routing on the card and on the CPU "
                             f"differs: {same}")
    return timed


def time_arena(torch, arch):
    """Rows 1-3 at an arch's arena (LAYOUTS[arch], recorded by its main
    paths): the MoE arch's two stacked regions (2.26e9 elements, the
    port's first arena past 2^31), the enc-dec arch's decoder and encoder
    regions and the vlm arch's one region. Each is first
    held bit for bit against its plain version on copies of the same m, v
    (and p), over the whole arena, then timed as in phase 3 (CUDA events,
    ARENA_TIMED_RUNS runs of KERNEL_REPS launches; the plain version
    ARENA_PLAIN_RUNS runs of one call) beside its bound: the whole-arena
    fold (with the fused decay) and apply, and the slice folds of
    ARENA_SLICES[arch] (layer 0 of each stacked region, the rest region)
    at their arena offsets. The plain versions work in place on chunks of
    rows, so a copy of the state is all they need beside the kernel's."""
    from repro_torch.kernels import fused_step
    layout = LAYOUTS[arch]

    def same_bits(name, label, pairs):
        for a, b in pairs:
            if not a.view(torch.uint8).equal(b.view(torch.uint8)):
                raise AssertionError(
                    f"{name} {label} at the {arch} arena: kernel != plain "
                    f"at {int((a != b).sum())} elements")
        return 0.0

    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    shape = (layout.rows, LANES)
    n = layout.rows * LANES
    m = torch.randn(shape, generator=gen, device="cuda") * 1e-3
    v = (torch.randn(shape, generator=gen, device="cuda") * 1e-6).abs()
    g = torch.randn(shape, generator=gen, device="cuda")
    mr, vr = m.clone(), v.clone()
    fold_kw = dict(beta1=0.9, beta2=0.999, scale=1.0 / 8)
    info = {"rows": layout.rows, "elements": n, "past_2^31": n > 2 ** 31}
    cases = {name: [] for name in ("arena_fold", "arena_fold_slice",
                                   "arena_apply")}
    fused_step.arena_fold(m, v, g, decay=(0.9, 0.999), **fold_kw)
    fused_step.arena_fold_ref(mr, vr, g, decay=(0.9, 0.999), **fold_kw)
    err = same_bits("arena_fold", "arena", [(m, mr), (v, vr)])
    cases["arena_fold"].append((
        "arena", err, lambda: fused_step.arena_fold(m, v, g, **fold_kw),
        lambda: fused_step.arena_fold_ref(mr, vr, g, **fold_kw),
        bound_ms(5 * 4 * n, 8 * n), {}))
    for label, region in ARENA_SLICES[arch]:
        spec = layout.rest if region is None else layout.stack(region)
        off = spec.row
        rows_g = spec.layer_rows if spec is not layout.rest else spec.rows
        kw = dict(fold_kw, block=layout.slice_block(spec))
        gs = g[:rows_g]
        # m == mr and v == vr here, so each side folds the same state; the
        # whole arenas compared hold the rows outside the slice unchanged
        fused_step.arena_fold_slice(m, v, gs, off, **kw)
        fused_step.arena_fold_slice_ref(mr, vr, gs, off, **kw)
        err = same_bits("arena_fold_slice", label, [(m, mr), (v, vr)])
        crosses = off * LANES < 2 ** 31 < (off + rows_g) * LANES
        cases["arena_fold_slice"].append((
            label, err,
            functools.partial(fused_step.arena_fold_slice, m, v, gs, off,
                              **kw),
            functools.partial(fused_step.arena_fold_slice_ref, mr, vr, gs,
                              off, **kw),
            bound_ms(5 * 4 * rows_g * LANES, 8 * rows_g * LANES),
            {"rows": rows_g, "row_offset": off,
             "crosses_element_2^31": crosses}))
        info[label + " rows"] = [off, rows_g]
    out = {}

    def run_cases(name):
        out[name] = [dict(_kernel_entry(
            name, label,
            timed_ms(torch, fn, runs=ARENA_TIMED_RUNS, reps=KERNEL_REPS),
            timed_ms(torch, plain, runs=ARENA_PLAIN_RUNS, warmup=1), bound,
            {"arena_rows": layout.rows, **shape_info},
            {"max_abs_err": err}), max_abs_err=err)
            for label, err, fn, plain, bound, shape_info in cases[name]]

    run_cases("arena_fold")
    run_cases("arena_fold_slice")
    # the timed calls hold g (its slices), mr and vr: drop them, and the
    # loop's last slice, before p and its copy take their place
    cases["arena_fold"].clear()
    cases["arena_fold_slice"].clear()
    del g, gs, mr, vr
    torch.cuda.empty_cache()
    p = torch.randn(shape, generator=gen, device="cuda") * 0.02
    pr = p.clone()
    apply_kw = dict(lr=1e-3, bc1=0.1, bc2=0.001, eps=1e-8)
    fused_step.arena_apply(p, m, v, **apply_kw)
    fused_step.arena_apply_ref(pr, m, v, **apply_kw)
    err = same_bits("arena_apply", "arena", [(p, pr)])
    cases["arena_apply"].append((
        "arena", err, lambda: fused_step.arena_apply(p, m, v, **apply_kw),
        lambda: fused_step.arena_apply_ref(pr, m, v, **apply_kw),
        bound_ms(4 * 4 * n, 7 * n), {}))
    run_cases("arena_apply")
    if not all(bool(torch.isfinite(x).all()) for x in (m, v, p, pr)):
        raise AssertionError(f"{arch} arena: non-finite state after the "
                             f"timed runs")
    log(json.dumps({"phase": "arena_kernels", "arch": arch, **info,
                    "bit_for_bit": {k: [e["case"] for e in x]
                                    for k, x in out.items()}}))
    del m, v, p, pr
    torch.cuda.empty_cache()
    return out


def _expected_launches(path, tree):
    """Launches per step that a path's schedule makes, derived from the
    param tree: N micro-batches, L layers over the stacked regions (an MoE
    model's dense_blocks too), the stacked block leaves and the rest leaves
    (the layer-wise arena path folds L layer slices and one rest slice per
    micro-batch). An rwkv6 model runs one forward scan per layer and
    micro-batch (two in the layer-wise path: the no-grad forward and the
    recompute) and one backward scan."""
    from repro_torch.core.arena import STACK_KEYS
    arch, engine, arena, _, _ = PATHS[path]
    n = MAIN[arch]["micro_batches"]
    stacks = [tree[k] for k in STACK_KEYS if k in tree]
    depths = [next(iter(st.values())).shape[0] for st in stacks]
    n_layers = sum(depths)
    n_rest = len(tree) - len(stacks)
    n_leaves = n_rest + sum(len(st) for st in stacks)
    # per-leaf layer-wise: one fold per stacked leaf and layer
    n_layer_leaves = sum(len(st) * d for st, d in zip(stacks, depths))
    want = {k: 0 for k in KERNELS}
    if path in GUARDED:
        # one flag per fold (adama), per step (ga); the layer-wise engine's
        # per slab and per tensor its pre-backward guard checks (dx and the
        # head's gradients: every rest leaf but the embedding)
        want["finite_and"] = {"adama": n, "ga": 1}.get(
            engine, n * (n_layers + 1) + n * (1 + n_rest - 1))
    if path in FP8:
        # the encode ANDs each slab's flag: finite_and is left to the
        # layer-wise pre-backward guard
        slabs = n if engine == "adama" else n * (n_layers + 1)
        want["fp8_encode"] = want["fp8_ef_update"] = slabs
        want["finite_and"] = 0 if engine == "adama" else n * n_rest
    if arena:
        want["arena_apply"] = 1
        if engine == "adama":
            want["arena_fold"] = n
        elif engine == "ga":
            want["arena_fold"] = 1
        else:
            want["arena_fold_slice"] = n * (n_layers + 1)
    else:
        want["adam_apply_2d"] = n_leaves
        want["adama_accum_2d"] = n * (n_leaves if engine == "adama" else
                                      n_layer_leaves + n_rest)
    if arch == "rwkv6_7b":
        recompute = 2 if engine == "adama_layerwise" else 1
        want["rwkv6_chunk_scan"] = recompute * n * n_layers
        want["rwkv6_chunk_scan_bwd"] = n * n_layers
    return want


# the init's scale of lm_head (models/model.py `_dense`)
HEAD_INIT_STD = 0.02


def first_step_loss(cfg):
    """The cross entropy a freshly initialised model starts near: the
    final norm leaves each position's features at unit mean square, so
    each logit is a sum of d_model products with lm_head's N(0, 0.02^2)
    weights, N(0, d_model x 0.02^2), and the expected logsumexp over the
    V_pad logits is ln(V_pad) + that variance / 2 (the gold logit's mean
    is 0). The variance term is 0.05 at d_model 512 and 1.23 at 6144."""
    return (math.log(cfg.padded_vocab())
            + cfg.d_model * HEAD_INIT_STD ** 2 / 2)


def _main_config(arch):
    import dataclasses

    from repro_torch.configs.base import get_config
    cfg = get_config(arch)
    if "num_layers" in MAIN[arch]:
        cfg = dataclasses.replace(cfg, num_layers=MAIN[arch]["num_layers"])
    return cfg


def _engine_twins(p, q):
    """Two paths that differ only in adama vs adama_layerwise, on arena
    state with the same codecs and the same guard and fault: their losses
    agree every step, the codecs' state included (measured: bit for bit on
    bert-large and stablelm-1.6b, within 6e-6 relative on rwkv6-7b)."""
    a, b = PATHS[p], PATHS[q]
    return ({a[1], b[1]} == {"adama", "adama_layerwise"} and a[2] and b[2]
            and a[0] == b[0] and a[4] == b[4]
            and GUARDED.get(p, (0,))[0] == GUARDED.get(q, (0,))[0]
            and WIRE.get(p) == WIRE.get(q) and FP8.get(p) == FP8.get(q)
            and (p in MASTER) == (q in MASTER))


def _after_steps(actions):
    """A train() step_context that runs each action(i) once step i (0-based)
    has ended and been timed."""
    @contextlib.contextmanager
    def ctx(i):
        yield
        for action in actions:
            action(i)
    return ctx


@contextlib.contextmanager
def _holding_state(held):
    """While a path runs, every arena state the engines initialise is also
    kept in held["state"] (the master and the cache are updated in place, so
    a step_context action reads them after each step)."""
    from repro_torch.core import adama
    init = adama.init_arena

    def keep(*a, **kw):
        held["state"] = init(*a, **kw)
        return held["state"]
    adama.init_arena = keep
    try:
        yield
    finally:
        adama.init_arena = init


def _held_state_tensors(held):
    """The tensors `_state_tensors` covers, read while a path runs: its
    param leaves and the arena state `_holding_state` keeps."""
    return held["leaves"] + _moment_tensors(held["state"])


def _master_leaves(state):
    """The master region's values as leaves (fp32, sorted paths, views of
    the arena where contiguous): what the param leaves would hold without
    the bf16 cast."""
    from repro_torch.core import arena as arena_mod
    return _tree_leaves(arena_mod.unpack(state["p"].data, state["p"].layout))


def _check_master_step(torch, path, i, leaves, state):
    """After step i of a master path: every param leaf is exactly
    bf16(master), and the cache, where there is one, holds bf16(master)
    too (so the leaves equal its upcast)."""
    bf16 = torch.bfloat16
    for k, (leaf, x) in enumerate(zip(leaves, _master_leaves(state))):
        if not leaf.detach().equal(x.to(bf16).float()):
            raise AssertionError(f"{path}: after step {i + 1} param leaf {k} "
                                 f"is not bf16(master)")
    if "wp" in state:
        p, wp = state["p"].data, state["wp"].data
        for lo in range(0, p.shape[0], 1 << 16):
            if not wp[lo:lo + (1 << 16)].view(torch.int16).equal(
                    p[lo:lo + (1 << 16)].to(bf16).view(torch.int16)):
                raise AssertionError(f"{path}: after step {i + 1} the cache "
                                     f"is not bf16(master)")


def _work_bytes_per_apply(torch, state):
    """One more master apply on a path's final state (lr 0, after its
    launches were read): the bytes it allocates for its work output (0
    when the kernel writes into the cache), after checking that with a
    cache the work it returns is the cache."""
    from repro_torch.core import state_store
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    work, _ = state_store.apply_master_state(state, lr=0.0, bc1=0.19,
                                             bc2=0.001999)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - before
    if "wp" in state and (work.data_ptr() != state["wp"].data.data_ptr()
                          or extra):
        raise AssertionError(f"the cached master apply allocated {extra} B "
                             f"or wrote its work elsewhere than the cache")
    del work
    return extra


def _check_master_path(path, peak, peaks, counts, regions, info):
    """A master path against its twin (MASTER): the same launches per step,
    its new regions' bytes, and a peak at most the twin's + those bytes +
    MASTER_PEAK_SLACK. Returns what is logged."""
    cache, wire, twin = MASTER[path]
    want = dict(p=MASTER_REGION_BYTES["p"],
                **({"wp": MASTER_REGION_BYTES["wp"]} if cache else {}))
    if regions != want:
        raise AssertionError(f"{path}: master regions {regions} B; expected "
                             f"{want}")
    added = sum(_allocator_bytes(b) for b in regions.values())
    info.update({"work_param_cache": cache, "grad_dtype": wire,
                 "master_twin": twin, "master_twin_peak": peaks[twin],
                 "region_bytes": regions, "region_allocator_bytes": added,
                 "peak_minus_master_twin": peak - peaks[twin],
                 "peak_minus_master_twin_minus_regions":
                     peak - peaks[twin] - sum(regions.values())})
    if peak > peaks[twin] + added + MASTER_PEAK_SLACK:
        raise AssertionError(f"{path}: peak {peak} is more than "
                             f"{MASTER_PEAK_SLACK} B above {twin}'s "
                             f"{peaks[twin]} + its regions' {added} B (as "
                             f"allocated)")
    per_step = {p: {k: c / PATHS[p][3] for k, c in counts[p].items()}
                for p in (path, twin)}
    if per_step[path] != per_step[twin]:
        raise AssertionError(f"{path}: launches per step {per_step[path]} "
                             f"!= {twin}'s {per_step[twin]}")
    return info


def _param_diff(torch, leaves, host_leaves, chunk=1 << 26):
    """Leaves on the card against copies on the host, compared on the card
    a chunk at a time (64 Mi elements: 256 MiB, far below any path's peak
    between two steps): (largest |a - b|, elements beyond SMALL_PARAM_TOL,
    elements)."""
    worst, beyond, total = 0.0, 0, 0
    for a, b in zip(leaves, host_leaves):
        a, b = a.detach().reshape(-1), b.reshape(-1)
        for lo in range(0, a.numel(), chunk):
            d = (a[lo:lo + chunk] - b[lo:lo + chunk].to(a.device)).abs()
            worst = max(worst, float(d.max()))
            beyond += int((d > SMALL_PARAM_TOL).sum())
            total += d.numel()
    return worst, beyond, total


def _wire_tolerance(codecs, lr, field="bf16_wire_lr"):
    """Params after one step, a narrower wire against the fp32 wire: the
    pair's declared drift for it (`field`: bf16_wire_lr or fp8_wire_lr,
    summed over its codecs, as the reference's
    tests/test_codec_conformance.py sums them) x lr."""
    from repro_torch.core import state_store
    return lr * sum(getattr(state_store.get_codec(name, moment).conformance,
                            field) for moment, name in zip(("m", "v"), codecs))


def _check_wire_path(path, out, peak, counts, all_losses, peaks, diff, tol):
    """A bf16-wire path against its fp32-wire twin (WIRE); returns what is
    logged."""
    loss_scale, twin = WIRE[path]
    info = {"grad_dtype": "bf16", "loss_scale_config": loss_scale,
            "wire_twin": twin, "wire_twin_peak": peaks[twin],
            "peak_minus_wire_twin": peak - peaks[twin],
            "step1_loss": out["losses"][0],
            "wire_twin_step1_loss": all_losses[twin][0],
            "params_after_step_1_max_abs_diff": diff[0],
            "params_after_step_1_tolerance": tol,
            "params_after_step_1_share_beyond": diff[1] / diff[2],
            "share_beyond_limit": SMALL_PARAM_TOL,
            "share_tolerance": CODE_FLIP_FRAC,
            "metrics": out["metrics"]}
    if peak > peaks[twin] + WIRE_PEAK_SLACK:
        raise AssertionError(f"{path}: peak {peak} is more than "
                             f"{WIRE_PEAK_SLACK} B above {twin}'s "
                             f"{peaks[twin]}")
    per_step = {p: {k: c / PATHS[p][3] for k, c in counts[p].items()}
                for p in (path, twin)}
    if per_step[path] != per_step[twin]:
        raise AssertionError(f"{path}: launches per step {per_step[path]} "
                             f"!= {twin}'s {per_step[twin]}")
    if out["losses"][0] != all_losses[twin][0]:
        raise AssertionError(f"{path}: step-1 loss {out['losses'][0]} != "
                             f"{twin}'s {all_losses[twin][0]}")
    if not diff[0] <= tol:
        raise AssertionError(f"{path}: params after step 1 differ from "
                             f"{twin}'s by up to {diff[0]} (tolerance {tol})")
    if not diff[1] <= CODE_FLIP_FRAC * diff[2]:
        raise AssertionError(f"{path}: {diff[1]} of {diff[2]} params after "
                             f"step 1 differ from {twin}'s by more than "
                             f"{SMALL_PARAM_TOL}")
    want = WIRE_LOSS_SCALE.get(path)
    if want is not None and out["metrics"].get("loss_scale") != want:
        raise AssertionError(f"{path}: loss scale "
                             f"{out['metrics'].get('loss_scale')} != {want}")
    return info


def _fp8_param_diff(torch, leaves, twin_leaves, initial, lr,
                    chunk=1 << 26):
    """An fp8 path's params after step 1 against its twin's and the initial
    params (host copies), on the card a chunk at a time: (largest |p -
    twin|, params whose twin update |twin - p0| exceeds lr / 2, of those
    the ones whose update p - p0 has the twin's sign)."""
    worst, big, agree = 0.0, 0, 0
    for a, b, c in zip(leaves, twin_leaves, initial):
        a = a.detach().reshape(-1)
        b, c = b.reshape(-1), c.reshape(-1)
        for lo in range(0, a.numel(), chunk):
            p = a[lo:lo + chunk]
            t = b[lo:lo + chunk].to(p.device)
            p0 = c[lo:lo + chunk].to(p.device)
            worst = max(worst, float((p - t).abs().max()))
            u, ut = p - p0, t - p0
            mask = ut.abs() > lr / 2
            big += int(mask.sum())
            agree += int((mask & (torch.sign(u) == torch.sign(ut))).sum())
    return worst, big, agree


def _check_fp8_path(torch, path, out, peaks, counts, all_losses, diff,
                    tol):
    """An fp8-wire path against its fp32-wire twin (FP8); returns what is
    logged."""
    from repro_torch.core import state_store
    loss_scale, twin = FP8[path]
    engine = PATHS[path][1]
    state = out["opt_state"]
    regions = state_store.wire_region_bytes(state)
    ef = state["ef"].data
    finite, nonzero = bool(torch.isfinite(ef).all()), bool((ef != 0).any())
    added = {"ef": _allocator_bytes(FP8_EF_BYTES),
             "codes": _allocator_bytes(FP8_CODES_BYTES[engine]),
             "slack": FP8_PEAK_SLACK}
    info = {"grad_dtype": "fp8_e4m3", "loss_scale_config": loss_scale,
            "fp8_twin": twin, "fp8_twin_peak": peaks[twin],
            "peak_minus_fp8_twin": peaks[path] - peaks[twin],
            "peak_limit_terms": added, "region_bytes": regions,
            "ef_finite": finite, "ef_nonzero": nonzero,
            "step1_loss": out["losses"][0],
            "fp8_twin_step1_loss": all_losses[twin][0],
            "params_after_step_1_max_abs_diff": diff[0],
            "params_after_step_1_tolerance": tol,
            "twin_updates_beyond_half_lr": diff[1],
            "update_sign_agreement": diff[2] / max(diff[1], 1),
            "sign_share_limit": FP8_SIGN_SHARE, "metrics": out["metrics"]}
    log(json.dumps({"phase": "fp8_peak", "path": path, "peak": peaks[path],
                    "twin_peak": peaks[twin], **added,
                    "limit": peaks[twin] + sum(added.values())}))
    if regions != {"ef": FP8_EF_BYTES}:
        raise AssertionError(f"{path}: residual regions {regions} B; "
                             f"expected {FP8_EF_BYTES}")
    if not (finite and nonzero):
        raise AssertionError(f"{path}: the residual is not finite or is all "
                             f"zero (finite {finite}, non-zero {nonzero})")
    if peaks[path] > peaks[twin] + sum(added.values()):
        raise AssertionError(f"{path}: peak {peaks[path]} is more than "
                             f"{twin}'s {peaks[twin]} + {added}")
    if out["losses"][0] != all_losses[twin][0]:
        raise AssertionError(f"{path}: step-1 loss {out['losses'][0]} != "
                             f"{twin}'s {all_losses[twin][0]}")
    if not diff[0] <= tol:
        raise AssertionError(f"{path}: params after step 1 differ from "
                             f"{twin}'s by up to {diff[0]} (tolerance {tol})")
    if not diff[2] >= FP8_SIGN_SHARE * diff[1] or not diff[1]:
        raise AssertionError(f"{path}: the step-1 update has the sign of "
                             f"{twin}'s on {diff[2]} of the {diff[1]} params "
                             f"whose twin update exceeds lr / 2 (at least "
                             f"{FP8_SIGN_SHARE} required)")
    want = FP8_LOSS_SCALE.get(path)
    if want is not None and out["metrics"].get("loss_scale") != want:
        raise AssertionError(f"{path}: loss scale "
                             f"{out['metrics'].get('loss_scale')} != {want}")
    return info


def run_main_paths(torch, wrappers, arch):
    """Phase 5: one arch at full width, each of its main paths; returns
    each path's launch counts per kernel and peak memory, the bytes a
    master path's apply allocates for its work, the digests taken (the
    guard's claims and the remat phase's twins), each path's losses and
    the model's parameter count. Every arena path must have the arch's
    arena rows."""
    from repro_torch.configs.base import OptimizerConfig, RunConfig
    from repro_torch.core import arena as arena_mod
    from repro_torch.core import state_store
    from repro_torch.train.loop import train

    from repro_torch.models.model import init_params

    cfg = _main_config(arch)
    main = MAIN[arch]
    expected = first_step_loss(cfg)
    counts, peaks, all_losses, digests = {}, {}, {}, {}
    work_bytes, n_params_by_path = {}, {}
    paths = [p for p, spec in PATHS.items() if spec[0] == arch]
    digested = {p for d in GUARD_DIGESTS for p in d[:2]} | {
        base for base, _, seq, _, _ in REMAT.values() if seq is None}
    # params after step 1 of each bf16- or fp8-wire path's twin, on the
    # host: step1[twin] is the digest of its params then, snaps[digest] one
    # host copy of each distinct set (the guarded twins' step-1 params are
    # their unguarded twins', bit for bit: two copies on stablelm-1.6b)
    wire_twins = {twin for _, twin in (*WIRE.values(), *FP8.values())}
    step1, snaps = {}, {}
    # the fp8 paths' initial params on the host (the same seed for every
    # path), for the sign of their step-1 update
    initial = {}
    # a master path without the cache runs its twin's step 1 (the same
    # fp32 leaves, the same wire): its master after step 1 is the twin's
    # params then, held by digests on the card
    master_twins = {twin: p for p, (cache, _, twin) in MASTER.items()
                    if not cache}
    step1_digest = {}
    for path in paths:
        _, engine, arena, steps, codecs = PATHS[path]
        fault, twin = GUARDED.get(path, (None, None))
        loss_scale = (WIRE.get(path) or FP8.get(path) or ("off",))[0]
        cache, master_wire, _ = MASTER.get(path, (False, "fp32", None))
        bf16_wire = path in WIRE or master_wire == "bf16"
        run = RunConfig(model=cfg,
                        optimizer=OptimizerConfig(
                            accumulation=engine, arena=arena,
                            micro_batches=main["micro_batches"],
                            m_codec=codecs[0], state_codec=codecs[1],
                            grad_dtype=("fp8_e4m3" if path in FP8 else
                                        "bf16" if bf16_wire else "fp32"),
                            master_params=path in MASTER,
                            work_param_cache=cache,
                            finite_guard=path in GUARDED,
                            loss_scale=loss_scale),
                        seq_len=main["seq_len"],
                        global_batch=main["global_batch"],
                        seed=main["seed"], steps=steps, log_every=1,
                        remat=main.get("remat", False), inject_fault=fault)
        torch.cuda.empty_cache()
        params, before, packed, diff = None, None, None, []
        if (engine == "ga" and path in GUARDED) or path in WIRE or \
                path in wire_twins or path in MASTER or \
                path in master_twins or path in FP8 or path == MOE_RERUN \
                or (arch == DP_ARCH and path in DP_TWINS):
            # the params train() would make, which it updates in place
            gen = torch.Generator(device="cuda")
            gen.manual_seed(main["seed"])
            params = init_params(cfg, gen)
        if engine == "ga" and path in GUARDED:
            # every step skips: the leaves stay, or with master params
            # become bf16 of themselves, the master pack(initial params)
            # (no name may keep the leaves past the run: the next path's
            # peak would count them)
            before = _digest(torch, _tree_leaves(params)
                             if path not in MASTER else (
                                 x.detach().to(torch.bfloat16).float()
                                 for x in _tree_leaves(params)))
            if path in MASTER:
                packed = _digest(torch, [arena_mod.pack(
                    params, arena_mod.build_layout(params))])
        # the param leaves (and a master path's state), for the actions
        # after each step; cleared after the run
        held = {"leaves": _tree_leaves(params) if params else None}
        actions = []
        if path in wire_twins:
            def snapshot(i, path=path):
                if i == 0:
                    d = step1[path] = _digest(torch, held["leaves"])
                    if d not in snaps:
                        snaps[d] = [x.detach().to("cpu", copy=True)
                                    for x in held["leaves"]]
            actions.append(snapshot)
        elif path in WIRE:
            def compare(i, twin=WIRE[path][1]):
                if i == 0:
                    diff.append(_param_diff(torch, held["leaves"],
                                            snaps[step1[twin]]))
            actions.append(compare)
        elif path in FP8:
            d0 = _digest(torch, held["leaves"])
            if d0 not in initial:
                initial.clear()
                initial[d0] = [x.detach().to("cpu", copy=True)
                               for x in held["leaves"]]

            def compare_fp8(i, twin=FP8[path][1], d0=d0,
                            lr=run.optimizer.lr):
                if i == 0:
                    diff.append(_fp8_param_diff(
                        torch, held["leaves"], snaps[step1[twin]],
                        initial[d0], lr))
            actions.append(compare_fp8)
        if path in master_twins:
            def twin_digest(i, path=path):
                if i == 0:
                    step1_digest[path] = _digest(torch, held["leaves"])
            actions.append(twin_digest)
        if path == MOE_RERUN:
            def rerun_digest(i, path=path):
                if i == 0:
                    digests[path + ":step1"] = _digest(
                        torch, _held_state_tensors(held))
            actions.append(rerun_digest)
        if arch == DP_ARCH and path in DP_TWINS:
            def dp_digest(i, path=path):
                if i == DP_STEPS - 1:
                    digests[f"{path}:step{DP_STEPS}"] = _digest(
                        torch, _held_state_tensors(held))
            actions.append(dp_digest)
        if path in MASTER:
            def master_step(i, path=path):
                _check_master_step(torch, path, i, held["leaves"],
                                   held["state"])
                if i == 0 and not MASTER[path][0]:
                    step1_digest[path] = _digest(
                        torch, _master_leaves(held["state"]))
            actions.append(master_step)
        torch.cuda.reset_peak_memory_stats()
        for fn in wrappers.values():
            fn.launches = 0
        with (_holding_state(held)
              if path in MASTER or path == MOE_RERUN or
              (arch == DP_ARCH and path in DP_TWINS)
              else contextlib.nullcontext()):
            out = train(run, device="cuda", log_fn=log, params=params,
                        step_context=_after_steps(actions) if actions
                        else None)
        counts[path] = {k: fn.launches for k, fn in wrappers.items()}
        peaks[path] = torch.cuda.max_memory_allocated()
        REQUESTED_PEAKS[path] = _requested_peak(torch)
        # drop every reference to the param leaves, or the next path's
        # peak would count them
        held.clear()
        del params
        if path in digested:
            digests[path] = _digest(torch, _state_tensors(out))
        guard_info = {}
        if path in GUARDED:
            skipped = out["metrics"]["skipped_micro_batches"]
            guard_info = {"fault": fault, "twin": twin,
                          "skipped_micro_batches": skipped,
                          "final_step": out["opt_state"]["step"],
                          "twin_peak": peaks.get(twin)}
            if (skipped, out["opt_state"]["step"]) != GUARD_SKIPS[path]:
                raise AssertionError(
                    f"{path}: skipped {skipped}, step "
                    f"{out['opt_state']['step']}; expected "
                    f"{GUARD_SKIPS[path]}")
            if path not in MASTER and path not in FP8 and \
                    peaks[path] > peaks[twin] + GUARD_PEAK_SLACK:
                raise AssertionError(
                    f"{path}: peak {peaks[path]} is more than "
                    f"{GUARD_PEAK_SLACK} B above {twin}'s {peaks[twin]}")
            if before is not None:
                after = _digest(torch, _tree_leaves(out["params"]))
                guard_info["params_unchanged"] = after == before
                if after != before:
                    raise AssertionError(
                        f"{path}: the params changed; every step was "
                        f"skipped" + (", so they must be bf16 of the "
                                      "initial params" if path in MASTER
                                      else ""))
            if packed is not None:
                master = _digest(torch, [out["opt_state"]["p"].data])
                guard_info["master_unchanged"] = master == packed
                if master != packed:
                    raise AssertionError(f"{path}: the master is not "
                                         f"pack(initial params); every step "
                                         f"was skipped")
        master_info = {}
        if path in MASTER:
            state = out["opt_state"]
            work_bytes[path] = _work_bytes_per_apply(torch, state)
            master_info = _check_master_path(
                path, peaks[path], peaks, counts,
                state_store.param_region_bytes(state),
                {"work_bytes_allocated_per_apply": work_bytes[path]})
            twin = MASTER[path][2]
            if not MASTER[path][0]:
                master_info.update(
                    step1_loss=out["losses"][0],
                    master_twin_step1_loss=all_losses[twin][0],
                    master_after_step_1_digest=step1_digest[path],
                    twin_params_after_step_1_digest=step1_digest[twin])
                if out["losses"][0] != all_losses[twin][0]:
                    raise AssertionError(f"{path}: step-1 loss "
                                         f"{out['losses'][0]} != {twin}'s "
                                         f"{all_losses[twin][0]}")
                if step1_digest[path] != step1_digest[twin]:
                    raise AssertionError(f"{path}: the master after step 1 "
                                         f"is not {twin}'s params after "
                                         f"step 1 bit for bit")
            del state
        wire_info = {}
        if path in WIRE:
            wire_info = _check_wire_path(
                path, out, peaks[path], counts, all_losses, peaks, diff[0],
                _wire_tolerance(codecs, run.optimizer.lr))
        fp8_info = {}
        if path in FP8:
            fp8_info = _check_fp8_path(
                torch, path, out, peaks, counts, all_losses, diff[0],
                _wire_tolerance(codecs, run.optimizer.lr, "fp8_wire_lr"))
        n_params = sum(x.numel() for x in out["model"].parameters())
        n_params_by_path[path] = n_params
        state = out["opt_state"]
        rows = state["m"].layout.rows if arena else None
        if arena:
            LAYOUTS.setdefault(arch, state["m"].layout)
        state_bytes = (state_store.optimizer_state_bytes(state) if arena
                       else None)
        want = _expected_launches(path, out["params"])
        log(json.dumps({"phase": "main_path", "path": path, "engine": engine,
                        "arena": arena, "m_codec": codecs[0],
                        "v_codec": codecs[1], "state_bytes": state_bytes,
                        "arch": cfg.name,
                        "num_layers": cfg.num_layers, "params": n_params,
                        "arena_rows": rows, "steps": steps,
                        "losses": out["losses"],
                        "step_seconds": out["step_seconds"],
                        "max_memory_allocated_bytes": peaks[path],
                        "requested_peak_bytes": REQUESTED_PEAKS[path],
                        "launches": counts[path],
                        "launches_per_step": want,
                        "expected_step1_loss": expected, **guard_info,
                        **wire_info, **master_info, **fp8_info,
                        "digest": digests.get(path), **main}))
        losses = out["losses"]
        all_losses[path] = losses
        first = all_losses[paths[0]][0]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{path}: non-finite loss {losses}")
        if abs(losses[0] - expected) > 0.1 * expected:
            raise AssertionError(f"{path}: step-1 loss {losses[0]} is not "
                                 f"within 10% of ln(V) + d_model x "
                                 f"{HEAD_INIT_STD}^2 / 2 = {expected:.4f}")
        if abs(losses[0] - first) > 1e-4 * first:
            raise AssertionError(f"{path}: step-1 loss {losses[0]} differs "
                                 f"from {paths[0]}'s {first}")
        twin = next((p for p in paths if p in all_losses and p != path
                     and _engine_twins(p, path)), None)
        if twin and any(abs(a - b) > 1e-4 * abs(b)
                        for a, b in zip(losses, all_losses[twin])):
            raise AssertionError(f"{path}: losses {losses} differ from "
                                 f"{twin}'s {all_losses[twin]} (Algorithms "
                                 f"1 and 2 on the same state)")
        want = {k: c * steps for k, c in want.items()}
        if counts[path] != want:
            raise AssertionError(f"{path}: kernel launches {counts[path]} "
                                 f"!= {want}")
        if arena and (rows != main["arena_rows"] or rows * LANES < n_params):
            raise AssertionError(f"{path}: arena rows {rows} != "
                                 f"{main['arena_rows']} or too few for "
                                 f"{n_params} params")
        if arena and state_bytes != _codec_bytes(*codecs, rows):
            raise AssertionError(f"{path}: state bytes {state_bytes} != "
                                 f"{_codec_bytes(*codecs, rows)}")
        del out, state
    for a, b, equal in GUARD_DIGESTS:
        if a in digests and (digests[a] == digests[b]) != equal:
            raise AssertionError(f"{a} and {b}: params, m and v are "
                                 f"{'not ' if equal else ''}bit for bit "
                                 f"equal (digests {digests[a]}, "
                                 f"{digests[b]})")
    if any(a in digests for a, _, _ in GUARD_DIGESTS):
        log(json.dumps({"phase": "guard", "arch": arch,
                        "digest_claims": [[a, b, "equal" if e else "differ"]
                                          for a, b, e in GUARD_DIGESTS],
                        "met": True}))
    if len(set(n_params_by_path.values())) != 1:
        raise AssertionError(f"{arch}: parameter counts differ between "
                             f"paths: {n_params_by_path}")
    return (counts, peaks, work_bytes, digests, all_losses,
            n_params_by_path[paths[0]])


def _requested_peak(torch) -> int:
    """The peak since the last reset of the bytes the program's tensors
    asked for (`requested_bytes.all.peak`): max_memory_allocated less the
    caching allocator's slack, up to 1 MiB a block, where it hands a
    request a free block too small to split (its 512-B rounding aside)."""
    return torch.cuda.memory_stats()["requested_bytes.all.peak"]


# each main and remat path's _requested_peak, by path
REQUESTED_PEAKS = {}


def check_remat_memory(arch, peaks, ga, adama, lw=None, info=None,
                       arena_rows=None, n_params=None):
    """ga + remat (path `ga`) peaks at least one fp32 arena (of
    `arena_rows`, by default the arch's main paths') above adama + remat
    (`adama`) and at most that arena as allocated + REMAT_GAP_SLACK above
    it; Algorithm 2 (`lw`), where given, below adama + remat, and where
    MAIN[arch]["layerwise_gap"] is "gradient" at least the whole-model
    fp32 gradient (`n_params` x 4 B) below it. The gap
    between ga and adama is taken between the bytes their tensors request
    at the peak (REQUESTED_PEAKS): the allocator's slack at the two peaks
    differs by up to MiBs with the order of their allocations (hymba-1.5b:
    its scan's tensors of S and S + 1 steps reuse each other's blocks).
    Logs both gaps with `info`."""
    arena_bytes = (arena_rows or MAIN[arch]["arena_rows"]) * LANES * 4
    limit = _allocator_bytes(arena_bytes) + REMAT_GAP_SLACK
    gap = REQUESTED_PEAKS[ga] - REQUESTED_PEAKS[adama]
    info = dict(info or {}, phase="remat_memory", arch=arch,
                arena_bytes=arena_bytes, ga_minus_adama=gap,
                ga_minus_adama_allocated=peaks[ga] - peaks[adama],
                ga_minus_adama_limit=limit,
                requested_peaks={p: REQUESTED_PEAKS[p]
                                 for p in (ga, adama, lw) if p})
    lw_limit = (n_params * 4 if lw and MAIN.get(arch, {}).get(
        "layerwise_gap") == "gradient" else None)
    if lw:
        info["adama_minus_adama_layerwise"] = peaks[adama] - peaks[lw]
        info["adama_minus_adama_layerwise_limit"] = lw_limit
        info["adama_minus_adama_layerwise_at_least_one_arena"] = (
            peaks[adama] - peaks[lw] >= arena_bytes)
    log(json.dumps(info))
    if gap < arena_bytes:
        raise AssertionError(f"{arch}: {adama}'s requested peak is only "
                             f"{gap} B below {ga}'s; expected at least one "
                             f"fp32 arena ({arena_bytes} B)")
    if gap > limit:
        raise AssertionError(f"{arch}: {ga}'s requested peak is {gap} B "
                             f"above {adama}'s; expected at most one fp32 "
                             f"arena as allocated + {REMAT_GAP_SLACK} B "
                             f"({limit} B)")
    # Algorithm 2 never holds the gradient tree, but with long sequences
    # both engines' peaks lie in the backward's activations: adama + remat
    # at layer 0's recompute with the layers' gradients, Algorithm 2 in a
    # layer's recompute or the head's cross-entropy backward, which both
    # run. The gap is below one arena there (launch/memory_split.py
    # --peak-sites shows the sites), so the claim is that Algorithm 2
    # peaks lower
    if lw and peaks[lw] >= peaks[adama]:
        raise AssertionError(f"{arch}: {lw}'s peak {peaks[lw]} is not "
                             f"below {adama}'s {peaks[adama]}")
    if lw_limit is not None and peaks[adama] - peaks[lw] < lw_limit:
        raise AssertionError(f"{arch}: {lw}'s peak {peaks[lw]} is only "
                             f"{peaks[adama] - peaks[lw]} B below {adama}'s; "
                             f"expected at least the fp32 gradient "
                             f"({lw_limit} B)")


def check_memory(arch, peaks, n_params):
    """ga peaks at least one fp32 arena (its accumulator) above adama, and
    Algorithm 2 at least two below Algorithm 1 (no whole-model gradient
    and its packed copy), or, where MAIN[arch]["layerwise_gap"] is
    "gradient", at least the whole-model fp32 gradient, `n_params` (the
    model the paths built) x 4 B: there Algorithm 2 peaks at the apply's
    pack of the params, adama at its gradient's pack, so the gap is the
    gradient tree; a path with compressed state
    peaks below the same engine's fp32 path by at least the state bytes it
    saves. An arch whose main paths run ga and adama with remat is held to
    check_remat_memory's claims instead."""
    path = {spec[1]: p for p, spec in PATHS.items()
            if spec[0] == arch and spec[2] and spec[4] == FP32
            and p not in GUARDED and p not in WIRE and p not in MASTER}
    if MAIN[arch].get("remat"):
        check_remat_memory(arch, peaks, path["ga"], path["adama"],
                           path["adama_layerwise"], {"peaks": peaks},
                           n_params=n_params)
        return
    adama, ga, lw = (peaks[path[e]] for e in ("adama", "ga",
                                              "adama_layerwise"))
    arena_bytes = MAIN[arch]["arena_rows"] * LANES * 4
    gap = MAIN[arch].get("layerwise_gap", "two arenas")
    lw_limit, lw_what = {"gradient": (n_params * 4, "the fp32 gradient"),
                         "two arenas": (2 * arena_bytes,
                                        "two fp32 arenas")}[gap]
    log(json.dumps({"phase": "memory", "arch": arch, "peaks": peaks,
                    "ga_minus_adama": ga - adama,
                    "adama_minus_adama_layerwise": adama - lw,
                    "arena_bytes": arena_bytes, "params": n_params,
                    "adama_minus_adama_layerwise_limit": lw_limit,
                    "adama_minus_adama_layerwise_limit_is": lw_what,
                    "adama_minus_adama_layerwise_at_least_one_arena":
                        adama - lw >= arena_bytes}))
    if ga - adama < arena_bytes:
        raise AssertionError(f"{arch}: adama's peak {adama} is only "
                             f"{ga - adama} B below ga's {ga}; expected at "
                             f"least one fp32 arena ({arena_bytes} B)")
    if adama - lw < lw_limit:
        raise AssertionError(f"{arch}: adama_layerwise's peak {lw} is only "
                             f"{adama - lw} B below adama's {adama}; "
                             f"expected at least {lw_what} ({lw_limit} B)")
    rows = MAIN[arch]["arena_rows"]
    for p, (a, engine, arena, _, codecs) in PATHS.items():
        if a != arch or codecs == FP32 or p in GUARDED or p in WIRE or \
                p in MASTER:
            continue
        base = path[engine]
        saved = _codec_bytes(*FP32, rows) - _codec_bytes(*codecs, rows)
        gap = peaks[base] - peaks[p]
        log(json.dumps({"phase": "memory", "arch": arch, "path": p,
                        "fp32_path": base, "peak_gap": gap,
                        "state_bytes_saved": saved}))
        if gap < saved:
            raise AssertionError(f"{p}: peak {peaks[p]} is only {gap} B "
                                 f"below {base}'s {peaks[base]}; the "
                                 f"{codecs[0]}/{codecs[1]} state saves "
                                 f"{saved} B")


def _codec_forms(name, checked, timed, counts):
    """The `kernels` line's codec forms of one kernel: every pair checked
    bit for bit on the small arena; the timed pairs' numbers at the
    stablelm arena (their differences from the plain version measured
    there) and their launches on the main path that runs them."""
    forms = []
    for pair, entries in timed.items():
        codecs = tuple(pair.split("/"))
        path = next((p for p, spec in PATHS.items()
                     if spec[4] == codecs and counts[p][name]), None)
        forms.append(dict(
            {k: x for k, x in entries[0].items() if k != "case"},
            pair=pair, main_path=path,
            launches=counts[path][name] if path else 0,
            max_abs_err=max(e["max_abs_err"] for e in entries),
            library_ms=None, by_case=entries))
    return {"bitwise_pairs": sorted({pr for k, pr, _ in checked
                                     if k == name}),
            "bitwise_cases": sum(k == name for k, _, _ in checked),
            "timed": forms}


def _guarded_forms(name, checked, timed, counts):
    """The `kernels` line's guarded forms of one kernel: the pairs and
    cases checked bit for bit on the small arenas; the timed pairs' numbers
    at the stablelm arena beside the unguarded kernel's; and the launches
    of the guarded main paths."""
    return {"bitwise_pairs": sorted({pr for k, pr, _ in checked
                                     if k == name}),
            "bitwise_cases": sum(k == name for k, _, _ in checked),
            "timed": [dict({k: x for k, x in entries[0].items()
                            if k != "case"}, pair=pair, library_ms=None,
                           by_case=entries)
                      for pair, entries in timed.items()],
            "launches_by_guarded_path": {p: counts[p][name]
                                         for p in GUARDED if p in counts}}


def _remat_run(torch, wrappers, path):
    """One path of the remat phase through train(), with every launch count
    set to 0 just before it: (its result, launches, peak, seconds)."""
    from repro_torch.configs.base import OptimizerConfig, RunConfig
    from repro_torch.train.loop import train
    import dataclasses
    base, remat, seq_len, num_layers, steps = REMAT[path]
    arch, engine, arena, _, codecs = PATHS[base]
    main = MAIN[arch]
    cfg = _main_config(arch)
    if num_layers:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    run = RunConfig(model=cfg,
                    optimizer=OptimizerConfig(
                        accumulation=engine, arena=arena,
                        micro_batches=main["micro_batches"],
                        m_codec=codecs[0], state_codec=codecs[1]),
                    seq_len=seq_len or main["seq_len"],
                    global_batch=main["global_batch"], seed=main["seed"],
                    steps=steps, log_every=1, remat=remat)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = train(run, device="cuda", log_fn=log)
    seconds = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in wrappers.items()}
    REQUESTED_PEAKS[path] = _requested_peak(torch)
    return out, counts, torch.cuda.max_memory_allocated(), seconds


def check_remat(torch, wrappers, main_runs):
    """Phase 6: the REMAT paths, then launch.memory_split on REMAT_SPLIT;
    `main_runs` holds each main path's (digest or None, losses, peak).
    Returns each remat path's launch counts."""
    from repro_torch.launch.memory_split import memory_split
    t0 = time.perf_counter()
    counts, peaks, first_loss, rows = {}, {}, {}, {}
    for path, (base, remat, seq_len, num_layers, steps) in REMAT.items():
        arch = PATHS[base][0]
        out, counts[path], peaks[path], seconds = _remat_run(torch, wrappers,
                                                             path)
        losses = out["losses"]
        rows[path] = out["opt_state"]["m"].layout.rows
        first_loss[path] = losses[0]
        want = _expected_launches(base, out["params"])
        if remat and arch == "rwkv6_7b":
            want["rwkv6_chunk_scan"] *= 2         # forward and recompute
        info = {"phase": "remat", "path": path, "main_path": base,
                "remat": remat, "arch": arch,
                "seq_len": seq_len or MAIN[arch]["seq_len"],
                "num_layers": out["model"].cfg.num_layers,
                "arena_rows": rows[path],
                "losses": losses, "step_seconds": out["step_seconds"],
                "seconds": seconds, "max_memory_allocated_bytes": peaks[path],
                "launches": counts[path], "launches_per_step": want}
        digest = twin = None
        if seq_len is None:
            digest = _digest(torch, _state_tensors(out))
            twin = main_runs[base]
            info.update(digest=digest, main_path_digest=twin[0],
                        main_path_losses=twin[1], main_path_peak=twin[2])
        del out
        log(json.dumps(info))
        expected = first_step_loss(_main_config(arch))
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{path}: non-finite loss {losses}")
        if abs(losses[0] - expected) > 0.1 * expected:
            raise AssertionError(f"{path}: step-1 loss {losses[0]} is not "
                                 f"within 10% of ln(V) + d_model x "
                                 f"{HEAD_INIT_STD}^2 / 2 = {expected:.4f}")
        want = {k: c * steps for k, c in want.items()}
        if counts[path] != want:
            raise AssertionError(f"{path}: kernel launches {counts[path]} "
                                 f"!= {want}")
        if twin is not None:
            if (digest, losses) != (twin[0], twin[1][:steps]):
                raise AssertionError(
                    f"{path}: losses {losses} and digest {digest} are not "
                    f"{base}'s {twin[1]} and {twin[0]} bit for bit")
            if not peaks[path] < twin[2]:
                raise AssertionError(f"{path}: peak {peaks[path]} is not "
                                     f"below {base}'s {twin[2]}")
    pairs = {"bert_large": ("ga_remat", "adama_remat", None),
             "stablelm_1_6b": ("stablelm_4096_ga_remat",
                               "stablelm_4096_adama_remat",
                               "stablelm_4096_adama_layerwise")}
    for arch, (ga, adama, lw) in pairs.items():
        info = {}
        if lw:
            info["step1_losses"] = [first_loss[p] for p in (ga, adama, lw)]
        check_remat_memory(arch, peaks, ga, adama, lw, info, rows[adama])
        if lw is None:
            continue
        first = first_loss[ga]
        if any(abs(first_loss[p] - first) > 1e-4 * first
               for p in (adama, lw)):
            raise AssertionError(f"{arch}: step-1 losses "
                                 f"{info['step1_losses']} differ by more "
                                 f"than 1e-4 relative")
    for arch, kw in REMAT_SPLIT.items():
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        split = memory_split(arch, **kw)
        log(json.dumps({"phase": "remat_memory_split", **split,
                        "seconds": time.perf_counter() - t1}))
    log(json.dumps({"phase": "remat_done",
                    "seconds": time.perf_counter() - t0, "met": True}))
    return counts


@contextlib.contextmanager
def _timed_checkpoint_io(ckpt, io):
    """While the phase runs, every save and restore the loop makes is timed
    (host clock; a save ends in fsync, a restore has copied every leaf to
    the card, which needs no synchronize: a copy from pageable memory
    returns when done) and logged with the bytes of the step's files."""
    save, restore = ckpt.save, ckpt.restore

    def record(op, step, d, t0):
        sec = time.perf_counter() - t0
        n = sum(f.stat().st_size for f in Path(d).iterdir())
        io.append({"op": op, "step": step, "bytes": n, "seconds": sec,
                   "GB_per_s": n / sec / 1e9})
        log(json.dumps({"phase": "checkpoint_io", **io[-1]}))

    def timed_save(ckpt_dir, step, tree, **kw):
        t0 = time.perf_counter()
        out = save(ckpt_dir, step, tree, **kw)
        record("save", step, out, t0)
        return out

    def timed_restore(ckpt_dir, step, tree, **kw):
        t0 = time.perf_counter()
        out = restore(ckpt_dir, step, tree, **kw)
        record("restore", step, Path(ckpt_dir) / f"step_{step:08d}", t0)
        return out
    ckpt.save, ckpt.restore = timed_save, timed_restore
    try:
        yield
    finally:
        ckpt.save, ckpt.restore = save, restore


def _run_counted(torch, wrappers, run, logs):
    """train() on the card with every launch count set to 0 just before it:
    (its result, or the InjectedCrash it raised; launches per step index;
    peak device memory)."""
    from repro_torch.train import faults
    from repro_torch.train.loop import train
    cum = {}

    def snap(i):
        cum[i] = {k: fn.launches for k, fn in wrappers.items()}
    def log_both(msg):
        logs.append(msg)
        log(msg)
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    try:
        out = train(run, device="cuda", log_fn=log_both,
                    step_context=_after_steps([snap]))
    except faults.InjectedCrash as e:
        out = str(e)
    peak = torch.cuda.max_memory_allocated()
    per_step, prev = {}, {k: 0 for k in wrappers}
    for i in sorted(cum):
        per_step[i] = {k: cum[i][k] - prev[k] for k in wrappers
                       if cum[i][k] - prev[k]}
        prev = cum[i]
    return out, per_step, peak


def _run_state(torch, ckpt, out):
    """(digest on the card of every tensor a checkpoint of the run holds:
    the params, every column of m and v, p, wp, ef and the scaler; the
    host-int step; their bytes)."""
    leaves = ckpt.tree_leaves({"params": out["params"],
                               "opt": out["opt_state"]})
    tensors = [x for x in leaves if not isinstance(x, int)]
    return (_digest(torch, tensors), out["opt_state"]["step"],
            sum(x.numel() * x.element_size() for x in tensors))


def _check_resume_path(torch, wrappers, path, ckpt_dir):
    """One path of the checkpoint phase: clean, crashed, (path A) the
    corruption check on the crashed run's step-1 checkpoint with the clean
    run's state as the live target, resumed; the claims of CKPT_PATHS."""
    from repro_torch.configs.base import OptimizerConfig, RunConfig
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import faults
    engine, codecs, extra, fault = CKPT_PATHS[path]
    main = MAIN["bert_large"]

    def run(fault, **kw):
        return RunConfig(
            model=_ckpt_config(),
            optimizer=OptimizerConfig(
                accumulation=engine, micro_batches=main["micro_batches"],
                m_codec=codecs[0], state_codec=codecs[1], **extra),
            seq_len=main["seq_len"], global_batch=main["global_batch"],
            seed=main["seed"], steps=CKPT_STEPS, log_every=1,
            inject_fault=fault, **kw)
    saving = dict(checkpoint_dir=str(ckpt_dir), checkpoint_every=1,
                  keep_last_n=1)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    logs = []
    clean, clean_steps, clean_peak = _run_counted(torch, wrappers,
                                                  run(fault), logs)
    clean_digest, clean_step, n_bytes = _run_state(torch, ckpt, clean)
    clean_losses, clean_metrics = clean["losses"], clean["metrics"]
    free = shutil.disk_usage(ckpt_dir.parent).free
    if free < 2 * n_bytes:
        raise AssertionError(
            f"{path}: {free} B free under {ckpt_dir.parent}; a save that "
            f"keeps one step holds two checkpoints of {n_bytes} B at once")
    crashed, _, _ = _run_counted(torch, wrappers, run(CKPT_CRASH, **saving),
                                 logs)
    if not isinstance(crashed, str):
        raise AssertionError(f"{path}: {CKPT_CRASH} did not raise "
                             f"InjectedCrash")
    del crashed
    listing = sorted(p.name for p in ckpt_dir.iterdir())
    if ckpt.latest_step(ckpt_dir) != 1 or listing != ["step_00000001"]:
        raise AssertionError(f"{path}: after the crash {ckpt_dir} holds "
                             f"{listing}; expected step 1 alone")
    corrupt = None
    if path == CKPT_CORRUPT:
        corrupt = _check_corrupt_refused(torch, ckpt, faults, clean,
                                         ckpt_dir)
    del clean
    gc.collect()
    torch.cuda.empty_cache()
    # the peaks compare only if nothing of the clean run is still held
    bases = [base, torch.cuda.memory_allocated()]
    logs.clear()
    resumed, resumed_steps, resumed_peak = _run_counted(
        torch, wrappers, run(fault, **saving), logs)
    digest, step, _ = _run_state(torch, ckpt, resumed)
    info = {"phase": "checkpoint", "path": path, "engine": engine,
            "m_codec": codecs[0], "v_codec": codecs[1], **extra,
            "fault": fault, "crash": CKPT_CRASH, "checkpoint_bytes": n_bytes,
            "clean_losses": clean_losses, "resumed_losses": resumed["losses"],
            "clean_digest": clean_digest, "resumed_digest": digest,
            "final_step": [clean_step, step],
            "clean_launches_per_step": clean_steps,
            "resumed_launches_per_step": resumed_steps,
            "clean_peak": clean_peak, "resumed_peak": resumed_peak,
            "allocated_before_clean_and_resumed": bases,
            "corrupted_checkpoint": corrupt}
    if path in CKPT_SCALER:
        info["scaler"] = [[m["loss_scale"], m["skipped_micro_batches"]]
                          for m in (clean_metrics, resumed["metrics"])]
    log(json.dumps(info))
    del resumed
    if logs[0] != "[train] restored step 1":
        raise AssertionError(f"{path}: the resumed run logged {logs[0]!r} "
                             f"first, not its restore of step 1")
    if (digest, step) != (clean_digest, clean_step) or step != CKPT_STEPS:
        raise AssertionError(f"{path}: the resumed run ends on digest "
                             f"{digest} at step {step}, the clean run on "
                             f"{clean_digest} at step {clean_step}")
    if info["resumed_losses"] != clean_losses[1:]:
        raise AssertionError(f"{path}: resumed losses "
                             f"{info['resumed_losses']} != the clean run's "
                             f"steps 2-3 {clean_losses[1:]}")
    if resumed_steps != {i: clean_steps[i] for i in (1, 2)} or \
            not all(clean_steps[i] for i in (1, 2)):
        raise AssertionError(f"{path}: launches per step {resumed_steps}, "
                             f"the clean run's {clean_steps}")
    if resumed_peak > clean_peak + CKPT_PEAK_SLACK:
        raise AssertionError(f"{path}: resumed peak {resumed_peak} is more "
                             f"than {CKPT_PEAK_SLACK} B above the clean "
                             f"run's {clean_peak}")
    if path in CKPT_SCALER and any(tuple(x) != CKPT_SCALER[path]
                                   for x in info["scaler"]):
        raise AssertionError(f"{path}: scale and skips {info['scaler']}, "
                             f"expected {CKPT_SCALER[path]} in both runs")
    return info


def _check_corrupt_refused(torch, ckpt, faults, clean, ckpt_dir):
    """Flip one bit in the middle of the step-1 checkpoint's arrays.npz:
    restoring it into a live state (the clean run's) must raise
    CheckpointCorruptError naming the file and leave the state's digest as
    it was (the checksums come before any copy). The same flip again
    restores the file for the resumed run."""
    target = {"params": clean["params"], "opt": clean["opt_state"]}
    tensors = [x for x in ckpt.tree_leaves(target) if not isinstance(x, int)]
    before = _digest(torch, tensors)
    npz = ckpt_dir / "step_00000001" / "arrays.npz"
    offset = npz.stat().st_size // 2
    faults.corrupt_checkpoint_array(ckpt_dir, 1, offset=offset)
    t0 = time.perf_counter()
    try:
        ckpt.restore(ckpt_dir, 1, target)
    except ckpt.CheckpointCorruptError as e:
        message = str(e)
    else:
        raise AssertionError("a checkpoint with a flipped bit restored")
    seconds = time.perf_counter() - t0
    after = _digest(torch, tensors)
    faults.corrupt_checkpoint_array(ckpt_dir, 1, offset=offset)
    if "arrays.npz" not in message or after != before:
        raise AssertionError(f"corrupted checkpoint: {message!r}; state "
                             f"digest {before} -> {after}")
    return {"offset": offset, "error": message[:200],
            "refused_after_seconds": seconds, "state_unchanged": True}


def _ckpt_config():
    import dataclasses
    return dataclasses.replace(_main_config("bert_large"),
                               num_layers=CKPT_LAYERS)


def check_checkpoints(torch, wrappers):
    """Phase 7: the checkpoint paths on bert-large cut to CKPT_LAYERS
    layers (CKPT_PATHS), in a directory of the checkout that is deleted
    afterwards; the free disk space before, every save's and restore's
    bytes, seconds and GB/s, and the phase's seconds are logged."""
    from repro_torch.train import checkpoint as ckpt
    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent / CKPT_DIR
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir()
    cfg = _ckpt_config()
    log(json.dumps({"phase": "checkpoint", "dir": str(root),
                    "arch": cfg.name, "num_layers": cfg.num_layers,
                    "reduced": {"num_layers": [24, cfg.num_layers]},
                    "free_disk_bytes": shutil.disk_usage(root).free}))
    io, results = [], {}
    try:
        with _timed_checkpoint_io(ckpt, io):
            for path in CKPT_PATHS:
                results[path] = _check_resume_path(torch, wrappers, path,
                                                   root / path)
                shutil.rmtree(root / path)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(json.dumps({"phase": "checkpoint_done",
                    "seconds": time.perf_counter() - t0,
                    "saves": sum(x["op"] == "save" for x in io),
                    "restores": sum(x["op"] == "restore" for x in io),
                    "met": True}))
    return results


# ---------------------------------------------------------------------------
# The data-parallel phase
# ---------------------------------------------------------------------------


def _dp_expected(path, n_params, n_leaves, rows, plan=None, n_rest=0):
    """(launches per step, collectives per step as {name: (calls, bytes)})
    of a DP path at M = 1: N folds and one apply for the adama variants
    (and N finite flags when guarded), none for ga (plain Adam); ga
    all-reduces its gradient leaves, replicated adama its two moment
    arenas, ZeRO-1 scatters the gradient arena N times and gathers the
    params once (and all-reduces rowcol's column sums); each all-reduces
    its 4-byte loss. The bucketed schedule and the stream (`plan`, the
    bucket plan) fold and scatter each gradient bucket a micro-batch
    instead, never the padding bucket; guarded, the bucketed schedule
    checks every received slice and agrees once a micro-batch, the stream
    checks dx and the head's gradients (the `n_rest` rest leaves but the
    embedding) and agrees, then checks and agrees each received slice."""
    variant, kw, _, _ = DP_PATHS[path]
    n = MAIN[DP_ARCH]["micro_batches"]
    # the gradient wire's and the gathered params' bytes an element: bf16
    # for the bf16 wire and for a master's working rows
    wire = 2 if kw.get("grad_dtype") == "bf16" else 4
    gather = 2 if kw.get("master_params") else 4
    want = {k: 0 for k in KERNELS}
    if variant == "ga":
        return want, {"all_reduce": (n_leaves + 1, n_params * 4 + 4),
                      "reduce_scatter": (0, 0), "all_gather": (0, 0)}
    arena = rows * LANES * 4
    guarded = bool(kw.get("finite_guard"))
    want["arena_apply"] = 1
    if plan is None:
        want["arena_fold"] = n
        if guarded:
            want["finite_and"] = n
    if not kw.get("zero_stage"):
        return want, {"all_reduce": (3, 2 * arena + 4),
                      "reduce_scatter": (0, 0), "all_gather": (0, 0)}
    colsums = kw.get("state_codec") == "rowcol"
    if plan is None:
        # the guard's agreement: one 4-byte all-reduce a micro-batch
        flags = n if guarded else 0
        scatters = (n, n * arena * wire // 4)
    else:
        g = len(plan.grad_buckets())
        want["arena_fold_slice"] = n * g
        if guarded:
            stream = variant == "adama_layerwise"
            want["finite_and"] = n * (g + n_rest if stream else g)
        flags = (n * (1 + g) if variant == "adama_layerwise" else n) \
            if guarded else 0
        scatters = (n * g, n * sum(b.rows for b in plan.grad_buckets())
                    * LANES * wire)
    return want, {"all_reduce": (1 + colsums + flags,
                                 4 + 4 * LANES * colsums + 4 * flags),
                  "reduce_scatter": scatters,
                  "all_gather": (1, arena * gather // 4)}


def check_dp(torch, wrappers, digests, all_losses, peaks):
    """The data-parallel phase: each DP_PATHS path through train() on a
    one-rank NCCL group, with every launch and collective count set to 0
    just before it and read just after (DP_PEAK_SITES under the
    allocator's history, to name where they peak); then ZeRO-1 emulated at
    DP_SHARDS ranks over the full arena, row ranges
    (`check_zero1_shards`) and buckets (`check_zero1_buckets`). Returns
    (each path's launch counts, the shard and bucket entries by kernel)."""
    import dataclasses
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs.base import OptimizerConfig, RunConfig
    from repro_torch.core import collectives, state_store
    from repro_torch.core.arena import STACK_KEYS
    from repro_torch.core.zero import zero1_bucket_plan
    from repro_torch.kernels import fused_step
    from repro_torch.launch.memory_split import peak_sites
    from repro_torch.train.loop import train

    t0 = time.perf_counter()
    main = MAIN[DP_ARCH]
    counts, info, dp_digests, one_step = {}, {}, {}, {}
    with tempfile.TemporaryDirectory() as rdv:
        dist.init_process_group("nccl", init_method=f"file://{rdv}/rdv",
                                world_size=1, rank=0)
        try:
            for path, (variant, kw, layers, fault) in DP_PATHS.items():
                steps = 1 if path in DP_ONE_STEP else DP_STEPS
                cfg = _main_config(DP_ARCH)
                if layers is not None:
                    cfg = dataclasses.replace(cfg, num_layers=layers)
                run = RunConfig(model=cfg, optimizer=OptimizerConfig(
                    accumulation=variant,
                    micro_batches=main["micro_batches"], **kw),
                    seq_len=main["seq_len"],
                    global_batch=main["global_batch"], seed=main["seed"],
                    steps=steps, log_every=1, inject_fault=fault)
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                for fn in wrappers.values():
                    fn.launches = 0
                collectives.reset_counts()
                ran = {}

                def go(run=run, ran=ran):
                    ran["out"] = train(run, device="cuda", log_fn=log,
                                       group=dist.group.WORLD)
                sites = (peak_sites(go, DP_PEAK_SITES_TOP)
                         if path in DP_PEAK_SITES else go())
                out = ran.pop("out")
                counts[path] = {k: fn.launches for k, fn in wrappers.items()}
                moved = {fn.__name__: (fn.calls, fn.bytes)
                         for fn in collectives.COLLECTIVES}
                peak = torch.cuda.max_memory_allocated()
                requested = _requested_peak(torch)
                leaves = _tree_leaves(out["params"])
                n_params = sum(x.numel() for x in leaves)
                state = out["opt_state"]
                arena = variant != "ga"
                rows = state["m"].layout.rows if arena else None
                plan = (zero1_bucket_plan(state["m"].layout, 1)
                        if kw.get("zero_stage") and (
                            kw.get("zero_bucketed", True)
                            or variant == "adama_layerwise") else None)
                if arena:
                    dp_digests[path] = _digest(torch, _state_tensors(out) + (
                        [state["p"].data] if "p" in state else []))
                n_rest = sum(k not in STACK_KEYS for k in out["params"])
                want, want_moved = _dp_expected(path, n_params, len(leaves),
                                                rows, plan, n_rest)
                if path in DP_ONE_STEP:
                    one_step[path] = _one_step_columns(torch, fused_step,
                                                       out, kw)
                info[path] = {
                    "phase": "dp", "path": path, "variant": variant,
                    "fields": kw, "fault": fault, "num_layers":
                    cfg.num_layers, "ranks": dist.get_world_size(),
                    "backend": dist.get_backend(), "params": n_params,
                    "arena_rows": rows, "state_bytes": (
                        state_store.optimizer_state_bytes(state)
                        if arena else None),
                    "grad_buckets": (len(plan.grad_buckets()) if plan
                                     else None),
                    "losses": out["losses"],
                    "step_seconds": out["step_seconds"],
                    "metrics": out["metrics"],
                    "max_memory_allocated_bytes": peak,
                    "requested_peak_bytes": requested,
                    "launches": counts[path], "launches_per_step": want,
                    "collectives": moved,
                    "collectives_per_step": want_moved,
                    "digest": dp_digests.get(path),
                    "peak_sites": sites}
                log(json.dumps(info[path]))
                if not all(math.isfinite(x) for x in out["losses"]):
                    raise AssertionError(f"{path}: non-finite loss "
                                         f"{out['losses']}")
                if counts[path] != {k: c * steps for k, c in want.items()}:
                    raise AssertionError(f"{path}: launches {counts[path]} "
                                         f"!= {steps} x {want}")
                if moved != {k: (c * steps, b * steps)
                             for k, (c, b) in want_moved.items()}:
                    raise AssertionError(f"{path}: collectives {moved} != "
                                         f"{steps} x {want_moved}")
                del out, state, leaves
            wire_master = check_dp_wire_master(torch, wrappers, info,
                                               dp_digests)
        finally:
            dist.destroy_process_group()
    for path, twin_path in (("dp_adama", DP_TWIN), ("zero1_adama", DP_TWIN),
                            ("zero1_adama_bucketed", DP_TWIN),
                            ("zero1_adama_layerwise", "adama_layerwise")):
        twin = f"{twin_path}:step{DP_STEPS}"
        if dp_digests[path] != digests[twin] or \
                info[path]["losses"] != all_losses[twin_path][:DP_STEPS]:
            raise AssertionError(
                f"{path}: params, m and v (digest {dp_digests[path]}) or "
                f"losses {info[path]['losses']} are not the {twin_path} "
                f"main path's after {DP_STEPS} steps ({digests[twin]}, "
                f"{all_losses[twin_path][:DP_STEPS]})")
    if info["dp_ga"]["losses"][0] != all_losses[DP_TWIN][0]:
        raise AssertionError(f"dp_ga: step-1 loss {info['dp_ga']['losses']}"
                             f" != {DP_TWIN}'s {all_losses[DP_TWIN][0]}")
    for label in ("zero1_adama", "zero1_adama_layerwise"):
        nan, skip = f"{label}_guarded_nan", f"{label}_guarded_skip"
        for path in (nan, skip):
            if info[path]["metrics"]["skipped_micro_batches"] != DP_STEPS:
                raise AssertionError(f"{path}: {info[path]['metrics']}; one "
                                     f"skip a step expected")
        if dp_digests[nan] != dp_digests[skip]:
            raise AssertionError(f"{nan} != {skip}: params, m and v "
                                 f"{dp_digests[nan]} vs {dp_digests[skip]}")
    rowcol = _check_bucketed_rowcol(fused_step, one_step)
    z, ga = info["zero1_adama"], info["dp_ga"]
    own_rows = z["arena_rows"] // info["zero1_adama"]["ranks"]
    zero1_limit = peaks[DP_TWIN] + own_rows * LANES * 4 + DP_PEAK_SLACK
    gap = ga["requested_peak_bytes"] - z["requested_peak_bytes"]
    tree = ga["params"] * 4
    # dp_ga keeps m and v per leaf, zero1_adama as arenas, each larger by
    # the arena's row padding: both peak in the backward with their state
    # beside the same transients, so ga's accumulator shows less that
    # padding twice, and the one-tree claim is logged, not asserted
    # (ROADMAP queue 3 (bb))
    padding = (z["arena_rows"] * LANES - ga["params"]) * 4
    zb, zs = info["zero1_adama_bucketed"], info["zero1_adama_layerwise"]
    arena_bytes = zs["arena_rows"] * LANES * 4
    bucketed_limit = z["max_memory_allocated_bytes"] + DP_PEAK_SLACK
    stream_limit = (peaks["adama_layerwise"]
                    + zs["arena_rows"] // zs["ranks"] * LANES * 4
                    + DP_PEAK_SLACK)
    stream_below = min(z["max_memory_allocated_bytes"],
                       zb["max_memory_allocated_bytes"]) \
        - zs["max_memory_allocated_bytes"]
    memory = {"phase": "dp_memory", "twin": DP_TWIN,
              "twin_peak": peaks[DP_TWIN],
              "zero1_peak": z["max_memory_allocated_bytes"],
              "zero1_minus_twin": z["max_memory_allocated_bytes"]
              - peaks[DP_TWIN], "zero1_limit": zero1_limit,
              "ga_minus_zero1_requested": gap,
              "fp32_gradient_tree_bytes": tree,
              "arena_padding_bytes": padding,
              "zero1_bucketed_peak": zb["max_memory_allocated_bytes"],
              "bucketed_minus_full_pack": zb["max_memory_allocated_bytes"]
              - z["max_memory_allocated_bytes"],
              "bucketed_limit": bucketed_limit,
              "layerwise_twin_peak": peaks["adama_layerwise"],
              "zero1_layerwise_peak": zs["max_memory_allocated_bytes"],
              "stream_minus_layerwise_twin": zs["max_memory_allocated_bytes"]
              - peaks["adama_layerwise"], "stream_limit": stream_limit,
              "stream_below_zero1": stream_below,
              "stream_below_zero1_at_least": DP_STREAM_ARENAS * arena_bytes,
              "peak_sites": {p: info[p]["peak_sites"]
                             for p in DP_PEAK_SITES},
              "met": {"zero1_within_twin_plus_owned_rows":
                      z["max_memory_allocated_bytes"] <= zero1_limit,
                      "ga_at_least_zero1_plus_gradient_tree": gap >= tree,
                      "ga_at_least_zero1_plus_tree_less_two_paddings":
                      gap >= tree - 2 * padding,
                      "bucketed_within_full_pack":
                      zb["max_memory_allocated_bytes"] <= bucketed_limit,
                      "stream_within_layerwise_plus_owned_rows":
                      zs["max_memory_allocated_bytes"] <= stream_limit,
                      "stream_two_arenas_below_zero1":
                      stream_below >= DP_STREAM_ARENAS * arena_bytes}}
    log(json.dumps(memory))
    if not memory["met"]["zero1_within_twin_plus_owned_rows"]:
        raise AssertionError(f"zero1_adama peaks at "
                             f"{z['max_memory_allocated_bytes']} B, above "
                             f"{zero1_limit}")
    if not memory["met"]["ga_at_least_zero1_plus_tree_less_two_paddings"]:
        raise AssertionError(f"dp_ga's requested peak is {gap} B above "
                             f"zero1_adama's, under the fp32 gradient tree "
                             f"less two arena paddings, "
                             f"{tree - 2 * padding} B")
    for claim in ("bucketed_within_full_pack",
                  "stream_within_layerwise_plus_owned_rows",
                  "stream_two_arenas_below_zero1"):
        if not memory["met"][claim]:
            raise AssertionError(f"dp memory: {claim} not met: "
                                 f"{json.dumps(memory)}")
    shards = check_zero1_shards(torch)
    shards["arena_fold_slice"] = check_zero1_buckets(torch)
    log(json.dumps({"phase": "dp_done", "digest_claims": [
        ["dp_adama", f"{DP_TWIN}:step{DP_STEPS}", "equal"],
        ["zero1_adama", f"{DP_TWIN}:step{DP_STEPS}", "equal"],
        ["zero1_adama_bucketed", f"{DP_TWIN}:step{DP_STEPS}", "equal"],
        ["zero1_adama_layerwise", f"adama_layerwise:step{DP_STEPS}",
         "equal"],
        ["zero1_adama_guarded_nan", "zero1_adama_guarded_skip", "equal"],
        ["zero1_adama_layerwise_guarded_nan",
         "zero1_adama_layerwise_guarded_skip", "equal"]],
        "bucketed_int8_rowcol": rowcol, "wire_master": wire_master,
        "seconds": time.perf_counter() - t0}))
    return counts, shards


def check_dp_wire_master(torch, wrappers, info, dp_digests):
    """ROADMAP 10.2's second half on the one-rank group: each
    DP_WIRE_MASTER path against its single-device twin (run here without
    the group, at the same depth and steps) and its DP twin's peak and
    collective bytes; then DP_RESUMED crashed by CKPT_CRASH after step 2's
    update and resumed from its step-1 checkpoint (written and read over
    the group). Raises on a claim not met; returns the phase's lines."""
    import dataclasses
    import shutil

    import torch.distributed as dist

    from repro_torch.configs.base import OptimizerConfig, RunConfig
    from repro_torch.train.faults import InjectedCrash
    from repro_torch.train.loop import train

    t0 = time.perf_counter()
    main = MAIN[DP_ARCH]
    cfg = dataclasses.replace(_main_config(DP_ARCH), num_layers=CKPT_LAYERS)

    def go(variant, kw, fault=None, group=None, ckpt=None):
        run = RunConfig(model=cfg, optimizer=OptimizerConfig(
            accumulation=variant, micro_batches=main["micro_batches"],
            **kw), seq_len=main["seq_len"],
            global_batch=main["global_batch"], seed=main["seed"],
            steps=DP_STEPS, log_every=1, inject_fault=fault,
            checkpoint_dir=ckpt, checkpoint_every=1)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for fn in wrappers.values():
            fn.launches = 0
        out = train(run, device="cuda", log_fn=log, group=group)
        state = out["opt_state"]
        return {"digest": _digest(torch, _state_tensors(out)
                                  + [state["p"].data]),
                "losses": out["losses"], "metrics": out["metrics"],
                "peak": torch.cuda.max_memory_allocated(),
                "launches": {k: fn.launches for k, fn in wrappers.items()},
                "step_seconds": out["step_seconds"]}

    lines = {}
    for path, (dp_twin, engine, fault) in DP_WIRE_MASTER.items():
        _, kw, _, _ = DP_PATHS[path]
        twin = go(engine, {k: x for k, x in kw.items()
                           if k not in ("zero_stage", "zero_bucketed")},
                  fault)
        got, base = info[path], info[dp_twin]
        master = _allocator_bytes(got["arena_rows"] * LANES * 4)
        limit = base["max_memory_allocated_bytes"] + master \
            + DP_PEAK_SLACK // 2
        moved, base_moved = got["collectives"], base["collectives"]
        rs, ag = moved["reduce_scatter"], moved["all_gather"]
        brs, bag = base_moved["reduce_scatter"], base_moved["all_gather"]
        ratio = (sum(b for _, b in moved.values())
                 / sum(b for _, b in base_moved.values()))
        scale = got["metrics"].get("loss_scale")
        line = {"phase": "dp_wire_master", "path": path,
                "fields": DP_PATHS[path][1], "num_layers": CKPT_LAYERS,
                "dp_twin": dp_twin, "single_device_twin": engine,
                "twin_fault": fault, "digest": dp_digests[path],
                "twin_digest": twin["digest"], "losses": got["losses"],
                "twin_losses": twin["losses"],
                "twin_step_seconds": twin["step_seconds"],
                "peak": got["max_memory_allocated_bytes"],
                "twin_peak": twin["peak"],
                "dp_twin_peak": base["max_memory_allocated_bytes"],
                "owned_master_as_allocated": master, "peak_limit": limit,
                "reduce_scatter": rs, "dp_twin_reduce_scatter": brs,
                "all_gather": ag, "dp_twin_all_gather": bag,
                "bytes_ratio": ratio, "loss_scale": scale,
                "met": {"equal_to_single_device":
                        dp_digests[path] == twin["digest"]
                        and got["losses"] == twin["losses"]
                        and got["metrics"] == twin["metrics"],
                        "peak_within_dp_twin_plus_master":
                        got["max_memory_allocated_bytes"] <= limit,
                        "reduce_scatter_half":
                        rs == (brs[0], brs[1] // 2) and brs[1] % 2 == 0,
                        "all_gather_half":
                        ag == (bag[0], bag[1] // 2) and bag[1] % 2 == 0,
                        "bytes_within_ratio":
                        ratio <= DP_WIRE_BYTES_RATIO}}
        if got["fault"]:
            line["met"]["scale_backed_off_once"] = \
                scale == DP_WIRE_LOSS_SCALE \
                and got["metrics"]["skipped_micro_batches"] == 1
        log(json.dumps(line))
        lines[path] = line
        if not all(line["met"].values()):
            raise AssertionError(f"{path}: {line['met']}")
    root = Path(__file__).resolve().parent / CKPT_DIR / "dp"
    shutil.rmtree(root, ignore_errors=True)
    variant, kw, _, _ = DP_PATHS[DP_RESUMED]
    try:
        go(variant, kw, CKPT_CRASH, dist.group.WORLD, str(root))
        crashed = False
    except InjectedCrash:
        crashed = True
    kept = sorted(p.name for p in root.glob("step_*"))
    resumed = go(variant, kw, None, dist.group.WORLD, str(root))
    shutil.rmtree(root.parent, ignore_errors=True)
    clean = info[DP_RESUMED]
    line = {"phase": "dp_resume", "path": DP_RESUMED, "fault": CKPT_CRASH,
            "crashed": crashed, "checkpoints_after_crash": kept,
            "digest": resumed["digest"], "clean_digest":
            dp_digests[DP_RESUMED], "losses": resumed["losses"],
            "clean_losses": clean["losses"], "peak": resumed["peak"],
            "clean_peak": clean["max_memory_allocated_bytes"],
            "launches": resumed["launches"],
            "step_seconds": resumed["step_seconds"],
            "met": {"crashed_after_step_1_save": crashed
                    and kept == ["step_00000001"],
                    "equal_to_clean":
                    resumed["digest"] == dp_digests[DP_RESUMED]
                    and resumed["losses"] == clean["losses"][1:],
                    "peak_within_clean": resumed["peak"]
                    <= clean["max_memory_allocated_bytes"]
                    + DP_PEAK_SLACK // 2}}
    log(json.dumps(line))
    if not all(line["met"].values()):
        raise AssertionError(f"dp resume: {line['met']}")
    lines["resume"] = line
    lines["seconds"] = time.perf_counter() - t0
    return lines


def _one_step_columns(torch, fused_step, out, kw):
    """What the int8/rowcol one-step comparison reads of a run: a digest
    of each row-indexed column of m and v, the column sums and the params
    (on the host)."""
    from repro_torch.core import state_store
    state = out["opt_state"]
    cols = [(c.row_indexed, x) for mo, name in (("m", kw["m_codec"]),
                                                ("v", kw["state_codec"]))
            for x, c in zip(state_store.codec_of(state[mo], mo)
                            .parts_of(state[mo]),
                            fused_step.kernel_codec(mo, name).cols)]
    return {"rows": state["m"].layout.rows,
            "layout": state["m"].layout,
            "row_digests": [_digest(torch, [x]) for ri, x in cols if ri],
            "colsums": [x.detach().double().cpu() for ri, x in cols
                        if not ri],
            "params": [x.detach().to("cpu", copy=True)
                       for x in _tree_leaves(out["params"])]}


def _check_bucketed_rowcol(fused_step, one_step):
    """Bucketed int8/rowcol against the full pack after one step (8
    layers, one rank): every row-indexed column bit for bit (digests),
    the column sums, added bucket by bucket, within the float32 bound of
    the two orders (`_bucket_colsum_bound`; queue 3 (j)'s DP_COLSUM_REL
    logged); the params' largest difference logged."""
    from repro_torch.core.zero import zero1_bucket_plan
    a = one_step["zero1_adama_bucketed_int8_rowcol"]
    b = one_step["zero1_adama_int8_rowcol_step1"]
    rel = max(float((x - y).abs().max() / y.abs().max())
              for x, y in zip(a["colsums"], b["colsums"]))
    plan = zero1_bucket_plan(a["layout"], 1)
    bound = _bucket_colsum_bound(fused_step, a["rows"], plan)
    param_diff = max(float((x - y).abs().max())
                     for x, y in zip(a["params"], b["params"]))
    line = {"phase": "zero1_bucketed_int8_rowcol",
            "row_indexed_equal": a["row_digests"] == b["row_digests"],
            "colsum_rel": rel, "bound": bound,
            "within_queue3_j": rel <= DP_COLSUM_REL,
            "max_param_diff": param_diff}
    log(json.dumps(line))
    if not line["row_indexed_equal"]:
        raise AssertionError(f"bucketed int8/rowcol: row-indexed columns "
                             f"differ from the full pack's: {line}")
    if not rel <= bound:
        raise AssertionError(f"bucketed int8/rowcol: column sums {rel} "
                             f"relative from the full pack's, past {bound}")
    one_step.clear()
    return line


def _shard_state(torch, gen, m_codec, v_codec, rows):
    """Random (m, v) columns of a pair over `rows` rows on the card."""
    def col(scale, n=rows, width=1):
        return torch.rand((n, width), generator=gen, device="cuda") * scale

    def codes(lo):
        return torch.randint(lo, 128, (rows, LANES), generator=gen,
                             device="cuda", dtype=torch.int8)
    m = ((codes(-127), col(1e-5)) if m_codec == "int8" else
         (torch.randn((rows, LANES), generator=gen, device="cuda") * 1e-3,))
    v = {"fp32": lambda: ((torch.randn((rows, LANES), generator=gen,
                                       device="cuda") * 1e-6).abs(),),
         "int8": lambda: (codes(0), col(1e-8)),
         "factored": lambda: (col(1e-6),),
         "rowcol": lambda: (col(1e-3), col(1.0, 1, LANES))}[v_codec]()
    return m, v


def _colsum_chain(fused_step, n):
    """The float32 additions that chain into one column sum of rowcol's
    fold over n rows: a warp's rows of a range, the CTA's tree over its
    warps, the ranges in order (`rowcol_partition`)."""
    ranges, range_rows = fused_step.rowcol_partition(n)
    return (-(-range_rows // fused_step.RC_WARPS)
            + fused_step.RC_WARPS.bit_length() - 1 + ranges)


def _colsum_bound(fused_step, rows, shards):
    """The relative bound of rowcol's column sums over `rows` rows against
    their `shards` ranks' partials summed in rank order: every term is
    positive, so a float32 chain of L additions is within L x 2^-24 of the
    exact sum (relative), and the two computations within the sum of their
    bounds (`_colsum_chain`); the partials add `shards` more."""
    return (_colsum_chain(fused_step, rows)
            + _colsum_chain(fused_step, rows // shards) + shards) * 2.0 ** -24


def _bucket_colsum_bound(fused_step, rows, plan):
    """As `_colsum_bound`, for the bucketed schedule against the whole
    arena's fold: a rank adds each bucket's slice partial (its own chain)
    into the column sums in bucket order, and the ranks' partials add in
    rank order."""
    buckets = plan.grad_buckets()
    return (_colsum_chain(fused_step, rows)
            + max(_colsum_chain(fused_step, b.slice_rows) for b in buckets)
            + len(buckets) + plan.n_shards) * 2.0 ** -24


def check_zero1_buckets(torch):
    """The bucketed ZeRO-1 schedule emulated at DP_SHARDS ranks over
    bert-large's full arena, laid out for DP_SHARDS ranks, for each pair of
    DP_SHARD_PAIRS: each rank's owned rows (partition order) of the same
    state, its slice of every gradient bucket folded at the bucket's
    own_offset with the slice-fold kernel (the first fold of a mini-batch,
    the decay fused, scale 1/8; a shared column: the rank's own copy,
    decayed by b2 / M), then the apply on its owned param rows; the ranks'
    rows unpermuted to arena order against the whole arena's fold and
    apply. Every row-indexed column and p bit for bit; rowcol's column
    sums, the ranks' partials in rank order, within the float32 bound of
    the orders (`_bucket_colsum_bound`; DP_COLSUM_REL logged). Then the
    slice fold timed on DP_BUCKET_TIMED's buckets and slices beside its
    bound. Returns the timed entries."""
    from repro_torch.core import buckets, state_store
    from repro_torch.core.zero import zero1_bucket_plan
    from repro_torch.kernels import fused_step

    layout = full_layout(torch, DP_ARCH, n_shards=DP_SHARDS)
    plan = zero1_bucket_plan(layout, DP_SHARDS)
    rows, m_ = layout.rows, DP_SHARDS
    perm = torch.from_numpy(buckets.partition_index(plan).astype(
        "int64")).to("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(32)
    g = torch.randn((rows, LANES), generator=gen, device="cuda")
    p = torch.randn((rows, LANES), generator=gen, device="cuda") * 0.02
    # the padding bucket's rows hold zeros, as in training: no rank folds
    # them, and the whole arena's fold leaves zeros zero
    pad = layout.rest.row + layout.rest.rows
    g[pad:] = 0.0
    b1, b2 = 0.9, 0.999
    fold_kw = dict(beta1=b1, beta2=b2, scale=1.0 / 8, decay=(b1, b2))
    apply_kw = dict(lr=1e-3, bc1=0.19, bc2=0.001999, eps=1e-8)
    out = []

    def owned(parts, codec, k, shared=None):
        """Rank k's owned rows of each row-indexed column (a copy, in
        partition order); a shared column: `shared`, or a copy."""
        return tuple(buckets.gather_owned_rows(x, plan, k) if c.row_indexed
                     else (shared if shared is not None else x.clone())
                     for x, c in zip(parts, codec.kernel.cols))

    def arena_order(cols):
        return torch.cat(cols).index_select(0, perm)

    for m_codec, v_codec in DP_SHARD_PAIRS:
        pair = f"{m_codec}/{v_codec}"
        mc, vc = (state_store.get_codec(m_codec, "m"),
                  state_store.get_codec(v_codec, "v"))
        m0, v0 = _shard_state(torch, gen, m_codec, v_codec, rows)
        for x in _row_cols(fused_step, m_codec, v_codec, m0, v0):
            x[pad:] = 0
        mw, vw = _clone(m0), _clone(v0)
        state_store.fold(mc, vc, mw, vw, g, **fold_kw)
        pw = p.clone()
        state_store.apply(mc, vc, pw, mw, vw, **apply_kw)
        ranks_m, ranks_v, ranks_p = [], [], []
        for k in range(m_):
            mk, vk = owned(m0, mc, k), owned(v0, vc, k)
            mc.begin_micro(mk, b1)
            vc.begin_micro(vk, b2 / m_)
            for b in plan.grad_buckets():
                lo = b.start + k * b.slice_rows
                state_store.fold_slice(mc, vc, mk, vk,
                                       g[lo:lo + b.slice_rows],
                                       b.own_offset, beta1=b1, beta2=b2,
                                       block=b.fold_block, scale=1.0 / 8,
                                       decay=(b1, b2))
            pk = buckets.gather_owned_rows(p, plan, k)
            state_store.apply(mc, vc, pk, owned(mw, mc, k),
                              owned(vw, vc, k, vw[-1]), **apply_kw)
            ranks_m.append(mk)
            ranks_v.append(vk)
            ranks_p.append(pk)
        torch.cuda.synchronize()
        row_w = _row_cols(fused_step, m_codec, v_codec, mw, vw)
        row_s = [arena_order(list(cols)) for cols in zip(*[
            _row_cols(fused_step, m_codec, v_codec, a, b)
            for a, b in zip(ranks_m, ranks_v)])]
        _compare_bits(torch, "zero1 buckets", f"{pair} fold",
                      list(zip(row_s, row_w)))
        _compare_bits(torch, "zero1 buckets", f"{pair} apply",
                      [(arena_order(ranks_p), pw)])
        colsum_rel = None
        if v_codec == "rowcol":
            total = ranks_v[0][-1].clone()
            for x in ranks_v[1:]:
                total += x[-1]
            colsum_rel = float((total - vw[-1]).abs().max()
                               / vw[-1].abs().max())
            bound = _bucket_colsum_bound(fused_step, rows, plan)
            log(json.dumps({"phase": "zero1_bucket_colsums", "pair": pair,
                            "relative": colsum_rel, "bound": bound,
                            "within_queue3_j": colsum_rel <= DP_COLSUM_REL}))
            if not colsum_rel <= bound:
                raise AssertionError(f"zero1 buckets {pair}: column sums "
                                     f"{colsum_rel} relative from the whole "
                                     f"arena's, past {bound}")
        del mw, vw, pw, ranks_m, ranks_v, ranks_p, row_w, row_s
        ops = 2 + _FOLD_OPS[m_codec] + _FOLD_OPS[v_codec]
        for label, kind, shards in DP_BUCKET_TIMED:
            b = next(x for x in plan.buckets if x.kind == kind)
            n_rows = b.rows // shards
            off = b.start if shards == 1 else b.own_offset
            block = (math.gcd(math.gcd(fused_step.BLOCK_ROWS, n_rows), off)
                     if shards == 1 else b.fold_block)
            n = n_rows * LANES
            gs = g[b.start:b.start + n_rows]
            fold_t = dict(beta1=b1, beta2=b2, block=block, scale=1.0 / 8,
                          m_codec=m_codec, v_codec=v_codec)
            per_step = MAIN[DP_ARCH]["micro_batches"] * sum(
                x.kind == kind for x in plan.grad_buckets())
            out.append(_kernel_entry(
                "arena_fold_slice", f"zero1 buckets {pair} {label}",
                timed_ms(torch, lambda: fused_step.arena_fold_slice(
                    m0, v0, gs, off, **fold_t), runs=WIRE_TIMED_RUNS,
                    reps=KERNEL_REPS),
                timed_ms(torch, lambda: fused_step.arena_fold_slice_ref(
                    m0, v0, gs, off, **fold_t), runs=1, warmup=0),
                bound_ms(4 * n + 2 * _codec_bytes(m_codec, v_codec, n_rows),
                         ops * n),
                {"pair": pair, "rows": n_rows, "row_offset": off,
                 "block": block, "ranks": shards, "max_abs_err": 0.0,
                 "colsum_rel": colsum_rel,
                 "launches_per_step_at_this_kind": per_step}))
        del m0, v0
    del g, p, perm
    torch.cuda.empty_cache()
    return out


def check_zero1_shards(torch):
    """ZeRO-1 emulated at DP_SHARDS ranks over bert-large's full arena,
    laid out for DP_SHARDS row ranges, for each pair of DP_SHARD_PAIRS:
    the first fold of a mini-batch (the decay fused, scale 1/8) and the
    apply, on the whole arena and on each rank's row-range view of the
    same state (a shared column: each rank's own copy, decayed by b2 / M
    as ZeRO-1 decays it), through the state store the engines call. Every
    row-indexed column and p must equal the whole arena's bit for bit;
    rowcol's column sums, the ranks' partials summed in rank order, within
    the float32 bound of the two orders (`_colsum_bound`; queue 3 (j)'s
    DP_COLSUM_REL logged) of the whole arena's (each rank's apply then
    takes the whole arena's sums). Each rank's fold and apply are timed beside the
    whole arena's, with their bounds. Returns {kernel: [entry, ...]}."""
    from repro_torch.core import state_store
    from repro_torch.core.zero import shard_rows
    from repro_torch.kernels import fused_step

    layout = full_layout(torch, DP_ARCH, n_shards=DP_SHARDS)
    shards = shard_rows(layout, DP_SHARDS)
    rows = layout.rows
    gen = torch.Generator(device="cuda")
    gen.manual_seed(31)
    g = torch.randn((rows, LANES), generator=gen, device="cuda")
    p = torch.randn((rows, LANES), generator=gen, device="cuda") * 0.02
    b1, b2 = 0.9, 0.999
    fold_kw = dict(beta1=b1, beta2=b2, scale=1.0 / 8, decay=(b1, b2))
    apply_kw = dict(lr=1e-3, bc1=0.19, bc2=0.001999, eps=1e-8)
    out = {"arena_fold": [], "arena_apply": []}

    def view(parts, codec, s, shared=None):
        """A rank's rows of each row-indexed column; a shared column:
        `shared`, or a copy of the rank's own."""
        return tuple(x[s.start:s.stop] if c.row_indexed else
                     (shared if shared is not None else x.clone())
                     for x, c in zip(parts, codec.kernel.cols))
    for m_codec, v_codec in DP_SHARD_PAIRS:
        pair = f"{m_codec}/{v_codec}"
        mc, vc = (state_store.get_codec(m_codec, "m"),
                  state_store.get_codec(v_codec, "v"))
        m0, v0 = _shard_state(torch, gen, m_codec, v_codec, rows)
        mw, vw = _clone(m0), _clone(v0)
        state_store.fold(mc, vc, mw, vw, g, **fold_kw)
        pw = p.clone()
        state_store.apply(mc, vc, pw, mw, vw, **apply_kw)
        ms, vs, ps = _clone(m0), _clone(v0), p.clone()
        partials = []
        for s in shards:
            mv, vv = view(ms, mc, s), view(vs, vc, s)
            state_store.fold(mc, vc, mv, vv, g[s.start:s.stop],
                             replicated_decay=(b1, b2 / DP_SHARDS),
                             **fold_kw)
            partials.append(vv[-1] if v_codec == "rowcol" else None)
            state_store.apply(mc, vc, ps[s.start:s.stop], view(mw, mc, s),
                              view(vw, vc, s, vw[-1]), **apply_kw)
        torch.cuda.synchronize()
        row_w = _row_cols(fused_step, m_codec, v_codec, mw, vw)
        row_s = _row_cols(fused_step, m_codec, v_codec, ms, vs)
        _compare_bits(torch, "zero1 shards", f"{pair} fold",
                      list(zip(row_s, row_w)))
        _compare_bits(torch, "zero1 shards", f"{pair} apply", [(ps, pw)])
        colsum_rel = None
        if v_codec == "rowcol":
            total = partials[0].clone()
            for x in partials[1:]:
                total += x
            colsum_rel = float((total - vw[-1]).abs().max()
                               / vw[-1].abs().max())
            bound = _colsum_bound(fused_step, rows, DP_SHARDS)
            log(json.dumps({"phase": "zero1_colsums", "pair": pair,
                            "relative": colsum_rel, "bound": bound,
                            "within_queue3_j": colsum_rel <= DP_COLSUM_REL}))
            if not colsum_rel <= bound:
                raise AssertionError(f"zero1 shards {pair}: column sums "
                                     f"{colsum_rel} relative from the whole "
                                     f"arena's, past {bound}")
        del mw, vw, pw, ms, vs, ps, partials
        ops = 2 + _FOLD_OPS[m_codec] + _FOLD_OPS[v_codec]
        apply_ops = _DECODE_OPS[m_codec] + _DECODE_OPS[v_codec] + 3 + (
            0 if v_codec == "factored" else 4)
        for label, lo, hi in [("whole arena", 0, rows)] + [
                (f"rank {s.index} of {DP_SHARDS}", s.start, s.stop)
                for s in shards]:
            n_rows, n = hi - lo, (hi - lo) * LANES
            mv = tuple(x[lo:hi] if c.row_indexed else x
                       for x, c in zip(m0, mc.kernel.cols))
            vv = tuple(x[lo:hi] if c.row_indexed else x
                       for x, c in zip(v0, vc.kernel.cols))
            kw = dict(m_codec=m_codec, v_codec=v_codec)
            fold_t = dict(kw, beta1=b1, beta2=b2, scale=1.0 / 8)
            plain = (lo == 0)
            shape = {"pair": pair, "rows": n_rows, "row_offset": lo,
                     "max_abs_err": 0.0, "launches_per_zero1_step": (
                         MAIN[DP_ARCH]["micro_batches"])}
            out["arena_fold"].append(_kernel_entry(
                "arena_fold", f"zero1 {pair} {label}",
                timed_ms(torch, lambda: fused_step.arena_fold(
                    mv, vv, g[lo:hi], **fold_t), runs=WIRE_TIMED_RUNS,
                    reps=KERNEL_REPS),
                timed_ms(torch, lambda: fused_step.arena_fold_ref(
                    mv, vv, g[lo:hi], **fold_t), runs=1, warmup=0)
                if plain else None,
                bound_ms(4 * n + 2 * _codec_bytes(m_codec, v_codec, n_rows),
                         ops * n), shape))
            out["arena_apply"].append(_kernel_entry(
                "arena_apply", f"zero1 {pair} {label}",
                timed_ms(torch, lambda: fused_step.arena_apply(
                    p[lo:hi], mv, vv, **apply_kw, **kw),
                    runs=WIRE_TIMED_RUNS, reps=KERNEL_REPS),
                timed_ms(torch, lambda: fused_step.arena_apply_ref(
                    p[lo:hi], mv, vv, **apply_kw, **kw), runs=1, warmup=0)
                if plain else None,
                bound_ms(8 * n + _codec_bytes(m_codec, v_codec, n_rows),
                         apply_ops * n),
                dict(shape, launches_per_zero1_step=1,
                     colsum_rel=colsum_rel)))
        del m0, v0
    del g, p
    torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.kernels import (adam_apply, adama_accum, build,
                                     fp8_wire, fused_step, rwkv6_chunk)
    from repro_torch.train.loop import resolve_device
    if sys.argv[1:2] == [PROFILE_FLAG]:
        resolve_device("cuda")
        return profile_child(torch, fused_step, fp8_wire, int(sys.argv[2]))

    t_start = time.perf_counter()
    resolve_device("cuda")           # TF32 off for fp32 matmuls
    smi = gpu_name_and_power()
    log(json.dumps({"phase": "versions", "python": sys.version.split()[0],
                    "torch": torch.__version__, "cuda": torch.version.cuda,
                    "device": torch.cuda.get_device_name(0),
                    "nvidia_smi": smi,
                    "allow_tf32": [torch.backends.cuda.matmul.allow_tf32,
                                   torch.backends.cudnn.allow_tf32]}))

    t0 = time.perf_counter()
    outputs = build.build_all()
    log(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                    "sources": sorted(outputs)}))
    for name, text in outputs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas {name}] {line.strip()}")
    rowcol_ptxas = check_ptxas(outputs["fused_step"])

    modules = {"fused_step": fused_step, "adama_accum": adama_accum,
               "adam_apply": adam_apply, "rwkv6_chunk": rwkv6_chunk,
               "fp8_wire": fp8_wire}
    wrappers = {k: getattr(modules[mod], k)
                for k, (mod, _, _, _) in KERNELS.items()}
    kernels = check_kernels(torch, fused_step)
    kernels["arena_fold_slice"] = check_slice_fold(torch, fused_step,
                                                   full_layout(torch))
    kernels.update(check_leaf_kernels(torch, adama_accum, adam_apply))
    kernels.update(check_rwkv_scan(torch, rwkv6_chunk))
    exactness = check_fold_exactness(torch, fused_step)
    codec_checked = check_codec_small(torch, fused_step, adama_accum)
    stablelm_layout = full_layout(torch, "stablelm_1_6b")
    codec_timed, codec_per_call = check_codec_timed(torch, fused_step,
                                                    stablelm_layout)
    guard_checked = check_guard_small(torch, fused_step, adama_accum)
    guard_timed, kernels["finite_and"] = check_guard_timed(
        torch, fused_step, stablelm_layout)
    guard_per_call, fp8_per_call = child_kernels_per_call()
    kernels["finite_and"]["device_ms_with_guarded_fold"] = guard_per_call
    wire_checked = check_wire_small(torch, fused_step, adama_accum)
    wire_timed, kernels["finite_and"]["bf16_slab"] = check_wire_timed(
        torch, fused_step, stablelm_layout)
    master_checked = check_master_small(torch, fused_step, adama_accum)
    master_timed = check_master_timed(torch, fused_step, stablelm_layout)
    fp8_wire_checked, fp8_checked = check_fp8_small(torch, fused_step,
                                                    fp8_wire, adama_accum)
    fp8_passes, fp8_timed = check_fp8_timed(torch, fused_step, fp8_wire,
                                            stablelm_layout)
    for name, entry in fp8_passes.items():
        entry["device_ms_per_call"] = fp8_per_call[name]
    for pair, entries in fp8_timed["arena_fold"].items():
        entries[0]["device_ms_per_call"] = fp8_per_call[
            f"arena_fold e4m3 {pair}"]
    kernels.update(fp8_passes)
    log(json.dumps({"phase": "kernels_checked", "kernels": list(KERNELS),
                    "seconds": time.perf_counter() - t_start}))
    check_ga_accumulate(torch)
    check_rope(torch)
    check_mamba(torch)
    check_small_input(torch)
    counts, work_bytes, main_runs = {}, {}, {}
    for arch in MAIN:
        c, peaks, w, d, losses, n_params = run_main_paths(torch, wrappers,
                                                          arch)
        check_memory(arch, peaks, n_params)
        if arch == DP_ARCH:
            dp_counts, dp_shards = check_dp(torch, wrappers, d, losses,
                                            peaks)
            counts.update(dp_counts)
            for name, entries in dp_shards.items():
                kernels[name]["zero1_buckets" if name == "arena_fold_slice"
                             else "zero1_shards"] = entries
        if _main_config(arch).attention == "swa":
            check_window(torch, arch)
        if _main_config(arch).moe is not None:
            timed = check_moe(torch, arch, d, losses)
        elif arch in ARENA_SLICES:
            timed = time_arena(torch, arch)
        else:
            timed = {}
        for name, entries in timed.items():
            kernels[name][arch + "_arena"] = entries
        counts.update(c)
        work_bytes.update(w)
        main_runs.update({p: (d.get(p), losses[p], peaks[p]) for p in c})
    counts.update(check_remat(torch, wrappers, main_runs))
    check_checkpoints(torch, wrappers)
    for name in CODEC_FORMS:
        kernels[name]["codec_forms"] = _codec_forms(
            name, codec_checked, codec_timed[name], counts)
        kernels[name]["codec_forms"]["device_kernels_per_call"] = {
            case: n for case, n in codec_per_call.items()
            if case.startswith(name + " ")}
        kernels[name]["guarded_forms"] = _guarded_forms(
            name, guard_checked, guard_timed[name], counts)
        if name in wire_timed:
            kernels[name]["wire_forms"] = _wire_forms(
                name, wire_checked, wire_timed[name], counts)
        if name in fp8_timed:
            kernels[name]["fp8_forms"] = _wire_forms(
                name, fp8_checked, fp8_timed[name], counts, "e4m3", FP8)
    for name in fp8_passes:
        kernels[name]["bitwise_cases"] = sum(k == name
                                             for k, _ in fp8_wire_checked)
    kernels["finite_and"]["bitwise_cases"] = sum(
        k == "finite_and" for k, _, _ in guard_checked)
    kernels["arena_apply"]["master_forms"] = _master_forms(
        master_checked, master_timed, counts, work_bytes)
    for name in ("arena_fold", "arena_fold_slice"):
        kernels[name]["rowcol_design"] = {"exactness": exactness,
                                          "ptxas": rowcol_ptxas}

    line = {"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": counts[path][name],
         "main_path": path,
         "launches_by_path": {p: c[name] for p, c in counts.items()},
         **kernels[name]}
        for name, (_, source, replaces, path) in KERNELS.items()],
        "seconds": time.perf_counter() - t_start}
    print(json.dumps(line))
    print(gpu_name_and_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
