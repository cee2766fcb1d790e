#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ring_attention_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit's nvcc:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero, printing no
result line):

1. The card's name and power limit; every CUDA kernel of the package is
   built from ``csrc/`` (one nvcc per source, all started together); the
   ptxas report of each flash kernel, and no bf16 instantiation of the
   wgmma kernels (B1's sweep, B2's dk/dv, B3's dq, the fused ring's B7 and
   B8) may spill; their registers and their WARPGROUP.DEPBAR counts (SASS)
   are printed.  No instantiation of the int8 kernels (B4, B6) may spill;
   B4's SASS must run int8 wgmma (IGMMA) and no mma.sync (IMMA), and each
   of its loops that runs the products is printed with its instruction
   count and its conversions (I2F, I2FP, F2I, FRND) and MUFU.RCP.
2. Each kernel against its plain PyTorch version on the card, in bf16 and
   f32, at the shapes of its path and of the cases its port must cover
   (causal, offset, band-empty rows, window, softclamp, key mask with an
   all-False row, GQA):
   2. the forward kernel, also on FWD_EDGE_CASES (query counts of 128k +
       1, + 64 and + 127, band edges inside a 128-row block and a 64-key
       tile, a key mask that leaves one 64-row warpgroup of a block no live
       key while the other keeps its keys); the split-KV decode kernel
       (csrc/flash_decode.cu)
       fused and as partials, at the wrapper's split count and at one
       range, on DECODE_CASES (ragged valid prefixes, a request with no
       valid key, nk not a multiple of the 64-key tile, softclamp, MQA,
       nq 2), each call launching the decode kernel and never flash_fwd;
   2b. the dk/dv and dq backward kernels, also on BWD_EDGE_CASES (key
       counts of 128k + 1, + 64 and + 127, band edges inside a 128-key
       block) and FWD_EDGE_CASES (dq's 128-row blocks) and on the
       65,536-token causal backward in 1,024-row and
       1,024-key slices;
   2c. the forward kernel's ring modes (seed partials, resumed partials
       into new tensors and in place, the fused write from a carry) on
       every forward case and FWD_EDGE_CASES, a 3-hop striped chain with a
       band-empty row, the
       4-hop chains that phase 3c launches (n_local 16,384: contiguous
       rank 3, striped ranks 0-2) and the 4-hop chain of ring rank 3 at
       262,144 tokens (n_local 65,536), the long chains in 1,024-row
       slices; outputs are held elementwise and by their norm-relative
       error (RING_REL_TOL).
   2d. the int8 kernels: B4's tile layout and descriptors probed against
       ``torch._int_mm``; the int8 forward (csrc/flash_fwd_q8.cu) in every
       mode (fused, seed, resume into new tensors and in place, fused from
       a carry) on every forward case and FWD_EDGE_CASES, at a ring hop's
       quantization block, a block of 96 keys and blocks of 32 (below one
       tile), a case where every key carries its own value, one block of
       262,144 keys whose int32 P V sum would pass 2^31 unfolded, the
       65,536-token causal launch in 1,024-row slices and two 4 x 16,384
       int8 hop chains; the int8 decode (csrc/flash_decode_q8.cu) fused, with
       softclamp and as partials on the decode shapes; each held by its
       norm-relative error and its lse (Q8_REL_TOL, Q8_LSE_TOL).
   2e. the fused ring kernel (csrc/flash_ring.cu) in bf16 and f32 against
       its plain version (OUT_TOL and RING_REL_TOL) for every rank of a
       ring of 4, with contiguous and striped tables, a lookback window
       with limited passes over ragged 1,000-key shards, a striped window,
       GQA h8/hk2, softclamp and a key mask with an all-False row; each
       case's whole ring also against the hop chain of the forward kernel
       (``impl="cuda"``) bit for bit, where a causal key mask with an
       all-False row pins the (hop, tile) set the two visit; then the
       launches of phase
       3e (n_local 16,384, h8 hk8 bf16): every rank, contiguous and
       striped, against the plain chain in 1,024-row slices, and each
       layout's whole ring against the hop chain (bit for bit); then the
       262,144-token schedule of ring rank 3 (4 x 65,536) against the hop
       chain (bit for bit) and, in 1,024-row slices, against the plain
       chain.
   2f. the fused ring's remote tier (csrc/flash_ring_remote.cu, one
       cooperative launch for the whole ring, the ranks passing KV to each
       other under the grant protocol) in bf16 and f32: rings of 2, 4 and
       8, contiguous and striped, a window with 3 passes, GQA h8/hk2,
       softclamp 50; every rank against its plain version (OUT_TOL,
       LSE_TOL, RING_REL_TOL), against B7 over the gathered span and
       against the ``impl="cuda"`` hop chain of B1 (max|diff| == 0 on out
       and lse: B7 and B8 walk B1's sweep hop by hop); the
       fused model's launch (4 ranks x n_local 16,384, h8 hk8 bf16, both
       layouts) the same, and against the plain chain in 1,024-row slices;
       then the stress: 50 launches of the causal ring of 4, each bit for
       bit the first, with the default block split and with rank 0, then
       rank 3, starved to one block; a grid the card cannot hold at
       once must raise.  Phase 1 also reads B7's and B8's ptxas reports
       and SASS: their local-memory traffic (in all and in the innermost
       loop that runs the tensor cores, which in bf16 must hold HGMMA, no
       HMMA and no local load or store), and B8 may take no load through
       the non-coherent read-only path (LDG...CONSTANT) and its bf16 stage
       copies must all bypass L1 (LDGSTS...BYPASS: cp.async.cg); and every
       flash kernel's stack and spills per instantiation (the segmented
       ones are ``<64,1>``).
   2g. packed sequences: the segmented instantiations of the forward
       kernel (fused, seed, resume into new tensors and in place, fused
       from a carry) and of both backward kernels against their plain
       versions, bf16 and f32, on the forward cases that take
       self-attention ids (causal, window, softclamp, a key mask with an
       all-False row, GQA), packed as documents of 100-1,500 tokens whose
       boundaries fall inside tiles and ending in a PAD_SEGMENT_ID tail;
       the resumed hops' keys hold the same documents with their
       boundaries moved; then phase 3f's 65,536-token launch, forward and
       backward, in 1,024-row and 1,024-key slices.
   2h. the shapes zig-zag and tree decoding give the kernels: B1, B2 and
       B3 on the first and the last query chunk against the whole gathered
       span (the zig-zag model's 8,192 rows of 65,536 keys, in 1,024-row
       and 1,024-key slices; config 3's 2,048 of 32,768 and 512 of 8,192 in
       f32, whole), the keys past a chunk's band written and zero in dk and
       dv; B5 and B6 partials on each rank's 262,144-key shard of config
       5's cache, full and with valid prefixes of 100 and 300,000 keys,
       where a shard with no valid key must keep m at exactly MASK_VALUE
       with l > 0 and a finite acc.
   2i. declared packings: the forward kernel (fused, seed, resume into new
       tensors and in place, fused from a carry) and both backward kernels
       with ``doc_starts`` against their plain versions (the layout as
       runtime ids), bf16 and f32, on packings aligned to 128 tokens (every
       pass takes its doc-tile table and drops the tiles of other
       documents), aligned to 64 (the bf16 dk/dv pass takes runtime ids) and
       misaligned (every pass takes runtime ids), causal, windowed, soft
       clamped and GQA, each launch counted as the one it must be; phase
       3k's 65,536-token launch in 1,024-row and 1,024-key slices; then the
       fused ring kernel with ids (its segmented instantiation) against its
       plain version for every rank of a ring of 4 (contiguous, striped,
       GQA with softclamp) and each whole ring against the ``impl="cuda"``
       ring bit for bit, and the fused mask model's launches (4 x 16,384)
       against the segmented B1 hop chain bit for bit; with the JAX
       launch's tables (the hops whose ids share no document visited) the
       difference is printed.
   2k. the ring variants' call shapes (every rank of a causal ring of 4 at
       n_local 4,096, contiguous and striped, bf16 and f32): the forward
       kernel's seed, resume and fused modes and both backward kernels on
       the bidirectional half-streams (spans of 2,048 keys, the reverse
       stream's bands shifted by -2,048) and on the counter-rotated
       schedule (the carry unpacked from the f32 ``[q | acc | m | l]``
       pack), and the int8 forward fed per-stream blobs and on the
       counter schedule (bf16), each ring function against the same
       function with every span through its plain version (OUT_TOL and
       RING_REL_TOL, BWD_REL_TOL, Q8_REL_TOL and Q8_LSE_TOL).
3. The serving path through the entry points a user calls: RingTransformer
   at the full width of the repository's benchmark model (vocab 256,
   dim 512, 8 heads of 64, depth 2, ff_mult 4, rotary, causal, bf16) with
   weights from a seeded generator: logits for one 65,536-token request,
   then ``generate`` for 4 requests of 2,048-token prompts (128 new tokens,
   max_len 4096, greedy), which must launch the decode kernel once per
   layer and decode step and nothing else (the prompt runs the blockwise
   PyTorch prefill).  A float32 copy of the model (seq 256) on the card is
   held to the same weights on the CPU, forward and decode.
3b. The training path: the same model takes 4 ``make_train_step`` steps
   with ``torch.optim.Adam(lr=1e-3)`` on one batch of 65,536 tokens (65,537
   ids); every loss must be finite, the last below the first, and each
   step must launch each of the three kernels exactly twice (once per
   layer).  A float32 copy (seq 256) computes one step's gradients on the
   card and on the CPU, which must agree.
3c. The ring path: the same model with ``mesh=create_mesh(ring_size=4)``, a
   virtual ring of 4 ranks on the card, in the contiguous and the striped
   layout: logits for the 65,536-token request held to the local model's,
   then 4 Adam steps (loss finite and falling).  Each forward and step must
   launch the forward kernel's ring modes and the backward kernels exactly
   as the hop schedule says (RING_SCHEDULE).  A float32 copy (seq 256)
   on the card is held to the CPU, logits and gradients, in both layouts.
3d. The int8 path: the same model with ``quantize_cache=True,
   compute_dtype="int8"``: logits for the 65,536-token request held to the
   bf16 model's (Q8_FWD_REL_L2), ``generate`` on the int8 cache, 4 Adam
   steps; a float32 copy (seq 256) on the card held to the CPU; then the
   ring of 4 in both layouts, forward and one step.  Every run launches
   exactly what its path says: the int8 forward twice per forward, the int8
   decode once per layer and step, the ring modes per RING_SCHEDULE.
3e. The fused ring path: the same model with ``mesh=create_mesh(ring_size=4),
   impl="fused"``, contiguous and striped, as in 3c: logits held to the
   local model's and, bit for bit, to the scan-path ring model's (the same
   seeded weights), 4 Adam steps, the float32 copy held to the CPU.  Each
   unmasked forward launches the remote-tier kernel once per layer (2) and
   nothing of the local tier or the forward kernel; each step's backward
   launches the backward kernels per RING_SCHEDULE.  A non-causal copy of
   the model at 65,535 tokens, which the model pads and masks (a causal
   layer drops the mask), takes the local tier: B7 once per rank and layer
   (8), its logits held to the local non-causal model's.
3f. The packed path: the same model on 1 x 65,536 tokens packed as
   documents of log-uniform 512-16,384 tokens (numpy default_rng(0), the
   last cut at the row's end, ids 0, 1, 2, ...): the forward and one
   ``make_train_step`` step locally and on the ring of 4 (contiguous and
   striped, ``impl="cuda"``), the ring's logits held to the local packed
   model's; every launch segmented, the hops the ids skip (worked out here
   from the ids) missing from the counts exactly.  The f32 model's packed
   logits of each document held to the document run alone at the rotary
   positions it holds in the row (MODEL_ATOL; the distance from the
   document run from position 0 printed beside it), and the packed f32
   model at seq 256 on the card held to the CPU, logits and gradients,
   locally and on both ring layouts.  Then the packed forward and step
   beside the unpacked ones of the same models, in turns.
3g. The zig-zag path: the same model with ``sequence_parallel="zigzag",
   mesh=create_mesh(ring_size=4)`` on 1 x 65,536 tokens: logits held to
   the local model's (RING_LOGITS_REL_TOL), one step's gradients to the
   local model's (ZIGZAG_BF16_GRAD_REL_TOL), 4 Adam steps; 8 B1 launches
   (fused mode) per forward and 8 B2 and 8 B3 per step's backward, per
   layer.  A float32 copy on the card held to the float32 local model at
   1 x 4,096 (logits MODEL_ATOL, gradients GRAD_REL_TOL) and to the CPU at
   seq 256.
3h. ``zigzag_attention`` at BASELINE.json config 3 (causal, 32,768 tokens,
   a virtual ring of 8, 8 heads of 64, bf16): output and dq, dk, dv held
   to ``cuda_flash_attention`` on the canonical sequence (OUT_TOL and
   RING_REL_TOL, BWD_REL_TOL); 16 launches of each of B1, B2, B3.
3i. ``tree_attn_decode`` at BASELINE.json config 5 (b1 h8 hk8 d64, a
   1,048,576-token cache over a virtual ring of 4): held to one fused B5
   launch over the whole cache, and on the int8 cache (B6 partials) to one
   fused B6 launch; the valid prefixes of 2h, the 100-key one also held to
   the plain decode of those keys alone; 4 launches of B5 and of B6 each.
3j. The serving path on the ring of 4: ``generate`` for 4 prompts of 2,048
   tokens and 128 new ones (cache 4,096), plain, with
   ``quantize_cache=True`` and with ``impl="fused"``: the prompt runs the
   scan ring (RING_SCHEDULE's forward modes; the fused model: the remote
   tier, B8, once per layer, whose greedy tokens must equal the plain
   model's), each decode step B5 (B6) once per rank and layer.  The
   float32 models on the card against the float32 local model: greedy
   tokens equal (plain), the prefill's and each teacher-forced step's
   logits within MODEL_ATOL (with ``quantize_cache``, norm-relative
   Q8_MODEL_REL_TOL).
3k. The declared packing: the same model with ``mask=Causal() &
   DocumentMask(starts)``, phase 3f's documents with their lengths rounded
   to 128 tokens: the forward (one doc-table launch of the forward kernel
   per layer, nothing segmented) held to the same weights with the layout
   as runtime ``segment_ids``, two train steps (each pass's doc-table
   launch per layer); the f32 mask model at seq 256 on the card held to
   the CPU, locally and on the fused ring; the fused ring of 4 with ids
   (the mask's, contiguous; ``segment_ids=``, striped): B7 with ids once
   per rank and layer, never B8, logits bit-identical to the scan ring's,
   the hops the ids skip counted, one step's segmented backward; then the
   local forward and step with doc tables, with runtime ids and unpacked,
   in turns.
3m. The model over a mesh of processes: four processes (``spawn``), one
   rank each of ``create_mesh()`` over a gloo process group that meets
   through a ``FileStore``, all on this card (gloo stages every payload
   through host memory; the kernels run on the card in every process),
   joined with a timeout, a failure or a straggler failing the run.  The
   same model at 1 x 65,536: forward on the ring of 4 with
   ``impl="cuda"``, ``"fused"`` (B7 once a rank and layer) and the int8
   wire with int8 compute, striped, phase 3f's 13 documents as
   ``segment_ids`` (forward and loss), zig-zag (forward and step), an Adam
   step on the ring of 4 and on data 2 x ring 2 (2 x 32,768), and
   ``generate`` for 4 x (2,048 + 16 new); each held to the same model on a
   VirtualRing in this process: logits (RING_LOGITS_REL_TOL, one digest
   across the processes), losses (MP_LOSS_REL_TOL), the step's gradient
   (the mesh's sum) leaf by leaf (MP_GRAD_REL_TOL, with a control that
   must fail it: the gradient without the seq ring's sum), the parameters
   after the step bit-identical across the processes and within
   MP_PARAM_ATOL of the VirtualRing step's, greedy tokens equal; the launches of each
   process per layer, their sum equal to the VirtualRing model's (times
   the data rows; the fused forward: B7 where the VirtualRing takes B8),
   and the bytes each collective staged through the host.
3n. The memory knobs: the same model at 1 x 65,536 (65,537 ids), one loss
   and backward without knobs (twice: what a step repeats of itself),
   with ``remat=True`` under None, ``save_attn``, ``offload_attn``,
   ``save_attn_and_ffn_inputs`` and ``checkpoint_dots``, and with
   ``ff_chunk_size=loss_chunk_size=2048``: each against the step without
   knobs (loss KNOB_LOSS_REL_TOL relative, every gradient leaf
   KNOB_GRAD_REL_TOL norm-relative; the leaves that are not bit-identical
   printed), its launches exact (KNOB_B1: B1 4 where the backward reruns
   the attention, 2 where the region keeps its ``(out, lse)``; B2 and B3
   2) and its peak memory above live; the int8 model (B4) without remat,
   under ``save_attn`` and under None likewise.  The windowed cache:
   ``max_lookback_seq_len=(4096, None), windowed_cache=True`` against the
   full cache, bf16 and ``quantize_cache``, 4 x (8,192 prompt + 64 new)
   teacher-forced on the full model's greedy tokens: logits within
   RING_LOGITS_REL_TOL, the greedy token equal wherever the full model's
   margin decides it, layer 0's cache bytes, one B5 (B6) launch a layer
   and step; the int8 cache beside the full int8 model's spread under
   last-bit weight noise.  ``make_train_step(offload_opt_state=True)``:
   two Adam steps with parameters bit-identical to the plain steps' (the
   embedding frozen in both: its backward sums with atomics), the
   optimizer state in pinned host memory between steps.
3o. Ulysses and the hybrid strategy in one process (the held ranks folded
   into the batch): the same model at 1 x 65,536 with
   ``sequence_parallel="ulysses"`` on ``create_mesh(ring_size=4)`` and
   ``"hybrid"`` on ``create_mesh(ulysses_size=2, ring_size=2)``
   (contiguous, striped, ``impl="fused"``): logits against the local
   model's (RING_LOGITS_REL_TOL), one loss and backward against the local
   model's (SP_LOSS_REL_TOL, every gradient leaf SP_GRAD_REL_TOL), the
   launches exact (Ulysses: B1 once a layer, B2 and B3 once; hybrid:
   HYBRID_SCHEDULE, the outer ring of 2; fused: B8 once a layer); the int8
   hybrid (B4 fed, per HYBRID_SCHEDULE) against the local model
   (Q8_FWD_REL_L2); ``kv_head_reshard``'s small-hk branch on the
   attention alone (SP_ATTN_CASES: 32 heads over 4 kv heads on Ulysses of
   8, 12 over 3 on 4, at 32,768) against ``cuda_flash_attention`` over
   the whole span, with the ring's moves (K/V gathered once); the f32 int8
   hybrid at seq 256 on the card against the CPU beside the CPU's spread
   under weight noise.
3p. Ulysses (world 4) and the hybrid strategy (ulysses 2 x ring 2) on
   four gloo processes sharing the card, as in 3m: logits bit for bit
   against the VirtualRing mesh in this process, the loss the same on
   every process and, for Ulysses, bit for bit with it; for the hybrid
   within MP_LOSS_REL_TOL of it (its processes sum their shares' nll in
   another order: over the ulysses group, then the ring), the
   launches summed over the processes (the VirtualRing mesh's times the
   ranks it folds), the all-to-alls' host staging; ZeRO-1 on data 2 x ring
   2: two Adam steps plain, with ``shard_opt_state=True`` and with
   ``offload_opt_state=True`` as well (embedding frozen): parameters
   bit-identical to the plain steps' on every process, each process holding
   half the optimizer state.
3q. The ring variants on the virtual ring of 4 (1 x 65,536, bf16), each
   against the unidirectional ring model with the same weights: the
   counter-rotated model (logits, loss and every gradient but the frozen
   embedding's compared bit for bit and printed; held within
   RING_LOGITS_REL_TOL, SP_LOSS_REL_TOL and SP_GRAD_REL_TOL), the
   bidirectional one (the same bounds), ``ring_dkv_dtype="bfloat16"``
   (logits and loss bit for bit, gradients within DKV_BF16_REL_TOL), the
   counter-rotated int8 ring (the unidirectional int8 ring's logits,
   Q8_FWD_REL_L2 from the bf16 local model) and the hybrid 2 x 2 with its
   outer ring counter-rotated; launches per RING_SCHEDULE and
   BIDIR_SCHEDULE.
3r. Four gloo processes as in 3p: the counter-rotated (striped), the
   bidirectional and the counter-rotated int8-wire models' logits bit for
   bit against the VirtualRing mesh, each rotation's (shift, bytes) against
   JAX's ``hop_bytes`` (``analysis/contracts.py``: the compressed KV handle
   ``2*b*hk*chunk*(d+4)``, the f32 q pack ``4*b*h*chunk*(2d+2)``) and the
   host staging twice those bytes; process-local batches on data 2 x ring
   2: ``shard_batch`` of each process's row feeding ``auto_shard=False``,
   whose block logits and parameters after one SGD step (embedding frozen)
   equal the ``auto_shard=True`` model's bit for bit.
   In phases 3 to 3r every launch counter is set to 0 just before each
   run and read just after; a kernel that never launched fails the run.
4. Timings with CUDA events (median of 10 runs after warm-up): each kernel
   beside its bound (the larger of its bytes over 3.35 TB/s and its
   operations over the peak rate of their type), its plain version and
   one PyTorch library call computing the same function (a yardstick the
   package never calls); the decode kernel at b4 h8 hk2 nk32,768, b4 h8
   hk8 nk4,096 and b1 h8 hk8 nk1,048,576 on the device alone (replayed
   from a CUDA graph of 20 calls: its ``ms``), per call in a stream of 20
   and as one synchronized call (both bound by the host's launch work at
   small caches), SDPA likewise; the model's forward tokens/s and decode
   ms/step at 4 requests of ~2,048 and of ~32,768 cached tokens.
4b. The same for the backward kernels (the library call is the backward
   of ``scaled_dot_product_attention``), and the train step: ms per step
   (host clock around a synchronized step, median after warm-up), tokens/s,
   peak device memory, and the step split into forward, backward and
   optimizer.
4c. The ring: each ring mode of the forward kernel beside its bound, its
   plain version and SDPA with its lse (a yardstick: no PyTorch call
   returns un-normalized partials); the hop chain of ring rank 3 at
   262,144 tokens (ms, TFLOP/s, bound, ratio to the single causal sweep)
   beside SDPA per span merged in PyTorch; the ring models' forward and
   train step (ms, tokens/s, peak memory) beside the local model's.
4d. The int8 kernels: the int8 forward at causal 4,096 and 65,536 (the
   kernel on quantized operands and the wrapper with its quantization)
   beside B1 on the same inputs, its ring modes on a 65,536-row span, the
   int8 decode at b4 h8 hk8 nk4,096 and b4 h8 hk2 nk32,768 on the device
   alone (CUDA graph of 20 calls; also per call in a stream of 20 and one
   synchronized call) beside B5 and SDPA on a bf16 cache of the same
   shape, each beside its bound at the int8 or byte rate and its plain
   version (no PyTorch call computes int8 attention); the int8 model's
   forward tokens/s (and the int8 ring models'), decode ms/step and train
   step.
4e. The fused ring: the kernel on ring rank 3's schedule at n_local 16,384
   (the fused model's launches, contiguous and striped), 4,096 and 65,536
   (262,144 tokens) beside its bound, the forward kernel's hop chain on
   the same spans (timed in turns: chain, fused, fused, chain), SDPA per
   span merged in PyTorch (the yardstick of 4c) and, at 16,384 contiguous
   and at 4,096, its plain version; one 65,536-key span, unbanded and causal, through
   the forward kernel and through the fused kernel with a one-hop table
   (the same function, in turns); the remote tier for the whole causal
   ring of 4 at n_local 16,384 (contiguous and striped), 4,096 and 65,536
   (262,144 tokens), timed in turns with the four B7 launches over the
   gathered span and the four ranks' hop chains, beside its bound (all
   ranks' in-band operations), its plain version (16,384 and 4,096) and
   SDPA per span merged, summed over the ranks; B8's diagnostics (a ring
   of one against B7, causal and unbanded; the whole ring under even,
   proportional and default block splits beside each one's modelled
   time); the fused ring models' forward (in turns with the scan-path
   ring models') and train step.
4f. The segmented kernels on packed causal (1, 8, n, 64) bf16 at 4,096
   (with the plain versions), 16,384 and 65,536 beside their bound (only
   the same-document in-band pairs count) and SDPA with the packing's
   dense boolean block-diagonal causal ``attn_mask`` (its backward for
   B2/B3; null where it does not fit on the card).
4g. Zig-zag and decoding on a mesh: the zig-zag model's forward and step
   beside the contiguous and striped scan ring models (in turns); config 3
   forward and forward + backward beside ``cuda_flash_attention`` (in
   turns); config 5's tree decode (on the device, CUDA graph of 20, and
   synchronized) beside its four partials launches alone and one fused B5
   launch, the same on the int8 cache with B6; the decode step of the
   ring models at ~32,768 cached tokens beside the local ones.
4h. Declared packings: the three kernels with doc tables on aligned
   packings of causal (1, 8, n, 64) bf16 at 4,096 (with the plain versions)
   and 65,536 beside their bound (same-document in-band pairs), the same
   layout as runtime ids on the segmented kernels (in turns) and SDPA with
   the dense mask; B7 with ids at n_local 16,384 (rank 3, contiguous)
   beside the unsegmented B7 and the segmented B1 chain on the same spans
   (in turns), its bound, plain version and SDPA with the dense mask over
   the gathered span.
4j. Phase 3m's wall times (host clock around synchronized calls): each
   forward and ``generate`` the median of 3 after the first, each step the
   second one, beside the VirtualRing model's, with the card's name and
   power limit: four processes time-sliced on one card with gloo staging,
   not a measure of a multi-GPU ring.
4k. bench.py's train configuration (``remat=True,
   remat_policy="save_attn", ff_chunk_size=loss_chunk_size=2048``) at 1 x
   262,144 beside the model without knobs, remat alone and the chunks
   alone (Adam steps, one warm-up each, then a, b, c, d, d, c, b, a on the
   host clock around synchronized steps): ms, tokens/s, peak memory above
   live, launches; then ``train1m`` (bench.py phase 7): one step at 1 x
   1,048,576 after one warm-up.  The phase prints its own seconds.
4l. Ulysses of 4 and hybrid 2 x 2 (scan ring and fused) beside the local
   model and the scan ring of 4 at 1 x 65,536: the forward (CUDA events,
   in turns) and the Adam step (host clock around synchronized steps, in
   turns), each beside its attention kernels' device time (CUDA events
   around every B1, B2, B3, B7 and B8 launch of one forward and one step)
   and the step's peak memory above live.  The phase prints its own
   seconds.
4m. The counter-rotated, bidirectional and ``ring_dkv_dtype="bfloat16"``
   models beside the scan ring of 4 at 1 x 65,536, as 4l (forward and Adam
   step in turns, each with its B1/B2/B3 device time); one layer's
   counter-rotated int8 ring (wire and compute) at n_local 16,384 beside
   the unidirectional int8 ring, in turns (bench.py phase 4d's
   counterpart).  The phase prints its own seconds.
5. The kernels line, one JSON object with eight kernels; the forward
   kernels' entries list their ring modes; the per-shape rows of
   flash_fwd, flash_bwd_dkv and flash_bwd_dq end with phase 4f's, each
   with the segmented launches of phase 3f, and phase 4h's, each with the
   doc-table launches of phase 3k; flash_ring's with 4h's row with ids.
6. The last line: ``{"ok": true, "device": {...}}``.

It exits non-zero when ``torch.cuda.is_available()`` is false and when the
package is not beside it.
"""

from __future__ import annotations

import concurrent.futures
import copy
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"torch.bfloat16": 989e12, "torch.float32": 67e12, "torch.int8": 1979e12}

# Phase-2 tolerances, |kernel - plain| <= atol + rtol * |plain|:
# bf16 output is rounded to bf16 (one ulp is 7.8e-3 at 1.0) and the kernel
# rounds p to bf16 for the PV product; f32 differs by summation order only.
OUT_TOL = {"torch.bfloat16": (2e-2, 1e-2), "torch.float32": (1e-4, 0.0)}
LSE_TOL = {"torch.bfloat16": (1e-3, 0.0), "torch.float32": (1e-4, 0.0)}
# Phase-2c tolerance beside OUT_TOL, ||out - plain|| / ||plain||: a row that
# averages standard-normal V over n keys has |out| near n^-1/2, below OUT_TOL's
# atol at the ring's spans, so the output is also held at its own scale (bf16:
# p rounded for the PV product and out rounded, a relative 2^-9 each; f32:
# summation order only).
RING_REL_TOL = {"torch.bfloat16": 1e-2, "torch.float32": 1e-5}
# Phase-2b tolerances, ||kernel - plain|| / ||plain|| per gradient: the plain
# version stays in f32 where the bf16 kernels round p and ds to bf16 (a
# relative 2^-9 each) before their products, and dk/dv sum up to 65,536
# such terms; f32 differs by summation order and exp2 rounding only.
BWD_REL_TOL = {"torch.bfloat16": 1e-2, "torch.float32": 1e-5}
# Phase-3 f32 card-vs-CPU logits: two layers of f32 matmuls (k up to 2048)
# and attention summed in another order on each side.
MODEL_ATOL = 1e-3
# Phase-3b f32 card-vs-CPU gradients, ||card - cpu|| / ||cpu|| per parameter:
# the same f32 sums in another order through two layers and back.
GRAD_REL_TOL = 1e-4
TRAIN_STEPS = 4
# Phase-3c bf16 ring-vs-local logits, ||ring - local|| / ||local||: the same
# bf16 model whose attention sums its keys in 4 hop spans instead of one
# sweep (each output rounds to bf16 once either way), through two layers.
RING_LOGITS_REL_TOL = 1e-2
RING_SIZE = 4
# Launches per layer and forward on a ring of 4 (parallel/ring.py): seed
# partials, resumed partials, fused from a carry; then dk/dv and dq per hop
# with work.  Contiguous causal: rank r has work on hops 0..r, ranks 0-2
# finalize on the host.  Striped causal: every hop has work on every rank.
RING_SCHEDULE = {False: (4, 5, 1, 10, 10), True: (4, 8, 4, 16, 16)}

BENCH_MODEL = dict(num_tokens=256, dim=512, depth=2, causal=True, heads=8,
                   dim_head=64, bucket_size=2048, rotary=True, ff_mult=4)
SEED = 0
KERNEL_SOURCES = ("flash_fwd", "flash_bwd", "flash_decode", "flash_fwd_q8",
                  "flash_decode_q8", "flash_ring", "flash_ring_remote")

# Phase-2d tolerances of the int8 kernels against their plain versions,
# which quantize q, k, v and p exactly as the kernels do.  B4: the output's
# norm-relative error (bf16 rounds the output, a relative 2^-9; f32 differs
# where the card's exp or tanh differs from the plain version's in its last
# bit and a p8 unit flips, 1.6e-5 measured with softclamp) and max|lse -
# plain| (a flipped p8 unit moves l by at most safe = rowmax(p) / 127).
# B6 dequantizes in f32 and does not quantize p: summation order only.
Q8_REL_TOL = {"torch.bfloat16": 5e-3, "torch.float32": 1e-4}
Q8_LSE_TOL = 1e-3
DECODE_Q8_REL_TOL = {"torch.bfloat16": 5e-3, "torch.float32": 1e-5}
DECODE_Q8_LSE_TOL = 1e-4
# Phase-3d: the int8 model's bf16 logits against the bf16 model's,
# ||int8 - bf16|| / ||bf16||: the JAX package's own pin for the int8 forward
# (tests/test_quant.py Q8_FWD_REL_L2).
Q8_FWD_REL_L2 = 2e-2
# Phase-3d f32 int8 model, card vs CPU, norm-relative per output.  The int8
# forward amplifies last-bit differences: an f32 sum taken in another order
# moves q, k, v or p across a half step of their int8 grid now and then, and
# one p8 unit is 1/127 of a row's largest weight.  The phase measures that
# spread on the CPU each run (every weight times 1 + 1.2e-7 noise) and prints
# it beside the int8 error itself (the int8 model's distance from the exact
# f32 one); the bound sits between the two.
Q8_MODEL_REL_TOL = 5e-3

# The kernels' cases on the card, forward and backward alike:
# name: (b, h, hk, nq, nk, causal_offset, window_lo, softclamp, masked)
KERNEL_CASES = {
    "causal (1,8,4096,64)": (1, 8, 8, 4096, 4096, 0, None, None, False),
    "causal offset nq1024 nk4096": (1, 8, 8, 1024, 4096, 3072, None, None, False),
    # rows 0..1023 have no key in their band: the forward averages all of V
    # there, the backward gives them no gradient (as the TPU kernels do)
    "causal nq2048 > nk1024": (1, 8, 8, 2048, 1024, -1024, None, None, False),
    "window 1024": (1, 8, 8, 4096, 4096, 0, -1023, None, False),
    "softclamp 50": (1, 8, 8, 4096, 4096, 0, None, 50.0, False),
    "kv_mask, one all-False row": (2, 8, 8, 2048, 2048, None, None, None, True),
    "GQA h32 hk4 (1,32,2048,64)": (1, 32, 4, 2048, 2048, 0, None, None, False),
}


# Phase-2b cases beside KERNEL_CASES, in its format: the dk/dv kernel takes
# 128 keys a block and runs the keep test only on query tiles that meet the
# band's edge, the ragged end or a key mask.
BWD_EDGE_CASES = {
    "nk 1025 (128k+1), causal offset 25": (1, 8, 2, 1000, 1025, 25, None, None, False),
    "nk 1088 (128k+64), key mask": (2, 8, 8, 777, 1088, None, None, None, True),
    "nk 1151 (128k+127), window, softclamp": (1, 8, 4, 1200, 1151, -49, -300, 30.0, False),
    "causal offset 100 (edge mid-block)": (1, 8, 8, 2048, 2148, 100, None, None, False),
    "causal offset -37, window 500": (1, 8, 8, 1500, 1500, -37, -537, None, False),
}


# The bf16 kernels on wgmma and their instantiations (B1, B2, B3 and B7 kSeg;
# B1, B2 and B3 kDocs, the doc-tile tables; B1, B7 and B8 the soft clamp),
# none of which may spill: B1's sweep, B2's dk/dv, B3's dq
# and the fused ring's B7 and B8, which walk B1's sweep hop by hop.
WGMMA_KERNELS = {"flash_fwd_bf16_kernel": 6, "flash_bwd_dkv_bf16_kernel": 3,
                 "flash_bwd_dq_bf16_kernel": 3, "flash_ring_bf16_kernel": 4,
                 "flash_ring_remote_bf16_kernel": 2}
# The int8 kernels and their instantiations, none of which may spill: B4's
# sweep (the soft clamp, times none, kSeg and kDocs), B6's decode (rows a
# block: 1, 2, 4, 8, 16), and B4's sweep in B7 (the soft clamp times kSeg)
# and B8 (the soft clamp).
Q8_FWD_KERNELS = {"flash_fwd_q8_kernel": 6}
Q8_DECODE_KERNELS = {"decode_q8_kernel": 5}
Q8_RING_KERNELS = {"flash_ring_q8_kernel": 4, "flash_ring_remote_q8_kernel": 2}
# The fused ring's bf16 kernels: their hot loop runs wgmma (HGMMA), no
# mma.sync (HMMA).
RING_WGMMA_KERNELS = ("flash_ring_bf16_kernel", "flash_ring_remote_bf16_kernel")


# Phase-2 and 2c cases beside KERNEL_CASES, in its format: the bf16 forward
# kernel takes 128 query rows a block in two warpgroups of 64, each with its
# own tile range, and runs the keep test only on tiles that meet the band's
# edge, the ragged end or a key mask.  Query counts of 128k + 1, + 64 and +
# 127; band edges inside a block and inside a 64-key tile; and masked =
# "half": keys 0..62 masked, so that under causal offset -1 rows 0..63 (the
# first warpgroup of the first block, whose row 0 sees no key, so that it
# visits every tile as the plain version's dense rows do) have no live key
# while rows 64..127 of the same block do.
FWD_EDGE_CASES = {
    "nq 1025 (128k+1), causal": (1, 8, 2, 1025, 1025, 0, None, None, False),
    "nq 1088 (128k+64), causal offset 64": (1, 8, 8, 1088, 1152, 64, None, None, False),
    "nq 1151 (128k+127), window, softclamp": (1, 8, 4, 1151, 1151, 0, -300, 30.0, False),
    "causal offset 96 (edge mid-block)": (1, 8, 8, 2048, 2144, 96, None, None, False),
    "window -200 (lower edge mid-block)": (1, 8, 8, 2048, 2048, 0, -200, None, False),
    "key mask empties one warpgroup": (2, 8, 8, 1024, 1024, -1, None, None, "half"),
}


def log(*parts) -> None:
    print(*parts, flush=True)


def check(ok: bool, message: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {message}")


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median device time of ``fn`` over ``iters`` runs (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def band_pairs(nq: int, nk: int, hi: int | None, lo: int | None) -> int:
    """(query, key) pairs inside the band lo <= j - i <= hi, clipped to nk."""
    if hi is None:
        return nq * nk
    upper = [min(nk - 1, i + hi) for i in range(nq)]
    lower = [max(0, i + lo) if lo is not None else 0 for i in range(nq)]
    return sum(max(0, u - lo_ + 1) for u, lo_ in zip(upper, lower))


def bound_ms(ops: float, nbytes: float, dtype) -> tuple[float, str]:
    t_ops = ops / PEAK_OPS_PER_S[str(dtype)]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


# ---------------------------------------------------------------------------


def _kernel_name(mangled: str, with_args: bool = False) -> str:
    """The ``..._kernel`` identifier that an Itanium-mangled name ends its
    (possibly nested) name with, read component by component from the start,
    so that no digit inside a component (the path hash of an anonymous
    namespace) is taken for a length; with ``with_args``, followed by its
    integer and bool template arguments (``<64,1>``: the segmented
    instantiation of a flash kernel). Any other name comes back as it is."""
    import re

    head = re.match(r"_ZL?(N?)", mangled)
    if head is None:
        return mangled
    pos, name = head.end(), ""
    while (length := re.match(r"\d+", mangled[pos:])) is not None:
        start = pos + length.end()
        pos = start + int(length.group())
        name = mangled[start:pos]
        if not head.group(1):
            break
    if not (name.endswith("_kernel") and name.isidentifier()):
        return mangled
    args = re.match(r"I((?:L[a-z]\d+E)+)E", mangled[pos:])
    if with_args and args:
        name += "<" + ",".join(re.findall(r"L[a-z](\d+)E", args.group(1))) + ">"
    return name


def _ptxas_usage(log_text: str) -> list[str]:
    """``kernel: Used N registers, ...`` for each entry function that
    ``ptxas -v`` reports."""
    import re

    usage, kernel = [], "?"
    for line in log_text.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            kernel = _kernel_name(entry.group(1), with_args=True)
        elif "registers" in line:
            usage.append(f"{kernel}: " + line.split(":", 1)[1].strip())
    return usage


def phase_build(port_dir: Path) -> None:
    from ring_attention_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    for line in smi.stdout.strip().splitlines():
        log(line)
    start = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        results = dict(zip(KERNEL_SOURCES, pool.map(_build.build, KERNEL_SOURCES)))
    for name, res in results.items():
        check(res.path.is_file(), f"{name} did not build")
        check(port_dir in res.path.resolve().parents,
              f"{name} built outside the checkout: {res.path}")
        log(f"build {name}: {res.seconds:.1f} s nvcc; " + " | ".join(_ptxas_usage(res.log)))
    log(f"phase 1 build: {time.perf_counter() - start:.1f} s wall")
    # the stack and spills of every instantiation of the kernels that share
    # csrc/flash_tile.cuh or take document ids (the segmented ones are
    # <64,1> or, in the wgmma kernels, <1> and B1's <1,clamp>; the
    # unsegmented ones must keep their registers and spills); no bf16
    # instantiation of the wgmma kernels (B1, B2 dk/dv, B3 dq) may spill
    wgmma_reports = {name: 0 for name in WGMMA_KERNELS}
    for name in ("flash_fwd", "flash_bwd", "flash_decode", "flash_ring", "flash_ring_remote"):
        function = "?"
        for line in results[name].log.splitlines():
            if "Function properties for" in line:
                function = _kernel_name(line.split()[-1], with_args=True)
            elif "stack frame" in line and "_kernel" in function:
                log(f"  ptxas {function}: {line.strip()}")
                kernel = function.split("<")[0]
                if kernel in wgmma_reports:
                    wgmma_reports[kernel] += 1
                    check(" 0 bytes spill stores, 0 bytes spill loads" in line,
                          f"{function} spills: {line.strip()}")
    check(wgmma_reports == WGMMA_KERNELS,
          f"ptxas reported {wgmma_reports} bf16 wgmma instantiations, not {WGMMA_KERNELS}")
    # registers of each wgmma kernel, and the WARPGROUP.DEPBAR waits in its
    # SASS (one per wgmma wait in the source; ptxas adds one before every
    # wgmma it serializes)
    reports = {name: _sass_report(results[name].path)
               for name in ("flash_fwd", "flash_bwd", "flash_ring", "flash_ring_remote")}
    for name, report in reports.items():
        usage = {line.split(":")[0]: line for line in _ptxas_usage(results[name].log)}
        for kernel, row in report.items():
            if kernel.split("<")[0] in WGMMA_KERNELS:
                log(f"  SASS {kernel}: {row['hgmma']} HGMMA, {row['depbar']} WARPGROUP.DEPBAR; "
                    f"ptxas {usage.get(kernel, '?').split(': ', 1)[-1]}")
    # the fused ring's kernels: the local memory they touch, in all and in
    # their innermost loop that runs the tensor cores, whose bf16 loop must
    # run wgmma and no mma.sync; slot memory is rewritten by other SMs during
    # the remote tier's launch, so none of its loads may take the
    # non-coherent read-only path, and its bf16 stages must come through L2
    # alone (cp.async.cg: LDGSTS with BYPASS)
    for name in ("flash_ring", "flash_ring_remote"):
        for kernel, row in reports[name].items():
            log(f"  SASS {kernel}: {row['loads']} global loads, {row['constant']} through "
                f"the read-only path (LDG...CONSTANT), {row['ldgsts']} LDGSTS of which "
                f"{row['bypass']} BYPASS L1; local loads/stores {row['ldl']}/{row['stl']}; "
                f"{row['hmma']} HMMA in all; in the innermost tensor-core loop {row['hot']}")
            if kernel.split("<")[0] in RING_WGMMA_KERNELS:
                hot = row["hot_counts"]
                check(hot is not None and hot["hgmma"] > 0 and hot["hmma"] == 0
                      and row["hmma"] == 0 and hot["ldl"] == hot["stl"] == 0,
                      f"{kernel}: its hot loop is not on wgmma alone, or touches local "
                      f"memory: {row['hot']}")
            if name == "flash_ring_remote":
                check(row["loads"] > 0 and row["constant"] == 0,
                      f"{kernel}: read-only-path loads in the SASS")
                if kernel.split("<")[0] in RING_WGMMA_KERNELS:
                    check(row["ldgsts"] > 0 and row["bypass"] == row["ldgsts"],
                          f"{kernel}: stage copies that may read a slot through L1")
    _q8_build_report(results)


def _q8_build_report(results) -> None:
    """Phase 1 for the int8 kernels: the stack and spills of every B4 and B6
    instantiation (none may spill), and B4's SASS: int8 wgmma (IGMMA) and no
    mma.sync (IMMA), with the conversion instructions (I2F, I2FP, F2I,
    FRND) and MUFU.RCP in each loop that runs its products (the per-score
    conversions take the full-rate integer and FMA pipes instead)."""
    for name, kernels in (("flash_fwd_q8", Q8_FWD_KERNELS), ("flash_decode_q8", Q8_DECODE_KERNELS),
                          ("flash_ring", {"flash_ring_q8_kernel": 4}),
                          ("flash_ring_remote", {"flash_ring_remote_q8_kernel": 2})):
        function, seen = "?", 0
        for line in results[name].log.splitlines():
            if "Function properties for" in line:
                function = _kernel_name(line.split()[-1], with_args=True)
            elif "stack frame" in line and function.split("<")[0] in kernels:
                seen += 1
                log(f"  ptxas {function}: {line.strip()}")
                check(" 0 bytes spill stores, 0 bytes spill loads" in line,
                      f"{function} spills: {line.strip()}")
        check(seen == sum(kernels.values()),
              f"ptxas reported {seen} instantiations of {name}, not {sum(kernels.values())}")
    for name in ("flash_fwd_q8", "flash_ring", "flash_ring_remote"):
        usage = {line.split(":")[0]: line for line in _ptxas_usage(results[name].log)}
        for kernel, row in _sass_report(results[name].path).items():
            if kernel.split("<")[0] not in {**Q8_FWD_KERNELS, **Q8_RING_KERNELS}:
                continue
            log(f"  SASS {kernel}: {row['igmma']} IGMMA, {row['imma']} IMMA, "
                f"{row['depbar']} WARPGROUP.DEPBAR; ptxas "
                f"{usage.get(kernel, '?').split(': ', 1)[-1]}; loops with products: "
                + "; ".join(f"{n} instructions, " + ", ".join(f"{k} {v}" for k, v in c.items())
                            for n, c in row["product_loops"]))
            check(row["igmma"] > 0 and row["imma"] == 0, f"{kernel}: not on int8 wgmma alone")


def _sass_report(lib: Path) -> dict[str, dict]:
    """Per kernel of a built library (``cuobjdump -sass``): its wgmma
    (HGMMA; IGMMA in int8) and mma.sync (HMMA; IMMA) instructions and
    WARPGROUP.DEPBAR waits, the instruction count and conversions of each
    loop that holds an IGMMA,
    its global loads, those through the non-coherent read-only path, its
    cp.async copies (LDGSTS) and those that bypass L1, its local loads and
    stores, and the local loads, stores, HGMMA and HMMA inside its innermost
    loop that holds either product (None without one)."""
    import re

    from ring_attention_tpu_torch.ops import _build

    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    report = {}
    for section in sass.split("Function : ")[1:]:
        lines = section.splitlines()
        ops = [(int(m.group(1), 16), m.group(2)) for m in
               (re.search(r"/\*([0-9a-f]{4,6})\*/\s+(.*?);", line) for line in lines) if m]

        def count(pattern, lo=0, hi=1 << 40):
            return sum(bool(re.search(pattern, t)) for a, t in ops if lo <= a <= hi)

        loops = [(int(b.group(1), 16), a) for a, t in ops
                 if (b := re.search(r"BRA\s+0x([0-9a-f]+)", t)) and int(b.group(1), 16) < a]
        hot = [(lo, hi) for lo, hi in loops if count(r"HG?MMA", lo, hi)]
        product_loops = [
            (count(".", lo, hi), {key: count(pattern, lo, hi) for key, pattern in (
                ("IGMMA", "IGMMA"), ("I2F", r"I2F\b|I2F\."), ("I2FP", "I2FP"),
                ("F2I", r"F2I\b|F2I\."), ("FRND", "FRND"), ("MUFU.RCP", r"MUFU\.RCP"),
                ("MUFU.EX2", r"MUFU\.EX2"))})
            for lo, hi in sorted(set(loops)) if count("IGMMA", lo, hi)]
        inner = min(hot, key=lambda x: x[1] - x[0]) if hot else None
        hot_counts = None if inner is None else {
            key: count(pattern, *inner) for key, pattern in
            (("ldl", "LDL"), ("stl", "STL"), ("hgmma", "HGMMA"), ("hmma", "HMMA"))}
        report[_kernel_name(lines[0].strip(), with_args=True)] = {
            "hgmma": count("HGMMA"), "hmma": count("HMMA"),
            "igmma": count("IGMMA"), "imma": count(r"IMMA"), "product_loops": product_loops,
            "depbar": count(r"WARPGROUP\.DEPBAR"),
            "loads": count("LDG"), "constant": count(r"LDG.*CONSTANT"),
            "ldgsts": count("LDGSTS"), "bypass": count(r"LDGSTS.*BYPASS"),
            "ldl": count("LDL"), "stl": count("STL"), "hot_counts": hot_counts,
            "hot": None if inner is None else ", ".join(
                f"{key.upper()} {n}" for key, n in hot_counts.items())}
    check(len(report) >= 2, f"no kernels in the SASS of {lib.name}")
    return report


def _rand(gen, shape, dtype):
    import torch

    return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)


def _case_inputs(gen, case, dtype):
    """q, k, v, the key mask (its last row all False; FWD_EDGE_CASES' "half"
    masks keys 0..62 of every row) and the band of a case."""
    import torch

    b, h, hk, nq, nk, hi, lo, clamp, masked = case
    q = _rand(gen, (b, h, nq, 64), dtype)
    k = _rand(gen, (b, hk, nk, 64), dtype)
    v = _rand(gen, (b, hk, nk, 64), dtype)
    mask = None
    if masked == "half":  # FWD_EDGE_CASES
        mask = torch.ones((b, nk), dtype=torch.bool, device="cuda")
        mask[:, :63] = False
    elif masked:
        mask = torch.rand((b, nk), generator=gen, device="cuda") > 0.3
        mask[-1] = False
    kw = dict(scale=0.125, causal_offset=hi, window_lo=lo, softclamp_value=clamp)
    return q, k, v, mask, kw


# Phase-2 decode cases (b 4): name: (h, hk, nq, nk, softclamp, key mask).
# "ragged": a valid prefix of random length per request; "all masked": the
# same with request 0 attending no key (it averages V over all nk keys).
DECODE_CASES = {
    "b4 h8 hk2 nk32768": (8, 2, 1, 32768, None, "ragged"),
    "b4 h8 hk8 nk4096": (8, 8, 1, 4096, None, "ragged"),
    "b4 h8 hk2 nk5000 all masked": (8, 2, 1, 5000, None, "all masked"),
    "b4 h8 hk2 nq2 nk4097 softclamp": (8, 2, 2, 4097, 30.0, "ragged"),
    "b4 mqa h8 hk1 nk3001": (8, 1, 1, 3001, None, "ragged"),
}


def _decode_inputs(gen, case, dtype):
    """q, k, v, the key mask and the softclamp of a decode case."""
    import torch

    h, hk, nq, nk, clamp, mask_kind = case
    b = 4
    q = _rand(gen, (b, h, nq, 64), dtype)
    k = _rand(gen, (b, hk, nk, 64), dtype)
    v = _rand(gen, (b, hk, nk, 64), dtype)
    lengths = torch.randint(1, nk + 1, (b,), generator=gen, device="cuda")
    mask = torch.arange(nk, device="cuda")[None, :] < lengths[:, None]
    if mask_kind == "all masked":
        mask[0] = False
    return q, k, v, mask, clamp


def _compare(name, dtype, out, ref_out, lse, ref_lse, errors, rel_tol=None):
    """Elementwise out (OUT_TOL) and lse (LSE_TOL) against the plain
    version, and with ``rel_tol`` also ||out - plain|| / ||plain||."""
    import torch

    atol, rtol = OUT_TOL[str(dtype)]
    diff = out.float() - ref_out.float()
    err = diff.abs()
    out_ok = bool((err <= atol + rtol * ref_out.float().abs()).all())
    rel_note = ""
    if rel_tol is not None:
        rel = (diff.norm() / ref_out.float().norm().clamp_min(1e-30)).item()
        out_ok = out_ok and rel <= rel_tol
        rel_note = f"  ||out-plain||/||plain|| {rel:.3e} (tol {rel_tol})"
    latol, _ = LSE_TOL[str(dtype)]
    lse_err = (lse - ref_lse).abs().max().item()
    errors.append(err.max().item())
    log(f"  {name:<28} {str(dtype):<15} max|out-plain| {err.max().item():.3e} "
        f"(tol {atol}+{rtol}*|plain|){rel_note}  max|lse-plain| {lse_err:.3e} "
        f"(tol {latol})  {'ok' if out_ok and lse_err <= latol else 'FAIL'}")
    check(out_ok and lse_err <= latol, f"{name} {dtype}: kernel disagrees with plain")
    check(bool(torch.isfinite(out.float()).all()), f"{name} {dtype}: non-finite output")


def phase_kernel_vs_plain() -> tuple[float, float]:
    """Every case of the forward kernel and of the decode kernel against
    their plain versions; returns the largest |out - plain| of each."""
    import torch

    from ring_attention_tpu_torch.ops import cuda_flash as cf
    from ring_attention_tpu_torch.ops.partials import FlashPartials

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errors: list[float] = []
    dec_errors: list[float] = []
    log("phase 2: flash_fwd kernel vs flash_fwd_reference, flash_decode kernel vs "
        "flash_decode_reference, on the card")
    for dtype in (torch.bfloat16, torch.float32):
        for name, case in {**KERNEL_CASES, **FWD_EDGE_CASES}.items():
            q, k, v, mask, kw = _case_inputs(gen, case, dtype)
            out, lse = cf.flash_fwd(q, k, v, mask, **kw)
            torch.cuda.synchronize()
            ref_out, ref_lse = cf.flash_fwd_reference(q, k, v, mask, **kw)
            _compare(name, dtype, out, ref_out, lse, ref_lse, errors)
            torch.cuda.synchronize()

        # the split-KV decode (csrc/flash_decode.cu) against its plain
        # version, split the same way: the wrapper's own split count and a
        # single range, fused and as partials
        for name, case in DECODE_CASES.items():
            q, k, v, mask, clamp = _decode_inputs(gen, case, dtype)
            b, h, nq = q.shape[:3]
            hk, nk = k.shape[1:3]
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            own = cf.decode_splits(b * hk, -(-(h // hk * nq) // 16), nk, sms)
            for splits in sorted({own, 1}):
                kw = dict(softclamp_value=clamp, splits=splits)
                cf.decode_launch_count = cf.launch_count = 0
                out, lse = cf.cuda_flash_decode(q, k, v, mask, **kw)
                parts = cf.cuda_flash_decode(q, k, v, mask, fused=False, **kw)
                torch.cuda.synchronize()
                check((cf.decode_launch_count, cf.launch_count) == (2, 0),
                      f"decode {name}: launched flash_decode {cf.decode_launch_count} and "
                      f"flash_fwd {cf.launch_count} times, expected 2 and 0")
                ref_out, ref_lse = cf.flash_decode_reference(q, k, v, mask, **kw)
                _compare(f"decode {name} splits {splits}", dtype, out, ref_out, lse, ref_lse,
                         dec_errors)
                ref = cf.flash_decode_reference(q, k, v, mask, fused=False, **kw)
                _compare_partials(f"decode {name} splits {splits} partials", dtype,
                                  FlashPartials(*parts), FlashPartials(*ref), dec_errors)
                if case[-1] == "all masked":  # request 0 has no valid key
                    mean_v = v[0].float().mean(dim=1).repeat_interleave(h // hk, dim=0)
                    err = (out[0, :, 0].float() - mean_v).abs().max().item()
                    check(err <= OUT_TOL[str(dtype)][0],
                          f"decode {name}: the all-masked request is not the mean of V ({err})")
            torch.cuda.synchronize()

    # the serving forward's own shape: one 65,536-token causal sweep, held
    # row-block by row-block (the dense plain version of the whole sweep
    # would need 137 GB of scores)
    n = 65536
    q, k, v = (_rand(gen, (1, 8, n, 64), torch.bfloat16) for _ in range(3))
    out, lse = cf.flash_fwd(q, k, v, scale=0.125, causal_offset=0)
    torch.cuda.synchronize()
    for r0 in (0, n // 2, n - 1024):
        ref_out, ref_lse = cf.flash_fwd_reference(
            q[:, :, r0:r0 + 1024].contiguous(), k, v, scale=0.125, causal_offset=r0
        )
        _compare(f"causal (1,8,65536,64) rows {r0}+", torch.bfloat16,
                 out[:, :, r0:r0 + 1024], ref_out, lse[:, :, r0:r0 + 1024],
                 ref_lse, errors)
    torch.cuda.synchronize()
    return max(errors), max(dec_errors)


def _clone(parts):
    from ring_attention_tpu_torch.ops.partials import FlashPartials

    return FlashPartials(*(x.clone() for x in parts))


def _compare_partials(name, dtype, got, ref, errors) -> None:
    """Partials are held through what they stand for: finalized, their
    output and lse against the plain version's (an l off by the 4 threads
    of a row, or an m in other units, shows in both)."""
    from ring_attention_tpu_torch.ops.partials import finalize_partials

    check(all(x.dtype == ref_x.dtype and x.shape == ref_x.shape
              for x, ref_x in zip(got, ref)), f"{name}: partials layout")
    out, lse = finalize_partials(got)
    ref_out, ref_lse = finalize_partials(ref)
    _compare(name, dtype, out.to(dtype), ref_out.to(dtype), lse, ref_lse, errors,
             rel_tol=RING_REL_TOL[str(dtype)])


def _hop_chain(q, spans, bands, int8_block=None):
    """A rank's ring forward on the kernels, as parallel/ring.py runs it:
    seed, resumes in place, fused last span; ``spans`` are (k, v) and
    ``bands`` the causal offset of each hop (None: unmasked).  With
    ``int8_block`` the hops run the int8 sweep, quantized per block of that
    many keys (the ring's bucket)."""
    from ring_attention_tpu_torch.ops import cuda_flash as cf

    q8 = {} if int8_block is None else dict(compute_dtype="int8", block_k=int8_block)
    carry = None
    for (k, v), hi in zip(spans[:-1], bands[:-1]):
        carry = cf.flash_partials(q, k, v, scale=0.125, causal_offset=hi,
                                  carry=carry, out=carry, **q8)
    (k, v), hi = spans[-1], bands[-1]
    return cf.flash_fwd(q, k, v, scale=0.125, causal_offset=hi, carry=carry, **q8)


def _hop_chain_reference(q, spans, bands, int8_block=None):
    from ring_attention_tpu_torch.ops import cuda_flash as cf
    from ring_attention_tpu_torch.ops import cuda_flash_q8 as q8

    if int8_block is None:
        partials, fused, kw = cf.flash_partials_reference, cf.flash_fwd_reference, {}
    else:
        partials, fused = q8.flash_partials_q8_reference, q8.flash_fwd_q8_reference
        kw = dict(block_k=int8_block)
    carry = None
    for (k, v), hi in zip(spans[:-1], bands[:-1]):
        carry = partials(q, k, v, scale=0.125, causal_offset=hi, carry=carry, **kw)
    (k, v), hi = spans[-1], bands[-1]
    return fused(q, k, v, scale=0.125, causal_offset=hi, carry=carry, **kw)


def _hold_chain_in_slices(name, q, spans, bands, errors, w=1024, int8_block=None,
                          result=None) -> None:
    """A bf16 hop chain (or ``result``, the ``(out, lse)`` of a kernel that
    computes the same) against the chain's plain version in ``w``-row
    slices at the start, middle and end (the dense plain version of the
    whole chain would not fit): each slice's bands shift by its first row."""
    import torch

    out, lse = result if result is not None else _hop_chain(q, spans, bands, int8_block)
    torch.cuda.synchronize()
    n = q.shape[2]
    for r0 in (0, n // 2, n - w):
        rows = slice(r0, r0 + w)
        ref_out, ref_lse = _hop_chain_reference(
            q[:, :, rows].contiguous(), spans,
            tuple(None if hi is None else hi + r0 for hi in bands), int8_block)
        if int8_block is None:
            _compare(f"{name} rows {r0}+", torch.bfloat16, out[:, :, rows], ref_out,
                     lse[:, :, rows], ref_lse, errors,
                     rel_tol=RING_REL_TOL["torch.bfloat16"])
        else:
            _compare_q8(f"{name} rows {r0}+", torch.bfloat16, out[:, :, rows], ref_out,
                        lse[:, :, rows], ref_lse, errors)
        del ref_out, ref_lse
    torch.cuda.synchronize()


def phase_ring_modes_vs_plain() -> dict:
    """The forward kernel's ring modes against their plain versions:
    seed partials, resumed partials (into new tensors and in place) and
    the fused write from a carry, on every forward case, a 3-hop chain,
    the 4-hop chains phase 3c launches (n_local 16,384) and the 65,536-row
    hop chain of ring rank 3 at 262,144 tokens; returns the largest
    |out - plain| of each mode."""
    import torch

    from ring_attention_tpu_torch.ops import cuda_flash as cf

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    errors: dict[str, list[float]] = {"seed": [], "resume": [], "fused_carry": []}
    log("phase 2c: flash_fwd ring modes (seed partials, resume, fused from a "
        "carry) vs their plain versions")
    for dtype in (torch.bfloat16, torch.float32):
        for name, case in {**KERNEL_CASES, **FWD_EDGE_CASES}.items():
            q, k, v, mask, kw = _case_inputs(gen, case, dtype)
            # the carry of a first span with real content: unmasked, in full
            carry = cf.flash_partials_reference(
                q, _rand(gen, k.shape, dtype), _rand(gen, v.shape, dtype),
                scale=0.125,
            )
            got = cf.flash_partials(q, k, v, mask, **kw)
            torch.cuda.synchronize()
            ref = cf.flash_partials_reference(q, k, v, mask, **kw)
            _compare_partials(f"{name} seed", dtype, got, ref, errors["seed"])
            kept = _clone(carry)
            got = cf.flash_partials(q, k, v, mask, carry=carry, **kw)
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in zip(carry, kept)),
                  f"{name} {dtype}: a resume without out= changed its carry")
            ref = cf.flash_partials_reference(q, k, v, mask, carry=carry, **kw)
            _compare_partials(f"{name} resume", dtype, got, ref, errors["resume"])
            cf.flash_partials(q, k, v, mask, carry=kept, out=kept, **kw)
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in zip(kept, got)),
                  f"{name} {dtype}: the in-place resume differs from the resume")
            out, lse = cf.flash_fwd(q, k, v, mask, carry=carry, **kw)
            torch.cuda.synchronize()
            ref_out, ref_lse = cf.flash_fwd_reference(q, k, v, mask, carry=carry, **kw)
            _compare(f"{name} fused+carry", dtype, out, ref_out, lse, ref_lse,
                     errors["fused_carry"], rel_tol=RING_REL_TOL[str(dtype)])
            del got, ref, carry, kept
        # a striped rank's 3 hops: its own shard (diagonal), a shard from a
        # rank ahead (hi = -1: row 0 has no key there, and its carry from
        # hop 0 must absorb the masked scores) and one from a rank behind
        n = 4096
        q = _rand(gen, (1, 8, n, 64), dtype)
        spans = [(_rand(gen, q.shape, dtype), _rand(gen, q.shape, dtype))
                 for _ in range(3)]
        out, lse = _hop_chain(q, spans, (0, -1, 0))
        torch.cuda.synchronize()
        ref_out, ref_lse = _hop_chain_reference(q, spans, (0, -1, 0))
        _compare("3-hop striped chain", dtype, out, ref_out, lse, ref_lse,
                 errors["fused_carry"], rel_tol=RING_REL_TOL[str(dtype)])

    # the spans phase 3c launches (65,536 tokens on a ring of 4, n_local
    # 16,384), per parallel/ring.py's hop bands.  Contiguous rank 3: its
    # diagonal, then three shards fully behind it, run unmasked.  Striped
    # rank r at hop i: band 0 when the keys' origin r - i is at or behind r,
    # -1 (row 0 sees no key) when it is ahead.
    n = 16384
    for layout, bands in (("contiguous rank 3", (0, None, None, None)),
                          ("striped rank 0", (0, -1, -1, -1)),
                          ("striped rank 1", (0, 0, -1, -1)),
                          ("striped rank 2", (0, 0, 0, -1))):
        q = _rand(gen, (1, 8, n, 64), torch.bfloat16)
        spans = [(_rand(gen, q.shape, torch.bfloat16), _rand(gen, q.shape, torch.bfloat16))
                 for _ in range(4)]
        _hold_chain_in_slices(f"{layout} 4 x {n}", q, spans, bands,
                              errors["fused_carry"])

    # ring rank 3 of a contiguous causal ring of 4 at 262,144 tokens
    n = 65536
    q = _rand(gen, (1, 8, n, 64), torch.bfloat16)
    spans = [(_rand(gen, q.shape, torch.bfloat16), _rand(gen, q.shape, torch.bfloat16))
             for _ in range(4)]
    _hold_chain_in_slices(f"hop chain 4 x {n}", q, spans, (0, None, None, None),
                          errors["fused_carry"])
    return {mode: max(errs) for mode, errs in errors.items()}


# Phase-2e cases of the fused ring kernel, every rank of a ring of 4:
# name: (b, h, hk, n_local, ring arguments, softclamp, key mask)
FUSED_CASES = {
    "contiguous causal": (1, 8, 8, 1024, dict(causal=True), None, False),
    "striped causal": (1, 8, 8, 1024, dict(causal=True, striped=True), None, False),
    # 1,500 tokens back over shards of 1,000 (ragged tiles): 3 of 4 passes
    "window 1500, 3 passes, n_local 1000": (
        1, 8, 8, 1000, dict(causal=True, window=1500, max_ring_passes=3), None, False),
    "striped window 700": (1, 8, 8, 1024, dict(causal=True, striped=True, window=700),
                           None, False),
    "GQA h8 hk2 striped": (1, 8, 2, 1024, dict(causal=True, striped=True), None, False),
    "softclamp 50": (1, 8, 8, 1024, dict(causal=True), 50.0, False),
    "kv_mask, one all-False row": (2, 8, 8, 1024, dict(), None, True),
    # held to the hop chain only: a causal row that sees no key averages V
    # over the tiles the kernels visit, the plain version over every key
    "causal kv_mask, one all-False row": (2, 8, 8, 1024, dict(causal=True), None, True),
}
FUSED_CHAIN_ONLY = ("causal kv_mask, one all-False row",)


def _fused_tables(rank, n_local, ring_size=RING_SIZE, causal=False, striped=False,
                  window=None, max_ring_passes=None):
    """The hop tables of ``rank`` on the card, as the fused ring builds them."""
    from ring_attention_tpu_torch.parallel import ring as pring

    passes = min(max_ring_passes or ring_size, ring_size)
    tables = pring._fused_tables(rank, passes, n_local, causal, striped, window,
                                 ring_size, device="cuda")
    return dict(zip(("origins", "his", "los", "works"), tables))


def _compare_to_chain(name, dtype, out, chain, lse=None, chain_lse=None) -> float:
    """The fused kernel's output against the hop chain of the forward
    kernel on the same spans: max|diff| and the norm-relative distance
    printed, every element identical (B7 and B8 walk B1's own sweep hop by
    hop, its carry between hops as the chain stores and loads it)."""
    diff = out.float() - chain.float()
    err = diff.abs().max().item()
    rel = (diff.norm() / chain.float().norm().clamp_min(1e-30)).item()
    same = bool((out == chain).all())
    note = ""
    if lse is not None:
        note = f", max|lse - chain| {(lse - chain_lse).abs().max().item():.3e}"
        same = same and bool((lse == chain_lse).all())
    log(f"  {name:<40} {str(dtype):<15} vs the hop chain: max|diff| {err:.3e}, "
        f"rel {rel:.3e}{note}, bit-identical {same}")
    check(same and err == 0, f"{name} {dtype}: fused ring vs hop chain")
    return err


def _chain_schedule(k_all, v_all, tables, n):
    """The hop chain that one fused launch stands for: the (k, v) blocks of
    the hops with work, in hop order, and each one's causal offset (None
    where the band covers the whole block).  Unwindowed tables only."""
    origins, his, los, works = (tables[key].tolist()
                                for key in ("origins", "his", "los", "works"))
    check(all(lo <= -n for lo in los), "a windowed table has no plain hop chain here")
    live = [(o, hi) for o, hi, w in zip(origins, his, works) if w]
    spans = [(k_all[:, :, o * n:(o + 1) * n].contiguous(),
              v_all[:, :, o * n:(o + 1) * n].contiguous()) for o, _ in live]
    return spans, tuple(None if hi >= n - 1 else hi for _, hi in live)


def _fused_rank_inputs(gen, n, rank=RING_SIZE - 1, striped=False):
    """One rank of a causal ring of 4, contiguous or striped: (1, 8, n, 64)
    queries, the gathered (1, 8, 4n, 64) keys and values, the tables, and
    the spans and bands of its hop chain (bench.py::_hop_sequence)."""
    import torch

    q = _rand(gen, (1, 8, n, 64), torch.bfloat16)
    k_all, v_all = (_rand(gen, (1, 8, RING_SIZE * n, 64), torch.bfloat16)
                    for _ in range(2))
    tables = _fused_tables(rank, n, causal=True, striped=striped)
    return (q, k_all, v_all, tables) + _chain_schedule(k_all, v_all, tables, n)


def phase_fused_ring_vs_plain() -> float:
    """The fused ring kernel (csrc/flash_ring.cu) against its plain version
    and against the forward kernel's hop chain on the same spans; returns
    the largest |out - plain|."""
    import torch

    from ring_attention_tpu_torch.ops import cuda_ring as cr
    from ring_attention_tpu_torch.parallel import VirtualRing, ring_flash_attention

    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    errors: list[float] = []
    chain_errors: list[float] = []
    log("phase 2e: fused ring kernel (flash_ring) vs fused_ring_local_plain and vs "
        "the hop chain of flash_fwd, every rank of a ring of 4")
    for dtype in (torch.bfloat16, torch.float32):
        for name, (b, h, hk, n, ring_kw, clamp, masked) in FUSED_CASES.items():
            q = _rand(gen, (b, h, RING_SIZE * n, 64), dtype)
            k, v = (_rand(gen, (b, hk, RING_SIZE * n, 64), dtype) for _ in range(2))
            mask = None
            if masked:
                mask = torch.rand((b, RING_SIZE * n), generator=gen, device="cuda") > 0.3
                mask[-1] = False
            if name not in FUSED_CHAIN_ONLY:
                for rank in range(RING_SIZE):
                    q_r = q[:, :, rank * n:(rank + 1) * n].contiguous()
                    kw = dict(n_local=n, scale=0.125, softclamp_value=clamp,
                              **_fused_tables(rank, n, **ring_kw))
                    out, lse = cr.fused_ring_local(q_r, k, v, mask, **kw)
                    torch.cuda.synchronize()
                    ref_out, ref_lse = cr.fused_ring_local_plain(q_r, k, v, mask, **kw)
                    _compare(f"{name} rank {rank}", dtype, out, ref_out, lse, ref_lse,
                             errors, rel_tol=RING_REL_TOL[str(dtype)])
                    del out, lse, ref_out, ref_lse
            with torch.no_grad():
                ring = dict(ring_kw, softclamp_value=clamp, scale=0.125)
                chain = ring_flash_attention(q, k, v, mask, VirtualRing(RING_SIZE),
                                             impl="cuda", **ring)
                fused = ring_flash_attention(q, k, v, mask, VirtualRing(RING_SIZE),
                                             impl="fused", **ring)
            torch.cuda.synchronize()
            chain_errors.append(_compare_to_chain(f"{name}, ring of 4", dtype, fused, chain))

    # the launches phase 3e makes: 65,536 tokens on a ring of 4 (n_local
    # 16,384, h8 hk8 bf16), every rank of both layouts, each launch held to
    # the plain chain in 1,024-row slices, then the whole ring held to the
    # scan-path ring (impl="cuda") on the same inputs
    n = 16384
    for striped in (False, True):
        layout = "striped" if striped else "contiguous"
        q = _rand(gen, (1, 8, RING_SIZE * n, 64), torch.bfloat16)
        k, v = (_rand(gen, q.shape, torch.bfloat16) for _ in range(2))
        for rank in range(RING_SIZE):
            tables = _fused_tables(rank, n, causal=True, striped=striped)
            q_r = q[:, :, rank * n:(rank + 1) * n].contiguous()
            result = cr.fused_ring_local(q_r, k, v, n_local=n, scale=0.125, **tables)
            spans, bands = _chain_schedule(k, v, tables, n)
            _hold_chain_in_slices(f"flash_ring {layout} rank {rank} 4 x {n}", q_r, spans,
                                  bands, errors, result=result)
            del result, spans
        with torch.no_grad():
            ring = dict(causal=True, striped=striped, scale=0.125)
            chain = ring_flash_attention(q, k, v, None, VirtualRing(RING_SIZE),
                                         impl="cuda", **ring)
            fused = ring_flash_attention(q, k, v, None, VirtualRing(RING_SIZE),
                                         impl="fused", **ring)
        torch.cuda.synchronize()
        chain_errors.append(_compare_to_chain(f"{layout} causal 4 x {n}, ring of 4",
                                              torch.bfloat16, fused, chain))
        del q, k, v, chain, fused

    # ring rank 3 at 262,144 tokens: one launch over the 4 x 65,536 span
    n = 65536
    q, k_all, v_all, tables, spans, bands = _fused_rank_inputs(gen, n)
    out, lse = cr.fused_ring_local(q, k_all, v_all, n_local=n, scale=0.125, **tables)
    torch.cuda.synchronize()
    chain_out, chain_lse = _hop_chain(q, spans, bands)
    torch.cuda.synchronize()
    chain_errors.append(_compare_to_chain(f"rank 3 at 262144 (4 x {n})", torch.bfloat16,
                                          out, chain_out, lse, chain_lse))
    del chain_out, chain_lse
    _hold_chain_in_slices(f"flash_ring rank 3 4 x {n}", q, spans, bands, errors,
                          result=(out, lse))
    log(f"  largest |fused - hop chain| over phase 2e: {max(chain_errors):.3e}")
    return max(errors)


# Phase-2f cases of the remote-tier kernel, every rank of each ring:
# name: (ring size, b, h, hk, n_local, ring arguments, softclamp)
REMOTE_CASES = {
    "ring 2 contiguous causal": (2, 1, 8, 8, 1024, dict(causal=True), None),
    "ring 2 striped causal": (2, 1, 8, 8, 1024, dict(causal=True, striped=True), None),
    "ring 4 contiguous causal": (4, 1, 8, 8, 1024, dict(causal=True), None),
    "ring 4 striped causal": (4, 1, 8, 8, 1024, dict(causal=True, striped=True), None),
    "ring 8 contiguous causal": (8, 1, 8, 8, 512, dict(causal=True), None),
    "ring 8 striped causal": (8, 1, 8, 8, 512, dict(causal=True, striped=True), None),
    # 1,500 tokens back over shards of 1,000 (ragged tiles): 3 of 4 passes
    "ring 4 window 1500, 3 passes, n_local 1000": (
        4, 2, 8, 8, 1000, dict(causal=True, window=1500, max_ring_passes=3), None),
    "ring 4 GQA h8 hk2 striped": (4, 1, 8, 2, 1024, dict(causal=True, striped=True), None),
    "ring 4 softclamp 50": (4, 1, 8, 8, 1024, dict(causal=True), 50.0),
    "ring 4 not causal": (4, 2, 8, 8, 512, dict(), None),
}
STRESS_LAUNCHES = 50
TABLE_NAMES = ("origins", "his", "los", "works")


def _remote_tables(ring_size, n_local, causal=False, striped=False, window=None,
                   max_ring_passes=None):
    """Every rank's hop tables on the host, as the remote tier takes them."""
    from ring_attention_tpu_torch.parallel import ring as pring

    passes = min(max_ring_passes or ring_size, ring_size)
    return [pring._fused_tables(rank, passes, n_local, causal, striped, window, ring_size)
            for rank in range(ring_size)]


def _remote_inputs(gen, ring_size, b, h, hk, n, dtype):
    """Per-rank shards q (b, h, n, 64), k and v (b, hk, n, 64)."""
    qs = [_rand(gen, (b, h, n, 64), dtype) for _ in range(ring_size)]
    ks = [_rand(gen, (b, hk, n, 64), dtype) for _ in range(ring_size)]
    vs = [_rand(gen, (b, hk, n, 64), dtype) for _ in range(ring_size)]
    return qs, ks, vs


def _local_tier(qs, ks, vs, tables, clamp=None):
    """B7 for every rank over the gathered span: per-rank (outs, lses)."""
    import torch

    from ring_attention_tpu_torch.ops import cuda_ring as cr

    k_all, v_all = torch.cat(ks, dim=2), torch.cat(vs, dim=2)
    results = [cr.fused_ring_local(q, k_all, v_all, n_local=q.shape[2], scale=0.125,
                                   softclamp_value=clamp,
                                   **dict(zip(TABLE_NAMES, (t.cuda() for t in table))))
               for q, table in zip(qs, tables)]
    return [o for o, _ in results], [lse for _, lse in results]


def _chain_ring(qs, ks, vs, ring_kw, clamp=None):
    """The ``impl="cuda"`` hop chain of every rank, as
    ``parallel/ring.py::_ring_fwd_cuda`` runs it: per-rank (outs, lses)."""
    import torch

    from ring_attention_tpu_torch.parallel import VirtualRing
    from ring_attention_tpu_torch.parallel import ring as pring

    ring_size = len(qs)
    cfg = dict(impl="cuda", causal=ring_kw.get("causal", False),
               striped=ring_kw.get("striped", False), bucket_size=None,
               passes=min(ring_kw.get("max_ring_passes") or ring_size, ring_size),
               window=ring_kw.get("window"), softclamp_value=clamp, scale=0.125,
               compute_dtype=None, hop_compression=None, streams=[(1, 0, qs[0].shape[2])],
               counter_rotate=False, dkv_dtype=torch.float32)
    return pring._ring_fwd_cuda(qs, ks, vs, None, None, None, VirtualRing(ring_size), cfg)


def _hold_identical(name, dtype, got, ref, what) -> None:
    """Every rank's out and lse of ``got`` equal to ``ref``'s, bit for bit."""
    out_err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got[0], ref[0]))
    lse_err = max((a - b).abs().max().item() for a, b in zip(got[1], ref[1]))
    same = all(bool((a == b).all()) for a, b in zip(got[0] + got[1], ref[0] + ref[1]))
    log(f"  {name:<44} {str(dtype):<15} vs {what}: max|out diff| {out_err:.3e}, "
        f"max|lse diff| {lse_err:.3e}, bit-identical {same}")
    check(same and out_err == 0 and lse_err == 0, f"{name} {dtype}: remote tier vs {what}")


def _raises(fn, exc_type) -> str | None:
    """The message of the ``exc_type`` that ``fn`` raises, or None."""
    try:
        fn()
    except exc_type as exc:
        return str(exc)
    return None


def _remote_stress(gen) -> None:
    """50 launches of the causal ring of 4 with each block split, every one
    bit for bit the first launch; then a grid the card cannot hold at once,
    which must raise."""
    import torch

    from ring_attention_tpu_torch.ops import cuda_ring_remote as crr

    n, ring_size = 1024, RING_SIZE
    qs, ks, vs = _remote_inputs(gen, ring_size, 1, 8, 8, n, torch.bfloat16)
    kw = dict(tables=_remote_tables(ring_size, n, causal=True), n_local=n, scale=0.125)
    capacity = crr._capacity(torch.cuda.current_device(), True, False)
    split = crr.balanced_split(kw["tables"], n, 8,
                               crr._grid_blocks(capacity, ring_size, 8, n, True))
    first_outs, first_lses = crr.fused_ring_remote(qs, ks, vs, **kw)
    first = first_outs + first_lses
    for label, cta_split in (("balanced", split),
                             ("rank 0 on one block", [1] + split[1:]),
                             ("rank 3 on one block", split[:3] + [1])):
        start = time.perf_counter()
        same = 0
        for _ in range(STRESS_LAUNCHES):
            outs, lses = crr.fused_ring_remote(qs, ks, vs, **kw, cta_split=cta_split)
            same += all(bool(torch.equal(a, b)) for a, b in zip(outs + lses, first))
        seconds = time.perf_counter() - start
        log(f"  stress, causal ring of 4 x {n} bf16, blocks {cta_split} ({label}): "
            f"{same} of {STRESS_LAUNCHES} launches bit-identical to the first, "
            f"{seconds:.2f} s")
        check(same == STRESS_LAUNCHES, f"stress ({label}): a launch differed")
    too_big = split[:3] + [capacity + 1 - sum(split[:3])]
    message = _raises(lambda: crr.fused_ring_remote(qs, ks, vs, **kw, cta_split=too_big),
                      ValueError)
    log(f"  blocks {too_big} ({capacity + 1}, the card holds {capacity} at once): "
        f"raised {message!r}")
    check(message is not None and "does not fit" in message,
          "a grid the card cannot hold at once did not raise")
    outs, lses = crr.fused_ring_remote(qs, ks, vs, **kw)
    check(all(bool(torch.equal(a, b)) for a, b in zip(outs + lses, first)),
          "the launch after the refused grid differs")


def phase_fused_remote_vs_plain() -> float:
    """The remote-tier kernel (csrc/flash_ring_remote.cu) against its plain
    version, B7 and the hop chain, then the stress launches; returns the
    largest |out - plain|."""
    import torch

    from ring_attention_tpu_torch.ops import cuda_ring_remote as crr

    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    errors: list[float] = []
    log("phase 2f: the remote tier (flash_ring_remote, one launch per ring) vs "
        "fused_ring_remote_plain, vs B7 over the gathered span and vs the hop chain")
    for dtype in (torch.bfloat16, torch.float32):
        for name, (ring_size, b, h, hk, n, ring_kw, clamp) in REMOTE_CASES.items():
            qs, ks, vs = _remote_inputs(gen, ring_size, b, h, hk, n, dtype)
            kw = dict(tables=_remote_tables(ring_size, n, **ring_kw), n_local=n,
                      scale=0.125, softclamp_value=clamp)
            outs, lses = crr.fused_ring_remote(qs, ks, vs, **kw)
            torch.cuda.synchronize()
            ref_outs, ref_lses = crr.fused_ring_remote_plain(qs, ks, vs, **kw)
            for rank in range(ring_size):
                _compare(f"{name} rank {rank}", dtype, outs[rank], ref_outs[rank],
                         lses[rank], ref_lses[rank], errors,
                         rel_tol=RING_REL_TOL[str(dtype)])
            del ref_outs, ref_lses
            _hold_identical(name, dtype, (outs, lses),
                            _local_tier(qs, ks, vs, kw["tables"], clamp), "B7")
            _hold_identical(name, dtype, (outs, lses),
                            _chain_ring(qs, ks, vs, ring_kw, clamp), "the hop chain")

    # the launch the fused model makes: a causal ring of 4 x 16,384, h8 hk8
    # bf16, both layouts; each rank also against the plain chain in slices
    n = 16384
    for striped in (False, True):
        layout = "striped" if striped else "contiguous"
        qs, ks, vs = _remote_inputs(gen, RING_SIZE, 1, 8, 8, n, torch.bfloat16)
        tables = _remote_tables(RING_SIZE, n, causal=True, striped=striped)
        outs, lses = crr.fused_ring_remote(qs, ks, vs, tables=tables, n_local=n, scale=0.125)
        torch.cuda.synchronize()
        name = f"{layout} causal ring of 4 x {n}"
        _hold_identical(name, torch.bfloat16, (outs, lses), _local_tier(qs, ks, vs, tables),
                        "B7")
        _hold_identical(name, torch.bfloat16, (outs, lses),
                        _chain_ring(qs, ks, vs, dict(causal=True, striped=striped)),
                        "the hop chain")
        k_all, v_all = torch.cat(ks, dim=2), torch.cat(vs, dim=2)
        for rank, table in enumerate(tables):
            spans, bands = _chain_schedule(k_all, v_all, dict(zip(TABLE_NAMES, table)), n)
            _hold_chain_in_slices(f"flash_ring_remote {layout} rank {rank} 4 x {n}",
                                  qs[rank], spans, bands, errors,
                                  result=(outs[rank], lses[rank]))
            del spans
        del qs, ks, vs, outs, lses, k_all, v_all
    _remote_stress(gen)
    return max(errors)


def _compare_bwd(name, dtype, got, ref, errors) -> None:
    """Norm-relative and max-abs error of each of (dq, dk, dv)."""
    import torch

    tol = BWD_REL_TOL[str(dtype)]
    parts = []
    ok = True
    for label, x, r in zip(("dq", "dk", "dv"), got, ref):
        if x is None:
            continue
        check(bool(torch.isfinite(x).all()), f"{name} {dtype}: non-finite {label}")
        diff = x.float() - r.float()
        rel = (diff.norm() / r.float().norm().clamp_min(1e-30)).item()
        abs_err = diff.abs().max().item()
        errors.setdefault(label, []).append(abs_err)
        ok = ok and rel <= tol
        parts.append(f"{label} rel {rel:.2e} max|d| {abs_err:.2e}")
    log(f"  {name:<32} {str(dtype):<15} " + ", ".join(parts)
        + f" (tol rel {tol})  {'ok' if ok else 'FAIL'}")
    check(ok, f"{name} {dtype}: backward kernels disagree with plain")


def phase_bwd_kernel_vs_plain() -> dict:
    """Both backward kernels against ``flash_bwd_reference`` on the
    forward's cases and on the 65,536-token causal backward; returns the
    largest |kernel - plain| of each gradient."""
    import torch

    from ring_attention_tpu_torch.ops import cuda_flash as cf

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    errors: dict[str, list[float]] = {}
    log("phase 2b: flash_bwd_dkv and flash_bwd_dq kernels vs flash_bwd_reference")
    for dtype in (torch.bfloat16, torch.float32):
        for name, case in KERNEL_CASES.items():
            q, k, v, mask, kw = _case_inputs(gen, case, dtype)
            do = _rand(gen, q.shape, dtype)
            out, lse = cf.flash_fwd(q, k, v, mask, **kw)
            delta = (do.float() * out.float()).sum(-1)
            dk, dv = cf.flash_bwd_dkv(do, q, k, v, lse, delta, mask, **kw)
            dq = cf.flash_bwd_dq(do, q, k, v, lse, delta, mask, **kw)
            torch.cuda.synchronize()
            ref = cf.flash_bwd_reference(do, q, k, v, lse, delta, mask, **kw)
            _compare_bwd(name, dtype, (dq, dk, dv), ref, errors)
            del ref
            torch.cuda.synchronize()

        # key counts one past, half past and one short of whole 128-key
        # blocks, and causal offsets that put the band's edge inside a block;
        # then the forward's edge cases, whose 128-row blocks are those of dq
        for name, case in {**BWD_EDGE_CASES, **FWD_EDGE_CASES}.items():
            q, k, v, mask, kw = _case_inputs(gen, case, dtype)
            do = _rand(gen, q.shape, dtype)
            out, lse = cf.flash_fwd(q, k, v, mask, **kw)
            delta = (do.float() * out.float()).sum(-1)
            dk, dv = cf.flash_bwd_dkv(do, q, k, v, lse, delta, mask, **kw)
            dq = cf.flash_bwd_dq(do, q, k, v, lse, delta, mask, **kw)
            torch.cuda.synchronize()
            ref = cf.flash_bwd_reference(do, q, k, v, lse, delta, mask, **kw)
            _compare_bwd(name, dtype, (dq, dk, dv), ref, errors)
            del ref
            torch.cuda.synchronize()

    # the training path's own shape, held in slices: the plain version takes
    # lse and delta as inputs, so a block of query rows (dq) or of keys
    # (dk, dv) is checked with the band shifted to the slice
    n, w = 65536, 1024
    q, k, v, do = (_rand(gen, (1, 8, n, 64), torch.bfloat16) for _ in range(4))
    kw = dict(scale=0.125, causal_offset=0)
    out, lse = cf.flash_fwd(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1)
    dk, dv = cf.flash_bwd_dkv(do, q, k, v, lse, delta, **kw)
    dq = cf.flash_bwd_dq(do, q, k, v, lse, delta, **kw)
    torch.cuda.synchronize()
    for r0 in (0, n // 2, n - w):
        rows = slice(r0, r0 + w)
        ref = cf.flash_bwd_reference(
            do[:, :, rows].contiguous(), q[:, :, rows].contiguous(), k, v,
            lse[:, :, rows].contiguous(), delta[:, :, rows].contiguous(),
            scale=0.125, causal_offset=r0,
        )
        _compare_bwd(f"causal 65536 dq rows {r0}+", torch.bfloat16,
                     (dq[:, :, rows], None, None), ref, errors)
        del ref
    for c0 in (0, n // 2, n - w):
        keys = slice(c0, c0 + w)
        ref = cf.flash_bwd_reference(
            do, q, k[:, :, keys].contiguous(), v[:, :, keys].contiguous(), lse,
            delta, scale=0.125, causal_offset=-c0,
        )
        _compare_bwd(f"causal 65536 dk/dv keys {c0}+", torch.bfloat16,
                     (None, dk[:, :, keys], dv[:, :, keys]), ref, errors)
        del ref
    torch.cuda.synchronize()
    return {label: max(errs) for label, errs in errors.items()}


def _model(dtype, device, **ring):
    """The benchmark model with the seeded weights (the same with and
    without a ring mesh in ``ring``, which may also override a field of
    BENCH_MODEL)."""
    import torch

    from ring_attention_tpu_torch import RingTransformer, init_random_params

    model = RingTransformer(**{**BENCH_MODEL, **ring}, dtype=dtype, device=device)
    init_random_params(model, torch.Generator().manual_seed(SEED))
    return model.eval()


def phase_serving_path() -> dict:
    """The serving path at full width; returns launch counts and timings."""
    import torch

    from ring_attention_tpu_torch.ops import cuda_flash as cf

    log("phase 3: RingTransformer serving path, bench model at full width, bf16")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = _model(torch.bfloat16, "cuda")
    vocab = BENCH_MODEL["num_tokens"]
    tokens = torch.randint(0, vocab, (1, 65536), generator=gen, device="cuda")
    prompts = torch.randint(0, vocab, (4, 2048), generator=gen, device="cuda")
    with torch.inference_mode():
        cf.launch_count = 0
        start = time.perf_counter()
        logits = model(tokens)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - start
        fwd_launches = cf.launch_count
        check(fwd_launches > 0, "forward never launched flash_fwd")
        check(tuple(logits.shape) == (1, 65536, vocab), f"logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits.float()).all()), "non-finite forward logits")
        log(f"  forward 1 x 65536 tokens: {fwd_s:.3f} s (first call), "
            f"flash_fwd launches {fwd_launches}")

        steps = 128
        _reset_counts()
        start = time.perf_counter()
        new = model.generate(prompts, max_len=4096, num_steps=steps)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - start
        counts = _read_counts()
        # the prompt runs the blockwise PyTorch prefill; each later token
        # runs the split-KV decode once per layer, and nothing else
        expected = _counts(flash_decode=BENCH_MODEL["depth"] * (steps - 1))
        check(counts == expected, f"generate launched {counts}, expected {expected}")
        check(tuple(new.shape) == (4, steps), f"generate shape {tuple(new.shape)}")
        check(bool(((new >= 0) & (new < vocab)).all()), "generated ids out of range")
        log(f"  generate 4 x (2048 prompt + {steps} new): {gen_s:.3f} s (first call), "
            f"flash_decode launches {counts['flash_decode']}, flash_fwd {counts['flash_fwd']}")

    launches = fwd_launches
    _hold_f32_model_to_cpu()
    return {"launches": launches, "decode_launches": counts["flash_decode"], "model": model,
            "tokens": tokens, "prompts": prompts}


def _hold_f32_model_to_cpu() -> None:
    """A float32 copy of the model at seq 256 on the card against the same
    weights on the CPU (plain versions): forward logits and decode steps."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = _model(None, "cuda")
    cpu = copy.deepcopy(gpu).to("cpu")
    gen = torch.Generator().manual_seed(SEED + 1)
    tokens = torch.randint(0, BENCH_MODEL["num_tokens"], (2, 256), generator=gen)
    with torch.inference_mode():
        errs = [(gpu(tokens.cuda()).cpu() - cpu(tokens)).abs().max().item()]
        caches = [m.init_cache(2, 256) for m in (gpu, cpu)]
        logits = [m.prefill(tokens[:, :200], c)[0].cpu() for m, c in zip((gpu, cpu), caches)]
        errs.append((logits[0] - logits[1]).abs().max().item())
        for pos in range(200, 208):
            step = [m.decode_step(tokens[:, pos], c, pos)[0].cpu()
                    for m, c in zip((gpu, cpu), caches)]
            errs.append((step[0] - step[1]).abs().max().item())
    log(f"  f32 model seq 256, card vs CPU: forward max|diff| {errs[0]:.3e}, "
        f"prefill {errs[1]:.3e}, 8 decode steps {max(errs[2:]):.3e} (tol {MODEL_ATOL})")
    check(max(errs) <= MODEL_ATOL, "f32 model on the card disagrees with the CPU")


def phase_training_path() -> dict:
    """The training path at full width; returns launch counts, losses and
    what phase 4b times."""
    import torch

    from ring_attention_tpu_torch import make_train_step
    from ring_attention_tpu_torch.ops import cuda_flash as cf

    log(f"phase 3b: training path, bench model at full width, bf16, "
        f"Adam(lr=1e-3), {TRAIN_STEPS} steps of 1 x 65536 tokens")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    model = _model(torch.bfloat16, "cuda").train()
    tokens = torch.randint(0, BENCH_MODEL["num_tokens"], (1, 65537),
                           generator=gen, device="cuda")
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = make_train_step(lambda t: model(t, return_loss=True), opt)
    losses, launches = [], {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}
    for i in range(TRAIN_STEPS):
        cf.launch_count = cf.dkv_launch_count = cf.dq_launch_count = 0
        start = time.perf_counter()
        loss = float(step(tokens))
        seconds = time.perf_counter() - start
        counts = {"flash_fwd": cf.launch_count, "flash_bwd_dkv": cf.dkv_launch_count,
                  "flash_bwd_dq": cf.dq_launch_count}
        log(f"  step {i}: loss {loss:.6f}, {seconds:.3f} s, launches {counts}")
        check(counts == {name: 2 for name in counts},
              f"step {i} launched {counts}, expected 2 of each kernel")
        check(math.isfinite(loss), f"step {i}: loss {loss}")
        losses.append(loss)
        for name, n in counts.items():
            launches[name] += n
    check(losses[-1] < losses[0], f"loss did not fall over {TRAIN_STEPS} steps: {losses}")
    _hold_f32_grads_to_cpu()
    return {"launches": launches, "losses": losses, "model": model, "opt": opt,
            "step": step, "tokens": tokens}


def _hold_f32_grads_to_cpu() -> None:
    """One step's gradients of a float32 copy of the model at seq 256, on
    the card (the f32 kernels) and on the CPU (the plain versions)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = _model(None, "cuda")
    cpu = copy.deepcopy(gpu).to("cpu")
    gen = torch.Generator().manual_seed(SEED + 6)
    tokens = torch.randint(0, BENCH_MODEL["num_tokens"], (2, 257), generator=gen)
    losses = []
    for m, t in ((gpu, tokens.cuda()), (cpu, tokens)):
        loss = m(t, return_loss=True)
        loss.backward()
        losses.append(loss.item())
    worst, worst_name = 0.0, ""
    for (name, pg), pc in zip(gpu.named_parameters(), cpu.parameters()):
        rel = ((pg.grad.cpu() - pc.grad).norm() / pc.grad.norm()).item()
        if rel >= worst:
            worst, worst_name = rel, name
    log(f"  f32 model seq 256, card vs CPU: loss {losses[0]:.7f} vs {losses[1]:.7f}, "
        f"worst gradient ||card - cpu|| / ||cpu|| {worst:.3e} ({worst_name}) "
        f"(tol {GRAD_REL_TOL})")
    check(worst <= GRAD_REL_TOL, "f32 gradients on the card disagree with the CPU")


def _causal_timing(name, n, with_plain):
    import torch
    import torch.nn.functional as F

    from ring_attention_tpu_torch.ops import cuda_flash as cf

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    q, k, v = (_rand(gen, (1, 8, n, 64), torch.bfloat16) for _ in range(3))
    kw = dict(scale=0.125, causal_offset=0)
    out, lse = cf.flash_fwd(q, k, v, **kw)
    ops = 4 * 64 * 8 * band_pairs(n, n, 0, None)
    b_ms, b_by = bound_ms(ops, nbytes(q, k, v, out, lse), torch.bfloat16)
    row = {
        "shape": f"causal (1,8,{n},64) bf16",
        "ms": time_ms(lambda: cf.flash_fwd(q, k, v, **kw)),
        "plain_ms": (time_ms(lambda: cf.flash_fwd_reference(q, k, v, **kw))
                     if with_plain else None),
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)
        ),
    }
    log(f"  {name}: kernel {row['ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"plain {row['plain_ms']} ms, sdpa {row['library_ms']:.4f} ms, "
        f"{ops / row['ms'] / 1e9:.1f} TFLOP/s")
    return row


def _streamed_ms(fn, calls: int = 20) -> float:
    """Device ms per call in a stream of ``calls`` back-to-back calls: a
    single call of a decode-sized kernel is host-bound (time_ms of one
    synchronized call is reported beside it)."""
    return time_ms(lambda: [fn() for _ in range(calls)]) / calls


def _graph_ms(fn, calls: int = 20) -> float:
    """Device ms per call of ``fn``, replayed from one CUDA graph of
    ``calls`` calls: the kernels' own time, without the host's launch work
    (which bounds a decode-sized call in a stream)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return time_ms(graph.replay) / calls


def _decode_timing(name, b, h, hk, nk):
    """The split-KV decode beside its bound, its plain version and SDPA on
    the same inputs: each on the device alone (CUDA graph), per call in a
    stream of 20 and as one synchronized call."""
    import torch
    import torch.nn.functional as F

    from ring_attention_tpu_torch.ops import cuda_flash as cf

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    q = _rand(gen, (b, h, 1, 64), torch.bfloat16)
    k = _rand(gen, (b, hk, nk, 64), torch.bfloat16)
    v = _rand(gen, (b, hk, nk, 64), torch.bfloat16)
    mask = torch.ones((b, nk), dtype=torch.bool, device="cuda")
    out, lse = cf.cuda_flash_decode(q, k, v, mask)
    ops = 4 * 64 * b * h * nk
    b_ms, b_by = bound_ms(ops, nbytes(q, k, v, mask, out, lse), torch.bfloat16)

    def decode():
        return cf.cuda_flash_decode(q, k, v, mask)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask[:, None, None, :],
                                              enable_gqa=h != hk)

    row = {
        "shape": f"decode b{b} h{h} hk{hk} nk{nk} bf16",
        "ms": _graph_ms(decode),
        "streamed_ms": _streamed_ms(decode),
        "sync_call_ms": time_ms(decode, iters=50),
        "plain_ms": time_ms(lambda: cf.flash_decode_reference(q, k, v, mask), iters=3),
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": _graph_ms(sdpa),
        "library_streamed_ms": _streamed_ms(sdpa),
        "library_sync_ms": time_ms(sdpa, iters=50),
    }
    log(f"  {name}: kernel {row['ms']:.4f} ms a call on the device (CUDA graph of 20), "
        f"{row['streamed_ms']:.4f} ms per call in a stream of 20, {row['sync_call_ms']:.4f} ms "
        f"a synchronized call; bound {b_ms:.4f} ms ({b_by}), {b_ms / row['ms']:.1%} of it; "
        f"plain {row['plain_ms']:.4f} ms; sdpa {row['library_ms']:.4f} / "
        f"{row['library_streamed_ms']:.4f} / {row['library_sync_ms']:.4f} ms (device, "
        f"streamed, synchronized); {nbytes(k, v) / row['ms'] / 1e6:.1f} GB/s of cache")
    return row


def _bwd_timings(n, iters, with_plain) -> dict[str, dict]:
    """Both backward kernels on the causal (1, 8, n, 64) bf16 backward."""
    import torch
    import torch.nn.functional as F

    from ring_attention_tpu_torch.ops import cuda_flash as cf

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    q, k, v, do = (_rand(gen, (1, 8, n, 64), torch.bfloat16) for _ in range(4))
    kw = dict(scale=0.125, causal_offset=0)
    out, lse = cf.flash_fwd(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1)
    args = (do, q, k, v, lse, delta)
    pairs = 8 * band_pairs(n, n, 0, None)  # in-band (query, key) pairs, 8 heads
    # the plain version and the library call compute all three gradients
    plain_ms = (time_ms(lambda: cf.flash_bwd_reference(*args, **kw), iters=iters)
                if with_plain else None)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    ref_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    library_ms = time_ms(lambda: torch.autograd.grad(
        ref_out, (qg, kg, vg), do, retain_graph=True), iters=iters)
    f32_grad = 4 * n * 64 * 8  # one (1, 8, n, 64) float32 gradient, bytes
    rows = {}
    for name, fn, products, out_bytes in (
        ("flash_bwd_dkv", cf.flash_bwd_dkv, 4, 2 * f32_grad),
        ("flash_bwd_dq", cf.flash_bwd_dq, 3, f32_grad),
    ):
        ops = 2 * products * 64 * pairs
        b_ms, b_by = bound_ms(ops, nbytes(*args) + out_bytes, torch.bfloat16)
        ms = time_ms(lambda: fn(*args, **kw), iters=iters)
        rows[name] = {"shape": f"causal (1,8,{n},64) bf16", "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": library_ms}
        log(f"  {name} causal {n}: kernel {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"plain (all three gradients) {plain_ms} ms, sdpa backward "
            f"{library_ms:.4f} ms, {ops / ms / 1e9:.1f} TFLOP/s")
    return rows


def _train_step_timing(step, tokens) -> tuple[float, list[float], int, int]:
    """Median ms of 5 synchronized steps after 2 warm-up steps, every step's
    seconds, the peak device memory over the 5 and the memory live before
    them (other models of this script included)."""
    import torch

    for _ in range(2):
        step(tokens)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for _ in range(5):
        start = time.perf_counter()
        step(tokens)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - start)
    return (statistics.median(step_s) * 1e3, step_s, torch.cuda.max_memory_allocated(),
            base)


def phase_train_timings(training: dict) -> dict[str, list[dict]]:
    """Phase 4b; returns each backward kernel's rows by shape."""
    import torch

    log("phase 4b: backward kernels and the train step")
    rows: dict[str, list[dict]] = {"flash_bwd_dkv": [], "flash_bwd_dq": []}
    for n, iters, with_plain in ((4096, 10, True), (65536, 10, False),
                                 (262144, 3, False)):
        for name, row in _bwd_timings(n, iters, with_plain).items():
            rows[name].append(row)

    model, opt, step, tokens = (training[k] for k in ("model", "opt", "step", "tokens"))
    n = tokens.shape[1] - 1
    ms, step_s, peak, base = _train_step_timing(step, tokens)
    fwd_s, bwd_s, opt_s = [], [], []
    for _ in range(3):  # the same work, split at its three stages
        opt.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        loss = model(tokens, return_loss=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        opt.step()
        torch.cuda.synchronize()
        fwd_s.append(t1 - t0)
        bwd_s.append(t2 - t1)
        opt_s.append(time.perf_counter() - t2)
    training["step_ms"], training["peak"], training["above"] = ms, peak, peak - base
    log(f"  train step 1 x {n} tokens: {ms:.3f} ms (median of 5 after 2 warm-up; "
        f"all {[round(x * 1e3, 3) for x in step_s]}), {n / ms * 1e3:.0f} tokens/s, "
        f"peak device memory {peak / 2**30:.3f} GiB, {(peak - base) / 2**30:.3f} GiB "
        f"above what was live before the step")
    log(f"  step split: forward + loss {statistics.median(fwd_s) * 1e3:.3f} ms, "
        f"backward {statistics.median(bwd_s) * 1e3:.3f} ms, "
        f"optimizer {statistics.median(opt_s) * 1e3:.3f} ms (medians of 3)")
    return rows


def _decode_step_ms(model, prompts, max_len) -> float:
    """The model's decode step (median of 10 after warm-up, CUDA events) for
    the requests of ``prompts`` after their prefill, the cache growing by a
    token a step."""
    import torch

    with torch.inference_mode():
        cache = model.init_cache(prompts.shape[0], max_len)
        logits, cache = model.prefill(prompts, cache)
        tok = logits.argmax(-1)
        pos = [prompts.shape[1]]

        def step():
            model.decode_step(tok, cache, pos[0])
            pos[0] += 1

        return time_ms(step)


def phase_timings(serving: dict) -> tuple[list[dict], list[dict]]:
    """Phase 4; returns the forward kernel's rows and the decode kernel's."""
    import torch

    log("phase 4: timings (CUDA events, median of 10 after warm-up)")
    rows = [
        _causal_timing("flash_fwd causal 4096", 4096, with_plain=True),
        _causal_timing("flash_fwd causal 65536 (serving forward)", 65536, with_plain=False),
        _causal_timing("flash_fwd causal 262144", 262144, with_plain=False),
    ]
    decode_rows = [
        _decode_timing("flash_decode b4 h8 hk2 nk32768", 4, 8, 2, 32768),
        _decode_timing("flash_decode b4 h8 hk8 nk4096 (serving decode)", 4, 8, 8, 4096),
        _decode_timing("flash_decode b1 h8 hk8 nk1048576", 1, 8, 8, 1 << 20),
    ]
    torch.cuda.empty_cache()
    model, tokens, prompts = serving["model"], serving["tokens"], serving["prompts"]
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: model(tokens))
    step_ms = _decode_step_ms(model, prompts, 4096)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    long_prompts = torch.randint(0, BENCH_MODEL["num_tokens"], (4, 32768), generator=gen,
                                 device="cuda")
    long_ms = _decode_step_ms(model, long_prompts, 32768 + 64)
    serving["fwd_ms"] = fwd_ms
    log(f"  model forward 1 x 65536: {fwd_ms:.3f} ms, "
        f"{65536 / fwd_ms * 1e3:.0f} tokens/s")
    log(f"  model decode step, 4 requests at ~2048-2060 cached tokens: "
        f"{step_ms:.3f} ms/step ({4 / step_ms * 1e3:.0f} tokens/s)")
    log(f"  model decode step, 4 requests at ~32768-32780 cached tokens: "
        f"{long_ms:.3f} ms/step ({4 / long_ms * 1e3:.0f} tokens/s)")
    return rows, decode_rows

# name: (module of ring_attention_tpu_torch.ops, launch counter)
COUNTERS = {"flash_fwd": ("cuda_flash", "launch_count"),
            "seed": ("cuda_flash", "seed_launch_count"),
            "resume": ("cuda_flash", "resume_launch_count"),
            "fused_carry": ("cuda_flash", "fused_carry_launch_count"),
            "flash_bwd_dkv": ("cuda_flash", "dkv_launch_count"),
            "flash_bwd_dq": ("cuda_flash", "dq_launch_count"),
            "seg_flash_fwd": ("cuda_flash", "seg_launch_count"),
            "seg_flash_bwd_dkv": ("cuda_flash", "seg_dkv_launch_count"),
            "seg_flash_bwd_dq": ("cuda_flash", "seg_dq_launch_count"),
            "doc_flash_fwd": ("cuda_flash", "doc_launch_count"),
            "doc_flash_bwd_dkv": ("cuda_flash", "doc_dkv_launch_count"),
            "doc_flash_bwd_dq": ("cuda_flash", "doc_dq_launch_count"),
            "flash_fwd_q8": ("cuda_flash_q8", "fwd_launch_count"),
            "q8_seed": ("cuda_flash_q8", "seed_launch_count"),
            "q8_resume": ("cuda_flash_q8", "resume_launch_count"),
            "q8_fused_carry": ("cuda_flash_q8", "fused_carry_launch_count"),
            "flash_decode": ("cuda_flash", "decode_launch_count"),
            "flash_decode_q8": ("cuda_flash_q8", "decode_launch_count"),
            "flash_ring": ("cuda_ring", "launch_count"),
            "seg_flash_ring": ("cuda_ring", "seg_launch_count"),
            "flash_ring_remote": ("cuda_ring_remote", "launch_count"),
            # the int8 ring's instantiations: B4 with ids, with a doc table,
            # fed K/V quantized before; B7's and B8's int8 kernels
            "seg_flash_fwd_q8": ("cuda_flash_q8", "seg_launch_count"),
            "doc_flash_fwd_q8": ("cuda_flash_q8", "doc_launch_count"),
            "feed_flash_fwd_q8": ("cuda_flash_q8", "feed_launch_count"),
            "q8_flash_ring": ("cuda_ring", "q8_launch_count"),
            "q8_flash_ring_remote": ("cuda_ring_remote", "q8_launch_count")}


def _counter_module(name: str):
    import importlib

    return importlib.import_module(f"ring_attention_tpu_torch.ops.{name}")


def _reset_counts() -> None:
    for module, attr in COUNTERS.values():
        setattr(_counter_module(module), attr, 0)


def _read_counts() -> dict[str, int]:
    return {name: getattr(_counter_module(module), attr)
            for name, (module, attr) in COUNTERS.items()}


def _counts(**nonzero) -> dict[str, int]:
    """Every counter at 0 but those named."""
    return {name: nonzero.get(name, 0) for name in COUNTERS}


def _ring_counts(striped: bool, backward: bool, int8: bool = False) -> dict[str, int]:
    """Launches of one forward (and backward) of the model on the ring:
    RING_SCHEDULE per layer, times the depth; ``int8`` runs the forward's
    modes on the int8 kernel."""
    seed, resume, fused, dkv, dq = (x * BENCH_MODEL["depth"] for x in RING_SCHEDULE[striped])
    prefix, fwd = ("q8_", "flash_fwd_q8") if int8 else ("", "flash_fwd")
    # the int8 ring quantizes K/V once per stream: every hop's B4 is fed
    feed = {"feed_flash_fwd_q8": seed + resume + fused} if int8 else {}
    return _counts(**{fwd: seed + resume + fused, f"{prefix}seed": seed,
                      f"{prefix}resume": resume, f"{prefix}fused_carry": fused,
                      "flash_bwd_dkv": dkv if backward else 0,
                      "flash_bwd_dq": dq if backward else 0, **feed})


def _fused_counts(striped: bool, backward: bool) -> dict[str, int]:
    """Launches of one unmasked forward (and backward) of the model on the
    fused ring: the remote-tier kernel once per layer (the whole ring in
    one launch), nothing of the local tier or the forward kernel, and the
    backward kernels per RING_SCHEDULE."""
    depth = BENCH_MODEL["depth"]
    *_, dkv, dq = RING_SCHEDULE[striped]
    return _counts(flash_ring_remote=depth,
                   flash_bwd_dkv=dkv * depth if backward else 0,
                   flash_bwd_dq=dq * depth if backward else 0)


def _hold_fused_ring_model(model, tokens, local, striped, logits, launches) -> None:
    """Phase 3e beside the logits: the scan-path ring model with the same
    seeded weights gives bit-identical logits (its hops run B1, whose sweep
    the remote tier walks hop by hop, the carry spilled in B1's format;
    their norm-relative distance is printed); and a request that the model
    pads and masks takes the local tier (B7 once per rank and layer), its
    logits held to the local model's.  That request goes to a non-causal
    copy of the model: 65,535 tokens do not divide over 4 ranks, so the
    model pads and builds a key mask, which only a non-causal layer keeps
    (a causal one drops it: the pad sits after every real query)."""
    import torch

    from ring_attention_tpu_torch.parallel import create_mesh

    layout = "striped" if striped else "contiguous"
    mesh = create_mesh(ring_size=RING_SIZE)
    scan = _model(torch.bfloat16, "cuda", mesh=mesh, striped=striped, impl="cuda")
    with torch.inference_mode():
        scan_logits = scan(tokens)
    del scan
    same = bool(torch.equal(scan_logits, logits))
    rel = ((logits.float() - scan_logits.float()).norm()
           / scan_logits.float().norm()).item()
    del scan_logits
    log(f"  {layout} forward 1 x 65536 vs the scan-path ring model (impl='cuda', the "
        f"same weights): ||fused - scan|| / ||scan|| {rel:.3e}, logits bit-identical {same}")
    check(same, f"{layout}: the remote-tier model's logits differ from the scan ring's")
    short = tokens[:, :-1]
    masked_model = _model(torch.bfloat16, "cuda", mesh=mesh, striped=striped, impl="fused",
                          causal=False)
    local_nc = _model(torch.bfloat16, "cuda", causal=False)
    with torch.inference_mode():
        ref = local_nc(short).float()
        _reset_counts()
        masked = masked_model(short)
        torch.cuda.synchronize()
        counts = _read_counts()
    del masked_model, local_nc
    expected = _counts(flash_ring=RING_SIZE * BENCH_MODEL["depth"])
    check(counts == expected, f"{layout} masked forward launched {counts}, expected {expected}")
    for name, n in counts.items():
        launches[name] += n
    rel = ((masked.float() - ref).norm() / ref.norm()).item()
    log(f"  {layout} non-causal forward 1 x 65535 (padded to 65536 and masked): launches "
        f"{counts}; logits vs the local non-causal model ||diff|| / ||local|| {rel:.3e} "
        f"(tol rel {RING_LOGITS_REL_TOL})")
    check(bool(torch.isfinite(masked.float()).all()) and rel <= RING_LOGITS_REL_TOL,
          f"{layout}: masked fused ring logits disagree with the local model")


def phase_ring_path(serving: dict, training: dict, impl: str = "cuda") -> dict:
    """The ring path at full width on a virtual ring of 4: logits against
    the local model, launch counts against the hop schedule, Adam steps;
    then the float32 ring on the card against the CPU.  ``impl="fused"``
    runs the whole ring's forward as one remote-tier launch per layer, and
    a masked request as one B7 launch per rank and layer (phase 3e)."""
    import torch

    from ring_attention_tpu_torch import make_train_step
    from ring_attention_tpu_torch.parallel import create_mesh

    expected = _ring_counts if impl == "cuda" else _fused_counts
    phase = "3c" if impl == "cuda" else "3e"
    log(f"phase {phase}: RingTransformer(mesh=create_mesh(ring_size={RING_SIZE}), "
        f"impl={impl!r}) on a virtual ring, bench model at full width, bf16")
    tokens, local = serving["tokens"], serving["model"]
    with torch.inference_mode():
        ref = local(tokens).float()
    launches = {name: 0 for name in COUNTERS}
    models = {}
    for striped in (False, True):
        layout = "striped" if striped else "contiguous"
        model = _model(torch.bfloat16, "cuda", mesh=create_mesh(ring_size=RING_SIZE),
                       striped=striped, impl=impl)
        with torch.inference_mode():
            _reset_counts()
            start = time.perf_counter()
            logits = model(tokens)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
            counts = _read_counts()
        check(counts == expected(striped, backward=False),
              f"{layout} forward launched {counts}, expected {expected(striped, False)}")
        for name, n in counts.items():
            launches[name] += n
        check(bool(torch.isfinite(logits.float()).all()), f"{layout}: non-finite logits")
        diff = logits.float() - ref
        rel = (diff.norm() / ref.norm()).item()
        log(f"  {layout} forward 1 x 65536: {seconds:.3f} s (first call), launches "
            f"{counts}; logits vs the local model ||diff|| / ||local|| {rel:.3e}, "
            f"max|diff| {diff.abs().max().item():.3e} (tol rel {RING_LOGITS_REL_TOL})")
        check(rel <= RING_LOGITS_REL_TOL, f"{layout} ring logits disagree with the local model")
        if impl == "fused":
            _hold_fused_ring_model(model, tokens, local, striped, logits, launches)
        del logits, diff

        model.train()
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        step = make_train_step(lambda t, m=model: m(t, return_loss=True), opt)
        losses = []
        for i in range(TRAIN_STEPS):
            _reset_counts()
            start = time.perf_counter()
            loss = float(step(training["tokens"]))
            seconds = time.perf_counter() - start
            counts = _read_counts()
            log(f"  {layout} step {i}: loss {loss:.6f}, {seconds:.3f} s, launches {counts}")
            check(counts == expected(striped, backward=True),
                  f"{layout} step {i} launched {counts}")
            check(math.isfinite(loss), f"{layout} step {i}: loss {loss}")
            losses.append(loss)
            for name, n in counts.items():
                launches[name] += n
        check(losses[-1] < losses[0], f"{layout}: loss did not fall: {losses}")
        models[layout] = (model, step)
    _hold_f32_ring_to_cpu(impl)
    return {"launches": launches, "models": models}


def _hold_f32_ring_to_cpu(impl: str) -> None:
    """A float32 copy of the ring model (seq 256, ring 4) on the card against
    the same model on the CPU: logits and one step's gradients."""
    import torch

    from ring_attention_tpu_torch.parallel import create_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED + 9)
    tokens = torch.randint(0, BENCH_MODEL["num_tokens"], (2, 257), generator=gen)
    for striped in (False, True):
        gpu = _model(None, "cuda", mesh=create_mesh(ring_size=RING_SIZE), striped=striped,
                     impl=impl)
        cpu = copy.deepcopy(gpu).to("cpu")
        with torch.no_grad():
            logits_err = (gpu(tokens[:, :256].cuda()).cpu() - cpu(tokens[:, :256])).abs().max().item()
        losses = []
        for m, t in ((gpu, tokens.cuda()), (cpu, tokens)):
            loss = m(t, return_loss=True)
            loss.backward()
            losses.append(loss.item())
        worst, worst_name = 0.0, ""
        for (name, pg), pc in zip(gpu.named_parameters(), cpu.parameters()):
            rel = ((pg.grad.cpu() - pc.grad).norm() / pc.grad.norm()).item()
            if rel >= worst:
                worst, worst_name = rel, name
        log(f"  f32 {impl} ring model ({'striped' if striped else 'contiguous'}) seq 256, card "
            f"vs CPU: logits max|diff| {logits_err:.3e} (tol {MODEL_ATOL}), loss "
            f"{losses[0]:.7f} vs {losses[1]:.7f}, worst gradient ||card - cpu|| / "
            f"||cpu|| {worst:.3e} ({worst_name}) (tol {GRAD_REL_TOL})")
        check(logits_err <= MODEL_ATOL, "f32 ring logits on the card disagree with the CPU")
        check(worst <= GRAD_REL_TOL, "f32 ring gradients on the card disagree with the CPU")


def _sdpa_partial(q, k, v, causal):
    """One library call returning an attention span's normalized output and
    its lse, which is what a merge of partial spans needs."""
    import torch

    out, lse = torch.ops.aten._scaled_dot_product_flash_attention(
        q, k, v, 0.0, causal, False, scale=0.125)[:2]
    return out, lse


def _sdpa_chain(q, spans, bands):
    """The library yardstick of the hop chain: each span through SDPA (flash)
    with its lse, merged in PyTorch (no PyTorch call returns un-normalized
    partials or resumes a carry)."""
    import torch

    parts = [_sdpa_partial(q, k, v, hi == 0) for (k, v), hi in zip(spans, bands)]
    lses = torch.stack([lse for _, lse in parts])
    total = torch.logsumexp(lses, dim=0)
    out = sum(o.float() * torch.exp(lse - total)[..., None] for o, lse in parts)
    return out.to(q.dtype), total


def _mode_rows(n, with_plain) -> dict[str, dict]:
    """Each ring mode of the forward kernel on a (1, 8, n, 64) bf16 span of
    the hop chain: seed (the diagonal), resume and fused (spans fully in
    view) from a carry."""
    import torch

    from ring_attention_tpu_torch.ops import cuda_flash as cf

    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    q, k, v = (_rand(gen, (1, 8, n, 64), torch.bfloat16) for _ in range(3))
    carry = cf.flash_partials(q, k, v, scale=0.125, causal_offset=0)
    f32_state = 4 * 8 * n * (64 + 2)  # (acc, m, l) bytes
    qkv = nbytes(q, k, v)
    cases = {
        # name: (kernel, plain, library, pairs, bytes moved)
        "seed": (lambda: cf.flash_partials(q, k, v, scale=0.125, causal_offset=0),
                 lambda: cf.flash_partials_reference(q, k, v, scale=0.125, causal_offset=0),
                 lambda: _sdpa_partial(q, k, v, True),
                 band_pairs(n, n, 0, None), qkv + f32_state),
        # resumes in place: each timed launch folds the span in once more
        "resume": (lambda: cf.flash_partials(q, k, v, scale=0.125, carry=carry,
                                             out=carry),
                   lambda: cf.flash_partials_reference(q, k, v, scale=0.125, carry=carry),
                   lambda: _sdpa_partial(q, k, v, False),
                   n * n, qkv + 2 * f32_state),
        "fused_carry": (lambda: cf.flash_fwd(q, k, v, scale=0.125, carry=carry),
                        lambda: cf.flash_fwd_reference(q, k, v, scale=0.125, carry=carry),
                        lambda: _sdpa_partial(q, k, v, False),
                        n * n, qkv + f32_state + nbytes(q) + 4 * 8 * n),
    }
    rows = {}
    for mode, (kernel, plain, library, pairs, moved) in cases.items():
        ops = 4 * 64 * 8 * pairs
        b_ms, b_by = bound_ms(ops, moved, torch.bfloat16)
        ms = time_ms(kernel)
        rows[mode] = {"shape": f"{mode} (1,8,{n},64) bf16", "ms": ms,
                      "plain_ms": time_ms(plain) if with_plain else None,
                      "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": time_ms(library)}
        log(f"  flash_fwd {mode} {n}: kernel {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"plain {rows[mode]['plain_ms']} ms, sdpa with lse (library yardstick, "
            f"normalized) {rows[mode]['library_ms']:.4f} ms, "
            f"{ops / ms / 1e9:.1f} TFLOP/s")
    return rows


def phase_ring_timings(ring: dict, serving: dict, training: dict,
                       fwd_rows: list[dict]) -> dict[str, list[dict]]:
    """Phase 4c; returns the forward kernel's ring-mode rows by mode."""
    import torch

    log("phase 4c: the ring (CUDA events, median after warm-up)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    log(f"  card: {smi.stdout.strip()}")
    rows: dict[str, list[dict]] = {"seed": [], "resume": [], "fused_carry": []}
    for n, with_plain in ((4096, True), (65536, False)):
        for mode, row in _mode_rows(n, with_plain).items():
            rows[mode].append(row)

    # ring rank 3's hops at 262,144 tokens, ring 4 (bench.py::_hop_sequence)
    n = 65536
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    q = _rand(gen, (1, 8, n, 64), torch.bfloat16)
    spans = [(_rand(gen, q.shape, torch.bfloat16), _rand(gen, q.shape, torch.bfloat16))
             for _ in range(RING_SIZE)]
    bands = (0,) + (None,) * (RING_SIZE - 1)
    ops = 4 * 64 * 8 * (band_pairs(n, n, 0, None) + (RING_SIZE - 1) * n * n)
    b_ms, b_by = bound_ms(ops, nbytes(q, *(x for kv in spans for x in kv), q)
                          + 4 * 8 * n, torch.bfloat16)
    chain_ms = time_ms(lambda: _hop_chain(q, spans, bands), iters=5)
    library_ms = time_ms(lambda: _sdpa_chain(q, spans, bands), iters=5)
    out, _ = _hop_chain(q, spans, bands)
    ref, _ = _sdpa_chain(q, spans, bands)
    rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
    check(rel <= 1e-2, f"hop chain vs the SDPA yardstick: rel {rel}")
    sweep = next(r for r in fwd_rows if r["shape"] == "causal (1,8,262144,64) bf16")
    sweep_tflops = 4 * 64 * 8 * band_pairs(262144, 262144, 0, None) / sweep["ms"] / 1e9
    chain_tflops = ops / chain_ms / 1e9
    log(f"  hop chain, rank 3 of a causal ring of 4 at 262144 (seed + 2 resume + "
        f"fused, 1 x 8 x 65536 x 64 each): {chain_ms:.3f} ms, {chain_tflops:.1f} TFLOP/s, "
        f"bound {b_ms:.3f} ms ({b_by}); single causal sweep at 262144 {sweep['ms']:.3f} ms, "
        f"{sweep_tflops:.1f} TFLOP/s; ratio {chain_tflops / sweep_tflops:.4f}")
    log(f"  library yardstick for the chain (SDPA flash per span with its lse, "
        f"merged in PyTorch): {library_ms:.3f} ms; ||chain - yardstick|| / "
        f"||yardstick|| {rel:.2e}")

    tokens = serving["tokens"]
    log(f"  local model: forward 1 x 65536 {serving['fwd_ms']:.3f} ms "
        f"({65536 / serving['fwd_ms'] * 1e3:.0f} tokens/s), train step "
        f"{training['step_ms']:.3f} ms ({65536 / training['step_ms'] * 1e3:.0f} "
        f"tokens/s), peak {training['peak'] / 2**30:.3f} GiB, "
        f"{training['above'] / 2**30:.3f} GiB above the live memory (phases 4, 4b)")
    ring["timings"] = {}
    for layout, (model, step) in ring["models"].items():
        model.eval()
        with torch.inference_mode():
            fwd_ms = time_ms(lambda: model(tokens))
        model.train()
        ms, step_s, peak, base = _train_step_timing(step, training["tokens"])
        ring["timings"][layout] = {"fwd_ms": fwd_ms, "step_ms": ms}
        log(f"  ring {layout} model: forward 1 x 65536 {fwd_ms:.3f} ms "
            f"({65536 / fwd_ms * 1e3:.0f} tokens/s, {fwd_ms / serving['fwd_ms']:.3f} x "
            f"local), train step {ms:.3f} ms (all {[round(x * 1e3, 3) for x in step_s]}; "
            f"{65536 / ms * 1e3:.0f} tokens/s, {ms / training['step_ms']:.3f} x local), "
            f"peak {peak / 2**30:.3f} GiB, {(peak - base) / 2**30:.3f} GiB above the "
            f"live memory")
    return rows


def _fused_row(n, with_plain, iters, striped=False) -> dict:
    """The fused ring kernel on ring rank 3's schedule of a causal ring of 4
    (n_local ``n``, contiguous or striped) beside its bound, its plain
    version, the hop chain of the forward kernel on the same spans (timed
    chain, fused, fused, chain) and the SDPA-per-span yardstick."""
    import torch

    from ring_attention_tpu_torch.ops import cuda_ring as cr

    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    q, k_all, v_all, tables, spans, bands = _fused_rank_inputs(gen, n, striped=striped)
    ops = 4 * 64 * 8 * sum(band_pairs(n, n, hi, None) for hi in bands)
    moved = nbytes(q, k_all, v_all) + nbytes(q) + 4 * 8 * n  # inputs, out, lse
    b_ms, b_by = bound_ms(ops, moved, torch.bfloat16)

    def kernel():
        return cr.fused_ring_local(q, k_all, v_all, n_local=n, scale=0.125, **tables)

    def chain():
        return _hop_chain(q, spans, bands)

    chain_ms = [time_ms(chain, iters=iters)]
    fused_ms = [time_ms(kernel, iters=iters), time_ms(kernel, iters=iters)]
    chain_ms.append(time_ms(chain, iters=iters))
    ms, hop_chain_ms = statistics.mean(fused_ms), statistics.mean(chain_ms)
    library_ms = time_ms(lambda: _sdpa_chain(q, spans, bands), iters=iters)
    plain_ms = None
    if with_plain:
        torch.cuda.empty_cache()  # the dense plain version holds n x n scores
        plain_ms = time_ms(lambda: cr.fused_ring_local_plain(
            q, k_all, v_all, n_local=n, scale=0.125, **tables), iters=min(iters, 3))
    layout = "striped" if striped else "contiguous"
    log(f"  flash_ring rank 3 of a {layout} causal ring of 4, 4 x {n}: kernel {ms:.3f} ms "
        f"(runs {[round(x, 3) for x in fused_ms]}), {ops / ms / 1e9:.1f} TFLOP/s, bound "
        f"{b_ms:.3f} ms ({b_by}); hop chain of flash_fwd on the same spans "
        f"{hop_chain_ms:.3f} ms (runs {[round(x, 3) for x in chain_ms]}), "
        f"{ops / hop_chain_ms / 1e9:.1f} TFLOP/s, fused / chain {ms / hop_chain_ms:.4f}; "
        f"plain {plain_ms} ms; SDPA per span merged in PyTorch (library yardstick) "
        f"{library_ms:.3f} ms")
    return {"shape": f"rank 3 of {layout} causal ring 4, 4 x (1,8,{n},64) bf16", "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms, "hop_chain_ms": hop_chain_ms}


def _one_span_row(n, causal) -> None:
    """One span of n keys (causal, or unbanded) two ways: the forward
    kernel's fused sweep and the fused ring kernel with a one-hop table of
    the same band, which run the same sweep over the same tiles (outputs
    checked bit-identical); timed in turns B1, B7, B7, B1, to show whether
    B7's speed is the hop walk or the kernel itself."""
    import torch

    from ring_attention_tpu_torch.ops import cuda_flash as cf
    from ring_attention_tpu_torch.ops import cuda_ring as cr

    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    q, k, v = (_rand(gen, (1, 8, n, 64), torch.bfloat16) for _ in range(3))
    table = [[0], [0 if causal else n], [-n], [1]]
    tables = dict(zip(("origins", "his", "los", "works"),
                      torch.tensor(table, dtype=torch.int32, device="cuda")))

    def b1():
        return cf.flash_fwd(q, k, v, scale=0.125, causal_offset=0 if causal else None)

    def b7():
        return cr.fused_ring_local(q, k, v, n_local=n, scale=0.125, **tables)

    same = all(bool((x == y).all()) for x, y in zip(b1(), b7()))
    check(same, f"one span {n} causal={causal}: B7 and B1 differ")
    b1_ms = [time_ms(b1, iters=5)]
    b7_ms = [time_ms(b7, iters=5), time_ms(b7, iters=5)]
    b1_ms.append(time_ms(b1, iters=5))
    ops = 4 * 64 * 8 * band_pairs(n, n, 0 if causal else None, None)
    b1_mean, b7_mean = statistics.mean(b1_ms), statistics.mean(b7_ms)
    log(f"  one {'causal' if causal else 'unbanded'} span (1,8,{n},64) bf16, outputs "
        f"bit-identical {same}: flash_fwd {b1_mean:.3f} ms (runs {[round(x, 3) for x in b1_ms]}, "
        f"{ops / b1_mean / 1e9:.1f} TFLOP/s), flash_ring one hop {b7_mean:.3f} ms (runs "
        f"{[round(x, 3) for x in b7_ms]}, {ops / b7_mean / 1e9:.1f} TFLOP/s), ring / fwd "
        f"{b7_mean / b1_mean:.4f}")


def _remote_row(n, striped=False, iters=10, with_plain=False) -> dict:
    """The remote tier for the whole causal ring of 4 at n_local ``n``
    beside its bound (every rank's in-band operations), the four B7
    launches over the gathered span (the gather itself not timed) and the
    four ranks' hop chains (timed in turns: B7, chain, B8, B8, chain, B7),
    its plain version and SDPA per span merged, summed over the ranks."""
    import torch

    from ring_attention_tpu_torch.ops import cuda_ring_remote as crr

    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    qs, ks, vs = _remote_inputs(gen, RING_SIZE, 1, 8, 8, n, torch.bfloat16)
    tables = _remote_tables(RING_SIZE, n, causal=True, striped=striped)
    k_all, v_all = torch.cat(ks, dim=2), torch.cat(vs, dim=2)
    chains = [_chain_schedule(k_all, v_all, dict(zip(TABLE_NAMES, t)), n) for t in tables]
    ops = 4 * 64 * 8 * sum(band_pairs(n, n, hi, None) for _, bands in chains for hi in bands)
    moved = nbytes(*qs, *ks, *vs) + nbytes(*qs) + RING_SIZE * 4 * 8 * n  # inputs, out, lse
    b_ms, b_by = bound_ms(ops, moved, torch.bfloat16)

    def b8():
        return crr.fused_ring_remote(qs, ks, vs, tables=tables, n_local=n, scale=0.125)

    def b7():
        return _local_tier(qs, ks, vs, tables)

    def chain():
        return [_hop_chain(q, spans, bands) for q, (spans, bands) in zip(qs, chains)]

    runs = {"b7": [], "chain": [], "b8": []}
    for name in ("b7", "chain", "b8", "b8", "chain", "b7"):
        runs[name].append(time_ms({"b7": b7, "chain": chain, "b8": b8}[name], iters=iters,
                                  warmup=1))
    ms, b7_ms, chain_ms = (statistics.mean(runs[k]) for k in ("b8", "b7", "chain"))
    library_ms = time_ms(lambda: [_sdpa_chain(q, spans, bands)
                                  for q, (spans, bands) in zip(qs, chains)],
                         iters=iters, warmup=1)
    plain_ms = None
    if with_plain:
        del chains
        torch.cuda.empty_cache()  # the dense plain version holds n x n scores
        plain_ms = time_ms(lambda: crr.fused_ring_remote_plain(
            qs, ks, vs, tables=tables, n_local=n, scale=0.125), iters=min(iters, 3), warmup=1)
    layout = "striped" if striped else "contiguous"
    log(f"  flash_ring_remote, the whole {layout} causal ring of 4, 4 x {n}: kernel "
        f"{ms:.3f} ms (runs {[round(x, 3) for x in runs['b8']]}), {ops / ms / 1e9:.1f} "
        f"TFLOP/s, bound {b_ms:.3f} ms ({b_by}); four B7 launches {b7_ms:.3f} ms (runs "
        f"{[round(x, 3) for x in runs['b7']]}), B8 / B7 {ms / b7_ms:.4f}; four hop chains "
        f"{chain_ms:.3f} ms (runs {[round(x, 3) for x in runs['chain']]}), B8 / chain "
        f"{ms / chain_ms:.4f}; plain {plain_ms} ms; SDPA per span merged, summed over "
        f"the ranks (library yardstick) {library_ms:.3f} ms")
    return {"shape": f"whole {layout} causal ring 4 x (1,8,{n},64) bf16", "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms, "local_tier_ms": b7_ms, "hop_chain_ms": chain_ms}


def _remote_diagnostics() -> None:
    """What the remote tier's time is made of: a ring of one (one rank, one
    hop: B8's tile body with no ring around it) against B7 on the same span,
    causal and unbanded, in turns (B7, B8, B8, B7); and the whole causal ring
    of 4 at n_local 16,384 under three block splits (even, in proportion to
    each rank's work, the wrapper's default) beside each one's modelled
    time (KV tiles a block walks on the protocol's critical path)."""
    import torch

    from ring_attention_tpu_torch.ops import cuda_ring_remote as crr

    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    n = 16384
    for causal in (True, False):
        qs, ks, vs = _remote_inputs(gen, 1, 1, 8, 8, n, torch.bfloat16)
        tables = _remote_tables(1, n, causal=causal)

        def b8():
            return crr.fused_ring_remote(qs, ks, vs, tables=tables, n_local=n, scale=0.125)

        def b7():
            return _local_tier(qs, ks, vs, tables)

        runs = [time_ms(fn) for fn in (b7, b8, b8, b7)]
        log(f"  ring of one, {'causal' if causal else 'unbanded'} (1,8,{n},64) bf16: B7 "
            f"{(runs[0] + runs[3]) / 2:.3f} ms (runs {runs[0]:.3f}, {runs[3]:.3f}), B8 "
            f"{(runs[1] + runs[2]) / 2:.3f} ms (runs {runs[1]:.3f}, {runs[2]:.3f})")
    capacity = crr._capacity(torch.cuda.current_device(), True, False)
    for striped in (False, True):
        qs, ks, vs = _remote_inputs(gen, RING_SIZE, 1, 8, 8, n, torch.bfloat16)
        tables = _remote_tables(RING_SIZE, n, causal=True, striped=striped)
        model = crr._SplitModel(crr._schedule_key(tables), n, 8)
        work = [sum(int(v.sum()) for v in hops if v is not None) for hops in model.visits]
        splits = {"even": [capacity // RING_SIZE] * RING_SIZE,
                  "proportional": [max(1, capacity * w // sum(work)) for w in work],
                  "default": crr.balanced_split(tables, n, 8, capacity)}
        for label, split in splits.items():
            ms = time_ms(lambda: crr.fused_ring_remote(qs, ks, vs, tables=tables, n_local=n,
                                                       scale=0.125, cta_split=split))
            log(f"  {'striped' if striped else 'contiguous'} causal ring of 4 x {n}, blocks "
                f"{split} ({label}): {ms:.3f} ms, modelled {model.makespan(split):.0f} KV "
                "tiles a block")


def phase_fused_ring_timings(fused: dict, ring: dict, serving: dict,
                             training: dict) -> list[dict]:
    """Phase 4e: the fused ring kernel and the fused ring models."""
    import torch

    log("phase 4e: the fused ring (CUDA events, median after warm-up)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    log(f"  card: {smi.stdout.strip()}")
    # first the launches the fused model makes (n_local 16,384), the
    # headline; then 4,096 and the 262,144-token schedule
    rows = [_fused_row(16384, with_plain=True, iters=10),
            _fused_row(16384, with_plain=False, iters=10, striped=True),
            _fused_row(4096, with_plain=True, iters=10),
            _fused_row(65536, with_plain=False, iters=5)]
    for causal in (False, True):
        _one_span_row(65536, causal)
    # the remote tier: first the launch the fused model makes (the headline)
    fused["remote_rows"] = [_remote_row(16384, with_plain=True),
                            _remote_row(16384, striped=True),
                            _remote_row(4096, with_plain=True),
                            _remote_row(65536, iters=3)]
    _remote_diagnostics()
    tokens = serving["tokens"]
    for layout, (model, step) in fused["models"].items():
        scan_model = ring["models"][layout][0].eval()
        model.eval()
        with torch.inference_mode():  # in turns: scan, fused, fused, scan
            scan_ms = [time_ms(lambda: scan_model(tokens))]
            fwd_ms = [time_ms(lambda: model(tokens)), time_ms(lambda: model(tokens))]
            scan_ms.append(time_ms(lambda: scan_model(tokens)))
        model.train()
        ms, step_s, peak, base = _train_step_timing(step, training["tokens"])
        fwd, scan = statistics.mean(fwd_ms), statistics.mean(scan_ms)
        log(f"  fused ring {layout} model: forward 1 x 65536 {fwd:.3f} ms (runs "
            f"{[round(x, 3) for x in fwd_ms]}; {65536 / fwd * 1e3:.0f} tokens/s), scan-path "
            f"ring {scan:.3f} ms (runs {[round(x, 3) for x in scan_ms]}), fused / scan "
            f"{fwd / scan:.4f}, {fwd / serving['fwd_ms']:.3f} x local; train step "
            f"{ms:.3f} ms (all {[round(x * 1e3, 3) for x in step_s]}; "
            f"{65536 / ms * 1e3:.0f} tokens/s), scan-path ring "
            f"{ring['timings'][layout]['step_ms']:.3f} ms (phase 4c), local "
            f"{training['step_ms']:.3f} ms; peak {peak / 2**30:.3f} GiB, "
            f"{(peak - base) / 2**30:.3f} GiB above the live memory")
    return rows


# ---------------------------------------------------------------------------
# The int8 path: B4 (csrc/flash_fwd_q8.cu) and B6 (csrc/flash_decode_q8.cu)
# ---------------------------------------------------------------------------


def _compare_q8(name, dtype, out, ref_out, lse, ref_lse, errors,
                rel_tol=None, lse_tol=Q8_LSE_TOL) -> None:
    """Norm-relative error of an int8 kernel's output and max|lse - plain|
    against its plain version (``Q8_REL_TOL``, ``Q8_LSE_TOL``)."""
    import torch

    rel_tol = Q8_REL_TOL[str(dtype)] if rel_tol is None else rel_tol
    diff = out.float() - ref_out.float()
    rel = (diff.norm() / ref_out.float().norm().clamp_min(1e-30)).item()
    lse_err = (lse - ref_lse).abs().max().item()
    errors.append(diff.abs().max().item())
    ok = rel <= rel_tol and lse_err <= lse_tol
    log(f"  {name:<34} {str(dtype):<15} ||out-plain||/||plain|| {rel:.3e} (tol {rel_tol}) "
        f"max|out-plain| {diff.abs().max().item():.3e} max|lse-plain| {lse_err:.3e} "
        f"(tol {lse_tol})  {'ok' if ok else 'FAIL'}")
    check(ok, f"{name} {dtype}: int8 kernel disagrees with plain")
    check(bool(torch.isfinite(out.float()).all()), f"{name} {dtype}: non-finite output")


def _compare_q8_partials(name, dtype, got, ref, errors) -> None:
    from ring_attention_tpu_torch.ops.partials import finalize_partials

    check(all(x.dtype == r.dtype and x.shape == r.shape for x, r in zip(got, ref)),
          f"{name}: partials layout")
    (out, lse), (ref_out, ref_lse) = finalize_partials(got), finalize_partials(ref)
    _compare_q8(name, dtype, out.to(dtype), ref_out.to(dtype), lse, ref_lse, errors)


def _q8_modes_vs_plain(name, dtype, q, k, v, mask, kw, carry, errors) -> None:
    """B4 in every mode against its plain version: fused, seed partials,
    resume into new tensors (the carry unchanged) and in place (bit-equal to
    the former), and fused from a carry."""
    import torch

    from ring_attention_tpu_torch.ops import cuda_flash_q8 as q8

    out, lse = q8.flash_fwd_q8(q, k, v, mask, **kw)
    torch.cuda.synchronize()
    ref_out, ref_lse = q8.flash_fwd_q8_reference(q, k, v, mask, **kw)
    _compare_q8(f"{name} fused", dtype, out, ref_out, lse, ref_lse, errors["fused"])
    got = q8.flash_partials_q8(q, k, v, mask, **kw)
    torch.cuda.synchronize()
    _compare_q8_partials(f"{name} seed", dtype, got,
                         q8.flash_partials_q8_reference(q, k, v, mask, **kw), errors["seed"])
    kept = _clone(carry)
    got = q8.flash_partials_q8(q, k, v, mask, carry=carry, **kw)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(carry, kept)),
          f"{name} {dtype}: an int8 resume without out= changed its carry")
    _compare_q8_partials(f"{name} resume", dtype, got,
                         q8.flash_partials_q8_reference(q, k, v, mask, carry=carry, **kw),
                         errors["resume"])
    q8.flash_partials_q8(q, k, v, mask, carry=kept, out=kept, **kw)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(kept, got)),
          f"{name} {dtype}: the int8 in-place resume differs from the resume")
    out, lse = q8.flash_fwd_q8(q, k, v, mask, carry=carry, **kw)
    torch.cuda.synchronize()
    ref_out, ref_lse = q8.flash_fwd_q8_reference(q, k, v, mask, carry=carry, **kw)
    _compare_q8(f"{name} fused+carry", dtype, out, ref_out, lse, ref_lse,
                errors["fused_carry"])


def _q8_probe(gen) -> None:
    """B4's tile layout and descriptors (the 64-byte swizzle) against
    ``torch._int_mm``: A . B^T of two random int8 64 x 64 tiles by one
    warpgroup's int8 wgmma, A from shared memory and from registers."""
    import ctypes

    import torch

    from ring_attention_tpu_torch.ops import _build

    lib = _build.flash_fwd_q8_library()
    a, b = (torch.randint(-127, 128, (64, 64), generator=gen, device="cuda",
                          dtype=torch.int32).to(torch.int8) for _ in range(2))
    ref = torch._int_mm(a, b.t().contiguous())
    got = [torch.zeros_like(ref) for _ in range(2)]
    rc = lib.flash_q8_probe(a.data_ptr(), b.data_ptr(), got[0].data_ptr(), got[1].data_ptr(),
                            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    torch.cuda.synchronize()
    check(rc == 0, f"flash_q8_probe launch failed: {rc}")
    same = [bool(torch.equal(x, ref)) for x in got]
    log(f"  int8 wgmma probe vs torch._int_mm: A in shared memory {same[0]}, A in registers "
        f"{same[1]}")
    check(all(same), "the int8 wgmma tile layout disagrees with torch._int_mm")


def phase_q8_kernels_vs_plain() -> dict:
    """B4 in every mode and B6 fused and partials against their plain
    versions on the card; returns the largest |out - plain| by mode."""
    import torch

    from ring_attention_tpu_torch.ops import cuda_flash as cf
    from ring_attention_tpu_torch.ops import cuda_flash_q8 as q8

    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    errors: dict[str, list[float]] = {m: [] for m in
                                      ("fused", "seed", "resume", "fused_carry", "decode")}
    log("phase 2d: flash_fwd_q8 (every mode) and flash_decode_q8 (fused, partials) "
        "vs their plain versions")
    _q8_probe(gen)
    for dtype in (torch.bfloat16, torch.float32):
        # the forward cases and B1's edge cases (B4 takes 128 rows a block
        # in two warpgroups of 64 too, each with its own visit set)
        for name, case in {**KERNEL_CASES, **FWD_EDGE_CASES}.items():
            q, k, v, mask, kw = _case_inputs(gen, case, dtype)
            carry = cf.flash_partials_reference(
                q, _rand(gen, k.shape, dtype), _rand(gen, v.shape, dtype), scale=0.125)
            _q8_modes_vs_plain(name, dtype, q, k, v, mask, kw, carry, errors)
            del carry
        # quantization blocks of a ring hop (the bucket, 2048 of 4096 keys),
        # of a short, unaligned span (96 keys, one block of 96) and below one
        # 64-key tile (blocks of 32)
        for name, shape, bk in (("hop span bk2048 (1,8,2048,4096)", (1, 8, 2048, 4096), 2048),
                                ("ragged bk96 (1,4,80,96) causal", (1, 4, 80, 96), None),
                                ("bk32 (1,4,80,96) causal", (1, 4, 80, 96), 32)):
            b, h, nq, nk = shape
            q = _rand(gen, (b, h, nq, 64), dtype)
            k, v = (_rand(gen, (b, h, nk, 64), dtype) for _ in range(2))
            kw = dict(scale=0.125, causal_offset=nk - nq if "causal" in name else None,
                      block_k=bk)
            carry = cf.flash_partials_reference(q, _rand(gen, k.shape, dtype),
                                                _rand(gen, v.shape, dtype), scale=0.125)
            _q8_modes_vs_plain(name, dtype, q, k, v, None, kw, carry, errors)
        # every key carries its own value in its own column: a key order of
        # p and V that disagreed inside the kernel could not pass
        n = 256
        q, k = (_rand(gen, (1, 8, n, 64), dtype) for _ in range(2))
        v = torch.zeros((1, 8, n, 64), device="cuda")
        keys = torch.arange(n, device="cuda")
        v[:, :, keys, keys % 64] = (keys + 1).float()
        v = v.to(dtype)
        out, lse = q8.flash_fwd_q8(q, k, v, scale=0.125, causal_offset=0, block_k=64)
        torch.cuda.synchronize()
        ref_out, ref_lse = q8.flash_fwd_q8_reference(q, k, v, scale=0.125, causal_offset=0,
                                                     block_k=64)
        _compare_q8("distinct value per key", dtype, out, ref_out, lse, ref_lse,
                    errors["fused"])
        # one block of 262,144 keys whose p8 . v8 sum on one channel reaches
        # 262,144 * 127 * 127 > 2^31: zero queries score every key alike
        # (p8 = 127) and v's channel 0 is constant (v8 = 127); the int32 sum
        # must be folded before it wraps
        n = 262144
        q = torch.zeros((1, 1, 64, 64), device="cuda", dtype=dtype)
        k = _rand(gen, (1, 1, n, 64), dtype)
        v = torch.zeros((1, 1, n, 64), device="cuda", dtype=dtype)
        v[..., 0] = 1.0
        kw = dict(scale=0.125, block_k=n)
        out, lse = q8.flash_fwd_q8(q, k, v, **kw)
        torch.cuda.synchronize()
        ref_out, ref_lse = q8.flash_fwd_q8_reference(q, k, v, **kw)
        _compare_q8("one block of 262144 keys (int32 fold)", dtype, out, ref_out, lse, ref_lse,
                    errors["fused"])
        del q, k, v

        # B6 on the decode shapes of phase 2, ragged valid prefixes
        for h, hk, nk in ((8, 2, 32768), (8, 8, 4096)):
            b = 4
            q = _rand(gen, (b, h, 1, 64), dtype)
            kv = q8.quantize_kv_cache(_rand(gen, (b, hk, nk, 64), dtype),
                                      _rand(gen, (b, hk, nk, 64), dtype))
            lengths = torch.randint(1, nk + 1, (b,), generator=gen, device="cuda")
            mask = torch.arange(nk, device="cuda")[None, :] < lengths[:, None]
            for clamp in (None, 30.0):
                out, lse = q8.flash_decode_q8(q, kv, mask, softclamp_value=clamp)
                torch.cuda.synchronize()
                ref_out, ref_lse = q8.flash_decode_q8_reference(q, kv, mask,
                                                                softclamp_value=clamp)
                _compare_q8(f"decode_q8 b4 h{h} hk{hk} nk{nk} clamp {clamp}", dtype, out,
                            ref_out, lse, ref_lse, errors["decode"],
                            DECODE_Q8_REL_TOL[str(dtype)], DECODE_Q8_LSE_TOL)
            acc, m, l = q8.flash_decode_q8(q, kv, mask, fused=False)
            torch.cuda.synchronize()
            ref = q8.flash_decode_q8_reference(q, kv, mask, fused=False)
            (out, lse), (ref_out, ref_lse) = (
                _finalize_decode_partials(parts) for parts in ((acc, m, l), ref))
            _compare_q8(f"decode_q8 b4 h{h} hk{hk} nk{nk} partials", dtype, out, ref_out,
                        lse, ref_lse, errors["decode"], DECODE_Q8_REL_TOL[str(dtype)],
                        DECODE_Q8_LSE_TOL)

    # the int8 serving forward's own launch, held in row slices (the block
    # of the whole 65,536-key sweep is 1,024 keys), and a ring chain of
    # 16,384-row hops at the bench model's bucket of 2,048
    n, w = 65536, 1024
    q, k, v = (_rand(gen, (1, 8, n, 64), torch.bfloat16) for _ in range(3))
    out, lse = q8.flash_fwd_q8(q, k, v, scale=0.125, causal_offset=0)
    torch.cuda.synchronize()
    for r0 in (0, n // 2, n - w):
        ref_out, ref_lse = q8.flash_fwd_q8_reference(
            q[:, :, r0:r0 + w].contiguous(), k, v, scale=0.125, causal_offset=r0)
        _compare_q8(f"causal (1,8,65536,64) rows {r0}+", torch.bfloat16,
                    out[:, :, r0:r0 + w], ref_out, lse[:, :, r0:r0 + w], ref_lse,
                    errors["fused"])
    del q, k, v, out, lse
    n = 16384
    for layout, bands in (("contiguous rank 3", (0, None, None, None)),
                          ("striped rank 1", (0, 0, -1, -1))):
        q = _rand(gen, (1, 8, n, 64), torch.bfloat16)
        spans = [(_rand(gen, q.shape, torch.bfloat16), _rand(gen, q.shape, torch.bfloat16))
                 for _ in range(4)]
        _hold_chain_in_slices(f"int8 {layout} 4 x {n}", q, spans, bands,
                              errors["fused_carry"], int8_block=2048)
    return {mode: max(errs) for mode, errs in errors.items()}


def _q8_model(dtype, device, **ring):
    return _model(dtype, device, quantize_cache=True, compute_dtype="int8", **ring)


def _rel_err(got, ref) -> float:
    return ((got.float() - ref.float()).norm() / ref.float().norm()).item()


def phase_q8_path(serving: dict, training: dict) -> dict:
    """The int8 serving and training path at full width, then on a ring of
    4; returns launch counts and what phase 4d times."""
    import torch

    from ring_attention_tpu_torch import make_train_step
    from ring_attention_tpu_torch.parallel import create_mesh

    depth = BENCH_MODEL["depth"]
    log('phase 3d: int8 path, RingTransformer(quantize_cache=True, compute_dtype="int8"), '
        "bench model at full width, bf16")
    model = _q8_model(torch.bfloat16, "cuda")
    tokens, prompts = serving["tokens"], serving["prompts"]
    launches = {name: 0 for name in COUNTERS}

    def run(label, fn, expect):
        _reset_counts()
        start = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        counts = _read_counts()
        log(f"  {label}: {seconds:.3f} s (first call), launches "
            f"{ {k: n for k, n in counts.items() if n} }")
        check(counts == expect, f"{label} launched {counts}, expected {expect}")
        for name, n in counts.items():
            launches[name] += n
        return result

    with torch.inference_mode():
        ref = serving["model"](tokens).float()
        logits = run("forward 1 x 65536", lambda: model(tokens),
                     _counts(flash_fwd_q8=depth))
        check(tuple(logits.shape) == tuple(ref.shape), f"logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits.float()).all()), "int8 forward: non-finite logits")
        rel = _rel_err(logits, ref)
        log(f"  int8 logits vs the bf16 model: ||int8 - bf16|| / ||bf16|| {rel:.3e} "
            f"(tol {Q8_FWD_REL_L2})")
        check(rel <= Q8_FWD_REL_L2, "int8 logits disagree with the bf16 model")
        del logits
        steps = 128
        new = run(f"generate 4 x (2048 prompt + {steps} new)",
                  lambda: model.generate(prompts, max_len=4096, num_steps=steps),
                  _counts(flash_decode_q8=depth * (steps - 1)))
        check(tuple(new.shape) == (4, steps), f"generate shape {tuple(new.shape)}")
        check(bool(((new >= 0) & (new < BENCH_MODEL["num_tokens"])).all()),
              "generated ids out of range")
        ref_new = serving["model"].generate(prompts, max_len=4096, num_steps=steps)
        agree = (new == ref_new).float().mean().item()
        log(f"  greedy tokens equal to the bf16 model's: {agree:.4f} of {new.numel()}")

    model.train()
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = make_train_step(lambda t: model(t, return_loss=True), opt)
    losses = []
    for i in range(TRAIN_STEPS):
        loss = float(run(f"train step {i}", lambda: step(training["tokens"]),
                         _counts(flash_fwd_q8=depth, flash_bwd_dkv=depth,
                                 flash_bwd_dq=depth)))
        log(f"    loss {loss:.6f}")
        check(math.isfinite(loss), f"int8 step {i}: loss {loss}")
        losses.append(loss)
    check(losses[-1] < losses[0], f"int8 loss did not fall: {losses}")
    model.eval()
    _hold_f32_q8_model_to_cpu()

    ring_models = {}
    for striped in (False, True):
        layout = "striped" if striped else "contiguous"
        ring_model = _q8_model(torch.bfloat16, "cuda", mesh=create_mesh(ring_size=RING_SIZE),
                               striped=striped)
        with torch.inference_mode():
            logits = run(f"ring {layout} forward 1 x 65536", lambda: ring_model(tokens),
                         _ring_counts(striped, backward=False, int8=True))
            rel = _rel_err(logits, ref)
            log(f"  ring {layout} int8 logits vs the bf16 local model: {rel:.3e} "
                f"(tol {Q8_FWD_REL_L2})")
            check(rel <= Q8_FWD_REL_L2, f"ring {layout} int8 logits disagree")
            del logits
        ring_model.train()
        ring_step = make_train_step(lambda t, m=ring_model: m(t, return_loss=True),
                                    torch.optim.Adam(ring_model.parameters(), lr=1e-3))
        loss = float(run(f"ring {layout} train step", lambda: ring_step(training["tokens"]),
                         _ring_counts(striped, backward=True, int8=True)))
        check(math.isfinite(loss), f"ring {layout} int8 step: loss {loss}")
        log(f"    loss {loss:.6f}")
        ring_models[layout] = ring_model.eval()
    return {"launches": launches, "model": model, "step": step, "losses": losses,
            "ring_models": ring_models}


def _hold_f32_q8_model_to_cpu() -> None:
    """A float32 int8 model (seq 256) on the card against the same weights
    on the CPU (plain versions): logits, prefill and decode steps, and the
    quantized cache entries."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = _q8_model(None, "cuda")
    cpu = copy.deepcopy(gpu).to("cpu")
    gen = torch.Generator().manual_seed(SEED + 13)
    tokens = torch.randint(0, BENCH_MODEL["num_tokens"], (2, 256), generator=gen)
    with torch.inference_mode():
        ref = cpu(tokens)
        errs = [_rel_err(gpu(tokens.cuda()).cpu(), ref)]
        # the spread of the int8 model itself under last-bit weight noise,
        # and its distance from the exact model, both on the CPU
        noisy = copy.deepcopy(cpu)
        for w in noisy.parameters():
            w.mul_(1 + 1.2e-7 * torch.randn(w.shape, generator=gen))
        spread = _rel_err(noisy(tokens), ref)
        exact = copy.deepcopy(cpu)
        for layer in exact.attn_layers:
            layer.compute_dtype = None
        int8_err = _rel_err(ref, exact(tokens))
        caches = [m.init_cache(2, 256) for m in (gpu, cpu)]
        logits = [m.prefill(tokens[:, :200], c)[0].cpu() for m, c in zip((gpu, cpu), caches)]
        errs.append(_rel_err(logits[0], logits[1]))
        for pos in range(200, 208):
            step = [m.decode_step(tokens[:, pos], c, pos)[0].cpu()
                    for m, c in zip((gpu, cpu), caches)]
            errs.append(_rel_err(step[0], step[1]))
    (values, scales), (cpu_values, cpu_scales) = caches[0]["k"][0], caches[1]["k"][0]
    flips = (values.cpu() != cpu_values).float().mean().item()
    scale_err = ((scales.cpu() - cpu_scales).abs() / cpu_scales.clamp_min(1e-30)).max().item()
    log(f"  f32 int8 model seq 256, card vs CPU, ||card - cpu|| / ||cpu||: forward "
        f"{errs[0]:.3e}, prefill {errs[1]:.3e}, 8 decode steps {max(errs[2:]):.3e} "
        f"(tol {Q8_MODEL_REL_TOL}); int8 cache values that differ {flips:.2e}, scales "
        f"max rel {scale_err:.2e}; "
        f"on the CPU, weights x (1 + 1.2e-7 noise) move the forward {spread:.3e}, the "
        f"int8 forward is {int8_err:.3e} from the exact one")
    check(max(errs) <= Q8_MODEL_REL_TOL, "f32 int8 model on the card disagrees with the CPU")


def _q8_causal_rows(n, with_plain) -> dict:
    """B4 on the causal (1, 8, n, 64) bf16 sweep: the kernel on quantized
    operands, the wrapper (quantization included), the plain version, B1's
    bf16 sweep and SDPA on the same inputs."""
    import torch
    import torch.nn.functional as F

    from ring_attention_tpu_torch.ops import cuda_flash as cf
    from ring_attention_tpu_torch.ops import cuda_flash_q8 as q8

    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    q, k, v = (_rand(gen, (1, 8, n, 64), torch.bfloat16) for _ in range(3))
    ops8 = q8.quantize_operands(q, k, v)
    band = dict(scale=0.125, causal_offset=0, window_lo=None, softclamp_value=None)
    out, lse = q8.launch_fwd_q8(ops8, None, band, torch.bfloat16)
    ops = 4 * 64 * 8 * band_pairs(n, n, 0, None)
    moved = nbytes(*ops8[:6], out, lse)
    b_ms, b_by = bound_ms(ops, moved, torch.int8)
    kw = dict(scale=0.125, causal_offset=0)
    row = {
        "shape": f"causal (1,8,{n},64) bf16 in, int8 operands, block {ops8.block}",
        "ms": time_ms(lambda: q8.launch_fwd_q8(ops8, None, band, torch.bfloat16)),
        "wrapper_ms": time_ms(lambda: q8.flash_fwd_q8(q, k, v, **kw)),
        "plain_ms": time_ms(lambda: q8.flash_fwd_q8_reference(q, k, v, **kw), iters=3)
        if with_plain else None,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,  # no PyTorch call computes int8 attention
        "bf16_kernel_ms": time_ms(lambda: cf.flash_fwd(q, k, v, **kw)),
        "bf16_sdpa_ms": time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)),
    }
    log(f"  flash_fwd_q8 causal {n}: kernel {row['ms']:.4f} ms (wrapper with quantization "
        f"{row['wrapper_ms']:.4f} ms), bound {b_ms:.4f} ms ({b_by}), plain {row['plain_ms']} "
        f"ms; bf16 comparison: flash_fwd (B1) {row['bf16_kernel_ms']:.4f} ms (B4 / B1 "
        f"{row['ms'] / row['bf16_kernel_ms']:.3f}), sdpa {row['bf16_sdpa_ms']:.4f} ms; "
        f"{ops / row['ms'] / 1e9:.1f} TOP/s")
    return row


def _q8_mode_rows(n) -> dict[str, dict]:
    """B4's ring modes on a (1, 8, n, 64) span at the bench model's hop block
    (2,048): seed (the diagonal), resume and fused (spans fully in view)."""
    import torch

    from ring_attention_tpu_torch.ops import cuda_flash as cf
    from ring_attention_tpu_torch.ops import cuda_flash_q8 as q8

    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    q, k, v = (_rand(gen, (1, 8, n, 64), torch.bfloat16) for _ in range(3))
    ops8 = q8.quantize_operands(q, k, v, 2048)
    band = dict(scale=0.125, causal_offset=None, window_lo=None, softclamp_value=None)
    carry = q8.launch_fwd_q8(ops8, None, dict(band, causal_offset=0), torch.bfloat16,
                             partials=True)
    f32_state = 4 * 8 * n * (64 + 2)
    qkv8 = nbytes(*ops8[:6])
    cases = {
        "seed": (lambda: q8.launch_fwd_q8(ops8, None, dict(band, causal_offset=0),
                                          torch.bfloat16, partials=True),
                 lambda: cf.flash_partials(q, k, v, scale=0.125, causal_offset=0),
                 band_pairs(n, n, 0, None), qkv8 + f32_state),
        "resume": (lambda: q8.launch_fwd_q8(ops8, None, band, torch.bfloat16, carry=carry,
                                            partials=True, out=carry),
                   lambda: cf.flash_partials(q, k, v, scale=0.125, carry=carry, out=carry),
                   n * n, qkv8 + 2 * f32_state),
        "fused_carry": (lambda: q8.launch_fwd_q8(ops8, None, band, torch.bfloat16,
                                                 carry=carry),
                        lambda: cf.flash_fwd(q, k, v, scale=0.125, carry=carry),
                        n * n, qkv8 + f32_state + nbytes(q) + 4 * 8 * n),
    }
    rows = {}
    for mode, (kernel, bf16, pairs, moved) in cases.items():
        ops = 4 * 64 * 8 * pairs
        b_ms, b_by = bound_ms(ops, moved, torch.int8)
        ms = time_ms(kernel)
        rows[mode] = {"shape": f"{mode} (1,8,{n},64) int8 operands, block 2048", "ms": ms,
                      "plain_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": None, "bf16_kernel_ms": time_ms(bf16)}
        log(f"  flash_fwd_q8 {mode} {n}: kernel {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"bf16 flash_fwd {mode} {rows[mode]['bf16_kernel_ms']:.4f} ms, "
            f"{ops / ms / 1e9:.1f} TOP/s")
    return rows


def _q8_decode_row(h, hk, nk) -> dict:
    """B6 at b4 beside its bound, its plain version, and B5 and SDPA on a
    bf16 cache of the same shape: each on the device alone (CUDA graph of
    20 calls: ``ms``), B6 also per call in a stream of 20 and as one
    synchronized call."""
    import torch
    import torch.nn.functional as F

    from ring_attention_tpu_torch.ops import cuda_flash as cf
    from ring_attention_tpu_torch.ops import cuda_flash_q8 as q8

    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    b = 4
    q = _rand(gen, (b, h, 1, 64), torch.bfloat16)
    k, v = (_rand(gen, (b, hk, nk, 64), torch.bfloat16) for _ in range(2))
    kv = q8.quantize_kv_cache(k, v)
    mask = torch.ones((b, nk), dtype=torch.bool, device="cuda")
    out, lse = q8.flash_decode_q8(q, kv, mask)
    ops = 4 * 64 * b * h * nk
    b_ms, b_by = bound_ms(ops, nbytes(q, *kv, mask, out, lse), torch.float32)

    def decode():
        return q8.flash_decode_q8(q, kv, mask)

    def bf16_decode():
        return cf.cuda_flash_decode(q, k, v, mask)

    row = {
        "shape": f"decode b{b} h{h} hk{hk} nk{nk} int8 cache",
        "ms": _graph_ms(decode),
        "streamed_ms": _streamed_ms(decode),
        "sync_call_ms": time_ms(decode, iters=50),
        "plain_ms": time_ms(lambda: q8.flash_decode_q8_reference(q, kv, mask)),
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,  # no PyTorch call attends over an int8 cache
        "bf16_kernel_ms": _graph_ms(bf16_decode),
        "bf16_sdpa_ms": _graph_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask[:, None, None, :], enable_gqa=h != hk)),
    }
    log(f"  flash_decode_q8 b{b} h{h} hk{hk} nk{nk}: kernel {row['ms']:.4f} ms a call on the "
        f"device (CUDA graph of 20), {row['streamed_ms']:.4f} ms per call in a stream of 20, "
        f"{row['sync_call_ms']:.4f} ms a synchronized call; bound {b_ms:.4f} ms ({b_by}), "
        f"{b_ms / row['ms']:.1%} of it; plain {row['plain_ms']:.4f} ms; bf16 cache on the "
        f"device: flash_decode (B5) {row['bf16_kernel_ms']:.4f} ms (B6 / B5 "
        f"{row['ms'] / row['bf16_kernel_ms']:.3f}), sdpa {row['bf16_sdpa_ms']:.4f} ms; "
        f"{nbytes(*kv) / row['ms'] / 1e6:.1f} GB/s of cache")
    return row


def phase_q8_timings(q8_path: dict, serving: dict, training: dict) -> dict:
    """Phase 4d; returns B4's rows (with its modes) and B6's rows."""
    import torch

    log("phase 4d: the int8 kernels and the int8 model (CUDA events, median after warm-up)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    log(f"  card: {smi.stdout.strip()}")
    fwd_rows = [_q8_causal_rows(4096, with_plain=True), _q8_causal_rows(65536, with_plain=False)]
    mode_rows = _q8_mode_rows(65536)
    decode_rows = [_q8_decode_row(8, 8, 4096), _q8_decode_row(8, 2, 32768)]

    model, tokens, prompts = q8_path["model"], serving["tokens"], serving["prompts"]
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: model(tokens))
        cache = model.init_cache(4, 4096)
        logits, cache = model.prefill(prompts, cache)
        tok = logits.argmax(-1)
        pos = [prompts.shape[1]]

        def step():
            model.decode_step(tok, cache, pos[0])
            pos[0] += 1

        step_ms = time_ms(step)
    model.train()
    ms, step_s, peak, base = _train_step_timing(q8_path["step"], training["tokens"])
    log(f"  int8 model forward 1 x 65536: {fwd_ms:.3f} ms, {65536 / fwd_ms * 1e3:.0f} tokens/s "
        f"(bf16 model {serving['fwd_ms']:.3f} ms)")
    for layout, ring_model in q8_path["ring_models"].items():
        with torch.inference_mode():
            ring_ms = time_ms(lambda m=ring_model: m(tokens))
        log(f"  int8 ring {layout} model forward 1 x 65536: {ring_ms:.3f} ms "
            f"({ring_ms / fwd_ms:.3f} x the int8 local model)")
    log(f"  int8 model decode step, 4 requests at ~2048-2060 cached tokens: {step_ms:.3f} "
        f"ms/step ({4 / step_ms * 1e3:.0f} tokens/s)")
    log(f"  int8 train step 1 x 65536: {ms:.3f} ms (all {[round(x * 1e3, 3) for x in step_s]}), "
        f"{65536 / ms * 1e3:.0f} tokens/s, peak {peak / 2**30:.3f} GiB, "
        f"{(peak - base) / 2**30:.3f} GiB above the live memory (bf16 model "
        f"{training['step_ms']:.3f} ms)")
    return {"fwd": fwd_rows, "modes": mode_rows, "decode": decode_rows}


# ---------------------------------------------------------------------------
# Packed sequences: document ids through B1 (every mode), B2 and B3
# ---------------------------------------------------------------------------

# Phases 2g, 3f and 4f pack documents whose lengths are drawn log-uniform on
# PACK_LEN_RANGE tokens from numpy.random.default_rng(PACK_SEED), the last
# one cut at the row's end; their ids run 0, 1, 2, ... in order.
PACK_LEN_RANGE = (512, 16384)
PACK_SEED = 0
# Phase 2g and 4f's 4,096-token row: shorter documents, so that a 4,096
# (or 2,048) token row holds several, their boundaries inside tiles.
SHORT_LEN_RANGE = (100, 1500)
# Phase 2g: the forward cases that take self-attention ids (nq == nk, so a
# causal row always meets its own key), each packing ending in a tail of
# PAD_SEGMENT_ID tokens.
SEG_CASES = ("causal (1,8,4096,64)", "window 1024", "softclamp 50",
             "kv_mask, one all-False row", "GQA h32 hk4 (1,32,2048,64)")
PACK_PAD_TAIL = 100
# Phase 3f: the f32 model at seq 256 on the card and the CPU, packed as
# documents of these lengths (sum 257: the train step's ids).
SMALL_PACKING = (37, 90, 51, 79)


def packed_ids(n: int, pad_tail: int = 0, len_range=PACK_LEN_RANGE):
    """``(1, n)`` int32 document ids on the card: documents of lengths drawn
    log-uniform on ``len_range``, the last ``pad_tail`` tokens
    PAD_SEGMENT_ID (-1)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(PACK_SEED)
    lo, hi = np.log(len_range)
    ids = np.empty(n, np.int32)
    start = doc = 0
    while start < n:
        length = int(round(float(np.exp(rng.uniform(lo, hi)))))
        ids[start:start + length] = doc
        start, doc = start + length, doc + 1
    if pad_tail:
        ids[n - pad_tail:] = -1
    return torch.from_numpy(ids)[None].cuda()


def doc_lengths(ids) -> list[int]:
    """Lengths of the runs of equal ids of a ``(1, n)`` packing, in order."""
    import torch

    return torch.unique_consecutive(ids[0], return_counts=True)[1].tolist()


def same_doc_pairs(ids) -> int:
    """Causal (query, key) pairs of one document each: what a packed causal
    sweep must compute (sum of L (L + 1) / 2 over its documents)."""
    return sum(n * (n + 1) // 2 for n in doc_lengths(ids))


def _rolled(ids, shift: int):
    """The same documents with their boundaries moved (a ring hop's keys)."""
    import torch

    return torch.roll(ids, shift, dims=1).contiguous()


def phase_segmented_vs_plain() -> dict[str, float]:
    """B1 (fused, seed, resume in place and into new tensors, fused from a
    carry), B2 and B3 with document ids against their plain versions on
    the card; returns the largest |kernel - plain| of each."""
    import torch

    from ring_attention_tpu_torch.ops import cuda_flash as cf

    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    errors: dict[str, list[float]] = {m: [] for m in ("fused", "seed", "resume",
                                                      "fused_carry")}
    bwd_errors: dict[str, list[float]] = {}
    log(f"phase 2g: segmented flash_fwd (every mode), flash_bwd_dkv and flash_bwd_dq vs "
        f"their plain versions; documents log-uniform on {SHORT_LEN_RANGE} tokens, "
        f"a {PACK_PAD_TAIL}-token PAD_SEGMENT_ID tail; then the 65,536-token launch "
        f"of phase 3f's packing in slices")
    for dtype in (torch.bfloat16, torch.float32):
        for name in SEG_CASES:
            q, k, v, mask, kw = _case_inputs(gen, KERNEL_CASES[name], dtype)
            b, n = q.shape[0], q.shape[2]
            ids = packed_ids(n, PACK_PAD_TAIL, SHORT_LEN_RANGE).expand(b, n).contiguous()
            if dtype == torch.bfloat16:
                log(f"  {name}: documents {doc_lengths(ids[:1])}")
            seg = dict(q_seg=ids, kv_seg=ids)
            out, lse = cf.flash_fwd(q, k, v, mask, **kw, **seg)
            torch.cuda.synchronize()
            ref_out, ref_lse = cf.flash_fwd_reference(q, k, v, mask, **kw, **seg)
            _compare(f"{name} packed", dtype, out, ref_out, lse, ref_lse, errors["fused"])

            do = _rand(gen, q.shape, dtype)
            delta = (do.float() * out.float()).sum(-1)
            dk, dv = cf.flash_bwd_dkv(do, q, k, v, lse, delta, mask, **kw, **seg)
            dq = cf.flash_bwd_dq(do, q, k, v, lse, delta, mask, **kw, **seg)
            torch.cuda.synchronize()
            ref = cf.flash_bwd_reference(do, q, k, v, lse, delta, mask, **kw, **seg)
            _compare_bwd(f"{name} packed", dtype, (dq, dk, dv), ref, bwd_errors)
            del ref

            # a hop chain: the seed on this span (the diagonal), then two
            # spans whose keys hold the same documents with their boundaries
            # moved, unbanded, resumed and fused from the carry
            spans = [(_rand(gen, k.shape, dtype), _rand(gen, k.shape, dtype),
                      _rolled(ids, shift)) for shift in (n // 3, -n // 5)]
            hop = dict(scale=kw["scale"], softclamp_value=kw["softclamp_value"])
            seed = cf.flash_partials(q, k, v, mask, **kw, **seg)
            torch.cuda.synchronize()
            ref_seed = cf.flash_partials_reference(q, k, v, mask, **kw, **seg)
            _compare_partials(f"{name} packed seed", dtype, seed, ref_seed, errors["seed"])
            (k2, v2, ids2), (k3, v3, ids3) = spans
            hop2 = dict(hop, q_seg=ids, kv_seg=ids2)
            resumed = cf.flash_partials(q, k2, v2, carry=seed, **hop2)
            carry = _clone(seed)
            cf.flash_partials(q, k2, v2, carry=carry, out=carry, **hop2)
            torch.cuda.synchronize()
            ref_resumed = cf.flash_partials_reference(q, k2, v2, carry=ref_seed, **hop2)
            for label, got in (("resume new tensors", resumed), ("resume in place", carry)):
                _compare_partials(f"{name} packed {label}", dtype, got, ref_resumed,
                                  errors["resume"])
            hop3 = dict(hop, q_seg=ids, kv_seg=ids3)
            out, lse = cf.flash_fwd(q, k3, v3, carry=resumed, **hop3)
            torch.cuda.synchronize()
            ref_out, ref_lse = cf.flash_fwd_reference(q, k3, v3, carry=ref_resumed, **hop3)
            _compare(f"{name} packed fused-carry", dtype, out, ref_out, lse, ref_lse,
                     errors["fused_carry"], rel_tol=RING_REL_TOL[str(dtype)])
            torch.cuda.synchronize()

    # the packed model's own launch: one 65,536-token causal sweep and its
    # backward, held in 1,024-row and 1,024-key slices as phases 2 and 2b
    n, w = 65536, 1024
    ids = packed_ids(n)
    q, k, v, do = (_rand(gen, (1, 8, n, 64), torch.bfloat16) for _ in range(4))
    kw = dict(scale=0.125, causal_offset=0, q_seg=ids, kv_seg=ids)
    out, lse = cf.flash_fwd(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1)
    dk, dv = cf.flash_bwd_dkv(do, q, k, v, lse, delta, **kw)
    dq = cf.flash_bwd_dq(do, q, k, v, lse, delta, **kw)
    torch.cuda.synchronize()
    for r0 in (0, n // 2, n - w):
        rows = slice(r0, r0 + w)
        sliced = dict(scale=0.125, causal_offset=r0, q_seg=ids[:, rows].contiguous(),
                      kv_seg=ids)
        ref_out, ref_lse = cf.flash_fwd_reference(q[:, :, rows].contiguous(), k, v,
                                                  **sliced)
        _compare(f"packed causal 65536 rows {r0}+", torch.bfloat16, out[:, :, rows],
                 ref_out, lse[:, :, rows], ref_lse, errors["fused"])
        ref = cf.flash_bwd_reference(
            do[:, :, rows].contiguous(), q[:, :, rows].contiguous(), k, v,
            lse[:, :, rows].contiguous(), delta[:, :, rows].contiguous(), **sliced)
        _compare_bwd(f"packed causal 65536 dq rows {r0}+", torch.bfloat16,
                     (dq[:, :, rows], None, None), ref, bwd_errors)
        keys = slice(r0, r0 + w)
        ref = cf.flash_bwd_reference(
            do, q, k[:, :, keys].contiguous(), v[:, :, keys].contiguous(), lse, delta,
            scale=0.125, causal_offset=-r0, q_seg=ids, kv_seg=ids[:, keys].contiguous())
        _compare_bwd(f"packed causal 65536 dk/dv keys {r0}+", torch.bfloat16,
                     (None, dk[:, :, keys], dv[:, :, keys]), ref, bwd_errors)
        del ref
    torch.cuda.synchronize()
    result = {mode: max(errs) for mode, errs in errors.items()}
    result.update({label: max(errs) for label, errs in bwd_errors.items()})
    return result


def _expected_doc_skips(ids, striped: bool) -> int:
    """(rank, hop) pairs of a causal ring of RING_SIZE, per layer, whose band
    has work and whose two id ranges share no document: worked out here
    from the ids alone.  Contiguous, rank r has work on hops 0..r; striped
    (rank r holds tokens r, r + W, ...), on every hop."""
    x = ids[0].cpu().numpy()
    if striped:
        x = x.reshape(-1, RING_SIZE).T.reshape(-1)
    shards = x.reshape(RING_SIZE, -1)
    lo, hi = shards.min(1), shards.max(1)
    skips = 0
    for rank in range(RING_SIZE):
        for i in range(RING_SIZE):
            origin = (rank - i) % RING_SIZE
            if (striped or i <= rank) and not (lo[rank] <= hi[origin] and lo[origin] <= hi[rank]):
                skips += 1
    return skips


def _packed_ring_counts(counts, skips, striped, backward) -> bool:
    """Whether a packed ring run launched what the hop schedule and the
    skipped hops say: every seed, one resume or fused-carry launch fewer
    per skipped hop, one backward hop fewer per skipped hop, and every
    launch the segmented kernels'."""
    depth = BENCH_MODEL["depth"]
    seed, resume, fused, dkv, dq = RING_SCHEDULE[striped]
    ok = (counts["seed"] == seed * depth
          and counts["resume"] + counts["fused_carry"] == (resume + fused - skips) * depth
          and counts["flash_fwd"] == counts["seed"] + counts["resume"] + counts["fused_carry"]
          and counts["seg_flash_fwd"] == counts["flash_fwd"]
          and counts["flash_bwd_dkv"] == ((dkv - skips) * depth if backward else 0)
          and counts["flash_bwd_dq"] == ((dq - skips) * depth if backward else 0)
          and counts["seg_flash_bwd_dkv"] == counts["flash_bwd_dkv"]
          and counts["seg_flash_bwd_dq"] == counts["flash_bwd_dq"])
    others = {name: n for name, n in counts.items() if name not in (
        "flash_fwd", "seed", "resume", "fused_carry", "flash_bwd_dkv", "flash_bwd_dq",
        "seg_flash_fwd", "seg_flash_bwd_dkv", "seg_flash_bwd_dq")}
    return ok and not any(others.values())


def _alone_logits(model, tokens, p0: int):
    """``tokens`` run alone through the local ``model`` on the unsegmented
    kernels, with the rotary positions p0, p0 + 1, ... they hold in the
    packed row (the model itself would rotate from 0)."""
    import types

    import torch

    from ring_attention_tpu_torch import cuda_flash_attention

    def local_attend(layer, q, k, v, mask, segment_ids=None):
        positions = torch.arange(p0, p0 + q.shape[2], device=q.device)
        q, k = layer._rotate(q, k, positions)
        return cuda_flash_attention(q, k, v, mask, causal=layer.causal,
                                    softclamp_value=layer.softclamp_value)

    for layer in model.attn_layers:
        layer._local_attend = types.MethodType(local_attend, layer)
    try:
        return model(tokens)
    finally:
        for layer in model.attn_layers:
            del layer._local_attend


def _hold_packed_f32(tokens, ids) -> None:
    """The f32 model, packed at 65,536 tokens on the card: each document's
    logits against the same document run alone (the unsegmented kernels)
    at the rotary positions it holds in the row, within MODEL_ATOL; beside
    it, against the document run alone from position 0 (rotary is
    relative, so only f32 rounding of large angles separates the two).
    Then the packed f32 model at seq 256, card vs CPU, logits and one
    step's gradients, locally and on the ring."""
    import torch

    from ring_attention_tpu_torch.parallel import create_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = _model(None, "cuda")
    with torch.inference_mode():
        packed = model(tokens, segment_ids=ids)
        worst, worst_from_0, start = 0.0, 0.0, 0
        for length in doc_lengths(ids):
            doc = tokens[:, start:start + length]
            got = packed[:, start:start + length]
            err = (got - _alone_logits(model, doc, start)).abs().max().item()
            err_0 = (got - model(doc)).abs().max().item()
            worst, worst_from_0 = max(worst, err), max(worst_from_0, err_0)
            log(f"  f32 document at {start} ({length} tokens): packed vs alone at its "
                f"positions max|diff| {err:.3e}, vs alone from position 0 {err_0:.3e}")
            start += length
    log(f"  f32 packed vs alone: worst {worst:.3e} (tol {MODEL_ATOL}); from position 0 "
        f"{worst_from_0:.3e} (not held: rotary angles rounded at large positions)")
    check(worst <= MODEL_ATOL, "f32 packed documents disagree with the documents alone")
    del model, packed

    gen = torch.Generator().manual_seed(SEED + 13)
    small = torch.randint(0, BENCH_MODEL["num_tokens"], (2, sum(SMALL_PACKING)), generator=gen)
    small_ids = torch.repeat_interleave(torch.arange(len(SMALL_PACKING)),
                                        torch.tensor(SMALL_PACKING))[None].expand(2, -1)
    for ring in ({}, dict(mesh=create_mesh(ring_size=RING_SIZE)),
                 dict(mesh=create_mesh(ring_size=RING_SIZE), striped=True)):
        gpu = _model(None, "cuda", **ring)
        cpu = copy.deepcopy(gpu).to("cpu")
        with torch.no_grad():
            logits_err = (gpu(small[:, :256].cuda(), segment_ids=small_ids[:, :256].cuda()).cpu()
                          - cpu(small[:, :256], segment_ids=small_ids[:, :256])).abs().max().item()
        losses = []
        for m, dev in ((gpu, "cuda"), (cpu, "cpu")):
            loss = m(small.to(dev), return_loss=True, segment_ids=small_ids.to(dev))
            loss.backward()
            losses.append(loss.item())
        grad_err = max(((pg.grad.cpu() - pc.grad).norm() / pc.grad.norm()).item()
                       for pg, pc in zip(gpu.parameters(), cpu.parameters()))
        name = "local" if not ring else ("striped" if ring.get("striped") else "contiguous")
        log(f"  f32 packed model seq 256 ({name}), card vs CPU: logits max|diff| "
            f"{logits_err:.3e} (tol {MODEL_ATOL}), loss {losses[0]:.7f} vs {losses[1]:.7f}, "
            f"worst gradient ||card - cpu|| / ||cpu|| {grad_err:.3e} (tol {GRAD_REL_TOL})")
        check(logits_err <= MODEL_ATOL and grad_err <= GRAD_REL_TOL,
              f"f32 packed {name} model on the card disagrees with the CPU")


def phase_packed_path(serving: dict, training: dict) -> dict:
    """The packed path at full width: the bench model on 1 x 65,536 packed
    tokens, forward and one train step, locally and on the ring of 4
    (contiguous and striped, ``impl="cuda"``), with exact launch counts and
    the hops the ids skip; the f32 checks of ``_hold_packed_f32``; then the
    packed forward and step timed beside the unpacked ones (phase 4f's
    model rows)."""
    import torch

    from ring_attention_tpu_torch import make_train_step
    from ring_attention_tpu_torch.parallel import create_mesh
    from ring_attention_tpu_torch.parallel import ring as pring

    tokens, local = serving["tokens"], serving["model"]
    ids = packed_ids(65536)
    # the train step takes 65,537 ids: its last document is one longer
    step_tokens = training["tokens"]
    step_ids = torch.cat([ids, ids[:, -1:]], dim=1)
    log(f"phase 3f: packed documents, bench model at full width, bf16: 1 x 65536 tokens "
        f"in {len(doc_lengths(ids))} documents {doc_lengths(ids)}")
    launches = {name: 0 for name in COUNTERS}
    with torch.inference_mode():
        _reset_counts()
        ref = local(tokens, segment_ids=ids)
        torch.cuda.synchronize()
        counts = _read_counts()
    depth = BENCH_MODEL["depth"]
    expected = _counts(flash_fwd=depth, seg_flash_fwd=depth)
    check(counts == expected, f"local packed forward launched {counts}, expected {expected}")
    check(bool(torch.isfinite(ref.float()).all()) and tuple(ref.shape) == (1, 65536, 256),
          "local packed forward: logits")
    for name, n in counts.items():
        launches[name] += n
    log(f"  local forward: launches {counts}")

    models = {"local": _model(torch.bfloat16, "cuda").train()}
    for striped in (False, True):
        layout = "striped" if striped else "contiguous"
        skips = _expected_doc_skips(ids, striped)
        model = _model(torch.bfloat16, "cuda", mesh=create_mesh(ring_size=RING_SIZE),
                       striped=striped)
        with torch.inference_mode():
            _reset_counts()
            pring.doc_skip_count = pring.doc_skip_bwd_count = 0
            logits = model(tokens, segment_ids=ids)
            torch.cuda.synchronize()
            counts = _read_counts()
        check(_packed_ring_counts(counts, skips, striped, backward=False)
              and pring.doc_skip_count == skips * depth,
              f"{layout} packed forward launched {counts}, {pring.doc_skip_count} hops "
              f"skipped; expected {skips} skipped per layer")
        for name, n in counts.items():
            launches[name] += n
        rel = ((logits.float() - ref.float()).norm() / ref.float().norm()).item()
        log(f"  {layout} ring forward: {skips} of the {16 if striped else 10} hops with band "
            f"work skipped per layer (the ids share no document), launches {counts}; "
            f"logits vs the local packed model ||diff|| / ||local|| {rel:.3e} "
            f"(tol rel {RING_LOGITS_REL_TOL})")
        check(rel <= RING_LOGITS_REL_TOL, f"{layout} packed ring logits disagree")
        models[layout] = model.train()
        del logits

    steps = {}
    for layout, model in models.items():
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        packed_step = make_train_step(
            lambda t, m=model: m(t, return_loss=True, segment_ids=step_ids), opt)
        plain_step = make_train_step(lambda t, m=model: m(t, return_loss=True), opt)
        _reset_counts()
        pring.doc_skip_count = pring.doc_skip_bwd_count = 0
        loss = float(packed_step(step_tokens))
        torch.cuda.synchronize()
        counts = _read_counts()
        if layout == "local":
            ok = counts == _counts(flash_fwd=depth, seg_flash_fwd=depth,
                                   flash_bwd_dkv=depth, flash_bwd_dq=depth,
                                   seg_flash_bwd_dkv=depth, seg_flash_bwd_dq=depth)
        else:
            skips = _expected_doc_skips(ids, layout == "striped")
            ok = (_packed_ring_counts(counts, skips, layout == "striped", backward=True)
                  and pring.doc_skip_bwd_count == skips * depth)
        check(ok and math.isfinite(loss), f"{layout} packed step: loss {loss}, launches {counts}")
        for name, n in counts.items():
            launches[name] += n
        log(f"  {layout} packed train step: loss {loss:.6f}, launches {counts}")
        steps[layout] = (packed_step, plain_step)

    _hold_packed_f32(tokens, ids)

    log("  packed vs unpacked, the same model and tokens (CUDA events for the forward, "
        "host clock around synchronized steps; in turns: unpacked, packed, packed, "
        "unpacked)")
    timings = {}
    for layout, model in models.items():
        model.eval()
        fwd = {"unpacked": [], "packed": []}
        with torch.inference_mode():
            for kind in ("unpacked", "packed", "packed", "unpacked"):
                seg = ids if kind == "packed" else None
                fwd[kind].append(time_ms(lambda: model(tokens, segment_ids=seg), iters=5))
        model.train()
        step_ms = {"unpacked": [], "packed": []}
        for kind in ("unpacked", "packed", "packed", "unpacked"):
            step = steps[layout][0 if kind == "packed" else 1]
            step_ms[kind].append(_train_step_timing(step, step_tokens)[0])
        timings[layout] = {kind: (statistics.mean(fwd[kind]), statistics.mean(step_ms[kind]))
                           for kind in fwd}
        (uf, us), (pf, ps) = timings[layout]["unpacked"], timings[layout]["packed"]
        log(f"  {layout}: forward 1 x 65536 unpacked {uf:.3f} ms, packed {pf:.3f} ms "
            f"({pf / uf:.3f} x); train step unpacked {us:.3f} ms, packed {ps:.3f} ms "
            f"({ps / us:.3f} x)")
    del models, steps
    return {"launches": launches, "timings": timings}


def _sdpa_packed_mask(ids):
    """The dense boolean block-diagonal causal mask ``(n, n)`` of a ``(1,
    n)`` packing: the library yardstick's ``attn_mask``."""
    import torch

    n = ids.shape[1]
    same = ids[0][:, None] == ids[0][None, :]
    return same & torch.ones((n, n), dtype=torch.bool, device=ids.device).tril()


def _sdpa_masked(fn):
    """``fn()``'s time, or None when the card cannot hold its dense mask
    and scores (SDPA with an arbitrary mask at long sequence)."""
    import torch

    try:
        return time_ms(fn, iters=5)
    except torch.cuda.OutOfMemoryError as err:
        log(f"  (library yardstick did not fit: {str(err).splitlines()[0]})")
        torch.cuda.empty_cache()
        return None


def phase_segmented_timings(packed: dict) -> dict[str, list[dict]]:
    """Phase 4f: the segmented B1, B2 and B3 on the packed causal (1, 8, n,
    64) bf16 shape at 4,096 (with the plain versions), 16,384 and 65,536,
    beside their bound (same-document in-band pairs only) and SDPA with the
    packing's dense boolean block-diagonal causal mask; returns each
    kernel's rows, every row carrying the segmented launches of the packed
    path (phase 3f)."""
    import torch
    import torch.nn.functional as F

    from ring_attention_tpu_torch.ops import cuda_flash as cf

    log("phase 4f: segmented kernels on the packed shape (CUDA events)")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    rows: dict[str, list[dict]] = {"flash_fwd": [], "flash_bwd_dkv": [], "flash_bwd_dq": []}
    launches = packed["launches"]
    for n in (4096, 16384, 65536):
        ids = packed_ids(n, len_range=SHORT_LEN_RANGE if n == 4096 else PACK_LEN_RANGE)
        q, k, v, do = (_rand(gen, (1, 8, n, 64), torch.bfloat16) for _ in range(4))
        kw = dict(scale=0.125, causal_offset=0, q_seg=ids, kv_seg=ids)
        out, lse = cf.flash_fwd(q, k, v, **kw)
        delta = (do.float() * out.float()).sum(-1)
        pairs = 8 * same_doc_pairs(ids)
        docs = len(doc_lengths(ids))
        shape = (f"packed causal (1,8,{n},64) bf16, {docs} document{'s' * (docs > 1)} "
                 f"(lengths log-uniform on {SHORT_LEN_RANGE if n == 4096 else PACK_LEN_RANGE})")
        mask = _sdpa_packed_mask(ids)
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)

        fwd_lib = _sdpa_masked(sdpa)
        bwd_lib = None
        if fwd_lib is not None:
            try:
                ref = sdpa()
                bwd_lib = _sdpa_masked(lambda: torch.autograd.grad(
                    ref, (qg, kg, vg), do, retain_graph=True))
                del ref
            except torch.cuda.OutOfMemoryError:
                torch.cuda.empty_cache()
        del mask
        with_plain = n == 4096
        args = (do, q, k, v, lse, delta)
        bwd_plain = (time_ms(lambda: cf.flash_bwd_reference(*args, **kw), iters=3)
                     if with_plain else None)
        id_bytes = nbytes(ids, ids)
        f32_grad = 4 * n * 64 * 8
        for name, fn, products, moved, plain, library in (
            ("flash_fwd", lambda: cf.flash_fwd(q, k, v, **kw), 2,
             nbytes(q, k, v, out, lse) + id_bytes,
             (time_ms(lambda: cf.flash_fwd_reference(q, k, v, **kw), iters=3)
              if with_plain else None), fwd_lib),
            ("flash_bwd_dkv", lambda: cf.flash_bwd_dkv(*args, **kw), 4,
             nbytes(*args) + id_bytes + 2 * f32_grad, bwd_plain, bwd_lib),
            ("flash_bwd_dq", lambda: cf.flash_bwd_dq(*args, **kw), 3,
             nbytes(*args) + id_bytes + f32_grad, bwd_plain, bwd_lib),
        ):
            ops = 2 * products * 64 * pairs
            b_ms, b_by = bound_ms(ops, moved, torch.bfloat16)
            ms = time_ms(fn, iters=10 if n < 65536 else 5)
            rows[name].append({"shape": shape, "launches": launches[f"seg_{name}"],
                               "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                               "bound_by": b_by, "library_ms": library})
            log(f"  {name} {shape}: kernel {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
                f"same-document pairs only), plain {plain} ms"
                f"{' (all three gradients)' if plain and name != 'flash_fwd' else ''}, "
                f"sdpa with the dense block-diagonal causal mask"
                f"{' backward' if name != 'flash_fwd' else ''} {library} ms, "
                f"{ops / ms / 1e9:.1f} TFLOP/s")
        del q, k, v, do, out, lse, delta, qg, kg, vg
        torch.cuda.empty_cache()
    for layout, t in packed["timings"].items():
        (uf, us), (pf, ps) = t["unpacked"], t["packed"]
        log(f"  {layout} model: forward unpacked {uf:.3f} / packed {pf:.3f} ms, "
            f"train step unpacked {us:.3f} / packed {ps:.3f} ms (phase 3f)")
    return rows


# ---------------------------------------------------------------------------
# Zig-zag and decoding on a mesh (phases 2h, 3g-3j, 4g)
# ---------------------------------------------------------------------------

# The zig-zag model runs the bench model on a virtual ring of 4 at 1 x 65,536
# tokens: 8 chunks of 8,192, each against the whole gathered span.
ZIGZAG_SEQ = 65536
# BASELINE.json config 3: causal zig-zag at 32,768 tokens on a ring of 8,
# 8 heads of 64, bf16.
CONFIG3_SEQ, CONFIG3_RING = 32768, 8
# BASELINE.json config 5: tree decode b1 h8 hk8 d64, a 1,048,576-token cache
# over a ring of 4 (shards of 262,144).
CONFIG5_SEQ = 1 << 20
# The empty-rank case: valid cache prefixes of 100 keys (fewer than rank 0's
# shard: ranks 1-3 hold none) and 300,000 (rank 1 in part, ranks 2-3 none).
EMPTY_RANK_PREFIXES = (100, 300000)
# The serving path on a ring of 4: 4 prompts of 2,048, 128 new tokens, a
# cache of 4,096 (shards of 1,024: the prompts fill ranks 0 and 1).
SERVE_PROMPT, SERVE_NEW, SERVE_MAX_LEN = 2048, 128, 4096
# Phase-3g bf16 zig-zag vs local gradients, largest ||diff|| / ||local|| over
# the parameters: the same bf16 model whose attention sums each query chunk
# against the gathered span in other tiles than the one causal sweep, and
# whose dk/dv sum over the 8 chunks, through two layers and back.
ZIGZAG_BF16_GRAD_REL_TOL = 2e-2


def _zigzag_chunk_vs_plain(name, dtype, chunk, span, start, gen, errors, dense) -> None:
    """B1, B2 and B3 on one zig-zag query chunk (global rows ``start`` ..
    ``start + chunk``) against the whole gathered span, as
    ``parallel/zigzag.py`` launches them, against their plain versions
    (``dense``: whole; else in 1,024-row and 1,024-key slices, the band
    shifted to the slice).  The keys past the chunk's last row meet no
    query: their dk and dv must be written, and zero."""
    import torch

    from ring_attention_tpu_torch.ops import cuda_flash as cf

    q, do = (_rand(gen, (1, 8, chunk, 64), dtype) for _ in range(2))
    k, v = (_rand(gen, (1, 8, span, 64), dtype) for _ in range(2))
    kw = dict(scale=0.125, causal_offset=start)
    out, lse = cf.flash_fwd(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1)
    dk, dv = cf.flash_bwd_dkv(do, q, k, v, lse, delta, **kw)
    dq = cf.flash_bwd_dq(do, q, k, v, lse, delta, **kw)
    torch.cuda.synchronize()
    end = start + chunk
    if end < span:
        zero = bool((dk[:, :, end:] == 0).all()) and bool((dv[:, :, end:] == 0).all())
        log(f"  {name}: dk/dv of the {span - end} keys past the chunk all zero: {zero}")
        check(zero, f"{name}: dk/dv past the band are not zero")
    rel_tol = RING_REL_TOL[str(dtype)]
    if dense:
        ref_out, ref_lse = cf.flash_fwd_reference(q, k, v, **kw)
        _compare(name, dtype, out, ref_out, lse, ref_lse, errors["fwd"], rel_tol=rel_tol)
        ref = cf.flash_bwd_reference(do, q, k, v, lse, delta, **kw)
        _compare_bwd(name, dtype, (dq, dk, dv), ref, errors["bwd"])
        return
    w = 1024
    for r0 in (0, chunk // 2, chunk - w):
        rows = slice(r0, r0 + w)
        qs, dos = q[:, :, rows].contiguous(), do[:, :, rows].contiguous()
        band = dict(scale=0.125, causal_offset=start + r0)
        ref_out, ref_lse = cf.flash_fwd_reference(qs, k, v, **band)
        _compare(f"{name} rows {r0}+", dtype, out[:, :, rows], ref_out, lse[:, :, rows],
                 ref_lse, errors["fwd"], rel_tol=rel_tol)
        del ref_out, ref_lse
        ref = cf.flash_bwd_reference(dos, qs, k, v, lse[:, :, rows].contiguous(),
                                     delta[:, :, rows].contiguous(), **band)
        _compare_bwd(f"{name} dq rows {r0}+", dtype, (dq[:, :, rows], None, None), ref,
                     errors["bwd"])
        del ref
    for c0 in sorted({0, max(0, end - w), span - w}):
        keys = slice(c0, c0 + w)
        ref = cf.flash_bwd_reference(do, q, k[:, :, keys].contiguous(),
                                     v[:, :, keys].contiguous(), lse, delta,
                                     scale=0.125, causal_offset=start - c0)
        _compare_bwd(f"{name} dk/dv keys {c0}+", dtype, (None, dk[:, :, keys], dv[:, :, keys]),
                     ref, errors["bwd"])
        del ref
    torch.cuda.synchronize()


def _empty_shard_partials(name, parts) -> None:
    """A shard with no valid key keeps m at the finite MASK_VALUE with l > 0
    and a finite acc, so that exp(m - m_global) removes it in the merge."""
    import torch

    from ring_attention_tpu_torch.ops.attention import MASK_VALUE

    acc, m, l = parts
    ok = (bool((m == MASK_VALUE).all()) and bool((l > 0).all())
          and bool(torch.isfinite(acc).all()) and bool(torch.isfinite(l).all()))
    log(f"  {name}: m == MASK_VALUE everywhere {bool((m == MASK_VALUE).all())}, "
        f"min l {l.min().item():.1f}, acc finite {bool(torch.isfinite(acc).all())}")
    check(ok, f"{name}: an empty shard's partials are not (finite acc, MASK_VALUE, l > 0)")


def _finalize_decode_partials(parts):
    """``(out, lse)`` of decode partials ``(acc (b, hk, g, nq, d), m, l)``."""
    from ring_attention_tpu_torch.ops.partials import FlashPartials, finalize_partials

    return finalize_partials(FlashPartials(*(x.flatten(1, 2) for x in parts)))


def phase_mesh_kernels_vs_plain() -> dict:
    """Phase 2h: the kernels at the shapes zig-zag and tree decoding give
    them, against their plain versions; returns the largest errors."""
    import torch

    from ring_attention_tpu_torch.ops import cuda_flash as cf
    from ring_attention_tpu_torch.ops import cuda_flash_q8 as q8
    from ring_attention_tpu_torch.ops.partials import FlashPartials

    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    errors = {"fwd": [], "bwd": {}, "decode": [], "decode_q8": []}
    log("phase 2h: flash_fwd, flash_bwd_dkv and flash_bwd_dq on zig-zag chunks against the "
        "whole gathered span, flash_decode and flash_decode_q8 partials on each rank's cache "
        "shard, vs their plain versions")
    # the zig-zag model's chunks (ring 4 at 65,536: chunks of 8,192), the first
    # and the last, in slices; config 3's (ring 8 at 32,768: chunks of 2,048)
    # and a small ring-8 span in f32, whole
    model_chunk = ZIGZAG_SEQ // (2 * RING_SIZE)
    for which, start in (("first", 0), ("last", (2 * RING_SIZE - 1) * model_chunk)):
        _zigzag_chunk_vs_plain(f"zigzag {which} chunk 8192 of 65536", torch.bfloat16,
                               model_chunk, ZIGZAG_SEQ, start, gen, errors, dense=False)
    config3_chunk = CONFIG3_SEQ // (2 * CONFIG3_RING)
    for which, start in (("first", 0), ("last", (2 * CONFIG3_RING - 1) * config3_chunk)):
        _zigzag_chunk_vs_plain(f"zigzag {which} chunk 2048 of 32768", torch.bfloat16,
                               config3_chunk, CONFIG3_SEQ, start, gen, errors, dense=True)
        _zigzag_chunk_vs_plain(f"zigzag {which} chunk 512 of 8192", torch.float32, 512, 8192,
                               0 if which == "first" else 15 * 512, gen, errors, dense=True)

    # tree decoding's partials at config 5: each rank's shard of a
    # 1,048,576-token cache, full and with valid prefixes that leave ranks
    # without a valid key
    n, ring = CONFIG5_SEQ, RING_SIZE
    n_local = n // ring
    q = _rand(gen, (1, 8, 1, 64), torch.bfloat16)
    k, v = (_rand(gen, (1, 8, n, 64), torch.bfloat16) for _ in range(2))
    kv8 = q8.quantize_kv_cache(k, v)
    for valid in (n,) + EMPTY_RANK_PREFIXES:
        mask = (torch.arange(n, device="cuda") < valid)[None]
        for r in range(ring):
            cut = slice(r * n_local, (r + 1) * n_local)
            shard = [x[:, :, cut].contiguous() for x in (k, v)]
            mask_r = mask[:, cut].contiguous()
            parts = cf.cuda_flash_decode(q, *shard, mask_r, fused=False)
            torch.cuda.synchronize()
            ref = cf.flash_decode_reference(q, *shard, mask_r, fused=False)
            label = f"decode partials valid {valid} rank {r}"
            _compare_partials(label, torch.bfloat16, FlashPartials(*parts),
                              FlashPartials(*ref), errors["decode"])
            kv_r = q8.QuantizedKV(*(x[:, :, cut].contiguous() for x in kv8))
            parts8 = q8.flash_decode_q8(q, kv_r, mask_r, fused=False)
            torch.cuda.synchronize()
            ref8 = q8.flash_decode_q8_reference(q, kv_r, mask_r, fused=False)
            (out, lse), (ref_out, ref_lse) = (
                _finalize_decode_partials(p) for p in (parts8, ref8))
            _compare_q8(f"decode_q8 partials valid {valid} rank {r}", torch.bfloat16, out,
                        ref_out, lse, ref_lse, errors["decode_q8"],
                        DECODE_Q8_REL_TOL["torch.bfloat16"], DECODE_Q8_LSE_TOL)
            if valid <= r * n_local:
                _empty_shard_partials(f"empty rank {r} (valid {valid}) flash_decode", parts)
                _empty_shard_partials(f"empty rank {r} (valid {valid}) flash_decode_q8",
                                      parts8)
            del parts, ref, parts8, ref8
    torch.cuda.synchronize()
    return {"fwd": max(errors["fwd"]),
            **{label: max(errs) for label, errs in errors["bwd"].items()},
            "decode": max(errors["decode"]), "decode_q8": max(errors["decode_q8"])}


def _param_grads(model, tokens) -> list:
    """One loss and backward: every parameter's gradient (f32), then cleared."""
    model.zero_grad(set_to_none=True)
    model(tokens, return_loss=True).backward()
    grads = [p.grad.detach().clone() for p in model.parameters()]
    model.zero_grad(set_to_none=True)
    return grads


def _grad_rel(got, ref) -> float:
    return max((g.float() - r.float()).norm().item() / max(r.float().norm().item(), 1e-30)
               for g, r in zip(got, ref))


def _zigzag_counts(backward: bool) -> dict[str, int]:
    """Launches of one forward (and backward) of the zig-zag model on the
    ring of 4: per layer B1 once per query chunk (2 a rank, fused mode), and
    B2 and B3 once per chunk."""
    chunks = 2 * RING_SIZE * BENCH_MODEL["depth"]
    return _counts(flash_fwd=chunks, flash_bwd_dkv=chunks if backward else 0,
                   flash_bwd_dq=chunks if backward else 0)


def phase_zigzag_path(serving: dict, training: dict) -> dict:
    """Phase 3g: the zig-zag model at full width on a virtual ring of 4."""
    import torch

    from ring_attention_tpu_torch import make_train_step
    from ring_attention_tpu_torch.parallel import create_mesh

    log(f"phase 3g: RingTransformer(sequence_parallel='zigzag', mesh=create_mesh(ring_size="
        f"{RING_SIZE})) on a virtual ring, bench model at full width, bf16, 1 x {ZIGZAG_SEQ}")
    tokens, local = serving["tokens"], serving["model"]
    launches = {name: 0 for name in COUNTERS}
    model = _model(torch.bfloat16, "cuda", mesh=create_mesh(ring_size=RING_SIZE),
                   sequence_parallel="zigzag")
    with torch.inference_mode():
        ref = local(tokens).float()
        _reset_counts()
        start = time.perf_counter()
        logits = model(tokens)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        counts = _read_counts()
    check(counts == _zigzag_counts(False), f"zigzag forward launched {counts}")
    for name, c in counts.items():
        launches[name] += c
    check(bool(torch.isfinite(logits.float()).all()), "zigzag: non-finite logits")
    rel = ((logits.float() - ref).norm() / ref.norm()).item()
    log(f"  forward: {seconds:.3f} s (first call), launches {counts}; logits vs the local "
        f"model ||diff|| / ||local|| {rel:.3e} (tol rel {RING_LOGITS_REL_TOL})")
    check(rel <= RING_LOGITS_REL_TOL, "zigzag logits disagree with the local model")
    del logits, ref

    # one step's gradients against the local model with the same weights
    model.train()
    local.train()
    _reset_counts()
    grads = _param_grads(model, training["tokens"])
    torch.cuda.synchronize()
    counts = _read_counts()
    check(counts == _zigzag_counts(True), f"zigzag backward launched {counts}")
    for name, c in counts.items():
        launches[name] += c
    ref_grads = _param_grads(local, training["tokens"])
    local.eval()
    grad_rel = _grad_rel(grads, ref_grads)
    del grads, ref_grads
    log(f"  one step's gradients vs the local model's: largest ||diff|| / ||local|| over "
        f"the parameters {grad_rel:.3e} (bf16; tol {ZIGZAG_BF16_GRAD_REL_TOL})")
    check(grad_rel <= ZIGZAG_BF16_GRAD_REL_TOL, "zigzag gradients disagree with the local model")

    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = make_train_step(lambda t: model(t, return_loss=True), opt)
    losses = []
    for i in range(TRAIN_STEPS):
        _reset_counts()
        start = time.perf_counter()
        loss = float(step(training["tokens"]))
        seconds = time.perf_counter() - start
        counts = _read_counts()
        log(f"  step {i}: loss {loss:.6f}, {seconds:.3f} s, launches {counts}")
        check(counts == _zigzag_counts(True), f"zigzag step {i} launched {counts}")
        check(math.isfinite(loss), f"zigzag step {i}: loss {loss}")
        losses.append(loss)
        for name, c in counts.items():
            launches[name] += c
    check(losses[-1] < losses[0], f"zigzag: loss did not fall: {losses}")
    _hold_f32_zigzag_to_local()
    return {"launches": launches, "model": model, "step": step}


def _hold_f32_zigzag_to_local() -> None:
    """The float32 zig-zag model on the card against the float32 local
    model on the card (logits and one step's gradients, 1 x 4,096 tokens)
    and against itself on the CPU (seq 256)."""
    import torch

    from ring_attention_tpu_torch.parallel import create_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED + 21)
    tokens = torch.randint(0, BENCH_MODEL["num_tokens"], (1, 4097), generator=gen).cuda()
    zz = _model(None, "cuda", mesh=create_mesh(ring_size=RING_SIZE),
                sequence_parallel="zigzag").train()
    local = _model(None, "cuda").train()
    with torch.no_grad():
        logits_err = (zz(tokens[:, :-1]) - local(tokens[:, :-1])).abs().max().item()
    grad_rel = _grad_rel(_param_grads(zz, tokens), _param_grads(local, tokens))
    cpu = copy.deepcopy(zz).to("cpu")
    small = tokens[:, :257].cpu()
    with torch.no_grad():
        cpu_err = (zz(small[:, :-1].cuda()).cpu() - cpu(small[:, :-1])).abs().max().item()
    cpu_rel = _grad_rel([g.cpu() for g in _param_grads(zz, small.cuda())],
                        _param_grads(cpu, small))
    log(f"  f32 zigzag vs f32 local model on the card, 1 x 4096: logits max|diff| "
        f"{logits_err:.3e} (tol {MODEL_ATOL}), gradients largest ||diff|| / ||local|| "
        f"{grad_rel:.3e} (tol {GRAD_REL_TOL}); vs itself on the CPU at seq 256: logits "
        f"{cpu_err:.3e}, gradients {cpu_rel:.3e}")
    check(max(logits_err, cpu_err) <= MODEL_ATOL and max(grad_rel, cpu_rel) <= GRAD_REL_TOL,
          "f32 zigzag model disagrees with the local model or the CPU")
    del zz, local, cpu


def phase_zigzag_config3() -> dict:
    """Phase 3h: ``zigzag_attention`` at BASELINE.json config 3 against
    ``cuda_flash_attention`` on the canonical sequence: output and
    gradients, and the launches."""
    import torch

    from ring_attention_tpu_torch.ops.cuda_flash import cuda_flash_attention
    from ring_attention_tpu_torch.parallel import (
        VirtualRing,
        zigzag_attention,
        zigzag_permute,
        zigzag_unpermute,
    )

    n, ring = CONFIG3_SEQ, CONFIG3_RING
    log(f"phase 3h: zigzag_attention at BASELINE.json config 3: causal, {n} tokens, a "
        f"virtual ring of {ring}, 8 heads of 64, bf16, against cuda_flash_attention")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    q, k, v, do = (_rand(gen, (1, 8, n, 64), torch.bfloat16) for _ in range(4))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = cuda_flash_attention(*leaves, causal=True)
    ref.backward(do)
    ref_grads = [x.grad for x in leaves]
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ring_ = VirtualRing(ring)
    _reset_counts()
    out = zigzag_attention(*(zigzag_permute(x, ring, axis=2) for x in leaves), ring_,
                           impl="cuda")
    out = zigzag_unpermute(out, ring, axis=2)
    out.backward(do)
    torch.cuda.synchronize()
    counts = _read_counts()
    chunks = 2 * ring
    expected = _counts(flash_fwd=chunks, flash_bwd_dkv=chunks, flash_bwd_dq=chunks)
    log(f"  launches {counts}")
    check(counts == expected, f"config 3 launched {counts}, expected {expected}")
    errors = {"fwd": []}
    bwd_errors: dict[str, list[float]] = {}
    atol, rtol = OUT_TOL["torch.bfloat16"]
    diff = (out.detach().float() - ref.detach().float())
    rel = (diff.norm() / ref.detach().float().norm()).item()
    ok = bool((diff.abs() <= atol + rtol * ref.detach().float().abs()).all())
    errors["fwd"].append(diff.abs().max().item())
    log(f"  output vs cuda_flash_attention: max|diff| {diff.abs().max().item():.3e} (tol "
        f"{atol}+{rtol}*|ref|), ||diff|| / ||ref|| {rel:.3e} "
        f"(tol {RING_REL_TOL['torch.bfloat16']})")
    check(ok and rel <= RING_REL_TOL["torch.bfloat16"], "config 3 output disagrees")
    _compare_bwd("config 3 gradients vs cuda_flash_attention", torch.bfloat16,
                 [x.grad for x in leaves], ref_grads, bwd_errors)
    return {"launches": counts, "fwd_err": errors["fwd"][0],
            **{label: max(e) for label, e in bwd_errors.items()}}


def phase_tree_decode_config5() -> dict:
    """Phase 3i: ``tree_attn_decode`` at BASELINE.json config 5 against one
    fused decode launch over the whole cache (B5; B6 on the int8 cache),
    and the empty-rank case."""
    import torch

    from ring_attention_tpu_torch.ops import cuda_flash as cf
    from ring_attention_tpu_torch.ops import cuda_flash_q8 as q8
    from ring_attention_tpu_torch.parallel import VirtualRing, tree_attn_decode

    n = CONFIG5_SEQ
    log(f"phase 3i: tree_attn_decode at BASELINE.json config 5: b1 h8 hk8 d64, a {n}-token "
        f"cache over a virtual ring of {RING_SIZE}, bf16, against one fused launch over the "
        f"whole cache")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    q = _rand(gen, (1, 8, 1, 64), torch.bfloat16)
    # the cache as the model keeps it on a mesh, one tensor a rank's shard,
    # and the whole cache that the one fused launch reads
    n_local = n // RING_SIZE
    k_shards, v_shards = ([_rand(gen, (1, 8, n_local, 64), torch.bfloat16)
                           for _ in range(RING_SIZE)] for _ in range(2))
    kv8_shards = [q8.quantize_kv_cache(a, b) for a, b in zip(k_shards, v_shards)]
    k, v = torch.cat(k_shards, dim=2), torch.cat(v_shards, dim=2)
    kv8 = q8.QuantizedKV(*(torch.cat(x, dim=2) for x in zip(*kv8_shards)))
    ring = VirtualRing(RING_SIZE)
    launches = {name: 0 for name in COUNTERS}
    errs = {"decode": [], "decode_q8": []}
    rel_tol = RING_REL_TOL["torch.bfloat16"]
    for valid in (n,) + EMPTY_RANK_PREFIXES:
        mask = (torch.arange(n, device="cuda") < valid)[None]
        fused, _ = cf.cuda_flash_decode(q, k, v, mask)
        fused8, _ = q8.flash_decode_q8(q, kv8, mask)
        masks = list(mask.chunk(RING_SIZE, dim=1))
        _reset_counts()
        tree = tree_attn_decode(q, k_shards, v_shards, masks, ring=ring, impl="cuda")
        tree8 = tree_attn_decode(q, None, None, masks, ring=ring, kv_quantized=kv8_shards)
        torch.cuda.synchronize()
        counts = _read_counts()
        expected = _counts(flash_decode=RING_SIZE, flash_decode_q8=RING_SIZE)
        check(counts == expected, f"tree decode launched {counts}, expected {expected}")
        for name, c in counts.items():
            launches[name] += c
        for label, got, ref, key in (("flash_decode", tree, fused, "decode"),
                                     ("flash_decode_q8", tree8, fused8, "decode_q8")):
            diff = got.float() - ref.float()
            rel = (diff.norm() / ref.float().norm()).item()
            errs[key].append(diff.abs().max().item())
            tol = rel_tol if key == "decode" else DECODE_Q8_REL_TOL["torch.bfloat16"]
            log(f"  valid {valid}: tree ({RING_SIZE} {label} partials, merged) vs one fused "
                f"{label}: max|diff| {diff.abs().max().item():.3e}, ||diff|| / ||fused|| "
                f"{rel:.3e} (tol {tol})")
            check(bool(torch.isfinite(got.float()).all()) and rel <= tol,
                  f"tree decode ({label}, valid {valid}) disagrees with the fused launch")
        if valid < n // RING_SIZE:  # every key on rank 0: the plain decode of the prefix
            ref, _ = cf.flash_decode_reference(q, k[:, :, :valid], v[:, :, :valid])
            err = (tree.float() - ref.float()).abs().max().item()
            log(f"  valid {valid}: tree vs the plain decode of the {valid} valid keys alone: "
                f"max|diff| {err:.3e} (tol {OUT_TOL['torch.bfloat16'][0]})")
            check(err <= OUT_TOL["torch.bfloat16"][0], "empty-rank tree decode is wrong")
    return {"launches": launches, "q": q, "k": k, "v": v, "kv8": kv8, "k_shards": k_shards,
            "v_shards": v_shards, "kv8_shards": kv8_shards, "decode_err": max(errs["decode"]), "decode_q8_err": max(errs["decode_q8"])}


def phase_mesh_serving() -> dict:
    """Phase 3j: the serving path on a virtual ring of 4: prefill (the ring
    over the prompt), decode (tree attention over the ring-sharded cache)
    and generate, plain and with ``quantize_cache=True``; the f32 models
    held to the local model's."""
    import torch

    from ring_attention_tpu_torch.parallel import create_mesh

    depth, steps = BENCH_MODEL["depth"], SERVE_NEW
    log(f"phase 3j: RingTransformer(mesh=create_mesh(ring_size={RING_SIZE})) serving, bench "
        f"model at full width: generate 4 x ({SERVE_PROMPT} prompt + {steps} new), cache "
        f"{SERVE_MAX_LEN}, plain, quantize_cache=True and impl='fused'")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)
    prompts = torch.randint(0, BENCH_MODEL["num_tokens"], (4, SERVE_PROMPT), generator=gen,
                            device="cuda")
    seed, resume, fused_carry, *_ = (x * depth for x in RING_SCHEDULE[False])
    launches = {name: 0 for name in COUNTERS}
    models, tokens = {}, {}
    for label, kw in (("plain", {}), ("quantize_cache=True", dict(quantize_cache=True)),
                      ("impl='fused'", dict(impl="fused"))):
        model = _model(torch.bfloat16, "cuda", mesh=create_mesh(ring_size=RING_SIZE), **kw)
        decode = "flash_decode_q8" if kw.get("quantize_cache") else "flash_decode"
        # the prompt runs the scan ring's modes, or with impl="fused" the
        # remote tier once per layer
        prefill = (dict(flash_ring_remote=depth) if kw.get("impl") == "fused" else
                   dict(flash_fwd=seed + resume + fused_carry, seed=seed, resume=resume,
                        fused_carry=fused_carry))
        expected = _counts(**prefill, **{decode: RING_SIZE * depth * (steps - 1)})
        with torch.inference_mode():
            _reset_counts()
            start = time.perf_counter()
            new = model.generate(prompts, max_len=SERVE_MAX_LEN, num_steps=steps)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
            counts = _read_counts()
        log(f"  {label}: generate {seconds:.3f} s (first call), launches {counts}")
        check(counts == expected, f"mesh generate ({label}) launched {counts}, expected "
              f"{expected}")
        check(tuple(new.shape) == (4, steps) and bool(((new >= 0) & (new < 256)).all()),
              f"mesh generate ({label}): ids {tuple(new.shape)} out of range")
        for name, c in counts.items():
            launches[name] += c
        models[label], tokens[label] = model, new
    # the remote tier's prefill is the hop chain's bit for bit, so the
    # greedy tokens are the same
    same = bool(torch.equal(tokens["impl='fused'"], tokens["plain"]))
    log(f"  impl='fused' greedy tokens equal the scan ring model's: {same}")
    check(same, "the fused ring model's generate differs from the scan ring model's")
    _hold_f32_mesh_serving(prompts)
    return {"launches": launches, "models": models, "prompts": prompts}


def _hold_f32_mesh_serving(prompts) -> None:
    """The float32 model on the ring of 4 against the float32 local model,
    both on the card: greedy tokens equal, and the logits of the prefill
    and of each teacher-forced decode step (plain: MODEL_ATOL; with
    ``quantize_cache``, norm-relative Q8_MODEL_REL_TOL: a last-bit
    difference may move an int8 cache entry by one step)."""
    import torch

    from ring_attention_tpu_torch.parallel import create_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for quantized in (False, True):
        mesh_model = _model(None, "cuda", mesh=create_mesh(ring_size=RING_SIZE),
                            quantize_cache=quantized)
        local = _model(None, "cuda", quantize_cache=quantized)
        with torch.inference_mode():
            want = local.generate(prompts, max_len=SERVE_MAX_LEN, num_steps=SERVE_NEW)
            got = mesh_model.generate(prompts, max_len=SERVE_MAX_LEN, num_steps=SERVE_NEW)
            caches = [m.init_cache(4, SERVE_MAX_LEN) for m in (mesh_model, local)]
            logits = [m.prefill(prompts, c)[0] for m, c in zip((mesh_model, local), caches)]
            errs, rels = [], []
            for i in range(SERVE_NEW):
                diff = logits[0] - logits[1]
                errs.append(diff.abs().max().item())
                rels.append((diff.norm() / logits[1].norm()).item())
                if i == SERVE_NEW - 1:
                    break
                pos = SERVE_PROMPT + i
                logits = [m.decode_step(want[:, i], c, pos)[0]
                          for m, c in zip((mesh_model, local), caches)]
        same = bool(torch.equal(got, want))
        label = "quantize_cache=True" if quantized else "plain"
        log(f"  f32 {label} on the ring vs local, 4 x ({SERVE_PROMPT} + {SERVE_NEW}): greedy "
            f"tokens equal {same}; prefill and {SERVE_NEW - 1} teacher-forced steps: logits "
            f"max|diff| {max(errs):.3e}, largest ||diff|| / ||local|| {max(rels):.3e} (tol "
            f"{'rel ' + str(Q8_MODEL_REL_TOL) if quantized else MODEL_ATOL})")
        ok = max(rels) <= Q8_MODEL_REL_TOL if quantized else max(errs) <= MODEL_ATOL
        check(ok and (same or quantized), f"f32 {label} ring serving disagrees with local")
        del mesh_model, local, caches


def phase_mesh_timings(zigzag: dict, ring: dict, serving: dict, training: dict,
                       tree: dict, mesh_serving: dict) -> None:
    """Phase 4g: the zig-zag model beside the scan ring models, config 3
    beside cuda_flash_attention, config 5's tree decode beside one fused
    B5 launch, and the decode step on the ring beside the local one."""
    import torch

    from ring_attention_tpu_torch.ops import cuda_flash as cf
    from ring_attention_tpu_torch.ops import cuda_flash_q8 as q8
    from ring_attention_tpu_torch.ops.cuda_flash import cuda_flash_attention
    from ring_attention_tpu_torch.parallel import (
        VirtualRing,
        tree_attn_decode,
        zigzag_attention,
        zigzag_permute,
    )

    log("phase 4g: zig-zag and decoding on a mesh (CUDA events, median after warm-up)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    log(f"  card: {smi.stdout.strip()}")
    tokens = serving["tokens"]
    models = {"contiguous ring": ring["models"]["contiguous"],
              "striped ring": ring["models"]["striped"],
              "zigzag": (zigzag["model"], zigzag["step"])}
    times: dict[str, dict[str, list[float]]] = {name: {"fwd": [], "step": []} for name in models}
    order = list(models) + list(models)[::-1]  # in turns
    for name in order:
        model, step = models[name]
        model.eval()
        with torch.inference_mode():
            times[name]["fwd"].append(time_ms(lambda: model(tokens)))
        model.train()
        times[name]["step"].append(_train_step_timing(step, training["tokens"])[0])
    for name in models:
        fwd, stp = statistics.mean(times[name]["fwd"]), statistics.mean(times[name]["step"])
        log(f"  {name} model (ring of {RING_SIZE}, 1 x 65536): forward {fwd:.3f} ms "
            f"({65536 / fwd * 1e3:.0f} tokens/s), train step {stp:.3f} ms "
            f"({65536 / stp * 1e3:.0f} tokens/s); each the mean of two turns "
            f"{[round(x, 3) for x in times[name]['fwd']]} / "
            f"{[round(x, 3) for x in times[name]['step']]}")

    # config 3: zig-zag (forward, forward + backward) beside the one-sweep call
    n, rs = CONFIG3_SEQ, CONFIG3_RING
    gen = torch.Generator(device="cuda").manual_seed(SEED + 25)
    q, k, v, do = (_rand(gen, (1, 8, n, 64), torch.bfloat16) for _ in range(4))
    vring = VirtualRing(rs)
    qz, kz, vz, doz = (zigzag_permute(x, rs, axis=2) for x in (q, k, v, do))

    def zz(backward):
        leaves = [x.detach().requires_grad_(backward) for x in (qz, kz, vz)]
        out = zigzag_attention(*leaves, vring, impl="cuda")
        if backward:
            out.backward(doz)

    def one(backward):
        leaves = [x.detach().requires_grad_(backward) for x in (q, k, v)]
        out = cuda_flash_attention(*leaves, causal=True)
        if backward:
            out.backward(do)

    for backward in (False, True):
        with torch.inference_mode(not backward):
            t_one1 = time_ms(lambda: one(backward), iters=5)
            t_zz1 = time_ms(lambda: zz(backward), iters=5)
            t_zz2 = time_ms(lambda: zz(backward), iters=5)
            t_one2 = time_ms(lambda: one(backward), iters=5)
        what = "forward + backward" if backward else "forward"
        log(f"  config 3 {what}: zigzag_attention (ring of {rs}, 16 chunks) "
            f"{(t_zz1 + t_zz2) / 2:.3f} ms, cuda_flash_attention (one causal sweep) "
            f"{(t_one1 + t_one2) / 2:.3f} ms, in turns (one, zz, zz, one: "
            f"{t_one1:.3f}, {t_zz1:.3f}, {t_zz2:.3f}, {t_one2:.3f})")

    # config 5: the tree decode beside one fused launch over the whole cache
    q, k, v, kv8 = tree["q"], tree["k"], tree["v"], tree["kv8"]
    k_shards, v_shards, kv8_shards = tree["k_shards"], tree["v_shards"], tree["kv8_shards"]
    n = k.shape[2]
    mask = torch.ones((1, n), dtype=torch.bool, device="cuda")
    masks = list(mask.chunk(RING_SIZE, dim=1))
    vring = VirtualRing(RING_SIZE)
    calls = {
        "tree_attn_decode (B5 partials per rank, merged)":
            lambda: tree_attn_decode(q, k_shards, v_shards, masks, ring=vring, impl="cuda"),
        "the 4 B5 partials launches alone":
            lambda: [cf.cuda_flash_decode(q, *s, fused=False)
                     for s in zip(k_shards, v_shards, masks)],
        "one fused B5 launch over the whole cache":
            lambda: cf.cuda_flash_decode(q, k, v, mask),
        "tree_attn_decode, int8 cache (B6 partials per rank, merged)":
            lambda: tree_attn_decode(q, None, None, masks, ring=vring,
                                     kv_quantized=kv8_shards),
        "the 4 B6 partials launches alone":
            lambda: [q8.flash_decode_q8(q, s, m, fused=False)
                     for s, m in zip(kv8_shards, masks)],
        "one fused B6 launch over the whole int8 cache":
            lambda: q8.flash_decode_q8(q, kv8, mask),
    }
    b_ms, _ = bound_ms(4 * 64 * 8 * n, nbytes(q, k, v, mask), torch.bfloat16)
    for name, fn in calls.items():
        graph = _graph_ms(fn)
        sync = time_ms(fn, iters=20)
        log(f"  config 5, {name}: {graph:.4f} ms on the device (CUDA graph of 20), "
            f"{sync:.4f} ms a synchronized call; bf16 cache bound {b_ms:.4f} ms")

    # the model's decode step on the ring beside the local one, 4 requests at
    # ~32,768 cached tokens
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    long_prompts = torch.randint(0, BENCH_MODEL["num_tokens"], (4, 32768), generator=gen,
                                 device="cuda")
    max_len = 32768 + 64
    for label in ("plain", "quantize_cache=True"):
        model, quantized = mesh_serving["models"][label], label != "plain"
        mesh_ms = _decode_step_ms(model, long_prompts, max_len)
        local_ms = _decode_step_ms(serving["model"] if not quantized else
                                   _model(torch.bfloat16, "cuda", quantize_cache=True),
                                   long_prompts, max_len)
        log(f"  decode step, 4 requests at ~32768-32780 cached tokens ({label}): on the ring "
            f"of {RING_SIZE} {mesh_ms:.3f} ms/step, local {local_ms:.3f} ms/step")


# ---------------------------------------------------------------------------
# Declared packings: B1, B2 and B3 with doc tables, B7 with ids (phases 2i,
# 3k, 4h)
# ---------------------------------------------------------------------------

# Phases 2i, 3k and 4h declare phase 3f's packings (packed_ids) with each
# document's length rounded to a multiple of DOC_ALIGN tokens, at least one
# (the largest block of the port's passes: the bf16 dk/dv pass's 128 keys),
# so that every pass drops the tiles of other documents.
DOC_ALIGN = 128
# Phase 2i: name: (the KERNEL_CASES entry, the packing): "aligned" to
# DOC_ALIGN (every pass takes its doc-tile table), "64" (aligned to 64 with
# a start that 128 does not divide: the bf16 dk/dv pass takes runtime ids,
# the other passes their tables), "misaligned" (phase 2g's documents: every
# pass takes runtime ids).
DOC_CASES = {
    "aligned causal (1,8,4096,64)": ("causal (1,8,4096,64)", "aligned"),
    "aligned window 1024": ("window 1024", "aligned"),
    "aligned softclamp 50": ("softclamp 50", "aligned"),
    "aligned GQA h32 hk4": ("GQA h32 hk4 (1,32,2048,64)", "aligned"),
    "64-aligned causal": ("causal (1,8,4096,64)", "64"),
    "misaligned causal": ("causal (1,8,4096,64)", "misaligned"),
}
# Phase 2i's fused ring cases with ids, every rank of a ring of 4 (n_local
# 1,024): name: (h, hk, striped, softclamp).
RING_ID_CASES = {
    "contiguous": (8, 8, False, None),
    "striped": (8, 8, True, None),
    "GQA h8 hk2 striped softclamp 50": (8, 2, True, 50.0),
}


def aligned_starts(n: int, len_range=PACK_LEN_RANGE, align: int = DOC_ALIGN) -> tuple:
    """Start offsets of ``packed_ids(n, len_range=...)``'s documents with
    each length rounded to a multiple of ``align`` (at least one); the last
    document ends at the row's end."""
    starts, pos = [], 0
    for length in doc_lengths(packed_ids(n, len_range=len_range)):
        if pos >= n:
            break
        starts.append(pos)
        pos += max(align, round(length / align) * align)
    return tuple(starts)


def _starts_of(ids) -> tuple:
    """The start offsets of a ``(1, n)`` packing's documents."""
    lengths = doc_lengths(ids)
    return tuple(int(sum(lengths[:i])) for i in range(len(lengths)))


def _doc_packing(kind: str, n: int) -> tuple:
    if kind == "aligned":
        return aligned_starts(n, SHORT_LEN_RANGE)
    if kind == "64":
        starts = aligned_starts(n, SHORT_LEN_RANGE, 64)
        check(any(s % 128 for s in starts), f"the 64-aligned packing {starts} aligns to 128")
        return starts
    return _starts_of(packed_ids(n, len_range=SHORT_LEN_RANGE))


def _doc_ids(starts, n, b=1):
    from ring_attention_tpu_torch.ops.attention import doc_runtime_ids

    return doc_runtime_ids(starts, n, b, "cuda")


def _ranges(ids, n_local):
    """Each ring rank's (min, max) id, as parallel/ring.py reads them: the
    queries' ranges and the one stream's kv ranges (the same)."""
    shards = ids[0].reshape(-1, n_local)
    q = list(zip(shards.min(1).values.tolist(), shards.max(1).values.tolist()))
    return q, [q]


def _id_tables(rank, n_local, ranges, striped=False, skip_docs=True):
    """The fused ring's tables of ``rank`` on the card, the hops whose ids
    share no document cleared as parallel/ring.py clears them (or, with
    ``skip_docs`` False, left as the JAX launch's tables leave them)."""
    from ring_attention_tpu_torch.parallel import ring as pring

    tables = pring._fused_tables(rank, RING_SIZE, n_local, True, striped, None, RING_SIZE,
                                 device="cuda", ranges=ranges if skip_docs else None)
    return dict(zip(("origins", "his", "los", "works"), tables))


def _doc_counts(kind: str, dtype) -> dict[str, int]:
    """The launches one forward and both backward passes of a phase-2i case
    make: each pass its doc-tile table where the packing aligns to its
    blocks, runtime ids where it does not."""
    import torch

    bf16 = dtype == torch.bfloat16
    docs = {"aligned": (1, 1, 1), "64": (1, 0 if bf16 else 1, 1),
            "misaligned": (0, 0, 0)}[kind]
    names = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
    counts = {name: 1 for name in names}
    for name, doc in zip(names, docs):
        counts[f"{'doc' if doc else 'seg'}_{name}"] = 1
    return _counts(**counts)


def phase_doc_tables_vs_plain() -> dict[str, float]:
    """B1 (every mode), B2 and B3 with a declared packing against their
    plain versions (the layout as runtime ids), bf16 and f32, on aligned,
    64-aligned and misaligned packings and a window; phase 3k's 65,536-token
    packing forward and backward in slices; then B7 with ids against its
    plain version and against the segmented B1 hop chain.  Returns the
    largest |kernel - plain| of each."""
    import torch

    from ring_attention_tpu_torch.ops import cuda_flash as cf
    from ring_attention_tpu_torch.ops import cuda_ring as cr
    from ring_attention_tpu_torch.parallel import VirtualRing, ring_flash_attention

    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    errors: dict[str, list[float]] = {m: [] for m in ("fused", "seed", "resume",
                                                      "fused_carry", "ring")}
    bwd_errors: dict[str, list[float]] = {}
    log(f"phase 2i: flash_fwd (every mode), flash_bwd_dkv and flash_bwd_dq with doc_starts "
        f"vs their plain versions (the layout as ids): documents log-uniform on "
        f"{SHORT_LEN_RANGE} tokens, rounded to {DOC_ALIGN} (or 64), or as drawn; then the "
        f"65,536-token packing of phase 3k in slices, then flash_ring with ids")
    for dtype in (torch.bfloat16, torch.float32):
        for name, (case, kind) in DOC_CASES.items():
            q, k, v, mask, kw = _case_inputs(gen, KERNEL_CASES[case], dtype)
            b, n = q.shape[0], q.shape[2]
            starts = _doc_packing(kind, n)
            ids = _doc_ids(starts, n, b)
            if dtype == torch.bfloat16:
                log(f"  {name}: starts {starts}")
            seg = dict(q_seg=ids, kv_seg=ids)
            _reset_counts()
            out, lse = cf.flash_fwd(q, k, v, mask, **kw, doc_starts=starts)
            do = _rand(gen, q.shape, dtype)
            delta = (do.float() * out.float()).sum(-1)
            dk, dv = cf.flash_bwd_dkv(do, q, k, v, lse, delta, mask, **kw, doc_starts=starts)
            dq = cf.flash_bwd_dq(do, q, k, v, lse, delta, mask, **kw, doc_starts=starts)
            torch.cuda.synchronize()
            counts = _read_counts()
            check(counts == _doc_counts(kind, dtype),
                  f"{name} {dtype}: launches {counts}, expected {_doc_counts(kind, dtype)}")
            ref_out, ref_lse = cf.flash_fwd_reference(q, k, v, mask, **kw, **seg)
            _compare(f"{name} docs", dtype, out, ref_out, lse, ref_lse, errors["fused"])
            ref = cf.flash_bwd_reference(do, q, k, v, lse, delta, mask, **kw, **seg)
            _compare_bwd(f"{name} docs", dtype, (dq, dk, dv), ref, bwd_errors)
            del ref

            # the ring modes with the table: the seed on this span, then two
            # more spans of keys in the same layout, resumed and fused from
            # the carry (the layout holds for any keys at those positions)
            hop = dict(kw, doc_starts=starts)
            spans = [(_rand(gen, k.shape, dtype), _rand(gen, k.shape, dtype)) for _ in range(2)]
            seed = cf.flash_partials(q, k, v, mask, **hop)
            torch.cuda.synchronize()
            ref_seed = cf.flash_partials_reference(q, k, v, mask, **kw, **seg)
            _compare_partials(f"{name} docs seed", dtype, seed, ref_seed, errors["seed"])
            (k2, v2), (k3, v3) = spans
            resumed = cf.flash_partials(q, k2, v2, carry=seed, **hop)
            carry = _clone(seed)
            cf.flash_partials(q, k2, v2, carry=carry, out=carry, **hop)
            torch.cuda.synchronize()
            ref_resumed = cf.flash_partials_reference(q, k2, v2, carry=ref_seed, **kw, **seg)
            for label, got in (("resume new tensors", resumed), ("resume in place", carry)):
                _compare_partials(f"{name} docs {label}", dtype, got, ref_resumed,
                                  errors["resume"])
            out, lse = cf.flash_fwd(q, k3, v3, carry=resumed, **hop)
            torch.cuda.synchronize()
            ref_out, ref_lse = cf.flash_fwd_reference(q, k3, v3, carry=ref_resumed, **kw,
                                                      **seg)
            _compare(f"{name} docs fused-carry", dtype, out, ref_out, lse, ref_lse,
                     errors["fused_carry"], rel_tol=RING_REL_TOL[str(dtype)])
            torch.cuda.synchronize()

    # phase 3k's launch: one 65,536-token causal sweep with its table and
    # its backward, in 1,024-row and 1,024-key slices as phase 2g
    n, w = 65536, 1024
    starts = aligned_starts(n)
    ids = _doc_ids(starts, n)
    q, k, v, do = (_rand(gen, (1, 8, n, 64), torch.bfloat16) for _ in range(4))
    kw = dict(scale=0.125, causal_offset=0, doc_starts=starts)
    out, lse = cf.flash_fwd(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1)
    dk, dv = cf.flash_bwd_dkv(do, q, k, v, lse, delta, **kw)
    dq = cf.flash_bwd_dq(do, q, k, v, lse, delta, **kw)
    torch.cuda.synchronize()
    for r0 in (0, n // 2, n - w):
        rows = slice(r0, r0 + w)
        sliced = dict(scale=0.125, causal_offset=r0, q_seg=ids[:, rows].contiguous(),
                      kv_seg=ids)
        ref_out, ref_lse = cf.flash_fwd_reference(q[:, :, rows].contiguous(), k, v, **sliced)
        _compare(f"docs causal 65536 rows {r0}+", torch.bfloat16, out[:, :, rows],
                 ref_out, lse[:, :, rows], ref_lse, errors["fused"])
        ref = cf.flash_bwd_reference(
            do[:, :, rows].contiguous(), q[:, :, rows].contiguous(), k, v,
            lse[:, :, rows].contiguous(), delta[:, :, rows].contiguous(), **sliced)
        _compare_bwd(f"docs causal 65536 dq rows {r0}+", torch.bfloat16,
                     (dq[:, :, rows], None, None), ref, bwd_errors)
        keys = slice(r0, r0 + w)
        ref = cf.flash_bwd_reference(
            do, q, k[:, :, keys].contiguous(), v[:, :, keys].contiguous(), lse, delta,
            scale=0.125, causal_offset=-r0, q_seg=ids, kv_seg=ids[:, keys].contiguous())
        _compare_bwd(f"docs causal 65536 dk/dv keys {r0}+", torch.bfloat16,
                     (None, dk[:, :, keys], dv[:, :, keys]), ref, bwd_errors)
        del ref
    del q, k, v, do, out, lse, delta, dk, dv, dq
    torch.cuda.empty_cache()

    # B7 with ids: every rank of a ring of 4 against its plain version, and
    # each whole ring against the impl="cuda" ring (the segmented B1 chain)
    n = 1024
    chain_errors = []
    for dtype in (torch.bfloat16, torch.float32):
        for name, (h, hk, striped, clamp) in RING_ID_CASES.items():
            q = _rand(gen, (1, h, RING_SIZE * n, 64), dtype)
            k, v = (_rand(gen, (1, hk, RING_SIZE * n, 64), dtype) for _ in range(2))
            ids = _doc_ids(_starts_of(packed_ids(RING_SIZE * n, 0, SHORT_LEN_RANGE)),
                           RING_SIZE * n)
            ranges = _ranges(ids, n)
            for rank in range(RING_SIZE):
                rows = slice(rank * n, (rank + 1) * n)
                kw = dict(n_local=n, scale=0.125, softclamp_value=clamp,
                          q_seg=ids[:, rows].contiguous(), kv_seg=ids,
                          **_id_tables(rank, n, ranges, striped))
                out, lse = cr.fused_ring_local(q[:, :, rows].contiguous(), k, v, **kw)
                torch.cuda.synchronize()
                ref_out, ref_lse = cr.fused_ring_local_plain(q[:, :, rows].contiguous(), k, v,
                                                             **kw)
                _compare(f"flash_ring ids {name} rank {rank}", dtype, out, ref_out, lse,
                         ref_lse, errors["ring"], rel_tol=RING_REL_TOL[str(dtype)])
            with torch.no_grad():
                ring = dict(causal=True, striped=striped, softclamp_value=clamp, scale=0.125,
                            segment_ids=ids)
                chain = ring_flash_attention(q, k, v, None, VirtualRing(RING_SIZE),
                                             impl="cuda", **ring)
                fused = ring_flash_attention(q, k, v, None, VirtualRing(RING_SIZE),
                                             impl="fused", **ring)
            torch.cuda.synchronize()
            chain_errors.append(_compare_to_chain(f"ids {name}, ring of 4", dtype, fused,
                                                  chain))

    # the fused mask model's launches (phase 3k): 4 x 16,384 of the aligned
    # 65,536-token packing, bf16 h8; every rank against the segmented B1
    # chain (the impl="cuda" ring's hops) bit for bit; then rank 3 with the
    # JAX launch's tables, whose doc-disjoint hops B7 visits (all scores
    # masked) where the chain skips them: the difference is printed, not held
    n = 16384
    ids = _doc_ids(aligned_starts(RING_SIZE * n), RING_SIZE * n)
    ranges = _ranges(ids, n)
    q = _rand(gen, (1, 8, RING_SIZE * n, 64), torch.bfloat16)
    k, v = (_rand(gen, q.shape, torch.bfloat16) for _ in range(2))
    with torch.no_grad():
        chain = ring_flash_attention(q, k, v, None, VirtualRing(RING_SIZE), causal=True,
                                     scale=0.125, impl="cuda", segment_ids=ids)
    for rank in range(RING_SIZE):
        rows = slice(rank * n, (rank + 1) * n)
        kw = dict(n_local=n, scale=0.125, q_seg=ids[:, rows].contiguous(), kv_seg=ids)
        out, _ = cr.fused_ring_local(q[:, :, rows].contiguous(), k, v,
                                     **_id_tables(rank, n, ranges), **kw)
        torch.cuda.synchronize()
        chain_errors.append(_compare_to_chain(f"ids 4 x {n} rank {rank}", torch.bfloat16,
                                              out, chain[:, :, rows]))
        if rank == RING_SIZE - 1:
            all_hops, _ = cr.fused_ring_local(q[:, :, rows].contiguous(), k, v,
                                              **_id_tables(rank, n, ranges, skip_docs=False),
                                              **kw)
            torch.cuda.synchronize()
            diff = (all_hops.float() - chain[:, :, rows].float()).abs().max().item()
            log(f"  rank {rank} with the doc-disjoint hops visited (JAX's tables, "
                f"{sum(_id_tables(rank, n, ranges, skip_docs=False)['works'].tolist())} hops "
                f"against {sum(_id_tables(rank, n, ranges)['works'].tolist())}): max|diff| from "
                f"the chain {diff:.3e}, bit-identical {bool(torch.equal(all_hops, chain[:, :, rows]))}")
    log(f"  largest |flash_ring with ids - segmented hop chain| over phase 2i: "
        f"{max(chain_errors):.3e}")
    del q, k, v, chain
    torch.cuda.empty_cache()
    result = {mode: max(errs) for mode, errs in errors.items()}
    result.update({label: max(errs) for label, errs in bwd_errors.items()})
    return result


def _doc_model_counts(backward: bool) -> dict[str, int]:
    """Launches of one forward (and backward) of the local model under a
    declared packing that aligns: each pass once per layer, each with its
    doc-tile table, none segmented."""
    depth = BENCH_MODEL["depth"]
    kw = dict(flash_fwd=depth, doc_flash_fwd=depth)
    if backward:
        kw.update(flash_bwd_dkv=depth, doc_flash_bwd_dkv=depth, flash_bwd_dq=depth,
                  doc_flash_bwd_dq=depth)
    return _counts(**kw)


def _fused_id_counts(skips: int, striped: bool, backward: bool) -> dict[str, int]:
    """Launches of one forward (and backward) of the fused ring model with
    ids: B7 with ids once per rank and layer (never B8), and the segmented
    backward kernels per hop with work, less the hops the ids skip."""
    depth = BENCH_MODEL["depth"]
    *_, dkv, dq = RING_SCHEDULE[striped]
    kw = dict(flash_ring=RING_SIZE * depth, seg_flash_ring=RING_SIZE * depth)
    if backward:
        kw.update(flash_bwd_dkv=(dkv - skips) * depth, seg_flash_bwd_dkv=(dkv - skips) * depth,
                  flash_bwd_dq=(dq - skips) * depth, seg_flash_bwd_dq=(dq - skips) * depth)
    return _counts(**kw)


def _hold_doc_f32() -> None:
    """The float32 model under ``mask=Causal() & DocumentMask((0, 128))`` at
    seq 256 on the card (its doc-tile tables) against the CPU (the layout
    as ids), logits and one step's gradients, locally and on the fused ring
    of 4 (B7 with ids)."""
    import torch

    from ring_attention_tpu_torch.masks import Causal, DocumentMask
    from ring_attention_tpu_torch.parallel import create_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED + 31)
    small = torch.randint(0, BENCH_MODEL["num_tokens"], (2, 257), generator=gen)
    mask = Causal() & DocumentMask((0, 128))
    for name, ring in (("local", {}),
                       ("fused ring", dict(mesh=create_mesh(ring_size=RING_SIZE), impl="fused"))):
        gpu = _model(None, "cuda", causal=False, mask=mask, **ring)
        cpu = copy.deepcopy(gpu).to("cpu")
        with torch.no_grad():
            logits_err = (gpu(small[:, :256].cuda()).cpu() - cpu(small[:, :256])).abs().max().item()
        losses = []
        for m, dev in ((gpu, "cuda"), (cpu, "cpu")):
            loss = m(small.to(dev), return_loss=True)
            loss.backward()
            losses.append(loss.item())
        grad_err = max(((pg.grad.cpu() - pc.grad).norm() / pc.grad.norm()).item()
                       for pg, pc in zip(gpu.parameters(), cpu.parameters()))
        log(f"  f32 mask model seq 256 ({name}), card vs CPU: logits max|diff| "
            f"{logits_err:.3e} (tol {MODEL_ATOL}), loss {losses[0]:.7f} vs {losses[1]:.7f}, "
            f"worst gradient ||card - cpu|| / ||cpu|| {grad_err:.3e} (tol {GRAD_REL_TOL})")
        check(logits_err <= MODEL_ATOL and grad_err <= GRAD_REL_TOL,
              f"f32 mask model ({name}) on the card disagrees with the CPU")


def phase_doc_mask_path(serving: dict, training: dict) -> dict:
    """Phase 3k: the bench model with ``mask=Causal() &
    DocumentMask(starts)`` (phase 3f's documents, lengths rounded to
    DOC_ALIGN) at full width, forward and train steps on its doc-tile
    tables, held to the same model with the layout as runtime ``segment_ids``
    (bit for bit expected: the dropped tiles' scores are all masked); the
    f32 copy against the CPU; the fused ring of 4 with ids (the mask's and
    ``segment_ids=``), held to the scan ring; then the packed forward and
    step with doc tables beside runtime ids and the unpacked row, in turns."""
    import torch

    from ring_attention_tpu_torch import make_train_step
    from ring_attention_tpu_torch.masks import Causal, DocumentMask
    from ring_attention_tpu_torch.parallel import create_mesh
    from ring_attention_tpu_torch.parallel import ring as pring

    tokens, step_tokens = serving["tokens"], training["tokens"]
    n = tokens.shape[1]
    starts = aligned_starts(n)
    ids = _doc_ids(starts, n)
    mask = Causal() & DocumentMask(starts)
    depth = BENCH_MODEL["depth"]
    log(f"phase 3k: RingTransformer(mask=Causal() & DocumentMask(starts)), bench model at "
        f"full width, bf16, 1 x {n} tokens in {len(starts)} documents of lengths "
        f"{doc_lengths(ids)} (phase 3f's rounded to {DOC_ALIGN})")
    launches = {name: 0 for name in COUNTERS}

    def add(counts):
        for name, x in counts.items():
            launches[name] += x

    model = _model(torch.bfloat16, "cuda", causal=False, mask=mask)
    with torch.inference_mode():
        _reset_counts()
        logits = model(tokens)
        torch.cuda.synchronize()
        counts = _read_counts()
        check(counts == _doc_model_counts(False),
              f"mask model forward launched {counts}, expected {_doc_model_counts(False)}")
        add(counts)
        ids_logits = serving["model"](tokens, segment_ids=ids)
    check(bool(torch.isfinite(logits.float()).all()) and tuple(logits.shape) == (1, n, 256),
          "mask model forward: logits")
    diff = logits.float() - ids_logits.float()
    rel = (diff.norm() / ids_logits.float().norm()).item()
    same = bool(torch.equal(logits, ids_logits))
    log(f"  forward: launches {counts}; logits vs the runtime-ids model (segment_ids, the "
        f"segmented kernels): max|diff| {diff.abs().max().item():.3e}, ||diff|| / ||ids|| "
        f"{rel:.3e} (tol rel {RING_LOGITS_REL_TOL}), bit-identical {same}")
    check(rel <= RING_LOGITS_REL_TOL, "mask model logits disagree with the runtime-ids model")
    del logits, ids_logits, diff

    model.train()
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    doc_step = make_train_step(lambda t: model(t, return_loss=True), opt)
    losses = []
    for i in range(2):
        _reset_counts()
        loss = float(doc_step(step_tokens))
        torch.cuda.synchronize()
        counts = _read_counts()
        check(counts == _doc_model_counts(True) and math.isfinite(loss),
              f"mask model step {i}: loss {loss}, launches {counts}")
        add(counts)
        losses.append(loss)
    log(f"  train steps: losses {[round(x, 6) for x in losses]}, launches {counts} a step")
    _hold_doc_f32()

    # the fused ring with ids: the mask's layout (contiguous) and segment_ids
    # (striped), each held to the scan ring model with the same weights
    for striped, declared in ((False, True), (True, False)):
        layout = "striped" if striped else "contiguous"
        kw = dict(mesh=create_mesh(ring_size=RING_SIZE), striped=striped)
        if declared:
            kw.update(causal=False, mask=mask)
        seg = None if declared else ids
        fused = _model(torch.bfloat16, "cuda", impl="fused", **kw)
        scan = _model(torch.bfloat16, "cuda", impl="cuda", **kw)
        skips = _expected_doc_skips(ids, striped)
        with torch.inference_mode():
            _reset_counts()
            pring.doc_skip_count = 0
            fused_logits = fused(tokens, segment_ids=seg)
            torch.cuda.synchronize()
            counts, skipped = _read_counts(), pring.doc_skip_count
            scan_logits = scan(tokens, segment_ids=seg)
        check(counts == _fused_id_counts(skips, striped, False) and skipped == skips * depth,
              f"{layout} fused forward with ids launched {counts}, {skipped} hops skipped; "
              f"expected {_fused_id_counts(skips, striped, False)}, {skips * depth} skipped")
        add(counts)
        same = bool(torch.equal(fused_logits, scan_logits))
        rel = ((fused_logits.float() - scan_logits.float()).norm()
               / scan_logits.float().norm()).item()
        log(f"  fused ring of {RING_SIZE}, {layout}, ids from "
            f"{'the mask' if declared else 'segment_ids='}: launches {counts}, {skips} of the "
            f"hops with band work skipped per layer; logits vs the scan ring model "
            f"||diff|| / ||scan|| {rel:.3e}, bit-identical {same}")
        check(same, f"{layout} fused ring with ids: logits differ from the scan ring's")
        del fused_logits, scan_logits, scan
        fused.train()
        opt = torch.optim.Adam(fused.parameters(), lr=1e-3)
        step = make_train_step(lambda t, m=fused, s=seg: m(
            t, return_loss=True,
            segment_ids=None if s is None else torch.cat([s, s[:, -1:]], dim=1)), opt)
        _reset_counts()
        pring.doc_skip_count = pring.doc_skip_bwd_count = 0
        loss = float(step(step_tokens))
        torch.cuda.synchronize()
        counts = _read_counts()
        check(counts == _fused_id_counts(skips, striped, True) and math.isfinite(loss),
              f"{layout} fused ring step with ids: loss {loss}, launches {counts}")
        add(counts)
        log(f"  fused ring of {RING_SIZE}, {layout}, train step: loss {loss:.6f}, launches "
            f"{counts}")
        del fused, step, opt

    log("  packed with doc tables vs runtime ids vs unpacked, the same tokens (CUDA events "
        "for the forward, host clock around synchronized steps; in turns: unpacked, docs, "
        "ids, ids, docs, unpacked)")
    plain = _model(torch.bfloat16, "cuda").train()
    opt = torch.optim.Adam(plain.parameters(), lr=1e-3)
    step_ids = torch.cat([ids, ids[:, -1:]], dim=1)
    runs = {"unpacked": (plain, None, make_train_step(
                lambda t: plain(t, return_loss=True), opt)),
            "docs": (model, None, doc_step),
            "ids": (plain, ids, make_train_step(
                lambda t: plain(t, return_loss=True, segment_ids=step_ids), opt))}
    fwd = {kind: [] for kind in runs}
    step_ms = {kind: [] for kind in runs}
    order = ("unpacked", "docs", "ids", "ids", "docs", "unpacked")
    for kind in order:
        m, seg, _ = runs[kind]
        m.eval()
        with torch.inference_mode():
            fwd[kind].append(time_ms(lambda: m(tokens, segment_ids=seg), iters=5))
        m.train()
    for kind in order:
        step_ms[kind].append(_train_step_timing(runs[kind][2], step_tokens)[0])
    timings = {kind: (statistics.mean(fwd[kind]), statistics.mean(step_ms[kind]))
               for kind in runs}
    uf, us = timings["unpacked"]
    for kind, (f, s) in timings.items():
        log(f"  local {kind}: forward 1 x {n} {f:.3f} ms ({f / uf:.3f} x unpacked; runs "
            f"{[round(x, 3) for x in fwd[kind]]}), train step {s:.3f} ms ({s / us:.3f} x; "
            f"runs {[round(x, 3) for x in step_ms[kind]]})")
    del runs, model, plain, opt, doc_step
    torch.cuda.empty_cache()
    return {"launches": launches, "timings": timings, "starts": starts}


def _seg_spans(k_all, v_all, kv_seg, tables, n):
    """The hops with work of one B7 launch with ids, in order: each one's
    contiguous (k, v, kv ids) block of the gathered span and its causal
    offset (None where its band covers the whole block)."""
    live = [(o, hi) for o, hi, w in zip(tables["origins"].tolist(), tables["his"].tolist(),
                                        tables["works"].tolist()) if w]
    return [tuple(x[..., o * n:(o + 1) * n, :].contiguous() for x in (k_all, v_all))
            + (kv_seg[:, o * n:(o + 1) * n].contiguous(), None if hi >= n - 1 else hi)
            for o, hi in live]


def _seg_chain(q, q_seg, spans):
    """The segmented B1 hop chain that one B7 launch with ids stands for
    (``spans`` from :func:`_seg_spans`): seed, resumes in place, the fused
    write from the carry."""
    from ring_attention_tpu_torch.ops import cuda_flash as cf

    carry = None
    for i, (k, v, kv_seg, hi) in enumerate(spans):
        kw = dict(scale=0.125, causal_offset=hi, q_seg=q_seg, kv_seg=kv_seg)
        if i == len(spans) - 1:
            return cf.flash_fwd(q, k, v, carry=carry, **kw)
        carry = cf.flash_partials(q, k, v, carry=carry, out=carry, **kw)


def _doc_ring_row(n: int, launches: int) -> dict:
    """B7 with ids on ring rank 3's schedule of a contiguous causal ring of 4
    (n_local ``n``; phase 3k's aligned packing over the 4n tokens) beside
    the unsegmented B7 on the same spans, the segmented B1 chain (in turns:
    unsegmented, ids, chain, chain, ids, unsegmented), its bound (the
    same-document in-band pairs of its live hops), its plain version and
    SDPA with the dense mask of the same pairs over the gathered span."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ring_attention_tpu_torch.ops import cuda_ring as cr

    gen = torch.Generator(device="cuda").manual_seed(SEED + 32)
    starts = aligned_starts(RING_SIZE * n)
    ids = _doc_ids(starts, RING_SIZE * n)
    rank = RING_SIZE - 1
    rows = slice(rank * n, (rank + 1) * n)
    q = _rand(gen, (1, 8, n, 64), torch.bfloat16)
    k_all, v_all = (_rand(gen, (1, 8, RING_SIZE * n, 64), torch.bfloat16) for _ in range(2))
    q_seg = ids[:, rows].contiguous()
    tables = _id_tables(rank, n, _ranges(ids, n))
    plain_tables = _fused_tables(rank, n, causal=True)
    # same-document causal pairs of this rank's rows (every key at or before
    # each row is in a hop with work)
    ends = list(starts[1:]) + [RING_SIZE * n]
    pairs = 0
    for s, e in zip(starts, ends):
        r = np.arange(max(s, rank * n), min(e, (rank + 1) * n))
        pairs += int((r - s + 1).sum())
    ops = 4 * 64 * 8 * pairs
    moved = nbytes(q, k_all, v_all, q_seg, ids) + nbytes(q) + 4 * 8 * n
    b_ms, b_by = bound_ms(ops, moved, torch.bfloat16)

    def with_ids():
        return cr.fused_ring_local(q, k_all, v_all, n_local=n, scale=0.125, q_seg=q_seg,
                                   kv_seg=ids, **tables)

    def without():
        return cr.fused_ring_local(q, k_all, v_all, n_local=n, scale=0.125, **plain_tables)

    spans = _seg_spans(k_all, v_all, ids, tables, n)

    def chain():
        return _seg_chain(q, q_seg, spans)

    same = bool(torch.equal(with_ids()[0], chain()[0]))
    times = {"without": [], "ids": [], "chain": []}
    for kind in ("without", "ids", "chain", "chain", "ids", "without"):
        times[kind].append(time_ms({"without": without, "ids": with_ids, "chain": chain}[kind]))
    ms, without_ms, chain_ms = (statistics.mean(times[k]) for k in ("ids", "without", "chain"))
    keep = (ids[0, rows][:, None] == ids[0][None, :]) & (
        torch.arange(RING_SIZE * n, device="cuda")[None, :]
        <= torch.arange(rank * n, (rank + 1) * n, device="cuda")[:, None])
    qg, kg, vg = q, k_all, v_all
    library_ms = _sdpa_masked(lambda: F.scaled_dot_product_attention(
        qg, kg, vg, attn_mask=keep, scale=0.125))
    del keep
    torch.cuda.empty_cache()
    plain_ms = time_ms(lambda: cr.fused_ring_local_plain(
        q, k_all, v_all, n_local=n, scale=0.125, q_seg=q_seg, kv_seg=ids, **tables), iters=2)
    live = sum(tables["works"].tolist())
    log(f"  flash_ring with ids, rank 3 of a contiguous causal ring of 4, 4 x {n} "
        f"({len(starts)} documents, {live} of 4 hops with work): kernel {ms:.3f} ms (runs "
        f"{[round(x, 3) for x in times['ids']]}), bound {b_ms:.3f} ms ({b_by}, same-document "
        f"pairs), {ops / ms / 1e9:.1f} TFLOP/s; without ids on the same spans (every causal "
        f"tile of the 4 hops) {without_ms:.3f} ms; the segmented flash_fwd chain {chain_ms:.3f} "
        f"ms (output bit-identical {same}); plain {plain_ms:.3f} ms; SDPA with the dense mask "
        f"over the gathered span {library_ms} ms")
    check(same, "flash_ring with ids differs from the segmented chain")
    return {"shape": f"ids, rank 3 of contiguous causal ring 4, 4 x (1,8,{n},64) bf16, "
                     f"{len(starts)} documents", "launches": launches, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms, "unsegmented_kernel_ms": without_ms,
            "hop_chain_ms": chain_ms}


def phase_doc_timings(doc: dict) -> dict[str, list[dict]]:
    """Phase 4h: B1, B2 and B3 with doc tables on aligned packings of causal
    (1, 8, n, 64) bf16 at 4,096 (with the plain versions) and 65,536 beside
    their bound (same-document in-band pairs), the segmented kernels on the
    same packing as runtime ids (in turns: ids, docs, docs, ids) and SDPA
    with the packing's dense mask; then B7 with ids at n_local 16,384.
    Returns each kernel's rows, each carrying phase 3k's launches."""
    import torch
    import torch.nn.functional as F

    from ring_attention_tpu_torch.ops import cuda_flash as cf

    log("phase 4h: doc tables and B7's ids (CUDA events)")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 33)
    rows: dict[str, list[dict]] = {"flash_fwd": [], "flash_bwd_dkv": [], "flash_bwd_dq": []}
    launches = doc["launches"]
    for n in (4096, 65536):
        len_range = SHORT_LEN_RANGE if n == 4096 else PACK_LEN_RANGE
        starts = aligned_starts(n, len_range)
        ids = _doc_ids(starts, n)
        q, k, v, do = (_rand(gen, (1, 8, n, 64), torch.bfloat16) for _ in range(4))
        docs = dict(scale=0.125, causal_offset=0, doc_starts=starts)
        seg = dict(scale=0.125, causal_offset=0, q_seg=ids, kv_seg=ids)
        out, lse = cf.flash_fwd(q, k, v, **docs)
        delta = (do.float() * out.float()).sum(-1)
        pairs = 8 * same_doc_pairs(ids)
        shape = (f"docs causal (1,8,{n},64) bf16, {len(starts)} documents (lengths "
                 f"log-uniform on {len_range}, rounded to {DOC_ALIGN})")
        mask = _sdpa_packed_mask(ids)
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)

        fwd_lib = _sdpa_masked(sdpa)
        bwd_lib = None
        if fwd_lib is not None:
            try:
                ref = sdpa()
                bwd_lib = _sdpa_masked(lambda: torch.autograd.grad(
                    ref, (qg, kg, vg), do, retain_graph=True))
                del ref
            except torch.cuda.OutOfMemoryError:
                torch.cuda.empty_cache()
        del mask
        with_plain = n == 4096
        args = (do, q, k, v, lse, delta)
        bwd_plain = (time_ms(lambda: cf.flash_bwd_reference(*args, **seg), iters=3)
                     if with_plain else None)
        f32_grad = 4 * n * 64 * 8
        for name, fn, products, moved, plain, library in (
            ("flash_fwd", cf.flash_fwd, 2, nbytes(q, k, v, out, lse),
             (time_ms(lambda: cf.flash_fwd_reference(q, k, v, **seg), iters=3)
              if with_plain else None), fwd_lib),
            ("flash_bwd_dkv", cf.flash_bwd_dkv, 4, nbytes(*args) + 2 * f32_grad, bwd_plain,
             bwd_lib),
            ("flash_bwd_dq", cf.flash_bwd_dq, 3, nbytes(*args) + f32_grad, bwd_plain, bwd_lib),
        ):
            inputs = (q, k, v) if name == "flash_fwd" else args
            ops = 2 * products * 64 * pairs
            b_ms, b_by = bound_ms(ops, moved, torch.bfloat16)
            iters = 10 if n < 65536 else 5
            times = {"ids": [], "docs": []}
            for kind in ("ids", "docs", "docs", "ids"):
                kw = docs if kind == "docs" else seg
                times[kind].append(time_ms(lambda: fn(*inputs, **kw), iters=iters))
            ms, ids_ms = statistics.mean(times["docs"]), statistics.mean(times["ids"])
            rows[name].append({"shape": shape, "launches": launches[f"doc_{name}"], "ms": ms,
                               "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                               "library_ms": library, "ids_kernel_ms": ids_ms})
            log(f"  {name} {shape}: doc tables {ms:.4f} ms (runs "
                f"{[round(x, 4) for x in times['docs']]}), the same layout as runtime ids "
                f"{ids_ms:.4f} ms (runs {[round(x, 4) for x in times['ids']]}), ids / docs "
                f"{ids_ms / ms:.3f}; bound {b_ms:.4f} ms ({b_by}, same-document pairs), "
                f"plain {plain} ms{' (all three gradients)' if plain and name != 'flash_fwd' else ''}, "
                f"sdpa with the dense mask{' backward' if name != 'flash_fwd' else ''} "
                f"{library} ms, {ops / ms / 1e9:.1f} TFLOP/s")
        del q, k, v, do, out, lse, delta, qg, kg, vg
        torch.cuda.empty_cache()
    for kind, (f, s) in doc["timings"].items():
        log(f"  local model {kind}: forward {f:.3f} ms, train step {s:.3f} ms (phase 3k)")
    ring_row = _doc_ring_row(16384, launches["seg_flash_ring"])
    return {**rows, "flash_ring": [ring_row]}


# ---------------------------------------------------------------------------
# The int8 ring: B4's ids, doc tables and pre-quantized feed (K3c, K4), B7's
# int8 feed and B8's int8 wire; hop_compression="int8" on the model
# ---------------------------------------------------------------------------

# Phase 2j: B4 with packed sequences on 4,096 (and 2,048) rows, every mode;
# the misaligned packing is phase 2g's (boundaries inside tiles, a tail of
# PAD_SEGMENT_ID), the aligned one starts every document on a 128-row block
# (B4's kDocs instantiation takes it; runtime ids the misaligned one).
Q8_SEG_CASES = ("causal (1,8,4096,64)", "window 1024", "softclamp 50",
                "kv_mask, one all-False row", "GQA h32 hk4 (1,32,2048,64)")
# Phase 2j and 4i: B7's and B8's int8 schedules, the whole ring of 4 at
# these shard lengths (the timings' 262,144 is rank 3's schedule alone for
# B7, and the whole ring for B8).
INT8_RING_N = 4096
INT8_TIMING_N = (16384, 262144)


def _q8_packed_modes(name, dtype, q, k, v, kw, carry, packing, ids, errors, counter) -> None:
    """B4 with a packing (``packing``: ids or ``doc_starts``) in every mode
    against its plain version with the same layout as ids: fused, seed,
    resume into new tensors and in place (bit-equal), fused from a carry;
    each launch counted once by ``counter`` of ``cuda_flash_q8``."""
    import torch

    from ring_attention_tpu_torch.ops import cuda_flash_q8 as q8

    ref_kw = dict(kw, q_seg=ids, kv_seg=ids)
    before = getattr(q8, counter)
    out, lse = q8.flash_fwd_q8(q, k, v, **packing, **kw)
    torch.cuda.synchronize()
    ref_out, ref_lse = q8.flash_fwd_q8_reference(q, k, v, **ref_kw)
    _compare_q8(f"{name} fused", dtype, out, ref_out, lse, ref_lse, errors)
    got = q8.flash_partials_q8(q, k, v, **packing, **kw)
    torch.cuda.synchronize()
    _compare_q8_partials(f"{name} seed", dtype, got,
                         q8.flash_partials_q8_reference(q, k, v, **ref_kw), errors)
    kept = _clone(carry)
    got = q8.flash_partials_q8(q, k, v, carry=carry, **packing, **kw)
    torch.cuda.synchronize()
    _compare_q8_partials(f"{name} resume", dtype, got,
                         q8.flash_partials_q8_reference(q, k, v, carry=carry, **ref_kw), errors)
    q8.flash_partials_q8(q, k, v, carry=kept, out=kept, **packing, **kw)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(kept, got)),
          f"{name} {dtype}: the in-place resume differs from the resume")
    out, lse = q8.flash_fwd_q8(q, k, v, carry=carry, **packing, **kw)
    torch.cuda.synchronize()
    ref_out, ref_lse = q8.flash_fwd_q8_reference(q, k, v, carry=carry, **ref_kw)
    _compare_q8(f"{name} fused+carry", dtype, out, ref_out, lse, ref_lse, errors)
    check(getattr(q8, counter) - before == 5, f"{name}: {counter} counted "
          f"{getattr(q8, counter) - before} of 5 launches")


def _ring_shards(gen, n_local, dtype=None, h=8, hk=8):
    import torch

    dtype = dtype or torch.bfloat16
    n = RING_SIZE * n_local
    return (_rand(gen, (1, h, n, 64), dtype), _rand(gen, (1, hk, n, 64), dtype),
            _rand(gen, (1, hk, n, 64), dtype))


def _remote_q8_feeds(ks, vs, n_local):
    """Each rank's K/V as the int8 wire carries it to B8: its
    ``pack_kv(v_block=n_local)`` payload read as the feed (JAX ring.py:719)."""
    from ring_attention_tpu_torch.ops import cuda_flash_q8 as q8
    from ring_attention_tpu_torch.ops import quant

    return [q8.kernel_kv(quant.payload_kernel_feed(quant.pack_kv(k, v, v_block=n_local),
                                                   n_local)) for k, v in zip(ks, vs)]


def _q8_remote_stress(gen) -> None:
    """B8's int8 kernel: 50 launches of the causal ring of 4 with each block
    split, every one bit for bit the first launch."""
    import torch

    from ring_attention_tpu_torch.ops import cuda_ring_remote as crr

    n = 1024
    qs, ks, vs = _remote_inputs(gen, RING_SIZE, 1, 8, 8, n, torch.bfloat16)
    feeds = _remote_q8_feeds(ks, vs, n)
    kw = dict(tables=_remote_tables(RING_SIZE, n, causal=True), n_local=n, scale=0.125,
              compute_dtype="int8", kv_quantized=feeds)
    capacity = crr._capacity(torch.cuda.current_device(), True, False, True)
    split = crr.balanced_split(kw["tables"], n, 8,
                               crr._grid_blocks(capacity, RING_SIZE, 8, n, True))
    first_outs, first_lses = crr.fused_ring_remote(qs, None, None, **kw)
    first = first_outs + first_lses
    for label, cta_split in (("balanced", split), ("rank 0 on one block", [1] + split[1:]),
                             ("rank 3 on one block", split[:3] + [1])):
        same = 0
        for _ in range(STRESS_LAUNCHES):
            outs, lses = crr.fused_ring_remote(qs, None, None, **kw, cta_split=cta_split)
            same += all(bool(torch.equal(a, b)) for a, b in zip(outs + lses, first))
        log(f"  int8 stress, causal ring of 4 x {n}, blocks {cta_split} ({label}): {same} of "
            f"{STRESS_LAUNCHES} launches bit-identical to the first")
        check(same == STRESS_LAUNCHES, f"int8 stress ({label}): a launch differed")
    too_big = split[:3] + [capacity + 1 - sum(split[:3])]
    message = _raises(lambda: crr.fused_ring_remote(qs, None, None, **kw, cta_split=too_big),
                      ValueError)
    check(message is not None and "does not fit" in message,
          "an int8 grid the card cannot hold at once did not raise")


def phase_int8_ring_vs_plain() -> dict:
    """Phase 2j: B4's segmented and doc-table instantiations in every mode,
    its direct feed against its own quantization, B7's int8 instantiations
    and B8's int8 kernel against their plain versions and, bit for bit, the
    B4 hop chain fed the same feed; returns the largest |out - plain| by
    instantiation."""
    import torch

    from ring_attention_tpu_torch.ops import cuda_flash as cf
    from ring_attention_tpu_torch.ops import cuda_flash_q8 as q8
    from ring_attention_tpu_torch.ops import cuda_ring as cr
    from ring_attention_tpu_torch.ops import cuda_ring_remote as crr
    from ring_attention_tpu_torch.ops.attention import doc_runtime_ids
    from ring_attention_tpu_torch.parallel import VirtualRing, ring_flash_attention

    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    errors = {key: [] for key in ("seg", "docs", "feed", "ring_q8", "ring_q8_seg",
                                  "remote_q8")}
    log("phase 2j: the int8 ring's kernels vs their plain versions: flash_fwd_q8 with ids "
        "(kSeg) and doc tables (kDocs) in every mode, fed a pre-quantized K/V; "
        "flash_ring's int8 instantiations; flash_ring_remote's int8 wire")
    for name in Q8_SEG_CASES:
        case = KERNEL_CASES[name]
        b, n = case[0], case[3]
        for dtype in (torch.bfloat16, torch.float32) if name == Q8_SEG_CASES[0] else (
                torch.bfloat16,):
            q, k, v, mask, kw = _case_inputs(gen, case, dtype)
            kw = dict(kw, block_k=1024)
            carry = cf.flash_partials_reference(
                q, _rand(gen, k.shape, dtype), _rand(gen, v.shape, dtype), scale=0.125)
            ids = packed_ids(n, PACK_PAD_TAIL, SHORT_LEN_RANGE).expand(b, n).contiguous()
            _q8_packed_modes(f"kSeg {name}", dtype, q, k, v, dict(kw, kv_mask=mask), carry,
                             dict(q_seg=ids, kv_seg=ids), ids, errors["seg"],
                             "seg_launch_count")
            if kw["causal_offset"] is not None and mask is None:
                starts = _doc_packing("aligned", n)
                dids = doc_runtime_ids(starts, n, b, "cuda")
                _q8_packed_modes(f"kDocs {name} ({len(starts)} docs)", dtype, q, k, v, kw,
                                 carry, dict(doc_starts=starts), dids, errors["docs"],
                                 "doc_launch_count")
            del carry

    # the direct feed: K/V quantized once, read by every mode, bit for bit
    # the launches that quantize them in the wrapper
    q, k, v = (_rand(gen, (1, 8, 4096, 64), torch.bfloat16) for _ in range(3))
    kw = dict(scale=0.125, causal_offset=0, block_k=1024)
    feed = q8.quantize_kv_feed(k, v, 1024)
    before = q8.feed_launch_count
    fused = (q8.flash_fwd_q8(q, k, v, **kw), q8.flash_fwd_q8(q, None, None, kv_quantized=feed,
                                                             **kw))
    parts = (q8.flash_partials_q8(q, k, v, **kw),
             q8.flash_partials_q8(q, None, None, kv_quantized=feed, **kw))
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(*fused)) and all(
        torch.equal(x, y) for x, y in zip(*parts))
    log(f"  direct feed (1,8,4096,64) causal, block 1024: fused and partials bit-identical to "
        f"the wrapper's own quantization {same}; feed launches {q8.feed_launch_count - before}")
    check(same and q8.feed_launch_count - before == 2, "the direct feed differs")
    errors["feed"].append(0.0)

    # B7 int8 and B8 int8 over a ring of 4 x INT8_RING_N: per rank against
    # the plain version, and whole rings bit for bit the scan ring fed the
    # same feed (B8: the v_block=n_local payload, the chain's bucket n_local)
    n_local = INT8_RING_N
    Q, K, V = _ring_shards(gen, n_local)
    ids = packed_ids(RING_SIZE * n_local, PACK_PAD_TAIL, SHORT_LEN_RANGE)
    ring = VirtualRing(RING_SIZE)
    block = 1024
    feed_all = q8.quantize_kv_feed(K, V, block)
    qs = [x.contiguous() for x in Q.chunk(RING_SIZE, 2)]
    for striped in (False, True):
        tables = _remote_tables(RING_SIZE, n_local, causal=True, striped=striped)
        for seg in (None, ids):
            label = ("striped" if striped else "contiguous") + (" ids" if seg is not None
                                                                else "")
            key = "ring_q8" if seg is None else "ring_q8_seg"
            for rank in range(RING_SIZE):
                t = dict(zip(TABLE_NAMES, (x.cuda() for x in tables[rank])))
                sg = {} if seg is None else dict(
                    q_seg=seg[:, rank * n_local:(rank + 1) * n_local].contiguous(), kv_seg=seg)
                out, lse = cr.fused_ring_local(qs[rank], None, None, kv_quantized=feed_all,
                                               block_k=block, n_local=n_local, scale=0.125,
                                               **t, **sg)
                torch.cuda.synchronize()
                ref_out, ref_lse = cr.fused_ring_local_plain(
                    qs[rank], None, None, kv_quantized=feed_all, block_k=block,
                    n_local=n_local, scale=0.125, **t, **sg)
                _compare_q8(f"flash_ring int8 {label} rank {rank}", torch.bfloat16, out,
                            ref_out, lse, ref_lse, errors[key])
            # the whole ring, fused (a key mask of all True: the local tier)
            # against the scan ring, both fed per-stream feeds at the bucket
            mask = torch.ones((1, RING_SIZE * n_local), dtype=torch.bool, device="cuda")
            kw = dict(causal=True, striped=striped, bucket_size=block, compute_dtype="int8",
                      hop_compression="int8", segment_ids=seg)
            with torch.inference_mode():
                before = cr.q8_launch_count
                fused_out = ring_flash_attention(Q, K, V, mask, ring, impl="fused", **kw)
                launched = cr.q8_launch_count - before
                scan_out = ring_flash_attention(Q, K, V, mask, ring, impl="cuda", **kw)
            same = bool(torch.equal(fused_out, scan_out))
            log(f"  flash_ring int8 ring of 4 x {n_local} {label}: {launched} launches, "
                f"bit-identical to the int8 hop chain {same}")
            check(same and launched == RING_SIZE, f"flash_ring int8 {label}: differs from "
                  "the hop chain")
        # B8 int8: one launch for the ring, each rank's v_block=n_local feed
        qs_, ks_, vs_ = (list(x.chunk(RING_SIZE, 2)) for x in (Q, K, V))
        qs_, ks_, vs_ = ([x.contiguous() for x in xs] for xs in (qs_, ks_, vs_))
        feeds = _remote_q8_feeds(ks_, vs_, n_local)
        outs, lses = crr.fused_ring_remote(qs_, None, None, tables=tables, n_local=n_local,
                                           scale=0.125, compute_dtype="int8",
                                           kv_quantized=feeds)
        torch.cuda.synchronize()
        ref_outs, ref_lses = crr.fused_ring_remote_plain(
            qs_, None, None, tables=tables, n_local=n_local, scale=0.125, kv_quantized=feeds)
        layout = "striped" if striped else "contiguous"
        for rank in range(RING_SIZE):
            _compare_q8(f"flash_ring_remote int8 {layout} rank {rank}", torch.bfloat16,
                        outs[rank], ref_outs[rank], lses[rank], ref_lses[rank],
                        errors["remote_q8"])
        with torch.inference_mode():
            before = crr.q8_launch_count
            remote_out = ring_flash_attention(Q, K, V, None, ring, causal=True, striped=striped,
                                              bucket_size=block, impl="fused",
                                              compute_dtype="int8", hop_compression="int8")
            launched = crr.q8_launch_count - before
            chain_out = ring_flash_attention(Q, K, V, None, ring, causal=True, striped=striped,
                                             bucket_size=n_local, impl="cuda",
                                             compute_dtype="int8", hop_compression="int8")
        same = bool(torch.equal(remote_out, chain_out))
        log(f"  flash_ring_remote int8 ring of 4 x {n_local} {layout}: {launched} launch, "
            f"bit-identical to the int8 hop chain fed the v_block=n_local payload {same}")
        check(same and launched == 1, f"flash_ring_remote int8 {layout}: differs from the "
              "hop chain")
    _q8_remote_stress(gen)
    return {key: max(errs) for key, errs in errors.items()}


# Phase 3l's forms of the bench model on the virtual ring of 4, all with
# ring_hop_compression="int8": (impl, compute_dtype).
INT8_RING_FORMS = {"wire": ("cuda", None), "q8": ("cuda", "int8"), "fused": ("fused", "int8")}


def _int8_ring_model(form, dtype="bf16", **kw):
    """The bench model on the virtual ring of 4 in one of INT8_RING_FORMS
    (``dtype`` "bf16", or None: f32 parameters and compute)."""
    import torch

    from ring_attention_tpu_torch.parallel import create_mesh

    impl, compute = INT8_RING_FORMS[form]
    return _model(torch.bfloat16 if dtype == "bf16" else dtype, "cuda",
                  mesh=create_mesh(ring_size=RING_SIZE), impl=impl, compute_dtype=compute,
                  ring_hop_compression="int8", **kw)


def _hold_f32_int8_ring_to_cpu() -> None:
    """The f32 int8 ring models (seq 256, the scan ring and the fused ring)
    on the card against the same weights on the CPU (plain versions), with
    the CPU's own spread under last-bit weight noise beside it."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED + 31)
    tokens = torch.randint(0, BENCH_MODEL["num_tokens"], (2, 256), generator=gen)
    for form in ("q8", "fused"):
        gpu = _int8_ring_model(form, dtype=None, bucket_size=32)
        cpu = copy.deepcopy(gpu).to("cpu")
        with torch.inference_mode():
            ref = cpu(tokens)
            err = _rel_err(gpu(tokens.cuda()).cpu(), ref)
            noisy = copy.deepcopy(cpu)
            for w in noisy.parameters():
                w.mul_(1 + 1.2e-7 * torch.randn(w.shape, generator=gen))
            spread = _rel_err(noisy(tokens), ref)
        log(f"  f32 int8 ring model ({form}) seq 256, card vs CPU: ||card - cpu|| / ||cpu|| "
            f"{err:.3e} (tol {Q8_MODEL_REL_TOL}); on the CPU, weights x (1 + 1.2e-7 noise) "
            f"move it {spread:.3e}")
        check(err <= Q8_MODEL_REL_TOL, f"f32 int8 ring model ({form}) disagrees with the CPU")


def phase_int8_ring_path(serving: dict, training: dict) -> dict:
    """Phase 3l: the bench model at full width on the virtual ring of 4 with
    ``ring_hop_compression="int8"``, in its forms (the wire alone over the
    float kernels, the scan ring's B4 hops fed the payload, the fused ring's
    B8 on the int8 wire and B7 when a key mask pads the request), then the
    int8 model with ids and with ``mask=Causal() & DocumentMask(starts)``
    locally and on the ring: a forward and a train step each, exact launch
    counts, the K/V quantizations of a forward (one per rank and layer),
    logits against the bf16 local model."""
    import torch

    from ring_attention_tpu_torch import make_train_step
    from ring_attention_tpu_torch.masks import Causal, DocumentMask
    from ring_attention_tpu_torch.ops import quant

    depth = BENCH_MODEL["depth"]
    tokens, step_tokens = serving["tokens"], training["tokens"]
    n = tokens.shape[1]
    log('phase 3l: the int8 ring, RingTransformer(ring_hop_compression="int8") on a virtual '
        f"ring of {RING_SIZE}, bench model at full width, bf16, 1 x {n} tokens")
    launches = {name: 0 for name in COUNTERS}
    with torch.inference_mode():
        ref = serving["model"](tokens).float()

    def run(label, fn, expect=None, quantizations=None):
        _reset_counts()
        quant.kv_quantize_count = 0
        start = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        counts, quantized = _read_counts(), quant.kv_quantize_count
        log(f"  {label}: {seconds:.3f} s, launches {({k: x for k, x in counts.items() if x})}, "
            f"K/V quantizations {quantized}")
        if expect is not None:
            check(counts == expect, f"{label} launched {counts}, expected {expect}")
        if quantizations is not None:
            check(quantized == quantizations,
                  f"{label}: {quantized} K/V quantizations, expected {quantizations}")
        for name, x in counts.items():
            launches[name] += x
        return result, counts

    hops = RING_SIZE * depth  # one quantization per rank and layer
    seed, resume, fused_c, dkv, dq = (x * depth for x in RING_SCHEDULE[False])
    expect_fwd = {
        "wire": _ring_counts(False, backward=False),
        "q8": _counts(flash_fwd_q8=seed + resume + fused_c, q8_seed=seed, q8_resume=resume,
                      q8_fused_carry=fused_c, feed_flash_fwd_q8=seed + resume + fused_c),
        "fused": _counts(flash_ring_remote=depth, q8_flash_ring_remote=depth),
    }
    models, results = {}, {}
    for form in INT8_RING_FORMS:
        model = _int8_ring_model(form)
        with torch.inference_mode():
            logits, _ = run(f"{form} forward 1 x {n}", lambda: model(tokens), expect_fwd[form],
                            hops)
        rel = _rel_err(logits, ref)
        log(f"    logits vs the bf16 local model: ||ring - local|| / ||local|| {rel:.3e} "
            f"(tol {Q8_FWD_REL_L2})")
        check(bool(torch.isfinite(logits.float()).all()) and rel <= Q8_FWD_REL_L2,
              f"{form}: int8 ring logits disagree with the bf16 model")
        results[form] = logits
        model.train()
        step = make_train_step(lambda t, m=model: m(t, return_loss=True),
                               torch.optim.Adam(model.parameters(), lr=1e-3))
        expect_step = dict(expect_fwd[form], flash_bwd_dkv=dkv, flash_bwd_dq=dq)
        (loss, _) = run(f"{form} train step", lambda s=step: s(step_tokens), expect_step, hops)
        loss = float(loss)
        log(f"    loss {loss:.6f}")
        check(math.isfinite(loss), f"{form}: loss {loss}")
        models[form] = (model.eval(), step)
    same = bool(torch.equal(results["q8"], results["fused"]))
    # the fused ring's remote tier is the chain fed v_block=n_local payloads
    chain = _int8_ring_model("q8", bucket_size=n // RING_SIZE)
    with torch.inference_mode():
        chain_logits = chain(tokens)
    del chain
    remote_same = bool(torch.equal(chain_logits, results["fused"]))
    log(f"  fused (B8 int8) logits bit-identical to the scan int8 ring fed the "
        f"v_block=n_local payload {remote_same}; to the scan ring at the bucket's block "
        f"{same} (one v scale per rank span vs per 2,048 keys)")
    check(remote_same, "the int8 remote tier's logits differ from the hop chain's")
    del chain_logits
    results = {}

    # a padded request: 65,535 tokens on a non-causal copy take B7 int8
    masked = _int8_ring_model("fused", causal=False)
    with torch.inference_mode():
        _, counts = run(f"fused non-causal forward 1 x {n - 1} (padded, masked)",
                        lambda: masked(tokens[:, :-1]),
                        _counts(flash_ring=hops, q8_flash_ring=hops), hops)
    del masked

    # packed documents: ids on the ring (B4 kSeg hop by hop, B7 int8 kSeg),
    # the declared packing locally (B4 kDocs) and on the ring (runtime ids)
    ids = packed_ids(n)
    starts = aligned_starts(n)
    fresh = {form: _int8_ring_model(form) for form in ("q8", "fused")}  # the seeded weights
    for form, model in fresh.items():
        with torch.inference_mode():
            logits, counts = run(f"{form} forward with segment_ids ({len(doc_lengths(ids))} "
                                 f"documents)", lambda m=model: m(tokens, segment_ids=ids),
                                 quantizations=hops)
        key = "seg_flash_fwd_q8" if form == "q8" else "seg_flash_ring"
        check(counts[key] > 0 and counts[key] == counts["flash_fwd_q8" if form == "q8"
                                                       else "q8_flash_ring"],
              f"{form} with ids: {counts}")
        results[form] = logits
    same = bool(torch.equal(results["q8"], results["fused"]))
    log(f"  fused int8 ring with ids (B7 int8 kSeg) bit-identical to the scan int8 ring "
        f"{same}")
    check(same, "the fused int8 ring with ids differs from the scan int8 ring")
    step_ids = torch.cat([ids, ids[:, -1:]], dim=1)
    model = fresh["q8"]
    model.train()
    seg_step = make_train_step(lambda t: model(t, return_loss=True, segment_ids=step_ids),
                               torch.optim.Adam(model.parameters(), lr=1e-3))
    loss, _ = run("q8 train step with segment_ids", lambda: seg_step(step_tokens),
                  quantizations=hops)
    check(math.isfinite(float(loss)), f"packed int8 step: loss {float(loss)}")
    model.eval()
    mask = Causal() & DocumentMask(starts)
    local = _model(torch.bfloat16, "cuda", causal=False, mask=mask, compute_dtype="int8")
    with torch.inference_mode():
        local_logits, counts = run(
            f"local int8 mask=Causal() & DocumentMask({len(starts)} documents)",
            lambda: local(tokens), _counts(flash_fwd_q8=depth, doc_flash_fwd_q8=depth))
        ring_mask = _int8_ring_model("q8", causal=False, mask=mask)
        ring_logits, counts = run("q8 ring with the same mask", lambda: ring_mask(tokens),
                                  quantizations=hops)
    check(counts["seg_flash_fwd_q8"] == counts["flash_fwd_q8"] > 0,
          f"the int8 ring's declared packing did not run as ids: {counts}")
    rel = _rel_err(ring_logits, local_logits)
    log(f"    the masked int8 ring vs the masked int8 local model: {rel:.3e} "
        f"(tol {Q8_FWD_REL_L2})")
    check(rel <= Q8_FWD_REL_L2, "the masked int8 ring disagrees with the local model")
    local.train()
    local_step = make_train_step(lambda t: local(t, return_loss=True),
                                 torch.optim.Adam(local.parameters(), lr=1e-3))
    loss, _ = run("local int8 mask train step", lambda: local_step(step_tokens),
                  _counts(flash_fwd_q8=depth, doc_flash_fwd_q8=depth, flash_bwd_dkv=depth,
                          flash_bwd_dq=depth, doc_flash_bwd_dkv=depth, doc_flash_bwd_dq=depth))
    check(math.isfinite(float(loss)), f"local int8 mask step: loss {float(loss)}")
    del local, ring_mask, local_logits, ring_logits, results, fresh, model
    _hold_f32_int8_ring_to_cpu()
    return {"launches": launches, "models": models, "ids": ids, "starts": starts}


def _time_turns(fns: dict, iters: int = 10, warmup: int = 2) -> dict:
    """Each function's median device time, taken in turns: the order, then
    the order reversed (a, b, b, a); the faster of each function's two."""
    times = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        times[name].append(time_ms(fns[name], iters=iters, warmup=warmup))
    return {name: min(ts) for name, ts in times.items()}


def phase_int8_ring_timings(int8_path: dict, serving: dict, training: dict) -> dict:
    """Phase 4i: B4 with ids and doc tables on phase 3f's packing beside the
    unsegmented B4 and B1's doc tables; B4's wrapper with and without the
    feed beside its kernel; B7 int8 on rank 3's schedule beside the B4 hop
    chain; B8 int8 beside four B7 int8 launches; the int8 ring model with
    and without the wire.  Returns the kernels line's rows."""
    import torch
    import torch.nn.functional as F

    from ring_attention_tpu_torch import make_train_step
    from ring_attention_tpu_torch.ops import cuda_flash as cf
    from ring_attention_tpu_torch.ops import cuda_flash_q8 as q8
    from ring_attention_tpu_torch.ops import cuda_ring as cr
    from ring_attention_tpu_torch.ops import cuda_ring_remote as crr

    log("phase 4i: the int8 ring's kernels and models (CUDA events, median after warm-up, "
        "in turns)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(f"  card: {smi.stdout.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 32)
    rows = {}
    n = 65536
    q, k, v = (_rand(gen, (1, 8, n, 64), torch.bfloat16) for _ in range(3))
    ids, starts = int8_path["ids"], int8_path["starts"]
    dids = _doc_ids(starts, n)
    ops8 = q8.quantize_operands(q, k, v)
    band = dict(scale=0.125, causal_offset=0, window_lo=None, softclamp_value=None)
    table = cf._doc_table(starts, "fwd_q8", True, n, 0, None, str(q.device))
    check(table is not None, f"phase 3f's aligned packing {starts} has no B4 doc table")
    kw = dict(scale=0.125, causal_offset=0)
    t = _time_turns({
        "unsegmented": lambda: q8.launch_fwd_q8(ops8, None, band, torch.bfloat16),
        "kSeg": lambda: q8.launch_fwd_q8(ops8, None, band, torch.bfloat16, q_seg=ids,
                                         kv_seg=ids),
        "kDocs": lambda: q8.launch_fwd_q8(ops8, None, band, torch.bfloat16, doc_tiles=table),
        "b1_kDocs": lambda: cf.flash_fwd(q, k, v, doc_starts=starts, **kw),
    })
    sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    moved = nbytes(*ops8[:6]) + nbytes(q)
    for name, packing_ids in (("kSeg", ids), ("kDocs", dids)):
        ops = 4 * 64 * 8 * same_doc_pairs(packing_ids)
        b_ms, b_by = bound_ms(ops, moved + nbytes(packing_ids), torch.int8)
        rows[name] = {"shape": f"causal (1,8,{n},64), {len(doc_lengths(packing_ids))} "
                               f"documents, block 1024", "ms": t[name], "plain_ms": None,
                      "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                      "unsegmented_kernel_ms": t["unsegmented"],
                      "bf16_kdocs_ms": t["b1_kDocs"], "bf16_sdpa_ms": sdpa_ms}
        log(f"  flash_fwd_q8 {name} causal {n}: {t[name]:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}); unsegmented B4 {t['unsegmented']:.4f} ms, B1 kDocs "
            f"{t['b1_kDocs']:.4f} ms, bf16 sdpa (whole causal) {sdpa_ms:.4f} ms")
    feed = q8.quantize_kv_feed(k, v)
    t = _time_turns({
        "kernel": lambda: q8.launch_fwd_q8(ops8, None, band, torch.bfloat16),
        "wrapper": lambda: q8.flash_fwd_q8(q, k, v, **kw),
        "wrapper_fed": lambda: q8.flash_fwd_q8(q, None, None, kv_quantized=feed, **kw),
    })
    ops = 4 * 64 * 8 * band_pairs(n, n, 0, None)
    b_ms, b_by = bound_ms(ops, nbytes(*ops8[:6], q), torch.int8)
    rows["feed"] = {"shape": f"causal (1,8,{n},64), fed K/V, block 1024",
                    "ms": t["wrapper_fed"], "plain_ms": None, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": None, "kernel_ms": t["kernel"],
                    "wrapper_ms": t["wrapper"]}
    log(f"  flash_fwd_q8 causal {n}: kernel {t['kernel']:.4f} ms; wrapper quantizing q, k, v "
        f"{t['wrapper']:.4f} ms ({t['wrapper'] - t['kernel']:.4f} ms around the kernel); "
        f"wrapper fed K/V {t['wrapper_fed']:.4f} ms ({t['wrapper_fed'] - t['kernel']:.4f} ms)")
    del q, k, v, ops8, feed

    for n_local in INT8_TIMING_N:
        block = 1024
        Q, K, V = _ring_shards(gen, n_local)
        feed_all = q8.quantize_kv_feed(K, V, block)
        q3 = Q[:, :, 3 * n_local:].contiguous()
        tables = _remote_tables(RING_SIZE, n_local, causal=True)
        tab3 = dict(zip(TABLE_NAMES, (x.cuda() for x in tables[3])))

        # each hop's origin's feed, contiguous, as the scan ring's streams hold it
        hop_feeds = [q8.Int8KV(*(x.contiguous() for x in cr._feed_rows(feed_all, o, n_local)[:4]),
                               block) for o in range(RING_SIZE)]

        def chain(q3=q3, hop_feeds=hop_feeds, n_local=n_local):
            carry = None
            for hop in range(RING_SIZE):
                fd = hop_feeds[3 - hop]
                hi = n_local if hop else 0
                if hop == RING_SIZE - 1:
                    return q8.flash_fwd_q8(q3, None, None, kv_quantized=fd, block_k=block,
                                           scale=0.125, causal_offset=hi, carry=carry)
                carry = q8.flash_partials_q8(q3, None, None, kv_quantized=fd, block_k=block,
                                             scale=0.125, causal_offset=hi, carry=carry,
                                             out=carry)

        def b7(q3=q3, feed_all=feed_all, n_local=n_local, tab3=tab3):
            return cr.fused_ring_local(q3, None, None, kv_quantized=feed_all, block_k=block,
                                       n_local=n_local, scale=0.125, **tab3)

        same = all(torch.equal(x, y) for x, y in zip(chain(), b7()))
        long = n_local > 65536  # seconds a launch: one timed run each, in turns
        t = _time_turns({"chain": chain, "b7": b7}, iters=1 if long else 10,
                        warmup=0 if long else 2)
        pairs = n_local * (n_local + 1) // 2 + 3 * n_local * n_local
        ops = 4 * 64 * 8 * pairs
        b_ms, b_by = bound_ms(ops, nbytes(q3, *feed_all[:4]), torch.int8)
        rows[f"ring_q8_{n_local}"] = {
            "shape": f"rank 3 of a causal ring of 4, n_local {n_local}, (1,8), block {block}",
            "ms": t["b7"], "plain_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "hop_chain_ms": t["chain"]}
        log(f"  flash_ring int8 rank 3 n_local {n_local}: {t['b7']:.4f} ms, B4 hop chain "
            f"{t['chain']:.4f} ms (B7 / chain {t['b7'] / t['chain']:.3f}), bit-identical "
            f"{same}; bound {b_ms:.4f} ms ({b_by}); {ops / t['b7'] / 1e9:.1f} TOP/s")
        check(same, f"flash_ring int8 n_local {n_local}: differs from the B4 chain")
        del feed_all, q3, hop_feeds
        qs, ks, vs = ([x.contiguous() for x in t_.chunk(RING_SIZE, 2)] for t_ in (Q, K, V))
        del Q, K, V
        feeds = _remote_q8_feeds(ks, vs, n_local)
        gathered = q8.Int8KV(*(torch.cat([f[i] for f in feeds], dim=2) for i in range(4)),
                             n_local)
        tabs = [dict(zip(TABLE_NAMES, (x.cuda() for x in table))) for table in tables]

        def b8(qs=qs, feeds=feeds, tables=tables, n_local=n_local):
            return crr.fused_ring_remote(qs, None, None, tables=tables, n_local=n_local,
                                         scale=0.125, compute_dtype="int8", kv_quantized=feeds)

        def four_b7(qs=qs, gathered=gathered, tabs=tabs, n_local=n_local):
            return [cr.fused_ring_local(q_, None, None, kv_quantized=gathered,
                                        block_k=n_local, n_local=n_local, scale=0.125, **tab)
                    for q_, tab in zip(qs, tabs)]

        outs, _ = b8()
        same = all(torch.equal(o, r[0]) for o, r in zip(outs, four_b7()))
        t = _time_turns({"four_b7": four_b7, "b8": b8}, iters=1 if long else 10,
                        warmup=0 if long else 2)
        pairs = (RING_SIZE * n_local * n_local * (RING_SIZE - 1) // 2
                 + RING_SIZE * n_local * (n_local + 1) // 2)
        ops = 4 * 64 * 8 * pairs
        b_ms, b_by = bound_ms(ops, nbytes(*qs, *(x for f in feeds for x in f[:4])), torch.int8)
        rows[f"remote_q8_{n_local}"] = {
            "shape": f"causal ring of 4, n_local {n_local}, (1,8), one v block per rank",
            "ms": t["b8"], "plain_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "local_tier_ms": t["four_b7"]}
        log(f"  flash_ring_remote int8 ring of 4 x {n_local}: {t['b8']:.4f} ms, four B7 int8 "
            f"launches (the same feeds, gathered) {t['four_b7']:.4f} ms (B8 / 4 B7 "
            f"{t['b8'] / t['four_b7']:.3f}), B8 bit-identical to them {same}; bound "
            f"{b_ms:.4f} ms ({b_by})")
        check(same, f"flash_ring_remote int8 n_local {n_local}: differs from four B7 launches")
        del qs, ks, vs, feeds, gathered

    # the models: forward and train step, with and without the wire
    tokens = serving["tokens"]
    fwd = {}
    for form, (model, step) in int8_path["models"].items():
        with torch.inference_mode():
            fwd[form] = time_ms(lambda m=model: m(tokens), iters=5)
    q8_nowire = _model(torch.bfloat16, "cuda", mesh=int8_path["models"]["q8"][0].mesh,
                       compute_dtype="int8")
    with torch.inference_mode():
        fwd["q8_no_wire"] = time_ms(lambda: q8_nowire(tokens), iters=5)
    for form, ms in fwd.items():
        log(f"  int8 ring model {form} forward 1 x {tokens.shape[1]}: {ms:.3f} ms, "
            f"{tokens.shape[1] / ms * 1e3:.0f} tokens/s (bf16 local model "
            f"{serving['fwd_ms']:.3f} ms)")
    for form in ("q8",):
        model, step = int8_path["models"][form]
        model.train()
        ms, _, peak, _ = _train_step_timing(step, training["tokens"])
        log(f"  int8 ring model {form} train step 1 x {training['tokens'].shape[1]}: "
            f"{ms:.3f} ms, peak {peak / 2**30:.3f} GiB")
        model.eval()
    q8_nowire.train()
    nowire_ms, *_ = _train_step_timing(
        make_train_step(lambda t_: q8_nowire(t_, return_loss=True),
                        torch.optim.Adam(q8_nowire.parameters(), lr=1e-3)), training["tokens"])
    log(f"  int8 ring model without the wire (compute_dtype='int8' alone) train step: "
        f"{nowire_ms:.3f} ms")
    del q8_nowire
    rows["models"] = fwd
    return rows


# ---------------------------------------------------------------------------
# Phases 3m and 4j: the model over a mesh of processes.  Four processes
# (spawn), each one rank of create_mesh() over a gloo process group
# rendezvousing through a FileStore, all on this one card: gloo stages the
# collectives' payloads through host memory (NCCL takes no two ranks on one
# device); the kernels run on the card in every process.

MP_WORLD = 4
MP_SEQ = 65536
MP_JOIN_TIMEOUT_S = 480
MP_LR = 1e-3
MP_SERVE_NEW = 16
MP_TIMED_CALLS = 3
# name: (ring size, data size, model fields, what the case runs)
MP_CASES = {
    "cuda": (4, 1, dict(impl="cuda"), ("forward", "step")),
    "fused": (4, 1, dict(impl="fused"), ("forward",)),
    "int8": (4, 1, dict(impl="cuda", ring_hop_compression="int8", compute_dtype="int8"),
             ("forward",)),
    "striped": (4, 1, dict(impl="cuda", striped=True), ("forward",)),
    "packed": (4, 1, dict(impl="cuda"), ("forward", "loss")),
    "zigzag": (4, 1, dict(impl="cuda", sequence_parallel="zigzag"), ("forward", "step")),
    "data2_ring2": (2, 2, dict(impl="cuda"), ("step",)),
    "serving": (4, 1, dict(impl="cuda"), ("generate",)),
}
# Phase-3m bounds against the same model on a VirtualRing in this process.
# Logits: RING_LOGITS_REL_TOL (the attention on the same q, k, v is the
# same arithmetic, but cuBLAS may choose another algorithm for the
# projections of 16,384 rows than for 65,536).  Loss: the same f32 nll
# summed in another order (each process's positions, then gloo's sum of
# the four) from those logits.
MP_LOSS_REL_TOL = 1e-5
# The step's gradient (the mesh's sum that the optimizer is given) against
# the VirtualRing model's, leaf by leaf, ||diff|| / ||ref||, the worst leaf
# (prediction in PERF.md section 6, PR 18).  The f32 gradient of each weight
# is a bf16 product summed over the rows: a process rounds its share of
# 16,384 rows to bf16 once, the VirtualRing model the sum of 65,536 rows,
# so the two differ by a few bf16 roundings (2^-9 relative each) of
# shares that partly cancel.  The bound sits above the sound runs' readings
# and far below the control's: the ring-4 step's gradient without the seq
# ring's sum (MP_GRAD_CONTROL), which must land outside it.
MP_GRAD_REL_TOL = 2e-2
MP_GRAD_CONTROL = "cuda"
# Parameters after one Adam step (lr MP_LR) from the same parameters, a
# bound on the parameters alone, not on the gradient (that is
# MP_GRAD_REL_TOL's): Adam's first update is lr * g / (|g| + eps), never more
# than lr from zero whatever the gradient's scale, so two such steps differ
# by at most 2 * lr (plus the f32 rounding of parameters below 8 in
# magnitude, 1e-6), reached where the two gradients' signs differ.  The
# norm of the updates' difference over the norm of the update is printed
# beside it.
MP_PARAM_ATOL = 2 * MP_LR + 1e-6
MP_KERNELS = {"flash_fwd": "B1", "flash_bwd_dkv": "B2", "flash_bwd_dq": "B3",
              "flash_fwd_q8": "B4", "flash_decode": "B5", "flash_ring": "B7",
              "flash_ring_remote": "B8"}


def _mp_tokens(shape, seed):
    import torch

    gen = torch.Generator().manual_seed(SEED + seed)
    return torch.randint(0, BENCH_MODEL["num_tokens"], shape, generator=gen).cuda()


def _mp_staged(mesh) -> dict:
    """Bytes and calls that the mesh's rings staged through host memory."""
    from ring_attention_tpu_torch.parallel import DistributedRing

    rings = [r for r in (mesh.ring, mesh.data_ring) if isinstance(r, DistributedRing)]
    return {op: [sum(r.staged_calls[op] for r in rings), sum(r.staged_bytes[op] for r in rings)]
            for op in ("rotate", "all_gather", "all_reduce")}


def _mp_digest(t) -> str:
    """A digest of a tensor's bytes (bit-identity across processes)."""
    import hashlib

    import torch

    data = t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy()
    return hashlib.sha256(data.tobytes()).hexdigest()


def _mp_timed(fn, mesh):
    """``fn()``'s result, host ms of its first call and the median of
    MP_TIMED_CALLS more (each synchronized), and the launches and host
    staging of the first call."""
    import torch

    _reset_counts()
    staged = _mp_staged(mesh)
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    first = (time.perf_counter() - start) * 1e3
    counts = _read_counts()
    staged = {op: [a - b for a, b in zip(n, staged[op])] for op, n in _mp_staged(mesh).items()}
    times = []
    for _ in range(MP_TIMED_CALLS):
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return out, {"first_ms": first, "ms": statistics.median(times), "counts": counts,
                 "staged": staged}


def _mp_case(name: str, mesh, out_dir: str, tag) -> dict:
    """One case of MP_CASES on ``mesh`` (a process's, or a VirtualRing's in
    the parent, ``tag == "ref"``): its launches, times, host staging and
    digests; rank 0 and the reference save their logits and parameters."""
    import torch

    from ring_attention_tpu_torch import make_train_step

    ring, data, fields, actions = MP_CASES[name]
    model = _model(torch.bfloat16, "cuda", mesh=mesh, **fields)
    ids = packed_ids(MP_SEQ) if name == "packed" else None
    save = tag in (0, "ref")
    res = {}
    if "forward" in actions:
        tokens = _mp_tokens((1, MP_SEQ), 40)
        with torch.inference_mode():
            logits, res["forward"] = _mp_timed(lambda: model(tokens, segment_ids=ids), mesh)
        res["forward"]["digest"] = _mp_digest(logits)
        if save:
            torch.save(logits.cpu(), f"{out_dir}/{name}_{tag}_logits.pt")
        del logits
    if "loss" in actions:
        step_tokens = _mp_tokens((1, MP_SEQ + 1), 41)
        step_ids = torch.cat([ids, ids[:, -1:]], dim=1)
        with torch.inference_mode():
            res["loss"] = float(model(step_tokens, return_loss=True, segment_ids=step_ids))
    if "step" in actions:
        step_tokens = _mp_tokens((data, MP_SEQ // data + 1), 41)
        model.train()
        if name == MP_GRAD_CONTROL and tag != "ref":
            # the control: this process's gradient before any step, without
            # the seq ring's sum (the case has one data row)
            model(step_tokens, return_loss=True).backward()
            if save:
                torch.save([p.grad.float().cpu() for p in model.parameters()],
                           f"{out_dir}/{name}_{tag}_local.pt")
            model.zero_grad(set_to_none=True)
        opt = torch.optim.Adam(model.parameters(), lr=MP_LR)
        step = make_train_step(lambda t: model(t, return_loss=True), opt, mesh=mesh)
        _reset_counts()
        staged = _mp_staged(mesh)
        loss = float(step(step_tokens))
        torch.cuda.synchronize()
        flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()]).cpu()
        res["step"] = {"loss": loss, "counts": _read_counts(), "digest": _mp_digest(flat),
                       "staged": {op: [a - b for a, b in zip(n, staged[op])]
                                  for op, n in _mp_staged(mesh).items()}}
        if save:
            torch.save(flat, f"{out_dir}/{name}_{tag}_params.pt")
            # the step's gradient: on a process the mesh's sum that the step
            # gave the optimizer (it leaves it in .grad), on the VirtualRing
            # the model's own
            torch.save([p.grad.float().cpu() for p in model.parameters()],
                       f"{out_dir}/{name}_{tag}_grads.pt")
        # the step compared above is the first; a second one is timed
        start = time.perf_counter()
        step(step_tokens)
        torch.cuda.synchronize()
        res["step"]["ms"] = (time.perf_counter() - start) * 1e3
    if "generate" in actions:
        prompts = _mp_tokens((4, SERVE_PROMPT), 42)
        with torch.inference_mode():
            new, res["generate"] = _mp_timed(lambda: model.generate(
                prompts, max_len=SERVE_MAX_LEN, num_steps=MP_SERVE_NEW), mesh)
        res["generate"]["tokens"] = new.tolist()
    del model
    torch.cuda.empty_cache()
    return res


def _mp_worker(rank: int, store_path: str, out_dir: str) -> None:
    """One process of the mesh: every case of MP_CASES on its mesh, the
    results written to ``rank<r>.json``.  A failure raises (the process
    exits non-zero and the parent fails the run)."""
    import torch
    import torch.distributed as dist

    from ring_attention_tpu_torch.parallel import create_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, MP_WORLD), rank=rank,
                            world_size=MP_WORLD)
    meshes = {(4, 1): create_mesh(), (2, 2): create_mesh(ring_size=2, data_size=2)}
    check(meshes[4, 1].ring.host_staged, "a gloo ring must stage CUDA payloads on the host")
    results = {name: _mp_case(name, meshes[ring, data], out_dir, rank)
               for name, (ring, data, _, _) in MP_CASES.items()}
    with open(f"{out_dir}/rank{rank}.json", "w") as f:
        json.dump(results, f)
    dist.destroy_process_group()


def _mp_spawn(out_dir: str) -> list[dict]:
    """The MP_WORLD processes, joined within MP_JOIN_TIMEOUT_S; a process
    that fails or is still running fails the run (the stragglers are
    terminated first)."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_mp_worker, args=(r, f"{out_dir}/store", out_dir))
             for r in range(MP_WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + MP_JOIN_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    check(not hung, f"phase 3m: ranks {hung} still running after {MP_JOIN_TIMEOUT_S} s")
    codes = [p.exitcode for p in procs]
    check(codes == [0] * MP_WORLD, f"phase 3m: the processes exited with {codes}")
    results = []
    for r in range(MP_WORLD):
        with open(f"{out_dir}/rank{r}.json") as f:
            results.append(json.load(f))
    return results


def _staged_text(staged: dict) -> str:
    calls, nbytes_ = staged["rotate"]
    text = f"{calls} hops of {nbytes_ // max(calls, 1):,} B"
    for op in ("all_gather", "all_reduce"):
        text += f", {op} {staged[op][1]:,} B in {staged[op][0]}"
    return text


def _worst_leaf(got: list, want: list) -> float:
    """The largest ``||got - want|| / ||want||`` over the leaves."""
    return max(((g - w).norm() / w.norm()).item() for g, w in zip(got, want))


def _per_layer(counts: dict) -> dict:
    depth = BENCH_MODEL["depth"]
    return {f"{MP_KERNELS[k]} {k}": v / depth for k, v in counts.items()
            if k in MP_KERNELS and v}


def phase_multiprocess_model() -> dict:
    """Phases 3m and 4j: the bench model at full width on a mesh of four
    processes sharing this card over gloo (``DistributedRing``), each case
    held to the same model on a ``VirtualRing`` in this process; then the
    processes' times beside the ``VirtualRing`` model's."""
    import tempfile

    import torch

    from ring_attention_tpu_torch.parallel import create_mesh

    log(f"phase 3m: RingTransformer on a mesh of {MP_WORLD} processes (spawn, gloo through a "
        f"FileStore, every process on this card; ring 4, and data 2 x ring 2), bench model at "
        f"full width, bf16: cases {list(MP_CASES)}")
    depth = BENCH_MODEL["depth"]
    launches = {name: 0 for name in COUNTERS}
    with tempfile.TemporaryDirectory() as out_dir:
        refs = {name: _mp_case(name, create_mesh(ring_size=ring), out_dir, "ref")
                for name, (ring, _, _, _) in MP_CASES.items()}
        start = time.perf_counter()
        procs = _mp_spawn(out_dir)
        log(f"  the {MP_WORLD} processes ran every case in {time.perf_counter() - start:.1f} s "
            f"(spawn, CUDA init and the first calls included)")
        rows = []
        for name, (ring, data, fields, actions) in MP_CASES.items():
            ref = refs[name]
            for action in actions:
                if action == "loss":
                    continue
                got = [p[name][action] for p in procs]
                summed = {k: sum(g["counts"][k] for g in got) for k in COUNTERS}
                for k, v in summed.items():
                    launches[k] += v
                expected = {k: data * v for k, v in ref[action]["counts"].items()}
                if name == "fused" and action == "forward":
                    # a DistributedRing is not colocated: B7 over the gathered
                    # span once per rank and layer where the VirtualRing takes B8
                    expected = _counts(flash_ring=MP_WORLD * depth)
                log(f"  {name} {action}: launches per process and layer "
                    f"{[_per_layer(g['counts']) for g in got]}; summed over the processes "
                    f"{ {k: v for k, v in summed.items() if v} }; rank 0 staged through the "
                    f"host (bytes to and from it, calls): {_staged_text(got[0]['staged'])}")
                check(summed == expected, f"{name} {action}: the processes launched {summed}, "
                      f"expected {expected}")
                for k in ("flash_fwd", "flash_fwd_q8", "flash_ring", "flash_decode"):
                    if expected.get(k):
                        check(all(g["counts"][k] > 0 for g in got),
                              f"{name} {action}: a process never launched {k}")
            if "forward" in actions:
                digests = {p[name]["forward"]["digest"] for p in procs}
                check(len(digests) == 1, f"{name}: the processes' logits differ")
                logits = torch.load(f"{out_dir}/{name}_0_logits.pt").float()
                want = torch.load(f"{out_dir}/{name}_ref_logits.pt").float()
                rel = ((logits - want).norm() / want.norm()).item()
                log(f"  {name} forward 1 x {MP_SEQ}: global logits on every process (one digest), "
                    f"vs the VirtualRing model ||diff|| / ||ref|| {rel:.3e} (tol "
                    f"{RING_LOGITS_REL_TOL}), bit-identical {bool(torch.equal(logits, want))}")
                check(bool(torch.isfinite(logits).all()) and rel <= RING_LOGITS_REL_TOL,
                      f"{name}: logits on the processes disagree with the VirtualRing model")
                del logits, want
            if "loss" in actions:
                losses = [p[name]["loss"] for p in procs]
                rel = abs(losses[0] - ref["loss"]) / abs(ref["loss"])
                log(f"  {name} loss: {losses} vs the VirtualRing model {ref['loss']:.7f}: "
                    f"rel {rel:.3e} (tol {MP_LOSS_REL_TOL})")
                check(len(set(losses)) == 1 and rel <= MP_LOSS_REL_TOL,
                      f"{name}: packed loss on the processes disagrees")
            if "step" in actions:
                losses = [p[name]["step"]["loss"] for p in procs]
                rel = abs(losses[0] - ref["step"]["loss"]) / abs(ref["step"]["loss"])
                digests = {p[name]["step"]["digest"] for p in procs}
                params = torch.load(f"{out_dir}/{name}_0_params.pt")
                want = torch.load(f"{out_dir}/{name}_ref_params.pt")
                init = torch.cat([p.detach().reshape(-1).cpu() for p in
                                  _model(torch.bfloat16, "cpu").parameters()])
                worst = (params - want).abs().max().item()
                upd = ((params - want).norm() / (want - init).norm()).item()
                log(f"  {name} Adam step ({data} x {MP_SEQ // data} tokens): loss {losses} vs "
                    f"the VirtualRing step {ref['step']['loss']:.7f}: rel {rel:.3e} (tol "
                    f"{MP_LOSS_REL_TOL}); parameters equal bit for bit on every process "
                    f"{len(digests) == 1}; vs the VirtualRing step max|diff| {worst:.3e} "
                    f"(tol {MP_PARAM_ATOL}), ||diff|| / ||VirtualRing update|| {upd:.3e}")
                check(len(set(losses)) == 1 and rel <= MP_LOSS_REL_TOL,
                      f"{name}: the step's loss on the processes disagrees")
                check(len(digests) == 1, f"{name}: the processes' parameters differ")
                check(worst <= MP_PARAM_ATOL, f"{name}: parameters off the VirtualRing step")
                want = torch.load(f"{out_dir}/{name}_ref_grads.pt")
                grad_rel = _worst_leaf(torch.load(f"{out_dir}/{name}_0_grads.pt"), want)
                log(f"  {name} step gradient (the mesh's sum) vs the VirtualRing model's: worst "
                    f"leaf ||diff|| / ||ref|| {grad_rel:.3e} (tol {MP_GRAD_REL_TOL})")
                check(grad_rel <= MP_GRAD_REL_TOL,
                      f"{name}: the step's gradient disagrees with the VirtualRing model's")
                if name == MP_GRAD_CONTROL:
                    control = _worst_leaf(torch.load(f"{out_dir}/{name}_0_local.pt"), want)
                    scaled = _worst_leaf([MP_WORLD * g for g in want], want)
                    log(f"  {name} controls, each outside the bound: the gradient without the "
                        f"seq ring's sum {control:.3e}; the VirtualRing gradient times "
                        f"{MP_WORLD} {scaled:.3e}")
                    check(min(control, scaled) > MP_GRAD_REL_TOL,
                          f"{name}: the gradient bound does not tell a wrong gradient apart")
            if "generate" in actions:
                tokens = [p[name]["generate"]["tokens"] for p in procs]
                same = all(t == ref["generate"]["tokens"] for t in tokens)
                log(f"  {name}: 4 x ({SERVE_PROMPT} prompt + {MP_SERVE_NEW} new), greedy, "
                    f"cache {SERVE_MAX_LEN}: tokens equal the VirtualRing model's on every "
                    f"process {same}")
                check(same, "generate on the processes differs from the VirtualRing model")
            for action in ("forward", "step", "generate"):
                if action in actions:
                    got = [p[name][action]["ms"] for p in procs]
                    rows.append((name, action, ref[action]["ms"], got,
                                 [p[name][action].get("first_ms") for p in procs]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"phase 4j: the mesh of processes' wall times, host clock around synchronized calls "
        f"({smi}). Four processes time-sliced on ONE card with gloo staging every hop "
        f"through host memory: not a measure of a multi-GPU ring; no claim rests on them")
    for name, action, ref_ms, got, first in rows:
        how = ("the second step, after the one compared" if first[0] is None else
               f"median of {MP_TIMED_CALLS} after the first, first "
               f"{[round(f, 1) for f in first]}")
        log(f"  {name} {action}: VirtualRing model {ref_ms:.1f} ms; processes "
            f"{[round(g, 1) for g in got]} ms ({how})")
    return {"launches": launches}



# Phase 3n: the memory knobs on the bench model at 1 x 65,536, bf16.  Each
# configuration's loss and gradients against the step without knobs, held to
# the bf16 bounds below (loss relative, each gradient leaf norm-relative, as
# MP_GRAD_REL_TOL holds a bf16 step's gradient taken in another order): the
# chunks change the FeedForward's and the loss's matmul shapes (cuBLAS may
# take other kernels) and the loss's f32 sum order.  The remat policies rerun
# the same kernels and matmuls on the same inputs (or read back what the
# first forward kept); whether they are bit-identical is printed beside the
# step without knobs run twice, which shows how far one step repeats itself.
KNOB_SEQ = 65536
KNOB_CONFIGS = {
    "no knobs": {},
    "no knobs, again": {},
    "remat None": dict(remat=True, remat_policy=None),
    "remat save_attn": dict(remat=True, remat_policy="save_attn"),
    "remat offload_attn": dict(remat=True, remat_policy="offload_attn"),
    "remat save_attn_and_ffn_inputs": dict(remat=True, remat_policy="save_attn_and_ffn_inputs"),
    "remat checkpoint_dots": dict(remat=True, remat_policy="checkpoint_dots"),
    "chunks 2048": dict(ff_chunk_size=2048, loss_chunk_size=2048),
}
# B1 launches per step (B2 and B3: 2 each in every configuration)
KNOB_B1 = {"no knobs": 2, "no knobs, again": 2, "remat None": 4, "remat save_attn": 2, "remat offload_attn": 2,
           "remat save_attn_and_ffn_inputs": 2, "remat checkpoint_dots": 4, "chunks 2048": 2}
KNOB_LOSS_REL_TOL = 1e-3
KNOB_GRAD_REL_TOL = 2e-2
# bench.py's train model (bench.py:1147-1162) and its phase 7 (train1m)
BENCH_TRAIN_KNOBS = dict(remat=True, remat_policy="save_attn", ff_chunk_size=2048,
                         loss_chunk_size=2048)
# The windowed decode cache: layer 0 looks back 4,096 tokens; 4 requests of
# 8,192-token prompts, 64 new tokens.  Windowed and full caches hold the same
# rows for layer 0's window, read by B5 (B6) over another slot order and
# split; the logits of each teacher-forced step are held norm-relative
# (RING_LOGITS_REL_TOL: the same bf16 model summing its keys in another
# order), and the windowed model's greedy token must equal the full model's
# wherever the full model's top-2 margin exceeds twice the step's largest
# logit difference.
WINDOW = 4096
WINDOW_PROMPT = 8192
WINDOW_NEW = 64
# Phase 4k: under save_attn a step launches B1, B2 and B3 once per layer,
# as without remat
KNOB_STEP_LAUNCHES = _counts(flash_fwd=2, flash_bwd_dkv=2, flash_bwd_dq=2)


def _knob_step(model, tokens) -> dict:
    """One loss and backward of ``model`` on ``tokens``: the loss, every
    gradient, the launches and the peak memory above what was live."""
    import torch

    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    start = time.perf_counter()
    loss = model(tokens, return_loss=True)
    loss.backward()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    counts = _read_counts()
    out = {"loss": loss.detach(),
           "grads": [p.grad.detach().clone() for p in model.parameters() if p.grad is not None],
           "counts": counts, "above": torch.cuda.max_memory_allocated() - base,
           "seconds": seconds}
    model.zero_grad(set_to_none=True)
    return out


def _against(res: dict, ref: dict, names: list) -> tuple:
    """A step's loss and gradients against a reference step's: the loss's
    relative difference, the worst leaf's norm-relative one and its name,
    and which leaves differ at all ("none" where the two are bit-identical)."""
    import torch

    loss_rel = abs(res["loss"].item() - ref["loss"].item()) / abs(ref["loss"].item())
    rels = [(g.float() - r.float()).norm().item() / max(r.float().norm().item(), 1e-30)
            for g, r in zip(res["grads"], ref["grads"])]
    worst = max(range(len(rels)), key=rels.__getitem__)
    differ = [name for name, g, r in zip(names, res["grads"], ref["grads"])
              if not torch.equal(g, r)]
    if not torch.equal(res["loss"], ref["loss"]):
        differ.insert(0, "the loss")
    return loss_rel, rels[worst], names[worst], ", ".join(differ) or "none"


def _teacher_forced(model, prompts, new_tokens, max_len) -> tuple:
    """Prefill logits and each teacher-forced decode step's logits ``(steps,
    b, vocab)`` in f32, and the model's cache."""
    import torch

    n = prompts.shape[1]
    with torch.inference_mode():
        cache = model.init_cache(prompts.shape[0], max_len)
        logits, cache = model.prefill(prompts, cache)
        steps = [logits.float()]
        for i in range(new_tokens.shape[1] - 1):
            logits, cache = model.decode_step(new_tokens[:, i], cache, n + i)
            steps.append(logits.float())
    return torch.stack(steps), cache


def _cache_bytes(entry) -> int:
    return sum(t.numel() * t.element_size() for t in (entry if isinstance(entry, tuple)
                                                     else (entry,)))


def _hold_windowed_cache(quantize: bool) -> dict:
    """The windowed cache against the full one on the bench model (layer 0
    windowed); returns the launches of the windowed model's decoding."""
    import torch

    kind = "int8 cache" if quantize else "bf16 cache"
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    vocab = BENCH_MODEL["num_tokens"]
    prompts = torch.randint(0, vocab, (4, WINDOW_PROMPT), generator=gen, device="cuda")
    max_len = WINDOW_PROMPT + WINDOW_NEW
    kw = dict(max_lookback_seq_len=(WINDOW, None), quantize_cache=quantize)
    full = _model(torch.bfloat16, "cuda", **kw)
    windowed = _model(torch.bfloat16, "cuda", windowed_cache=True, **kw)
    with torch.inference_mode():
        greedy = full.generate(prompts, max_len=max_len, num_steps=WINDOW_NEW)
        want, full_cache = _teacher_forced(full, prompts, greedy, max_len)
        _reset_counts()
        got, cache = _teacher_forced(windowed, prompts, greedy, max_len)
        counts = _read_counts()
    decode = "flash_decode_q8" if quantize else "flash_decode"
    expected = _counts(**{decode: BENCH_MODEL["depth"] * (WINDOW_NEW - 1)})
    check(counts == expected, f"windowed {kind}: decoding launched {counts}, expected {expected}")
    slots = (cache["k"][0][0] if quantize else cache["k"][0]).shape[2]
    check(slots == WINDOW, f"windowed {kind}: layer 0 holds {slots} slots, expected {WINDOW}")
    rel = [_rel_err(g, w) for g, w in zip(got, want)]
    diff = (got - want).abs().amax(dim=-1).amax(dim=-1)  # (steps,)
    top2 = want.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]  # (steps, b)
    agree = got.argmax(-1) == want.argmax(-1)
    decided = margin > 2 * diff[:, None]
    layer0 = [_cache_bytes(c["k"][0]) + _cache_bytes(c["v"][0]) for c in (cache, full_cache)]
    line = (f"  windowed {kind} (layer 0 window {WINDOW}): 4 x ({WINDOW_PROMPT} prompt + "
            f"{WINDOW_NEW} new), teacher-forced on the full model's greedy tokens: logits "
            f"||windowed - full|| / ||full|| max {max(rel):.3e} (tol {RING_LOGITS_REL_TOL}), "
            f"max|diff| {diff.max().item():.3e}; greedy tokens equal "
            f"{int(agree.sum())}/{agree.numel()} ({int(decided.sum())} decided by a margin "
            f"above 2 x max|diff|, all of them equal: {bool(agree[decided].all())}); layer 0 "
            f"cache {layer0[0] / 2**20:.1f} MiB windowed, {layer0[1] / 2**20:.1f} MiB full; "
            f"launches {_nonzero(counts)}")
    if quantize:
        # the int8 noise reference (PERF.md, ROADMAP Queue 3): the full int8
        # model's own logits under last-bit weight noise
        noisy = _model(torch.bfloat16, "cuda", **kw)
        cpu_gen = torch.Generator().manual_seed(SEED + 41)
        with torch.no_grad():
            for w in noisy.parameters():
                w.mul_(1 + 1.2e-7 * torch.randn(w.shape, generator=cpu_gen).cuda())
        spread, _ = _teacher_forced(noisy, prompts, greedy, max_len)
        line += (f"; the full int8 model's weights x (1 + 1.2e-7 noise) move its logits "
                 f"{max(_rel_err(s, w) for s, w in zip(spread, want)):.3e}")
    log(line)
    check(max(rel) <= RING_LOGITS_REL_TOL, f"windowed {kind}: logits off the full cache's")
    check(bool(agree[decided].all()), f"windowed {kind}: a greedy token differs where the "
          "full model's margin decides it")
    return counts


def _nonzero(counts: dict) -> dict:
    return {name: n for name, n in counts.items() if n}


def _hold_offload(tokens) -> dict:
    """Two Adam steps with ``offload_opt_state=True`` against two plain
    ones from the same weights; returns the launches of the offloaded
    steps.  The embedding is frozen in both: its backward sums each row's
    gradient with atomics, in no fixed order (the repeated step of 3n shows
    it), and every other parameter's gradient repeats bit for bit."""
    import torch

    from ring_attention_tpu_torch import make_train_step

    runs, launches = {}, None
    for offload in (False, True):
        model = _model(torch.bfloat16, "cuda").train()
        model.embed.weight.requires_grad_(False)
        opt = torch.optim.Adam([p for p in model.parameters() if p.requires_grad], lr=1e-3)
        step = make_train_step(lambda t, m=model: m(t, return_loss=True), opt,
                               offload_opt_state=offload)
        device_bytes, where = [], []
        if offload:
            _reset_counts()
        for _ in range(2):
            step(tokens)
            torch.cuda.synchronize()
            state = [t for s in opt.state.values() for t in s.values() if torch.is_tensor(t)]
            device_bytes.append(sum(t.numel() * t.element_size() for t in state
                                    if t.device.type == "cuda"))
            where.append({(t.device.type, t.is_pinned()) for t in state})
        if offload:
            launches = _read_counts()
            parked = sum(t.numel() * t.element_size() for s in opt.state.values()
                         for t in s.values() if torch.is_tensor(t) and t.is_pinned())
        runs[offload] = ([p.detach().clone() for p in model.parameters()], device_bytes, where)
        del model, opt, step
    same = all(torch.equal(a, b) for a, b in zip(runs[False][0], runs[True][0]))
    log(f"  offload_opt_state: 2 Adam steps at 1 x {KNOB_SEQ} (embedding frozen): parameters "
        f"bit-identical to the plain step's: {same}; optimizer state on the device between steps "
        f"{runs[False][1]} bytes plain, {runs[True][1]} offloaded; {parked} bytes parked "
        f"in pinned host memory; state placement (device, pinned) after each step "
        f"{[sorted(w) for w in runs[True][2]]}")
    check(same, "offload_opt_state: parameters differ from the plain step's")
    check(all(w <= {("cpu", True), ("cpu", False)} for w in runs[True][2])
          and all(b == 0 for b in runs[True][1]) and parked > 0,
          "offload_opt_state: optimizer state left on the device between steps")
    return launches


def phase_memory_knobs() -> dict:
    """Phase 3n: the memory knobs' parity, launches and memory on the card;
    returns the launches of their runs."""
    import torch

    log(f"phase 3n: the memory knobs, bench model at full width, bf16, 1 x {KNOB_SEQ}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 39)
    tokens = torch.randint(0, BENCH_MODEL["num_tokens"], (1, KNOB_SEQ + 1), generator=gen,
                           device="cuda")
    launches = _counts()
    results = {}
    for name, kw in KNOB_CONFIGS.items():
        model = _model(torch.bfloat16, "cuda", **kw).train()
        names = [param for param, _ in model.named_parameters()]
        results[name] = _knob_step(model, tokens)
        del model
        for key, n in results[name]["counts"].items():
            launches[key] += n
    for name, res in results.items():
        counts = res["counts"]
        b123 = {k: counts[k] for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")}
        loss_rel, grad_rel, leaf, differ = _against(res, results["no knobs"], names)
        log(f"  {name}: loss {res['loss'].item():.6f} (rel {loss_rel:.2e}), worst gradient "
            f"leaf ||diff|| / ||ref|| {grad_rel:.2e} ({leaf}), leaves not bit-identical: "
            f"{differ}; launches {b123}; peak {res['above'] / 2**30:.3f} GiB above live; "
            f"{res['seconds'] * 1e3:.1f} ms (loss and backward, first call)")
        expected = _counts(flash_fwd=KNOB_B1[name], flash_bwd_dkv=2, flash_bwd_dq=2)
        check(counts == expected, f"{name}: launched {_nonzero(counts)}, expected "
              f"{_nonzero(expected)}")
        check(loss_rel <= KNOB_LOSS_REL_TOL and grad_rel <= KNOB_GRAD_REL_TOL,
              f"{name}: loss or gradients off the step without knobs")
    log("  (the step without knobs, run again, shows what a step repeats: the "
        "embedding's backward sums its rows' gradients with atomics, in no fixed order)")
    # compute_dtype="int8": the int8 sweep (B4) under save_attn runs once per
    # layer, as without remat, and under None twice
    int8 = {}
    for name, kw in (("no knobs", {}), ("remat save_attn", KNOB_CONFIGS["remat save_attn"]),
                     ("remat None", KNOB_CONFIGS["remat None"])):
        model = _q8_model(torch.bfloat16, "cuda", **kw).train()
        int8[name] = _knob_step(model, tokens)
        del model
        for key, n in int8[name]["counts"].items():
            launches[key] += n
    for name, res in int8.items():
        expected = _counts(flash_fwd_q8=KNOB_B1[name], flash_bwd_dkv=2, flash_bwd_dq=2)
        loss_rel, grad_rel, leaf, differ = _against(res, int8["no knobs"], names)
        log(f"  int8 compute, {name}: loss {res['loss'].item():.6f} (rel {loss_rel:.2e}), "
            f"worst gradient leaf {grad_rel:.2e} ({leaf}) against the int8 step without "
            f"knobs, leaves not bit-identical: {differ}; launches {_nonzero(res['counts'])}; "
            f"peak {res['above'] / 2**30:.3f} GiB above live")
        check(res["counts"] == expected, f"int8 {name}: launched {_nonzero(res['counts'])}")
        check(loss_rel <= KNOB_LOSS_REL_TOL and grad_rel <= KNOB_GRAD_REL_TOL,
              f"int8 {name}: loss or gradients off the int8 step without knobs")
    for quantize in (False, True):
        for key, n in _hold_windowed_cache(quantize).items():
            launches[key] += n
    for key, n in _hold_offload(tokens).items():
        launches[key] += n
    return {"launches": launches}


def _time_knob_steps(models: dict, tokens, order: list) -> dict:
    """Each model's Adam step (``make_train_step``): one warm-up step each,
    then the steps of ``order`` on the host clock around synchronized
    steps; each model's step times, the peak memory above live, the launches
    of its warm-up step and its losses."""
    import torch

    from ring_attention_tpu_torch import make_train_step

    steps = {}
    for name, model in models.items():
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        steps[name] = make_train_step(lambda t, m=model: m(t, return_loss=True), opt)
    out = {name: {"ms": [], "above": 0, "losses": []} for name in models}
    for name, step in steps.items():
        _reset_counts()
        out[name]["losses"].append(float(step(tokens)))
        out[name]["counts"] = _read_counts()
    for name in order:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        loss = steps[name](tokens)
        torch.cuda.synchronize()
        out[name]["ms"].append((time.perf_counter() - start) * 1e3)
        out[name]["above"] = max(out[name]["above"], torch.cuda.max_memory_allocated() - base)
        out[name]["losses"].append(float(loss))
    for name, row in out.items():
        check(all(math.isfinite(x) for x in row["losses"]), f"{name}: losses {row['losses']}")
    return out


def _log_knob_row(name: str, n: int, row: dict) -> None:
    ms = statistics.median(row["ms"])
    log(f"  {name}, 1 x {n}: {ms:.1f} ms a step (median of {len(row['ms'])}: "
        f"{[round(x, 1) for x in row['ms']]}), {n / ms * 1e3:.0f} tokens/s, peak "
        f"{row['above'] / 2**30:.3f} GiB above live; losses "
        f"{[round(x, 6) for x in row['losses']]}; launches a step {_nonzero(row['counts'])}")


def phase_memory_timings() -> dict:
    """Phase 4k: bench.py's train configuration at 262,144 beside the model
    without knobs, then one train1m step at 1,048,576; returns the launches
    of the knob model's steps."""
    import gc

    import torch

    start = time.perf_counter()
    log("phase 4k: bench.py's train model (remat save_attn, ff and loss chunks 2,048), "
        "Adam steps (host clock around synchronized steps)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    log(f"  card: {smi.stdout.strip()}")
    launches = _counts()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 42)
    n = 262144
    tokens = torch.randint(0, BENCH_MODEL["num_tokens"], (1, n + 1), generator=gen,
                           device="cuda")
    # the knobs apart: remat alone, the chunks alone
    chunks = dict(ff_chunk_size=2048, loss_chunk_size=2048)
    models = {"bench train knobs": _model(torch.bfloat16, "cuda", **BENCH_TRAIN_KNOBS).train(),
              "no knobs": _model(torch.bfloat16, "cuda").train(),
              "remat save_attn alone": _model(torch.bfloat16, "cuda", remat=True,
                                              remat_policy="save_attn").train(),
              "chunks alone": _model(torch.bfloat16, "cuda", **chunks).train()}
    names = list(models)
    rows = _time_knob_steps(models, tokens, names + names[::-1])
    for name, row in rows.items():
        _log_knob_row(name, n, row)
        check(row["counts"] == KNOB_STEP_LAUNCHES, f"{name}: a step launched "
              f"{_nonzero(row['counts'])}, expected {_nonzero(KNOB_STEP_LAUNCHES)}")
    for key, count in rows["bench train knobs"]["counts"].items():
        launches[key] += count
    del models, rows
    gc.collect()
    torch.cuda.empty_cache()
    n = 1 << 20
    tokens = torch.randint(0, BENCH_MODEL["num_tokens"], (1, n + 1), generator=gen,
                           device="cuda")
    model = _model(torch.bfloat16, "cuda", **BENCH_TRAIN_KNOBS).train()
    row = _time_knob_steps({"train1m": model}, tokens, ["train1m"])["train1m"]
    _log_knob_row("train1m (bench.py phase 7), one step after one warm-up", n, row)
    check(row["counts"] == KNOB_STEP_LAUNCHES, f"train1m: a step launched "
          f"{_nonzero(row['counts'])}, expected {_nonzero(KNOB_STEP_LAUNCHES)}")
    for key, count in row["counts"].items():
        launches[key] += count
    del model, tokens
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 4k took {time.perf_counter() - start:.1f} s")
    return {"launches": launches}


# ---------------------------------------------------------------------------
# Phases 3o, 3p and 4l: Ulysses and the hybrid Ulysses x Ring strategy on the
# factored mesh, and ZeRO-1 over the data ring.  In one process the held
# ranks are folded into the batch: Ulysses of 4 runs ONE launch of B1 (and of
# B2 and B3) a layer over 4 x 2 heads, the hybrid strategy on ulysses 2 x
# ring 2 ONE outer ring of 2 over 2 x 4 heads (parallel/hybrid.py).

SP_SEQ = 65536
SP_ULYSSES = 4
SP_HYBRID = dict(ulysses_size=2, ring_size=2)
# Launches per layer of the outer ring of 2 (the hop schedule of
# RING_SCHEDULE at ring 2): (seed, resume, fused_carry, dkv, dq).  Contiguous
# causal: rank 0 has work on hop 0 only (and finalizes on the host), rank 1
# on both; striped: every hop of every rank.
HYBRID_SCHEDULE = {False: (2, 0, 1, 3, 3), True: (2, 0, 2, 4, 4)}
# name: (create_mesh arguments, model fields)
SP_CASES = {
    "ulysses 4": (dict(ring_size=SP_ULYSSES), dict(sequence_parallel="ulysses", impl="cuda")),
    "hybrid 2x2": (SP_HYBRID, dict(sequence_parallel="hybrid", impl="cuda")),
    "hybrid 2x2 striped": (SP_HYBRID, dict(sequence_parallel="hybrid", impl="cuda",
                                           striped=True)),
    "hybrid 2x2 fused": (SP_HYBRID, dict(sequence_parallel="hybrid", impl="fused")),
}
# Phase-3o bounds against the local model with the same weights, bf16: the
# logits RING_LOGITS_REL_TOL (the ring's hop spans sum the keys in another
# order; Ulysses attends the same span on the same kernel and is held to it
# alike); a loss and backward's loss and worst gradient leaf the bounds of a
# bf16 step taken another way (KNOB_LOSS_REL_TOL, KNOB_GRAD_REL_TOL: phase
# 3n's, whose reruns of the same step differ in the embedding's atomics).
SP_LOSS_REL_TOL = KNOB_LOSS_REL_TOL
SP_GRAD_REL_TOL = KNOB_GRAD_REL_TOL
# The attention-only cases of kv_head_reshard's small-hk branch on the card:
# name: (ulysses degree, b, h, hk, n); bf16, d 64, causal.  BASELINE.json's
# GQA shape (32 query heads, 4 kv heads: every rank's 4 query heads share
# one kv head, sliced) and an unaligned group (12 over 3 on 4 ranks: one kv
# copy per query head).
SP_ATTN_CASES = {
    "GQA h32 hk4, Ulysses of 8": (8, 1, 32, 4, 32768),
    "unaligned h12 hk3, Ulysses of 4": (4, 1, 12, 3, 32768),
}
SP_WORLD = 4
SP_JOIN_TIMEOUT_S = 480
SP_LR = 1e-3


def _sp_counts(name: str, backward: bool) -> dict[str, int]:
    """Launches of one forward (and backward) of SP_CASES[name]'s model in
    one process (the folded design)."""
    depth = BENCH_MODEL["depth"]
    mesh_kw, fields = SP_CASES[name]
    if fields["sequence_parallel"] == "ulysses":
        return _counts(flash_fwd=depth, flash_bwd_dkv=depth if backward else 0,
                       flash_bwd_dq=depth if backward else 0)
    striped = fields.get("striped", False)
    seed, resume, fused, dkv, dq = (x * depth for x in HYBRID_SCHEDULE[striped])
    bwd = dict(flash_bwd_dkv=dkv if backward else 0, flash_bwd_dq=dq if backward else 0)
    if fields["impl"] == "fused":
        return _counts(flash_ring_remote=depth, **bwd)
    return _counts(flash_fwd=seed + resume + fused, seed=seed, resume=resume,
                   fused_carry=fused, **bwd)


def _sp_attention_cases(launches: dict) -> float:
    """Ulysses' small-hk K/V resharding on the card: ``ulysses_attention``
    against ``cuda_flash_attention`` over the whole sequence (the same
    kernels), output and gradients; the launches (one B1, one B2 and one B3:
    the ranks folded into the batch) and the ring's moves (K/V gathered
    once, only q and the output through the all-to-all).  Returns the worst
    norm-relative error."""
    import torch

    from ring_attention_tpu_torch.ops.cuda_flash import cuda_flash_attention
    from ring_attention_tpu_torch.parallel import VirtualRing
    from ring_attention_tpu_torch.parallel.ulysses import ulysses_attention

    worst = 0.0
    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    for name, (world, b, h, hk, n) in SP_ATTN_CASES.items():
        q = _rand(gen, (b, h, n, 64), torch.bfloat16).requires_grad_()
        k, v = (_rand(gen, (b, hk, n, 64), torch.bfloat16).requires_grad_() for _ in range(2))
        do = _rand(gen, (b, h, n, 64), torch.bfloat16)
        ring = VirtualRing(world)
        _reset_counts()
        out = ulysses_attention(q, k, v, ring, causal=True, impl="cuda")
        grads = torch.autograd.grad(out, (q, k, v), do)
        torch.cuda.synchronize()
        counts = _read_counts()
        ref = cuda_flash_attention(q, k, v, causal=True)
        ref_grads = torch.autograd.grad(ref, (q, k, v), do)
        errs = [_rel_err(out, ref)] + [_rel_err(g, r) for g, r in zip(grads, ref_grads)]
        same = [bool(torch.equal(a, b_)) for a, b_ in zip((out, *grads), (ref, *ref_grads))]
        expected = _counts(flash_fwd=1, flash_bwd_dkv=1, flash_bwd_dq=1)
        moves = {op: ring.calls[op] for op in ("all_to_all", "all_gather")}
        log(f"  {name} (b{b} n{n} d64 bf16, causal): vs cuda_flash_attention over the whole "
            f"span ||diff|| / ||ref|| out {errs[0]:.3e} (tol {RING_REL_TOL['torch.bfloat16']}), "
            f"dq {errs[1]:.3e}, dk {errs[2]:.3e}, dv {errs[3]:.3e} (tol "
            f"{BWD_REL_TOL['torch.bfloat16']}); bit-identical (out, dq, dk, dv) {same}; "
            f"launches {_nonzero(counts)}; the ring's moves (tensors) {moves}")
        check(counts == expected, f"{name}: launched {_nonzero(counts)}, expected "
              f"{_nonzero(expected)}")
        check(moves == {"all_to_all": 2, "all_gather": 2},
              f"{name}: K/V moved {moves}, expected one gather each and q/out all-to-alls")
        check(errs[0] <= RING_REL_TOL["torch.bfloat16"]
              and max(errs[1:]) <= BWD_REL_TOL["torch.bfloat16"],
              f"{name}: Ulysses disagrees with the whole-span kernels")
        for key, c in counts.items():
            launches[key] += c
        worst = max(worst, errs[0])
        del q, k, v, do, out, grads, ref, ref_grads
    return worst


def _hold_f32_int8_hybrid_to_cpu() -> None:
    """The f32 int8 hybrid model (seq 256, ulysses 2 x ring 2, the int8 wire
    and compute on the outer ring) on the card against the same weights on
    the CPU, with the CPU's own spread under last-bit weight noise beside
    it (the int8 noise reference of ROADMAP Queue 3)."""
    import torch

    from ring_attention_tpu_torch.parallel import create_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED + 51)
    tokens = torch.randint(0, BENCH_MODEL["num_tokens"], (2, 256), generator=gen)
    gpu = _model(None, "cuda", mesh=create_mesh(**SP_HYBRID), sequence_parallel="hybrid",
                 impl="cuda", compute_dtype="int8", ring_hop_compression="int8",
                 bucket_size=32)
    cpu = copy.deepcopy(gpu).to("cpu")
    with torch.inference_mode():
        ref = cpu(tokens)
        err = _rel_err(gpu(tokens.cuda()).cpu(), ref)
        noisy = copy.deepcopy(cpu)
        for w in noisy.parameters():
            w.mul_(1 + 1.2e-7 * torch.randn(w.shape, generator=gen))
        spread = _rel_err(noisy(tokens), ref)
    log(f"  f32 int8 hybrid model (ulysses 2 x ring 2, int8 wire and compute) seq 256, card vs "
        f"CPU: ||card - cpu|| / ||cpu|| {err:.3e} (tol {Q8_MODEL_REL_TOL}); on the CPU, weights "
        f"x (1 + 1.2e-7 noise) move it {spread:.3e}")
    check(err <= Q8_MODEL_REL_TOL, "f32 int8 hybrid model disagrees with the CPU")


def phase_sp_path(serving: dict, training: dict) -> dict:
    """Phase 3o: Ulysses of 4 and the hybrid strategy (ulysses 2 x ring 2:
    contiguous, striped, fused; int8) on the bench model at full width in
    one process, each against the local model with the same weights:
    logits, one loss and backward, exact launch counts; the small-hk
    attention cases; the f32 int8 hybrid against the CPU.  Returns the
    launches and the models (for phase 4l)."""
    import torch

    from ring_attention_tpu_torch.parallel import create_mesh

    start = time.perf_counter()
    log(f"phase 3o: Ulysses and hybrid Ulysses x Ring on one card (the held ranks folded into "
        f"the batch), bench model at full width, bf16, 1 x {SP_SEQ}: {list(SP_CASES)}")
    tokens, local = serving["tokens"], serving["model"]
    with torch.inference_mode():
        ref = local(tokens).float()
    local.train()
    names = [name for name, _ in local.named_parameters()]
    ref_step = _knob_step(local, training["tokens"])
    local.eval()
    launches = _counts()
    models = {}
    for name, (mesh_kw, fields) in SP_CASES.items():
        model = _model(torch.bfloat16, "cuda", mesh=create_mesh(**mesh_kw), **fields)
        with torch.inference_mode():
            _reset_counts()
            logits = model(tokens)
            torch.cuda.synchronize()
            counts = _read_counts()
        rel = ((logits.float() - ref).norm() / ref.norm()).item()
        finite = bool(torch.isfinite(logits.float()).all())
        del logits
        model.train()
        res = _knob_step(model, training["tokens"])
        model.eval()
        loss_rel, grad_rel, leaf, _ = _against(res, ref_step, names)
        log(f"  {name}: forward launches {_nonzero(counts)}, logits vs the local model "
            f"||diff|| / ||local|| {rel:.3e} (tol {RING_LOGITS_REL_TOL}); loss "
            f"{res['loss'].item():.6f} vs local {ref_step['loss'].item():.6f} (rel "
            f"{loss_rel:.2e}, tol {SP_LOSS_REL_TOL}), worst gradient leaf {grad_rel:.2e} "
            f"({leaf}; tol {SP_GRAD_REL_TOL}); loss and backward launches "
            f"{_nonzero(res['counts'])}, peak {res['above'] / 2**30:.3f} GiB above live")
        for got, backward in ((counts, False), (res["counts"], True)):
            want = _sp_counts(name, backward)
            check(got == want, f"{name}: launched {_nonzero(got)}, expected {_nonzero(want)}")
            for key, c in got.items():
                launches[key] += c
        check(finite and rel <= RING_LOGITS_REL_TOL, f"{name}: logits off the local model")
        check(loss_rel <= SP_LOSS_REL_TOL and grad_rel <= SP_GRAD_REL_TOL,
              f"{name}: loss or gradients off the local model")
        models[name] = model
        del res
    # the int8 hybrid: the int8 wire and compute on the outer ring (B4 fed
    # K/V quantized once per stream, per HYBRID_SCHEDULE)
    q8 = _model(torch.bfloat16, "cuda", mesh=create_mesh(**SP_HYBRID), sequence_parallel="hybrid",
                impl="cuda", compute_dtype="int8", ring_hop_compression="int8")
    with torch.inference_mode():
        _reset_counts()
        logits = q8(tokens)
        torch.cuda.synchronize()
        counts = _read_counts()
    depth = BENCH_MODEL["depth"]
    seed, resume, fused, *_ = (x * depth for x in HYBRID_SCHEDULE[False])
    want = _counts(flash_fwd_q8=seed + resume + fused, q8_seed=seed, q8_resume=resume,
                   q8_fused_carry=fused, feed_flash_fwd_q8=seed + resume + fused)
    rel = _rel_err(logits, ref)
    log(f"  hybrid 2x2 int8 (compute_dtype='int8', ring_hop_compression='int8'): launches "
        f"{_nonzero(counts)}; logits vs the bf16 local model ||diff|| / ||local|| {rel:.3e} "
        f"(tol {Q8_FWD_REL_L2})")
    check(counts == want, f"hybrid int8: launched {_nonzero(counts)}, expected {_nonzero(want)}")
    check(rel <= Q8_FWD_REL_L2, "hybrid int8 logits off the local model")
    for key, c in counts.items():
        launches[key] += c
    del q8, logits
    attn_err = _sp_attention_cases(launches)
    _hold_f32_int8_hybrid_to_cpu()
    log(f"  phase 3o took {time.perf_counter() - start:.1f} s")
    return {"launches": launches, "models": models, "attn_err": attn_err}


def _sp_worker(rank: int, store_path: str, out_dir: str) -> None:
    """One process of phase 3p: Ulysses over the ring of 4 and the hybrid
    strategy on ulysses 2 x ring 2 (forward and loss), then the ZeRO-1
    steps on data 2 x ring 2; the results written to ``sp<rank>.json``."""
    import torch
    import torch.distributed as dist

    from ring_attention_tpu_torch.parallel import create_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, SP_WORLD), rank=rank,
                            world_size=SP_WORLD)
    # every process creates the meshes' groups in the same order
    meshes = {"ulysses 4": create_mesh(), "hybrid 2x2": create_mesh(**SP_HYBRID),
              "zero": create_mesh(ring_size=2, data_size=2)}
    results = {name: _sp_model_case(name, meshes[name], out_dir, rank)
               for name in ("ulysses 4", "hybrid 2x2")}
    results["zero"] = _zero_case(meshes["zero"], out_dir, rank)
    with open(f"{out_dir}/sp{rank}.json", "w") as f:
        json.dump(results, f)
    dist.destroy_process_group()


def _sp_staged(mesh) -> dict:
    """Calls and bytes each collective of the mesh's rings staged through
    host memory."""
    from ring_attention_tpu_torch.parallel import DistributedRing

    rings = [r for r in (mesh.ring, mesh.data_ring, mesh.ulysses_ring)
             if isinstance(r, DistributedRing)]
    return {op: [sum(r.staged_calls[op] for r in rings), sum(r.staged_bytes[op] for r in rings)]
            for op in ("rotate", "all_gather", "all_reduce", "all_to_all")}


def _sp_model_case(name: str, mesh, out_dir: str, tag) -> dict:
    """SP_CASES[name]'s model on ``mesh`` (a process's, or the VirtualRing
    mesh in the parent, ``tag == "ref"``): the forward's launches, staging,
    digest and ms; the loss; rank 0 and the reference save their logits."""
    import torch

    _, fields = SP_CASES[name]
    model = _model(torch.bfloat16, "cuda", mesh=mesh, **fields)
    tokens = _mp_tokens((1, SP_SEQ), 60)
    res = {}
    with torch.inference_mode():
        staged = _sp_staged(mesh)
        logits, res["forward"] = _mp_timed(lambda: model(tokens), mesh)
        # the staging of the first call alone: the timed calls repeat it
        res["forward"]["staged"] = {op: [(a - b) // (1 + MP_TIMED_CALLS) for a, b in
                                         zip(n, staged[op])]
                                    for op, n in _sp_staged(mesh).items()}
        res["forward"]["digest"] = _mp_digest(logits)
        if tag in (0, "ref"):
            torch.save(logits.cpu(), f"{out_dir}/sp_{name}_{tag}_logits.pt")
        del logits
        loss = model(_mp_tokens((1, SP_SEQ + 1), 61), return_loss=True)
        res["loss"] = loss.item()
        res["loss_digest"] = _mp_digest(loss)
    del model
    torch.cuda.empty_cache()
    return res


def _opt_bytes(opt) -> dict:
    """Bytes of the optimizer's state tensors, in all and on the device."""
    import torch

    state = [t for s in opt.state.values() for t in s.values() if torch.is_tensor(t)]
    return {"all": sum(t.numel() * t.element_size() for t in state),
            "device": sum(t.numel() * t.element_size() for t in state
                          if t.device.type == "cuda")}


ZERO_RUNS = {"plain": {}, "shard_opt_state": dict(shard_opt_state=True),
             "shard_opt_state + offload_opt_state": dict(shard_opt_state=True,
                                                         offload_opt_state=True)}


def _zero_case(mesh, out_dir: str, rank: int) -> dict:
    """Two Adam steps on data 2 x ring 2 (2 x 32,768 tokens), plain, with
    ``shard_opt_state=True`` and with ``offload_opt_state=True`` as well,
    from the same weights (the embedding frozen in all: its backward sums
    with atomics in no fixed order): each run's parameter digest, whether
    they equal the plain run's bit for bit, the optimizer state it holds
    and its step ms."""
    import torch

    from ring_attention_tpu_torch import make_train_step

    tokens = _mp_tokens((2, SP_SEQ // 2 + 1), 62)
    out, plain = {}, None
    for run, options in ZERO_RUNS.items():
        model = _model(torch.bfloat16, "cuda", mesh=mesh, impl="cuda").train()
        model.embed.weight.requires_grad_(False)
        opt = torch.optim.Adam([p for p in model.parameters() if p.requires_grad], lr=SP_LR)
        step = make_train_step(lambda t, m=model: m(t, return_loss=True), opt, mesh=mesh,
                               **options)
        _reset_counts()
        staged = _sp_staged(mesh)
        times = []
        for _ in range(2):
            start = time.perf_counter()
            step(tokens)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - start) * 1e3)
        flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
        staged = {op: [a - b for a, b in zip(n, staged[op])]
                  for op, n in _sp_staged(mesh).items()}
        out[run] = {"digest": _mp_digest(flat), "bytes": _opt_bytes(opt), "ms": times,
                    "counts": _read_counts(), "staged": staged,
                    "equal_plain": None if plain is None else bool(torch.equal(flat, plain))}
        if plain is None:
            plain = flat.clone()
        del model, opt, step
        torch.cuda.empty_cache()
    return out


def _sp_spawn(out_dir: str) -> list[dict]:
    """The SP_WORLD processes of phase 3p, joined within SP_JOIN_TIMEOUT_S;
    a process that fails or is still running fails the run."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_sp_worker, args=(r, f"{out_dir}/sp_store", out_dir))
             for r in range(SP_WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SP_JOIN_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    check(not hung, f"phase 3p: ranks {hung} still running after {SP_JOIN_TIMEOUT_S} s")
    codes = [p.exitcode for p in procs]
    check(codes == [0] * SP_WORLD, f"phase 3p: the processes exited with {codes}")
    results = []
    for r in range(SP_WORLD):
        with open(f"{out_dir}/sp{r}.json") as f:
            results.append(json.load(f))
    return results


def phase_sp_processes() -> dict:
    """Phase 3p: Ulysses (world 4) and the hybrid strategy (ulysses 2 x ring
    2) on four gloo processes sharing this card, each held to the same model
    on the VirtualRing mesh in this process; ZeRO-1 (``shard_opt_state``)
    over the data ring of a 2 x 2 mesh.  Returns the processes' launches."""
    import tempfile

    import torch

    from ring_attention_tpu_torch.parallel import create_mesh

    start = time.perf_counter()
    log(f"phase 3p: Ulysses over {SP_WORLD} processes and hybrid ulysses 2 x ring 2 over "
        f"{SP_WORLD} processes (spawn, gloo through a FileStore, every process on this card), "
        f"bench model at full width, bf16, 1 x {SP_SEQ}; then ZeRO-1 on data 2 x ring 2")
    launches = _counts()
    with tempfile.TemporaryDirectory() as out_dir:
        refs = {name: _sp_model_case(name, create_mesh(**SP_CASES[name][0]), out_dir, "ref")
                for name in ("ulysses 4", "hybrid 2x2")}
        procs = _sp_spawn(out_dir)
        for name, ref in refs.items():
            got = [p[name] for p in procs]
            summed = {k: sum(g["forward"]["counts"][k] for g in got) for k in COUNTERS}
            # each process attends its own heads (Ulysses) or its ulysses
            # index's outer ring (hybrid), the VirtualRing mesh all of them
            # folded into one launch
            folded = SP_WORLD if name.startswith("ulysses") else SP_HYBRID["ulysses_size"]
            want = {k: folded * v for k, v in ref["forward"]["counts"].items()}
            for k, v in summed.items():
                launches[k] += v
            digests = {g["forward"]["digest"] for g in got}
            logits = torch.load(f"{out_dir}/sp_{name}_0_logits.pt")
            ref_logits = torch.load(f"{out_dir}/sp_{name}_ref_logits.pt")
            same = bool(torch.equal(logits, ref_logits))
            rel = _rel_err(logits, ref_logits)
            losses = [g["loss"] for g in got]
            loss_same = all(g["loss_digest"] == ref["loss_digest"] for g in got)
            loss_rel = max(abs(x - ref["loss"]) for x in losses) / abs(ref["loss"])
            # Ulysses' processes sum their four shares in one all-reduce and
            # give the VirtualRing model's loss bit for bit; the hybrid's sum
            # over the ulysses group, then the ring, another order than the
            # VirtualRing model's one sum: its last bits may differ
            exact = name.startswith("ulysses")
            staged = got[0]["forward"]["staged"]
            log(f"  {name}: launches per process and layer "
                f"{[_per_layer(g['forward']['counts']) for g in got]}, summed "
                f"{_nonzero(summed)} (the VirtualRing mesh's x {folded}); logits on every "
                f"process one digest {len(digests) == 1}, bit-identical to the VirtualRing "
                f"model's {same} (||diff|| / ||ref|| {rel:.3e}); losses {losses} vs the "
                f"VirtualRing model {ref['loss']:.7f}, bit for bit {loss_same} (rel "
                f"{loss_rel:.2e}, tol {'bit for bit' if exact else MP_LOSS_REL_TOL}); rank 0 staged "
                f"through the host in one forward (calls, bytes): all_to_all "
                f"{staged['all_to_all']}, all_gather {staged['all_gather']}, rotate "
                f"{staged['rotate']}; forward ms {[round(g['forward']['ms'], 1) for g in got]} "
                f"(VirtualRing {ref['forward']['ms']:.1f})")
            check(summed == want, f"{name}: the processes launched {_nonzero(summed)}, "
                  f"expected {_nonzero(want)}")
            check(len(digests) == 1 and same, f"{name}: logits on the processes differ from "
                  "the VirtualRing model's")
            loss_ok = loss_same if exact else loss_rel <= MP_LOSS_REL_TOL
            check(len(set(losses)) == 1 and loss_ok,
                  f"{name}: the processes' loss disagrees with the VirtualRing model's")
        zero = [p["zero"] for p in procs]
        for run in ZERO_RUNS:
            rows = [z[run] for z in zero]
            digests = {r["digest"] for r in rows}
            for r in rows:
                for k, v in r["counts"].items():
                    launches[k] += v
            log(f"  ZeRO-1 {run}: 2 Adam steps (embedding frozen), parameters one digest on "
                f"every process {len(digests) == 1}, equal to the plain steps' bit for bit "
                f"{[r['equal_plain'] for r in rows]}; optimizer state a process holds "
                f"{[r['bytes']['all'] for r in rows]} B ({[r['bytes']['device'] for r in rows]} "
                f"on the device between steps); step ms {[[round(t, 1) for t in r['ms']] for r in rows]}; "
                f"rank 0 all_gather staged (calls, bytes) {rows[0]['staged']['all_gather']}")
            check(len(digests) == 1, f"ZeRO-1 {run}: the processes' parameters differ")
            if run != "plain":
                check(all(r["equal_plain"] for r in rows),
                      f"ZeRO-1 {run}: parameters differ from the plain steps'")
                for r, p in zip(rows, (z["plain"] for z in zero)):
                    half = p["bytes"]["all"] // 2
                    check(half - 4096 <= r["bytes"]["all"] <= half + 4096,
                          f"ZeRO-1 {run}: a process holds {r['bytes']['all']} B of state, "
                          f"not half of {p['bytes']['all']}")
            if "offload" in run:
                check(all(r["bytes"]["device"] == 0 for r in rows),
                      "ZeRO-1 with offload: optimizer state left on the device")
    log(f"  phase 3p took {time.perf_counter() - start:.1f} s")
    return {"launches": launches}


class _KernelClock:
    """CUDA events around every launch of B1, B2, B3, B7 and B8 while
    active (the ctypes entries of their cached libraries wrapped): the sum
    of the launches' device time, read after a synchronize."""

    ENTRIES = (("flash_fwd_library", "flash_fwd"), ("flash_bwd_library", "flash_bwd_dkv"),
               ("flash_bwd_library", "flash_bwd_dq"), ("flash_ring_library", "flash_ring"),
               ("flash_ring_remote_library", "flash_ring_remote"))

    def __enter__(self):
        import torch

        from ring_attention_tpu_torch.ops import _build

        self.events, self.saved = [], []
        for library, entry in self.ENTRIES:
            lib = getattr(_build, library)()
            fn = getattr(lib, entry)

            def timed(*args, fn=fn):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                rc = fn(*args)
                end.record()
                self.events.append((start, end))
                return rc

            self.saved.append((lib, entry, fn))
            setattr(lib, entry, timed)
        return self

    def __exit__(self, *exc):
        for lib, entry, fn in self.saved:
            setattr(lib, entry, fn)

    def ms(self) -> float:
        import torch

        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


def phase_sp_timings(sp: dict, ring: dict, serving: dict, training: dict) -> None:
    """Phase 4l: the forward and the Adam step at 1 x 65,536 of Ulysses of
    4, hybrid 2 x 2 (scan and fused), the local model and the scan ring of
    4, in turns; beside each, its attention kernels' device time (CUDA
    events around every B1, B2, B3, B7 and B8 launch of one forward and one
    step) and the peak memory above live."""
    import torch

    from ring_attention_tpu_torch import make_train_step

    start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"phase 4l: Ulysses and hybrid beside the local model and the scan ring of 4, 1 x "
        f"{SP_SEQ}, bf16 ({smi}); forward: CUDA events, median of 10 after 2 warm-up, in turns; "
        f"Adam step: host clock around synchronized steps, one warm-up each, then in turns")
    tokens, step_tokens = serving["tokens"], training["tokens"]
    models = {"local": serving["model"], "ring 4 (scan)": ring["models"]["contiguous"][0],
              "ulysses 4": sp["models"]["ulysses 4"], "hybrid 2x2": sp["models"]["hybrid 2x2"],
              "hybrid 2x2 fused": sp["models"]["hybrid 2x2 fused"]}
    for model in models.values():
        model.eval()

    def forward(m):
        def run():
            with torch.inference_mode():
                m(tokens)
        return run

    fwd_ms = _time_turns({name: forward(m) for name, m in models.items()})
    kernel_fwd = {}
    for name, model in models.items():
        with _KernelClock() as clock, torch.inference_mode():
            model(tokens)
        kernel_fwd[name] = clock.ms()
    for model in models.values():
        model.train()
    names = list(models)
    steps = _time_knob_steps(models, step_tokens, 2 * (names + names[::-1]))
    kernel_step = {}
    for name, model in models.items():
        opt = torch.optim.SGD(model.parameters(), lr=0.0)
        step = make_train_step(lambda t, m=model: m(t, return_loss=True), opt)
        with _KernelClock() as clock:
            step(step_tokens)
        kernel_step[name] = clock.ms()
    for name in models:
        row = steps[name]
        step_ms = statistics.median(row["ms"])
        log(f"  {name}: forward {fwd_ms[name]:.3f} ms ({SP_SEQ / fwd_ms[name] * 1e3:.0f} "
            f"tokens/s), its B1/B7/B8 launches {kernel_fwd[name]:.3f} ms of it "
            f"({kernel_fwd[name] / fwd_ms[name]:.1%}); Adam step {step_ms:.1f} ms (median of "
            f"{len(row['ms'])}: {[round(x, 1) for x in row['ms']]}), its B1/B2/B3/B7/B8 "
            f"launches {kernel_step[name]:.3f} ms, peak {row['above'] / 2**30:.3f} GiB above "
            f"live; step launches {_nonzero(row['counts'])}")
        check(all(math.isfinite(x) for x in row["losses"]), f"{name}: losses {row['losses']}")
    log(f"  phase 4l took {time.perf_counter() - start:.1f} s")


# ---------------------------------------------------------------------------
# Phases 2k, 3q, 3r and 4m: the ring variants (bidirectional half-streams,
# counter-rotation, dkv_dtype) and process-local batches
# ---------------------------------------------------------------------------

VARIANT_N_LOCAL = 4096
# Launches per layer on the contiguous causal ring of 4 (seed, resume,
# fused_carry, dkv, dq).  The counter-rotated ring pairs the unidirectional
# ring's blocks hop for hop: RING_SCHEDULE.  The half-streams run 8 spans a
# rank: the forward stream's hop i on ranks >= i, the reverse stream's hop
# 0 on every rank and hop i on ranks >= 4 - i; the last span (the reverse
# stream's hop 3) fuses on ranks 1-3, rank 0 finalizes on the host.
BIDIR_SCHEDULE = (4, 13, 3, 20, 20)
# name: model fields, on the bench model on a virtual ring of 4
VARIANT_MODELS = {
    "counter": dict(ring_counter_rotate=True),
    "bidirectional": dict(ring_bidirectional=True),
    "dkv bf16": dict(ring_dkv_dtype="bfloat16"),
}
# dk/dv rounded to bf16 a hop: tests/test_ring.py::test_ring_dkv_bf16_circulation
DKV_BF16_REL_TOL = 2e-2
VARIANT_WORLD = 4
VARIANT_JOIN_TIMEOUT_S = 480
# phase 3r's cases on a DistributedRing of the four processes: name ->
# model fields (held to the VirtualRing mesh's logits bit for bit)
VARIANT_MP_CASES = {
    "counter": dict(impl="cuda", striped=True, ring_counter_rotate=True),
    "bidirectional": dict(impl="cuda", ring_bidirectional=True),
    "counter int8 wire": dict(impl="cuda", ring_counter_rotate=True,
                              ring_hop_compression="int8"),
}
BATCH_LR = 1e-3
VARIANT_INT8_N = 16384


class _PlainKernels:
    """While active, ``parallel/ring.py``'s kernel wrappers are their plain
    versions on the card's tensors (``flash_partials_reference``,
    ``flash_fwd_reference``, their int8 forms under int8 compute, and
    ``flash_bwd_reference``): the same hop schedule, each span computed by
    the plain version, so that a ring function's result is its plain
    version's on the same inputs."""

    def __enter__(self):
        from ring_attention_tpu_torch.ops import cuda_flash as cf
        from ring_attention_tpu_torch.ops import cuda_flash_q8 as q8
        from ring_attention_tpu_torch.parallel import ring as pring

        def plain(fwd_q8, fwd):
            def run(q, k, v, mask=None, *, out=None, compute_dtype=None, block_k=None,
                    kv_quantized=None, **band):
                if compute_dtype == "int8":
                    res = fwd_q8(q, k, v, mask, block_k=block_k, kv_quantized=kv_quantized,
                                 **band)
                else:
                    res = fwd(q, k, v, mask, **band)
                if out is None:
                    return res
                for dst, src in zip(out, res):
                    dst.copy_(src)
                return out
            return run

        self.ring = pring
        self.saved = {name: getattr(pring, name)
                      for name in ("flash_partials", "flash_fwd", "flash_bwd")}
        pring.flash_partials = plain(q8.flash_partials_q8_reference, cf.flash_partials_reference)
        pring.flash_fwd = plain(q8.flash_fwd_q8_reference, cf.flash_fwd_reference)
        pring.flash_bwd = cf.flash_bwd_reference
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.ring, name, fn)


def _variant_cfg(n_local, striped, **knobs) -> dict:
    """The ring's configuration of a causal ring of 4 on the CUDA kernels,
    as ``ring_flash_attention`` builds it (the bench model's bucket)."""
    import torch

    cfg = dict(impl="cuda", causal=True, striped=striped,
               bucket_size=BENCH_MODEL["bucket_size"], passes=RING_SIZE, window=None,
               softclamp_value=None, scale=0.125, compute_dtype=None, hop_compression=None,
               streams=[(1, 0, n_local)], counter_rotate=False, dkv_dtype=torch.float32)
    cfg.update(knobs)
    return cfg


def _hold_q8(name, out, ref, lse, ref_lse, errors) -> None:
    """An int8 ring's output and lse against its plain version (Q8_REL_TOL,
    Q8_LSE_TOL)."""
    rel = _rel_err(out, ref)
    lse_err = (lse - ref_lse).abs().max().item()
    errors.append((out.float() - ref.float()).abs().max().item())
    log(f"  {name:<44} ||out-plain||/||plain|| {rel:.3e} (tol "
        f"{Q8_REL_TOL['torch.bfloat16']}), max|lse-plain| {lse_err:.3e} (tol {Q8_LSE_TOL})")
    check(rel <= Q8_REL_TOL["torch.bfloat16"] and lse_err <= Q8_LSE_TOL,
          f"{name}: the int8 ring disagrees with its plain version")


def phase_variants_vs_plain() -> dict:
    """Phase 2k: the kernels on the ring variants' call shapes against
    their plain versions, every rank of a causal ring of 4 at n_local
    4,096, contiguous and striped, bf16 and f32: B1's seed, resume and
    fused modes and B2/B3 on the bidirectional half-streams (spans of
    2,048 keys, bands shifted by -2,048 on the reverse stream, its
    wrapped hops unmasked) and on the counter-rotated schedule (the carry
    unpacked from the f32 ``[q | acc | m | l]`` pack); B4 fed per-stream
    blobs (the int8 wire and compute on the half-streams) and on the
    counter schedule.  Returns the largest |kernel - plain| of B1, B2, B3
    and B4."""
    import torch

    from ring_attention_tpu_torch.parallel import VirtualRing
    from ring_attention_tpu_torch.parallel import ring as pring

    n = VARIANT_N_LOCAL
    gen = torch.Generator(device="cuda").manual_seed(SEED + 70)
    ring = VirtualRing(RING_SIZE)
    errors: dict[str, list[float]] = {"fwd": [], "q8": []}
    log(f"phase 2k: the ring variants' call shapes vs the plain versions, a causal ring of "
        f"{RING_SIZE} at n_local {n}: half-streams of {n // 2} keys and the counter-rotated "
        f"schedule")
    schedules = {"bidirectional": dict(streams=pring._streams(True, n)),
                 "counter": dict(counter_rotate=True)}
    for dtype in (torch.bfloat16, torch.float32):
        for striped in (False, True):
            layout = "striped" if striped else "contiguous"
            q, do = (_rand(gen, (1, 8, RING_SIZE * n, 64), dtype) for _ in range(2))
            k, v = (_rand(gen, (1, 8, RING_SIZE * n, 64), dtype) for _ in range(2))
            qs, ks, vs, dos = ([c.contiguous() for c in x.chunk(RING_SIZE, dim=2)]
                               for x in (q, k, v, do))
            for label, knobs in schedules.items():
                cfg = _variant_cfg(n, striped, **knobs)
                fwd = pring._counter_fwd if cfg["counter_rotate"] else pring._ring_fwd_cuda
                outs, lses = fwd(qs, ks, vs, None, None, None, ring, cfg)
                torch.cuda.synchronize()
                with _PlainKernels():
                    ref_outs, ref_lses = fwd(qs, ks, vs, None, None, None, ring, cfg)
                _compare(f"{label} {layout} (B1)", dtype, torch.cat(outs, 2),
                         torch.cat(ref_outs, 2), torch.cat(lses, 2), torch.cat(ref_lses, 2),
                         errors["fwd"], rel_tol=RING_REL_TOL[str(dtype)])
                got = pring._ring_bwd(dos, qs, ks, vs, None, None, None, outs, lses, ring, cfg)
                torch.cuda.synchronize()
                with _PlainKernels():
                    ref = pring._ring_bwd(dos, qs, ks, vs, None, None, None, outs, lses, ring,
                                          cfg)
                _compare_bwd(f"{label} {layout} (B2, B3)", dtype,
                             [torch.cat(x, 2) for x in got], [torch.cat(x, 2) for x in ref],
                             errors)
                del outs, lses, ref_outs, ref_lses, got, ref
            if dtype != torch.bfloat16:
                continue
            for label, knobs in schedules.items():
                for wire in ("int8", None):
                    cfg = _variant_cfg(n, striped, compute_dtype="int8", hop_compression=wire,
                                       **knobs)
                    fwd = pring._counter_fwd if cfg["counter_rotate"] else pring._ring_fwd_cuda
                    outs, lses = fwd(qs, ks, vs, None, None, None, ring, cfg)
                    torch.cuda.synchronize()
                    with _PlainKernels():
                        ref_outs, ref_lses = fwd(qs, ks, vs, None, None, None, ring, cfg)
                    _hold_q8(f"{label} {layout} int8, wire {wire} (B4 fed)",
                             torch.cat(outs, 2), torch.cat(ref_outs, 2), torch.cat(lses, 2),
                             torch.cat(ref_lses, 2), errors["q8"])
            del q, k, v, do, qs, ks, vs, dos
    torch.cuda.empty_cache()
    return {label: max(errs) for label, errs in errors.items()}


def _variant_step(model, tokens) -> dict:
    """``_knob_step`` with the embedding frozen (its backward sums each
    row's gradient with atomics, in no fixed order: phase 3n), so that two
    steps can be compared bit for bit."""
    model.embed.weight.requires_grad_(False)
    try:
        return _knob_step(model, tokens)
    finally:
        model.embed.weight.requires_grad_(True)


def phase_variants_path(serving: dict, training: dict) -> dict:
    """Phase 3q: the ring variants on the bench model at full width on a
    virtual ring of 4 (1 x 65,536, bf16), each against the unidirectional
    ring model with the same weights: the counter-rotated model (logits,
    loss and gradients expected bit for bit: hop i runs the same launch on
    the same blocks), the bidirectional one (within the ring's bf16
    bounds), ``ring_dkv_dtype="bfloat16"`` (gradients within 2e-2), the
    counter-rotated int8 ring (wire and compute: the unidirectional int8
    ring's logits bit for bit, within Q8_FWD_REL_L2 of the bf16 local
    model) and the hybrid 2 x 2 with its outer ring counter-rotated; exact
    launch counts.  Returns the launches and the models (for phase 4m)."""
    import torch

    from ring_attention_tpu_torch.parallel import create_mesh

    start = time.perf_counter()
    depth = BENCH_MODEL["depth"]
    tokens, step_tokens = serving["tokens"], training["tokens"]
    log(f"phase 3q: the ring variants on a virtual ring of {RING_SIZE}, bench model at full "
        f"width, bf16, 1 x {tokens.shape[1]}: {list(VARIANT_MODELS)}, the counter-rotated "
        f"int8 ring and the counter-rotated hybrid 2 x 2, each against its unidirectional "
        f"model with the same weights (embedding frozen in the gradient steps)")
    launches = _counts()
    uni = _model(torch.bfloat16, "cuda", mesh=create_mesh(ring_size=RING_SIZE), impl="cuda")
    with torch.inference_mode():
        ref = uni(tokens)
    uni.train()
    ref_step = _variant_step(uni, step_tokens)
    again = _variant_step(uni, step_tokens)
    uni.eval()
    names = [name for name, p in uni.named_parameters() if name != "embed.weight"]
    _, _, _, rerun_differ = _against(again, ref_step, names)
    log(f"  the unidirectional ring model's step run twice: leaves that differ: "
        f"{rerun_differ}")
    seed, resume, fused, dkv, dq = (x * depth for x in BIDIR_SCHEDULE)
    bidir = _counts(flash_fwd=seed + resume + fused, seed=seed, resume=resume,
                    fused_carry=fused, flash_bwd_dkv=dkv, flash_bwd_dq=dq)
    expected = {"counter": (_ring_counts(False, backward=False), _ring_counts(False, True)),
                "bidirectional": ({k: v if k not in ("flash_bwd_dkv", "flash_bwd_dq") else 0
                                   for k, v in bidir.items()}, bidir),
                "dkv bf16": (_ring_counts(False, backward=False), _ring_counts(False, True))}
    models = {"ring 4 (scan)": uni}
    for name, fields in VARIANT_MODELS.items():
        model = _model(torch.bfloat16, "cuda", mesh=create_mesh(ring_size=RING_SIZE),
                       impl="cuda", **fields)
        with torch.inference_mode():
            _reset_counts()
            logits = model(tokens)
            torch.cuda.synchronize()
            counts = _read_counts()
        same = bool(torch.equal(logits, ref))
        rel = _rel_err(logits, ref)
        max_diff = (logits.float() - ref.float()).abs().max().item()
        del logits
        model.train()
        res = _variant_step(model, step_tokens)
        model.eval()
        loss_rel, grad_rel, leaf, differ = _against(res, ref_step, names)
        log(f"  {name}: forward launches {_nonzero(counts)}; logits vs the unidirectional "
            f"ring model bit for bit {same} (||diff|| / ||ring|| {rel:.3e}, max|diff| "
            f"{max_diff:.3e}); loss {res['loss'].item():.6f} vs {ref_step['loss'].item():.6f} "
            f"(rel {loss_rel:.2e}), worst gradient leaf {grad_rel:.2e} ({leaf}), leaves that "
            f"differ: {differ}; loss and backward launches {_nonzero(res['counts'])}, peak "
            f"{res['above'] / 2**30:.3f} GiB above live")
        for got, want in ((counts, expected[name][0]), (res["counts"], expected[name][1])):
            check(got == want, f"{name}: launched {_nonzero(got)}, expected {_nonzero(want)}")
            for key, c in got.items():
                launches[key] += c
        check(rel <= RING_LOGITS_REL_TOL, f"{name}: logits off the unidirectional ring")
        if name == "dkv bf16":
            check(same and loss_rel == 0.0 and grad_rel <= DKV_BF16_REL_TOL,
                  f"{name}: gradients off the float32 accumulators' beyond {DKV_BF16_REL_TOL}")
        else:
            check(loss_rel <= SP_LOSS_REL_TOL and grad_rel <= SP_GRAD_REL_TOL,
                  f"{name}: loss or gradients off the unidirectional ring")
        models[name] = model
        del res
    torch.cuda.empty_cache()
    # the counter-rotated int8 ring (JAX counter_q8): every hop's B4 fed the
    # payload's bytes, the carry travelling in the f32 pack
    q8 = {counter: _int8_ring_model("q8", ring_counter_rotate=counter)
          for counter in (False, True)}
    seed, resume, fused, _, _ = (x * depth for x in RING_SCHEDULE[False])
    want = _counts(flash_fwd_q8=seed + resume + fused, q8_seed=seed, q8_resume=resume,
                   q8_fused_carry=fused, feed_flash_fwd_q8=seed + resume + fused)
    with torch.inference_mode():
        # a fresh local model: phase 4l's timed Adam steps moved the serving model's weights
        local = _model(torch.bfloat16, "cuda")(tokens)
        q8_logits = {}
        for counter, model in q8.items():
            _reset_counts()
            q8_logits[counter] = model(tokens)
            torch.cuda.synchronize()
            counts = _read_counts()
            check(counts == want, f"int8 ring, counter-rotated {counter}: launched "
                  f"{_nonzero(counts)}, expected {_nonzero(want)}")
            for key, c in counts.items():
                launches[key] += c
    same = bool(torch.equal(q8_logits[True], q8_logits[False]))
    rel = _rel_err(q8_logits[True], local)
    log(f"  counter int8 ring (ring_hop_compression='int8', compute_dtype='int8'): launches "
        f"{_nonzero(counts)} (as the unidirectional int8 ring's); logits bit for bit the "
        f"unidirectional int8 ring's {same} (||diff|| / ||ring|| "
        f"{_rel_err(q8_logits[True], q8_logits[False]):.3e}); vs the bf16 local model "
        f"{rel:.3e} (tol {Q8_FWD_REL_L2})")
    check(rel <= Q8_FWD_REL_L2, "counter int8 ring logits off the bf16 local model")
    check(_rel_err(q8_logits[True], q8_logits[False]) <= RING_LOGITS_REL_TOL,
          "counter int8 ring logits off the unidirectional int8 ring")
    del q8, q8_logits, local
    # the hybrid's outer ring counter-rotated
    hybrid = {counter: _model(torch.bfloat16, "cuda", mesh=create_mesh(**SP_HYBRID),
                              sequence_parallel="hybrid", impl="cuda",
                              ring_counter_rotate=counter) for counter in (False, True)}
    want = _sp_counts("hybrid 2x2", backward=False)
    with torch.inference_mode():
        hyb_logits = {}
        for counter, model in hybrid.items():
            _reset_counts()
            hyb_logits[counter] = model(tokens)
            torch.cuda.synchronize()
            counts = _read_counts()
            check(counts == want, f"hybrid, counter-rotated {counter}: launched "
                  f"{_nonzero(counts)}, expected {_nonzero(want)}")
            for key, c in counts.items():
                launches[key] += c
    same = bool(torch.equal(hyb_logits[True], hyb_logits[False]))
    log(f"  hybrid 2x2 with its outer ring counter-rotated: launches {_nonzero(counts)}; "
        f"logits bit for bit the hybrid's {same} (||diff|| / ||hybrid|| "
        f"{_rel_err(hyb_logits[True], hyb_logits[False]):.3e})")
    check(_rel_err(hyb_logits[True], hyb_logits[False]) <= RING_LOGITS_REL_TOL,
          "counter hybrid logits off the hybrid's")
    del hybrid, hyb_logits
    torch.cuda.empty_cache()
    log(f"  phase 3q took {time.perf_counter() - start:.1f} s")
    return {"launches": launches, "models": models}


def _recording_rotations(ring) -> list:
    """Record, on ``ring`` (a DistributedRing), each rotation's shift and
    the bytes of the payload it sends; returns the record."""
    record = []
    rotate = ring.rotate

    def recorded(payloads, shift):
        record.append((shift, sum(x.numel() * x.element_size() for x in payloads[0])))
        return rotate(payloads, shift)

    ring.rotate = recorded
    return record


def _variant_mp_case(name: str, mesh, out_dir: str, tag) -> dict:
    """VARIANT_MP_CASES[name]'s model on ``mesh``: the forward's launches,
    digest, ms, each rotation (shift, bytes) and the bytes staged through
    the host; rank 0 and the reference save their logits."""
    import torch

    model = _model(torch.bfloat16, "cuda", mesh=mesh, **VARIANT_MP_CASES[name])
    tokens = _mp_tokens((1, SP_SEQ), 70)
    record = [] if tag == "ref" else _recording_rotations(mesh.ring)
    res = {}
    with torch.inference_mode():
        staged = _sp_staged(mesh)
        logits, res["forward"] = _mp_timed(lambda: model(tokens), mesh)
        calls = 1 + MP_TIMED_CALLS
        res["forward"]["rotations"] = record[:len(record) // calls]
        res["forward"]["staged"] = {op: [(a - b) // calls for a, b in zip(n, staged[op])]
                                    for op, n in _sp_staged(mesh).items()}
        res["forward"]["digest"] = _mp_digest(logits)
        if tag in (0, "ref"):
            torch.save(logits.cpu(), f"{out_dir}/var_{name}_{tag}_logits.pt")
    if tag != "ref":
        del mesh.ring.rotate
    del model, logits
    torch.cuda.empty_cache()
    return res


def _batch_case(mesh, rank: int) -> dict:
    """Process-local batches on data 2 x ring 2 (2 x 32,768 tokens): one SGD
    step of the model with ``auto_shard=True`` on the global batch and one
    with ``auto_shard=False`` on ``shard_batch`` of this process's row (its
    seq block and one token of overlap), from the same weights (embedding
    frozen): each one's parameter digest, whether they are equal bit for
    bit, the block's logits against the global ones', the losses and the
    launches."""
    import torch

    from ring_attention_tpu_torch import make_train_step
    from ring_attention_tpu_torch.parallel import shard_batch

    tokens = _mp_tokens((2, SP_SEQ // 2 + 1), 71)
    row = tokens[mesh.data_rank:mesh.data_rank + 1]
    part = shard_batch(row, mesh, overlap=1)
    out, flats = {"part_shape": list(part.shape)}, {}
    for auto in (True, False):
        model = _model(torch.bfloat16, "cuda", mesh=mesh, impl="cuda", auto_shard=auto).train()
        model.embed.weight.requires_grad_(False)
        with torch.inference_mode():
            logits = model(tokens[:, :-1] if auto else part[:, :-1])
        if auto:
            logits = shard_batch(logits[mesh.data_rank:mesh.data_rank + 1], mesh)
        opt = torch.optim.SGD([p for p in model.parameters() if p.requires_grad], lr=BATCH_LR)
        step = make_train_step(lambda t, m=model: m(t, return_loss=True), opt, mesh=mesh)
        _reset_counts()
        loss = float(step(tokens if auto else part))
        torch.cuda.synchronize()
        tag = "auto" if auto else "local"
        flats[tag] = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
        out[tag] = {"digest": _mp_digest(flats[tag]), "loss": loss, "counts": _read_counts(),
                    "logits_digest": _mp_digest(logits)}
        del model, opt, step, logits
        torch.cuda.empty_cache()
    out["equal"] = bool(torch.equal(flats["auto"], flats["local"]))
    return out


def _variant_worker(rank: int, store_path: str, out_dir: str) -> None:
    """One process of phase 3r: the variants on the ring of 4, then the
    process-local batches on data 2 x ring 2; results to ``var<rank>.json``."""
    import torch
    import torch.distributed as dist

    from ring_attention_tpu_torch.parallel import create_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, VARIANT_WORLD),
                            rank=rank, world_size=VARIANT_WORLD)
    meshes = {"ring": create_mesh(), "batch": create_mesh(ring_size=2, data_size=2)}
    results = {name: _variant_mp_case(name, meshes["ring"], out_dir, rank)
               for name in VARIANT_MP_CASES}
    results["batch"] = _batch_case(meshes["batch"], rank)
    with open(f"{out_dir}/var{rank}.json", "w") as f:
        json.dump(results, f)
    dist.destroy_process_group()


def _hop_bytes(b, h, hk, chunk, d) -> dict:
    """JAX's ``hop_bytes`` of the counter-rotated ring with the int8 wire
    (``analysis/contracts.py:80-175``): the compressed KV handle and the
    f32 q pack; beside them the f32 ``[out | lse]`` catch-up."""
    return {"kv handle": 2 * b * hk * chunk * (d + 4), "q pack": 4 * b * h * chunk * (2 * d + 2),
            "catch-up": 4 * b * h * chunk * (d + 1)}


def phase_variants_processes() -> dict:
    """Phase 3r: the counter-rotated and bidirectional models on four gloo
    processes sharing this card (a DistributedRing of 4), their logits held
    to the VirtualRing mesh's bit for bit, each rotation's bytes to JAX's
    ``hop_bytes``; then process-local batches (``shard_batch`` feeding
    ``auto_shard=False``) on data 2 x ring 2, the parameters after a step
    held to the ``auto_shard=True`` step's bit for bit.  Returns the
    processes' launches."""
    import multiprocessing
    import tempfile

    import torch

    from ring_attention_tpu_torch.parallel import create_mesh

    start = time.perf_counter()
    log(f"phase 3r: {list(VARIANT_MP_CASES)} on {VARIANT_WORLD} gloo processes (spawn, every "
        f"process on this card), bench model at full width, bf16, 1 x {SP_SEQ}; then "
        f"process-local batches on data 2 x ring 2")
    launches = _counts()
    with tempfile.TemporaryDirectory() as out_dir:
        refs = {name: _variant_mp_case(name, create_mesh(ring_size=VARIANT_WORLD), out_dir,
                                       "ref") for name in VARIANT_MP_CASES}
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_variant_worker, args=(r, f"{out_dir}/var_store", out_dir))
                 for r in range(VARIANT_WORLD)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + VARIANT_JOIN_TIMEOUT_S
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        check(not hung, f"phase 3r: ranks {hung} still running after {VARIANT_JOIN_TIMEOUT_S} s")
        codes = [p.exitcode for p in procs]
        check(codes == [0] * VARIANT_WORLD, f"phase 3r: the processes exited with {codes}")
        got = []
        for r in range(VARIANT_WORLD):
            with open(f"{out_dir}/var{r}.json") as f:
                got.append(json.load(f))
        chunk = SP_SEQ // VARIANT_WORLD
        formulas = _hop_bytes(1, BENCH_MODEL["heads"], BENCH_MODEL["heads"], chunk,
                              BENCH_MODEL["dim_head"])
        # a half-stream's k and v halves, bf16 (the bench model has no GQA)
        half_kv = 2 * BENCH_MODEL["heads"] * (chunk // 2) * BENCH_MODEL["dim_head"] * 2
        for name, ref in refs.items():
            rows = [g[name]["forward"] for g in got]
            summed = {k: sum(r["counts"][k] for r in rows) for k in COUNTERS}
            for k, v in summed.items():
                launches[k] += v
            logits = torch.load(f"{out_dir}/var_{name}_0_logits.pt")
            ref_logits = torch.load(f"{out_dir}/var_{name}_ref_logits.pt")
            same = bool(torch.equal(logits, ref_logits))
            digests = {r["digest"] for r in rows}
            rotations = rows[0]["rotations"]
            staged = rows[0]["staged"]["rotate"]
            sent = sum(nbytes for _, nbytes in rotations)
            log(f"  {name}: launches summed over the processes {_nonzero(summed)} (the "
                f"VirtualRing mesh's {_nonzero(ref['forward']['counts'])}); logits one digest "
                f"on every process {len(digests) == 1}, bit-identical to the VirtualRing "
                f"mesh's {same} (||diff|| / ||ref|| {_rel_err(logits, ref_logits):.3e}); rank "
                f"0's rotations in one forward (shift, bytes) {rotations}; staged through the "
                f"host (calls, bytes) {staged} (twice the bytes sent {2 * sent}); forward ms "
                f"{[round(r['ms'], 1) for r in rows]} (VirtualRing {ref['forward']['ms']:.1f})")
            check(summed == ref["forward"]["counts"], f"{name}: the processes launched "
                  f"{_nonzero(summed)}, the VirtualRing mesh {_nonzero(ref['forward']['counts'])}")
            check(len(digests) == 1 and same, f"{name}: logits on the processes differ from "
                  "the VirtualRing mesh's")
            check(staged[1] == 2 * sent, f"{name}: staged {staged[1]} B for {sent} B sent")
            depth = BENCH_MODEL["depth"]
            if name == "counter int8 wire":
                want = [(-1, formulas["q pack"]), (1, formulas["kv handle"]),
                        (-1, formulas["q pack"]), (2, formulas["catch-up"])] * depth
                log(f"    JAX hop_bytes (analysis/contracts.py counter_compressed): kv handle "
                    f"2*b*hk*chunk*(d+4) = {formulas['kv handle']}, q pack "
                    f"4*b*h*chunk*(2d+2) = {formulas['q pack']}; the [out | lse] catch-up "
                    f"4*b*h*chunk*(d+1) = {formulas['catch-up']}")
                check([tuple(x) for x in rotations] == want,
                      f"{name}: rotations {rotations}, expected {want}")
            elif name == "bidirectional":
                want = [(1, half_kv), (-1, half_kv)] * (VARIANT_WORLD - 1) * depth
                check([tuple(x) for x in rotations] == want,
                      f"{name}: rotations {rotations}, expected {want}")
        batch = [g["batch"] for g in got]
        for row in batch:
            for tag in ("auto", "local"):
                for k, v in row[tag]["counts"].items():
                    launches[k] += v
        digests = {row[tag]["digest"] for row in batch for tag in ("auto", "local")}
        losses = [(row["auto"]["loss"], row["local"]["loss"]) for row in batch]
        log(f"  process-local batches (data 2 x ring 2, 2 x {SP_SEQ // 2} tokens): each "
            f"process's shard_batch part {[row['part_shape'] for row in batch]}; after one SGD "
            f"step the auto_shard=False parameters equal the auto_shard=True ones bit for bit "
            f"{[row['equal'] for row in batch]}, one digest on every process "
            f"{len(digests) == 1}; block logits equal the global logits' block "
            f"{[row['auto']['logits_digest'] == row['local']['logits_digest'] for row in batch]}; "
            f"losses (auto, local) {losses}")
        check(all(row["equal"] for row in batch) and len(digests) == 1,
              "process-local batches: the parameters differ from the auto_shard=True step's")
        check(all(row["auto"]["logits_digest"] == row["local"]["logits_digest"]
                  for row in batch), "process-local batches: block logits differ")
    log(f"  phase 3r took {time.perf_counter() - start:.1f} s")
    return {"launches": launches}


def phase_variants_timings(variants: dict, serving: dict, training: dict) -> None:
    """Phase 4m: the forward (CUDA events, in turns) and the Adam step (host
    clock around synchronized steps, in turns) at 1 x 65,536 of the
    counter-rotated, bidirectional and ``ring_dkv_dtype="bfloat16"`` models
    beside the unidirectional scan ring, each with its attention kernels'
    device time (CUDA events around every B1, B2 and B3 launch of one
    forward and one step); then one layer's counter-rotated int8 ring
    (wire and compute) at n_local 16,384 beside the unidirectional int8
    ring (bench.py phase 4d's counterpart), in turns."""
    import torch

    from ring_attention_tpu_torch.parallel import VirtualRing, ring_flash_attention

    start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"phase 4m: the ring variants beside the scan ring of {RING_SIZE}, 1 x {SP_SEQ}, bf16 "
        f"({smi}); forward: CUDA events, median of 10 after 2 warm-up, in turns; Adam step: "
        f"host clock around synchronized steps, one warm-up each, then in turns")
    tokens, step_tokens = serving["tokens"], training["tokens"]
    models = variants["models"]
    for model in models.values():
        model.eval()

    def forward(m):
        def run():
            with torch.inference_mode():
                m(tokens)
        return run

    fwd_ms = _time_turns({name: forward(m) for name, m in models.items()})
    kernel_fwd = {}
    for name, model in models.items():
        with _KernelClock() as clock, torch.inference_mode():
            model(tokens)
        kernel_fwd[name] = clock.ms()
    for model in models.values():
        model.train()
    names = list(models)
    steps = _time_knob_steps(models, step_tokens, 2 * (names + names[::-1]))
    kernel_step = {}
    from ring_attention_tpu_torch import make_train_step

    for name, model in models.items():
        opt = torch.optim.SGD(model.parameters(), lr=0.0)
        step = make_train_step(lambda t, m=model: m(t, return_loss=True), opt)
        with _KernelClock() as clock:
            step(step_tokens)
        kernel_step[name] = clock.ms()
    for name in models:
        row = steps[name]
        step_ms = statistics.median(row["ms"])
        log(f"  {name}: forward {fwd_ms[name]:.3f} ms ({SP_SEQ / fwd_ms[name] * 1e3:.0f} "
            f"tokens/s), its B1 launches {kernel_fwd[name]:.3f} ms of it "
            f"({kernel_fwd[name] / fwd_ms[name]:.1%}); Adam step {step_ms:.1f} ms (median of "
            f"{len(row['ms'])}: {[round(x, 1) for x in row['ms']]}), its B1/B2/B3 launches "
            f"{kernel_step[name]:.3f} ms ({kernel_step[name] / step_ms:.1%}), peak "
            f"{row['above'] / 2**30:.3f} GiB above live; step launches {_nonzero(row['counts'])}")
    for model in models.values():
        model.eval()
    # one layer's int8 ring at n_local 16,384: counter-rotated and not
    gen = torch.Generator(device="cuda").manual_seed(SEED + 72)
    q, k, v = (_rand(gen, (1, 8, RING_SIZE * VARIANT_INT8_N, 64), torch.bfloat16)
               for _ in range(3))
    kw = dict(causal=True, impl="cuda", hop_compression="int8", compute_dtype="int8",
              bucket_size=BENCH_MODEL["bucket_size"])

    def layer(counter):
        def run():
            with torch.inference_mode():
                ring_flash_attention(q, k, v, None, VirtualRing(RING_SIZE),
                                     counter_rotate=counter, **kw)
        return run

    with torch.inference_mode():
        a = ring_flash_attention(q, k, v, None, VirtualRing(RING_SIZE), counter_rotate=True, **kw)
        b = ring_flash_attention(q, k, v, None, VirtualRing(RING_SIZE), **kw)
    same = bool(torch.equal(a, b))
    del a, b
    ms = _time_turns({"int8 ring": layer(False), "counter int8 ring": layer(True)})
    log(f"  one layer's int8 ring (wire and compute), causal, 4 x {VARIANT_INT8_N}: "
        f"counter-rotated {ms['counter int8 ring']:.3f} ms, unidirectional "
        f"{ms['int8 ring']:.3f} ms ({ms['counter int8 ring'] / ms['int8 ring']:.3f}x); outputs "
        f"bit-identical {same}")
    check(same, "the counter-rotated int8 layer differs from the unidirectional one")
    log(f"  phase 4m took {time.perf_counter() - start:.1f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU", file=sys.stderr)
        return 1
    here = Path(__file__).resolve().parent
    port_dir = here / "ring_attention_tpu_torch"
    if not (port_dir / "__init__.py").is_file():
        print(f"chip_smoke: {port_dir} is missing; run from a checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(here))
    import ring_attention_tpu_torch

    check(Path(ring_attention_tpu_torch.__file__).resolve().parent == port_dir,
          f"imported the package from {ring_attention_tpu_torch.__file__}")

    start = time.perf_counter()
    phase_build(port_dir)
    max_err, decode_err = phase_kernel_vs_plain()
    mode_err = phase_ring_modes_vs_plain()
    fused_err = phase_fused_ring_vs_plain()
    remote_err = phase_fused_remote_vs_plain()
    bwd_err = phase_bwd_kernel_vs_plain()
    q8_err = phase_q8_kernels_vs_plain()
    seg_err = phase_segmented_vs_plain()
    mesh_err = phase_mesh_kernels_vs_plain()
    doc_err = phase_doc_tables_vs_plain()
    int8_err = phase_int8_ring_vs_plain()
    variant_err = phase_variants_vs_plain()
    serving = phase_serving_path()
    training = phase_training_path()
    ring = phase_ring_path(serving, training)
    fused = phase_ring_path(serving, training, impl="fused")
    q8_path = phase_q8_path(serving, training)
    packed = phase_packed_path(serving, training)
    zigzag = phase_zigzag_path(serving, training)
    config3 = phase_zigzag_config3()
    tree = phase_tree_decode_config5()
    mesh_serving = phase_mesh_serving()
    doc = phase_doc_mask_path(serving, training)
    int8_path = phase_int8_ring_path(serving, training)
    knobs = phase_memory_knobs()
    rows, decode_rows = phase_timings(serving)
    bwd_rows = phase_train_timings(training)
    mode_rows = phase_ring_timings(ring, serving, training, rows)
    q8_rows = phase_q8_timings(q8_path, serving, training)
    fused_rows = phase_fused_ring_timings(fused, ring, serving, training)
    seg_rows = phase_segmented_timings(packed)
    phase_mesh_timings(zigzag, ring, serving, training, tree, mesh_serving)
    doc_rows = phase_doc_timings(doc)
    int8_rows = phase_int8_ring_timings(int8_path, serving, training)
    mp_launches = phase_multiprocess_model()["launches"]
    # phases 3n and 4k: the memory knobs on the bench model (B1, B2, B3; B4
    # in the int8 remat case; B5 and B6 on the windowed caches)
    knob_timed = phase_memory_timings()["launches"]
    knob_launches = {name: knobs["launches"][name] + knob_timed[name] for name in COUNTERS}
    # phases 3o, 3p and 4l: Ulysses, the hybrid strategy and ZeRO-1 (B1, B2,
    # B3; B8 in the fused hybrid; B4 in the int8 hybrid)
    sp = phase_sp_path(serving, training)
    sp_mp = phase_sp_processes()["launches"]
    phase_sp_timings(sp, ring, serving, training)
    sp_launches = {name: sp["launches"][name] + sp_mp[name] for name in COUNTERS}
    # phases 3q, 3r and 4m: the ring variants and process-local batches (B1,
    # B2, B3; B4 in the counter-rotated int8 ring), added to the hybrid's
    variants = phase_variants_path(serving, training)
    variants_mp = phase_variants_processes()["launches"]
    phase_variants_timings(variants, serving, training)
    sp_launches = {name: sp_launches[name] + variants["launches"][name] + variants_mp[name]
                   for name in COUNTERS}
    # the main paths' launches of this slice: the zig-zag model, config 3,
    # config 5's tree decode and the serving path on the ring
    mesh_launches = {name: zigzag["launches"][name] + config3["launches"][name]
                     + tree["launches"][name] + mesh_serving["launches"][name]
                     for name in COUNTERS}
    ring_launches = ring["launches"]
    packed_launches = packed["launches"]
    doc_launches = doc["launches"]
    fused_launches = fused["launches"]
    # phase 3m's processes add the launches of their shards: to B4's here
    # (q8_launches' B2 and B3 counts include them, so the backward entries
    # add mp_launches no more), and to each other kernel's entry below
    q8_launches = {name: q8_path["launches"][name] + int8_path["launches"][name]
                   + mp_launches[name] + sp_launches[name] for name in COUNTERS}
    int8_launches = int8_path["launches"]
    flash, pallas_ring = "ring_attention_tpu/ops/pallas_flash.py", "ring_attention_tpu/ops/pallas_ring.py"
    entries = [
        ("flash_fwd", "flash_fwd.cu", f"{flash}:1174",
         serving["launches"] + training["launches"]["flash_fwd"]
         + ring_launches["flash_fwd"] + packed_launches["flash_fwd"]
         + mesh_launches["flash_fwd"] + doc_launches["flash_fwd"]
         + int8_launches["flash_fwd"] + mp_launches["flash_fwd"]
         + knob_launches["flash_fwd"] + sp_launches["flash_fwd"],
         max(max_err, *mode_err.values(), mesh_err["fwd"], config3["fwd_err"],
             variant_err["fwd"],
             *(seg_err[m] for m in ("fused", "seed", "resume", "fused_carry")),
             *(doc_err[m] for m in ("fused", "seed", "resume", "fused_carry"))),
         rows + seg_rows["flash_fwd"] + doc_rows["flash_fwd"]),
        ("flash_decode", "flash_decode.cu", f"{flash}:1174",
         serving["decode_launches"] + mesh_launches["flash_decode"]
         + mp_launches["flash_decode"] + knob_launches["flash_decode"],
         max(decode_err, mesh_err["decode"]), decode_rows),
        ("flash_bwd_dkv", "flash_bwd.cu", f"{flash}:2108",
         training["launches"]["flash_bwd_dkv"] + ring_launches["flash_bwd_dkv"]
         + fused_launches["flash_bwd_dkv"] + q8_launches["flash_bwd_dkv"]
         + packed_launches["flash_bwd_dkv"] + mesh_launches["flash_bwd_dkv"]
         + doc_launches["flash_bwd_dkv"] + knob_launches["flash_bwd_dkv"],
         max(bwd_err["dk"], bwd_err["dv"], seg_err["dk"], seg_err["dv"], mesh_err["dk"],
             mesh_err["dv"], config3["dk"], config3["dv"], doc_err["dk"], doc_err["dv"],
             variant_err["dk"], variant_err["dv"]),
         bwd_rows["flash_bwd_dkv"] + seg_rows["flash_bwd_dkv"] + doc_rows["flash_bwd_dkv"]),
        ("flash_bwd_dq", "flash_bwd.cu", f"{flash}:2186",
         training["launches"]["flash_bwd_dq"] + ring_launches["flash_bwd_dq"]
         + fused_launches["flash_bwd_dq"] + q8_launches["flash_bwd_dq"]
         + packed_launches["flash_bwd_dq"] + mesh_launches["flash_bwd_dq"]
         + doc_launches["flash_bwd_dq"] + knob_launches["flash_bwd_dq"],
         max(bwd_err["dq"], seg_err["dq"], mesh_err["dq"], config3["dq"], doc_err["dq"],
             variant_err["dq"]),
         bwd_rows["flash_bwd_dq"] + seg_rows["flash_bwd_dq"] + doc_rows["flash_bwd_dq"]),
        ("flash_fwd_q8", "flash_fwd_q8.cu", f"{flash}:1174",
         q8_launches["flash_fwd_q8"] + knob_launches["flash_fwd_q8"],
         max(*(q8_err[m] for m in ("fused", "seed", "resume", "fused_carry")),
             int8_err["seg"], int8_err["docs"], int8_err["feed"], variant_err["q8"]),
         q8_rows["fwd"]),
        ("flash_decode_q8", "flash_decode_q8.cu", f"{flash}:1585",
         q8_launches["flash_decode_q8"] + mesh_launches["flash_decode_q8"]
         + knob_launches["flash_decode_q8"],
         max(q8_err["decode"], mesh_err["decode_q8"]), q8_rows["decode"]),
        ("flash_ring", "flash_ring.cu", f"{pallas_ring}:341",
         fused_launches["flash_ring"] + doc_launches["flash_ring"] + int8_launches["flash_ring"]
         + mp_launches["flash_ring"] + sp_launches["flash_ring"],
         max(fused_err, doc_err["ring"], int8_err["ring_q8"], int8_err["ring_q8_seg"]),
         fused_rows + doc_rows["flash_ring"]),
        ("flash_ring_remote", "flash_ring_remote.cu", f"{pallas_ring}:866",
         fused_launches["flash_ring_remote"] + mesh_launches["flash_ring_remote"]
         + int8_launches["flash_ring_remote"] + sp_launches["flash_ring_remote"],
         max(remote_err, int8_err["remote_q8"]), fused["remote_rows"]),
    ]
    kernels = []
    for name, source, replaces, launches, err, per_shape in entries:
        headline = per_shape[0]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"ring_attention_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": err,
            "shape": headline["shape"],
            "ms": headline["ms"],
            "plain_ms": headline["plain_ms"],
            "bound_ms": headline["bound_ms"],
            "bound_by": headline["bound_by"],
            "library_ms": headline["library_ms"],
            **{key: headline[key] for key in ("streamed_ms", "sync_call_ms",
                                              "library_streamed_ms", "library_sync_ms",
                                              "bf16_kernel_ms", "bf16_sdpa_ms",
                                              "hop_chain_ms", "local_tier_ms",
                                              "ids_kernel_ms", "unsegmented_kernel_ms")
               if key in headline},
            "pass": True,
            "per_shape": per_shape,
        })
    # the forward kernel's ring modes, each with its own launches and numbers
    kernels[0]["modes"] = [
        {"mode": mode, "launches": ring_launches[mode] + packed_launches[mode]
         + mesh_launches[mode] + mp_launches[mode] + sp_launches[mode],
         "max_abs_err": max(mode_err[mode], seg_err[mode]),
         **{key: mode_rows[mode][0][key] for key in
            ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         "per_shape": mode_rows[mode]}
        for mode in ("seed", "resume", "fused_carry")
    ]
    next(x for x in kernels if x["name"] == "flash_fwd_q8")["modes"] = [
        {"mode": mode, "launches": q8_launches[f"q8_{mode}"], "max_abs_err": q8_err[mode],
         **{key: q8_rows["modes"][mode][key] for key in
            ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "bf16_kernel_ms")}}
        for mode in ("seed", "resume", "fused_carry")
    ]
    # the instantiations this slice added, each with its main-path launches
    # and numbers: B4 with ids, with doc tables and fed; B7's and B8's int8
    instantiations = {
        "flash_fwd_q8": [("kSeg", "seg_flash_fwd_q8", int8_err["seg"], int8_rows["kSeg"]),
                         ("kDocs", "doc_flash_fwd_q8", int8_err["docs"], int8_rows["kDocs"]),
                         ("fed", "feed_flash_fwd_q8", int8_err["feed"], int8_rows["feed"])],
        "flash_ring": [("int8", "q8_flash_ring", max(int8_err["ring_q8"],
                                                     int8_err["ring_q8_seg"]),
                        int8_rows[f"ring_q8_{INT8_TIMING_N[0]}"])],
        "flash_ring_remote": [("int8", "q8_flash_ring_remote", int8_err["remote_q8"],
                               int8_rows[f"remote_q8_{INT8_TIMING_N[0]}"])],
    }
    for kernel in kernels:
        if kernel["name"] in instantiations:
            kernel["instantiations"] = [
                {"instantiation": label, "launches": q8_launches[counter],
                 "max_abs_err": err,
                 **{key: row[key] for key in ("shape", "ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms")},
                 **{key: row[key] for key in ("bf16_sdpa_ms", "hop_chain_ms", "local_tier_ms",
                                              "unsegmented_kernel_ms", "bf16_kdocs_ms",
                                              "kernel_ms", "wrapper_ms") if key in row}}
                for label, counter, err, row in instantiations[kernel["name"]]]
    for kernel in kernels:
        for inst in kernel.get("instantiations", []):
            check(inst["launches"] > 0, f"{kernel['name']} {inst['instantiation']}: not "
                  "launched on the main path")
    log(f"total {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
