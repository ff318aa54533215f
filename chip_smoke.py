#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, then:

  (b) kernels: each kernel against its plain PyTorch version on the card,
      at the shapes the llama-1b-armt main path gives it (the diagonal
      prefill's band of G = 16 layers, B = 1, T = 1024 + 128; decode over 4
      slots of a 1152-row cache; bf16; armt_read's device launches per
      call counted, three), mamba_scan at falcon-mamba's (the band of 16
      layers at T = 1024, d_inner 8192, d_state 16, and one layer, in the
      TPU kernel's form and in the form the model runs, with the raw dt,
      its bias and the gate z taken in; timed at 1, 4 and 16 rows; decode
      over 4 rows), and at small odd shapes;
      error against a stated tolerance, and median device times (CUDA
      events behind a ~0.5 ms spin of the card, so the host's Python time
      is not counted) of the kernel, the plain version and, where one
      exists, a single PyTorch call computing the same function (a
      yardstick the port never calls); flash also with hd 128, decode also
      at the 64-key chunk edges and with windows; the long shapes of the
      full-attention and full-KV paths: flash at T = S = 16,384 (held at 4
      q heads over 1 kv head) and 131,072 (held on three slices of query
      rows), timed at 32 over 8 heads beside SDPA's flash backend, and
      decode over 17,432 and 131,136 keys (the last split full, one key
      long and empty) beside SDPA with a length mask; the dense configs'
      head shapes: flash at hd 80 (h2o-danube-1.8b's band, and T = S =
      16,384 held at 4 over 1 heads with its 4,096-key window, timed at
      32 over 8 heads) and decode at 16 q heads per kv head of 128
      (chatglm3-6b: 4 slots at 1,024 keys and 4 rows over 131,136 keys,
      each row batched equal to the row alone to the bit); the MoE configs'
      shapes: flash at hd 112 (kimi-k2-1t-a32b's band, 64 q over 8 kv
      heads, against its plain version and SDPA), decode at kimi-k2's 64 q
      over 8 kv heads of 112 and qwen2-moe-a2.7b's 16 over 16 of 128 (4
      slots on the ARMT decode cache of 1,152 rows and on the cache mode's
      2,112, each row batched equal to the row alone to the bit, beside
      SDPA) and armt_update at kimi-k2's width (3 layers' last 128 rows of
      7,168, B = 1, as the attn_moe cell calls it); jamba-1.5-large's
      shapes: flash over its attention band (2 layers, 64 q over 8 kv
      heads of 128), decode at 64 q over 8 kv heads of 128 (the same
      slots and caches, rows alone = batched) and mamba_scan over its
      band (2 layers, T = 1,152, d_inner 16,384, fused); whisper-medium's
      shapes: the GEMM's bias + tanh-GELU epilogue at its MLP up
      projection over the band [16,1152,1024]x[16,1024,4096], flash
      without a mask at T != S over a ragged 1,500 keys (the dec cell's
      cross-attention, k/v read as views of a [G,B,F,H,hd] cross K/V
      buffer) and at T = S = 1,500 (the encoder), and decode's
      cross-attention at rep 1 x hd 64 over 1,500 frames (rows alone =
      batched), each beside its library call;
  (c) model: llama-1b-armt at full width and depth (random weights from a
      seed, bf16), diagonal prefill on the kernels against the sequential
      schedule on the plain path: 16 segments free-running, gated on the
      first 2 (the untrained model is chaotic past a few segments, plain
      versions included); 16 segments teacher-forced, each segment started
      from the sequential path's state, its last-token logits and every
      layer's A and z held wherever the plain versions on the card (a
      second rounding of the same math) agree within half the tolerance,
      which must be at least 8 segments, with a negative control (the
      fused update's delta A scaled by 0.9 must fail it); 2 segments with
      every layer's final A and z held, plus two negative controls (a read
      perturbed by 2 %, and the fused update's delta A scaled by 0.95,
      must each fail that check); and fp32 with 2 layers and 3 segments
      against a tight tolerance;
  (d) serving through generate: ServeEngine.generate for B = 1 (a prompt
      of 4 segments + 1000 tokens, 48 new, crossing a segment flush) and
      B = 2 (4 segments + 300 tokens, 32 new), logits held finite, decode
      on CUDA graphs; each run again on the graphs (repeated bit for bit)
      and on an eager engine (the same programs uncaptured): tokens, every
      step's logits and the final decode state equal to the bit, launch
      counts equal; B = 1 sampled (temperature 0.8, top_k 40, seed 0) the
      same; one decode step's host span and device time, graph and eager;
      plus generate at smoke size (B = 1 and B = 2, fp32) on the card
      against the CPU path, token for token;
  (e) serving through the continuous-batching front door, the main path:
      ServeEngine.serve with 4 slots, chunk 8 and 6 requests (1-3 segments
      plus 10-1010 tail tokens, 24-64 new, slots crossing their segment
      flushes at different steps); each request's first token against a
      B = 1 generate of its prompt; graph against eager (every request's
      events, launch counts, tok/s); one step over the 4 slots timed; and
      serve at smoke size (fp32) on the card against the CPU path, token
      for token.
  (i) full attention, the paper's baseline: forward_hidden(mode="full") at
      4,096 tokens, B = 1, full depth, bf16 on the kernels against the plain
      path in fp32 on the same weights (the last 1,024 positions' hidden
      states and the last logits), the attention output projection x0.98 a
      control that must fail; the diagonal executor (one segment) and the
      sequential one on the fused cell equal to the bit; fp32 at 2 layers,
      kernels vs plain, within 1e-3, with the same control;
  (j) the 16-segment ARMT prefill, diagonal against sequential (each
      segment a replay of a captured CUDA graph), both on the kernels: the
      largest relative difference per segment (hidden states, logits) and
      per layer (final A, z), gated on equality to the bit (or, if they
      differ, on the first 2 segments within 5e-2); the captured
      sequential run against the eager one to the bit, launches equal;
  (k) ServeEngine(serve_mode="cache", max_len=17432).generate: B = 1 on
      16,384 + 1,000 tokens (48 new), B = 2 on 4,096 + 300 (32 new), logits
      finite and the prefill's last logits within 5e-2 of the full-mode
      forward's; each run again on the graphs and on an eager engine, to
      the bit (tokens, logits, state); sampling (temperature 0.8, top_k
      40, seed 0) twice equal, top_k 1 equal to greedy;
  (l) ServeEngine(serve_mode="cache", max_len=8192).serve: 6 requests of
      1,000-6,000 tokens + 32 new on 4 slots, chunk 8, each first token
      against a B = 1 generate; graph against eager;
  (m) one cache-mode decode step over a full cache of 17,432 and 131,136
      rows, the engine's captured step (the cache written in place, which
      must keep its address) and the same step eager: host span and device
      time;
  (n) the three schedules timed (informational: gated on finite times and a
      finite full-mode output): full attention, ARMT sequential (captured
      segments) and ARMT diagonal, all on the kernels, and the sequential
      one eager, at 16,384 and 131,072 tokens, B = 1; 1 warm-up and 3 runs
      each, host wall and CUDA-event time, peak memory, and the ratios
      beside the paper's 3.3x and 1.8x (quoted).

  (o) interleaved admission, llama-1b-armt at full width and depth: the
      resumable pipeline (pipeline_step at k = 1, 4 and 31, then one
      overshoot step) against run_diagonal over 16 segments, every
      segment's hidden states, the last logits and every layer's A and z
      to the bit; boundary states c = 1, 4, 16 of the capture against
      run_diagonal over c segments, and stream_ys's brow and win against
      the full ys, to the bit; the pooled step over members of 4, 8 and 16
      segments at cursors 0, 5 and past the end (k = 4), each member to
      the bit against its own steps, one pooled band step launching what
      one member's band step launches; (e)'s requests through serve at k
      = 0 (blocking), 1, 4 (phase (e)'s run), -1, one admission at a
      time, oldest first and fused, every request's events equal to
      blocking's, with tok/s and the band steps pooled; the stall run (3
      requests decoding on 4 slots while a 16-segment prompt arrives) at
      k = 0 and 4: aggregate tok/s, each request's TTFT and the longest
      host gap between two chunks of a decoding slot (informational); the
      byte budget (prefill_activation_bytes(4, stream)) streaming the
      16-segment prompt in stages of 4, its tokens equal to blocking's,
      and the admission's peak memory, streaming and full ys, each at or
      below its estimate. After (h): falcon-mamba's (h) run (k = 4) and a fused k = 4
      run against a blocking run, every request's events equal. Prints a
      ``{"interleave": ...}`` and an ``{"interleave_falcon": ...}`` line.
      The kernel phase also holds the GEMM's layer index (24 groups over
      16 layers at the FFN up shape, and an odd shape) to the bit against
      the launch on the gathered weights, and times both.
  (f) falcon-mamba-7b at full width and depth (random weights from a seed,
      bf16): the 16-segment prefill, diagonal on the kernels against the
      sequential schedule on the kernels (every segment's hidden states and
      last-token logits, every layer's final h), with the mamba_scan
      launches counted (S + L - 1 band steps) and those of one decoded
      token (one per layer); 1 segment against the sequential plain path,
      printed in bf16 beside the bf16 stack's own rounding floor, and 2
      gated on the same weights in fp32 at 1e-3, with two negative controls on
      the kernel path (dt x~1.02 into the scan through its bias, the
      scan's output x0.98) that the check must reject; the smoke config in
      fp32, card against CPU;
  (g) ServeEngine(max_len=8192).generate: B = 1 on 2 x 8192 + 1000 tokens
      (48 new) and B = 2 on 8192 + 500 (32 new), each repeated bit for bit
      and held against an eager engine (tokens, logits, h and conv tail
      to the bit); one step timed, graph and eager; smoke config card vs
      CPU, token for token;
  (h) ServeEngine.serve: 6 requests of 8,192-17,384 tokens on 4 slots,
      chunk 8, each first token against a B = 1 generate; graph against
      eager; smoke config card vs CPU.

  (p1) the prefix cache through generate (llama-1b-armt after (o)): a
      PrefixCache holding one 16-segment prompt's boundaries (and two more),
      filled by a cold generate of 16 segments + 300 tokens (48 new); hits
      sharing 8 and 16 of its segments with tails of 0 (the exact full hit),
      1, 1,023 and 1,027 tokens, each against an engine without a cache:
      tokens, every step's logits and the final decode state to the bit (the
      exact full hit's first logits, the stored boundary logits, within
      1e-2); the 8-segment hit run twice (aliasing); a snapshot's A scaled
      by 1.01 in one layer, a control that must fail; the bytes of a
      snapshot beside a KV prefix of 16,384 tokens; TTFT hit, no cache and
      cold with a cache (median of 3);
  (p2) the prefix cache through serve: 6 requests on 4 slots, 4 sharing an
      8-segment prefix, at k = 4 and blocking, every request's events equal
      serve without a cache; hits, misses, pooled band steps; a capturing
      16-segment admission's peak memory at or below
      prefill_activation_bytes (with its capture term);
  (p3) a 3-turn session (2 segments + 5, 7, 2 segments) through generate,
      and through serve (turn 1 beside another request, turn 2 at k = 4,
      turn 3 through generate): kept in memory against spilled to disk and
      restored (a store of 1 byte), to the bit; an evicted session raising
      SessionEvicted and yielding session_evicted, an unknown id starting
      fresh; the smoke config (fp32) card against CPU over the whole flow;
      each generate turn against one generate over the history (first
      logits within 5e-2 while the history is at most 2 segments, printed
      past that), with both TTFTs;
  (q) telemetry: phase (e)'s requests through serve with
      Telemetry(trace=True): the exported trace valid (schema and the CLI
      gate on the decode, admission, transplant and flush categories), the
      events equal with telemetry off, one device-to-host conversion per
      chunk on and off (counted on every CUDA tensor's conversions); tok/s
      on against off (alternating), ITL percentiles, the stall run's
      admission_stall_s beside its longest gap, and the span totals of the
      process's first interleaved serve (phase (e), run with the trace
      recorder on) beside a warm one. Prints a ``{"stores": ...}`` line;
  (r) after (q), before (f): the five other dense ARMT configs, one at a
      time, bf16, full width, weights drawn on the card from the seed
      with the QKV biases (normal x 0.02) and q/k norm weights (1 +
      normal x 0.1) non-zero: h2o-danube-1.8b, chatglm3-6b and
      minitron-8b at full depth, qwen2.5-32b at 16 of 64 layers and
      chameleon-34b at 12 of 48 (reduced depth: the weights must fit the
      card). Each: a 4-segment prefill, diagonal against sequential on the
      fused cell to the bit (hidden, logits, A, z), its first 2 segments
      within 5e-2 of the sequential plain path, warm prefill times;
      generate B = 1 (16 new, crossing a flush) captured against eager to
      the bit; for chatglm3-6b and h2o-danube-1.8b also cache-mode
      generate over 6,144 tokens (past danube's window) against eager,
      and a two-request serve, each first token against a B = 1
      generate. No SIMT GEMM or flash may launch. Prints a
      ``{"dense_configs": ...}`` line;
  (s) after (r): the two MoE ARMT configs, one at a time, bf16, weights
      drawn on the card: qwen2-moe-a2.7b at full width and depth (24
      layers, 60 experts top-4, QKV biases normal x 0.02) and
      kimi-k2-1t-a32b at full width with its dense prelude layer and 3 of
      60 MoE layers, 128 of 384 experts (top-8; ~41 GB). Each: 4-segment
      prefill at B = 1 and B = 2, diagonal against sequential on the
      fused cells to the bit (hidden, logits, every layer's A and z);
      warm 4- and 16-segment prefill times; the fused path against the
      plain path, where routing is discontinuous: at the first MoE layer
      (the model cut after it, 2 segments, each from the fused path's
      state) the tokens whose top-k set or capacity keep differ are
      counted and the others held within 5e-2, the new A and z within
      5e-2 (the prelude's always, the MoE layer's where none of its
      memory rows was routed differently), and at full depth the flips
      per layer reported; generate B = 1 captured against eager to
      the bit, ARMT and cache mode; serve on 4 slots, blocking against
      interleaved (k = 4), every request's tokens equal; an admission's
      peak memory at or below prefill_activation_bytes; the MoE layer
      alone at the band's shape (every pattern layer, T = 1152): the
      expert gate GEMM held against fp32 torch.bmm and timed beside
      torch.bmm, the whole fused moe_ffn against its plain version in
      fp32. No SIMT GEMM or flash may launch. Prints a
      ``{"moe_configs": ...}`` line;
  (t) after (s): (t4) the blockwise cell FFN on llama-1b-armt at full
      width and depth (cell_block 256, 16 segments, B = 1): diagonal
      against sequential to the bit, the hidden states against cell_block
      0 (the first 2 segments' relative error within 1e-2, the worst row
      printed), armt_update launched in place
      of the fused update, and a 16-segment admission's peak lower than
      at cell_block 0 and at or below its estimate; then
      jamba-1.5-large-398b at full width (d_model 8,192, 64/8 heads of
      128 without rotary, FFN and experts 24,576, top-2, d_inner 16,384,
      vocab 65,536) with 2 of its 9 superblocks (16 of 72 layers: 2 attn,
      6 mamba with their dense FFN, 8 mamba_moe) and 4 of its 16 experts,
      bf16, weights drawn on the card (the cuts listed with their bytes
      from init_params' leaves): (t1) the 4- and 16-segment prefill at B =
      1 and 2, diagonal (its strided bands) against sequential to the bit
      (hidden, logits, every layer's state), and at 16 segments B = 1 the
      boundary states of both captures; the warm prefill times (median
      of 3); (t2) at segment 0 the fused mamba_moe and mamba cells over
      both superblocks' layers of their position (a strided band) against
      the plain block: the first mamba layer within 5e-2 (its h and conv
      tail too), the first MoE layer's routing-agreeing tokens within
      5e-2, the flips counted; the MoE band timed; (t5) the expert gate
      GEMM at [2*4, 720, 8192] x [8192, 24576] on the model's experts,
      each of layer 1's against fp32 torch.bmm, timed beside torch.bmm;
      (t3) generate captured against eager in ARMT mode (a flush crossed)
      and cache mode (2,048 tokens), serve blocking against k = 4, a
      3-segment prefix-cache hit against an engine without a cache (the
      cold run too), and the admission's peak at or below
      prefill_activation_bytes at 4 and 16 segments. No SIMT GEMM or flash
      may launch, and every kernel must. Prints a ``{"jamba": ...}`` line;
  (u) after (t): whisper-medium at full width and depth (24 encoder and
      24 decoder layers, 975.8 M parameters, weights drawn on the card,
      every bias and layernorm leaf away from its init value, frame
      embeddings from the seed): the encoder on the kernels within 1e-2 of
      the plain path in fp32 (rel err of the output; a control, every
      layer's output projection x0.98, must fail it), and timed; diagonal
      = sequential to the bit at B = 1 and 2, 4 and 16 segments (hidden,
      logits, every layer's A, z and cross K/V); the first 2 segments
      free-running against the sequential plain path in fp32 at 5e-2, and
      all 16 teacher-forced from its states (held where the plain versions
      on the card agree within half the tolerance); generate captured
      against eager to the bit in ARMT mode (a flush crossed) and cache
      mode (2,048 tokens); frames A, B, A on one engine's graphs: the A
      runs equal to the bit, B's run equal to the bit to an eager engine's
      B, its logits not A's; the blocking prefill's peak at or below
      prefill_activation_bytes at 4 and 16 segments; no SIMT, every
      kernel but mamba_scan launched. Prints a ``{"whisper": ...}`` line;
  (v) after (u): training llama-1b-armt at full width and depth on the
      kernels' autograd Functions. (v1) each backward at the band's shapes
      (the GEMM with silu, with gelu + bias, the down projection with a
      residual; flash causal and with a 512-key window; armt_read;
      armt_update) against autograd through the plain version in fp32 on
      the same values: every input's gradient within 1e-4 (fp32) or 2e-2
      (bf16) of its norm, a control (one gradient x0.98 in fp32, x0.95 in
      bf16) failing; forward, backward and the plain version's backward
      timed in bf16. (v2) fp32, B = 1, 2 segments: lm_loss within 1e-4 and
      every parameter's gradient within 1e-3 of the plain path (diagonal,
      fused against unfused), layer 4's wo x0.98 a control that must
      fail; the B = 1 cell's unfused route (the training form) against the
      fused op in the forward at the bf16 band, to the bit. (v3) bf16,
      remat, 16 segments: the training stream's first batch, loss and
      gradients diagonal against sequential (the losses to the bit, the
      gradients finite; their difference printed); fp32 at 4 segments
      within 1e-3; uniform random tokens, forward only, reported (the
      untrained recurrence overflows on them). (v4) train_loop on
      lm_stream, bf16, 16 segments, B = 1, diagonal, 12 steps (lr 1e-3,
      warmup 2): step time, tokens/s and peak memory; a checkpoint at step
      6 resumed in a fresh loop to step 12, its losses within 1e-3 of the
      uninterrupted run's (bitwise reported); a step with a NaN in its
      loss mask skipped, params and moments unchanged to the bit; the
      steps the loop skipped as non-finite reported; the loss must fall
      (the mean of the last 3 steps below the first 3) on one batch of 2
      segments repeated for 12 steps, where the untrained recurrence is
      well conditioned. Prints a ``{"train": ...}`` line;
  (w) after (v): training the mamba, MoE and encoder configs. (w1)
      mamba_scan's backward kernel (the reverse scan from the states the
      forward keeps every 128 tokens) at falcon-mamba's width in the fused
      form, x [2,1024,8192], d_state 16, per-group A_log, the operands the
      mixer's views: every operand's gradient (y's and the final state's
      given) within 1e-4 (fp32) or 2e-2 (bf16) of its norm against the
      plain backward (grad.mamba_scan_bwd_plain, fp32 on the same values),
      a control (x's gradient x0.98 in fp32, x0.95 in bf16) failing; the
      plain backward against autograd through the plain scan in fp32; the
      forward (keeping its states, and without) and the backward kernel
      timed at falcon's training band [12,1024,8192] and jamba's
      [2,1152,16384], beside the backward's bound, and the plain backward
      at 2 rows. (w2) fp32, B = 1, 2 segments: falcon-mamba-7b at 2 layers,
      qwen2-moe-a2.7b at 2 layers, whisper-medium whole (frames from the
      seed), all at full width, and jamba-1.5-large's whole superblock
      pattern at the smoke width: lm_loss within 1e-4 and every leaf's
      gradient within max(1e-3, 3x the leaf's diagonal-vs-sequential
      difference on the kernels), at most 1e-2, of the plain path (every
      kernel on its plain version, the plain blocks, sequential); a
      difference above 5e-4 fails outside a named list (whisper's memory
      projections, small differences of nearly equal terms:
      tools/grad_gap.py), as does a run with no leaf held; a leaf whose
      gradient is zero in exact arithmetic (a key bias) held to that zero;
      the share of MoE tokens whose routing flips between the two paths
      (where any flips, only the layers before the first flipped MoE layer
      gated);
      the diagonal and sequential losses to the bit; a control (a row of
      layer 0's output projection x0.98) that must fail. (w3) bf16, B =
      1, 4 segments, 12 steps (lr 1e-3, warmup 2) on one repeated batch of
      the LM stream: falcon-mamba-7b at 12 of 64 layers through
      train_loop, qwen2-moe-a2.7b at 3 of 24 layers with all 60 experts
      and whisper-medium whole (frames from the seed) through
      make_train_step: the loss falls (the mean of the last 3 steps below
      the first 3), step time, tokens/s, peak (at most 75 GB) and skipped
      steps; falcon's loop checkpointed at step 6 and resumed in a fresh
      loop to step 12, its losses within 1e-3 of the uninterrupted run's
      (bitwise reported). Launches are counted from 0 around each run of
      (w2) and (w3): mamba_scan's forward and backward in falcon's and
      jamba's, the GEMM, flash, armt_read and armt_update in qwen's and
      whisper's, no SIMT GEMM or flash in (w3). Prints a
      ``{"train_families": ...}`` line;
  (p4) after (h): a falcon-mamba-7b session (2 x 8192 + 1000 tokens, then
      500), spilled and restored against kept in memory to the bit (h and
      the bf16 conv tail), resume TTFT against re-prefilling the history
      (a ``{"stores_falcon": ...}`` line).

Decode runs on CUDA graphs (``DecodeProgram``: the step, with sampling
and the finite flag, and the masked flush, over static state updated in
place), and so does the sequential schedule's segment; the eager engines
(``ServeEngine(eager=True)``, ``forward_hidden(eager=True)``) exist only
to be held against them here and in the card tests.

The kernels' launch counters are set to 0 just before each main-path run
of (d), (e), (i), (k), (l), (o), (p1)-(p4), (r), (s), (t), (u), (v), (w), (g), (h)
and falcon's fused run of (o), and read just after it (a phase's count is the sum over its runs; a
graph replay counts what its capture launched, so the counts read the
same under graphs as eager): every llama kernel must have been launched
in (d), every one but armt_update (which runs only at B > 1) in (e), in
(o)'s interleaved serve runs (``serve_interleaved``) and in the
prefix-cache (p1-p2) and session (p3) runs (``prefix_cache``,
``sessions``) and in (r) (``dense_configs``), every one in (s)
(``moe_configs``: armt_update through the MoE cell at B = 1, the fused
update through kimi's dense prelude layer) and in (t) (``jamba``, with
mamba_scan) and in (u) (``whisper``), the GEMM, flash, armt_read and
armt_update and not the fused update or decode attention in (v)'s
uninterrupted 12 steps (``train``: forward and backward launches, the
backward's recomputed pre-activations and rematerialized cells
included), the GEMM and
flash in (i) and flash and decode attention in (k) and (l), with none of
the ARMT memory kernels there, and mamba_scan in (g), (h) and falcon's
interleaved run and session run (p4). ``serve`` runs at its default of 4 band steps per
chunk (interleaved admission) in (e), (l) and (h). The GEMM's and flash attention's
launches are also counted by route (the TMA + wgmma kernel or the fp32 SIMT
kernel; for the GEMM whoever called it: projections, the fused op, the
ARMT kernels' projections): the bf16 runs of (d),
(e), (i), (k), (l), (o), (p1)-(p3), (r), (s), (t), (u) and (v) must launch no SIMT GEMM and
no SIMT flash. One decode_attention
call (its partials and their combine) counts as one launch.
The script prints JSON lines of the schedules' timing, of the graph
phase (every graph-against-eager check with its rates) and of the kernel
summaries (each with ``launches_train``, ``launches_train_families`` and
``backward``: (v1)'s rows, (w1)'s for mamba_scan, null for the kernels
off the training path), the card's name and power limit, and last ``{"ok": true,
"device": {...}}``. Any failure exits
non-zero before that line; without a CUDA device it exits 2.
"""
from __future__ import annotations

import contextlib
import json
import math
import shutil
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published dense peaks (NVIDIA data sheet), used for bound_ms
PEAK_BF16 = 989e12      # tensor-core flop/s, bf16 inputs
PEAK_FP32 = 67e12       # CUDA-core flop/s, fp32
PEAK_BYTES = 3.35e12    # HBM bytes/s
N_SM = 132
SFU_PER_CLOCK_SM = 16   # special-function unit results (exp2) per clock per SM
SEED = 0


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


# ---------------------------------------------------------------------------
# The telemetry phase's (q) count of device-to-host conversions
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def device_reads(torch):
    """Counts the device-to-host conversions of CUDA tensors made inside
    the block (``.cpu()``, ``.item()``, ``.tolist()``, ``.numpy()``, a
    ``.to`` that lands on the host, and bool / int / float / index /
    array conversions): yields a one-element list holding the count."""
    names = ("cpu", "item", "tolist", "numpy", "__bool__", "__int__", "__float__",
             "__index__", "__array__")
    count = [0]
    own = {n: torch.Tensor.__dict__.get(n) for n in names + ("to",)}

    def counting(fn):
        def wrapped(self, *a, **k):
            if self.is_cuda:
                count[0] += 1
            return fn(self, *a, **k)
        return wrapped

    def counting_to(fn):
        def wrapped(self, *a, **k):
            out = fn(self, *a, **k)
            if self.is_cuda and isinstance(out, torch.Tensor) and not out.is_cuda:
                count[0] += 1
            return out
        return wrapped
    for n in names:
        setattr(torch.Tensor, n, counting(getattr(torch.Tensor, n)))
    torch.Tensor.to = counting_to(getattr(torch.Tensor, "to"))
    try:
        yield count
    finally:
        for n, fn in own.items():
            if fn is None:
                delattr(torch.Tensor, n)
            else:
                setattr(torch.Tensor, n, fn)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import (armt_memory, build, decode_attention, flash_attention,
                                     grouped_matmul, mamba_scan, ops, swap)
    from repro_torch.core import diagonal as diag
    from repro_torch.models import model as M
    from repro_torch.serve import (ContinuousScheduler, MetricsRegistry, Request, RequestError,
                                   ServeEngine, Telemetry)

    counters = {"grouped_matmul": (grouped_matmul, "launches"),
                "flash_attention": (flash_attention, "launches"),
                "armt_read": (armt_memory, "read_launches"),
                "armt_update": (armt_memory, "update_launches"),
                "grouped_matmul_armt_update": (grouped_matmul, "fused_launches"),
                "decode_attention": (decode_attention, "launches"),
                "mamba_scan": (mamba_scan, "launches"),
                "mamba_scan_bwd": (mamba_scan, "bwd_launches")}   # training only, (w)
    # the kernels each model's path runs (forward)
    forward_kernels = [k for k in counters if k != "mamba_scan_bwd"]
    llama_kernels = [k for k in forward_kernels if k != "mamba_scan"]
    falcon_kernels = ["mamba_scan"]

    # GEMM and flash launches by route, counted where launched (not kernels
    # of their own)
    routes = {"wgmma": "tc_launches", "simt": "simt_launches"}
    routed = {"grouped_matmul": grouped_matmul, "flash_attention": flash_attention}

    def reset_counts():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        for mod in routed.values():
            for attr in routes.values():
                setattr(mod, attr, 0)

    def read_counts():
        return {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}

    def read_routes():
        """{kernel: {route: launches}} for the GEMM and flash."""
        return {k: {name: getattr(mod, attr) for name, attr in routes.items()}
                for k, mod in routed.items()}

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()
    log(f"card: {smi}")
    clock_hz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0]) * 1e6
    sfu_rate = SFU_PER_CLOCK_SM * N_SM * clock_hz
    log(f"max SM clock {clock_hz / 1e6:.0f} MHz: {sfu_rate / 1e12:.3f} T exponentials/s "
        f"({SFU_PER_CLOCK_SM} per clock per SM, {N_SM} SMs)")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    build.lib()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {build.build_seconds if build.build_seconds is not None else 'reused'})")
    for line in build.ptxas_log().splitlines():
        if "Compiling entry" in line or "Used" in line or (
                "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line):
            log("  ptxas:", line.strip())

    def sync():
        torch.cuda.synchronize(dev)

    def time_ms(fn, iters=10, warmup=2, spin=1_000_000):
        """Median device time of one call: the card spins first (~0.5 ms
        at the default ``spin`` cycles; longer where the host takes longer
        to enqueue the call), so the host has enqueued the call before the
        start event is reached and its Python time is not counted."""
        for _ in range(warmup):
            fn()
        sync()
        ts = []
        for _ in range(iters):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(spin)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return float(np.median(ts))

    def bound(flops_bf16=0.0, flops_fp32=0.0, nbytes=0.0, exps=0.0):
        # exponentials run on the special-function units, beside the FMA pipe
        ops_t = max(flops_bf16 / PEAK_BF16 + flops_fp32 / PEAK_FP32, exps / sfu_rate)
        byte_t = nbytes / PEAK_BYTES
        return max(ops_t, byte_t) * 1e3, ("operations" if ops_t >= byte_t else "bytes")

    def rel_err(a, b):
        # float64: fp32 norms of the grown ARMT state can overflow
        return ((a.double() - b.double()).norm() / b.double().norm()).item()

    gen = torch.Generator().manual_seed(SEED)

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)

    failures = []
    summary = {}

    def row_rel(got, want):
        """Worst ||got - want|| / ||want|| over the rows (last dim)."""
        got, want = got.float(), want.float()
        return ((got - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)).max().item()

    def check(name, got, want, tol):
        """Holds every row of each output to tol of that row's norm, so rows
        of small values (late attention queries, say) are held as tightly as
        the largest ones. ``want`` is the plain version computed in fp32 on
        the same input values, so only the kernel's rounding is measured."""
        got, want = [t if isinstance(t, (tuple, list)) else (t,) for t in (got, want)]
        err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
        worst = max(row_rel(g, w) for g, w in zip(got, want))
        finite = all(torch.isfinite(g).all().item() for g in got)
        ok = finite and worst <= tol
        log(f"  {name}: max_abs_err {err:.3e} worst row rel err {worst:.3e} "
            f"(tol {tol:g}) finite {finite} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(name)
        return err

    def timed(name, kernel, plain, library=None, **bnd):
        ms, plain_ms = time_ms(kernel), time_ms(plain, iters=5)
        lib_ms = time_ms(library) if library is not None else None
        b_ms, b_by = bound(**bnd)
        log(f"  {name}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  library "
            f"{'%.4f ms' % lib_ms if lib_ms is not None else 'none'}  bound {b_ms:.4f} ms "
            f"({b_by})  kernel/bound {ms / b_ms:.2f}")
        return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)

    def counted(fn):
        """fn() run from launch counts set to 0 -> (its result, its
        launches, its GEMM and flash launches by route)."""
        reset_counts()
        out = fn()
        sync()
        return out, read_counts(), read_routes()

    def merged(total, more):
        """Counts (or nested counts) summed over the runs of one path."""
        if isinstance(more, dict):
            return {k: merged(total.get(k, 0 if not isinstance(v, dict) else {}), v)
                    for k, v in more.items()}
        return total + more

    def bits(t):
        return t.view({torch.bfloat16: torch.int16, torch.float32: torch.int32,
                       torch.int32: torch.int32, torch.int64: torch.int64,
                       torch.bool: torch.bool}[t.dtype])

    def same_bits(a, b):
        """Equal to the bit (NaN and inf included)."""
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(bits(a), bits(b))

    def same_state(a, b):
        """Two decode states equal to the bit, every leaf and pos."""
        return same_bits(a["pos"], b["pos"]) and all(
            da.keys() == db.keys() and all(same_bits(da[k], db[k]) for k in da)
            for part in ("prelude", "pattern") for da, db in zip(a[part], b[part]))

    graph_phase = {}      # what the graph runs were held against, and the rates

    def check_graph(label, same, counts_g, counts_e, **rates):
        """Logs and records one graph-against-eager check (each item of
        ``same`` must be true, and the launch counts equal)."""
        ok = all(same.values()) and counts_g == counts_e
        log(f"  graph vs eager, {label}: "
            + ", ".join(f"{k} {v}" for k, v in same.items())
            + f", launches equal {counts_g == counts_e} -> {'ok' if ok else 'FAIL'}")
        if counts_g != counts_e:
            log(f"    launches graph {counts_g} eager {counts_e}")
        if not ok:
            failures.append(f"graph vs eager: {label}")
        graph_phase[label] = dict(same, launches_equal=counts_g == counts_e, **rates)

    def check_generate(label, g, e, counts_g, counts_e, **rates):
        """generate(keep=True) on a graph engine against an eager one."""
        check_graph(label, {"tokens equal": bool(np.array_equal(g.tokens, e.tokens)),
                            "every step's logits to the bit": same_bits(g.logits, e.logits),
                            "final decode state to the bit": same_state(g.state, e.state)},
                    counts_g, counts_e, **rates)

    def step_times(prog, eager):
        """One decode step of a program over all its rows: host span per
        step over 32 steps ending in a sync, and device time (CUDA events;
        an eager step is enqueued behind a ~100 ms spin)."""
        prog.active.fill_(True)
        prog.step()
        sync()
        t0 = time.perf_counter()
        for _ in range(32):
            prog.step()
        sync()
        span = (time.perf_counter() - t0) / 32 * 1e3
        return dict(span_ms=span, device_ms=time_ms(prog.step, iters=5, warmup=1,
                                                     spin=200_000_000 if eager else 1_000_000))

    # ------------------------------------------------------------ (b) kernels
    log("== kernel phase (main-path shapes: G=16, B=1, T=1152, bf16; odd shapes)")
    G, T, D, F, Hq, Hkv, hd, dm, Mt = 16, 1152, 2048, 8192, 32, 8, 64, 64, 128
    P = 6 * dm
    # per-row relative L2 error against the plain version in fp32; the
    # kernels' bf16 output rounding alone reads ~1e-3
    TOL_BF16, TOL_F32, TOL_STATE = 1e-2, 1e-4, 1e-4

    # grouped_matmul: every projection shape of the cell; the FFN up
    # projection (the largest, no epilogue) is the one reported per kernel
    x = rnd(G, T, D)
    xf = rnd(G, T, F)
    for label, xin, K, N, act in [("q/o 2048x2048", x, D, D, None),
                                  ("k/v 2048x512", x, D, Hkv * hd, None),
                                  ("gate 2048x8192 silu", x, D, F, "silu"),
                                  ("up 2048x8192", x, D, F, None),
                                  ("down 8192x2048", xf, F, D, None)]:
        w = rnd(G, K, N, scale=K ** -0.5)
        err = check(f"grouped_matmul {label}",
                    grouped_matmul.grouped_matmul(xin, w, activation=act),
                    grouped_matmul.grouped_matmul_plain(xin.float(), w.float(), activation=act),
                    TOL_BF16)
        t = timed(f"grouped_matmul {label}",
                  lambda: grouped_matmul.grouped_matmul(xin, w, activation=act),
                  lambda: grouped_matmul.grouped_matmul_plain(xin, w, activation=act),
                  (lambda: torch.bmm(xin, w)) if act is None else None,
                  flops_bf16=2.0 * G * T * K * N, nbytes=2.0 * G * (T * K + K * N + T * N))
        if label.startswith("up"):
            summary["grouped_matmul"] = dict(t, max_abs_err=err, shape=f"[{G},{T},{K}]@[{G},{K},{N}]")
        del w
    del xf
    for dtype, (g_, r_, k_, n_) in [(torch.float32, (3, 37, 50, 29)),
                                    (torch.bfloat16, (2, 130, 64, 136)),
                                    (torch.bfloat16, (16, 1100, 72, 512))]:
        xo, wo, bo = (rnd(g_, r_, k_, dtype=dtype), rnd(g_, k_, n_, scale=0.2, dtype=dtype),
                      rnd(g_, n_, dtype=dtype))
        check(f"grouped_matmul odd {dtype} [{g_},{r_},{k_}]x[{k_},{n_}] bias+gelu",
              grouped_matmul.grouped_matmul(xo, wo, bo, activation="gelu"),
              grouped_matmul.grouped_matmul_plain(xo.float(), wo.float(), bo.float(),
                                                  activation="gelu"),
              TOL_F32 if dtype == torch.float32 else TOL_BF16)

    # the layer index of a pooled band step: group i reads w[widx[i]] of the
    # stack, held to the bit against the same launch on the weights
    # gathered into group order; the main-path shape is two bands (16 + 8
    # layers) of the FFN up projection in one launch over the 16-layer stack
    gmm_index = {}
    for label, (g_, r_, k_, n_, lw, act, with_bias) in [
            ("main 24 groups from 16 layers, up 2048x8192", (24, T, D, F, 16, None, False)),
            ("odd 5 groups from 3 layers, bias+gelu", (5, 130, 72, 136, 3, "gelu", True))]:
        xo, wo = rnd(g_, r_, k_), rnd(lw, k_, n_, scale=k_ ** -0.5)
        bo = rnd(lw, n_) if with_bias else None
        order = (list(range(16)) + list(range(8)) if g_ == 24
                 else [2, 0, 0, 1, 2])
        idx = torch.tensor(order, device=dev)
        widx = idx.to(torch.int32)
        wg = wo[idx].contiguous()
        bg = bo[idx].contiguous() if with_bias else None
        got = grouped_matmul.grouped_matmul(xo, wo, bo, activation=act, widx=widx)
        want = grouped_matmul.grouped_matmul(xo, wg, bg, activation=act)
        same = same_bits(got, want)
        row = dict(bitwise=same,
                   ms_indexed=time_ms(lambda: grouped_matmul.grouped_matmul(
                       xo, wo, bo, activation=act, widx=widx)),
                   ms_gathered=time_ms(lambda: grouped_matmul.grouped_matmul(
                       xo, wg, bg, activation=act)),
                   ms_gather_then_launch=time_ms(lambda: grouped_matmul.grouped_matmul(
                       xo, wo[idx], None if bo is None else bo[idx], activation=act)),
                   route=grouped_matmul.route(xo, wo, got))
        log(f"  grouped_matmul layer index, {label}: equal to the gathered launch to the "
            f"bit {same}; indexed {row['ms_indexed']:.4f} ms, gathered weights "
            f"{row['ms_gathered']:.4f} ms, gather + launch {row['ms_gather_then_launch']:.4f} "
            f"ms (route {row['route']}) -> {'ok' if same else 'FAIL'}; card {smi}")
        if not same:
            failures.append(f"grouped_matmul layer index {label}")
        gmm_index[label] = row
        del xo, wo, bo, wg, bg, got, want
    summary["grouped_matmul"]["layer_index"] = gmm_index
    torch.cuda.empty_cache()

    # flash_attention: the cell's 5-D layout, read through strides
    q5, k5, v5 = rnd(G, 1, T, Hq, hd), rnd(G, 1, T, Hkv, hd), rnd(G, 1, T, Hkv, hd)

    def flat(a):
        return a.reshape((G,) + a.shape[2:]).transpose(1, 2)
    ref32 = flash_attention.flash_attention_plain(flat(q5).float(), flat(k5).float(),
                                                  flat(v5).float())
    err = check("flash_attention causal GQA [16,32,1152,64]",
                ops.segment_attention(q5, k5, v5, causal=True),
                ref32.transpose(1, 2).reshape(q5.shape), TOL_BF16)
    plain16 = flash_attention.flash_attention_plain(flat(q5), flat(k5), flat(v5))
    log("  (the plain version on the bf16 tensors, which rounds its scores to bf16, "
        f"is at worst row rel err {row_rel(plain16, ref32):.3e} of the same reference)")
    del ref32, plain16
    qc, kc, vc = flat(q5).contiguous(), flat(k5).contiguous(), flat(v5).contiguous()
    pairs = T * (T + 1) / 2
    # the softmax's exponentials run on the special-function units beside
    # the tensor cores: at hd 64 they bound the kernel about as tightly
    t = timed("flash_attention [16,32,1152,64]",
              lambda: ops.segment_attention(q5, k5, v5, causal=True),
              lambda: flash_attention.flash_attention_plain(flat(q5), flat(k5), flat(v5)),
              lambda: torch.nn.functional.scaled_dot_product_attention(
                  qc, kc, vc, is_causal=True, enable_gqa=True),
              flops_bf16=4.0 * G * Hq * hd * pairs, exps=G * Hq * pairs,
              nbytes=2.0 * G * (2 * Hq * T * hd + 2 * Hkv * T * hd))
    summary["flash_attention"] = dict(t, max_abs_err=err, shape=f"q[{G},{Hq},{T},{hd}] k/v[{G},{Hkv},{T},{hd}]")
    log(f"  (route of the cell's strided views: {flash_attention.route(flat(q5), flat(k5), flat(v5))})")
    del q5, k5, v5, qc, kc, vc
    # hd 128 (llama-3b/8b-armt's head dim), the cell's layout, 24 q heads
    Hq3, hd3 = 24, 128
    q5, k5, v5 = rnd(G, 1, T, Hq3, hd3), rnd(G, 1, T, Hkv, hd3), rnd(G, 1, T, Hkv, hd3)
    ref32 = flash_attention.flash_attention_plain(flat(q5).float(), flat(k5).float(),
                                                  flat(v5).float())
    check(f"flash_attention causal GQA hd 128 [16,{Hq3},1152,{hd3}]",
          ops.segment_attention(q5, k5, v5, causal=True),
          ref32.transpose(1, 2).reshape(q5.shape), TOL_BF16)
    t3 = time_ms(lambda: ops.segment_attention(q5, k5, v5, causal=True))
    log(f"  flash_attention hd 128 [16,{Hq3},1152,{hd3}]: kernel {t3:.4f} ms; route "
        f"{flash_attention.route(flat(q5), flat(k5), flat(v5))}")
    del q5, k5, v5, ref32
    for dtype, (n_, hq_, hk_, t_, hd_, win) in [(torch.float32, (2, 4, 2, 45, 40, 17)),
                                                (torch.bfloat16, (2, 4, 2, 100, 64, 31))]:
        qo, ko, vo = (rnd(n_, hq_, t_, hd_, dtype=dtype), rnd(n_, hk_, t_, hd_, dtype=dtype),
                      rnd(n_, hk_, t_, hd_, dtype=dtype))
        check(f"flash_attention odd {dtype} q[{n_},{hq_},{t_},{hd_}] window {win}",
              flash_attention.flash_attention(qo, ko, vo, causal=True, window=win),
              flash_attention.flash_attention_plain(qo.float(), ko.float(), vo.float(),
                                                    causal=True, window=win),
              TOL_F32 if dtype == torch.float32 else TOL_BF16)

    # armt_read / armt_update: per-group weights, fp32 state
    A = rnd(G, P, D, scale=0.1, dtype=torch.float32)
    z = torch.rand(G, P, generator=gen).to(dev) + 0.5
    wq, wk = rnd(G, D, dm, scale=D ** -0.5), rnd(G, D, dm, scale=D ** -0.5)
    wv, wb = rnd(G, D, D, scale=D ** -0.5), rnd(G, D, 1, scale=D ** -0.5)
    err = check("armt_read [16,1152,2048] A[16,384,2048]",
                armt_memory.armt_read(x, wq, A, z),
                armt_memory.armt_read_plain(x.float(), wq.float(), A, z), TOL_BF16)
    # bf16 activations: phi A runs on the tensor cores as a three-term bf16
    # split (K = 3P) after the q projection, so it is priced at the bf16
    # peak; only phi z is fp32
    t = timed("armt_read", lambda: armt_memory.armt_read(x, wq, A, z),
              lambda: armt_memory.armt_read_plain(x, wq, A, z),
              flops_bf16=2.0 * G * T * D * dm + 3 * 2.0 * G * T * P * D,
              flops_fp32=2.0 * G * T * P,
              nbytes=2.0 * G * T * D + 2.0 * G * D * dm + 4.0 * G * P * (D + 1) + 2.0 * G * T * D)
    summary["armt_read"] = dict(t, max_abs_err=err, shape=f"x[{G},{T},{D}] A[{G},{P},{D}]")
    # device launches of one bf16 call (torch.profiler): the q projection on
    # the GEMM, the splits of phi and A, and their product, three
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        armt_memory.armt_read(x, wq, A, z)
        sync()
    read_kernels = [ev.name for ev in prof.events() if ev.device_type.name == "CUDA"]
    summary["armt_read"]["device_launches_per_call"] = len(read_kernels)
    log(f"  armt_read: {len(read_kernels)} device launches per call "
        f"({', '.join(k[:40] for k in read_kernels)}) -> "
        f"{'ok' if len(read_kernels) == 3 else 'FAIL'}")
    if len(read_kernels) != 3:
        failures.append(f"armt_read launched {len(read_kernels)} kernels, not 3")
    y = rnd(G, 1, T, D)
    m = y[:, :, -Mt:, :].reshape(G, Mt, D)          # strided, as the cell passes it
    err = check("armt_update m[16,128,2048] A[16,384,2048]",
                armt_memory.armt_update(m, wk, wv, wb, A, z),
                armt_memory.armt_update_plain(m.float(), wk.float(), wv.float(), wb.float(), A, z),
                TOL_STATE)
    t = timed("armt_update", lambda: armt_memory.armt_update(m, wk, wv, wb, A, z),
              lambda: armt_memory.armt_update_plain(m, wk, wv, wb, A, z),
              flops_bf16=2.0 * G * Mt * D * (dm + 1 + D),
              flops_fp32=4.0 * G * Mt * P * D,
              nbytes=2.0 * G * (Mt * D + D * (dm + 1 + D)) + 8.0 * G * P * (D + 1))
    summary["armt_update"] = dict(t, max_abs_err=err, shape=f"m[{G},{Mt},{D}] A[{G},{P},{D}]")
    del A, z, wq, wk, wv, wb, x, y, m
    g2 = 2
    for dtype in (torch.float32, torch.bfloat16):
        xo, mo = rnd(6, 13, 40, dtype=dtype), rnd(6, 5, 40, dtype=dtype)
        wqo, wko = rnd(g2, 40, 8, scale=0.3, dtype=dtype), rnd(g2, 40, 8, scale=0.3, dtype=dtype)
        wvo, wbo = rnd(g2, 40, 52, scale=0.3, dtype=dtype), rnd(g2, 40, 1, scale=0.3, dtype=dtype)
        Ao = rnd(6, 48, 52, scale=0.1, dtype=torch.float32)
        zo = torch.rand(6, 48, generator=gen).to(dev)
        check(f"armt_read odd {dtype} x[6,13,40] dm 8 Dv 52",
              armt_memory.armt_read(xo, wqo, Ao, zo),
              armt_memory.armt_read_plain(xo.float(), wqo.float(), Ao, zo),
              TOL_F32 if dtype == torch.float32 else TOL_BF16)
        check(f"armt_update odd {dtype} m[6,5,40] dm 8 Dv 52",
              armt_memory.armt_update(mo, wko, wvo, wbo, Ao, zo),
              armt_memory.armt_update_plain(mo.float(), wko.float(), wvo.float(), wbo.float(),
                                            Ao, zo), TOL_STATE)

    # grouped_matmul_armt_update: the B = 1 cell's down projection with the
    # residual added before the cast, then the update from y's memory rows
    xf, wd, res = rnd(G, T, F), rnd(G, F, D, scale=F ** -0.5), rnd(G, T, D)
    wk, wv, wb = (rnd(G, D, dm, scale=D ** -0.5), rnd(G, D, D, scale=D ** -0.5),
                  rnd(G, D, 1, scale=D ** -0.5))
    A = rnd(G, P, D, scale=0.1, dtype=torch.float32)
    z = torch.rand(G, P, generator=gen).to(dev) + 0.5

    def fused():
        return grouped_matmul.grouped_matmul_armt_update(xf, wd, res, wk, wv, wb, A, z, M=Mt)
    y, A2, z2 = fused()
    y32 = grouped_matmul.grouped_matmul_armt_update_plain(
        xf.float(), wd.float(), res.float(), wk.float(), wv.float(), wb.float(), A, z,
        M=Mt)[0]
    err = check("grouped_matmul_armt_update y [16,1152,8192]@[16,8192,2048] + res",
                y, y32, TOL_BF16)
    # the update is held on the kernel's own y rows, so only its rounding counts
    err = max(err, check("grouped_matmul_armt_update A', z' (update of its own y rows)",
                         (A2, z2), armt_memory.armt_update_plain(
                             y[:, -Mt:].float(), wk.float(), wv.float(), wb.float(), A, z),
                         TOL_STATE))
    two = res + grouped_matmul.grouped_matmul(xf, wd)      # the B > 1 path: rounds twice
    log(f"  (y against the fp32 oracle: fused {row_rel(y, y32):.3e}, two-launch "
        f"res + bf16(x@w) {row_rel(two, y32):.3e}; fused vs two-launch "
        f"{row_rel(y, two):.3e})")
    del y32, two, y, A2, z2
    t = timed("grouped_matmul_armt_update", fused,
              lambda: grouped_matmul.grouped_matmul_armt_update_plain(
                  xf, wd, res, wk, wv, wb, A, z, M=Mt),
              lambda: torch.baddbmm(res, xf, wd),
              flops_bf16=2.0 * G * T * F * D + 2.0 * G * Mt * D * (dm + 1 + D),
              flops_fp32=4.0 * G * Mt * P * D,
              nbytes=2.0 * G * (T * F + F * D + 2 * T * D + D * (dm + 1 + D))
              + 8.0 * G * P * (D + 1))
    log("  (library: torch.baddbmm(res, x, w), the y part only)")
    summary["grouped_matmul_armt_update"] = dict(
        t, max_abs_err=err, shape=f"x[{G},{T},{F}] w[{G},{F},{D}] A[{G},{P},{D}] M {Mt}")
    del xf, wd, res, wk, wv, wb, A, z
    for dtype, (g_, r_, k_, n_, m_) in [(torch.float32, (3, 37, 50, 40, 5)),
                                        (torch.bfloat16, (3, 37, 48, 40, 5)),
                                        (torch.bfloat16, (2, 130, 72, 56, 128))]:
        xo, wo, ro = (rnd(g_, r_, k_, dtype=dtype), rnd(g_, k_, n_, scale=0.2, dtype=dtype),
                      rnd(g_, r_, n_, dtype=dtype))
        bo = rnd(g_, n_, dtype=dtype)
        wko, wvo, wbo = (rnd(g_, n_, 8, scale=0.3, dtype=dtype),
                         rnd(g_, n_, 32, scale=0.3, dtype=dtype),
                         rnd(g_, n_, 1, scale=0.3, dtype=dtype))
        Ao = rnd(g_, 48, 32, scale=0.1, dtype=torch.float32)
        zo = torch.rand(g_, 48, generator=gen).to(dev)
        yo, Ao2, zo2 = grouped_matmul.grouped_matmul_armt_update(xo, wo, ro, wko, wvo, wbo,
                                                                 Ao, zo, bo, M=m_)
        name = f"grouped_matmul_armt_update odd {dtype} [{g_},{r_},{k_}]x[{k_},{n_}] M {m_}"
        check(name + " y", yo, grouped_matmul.grouped_matmul_armt_update_plain(
            xo.float(), wo.float(), ro.float(), wko.float(), wvo.float(), wbo.float(), Ao,
            zo, bo.float(), M=m_)[0], TOL_F32 if dtype == torch.float32 else TOL_BF16)
        check(name + " A', z'", (Ao2, zo2), armt_memory.armt_update_plain(
            yo[:, -m_:].float(), wko.float(), wvo.float(), wbo.float(), Ao, zo), TOL_STATE)

    # decode_attention: one token per slot against the decode cache of 4
    # slots (seg_len + M rows), ragged lengths and every slot at full length
    Bd, Sd = 4, T
    qd = rnd(Bd, Hq, hd)
    kd, vd = rnd(Bd, Sd, Hkv, hd), rnd(Bd, Sd, Hkv, hd)
    err = 0.0
    # 64-key chunks: lengths at chunk edges, length 1, windows inside one
    # chunk (keys 960-999) and across chunks (89-128)
    for lens, win in [((63, 64, 65, 1), 0), ((1000, 129, 1152, 640), 40),
                      ((1024, 517, 1, 1000), 0), ((1024,) * Bd, 0)]:
        Ld = torch.tensor(lens, dtype=torch.int32, device=dev)
        err = max(err, check(
            f"decode_attention q[{Bd},{Hq},{hd}] k/v[{Bd},{Sd},{Hkv},{hd}] lengths {lens} "
            f"window {win}", decode_attention.decode_attention(qd, kd, vd, Ld, window=win),
            decode_attention.decode_attention_plain(qd.float(), kd.float(), vd.float(), Ld,
                                                    window=win), TOL_BF16))
    q4, k4, v4 = qd[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2)
    mask4 = (torch.arange(Sd, device=dev) < Ld[:, None])[:, None, None, :]
    n_keys = float(sum(lens))
    t = timed("decode_attention (4 slots at 1024 keys)",
              lambda: decode_attention.decode_attention(qd, kd, vd, Ld),
              lambda: decode_attention.decode_attention_plain(qd, kd, vd, Ld),
              lambda: torch.nn.functional.scaled_dot_product_attention(
                  q4, k4, v4, attn_mask=mask4, enable_gqa=True),
              flops_fp32=4.0 * n_keys * Hq * hd,
              nbytes=2.0 * 2 * n_keys * Hkv * hd + 2.0 * 2 * Bd * Hq * hd + 4.0 * Bd)
    log("  (library: scaled_dot_product_attention, enable_gqa, boolean length mask)")
    summary["decode_attention"] = dict(
        t, max_abs_err=err, shape=f"q[{Bd},{Hq},{hd}] k/v[{Bd},{Sd},{Hkv},{hd}] lengths {lens}")
    del qd, kd, vd, q4, k4, v4
    for dtype in (torch.float32, torch.bfloat16):
        for (b_, hq_, hk_, s_, hd_, lens, win) in [(3, 4, 4, 77, 64, (77, 40, 1), 0),
                                                   (2, 8, 2, 100, 40, (100, 63), 17)]:
            qo = rnd(b_, hq_, hd_, dtype=dtype)
            cache = rnd(b_, s_, 2 * hk_, hd_, dtype=dtype)   # strided k/v views
            ko, vo = cache[:, :, :hk_], cache[:, :, hk_:]
            Lo = torch.tensor(lens, dtype=torch.int32, device=dev)
            check(f"decode_attention odd {dtype} q[{b_},{hq_},{hd_}] S {s_} lengths {lens} "
                  f"window {win}",
                  decode_attention.decode_attention(qo, ko, vo, Lo, window=win),
                  decode_attention.decode_attention_plain(qo.float(), ko.float(), vo.float(),
                                                          Lo, window=win),
                  TOL_F32 if dtype == torch.float32 else TOL_BF16)

    # long shapes of the full-attention and full-KV paths (hd 64, 32 q heads
    # over 8 kv heads): flash at T = S = 16,384 and 131,072 (a full-mode
    # prompt, a cache-mode prefill), decode over caches of 17,432 and 131,136
    # keys (cache-mode decode after 16,384 + 1,000 and 131,072 tokens). flash
    # is held against its plain version at 16,384 with 4 q heads over 1 kv
    # head (at 32 heads the plain [Hq,T,S] fp32 scores take 34 GB) and at
    # 131,072 on three slices of 192 query rows; decode whole, with lengths
    # that leave the last 64-key-multiple split full, one key long and empty.
    # The library yardstick is SDPA's flash backend (enable_gqa where the
    # backend takes it); no plain time at 32 heads (it would not fit).
    from torch.nn.attention import SDPBackend, sdpa_kernel
    long_rows = {"flash_attention": {}, "decode_attention": {}}

    def flash_rows_plain(q, k, v, t0, t1):
        """The plain causal attention of query rows [t0, t1) in fp32 (row t
        sees keys <= t) -> [N, Hq, t1 - t0, hd]."""
        rep_ = q.shape[1] // k.shape[1]
        kk = k[:, :, :t1].float().repeat_interleave(rep_, 1)
        vv = v[:, :, :t1].float().repeat_interleave(rep_, 1)
        s_ = torch.matmul(q[:, :, t0:t1].float(), kk.transpose(-1, -2)) * q.shape[-1] ** -0.5
        vis = (torch.arange(t1, device=dev)[None, :]
               <= torch.arange(t0, t1, device=dev)[:, None])
        s_ = s_.masked_fill(~vis, float("-inf"))
        return torch.matmul(torch.softmax(s_, -1), vv)

    def sdpa_causal(q, k, v):
        """(call, note): SDPA's flash backend on q [1,Hq,T,hd], k/v
        [1,Hkv,S,hd], with enable_gqa if that backend takes it, else on
        k/v expanded to Hq heads outside the timed call."""
        def gqa():
            with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                return torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True)
        try:
            gqa()
            return gqa, "SDPA flash backend, enable_gqa"
        except RuntimeError:
            ke = k.repeat_interleave(q.shape[1] // k.shape[1], 1)
            ve = v.repeat_interleave(q.shape[1] // k.shape[1], 1)

            def expanded():
                with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                    return torch.nn.functional.scaled_dot_product_attention(
                        q, ke, ve, is_causal=True)
            return expanded, "SDPA flash backend, k/v expanded to 32 heads"

    Tl = 16384
    ql, kl, vl = rnd(1, 4, Tl, hd), rnd(1, 1, Tl, hd), rnd(1, 1, Tl, hd)
    check(f"flash_attention causal q[1,4,{Tl},{hd}] k/v[1,1,{Tl},{hd}]",
          flash_attention.flash_attention(ql, kl, vl),
          flash_attention.flash_attention_plain(ql.float(), kl.float(), vl.float()), TOL_BF16)
    del ql, kl, vl
    torch.cuda.empty_cache()
    for Tl in (16384, 131072):
        ql, kl, vl = rnd(1, Hq, Tl, hd), rnd(1, Hkv, Tl, hd), rnd(1, Hkv, Tl, hd)
        err = 0.0
        if Tl == 131072:
            out = flash_attention.flash_attention(ql, kl, vl)
            for t0 in (0, Tl // 2, Tl - 192):
                err = max(err, check(f"flash_attention q[1,{Hq},{Tl},{hd}] rows {t0}-{t0 + 191}",
                                     out[:, :, t0:t0 + 192],
                                     flash_rows_plain(ql, kl, vl, t0, t0 + 192), TOL_BF16))
            del out
        pairs = Tl * (Tl + 1) / 2
        lib, note = sdpa_causal(ql, kl, vl)
        ms = time_ms(lambda: flash_attention.flash_attention(ql, kl, vl), iters=5, warmup=1)
        lib_ms = time_ms(lib, iters=5, warmup=1)
        b_ms, b_by = bound(flops_bf16=4.0 * Hq * hd * pairs, exps=Hq * pairs,
                           nbytes=2.0 * (2 * Hq * Tl * hd + 2 * Hkv * Tl * hd))
        log(f"  flash_attention q[1,{Hq},{Tl},{hd}] k/v[1,{Hkv},{Tl},{hd}] causal: kernel "
            f"{ms:.4f} ms  library {lib_ms:.4f} ms ({note})  bound {b_ms:.4f} ms ({b_by})  "
            f"kernel/bound {ms / b_ms:.2f}  plain not measured (the [Hq,T,S] fp32 scores "
            f"take {4.0 * Hq * Tl * Tl / 1e9:.0f} GB); card {smi}")
        long_rows["flash_attention"][f"T=S={Tl}"] = dict(
            ms=ms, library_ms=lib_ms, library=note, bound_ms=b_ms, bound_by=b_by,
            max_abs_err=err if Tl == 131072 else None, plain_ms=None)
        del ql, kl, vl, lib
        torch.cuda.empty_cache()
    for Sl in (17432, 131136):
        chunk_, n_splits_ = decode_attention.split_plan(Sl)
        last = (n_splits_ - 1) * chunk_
        qd = rnd(3, Hq, hd)
        kd, vd = rnd(3, Sl, Hkv, hd), rnd(3, Sl, Hkv, hd)
        lens = (Sl, last + 1, last)
        Ld = torch.tensor(lens, dtype=torch.int32, device=dev)
        err = check(f"decode_attention q[3,{Hq},{hd}] k/v[3,{Sl},{Hkv},{hd}] lengths {lens} "
                    f"({n_splits_} splits of {chunk_} keys, the last {Sl - last})",
                    decode_attention.decode_attention(qd, kd, vd, Ld),
                    decode_attention.decode_attention_plain(qd.float(), kd.float(), vd.float(),
                                                            Ld), TOL_BF16)
        q1, k1, v1 = qd[:1], kd[:1], vd[:1]
        L1 = Ld[:1]
        q4, k4, v4 = q1[:, :, None], k1.transpose(1, 2), v1.transpose(1, 2)
        mask4 = (torch.arange(Sl, device=dev) < L1[:, None])[:, None, None, :]
        t = timed(f"decode_attention q[1,{Hq},{hd}] over {Sl} keys",
                  lambda: decode_attention.decode_attention(q1, k1, v1, L1),
                  lambda: decode_attention.decode_attention_plain(q1, k1, v1, L1),
                  lambda: torch.nn.functional.scaled_dot_product_attention(
                      q4, k4, v4, attn_mask=mask4, enable_gqa=True),
                  flops_fp32=4.0 * Sl * Hq * hd,
                  nbytes=2.0 * 2 * Sl * Hkv * hd + 2.0 * 2 * Hq * hd + 4.0)
        long_rows["decode_attention"][f"S={Sl}"] = dict(t, max_abs_err=err, splits=n_splits_,
                                                        chunk=chunk_)
        del qd, kd, vd, q1, k1, v1, q4, k4, v4, mask4
        torch.cuda.empty_cache()

    # the dense configs' shapes (phase (r)): flash at h2o-danube-1.8b's head
    # dim 80 (its band step, 32 q over 8 kv heads; and T = S = 16,384,
    # held at 4 q heads over 1 kv head with its 4,096-key window, timed
    # causal at 32 over 8 heads beside SDPA's flash backend), and decode at
    # chatglm3-6b's 16 q heads per kv head (32 over 2, hd 128; 4 slots of a
    # 1,152-row cache at 1,024 keys, and 4 rows over 131,136 keys)
    Hqd, Hkvd, hdd = 32, 8, 80
    q5, k5, v5 = rnd(G, 1, T, Hqd, hdd), rnd(G, 1, T, Hkvd, hdd), rnd(G, 1, T, Hkvd, hdd)
    ref32 = flash_attention.flash_attention_plain(flat(q5).float(), flat(k5).float(),
                                                  flat(v5).float())
    err = check(f"flash_attention causal GQA hd 80 [16,{Hqd},1152,{hdd}]",
                ops.segment_attention(q5, k5, v5, causal=True),
                ref32.transpose(1, 2).reshape(q5.shape), TOL_BF16)
    del ref32
    qc, kc, vc = flat(q5).contiguous(), flat(k5).contiguous(), flat(v5).contiguous()
    route80 = flash_attention.route(flat(q5), flat(k5), flat(v5))
    pairs_b = T * (T + 1) / 2
    t = timed(f"flash_attention hd 80 [16,{Hqd},1152,{hdd}] (route {route80})",
              lambda: ops.segment_attention(q5, k5, v5, causal=True),
              lambda: flash_attention.flash_attention_plain(flat(q5), flat(k5), flat(v5)),
              lambda: torch.nn.functional.scaled_dot_product_attention(
                  qc, kc, vc, is_causal=True, enable_gqa=True),
              flops_bf16=4.0 * G * Hqd * hdd * pairs_b, exps=G * Hqd * pairs_b,
              nbytes=2.0 * G * (2 * Hqd * T * hdd + 2 * Hkvd * T * hdd))
    long_rows["flash_attention"]["hd 80 band [16,32,1152,80]"] = dict(
        t, max_abs_err=err, route=route80)
    if route80 != "wgmma":
        failures.append(f"flash_attention at hd 80 took the {route80} route")
    del q5, k5, v5, qc, kc, vc
    Tl = 16384
    ql, kl, vl = rnd(1, 4, Tl, hdd), rnd(1, 1, Tl, hdd), rnd(1, 1, Tl, hdd)
    err = check(f"flash_attention causal window 4096 q[1,4,{Tl},{hdd}] k/v[1,1,{Tl},{hdd}]",
                flash_attention.flash_attention(ql, kl, vl, window=4096),
                flash_attention.flash_attention_plain(ql.float(), kl.float(), vl.float(),
                                                      window=4096), TOL_BF16)
    del ql, kl, vl
    torch.cuda.empty_cache()
    ql, kl, vl = rnd(1, Hqd, Tl, hdd), rnd(1, Hkvd, Tl, hdd), rnd(1, Hkvd, Tl, hdd)
    pairs_l = Tl * (Tl + 1) / 2
    lib, note = sdpa_causal(ql, kl, vl)
    ms = time_ms(lambda: flash_attention.flash_attention(ql, kl, vl), iters=5, warmup=1)
    lib_ms = time_ms(lib, iters=5, warmup=1)
    b_ms, b_by = bound(flops_bf16=4.0 * Hqd * hdd * pairs_l, exps=Hqd * pairs_l,
                       nbytes=2.0 * (2 * Hqd * Tl * hdd + 2 * Hkvd * Tl * hdd))
    log(f"  flash_attention q[1,{Hqd},{Tl},{hdd}] k/v[1,{Hkvd},{Tl},{hdd}] causal: kernel "
        f"{ms:.4f} ms  library {lib_ms:.4f} ms ({note})  bound {b_ms:.4f} ms ({b_by})  "
        f"kernel/bound {ms / b_ms:.2f}  plain not measured; card {smi}")
    long_rows["flash_attention"][f"hd 80 T=S={Tl}"] = dict(
        ms=ms, library_ms=lib_ms, library=note, bound_ms=b_ms, bound_by=b_by,
        max_abs_err=err, plain_ms=None)
    del ql, kl, vl, lib
    torch.cuda.empty_cache()
    # kimi-k2-1t-a32b's head shape (phase (s)): flash at hd 112, 64 q over 8
    # kv heads, a band step of 16 layers, against its plain version and SDPA
    Hqk, Hkvk, hdk = 64, 8, 112
    q5, k5, v5 = rnd(G, 1, T, Hqk, hdk), rnd(G, 1, T, Hkvk, hdk), rnd(G, 1, T, Hkvk, hdk)
    ref32 = flash_attention.flash_attention_plain(flat(q5).float(), flat(k5).float(),
                                                  flat(v5).float())
    err = check(f"flash_attention causal GQA hd 112 [16,{Hqk},1152,{hdk}]",
                ops.segment_attention(q5, k5, v5, causal=True),
                ref32.transpose(1, 2).reshape(q5.shape), TOL_BF16)
    del ref32
    qc, kc, vc = flat(q5).contiguous(), flat(k5).contiguous(), flat(v5).contiguous()
    route112 = flash_attention.route(flat(q5), flat(k5), flat(v5))
    t = timed(f"flash_attention hd 112 [16,{Hqk},1152,{hdk}] (route {route112})",
              lambda: ops.segment_attention(q5, k5, v5, causal=True),
              lambda: flash_attention.flash_attention_plain(flat(q5), flat(k5), flat(v5)),
              lambda: torch.nn.functional.scaled_dot_product_attention(
                  qc, kc, vc, is_causal=True, enable_gqa=True),
              flops_bf16=4.0 * G * Hqk * hdk * pairs_b, exps=G * Hqk * pairs_b,
              nbytes=2.0 * G * (2 * Hqk * T * hdk + 2 * Hkvk * T * hdk))
    long_rows["flash_attention"]["hd 112 band [16,64,1152,112]"] = dict(
        t, max_abs_err=err, route=route112)
    if route112 != "wgmma":
        failures.append(f"flash_attention at hd 112 took the {route112} route")
    del q5, k5, v5, qc, kc, vc
    torch.cuda.empty_cache()
    # jamba-1.5-large's attention band (phase (t)): 2 layers (its 2
    # superblocks' attn layers), 64 q over 8 kv heads of 128, no rotary
    Gj, Hqj, Hkvj, hdj = 2, 64, 8, 128

    def flat_j(a):
        return a.reshape((Gj,) + a.shape[2:]).transpose(1, 2)
    q5, k5, v5 = rnd(Gj, 1, T, Hqj, hdj), rnd(Gj, 1, T, Hkvj, hdj), rnd(Gj, 1, T, Hkvj, hdj)
    ref32 = flash_attention.flash_attention_plain(flat_j(q5).float(), flat_j(k5).float(),
                                                  flat_j(v5).float())
    err = check(f"flash_attention causal GQA jamba band [{Gj},{Hqj},1152,{hdj}]",
                ops.segment_attention(q5, k5, v5, causal=True),
                ref32.transpose(1, 2).reshape(q5.shape), TOL_BF16)
    del ref32
    qc, kc, vc = flat_j(q5).contiguous(), flat_j(k5).contiguous(), flat_j(v5).contiguous()
    routej = flash_attention.route(flat_j(q5), flat_j(k5), flat_j(v5))
    t = timed(f"flash_attention jamba band [{Gj},{Hqj},1152,{hdj}] (route {routej})",
              lambda: ops.segment_attention(q5, k5, v5, causal=True),
              lambda: flash_attention.flash_attention_plain(flat_j(q5), flat_j(k5), flat_j(v5)),
              lambda: torch.nn.functional.scaled_dot_product_attention(
                  qc, kc, vc, is_causal=True, enable_gqa=True),
              flops_bf16=4.0 * Gj * Hqj * hdj * pairs_b, exps=Gj * Hqj * pairs_b,
              nbytes=2.0 * Gj * (2 * Hqj * T * hdj + 2 * Hkvj * T * hdj))
    long_rows["flash_attention"]["jamba band [2,64,1152,128]"] = dict(
        t, max_abs_err=err, route=routej)
    if routej != "wgmma":
        failures.append(f"flash_attention at jamba's band took the {routej} route")
    del q5, k5, v5, qc, kc, vc
    torch.cuda.empty_cache()
    Hqg, Hkvg, hdg = 32, 2, 128
    log(f"  decode_attention at {Hqg // Hkvg} q heads per kv head of {hdg}: head groups "
        f"{decode_attention.head_groups(Hqg // Hkvg, hdg)} (heads a block, blocks a kv head)")
    for Bg, Sg, lens in [(4, T, (1024,) * 4), (4, 131136, (131136, 70001, 1, 131000))]:
        qd = rnd(Bg, Hqg, hdg)
        kd, vd = rnd(Bg, Sg, Hkvg, hdg), rnd(Bg, Sg, Hkvg, hdg)
        Ld = torch.tensor(lens, dtype=torch.int32, device=dev)
        err = check(f"decode_attention q[{Bg},{Hqg},{hdg}] k/v[{Bg},{Sg},{Hkvg},{hdg}] "
                    f"lengths {lens}", decode_attention.decode_attention(qd, kd, vd, Ld),
                    decode_attention.decode_attention_plain(qd.float(), kd.float(), vd.float(),
                                                            Ld), TOL_BF16)
        alone = all(same_bits(decode_attention.decode_attention(qd, kd, vd, Ld)[b],
                              decode_attention.decode_attention(qd[b:b + 1], kd[b:b + 1],
                                                                vd[b:b + 1], Ld[b:b + 1])[0])
                    for b in range(Bg))
        log(f"  each row batched equal to the row alone, to the bit: {alone} -> "
            f"{'ok' if alone else 'FAIL'}")
        if not alone:
            failures.append(f"decode_attention rep 16 over {Sg} keys: a row's bits depend on "
                            "its batch")
        q4, k4, v4 = qd[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2)
        mask4 = (torch.arange(Sg, device=dev) < Ld[:, None])[:, None, None, :]
        n_keys = float(sum(lens))
        t = timed(f"decode_attention rep 16 q[{Bg},{Hqg},{hdg}] over {Sg} keys, lengths {lens}",
                  lambda: decode_attention.decode_attention(qd, kd, vd, Ld),
                  lambda: decode_attention.decode_attention_plain(qd, kd, vd, Ld),
                  lambda: torch.nn.functional.scaled_dot_product_attention(
                      q4, k4, v4, attn_mask=mask4, enable_gqa=True),
                  flops_fp32=4.0 * n_keys * Hqg * hdg,
                  nbytes=2.0 * 2 * n_keys * Hkvg * hdg + 2.0 * 2 * Bg * Hqg * hdg + 4.0 * Bg)
        long_rows["decode_attention"][f"rep 16 hd 128 B={Bg} S={Sg}"] = dict(
            t, max_abs_err=err, lengths=list(lens))
        del qd, kd, vd, q4, k4, v4, mask4
        torch.cuda.empty_cache()
    # the MoE configs' decode heads (phase (s)): kimi-k2's 64 q over 8 kv
    # heads of 112 (rep 8, one head group of 896 outputs) and qwen2-moe's 16
    # over 16 of 128 (rep 1), 4 slots, on the ARMT decode cache (seg_len + M
    # rows) and the cache mode's (a 2048-token prompt + 64 rows)
    # (and jamba-1.5-large's 64 over 8 of 128, rep 8, phase (t))
    for Hqm, Hkvm, hdm in ((64, 8, 112), (16, 16, 128), (64, 8, 128)):
        rep = Hqm // Hkvm
        for Sm, lens in ((T, (1152, 517, 1, 1025)), (2112, (2049, 2064, 1, 1500))):
            qd = rnd(4, Hqm, hdm)
            kd, vd = rnd(4, Sm, Hkvm, hdm), rnd(4, Sm, Hkvm, hdm)
            Ld = torch.tensor(lens, dtype=torch.int32, device=dev)
            err = check(f"decode_attention rep {rep} q[4,{Hqm},{hdm}] k/v[4,{Sm},{Hkvm},{hdm}] "
                        f"lengths {lens}", decode_attention.decode_attention(qd, kd, vd, Ld),
                        decode_attention.decode_attention_plain(qd.float(), kd.float(),
                                                                vd.float(), Ld), TOL_BF16)
            alone = all(same_bits(decode_attention.decode_attention(qd, kd, vd, Ld)[b],
                                  decode_attention.decode_attention(qd[b:b + 1], kd[b:b + 1],
                                                                    vd[b:b + 1], Ld[b:b + 1])[0])
                        for b in range(4))
            log(f"  each row batched equal to the row alone, to the bit: {alone} -> "
                f"{'ok' if alone else 'FAIL'}")
            if not alone:
                failures.append(f"decode_attention rep {rep} hd {hdm} over {Sm} keys: a row's "
                                "bits depend on its batch")
            q4, k4, v4 = qd[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2)
            mask4 = (torch.arange(Sm, device=dev) < Ld[:, None])[:, None, None, :]
            n_keys = float(sum(lens))
            t = timed(f"decode_attention rep {rep} q[4,{Hqm},{hdm}] over {Sm} keys, "
                      f"lengths {lens}",
                      lambda: decode_attention.decode_attention(qd, kd, vd, Ld),
                      lambda: decode_attention.decode_attention_plain(qd, kd, vd, Ld),
                      lambda: torch.nn.functional.scaled_dot_product_attention(
                          q4, k4, v4, attn_mask=mask4, enable_gqa=True),
                      flops_fp32=4.0 * n_keys * Hqm * hdm,
                      nbytes=2.0 * 2 * n_keys * Hkvm * hdm + 2.0 * 2 * 4 * Hqm * hdm + 4.0 * 4)
            long_rows["decode_attention"][f"rep {rep} hd {hdm} B=4 S={Sm}"] = dict(
                t, max_abs_err=err, lengths=list(lens))
            del qd, kd, vd, q4, k4, v4, mask4
    torch.cuda.empty_cache()
    # armt_update at kimi-k2's width, as the attn_moe cell calls it at B = 1:
    # the last 128 rows of a band of 3 layers' y [3, 1, 1152, 7168]
    # (strided), d_mem 64, against its plain version
    Gk, Dk = 3, 7168
    Ak = rnd(Gk, P, Dk, scale=0.1, dtype=torch.float32)
    zk = torch.rand(Gk, P, generator=gen).to(dev) + 0.5
    wkk, wvk = rnd(Gk, Dk, dm, scale=Dk ** -0.5), rnd(Gk, Dk, Dk, scale=Dk ** -0.5)
    wbk = rnd(Gk, Dk, 1, scale=Dk ** -0.5)
    yk = rnd(Gk, 1, T, Dk)
    mk = yk[:, :, -Mt:, :].reshape(Gk, Mt, Dk)
    err = check(f"armt_update m[{Gk},{Mt},{Dk}] A[{Gk},{P},{Dk}]",
                armt_memory.armt_update(mk, wkk, wvk, wbk, Ak, zk),
                armt_memory.armt_update_plain(mk.float(), wkk.float(), wvk.float(), wbk.float(),
                                              Ak, zk), TOL_STATE)
    t = timed(f"armt_update at kimi-k2's width m[{Gk},{Mt},{Dk}]",
              lambda: armt_memory.armt_update(mk, wkk, wvk, wbk, Ak, zk),
              lambda: armt_memory.armt_update_plain(mk, wkk, wvk, wbk, Ak, zk),
              flops_bf16=2.0 * Gk * Mt * Dk * (dm + 1 + Dk),
              flops_fp32=4.0 * Gk * Mt * P * Dk,
              nbytes=2.0 * Gk * (Mt * Dk + Dk * (dm + 1 + Dk)) + 8.0 * Gk * P * (Dk + 1))
    long_rows["armt_update"] = {f"m[{Gk},{Mt},{Dk}] A[{Gk},{P},{Dk}]": dict(t, max_abs_err=err)}
    del Ak, zk, wkk, wvk, wbk, yk, mk
    torch.cuda.empty_cache()

    # whisper-medium's shapes (phase (u)): the GELU MLP's up projection over
    # the 16-layer band with its bias and tanh-GELU on the epilogue; the
    # dec cell's cross-attention, q [16,16,1152,64] against a cross K/V of
    # 1,500 frames read as [N,H,F,hd] views of its [G,B,F,H,hd] buffer, no
    # mask; the encoder's attention [1,16,1500,64] without a mask; and
    # decode's cross-attention, one query of 16 heads of 64 over the 1,500
    # frames (rep 1, every length 1,500), 4 slots
    Dw, Fw, Hw, hdw, Fr = 1024, 4096, 16, 64, 1500
    xw, ww, bw = rnd(G, T, Dw), rnd(G, Dw, Fw, scale=Dw ** -0.5), rnd(G, Fw)
    err = check(f"grouped_matmul whisper MLP up [{G},{T},{Dw}]x[{G},{Dw},{Fw}] bias+gelu",
                grouped_matmul.grouped_matmul(xw, ww, bw, activation="gelu"),
                grouped_matmul.grouped_matmul_plain(xw.float(), ww.float(), bw.float(),
                                                    activation="gelu"), TOL_BF16)
    routew = grouped_matmul.route(xw, ww, xw)
    t = timed(f"grouped_matmul whisper MLP up bias+gelu (route {routew})",
              lambda: grouped_matmul.grouped_matmul(xw, ww, bw, activation="gelu"),
              lambda: grouped_matmul.grouped_matmul_plain(xw, ww, bw, activation="gelu"),
              lambda: torch.baddbmm(bw[:, None, :], xw, ww),
              flops_bf16=2.0 * G * T * Dw * Fw,
              nbytes=2.0 * G * (T * Dw + Dw * Fw + T * Fw + Fw))
    long_rows["grouped_matmul"] = {
        f"whisper MLP up [{G},{T},{Dw}]x[{G},{Dw},{Fw}] bias+gelu": dict(
            t, max_abs_err=err, route=routew, library="torch.baddbmm (bias, no GELU)")}
    if routew != "wgmma":
        failures.append(f"grouped_matmul at whisper's MLP took the {routew} route")
    del xw, ww, bw
    for label, (Gq, Tq) in (("whisper cross", (G, T)), ("whisper encoder", (1, Fr))):
        q5 = rnd(Gq, 1, Tq, Hw, hdw)
        ck5, cv5 = rnd(Gq, 1, Fr, Hw, hdw), rnd(Gq, 1, Fr, Hw, hdw)

        def flat_w(a, Gq=Gq):
            return a.reshape((Gq,) + a.shape[2:]).transpose(1, 2)
        ref32 = flash_attention.flash_attention_plain(flat_w(q5).float(), flat_w(ck5).float(),
                                                      flat_w(cv5).float(), causal=False)
        shape = f"q[{Gq},{Hw},{Tq},{hdw}] k/v[{Gq},{Hw},{Fr},{hdw}]"
        err = check(f"flash_attention non-causal {label} {shape}",
                    ops.segment_attention(q5, ck5, cv5, causal=False),
                    ref32.transpose(1, 2).reshape(q5.shape), TOL_BF16)
        del ref32
        routew = flash_attention.route(flat_w(q5), flat_w(ck5), flat_w(cv5))
        qc, kc, vc = flat_w(q5).contiguous(), flat_w(ck5).contiguous(), flat_w(cv5).contiguous()
        pairs_w = float(Tq * Fr)
        t = timed(f"flash_attention {label} {shape} no mask (route {routew})",
                  lambda: ops.segment_attention(q5, ck5, cv5, causal=False),
                  lambda: flash_attention.flash_attention_plain(flat_w(q5), flat_w(ck5),
                                                                flat_w(cv5), causal=False),
                  lambda: torch.nn.functional.scaled_dot_product_attention(qc, kc, vc),
                  flops_bf16=4.0 * Gq * Hw * hdw * pairs_w, exps=Gq * Hw * pairs_w,
                  nbytes=2.0 * Gq * Hw * hdw * (2 * Tq + 2 * Fr))
        long_rows["flash_attention"][f"{label} {shape}"] = dict(t, max_abs_err=err,
                                                                route=routew)
        if routew != "wgmma":
            failures.append(f"flash_attention at {label} took the {routew} route")
        del q5, ck5, cv5, qc, kc, vc
    qd, kd, vd = rnd(4, Hw, hdw), rnd(4, Fr, Hw, hdw), rnd(4, Fr, Hw, hdw)
    Ld = torch.full((4,), Fr, dtype=torch.int32, device=dev)
    err = check(f"decode_attention whisper cross rep 1 q[4,{Hw},{hdw}] over {Fr} frames",
                decode_attention.decode_attention(qd, kd, vd, Ld),
                decode_attention.decode_attention_plain(qd.float(), kd.float(), vd.float(), Ld),
                TOL_BF16)
    alone = all(same_bits(decode_attention.decode_attention(qd, kd, vd, Ld)[b],
                          decode_attention.decode_attention(qd[b:b + 1], kd[b:b + 1],
                                                            vd[b:b + 1], Ld[b:b + 1])[0])
                for b in range(4))
    log(f"  split plan over {Fr} keys {decode_attention.split_plan(Fr)}, head groups "
        f"{decode_attention.head_groups(1, hdw)}; each row batched equal to the row alone, to "
        f"the bit: {alone} -> {'ok' if alone else 'FAIL'}")
    if not alone:
        failures.append("decode_attention whisper cross: a row's bits depend on its batch")
    q4, k4, v4 = qd[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2)
    t = timed(f"decode_attention whisper cross q[4,{Hw},{hdw}] over {Fr} frames",
              lambda: decode_attention.decode_attention(qd, kd, vd, Ld),
              lambda: decode_attention.decode_attention_plain(qd, kd, vd, Ld),
              lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4),
              flops_fp32=4.0 * 4 * Fr * Hw * hdw,
              nbytes=2.0 * 2 * 4 * Fr * Hw * hdw + 2.0 * 2 * 4 * Hw * hdw + 4.0 * 4)
    long_rows["decode_attention"][f"whisper cross rep 1 hd 64 B=4 S={Fr}"] = dict(
        t, max_abs_err=err, lengths=[Fr] * 4)
    del qd, kd, vd, q4, k4, v4, Ld
    torch.cuda.empty_cache()

    # mamba_scan: the falcon-mamba band step (G = 16 layers, B = 1, T = 1024,
    # d_inner 8192, d_state 16; x bf16, B/C column slices of the fp32 x_proj
    # output), each group its own A_log, D and dt_bias so a wrong group index
    # shows; in two forms: the TPU kernel's (dt fp32 = softplus(raw dt +
    # bias), y fp32) and the one the model runs (the raw dt_proj output, its
    # bias and the gate z, the strided half of in_proj's output, taken in;
    # y gated in x's dtype). Then one layer (G = 1), 4 layers, decode (4
    # rows, T = 1) and odd shapes. y and hT are held in fp32 at 1e-4 (x
    # fp32); with bf16 x the gated y is held at bf16 rounding, hT at 1e-4.
    def scan_inputs(N, T, dI, dS, G, xdtype, lead=256):
        raw = rnd(N, T, dI, dtype=xdtype)
        bias = rnd(G, dI, scale=0.1, dtype=torch.float32) - 4.6
        dts = torch.nn.functional.softplus(raw.float() + bias.repeat_interleave(N // G, 0)[:, None])
        proj = rnd(N, T, lead + 2 * dS, scale=0.5, dtype=torch.float32)
        A_log = torch.log(torch.arange(1, dS + 1, dtype=torch.float32)
                          * (torch.rand(G, dI, dS, generator=gen) + 0.5)).to(dev)
        Ds, h0 = rnd(G, dI, dtype=torch.float32), rnd(N, dI, dS, scale=0.1, dtype=torch.float32)
        xz = rnd(N, T, 2 * dI, scale=0.5, dtype=xdtype)
        if G == 1:
            A_log, Ds, bias = A_log[0], Ds[0], bias[0]
        return dict(args=(xz[..., :dI].contiguous(), dts, proj[..., lead:lead + dS],
                          proj[..., lead + dS:], A_log.contiguous(), Ds.contiguous(), h0),
                    raw=raw, bias=bias.contiguous(), z=xz[..., dI:])

    def fused_args(c):
        return (c["args"][0], c["raw"]) + c["args"][2:]

    def run_scan(c, fused):
        if fused:
            return mamba_scan.mamba_scan(*fused_args(c), dt_bias=c["bias"], z=c["z"])
        return mamba_scan.mamba_scan(*c["args"])

    def plain_scan(c, fused, f32=True):
        cast = (lambda t: t.float()) if f32 else (lambda t: t)
        if fused:
            a = fused_args(c)
            return mamba_scan.mamba_scan_plain(cast(a[0]), cast(a[1]), *a[2:], dt_bias=c["bias"],
                                               z=cast(c["z"]))
        return mamba_scan.mamba_scan_plain(cast(c["args"][0]), *c["args"][1:])

    def scan_check(name, c, fused):
        (y, hT), (wy, wh) = run_scan(c, fused), plain_scan(c, fused)
        tol_y = TOL_BF16 if fused and y.dtype == torch.bfloat16 else TOL_F32
        return max(check(name + " y", y, wy, tol_y), check(name + " hT", hT, wh, TOL_F32))

    def scan_bound(steps, N, T, dI, dS, fused):
        """exponentials (+ softplus and silu fused) and fp32 operations a
        channel-step; bytes 10 a channel-step (x bf16, dt and y fp32) or 8
        fused (x, raw dt, z, y bf16), plus B/C, A_log, D, h0 and hT"""
        side = 4.0 * N * T * 2 * dS + 4.0 * N * dI * (dS + 1) + 2 * 4.0 * N * dI * dS
        return dict(flops_fp32=steps * (6 * dS + (12 if fused else 3)),
                    exps=steps * (dS + (2 if fused else 0)),
                    nbytes=steps * (8 if fused else 10) + side)

    Tm, dIm, dSm = 1024, 8192, 16
    err = 0.0
    for Nm in (16, 1):
        for dtype in (torch.bfloat16, torch.float32):
            c = scan_inputs(Nm, Tm, dIm, dSm, Nm, dtype)
            for fused in (False, True):
                e = scan_check(f"mamba_scan G={Nm} x[{Nm},{Tm},{dIm}] {dtype} dS {dSm} "
                               f"{'fused (raw dt, dt_bias, z)' if fused else 'unfused'},", c, fused)
                if fused and dtype == torch.bfloat16 and Nm == 16:
                    err = e
            del c
    by_rows = {}
    for Nm in (1, 4, 16):
        c = scan_inputs(Nm, Tm, dIm, dSm, Nm, torch.bfloat16)
        steps = float(Nm * Tm * dIm)
        for fused in (False, True):
            name = f"mamba_scan G={Nm} [{Nm},{Tm},{dIm}] dS {dSm} {'fused' if fused else 'unfused'}"
            if Nm == 16:
                t = timed(name, lambda: run_scan(c, fused),
                          lambda: plain_scan(c, fused, f32=False),
                          **scan_bound(steps, Nm, Tm, dIm, dSm, fused))
            else:
                ms = time_ms(lambda: run_scan(c, fused))
                b_ms, b_by = bound(**scan_bound(steps, Nm, Tm, dIm, dSm, fused))
                t = dict(ms=ms, bound_ms=b_ms, bound_by=b_by)
                log(f"  {name}: kernel {ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})  "
                    f"kernel/bound {ms / b_ms:.2f}")
            by_rows[f"G={Nm} {'fused' if fused else 'unfused'}"] = t
        del c
    log(f"  mamba_scan G=1 / G=16 time: unfused "
        f"{by_rows['G=1 unfused']['ms'] / by_rows['G=16 unfused']['ms']:.3f}, fused "
        f"{by_rows['G=1 fused']['ms'] / by_rows['G=16 fused']['ms']:.3f}")
    # the kernels line reports the form the model runs, at the band step
    summary["mamba_scan"] = dict(
        by_rows["G=16 fused"], max_abs_err=err,
        unfused={k: by_rows["G=16 unfused"][k] for k in ("ms", "plain_ms", "bound_ms")},
        ms_by_rows={k: v["ms"] for k, v in by_rows.items()},
        shape=f"x[16,{Tm},{dIm}] bf16 dS {dSm}, 16 groups, raw dt, dt_bias and z fused")
    # jamba-1.5-large's band (phase (t)): 2 layers of one pattern position,
    # B = 1, T = 1152, d_inner 16,384, the fused form
    Nj, Tj, dIj = 2, 1152, 16384
    c = scan_inputs(Nj, Tj, dIj, dSm, Nj, torch.bfloat16)
    e = scan_check(f"mamba_scan jamba band G={Nj} x[{Nj},{Tj},{dIj}] bf16 dS {dSm} fused,", c,
                   True)
    t = timed(f"mamba_scan jamba band G={Nj} [{Nj},{Tj},{dIj}] dS {dSm} fused",
              lambda: run_scan(c, True), lambda: plain_scan(c, True, f32=False),
              **scan_bound(float(Nj * Tj * dIj), Nj, Tj, dIj, dSm, True))
    long_rows["mamba_scan"] = {f"jamba band G={Nj} [{Nj},{Tj},{dIj}] fused": dict(
        t, max_abs_err=e)}
    del c
    dec = scan_inputs(4, 1, dIm, dSm, 1, torch.bfloat16)
    for fused in (False, True):
        scan_check(f"mamba_scan decode x[4,1,{dIm}] bf16 {'fused' if fused else 'unfused'},",
                   dec, fused)
        t_dec = time_ms(lambda: run_scan(dec, fused))
        log(f"  mamba_scan decode [4,1,{dIm}] {'fused' if fused else 'unfused'}: kernel "
            f"{t_dec:.4f} ms per launch")
    for dtype, (n_, t_, di_, ds_, g_) in [(torch.float32, (2, 37, 200, 4, 1)),
                                          (torch.bfloat16, (2, 37, 200, 4, 1)),
                                          (torch.bfloat16, (6, 50, 130, 8, 3)),
                                          (torch.float32, (3, 1, 70, 16, 3))]:
        for fused in (False, True):
            scan_check(f"mamba_scan odd {dtype} x[{n_},{t_},{di_}] dS {ds_} groups {g_}, strided "
                       f"B/C{', fused' if fused else ''}",
                       scan_inputs(n_, t_, di_, ds_, g_, dtype, lead=3), fused)
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ (c) model
    log("== model phase: llama-1b-armt, full width and depth, bf16, seed 0")
    cfg = get_config("llama-1b-armt")
    params = M.init_params(cfg, SEED, device=dev)
    seg = cfg.armt.segment_len
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 16 * seg))).to(dev)

    def prefill(schedule, p, c, tk):
        """The diagonal schedule on the kernels (the fused cell), the
        sequential one on the plain path."""
        h, fin = M.forward_hidden(p, c, tk, schedule=schedule, fused=schedule == "diagonal")
        return M.last_logits(p, c, h), fin

    def seg_logits(p, c, h):
        """fp32 logits of the last token of every segment: [S, 1, V]."""
        return M.boundary_logits(p, c, h)

    with torch.no_grad():
        prefill("diagonal", params, cfg, toks[:, :2 * seg])      # warm-up
        sync()
        t0 = time.perf_counter()
        hd, fd = M.forward_hidden(params, cfg, toks, schedule="diagonal")
        ld = seg_logits(params, cfg, hd)
        sync()
        t_diag = time.perf_counter() - t0
        t0 = time.perf_counter()
        hs, fs = M.forward_hidden(params, cfg, toks, schedule="sequential", fused=False)
        ls = seg_logits(params, cfg, hs)
        sync()
        t_seq = time.perf_counter() - t0
    # The untrained model is chaotic over segments (PERF.md §6, from
    # tools/deep_prefill.py on 4 seeds): by segment 3-5 rounding alone puts
    # every diagonal variant, plain versions on the card included, O(1) away
    # from the sequential path, and some overflow by segment 11-14. So the
    # free-running 16-segment run is gated on its first n_free segments,
    # and the teacher-forced check below covers all 16.
    n_free, tol_free = 2, 5e-2
    errs = [rel_err(ld[i], ls[i]) for i in range(ld.shape[0])]
    ok = bool(torch.isfinite(ld[:n_free]).all()) and max(errs[:n_free]) <= tol_free
    log(f"  16-segment prefill ({16 * seg} tokens): diagonal on kernels {t_diag:.3f} s, "
        f"sequential plain {t_seq:.3f} s; last-token logits rel err per segment "
        f"{' '.join(f'{e:.1e}' for e in errs)}; segments 1-{n_free} gated (tol "
        f"{tol_free:g}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("model bf16 prefill, first segments")
    del hd, fd, hs, fs, ld, ls

    # Teacher forcing: each segment from the state the sequential plain path
    # reached before it, so errors do not carry over. Even so, at a few
    # segments the untrained model is so ill-conditioned that any two
    # roundings of the same math differ by O(1) (PERF.md §6: up to 5e2 in A
    # for the kernels, 9.7 for the plain versions on the card). So the same
    # segments also run on the plain versions on the card, as a second
    # rounding of the same math, and the kernels are held at every segment
    # where that one is within half the tolerance: 11-13 of 16 on 4 seeds.
    forced_in = []
    with torch.no_grad():
        state = None
        for i in range(16):
            part = toks[:, i * seg:(i + 1) * seg]
            hs, fs = M.forward_hidden(params, cfg, part, schedule="sequential", fused=False,
                                      state0=state)
            forced_in.append((part, state, seg_logits(params, cfg, hs), fs["pattern"][0]))
            state = fs
        del hs, fs, state

    def forced_errors():
        """Per segment: the larger of the last-token logits' and the worst
        layer's A/z rel err, diagonal schedule on the ops as they stand
        against the sequential plain path; and whether all were finite."""
        out = []
        with torch.no_grad():
            for part, state, ls, ss in forced_in:
                hd, fd = M.forward_hidden(params, cfg, part, schedule="diagonal", state0=state)
                ld, sd = seg_logits(params, cfg, hd), fd["pattern"][0]
                err = max([rel_err(ld, ls)] + [rel_err(sd[k][j], ss[k][j]) for k in ("A", "z")
                                               for j in range(cfg.n_layers)])
                out.append((err, all(torch.isfinite(t).all().item()
                                     for t in (ld, sd["A"], sd["z"]))))
        return out

    tol_forced, min_held = 5e-2, 8
    with swap.plain_versions():
        probe = forced_errors()
    held = [i for i, (e, f) in enumerate(probe) if f and e <= tol_forced / 2]

    def forced_check():
        errs = forced_errors()
        ok = (all(f for _, f in errs) and len(held) >= min_held
              and all(errs[i][0] <= tol_forced for i in held))
        return errs, ok

    errs, ok = forced_check()
    log(f"  16 segments teacher-forced, worst of logits/A/z rel err per segment: kernels "
        f"{' '.join(f'{e:.1e}' for e, _ in errs)}; plain versions "
        f"{' '.join(f'{e:.1e}' for e, _ in probe)}; held at segments "
        f"{[i + 1 for i in held]} (tol {tol_forced:g}, at least {min_held}), kernels "
        f"finite at all {all(f for _, f in errs)} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("model bf16 teacher-forced segments")
    torch.cuda.empty_cache()

    # the same at 2 segments, before the untrained state diverges between
    # schedules (PERF.md §6), holding every layer's final A and z as well:
    # at 16 segments the read is nearly inert, so the logits alone cannot
    # see a wrong memory kernel
    n_early, tol_early = 2, 5e-2
    with torch.no_grad():
        ls, fs = prefill("sequential", params, cfg, toks[:, :n_early * seg])

    def early_errors():
        with torch.no_grad():
            ld, fd = prefill("diagonal", params, cfg, toks[:, :n_early * seg])
        sd, ss = fd["pattern"][0], fs["pattern"][0]
        errs = {"last_logits": rel_err(ld, ls),
                "A": max(rel_err(sd["A"][i], ss["A"][i]) for i in range(sd["A"].shape[0])),
                "z": max(rel_err(sd["z"][i], ss["z"][i]) for i in range(sd["z"].shape[0]))}
        finite = all(torch.isfinite(t).all().item() for t in (ld, sd["A"], sd["z"]))
        return errs, finite and max(errs.values()) <= tol_early

    def show(errs):
        return ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
    errs, ok = early_errors()
    log(f"  {n_early}-segment prefill, diagonal on kernels vs sequential plain: rel err "
        f"{show(errs)} (A, z: worst layer; tol {tol_early:g}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("model bf16 early-segment state")
    # negative controls: the 2-segment check must reject a memory read 2 %
    # low, and the B = 1 cell's fused update with its delta A scaled by 0.95.
    # A teacher-forced segment starts from the reference's state, so a
    # scaled delta A moves its A by at most the scale's own share: that
    # check, at 5e-2, must reject a scale of 0.9.
    read, fused_op = ops.assoc_read, ops.grouped_gemm_armt_update

    def scaled_update(scale):
        def update(*a, **k):
            y, A2, z2 = fused_op(*a, **k)
            A = a[6]
            return y, A + scale * (A2 - A), z2
        return update
    with swap.replaced(assoc_read=lambda *a, **k: 0.98 * read(*a, **k)):
        errs, passed = early_errors()
    log(f"  negative control, armt_read output x0.98: rel err {show(errs)} -> "
        f"{'FAIL: not caught' if passed else 'caught, ok'}")
    if passed:
        failures.append("model check blind to a 2 % read error")
    with swap.replaced(grouped_gemm_armt_update=scaled_update(0.95)):
        errs, passed = early_errors()
    log(f"  negative control, fused update's delta A x0.95: rel err {show(errs)} -> "
        f"{'FAIL: not caught' if passed else 'caught, ok'}")
    if passed:
        failures.append("model check blind to a 5 % error in the fused update")
    with swap.replaced(grouped_gemm_armt_update=scaled_update(0.9)):
        ferrs, passed = forced_check()
    log(f"  negative control, teacher-forced, fused update's delta A x0.9: worst held "
        f"segment {max([ferrs[i][0] for i in held], default=0.0):.3e} -> "
        f"{'FAIL: not caught' if passed else 'caught, ok'}")
    if passed:
        failures.append("teacher-forced check blind to a 10 % error in the fused update")
    del ls, fs

    cfg32 = replace(cfg, n_layers=2, dtype="float32")
    p32 = M.init_params(cfg32, SEED + 1, device=dev)
    with torch.no_grad():
        ld, _ = prefill("diagonal", p32, cfg32, toks[:, :3 * seg])
        ls, _ = prefill("sequential", p32, cfg32, toks[:, :3 * seg])
    rel32 = rel_err(ld, ls)
    ok = bool(torch.isfinite(ld).all()) and rel32 <= 1e-3
    log(f"  fp32, 2 layers, 3 segments: last_logits rel err {rel32:.3e} (tol 1e-3) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("model fp32 prefill")
    del p32, ld, ls, forced_in
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ (d) serving
    log("== generate phase: ServeEngine.generate, greedy, decode on CUDA graphs")
    engine = ServeEngine(params, cfg)
    eager_engine = ServeEngine(params, cfg, eager=True)     # the same programs, uncaptured
    launches_gen, routes_gen = {}, {}
    # 4 segments: on 4 seeds no diagonal variant, kernels or plain versions,
    # overflowed before segment 11 (PERF.md §6), while 16 segments overflow
    # on some seeds whatever the path, so the logits are held finite here
    runs = [(1, 4 * seg + 1000, 48), (2, 4 * seg + 300, 32)]
    for B, plen, new in runs:
        prompts = rng.integers(0, cfg.vocab, (B, plen))
        res, n, r = counted(lambda: engine.generate(prompts, new))
        again, ng, rg = counted(lambda: engine.generate(prompts, new, keep=True))
        launches_gen = merged(merged(launches_gen, n), ng)
        routes_gen = merged(merged(routes_gen, r), rg)
        good = (res.finite and res.tokens.shape == (B, new)
                and res.tokens.min() >= 0 and res.tokens.max() < cfg.vocab)
        log(f"  B={B} prompt {plen} new {new}: TTFT {res.ttft_s:.3f} s, decode "
            f"{res.tok_s:.1f} tok/s (capture {res.capture_s:.3f} s before the prefill); "
            f"again on the captured graphs: TTFT {again.ttft_s:.3f} s, {again.tok_s:.1f} tok/s; "
            f"logits finite {res.finite} -> {'ok' if good else 'FAIL'}; card {smi}")
        for b in range(B):
            log(f"    tokens[{b}]: {res.tokens[b].tolist()}")
        if not good:
            failures.append(f"generate B={B}")
        # the untrained ARMT state is chaotic over segments (PERF.md §6),
        # so show that a run reproduces bit for bit: no atomics anywhere
        same = bool((again.tokens == res.tokens).all())
        log(f"  B={B} repeated: tokens equal {same}")
        if not same:
            failures.append(f"generate B={B} not reproducible")
        ge, ne, _ = counted(lambda: eager_engine.generate(prompts, new, keep=True))
        log(f"  B={B} eager: TTFT {ge.ttft_s:.3f} s, decode {ge.tok_s:.1f} tok/s")
        check_generate(f"llama ARMT generate B={B}", again, ge, ng, ne,
                       graph_tok_s=again.tok_s, eager_tok_s=ge.tok_s,
                       graph_ttft_s=again.ttft_s, eager_ttft_s=ge.ttft_s)
        if B == 1:
            kw = dict(temperature=0.8, top_k=40, seed=0)
            sg, ng, rg = counted(lambda: engine.generate(prompts, new, keep=True, **kw))
            launches_gen, routes_gen = merged(launches_gen, ng), merged(routes_gen, rg)
            se, ne, _ = counted(lambda: eager_engine.generate(prompts, new, keep=True, **kw))
            check_generate(f"llama ARMT generate B=1 sampled {kw}", sg, se, ng, ne,
                           differs_from_greedy=int((sg.tokens != res.tokens).sum()))
            steps = {"graph": step_times(engine.program(1), False),
                     "eager": step_times(eager_engine.program(1), True)}
            log(f"  one decode step at B=1: graph span {steps['graph']['span_ms']:.3f} ms, "
                f"device {steps['graph']['device_ms']:.3f} ms; eager span "
                f"{steps['eager']['span_ms']:.3f} ms, device {steps['eager']['device_ms']:.3f} "
                f"ms; card {smi}")
            graph_phase["llama ARMT decode step B=1"] = steps
    log(f"  launches in the generate phase: {launches_gen}; GEMM and flash launches by "
        f"route {routes_gen}")
    for name in llama_kernels:
        if launches_gen[name] == 0:
            failures.append(f"{name} never launched by generate")
    for k in routed:
        if routes_gen[k]["simt"] or not routes_gen[k]["wgmma"]:
            failures.append(f"generate's {k} left the TMA + wgmma route: {routes_gen[k]}")

    scfg = get_smoke_config("llama-1b-armt")
    sp = M.init_params(scfg, SEED, device="cpu")
    sp_gpu = M.Model(scfg, sp).to(dev).tree()
    sseg = scfg.armt.segment_len
    for B in (1, 2):
        prompts = rng.integers(0, scfg.vocab, (B, 3 * sseg + 5))
        on_card = ServeEngine(sp_gpu, scfg).generate(prompts, 20).tokens
        on_cpu = ServeEngine(sp, scfg, device="cpu").generate(prompts, 20).tokens
        same = bool((on_card == on_cpu).all())
        log(f"  smoke config (fp32) generate B={B}, card kernels vs CPU plain path: "
            f"tokens equal {same}")
        if not same:
            failures.append(f"smoke generate B={B} card vs cpu")

    # ------------------------------------------------------------ (e) serve
    log("== serve phase (main path): ServeEngine.serve, 4 slots, chunk 8, greedy")
    # (segments, tail tokens, max_new): tails near seg_len make slots reach
    # their flushes at steps 14, 24, 34 and 44; two slots never flush
    spec = [(1, 1000, 40), (2, 990, 64), (3, 1010, 24), (1, 300, 48), (2, 980, 56),
            (1, 10, 32)]
    reqs = [Request(i, rng.integers(0, cfg.vocab, n * seg + tail), new)
            for i, (n, tail, new) in enumerate(spec)]
    t0 = time.perf_counter()
    engine.program(4, "serve").prepare()
    log(f"  capture of the 4-slot step and flush: {time.perf_counter() - t0:.3f} s")

    pooled = {}
    first_serve = "k=4 (phase (e), the first interleaved serve)"

    def serve_run(eng, rq, label=None, **kw):
        """(events, host seconds) of one serve call; under ``label``, the
        band steps its admission rounds pooled (``diag.pool_counts``)."""
        diag.pool_counts.update(steps=0, member_steps=0)
        t0 = time.perf_counter()
        evs = list(eng.serve(rq, n_slots=4, chunk=8, **kw))
        sync()
        if label is not None:
            pooled[label] = dict(diag.pool_counts)
        return evs, time.perf_counter() - t0

    def streams(evs):
        return [(e.req_id, e.token, e.index, e.done, e.finite) for e in evs
                if not isinstance(e, RequestError)]

    # the process's first interleaved serve runs with the trace recorder on
    # (host spans only), for phase (q)'s split of where its time goes
    engine.telemetry = Telemetry(trace=True, registry=MetricsRegistry())
    (events, t_serve), launches_serve, routes_serve = counted(
        lambda: serve_run(engine, reqs, first_serve))
    first_trace, engine.telemetry = engine.telemetry.trace, Telemetry()
    log(f"  launches in the serve phase: {launches_serve}; GEMM and flash launches by "
        f"route {routes_serve}")
    for name in llama_kernels:
        if launches_serve[name] == 0 and name != "armt_update":   # B > 1 only
            failures.append(f"{name} never launched by serve")
    for k in routed:
        if routes_serve[k]["simt"] or not routes_serve[k]["wgmma"]:
            failures.append(f"serve's {k} left the TMA + wgmma route: {routes_serve[k]}")
    errors = [e for e in events if isinstance(e, RequestError)]
    n_tok = len(events) - len(errors)
    log(f"  {len(reqs)} requests, {n_tok} tokens in {t_serve:.3f} s: aggregate "
        f"{n_tok / t_serve:.1f} tok/s (admission prefills included); pooled band steps "
        f"{pooled[first_serve]}; card {smi}")
    if errors:
        failures.append(f"serve rejected {errors}")
    for r in reqs:
        mine = [e for e in events if not isinstance(e, RequestError) and e.req_id == r.req_id]
        toks = [e.token for e in mine]
        first_gen = int(engine.generate(r.prompt[None], 1).tokens[0, 0])
        good = (len(mine) == r.max_new and mine[-1].done and bool(mine[-1].finite)
                and [e.index for e in mine] == list(range(r.max_new))
                and toks[0] == first_gen)
        log(f"  request {r.req_id} (prompt {len(r.prompt)}, new {r.max_new}): TTFT "
            f"{mine[0].ttft_s:.3f} s, {len(mine)} tokens, finite {mine[-1].finite}, first "
            f"token {toks[0]} vs B=1 generate {first_gen} -> {'ok' if good else 'FAIL'}")
        log(f"    tokens: {toks}")
        if not good:
            failures.append(f"serve request {r.req_id}")
    (e_events, t_eserve), ne, _ = counted(lambda: serve_run(eager_engine, reqs))
    log(f"  eager: {n_tok} tokens in {t_eserve:.3f} s, {n_tok / t_eserve:.1f} tok/s")
    check_graph("llama ARMT serve, 6 requests on 4 slots", {
        "every request's events equal": streams(events) == streams(e_events)},
        launches_serve, ne, graph_tok_s=n_tok / t_serve, eager_tok_s=n_tok / t_eserve,
        graph_ttft_s={e.req_id: e.ttft_s for e in events if e.index == 0},
        eager_ttft_s={e.req_id: e.ttft_s for e in e_events if e.index == 0})
    steps = {"graph": step_times(engine.program(4, "serve"), False),
             "eager": step_times(eager_engine.program(4, "serve"), True)}
    log(f"  one decode step over 4 slots: graph span {steps['graph']['span_ms']:.3f} ms, "
        f"device {steps['graph']['device_ms']:.3f} ms; eager span "
        f"{steps['eager']['span_ms']:.3f} ms, device {steps['eager']['device_ms']:.3f} ms; "
        f"card {smi}")
    graph_phase["llama ARMT decode step 4 slots"] = steps
    # ------------------------------------------------------------ (i) full attention
    log("== full-attention phase: llama-1b-armt, forward_hidden(mode='full'), 4,096 tokens, "
        "B = 1, bf16")
    Tf, n_last = 4096, 1024
    ftk = torch.from_numpy(rng.integers(0, cfg.vocab, (1, Tf))).to(dev)

    def full_run(p, c, schedule="diagonal", fused=True, tk=None):
        """Full mode (one segment of the whole prompt, no memory): (hidden
        [1, B, T, D], last-token logits [B, V])."""
        with torch.no_grad():
            h, _ = M.forward_hidden(p, c, ftk if tk is None else tk, mode="full",
                                    schedule=schedule, fused=fused)
            return h, M.last_logits(p, c, h)

    def with_wo(p, scale):
        """p with the attention output projection scaled (the control)."""
        pat = dict(p["pattern"][0])
        pat["attn"] = dict(pat["attn"], wo=pat["attn"]["wo"] * scale)
        return dict(p, pattern=(pat,))

    reset_counts()
    hfd, lfd = full_run(params, cfg)
    sync()
    launches_full, routes_full = read_counts(), read_routes()
    log(f"  launches: {launches_full}; GEMM and flash launches by route {routes_full}")
    for name in ("grouped_matmul", "flash_attention"):
        if launches_full[name] == 0:
            failures.append(f"{name} never launched by the full-mode forward")
    for name in ("armt_read", "armt_update", "grouped_matmul_armt_update", "decode_attention"):
        if launches_full[name]:
            failures.append(f"the full-mode forward launched {name}")
    for k in routed:
        if routes_full[k]["simt"] or not routes_full[k]["wgmma"]:
            failures.append(f"full mode's {k} left the TMA + wgmma route: {routes_full[k]}")
    hfs, lfs = full_run(params, cfg, "sequential")
    same = same_bits(hfd, hfs) and same_bits(lfd, lfs)
    log(f"  diagonal (one segment: {cfg.n_layers} bands of one layer) and sequential on the "
        f"fused cell equal to the bit: {same} -> {'ok' if same else 'FAIL'}")
    if not same:
        failures.append("full mode: diagonal and sequential-fused differ")
    del hfs, lfs
    p32 = M._tree_map(lambda path, t: t.float(), params)
    hpl, lpl = full_run(p32, cfg, "sequential", fused=False)
    del p32
    torch.cuda.empty_cache()

    def full_errs(h, lg, h_ref=hpl, l_ref=lpl):
        return {"hidden (last 1024 positions)": rel_err(h[0, :, -n_last:], h_ref[0, :, -n_last:]),
                "last logits": rel_err(lg, l_ref)}
    # A 2 % error in every attention output projection moves the hidden
    # states by ~5.6e-2 at 16 layers, just past 5e-2, while the bf16 path
    # reads ~1.6e-2 (PERF.md §6): tol_full sits between the two.
    tol_full = 3e-2
    errs = full_errs(hfd, lfd)
    ok = bool(torch.isfinite(hfd).all()) and max(errs.values()) <= tol_full
    log(f"  bf16 on the kernels vs the plain path in fp32 (same weights), full depth: rel err "
        f"{show(errs)} (tol {tol_full:g}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("full mode bf16 full depth vs fp32 plain")
    errs_c = full_errs(*full_run(with_wo(params, 0.98), cfg))
    caught = max(errs_c.values()) > tol_full
    log(f"  negative control, attention output projection x0.98: rel err {show(errs_c)} -> "
        f"{'caught, ok' if caught else 'FAIL: not caught'}")
    if not caught:
        failures.append("full-mode check blind to the attention output x0.98")
    del hfd, lfd, hpl, lpl
    cfg2 = replace(cfg, n_layers=2, dtype="float32")
    p2 = M.init_params(cfg2, SEED + 2, device=dev)
    h2p, l2p = full_run(p2, cfg2, "sequential", fused=False)
    h2k, l2k = full_run(p2, cfg2)
    errs = full_errs(h2k, l2k, h2p, l2p)
    ok = bool(torch.isfinite(h2k).all()) and max(errs.values()) <= 1e-3
    log(f"  fp32, 2 layers, kernels vs plain: rel err {show(errs)} (tol 1e-3) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("full mode fp32 2 layers")
    errs_c = full_errs(*full_run(with_wo(p2, 0.98), cfg2), h2p, l2p)
    caught = max(errs_c.values()) > 1e-3
    log(f"  negative control, fp32, attention output projection x0.98: rel err {show(errs_c)} "
        f"-> {'caught, ok' if caught else 'FAIL: not caught'}")
    if not caught:
        failures.append("full-mode fp32 check blind to the attention output x0.98")
    del p2, h2p, l2p, h2k, l2k
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ (j) exactness of the schedules
    log("== schedules: 16-segment ARMT prefill, diagonal vs sequential (its segment a "
        "captured CUDA graph), both on the kernels; the sequential one also eager")
    xtk = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 16 * seg))).to(dev)

    def prefill16(**kw):
        with torch.no_grad():
            h, f = M.forward_hidden(params, cfg, xtk, **kw)
            return h, f, seg_logits(params, cfg, h)
    hxd, fxd, lxd = prefill16(schedule="diagonal")
    t0 = time.perf_counter()
    prefill16(schedule="sequential")            # captures the segment graph
    sync()
    log(f"  first captured sequential run (capture included): {time.perf_counter() - t0:.3f} s")
    (hxs, fxs, lxs), n_seq, _ = counted(lambda: prefill16(schedule="sequential"))
    (hxe, fxe, lxe), n_eag, _ = counted(lambda: prefill16(schedule="sequential", eager=True))
    check_graph("llama ARMT sequential 16-segment prefill", {
        "hidden to the bit": same_bits(hxs, hxe), "logits to the bit": same_bits(lxs, lxe),
        "every layer's A to the bit": same_bits(fxs["pattern"][0]["A"], fxe["pattern"][0]["A"]),
        "every layer's z to the bit": same_bits(fxs["pattern"][0]["z"], fxe["pattern"][0]["z"])},
        n_seq, n_eag)
    del hxe, fxe, lxe

    def max_rel(a, b):
        """Largest |a - b| over the largest |b|, finite elements only."""
        a, b = a.double(), b.double()
        fin = torch.isfinite(a) & torch.isfinite(b)
        if not fin.any():
            return float("nan")
        return ((a - b).abs()[fin].max() / b.abs()[fin].max().clamp_min(1e-300)).item()
    sd_, ss_ = fxd["pattern"][0], fxs["pattern"][0]
    exact = {"hidden": [same_bits(hxd[i], hxs[i]) for i in range(16)],
             "logits": [same_bits(lxd[i], lxs[i]) for i in range(16)],
             "A": [same_bits(sd_["A"][j], ss_["A"][j]) for j in range(cfg.n_layers)],
             "z": [same_bits(sd_["z"][j], ss_["z"][j]) for j in range(cfg.n_layers)]}
    diffs = {"hidden": [max_rel(hxd[i], hxs[i]) for i in range(16)],
             "logits": [max_rel(lxd[i], lxs[i]) for i in range(16)],
             "A": [max_rel(sd_["A"][j], ss_["A"][j]) for j in range(cfg.n_layers)],
             "z": [max_rel(sd_["z"][j], ss_["z"][j]) for j in range(cfg.n_layers)]}
    for k in diffs:
        per = "per segment" if k in ("hidden", "logits") else "per layer (final state)"
        log(f"  {k} largest rel difference {per}: {' '.join(f'{e:.1e}' for e in diffs[k])}; "
            f"equal to the bit at {sum(exact[k])} of {len(exact[k])}")
    bitwise = all(all(v) for v in exact.values())
    if bitwise:
        log("  diagonal and sequential on the kernels agree to the bit -> ok")
    else:
        errs = [rel_err(lxd[i], lxs[i]) for i in range(2)] + [rel_err(hxd[i], hxs[i])
                                                              for i in range(2)]
        ok = max(errs) <= 5e-2
        log(f"  NOT bitwise; first 2 segments' hidden/logits rel err {max(errs):.3e} (tol 5e-2)"
            f" -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("diagonal vs sequential on the kernels, first 2 segments")
    schedules_exact = dict(bitwise=bitwise, max_rel={k: max((e for e in v if e == e),
                                                            default=float("nan"))
                                                     for k, v in diffs.items()})
    del hxd, fxd, hxs, fxs, lxd, lxs, sd_, ss_
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ (k) cache-mode generate
    log("== cache-mode generate: ServeEngine(serve_mode='cache', max_len=17432), greedy")
    ceng = ServeEngine(params, cfg, serve_mode="cache", max_len=17432)
    ceng_eager = ServeEngine(params, cfg, serve_mode="cache", max_len=17432, eager=True)
    cruns = [(1, 16384 + 1000, 48), (2, 4096 + 300, 32)]
    cprompts = [rng.integers(0, cfg.vocab, (B, plen)) for B, plen, _ in cruns]
    reset_counts()
    cres = [ceng.generate(pr, new) for pr, (_, _, new) in zip(cprompts, cruns)]
    sync()
    launches_cgen, routes_cgen = read_counts(), read_routes()
    log(f"  launches: {launches_cgen}; GEMM and flash launches by route {routes_cgen}")
    for name in ("flash_attention", "decode_attention"):
        if launches_cgen[name] == 0:
            failures.append(f"{name} never launched by cache-mode generate")
    for name in ("armt_read", "armt_update", "grouped_matmul_armt_update"):
        if launches_cgen[name]:
            failures.append(f"cache-mode generate launched {name}")
    if routes_cgen["flash_attention"]["simt"] or routes_cgen["grouped_matmul"]["simt"]:
        failures.append(f"cache-mode generate left the TMA + wgmma route: {routes_cgen}")
    for pr, (B, plen, new), res in zip(cprompts, cruns, cres):
        good = (res.finite and res.tokens.shape == (B, new)
                and res.tokens.min() >= 0 and res.tokens.max() < cfg.vocab)
        log(f"  B={B} prompt {plen} new {new}: TTFT {res.ttft_s:.3f} s, decode "
            f"{res.tok_s:.1f} tok/s, logits finite {res.finite} -> {'ok' if good else 'FAIL'}"
            f"; card {smi}")
        for b in range(B):
            log(f"    tokens[{b}]: {res.tokens[b].tolist()}")
        if not good:
            failures.append(f"cache-mode generate B={B}")
        again, ng, _ = counted(lambda: ceng.generate(pr, new, keep=True))
        ce, ne, _ = counted(lambda: ceng_eager.generate(pr, new, keep=True))
        log(f"  B={B} again on the captured graphs: TTFT {again.ttft_s:.3f} s, "
            f"{again.tok_s:.1f} tok/s; eager: TTFT {ce.ttft_s:.3f} s, {ce.tok_s:.1f} tok/s")
        check_generate(f"cache-mode generate B={B} at {plen} tokens", again, ce, ng, ne,
                       graph_tok_s=again.tok_s, eager_tok_s=ce.tok_s,
                       graph_ttft_s=again.ttft_s, eager_ttft_s=ce.ttft_s)
        del again, ce
        # two code paths for one function: the cache-mode prefill (one
        # decode_step chunk: torch.matmul projections, flash inside
        # decode_attention) and forward_hidden(mode='full') on the fused cell
        with torch.no_grad():
            lg = ceng.prefill(torch.from_numpy(pr))[0]
            lf = full_run(params, cfg, tk=torch.from_numpy(pr).to(dev))[1]
        e = max(rel_err(lg[b], lf[b]) for b in range(B))
        ok = bool(torch.isfinite(lg).all()) and e <= 5e-2
        log(f"  B={B} prefill's last logits vs forward_hidden(mode='full'): rel err {e:.3e} "
            f"(tol 5e-2) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"cache-mode prefill vs full mode B={B}")
        del lg, lf
        if B == 1:
            kw = dict(temperature=0.8, top_k=40, seed=0)
            s1 = ceng.generate(pr, new, **kw).tokens
            s2 = ceng.generate(pr, new, **kw).tokens
            k1 = ceng.generate(pr, new, temperature=0.8, top_k=1, seed=0).tokens
            ok = bool((s1 == s2).all()) and bool((k1 == res.tokens).all())
            log(f"  sampling {kw} twice: equal {bool((s1 == s2).all())}; top_k=1 equals "
                f"greedy {bool((k1 == res.tokens).all())}; differs from greedy at "
                f"{int((s1 != res.tokens).sum())} of {new} -> {'ok' if ok else 'FAIL'}")
            log(f"    sampled tokens: {s1[0].tolist()}")
            if not ok:
                failures.append("cache-mode sampling")
    del ceng, ceng_eager, cres
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ (l) cache-mode serve
    log("== cache-mode serve: ServeEngine(serve_mode='cache', max_len=8192).serve, 4 slots, "
        "chunk 8, greedy")
    seng = ServeEngine(params, cfg, serve_mode="cache", max_len=8192)
    cspec = [(1000, 32), (6000, 32), (2500, 32), (4096, 32), (1500, 32), (5200, 32)]
    creqs = [Request(i, rng.integers(0, cfg.vocab, n), new) for i, (n, new) in enumerate(cspec)]
    seng.program(4, "serve").prepare()
    (cevents, t_cserve), launches_cserve, routes_cserve = counted(
        lambda: serve_run(seng, creqs))
    log(f"  launches: {launches_cserve}; GEMM and flash launches by route {routes_cserve}")
    for name in ("flash_attention", "decode_attention"):
        if launches_cserve[name] == 0:
            failures.append(f"{name} never launched by cache-mode serve")
    if routes_cserve["flash_attention"]["simt"]:
        failures.append(f"cache-mode serve left the TMA + wgmma flash: {routes_cserve}")
    errors = [e for e in cevents if isinstance(e, RequestError)]
    n_tok = len(cevents) - len(errors)
    log(f"  {len(creqs)} requests, {n_tok} tokens in {t_cserve:.3f} s: aggregate "
        f"{n_tok / t_cserve:.1f} tok/s (admission prefills included); card {smi}")
    if errors:
        failures.append(f"cache-mode serve rejected {errors}")
    for r in creqs:
        mine = [e for e in cevents if not isinstance(e, RequestError) and e.req_id == r.req_id]
        ctoks = [e.token for e in mine]
        first_gen = int(seng.generate(r.prompt[None], 1).tokens[0, 0])
        good = (len(mine) == r.max_new and mine[-1].done and bool(mine[-1].finite)
                and [e.index for e in mine] == list(range(r.max_new))
                and ctoks[0] == first_gen)
        log(f"  request {r.req_id} (prompt {len(r.prompt)}, new {r.max_new}): TTFT "
            f"{mine[0].ttft_s:.3f} s, {len(mine)} tokens, finite {mine[-1].finite}, first "
            f"token {ctoks[0]} vs B=1 generate {first_gen} -> {'ok' if good else 'FAIL'}")
        if not good:
            failures.append(f"cache-mode serve request {r.req_id}")
    seng_eager = ServeEngine(params, cfg, serve_mode="cache", max_len=8192, eager=True)
    (e_events, t_eserve), ne, _ = counted(lambda: serve_run(seng_eager, creqs))
    log(f"  eager: {n_tok} tokens in {t_eserve:.3f} s, {n_tok / t_eserve:.1f} tok/s")
    check_graph("cache-mode serve, 6 requests on 4 slots", {
        "every request's events equal": streams(cevents) == streams(e_events)},
        launches_cserve, ne, graph_tok_s=n_tok / t_cserve, eager_tok_s=n_tok / t_eserve)
    del seng, seng_eager, cevents, e_events
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ (m) cache decode step
    # One cache-mode decode step (B = 1) against a full cache of 17,432 and
    # 131,136 rows (random contents: the step reads what a prompt of that
    # length would leave), as the engine runs it: the captured step over
    # the static state, which writes the new k/v row in place (a
    # functional step would clone every layer's cache and stack them
    # again), beside the same program run eagerly.
    log("== cache-mode decode step: B = 1, full cache, the captured step and the eager one")
    decode_step_rows = {}
    cgen = torch.Generator(device=dev).manual_seed(SEED)
    for Sl in (17432, 131136):
        row = {}
        for label, eager in (("graph", False), ("eager", True)):
            prog = ServeEngine(params, cfg, serve_mode="cache", max_len=Sl,
                               eager=eager).program(1)
            prog.prepare()
            cache = prog.state["pattern"][0]
            for k in ("k", "v"):
                cache[k].normal_(generator=cgen)
            prog.state["pos"].fill_(Sl - 1)
            prog.tok.fill_(int(rng.integers(cfg.vocab)))
            ptrs = [cache[k].data_ptr() for k in ("k", "v")]
            _, n, _ = counted(prog.step)
            row[label] = dict(step_times(prog, eager), decode_launches=n["decode_attention"],
                              cache_kept_address=ptrs == [cache[k].data_ptr()
                                                          for k in ("k", "v")])
            del prog, cache
            torch.cuda.empty_cache()
        gb = 2 * cfg.n_layers * Sl * cfg.n_kv_heads * cfg.head_dim * 2 / 1e9
        log(f"  cache of {Sl} rows ({gb:.2f} GB of k and v): captured step span "
            f"{row['graph']['span_ms']:.3f} ms, device {row['graph']['device_ms']:.3f} ms; "
            f"eager span {row['eager']['span_ms']:.3f} ms, device "
            f"{row['eager']['device_ms']:.3f} ms ({row['graph']['decode_launches']} "
            f"decode_attention launches a step; the cache kept its address "
            f"{row['graph']['cache_kept_address']}); byte bound of the keys read "
            f"{gb / (PEAK_BYTES / 1e9) * 1e3:.3f} ms; card {smi}")
        if not row["graph"]["cache_kept_address"]:
            failures.append(f"the captured cache step over {Sl} rows moved the cache")
        decode_step_rows[f"S={Sl}"] = row

    # ------------------------------------------------------------ (n) schedules timing
    # Informational, gated on nothing but finite times (and a finite
    # full-mode output): the paper's three schedules on one set of kernels.
    log("== schedules timing (informational): llama-1b-armt, B = 1, bf16, all on the kernels; "
        "1 warm-up and 3 runs each")

    def timed_runs(fn):
        """1 warm-up and 3 runs -> (host wall s, CUDA-event s, peak GB) lists
        and the last run's output."""
        fn()
        sync()
        walls, devs, peaks = [], [], []
        for _ in range(3):
            torch.cuda.reset_peak_memory_stats()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            out = fn()
            b.record()
            sync()
            walls.append(time.perf_counter() - t0)
            devs.append(a.elapsed_time(b) / 1e3)
            peaks.append(torch.cuda.max_memory_allocated() / 1e9)
        return dict(wall_s=walls, device_s=devs, peak_gb=peaks), out

    def fwd(tk, **kw):
        def run():
            with torch.no_grad():
                h, _ = M.forward_hidden(params, cfg, tk, **kw)
                return M.last_logits(params, cfg, h)
        return run

    def med(v):
        return float(np.median(v))
    sched_timing = {}
    for n_tok in (16384, 131072):
        tk = torch.from_numpy(rng.integers(0, cfg.vocab, (1, n_tok))).to(dev)
        runs = {"full attention (sequential, fused cell)":
                fwd(tk, mode="full", schedule="sequential"),
                "ARMT sequential (fused cell, captured segment)": fwd(tk, schedule="sequential"),
                "ARMT diagonal (fused cell)": fwd(tk, schedule="diagonal"),
                "ARMT sequential (fused cell, eager)": fwd(tk, schedule="sequential",
                                                          eager=True)}
        row = {}
        for label, fn in runs.items():
            r, out = timed_runs(fn)
            fin = bool(torch.isfinite(out).all())
            row[label] = dict(r, output_finite=fin)
            finite_t = all(math.isfinite(x) for v in r.values() for x in v)
            unchecked = ("" if label.startswith("full") else
                         " (not checked: the untrained ARMT normalizer overflows before "
                         "segment 16, ROADMAP Queue 3)")
            log(f"  {n_tok} tokens, {label}: host wall median {med(r['wall_s']):.4f} s "
                f"(runs {' '.join(f'{x:.4f}' for x in r['wall_s'])}), CUDA-event span median "
                f"{med(r['device_s']):.4f} s (runs {' '.join(f'{x:.4f}' for x in r['device_s'])};"
                f" idle gaps included), peak {max(r['peak_gb']):.2f} GB; output finite "
                f"{fin}{unchecked}; card {smi}")
            if not finite_t:
                failures.append(f"schedules timing {n_tok} {label}: non-finite time")
            if label.startswith("full") and not fin:
                failures.append(f"full attention at {n_tok} tokens: non-finite output")
            del out
            torch.cuda.empty_cache()
        full_, seq_, diag_, eseq_ = ([med(row[k][m]) for m in ("device_s", "wall_s")]
                                     for k in runs)
        log(f"  {n_tok} tokens: CUDA-event ratios full/diagonal {full_[0] / diag_[0]:.2f}, "
            f"sequential/diagonal {seq_[0] / diag_[0]:.2f} captured, {eseq_[0] / diag_[0]:.2f} "
            f"eager (host wall {full_[1] / diag_[1]:.2f}; {seq_[1] / diag_[1]:.2f} captured, "
            f"{eseq_[1] / diag_[1]:.2f} eager); the paper's figures at 131,072 tokens, quoted, "
            f"not measured here: 3.3x and 1.8x; card {smi}")
        sched_timing[str(n_tok)] = row
        del tk
    print(json.dumps({"schedules": sched_timing, "schedules_exact": schedules_exact,
                      "decode_step": decode_step_rows, "card": smi}))

    # ------------------------------------------------------------ (o) interleaved admission
    log("== interleaved admission: llama-1b-armt, full width and depth, bf16, seed 0")
    from repro_torch.core.schedule import StackLayout, n_diagonal_groups
    layout = StackLayout.from_config(cfg)
    L = layout.n_layers
    exec_p = {"prelude": params["prelude"], "pattern": params["pattern"]}
    interleave = {}

    def same_tree(a, b):
        return all(same_bits(a[k], b[k]) for k in a)

    def embedded(n_seg, seed):
        tk = torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.vocab, (1, n_seg * seg))).to(dev)
        return M.embed_segments(params, cfg, tk, seg)

    with torch.no_grad():
        # (o1) the resumable pipeline against the one-shot executor, to the bit
        x16 = embedded(16, 101)
        st0 = M.init_state(cfg, 1, dev)
        n_steps = n_diagonal_groups(16, L)
        ys_ref, fin_ref, cap_ref = diag.run_diagonal(layout, exec_p, st0, x16, engine._apply,
                                                  grouped_apply=engine._gapply,
                                                  capture_states=True)
        logits_ref = M.last_logits(params, cfg, ys_ref[:, :, :seg])
        pipe_ok = {}
        for k in (1, 4, n_steps):
            xs, carry = diag.pipeline_init(layout, st0, x16)
            calls = 0
            t0 = time.perf_counter()
            while calls * k < n_steps:
                engine.prefill_step(xs, carry, k)
                calls += 1
            sync()
            t_pipe = time.perf_counter() - t0
            before = carry["ys"].clone()
            engine.prefill_step(xs, carry, 1)              # one overshoot step: a no-op
            ys_p, fin_p, _ = diag.pipeline_finalize(layout, carry)
            ok = (same_bits(ys_p, ys_ref) and same_bits(before, ys_p)
                  and same_bits(M.last_logits(params, cfg, ys_p[:, :, :seg]), logits_ref)
                  and same_tree(fin_p["pattern"][0], fin_ref["pattern"][0]))
            pipe_ok[f"k={k}"] = dict(bitwise=ok, calls=calls, host_s=t_pipe)
            log(f"  pipeline_step k={k} ({calls} calls + 1 overshoot, {t_pipe:.3f} s host) vs "
                f"run_diagonal, 16 segments: every segment's hidden states, the last logits, "
                f"every layer's A and z to the bit {ok} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"pipeline_step k={k} vs run_diagonal")
            del xs, carry, before, ys_p, fin_p
        interleave["pipeline_vs_run_diagonal"] = pipe_ok

        # (o2) capture: boundary c against a run over the first c segments;
        # stream: brow and win against the full ys
        bs = diag.boundary_states_from_capture(layout, cap_ref, 16)
        cap_ok = {}
        for c in (1, 4, 16):
            _, fin_c = diag.run_diagonal(layout, exec_p, st0, x16[:c], engine._apply,
                                      grouped_apply=engine._gapply)
            ok = all(same_bits(bs["pattern"][0][k][c - 1], fin_c["pattern"][0][k])
                     for k in ("A", "z"))
            cap_ok[f"c={c}"] = ok
            log(f"  capture: boundary {c} vs the final state of run_diagonal over {c} "
                f"segments, every layer's A and z to the bit {ok} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"capture boundary {c}")
        del bs, cap_ref
        out_s, fin_s = diag.run_diagonal(layout, exec_p, st0, x16, engine._apply,
                                      grouped_apply=engine._gapply, stream_ys=True,
                                      retain_pos=seg - 1)
        W = out_s["win"].shape[0]
        ok = (same_bits(out_s["brow"], ys_ref[:, :, seg - 1])
              and all(same_bits(out_s["win"][s % W], ys_ref[s]) for s in range(16 - W, 16))
              and same_tree(fin_s["pattern"][0], fin_ref["pattern"][0]))
        cap_ok["stream"] = ok
        log(f"  stream_ys: brow (16 rows) and win ({W} segments) vs the full ys to the bit "
            f"{ok} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("stream_ys vs full ys")
        interleave["capture_and_stream"] = cap_ok
        del out_s, fin_s, ys_ref, fin_ref, x16
        torch.cuda.empty_cache()

        # (o3) the pooled step: members of 4, 8 and 16 segments at cursors 0,
        # 5 and past the end, k = 4; each to the bit against its own steps
        def members():
            out = []
            for i, (n_seg, done) in enumerate([(4, 0), (8, 5), (16, n_diagonal_groups(16, L) + 1)]):
                xs, carry = diag.pipeline_init(layout, st0, embedded(n_seg, 200 + i))
                engine.prefill_step(xs, carry, done)
                out.append((None, xs, carry))
            return out
        pool_m, own_m = members(), members()
        sync()
        _, n_pool, r_pool = counted(lambda: engine.pool_prefill_step_run(1, pool_m))
        _, n_one, _ = counted(lambda: engine.prefill_step(own_m[1][1], own_m[1][2], 1))
        for i in (0, 2):
            engine.prefill_step(own_m[i][1], own_m[i][2], 1)
        engine.pool_prefill_step_run(4, pool_m)
        for _, xs, carry in own_m:
            engine.prefill_step(xs, carry, 4)
        sync()
        ok_m = [a[2]["step"] == b[2]["step"] and same_bits(a[2]["ys"], b[2]["ys"])
                and same_bits(a[2]["buf"], b[2]["buf"])
                and same_tree(a[2]["state"]["pattern"][0], b[2]["state"]["pattern"][0])
                for a, b in zip(pool_m, own_m)]
        launches_ok = n_pool == n_one
        log(f"  pooled step (members of 4, 8, 16 segments at cursors 0, 5, past the end; 1 + "
            f"4 steps) vs each member's own steps, buffers, outputs, A and z to the bit: "
            f"{ok_m}; launches of one pooled step {n_pool} vs one member's band step {n_one} "
            f"(routes {r_pool}) -> {'ok' if all(ok_m) and launches_ok else 'FAIL'}")
        if not all(ok_m):
            failures.append(f"pooled step vs own steps {ok_m}")
        if not launches_ok:
            failures.append("a pooled band step launched more kernels than one band step")
        interleave["pooled_step"] = dict(bitwise=ok_m, launches_pool=n_pool,
                                         launches_one=n_one)
        del pool_m, own_m
        torch.cuda.empty_cache()

    # (o4) interleaved serve against blocking, phase (e)'s requests
    def by_req(evs):
        out = {}
        for e in evs:
            if not isinstance(e, RequestError):
                out.setdefault(e.req_id, []).append((e.token, e.index, e.done, e.finite))
        return out
    (b_events, t_block), _, _ = counted(lambda: serve_run(engine, reqs,
                                                          prefill_groups_per_chunk=0))
    blocking = by_req(b_events)
    n_tok = sum(len(v) for v in blocking.values())
    settings = {first_serve: None,
                "k=4": {},
                "k=1": dict(prefill_groups_per_chunk=1),
                "k=-1": dict(prefill_groups_per_chunk=-1),
                "k=4 max_concurrent_admissions=1": dict(max_concurrent_admissions=1),
                "k=4 oldest_first": dict(admission_fairness="oldest_first"),
                "k=4 fused": dict(fused_admission=True),
                "k=1 fused max_concurrent_admissions=1": dict(
                    prefill_groups_per_chunk=1, fused_admission=True,
                    max_concurrent_admissions=1)}
    launches_inter, routes_inter = {}, {}
    serve_rows = {"k=0 (blocking)": dict(tok_s=n_tok / t_block)}
    for label, kw in settings.items():
        if kw is None:
            evs, t_run = events, t_serve
        else:
            (evs, t_run), nl, nr = counted(lambda: serve_run(engine, reqs, label, **kw))
            launches_inter, routes_inter = merged(launches_inter, nl), merged(routes_inter, nr)
        ok = by_req(evs) == blocking
        serve_rows[label] = dict(events_equal_blocking=ok, tok_s=n_tok / t_run,
                                 pooled_band_steps=pooled[label])
        log(f"  serve {label}: every request's events equal blocking's {ok}; "
            f"{n_tok / t_run:.1f} tok/s (blocking {n_tok / t_block:.1f}); pooled band steps "
            f"{pooled[label]} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"interleaved serve {label} vs blocking")
    log(f"  launches in the interleaved serve runs: {launches_inter}; GEMM and flash "
        f"launches by route {routes_inter}")
    for name in llama_kernels:
        if launches_inter[name] == 0 and name != "armt_update":   # B > 1 only
            failures.append(f"{name} never launched by interleaved serve")
    for k in routed:
        if routes_inter[k]["simt"] or not routes_inter[k]["wgmma"]:
            failures.append(f"interleaved serve's {k} left the TMA + wgmma route: "
                            f"{routes_inter[k]}")
    interleave["serve_vs_blocking"] = serve_rows

    # the stall run: 3 requests decode on 4 slots while a 16-segment prompt
    # arrives (the source has nothing for its first pulls after them)
    short = [Request(f"s{i}", rng.integers(0, cfg.vocab, seg + 100 * (i + 1)), 128)
             for i in range(3)]
    long_req = Request("long", rng.integers(0, cfg.vocab, 16 * seg), 16)

    def stall_source():
        yield from short
        for _ in range(4):
            yield None
        yield long_req

    def stall_run(**kw):
        diag.pool_counts.update(steps=0, member_steps=0)
        t0 = time.perf_counter()
        evs = [e for e in engine.serve(stall_source(), n_slots=4, chunk=8, **kw)
               if not isinstance(e, RequestError)]
        sync()
        wall = time.perf_counter() - t0
        gaps = []
        for r in short:
            ts = sorted({e.t_emit for e in evs if e.req_id == r.req_id})
            gaps += [b - a for a, b in zip(ts, ts[1:])]
        return evs, dict(tok_s=len(evs) / wall, wall_s=wall,
                         ttft_s={e.req_id: e.ttft_s for e in evs if e.index == 0},
                         longest_gap_s=max(gaps), tokens=len(evs),
                         pooled_band_steps=dict(diag.pool_counts))
    stall = {}
    stall_events = {}
    stall_run(prefill_groups_per_chunk=0)        # warm-up: the allocator's first 16 segments
    for i, k in enumerate((0, 4, 4, 0)):
        stall_events[k], stall[f"k={k} run {i + 1}"] = stall_run(prefill_groups_per_chunk=k)
        row = stall[f"k={k} run {i + 1}"]
        log(f"  stall run {i + 1}, k={k}: {row['tokens']} tokens in {row['wall_s']:.3f} s, "
            f"aggregate {row['tok_s']:.1f} tok/s; TTFT " + ", ".join(
                f"{r} {t:.3f} s" for r, t in row["ttft_s"].items())
            + f"; longest host gap between two chunks of a decoding slot "
            f"{row['longest_gap_s'] * 1e3:.1f} ms; pooled band steps "
            f"{row['pooled_band_steps']}; card {smi}")
    ok = by_req(stall_events[0]) == by_req(stall_events[4])
    log(f"  stall run: k=4 events equal k=0's {ok} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("stall run k=4 vs blocking")
    interleave["stall_run"] = stall

    # (o5) the byte budget: the 16-segment prompt through the streaming carry
    # in stages of 4 segments; its tokens, and the admission's peak memory
    budget = engine.prefill_activation_bytes(4, stream=True)
    b_evs = list(engine.serve(stall_source(), n_slots=4, chunk=8,
                              admission_byte_budget=budget))
    ok = by_req(b_evs) == by_req(stall_events[0])
    sched = ContinuousScheduler(engine, admission_byte_budget=budget)
    plan = sched._admission_plan(len(long_req.prompt))
    ok = ok and plan == (True, 4)
    peaks = {}
    with torch.no_grad():
        for label, kw, est in [
                ("stream, stages of 4", dict(stream=True, max_stage_segments=4),
                 budget),
                ("full ys, one stage of 16", {},
                 engine.prefill_activation_bytes(16, stream=False))]:
            torch.cuda.empty_cache()
            sync()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            pipe = engine.start_prefill(long_req.prompt[None], groups_per_call=4, **kw)
            while not pipe.advance():
                pass
            sync()
            peaks[label] = dict(peak_bytes=torch.cuda.max_memory_allocated() - base,
                                estimate_bytes=est)
            del pipe
    bounded = all(v["peak_bytes"] <= v["estimate_bytes"] for v in peaks.values())
    log(f"  byte budget {budget} B (prefill_activation_bytes(4, stream)): plan {plan}, "
        f"tokens equal blocking's -> {'ok' if ok else 'FAIL'}; peak memory above the "
        f"admission's start: " + "; ".join(
            f"{k} {v['peak_bytes'] / 1e6:.1f} MB (estimate {v['estimate_bytes'] / 1e6:.1f} MB)"
            for k, v in peaks.items()) + f"; every peak within its estimate "
        f"-> {'ok' if bounded else 'FAIL'}; card {smi}")
    if not ok:
        failures.append("byte-budget serve vs blocking")
    if not bounded:
        failures.append(f"an admission's peak memory above prefill_activation_bytes: {peaks}")
    interleave["byte_budget"] = dict(budget_bytes=budget, plan=list(plan), tokens_equal=ok,
                                     peaks=peaks)
    print(json.dumps({"interleave": interleave, "card": smi}))
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ (p1)-(p3), (q)
    # each a function called once below, so that its names stay out of
    # main's scope (several of them, new and sseg among them, are main's too)
    def prefix_cache_phases():
        """(p1) the prefix cache through generate, (p2) through serve. ->
        (summary, launches, routes) of the cache engine's runs."""
        from repro_torch.serve import PrefixCache, Request, ServeEngine
        from repro_torch.serve.state_store import tree_nbytes
        base, V = engine, cfg.vocab
        # the cold prompt's tail; the tails of (p2)'s four requests sharing a prefix
        p0_tail, serve_tails = 300, (10, 300, 990, 1010)
        hit_tails = (0, 1, seg - 1, seg + 3)
        out, launches, routes = {}, {}, {}

        def tally(fn):
            nonlocal launches, routes
            res, n, r = counted(fn)
            launches, routes = merged(launches, n), merged(routes, r)
            return res

        def same_run(a, b, first_bits=True):
            """Tokens, every step's logits (the first only if first_bits) and
            the final decode state to the bit."""
            return (np.array_equal(a.tokens, b.tokens)
                    and same_bits(a.logits[:, 1:], b.logits[:, 1:])
                    and (not first_bits or same_bits(a.logits[:, :1], b.logits[:, :1]))
                    and same_state(a.state, b.state))

        # ---- (p1) generate
        t_phase = time.perf_counter()
        log("== (p1) prefix cache through generate: llama-1b-armt, bf16, seed 0")
        snap_bytes = (tree_nbytes(M.init_state(cfg, 1, torch.device("meta"),
                                               params["embed"].dtype)) + V * 4)
        budget = 18 * snap_bytes              # one 16-segment prompt's boundaries, and two more
        pc = PrefixCache(seg, max_bytes=budget)
        ceng = ServeEngine(params, cfg, prefix_cache=pc)
        p0 = rng.integers(0, V, 16 * seg + p0_tail)
        cold = tally(lambda: ceng.generate(p0[None], 48, keep=True))
        ref = base.generate(p0[None], 48, keep=True)
        per_snap = pc.stats.bytes_in_ram / max(len(pc), 1)
        L, kv = M.StackLayout.from_config(cfg).n_layers, cfg.n_kv_heads * cfg.head_dim
        kv_16k = L * 2 * 16384 * kv * params["embed"].element_size()
        ok = len(pc) == 16 and cold.cached_segments == 0 and same_run(cold, ref)
        log(f"  cold generate, 16 segments + {p0_tail} tokens, 48 new: {len(pc)} snapshots of "
            f"{per_snap / 1e6:.3f} MB each (estimate {snap_bytes / 1e6:.3f} MB) beside a KV "
            f"prefix of 16,384 tokens {kv_16k / 1e6:.1f} MB; tokens, logits and final state "
            f"equal the engine without a cache to the bit -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("prefix cache: the capturing cold run differs from the engine "
                            "without a cache")
        out.update(snapshot_bytes=per_snap, snapshot_estimate_bytes=snap_bytes,
                   kv_prefix_16384_bytes=kv_16k, hits={})
        prompt81 = first81 = None
        for n_shared in (8, 16):
            for tail in hit_tails:
                prompt = np.concatenate([p0[:n_shared * seg], rng.integers(0, V, tail)])
                hit = tally(lambda: ceng.generate(prompt[None], 48, keep=True))
                nc = base.generate(prompt[None], 48, keep=True)
                exact = tail == 0
                first_bitwise = same_bits(hit.logits[:, :1], nc.logits[:, :1])
                first_err = row_rel(hit.logits[:, 0], nc.logits[:, 0])
                ok = (hit.cached_segments == n_shared and same_run(hit, nc, first_bits=not exact)
                      and (first_err <= 1e-2 if exact else first_bitwise))
                label = f"{n_shared} segments + {tail}"
                out["hits"][label] = dict(ok=ok, first_logits_bitwise=first_bitwise,
                                          first_logits_rel_err=first_err)
                first = ("first logits bitwise" if first_bitwise
                         else f"first logits rel err {first_err:.3e} (tol 1e-2)")
                log(f"  hit {label}{' (the exact full hit)' if exact else ''}: cached "
                    f"{hit.cached_segments}; tokens, logits and final state vs no cache: "
                    f"{first} -> {'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(f"prefix cache hit {label} vs no cache")
                if n_shared == 8 and tail == 1:
                    prompt81, first81 = prompt, hit
        again = tally(lambda: ceng.generate(prompt81[None], 48, keep=True))
        ok = again.cached_segments == 8 and same_run(again, first81)
        out["second_hit_bitwise"] = ok
        log(f"  the 8-segment + 1 hit again (aliasing): to the bit the first -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("prefix cache: a second hit on one prefix differs from the first")
        # control: one layer of the 16-segment snapshot's A scaled by 1.01
        n, snap = pc.match(p0[:16 * seg])
        A = snap.state["pattern"][0]["A"]
        saved = A[L // 3].clone()
        A[L // 3].mul_(1.01)
        prompt = np.concatenate([p0[:16 * seg], rng.integers(0, V, 1)])
        bad = ceng.generate(prompt[None], 48, keep=True)
        caught = bad.cached_segments == 16 and not same_run(bad, base.generate(prompt[None], 48,
                                                                               keep=True))
        A[L // 3].copy_(saved)
        out["control_caught"] = caught
        log(f"  control: layer {L // 3}'s A x1.01 in the stored snapshot: the hit differs from "
            f"no cache {caught} -> {'ok' if caught else 'FAIL'}")
        if not caught:
            failures.append("prefix cache control (snapshot A x1.01) was not caught")
        # TTFT, host clock, median of 3
        pr = np.concatenate([p0[:16 * seg], rng.integers(0, V, seg - 1)])
        def median3(fn):
            return float(np.median([fn() for _ in range(3)]))
        ttft = {"hit 16 + %d" % (seg - 1): median3(lambda: ceng.generate(pr[None], 48).ttft_s),
                "no cache 16 + %d" % (seg - 1): median3(lambda: base.generate(pr[None], 48).ttft_s)}
        colds = []
        for _ in range(3):
            ceng.prefix_cache = PrefixCache(seg, max_bytes=budget)
            colds.append(ceng.generate(p0[None], 48).ttft_s)
        ttft[f"cold with a cache 16 + {p0_tail} (capture)"] = float(np.median(colds))
        ttft[f"no cache 16 + {p0_tail}"] = median3(lambda: base.generate(p0[None], 48).ttft_s)
        ceng.prefix_cache = pc
        out["ttft_s"] = ttft
        log("  TTFT (host clock, median of 3): " + "; ".join(f"{k} {v:.4f} s"
                                                             for k, v in ttft.items())
            + f"; card {smi}")
        out["stats_p1"] = pc.stats.as_dict()
        log(f"  prefix cache stats: {out['stats_p1']}; phase {time.perf_counter() - t_phase:.1f} s")

        # ---- (p2) serve: 6 requests on 4 slots, 4 of them sharing 8 segments
        t_phase = time.perf_counter()
        log("== (p2) prefix cache through serve: 4 slots, chunk 8, 6 requests, 4 sharing 8 "
            "segments")
        shared = rng.integers(0, V, 8 * seg)
        spec = [("c0", serve_tails[0], 40), ("o0", None, 32), ("c1", serve_tails[1], 48),
                ("c2", serve_tails[2], 56), ("o1", None, 64), ("c3", serve_tails[3], 24)]
        others = {"o0": seg + serve_tails[2], "o1": 2 * seg + serve_tails[2]}
        reqs = [Request(rid, np.concatenate([shared, rng.integers(0, V, t)]) if t is not None
                        else rng.integers(0, V, others[rid]), new) for rid, t, new in spec]
        want, _ = serve_run(base, reqs)
        want = by_req(want)
        out["serve"] = {}
        for label, kw in (("k=4", {}), ("blocking", dict(prefill_groups_per_chunk=0))):
            ceng.prefix_cache = PrefixCache(seg, max_bytes=budget)
            evs, t_run = tally(lambda: serve_run(ceng, reqs, **kw))
            ok = by_req(evs) == want
            st = ceng.prefix_cache.stats.as_dict()
            out["serve"][label] = dict(events_equal=ok, hits=st["hits"], misses=st["misses"],
                                       insertions=st["insertions"], tok_s=len(evs) / t_run,
                                       pooled_band_steps=dict(diag.pool_counts))
            log(f"  serve {label} with a cache: every request's events equal serve without "
                f"one {ok}; hits {st['hits']}, misses {st['misses']}, insertions "
                f"{st['insertions']}; {len(evs) / t_run:.1f} tok/s; pooled band steps "
                f"{dict(diag.pool_counts)} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"prefix-cache serve {label} vs no cache")
        # a capturing admission's peak against the byte estimate
        ceng.prefix_cache = PrefixCache(seg, max_bytes=budget)
        long_prompt = rng.integers(0, V, 16 * seg)
        est = ceng.prefill_activation_bytes(16, stream=False)
        peak = None
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            sync()
            start = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            pipe = ceng.start_prefill(long_prompt[None], groups_per_call=4)
            while not pipe.advance():
                pass
        sync()
        if dev.type == "cuda":
            peak = torch.cuda.max_memory_allocated() - start
        ok = peak is not None and peak <= est and len(ceng.prefix_cache) == 16
        out["capturing_admission"] = dict(peak_bytes=peak, estimate_bytes=est)
        log(f"  a capturing admission of 16 segments (k = 4, full ys): peak "
            f"{(peak or 0) / 1e6:.1f} MB above its start, estimate {est / 1e6:.1f} MB "
            f"(prefill_activation_bytes with the capture term) -> {'ok' if ok else 'FAIL'}; "
            f"card {smi}")
        if not ok:
            failures.append(f"capturing admission peak {peak} above its estimate {est}")
        del pipe, ceng
        log(f"  phase {time.perf_counter() - t_phase:.1f} s")
        return out, launches, routes

    def session_phases():
        """(p3) a 3-turn session through generate and serve: in memory against
        spilled, evictions, smoke config card against CPU, against one
        generate over the history. -> (summary, launches, routes) of the
        in-memory runs."""
        import tempfile
        from repro_torch.serve import (Request, RequestError, ServeEngine, SessionEvicted,
                                       SessionStore)
        t_phase = time.perf_counter()
        log("== (p3) sessions: llama-1b-armt, bf16; turns of 2 segments + 5, 7, and 2 segments")
        eng, V, new = engine, cfg.vocab, 24       # new: each turn's new tokens
        out, launches, routes = {}, {}, {}

        def flow(e, turns, other):
            """Turns through generate (session 'g'), then through serve (turn 1
            beside another request, turn 2 at k = 4) and generate (turn 3)."""
            gen = [e.generate(t[None], new, session_id="g", keep=True) for t in turns]
            ev1 = list(e.serve([Request("s1", turns[0], new, "s"), Request("x", other, 16)],
                               n_slots=4, chunk=8))
            ev2 = list(e.serve([Request("s2", turns[1], new, "s")], n_slots=4, chunk=8))
            g3 = e.generate(turns[2][None], new, session_id="s", keep=True)
            return gen, ev1, ev2, g3

        turns = [rng.integers(0, V, 2 * seg + 5), rng.integers(0, V, 7),
                 rng.integers(0, V, 2 * seg)]
        other = rng.integers(0, V, seg + 300)
        with tempfile.TemporaryDirectory() as spill:
            eng.session_store = SessionStore(max_bytes=4 << 30)
            res, n, r = counted(lambda: flow(eng, turns, other))
            launches, routes = merged(launches, n), merged(routes, r)
            eng.session_store = SessionStore(max_bytes=1, spill_dir=spill)
            spilled = flow(eng, turns, other)
            spills = eng.session_store.stats.as_dict()
        gen, ev1, ev2, g3 = res
        same = (all(np.array_equal(a.tokens, b.tokens) and same_bits(a.logits, b.logits)
                    and same_state(a.state, b.state)
                    for a, b in zip(gen + [g3], spilled[0] + [spilled[3]]))
                and streams(ev1) == streams(spilled[1]) and streams(ev2) == streams(spilled[2])
                and all(x.resumed for x in gen[1:] + [g3]))
        out["spilled_equals_in_memory"] = same
        log(f"  (i) spilled and restored (store of 1 byte: {spills['spills']} spills, "
            f"{spills['restores']} restores) vs kept in memory: tokens, every step's logits and "
            f"state of each generate turn and the events of each serve turn to the bit "
            f"{same} -> {'ok' if same else 'FAIL'}")
        if not same:
            failures.append("sessions: spilled and restored differ from in memory")
        # (ii) eviction is loud; an unknown id starts fresh
        eng.session_store = SessionStore(max_bytes=1)
        eng.generate(turns[1][None], 4, session_id="gone")
        try:
            eng.generate(turns[1][None], 4, session_id="gone")
            raised = False
        except SessionEvicted:
            raised = True
        evs = list(eng.serve([Request("e", turns[1], 4, "gone")], n_slots=4, chunk=8))
        fresh = list(eng.serve([Request("f", turns[1], 4, "fresh")], n_slots=4, chunk=8))
        ok = (raised and len(evs) == 1 and isinstance(evs[0], RequestError)
              and evs[0].code == "session_evicted"
              and [e.index for e in fresh if not isinstance(e, RequestError)] == [0, 1, 2, 3])
        out["eviction_loud"] = ok
        log(f"  (ii) an evicted session (no spill): generate raises SessionEvicted {raised}, "
            f"serve yields {[getattr(e, 'code', None) for e in evs]}; an unknown id starts "
            f"fresh -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("sessions: an evicted session was not loud")
        eng.session_store = None
        # (iii) smoke config, fp32: card against CPU over the whole flow
        sseg = scfg.armt.segment_len
        sturns = [rng.integers(0, scfg.vocab, n) for n in (2 * sseg + 5, 7, 2 * sseg)]
        sother = rng.integers(0, scfg.vocab, sseg + 3)

        def tokens_of(run):
            gen, ev1, ev2, g3 = run
            return ([x.tokens.tolist() for x in gen + [g3]],
                    [(e.req_id, e.token) for e in ev1 + ev2 if not isinstance(e, RequestError)])
        card = tokens_of(flow(ServeEngine(sp_gpu, scfg, session_store=SessionStore()),
                              sturns, sother))
        cpu = tokens_of(flow(ServeEngine(sp, scfg, device="cpu",
                                         session_store=SessionStore()), sturns, sother))
        ok = card == cpu
        out["smoke_card_equals_cpu"] = ok
        log(f"  (iii) smoke config (fp32), the whole flow, card vs CPU: tokens equal {ok} -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("sessions: smoke config card vs cpu")
        # (iv) each generate turn against one generate over the whole history
        hist = np.empty(0, np.int64)
        out["vs_history"] = []
        for i, (t, x) in enumerate(zip(turns, gen)):
            h = np.concatenate([hist, t])
            ref = eng.generate(h[None], new, keep=True)
            err = row_rel(x.logits[:, 0], ref.logits[:, 0])
            gated = len(h) // seg <= 2
            ok = err <= 5e-2 or not gated
            row = dict(turn=i + 1, history_tokens=len(h), first_logits_rel_err=err, gated=gated,
                       tokens_equal=bool(np.array_equal(x.tokens, ref.tokens)),
                       ttft_resumed_s=x.ttft_s, ttft_reprefill_s=ref.ttft_s)
            out["vs_history"].append(row)
            log(f"  (iv) turn {i + 1} (history {len(h)} tokens) vs one generate over the "
                f"history: first logits rel err {err:.3e}"
                f"{' (tol 5e-2)' if gated else ' (printed only: past 2 segments)'}, tokens "
                f"equal {row['tokens_equal']}; TTFT resumed {x.ttft_s:.4f} s vs re-prefill "
                f"{ref.ttft_s:.4f} s -> {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"sessions: turn {i + 1} vs the history")
            hist = np.concatenate([h, x.tokens[0]])
        log(f"  phase {time.perf_counter() - t_phase:.1f} s; card {smi}")
        return out, launches, routes

    def telemetry_phase():
        """(q) phase (e)'s requests through serve with the trace on: the trace's
        schema, the events against telemetry off, the device-to-host
        conversions per chunk; tok/s on against off, ITL percentiles, the
        stall run's admission stall, the first serve's span totals beside a
        warm one's."""
        import tempfile
        from repro_torch.serve import MetricsRegistry, Telemetry, validate_chrome_trace
        from repro_torch.serve.telemetry import _main as trace_cli
        t_phase = time.perf_counter()
        log("== (q) telemetry: phase (e)'s requests through serve, Telemetry(trace=True)")
        eng, out = engine, {}

        def traced():
            return Telemetry(trace=True, registry=MetricsRegistry())
        eng.telemetry = traced()
        with device_reads(torch) as reads_on:
            (evs_on, t_on) = serve_run(eng, reqs)
        tel = eng.telemetry
        n_chunks = sum(1 for s in tel.trace.spans if s.name == "decode_chunk")
        eng.telemetry = Telemetry.disabled()
        with device_reads(torch) as reads_off:
            (evs_off, t_off) = serve_run(eng, reqs)
        same = streams(evs_on) == streams(evs_off)
        with tempfile.TemporaryDirectory() as d:
            path = f"{d}/trace.json"
            tel.trace.export(path)
            errs = validate_chrome_trace(path)
            cli = trace_cli([path, "--require-cats", "decode,admission,transplant,flush"])
        reads_ok = reads_on[0] == n_chunks and reads_off[0] == reads_on[0]
        ok = same and not errs and cli == 0 and reads_ok
        out.update(trace_valid=not errs and cli == 0, events_equal_off=same, chunks=n_chunks,
                   device_reads_on=reads_on[0], device_reads_off=reads_off[0],
                   itl_p50_p99_s=list(tel.trace.itl_percentiles()))
        log(f"  trace: {len(tel.trace.spans)} spans, schema problems {errs[:3]}, CLI gate "
            f"(decode, admission, transplant, flush) rc {cli}; events with telemetry on equal "
            f"off {same}; device-to-host conversions {reads_on[0]} on, {reads_off[0]} off, over "
            f"{n_chunks} chunks (one per chunk: the tokens and finite flags) -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("telemetry: trace, events or device reads")
        # tok/s on against off, alternating
        rates = {"off": [], "on": []}
        for mode in ("off", "on", "on", "off"):
            eng.telemetry = traced() if mode == "on" else Telemetry.disabled()
            evs, t = serve_run(eng, reqs)
            rates[mode].append(len(evs) / t)
        out["tok_s"] = rates
        log(f"  tok/s, telemetry off / on, alternating: {rates['off']} / {rates['on']}; ITL p50, "
            f"p99 {out['itl_p50_p99_s']} s; card {smi}")
        # the stall run's admission stall beside chip_smoke's own longest gap
        # (after an untraced warm-up, as phase (o)'s: the allocator's first
        # 16 segments since the caches above were freed)
        stall_run(prefill_groups_per_chunk=4)
        eng.telemetry = traced()
        _, row = stall_run(prefill_groups_per_chunk=4)
        out["stall_run"] = dict(admission_stall_s=eng.telemetry.trace.admission_stall_s(),
                                longest_gap_s=row["longest_gap_s"])
        log(f"  stall run (k = 4): admission_stall_s {out['stall_run']['admission_stall_s']:.4f} "
            f"s, chip_smoke's longest gap of a decoding slot {row['longest_gap_s']:.4f} s")
        # the process's first interleaved serve (phase (e)) beside a warm one
        keys = ("admission_round", "decode_chunk", "transplant", "flush_segment", "admission",
                "idle_drain_round")
        first, warm = first_trace.span_totals(), tel.trace.span_totals()
        out["spans_first_vs_warm"] = {k: dict(first=first.get(k), warm=warm.get(k)) for k in keys}
        log("  span totals (count, s), phase (e)'s first serve / warm: " + "; ".join(
            f"{k} {first.get(k, {}).get('count', 0)}, {first.get(k, {}).get('total_s', 0.0):.4f} / "
            f"{warm.get(k, {}).get('count', 0)}, {warm.get(k, {}).get('total_s', 0.0):.4f}"
            for k in keys) + f" (wall {t_serve:.3f} / {t_on:.3f} s)")
        eng.telemetry = Telemetry()
        log(f"  phase {time.perf_counter() - t_phase:.1f} s")
        return out

    stores = {}
    stores["prefix_cache"], launches_prefix, routes_prefix = prefix_cache_phases()
    stores["sessions"], launches_sess, routes_sess = session_phases()
    for label, n, r in (("prefix_cache", launches_prefix, routes_prefix),
                        ("sessions", launches_sess, routes_sess)):
        log(f"  launches in the {label} runs: {n}; GEMM and flash launches by route {r}")
        for name in llama_kernels:
            if n[name] == 0 and name != "armt_update":   # B > 1 only
                failures.append(f"{name} never launched by the {label} runs")
        for k in routed:
            if r[k]["simt"] or not r[k]["wgmma"]:
                failures.append(f"the {label} runs' {k} left the TMA + wgmma route: {r[k]}")
    stores["telemetry"] = telemetry_phase()
    print(json.dumps({"stores": stores, "card": smi}))

    del engine, eager_engine, params, events
    torch.cuda.empty_cache()

    sspec = [(1, 5, 20), (2, 3, 14), (0, 7, 25), (3, 0, 9), (1, 11, 17)]
    sreqs = [Request(i, rng.integers(0, scfg.vocab, n * sseg + tail), new)
             for i, (n, tail, new) in enumerate(sspec)]

    def served(eng):
        out = {}
        for e in eng.serve(sreqs, n_slots=2, chunk=4):
            out.setdefault(e.req_id, []).append(getattr(e, "token", e))
        return out
    on_card, on_cpu = served(ServeEngine(sp_gpu, scfg)), served(ServeEngine(sp, scfg, device="cpu"))
    same = on_card == on_cpu and all(len(on_card[i]) == r.max_new for i, r in enumerate(sreqs))
    log(f"  smoke config (fp32) serve, 5 requests on 2 slots, card kernels vs CPU plain "
        f"path: tokens equal {same}")
    if not same:
        failures.append("smoke serve card vs cpu")

    del sp, sp_gpu
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ (r) dense configs
    def dense_config_phase():
        """(r) the five other dense ARMT configs, one at a time, at full width
        in bf16, random weights drawn on the card from the seed, the QKV
        biases (normal x 0.02) and q/k norm weights (1 + normal x 0.1) set
        non-zero. qwen2.5-32b runs 16 of its 64 layers and chameleon-34b 12
        of 48 (full depth would not fit the card: ~69 and ~75 GB of
        weights); the others run at full depth. Returns (launches and
        routes summed over the phase's graph, prefill and serve runs, the
        per-config results)."""
        from repro_torch.serve.state_store import tree_nbytes
        log("== (r) dense configs: full width, bf16, QKV biases and q/k norm weights "
            "non-zero")
        M.SegmentProgram._cache.clear()
        torch.cuda.empty_cache()
        plan = [("h2o-danube-1.8b", None), ("chatglm3-6b", None), ("minitron-8b", None),
                ("qwen2.5-32b", 16), ("chameleon-34b", 12)]
        launches, routes, out = {}, {}, {}

        def add(n, r):
            nonlocal launches, routes
            launches, routes = merged(launches, n), merged(routes, r)
            return n, r

        for arch, depth in plan:
            t_phase = time.perf_counter()
            torch.cuda.reset_peak_memory_stats(dev)
            cfg = get_config(arch)
            full_depth = cfg.n_layers
            if depth is not None:
                cfg = replace(cfg, n_layers=depth)
            g = torch.Generator(device=dev).manual_seed(SEED)
            params = M.init_params(cfg, g, device=dev)
            attn = params["pattern"][0]["attn"]
            for b in ("bq", "bk", "bv"):
                if b in attn:
                    attn[b].copy_(torch.randn(attn[b].shape, generator=g, device=dev) * 0.02)
            for n in ("qn", "kn"):
                if n in attn:
                    attn[n]["w"].copy_(1 + 0.1 * torch.randn(attn[n]["w"].shape, generator=g,
                                                             device=dev))
            sync()
            row = dict(depth=cfg.n_layers, full_depth=full_depth,
                       weights_gb=tree_nbytes(params) / 1e9,
                       init_s=time.perf_counter() - t_phase)
            log(f"-- {arch}: {cfg.n_layers} of {full_depth} layers"
                f"{' (reduced depth)' if depth else ''}, {row['weights_gb']:.2f} GB of bf16 "
                f"weights, made on the card in {row['init_s']:.2f} s; hd "
                f"{cfg.head_dim}, {cfg.n_heads}/{cfg.n_kv_heads} heads, qkv_bias "
                f"{cfg.qkv_bias}, qk_norm {cfg.qk_norm}, rope_fraction {cfg.rope_fraction}, "
                f"window {cfg.sliding_window}")
            seg = cfg.armt.segment_len
            tk = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 4 * seg))).to(dev)

            def fwd(tokens=tk, **kw):
                with torch.no_grad():
                    h, f = M.forward_hidden(params, cfg, tokens, **kw)
                    return h, f, seg_logits(params, cfg, h)

            def timed_run(**kw):
                t0 = time.perf_counter()
                res = fwd(**kw)
                sync()
                return res, time.perf_counter() - t0
            # the first runs launch each shape once (and capture the segment
            # graph); the second are timed
            (hd_, fd_, ld_), nd, rd = counted(lambda: fwd(schedule="diagonal"))
            add(nd, rd)
            (hs_, fs_, ls_), ns, rs = counted(lambda: fwd(schedule="sequential"))
            add(ns, rs)
            _, row["prefill_diagonal_s"] = timed_run(schedule="diagonal")
            _, row["prefill_sequential_s"] = timed_run(schedule="sequential")
            sd_, ss_ = fd_["pattern"][0], fs_["pattern"][0]
            exact = {"hidden": same_bits(hd_, hs_), "logits": same_bits(ld_, ls_),
                     "A": same_bits(sd_["A"], ss_["A"]), "z": same_bits(sd_["z"], ss_["z"])}
            row["diagonal_equals_sequential"] = exact
            ok = all(exact.values())
            log(f"  4-segment prefill, diagonal vs sequential (captured segments), both on "
                f"the fused cell: to the bit {exact} -> {'ok' if ok else 'FAIL'}; diagonal "
                f"{row['prefill_diagonal_s']:.3f} s, sequential {row['prefill_sequential_s']:.3f}"
                f" s; card {smi}")
            if not ok:
                failures.append(f"{arch}: diagonal vs sequential not bitwise {exact}")
            hp, _, lp = fwd(tk[:, :2 * seg], schedule="sequential", fused=False)
            errs = [rel_err(ld_[i], lp[i]) for i in range(2)]
            herrs = [rel_err(hd_[i], hp[i]) for i in range(2)]
            ok = bool(torch.isfinite(ld_).all()) and max(errs) <= 5e-2
            row.update(plain_logits_rel_err=errs, plain_hidden_rel_err=herrs)
            log(f"  segments 1-2, diagonal on the kernels vs sequential plain: last-token "
                f"logits rel err {' '.join(f'{e:.2e}' for e in errs)} (tol 5e-2), hidden "
                f"{' '.join(f'{e:.2e}' for e in herrs)} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{arch}: first 2 segments vs the plain path")
            del hd_, fd_, ld_, hs_, fs_, ls_, sd_, ss_, hp, lp

            eng, eng_e = ServeEngine(params, cfg), ServeEngine(params, cfg, eager=True)
            prompt = rng.integers(0, cfg.vocab, (1, 2 * seg + 1020))   # flushes at token 4
            gres, ng, rg = counted(lambda: eng.generate(prompt, 16, keep=True))
            add(ng, rg)
            eres, ne, _ = counted(lambda: eng_e.generate(prompt, 16, keep=True))
            good = (gres.finite and gres.tokens.shape == (1, 16)
                    and 0 <= gres.tokens.min() and gres.tokens.max() < cfg.vocab)
            log(f"  generate B=1, prompt {prompt.shape[1]}, 16 new: TTFT {gres.ttft_s:.3f} s, "
                f"{gres.tok_s:.1f} tok/s (capture {gres.capture_s:.3f} s); eager TTFT "
                f"{eres.ttft_s:.3f} s, {eres.tok_s:.1f} tok/s; finite {gres.finite} -> "
                f"{'ok' if good else 'FAIL'}; launches {ng}; card {smi}")
            log(f"    tokens: {gres.tokens[0].tolist()}")
            if not good:
                failures.append(f"{arch}: generate")
            check_generate(f"{arch} ARMT generate B=1", gres, eres, ng, ne,
                           graph_tok_s=gres.tok_s, eager_tok_s=eres.tok_s,
                           graph_ttft_s=gres.ttft_s, eager_ttft_s=eres.ttft_s)
            row.update(generate_ttft_s=gres.ttft_s, generate_tok_s=gres.tok_s,
                       generate_eager_tok_s=eres.tok_s)
            if ng["decode_attention"] == 0 or ng["flash_attention"] == 0:
                failures.append(f"{arch}: generate launched no decode or flash attention")
            del gres, eres, eng_e

            if arch in ("h2o-danube-1.8b", "chatglm3-6b"):
                # cache mode over 6,144 tokens: past h2o-danube's 4,096-key
                # window, so it binds in flash (the prompt) and in decode
                P = 6144
                ceng = ServeEngine(params, cfg, serve_mode="cache", max_len=P + 64)
                ceng_e = ServeEngine(params, cfg, serve_mode="cache", max_len=P + 64,
                                     eager=True)
                cprompt = rng.integers(0, cfg.vocab, (1, P))
                cres, nc, rc = counted(lambda: ceng.generate(cprompt, 16, keep=True))
                add(nc, rc)
                ceres, nce, _ = counted(lambda: ceng_e.generate(cprompt, 16, keep=True))
                log(f"  cache-mode generate B=1, prompt {P}, 16 new: TTFT {cres.ttft_s:.3f} s, "
                    f"{cres.tok_s:.1f} tok/s; eager {ceres.tok_s:.1f} tok/s; finite "
                    f"{cres.finite}; launches {nc}")
                if not cres.finite:
                    failures.append(f"{arch}: cache-mode generate not finite")
                check_generate(f"{arch} cache-mode generate B=1 at {P} tokens", cres, ceres,
                               nc, nce, graph_tok_s=cres.tok_s, eager_tok_s=ceres.tok_s)
                row.update(cache_generate_ttft_s=cres.ttft_s, cache_generate_tok_s=cres.tok_s)
                del ceng, ceng_e, cres, ceres
                sreq = [Request(0, rng.integers(0, cfg.vocab, seg + 500), 16),
                        Request(1, rng.integers(0, cfg.vocab, 2 * seg + 1000), 16)]
                eng.program(4, "serve").prepare()   # the capture, outside the timed run
                (evs, t_srv), nsv, rsv = counted(lambda: serve_run(eng, sreq))
                add(nsv, rsv)
                n_tok = sum(1 for e in evs if not isinstance(e, RequestError))
                good = n_tok == 32
                for r in sreq:
                    mine = [e for e in evs if not isinstance(e, RequestError)
                            and e.req_id == r.req_id]
                    first = int(eng.generate(r.prompt[None], 1).tokens[0, 0])
                    good = good and (len(mine) == r.max_new and mine[-1].done
                                     and bool(mine[-1].finite) and mine[0].token == first)
                log(f"  serve, 2 requests ({', '.join(str(len(r.prompt)) for r in sreq)} "
                    f"tokens, 16 new each) on 4 slots: {n_tok} tokens in {t_srv:.3f} s, "
                    f"{n_tok / t_srv:.1f} tok/s; every request complete, finite, first token "
                    f"= B=1 generate's -> {'ok' if good else 'FAIL'}; launches {nsv}")
                if not good:
                    failures.append(f"{arch}: serve")
                row.update(serve_tok_s=n_tok / t_srv)
                if nsv["decode_attention"] == 0:
                    failures.append(f"{arch}: serve launched no decode attention")
                del evs
            row.update(peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                       phase_s=time.perf_counter() - t_phase)
            log(f"  peak {row['peak_gb']:.2f} GB; {row['phase_s']:.1f} s")
            out[arch] = row
            del eng, params, attn
            M.SegmentProgram._cache.clear()
            torch.cuda.empty_cache()
        log(f"  launches over the phase: {launches}; GEMM and flash launches by route {routes}")
        for k in routed:
            if routes[k]["simt"] or not routes[k]["wgmma"]:
                failures.append(f"(r)'s {k} left the TMA + wgmma route: {routes[k]}")
        for name in llama_kernels:
            if launches[name] == 0 and name != "armt_update":   # B > 1 only
                failures.append(f"{name} never launched by (r)")
        return launches, routes, out

    launches_dense, routes_dense, dense = dense_config_phase()
    print(json.dumps({"dense_configs": dense, "card": smi}))

    # ------------------------------------------------------------ (s) MoE configs
    def moe_config_phase():
        """(s) the two MoE ARMT configs, one at a time, in bf16, random weights
        drawn on the card from the seed (qwen's QKV biases normal x 0.02):
        qwen2-moe-a2.7b at full width and depth, kimi-k2-1t-a32b at full
        width with 1 prelude and 3 MoE layers of 61 and 128 of its 384
        experts (the whole model would not fit the card). Returns (launches
        and routes summed over the phase's prefill, generate and serve runs,
        the per-config results)."""
        from repro_torch.models import moe as moe_mod
        from repro_torch.models.layers import swiglu
        from repro_torch.serve.state_store import tree_nbytes
        log("== (s) MoE configs: qwen2-moe-a2.7b full, kimi-k2-1t-a32b at 1 + 3 layers and "
            "128 experts; bf16, weights drawn on the card")
        M.SegmentProgram._cache.clear()
        torch.cuda.empty_cache()
        plan = [("qwen2-moe-a2.7b", None), ("kimi-k2-1t-a32b", (4, 128))]
        launches, routes, out = {}, {}, {}

        def add(n, r):
            nonlocal launches, routes
            launches, routes = merged(launches, n), merged(routes, r)
            return n, r

        # every routing decision of an eager run, recorded around the one
        # function both the plain and the fused paths route through
        real_route = moe_mod.route
        records = []
        recording = [False]

        def recording_route(*a, **k):
            r = real_route(*a, **k)
            if recording[0]:
                records.append((r.eidx.clone(), r.keep.clone()))
            return r

        def routed_run(fn):
            records.clear()
            recording[0] = True
            try:
                res = fn()
                sync()
            finally:
                recording[0] = False
            return res, list(records)

        def routing_code(rec, E):
            """[Q, N, E] per token and expert: 0 not chosen, 1 chosen and
            dropped at the capacity, 2 chosen and kept."""
            eidx, keep = rec
            return torch.zeros(eidx.shape[:2] + (E,), dtype=torch.int8, device=dev).scatter_(
                2, eidx, (1 + keep).to(torch.int8))

        moe_mod.route = recording_route
        try:
            for arch, cut in plan:
                t_phase = time.perf_counter()
                torch.cuda.reset_peak_memory_stats(dev)
                cfg = get_config(arch)
                full_depth, full_e = cfg.n_layers, cfg.moe.n_experts
                if cut is not None:
                    cfg = replace(cfg, n_layers=cut[0], moe=replace(cfg.moe, n_experts=cut[1]))
                mc = cfg.moe
                g = torch.Generator(device=dev).manual_seed(SEED)
                params = M.init_params(cfg, g, device=dev)
                attn = params["pattern"][0]["attn"]
                for b in ("bq", "bk", "bv"):
                    if b in attn:
                        attn[b].copy_(torch.randn(attn[b].shape, generator=g, device=dev) * 0.02)
                sync()
                row = dict(depth=cfg.n_layers, full_depth=full_depth, experts=mc.n_experts,
                           full_experts=full_e, weights_gb=tree_nbytes(params) / 1e9,
                           init_s=time.perf_counter() - t_phase)
                log(f"-- {arch}: {cfg.n_layers} of {full_depth} layers (prelude "
                    f"{cfg.prelude}), {mc.n_experts} of {full_e} experts (top {mc.top_k}, "
                    f"{mc.d_expert} wide, shared {mc.d_shared}), {row['weights_gb']:.2f} GB of "
                    f"bf16 weights, made on the card in {row['init_s']:.2f} s; hd "
                    f"{cfg.head_dim}, {cfg.n_heads}/{cfg.n_kv_heads} heads, qkv_bias "
                    f"{cfg.qkv_bias}; router {params['pattern'][0]['moe']['router'].dtype}")
                seg = cfg.armt.segment_len
                E = mc.n_experts

                def fwd(tokens, p=params, c=cfg, **kw):
                    with torch.no_grad():
                        h, f = M.forward_hidden(p, c, tokens, **kw)
                        return h, f, seg_logits(p, c, h)

                # (s1) diagonal = sequential on the fused cells, B = 1 and 2
                for B in (1, 2):
                    tk = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 4 * seg))).to(dev)
                    (hd_, fd_, ld_), nd, rd = counted(lambda: fwd(tk, schedule="diagonal"))
                    add(nd, rd)
                    (hs_, fs_, ls_), ns, rs = counted(lambda: fwd(tk, schedule="sequential"))
                    add(ns, rs)
                    exact = {"hidden": same_bits(hd_, hs_), "logits": same_bits(ld_, ls_)}
                    for part in ("prelude", "pattern"):
                        for j, (a, b) in enumerate(zip(fd_[part], fs_[part])):
                            for k in ("A", "z"):
                                exact[f"{part}{j}.{k}"] = same_bits(a[k], b[k])
                    ok = all(exact.values())
                    row[f"diagonal_equals_sequential_B{B}"] = exact
                    log(f"  4-segment prefill B={B}, diagonal vs sequential (captured "
                        f"segments), both on the fused cells: to the bit {exact} -> "
                        f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        failures.append(f"{arch}: diagonal vs sequential B={B} not bitwise")
                    if B == 1:
                        tk1 = tk
                    del hd_, fd_, ld_, hs_, fs_, ls_
                for label, n_seg in (("prefill_diagonal_s", 4), ("prefill_diagonal_16_s", 16)):
                    tkn = torch.from_numpy(rng.integers(0, cfg.vocab, (1, n_seg * seg))).to(dev)
                    fwd(tkn, schedule="diagonal")
                    sync()
                    t0 = time.perf_counter()
                    fwd(tkn, schedule="diagonal")
                    sync()
                    row[label] = time.perf_counter() - t0
                t0 = time.perf_counter()
                fwd(tk1, schedule="sequential")
                sync()
                row["prefill_sequential_s"] = time.perf_counter() - t0
                log(f"  warm diagonal prefill B=1: 4 segments {row['prefill_diagonal_s']:.4f} s, "
                    f"16 segments {row['prefill_diagonal_16_s']:.4f} s; sequential (captured) "
                    f"4 segments {row['prefill_sequential_s']:.4f} s; card {smi}")

                # (s2) the fused path against the plain path. Routing is
                # discontinuous: a last-bit difference before the router can
                # flip a token's top-k set or its capacity drop. At the first
                # MoE layer (the model cut after it), each of 2 segments from
                # the fused path's state: the tokens whose routing agrees are
                # held within 5e-2 (row relative), the others counted; the
                # new A and z (rel err) within 5e-2 too: the prelude's always,
                # the MoE layer's where none of the M memory rows its update
                # reads was routed differently; at full depth the flips per
                # layer are reported
                n1 = len(cfg.prelude) + 1
                cfg1 = replace(cfg, n_layers=n1)
                M_ = cfg.armt.num_mem_tokens
                def first_layer(tree):
                    if isinstance(tree, dict):
                        return {k: first_layer(v) for k, v in tree.items()}
                    return tree[:1]
                p1 = dict(params, pattern=(first_layer(params["pattern"][0]),))
                state, first = None, dict(flipped=[], tokens=[], worst_agreeing=[],
                                          memory_rows_flipped=[], state_rel_err=[])
                held_state = []
                for s in range(2):
                    ts = tk1[:, s * seg:(s + 1) * seg]
                    (hf, ff, _), rf = routed_run(lambda: fwd(ts, p1, cfg1, schedule="sequential",
                                                              eager=True, state0=state))
                    (hp, fp_, _), rp = routed_run(lambda: fwd(ts, p1, cfg1, schedule="sequential",
                                                              fused=False, state0=state))
                    differ = (routing_code(rf[-1], E) != routing_code(rp[-1], E)).any(-1)[0]
                    agree = ~differ[:seg]
                    first["flipped"].append(int(differ.sum()))
                    first["tokens"].append(int(differ.numel()))
                    first["worst_agreeing"].append(row_rel(hf[0, 0][agree], hp[0, 0][agree]))
                    n_mem = int(differ[seg:seg + M_].sum())
                    errs = {f"{part}{j}.{k}": rel_err(a[k], b[k])
                            for part in ("prelude", "pattern")
                            for j, (a, b) in enumerate(zip(ff[part], fp_[part])) for k in ("A", "z")}
                    first["memory_rows_flipped"].append(n_mem)
                    first["state_rel_err"].append(errs)
                    held_state += [e for k, e in errs.items()
                                   if k.startswith("prelude") or n_mem == 0]
                    state = ff
                    del hf, hp, fp_
                ok = max(first["worst_agreeing"]) <= 5e-2
                ok_state = all(e <= 5e-2 for e in held_state)
                first["state_errors_held"] = len(held_state)
                row["first_moe_layer"] = first
                log(f"  first MoE layer (layer {n1 - 1}), fused vs plain, 2 segments each from "
                    f"the fused state: tokens routed differently (top-k set or keep) "
                    f"{first['flipped']} of {first['tokens']} (memory rows included); worst "
                    f"row rel err of the agreeing tokens "
                    f"{' '.join(f'{e:.2e}' for e in first['worst_agreeing'])} (tol 5e-2) -> "
                    f"{'ok' if ok else 'FAIL'}")
                log(f"  the new A and z, fused vs plain: memory rows routed differently "
                    f"{first['memory_rows_flipped']} of {M_}; rel err per segment "
                    f"{[{k: f'{e:.2e}' for k, e in d.items()} for d in first['state_rel_err']]}; "
                    f"{len(held_state)} held (the prelude's, and the MoE layer's where no memory "
                    f"row flipped; tol 5e-2) -> {'ok' if ok_state else 'FAIL'}")
                if not ok:
                    failures.append(f"{arch}: first MoE layer, agreeing tokens vs plain")
                if not ok_state:
                    failures.append(f"{arch}: first MoE layer, A and z vs plain")
                tk2 = tk1[:, :2 * seg]
                (hf, _, lf), rf = routed_run(lambda: fwd(tk2, schedule="sequential", eager=True))
                (hp, _, lp), rp = routed_run(lambda: fwd(tk2, schedule="sequential",
                                                         fused=False))
                n_moe = cfg.n_layers - len(cfg.prelude)
                flips = [[int((routing_code(a, E) != routing_code(b, E)).any(-1).sum())
                          for a, b in zip(rf[s * n_moe:(s + 1) * n_moe],
                                          rp[s * n_moe:(s + 1) * n_moe])] for s in range(2)]
                ever = torch.zeros(hf.shape[2], dtype=torch.bool, device=dev)
                for a, b in zip(rf[:n_moe], rp[:n_moe]):
                    ever |= (routing_code(a, E) != routing_code(b, E)).any(-1)[0, :seg]
                never = ~ever
                full = dict(flipped_per_layer=flips,
                            segment1_tokens_never_flipped=int(never.sum()),
                            segment1_hidden_rel_err_never_flipped=row_rel(
                                hf[0, 0][never], hp[0, 0][never]) if never.any() else None,
                            logits_rel_err=[rel_err(lf[i], lp[i]) for i in range(2)])
                row["full_depth_routing"] = full
                log(f"  full depth, fused vs plain, 2 segments (informational): tokens routed "
                    f"differently per MoE layer {flips}; segment 1's tokens never flipped "
                    f"{full['segment1_tokens_never_flipped']} of {seg}, their worst row rel "
                    f"err {full['segment1_hidden_rel_err_never_flipped']}; last-token logits "
                    f"rel err {' '.join(f'{e:.2e}' for e in full['logits_rel_err'])}")
                del hf, hp, lf, lp, rf, rp

                # (s3) generate, captured against eager, ARMT and cache mode
                eng, eng_e = ServeEngine(params, cfg), ServeEngine(params, cfg, eager=True)
                prompt = rng.integers(0, cfg.vocab, (1, 2 * seg + 1020))   # flushes at token 4
                gres, ng, rg = counted(lambda: eng.generate(prompt, 16, keep=True))
                add(ng, rg)
                eres, ne, _ = counted(lambda: eng_e.generate(prompt, 16, keep=True))
                good = (gres.finite and gres.tokens.shape == (1, 16)
                        and 0 <= gres.tokens.min() and gres.tokens.max() < cfg.vocab)
                log(f"  generate B=1, prompt {prompt.shape[1]}, 16 new: TTFT {gres.ttft_s:.3f} s, "
                    f"{gres.tok_s:.1f} tok/s (capture {gres.capture_s:.3f} s); eager TTFT "
                    f"{eres.ttft_s:.3f} s, {eres.tok_s:.1f} tok/s; finite {gres.finite} -> "
                    f"{'ok' if good else 'FAIL'}; launches {ng}; card {smi}")
                if not good:
                    failures.append(f"{arch}: generate")
                check_generate(f"{arch} ARMT generate B=1", gres, eres, ng, ne,
                               graph_tok_s=gres.tok_s, eager_tok_s=eres.tok_s,
                               graph_ttft_s=gres.ttft_s, eager_ttft_s=eres.ttft_s)
                row.update(generate_ttft_s=gres.ttft_s, generate_tok_s=gres.tok_s,
                           generate_eager_tok_s=eres.tok_s)
                del gres, eres, eng_e
                P = 2048
                ceng = ServeEngine(params, cfg, serve_mode="cache", max_len=P + 64)
                ceng_e = ServeEngine(params, cfg, serve_mode="cache", max_len=P + 64,
                                     eager=True)
                cprompt = rng.integers(0, cfg.vocab, (1, P))
                cres, nc, rc = counted(lambda: ceng.generate(cprompt, 16, keep=True))
                add(nc, rc)
                ceres, nce, _ = counted(lambda: ceng_e.generate(cprompt, 16, keep=True))
                log(f"  cache-mode generate B=1, prompt {P}, 16 new: TTFT {cres.ttft_s:.3f} s, "
                    f"{cres.tok_s:.1f} tok/s; eager {ceres.tok_s:.1f} tok/s; finite "
                    f"{cres.finite}; launches {nc}")
                if not cres.finite:
                    failures.append(f"{arch}: cache-mode generate not finite")
                check_generate(f"{arch} cache-mode generate B=1 at {P} tokens", cres, ceres,
                               nc, nce, graph_tok_s=cres.tok_s, eager_tok_s=ceres.tok_s)
                row.update(cache_generate_ttft_s=cres.ttft_s, cache_generate_tok_s=cres.tok_s)
                del ceng, ceng_e, cres, ceres

                # (s4) serve on 4 slots: blocking against interleaved (k = 4)
                sreq = [Request(i, rng.integers(0, cfg.vocab, n), 12)
                        for i, n in enumerate([seg + 500, 2 * seg + 1000, 600, seg])]
                eng.program(4, "serve").prepare()   # the capture, outside the timed runs
                srv = {}
                for label, k in (("blocking", 0), ("k=4", 4)):
                    (evs, t_srv), nsv, rsv = counted(lambda: serve_run(
                        eng, sreq, prefill_groups_per_chunk=k))
                    add(nsv, rsv)
                    n_tok = sum(1 for e in evs if not isinstance(e, RequestError))
                    srv[label] = (by_req(evs), n_tok / t_srv, n_tok)
                same = srv["blocking"][0] == srv["k=4"][0]
                good = same and srv["blocking"][2] == 48 and all(
                    v[-1][2] and bool(v[-1][3]) for v in srv["blocking"][0].values())
                log(f"  serve, 4 requests ({', '.join(str(len(r.prompt)) for r in sreq)} tokens, "
                    f"12 new each) on 4 slots: blocking {srv['blocking'][1]:.1f} tok/s, k=4 "
                    f"{srv['k=4'][1]:.1f} tok/s; every request's tokens equal "
                    f"{same}, complete and finite -> {'ok' if good else 'FAIL'}")
                if not good:
                    failures.append(f"{arch}: serve blocking vs interleaved")
                row.update(serve_blocking_tok_s=srv["blocking"][1], serve_k4_tok_s=srv["k=4"][1],
                           serve_tokens_equal=same)
                del srv, evs

                # the byte estimate of an admission against its measured peak
                n_est = 16 if cut is None else 4
                est = eng.prefill_activation_bytes(n_est, stream=False)
                long_prompt = rng.integers(0, cfg.vocab, n_est * seg + 100)
                with torch.no_grad():
                    torch.cuda.empty_cache()
                    sync()
                    base = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    pipe = eng.start_prefill(long_prompt[None], groups_per_call=4)
                    while not pipe.advance():
                        pass
                    sync()
                    peak = torch.cuda.max_memory_allocated() - base
                    del pipe
                ok = peak <= est
                row.update(admission_peak_bytes=peak, admission_estimate_bytes=est)
                log(f"  a {n_est}-segment admission's peak above its start {peak / 1e6:.1f} MB, "
                    f"prefill_activation_bytes({n_est}) {est / 1e6:.1f} MB -> "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(f"{arch}: admission peak above prefill_activation_bytes")
                del eng

                # (s5) the MoE layer alone at the band's shape: every pattern
                # layer, B = 1, T = seg + M, on the model's weights
                pm = params["pattern"][0]["moe"]
                Gb, T_ = cfg.n_layers - len(cfg.prelude), seg + cfg.armt.num_mem_tokens
                D, F = cfg.d_model, mc.d_expert
                C = moe_mod.capacity(T_, mc)
                xs = rnd(Gb, 1, T_, D)
                buf = rnd(Gb * E, C, D)
                wg = pm["wg"].reshape(-1, D, F)
                sl = E      # the held slice: one layer's experts
                want = torch.bmm(buf[:sl].float(), wg[:sl].float())
                gerr = check(f"{arch} expert gate GEMM [{Gb}*{E},{C},{D}]x[{D},{F}] silu "
                             f"(first {sl} groups) vs fp32 torch.bmm",
                             grouped_matmul.grouped_matmul(buf[:sl], wg[:sl], activation="silu"),
                             want * torch.sigmoid(want), TOL_BF16)
                del want
                gt = dict(ms=time_ms(lambda: grouped_matmul.grouped_matmul(
                              buf, wg, activation="silu")),
                          library_ms=time_ms(lambda: torch.bmm(buf, wg)),
                          # the plain version's fp32 copy of kimi's experts would not fit
                          plain_ms=time_ms(lambda: grouped_matmul.grouped_matmul_plain(
                              buf, wg, activation="silu"), iters=3)
                          if arch == "qwen2-moe-a2.7b" else None)
                gt["bound_ms"], gt["bound_by"] = bound(
                    flops_bf16=2.0 * Gb * E * C * D * F,
                    nbytes=2.0 * Gb * E * (C * D + D * F + C * F))
                log(f"  {arch} expert gate GEMM [{Gb}*{E},{C},{D}]x[{D},{F}] silu: kernel "
                    f"{gt['ms']:.4f} ms  plain {gt['plain_ms']} ms  library {gt['library_ms']:.4f}"
                    f" ms (torch.bmm, no silu)  bound {gt['bound_ms']:.4f} ms ({gt['bound_by']})"
                    f"  kernel/bound {gt['ms'] / gt['bound_ms']:.2f}; card {smi}")
                row["expert_gemm"] = dict(gt, max_abs_err=gerr,
                                          route=grouped_matmul.route(buf, wg, buf),
                                          shape=f"[{Gb}*{E},{C},{D}]@[{D},{F}]")
                del buf

                def plain32(x4):
                    """The plain MoE in fp32 on the bf16 input's values (so the
                    same routing), a layer and an expert at a time."""
                    ys = []
                    for gi in range(Gb):
                        def experts(b, gi=gi):
                            o = torch.empty_like(b)
                            for e in range(E):
                                be = b[:, e]
                                gg = be @ pm["wg"][gi, e].float()
                                uu = be @ pm["wu"][gi, e].float()
                                o[:, e] = ((torch.nn.functional.silu(gg) * uu)
                                           @ pm["wd"][gi, e].float())
                            return o
                        xg = x4[gi].float().reshape(1, -1, D)
                        y = moe_mod.moe_tokens(xg, pm["router"][gi][None], mc, experts)
                        if "shared" in pm:
                            y = y + swiglu(xg, {k: v[gi].float()
                                                        for k, v in pm["shared"].items()})
                        ys.append(y.reshape(x4.shape[1:]))
                    return torch.stack(ys)

                def plain_bf16(x4):
                    return torch.stack([moe_mod.moe_ffn(
                        x4[gi], {k: (v[gi] if not isinstance(v, dict) else
                                     {kk: vv[gi] for kk, vv in v.items()})
                                 for k, v in pm.items()}, mc) for gi in range(Gb)])
                got = moe_mod.moe_ffn_grouped(xs, pm, mc)
                merr = check(f"{arch} moe_ffn band [{Gb},1,{T_},{D}] (C {C}) vs its plain "
                             "version in fp32", got, plain32(xs), TOL_BF16)
                mt = dict(ms=time_ms(lambda: moe_mod.moe_ffn_grouped(xs, pm, mc), iters=5),
                          plain_ms=time_ms(lambda: plain_bf16(xs), iters=3))
                log(f"  {arch} moe_ffn band: fused {mt['ms']:.3f} ms, plain (bf16 torch "
                    f"matmuls) {mt['plain_ms']:.3f} ms; card {smi}")
                row["moe_ffn_band"] = dict(mt, max_abs_err=merr, capacity=C)
                del xs, got, pm, wg

                row.update(peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                           phase_s=time.perf_counter() - t_phase)
                log(f"  peak {row['peak_gb']:.2f} GB; {row['phase_s']:.1f} s")
                out[arch] = row
                del params, attn, p1
                M.SegmentProgram._cache.clear()
                torch.cuda.empty_cache()
        finally:
            moe_mod.route = real_route
        log(f"  launches over the phase: {launches}; GEMM and flash launches by route {routes}")
        for k in routed:
            if routes[k]["simt"] or not routes[k]["wgmma"]:
                failures.append(f"(s)'s {k} left the TMA + wgmma route: {routes[k]}")
        for name in llama_kernels:
            if launches[name] == 0:
                failures.append(f"{name} never launched by (s)")
        return launches, routes, out

    launches_moe, routes_moe, moe_rows = moe_config_phase()
    print(json.dumps({"moe_configs": moe_rows, "card": smi}))

    # ------------------------------------------------------------ (t) cell_block, jamba
    def jamba_phase():
        """(t4) the blockwise cell FFN on llama-1b-armt at full width and
        depth, then (t1)-(t3) jamba-1.5-large-398b at full width with 2 of
        its 9 superblocks and 4 of its 16 experts (the whole model, 398 B
        parameters, fits no card), bf16, weights drawn on the card from the
        seed; (t5) the expert gate GEMM at the band's shape. Returns
        (launches and routes summed over the phase's runs, the results)."""
        from repro_torch.core.sequential import layer_slice
        from repro_torch.models import moe as moe_mod
        from repro_torch.models.blocks import make_apply_block
        from repro_torch.models.grouped_blocks import make_grouped_apply
        from repro_torch.serve import PrefixCache
        from repro_torch.serve.state_store import tree_nbytes
        t_phase = time.perf_counter()
        M.SegmentProgram._cache.clear()
        torch.cuda.empty_cache()
        launches, routes, out = {}, {}, {}

        def add(n, r):
            nonlocal launches, routes
            launches, routes = merged(launches, n), merged(routes, r)
            return n, r

        def fwd(p, c, tk, **kw):
            with torch.no_grad():
                res = M.forward_hidden(p, c, tk, **kw)
                return res[0], res[1:], M.boundary_logits(p, c, res[0])

        def states_equal(a, b):
            return {f"{part}{j}.{k}": same_bits(x[k], y[k])
                    for part in ("prelude", "pattern")
                    for j, (x, y) in enumerate(zip(a[part], b[part])) for k in x}

        def admission_peak(eng, n_seg, seg):
            """An admission of n_seg whole segments + 100 tokens through the
            resumable pipeline (4 band steps a call): its peak memory above
            its start, and prefill_activation_bytes(n_seg)."""
            est = eng.prefill_activation_bytes(n_seg, stream=False)
            prompt = rng.integers(0, eng.cfg.vocab, n_seg * seg + 100)
            with torch.no_grad():
                torch.cuda.empty_cache()
                sync()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                pipe = eng.start_prefill(prompt[None], groups_per_call=4)
                while not pipe.advance():
                    pass
                sync()
                peak = torch.cuda.max_memory_allocated() - base
                del pipe
            return peak, est

        # (t4) cell_block on llama-1b-armt: 16 segments, B = 1, the main path
        log("== (t4) cell_block 256 on llama-1b-armt, full width and depth, bf16, weights "
            "drawn on the card")
        lcfg = get_config("llama-1b-armt")
        bcfg = replace(lcfg, cell_block=256)
        lp = M.init_params(lcfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
        lseg = lcfg.armt.segment_len
        ltk = torch.from_numpy(rng.integers(0, lcfg.vocab, (1, 16 * lseg))).to(dev)
        (h0, _, _), n0, _ = counted(lambda: fwd(lp, lcfg, ltk))
        (hb, (fb,), lb), nb, rb = counted(lambda: fwd(lp, bcfg, ltk))
        add(nb, rb)
        (hbs, (fbs,), lbs), nbs, rbs = counted(lambda: fwd(lp, bcfg, ltk,
                                                          schedule="sequential"))
        add(nbs, rbs)
        exact = dict(hidden=same_bits(hb, hbs), logits=same_bits(lb, lbs),
                     **states_equal(fb, fbs))
        same_0 = same_bits(hb, h0)
        errs = [rel_err(hb[s], h0[s]) for s in range(16)]
        worst_rows = [row_rel(hb[s], h0[s]) for s in range(16)]
        swapped = (n0["grouped_matmul_armt_update"] > 0 and n0["armt_update"] == 0
                   and nb["grouped_matmul_armt_update"] == 0 and nb["armt_update"] > 0)
        peaks = {}
        for label, c in (("cell_block 0", lcfg), ("cell_block 256", bcfg)):
            peaks[label] = admission_peak(ServeEngine(lp, c), 16, lseg)
        (p0, e0), (pb, eb) = peaks["cell_block 0"], peaks["cell_block 256"]
        ok_exact, ok_close = all(exact.values()), max(errs[:2]) <= 1e-2
        ok_peak = pb < p0 and pb <= eb and p0 <= e0
        log(f"  16 segments B=1 at cell_block 256, diagonal vs sequential (captured "
            f"segments): to the bit {ok_exact} -> {'ok' if ok_exact else 'FAIL'}")
        log(f"  hidden vs cell_block 0: to the bit {same_0}; rel err per segment "
            f"{' '.join(f'{e:.2e}' for e in errs)}, gated on the first 2 (tol 1e-2; the "
            f"random-weight model is chaotic past a few segments) -> "
            f"{'ok' if ok_close else 'FAIL'}; worst row rel err per segment "
            f"{' '.join(f'{e:.2e}' for e in worst_rows)}")
        log(f"  launches cell_block 0: fused update {n0['grouped_matmul_armt_update']}, "
            f"armt_update {n0['armt_update']}, GEMM {n0['grouped_matmul']}; cell_block 256: "
            f"fused update {nb['grouped_matmul_armt_update']}, armt_update "
            f"{nb['armt_update']}, GEMM {nb['grouped_matmul']} -> "
            f"{'ok' if swapped else 'FAIL'}")
        log(f"  a 16-segment admission's peak above its start: cell_block 0 {p0 / 1e6:.1f} MB "
            f"(estimate {e0 / 1e6:.1f}), 256 {pb / 1e6:.1f} MB (estimate {eb / 1e6:.1f}) -> "
            f"{'ok' if ok_peak else 'FAIL'}")
        for ok, what in ((ok_exact, "diagonal vs sequential"), (ok_close, "vs cell_block 0"),
                         (swapped, "armt_update in place of the fused update"),
                         (ok_peak, "peak lower than unblocked and within its estimate")):
            if not ok:
                failures.append(f"(t4) cell_block 256: {what}")
        out["cell_block"] = dict(diagonal_equals_sequential=exact, equals_0_bitwise=same_0,
                                 rel_err_vs_0=errs,
                                 worst_row_rel_err_vs_0=worst_rows,
                                 launches_0=n0, launches_256=nb,
                                 peak_bytes={k: v[0] for k, v in peaks.items()},
                                 estimate_bytes={k: v[1] for k, v in peaks.items()})
        del lp, h0, hb, fb, lb, hbs, fbs, lbs
        M.SegmentProgram._cache.clear()
        torch.cuda.empty_cache()

        # jamba-1.5-large-398b cut to 2 of its 9 superblocks (16 of 72
        # layers) and 4 of its 16 experts, by init_params' own leaves: an
        # attn layer 1.646 GB, a mamba layer with its FFN 2.049 GB, a
        # mamba_moe layer 5.673 GB (4 experts of 1.208 GB), embedding, head
        # and memory tokens 2.150 GB: 63.12 GB, of 798.4 GB for the whole
        # model in bf16 (the phase prints them)
        full = get_config("jamba-1.5-large-398b")
        n_super, n_exp = 2, 4
        cfg = replace(full, n_layers=n_super * len(full.block_pattern),
                      moe=replace(full.moe, n_experts=n_exp))
        log(f"== (t) jamba-1.5-large-398b: {cfg.n_layers} of {full.n_layers} layers ({n_super} "
            f"of {full.n_superblocks} superblocks of {full.block_pattern}), {n_exp} of "
            f"{full.moe.n_experts} experts (top {full.moe.top_k}); d_model {cfg.d_model}, "
            f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, no rotary, FFN and "
            f"experts {cfg.d_ff}, d_inner {cfg.ssm.expand * cfg.d_model}, vocab {cfg.vocab}; "
            "bf16")
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
        sync()
        init_s = time.perf_counter() - t0
        layer_bytes = {t: tree_nbytes(layer_slice(params["pattern"][cfg.block_pattern.index(t)],
                                                  0))
                       for t in ("attn", "mamba", "mamba_moe")}
        expert = tree_nbytes({k: v[0, 0] for k, v in params["pattern"][1]["moe"].items()
                              if k != "router"})
        outer = sum(tree_nbytes(params[k]) for k in ("embed", "head", "final_norm",
                                                      "mem_tokens"))
        weights = tree_nbytes(params)
        n_t = {t: full.block_pattern.count(t) * full.n_superblocks
               for t in ("attn", "mamba", "mamba_moe")}
        whole = outer + sum(n_t[t] * layer_bytes[t] for t in n_t) + n_t["mamba_moe"] * (
            full.moe.n_experts - n_exp) * expert
        row = dict(layers=cfg.n_layers, full_layers=full.n_layers, experts=n_exp,
                   full_experts=full.moe.n_experts, weights_bytes=weights,
                   layer_bytes=layer_bytes, expert_bytes=expert, embed_head_bytes=outer,
                   whole_model_bytes=whole, init_s=init_s)
        log(f"  weights {weights / 1e9:.2f} GB (init_params' own leaves), drawn on the card in "
            f"{init_s:.2f} s: an attn layer {layer_bytes['attn'] / 1e9:.3f} GB, a mamba layer "
            f"(with its FFN) {layer_bytes['mamba'] / 1e9:.3f} GB, a mamba_moe layer "
            f"{layer_bytes['mamba_moe'] / 1e9:.3f} GB ({n_exp} experts of "
            f"{expert / 1e9:.3f} GB), embedding, head and memory tokens {outer / 1e9:.3f} GB; "
            f"the whole model would be {whole / 1e9:.1f} GB (cuts: depth 72 -> 16, experts "
            f"16 -> 4)")
        seg = cfg.armt.segment_len

        # (t1) diagonal = sequential, B = 1 and 2, 4 and 16 segments; the
        # boundary states of both captures at 16 segments, B = 1
        for B in (1, 2):
            for n_seg in (4, 16):
                tk = torch.from_numpy(rng.integers(0, cfg.vocab, (B, n_seg * seg))).to(dev)
                cap = B == 1 and n_seg == 16
                (hd_, rest_d, ld_), nd, rd = counted(lambda: fwd(params, cfg, tk,
                                                                 capture_states=cap))
                add(nd, rd)
                (hs_, rest_s, ls_), ns, rs = counted(lambda: fwd(params, cfg, tk,
                                                                 schedule="sequential",
                                                                 capture_states=cap))
                add(ns, rs)
                exact = dict(hidden=same_bits(hd_, hs_), logits=same_bits(ld_, ls_),
                             **states_equal(rest_d[0], rest_s[0]))
                if cap:
                    exact["boundaries"] = all(states_equal(rest_d[1], rest_s[1]).values())
                ok = all(exact.values())
                row[f"diagonal_equals_sequential_B{B}_S{n_seg}"] = ok
                log(f"  {n_seg}-segment prefill B={B}, diagonal (strided bands) vs sequential "
                    f"(captured segments){', and the boundary captures' if cap else ''}: to "
                    f"the bit {ok} ({sum(exact.values())} of {len(exact)} tensors) -> "
                    f"{'ok' if ok else 'FAIL'}; launches {nd}")
                if not ok:
                    failures.append(f"jamba: diagonal vs sequential B={B} S={n_seg}: "
                                    f"{[k for k, v in exact.items() if not v]}")
                if B == 1 and n_seg == 4:
                    tk1 = tk
                del hd_, rest_d, ld_, hs_, rest_s, ls_
            M.SegmentProgram._cache.clear()     # its graphs' pools: one shape at a time
            torch.cuda.empty_cache()
        times = {}
        for n_seg in (4, 16):
            tkn = torch.from_numpy(rng.integers(0, cfg.vocab, (1, n_seg * seg))).to(dev)
            for schedule in ("diagonal", "sequential"):
                fwd(params, cfg, tkn, schedule=schedule)
                ts = []
                for _ in range(3):
                    sync()
                    t0 = time.perf_counter()
                    fwd(params, cfg, tkn, schedule=schedule)
                    sync()
                    ts.append(time.perf_counter() - t0)
                times[f"{schedule}_{n_seg}"] = float(np.median(ts))
        row["prefill_s"] = times
        M.SegmentProgram._cache.clear()
        torch.cuda.empty_cache()
        log(f"  warm prefill B=1, median of 3: 4 segments diagonal {times['diagonal_4']:.4f} s, "
            f"sequential {times['sequential_4']:.4f} s; 16 segments diagonal "
            f"{times['diagonal_16']:.4f} s, sequential {times['sequential_16']:.4f} s; "
            f"card {smi}")

        # (t2) the fused mamba cells against the plain block, segment 0, at
        # the band of both superblocks' layers of a position (G = 2, a
        # strided view of a slot buffer), each group from the plain path's
        # input to the position's first layer: the first mamba layer (layer
        # 2) within 5e-2 (row relative), with its h and conv tail; at the
        # first MoE layer (layer 1) the tokens whose routing agrees held
        # within 5e-2, the others counted (routing is discontinuous)
        apply = make_apply_block(cfg)
        cell = make_grouped_apply(cfg)
        per_slot = diag._per_slot_apply(apply)
        real_route = moe_mod.route
        records = []

        def recording_route(*a, **k):
            r = real_route(*a, **k)
            records.append((r.eidx.clone(), r.keep.clone()))
            return r

        def routing_code(rec):
            eidx, keep = rec
            return torch.zeros(eidx.shape[:2] + (n_exp,), dtype=torch.int8,
                               device=dev).scatter_(2, eidx, (1 + keep).to(torch.int8))
        T_ = seg + cfg.armt.num_mem_tokens
        D_ = cfg.d_model
        n_pat = len(cfg.block_pattern)
        cells = {}
        with torch.no_grad():
            x0 = M.embed_segments(params, cfg, tk1[:, :seg], seg)[0]
            st1 = M.init_state(cfg, 1, dev)
            y, _ = apply("attn", layer_slice(params["pattern"][0], 0), x0,
                         layer_slice(st1["pattern"][0], 0))
            buf = torch.zeros(cfg.n_layers, 1, T_, D_, dtype=y.dtype, device=dev)
            moe_mod.route = recording_route
            try:
                for p in (1, 2):
                    t = cfg.block_pattern[p]
                    buf[p::n_pat] = y
                    xb = buf[p::n_pat]
                    records.clear()
                    got, gst = cell(t, params["pattern"][p], xb, st1["pattern"][p])
                    rec_f = list(records)
                    records.clear()
                    want, wst = per_slot(t, params["pattern"][p], xb, st1["pattern"][p])
                    rec_p = list(records)
                    res = dict(state_rel_err={k: [rel_err(gst[k][j], wst[k][j])
                                                  for j in range(2)] for k in gst})
                    if t == "mamba_moe":
                        differ = [(routing_code(rec_f[0])[j] != routing_code(rec_p[j])[0]
                                   ).any(-1) for j in range(2)]
                        res["flipped"] = [int(d.sum()) for d in differ]
                        res["worst_agreeing"] = [row_rel(got[j, 0][~d], want[j, 0][~d])
                                                 for j, d in enumerate(differ)]
                        ok = res["worst_agreeing"][0] <= 5e-2
                        log(f"  first MoE layer (layer 1) and layer 9, the fused mamba_moe "
                            f"cell at G=2 vs the plain block: tokens routed differently "
                            f"{res['flipped']} of {T_}; worst row rel err of the agreeing "
                            f"tokens {' '.join(f'{e:.2e}' for e in res['worst_agreeing'])} "
                            f"(layer 1 gated, tol 5e-2); h, conv rel err "
                            f"{res['state_rel_err']} -> {'ok' if ok else 'FAIL'}")
                    else:
                        res["worst_row_rel"] = [row_rel(got[j], want[j]) for j in range(2)]
                        ok = (res["worst_row_rel"][0] <= 5e-2
                              and max(e[0] for e in res["state_rel_err"].values()) <= 5e-2)
                        log(f"  first mamba layer (layer 2) and layer 10, the fused mamba cell "
                            f"(with its FFN) at G=2 vs the plain block: worst row rel err "
                            f"{' '.join(f'{e:.2e}' for e in res['worst_row_rel'])}; h, conv "
                            f"rel err {res['state_rel_err']} (layer 2 gated, tol 5e-2) -> "
                            f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        failures.append(f"jamba: fused {t} cell vs plain")
                    cells[t] = res
                    y = want[0]
                    del got, gst, want, wst
            finally:
                moe_mod.route = real_route
            # the MoE band alone: both MoE layers of position 1 at T = 1152
            pm = params["pattern"][1]["moe"]
            xs = rnd(2, 1, T_, D_)
            mt = dict(ms=time_ms(lambda: moe_mod.moe_ffn_grouped(xs, pm, cfg.moe), iters=5),
                      plain_ms=time_ms(lambda: torch.stack([moe_mod.moe_ffn(
                          xs[j], {k: v[j] for k, v in pm.items()}, cfg.moe) for j in range(2)]),
                          iters=3))
            log(f"  moe_ffn band [2,1,{T_},{D_}], {n_exp} experts of {cfg.moe.d_expert}: fused "
                f"{mt['ms']:.3f} ms, plain (bf16 torch matmuls) {mt['plain_ms']:.3f} ms; "
                f"card {smi}")
            cells["moe_ffn_band"] = mt
            # (t5) the expert gate GEMM at the band's shape on the model's
            # experts: [G*E, C, D] x [D, F] with silu, each expert of layer 1
            # held against fp32 torch.bmm on its own
            C = moe_mod.capacity(T_, cfg.moe)
            Fe = cfg.moe.d_expert
            wg = pm["wg"].reshape(-1, D_, Fe)
            xe = rnd(2 * n_exp, C, D_)
            got = grouped_matmul.grouped_matmul(xe, wg, activation="silu")
            gerr = 0.0
            for e in range(n_exp):
                w32 = torch.bmm(xe[e:e + 1].float(), wg[e:e + 1].float())
                gerr = max(gerr, check(f"jamba expert gate GEMM group {e} [{C},{D_}]x[{D_},"
                                       f"{Fe}] silu vs fp32 torch.bmm", got[e:e + 1],
                                       w32 * torch.sigmoid(w32), TOL_BF16))
                del w32
            del got
            gt = dict(ms=time_ms(lambda: grouped_matmul.grouped_matmul(xe, wg,
                                                                       activation="silu")),
                      library_ms=time_ms(lambda: torch.bmm(xe, wg)), plain_ms=None)
            gt["bound_ms"], gt["bound_by"] = bound(
                flops_bf16=2.0 * 2 * n_exp * C * D_ * Fe,
                nbytes=2.0 * 2 * n_exp * (C * D_ + D_ * Fe + C * Fe))
            gt.update(max_abs_err=gerr, route=grouped_matmul.route(xe, wg, xe),
                      shape=f"[2*{n_exp},{C},{D_}]@[{D_},{Fe}]")
            log(f"  expert gate GEMM [2*{n_exp},{C},{D_}]x[{D_},{Fe}] silu (route "
                f"{gt['route']}): kernel {gt['ms']:.4f} ms  library {gt['library_ms']:.4f} ms "
                f"(torch.bmm, no silu)  bound {gt['bound_ms']:.4f} ms ({gt['bound_by']})  "
                f"kernel/bound {gt['ms'] / gt['bound_ms']:.2f}  plain not measured (its fp32 "
                f"experts would not fit beside the weights); card {smi}")
            cells["expert_gemm"] = gt
            del xs, xe, wg, pm, buf, x0, y
        row["cells"] = cells
        torch.cuda.empty_cache()

        # (t3) serving: generate graph vs eager in both modes, serve blocking
        # vs interleaved, a prefix-cache hit vs the uncached run, the
        # admission's peak against its estimate at 4 and 16 segments
        eng, eng_e = ServeEngine(params, cfg), ServeEngine(params, cfg, eager=True)
        prompt = rng.integers(0, cfg.vocab, (1, 2 * seg + 1020))     # flushes at token 4
        gres, ng, rg = counted(lambda: eng.generate(prompt, 16, keep=True))
        add(ng, rg)
        eres, ne, _ = counted(lambda: eng_e.generate(prompt, 16, keep=True))
        good = (gres.finite and gres.tokens.shape == (1, 16)
                and 0 <= gres.tokens.min() and gres.tokens.max() < cfg.vocab)
        log(f"  generate B=1, prompt {prompt.shape[1]}, 16 new (a flush at token 4): TTFT "
            f"{gres.ttft_s:.3f} s, {gres.tok_s:.1f} tok/s (capture {gres.capture_s:.3f} s); "
            f"eager TTFT {eres.ttft_s:.3f} s, {eres.tok_s:.1f} tok/s; finite {gres.finite} -> "
            f"{'ok' if good else 'FAIL'}; launches {ng}; card {smi}")
        if not good:
            failures.append("jamba: generate")
        check_generate("jamba ARMT generate B=1", gres, eres, ng, ne,
                       graph_tok_s=gres.tok_s, eager_tok_s=eres.tok_s,
                       graph_ttft_s=gres.ttft_s, eager_ttft_s=eres.ttft_s)
        row.update(generate_ttft_s=gres.ttft_s, generate_tok_s=gres.tok_s,
                   generate_eager_ttft_s=eres.ttft_s, generate_eager_tok_s=eres.tok_s)
        del gres, eres, eng_e
        P = 2048
        ceng = ServeEngine(params, cfg, serve_mode="cache", max_len=P + 64)
        ceng_e = ServeEngine(params, cfg, serve_mode="cache", max_len=P + 64, eager=True)
        cprompt = rng.integers(0, cfg.vocab, (1, P))
        cres, nc, rc = counted(lambda: ceng.generate(cprompt, 16, keep=True))
        add(nc, rc)
        ceres, nce, _ = counted(lambda: ceng_e.generate(cprompt, 16, keep=True))
        log(f"  cache-mode generate B=1, prompt {P}, 16 new: TTFT {cres.ttft_s:.3f} s, "
            f"{cres.tok_s:.1f} tok/s; eager TTFT {ceres.ttft_s:.3f} s, {ceres.tok_s:.1f} tok/s; "
            f"finite {cres.finite}; launches {nc}")
        if not cres.finite:
            failures.append("jamba: cache-mode generate not finite")
        check_generate(f"jamba cache-mode generate B=1 at {P} tokens", cres, ceres, nc, nce,
                       graph_tok_s=cres.tok_s, eager_tok_s=ceres.tok_s,
                       graph_ttft_s=cres.ttft_s, eager_ttft_s=ceres.ttft_s)
        row.update(cache_generate_ttft_s=cres.ttft_s, cache_generate_tok_s=cres.tok_s,
                   cache_generate_eager_ttft_s=ceres.ttft_s,
                   cache_generate_eager_tok_s=ceres.tok_s)
        del ceng, ceng_e, cres, ceres

        sreq = [Request(i, rng.integers(0, cfg.vocab, n), 12)
                for i, n in enumerate([seg + 500, 2 * seg + 1000, 600, seg])]
        eng.program(4, "serve").prepare()   # the capture, outside the timed runs
        srv = {}
        for label, k in (("blocking", 0), ("k=4", 4)):
            (evs, t_srv), nsv, rsv = counted(lambda: serve_run(
                eng, sreq, prefill_groups_per_chunk=k))
            add(nsv, rsv)
            n_tok = sum(1 for e in evs if not isinstance(e, RequestError))
            srv[label] = (by_req(evs), n_tok / t_srv, n_tok)
        same = srv["blocking"][0] == srv["k=4"][0]
        good = same and srv["blocking"][2] == 48 and all(
            v[-1][2] and bool(v[-1][3]) for v in srv["blocking"][0].values())
        log(f"  serve, 4 requests ({', '.join(str(len(r.prompt)) for r in sreq)} tokens, 12 "
            f"new each) on 4 slots: blocking {srv['blocking'][1]:.1f} tok/s, k=4 "
            f"{srv['k=4'][1]:.1f} tok/s; every request's tokens equal {same}, complete and "
            f"finite -> {'ok' if good else 'FAIL'}")
        if not good:
            failures.append("jamba: serve blocking vs interleaved")
        row.update(serve_blocking_tok_s=srv["blocking"][1], serve_k4_tok_s=srv["k=4"][1],
                   serve_tokens_equal=same)
        del srv, evs

        pprompt = rng.integers(0, cfg.vocab, (1, 3 * seg + 300))
        peng = ServeEngine(params, cfg, prefix_cache=PrefixCache(seg))
        cold, nco, rco = counted(lambda: peng.generate(pprompt, 8, keep=True))
        add(nco, rco)
        hit, nh, rh = counted(lambda: peng.generate(pprompt, 8, keep=True))
        add(nh, rh)
        base_run = eng.generate(pprompt, 8, keep=True)
        same = dict(cached_segments=(cold.cached_segments, hit.cached_segments) == (0, 3),
                    tokens=bool(np.array_equal(hit.tokens, base_run.tokens)
                                and np.array_equal(cold.tokens, base_run.tokens)),
                    logits=same_bits(hit.logits, base_run.logits)
                    and same_bits(cold.logits, base_run.logits),
                    state=same_state(hit.state, base_run.state))
        ok = all(same.values())
        log(f"  prefix cache: a 3-segment hit (+300 tokens, 8 new) and the cold capturing run "
            f"against an engine without a cache: {same} -> {'ok' if ok else 'FAIL'}; TTFT "
            f"hit {hit.ttft_s:.3f} s, cold {cold.ttft_s:.3f} s, no cache "
            f"{base_run.ttft_s:.3f} s")
        if not ok:
            failures.append("jamba: prefix-cache hit vs uncached")
        row.update(prefix_hit_equal=ok, prefix_hit_ttft_s=hit.ttft_s,
                   prefix_cold_ttft_s=cold.ttft_s, no_cache_ttft_s=base_run.ttft_s)
        del peng, cold, hit, base_run

        for n_seg in (4, 16):
            peak, est = admission_peak(eng, n_seg, seg)
            ok = peak <= est
            row[f"admission_{n_seg}"] = dict(peak_bytes=peak, estimate_bytes=est)
            log(f"  a {n_seg}-segment admission's peak above its start {peak / 1e6:.1f} MB, "
                f"prefill_activation_bytes({n_seg}) {est / 1e6:.1f} MB -> "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"jamba: {n_seg}-segment admission peak above its estimate")
        del eng
        row.update(peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                   phase_s=time.perf_counter() - t_phase)
        log(f"  jamba peak {row['peak_gb']:.2f} GB; (t) {row['phase_s']:.1f} s")
        out["jamba"] = row
        del params
        M.SegmentProgram._cache.clear()
        torch.cuda.empty_cache()
        log(f"  launches over the phase: {launches}; GEMM and flash launches by route {routes}")
        for k in routed:
            if routes[k]["simt"] or not routes[k]["wgmma"]:
                failures.append(f"(t)'s {k} left the TMA + wgmma route: {routes[k]}")
        for name in forward_kernels:
            if launches[name] == 0:
                failures.append(f"{name} never launched by (t)")
        return launches, routes, out

    launches_jamba, routes_jamba, jamba_rows = jamba_phase()
    print(json.dumps({"jamba": jamba_rows, "card": smi}))

    # ------------------------------------------------------------ (u) whisper-medium
    def whisper_phase():
        """(u) whisper-medium at full width and depth (24 encoder and 24
        decoder layers, 1,500 frames), bf16, weights drawn on the card from
        the seed, every bias and layernorm leaf set away from its init value
        (normal x 0.02; 1 + normal x 0.02); two sets of frame embeddings
        drawn from the seed (the frontend is a stub). Returns (launches and
        routes summed over the phase's runs, the results)."""
        t_phase = time.perf_counter()
        M.SegmentProgram._cache.clear()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        launches, routes = {}, {}

        def add(n, r):
            nonlocal launches, routes
            launches, routes = merged(launches, n), merged(routes, r)
            return n, r

        cfg = get_config("whisper-medium")
        g = torch.Generator(device=dev).manual_seed(SEED)
        params = M.init_params(cfg, g, device=dev)

        def perturb(tree):
            for k, v in tree.items():
                if isinstance(v, dict):
                    perturb(v)
                elif k in ("bq", "bk", "bv", "bi", "bo", "b"):
                    v.copy_(torch.randn(v.shape, generator=g, device=dev) * 0.02)
                elif k == "w":
                    v.add_(torch.randn(v.shape, generator=g, device=dev) * 0.02)
        perturb({"dec": params["pattern"][0], "enc": params["enc"], "f": params["final_norm"]})
        D, F, seg = cfg.d_model, cfg.encoder.n_frames, cfg.armt.segment_len
        frames = [torch.randn((2, F, D), generator=g, device=dev).to(torch.bfloat16)
                  for _ in range(2)]
        fA, fB = frames[0][:1], frames[1][:1]
        sync()

        def numel(tree):
            return sum(numel(v) for v in tree.values()) if isinstance(tree, dict) else (
                sum(numel(v) for v in tree) if isinstance(tree, tuple) else tree.numel())
        counts = dict(total=numel(params), encoder=numel(params["enc"]),
                      decoder=numel(params["pattern"]), embed=numel(params["embed"]),
                      head=numel(params["head"]), pos_embed=numel(params["pos_embed"]))
        row = dict(params=counts, init_s=time.perf_counter() - t_phase,
                   cross_kv_bytes_per_row=2 * cfg.n_layers * F * D * 2)
        log(f"== (u) whisper-medium: {cfg.encoder.n_layers} + {cfg.n_layers} layers, d_model "
            f"{D}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, "
            f"vocab {cfg.vocab}, {F} frames, bf16: {counts['total'] / 1e6:.1f} M parameters "
            f"(encoder {counts['encoder'] / 1e6:.1f}, decoder {counts['decoder'] / 1e6:.1f}, "
            f"embedding {counts['embed'] / 1e6:.1f}, head {counts['head'] / 1e6:.1f}, "
            f"positions {counts['pos_embed'] / 1e6:.1f}), drawn on the card in "
            f"{row['init_s']:.2f} s; cross K/V {row['cross_kv_bytes_per_row'] / 1e6:.1f} MB a "
            "batch row")

        # (u1) the encoder on the kernels (bf16) against the plain path in
        # fp32 on the same weights, B = 1, as (i) holds full mode: the
        # output's rel err within 1e-2 (the worst row's logged), with a
        # negative control (every encoder layer's output projection x0.98)
        # that must fail it; then timed, device time behind a spin longer
        # than the host's enqueue of its ~1,000 launches, and host wall
        p32 = M._tree_map(lambda path, t: t.float(), params)
        tol_enc = 1e-2
        with torch.no_grad():
            enc, ne, re_ = counted(lambda: M.encode(params, cfg, fA))
            add(ne, re_)
            enc32 = M.encode(p32, cfg, fA.float(), fused=False)
            enc_err, enc_row = rel_err(enc, enc32), row_rel(enc, enc32)
            encp_err = rel_err(M.encode(params, cfg, fA, fused=False), enc32)
            ok = bool(torch.isfinite(enc).all()) and enc_err <= tol_enc
            blocks = params["enc"]["blocks"]
            ctl = dict(params, enc=dict(params["enc"], blocks=dict(blocks, attn=dict(
                blocks["attn"], wo=blocks["attn"]["wo"] * 0.98))))
            ctl_err = rel_err(M.encode(ctl, cfg, fA), enc32)
            del ctl
            row.update(encode_rel_err=enc_err, encode_worst_row_rel_err=enc_row,
                       encode_plain_bf16_rel_err=encp_err, encode_control_rel_err=ctl_err,
                       encode_ms=time_ms(lambda: M.encode(params, cfg, fA), iters=5,
                                         spin=200_000_000),
                       encode_plain_ms=time_ms(lambda: M.encode(params, cfg, fA, fused=False),
                                               iters=3, spin=200_000_000))
            sync()
            t0 = time.perf_counter()
            M.encode(params, cfg, fA)
            sync()
            row["encode_host_s"] = time.perf_counter() - t0
        caught = ctl_err > tol_enc
        log(f"  encode B=1 [1,{F},{D}], bf16 on the kernels vs the plain path in fp32: rel err "
            f"{enc_err:.3e} (worst row {enc_row:.3e}; the plain path in bf16 {encp_err:.3e}) "
            f"(tol {tol_enc:g}) -> {'ok' if ok else 'FAIL'}; negative control, every layer's "
            f"output projection x0.98: {ctl_err:.3e} -> {'caught, ok' if caught else 'FAIL'}; "
            f"{row['encode_ms']:.3f} ms device (plain bf16 {row['encode_plain_ms']:.3f} ms), "
            f"{row['encode_host_s'] * 1e3:.1f} ms host wall; launches {ne}; card {smi}")
        if not ok:
            failures.append("whisper: encoder vs plain")
        if not caught:
            failures.append("whisper: encoder check blind to the x0.98 control")
        del enc

        def fwd(tk, fr, **kw):
            with torch.no_grad():
                h, f = M.forward_hidden(params, cfg, tk, enc_frames=fr, **kw)
                return h, f, M.boundary_logits(params, cfg, h)

        # (u2) diagonal = sequential (captured segments), B = 1 and 2, 4 and
        # 16 segments: hidden states, logits, every layer's A, z and cross K/V
        for B in (1, 2):
            for n_seg in (4, 16):
                tk = torch.from_numpy(rng.integers(0, cfg.vocab, (B, n_seg * seg))).to(dev)
                (hd_, fd_, ld_), nd, rd = counted(lambda: fwd(tk, frames[0][:B]))
                add(nd, rd)
                (hs_, fs_, ls_), ns, rs = counted(lambda: fwd(tk, frames[0][:B],
                                                              schedule="sequential"))
                add(ns, rs)
                exact = dict(hidden=same_bits(hd_, hs_), logits=same_bits(ld_, ls_),
                             **{k: same_bits(v, fs_["pattern"][0][k])
                                for k, v in fd_["pattern"][0].items()})
                ok = all(exact.values())
                row[f"diagonal_equals_sequential_B{B}_S{n_seg}"] = ok
                log(f"  {n_seg}-segment prefill B={B}, diagonal vs sequential (captured "
                    f"segments): to the bit {ok} ({sum(exact.values())} of {len(exact)} "
                    f"tensors) -> {'ok' if ok else 'FAIL'}; launches {nd}")
                if not ok:
                    failures.append(f"whisper: diagonal vs sequential B={B} S={n_seg}: "
                                    f"{[k for k, v in exact.items() if not v]}")
                if B == 1 and n_seg == 16:
                    tk16, ld16 = tk, ld_
                del hd_, fd_, ld_, hs_, fs_, ls_
            M.SegmentProgram._cache.clear()
            torch.cuda.empty_cache()
        times = {}
        for n_seg in (4, 16):
            tkn = tk16[:, :n_seg * seg]
            for schedule in ("diagonal", "sequential"):
                fwd(tkn, fA, schedule=schedule)
                ts = []
                for _ in range(3):
                    sync()
                    t0 = time.perf_counter()
                    fwd(tkn, fA, schedule=schedule)
                    sync()
                    ts.append(time.perf_counter() - t0)
                times[f"{schedule}_{n_seg}"] = float(np.median(ts))
        row["prefill_s"] = times
        M.SegmentProgram._cache.clear()
        torch.cuda.empty_cache()
        log(f"  warm prefill B=1 with the encoder, median of 3: 4 segments diagonal "
            f"{times['diagonal_4']:.4f} s, sequential {times['sequential_4']:.4f} s; 16 "
            f"segments diagonal {times['diagonal_16']:.4f} s, sequential "
            f"{times['sequential_16']:.4f} s; card {smi}")

        # (u3) the kernels (bf16) against the plain path in fp32 on the same
        # weights: 16 segments free-running, the first 2 gated; then all 16
        # teacher-forced, each from the state the fp32 plain path reached
        # before it (its cross K/V from the fp32 plain encoder, in bf16),
        # held where a second rounding of the same math (the plain versions
        # of the kernels on the card, bf16) agrees within half the tolerance
        n_free, tol = 2, 5e-2
        with torch.no_grad():
            h32, _ = M.forward_hidden(p32, cfg, tk16[:, :n_free * seg], schedule="sequential",
                                      fused=False, enc_frames=fA.float())
            l32 = M.boundary_logits(p32, cfg, h32)
        free = [rel_err(ld16[i], l32[i]) for i in range(n_free)]
        ok = bool(torch.isfinite(ld16[:n_free]).all()) and max(free) <= tol
        row["free_running_logits_rel_err"] = free
        log(f"  segments 1-{n_free} free-running, diagonal on the kernels vs sequential plain "
            f"in fp32: last-token logits rel err {' '.join(f'{e:.2e}' for e in free)} (tol "
            f"{tol:g}) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("whisper: first segments vs the plain path")
        forced_in = []
        with torch.no_grad():
            st = M.init_state(cfg, 1, dev, torch.float32)
            M.fill_cross_kv_(p32, cfg, st, enc32, fused=False)
            ck16, cv16 = (st["pattern"][0][k].to(torch.bfloat16) for k in ("ck", "cv"))
            for i in range(16):
                part = tk16[:, i * seg:(i + 1) * seg]
                hs_, fs_ = M.forward_hidden(p32, cfg, part, schedule="sequential",
                                            fused=False, state0=st)
                st0 = {"prelude": (), "pattern": (dict(st["pattern"][0], ck=ck16, cv=cv16),)}
                forced_in.append((part, st0, M.boundary_logits(p32, cfg, hs_),
                                  fs_["pattern"][0]))
                st = fs_
        del h32, l32, hs_, st, enc32, p32

        def forced_errors():
            """Per segment: (the worst of the logits' and every layer's A
            and z rel err, all finite, the worst quantity's name)."""
            errs = []
            with torch.no_grad():
                for part, st0, lref, sref in forced_in:
                    h, f = M.forward_hidden(params, cfg, part, state0=st0)
                    lg, sd = M.boundary_logits(params, cfg, h), f["pattern"][0]
                    each = {"logits": rel_err(lg, lref)}
                    each.update({f"{k}{j}": rel_err(sd[k][j], sref[k][j])
                                 for k in ("A", "z") for j in range(cfg.n_layers)})
                    worst_k = max(each, key=each.get)
                    errs.append((each[worst_k], all(torch.isfinite(t).all().item()
                                                    for t in (lg, sd["A"], sd["z"])), worst_k))
            return errs
        with swap.plain_versions():
            probe = forced_errors()
        held = [i for i, (e, f, _) in enumerate(probe) if f and e <= tol / 2]
        errs = forced_errors()
        ok = (all(f for _, f, _ in errs) and len(held) >= 8
              and all(errs[i][0] <= tol for i in held))
        row.update(forced_rel_err=[e for e, _, _ in errs],
                   forced_worst=[w for _, _, w in errs],
                   forced_plain_rel_err=[e for e, _, _ in probe],
                   forced_held=[i + 1 for i in held])
        log(f"  16 segments teacher-forced from the fp32 plain path's states, worst of "
            f"logits/A/z rel err per segment: kernels "
            f"{' '.join(f'{e:.1e} ({w})' for e, _, w in errs)}; plain versions "
            f"{' '.join(f'{e:.1e}' for e, _, _ in probe)}; held at segments "
            f"{[i + 1 for i in held]} (tol {tol:g}, at least 8), kernels finite at all "
            f"{all(f for _, f, _ in errs)} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("whisper: teacher-forced segments")
        del forced_in
        torch.cuda.empty_cache()

        # (u4) generate: captured decode against eager in both serve modes
        # (ARMT: a flush at token 4; cache mode after 2,048 tokens), and one
        # engine's graphs reading each request's frames: A, B, then A again
        new = 24
        for mode, P in (("armt", 2 * seg + 1020), ("cache", 2048)):
            kw = dict(serve_mode=mode, max_len=P + 64) if mode == "cache" else {}
            eng, eng_e = ServeEngine(params, cfg, **kw), ServeEngine(params, cfg, eager=True, **kw)
            prompt = rng.integers(0, cfg.vocab, (1, P))
            gres, ng, rg = counted(lambda: eng.generate(prompt, new, keep=True, enc_frames=fA))
            add(ng, rg)
            eres, ne_, _ = counted(lambda: eng_e.generate(prompt, new, keep=True, enc_frames=fA))
            good = (gres.finite and gres.tokens.shape == (1, new)
                    and 0 <= gres.tokens.min() and gres.tokens.max() < cfg.vocab)
            log(f"  {mode} generate B=1, prompt {P}, {new} new: TTFT {gres.ttft_s:.3f} s, "
                f"{gres.tok_s:.1f} tok/s (capture {gres.capture_s:.3f} s); eager TTFT "
                f"{eres.ttft_s:.3f} s, {eres.tok_s:.1f} tok/s; finite {gres.finite} -> "
                f"{'ok' if good else 'FAIL'}; launches {ng}; card {smi}")
            log(f"    tokens: {gres.tokens[0].tolist()}")
            if not good:
                failures.append(f"whisper: {mode} generate")
            check_generate(f"whisper {mode} generate B=1", gres, eres, ng, ne_,
                           graph_tok_s=gres.tok_s, eager_tok_s=eres.tok_s,
                           graph_ttft_s=gres.ttft_s, eager_ttft_s=eres.ttft_s)
            row[f"{mode}_generate"] = dict(ttft_s=gres.ttft_s, tok_s=gres.tok_s,
                                           eager_ttft_s=eres.ttft_s, eager_tok_s=eres.tok_s)
            del eres
            # the graphs follow each request's frames: after A, B's run on
            # the same graphs equals B's on an eager engine that never saw
            # A, to the bit, and its logits are not A's; A again repeats A
            (rB, rA), nf, rf = counted(lambda: [eng.generate(prompt, new, keep=True,
                                                             enc_frames=f) for f in (fB, fA)])
            add(nf, rf)
            eB = eng_e.generate(prompt, new, keep=True, enc_frames=fB)
            same_a = (np.array_equal(gres.tokens, rA.tokens) and same_bits(gres.logits, rA.logits)
                      and same_state(gres.state, rA.state))
            b_fresh = (np.array_equal(rB.tokens, eB.tokens) and same_bits(rB.logits, eB.logits)
                       and same_state(rB.state, eB.state))
            b_other = not torch.equal(rB.logits, gres.logits)
            tokens_differ = not np.array_equal(gres.tokens, rB.tokens)
            ok = same_a and b_fresh and b_other
            row[f"{mode}_frames_A_B_A"] = dict(A_twice_to_the_bit=same_a,
                                               B_equals_fresh_eager=b_fresh,
                                               B_logits_differ=b_other,
                                               B_tokens_differ=tokens_differ)
            log(f"  {mode} generate on one engine's graphs, frames A, B, A: the two A runs "
                f"equal to the bit (tokens, logits, state) {same_a}; B equal to the bit to an "
                f"eager engine's B {b_fresh}, its logits not A's {b_other} -> "
                f"{'ok' if ok else 'FAIL'}; B's tokens differ from A's {tokens_differ}")
            if not ok:
                failures.append(f"whisper: {mode} graphs do not follow the request's frames")
            del gres, rA, rB, eB, eng, eng_e
            torch.cuda.empty_cache()

        # (u5) the blocking prefill's peak above its start against
        # prefill_activation_bytes (the encoder's transients and the cross K/V
        # counted), at 4 and 16 segments
        row["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        eng = ServeEngine(params, cfg)
        for n_seg in (4, 16):
            est = eng.prefill_activation_bytes(n_seg, stream=False)
            prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (1, n_seg * seg + 100)))
            torch.cuda.empty_cache()
            sync()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats(dev)
            res, nprf, rprf = counted(lambda: eng.prefill(prompt, enc_frames=fA))
            add(nprf, rprf)
            peak = torch.cuda.max_memory_allocated(dev) - base
            del res
            ok = peak <= est
            row[f"prefill_{n_seg}"] = dict(peak_bytes=peak, estimate_bytes=est)
            log(f"  a {n_seg}-segment prefill's peak above its start {peak / 1e6:.1f} MB, "
                f"prefill_activation_bytes({n_seg}) {est / 1e6:.1f} MB -> "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"whisper: {n_seg}-segment prefill peak above its estimate")
        del eng, params, frames, fA, fB
        M.SegmentProgram._cache.clear()
        torch.cuda.empty_cache()
        row["phase_s"] = time.perf_counter() - t_phase
        log(f"  whisper peak {row['peak_gb']:.2f} GB; (u) {row['phase_s']:.1f} s")
        log(f"  launches over the phase: {launches}; GEMM and flash launches by route {routes}")
        for k in routed:
            if routes[k]["simt"] or not routes[k]["wgmma"]:
                failures.append(f"(u)'s {k} left the TMA + wgmma route: {routes[k]}")
        for name in llama_kernels:
            if launches[name] == 0:
                failures.append(f"{name} never launched by (u)")
        return launches, routes, row

    launches_whisper, routes_whisper, whisper_row = whisper_phase()
    print(json.dumps({"whisper": whisper_row, "card": smi}))

    # ------------------------------------------------------------ (v) training
    def train_phase():
        """(v) training llama-1b-armt at full width and depth on the kernels:
        (v1) each backward at the band's shapes against autograd through
        the plain version, timed; (v2) fp32, 2 segments: the loss and every
        gradient of the kernel path against the plain path (a control that
        must fail), and the B = 1 cell's unfused route (the training form)
        against the fused op in the forward; (v3) bf16, remat, 16
        segments: diagonal against sequential (the losses to the bit), and
        in fp32 at 4 segments their gradients; (v4) train_loop on lm_stream
        for 12 steps, resumed from step 6 in a fresh loop, and a non-finite
        step skipped. Returns (the launches of (v4)'s uninterrupted run,
        its routes, the backward rows of (v1), the results)."""
        from repro_torch.data import lm_stream, to_device
        from repro_torch.kernels import ref
        from repro_torch.models.grouped_blocks import make_grouped_apply
        from repro_torch.optim import OptimConfig
        from repro_torch.train import make_train_step, train_loop
        from repro_torch.utils import tree_flatten_with_path, tree_leaves, tree_unflatten

        t_phase = time.perf_counter()
        M.SegmentProgram._cache.clear()
        torch.cuda.empty_cache()
        row = {}
        tol32, tol16, step_tol, leaf_tol = 1e-4, 2e-2, 1e-4, 1e-3

        gdev = torch.Generator(device=dev).manual_seed(SEED + 9)

        def rnd_d(*shape, scale=1.0, dtype=torch.bfloat16):
            """Normals drawn on the card (the band's weights are too many for
            the host's generator to draw quickly)."""
            return (torch.randn(shape, generator=gdev, device=dev) * scale).to(dtype)

        def grads(fn, ins, gys):
            outs = fn(*ins)
            outs = outs if isinstance(outs, tuple) else (outs,)
            return outs, torch.autograd.grad(outs, [t for t in ins if t is not None], gys,
                                             retain_graph=True)

        # (v1) each backward against autograd through its plain version
        log("== (v) training llama-1b-armt; (v1) each kernel's backward at the band's shapes "
            "against autograd through its plain version (fp32 on the same input values)")
        bwd = {}

        def bwd_case(name, kernel, plain, shapes, time_it):
            """shapes: [(shape, scale) or None] of the inputs; each run in
            fp32 and in bf16, every input's gradient held (norm-relative)
            against autograd through the plain version in fp32 on the same
            values; a control must fail: the first gradient x0.98 in fp32,
            x0.95 in bf16 (x0.98 sits at bf16's tolerance of 2e-2)."""
            out = {}
            for dtype, tol, scale in ((torch.float32, tol32, 0.98),
                                      (torch.bfloat16, tol16, 0.95)):
                ins = [None if s is None else rnd_d(*s[0], scale=s[1], dtype=dtype)
                       .requires_grad_() for s in shapes]
                with torch.no_grad():
                    ys = kernel(*ins)
                ys = ys if isinstance(ys, tuple) else (ys,)
                gys = [rnd_d(*y.shape, dtype=y.dtype) for y in ys]
                ref_ins = [None if t is None else t.detach().float().requires_grad_()
                           for t in ins]
                _, want = grads(plain, ref_ins, [g.float() for g in gys])
                outs, got = grads(kernel, ins, gys)
                errs = [rel_err(g.float(), w) for g, w in zip(got, want)]
                control = rel_err(got[0].float() * scale, want[0])
                ok = max(errs) <= tol and control > tol and all(
                    torch.isfinite(g).all().item() for g in got)
                label = "fp32" if dtype == torch.float32 else "bf16"
                log(f"  {name} {label}: worst input grad rel err {max(errs):.3e} (tol {tol:g}; "
                    f"each {['%.2e' % e for e in errs]}), control x{scale} {control:.3e} -> "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(f"(v1) {name} {label} backward")
                out[f"err_{label}"] = max(errs)
                out[f"control_{label}"] = control
                if dtype == torch.bfloat16 and time_it:
                    plain_outs = plain(*ins)
                    plain_outs = plain_outs if isinstance(plain_outs, tuple) else (plain_outs,)
                    live = [t for t in ins if t is not None]
                    with torch.no_grad():
                        out["fwd_ms"] = time_ms(lambda: kernel(*ins), iters=5)
                    out["bwd_ms"] = time_ms(lambda: torch.autograd.grad(
                        outs, live, gys, retain_graph=True), iters=5, warmup=1,
                        spin=20_000_000)
                    out["plain_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
                        plain_outs, live, gys, retain_graph=True), iters=3, warmup=1,
                        spin=20_000_000)
                    log(f"    bf16 times: forward {out['fwd_ms']:.3f} ms, backward "
                        f"{out['bwd_ms']:.3f} ms, the plain version's backward "
                        f"{out['plain_bwd_ms']:.3f} ms")
                    del plain_outs
                del ins, ref_ins, outs, got, want, ys, gys
                torch.cuda.empty_cache()
            return out

        Gb, Tb, Db, Fb, Hq, Hkv, hd, dmb, Mb = 16, 1152, 2048, 8192, 32, 8, 64, 64, 128
        Pb = 6 * dmb
        bwd["grouped_matmul"] = {
            "up_silu": bwd_case(
                "grouped_matmul silu [16,1152,2048]x[16,2048,8192]",
                lambda x, w: grouped_matmul.grouped_matmul(x, w, activation="silu"),
                lambda x, w: ref.grouped_matmul_ref(x, w, activation="silu"),
                [((Gb, Tb, Db), 1.0), ((Gb, Db, Fb), Db ** -0.5)], True),
            "up_gelu_bias": bwd_case(
                "grouped_matmul gelu + bias [16,1152,2048]x[16,2048,8192]",
                lambda x, w, b: grouped_matmul.grouped_matmul(x, w, b, activation="gelu"),
                lambda x, w, b: ref.grouped_matmul_ref(x, w, b, activation="gelu"),
                [((Gb, Tb, Db), 1.0), ((Gb, Db, Fb), Db ** -0.5), ((Gb, Fb), 0.1)], True),
            "down_res": bwd_case(
                "grouped_matmul + res [16,1152,8192]x[16,8192,2048]",
                lambda x, w, r: grouped_matmul.grouped_matmul(x, w, res=r),
                lambda x, w, r: ref.grouped_matmul_ref(x, w, res=r),
                [((Gb, Tb, Fb), 1.0), ((Gb, Fb, Db), Fb ** -0.5), ((Gb, Tb, Db), 1.0)], True)}
        bwd["flash_attention"] = {
            f"{label}": bwd_case(
                f"flash_attention {label} q [16,32,1152,64] k/v [16,8,1152,64]",
                lambda q, k, v, w=w: flash_attention.flash_attention(q, k, v, causal=True,
                                                                     window=w),
                lambda q, k, v, w=w: ref.flash_attention_ref(q, k, v, causal=True, window=w),
                [((Gb, Hq, Tb, hd), 1.0), ((Gb, Hkv, Tb, hd), 1.0), ((Gb, Hkv, Tb, hd), 1.0)],
                True)
            for label, w in (("causal", 0), ("window_512", 512))}
        bwd["armt_read"] = {"band": bwd_case(
            "armt_read x [16,1152,2048] wq [16,2048,64] A [16,384,2048]",
            lambda x, wq, A, z: armt_memory.armt_read(x, wq, A.float(), z.float().abs() + 1,
                                                      nu=3),
            lambda x, wq, A, z: ref.armt_read_ref(x, wq, A.float(), z.float().abs() + 1, nu=3),
            [((Gb, Tb, Db), 1.0), ((Gb, Db, dmb), Db ** -0.5), ((Gb, Pb, Db), 0.05),
             ((Gb, Pb), 1.0)], True)}
        bwd["armt_update"] = {"band": bwd_case(
            "armt_update m [16,128,2048] wk/wv/wb [16,2048,64/2048/1] A [16,384,2048]",
            lambda m, wk, wv, wb, A, z: armt_memory.armt_update(m, wk, wv, wb, A.float(),
                                                                z.float().abs() + 1, nu=3),
            lambda m, wk, wv, wb, A, z: ref.armt_update_ref(m, wk, wv, wb, A.float(),
                                                            z.float().abs() + 1, nu=3),
            [((Gb, Mb, Db), 1.0), ((Gb, Db, dmb), Db ** -0.5), ((Gb, Db, Db), Db ** -0.5),
             ((Gb, Db, 1), Db ** -0.5), ((Gb, Pb, Db), 0.05), ((Gb, Pb), 1.0)], True)}
        row["v1"] = bwd

        # (v2) fp32, 2 segments: the kernel path's loss and gradients against
        # the plain path's
        cfg = get_config("llama-1b-armt")
        seg = cfg.armt.segment_len
        cfg32 = replace(cfg, dtype="float32")
        p32 = M.init_params(cfg32, torch.Generator(device=dev).manual_seed(SEED), device=dev)
        trng = np.random.default_rng(SEED + 5)

        def tokens(n_seg):
            t = torch.from_numpy(trng.integers(0, cfg.vocab, (1, n_seg * seg + 1))).to(dev)
            return t[:, :-1], t[:, 1:]

        def loss_grads(p, c, tk, lb, **kw):
            leaves = [t.detach().requires_grad_() for t in tree_leaves(p)]
            loss = M.lm_loss(tree_unflatten(p, leaves), c, tk, lb, **kw)
            return loss.detach(), torch.autograd.grad(loss, leaves)

        names = [n for n, _ in tree_flatten_with_path(p32)]

        def compare(a, b):
            """(loss rel err, {leaf: grad rel err})"""
            return (abs(a[0].item() - b[0].item()) / abs(b[0].item()),
                    {n: rel_err(x.float(), y.float()) for n, x, y in zip(names, a[1], b[1])})
        tk2, lb2 = tokens(2)
        log("== (v2) fp32, full width and depth, B = 1, 2 segments: lm_loss and every "
            "gradient, kernels (diagonal, fused) against the plain path")
        t0 = time.perf_counter()
        kern = loss_grads(p32, cfg32, tk2, lb2, schedule="diagonal", fused=True)
        sync()
        t_kern = time.perf_counter() - t0
        plain = loss_grads(p32, cfg32, tk2, lb2, schedule="diagonal", fused=False)
        l_err, g_errs = compare(kern, plain)
        worst = max(g_errs, key=g_errs.get)
        ok = l_err <= step_tol and g_errs[worst] <= leaf_tol
        log(f"  loss {kern[0].item():.6f} vs plain {plain[0].item():.6f}: rel {l_err:.3e} (tol "
            f"{step_tol:g}); worst leaf {worst} {g_errs[worst]:.3e} (tol {leaf_tol:g}) -> "
            f"{'ok' if ok else 'FAIL'}; kernel run {t_kern:.2f} s")
        if not ok:
            failures.append("(v2) fp32 kernel gradients against the plain path")
        del kern
        wo = p32["pattern"][0]["attn"]["wo"]
        wo_c = wo.clone()
        wo_c[wo_c.shape[0] // 4] *= 0.98
        pc = dict(p32, pattern=({**p32["pattern"][0],
                                 "attn": {**p32["pattern"][0]["attn"], "wo": wo_c}},))
        l_c, g_c = compare(loss_grads(pc, cfg32, tk2, lb2, schedule="diagonal", fused=True),
                           plain)
        worst_c = max(g_c.values())
        control_ok = l_c > step_tol or worst_c > leaf_tol
        log(f"  control (layer {wo_c.shape[0] // 4}'s wo x0.98 in the kernel run): loss rel "
            f"{l_c:.3e}, worst leaf "
            f"{worst_c:.3e} -> {'fails as it must' if control_ok else 'PASSES: FAIL'}")
        if not control_ok:
            failures.append("(v2) control passed")
        del plain, pc, wo_c
        row["v2"] = dict(loss_rel_err=l_err, worst_leaf=worst, worst_leaf_rel_err=g_errs[worst],
                         grad_rel_err=g_errs, control_loss_rel_err=l_c,
                         control_worst_leaf_rel_err=worst_c, kernel_run_s=t_kern)
        # diagonal against sequential gradients, fp32, 4 segments
        tk4, lb4 = tokens(4)
        d4 = loss_grads(p32, cfg32, tk4, lb4, schedule="diagonal")
        s4 = loss_grads(p32, cfg32, tk4, lb4, schedule="sequential")
        l_ds, g_ds = compare(d4, s4)
        ok = max(g_ds.values()) <= leaf_tol and l_ds <= step_tol
        log(f"  fp32, 4 segments, diagonal vs sequential on the kernels: loss rel {l_ds:.3e}, "
            f"worst leaf {max(g_ds.values()):.3e} (tol {leaf_tol:g}) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("(v3) fp32 diagonal vs sequential gradients at 4 segments")
        row["v3_fp32_4seg"] = dict(loss_rel_err=l_ds, worst_leaf_rel_err=max(g_ds.values()))
        del d4, s4, p32
        torch.cuda.empty_cache()

        # the B = 1 cell under gradients (grouped_matmul(res=) then
        # armt_update) against the fused op, in the forward, bf16
        p16 = M.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
        cell = make_grouped_apply(cfg)
        xb = rnd_d(Gb, 1, Tb, Db)
        stb = {"A": rnd_d(Gb, 1, Pb, Db, scale=0.05, dtype=torch.float32),
               "z": rnd_d(Gb, 1, Pb, dtype=torch.float32).abs() + 1}
        reset_counts()
        with torch.no_grad():
            y0, s0 = cell("attn", p16["pattern"][0], xb, stb)
        fused_launches = read_counts()["grouped_matmul_armt_update"]
        y1, s1 = cell("attn", p16["pattern"][0], xb.clone().requires_grad_(), stb)
        unfused_ok = read_counts()["grouped_matmul_armt_update"] == fused_launches == 1
        bitwise = same_bits(y0, y1.detach()) and all(same_bits(s0[k], s1[k].detach())
                                                     for k in ("A", "z"))
        rels = [rel_err(y1.detach().float(), y0.float())] + [
            rel_err(s1[k].detach(), s0[k]) for k in ("A", "z")]
        log(f"  the B = 1 cell's unfused route (grouped_matmul(res=), armt_update) against the "
            f"fused op, forward, bf16 band [16,1,1152,2048]: to the bit {bitwise} (rel err y, "
            f"A, z {['%.2e' % r for r in rels]}); the fused op launched only without "
            f"gradients {unfused_ok}")
        if not unfused_ok or max(rels) > 1e-2:
            failures.append("(v2) unfused B = 1 route against the fused op")
        row["unfused_vs_fused_bitwise"] = bitwise
        row["unfused_vs_fused_rel_err"] = rels
        del y0, s0, y1, s1, xb, stb

        # (v3) bf16, remat, 16 segments: diagonal against sequential, on the
        # training stream's first batch (uniform random tokens overflow the
        # untrained model's forward by segments 11-14: reported, not trained)
        log("== (v3) bf16, remat 'full', B = 1, 16 segments of 1,024: lm_loss and gradients, "
            "diagonal against sequential, both on the kernels")
        first = to_device(next(lm_stream(cfg.vocab, 1, 16 * seg, seed=SEED)), dev)
        tk16, lb16 = first["tokens"], first["labels"]
        rt, rl = tokens(16)
        with torch.no_grad():
            rand_loss = {sch: M.lm_loss(p16, cfg, rt, rl, schedule=sch)
                         for sch in ("diagonal", "sequential")}
        log(f"  uniform random tokens (forward only): loss diagonal "
            f"{rand_loss['diagonal'].item():.6f}, sequential {rand_loss['sequential'].item():.6f}, "
            f"to the bit {same_bits(rand_loss['diagonal'], rand_loss['sequential'])} "
            "(informational: the untrained recurrence overflows on them)")
        row["v3_random_tokens_loss"] = {k: v.item() for k, v in rand_loss.items()}
        runs = {}
        for schedule in ("diagonal", "sequential"):
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            runs[schedule] = loss_grads(p16, cfg, tk16, lb16, schedule=schedule)
            sync()
            runs[schedule] += (time.perf_counter() - t0,
                               torch.cuda.max_memory_allocated(dev) / 1e9)
        (ld, gd, td, md), (ls, gs, ts, ms) = runs["diagonal"], runs["sequential"]
        loss_bits = same_bits(ld, ls)
        g_rel = {n: rel_err(a.float(), b.float()) for n, a, b in zip(names, gd, gs)}
        finite = all(torch.isfinite(g).all().item() for g in gd + gs)
        log(f"  the training stream's first batch: loss diagonal {ld.item():.6f} sequential "
            f"{ls.item():.6f}: to the bit {loss_bits}; "
            f"gradients finite {finite}, largest rel difference {max(g_rel.values()):.3e} "
            f"({max(g_rel, key=g_rel.get)}; informational); loss + gradients diagonal {td:.2f} s "
            f"(peak {md:.2f} GB), sequential {ts:.2f} s (peak {ms:.2f} GB)")
        if not (loss_bits and finite):
            failures.append("(v3) bf16 diagonal vs sequential loss bits / finite gradients")
        row["v3"] = dict(loss=ld.item(), loss_bitwise=loss_bits, grads_finite=finite,
                         grad_rel_diff=g_rel, diagonal_s=td, sequential_s=ts,
                         diagonal_peak_gb=md, sequential_peak_gb=ms)
        del runs, gd, gs, p16, cell
        torch.cuda.empty_cache()

        # (v4) train_loop, bf16, diagonal, 12 steps: 16 segments (the main
        # path: times, launches, the non-finite guard), then 4 segments (the
        # loss falls; checkpoint and resume)
        ocfg = OptimConfig(lr=1e-3, warmup_steps=2, total_steps=12)
        ckpt = ROOT / "build" / "chip_smoke_train_ckpt"
        shutil.rmtree(ckpt, ignore_errors=True)

        def loop(n_seg, steps, **kw):
            return train_loop(cfg, ocfg, lm_stream(cfg.vocab, 1, n_seg * seg, seed=SEED),
                              steps=steps, schedule="diagonal", device=dev,
                              generator=torch.Generator(device=dev).manual_seed(SEED), **kw)

        def trend(ls):
            """(mean of the first 3 finite losses, of the last 3)."""
            fin = [l for l in ls if math.isfinite(l)]
            return float(np.mean(fin[:3])), float(np.mean(fin[-3:]))
        log("== (v4) train_loop on lm_stream: bf16, full width and depth, B = 1, diagonal, 12 "
            "steps, lr 1e-3 (warmup 2); 16 segments (16,384 tokens)")
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        full = loop(16, 12)
        sync()
        launches, routes = read_counts(), read_routes()
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        hist = full["history"]
        losses = [h["loss"] for h in hist]
        times = [h["step_time_s"] for h in hist]
        skipped = [h["step"] for h in hist if h["skipped"]]
        step_s = float(np.median(times[1:]))
        log(f"  losses {['%.4f' % l for l in losses]}; grad norms "
            f"{['%.3g' % h['grad_norm'] for h in hist]}; steps skipped as non-finite {skipped} "
            "(informational: the untrained recurrence overflows at 16 segments once updated)")
        log(f"  step time median {step_s:.3f} s over steps 1-11 (first {times[0]:.3f} s): "
            f"{16 * seg / step_s:.0f} tokens/s; peak {peak:.2f} GB")
        log(f"  launches over the 12 steps: {launches}; GEMM and flash by route {routes}")
        for name in ("grouped_matmul", "flash_attention", "armt_read", "armt_update"):
            if launches[name] == 0:
                failures.append(f"(v4) {name} never launched")
        for name in ("grouped_matmul_armt_update", "decode_attention", "mamba_scan"):
            if launches[name]:
                failures.append(f"(v4) {name} launched in training")
        for k in routed:
            if routes[k]["simt"] or not routes[k]["wgmma"]:
                failures.append(f"(v4)'s {k} left the TMA + wgmma route: {routes[k]}")
        del full
        torch.cuda.empty_cache()
        # 4 segments: the loss must fall; a checkpoint at step 6 resumed in
        # a fresh loop to step 12; a step with a NaN in its loss mask skipped
        log("  4 segments (4,096 tokens), the same settings:")
        four = loop(4, 12)
        f_losses = [h["loss"] for h in four["history"]]
        f_skipped = [h["step"] for h in four["history"] if h["skipped"]]
        first3, last3 = trend(f_losses)
        learned = last3 < first3 and not f_skipped
        log(f"  losses {['%.4f' % l for l in f_losses]}; skipped {f_skipped}; mean of the first "
            f"3 {first3:.4f}, of the last 3 {last3:.4f}: margin {first3 - last3:.4f} -> "
            f"{'ok' if learned else 'FAIL'}")
        if not learned:
            failures.append("(v4) the loss did not fall at 4 segments")
        t0 = time.perf_counter()
        loop(4, 6, ckpt_dir=str(ckpt), ckpt_every=6, keep=1)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        resumed = loop(4, 12, ckpt_dir=str(ckpt), ckpt_every=6, keep=1)
        t_resume = time.perf_counter() - t0
        r_losses = [h["loss"] for h in resumed["history"]]
        r_steps = [h["step"] for h in resumed["history"]]
        r_err = max(abs(a - b) / abs(b) for a, b in zip(r_losses, f_losses[6:]))
        r_bits = r_losses == f_losses[6:]
        ok = r_steps == list(range(6, 12)) and r_err <= 1e-3
        log(f"  resumed at step {r_steps[0]}: losses {['%.4f' % l for l in r_losses]}; largest "
            f"rel difference to the uninterrupted run {r_err:.3e} (tol 1e-3), to the bit "
            f"{r_bits} -> {'ok' if ok else 'FAIL'}; the 6-step run with its save {t_save:.1f} s, "
            f"the resumed run with its restore and save {t_resume:.1f} s")
        if not ok:
            failures.append("(v4) resumed losses")
        del resumed
        shutil.rmtree(ckpt, ignore_errors=True)
        state = four["state"]
        batch = to_device(next(lm_stream(cfg.vocab, 1, 4 * seg, seed=SEED + 1)), dev)
        mask = torch.ones(1, 4 * seg, device=dev)
        mask[0, seg + 3] = float("nan")
        batch["loss_mask"] = mask
        new, metrics = make_train_step(cfg, ocfg, schedule="diagonal")(state, batch)
        nan_skipped = metrics["skipped"].item() == 1.0
        kept = all(same_bits(a, b) for a, b in zip(tree_leaves(new), tree_leaves(state)))
        log(f"  a step with a NaN in the loss mask: skipped {nan_skipped}, params and moments "
            f"unchanged to the bit {kept} -> {'ok' if nan_skipped and kept else 'FAIL'}")
        if not (nan_skipped and kept):
            failures.append("(v4) non-finite step not skipped")
        del new, state, four
        torch.cuda.empty_cache()
        row["v4"] = dict(losses_16=losses, grad_norms_16=[h["grad_norm"] for h in hist],
                         skipped_16=skipped, step_s=step_s, step_times_s=times,
                         tokens_per_s=16 * seg / step_s, peak_gb=peak, losses_4=f_losses,
                         first3_4=first3, last3_4=last3, margin_4=first3 - last3,
                         resumed_losses_4=r_losses, resumed_rel_err=r_err, resumed_bitwise=r_bits,
                         save_run_s=t_save, resume_run_s=t_resume,
                         nonfinite_skipped=nan_skipped, nonfinite_state_kept=kept)
        row["phase_s"] = time.perf_counter() - t_phase
        log(f"  (v) {row['phase_s']:.1f} s")
        return launches, routes, bwd, row

    launches_train, routes_train, backward_rows, train_row = train_phase()
    print(json.dumps({"train": dict(step_s=train_row["v4"]["step_s"],
                                    tokens_per_s=train_row["v4"]["tokens_per_s"],
                                    peak_gb=train_row["v4"]["peak_gb"], **train_row),
                      "card": smi}))

    # ------------------------------------------------------------ (w) training the other families
    def train_families_phase():
        """(w) training the mamba, MoE and encoder configs on the kernels'
        autograd Functions. (w1) mamba_scan's backward kernel at falcon's
        width against its plain backward, the plain backward against
        autograd through the plain scan, and both kernels timed at
        falcon's and jamba's bands; (w2) fp32, B = 1, 2 segments: the
        fused path's loss and every gradient against the plain path's
        (routing flips counted), diagonal = sequential losses; (w3) bf16,
        4 segments, 12 steps on one repeated batch: the loss falls, step
        times, peaks, and falcon's train_loop resumed from a checkpoint.
        Returns (launches over (w2) and (w3), by route, mamba_scan's
        backward row, the results)."""
        from repro_torch.core.schedule import StackLayout
        from repro_torch.data import lm_stream, to_device
        from repro_torch.kernels import grad as kgrad
        from repro_torch.kernels import ref
        from repro_torch.models import moe as moe_mod
        from repro_torch.optim import OptimConfig
        from repro_torch.train import init_train_state, make_train_step, train_loop
        from repro_torch.utils import tree_flatten_with_path, tree_leaves, tree_unflatten

        t_phase = time.perf_counter()
        M.SegmentProgram._cache.clear()
        torch.cuda.empty_cache()
        row, launches, routes = {}, {}, {}
        tol32, tol16, loss_tol, leaf_tol = 1e-4, 2e-2, 1e-4, 1e-3
        gw = torch.Generator(device=dev).manual_seed(SEED + 11)

        def rnd_w(*shape, scale=1.0, dtype=torch.float32):
            return (torch.randn(shape, generator=gw, device=dev) * scale).to(dtype)

        def counted_w(fn):
            """fn() from counts set to 0; its launches and routes added to
            the phase's -> (result, launches)."""
            nonlocal launches, routes
            reset_counts()
            out = fn()
            sync()
            n = read_counts()
            launches, routes = merged(launches, n), merged(routes, read_routes())
            return out, n

        # (w1) the scan's backward kernel
        log("== (w) training the mamba, MoE and encoder configs; (w1) mamba_scan's backward "
            "kernel at falcon-mamba's width (fused form, per-group A_log)")
        names = ("x", "dt", "Bt", "Ct", "A_log", "D", "h0", "dt_bias", "z")

        def scan_case(N, T, dI, dS, G, dtype):
            """The fused form's operands as the mixer hands them over: x and z
            halves of in_proj's output, the raw dt a column slice, B and C
            slices of x_proj's fp32 output, per-group A_log, D and dt_bias."""
            xz = rnd_w(N, T, 2 * dI, scale=0.5, dtype=dtype)
            raw = rnd_w(N, T, dI + 8, dtype=dtype)
            proj = rnd_w(N, T, 8 + 2 * dS, scale=0.5)
            A_log = torch.log(torch.arange(1, dS + 1, dtype=torch.float32, device=dev)
                              * (torch.rand(G, dI, dS, generator=gw, device=dev) + 0.5))
            return dict(x=xz[..., :dI], dt=raw[..., 8:], Bt=proj[..., 8:8 + dS],
                        Ct=proj[..., 8 + dS:], A_log=A_log, D=rnd_w(G, dI),
                        h0=rnd_w(N, dI, dS, scale=0.1), dt_bias=rnd_w(G, dI, scale=0.1) - 4.6,
                        z=xz[..., dI:])

        def scan_grads(c, fn, gy, gh):
            """Gradients of fn's (y, hT) to every operand (views included)."""
            ins = {k: v.detach().requires_grad_() for k, v in c.items()}
            y, hT = fn(*(ins[k] for k in names[:7]), dt_bias=ins["dt_bias"], z=ins["z"])
            return torch.autograd.grad((y, hT), [ins[k] for k in names], (gy, gh))

        w1 = {}
        Nw, Tw, dIw, dSw = 2, 1024, 8192, 16
        for dtype, tol, scale in ((torch.float32, tol32, 0.98), (torch.bfloat16, tol16, 0.95)):
            label = "fp32" if dtype == torch.float32 else "bf16"
            c = scan_case(Nw, Tw, dIw, dSw, Nw, dtype)
            with torch.no_grad():
                y0, _ = mamba_scan.mamba_scan(*(c[k] for k in names[:7]), dt_bias=c["dt_bias"],
                                              z=c["z"])
            gy, gh = rnd_w(*y0.shape, dtype=y0.dtype), rnd_w(Nw, dIw, dSw, scale=0.1)
            got = scan_grads(c, mamba_scan.mamba_scan, gy, gh)
            c32 = {k: v.float() for k, v in c.items()}
            plain = kgrad.mamba_scan_bwd_plain(*(c32[k] for k in names[:7]), gy.float(), gh,
                                               dt_bias=c32["dt_bias"], z=c32["z"])
            errs = {k: rel_err(a.float(), b) for k, a, b in zip(names, got, plain)}
            control = rel_err(got[0].float() * scale, plain[0])
            ok = max(errs.values()) <= tol and control > tol and all(
                torch.isfinite(g).all().item() for g in got)
            log(f"  kernel backward vs plain backward, {label}, x [{Nw},{Tw},{dIw}] dS {dSw}: "
                f"worst {max(errs, key=errs.get)} {max(errs.values()):.3e} (tol {tol:g}; "
                f"{', '.join(f'{k} {v:.1e}' for k, v in errs.items())}), control x{scale} "
                f"{control:.3e} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"(w1) mamba_scan backward {label}")
            w1[f"err_{label}"] = max(errs.values())
            w1[f"control_{label}"] = control
            if dtype == torch.float32:
                # the plain backward against autograd through the plain scan
                auto = scan_grads(c32, ref.mamba_scan_ref, gy.float(), gh)
                errs_p = {k: rel_err(a, b) for k, a, b in zip(names, plain, auto)}
                control_p = rel_err(plain[0] * scale, auto[0])
                ok = max(errs_p.values()) <= tol and control_p > tol
                log(f"  plain backward vs autograd through the plain scan, fp32: worst "
                    f"{max(errs_p.values()):.3e} (tol {tol:g}), control x{scale} "
                    f"{control_p:.3e} -> {'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append("(w1) mamba_scan plain backward vs autograd")
                w1["plain_vs_autograd_err"] = max(errs_p.values())
                del auto
            else:
                w1["plain_bwd_ms"] = time_ms(lambda: kgrad.mamba_scan_bwd_plain(
                    *(c32[k] for k in names[:7]), gy.float(), gh, dt_bias=c32["dt_bias"],
                    z=c32["z"]), iters=1, warmup=0)
                log(f"    the plain backward at N = {Nw}: {w1['plain_bwd_ms']:.1f} ms")
            del c, c32, got, plain
            torch.cuda.empty_cache()

        def bwd_bound(N, T, dI, dS):
            """The backward's least work: exp(delta A) once a channel-step and
            state (and the softplus and silu), ~12 fp32 operations a state;
            x, raw dt, z and dy read and dx, ddt and dz written once (bf16),
            B, C, their gradients, the kept states and the per-channel
            leaves."""
            steps = N * T * dI
            side = (4.0 * N * T * 2 * dS * 2 + 4.0 * N * -(-T // mamba_scan.CHUNK) * dI * dS
                    + 4.0 * N * dI * (3 * dS + 3))
            return bound(flops_fp32=steps * (12 * dS + 20), exps=steps * (dS + 3),
                         nbytes=steps * 14 + side)
        times = {}
        for label, (N, T, dI, G) in (("falcon band", (12, 1024, 8192, 12)),
                                      ("jamba band", (2, 1152, 16384, 2))):
            c = scan_case(N, T, dI, dSw, G, torch.bfloat16)
            args = [c[k] for k in names[:7]]
            kw = dict(dt_bias=c["dt_bias"], z=c["z"])
            y, hT, hs = mamba_scan._mamba_scan(*args, keep=True, **kw)
            gy, gh = rnd_w(*y.shape, dtype=y.dtype), rnd_w(N, dI, dSw, scale=0.1)
            fwd = time_ms(lambda: mamba_scan._mamba_scan(*args, keep=True, **kw))
            fwd_plain = time_ms(lambda: mamba_scan._mamba_scan(*args, **kw))
            bwd_ms = time_ms(lambda: mamba_scan.mamba_scan_bwd(*args, hs, gy, gh, **kw), iters=5)
            b_ms, b_by = bwd_bound(N, T, dI, dSw)
            times[label] = dict(shape=[N, T, dI, dSw], fwd_ms=fwd, fwd_no_states_ms=fwd_plain,
                                bwd_ms=bwd_ms, bwd_bound_ms=b_ms, bwd_bound_by=b_by)
            log(f"  {label} x [{N},{T},{dI}] bf16 fused: forward keeping its states {fwd:.3f} ms "
                f"(without {fwd_plain:.3f}), backward kernel {bwd_ms:.3f} ms, its bound "
                f"{b_ms:.3f} ms ({b_by}), backward/bound {bwd_ms / b_ms:.1f}; card {smi}")
            del c, args, kw, y, hT, hs, gy, gh
            torch.cuda.empty_cache()
        w1["times"] = times
        f_band = times["falcon band"]
        bwd_row = dict(err_fp32=w1["err_fp32"], err_bf16=w1["err_bf16"],
                       control_fp32=w1["control_fp32"], control_bf16=w1["control_bf16"],
                       fwd_ms=f_band["fwd_ms"], bwd_ms=f_band["bwd_ms"],
                       bwd_bound_ms=f_band["bwd_bound_ms"], plain_bwd_ms=w1["plain_bwd_ms"],
                       plain_bwd_rows=Nw, shape=f_band["shape"], jamba=times["jamba band"],
                       route="cuda", source="src/repro_torch/kernels/csrc/mamba_scan_bwd.cu")
        row["w1"] = w1

        # (w2) fp32, B = 1, 2 segments: the kernels against the plain path
        trng = np.random.default_rng(SEED + 12)

        def leaf_grads(p, c, batch, **kw):
            leaves = [t.detach().requires_grad_() for t in tree_leaves(p)]
            loss = M.lm_loss(tree_unflatten(p, leaves), c, batch["tokens"], batch["labels"],
                             enc_frames=batch.get("enc_frames"), **kw)
            gs = torch.autograd.grad(loss, leaves, allow_unused=True)
            return loss.detach(), [torch.zeros_like(t) if g is None else g
                                   for t, g in zip(leaves, gs)]

        real_route = moe_mod.route
        records = []

        def recording_route(*a, **k):
            r = real_route(*a, **k)
            records.append((r.eidx.clone(), r.keep.clone()))
            return r

        def routes_of(fn):
            records.clear()
            moe_mod.route = recording_route
            try:
                with torch.no_grad():
                    fn()
                sync()
            finally:
                moe_mod.route = real_route
            return list(records)

        def routing_code(rec, E):
            eidx, keep = rec
            return torch.zeros(eidx.shape[:2] + (E,), dtype=torch.int8, device=dev).scatter_(
                2, eidx, (1 + keep).to(torch.int8))

        def batch_of(cfg, n_tok, frames=False, dtype=torch.float32):
            b = next(lm_stream(cfg.vocab, 1, n_tok, seed=SEED + 12))
            b = to_device(b, dev)
            if frames:
                b["enc_frames"] = rnd_w(1, cfg.encoder.n_frames, cfg.d_model, dtype=dtype)
            return b

        def layer_of(name, layout):
            """(layer index, stacked) of a leaf path: prelude/j -> j; pattern/p
            -> its layers n_prelude + p + P j (stacked over j); None for the
            leaves of no layer."""
            parts = name.split("/")
            if parts[0] == "prelude":
                return int(parts[1]), False
            if parts[0] == "pattern":
                return int(parts[1]), True
            return None, False

        # the leaves whose two schedules on the kernels may differ by more
        # than half the tolerance: whisper's memory projections, whose
        # gradients are small differences of nearly equal terms
        # (tools/grad_gap.py whisper-medium). Every leaf is held within
        # max(tol, 3x that difference), at most 10x tol; any other leaf's
        # difference above half the tolerance fails.
        loose = {"whisper-medium": ("pattern/0/mem/wk", "pattern/0/mem/wq")}
        w2 = {}
        plan2 = [("falcon-mamba-7b", dict(n_layers=2), "pattern/0/mixer/out_proj"),
                 ("qwen2-moe-a2.7b", dict(n_layers=2), "pattern/0/attn/wo"),
                 ("whisper-medium", {}, "pattern/0/attn/wo"),
                 ("jamba-1.5-large-398b", None, "pattern/0/attn/wo")]
        for arch, cut, control_leaf in plan2:
            t0 = time.perf_counter()
            cfg = (replace(get_smoke_config(arch), dtype="float32") if cut is None
                   else replace(get_config(arch), dtype="float32", **cut))
            layout = StackLayout.from_config(cfg)
            p = M.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
            pnames = [n for n, _ in tree_flatten_with_path(p)]
            seg = M.segment_len(cfg)
            batch = batch_of(cfg, 2 * seg, frames=cfg.encoder is not None)
            (kern, n_k) = counted_w(lambda: leaf_grads(p, cfg, batch, schedule="diagonal"))
            # the sequential schedule on the kernels: the same math rounded
            # otherwise (the batched backward products, a band against one
            # layer), so each leaf's difference is its rounding floor
            kseq = leaf_grads(p, cfg, batch, schedule="sequential")
            loss_bits = same_bits(kern[0], kseq[0])
            with swap.plain_versions():
                plain = leaf_grads(p, cfg, batch, schedule="sequential", fused=False)
            # routing flips between the kernels and the plain path, at each
            # (segment, MoE layer) in the sequential order both run
            flips, first_flip = None, None
            if cfg.moe is not None:
                moe_layers = [j for j, t in enumerate(cfg.layer_types)
                              if t in ("attn_moe", "mamba_moe")]
                rk = routes_of(lambda: M.forward_hidden(p, cfg, batch["tokens"],
                                                        schedule="sequential", eager=True,
                                                        enc_frames=batch.get("enc_frames")))
                with swap.plain_versions():
                    rp = routes_of(lambda: M.forward_hidden(
                        p, cfg, batch["tokens"], schedule="sequential", fused=False,
                        enc_frames=batch.get("enc_frames")))
                E = cfg.moe.n_experts
                per = [(routing_code(a, E) != routing_code(b, E)).any(-1) for a, b in zip(rk, rp)]
                n_tok = sum(int(f.numel()) for f in per)
                n_flip = sum(int(f.sum()) for f in per)
                flips = n_flip / max(1, n_tok)
                flipped = [moe_layers[i % len(moe_layers)] for i, f in enumerate(per) if f.any()]
                first_flip = min(flipped) if flipped else None
                if len(rk) != len(rp) or len(rk) != 2 * len(moe_layers):
                    failures.append(f"(w2) {arch}: routing records {len(rk)} / {len(rp)}")
            scale_g = max(g.double().norm().item() for g in plain[1])

            floor = {n: rel_err(a.float(), b.float()) for n, a, b, c in
                     zip(pnames, kern[1], kseq[1], plain[1])
                     if c.double().norm().item() > 1e-6 * scale_g}
            limit = {n: min(max(leaf_tol, 3 * f), 10 * leaf_tol) for n, f in floor.items()}
            off_floor = sorted(n for n, f in floor.items()
                               if f > leaf_tol / 2 and n not in loose.get(arch, ()))

            def gated(name):
                """The leaves (or stacked layer slices) the gate holds: every
                one, and with routing flips only the layers before the first
                flipped MoE layer."""
                if first_flip is None:
                    return [slice(None)]
                pos, stacked = layer_of(name, layout)
                if pos is None:
                    return []
                if not stacked:
                    return [slice(None)] if pos < first_flip else []
                P = len(layout.pattern)
                return [j for j in range(layout.n_super)
                        if len(layout.prelude) + pos + P * j < first_flip]

            def leaf_errs(grads):
                """{held leaf: (rel err, its limit)}; a leaf whose plain
                gradient is zero in exact arithmetic (a key bias: softmax
                ignores a shift of a query's scores) is held to that zero, its
                norm over 1e-6 of the largest gradient's counted as its error
                over 1e-3."""
                errs = {}
                for n, a, b in zip(pnames, grads, plain[1]):
                    for sl in gated(n):
                        key = n if sl == slice(None) else f"{n}[{sl}]"
                        if n not in limit:
                            errs[key] = (a[sl].double().norm().item() / (1e-6 * scale_g)
                                         * leaf_tol, leaf_tol)
                        else:
                            errs[key] = (rel_err(a[sl].float(), b[sl].float()), limit[n])
                return errs

            def over(errs):
                return {k: e / lim for k, (e, lim) in errs.items()}
            l_err = abs(kern[0].item() - plain[0].item()) / abs(plain[0].item())
            errs = leaf_errs(kern[1])
            worst = max(errs, key=over(errs).get) if errs else None
            ok = (l_err <= loss_tol and bool(errs) and max(over(errs).values()) <= 1
                  and not off_floor and loss_bits and math.isfinite(kern[0].item()))
            largest = ", ".join(
                f"{n} {errs[n][0]:.1e} (limit {errs[n][1]:.1e}; schedules "
                f"{floor.get(n.split('[')[0], 0):.1e})"
                for n in sorted(errs, key=over(errs).get, reverse=True)[:3])
            loose_rows = {n: dict(schedules=floor[n], limit=limit[n],
                                  held=errs.get(n, (None,))[0],
                                  norm_over_largest=plain[1][pnames.index(n)].double().norm()
                                  .item() / scale_g)
                          for n in loose.get(arch, ()) if n in floor}
            # the control: layer 0's output projection x0.98
            i_c = pnames.index(control_leaf)
            leaves = list(tree_leaves(p))
            wc = leaves[i_c].clone()
            wc[0] *= 0.98
            leaves[i_c] = wc
            ctl = leaf_grads(tree_unflatten(p, leaves), cfg, batch, schedule="diagonal")
            l_c = abs(ctl[0].item() - plain[0].item()) / abs(plain[0].item())
            errs_c = over(leaf_errs(ctl[1]))
            worst_c = max(errs_c.values()) if errs_c else 0.0
            control_ok = l_c > loss_tol or worst_c > 1
            need = (["mamba_scan", "mamba_scan_bwd"] if cfg.ssm is not None else []) + (
                ["grouped_matmul", "flash_attention", "armt_read", "armt_update"]
                if cfg.armt is not None else [])
            missing = [k for k in need if n_k[k] == 0]
            log(f"  (w2) {arch} fp32 ({cfg.n_layers} layers, d {cfg.d_model}), B = 1, 2 segments "
                f"of {seg}: loss {kern[0].item():.6f} vs plain {plain[0].item():.6f} rel "
                f"{l_err:.2e} (tol {loss_tol:g}); worst leaf {worst} "
                f"{errs[worst][0] if errs else 0.0:.2e} (limit max({leaf_tol:g}, 3x the "
                f"schedules' difference), at most {10 * leaf_tol:g}; {len(errs)} held; largest "
                f"over their limits "
                f"{largest}; diagonal vs sequential on the kernels, worst "
                f"{max(floor.values()):.1e}, above {leaf_tol / 2:g} outside "
                f"{list(loose.get(arch, ()))}: {off_floor}; named leaves {loose_rows}"
                + (f", routing flips {flips:.4%} of tokens, first flipped MoE layer "
                   f"{first_flip}: only the layers before it gated" if first_flip is not None
                   else (f", routing flips {flips:.4%}" if flips is not None else ""))
                + f"); diagonal = sequential loss bits {loss_bits}; control (layer 0's "
                f"{control_leaf} x0.98) loss rel {l_c:.2e}, worst leaf {worst_c:.2f}x its limit "
                f"-> "
                f"{'fails as it must' if control_ok else 'PASSES'}; launches {n_k} -> "
                f"{'ok' if ok and control_ok and not missing else 'FAIL'} "
                f"({time.perf_counter() - t0:.1f} s)")
            if not ok:
                failures.append(f"(w2) {arch} fp32 kernels vs plain"
                                + (f"; schedules differ on {off_floor}" if off_floor else "")
                                + ("" if errs else "; no leaf held"))
            if not control_ok:
                failures.append(f"(w2) {arch} control passed")
            if missing:
                failures.append(f"(w2) {arch}: {missing} never launched")
            w2[arch] = dict(layers=cfg.n_layers, loss_rel_err=l_err, worst_leaf=worst,
                            worst_leaf_rel_err=errs[worst][0] if errs else None,
                            worst_leaf_limit=errs[worst][1] if errs else None,
                            leaves_held=len(errs),
                            schedules_worst_leaf_rel_diff=max(floor.values()),
                            schedules_above_half_tol_unnamed=off_floor, named_leaves=loose_rows,
                            route_flip_share=flips, first_flipped_moe_layer=first_flip,
                            loss_bitwise_diag_seq=loss_bits, control_loss_rel_err=l_c,
                            control_worst_leaf_over_limit=worst_c, launches=n_k,
                            seconds=time.perf_counter() - t0)
            del p, kern, kseq, plain, ctl, leaves, wc, batch
            torch.cuda.empty_cache()
        row["w2"] = w2

        # (w3) bf16, 4 segments, B = 1, 12 steps on one repeated batch
        ocfg = OptimConfig(lr=1e-3, warmup_steps=2, total_steps=12)
        ckpt = ROOT / "build" / "chip_smoke_train_families_ckpt"
        shutil.rmtree(ckpt, ignore_errors=True)

        def repeated(batch):
            while True:
                yield dict(batch)

        def trend(ls):
            return float(np.mean(ls[:3])), float(np.mean(ls[-3:]))
        w3 = {}
        plan3 = [("falcon-mamba-7b", dict(n_layers=12)), ("qwen2-moe-a2.7b", dict(n_layers=3)),
                 ("whisper-medium", {})]
        for arch, cut in plan3:
            t0 = time.perf_counter()
            cfg = replace(get_config(arch), **cut)
            seg = M.segment_len(cfg)
            host = next(lm_stream(cfg.vocab, 1, 4 * seg, seed=SEED + 13))
            torch.cuda.reset_peak_memory_stats(dev)
            if arch == "falcon-mamba-7b":
                def loop(steps, **kw):
                    return train_loop(cfg, ocfg, repeated(host), steps=steps, schedule="diagonal",
                                      device=dev,
                                      generator=torch.Generator(device=dev).manual_seed(SEED),
                                      **kw)
                out, n_k = counted_w(lambda: loop(12))
                hist = out["history"]
                losses = [h["loss"] for h in hist]
                step_times = [h["step_time_s"] for h in hist]
                skipped = [h["step"] for h in hist if h["skipped"]]
                n_par = sum(t.numel() for t in tree_leaves(out["state"]["params"]))
                del out
            else:
                state = init_train_state(cfg, ocfg, torch.Generator(device=dev).manual_seed(SEED),
                                         device=dev)
                n_par = sum(t.numel() for t in tree_leaves(state["params"]))
                batch = to_device(host, dev)
                if cfg.encoder is not None:
                    batch["enc_frames"] = rnd_w(1, cfg.encoder.n_frames, cfg.d_model,
                                                dtype=torch.bfloat16)
                step = make_train_step(cfg, ocfg, schedule="diagonal")

                def steps12():
                    nonlocal state
                    out = []
                    for _ in range(12):
                        t1 = time.perf_counter()
                        state, m = step(state, batch)
                        m = {k: float(v) for k, v in m.items()}
                        out.append((m, time.perf_counter() - t1))
                    return out
                hist, n_k = counted_w(steps12)
                losses = [m["loss"] for m, _ in hist]
                step_times = [t for _, t in hist]
                skipped = [i for i, (m, _) in enumerate(hist) if m["skipped"]]
                del state, batch
            peak = torch.cuda.max_memory_allocated(dev) / 1e9
            step_s = float(np.median(step_times[1:]))
            first3, last3 = trend(losses)
            learned = last3 < first3 and not skipped
            need = (["mamba_scan", "mamba_scan_bwd"] if cfg.ssm is not None else
                    ["grouped_matmul", "flash_attention", "armt_read", "armt_update"])
            missing = [k for k in need if n_k[k] == 0]
            simt = {k: v["simt"] for k, v in read_routes().items()}
            log(f"  (w3) {arch} bf16, {cfg.n_layers} layers ({n_par / 1e9:.3f} B parameters), "
                f"B = 1, 4 segments of {seg}: losses {['%.4f' % l for l in losses]}; skipped "
                f"{skipped}; first 3 {first3:.4f}, last 3 {last3:.4f} -> "
                f"{'ok' if learned else 'FAIL'}; step {step_s:.3f} s median of steps 1-11 "
                f"(first {step_times[0]:.2f} s), {4 * seg / step_s:.0f} tokens/s, peak "
                f"{peak:.2f} GB; launches {n_k}, SIMT {simt}; card {smi}")
            if not learned:
                failures.append(f"(w3) {arch}: the loss did not fall")
            if missing:
                failures.append(f"(w3) {arch}: {missing} never launched")
            if any(simt.values()):
                failures.append(f"(w3) {arch}: a SIMT GEMM or flash launched in bf16")
            if peak > 75:
                failures.append(f"(w3) {arch}: peak {peak:.1f} GB above 75")
            w3[arch] = dict(layers=cfg.n_layers, params_b=n_par / 1e9, losses=losses,
                            skipped=skipped, first3=first3, last3=last3, step_s=step_s,
                            step_times_s=step_times, tokens_per_s=4 * seg / step_s,
                            peak_gb=peak, launches=n_k)
            if arch == "falcon-mamba-7b":
                t1 = time.perf_counter()
                loop(6, ckpt_dir=str(ckpt), ckpt_every=6, keep=1)
                resumed = loop(12, ckpt_dir=str(ckpt), ckpt_every=6, keep=1)
                t_ckpt = time.perf_counter() - t1
                r_losses = [h["loss"] for h in resumed["history"]]
                r_steps = [h["step"] for h in resumed["history"]]
                r_err = max(abs(a - b) / abs(b) for a, b in zip(r_losses, losses[6:]))
                r_bits = r_losses == losses[6:]
                ok = r_steps == list(range(6, 12)) and r_err <= 1e-3
                log(f"  falcon train_loop resumed at step {r_steps[0] if r_steps else None} from "
                    f"the step-6 checkpoint: losses {['%.4f' % l for l in r_losses]}; largest "
                    f"rel difference {r_err:.3e} (tol 1e-3), to the bit {r_bits} -> "
                    f"{'ok' if ok else 'FAIL'} (both runs with save and restore "
                    f"{t_ckpt:.1f} s)")
                if not ok:
                    failures.append("(w3) falcon resumed losses")
                w3[arch].update(resumed_losses=r_losses, resumed_rel_err=r_err,
                                resumed_bitwise=r_bits, ckpt_runs_s=t_ckpt)
                del resumed
                shutil.rmtree(ckpt, ignore_errors=True)
            w3[arch]["seconds"] = time.perf_counter() - t0
            M.SegmentProgram._cache.clear()
            torch.cuda.empty_cache()
        row["w3"] = w3
        bwd_row["launches"] = launches.get("mamba_scan_bwd", 0)
        row["phase_s"] = time.perf_counter() - t_phase
        log(f"  (w) {row['phase_s']:.1f} s; launches over (w2) and (w3) {launches}")
        return launches, routes, bwd_row, row

    launches_families, routes_families, scan_bwd_row, families_row = train_families_phase()
    backward_rows["mamba_scan"] = scan_bwd_row
    print(json.dumps({"train_families": families_row, "card": smi}))

    # ------------------------------------------------------------ (f) falcon-mamba model
    log("== model phase: falcon-mamba-7b, full width and depth, bf16, seed 0 on the card")
    fcfg = get_config("falcon-mamba-7b")
    t0 = time.perf_counter()
    # drawn on the card from the seed (seconds; the CPU generator took ~70 s
    # for the 7.27 B normals)
    fparams = M.init_params(fcfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    sync()
    n_par = sum(t.numel() for t in M.Model(fcfg, fparams).buffers())
    log(f"  init_params: {n_par / 1e9:.3f} B parameters in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    fseg, L = M.DEFAULT_SEG_LEN, fcfg.n_layers
    ftoks = torch.from_numpy(rng.integers(0, fcfg.vocab, (1, 16 * fseg))).to(dev)

    def frun(schedule, tk, p=None):
        """hidden [S,1,T,D], every layer's final h [L,1,dI,dS], last-token
        logits per segment [S,1,V]."""
        p = fparams if p is None else p
        with torch.no_grad():
            # the sequential schedule on the plain block, which runs the
            # scan kernel: the path whose bits the falcon checks hold
            h, fin = M.forward_hidden(p, fcfg, tk, schedule=schedule,
                                      fused=schedule == "diagonal")
            return h, fin["pattern"][0]["h"], seg_logits(p, fcfg, h)

    tol_mamba = 5e-2

    def mamba_errors(got, want, tol=tol_mamba):
        """Per-segment rel err of the hidden states (every position) and of
        the last-token logits, per-layer rel err of the final h; within tol
        and finite?"""
        (hd, Hd, ld), (hs, Hs, ls) = got, want
        errs = {"hidden": [rel_err(hd[i], hs[i]) for i in range(hd.shape[0])],
                "logits": [rel_err(ld[i], ls[i]) for i in range(ld.shape[0])],
                "h": [rel_err(Hd[j], Hs[j]) for j in range(Hd.shape[0])]}
        finite = all(torch.isfinite(t).all().item() for t in (hd, Hd, ld))
        return errs, finite and max(max(v) for v in errs.values()) <= tol

    def worst(errs):
        return ", ".join(f"{k} {max(v):.3e}" for k, v in errs.items())

    frun("diagonal", ftoks[:, :2 * fseg])           # warm-up
    sync()
    reset_counts()
    t0 = time.perf_counter()
    diag16 = frun("diagonal", ftoks)
    sync()
    t_fdiag = time.perf_counter() - t0
    prefill_launches = mamba_scan.launches
    t0 = time.perf_counter()
    seq16 = frun("sequential", ftoks)
    sync()
    t_fseq = time.perf_counter() - t0
    errs, ok = mamba_errors(diag16, seq16)
    log(f"  16-segment prefill ({16 * fseg} tokens): diagonal on kernels {t_fdiag:.3f} s, "
        f"sequential on kernels {t_fseq:.3f} s; mamba_scan launches in the diagonal "
        f"prefill {prefill_launches} (S + L - 1 = {16 + L - 1})")
    log(f"  rel err per segment, hidden {' '.join(f'{e:.1e}' for e in errs['hidden'])}; "
        f"logits {' '.join(f'{e:.1e}' for e in errs['logits'])}; worst layer h "
        f"{max(errs['h']):.3e} (tol {tol_mamba:g}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("falcon-mamba 16-segment diagonal vs sequential")
    if prefill_launches != 16 + L - 1:
        failures.append(f"falcon-mamba prefill launched mamba_scan {prefill_launches} times")
    del diag16, seq16
    st1 = M.decode_state_init(fcfg, 1, dtype=torch.bfloat16, device=dev)
    reset_counts()
    with torch.no_grad():
        M.decode_step(fparams, fcfg, st1, ftoks[:, 0])
    log(f"  mamba_scan launches per decoded token: {mamba_scan.launches} (layers {L})")
    if mamba_scan.launches != L:
        failures.append(f"falcon-mamba decode step launched mamba_scan {mamba_scan.launches} "
                        "times")
    del st1

    # 2 segments against the sequential plain path (the scan as a Python
    # loop over T, the rest the same PyTorch ops). In bf16 the comparison
    # measures the stack's rounding, not the kernel: 64 random-init layers
    # in bf16 turn any perturbation, 1e-6 of the scan's output included,
    # into ~5e-2 of the hidden states (PERF.md §6). So in bf16 it is printed
    # beside that floor (the kernel path against itself with the scan's D
    # scaled by 1 + 1e-6, which moves y before the kernel rounds it to
    # bf16), and it is gated in fp32, on the same weights at full width and
    # depth, at 1e-3, with two negative controls on the kernel path that
    # must fail it: dt x~1.02 into the scan (dt_bias + log 1.02: softplus(u
    # + log 1.02) is 1.02 softplus(u) to within 1 % at the model's bias of
    # -4.6), the scan's output x0.98 (in fp32, y x0.98 before the gate).
    two = ftoks[:, :2 * fseg]
    scan = ops.mamba_scan

    def scaled_D(f):
        def fn(x, dt, Bt, Ct, A_log, D, h0, **k):
            return scan(x, dt, Bt, Ct, A_log, f * D, h0, **k)
        return fn

    def scaled_out(*a, **k):
        y, hT = scan(*a, **k)
        return 0.98 * y, hT

    def dt_scaled(*a, dt_bias, **k):
        return scan(*a, dt_bias=dt_bias + math.log(1.02), **k)
    # (the informational bf16 comparison over the first segment only: the
    # plain scan is a token loop, ~12 s a segment)
    one = ftoks[:, :fseg]
    t0 = time.perf_counter()
    with swap.plain_versions():
        plain2 = frun("sequential", one)
    sync()
    t_plain2 = time.perf_counter() - t0
    diag2 = frun("diagonal", one)
    errs, _ = mamba_errors(diag2, plain2)
    with swap.replaced(mamba_scan=scaled_D(1 + 1e-6)):
        floor, _ = mamba_errors(frun("diagonal", one), diag2)
    log(f"  bf16, 1 segment ({t_plain2:.1f} s plain): diagonal on kernels vs sequential "
        f"plain, worst rel err {worst(errs)}; the bf16 floor, kernels vs themselves with "
        f"the scan's D x(1 + 1e-6): {worst(floor)} (not gated)")
    del plain2, diag2
    torch.cuda.empty_cache()
    fp32 = M._tree_map(lambda path, t: t.float(), fparams)
    with swap.plain_versions():
        plain32 = frun("sequential", two, fp32)
    tol32 = 1e-3
    errs, ok = mamba_errors(frun("diagonal", two, fp32), plain32, tol32)
    log(f"  fp32 weights, 2 segments: diagonal on kernels vs sequential plain, worst rel err "
        f"{worst(errs)} (tol {tol32:g}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("falcon-mamba fp32 2-segment diagonal vs sequential plain")
    for label, fn in [("dt x~1.02 into the scan (dt_bias + log 1.02)", dt_scaled),
                      ("scan output x0.98", scaled_out)]:
        with swap.replaced(mamba_scan=fn):
            errs, passed = mamba_errors(frun("diagonal", two, fp32), plain32, tol32)
        log(f"  negative control, fp32, {label}: worst rel err {worst(errs)} -> "
            f"{'FAIL: not caught' if passed else 'caught, ok'}")
        if passed:
            failures.append(f"falcon-mamba check blind to {label}")
    del fp32, plain32
    torch.cuda.empty_cache()

    fsmoke = get_smoke_config("falcon-mamba-7b")
    fsp = M.init_params(fsmoke, SEED, device="cpu")
    fsp_gpu = M.Model(fsmoke, fsp).to(dev).tree()
    stoks = rng.integers(0, fsmoke.vocab, (2, 3 * 16))
    outs = []
    for p_, where in ((fsp_gpu, dev), (fsp, "cpu")):
        with torch.no_grad():
            h, fin = M.forward_hidden(p_, fsmoke, torch.from_numpy(stoks).to(where), seg_len=16)
        outs.append([t.cpu() for t in (h, fin["pattern"][0]["h"], M.last_logits(p_, fsmoke, h))])
    rel32 = max(rel_err(a, b) for a, b in zip(*outs))
    ok = rel32 <= 1e-4
    log(f"  smoke config (fp32), 3 segments, diagonal: card kernels vs CPU plain path, worst "
        f"rel err of hidden, h, logits {rel32:.3e} (tol 1e-4) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("falcon-mamba smoke card vs cpu")

    # ------------------------------------------------------------ (g) falcon-mamba generate
    log("== generate phase: falcon-mamba-7b, ServeEngine(max_len=8192).generate, greedy")
    feng = ServeEngine(fparams, fcfg, max_len=8192)
    feng_eager = ServeEngine(fparams, fcfg, max_len=8192, eager=True)
    flaunch_gen = {}
    for B, plen, new in [(1, 2 * 8192 + 1000, 48), (2, 8192 + 500, 32)]:
        prompts = rng.integers(0, fcfg.vocab, (B, plen))
        res, n, _ = counted(lambda: feng.generate(prompts, new))
        again, ng, _ = counted(lambda: feng.generate(prompts, new, keep=True))
        flaunch_gen = merged(merged(flaunch_gen, n), ng)
        good = (res.finite and res.tokens.shape == (B, new)
                and res.tokens.min() >= 0 and res.tokens.max() < fcfg.vocab)
        log(f"  B={B} prompt {plen} new {new}: TTFT {res.ttft_s:.3f} s, decode "
            f"{res.tok_s:.1f} tok/s (capture {res.capture_s:.3f} s before the prefill); "
            f"again on the captured graphs: TTFT {again.ttft_s:.3f} s, {again.tok_s:.1f} tok/s; "
            f"logits finite {res.finite} -> {'ok' if good else 'FAIL'}; card {smi}")
        for b in range(B):
            log(f"    tokens[{b}]: {res.tokens[b].tolist()}")
        if not good:
            failures.append(f"falcon-mamba generate B={B}")
        same = bool((again.tokens == res.tokens).all())
        log(f"  B={B} repeated: tokens equal {same}")
        if not same:
            failures.append(f"falcon-mamba generate B={B} not reproducible")
        fe, ne, _ = counted(lambda: feng_eager.generate(prompts, new, keep=True))
        log(f"  B={B} eager: TTFT {fe.ttft_s:.3f} s, decode {fe.tok_s:.1f} tok/s")
        check_generate(f"falcon-mamba generate B={B}", again, fe, ng, ne,
                       graph_tok_s=again.tok_s, eager_tok_s=fe.tok_s,
                       graph_ttft_s=again.ttft_s, eager_ttft_s=fe.ttft_s)
        del again, fe
        if B == 1:
            steps = {"graph": step_times(feng.program(1), False),
                     "eager": step_times(feng_eager.program(1), True)}
            log(f"  one decode step at B=1: graph span {steps['graph']['span_ms']:.3f} ms, "
                f"device {steps['graph']['device_ms']:.3f} ms; eager span "
                f"{steps['eager']['span_ms']:.3f} ms, device {steps['eager']['device_ms']:.3f} "
                f"ms; card {smi}")
            graph_phase["falcon-mamba decode step B=1"] = steps
    log(f"  launches in the falcon-mamba generate phase: {flaunch_gen}")
    for name in falcon_kernels:
        if flaunch_gen[name] == 0:
            failures.append(f"{name} never launched by falcon-mamba generate")
    fsp_eng = (ServeEngine(fsp_gpu, fsmoke, max_len=32),
               ServeEngine(fsp, fsmoke, device="cpu", max_len=32))
    for B in (1, 2):
        prompts = rng.integers(0, fsmoke.vocab, (B, 3 * 32 + 5))
        on_card, on_cpu = (e.generate(prompts, 20).tokens for e in fsp_eng)
        same = bool((on_card == on_cpu).all())
        log(f"  smoke config (fp32) generate B={B}, card kernels vs CPU plain path: "
            f"tokens equal {same}")
        if not same:
            failures.append(f"falcon-mamba smoke generate B={B} card vs cpu")

    # ------------------------------------------------------------ (h) falcon-mamba serve
    log("== serve phase: falcon-mamba-7b, ServeEngine.serve, 4 slots, chunk 8, greedy")
    fspec = [(8192, 40), (2 * 8192 + 1000, 24), (9000, 32), (12000, 48), (8193, 16),
             (16384, 20)]
    freqs = [Request(i, rng.integers(0, fcfg.vocab, n), new) for i, (n, new) in enumerate(fspec)]
    feng.program(4, "serve").prepare()
    (events, t_serve), flaunch_serve, _ = counted(lambda: serve_run(feng, freqs))
    log(f"  launches in the falcon-mamba serve phase: {flaunch_serve}")
    for name in falcon_kernels:
        if flaunch_serve[name] == 0:
            failures.append(f"{name} never launched by falcon-mamba serve")
    errors = [e for e in events if isinstance(e, RequestError)]
    n_tok = len(events) - len(errors)
    log(f"  {len(freqs)} requests, {n_tok} tokens in {t_serve:.3f} s: aggregate "
        f"{n_tok / t_serve:.1f} tok/s (admission prefills included); card {smi}")
    if errors:
        failures.append(f"falcon-mamba serve rejected {errors}")
    for r in freqs:
        mine = [e for e in events if not isinstance(e, RequestError) and e.req_id == r.req_id]
        toks = [e.token for e in mine]
        first_gen = int(feng.generate(r.prompt[None], 1).tokens[0, 0])
        good = (len(mine) == r.max_new and mine[-1].done and bool(mine[-1].finite)
                and [e.index for e in mine] == list(range(r.max_new))
                and toks[0] == first_gen)
        log(f"  request {r.req_id} (prompt {len(r.prompt)}, new {r.max_new}): TTFT "
            f"{mine[0].ttft_s:.3f} s, {len(mine)} tokens, finite {mine[-1].finite}, first "
            f"token {toks[0]} vs B=1 generate {first_gen} -> {'ok' if good else 'FAIL'}")
        if not good:
            failures.append(f"falcon-mamba serve request {r.req_id}")
    (e_events, t_eserve), ne, _ = counted(lambda: serve_run(feng_eager, freqs))
    log(f"  eager: {n_tok} tokens in {t_eserve:.3f} s, {n_tok / t_eserve:.1f} tok/s")
    check_graph("falcon-mamba serve, 6 requests on 4 slots", {
        "every request's events equal": streams(events) == streams(e_events)},
        flaunch_serve, ne, graph_tok_s=n_tok / t_serve, eager_tok_s=n_tok / t_eserve)
    # (o6) falcon-mamba: phase (h)'s run is interleaved (k = 4); blocking
    # and a fused k = 4 run beside it, every request's events equal
    (fb_events, t_fblock), _, _ = counted(lambda: serve_run(feng, freqs,
                                                            prefill_groups_per_chunk=0))
    (ff_events, t_ffused), flaunch_inter, froutes_inter = counted(
        lambda: serve_run(feng, freqs, fused_admission=True))
    fblock = by_req(fb_events)
    ok = by_req(events) == fblock and by_req(ff_events) == fblock
    log(f"  falcon-mamba serve k=4 (phase (h)) and k=4 fused vs blocking: every request's "
        f"events equal {ok}; {n_tok / t_serve:.1f} / {n_tok / t_ffused:.1f} tok/s, blocking "
        f"{n_tok / t_fblock:.1f}; launches of the fused run {flaunch_inter} -> "
        f"{'ok' if ok else 'FAIL'}; card {smi}")
    if not ok:
        failures.append("falcon-mamba interleaved serve vs blocking")
    for name in falcon_kernels:
        if flaunch_inter[name] == 0:
            failures.append(f"{name} never launched by falcon-mamba interleaved serve")
    interleave_falcon = {"events_equal_blocking": ok, "tok_s_k4": n_tok / t_serve,
                         "tok_s_k4_fused": n_tok / t_ffused, "tok_s_blocking": n_tok / t_fblock}
    print(json.dumps({"interleave_falcon": interleave_falcon, "card": smi}))
    del fb_events, ff_events
    def falcon_session_phase(new=32):
        """(p4) a falcon-mamba session (turn 1 of 2 x max_len + 1000 tokens),
        in memory against spilled, and the resume against re-prefilling the
        history. -> (summary, launches)."""
        import tempfile
        from repro_torch.serve import SessionStore
        t_phase = time.perf_counter()
        V = feng.cfg.vocab
        turn1, turn2 = 2 * feng.max_len + 1000, 500
        log(f"== (p4) falcon-mamba-7b session: turn 1 {turn1} tokens, turn 2 {turn2}")
        turns = [rng.integers(0, V, turn1), rng.integers(0, V, turn2)]
        runs = []
        launches = {}
        with tempfile.TemporaryDirectory() as spill:
            for store in (SessionStore(max_bytes=8 << 30),
                          SessionStore(max_bytes=1, spill_dir=spill)):
                feng.session_store = store
                res, n, _ = counted(lambda: [feng.generate(t[None], new, session_id="f", keep=True)
                                             for t in turns])
                launches = merged(launches, n)
                runs.append(res)
            spills = feng.session_store.stats.as_dict()
        feng.session_store = None
        same = all(np.array_equal(a.tokens, b.tokens) and same_bits(a.logits, b.logits)
                   and same_state(a.state, b.state) for a, b in zip(*runs))
        hist = np.concatenate([turns[0], runs[0][0].tokens[0], turns[1]])
        ref = feng.generate(hist[None], new)
        out = dict(spilled_equals_in_memory=same, spills=spills["spills"],
                   ttft_resumed_s=runs[0][1].ttft_s, ttft_reprefill_s=ref.ttft_s,
                   tokens_equal_history=bool(np.array_equal(runs[0][1].tokens, ref.tokens)))
        log(f"  spilled and restored ({spills['spills']} spills, {spills['restores']} restores) "
            f"vs in memory: tokens, logits, h and the bf16 conv tail to the bit {same} -> "
            f"{'ok' if same else 'FAIL'}; TTFT resumed {runs[0][1].ttft_s:.4f} s vs re-prefill "
            f"of the {len(hist)}-token history {ref.ttft_s:.4f} s (tokens equal "
            f"{out['tokens_equal_history']}); phase {time.perf_counter() - t_phase:.1f} s; "
            f"card {smi}")
        if not same:
            failures.append("falcon-mamba session: spilled differs from in memory")
        return out, launches

    stores_falcon, launches_fsess = falcon_session_phase()
    for name in falcon_kernels:
        if launches_fsess[name] == 0:
            failures.append(f"{name} never launched by the falcon-mamba session runs")
    print(json.dumps({"stores_falcon": stores_falcon, "card": smi}))
    del feng, feng_eager, fparams, events, e_events
    torch.cuda.empty_cache()
    fsreqs = [Request(i, rng.integers(0, fsmoke.vocab, n), new)
              for i, (n, new) in enumerate([(40, 9), (70, 14), (5, 20), (96, 6), (33, 11)])]

    def fserved(eng):
        out = {}
        for e in eng.serve(fsreqs, n_slots=2, chunk=4):
            out.setdefault(e.req_id, []).append(getattr(e, "token", e))
        return out
    on_card, on_cpu = (fserved(e) for e in fsp_eng)
    same = on_card == on_cpu and all(len(on_card[i]) == r.max_new for i, r in enumerate(fsreqs))
    log(f"  smoke config (fp32) serve, 5 requests on 2 slots, card kernels vs CPU plain "
        f"path: tokens equal {same}")
    if not same:
        failures.append("falcon-mamba smoke serve card vs cpu")

    print(json.dumps({"graphs": graph_phase, "card": smi}))
    if failures:
        log(f"FAILED: {failures}")
        return 1

    sources = {"grouped_matmul": ("src/repro_torch/kernels/csrc/grouped_matmul.cu",
                                  "src/repro/kernels/grouped_matmul.py:198"),
               "grouped_matmul_armt_update": ("src/repro_torch/kernels/csrc/grouped_matmul.cu",
                                              "src/repro/kernels/grouped_matmul.py:114"),
               "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                                    "src/repro/kernels/decode_attention.py:67"),
               "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:89"),
               "armt_read": ("src/repro_torch/kernels/csrc/armt_memory.cu + "
                             "src/repro_torch/kernels/csrc/grouped_matmul.cu",
                             "src/repro/kernels/armt_memory.py:67"),
               "armt_update": ("src/repro_torch/kernels/csrc/armt_memory.cu",
                               "src/repro/kernels/armt_memory.py:114"),
               "mamba_scan": ("src/repro_torch/kernels/csrc/mamba_scan.cu",
                              "src/repro/kernels/mamba_scan.py:44")}
    # the runs of each model's paths, each read from counts set to 0 just
    # before it: llama's generate and serve ('armt' mode), its full-mode
    # forward and cache-mode generate and serve, its interleaved serve, its
    # prefix-cache and session runs; falcon's generate, serve, interleaved
    # serve and session runs
    llama_paths = {"generate": launches_gen, "serve": launches_serve,
                   "full_forward": launches_full, "cache_generate": launches_cgen,
                   "cache_serve": launches_cserve, "serve_interleaved": launches_inter,
                   "prefix_cache": launches_prefix, "sessions": launches_sess,
                   "dense_configs": launches_dense, "moe_configs": launches_moe,
                   "jamba": launches_jamba, "whisper": launches_whisper,
                   "train": launches_train, "train_families": launches_families}
    llama_routes = {"generate": routes_gen, "serve": routes_serve, "full_forward": routes_full,
                    "cache_generate": routes_cgen, "cache_serve": routes_cserve,
                    "serve_interleaved": routes_inter, "prefix_cache": routes_prefix,
                    "sessions": routes_sess, "dense_configs": routes_dense,
                    "moe_configs": routes_moe, "jamba": routes_jamba,
                    "whisper": routes_whisper, "train": routes_train,
                    "train_families": routes_families}
    # falcon-mamba has no prefix-cache run (its engine refuses a cache at
    # max_len 8192: its seg_len is max_len, not the model's segment), so
    # mamba_scan has no launches_prefix_cache; jamba's (t) runs every
    # kernel, so each has a launches_jamba
    falcon_paths = {"generate": flaunch_gen, "serve": flaunch_serve,
                    "serve_interleaved": flaunch_inter, "sessions": launches_fsess,
                    "jamba": launches_jamba, "train": launches_train,
                    "train_families": launches_families}
    kernels = []
    for name, (src, replaces) in sources.items():
        s = summary[name]
        paths = llama_paths if name in llama_kernels else falcon_paths
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": sum(n[name] for n in paths.values()),
                        **{f"launches_{p}": n[name] for p, n in paths.items()},
                        "max_abs_err": s["max_abs_err"],
                        "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                        "bound_by": s["bound_by"], "library_ms": s["library_ms"],
                        "shape": s["shape"]})
        kernels[-1].update({k: s[k] for k in ("unfused", "ms_by_rows", "device_launches_per_call",
                                              "layer_index") if k in s})
        # (v1): the backward's errors and times at the band's shapes (the
        # kernels off the training path have none yet)
        kernels[-1]["backward"] = backward_rows.get(name)
        if name in routed:   # every GEMM / flash launch of the llama runs, by route
            kernels[-1]["launches_by_route"] = {
                r: sum(v[name][r] for v in llama_routes.values()) for r in routes}
        if name in long_rows:
            kernels[-1]["long_shapes"] = long_rows[name]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
