#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one card.  The kernels
build from ``src/repro_torch/kernels/csrc`` at first use.  Phases (any
failure ends the run with a non-zero exit):

  1. the card (name, power limit) and the kernel build (seconds and
     registers per source);
  2. each kernel against its plain PyTorch version on the card, at the
     shapes of its path, with times of the kernel and the plain version
     beside the bound (a kernel's ms: device time a call from
     torch.profiler, every op the wrapper runs; beside it the CUDA-event
     time of back-to-back calls, which the host sets for calls of a few
     microseconds; the ELL plain versions and library calls, 0.5-15 ms,
     by CUDA events):
     - the ELL kernels at 80000 rows x 1000 slots -> 80000 posts (80% of
       slots valid; B = 1 and 8; 1% and 100% of rows spiking; 21 delay
       slots): rtol=atol=1e-5, exact with integer-valued weights, bool
       spikes (the simulator's) equal to float ones, and both bit-equal
       to their plain versions (all sum in float64); beside them
       torch.sparse.mm on the same matrix as CSR (a yardstick only: the
       port never calls it), the kernel's own device time, the atomics'
       adds/s, its ``launch_plan`` and the SASS instruction count of the
       main path's instance;
     - the dendritic ring's fold at phase 5's [1, 21, 80000] and the
       sweep's [8, 21, 80000], every member's cursor at 0, 11 and 20,
       sign +-1, a scalar and a per-member gScale: bit-equal to its plain
       version (the eager sequence it replaces, whose device time stands
       beside it), the scratch left zeroed; the bound by bytes (read ring
       and scratch, write the new ring, the zeros and the cursor's row);
       then at [8, 21, 80000] with a cursor a member, all different (as
       served streams hold them), bit-equal to its plain version at every
       block it is compiled for, and its time;
     - izhikevich_step at [1, 80000] and [8, 80000] with per-neuron a..d,
       hh_step at the mushroom body's [1, 20], [1, 100000], [1, 100] and
       [5, 100000] (dt 0.1, 5 substeps), inputs that straddle the
       threshold, each with the NaN guard's flag: rtol=atol=2e-4, spike
       decisions differ on < 0.2% of neurons, above = v >= 0, the flag
       untouched; beside each time the wrapper's host time (CUDA-event
       time less device time) and hh_step's SASS instruction count (all,
       and one substep's); no single PyTorch call computes either, so
       they have no library time;
  2c. flash_attention against its plain version on the card, with kernel,
     plain and library (torch's scaled_dot_product_attention on the same
     inputs, a yardstick only: the port never calls it) times beside the
     bound; bf16 runs on the wgmma kernels, float32 on the 3xTF32 ones
     (its bound 3 x the operations at TF32's rate, the CUDA cores'
     float32 bound beside it): the serving prefill's shape, q [8, 14,
     2048, 64] and k, v
     [8, 2, 2048, 64], bf16, causal (rtol=atol=1e-2 against the plain
     version in float32 on the same bf16 inputs); the same at B=1 in
     float32 (2e-5); gemma3's local layer, [1, 16, 2048, 256] /
     [1, 8, 2048, 256], window 1024, bf16; softcap 30, and prefix 100, at
     [1, 4, 256, 64] / [1, 2, 256, 64], in float32 and in bf16; non-causal
     ragged T=200 in both; in bf16 also q_offset 100, zamba2's D=112
     ([1, 32, 2048, 112]), D=40 (a contraction padded with zeros) and the
     prefill shape without the causal mask; paligemma's D = 256 under MQA
     8:1 with a prefix-LM span: its prefill wave [8, 8, 1024, 256] and
     training batch [2, 8, 1280, 256] with the image's 256 positions as
     the prefix, and a prefix of 200 ending inside a tile at T = 456, in
     bf16 and float32; the training example's float32 shapes, [8, 5 over
     1, 256, 64] and [8, 10 over 2, 256, 64]; for a prefix case, the SDPA
     backend that takes the explicit mask;
  2f. the threefry kernels (``threefry_split``, ``threefry_draw``)
     against their plain version on the card at the SNN paths' shapes
     (main's 5 keys a step and normal draws of 80,000 x 5.0 and 20,000 x
     2.0; mb_full's 9 keys and 100 PN uniforms), B = 1 and 8: keys, bits
     and uniforms bit-equal, normals within 4 float32 ulp; times beside
     the bound (integer operations against bytes) and, as a yardstick
     only, ``torch.randn`` at the same shape (Philox, not threefry: no
     library time); then on-device construction's entries at main's exc
     group (80,000 row keys, 1000 targets a row): ``threefry_fold_in``
     (the rows into one key; a word into each row key) and
     ``threefry_draw``'s randint draw at spans 100000, 21, 1 and 2^31 - 1
     (its launches counted as ``threefry_draw.randint``), bit-equal
     to their plain versions on the card (and the first 512 rows on the
     CPU), and the weights' affine uniform draw likewise;
  Phases 3-6b each run their model once eagerly (``Simulator.run``) and
     once through the graph route (``Simulator.run_compiled``: CUDA graphs
     of 32 steps and a remainder, which ``CompiledModel.run`` and
     ``sweep_gscale`` replay) from the same state: counts and every state
     tensor (neurons, spikes, rings, cursors, t, key, finite) bit-equal,
     the same kernel launches, and rasters bit-equal over 100 steps; they
     print eager and graph us/step, the first graph run's seconds (the
     capture), captures and replays; phases 4 and 5b replay one capture
     for two gScale grids; the phases' own runs below take the graph
     route, their comparisons with the plain versions the eager one;
  3. the main path at full width: the Izhikevich net, 100k neurons, 1000
     synapses per neuron (4 split ELL groups, ~1.8 GB), 1000 steps; its
     launch counts (4 ell_spmv, 2 izhikevich_step, 1 threefry_split and 2
     threefry_draw per step); 50 steps through the plain versions on the
     card (no kernel launched), whose raster must agree with the kernel
     run's on >= 99.8% of neuron-steps; profiles of 50 steps, eager and
     replayed (device ops a step, busy share; eagerly, the device ops a
     step that the NaN guard costs);
  4. a gScale sweep of the excitatory groups: 8 candidates (0.3 .. 1.2,
     below saturation) x 500 steps as one batch, rates non-decreasing in
     gScale, then the conductance search;
  5. the delay path at full width: the main path's net (100k neurons,
     1000 synapses each) with per-synapse delays 0..20 steps on the
     excitatory groups (21 ring slots), 200 steps through the delay
     scatter and the ring fold (2 launches of each a step); 50 steps
     through the plain versions, rasters agreeing on >= 99.8% of
     neuron-steps and the rings bit-equal; us/step beside the card; a
     profile of 50 steps as in 3;
  5b. phase 4's gScale grid on phase 5's net, one batch of 8 x 500 steps
     (2 launches of the delay scatter and the fold a step, the exc->exc
     group's float64 scratch 107.5 MB), every candidate finite, member 5
     equal spike for spike to the B = 1 run at its gScale; candidates/s and
     us/step beside the card; a profile of 50 steps;
  6a. the paper's NaN-guard table on the mushroom body at the example's
     size (24 PN / 6 LHI / 150 KC / 12 DN, dt 0.1 ms): PN_KC gScale
     0.5 .. 50 as one batch of 5 x 2500 steps; finite at 0.5 and 1, not
     finite at 50, PN within 15 Hz of 50;
  6b. the mushroom body at full width (100 PN / 20 LHI / 100k KC / 100 DN)
     with every group's gScale scaled by fan-in from the example's, 2500
     steps (3 hh_step launches per step, finite); 200 steps through the
     plain versions, rasters agreeing on >= 99.8% of neuron-steps; a
     profile as in 3; then
     the conductance search for the PN_KC gScale that gives 6a's KC rate
     at gScale 1, 12 candidates as one batch;
  7. LM serving at full width: ``Server("qwen2-0.5b", use_reduced=False,
     max_batch=8, max_seq=4096)`` (494.1M bf16 weights from a seeded
     generator, a 402.7 MB bf16 KV cache) serves 16 greedy requests, prompt
     lengths 1024..2048 from numpy's default_rng(0), 32 new tokens each, in
     two waves of 8: every request gets 32 tokens below the vocab size,
     every logit row is finite, flash_attention launches 24 x 2 = 48 times;
     a float32 copy of the weights prefills 2 prompts of 512 tokens through
     the kernel and through the plain versions, whose last-token logits
     agree within rtol=atol=1e-3 with equal argmax.  It prints prefill
     tokens/s and time to first token per wave, decode ms/step and
     tokens/s, peak device memory, and from torch.profiler the kernel's
     share of one prefill wave's device time and the card's busy share
     over 20 decode steps;
  2d. ssd_scan against its plain version (``ssd_chunked``) on the card,
     torch's TF32 off: Mamba2-2.7B's training shape, x [2, 2048, 80, 64]
     and B/C [2, 2048, 1, 128] float32, and t = 96, t = 1000, 4 and 3
     heads, within rtol=atol=2e-4; kernel and plain times beside two
     bounds, float32 on the CUDA cores and the tensor cores' (3 x the
     operations at TF32's rate: the kernel splits every operand into two
     tf32 halves), with the time before the redesign and its prediction
     (no single PyTorch call computes the scan); the count of tensor-core
     (HMMA) instructions in the built kernel; and the time of
     ``SSDScan``'s backward (autograd of ``ssd_chunked``) at the training
     shape; then the prefill form (``ssd_scan_state``: y and the state
     after the last chunk) against ``ssd_chunked(return_final_state=True)``
     within 2e-4 at mamba2's serving prefill [8, 2048, 80, 64] / 128,
     zamba2's [8, 2048, 112, 64] / 64 and t = 1037, its time beside the
     stateless kernel's and the bound (x, B, C, dt, y and the state);
  2e. the flash-attention backward against its plain version
     (``flash_attention_bwd_ref``, on the same saved tensors) and against
     autograd through ``flash_attention_ref``: Qwen2-0.5B's training
     shape, q [4, 14, 2048, 64], k/v [4, 2, 2048, 64], bf16, causal; the
     same at B=1 in float32; gemma3's local layer; the other cases of 2c
     (tolerances at FLASH_BWD_TOL); two calls bit-equal (no atomics);
     beside the
     bound, the plain backward's time and SDPA's backward
     (``torch.autograd.grad`` through ``scaled_dot_product_attention``, a
     yardstick only) with the kernels it ran;
  8a. training Qwen2-0.5B at full width and depth (24 layers, bf16
     params, float32 master copies and moments, remat): batch 4 x 2048
     from ``TokenPipeline(seed=0)``, 4 steps (the first a warm-up); each
     step 48 ``flash_attention`` and 24 ``flash_attention_bwd`` launches
     and a finite loss (the first step's printed beside 12.07, its value
     on the CUDA-core flash kernels);
     ms/step, tokens/s, model TFLOP/s (6N), peak memory, and a
     torch.profiler trace of one more step, whose flash kernels must show
     by name;
  8b. the same for Mamba2-2.7B (64 layers): batch 2 x 2048, 3 steps, 128
     ``ssd_scan`` launches a step; beside ms/step, the calls of
     ``SSDScan``'s backward a step times its time from 2d;
  8c. one training step of each, 2 layers at full width in float32, with
     the kernels and with the plain versions: losses within 1e-4, every
     gradient within rtol=1e-3 plus 1e-4 of its largest entry, and
     ``wq``/``wk``/``wv`` gradients nonzero on the card;
  9a. ``spike_bitmask`` (GeNN's 32x spike words) against its plain version
     at [1, 80000], [8, 80000], [1, 100000] and [1, 80001], bit-equal
     (bit 31 and the last neuron set), device and plain ms beside the bytes
     bound; its ring variant with a device slot and active flag;
  9b. main's net (100k x 1000, B=1, 1000 steps) with four probes ("exc"
     spikes every step, packed; "exc" V's mean; "exc" V every 25 in a
     window of 20; "inh" spikes every 10) and the health monitor (bands
     1-100 Hz), eagerly and from graphs from one state: recordings, counts,
     health and state bit-equal, the same launches but for the bitmask
     (the graph packs every step into its staging rows), the spike probes
     equal to ``record_raster``'s raster, the health totals the summed
     counts; us/step of the net with and without the observation, eager
     and replayed, in turns, and device ops a step (phase 3's, which has
     none of it, within 1 of PR 19's 33.2 / 33.9);
  9c. mb_full with ``kc_probe_every=25``, ``kc_dn_normalize=True`` (KC_DN
     on the ELL path, its g in the state) and the monitor: eager vs graph
     over 500 steps as in 9b, 2500 steps, then ``custom_update(
     "normalize_kc_dn")`` on the card within 1e-5 relative of its plain
     version and a float64 numpy oracle, every DN's total within 1e-5 of
     ``g_total``; the "post" reduction's time at KC_DN's [100000, 100]
     (one ``ell_spmv`` launch, every row live, 100 posts: contended
     atomics) beside ``index_add_`` (a yardstick); us/step with and
     without the observation; the 12-candidate search with the KC V
     probe's recordings per candidate;
  10. the paper's occupancy model (``kernels.autotune``) against the
     runtime: every ``H100Limits`` value the card reports equal to it;
     for every kernel of the port at every block it is compiled for, the
     model's resident CTAs an SM equal to
     ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` (the kernels the
     model chooses blocks for also at every block of whole warps and at
     two shared-memory sizes), each limit the runtime does not report
     (register and shared-memory units, the register file's quarters, the
     1 KB reserve, 32 CTAs an SM) deciding at least one case; each
     model-chosen kernel at its path's shape at every compiled block, bit
     for bit the chosen block's result, with its device time; then the
     paper's experiment at full width (``benchmarks/
     gscale_experiments_torch.py``): gScale searched per nConn on the
     100k-neuron Izhikevich net (nConn 100..1000, 20 candidates x 350
     steps) and per nPN on the 100k-KC mushroom body (nPN 25..100, 12
     candidates x 700 steps, PN_KC and PN_LHI), both hyperbola fits,
     every pick finite; the trace of those builds and runs exported
     (``chiprun_out/phase10_trace.json``), valid, with the JAX package's
     span and instant names;
  11. SNN serving at full width (``repro_torch.launch.snn_serve`` over
     ``CompiledModel.serve_chunk``, one CUDA graph a configuration): (a)
     the main path's net (100k x 1000), ``SNNServer(max_streams=8,
     chunk=50)``, 16 requests of 100-200 steps of 3.0 x normal stim from
     numpy's default_rng(0), seeds 1000 + i, every stream's spike counts
     equal to its offline ``CompiledModel.run`` at B=1; (b) the same
     requests through ``Gateway(buckets=(4, 8))``, a deadline on every
     other request passed by a fake clock after the first chunk: a
     mid-flight eviction, a grow and a shrink, the survivors exact; (c)
     mb_full (100k KCs, phase 6b's fan-in gScales: the default
     conductances are non-finite at this size) with the KC V probe every
     5 steps, 8 streams, counts exact and recordings within rtol=1e-5,
     atol=1e-4; (d) phase 5's delayed net with 4 streams admitted a chunk
     apart, each stream's final state (rings and cursors) bit-equal to
     its offline run's; (e) the gateway's HTTP front door at the
     demo's size, 4 concurrent requests served by the pump thread from
     graphs captured at registration, each exact.  It prints
     slot-steps/s, streams/s, chunk ms p50/p99, the chunk's phases (host
     assembly; stim copy and replay by CUDA events; the call's wait and
     readback), device ops a served chunk and the card's busy share over
     it, and the masking's cost (device ops and time a step, served S=8
     against ``run_compiled`` at B=8 on the same stim, in turns).
  12. on-device construction and the SNN benchmark scripts: (a) main's
     net (phase 3's) built with ``compile_model(init="device")``: build s
     beside phase 3's host build, each synapse population's
     ``device_init`` span and redraw rounds, peak memory, the
     construction kernels' launches; every row 1000 distinct sorted
     targets; rows [0, 2048) and 2048 sampled rows equal to a CPU build of
     those rows (``rows=``, the plain versions) bit for bit; the whole
     graph's digest equal to ``DEVICE_INIT_DIGESTS`` (the JAX package's,
     ``experiments/device_init_digests.py``); (b) the same for phase 5's
     delayed net (``UniformIntDelay(0, 20)``); (c) the device-built main
     net for 1000 steps from graphs, bit-equal to its eager run, us/step
     beside phase 3's; (d) ``benchmarks/snn_{scaling,event,probes,
     health}_torch.py`` at the main path's width (100k neurons x 1000;
     snn_scaling's construction at 25k, 50k and 100k), steps cut, their
     JSON printed (and written under ``chiprun_out/phase12_bench``).
  13. the sharded engine (``core/snn/engine.py``) at one NCCL rank
     (``launch.mesh.make_snn_mesh``: a world of one, the collectives
     issued all the same): the NCCL all-gather of main's exc words timed
     alone; (a) phase 12c's net built over the mesh (``init="device"``:
     ``device_init_local``), its blocks equal to ``partition_ell_by_post``
     of the graph, 1000 steps eager and replayed from CUDA graphs (the
     all-gathers inside the capture) bit-equal, the run's counts, rasters
     and state bit-equal to phase 12c's, us/step, device ops a step and
     the busy share beside the model's own Simulator (the exchange's
     cost); (c) phase 4's sweep on it, candidates/s beside phase 4's,
     counts equal to the Simulator's; (d) 8 streams served on it, each
     equal to its offline run; (b) phase 5's delayed net, 200 steps,
     bit-equal to phase 5's run; (e) phase 6a's NaN-guard table on the
     engine (the ``hh_step`` route), equal to phase 6a's.

  14. the MoE, SSM and hybrid families at full width (random bf16 weights
     from a seeded generator): (a) granite-moe-1b-a400m, (b) mixtral-8x22b
     cut to 2 layers (56 do not fit one card), (c) mamba2-2.7b and (d)
     zamba2-7b (81 slots: 13 shared-attention applications, 68 mamba
     layers) each serve 8 greedy requests of 512-1024 prompt tokens
     (numpy's default_rng(0)) x 16 new tokens in one wave through
     ``Server(max_batch=8, max_seq=2048)``: every request its tokens below
     the vocab, finite logits, ``flash_attention`` launched once an
     attention layer and ``ssd_scan.state`` (the SSD kernel writing its
     final state) once a mamba layer a wave, nothing else; the MoE's
     capacity drops in the prefill and the decode steps; prefill
     tokens/s, decode ms/step, device ops a decode step and the card's
     busy share; for 14a, c and d phase 7's float32 prefill check at full
     depth (the MoE's plain run pinned to the kernel run's routing, where
     a choice may differ only at a near tie of 1e-6); (e) training
     granite-moe at full depth (4 x 2048, 4 steps: 48 ``flash_attention``
     and 24 ``flash_attention_bwd`` a step, finite ce and aux; ms/step,
     tokens/s, model TFLOP/s on the active parameters, peak memory) and
     (f) zamba2 at 15 layer slots (2 x 2048, 3 steps: 26 ``ssd_scan``, 2
     ``flash_attention`` and 2 ``flash_attention_bwd`` a step), then one
     float32 step of zamba2 at 2 groups with the kernels and with the
     plain versions as 8c.

  15. whisper-tiny (encdec) at full width (4 + 4 layers, d 384, 1500
     audio frames; random bf16 weights from a seeded generator): (a)
     8 greedy requests of 32-224 prompt tokens x 32 new tokens in one wave
     over the Server's zero audio, caches to 448: 12 ``flash_attention``
     launches a wave (4 encoder, 4 decoder self-, 4 cross-attentions) and
     nothing else, no PyTorch attention kernel in the profiles; (b) 3
     training steps at 8 x 448 tokens with the trainer's threefry audio
     (24 ``flash_attention`` and 12 ``flash_attention_bwd`` a step;
     TFLOP/s by 6N, N split between the tokens and the frames); (c) one
     float32 step (2 x 448) through the kernels and through the plain
     versions: logits within 1e-3, the loss and every gradient (the
     encoder's and the cross-attention's among them) within 8c's
     tolerances.  Phase 13 ends its NCCL group
     (``launch.mesh.shutdown_distributed``).

  16. the paper's harness: ``benchmarks/run_torch.py`` with every row on
     the card and ``benchmarks/determinism_smoke_torch.py`` (the
     Simulator against one NCCL rank), each in a process of its own,
     every row present and timed rows positive, the smoke's checks true
     and its output free of PyTorch's NCCL leak warning.

  17. paligemma-3b (vlm) at full width (18 layers, d 2048, 8 query heads
     over 1 kv head of 256, vocab 257216; random bf16 weights from a
     seeded generator): (a) 8 greedy requests of 256-768 prompt tokens x
     32 new tokens in one wave after the Server's zero image (256
     positions under the prefix-LM mask), caches to 2048: 18
     ``flash_attention`` launches a wave and nothing else, no PyTorch
     attention kernel; prefill tokens/s with the image's positions counted
     apart, TTFT, decode ms/step, device ops a decode step, busy share;
     phase 7's float32 prefill check (2 prompts of 512 tokens after the
     image); (b) 3 training steps of 2 x 1024 tokens, 256 image positions
     a row (the trainer's threefry image): 36 ``flash_attention`` and 18
     ``flash_attention_bwd`` a step, finite losses, ms/step, TFLOP/s by 6N
     over all 1280 positions, peak memory, a profiled step; (c) one
     float32 step of 2 layers at full width (2 x 512 tokens after the
     image) through the kernels and through the plain versions: logits,
     loss and every gradient under 8c's tolerances, ``img_proj``'s and
     ``wq``/``wk``/``wv``'s gradients nonzero.

  18. the trainer's checkpoints (``launch.train.run(ckpt_dir=)``) at full
     width: qwen2-0.5b cut to 2 layers (a ~2.3 GB checkpoint of bf16
     params and float32 master copies and moments), 6 steps of 2 x 512
     tokens with a checkpoint every 3, in a temporary directory: an
     uninterrupted run, a second one, and that second one restarted from
     step 3 once its step-6 manifest is removed: the restarted losses 4-6
     and step-6 checkpoint equal the uninterrupted run's bit for bit (or
     within the two uninterrupted runs' own gap, printed); a non-finite
     loss injected at step 5 rolls back to step 3 with ``lr_scale`` 0.5;
     a restore adds at most one leaf's bytes on the card (the trainer
     restores into its live tensors); the checkpoint's bytes and its host
     copy, write and restore seconds.

  19. LM model parallelism on a ("data", "model") mesh of one NCCL rank
     (``init_distributed``; ``make_local_mesh(1)`` inside ``Server`` and
     ``run``; ended by ``shutdown_distributed``): (a) qwen2-0.5b served
     at full width, 8 greedy requests of 1024-2048 prompt tokens x 16 new
     tokens, params placed by ``param_specs``, caches in
     ``cache_shardings``' layout: its tokens equal the unmeshed server's
     wherever that run's top-2 margin exceeds 1e-3, 24
     ``flash_attention`` launches a wave on the mesh, prefill s and
     decode ms/step beside the unmeshed run's and phase 7's; a float32
     prefill (2 x 512) on the mesh within 1e-4 of the unmeshed one; (b)
     granite-moe trained at full width through ``run(model_parallel=1)``
     (4 x 2048, 3 steps, experts on "model"): losses within rtol 1e-5 of
     the unmeshed trainer's, 48 ``flash_attention`` and 24
     ``flash_attention_bwd`` a step, ms/step and peak memory beside the
     unmeshed run's and phase 14e's; (c) qwen2-0.5b at 2 layers, a placed training state
     after one step saved on the mesh (rank 0 writes the joined leaves)
     and restored in place by the unmeshed trainer, bit for bit; (d)
     ``optim.grad_compression`` round-tripping qwen2-0.5b's gradient tree
     (2 x 512 tokens): int8 codes, each entry within half a step of its
     block's scale, deq + new error equal to the gradient, bytes before
     and after, compress and decompress ms.

  20. the dry run and the LM scaling law (``launch/dryrun.py``,
     ``core/scaling.py``; the card's name, power limit and torch's
     version printed): (a) ``probe_and_fit`` at ``benchmarks/run.py``'s
     fan-ins (64-2048) on the card and on the CPU, the six scales equal,
     the fit, scale(256)/scale(1024) (ideal 2.0) and the seconds; (b) the
     dry run of phase 8a's training step (4 x 2048) and of phase 7's
     decode step (8 at 4096 positions) on a fake group of one rank (fake
     cuda tensors), against the real steps of those phases: FLOPs equal
     to ``FlopCounterMode``'s count of the real step, the peak within 15%
     of the step's own (``torch.cuda.max_memory_allocated()`` after a
     reset, less what earlier phases left live beside the step's inputs),
     and the roofline's bound against the measured ms/step; (c) qwen3-8b x
     train_4k, qwen2-0.5b x prefill_32k and mixtral-8x22b x decode_32k on
     a fake group of 256 (the 16 x 16 mesh), traced on fake cuda and on
     fake CPU tensors: FLOPs, bytes, collectives and peak equal, the trace
     seconds printed.  The traces run in three processes
     (``chip_smoke.py --dryrun-traces``) started after phase 1, beside
     the phases before 20.

Before the last line it prints the card's ``nvidia-smi`` name and power
limit and a ``{"kernels": [...]}`` JSON line (each kernel's launches on its
path, ``engine_launches`` on phase 13's and ``family_launches`` on phases
14's, 15's, 17's and 19's); the last line is
``{"ok": true, "device": {...}}``.  The full results also go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the card's data-sheet rates, from their one place in the port
# (kernels/autotune.py's H100_RATES); None without torch or outside a
# checkout, which main() reports before anything runs
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))
try:
    from repro_torch.kernels.autotune import H100_RATES
except ImportError:
    H100_RATES = None
HBM_BYTES_PER_S = getattr(H100_RATES, "hbm_bytes_per_s", None)
FP32_FLOPS = getattr(H100_RATES, "fp32_flops", None)
BF16_FLOPS = getattr(H100_RATES, "bf16_flops", None)
TF32_FLOPS = getattr(H100_RATES, "tf32_flops", None)
TOL = 1e-5
NEURON_TOL = 2e-4
SPIKE_DISAGREEMENT = 0.002
RASTER_AGREEMENT = 0.998

N_PRE, N_CONN, N_POST, N_SLOTS = 80_000, 1000, 80_000, 21
# the main path's ELL kernel in the SASS (its mangled name holds this)
# at the rows the model chose: ell_spmv_live_kernel<rows, bool spikes, 4
# slots>
ELL_SASS_KERNEL = "ell_spmv_live_kernelILi{rows}EhLi4E"
MAIN = dict(n_total=100_000, n_conn=1000, steps=1000, plain_steps=50)
# the grid a conductance search scans, below the saturated regime: above
# gScale ~1.25 this net bursts at ~100 Hz and the rate is no longer monotone
SWEEP = dict(values=(0.3, 0.45, 0.6, 0.75, 0.9, 1.0, 1.1, 1.2), steps=500,
             # a second grid the same capture replays (phases 4 and 5b)
             values_b=(0.35, 0.5, 0.65, 0.8, 0.95, 1.05, 1.15, 1.25))
# phase 5: the main path's net with per-synapse delays 0..20 steps on the
# excitatory groups (21 ring slots); its plain run and profile take 50
DELAY = dict(n_total=100_000, n_conn=1000, max_delay=20, steps=200,
             plain_steps=50, profile_steps=50, sweep_steps=500)
# the fold's rows in phase 2: phase 5's ring of the 80,000 excitatory
# posts at B = 1, and at the sweep's B = 8
FOLD_SHAPES = ((1, 21, 80_000), (8, 21, 80_000))
IZH_SHAPES = ((1, 80_000), (8, 80_000))      # exc; B of phases 3 and 4
# mb_full's LHI, KC and DN (phase 6b), then mb_table's batch of 5 (6a)
HH_SHAPES = ((1, 20), (1, 100_000), (1, 100), (5, 100_000))
# float operations per (member, neuron), counting expf and a division as
# one each (so the operation bound is a lower bound): the statements of
# csrc/neuron_step.cu
IZH_OPS = 28
HH_OPS_PER_SUBSTEP = 88
# bytes per (member, neuron): v, m, h, n, isyn read, v, m, h, n written
# (float32) and above (a byte)
HH_BYTES = 5 * 4 + 4 * 4 + 1
# phase 2f: the threefry draws of the SNN paths, (what, n, draw, scale):
# main's thalamic normals and mb_full's PN rand; the keys a step's split
# makes (1 + 2 x populations: main 2, mb_full 4)
THREEFRY_DRAWS = (("main exc", 80_000, "normal", 5.0),
                  ("main inh", 20_000, "normal", 2.0),
                  ("mb_full PN", 100, "uniform", 1.0))
THREEFRY_SPLITS = (5, 9)
NORMAL_ULP = 4
# operations a draw costs at least: 20 rounds of add, rotate (one funnel
# shift) and xor and 12 key-schedule adds, in 32-bit integers; a normal
# ~17 float operations more (log1p and sqrt counted as one each)
THREEFRY_INT_OPS = 72
NORMAL_FLOAT_OPS = 17
# 32-bit integer operations/s: Hopper has 64 INT32 lanes a SM beside 128
# float32 lanes, and no fused pair: a quarter of FP32_FLOPS
INT32_OPS = FP32_FLOPS and FP32_FLOPS / 4
# the graph route's raster check: 3 chunks of 32 steps and a remainder
RASTER_CHECK_STEPS = 100
MB_EXAMPLE = dict(n_pn=24, n_lhi=6, n_kc=150, n_dn=12)
MB_FULL = dict(n_pn=100, n_lhi=20, n_kc=100_000, n_dn=100)
MB_TABLE = dict(values=(0.5, 1.0, 2.0, 8.0, 50.0), steps=2500)
# phase 9a: spike rows the bitmask packs (main's exc at B = 1 and the
# sweep's 8, mb_full's KCs, and a width past a word's boundary)
BITMASK_SHAPES = ((1, 80_000), (8, 80_000), (1, 100_000), (1, 80_001))
# phase 9b: main's net with four probes and the monitor; us/step taken in
# turns (plain, observed, observed, plain) on the same graph
OBS_MAIN = dict(steps=1000, profile_steps=50, turns=2, bands=(1.0, 100.0))
# phase 9c: mb_full with the KC V probe and the KC->DN normalisation; eager
# and replayed from one state over check_steps, then the run and search
OBS_MB = dict(check_steps=500, steps=2500, kc_probe_every=25, turns=2)
# phase 11: SNN serving at full width: the main path's net and mb_full,
# 8 slots, chunks of 50, requests of 100-200 steps; the gateway's buckets;
# phase 5's net with 4 streams admitted a chunk apart
SNN_SERVE = dict(streams=8, chunk=50, requests=16, min_steps=100,
             max_steps=200, izh_scale=3.0, mb_scale=1.5, mb_requests=8,
             mb_probe_every=5, buckets=(4, 8), delay_streams=4,
             delay_steps=(200, 180, 160, 140))
# PR 19's device ops a step of phase 3 (eager, replayed), which a run
# without probes, custom updates or a monitor keeps
MAIN_OPS_PR19 = (33.2, 33.9)
# phase 13: the sharded engine at one NCCL rank: the all-gather timed
# alone, a profile's steps (13d serves phase 11's SNN_SERVE requests)
ENGINE = dict(nccl_reps=200, profile_steps=50)
MB_RUN = dict(steps=2500, plain_steps=200, search_steps=2500,
              # PN_KC candidates around its fan-in gScale (0.24)
              search=tuple(0.24 * 2.0 ** (i / 4 - 1) for i in range(12)))
# name, (B, Hq, Hkv, T, D), dtype, options, tolerance against the plain
# version (in float32, on the same inputs)
# (bf16 runs on the tensor cores as bf16, float32 as 3xTF32)
FLASH_CASES = (
    ("prefill", (8, 14, 2, 2048, 64), "bfloat16", {"causal": True}, 1e-2),
    ("prefill_b1_f32", (1, 14, 2, 2048, 64), "float32", {"causal": True},
     2e-5),
    ("gemma3_local", (1, 16, 8, 2048, 256), "bfloat16",
     {"causal": True, "window": 1024}, 1e-2),
    ("softcap", (1, 4, 2, 256, 64), "float32",
     {"causal": True, "softcap": 30.0}, 2e-5),
    ("prefix", (1, 4, 2, 256, 64), "float32",
     {"causal": True, "prefix": 100}, 2e-5),
    ("noncausal_ragged", (2, 4, 4, 200, 64), "float32", {"causal": False},
     2e-5),
    ("softcap_bf16", (1, 4, 2, 256, 64), "bfloat16",
     {"causal": True, "softcap": 30.0}, 1e-2),
    ("prefix_bf16", (1, 4, 2, 256, 64), "bfloat16",
     {"causal": True, "prefix": 100}, 1e-2),
    ("noncausal_ragged_bf16", (2, 4, 4, 200, 64), "bfloat16",
     {"causal": False}, 1e-2),
    ("q_offset_bf16", (1, 4, 2, 256, 64), "bfloat16",
     {"causal": True, "q_offset": 100}, 1e-2),
    ("zamba2_d112", (1, 32, 32, 2048, 112), "bfloat16", {"causal": True},
     1e-2),
    ("d40_bf16", (1, 4, 2, 256, 40), "bfloat16", {"causal": True}, 1e-2),
    # the prefill shape without the causal mask: what the masks cost the
    # tensor-core kernel per visible pair
    ("prefill_noncausal", (8, 14, 2, 2048, 64), "bfloat16",
     {"causal": False}, 1e-2),
    # whisper-tiny (phase 15): the encoder's self-attention over 1500 frames
    # (no tile divides 1500) and the decoder's cross-attention, Tq != Tk,
    # both non-causal; T as (Tq, Tk) where they differ
    ("whisper_encoder", (8, 6, 6, 1500, 64), "bfloat16", {"causal": False},
     1e-2),
    ("whisper_cross", (8, 6, 6, (224, 1500), 64), "bfloat16",
     {"causal": False}, 1e-2),
    ("whisper_cross_f32", (2, 6, 6, (37, 1500), 64), "float32",
     {"causal": False}, 2e-5),
    # paligemma-3b (phase 17): D = 256, MQA 8:1, a prefix-LM span of 256
    # image positions: the prefill wave (256 + 768 text positions), the
    # training batch (256 + 1024), and a prefix of 200 that ends inside a
    # tile, in both dtypes
    ("paligemma_prefill", (8, 8, 1, 1024, 256), "bfloat16",
     {"causal": True, "prefix": 256}, 1e-2),
    ("paligemma_train", (2, 8, 1, 1280, 256), "bfloat16",
     {"causal": True, "prefix": 256}, 1e-2),
    ("paligemma_prefix200", (1, 8, 1, 456, 256), "bfloat16",
     {"causal": True, "prefix": 200}, 1e-2),
    ("paligemma_prefix200_f32", (1, 8, 1, 456, 256), "float32",
     {"causal": True, "prefix": 200}, 2e-5),
    # examples/train_lm_torch.py's float32 training: its default model (5
    # query heads over 1) and --hundred-m's (10 over 2), 8 x 256 tokens
    ("example_f32", (8, 5, 1, 256, 64), "float32", {"causal": True}, 2e-5),
    ("example_100m_f32", (8, 10, 2, 256, 64), "float32", {"causal": True},
     2e-5),
)
# phase 14: the MoE, SSM and hybrid families served at full width, one
# wave of 8 greedy requests (prompts of 512-1024 tokens from numpy's
# default_rng(0), 16 new tokens each), caches to 2048 positions; mixtral
# with its depth cut to 2 layers (its 56, ~141B parameters, do not fit one
# card); the float32 kernel-vs-plain prefill of phase 7 (2 prompts of 512
# tokens) at full depth, mixtral's skipped; the decode's device ops from a
# profile of 10 steps
FAMILIES = (
    ("14a", "granite-moe-1b-a400m", None, True),
    ("14b", "mixtral-8x22b", 2, False),
    ("14c", "mamba2-2.7b", None, True),
    ("14d", "zamba2-7b", None, True),
)
FAMILY_SERVE = dict(max_batch=8, max_seq=2048, requests=8,
                    prompt_len=(512, 1024), max_new=16, check_prompts=2,
                    check_len=512, tol=1e-3, decode_profile_steps=10,
                    tie=1e-6)
# phase 15: whisper-tiny at full width (4 + 4 layers, d 384, 1500 audio
# frames; random bf16 weights from a seeded generator): one wave of 8
# greedy requests over zero audio (the Server's), prompts of 32-224 tokens
# from numpy's default_rng(0), 32 new tokens, caches to 448 positions (the
# decoder's context); 3 training steps at 8 x 448 tokens with the
# trainer's audio; a float32 step (2 x 448) with the kernels and with the
# plain versions, under 8c's tolerances and the family check's logit
# tolerance
WHISPER = dict(arch="whisper-tiny", max_batch=8, max_seq=448, requests=8,
               prompt_len=(32, 224), max_new=32, decode_profile_steps=10,
               check_batch=2, check_seq=448)
# phase 17: paligemma-3b (vlm) at full width (18 layers, d 2048, 8 query
# heads over 1 kv head of 256, ff 16384, vocab 257216; random bf16 weights
# from a seeded generator): one wave of 8 greedy requests after the
# Server's zero image (256 positions), prompts of 256-768 tokens from
# numpy's default_rng(0), 32 new tokens, caches to 2048 positions; phase
# 7's float32 prefill check on 2 prompts of 512 tokens; 3 training steps
# (TRAIN) and a float32 step of 2 layers (2 x 512 tokens, the image
# before them)
PALIGEMMA = dict(arch="paligemma-3b", max_batch=8, max_seq=2048, requests=8,
                 prompt_len=(256, 768), max_new=32, check_prompts=2,
                 check_len=512, tol=1e-3, decode_profile_steps=10,
                 check_layers=2, check_batch=2, check_seq=512)
# phase 18: checkpoints on the card: qwen2-0.5b at full width cut to 2
# layers (a checkpoint of ~2.3 GB: bf16 params, float32 master copies and
# moments), the trainer's run of 6 steps with a checkpoint every 3; the
# rollback's non-finite loss injected at step 5
CKPT = dict(arch="qwen2-0.5b", n_layers=2, steps=6, every=3, batch=2,
            seq=512, lr=3e-3, nan_at=5)
# phase 19: the LM stack on a one-rank NCCL mesh
LM_MESH = dict(serve_arch="qwen2-0.5b", max_batch=8, max_seq=4096,
               requests=8, prompt_len=(1024, 2048), max_new=16, margin=1e-3,
               f32_prompts=2, f32_len=512, f32_tol=1e-4,
               train_arch="granite-moe-1b-a400m", batch=4, seq=2048, steps=3,
               lr=3e-3, loss_rtol=1e-5,
               per_step={"flash_attention": 48, "flash_attention_bwd": 24},
               ckpt_arch="qwen2-0.5b", ckpt_layers=2, ckpt_batch=2,
               ckpt_seq=512, gc_batch=2, gc_seq=512)
# phase 20: the dry run and the LM scaling law.  (a) the probe at
# benchmarks/run.py's fan-ins; (b) the dry run of phase 8a's training step
# and phase 7's decode step on a fake group of one rank (fake cuda
# tensors), against the real steps; (c) three production cells on a fake
# group of 256, traced on fake cuda and on fake CPU tensors.  Each
# trace's name is arch:kind:seq:batch
DRYRUN = dict(fanins=(64, 128, 256, 512, 1024, 2048), peak_rtol=0.15,
              one_rank=("qwen2-0.5b:train:2048:4",
                        "qwen2-0.5b:decode:4096:8"),
              production=("qwen3-8b:train:4096:256",
                          "qwen2-0.5b:prefill:32768:32",
                          "mixtral-8x22b:decode:32768:128"),
              timeout_s=900)
# device kernels of PyTorch's own attention (SDPA's flash, memory-efficient
# and cuDNN routes), which no path of the port may run
SDPA_KERNELS = ("pytorch_flash", "fmha", "efficient_attention", "cudnn")
SERVE = dict(arch="qwen2-0.5b", max_batch=8, max_seq=4096, requests=16,
             prompt_len=(1024, 2048), max_new=32, check_prompts=2,
             check_len=512, tol=1e-3, decode_profile_steps=20)

# name, (b, t, h, dh, ds): the training shape of mamba2-2.7b (batch 2 x
# 2048 tokens, 80 heads of 64, state 128), t = 96 (one chunk of 96 in the
# plain version) and t = 1000 (chunks of 8 by the halving rule), and head
# counts that no head block of the TPU kernel divides evenly
SSD_CASES = (
    ("train", (2, 2048, 80, 64, 128)),
    ("t96", (2, 96, 80, 64, 128)),
    ("t1000", (1, 1000, 80, 64, 128)),
    ("h4", (2, 512, 4, 64, 128)),
    ("h3_small", (1, 300, 3, 16, 16)),
)
SSD_TOL = 2e-4
# the prefill form (``ssd_scan_state``: y and the state after the last
# chunk): mamba2's serving prefill (8 x 2048, 80 heads, state 128),
# zamba2's (112 heads, state 64) and a t that 32 does not divide
SSD_STATE_CASES = (
    ("mamba2_prefill", (8, 2048, 80, 64, 128)),
    ("zamba2_prefill", (8, 2048, 112, 64, 64)),
    ("t1037", (1, 1037, 80, 64, 128)),
)
SSD_Q = 32                       # the kernel's chunk (csrc/ssd_scan.cu)
# the training shape's time on the CUDA-core kernel that the tensor-core
# one replaced (PERF.md) and what the redesign predicted, in ms; both
# printed beside this run's time
SSD_BEFORE_MS = 1.363
SSD_PREDICTED_MS = (0.25, 0.5)
# name, (B, Hq, Hkv, T, D), dtype, options: the training shape of
# qwen2-0.5b (batch 4 x 2048), the same at B=1 in float32, gemma3's local
# layer, and small float32 softcap, prefix and non-causal cases
FLASH_BWD_CASES = (
    ("train", (4, 14, 2, 2048, 64), "bfloat16", {"causal": True}),
    ("train_b1_f32", (1, 14, 2, 2048, 64), "float32", {"causal": True}),
    ("gemma3_local", (1, 16, 8, 2048, 256), "bfloat16",
     {"causal": True, "window": 1024}),
    ("softcap", (1, 4, 2, 256, 64), "float32",
     {"causal": True, "softcap": 30.0}),
    ("prefix", (1, 4, 2, 256, 64), "float32", {"causal": True, "prefix": 100}),
    ("noncausal_ragged", (2, 4, 4, 200, 64), "float32", {"causal": False}),
    ("softcap_bf16", (1, 4, 2, 256, 64), "bfloat16",
     {"causal": True, "softcap": 30.0}),
    ("prefix_bf16", (1, 4, 2, 256, 64), "bfloat16",
     {"causal": True, "prefix": 100}),
    ("noncausal_ragged_bf16", (2, 4, 4, 200, 64), "bfloat16",
     {"causal": False}),
    ("q_offset_bf16", (1, 4, 2, 256, 64), "bfloat16",
     {"causal": True, "q_offset": 100}),
    ("zamba2_d112", (1, 32, 32, 2048, 112), "bfloat16", {"causal": True}),
    ("d40_bf16", (1, 4, 2, 256, 40), "bfloat16", {"causal": True}),
    ("train_noncausal", (4, 14, 2, 2048, 64), "bfloat16", {"causal": False}),
    # whisper-tiny's training (phase 15): the encoder over 1500 frames and
    # the decoder's cross-attention at 448 queries, non-causal
    ("whisper_encoder", (8, 6, 6, 1500, 64), "bfloat16", {"causal": False}),
    ("whisper_cross", (8, 6, 6, (448, 1500), 64), "bfloat16",
     {"causal": False}),
    ("whisper_cross_f32", (2, 6, 6, (37, 1500), 64), "float32",
     {"causal": False}),
    # paligemma-3b's training (phase 17b) and prefill, and a prefix of 200
    ("paligemma_train", (2, 8, 1, 1280, 256), "bfloat16",
     {"causal": True, "prefix": 256}),
    ("paligemma_prefill", (8, 8, 1, 1024, 256), "bfloat16",
     {"causal": True, "prefix": 256}),
    ("paligemma_prefix200", (1, 8, 1, 456, 256), "bfloat16",
     {"causal": True, "prefix": 200}),
    ("paligemma_prefix200_f32", (1, 8, 1, 456, 256), "float32",
     {"causal": True, "prefix": 200}),
    # examples/train_lm_torch.py's float32 training (default and
    # --hundred-m)
    ("example_f32", (8, 5, 1, 256, 64), "float32", {"causal": True}),
    ("example_100m_f32", (8, 10, 2, 256, 64), "float32", {"causal": True}),
)
# float32: tests/test_kernels.py's gradient tolerance.  bf16: against the
# plain backward on the same saved bf16 tensors, 1e-2 of each gradient's
# largest entry (each gradient is rounded to bf16 once, 2^-8 relative, and
# the float32 sums run in another order); against autograd through the
# plain float32 forward, 3e-2 (that forward keeps its output in float32,
# while the kernel's delta = rowsum(dO * O) reads the bf16-rounded output,
# as training does)
FLASH_BWD_TOL = {"float32": (5e-4, 5e-5), "bfloat16": (1e-2, 3e-2)}
# full width and depth; the trainer's schedule (launch/train.py run()):
# warmup_cosine(lr, warmup=min(20, steps // 5 + 1), total=steps)
TRAIN = {
    "qwen2-0.5b": dict(batch=4, seq=2048, steps=4, lr=3e-3,
                       per_step={"flash_attention": 48,
                                 "flash_attention_bwd": 24},
                       # the first step's loss on the CUDA-core flash
                       # kernels (same seed and data; PERF.md)
                       first_loss_cuda_cores=12.07),
    "mamba2-2.7b": dict(batch=2, seq=2048, steps=3, lr=3e-3,
                        per_step={"ssd_scan": 128}),
    # phase 14e: every layer's attention forward twice (remat) and its
    # backward once; 14f: zamba2 at 15 layer slots (2 groups of 5 mamba +
    # the shared block, a tail of 3 mamba): the 13 mamba layers' SSD twice
    # (remat), the shared block once a group (not rematerialised) and its
    # backward
    "granite-moe-1b-a400m": dict(batch=4, seq=2048, steps=4, lr=3e-3,
                                 per_step={"flash_attention": 48,
                                           "flash_attention_bwd": 24}),
    "zamba2-7b@15": dict(arch="zamba2-7b", n_layers=15, batch=2, seq=2048,
                         steps=3, lr=3e-3,
                         per_step={"ssd_scan": 26, "flash_attention": 2,
                                   "flash_attention_bwd": 2}),
    # phase 15b: whisper-tiny's 12 attentions (4 encoder layers, 4 decoder
    # self- and 4 cross-attentions) forward twice (remat) and backward
    # once; the batch's audio, one fold_in and one normal draw
    "whisper-tiny": dict(batch=8, seq=448, steps=3, lr=3e-3,
                         per_step={"flash_attention": 24,
                                   "flash_attention_bwd": 12,
                                   "threefry_fold_in": 1,
                                   "threefry_draw": 1}),
    # phase 17b: paligemma-3b's 18 attentions forward twice (remat) and
    # backward once, each over 256 image + 1024 text positions; the
    # batch's image, one fold_in and one normal draw
    "paligemma-3b": dict(batch=2, seq=1024, steps=3, lr=3e-3,
                         per_step={"flash_attention": 36,
                                   "flash_attention_bwd": 18,
                                   "threefry_fold_in": 1,
                                   "threefry_draw": 1}),
}
# 8c: one step at full width, 2 layers, float32, kernels vs plain versions:
# losses within 1e-4; each gradient within rtol=1e-3 plus 1e-4 of its
# largest entry (float32 on both sides; the kernels sum in another order)
STEP_CHECK = dict(layers=2, batch=2, seq=512, loss_tol=1e-4, grad_rtol=1e-3,
                  grad_atol_frac=1e-4)

# phase 10: the paper's gScale(nConn) experiment at full width
# (benchmarks/gscale_experiments_torch.py): Table 1 on the Izhikevich net,
# Table 2 on the mushroom body (its fan-in-growing groups scaled from
# MB_EXAMPLE's, as 6b does, so that 100k KCs stay finite)
EXPERIMENT = {
    "izhikevich": dict(n_total=100_000,
                       n_conns=(100, 200, 300, 500, 700, 1000),
                       n_steps=350, candidates=20),
    "mushroom": dict(n_kc=100_000, n_lhi=20, n_dn=100,
                     n_pns=(25, 50, 75, 100), n_steps=700, candidates=12),
}
# profiles of each model-chosen kernel at each compiled block, in turns
BLOCK_ROUNDS = 3
# a CTA's shared memory at 128 threads where the system's 1 KB and the
# 128-byte unit decide the count (tests/test_torch_autotune.py)
OCC_SMEM_WITNESS = (45 * 1024 + 100, 45666)
# the limits the runtime does not report, each with a value that differs
# from the card's: a case the real value alone decides is its check
UNIT_ALTERNATIVES = {"reg_alloc_unit": 32, "reg_sub_partitions": 1,
                     "smem_alloc_unit": 1, "smem_reserved_per_cta": 0,
                     "max_ctas_per_sm": 64}


# phase 2f's construction entries: the row keys of main's exc group
# (80000 rows) and its sampler's draw of 1000 targets a row, at the
# sampler's span (100000 posts), phase 5's delay span (21) and the edges of
# the span arithmetic
CONSTRUCT = dict(rows=80_000, k=1000, spans=(100_000, 21, 1, 2 ** 31 - 1),
                 cpu_rows=512)
# operations of a randint element beyond its two hashes: three remainders,
# a product and two adds (a remainder counted as one, a lower bound; each
# CTA's split and multiplier are counted once a row)
RANDINT_EXTRA_OPS = 6
# phase 12: on-device construction of phases 3's and 5's nets; rows held
# against a CPU build of them through the plain versions; the 100k net
# replayed for MAIN["steps"]; the benchmark scripts at the main path's
# width (snn_scaling at 25k, 50k and 100k neurons), their steps cut
CONSTRUCT_CHECK = dict(first_rows=2048, sampled_rows=2048, seed=0)
# experiments/device_init_digests.py's digests of the JAX package's
# init="device" graphs of phases 3's and 5's nets (100k x 1000, seed 1234),
# computed on the CPU
DEVICE_INIT_DIGESTS = {
    "main": "c67edc449439b8e186e23c84ccf9568650b0568d10940b2946ce8436bd11e0ab",
    "delay": "87dce920575e0f03747facce3d1f10c2ceda3064aa06a9fa28074e333ac6f877",
}
SCRIPTS = (
    ("snn_scaling", {"SNN_BENCH_PER_DEV": "25000", "SNN_BENCH_NCONN": "1000",
                     "SNN_BENCH_STEPS": "200"}),
    ("snn_event", {"SNN_EVENT_BENCH_N": "100000",
                   "SNN_EVENT_BENCH_NCONN": "1000",
                   "SNN_EVENT_BENCH_STEPS": "50",
                   "SNN_EVENT_BENCH_REPS": "2"}),
    ("snn_probes", {"SNN_PROBE_BENCH_N": "100000",
                    "SNN_PROBE_BENCH_NCONN": "1000",
                    "SNN_PROBE_BENCH_STEPS": "200",
                    "SNN_PROBE_BENCH_REPS": "2"}),
    ("snn_health", {"SNN_HEALTH_BENCH_N": "100000",
                    "SNN_HEALTH_BENCH_NCONN": "1000",
                    "SNN_HEALTH_BENCH_STEPS": "200",
                    "SNN_HEALTH_BENCH_REPS": "2"}),
)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


@contextlib.contextmanager
def phase(name: str):
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    try:
        yield
    except BaseException:
        print(f"== {name}: FAILED", flush=True)
        raise
    print(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)", flush=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    if H100_RATES is None:
        print("chip_smoke: repro_torch.kernels.autotune does not import "
              "from this checkout", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    report: dict = {}
    kernels = card_and_build(torch, report)
    # phase 20's traces run on the host beside the phases before it
    traces = start_dryrun_traces()
    try:
        return _phases(torch, report, kernels, traces, t_start)
    finally:
        traces.stop()


def _phases(torch, report, kernels, traces, t_start) -> int:
    kernel_entries = compare_kernels(torch, report)
    kernel_entries += compare_neuron_kernels(torch, report)
    kernel_entries += compare_flash(torch, report)
    kernel_entries += compare_ssd(torch, report)
    kernel_entries += compare_flash_bwd(torch, report)
    kernel_entries += compare_threefry(torch, report)
    launches_main, model = main_path(torch, report)
    sweep(torch, report, model)
    del model
    torch.cuda.empty_cache()
    launches_delay, model = delay_path(torch, report)
    delay_sweep(torch, report, model)
    del model
    torch.cuda.empty_cache()
    kc_target = gscale_table(torch, report)
    launches_mb = mushroom_body_full(torch, report, kc_target)
    torch.cuda.empty_cache()
    launches_serve = serve_full(torch, report)
    torch.cuda.empty_cache()
    launches_qwen = train_full(torch, report, "qwen2-0.5b", "8a")
    launches_mamba = train_full(torch, report, "mamba2-2.7b", "8b")
    train_step_check(torch, report)
    torch.cuda.empty_cache()
    launches_families = families(torch, report)
    torch.cuda.empty_cache()
    kernel_entries += compare_bitmask(torch, report)
    launches_obs = main_observed(torch, report)
    torch.cuda.empty_cache()
    mb_observed(torch, report)
    torch.cuda.empty_cache()
    paper_experiment(torch, report)
    torch.cuda.empty_cache()
    serve_snn(torch, report)
    torch.cuda.empty_cache()
    launches_construct = device_construction(torch, report)
    torch.cuda.empty_cache()
    launches_engine = sharded_engine(torch, report)
    torch.cuda.empty_cache()
    launches_families.update(whisper(torch, report))
    torch.cuda.empty_cache()
    paper_harness(torch, report)
    torch.cuda.empty_cache()
    launches_families.update(paligemma(torch, report))
    torch.cuda.empty_cache()
    checkpoints(torch, report)
    torch.cuda.empty_cache()
    launches_families.update(lm_mesh(torch, report))
    torch.cuda.empty_cache()
    dryrun_and_scaling(torch, report, traces)
    # each kernel's launches come from the run of its own path; the
    # float32 flash route's is phase 8c's float32 training step (qwen2)
    launches_f32 = report["train_step_check"]["qwen2-0.5b"]["launches"]
    path_of = {"ell_spmv": launches_main, "ell_spmv_delay": launches_delay,
               "delay_ring_fold": launches_delay,
               "izhikevich_step": launches_main, "hh_step": launches_mb,
               "threefry_split": launches_main,
               "threefry_draw": launches_main,
               "threefry_fold_in": launches_construct,
               "threefry_draw.randint": launches_construct,
               "flash_attention": launches_serve,
               "flash_attention_bwd": launches_qwen,
               "flash_attention" + F32_ENTRY: launches_f32,
               "flash_attention_bwd" + F32_ENTRY: launches_f32,
               "ssd_scan": launches_mamba,
               "ssd_scan.state": launches_families["14c"],
               "spike_bitmask": launches_obs}
    # and, for those on the engine's paths, their launches there
    engine_path = {"ell_spmv": "main", "izhikevich_step": "main",
                   "threefry_split": "main", "threefry_draw": "main",
                   "spike_bitmask": "main", "ell_spmv_delay": "delay",
                   "delay_ring_fold": "delay", "hh_step": "mb",
                   "threefry_fold_in": "build",
                   "threefry_draw.randint": "build"}
    # the float32 phases 15c and 17c, for the float32 entries
    f32_steps = {label: report[key]["launches"] for label, key in
                 (("15c", "whisper_check"), ("17c", "paligemma_check"))}
    for e in kernel_entries:
        counter = e["name"].removesuffix(F32_ENTRY)
        e["launches"] = path_of[e["name"]][counter]
        check(e["launches"] > 0, f"{e['name']} never launched on its path")
        on = engine_path.get(e["name"])
        e["engine_launches"] = (launches_engine[on][e["name"]] if on
                                else 0)
        check(on is None or e["engine_launches"] > 0,
              f"{e['name']} never launched on the engine's path")
        # and its launches on each of phases 14's, 15's, 17's and 19's
        # paths that runs it
        runs = (f32_steps if e["name"].endswith(F32_ENTRY)
                else launches_families)
        e["family_launches"] = {label: n[counter]
                                for label, n in runs.items()
                                if n.get(counter)}
    report["kernels"] = kernel_entries
    report["build"] = kernels
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    report["seconds"] = time.perf_counter() - t_start
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(f"chip_smoke: every phase passed in {report['seconds']:.1f} s")
    print(report["nvidia_smi"])
    print(json.dumps({"kernels": kernel_entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------
def card_and_build(torch, report) -> dict:
    from repro_torch.kernels import _build
    with phase("1. card and kernel build"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        report["nvidia_smi"] = smi.stdout.strip().splitlines()[0]
        print(report["nvidia_smi"])
        t0 = time.perf_counter()
        built = _build.build()
        secs = time.perf_counter() - t0
        print(f"kernels built in {secs:.2f} s: {sorted(built)}")
        for name, b in built.items():
            regs = [ln.strip() for ln in b["log"].splitlines()
                    if "registers" in ln or "spill" in ln]
            print(f"  {name}.cu: {b['seconds']:.2f} s; " + " | ".join(regs))
        report["build_seconds"] = secs
        return {n: {"seconds": b["seconds"], "cached": b["cached"]}
                for n, b in built.items()}


def _time_ms(torch, fn, reps: int) -> float:
    fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i + 1)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(torch, fn, reps: int, kernel: str = "") -> tuple:
    """Device time per call from a torch.profiler trace of ``reps`` calls
    of ``fn``: (every device op's, those whose name holds ``kernel``).
    Unlike ``_time_ms`` it leaves out the gaps between launches, which set
    the wall time of a kernel of a few microseconds.  Every call runs the
    same device ops, so a trace whose count of them (of ``kernel``'s, when
    named) is no multiple of ``reps`` dropped or gained some: it is taken
    again, up to ten times (on the card one trace once kept a tenth of its
    launches, traces of 5 calls of a 14 ms kernel three times running kept
    4, and five traces running of 50 threefry draws kept 62)."""
    fn(0)
    torch.cuda.synchronize()

    def calls():
        for i in range(reps):
            fn(i + 1)
        torch.cuda.synchronize()

    for _ in range(10):
        prof = _device_profile(torch, calls, warm=True)
        mine = [(c, t) for n, (c, t) in prof["by_name"].items() if kernel in n]
        seen = sum(c for c, _ in mine)
        if seen > 0 and seen % reps == 0:
            break
    check(seen > 0 and seen % reps == 0,
          f"traces of {reps} calls kept {seen} device ops of {kernel!r}")
    return (prof["device_busy_us"] / reps / 1e3,
            sum(t for _, t in mine) / reps / 1e3)


def _csr(torch, post_ind, valid, g, rows_of, n_rows):
    """The ELL as a CSR matrix [n_rows, n_pre] (row = target coordinate)."""
    n_pre, k = post_ind.shape
    pre = torch.arange(n_pre, device=g.device)[:, None].expand(n_pre, k)
    sel = valid.reshape(-1)
    idx = torch.stack([rows_of.reshape(-1)[sel], pre.reshape(-1)[sel]])
    coo = torch.sparse_coo_tensor(idx, g.reshape(-1)[sel], (n_rows, n_pre))
    return coo.coalesce().to_sparse_csr()


def compare_kernels(torch, report) -> list:
    from repro_torch.kernels import _build
    from repro_torch.kernels import ell_spmv as K
    from repro_torch.kernels import ref as R
    dev = torch.device("cuda")
    rows = []
    with phase("2. kernels against their plain versions"):
        name = ELL_SASS_KERNEL.format(rows=K.launch_plan(
            1, N_PRE, N_CONN, N_POST)["rows_per_cta"])
        sass = _sass_instructions(str(_build.library_path("ell_spmv")), name)
        print(f"{name}: {sass['instructions']} SASS "
              f"instructions: {sass['by_opcode']}")
        report["ell_spmv_sass"] = sass
        gen = torch.Generator(device=dev).manual_seed(0)
        g = 0.5 * torch.rand(N_PRE, N_CONN, device=dev, generator=gen)
        idx = torch.randint(0, N_POST, (N_PRE, N_CONN), device=dev,
                            generator=gen, dtype=torch.int32)
        valid = torch.rand(N_PRE, N_CONN, device=dev, generator=gen) < 0.8
        dly = torch.randint(0, N_SLOTS, (N_PRE, N_CONN), device=dev,
                            generator=gen, dtype=torch.int32)
        g_int = torch.floor(8.0 * g)
        csr = _csr(torch, idx, valid, g, idx.long(), N_POST)
        csr_d = _csr(torch, idx, valid, g,
                     dly.long() * N_POST + idx.long(), N_SLOTS * N_POST)
        valid_per_row = valid.sum(dim=1)
        for b in (1, 8):
            for p in (0.01, 1.0):
                spikes = [(torch.rand(b, N_PRE, device=dev, generator=gen)
                           < p).float() for _ in range(8)]
                # the simulator hands both kernels its bool spikes as
                # they are
                spikes_bool = [s.bool() for s in spikes]
                spk = spikes[0]
                live = spk.amax(dim=0) > 0
                n_live = int(live.sum())
                valid_live = int(valid_per_row[live].sum())
                syn_events = int((spk * valid_per_row).sum())
                for name in ("ell_spmv", "ell_spmv_delay"):
                    delay = name == "ell_spmv_delay"
                    slots = N_SLOTS if delay else 1
                    if delay:
                        kern = lambda s, gg=g: K.ell_spmv_delay(
                            gg, idx, valid, dly, s, N_POST, N_SLOTS)
                        plain = lambda s, gg=g: R.ell_spmv_delay_ref(
                            gg, idx, valid, dly, s, N_POST, N_SLOTS)
                        lib = lambda s: torch.sparse.mm(csr_d, s.t())
                    else:
                        kern = lambda s, gg=g: K.ell_spmv(
                            gg, idx, valid, s, N_POST)
                        plain = lambda s, gg=g: R.ell_spmv_ref(
                            gg, idx, valid, s, N_POST)
                        lib = lambda s: torch.sparse.mm(csr, s.t())
                    ins = spikes_bool
                    out, ref = kern(ins[0]), plain(spk)
                    torch.cuda.synchronize()
                    err = float((out - ref).abs().max())
                    check(bool(torch.allclose(out, ref, rtol=TOL, atol=TOL)),
                          f"{name} B={b} p={p}: max abs err {err}")
                    check(bool(torch.equal(kern(ins[0], g_int),
                                           plain(spk, g_int))),
                          f"{name} B={b} p={p}: integer weights not exact")
                    check(bool(torch.equal(kern(spk), out)),
                          f"{name} B={b} p={p}: float and bool spikes "
                          "differ")
                    # both sum in float64 and round once: bit-equal with
                    # any weights, whatever the atomics' order
                    check(bool(torch.equal(out, ref)),
                          f"{name} B={b} p={p}: not bit-equal to the "
                          f"plain version (max abs err {err})")
                    lib_out = lib(spk).t().reshape(out.shape)
                    check(bool(torch.allclose(lib_out, ref, rtol=1e-4,
                                              atol=1e-4)),
                          f"{name}: the library yardstick computes another "
                          "function")
                    reps = 20 if p < 0.5 else 5
                    call = lambda i: kern(ins[i % 8])
                    # the wrapper's device time a call (every op it runs:
                    # the output's zero fill and the kernel) and the
                    # kernel's alone, beside the CUDA-event time of
                    # back-to-back calls, which the host's enqueue rate
                    # sets once a call's device work is shorter than its
                    # host work (PRs 11-16 kept only this); the plain
                    # version and the library call run ~0.5-15 ms on the
                    # device, so events time them
                    ms, kernel_ms = _device_ms(torch, call, reps, "ell_spmv")
                    times = {"ms": ms, "kernel_ms": kernel_ms,
                             "wall_ms": _time_ms(torch, call, reps),
                             "plain_ms": _time_ms(
                                 torch, lambda i: plain(spikes[i % 8]), reps),
                             "library_ms": _time_ms(
                                 torch, lambda i: lib(spikes[i % 8]), reps)}
                    nbytes = (n_live * N_CONN                       # valid
                              + valid_live * (8 + (4 if delay else 0))
                              # spikes, as the kernel reads them: a
                              # byte each when bool, 4 when float32
                              + b * N_PRE * ins[0].element_size()
                              + b * slots * N_POST * 4)        # output
                    flops = 2.0 * syn_events
                    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                    t_ops = flops / FP32_FLOPS * 1e3
                    row = {"name": name, "B": b, "spiking": p,
                           "spikes": str(ins[0].dtype),
                           "max_abs_err": err, **times,
                           "bound_ms": max(t_bytes, t_ops),
                           "bound_by": ("bytes" if t_bytes >= t_ops
                                        else "operations"),
                           "bytes": nbytes, "flops": flops,
                           "live_rows": n_live,
                           # the atomics' rate: one add per valid slot
                           # of a spiking row and member
                           "adds": syn_events,
                           "adds_per_s": syn_events / (kernel_ms * 1e-3),
                           "plan": K.launch_plan(
                               b, N_PRE, N_CONN, N_POST,
                               n_slots=N_SLOTS if delay else None)}
                    rows.append(row)
                    print(json.dumps(row))
        del g, idx, valid, dly, g_int, csr, csr_d
        torch.cuda.empty_cache()
        rows += _compare_fold(torch, dev, gen)
    report["kernel_table"] = rows
    entries = []
    for name, replaces in (("ell_spmv", "src/repro/kernels/ell_spmv.py:127"),
                           ("ell_spmv_delay",
                            "src/repro/kernels/ell_spmv.py:190")):
        # the main path's own regime: one simulation, ~1% of rows spiking
        r = next(x for x in rows if x["name"] == name and x["B"] == 1
                 and x["spiking"] < 0.5)
        entries.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ell_spmv.cu",
            "replaces": replaces, "launches": 0,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    # the fold at B = 1, phase 5's own regime; it fuses the eager ring
    # update that the JAX package runs in its step (no TPU kernel)
    r = next(x for x in rows if x["name"] == "delay_ring_fold"
             and x["B"] == 1 and "cursors" not in x)
    entries.append({
        "name": "delay_ring_fold", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ell_spmv.cu",
        "replaces": "src/repro/core/snn/synapses.py:513", "launches": 0,
        **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                             "bound_by", "library_ms")}})
    return entries


def _compare_fold(torch, dev, gen) -> list:
    """The dendritic ring's fold at phase 5's shapes against its plain
    version (the eager sequence it replaces), bit for bit; times beside
    the bytes bound (read ring and scratch, write the new ring, the
    scratch's zeros and inj)."""
    from repro_torch.kernels import autotune as AT
    from repro_torch.kernels import delay_ring as DR
    from repro_torch.kernels import ref as R
    rows = []
    for b, n_slots, n_post in FOLD_SHAPES:
        # every member's cursor at c (a run or a sweep)
        curs = [torch.full((b,), c, dtype=torch.int32, device=dev)
                for c in range(n_slots)]
        ring = torch.randn(b, n_slots, n_post, device=dev, generator=gen)
        ring[:, :, :64] = 0.0
        acc0 = torch.randn(n_slots, n_post, b, device=dev, generator=gen,
                           dtype=torch.float64)
        acc0[:, 32:96] = 0.0
        gscales = (torch.tensor(0.7),
                   torch.rand(b, device=dev, generator=gen) + 0.5)
        for gs in gscales:
            for sign in (1.0, -1.0):
                for cursor in (0, 11, n_slots - 1):
                    acc, acc_ref = acc0.clone(), acc0.clone()
                    got = DR.delay_ring_fold(ring, acc, curs[cursor], sign,
                                             gs)
                    want = R.delay_ring_fold_ref(ring, acc_ref,
                                                 curs[cursor], sign, gs)
                    check(got[2].tolist() == want[2].tolist()
                          == [(cursor + 1) % n_slots] * b,
                          "delay_ring_fold: the advanced cursors")
                    for x, y in zip(got[:2], want[:2]):
                        check(bool(torch.equal(x, y)) and bool(torch.equal(
                            torch.signbit(x), torch.signbit(y))),
                              f"delay_ring_fold {[b, n_slots, n_post]}: "
                              "not bit-equal to the plain version")
                    check(not bool(acc.any()),
                          "delay_ring_fold left its scratch nonzero")
        err = float((got[0] - want[0]).abs().max())
        accs = [acc0.clone() for _ in range(8)]
        # the simulator's regime: a 0-dim gscale at B = 1, [B] for a sweep
        gs = gscales[0] if b == 1 else gscales[1]
        kern = lambda i: DR.delay_ring_fold(ring, accs[i % 8],
                                            curs[i % n_slots], -1.0, gs)
        plain = lambda i: R.delay_ring_fold_ref(ring, accs[i % 8],
                                                curs[i % n_slots], -1.0, gs)
        ms, kernel_ms = _device_ms(torch, kern, 20, "delay_ring_fold")
        nbytes = b * n_slots * n_post * (4 + 8 + 4 + 8) + b * n_post * 4
        row = {"name": "delay_ring_fold", "B": b, "shape": [b, n_slots,
                                                            n_post],
               "max_abs_err": err, "ms": ms, "kernel_ms": kernel_ms,
               "wall_ms": _time_ms(torch, kern, 20),
               "plain_ms": _device_ms(torch, plain, 20)[0],
               "plain_wall_ms": _time_ms(torch, plain, 20),
               **_bound(nbytes, 0.0), "bytes": nbytes, "library_ms": None,
               "plan": DR.launch_plan(b, n_slots, n_post)}
        rows.append(row)
        print(json.dumps(row))
        if b > 1:
            rows.append(_fold_unequal_cursors(torch, DR, R, AT, ring, acc0,
                                              gscales[1], nbytes))
    return rows


def _fold_unequal_cursors(torch, DR, R, AT, ring, acc0, gs, nbytes) -> dict:
    """The fold with a cursor a member, all different (served streams sit
    at their own steps): bit-equal to its plain version at every block
    the source is compiled for, the scratch left zeroed; its time at the
    chosen block beside the equal-cursor row's."""
    b, n_slots, n_post = ring.shape
    cur = torch.tensor([(5 * m + 2) % n_slots for m in range(b)],
                       dtype=torch.int32, device=ring.device)
    check(len(set(cur.tolist())) == b, "the cursors are not all different")
    acc_ref = acc0.clone()
    want = R.delay_ring_fold_ref(ring, acc_ref, cur, -1.0, gs)
    check(want[2].tolist() == [(c + 1) % n_slots for c in cur.tolist()],
          "delay_ring_fold_ref: the advanced cursors")
    for block in AT.ELEMENTWISE_BLOCKS:
        acc = acc0.clone()
        with _forced_block(DR, block):
            got = DR.delay_ring_fold(ring, acc, cur, -1.0, gs)
        for x, y in zip(got, want):
            check(bool(torch.equal(x, y)) and (
                not x.is_floating_point() or bool(torch.equal(
                    torch.signbit(x), torch.signbit(y)))),
                f"delay_ring_fold {list(ring.shape)}, cursors "
                f"{cur.tolist()}, block {block}: not bit-equal to the plain "
                "version")
        check(not bool(acc.any()), "delay_ring_fold left its scratch "
              "nonzero")
    accs = [acc0.clone() for _ in range(8)]
    kern = lambda i: DR.delay_ring_fold(ring, accs[i % 8], cur, -1.0, gs)
    plain = lambda i: R.delay_ring_fold_ref(ring, accs[i % 8], cur, -1.0,
                                            gs)
    ms, kernel_ms = _device_ms(torch, kern, 20, "delay_ring_fold")
    row = {"name": "delay_ring_fold", "B": b, "shape": list(ring.shape),
           "cursors": cur.tolist(), "blocks": list(AT.ELEMENTWISE_BLOCKS),
           "max_abs_err": 0.0, "ms": ms, "kernel_ms": kernel_ms,
           "wall_ms": _time_ms(torch, kern, 20),
           "plain_ms": _device_ms(torch, plain, 20)[0],
           **_bound(nbytes, 0.0), "bytes": nbytes, "library_ms": None,
           "plan": DR.launch_plan(b, n_slots, n_post)}
    print("unequal cursors: " + json.dumps(row))
    return row


def _bound(nbytes: float, ops: float) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _neuron_times(torch, kern, plain) -> dict:
    """ms / plain_ms: device time per call (the kernel, or all the plain
    version's ops); *_wall_ms: CUDA events around back-to-back calls, which
    the host's enqueue rate sets for kernels this short."""
    return {"ms": _device_ms(torch, kern, 50, "_step_kernel")[0],
            "plain_ms": _device_ms(torch, plain, 20)[0],
            "wall_ms": _time_ms(torch, kern, 50),
            "plain_wall_ms": _time_ms(torch, plain, 20)}


def compare_neuron_kernels(torch, report) -> list:
    from repro_torch.kernels import _build
    from repro_torch.kernels import hh_step as HH
    from repro_torch.kernels import izhikevich_step as IZ
    from repro_torch.kernels import ref as R
    dev = torch.device("cuda")
    rows = []
    with phase("2b. neuron kernels against their plain versions"):
        # the instance of mb_full's KCs' block
        name = f"hh_step_kernelILi{HH.launch_plan(1, 100_000)['block']}E"
        sass = _sass_instructions(str(_build.library_path("neuron_step")),
                                  name)
        print(f"{name}: {sass['instructions']} SASS instructions, "
              f"{sass['loop_body']} in one substep (the innermost loop): "
              f"{sass['by_opcode']}")
        report["hh_step_sass"] = sass
        gen = torch.Generator(device=dev).manual_seed(1)

        def uniform(shape, lo, hi):
            return lo + (hi - lo) * torch.rand(shape, device=dev,
                                               generator=gen)

        def normal(shape, scale):
            return scale * torch.randn(shape, device=dev, generator=gen)

        for b, n in IZH_SHAPES:
            r = torch.rand(n, device=dev, generator=gen)
            params = (0.02 + 0.08 * r, 0.25 - 0.05 * r, -65.0 + 15.0 * r * r,
                      8.0 - 6.0 * r * r)
            ins = [(uniform((b, n), -80, 25), uniform((b, n), -20, 5),
                    normal((b, n), 5.0)) for _ in range(4)]
            dt = 1.0                                   # the main path's dt
            # the NaN guard's flag, as the simulator passes it
            flag = torch.ones(b, dtype=torch.bool, device=dev)
            kern = lambda i: IZ.izhikevich_step(*ins[i % 4], *params, dt,
                                                finite=flag)
            plain = lambda i: R.izhikevich_step_ref(*ins[i % 4], *params, dt,
                                                    finite=flag)
            out, ref = kern(0), plain(0)
            torch.cuda.synchronize()
            agree = out[2] == ref[2]
            disagree = float((~agree).float().mean())
            spiking = float(ref[2].float().mean())
            err = max(float((o - e)[agree].abs().max())
                      for o, e in zip(out[:2], ref[:2]))
            check(0.01 < spiking < 0.99,
                  f"izhikevich_step inputs spike {spiking}: they do not "
                  "straddle the threshold")
            check(disagree < SPIKE_DISAGREEMENT,
                  f"izhikevich_step [{b}, {n}]: spike decisions differ on "
                  f"{disagree} of neurons")
            check(all(bool(torch.allclose(o[agree], e[agree], rtol=NEURON_TOL,
                                          atol=NEURON_TOL))
                      for o, e in zip(out[:2], ref[:2])),
                  f"izhikevich_step [{b}, {n}]: max abs err {err}")
            rows.append({"name": "izhikevich_step", "B": b, "n": n,
                         "max_abs_err": err, "spike_disagreement": disagree,
                         "spiking": spiking, **_neuron_times(torch, kern,
                                                             plain),
                         "library_ms": None,
                         **_bound(b * n * (12 + 9) + n * 16, b * n * IZH_OPS),
                         "bytes": b * n * (12 + 9) + n * 16,
                         "ops": b * n * IZH_OPS})
            print(json.dumps(rows[-1]))
        for b, n in HH_SHAPES:
            ins = [(uniform((b, n), -80, 30), uniform((b, n), 0, 1),
                    uniform((b, n), 0, 1), uniform((b, n), 0, 1),
                    normal((b, n), 2.0)) for _ in range(4)]
            flag = torch.ones(b, dtype=torch.bool, device=dev)
            kern = lambda i: HH.hh_step(*ins[i % 4], 0.1, 5, finite=flag)
            plain = lambda i: R.hh_step_ref(*ins[i % 4], 0.1, 5, finite=flag)
            out, ref = kern(0), plain(0)
            torch.cuda.synchronize()
            err = max(float((o - e).abs().max())
                      for o, e in zip(out[:4], ref[:4]))
            check(all(bool(torch.equal(o, e))
                      for o, e in zip(out[:4], ref[:4])),
                  f"hh_step [{b}, {n}]: not bit-equal to its plain version "
                  f"(max abs err {err})")
            check(bool(torch.equal(out[4], out[0] >= 0.0)),
                  f"hh_step [{b}, {n}]: above is not v >= 0")
            check(bool(flag.all()), f"hh_step [{b}, {n}]: finite inputs "
                  f"cleared the flag {flag.tolist()}")
            ops = b * n * 5 * HH_OPS_PER_SUBSTEP
            times = _neuron_times(torch, kern, plain)
            rows.append({"name": "hh_step", "B": b, "n": n,
                         "max_abs_err": err, **times,
                         # what the host adds to each call: the wrapper
                         # and the launch, beyond the device time
                         "host_ms": times["wall_ms"] - times["ms"],
                         "library_ms": None, **_bound(b * n * HH_BYTES, ops),
                         "bytes": b * n * HH_BYTES, "ops": ops})
            print(json.dumps(rows[-1]))
    report["neuron_kernel_table"] = rows
    entries = []
    for name, replaces in (
            ("izhikevich_step", "src/repro/kernels/izhikevich_step.py:50"),
            ("hh_step", "src/repro/kernels/hh_step.py:71")):
        # the largest population of the kernel's path at B = 1
        r = max((x for x in rows if x["name"] == name and x["B"] == 1),
                key=lambda x: x["n"])
        entries.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/neuron_step.cu",
            "replaces": replaces, "launches": 0,
            **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")}})
    return entries


def _visible_pairs(torch, tq, tk, causal, window=None, prefix=None,
                   q_offset=0, **_):
    """The number of (query, key) pairs the masks leave visible in one
    (batch, head), and the mask [tq, tk]."""
    qpos = q_offset + torch.arange(tq, device="cuda")[:, None]
    kpos = torch.arange(tk, device="cuda")[None, :]
    mask = torch.ones(tq, tk, dtype=torch.bool, device="cuda")
    if causal:
        cm = kpos <= qpos
        if prefix is not None:
            cm = cm | ((kpos < prefix) & (qpos < prefix))
        mask &= cm
    if window is not None:
        mask &= kpos > qpos - window
    return int(mask.sum()), mask


def compare_flash(torch, report) -> list:
    import torch.nn.functional as TF
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref as R
    dev = torch.device("cuda")
    rows = []
    with phase("2c. flash_attention against its plain version"):
        gen = torch.Generator(device=dev).manual_seed(2)
        for name, (b, hq, hkv, t, d), dt, kw, tol in FLASH_CASES:
            dtype = getattr(torch, dt)
            tq, tk = t if isinstance(t, tuple) else (t, t)
            q, k, v = (torch.randn(shape, device=dev, generator=gen
                                   ).to(dtype)
                       for shape in ((b, hq, tq, d), (b, hkv, tk, d),
                                     (b, hkv, tk, d)))
            out = FA.flash_attention(q, k, v, **kw)
            ref = R.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
            torch.cuda.synchronize()
            err = float((out.float() - ref).abs().max())
            check(bool(torch.allclose(out.float(), ref, rtol=tol, atol=tol)),
                  f"flash_attention {name}: max abs err {err} > {tol}")
            pairs, mask = _visible_pairs(torch, tq, tk, **kw)
            lib = None
            if "softcap" not in kw:       # no PyTorch call soft-caps
                lib_kw = ({"is_causal": kw["causal"]} if set(kw) == {"causal"}
                          else {"attn_mask": mask})

                def lib(i, q=q, k=k, v=v, lib_kw=lib_kw):
                    return TF.scaled_dot_product_attention(
                        q, k, v, enable_gqa=True, **lib_kw)

                lib_err = float((lib(0).float() - ref).abs().max())
                check(lib_err < (2e-2 if dt == "bfloat16" else 1e-3),
                      f"flash_attention {name}: the library yardstick "
                      f"computes another function (max abs err {lib_err})")
            lib_backend = None
            if lib is not None and "prefix" in kw:
                # which SDPA backend takes the explicit prefix-LM mask

                def lib_once(lib=lib):
                    lib(0)
                    torch.cuda.synchronize()

                lib_backend = _sdpa_backend(torch, lib_once)
            reps = 10 if b * hq * tq * tk * d > 1e9 else 50
            ms = _time_ms(torch, lambda i: FA.flash_attention(q, k, v, **kw),
                          reps)
            plain_ms = _time_ms(torch, lambda i: R.flash_attention_ref(
                q, k, v, **kw), max(3, reps // 5))
            lib_ms = None if lib is None else _time_ms(torch, lib, reps)
            es = q.element_size()
            nbytes = es * (2 * b * hq * tq * d + 2 * b * hkv * tk * d)
            flops = 4.0 * b * hq * d * pairs
            row = {"name": "flash_attention", "case": name,
                   "shape": [b, hq, hkv, t, d], "dtype": dt,
                   "options": kw, "tol": tol, "max_abs_err": err,
                   "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                   "library_kernels": lib_backend,
                   **_flash_bounds(dt, nbytes, flops),
                   "bytes": nbytes, "flops": flops,
                   "tflops": flops / ms / 1e9}
            rows.append(row)
            print(json.dumps(row))
            del q, k, v, out, ref, mask
            torch.cuda.empty_cache()
    report["flash_table"] = rows
    # the serving prefill's own shape (bf16) and its float32 counterpart
    return _flash_entries("flash_attention",
                          "src/repro/kernels/flash_attention.py:112",
                          rows, "prefill", "prefill_b1_f32")


# each flash route's source; the float32 entries' names in the kernels
# line, which the wrappers count under their own ("flash_attention",
# "flash_attention_bwd")
FLASH_SOURCES = {"bfloat16": "src/repro_torch/kernels/csrc/"
                             "flash_attention_sm90.cu",
                 "float32": "src/repro_torch/kernels/csrc/flash_attention.cu"}
F32_ENTRY = ".f32"


def _flash_bounds(dt: str, nbytes: float, flops: float) -> dict:
    """A flash case's bound: bf16 on the tensor cores' bf16 rate; float32
    as 3xTF32 on the tensor cores (three TF32 products for each,
    ``_tc_bound``), with the CUDA cores' float32 bound beside it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if dt == "bfloat16":
        t_ops = flops / BF16_FLOPS * 1e3
        return {"bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    f32 = _bound(nbytes, flops)
    return {**_tc_bound(nbytes, flops, passes=3),
            "f32_bound_ms": f32["bound_ms"], "f32_bound_by": f32["bound_by"]}


def _flash_entries(name: str, replaces: str, rows: list, bf16_case: str,
                   f32_case: str) -> list:
    """The kernels line's entries of both flash routes, from the rows of
    the named cases."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    out = []
    for dt, case, suffix in (("bfloat16", bf16_case, ""),
                             ("float32", f32_case, F32_ENTRY)):
        r = next(x for x in rows if x["case"] == case)
        out.append({"name": name + suffix, "route": "cuda",
                    "source": FLASH_SOURCES[dt], "replaces": replaces,
                    "launches": 0, **{k: r[k] for k in keys}})
    return out


def _ssd_work(b, t, h, dh, ds) -> tuple:
    """(bytes, float ops) of the SSD scan at the kernel's chunk: x, B, C
    and dt read once, y written once (float32); C B^T once a chunk (the
    heads share it), the lower triangles of it and of G x, and C S and the
    state update per head."""
    tri = sum(n * (n + 1) // 2 for n in
              (min(SSD_Q, t - c) for c in range(0, t, SSD_Q)))
    nbytes = 4 * (2 * b * t * h * dh + 2 * b * t * ds + b * t * h + 2 * h)
    ops = 2 * b * tri * ds + 2 * b * h * (tri * dh + 2 * t * ds * dh)
    return nbytes, ops


def _tc_bound(nbytes: float, ops: float, passes: int = 3) -> dict:
    """The tensor cores' bound: ``passes`` x the operations at TF32's rate
    (3xTF32 runs three products for each), or the bytes."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = passes * ops / TF32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _sass_count(lib_path: str, opcode: str) -> int:
    """Lines of ``opcode`` in the SASS of a built library (cuobjdump from
    the toolkit that built it)."""
    from repro_torch.kernels import _build
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", lib_path], capture_output=True,
                         text=True, timeout=120)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr[-500:]}")
    return sum(1 for ln in out.stdout.splitlines() if opcode in ln)


def _sass_instructions(lib_path: str, kernel: str) -> dict:
    """The instructions (NOPs left out) in the SASS of the one function of
    a built library whose name holds ``kernel``: their number, the number
    of each opcode (its first word), and the number inside its innermost
    loop (the shortest span that a backward branch closes: one pass of HH's
    substep loop, slow paths such as a division's called out of line)."""
    import re
    from collections import Counter
    from repro_torch.kernels import _build
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", lib_path], capture_output=True,
                         text=True, timeout=120)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr[-500:]}")
    funcs = [f for f in re.split(r"\n\s*Function : ", out.stdout)[1:]
             if kernel in f.split("\n", 1)[0]]
    check(len(funcs) == 1, f"{len(funcs)} functions named like {kernel} in "
          f"{lib_path}")
    code = [(int(a, 16), op, rest) for a, op, rest in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)"
        r"([^;]*);", funcs[0]) if not op.startswith("NOP")]
    loops = [(addr - int(t, 16), int(t, 16), addr) for addr, op, rest in code
             if op.startswith("BRA")
             for t in re.findall(r"0x([0-9a-f]+)", rest)
             if int(t, 16) < addr]      # not the idle self-branch after EXIT
    body = 0
    if loops:
        _, lo, hi = min(loops)
        body = sum(1 for addr, _, _ in code if lo <= addr <= hi)
    by_op = Counter(op.split(".")[0] for _, op, _ in code)
    return {"instructions": len(code), "loop_body": body,
            "by_opcode": dict(by_op.most_common())}


def compare_ssd(torch, report) -> list:
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.models.ssm import ssd_chunked
    dev = torch.device("cuda")
    rows = []
    with phase("2d. ssd_scan against its plain version (ssd_chunked)"):
        print(f"torch.backends.cuda.matmul.allow_tf32 = "
              f"{torch.backends.cuda.matmul.allow_tf32}")
        check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
        hmma = _sass_count(str(_build.library_path("ssd_scan")), "HMMA")
        print(f"ssd_scan.cu: {hmma} HMMA (tensor-core mma) instructions in "
              "its SASS")
        check(hmma > 0, "the ssd_scan kernel has no tensor-core instruction")
        report["ssd_hmma_instructions"] = hmma
        gen = torch.Generator(device=dev).manual_seed(3)
        for name, (b, t, h, dh, ds) in SSD_CASES:
            def rand(*shape):
                return torch.rand(shape, device=dev, generator=gen)

            def randn(*shape):
                return torch.randn(shape, device=dev, generator=gen)

            x, dt = randn(b, t, h, dh), 0.001 + 0.1 * rand(b, t, h)
            A = -torch.exp(2.0 * rand(h))
            B, C, D = randn(b, t, 1, ds), randn(b, t, 1, ds), randn(h)
            y = SSD.ssd_scan(x, dt, A, B, C, D)
            ref = ssd_chunked(x, dt, A, B, C, D)
            torch.cuda.synchronize()
            err = float((y - ref).abs().max())
            check(bool(torch.allclose(y, ref, rtol=SSD_TOL, atol=SSD_TOL)),
                  f"ssd_scan {name}: max abs err {err} > {SSD_TOL}")
            big = b * t * h > 1e5
            ms = _time_ms(torch, lambda i: SSD.ssd_scan(x, dt, A, B, C, D),
                          20 if big else 50)
            plain_ms = _time_ms(torch, lambda i: ssd_chunked(
                x, dt, A, B, C, D), 3 if big else 10)
            nbytes, ops = _ssd_work(b, t, h, dh, ds)
            f32 = _bound(nbytes, ops)
            row = {"name": "ssd_scan", "case": name,
                   "shape": [b, t, h, dh, ds], "max_abs_err": err,
                   "tol": SSD_TOL, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": None, **_tc_bound(nbytes, ops),
                   "f32_bound_ms": f32["bound_ms"],
                   "f32_bound_by": f32["bound_by"],
                   "bytes": nbytes, "ops": ops,
                   "tflops": ops / ms / 1e9,
                   "plan": SSD.launch_plan(b, t, h, dh, ds)}
            if name == "train":
                row["before_ms"] = SSD_BEFORE_MS
                row["predicted_ms"] = list(SSD_PREDICTED_MS)
                row["bwd_ms"] = _ssd_bwd_ms(torch, SSD, x, dt, A, B, C, D)
                lo, hi = SSD_PREDICTED_MS
                print(f"ssd_scan at the training shape: {ms:.4f} ms "
                      f"(before the tensor cores {SSD_BEFORE_MS}; predicted "
                      f"{lo}-{hi}: {'in' if lo <= ms <= hi else 'out'}); "
                      f"bounds: tensor cores {row['bound_ms']:.4f} "
                      f"({row['bound_by']}), float32 CUDA cores "
                      f"{row['f32_bound_ms']:.4f}; SSDScan backward "
                      f"{row['bwd_ms']:.3f} ms; {report['nvidia_smi']}")
            rows.append(row)
            print(json.dumps(row))
            del x, dt, A, B, C, D, y, ref
        torch.cuda.empty_cache()
        state_rows = [_ssd_state_case(torch, SSD, gen, name, shape)
                      for name, shape in SSD_STATE_CASES]
    report["ssd_table"] = rows
    report["ssd_state_table"] = state_rows
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    r, rs = rows[0], state_rows[0]    # the training and prefill shapes
    return [{"name": "ssd_scan", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
             "replaces": "src/repro/kernels/ssd_scan.py:76", "launches": 0,
             **{k: r[k] for k in keys}},
            {"name": "ssd_scan.state", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
             "replaces": "src/repro/kernels/ssd_scan.py:76", "launches": 0,
             **{k: rs[k] for k in keys}}]


def _ssd_state_case(torch, SSD, gen, name, shape) -> dict:
    """2d's prefill form: y and the final state against ``ssd_chunked(...,
    return_final_state=True)``, times beside the stateless kernel's at the
    same shape and the bound (the bytes of x, B, C, dt, y and the
    state)."""
    from repro_torch.models.ssm import ssd_chunked
    b, t, h, dh, ds = shape
    dev = gen.device
    x = torch.randn((b, t, h, dh), device=dev, generator=gen)
    dt = 0.001 + 0.1 * torch.rand((b, t, h), device=dev, generator=gen)
    A = -torch.exp(2.0 * torch.rand(h, device=dev, generator=gen))
    B, C = (torch.randn((b, t, 1, ds), device=dev, generator=gen)
            for _ in range(2))
    D = torch.randn(h, device=dev, generator=gen)
    y, st = SSD.ssd_scan_state(x, dt, A, B, C, D)
    ref_y, ref_s = ssd_chunked(x, dt, A, B, C, D, return_final_state=True)
    torch.cuda.synchronize()
    err_y = float((y - ref_y).abs().max())
    err_s = float((st - ref_s).abs().max())
    check(bool(torch.allclose(y, ref_y, rtol=SSD_TOL, atol=SSD_TOL)),
          f"ssd_scan_state {name}: y max abs err {err_y} > {SSD_TOL}")
    check(bool(torch.allclose(st, ref_s, rtol=SSD_TOL, atol=SSD_TOL)),
          f"ssd_scan_state {name}: state max abs err {err_s} > {SSD_TOL}")
    del ref_y, ref_s
    ms = _time_ms(torch, lambda i: SSD.ssd_scan_state(x, dt, A, B, C, D), 20)
    no_state_ms = _time_ms(torch, lambda i: SSD.ssd_scan(x, dt, A, B, C, D),
                           20)
    plain_ms = _time_ms(torch, lambda i: ssd_chunked(
        x, dt, A, B, C, D, return_final_state=True), 3)
    nbytes, ops = _ssd_work(b, t, h, dh, ds)
    nbytes += 4 * b * h * ds * dh
    row = {"name": "ssd_scan.state", "case": name, "shape": list(shape),
           "max_abs_err": max(err_y, err_s), "state_max_abs_err": err_s,
           "tol": SSD_TOL, "ms": ms, "no_state_ms": no_state_ms,
           "plain_ms": plain_ms, "library_ms": None,
           **_tc_bound(nbytes, ops), "bytes": nbytes, "ops": ops}
    print(json.dumps(row))
    del x, dt, A, B, C, D, y, st
    torch.cuda.empty_cache()
    return row


def _ssd_bwd_ms(torch, SSD, *inputs) -> float:
    """CUDA-event time of one ``SSDScan`` backward (autograd of the plain
    ``ssd_chunked`` on the saved inputs), every input needing a gradient,
    as in training."""
    ins = [v.detach().clone().requires_grad_(True) for v in inputs]
    y = SSD.SSDScan.apply(*ins)
    gy = torch.randn_like(y)

    def bwd(i):
        torch.autograd.grad(y, ins, gy, retain_graph=True)

    ms = _time_ms(torch, bwd, 3)
    del ins, y, gy
    return ms


def _sdpa_backend(torch, grad_fn) -> str:
    """The device kernels one SDPA backward runs, by name."""
    prof = _device_profile(torch, grad_fn)
    return "; ".join(n for n, _, _ in prof["top"][:3])


def compare_flash_bwd(torch, report) -> list:
    import torch.nn.functional as TF
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref as R
    dev = torch.device("cuda")
    rows = []
    with phase("2e. flash_attention backward against its plain versions"):
        gen = torch.Generator(device=dev).manual_seed(4)
        for name, (b, hq, hkv, t, d), dt, kw in FLASH_BWD_CASES:
            dtype = getattr(torch, dt)
            tq, tk = t if isinstance(t, tuple) else (t, t)
            q, k, v, g = (torch.randn(shape, device=dev, generator=gen
                                      ).to(dtype)
                          for shape in ((b, hq, tq, d), (b, hkv, tk, d),
                                        (b, hkv, tk, d), (b, hq, tq, d)))
            out, lse = FA.flash_attention_fwd(q, k, v, **kw)
            got = FA.flash_attention_bwd(q, k, v, out, lse, g, **kw)
            # no atomics: a second call gives the same bits
            again = FA.flash_attention_bwd(q, k, v, out, lse, g, **kw)
            same = all(bool(torch.equal(a, a2)) for a, a2 in zip(got, again))
            check(same, f"flash_attention_bwd {name}: two calls on the same "
                  "inputs gave different bits")
            del again
            # the plain backward on the same saved tensors
            want = R.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                             out.float(), lse, g.float(),
                                             **kw)
            # autograd through the plain forward
            ins = [x.float().requires_grad_(True) for x in (q, k, v)]
            auto = torch.autograd.grad(R.flash_attention_ref(*ins, **kw),
                                       ins, g.float())
            torch.cuda.synchronize()
            tol_ref, tol_auto = FLASH_BWD_TOL[dt]
            errs, auto_errs = [], []
            for gname, a, w, au in zip("qkv", got, want, auto):
                a = a.float()
                errs.append(float((a - w).abs().max()))
                auto_errs.append(float((a - au).abs().max()))
                if dt == "float32":
                    ok = torch.allclose(a, w, rtol=tol_ref, atol=tol_auto) \
                        and torch.allclose(a, au, rtol=tol_ref,
                                           atol=tol_auto)
                else:
                    ok = torch.allclose(
                        a, w, rtol=tol_ref,
                        atol=tol_ref * float(w.abs().max())) \
                        and torch.allclose(
                            a, au, rtol=tol_auto,
                            atol=tol_auto * float(au.abs().max()))
                check(bool(ok), f"flash_attention_bwd {name} d{gname}: max "
                      f"abs err {errs[-1]} (plain bwd), {auto_errs[-1]} "
                      "(autograd)")
            del want, auto, ins
            torch.cuda.empty_cache()
            pairs, mask = _visible_pairs(torch, tq, tk, **kw)
            lib_ms = lib_backend = None
            if "softcap" not in kw:       # no PyTorch call soft-caps
                lib_kw = ({"is_causal": kw["causal"]} if set(kw) == {"causal"}
                          else {"attn_mask": mask})
                lq, lk, lv = (x.detach().requires_grad_(True)
                              for x in (q, k, v))
                lo = TF.scaled_dot_product_attention(lq, lk, lv,
                                                     enable_gqa=True,
                                                     **lib_kw)

                def lib(i):
                    return torch.autograd.grad(lo, (lq, lk, lv), g,
                                               retain_graph=True)

                lib_err = max(float((x.float() - w.float()).abs().max())
                              for x, w in zip(lib(0), got))
                check(lib_err < 0.05 * max(float(w.float().abs().max())
                                           for w in got),
                      f"flash_attention_bwd {name}: the library yardstick "
                      f"computes another gradient (max abs err {lib_err})")

                def lib_once():
                    lib(0)
                    torch.cuda.synchronize()

                lib_backend = _sdpa_backend(torch, lib_once)
            reps = 5 if b * hq * tq * tk * d > 1e9 else 20
            ms = _time_ms(torch, lambda i: FA.flash_attention_bwd(
                q, k, v, out, lse, g, **kw), reps)
            plain_ms = _time_ms(torch, lambda i: R.flash_attention_bwd_ref(
                q, k, v, out, lse, g, **kw), max(2, reps // 5))
            if lib_backend is not None:
                lib_ms = _time_ms(torch, lib, reps)
                del lo, lq, lk, lv
            es = q.element_size()
            nbytes = (es * (4 * b * hq * tq * d + 4 * b * hkv * tk * d)
                      + 4 * b * hq * tq)
            flops = 10.0 * b * hq * d * pairs
            row = {"name": "flash_attention_bwd", "case": name,
                   "shape": [b, hq, hkv, t, d], "dtype": dt, "options": kw,
                   "tol": FLASH_BWD_TOL[dt], "max_abs_err": max(errs),
                   "max_abs_err_autograd": max(auto_errs),
                   "bit_equal_calls": same, "ms": ms,
                   "plain_ms": plain_ms, "library_ms": lib_ms,
                   "library_kernels": lib_backend,
                   **_flash_bounds(dt, nbytes, flops),
                   "bytes": nbytes, "flops": flops,
                   "tflops": flops / ms / 1e9}
            rows.append(row)
            print(json.dumps(row))
            del q, k, v, g, out, lse, got, mask
            torch.cuda.empty_cache()
    report["flash_bwd_table"] = rows
    # the training shape (bf16) and its float32 counterpart
    return _flash_entries("flash_attention_bwd",
                          "src/repro/kernels/flash_xla.py:121", rows,
                          "train", "train_b1_f32")


def _ulp(torch, a, b) -> int:
    """The largest distance between two float32 tensors in float32 steps
    (of one sign, as draws of one key are)."""
    return int((a.view(torch.int32).long()
                - b.view(torch.int32).long()).abs().max())


def compare_threefry(torch, report) -> list:
    """Phase 2f: the threefry kernels against their plain version on the
    card, at the SNN paths' shapes; times beside the bound and, as a
    yardstick, torch.randn at the same shape (Philox, another function)."""
    from repro_torch import random as RND
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import threefry as TFK
    dev = torch.device("cuda")
    rows = []
    with phase("2f. threefry kernels against their plain version"):
        for b in (1, 8):
            keys = RND.split(RND.PRNGKey(1234), b).to(dev)
            for num in THREEFRY_SPLITS:
                got = TFK.threefry_split(keys, num)
                check(bool(torch.equal(got, R.threefry_split_ref(keys, num)))
                      and bool(torch.equal(got.cpu(), R.threefry_split_ref(
                          keys.cpu(), num))),
                      f"threefry_split B={b} num={num}: not bit-equal")
                kern = lambda i, n=num: TFK.threefry_split(keys, n)
                plain = lambda i, n=num: R.threefry_split_ref(keys, n)
                nbytes = b * 8 + b * num * 8
                t_ops = b * num * THREEFRY_INT_OPS / INT32_OPS * 1e3
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                row = {"name": "threefry_split", "B": b, "num": num,
                       "max_abs_err": 0.0,
                       "ms": _device_ms(torch, kern, 50, "threefry")[0],
                       "wall_ms": _time_ms(torch, kern, 50),
                       "plain_ms": _device_ms(torch, plain, 20)[0],
                       "bound_ms": max(t_bytes, t_ops),
                       "bound_by": ("bytes" if t_bytes >= t_ops
                                    else "operations"),
                       "library_ms": None}
                rows.append(row)
                print(json.dumps(row))
            # a step's subkeys: a strided column of its split
            sub = TFK.threefry_split(keys, THREEFRY_SPLITS[0])[:, 1]
            for what, n, dist, scale in THREEFRY_DRAWS:
                bits = TFK.threefry_draw(sub, n, "bits")
                check(bool(torch.equal(bits, R.threefry_draw_ref(
                    sub, n, "bits"))), f"threefry bits {what} B={b}")
                got = TFK.threefry_draw(sub, n, dist, scale)
                want = R.threefry_draw_ref(sub, n, dist, scale)
                err = float((got - want).abs().max())
                if dist == "normal":
                    ulp = _ulp(torch, got, want)
                    check(ulp <= NORMAL_ULP, f"threefry normal {what} B={b}:"
                          f" {ulp} ulp from the plain version")
                else:
                    ulp = 0
                    check(bool(torch.equal(got, want)),
                          f"threefry uniform {what} B={b}: not bit-equal")
                kern = lambda i: TFK.threefry_draw(sub, n, dist, scale)
                plain = lambda i: R.threefry_draw_ref(sub, n, dist, scale)
                randn = lambda i: torch.randn(b, n, device=dev)
                t_bytes = (b * n * 4 + b * 8) / HBM_BYTES_PER_S * 1e3
                t_ops = max(b * n * THREEFRY_INT_OPS / INT32_OPS,
                            (b * n * NORMAL_FLOAT_OPS / FP32_FLOPS
                             if dist == "normal" else 0.0)) * 1e3
                row = {"name": "threefry_draw", "B": b, "case": what, "n": n,
                       "draw": dist, "max_abs_err": err, "max_ulp": ulp,
                       "ms": _device_ms(torch, kern, 50, "threefry")[0],
                       "wall_ms": _time_ms(torch, kern, 50),
                       "plain_ms": _device_ms(torch, plain, 20)[0],
                       "bound_ms": max(t_bytes, t_ops),
                       "bound_by": ("bytes" if t_bytes >= t_ops
                                    else "operations"),
                       "library_ms": None,
                       "randn_ms": _device_ms(torch, randn, 50)[0]}
                rows.append(row)
                print(json.dumps(row))
        rows += _compare_construction_draws(torch, dev)
    report["threefry_table"] = rows
    entries = []
    for name, replaces, pick in (
            ("threefry_split", "src/repro/core/snn/simulator.py:210",
             lambda r: r["B"] == 1 and r["num"] == THREEFRY_SPLITS[0]),
            ("threefry_draw", "src/repro/core/models/izhikevich_net.py:62",
             lambda r: r["B"] == 1 and r["case"] == "main exc"),
            ("threefry_fold_in", "src/repro/sparse/device_init.py:163",
             lambda r: r["case"] == "a word into each row key"),
            ("threefry_draw.randint", "src/repro/sparse/device_init.py:158",
             lambda r: r["span"] == CONSTRUCT["spans"][0])):
        r = next(x for x in rows if x["name"] == name and pick(x))
        entries.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/threefry.cu",
            "replaces": replaces, "launches": 0,
            **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")}})
    return entries


def _compare_construction_draws(torch, dev) -> list:
    """Phase 2f's construction entries on the card at main's exc group's
    shapes: ``threefry_fold_in`` (the rows' indices into one key, and one
    word into each of 80000 row keys) and ``threefry_draw``'s randint draw
    at [80000 keys, 1000] for each span of CONSTRUCT, bit-equal to their plain
    versions on the card, and the first rows to the plain versions on the
    CPU; the affine uniform draw (the weights') likewise.  Times beside the
    bound and, as a yardstick, torch.randint (Philox, another function)."""
    from repro_torch import random as RND
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import threefry as TFK
    n, k, m = CONSTRUCT["rows"], CONSTRUCT["k"], CONSTRUCT["cpu_rows"]
    key = RND.PRNGKey(1234).to(dev).reshape(1, 2)
    rks = TFK.threefry_split(key, n)[0]
    rows_t = torch.arange(n, dtype=torch.int32, device=dev)
    out = []
    for what, keys, data in (("the rows into one key", key, rows_t),
                             ("a word into each row key", rks, 7)):
        got = TFK.threefry_fold_in(keys, data)
        cpu_data = data.cpu() if isinstance(data, torch.Tensor) else data
        check(bool(torch.equal(got, R.threefry_fold_in_ref(keys, data)))
              and bool(torch.equal(got.cpu(), R.threefry_fold_in_ref(
                  keys.cpu(), cpu_data))),
              f"threefry_fold_in ({what}) at {n} keys: not bit-equal")
        kern = lambda i: TFK.threefry_fold_in(keys, data)
        plain = lambda i: R.threefry_fold_in_ref(keys, data)
        nbytes = keys.shape[0] * 8 + n * 8 + (
            n * 4 if isinstance(data, torch.Tensor) else 0)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = n * THREEFRY_INT_OPS / INT32_OPS * 1e3
        row = {"name": "threefry_fold_in", "case": what, "n": n,
               "max_abs_err": 0.0,
               "ms": _device_ms(torch, kern, 50, "threefry")[0],
               "wall_ms": _time_ms(torch, kern, 50),
               "plain_ms": _device_ms(torch, plain, 20)[0],
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": None}
        out.append(row)
        print(json.dumps(row))
    for span in CONSTRUCT["spans"]:
        got = TFK.threefry_draw(rks, k, "randint", span=span)
        want = R.threefry_draw_ref(rks, k, "randint", span=span)
        check(bool(torch.equal(got, want)) and bool(torch.equal(
            got[:m].cpu(), R.threefry_draw_ref(rks[:m].cpu(), k, "randint",
                                               span=span))),
              f"randint draw span {span} at [{n}, {k}]: not bit-equal")
        check(int(got.min()) >= 0 and int(got.max()) < span,
              f"randint draw span {span}: a draw out of range")
        del want
        if span != CONSTRUCT["spans"][0]:
            continue
        kern = lambda i: TFK.threefry_draw(rks, k, "randint", span=span)
        plain = lambda i: R.threefry_draw_ref(rks, k, "randint", span=span)
        randint = lambda i: torch.randint(0, span, (n, k), device=dev,
                                          dtype=torch.int32)
        # the least work: each row's two keys once, each element's two
        # words and its arithmetic
        ops = n * 2 * THREEFRY_INT_OPS + n * k * (2 * THREEFRY_INT_OPS
                                                  + RANDINT_EXTRA_OPS)
        t_ops = ops / INT32_OPS * 1e3
        t_bytes = (n * 8 + n * k * 4) / HBM_BYTES_PER_S * 1e3
        row = {"name": "threefry_draw.randint", "span": span, "rows": n,
               "k": k,
               "max_abs_err": 0.0,
               "ms": _device_ms(torch, kern, 10, "threefry")[0],
               "wall_ms": _time_ms(torch, kern, 10),
               "plain_ms": _device_ms(torch, plain, 3)[0],
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": None,
               "randint_ms": _device_ms(torch, randint, 10)[0]}
        out.append(row)
        print(json.dumps(row))
        torch.cuda.empty_cache()
    # the weights' affine uniform draw (lo = 0 and lo != 0) at the same rows
    for scale, offset in ((0.5, None), (-1.3, 0.25)):
        got = TFK.threefry_draw(rks, k, "uniform", scale, offset)
        want = R.threefry_draw_ref(rks, k, "uniform", scale, offset)
        check(bool(torch.equal(got.view(torch.int32),
                               want.view(torch.int32))),
              f"affine uniform draw ({scale}, {offset}): not bit-equal")
    print(f"  affine uniform draws at [{n}, {k}] bit-equal to the plain "
          "version (lo = 0 and lo != 0)")
    return out


def _kernel_modules():
    from repro_torch.kernels import (delay_ring, ell_spmv, flash_attention,
                                     hh_step, izhikevich_step, spike_bitmask,
                                     ssd_scan, threefry)
    return (ell_spmv, izhikevich_step, hh_step, flash_attention, ssd_scan,
            delay_ring, threefry, spike_bitmask)


def reset_launches() -> None:
    for m in _kernel_modules():
        m.reset_launches()


def read_launches() -> dict:
    out: dict = {}
    for m in _kernel_modules():
        out.update(m.launches)
    return out


@contextlib.contextmanager
def plain_versions():
    """Route every kernel's wrapper to its plain version on the card, for
    the comparison runs only (the port itself never does this)."""
    from unittest import mock
    from repro_torch.kernels import ref as R
    K, IZ, HH, FA, SSD, DR, TFK, SBK = _kernel_modules()
    with mock.patch.object(K, "ell_spmv", R.ell_spmv_ref), \
            mock.patch.object(K, "ell_spmv_delay", R.ell_spmv_delay_ref), \
            mock.patch.object(K, "ell_spmv_delay_into",
                              R.ell_spmv_delay_into_ref), \
            mock.patch.object(DR, "delay_ring_fold",
                              R.delay_ring_fold_ref), \
            mock.patch.object(IZ, "izhikevich_step", R.izhikevich_step_ref), \
            mock.patch.object(HH, "hh_step", R.hh_step_ref), \
            mock.patch.object(FA, "flash_attention", R.flash_attention_ref), \
            mock.patch.object(FA, "flash_attention_fwd",
                              R.flash_attention_fwd_ref), \
            mock.patch.object(FA, "flash_attention_bwd",
                              R.flash_attention_bwd_ref), \
            mock.patch.object(SSD, "ssd_scan", SSD._plain), \
            mock.patch.object(SSD, "ssd_scan_state", _ssd_state_plain), \
            mock.patch.object(TFK, "threefry_split", R.threefry_split_ref), \
            mock.patch.object(TFK, "threefry_draw", R.threefry_draw_ref), \
            mock.patch.object(TFK, "threefry_fold_in",
                              R.threefry_fold_in_ref), \
            mock.patch.object(SBK, "spike_bitmask", R.spike_bitmask_ref), \
            mock.patch.object(SBK, "spike_bitmask_into", _bitmask_into_ref):
        yield


def _ssd_state_plain(x, dt, A, B, C, D=None, initial_state=None):
    """``ssd_scan_state``'s plain version (``ssd_chunked`` with the final
    state)."""
    from repro_torch.kernels import ssd_scan as SSD
    return SSD._plain(x, dt, A, B, C, D, initial_state=initial_state,
                      return_final_state=True)


def _bitmask_into_ref(bits, ring, slot, active=None):
    """The ring variant's plain version, for a host or a device slot."""
    from repro_torch.kernels import ref as R
    if isinstance(slot, int):
        ring[slot].copy_(R.spike_bitmask_ref(bits))
    else:
        R.spike_bitmask_into_ref(bits, ring, slot, active)


def _raster_agreement(torch, a, b) -> float:
    num = sum(int((a[k] == b[k]).sum()) for k in a)
    den = sum(a[k].numel() for k in a)
    return num / den


def _flash_kernels(direction: str) -> tuple:
    """The device kernels of both flash routes, forward ("fwd") or
    backward ("bwd"), by the names a profile shows."""
    from repro_torch.kernels import flash_attention as FA
    return tuple(n for r in FA.ROUTES.values() for n in r[direction])


def _device_profile(torch, fn, warm: bool = False) -> dict:
    """Device time by kernel name and the wall time of ``fn()`` under
    torch.profiler (``fn`` ends in a synchronise).  With ``warm`` (the
    short kernel and SNN traces) ``fn`` runs twice and only the second run
    is kept, since a trace that starts cold can miss the device ops of its
    first milliseconds; the LM phases trace one run.  In both modes a trace
    that holds no device op at all is taken again, up to six times, so
    ``fn`` may run again: on the card, in two of three full runs one such
    trace came back empty after ~50 earlier ones in the process (and once
    the first trace of phase 2e's SDPA backward; once three running, in
    phase 9a)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for _ in range(6):
        if warm:
            with profile(activities=activities,
                         schedule=schedule(wait=0, warmup=1, active=1,
                                           repeat=1)) as prof:
                fn()
                prof.step()
                t0 = time.perf_counter()
                fn()
                wall_us = (time.perf_counter() - t0) * 1e6
                prof.step()
        else:
            with profile(activities=activities) as prof:
                t0 = time.perf_counter()
                fn()
                wall_us = (time.perf_counter() - t0) * 1e6
        by_name: dict = {}
        for e in prof.events():
            # a schedule's step markers show on the device timeline as
            # annotations spanning the step: they are not device work
            if (e.device_type == DeviceType.CUDA
                    and not e.name.startswith("ProfilerStep")
                    and not getattr(e, "is_user_annotation", False)):
                key = e.name[:100]
                n, us = by_name.get(key, (0, 0.0))
                by_name[key] = (n + 1, us + e.time_range.elapsed_us())
        busy = sum(us for _, us in by_name.values())
        if busy > 0:
            break
    check(busy > 0, "the profiler saw no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {"wall_us": wall_us, "device_busy_us": busy,
            "busy_share": busy / wall_us,
            "device_ops": sum(n for n, _ in by_name.values()),
            "top": [[n[:80], c, us] for n, (c, us) in top[:8]],
            "by_name": {n: [c, us] for n, (c, us) in top}}


def _profile_window(torch, run, steps: int, guard: bool = True) -> dict:
    """Device busy share, device ops per step and the kernels that fill the
    busy time, from a torch.profiler trace of ``run(steps)`` (``run(n)``
    runs n steps, eagerly or replayed from graphs).  Profiling slows the
    host, so the idle share it shows is an upper bound.  With ``guard``
    (eager runs only: a graph keeps the ops it captured) also the device
    ops and time a step of the NaN guard."""
    run(2)
    torch.cuda.synchronize()

    def window():
        run(steps)
        torch.cuda.synchronize()

    def traced():
        """The trace and the port's kernels in it (device time per launch,
        by name).  A trace that kept some steps' launches of them and not
        others dropped events (see _device_ms): it is taken again."""
        for _ in range(3):
            prof = _device_profile(torch, window, warm=True)
            ours = {n[:80]: {"launches": c, "us_per_launch": us / c}
                    for n, (c, us) in prof["by_name"].items()
                    if any(k in n for k in ("ell_spmv",
                                            "delay_ring_fold",
                                            "izhikevich_step_kernel",
                                            "hh_step_kernel", "threefry",
                                            *_flash_kernels("fwd")))}
            whole = bool(ours) and all(v["launches"] % steps == 0
                                       for v in ours.values())
            if whole:
                break
        check(whole, f"traces of {steps} steps kept {ours}")
        return prof, ours

    prof, ours = traced()
    busy_us, wall_us = prof["device_busy_us"], prof["wall_us"]
    top = [(n, us) for n, _, us in prof["top"][:6]]
    print(f"profiled {steps} steps: device busy {busy_us:.0f} of "
          f"{wall_us:.0f} us ({100 * busy_us / wall_us:.1f}%), "
          f"{prof['device_ops'] / steps:.1f} device ops/step; top: "
          + "; ".join(f"{n[:40]} {us:.0f} us" for n, us in top))
    print(f"the port's kernels on the device: {ours}")
    out = {"steps": steps, "wall_us": wall_us, "device_busy_us": busy_us,
           "busy_share": prof["busy_share"],
           "device_us_per_step": busy_us / steps,
           "device_ops_per_step": prof["device_ops"] / steps,
           "top_us": [list(x) for x in top], "kernels": ours,
           "by_name": prof["by_name"]}
    if guard:
        # the same window with the NaN guard's isfinite fold (codegen'd
        # populations) and its copy of the flag (fused ones) patched out:
        # the difference is what the guard costs a step (the flag that the
        # fused kernels write in their epilogues costs no device op of its
        # own)
        from unittest import mock
        from repro_torch.core.snn import simulator as S
        with mock.patch.object(S, "fold_finite",
                               lambda finite, arrays: finite), \
                mock.patch.object(S, "own_flag", lambda finite: finite):
            bare, _ = traced()
        out["guard_ops_per_step"] = (prof["device_ops"]
                                     - bare["device_ops"]) / steps
        out["guard_busy_us_per_step"] = (busy_us
                                         - bare["device_busy_us"]) / steps
        print(f"the NaN guard: {out['guard_ops_per_step']:.1f} device "
              f"ops/step, {out['guard_busy_us_per_step']:.2f} us device "
              "time/step")
    return out


def _profiles(torch, model, steps: int, batch: int = 1,
              gscales=None) -> dict:
    """Profiles of ``steps`` steps eagerly (with the NaN guard's cost) and
    replayed from graphs, from a fresh state of ``batch`` members."""
    sim = model.simulator
    st = sim.init_state(batch)
    print("eager:")
    eager = _profile_window(torch, lambda n: sim.run(st, n, gscales),
                            steps)
    print("graph:")
    graph = _profile_window(
        torch, lambda n: sim.run_compiled(st, n, gscales), steps,
        guard=False)
    return {"eager": eager, "graph": graph}


def _state_tensors(state, prefix: str = "") -> dict:
    """name -> tensor of every tensor of a SimState: neurons, spikes,
    prev_above, synapse state (rings, cursors, traces), t, key, finite."""
    import dataclasses
    import torch
    if isinstance(state, torch.Tensor):
        return {prefix: state}
    out = {}
    if isinstance(state, dict):
        for k in sorted(state):
            out.update(_state_tensors(state[k], f"{prefix}.{k}"))
    elif dataclasses.is_dataclass(state):
        for f in dataclasses.fields(state):
            out.update(_state_tensors(getattr(state, f.name),
                                      f"{prefix}.{f.name}"))
    return out


def _check_same_run(torch, a, b, what: str, raster: bool = False) -> None:
    """Two RunResults bit for bit: spike counts (rasters), and every state
    tensor's dtype, shape and bits."""
    for k in a.spike_counts:
        check(bool(torch.equal(a.spike_counts[k], b.spike_counts[k])),
              f"{what}: {k} spike counts differ between eager and graph")
        if raster:
            check(bool(torch.equal(a.raster[k], b.raster[k])),
                  f"{what}: {k} rasters differ between eager and graph")
    sa, sb = _state_tensors(a.state), _state_tensors(b.state)
    check(sa.keys() == sb.keys(), f"{what}: the states hold other tensors")
    for k, x in sa.items():
        y = sb[k]
        same = x.dtype == y.dtype and x.shape == y.shape
        if same and x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        check(same and bool(torch.equal(x, y)),
              f"{what}: state {k} differs between eager and graph")


def _eager_vs_graph(torch, model, what: str, steps: int, batch: int = 1,
                    grids=None, sim=None) -> tuple:
    """Each gScale set of ``grids`` (group name -> value) run for ``steps``
    from one fresh state, eagerly (``Simulator.run``) and through the graph
    route (``Simulator.run_compiled``, as ``CompiledModel.run`` and
    ``sweep_gscale`` run), after one graph run that captures: the graph
    runs must equal the eager ones bit for bit, launch the same kernels as
    often, and later sets replay the first set's capture; then rasters over
    RASTER_CHECK_STEPS.  ``sim``: what runs them (default the model's
    Simulator; phase 13 passes its ShardedEngine).  Returns (the numbers,
    the graph runs, the graph runs' launch counts)."""
    sim = model.simulator if sim is None else sim
    grids = list(grids or [{}])
    st = sim.init_state(batch)
    captures0 = sim.graph_counts["captures"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run_compiled(st, steps, grids[0])
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    captures = sim.graph_counts["captures"] - captures0
    sets, runs, launches = [], [], []
    for gs in grids:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e = sim.run(st, steps, gs)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        le = read_launches()
        reset_launches()
        replays0 = sim.graph_counts["replays"]
        t0 = time.perf_counter()
        g = sim.run_compiled(st, steps, gs)
        torch.cuda.synchronize()
        graph_s = time.perf_counter() - t0
        lg = read_launches()
        check(lg == le, f"{what}: the graph run launched {lg}, the eager "
              f"run {le}")
        _check_same_run(torch, e, g, what)
        sets.append({"eager_s": eager_s, "graph_s": graph_s,
                     "eager_us_per_step": eager_s / steps * 1e6,
                     "graph_us_per_step": graph_s / steps * 1e6,
                     "eager_candidates_per_s": batch / eager_s,
                     "graph_candidates_per_s": batch / graph_s,
                     "replays": sim.graph_counts["replays"] - replays0})
        runs.append(g)
        launches.append(lg)
        del e
    check(sim.graph_counts["captures"] - captures0 == captures,
          f"{what}: a later gScale set captured anew")
    n = min(steps, RASTER_CHECK_STEPS)
    _check_same_run(torch, sim.run(st, n, grids[0], record_raster=True),
                    sim.run_compiled(st, n, grids[0], record_raster=True),
                    what, raster=True)
    out = {"steps": steps, "batch": batch, "first_graph_run_s": first_s,
           "capture_s": first_s - sets[0]["graph_s"], "captures": captures,
           "sets": sets}
    for i, x in enumerate(sets):
        print(f"{what} (set {i}): eager {x['eager_us_per_step']:.1f} "
              f"us/step, graph {x['graph_us_per_step']:.1f} us/step "
              f"({x['replays']} replays); B={batch}: "
              f"{x['eager_candidates_per_s']:.3f} / "
              f"{x['graph_candidates_per_s']:.3f} candidates/s")
    print(f"{what}: first graph run {first_s:.3f} s ({captures} captures, "
          f"~{out['capture_s']:.3f} s more than a replayed run); graph "
          f"equals eager bit for bit (state, counts; rasters over {n} "
          "steps)")
    return out, runs, launches


def _run_digest(torch, res, state=None) -> str:
    """sha256 over a run's spike counts, raster (when recorded) and every
    tensor of its state (``state``: in place of ``res.state``), name by
    name: phase 13 holds the engine's runs to phases 5's and 12c's by it
    (the digest of one run is a few hundred MB less to keep)."""
    import hashlib
    tensors = {f"counts.{k}": v for k, v in res.spike_counts.items()}
    if res.raster is not None:
        tensors.update({f"raster.{k}": v for k, v in res.raster.items()})
    tensors.update(_state_tensors(res.state if state is None else state,
                                  "state"))
    h = hashlib.sha256()
    for k in sorted(tensors):
        t = tensors[k].detach().contiguous().cpu()
        h.update(f"{k} {t.dtype} {tuple(t.shape)}".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _run_checked(torch, model, steps, what, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = model.run(steps, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rates = {k: float(v) for k, v in res.rates_hz.items()}
    finite = bool(res.finite)
    print(f"{what}: {steps} steps in {secs:.3f} s "
          f"({secs / steps * 1e6:.1f} us/step), rates Hz {rates}, "
          f"finite {finite}")
    check(finite, f"{what}: state went non-finite")
    check(all(0.0 < r < float("inf") for r in rates.values()),
          f"{what}: a population is silent or its rate is not finite: "
          f"{rates}")
    return res, secs, rates


def _plain_agreement(torch, model, n: int, **run_kw) -> tuple:
    """n steps eagerly through the kernels and through the plain versions
    (no kernel launched), from one fresh state: (raster agreement, the two
    runs)."""
    sim = model.simulator
    st = sim.init_state()
    kr = sim.run(st, n, record_raster=True, **run_kw)
    reset_launches()
    with plain_versions():
        pr = sim.run(st, n, record_raster=True, **run_kw)
    check(not any(read_launches().values()),
          f"the plain run launched kernels: {read_launches()}")
    agree = _raster_agreement(torch, kr.raster, pr.raster)
    print(f"raster agreement kernel vs plain over {n} steps: {agree}")
    check(agree >= RASTER_AGREEMENT, f"rasters agree on only {agree}")
    return agree, kr, pr


def main_path(torch, report):
    from repro_torch.core.models import izhikevich_net as IZ
    with phase("3. main path: Izhikevich net, 100k neurons"):
        cfg = IZ.IzhikevichNetConfig(n_total=MAIN["n_total"],
                                     n_conn=MAIN["n_conn"],
                                     representation="sparse")
        t0 = time.perf_counter()
        model = IZ.compile_model(cfg)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        groups = [(g.name, g.representation, g.ell.n_pre, g.ell.max_conn,
                   int(g.ell.valid.sum())) for g in model.network.synapses]
        print(f"built {model} in {build_s:.1f} s; groups {groups}")
        n_sparse = sum(1 for g in model.network.synapses
                       if g.representation == "sparse")
        check(n_sparse == 4, f"expected 4 sparse groups, got {groups}")
        check(model.simulator.routes == {"exc": "izhikevich_step",
                                         "inh": "izhikevich_step"},
              f"neuron routes {model.simulator.routes}")
        steps = MAIN["steps"]
        graph, _, _ = _eager_vs_graph(torch, model, "main", steps)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        res, secs, rates = _run_checked(torch, model, steps, "kernel run")
        launches = read_launches()
        print(f"launches in the main-path run: {launches}")
        check(launches["ell_spmv"] >= n_sparse * steps,
              f"ell_spmv launched {launches['ell_spmv']} times for "
              f"{n_sparse} sparse groups x {steps} steps")
        for name, per_step in (("izhikevich_step", 2), ("threefry_split", 1),
                               ("threefry_draw", 2)):
            check(launches[name] == per_step * steps,
                  f"{name} launched {launches[name]} times for "
                  f"{per_step} x {steps} steps")
        report["main"] = {
            "config": MAIN, "build_s": build_s, "groups": groups,
            "seconds": secs, "us_per_step": secs / steps * 1e6,
            "rates_hz": rates, "launches": launches,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "eager_vs_graph": graph,
            "graph_counts": dict(model.simulator.graph_counts)}
        agree, _, _ = _plain_agreement(torch, model, MAIN["plain_steps"])
        report["main"]["plain_raster_agreement"] = agree
        report["main"]["profile"] = _profiles(torch, model, 50)
        return launches, model


def sweep(torch, report, model) -> None:
    from repro_torch.core import conductance as C
    with phase("4. gScale sweep of the excitatory groups"):
        values, steps = list(SWEEP["values"]), SWEEP["steps"]
        names = model._expand_group("exc")
        grids = [{n: torch.tensor(v, device="cuda") for n in names}
                 for v in (values, SWEEP["values_b"])]
        graph, _, _ = _eager_vs_graph(torch, model, "sweep", steps,
                                      batch=len(values), grids=grids)
        captures = model.simulator.graph_counts["captures"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = model.sweep_gscale("exc", values, steps)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(model.simulator.graph_counts["captures"] == captures,
              "sweep_gscale captured anew for values of a captured grid")
        rates = {k: v.tolist() for k, v in s.rates_hz.items()}
        finite = s.finite.tolist()
        print(f"{len(values)} candidates x {steps} steps in "
              f"{secs:.3f} s: {len(values) / secs:.3f} candidates/s")
        for i, v in enumerate(values):
            print(f"  gScale {v}: " + ", ".join(
                f"{k} {rates[k][i]:.4f} Hz" for k in rates)
                + f", finite {finite[i]}")
        for k, r in rates.items():
            fin = [x for x, ok in zip(r, finite) if ok]
            check(all(b >= a for a, b in zip(fin, fin[1:])),
                  f"{k} rate falls as gScale grows: {r}")
        target = report["main"]["rates_hz"]["exc"]
        pick = C.search_sweep(lambda c: (s.rates_hz["exc"], s.finite),
                              values, target)
        print(f"search_sweep to the main run's exc rate {target:.4f} Hz: "
              f"{pick}")
        check(pick.finite and min(abs(pick.gscale - v) for v in values)
              < 1e-6, f"search_sweep picked {pick}")
        report["sweep"] = {"values": values, "steps": steps,
                           "seconds": secs,
                           "candidates_per_s": len(values) / secs,
                           "rates_hz": rates, "finite": finite,
                           "pick": pick.__dict__, "eager_vs_graph": graph}


def build_delay_model(torch, init: str = "host", mesh=None):
    """Phase 5's net: the main path's, with per-synapse delays
    ``UniformIntDelay(0, DELAY["max_delay"])`` on the excitatory groups,
    built with ``init`` (over ``mesh``, phase 13).  Returns (model, build
    seconds)."""
    from repro_torch.core.models import izhikevich_net as IZ
    from repro_torch.core.snn.spec import ModelSpec
    from repro_torch.sparse.formats import UniformIntDelay
    cfg = IZ.IzhikevichNetConfig(n_total=DELAY["n_total"],
                                 n_conn=DELAY["n_conn"],
                                 representation="sparse")
    base = IZ.spec(cfg)
    ms = ModelSpec(f"{base.name}_delayed")
    for pop in base.populations.values():
        ms.add_neuron_population(pop.name, pop.n, pop.model, pop.params,
                                 pop.input_fn)
    for sp in base.synapses:
        ms.add_synapse_population(
            sp.name, sp.pre, list(sp.post), sp.connect, sp.weight,
            representation="sparse",
            delay=(UniformIntDelay(0, DELAY["max_delay"])
                   if sp.name == "exc" else None))
    t0 = time.perf_counter()
    model = ms.build(dt=cfg.dt, seed=cfg.seed, init=init, mesh=mesh)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def delay_path(torch, report) -> dict:
    with phase("5. delay path: 100k neurons, per-synapse delays 0..20 "
               "steps"):
        model, build_s = build_delay_model(torch)
        delayed = [g for g in model.network.synapses
                   if g.ell.delay is not None]
        rings = [(g.name, g.ring_slots if g.needs_ring else 0)
                 for g in model.network.synapses]
        ell_bytes = sum(g.ell.post_ind.numel() * (9 + (
            4 if g.ell.delay is not None else 0))
            for g in model.network.synapses)
        print(f"built {model} in {build_s:.1f} s; ring slots {rings}; ELL "
              f"{ell_bytes} B")
        check(len(delayed) == 2 and all(
            g.ring_slots == DELAY["max_delay"] + 1 for g in delayed),
            f"expected 2 delayed groups of {DELAY['max_delay'] + 1} slots: "
            f"{rings}")
        steps = DELAY["steps"]
        graph, _, _ = _eager_vs_graph(torch, model, "delay", steps)
        ring_bytes = sum(g._acc.numel() * 8 + 4 * g.ring_slots * g.ell.n_post
                         for g in delayed)
        reset_launches()
        _, secs, rates = _run_checked(torch, model, steps, "delay run")
        launches = read_launches()
        print(f"launches in the delay run: {launches}")
        # phase 13 holds the engine's run of this net to this one
        run_digest = _run_digest(torch, model.run(steps, record_raster=True))
        for name in ("ell_spmv_delay", "delay_ring_fold", "ell_spmv"):
            check(launches[name] == 2 * steps,
                  f"{name} launched {launches[name]} times for 2 groups x "
                  f"{steps} steps")
        us = secs / steps * 1e6
        print(f"delay path: {us:.1f} us/step ({report['nvidia_smi']}); "
              f"rings and scratch {ring_bytes} B")
        agree, kr, pr = _plain_agreement(torch, model, DELAY["plain_steps"])
        # both sides sum in float64 and fold with the same roundings: with
        # equal rasters the rings are equal bit for bit
        rings_equal = {g.name: bool(torch.equal(
            kr.state.syn[g.name].dendritic, pr.state.syn[g.name].dendritic))
            and bool(torch.equal(kr.state.syn[g.name].cursor,
                                 pr.state.syn[g.name].cursor))
            for g in delayed}
        print(f"rings bit-equal after {DELAY['plain_steps']} steps: "
              f"{rings_equal}")
        check(all(rings_equal.values()),
              f"the rings differ from the plain run's: {rings_equal}")
        prof = _profiles(torch, model, DELAY["profile_steps"])
        report["delay"] = {"config": DELAY, "build_s": build_s,
                           "ell_bytes": ell_bytes,
                           "ring_and_scratch_bytes": ring_bytes,
                           "seconds": secs, "us_per_step": us,
                           "rates_hz": rates, "launches": launches,
                           "plain_raster_agreement": agree,
                           "rings_bit_equal": rings_equal, "profile": prof,
                           "eager_vs_graph": graph, "run_digest": run_digest}
        return launches, model


def delay_sweep(torch, report, model) -> None:
    """Phase 5b: phase 4's gScale grid on phase 5's net, one batch of 8:
    the delay path's batch axis (the exc->exc group's scratch [21, 80000,
    8] is 107.5 MB, past L2)."""
    with phase("5b. delayed gScale sweep: phase 4's grid on phase 5's net"):
        values, steps = list(SWEEP["values"]), DELAY["sweep_steps"]
        names = model._expand_group("exc")
        grids = [{n: torch.tensor(v, device="cuda") for n in names}
                 for v in (values, SWEEP["values_b"])]
        graph, _, _ = _eager_vs_graph(torch, model, "delay_sweep", steps,
                                      batch=len(values), grids=grids)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = model.sweep_gscale("exc", values, steps)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_launches()
        want = 2 * steps
        for name in ("ell_spmv_delay", "delay_ring_fold"):
            check(launches[name] == want,
                  f"{name} launched {launches[name]} times, not {want}")
        rates = {k: v.tolist() for k, v in s.rates_hz.items()}
        finite = s.finite.tolist()
        us = secs / steps * 1e6
        print(f"{len(values)} candidates x {steps} steps in {secs:.3f} s: "
              f"{len(values) / secs:.3f} candidates/s, {us:.1f} us/step "
              f"({report['nvidia_smi']}); launches {launches}")
        for i, v in enumerate(values):
            print(f"  gScale {v}: " + ", ".join(
                f"{k} {rates[k][i]:.4f} Hz" for k in rates)
                + f", finite {finite[i]}")
        check(all(finite) and all(r > 0 for r in rates["exc"]),
              f"a candidate went non-finite or silent: {rates}, {finite}")
        # a member is the single run at its gScale spike for spike: the
        # sums are exact and the members independent
        i = 5
        one = model.run(steps, gscales={"exc": values[i]})
        same = {k: bool(torch.equal(one.spike_counts[k],
                                    s.spike_counts[k][i]))
                for k in one.spike_counts}
        print(f"member {i} (gScale {values[i]}) equals its B = 1 run: "
              f"{same}")
        check(all(same.values()),
              f"member {i} differs from its B = 1 run: {same}")
        prof = _profiles(torch, model, DELAY["profile_steps"],
                         batch=len(values), gscales=grids[0])
        report["delay_sweep"] = {
            "values": values, "steps": steps, "seconds": secs,
            "us_per_step": us, "candidates_per_s": len(values) / secs,
            "launches": launches,
            "rates_hz": rates, "finite": finite,
            "member_equals_single_run": same, "profile": prof,
            "eager_vs_graph": graph}


def gscale_table(torch, report) -> float:
    """Phase 6a; returns the KC rate at gScale 1 (the search's target)."""
    from repro_torch.core.models import mushroom_body as MB
    with phase("6a. mushroom body: the NaN-guard table"):
        cfg = MB.MushroomBodyConfig(**MB_EXAMPLE)
        model = MB.compile_model(cfg)
        print(f"built {model}; routes {model.simulator.routes}")
        values, steps = list(MB_TABLE["values"]), MB_TABLE["steps"]
        graph, _, _ = _eager_vs_graph(
            torch, model, "mb_table", steps, batch=len(values),
            grids=[{"PN_KC": torch.tensor(values, device="cuda")}])
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = model.sweep_gscale("PN_KC", values, steps)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_launches()
        rates = {k: v.tolist() for k, v in s.rates_hz.items()}
        finite = s.finite.tolist()
        print(f"{len(values)} candidates x {steps} steps in {secs:.3f} s "
              f"({secs / steps * 1e6:.1f} us/step); launches {launches}")
        print(" gScale |  PN Hz |  KC Hz |  DN Hz | finite (NaN guard)")
        for i, g in enumerate(values):
            print(f" {g:6.1f} | {rates['PN'][i]:6.1f} | {rates['KC'][i]:6.1f} "
                  f"| {rates['DN'][i]:6.1f} | {finite[i]}")
        check(launches["hh_step"] == 3 * steps,
              f"hh_step launched {launches['hh_step']} times for 3 "
              f"populations x {steps} steps")
        check(finite[0] and finite[1], f"not finite at gScale 0.5 or 1: "
              f"{finite}")
        check(not finite[-1], "gScale 50 did not trip the NaN guard")
        check(all(abs(r - cfg.pn_rate_hz) < 15.0 for r in rates["PN"]),
              f"PN rates {rates['PN']} not within 15 Hz of "
              f"{cfg.pn_rate_hz}")
        report["mb_table"] = {"config": MB_EXAMPLE, "values": values,
                              "steps": steps, "seconds": secs,
                              "us_per_step": secs / steps * 1e6,
                              "rates_hz": rates, "finite": finite,
                              "launches": launches, "eager_vs_graph": graph}
        return rates["KC"][1]


def mushroom_body_full(torch, report, kc_target: float) -> dict:
    """Phase 6b; returns the launch counts of its 2500-step run."""
    from repro_torch.core import conductance as C
    from repro_torch.core.models import mushroom_body as MB
    with phase("6b. mushroom body at full width: 100k KCs"):
        cfg = MB.MushroomBodyConfig(**MB_FULL)
        ex = MB_EXAMPLE
        # each group's gScale: the example's fan-in over this size's
        fan_in = {"PN_KC": ex["n_pn"] / cfg.n_pn,
                  "PN_LHI": ex["n_pn"] / cfg.n_pn,
                  "LHI_KC": ex["n_lhi"] / cfg.n_lhi,
                  "KC_DN": ex["n_kc"] / cfg.n_kc,
                  "DN_DN": ex["n_dn"] / cfg.n_dn}
        t0 = time.perf_counter()
        model = MB.compile_model(cfg)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        groups = [(g.name, g.representation, g.ell.n_pre, g.ell.n_post,
                   g.ell.max_conn) for g in model.network.synapses]
        print(f"built {model} in {build_s:.1f} s; groups {groups}; "
              f"fan-in gScales {fan_in}")
        check(model.simulator.routes == {"PN": "codegen", "LHI": "hh_step",
                                         "KC": "hh_step", "DN": "hh_step"},
              f"neuron routes {model.simulator.routes}")
        steps = MB_RUN["steps"]
        graph, _, _ = _eager_vs_graph(torch, model, "mb_full", steps,
                                      grids=[fan_in])
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        _, secs, rates = _run_checked(torch, model, steps, "kernel run",
                                      gscales=fan_in)
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        print(f"launches {launches}; peak device memory {peak} B")
        check(launches["hh_step"] == 3 * steps,
              f"hh_step launched {launches['hh_step']} times for 3 "
              f"populations x {steps} steps")
        out = report["mb_full"] = {
            "config": MB_FULL, "fan_in_gscales": fan_in, "build_s": build_s,
            "groups": groups, "steps": steps, "seconds": secs,
            "us_per_step": secs / steps * 1e6, "rates_hz": rates,
            "launches": launches, "peak_mem_bytes": peak,
            "eager_vs_graph": graph}
        out["plain_raster_agreement"], _, _ = _plain_agreement(
            torch, model, MB_RUN["plain_steps"], gscales=fan_in)
        out["profile"] = _profiles(torch, model, 50, gscales=fan_in)

        others = {k: v for k, v in fan_in.items() if k != "PN_KC"}
        search_steps = MB_RUN["search_steps"]

        seen = {}

        def kc_rate(cands):
            """One batched run of every candidate through the graph route;
            PN_KC's gScale [B], the other groups' fan-in gScales as
            scalars."""
            res = model.simulator.run_compiled(
                model.init_state(len(cands)), search_steps,
                {**others, "PN_KC": cands.to(model.device)})
            seen["kc"], seen["finite"] = res.rates_hz["KC"], res.finite
            return res.rates_hz["KC"], res.finite

        cands = list(MB_RUN["search"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pick = C.search_sweep(kc_rate, cands, kc_target)
        torch.cuda.synchronize()
        search_s = time.perf_counter() - t0
        kc, fin = seen["kc"].tolist(), seen["finite"].tolist()
        for g, r, f in zip(cands, kc, fin):
            print(f"  PN_KC gScale {g:.4f}: KC {r:.4f} Hz, finite {f}")
        bracketed = (min(r for r, f in zip(kc, fin) if f) <= kc_target
                     <= max(r for r, f in zip(kc, fin) if f))
        print(f"search_sweep to 6a's KC rate {kc_target:.4f} Hz: {pick} "
              f"({len(cands)} candidates x {search_steps} steps in "
              f"{search_s:.3f} s, the capture included; target bracketed: "
              f"{bracketed})")
        check(pick.finite, f"search_sweep picked {pick}")
        out["search"] = {"candidates": cands, "steps": search_steps,
                         "seconds": search_s, "kc_rates_hz": kc,
                         "finite": fin, "target_hz": kc_target,
                         "bracketed": bracketed, "pick": pick.__dict__}
        out["graph_counts"] = dict(model.simulator.graph_counts)
        return launches


def serve_full(torch, report) -> dict:
    """Phase 7; returns the launch counts of the serving run."""
    import numpy as np
    from torch.utils._pytree import tree_leaves, tree_map
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models import transformer as T
    cfg_s = SERVE
    with phase("7. LM serving at full width: qwen2-0.5b"):
        t0 = time.perf_counter()
        srv = Server(cfg_s["arch"], use_reduced=False,
                     max_batch=cfg_s["max_batch"], max_seq=cfg_s["max_seq"],
                     seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        cfg = srv.cfg
        n_params = T.count_params(srv.params)
        leaves = tree_leaves(srv.params)
        param_bytes = sum(x.numel() * x.element_size() for x in leaves)
        caches = T.init_caches(cfg, cfg_s["max_batch"], cfg_s["max_seq"],
                               device="cuda")
        cache_bytes = sum(c[k].numel() * c[k].element_size()
                          for c in caches["segments"] for k in ("k", "v"))
        del caches
        print(f"{cfg.name}: {n_params} params ({param_bytes} B, "
              f"{leaves[0].dtype}) drawn in {init_s:.2f} s; KV cache "
              f"{cache_bytes} B at B={cfg_s['max_batch']}, "
              f"S={cfg_s['max_seq']}")
        check(all(x.dtype == torch.bfloat16 for x in leaves),
              "the full-width weights are not all bf16")

        # warm-up (cuBLAS handles, allocator), before the counted run
        warm = torch.randint(3, cfg.vocab, (1, 64), device="cuda")
        logits, caches = T.prefill(srv.params, cfg, warm, max_seq=80)
        T.decode_step(srv.params, cfg, caches, logits.argmax(-1))
        torch.cuda.synchronize()
        del caches

        rng = np.random.default_rng(0)
        lo, hi = cfg_s["prompt_len"]
        lens = rng.integers(lo, hi + 1, size=cfg_s["requests"])
        reqs = [Request(rid=i, prompt=rng.integers(3, cfg.vocab,
                                                   size=int(n)).tolist(),
                        max_new=cfg_s["max_new"])
                for i, n in enumerate(lens)]
        rows_seen = {"n": 0, "finite": True}
        sample = srv._sample

        def checked_sample(logits, req):
            rows_seen["n"] += 1
            rows_seen["finite"] &= bool(np.isfinite(logits[:cfg.vocab]).all())
            return sample(logits, req)

        srv._sample = checked_sample
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t_submit = time.perf_counter()
        for r in reqs:
            srv.submit(r)
        srv.run()
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t_submit
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        print(f"served {len(reqs)} requests in {total_s:.3f} s; launches "
              f"{launches}; peak device memory {peak} B")
        check(all(r.done and len(r.out) == cfg_s["max_new"] for r in reqs),
              "a request did not get its tokens: "
              f"{[len(r.out) for r in reqs]}")
        check(all(0 <= t < cfg.vocab for r in reqs for t in r.out),
              "a sampled token is a pad id")
        check(rows_seen["finite"] and rows_seen["n"] == len(reqs)
              * cfg_s["max_new"], f"logit rows: {rows_seen}")
        n_waves = len(srv.waves)
        check(launches["flash_attention"] == cfg.n_layers * n_waves == 48,
              f"flash_attention launched {launches['flash_attention']} "
              f"times for {cfg.n_layers} layers x {n_waves} waves")
        check(not any(v for k, v in launches.items()
                      if k != "flash_attention"),
              f"an SNN kernel launched on the serving path: {launches}")
        waves = []
        for w in srv.waves:
            tokens = w["size"] * w["prompt_len"]
            waves.append({
                **w, "prefill_tokens": tokens,
                "prefill_tok_per_s": tokens / w["prefill_s"],
                "ttft_s": w["first_token_at"] - t_submit,
                "decode_ms_per_step": w["decode_s"] / w["decode_steps"] * 1e3,
                "decode_tok_per_s": w["size"] * w["decode_steps"]
                / w["decode_s"]})
            print("wave: " + json.dumps(waves[-1]))
        out = report["serve"] = {
            "config": cfg_s, "params": n_params, "param_bytes": param_bytes,
            "kv_cache_bytes": cache_bytes, "init_s": init_s,
            "prompt_lens": lens.tolist(), "total_s": total_s,
            "tokens": sum(len(r.out) for r in reqs), "waves": waves,
            "launches": launches, "peak_mem_bytes": peak}

        # the kernel against the plain versions, float32 weights
        p32 = tree_map(lambda t: t.float(), srv.params)
        toks = torch.tensor(rng.integers(
            3, cfg.vocab, (cfg_s["check_prompts"], cfg_s["check_len"])),
            device="cuda")
        lk, _ = T.prefill(p32, cfg, toks)
        with plain_versions():
            lp, _ = T.prefill(p32, cfg, toks)
        lk, lp = lk[:, :cfg.vocab], lp[:, :cfg.vocab]
        torch.cuda.synchronize()
        err = float((lk - lp).abs().max())
        print(f"float32 prefill of {tuple(toks.shape)}, kernel vs plain "
              f"last-token logits: max abs err {err}, argmax "
              f"{lk.argmax(-1).tolist()} vs {lp.argmax(-1).tolist()}")
        check(bool(torch.allclose(lk, lp, rtol=cfg_s["tol"],
                                  atol=cfg_s["tol"])),
              f"float32 logits differ by {err}")
        check(torch.equal(lk.argmax(-1), lp.argmax(-1)),
              "float32 argmax differs between kernel and plain")
        out["f32_check"] = {"shape": list(toks.shape), "max_abs_err": err}
        del p32, lk, lp

        # where the device time goes: one prefill wave, 20 decode steps
        first = reqs[:cfg_s["max_batch"]]
        maxlen = max(len(r.prompt) for r in first)
        wave = np.zeros((len(first), maxlen), np.int64)
        for i, r in enumerate(first):
            wave[i, maxlen - len(r.prompt):] = r.prompt
        wave = torch.from_numpy(wave).cuda()
        box = {}

        def prefill():
            box["logits"], box["caches"] = T.prefill(
                srv.params, cfg, wave, max_seq=cfg_s["max_seq"])
            torch.cuda.synchronize()

        prof_prefill = _device_profile(torch, prefill)
        fa_us = sum(us for n, (_, us) in prof_prefill["by_name"].items()
                    if any(k in n for k in _flash_kernels("fwd")))
        prof_prefill["flash_share"] = fa_us / prof_prefill["device_busy_us"]
        check(prof_prefill["flash_share"] > 0,
              "the prefill profile shows no flash_attention kernel by name: "
              f"{prof_prefill['top']}")
        token = box["logits"].argmax(-1)

        def decode():
            caches, tok = box["caches"], token
            for _ in range(cfg_s["decode_profile_steps"]):
                logits, caches = T.decode_step(srv.params, cfg, caches, tok)
                tok = logits.argmax(-1)
            tok.cpu()

        prof_decode = _device_profile(torch, decode)
        print(f"prefill wave {tuple(wave.shape)} profiled: device busy "
              f"{prof_prefill['device_busy_us']:.0f} us of "
              f"{prof_prefill['wall_us']:.0f}, flash_attention "
              f"{100 * prof_prefill['flash_share']:.1f}% of device time; "
              f"top {prof_prefill['top'][:4]}")
        print(f"{cfg_s['decode_profile_steps']} decode steps profiled: "
              f"card busy {100 * prof_decode['busy_share']:.1f}% of "
              f"{prof_decode['wall_us']:.0f} us, "
              f"{prof_decode['device_ops'] / cfg_s['decode_profile_steps']:.0f}"
              f" device ops/step; top {prof_decode['top'][:4]}")
        out["profile_prefill"] = prof_prefill
        out["profile_decode"] = prof_decode
        # phase 20's real decode step (the wave of 8 at 4096 positions):
        # its peak memory and FLOPs, and the run's decode ms/step
        caches = box["caches"]
        out["decode_counts"] = _step_counts(
            torch, lambda: T.decode_step(srv.params, cfg, caches, token),
            (srv.params, caches, token))
        out["decode_ms_per_step"] = sum(
            w["decode_ms_per_step"] for w in waves) / len(waves)
        del srv, box, caches
        return launches


# ---------------------------------------------------------------------------
# phase 14: the MoE, SSM and hybrid families
# ---------------------------------------------------------------------------
def _layer_kinds(cfg) -> dict:
    """How many attentions and mamba layers a pass runs (a shared block
    counts once a group; an encdec model's encoder layers and each decoder
    layer's cross-attention count too)."""
    from repro_torch.models import transformer as T
    kinds = [k for k, *_ in T._layers(cfg)]
    attn = sum(k != "mamba" for k in kinds)
    if cfg.family == "encdec":
        attn += cfg.n_enc_layers + cfg.n_layers
    return {"attn": attn, "mamba": kinds.count("mamba")}


@contextlib.contextmanager
def _routes_seen(seen):
    """Hand each MoE layer's routing (``moe_route``'s result) to
    ``seen``, in layer order."""
    from unittest import mock
    from repro_torch.models import moe as M
    real = M.moe_route

    def route(p, cfg, xg, cap):
        out = real(p, cfg, xg, cap)
        seen(out)
        return out

    with mock.patch.object(M, "moe_route", route):
        yield


def _count_drops(counts: dict):
    """A ``_routes_seen`` callback: the (token, slot) pairs routed and
    dropped (a host read a layer: outside timed runs only)."""
    def seen(out):
        counts["pairs"] += out[2].numel()
        counts["dropped"] += int((~out[2]).sum())
    return seen


@contextlib.contextmanager
def _pinned_routes(torch, recorded: list, tie: float, ties: dict):
    """Each MoE layer's routing as ``recorded`` (a run's (expert_idx, place,
    keep) in layer order), its gates and aux from this run's probabilities;
    a choice that differs from this run's own is allowed only as a near
    tie (the two competing probabilities within ``tie``), counted in
    ``ties``.  So a float32 comparison of two runs is not cut by a
    discontinuous routing flip."""
    from unittest import mock
    from repro_torch.models import moe as M
    calls = iter(recorded)
    real = M.moe_route

    def route(p, cfg, xg, cap):
        idx, place, keep = next(calls)
        own = real(p, cfg, xg, cap)
        probs = torch.softmax(xg.float() @ p["router"], dim=-1)
        differ = (own[0] != idx).any(-1)
        if bool(differ.any()):
            top = torch.sort(probs[differ], dim=-1, descending=True).values
            gap = top[:, cfg.top_k - 1] - top[:, cfg.top_k]
            check(bool((gap <= tie).all()),
                  f"a routing choice differs by {float(gap.max())} > {tie}")
            ties["n"] += int(differ.sum())
        gate = torch.gather(probs, -1, idx)
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
        onehot = torch.nn.functional.one_hot(idx, cfg.n_experts)
        f_e = onehot.sum(dim=(0, 1, 2)).float() / idx.numel()
        aux = cfg.aux_loss_weight * cfg.n_experts * torch.sum(
            f_e * probs.mean(dim=(0, 1)))
        return idx, place, keep, gate * keep, aux

    with mock.patch.object(M, "moe_route", route):
        yield


def _family_config(arch: str, n_layers):
    """The arch's config at full width, registered under its own name
    with its depth cut to ``n_layers`` where that is given (``Server``
    takes a registered name)."""
    import dataclasses
    from repro_torch import configs
    cfg = configs.get_config(arch)
    if n_layers is None:
        return arch, cfg
    name = f"{arch}@{n_layers}L"
    configs.ARCHS[name] = dataclasses.replace(cfg, name=name,
                                              n_layers=n_layers)
    return name, configs.ARCHS[name]


def serve_family(torch, report, label: str, arch: str, n_layers,
                 f32_check: bool, fs: dict = FAMILY_SERVE) -> dict:
    """Phases 14a-14d and 15a: serve ``arch`` at full width, one wave as
    ``fs`` sizes it; returns the launch counts of the serving run."""
    import numpy as np
    from torch.utils._pytree import tree_leaves
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models import transformer as T
    depth = "full depth" if n_layers is None else f"{n_layers} layers"
    with phase(f"{label}. {arch} served at full width, {depth}"):
        name, cfg = _family_config(arch, n_layers)
        t0 = time.perf_counter()
        srv = Server(name, use_reduced=False, max_batch=fs["max_batch"],
                     max_seq=fs["max_seq"], seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = T.count_params(srv.params)
        leaves = tree_leaves(srv.params)
        param_bytes = sum(x.numel() * x.element_size() for x in leaves)
        kinds = _layer_kinds(cfg)
        print(f"{name} ({cfg.family}): {n_params} params ({param_bytes} B), "
              f"{kinds['attn']} attention and {kinds['mamba']} mamba layer "
              f"slots, drawn in {init_s:.2f} s")
        check(cfg.dtype == "bfloat16" and all(
            x.dtype in (torch.bfloat16, torch.float32) for x in leaves),
            "the full-width weights are not bf16 (float32 where the JAX "
            "package keeps them)")

        warm = torch.randint(3, cfg.vocab, (1, 64), device="cuda")
        logits, caches = T.prefill(srv.params, cfg, warm, srv._extra(1),
                                   max_seq=80)
        T.decode_step(srv.params, cfg, caches, logits.argmax(-1))
        torch.cuda.synchronize()
        del caches

        rng = np.random.default_rng(0)
        lo, hi = fs["prompt_len"]
        lens = rng.integers(lo, hi + 1, size=fs["requests"])
        reqs = [Request(rid=i, prompt=rng.integers(3, cfg.vocab,
                                                   size=int(n)).tolist(),
                        max_new=fs["max_new"])
                for i, n in enumerate(lens)]
        rows_seen = {"n": 0, "finite": True}
        sample = srv._sample

        def checked_sample(logits, req):
            rows_seen["n"] += 1
            rows_seen["finite"] &= bool(np.isfinite(logits[:cfg.vocab]).all())
            return sample(logits, req)

        srv._sample = checked_sample
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t_submit = time.perf_counter()
        for r in reqs:
            srv.submit(r)
        srv.run()
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t_submit
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        n_waves = len(srv.waves)
        print(f"served {len(reqs)} requests in {total_s:.3f} s, {n_waves} "
              f"wave(s); launches {launches}; peak device memory {peak} B")
        check(all(r.done and len(r.out) == fs["max_new"] for r in reqs),
              f"a request did not get its tokens: {[len(r.out) for r in reqs]}")
        check(all(0 <= t < cfg.vocab for r in reqs for t in r.out),
              "a sampled token is a pad id")
        check(rows_seen["finite"] and rows_seen["n"] == len(reqs)
              * fs["max_new"], f"logit rows: {rows_seen}")
        want = {"flash_attention": kinds["attn"] * n_waves,
                "ssd_scan.state": kinds["mamba"] * n_waves}
        check(all(launches[k] == n for k, n in want.items())
              and not any(v for k, v in launches.items() if k not in want),
              f"launches {launches}, expected {want} and nothing else")
        waves = []
        for w in srv.waves:
            tokens = w["size"] * w["prompt_len"]
            waves.append({
                **w, "prefill_tokens": tokens,
                "prefill_tok_per_s": tokens / w["prefill_s"],
                "ttft_s": w["first_token_at"] - t_submit,
                "decode_ms_per_step": w["decode_s"] / w["decode_steps"] * 1e3,
                "decode_tok_per_s": w["size"] * w["decode_steps"]
                / w["decode_s"]})
            if cfg.family == "vlm":
                # the image's positions, counted apart from the text's
                img = w["size"] * cfg.img_tokens
                waves[-1].update({
                    "prefill_image_positions": img,
                    "prefill_positions_per_s": (tokens + img)
                    / w["prefill_s"]})
            print("wave: " + json.dumps(waves[-1]))
        out = report[f"serve_{label}"] = {
            "arch": name, "family": cfg.family, "config": fs,
            "params": n_params, "param_bytes": param_bytes, "init_s": init_s,
            "prompt_lens": lens.tolist(), "total_s": total_s, "waves": waves,
            "launches": launches, "peak_mem_bytes": peak}

        # the wave again, outside the timed run: what capacity dropped in
        # the prefill and in the decode steps the requests took
        maxlen = max(len(r.prompt) for r in reqs)
        wave = np.zeros((len(reqs), maxlen), np.int64)
        for i, r in enumerate(reqs):
            wave[i, maxlen - len(r.prompt):] = r.prompt
        wave = torch.from_numpy(wave).cuda()
        extra = srv._extra(len(reqs))
        if cfg.family == "moe":
            pre = {"pairs": 0, "dropped": 0}
            dec = {"pairs": 0, "dropped": 0}
            with _routes_seen(_count_drops(pre)):
                _, caches = T.prefill(srv.params, cfg, wave,
                                      max_seq=fs["max_seq"])
            with _routes_seen(_count_drops(dec)):
                for j in range(fs["max_new"] - 1):
                    tok = torch.tensor([r.out[j] for r in reqs],
                                       device="cuda")
                    _, caches = T.decode_step(srv.params, cfg, caches, tok)
            del caches
            out["prefill_dropped"] = pre
            out["decode_dropped"] = dec
            print(f"capacity dropped {pre['dropped']} of {pre['pairs']} "
                  f"(token, slot) pairs in the prefill "
                  f"({100 * pre['dropped'] / pre['pairs']:.3f}%), "
                  f"{dec['dropped']} of {dec['pairs']} in "
                  f"{fs['max_new'] - 1} decode steps "
                  f"({100 * dec['dropped'] / dec['pairs']:.3f}%)")

        # where the device time goes: the prefill wave, 10 decode steps
        box = {}

        def prefill():
            box["logits"], box["caches"] = T.prefill(
                srv.params, cfg, wave, extra, max_seq=fs["max_seq"])
            torch.cuda.synchronize()

        prof_prefill = _device_profile(torch, prefill)
        token = box["logits"].argmax(-1)
        cache_bytes = sum(x.numel() * x.element_size()
                          for x in tree_leaves(box["caches"])
                          if isinstance(x, torch.Tensor))
        print(f"the wave's caches: {cache_bytes} B")

        def decode():
            caches, tok = box["caches"], token
            for _ in range(fs["decode_profile_steps"]):
                logits, caches = T.decode_step(srv.params, cfg, caches, tok)
                tok = logits.argmax(-1)
            tok.cpu()

        prof_decode = _device_profile(torch, decode)
        steps = fs["decode_profile_steps"]
        cats = _categories(prof_prefill)
        sdpa = _sdpa_kernels(prof_prefill) + _sdpa_kernels(prof_decode)
        check(not sdpa, f"PyTorch's attention kernels ran: {sdpa}")
        print(f"prefill wave {tuple(wave.shape)} profiled: device busy "
              f"{prof_prefill['device_busy_us']:.0f} us of "
              f"{prof_prefill['wall_us']:.0f}, {prof_prefill['device_ops']} "
              "device ops; by category "
              + "; ".join(f"{k} {v['launches']} x, {v['us']:.0f} us "
                          f"({100 * v['share']:.1f}%)"
                          for k, v in sorted(cats.items(),
                                             key=lambda kv: -kv[1]["us"]))
              + f"; top {prof_prefill['top'][:5]}")
        print(f"{steps} decode steps profiled: card busy "
              f"{100 * prof_decode['busy_share']:.1f}% of "
              f"{prof_decode['wall_us']:.0f} us, "
              f"{prof_decode['device_ops'] / steps:.1f} device ops/step, "
              f"{prof_decode['device_busy_us'] / steps:.0f} device us/step; "
              f"top {prof_decode['top'][:4]}")
        out["profile_prefill"] = prof_prefill
        out["cache_bytes"] = cache_bytes
        out["prefill_categories"] = cats
        out["profile_decode"] = prof_decode
        out["decode_device_ops_per_step"] = prof_decode["device_ops"] / steps
        del box

        if f32_check:
            out["f32_check"] = _family_f32_check(torch, srv, cfg, rng)
        del srv
        torch.cuda.empty_cache()
        return launches


def _family_f32_check(torch, srv, cfg, rng) -> dict:
    """Phase 7's check on a family: a float32 copy of the weights prefills
    2 prompts of 512 tokens through the kernels and through the plain
    versions; last-token logits within FAMILY_SERVE["tol"], equal argmax.
    An MoE's plain run takes the kernel run's routing (``_pinned_routes``),
    where a choice may differ only at a near tie."""
    from torch.utils._pytree import tree_map
    from repro_torch.models import transformer as T
    fs = FAMILY_SERVE
    p32 = tree_map(lambda t: t.float(), srv.params)
    toks = torch.tensor(rng.integers(
        3, cfg.vocab, (fs["check_prompts"], fs["check_len"])), device="cuda")
    kinds = _layer_kinds(cfg)
    recorded: list = []
    reset_launches()
    extra = srv._extra(fs["check_prompts"])
    with _routes_seen(lambda out: recorded.append(out[:3])):
        lk, ck = T.prefill(p32, cfg, toks, extra)
    launches_k = read_launches()
    check(launches_k["flash_attention"] == kinds["attn"]
          and launches_k["ssd_scan.state"] == kinds["mamba"],
          f"the float32 prefill launched {launches_k}")
    ties = {"n": 0}
    reset_launches()
    with plain_versions(), _pinned_routes(torch, recorded, fs["tie"], ties):
        lp, cp = T.prefill(p32, cfg, toks, extra)
    check(not any(read_launches().values()), "the plain prefill launched")
    lk, lp = lk[:, :cfg.vocab], lp[:, :cfg.vocab]
    torch.cuda.synchronize()
    err = float((lk - lp).abs().max())
    state_err = 0.0
    for a, b in zip(_state_leaves(ck), _state_leaves(cp)):
        state_err = max(state_err, float((a - b).abs().max()))
    print(f"float32 prefill of {tuple(toks.shape)} ({cfg.n_layers} layer "
          f"slots), kernel vs plain last-token logits: max abs err {err}, "
          f"argmax {lk.argmax(-1).tolist()} vs {lp.argmax(-1).tolist()}; "
          f"mamba states max abs err {state_err}; routing near ties "
          f"{ties['n']}")
    check(bool(torch.allclose(lk, lp, rtol=fs["tol"], atol=fs["tol"])),
          f"float32 logits differ by {err}")
    check(torch.equal(lk.argmax(-1), lp.argmax(-1)),
          "float32 argmax differs between kernel and plain")
    res = {"shape": list(toks.shape), "layers": cfg.n_layers,
           "max_abs_err": err, "state_max_abs_err": state_err,
           "near_ties": ties["n"]}
    del p32, lk, lp, ck, cp
    torch.cuda.empty_cache()
    return res


def _state_leaves(caches):
    """The mamba caches' conv and ssd tensors of a cache tree."""
    return [seg[k] for where in ("segments", "tail") for seg in caches[where]
            if "ssd" in seg for k in ("conv", "ssd")]


def train_hybrid_check(torch, report) -> None:
    """Phase 14f's float32 step: zamba2 at full width, 2 groups (12 layer
    slots: the shared block's gradient sums over its 2 applications),
    kernels against plain versions, as 8c."""
    import dataclasses
    from torch.utils._pytree import tree_flatten_with_path
    from repro_torch.configs import get_config
    c = STEP_CHECK
    with phase("14f. one float32 zamba2 step (2 groups): kernels against "
               "plain versions"):
        cfg = dataclasses.replace(get_config("zamba2-7b"), n_layers=12,
                                  dtype="float32")
        params, opt, step_fn, pipe = _train_setup(
            torch, cfg, c["batch"], c["seq"], 1, 1e-3, seed=1)
        batch = pipe.next_batch()
        lk, gk, launches_k = _grads_of_step(torch, step_fn, params, opt,
                                            batch)
        with plain_versions():
            lp, gp, launches_p = _grads_of_step(torch, step_fn, params, opt,
                                                batch)
        print(f"zamba2 (12 layer slots, float32): loss kernel {lk} plain {lp}"
              f"; launches {launches_k} / plain {launches_p}")
        check(abs(lk - lp) <= c["loss_tol"],
              f"zamba2: losses differ by {abs(lk - lp)}")
        check(not any(launches_p.values()),
              f"zamba2: the plain run launched {launches_p}")
        want = {"ssd_scan": 20, "flash_attention": 2,
                "flash_attention_bwd": 2}
        check(all(launches_k[k] == n for k, n in want.items()),
              f"zamba2: kernel launches {launches_k}, expected {want}")
        worst = {}
        for (path, a), (_, w) in zip(tree_flatten_with_path(gk)[0],
                                     tree_flatten_with_path(gp)[0]):
            key = "".join(str(x) for x in path)
            err = float((a - w).abs().max())
            scale = float(w.abs().max())
            worst[key] = [err, scale]
            check(bool(torch.allclose(a, w, rtol=c["grad_rtol"],
                                      atol=c["grad_atol_frac"] * scale)),
                  f"zamba2: gradient {key} differs by {err} (largest entry "
                  f"{scale})")
        shared = gk["segments"][1]["attn"]["wq"]
        check(bool(shared.abs().sum() > 0),
              "zamba2: the shared block has no gradient on the card")
        rel = max(e / max(s, 1e-30) for e, s in worst.values())
        print(f"zamba2: {len(worst)} gradients within tolerance; largest "
              f"error relative to its leaf's scale {rel:.3g}")
        report["train_step_check_zamba2"] = {
            "loss_kernel": lk, "loss_plain": lp, "launches": launches_k,
            "grad_err": worst, "max_rel_grad_err": rel}
        del params, opt, step_fn, gk, gp
        torch.cuda.empty_cache()


def families(torch, report) -> dict:
    """Phase 14: the MoE, SSM and hybrid families at full width, served
    (14a-14d) and trained (14e, 14f); returns each sub-phase's launches."""
    out = {}
    for label, arch, n_layers, f32 in FAMILIES:
        out[label] = serve_family(torch, report, label, arch, n_layers, f32)
    out["14e"] = train_full(torch, report, "granite-moe-1b-a400m", "14e")
    out["14f"] = train_full(torch, report, "zamba2-7b@15", "14f")
    train_hybrid_check(torch, report)
    return out


def _train_setup(torch, cfg, batch: int, seq: int, steps: int, lr: float,
                 seed: int):
    """What ``launch.train.run`` builds: weights from a seeded generator,
    AdamW with the trainer's schedule, the train step, the pipeline."""
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.model import build
    from repro_torch.optim import adamw, schedule
    params = build(cfg).init(seed=seed, device="cuda")
    ocfg = adamw.AdamWConfig(lr=schedule.warmup_cosine(
        lr, warmup=min(20, steps // 5 + 1), total=steps), grad_clip=1.0)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                    global_batch=batch, seed=seed),
                         device="cuda")
    return (params, adamw.init(ocfg, params), make_train_step(cfg, ocfg),
            pipe)


# device-time categories of a training step, by kernel name (first match),
# after the flash kernels of both routes (kernels.flash_attention.ROUTES)
STEP_CATEGORIES = (
    ("ssd_scan", ("ssd_scan_kernel",)),
    ("matmul", ("gemm", "nvjet", "xmma", "cutlass")),
    ("copy", ("copy", "Memcpy", "Memset")),
    ("reduce", ("reduce", "SoftMax")),
    ("elementwise", ("elementwise", "Functor", "index", "scatter", "gather",
                     "cat", "where")),
)


def _categories(prof) -> dict:
    """Device us and share of busy time by STEP_CATEGORIES ("other" for a
    kernel no pattern names)."""
    cats = (("flash_attention_bwd", _flash_kernels("bwd")),
            ("flash_attention", _flash_kernels("fwd"))) + STEP_CATEGORIES
    out: dict = {}
    for n, (c, us) in prof["by_name"].items():
        cat = next((k for k, pats in cats if any(p in n for p in pats)),
                   "other")
        o = out.setdefault(cat, {"launches": 0, "us": 0.0})
        o["launches"] += c
        o["us"] += us
    for o in out.values():
        o["share"] = o["us"] / prof["device_busy_us"]
    return out


def _active_params(cfg, params) -> int:
    """The parameters a token uses: all of them but the MoE experts', and
    ``top_k / n_experts`` of those."""
    from repro_torch.models import transformer as T
    total = T.count_params(params)
    if cfg.family != "moe":
        return total
    experts = sum(T.count_params(seg["moe"][k]) for seg in params["segments"]
                  for k in ("w_gate", "w_up", "w_out"))
    return total - experts + experts * cfg.top_k // cfg.n_experts


def train_full(torch, report, name: str, label: str) -> dict:
    """Phases 8a / 8b / 14e / 14f: train ``TRAIN[name]``'s arch at full
    width (at full depth unless it names ``n_layers``); returns the launch
    counts of the run (warm-up step included)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.launch.train import extra_inputs
    spec = TRAIN[name]
    arch = spec.get("arch", name)
    b, t, steps = spec["batch"], spec["seq"], spec["steps"]
    depth = ("full depth" if "n_layers" not in spec
             else f"{spec['n_layers']} layer slots")
    with phase(f"{label}. train {arch} at full width, {depth}"):
        cfg = get_config(arch)
        if "n_layers" in spec:
            cfg = dataclasses.replace(cfg, n_layers=spec["n_layers"])
        t0 = time.perf_counter()
        params, opt, step_fn, pipe = _train_setup(torch, cfg, b, t, steps,
                                                  spec["lr"], seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = T.count_params(params)
        n_active = _active_params(cfg, params)
        flops_tok = T.model_flops_per_token(cfg, n_params, n_active)
        flops_step = flops_tok * b * t
        if cfg.family == "vlm":
            # 6 N over every position the layers run: the image's and the
            # text's
            flops_step = flops_tok * b * (t + cfg.img_tokens)
            print(f"{arch}: model FLOPs a step by 6N over all {t} + "
                  f"{cfg.img_tokens} positions a row: {flops_step:.4g}")
        if cfg.family == "encdec":
            # 6 N a token, N split by what it runs over: the decoder's
            # tokens (b x t) or the audio frames (b x enc_seq); attention's
            # own products are not counted
            n_frame = _frame_params(params)
            flops_step = 6.0 * ((n_params - n_frame) * b * t
                                + n_frame * b * cfg.enc_seq)
            print(f"{arch}: {n_frame} of the params run over the "
                  f"{cfg.enc_seq} frames; model FLOPs a step 6 x "
                  f"({n_params - n_frame} x {b * t} + {n_frame} x "
                  f"{b * cfg.enc_seq}) = {flops_step:.4g}")
        print(f"{arch}: {cfg.n_layers} layers, d {cfg.d_model}, {n_params} "
              f"params ({n_active} active a token; {cfg.dtype}, fp32 master "
              f"and moments), remat {cfg.remat} ({cfg.remat_policy}); "
              f"batch {b} x {t}; init {init_s:.2f} s")
        check(cfg.remat and cfg.dtype == "bfloat16",
              f"{arch}: expected the full config (bf16, remat)")
        rows = []
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        before = read_launches()
        bwd_calls = {"SSDScan": 0}
        for i in range(steps):
            batch = pipe.next_batch()
            batch.update(extra_inputs(cfg, b, i, 0, "cuda"))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with _counting_ssd_backward(bwd_calls):
                params, opt, m = step_fn(params, opt, batch)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t1
            now = read_launches()
            step_launches = {k: now[k] - before[k] for k in now}
            before = now
            rows.append({"step": i + 1, "loss": loss, "ce": float(m["ce"]),
                         "aux": float(m["aux"]), "ms": secs * 1e3,
                         "tokens_per_s": b * t / secs,
                         "model_tflops": flops_step / secs / 1e12,
                         "grad_norm": float(m["grad_norm"]),
                         "lr": float(m["lr"]),
                         "launches": {k: v for k, v in step_launches.items()
                                      if v}})
            print("step: " + json.dumps(rows[-1]))
            if i == 0 and "first_loss_cuda_cores" in spec:
                print(f"{arch}: first step's loss {loss:.4f} beside "
                      f"{spec['first_loss_cuda_cores']} on the CUDA-core "
                      "flash kernels (same seed and data)")
            check(all(math.isfinite(rows[-1][k]) for k in
                      ("loss", "ce", "aux")),
                  f"{arch}: step {i + 1} loss {loss}, ce {rows[-1]['ce']}, "
                  f"aux {rows[-1]['aux']}")
            check((rows[-1]["aux"] > 0) == (cfg.family == "moe"),
                  f"{arch}: step {i + 1} aux {rows[-1]['aux']}")
            for k, want in spec["per_step"].items():
                check(step_launches[k] == want,
                      f"{arch}: {k} launched {step_launches[k]} times in "
                      f"step {i + 1}, expected {want}")
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        timed = rows[1:]                # the first step is the warm-up
        ms = sum(r["ms"] for r in timed) / len(timed)
        summary = {"ms_per_step": ms, "tokens_per_s": b * t / ms * 1e3,
                   "model_tflops": flops_step / ms / 1e9,
                   "peak_mem_bytes": peak}
        if name == "mamba2-2.7b":
            # the SSD backward's share of a step: its calls a step times its
            # CUDA-event time at this shape (phase 2d)
            calls = bwd_calls["SSDScan"] / steps
            bwd_ms = report["ssd_table"][0]["bwd_ms"]
            summary["ssd_bwd"] = {"calls_per_step": calls, "ms": bwd_ms,
                                  "ms_per_step": calls * bwd_ms,
                                  "share": calls * bwd_ms / ms}
            fwd_ms = report["ssd_table"][0]["ms"]
            summary["ssd_fwd"] = {"launches_per_step":
                                  spec["per_step"]["ssd_scan"], "ms": fwd_ms,
                                  "ms_per_step": spec["per_step"]["ssd_scan"]
                                  * fwd_ms}
        print(f"{arch}: {json.dumps(summary)}; launches {launches}")
        if label == "8a":
            # phase 20's real step: its peak memory and FLOPs
            batch = pipe.next_batch()

            def step():
                return step_fn(params, opt, batch)
            summary["counts"] = _step_counts(torch, step,
                                             (params, opt, batch))

        # where the device time of one more step goes
        box = {"p": params, "o": opt}
        batch = pipe.next_batch()
        batch.update(extra_inputs(cfg, b, steps, 0, "cuda"))

        def one_step():
            box["p"], box["o"], box["m"] = step_fn(box["p"], box["o"], batch)
            float(box["m"]["loss"])
            torch.cuda.synchronize()

        prof = _device_profile(torch, one_step)
        cats = _categories(prof)
        sdpa = _sdpa_kernels(prof)
        check(not sdpa, f"{arch}: PyTorch's attention kernels ran: {sdpa}")
        for k in spec["per_step"]:
            if k in ("flash_attention", "flash_attention_bwd", "ssd_scan"):
                check(cats.get(k, {}).get("us", 0) > 0,
                      f"{arch}: the step's profile shows no {k} kernel by "
                      "name")
        print(f"profiled step: device busy {prof['device_busy_us']:.0f} of "
              f"{prof['wall_us']:.0f} us ({100 * prof['busy_share']:.1f}%), "
              f"{prof['device_ops']} device ops; by category "
              + "; ".join(f"{k} {v['launches']} x, {v['us']:.0f} us "
                          f"({100 * v['share']:.1f}%)"
                          for k, v in sorted(cats.items(),
                                             key=lambda kv: -kv[1]["us"]))
              + f"; top {prof['top'][:6]}")
        report[f"train_{name}"] = {
            "config": {**spec, "params": n_params, "active_params": n_active,
                       "flops_per_token": flops_tok,
                       "flops_per_step": flops_step},
            "init_s": init_s, "steps": rows,
            **summary, "launches": launches, "profile": prof,
            "categories": cats}
        del params, opt, box, step_fn
        torch.cuda.empty_cache()
        return launches


@contextlib.contextmanager
def _counting_ssd_backward(calls: dict):
    """Count the calls of ``SSDScan``'s backward (autograd looks it up on
    the class at each call)."""
    from unittest import mock
    from repro_torch.kernels import ssd_scan as SSD
    real = SSD.SSDScan.backward

    def counted(ctx, gy):
        calls["SSDScan"] += 1
        return real(ctx, gy)

    with mock.patch.object(SSD.SSDScan, "backward", staticmethod(counted)):
        yield


def _grads_of_step(torch, step_fn, params, opt, batch):
    """One train step on copies of params/opt; (loss, grads, launches)."""
    from torch.utils._pytree import tree_map
    from unittest import mock
    from repro_torch.optim import adamw
    seen = {}
    real = adamw.update

    def spy(cfg, grads, state, p):
        seen["grads"] = tree_map(lambda g: g.detach().clone(), grads)
        return real(cfg, grads, state, p)

    p = tree_map(lambda x: x.detach().clone(), params)
    o = opt._replace(mu=tree_map(torch.clone, opt.mu),
                     nu=tree_map(torch.clone, opt.nu),
                     master=tree_map(torch.clone, opt.master))
    reset_launches()
    with mock.patch.object(adamw, "update", spy):
        _, _, m = step_fn(p, o, batch)
        loss = float(m["loss"])
    torch.cuda.synchronize()
    return loss, seen["grads"], read_launches()


def train_step_check(torch, report) -> None:
    """Phase 8c: one train step with the kernels and with the plain
    versions, at full width, 2 layers, float32."""
    import dataclasses
    from torch.utils._pytree import tree_flatten_with_path
    from repro_torch.configs import get_config
    c = STEP_CHECK
    out = report["train_step_check"] = {}
    with phase("8c. one train step on the card: kernels against plain "
               "versions"):
        for arch in ("qwen2-0.5b", "mamba2-2.7b"):
            cfg = dataclasses.replace(get_config(arch), n_layers=c["layers"],
                                      dtype="float32")
            params, opt, step_fn, pipe = _train_setup(
                torch, cfg, c["batch"], c["seq"], 1, 1e-3, seed=1)
            batch = pipe.next_batch()
            lk, gk, launches_k = _grads_of_step(torch, step_fn, params, opt,
                                                batch)
            with plain_versions():
                lp, gp, launches_p = _grads_of_step(torch, step_fn, params,
                                                    opt, batch)
            print(f"{arch} ({c['layers']} layers, float32): loss kernel "
                  f"{lk} plain {lp}; launches {launches_k} / plain "
                  f"{launches_p}")
            check(abs(lk - lp) <= c["loss_tol"],
                  f"{arch}: losses differ by {abs(lk - lp)}")
            check(not any(launches_p.values()),
                  f"{arch}: the plain run launched {launches_p}")
            want = ({"flash_attention": 2 * c["layers"],
                     "flash_attention_bwd": c["layers"]}
                    if cfg.family == "dense"
                    else {"ssd_scan": 2 * c["layers"]})
            check(all(launches_k[k] == n for k, n in want.items()),
                  f"{arch}: kernel launches {launches_k}, expected {want}")
            worst = {}
            for (path, a), (_, w) in zip(tree_flatten_with_path(gk)[0],
                                         tree_flatten_with_path(gp)[0]):
                key = "".join(str(x) for x in path)
                err = float((a - w).abs().max())
                scale = float(w.abs().max())
                worst[key] = [err, scale]
                check(bool(torch.allclose(a, w, rtol=c["grad_rtol"],
                                          atol=c["grad_atol_frac"] * scale)),
                      f"{arch}: gradient {key} differs by {err} "
                      f"(largest entry {scale})")
            if cfg.family == "dense":
                for name in ("wq", "wk", "wv", "bq", "bk", "bv"):
                    g = gk["segments"][0]["attn"][name]
                    check(bool(g.abs().sum() > 0),
                          f"{arch}: {name} has no gradient on the card")
            rel = max(e / max(s, 1e-30) for e, s in worst.values())
            print(f"{arch}: {len(worst)} gradients within tolerance; "
                  f"largest error relative to its leaf's scale {rel:.3g}")
            out[arch] = {"loss_kernel": lk, "loss_plain": lp,
                         "launches": launches_k, "grad_err": worst,
                         "max_rel_grad_err": rel}
            del params, opt, step_fn, gk, gp
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 12: on-device construction and the SNN benchmark scripts
# ---------------------------------------------------------------------------
def _population_arrays(torch, model, sp) -> dict:
    """post_ind, g, valid and delay of synapse population ``sp`` (a spec
    entry), [n_pre, K] on the card, put back together from the groups the
    build split it into by post population (a slot is valid in one)."""
    groups = {g.name: g.ell for g in model.network.synapses}
    out, lo = {}, 0
    for pname, gname in zip(sp.post, sp.group_names()):
        e = groups[gname]
        if not out:
            out = {"post_ind": torch.zeros_like(e.post_ind),
                   "g": torch.zeros_like(e.g),
                   "valid": torch.zeros_like(e.valid),
                   "delay": (None if e.delay is None
                             else torch.zeros_like(e.delay))}
        out["post_ind"] = torch.where(e.valid, e.post_ind + lo,
                                      out["post_ind"])
        out["g"] = torch.where(e.valid, e.g, out["g"])
        if e.delay is not None:
            out["delay"] = torch.where(e.valid, e.delay, out["delay"])
        check(not bool((out["valid"] & e.valid).any()),
              f"{gname}: a slot valid in two groups")
        out["valid"] = out["valid"] | e.valid
        lo += model.network.populations[pname].n
    return out


def _build_spans(events) -> list:
    """Each synapse population's ``device_init`` span (seconds) with the
    redraw rounds its samplers reported inside it, in build order."""
    out, rounds = [], []
    for e in events:
        if e.get("name") == "device_init.redraw":
            rounds.append(e["args"]["rounds"])
        elif e.get("name") == "device_init" and e.get("ph") == "X":
            out.append({"group": e["args"]["group"],
                        "rows": e["args"]["rows"],
                        "n_post": e["args"]["n_post"],
                        "seconds": e["dur"] / 1e6, "redraw_rounds": rounds})
            rounds = []
    return out


def _device_build(torch, what: str, build, host_build_s) -> tuple:
    """Build ``what``'s net with init="device" (``build()`` -> (model,
    seconds)) and check it: every row k distinct sorted targets, the
    first and sampled rows equal to a CPU build of those rows through the
    plain versions bit for bit, the whole graph's digest the JAX package's.
    Returns (the numbers, the model, the build's launches)."""
    import numpy as np
    from experiments.graph_digest import FIELDS, graph_digest
    from repro_torch import random as RND
    from repro_torch.obs import trace
    from repro_torch.sparse import device_init as DI
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    trace.clear()
    reset_launches()
    model, build_s = build()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() - mem0
    resident = torch.cuda.memory_allocated() - mem0
    spans = _build_spans(trace.events())
    print(f"{what}: built on the card in {build_s:.3f} s (host build "
          f"{host_build_s if host_build_s is None else round(host_build_s, 3)}"
          f" s); peak {peak} B above the {mem0} B before it, {resident} B "
          f"resident after; launches {launches}")
    for sp in spans:
        print(f"  device_init {sp['group']}: {sp['seconds']:.4f} s, "
              f"{sp['rows']} rows, redraw rounds {sp['redraw_rounds']}")
    check(launches["threefry_draw.randint"] > 0
          and launches["threefry_fold_in"] > 0,
          f"{what}: the construction kernels did not launch: {launches}")
    rng = np.random.default_rng(CONSTRUCT_CHECK["seed"])
    seed = model.simulator.seed
    checked = {}
    for sidx, sp in enumerate(model.spec.synapses):
        n_pre = model.spec.populations[sp.pre].n
        n_post = sum(model.spec.populations[p].n for p in sp.post)
        k = sp.connect.n_conn
        arr = _population_arrays(torch, model, sp)
        post = arr["post_ind"]
        check(bool(arr["valid"].all()) and post.shape == (n_pre, k)
              and bool((post[:, 1:] > post[:, :-1]).all())
              and int(post.min()) >= 0 and int(post.max()) < n_post,
              f"{what} {sp.name}: a row without {k} distinct sorted targets")
        first = CONSTRUCT_CHECK["first_rows"]
        rest = rng.choice(np.arange(first, n_pre), size=min(
            CONSTRUCT_CHECK["sampled_rows"], n_pre - first), replace=False)
        rows = torch.from_numpy(np.concatenate(
            [np.arange(first), np.sort(rest)]).astype(np.int32))
        key = RND.fold_in(RND.PRNGKey(seed), sidx)
        t0 = time.perf_counter()
        cpu = dict(zip(("post_ind", "g", "valid"), DI.device_resolve(
            sp.connect, key, n_pre, n_post, sp.weight, rows=rows)))
        cpu["delay"] = (None if sp.delay is None else DI.device_delays(
            key, n_pre, k, sp.delay, rows=rows))
        cpu_s = time.perf_counter() - t0
        at = rows.to(post.device).long()
        for f in ("post_ind", "g", "valid", "delay"):
            if cpu[f] is None:
                check(arr[f] is None, f"{what} {sp.name}: a {f} array")
                continue
            x = arr[f].index_select(0, at).cpu()
            y = cpu[f]
            if f == "g":
                x, y = x.view(torch.int32), y.view(torch.int32)
            check(bool(torch.equal(x, y)),
                  f"{what} {sp.name}: {f} of the checked rows differs from "
                  "the CPU build through the plain versions")
        checked[sp.name] = {"rows": int(rows.numel()), "cpu_s": cpu_s}
        print(f"  {sp.name}: {rows.numel()} rows equal to the CPU build "
              f"bit for bit ({cpu_s:.2f} s on the CPU); every row {k} "
              "distinct sorted targets")
        del arr, post
    t0 = time.perf_counter()
    digest = graph_digest(
        (g.name, {f: getattr(g.ell, f) for f in FIELDS})
        for g in model.network.synapses)
    digest_s = time.perf_counter() - t0
    key = "delay" if "delayed" in model.spec.name else "main"
    print(f"  digest {digest} ({digest_s:.2f} s); the JAX package's "
          f"{DEVICE_INIT_DIGESTS[key]}")
    check(digest == DEVICE_INIT_DIGESTS[key],
          f"{what}: the graph's digest differs from the JAX package's")
    out = {"build_s": build_s, "host_build_s": host_build_s,
           "peak_bytes": peak, "resident_bytes": resident,
           "bytes_before": mem0, "spans": spans, "launches": launches,
           "rows_checked": checked, "digest": digest,
           "digest_s": digest_s}
    return out, model, launches


def _run_script(torch, name: str, env: dict, out_dir) -> dict:
    """One benchmark script's ``main`` in this process with its env knobs
    (restored after); its JSON is printed on a line of its own."""
    import importlib
    import os
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        t0 = time.perf_counter()
        mod = importlib.import_module(f"benchmarks.{name}_torch")
        payload = mod.main(["--out", str(out_dir)])
        secs = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    torch.cuda.empty_cache()
    print(f"{name}_torch ({secs:.1f} s): " + json.dumps(payload,
                                                         default=float))
    return {"seconds": secs, "result": payload}


def device_construction(torch, report) -> dict:
    """Phase 12: main's and the delayed net built on the card (init=
    "device") and checked, the device-built main net replayed for
    MAIN["steps"] steps bit-equal to its eager run, and the four SNN
    benchmark scripts at the main path's width.  Returns the launches of
    main's build."""
    from repro_torch.core.models import izhikevich_net as IZ
    with phase("12. on-device construction and the SNN benchmark "
               "scripts"):
        cfg = IZ.IzhikevichNetConfig(n_total=MAIN["n_total"],
                                     n_conn=MAIN["n_conn"],
                                     representation="sparse")

        def build_main():
            t0 = time.perf_counter()
            m = IZ.compile_model(cfg, init="device")
            torch.cuda.synchronize()
            return m, time.perf_counter() - t0

        main, model, launches = _device_build(
            torch, "12a main", build_main,
            report.get("main", {}).get("build_s"))
        graph, runs, _ = _eager_vs_graph(torch, model, "12c device-built "
                                         "main", MAIN["steps"])
        rates = {k: float(v) for k, v in runs[0].rates_hz.items()}
        check(bool(runs[0].finite) and all(
            0.0 < r < float("inf") for r in rates.values()),
            f"12c: the device-built net's run: finite "
            f"{bool(runs[0].finite)}, rates {rates}")
        us = graph["sets"][0]["graph_us_per_step"]
        ref = report.get("main", {}).get("eager_vs_graph", {})
        ref_us = ref["sets"][0]["graph_us_per_step"] if ref else None
        print(f"12c: device-built main replayed {us:.1f} us/step (phase 3's "
              f"host-built {ref_us if ref_us is None else round(ref_us, 1)});"
              f" rates Hz {rates} ({report['nvidia_smi']})")
        # phase 13 holds the engine's run of this net to this one
        ref = model.run(MAIN["steps"], record_raster=True)
        main.update({"eager_vs_graph": graph, "rates_hz": rates,
                     "us_per_step": us, "phase3_us_per_step": ref_us,
                     "run_digest": _run_digest(torch, ref)})
        del ref
        del model, runs
        delay, model, _ = _device_build(
            torch, "12b delay", lambda: build_delay_model(torch, "device"),
            report.get("delay", {}).get("build_s"))
        del model
        out_dir = ROOT / "chiprun_out" / "phase12_bench"
        scripts = {name: _run_script(torch, name, env, out_dir)
                   for name, env in SCRIPTS}
        report["construction"] = {"main": main, "delay": delay,
                                  "scripts": scripts}
        return launches


# ---------------------------------------------------------------------------
# phase 13: the sharded engine at one NCCL rank
# ---------------------------------------------------------------------------
def _engine_profiles(torch, model, steps: int) -> dict:
    """Profiles of ``steps`` steps of a model built over a mesh: its
    engine eagerly and replayed from graphs, and its own single-device
    Simulator replayed (the same net: the difference is the engine's)."""
    eng, sim = model.engine, model.simulator
    out = {}
    for what, run, st in (("engine eager", eng.run, eng.init_state()),
                          ("engine graph", eng.run_compiled,
                           eng.init_state()),
                          ("simulator graph", sim.run_compiled,
                           sim.init_state())):
        print(f"{what}:")
        out[what] = _profile_window(
            torch, lambda n, run=run, st=st: run(st, n), steps, guard=False)
    return out


def _engine_vs_simulator(torch, model, what: str, steps: int, **kw):
    """The engine's replayed run of ``steps`` from a fresh state against
    its model's single-device Simulator's, bit for bit (counts, state)."""
    eng, sim = model.engine, model.simulator
    a = eng.run_compiled(eng.init_state(), steps, **kw)
    b = sim.run_compiled(sim.init_state(), steps, **kw)
    _check_same_run(torch, a, b, f"{what} (engine vs simulator)")


def sharded_engine(torch, report) -> dict:
    """Phase 13; returns the launches of the engine's paths (main's
    build over the mesh and its run, delay, the mushroom body)."""
    import numpy as np
    from experiments.graph_digest import FIELDS, graph_digest
    from repro_torch.core.models import izhikevich_net as IZ
    from repro_torch.core.models import mushroom_body as MB
    from repro_torch.launch.mesh import make_snn_mesh
    from repro_torch.launch.snn_serve import SNNServer, StreamRequest
    from repro_torch.sparse import device_init as DI
    out = report["engine"] = {}
    launches: dict = {}
    with phase("13. the sharded engine at one NCCL rank"):
        mesh = make_snn_mesh(1)
        print(f"{mesh} ({report['nvidia_smi']})")
        check(mesh.backend == "nccl" and mesh.world_size == 1,
              f"expected one NCCL rank: {mesh}")
        # the exchange's collective alone, at main's exc words (B = 1)
        words = torch.zeros((1, MAIN["n_total"] * 4 // 5 // 32),
                            dtype=torch.int32, device=mesh.device)

        def gather(i):
            return mesh.all_gather(words, tiled=False)

        nccl_ms, _ = _device_ms(torch, gather, ENGINE["nccl_reps"])
        nccl_event_ms = _time_ms(torch, gather, ENGINE["nccl_reps"])
        out["nccl_all_gather"] = {"words": int(words.shape[1]),
                                  "device_ms": nccl_ms,
                                  "event_ms": nccl_event_ms}
        print(f"NCCL all_gather of {words.shape[1]} int32 words at world "
              f"size 1: {nccl_ms:.5f} ms device time a call, "
              f"{nccl_event_ms:.5f} ms back to back")

        # (a) phase 12c's net, built over the mesh (device_init_local)
        cfg = IZ.IzhikevichNetConfig(n_total=MAIN["n_total"],
                                     n_conn=MAIN["n_conn"],
                                     representation="sparse")
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = IZ.compile_model(cfg, init="device", mesh=mesh)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        launches["build"] = build_launches = read_launches()
        eng = model.engine
        print(f"13a: built {model} over the mesh in {build_s:.3f} s "
              f"(the full graph and every block drawn); routes "
              f"{eng.routes}; launches {build_launches}")
        check(eng.routes == {"exc": "izhikevich_step",
                             "inh": "izhikevich_step"},
              f"13a: neuron routes {eng.routes}")
        digest = graph_digest(
            (g.name, {f: getattr(g.ell, f) for f in FIELDS})
            for g in model.network.synapses)
        check(digest == DEVICE_INIT_DIGESTS["main"],
              "13a: the full graph's digest differs from the JAX "
              "package's (phase 12a's)")
        for g in model.network.synapses:
            ref = DI.partition_ell_by_post(g.ell, 1)
            blk = eng._conn[g.name].ell
            check(ref[5] == blk.max_conn,
                  f"13a {g.name}: k_local {blk.max_conn}, partition "
                  f"{ref[5]}")
            for f, x in zip(("g", "post_ind", "valid"), ref[:3]):
                y = getattr(blk, f)
                x = x[0]
                if f == "g":
                    x, y = x.view(torch.int32), y.view(torch.int32)
                check(bool(torch.equal(x, y)), f"13a {g.name}: the "
                      f"device_init_local block's {f} differs from "
                      "partition_ell_by_post of the graph")
            del ref
        block_digest = graph_digest(
            (g.name, {f: getattr(eng._conn[g.name].ell, f) for f in FIELDS})
            for g in model.network.synapses)
        print(f"13a: blocks equal partition_ell_by_post of the graph (phase "
              f"12c's), block digest {block_digest}")
        graph, _, _ = _eager_vs_graph(torch, model, "13a engine main",
                                      MAIN["steps"], sim=eng)
        model.run(MAIN["steps"], record_raster=True)      # captures
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = model.run(MAIN["steps"], record_raster=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches["main"] = la = read_launches()
        print(f"13a: engine run of {MAIN['steps']} steps in {secs:.3f} s; "
              f"launches {la}")
        steps = MAIN["steps"]
        for name, per_step in (("spike_bitmask", 2), ("izhikevich_step", 2),
                               ("threefry_split", 1), ("threefry_draw", 2)):
            check(la[name] == per_step * steps,
                  f"13a: {name} launched {la[name]} times for {per_step} x "
                  f"{steps} steps")
        check(la["ell_spmv"] >= 4 * steps,
              f"13a: ell_spmv launched {la['ell_spmv']} times")
        run_digest = _run_digest(torch, res, eng.gather_state(res.state))
        want = report.get("construction", {}).get("main", {}).get(
            "run_digest")
        if want is None:        # phase 12 did not run: its run, here
            ref_model = IZ.compile_model(cfg, init="device")
            want = _run_digest(torch, ref_model.run(steps,
                                                    record_raster=True))
            del ref_model
        check(run_digest == want, "13a: the engine's run (counts, "
              "rasters, state) differs from phase 12c's")
        print(f"13a: counts, rasters and state bit-equal to phase 12c's run "
              f"({run_digest[:16]})")
        del res
        prof = _engine_profiles(torch, model, ENGINE["profile_steps"])
        ops = {k: v["device_ops_per_step"] for k, v in prof.items()}
        print(f"13a: device ops a step {ops}; the exchange "
              f"{ops['engine graph'] - ops['simulator graph']:.1f} ops a "
              "step replayed")
        out["main"] = {
            "build_s": build_s, "build_launches": build_launches,
            "block_digest": block_digest, "eager_vs_graph": graph,
            "seconds": secs, "launches": la, "run_digest": run_digest,
            "us_per_step": {
                "eager": graph["sets"][0]["eager_us_per_step"],
                "graph": graph["sets"][0]["graph_us_per_step"],
                "phase12c_graph": report.get("construction", {}).get(
                    "main", {}).get("us_per_step")},
            "profile": prof,
            "exchange_ops_per_step": (ops["engine graph"]
                                      - ops["simulator graph"])}

        # (c) phase 4's sweep on the engine
        values, sweep_steps = list(SWEEP["values"]), SWEEP["steps"]
        model.sweep_gscale("exc", values, sweep_steps)     # captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sw = model.sweep_gscale("exc", values, sweep_steps)
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        sim = model.simulator
        names = model._expand_group("exc")
        gs = {n: torch.tensor(values, device=mesh.device) for n in names}
        ref = sim.run_compiled(sim.init_state(len(values)), sweep_steps, gs)
        for k, v in ref.spike_counts.items():
            check(bool(torch.equal(v, sw.spike_counts[k])),
                  f"13c: {k} counts differ from the simulator's sweep")
        check(bool(torch.equal(ref.finite, sw.finite)),
              "13c: finite differs from the simulator's sweep")
        cps = len(values) / sweep_s
        cps4 = report.get("sweep", {}).get("candidates_per_s")
        print(f"13c: {len(values)} x {sweep_steps} steps in {sweep_s:.3f} s:"
              f" {cps:.3f} candidates/s (phase 4's {cps4}); counts equal "
              "the simulator's sweep")
        out["sweep"] = {"seconds": sweep_s, "candidates_per_s": cps,
                        "phase4_candidates_per_s": cps4,
                        "rates_hz": {k: v.tolist()
                                     for k, v in sw.rates_hz.items()}}
        del ref, sw

        # (d) phase 11's 16 requests served on the engine in 8 slots
        S, C = SNN_SERVE["streams"], SNN_SERVE["chunk"]
        n_exc = model.network.populations["exc"].n
        reqs = _serve_requests(np, n_exc, SNN_SERVE["izh_scale"],
                               SNN_SERVE["requests"])
        srv = SNNServer(model, max_streams=S, chunk=C, stim_pops=("exc",))
        t0 = time.perf_counter()
        model.serve_chunk(srv.states, {"exc": np.zeros((S, C, n_exc),
                                                       np.float32)},
                          np.zeros(S, np.int32), C)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        for i, (T, stim, seed) in enumerate(reqs):
            srv.submit(StreamRequest(rid=i, n_steps=T, stim={"exc": stim},
                                     seed=seed))
        d = _drain(torch, srv)
        finished = srv.run()
        check(len(finished) == len(reqs), f"13d: {len(finished)} of "
              f"{len(reqs)} streams finished")
        for r in finished:
            off = _offline(model, r.n_steps, r.stim, r.seed)
            _assert_same_counts(np, f"13d stream {r.rid}", r.spike_counts,
                                off.spike_counts)
        d["capture_s"] = capture_s
        d["phase11_slot_steps_per_s"] = report.get("serve_snn", {}).get(
            "izh", {}).get("slot_steps_per_s")
        out["serve"] = d
        print(f"13d: {len(reqs)} streams, {d['chunks']} chunks, "
              f"{d['slot_steps']} slot-steps in {d['wall_s']:.3f} s "
              f"({d['slot_steps_per_s']:.1f} slot-steps/s, phase 11's "
              f"{d['phase11_slot_steps_per_s']}; chunk ms p50 "
              f"{d['chunk_ms_p50']:.3f} p99 {d['chunk_ms_p99']:.3f}); every "
              "stream's counts equal its offline run on the engine")
        del srv, finished, model, eng, sim
        torch.cuda.empty_cache()

        # (b) phase 5's delayed net, host-built over the mesh
        model, build_s = build_delay_model(torch, "host", mesh=mesh)
        eng = model.engine
        graph_b, _, _ = _eager_vs_graph(torch, model, "13b engine delay",
                                        DELAY["steps"], sim=eng)
        model.run(DELAY["steps"], record_raster=True)     # captures
        reset_launches()
        res = model.run(DELAY["steps"], record_raster=True)
        torch.cuda.synchronize()
        launches["delay"] = lb = read_launches()
        for name in ("ell_spmv_delay", "delay_ring_fold", "spike_bitmask"):
            check(lb[name] == 2 * DELAY["steps"],
                  f"13b: {name} launched {lb[name]} times")
        digest_b = _run_digest(torch, res, eng.gather_state(res.state))
        want = report.get("delay", {}).get("run_digest")
        if want is not None:
            check(digest_b == want, "13b: the engine's run differs from "
                  "phase 5's")
        _engine_vs_simulator(torch, model, "13b", DELAY["steps"])
        print(f"13b: delayed net built in {build_s:.1f} s; engine run "
              f"bit-equal to {'phase 5' if want else 'its simulator'}'s; "
              f"launches {lb}")
        out["delay"] = {"build_s": build_s, "eager_vs_graph": graph_b,
                        "launches": lb, "run_digest": digest_b,
                        "phase5_digest": want}
        del res, model, eng
        torch.cuda.empty_cache()

        # (e) phase 6a's NaN-guard table on the engine (the hh_step route)
        mb = MB.compile_model(MB.MushroomBodyConfig(**MB_EXAMPLE), mesh=mesh)
        check(set(mb.engine.routes.values()) == {"codegen", "hh_step"},
              f"13e: routes {mb.engine.routes}")
        values, steps = list(MB_TABLE["values"]), MB_TABLE["steps"]
        mb.sweep_gscale("PN_KC", values, steps)            # captures
        reset_launches()
        tab = mb.sweep_gscale("PN_KC", values, steps)
        launches["mb"] = le = read_launches()
        check(le["hh_step"] == 3 * steps,
              f"13e: hh_step launched {le['hh_step']} times")
        rates = {k: v.tolist() for k, v in tab.rates_hz.items()}
        finite = tab.finite.tolist()
        want = report.get("mb_table")
        if want is not None:
            check(rates == want["rates_hz"] and finite == want["finite"],
                  "13e: the table differs from phase 6a's")
        else:
            sim = mb.simulator
            ref = sim.run_compiled(sim.init_state(len(values)), steps, {
                "PN_KC": torch.tensor(values, device=mesh.device)})
            check(all(bool(torch.equal(ref.spike_counts[k],
                                       tab.spike_counts[k]))
                      for k in ref.spike_counts), "13e: counts differ "
                  "from the simulator's")
        check(finite[0] and finite[1] and not finite[-1],
              f"13e: the NaN guard's table {finite}")
        print(f"13e: the mushroom body's table on the engine equals "
              f"{'phase 6a' if want else 'its simulator'}'s: finite "
              f"{finite}; launches {le}")
        out["mb_table"] = {"rates_hz": rates, "finite": finite,
                           "launches": le}
        del mb, tab
        # the group ends here: every model (and graph) over it first
        import gc
        import torch.distributed as dist
        from repro_torch.launch.mesh import shutdown_distributed
        mesh = model = None
        gc.collect()
        torch.cuda.synchronize()
        check(shutdown_distributed() and not dist.is_initialized(),
              "13: the NCCL process group did not end")
        print("13: the NCCL process group ended (shutdown_distributed)")
    return launches


# ---------------------------------------------------------------------------
# phase 9: recording and state rewrites on the card
# ---------------------------------------------------------------------------
def compare_bitmask(torch, report) -> list:
    """Phase 9a: the spike bitmask against its plain version at the paths'
    shapes (bit-equal), the ring variant with a device slot and active
    flag; device ms beside the bytes bound and the plain version."""
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import spike_bitmask as SBK
    dev = torch.device("cuda")
    rows = []
    with phase("9a. spike_bitmask against its plain version"):
        gen = torch.Generator(device=dev)
        gen.manual_seed(9)
        for b, n in BITMASK_SHAPES:
            # ~2% firing, as main's exc population bursts; bit 31 of the
            # first word and the last neuron set
            bits = torch.rand((b, n), device=dev, generator=gen) < 0.02
            bits[:, 31] = True
            bits[:, -1] = True
            got = SBK.spike_bitmask(bits)
            check(bool(torch.equal(got, R.spike_bitmask_ref(bits)))
                  and bool(torch.equal(got.cpu(), R.spike_bitmask_ref(
                      bits.cpu()))),
                  f"spike_bitmask [{b}, {n}]: not bit-equal to its plain "
                  "version")
            words = got.shape[1]
            kern = lambda i, x=bits: SBK.spike_bitmask(x)
            plain = lambda i, x=bits: R.spike_bitmask_ref(x)
            t_bytes = (b * n + b * words * 4) / HBM_BYTES_PER_S * 1e3
            # one compare a neuron and one ballot a word, in integers
            t_ops = (b * n + b * words) / INT32_OPS * 1e3
            row = {"name": "spike_bitmask", "B": b, "n": n, "words": words,
                   "max_abs_err": 0.0,
                   "ms": _device_ms(torch, kern, 50, "spike_bitmask")[0],
                   "wall_ms": _time_ms(torch, kern, 50),
                   "plain_ms": _device_ms(torch, plain, 20)[0],
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "library_ms": None}
            rows.append(row)
            print(json.dumps(row))
        # the ring variant: slot and flag read on the device
        ring = torch.zeros((40, 1, 2500), dtype=torch.int32, device=dev)
        slot = torch.tensor(17, dtype=torch.int32, device=dev)
        active = torch.tensor(True, device=dev)
        bits = torch.rand((1, 80_000), device=dev, generator=gen) < 0.02
        SBK.spike_bitmask_into(bits, ring, slot, active)
        want = torch.zeros_like(ring)
        want[17] = R.spike_bitmask_ref(bits)
        check(bool(torch.equal(ring, want)), "ring variant: row 17 wrong")
        active.fill_(False)
        SBK.spike_bitmask_into(~bits, ring, slot, active)
        check(bool(torch.equal(ring, want)), "ring variant wrote while the "
              "active flag was False")
        print("ring variant [40, 1, 2500]: device slot 17 written "
              "bit-equal; nothing written while inactive")
    report["bitmask_table"] = rows
    r = rows[0]
    return [{"name": "spike_bitmask", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/spike_bitmask.cu",
             "replaces": "src/repro/core/snn/bitmask.py:29", "launches": 0,
             **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms")}}]


def _observations_equal(torch, a, b, what: str) -> None:
    """Two RunResults' recordings (data bits and counts) and health
    reports, bit for bit."""
    import dataclasses
    check(a.recordings.keys() == b.recordings.keys(),
          f"{what}: other probes")
    for name in a.recordings.keys():
        x, y = a.recordings[name], b.recordings[name]
        same = x.dtype == y.dtype and x.shape == y.shape
        if same and x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        check(same and bool(torch.equal(x, y))
              and bool(torch.equal(a.recordings.count(name),
                                   b.recordings.count(name))),
              f"{what}: recording {name} differs between eager and graph")
    check((a.health is None) == (b.health is None), f"{what}: health")
    if a.health is not None:
        for f in dataclasses.fields(a.health):
            x, y = getattr(a.health, f.name), getattr(b.health, f.name)
            pairs = ([(x[k], y[k]) for k in x] if isinstance(x, dict)
                     else [(x, y)])
            check(all(bool(torch.equal(p, q)) for p, q in pairs),
                  f"{what}: health {f.name} differs between eager and graph")


def _timed(torch, fn) -> tuple:
    """(seconds, result) of ``fn()``, synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _ab_us_per_step(torch, runs: dict, steps: dict, turns: int) -> dict:
    """us/step of each named run, taken in turns (a, b, ..., b, a), the
    median of each run's times."""
    import statistics
    names = list(runs)
    times = {k: [] for k in names}
    for t in range(turns):
        for k in (names if t % 2 == 0 else names[::-1]):
            times[k].append(_timed(torch, runs[k])[0] / steps[k] * 1e6)
    return {k: {"us_per_step": statistics.median(v), "all": v}
            for k, v in times.items()}


def main_observed(torch, report) -> dict:
    """Phase 9b; returns the launch counts of the replayed observed run."""
    from repro_torch.core.models import izhikevich_net as IZ
    from repro_torch.core.snn.simulator import Simulator
    from repro_torch.obs.health import HealthConfig
    with phase("9b. main path observed: four probes and the monitor"):
        cfg = IZ.IzhikevichNetConfig(n_total=MAIN["n_total"],
                                     n_conn=MAIN["n_conn"],
                                     representation="sparse")
        ms = IZ.spec(cfg)
        ms.probe("exc_spk", "exc", "spikes")
        ms.probe("exc_vmean", "exc", "V", reduce="mean")
        ms.probe("exc_v25", "exc", "V", every=25, window=20)
        ms.probe("inh_spk", "inh", "spikes", every=10)
        mon = HealthConfig(default_band_hz=OBS_MAIN["bands"])
        t0 = time.perf_counter()
        model = ms.build(dt=cfg.dt, seed=cfg.seed, monitor=mon)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        sim = model.simulator
        # the same graph with nothing observed: the yardstick of the cost
        plain = Simulator(model.network, dt=cfg.dt, seed=cfg.seed)
        steps = OBS_MAIN["steps"]
        st = sim.init_state()
        print(f"built {model} in {build_s:.1f} s; probes "
              f"{[(p.name, p.var, p.every, p.window, p.reduce) for p in sim.probes]}")
        first_s, _ = _timed(torch, lambda: sim.run_compiled(st, steps))
        reset_launches()
        eager_s, e = _timed(torch, lambda: sim.run(st, steps))
        le = read_launches()
        reset_launches()
        graph_s, g = _timed(torch, lambda: sim.run_compiled(st, steps))
        lg = read_launches()
        _check_same_run(torch, e, g, "main observed")
        _observations_equal(torch, e, g, "main observed")
        n_packed = steps + steps // 10
        check({k: v for k, v in lg.items() if k != "spike_bitmask"}
              == {k: v for k, v in le.items() if k != "spike_bitmask"},
              f"main observed: the graph run launched {lg}, eager {le}")
        check(le["spike_bitmask"] == n_packed
              and lg["spike_bitmask"] == 2 * steps,
              f"spike_bitmask launched {le['spike_bitmask']} / "
              f"{lg['spike_bitmask']} times (eager / graph)")
        rec, hl = g.recordings, g.health
        check(tuple(rec["exc_spk"].shape) == (1, steps, 80_000)
              and tuple(rec["exc_v25"].shape) == (1, 20, 80_000)
              and int(rec.count("exc_v25")[0]) == 20
              and int(rec.count("inh_spk")[0]) == steps // 10,
              f"recording shapes {[(k, tuple(v.shape)) for k, v in rec.items()]}")
        for p in ("exc", "inh"):
            check(int(hl.spike_total[p][0]) == int(g.spike_counts[p].sum()),
                  f"health spike total of {p} is not the summed counts")
        check(all(bool(torch.isfinite(v).all()) for k, v in rec.items()
                  if v.dtype == torch.float32), "a V probe is not finite")
        # through the entry point: the spike probe is record_raster's
        reset_launches()
        r = model.run(steps, record_raster=True)
        check(bool(torch.equal(r.recordings["exc_spk"], r.raster["exc"]))
              and bool(torch.equal(r.recordings["inh_spk"],
                                   r.raster["inh"][9::10])),
              "the spike probes differ from record_raster's raster")
        summary = r.health.summary()
        print(f"eager {eager_s / steps * 1e6:.1f} us/step, graph "
              f"{graph_s / steps * 1e6:.1f} us/step (first graph run "
              f"{first_s:.3f} s); recordings, counts, health and state "
              f"bit-equal; the spike probes equal the raster; health "
              f"{summary}")
        # the cost of observing: plain and observed in turns
        pst = plain.init_state()
        plain.run_compiled(pst, steps)
        ab = _ab_us_per_step(torch, {
            "plain_eager": lambda: plain.run(pst, steps),
            "observed_eager": lambda: sim.run(st, steps),
            "observed_graph": lambda: sim.run_compiled(st, steps),
            "plain_graph": lambda: plain.run_compiled(pst, steps)},
            {k: steps for k in ("plain_eager", "observed_eager",
                                "observed_graph", "plain_graph")},
            OBS_MAIN["turns"])
        print("us/step in turns: " + ", ".join(
            f"{k} {v['us_per_step']:.1f}" for k, v in ab.items()))
        ps = OBS_MAIN["profile_steps"]
        print("observed, eager:")
        prof_e = _profile_window(torch, lambda n: sim.run(st, n), ps,
                                 guard=False)
        print("observed, graph:")
        prof_g = _profile_window(torch, lambda n: sim.run_compiled(st, n),
                                 ps, guard=False)
        base = report["main"]["profile"]
        ops3 = (base["eager"]["device_ops_per_step"],
                base["graph"]["device_ops_per_step"])
        print(f"phase 3 (nothing observed): {ops3[0]:.1f} / {ops3[1]:.1f} "
              f"device ops a step eager / graph (PR 19: {MAIN_OPS_PR19}); "
              f"observed: {prof_e['device_ops_per_step']:.1f} / "
              f"{prof_g['device_ops_per_step']:.1f}")
        check(abs(ops3[0] - MAIN_OPS_PR19[0]) <= 1.0
              and abs(ops3[1] - MAIN_OPS_PR19[1]) <= 1.0,
              f"phase 3's device ops a step {ops3} moved from PR 19's "
              f"{MAIN_OPS_PR19}")
        bm = {n: v for n, v in prof_g["by_name"].items()
              if "spike_bitmask" in n}
        report["main_observed"] = {
            "build_s": build_s, "steps": steps, "first_graph_run_s": first_s,
            "eager_us_per_step": eager_s / steps * 1e6,
            "graph_us_per_step": graph_s / steps * 1e6,
            "launches_eager": le, "launches_graph": lg, "turns": ab,
            "health": summary, "profile": {"eager": prof_e, "graph": prof_g},
            "phase3_ops_per_step": ops3, "bitmask_in_graph_profile": bm,
            "graph_counts": dict(sim.graph_counts)}
        del e, g, r, model, sim, plain
        return lg


def mb_observed(torch, report) -> None:
    """Phase 9c: mb_full with the KC V probe, the KC->DN normalisation and
    the monitor: eager vs graph, the 2500-step run, the normalisation on
    the card against its plain version and a float64 oracle, the "post"
    reduction's time, the probe and monitor's cost, and the search with
    the probe's recordings per candidate."""
    import numpy as np
    from repro_torch.core import conductance as C
    from repro_torch.core.models import mushroom_body as MB
    from repro_torch.core.snn import custom_updates as CU
    from repro_torch.obs.health import HealthConfig
    with phase("9c. mushroom body observed: KC probe, KC->DN normalisation"):
        cfg = MB.MushroomBodyConfig(**MB_FULL,
                                    kc_probe_every=OBS_MB["kc_probe_every"],
                                    kc_dn_normalize=True)
        ex = MB_EXAMPLE
        fan_in = {"PN_KC": ex["n_pn"] / cfg.n_pn,
                  "PN_LHI": ex["n_pn"] / cfg.n_pn,
                  "LHI_KC": ex["n_lhi"] / cfg.n_lhi,
                  "KC_DN": ex["n_kc"] / cfg.n_kc,
                  "DN_DN": ex["n_dn"] / cfg.n_dn}
        t0 = time.perf_counter()
        model = MB.compile_model(cfg, monitor=HealthConfig())
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        sim = model.simulator
        kc_dn = next(x for x in model.network.synapses if x.name == "KC_DN")
        check(kc_dn.mutable_g and kc_dn.representation == "sparse",
              f"KC_DN: mutable {kc_dn.mutable_g}, {kc_dn.representation}")
        print(f"built {model} in {build_s:.1f} s; KC_DN sparse with its g "
              "in the state")
        gs = fan_in
        n = OBS_MB["check_steps"]
        st = sim.init_state()
        first_s, _ = _timed(torch, lambda: sim.run_compiled(st, n, gs))
        reset_launches()
        e = sim.run(st, n, gs)
        le = read_launches()
        reset_launches()
        g = sim.run_compiled(st, n, gs)
        lg = read_launches()
        check(le == lg, f"mb observed: the graph run launched {lg}, eager "
              f"{le}")
        _check_same_run(torch, e, g, "mb observed")
        _observations_equal(torch, e, g, "mb observed")
        del e, g
        steps = OBS_MB["steps"]
        res, secs, rates = _run_checked(torch, model, steps, "observed run",
                                        gscales=fan_in)
        kc_v = res.recordings["kc_v"]
        check(tuple(kc_v.shape) == (steps // 25, 100_000)
              and int(res.recordings.count("kc_v")) == steps // 25
              and bool(torch.isfinite(kc_v).all()),
              f"kc_v {tuple(kc_v.shape)}")
        summary = res.health.summary()
        print(f"health {summary}")

        # the normalisation on the card, plain, and a float64 oracle
        state = res.state
        g_total = cfg.n_kc * cfg.g_kc_dn / 2.0
        first_norm_s, _ = _timed(torch, lambda: model.custom_update(
            "normalize_kc_dn", state))
        norm_s, normed = _timed(torch, lambda: model.custom_update(
            "normalize_kc_dn", state))
        got = normed.syn["KC_DN"].g[0]
        with plain_versions():
            plain_g = model.custom_update("normalize_kc_dn",
                                          state).syn["KC_DN"].g[0]
        g0 = state.syn["KC_DN"].g[0].double().cpu().numpy()
        valid = kc_dn.ell.valid.cpu().numpy()
        post = kc_dn.ell.post_ind.cpu().numpy().astype(np.int64)
        tot = np.zeros(cfg.n_dn)
        np.add.at(tot, post[valid], g0[valid])
        oracle = np.where(valid, g0 * g_total / np.maximum(tot[post], 1e-9),
                          g0)
        gk = got.double().cpu().numpy()
        err_plain = float(np.max(np.abs(gk - plain_g.double().cpu().numpy())
                                 / np.maximum(np.abs(oracle), 1e-30)))
        err_oracle = float(np.max(np.abs(gk - oracle)
                                  / np.maximum(np.abs(oracle), 1e-30)))
        after = np.zeros(cfg.n_dn)
        np.add.at(after, post[valid], gk[valid])
        err_total = float(np.max(np.abs(after - g_total)) / g_total)
        print(f"normalize_kc_dn on the card in {norm_s * 1e3:.3f} ms (first "
              f"call {first_norm_s * 1e3:.3f} ms): "
              f"relative error against the plain version {err_plain:.3g}, "
              f"against the float64 oracle {err_oracle:.3g}; every DN's "
              f"total within {err_total:.3g} of {g_total}")
        check(err_plain <= 1e-5 and err_oracle <= 1e-5 and err_total <= 1e-5,
              "the KC->DN normalisation misses 1e-5")

        # the "post" reduction at KC_DN's [100000, 100]: one ell_spmv
        # launch, every row live, 100 posts
        gst = state.syn["KC_DN"].g
        red = lambda i: CU.group_reduce_host("sum", gst, kc_dn.ell, "post",
                                             0.0, 1)
        flat_i = kc_dn.ell.post_ind.reshape(-1).long()
        flat_v = torch.where(kc_dn.ell.valid, gst[0], 0.0).reshape(-1)
        lib = lambda i: torch.zeros(cfg.n_dn, device="cuda").index_add_(
            0, flat_i, flat_v)
        # the bound of the sum alone (the kernel): g, post_ind and valid
        # read once, the float64 sums written; float64 adds at half the
        # float32 rate
        nnz = kc_dn.ell.n_pre * kc_dn.ell.max_conn
        t_bytes = (nnz * (4 + 4 + 1) + cfg.n_dn * 8) / HBM_BYTES_PER_S * 1e3
        t_ops = nnz / (FP32_FLOPS / 2) * 1e3
        with plain_versions():
            plain_ms = _device_ms(torch, red, 5)[0]
        red_ms, red_kernel_ms = _device_ms(torch, red, 10, "ell_spmv")
        post_red = {"shape": [kc_dn.ell.n_pre, kc_dn.ell.max_conn,
                              cfg.n_dn],
                    "ms": red_ms, "kernel_ms": red_kernel_ms,
                    "wall_ms": _time_ms(torch, red, 10),
                    "plain_ms": plain_ms,
                    "library_ms": _device_ms(torch, lib, 10)[0],
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "update_ms": norm_s * 1e3}
        print(f"the post reduction at {post_red['shape']}: "
              f"{json.dumps(post_red)}")

        # the cost of observing: 6b's configuration on the same card
        t0 = time.perf_counter()
        plain_model = MB.compile_model(MB.MushroomBodyConfig(**MB_FULL))
        torch.cuda.synchronize()
        pst = plain_model.simulator.init_state()
        plain_model.simulator.run_compiled(pst, steps, gs)
        ab = _ab_us_per_step(torch, {
            "plain_eager": lambda: plain_model.simulator.run(pst, n, gs),
            "observed_eager": lambda: sim.run(st, n, gs),
            "observed_graph": lambda: sim.run_compiled(st, steps, gs),
            "plain_graph": lambda: plain_model.simulator.run_compiled(
                pst, steps, gs)},
            {"plain_eager": n, "observed_eager": n, "observed_graph": steps,
             "plain_graph": steps}, OBS_MB["turns"])
        print("us/step in turns: " + ", ".join(
            f"{k} {v['us_per_step']:.1f}" for k, v in ab.items()))
        del plain_model, pst
        print("observed, eager:")
        prof_e = _profile_window(torch, lambda k: sim.run(st, k, gs), 50,
                                 guard=False)
        print("observed, graph:")
        prof_g = _profile_window(
            torch, lambda k: sim.run_compiled(st, k, gs), 50, guard=False)

        # the search with the KC V probe: recordings per candidate
        others = {k: v for k, v in fan_in.items() if k != "PN_KC"}
        seen = {}

        def kc_rate(cands):
            out = sim.run_compiled(model.init_state(len(cands)), steps,
                                   {**others,
                                    "PN_KC": cands.to(model.device)})
            seen["res"] = out
            return out.rates_hz["KC"], out.finite

        cands = list(MB_RUN["search"])
        search_s, pick = _timed(torch, lambda: C.search_sweep(
            kc_rate, cands, report["mb_table"]["rates_hz"]["KC"][1]))
        srec = seen["res"].recordings
        check(tuple(srec["kc_v"].shape) == (len(cands), steps // 25, 100_000)
              and srec.count("kc_v").tolist() == [steps // 25] * len(cands),
              f"search recordings {tuple(srec['kc_v'].shape)}")
        print(f"search of {len(cands)} candidates x {steps} steps in "
              f"{search_s:.3f} s with kc_v recordings "
              f"{tuple(srec['kc_v'].shape)}; pick {pick}")
        report["mb_observed"] = {
            "build_s": build_s, "check_steps": n, "first_graph_run_s":
            first_s, "launches": lg, "steps": steps, "seconds": secs,
            "us_per_step": secs / steps * 1e6, "rates_hz": rates,
            "health": summary, "normalize": {
                "ms": norm_s * 1e3, "first_ms": first_norm_s * 1e3,
                "err_plain": err_plain,
                "err_oracle": err_oracle, "err_total": err_total},
            "post_reduction": post_red, "turns": ab,
            "profile": {"eager": prof_e, "graph": prof_g},
            "search": {"seconds": search_s, "pick": pick.__dict__},
            "graph_counts": dict(sim.graph_counts)}


# ---------------------------------------------------------------------------
# phase 10: the occupancy model against the runtime, and the paper's
# experiment at full width
# ---------------------------------------------------------------------------

def _limits_vs_runtime(torch, AT) -> dict:
    """Every H100Limits value the runtime reports, beside the model's."""
    got = AT.device_limits()
    rows = {k: {"model": getattr(AT.H100, k), "runtime": v}
            for k, v in got.items()}
    for k, r in rows.items():
        print(f"  {k}: model {r['model']}, runtime {r['runtime']}")
        check(r["model"] == r["runtime"],
              f"H100Limits.{k} = {r['model']}, the card says {r['runtime']}")
    return rows


def _occupancy_vs_runtime(torch, AT) -> dict:
    """The model's resident CTAs against the runtime's for every kernel at
    every compiled block; the kernels the model chooses blocks for also at
    every block of whole warps they may take and, at 128 threads, at
    OCC_SMEM_WITNESS bytes of shared memory.  Each limit the runtime does
    not report must decide at least one case (UNIT_ALTERNATIVES: the count
    that limit alone changes)."""
    import dataclasses
    for lib in sorted({k.library for k in AT.KERNELS.values()}):
        want = sorted(n for n, k in AT.KERNELS.items() if k.library == lib)
        got = sorted(AT.kernel_names(lib))
        check(got == want, f"{lib} numbers the kernels {got}, the model "
              f"lists {want}")
    alts = {k: dataclasses.replace(AT.H100, **{k: v})
            for k, v in UNIT_ALTERNATIVES.items()}
    witnesses = {k: 0 for k in alts}
    table, mismatches, samples = [], [], 0
    for name, spec in AT.KERNELS.items():
        for block in spec.blocks:
            a = AT.kernel_attributes(name, block)
            dyn = a["launchDynamicSharedBytes"]
            regs, static = a["numRegs"], a["sharedSizeBytes"]
            occ = AT.occupancy(block, regs, static + dyn)
            rt = AT.runtime_occupancy(name, block)
            table.append({"kernel": name, "block": block, "regs": regs,
                          "static_smem": static, "dynamic_smem": dyn,
                          "spill_bytes": a["localSizeBytes"],
                          "model_ctas": occ["ctas"], "runtime_ctas": rt,
                          "occupancy": occ["occupancy"],
                          "limiter": occ["limiter"]})
            cases = [(block, dyn)]
            if len(spec.blocks) > 1 or spec.library == "device_limits":
                top = a["maxThreadsPerBlock"]
                cases += [(q, 0) for q in range(32, top + 1, 32)]
                if top >= 128:
                    cases += [(128, t - static) for t in OCC_SMEM_WITNESS
                              if t > static]
            for q, d in cases:
                want = AT.runtime_occupancy(name, block, q, d)
                got = AT.occupancy(q, regs, static + d)["ctas"]
                samples += 1
                if got != want:
                    mismatches.append((name, block, q, d, got, want))
                for k, lim in alts.items():
                    if AT.occupancy(q, regs, static + d, lim)["ctas"] != want:
                        witnesses[k] += 1
    print(f"  {samples} cases over {len(AT.KERNELS)} kernels; mismatches "
          f"{mismatches[:10]}; cases each unreported limit decides "
          f"{witnesses}")
    check(not mismatches, f"the occupancy model disagrees with the runtime "
          f"in {len(mismatches)} cases, e.g. {mismatches[:5]}")
    check(all(w > 0 for w in witnesses.values()),
          f"a limit decided no case: {witnesses}")
    return {"table": table, "samples": samples, "witnesses": witnesses}


@contextlib.contextmanager
def _forced_block(module, block):
    """Patch ``module.launch_plan`` to put ``block`` (rows, for the ELL
    scatters) in its plan: a measurement of the blocks the model did not
    choose (the port itself never does this)."""
    from unittest import mock
    from repro_torch.kernels import autotune as AT
    orig = module.launch_plan

    def plan(*args, **kw):
        p = dict(orig(*args, **kw))
        p["block"] = block
        if "rows_per_cta" in p:
            p["rows_per_cta"] = block
            p["smem_bytes"] = AT.spmv_smem_bytes(block)
        if hasattr(module, "GRID_STRIDE_MAX"):
            p["grid"] = (min(-(-args[1] // block), module.GRID_STRIDE_MAX),
                         args[0], 1)
        return p
    with mock.patch.object(module, "launch_plan", plan):
        yield


def _leaves(x) -> list:
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    return [x]


def _ms_by_block(torch, module, run, kname: str, order, reps: int) -> dict:
    """Device ms a call of ``run`` at each block of ``order`` (taken in
    that order, ``reps`` calls each, under ``_forced_block``), from ONE
    torch.profiler trace: each block is its own instantiation, told apart
    by the block in the kernel's name (``<kname>...<block`` demangled,
    ``...ILi<block>`` mangled).  One trace a case, since a process that
    takes hundreds of traces has had the profiler come back empty."""
    import re
    pat = re.compile(re.escape(kname) + r"\w*?(?:<|ILi)(\d+)")

    def calls():
        for blk in order:
            with _forced_block(module, blk):
                for _ in range(reps):
                    run()
        torch.cuda.synchronize()

    want = {blk: reps * list(order).count(blk) for blk in set(order)}
    for _ in range(5):          # a trace that dropped launches is retaken
        prof = _device_profile(torch, calls, warm=True)
        seen: dict = {}
        for name, (c, us) in prof["by_name"].items():
            m = pat.search(name)
            if m:
                n, t = seen.get(int(m.group(1)), (0, 0.0))
                seen[int(m.group(1))] = (n + c, t + us)
        kept = {blk: seen.get(blk, (0, 0.0))[0] for blk in want}
        if all(kept[b] > 0 and kept[b] % want[b] == 0 for b in want):
            break
    check(all(kept[b] > 0 and kept[b] % want[b] == 0 for b in want),
          f"traces of {kname} kept {kept} launches a block, not multiples "
          f"of {want}")
    return {blk: seen[blk][1] / seen[blk][0] / 1e3 for blk in want}


def _blocks_at_path_shapes(torch, AT, rounds: int = BLOCK_ROUNDS) -> list:
    """Each kernel whose block the model chooses, at its path's shape: the
    chosen block, then every compiled one: the result bit-equal to the
    chosen block's (and at the chosen block to the plain version; normals
    within NORMAL_ULP), device ms a call, the
    median of ``rounds`` rounds with the spread (max - min); a round is one
    profile of every block in turn (ascending, then descending, ...)."""
    from repro_torch.kernels import (delay_ring, ell_spmv, hh_step,
                                     izhikevich_step, spike_bitmask,
                                     threefry)
    from repro_torch.kernels import ref as R
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(10)

    def rnd(*shape):
        return torch.rand(shape, device=dev, generator=gen)

    g = rnd(N_PRE, N_CONN)
    idx = torch.randint(0, N_POST, (N_PRE, N_CONN), device=dev,
                        generator=gen, dtype=torch.int32)
    valid = rnd(N_PRE, N_CONN) < 0.8
    dly = torch.randint(0, N_SLOTS, (N_PRE, N_CONN), device=dev,
                        generator=gen, dtype=torch.int32)
    spk = rnd(1, N_PRE) < 0.01
    n_exc = IZH_SHAPES[0][1]
    v = -65.0 + 40.0 * rnd(1, n_exc)
    u, isyn = -13.0 + rnd(1, n_exc), 10.0 * rnd(1, n_exc)
    pa, pb, pc, pd = (rnd(n_exc) for _ in range(4))
    n_kc = HH_SHAPES[1][1]
    hv, hm, hh_, hn, hi = (-60.0 + 10.0 * rnd(1, n_kc), rnd(1, n_kc),
                           rnd(1, n_kc), rnd(1, n_kc), rnd(1, n_kc))
    keys = torch.randint(-2 ** 31, 2 ** 31 - 1, (1, 2), device=dev,
                         generator=gen, dtype=torch.int32)
    ring = rnd(*FOLD_SHAPES[0])
    b, s_, n_post = FOLD_SHAPES[0]
    acc0 = rnd(s_, n_post, b).double()
    cur = torch.full((b,), 11, dtype=torch.int32, device=dev)
    bits = rnd(1, n_exc) < 0.02
    cases = [
        ("ell_spmv", ell_spmv, "ell_spmv_live",
         lambda: ell_spmv.ell_spmv(g, idx, valid, spk, N_POST),
         lambda: R.ell_spmv_ref(g, idx, valid, spk, N_POST),
         lambda: ell_spmv.launch_plan(1, N_PRE, N_CONN, N_POST)),
        ("ell_spmv_delay", ell_spmv, "ell_spmv_delay_live",
         lambda: ell_spmv.ell_spmv_delay(g, idx, valid, dly, spk, N_POST,
                                         N_SLOTS),
         lambda: R.ell_spmv_delay_ref(g, idx, valid, dly, spk, N_POST,
                                      N_SLOTS),
         lambda: ell_spmv.launch_plan(1, N_PRE, N_CONN, N_POST,
                                      n_slots=N_SLOTS)),
        ("delay_ring_fold", delay_ring, "delay_ring_fold",
         lambda: delay_ring.delay_ring_fold(ring, acc0.clone(), cur, 1.0,
                                            0.7),
         lambda: R.delay_ring_fold_ref(ring, acc0.clone(), cur, 1.0, 0.7),
         lambda: delay_ring.launch_plan(b, s_, n_post)),
        ("izhikevich_step", izhikevich_step, "izhikevich_step",
         lambda: izhikevich_step.izhikevich_step(v, u, isyn, pa, pb, pc,
                                                 pd, 1.0),
         lambda: R.izhikevich_step_ref(v, u, isyn, pa, pb, pc, pd, 1.0),
         lambda: izhikevich_step.launch_plan(1, n_exc)),
        ("hh_step", hh_step, "hh_step",
         lambda: hh_step.hh_step(hv, hm, hh_, hn, hi, 0.1),
         lambda: R.hh_step_ref(hv, hm, hh_, hn, hi, 0.1),
         lambda: hh_step.launch_plan(1, n_kc)),
        ("threefry_split", threefry, "threefry_split",
         lambda: threefry.threefry_split(keys, THREEFRY_SPLITS[0]),
         lambda: R.threefry_split_ref(keys, THREEFRY_SPLITS[0]),
         lambda: threefry.launch_plan("threefry_split", 1,
                                      THREEFRY_SPLITS[0])),
        ("threefry_draw", threefry, "threefry_draw",
         lambda: threefry.threefry_draw(keys, n_exc, "normal", 5.0),
         lambda: R.threefry_draw_ref(keys, n_exc, "normal", 5.0),
         lambda: threefry.launch_plan("threefry_draw", 1, n_exc)),
        ("spike_bitmask", spike_bitmask, "spike_bitmask",
         lambda: spike_bitmask.spike_bitmask(bits),
         lambda: R.spike_bitmask_ref(bits),
         lambda: spike_bitmask.launch_plan(1, n_exc)),
    ]
    rows = []
    for label, module, kname, run, plain, plan_of in cases:
        plan = plan_of()
        chosen = plan["block"]
        want = _leaves(run())
        ref = _leaves(plain())
        for a, r in zip(want, ref):
            if label == "threefry_draw":
                check(_ulp(torch, a, r) <= NORMAL_ULP,
                      f"{label}: past {NORMAL_ULP} ulp of its plain version")
            else:
                check(bool(torch.equal(a, r)),
                      f"{label} at block {chosen}: not bit-equal to its "
                      "plain version")
        spec_blocks = (AT.SPMV_ROWS if module is ell_spmv
                       else AT.ELEMENTWISE_BLOCKS)
        for block in spec_blocks:
            with _forced_block(module, block):
                got = _leaves(run())
            for a, w in zip(got, want):
                check(bool(torch.equal(a, w)),
                      f"{label} at block {block}: not bit-equal to the "
                      f"chosen block {chosen}'s result")
        samples = {b: [] for b in spec_blocks}
        for r in range(rounds):
            ms = _ms_by_block(torch, module, run, kname,
                              spec_blocks if r % 2 == 0
                              else spec_blocks[::-1], 20)
            for block in spec_blocks:
                samples[block].append(ms[block])
        times = {b: sorted(t)[len(t) // 2] for b, t in samples.items()}
        spread = {b: max(t) - min(t) for b, t in samples.items()}
        row = {"name": label, "chosen": chosen,
               "occupancy": plan["occupancy"],
               "resident_ctas": plan["resident_ctas"],
               "limiter": plan["limiter"], "rounds": rounds,
               "ms_by_block": times, "spread_by_block": spread,
               "ms": times[chosen], "ms_256": times[256]}
        rows.append(row)
        print(f"  {label}: chosen {chosen} ({plan['resident_ctas']} CTAs "
              f"an SM, {plan['limiter']}); device ms by block, median of "
              f"{rounds} (spread) "
              + ", ".join(f"{k}: {t:.5f} ({spread[k]:.5f})"
                          for k, t in times.items()))
    del g, idx, valid, dly
    return rows


def _plan_modules() -> tuple:
    """The wrappers whose ``launch_plan`` takes its block from the model."""
    from repro_torch.kernels import (delay_ring, ell_spmv, hh_step,
                                     izhikevich_step, spike_bitmask,
                                     threefry)
    return (delay_ring, ell_spmv, hh_step, izhikevich_step, spike_bitmask,
            threefry)


def _trace_plans(events) -> list:
    """The plans the wrappers made, one a shape: the trace's
    ``choose_block_elementwise`` / ``choose_block_spmv`` instants tagged
    ``launch_plan``, as (key, args); key (kernel, n, batch), or
    ("ell_spmv" | "ell_spmv_delay", n_pre, k, n_post, b, n_slots)."""
    plans = {}
    for e in events:
        a = e.get("args", {})
        if a.get("tag") != "launch_plan":
            continue
        if e["name"] == "choose_block_spmv":
            key = ("ell_spmv" if a["n_slots"] is None else "ell_spmv_delay",
                   a["n_pre"], a["k"], a["n_post"], a["b"], a["n_slots"])
        elif e["name"] == "choose_block_elementwise":
            key = (a["kernel"], a["n"], a["batch"])
        else:
            continue
        plans.setdefault(key, a)
    return list(plans.items())


def _blocks_at_experiment_shapes(torch, plans) -> list:
    """Each plan the experiment's wrappers made (``_trace_plans``), at its
    own shape on fresh inputs: the wrapper's result at the chosen block
    against the plain version (as ``_blocks_at_path_shapes`` holds it: bit
    for bit but the normal draws, within NORMAL_ULP; the ELL plain version
    member by member) and bit-equal to block 256's, the failures raised
    together at the end; device ms a call at the chosen block and at 256,
    in turns (chosen, 256, 256, chosen; 10 calls each) in one profile."""
    from repro_torch.kernels import ell_spmv, hh_step, izhikevich_step
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import spike_bitmask, threefry
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)

    def rnd(*shape):
        return torch.rand(shape, device=dev, generator=gen)

    def by_members(fn, b, step=4):
        return torch.cat([fn(slice(i, min(i + step, b)))
                          for i in range(0, b, step)])

    rows, failures = [], []
    for key, a in plans:
        name, chosen = key[0], a["block"]
        how = "equal"
        if name in ("ell_spmv", "ell_spmv_delay"):
            _, n_pre, k, n_post, b, n_slots = key
            g = rnd(n_pre, k)
            idx = torch.randint(0, n_post, (n_pre, k), device=dev,
                                generator=gen, dtype=torch.int32)
            valid = rnd(n_pre, k) < 0.8
            spk = rnd(b, n_pre) < 0.02
            module, kname = ell_spmv, "ell_spmv"
            if n_slots is None:
                run = lambda: ell_spmv.ell_spmv(g, idx, valid, spk, n_post)
                plain = lambda: by_members(lambda m: R.ell_spmv_ref(
                    g, idx, valid, spk[m], n_post), b)
            else:
                dly = torch.randint(0, n_slots, (n_pre, k), device=dev,
                                    generator=gen, dtype=torch.int32)
                run = lambda: ell_spmv.ell_spmv_delay(
                    g, idx, valid, dly, spk, n_post, n_slots)
                plain = lambda: by_members(lambda m: R.ell_spmv_delay_ref(
                    g, idx, valid, dly, spk[m], n_post, n_slots), b)
            shape = f"[{b}, {n_pre}] x K {k} -> {n_post}" + (
                f" x {n_slots} slots" if n_slots else "")
        elif name == "izhikevich_step":
            _, n, b = key
            v = -65.0 + 40.0 * rnd(b, n)
            u, isyn = -13.0 + rnd(b, n), 10.0 * rnd(b, n)
            pa, pb, pc, pd = (rnd(n) for _ in range(4))
            module, kname = izhikevich_step, name
            run = lambda: izhikevich_step.izhikevich_step(
                v, u, isyn, pa, pb, pc, pd, 1.0)
            plain = lambda: R.izhikevich_step_ref(v, u, isyn, pa, pb, pc,
                                                  pd, 1.0)
            shape = f"[{b}, {n}]"
        elif name == "hh_step":
            _, n, b = key
            hv, hm, hh_, hn, hi = (-60.0 + 10.0 * rnd(b, n), rnd(b, n),
                                   rnd(b, n), rnd(b, n), rnd(b, n))
            module, kname = hh_step, name
            run = lambda: hh_step.hh_step(hv, hm, hh_, hn, hi, 0.1)
            plain = lambda: R.hh_step_ref(hv, hm, hh_, hn, hi, 0.1)
            shape = f"[{b}, {n}]"
        elif name in ("threefry_split", "threefry_draw"):
            _, n, b = key
            keys = torch.randint(-2 ** 31, 2 ** 31 - 1, (b, 2), device=dev,
                                 generator=gen, dtype=torch.int32)
            module, kname = threefry, name
            if name == "threefry_split":
                run = lambda: threefry.threefry_split(keys, n)
                plain = lambda: R.threefry_split_ref(keys, n)
            else:
                # the draw's kernel is one for every distribution: uniform
                # held bit-equal here, normal within NORMAL_ULP below
                check(bool(torch.equal(
                    threefry.threefry_draw(keys, n, "uniform"),
                    R.threefry_draw_ref(keys, n, "uniform"))),
                    f"threefry uniform at [{b}, {n}]: not bit-equal")
                how = "normal"
                run = lambda: threefry.threefry_draw(keys, n, "normal", 5.0)
                plain = lambda: R.threefry_draw_ref(keys, n, "normal", 5.0)
            shape = f"[{b}, {n}]"
        elif name == "spike_bitmask":
            _, n, b = key
            bits = rnd(b, n) < 0.02
            module, kname = spike_bitmask, name
            run = lambda: spike_bitmask.spike_bitmask(bits)
            plain = lambda: R.spike_bitmask_ref(bits)
            shape = f"[{b}, {n}]"
        else:
            raise SmokeFailure(f"phase 10 has no case for {name}'s plan "
                               f"{key}")
        want = _leaves(run())
        err = 0.0
        for x, r in zip(want, _leaves(plain())):
            if x.dtype == torch.float32:
                err = max(err, float((x - r).abs().max()))
            if how == "normal":
                if _ulp(torch, x, r) > NORMAL_ULP:
                    failures.append(f"{name} {shape}: past {NORMAL_ULP} "
                                    "ulp of its plain version")
            elif not bool(torch.equal(x, r)):
                failures.append(f"{name} {shape} at block {chosen}: not "
                                "bit-equal to its plain version")
        with _forced_block(module, 256):
            got = _leaves(run())
        if not all(bool(torch.equal(x, w)) for x, w in zip(got, want)):
            failures.append(f"{name} {shape}: block 256 not bit-equal to "
                            f"the chosen {chosen}'s result")
        ms = _ms_by_block(torch, module, run, kname,
                          (chosen, 256, 256, chosen), 10)
        row = {"name": name, "shape": shape, "chosen": chosen,
               "resident_ctas": a["resident_ctas"], "limiter": a["limiter"],
               "occupancy": a["occupancy"], "score": a["score"],
               "max_abs_err": err, "ms": ms[chosen], "ms_256": ms[256]}
        rows.append(row)
        print(f"  {name} {shape}: chosen {chosen} ({a['resident_ctas']} "
              f"CTAs an SM, {a['limiter']}, score {a['score']:.4f}); "
              f"device ms {ms[chosen]:.5f} at {chosen}, "
              f"{ms[256]:.5f} at 256; max abs err {err:.3g}")
        del run, plain, want, got
        torch.cuda.empty_cache()
    check(not failures, "; ".join(failures))
    return rows


def _print_izhikevich(res) -> None:
    print(f"  target rate {res['target_rate']:.4f} Hz (reference build "
          f"host_init {res['ref_host_init_s']:.3f} s)")
    print("   nConn |    gScale |  rate Hz | finite | host_init s | "
          "candidates/s")
    for row in zip(res["n_conns"], res["gscales"], res["rates"],
                   res["finite"], res["host_init_s"],
                   res["candidates_per_s"]):
        print("  {:6d} | {:9.5f} | {:8.4f} | {!s:6} | {:11.3f} | {:.3f}"
              .format(*row))
    print(f"  fit k1={res['k1']:.6g} k2={res['k2']:.6g} k3={res['k3']:.6g} "
          f"MAPE={res['mape_pct']:.3f}%")


def _print_mushroom(res) -> None:
    print(f"  KC target {res['target_rate']:.4f} Hz (reference build "
          f"host_init {res['ref_host_init_s']:.3f} s)")
    print("   nPN | PN_KC gScale |  KC Hz | finite | PN_LHI gScale | "
          "finite | host_init s | candidates/s")
    for row in zip(res["n_pns"], res["gscales"], res["rates"],
                   res["finite"], res["gscales_lhi"], res["finite_lhi"],
                   res["host_init_s"], res["candidates_per_s"]):
        print("  {:4d} | {:12.5f} | {:6.3f} | {!s:6} | {:13.5f} | {!s:6} | "
              "{:11.3f} | {:.3f}".format(*row))
    print(f"  PN_KC fit k1={res['k1']:.6g} k2={res['k2']:.6g} "
          f"k3={res['k3']:.6g} MAPE={res['mape_pct']:.3f}%")
    print(f"  PN_LHI fit k1={res['k1_lhi']:.6g} k2={res['k2_lhi']:.6g} "
          f"k3={res['k3_lhi']:.6g} MAPE={res['mape_lhi_pct']:.3f}%")


def paper_experiment(torch, report) -> dict:
    """Phase 10; returns the launch counts of the experiment's runs."""
    from benchmarks import gscale_experiments_torch as EXP
    from repro_torch.kernels import autotune as AT
    from repro_torch.obs import trace as TR
    with phase("10. the occupancy model against the runtime; the paper's "
               "gScale(nConn) experiment at full width"):
        out = report["experiment"] = {}
        print("H100Limits against the card:")
        out["limits"] = _limits_vs_runtime(torch, AT)
        print("resident CTAs an SM, the model against "
              "cudaOccupancyMaxActiveBlocksPerMultiprocessor:")
        out["occupancy"] = _occupancy_vs_runtime(torch, AT)
        for r in out["occupancy"]["table"]:
            print(f"  {r['kernel']} @ {r['block']}: {r['regs']} registers, "
                  f"{r['static_smem']} + {r['dynamic_smem']} B shared, "
                  f"{r['spill_bytes']} B spilled; {r['model_ctas']} CTAs an "
                  f"SM (runtime {r['runtime_ctas']}), {r['limiter']}")
        print("the model's blocks at the paths' shapes:")
        out["blocks"] = _blocks_at_path_shapes(torch, AT)
        torch.cuda.empty_cache()
        print(AT.occupancy_report())
        TR.clear()
        reset_launches()
        # every shape the experiment launches is planned anew in its trace
        for module in _plan_modules():
            module.launch_plan.cache_clear()
        cfg = EXPERIMENT["izhikevich"]
        t0 = time.perf_counter()
        izh = EXP.izhikevich_gscale_sweep(device="cuda", **cfg)
        izh_s = time.perf_counter() - t0
        print(f"Izhikevich net, {cfg['n_total']} neurons, nConn "
              f"{cfg['n_conns']}, {cfg['candidates']} candidates x "
              f"{cfg['n_steps']} steps, in {izh_s:.1f} s:")
        _print_izhikevich(izh)
        torch.cuda.empty_cache()
        cfg = EXPERIMENT["mushroom"]
        t0 = time.perf_counter()
        mb = EXP.mushroom_gscale_sweep(device="cuda",
                                       fan_in_from=MB_EXAMPLE, **cfg)
        mb_s = time.perf_counter() - t0
        print(f"mushroom body, {cfg['n_kc']} KCs / {cfg['n_lhi']} LHIs / "
              f"{cfg['n_dn']} DNs, nPN {cfg['n_pns']}, {cfg['candidates']} "
              f"candidates x {cfg['n_steps']} steps, LHI->KC, KC->DN and "
              f"DN->DN scaled by fan-in from {MB_EXAMPLE}, in {mb_s:.1f} s:")
        _print_mushroom(mb)
        launches = read_launches()
        print(f"launches in the experiment: {launches}")
        for name in ("ell_spmv", "izhikevich_step", "hh_step",
                     "threefry_split", "threefry_draw"):
            check(launches[name] > 0, f"the experiment launched no {name}")
        picks = (izh["gscales"] + mb["gscales"] + mb["gscales_lhi"])
        check(all(math.isfinite(g) for g in picks)
              and all(izh["finite"]) and all(mb["finite"])
              and all(mb["finite_lhi"]),
              f"a pick is not finite: izh {izh['finite']}, mb "
              f"{mb['finite']}, lhi {mb['finite_lhi']}")
        doc = TR.chrome_trace()
        plans = _trace_plans(doc["traceEvents"])
        print(f"the experiment's blocks, from the trace's {len(plans)} "
              "launch plans; each against its plain version and block "
              "256 at its shape:")
        out["experiment_blocks"] = _blocks_at_experiment_shapes(torch,
                                                                plans)
        kinds = {r["name"] for r in out["experiment_blocks"]}
        check({"ell_spmv", "izhikevich_step", "hh_step", "threefry_split",
               "threefry_draw"} <= kinds,
              f"the trace holds plans of only {sorted(kinds)}")
        path = ROOT / "chiprun_out" / "phase10_trace.json"
        path.parent.mkdir(exist_ok=True)
        n_events = TR.export(str(path))
        bad = TR.validate_chrome_trace(doc)
        names = {e["name"] for e in doc["traceEvents"]}
        need = {"build", "validate", "host_init", "codegen", "run",
                "choose_block_spmv", "choose_propagation"}
        print(f"trace of the experiment: {n_events} events, "
              f"{doc['otherData']['dropped_events']} dropped, to {path}; "
              f"validation {bad or 'ok'}; names {sorted(names)}")
        check(bad is None, f"the exported trace is invalid: {bad}")
        check(need <= names, f"the trace lacks {sorted(need - names)}")
        out.update({"izhikevich": izh, "izhikevich_s": izh_s,
                    "mushroom": mb, "mushroom_s": mb_s,
                    "launches": launches, "trace_events": n_events})
        return launches


# ---------------------------------------------------------------------------
# phase 11: SNN serving on the card
# ---------------------------------------------------------------------------
def _serve_requests(np, n: int, scale: float, count: int, seed: int = 0):
    """``count`` requests (T, stim [T, n], seed) as the JAX package's
    serving demo draws them: T in [min_steps, max_steps], ``scale *
    normal`` from numpy's default_rng(seed), request seeds 1000 + i."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        T = int(rng.integers(SNN_SERVE["min_steps"],
                             SNN_SERVE["max_steps"] + 1))
        out.append((T, (scale * rng.normal(size=(T, n))).astype(np.float32),
                    1000 + i))
    return out


def _offline(model, T: int, stim: dict, seed: int, gscales=None):
    """The offline oracle of a served stream: ``CompiledModel.run`` at B=1
    from ``init_state(key=PRNGKey(seed))`` (the graph route)."""
    from repro_torch import random as RND
    return model.run(T, stim=stim, gscales=gscales,
                     state=model.init_state(key=RND.PRNGKey(seed)))


def _drain(torch, srv) -> dict:
    """Serve until the queue drains; per chunk its wall seconds and phases
    (assemble, stim copy and replay by CUDA events, call and readback)."""
    chunk_s, phases = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while True:
        before = srv.total_chunks
        more = srv.serve_step()
        if srv.total_chunks > before:
            chunk_s.append(srv.last_chunk_wall_s)
            phases.append(dict(srv.last_chunk_phases))
        if not more:
            break
    wall = time.perf_counter() - t0
    srt = sorted(chunk_s)

    def pct(q):
        return srt[min(len(srt) - 1, int(round(q * (len(srt) - 1))))]

    mean = {k: sum(p[k] for p in phases) / len(phases) for k in phases[0]}
    return {"wall_s": wall, "chunks": len(chunk_s),
            "slot_steps": srv.total_slot_steps,
            "slot_steps_per_s": srv.total_slot_steps / wall,
            "chunk_ms_p50": pct(0.5) * 1e3, "chunk_ms_p99": pct(0.99) * 1e3,
            "phase_mean_ms": {k: v * 1e3 for k, v in mean.items()},
            "utilization": srv.stats()["slot_utilization"]}


def _masking_cost(torch, model, pop: str, gscales=None) -> dict:
    """One served chunk (S=8, every lane active for all 50 steps) against
    ``run_compiled`` of the same 50 steps at B=8 (no masking) on the same
    stim: device ops and device time a step from torch.profiler, and the
    card's busy share over the served chunk (host assembly excluded)."""
    S, C = SNN_SERVE["streams"], SNN_SERVE["chunk"]
    sim = model.simulator
    n = model.network.populations[pop].n
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    stim = torch.randn(S, C, n, device="cuda", generator=gen)
    host = torch.empty((S, C, n), pin_memory=True)
    host.copy_(stim)
    gs = {k: torch.tensor(v) for k, v in (gscales or {}).items()}
    st = sim.init_state(S)
    left = torch.full((S,), C, dtype=torch.int32)
    norm = model._norm_gscales(gscales)

    def served():
        model.serve_chunk(st, {pop: host}, left, C, gscales=gs)
        torch.cuda.synchronize()

    def plain():
        sim.run_compiled(st, C, norm, stim={pop: stim.transpose(0, 1)})
        torch.cuda.synchronize()

    out = {}
    for name, fn in (("served", served), ("run", plain),
                     ("served_2", served), ("run_2", plain)):
        fn()
        prof = _device_profile(torch, fn, warm=True)
        out[name] = {"device_ops_per_step": prof["device_ops"] / C,
                     "device_us_per_step": prof["device_busy_us"] / C,
                     "busy_share": prof["busy_share"],
                     "device_ops": prof["device_ops"],
                     "wall_us": prof["wall_us"]}
    for k in ("device_ops_per_step", "device_us_per_step"):
        sv = (out["served"][k] + out["served_2"][k]) / 2
        rn = (out["run"][k] + out["run_2"][k]) / 2
        out[f"{k}_overhead"] = sv / rn - 1.0
    print(f"  masking ({pop}, S={S}): served {out['served']} / run "
          f"{out['run']}; overhead ops "
          f"{100 * out['device_ops_per_step_overhead']:.1f}%, device time "
          f"{100 * out['device_us_per_step_overhead']:.1f}%")
    return out


def _assert_same_counts(np, what: str, got: dict, want: dict) -> None:
    for k, v in want.items():
        w = v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)
        g = got[k]
        if not np.array_equal(g, w):
            diff = np.nonzero(g != w)[0]
            raise SmokeFailure(
                f"{what}: population {k!r} spike counts differ from the "
                f"offline run at neurons {diff[:8].tolist()} "
                f"(served {g[diff[:8]].tolist()}, offline "
                f"{w[diff[:8]].tolist()})")


def _serve_http_check(torch, np) -> dict:
    """(e) The HTTP front door on the card: the gateway demo's Izhikevich
    net (200 x 30), buckets (2, 4) captured at registration on this
    thread, then 4 concurrent POST /v1/simulate requests served by the
    pump thread, which replays those graphs; each reply's spike counts
    equal the offline run's, and /metrics counts them."""
    import asyncio
    from repro_torch.core.models import izhikevich_net as IZ
    from repro_torch.launch.gateway import Gateway
    from repro_torch.launch.gateway_http import GatewayHTTP
    model = IZ.compile_model(IZ.IzhikevichNetConfig(n_total=200, n_conn=30))
    n = model.network.populations["exc"].n
    rng = np.random.default_rng(5)
    bodies = [{"model": "izh", "n_steps": 60, "seed": 70 + i,
               "stim": {"exc": (3.0 * rng.normal(size=(60, n))).tolist()}}
              for i in range(4)]

    async def scenario():
        gw = Gateway(chunk=25, buckets=(2, 4))
        gw.register("izh", model, stim_pops=("exc",))
        captures = model.simulator.graph_counts["captures"]
        srv = GatewayHTTP(gw, "127.0.0.1", 0, idle_sleep_s=0.001)
        host, port = await srv.start()

        async def http(method, path, body=None):
            reader, writer = await asyncio.open_connection(host, port)
            payload = b"" if body is None else json.dumps(body).encode()
            writer.write((f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
                          f"Content-Length: {len(payload)}\r\n\r\n")
                         .encode() + payload)
            await writer.drain()
            raw = await reader.read()
            writer.close()
            head, _, rest = raw.partition(b"\r\n\r\n")
            return int(head.split()[1]), rest

        try:
            replies = await asyncio.gather(
                *(http("POST", "/v1/simulate", b) for b in bodies))
            status, metrics = await http("GET", "/metrics")
        finally:
            await srv.stop()
        return replies, metrics.decode(), (
            model.simulator.graph_counts["captures"] - captures)

    t0 = time.perf_counter()
    replies, metrics, new_captures = asyncio.run(scenario())
    secs = time.perf_counter() - t0
    check(new_captures == 0, f"(e) the pump thread captured "
          f"{new_captures} graphs")
    for (status, body), req in zip(replies, bodies):
        out = json.loads(body)
        check(status == 200 and out["status"] == "done",
              f"(e) request {req['seed']}: {status} {out}")
        res = _offline(model, req["n_steps"],
                       {"exc": np.asarray(req["stim"]["exc"], np.float32)},
                       req["seed"])
        for k, v in res.spike_counts.items():
            check(v.cpu().tolist() == out["spike_counts"][k],
                  f"(e) request {req['seed']}: {k} counts differ from "
                  "the offline run's")
    check('gateway_completed_total{model="izh"} 4' in metrics,
          "(e) /metrics does not count the 4 requests")
    print(f"(e) HTTP front door: 4 concurrent requests served by the "
          f"pump thread from graphs captured at registration in "
          f"{secs:.3f} s, each exact; /metrics counts them")
    return {"seconds": secs, "requests": len(bodies)}


def serve_snn(torch, report) -> dict:
    """Phase 11; returns the serving paths' launch counts."""
    import numpy as np
    from repro_torch.core.models import izhikevich_net as IZ
    from repro_torch.core.models import mushroom_body as MB
    from repro_torch.launch.gateway import Gateway
    from repro_torch.launch.snn_serve import (SNNServer, StreamRequest,
                                              _check_exact)
    S, C = SNN_SERVE["streams"], SNN_SERVE["chunk"]
    out = report["serve_snn"] = {"config": {k: (list(v) if isinstance(
        v, tuple) else v) for k, v in SNN_SERVE.items()}}
    launches: dict = {}
    with phase("11. SNN serving at full width"):
        # (a) the Izhikevich net, 8 slots, 16 requests
        cfg = IZ.IzhikevichNetConfig(n_total=MAIN["n_total"],
                                     n_conn=MAIN["n_conn"],
                                     representation="sparse")
        t0 = time.perf_counter()
        model = IZ.compile_model(cfg)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        n_exc = model.network.populations["exc"].n
        reqs = _serve_requests(np, n_exc, SNN_SERVE["izh_scale"],
                               SNN_SERVE["requests"])
        srv = SNNServer(model, max_streams=S, chunk=C, stim_pops=("exc",))
        # the chunk's capture, before the timed drain
        t0 = time.perf_counter()
        model.serve_chunk(srv.states, {"exc": np.zeros((S, C, n_exc),
                                                       np.float32)},
                          np.zeros(S, np.int32), C)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        for i, (T, stim, seed) in enumerate(reqs):
            srv.submit(StreamRequest(rid=i, n_steps=T, stim={"exc": stim},
                                     seed=seed))
        reset_launches()
        a = _drain(torch, srv)
        launches.update(read_launches())
        finished = srv.run()
        check(len(finished) == len(reqs), f"(a) {len(finished)} of "
              f"{len(reqs)} streams finished")
        offline = {}
        for r in finished:
            res = _offline(model, r.n_steps, r.stim, r.seed)
            offline[r.rid] = {k: v.cpu().numpy()
                              for k, v in res.spike_counts.items()}
            _assert_same_counts(np, f"(a) stream {r.rid}", r.spike_counts,
                                res.spike_counts)
        a.update({"build_s": build_s, "capture_s": capture_s,
                  "streams_per_s": len(reqs) / a["wall_s"],
                  "spikes": int(sum(int(np.sum(r.spike_counts["exc"]))
                                    for r in finished))})
        a["masking"] = _masking_cost(torch, model, "exc")
        out["izh"] = a
        print(f"(a) izhikevich 100k x 1000: {len(reqs)} streams, "
              f"{a['slot_steps']} slot-steps in {a['wall_s']:.3f} s: "
              f"{a['slot_steps_per_s']:.1f} slot-steps/s, "
              f"{a['streams_per_s']:.3f} streams/s; chunk ms p50 "
              f"{a['chunk_ms_p50']:.3f} p99 {a['chunk_ms_p99']:.3f}; "
              f"phases ms {a['phase_mean_ms']}; capture {capture_s:.3f} s; "
              f"every stream's counts equal its offline B=1 run")

        # (b) the same requests through the gateway, shortest first:
        # buckets (4, 8), a deadline on every other submission, a fake
        # clock that passes them after the first chunk (mid-flight
        # eviction); 16 queued grow the table to 8, and once the first
        # survivors (the shorter) are done, the rest shrink it to 4
        order = sorted(range(len(reqs)), key=lambda i: reqs[i][0])
        clk = [0.0]
        gw = Gateway(chunk=C, buckets=SNN_SERVE["buckets"], max_queue=32,
                     shrink_patience=1, clock=lambda: clk[0])
        t0 = time.perf_counter()
        gw.register("izh", model, stim_pops=("exc",))
        warm_s = time.perf_counter() - t0
        greqs = []
        for k, i in enumerate(order):
            T, stim, seed = reqs[i]
            greqs.append(gw.submit("izh", {"exc": stim}, T, seed=seed,
                                   deadline_ms=500.0 if k % 2 else None))
        t0 = time.perf_counter()
        gw.tick()
        clk[0] += 1.0
        gw.run_until_drained()
        gw_s = time.perf_counter() - t0
        w = gw.workers["izh"]
        cnt = dict(w.counters)
        done = gw.collect_finished()
        survivors = [r for r in done if r.status == "done"]
        print(f"(b) gateway: counters {cnt}; {len(survivors)} survivors; "
              f"warm (bucket captures) {warm_s:.3f} s, served in "
              f"{gw_s:.3f} s")
        check(cnt["grows"] >= 1 and cnt["shrinks"] >= 1,
              f"(b) expected a grow and a shrink: {cnt}")
        check(cnt["evicted_active"] >= 1, f"(b) no mid-flight eviction: "
              f"{cnt}")
        check(len(survivors) == len(reqs) // 2 and all(
            r.rid % 2 == 0 for r in survivors),
            f"(b) survivors {[r.rid for r in survivors]}")
        for r in survivors:
            # the gateway numbers its requests from 0 in submission order
            i = order[r.rid]
            _assert_same_counts(np, f"(b) stream {i}", r.spike_counts,
                                offline[i])
        out["gateway"] = {"counters": cnt, "warm_s": warm_s,
                          "served_s": gw_s, "survivors": len(survivors),
                          "metrics_text_lines":
                              len(gw.render_metrics().splitlines())}
        del srv, gw, w, model, greqs
        torch.cuda.empty_cache()

        # (c) the mushroom body at 100k KCs, 8 streams, the KC V probe
        # every 5 steps; phase 6b's fan-in gScales (the default
        # conductances are non-finite at this size in both packages)
        mcfg = MB.MushroomBodyConfig(
            **MB_FULL, kc_probe_every=SNN_SERVE["mb_probe_every"])
        ex = MB_EXAMPLE
        fan_in = {"PN_KC": ex["n_pn"] / mcfg.n_pn,
                  "PN_LHI": ex["n_pn"] / mcfg.n_pn,
                  "LHI_KC": ex["n_lhi"] / mcfg.n_lhi,
                  "KC_DN": ex["n_kc"] / mcfg.n_kc,
                  "DN_DN": ex["n_dn"] / mcfg.n_dn}
        model = MB.compile_model(mcfg)
        n_kc = model.network.populations["KC"].n
        mreqs = _serve_requests(np, n_kc, SNN_SERVE["mb_scale"],
                                SNN_SERVE["mb_requests"])
        srv = SNNServer(model, max_streams=S, chunk=C, stim_pops=("KC",),
                        gscales=fan_in)
        # the chunk's capture, before the timed drain
        t0 = time.perf_counter()
        model.serve_chunk(srv.states, {"KC": np.zeros((S, C, n_kc),
                                                      np.float32)},
                          np.zeros(S, np.int32), C, gscales=fan_in)
        torch.cuda.synchronize()
        mb_capture_s = time.perf_counter() - t0
        for i, (T, stim, seed) in enumerate(mreqs):
            srv.submit(StreamRequest(rid=i, n_steps=T, stim={"KC": stim},
                                     seed=seed))
        reset_launches()
        c = _drain(torch, srv)
        for k, v in read_launches().items():
            launches[k] = launches.get(k, 0) + v
        finished = srv.run()
        check(len(finished) == len(mreqs), "(c) not every stream finished")
        fails = []
        for r in finished:
            fails += _check_exact(model, r, gscales=fan_in)
            check(r.recordings["kc_v"].shape[0] == r.n_steps
                  // SNN_SERVE["mb_probe_every"],
                  f"(c) stream {r.rid}: {r.recordings['kc_v'].shape[0]} "
                  "KC V samples")
        check(not fails, f"(c) {fails}")
        c["capture_s"] = mb_capture_s
        c["masking"] = _masking_cost(torch, model, "KC", fan_in)
        c["spikes"] = {p: int(sum(int(np.sum(r.spike_counts[p]))
                                  for r in finished))
                       for p in model.network.populations}
        out["mb"] = c
        print(f"(c) mushroom body 100k KCs: {c['slot_steps']} slot-steps "
              f"in {c['wall_s']:.3f} s: {c['slot_steps_per_s']:.1f} "
              f"slot-steps/s; chunk ms p50 {c['chunk_ms_p50']:.3f} p99 "
              f"{c['chunk_ms_p99']:.3f}; phases ms {c['phase_mean_ms']}; "
              f"spikes {c['spikes']}; counts exact, KC V within "
              "rtol=1e-5, atol=1e-4")
        del srv, model
        torch.cuda.empty_cache()

        # (d) phase 5's delayed net, 4 streams admitted one chunk apart
        # (their cursors differ in every chunk after the first; each keeps
        # its slot, since none ends before the last is admitted): each
        # stream's final state (rings and cursors included) equals its
        # offline run's bit for bit
        model, _ = build_delay_model(torch)
        n_exc = model.network.populations["exc"].n
        rng = np.random.default_rng(3)
        srv = SNNServer(model, max_streams=SNN_SERVE["delay_streams"], chunk=C,
                        stim_pops=("exc",))
        dreqs = []
        reset_launches()
        for i, T in enumerate(SNN_SERVE["delay_steps"]):
            stim = (SNN_SERVE["izh_scale"] * rng.normal(size=(T, n_exc))
                    ).astype(np.float32)
            dreqs.append(srv.submit(StreamRequest(
                rid=i, n_steps=T, stim={"exc": stim}, seed=2000 + i)))
            srv.serve_step()
        srv.run()
        for k, v in read_launches().items():
            launches[k] = launches.get(k, 0) + v
        final = _state_tensors(srv.states)
        delayed = [g.name for g in model.network.synapses
                   if g.ell.delay is not None]
        cursors = {g: srv.states.syn[g].cursor.tolist() for g in delayed}
        for slot, r in enumerate(dreqs):
            check(r.done, f"(d) stream {r.rid} did not finish")
            res = _offline(model, r.n_steps, r.stim, r.seed)
            _assert_same_counts(np, f"(d) stream {r.rid}", r.spike_counts,
                                res.spike_counts)
            for k, v in _state_tensors(res.state).items():
                x, y = final[k][slot], v[0]
                if x.dtype == torch.float32:
                    x, y = x.view(torch.int32), y.view(torch.int32)
                check(bool(torch.equal(x, y)),
                      f"(d) stream {r.rid}: state {k} differs from the "
                      "offline run's")
        print(f"(d) delayed net, streams admitted a chunk apart: final "
              f"cursors {cursors}; every state tensor (rings, cursors) "
              "equals the offline run's")
        out["delay"] = {"steps": list(SNN_SERVE["delay_steps"]),
                        "final_cursors": cursors}
        del srv, model
        torch.cuda.empty_cache()
        out["http"] = _serve_http_check(torch, np)
        out["launches"] = launches
        print(f"launches on the serving paths: {launches}")
        print(f"serving summary ({report['nvidia_smi']}): izh "
              f"{out['izh']['slot_steps_per_s']:.1f} slot-steps/s, "
              f"{out['izh']['streams_per_s']:.3f} streams/s, chunk ms p50 "
              f"{out['izh']['chunk_ms_p50']:.3f} / p99 "
              f"{out['izh']['chunk_ms_p99']:.3f}, ops a chunk "
              f"{out['izh']['masking']['served']['device_ops']}, busy "
              f"{100 * out['izh']['masking']['served']['busy_share']:.1f}%, "
              f"masking +{100 * out['izh']['masking']['device_us_per_step_overhead']:.1f}% "
              f"device time; mb {out['mb']['slot_steps_per_s']:.1f} "
              f"slot-steps/s, ops a chunk "
              f"{out['mb']['masking']['served']['device_ops']}, busy "
              f"{100 * out['mb']['masking']['served']['busy_share']:.1f}%, "
              f"masking +{100 * out['mb']['masking']['device_us_per_step_overhead']:.1f}%")
    return launches


# ---------------------------------------------------------------------------
# phase 15: the encdec family (whisper-tiny)
# ---------------------------------------------------------------------------
def _sdpa_kernels(prof) -> list:
    """PyTorch's own attention kernels in a profile, by name."""
    return [n for n in prof["by_name"] if any(p in n for p in SDPA_KERNELS)]


def _frame_params(params) -> int:
    """The parameters that run once an audio frame: the encoder's and each
    decoder layer's cross-attention keys and values."""
    from repro_torch.models import transformer as T
    xattn = params["segments"][0]["xattn"]
    return T.count_params(params["enc"]) + sum(
        T.count_params(xattn[k]) for k in ("wk", "wv", "bk", "bv")
        if k in xattn)


def _float32_step(torch, report, key: str, cfg, b: int, t: int, named):
    """One float32 training step at full width (``b`` x ``t`` tokens, the
    trainer's audio or image) through the kernels and through the plain
    versions: the forward's logits within the family check's tolerance,
    the loss and every gradient within 8c's; the gradients whose path
    ``named`` accepts must be nonzero."""
    from torch.utils._pytree import tree_flatten_with_path
    from repro_torch.launch.train import extra_inputs
    from repro_torch.models import transformer as T
    c = STEP_CHECK
    arch = cfg.name
    params, opt, step_fn, pipe = _train_setup(torch, cfg, b, t, 1, 1e-3,
                                              seed=1)
    batch = pipe.next_batch()
    batch.update(extra_inputs(cfg, b, 0, 1, "cuda"))
    extra = {k: batch[k] for k in ("audio", "img") if k in batch}
    inp = batch["tokens"][:, :-1]
    attn = _layer_kinds(cfg)["attn"]
    reset_launches()
    with torch.no_grad():
        lk, _ = T.forward(params, cfg, inp, extra)
    launches_f = read_launches()
    with plain_versions(), torch.no_grad():
        lp, _ = T.forward(params, cfg, inp, extra)
    lk, lp = lk[..., :cfg.vocab], lp[..., :cfg.vocab]
    torch.cuda.synchronize()
    logit_err = float((lk - lp).abs().max())
    check(launches_f["flash_attention"] == attn,
          f"the float32 forward launched {launches_f}")
    check(bool(torch.allclose(lk, lp, rtol=FAMILY_SERVE["tol"],
                              atol=FAMILY_SERVE["tol"])),
          f"{arch} float32 logits differ by {logit_err}")
    del lk, lp
    lossk, gk, launches_k = _grads_of_step(torch, step_fn, params, opt,
                                           batch)
    with plain_versions():
        lossp, gp, launches_p = _grads_of_step(torch, step_fn, params, opt,
                                               batch)
    print(f"{arch} (float32, {b} x {t}): logits max abs err {logit_err}; "
          f"loss kernel {lossk} plain {lossp}; launches {launches_k} / "
          f"plain {launches_p}")
    check(abs(lossk - lossp) <= c["loss_tol"],
          f"{arch}: losses differ by {abs(lossk - lossp)}")
    check(not any(launches_p.values()),
          f"{arch}: the plain run launched {launches_p}")
    want = {"flash_attention": 2 * attn, "flash_attention_bwd": attn}
    check(all(launches_k[k] == n for k, n in want.items()),
          f"{arch}: kernel launches {launches_k}, expected {want}")
    worst = {}
    for (path, a), (_, wt) in zip(tree_flatten_with_path(gk)[0],
                                  tree_flatten_with_path(gp)[0]):
        name = "".join(str(x) for x in path)
        err = float((a - wt).abs().max())
        scale = float(wt.abs().max())
        worst[name] = [err, scale]
        check(bool(torch.allclose(a, wt, rtol=c["grad_rtol"],
                                  atol=c["grad_atol_frac"] * scale)),
              f"{arch}: gradient {name} differs by {err} (largest entry "
              f"{scale})")
    picked = {k: v for k, v in worst.items() if named(k)}
    check(len(picked) > 0 and all(s > 0 for _, s in picked.values()),
          f"{arch}: a gradient of {sorted(picked)} is zero")
    rel = max(e / max(s, 1e-30) for e, s in worst.values())
    rel_named = max(e / max(s, 1e-30) for e, s in picked.values())
    print(f"{arch}: {len(worst)} gradients within tolerance ({len(picked)} "
          f"named: {rel_named:.3g} of their scale at most); largest error "
          f"relative to its leaf's scale {rel:.3g}")
    report[key] = {
        "logit_max_abs_err": logit_err, "loss_kernel": lossk,
        "loss_plain": lossp, "launches": launches_k, "grad_err": worst,
        "max_rel_grad_err": rel, "max_rel_grad_err_named": rel_named}
    del params, opt, step_fn, gk, gp
    torch.cuda.empty_cache()


def whisper_check(torch, report) -> None:
    """Phase 15c: one float32 whisper-tiny step at full width (2 x 448
    tokens, the trainer's audio) through the kernels and through the plain
    versions: the forward's logits, the loss and every gradient (the
    encoder's and the cross-attention's named)."""
    import dataclasses
    from repro_torch.configs import get_config
    w = WHISPER
    with phase("15c. one float32 whisper-tiny step: kernels against plain "
               "versions"):
        cfg = dataclasses.replace(get_config(w["arch"]), dtype="float32")
        _float32_step(torch, report, "whisper_check", cfg, w["check_batch"],
                      w["check_seq"],
                      lambda k: k.startswith("['enc']") or "xattn" in k)


def whisper(torch, report) -> dict:
    """Phase 15: whisper-tiny served (15a), trained (15b) and held to the
    plain versions in float32 (15c); returns 15a's and 15b's launches."""
    out = {"15a": serve_family(torch, report, "15a", WHISPER["arch"], None,
                               False, fs=WHISPER),
           "15b": train_full(torch, report, WHISPER["arch"], "15b")}
    whisper_check(torch, report)
    return out


# ---------------------------------------------------------------------------
# phase 17: the vlm family (paligemma-3b)
# ---------------------------------------------------------------------------
def paligemma_check(torch, report) -> None:
    """Phase 17c: one float32 paligemma-3b step at full width, 2 layers
    (2 x 512 tokens after the trainer's image): the float32 route's
    prefix-LM mask at D = 256, the image projection's and the attention's
    gradients named."""
    import dataclasses
    from repro_torch.configs import get_config
    p = PALIGEMMA
    with phase("17c. one float32 paligemma-3b step (2 layers): kernels "
               "against plain versions"):
        cfg = dataclasses.replace(get_config(p["arch"]),
                                  n_layers=p["check_layers"], dtype="float32")
        _float32_step(torch, report, "paligemma_check", cfg,
                      p["check_batch"], p["check_seq"],
                      lambda k: "img_proj" in k or any(
                          f"['attn']['{w}']" in k for w in ("wq", "wk",
                                                              "wv")))


def paligemma(torch, report) -> dict:
    """Phase 17: paligemma-3b served (17a), trained (17b) and held to the
    plain versions in float32 (17c); returns 17a's and 17b's launches."""
    out = {"17a": serve_family(torch, report, "17a", PALIGEMMA["arch"], None,
                               True, fs=PALIGEMMA),
           "17b": train_full(torch, report, PALIGEMMA["arch"], "17b")}
    paligemma_check(torch, report)
    return out


# ---------------------------------------------------------------------------
# phase 18: checkpoints on the card
# ---------------------------------------------------------------------------
def _ckpt_gap(torch, x: dict, y: dict) -> dict:
    """How far two checkpoints' leaves (key -> the numpy array written)
    lie apart: the leaves that differ and the largest absolute difference
    (bf16 leaves by value)."""
    import numpy as np
    check(sorted(x) == sorted(y), "the checkpoints hold other leaves")
    gap = {"leaves": len(x), "differ": [], "max_abs": 0.0}
    for k in x:
        if np.array_equal(x[k], y[k]):
            continue
        u, v = (torch.from_numpy(t.view(np.int16)).view(torch.bfloat16)
                .float() if t.dtype == np.uint16
                else torch.from_numpy(t).double() for t in (x[k], y[k]))
        gap["differ"].append(k)
        gap["max_abs"] = max(gap["max_abs"], float((u - v).abs().max()))
    return gap


def checkpoints(torch, report) -> None:
    """Phase 18: the trainer's checkpoints at full width (qwen2-0.5b, 2
    layers): a run restarted from step 3 equals an uninterrupted run (its
    losses 4-6 and its step-6 checkpoint), and a non-finite loss at step 5
    rolls back to step 3 with the LR halved; the checkpoint's bytes and
    its host copy, write and restore seconds, and the card memory a
    restore adds (the trainer restores in place: at most one leaf)."""
    import io
    import shutil
    import tempfile
    from unittest import mock
    from repro_torch.checkpoint import manager as CM
    from repro_torch.launch import train as TR
    from repro_torch.models import transformer as T
    c = CKPT
    out = report["checkpoints"] = {}
    with phase("18. checkpoints on the card: restart and rollback"):
        name, cfg = _family_config(c["arch"], c["n_layers"])
        times = {"host_copy_s": [], "write_s": [], "restore_s": [],
                 "restore_extra_bytes": []}
        # each directory's last step as written: {directory: {key: array}}
        written = {}

        class Timed(CM.CheckpointManager):
            def save(self, step, tree, blocking=False):
                self.wait()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                super().save(step, tree, blocking)
                times["host_copy_s"].append(time.perf_counter() - t0)

            def _write(self, step, host_leaves):
                t0 = time.perf_counter()
                super()._write(step, host_leaves)
                times["write_s"].append(time.perf_counter() - t0)
                if step == c["steps"]:
                    written[self.dir] = dict(host_leaves)

            def restore(self, step, like, in_place=False):
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                tree = super().restore(step, like, in_place)
                torch.cuda.synchronize()
                times["restore_s"].append(time.perf_counter() - t0)
                # what the restore adds on the card above the live state
                times["restore_extra_bytes"].append(
                    torch.cuda.max_memory_allocated() - before)
                return tree

        def train(d):
            log = io.StringIO()
            with mock.patch.object(TR, "CheckpointManager", Timed), \
                    contextlib.redirect_stdout(log):
                losses = TR.run(name, steps=c["steps"], batch=c["batch"],
                                seq=c["seq"], use_reduced=False,
                                ckpt_dir=str(d), ckpt_every=c["every"],
                                lr=c["lr"], log_every=1, device="cuda")
            return losses, log.getvalue()

        tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
        try:
            free = shutil.disk_usage(tmp).free
            step_dir = f"step_{c['steps']:09d}"
            a, b = tmp / "a", tmp / "b"
            t0 = time.perf_counter()
            full, _ = train(a)
            run_s = time.perf_counter() - t0
            nbytes = sum(f.stat().st_size for f in (a / step_dir).iterdir())
            again, _ = train(b)
            # two uninterrupted runs: the card's own run-to-run gap
            gap = _ckpt_gap(torch, written[a], written[b])
            (b / step_dir / "manifest.json").unlink()
            resumed, log = train(b)
            check(f"[train] restored step {c['every']}" in log,
                  f"the run did not restart from step {c['every']}:\n{log}")
            rgap = _ckpt_gap(torch, written[a], written[b])
            # the trainer restores into its live tensors: at most one
            # leaf's staging on the card, never a second state
            leaf_max = max(v.nbytes for v in written[a].values())
            print(f"{name}: a checkpoint of {nbytes} B ({free} B free in "
                  f"{tmp.parent}); uninterrupted losses {full}, a second "
                  f"run {again}, resumed from step {c['every']} "
                  f"{resumed}; step {c['steps']} state: two runs differ in "
                  f"{len(gap['differ'])} of {gap['leaves']} leaves (max abs "
                  f"{gap['max_abs']}), restarted vs uninterrupted in "
                  f"{len(rgap['differ'])} (max abs {rgap['max_abs']}); "
                  f"a run of {c['steps']} steps with 2 saves {run_s:.2f} s")
            # bit for bit where two uninterrupted runs are; else within
            # their gap
            loss_gap = max(abs(x - y) for x, y in zip(full, again))
            check(max(abs(x - y) for x, y in zip(resumed, full[c["every"]:]))
                  <= loss_gap and len(resumed) == c["steps"] - c["every"]
                  and rgap["max_abs"] <= gap["max_abs"]
                  and (gap["differ"] or not rgap["differ"]),
                  "the restarted run differs from the uninterrupted one by "
                  "more than two uninterrupted runs differ")
            shutil.rmtree(a)
            shutil.rmtree(b)
            written.clear()

            real, calls = T.loss_fn, []

            def nan_at(params, cfg_, batch):
                loss, metrics = real(params, cfg_, batch)
                calls.append(1)
                if len(calls) == c["nan_at"]:
                    loss = loss + float("nan")
                return loss, metrics

            with mock.patch.object(T, "loss_fn", nan_at):
                rolled, log = train(tmp / "rollback")
            print(f"rollback: losses {rolled}; "
                  + " | ".join(ln for ln in log.splitlines() if "NaN" in ln))
            check(f"NaN at step {c['nan_at'] - 1}; rollback to {c['every']}, "
                  "lr_scale=0.5" in log,
                  f"no rollback to {c['every']}:\n{log}")
            # steps 1-4, then step 4 again from the step-3 checkpoint
            n = c["nan_at"] - 1
            check(len(rolled) == c["steps"] + n - c["every"]
                  and all(abs(x - y) <= loss_gap for x, y in
                          zip(rolled[:n] + [rolled[n]],
                              full[:n] + [full[c["every"]]]))
                  and all(math.isfinite(x) for x in rolled),
                  f"the rollback's losses {rolled} against {full}")
            check(max(times["restore_extra_bytes"]) <= leaf_max,
                  f"a restore added {max(times['restore_extra_bytes'])} B "
                  f"on the card (largest leaf {leaf_max} B)")
            out.update({
                "config": {**c, "name": name}, "bytes": nbytes,
                "free_bytes": free, "run_s": run_s, **times,
                "losses": full, "second_run": again, "resumed": resumed,
                "run_gap": gap, "restart_gap": rgap, "loss_gap": loss_gap,
                "rollback": rolled})
            print(f"checkpoint {nbytes} B: host copy "
                  f"{min(times['host_copy_s']):.3f}-"
                  f"{max(times['host_copy_s']):.3f} s, write "
                  f"{min(times['write_s']):.3f}-{max(times['write_s']):.3f}"
                  f" s, restore {min(times['restore_s']):.3f}-"
                  f"{max(times['restore_s']):.3f} s, adding at most "
                  f"{max(times['restore_extra_bytes'])} B on the card")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 19: LM model parallelism on a one-rank NCCL mesh
# ---------------------------------------------------------------------------
def _margins(srv, rows: list):
    """Wrap ``srv``'s sampler to record each request's sampled rows:
    (token, top-2 margin) in order."""
    import numpy as np
    sample = srv._sample

    def recorded(logits, req):
        top = np.sort(logits[:srv.cfg.vocab].astype(np.float64))[-2:]
        tok = sample(logits, req)
        rows.setdefault(req.rid, []).append((tok, float(top[1] - top[0])))
        return tok

    srv._sample = recorded


def _mesh_requests(np, cfg, spec):
    from repro_torch.launch.serve import Request
    rng = np.random.default_rng(19)
    lo, hi = spec["prompt_len"]
    lens = rng.integers(lo, hi + 1, size=spec["requests"])
    return [Request(rid=i, prompt=rng.integers(3, cfg.vocab,
                                               size=int(n)).tolist(),
                    max_new=spec["max_new"]) for i, n in enumerate(lens)]


def _wave_numbers(waves) -> dict:
    w = waves[0]
    return {"prefill_s": w["prefill_s"],
            "decode_ms_per_step": w["decode_s"] / w["decode_steps"] * 1e3}


def _timed_steps(TR, times: list):
    """``make_train_step`` whose steps are timed on the card's clock
    (synchronized), appended to ``times`` in ms."""
    import torch
    real = TR.make_train_step

    def make(cfg, ocfg, mesh=None):
        step = real(cfg, ocfg, mesh)

        def timed(params, opt, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(params, opt, batch)
            float(out[2]["loss"])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            return out
        return timed
    return make


def lm_mesh(torch, report) -> dict:
    """Phase 19: the LM stack on a ("data", "model") mesh of one NCCL rank
    (``init_distributed``, then ``make_local_mesh(1)`` inside ``Server``
    and ``run``): (a) qwen2-0.5b served at full width, tokens equal to the
    unmeshed server's where its top-2 margin exceeds 1e-3, a float32
    prefill within 1e-4; (b) granite-moe trained at full width for 3
    steps, losses within rtol 1e-5 of the unmeshed trainer's; (c) a save
    of a placed training state restored by the unmeshed trainer, bit for
    bit; (d) grad_compression round-tripping qwen2-0.5b's gradient tree.
    Returns the launches of (a)'s and (b)'s mesh runs."""
    import io
    import shutil
    import tempfile
    from unittest import mock
    import numpy as np
    import torch.distributed as dist
    from torch.utils._pytree import tree_flatten, tree_map
    from repro_torch.checkpoint import manager as CM
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import serve as S
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import train as TR
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.optim import grad_compression as GC
    c = LM_MESH
    out = report["lm_mesh"] = {}
    launches = {}
    with phase("19. LM model parallelism on a one-rank NCCL mesh"):
        check(not dist.is_initialized(), "a process group is already up")
        # the unmeshed runs first: no group yet
        plain = S.Server(c["serve_arch"], use_reduced=False,
                         max_batch=c["max_batch"], max_seq=c["max_seq"],
                         seed=0)
        cfg = plain.cfg
        # warm-up (cuBLAS handles, allocator), as phase 7's
        warm = torch.randint(3, cfg.vocab, (1, 64), device="cuda")
        logits, caches = T.prefill(plain.params, cfg, warm, max_seq=80)
        T.decode_step(plain.params, cfg, caches, logits.argmax(-1))
        torch.cuda.synchronize()
        del caches, logits
        plain_rows: dict = {}
        _margins(plain, plain_rows)
        for r in _mesh_requests(np, cfg, c):
            plain.submit(r)
        plain.run()
        torch.cuda.synchronize()
        arch_t = c["train_arch"]
        log = io.StringIO()
        plain_times: list = []
        torch.cuda.reset_peak_memory_stats()
        with mock.patch.object(TR, "make_train_step",
                               _timed_steps(TR, plain_times)), \
                contextlib.redirect_stdout(log):
            plain_losses = TR.run(arch_t, steps=c["steps"], batch=c["batch"],
                                  seq=c["seq"], use_reduced=False,
                                  lr=c["lr"], log_every=100, device="cuda")
        plain_peak = torch.cuda.max_memory_allocated()
        plain_ms = sum(plain_times[1:]) / len(plain_times[1:])
        torch.cuda.empty_cache()

        MESH.init_distributed(backend="nccl")
        try:
            # (a) served on the mesh
            srv = S.Server(c["serve_arch"], use_reduced=False,
                           max_batch=c["max_batch"], max_seq=c["max_seq"],
                           seed=0, model_parallel=1)
            check(srv.mesh is not None and dict(srv.mesh.shape) ==
                  {"data": 1, "model": 1}
                  and dist.get_backend() == "nccl",
                  f"expected a 1 x 1 NCCL mesh: {srv.mesh}")
            print(f"{srv.mesh} ({report['nvidia_smi']})")
            rows: dict = {}
            _margins(srv, rows)
            reqs = _mesh_requests(np, cfg, c)
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for r in reqs:
                srv.submit(r)
            srv.run()
            torch.cuda.synchronize()
            serve_s = time.perf_counter() - t0
            launches["19a"] = read_launches()
            n_waves = len(srv.waves)
            check(launches["19a"]["flash_attention"]
                  == cfg.n_layers * n_waves,
                  f"flash_attention launched "
                  f"{launches['19a']['flash_attention']} times on the mesh "
                  f"for {cfg.n_layers} layers x {n_waves} waves")
            compared = differ = 0
            for rid, want in plain_rows.items():
                for (tok, margin), (got, _) in zip(want, rows[rid]):
                    if margin <= c["margin"]:
                        break       # past a near tie the runs may part
                    compared += 1
                    differ += tok != got
            check(differ == 0 and compared > 0,
                  f"{differ} of {compared} greedy tokens differ from the "
                  "unmeshed server's")
            mine, phase7 = _wave_numbers(srv.waves), _wave_numbers(
                plain.waves)
            print(f"19a: {len(reqs)} requests served on the mesh in "
                  f"{serve_s:.3f} s; {compared} tokens compared with the "
                  f"unmeshed server, all equal; prefill "
                  f"{mine['prefill_s']:.4f} s, decode "
                  f"{mine['decode_ms_per_step']:.2f} ms/step (unmeshed here: "
                  f"{phase7['prefill_s']:.4f} s, "
                  f"{phase7['decode_ms_per_step']:.2f} ms/step; phase 7: "
                  + (f"{report['serve']['waves'][0]['prefill_s']:.4f} s, "
                     f"{report['serve']['waves'][0]['decode_ms_per_step']:.2f}"
                     " ms/step" if "serve" in report else "not run")
                  + f"); launches {launches['19a']}")
            # float32 prefill on the mesh against the unmeshed one
            p32 = tree_map(lambda t: t.float(), plain.params)
            toks = torch.tensor(np.random.default_rng(7).integers(
                3, cfg.vocab, (c["f32_prompts"], c["f32_len"])),
                device="cuda")
            lp, _ = T.prefill(p32, cfg, toks)
            placed = SH.place_params(p32, srv.mesh)
            with SH.activate(srv.mesh, batch_sharded=True), \
                    torch.no_grad():
                lm, _ = T.prefill(placed, cfg, toks)
            err = float((lm[:, :cfg.vocab] - lp[:, :cfg.vocab]).abs().max())
            check(err <= c["f32_tol"], f"float32 prefill logits on the mesh "
                  f"differ by {err}")
            print(f"19a: float32 prefill {tuple(toks.shape)} on the mesh vs "
                  f"unmeshed: max abs err {err}")
            out["serve"] = {"requests": len(reqs), "seconds": serve_s,
                            "compared": compared, **mine,
                            "unmeshed": phase7, "f32_max_abs_err": err,
                            "launches": launches["19a"]}
            del srv, plain, p32, placed, lm, lp
            torch.cuda.empty_cache()

            # (b) granite-moe trained on the mesh
            times: list = []
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            with mock.patch.object(TR, "make_train_step",
                                   _timed_steps(TR, times)), \
                    contextlib.redirect_stdout(log):
                losses = TR.run(arch_t, steps=c["steps"], batch=c["batch"],
                                seq=c["seq"], use_reduced=False, lr=c["lr"],
                                log_every=100, model_parallel=1,
                                device="cuda")
            torch.cuda.synchronize()
            launches["19b"] = read_launches()
            peak = torch.cuda.max_memory_allocated()
            gap = max(abs(x - y) / abs(y) for x, y in zip(losses,
                                                           plain_losses))
            check(len(losses) == c["steps"] and gap <= c["loss_rtol"],
                  f"losses on the mesh {losses} vs unmeshed {plain_losses}")
            for k, n in c["per_step"].items():
                check(launches["19b"][k] == n * c["steps"],
                      f"{k} launched {launches['19b'][k]} times in "
                      f"{c['steps']} steps on the mesh, expected "
                      f"{n} a step")
            ms = sum(times[1:]) / len(times[1:])
            e14 = report.get(f"train_{arch_t}", {})
            print(f"19b: {arch_t} on the mesh, losses {losses} (unmeshed "
                  f"{plain_losses}, largest relative gap {gap}); "
                  f"{ms:.1f} ms/step after the first ({times}), peak "
                  f"{peak} B (unmeshed here: {plain_ms:.1f} ms/step "
                  f"({plain_times}), peak {plain_peak} B; phase 14e: "
                  + (f"{e14['ms_per_step']:.1f} ms/step, "
                     f"{e14['peak_mem_bytes']} B" if e14 else "not run")
                  + f"); launches {launches['19b']}")
            out["train"] = {"losses": losses, "unmeshed": plain_losses,
                            "rel_gap": gap, "step_ms": times,
                            "ms_per_step": ms, "peak_mem_bytes": peak,
                            "unmeshed_step_ms": plain_times,
                            "unmeshed_ms_per_step": plain_ms,
                            "unmeshed_peak_mem_bytes": plain_peak,
                            "launches": launches["19b"]}
            torch.cuda.empty_cache()

            # (c) a placed state saved on the mesh, restored unmeshed
            mesh = MESH.make_local_mesh(1)
            name, ccfg = _family_config(c["ckpt_arch"], c["ckpt_layers"])
            ocfg = adamw.AdamWConfig(lr=c["lr"], grad_clip=1.0)
            params = SH.place_params(T.init_params(
                ccfg, torch.Generator(device="cuda").manual_seed(0)), mesh)
            opt = adamw.init(ocfg, params)
            pipe = TokenPipeline(DataConfig(
                vocab=ccfg.vocab, seq_len=c["ckpt_seq"],
                global_batch=c["ckpt_batch"], seed=0), device="cuda")
            params, opt, _ = TR.make_train_step(ccfg, ocfg, mesh)(
                params, opt, pipe.next_batch())
            state = {"params": params, "opt": opt}
            want = {k: CM._to_host(v.full_tensor() if hasattr(
                v, "full_tensor") else v) for k, v in CM._flatten(state)}
            tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_ckpt_"))
            try:
                t0 = time.perf_counter()
                mgr = CM.CheckpointManager(tmp)
                mgr.save(1, state)
                mgr.wait()
                save_s = time.perf_counter() - t0
                del state, params, opt
                torch.cuda.empty_cache()
                plain_p = T.init_params(
                    ccfg, torch.Generator(device="cuda").manual_seed(1))
                like = {"params": plain_p, "opt": adamw.init(ocfg, plain_p)}
                back = CM.CheckpointManager(tmp).restore(1, like,
                                                         in_place=True)
                got = {k: CM._to_host(v) for k, v in CM._flatten(back)}
                nbytes = sum(f.stat().st_size for f in
                             (tmp / "step_000000001").iterdir())
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            bad = [k for k in want if not np.array_equal(
                np.atleast_1d(got[k]).view(np.uint8),
                np.atleast_1d(want[k]).view(np.uint8))]
            check(set(got) == set(want) and not bad,
                  f"leaves restored unmeshed differ from the mesh's: {bad}")
            print(f"19c: {name}'s placed state after one step ({nbytes} B, "
                  f"{len(want)} leaves) saved on the mesh in {save_s:.2f} s "
                  "and restored by the unmeshed trainer, bit for bit")
            out["checkpoint"] = {"bytes": nbytes, "leaves": len(want),
                                 "save_s": save_s}
            del back, like, plain_p, got, want
            torch.cuda.empty_cache()

            # (d) grad_compression on qwen2-0.5b's gradient tree
            gparams = T.init_params(cfg, torch.Generator(
                device="cuda").manual_seed(0))
            leaves, spec = tree_flatten(gparams)
            for p in leaves:
                p.requires_grad_(True)
            batch = TokenPipeline(DataConfig(
                vocab=cfg.vocab, seq_len=c["gc_seq"],
                global_batch=c["gc_batch"], seed=0),
                device="cuda").next_batch()
            loss, _ = T.loss_fn(gparams, cfg, batch)
            grads = list(torch.autograd.grad(loss, leaves))
            del gparams, leaves, loss
            err0 = GC.init_error(grads)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            q, s, new_err = GC.ef_compress(grads, err0)
            torch.cuda.synchronize()
            comp_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            deq = GC.ef_decompress_apply(q, s, grads)
            torch.cuda.synchronize()
            decomp_ms = (time.perf_counter() - t0) * 1e3
            before = sum(g.numel() * 4 for g in grads)
            after = sum(a.numel() * a.element_size() for a in q) + \
                sum(b.numel() * b.element_size() for b in s)
            worst = max(float((d - g.float()).abs().max())
                        for d, g in zip(deq, grads))
            # each entry within half a step of its block's scale; deq +
            # new error == g + error
            half = max(float(((d - g.float()).abs().reshape(-1)
                              .narrow(0, 0, g.numel()).max()))
                       / float(sc.max()) for d, g, sc in zip(deq, grads, s))
            ef = max(float(((d + e) - g.float()).abs().max())
                     for d, e, g in zip(deq, new_err, grads))
            check(all(a.dtype == torch.int8 for a in q) and half <= 0.5001
                  and ef <= 1e-5 * max(float(g.float().abs().max())
                                       for g in grads),
                  f"grad compression: int8 {[a.dtype for a in q][:2]}, "
                  f"half-step ratio {half}, error feedback gap {ef}")
            print(f"19d: qwen2-0.5b's gradient tree ({len(grads)} leaves): "
                  f"{before} B as float32 -> {after} B int8 + scales "
                  f"({before / after:.2f}x); largest error {worst} "
                  f"(<= {half:.4f} of a block's scale), deq + new error vs "
                  f"g: {ef}; compress {comp_ms:.2f} ms, decompress "
                  f"{decomp_ms:.2f} ms")
            out["grad_compression"] = {
                "leaves": len(grads), "bytes_f32": before,
                "bytes_int8": after, "max_abs_err": worst,
                "compress_ms": comp_ms, "decompress_ms": decomp_ms}
            del grads, err0, q, s, new_err, deq
        finally:
            ended = MESH.shutdown_distributed()
        check(ended and not dist.is_initialized(),
              "the process group did not end")
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 16: the paper's benchmark harness and the determinism smoke
# ---------------------------------------------------------------------------
# every row run_torch.py prints, by its name's prefix
HARNESS_ROWS = ("table1_", "table2_", "fig2_", "eq12_", "speed_", "kernel_",
                "occupancy_", "lm_scaling_fit", "lm_scaling_ratio_256_1024",
                "roofline_")
NCCL_LEAK = "destroy_process_group() was not called"


def _script(args, timeout_s: float) -> tuple:
    """``python -m args...`` from the checkout's root, its output
    captured: (rc, stdout, stderr, seconds)."""
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", *args], cwd=str(ROOT),
                       env=env, capture_output=True, text=True,
                       timeout=timeout_s)
    return p.returncode, p.stdout, p.stderr, time.perf_counter() - t0


def paper_harness(torch, report) -> None:
    """Phase 16: ``benchmarks/run_torch.py`` with every row on the card
    and ``benchmarks/determinism_smoke_torch.py`` at one NCCL rank, each
    in a process of its own; neither leaves its process group up."""
    out_dir = ROOT / "chiprun_out" / "bench_torch"
    out = report["harness"] = {}
    with phase("16. the paper's benchmark harness and the determinism "
               "smoke"):
        rc, so, se, secs = _script(
            ["benchmarks.run_torch", "--out", str(out_dir)], 600)
        rows = [ln for ln in so.splitlines() if ln.count(",") >= 2]
        print("\n".join(rows))
        check(rc == 0, f"run_torch.py exited {rc}:\n{se[-3000:]}")
        check(rows and rows[0] == "name,us_per_call,derived",
              "run_torch.py printed no CSV header")
        names = [r.split(",", 1)[0] for r in rows[1:]]
        missing = [p for p in HARNESS_ROWS
                   if not any(n.startswith(p) for n in names)]
        check(not missing, f"run_torch.py printed no {missing} rows")
        timed = [r.split(",", 2) for r in rows[1:]
                 if r.startswith(("speed_step", "kernel_"))]
        check(timed and all(float(us) > 0 for _, us, _ in timed),
              f"a timed row is not positive: {timed}")
        print(f"run_torch.py: {len(rows) - 1} rows in {secs:.1f} s")
        out["run_torch"] = {"rows": rows[1:], "seconds": secs}

        rc, so, se, secs = _script(
            ["benchmarks.determinism_smoke_torch", "--out", str(out_dir)],
            300)
        print(so.strip())
        check(rc == 0, f"determinism_smoke_torch.py exited {rc}:\n"
              f"{se[-3000:]}")
        payload = json.loads((out_dir / "BENCH_determinism_torch.json")
                             .read_text())
        check(payload["backend"] == "nccl" and all(
            payload["checks"].values()) and payload["checks"].get(
            "process_group_ended"), f"determinism smoke: {payload}")
        check(NCCL_LEAK not in so + se,
              "the determinism smoke left its NCCL group up")
        print(f"determinism smoke: Simulator vs one NCCL rank, "
              f"{payload['checks']} in {secs:.1f} s; no NCCL leak warning "
              "in its output")
        out["determinism"] = {**payload, "seconds": secs}


# ---------------------------------------------------------------------------
# phase 20: the dry run and the LM scaling law
# ---------------------------------------------------------------------------
def _dry_cell(name: str):
    """(config, ShapeConfig) of a trace named arch:kind:seq:batch."""
    from repro_torch.configs import ShapeConfig, get_config
    arch, kind, seq, batch = name.split(":")
    return get_config(arch), ShapeConfig(name, int(seq), int(batch), kind)


def dryrun_traces(argv) -> int:
    """``chip_smoke.py --dryrun-traces DEVICE WORLD OUT NAME...``: each
    named cell traced by the dry run (``launch/dryrun.py``) on fake
    tensors of DEVICE, as rank 0 of a fake group of WORLD ranks (1: a 1 x
    1 mesh; 256: the production 16 x 16 mesh); {name: record or error}
    written to OUT as JSON."""
    device, world, out, names = argv[0], int(argv[1]), argv[2], argv[3:]
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as MESH
    res = {}
    with D.fake_group(world):
        mesh = (MESH.make_mesh((1, 1), ("data", "model"), device=device)
                if world == 1 else
                MESH.make_production_mesh(device=device))
        for name in names:
            try:
                res[name] = D.trace_cell(*_dry_cell(name), mesh)
            except Exception as e:  # noqa: BLE001 - the phase fails on it
                res[name] = {"error": f"{type(e).__name__}: {e}"}
            Path(out).write_text(json.dumps(res))
    return 0


class _Traces:
    """The dry-run trace processes phase 20 reads: started after phase 1,
    they run on the host while the card runs the phases before 20."""

    def __init__(self):
        import tempfile
        self.dir = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
        self.procs = {}

    def start(self, key: str, device: str, world: int, names) -> None:
        out = self.dir / f"{key}.json"
        log = open(self.dir / f"{key}.log", "w")
        self.procs[key] = (subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--dryrun-traces",
             device, str(world), str(out), *names], cwd=str(ROOT),
            stdout=log, stderr=subprocess.STDOUT), out, log, time.time())

    def result(self, key: str, timeout_s: float) -> dict:
        p, out, log, t0 = self.procs[key]
        try:
            rc = p.wait(timeout=max(1.0, timeout_s - (time.time() - t0)))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            raise SmokeFailure(f"the {key} traces did not end in "
                               f"{timeout_s} s")
        log.close()
        text = (self.dir / f"{key}.log").read_text()
        check(rc == 0 and out.exists(),
              f"the {key} traces exited {rc}:\n{text[-3000:]}")
        res = json.loads(out.read_text())
        errors = {k: v["error"] for k, v in res.items() if "error" in v}
        check(not errors, f"the {key} traces failed: {errors}")
        return {**res, "wall_s": time.time() - t0}

    def stop(self) -> None:
        import shutil
        for p, _, log, _ in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        shutil.rmtree(self.dir, ignore_errors=True)


def start_dryrun_traces() -> _Traces:
    """Phase 20's traces: (b) on a fake group of one rank, fake cuda
    tensors; (c) on a fake group of 256, fake cuda and fake CPU tensors,
    in three processes."""
    tr = _Traces()
    tr.start("one_rank", "cuda", 1, DRYRUN["one_rank"])
    tr.start("production_cuda", "cuda", 256, DRYRUN["production"])
    tr.start("production_cpu", "cpu", 256, DRYRUN["production"])
    return tr


def _step_counts(torch, run, inputs) -> dict:
    """One call of ``run`` (a training or decode step on the card, over
    the tensors of ``inputs``): its peak device memory after a reset, the
    bytes live before it and the inputs' own bytes, and its FLOPs counted
    by ``FlopCounterMode`` on a second call.  ``step_peak_bytes`` is the
    peak less what was live beside the inputs (earlier phases' tensors,
    the libraries' workspaces): the step's own, which the dry run traces."""
    from torch.utils._pytree import tree_leaves
    from torch.utils.flop_counter import FlopCounterMode
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in tree_leaves(inputs)
                if isinstance(t, torch.Tensor) and t.is_cuda}
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del out
    with FlopCounterMode(display=False) as fc:
        out = run()
        torch.cuda.synchronize()
    del out
    own = sum(storages.values())
    return {"flops": int(fc.get_total_flops()), "peak_bytes": peak,
            "live_bytes": live, "input_bytes": own,
            "step_peak_bytes": peak - (live - own)}


def _bound_ms(rec: dict) -> tuple:
    """The roofline's least time of a traced step on one card, in ms, and
    what bounds it (no collective term: one rank)."""
    t_ops = rec["flops"] / BF16_FLOPS * 1e3
    t_bytes = rec["bytes"] / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def dryrun_and_scaling(torch, report, traces) -> None:
    """Phase 20."""
    from repro_torch import random as RND
    from repro_torch.core import scaling as SC
    out = report["dryrun"] = {"torch": torch.__version__,
                              "card": report["nvidia_smi"]}
    with phase("20. the dry run and the LM scaling law on the card"):
        print(f"card: {report['nvidia_smi']}; torch {torch.__version__}")
        # (a) the probe, on the card and on the CPU
        fanins = DRYRUN["fanins"]
        key = RND.PRNGKey(0)
        scales, secs, pols = {}, {}, {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            scales[dev] = [SC.probe_scale_for_fanin(
                RND.fold_in(key, i), f, device=dev)
                for i, f in enumerate(fanins)]
            pols[dev] = SC.probe_and_fit(key, fanins=fanins, device=dev)
            secs[dev] = time.perf_counter() - t0
        pol = pols["cuda"]
        ratio = pol.scale(256) / pol.scale(1024)
        print(f"20a: probe_and_fit at fan-ins {fanins}: scales "
              f"{scales['cuda']} on the card, {scales['cpu']} on the CPU; "
              f"{pol}; scale(256)/scale(1024) = {ratio:.4f} (ideal 2.0); "
              f"probes and fit {secs['cuda']:.2f} s on the card, "
              f"{secs['cpu']:.2f} s on the CPU")
        check(scales["cuda"] == scales["cpu"],
              f"the card's scales {scales['cuda']} differ from the CPU's "
              f"{scales['cpu']}")
        check((pol.k1, pol.k2, pol.k3) == (pols["cpu"].k1, pols["cpu"].k2,
                                           pols["cpu"].k3),
              f"the fits differ: {pol} vs {pols['cpu']}")
        out["scaling"] = {"fanins": list(fanins), "scales": scales["cuda"],
                          "policy": [pol.k1, float(pol.k2), pol.k3],
                          "ratio_256_1024": ratio, "seconds": secs}

        # (b) the dry run of phases 8a's and 7's steps against the real ones
        one = traces.result("one_rank", DRYRUN["timeout_s"])
        real = {DRYRUN["one_rank"][0]: (
                    report["train_qwen2-0.5b"]["counts"],
                    report["train_qwen2-0.5b"]["ms_per_step"]),
                DRYRUN["one_rank"][1]: (
                    report["serve"]["decode_counts"],
                    report["serve"]["decode_ms_per_step"])}
        out["steps"] = {}
        for name, (counts, ms) in real.items():
            rec = one[name]
            bound, by = _bound_ms(rec)
            gap = rec["peak_bytes"] / counts["step_peak_bytes"] - 1
            row = {"dry_flops": rec["flops"], "real_flops": counts["flops"],
                   "dry_peak_bytes": rec["peak_bytes"], **{
                       f"real_{k}": v for k, v in counts.items()
                       if k != "flops"},
                   "peak_gap": gap, "dry_bytes": rec["bytes"],
                   "bound_ms": bound, "bound_by": by, "ms": ms,
                   "fraction": bound / ms, "trace_s": rec["trace_s"]}
            out["steps"][name] = row
            print(f"20b: {name}: FLOPs dry run {rec['flops']} vs the real "
                  f"step {counts['flops']}; peak {rec['peak_bytes']} vs the "
                  f"step's {counts['step_peak_bytes']} ({100 * gap:+.2f}%: "
                  f"max_memory_allocated {counts['peak_bytes']} less the "
                  f"{counts['live_bytes'] - counts['input_bytes']} B live "
                  f"beside its {counts['input_bytes']} B of inputs); "
                  f"bound {bound:.3f} ms by {by} vs {ms:.3f} ms/step "
                  f"measured ({100 * bound / ms:.1f}%); traced in "
                  f"{rec['trace_s']:.2f} s")
            check(rec["flops"] == counts["flops"],
                  f"{name}: the dry run counts {rec['flops']} FLOPs, the "
                  f"real step {counts['flops']}")
            check(abs(gap) <= DRYRUN["peak_rtol"],
                  f"{name}: the dry run's peak is {100 * gap:+.1f}% off "
                  "the card's")

        # (c) production cells: fake cuda against fake CPU
        cuda = traces.result("production_cuda", DRYRUN["timeout_s"])
        cpu = traces.result("production_cpu", DRYRUN["timeout_s"])
        out["production"] = {}
        for name in DRYRUN["production"]:
            a, b = cuda[name], cpu[name]
            keys = ("flops", "bytes", "peak_bytes", "collectives")
            print(f"20c: {name} on a fake group of 256: FLOPs {a['flops']}"
                  f", bytes {a['bytes']}, collective bytes "
                  f"{a['collectives']['total_bytes']} "
                  f"({a['collectives']['counts']}), peak {a['peak_bytes']} "
                  f"(fits 80 GB: {a['fits']}); traced in {a['trace_s']:.1f}"
                  f" s on fake cuda, {b['trace_s']:.1f} s on fake CPU")
            check(all(a[k] == b[k] for k in keys),
                  f"{name}: fake cuda {[a[k] for k in keys]} vs fake CPU "
                  f"{[b[k] for k in keys]}")
            out["production"][name] = {"cuda": a, "cpu": b}
        out["trace_wall_s"] = {k: r["wall_s"] for k, r in
                               (("one_rank", one), ("production_cuda", cuda),
                                ("production_cpu", cpu))}


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dryrun-traces"]:
        sys.exit(dryrun_traces(sys.argv[2:]))
    sys.exit(main())
