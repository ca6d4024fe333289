#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. device   require a CUDA device; print nvidia-smi's name and power
              limit
  2. build    compile every CUDA kernel from ``src/repro_torch/csrc`` with
              nvcc (one process per source, all at once)
  3. kernels  each kernel against its plain PyTorch version on the card,
              on the main paths' shapes and their edge cases (lut_sigmoid
              also on inputs 4-12 bytes past an alignment with ragged
              ends, under an odd table): they must
              be equal (flash_attention: within MHA_F32_ATOL /
              MHA_BF16_ATOL: float32 in another order; bf16 rounds P to
              bf16 for the tensor cores)
  4. main     the paper's training at full width (16 features) over 2048
              simulated PIM cores, through the public API, one path at a
              time with the kernel launch counts zeroed just before it
              and checked exactly just after it:
              - LIN int32/hyb/fp32 and LOG int32_lut_wram/int32_lut_mram
                at 6,291,456 samples; the same fits on the CPU must give
                bit-identical integer weights, fp32 weights within
                FP32_RTOL/FP32_ATOL, and equal TransferStats
              - KME int16 and fp32 at 25,600,000 samples, k=16, 10
                iterations; then whether the int32 reduce of the cluster
                sums across the cores left the int32 range (the same
                reduce in int64 beside it, on the card)
              - DTR at max_depth 10 on the largest of 153.6M / 76.8M /
                38.4M samples whose generation fits half the host's
                available memory
              - KME (100,000) and DTR (600,000) at the paper's quality
                sizes on the card and on the CPU: identical int16
                centroids, labels and iteration counts, fp32 centroids
                within KME_FP32_RTOL/KME_FP32_ATOL, identical trees, equal
                TransferStats
              - EMB at the Netflix Prize matrix's size (480,189 users x
                17,770 items, 100,480,507 ratings, cut when the host cannot
                generate them), dim 16, batch 64, 200 steps: int32 eager,
                int32 deferred D=8, int32 D=8 with compressed flushes and
                fp32 eager, each timed per step; then 20,000 ratings on 1
                and 16 cores under every reduce strategy on the card and
                on the CPU: identical int32 tables, history and
                TransferStats, fp32 tables within EMB_FP32_RTOL/ATOL
              - qwen3-8b served at full width and depth (36 layers, bf16,
                quantize_dense on, seeded random weights) through Model
                and ServeEngine: 8 requests over 4 slots, prompt lengths
                drawn from 128-1024, LM_NEW new tokens each; launch counts
                exactly 3 int_matmul per layer per forward call and 1
                flash_attention per layer per prefill; the same load with
                quantize_dense off; the busy share over decode steps;
                prefill + decode against the forward's last position;
                then the reduced model in float32 on the card and the CPU
  5. timing   each kernel and its plain version with CUDA events (median
              of TIMING_RUNS, each run after L2Flush: a flush that reads
              a 256 MB buffer, then a device sleep that covers the host's
              enqueue; the method's floor, a one-element add_, first)
              beside its bound (lut_sigmoid in both placements, with
              their shares of it, also on the z a LOG fit hands it at its
              first and last iteration)
              and, for the EMB and LM kernels, the nearest PyTorch call
              (int_matmul at M = 1 and at the shortest and longest
              prompts, with the rate reached, its share of the bound and
              the host's time per wrapper call; flash_attention likewise);
              each fit's milliseconds per iteration (per round for DTR,
              per step for EMB) and samples/s; the serve runs' time to
              first token, ms per decode token and tokens/s
  6. fused    step fusion, each chunk one CUDA graph replay, on the
              datasets resident since phases 4-5, each fit with the
              launch counts zeroed just before it: LIN int32/hyb and LOG
              int32_lut_wram/int32_lut_mram at fuse_steps 5 and 10,
              pipeline depth 1 and 2 (weights bit-identical to the
              serial card fit, its launch counts, a replay a chunk); KME
              int16 at fuse_steps 5 (10 kmeans_assign launches, within
              the reference's fused-against-serial tolerances; card ==
              CPU at 100,000 samples); EMB int32 D=8 at fuse_steps 8
              (run at the end of its phase-4 fits: tables and history
              bit-identical to the serial deferred fit, 400 emb_gather
              launches through replays); fused against serial times,
              capture times, graph pool bytes and the card's busy share
              over a fused KME and EMB fit
  7. compare  the paper's three-way compare (launch/compare.py) on the
              card at its CLI defaults (16 features, 16 cores): LIN, LOG,
              DTR, KME and EMB each on pim (DPU seconds modeled), host
              (fp32 on the card, measured) and gpu-model (the host's
              numerics, seconds modeled for an A100), 15 rows, with the
              launch counts zeroed just before it: every host row's score
              equal to its gpu-model row's, every modeled time above 0,
              the six PIM-ML kernels launched; then the tiny compare over
              4 cores on the card and on the CPU: equal integer pim
              scores, iterations, transfer bytes and modeled seconds, and
              equal gpu-model launches, flops and bytes
  8. orchestration  fx_matvec with lane weights [K, F] against its plain
              version (K = 1, 2, 3, 8, 13) and timed; the 8-point LIN
              int32 learning-rate sweep (GANG_LIN_LRS) as one
              FusedGdSweep against its 8 serial fits (every lane
              bit-identical, 10 fx_matvec launches against 80), the LOG
              gang with a lane cancelled, the LIN gang at fuse_steps 5
              and traced (a valid Chrome trace); two 1,024-core slices
              each equal to a standalone system; LIN and KME int16
              resumed from disk snapshots equal to the uninterrupted fits
  9. service  the training service at the LIN/LOG, KME and DTR cells'
              full width over N_CORES cores in 64-core ranks: one
              PimScheduler (deadline policy, preemptive) drains LIN
              int32, LOG int32_lut_wram, KME int16, DTR and the fused
              8-lane LIN gang, and a priority LIN job at fuse_steps 5
              that evicts one at a chunk boundary, with the launch counts
              zeroed just before it: every job DONE without an error and
              bit-identical to its standalone card fit, the counts exact,
              the parent's TransferStats the jobs' sum, device memory back
              within SERVICE_MEMORY_SLACK; per-job queue and completion
              latency, measured and modeled seconds and drift, the
              scheduler's host time a turn and the card's busy share;
              then serve mode with 4 jobs submitted while the loop runs
              (a chunk graph captured on the serve thread); then
              ``python -m repro_torch.launch.pim_jobs`` on
              examples/jobs.yaml as JSON and again with --resume, which
              restores every job without a launch
 10. train    LM training at full width: granite-3-8b (launch/train.py's
              default arch; d_model 4096, 32 query heads over 8 KV heads
              padded to 16, d_ff 12800), 8 of its 40 layers, bf16, remat
              full, MarkovCorpus batches of 8 x 1024 tokens, AdamW lr 3e-4,
              through repro_torch.launch.train.train:
              (a) flash_attention_bwd against its plain version at
                  [8, 32, 1024, 128] over 16 and 8 KV heads, a window, and
                  float32 (TRAIN_BWD_*_RTOL of max |plain|), two calls
                  at the first shape bitwise equal; (b) the
                  forward with lse kept returns the same out, lse within
                  TRAIN_LSE_ATOL of the plain logsumexp; (c) step 1's loss
                  and every gradient leaf against the same step with plain
                  attention under autograd (TRAIN_LOSS_ATOL,
                  TRAIN_GRAD_RTOL), every wq/wk/wv/wo gradient nonzero;
                  (d) 5 steps, losses finite and falling; (e) with the
                  counts zeroed just before: exactly 16 mha (forward and
                  remat recompute) and 8 mha_bwd a step; (f) 2 steps with
                  quantize_dense and lut_activations: 48 int_matmul a step,
                  every gate gradient exactly 0; (g) reduced granite
                  resumed at step 2 on the card: steps 3-4 and the params
                  equal the uninterrupted run's.  Printed: ms a step,
                  forward + backward against AdamW, tokens/s, peak memory,
                  a profiled step's busy share, top kernels and the
                  backward kernels' share; flash_attention_bwd's ms
                  (route wgmma bf16), bound, share of it, TFLOP/s, plain
                  ms and SDPA's forward + backward; flash_attention's
                  forward with lse at that shape beside SDPA's forward;
                  int_matmul at M = 8192
 11. families the decoder-only LM families at full width, bf16, seeded
              random weights, through Model and ServeEngine, each with the
              launch counts zeroed just before and checked exactly after.
              First int_matmul (exact) and flash_attention (bf16 and
              float32, windowed and not) against their plain versions at
              the shapes this phase gives them;
              (a) qwen2-moe-a2.7b (24 layers, 60 experts padded to 64,
                  top-4, a 5632-wide shared expert): LM_REQUESTS requests
                  over LM_SLOTS slots, FAM_NEW new tokens each, with
                  quantize_dense on (3 int_matmul
                  per layer per forward call, the shared expert's; 1 mha
                  per layer per prefill), then off; tokens/s, time to first
                  token, peak memory, a decode profile's busy share;
              (b) hymba-1.5b (32 layers, 29 of them sliding a 1024-token
                  window, 128 meta tokens) the same way, every layer's
                  prefill attention in flash_attention; then prefill +
                  decode against the forward in float32;
              (c) xlstm-350m on prompts of 64-token multiples (the
                  reference's chunk contract), no kernel launched; prefill
                  + 64 decode steps against the forward in float32;
              (d) dbrx-132b at full width, FAM_DBRX_LAYERS of 40 layers:
                  a 512-token prompt over its 16 routing groups, 8 decode
                  steps, logits finite, counts exact;
              (e) each family reduced to float32, card against CPU: forward
                  logits, greedy tokens, one value_and_grad and one AdamW
                  step (FAM_LOSS_ATOL, FAM_GRAD_RTOL), hymba's windowed
                  layer through mha and mha_bwd;
              (f) qwen2-moe-a2.7b in float32 at full width with dropless
                  capacity, as deep as float32 fits: prefill + decode
                  against the forward
 12. vlm/audio the VLM and audio families at full width, bf16, seeded
              random weights, served as the reference's API runs them
              (Model.prefill with the request's vision states or frames,
              then batch-1 Model.decode_step calls; ServeEngine prefills
              tokens alone), each run with the launch counts zeroed just
              before and checked exactly after.  First int_matmul (exact)
              at whisper's and the VLM's MLP shapes, flash_attention
              non-causal against 1601 and 1500 keys (Sq 1, 64, 300; D 128
              and 64; bf16 and float32; bf16 v drawn around X_V_MEAN so
              that a wrong normaliser shows; the lse within
              TRAIN_LSE_ATOL) and at the phase's other shapes,
              and flash_attention_bwd at whisper's training shapes,
              against their plain versions; flash_attention timed at the
              cross-attention shapes beside its bound and SDPA;
              (a) llama-3.2-vision-11b (40 layers, 8 gated cross-attention
                  over 1601 vision states [1, 1601, 4096] a request), every
                  gate set to X_GATE (init's 0 shuts the vision path; the
                  logits must move): X_REQUESTS requests of 64-512 tokens,
                  FAM_NEW new tokens each, quantize_dense off then on;
                  time to first token, ms a decode token, tokens/s, peak
                  memory, a decode profile's busy share;
              (b) whisper-tiny (4 encoder and 4 decoder layers over 1500
                  frames) the same way, 4-token decoder prompts;
              (c) both reduced to float32, gates open, card against CPU:
                  forward logits, prefill + 3 decode steps against the
                  forward, one value_and_grad (loss and every gradient
                  leaf, mha and mha_bwd counted) and one launch/train.py
                  step;
              (d) whisper-tiny trained at full width through
                  launch/train.py, B = 4, 448 decoder tokens: step 1
                  against plain attention under autograd (TRAIN_LOSS_ATOL,
                  TRAIN_GRAD_RTOL), then 2 steps with the counts exact
 13. data-parallel  make_dp_train_step over torch.distributed ranks that
              share the card (gloo: NCCL refuses two ranks on one device;
              spawn_ranks, a file rendezvous), each rank with its launch
              counts zeroed just before its run.  It runs right after
              the build, while this process holds nothing on the card:
              two replicas and their compressed step fill most of it:
              (a) two ranks train granite-3-8b at full width, DP_LAYERS of
                  40 layers, bf16, remat full, on MarkovCorpus batches of
                  8 x 1024 tokens (4 rows a rank), AdamW lr 3e-4:
                  DP_STEPS steps with the exact all-reduce, then
                  DP_STEPS with the int8 error-feedback one.  Step 1 of
                  the exact run against a one-process make_train_step on
                  the same global batch (loss within TRAIN_LOSS_ATOL, each
                  leaf's update within DP_STEP_RTOL of that step's); the
                  compressed run's last loss below its first and within
                  DP_EF_LOSS_GAP of the exact run's; both ranks'
                  parameters bit-identical after every step (checksums of
                  every leaf's bits); exactly 2 flash_attention and 1
                  flash_attention_bwd a layer a step on each rank.
                  Printed: ms a step and tokens/s over both ranks, the
                  reduction's ms, the payload bytes handed to collectives
                  and copied through host memory against
                  compressed_bytes_saved's model, peak memory per rank;
              (b) four ranks, reduced granite-3-8b in float32: DP_SMALL
                  steps on a (2, 2) ("pod", "data") mesh (the hierarchical
                  reduction) within DP_POD_RTOL of the flat (4,) run;
              (c) the GPipe pipeline over 4 ranks at tests/test_pipeline.py's
                  size (8 tanh layers of 32, 6 microbatches): the forward
                  within PIPE_FWD_ATOL and each stage's gradients within
                  PIPE_GRAD_RTOL of the sequential run on the card;
              (d) compress_decompress_psum and ef_compress_psum on CUDA
                  tensors bit-identical to the same ranks on CPU tensors
 14. PIM-ML over ranks  the PIM system with backend="shard_map": its
              cores spread over PIM_RANKS ranks that share the card
              (gloo), 1024 of the 2048 a rank, at phases 4-5's sizes and
              on their data (generated once by this process after phase
              13, written under build/phase14 and memory-mapped by every
              rank; removed after): LIN int32 under fabric, host and
              hierarchical, LOG int32_lut_wram, KME int16, DTR and EMB
              int32 D=8 under fabric, each with the rank's launch counts
              zeroed just before it and checked exactly after; the model
              state equal on both ranks after every step (every flush
              for EMB, whose tables each rank holds a block of); each
              result bit-identical to this process's one-process card fit
              of phases 4-5 (the KME inertia, a float32 sum in another
              order, within KME_INERTIA_RTOL); kernels 1-6 against their
              plain versions at the rank-local shapes; each fit timed
              again (ms/iteration beside phase 5's) and a third time
              with every collective synchronised and timed (the cross-
              rank reduce's ms and share) with collectives.traffic; then
              PIM_SMALL_RANKS ranks over PIM_SMALL_CORES cores, whose
              hierarchical groups of 8 straddle ranks, against the same
              fits in this process, bit for bit

 15. tensor-parallel  the dense LM on sharded parameters: TP_RANKS ranks
              share the card (gloo) on a ("data"=1, "model"=2) mesh, the
              weights placed by the reference's param_shardings
              (Model.place), each rank's launch counts zeroed just before
              each run.  It runs first, right after the build:
              (a) qwen3-8b at full width and depth (36 layers, bf16,
                  ~8.2 GB of weights a rank): 2 prompts of 512 tokens
                  prefilled, then TP_NEW greedy decode tokens, quantize_dense on
                  and off; the logits against one process on the same
                  weights fed the same tokens and, quantize_dense on, the
                  ranks' int8 activations (TP_BF16_TOL), the greedy tokens
                  equal wherever that run's top-2 margin exceeds it; every
                  quantized linear's int8 activations equal to one-process
                  quantization of its gathered input, the first
                  TP_INT8_CALLS int32 products equal to int_matmul_cuda on
                  the gathered operands; the int8 elements that differ
                  from a one-process run quantizing its own activations
                  counted a forward call, beside that run's logit gap;
                  ms a prefill and a decode token against one process (a
                  run of its own), and the collectives' share of a decode
                  run (every redistribution synchronised and timed);
              (b) one granite-3-8b train step at full width,
                  TP_TRAIN_LAYERS of 40 layers, 8 x 1024 tokens: loss and
                  grad norm against one process (TRAIN_LOSS_ATOL,
                  TRAIN_GRAD_RTOL);
              (c) its params saved from both ranks, restored into one
                  process bit for bit (each rank's shard of a leaf against
                  the same cut of the restored leaf, by digest), one more
                  step;
              (d) mha, mha_bwd and int_matmul launch on each rank exactly
                  as in the one-process runs, on the rank's heads and
                  weight shards, and each launch in (a) and (b) equals its
                  plain version on the rank's operands (int_matmul
                  exactly, mha within MHA_BF16_ATOL, mha_bwd within
                  TRAIN_BWD_BF16_RTOL of max |plain|): the prefill
                  (tensor-core) and decode (dp4a stream) int_matmul on
                  [4096, 6144] / [6144, 4096] shards, mha on 16 of 32
                  heads, mha_bwd at [8, 16, 1024, 128];
              (e) the dry-run (python -m repro_torch.launch.dryrun, two
                  processes of their own, each with a fake group of 256 /
                  512 ranks, fake CUDA tensors) of qwen3-8b's train_4k,
                  prefill_32k and decode_32k on both production meshes,
                  beside the data's set-up before phase 14 (no timed
                  phase runs beside it); their roofline rows printed (a
                  model of H100s); its parameter bytes a rank on (1, 2)
                  equal to what each rank of (a) holds
 16. MoE over ranks  the MoE family on sharded parameters, right after
              phase 15: each rank's launch counts zeroed just before each
              run, every launch on a rank held against its plain version
              on the rank's operands (KernelChecks), the weights drawn a
              layer at a time and placed (Model.init_placed):
              (a) qwen2-moe-a2.7b at full width and depth (24 layers,
                  bf16, 64 experts of which 60 real, 32 a rank: expert
                  parallel over "model"; the shared expert tensor
                  parallel) on MOE_RANKS ranks, a (data 1, model 2) mesh:
                  2 prompts of 512 tokens, MOE_NEW greedy decode tokens,
                  quantize_dense on and off; logits against one process
                  on the same weights fed the same tokens and the ranks'
                  routing (a top-k flip between the runs' bf16 streams
                  moves which tokens a full expert drops; on: also the
                  ranks' int8 activations) within TP_BF16_TOL, greedy
                  tokens equal where that run's top-2 margin exceeds it,
                  the gap of one process routing its own printed;
                  every quantized linear's int8 activations equal to the
                  one-process quantization of its gathered input, the
                  first TP_INT8_CALLS int32 products to int_matmul_cuda on
                  the gathered operands; launches a rank = one process's;
                  each rank multiplying its own 32 experts; ms a prefill
                  and a decode token against one process, the collectives'
                  share of a decode run (every one synchronised and
                  timed), the expert weight bytes a rank reads a decode
                  token against one process's;
              (b) one AdamW step at MOE_TRAIN_LAYERS of 24 layers on
                  MOE_TRAIN_BATCH x MOE_TRAIN_SEQ tokens: loss and grad
                  norm against one process (TRAIN_LOSS_ATOL,
                  TRAIN_GRAD_RTOL), launches equal; the ranks' state saved
                  and restored into one process bit for bit;
              (c) dbrx-132b at full width, DBRX_LAYERS of 40 layers, with
                  FSDP (param_shardings_fsdp: each weight's widest free
                  dim over "data", gathered a layer at a time through host
                  memory) on a DBRX_MESH (data 2, model 2) mesh: 2 prompts
                  of 512 tokens (8 of the 16 routing groups a data rank),
                  DBRX_NEW decode steps (one group over both data ranks);
                  logits against one process fed the ranks' routing within
                  TP_BF16_TOL (its own routing's gap printed); at each
                  decode step the expert ids and kept (token, slot) pairs
                  equal to one process's fed the ranks' router inputs;
                  launches equal; the FSDP gathers' bytes;
              (d) the dry-run of qwen2-moe-a2.7b's decode_32k on both
                  production meshes and on (1, 2), with phase 15 (e); its
                  parameter bytes a rank on (1, 2) equal to (a)'s ranks'
 17. recurrent over ranks  the ssm and hybrid families on sharded
              parameters, right after phase 16: SSM_RANKS ranks share the
              card (gloo) on a (data 1, model 2) mesh, the weights drawn a
              layer at a time and placed (Model.init_placed), each rank's
              launch counts zeroed just before each run and every launch
              on a rank held against its plain version on the rank's
              operands (KernelChecks):
              (a) hymba-1.5b at full width and depth (32 layers, bf16,
                  ~1.9 GB of weights a rank; the SSM's channels, 16 of 32
                  query and 8 of 16 KV heads a rank): phase 15's 2 prompts
                  of 512 tokens (640 with the meta tokens), SSM_NEW greedy
                  decode tokens, quantize_dense on and off; logits within
                  TP_BF16_TOL of one process on the same weights fed the
                  same tokens (on: and the ranks' int8 activations),
                  greedy tokens equal where that run's top-2 margin
                  exceeds it; every quantized linear's int8 activations
                  equal to the one-process quantization of its gathered
                  input; launches a rank = one process's (1 mha a layer a
                  prefill, 3 int_matmul a layer a forward call with
                  quantize_dense on); ms a prefill and a decode token
                  (the checked runs') against one process, the
                  collectives' ms and share of a quantize-off serve run
                  (every one synchronised and timed);
              (b) xlstm-350m at full width and depth (21 mLSTM and 3 sLSTM
                  layers) the same way, quantize_dense off (no dense MLP
                  to quantize), no kernel launched;
              (c) one AdamW step of each at SSM_TRAIN_LAYERS (hymba 4 of
                  32 layers, xlstm its first 7 + 1 unit of 24: the
                  script's time limit) on SSM_TRAIN_BATCH x SSM_TRAIN_SEQ
                  tokens: loss and grad norm against one process
                  (TRAIN_LOSS_ATOL, TRAIN_GRAD_RTOL), launches equal; the
                  ranks' state restored into one process bit for bit;
              (d) the dry-run of xlstm-350m's long_500k and hymba-1.5b's
                  decode_32k on both production meshes and on (1, 2), with
                  phase 15 (e); their parameter bytes a rank on (1, 2)
                  equal to (a)'s and (b)'s ranks'
 18. VLM and audio over ranks  the vlm and audio families on sharded
              parameters, on phase 17's ranks after its runs (one
              spawn): X_RANKS ranks share the card (gloo) on a (data 1,
              model 2) mesh, the weights drawn a
              layer at a time and placed (Model.init_placed; whisper whole,
              then placed), every cross block's gates at X_GATE, each
              rank's launch counts zeroed just before each run and every
              launch on a rank held against its plain version on the
              rank's operands (KernelChecks):
              (a) llama-3.2-vision-11b at full width, X_VLM_LAYERS of 40
                  layers (two units: layers 4 and 9 gated cross blocks),
                  vision states [2, 1601, 4096] bf16: phase 15's 2 prompts
                  of 512 tokens, X_NEW greedy decode tokens, quantize_dense
                  on and off; logits within TP_BF16_TOL of one process on
                  the same weights fed the same tokens (on: and the ranks'
                  int8 activations), greedy tokens equal where that run's
                  top-2 margin exceeds it; every quantized linear's int8
                  activations equal to the one-process quantization of its
                  gathered input; launches a rank = one process's (mha on
                  16 of 32 query heads a layer a prefill and a cross block
                  a decode step, int_matmul on [4096, 7168] / [7168, 4096]
                  shards); the collectives of one prefill and one decode
                  call counted (OpTrace): all-reduces only, 2 a layer and 1
                  for the vocab-split lookup; ms a prefill and a decode
                  token against one process, the collectives' ms and share
                  of a quantize-off serve run (every one synchronised and
                  timed);
              (b) whisper-tiny at full width and depth (4 + 4 layers, 8 of
                  16 padded heads a rank, 1500 frames [2, 1500, 384] bf16)
                  the same way, 2 prompts of X_AUDIO_PROMPT_LEN tokens; 2
                  all-reduces an encoder layer, 3 a decoder layer, 1 for
                  the lookup;
              (c) one AdamW step of whisper-tiny at full depth on
                  X_TP_TRAIN_BATCH x X_TRAIN_SEQ tokens and of the VLM at
                  X_VLM_TRAIN_LAYERS (one unit) on X_TP_TRAIN_BATCH x
                  X_VLM_TRAIN_SEQ tokens with its vision states: loss and
                  grad norm against one process (TRAIN_LOSS_ATOL,
                  TRAIN_GRAD_RTOL), launches equal; the ranks' state
                  restored into one process, each rank's shards equal bit
                  for bit to the same cuts of the restored leaves (no
                  gather);
              (d) the dry-run of both archs' decode_32k on both production
                  meshes and on (1, 2), with phase 15 (e); their parameter
                  bytes a rank on (1, 2) equal to (b)'s ranks' (whisper)
                  and to the 40-layer model's bytes a rank derived from
                  (a)'s shards (the VLM: the top-level leaves and 4 times
                  a unit's layers)
 19. examples  the eight walkthroughs of repro_torch.examples (the
              reference's examples/*.py), each main run in this process
              on the default device at the reference's sizes, with the
              launch counts zeroed just before it and held exactly after
              it to EX_COUNTS (worked out from each example):
              quickstart, pim_ml_sklearn, compare_systems, emb_recsys,
              job_queue and elastic_jobs, their stdout against the
              reference's (expected/<name>.txt, outputs.compare: every
              number exact but where a rule of outputs.RULES says
              otherwise); serve_lm: 8 requests done,
              240 tokens, one flash_attention a layer a prefill (the
              reduced qwen3-8b is float32: the CUDA-core kernel);
              train_lm at EX_TRAIN_STEPS steps (100 of its 300: the
              phase's time) with its checkpoint under build/phase19
              (removed after): its loss falls,
              flash_attention and flash_attention_bwd once a layer a
              microbatch a step; seconds of each, and the median of the
              train loop's own step times after the first (no checkpoint
              in them) beside 6 x parameters x tokens at the float32 peak.
              Together they launch every kernel but int_matmul (both LM
              examples keep quantize_dense off, as the reference's do)

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Nothing of JAX or the JAX package is
imported.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

SEED = 0
N_CORES = 2048
N_SAMPLES = 6_291_456          # the paper's strong-scaling LIN/LOG dataset
N_FEATURES = 16
ITERS = 10
TIMING_RUNS = 20
#: the device sleep after a reading L2 flush: ~0.5 ms at the H100's boost
#: clock (1.98 GHz), longer than the host takes to enqueue a kernel
#: wrapper (29-83 us per call, PR 15)
FLUSH_SLEEP_CYCLES = 1_000_000
#: fp32 CPU-vs-card tolerance: cuBLAS and ATen's CPU kernels sum the
#: per-core products and the gradient rows in different orders
FP32_RTOL, FP32_ATOL = 1e-4, 1e-6
KME_SAMPLES = 25_600_000       # the paper's strong-scaling KME dataset
KME_QUALITY = 100_000          # ... and its quality dataset
KME_K = 16
#: KME fp32 CPU-vs-card tolerance on the centroids (blob coordinates are
#: ~10): the float32 distance and one-hot sum matmuls run in other orders
KME_FP32_RTOL, KME_FP32_ATOL = 1e-4, 1e-3
#: the paper's strong-scaling DTR dataset, then the cuts taken when the
#: host cannot generate it: make_classification peaks at ~450 B of host
#: memory per sample (float64 intermediates)
DTR_SIZES = (153_600_000, 76_800_000, 38_400_000)
DTR_HOST_BYTES_PER_SAMPLE = 450
DTR_QUALITY = 600_000
DTR_DEPTH = 10
#: the DTR main rows timed again over this many cores (the launcher's
#: default), fewer than the H100's 132 SMs: gini_counts then splits a
#: core's rows over blocks that add into its partial
FEW_CORES = 16
#: the Netflix Prize matrix (Bennett & Lanning, KDD Cup 2007): users and
#: items; then its 100,480,507 ratings and the cuts taken when the host
#: cannot generate them: make_recsys peaks at ~250 B of host memory per
#: rating at dim 16 (the gathered user and item rows and their product)
EMB_USERS, EMB_ITEMS = 480_189, 17_770
EMB_SIZES = (100_480_507, 50_240_254, 25_120_127)
EMB_HOST_BYTES_PER_SAMPLE = 250
EMB_DIM, EMB_BATCH, EMB_ITERS, EMB_FLUSH = 16, 64, 200, 8
#: the learning rate and Q format of the repo's EMB benchmark
#: (benchmarks/emb_bench.py); at the defaults (0.05, Q10) the int32
#: update lr/batch rounds to 1/1024 and most delta rows round to zero
EMB_LR, EMB_FRAC_BITS = 1.0, 12
#: the main path's EMB fits (name, hyperparameters)
EMB_FITS = (("int32 eager", {"version": "int32"}),
            ("int32 deferred D=8", {"version": "int32",
                                    "flush_every": EMB_FLUSH}),
            ("int32 D=8 compressed", {"version": "int32",
                                      "flush_every": EMB_FLUSH,
                                      "compress_flush": True}),
            ("fp32 eager", {"version": "fp32"}))
EMB_CHECK, EMB_CHECK_ITERS = 20_000, 40   # the card-vs-CPU EMB fits
#: the fused phase: GD and Lloyd's chunk lengths and pipeline depths, and
#: EMB's chunk length (one D=8 window a chunk)
FUSE_STEPS, FUSE_DEPTHS, KME_FUSE, EMB_FUSE = (5, 10), (1, 2), 5, 8
FUSED_GD = (("linreg", "int32"), ("linreg", "hyb"),
            ("logreg", "int32_lut_wram"), ("logreg", "int32_lut_mram"))
#: EMB fp32 CPU-vs-card tolerance on the tables: the prediction sums
#: u * i over the 16 columns in another order on the card
EMB_FP32_RTOL, EMB_FP32_ATOL = 1e-4, 1e-6
#: published peaks of the H100 SXM (NVIDIA data sheet): HBM3 bytes/s;
#: int32 operations on the CUDA cores (64 INT32 lanes per SM, half the
#: FP32 lanes; a multiply-add counts 2); float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 33.5e12
PEAK_FP32_OPS_PER_S = 67e12
#: ... and the dense tensor-core rates: int8 operations, bf16 flops
PEAK_INT8_OPS_PER_S = 1979e12
PEAK_BF16_FLOPS = 989e12
INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1
#: lut_sigmoid's misaligned and ragged cases: about this many elements,
#: and the length of the odd table beside the paper's
LUT_RAGGED, LUT_ODD = 100_000, 1_001

#: phase 10, LM training: launch/train.py's default arch at full width,
#: depth cut from 40 layers to 8 (8.2B parameters at 12 bytes each for
#: training is 98 GB, over the card's 80 GB), bf16, remat full; MarkovCorpus
#: batches of 8 x 1024 tokens, AdamW at lr 3e-4 through launch.train.train;
#: its MLP linears as (K, N) for int_matmul at M = B * S
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = "granite-3-8b", 8, 8, 1024
TRAIN_STEPS, TRAIN_QUANT_STEPS, TRAIN_TIMED_STEPS, TRAIN_LR = 5, 2, 3, 3e-4
TRAIN_MLP_SHAPES = ((4096, 12800), (12800, 4096))
#: step 1 with the kernels against plain attention under autograd, bf16:
#: the loss (|loss| ~ 11) and each gradient leaf's relative norm.  The
#: forward kernel rounds P to bf16 for P V (MHA_BF16_ATOL on out) and both
#: round every activation and gradient to bf16 in other orders through 8
#: layers (2**-8 a rounding)
TRAIN_LOSS_ATOL, TRAIN_GRAD_RTOL = 2e-2, 5e-2
#: mha_bwd against mha_bwd_plain, max abs error over max |plain|: bf16
#: outputs round to bf16 (2**-8 of a value) after float32 arithmetic in
#: both; float32 in other orders (~1e-6), room for dS's cancellation.  The
#: forward's lse against the plain logsumexp (|lse| <= ~10; the bf16
#: kernel's exp2 is ex2.approx, ~2**-22 relative)
TRAIN_BWD_BF16_RTOL, TRAIN_BWD_F32_RTOL, TRAIN_LSE_ATOL = 1e-2, 1e-4, 1e-4

#: phase 13, data-parallel training: (a) DP_RANKS ranks share the card,
#: each a whole granite-3-8b replica at full width cut to DP_LAYERS of 40
#: layers (1.24B parameters; bf16 params and grads, float32 AdamW moments
#: and error buffers: 16 bytes a parameter, ~20 GB a rank), TRAIN_BATCH x
#: TRAIN_SEQ tokens a step over both, AdamW lr TRAIN_LR, DP_STEPS steps
#: exact then compressed.  Step 1's leaf updates against the one-process
#: step's: AdamW's first update is about lr * sign(g), and bf16 gradients
#: summed in another order flip the sign of near-zero ones, so within
#: DP_STEP_RTOL of the leaf's update norm; the compressed run's bound is
#: the reference's (tests/test_distributed.py).  (b)-(d) on four ranks,
#: reduced configs; the hierarchical bound is tests/test_collectives.py's.
#: DP_STEPS cut from 5 to 3 beside phase 16 and to 2 beside phase 18 (the
#: script's time limit; it took 968.9 s with 3): the checks are as before
#: (step 1, the ranks bit-identical after every step, the compressed
#: run's last loss below its first: 11.2980 against 11.3199 at step 2),
#: but steps 3-5 of each run run no more, and a step's ms is step 2's
DP_RANKS, DP_LAYERS, DP_STEPS = 2, 4, 2
DP_STEP_RTOL, DP_EF_LOSS_GAP, DP_POD_RTOL = 0.1, 0.35, 1e-4
DP_SMALL_RANKS, DP_SMALL_STEPS, DP_SMALL_BATCH, DP_SMALL_SEQ = 4, 3, 8, 16
#: the pipeline at tests/test_pipeline.py's size and bounds
PIPE_L, PIPE_D, PIPE_MICRO, PIPE_B, PIPE_S = 8, 32, 6, 2, 4
PIPE_FWD_ATOL, PIPE_GRAD_RTOL = 1e-5, 1e-4
#: (d)'s leaf: granite's wk at full width
DP_COMPRESS_SHAPE = (4096, 1024)
DP_TIMEOUT = 600.0

#: phase 15, the dense LM on sharded parameters: TP_RANKS ranks share the
#: card over gloo on a ("data"=1, "model"=TP_RANKS) mesh.  (a) LM_ARCH at
#: full width and depth, TP_PROMPTS prompts of TP_PROMPT_LEN tokens, then
#: TP_NEW greedy decode tokens, quantize_dense on and off; every quantized
#: linear's int8 activations checked, and the first TP_INT8_CALLS int32
#: products on the gathered operands.  TP_BF16_TOL: the sharded run sums
#: each row-parallel product (wo, and down with quantize_dense off) as two
#: bf16 partials, ~2 more bf16 roundings (2**-8) a layer than one process:
#: 72 over 36 layers, a random walk of ~2**-8 * sqrt(72) ~ 3% of a logit's
#: scale (~1), whose largest of 151,936 logits lies ~4 sigma out:
#: LM_BF16_TOL's bound, 0.25.  With quantize_dense on the one-process run
#: is fed the ranks' int8 activations and scales (Int8Feed): its linears
#: then multiply what the ranks' did, exactly (the int32 partial sums are
#: reduced in int32), and only the bf16 walk above (wo's half of it)
#: separates the runs, so the same bound holds.  (b) TRAIN_ARCH at full
#: width, TP_TRAIN_LAYERS of 40 layers, one step on TRAIN_BATCH x
#: TRAIN_SEQ tokens (TRAIN_LOSS_ATOL, TRAIN_GRAD_RTOL: phase 10's bounds
#: for bf16 in other orders).  Every kernel launch on a rank is held
#: against its plain version on the rank's operands (KernelChecks).  (e)
#: the dry-run's cells (TP_DRY_SHAPES on both production meshes, and
#: decode_32k on (1, TP_RANKS)), in processes of their own beside the
#: data's set-up before phase 14, where no timed phase runs
#: TP_NEW cut from 8 to 4 beside phase 16 and to 2 beside phase 18 (the
#: script's time limit; it took 1081.8 s with phase 18 and 4), and
#: TP_TRAIN_LAYERS from 4 to 2 beside phase 18: the checks are as before,
#: on prefill and 2 decode steps, not 8, and a step of 2 layers, not 4
TP_RANKS, TP_PROMPTS, TP_PROMPT_LEN, TP_NEW = 2, 2, 512, 2
TP_INT8_CALLS, TP_TRAIN_LAYERS, TP_TIMEOUT = 6, 2, 600.0
TP_BF16_TOL = 0.25
TP_DRY_SHAPES = ("decode_32k", "prefill_32k", "train_4k")
TP_DRY_TIMEOUT = 600.0
TP_DIR = Path(__file__).resolve().parent / "build" / "phase15"

#: phase 16, the MoE family on sharded parameters: MOE_RANKS ranks share the
#: card over gloo on a ("data"=1, "model"=MOE_RANKS) mesh.  (a) FAM_MOE at
#: full width and depth (its 64 experts, 60 real, 32 a rank; the shared
#: expert tensor parallel), phase 15's TP_PROMPTS prompts of TP_PROMPT_LEN
#: tokens, then MOE_NEW greedy decode tokens, quantize_dense on and off,
#: within TP_BF16_TOL of one process (each rank's experts combine into a
#: bf16 partial, summed over "model": one more bf16 rounding a layer than
#: phase 15's wo, over 24 layers).  (b) its train step at MOE_TRAIN_LAYERS of
#: 24 layers (~0.6B parameters a layer at 12 bytes each for training: the
#: ranks and then the one-process check fit beside the card's other
#: tenants), MOE_TRAIN_BATCH x MOE_TRAIN_SEQ tokens.  (c) FAM_DBRX at full
#: width with FSDP over "data" on a DBRX_MESH mesh, DBRX_LAYERS of 40 layers
#: (cut from phase 11's 4 for time: every forward call gathers each layer's
#: 3.2 GB of expert weights a rank over gloo through host memory, ~5 s a
#: layer with four ranks on one card, so 4 layers took 102 s of the
#: phase's 232 s in a trial; the card held them), DBRX_PROMPTS prompts of
#: FAM_DBRX_PROMPT tokens (each data rank holds 8 of the 16 routing
#: groups), then DBRX_NEW decode steps, each one routing group over both
#: data ranks (cut from FAM_NEW for the same reason).  DBRX_LAYERS cut from
#: 2 to 1 beside phase 17 (the script took 1329.9 s on a slower host, its
#: phases before 17 ~1200 s of it): every check runs as before on the one
#: layer's routers, gathers and logits; the second layer's no longer run.
#: MOE_NEW (FAM_NEW before) cut from 4 to 2, DBRX_NEW from 2 to 1 and
#: MOE_TRAIN_LAYERS from 2 to 1 beside phase 18 (the script took 1081.8 s
#: with it, then 968.9 s): every check runs as before on the prefill, the
#: decode steps and the layer left; (a)'s decode steps 3-4, (b)'s second
#: layer and (c)'s second decode step no longer run
MOE_RANKS, MOE_TRAIN_LAYERS, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 2, 1, 4, 1024
MOE_NEW = 2
DBRX_MESH, DBRX_LAYERS, DBRX_PROMPTS, DBRX_NEW = (2, 2), 1, 2, 1
MOE_TIMEOUT = 600.0
MOE_DIR = Path(__file__).resolve().parent / "build" / "phase16"

#: phase 17, the recurrent families on sharded parameters: SSM_RANKS ranks
#: share the card over gloo on a ("data"=1, "model"=SSM_RANKS) mesh.  (a)
#: FAM_HYMBA and (b) FAM_XLSTM at full width and depth, phase 15's
#: TP_PROMPTS prompts of TP_PROMPT_LEN tokens, then SSM_NEW greedy decode
#: tokens, within TP_BF16_TOL of one process (the row-parallel products'
#: bf16 partial sums summed over "model", as phase 15's wo); (c) one AdamW
#: step of each at SSM_TRAIN_LAYERS on SSM_TRAIN_BATCH x SSM_TRAIN_SEQ
#: tokens (TRAIN_LOSS_ATOL, TRAIN_GRAD_RTOL).  Cut for the script's time
#: limit (phase 17 took 268.6 s at full training depth and 4 decode tokens
#: with a separate timed serve run a mode, then 130.1 s with the cuts
#: below but 4 tokens and 8 hymba layers, in a run of 1329.9 s): the steps
#: run at 4 of hymba's 32 layers and at xlstm's first 7 + 1 unit of 24
#: (its sLSTM loops over the 1,024 tokens three times a step: 25.0 s a step
#: at full depth over ranks, 22.1 s in one process), SSM_NEW decode tokens
#: (4 before), and the serve ms come from the checked runs (quantize on:
#: every int8 activation gathered and checked inside them), so the other
#: 28 and 16 layers no longer train here, decode steps 3-4 no longer run
#: and no serve run goes unchecked.  SSM_NEW cut from 2 to 1 beside phase
#: 18 (the script took 1082.3 s with 2 on a slower host): the second
#: decode step no longer runs
SSM_RANKS, SSM_NEW, SSM_TRAIN_BATCH, SSM_TRAIN_SEQ = 2, 1, 2, 1024
SSM_TRAIN_LAYERS = {"hymba-1.5b": 4, "xlstm-350m": 8}
SSM_TIMEOUT = 600.0
SSM_DIR = Path(__file__).resolve().parent / "build" / "phase17"

#: phase 18, the VLM and audio families on sharded parameters: phase 17's
#: X_RANKS ranks (one spawn: each spawn's ranks take ~15 s to start) share
#: the card over gloo on a ("data"=1, "model"=X_RANKS) mesh,
#: every cross block's gates at X_GATE (init leaves them 0, and tanh(0)
#: shuts the cross path).  (a) X_VLM at full width, X_VLM_LAYERS of its 40
#: layers: two units of 4 self-attention blocks and a gated cross block
#: (layers 4 and 9), so both block types run; the depth is cut for the
#: script's time limit.  Its vision states [TP_PROMPTS, 1601, 4096] bf16
#: drawn from SEED, phase 15's TP_PROMPTS prompts of TP_PROMPT_LEN tokens,
#: then X_NEW greedy decode tokens, quantize_dense on and off, within
#: TP_BF16_TOL of one process (the row-parallel products' bf16 partial
#: sums summed over "model", as phase 15's wo).  (b) X_AUDIO at full
#: width and depth over 1500 frames [TP_PROMPTS, 1500, 384] bf16, the
#: same way on prompts of X_AUDIO_PROMPT_LEN tokens.  (c) one AdamW step
#: each (TRAIN_LOSS_ATOL, TRAIN_GRAD_RTOL): whisper at full depth on
#: X_TP_TRAIN_BATCH x X_TRAIN_SEQ tokens (its decoder's context), the VLM
#: at X_VLM_TRAIN_LAYERS (one unit) on X_TP_TRAIN_BATCH x X_VLM_TRAIN_SEQ
#: tokens with its vision states
X_RANKS = SSM_RANKS         # phase 18 runs on phase 17's ranks
X_NEW, X_VLM_LAYERS, X_AUDIO_PROMPT_LEN = 2, 10, 256
X_VLM_TRAIN_LAYERS, X_VLM_TRAIN_SEQ, X_TP_TRAIN_BATCH = 5, 1024, 2
X_TIMEOUT = 600.0
X_DIR = Path(__file__).resolve().parent / "build" / "phase18"

#: phase 19, the examples: each main of repro_torch.examples at the
#: reference's sizes, in this order; the six PIM-ML walkthroughs are held
#: to expected/<name>.txt (outputs.compare)
EX_PIM = ("quickstart", "pim_ml_sklearn", "compare_systems", "emb_recsys",
          "job_queue", "elastic_jobs")
EX_ALL = EX_PIM + ("serve_lm", "train_lm")
#: each PIM-ML example's kernel launches, worked out from it (op names);
#: the integer fits are bit-identical on the card and the CPU (phase 4),
#: so data-dependent counts (KME iterations, DTR rounds, a resumed job's
#: rework) are the reference's own runs'
EX_COUNTS = {
    # fx_matvec: LIN int32 500 + LOG int32 500 + LOG int32_lut_wram 500,
    # the host-reduce fit 100, the 3-lane gang 500 (one a step for all
    # lanes), the mixed queue's PIM job 120 (hyb, bui, bui_lut and every
    # fp32 fit launch none); lut_sigmoid: LOG int32_lut_wram and bui_lut,
    # 500 each; gini_split: 11 rounds (depth 10) on PIM and 11 on the
    # host; kmeans_assign: the int16 fit's two restarts, 45 + 28 Lloyd
    # iterations
    "quickstart": {"fx_matvec": 3 * 500 + 100 + 500 + 120,
                   "lut_sigmoid": 2 * 500, "gini_split": 2 * 11,
                   "kmeans_assign": 45 + 28},
    # LOG bui_lut 400 steps (LIN bui and its sweep launch none); DTR depth
    # 8, 9 rounds; PimKMeans' two restarts, 5 + 22 iterations
    "pim_ml_sklearn": {"lut_sigmoid": 400, "gini_split": 9,
                       "kmeans_assign": 5 + 22},
    # the PIM int32 fit's 200 steps; host and gpu-model fp32 launch none
    "compare_systems": {"fx_matvec": 200},
    # 1120 steps in all (eager, D=8, the two D=1 identity fits, the
    # compressed D=8 fit, the registry's fp32 and int32 D=8 fits: 160
    # each), 2 gathers a step; 2 scatter-adds an apply or flush: 160 +
    # 20 + 160 + 160 + 20 + 20 + 20 = 560
    "emb_recsys": {"emb_gather": 2 * 7 * 160,
                   "emb_scatter_add": 2 * (3 * 160 + 4 * 20)},
    # LIN int32 60 + LOG int32_lut_wram 60 steps; KME int16 20 iterations
    # (the poisoned job fails before its first); the hyb sweep none
    "job_queue": {"fx_matvec": 2 * 60, "lut_sigmoid": 60,
                  "kmeans_assign": 20},
    # act 1: the preempted job 200 + 16 (the chunk in flight at the
    # preemption, dropped) and its uninterrupted twin 200; act 2: two
    # tenants 120 each and the urgent job 40; act 3: the int32 job 20
    # (fp32 launches none); act 4: 100 + 32 (4 chunks of 8 redone after
    # the fault); act 5: 8 + 200 + 2 (the chunk the crash cut, redone)
    "elastic_jobs": {"fx_matvec": 416 + 280 + 20 + 132 + 210},
}
#: serve_lm: 8 requests of 12-token prompts over 4 slots, 240 tokens
EX_SERVE_REQUESTS, EX_SERVE_TOKENS = 8, 240
#: train_lm's ~100M granite at 100 of its default 300 steps (one
#: checkpoint): 300 took 59.1 s of the phase's 84.2 on an H100 at 700 W,
#: over its 60 s; steps 101-300 and the two later checkpoints no longer
#: run, every check does.  Its layers and microbatches, and the tokens of
#: a step at its --batch and --seq defaults (examples/train_lm.py)
EX_TRAIN_STEPS, EX_TRAIN_LAYERS, EX_TRAIN_MICROBATCHES = 100, 12, 2
EX_TRAIN_TOKENS = 16 * 128
#: the ops the examples launch between them: every kernel but int_matmul
#: (both LM examples keep quantize_dense off, as the reference's do)
EX_KERNELS = {"fx_matvec", "lut_sigmoid", "kmeans_assign", "gini_split",
              "emb_gather", "emb_scatter_add", "mha", "mha_bwd"}
EX_DIR = Path(__file__).resolve().parent / "build" / "phase19"

#: phase 14, PIM-ML over ranks: PIM_RANKS ranks share the card over gloo,
#: each owning N_CORES / PIM_RANKS cores; the fits (name: workload,
#: version, data, reduce), each at phase 4-5's parameters; the KME inertia
#: against the one-process fit's (tests/test_torch_kmeans.py's INERTIA_RTOL);
#: then PIM_SMALL_RANKS ranks over PIM_SMALL_CORES cores (6 a rank:
#: hierarchical groups of 8 straddle ranks 0-1 and 2-3) at small sizes
PIM_RANKS, PIM_TIMEOUT = 2, 600.0
PIM_FITS = {
    "lin int32 fabric": ("linreg", "int32", "lin", "fabric"),
    "lin int32 host": ("linreg", "int32", "lin", "host"),
    "lin int32 hierarchical": ("linreg", "int32", "lin", "hierarchical"),
    "log int32_lut_wram fabric": ("logreg", "int32_lut_wram", "log",
                                  "fabric"),
    "kme int16 fabric": ("kmeans", "int16", "kme", "fabric"),
    "dtr fabric": ("dtree", None, "dtr", "fabric"),
    "emb int32 D=8 fabric": ("emb", "int32", "emb", "fabric"),
}
KME_INERTIA_RTOL = 1e-6
PIM_SMALL_RANKS, PIM_SMALL_CORES, PIM_SMALL_SAMPLES = 4, 24, 24_000
PIM_DATA_DIR = Path(__file__).resolve().parent / "build" / "phase14"

#: the LM serve load: the repo's serving model (launch/serve.py's default)
#: at full width and depth, 8 requests over 4 slots, prompt lengths drawn
#: by SEED from 128-1024, 4 new tokens each, greedy.  Cut from 32 (with
#: FAM_NEW) to 16 to keep the script inside its time limit beside phase 15
#: (a slower host took 1170.6 s of 1200 before the cut), to 8 beside
#: phase 16 (a slower host took 1010.4 s with 16), and to 4 beside phase
#: 19 (the script took 1022.3 s with 8): the launch counts, the prefill +
#: decode check and the card against CPU check are as before, but decode
#: steps 5-32 of a request (cache positions up to prompt + 32) run no
#: more, and the decode medians come from 24 calls, not 248
LM_ARCH = "qwen3-8b"
LM_REQUESTS, LM_SLOTS, LM_NEW, LM_MAX_SEQ = 8, 4, 4, 2048
LM_PROMPT_MIN, LM_PROMPT_MAX = 128, 1024
LM_PROFILE_STEPS = 8
#: qwen3-8b's MLP linears as (K, N): up and gate, then down
LM_MLP_SHAPES = ((4096, 12288), (12288, 4096))
#: flash_attention against its plain version: both compute in float32 in
#: other orders (expf against ATen's exp), so float32 outputs agree to
#: ~1e-6 of their O(1) size; in bf16 the kernel also rounds the softmax
#: weights to bf16 (2**-9 relative) for the tensor cores' P @ V, and the
#: output may round to the neighbouring bf16 value (one ulp is 2**-6
#: below 4)
MHA_F32_ATOL, MHA_BF16_ATOL = 1e-5, 2e-2
#: prefill + decode against the forward at full width, on one prompt.
#: float32: the repo's float32 tolerance for that property
#: (tests/test_arch_smoke.py).  bf16 keeps 8 significant bits (2**-8 per
#: rounding); the decode step rounds the residual stream of its one token
#: through 36 layers in other orders than the prompt's batched path
#: (cuBLAS gemv against gemm) and casts the softmax weights to bf16
#: before p @ v (the reference's attention.py:184) where the prefill's
#: kernel keeps them float32: ~10 roundings a layer, a random walk of
#: ~2**-8 * sqrt(360) ~ 7% of a logit's scale (~1 here), whose largest of
#: 151,936 logits lies ~4 sigma out
LM_F32_PROPERTY_TOL, LM_BF16_TOL = 1e-3, 0.25
#: reduced qwen3-8b in float32, card against CPU: float32 in other orders
#: (tests/test_torch_lm.py's LOGIT_ATOL); with quantize_dense on, one int8
#: rounding step of one activation moves a logit by up to 0.145 there, so
#: two such steps (QUANT_LOGIT_ATOL)
LM_F32_ATOL, LM_QUANT_ATOL = 1e-4, 0.3

#: phase 11, the decoder-only families at full width, bf16, seeded random
#: weights: qwen2-moe-a2.7b and hymba-1.5b served as qwen3-8b is (LM_REQUESTS
#: over LM_SLOTS, prompts drawn from LM_PROMPT_MIN-MAX, FAM_NEW new tokens:
#: cut from 16 to 8, then to 4 beside phase 17 (the script took 1329.9 s on
#: a slower host, its phases before 17 ~1200 s of it), then to 2 beside
#: phase 18 (1082.3 s on a slower host), to keep the script inside its
#: time limit, so decode steps 3-16 of a request, in phases 11 and 12, run
#: no more: hymba's window of 1024 is passed either way, its meta tokens
#: included, and every check runs as before),
#: xlstm-350m on prompts of 64-token multiples (its mLSTM's chunk contract:
#: a prompt longer than 64 tokens must be a multiple of 64), dbrx-132b cut
#: to FAM_DBRX_LAYERS of 40 layers (40 would be 264 GB of bf16) on one
#: prompt whose length splits into its 16 routing groups
FAM_MOE, FAM_HYMBA, FAM_XLSTM, FAM_DBRX = ("qwen2-moe-a2.7b", "hymba-1.5b",
                                           "xlstm-350m", "dbrx-132b")
FAM_DBRX_LAYERS, FAM_DBRX_PROMPT, FAM_DBRX_NEW = 4, 512, 8
FAM_XLSTM_CHUNK = 64
FAM_NEW = 2
#: (e), card against CPU on each family reduced to float32: hymba with 4
#: layers (layer 1 slides its 32-token window; both layers of the default
#: 2 are global), batches of 2 x 64 tokens so the window bites.  One
#: value_and_grad and one AdamW step: losses within FAM_LOSS_ATOL, each
#: gradient leaf within FAM_GRAD_RTOL of its norm (float32 in other orders,
#: tests/test_torch_cuda.py's step tolerances); forward logits within
#: LM_F32_ATOL, greedy tokens equal
FAM_REDUCED = {FAM_MOE: {}, FAM_DBRX: {}, FAM_XLSTM: {},
               FAM_HYMBA: {"n_layers": 4}}
FAM_LOSS_ATOL, FAM_GRAD_RTOL = 1e-5, 1e-4
#: (f), the MoE property in float32 at full width: capacity factor
#: experts / top_k makes every expert's buffer hold all its group's tokens
#: (dropless), so prefill + decode gives the forward's last position; the
#: prompt's length
FAM_PROPERTY_PROMPT = 512

#: phase 12, the VLM and audio families at full width, bf16, seeded random
#: weights, served as the reference's API runs them (tests/test_arch_smoke.py:
#: Model.prefill with the batch's vision states or frames, then batch-1
#: Model.decode_step calls; ServeEngine prefills tokens alone): X_REQUESTS
#: requests of FAM_NEW greedy tokens each, llama-3.2-vision-11b's prompts
#: drawn by SEED from X_PROMPT_MIN-MAX tokens, each with its own vision
#: states [1, 1601, 4096], whisper-tiny's X_AUDIO_PROMPT-token decoder
#: prompts over 1500 frames each (bf16, as the reference's input_specs
#: give them), within whisper's X_TRAIN_SEQ positions.  Every cross block's
#: gates at X_GATE: init leaves them 0, and tanh(0) shuts the vision path.
#: Then whisper-tiny trained X_TRAIN_STEPS steps at full width through
#: launch/train.py, X_TRAIN_BATCH sequences of X_TRAIN_SEQ tokens (its
#: decoder's context), its frames float32 as the reference's launcher draws
#: them (the encoder then computes in float32, as the reference's does)
X_VLM, X_AUDIO = "llama-3.2-vision-11b", "whisper-tiny"
X_REQUESTS, X_PROMPT_MIN, X_PROMPT_MAX, X_AUDIO_PROMPT = 4, 64, 512, 4
X_GATE = 1.0
X_TRAIN_BATCH, X_TRAIN_SEQ, X_TRAIN_STEPS = 4, 448, 2
#: the reduced families' card-against-CPU batch, and the prompt's length
#: before its 3 decode steps
X_REDUCED_BATCH, X_REDUCED_SEQ = 2, 64
#: phase 12's bf16 flash_attention checks draw v around X_V_MEAN (q and k
#: zero-mean), so every output lies in [2, 4), where one bf16 ulp is 2**-6:
#: a right kernel is at most one ulp (0.0156) from plain, within
#: MHA_BF16_ATOL.  A kernel that let the TMA's zero-filled keys past Skv
#: (36 past 1500, 63 past 1601 in 64-key tiles) into the softmax would add
#: exp(0) per key to a sum of ~Skv e**0.5, scale the output by <= 0.9855
#: and move it by >= 0.043, nearly 3 ulps; its lse would move by >=
#: log(1.0145) = 0.0144, against TRAIN_LSE_ATOL.  With zero-mean v the same
#: fault moves the output (|out| ~ 0.16) by ~4e-3, inside MHA_BF16_ATOL
X_V_MEAN = 3.0

LIN_VERSIONS = ("int32", "hyb", "fp32")
LOG_VERSIONS = ("int32_lut_wram", "int32_lut_mram")

#: phase 8: fx_matvec's lane counts against the plain version, the gangs'
#: learning rates (an 8-point LIN sweep around the launcher's 0.1, a
#: 4-point LOG one around its 5.0), the LOG lane cancelled after
#: GANG_CANCEL_AT iterations, the chunked gang's fuse_steps, the slices'
#: rank and width, and the iteration of the snapshots
LANE_KS = (1, 2, 3, 8, 13)
GANG_LIN_LRS = (0.02, 0.05, 0.1, 0.15, 0.2, 0.3, 0.4, 0.5)
GANG_LOG_LRS = (1.0, 2.0, 5.0, 10.0)
GANG_CANCEL_AT, GANG_FUSE = 3, 5
#: the gang timed untraced (False) and traced (True) in these turns
TRACE_TURNS = (False, True, True, False) * 2
SLICE_RANK, SLICE_CORES = 64, 1024
SNAPSHOT_LIN_AT, SNAPSHOT_KME_AT = 5, 3

#: phase 9, the training service over N_CORES cores in UPMEM's 64-core
#: ranks: the priority job's arrival (after this many turns) and chunk
#: length, the drain's and the serve loop's time limits, the service's
#: device-memory allowance after a drain, and examples/jobs.yaml as JSON
#: (the card's machine has no PyYAML; tests/test_torch_service.py holds
#: this equal to the YAML file)
SERVICE_RANK, SERVICE_PRIORITY_AT, SERVICE_FUSE = 64, 3, 5
SERVICE_TIMEOUT = 300.0
SERVICE_MEMORY_SLACK = 64 << 20
TREE_FIELDS = ("feature", "threshold", "left", "right", "leaf_class",
               "depth")
JOBS_YAML_AS_JSON = {
    "system": {"cores": 32, "rank_size": 4, "reduce": "fabric"},
    "datasets": {
        "lin": {"kind": "linear", "samples": 2048, "features": 16,
                "seed": 0},
        "blobs": {"kind": "blobs", "samples": 4096, "features": 8,
                  "centers": 8, "seed": 1},
    },
    "jobs": [
        {"workload": "kmeans", "dataset": "blobs", "cores": 8,
         "priority": 1, "params": {"n_clusters": 8, "max_iter": 40}},
        {"workload": "logreg", "dataset": "lin",
         "version": "int32_lut_wram", "cores": 4,
         "params": {"n_iters": 150}},
    ],
    "sweeps": [
        {"workload": "linreg", "dataset": "lin", "version": "hyb",
         "cores": 8, "fused": True, "grid": {"lr": [0.05, 0.1, 0.2, 0.4]},
         "params": {"n_iters": 150}},
    ],
}


def say(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


class L2Flush:
    """What runs before each timed call, so that the call finds L2 cold:
    sum a 256 MB buffer into a preallocated scalar, which leaves L2
    holding clean lines of the buffer (zeroing it would leave ~50 MB of
    dirty lines whose write-back the timed call pays), then a device sleep
    of FLUSH_SLEEP_CYCLES, so that the host has enqueued the timed call
    before its start event fires."""

    def __init__(self, torch):
        self.torch = torch
        self.buf = torch.zeros(32 << 20, dtype=torch.int64, device="cuda")
        self.sink = torch.zeros((), dtype=torch.int64, device="cuda")

    def __call__(self) -> None:
        self.torch.sum(self.buf, 0, out=self.sink)
        self.torch.cuda._sleep(FLUSH_SLEEP_CYCLES)


def cuda_ms(torch, fn, flush: L2Flush) -> float:
    """Median CUDA-event time of ``fn()`` in ms over TIMING_RUNS runs,
    after two warm-up runs, with ``flush()`` before each."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(TIMING_RUNS):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(torch, fn, n: int = 50) -> float:
    """Host microseconds per call of ``fn`` (enqueue only: the card runs
    behind), over ``n`` calls after a synchronised warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def bound(nbytes: float, ops: float,
          ops_per_s: float = PEAK_INT32_OPS_PER_S) -> tuple[float, str]:
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


#: the peak each declared cost's operations run at (KernelCost.rate)
PEAK_OPS_PER_S = {"int32": PEAK_INT32_OPS_PER_S, "fp32": PEAK_FP32_OPS_PER_S,
                  "int8": PEAK_INT8_OPS_PER_S, "bf16": PEAK_BF16_FLOPS}


def declared_bound(op: str, *args) -> tuple[float, str]:
    """The bound of one call of a PIM-ML kernel op from the cost it
    declares (kernels/dispatch.py), the same count the gpu-model target
    charges it."""
    from repro_torch.kernels import dispatch
    cost = dispatch.declared_cost(op, *args)
    return bound(cost.bytes, cost.ops, PEAK_OPS_PER_S[cost.rate])


def host_samples(sizes, bytes_per_sample: int) -> tuple[int, int]:
    """The largest of ``sizes`` whose generation fits half of
    MemAvailable, and MemAvailable in bytes."""
    with open("/proc/meminfo") as f:
        avail = next(int(line.split()[1]) * 1024 for line in f
                     if line.startswith("MemAvailable:"))
    for n in sizes:
        if n * bytes_per_sample <= avail / 2:
            return n, avail
    fail(f"MemAvailable {avail} B holds no size of {sizes}")


def same(torch, outs, refs) -> float:
    """Max abs difference of kernel outputs from their plain version's;
    fails unless they are equal (shape, dtype and values)."""
    torch.cuda.synchronize()
    if any(o.shape != r.shape or o.dtype != r.dtype
           for o, r in zip(outs, refs)):
        fail("kernel output and plain version differ in shape or dtype")
    err = max(float((o.double() - r.double()).abs().max()) if o.numel()
              else 0.0 for o, r in zip(outs, refs))
    if not all(torch.equal(o, r) for o, r in zip(outs, refs)):
        fail(f"kernel != plain (max abs err {err})")
    return err


def check_kmeans_assign(torch, dev, gen) -> tuple[int, dict]:
    """kmeans_assign against its plain version: the KME main shape with
    quantized and with full-range int16 (the products wrap), two chained
    calls there (one block per core stores a partial allocated empty), a
    ragged shape, K = 1, 9 and 33, F = 1 and 40, one row a core, rows that
    are not 16-byte aligned, and duplicated centroids (ties).  Returns the
    max abs error and the main-shape inputs."""
    from repro_torch.kernels.kmeans_assign import (kmeans_assign_cuda,
                                                   kmeans_assign_plain)

    def ints(shape, lo=-32768, hi=32768):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32).to(torch.int16)
    n_pc = KME_SAMPLES // N_CORES
    main = (ints((N_CORES, n_pc, N_FEATURES), -2047, 2048),
            ints((KME_K, N_FEATURES), -2047, 2048))
    ties_c = ints((9, N_FEATURES), -1, 2)
    ties_c[4], ties_c[8] = ties_c[2], ties_c[0]
    flat = ints((5 * 999 * N_FEATURES + 1,))
    cases = {
        f"main {tuple(main[0].shape)} K={KME_K}": main,
        "main shape, full-range int16": (ints((N_CORES, n_pc, N_FEATURES)),
                                         ints((KME_K, N_FEATURES))),
        "main shape again, other values (chained)": (
            ints((N_CORES, n_pc, N_FEATURES), -3, 4),
            ints((KME_K, N_FEATURES), -3, 4)),
        "ragged (7, 100003, 13) K=5, full-range": (ints((7, 100_003, 13)),
                                                   ints((5, 13))),
        "(4, 3001, 16) K=1": (ints((4, 3001, 16)), ints((1, 16))),
        "(4, 3001, 16) K=9": (ints((4, 3001, 16)), ints((9, 16))),
        "(5, 2999, 16) K=33": (ints((5, 2999, 16)), ints((33, 16))),
        "(6, 3001, 1) K=7": (ints((6, 3001, 1)), ints((7, 1))),
        "(3, 4001, 40) K=33": (ints((3, 4001, 40)), ints((33, 40))),
        "(5, 1, 16) K=16, one row a core": (ints((5, 1, 16)),
                                            ints((16, 16))),
        "(5, 999, 16) K=16, rows not 16-byte aligned": (
            flat[1:].view(5, 999, N_FEATURES), ints((16, 16))),
        "ties (16, 4097, 16) K=9, duplicated centroids": (
            ints((16, 4097, N_FEATURES), -3, 4), ties_c),
    }
    err = 0
    for name, (x, c) in cases.items():
        out = kmeans_assign_cuda(x, c)
        err = max(err, same(torch, out, kmeans_assign_plain(x, c)))
        if name.startswith("ties") and torch.isin(
                out[0], torch.tensor([4, 8], device=dev)).any():
            fail("kmeans_assign: a duplicated centroid won a tie")
        say(f"kernels: kmeans_assign == plain, {name}")
        del out
    return err, {"x": main[0], "c": main[1]}


def check_gini_counts(torch, dev, gen, n_dtr: int) -> tuple[int, dict]:
    """gini_counts against its plain version at the DTR main shape with
    L = 4096: every row at the root, leaves spread over 2^10 values, over
    all 4,096 (wider than the window: rows past it add to global memory)
    and over a depth-10 frontier's ids 1023-2046, these calls chained on
    partials allocated empty; one block over more than 65,535 rows (three
    passes of 16-bit counters); the main rows over FEW_CORES cores and a
    3-core shape, whose cores split over blocks that add into zeros; 3
    classes at F = 13 and a ragged shape, with rows out of range.  Returns
    the max abs error and the main-shape inputs."""
    from repro_torch.kernels.gini_split import (gini_split_cuda,
                                                gini_split_plain)
    n_leaves = 2 ** (DTR_DEPTH + 2)
    n_pc = n_dtr // N_CORES
    x = torch.randn((N_CORES, n_pc, N_FEATURES), generator=gen, device=dev)
    y = torch.randint(0, 2, (N_CORES, n_pc), generator=gen, device=dev,
                      dtype=torch.int32)
    th = torch.randn((n_leaves, N_FEATURES), generator=gen, device=dev)

    def leaves(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)
    def few_cores(leaf):
        return (x.view(FEW_CORES, -1, N_FEATURES), y.view(FEW_CORES, -1),
                leaf.view(FEW_CORES, -1), th, 2)
    main = {"x": x, "y": y, "th": th, "few_cores": few_cores,
            "spread": leaves((N_CORES, n_pc), 0, 1024),
            "root": torch.zeros((N_CORES, n_pc), dtype=torch.int32,
                                device=dev),
            "frontier": leaves((N_CORES, n_pc), 1023, 2047)}

    def ragged(n_cores, n_pc, f, n_leaves, n_cls, hi):
        rx = torch.randn((n_cores, n_pc, f), generator=gen, device=dev)
        ry = torch.randint(0, n_cls, (n_cores, n_pc), generator=gen,
                           device=dev, dtype=torch.int32)
        rleaf = leaves((n_cores, n_pc), 0, hi)
        rleaf[0, :9], ry[1, :9], rleaf[2, :5] = n_leaves, n_cls, -1
        return (rx, ry, rleaf, torch.randn((n_leaves, f), generator=gen,
                                           device=dev), n_cls)
    cases = {
        f"main {tuple(x.shape)} L={n_leaves}, all rows at the root":
            lambda: (x, y, main["root"], th, 2),
        "main shape, leaves spread over 2^10": lambda: (x, y, main["spread"],
                                                        th, 2),
        "main shape, leaves spread over all 4096 (past the window)":
            lambda: (x, y, leaves((N_CORES, n_pc), 0, n_leaves), th, 2),
        "main shape, a depth-10 frontier's ids 1023-2046":
            lambda: (x, y, main["frontier"], th, 2),
        "(132, 150001, 16) L=4096, one block over more than 65,535 rows":
            lambda: (torch.randn((132, 150_001, N_FEATURES), generator=gen,
                                 device=dev), leaves((132, 150_001), 0, 2),
                     leaves((132, 150_001), 0, 1024), th, 2),
        f"the main rows as ({FEW_CORES}, {N_CORES * n_pc // FEW_CORES}, "
        f"16), leaves spread over 2^10 (several blocks a core add)":
            lambda: few_cores(main["spread"]),
        "(3, 200001, 16) L=4096, leaves over all 4096, several blocks a core":
            lambda: (torch.randn((3, 200_001, N_FEATURES), generator=gen,
                                 device=dev), leaves((3, 200_001), 0, 2),
                     leaves((3, 200_001), 0, n_leaves), th, 2),
        "(64, 20000, 13) L=4096, 3 classes, rows out of range":
            lambda: ragged(64, 20_000, 13, n_leaves, 3, 2047),
        "ragged (5, 100003, 13) L=37, 3 classes, rows out of range":
            lambda: ragged(5, 100_003, 13, 37, 3, 37),
    }
    err = 0
    for name, make in cases.items():
        args = make()
        out = gini_split_cuda(*args)
        err = max(err, same(torch, out, gini_split_plain(*args)))
        say(f"kernels: gini_counts == plain, {name}")
        del args, out
    return err, main


def zipf_ids(rng, n: int, vocab: int) -> np.ndarray:
    """``n`` ids from make_recsys's truncated Pareto popularity stream."""
    return np.minimum(rng.pareto(1.2, n).astype(np.int64),
                      vocab - 1).astype(np.int32)


def check_emb_kernels(torch, dev, make_system) -> tuple[int, int, dict]:
    """emb_gather and emb_scatter_add against their plain versions at the
    EMB main shapes: the Netflix-size tables placed over 2048 cores
    ([2048, 235, 16] users, [2048, 9, 16] items; both tails pad) with 64
    Zipf lookups; at both, a padded deferred flush (8 batches
    deduplicated, padded with IDX_PAD to a multiple of 64); 64 copies of
    one hot id; and a ragged shape with misses.  int32 tables and updates
    are full-range, so the sums wrap.  The gathers search each table's
    gather index, built once per placement.  Returns the max abs errors
    and the main inputs per table and dtype."""
    from repro_torch.kernels.sparse_gather import (
        IDX_PAD, emb_gather_cuda, emb_gather_plain, emb_scatter_add_cuda,
        emb_scatter_add_plain, gather_index)
    rng = np.random.RandomState(SEED)
    system = make_system("pim", n_cores=N_CORES, device="cuda")

    def table(vocab, dtype):
        t = system.put_table(np.zeros((vocab, 1), np.float32))
        shape = (N_CORES, t.rows_per_shard, EMB_DIM)
        if dtype == "int32":
            v = rng.randint(INT32_MIN, INT32_MAX, shape, np.int64)
            v = v.astype(np.int32)
        else:
            v = rng.uniform(0.5, 2.0, shape).astype(np.float32)
            v *= rng.choice([-1, 1], shape)           # finite, never 0
        return torch.from_numpy(v).to(dev), t

    def rows(n, dtype):
        if dtype == "int32":
            v = rng.randint(INT32_MIN, INT32_MAX, (n, EMB_DIM), np.int64)
            return torch.from_numpy(v.astype(np.int32)).to(dev)
        return torch.from_numpy(rng.randn(n, EMB_DIM)
                                .astype(np.float32)).to(dev)

    def ids_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    def padded_flush(vocab):
        flush = np.unique(zipf_ids(rng, EMB_FLUSH * EMB_BATCH, vocab))
        pad = -len(flush) % EMB_BATCH
        return np.concatenate([flush, np.full(pad, IDX_PAD, np.int32)])

    vocabs = {"users": EMB_USERS, "items": EMB_ITEMS}
    eager = {k: zipf_ids(rng, EMB_BATCH, v) for k, v in vocabs.items()}
    flushes = {k: padded_flush(v) for k, v in vocabs.items()}
    err_g = err_s = 0
    main = {}
    for dtype in ("int32", "fp32"):
        tabs = {k: table(v, dtype) for k, v in vocabs.items()}
        rt = torch.from_numpy(rng.randint(-99, 99, (7, 13, 3))
                              .astype(np.int32)).to(dev)
        rt = rt if dtype == "int32" else rt.float() + 0.5
        rids = ids_dev(np.arange(7 * 13).reshape(13, 7).T)
        ragged = ids_dev([5, 90, IDX_PAD, 91, 5, 12, 300, 6, 5])
        gathers = {"ragged (7, 13, 3), misses and IDX_PAD": (
            rt, rids, ragged, gather_index(rids))}
        scatters = {"ragged (7, 13, 3), duplicates, misses and IDX_PAD": (
            rt, rids, ragged, rows(9, dtype)[:, :3].contiguous()
            .to(rt.dtype))}
        for name, (tab, t) in tabs.items():
            ids, index = t.ids_device(), t.gather_index()
            shape = tuple(tab.shape)
            gathers[f"{name} {shape}, 64 Zipf lookups"] = (
                tab, ids, ids_dev(eager[name]), index)
            scatters[f"{name} {shape}, one eager batch of 64 Zipf ids"] = (
                tab, ids, ids_dev(eager[name]), rows(EMB_BATCH, dtype))
            scatters[f"{name}, a padded D={EMB_FLUSH} flush of "
                     f"{len(flushes[name])} rows"] = (
                tab, ids, ids_dev(flushes[name]),
                rows(len(flushes[name]), dtype))
            main[name, dtype] = {
                "table": tab, "ids": ids, "index": index, "placement": t,
                "idx": ids_dev(eager[name]), "upd": rows(EMB_BATCH, dtype),
                "flush": ids_dev(flushes[name]),
                "flush_upd": rows(len(flushes[name]), dtype)}
        scatters["users, 64 copies of one hot id"] = (
            tabs["users"][0], tabs["users"][1].ids_device(),
            ids_dev(np.zeros(EMB_BATCH)), rows(EMB_BATCH, dtype))
        for name, args in gathers.items():
            err_g = max(err_g, same(torch, [emb_gather_cuda(*args)],
                                    [emb_gather_plain(*args)]))
            say(f"kernels: emb_gather == plain, {dtype} {name}")
        for name, args in scatters.items():
            before = args[0].clone()
            out = emb_scatter_add_cuda(*args)
            err_s = max(err_s, same(torch, [out],
                                    [emb_scatter_add_plain(*args)]))
            if not torch.equal(args[0], before):
                fail("emb_scatter_add wrote its input table")
            say(f"kernels: emb_scatter_add == plain, {dtype} {name}")
    return err_g, err_s, main


def emb_fits_on_card(torch, make_system, get_workload, dispatch, smi: str,
                     X, y) -> tuple[dict, list, str, dict]:
    """EMB's main path at the Netflix matrix's size (the ratings ``X``,
    ``y``): every fit of EMB_FITS through the workload's ``fit_steps``
    with the launch counts zeroed just before it and checked just after;
    then the deferred D=8 int32 fit fused (EMB_FUSE steps a chunk, one
    CUDA graph replay each), against the serial one.  Returns the summed
    launch counts (the serial fits'), a profiler summary of 50 eager int32
    steps and one of a fused fit, and each serial fit's model and seconds
    a step."""
    system = make_system("pim", n_cores=N_CORES, device="cuda")
    ds = system.put(X, y)
    wl = get_workload("emb")
    base = dict(n_iters=EMB_ITERS, batch=EMB_BATCH, dim=EMB_DIM, lr=EMB_LR,
                frac_bits=EMB_FRAC_BITS, n_users=EMB_USERS, n_items=EMB_ITEMS,
                record_every=EMB_ITERS // 4, seed=SEED)
    totals: dict = {}
    serial, step_s = {}, {}
    for name, params in EMB_FITS:
        spec = wl.spec(**base, **params)
        dispatch.reset_launch_counts()
        steps, res = step_times(wl.fit_steps(ds, spec))
        torch.cuda.synchronize()
        counts = dict(dispatch.launch_counts)
        m = serial[name] = res.model
        expected = {"emb_gather": 2 * EMB_ITERS,
                    "emb_scatter_add": 2 * m.n_flushes}
        windows = EMB_ITERS // params.get("flush_every", 1)
        if counts != expected or m.n_flushes != windows:
            fail(f"EMB {name}: launch counts {counts}, {m.n_flushes} "
                 f"flushes (expected {expected}, {windows} flushes)")
        if not (m.user_emb.shape == (EMB_USERS, EMB_DIM)
                and m.item_emb.shape == (EMB_ITEMS, EMB_DIM)
                and np.isfinite(m.user_emb).all()
                and np.isfinite(m.item_emb).all()
                and all(np.isfinite(h) for _, h in m.history)):
            fail(f"EMB {name}: misshapen or non-finite tables or loss")
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        dt = statistics.median(steps[1:EMB_ITERS])
        mean = statistics.mean(steps[1:EMB_ITERS])
        step_s[name] = dt
        say(f"fit: emb     {name:<21} {dt * 1e3:.3f} ms/step (median of "
            f"steps 2-{EMB_ITERS}; mean {mean * 1e3:.3f}), "
            f"{EMB_BATCH / dt:.4g} samples/s; setup and first step "
            f"{steps[0] * 1e3:.1f} ms; launch counts {counts}, "
            f"{m.n_flushes} flushes; batch MSE "
            + " ".join(f"{h:.4g}" for _, h in m.history)
            + f" ({N_CORES} cores, on {smi})")
    gen = wl.fit_steps(ds, wl.spec(**base, version="int32"))
    next(gen)                                # set-up and the first step
    profile = device_profile(torch, lambda: [next(gen) for _ in range(50)])
    gen.close()
    fused_profile = emb_fused_on_card(torch, wl, ds, base, dispatch,
                                      serial["int32 deferred D=8"], smi)
    del X, y, ds
    return totals, profile, fused_profile, {
        name: (serial[name], step_s[name]) for name in serial}


def emb_fused_on_card(torch, wl, ds, base: dict, dispatch, serial, smi: str
                      ) -> str:
    """The deferred D=8 int32 fit with EMB_FUSE steps a chunk, twice, each
    with the launch counts zeroed just before it: tables and loss history
    equal the serial fit's, 2 emb_gather a step and 2 emb_scatter_add a
    flush, one graph replay a chunk.  A fit captures its own chunk graphs
    (they read its tables), one per chunk length.  Returns a profiler
    summary of a third fit after its first chunk."""
    spec = wl.spec(**base, version="int32", flush_every=EMB_FLUSH,
                   fuse_steps=EMB_FUSE)
    for run in (1, 2):
        syncs = ds.system.stats.host_syncs
        dispatch.reset_launch_counts()
        with GraphCaptures(torch) as graphs:
            chunks, res = chunk_times(torch, wl.fit_steps(ds, spec))
        m = res.model
        counts = dict(dispatch.launch_counts)
        replays = sum(dispatch.graph_replays.values())
        n_chunks = ds.system.stats.host_syncs - syncs  # a sync a chunk
        expected = {"emb_gather": 2 * EMB_ITERS,
                    "emb_scatter_add": 2 * m.n_flushes}
        if counts != expected or replays != n_chunks:
            fail(f"EMB fused: launch counts {counts}, {replays} replays "
                 f"for {n_chunks} chunks (expected {expected})")
        if not (np.array_equal(m.user_raw, serial.user_raw)
                and np.array_equal(m.item_raw, serial.item_raw)
                and m.history == serial.history
                and m.n_flushes == serial.n_flushes):
            fail("EMB fused: tables or history differ from the serial "
                 "deferred fit on the card")
        per_step = statistics.median(t / k for k, t in chunks[1:-1])
        say(f"fused: emb int32 D={EMB_FLUSH} fuse_steps {EMB_FUSE} (fit "
            f"{run}) {per_step * 1e3:.3f} ms/step (median over chunks "
            f"2-{len(chunks) - 1} of a chunk's time over its steps, "
            f"flushes included; the chunks that capture their graph "
            f"among them); set-up and first chunk "
            f"{chunks[0][1] * 1e3:.1f} ms; launch counts {counts}, "
            f"{replays} graph replays for {n_chunks} chunks; tables and "
            f"history == serial deferred fit ({N_CORES} cores, on {smi})")
        say(f"fused: emb chunk graphs of fit {run}: {graphs} (on {smi})")
    from repro_torch.systems import run_steps
    gen = wl.fit_steps(ds, spec)
    next(gen)
    return device_profile(torch, lambda: run_steps(gen))


def emb_card_equals_cpu(make_system, make_estimator) -> None:
    """The EMB fits at EMB_CHECK ratings on 1 and 16 cores under every
    reduce strategy, on the card and on the CPU."""
    from repro_torch.data.synthetic import make_recsys
    X, y = make_recsys(EMB_CHECK, n_users=max(64, EMB_CHECK // 16),
                       n_items=max(48, EMB_CHECK // 24), dim=EMB_DIM,
                       seed=SEED)
    t0 = time.perf_counter()
    n_int = n_fp = 0
    for cores in (1, 16):
        for reduce in ("fabric", "host", "hierarchical"):
            fits, stats = {}, {}
            for device in ("cuda", "cpu"):
                system = make_system("pim", n_cores=cores, reduce=reduce,
                                     device=device)
                ds = system.put(X, y)
                fits[device] = [make_estimator(
                    "emb", n_iters=EMB_CHECK_ITERS, batch=EMB_BATCH,
                    dim=EMB_DIM, lr=EMB_LR, frac_bits=EMB_FRAC_BITS,
                    record_every=10, seed=SEED, system=system,
                    **params).fit(ds).result_.model
                    for _, params in EMB_FITS]
                stats[device] = system.stats.snapshot()
            for (name, params), g, c in zip(EMB_FITS, fits["cuda"],
                                            fits["cpu"]):
                what = f"EMB {name}, {cores} cores, {reduce} reduce"
                if g.n_flushes != c.n_flushes:
                    fail(f"{what}: flush counts differ")
                if params["version"] == "int32":
                    n_int += 1
                    if not (np.array_equal(g.user_raw, c.user_raw)
                            and np.array_equal(g.item_raw, c.item_raw)
                            and g.history == c.history):
                        fail(f"{what}: card and CPU fits differ")
                    continue
                n_fp += 1
                if not all(np.allclose(a, b, rtol=EMB_FP32_RTOL,
                                       atol=EMB_FP32_ATOL)
                           for a, b in ((g.user_raw, c.user_raw),
                                        (g.item_raw, c.item_raw))):
                    fail(f"{what}: fp32 tables differ beyond tolerance")
            if stats["cuda"] != stats["cpu"]:
                fail(f"EMB TransferStats differ on {cores} cores, {reduce} "
                     f"reduce: {stats['cuda']} != {stats['cpu']}")
    say(f"  EMB at {EMB_CHECK:,} ratings, {EMB_CHECK_ITERS} steps, 1 and 16 "
        f"cores x fabric/host/hierarchical: {n_int} int32 fits card == cpu "
        f"(tables, history, flushes), {n_fp} fp32 fits within rtol "
        f"{EMB_FP32_RTOL} atol {EMB_FP32_ATOL}, TransferStats equal "
        f"({time.perf_counter() - t0:.1f} s)")


def emb_kernel_times(torch, emb: dict, flush) -> dict:
    """CUDA-event times of both EMB kernels at the main shapes (the user
    and the item table, int32 and float32, one eager batch; the scatter
    also on each table's padded flush), their plain versions, their
    bounds, and the nearest PyTorch call on the flat (C*R, D) table with
    the lookups' slots computed on the host.  Keys of the users table
    (int32) are bare; the other cases carry a prefix."""
    from repro_torch.kernels.sparse_gather import (
        emb_gather_cuda, emb_gather_plain, emb_scatter_add_cuda,
        emb_scatter_add_plain)

    def gather(d):
        return emb_gather_cuda(d["table"], d["ids"], d["idx"], d["index"])

    def scatter(d, key="idx", upd="upd"):
        return emb_scatter_add_cuda(d["table"], d["ids"], d[key], d[upd])

    g, s = {}, {}
    for name in ("users", "items"):
        e, f = emb[name, "int32"], emb[name, "fp32"]
        pre = "" if name == "users" else "items_"
        n_cores, n_rows, dim = e["table"].shape
        ids = e["placement"].ids
        slot_of = np.full(e["placement"].n_rows, -1, np.int64)
        slot_of[ids[ids >= 0]] = np.flatnonzero(ids >= 0)
        slot = torch.from_numpy(slot_of[e["idx"].cpu().numpy()]).to(
            e["table"].device)
        flat = e["table"].view(-1, dim)
        b = e["idx"].numel()
        g[pre + "ms"] = cuda_ms(torch, lambda: gather(e), flush)
        g[pre + "fp32_ms"] = cuda_ms(torch, lambda: gather(f), flush)
        g[pre + "library_ms"] = cuda_ms(torch, lambda: torch.index_select(
            flat, 0, slot), flush)
        # what the function moves: the [C, B, D] partials, the B rows it
        # looks up and idx; PR 13-15 counted every id and C*R*B compares
        g[pre + "bound_ms"], g[pre + "bound_by"] = declared_bound(
            "emb_gather", e["table"], e["ids"], e["idx"])
        g[pre + "old_bound_ms"], _ = bound(
            n_cores * n_rows * 4 + b * 4 + n_cores * b * dim * 4,
            n_cores * n_rows * b)
        s[pre + "ms"] = cuda_ms(torch, lambda: scatter(e), flush)
        s[pre + "fp32_ms"] = cuda_ms(torch, lambda: scatter(f), flush)
        s[pre + "flush_ms"] = cuda_ms(
            torch, lambda: scatter(e, "flush", "flush_upd"), flush)
        s[pre + "library_ms"] = cuda_ms(torch, lambda: torch.index_add(
            flat, 0, slot, e["upd"]), flush)
        s[pre + "bound_ms"], s[pre + "bound_by"] = declared_bound(
            "emb_scatter_add", e["table"], e["ids"], e["idx"], e["upd"])
    e = emb["users", "int32"]
    g["plain_ms"] = cuda_ms(torch, lambda: emb_gather_plain(
        e["table"], e["ids"], e["idx"]), flush)
    s["plain_ms"] = cuda_ms(torch, lambda: emb_scatter_add_plain(
        e["table"], e["ids"], e["idx"], e["upd"]), flush)
    g["library_call"], s["library_call"] = ("torch.index_select",
                                            "torch.index_add")
    return {"emb_gather": g, "emb_scatter_add": s}


def kme_fits(make_estimator, system, ds) -> dict:
    """The KME int16 and fp32 fits of the main path and of the card-CPU
    comparison: k=16, one restart, exactly ITERS iterations."""
    return {v: make_estimator("kmeans", version=v, n_clusters=KME_K,
                              n_init=1, max_iter=ITERS, tol=0.0,
                              system=system).fit(ds)
            for v in ("int16", "fp32")}


def check_kme(est: dict, n: int) -> None:
    for version, e in est.items():
        c = e.cluster_centers_
        if not (c.shape == (KME_K, N_FEATURES) and np.isfinite(c).all()
                and e.n_iter_ == ITERS and e.labels_.shape == (n,)
                and 0 <= e.labels_.min() and e.labels_.max() < KME_K
                and np.isfinite(e.inertia_)):
            fail(f"KME {version}: misshapen or non-finite result")


def chunk_times(torch, gen) -> tuple[list, object]:
    """``(iterations, wall seconds)`` of each chunk a ``fit_steps``
    generator yields, each ending in a synchronize (the last entry, with
    0 iterations, is the work after the last yield), and the result."""
    out, t = [], time.perf_counter()
    while True:
        try:
            k = int(next(gen))
        except StopIteration as stop:
            torch.cuda.synchronize()
            out.append((0, time.perf_counter() - t))
            return out, stop.value
        torch.cuda.synchronize()
        now = time.perf_counter()
        out.append((k, now - t))
        t = now


def step_times(gen) -> tuple[list, object]:
    """Wall seconds of each step of a ``fit_steps`` generator (the host
    reads the reduced partials, a sync, at every step; the last entry is
    the work after the last yield) and the fit's result."""
    times, t = [], time.perf_counter()
    while True:
        try:
            next(gen)
        except StopIteration as stop:
            times.append(time.perf_counter() - t)
            return times, stop.value
        now = time.perf_counter()
        times.append(now - t)
        t = now


def timed(torch, fn) -> tuple[float, object]:
    """Wall seconds of ``fn()`` up to a synchronize, and its result."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


class GraphCaptures:
    """Within the block, each chunk graph's capture, its warm-up step
    included, timed between two synchronizations, and the bytes of the
    memory pool it keeps (the segments the allocator lists under the
    graph's pool): ``taken`` holds (program, k, seconds, pool bytes)."""

    def __init__(self, torch):
        from repro_torch.systems import step_graph
        self.torch, self.cls = torch, step_graph.ChunkGraph
        self.taken: list = []

    def __enter__(self):
        torch, init, taken = self.torch, self.cls.__init__, self.taken
        self.init = init

        def timed_init(graph, program, carry, sharded, xs, k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            init(graph, program, carry, sharded, xs, k)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            pool = tuple(graph.graph.pool())
            taken.append((graph.name, k, dt, sum(
                seg["total_size"] for seg in torch.cuda.memory_snapshot()
                if tuple(seg["segment_pool_id"]) == pool)))
        self.cls.__init__ = timed_init
        return self

    def __exit__(self, *exc):
        self.cls.__init__ = self.init

    @property
    def seconds(self) -> float:
        return sum(t for _, _, t, _ in self.taken)

    def __str__(self) -> str:
        return ", ".join(f"k={k} capture {t * 1e3:.1f} ms pool {b:,} B"
                         for _, k, t, b in self.taken)


def fused_gd_fits(torch, dispatch, make_estimator, system, lin_ds, log_ds,
                  smi: str) -> None:
    """LIN int32 and hyb, LOG int32_lut_wram and int32_lut_mram at the main
    shape, serial and then fused at every FUSE_STEPS x FUSE_DEPTHS, each
    with the launch counts zeroed just before it: weights bit-identical
    to the serial card fit, the serial fit's launch counts, one graph
    replay and one host sync per chunk.  Each fused fit captures its
    chunk graphs and drops them when it ends; its time per iteration is
    given with the captures and without them."""
    for workload, version in FUSED_GD:
        ds = lin_ds if workload == "linreg" else log_ds

        def fit(**params):
            return make_estimator(workload, version=version, n_iters=ITERS,
                                  system=system, **params).fit(ds)
        dispatch.reset_launch_counts()
        dt, ref = timed(torch, fit)
        serial_counts = dict(dispatch.launch_counts)
        say(f"fused: {workload:<7} {version:<15} serial "
            f"{dt / ITERS * 1e3:.3f} ms/iteration over the fit; launch "
            f"counts {serial_counts} ({N_CORES} cores, on {smi})")
        for fuse in FUSE_STEPS:
            for depth in FUSE_DEPTHS:
                syncs = system.stats.host_syncs
                dispatch.reset_launch_counts()
                with GraphCaptures(torch) as graphs:
                    dt, est = timed(torch, lambda: fit(
                        fuse_steps=fuse, pipeline_depth=depth))
                counts = dict(dispatch.launch_counts)
                replays = sum(dispatch.graph_replays.values())
                chunks = system.stats.host_syncs - syncs
                if (counts != serial_counts or replays != chunks
                        or chunks != -(-ITERS // fuse)):
                    fail(f"{workload} {version} fuse_steps {fuse}: launch "
                         f"counts {counts}, {replays} replays, {chunks} "
                         f"chunks (serial: {serial_counts})")
                if not (np.array_equal(est.coef_, ref.coef_)
                        and est.intercept_ == ref.intercept_):
                    fail(f"{workload} {version} fuse_steps {fuse} depth "
                         f"{depth}: weights differ from the serial card fit")
                say(f"fused: {workload:<7} {version:<15} fuse_steps {fuse:>2}"
                    f" depth {depth} "
                    f"{(dt - graphs.seconds) / ITERS * 1e3:.3f} ms/iteration"
                    f" over the fit without its captures "
                    f"({dt / ITERS * 1e3:.3f} with them); {replays} "
                    f"replays; w, b == serial card fit; chunk graphs: "
                    f"{graphs} (on {smi})")
    torch.cuda.empty_cache()


def fused_kme(torch, dispatch, make_system, get_workload, kme_ds, serial,
              Xq, smi: str) -> str:
    """KME int16 at the main shape with KME_FUSE iterations a chunk, at
    depth 1 (to time a replayed chunk) and 2, each fit capturing its
    chunk graph and with the launch counts zeroed just before it: ITERS
    kmeans_assign launches, one replay a chunk, held to the serial fit
    within the reference's fused-against-serial tolerances
    (tests/test_step_fusion.py); then the card's fused fit against the
    CPU's at KME_QUALITY samples, bit for bit.  Returns a profiler
    summary of a fused fit."""
    wl = get_workload("kmeans")

    def spec(**extra):
        return wl.spec("int16", n_clusters=KME_K, n_init=1, max_iter=ITERS,
                       tol=0.0, **extra)
    steps, _ = step_times(wl.fit_steps(kme_ds, spec()))
    say(f"fused: kmeans  int16 serial "
        f"{statistics.median(steps[1:ITERS]) * 1e3:.3f} ms/iteration "
        f"(median of iterations 2-{ITERS}; {N_CORES} cores, "
        f"{KME_SAMPLES:,} samples, on {smi})")
    for depth in FUSE_DEPTHS:
        dispatch.reset_launch_counts()
        with GraphCaptures(torch) as graphs:
            chunks, res = chunk_times(torch, wl.fit_steps(
                kme_ds, spec(fuse_steps=KME_FUSE, pipeline_depth=depth)))
        m = res.model
        counts = dict(dispatch.launch_counts)
        replays = sum(dispatch.graph_replays.values())
        if counts != {"kmeans_assign": ITERS} or replays != ITERS // KME_FUSE:
            fail(f"KME fused: launch counts {counts}, {replays} replays")
        dc = float(np.abs(m.centroids - serial.cluster_centers_).max())
        rel = abs(m.inertia - serial.inertia_) / abs(serial.inertia_)
        say(f"fused: kmeans  int16 fuse_steps {KME_FUSE} depth {depth} "
            + (f"{chunks[1][1] / chunks[1][0] * 1e3:.3f} ms/iteration (the "
               f"second chunk over its {chunks[1][0]} iterations); "
               if depth == 1 else "")
            + f"first chunk with the init draw and the capture "
            f"{chunks[0][1] * 1e3:.1f} ms; chunk graph: {graphs}; launch "
            f"counts {counts}, {replays} replays; against the serial fit: "
            f"n_iter {m.n_iters}, inertia rel {rel:.3g}, max |dC| "
            f"{dc:.3g} (on {smi})")
        if not (m.n_iters == serial.n_iter_ and rel <= 1e-4
                and np.allclose(m.centroids, serial.cluster_centers_,
                                rtol=1e-4, atol=1e-3)):
            fail("KME fused: beyond the fused-against-serial tolerances")
    profile = device_profile(torch, lambda: wl.fit(
        kme_ds, spec(fuse_steps=KME_FUSE)))
    gen = wl.fit_steps(kme_ds, spec(fuse_steps=KME_FUSE, pipeline_depth=1))
    next(gen)                          # the init draw and the first chunk
    say(f"profile: KME int16 fused, its second chunk ({KME_FUSE} "
        f"iterations): " + device_profile(torch, lambda: next(gen), top=10))
    gen.close()
    quality = {}
    for device in ("cuda", "cpu"):
        qs = make_system("pim", n_cores=N_CORES, device=device)
        quality[device] = (wl.fit(qs.put(Xq), spec(fuse_steps=KME_FUSE)
                                  ).model, qs.stats.snapshot())
    (g, gs), (c, cs) = quality["cuda"], quality["cpu"]
    if not (np.array_equal(g.centroids, c.centroids)
            and np.array_equal(g.labels, c.labels)
            and g.n_iters == c.n_iters and gs == cs):
        fail("KME fused: card and CPU fits differ at the quality size")
    say(f"fused: kmeans int16 at {KME_QUALITY:,} samples: card == cpu "
        f"(centroids, labels, n_iter {g.n_iters}, TransferStats)")
    return profile


def gini_round_times(torch, dispatch, fit):
    """CUDA-event ms of each gini_split launch inside ``fit()`` (the
    rounds with L2 as the fit leaves it), and the fit's result."""
    op = dispatch.get_op("gini_split")
    events = []

    def timed(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = op.cuda(*args)
        end.record()
        events.append((start, end))
        return out
    dispatch.register_op("gini_split", cuda=timed, plain=op.plain,
                         cost=op.cost)
    try:
        result = fit()
    finally:
        dispatch.register_op("gini_split", cuda=op.cuda, plain=op.plain,
                             cost=op.cost)
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in events], result


def lut_edges(n_table: int) -> list:
    """The inputs where lut_sigmoid's index arithmetic turns: 0, +-1, the
    table's last entry and the first past it, and the int32 extremes
    (|INT32_MIN| wraps)."""
    return [0, 1, -1, n_table - 1, -(n_table - 1), n_table, -n_table,
            INT32_MAX, INT32_MIN, INT32_MIN + 1]


def check_lut_sigmoid(torch, rng, lut, z) -> tuple[int, int]:
    """lut_sigmoid against its plain version in both placements: on the
    main shape ``z`` (which holds the edge values); then on inputs 4, 8
    and 12 bytes past a 16-byte boundary whose lengths are 1, 2 and 3
    past a multiple of 4, with each edge value in turn in the scalar
    head, the first vector and the scalar tail, under the paper's table
    and an odd one of LUT_ODD entries.  Returns the max abs error and
    the number of those cases."""
    from repro_torch.core.lut import SigmoidLut
    from repro_torch.kernels.lut_activation import (lut_sigmoid_cuda,
                                                    lut_sigmoid_plain)
    odd = SigmoidLut(lut.table[:LUT_ODD].clone(), lut.frac_bits,
                     lut.boundary, lut.value_frac)
    base = torch.from_numpy(rng.randint(-30000, 30000, LUT_RAGGED + 16)
                            .astype(np.int32)).to(z.device)
    cases = [(lut, z)]
    for table in (lut, odd):
        for off in (1, 2, 3):
            for rem in (1, 2, 3):
                n = LUT_RAGGED + rem
                head = (4 - off) % 4
                tail = (n - head) % 4
                for e in lut_edges(table.table.numel()):
                    xs = base.clone()[off:off + n]
                    xs[:head + 4] = e
                    if tail:
                        xs[n - tail:] = e
                    cases.append((table, xs))
    err = 0
    for table, xs in cases:
        for placement in ("wram", "mram"):
            out = lut_sigmoid_cuda(xs, table, placement)
            ref = lut_sigmoid_plain(xs, table)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                fail(f"lut_sigmoid[{placement}] kernel != plain at "
                     f"{xs.numel()} elements, {xs.data_ptr() % 16} B past "
                     f"an alignment, a table of {table.table.numel()}")
            err = max(err, int((out.long() - ref.long()).abs().max()))
    return err, len(cases) - 1


def log_fit_z(dispatch, make_estimator, ds) -> dict:
    """The z that a LOG int32_lut_wram fit of ITERS iterations over ``ds``
    hands ``lut_sigmoid`` at its first iteration (w = 0 there, so z = 0
    everywhere) and at its last, copied on the card."""
    op = dispatch.get_op("lut_sigmoid")
    seen = []

    def capture(z, *args, **kwargs):
        seen.append(z.clone())
        return op.cuda(z, *args, **kwargs)
    dispatch.register_op("lut_sigmoid", cuda=capture, plain=op.plain,
                         cost=op.cost)
    try:
        make_estimator("logreg", version="int32_lut_wram", n_iters=ITERS,
                       system=ds.system).fit(ds)
    finally:
        dispatch.register_op("lut_sigmoid", cuda=op.cuda, plain=op.plain,
                             cost=op.cost)
    return {"first": seen[0], "last": seen[-1]}


def device_profile(torch, fn, top: int = 6, host: bool = True,
                   watch: str = "") -> str:
    """Run ``fn`` under torch.profiler: the device's busy share of the
    wall time ``fn`` took inside the profiler (its start-up and the trace's
    processing at exit excluded) and the kernels with the most device
    time.  ``host=False`` traces the device only, which leaves the
    host's timings of ``fn`` nearly as they are.  ``watch``: also the
    device time of the kernels whose names hold it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA]
    if host:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.self_device_time_total / 1e3, e.key, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA), reverse=True)
    busy_ms = sum(t for t, _, _ in kernels)
    if not kernels:
        return f"{wall_ms:.1f} ms wall, no device time traced"
    watched = ""
    if watch:
        hits = [(t, n) for t, k, n in kernels if watch in k]
        watched = (f"; kernels named *{watch}*: "
                   f"{sum(t for t, _ in hits):.1f} ms in "
                   f"{sum(n for _, n in hits)} launches")
    return (f"{wall_ms:.1f} ms wall under the profiler, device busy "
            f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%){watched}; "
            f"top: " + "; ".join(f"{t:.1f} ms x{n} {k[:60]}"
                                 for t, k, n in kernels[:top]))


# -- the LM serving path (qwen3-8b) -------------------------------------------

def lm_requests(vocab: int) -> list:
    """The serve load: LM_REQUESTS prompts whose lengths and tokens are
    drawn by SEED, LM_NEW tokens each."""
    rng = np.random.RandomState(SEED)
    lens = rng.randint(LM_PROMPT_MIN, LM_PROMPT_MAX + 1, LM_REQUESTS)
    return [rng.randint(0, vocab, n).astype(np.int32) for n in lens]


def int8_operand(torch, gen, shape):
    """Full-range int8 on the card, -128 in its first three elements."""
    t = torch.randint(-128, 128, shape, generator=gen, device="cuda",
                      dtype=torch.int32).to(torch.int8)
    t.view(-1)[:3] = -128
    return t


def check_mha_cases(torch, cases, prefix: str) -> float:
    """mha_cuda against mha_plain for each ``(name, (q, k, v), kwargs)``,
    within MHA_BF16_ATOL (bf16) or MHA_F32_ATOL (float32); fails outside.
    Returns the max abs error."""
    from repro_torch.kernels.flash_attention import mha_cuda, mha_plain
    err = 0.0
    for name, (q, k, v), kw in cases:
        out, ref = mha_cuda(q, k, v, **kw), mha_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        if out.dtype != ref.dtype or out.shape != ref.shape:
            fail(f"flash_attention: {name}: dtype or shape differs")
        e = float((out.float() - ref.float()).abs().max())
        tol = MHA_BF16_ATOL if q.dtype == torch.bfloat16 else MHA_F32_ATOL
        if not e <= tol:
            fail(f"flash_attention: {name}: max abs err {e} > {tol}")
        err = max(err, e)
        say(f"{prefix}flash_attention ~ plain, {name} (max abs err {e:.3g}"
            f" <= {tol})")
    return err


def check_lm_kernels(torch, dev, gen, prompt_lens) -> tuple[int, float]:
    """int_matmul (exact on full-range int8, -128 included) at the MLP
    shapes of qwen3-8b for M = 1, 7, 16 and 17 (the streaming and
    tensor-core paths' boundary), 513 and the shortest and longest
    prompts, plus ragged and unaligned shapes on both paths;
    flash_attention (within MHA_BF16_ATOL / MHA_F32_ATOL of its plain
    version) on bf16 [1, 32, S, 128] over 16 KV heads for every prompt
    length S, causal and not, one-token decode with q_offset, a window,
    D = 64 and 80, GQA groups 1 and 4, and float32.  Returns the max abs
    errors."""
    from repro_torch.kernels.quant_matmul import (int_matmul_cuda,
                                                  int_matmul_plain,
                                                  int_matmul_plan)

    def int8(shape):
        return int8_operand(torch, gen, shape)
    err_mm = 0
    shapes = [(m, k, n) for m in (1, 7, 16, 17, 513, min(prompt_lens),
                                  max(prompt_lens))
              for k, n in LM_MLP_SHAPES] + [(33, 4099, 1000), (17, 61, 13),
                                            (5, 4099, 70)]
    for m, k, n in shapes:
        a, b = int8((m, k)), int8((k, n))
        err_mm = max(err_mm, same(torch, [int_matmul_cuda(a, b)],
                                  [int_matmul_plain(a, b)]))
    say(f"kernels: int_matmul == plain at (M, K, N) {shapes}")
    for m in (7, 40):                 # 1 byte past alignment: both paths
        flat = int8((1 + m * 64 + 64 * 36,))
        a, b = flat[1:1 + m * 64].view(m, 64), flat[1 + m * 64:].view(64, 36)
        err_mm = max(err_mm, same(torch, [int_matmul_cuda(a, b)],
                                  [int_matmul_plain(a, b)]))
        say(f"kernels: int_matmul == plain, unaligned ({m}, 64) @ (64, 36)"
            f" on the {int_matmul_plan(m, 36, 64).path} path")

    def qkv(b, hq, hkv, sq, skv, d, dtype):
        # [B, S, H, D] projections seen as [B, H, S, D], as _project_qkv does
        return [torch.randn((b, s, h, d), generator=gen, device=dev)
                .to(dtype).transpose(1, 2)
                for s, h in ((sq, hq), (skv, hkv), (skv, hkv))]
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(f"bf16 [1, 32, {s}, 128] over 16 KV heads, causal",
              qkv(1, 32, 16, s, s, 128, bf16), {}) for s in prompt_lens]
    s = int(prompt_lens[0])
    cases += [
        (f"bf16 [1, 32, {s}, 128], not causal",
         qkv(1, 32, 16, s, s, 128, bf16), {"causal": False}),
        (f"bf16 decode: 1 query at q_offset {s - 1} of {s} keys",
         qkv(1, 32, 16, 1, s, 128, bf16), {"q_offset": s - 1}),
        (f"bf16 [1, 32, {s}, 128], window 256",
         qkv(1, 32, 16, s, s, 128, bf16), {"window": 256}),
        ("bf16 [2, 8, 77, 64] over 2 KV heads (group 4), causal",
         qkv(2, 8, 2, 77, 77, 64, bf16), {}),
        ("bf16 [1, 8, 300, 80] over 8 KV heads (group 1), window 100",
         qkv(1, 8, 8, 300, 300, 80, bf16), {"window": 100}),
        ("f32 [2, 8, 300, 64] over 2 KV heads, causal",
         qkv(2, 8, 2, 300, 300, 64, f32), {}),
        ("f32 [1, 4, 5, 80], q_offset 255 of 260 keys, window 64",
         qkv(1, 4, 4, 5, 260, 80, f32), {"q_offset": 255, "window": 64}),
    ]
    return err_mm, check_mha_cases(torch, cases, "kernels: ")


class TimedModel:
    """A Model as the ServeEngine sees it, timing each synchronised
    prefill and decode call (host clock) and when each prefill ended."""

    def __init__(self, torch, model):
        self.torch, self.model, self.cfg = torch, model, model.cfg
        self.prefill_s, self.decode_s, self.prefill_end = [], [], []

    def prefill(self, params, batch, max_seq):
        t0 = time.perf_counter()
        out = self.model.prefill(params, batch, max_seq)
        self.torch.cuda.synchronize()
        t1 = time.perf_counter()
        self.prefill_s.append(t1 - t0)
        self.prefill_end.append(t1)
        return out

    def decode_step(self, params, tokens, cache, extras=None):
        t0 = time.perf_counter()
        out = self.model.decode_step(params, tokens, cache)
        self.torch.cuda.synchronize()
        self.decode_s.append(time.perf_counter() - t0)
        return out


def serve_timed(torch, Model, Request, ServeEngine, cfg, params,
                prompts, new: int = LM_NEW) -> dict:
    """Serve ``prompts`` (``new`` tokens each) through ServeEngine on the
    card: the outputs and time to first token, ms per decode call and
    tokens/s."""
    timed = TimedModel(torch, Model(cfg, device="cuda"))
    reqs = [Request(prompt=p, max_new_tokens=new) for p in prompts]
    engine = ServeEngine(timed, params, n_slots=LM_SLOTS, max_seq=LM_MAX_SEQ)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run(reqs)
    wall = time.perf_counter() - t0
    n_tok = sum(len(r.output) for r in reqs)
    return {"outputs": [r.output for r in reqs], "wall_s": wall,
            "tokens": n_tok, "tokens_per_s": n_tok / wall,
            "ttft_ms": [(t - t0) * 1e3 for t in timed.prefill_end],
            "prefill_ms": [t * 1e3 for t in timed.prefill_s],
            "decode_ms": statistics.median(timed.decode_s) * 1e3,
            "decode_calls": len(timed.decode_s)}


def serve_line(name: str, r: dict, prompts, smi: str,
               new: int = LM_NEW) -> str:
    return (f"serve: {name}: {len(prompts)} requests over {LM_SLOTS} slots, "
            f"prompts {[len(p) for p in prompts]}, {new} new tokens each:"
            f" {r['tokens']} tokens in {r['wall_s']:.2f} s, "
            f"{r['tokens_per_s']:.2f} tokens/s; time to first token "
            f"{', '.join(f'{t:.0f}' for t in r['ttft_ms'])} ms (prefill "
            f"alone {', '.join(f'{t:.0f}' for t in r['prefill_ms'])} ms); "
            f"{r['decode_ms']:.2f} ms per decode token (median of "
            f"{r['decode_calls']} batch-1 decode calls) on {smi}")


def lm_serve_on_card(torch, dispatch, smi: str) -> dict:
    """qwen3-8b at full width and depth in bf16 with quantize_dense on,
    random weights from SEED, served through Model and ServeEngine with
    the launch counts zeroed just before and checked exactly after; then
    the same load with quantize_dense off (no int_matmul launches); the
    card's busy share over decode steps; and prefill + one decode step
    against the forward's last position (quantize_dense off, the repo's
    own property, tests/test_arch_smoke.py)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.api import Model
    from repro_torch.models.transformer import attn_spec
    from repro_torch.serve.engine import Request, ServeEngine
    base = get_config(LM_ARCH)
    cfg_q = dataclasses.replace(base, quantize_dense=True)
    t0 = time.perf_counter()
    model = Model(cfg_q, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = Model.param_count(params)
    plan = attn_spec(cfg_q).plan
    say(f"model: {LM_ARCH} at full width: {cfg_q.n_layers} layers, d_model "
        f"{cfg_q.d_model}, {cfg_q.n_heads} query / {cfg_q.n_kv_heads} KV "
        f"heads (padded to {plan.n_q} / {plan.n_kv}), d_ff {cfg_q.d_ff}, vocab "
        f"{cfg_q.vocab_size}, {cfg_q.dtype}, {n_params:,} parameters drawn "
        f"in {time.perf_counter() - t0:.1f} s; device memory "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB")
    prompts = lm_requests(cfg_q.vocab_size)
    calls = LM_REQUESTS + LM_REQUESTS * (LM_NEW - 1)
    expected = {"int_matmul": 3 * cfg_q.n_layers * calls,
                "mha": cfg_q.n_layers * LM_REQUESTS}
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    on = serve_timed(torch, Model, Request, ServeEngine, cfg_q, params,
                     prompts)
    torch.cuda.synchronize()
    counts = dict(dispatch.launch_counts)
    say(f"launch counts on the main path (quantize_dense on): {counts} "
        f"(expected {expected}: 3 per layer per forward call over "
        f"{LM_REQUESTS} prefills + {calls - LM_REQUESTS} decode calls, 1 "
        f"per layer per prefill)")
    if counts != expected:
        fail(f"qwen3-8b serve launch counts {counts} != {expected}")
    if any(len(o) != LM_NEW or not all(0 <= t < cfg_q.vocab_size for t in o)
           for o in on["outputs"]):
        fail("qwen3-8b serve: an output has the wrong length or an id "
             "outside the vocabulary")
    say(serve_line("qwen3-8b quantize_dense on", on, prompts, smi)
        + f"; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")

    cfg_f = dataclasses.replace(base, quantize_dense=False)
    dispatch.reset_launch_counts()
    off = serve_timed(torch, Model, Request, ServeEngine, cfg_f, params,
                      prompts)
    torch.cuda.synchronize()
    if dict(dispatch.launch_counts) != {"mha": expected["mha"]}:
        fail(f"quantize_dense off: launch counts {dispatch.launch_counts}")
    say(serve_line("qwen3-8b quantize_dense off (same weights)", off,
                   prompts, smi))
    agree = sum(a == b for x, y in zip(on["outputs"], off["outputs"])
                for a, b in zip(x, y))
    say(f"  greedy tokens equal with quantize_dense on and off: {agree} of "
        f"{on['tokens']}")

    # the card's busy share over decode steps, quantize_dense on and off,
    # the device traced alone, as the families' are (with the host traced
    # too, each profile took ~25-30 s to process)
    profiles = {}
    for name, cfg in (("on", cfg_q), ("off", cfg_f)):
        profiles[name] = family_profile(torch, Model(cfg, device="cuda"),
                                        params, prompts[0])
        say(f"profile: {LM_PROFILE_STEPS} decode steps, quantize_dense "
            f"{name}: {profiles[name]}")

    # prefill + one decode step == the forward's last position (the repo's
    # property, tests/test_arch_smoke.py), in bf16 and then, the same
    # weights cast exactly to float32, at the repo's float32 tolerance
    toks = prompts[0][None]
    for cfg, (atol, rtol) in ((cfg_f, (LM_BF16_TOL, 0.0)),
                              (dataclasses.replace(cfg_f, dtype="float32"),
                               (LM_F32_PROPERTY_TOL, LM_F32_PROPERTY_TOL))):
        if cfg.dtype == "float32":
            params.float()                    # in place: frees the bf16
        m = Model(cfg, device="cuda")
        _, cache = m.prefill(params, {"tokens": toks[:, :-1]}, LM_MAX_SEQ)
        dec, _ = m.decode_step(params, toks[:, -1:], cache)
        full = m.forward(params, {"tokens": toks})[:, -1]
        dec, full = dec[:, 0].float(), full.float()
        if not bool(torch.isfinite(full).all()):
            fail(f"qwen3-8b forward ({cfg.dtype}): non-finite logits")
        diff = (dec - full).abs()
        ok = bool((diff <= atol + rtol * full.abs()).all())
        say(f"  prefill({toks.shape[1] - 1}) + decode == forward's last "
            f"position at full width, {cfg.dtype}: {ok} (max |dlogit| "
            f"{float(diff.max()):.4g}, RMS logit "
            f"{float(full.square().mean().sqrt()):.4g}, max |logit| "
            f"{float(full.abs().max()):.4g}; atol {atol}, rtol {rtol}; argmax "
            f"{int(dec.argmax())} vs {int(full.argmax())})")
        if not ok:
            fail(f"qwen3-8b {cfg.dtype}: prefill + decode disagrees with "
                 f"the forward")
    del params, cache, full, dec
    torch.cuda.empty_cache()
    return {"on": on, "off": off, "counts": counts, "profiles": profiles,
            "prompts": prompts}


def lm_card_equals_cpu(torch) -> None:
    """qwen3-8b reduced, float32, the same weights on the card and the CPU:
    with quantize_dense off the greedy tokens are identical and the
    forward logits within LM_F32_ATOL; with it on the logits are within
    LM_QUANT_ATOL (one int8 rounding step, tests/test_torch_lm.py) and the
    token agreement is printed."""
    import copy
    from repro_torch.configs.base import get_config
    from repro_torch.models.api import Model
    from repro_torch.serve.engine import Request, ServeEngine
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(0, 512, n).astype(np.int32) for n in (40, 9, 77,
                                                                 23)]
    toks = rng.randint(0, 512, (2, 48)).astype(np.int32)
    for quantize in (False, True):
        cfg = get_config(LM_ARCH).reduced(quantize_dense=quantize)
        weights = Model(cfg, device="cpu").init(
            torch.Generator().manual_seed(SEED))
        res = {}
        for device in ("cuda", "cpu"):
            model = Model(cfg, device=device)
            params = copy.deepcopy(weights).to(device)
            reqs = [Request(prompt=p, max_new_tokens=12) for p in prompts]
            ServeEngine(model, params, n_slots=2, max_seq=128).run(reqs)
            logits = model.forward(params, {"tokens": toks}).cpu()
            res[device] = ([r.output for r in reqs], logits)
        (tg, lg), (tc, lc) = res["cuda"], res["cpu"]
        err = float((lg - lc).abs().max())
        agree = sum(a == b for x, y in zip(tg, tc) for a, b in zip(x, y))
        tol = LM_QUANT_ATOL if quantize else LM_F32_ATOL
        say(f"  {LM_ARCH} reduced f32, quantize_dense "
            f"{'on' if quantize else 'off'}: card vs CPU forward max "
            f"|dlogit| {err:.3g} (tolerance {tol}); greedy tokens equal "
            f"{agree} of {sum(len(t) for t in tg)}")
        if not err <= tol:
            fail(f"reduced {LM_ARCH}: card and CPU logits disagree")
        if not quantize and tg != tc:
            fail(f"reduced {LM_ARCH}: card and CPU greedy tokens differ")


def lm_kernel_times(torch, flush, prompt_lens) -> dict:
    """int_matmul at decode (M = 1) and at the shortest and longest
    prefills, both MLP shapes, and flash_attention at the longest prefill:
    kernel, plain, bound and the nearest PyTorch call (torch._int_mm where
    its shape rules allow; F.scaled_dot_product_attention with
    enable_gqa), with the achieved rate (TOP/s or TFLOP/s, the bound's
    operations over the kernel's time), its share of the bound, and the
    host's microseconds per wrapper call."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import mha_cuda, mha_plain
    from repro_torch.kernels.quant_matmul import (int_matmul_cuda,
                                                  int_matmul_plain)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    for m in (1, min(prompt_lens), max(prompt_lens)):
        for k, n in LM_MLP_SHAPES:
            a = torch.randint(-128, 128, (m, k), generator=gen, device="cuda",
                              dtype=torch.int32).to(torch.int8)
            b = torch.randint(-128, 128, (k, n), generator=gen, device="cuda",
                              dtype=torch.int32).to(torch.int8)
            t = dict(ms=cuda_ms(torch, lambda: int_matmul_cuda(a, b), flush),
                     plain_ms=cuda_ms(torch, lambda: int_matmul_plain(a, b),
                                      flush))
            t["bound_ms"], t["bound_by"] = bound(
                m * k + k * n + 4 * m * n, 2 * m * k * n, PEAK_INT8_OPS_PER_S)
            # torch._int_mm: M > 16, K and N multiples of 8
            t["library_ms"] = (cuda_ms(torch, lambda: torch._int_mm(a, b),
                                       flush)
                               if m > 16 and k % 8 == 0 and n % 8 == 0
                               else None)
            t["tops"] = 2 * m * k * n / t["ms"] / 1e9
            t["bound_share"] = t["bound_ms"] / t["ms"]
            t["host_us"] = host_us(torch, lambda: int_matmul_cuda(a, b))
            out["int_matmul", m, k, n] = t
    s = max(prompt_lens)
    q, k, v = [torch.randn((1, s, h, 128), generator=gen, device="cuda")
               .to(torch.bfloat16).transpose(1, 2) for h in (32, 16, 16)]
    pairs = s * (s + 1) // 2 * 32                 # unmasked (query, key)
    t = dict(ms=cuda_ms(torch, lambda: mha_cuda(q, k, v), flush),
             plain_ms=cuda_ms(torch, lambda: mha_plain(q, k, v), flush),
             library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                 q, k, v, is_causal=True, enable_gqa=True), flush))
    t["bound_ms"], t["bound_by"] = bound(
        2 * (q.numel() * 2 + k.numel() * 2), 4 * 128 * pairs,
        PEAK_BF16_FLOPS)
    t["tflops"] = 4 * 128 * pairs / t["ms"] / 1e9
    t["bound_share"] = t["bound_ms"] / t["ms"]
    t["host_us"] = host_us(torch, lambda: mha_cuda(q, k, v))
    out["flash_attention",] = t
    return out


#: the compare's kernels: those its pim rows run (LIN/LOG int32, KME
#: int16, DTR, EMB int32), DTR's and EMB's also in the host and gpu-model
#: rows
COMPARE_KERNELS = ("fx_matvec", "lut_sigmoid", "kmeans_assign", "gini_split",
                   "emb_gather", "emb_scatter_add")


def compare_on_card(torch, dispatch, smi: str) -> dict:
    """Phase 7: the three-way compare at its CLI defaults on the card,
    then the tiny compare on the card against the CPU.  Returns the
    launch counts of the full run."""
    from repro_torch.launch.compare import render_compare_table, run_compare
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    record = run_compare(tiny=False, cores=16, device="cuda")
    torch.cuda.synchronize()
    counts = dict(dispatch.launch_counts)
    say(f"compare: the full run in {time.perf_counter() - t0:.1f} s; "
        f"launch counts {counts}")
    say(render_compare_table(record))
    rows = {(r["workload"], r["system"]): r for r in record["rows"]}
    if len(rows) != 15 or record["meta"]["gpu"] != smi:
        fail(f"compare: {len(rows)} rows on {record['meta']['gpu']}")
    for (workload, kind), row in rows.items():
        if not row["modeled_s"] > 0:
            fail(f"compare {workload} {kind}: modeled_s {row['modeled_s']}")
        if kind == "host" and row["score"] != rows[workload,
                                                  "gpu-model"]["score"]:
            fail(f"compare {workload}: host score {row['score']} != "
                 f"gpu-model {rows[workload, 'gpu-model']['score']}")
    missing = [k for k in COMPARE_KERNELS if not counts.get(k)]
    if missing:
        fail(f"compare: kernels not launched: {missing}")
    say("compare rows: " + json.dumps([
        {k: r.get(k) for k in ("workload", "system", "version", "wall_s",
                               "modeled_s", "drift_ratio", "score",
                               "kernel_launches", "iterations",
                               "modeled_kernel_s", "modeled_transfer_s",
                               "modeled_flops", "modeled_hbm_bytes")}
        for r in record["rows"]]))
    t0 = time.perf_counter()
    tiny = {dev: {(r["workload"], r["system"]): r for r in run_compare(
        tiny=True, cores=4, device=dev)["rows"]} for dev in ("cuda", "cpu")}
    fields = {"pim": ("iterations", "cpu_to_pim_bytes", "pim_to_cpu_bytes",
                      "modeled_s", "modeled_kernel_s", "modeled_transfer_s"),
              "gpu-model": ("modeled_launches", "modeled_flops",
                            "modeled_hbm_bytes")}
    for key, row in tiny["cuda"].items():
        other = tiny["cpu"][key]
        check = list(fields.get(key[1], ()))
        if key[1] == "pim" and key[0] != "dtree":      # the integer rows
            check.append("score")
        for field in check:
            if row[field] != other[field]:
                fail(f"tiny compare {key} {field}: card {row[field]} != "
                     f"cpu {other[field]}")
    say(f"compare: tiny (4 cores) card == cpu in "
        f"{time.perf_counter() - t0:.1f} s: integer pim scores, iterations, "
        f"transfer bytes and modeled seconds; gpu-model launches, flops "
        f"and bytes (" + ", ".join(
            f"{w} {tiny['cuda'][w, 'gpu-model']['modeled_launches']} / "
            f"{tiny['cuda'][w, 'gpu-model']['modeled_flops']:.6g} / "
            f"{tiny['cuda'][w, 'gpu-model']['modeled_hbm_bytes']:.6g}"
            for w in ("linreg", "logreg", "dtree", "kmeans", "emb")) + ")")
    return counts


def lane_kernel_on_card(torch, dispatch, rng, flush, smi: str) -> dict:
    """Phase 8a: fx_matvec with lanes against its plain version at the
    gang's shape for every LANE_KS and on full-range wrapping operands
    over F = 13 (the scalar path); K = 1 and K = 8 timed beside their
    declared bounds.  Returns the lane entries of the kernel table."""
    from repro_torch.kernels.quant_matmul import (fx_matvec_cuda,
                                                  fx_matvec_plain)

    def ints(shape, lo, hi):
        return torch.from_numpy(rng.randint(lo, hi, shape, dtype=np.int64)
                                .astype(np.int32)).to("cuda")
    n_pc = N_SAMPLES // N_CORES
    x = ints((N_CORES, n_pc, N_FEATURES), -(16 << 10), 16 << 10)
    wide = ints((1_000_003, 13), INT32_MIN, INT32_MAX)
    err = 0
    for k in LANE_KS:
        for xs, ws in ((x, ints((k, N_FEATURES), -(4 << 10), 4 << 10)),
                       (wide, ints((k, 13), INT32_MIN, INT32_MAX))):
            out = fx_matvec_cuda(xs, ws, 10)
            ref = fx_matvec_plain(xs, ws, 10)
            err = max(err, same(torch, [out], [ref]))
            del out, ref
    say(f"lanes: fx_matvec == plain for K in {LANE_KS} at "
        f"{tuple(x.shape)} and on full-range operands at "
        f"{tuple(wide.shape)} (max abs err {err})")
    out = {"lanes_max_abs_err": err}
    for k in (1, 8):
        w = ints((k, N_FEATURES), -(4 << 10), 4 << 10)
        t = dict(ms=cuda_ms(torch, lambda: fx_matvec_cuda(x, w, 10), flush),
                 plain_ms=cuda_ms(torch, lambda: fx_matvec_plain(x, w, 10),
                                  flush))
        t["bound_ms"], t["bound_by"] = declared_bound("fx_matvec", x, w, 10)
        cost = dispatch.declared_cost("fx_matvec", x, w, 10)
        say(f"timing: fx_matvec K={k} lanes at {tuple(x.shape)} "
            f"{t['ms']:.4f} ms ({100 * t['bound_ms'] / t['ms']:.1f}% of "
            f"the bound), plain {t['plain_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {cost.bytes:.4g} B, "
            f"{cost.ops:.4g} int32 ops) on {smi}")
        out[f"k{k}"] = t
    return out


def run_gang(torch, gang, per_step: bool = False) -> list:
    """Step ``gang`` to its end; the wall seconds of each step (each
    ending in a synchronize when ``per_step``, else one for the run)."""
    times, t0 = [], time.perf_counter()
    while not gang.done:
        gang.step()
        if per_step:
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
    torch.cuda.synchronize()
    return times or [time.perf_counter() - t0]


def gang_on_card(torch, dispatch, make_estimator, get_workload, system,
                 lin_ds, log_ds, smi: str) -> dict:
    """Phase 8b, e and f: the 8-point LIN int32 sweep through
    FusedGdSweep (each lane bit-identical to a serial card fit; 10 map_*
    launches and 10 fx_matvec launches against 80 for the serial fits);
    the 4-point LOG int32_lut_wram sweep with lane 1 cancelled after
    GANG_CANCEL_AT iterations; the LIN sweep at fuse_steps GANG_FUSE (two
    chunk replays, equal to the unchunked gang); the LIN gang traced
    (a valid Chrome trace, one map_reduce span a step); the per-step
    seconds through StragglerMonitor."""
    import tempfile

    from repro_torch.obs import (TRACER, summarize, validate_chrome_trace,
                                 write_chrome_trace)
    from repro_torch.sched import FusedGdSweep
    from repro_torch.train.fault_tolerance import StragglerMonitor
    lin, log = get_workload("linreg"), get_workload("logreg")

    def gang(wl, version, lrs, ds, **params):
        return FusedGdSweep(wl, [wl.spec(version, lr=lr, n_iters=ITERS,
                                         **params) for lr in lrs], ds)

    def serial(workload, version, lrs, ds, n_iters=ITERS):
        return [make_estimator(workload, version=version, lr=lr,
                               n_iters=n_iters, system=system).fit(ds)
                for lr in lrs]

    run_gang(torch, gang(lin, "int32", GANG_LIN_LRS, lin_ds))   # warm-up
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    dispatch.reset_launch_counts()
    snap = system.stats.snapshot()
    g = gang(lin, "int32", GANG_LIN_LRS, lin_ds)
    dt = sum(run_gang(torch, g))
    counts = dict(dispatch.launch_counts)
    launches = system.stats.delta(snap).kernel_launches
    peak = torch.cuda.max_memory_allocated() - base
    dispatch.reset_launch_counts()
    dt_serial, fits = timed(torch, lambda: serial("linreg", "int32",
                                                  GANG_LIN_LRS, lin_ds))
    serial_counts = dict(dispatch.launch_counts)
    k = len(GANG_LIN_LRS)
    say(f"gang: LIN int32 {k} lanes {dt / ITERS * 1e3:.3f} ms/iteration, "
        f"the {k} serial fits {dt_serial / ITERS * 1e3:.3f} ms per "
        f"iteration of all {k} ({dt_serial / dt:.2f}x); launch counts "
        f"{counts} ({launches} map_* calls) against {serial_counts}; peak "
        f"{peak / 2 ** 30:.2f} GiB above the resident data "
        f"(torch.cuda.max_memory_allocated) at {N_SAMPLES}x{N_FEATURES} "
        f"over {N_CORES} cores on {smi}")
    if counts != {"fx_matvec": ITERS} or launches != ITERS \
            or serial_counts != {"fx_matvec": k * ITERS}:
        fail(f"gang: launch counts {counts}, {launches} launches, serial "
             f"{serial_counts}")
    for lane, est in enumerate(fits):
        r = g.result(lane).model
        if not (np.array_equal(r.w, est.coef_) and r.b == est.intercept_):
            fail(f"gang: LIN lane {lane} differs from its serial card fit")
    say(f"gang: every LIN lane == its serial card fit (lr {GANG_LIN_LRS})")

    dispatch.reset_launch_counts()
    lg = gang(log, "int32_lut_wram", GANG_LOG_LRS, log_ds)
    while not lg.done:
        lg.step()
        if lg.it == GANG_CANCEL_AT:
            lg.deactivate(1)
    torch.cuda.synchronize()
    log_counts = dict(dispatch.launch_counts)
    if log_counts != {"fx_matvec": ITERS, "lut_sigmoid": ITERS}:
        fail(f"gang: LOG launch counts {log_counts}")
    frozen = serial("logreg", "int32_lut_wram", [GANG_LOG_LRS[1]], log_ds,
                    n_iters=GANG_CANCEL_AT)[0]
    if lg.result(1) is not None or not np.array_equal(
            lg.lane_state(1)["arrays"]["w"], frozen.coef_):
        fail("gang: the cancelled LOG lane did not freeze")
    for lane, est in zip((0, 2, 3), serial(
            "logreg", "int32_lut_wram",
            [GANG_LOG_LRS[i] for i in (0, 2, 3)], log_ds)):
        r = lg.result(lane).model
        if not (np.array_equal(r.w, est.coef_) and r.b == est.intercept_):
            fail(f"gang: LOG lane {lane} differs from its serial card fit")
    say(f"gang: LOG int32_lut_wram {len(GANG_LOG_LRS)} lanes, lane 1 "
        f"cancelled after iteration {GANG_CANCEL_AT}: frozen there, lanes "
        f"0, 2, 3 == their serial card fits; launch counts {log_counts}")

    dispatch.reset_launch_counts()
    syncs = system.stats.host_syncs
    fg = gang(lin, "int32", GANG_LIN_LRS, lin_ds, fuse_steps=GANG_FUSE)
    dt_fused = sum(run_gang(torch, fg))
    fused_counts = dict(dispatch.launch_counts)
    replays = sum(dispatch.graph_replays.values())
    chunks = system.stats.host_syncs - syncs
    if fused_counts != counts or replays != chunks or chunks != -(
            -ITERS // GANG_FUSE):
        fail(f"gang fused: launch counts {fused_counts}, {replays} "
             f"replays, {chunks} chunks")
    for lane in range(k):
        a, b = fg.result(lane).model, g.result(lane).model
        if not (np.array_equal(a.w, b.w) and a.b == b.b):
            fail(f"gang fused: lane {lane} differs from the unchunked gang")
    say(f"gang: LIN at fuse_steps {GANG_FUSE}: {replays} chunk replays, "
        f"every lane == the unchunked gang; {dt_fused / ITERS * 1e3:.3f} "
        f"ms/iteration with its capture")

    # untraced and traced gangs in turns (off, on, on, off, ...); the
    # last traced gang's events are the trace
    per_it = {False: [], True: []}
    for traced in TRACE_TURNS:
        TRACER.clear()
        if traced:
            TRACER.enable()
        try:
            tg = gang(lin, "int32", GANG_LIN_LRS, lin_ds)
            per_it[traced].append(sum(run_gang(torch, tg)) / ITERS * 1e3)
            if traced:
                events = TRACER.events()
        finally:
            TRACER.disable()
            TRACER.clear()
    with tempfile.TemporaryDirectory() as tmp:
        doc = write_chrome_trace(events, str(Path(tmp) / "gang.json"))
    validate_chrome_trace(doc)
    name = f"map_reduce:{tg.kernel}"
    spans = sum(1 for e in events if e["name"] == name)
    if spans != ITERS:
        fail(f"trace: {spans} {name!r} spans for {ITERS} gang steps")
    say(f"trace: the LIN gang traced, a valid Chrome trace of "
        f"{len(events)} events; per track " + json.dumps(summarize(doc))
        + f"; {spans} {name!r} spans (one a step; a span times the "
        f"enqueue); ms/iteration in turns, traced "
        f"{' '.join(f'{t:.3f}' for t in per_it[True])}, untraced "
        f"{' '.join(f'{t:.3f}' for t in per_it[False])}")

    steps = run_gang(torch, gang(lin, "int32", GANG_LIN_LRS, lin_ds),
                     per_step=True)
    monitor = StragglerMonitor()
    flags = [monitor.observe(t) for t in steps]
    say(f"straggler: {monitor.flagged} of {len(steps)} gang steps flagged "
        f"(steps {' '.join(f'{t * 1e3:.2f}' for t in steps)} ms, each "
        f"ending in a synchronize; flags {flags})")
    return {"gang_ms_per_iteration": dt / ITERS * 1e3,
            "serial_ms_per_iteration": dt_serial / ITERS * 1e3,
            "gang_traced_ms_per_iteration": per_it[True],
            "gang_untraced_ms_per_iteration": per_it[False],
            "gang_launches": counts["fx_matvec"],
            "serial_launches": serial_counts["fx_matvec"],
            "gang_peak_bytes": peak}


def slices_on_card(torch, make_system, make_estimator, X, y, Xc, yc,
                   smi: str) -> None:
    """Phase 8c: two SLICE_CORES-core slices of an N_CORES-core machine
    leased through BankAllocator; LIN int32 on one, LOG int32_lut_wram on
    the other, each bit-identical to its fit on a standalone
    SLICE_CORES-core system; the parent's TransferStats the sum of the
    slices' deltas."""
    import dataclasses as dc

    from repro_torch.sched import BankAllocator
    parent = make_system("pim", n_cores=N_CORES, device="cuda")
    alloc = BankAllocator(N_CORES, rank_size=SLICE_RANK)
    leases = [alloc.allocate(SLICE_CORES) for _ in range(2)]
    deltas = []
    for lease, (workload, version, Xw, yw) in zip(leases, (
            ("linreg", "int32", X, y), ("logreg", "int32_lut_wram", Xc,
                                        yc))):
        sl = parent.slice(lease)
        snap = sl.stats.snapshot()
        t, got = timed(torch, lambda: make_estimator(
            workload, version=version, n_iters=ITERS, system=sl).fit(
                sl.put(Xw, yw)))
        deltas.append(sl.stats.delta(snap))
        alone = make_system("pim", n_cores=SLICE_CORES, device="cuda")
        want = make_estimator(workload, version=version, n_iters=ITERS,
                              system=alone).fit(alone.put(Xw, yw))
        if not (np.array_equal(got.coef_, want.coef_)
                and got.intercept_ == want.intercept_
                and sl.stats.snapshot() == alone.stats.snapshot()):
            fail(f"slices: {workload} {version} on cores [{lease.start}, "
                 f"{lease.stop}) differs from a standalone system")
        say(f"slices: {workload} {version} on cores [{lease.start}, "
            f"{lease.stop}) (ranks {lease.ranks[0]}-{lease.ranks[-1]}) == "
            f"a standalone {SLICE_CORES}-core system, weights and "
            f"TransferStats; {t:.2f} s with the put")
    for f in dc.fields(parent.stats):
        if getattr(parent.stats, f.name) != sum(getattr(d, f.name)
                                                 for d in deltas):
            fail(f"slices: parent {f.name} is not the slices' sum")
    say(f"slices: the parent's TransferStats == the sum of the slices' "
        f"deltas: {parent.stats}")
    say(f"slices: occupied {alloc.fragmentation()}")
    for lease in leases:
        alloc.release(lease)
    say(f"slices: released {alloc.fragmentation()} on {smi}")


def elastic_on_card(torch, dispatch, get_workload, system, lin_ds, kme_ds,
                    lin_ref, kme_ref, smi: str) -> None:
    """Phase 8d: LIN int32 snapshotted at iteration SNAPSHOT_LIN_AT and
    KME int16 after SNAPSHOT_KME_AT iterations (its MT19937 state in the
    snapshot) through elastic.save_snapshot, resumed through
    fit_steps(state=load_snapshot(...)[0]): each bit-identical to its
    uninterrupted phase-4 fit."""
    import tempfile

    from repro_torch.elastic import load_snapshot, save_snapshot
    cases = (("linreg", lin_ds, SNAPSHOT_LIN_AT,
              get_workload("linreg").spec("int32", n_iters=ITERS)),
             ("kmeans", kme_ds, SNAPSHOT_KME_AT,
              get_workload("kmeans").spec(
                  "int16", n_clusters=KME_K, n_init=1, max_iter=ITERS,
                  tol=0.0)))
    for workload, ds, at, spec in cases:
        wl = get_workload(workload)
        gen = wl.fit_steps(ds, spec)
        for _ in range(at):
            tick = next(gen)
        snap = tick.snapshot()
        gen.close()
        with tempfile.TemporaryDirectory() as tmp:
            path = save_snapshot(tmp, snap, envelope={
                "workload": workload, "version": spec.version,
                "system_kind": system.kind,
                "iters": snap["meta"]["iters"]})
            state, envelope = load_snapshot(tmp)
        dispatch.reset_launch_counts()
        gen = wl.fit_steps(ds, spec, state=state)
        while True:
            try:
                next(gen)
            except StopIteration as stop:
                res = stop.value
                break
        torch.cuda.synchronize()
        counts = dict(dispatch.launch_counts)
        if workload == "linreg":
            ok = (np.array_equal(res.attributes["coef_"], lin_ref[0])
                  and res.attributes["intercept_"] == lin_ref[1])
        else:
            ok = ("rng_mt_keys" in state["arrays"] and np.array_equal(
                res.attributes["cluster_centers_"],
                kme_ref.cluster_centers_)
                and np.array_equal(res.attributes["labels_"],
                                   kme_ref.labels_))
        if not ok:
            fail(f"elastic: the resumed {workload} fit differs from the "
                 f"uninterrupted one")
        say(f"elastic: {workload} {spec.version} snapshotted at iteration "
            f"{snap['meta']['iters']} ({Path(path).name}, "
            f"{len(state['arrays'])} arrays: {sorted(state['arrays'])}), "
            f"resumed == uninterrupted; launch counts of the resumed part "
            f"{counts} on {smi}")


# -- phase 9: the training service --------------------------------------------

def service_sizes(n_cores: int) -> dict:
    """Phase 9's leases: LIN and the fused gang half the machine each;
    LOG, KME, DTR and the priority job a quarter each."""
    half, quarter = n_cores // 2, n_cores // 4
    return {"lin": half, "log": quarter, "kme": quarter, "dtr": quarter,
            "gang": half, "priority": quarter}


def service_specs(data: dict, iters: int, depth: int,
                  fuse: int = SERVICE_FUSE) -> dict:
    """name -> (workload, (X, y), version, hyperparameters) of every
    phase-9 job but the gang's lanes."""
    lin, log = data["lin"], data["log"]
    return {
        "lin": ("linreg", lin, "int32", {"n_iters": iters}),
        "log": ("logreg", log, "int32_lut_wram", {"n_iters": iters}),
        "kme": ("kmeans", (data["kme"], None), "int16",
                {"n_clusters": KME_K, "max_iter": iters, "tol": 0.0}),
        "dtr": ("dtree", log, "fp32", {"max_depth": depth}),
        "priority": ("linreg", lin, "int32",
                     {"n_iters": iters, "fuse_steps": fuse}),
    }


def turn_states(sched) -> list:
    """Every job's state, turns, iterations and lease."""
    return [(h.name, h.state.value, h.steps, h.iters,
             None if h.lease is None else (h.lease.start, h.lease.n_cores))
            for h in sched.handles]


def service_drain(sched, data: dict, sizes: dict, iters: int, depth: int,
                  priority_at: int = SERVICE_PRIORITY_AT) -> dict:
    """Phase 9's queue, drained one turn at a time: LIN int32, LOG
    int32_lut_wram, KME int16 and DTR, the fused 8-point LIN int32 gang
    (GANG_LIN_LRS), then after ``priority_at`` turns a priority-1 LIN
    int32 job at fuse_steps SERVICE_FUSE, which evicts a priority-0 job.
    Returns the handles by name, each turn's states, wall seconds and
    the scheduler's own seconds (the turn's wall outside its jobs'
    chunks), and the TransferStats a preempted job settled before it
    resumed (its handle then keeps only the resumed run's delta)."""
    specs = service_specs(data, iters, depth)
    handles = {}
    for name in ("lin", "log", "kme", "dtr"):
        workload, d, version, params = specs[name]
        handles[name] = sched.submit(workload, d, version=version,
                                     n_cores=sizes[name], name=name,
                                     **params)
    lanes = sched.sweep("linreg", data["lin"], {"lr": list(GANG_LIN_LRS)},
                        version="int32", n_iters=iters,
                        n_cores=sizes["gang"], fused=True)
    handles.update((f"gang{i}", h) for i, h in enumerate(lanes))
    log, turns, own, segments = [], [], [], []
    preempted = {}

    def in_chunks():     # gang lanes each see their shared chunk's time
        return sum(h.measured_seconds for n, h in handles.items()
                   if not n.startswith("gang") or n == "gang0")

    more = True
    while more:
        if len(turns) == priority_at:
            workload, d, version, params = specs["priority"]
            handles["priority"] = sched.submit(
                workload, d, version=version, n_cores=sizes["priority"],
                priority=1, name="priority", **params)
        inside = in_chunks()
        t0 = time.perf_counter()
        more = sched.step()
        turns.append(time.perf_counter() - t0)
        own.append(turns[-1] - (in_chunks() - inside))
        log.append(turn_states(sched))
        for h in sched.handles:
            if h.preemptions > preempted.get(h.name, 0):
                preempted[h.name] = h.preemptions
                segments.append(h.transfer)
    return {"handles": handles, "log": log, "turns": turns, "own": own,
            "segments": segments}


def same_fit(got, want) -> bool:
    """Two FitResults: weights, centroids, labels and trees bit for bit
    (the int16 inertia, a float32 sum, to 1e-6)."""
    if got is None or sorted(got.attributes) != sorted(want.attributes):
        return False
    for key, w in want.attributes.items():
        g = got.attributes[key]
        if key == "tree_":
            ok = all(np.array_equal(getattr(g, f), getattr(w, f))
                     for f in TREE_FIELDS)
        elif key == "inertia_":
            ok = bool(np.isclose(g, w, rtol=1e-6, atol=0.0))
        else:
            ok = np.array_equal(np.asarray(g), np.asarray(w))
        if not ok:
            return False
    return True


def standalone_fits(torch, make_system, get_workload, data: dict,
                    sizes: dict, iters: int, depth: int) -> dict:
    """Each phase-9 job fitted alone on a card PimSystem of its lease's
    size (each gang lane as its serial fit), one after another, as one
    user would: one system a size, one dataset a (size, data) pair, so
    the first fit on a dataset builds its views.  name -> (FitResult,
    wall seconds)."""
    out, systems, datasets = {}, {}, {}
    specs = service_specs(data, iters, depth)
    specs.update((f"gang{i}", ("linreg", data["lin"], "int32",
                               {"n_iters": iters, "lr": lr}))
                 for i, lr in enumerate(GANG_LIN_LRS))
    for name, (workload, (X, y), version, params) in specs.items():
        size = sizes["gang" if name.startswith("gang") else name]
        if size not in systems:
            systems[size] = make_system("pim", n_cores=size, device="cuda")
        key = (size, id(X))
        if key not in datasets:
            datasets[key] = systems[size].put(X, y)
        wl = get_workload(workload)
        seconds, result = timed(torch, lambda: wl.fit(
            datasets[key], wl.spec(version, **params)))
        out[name] = (result, seconds)
    return out


def service_on_card(torch, dispatch, make_system, get_workload, data: dict,
                    smi: str) -> dict:
    """Phase 9: the training service on the card.

    (a) A drain: one PimScheduler over N_CORES cores (rank SERVICE_RANK,
    the deadline policy, preemptive) runs service_drain's queue with the
    launch counts zeroed just before it.  Every job DONE without an
    error, no retry and no serve error; each job and gang lane
    bit-identical to its standalone card fit; launch counts exactly what
    the iterations imply (the gang one fx_matvec launch a step for its 8
    lanes, the evicted job none again for an iteration done before its
    eviction); the parent's TransferStats the sum of the jobs' deltas;
    the allocator empty; device memory back within SERVICE_MEMORY_SLACK
    with the scheduler alive; the card's busy share over the drain
    (torch.profiler tracing the device only).
    (b) Serve mode: a fresh scheduler's serve loop takes 4 jobs submitted
    from this thread while it runs (one at fuse_steps SERVICE_FUSE, its
    chunk graph captured on the serve thread); shutdown(wait=True) loses
    none, each equals its standalone fit, the counts are exact.
    (c) The CLI: ``python -m repro_torch.launch.pim_jobs`` on
    examples/jobs.yaml as JSON with --checkpoint-dir, then again with
    --resume: every job restored without one kernel launch."""
    import gc
    import tempfile

    from repro_torch.sched import JobState, PimScheduler
    sizes = service_sizes(N_CORES)
    specs = service_specs(data, ITERS, DTR_DEPTH)
    alone = standalone_fits(torch, make_system, get_workload, data, sizes,
                            ITERS, DTR_DEPTH)
    alone_s = sum(t for _, t in alone.values())
    rounds = tree_rounds(alone["dtr"][0].model)

    def scheduler():
        return PimScheduler(make_system("pim", n_cores=N_CORES,
                                        device="cuda"),
                            rank_size=SERVICE_RANK, policy="deadline",
                            preemptive=True)

    def check_jobs(sched, handles: dict, what: str) -> None:
        bad = [h.name for h in handles.values()
               if h.state is not JobState.DONE or h.error is not None]
        if bad:
            fail(f"service {what}: jobs {bad} not DONE cleanly: " + "; ".join(
                f"{handles[n].state.value} {handles[n].error!r}"
                for n in bad))
        errors = {c: sched.metrics.counter(c).value
                  for c in ("sched.serve_errors", "sched.retries")}
        if any(errors.values()):
            fail(f"service {what}: {errors}")
        for name, h in handles.items():
            if not same_fit(h.result, alone[name][0]):
                fail(f"service {what}: job {name} differs from its "
                     f"standalone card fit")

    # (a) the drain
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    sched, run = scheduler(), {}

    def drain():
        t0 = time.perf_counter()
        run.update(service_drain(sched, data, sizes, ITERS, DTR_DEPTH))
        torch.cuda.synchronize()
        run["wall"] = time.perf_counter() - t0

    dispatch.reset_launch_counts()
    busy = device_profile(torch, drain, host=False)
    wall = run["wall"]
    counts = dict(dispatch.launch_counts)
    replays = sum(dispatch.graph_replays.values())
    handles = run["handles"]
    check_jobs(sched, handles, "drain")
    expected = {"fx_matvec": 4 * ITERS, "lut_sigmoid": ITERS,
                "kmeans_assign": ITERS, "gini_split": rounds}
    if counts != expected or replays != -(-ITERS // SERVICE_FUSE):
        fail(f"service drain: launch counts {counts} (expected "
             f"{expected}), {replays} graph replays")
    evicted = [h.name for h in handles.values() if h.preemptions]
    if len(evicted) != 1 or sched.metrics.counter(
            "sched.evictions").value != 1:
        fail(f"service drain: evicted {evicted}")
    parent = sched.system.stats.snapshot()
    deltas = [h.transfer for n, h in handles.items()
              if not n.startswith("gang") or n == "gang0"]
    deltas += run["segments"]
    for f in dataclasses.fields(parent):
        total = sum(getattr(d, f.name) for d in deltas)
        if getattr(parent, f.name) != total:
            fail(f"service drain: parent {f.name} {getattr(parent, f.name)}"
                 f" != the jobs' deltas {total}")
    frag = sched.fragmentation()
    if frag.used_cores or frag.n_leases:
        fail(f"service drain: the allocator is not empty: {frag}")
    gc.collect()
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - base
    if grown > SERVICE_MEMORY_SLACK:
        fail(f"service drain: {grown / 2 ** 20:.1f} MiB of device memory "
             f"still allocated after the drain")
    turns, own = run["turns"], run["own"]
    say(f"service: drain of {len(handles)} jobs over {N_CORES} cores "
        f"(rank {SERVICE_RANK}, deadline, preemptive) in {wall:.3f} s, "
        f"{len(turns)} turns; the {len(alone)} standalone card fits one "
        f"after another (one system a lease size, views shared) "
        f"{alone_s:.3f} s in all ({alone_s / wall:.2f}x); evicted "
        f"{evicted} at its chunk boundary and resumed; every job == its "
        f"standalone card fit; launch counts {counts} == expected, "
        f"{replays} graph replays; parent TransferStats == the jobs' "
        f"deltas ({len(run['segments'])} preempted segment); allocator "
        f"empty; device memory {grown / 2 ** 20:+.1f} MiB against the "
        f"phase's start (scheduler alive) on {smi}")
    say(f"service: per turn {statistics.median(turns) * 1e3:.3f} ms median"
        f" ({min(turns) * 1e3:.3f}-{max(turns) * 1e3:.3f}); the "
        f"scheduler's own host time (a turn's wall outside its jobs' "
        f"chunks) {statistics.median(own) * 1e6:.1f} us median a turn "
        f"({min(own) * 1e6:.1f}-{max(own) * 1e6:.1f}; admission builds a "
        f"gang's view), {sum(own):.3f} s in all; turn-end synchronizes "
        f"{sched.syncs}, waiting {sched.sync_seconds * 1e3:.3f} ms in all "
        f"({sched.sync_seconds / max(sched.syncs, 1) * 1e6:.1f} us each) "
        f"on {smi}")
    say(f"profile: service drain (device only traced): {busy}")
    for name, h in handles.items():
        fit_s = alone[name][1]
        say(f"service job {name:<8} {h.workload.name:<7} "
            f"{h.spec.version:<15} cores {h.n_cores:<5} turns {h.steps:<3}"
            f" queue {h.queue_latency:.4f} s, completion "
            f"{h.completion_latency:.4f} s, measured {h.measured_seconds:.4f}"
            f" s, modeled {h.modeled_seconds:.6g} s, drift "
            + (f"{h.drift_ratio:.4g}" if h.drift_ratio is not None
               else "none")
            + f"; standalone fit {fit_s:.4f} s, on {smi}")
    stats = sched.stats()
    say("service: stats " + json.dumps(
        {k: stats[k] for k in ("jobs", "preemptions", "recoveries",
                               "straggler_flags")})
        + f"; latency {json.dumps(sched.latency_summary())}")
    del sched, handles, run

    # (b) serve mode: submissions from this thread while the loop runs
    sched = scheduler()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    sched.serve(poll_interval=0.005)
    served = {}
    for name in ("lin", "log", "kme", "priority"):
        workload, d, version, params = specs[name]
        served[name] = sched.submit(workload, d, version=version,
                                    n_cores=sizes[name], name=name,
                                    **params)
        t_end = time.monotonic() + SERVICE_TIMEOUT
        while (served[name].state is JobState.QUEUED
               and time.monotonic() < t_end):
            time.sleep(0.001)          # mid-flight: the loop has taken it
    if not sched.wait(list(served.values()), timeout=SERVICE_TIMEOUT):
        fail("service serve: jobs unfinished after "
             f"{SERVICE_TIMEOUT} s")
    sched.shutdown(wait=True, timeout=SERVICE_TIMEOUT)
    serve_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    check_jobs(sched, served, "serve")
    serve_counts = dict(dispatch.launch_counts)
    serve_expected = {"fx_matvec": 3 * ITERS, "lut_sigmoid": ITERS,
                      "kmeans_assign": ITERS}
    serve_replays = sum(dispatch.graph_replays.values())
    if serve_counts != serve_expected or serve_replays != -(
            -ITERS // SERVICE_FUSE):
        fail(f"service serve: launch counts {serve_counts} (expected "
             f"{serve_expected}), {serve_replays} graph replays")
    say(f"service: serve loop took {len(served)} jobs submitted while it "
        f"ran (the fuse_steps {SERVICE_FUSE} job's chunk graph captured "
        f"on the serve thread), shutdown lost none, each == its "
        f"standalone card fit, launch counts {serve_counts}, "
        f"{serve_replays} replays, in {serve_s:.3f} s; latency "
        + json.dumps(sched.latency_summary()) + f" on {smi}")
    del sched, served
    gc.collect()
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - base
    if grown > SERVICE_MEMORY_SLACK:
        fail(f"service serve: {grown / 2 ** 20:.1f} MiB of device memory "
             f"still allocated")

    # (c) the CLI on examples/jobs.yaml as JSON, then resumed
    src = Path(__file__).resolve().parent / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    with tempfile.TemporaryDirectory() as tmp:
        manifest = Path(tmp) / "jobs.json"
        manifest.write_text(json.dumps(JOBS_YAML_AS_JSON))
        reports = []
        for resume in (False, True):
            out = Path(tmp) / f"report{int(resume)}.json"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.pim_jobs",
                 str(manifest), "--checkpoint-dir", str(Path(tmp) / "ck"),
                 "--json", str(out)] + (["--resume"] if resume else []),
                env=env, capture_output=True, text=True,
                timeout=SERVICE_TIMEOUT)
            if proc.returncode:
                fail(f"service cli: pim_jobs exited {proc.returncode}:\n"
                     f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
            reports.append((json.loads(out.read_text()),
                            time.perf_counter() - t0))
    (first, t_first), (again, t_again) = reports
    jobs_run = {r["name"]: r for r in first["jobs"]}
    if {r["state"] for r in first["jobs"]} != {"done"} or not {
            "fx_matvec", "lut_sigmoid", "kmeans_assign"} <= set(
                first["launch_counts"]) or first["device"] != "cuda":
        fail(f"service cli: first run {first['launch_counts']}, "
             f"{[(r['name'], r['state']) for r in first['jobs']]}")
    if not all(r.get("restored") and r["state"] == "done"
               for r in again["jobs"]) or again["launch_counts"] or \
            again["scheduler"]["transfer"]["pim"]["kernel_launches"]:
        fail(f"service cli: --resume re-ran work: "
             f"{again['launch_counts']}, {again['jobs']}")
    say(f"service: pim_jobs on examples/jobs.yaml as JSON "
        f"({len(jobs_run)} jobs, launch counts {first['launch_counts']}) "
        f"in {t_first:.1f} s with its start-up; --resume restored all "
        f"{len(again['jobs'])} without a launch in {t_again:.1f} s")
    return {"drain": counts, "serve": serve_counts}


# -- phase 10: LM training at full width ---------------------------------------

def _rel_err(got, want) -> float:
    """Max abs error over max |reference|."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def _leaf_rel(got, want) -> float:
    """||got - want|| / ||want|| in float32."""
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-30))


def check_mha_bwd(torch, dev, gen) -> tuple[float, float, tuple]:
    """Checks (a) and (b): the forward with lse against itself without
    lse (equal out) and against the plain logsumexp; mha_bwd against
    mha_bwd_plain at the full-width shapes (the model's 16 padded KV heads
    and granite's own 8), in float32 and with a window, and two calls at
    the main shape bitwise equal.  Returns the max
    of the max abs errors, the max of the errors over max |reference|
    and the inputs of the main path's shape, for timing."""
    from repro_torch.kernels.flash_attention import (mha_bwd_cuda,
                                                     mha_bwd_plain, mha_cuda,
                                                     mha_plain)
    b, hq, s, d = TRAIN_BATCH, 32, TRAIN_SEQ, 128

    def inputs(b, hq, hkv, s, dtype):
        # [B, S, H, D] projections seen as [B, H, S, D], as _project_qkv
        # hands them over; dout as the model's reshape hands it back
        return [torch.randn((b, s, h, d), generator=gen, device=dev)
                .to(dtype).transpose(1, 2) for h in (hq, hkv, hkv, hq)]
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(f"bf16 [{b}, {hq}, {s}, {d}] over 16 KV heads (the model's "
              f"padded heads), causal", (b, hq, 16, s, bf16), {}),
             (f"bf16 [{b}, {hq}, {s}, {d}] over 8 KV heads, causal",
              (b, hq, 8, s, bf16), {}),
             (f"bf16 [2, {hq}, {s}, {d}] over 16 KV heads, window 256",
              (2, hq, 16, s, bf16), {"window": 256}),
             (f"f32 [2, 8, {s}, {d}] over 2 KV heads, causal",
              (2, 8, 2, s, f32), {})]
    worst, worst_abs, main = 0.0, 0.0, None
    for name, shape, kw in cases:
        q, k, v, dout = inputs(*shape)
        out0 = mha_cuda(q, k, v, **kw)
        out, lse = mha_cuda(q, k, v, with_lse=True, **kw)
        _, lse_ref = mha_plain(q, k, v, with_lse=True, **kw)
        torch.cuda.synchronize()
        if not torch.equal(out0, out):
            fail(f"flash_attention: {name}: out with lse != out without")
        e_lse = float((lse - lse_ref).abs().max())
        if not e_lse <= TRAIN_LSE_ATOL:
            fail(f"flash_attention: {name}: lse off the plain logsumexp by "
                 f"{e_lse} > {TRAIN_LSE_ATOL}")
        got = mha_bwd_cuda(q, k, v, out, dout, lse, **kw)
        if main is None:    # no atomics: a second call is bitwise equal
            again = mha_bwd_cuda(q, k, v, out, dout, lse, **kw)
            torch.cuda.synchronize()
            if not all(torch.equal(a, g) for a, g in zip(again, got)):
                fail(f"flash_attention_bwd: {name}: two calls differ")
            del again
        want = mha_bwd_plain(q, k, v, out, dout, lse, **kw)
        tol = TRAIN_BWD_BF16_RTOL if shape[-1] == bf16 else TRAIN_BWD_F32_RTOL
        errs = [_rel_err(g, w) for g, w in zip(got, want)]
        if not max(errs) <= tol:
            fail(f"flash_attention_bwd: {name}: dq, dk, dv errors {errs} > "
                 f"{tol} of max |plain|")
        worst = max(worst, max(errs))
        worst_abs = max(worst_abs, max(float((g.float() - w.float()).abs()
                                             .max())
                                       for g, w in zip(got, want)))
        say(f"kernels: flash_attention_bwd ~ plain, {name}: dq {errs[0]:.3g}"
            f", dk {errs[1]:.3g}, dv {errs[2]:.3g} of max |plain| (<= {tol})"
            f"{'; two calls bitwise equal' if main is None else ''}"
            f"; forward out with lse == without, lse within {e_lse:.3g}")
        if main is None:
            main = (q, k, v, out, dout, lse)
        del q, k, v, dout, out, lse, got, want
    return worst_abs, worst, main


def mha_bwd_times(torch, flush, main) -> dict:
    """mha_bwd at the main path's shape: kernel, plain, bound from its
    declared cost; beside them this port's forward + backward through
    MhaFunction and F.scaled_dot_product_attention's (autograd, the
    library yardstick), each with dout given; and the forward kernel with
    lse kept at that shape (``fwd``: kernel, plain, bound, SDPA's
    forward)."""
    import torch.nn.functional as F
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.flash_attention import (mha, mha_bwd_cuda,
                                                     mha_bwd_plain, mha_cuda,
                                                     mha_plain)
    q, k, v, out, dout, lse = main
    t = dict(ms=cuda_ms(torch, lambda: mha_bwd_cuda(q, k, v, out, dout, lse),
                        flush),
             plain_ms=cuda_ms(torch, lambda: mha_bwd_plain(q, k, v, out,
                                                           dout, lse), flush))
    cost = dispatch.declared_cost("mha_bwd", q, k, v, out, dout, lse)
    t["bound_ms"], t["bound_by"] = bound(cost.bytes, cost.ops,
                                         PEAK_OPS_PER_S[cost.rate])
    t["bound_share"] = t["bound_ms"] / t["ms"]
    t["tflops"] = cost.ops / t["ms"] / 1e9
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

    def ours():
        torch.autograd.grad(mha(qg, kg, vg), (qg, kg, vg), dout)

    def library():
        torch.autograd.grad(F.scaled_dot_product_attention(
            qg, kg, vg, is_causal=True, enable_gqa=True), (qg, kg, vg), dout)
    t["fwd_bwd_ms"] = cuda_ms(torch, ours, flush)
    t["library_ms"] = cuda_ms(torch, library, flush)

    def sdpa_forward():
        F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                       enable_gqa=True)
    fwd = dict(ms=cuda_ms(torch, lambda: mha_cuda(q, k, v, with_lse=True),
                          flush),
               plain_ms=cuda_ms(torch, lambda: mha_plain(q, k, v,
                                                         with_lse=True),
                                flush),
               library_ms=cuda_ms(torch, sdpa_forward, flush))
    cost = dispatch.declared_cost("mha", q, k, v, with_lse=True)
    fwd["bound_ms"], fwd["bound_by"] = bound(cost.bytes, cost.ops,
                                             PEAK_OPS_PER_S[cost.rate])
    t["fwd"] = fwd
    return t


def int_matmul_train_times(torch, flush) -> dict:
    """int_matmul at the training path's M = B * S = 8192 (granite's MLP
    shapes): kernel, plain, bound, torch._int_mm."""
    from repro_torch.kernels.quant_matmul import (int_matmul_cuda,
                                                  int_matmul_plain)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    m = TRAIN_BATCH * TRAIN_SEQ
    out = {}
    for k, n in TRAIN_MLP_SHAPES:
        a = torch.randint(-128, 128, (m, k), generator=gen, device="cuda",
                          dtype=torch.int32).to(torch.int8)
        b = torch.randint(-128, 128, (k, n), generator=gen, device="cuda",
                          dtype=torch.int32).to(torch.int8)
        t = dict(ms=cuda_ms(torch, lambda: int_matmul_cuda(a, b), flush),
                 plain_ms=cuda_ms(torch, lambda: int_matmul_plain(a, b),
                                  flush),
                 library_ms=cuda_ms(torch, lambda: torch._int_mm(a, b),
                                    flush))
        t["bound_ms"], t["bound_by"] = bound(
            m * k + k * n + 4 * m * n, 2 * m * k * n, PEAK_INT8_OPS_PER_S)
        t["bound_share"] = t["bound_ms"] / t["ms"]
        t["tops"] = 2 * m * k * n / t["ms"] / 1e9
        out[f"{m}x{k}x{n}"] = t
    return out


def lm_train_on_card(torch, dispatch, smi: str) -> dict:
    """Phase 10: granite-3-8b at full width (8 of 40 layers, bf16, remat
    full) trained through repro_torch.launch.train.train, with checks
    (a)-(g) of the module docstring; returns the launch
    counts, times and errors for the kernel table."""
    import tempfile
    from repro_torch.data.tokens import MarkovCorpus
    from repro_torch.launch import train as launch_train
    from repro_torch.models import attention as attention_mod
    from repro_torch.kernels.flash_attention import mha_plain
    from repro_torch.train.loop import value_and_grad
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    full = dict(reduced=False, overrides={"n_layers": TRAIN_LAYERS},
                device="cuda")
    res = {}

    # (a), (b): the kernels against their plain versions at full width
    torch.cuda.empty_cache()
    say(f"train: {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB held by "
        f"the earlier phases at the start of phase 10")
    res["bwd_abs_err"], res["bwd_err"], main = check_mha_bwd(torch, dev, gen)
    flush = L2Flush(torch)
    res["bwd"] = mha_bwd_times(torch, flush, main)
    del main
    res["int_matmul"] = int_matmul_train_times(torch, flush)
    del flush
    bt, ft = res["bwd"], res["bwd"]["fwd"]
    shape = f"[{TRAIN_BATCH}, 32, {TRAIN_SEQ}, 128] over 16 KV heads, causal"
    say(f"timing: flash_attention_bwd (route: wgmma bf16) {shape}: kernel "
        f"{bt['ms']:.4f} ms ({bt['tflops']:.1f} TFLOP/s of the 5 products; "
        f"bound {bt['bound_ms']:.4f} ms by {bt['bound_by']}, "
        f"{100 * bt['bound_share']:.1f}% of it), plain {bt['plain_ms']:.3f} "
        f"ms; forward + backward: this port's {bt['fwd_bwd_ms']:.4f} ms, "
        f"F.scaled_dot_product_attention's {bt['library_ms']:.4f} ms "
        f"(on {smi})")
    say(f"timing: flash_attention (route: wgmma bf16) with lse, {shape}: "
        f"kernel {ft['ms']:.4f} ms ({100 * ft['bound_ms'] / ft['ms']:.1f}% of "
        f"the bound {ft['bound_ms']:.4f} ms by {ft['bound_by']}), plain "
        f"{ft['plain_ms']:.3f} ms, F.scaled_dot_product_attention forward "
        f"{ft['library_ms']:.4f} ms (on {smi})")
    for shape, t in res["int_matmul"].items():
        say(f"timing: int_matmul {shape}: kernel {t['ms']:.4f} ms "
            f"({t['tops']:.0f} TOP/s, {100 * t['bound_share']:.1f}% of the "
            f"bound {t['bound_ms']:.4f} ms by {t['bound_by']}), plain "
            f"{t['plain_ms']:.3f} ms, torch._int_mm {t['library_ms']:.4f} "
            f"ms (on {smi})")

    # (c): step 1's loss and gradients against plain attention under
    # autograd, on the same weights and batch
    cfg, model, opt, step_fn = launch_train.build(TRAIN_ARCH, **full)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    params.trainable_()
    batch = MarkovCorpus(cfg.vocab_size, seed=SEED).batch(TRAIN_BATCH,
                                                          TRAIN_SEQ)
    loss_k, grads_k = value_and_grad(model, params, batch)
    kernel_mha = attention_mod.mha
    attention_mod.mha = mha_plain           # the check's plain attention
    try:
        loss_p, grads_p = value_and_grad(model, params, batch)
    finally:
        attention_mod.mha = kernel_mha
    errs = {n: _leaf_rel(grads_k[n], grads_p[n]) for n in grads_k}
    worst = max(errs.items(), key=lambda kv: kv[1])
    dloss = abs(float(loss_k) - float(loss_p))
    say(f"train: step 1 at full width, kernels against plain attention "
        f"under autograd: loss {float(loss_k):.5f} / {float(loss_p):.5f} "
        f"(|d| {dloss:.3g} <= {TRAIN_LOSS_ATOL}); worst leaf "
        f"{worst[0]} at {worst[1]:.3g} (<= {TRAIN_GRAD_RTOL} of its norm)")
    if not dloss <= TRAIN_LOSS_ATOL or not worst[1] <= TRAIN_GRAD_RTOL:
        fail("train: the kernels' step-1 loss or gradients are off the "
             "plain attention's")
    dead = [n for n in grads_k if n.rsplit(".", 1)[-1] in
            ("wq", "wk", "wv", "wo") and not torch.any(grads_k[n])]
    if dead:
        fail(f"train: attention weights with a zero gradient: {dead}")
    res["step1_loss_err"], res["step1_grad_err"] = dloss, worst[1]
    del params, grads_k, grads_p, loss_k, loss_p

    # (d), (e): 5 steps through the entry point, counts exact
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    params, losses, corpus = launch_train.train(
        TRAIN_ARCH, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        lr=TRAIN_LR, seed=SEED, log_every=1, **full)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(dispatch.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    expected = {"mha": 2 * TRAIN_LAYERS * TRAIN_STEPS,
                "mha_bwd": TRAIN_LAYERS * TRAIN_STEPS}
    say(f"train: {TRAIN_ARCH} d_model {cfg.d_model}, {TRAIN_LAYERS} of 40 "
        f"layers, bf16, remat {cfg.remat}, B={TRAIN_BATCH} S={TRAIN_SEQ}, "
        f"AdamW lr {TRAIN_LR}: {TRAIN_STEPS} steps through launch.train in "
        f"{wall:.2f} s (init included), losses {losses}, peak "
        f"{peak / 2 ** 30:.2f} GiB allocated; launch counts {counts} "
        f"(expected {expected})")
    if counts != expected:
        fail(f"train: launch counts {counts} != {expected}")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail(f"train: losses {losses} not finite or not falling")
    res.update(counts=counts, losses=losses, peak_bytes=peak)

    # timing and the profile: steps on the trained weights
    opt_state = opt.init(params)
    batch = corpus.batch(TRAIN_BATCH, TRAIN_SEQ)
    params, opt_state, _ = step_fn(params, opt_state, batch)    # warm
    torch.cuda.synchronize()
    tot, fb, up = [], [], []
    for _ in range(TRAIN_TIMED_STEPS):       # the step as launch.train runs it
        t0 = time.perf_counter()
        params, opt_state, _ = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        tot.append(time.perf_counter() - t0)
    for _ in range(TRAIN_TIMED_STEPS):       # its split, each part synchronised
        t0 = time.perf_counter()
        _, grads = value_and_grad(model, params, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        opt.update(grads, opt_state, params)
        torch.cuda.synchronize()
        fb.append(t1 - t0)
        up.append(time.perf_counter() - t1)
        del grads
    step_ms = statistics.median(tot) * 1e3
    res.update(step_ms=step_ms, fwd_bwd_ms=statistics.median(fb) * 1e3,
               update_ms=statistics.median(up) * 1e3,
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3))
    res["profile"] = device_profile(
        torch, lambda: step_fn(params, opt_state, batch), top=8,
        watch="mha_bwd")
    say(f"train: {step_ms:.1f} ms a step (step_fn, median of "
        f"{TRAIN_TIMED_STEPS}, host clock, synchronised), "
        f"{res['tokens_per_s']:.0f} tokens/s; timed apart: forward + "
        f"backward {res['fwd_bwd_ms']:.1f} ms, AdamW "
        f"{res['update_ms']:.1f} ms (on {smi})")
    say(f"profile: one train step: {res['profile']}")
    del params, opt_state

    # (f): the paper's two techniques, 2 steps
    dispatch.reset_launch_counts()
    params, q_losses, _ = launch_train.train(
        TRAIN_ARCH, steps=TRAIN_QUANT_STEPS, batch=TRAIN_BATCH,
        seq=TRAIN_SEQ, lr=TRAIN_LR, seed=SEED, log_every=1,
        quantize_dense=True, lut_activations=True, **full)
    torch.cuda.synchronize()
    q_counts = dict(dispatch.launch_counts)
    q_expected = {"int_matmul": 6 * TRAIN_LAYERS * TRAIN_QUANT_STEPS,
                  "mha": 2 * TRAIN_LAYERS * TRAIN_QUANT_STEPS,
                  "mha_bwd": TRAIN_LAYERS * TRAIN_QUANT_STEPS}
    _, qmodel, _, _ = launch_train.build(
        TRAIN_ARCH, quantize_dense=True, lut_activations=True, **full)
    _, q_grads = value_and_grad(qmodel, params,
                                corpus.batch(TRAIN_BATCH, TRAIN_SEQ))
    gates = [n for n in q_grads if n.endswith(".gate")]
    live_gates = [n for n in gates if torch.any(q_grads[n])]
    dead_ups = [n for n in q_grads if n.endswith(".up")
                and not torch.any(q_grads[n])]
    say(f"train: quantize_dense + lut_activations, {TRAIN_QUANT_STEPS} "
        f"steps: losses {q_losses}, launch counts {q_counts} (expected "
        f"{q_expected}: 3 int_matmul per layer in the forward and again in "
        f"its recompute); {len(gates)} gate gradients, {len(live_gates)} "
        f"nonzero (expected 0); up gradients all nonzero: {not dead_ups}")
    if q_counts != q_expected:
        fail(f"train: quantized launch counts {q_counts} != {q_expected}")
    if not np.all(np.isfinite(q_losses)) or live_gates or dead_ups:
        fail("train: quantized losses not finite, a gate gradient not 0 or "
             "an up gradient 0")
    res["quant_counts"] = q_counts
    del params, q_grads

    # (g): a reduced resume on the card retraces the uninterrupted run
    red = dict(steps=4, batch=2, seq=64, seed=SEED, ckpt_every=2,
               log_every=100, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        a, la, _ = launch_train.train(TRAIN_ARCH, ckpt_dir=f"{tmp}/a", **red)
        launch_train.train(TRAIN_ARCH, ckpt_dir=f"{tmp}/b",
                           **dict(red, steps=2))
        b, lb, _ = launch_train.train(TRAIN_ARCH, ckpt_dir=f"{tmp}/b", **red)
    same_params = all(torch.equal(x, y) for x, y in
                      zip(a.parameters(), b.parameters()))
    say(f"train: reduced {TRAIN_ARCH} resumed at step 2 on the card: steps "
        f"3-4 losses {lb} against the uninterrupted {la[2:]}, params equal:"
        f" {same_params}")
    if lb != la[2:] or not same_params:
        fail("train: the resumed run differs from the uninterrupted one")
    say(f"train: phase 10 in {time.perf_counter() - t_phase:.1f} s on {smi}")
    return res


# -- phase 11: the decoder-only families at full width ------------------------

def family_counts(cfg, prompts: int, calls: int) -> dict:
    """The launches a serve run of ``cfg`` makes: one mha per attention
    layer (moe, hymba) a prefill, the windowed ones included; with
    quantize_dense, 3 int_matmul per MLP (hymba's, the MoE's shared expert;
    the routed experts are not quantized, as in the reference) per layer
    per forward call.  xLSTM's blocks launch none."""
    pattern = cfg.layer_pattern()
    attn = sum(bt in ("attn", "moe", "hymba") for bt in pattern)
    mlps = sum(bt in ("attn", "hymba")
               or (bt == "moe" and bool(cfg.shared_expert_d_ff))
               for bt in pattern)
    out = {"mha": attn * prompts} if attn else {}
    if cfg.quantize_dense and mlps:
        out["int_matmul"] = 3 * mlps * calls
    return out


def add_counts(total: dict, counts: dict) -> None:
    for k, n in counts.items():
        total[k] = total.get(k, 0) + n


def serve_family(torch, dispatch, name: str, cfg, params, prompts,
                 total: dict, smi: str) -> dict:
    """Serve ``prompts`` (FAM_NEW tokens each, LM_SLOTS slots) with the
    counts zeroed just before and checked exactly just after; prints the
    load's line and peak memory."""
    from repro_torch.models.api import Model
    from repro_torch.serve.engine import Request, ServeEngine
    calls = len(prompts) * FAM_NEW
    expected = family_counts(cfg, len(prompts), calls)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    r = serve_timed(torch, Model, Request, ServeEngine, cfg, params, prompts,
                    FAM_NEW)
    torch.cuda.synchronize()
    counts = dict(dispatch.launch_counts)
    say(f"families: {name}: launch counts {counts} (expected {expected}: "
        f"{len(prompts)} prefills + {calls - len(prompts)} decode calls)")
    if counts != expected:
        fail(f"{name}: launch counts {counts} != {expected}")
    if any(len(o) != FAM_NEW or not all(0 <= t < cfg.vocab_size for t in o)
           for o in r["outputs"]):
        fail(f"{name}: an output has the wrong length or an id outside the "
             f"vocabulary")
    r["peak_bytes"] = torch.cuda.max_memory_allocated()
    say(serve_line(name, r, prompts, smi, FAM_NEW) + f"; peak device memory "
        f"{r['peak_bytes'] / 2 ** 30:.1f} GiB")
    add_counts(total, counts)
    r["counts"] = counts
    return r


def family_profile(torch, model, params, prompt, extras=None) -> str:
    """The card's busy share over LM_PROFILE_STEPS batch-1 decode steps
    after a prefill of ``prompt`` (and its batch's ``extras``), the device
    traced alone (a host trace of ~25,000 eager ops takes seconds to
    process)."""
    _, cache = model.prefill(params, {"tokens": prompt[None],
                                      **(extras or {})}, LM_MAX_SEQ)
    tok = np.zeros((1, 1), np.int32)

    def steps():
        c = cache
        for _ in range(LM_PROFILE_STEPS):
            _, c = model.decode_step(params, tok, c)
    return device_profile(torch, steps, host=False)


def property_check(torch, name: str, model, params, toks, prefix: int,
                   atol: float, rtol: float, extras=None) -> float:
    """Prefill ``toks[:, :prefix]`` (with the batch's ``extras``), then
    decode the rest one token at a time: every step's logits (and the
    prefill's last) against the forward's over all of ``toks``; fails
    outside ``atol + rtol * |logit|``.  Returns the max |dlogit|."""
    extras = extras or {}
    full = model.forward(params, {"tokens": toks, **extras}).float()
    if not bool(torch.isfinite(full).all()):
        fail(f"{name}: non-finite forward logits")
    logits, cache = model.prefill(params, {"tokens": toks[:, :prefix],
                                           **extras}, LM_MAX_SEQ)
    steps = [logits[:, 0].float()]
    for i in range(prefix, toks.shape[1]):
        logits, cache = model.decode_step(params, toks[:, i:i + 1], cache)
        steps.append(logits[:, 0].float())
    got = torch.stack(steps, dim=1)
    want = full[:, prefix - 1:]
    diff = (got - want).abs()
    ok = bool((diff <= atol + rtol * want.abs()).all())
    say(f"  {name}: prefill({prefix}) + {toks.shape[1] - prefix} decode "
        f"steps == the forward at positions {prefix - 1}-"
        f"{toks.shape[1] - 1}, float32: {ok} (max |dlogit| "
        f"{float(diff.max()):.4g}, max |logit| {float(want.abs().max()):.4g};"
        f" atol {atol}, rtol {rtol})")
    if not ok:
        fail(f"{name}: prefill + decode disagrees with the forward")
    return float(diff.max())


def families_card_equals_cpu(torch, dispatch, total: dict) -> dict:
    """(e): each family reduced to float32, the same weights on the card
    and the CPU: forward logits, greedy tokens, and one value_and_grad and
    one AdamW step (loss and every gradient leaf); the card's launches of
    the grad (mha with lse and mha_bwd, hymba's windowed layer among them)
    counted."""
    import copy
    from repro_torch.configs.base import get_config
    from repro_torch.data.tokens import MarkovCorpus
    from repro_torch.models.api import Model
    from repro_torch.optim.adam import AdamW
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.train.loop import make_train_step, value_and_grad
    out = {}
    for arch, overrides in FAM_REDUCED.items():
        cfg = get_config(arch).reduced(**overrides)
        weights = Model(cfg, device="cpu").init(
            torch.Generator().manual_seed(SEED))
        batch = MarkovCorpus(cfg.vocab_size, seed=SEED).batch(2, 64)
        rng = np.random.RandomState(SEED)
        prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
                   for n in (40, 9, 64, 23)]
        res = {}
        for device in ("cuda", "cpu"):
            model = Model(cfg, device=device)
            params = copy.deepcopy(weights).to(device)
            reqs = [Request(prompt=p, max_new_tokens=8) for p in prompts]
            ServeEngine(model, params, n_slots=2, max_seq=128).run(reqs)
            logits = model.forward(params, {"tokens": batch["tokens"]})
            params.trainable_()
            dispatch.reset_launch_counts()
            loss, grads = value_and_grad(model, params, batch)
            if device == "cuda":
                torch.cuda.synchronize()
                grad_counts = dict(dispatch.launch_counts)
            opt = AdamW(lr=1e-3)
            _, _, metrics = make_train_step(model, opt)(
                params, opt.init(params), batch)
            res[device] = ([r.output for r in reqs], logits.cpu(),
                           float(loss), {n: g.cpu() for n, g in grads.items()},
                           float(metrics["loss"]))
        (tg, lg, sg, gg, mg), (tc, lc, sc, gc, mc) = res["cuda"], res["cpu"]
        err = float((lg - lc).abs().max())
        worst = max(((n, _leaf_rel(gg[n], gc[n])) for n in gc),
                    key=lambda kv: kv[1])
        attn = sum(bt in ("moe", "hymba") for bt in cfg.layer_pattern())
        want = {"mha": attn, "mha_bwd": attn} if attn else {}
        say(f"  {arch} reduced f32 {overrides or ''}: card vs CPU forward "
            f"max |dlogit| {err:.3g} (<= {LM_F32_ATOL}); greedy tokens equal:"
            f" {tg == tc}; loss {sg:.6f} / {sc:.6f}, AdamW step's loss "
            f"{mg:.6f} / {mc:.6f} (<= {FAM_LOSS_ATOL}); worst gradient leaf "
            f"{worst[0]} at {worst[1]:.3g} (<= {FAM_GRAD_RTOL}); the grad's "
            f"launches {grad_counts} (expected {want})")
        if not (err <= LM_F32_ATOL and tg == tc
                and abs(sg - sc) <= FAM_LOSS_ATOL
                and abs(mg - mc) <= FAM_LOSS_ATOL
                and worst[1] <= FAM_GRAD_RTOL and grad_counts == want):
            fail(f"{arch} reduced: the card and the CPU disagree")
        add_counts(total, grad_counts)
        out[arch] = {"logit_err": err, "grad_err": worst[1],
                     "loss_err": abs(sg - sc)}
    return out


def check_family_kernels(torch, prompt_lens: list) -> tuple[int, float]:
    """The kernels at the shapes phase 11 gives them, against their plain
    versions: int_matmul (exact, full-range int8) at qwen2-moe's shared
    expert and hymba's MLP for M = 1 (a decode token) and the shortest and
    longest prefill (hymba's with its meta tokens); flash_attention (within
    MHA_BF16_ATOL / MHA_F32_ATOL) on each family's padded head plan at its
    prefill lengths in bf16, hymba's with the window its layers pass and
    without (FULL_WINDOW), and at the float32 property checks' shapes of
    (b) and (f).  Returns the max abs errors."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.quant_matmul import (int_matmul_cuda,
                                                  int_matmul_plain)
    from repro_torch.models.transformer import attn_spec
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    moe, hy, db = (get_config(a) for a in (FAM_MOE, FAM_HYMBA, FAM_DBRX))
    lo, hi = min(prompt_lens), max(prompt_lens)
    err_mm, shapes = 0, []
    for cfg, d_ff in ((moe, moe.shared_expert_d_ff), (hy, hy.d_ff)):
        shapes += [(m, k, n) for m in (1, lo + cfg.meta_tokens,
                                       hi + cfg.meta_tokens)
                   for k, n in ((cfg.d_model, d_ff), (d_ff, cfg.d_model))]
    for m, k, n in shapes:
        a, b = int8_operand(torch, gen, (m, k)), int8_operand(torch, gen,
                                                              (k, n))
        err_mm = max(err_mm, same(torch, [int_matmul_cuda(a, b)],
                                  [int_matmul_plain(a, b)]))
    say(f"families: kernels: int_matmul == plain at (M, K, N) {shapes}")

    bf16, f32 = torch.bfloat16, torch.float32
    w = hy.sliding_window
    shapes = [(cfg, s, bf16, 0) for cfg, ss in (
        (moe, (lo, hi)), (db, (FAM_DBRX_PROMPT,))) for s in ss]
    shapes += [(hy, s + hy.meta_tokens, bf16, win) for s in (lo, hi)
               for win in (w, 0)]
    p0 = prompt_lens[0] + hy.meta_tokens     # (b)'s forward, its prefill
    shapes += [(hy, s, f32, w) for s in (p0, p0 - 1)]
    shapes += [(moe, s, f32, 0) for s in (FAM_PROPERTY_PROMPT + 1,
                                          FAM_PROPERTY_PROMPT)]
    cases = []
    for cfg, s, dtype, win in dict.fromkeys(  # windows as _sdpa passes them
            (c, s, t, win if win < s else 0) for c, s, t, win in shapes):
        plan, d = attn_spec(cfg).plan, cfg.resolved_head_dim
        q, k, v = (torch.randn((1, s, h, d), generator=gen, device="cuda")
                   .to(dtype).transpose(1, 2)
                   for h in (plan.n_q, plan.n_kv, plan.n_kv))
        cases.append((f"{cfg.name} {str(dtype)[6:]} {list(q.shape)} over "
                      f"{plan.n_kv} KV heads, causal, window "
                      f"{win or 'none'}", (q, k, v), {"window": win}))
    return err_mm, check_mha_cases(torch, cases, "families: kernels: ")


def lm_families_on_card(torch, dispatch, smi: str) -> dict:
    """Phase 11: qwen2-moe-a2.7b, hymba-1.5b and xlstm-350m at full width
    and depth, dbrx-132b at full width and FAM_DBRX_LAYERS layers, bf16,
    seeded random weights, through Model and ServeEngine; checks (a)-(f) of
    the module docstring.  Returns the phase's launch counts and each
    family's serve numbers."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.api import Model
    from repro_torch.models.transformer import attn_spec, moe_spec
    t_phase = time.perf_counter()
    total, res = {}, {"seconds": {}}
    torch.cuda.empty_cache()
    marks = [t_phase]

    def lap(part: str) -> None:
        now = time.perf_counter()
        res["seconds"][part] = now - marks[-1]
        say(f"families: ({part}) took {now - marks[-1]:.1f} s")
        marks.append(now)

    prompt_lens = [len(p) for p in lm_requests(
        get_config(FAM_MOE).vocab_size)]
    res["err_mm"], res["err_fa"] = check_family_kernels(torch, prompt_lens)
    lap("kernels")

    def draw(cfg):
        t0 = time.perf_counter()
        params = Model(cfg, device="cuda").init(
            torch.Generator(device="cuda").manual_seed(SEED))
        torch.cuda.synchronize()
        n = Model.param_count(params)
        plan = attn_spec(cfg).plan
        say(f"families: {cfg.name} at full width: {cfg.n_layers} layers "
            f"{sorted(set(cfg.layer_pattern()))}, d_model {cfg.d_model}, "
            f"{cfg.n_heads} query / {cfg.n_kv_heads} KV heads (padded to "
            f"{plan.n_q} / {plan.n_kv}), vocab {cfg.vocab_size}, {cfg.dtype}, "
            f"{n:,} parameters drawn in {time.perf_counter() - t0:.1f} s; "
            f"device memory {torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB")
        return params, n

    # (a) qwen2-moe-a2.7b, quantize_dense on then off
    base = get_config(FAM_MOE)
    spec = moe_spec(base)
    cfg_q = dataclasses.replace(base, quantize_dense=True)
    params, n_params = draw(cfg_q)
    expert_bytes = 3 * spec.n_experts * spec.d_model * spec.d_ff * 2
    say(f"families: {FAM_MOE}: {spec.n_experts_real} experts padded to "
        f"{spec.n_experts}, top-{spec.top_k}, shared expert "
        f"{base.shared_expert_d_ff} wide; a decode token's capacity is 1 "
        f"in every expert, so each decode step computes all "
        f"{spec.n_experts} experts' buffers and reads their weights: "
        f"{base.n_layers * expert_bytes / 1e9:.2f} GB a token, "
        f"{base.n_layers * expert_bytes / PEAK_BYTES_PER_S * 1e3:.2f} ms at "
        f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s")
    prompts = lm_requests(base.vocab_size)
    moe = {"params": n_params}
    moe["on"] = serve_family(torch, dispatch, f"{FAM_MOE} quantize_dense on",
                             cfg_q, params, prompts, total, smi)
    cfg_f = dataclasses.replace(base, quantize_dense=False)
    moe["off"] = serve_family(torch, dispatch,
                              f"{FAM_MOE} quantize_dense off (same weights)",
                              cfg_f, params, prompts, total, smi)
    moe["profile"] = family_profile(torch, Model(cfg_q, device="cuda"),
                                    params, prompts[0])
    say(f"profile: {LM_PROFILE_STEPS} decode steps, {FAM_MOE} quantize_dense"
        f" on: {moe['profile']}")
    res[FAM_MOE] = moe
    del params
    torch.cuda.empty_cache()
    lap("a")

    # (b) hymba-1.5b, quantize_dense on then off; float32 property
    base = get_config(FAM_HYMBA)
    cfg_q = dataclasses.replace(base, quantize_dense=True)
    params, n_params = draw(cfg_q)
    prompts = lm_requests(base.vocab_size)
    hy = {"params": n_params}
    hy["on"] = serve_family(torch, dispatch,
                            f"{FAM_HYMBA} quantize_dense on", cfg_q, params,
                            prompts, total, smi)
    hy["off"] = serve_family(torch, dispatch,
                             f"{FAM_HYMBA} quantize_dense off (same weights)",
                             dataclasses.replace(base, quantize_dense=False),
                             params, prompts, total, smi)
    hy["profile"] = family_profile(torch, Model(cfg_q, device="cuda"), params,
                                   prompts[0])
    say(f"profile: {LM_PROFILE_STEPS} decode steps, {FAM_HYMBA} "
        f"quantize_dense on: {hy['profile']}")
    params.float()                            # in place: frees the bf16
    cfg32 = dataclasses.replace(base, dtype="float32")
    dispatch.reset_launch_counts()
    hy["property_err"] = property_check(
        torch, FAM_HYMBA, Model(cfg32, device="cuda"), params,
        prompts[0][None], len(prompts[0]) - 1, LM_F32_PROPERTY_TOL,
        LM_F32_PROPERTY_TOL)
    add_counts(total, dispatch.launch_counts)
    res[FAM_HYMBA] = hy
    del params
    torch.cuda.empty_cache()
    lap("b")

    # (c) xlstm-350m on prompts of 64-token multiples; float32 property
    base = get_config(FAM_XLSTM)
    params, n_params = draw(base)
    rng = np.random.RandomState(SEED)
    x_prompts = [rng.randint(0, base.vocab_size, FAM_XLSTM_CHUNK * n)
                 .astype(np.int32)
                 for n in rng.randint(LM_PROMPT_MIN // FAM_XLSTM_CHUNK,
                                      LM_PROMPT_MAX // FAM_XLSTM_CHUNK + 1,
                                      LM_REQUESTS)]
    say(f"families: {FAM_XLSTM}: prompts of {FAM_XLSTM_CHUNK}-token "
        f"multiples, the reference's chunk contract (mlstm_chunkwise "
        f"asserts S % 64 == 0 past 64 tokens); its blocks launch no kernel "
        f"(no attention, no MLP: the mLSTM's x2 up-projection replaces it)")
    xl = {"params": n_params}
    xl["serve"] = serve_family(torch, dispatch, FAM_XLSTM, base, params,
                               x_prompts, total, smi)
    xl["profile"] = family_profile(torch, Model(base, device="cuda"), params,
                                   x_prompts[0])
    say(f"profile: {LM_PROFILE_STEPS} decode steps, {FAM_XLSTM}: "
        f"{xl['profile']}")
    params.float()
    cfg32 = dataclasses.replace(base, dtype="float32")
    p0 = len(x_prompts[0])
    toks = np.concatenate([x_prompts[0], rng.randint(
        0, base.vocab_size, FAM_XLSTM_CHUNK).astype(np.int32)])[None]
    dispatch.reset_launch_counts()
    xl["property_err"] = property_check(
        torch, FAM_XLSTM, Model(cfg32, device="cuda"), params, toks, p0,
        LM_F32_PROPERTY_TOL, LM_F32_PROPERTY_TOL)
    if dispatch.launch_counts:
        fail(f"{FAM_XLSTM}: launched {dispatch.launch_counts}")
    res[FAM_XLSTM] = xl
    del params
    torch.cuda.empty_cache()
    lap("c")

    # (d) dbrx-132b, FAM_DBRX_LAYERS layers: one prompt in 16 groups
    base = get_config(FAM_DBRX)
    cfg = dataclasses.replace(base, n_layers=FAM_DBRX_LAYERS)
    params, n_params = draw(cfg)
    emb = 2 * base.padded_vocab * base.d_model
    whole = emb + (n_params - emb) * base.n_layers / FAM_DBRX_LAYERS
    say(f"families: {FAM_DBRX}: {FAM_DBRX_LAYERS} of {base.n_layers} layers "
        f"({n_params * 2 / 1e9:.1f} GB of bf16; all {base.n_layers} would be "
        f"{whole * 2 / 1e9:.0f} GB), {moe_spec(base).groups} routing groups")
    model = Model(cfg, device="cuda")
    prompt = np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, FAM_DBRX_PROMPT).astype(np.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": prompt[None]},
                                  LM_MAX_SEQ)
    torch.cuda.synchronize()
    ttft = time.perf_counter() - t0
    finite = bool(torch.isfinite(logits).all())
    out, dec = [], []
    for _ in range(FAM_DBRX_NEW):
        tok = int(torch.argmax(logits[0, -1, :cfg.vocab_size]))
        out.append(tok)
        t0 = time.perf_counter()
        logits, cache = model.decode_step(params, np.array([[tok]],
                                                           np.int32), cache)
        torch.cuda.synchronize()
        dec.append(time.perf_counter() - t0)
        finite &= bool(torch.isfinite(logits).all())
    counts = dict(dispatch.launch_counts)
    expected = family_counts(cfg, 1, 1 + FAM_DBRX_NEW)
    db = {"params": n_params, "ttft_ms": ttft * 1e3,
          "decode_ms": statistics.median(dec) * 1e3, "counts": counts,
          "peak_bytes": torch.cuda.max_memory_allocated()}
    say(f"families: {FAM_DBRX} ({FAM_DBRX_LAYERS} layers): prefill of "
        f"{FAM_DBRX_PROMPT} tokens {db['ttft_ms']:.1f} ms, {FAM_DBRX_NEW} "
        f"decode steps {db['decode_ms']:.2f} ms each (median), greedy "
        f"{out}; logits finite: {finite}; launch counts {counts} (expected "
        f"{expected}); peak device memory "
        f"{db['peak_bytes'] / 2 ** 30:.1f} GiB on {smi}")
    if not finite or counts != expected:
        fail(f"{FAM_DBRX}: non-finite logits or counts {counts} != "
             f"{expected}")
    add_counts(total, counts)
    res[FAM_DBRX] = db
    del params, cache, logits
    torch.cuda.empty_cache()
    lap("d")

    # (e) each family reduced, card against CPU
    res["card_vs_cpu"] = families_card_equals_cpu(torch, dispatch, total)
    lap("e")

    # (f) the MoE property at full width in float32, dropless capacity
    base = get_config(FAM_MOE)
    spec = moe_spec(base)
    free, _ = torch.cuda.mem_get_info()
    per_layer = sum(int(np.prod(s)) for s in (
        (3, spec.n_experts, spec.d_model, spec.d_ff),
        (3, base.d_model, base.shared_expert_d_ff),
        (4, base.d_model, base.d_model))) * 4
    layers = next(n for n in (base.n_layers, base.n_layers // 2,
                              base.n_layers // 4, 1)
                  if n * per_layer <= 0.6 * free)
    cfg = dataclasses.replace(base, dtype="float32", n_layers=layers,
                              moe_capacity_factor=spec.n_experts / spec.top_k)
    say(f"families: {FAM_MOE} in float32 with capacity factor "
        f"{cfg.moe_capacity_factor} (dropless): {layers} of {base.n_layers} "
        f"layers, the most (halving) whose float32 weights "
        f"({per_layer / 2 ** 30:.2f} GiB a layer) take at most 60% of the "
        f"{free / 2 ** 30:.1f} GiB free, leaving room for the embeddings "
        f"and the dropless buffers")
    params, _ = draw(cfg)
    toks = np.random.RandomState(SEED + 1).randint(
        0, cfg.vocab_size, (1, FAM_PROPERTY_PROMPT + 1)).astype(np.int32)
    dispatch.reset_launch_counts()
    res["moe_property_err"] = property_check(
        torch, f"{FAM_MOE} dropless", Model(cfg, device="cuda"), params, toks,
        FAM_PROPERTY_PROMPT, LM_F32_PROPERTY_TOL, LM_F32_PROPERTY_TOL)
    counts = dict(dispatch.launch_counts)
    if counts != {"mha": 2 * layers}:          # the forward and the prefill
        fail(f"{FAM_MOE} property: launch counts {counts}")
    add_counts(total, counts)
    res["moe_property_layers"] = layers
    del params
    torch.cuda.empty_cache()
    lap("f")

    res["counts"] = total
    say(f"families: phase 11's launches {total} in "
        f"{time.perf_counter() - t_phase:.1f} s on {smi}")
    return res


# -- phase 12: the VLM and audio families at full width ------------------------

def open_gates(torch, params, value: float) -> int:
    """Every cross block's gate_attn and gate_mlp at ``value``, in place;
    returns how many leaves were set."""
    gates = [p for n, p in params.named_parameters()
             if n.rsplit(".", 1)[-1] in ("gate_attn", "gate_mlp")]
    with torch.no_grad():
        for p in gates:
            p.fill_(value)
    return len(gates)


def x_counts(cfg, prefills: int, decode_calls: int) -> dict:
    """The launches a phase-12 serve run of ``cfg`` makes: one mha per
    attention and per cross-attention layer a prefill (the encoder's
    self-attention included), one per cross-attention layer a decode step
    (decode's self-attention keeps the masked plain path); with
    quantize_dense, an int_matmul per MLP linear (the VLM's gated MLP has
    3, whisper's 2) per layer per forward call, the encoder's a prefill."""
    if cfg.family == "audio":
        dec, enc = cfg.n_layers, cfg.encoder_layers
        out = {"mha": prefills * (enc + 2 * dec) + decode_calls * dec}
        mm = 2 * (prefills * (enc + dec) + decode_calls * dec)
    else:
        pattern = cfg.layer_pattern()
        out = {"mha": prefills * len(pattern)
               + decode_calls * pattern.count("cross")}
        mm = 3 * len(pattern) * (prefills + decode_calls)
    if cfg.quantize_dense:
        out["int_matmul"] = mm
    return out


def x_requests(torch, cfg) -> list:
    """Phase 12's requests: (prompt, the batch's extras on the card in
    bf16), drawn by SEED."""
    rng = np.random.RandomState(SEED)
    out = []
    for _ in range(X_REQUESTS):
        if cfg.family == "vlm":
            n = int(rng.randint(X_PROMPT_MIN, X_PROMPT_MAX + 1))
            name, shape = "vision", (1, cfg.vision_tokens, cfg.vision_dim)
        else:
            n, name, shape = X_AUDIO_PROMPT, "frames", (1, cfg.encoder_seq,
                                                        cfg.d_model)
        prompt = rng.randint(0, cfg.vocab_size, n).astype(np.int32)
        states = torch.from_numpy(rng.normal(0, 1, shape).astype(
            np.float32)).to("cuda", torch.bfloat16)
        out.append((prompt, {name: states}))
    return out


def serve_extras(torch, dispatch, name: str, cfg, params, reqs,
                 max_seq: int, total: dict, smi: str) -> dict:
    """Serve ``reqs`` one at a time as the reference's API runs them:
    Model.prefill of the prompt with its extras, then FAM_NEW - 1 batch-1
    Model.decode_step calls, greedy; the counts zeroed just before and
    checked exactly just after, every logit finite.  Prints the time to
    first token (the prefill and its argmax), ms per decode token, tokens/s
    and peak memory."""
    from repro_torch.models.api import Model
    model = Model(cfg, device="cuda")
    decode_calls = len(reqs) * (FAM_NEW - 1)
    expected = x_counts(cfg, len(reqs), decode_calls)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    outputs, ttft, dec, finite = [], [], [], True
    t_start = time.perf_counter()
    for prompt, extras in reqs:
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": prompt[None],
                                               **extras}, max_seq)
        tok = int(torch.argmax(logits[0, -1, :cfg.vocab_size]))
        ttft.append((time.perf_counter() - t0) * 1e3)
        out = [tok]
        finite &= bool(torch.isfinite(logits).all())
        for _ in range(FAM_NEW - 1):
            t0 = time.perf_counter()
            logits, cache = model.decode_step(
                params, np.array([[tok]], np.int32), cache)
            tok = int(torch.argmax(logits[0, -1, :cfg.vocab_size]))
            dec.append(time.perf_counter() - t0)
            out.append(tok)
            finite &= bool(torch.isfinite(logits).all())
        outputs.append(out)
    wall = time.perf_counter() - t_start
    counts = dict(dispatch.launch_counts)
    n_tok = sum(len(o) for o in outputs)
    r = {"outputs": outputs, "wall_s": wall, "tokens": n_tok,
         "tokens_per_s": n_tok / wall, "ttft_ms": ttft,
         "decode_ms": statistics.median(dec) * 1e3,
         "decode_calls": len(dec), "counts": counts,
         "peak_bytes": torch.cuda.max_memory_allocated()}
    say(f"vlm/audio: {name}: launch counts {counts} (expected {expected}: "
        f"{len(reqs)} prefills + {decode_calls} decode calls)")
    if counts != expected or not finite:
        fail(f"{name}: launch counts {counts} != {expected} or a "
             f"non-finite logit")
    say(f"serve: {name}: {len(reqs)} requests one at a time, prompts "
        f"{[len(p) for p, _ in reqs]}, {FAM_NEW} new tokens each: {n_tok} "
        f"tokens in {wall:.2f} s, {r['tokens_per_s']:.2f} tokens/s; time to "
        f"first token {', '.join(f'{t:.1f}' for t in ttft)} ms; "
        f"{r['decode_ms']:.2f} ms per decode token (median of {len(dec)} "
        f"batch-1 decode calls); peak device memory "
        f"{r['peak_bytes'] / 2 ** 30:.1f} GiB on {smi}")
    add_counts(total, counts)
    return r


def check_x_kernels(torch, prompt_lens: list) -> tuple[int, float, float]:
    """The kernels at the shapes phase 12 gives them, against their plain
    versions.  int_matmul exact (full-range int8) at whisper's MLP (384 x
    1536 and back) for M = 1 (a decode token), 4 (a prompt) and 1500 (the
    encoder) and at the VLM's (4096 x 14336 and back) for M = 1 and the
    shortest and longest prompts.  flash_attention non-causal (within
    MHA_BF16_ATOL / MHA_F32_ATOL, bf16 v around X_V_MEAN; the lse within
    TRAIN_LSE_ATOL of plain's) against 1601 vision states (32 query
    over 16 KV heads of 128) and 1500 encoder states (16 over 16 of 64)
    for Sq = 1, 64 and 300 in bf16 and float32, the decode step's over
    contiguous cached keys and values; the VLM's prompts' cross-attention;
    whisper's encoder in bf16 (serving) and float32 (training, B =
    X_TRAIN_BATCH); its training decoder's attention.  flash_attention_bwd
    (within TRAIN_BWD_*_RTOL of max |plain|) at whisper's training shapes.
    Returns the max abs errors (int_matmul, mha, mha_bwd)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import (mha_bwd_cuda,
                                                     mha_bwd_plain, mha_cuda,
                                                     mha_plain)
    from repro_torch.kernels.quant_matmul import (int_matmul_cuda,
                                                  int_matmul_plain)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    vlm, au = get_config(X_VLM), get_config(X_AUDIO)
    lo, hi = min(prompt_lens), max(prompt_lens)
    shapes = [(m, k, n) for cfg, ms in ((au, (1, X_AUDIO_PROMPT,
                                              au.encoder_seq)),
                                        (vlm, (1, lo, hi)))
              for m in ms for k, n in ((cfg.d_model, cfg.d_ff),
                                       (cfg.d_ff, cfg.d_model))]
    err_mm = 0
    for m, k, n in shapes:
        a, b = int8_operand(torch, gen, (m, k)), int8_operand(torch, gen,
                                                              (k, n))
        err_mm = max(err_mm, same(torch, [int_matmul_cuda(a, b)],
                                  [int_matmul_plain(a, b)]))
    say(f"vlm/audio: kernels: int_matmul == plain at (M, K, N) {shapes}")

    bf16, f32 = torch.bfloat16, torch.float32

    def qkv(b, hq, hkv, sq, skv, d, dtype, cached=False, v_mean=None):
        """[B, S, H, D] draws seen as [B, H, S, D]; bf16 v around X_V_MEAN
        unless ``v_mean`` says otherwise (a causal row averages few keys,
        so its output leaves [2, 4)); a decode step's cached k, v
        contiguous."""
        if v_mean is None:
            v_mean = X_V_MEAN if dtype == bf16 else 0.0
        q, k, v = ((torch.randn((b, s, h, d), generator=gen, device="cuda")
                    + m).to(dtype).transpose(1, 2)
                   for s, h, m in ((sq, hq, 0.0), (skv, hkv, 0.0),
                                   (skv, hkv, v_mean)))
        return (q, k.contiguous(), v.contiguous()) if cached else (q, k, v)
    vis, enc = vlm.vision_tokens, au.encoder_seq
    nc = {"causal": False}
    cases = [(f"{str(dt)[6:]} [1, {hq}, {sq}, {d}] against {skv} keys over "
              f"{hkv} KV heads, not causal"
              f"{' (cached k, v)' if sq == 1 else ''}",
              qkv(1, hq, hkv, sq, skv, d, dt, sq == 1), nc)
             for hq, hkv, d, skv in ((32, 16, 128, vis), (16, 16, 64, enc))
             for sq in (1, 64, 300) for dt in (bf16, f32)]
    cases += [(f"bf16 [1, 32, {s}, 128] against {vis} vision states, not "
               f"causal", qkv(1, 32, 16, s, vis, 128, bf16), nc)
              for s in (lo, hi)]
    b, s = X_TRAIN_BATCH, X_TRAIN_SEQ
    cases.append(
        (f"bf16 [1, 16, {enc}, 64], whisper's encoder serving, not causal",
         qkv(1, 16, 16, enc, enc, 64, bf16), nc))
    train = [           # whisper's training shapes
        (f"f32 [{b}, 16, {enc}, 64], whisper's encoder training, not causal",
         (b, 16, 16, enc, enc, 64, f32), nc),
        (f"bf16 [{b}, 16, {s}, 64] against {enc} encoder states, not causal",
         (b, 16, 16, s, enc, 64, bf16), nc),
        (f"bf16 [{b}, 16, {s}, 64], whisper's decoder, causal",
         (b, 16, 16, s, s, 64, bf16), {})]
    cases += [(name, qkv(*shape, v_mean=None if kw is nc else 0.0), kw)
              for name, shape, kw in train]
    err_fa = check_mha_cases(torch, cases, "vlm/audio: kernels: ")
    err_lse = 0.0
    for name, (q, k, v), kw in cases:
        if kw.get("causal", True):
            continue
        out, lse = mha_cuda(q, k, v, with_lse=True, **kw)
        want, lse_ref = mha_plain(q, k, v, with_lse=True, **kw)
        e = float((lse - lse_ref).abs().max())
        if not (torch.equal(out, mha_cuda(q, k, v, **kw))
                and e <= TRAIN_LSE_ATOL):
            fail(f"flash_attention: {name}: out with lse != out without, or "
                 f"lse off the plain logsumexp by {e} > {TRAIN_LSE_ATOL}")
        err_lse = max(err_lse, e)
    say(f"vlm/audio: kernels: flash_attention's lse ~ plain logsumexp in "
        f"every not-causal case above (max abs err {err_lse:.3g} <= "
        f"{TRAIN_LSE_ATOL}; bf16 v drawn around {X_V_MEAN})")

    err_bwd = 0.0
    for name, shape, kw in train:       # zero-mean v, as training's
        q, k, v = qkv(*shape, v_mean=0.0)
        dout = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
        out, lse = mha_cuda(q, k, v, with_lse=True, **kw)
        got = mha_bwd_cuda(q, k, v, out, dout, lse, **kw)
        want = mha_bwd_plain(q, k, v, out, dout, lse, **kw)
        tol = (TRAIN_BWD_BF16_RTOL if q.dtype == bf16
               else TRAIN_BWD_F32_RTOL)
        errs = [_rel_err(g, w) for g, w in zip(got, want)]
        say(f"vlm/audio: kernels: flash_attention_bwd ~ plain, {name}: dq "
            f"{errs[0]:.3g}, dk {errs[1]:.3g}, dv {errs[2]:.3g} of max "
            f"|plain| (<= {tol})")
        if not max(errs) <= tol:
            fail(f"flash_attention_bwd: {name}: errors {errs} > {tol}")
        err_bwd = max(err_bwd, max(float((g.float() - w.float()).abs().max())
                                   for g, w in zip(got, want)))
    return err_mm, err_fa, err_bwd


def x_kernel_times(torch, prompt_lens: list) -> dict:
    """flash_attention at the cross-attention shapes phase 12 serves:
    kernel, plain, the bound from its declared cost and
    F.scaled_dot_product_attention (enable_gqa) on the same inputs, the
    achieved TFLOP/s and the share of the bound."""
    import torch.nn.functional as F
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.flash_attention import mha_cuda, mha_plain
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    vis, enc = (get_config(X_VLM).vision_tokens,
                get_config(X_AUDIO).encoder_seq)
    shapes = {"vlm decode cross": (32, 16, 128, 1, vis),
              "vlm prefill cross": (32, 16, 128, max(prompt_lens), vis),
              "whisper encoder": (16, 16, 64, enc, enc),
              "whisper decode cross": (16, 16, 64, 1, enc)}
    flush = L2Flush(torch)
    out = {}
    for name, (hq, hkv, d, sq, skv) in shapes.items():
        q = (torch.randn((1, sq, hq, d), generator=gen, device="cuda")
             .to(torch.bfloat16).transpose(1, 2))
        k, v = (torch.randn((1, skv, hkv, d), generator=gen, device="cuda")
                .to(torch.bfloat16).transpose(1, 2) for _ in range(2))
        if sq == 1:                     # a decode step reads the cache
            k, v = k.contiguous(), v.contiguous()
        t = dict(shape=[1, hq, sq, d], keys=skv, kv_heads=hkv,
                 ms=cuda_ms(torch, lambda: mha_cuda(q, k, v, causal=False),
                            flush),
                 plain_ms=cuda_ms(torch, lambda: mha_plain(q, k, v,
                                                           causal=False),
                                  flush),
                 library_ms=cuda_ms(
                     torch, lambda: F.scaled_dot_product_attention(
                         q, k, v, is_causal=False, enable_gqa=True), flush))
        cost = dispatch.declared_cost("mha", q, k, v, causal=False)
        t["bound_ms"], t["bound_by"] = bound(cost.bytes, cost.ops,
                                             PEAK_OPS_PER_S[cost.rate])
        t["bound_share"] = t["bound_ms"] / t["ms"]
        t["tflops"] = cost.ops / t["ms"] / 1e9
        out[name] = t
    del flush
    return out


def x_card_equals_cpu(torch, dispatch, total: dict) -> dict:
    """Both families reduced to float32, the VLM's gates at X_GATE, the
    same weights on the card and the CPU: forward logits (within
    LM_F32_ATOL; with the gates shut the VLM's logits move), prefill + 3
    decode steps against the forward on the card (LM_F32_PROPERTY_TOL),
    one value_and_grad (FAM_LOSS_ATOL, each leaf within FAM_GRAD_RTOL of
    its norm; the card's mha and mha_bwd launches counted) and one
    launch/train.py step (its build, batch and step function) with the
    same loss."""
    import copy
    from repro_torch.configs.base import get_config
    from repro_torch.data.tokens import MarkovCorpus
    from repro_torch.launch import train as launch_train
    from repro_torch.models.api import Model
    from repro_torch.train.loop import value_and_grad
    out = {}
    for arch in (X_VLM, X_AUDIO):
        cfg = get_config(arch).reduced()
        weights = Model(cfg, device="cpu").init(
            torch.Generator().manual_seed(SEED))
        n_gates = open_gates(torch, weights, X_GATE)
        batch = launch_train.draw_batch(
            cfg, MarkovCorpus(cfg.vocab_size, seed=SEED), X_REDUCED_BATCH,
            X_REDUCED_SEQ, 0)
        extras = {k: v for k, v in batch.items()
                  if k not in ("tokens", "targets")}
        res = {}
        for device in ("cuda", "cpu"):
            model = Model(cfg, device=device)
            params = copy.deepcopy(weights).to(device)
            logits = model.forward(params, batch)
            if device == "cuda":
                shut = copy.deepcopy(params)
                open_gates(torch, shut, 0.0)
                moved = float((model.forward(shut, batch) - logits).abs()
                              .max())
                del shut
                prop = property_check(
                    torch, f"{arch} reduced", model, params,
                    batch["tokens"], X_REDUCED_SEQ - 3, LM_F32_PROPERTY_TOL,
                    LM_F32_PROPERTY_TOL, extras)
            params.trainable_()
            dispatch.reset_launch_counts()
            loss, grads = value_and_grad(model, params, batch)
            if device == "cuda":
                torch.cuda.synchronize()
                grad_counts = dict(dispatch.launch_counts)
            _, _, opt, step_fn = launch_train.build(arch, reduced=True,
                                                    device=device)
            _, _, metrics = step_fn(params, opt.init(params), batch)
            res[device] = (logits.cpu(), float(loss),
                           {n: g.cpu() for n, g in grads.items()},
                           float(metrics["loss"]))
        (lg, sg, gg, mg), (lc, sc, gc, mc) = res["cuda"], res["cpu"]
        err = float((lg - lc).abs().max())
        worst = max(((n, _leaf_rel(gg[n], gc[n])) for n in gc),
                    key=lambda kv: kv[1])
        attn = (cfg.encoder_layers + 2 * cfg.n_layers
                if cfg.family == "audio" else cfg.n_layers)
        want = {"mha": attn, "mha_bwd": attn}
        say(f"  {arch} reduced f32, {n_gates} gates at {X_GATE}: card vs "
            f"CPU forward max |dlogit| {err:.3g} (<= {LM_F32_ATOL}); gates "
            f"shut move the logits by {moved:.3g}; loss {sg:.6f} / "
            f"{sc:.6f}, launch/train.py step's loss {mg:.6f} / {mc:.6f} (<= "
            f"{FAM_LOSS_ATOL}); worst gradient leaf {worst[0]} at "
            f"{worst[1]:.3g} (<= {FAM_GRAD_RTOL}); the grad's launches "
            f"{grad_counts} (expected {want})")
        if not (err <= LM_F32_ATOL and abs(sg - sc) <= FAM_LOSS_ATOL
                and abs(mg - mc) <= FAM_LOSS_ATOL
                and worst[1] <= FAM_GRAD_RTOL and grad_counts == want
                and (cfg.family == "audio" or moved > 1e3 * LM_F32_ATOL)):
            fail(f"{arch} reduced: the card and the CPU disagree, or the "
                 f"gates do not reach the logits")
        add_counts(total, grad_counts)
        out[arch] = {"logit_err": err, "grad_err": worst[1],
                     "loss_err": abs(sg - sc), "property_err": prop}
    return out


def audio_train_on_card(torch, dispatch, total: dict, smi: str) -> dict:
    """whisper-tiny at full width trained through launch/train.py: step 1's
    loss and every gradient leaf against the same step with plain
    attention under autograd (TRAIN_LOSS_ATOL, TRAIN_GRAD_RTOL; every
    cross-attention weight's gradient nonzero), then X_TRAIN_STEPS steps
    through train(..., reduced=False) with the counts exact: the encoder's
    4 mha, the decoder's 8 and their remat recompute's 8 a step, and an
    mha_bwd for each of the 12 attentions; then ms a step and tokens/s
    (launch.train's step function on one batch, host clock, synchronised,
    the median of TRAIN_TIMED_STEPS after a warm step)."""
    from repro_torch.data.tokens import MarkovCorpus
    from repro_torch.kernels.flash_attention import mha_plain
    from repro_torch.launch import train as launch_train
    from repro_torch.models import attention as attention_mod
    from repro_torch.train.loop import value_and_grad
    cfg, model, opt, step_fn = launch_train.build(X_AUDIO, reduced=False,
                                                  device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    params.trainable_()
    batch = launch_train.draw_batch(cfg, MarkovCorpus(cfg.vocab_size,
                                                      seed=SEED),
                                    X_TRAIN_BATCH, X_TRAIN_SEQ, 0)
    loss_k, grads_k = value_and_grad(model, params, batch)
    kernel_mha = attention_mod.mha
    attention_mod.mha = mha_plain           # the check's plain attention
    try:
        loss_p, grads_p = value_and_grad(model, params, batch)
    finally:
        attention_mod.mha = kernel_mha
    worst = max(((n, _leaf_rel(grads_k[n], grads_p[n])) for n in grads_k),
                key=lambda kv: kv[1])
    dloss = abs(float(loss_k) - float(loss_p))
    dead = [n for n in grads_k if ".cross.w" in n
            and not torch.any(grads_k[n])]
    say(f"vlm/audio: {X_AUDIO} step 1 at full width (B={X_TRAIN_BATCH}, "
        f"decoder {X_TRAIN_SEQ} tokens over {cfg.encoder_seq} float32 "
        f"frames), kernels against plain attention under autograd: loss "
        f"{float(loss_k):.5f} / {float(loss_p):.5f} (|d| {dloss:.3g} <= "
        f"{TRAIN_LOSS_ATOL}); worst leaf {worst[0]} at {worst[1]:.3g} (<= "
        f"{TRAIN_GRAD_RTOL} of its norm); cross weights with a zero "
        f"gradient: {dead}")
    if not (dloss <= TRAIN_LOSS_ATOL and worst[1] <= TRAIN_GRAD_RTOL
            and not dead):
        fail(f"{X_AUDIO}: the kernels' step-1 loss or gradients are off the "
             f"plain attention's")
    del params, grads_k, grads_p
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    params, losses, _ = launch_train.train(
        X_AUDIO, steps=X_TRAIN_STEPS, batch=X_TRAIN_BATCH, seq=X_TRAIN_SEQ,
        reduced=False, seed=SEED, log_every=1, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(dispatch.launch_counts)
    opt_state = opt.init(params)
    times = []
    for _ in range(1 + TRAIN_TIMED_STEPS):     # a warm step, then timed
        t0 = time.perf_counter()
        params, opt_state, _ = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_ms = statistics.median(times[1:]) * 1e3
    enc, dec = cfg.encoder_layers, cfg.n_layers
    expected = {"mha": X_TRAIN_STEPS * (enc + 2 * 2 * dec),
                "mha_bwd": X_TRAIN_STEPS * (enc + 2 * dec)}
    peak = torch.cuda.max_memory_allocated()
    say(f"train: {X_AUDIO} at full width, remat {cfg.remat}: "
        f"{X_TRAIN_STEPS} steps through launch.train in {wall:.2f} s (init "
        f"included), losses {losses}, peak {peak / 2 ** 30:.2f} GiB; launch "
        f"counts {counts} (expected {expected}); {step_ms:.1f} ms a step "
        f"(median of {TRAIN_TIMED_STEPS}), "
        f"{X_TRAIN_BATCH * X_TRAIN_SEQ / step_ms * 1e3:.0f} decoder tokens/s"
        f" on {smi}")
    if counts != expected or not np.all(np.isfinite(losses)):
        fail(f"{X_AUDIO} train: counts {counts} != {expected} or losses "
             f"{losses} not finite")
    add_counts(total, counts)
    return {"losses": losses, "wall_s": wall, "peak_bytes": peak,
            "step_ms": step_ms, "step1_loss_err": dloss,
            "step1_grad_err": worst[1]}


def vlm_audio_on_card(torch, dispatch, smi: str) -> dict:
    """Phase 12: llama-3.2-vision-11b (40 layers, 8 of them gated
    cross-attention over 1601 vision states) and whisper-tiny (4 encoder
    and 4 decoder layers over 1500 frames) at full width, bf16, seeded
    random weights, served as the reference's API runs them with
    quantize_dense off and on; the kernels at their shapes first; both
    families reduced, card against CPU; whisper-tiny trained at full
    width.  Returns the phase's launch counts, errors and numbers."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.api import Model
    from repro_torch.models.transformer import attn_spec
    t_phase = time.perf_counter()
    total, res = {}, {"seconds": {}}
    torch.cuda.empty_cache()
    marks = [t_phase]

    def lap(part: str) -> None:
        now = time.perf_counter()
        res["seconds"][part] = now - marks[-1]
        say(f"vlm/audio: ({part}) took {now - marks[-1]:.1f} s")
        marks.append(now)

    vlm = get_config(X_VLM)
    vlm_reqs = x_requests(torch, vlm)
    prompt_lens = [len(p) for p, _ in vlm_reqs]
    res["err_mm"], res["err_fa"], res["err_bwd"] = check_x_kernels(
        torch, prompt_lens)
    res["times"] = x_kernel_times(torch, prompt_lens)
    for name, t in res["times"].items():
        say(f"timing: flash_attention {name} bf16 {t['shape']} against "
            f"{t['keys']} keys over {t['kv_heads']} KV heads, not causal: "
            f"kernel {t['ms']:.4f} ms ({t['tflops']:.2f} TFLOP/s, "
            f"{100 * t['bound_share']:.1f}% of the bound {t['bound_ms']:.4f} "
            f"ms by {t['bound_by']}), plain {t['plain_ms']:.4f} ms, "
            f"F.scaled_dot_product_attention {t['library_ms']:.4f} ms (on "
            f"{smi})")
    lap("kernels")

    # llama-3.2-vision-11b: quantize_dense off, then on; gates open
    t0 = time.perf_counter()
    params = Model(vlm, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = Model.param_count(params)
    plan = attn_spec(vlm).plan
    first = {"tokens": vlm_reqs[0][0][None], **vlm_reqs[0][1]}
    shut, _ = Model(vlm, device="cuda").prefill(params, first, LM_MAX_SEQ)
    n_gates = open_gates(torch, params, X_GATE)
    opened, _ = Model(vlm, device="cuda").prefill(params, first, LM_MAX_SEQ)
    moved = float((opened.float() - shut.float()).abs().max())
    say(f"vlm/audio: {X_VLM} at full width: {vlm.n_layers} layers "
        f"({vlm.layer_pattern().count('cross')} gated cross-attention), "
        f"d_model {vlm.d_model}, {vlm.n_heads} query / {vlm.n_kv_heads} KV "
        f"heads (padded to {plan.n_q} / {plan.n_kv}), d_ff {vlm.d_ff}, "
        f"vocab {vlm.vocab_size}, {vlm.vision_tokens} vision states "
        f"{vlm.vision_dim} wide, bf16, {n_params:,} parameters drawn in "
        f"{time.perf_counter() - t0:.1f} s; device memory "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB; all {n_gates} "
        f"gate leaves set to {X_GATE} (init leaves them 0): the first "
        f"prompt's logits moved by {moved:.3g}")
    if not moved > 0.01:
        fail(f"{X_VLM}: opening the gates did not move the logits")
    del shut, opened
    v = {"params": n_params, "gate_moved": moved}
    for mode, q in (("off", False), ("on", True)):
        cfg = dataclasses.replace(vlm, quantize_dense=q)
        v[mode] = serve_extras(torch, dispatch,
                               f"{X_VLM} quantize_dense {mode}", cfg,
                               params, vlm_reqs, LM_MAX_SEQ, total, smi)
        v[mode]["profile"] = family_profile(
            torch, Model(cfg, device="cuda"), params, *vlm_reqs[0])
        say(f"profile: {LM_PROFILE_STEPS} decode steps, {X_VLM} "
            f"quantize_dense {mode}: {v[mode]['profile']}")
    res[X_VLM] = v
    del params, vlm_reqs
    torch.cuda.empty_cache()
    lap("vlm")

    # whisper-tiny: quantize_dense off, then on
    au = get_config(X_AUDIO)
    params = Model(au, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(SEED))
    au_reqs = x_requests(torch, au)
    a = {"params": Model.param_count(params)}
    plan = attn_spec(au).plan
    say(f"vlm/audio: {X_AUDIO} at full width: {au.encoder_layers} encoder "
        f"and {au.n_layers} decoder layers, d_model {au.d_model}, "
        f"{au.n_heads} heads of {au.resolved_head_dim} (padded to "
        f"{plan.n_q} / {plan.n_kv}), d_ff {au.d_ff}, GELU, vocab "
        f"{au.vocab_size}, {au.encoder_seq} frames, bf16, "
        f"{a['params']:,} parameters")
    for mode, q in (("off", False), ("on", True)):
        cfg = dataclasses.replace(au, quantize_dense=q)
        a[mode] = serve_extras(torch, dispatch,
                               f"{X_AUDIO} quantize_dense {mode}", cfg,
                               params, au_reqs, X_TRAIN_SEQ, total, smi)
        a[mode]["profile"] = family_profile(
            torch, Model(cfg, device="cuda"), params, *au_reqs[0])
        say(f"profile: {LM_PROFILE_STEPS} decode steps, {X_AUDIO} "
            f"quantize_dense {mode}: {a[mode]['profile']}")
    res[X_AUDIO] = a
    del params, au_reqs
    torch.cuda.empty_cache()
    lap("audio")

    res["card_vs_cpu"] = x_card_equals_cpu(torch, dispatch, total)
    lap("card vs cpu")
    res["train"] = audio_train_on_card(torch, dispatch, total, smi)
    torch.cuda.empty_cache()
    lap("train")
    res["counts"] = total
    say(f"vlm/audio: phase 12's launches {total} in "
        f"{time.perf_counter() - t_phase:.1f} s on {smi}")
    return res


# -- phase 15: the dense LM on sharded parameters ------------------------------

def _local_param_bytes(params) -> int:
    return sum(getattr(p, "_local_tensor", p).numel() * p.element_size()
               for p in params.parameters())


def _shard_digests(params) -> dict:
    """name -> (the cuts that take this rank's shard of the leaf from its
    whole value: (dim, parts, index) a split mesh dim, in mesh order; the
    sha256 of the shard's bits): a sharded state's digest with no
    gather."""
    out = {}
    for name, p in params.named_parameters():
        t, cuts = p.detach(), []
        if hasattr(t, "placements"):
            mesh, coord = t.device_mesh, t.device_mesh.get_coordinate()
            cuts = [(pl.dim, mesh.size(i), coord[i])
                    for i, pl in enumerate(t.placements) if pl.is_shard()]
            t = t.to_local()
        out[name] = (cuts, _sha256(t))
    return out


def _slice_digests(params, shards: dict) -> dict:
    """The sha256 of each whole leaf of ``params`` cut as ``shards`` (a
    rank's :func:`_shard_digests`) says."""
    out = {}
    for name, p in params.named_parameters():
        t = p.detach()
        for dim, parts, index in shards[name][0]:
            t = t.chunk(parts, dim=dim)[index]
        out[name] = _sha256(t)
    return out


def _restore_mismatch(saved: list, restored: list) -> list:
    """The leaves whose restored cuts (:func:`_slice_digests`, one dict a
    rank) differ from a rank's shards (:func:`_shard_digests`, one a
    rank), or that one side lacks."""
    out = set()
    for shards, got in zip(saved, restored):
        want = {n: d for n, (_, d) in shards.items()}
        out |= {n for n in want.keys() | got.keys()
                if want.get(n) != got.get(n)}
    return sorted(out)


def _sha256(t) -> str:
    import hashlib
    t = t.contiguous()
    return hashlib.sha256(t.view(torch_dtype_bits(t)).cpu().numpy()
                          .tobytes()).hexdigest()


def torch_dtype_bits(t):
    import torch
    return {1: torch.int8, 2: torch.int16, 4: torch.int32}[t.element_size()]


class KernelChecks:
    """Wraps the CUDA wrappers of ``ops`` in the registry: every launch
    keeps its operand shapes (the first two tensors') and is held against
    the op's plain version on the same operands, the rank's own shards
    (the plain versions count no launch): int_matmul exactly; mha and
    mha_bwd within TRAIN_BWD_BF16_RTOL of max |plain|, mha's lse within
    TRAIN_LSE_ATOL.  The model's own activations, not unit-scale draws:
    its prefill attention outputs reach [4, 8), where one bf16 rounding
    (2**-8 of a value, TRAIN_BWD_BF16_RTOL's reason) is 0.03125, above
    MHA_BF16_ATOL's absolute 2e-2."""

    def __init__(self, torch, dispatch, ops):
        self.torch, self.dispatch, self.ops = torch, dispatch, ops
        self.shapes, self.errs, self.checked, self.over = {}, {}, {}, []

    def __enter__(self):
        self.saved = {op: self.dispatch.get_op(op) for op in self.ops}
        for op, entry in self.saved.items():
            def wrapped(*args, _entry=entry, _op=op, **kwargs):
                out = _entry.cuda(*args, **kwargs)
                self.check(_op, _entry.plain, out, args, kwargs)
                return out
            self.dispatch._OPS[op] = dataclasses.replace(entry, cuda=wrapped)
        return self

    def __exit__(self, *exc):
        self.dispatch._OPS.update(self.saved)

    def check(self, op, plain, out, args, kwargs) -> None:
        with self.torch.no_grad():
            self._check(op, plain, out, args, kwargs)

    def _check(self, op, plain, out, args, kwargs) -> None:
        shapes = tuple(tuple(a.shape) for a in args[:2])
        self.shapes.setdefault(op, set()).add(shapes)
        self.checked[op] = self.checked.get(op, 0) + 1
        got = out if isinstance(out, tuple) else (out,)
        want = plain(*args, **kwargs)
        want = want if isinstance(want, tuple) else (want,)
        if args[0].dtype not in (self.torch.int8, self.torch.bfloat16):
            self.over.append(f"{op} ran on {args[0].dtype}, not the main "
                             f"path's type")
        if op == "int_matmul":
            errs = {op: (float((got[0].long() - want[0].long()).abs().max()),
                         0.0)}
        elif op == "mha":
            errs = {op: (_rel_err(got[0], want[0]), TRAIN_BWD_BF16_RTOL),
                    "mha abs": (float((got[0].float() - want[0].float())
                                      .abs().max()), float("inf"))}
            if len(got) > 1:
                errs["mha lse"] = (float((got[1] - want[1]).abs().max()),
                                   TRAIN_LSE_ATOL)
        else:
            errs = {op: (max(_rel_err(g, w) for g, w in zip(got, want)),
                         TRAIN_BWD_BF16_RTOL),
                    "mha_bwd abs": (max(float((g.float() - w.float()).abs()
                                              .max())
                                        for g, w in zip(got, want)),
                                    float("inf"))}
        for name, (err, tol) in errs.items():
            self.errs[name] = max(self.errs.get(name, 0.0), err)
            if not err <= tol:
                self.over.append(f"{name} at {shapes}: {err} > {tol}")

    def report(self) -> dict:
        return {"shapes": {op: sorted(s) for op, s in self.shapes.items()},
                "kernel_errs": dict(self.errs),
                "kernel_checked": dict(self.checked),
                "kernel_over": list(self.over)}


class CollectiveTimer:
    """Times every DTensor redistribution (each a collective, or a local
    slice) on the host clock, the card synchronised before and after."""

    def __init__(self, torch):
        from torch.distributed.tensor import _api, _dispatch, _redistribute
        self.torch, self.mods = torch, (_api, _dispatch, _redistribute)
        self.seconds, self.calls = 0.0, 0

    def __enter__(self):
        real = self.mods[2].redistribute_local_tensor

        def timed(*args, **kwargs):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*args, **kwargs)
            self.torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out
        self.real = real
        for m in self.mods:
            m.redistribute_local_tensor = timed
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m.redistribute_local_tensor = self.real


def tp_prompts(vocab: int) -> np.ndarray:
    return np.random.RandomState(SEED).randint(
        0, vocab, (TP_PROMPTS, TP_PROMPT_LEN)).astype(np.int32)


def tp_serve(torch, dispatch, model, params, prompts, tokens=None,
             new: int = TP_NEW, extras=None) -> dict:
    """Prefill ``prompts`` (the batch's ``extras`` beside them: the VLM's
    vision states, whisper's frames) then ``new`` decode steps, greedy (or
    fed ``tokens`` [new, B]): last logits each step (float32, whole),
    tokens, ms, launch counts."""
    from repro_torch.distributed.tp import full_tensor

    def whole(t):
        return full_tensor(t)[:, -1].float().cpu().numpy()
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": prompts,
                                               **(extras or {})},
                                      max_seq=prompts.shape[1] + new)
        out = [whole(logits)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        toks = []
        for i in range(new):
            tok = (out[-1].argmax(-1) if tokens is None else tokens[i])
            toks.append(np.asarray(tok, dtype=np.int32))
            logits, cache = model.decode_step(
                params, torch.as_tensor(toks[-1][:, None]), cache)
            out.append(whole(logits))
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {"logits": np.stack(out), "tokens": np.stack(toks),
            "prefill_ms": (t1 - t0) * 1e3,
            "decode_ms": (t2 - t1) * 1e3 / new,
            "counts": dict(dispatch.launch_counts)}


class QuantDenseHook:
    """Replaces ``models.quantized.quant_dense`` (what every quantized
    linear of the model calls) with ``self`` while entered."""

    def __enter__(self):
        from repro_torch.models import quantized
        self.module, self.orig = quantized, quantized.quant_dense
        quantized.quant_dense = self
        return self

    def __exit__(self, *exc):
        self.module.quant_dense = self.orig


class Int8Check(QuantDenseHook):
    """On the ranks, every quantized linear: its sharded int8 activations
    gathered against the one-process quantization of its gathered input
    (the elements that differ counted); for the first ``keep`` calls also
    the sharded int_matmul (int32 partial sums reduced) against
    ``int_matmul_cuda`` on the gathered operands, launches not counted.
    With ``record``, the gathered int8 activations and their scale, in
    call order, on the host (the one-process run is fed them:
    :class:`Int8Feed`)."""

    def __init__(self, keep: int, record: bool):
        self.keep, self.record = keep, record
        self.calls, self.diff, self.gathered, self.gathered_diff = 0, 0, 0, 0
        self.elements, self.records = 0, []

    def __call__(self, x, w_q, w_scale):
        from repro_torch.core.quantization import symmetric_quantize
        from repro_torch.distributed.tp import full_tensor
        from repro_torch.kernels import dispatch
        from repro_torch.kernels.quant_matmul import int_matmul_cuda
        flat = x.reshape(-1, x.shape[-1])
        x_q, xp = symmetric_quantize(flat, bits=8)
        got_q = full_tensor(x_q)
        want_q, _ = symmetric_quantize(full_tensor(flat), bits=8)
        self.diff += int((got_q != want_q).sum())
        self.elements += got_q.numel()
        if self.record:
            self.records.append((got_q.cpu(), full_tensor(xp.scale).cpu()))
        if self.calls < self.keep:
            counts = dict(dispatch.launch_counts)
            acc = full_tensor(dispatch.launch("int_matmul", x_q, w_q))
            want = int_matmul_cuda(want_q, full_tensor(w_q).contiguous())
            self.gathered_diff += int((acc != want).sum())
            self.gathered += 1
            dispatch.launch_counts.clear()
            dispatch.launch_counts.update(counts)
        self.calls += 1
        return self.orig(x, w_q, w_scale)


class Int8Feed(QuantDenseHook):
    """In the one-process run, quantized linear i quantizes its own input
    and counts the int8 elements that differ from the sharded run's call
    i (the flips between the runs); with ``feed`` it then multiplies the
    sharded run's int8 activations and scale in place of its own, so the
    int8 rounding of one run cannot move the other."""

    def __init__(self, records: list, feed: bool):
        self.records, self.feed = records, feed
        self.flips, self.sizes = [], []

    def __call__(self, x, w_q, w_scale):
        from repro_torch.core.quantization import symmetric_quantize
        from repro_torch.kernels import dispatch
        lead, k = x.shape[:-1], x.shape[-1]
        x_q, _ = symmetric_quantize(x.reshape(-1, k), bits=8)
        rec_q, rec_scale = self.records[len(self.flips)]
        rec_q = rec_q.to(x.device)
        self.flips.append(int((x_q != rec_q).sum()))
        self.sizes.append(x_q.numel())
        if not self.feed:
            return self.orig(x, w_q, w_scale)
        out = dispatch.launch("quant_matmul", rec_q, w_q,
                              rec_scale.to(x.device), w_scale)
        return out.reshape(*lead, -1).to(x.dtype)


def tp_rank(rank: int, ckpt_dir: str, int8_path: str) -> dict:
    """Phase 15 on one of TP_RANKS ranks of a ("data"=1, "model"=2) mesh:
    (a) qwen3-8b served with quantize_dense on and off: once checked
    (every kernel launch against its plain version on the rank's shards,
    every quantized linear's int8 activations; rank 0 writes them to
    ``int8_path`` for the one-process run), once timed, and off once more
    with the collectives timed; (b) granite-3-8b's train step at
    TP_TRAIN_LAYERS layers, its kernels checked; (c) its params saved;
    (d) the launch counts and the shapes each kernel ran at."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.distributed.act_sharding import use_mesh
    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import Model
    from repro_torch.optim.adam import AdamW
    from repro_torch.train import checkpoint
    from repro_torch.train.loop import make_train_step
    mesh = make_mesh((1, TP_RANKS), ("data", "model"), "cuda")
    res = {"jax": "jax" in sys.modules}
    cfg = get_config(LM_ARCH)
    with use_mesh(mesh):
        model = Model(cfg, "cuda")
        params = model.place(model.init(torch.Generator(
            device="cuda").manual_seed(SEED)), mesh)
        res["param_bytes"] = _local_param_bytes(params)
        torch.cuda.empty_cache()
        prompts = tp_prompts(cfg.vocab_size)
        for quant in (True, False):
            m = Model(dataclasses.replace(cfg, quantize_dense=quant), "cuda")
            tp_serve(torch, dispatch, m, params, prompts[:, :16], new=1)  # warm-up
            with KernelChecks(torch, dispatch, ("mha", "int_matmul")) as kc, \
                    Int8Check(TP_INT8_CALLS, record=quant and rank == 0) \
                    as i8:
                run = tp_serve(torch, dispatch, m, params, prompts)
            if i8.records:
                torch.save(i8.records, int8_path)
            run.update(kc.report(), int8_calls=i8.calls, int8_diff=i8.diff,
                       int8_elements=i8.elements, int8_gathered=i8.gathered,
                       int8_gathered_diff=i8.gathered_diff)
            del i8
            timed = tp_serve(torch, dispatch, m, params, prompts,
                             tokens=run["tokens"])
            run["prefill_ms"], run["decode_ms"] = (timed["prefill_ms"],
                                                   timed["decode_ms"])
            run["timed_counts"] = timed["counts"]
            if not quant:
                with CollectiveTimer(torch) as ct:
                    t0 = time.perf_counter()
                    tp_serve(torch, dispatch, m, params, prompts,
                             tokens=run["tokens"])
                    wall = time.perf_counter() - t0
                run["coll_share"] = ct.seconds / wall
                run["coll_calls"] = ct.calls
            res["serve", quant] = run
        res["peak_serve"] = torch.cuda.max_memory_allocated()
        del params
        torch.cuda.empty_cache()

        tcfg = dataclasses.replace(get_config(TRAIN_ARCH),
                                   n_layers=TP_TRAIN_LAYERS)
        tmodel = Model(tcfg, "cuda")
        params = tmodel.place(tmodel.init(torch.Generator(
            device="cuda").manual_seed(SEED)), mesh).trainable_()
        opt = AdamW(lr=TRAIN_LR)
        state = opt.init(params)
        step = make_train_step(tmodel, opt)
        batch = tp_train_batch(tcfg.vocab_size)
        torch.cuda.synchronize()
        dispatch.reset_launch_counts()
        with KernelChecks(torch, dispatch, ("mha", "mha_bwd")) as kc:
            params, state, m = step(params, state, batch)
            loss = float(m["loss"])
            torch.cuda.synchronize()
        res["train"] = {"loss": loss, "grad_norm": float(m["grad_norm"]),
                        "counts": dict(dispatch.launch_counts),
                        **kc.report(),
                        "step_ms": timed_step(torch, step, params, state,
                                              batch)}
        checkpoint.save(ckpt_dir, 1, params)
        res["saved"] = _shard_digests(params)
    return res


def timed_step(torch, step, params, state, batch) -> float:
    """ms of one more step (the first one warmed the card's paths)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(params, state, batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def tp_train_batch(vocab: int) -> dict:
    rng = np.random.RandomState(SEED + 1)
    return {k: rng.randint(0, vocab, (TRAIN_BATCH, TRAIN_SEQ))
            .astype(np.int32) for k in ("tokens", "targets")}


#: phase 15 (e)'s, 16 (d)'s, 17 (d)'s and 18 (d)'s dry-run cells beside
#: qwen3-8b's TP_DRY_SHAPES: (arch, shape), each also on (1, TP_RANKS)
DRY_CELLS = ((FAM_MOE, "decode_32k"), (FAM_XLSTM, "long_500k"),
             (FAM_HYMBA, "decode_32k"), (X_VLM, "decode_32k"),
             (X_AUDIO, "decode_32k"))


def tp_dryrun_start(out_dir: Path) -> list:
    """Start phase 15 (e)'s and 16-18 (d)'s dry-run on fake CUDA tensors
    in four processes of their own (each owns a fake process group in
    turn): qwen3-8b's train_4k on the 1pod mesh; the same on 2pod;
    DRY_CELLS on both; qwen3-8b's other TP_DRY_SHAPES on both, then its
    decode_32k and DRY_CELLS on (1, TP_RANKS).  Two processes, one a
    production mesh, kept the script waiting 58.6 s after the data's
    set-up once phase 18 added its cells.  Each writes its own
    results."""
    out_dir.mkdir(parents=True, exist_ok=True)
    code = ("import sys; from repro_torch.launch import dryrun; "
            "[dryrun.main(['--device', 'cuda', '--results', sys.argv[1], "
            "*run.split()]) for run in sys.argv[2:]]")
    lm = [f"--arch {LM_ARCH} --shape {s}" for s in TP_DRY_SHAPES]
    cells = [f"--arch {a} --shape {s}" for a, s in DRY_CELLS]
    train, rest = lm[TP_DRY_SHAPES.index("train_4k")], [
        c for c in lm if not c.endswith("train_4k")]
    groups = {
        "train_1pod": [f"{train} --single-pod-only"],
        "train_2pod": [f"{train} --multi-pod-only"],
        "cells": cells,
        "rest": rest + [f"{c} --single-pod-only --mesh-shape 1,{TP_RANKS}"
                        for c in (f"--arch {LM_ARCH} --shape decode_32k",
                                  *cells)]}
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    started = []
    for name, runs in groups.items():
        results = out_dir / f"dryrun_{name}.json"
        if results.exists():
            results.unlink()
        log = open(out_dir / f"dryrun_{name}.log", "w")
        proc = subprocess.Popen([sys.executable, "-c", code, str(results),
                                 *runs], env=env, stdout=log,
                                stderr=subprocess.STDOUT)
        started.append((proc, results, log))
    return started


def tp_dryrun_finish(started: list, tp: dict, moe: dict, ssm: dict,
                     xtp: dict, smi: str) -> dict:
    """Wait for phase 15 (e) and 16-18 (d), check their cells and print
    their roofline rows.  The VLM's ranks hold X_VLM_LAYERS of its 40
    layers: its bytes a rank of the whole model are theirs of the
    top-level leaves and 40 / X_VLM_LAYERS times their layers' (every
    unit alike)."""
    from repro_torch.launch import roofline
    t0 = time.perf_counter()
    entries = {}
    for proc, results, log in started:
        try:
            rc = proc.wait(timeout=TP_DRY_TIMEOUT)
        except subprocess.TimeoutExpired:
            for p, _, _ in started:
                p.kill()
                p.wait()
            fail(f"tp (e): the dry-run did not end in {TP_DRY_TIMEOUT:g} s")
        log.close()
        if rc != 0:
            say(Path(log.name).read_text()[-3000:])
            fail(f"tp (e): the dry-run exited {rc}")
        entries.update(json.loads(results.read_text()))
    say(f"tp (e): waited {time.perf_counter() - t0:.1f} s for the dry-run "
        f"after the data's set-up")
    for key, e in sorted(entries.items()):
        if e["status"] != "ok":
            fail(f"tp (e): {key} is {e['status']}: {e.get('error')}")
        c = e["corrected"]
        say(f"tp (e) {key}: {e['mesh']}, traced in {e['trace_s']} s: "
            f"{c['flops']:.4e} flops, {c['collective_bytes']:.4e} B of "
            f"collectives {c['collective_counts']}, params "
            f"{e['param_bytes'] / 2 ** 30:.3f} GiB, arguments "
            f"{e['argument_bytes'] / 2 ** 30:.3f} GiB, peak "
            f"{e['peak_bytes'] / 2 ** 30:.3f} GiB a rank (a model of "
            f"H100 ranks, traced on this host)")
    for mesh in ("1pod", "2pod"):
        say(roofline.render_markdown(roofline.build_table(entries, mesh),
                                     mesh))
    from repro_torch.configs.base import get_config
    scale = get_config(X_VLM).n_layers // X_VLM_LAYERS
    measured = {LM_ARCH: [r["param_bytes"] for r in tp["ranks"]],
                FAM_MOE: [r["param_bytes"] for r in moe["ranks"]],
                **{a: [r[a, "param_bytes"] for r in ssm["ranks"]]
                   for a in (FAM_XLSTM, FAM_HYMBA)},
                X_AUDIO: [r[X_AUDIO, "param_bytes"] for r in xtp["ranks"]],
                X_VLM: [r[X_VLM, "param_bytes"]
                        + (scale - 1) * r[X_VLM, "layer_bytes"]
                        for r in xtp["ranks"]]}
    for arch, shape in ((LM_ARCH, "decode_32k"), *DRY_CELLS):
        key = f"{arch}|{shape}|1pod|mesh1x{TP_RANKS}"
        want = entries[key]["param_bytes"]
        how = (f" (the ranks' {X_VLM_LAYERS} layers' shards x {scale} "
               f"with the top-level leaves)" if arch == X_VLM else "")
        say(f"tp (e) / moe, ssm, x (d): {arch}'s parameter bytes a rank on "
            f"(1, {TP_RANKS}): dry-run {want:,}, measured {measured[arch]}"
            f"{how} on {smi}")
        if any(b != want for b in measured[arch]):
            fail(f"tp (e) / moe, ssm, x (d): {arch}: the dry-run's "
                 f"{want:,} parameter bytes a rank != the ranks' "
                 f"{measured[arch]}")
    return {"cells": len(entries)}


def tp_one_process(torch, dispatch, tp: dict, ckpt_dir: str,
                   int8_path: str) -> dict:
    """The one-process runs phase 15 holds the ranks against: qwen3-8b
    fed the ranks' tokens (with quantize_dense on also fed their int8
    activations, and counting the flips), granite's step, the checkpoint
    restored."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.api import Model
    from repro_torch.optim.adam import AdamW
    from repro_torch.train import checkpoint
    from repro_torch.train.loop import make_train_step
    r0 = tp["ranks"][0]
    cfg = get_config(LM_ARCH)
    model = Model(cfg, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    out = {"param_bytes": _local_param_bytes(params)}
    prompts = tp_prompts(cfg.vocab_size)
    records = torch.load(int8_path, weights_only=True)
    for quant in (True, False):
        m = Model(dataclasses.replace(cfg, quantize_dense=quant), "cuda")
        tokens = r0["serve", quant]["tokens"]
        tp_serve(torch, dispatch, m, params, prompts[:, :16], new=1)
        out["serve", quant] = tp_serve(torch, dispatch, m, params, prompts,
                                       tokens=tokens)
        if quant:
            for feed in (False, True):
                with Int8Feed(records, feed) as f8:
                    run = tp_serve(torch, dispatch, m, params, prompts,
                                   tokens=tokens)
                run["flips"], run["sizes"] = f8.flips, f8.sizes
                out["int8", feed] = run
    del params, model, records
    torch.cuda.empty_cache()
    tcfg = dataclasses.replace(get_config(TRAIN_ARCH),
                               n_layers=TP_TRAIN_LAYERS)
    tmodel = Model(tcfg, "cuda")
    params = tmodel.init(torch.Generator(device="cuda").manual_seed(SEED)) \
        .trainable_()
    opt = AdamW(lr=TRAIN_LR)
    step = make_train_step(tmodel, opt)
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    state = opt.init(params)
    batch = tp_train_batch(tcfg.vocab_size)
    _, _, m = step(params, state, batch)
    loss = float(m["loss"])
    torch.cuda.synchronize()
    out["train"] = {"loss": loss, "grad_norm": float(m["grad_norm"]),
                    "counts": dict(dispatch.launch_counts),
                    "step_ms": timed_step(torch, step, params, state,
                                          batch)}
    # (c) the ranks' checkpoint into one process, then one more step
    params.load_(checkpoint.restore(ckpt_dir, 1, params))
    out["restored"] = [_slice_digests(params, r["saved"])
                       for r in tp["ranks"]]
    _, _, m = step(params, opt.init(params), tp_train_batch(tcfg.vocab_size))
    out["after_restore_loss"] = float(m["loss"])
    del params, tmodel, opt
    torch.cuda.empty_cache()
    return out


def tp_on_card(torch, dispatch, smi: str) -> dict:
    """Phase 15, checks (a)-(d) (the module docstring); (e) runs later,
    beside the data's set-up only (tp_dryrun_start)."""
    import shutil
    from repro_torch.launch.mesh import backend_for, spawn_ranks
    t_phase = time.perf_counter()
    ckpt, int8_path = TP_DIR / "ckpt", TP_DIR / "int8.pt"
    shutil.rmtree(ckpt, ignore_errors=True)
    TP_DIR.mkdir(parents=True, exist_ok=True)
    say(f"tp: {TP_RANKS} ranks share the card over "
        f"{backend_for('cuda', TP_RANKS)}, a (data=1, model={TP_RANKS}) "
        f"mesh")
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        t0 = time.perf_counter()
        ranks = spawn_ranks(tp_rank, TP_RANKS, device="cuda",
                            timeout=TP_TIMEOUT,
                            args=(str(ckpt), str(int8_path)))
        ranks_s = time.perf_counter() - t0
    finally:
        if conf is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf
    tp = {"ranks": ranks}
    one = tp_one_process(torch, dispatch, tp, str(ckpt), str(int8_path))
    shutil.rmtree(ckpt, ignore_errors=True)
    int8_path.unlink()
    check_tp(tp, one, smi)
    tp["wall_s"] = time.perf_counter() - t_phase
    say(f"tp: phase 15 (a)-(d) in {tp['wall_s']:.1f} s ({ranks_s:.1f} s "
        f"the ranks) on {smi}")
    return tp


def _greedy(fed, tokens, tol: float) -> tuple:
    """The positions whose top-2 margin in ``fed`` (the logits each fed
    token came from) exceeds ``tol``, and where argmax == the token."""
    top2 = np.sort(fed, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) > tol, fed.argmax(-1) == tokens


def check_tp(tp: dict, one: dict, smi: str) -> None:
    """Phase 15 (a)-(d) against the one-process runs: every number
    printed, then every failed check listed at once."""
    ranks, bad = tp["ranks"], []
    if any(r["jax"] for r in ranks):
        bad.append("tp: a rank imported JAX")
    for r in ranks:
        for part in (r["serve", True], r["serve", False], r["train"]):
            bad += [f"tp kernels: {o}" for o in part["kernel_over"]]
    for quant in (True, False):
        mode = "quantize_dense on" if quant else "off"
        got = ranks[0]["serve", quant]
        # with quantize_dense on, the one-process run fed the ranks' int8
        # activations: the int8 rounding of one run cannot move the other
        want = one["int8", True] if quant else one["serve", False]
        for r in ranks[1:]:
            if not np.array_equal(r["serve", quant]["logits"], got["logits"]):
                bad.append(f"tp (a) {mode}: the ranks' logits differ")
        err = float(np.abs(got["logits"] - want["logits"]).max())
        sure, agree = _greedy(want["logits"][:TP_NEW], got["tokens"],
                              TP_BF16_TOL)
        say(f"tp (a) {mode}: logits (prefill + {TP_NEW} decode steps) max "
            f"|sharded - one process{' fed their int8' if quant else ''}| "
            f"{err:.4g} (tolerance {TP_BF16_TOL}); greedy tokens equal at "
            f"{int((agree & sure).sum())} of {int(sure.sum())} positions "
            f"whose top-2 margin exceeds it ({int(agree.sum())} of "
            f"{agree.size} in all)")
        if err > TP_BF16_TOL or not np.all(agree[sure]):
            bad.append(f"tp (a) {mode}: sharded serving disagrees with one "
                       f"process")
        for r in ranks:
            c = r["serve", quant]
            if c["counts"] != one["serve", quant]["counts"] \
                    or c["timed_counts"] != c["counts"]:
                bad.append(f"tp (d) {mode}: rank launches {c['counts']} "
                           f"(timed run {c['timed_counts']}) != one process "
                           f"{one['serve', quant]['counts']}")
        say(f"tp (a) {mode}: every launch on a rank against its plain "
            f"version on the rank's operands: {got['kernel_checked']}, "
            f"errors {got['kernel_errs']} (int_matmul exact, mha <= "
            f"{TRAIN_BWD_BF16_RTOL} of max |plain|); shapes {got['shapes']}")
        say(f"tp (a) {mode}: prefill {got['prefill_ms']:.1f} ms against "
            f"{one['serve', quant]['prefill_ms']:.1f} ms in one process; "
            f"{got['decode_ms']:.1f} ms a decode token against "
            f"{one['serve', quant]['decode_ms']:.1f} ms; launches a rank "
            f"{got['counts']} (= one process) on {smi}")
    on = ranks[0]["serve", True]
    calls = one["serve", True]["counts"]["int_matmul"]
    say(f"tp (a) quantize_dense on: int8 activations of all "
        f"{on['int8_calls']} quantized linears ({on['int8_elements']:,} "
        f"elements) against one-process quantization of the gathered "
        f"inputs: {on['int8_diff']} differ; int32 products of the first "
        f"{on['int8_gathered']} against int_matmul on the gathered "
        f"operands: {on['int8_gathered_diff']} differ")
    if on["int8_calls"] != calls or on["int8_diff"] \
            or on["int8_gathered"] != TP_INT8_CALLS \
            or on["int8_gathered_diff"]:
        bad.append("tp (a): sharded int8 activations or int_matmul outputs "
                   "differ from one process on the same inputs")
    unfed, fed = one["serve", True], one["int8", True]
    per_call = len(one["int8", False]["flips"]) // (TP_NEW + 1)
    for name, run in (("own", one["int8", False]), ("fed", fed)):
        starts = np.arange(0, len(run["flips"]), per_call)
        flips = np.add.reduceat(run["flips"], starts)
        sizes = np.add.reduceat(run["sizes"], starts)
        say(f"tp (a) quantize_dense on, one process {name} int8: elements "
            f"differing from the ranks' int8 activations a forward call "
            f"(prefill, then each decode step) {flips.tolist()} of "
            f"{sizes.tolist()} ({flips.sum() / sizes.sum():.2%} in all)")
    gap = float(np.abs(on["logits"] - unfed["logits"]).max())
    sure, agree = _greedy(unfed["logits"][:TP_NEW], on["tokens"],
                          TP_BF16_TOL)
    say(f"tp (a) quantize_dense on, one process quantizing its own "
        f"activations (not bounded: the flips above move it): logits max "
        f"|sharded - one process| {gap:.4g}; greedy tokens equal at "
        f"{int((agree & sure).sum())} of {int(sure.sum())} positions whose "
        f"top-2 margin exceeds {TP_BF16_TOL} ({int(agree.sum())} of "
        f"{agree.size} in all)")
    if len(one["int8", False]["flips"]) != calls:
        bad.append("tp (a): the one-process run made another number of "
                   "quantized calls than the ranks")
    off = ranks[0]["serve", False]
    say(f"tp (a): with every redistribution synchronised and timed, the "
        f"collectives take {off['coll_share']:.1%} of the decode run "
        f"({off['coll_calls']} redistributions) on {smi}")
    for shapes in ranks[0]["serve", True]["shapes"]["mha"]:
        if shapes[0][1] != 32 // TP_RANKS:
            bad.append(f"tp (d): mha ran on {shapes}, not on the rank's "
                       f"heads")
    for (a, b) in ranks[0]["serve", True]["shapes"]["int_matmul"]:
        if b not in ((4096, 12288 // TP_RANKS), (12288 // TP_RANKS, 4096)):
            bad.append(f"tp (d): int_matmul ran on a weight {b}, not a "
                       f"shard")
    got, want = ranks[0]["train"], one["train"]
    for r in ranks:
        if r["train"]["counts"] != want["counts"]:
            bad.append(f"tp (d) train: rank launches "
                       f"{r['train']['counts']} != one process "
                       f"{want['counts']}")
    dloss = abs(got["loss"] - want["loss"])
    dnorm = abs(got["grad_norm"] - want["grad_norm"]) / want["grad_norm"]
    say(f"tp (b): {TRAIN_ARCH} at {TP_TRAIN_LAYERS} layers, one step: loss "
        f"{got['loss']:.5f} against {want['loss']:.5f} (|d| {dloss:.3g}, "
        f"tolerance {TRAIN_LOSS_ATOL}), grad norm {got['grad_norm']:.5f} "
        f"against {want['grad_norm']:.5f} (rel {dnorm:.3g}, tolerance "
        f"{TRAIN_GRAD_RTOL}); {got['step_ms']:.0f} ms a step (the second) "
        f"against {want['step_ms']:.0f} ms; launches a rank (step 1) "
        f"{got['counts']}; every launch against its plain version on the "
        f"rank's operands: {got['kernel_checked']}, errors "
        f"{got['kernel_errs']} (mha and mha_bwd <= {TRAIN_BWD_BF16_RTOL} "
        f"of max |plain|, lse <= {TRAIN_LSE_ATOL}); kernel shapes "
        f"{got['shapes']} on {smi}")
    if dloss > TRAIN_LOSS_ATOL or dnorm > TRAIN_GRAD_RTOL:
        bad.append("tp (b): the sharded step disagrees with one process")
    differ = _restore_mismatch([r["saved"] for r in ranks], one["restored"])
    if differ:
        bad.append(f"tp (c): {len(differ)} leaves differ after the "
                   f"restore (first {differ[:3]})")
    if not np.isfinite(one["after_restore_loss"]):
        bad.append("tp (c): the step after the restore is not finite")
    say(f"tp (c): {len(one['restored'][0])} leaves restored into one "
        f"process, each rank's shards bit for bit; the next step's loss "
        f"{one['after_restore_loss']:.5f}")
    say(f"tp: parameter bytes a rank {[r['param_bytes'] for r in ranks]} "
        f"against {one['param_bytes']:,} in one process; serving peak "
        f"{[r['peak_serve'] / 2 ** 30 for r in ranks]} GiB a rank")
    if bad:
        fail("; ".join(bad))


def tp_kernel_errs(tp: dict) -> dict:
    """Phase 15's largest kernel-against-plain error of each op over the
    ranks and runs (int_matmul: abs; mha and mha_bwd: abs and over max
    |plain|; mha's lse: abs), and the launches checked a rank."""
    errs, checked = {}, {}
    for r in tp["ranks"]:
        for part in (r["serve", True], r["serve", False], r["train"]):
            for k, e in part["kernel_errs"].items():
                errs[k] = max(errs.get(k, 0.0), e)
    r0 = tp["ranks"][0]
    for part in (r0["serve", True], r0["serve", False], r0["train"]):
        add_counts(checked, part["kernel_checked"])
    return {"errs": errs, "checked": checked}


# -- phase 16: the MoE family on sharded parameters -----------------------------

class ExpertShapes:
    """Records every expert-parallel product on a rank (``tp.ExpertMatmul``,
    which ``models/moe.py`` looks up at each call): the rank's local
    experts and the bytes of the local weight it reads."""

    def __enter__(self):
        from repro_torch.distributed import tp
        self.tp, self.orig, self.calls = tp, tp.ExpertMatmul, []
        rec = self.calls

        class Recorded(self.orig):
            @staticmethod
            def forward(ctx, x, w):
                wl = w.to_local()
                rec.append((x.to_local().shape[0],
                            wl.numel() * wl.element_size()))
                return self.orig.forward(ctx, x, w)
        tp.ExpertMatmul = Recorded
        return self

    def __exit__(self, *exc):
        self.tp.ExpertMatmul = self.orig


class RouteRecord:
    """Wraps the MoE routers (one process's ``moe._route``, a rank's
    ``moe._route_sharded``): for every call the expert ids ``[tokens, k]``
    of the tokens it routes (a rank: its data rank's rows) and which
    (token, slot) pairs its capacity keeps, on the host.  On a rank,
    ``inputs`` also keeps the router's input rows and ``decisions`` its
    gates, expert ids and positions.  In one process, ``feed`` routes call
    i's inputs ``feed[i]`` (the ranks' rows, whole) in place of its own,
    and ``decide`` takes call i's ``(gates, ids, positions)`` as its
    router's: the bf16 rounding of one run then cannot move the other's
    top-k (a flip changes which tokens a full expert drops)."""

    def __init__(self, inputs: bool = False, decisions: bool = False,
                 feed=None, decide=None):
        self.inputs, self.decisions = inputs, decisions
        self.feed, self.decide = feed, decide

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.calls, self.rows, self.made = moe, [], [], []
        self.orig = (moe._route, moe._route_sharded)

        def one(params, spec, xg):
            i = len(self.calls)
            if self.feed is not None:
                xg = self.feed[i].to(xg).reshape(xg.shape)
            out = self.orig[0](params, spec, xg)
            if self.decide is not None:
                out = tuple(t.to(o.device).reshape(o.shape)
                            for t, o in zip(self.decide[i], out[:3])) \
                    + (out[3],)
            cap = moe._capacity(spec, xg.shape[0] * xg.shape[1])[2]
            self.keep(out[1], out[2] < cap)
            return out

        def ranks(params, spec, x, sp):
            out = self.orig[1](params, spec, x, sp)
            self.keep(out[1], (out[2] >= 0) & (out[2] < sp.cap))
            if self.inputs:
                self.rows.append(x.to_local().detach().reshape(
                    -1, x.shape[-1]).cpu())
            if self.decisions:
                self.made.append(tuple(t.detach().cpu() for t in out[:3]))
            return out
        moe._route, moe._route_sharded = one, ranks
        return self

    def __exit__(self, *exc):
        self.moe._route, self.moe._route_sharded = self.orig

    def keep(self, gidx, kept) -> None:
        k = gidx.shape[-1]
        self.calls.append((gidx.reshape(-1, k).cpu().numpy(),
                           kept.reshape(-1, k).cpu().numpy()))


class MoeCollectiveTimer(CollectiveTimer):
    """:class:`CollectiveTimer`, and also the port's own collectives that
    the MoE path calls beside DTensor's redistributions (the router's
    gathers, FSDP's gathers)."""

    NAMES = ("gather_over", "reduce_scatter_over")

    def __enter__(self):
        from repro_torch.distributed import collectives
        self.coll = collectives
        self.saved = {n: getattr(collectives, n) for n in self.NAMES}
        for name, real in self.saved.items():
            def timed(*args, _real=real, **kwargs):
                self.torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _real(*args, **kwargs)    # staged: returns when done
                self.torch.cuda.synchronize()
                self.seconds += time.perf_counter() - t0
                self.calls += 1
                return out
            setattr(collectives, name, timed)
        return super().__enter__()

    def __exit__(self, *exc):
        for name, real in self.saved.items():
            setattr(self.coll, name, real)
        return super().__exit__(*exc)


def moe_train_batch(vocab: int) -> dict:
    rng = np.random.RandomState(SEED + 2)
    return {k: rng.randint(0, vocab, (MOE_TRAIN_BATCH, MOE_TRAIN_SEQ))
            .astype(np.int32) for k in ("tokens", "targets")}


def moe_rank(rank: int, ckpt_dir: str, int8_path: str) -> dict:
    """Phase 16 (a)-(b) on one of MOE_RANKS ranks of a ("data"=1,
    "model"=2) mesh: qwen2-moe-a2.7b at full width and depth served with
    quantize_dense on and off (every kernel launch and quantized linear
    checked, the experts' products recorded; rank 0 writes the int8
    activations for the one-process run), off once more with the
    collectives timed; its train step at MOE_TRAIN_LAYERS layers,
    its kernels checked, its params saved."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.distributed.act_sharding import use_mesh
    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import Model
    from repro_torch.optim.adam import AdamW
    from repro_torch.train import checkpoint
    from repro_torch.train.loop import make_train_step
    mesh = make_mesh((1, MOE_RANKS), ("data", "model"), "cuda")
    res = {"jax": "jax" in sys.modules}
    cfg = get_config(FAM_MOE)
    with use_mesh(mesh):
        t0 = time.perf_counter()
        params = Model(cfg, "cuda").init_placed(mesh, torch.Generator(
            device="cuda").manual_seed(SEED))
        torch.cuda.synchronize()
        res["init_s"] = time.perf_counter() - t0
        res["param_bytes"] = _local_param_bytes(params)
        res["init_peak"] = torch.cuda.max_memory_allocated()
        prompts = tp_prompts(cfg.vocab_size)
        for quant in (True, False):
            m = Model(dataclasses.replace(cfg, quantize_dense=quant), "cuda")
            tp_serve(torch, dispatch, m, params, prompts[:, :16], new=1)
            with KernelChecks(torch, dispatch, ("mha", "int_matmul")) as kc, \
                    Int8Check(TP_INT8_CALLS, record=quant and rank == 0) \
                    as i8, ExpertShapes() as es, \
                    RouteRecord(decisions=rank == 0) as rr:
                run = tp_serve(torch, dispatch, m, params, prompts,
                               new=MOE_NEW)
            if i8.records:
                torch.save(i8.records, int8_path)
            if rr.made:
                torch.save(rr.made, f"{int8_path}.route{int(quant)}")
            prefill_calls = 3 * cfg.n_layers
            run.update(kc.report(), int8_calls=i8.calls, int8_diff=i8.diff,
                       int8_elements=i8.elements, int8_gathered=i8.gathered,
                       int8_gathered_diff=i8.gathered_diff,
                       local_experts=sorted({e for e, _ in es.calls}),
                       expert_calls=len(es.calls),
                       expert_bytes_a_token=sum(
                           b for _, b in es.calls[prefill_calls:]) / MOE_NEW)
            del i8
            if not quant:
                with MoeCollectiveTimer(torch) as ct:
                    t0 = time.perf_counter()
                    tp_serve(torch, dispatch, m, params, prompts,
                             tokens=run["tokens"], new=MOE_NEW)
                    wall = time.perf_counter() - t0
                run["coll_share"] = ct.seconds / wall
                run["coll_calls"] = ct.calls
            res["serve", quant] = run
        res["peak_serve"] = torch.cuda.max_memory_allocated()
        del params
        torch.cuda.empty_cache()

        tcfg = dataclasses.replace(cfg, n_layers=MOE_TRAIN_LAYERS)
        tmodel = Model(tcfg, "cuda")
        params = tmodel.init_placed(mesh, torch.Generator(
            device="cuda").manual_seed(SEED)).trainable_()
        opt = AdamW(lr=TRAIN_LR)
        state = opt.init(params)
        step = make_train_step(tmodel, opt)
        batch = moe_train_batch(tcfg.vocab_size)
        torch.cuda.synchronize()
        dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        with KernelChecks(torch, dispatch, ("mha", "mha_bwd")) as kc:
            params, state, m = step(params, state, batch)
            loss = float(m["loss"])
            torch.cuda.synchronize()
        res["train"] = {"loss": loss, "grad_norm": float(m["grad_norm"]),
                        "counts": dict(dispatch.launch_counts),
                        "step_ms": (time.perf_counter() - t0) * 1e3,
                        **kc.report()}
        checkpoint.save(ckpt_dir, 1, params)
        res["saved"] = _shard_digests(params)
        res["peak_train"] = torch.cuda.max_memory_allocated()
    return res


def dbrx_prompts(vocab: int) -> np.ndarray:
    return np.random.RandomState(SEED + 3).randint(
        0, vocab, (DBRX_PROMPTS, FAM_DBRX_PROMPT)).astype(np.int32)


def dbrx_rank(rank: int) -> dict:
    """Phase 16 (c) on one of the ranks of a DBRX_MESH ("data", "model")
    mesh: dbrx-132b at full width and DBRX_LAYERS layers, its weights
    placed by param_shardings_fsdp (two ranks drawing at a time: each
    holds one whole layer while it draws), 2 prompts prefilled and DBRX_NEW
    greedy decode steps; every mha launch checked, the routers' keep sets
    and the FSDP gathers' bytes recorded."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import collectives
    from repro_torch.distributed.act_sharding import use_mesh
    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import Model
    mesh = make_mesh(DBRX_MESH, ("data", "model"), "cuda")
    res = {"jax": "jax" in sys.modules, "coord": mesh.get_coordinate()}
    cfg = dataclasses.replace(get_config(FAM_DBRX), n_layers=DBRX_LAYERS)
    model = Model(cfg, "cuda")
    with use_mesh(mesh):
        t0 = time.perf_counter()
        for r in range(0, dist.get_world_size(), 2):     # two at a time
            if rank in (r, r + 1):
                params = model.init_placed(mesh, torch.Generator(
                    device="cuda").manual_seed(SEED))
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
            dist.barrier()
        res["init_s"] = time.perf_counter() - t0
        res["param_bytes"] = _local_param_bytes(params)
        w = params["layers"][0]["moe"]["w_gate"]
        res["w_gate"] = (tuple(w.to_local().shape),
                         [str(p) for p in w.placements])
        torch.cuda.reset_peak_memory_stats()
        collectives.reset_traffic()
        with KernelChecks(torch, dispatch, ("mha",)) as kc, \
                RouteRecord(inputs=True, decisions=True) as rr:
            run = tp_serve(torch, dispatch, model, params,
                           dbrx_prompts(cfg.vocab_size), new=DBRX_NEW)
        run.update(kc.report(), traffic=dict(collectives.traffic),
                   routes=rr.calls, route_rows=rr.rows, route_made=rr.made,
                   peak_serve=torch.cuda.max_memory_allocated())
        res["serve"] = run
    return res


def moe_one_process(torch, dispatch, moe: dict, ckpt_dir: str,
                    int8_path: str) -> dict:
    """The one-process runs phase 16 (a)-(b) hold the ranks against:
    qwen2-moe-a2.7b fed the ranks' tokens (quantize_dense on: also fed
    their int8 activations), its train step, the checkpoint restored."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.api import Model
    from repro_torch.optim.adam import AdamW
    from repro_torch.train import checkpoint
    from repro_torch.train.loop import make_train_step
    r0 = moe["ranks"][0]
    cfg = get_config(FAM_MOE)
    params = Model(cfg, "cuda").init(torch.Generator(
        device="cuda").manual_seed(SEED))
    out = {"param_bytes": _local_param_bytes(params)}
    prompts = tp_prompts(cfg.vocab_size)
    records = torch.load(int8_path, weights_only=True)
    for quant in (True, False):
        m = Model(dataclasses.replace(cfg, quantize_dense=quant), "cuda")
        tokens = r0["serve", quant]["tokens"]
        decide = torch.load(f"{int8_path}.route{int(quant)}",
                            weights_only=True)
        tp_serve(torch, dispatch, m, params, prompts[:, :16], new=1)
        out["own", quant] = tp_serve(torch, dispatch, m, params, prompts,
                                     tokens=tokens, new=MOE_NEW)
        with Int8Feed(records, quant) as f8, RouteRecord(decide=decide):
            run = tp_serve(torch, dispatch, m, params, prompts,
                           tokens=tokens, new=MOE_NEW)
        run["flips"] = f8.flips if quant else []
        out["serve", quant] = run
        Path(f"{int8_path}.route{int(quant)}").unlink()
    del params, records
    torch.cuda.empty_cache()
    tcfg = dataclasses.replace(cfg, n_layers=MOE_TRAIN_LAYERS)
    tmodel = Model(tcfg, "cuda")
    params = tmodel.init(torch.Generator(device="cuda").manual_seed(SEED)) \
        .trainable_()
    opt = AdamW(lr=TRAIN_LR)
    step = make_train_step(tmodel, opt)
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    _, _, m = step(params, opt.init(params), moe_train_batch(tcfg.vocab_size))
    loss = float(m["loss"])
    out["train"] = {"loss": loss, "grad_norm": float(m["grad_norm"]),
                    "counts": dict(dispatch.launch_counts),
                    "step_ms": (time.perf_counter() - t0) * 1e3}
    params.load_(checkpoint.restore(ckpt_dir, 1, params))
    out["restored"] = [_slice_digests(params, r["saved"])
                       for r in moe["ranks"]]
    out["peak"] = torch.cuda.max_memory_allocated()
    del params, tmodel, opt
    torch.cuda.empty_cache()
    return out


def dbrx_one_process(torch, dispatch, ranks: list) -> dict:
    """dbrx-132b at DBRX_LAYERS layers in one process fed the ranks'
    tokens: routing its own activations; fed the ranks' routing (their
    gates, expert ids and positions, whole: data rank 0's rows, then
    1's); and with its routers fed the ranks' router inputs, their keep
    sets recorded."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.api import Model
    cfg = dataclasses.replace(get_config(FAM_DBRX), n_layers=DBRX_LAYERS)
    model = Model(cfg, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    prompts, tokens = (dbrx_prompts(cfg.vocab_size),
                       ranks[0]["serve"]["tokens"])
    by_data = {}
    for r in ranks:                      # model rank 0 of each data rank
        by_data.setdefault(r["coord"][0], r["serve"])
    runs = [by_data[d] for d in sorted(by_data)]

    def whole(i, pick):
        return torch.cat([pick(r, i).reshape(-1, pick(r, i).shape[-1])
                          for r in runs])
    calls = range(len(runs[0]["route_rows"]))
    feed = [whole(i, lambda r, i: r["route_rows"][i]) for i in calls]
    decide = [tuple(whole(i, lambda r, i, j=j: r["route_made"][i][j])
                    for j in range(3)) for i in calls]
    own = tp_serve(torch, dispatch, model, params, prompts, tokens=tokens,
                   new=DBRX_NEW)
    with RouteRecord(decide=decide):
        run = tp_serve(torch, dispatch, model, params, prompts,
                       tokens=tokens, new=DBRX_NEW)
    with RouteRecord(feed=feed) as rr:
        fed = tp_serve(torch, dispatch, model, params, prompts,
                       tokens=tokens, new=DBRX_NEW)
    run["routes"], run["fed_logits"] = rr.calls, fed["logits"]
    run["own_logits"] = own["logits"]
    run["param_bytes"] = _local_param_bytes(params)
    del params, model
    torch.cuda.empty_cache()
    return run


def moe_on_card(torch, dispatch, smi: str) -> dict:
    """Phase 16, checks (a)-(c) (the module docstring); (d) runs with
    phase 15 (e)."""
    import shutil
    from repro_torch.launch.mesh import backend_for, spawn_ranks
    t_phase = time.perf_counter()
    ckpt, int8_path = MOE_DIR / "ckpt", MOE_DIR / "int8.pt"
    shutil.rmtree(ckpt, ignore_errors=True)
    MOE_DIR.mkdir(parents=True, exist_ok=True)
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    marks = {}
    try:
        say(f"moe: {MOE_RANKS} ranks share the card over "
            f"{backend_for('cuda', MOE_RANKS)}, a (data=1, model="
            f"{MOE_RANKS}) mesh")
        t0 = time.perf_counter()
        ranks = spawn_ranks(moe_rank, MOE_RANKS, device="cuda",
                            timeout=MOE_TIMEOUT,
                            args=(str(ckpt), str(int8_path)))
        marks["ranks (a)-(b)"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        db = spawn_ranks(dbrx_rank, DBRX_MESH[0] * DBRX_MESH[1],
                         device="cuda", timeout=MOE_TIMEOUT)
        marks["ranks (c)"] = time.perf_counter() - t0
    finally:
        if conf is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf
    moe = {"ranks": ranks, "dbrx": db}
    t0 = time.perf_counter()
    one = moe_one_process(torch, dispatch, moe, str(ckpt), str(int8_path))
    one["dbrx"] = dbrx_one_process(torch, dispatch, db)
    marks["one process"] = time.perf_counter() - t0
    shutil.rmtree(ckpt, ignore_errors=True)
    int8_path.unlink()
    check_moe(moe, one, smi)
    moe["wall_s"] = time.perf_counter() - t_phase
    say(f"moe: phase 16 (a)-(c) in {moe['wall_s']:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in marks.items())}) on "
        f"{smi}")
    return moe


def check_moe(moe: dict, one: dict, smi: str) -> None:
    """Phase 16 (a)-(c) against the one-process runs: every number
    printed, then every failed check listed at once."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.transformer import moe_spec
    ranks, db, bad = moe["ranks"], moe["dbrx"], []
    cfg = get_config(FAM_MOE)
    spec = moe_spec(cfg)
    if any(r["jax"] for r in ranks + db):
        bad.append("moe: a rank imported JAX")
    for r in ranks:
        for part in (r["serve", True], r["serve", False], r["train"]):
            bad += [f"moe kernels: {o}" for o in part["kernel_over"]]
    for r in db:
        bad += [f"moe (c) kernels: {o}" for o in r["serve"]["kernel_over"]]
    for quant in (True, False):
        mode = "quantize_dense on" if quant else "off"
        got, want = ranks[0]["serve", quant], one["serve", quant]
        for r in ranks[1:]:
            if not np.array_equal(r["serve", quant]["logits"], got["logits"]):
                bad.append(f"moe (a) {mode}: the ranks' logits differ")
        err = float(np.abs(got["logits"] - want["logits"]).max())
        sure, agree = _greedy(want["logits"][:MOE_NEW], got["tokens"],
                              TP_BF16_TOL)
        own = one["own", quant]
        gap = float(np.abs(got["logits"] - own["logits"]).max())
        osure, oagree = _greedy(own["logits"][:MOE_NEW], got["tokens"],
                                TP_BF16_TOL)
        say(f"moe (a) {FAM_MOE} {mode}: logits (prefill + {MOE_NEW} decode "
            f"steps) max |sharded - one process fed their routing"
            f"{' and int8' if quant else ''}| {err:.4g} (tolerance "
            f"{TP_BF16_TOL}); greedy tokens equal at "
            f"{int((agree & sure).sum())} of {int(sure.sum())} positions "
            f"whose top-2 margin exceeds it ({int(agree.sum())} of "
            f"{agree.size} in all).  One process routing its own "
            f"activations (not bounded: a top-k flip moves which tokens a "
            f"full expert drops, capacity factor {spec.capacity_factor}): "
            f"{gap:.4g}, greedy tokens equal at "
            f"{int((oagree & osure).sum())} of {int(osure.sum())} sure "
            f"positions")
        if err > TP_BF16_TOL or not np.all(agree[sure]):
            bad.append(f"moe (a) {mode}: sharded serving disagrees with one "
                       f"process")
        for r in ranks:
            c = r["serve", quant]
            if c["counts"] != want["counts"]:
                bad.append(f"moe (a) {mode}: rank launches {c['counts']} != "
                           f"one process {want['counts']}")
            if c["local_experts"] != [spec.n_experts // MOE_RANKS]:
                bad.append(f"moe (a) {mode}: a rank multiplied "
                           f"{c['local_experts']} experts, not its "
                           f"{spec.n_experts // MOE_RANKS}")
        say(f"moe (a) {mode}: every launch on a rank against its plain "
            f"version on the rank's operands: {got['kernel_checked']}, "
            f"errors {got['kernel_errs']} (int_matmul exact, mha <= "
            f"{TRAIN_BWD_BF16_RTOL} of max |plain|); shapes {got['shapes']}; "
            f"launches a rank {got['counts']} (= one process); each rank "
            f"multiplied its own {got['local_experts']} experts in "
            f"{got['expert_calls']} expert products")
    on, off = ranks[0]["serve", True], ranks[0]["serve", False]
    calls = one["serve", True]["counts"]["int_matmul"]
    say(f"moe (a) quantize_dense on: int8 activations of all "
        f"{on['int8_calls']} quantized linears ({on['int8_elements']:,} "
        f"elements) against one-process quantization of the gathered "
        f"inputs: {on['int8_diff']} differ; int32 products of the first "
        f"{on['int8_gathered']} against int_matmul on the gathered operands: "
        f"{on['int8_gathered_diff']} differ; the one-process run fed them "
        f"({len(one['serve', True]['flips'])} calls)")
    if on["int8_calls"] != calls or on["int8_diff"] \
            or on["int8_gathered"] != TP_INT8_CALLS \
            or on["int8_gathered_diff"] \
            or len(one["serve", True]["flips"]) != calls:
        bad.append("moe (a): sharded int8 activations or int_matmul outputs "
                   "differ from one process on the same inputs")
    whole = 3 * spec.n_experts * spec.d_model * spec.d_ff * 2 * cfg.n_layers
    own = one["own", False]
    say(f"moe (a): {FAM_MOE} prefill {off['prefill_ms']:.1f} ms against "
        f"{own['prefill_ms']:.1f} ms in one process; {off['decode_ms']:.1f} "
        f"ms a decode token against {own['decode_ms']:.1f} ms (quantize_dense "
        f"off, its mha launches checked; on: {on['prefill_ms']:.1f} / "
        f"{on['decode_ms']:.1f} ms with every launch checked); the "
        f"collectives {off['coll_share']:.1%} of a decode run "
        f"({off['coll_calls']} timed, every one synchronised); expert weight "
        f"bytes read a rank a decode token {off['expert_bytes_a_token'] / 1e9:.2f}"
        f" GB (capacity >= 1 in every local expert) against {whole / 1e9:.2f} "
        f"GB in one process; parameter bytes a rank "
        f"{[r['param_bytes'] for r in ranks]} against {one['param_bytes']:,}"
        f" in one process; peaks a rank {[r['peak_serve'] / 2 ** 30 for r in ranks]}"
        f" GiB, drawn in {[round(r['init_s'], 1) for r in ranks]} s on {smi}")
    if abs(off["expert_bytes_a_token"] * MOE_RANKS - whole) > 1:
        bad.append(f"moe (a): expert bytes a decode token "
                   f"{off['expert_bytes_a_token']} a rank, not half of "
                   f"{whole}")
    got, want = ranks[0]["train"], one["train"]
    for r in ranks:
        if r["train"]["counts"] != want["counts"]:
            bad.append(f"moe (b) train: rank launches {r['train']['counts']} "
                       f"!= one process {want['counts']}")
    dloss = abs(got["loss"] - want["loss"])
    dnorm = abs(got["grad_norm"] - want["grad_norm"]) / want["grad_norm"]
    say(f"moe (b): {FAM_MOE} at {MOE_TRAIN_LAYERS} layers, one AdamW step on "
        f"{MOE_TRAIN_BATCH} x {MOE_TRAIN_SEQ} tokens: loss {got['loss']:.5f} "
        f"against {want['loss']:.5f} (|d| {dloss:.3g}, tolerance "
        f"{TRAIN_LOSS_ATOL}), grad norm {got['grad_norm']:.5f} against "
        f"{want['grad_norm']:.5f} (rel {dnorm:.3g}, tolerance "
        f"{TRAIN_GRAD_RTOL}); {got['step_ms']:.0f} ms a step (the first) "
        f"against {want['step_ms']:.0f} ms; launches a rank {got['counts']}; "
        f"every launch against its plain version on the rank's operands: "
        f"{got['kernel_checked']}, errors {got['kernel_errs']}; peak "
        f"{ranks[0]['peak_train'] / 2 ** 30:.1f} GiB a rank against "
        f"{one['peak'] / 2 ** 30:.1f} GiB in one process on {smi}")
    if dloss > TRAIN_LOSS_ATOL or dnorm > TRAIN_GRAD_RTOL:
        bad.append("moe (b): the sharded step disagrees with one process")
    differ = _restore_mismatch([r["saved"] for r in ranks], one["restored"])
    if differ:
        bad.append(f"moe (b): {len(differ)} leaves differ after the restore "
                   f"(first {differ[:3]})")
    say(f"moe (b): the ranks' state restored into one process, "
        f"{len(one['restored'][0])} leaves, each rank's shards bit for bit")

    # (c) dbrx with FSDP
    d0, d1 = db[0]["serve"], one["dbrx"]
    for r in db[1:]:
        if not np.array_equal(r["serve"]["logits"], d0["logits"]):
            bad.append("moe (c): the ranks' logits differ")
    err = float(np.abs(d0["logits"] - d1["logits"]).max())
    gap = float(np.abs(d0["logits"] - d1["own_logits"]).max())
    sure, agree = _greedy(d1["logits"][:DBRX_NEW], d0["tokens"], TP_BF16_TOL)
    if err > TP_BF16_TOL or not np.all(agree[sure]):
        bad.append("moe (c): dbrx over ranks disagrees with one process")
    for r in db:
        if r["serve"]["counts"] != d1["counts"]:
            bad.append(f"moe (c): rank launches {r['serve']['counts']} != "
                       f"one process {d1['counts']}")
    # the routers' keep sets: a rank routes its data rank's rows, alike
    # on every "model" rank
    by_data = {}
    for r in db:
        by_data.setdefault(r["coord"][0], []).append(r["serve"]["routes"])
    layers, drops, mismatch = DBRX_LAYERS, [], [0, 0]
    for i, (gidx, kept) in enumerate(d1["routes"]):
        for mr in range(DBRX_MESH[1]):
            rows = [by_data[dr][mr][i] for dr in sorted(by_data)]
            if not (np.array_equal(np.concatenate([g for g, _ in rows]), gidx)
                    and np.array_equal(np.concatenate([k for _, k in rows]),
                                       kept)):
                mismatch[i >= layers] += 1
        drops.append(int((~kept).sum()))
    pairs = sum(k.size for _, k in d1["routes"][layers:])
    fed_err = float(np.abs(d0["logits"] - d1["fed_logits"]).max())
    say(f"moe (c): {FAM_DBRX} at {DBRX_LAYERS} of 40 layers with FSDP over a "
        f"(data={DBRX_MESH[0]}, model={DBRX_MESH[1]}) mesh: logits (prefill + "
        f"{DBRX_NEW} decode steps) max |ranks - one process fed their "
        f"routing| {err:.4g} (tolerance {TP_BF16_TOL}; routing its own "
        f"activations, not bounded: {gap:.4g}); greedy tokens equal at "
        f"{int((agree & sure).sum())} of {int(sure.sum())} sure positions; "
        f"router calls {len(d1['routes'])}, one process's fed the ranks' "
        f"router inputs (its logits then {fed_err:.4g} from the ranks'): "
        f"expert ids and kept (token, slot) pairs differ in "
        f"{mismatch[0]} prefill and {mismatch[1]} decode calls (a rank's "
        f"float32 logits come from a product of other width: a top-k "
        f"near-tie may flip among the prefill's 1,024 tokens a layer, not "
        f"checked); "
        f"dropped pairs at "
        f"the prefill {sum(drops[:layers])}, at the decode steps "
        f"{sum(drops[layers:])} of {pairs}; launches a rank "
        f"{d0['counts']} (= one process); mha against plain "
        f"{d0['kernel_checked']}, errors {d0['kernel_errs']}, shapes "
        f"{d0['shapes']}; w_gate a rank "
        f"{db[0]['w_gate']}; parameter bytes a rank "
        f"{[r['param_bytes'] for r in db]} against {d1['param_bytes']:,} in "
        f"one process; collectives a rank {d0['traffic']} (all_gather: the "
        f"FSDP gathers and the routers'); prefill {d0['prefill_ms']:.0f} ms "
        f"against {d1['prefill_ms']:.0f} ms, a decode step "
        f"{d0['decode_ms']:.0f} ms against {d1['decode_ms']:.0f} ms; peak "
        f"{d0['peak_serve'] / 2 ** 30:.1f} GiB a rank, drawn in "
        f"{db[0]['init_s']:.1f} s on {smi}")
    if mismatch[1] or len(d1["routes"]) != layers * (1 + DBRX_NEW):
        bad.append(f"moe (c): {mismatch[1]} decode router calls keep other "
                   f"pairs than one process")
    if bad:
        fail("; ".join(bad))


def moe_kernel_errs(moe: dict) -> dict:
    """Phase 16's largest kernel-against-plain error of each op over the
    ranks and runs, and the launches a rank (rank 0 of (a)-(b), of (c))."""
    errs, counts = {}, {}
    parts = [p for r in moe["ranks"] for p in (r["serve", True],
                                                r["serve", False], r["train"])]
    parts += [r["serve"] for r in moe["dbrx"]]
    for part in parts:
        for k, e in part["kernel_errs"].items():
            errs[k] = max(errs.get(k, 0.0), e)
    r0 = moe["ranks"][0]
    for part in (r0["serve", True], r0["serve", False], r0["train"],
                 moe["dbrx"][0]["serve"]):
        add_counts(counts, part["counts"])
    return {"errs": errs, "counts": counts}


# -- phase 13: data-parallel training over ranks sharing the card -------------

# -- phase 17: the recurrent families on sharded parameters ---------------------


class SsmCollectiveTimer(MoeCollectiveTimer):
    """:class:`MoeCollectiveTimer`, and also the all-reduces the recurrent
    mixers call themselves (``tp.Reduce``: the SSM's ``bc``)."""

    NAMES = ("gather_over", "reduce_scatter_over", "reduce_over")


#: phase 17's archs and the quantize_dense modes each serves
SSM_ARCHS = ((FAM_HYMBA, (True, False)), (FAM_XLSTM, (False,)))


def ssm_train_batch(vocab: int) -> dict:
    rng = np.random.RandomState(SEED + 4)
    return {k: rng.randint(0, vocab, (SSM_TRAIN_BATCH, SSM_TRAIN_SEQ))
            .astype(np.int32) for k in ("tokens", "targets")}


def ssm_rank(rank: int, ckpt_dir: str, int8_path: str) -> dict:
    """Phase 17 (a)-(c) on one of SSM_RANKS ranks of a ("data"=1,
    "model"=2) mesh: hymba-1.5b served with quantize_dense on and off and
    xlstm-350m with it off, each once checked (every kernel launch and
    quantized linear; rank 0 writes hymba's int8 activations for the
    one-process run), once timed, and off once more with the collectives
    timed; then one AdamW step of each, its kernels checked, its params
    saved."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.distributed.act_sharding import use_mesh
    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import Model
    from repro_torch.optim.adam import AdamW
    from repro_torch.train import checkpoint
    from repro_torch.train.loop import make_train_step
    mesh = make_mesh((1, SSM_RANKS), ("data", "model"), "cuda")
    res = {"jax": "jax" in sys.modules}
    with use_mesh(mesh):
        for arch, quants in SSM_ARCHS:
            cfg = get_config(arch)
            t0 = time.perf_counter()
            params = Model(cfg, "cuda").init_placed(mesh, torch.Generator(
                device="cuda").manual_seed(SEED))
            torch.cuda.synchronize()
            res[arch, "init_s"] = time.perf_counter() - t0
            res[arch, "param_bytes"] = _local_param_bytes(params)
            prompts = tp_prompts(cfg.vocab_size)
            for quant in quants:
                m = Model(dataclasses.replace(cfg, quantize_dense=quant),
                          "cuda")
                tp_serve(torch, dispatch, m, params, prompts[:, :16], new=1)
                with KernelChecks(torch, dispatch, ("mha", "int_matmul")) \
                        as kc, Int8Check(TP_INT8_CALLS,
                                         record=quant and rank == 0) as i8:
                    run = tp_serve(torch, dispatch, m, params, prompts,
                                   new=SSM_NEW)
                if i8.records:
                    torch.save(i8.records, int8_path)
                run.update(kc.report(), int8_calls=i8.calls,
                           int8_diff=i8.diff, int8_elements=i8.elements,
                           int8_gathered=i8.gathered,
                           int8_gathered_diff=i8.gathered_diff)
                del i8
                if not quant:
                    with SsmCollectiveTimer(torch) as ct:
                        t0 = time.perf_counter()
                        tp_serve(torch, dispatch, m, params, prompts,
                                 tokens=run["tokens"], new=SSM_NEW)
                        wall = time.perf_counter() - t0
                    run["coll_s"], run["coll_wall_s"] = ct.seconds, wall
                    run["coll_share"] = ct.seconds / wall
                    run["coll_calls"] = ct.calls
                    run["timed_counts"] = dict(dispatch.launch_counts)
                res[arch, "serve", quant] = run
            del params, m
            torch.cuda.empty_cache()
        res["peak_serve"] = torch.cuda.max_memory_allocated()

        for arch, _ in SSM_ARCHS:
            cfg = dataclasses.replace(get_config(arch),
                                      n_layers=SSM_TRAIN_LAYERS[arch])
            model = Model(cfg, "cuda")
            params = model.init_placed(mesh, torch.Generator(
                device="cuda").manual_seed(SEED)).trainable_()
            opt = AdamW(lr=TRAIN_LR)
            step = make_train_step(model, opt)
            torch.cuda.synchronize()
            dispatch.reset_launch_counts()
            t0 = time.perf_counter()
            with KernelChecks(torch, dispatch, ("mha", "mha_bwd")) as kc:
                params, _, m = step(params, opt.init(params),
                                    ssm_train_batch(cfg.vocab_size))
                loss = float(m["loss"])
                torch.cuda.synchronize()
            res[arch, "train"] = {
                "loss": loss, "grad_norm": float(m["grad_norm"]),
                "counts": dict(dispatch.launch_counts),
                "step_ms": (time.perf_counter() - t0) * 1e3, **kc.report()}
            checkpoint.save(f"{ckpt_dir}/{arch}", 1, params)
            res[arch, "saved"] = _shard_digests(params)
            del params, opt, step
            torch.cuda.empty_cache()
        res["peak_train"] = torch.cuda.max_memory_allocated()
    return res


def ssm_one_process(torch, dispatch, ranks: list, ckpt_dir: str,
                    int8_path: str) -> dict:
    """The one-process runs phase 17 holds the ranks against: each arch
    fed the ranks' tokens (hymba with quantize_dense on also fed their
    int8 activations), its AdamW step, the ranks' checkpoint restored."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.api import Model
    from repro_torch.optim.adam import AdamW
    from repro_torch.train import checkpoint
    from repro_torch.train.loop import make_train_step
    r0, out = ranks[0], {}
    records = torch.load(int8_path, weights_only=True)
    for arch, quants in SSM_ARCHS:
        cfg = get_config(arch)
        params = Model(cfg, "cuda").init(torch.Generator(
            device="cuda").manual_seed(SEED))
        out[arch, "param_bytes"] = _local_param_bytes(params)
        prompts = tp_prompts(cfg.vocab_size)
        for quant in quants:
            m = Model(dataclasses.replace(cfg, quantize_dense=quant), "cuda")
            tokens = r0[arch, "serve", quant]["tokens"]
            tp_serve(torch, dispatch, m, params, prompts[:, :16], new=1)
            out[arch, "serve", quant] = tp_serve(
                torch, dispatch, m, params, prompts, tokens=tokens,
                new=SSM_NEW)
            if quant:
                with Int8Feed(records, True) as f8:
                    run = tp_serve(torch, dispatch, m, params, prompts,
                                   tokens=tokens, new=SSM_NEW)
                run["flips"] = f8.flips
                out[arch, "int8"] = run
        del params, m
        torch.cuda.empty_cache()
    del records
    for arch, _ in SSM_ARCHS:
        cfg = dataclasses.replace(get_config(arch),
                                  n_layers=SSM_TRAIN_LAYERS[arch])
        model = Model(cfg, "cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(
            SEED)).trainable_()
        opt = AdamW(lr=TRAIN_LR)
        step = make_train_step(model, opt)
        torch.cuda.synchronize()
        dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        _, _, m = step(params, opt.init(params),
                       ssm_train_batch(cfg.vocab_size))
        loss = float(m["loss"])
        out[arch, "train"] = {"loss": loss, "grad_norm": float(m["grad_norm"]),
                              "counts": dict(dispatch.launch_counts),
                              "step_ms": (time.perf_counter() - t0) * 1e3}
        params.load_(checkpoint.restore(f"{ckpt_dir}/{arch}", 1, params))
        out[arch, "restored"] = [_slice_digests(params, r[arch, "saved"])
                                 for r in ranks]
        del params, opt, step, model
        torch.cuda.empty_cache()
    out["peak"] = torch.cuda.max_memory_allocated()
    return out


def ssm_x_rank(rank: int, ssm_args: tuple, x_args: tuple) -> tuple:
    """Phase 17's rank body, then phase 18's, in the ranks one spawn
    makes (each spawn's processes take ~15 s to start on the card)."""
    return ssm_rank(rank, *ssm_args), x_rank(rank, *x_args)


def ssm_on_card(torch, dispatch, smi: str) -> dict:
    """Phase 17, checks (a)-(c) (the module docstring); (d) runs with
    phase 15 (e).  Its ranks then run phase 18 (a)-(c) (``x_rank``),
    whose results stay in ``"x_ranks"`` for :func:`x_on_card`."""
    import shutil
    from repro_torch.launch.mesh import backend_for, spawn_ranks
    t_phase = time.perf_counter()
    ckpt, int8_path = SSM_DIR / "ckpt", SSM_DIR / "int8.pt"
    shutil.rmtree(ckpt, ignore_errors=True)
    SSM_DIR.mkdir(parents=True, exist_ok=True)
    shutil.rmtree(X_DIR, ignore_errors=True)
    (X_DIR / "int8").mkdir(parents=True)
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        say(f"ssm, xtp: {SSM_RANKS} ranks share the card over "
            f"{backend_for('cuda', SSM_RANKS)}, a (data=1, model="
            f"{SSM_RANKS}) mesh")
        t0 = time.perf_counter()
        ranks = spawn_ranks(ssm_x_rank, SSM_RANKS, device="cuda",
                            timeout=SSM_TIMEOUT + X_TIMEOUT,
                            args=((str(ckpt), str(int8_path)),
                                  (str(X_DIR / "ckpt"), str(X_DIR / "int8"))))
        ranks_s = time.perf_counter() - t0
    finally:
        if conf is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf
    ssm = {"ranks": [r for r, _ in ranks], "x_ranks": [x for _, x in ranks]}
    x_s = max(x["seconds"]["all"] for x in ssm["x_ranks"])
    ssm["x_ranks_s"] = x_s
    t0 = time.perf_counter()
    one = ssm_one_process(torch, dispatch, ssm["ranks"], str(ckpt),
                          str(int8_path))
    one_s = time.perf_counter() - t0
    shutil.rmtree(ckpt, ignore_errors=True)
    int8_path.unlink()
    check_ssm(ssm, one, smi)
    ssm["wall_s"] = time.perf_counter() - t_phase - x_s
    say(f"ssm: phase 17 (a)-(c) in {ssm['wall_s']:.1f} s (ranks "
        f"{ranks_s - x_s:.1f} s, their start included; one process "
        f"{one_s:.1f} s; phase 18's {x_s:.1f} s on the same ranks left "
        f"out) on {smi}")
    return ssm


def check_ssm(ssm: dict, one: dict, smi: str) -> None:
    """Phase 17 (a)-(c) against the one-process runs: every number
    printed, then every failed check listed at once."""
    from repro_torch.configs.base import get_config
    ranks, bad = ssm["ranks"], []
    if any(r["jax"] for r in ranks):
        bad.append("ssm: a rank imported JAX")
    for r in ranks:
        for arch, quants in SSM_ARCHS:
            for part in [r[arch, "serve", q] for q in quants] + [
                    r[arch, "train"]]:
                bad += [f"ssm kernels: {o}" for o in part["kernel_over"]]
    for arch, quants in SSM_ARCHS:
        cfg = get_config(arch)
        tag = "(a)" if arch == FAM_HYMBA else "(b)"
        for quant in quants:
            mode = "quantize_dense on" if quant else "off"
            got = ranks[0][arch, "serve", quant]
            # quantize_dense on: the one-process run fed the ranks' int8
            want = one[arch, "int8"] if quant else one[arch, "serve", quant]
            for r in ranks[1:]:
                if not np.array_equal(r[arch, "serve", quant]["logits"],
                                      got["logits"]):
                    bad.append(f"ssm {tag} {mode}: the ranks' logits differ")
            err = float(np.abs(got["logits"] - want["logits"]).max())
            sure, agree = _greedy(want["logits"][:SSM_NEW], got["tokens"],
                                  TP_BF16_TOL)
            say(f"ssm {tag} {arch} {mode}: logits (prefill + {SSM_NEW} "
                f"decode steps) max |sharded - one process"
                f"{' fed their int8' if quant else ''}| {err:.4g} "
                f"(tolerance {TP_BF16_TOL}); greedy tokens equal at "
                f"{int((agree & sure).sum())} of {int(sure.sum())} "
                f"positions whose top-2 margin exceeds it "
                f"({int(agree.sum())} of {agree.size} in all)")
            if err > TP_BF16_TOL or not np.all(agree[sure]):
                bad.append(f"ssm {tag} {arch} {mode}: sharded serving "
                           f"disagrees with one process")
            ref = one[arch, "serve", quant]
            for r in ranks:
                c = r[arch, "serve", quant]
                if c["counts"] != ref["counts"] \
                        or c.get("timed_counts", c["counts"]) != c["counts"]:
                    bad.append(f"ssm {tag} {mode}: rank launches "
                               f"{c['counts']} (collective-timed run "
                               f"{c.get('timed_counts')}) != one process "
                               f"{ref['counts']}")
            prefill_mha = cfg.n_layers if arch == FAM_HYMBA else 0
            want_counts = {"mha": prefill_mha} if prefill_mha else {}
            if quant:
                want_counts["int_matmul"] = 3 * cfg.n_layers * (1 + SSM_NEW)
            if got["counts"] != want_counts:
                bad.append(f"ssm {tag} {mode}: launches {got['counts']}, "
                           f"not {want_counts}")
            line = (f"ssm {tag} {arch} {mode}: prefill "
                    f"{got['prefill_ms']:.1f} ms against "
                    f"{ref['prefill_ms']:.1f} ms in one process; "
                    f"{got['decode_ms']:.1f} ms a decode token against "
                    f"{ref['decode_ms']:.1f} ms (the ranks' checked run"
                    f"{', every int8 activation gathered' if quant else ''}"
                    f"); launches a rank "
                    f"{got['counts']} (= one process); every launch against "
                    f"its plain version on the rank's operands: "
                    f"{got['kernel_checked']}, errors {got['kernel_errs']} "
                    f"(int_matmul exact, mha <= {TRAIN_BWD_BF16_RTOL} of max "
                    f"|plain|); shapes {got['shapes']}")
            if not quant:
                line += (f"; the collectives {got['coll_s'] * 1e3:.1f} ms "
                         f"of a {got['coll_wall_s'] * 1e3:.1f} ms serve run "
                         f"({got['coll_share']:.1%}, {got['coll_calls']} "
                         f"timed, every one synchronised)")
            say(line + f" on {smi}")
        if arch == FAM_HYMBA:
            on = ranks[0][arch, "serve", True]
            calls = one[arch, "serve", True]["counts"].get("int_matmul", 0)
            flips = one[arch, "int8"]["flips"]
            say(f"ssm (a) quantize_dense on: int8 activations of all "
                f"{on['int8_calls']} quantized linears "
                f"({on['int8_elements']:,} elements) against one-process "
                f"quantization of the gathered inputs: {on['int8_diff']} "
                f"differ; int32 products of the first {on['int8_gathered']} "
                f"against int_matmul on the gathered operands: "
                f"{on['int8_gathered_diff']} differ; the one-process run "
                f"quantizing its own activations differs from the ranks' in "
                f"{sum(flips):,} int8 elements over {len(flips)} calls, and "
                f"is fed theirs")
            if on["int8_calls"] != calls or on["int8_diff"] \
                    or on["int8_gathered"] != TP_INT8_CALLS \
                    or on["int8_gathered_diff"] or len(flips) != calls:
                bad.append("ssm (a): sharded int8 activations or int_matmul "
                           "outputs differ from one process on the same "
                           "inputs")
            for shapes in on["shapes"].get("mha", ()):
                if shapes[0][1] != 32 // SSM_RANKS:
                    bad.append(f"ssm (a): mha ran on {shapes}, not on the "
                               f"rank's heads")
            for (_, b) in on["shapes"].get("int_matmul", ()):
                if b not in ((cfg.d_model, cfg.d_ff // SSM_RANKS),
                             (cfg.d_ff // SSM_RANKS, cfg.d_model)):
                    bad.append(f"ssm (a): int_matmul ran on a weight {b}, "
                               f"not a shard")
        got, want = ranks[0][arch, "train"], one[arch, "train"]
        for r in ranks:
            if r[arch, "train"]["counts"] != want["counts"]:
                bad.append(f"ssm (c) {arch}: rank launches "
                           f"{r[arch, 'train']['counts']} != one process "
                           f"{want['counts']}")
        dloss = abs(got["loss"] - want["loss"])
        dnorm = abs(got["grad_norm"] - want["grad_norm"]) / want["grad_norm"]
        say(f"ssm (c) {arch} at {SSM_TRAIN_LAYERS[arch]} of "
            f"{cfg.n_layers} layers, one AdamW step on "
            f"{SSM_TRAIN_BATCH} x {SSM_TRAIN_SEQ} tokens: loss "
            f"{got['loss']:.5f} against {want['loss']:.5f} (|d| {dloss:.3g}, "
            f"tolerance {TRAIN_LOSS_ATOL}), grad norm {got['grad_norm']:.5f} "
            f"against {want['grad_norm']:.5f} (rel {dnorm:.3g}, tolerance "
            f"{TRAIN_GRAD_RTOL}); {got['step_ms']:.0f} ms a step (the first) "
            f"against {want['step_ms']:.0f} ms; launches a rank "
            f"{got['counts']}; every launch against its plain version on the "
            f"rank's operands: {got['kernel_checked']}, errors "
            f"{got['kernel_errs']} on {smi}")
        if dloss > TRAIN_LOSS_ATOL or dnorm > TRAIN_GRAD_RTOL:
            bad.append(f"ssm (c) {arch}: the sharded step disagrees with one "
                       f"process")
        differ = _restore_mismatch([r[arch, "saved"] for r in ranks],
                                   one[arch, "restored"])
        if differ:
            bad.append(f"ssm (c) {arch}: {len(differ)} leaves differ after "
                       f"the restore (first {differ[:3]})")
        say(f"ssm (c) {arch}: the ranks' state restored into one process, "
            f"{len(one[arch, 'restored'][0])} leaves, each rank's shards bit "
            f"for bit; parameter bytes a rank "
            f"{[r[arch, 'param_bytes'] for r in ranks]} against "
            f"{one[arch, 'param_bytes']:,} in one process, drawn in "
            f"{[round(r[arch, 'init_s'], 1) for r in ranks]} s")
    say(f"ssm: peaks a rank serving {[r['peak_serve'] / 2 ** 30 for r in ranks]}"
        f" GiB, training {[r['peak_train'] / 2 ** 30 for r in ranks]} GiB; "
        f"one process {one['peak'] / 2 ** 30:.1f} GiB on {smi}")
    if bad:
        fail("; ".join(bad))


def ssm_kernel_errs(ssm: dict) -> dict:
    """Phase 17's launches on rank 0 (serving and training) and the
    largest kernel-against-plain errors over the ranks."""
    errs, counts = {}, {}
    for r in ssm["ranks"]:
        for arch, quants in SSM_ARCHS:
            for part in [r[arch, "serve", q] for q in quants] + [
                    r[arch, "train"]]:
                for k, e in part["kernel_errs"].items():
                    errs[k] = max(errs.get(k, 0.0), e)
    r0 = ssm["ranks"][0]
    for arch, quants in SSM_ARCHS:
        for part in [r0[arch, "serve", q] for q in quants] + [
                r0[arch, "train"]]:
            add_counts(counts, part["counts"])
    return {"errs": errs, "counts": counts}


# -- phase 18: the VLM and audio families on sharded parameters ----------------

def x_tp_cfg(arch: str, layers=None):
    """Phase 18's config of ``arch``: the VLM at ``layers`` (X_VLM_LAYERS
    unless given), whisper whole unless ``layers`` is given."""
    from repro_torch.configs.base import get_config
    cfg = get_config(arch)
    if arch == X_VLM:
        layers = layers or X_VLM_LAYERS
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def x_extras(torch, cfg, batch: int) -> dict:
    """The batch's vision states or frames for ``batch`` rows, bf16 on the
    card, drawn from SEED (the same on every rank and in one process)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    if cfg.family == "vlm":
        name, shape = "vision", (batch, cfg.vision_tokens, cfg.vision_dim)
    else:
        name, shape = "frames", (batch, cfg.encoder_seq, cfg.d_model)
    return {name: torch.randn(shape, generator=gen, device="cuda")
            .to(torch.bfloat16)}


def x_prompts(cfg) -> np.ndarray:
    """Phase 15's prompts, whisper's cut to X_AUDIO_PROMPT_LEN tokens."""
    p = tp_prompts(cfg.vocab_size)
    return p if cfg.family == "vlm" else p[:, :X_AUDIO_PROMPT_LEN]


def x_train_batch(torch, cfg, seq: int) -> dict:
    rng = np.random.RandomState(SEED + 5)
    return {**{k: rng.randint(0, cfg.vocab_size, (X_TP_TRAIN_BATCH, seq))
               .astype(np.int32) for k in ("tokens", "targets")},
            **x_extras(torch, cfg, X_TP_TRAIN_BATCH)}


#: phase 18's training steps: (arch, layers, tokens a sequence)
X_TRAINS = ((X_AUDIO, None, X_TRAIN_SEQ),
            (X_VLM, X_VLM_TRAIN_LAYERS, X_VLM_TRAIN_SEQ))


def x_all_reduces(cfg, call: str) -> int:
    """The layout's all-reduces a prefill or decode call: one a
    row-parallel product (2 a VLM layer, self- or cross-attention; 2 a
    whisper encoder layer, 3 a decoder layer) and one for the vocab-split
    lookup."""
    if cfg.family == "vlm":
        return 1 + 2 * cfg.n_layers
    enc = 0 if call == "decode" else 2 * cfg.encoder_layers
    return 1 + enc + 3 * cfg.n_layers


def x_collective_counts(torch, model, params, prompts, extras) -> dict:
    """The collectives one rank runs in a prefill of ``prompts`` and one
    decode step (a run of its own, after the checked and timed ones):
    OpTrace's counts by kind (DTensor's functional collectives) and the
    calls of the port's own collectives."""
    from repro_torch.distributed import collectives
    from repro_torch.launch.hlo_analysis import OpTrace
    out = {}
    with torch.no_grad():
        collectives.reset_traffic()
        with OpTrace() as t:
            _, cache = model.prefill(params, {"tokens": prompts, **extras},
                                     max_seq=prompts.shape[1] + 1)
        out["prefill"] = t.totals()["collective_counts"]
        out["prefill_port"] = collectives.traffic["calls"]
        collectives.reset_traffic()
        with OpTrace() as t:
            model.decode_step(params, torch.as_tensor(prompts[:, -1:]),
                              cache)
        out["decode"] = t.totals()["collective_counts"]
        out["decode_port"] = collectives.traffic["calls"]
    torch.cuda.synchronize()
    return out


def x_rank(rank: int, ckpt_dir: str, int8_dir: str) -> dict:
    """Phase 18 (a)-(c) on one of X_RANKS ranks of a ("data"=1, "model"=2)
    mesh: the VLM and whisper served with quantize_dense on and off, each
    once checked (every kernel launch and quantized linear; rank 0 writes
    the int8 activations for the one-process run), off once more with
    the collectives timed and once with them counted; then one AdamW step
    of each, its kernels checked, its params saved."""
    import torch
    from repro_torch.distributed.act_sharding import use_mesh
    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import Model
    from repro_torch.optim.adam import AdamW
    from repro_torch.train import checkpoint
    from repro_torch.train.loop import make_train_step
    t_rank = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_mesh((1, X_RANKS), ("data", "model"), "cuda")
    res = {"jax": "jax" in sys.modules, "seconds": {}}
    secs = res["seconds"]
    with use_mesh(mesh):
        for arch in (X_VLM, X_AUDIO):
            cfg = x_tp_cfg(arch)
            t0 = time.perf_counter()
            params = Model(cfg, "cuda").init_placed(mesh, torch.Generator(
                device="cuda").manual_seed(SEED))
            open_gates(torch, params, X_GATE)
            torch.cuda.synchronize()
            res[arch, "init_s"] = time.perf_counter() - t0
            res[arch, "param_bytes"] = _local_param_bytes(params)
            if arch == X_VLM:
                res[arch, "layer_bytes"] = _local_param_bytes(
                    params["layers"])
            prompts, extras = x_prompts(cfg), x_extras(torch, cfg,
                                                       TP_PROMPTS)
            for quant in (True, False):
                t_sec = time.perf_counter()
                m = Model(dataclasses.replace(cfg, quantize_dense=quant),
                          "cuda")
                tp_serve(torch, dispatch, m, params, prompts[:, :16], new=1,
                         extras=extras)
                with KernelChecks(torch, dispatch, ("mha", "int_matmul")) \
                        as kc, Int8Check(TP_INT8_CALLS,
                                         record=quant and rank == 0) as i8:
                    run = tp_serve(torch, dispatch, m, params, prompts,
                                   new=X_NEW, extras=extras)
                if i8.records:
                    torch.save(i8.records, f"{int8_dir}/{arch}.pt")
                run.update(kc.report(), int8_calls=i8.calls,
                           int8_diff=i8.diff, int8_elements=i8.elements,
                           int8_gathered=i8.gathered,
                           int8_gathered_diff=i8.gathered_diff)
                del i8
                if not quant:
                    with SsmCollectiveTimer(torch) as ct:
                        t0 = time.perf_counter()
                        tp_serve(torch, dispatch, m, params, prompts,
                                 tokens=run["tokens"], new=X_NEW,
                                 extras=extras)
                        wall = time.perf_counter() - t0
                    run["coll_s"], run["coll_wall_s"] = ct.seconds, wall
                    run["coll_share"] = ct.seconds / wall
                    run["coll_calls"] = ct.calls
                    run["timed_counts"] = dict(dispatch.launch_counts)
                    run["collectives"] = x_collective_counts(
                        torch, m, params, prompts, extras)
                res[arch, "serve", quant] = run
                secs[f"{arch} serve {'on' if quant else 'off'}"] = \
                    time.perf_counter() - t_sec
            del params, m, extras
            torch.cuda.empty_cache()
        res["peak_serve"] = torch.cuda.max_memory_allocated()

        for arch, layers, seq in X_TRAINS:
            t_sec = time.perf_counter()
            cfg = x_tp_cfg(arch, layers)
            model = Model(cfg, "cuda")
            params = model.init_placed(mesh, torch.Generator(
                device="cuda").manual_seed(SEED)).trainable_()
            open_gates(torch, params, X_GATE)
            opt = AdamW(lr=TRAIN_LR)
            step = make_train_step(model, opt)
            batch = x_train_batch(torch, cfg, seq)
            torch.cuda.synchronize()
            dispatch.reset_launch_counts()
            t0 = time.perf_counter()
            with KernelChecks(torch, dispatch, ("mha", "mha_bwd")) as kc:
                params, _, m = step(params, opt.init(params), batch)
                loss = float(m["loss"])
                torch.cuda.synchronize()
            res[arch, "train"] = {
                "loss": loss, "grad_norm": float(m["grad_norm"]),
                "counts": dict(dispatch.launch_counts),
                "step_ms": (time.perf_counter() - t0) * 1e3, **kc.report()}
            t1 = time.perf_counter()
            checkpoint.save(f"{ckpt_dir}/{arch}", 1, params)
            res[arch, "saved"] = _shard_digests(params)
            del params, opt, step, batch
            torch.cuda.empty_cache()
            secs[f"{arch} train"] = t1 - t_sec
            secs[f"{arch} save"] = time.perf_counter() - t1
        res["peak_train"] = torch.cuda.max_memory_allocated()
    secs["all"] = time.perf_counter() - t_rank
    return res


def x_one_process(torch, dispatch, ranks: list, ckpt_dir: str,
                  int8_dir: str) -> dict:
    """The one-process runs phase 18 holds the ranks against: each arch
    fed the ranks' tokens (with quantize_dense on also fed their int8
    activations), its AdamW step, the ranks' checkpoint restored."""
    from repro_torch.models.api import Model
    from repro_torch.optim.adam import AdamW
    from repro_torch.train import checkpoint
    from repro_torch.train.loop import make_train_step
    r0, out = ranks[0], {"seconds": {}}
    secs = out["seconds"]
    for arch in (X_VLM, X_AUDIO):
        t_sec = time.perf_counter()
        cfg = x_tp_cfg(arch)
        params = Model(cfg, "cuda").init(torch.Generator(
            device="cuda").manual_seed(SEED))
        open_gates(torch, params, X_GATE)
        out[arch, "param_bytes"] = _local_param_bytes(params)
        prompts, extras = x_prompts(cfg), x_extras(torch, cfg, TP_PROMPTS)
        for quant in (True, False):
            m = Model(dataclasses.replace(cfg, quantize_dense=quant), "cuda")
            tokens = r0[arch, "serve", quant]["tokens"]
            tp_serve(torch, dispatch, m, params, prompts[:, :16], new=1,
                     extras=extras)
            out[arch, "serve", quant] = tp_serve(
                torch, dispatch, m, params, prompts, tokens=tokens,
                new=X_NEW, extras=extras)
            if quant:
                records = torch.load(f"{int8_dir}/{arch}.pt",
                                     weights_only=True)
                with Int8Feed(records, True) as f8:
                    run = tp_serve(torch, dispatch, m, params, prompts,
                                   tokens=tokens, new=X_NEW, extras=extras)
                run["flips"] = f8.flips
                out[arch, "int8"] = run
                del records
        del params, m, extras
        torch.cuda.empty_cache()
        secs[f"{arch} serve"] = time.perf_counter() - t_sec
    for arch, layers, seq in X_TRAINS:
        t_sec = time.perf_counter()
        cfg = x_tp_cfg(arch, layers)
        model = Model(cfg, "cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(
            SEED)).trainable_()
        open_gates(torch, params, X_GATE)
        opt = AdamW(lr=TRAIN_LR)
        step = make_train_step(model, opt)
        batch = x_train_batch(torch, cfg, seq)
        torch.cuda.synchronize()
        dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        _, _, m = step(params, opt.init(params), batch)
        loss = float(m["loss"])
        out[arch, "train"] = {"loss": loss, "grad_norm": float(m["grad_norm"]),
                              "counts": dict(dispatch.launch_counts),
                              "step_ms": (time.perf_counter() - t0) * 1e3}
        params.load_(checkpoint.restore(f"{ckpt_dir}/{arch}", 1, params))
        out[arch, "restored"] = [_slice_digests(params, r[arch, "saved"])
                                 for r in ranks]
        del params, opt, step, model, batch
        torch.cuda.empty_cache()
        secs[f"{arch} train"] = time.perf_counter() - t_sec
    out["peak"] = torch.cuda.max_memory_allocated()
    return out


def x_on_card(torch, dispatch, ssm: dict, smi: str) -> dict:
    """Phase 18, checks (a)-(c) (the module docstring), on what phase 17's
    ranks ran of it (``ssm["x_ranks"]``); (d) runs with phase 15 (e)."""
    import shutil
    xtp = {"ranks": ssm["x_ranks"]}
    t0 = time.perf_counter()
    one = x_one_process(torch, dispatch, xtp["ranks"], str(X_DIR / "ckpt"),
                        str(X_DIR / "int8"))
    one_s = time.perf_counter() - t0
    shutil.rmtree(X_DIR, ignore_errors=True)
    check_x(xtp, one, smi)
    xtp["wall_s"] = ssm["x_ranks_s"] + time.perf_counter() - t0
    say(f"xtp: phase 18 (a)-(c) in {xtp['wall_s']:.1f} s (ranks "
        f"{ssm['x_ranks_s']:.1f} s, on phase 17's ranks; one process "
        f"{one_s:.1f} s) on {smi}")
    return xtp


def check_x(xtp: dict, one: dict, smi: str) -> None:
    """Phase 18 (a)-(c) against the one-process runs: every number
    printed, then every failed check listed at once."""
    ranks, bad = xtp["ranks"], []
    if any(r["jax"] for r in ranks):
        bad.append("xtp: a rank imported JAX")
    for r in ranks:
        for arch in (X_VLM, X_AUDIO):
            for part in [r[arch, "serve", q] for q in (True, False)] + [
                    r[arch, "train"]]:
                bad += [f"xtp kernels: {o}" for o in part["kernel_over"]]
    for arch in (X_VLM, X_AUDIO):
        cfg = x_tp_cfg(arch)
        tag = "(a)" if arch == X_VLM else "(b)"
        for quant in (True, False):
            mode = "quantize_dense on" if quant else "off"
            got = ranks[0][arch, "serve", quant]
            # quantize_dense on: the one-process run fed the ranks' int8
            want = one[arch, "int8"] if quant else one[arch, "serve", quant]
            for r in ranks[1:]:
                if not np.array_equal(r[arch, "serve", quant]["logits"],
                                      got["logits"]):
                    bad.append(f"xtp {tag} {mode}: the ranks' logits differ")
            err = float(np.abs(got["logits"] - want["logits"]).max())
            sure, agree = _greedy(want["logits"][:X_NEW], got["tokens"],
                                  TP_BF16_TOL)
            say(f"xtp {tag} {arch} at {cfg.n_layers} layers, {mode}: logits "
                f"(prefill + {X_NEW} decode steps) max |sharded - one "
                f"process{' fed their int8' if quant else ''}| {err:.4g} "
                f"(tolerance {TP_BF16_TOL}); greedy tokens equal at "
                f"{int((agree & sure).sum())} of {int(sure.sum())} "
                f"positions whose top-2 margin exceeds it "
                f"({int(agree.sum())} of {agree.size} in all)")
            if err > TP_BF16_TOL or not np.all(agree[sure]):
                bad.append(f"xtp {tag} {arch} {mode}: sharded serving "
                           f"disagrees with one process")
            ref = one[arch, "serve", quant]
            want_counts = x_counts(dataclasses.replace(
                cfg, quantize_dense=quant), 1, X_NEW)
            for r in ranks:
                c = r[arch, "serve", quant]
                if c["counts"] != ref["counts"] \
                        or c.get("timed_counts", c["counts"]) != c["counts"]:
                    bad.append(f"xtp {tag} {mode}: rank launches "
                               f"{c['counts']} (collective-timed run "
                               f"{c.get('timed_counts')}) != one process "
                               f"{ref['counts']}")
            if got["counts"] != want_counts:
                bad.append(f"xtp {tag} {mode}: launches {got['counts']}, "
                           f"not {want_counts}")
            line = (f"xtp {tag} {arch} {mode}: prefill "
                    f"{got['prefill_ms']:.1f} ms against "
                    f"{ref['prefill_ms']:.1f} ms in one process; "
                    f"{got['decode_ms']:.1f} ms a decode token against "
                    f"{ref['decode_ms']:.1f} ms (the ranks' checked run"
                    f"{', every int8 activation gathered' if quant else ''}"
                    f"); launches a rank {got['counts']} (= one process); "
                    f"every launch against its plain version on the rank's "
                    f"operands: {got['kernel_checked']}, errors "
                    f"{got['kernel_errs']} (int_matmul exact, mha <= "
                    f"{TRAIN_BWD_BF16_RTOL} of max |plain|); shapes "
                    f"{got['shapes']}")
            if not quant:
                line += (f"; the collectives {got['coll_s'] * 1e3:.1f} ms "
                         f"of a {got['coll_wall_s'] * 1e3:.1f} ms serve run "
                         f"({got['coll_share']:.1%}, {got['coll_calls']} "
                         f"timed, every one synchronised)")
            say(line + f" on {smi}")
        heads = 32 if arch == X_VLM else 16       # padded query heads
        on = ranks[0][arch, "serve", True]
        calls = one[arch, "serve", True]["counts"].get("int_matmul", 0)
        flips = one[arch, "int8"]["flips"]
        say(f"xtp {tag} quantize_dense on: int8 activations of all "
            f"{on['int8_calls']} quantized linears ({on['int8_elements']:,} "
            f"elements) against one-process quantization of the gathered "
            f"inputs: {on['int8_diff']} differ; int32 products of the "
            f"first {on['int8_gathered']} against int_matmul on the "
            f"gathered operands: {on['int8_gathered_diff']} differ; the "
            f"one-process run quantizing its own activations differs from "
            f"the ranks' in {sum(flips):,} int8 elements over {len(flips)} "
            f"calls, and is fed theirs")
        if on["int8_calls"] != calls or on["int8_diff"] \
                or on["int8_gathered"] != TP_INT8_CALLS \
                or on["int8_gathered_diff"] or len(flips) != calls:
            bad.append(f"xtp {tag}: sharded int8 activations or int_matmul "
                       f"outputs differ from one process on the same "
                       f"inputs")
        for shapes in on["shapes"].get("mha", ()):
            if shapes[0][1] != heads // X_RANKS:
                bad.append(f"xtp {tag}: mha ran on {shapes}, not on the "
                           f"rank's {heads // X_RANKS} heads")
        hidden = cfg.d_ff // X_RANKS
        for (_, b) in on["shapes"].get("int_matmul", ()):
            if b not in ((cfg.d_model, hidden), (hidden, cfg.d_model)):
                bad.append(f"xtp {tag}: int_matmul ran on a weight {b}, not "
                           f"a shard")
        coll = ranks[0][arch, "serve", False]["collectives"]
        for call in ("prefill", "decode"):
            want_c = {"all-reduce": x_all_reduces(cfg, call)}
            say(f"xtp {tag} {arch}: the collectives of one {call} call a "
                f"rank {coll[call]} (the layout's {want_c}), "
                f"{coll[call + '_port']} of the port's own")
            for r in ranks:
                c = r[arch, "serve", False]["collectives"]
                if c[call] != want_c or c[call + "_port"]:
                    bad.append(f"xtp {tag} {call}: collectives {c[call]} and "
                               f"{c[call + '_port']} of the port's own, not "
                               f"{want_c}")
    for arch, layers, seq in X_TRAINS:
        cfg = x_tp_cfg(arch, layers)
        got, want = ranks[0][arch, "train"], one[arch, "train"]
        for r in ranks:
            if r[arch, "train"]["counts"] != want["counts"]:
                bad.append(f"xtp (c) {arch}: rank launches "
                           f"{r[arch, 'train']['counts']} != one process "
                           f"{want['counts']}")
        dloss = abs(got["loss"] - want["loss"])
        dnorm = abs(got["grad_norm"] - want["grad_norm"]) / want["grad_norm"]
        say(f"xtp (c) {arch} at {cfg.n_layers} layers, one AdamW step on "
            f"{X_TP_TRAIN_BATCH} x {seq} tokens: loss {got['loss']:.5f} "
            f"against {want['loss']:.5f} (|d| {dloss:.3g}, tolerance "
            f"{TRAIN_LOSS_ATOL}), grad norm {got['grad_norm']:.5f} against "
            f"{want['grad_norm']:.5f} (rel {dnorm:.3g}, tolerance "
            f"{TRAIN_GRAD_RTOL}); {got['step_ms']:.0f} ms a step (the first) "
            f"against {want['step_ms']:.0f} ms; launches a rank "
            f"{got['counts']}; every launch against its plain version on the "
            f"rank's operands: {got['kernel_checked']}, errors "
            f"{got['kernel_errs']} on {smi}")
        if dloss > TRAIN_LOSS_ATOL or dnorm > TRAIN_GRAD_RTOL:
            bad.append(f"xtp (c) {arch}: the sharded step disagrees with one "
                       f"process")
        differ = _restore_mismatch([r[arch, "saved"] for r in ranks],
                                   one[arch, "restored"])
        if differ:
            bad.append(f"xtp (c) {arch}: {len(differ)} leaves differ after "
                       f"the restore (first {differ[:3]})")
        say(f"xtp (c) {arch}: the ranks' state restored into one process, "
            f"{len(one[arch, 'restored'][0])} leaves, each rank's shards bit "
            f"for bit")
    for arch in (X_VLM, X_AUDIO):
        say(f"xtp {arch}: parameter bytes a rank "
            f"{[r[arch, 'param_bytes'] for r in ranks]} against "
            f"{one[arch, 'param_bytes']:,} in one process, drawn in "
            f"{[round(r[arch, 'init_s'], 1) for r in ranks]} s")
    say(f"xtp: seconds on rank 0 "
        f"{ {k: round(v, 1) for k, v in ranks[0]['seconds'].items()} }, in "
        f"one process { {k: round(v, 1) for k, v in one['seconds'].items()} }")
    say(f"xtp: peaks a rank serving {[r['peak_serve'] / 2 ** 30 for r in ranks]}"
        f" GiB, training {[r['peak_train'] / 2 ** 30 for r in ranks]} GiB; "
        f"one process {one['peak'] / 2 ** 30:.1f} GiB on {smi}")
    if bad:
        fail("; ".join(bad))


def x_kernel_errs(xtp: dict) -> dict:
    """Phase 18's launches on rank 0 (serving and training) and the
    largest kernel-against-plain errors over the ranks."""
    errs, counts = {}, {}
    for r in xtp["ranks"]:
        for arch in (X_VLM, X_AUDIO):
            for part in [r[arch, "serve", q] for q in (True, False)] + [
                    r[arch, "train"]]:
                for k, e in part["kernel_errs"].items():
                    errs[k] = max(errs.get(k, 0.0), e)
    r0 = xtp["ranks"][0]
    for arch in (X_VLM, X_AUDIO):
        for part in [r0[arch, "serve", q] for q in (True, False)] + [
                r0[arch, "train"]]:
            add_counts(counts, part["counts"])
    return {"errs": errs, "counts": counts}


def _sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _ranks_agree(torch, dist, params) -> bool:
    """Whether every rank holds the same bits in every leaf: two checksums
    a leaf (the sum of its bits as integers and of their squares), their
    max and min over the ranks equal."""
    sums = []
    with torch.no_grad():
        for p in params.parameters():
            bits = p.view({2: torch.int16, 4: torch.int32}[p.element_size()])
            wide = bits.to(torch.int64)
            sums += [wide.sum(), (wide * wide).sum()]
            del wide
    local = torch.stack(sums).cpu()
    hi, lo = local.clone(), -local
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MAX)
    return bool(torch.equal(hi, -lo))


def dp_flat_rank(rank: int, device: str, reduced: bool, layers: int,
                 batch: int, seq: int, steps: int) -> dict:
    """Phase 13 (a) on one rank: the one-process reference step (rank 0),
    then ``steps`` exact and ``steps`` compressed make_dp_train_step steps
    of TRAIN_ARCH over a ("data",) mesh of every rank."""
    import torch
    import torch.distributed as dist
    from repro_torch.data.tokens import MarkovCorpus
    from repro_torch.distributed import collectives
    from repro_torch.kernels import dispatch
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.grad_compression import (compressed_bytes_saved,
                                                    init_error_buffers)
    from repro_torch.train import loop
    cuda = torch.device(device).type == "cuda"
    mesh = make_mesh((dist.get_world_size(),), ("data",), device)
    cfg, model, opt, step_fn = launch_train.build(
        TRAIN_ARCH, reduced=reduced, lr=TRAIN_LR, device=device,
        overrides={"n_layers": layers})

    def init():
        gen = torch.Generator(device=device).manual_seed(SEED)
        return model.init(gen).trainable_()
    corpus = MarkovCorpus(cfg.vocab_size, seed=SEED)
    draws = [corpus.batch(batch, seq) for _ in range(steps)]
    res = {}
    ref = p0 = None
    if rank == 0:              # the one-process step on the global batch
        p0, ref = init(), init()
        m = step_fn(ref, opt.init(ref), draws[0])[2]     # updates ref
        res["ref_loss"] = float(m["loss"])
        if cuda:
            torch.cuda.empty_cache()
    reduce_s = []
    real_reduce = loop.dp_reduce

    def timed_reduce(*args, **kwargs):
        _sync(torch, device)
        t0 = time.perf_counter()
        out = real_reduce(*args, **kwargs)
        _sync(torch, device)
        reduce_s.append(time.perf_counter() - t0)
        return out
    loop.dp_reduce = timed_reduce
    for compress in (False, True):
        params = init()
        res["params"] = sum(p.numel() for p in params.parameters())
        opt_state = opt.init(params)
        err = init_error_buffers(params) if compress else {}
        step = loop.make_dp_train_step(model, opt, mesh, compress=compress)
        run = {"loss": [], "step_s": [], "agree": [], "peak": []}
        reduce_s.clear()
        collectives.reset_traffic()
        _sync(torch, device)
        dispatch.reset_launch_counts()
        for b in draws:
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            params, opt_state, err, m = step(params, opt_state, err, b)
            loss = float(m["loss"])
            _sync(torch, device)
            run["step_s"].append(time.perf_counter() - t0)
            run["loss"].append(loss)
            if cuda:
                run["peak"].append(torch.cuda.max_memory_allocated())
            if ref is not None:          # rank 0 after the exact step 1
                with torch.no_grad():
                    pr = dict(ref.named_parameters())
                    pz = dict(p0.named_parameters())
                    run["step1_update_err"] = max(
                        float((p.float() - pr[n].float()).norm()
                              / (pr[n].float() - pz[n].float()).norm()
                              .clamp_min(1e-30))
                        for n, p in params.named_parameters())
                ref = p0 = pr = pz = None
            run["agree"].append(_ranks_agree(torch, dist, params))
        run["counts"] = dict(dispatch.launch_counts)
        run["traffic"] = dict(collectives.traffic)
        run["reduce_s"] = list(reduce_s)
        run["saved_model"] = compressed_bytes_saved(params)
        res["compressed" if compress else "exact"] = run
        del params, opt_state, err
        if cuda:
            torch.cuda.empty_cache()
    loop.dp_reduce = real_reduce
    return res


def dp_small_rank(rank: int, device: str) -> dict:
    """Phase 13 (b)-(d) on one of four ranks: the hierarchical trainer
    against the flat one, the pipeline against the sequential run, and
    the compress collectives on ``device`` against the same on the CPU."""
    import copy
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.data.tokens import MarkovCorpus
    from repro_torch.distributed import collectives
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch.mesh import describe, make_mesh
    from repro_torch.models.api import Model
    from repro_torch.optim.adam import AdamW
    from repro_torch.optim.grad_compression import (compress_decompress_psum,
                                                    ef_compress_psum,
                                                    init_error_buffers)
    from repro_torch.train import loop
    res = {}
    # (b) flat (4,) against hierarchical (2, 2), reduced float32
    cfg = get_config(TRAIN_ARCH).reduced()
    model = Model(cfg, device=device)
    weights = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    for shape, axes in (((4,), ("data",)), ((2, 2), ("pod", "data"))):
        mesh = make_mesh(shape, axes, device)
        params = copy.deepcopy(weights).to(device).trainable_()
        opt = AdamW(lr=3e-3)
        opt_state, err = opt.init(params), init_error_buffers(params)
        step = loop.make_dp_train_step(model, opt, mesh)
        corpus = MarkovCorpus(cfg.vocab_size, seed=SEED)
        collectives.reset_traffic()
        losses, agree = [], []
        for _ in range(DP_SMALL_STEPS):
            params, opt_state, err, m = step(
                params, opt_state, err,
                corpus.batch(DP_SMALL_BATCH, DP_SMALL_SEQ))
            losses.append(float(m["loss"]))
            agree.append(_ranks_agree(torch, dist, params))
        res[describe(mesh)] = {"loss": losses, "agree": agree,
                               "traffic": dict(collectives.traffic)}
    # (c) the pipeline, 4 stages of 2 layers, against the sequential run
    rng = np.random.RandomState(SEED)
    w = torch.from_numpy((rng.normal(0, 1, (PIPE_L, PIPE_D, PIPE_D))
                          / np.sqrt(PIPE_D)).astype(np.float32)).to(device)
    bias = torch.from_numpy(rng.normal(0, 0.1, (PIPE_L, PIPE_D))
                            .astype(np.float32)).to(device)
    xs = torch.from_numpy(rng.normal(
        0, 1, (PIPE_MICRO, PIPE_B, PIPE_S, PIPE_D)).astype(np.float32)
                          ).to(device)

    def block_fn(p, h):
        for wi, bi in zip(p["w"], p["b"]):
            h = torch.tanh(h @ wi + bi)
        return h
    whole = {"w": w.clone().requires_grad_(),
             "b": bias.clone().requires_grad_()}
    out_seq = torch.stack([block_fn(whole, xs[m])
                           for m in range(PIPE_MICRO)])
    (out_seq ** 2).sum().backward()
    stage, per = dist.get_rank(), PIPE_L // 4
    mine = {k: v[stage * per:(stage + 1) * per].clone().requires_grad_()
            for k, v in (("w", w), ("b", bias))}
    pipe_mesh = make_mesh((4,), ("stage",), device)
    collectives.reset_traffic()
    out = pipeline_apply(pipe_mesh, "stage", block_fn, mine, xs)
    (out ** 2).sum().backward()
    _sync(torch, device)
    res["pipe_fwd_err"] = float((out - out_seq).detach().abs().max())
    res["pipe_grad_err"] = max(
        float((mine[k].grad - whole[k].grad[stage * per:(stage + 1) * per])
              .abs().max() / whole[k].grad.abs().max()) for k in ("w", "b"))
    res["pipe_traffic"] = dict(collectives.traffic)
    # (d) the compress collectives, device against CPU tensors
    rng = np.random.RandomState(100 + rank)
    cases = {"leaf": (rng.normal(0, 3e-3, DP_COMPRESS_SHAPE),
                      rng.normal(0, 1e-5, DP_COMPRESS_SHAPE), torch.float32),
             "bf16": (rng.normal(0, 2, 4096), rng.normal(0, 0.01, 4096),
                      torch.bfloat16)}
    same = {}
    for name, (g, e, dtype) in cases.items():
        outs = {}
        for dev in (device, "cpu"):
            tg = torch.from_numpy(g.astype(np.float32)).to(dev, dtype)
            te = torch.from_numpy(e.astype(np.float32)).to(dev)
            outs[dev] = [t.cpu() for t in (compress_decompress_psum(tg),
                                           *ef_compress_psum(tg, te, None,
                                                             4))]
        same[name] = all(torch.equal(a, b) for a, b in
                         zip(outs[device], outs["cpu"]))
    res["compress_same"] = same
    return res


def dp_on_card(torch, smi: str) -> dict:
    """Phase 13: the data-parallel trainer over ranks sharing the card,
    checks (a)-(d) of the module docstring; returns the launch counts and
    the numbers printed."""
    from repro_torch.launch.mesh import backend_for, spawn_ranks
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    say(f"dp: {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB held by "
        f"this process, {free / 2 ** 30:.2f} of {total / 2 ** 30:.2f} GiB "
        f"free on the card; {DP_RANKS} ranks share it over "
        f"{backend_for('cuda', DP_RANKS)}")
    # two replicas and their transients fill most of the card: the ranks'
    # allocators (and only theirs) map segments that grow rather than
    # cache fixed blocks
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        ranks = spawn_ranks(dp_flat_rank, DP_RANKS, device="cuda",
                            timeout=DP_TIMEOUT,
                            args=("cuda", False, DP_LAYERS, TRAIN_BATCH,
                                  TRAIN_SEQ, DP_STEPS))
        small = spawn_ranks(dp_small_rank, DP_SMALL_RANKS, device="cuda",
                            timeout=DP_TIMEOUT, args=("cuda",))
    finally:
        if conf is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf
    res = check_dp_flat(ranks, DP_LAYERS, DP_STEPS, smi)
    res.update(check_dp_small(small))
    res["wall_s"] = time.perf_counter() - t_phase
    say(f"dp: phase 13 in {res['wall_s']:.1f} s on {smi}")
    return res


def check_dp_flat(ranks: list, layers: int, steps: int, smi: str) -> dict:
    """Phase 13 (a)'s checks and lines from its ranks' results."""
    res = {"counts": {}}
    expected = {"mha": 2 * layers * steps, "mha_bwd": layers * steps}
    n_params = ranks[0]["params"]
    say(f"dp: (a) {TRAIN_ARCH}, {layers} of 40 layers, {n_params:,} "
        f"parameters a replica ({16 * n_params / 2 ** 30:.1f} GiB a rank at "
        f"16 bytes a parameter), B={TRAIN_BATCH} x S={TRAIN_SEQ} over "
        f"{len(ranks)} ranks, AdamW lr {TRAIN_LR}")
    for mode in ("exact", "compressed"):
        runs = [r[mode] for r in ranks]
        step_ms = statistics.median(runs[0]["step_s"][1:]) * 1e3
        reduce_ms = statistics.median(runs[0]["reduce_s"][1:]) * 1e3
        t = runs[0]["traffic"]
        payload = sum(v for k, v in t.items()
                      if k not in ("staged", "calls")) / steps
        f32_b, int8_b = runs[0]["saved_model"]
        m = res[mode] = dict(
            losses=runs[0]["loss"], step_ms=step_ms, reduce_ms=reduce_ms,
            tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
            payload_bytes=payload, staged_bytes=t.get("staged", 0) / steps,
            saved_model=(f32_b, int8_b),
            peak_bytes=[max(r["peak"], default=0) for r in runs],
            counts=[r["counts"] for r in runs])
        say(f"dp: (a) {mode}: losses {m['losses']}; {step_ms:.1f} ms a step "
            f"(median of steps 2-{steps}, host clock, synchronised), "
            f"{m['tokens_per_s']:.0f} tokens/s over the ranks; the "
            f"reduction {reduce_ms:.1f} ms a step; payload handed to "
            f"collectives {payload / 1e9:.4f} GB a rank a step "
            f"(compressed_bytes_saved's model: {f32_b / 1e9:.4f} GB float32 "
            f"against {int8_b / 1e9:.4f} GB int8), "
            f"{m['staged_bytes'] / 1e9:.4f} GB copied through host "
            f"memory by the port; peak "
            f"{[round(b / 2 ** 30, 2) for b in m['peak_bytes']]} GiB a rank;"
            f" launch counts {m['counts']} (expected {expected} a rank) "
            f"(on {smi})")
        if any(c != expected for c in m["counts"]):
            fail(f"dp: (a) {mode} launch counts {m['counts']} != {expected}")
        if not all(all(r["agree"]) for r in runs):
            fail(f"dp: (a) {mode}: the ranks' parameters differ after a step")
        if not np.all(np.isfinite(m["losses"])) or any(
                r["loss"] != runs[0]["loss"] for r in runs):
            fail(f"dp: (a) {mode}: losses not finite or not the same on "
                 f"every rank")
    for k in ("mha", "mha_bwd"):
        res["counts"][k] = res["exact"]["counts"][0].get(k, 0) \
            + res["compressed"]["counts"][0].get(k, 0)
    exact, comp = res["exact"]["losses"], res["compressed"]["losses"]
    dloss = abs(exact[0] - ranks[0]["ref_loss"])
    upd = ranks[0]["exact"]["step1_update_err"]
    gap = abs(comp[-1] - exact[-1])
    say(f"dp: (a) step 1 against one-process make_train_step on the global "
        f"batch: loss {exact[0]:.5f} / {ranks[0]['ref_loss']:.5f} (|d| "
        f"{dloss:.3g} <= {TRAIN_LOSS_ATOL}); worst leaf update off by "
        f"{upd:.3g} of its norm (<= {DP_STEP_RTOL}); compressed last loss "
        f"{comp[-1]:.4f} (first {comp[0]:.4f}) against exact {exact[-1]:.4f}"
        f": gap {gap:.4f} (< {DP_EF_LOSS_GAP}); parameters bit-identical on "
        f"every rank after every step")
    if not dloss <= TRAIN_LOSS_ATOL or not upd <= DP_STEP_RTOL:
        fail("dp: (a) step 1 off the one-process step")
    if not (comp[-1] < comp[0] and gap < DP_EF_LOSS_GAP):
        fail("dp: (a) the compressed run does not learn within the "
             "reference's bound of the exact run")
    res["step1_loss_err"], res["step1_update_err"] = dloss, upd
    return res


def check_dp_small(small: list) -> dict:
    """Phase 13 (b)-(d)'s checks and lines from the four ranks' results."""
    flat, hier = small[0]["data=4"], small[0]["pod=2 x data=2"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(hier["loss"],
                                                   flat["loss"]))
    say(f"dp: (b) reduced {TRAIN_ARCH}, float32, {DP_SMALL_STEPS} steps on "
        f"four ranks: hierarchical (pod=2 x data=2) losses {hier['loss']} "
        f"against flat {flat['loss']}: rel {rel:.3g} (<= {DP_POD_RTOL}); "
        f"rank 0's traffic, flat {flat['traffic']}, hierarchical "
        f"{hier['traffic']}")
    if not rel <= DP_POD_RTOL or not all(
            all(r[k]["agree"]) for r in small
            for k in ("data=4", "pod=2 x data=2")):
        fail("dp: (b) the hierarchical trainer is off the flat one, or the "
             "ranks differ")
    fwd = max(r["pipe_fwd_err"] for r in small)
    grad = max(r["pipe_grad_err"] for r in small)
    say(f"dp: (c) the pipeline over 4 stages ({PIPE_L} layers of "
        f"{PIPE_D}, {PIPE_MICRO} microbatches): forward within {fwd:.3g} "
        f"(<= {PIPE_FWD_ATOL}), stage gradients within {grad:.3g} of max "
        f"|sequential| (<= {PIPE_GRAD_RTOL}); stage 1's traffic "
        f"{small[1]['pipe_traffic']}")
    if not fwd <= PIPE_FWD_ATOL or not grad <= PIPE_GRAD_RTOL:
        fail("dp: (c) the pipeline is off the sequential run")
    same = [r["compress_same"] for r in small]
    say(f"dp: (d) compress collectives on CUDA tensors == CPU tensors, "
        f"bit for bit, per rank: {same}")
    if not all(all(s.values()) for s in same):
        fail("dp: (d) the compress collectives differ between CUDA and CPU "
             "tensors")
    return {"pod_rel": rel, "pipe_fwd_err": fwd, "pipe_grad_err": grad}


# -- phase 14: PIM-ML over ranks sharing the card ------------------------------

def digest(*arrays) -> str:
    """A sha256 of arrays' dtypes, shapes and bytes."""
    import hashlib
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(np.asarray(a))
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def pim_params(workload: str, small: bool = False) -> dict:
    """Phase 4-5's parameters of a workload's fit (``small``: phase 14's
    reduced four-rank case)."""
    if workload in ("linreg", "logreg"):
        return {"n_iters": ITERS}
    if workload == "kmeans":
        return {"n_clusters": KME_K, "n_init": 1, "max_iter": ITERS,
                "tol": 0.0}
    if workload == "dtree":
        return {"max_depth": 6 if small else DTR_DEPTH}
    return dict(n_iters=EMB_CHECK_ITERS if small else EMB_ITERS,
                batch=EMB_BATCH, dim=EMB_DIM, lr=EMB_LR,
                frac_bits=EMB_FRAC_BITS, seed=SEED, flush_every=EMB_FLUSH,
                **({} if small else dict(n_users=EMB_USERS,
                                         n_items=EMB_ITEMS,
                                         record_every=EMB_ITERS // 4)))


def model_summary(workload: str, m) -> dict:
    """What phase 14 compares of a fit's model: large arrays as digests."""
    if workload in ("linreg", "logreg"):
        return {"w": digest(m.w), "b": float(m.b)}
    if workload == "kmeans":
        return {"centroids": digest(m.centroids), "labels": digest(m.labels),
                "n_iters": int(m.n_iters), "inertia": float(m.inertia)}
    if workload == "dtree":
        return {"tree": digest(m.feature, m.threshold, m.left, m.right,
                               m.leaf_class, m.depth),
                "n_nodes": int(m.n_nodes)}
    return {"tables": digest(m.user_raw, m.item_raw),
            "history": [tuple(h) for h in m.history],
            "n_flushes": int(m.n_flushes)}


def same_summary(got: dict, want: dict) -> bool:
    """Equal summaries; a KME inertia (a float32 sum over the cores in
    another order over ranks) within KME_INERTIA_RTOL."""
    if "inertia" in want:
        got, want = dict(got), dict(want)
        gi, wi = got.pop("inertia"), want.pop("inertia")
        if abs(gi - wi) > KME_INERTIA_RTOL * abs(wi):
            return False
    return got == want


def _step_state(gen, tick) -> dict:
    """The state a fit holds after a step: its snapshot's arrays, or, for
    a tree (not resumable), the arrays of the tree grown so far."""
    if getattr(tick, "resumable", False):
        return tick.snapshot()["arrays"]
    while getattr(gen, "gi_yieldfrom", None) is not None:
        gen = gen.gi_yieldfrom
    local = gen.gi_frame.f_locals
    return {k: local[k] for k in ("feature", "threshold", "left", "right",
                                  "leaf_class", "depth")}


def ranked_fit(torch, system, ds, workload: str, spec, every: int = 1):
    """One fit through ``fit_steps`` with the digest of the model state
    after every ``every``-th step and after the last; returns the model,
    the digests and the wall seconds to a synchronize."""
    from repro_torch.api import get_workload
    gen = get_workload(workload).fit_steps(ds, spec)
    digests, steps = [], 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while True:
        try:
            tick = next(gen)
        except StopIteration as stop:
            torch.cuda.synchronize()
            return stop.value.model, digests, time.perf_counter() - t0
        steps += int(tick)
        if steps % every == 0:
            arrays = _step_state(gen, tick)
            digests.append(digest(*(arrays[k] for k in sorted(arrays))))


def per_iteration(workload: str, steps: list, n_iters: int) -> float:
    """Seconds an iteration, as phase 5 reports it: the whole fit over its
    iterations (LIN, LOG), the median of iterations 2-N (KME, EMB), the
    mean round (DTR)."""
    if workload in ("linreg", "logreg"):
        return sum(steps) / n_iters
    if workload == "dtree":
        return sum(steps) / len(steps)
    return statistics.median(steps[1:n_iters])


def pim_rank_fits(torch, system_for, data: dict, fits: dict, small: bool
                  ) -> dict:
    """Phase 14's fits on one rank: each with the launch counts zeroed
    just before it and read just after, the state's digests, then timed
    again plain and with every collective synchronised and timed."""
    from repro_torch.api import get_workload
    from repro_torch.distributed import collectives
    from repro_torch.kernels import dispatch
    out, systems, views = {}, {}, {}
    for name, (workload, version, key, reduce) in fits.items():
        if reduce not in systems:
            systems[reduce] = system_for(reduce)
        system = systems[reduce]
        if (reduce, key) not in views:
            views[reduce, key] = system.put(*data[key])
        ds = views[reduce, key]
        wl = get_workload(workload)
        spec = wl.spec(version, **pim_params(workload, small))
        every = EMB_FLUSH if workload == "emb" else 1
        dispatch.reset_launch_counts()
        model, digests, first_s = ranked_fit(torch, system, ds, workload,
                                             spec, every)
        counts = dict(dispatch.launch_counts)
        rec = {"model": model_summary(workload, model), "digests": digests,
               "counts": counts, "first_s": first_s,
               "rounds": tree_rounds(model) if workload == "dtree" else 0,
               "n_flushes": getattr(model, "n_flushes", 0)}
        n_iters = rec["n_iters"] = (
            rec["rounds"] if workload == "dtree"
            else spec.params["n_iters"] if workload == "emb" else ITERS)
        for timing in (False, True):
            system.ranks.timing, system.ranks.seconds = timing, 0.0
            collectives.reset_traffic()
            torch.cuda.synchronize()
            steps, _ = step_times(wl.fit_steps(ds, spec))
            torch.cuda.synchronize()
            if timing:
                rec["reduce_s"] = system.ranks.seconds / n_iters
                rec["reduce_share"] = system.ranks.seconds / sum(steps)
                rec["timed_s"] = per_iteration(workload, steps, n_iters)
            else:
                rec["s"] = per_iteration(workload, steps, n_iters)
                rec["traffic"] = dict(collectives.traffic)
        system.ranks.timing = False
        rec["block"] = (system.ranks.start, system.ranks.stop)
        out[name] = rec
    return out, views


def pim_rank_kernels(torch, views: dict, system) -> dict:
    """Kernels 1-6 on this rank's own shards (the rank-local core count
    and shapes), each against its plain version once."""
    from repro_torch.core.lut import build_sigmoid_lut
    from repro_torch.kernels.gini_split import (gini_split_cuda,
                                                gini_split_plain)
    from repro_torch.kernels.kmeans_assign import (kmeans_assign_cuda,
                                                   kmeans_assign_plain)
    from repro_torch.kernels.lut_activation import (lut_sigmoid_cuda,
                                                    lut_sigmoid_plain)
    from repro_torch.kernels.quant_matmul import (fx_matvec_cuda,
                                                  fx_matvec_plain)
    from repro_torch.kernels.sparse_gather import (
        emb_gather_cuda, emb_gather_plain, emb_scatter_add_cuda,
        emb_scatter_add_plain)
    rng = np.random.RandomState(SEED + system.ranks.rank)
    dev = system.device
    out = {}

    def check(name, outs, refs, shape):
        out[name] = {"err": same(torch, outs, refs), "shape": list(shape)}

    x = views["fabric", "lin"].gd_view("int32")[0]
    w = torch.from_numpy(rng.randint(-(4 << 10), 4 << 10, x.shape[-1])
                         .astype(np.int32)).to(dev)
    check("fx_matvec", [fx_matvec_cuda(x, w, 10)],
          [fx_matvec_plain(x, w, 10)], x.shape)
    z = fx_matvec_plain(views["fabric", "log"].gd_view("int32")[0], w, 10)
    lut = build_sigmoid_lut(device=dev)
    for placement in ("wram", "mram"):
        check(f"lut_sigmoid {placement}",
              [lut_sigmoid_cuda(z, lut, placement)],
              [lut_sigmoid_plain(z, lut)], z.shape)
    kv = views["fabric", "kme"].kmeans_view("int16")
    c = torch.from_numpy(kv.host_q[rng.choice(kv.host_q.shape[0], KME_K,
                                              replace=False)]).to(dev)
    check("kmeans_assign", kmeans_assign_cuda(kv.shards, c),
          kmeans_assign_plain(kv.shards, c), kv.shards.shape)
    xs, ys, valid = views["fabric", "dtr"].tree_view()
    n_leaves = 2 ** (DTR_DEPTH + 2)
    leaf = torch.from_numpy(rng.randint(0, 1 << 10, tuple(valid.shape))
                            .astype(np.int32)).to(dev)
    th = torch.from_numpy(rng.randn(n_leaves, xs.shape[-1])
                          .astype(np.float32)).to(dev)
    check("gini_counts", gini_split_cuda(xs, ys, leaf, th, 2),
          gini_split_plain(xs, ys, leaf, th, 2), xs.shape)
    t = system.put_table(np.zeros((EMB_USERS, EMB_DIM), np.float32))
    tab, ids = t.view("int32", EMB_FRAC_BITS)
    tab = torch.from_numpy(rng.randint(INT32_MIN, INT32_MAX, tab.shape,
                                       np.int64).astype(np.int32)).to(dev)
    idx = torch.from_numpy(zipf_ids(rng, EMB_BATCH, EMB_USERS)).to(dev)
    upd = torch.from_numpy(rng.randint(INT32_MIN, INT32_MAX,
                                       (EMB_BATCH, EMB_DIM), np.int64)
                           .astype(np.int32)).to(dev)
    index = t.gather_index()
    check("emb_gather", [emb_gather_cuda(tab, ids, idx, index)],
          [emb_gather_plain(tab, ids, idx, index)], tab.shape)
    check("emb_scatter_add", [emb_scatter_add_cuda(tab, ids, idx, upd)],
          [emb_scatter_add_plain(tab, ids, idx, upd)], tab.shape)
    return out


def pim_rank(rank: int, files: dict) -> dict:
    """Phase 14 on one of PIM_RANKS ranks: the PIM_FITS over N_CORES
    cores spread over the ranks, on the memory-mapped data of phases
    4-5, then kernels 1-6 at the rank-local shapes."""
    import torch
    from repro_torch.api import make_system
    data = {}
    for key in ("lin", "log", "kme", "dtr", "emb"):
        # copy-on-write maps: the views' torch.from_numpy wants a
        # writable array (nothing writes them)
        X = np.load(files[key + "_x"], mmap_mode="c")
        y = (np.load(files[key + "_y"], mmap_mode="c")
             if key + "_y" in files else None)
        data[key] = (X, y)

    def system_for(reduce):
        return make_system("pim", n_cores=N_CORES, reduce=reduce,
                           device="cuda", backend="shard_map")
    fits, views = pim_rank_fits(torch, system_for, data, PIM_FITS, False)
    system = system_for("fabric")
    kernels = pim_rank_kernels(torch, views, system)
    return {"fits": fits, "kernels": kernels, "jax": "jax" in sys.modules,
            "block": (system.ranks.start, system.ranks.stop),
            "peak_bytes": torch.cuda.max_memory_allocated()}


def pim_small_data() -> dict:
    """The reduced four-rank case's data (made in every process alike)."""
    from repro_torch.data.synthetic import (make_blobs, make_classification,
                                            make_linear_dataset,
                                            make_recsys)
    n = PIM_SMALL_SAMPLES
    return {"lin": make_linear_dataset(n, N_FEATURES, seed=SEED)[:2],
            "log": make_classification(n, N_FEATURES, seed=SEED),
            "kme": (make_blobs(n, N_FEATURES, centers=KME_K,
                               seed=SEED)[0], None),
            "dtr": make_classification(2 * n, N_FEATURES, seed=SEED,
                                       class_sep=1.4),
            "emb": make_recsys(EMB_CHECK, n_users=600, n_items=300,
                               dim=EMB_DIM, seed=SEED)}


#: the reduced case's fits: every reduce hierarchical (groups of 8)
PIM_SMALL_FITS = {
    "lin int32 hierarchical": ("linreg", "int32", "lin", "hierarchical"),
    "log int32_lut_wram hierarchical": ("logreg", "int32_lut_wram", "log",
                                        "hierarchical"),
    "kme int16 hierarchical": ("kmeans", "int16", "kme", "hierarchical"),
    "dtr hierarchical": ("dtree", None, "dtr", "hierarchical"),
    "emb int32 D=8 hierarchical": ("emb", "int32", "emb", "hierarchical"),
}


def pim_small_rank(rank: int) -> dict:
    """Phase 14's reduced case on one of PIM_SMALL_RANKS ranks."""
    import torch
    from repro_torch.api import make_system
    fits, _ = pim_rank_fits(
        torch, lambda reduce: make_system(
            "pim", n_cores=PIM_SMALL_CORES, reduce=reduce, device="cuda",
            backend="shard_map"), pim_small_data(), PIM_SMALL_FITS, True)
    return {"fits": fits, "jax": "jax" in sys.modules}


def dtr_data(n_dtr: int, out_dir: str) -> float:
    """Phase 4's DTR dataset written as ``dtr_x.npy`` and ``dtr_y.npy``
    under ``out_dir`` (in a process of its own, beside the other
    datasets); its generation's seconds."""
    from repro_torch.data.synthetic import make_classification
    t0 = time.perf_counter()
    X, y = make_classification(n_dtr, N_FEATURES, seed=SEED, class_sep=1.4)
    np.save(Path(out_dir) / "dtr_x.npy", X)
    np.save(Path(out_dir) / "dtr_y.npy", y)
    return time.perf_counter() - t0


def pim_data(n_dtr: int, n_emb: int, mem_avail: int) -> dict:
    """Phases 4-5's datasets, made once here for them and for phase 14,
    and written as .npy files under PIM_DATA_DIR for phase 14's ranks.
    The DTR set is made in a process of its own beside the others when
    both generations' peaks fit 80% of ``mem_avail`` together (each alone
    fits half of it: ``host_samples``)."""
    import concurrent.futures
    import multiprocessing
    from repro_torch.data.synthetic import (make_blobs, make_classification,
                                            make_linear_dataset,
                                            make_recsys)
    PIM_DATA_DIR.mkdir(parents=True, exist_ok=True)
    apart = (n_dtr * DTR_HOST_BYTES_PER_SAMPLE + n_emb
             * EMB_HOST_BYTES_PER_SAMPLE) <= 0.8 * mem_avail
    pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn")) if apart else None
    dtr = pool.submit(dtr_data, n_dtr, str(PIM_DATA_DIR)) if apart else None
    t0 = time.perf_counter()
    data = {"lin": make_linear_dataset(N_SAMPLES, N_FEATURES, seed=SEED)[:2],
            "log": make_classification(N_SAMPLES, N_FEATURES, seed=SEED)}
    say(f"data: {N_SAMPLES}x{N_FEATURES} LIN and LOG datasets in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    data["kme"] = (make_blobs(KME_SAMPLES, N_FEATURES, centers=KME_K,
                              seed=SEED)[0], None)
    say(f"data: {KME_SAMPLES}x{N_FEATURES} KME blobs in "
        f"{time.perf_counter() - t0:.1f} s")
    if not apart:
        t0 = time.perf_counter()
        dtr_data(n_dtr, str(PIM_DATA_DIR))
        say(f"data: {n_dtr}x{N_FEATURES} DTR classification in "
            f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    data["emb"] = make_recsys(n_emb, n_users=EMB_USERS, n_items=EMB_ITEMS,
                              dim=EMB_DIM, seed=SEED)
    say(f"data: {n_emb:,} EMB ratings ({EMB_USERS:,} users x "
        f"{EMB_ITEMS:,} items) in {time.perf_counter() - t0:.1f} s")
    if apart:
        t0 = time.perf_counter()
        seconds = dtr.result()
        pool.shutdown()
        say(f"data: {n_dtr}x{N_FEATURES} DTR classification in "
            f"{seconds:.1f} s in a process of its own, beside the others "
            f"(waited {time.perf_counter() - t0:.1f} s for it after them)")
    data["dtr"] = tuple(np.load(PIM_DATA_DIR / f"dtr_{part}.npy")
                        for part in ("x", "y"))
    t0 = time.perf_counter()
    files = {f"dtr_{part}": str(PIM_DATA_DIR / f"dtr_{part}.npy")
             for part in ("x", "y")}
    for key, (X, y) in data.items():
        if key == "dtr":
            continue
        for part, a in (("x", X), ("y", y)):
            if a is not None:
                path = PIM_DATA_DIR / f"{key}_{part}.npy"
                np.save(path, a)
                files[f"{key}_{part}"] = str(path)
    size = sum(os.path.getsize(p) for p in files.values())
    say(f"data: {size / 2 ** 30:.2f} GiB written under {PIM_DATA_DIR} for "
        f"phase 14's ranks in {time.perf_counter() - t0:.1f} s")
    data["files"] = files
    return data


def pim_on_card(torch, data: dict, smi: str) -> dict:
    """Phase 14: the PIM system over PIM_RANKS ranks sharing the card,
    then the reduced four-rank case against this process's card fits.
    Returns the ranks' records (their fits are held against phases 4-5's
    one-process fits by check_pim_ranks)."""
    import shutil
    from repro_torch.api import get_workload, make_system
    from repro_torch.launch.mesh import backend_for, spawn_ranks
    t_phase = time.perf_counter()
    say(f"pim: {PIM_RANKS} ranks share the card over "
        f"{backend_for('cuda', PIM_RANKS)}, {N_CORES // PIM_RANKS} of "
        f"{N_CORES} PIM cores a rank")
    try:
        ranks = spawn_ranks(pim_rank, PIM_RANKS, device="cuda",
                            timeout=PIM_TIMEOUT, args=(data["files"],))
    finally:
        shutil.rmtree(PIM_DATA_DIR, ignore_errors=True)
    if any(r["jax"] for r in ranks):
        fail("pim: a rank imported JAX")
    blocks = [r["block"] for r in ranks]
    if blocks != [(0, N_CORES // 2), (N_CORES // 2, N_CORES)]:
        fail(f"pim: the ranks own cores {blocks}")
    for name, (workload, *_rest) in PIM_FITS.items():
        recs = [r["fits"][name] for r in ranks]
        check_pim_counts(name, workload, recs)
    for name in ranks[0]["kernels"]:
        k = [r["kernels"][name] for r in ranks]
        say(f"pim: {name} == plain at the rank-local shapes "
            f"{[x['shape'] for x in k]} (max abs err "
            f"{max(x['err'] for x in k)})")
    t_small = time.perf_counter()
    small = spawn_ranks(pim_small_rank, PIM_SMALL_RANKS, device="cuda",
                        timeout=PIM_TIMEOUT)
    sdata = pim_small_data()
    for name, (workload, version, key, reduce) in PIM_SMALL_FITS.items():
        recs = [r["fits"][name] for r in small]
        check_pim_counts(name, workload, recs)
        system = make_system("pim", n_cores=PIM_SMALL_CORES, reduce=reduce,
                             device="cuda")
        wl = get_workload(workload)
        want = model_summary(workload, wl.fit(
            system.put(*sdata[key]),
            wl.spec(version, **pim_params(workload, True))).model)
        if recs[0]["model"] != want:
            fail(f"pim: {name} over {PIM_SMALL_RANKS} ranks != the "
                 f"one-process card fit")
        say(f"pim: {name} on {PIM_SMALL_CORES} cores over "
            f"{PIM_SMALL_RANKS} ranks (blocks "
            f"{[r['fits'][name]['block'] for r in small]}, groups of 8 "
            f"across ranks 0-1 and 2-3) == the one-process card fit, bit "
            f"for bit; launch counts a rank {recs[0]['counts']}")
    say(f"pim: the {PIM_SMALL_RANKS}-rank case in "
        f"{time.perf_counter() - t_small:.1f} s")
    wall = time.perf_counter() - t_phase
    say(f"pim: phase 14 in {wall:.1f} s on {smi}")
    return {"ranks": ranks, "small": small, "wall_s": wall}


def check_pim_counts(name: str, workload: str, recs: list) -> None:
    """Every rank ran the same model state after every step and launched
    exactly what its fit needs."""
    first = recs[0]
    if not first["digests"] or any(r["digests"] != first["digests"]
                                   or r["model"] != first["model"]
                                   for r in recs):
        fail(f"pim: {name}: the ranks' model states differ")
    if workload in ("linreg", "logreg"):
        want = {"fx_matvec": ITERS}
        if workload == "logreg":
            want["lut_sigmoid"] = ITERS
    elif workload == "kmeans":
        want = {"kmeans_assign": ITERS}
    elif workload == "dtree":
        want = {"gini_split": first["rounds"]}
    else:
        if first["n_flushes"] != first["n_iters"] // EMB_FLUSH:
            fail(f"pim: {name}: {first['n_flushes']} flushes")
        want = {"emb_gather": 2 * first["n_iters"],
                "emb_scatter_add": 2 * first["n_flushes"]}
    for r in recs:
        if r["counts"] != want:
            fail(f"pim: {name}: launch counts {r['counts']} != {want}")


def check_pim_ranks(pim: dict, one_process: dict, smi: str) -> None:
    """Phase 14's fits over ranks against phases 4-5's one-process card
    fits (``one_process``: each PIM_FITS workload's model summary and its
    ms per iteration), and the lines with their times."""
    ranks = pim["ranks"]
    for name, (workload, version, key, reduce) in PIM_FITS.items():
        recs = [r["fits"][name] for r in ranks]
        want, one_s = one_process[workload]
        if not same_summary(recs[0]["model"], want):
            fail(f"pim: {name} over {PIM_RANKS} ranks != the one-process "
                 f"card fit")
        r = recs[0]
        unit = {"dtree": "round", "emb": "step"}.get(workload, "iteration")
        say(f"fit over ranks: {name:<26} {r['s'] * 1e3:.3f} ms/{unit} "
            f"(rank 0; rank 1 {recs[1]['s'] * 1e3:.3f}; one process, phase "
            f"5: {one_s * 1e3:.3f}); with every "
            f"collective synchronised and timed {r['timed_s'] * 1e3:.3f} "
            f"ms/{unit}, of which the cross-rank reduce "
            f"{r['reduce_s'] * 1e3:.3f} ms ({100 * r['reduce_share']:.1f}%); "
            f"traffic a rank {r['traffic']}; launch counts a rank "
            f"{r['counts']}; the first fit (views included) "
            f"{r['first_s']:.2f} s; == the one-process card fit, and both "
            f"ranks' state equal after every "
            f"{'flush' if workload == 'emb' else 'step'} "
            f"({len(r['digests'])} checks) ({N_CORES} cores over "
            f"{PIM_RANKS} ranks, on {smi})")


def examples_on_card(torch, dispatch, smi: str) -> dict:
    """Phase 19: every example's ``main`` on the default device, each with
    the launch counts zeroed just before it; returns the launches of each
    and in all, and the seconds."""
    import contextlib
    import importlib
    import io
    import shutil
    from repro_torch.configs.base import get_config
    from repro_torch.examples import outputs
    t_phase = time.perf_counter()
    shutil.rmtree(EX_DIR, ignore_errors=True)
    EX_DIR.mkdir(parents=True)
    lm_layers = get_config("qwen3-8b").reduced().n_layers
    per_step = EX_TRAIN_LAYERS * EX_TRAIN_MICROBATCHES
    expected = dict(EX_COUNTS, serve_lm={"mha": lm_layers
                                         * EX_SERVE_REQUESTS},
                    train_lm={"mha": per_step * EX_TRAIN_STEPS,
                              "mha_bwd": per_step * EX_TRAIN_STEPS})
    from unittest import mock
    from repro_torch.launch import train as train_launch
    from repro_torch.models.transformer import count_params
    step_s = []     # the train loop's own time of each step

    class StepTimes(train_launch.StragglerMonitor):
        def observe(self, step_seconds):
            step_s.append(step_seconds)
            return super().observe(step_seconds)

    total, secs, faults, train_ms = {}, {}, [], {}
    for name in EX_ALL:
        module = importlib.import_module(f"repro_torch.examples.{name}")
        argv = (["--steps", str(EX_TRAIN_STEPS), "--ckpt-dir",
                 str(EX_DIR / "ckpt")] if name == "train_lm" else [])
        buf = io.StringIO()
        dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf), mock.patch.object(
                train_launch, "StragglerMonitor", StepTimes):
            ret = module.main(argv)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        counts = dict(dispatch.launch_counts)
        add_counts(total, counts)
        out = buf.getvalue()
        (EX_DIR / f"{name}.out").write_text(out)
        say(f"examples: {name} in {secs[name]:.1f} s, launches {counts} "
            f"(expected {expected[name]})")
        if counts != expected[name]:
            faults.append(f"{name}: launches {counts} != {expected[name]}")
        if name in EX_PIM:
            diff = outputs.compare(out, outputs.expected(name))
            say(f"  {name}: {len(out.splitlines())} lines against the "
                f"reference's: {len(diff)} differences outside the rules")
            faults += [f"{name} {d}" for d in diff]
        elif name == "serve_lm":
            n_tokens = sum(len(r.output) for r in ret)
            say(f"  serve_lm: {len(ret)} requests, {n_tokens} tokens, all "
                f"done {all(r.done for r in ret)}: {out.splitlines()[0]}")
            if (len(ret), n_tokens) != (EX_SERVE_REQUESTS, EX_SERVE_TOKENS) \
                    or not all(r.done for r in ret):
                faults.append(f"serve_lm: {len(ret)} requests, {n_tokens} "
                              f"tokens")
        else:
            # the loop's step times: the step and its loss on the host,
            # no batch drawn and no checkpoint written
            n_params = count_params(get_config(module.ARCH).reduced(
                **module.WIDTH))
            train_ms = {
                "step": statistics.median(step_s[1:]) * 1e3,
                "first_step": step_s[0] * 1e3,
                "wall_a_step": secs[name] / len(ret) * 1e3,
                "gemm_bound": 6 * n_params * EX_TRAIN_TOKENS
                / PEAK_FP32_OPS_PER_S * 1e3}
            say(f"  train_lm: {EX_TRAIN_STEPS} steps, median "
                f"{train_ms['step']:.2f} ms a step after the first "
                f"({train_ms['first_step']:.1f} ms; the train loop's own "
                f"step times, checkpoints not in them), the example's wall "
                f"{train_ms['wall_a_step']:.1f} ms a step (build, "
                f"checkpoint and warm-up in it); 6 x {n_params / 1e6:.1f}M "
                f"parameters x {EX_TRAIN_TOKENS} tokens at the float32 "
                f"peak {train_ms['gemm_bound']:.2f} ms; loss "
                f"{ret[0]:.4f} -> {ret[-1]:.4f}; "
                + out.strip().splitlines()[-1])
            if not (len(ret) == EX_TRAIN_STEPS == len(step_s)
                    and np.all(np.isfinite(ret))):
                faults.append(f"train_lm: losses {ret[:3]}..., "
                              f"{len(step_s)} step times")
    shutil.rmtree(EX_DIR / "ckpt", ignore_errors=True)
    if faults:
        fail("examples: " + "; ".join(faults[:20]))
    if set(total) != EX_KERNELS:
        fail(f"examples: launched {sorted(total)}, not {sorted(EX_KERNELS)}")
    wall = time.perf_counter() - t_phase
    say(f"examples: phase 19 in {wall:.1f} s on {smi}; launches in all "
        f"{total}: every ported kernel but int_matmul")
    return {"counts": total, "secs": secs, "wall_s": wall,
            "train_ms": train_ms}


def tree_rounds(tree) -> int:
    """Frontier rounds a fit ran: one per depth level, plus the last
    round, which evaluates the deepest leaves and splits none."""
    return int(tree.depth[:tree.n_nodes].max()) + 1


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.api import get_workload, make_estimator, make_system
    from repro_torch.configs.base import get_config
    from repro_torch.core.lut import build_sigmoid_lut
    from repro_torch.core.metrics import adjusted_rand_index
    from repro_torch.data.synthetic import make_blobs, make_classification
    from repro_torch.kernels import build, dispatch
    from repro_torch.kernels.gini_split import (gini_split_cuda,
                                                gini_split_plain)
    from repro_torch.kernels.kmeans_assign import (kmeans_assign_cuda,
                                                   kmeans_assign_plain)
    from repro_torch.kernels.lut_activation import (lut_sigmoid_cuda,
                                                    lut_sigmoid_plain)
    from repro_torch.kernels.quant_matmul import (fx_matvec_cuda,
                                                  fx_matvec_plain)
    t_start = time.perf_counter()
    dev = torch.device("cuda")

    # -- 1. device -----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    say(smi)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s)")
    n_dtr, mem_avail = host_samples(DTR_SIZES, DTR_HOST_BYTES_PER_SAMPLE)
    say(f"host MemAvailable {mem_avail / 2 ** 30:.1f} GiB: DTR runs at "
        f"{n_dtr:,} samples (the paper's {DTR_SIZES[0]:,} needs "
        f"~{DTR_SIZES[0] * DTR_HOST_BYTES_PER_SAMPLE / 2 ** 30:.0f} GiB "
        f"to generate; taken when under half of MemAvailable)")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build()
    say(f"build: {len(logs)} of {len(build.SOURCES)} libraries compiled in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        kernel = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1][:90]
            elif "registers" in line or "spill" in line:
                say(f"  {name} {kernel}: {line.split(':', 1)[-1].strip()}")

    # -- 15. the dense LM on sharded parameters -----------------------------
    # first, while this process holds nothing on the card; (e), the
    # dry-run, runs beside phase 14's data set-up
    tp = tp_on_card(torch, dispatch, smi)

    # -- 16. the MoE family on sharded parameters ---------------------------
    # likewise while this process holds nothing on the card
    moe = moe_on_card(torch, dispatch, smi)

    # -- 17. the recurrent families on sharded parameters -------------------
    # likewise while this process holds nothing on the card
    ssm = ssm_on_card(torch, dispatch, smi)

    # -- 18. the VLM and audio families on sharded parameters ---------------
    # its ranks ran in phase 17's spawn; its one-process part likewise
    # while this process holds nothing on the card
    xtp = x_on_card(torch, dispatch, ssm, smi)

    # -- 13. data-parallel training over ranks sharing the card -------------
    # while this process holds nothing on the card
    dp = dp_on_card(torch, smi)

    # -- 14. PIM-ML over ranks sharing the card, on phases 4-5's data -------
    # (their fits are held against phases 4-5's one-process fits there)
    n_emb, mem_avail = host_samples(EMB_SIZES, EMB_HOST_BYTES_PER_SAMPLE)
    say(f"host MemAvailable {mem_avail / 2 ** 30:.1f} GiB: EMB runs at "
        f"{n_emb:,} ratings (the Netflix matrix's {EMB_SIZES[0]:,} need "
        f"~{EMB_SIZES[0] * EMB_HOST_BYTES_PER_SAMPLE / 2 ** 30:.0f} GiB to "
        f"generate; taken when under half of MemAvailable)")
    dry = tp_dryrun_start(TP_DIR / "dryrun")   # 15 (e), beside set-up only
    pim_sets = pim_data(n_dtr, n_emb, mem_avail)
    tp_dry = tp_dryrun_finish(dry, tp, moe, ssm, xtp, smi)
    pim = pim_on_card(torch, pim_sets, smi)

    # -- 3. kernels against their plain versions, on the card ----------------
    rng = np.random.RandomState(SEED)
    n_pc = N_SAMPLES // N_CORES
    x = torch.from_numpy(rng.randint(-(16 << 10), 16 << 10,
                                     (N_CORES, n_pc, N_FEATURES))
                         .astype(np.int32)).to(dev)
    w = torch.from_numpy(rng.randint(-(4 << 10), 4 << 10, N_FEATURES)
                         .astype(np.int32)).to(dev)

    def full_range(shape):     # int32 values whose products wrap
        return torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31 - 1, shape,
                                            dtype=np.int64)
                                .astype(np.int32)).to(dev)
    wide, wide_w = full_range((1_000_003, 13)), full_range(13)
    err_fx = 0
    for xs, ws in ((x, w), (wide, wide_w)):    # main shape; ragged, wrapping
        out, ref = fx_matvec_cuda(xs, ws, 10), fx_matvec_plain(xs, ws, 10)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            fail(f"fx_matvec kernel != plain at {tuple(xs.shape)}")
        err_fx = max(err_fx, int((out.long() - ref.long()).abs().max()))
    say(f"kernels: fx_matvec == plain at {tuple(x.shape)} and "
        f"{tuple(wide.shape)} (max abs err {err_fx})")

    lut = build_sigmoid_lut(device=dev)
    n_table = lut.table.numel()
    edges = torch.tensor(lut_edges(n_table), dtype=torch.int32)
    z = torch.from_numpy(rng.randint(-30000, 30000, (N_CORES, n_pc))
                         .astype(np.int32))
    z.view(-1)[:edges.numel()] = edges
    z = z.to(dev)
    err_lut, n_ragged = check_lut_sigmoid(torch, rng, lut, z)
    say(f"kernels: lut_sigmoid wram and mram == plain at {tuple(z.shape)} "
        f"with the edge values, and in {n_ragged} cases of ~{LUT_RAGGED} "
        f"elements 4-12 B past an alignment with ragged ends, the edge "
        f"values in the head, a vector and the tail, under tables of "
        f"{n_table} and {LUT_ODD} (max abs err {err_lut})")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    err_km, km = check_kmeans_assign(torch, dev, gen)
    err_gi, gi = check_gini_counts(torch, dev, gen, n_dtr)
    err_eg, err_es, emb = check_emb_kernels(torch, dev, make_system)
    lm_prompt_lens = sorted(len(p) for p in lm_requests(
        get_config(LM_ARCH).vocab_size))
    err_mm, err_fa = check_lm_kernels(torch, dev, gen, lm_prompt_lens)

    # -- 4. the main path at full size ---------------------------------------
    (X, y), (Xc, yc) = pim_sets.pop("lin"), pim_sets.pop("log")
    plan = ([("linreg", v) for v in LIN_VERSIONS]
            + [("logreg", v) for v in LOG_VERSIONS])
    results = {}
    for device in ("cuda", "cpu"):
        system = make_system("pim", n_cores=N_CORES, reduce="fabric",
                             device=device)
        lin_ds, log_ds = system.put(X, y), system.put(Xc, yc)
        if device == "cuda":
            dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        for workload, version in plan:
            est = make_estimator(workload, version=version, n_iters=ITERS,
                                 system=system)
            est.fit(lin_ds if workload == "linreg" else log_ds)
            results[device, version] = (est.coef_, est.intercept_)
        if device == "cuda":
            torch.cuda.synchronize()
            counts = dict(dispatch.launch_counts)
        results[device, "stats"] = system.stats.snapshot()
        say(f"main path on {device}: {len(plan)} fits x {ITERS} iterations "
            f"in {time.perf_counter() - t0:.1f} s (views included)")

    expected = {"fx_matvec": 3 * ITERS, "lut_sigmoid": 2 * ITERS}
    say(f"launch counts on the main path: {counts} (expected {expected})")
    if counts != expected:
        fail(f"kernel launch counts {counts} != {expected}")
    for workload, version in plan:
        (wg, bg), (wc, bc) = results["cuda", version], results["cpu", version]
        if not (np.all(np.isfinite(wg)) and np.isfinite(bg)
                and wg.shape == (N_FEATURES,)):
            fail(f"{workload} {version}: non-finite or misshapen weights")
        if version == "fp32":
            ok = (np.allclose(wg, wc, rtol=FP32_RTOL, atol=FP32_ATOL)
                  and np.isclose(bg, bc, rtol=FP32_RTOL, atol=FP32_ATOL))
        else:
            ok = np.array_equal(wg, wc) and bg == bc
        diff = float(max(np.abs(wg - wc).max(), abs(bg - bc)))
        say(f"  {workload:<7} {version:<15} card == cpu: {ok} "
            f"(max |dw|,|db| {diff:.3g}; w[:3] {wg[:3]}, b {bg:.6f})")
        if not ok:
            fail(f"{workload} {version}: card and CPU fits disagree")
    if results["cuda", "stats"] != results["cpu", "stats"]:
        fail("TransferStats differ between the card and the CPU run")
    say(f"TransferStats equal on card and CPU: {results['cuda', 'stats']}")

    # KME at the paper's strong-scaling size, on the card
    Xk = pim_sets.pop("kme")[0]
    kme_system = make_system("pim", n_cores=N_CORES, device="cuda")
    kme_ds = kme_system.put(Xk)
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    kme = kme_fits(make_estimator, kme_system, kme_ds)
    torch.cuda.synchronize()
    kme_counts = dict(dispatch.launch_counts)
    say(f"main path KME: int16 + fp32 fits x {ITERS} iterations in "
        f"{time.perf_counter() - t0:.1f} s (views included); launch counts "
        f"{kme_counts} (expected {{'kmeans_assign': {ITERS}}})")
    if kme_counts != {"kmeans_assign": ITERS}:
        fail(f"KME launch counts {kme_counts}")
    check_kme(kme, KME_SAMPLES)
    for version, e in kme.items():
        say(f"  kmeans {version:<5} inertia {e.inertia_:.6g}, n_iter "
            f"{e.n_iter_}, centroid[0][:3] {e.cluster_centers_[0, :3]}")
    # the int32 range of the cross-core reduce of the cluster sums: the
    # reference's fabric sum keeps int32 and wraps; hold it against int64
    view = kme_ds.kmeans_view("int16")
    init = view.host_q[np.random.RandomState(SEED).choice(
        KME_SAMPLES, KME_K, replace=False)]
    fitted = np.round(kme["int16"].cluster_centers_ / view.scale)
    for name, cq in (("initial", init), ("fitted", fitted)):
        _, sums, _ = kmeans_assign_cuda(
            view.shards, torch.from_numpy(cq.astype(np.int16)).to(dev))
        wide = torch.sum(sums, dim=0, dtype=torch.int64)
        narrow = torch.sum(sums, dim=0, dtype=torch.int32)
        n_out = int(((wide < INT32_MIN) | (wide > INT32_MAX)).sum())
        say(f"int32 range: KME cluster sums over {N_CORES} cores with the "
            f"{name} centroids: {n_out} of {wide.numel()} entries leave "
            f"int32 (max |sum| {int(wide.abs().max()):,}; the int32 "
            f"reduce wraps them: {int((narrow.long() != wide).sum())} "
            f"differ)")
    del Xk, view, sums, wide, narrow

    # DTR at the largest size the host can generate, on the card
    Xd, yd = pim_sets.pop("dtr")
    dtr_system = make_system("pim", n_cores=N_CORES, device="cuda")
    dtr_ds = dtr_system.put(Xd, yd)
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    dtr = make_estimator("dtree", max_depth=DTR_DEPTH,
                         system=dtr_system).fit(dtr_ds)
    torch.cuda.synchronize()
    dtr_counts = dict(dispatch.launch_counts)
    rounds = tree_rounds(dtr.tree_)
    say(f"main path DTR: max_depth {DTR_DEPTH}, {rounds} rounds, "
        f"{dtr.n_nodes_} nodes in {time.perf_counter() - t0:.1f} s (view "
        f"included); launch counts {dtr_counts} (expected "
        f"{{'gini_split': {rounds}}}); training accuracy on the first "
        f"1M samples {dtr.score(Xd[:1 << 20], yd[:1 << 20]):.4f}")
    if dtr_counts != {"gini_split": rounds}:
        fail(f"DTR launch counts {dtr_counts}")
    if dtr_system.stats.kernel_launches != 3 * rounds - 1:
        fail(f"DTR ran {dtr_system.stats.kernel_launches} map_* calls, "
             f"not 3 per round less the last commit")
    del Xd, yd

    # KME and DTR at the paper's quality sizes: the card against the CPU
    Xk, yk, _ = make_blobs(KME_QUALITY, N_FEATURES, centers=KME_K,
                           seed=SEED)
    Xd, yd = make_classification(DTR_QUALITY, N_FEATURES, seed=SEED,
                                 class_sep=1.4)
    quality = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        system = make_system("pim", n_cores=N_CORES, device=device)
        quality[device] = (
            kme_fits(make_estimator, system, system.put(Xk)),
            make_estimator("dtree", max_depth=DTR_DEPTH,
                           system=system).fit(Xd, yd).tree_,
            system.stats.snapshot())
        say(f"quality sizes on {device}: KME {KME_QUALITY} + DTR "
            f"{DTR_QUALITY} in {time.perf_counter() - t0:.1f} s")
    (gk, gt, gs), (ck, ct, cs) = quality["cuda"], quality["cpu"]
    check_kme(gk, KME_QUALITY)
    if not (np.array_equal(gk["int16"].cluster_centers_,
                           ck["int16"].cluster_centers_)
            and np.array_equal(gk["int16"].labels_, ck["int16"].labels_)
            and gk["int16"].n_iter_ == ck["int16"].n_iter_):
        fail("KME int16: card and CPU fits disagree")
    if not np.allclose(gk["fp32"].cluster_centers_,
                       ck["fp32"].cluster_centers_, rtol=KME_FP32_RTOL,
                       atol=KME_FP32_ATOL):
        fail("KME fp32: card and CPU centroids disagree")
    flips = int((gk["fp32"].labels_ != ck["fp32"].labels_).sum())
    dc = float(np.abs(gk["fp32"].cluster_centers_
                      - ck["fp32"].cluster_centers_).max())
    say(f"  KME int16 card == cpu (centroids, labels, n_iter {ITERS}); "
        f"fp32 max |dC| {dc:.3g}, {flips} labels differ; ARI vs the blobs' "
        f"truth: int16 {adjusted_rand_index(gk['int16'].labels_, yk):.4f}, "
        f"fp32 {adjusted_rand_index(gk['fp32'].labels_, yk):.4f}")
    fields = ("feature", "threshold", "left", "right", "leaf_class", "depth")
    if not (all(np.array_equal(getattr(gt, f), getattr(ct, f))
                for f in fields) and gt.n_nodes == ct.n_nodes):
        fail("DTR: card and CPU trees differ")
    say(f"  DTR tree card == cpu ({gt.n_nodes} nodes, {tree_rounds(gt)} "
        f"rounds; training accuracy {np.mean(gt.predict(Xd) == yd):.4f})")
    if gs != cs:
        fail("KME/DTR TransferStats differ between the card and the CPU")
    say(f"TransferStats equal on card and CPU: {gs}")

    # EMB at the Netflix matrix's size, on the card; then card == CPU
    emb_counts, emb_profile, emb_fused_profile, emb_serial = \
        emb_fits_on_card(torch, make_system, get_workload, dispatch, smi,
                         *pim_sets.pop("emb"))
    emb_card_equals_cpu(make_system, make_estimator)

    # qwen3-8b served at full width through Model and ServeEngine; then
    # the reduced model on the card against the CPU
    lm = lm_serve_on_card(torch, dispatch, smi)
    lm_card_equals_cpu(torch)

    # -- 5. timing -----------------------------------------------------------
    flush = L2Flush(torch)
    # the method's floor: no kernel reads below a one-element add_
    tiny = torch.zeros(1, dtype=torch.int32, device="cuda")
    say(f"timing: the method's floor, a one-element add_, "
        f"{cuda_ms(torch, lambda: tiny.add_(1), flush):.4f} ms on {smi}")
    fx = dict(ms=cuda_ms(torch, lambda: fx_matvec_cuda(x, w, 10), flush),
              plain_ms=cuda_ms(torch, lambda: fx_matvec_plain(x, w, 10),
                               flush))
    fx["bound_ms"], fx["bound_by"] = declared_bound("fx_matvec", x, w, 10)
    say(f"timing: fx_matvec {fx['ms']:.4f} ms, plain {fx['plain_ms']:.4f} "
        f"ms, bound {fx['bound_ms']:.4f} ms ({fx['bound_by']}; H100 SXM "
        f"peaks {PEAK_BYTES_PER_S:.3g} B/s, {PEAK_INT32_OPS_PER_S:.3g} "
        f"int32 op/s) on {smi}")
    # lut_sigmoid at the main shape, and on the z that the LOG fit itself
    # hands it (the system and datasets stay for the fits below)
    system = make_system("pim", n_cores=N_CORES, device="cuda")
    lin_ds, log_ds = system.put(X, y), system.put(Xc, yc)
    fit_z = log_fit_z(dispatch, make_estimator, log_ds)
    lu = dict(ms=cuda_ms(torch, lambda: lut_sigmoid_cuda(z, lut, "wram"),
                         flush),
              mram_ms=cuda_ms(torch, lambda: lut_sigmoid_cuda(
                  z, lut, "mram"), flush),
              plain_ms=cuda_ms(torch, lambda: lut_sigmoid_plain(z, lut),
                               flush))
    lu["bound_ms"], lu["bound_by"] = declared_bound("lut_sigmoid", z, lut)
    lu["fit_z_ms"] = {f"{it}_{placement}": cuda_ms(
        torch, lambda: lut_sigmoid_cuda(zi, lut, placement), flush)
        for it, zi in fit_z.items() for placement in ("wram", "mram")}
    fz = lu["fit_z_ms"]
    at_end = {name: float((zi.abs() >= n_table - 1).float().mean())
              for name, zi in (("main", z), ("last", fit_z["last"]))}
    say(f"timing: lut_sigmoid at {tuple(z.shape)} wram {lu['ms']:.4f} ms "
        f"({100 * lu['bound_ms'] / lu['ms']:.1f}% of the bound), mram "
        f"{lu['mram_ms']:.4f} ms "
        f"({100 * lu['bound_ms'] / lu['mram_ms']:.1f}%); "
        f"{100 * at_end['main']:.1f}% of z at the table's end; on the LOG "
        f"fit's own z, iteration 1 (all zero: "
        f"{not bool(fit_z['first'].any())}) wram {fz['first_wram']:.4f} / "
        f"mram {fz['first_mram']:.4f} ms, iteration {ITERS} (max |z| "
        f"{int(fit_z['last'].abs().max())}, {100 * at_end['last']:.2f}% "
        f"at the table's end) wram {fz['last_wram']:.4f} / mram "
        f"{fz['last_mram']:.4f} ms; plain {lu['plain_ms']:.4f} ms, bound "
        f"{lu['bound_ms']:.4f} ms ({lu['bound_by']}; H100 SXM peaks "
        f"{PEAK_BYTES_PER_S:.3g} B/s, {PEAK_INT32_OPS_PER_S:.3g} int32 "
        f"op/s) on {smi}")
    del fit_z

    kx, kc = km["x"], km["c"]
    n_km = kx.shape[0] * kx.shape[1]
    kt = dict(ms=cuda_ms(torch, lambda: kmeans_assign_cuda(kx, kc), flush),
              plain_ms=cuda_ms(torch, lambda: kmeans_assign_plain(kx, kc),
                               flush))
    # the products run on the tensor cores as four int8 products (the
    # byte split); on the CUDA cores they were 2 n K F int32 operations
    km_bytes = dispatch.declared_cost("kmeans_assign", kx, kc).bytes
    kt["bound_ms"], kt["bound_by"] = declared_bound("kmeans_assign", kx, kc)
    cuda_core_bound_ms = bound(km_bytes, 2 * n_km * KME_K * N_FEATURES)[0]
    n_leaves = gi["th"].shape[0]
    g_args = (gi["x"], gi["y"], gi["spread"], gi["th"], 2)
    g_root = (gi["x"], gi["y"], gi["root"], gi["th"], 2)
    g_front = (gi["x"], gi["y"], gi["frontier"], gi["th"], 2)
    gt = dict(ms=cuda_ms(torch, lambda: gini_split_cuda(*g_args), flush),
              root_ms=cuda_ms(torch, lambda: gini_split_cuda(*g_root),
                              flush),
              frontier_ms=cuda_ms(torch, lambda: gini_split_cuda(*g_front),
                                  flush),
              few_cores_ms=cuda_ms(torch, lambda: gini_split_cuda(
                  *gi["few_cores"](gi["spread"])), flush),
              few_cores_root_ms=cuda_ms(torch, lambda: gini_split_cuda(
                  *gi["few_cores"](gi["root"])), flush),
              plain_ms=cuda_ms(torch, lambda: gini_split_plain(*g_args),
                               flush))
    gt["bound_ms"], gt["bound_by"] = declared_bound("gini_split", *g_args)
    say(f"timing: kmeans_assign {kt['ms']:.4f} ms, plain "
        f"{kt['plain_ms']:.4f} ms, bound {kt['bound_ms']:.4f} ms "
        f"({kt['bound_by']}: {km_bytes:.4g} B at {PEAK_BYTES_PER_S:.3g} "
        f"B/s; four int8 products, {8 * n_km * KME_K * N_FEATURES:.4g} ops "
        f"at {PEAK_INT8_OPS_PER_S:.4g}/s; on the CUDA cores "
        f"{2 * n_km * KME_K * N_FEATURES:.4g} int32 ops at "
        f"{PEAK_INT32_OPS_PER_S:.3g}/s bound {cuda_core_bound_ms:.4f} "
        f"ms) at {tuple(kx.shape)} K={KME_K} on {smi}")
    say(f"timing: gini_counts {gt['ms']:.4f} ms (leaves spread over 2^10), "
        f"{gt['root_ms']:.4f} ms (all at the root), "
        f"{gt['frontier_ms']:.4f} ms (ids 1023-2046); the same rows over "
        f"{FEW_CORES} cores {gt['few_cores_ms']:.4f} ms spread, "
        f"{gt['few_cores_root_ms']:.4f} ms at the root; plain "
        f"{gt['plain_ms']:.4f} ms, bound {gt['bound_ms']:.4f} ms "
        f"({gt['bound_by']}) at {tuple(gi['x'].shape)} L={n_leaves} "
        f"on {smi}")
    et = emb_kernel_times(torch, emb, flush)
    for name in ("emb_gather", "emb_scatter_add"):
        t = et[name]
        for pre, table in (("", "users"), ("items_", "items")):
            shape = tuple(emb[table, "int32"]["table"].shape)
            say(f"timing: {name} {table} {shape} {t[pre + 'ms']:.4f} ms "
                f"int32, {t[pre + 'fp32_ms']:.4f} ms fp32"
                + (f", padded D={EMB_FLUSH} flush "
                   f"{t[pre + 'flush_ms']:.4f} ms" if "flush_ms" in t
                   else "")
                + f"; bound {t[pre + 'bound_ms']:.4f} ms "
                f"({t[pre + 'bound_by']}"
                + (f"; PR 13-15 counted every id and compare: "
                   f"{t[pre + 'old_bound_ms']:.4f} ms"
                   if "old_bound_ms" in t else "")
                + f"); {t['library_call']} {t[pre + 'library_ms']:.4f} ms "
                f"(it needs a slot map the kernel does not receive), "
                f"B={EMB_BATCH}, on {smi}")
        say(f"timing: {name} plain {t['plain_ms']:.4f} ms (users, int32)")

    lt = lm_kernel_times(torch, flush, lm_prompt_lens)
    for (name, *shape), t in lt.items():
        lib = ("none" if t["library_ms"] is None
               else f"{t['library_ms']:.4f} ms")
        rate = (f"{t['tops']:.1f} TOP/s" if shape
                else f"{t['tflops']:.1f} TFLOP/s")
        say(f"timing: {name} {t['ms']:.4f} ms ({rate}, "
            f"{100 * t['bound_share']:.1f}% of the bound), plain "
            f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}), "
            + (f"torch._int_mm {lib} at (M, K, N) {tuple(shape)}"
               if shape else f"F.scaled_dot_product_attention {lib} at "
               f"bf16 [1, 32, {lm_prompt_lens[-1]}, 128] over 16 KV "
               f"heads, causal")
            + f"; host {t['host_us']:.1f} us per wrapper call"
            f" on {smi}")
    del flush, km, gi

    one_s = {}       # seconds an iteration of the fits phase 14 repeats
    for workload, version in plan:
        ds = lin_ds if workload == "linreg" else log_ds
        make_estimator(workload, version=version, n_iters=1,
                       system=system).fit(ds)      # views and LUT resident
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        make_estimator(workload, version=version, n_iters=ITERS,
                       system=system).fit(ds)
        torch.cuda.synchronize()
        dt = one_s[workload, version] = (time.perf_counter() - t0) / ITERS
        say(f"fit: {workload:<7} {version:<15} {dt * 1e3:.3f} ms/iteration, "
            f"{N_SAMPLES / dt:.4g} samples/s ({N_CORES} cores, on {smi})")
    kme_wl, dtr_wl = get_workload("kmeans"), get_workload("dtree")
    kme_params = dict(n_clusters=KME_K, max_iter=ITERS, tol=0.0)
    for version in ("int16", "fp32"):          # views resident since phase 4
        steps, _ = step_times(kme_wl.fit_steps(
            kme_ds, kme_wl.spec(version, **kme_params)))
        dt = one_s["kmeans", version] = statistics.median(steps[1:ITERS])
        say(f"fit: kmeans  {version:<15} {dt * 1e3:.3f} ms/iteration "
            f"(median of iterations 2-{ITERS}), {KME_SAMPLES / dt:.4g} "
            f"samples/s; the first step with the init draw "
            f"{steps[0] * 1e3:.1f} ms, the end-of-fit inertia and labels "
            f"passes {steps[-1] * 1e3:.1f} ms ({N_CORES} cores, on {smi})")
    g_rounds, (steps, _) = gini_round_times(
        torch, dispatch, lambda: step_times(dtr_wl.fit_steps(
            dtr_ds, dtr_wl.spec(max_depth=DTR_DEPTH))))
    dt = one_s["dtree", None] = sum(steps) / len(steps)
    say(f"fit: dtree   max_depth {DTR_DEPTH:<5} {dt * 1e3:.3f} ms/round "
        f"(mean of {len(steps)}), {n_dtr / dt:.4g} samples/s per round; "
        f"rounds {' '.join(f'{t * 1e3:.1f}' for t in steps)} ms "
        f"({N_CORES} cores, {n_dtr:,} samples, on {smi})")
    gt["fit_round_ms"] = g_rounds
    say(f"fit: dtree   gini_counts per round "
        f"{' '.join(f'{t:.4f}' for t in g_rounds)} ms, "
        f"{sum(g_rounds):.3f} ms over its {len(g_rounds)} launches (CUDA "
        f"events inside the fit, L2 as the fit leaves it; on {smi})")
    for name, fit in (
            ("KME int16 fit", lambda: kme_wl.fit(
                kme_ds, kme_wl.spec("int16", **kme_params))),
            ("DTR fit", lambda: dtr_wl.fit(
                dtr_ds, dtr_wl.spec(max_depth=DTR_DEPTH)))):
        say(f"profile: {name}: " + device_profile(torch, fit))
    say(f"profile: EMB int32 eager, 50 steps at the Netflix size: "
        f"{emb_profile}")

    # -- 14, checked: the fits over ranks against the one-process ones -------
    def gd(version):
        w, b = results["cuda", version]
        return SimpleNamespace(w=w, b=b)
    emb_model, one_s["emb", "int32"] = emb_serial["int32 deferred D=8"]
    check_pim_ranks(pim, {
        "linreg": (model_summary("linreg", gd("int32")),
                   one_s["linreg", "int32"]),
        "logreg": (model_summary("logreg", gd("int32_lut_wram")),
                   one_s["logreg", "int32_lut_wram"]),
        "kmeans": (model_summary("kmeans", kme["int16"].result_.model),
                   one_s["kmeans", "int16"]),
        "dtree": (model_summary("dtree", dtr.tree_), one_s["dtree", None]),
        "emb": (model_summary("emb", emb_model), one_s["emb", "int32"])},
        smi)

    # -- 6. step fusion: each fused chunk one CUDA graph replay --------------
    fused_gd_fits(torch, dispatch, make_estimator, system, lin_ds, log_ds,
                  smi)
    kme_fused_profile = fused_kme(torch, dispatch, make_system,
                                  get_workload, kme_ds, kme["int16"], Xk,
                                  smi)
    say(f"profile: KME int16 fused (fuse_steps {KME_FUSE}): "
        f"{kme_fused_profile}")
    say(f"profile: EMB int32 D={EMB_FLUSH} fused (fuse_steps {EMB_FUSE}), "
        f"{EMB_ITERS} steps at the Netflix size: {emb_fused_profile}")

    # -- 7. the paper's three-way compare on the card ------------------------
    t0 = time.perf_counter()
    compare_counts = compare_on_card(torch, dispatch, smi)
    say(f"compare: phase 7 in {time.perf_counter() - t0:.1f} s on {smi}")

    # -- 8. orchestration: lanes, the fused gang, slices, elastic, trace ----
    t0 = time.perf_counter()
    flush = L2Flush(torch)
    lanes = lane_kernel_on_card(torch, dispatch, rng, flush, smi)
    del flush
    lanes.update(gang_on_card(torch, dispatch, make_estimator, get_workload,
                              system, lin_ds, log_ds, smi))
    slices_on_card(torch, make_system, make_estimator, X, y, Xc, yc, smi)
    elastic_on_card(torch, dispatch, get_workload, system, lin_ds, kme_ds,
                    results["cuda", "int32"], kme["int16"], smi)
    say(f"orchestration: phase 8 in {time.perf_counter() - t0:.1f} s on "
        f"{smi}")

    # -- 9. the training service: scheduler, serve loop, CLI ----------------
    t0 = time.perf_counter()
    service = service_on_card(
        torch, dispatch, make_system, get_workload,
        {"lin": (X, y), "log": (Xc, yc), "kme": kme_ds.X}, smi)
    say(f"service: phase 9 in {time.perf_counter() - t0:.1f} s on {smi}")

    # -- 10. LM training at full width ---------------------------------------
    lm_train = lm_train_on_card(torch, dispatch, smi)
    bt = lm_train["bwd"]

    # -- 11. the decoder-only families at full width -------------------------
    fam = lm_families_on_card(torch, dispatch, smi)

    # -- 12. the VLM and audio families at full width ------------------------
    xfam = vlm_audio_on_card(torch, dispatch, smi)
    fam_launches = dict(fam["counts"])
    add_counts(fam_launches, xfam["counts"])

    # -- 19. the examples' counterparts, whole ------------------------------
    ex = examples_on_card(torch, dispatch, smi)

    kernels = [
        {"name": "fx_matvec", "route": "cuda",
         "source": "src/repro_torch/csrc/fx_matvec.cu",
         "replaces": "src/repro/kernels/quant_matmul/kernel.py:82",
         "launches": counts["fx_matvec"], "max_abs_err": err_fx,
         "ms": fx["ms"], "plain_ms": fx["plain_ms"],
         "bound_ms": fx["bound_ms"], "bound_by": fx["bound_by"],
         "library_ms": None, "lanes": lanes},
        {"name": "lut_sigmoid", "route": "cuda",
         "source": "src/repro_torch/csrc/lut_sigmoid.cu",
         "replaces": "src/repro/kernels/lut_activation/kernel.py:37",
         "launches": counts["lut_sigmoid"], "max_abs_err": err_lut,
         "ms": lu["ms"], "mram_ms": lu["mram_ms"],
         "fit_z_ms": lu["fit_z_ms"], "plain_ms": lu["plain_ms"], "bound_ms": lu["bound_ms"],
         "bound_by": lu["bound_by"], "library_ms": None},
        {"name": "kmeans_assign", "route": "cuda",
         "source": "src/repro_torch/csrc/kmeans_assign.cu",
         "replaces": "src/repro/kernels/kmeans_assign/kernel.py:51",
         "launches": kme_counts["kmeans_assign"], "max_abs_err": err_km,
         "ms": kt["ms"], "plain_ms": kt["plain_ms"],
         "bound_ms": kt["bound_ms"], "bound_by": kt["bound_by"],
         "library_ms": None},
        {"name": "gini_counts", "route": "cuda",
         "source": "src/repro_torch/csrc/gini_counts.cu",
         "replaces": "src/repro/kernels/gini_split/kernel.py:58",
         "launches": dtr_counts["gini_split"], "max_abs_err": err_gi,
         "ms": gt["ms"], "root_ms": gt["root_ms"],
         "frontier_ms": gt["frontier_ms"],
         "few_cores_ms": gt["few_cores_ms"],
         "few_cores_root_ms": gt["few_cores_root_ms"],
         "fit_round_ms": gt["fit_round_ms"],
         "plain_ms": gt["plain_ms"], "bound_ms": gt["bound_ms"],
         "bound_by": gt["bound_by"], "library_ms": None},
        {"name": "emb_gather", "route": "cuda",
         "source": "src/repro_torch/csrc/emb_gather.cu",
         "replaces": "src/repro/kernels/sparse_gather/kernel.py:48",
         "launches": emb_counts["emb_gather"], "max_abs_err": err_eg,
         **et["emb_gather"]},
        {"name": "emb_scatter_add", "route": "cuda",
         "source": "src/repro_torch/csrc/emb_scatter_add.cu",
         "replaces": "src/repro/kernels/sparse_gather/kernel.py:81",
         "launches": emb_counts["emb_scatter_add"], "max_abs_err": err_es,
         **et["emb_scatter_add"]},
        {"name": "int_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/int_matmul.cu",
         "replaces": "src/repro/kernels/quant_matmul/kernel.py:43",
         "launches": lm["counts"]["int_matmul"],
         "max_abs_err": max(err_mm, fam["err_mm"], xfam["err_mm"]),
         "train_launches": lm_train["quant_counts"]["int_matmul"],
         "families_launches": fam_launches.get("int_matmul", 0),
         "families_max_abs_err": max(fam["err_mm"], xfam["err_mm"]),
         "train": lm_train["int_matmul"],
         "shape": [lm_prompt_lens[-1], *LM_MLP_SHAPES[0]],
         **lt["int_matmul", lm_prompt_lens[-1], *LM_MLP_SHAPES[0]],
         "decode": {f"{k}x{n}": lt["int_matmul", 1, k, n]
                    for k, n in LM_MLP_SHAPES},
         "prefill_down": lt["int_matmul", lm_prompt_lens[-1],
                            *LM_MLP_SHAPES[1]],
         "prefill_shortest": {f"{lm_prompt_lens[0]}x{k}x{n}":
                              lt["int_matmul", lm_prompt_lens[0], k, n]
                              for k, n in LM_MLP_SHAPES}},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:81",
         "launches": lm["counts"]["mha"],
         "max_abs_err": max(err_fa, fam["err_fa"], xfam["err_fa"]),
         "train_launches": lm_train["counts"]["mha"],
         "dp_launches_a_rank": dp["counts"]["mha"],
         "families_launches": fam_launches["mha"],
         "families_max_abs_err": max(fam["err_fa"], xfam["err_fa"]),
         "cross": xfam["times"],
         "shape": [1, 32, lm_prompt_lens[-1], 128], **lt["flash_attention",],
         "train": {"shape": [TRAIN_BATCH, 32, TRAIN_SEQ, 128],
                   "kv_heads": 16, "with_lse": True, **bt["fwd"]}},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
         "replaces": None,
         "note": "no Pallas backward exists: the reference differentiates "
                 "its XLA attention (src/repro/models/attention.py:151-186)"
                 " with jax.grad",
         "launches": lm_train["counts"]["mha_bwd"],
         "dp_launches_a_rank": dp["counts"]["mha_bwd"],
         "families_launches": fam_launches["mha_bwd"],
         "max_abs_err": max(lm_train["bwd_abs_err"], xfam["err_bwd"]),
         "max_rel_err": lm_train["bwd_err"],
         "shape": [TRAIN_BATCH, 32, TRAIN_SEQ, 128], "kv_heads": 16,
         "design": "bf16 wgmma, TMA rings",
         "ms": bt["ms"], "plain_ms": bt["plain_ms"],
         "bound_ms": bt["bound_ms"], "bound_by": bt["bound_by"],
         "library_ms": bt["library_ms"],
         "library": "F.scaled_dot_product_attention forward + backward",
         "fwd_bwd_ms": bt["fwd_bwd_ms"]},
    ]
    tp0, tpk = tp["ranks"][0], tp_kernel_errs(tp)
    for k in kernels:       # phase 15's launches on rank 0, checks' errors
        if k["name"] == "int_matmul":
            k["tp_launches_a_rank"] = tp0["serve", True]["counts"]["int_matmul"]
            k["tp_max_abs_err"] = tpk["errs"]["int_matmul"]
        elif k["name"] == "flash_attention":
            k["tp_launches_a_rank"] = (tp0["serve", True]["counts"]["mha"]
                                       + tp0["serve", False]["counts"]["mha"]
                                       + tp0["train"]["counts"]["mha"])
            k["tp_max_abs_err"] = tpk["errs"]["mha abs"]
            k["tp_max_rel_err"] = tpk["errs"]["mha"]
            k["tp_lse_max_abs_err"] = tpk["errs"]["mha lse"]
        elif k["name"] == "flash_attention_bwd":
            k["tp_launches_a_rank"] = tp0["train"]["counts"]["mha_bwd"]
            k["tp_max_abs_err"] = tpk["errs"]["mha_bwd abs"]
            k["tp_max_rel_err"] = tpk["errs"]["mha_bwd"]
    mk = moe_kernel_errs(moe)    # phase 16's launches a rank, errors
    for k in kernels:
        op = {"flash_attention": "mha", "flash_attention_bwd": "mha_bwd"}.get(
            k["name"], k["name"])
        if op in mk["counts"]:
            k["moe_launches_a_rank"] = mk["counts"][op]
            k["moe_max_abs_err"] = mk["errs"].get(
                f"{op} abs", mk["errs"].get(op))
            if op != "int_matmul":
                k["moe_max_rel_err"] = mk["errs"][op]
    sk = ssm_kernel_errs(ssm)    # phase 17's launches on rank 0, errors
    for k in kernels:
        op = {"flash_attention": "mha", "flash_attention_bwd": "mha_bwd"}.get(
            k["name"], k["name"])
        if op in sk["counts"]:
            k["ssm_launches_a_rank"] = sk["counts"][op]
            k["ssm_max_abs_err"] = sk["errs"].get(f"{op} abs",
                                                  sk["errs"].get(op))
            if op != "int_matmul":
                k["ssm_max_rel_err"] = sk["errs"][op]
    xk = x_kernel_errs(xtp)    # phase 18's launches on rank 0, errors
    for k in kernels:
        op = {"flash_attention": "mha", "flash_attention_bwd": "mha_bwd"}.get(
            k["name"], k["name"])
        if op in xk["counts"]:
            k["x_launches_a_rank"] = xk["counts"][op]
            k["x_max_abs_err"] = xk["errs"].get(f"{op} abs",
                                                xk["errs"].get(op))
            if op != "int_matmul":
                k["x_max_rel_err"] = xk["errs"][op]
    for k in kernels:        # phase 19's launches, all examples together
        op = {"flash_attention": "mha", "flash_attention_bwd": "mha_bwd",
              "gini_counts": "gini_split"}.get(k["name"], k["name"])
        k["examples_launches"] = ex["counts"].get(op, 0)
    ranked = {}     # phase 14's launches on rank 0, and its checks' errors
    for rec in pim["ranks"][0]["fits"].values():
        add_counts(ranked, rec["counts"])
    ranked_err = {}
    for r in pim["ranks"]:
        for name, check in r["kernels"].items():
            name = name.split()[0]
            ranked_err[name] = max(ranked_err.get(name, 0), check["err"])
    for k in kernels:
        op = "gini_split" if k["name"] == "gini_counts" else k["name"]
        if op in ranked:
            k["ranks_launches_a_rank"] = ranked[op]
            k["ranks_max_abs_err"] = ranked_err[k["name"]]
        if op in COMPARE_KERNELS:
            k["compare_launches"] = compare_counts[op]
        if op in service["drain"]:
            k["service_launches"] = service["drain"][op]
            k["serve_launches"] = service["serve"].get(op, 0)
    say("serve: " + json.dumps({
        name: {k: lm[name][k] for k in ("tokens_per_s", "ttft_ms",
                                        "prefill_ms", "decode_ms", "wall_s")}
        for name in ("on", "off")}))
    say("train: " + json.dumps({k: lm_train[k] for k in (
        "losses", "step_ms", "fwd_bwd_ms", "update_ms", "tokens_per_s",
        "peak_bytes")}))
    say("families: " + json.dumps({
        f"{arch} {mode}": {k: fam[arch][mode][k] for k in (
            "tokens_per_s", "ttft_ms", "decode_ms", "wall_s", "peak_bytes")}
        for arch, modes in ((FAM_MOE, ("on", "off")),
                            (FAM_HYMBA, ("on", "off")),
                            (FAM_XLSTM, ("serve",)))
        for mode in modes} | {FAM_DBRX: {k: fam[FAM_DBRX][k] for k in (
            "ttft_ms", "decode_ms", "peak_bytes")}}))
    say("vlm/audio: " + json.dumps({
        f"{arch} {mode}": {k: xfam[arch][mode][k] for k in (
            "tokens_per_s", "ttft_ms", "decode_ms", "wall_s", "peak_bytes")}
        for arch in (X_VLM, X_AUDIO) for mode in ("off", "on")}
        | {f"{X_AUDIO} train": {k: xfam["train"][k] for k in (
            "losses", "step_ms", "wall_s", "peak_bytes")}}))
    say("pim over ranks: " + json.dumps({name: {
        k: pim["ranks"][0]["fits"][name][k] for k in (
            "s", "reduce_s", "reduce_share", "traffic", "counts")}
        for name in PIM_FITS}))
    say("dp: " + json.dumps({mode: {k: dp[mode][k] for k in (
        "losses", "step_ms", "reduce_ms", "tokens_per_s", "payload_bytes",
        "staged_bytes", "saved_model", "peak_bytes")}
        for mode in ("exact", "compressed")}))
    say("tp: " + json.dumps({
        **{f"serve {'on' if q else 'off'}": {
            k: tp0["serve", q][k] for k in ("prefill_ms", "decode_ms")}
           for q in (True, False)},
        "coll_share": tp0["serve", False]["coll_share"],
        "train_step_ms": tp0["train"]["step_ms"],
        "dry_cells": tp_dry["cells"], "wall_s": tp["wall_s"]}))
    r0 = moe["ranks"][0]
    say("moe: " + json.dumps({
        **{f"serve {'on' if q else 'off'}": {
            k: r0["serve", q][k] for k in ("prefill_ms", "decode_ms")}
           for q in (True, False)},
        "coll_share": r0["serve", False]["coll_share"],
        "train_step_ms": r0["train"]["step_ms"],
        "dbrx": {k: moe["dbrx"][0]["serve"][k] for k in (
            "prefill_ms", "decode_ms", "traffic")},
        "wall_s": moe["wall_s"]}))
    s0 = ssm["ranks"][0]
    say("ssm: " + json.dumps({
        **{f"{arch} serve {'on' if q else 'off'}": {
            k: s0[arch, "serve", q][k] for k in ("prefill_ms", "decode_ms")}
           for arch, quants in SSM_ARCHS for q in quants},
        **{f"{arch} coll_share": s0[arch, "serve", False]["coll_share"]
           for arch, _ in SSM_ARCHS},
        **{f"{arch} train_step_ms": s0[arch, "train"]["step_ms"]
           for arch, _ in SSM_ARCHS},
        "wall_s": ssm["wall_s"]}))
    x0 = xtp["ranks"][0]
    say("xtp: " + json.dumps({
        **{f"{arch} serve {'on' if q else 'off'}": {
            k: x0[arch, "serve", q][k] for k in ("prefill_ms", "decode_ms")}
           for arch in (X_VLM, X_AUDIO) for q in (True, False)},
        **{f"{arch} coll_share": x0[arch, "serve", False]["coll_share"]
           for arch in (X_VLM, X_AUDIO)},
        **{f"{arch} train_step_ms": x0[arch, "train"]["step_ms"]
           for arch in (X_VLM, X_AUDIO)},
        "wall_s": xtp["wall_s"]}))
    say("examples: " + json.dumps({"secs": ex["secs"], "wall_s": ex["wall_s"],
                                   "train_lm_ms": ex["train_ms"]}))
    say(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
