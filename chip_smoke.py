#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing JSON lines; any failure raises and the script
exits non-zero:

1. device    - the card (nvidia-smi name and power limit), torch and CUDA.
2. build     - compiles every CUDA source of the port from this checkout
               (nvcc, one library per source, all started together), fails
               on a register spill in the nine wgmma sources (registers
               and spills of the float16 forward and backward printed per
               instantiation), and holds the
               wgmma/TMA self-check (a 64 x 64 x D product through each
               descriptor form, in bf16, in float16 and through the float32
               forward's three-term products, at D = 64, 128 and 256)
               against a float64 product.
3. kernels   - calls each kernel's wrapper on the card at the shapes the
               serving and training paths give it, and holds the result
               against its plain PyTorch version on the same inputs (stated
               tolerance): the forward kernels (wgmma_f32 for float32 with
               its bf16-term split pre-pass, which must equal its plain
               version bit for bit; wgmma for bf16; at D = 64, 128 and 256;
               each case checked for its route and replayed bit for bit;
               the FMA forward timed beside the tensor-core ones at
               D = 256, also at the D = 256 step's [2,8,1024,256] and at
               the D = 256 prefill's [1,8,2048,256]; float16 on the
               wgmma_f16 route at [2,16,1024,128], [1,32,4096,128],
               [2,16,1024,64], [1,8,1024,256], the float16 D = 256
               step's [2,8,1024,256], with a bias at Lq 384 /
               Lk 640 and ragged at L = 1500, held to the float32
               tolerance plus one float16 ulp, with the float16 wgmma_f32
               forward it replaced, on no route, checked and timed beside
               it with its split at the two training shapes), the
               dQ and dK/dV
               backward kernels (wgmma for bf16, wgmma_f32 for float32 and
               wgmma_f16 for float16, each at D = 64, 128 and 256; float16
               at D = 256 also at [2,16,1024,256], ragged, with a bias at
               Lq 384 / Lk 640, at the float16 D = 256 step's attention
               and with dO at a loss scale of 2^13, where dP passes
               65504, with the longest CTA's floor beside the time; each
               case checked for the
               route of each kernel; dS as the bias gradient, also causal
               with zeros above the diagonal; every kernel replayed bit
               for bit; the whole backward wrapper, with Delta and the
               split pre-pass, timed beside SDPA's; the FMA dQ and dK/dV,
               on no route, timed beside the tensor-core ones at
               [2,16,1024,128] and [2,16,1024,64] float32, at
               [1,8,1024,256] and the float32 D = 256 run's [2,8,1024,256]
               float32 (at these four also held to the float32
               tolerance), and at [1,8,1024,256], [2,16,1024,256] and the
               D = 256 step's [2,8,1024,256] bf16; the float16 wgmma_f32
               pair, on no route since the wgmma_f16 kernels took its
               place, checked and timed beside them at the float16 GPT
               step's [2,16,1024,128], Llama's [1,32,4096,128],
               [1,8,1024,256] and [2,16,1024,256]), and dropout (the
               CUDA Philox mask against the plain one bit for bit, its keep
               rate, replay of a fixed seed, and forward and backward at
               p = 0.1 given the same mask, also at bf16 D = 256 at its
               three shapes, at float32 D = 256 and at float16 on the
               wgmma_f16 forward and backward). Times the
               kernel and one PyTorch library call computing the same
               function (a yardstick the port never calls) in turns, as the
               median and range of 6 loops of 20 calls each, the plain
               version once, beside the least time the card could take.
4. serving   - a gpt_1p3b model (full width, random weights from a seed)
               behind InferenceServer(slots=4, max_length=2048) serves six
               requests; every stream must equal a solo generate() with the
               same arguments, no request may be requeued or failed, the
               wgmma_f32 flash forward and its split (float32 prefill) must
               launch exactly once per layer per prefill over the served
               run, no other forward at all, and the
               kernel-path prefill logits must agree with the
               plain-attention path.
5. serving_options - the same model and server geometry with the
               serving options. (a) A 512 MiB prefix pool (16-token
               blocks): six requests sharing a 1024-token prefix (one
               seeded-sampled) and one unrelated, served one at a time:
               the first sharer is cold, every later sharer hits 1024
               tokens, every stream equals the pool-less path's (a solo
               generate()), and pooled admits launch no flash forward and
               no split (they run the chunked continuation through
               cached_attention); cold and hit TTFT printed. (b) The int8
               cache: bytes per slot equal to the arithmetic (384 MiB
               bf16, 198 MiB int8 at 2048 positions), prefill logits
               bit-identical to the bf16 cache's, teacher-forced logit
               drift over 16 steps under the reference's 5 %, a pool-less
               int8 server whose streams equal solo generate(kv_dtype=
               "int8") with one wgmma_f32 forward and split per layer per
               prefill, and (a) again on the int8 cache and pool, each
               stream held to the same request served alone by a fresh
               pooled server (a pooled admit reads the dequantized
               cache, a pool-less prefill the un-quantized block, as in
               the reference), its agreement with the pool-less path
               printed. (c)
               warmup(), then two tenants under fair queueing with token
               buckets (one sending 10x the other's requests, its last
               ones rate-limited) submitted before the worker takes any:
               the admission order equals the port's scheduler on the CPU
               for the same submits and take budgets (deficit round robin,
               the reference's), the quiet tenant is served in the first
               round, a request predicted to miss its deadline is shed at
               the door, and rate limits and sheds are counted, not
               failed.
6. speculative - SpeculativeEngine(gpt_1p3b target, a 1-layer
               build_draft_model draft, k=4) on prompts of 300 and 900
               tokens, 64 new tokens, with the bf16 and the int8 cache:
               greedy output token-identical to solo greedy generate(), a
               fixed seed replaying its tokens and acceptance trace,
               exactly 25 wgmma_f32 forwards and splits per generate (the
               target and draft prefills; the draft chain and the
               [1, 5] verify run cached_attention); tokens per round,
               acceptance rate (random weights: plumbing, not quality) and
               ms per token against solo decode printed.
7. serve_preset - tools/decode_bench.py's serving preset (h1024, 24
               layers, 16 heads of 64, 1024 positions, float32
               parameters) behind InferenceServer(slots=8,
               max_length=1024, kv_dtype="int8"), without and with a
               256 MiB prefix pool, on serve_bench's prefix-heavy trace
               shape (16 requests, 90 % opening with one 512-token
               prefix, 16-128-token suffixes, 16 new tokens): every
               request completes, the pool-less run launches exactly 24
               wgmma_f32 D = 64 forwards and splits per prefill and the
               pooled run none, and every stream equals the same request
               served alone by a fresh server of the same configuration;
               TTFT p50/p99 and inter-token p50 printed for both runs.
               fleet_serving: the same model and requests through the
               fleet. A ReplicaRouter over two pool-less preset servers
               (both take requests, streams equal serve_preset's
               pool-less ones, exactly 24 x 16 = 384 wgmma_f32 forwards
               and splits); over two pooled ones (streams equal the
               pooled ones, at most one cold shared-prefix miss per
               replica, no forward launch). A child process on the same
               card (subprocess, the parent's weights from a file) hosts
               a pooled prefill server and a pool-less replica over rpc:
               a DisaggClient migrates each shared-prefix request's KV
               blocks from the child's pool into a pooled decode replica
               of the parent (streams equal the pooled ones, decode hits
               equal the migrated blocks, no fallback, no forward launch
               in the parent); the router's
               fleet_metrics_text carries both processes' series and
               collect_fleet_trace one request's lane from both; the
               router then serves the 16 requests over the parent's and
               the child's replica, the child is SIGKILLed partway (its
               own launch counts printed as it serves: 24 a prefill),
               and every stream still equals the pool-less one, with a
               replica_dead flight dump naming the rerouted ids. Then an
               Autoscaler over a router of one local replica scales out on
               a burning SLO report through a ProcessReplicaSpawner: a
               fresh child interpreter (``--replica-child``) hosts a
               pool-less preset replica on the card, which serves a
               request equal to the pool-less stream with 24 wgmma_f32
               forwards, and scale-in drains it. Last, a
               profiler capture of one request (serve:prefill and
               serve:decode ranges holding the kernel launches) and the
               server's 8-slot step (per-token decode spans included)
               with tracing on and off every other step, 4 rounds of 64
               pairs, and one record_span call's host time.
8. training  - the bench's GPT-3 1.3B pretrain step (bf16 O2 AdamW,
               recompute, chunked loss, batch 2 x 1024) through TrainStep:
               5 warm-up and 8 timed steps; finite losses that fall, and
               exactly 48 wgmma forward, 24 wgmma dQ and 24 wgmma dK/dV
               launches per step, none on an FMA kernel. Then the same
               model in float16 O2 (fp16_training: GradScaler, AdamW under
               LinearWarmup(CosineAnnealingDecay), ClipGradByGlobalNorm,
               the guarded TrainStep): 48 wgmma_f16 forward, 24 wgmma_f16
               dQ, 24 wgmma_f16 dK/dV and no split launch a step, the
               printed overflow
               flags replayed into the printed scales, a poisoned step
               and a FLAGS_check_nan_inf step that leave the state
               bit-equal; and a 2-layer float16 step against plain
               attention (fp16_step). Then
               one float32 forward and backward of the same configuration
               with the kernels (exactly 48 wgmma_f32 forward, 24 dQ and 24
               dK/dV launches, and 96 of the split, none on an FMA kernel)
               and with plain attention (loss and
               per-parameter gradients within tolerance), and a 2-layer
               full-width bf16 dropout run on the wgmma kernels that
               replays bit for bit from its seed.
9. d256      - the same bf16 O2 step at gpt_1p3b width with 8 heads of 256
               and 2 layers: the gradients of the first loss with the
               kernels against plain attention's, each parameter within
               twice plain attention's own distance from a float32
               reference; one step with the kernels (exactly 4 wgmma
               forward, 2 wgmma dQ and 2 wgmma dK/dV launches, none on an
               FMA kernel) and one with plain attention, the losses equal
               within two bf16 ulps. Then the same in float16 O2
               (d256_fp16_step: GradScaler, exactly 4 wgmma_f16 forward,
               2 wgmma_f16 dQ and 2 wgmma_f16 dK/dV launches, no split,
               none on another route; the first path that launches the
               float16 forward and backward at D = 256; its attention
               shape [2,8,1024,256] float16 is the kernels line's
               flash_attention_fwd_f16_sm90_d256 and
               flash_attention_bwd_{dq,dkv}_f16_sm90_d256 rows). Then the
               float32 check of phase 5 at that width and depth (d256_f32:
               exactly 4 wgmma_f32
               forward, 2 dQ and 2 dK/dV launches and 8 of the split, none
               on an FMA kernel; its attention shape [2,8,1024,256]
               float32 is also a case of the backward phase). Then
               gpt_1p3b width with 8 heads of 256 and 2 layers behind
               InferenceServer(slots=2, max_length=2048) serves two
               greedy prompts of 900 and 1900 tokens: the checks of
               phase 4, with the wgmma_f32 forward at D = 256 (exactly one
               launch and one split per layer per prefill, no other
               forward).
10. encoder  - transformer_base: nn.Transformer() at its defaults
               (Transformer-base: d_model 512, 8 heads of 64, 6 + 6
               layers, FFN 2048, ReLU, dropout 0.1) between a shared
               37000-word embedding with learned positions and a tied
               output projection, label smoothing 0.1, bf16 O2 AdamW
               through TrainStep on a seeded batch of 32 x source 256 /
               target 200 with per-row lengths (source 128-256, target
               100-200) and masks as the models pass them (bool key
               padding [32,1,256,256], float causal -inf plus padding
               [32,1,200,200], bool [32,1,200,256] for cross-attention):
               5 warm-up and 8 timed steps, falling losses, exactly 18
               wgmma forward, 18 dQ and 18 dK/dV launches a step (6 at each
               attention shape) and no dS output; step ms, tokens/s, peak
               memory. sdpa_routes: the port's SDPA at those three calls
               (and a left-padded float -inf mask) in bf16 and float32
               against its plain branch (float32: the kernels' stated
               tolerances; bf16: the output within 2 bf16 ulps of the
               float32 plain branch, gradients within twice the bf16 plain
               branch's distance from it), trained float masks [1,8,L,L]
               and [32,1,L,L] (dS and its reduction), the bf16 kernels at
               p = 0.1 against their plain versions given the same mask,
               causal Lq != Lk (no launch, bottom-right), and each kernel
               at each call timed against torch's SDPA with the same mask.
               bert_base: BertForSequenceClassification(bert_base()) bf16
               O2 AdamW at [32, 128] with padded rows (falling loss, no
               flash launch: its attention is plain by design),
               BertForPretraining forward and backward at [8, 512] with 76
               masked positions a row, ERNIE-3.0-base forward at [8, 512],
               and a float32 BertModel against float64 on the card.
11. resnet50_training - the convolutional path (no flash kernel on it):
               (a) one float32 Momentum(0.1, 0.9) step of ResNet-50 (1000
               classes, batch 4 at 224 x 224) on the card against the same
               step on the CPU from the same weights and batch (loss,
               training-mode logits, every running statistic, the update;
               a poisoned step skipped with the statistics bit-equal),
               sound and with three faults planted in the card's run
               (torch's momentum convention, a biased running variance, a
               skipped step that keeps its statistics), each of which must
               trip its gate; (b) bench.py bench_resnet50 at full width and
               depth: batch 64 at 224 x 224, bf16 O2, float32 images (so
               float32 compute, as the reference), 20 warm-up and 20 timed
               steps on CUDA events (median ms and spread, images/s, peak,
               MFU from the ported flops(), no flash launch, float32
               logits, statistics moved); (c) the same model fed bf16
               images; (d) a poisoned step and an EvalStep leaving every
               parameter, velocity, master and statistic bit-equal.
11b. vision_zoo - the vision zoo, nn and beam search (no flash kernel):
               (a) every constructor of vision.models at full width (30:
               LeNet at 28 x 28, InceptionV3 at 299, the rest at 224)
               runs a batch-2 float32 eval forward on the card, logits
               finite and [2, classes], and one of each family also on the
               CPU from the same seed, the card within 1e-3 of the
               largest CPU logit; (b) MobileNetV3-Large and ShuffleNetV2
               x1.0 trained through hapi.Model.fit on bench_resnet50's
               recipe (1000 classes, batch 64 at 224 x 224, Momentum(0.1,
               0.9), bf16 O2) from a vision.datasets.ImageFolder of JPEG
               files the phase writes, through RandomResizedCrop,
               RandomHorizontalFlip, ToTensor and Normalize in DataLoader
               worker processes and the device prefetch: 3 warm-up and
               10 timed steps (median and range, images/s, peak, the
               prefetcher's consumer stall), one step on a device batch
               traced for its launches and idle share, and each model's
               float32 batch-4 step held to the CPU by resnet50_training's
               yardstick (running means read in units of their feature's
               std); (c) BeamSearchDecoder over LSTMCell(512, 512) with a
               32000-word embedding and output layer, beam 4, batch 32,
               64 steps: sequences equal to the CPU's, log-probabilities
               within 1e-5.
12. detection_training, ocr_training - the detection and OCR path (no
               flash kernel on it; the models' ``loss`` through TrainStep
               and ``LossAdapter``): (a) one float32 step of ppyoloe_s and
               of YOLOv3(80, 32) at batch 2, 320 x 320, and of CRNN(6625)
               at [4, 3, 32, 64], on the card against the CPU's float64
               step (loss, logits, every statistic, the update, each read
               against the CPU float32 step's own error; the TAL
               assignment against the CPU's on the same inputs, each
               head's yolo_loss against the CPU's in float64, an
               infeasible CTC label's finite loss), sound and with two
               planted faults a model (argmax taking the last maximum, no
               detach before the assignment; padded rows writing cell
               (0, 0), the first of two rows in one cell winning; CTC's
               impossible paths at -inf, a skip between equal labels),
               each of which must trip its gate; (b) ppyoloe_s at
               [8, 3, 640, 640] and YOLOv3 at [8, 3, 608, 608] (float32
               Momentum(0.9), L2 5e-4, 32 gt rows an image) and CRNN at
               [128, 3, 32, 320] (Adam), 5 warm-up and 10 timed steps on
               CUDA events (median ms and spread, images/s, peak,
               launches and idle share of one traced step, falling loss,
               0 flash launches), the port's LSTM and CTC timed beside
               cuDNN's LSTM and torch's ctc_loss; (c) serving at batch 1
               (the fused PP-YOLOE held to the unfused one; forward,
               decode and NMS ms; predict's rows equal to the CPU
               matrix_nms of the same arrays) and CRNN's greedy decode
               equal to the CPU's of the same logits.
13. fit loop - hapi_gpt_fit: bench.py bench_gpt_primary's GPT-350M (h1024,
               24 layers, 16 heads of 64, vocab 50304, [8, 1024], bf16 O2
               AdamW, chunked loss, no recompute, dropout 0) through
               Model.fit with two DataLoader workers, the device prefetch
               (depth 2) and ModelCheckpoint: 5 warm-up and 8 timed steps
               (ms, tokens/s, MFU, peak memory), exactly 24 wgmma forward,
               dQ and dK/dV launches a step, losses bit-equal to a bare
               TrainStep on the same batches, bench.py's prefetch probe
               (stall a step; every prefetched batch equal to its host
               array), the saved final reloaded into a fresh model giving
               the same eval loss bit for bit; then a SIGTERM after batch
               6 of 12 under RecoveryPolicy (checkpoint and exit, resumed
               by a fresh model) and a rollback after two poisoned batches,
               each ending bit-identical to an uninterrupted fit, with the
               seconds and bytes of every save, restore and crc pass.
               hapi_bert_fit: BertForSequenceClassification(bert_base())
               bf16 O2 through Model.fit(train, eval) with Accuracy, tail
               padding, length buckets (64, 128), LRScheduler and
               EarlyStopping; evaluate and predict equal to a direct
               EvalStep over the same batches' real rows.
14. lora     - lora_fit: hapi_gpt_fit's GPT-350M, batches and loop
               through Model.fit(lora=LoraConfig(rank=8, alpha=16)): 5
               warm-up and 8 timed steps beside the full fit's, exactly 24
               wgmma forward, dQ and dK/dV launches a step, the bf16 base
               bitwise unchanged, only the float32 adapter leaves in the
               step, optimizer state under a tenth of the model's bytes,
               the adapter saved and loaded back bit-equal. lora_serving:
               the serve preset at 12 of its 24 layers, full width (bf16
               cache), with serve_bench's adapter
               traffic (8 tenants of rank 4, 85 % of 24 requests, Zipf,
               max_loaded=5), after the base model alone on the same
               requests: pool-less streams equal solo generate() with the
               adapter set, pooled streams the request served alone by a
               fresh pooled server, no failure, evictions, 12 wgmma_f32
               D = 64 forwards per pool-less prefill and none pooled, a
               tenant's hits only on its own blocks; TTFT, ms and launches
               per decode step with and without the adapters.
15. llama    - llama2_7b served at full width and depth, its bf16 O2
               step (8 of 32 layers) and its GQA gradients (2 layers).
16. distributed_training - hapi_gpt_fit's GPT-350M step (bf16 O2 AdamW,
               global batch [8, 1024]) at 12 of its 24 layers
               (DIST_LAYERS) at world 2 on the one card: a
               single-process TrainStep first (the yardstick), NCCL with
               two ranks on the device meanwhile (its refusal recorded)
               and then with a world of one (this process: the default
               backend), then one pair of fresh rank processes
               (``--dist-child``) over gloo with CUDA tensors running
               three runs in turn: sdp = 2 with ZeRO-2 and the overlap
               buckets, mp = 2, and sdp = 2 with ZeRO-3. Each
               takes 5 warm-up and 8 timed steps (ZeRO-3 gathering each
               decoder block on use); its losses are held to the
               yardstick's (DIST_LOSS_RTOL) and its float32 masters too,
               block by block on the ranks (DIST_UPDATE_RTOL,
               DIST_UPDATE_MODEL_RTOL: the share of the yardstick's update
               that the run got wrong, on the worst leaf and on the
               model); each rank
               launches exactly 24 wgmma forward, dQ and dK/dV kernels a
               step at its own shape
               ([4,16,1024,64] under ZeRO, [8,8,1024,64] under mp) and
               reports its step ms, peak GiB, bytes by collective, staged
               bytes and the backend. Then the same model launched
               (``distributed_training_launch``): two elastic launchers
               (``python -m paddle_tpu_torch.distributed.launch --nnodes
               1:2 --elastic_ttl 2``, a KV store this process binds
               first) as two nodes, each running one rank of
               tools/torch_launch_train.py on the card over gloo: the
               collective checks (new_group, send/recv with and without a
               buffer, isend/irecv, batch_isend_irecv, reduce, scatter,
               alltoall_single, all_gather_object on CUDA tensors, exact),
               LAUNCH_LOCALSGD_STEPS steps of fleet's LocalSGD (k_steps 2:
               the ranks' checksums differ before the first sync and are
               bit-equal after each; rank 0 replays the segment in one
               process, two TrainSteps on the halves with their masters
               averaged, and holds the losses within DIST_LOSS_RTOL and
               the masters within the update limits of the replay's),
               then group_sharded_parallel "os_g"
               at sdp = 2 saving one checkpoint from both ranks every
               LAUNCH_SAVE_EVERY steps; once step LAUNCH_KILL_AFTER's is
               published, node B's process group is SIGKILLed, node A's
               launcher must log "membership changed; resizing" and its
               new rank (world 1, mesh through reshaped_mesh, batch
               through rescale_batch) restores that checkpoint resharded,
               bit-equal to the shard files' crc32, and finishes the 13
               steps. Every step's loss at both worlds within
               DIST_LOSS_RTOL of the yardstick's, the final masters within
               its update limits, 12 wgmma forward, dQ and dK/dV launches
               every step at [4,16,1024,64] then [8,16,1024,64]; boot,
               save and restore seconds and bytes, the resize's wall time
               from the kill to the first resumed step, the peak a rank.
17. ps_ctr_training, graph_training - the parameter-server and graph
               path, after ocr_training (no flash kernel on it; the
               native C++ runtime built by g++ on a thread during the
               kernel phases): (a) a 2M-key adagrad table filled with
               tools/ps_bench.py's keys, its cold pull, hot pull and push
               rates at batch 8192; (b) examples/ps_ctr_train.py's CTR
               model (SparseEmbedding(16), Linear(32, 32), Linear(32, 1))
               trained 20 steps at batch 8192 on ids drawn with repeats,
               the dense tower by TrainStep with SGD(0.05), from that
               table's file, held against the CPU's float64 run (losses,
               dense update, touched rows, each against float32's own
               error), sound and with a skipped push and merged
               duplicates that must trip the rows gate, replayed bit for
               bit, its step split into pull, copies, kernels and push
               and the device's idle share; (c) the same through
               StagedPull; (d) over two PsServer processes, sync (bit-
               equal to (b)) and through an async Communicator; (e) the
               model served under eval() and no_grad (rows unchanged,
               shows up by their pulls). graph_training: (a)
               tools/graph_bench.py's 10M-edge graph built on one host
               and over two graph-shard servers (edges/s, samples/s,
               hops/s; samples and walks equal); (b) its DeepWalk step on
               a [1M, 64] embedding on the card, 30 steps sequential and
               overlapped with a producer thread, held to the CPU's
               float64 run; (c) khop_sampler_from_store from 1024 seeds
               at (25, 10), reindex_graph, two hops of send_u_recv (sum,
               mean, max) on the card against the CPU, ms a hop. Each
               prints the host's CPU count beside its host rates.
18. inference_export - the deployment path, after eager_training: (a)
               bench_gpt_primary's GPT-350M (bf16, seeded, eval) saved
               by jit.save with InputSpec([None, None], "int64"), loaded
               by inference.create_predictor and run at [1, 1024] and
               [4, 512] from one artifact: logits equal to the eager
               model's, 24 wgmma forward launches a run from the loaded
               program (24 operator nodes, no softmax), set_state_dict
               changing the output; capture, write, load, first and
               median run times and the artifact's bytes; a 2-layer
               GPT-350M saved on the CPU and served on the card launching
               the wgmma forward once a layer, equal to its eager model
               on the card. (b) ResNet-50
               float32 saved as one DistModel stage: the plain-C consumer
               (tools/torch_infer_demo.c over the C API) at batch 1 and
               DistModel at batch 4 in two micro-batches, each equal to
               the Python predictor at rtol 1e-5 / atol 1e-6, and the
               card's program moved to the CPU by Config.disable_gpu().
               ``--only inference_export`` builds the kernels and runs
               this phase alone (no result line); ``--only
               distributed_training`` does the same for phase 16.

Then a line with the kernels' summary, a line with the card's name and
power limit, and the last line {"ok": true, "device": {...}}.
The kernels line counts each kernel's launches on the path that runs it
(the serving options, speculative prefills, the serve preset's D = 64
prefills, the fleet's, each attention call of Transformer-base, the fit loop's
D = 64 step, the two LoRA paths, the three world-2 runs and the saved
GPT-350M's two served shapes have rows of their own). ``--kernels-only`` stops after phase 3
and prints none of those three
lines, and reports a register spill without failing on it: a partial
run, to compare kernel builds (a layout that spills among them) in turns.

It exits non-zero without printing a result when no CUDA device is
present, and imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_F32_FLOPS = 67e12        # CUDA cores, no tensor cores
PEAK_BF16_TC_FLOPS = 989e12   # tensor cores
PEAK_HBM_BYTES = 3.35e12
# INT32 on the CUDA cores: 64 lanes per SM x 132 SMs at the 1.98 GHz boost
# clock behind the data sheet's 67 TFLOP/s float32 (Hopper white paper)
PEAK_INT32_OPS = 132 * 64 * 1.98e9
# the least integer instructions per dropout element of csrc/philox.cuh:
# each of the 10 rounds takes 2 wide 32 x 32 -> 64-bit products (hi and lo
# in one IMAD.WIDE) and 2 three-input XORs (one LOP3 each); the key
# schedule is the same for every element and not counted; 1 compare
PHILOX_OPS = 10 * (2 + 2) + 1

F32_TOL = 1e-4   # float32 kernel vs float32 einsum: summation order only
# the wgmma_f32 forward (six bf16 term pairs, float32's own 2^-24): the
# reference's float32 forward tolerance, |x - y| <= atol + rtol |y|, on O
# and on LSE, as its cuda tests hold it
F32_FWD_RTOL, F32_FWD_ATOL = 1e-5, 1e-5
# bf16 outputs: kernel and plain version each round an f32 value (equal to
# ~1e-6) to bf16, so they differ by at most one bf16 ulp of the element;
# the limit is two ulps of each element's own size, plus 1e-6 near zero
BF16_ULPS = 2
# backward, float32: the reference's backward tolerance, elementwise
# |x - y| <= BWD_ATOL + BWD_RTOL * |y|
BWD_RTOL, BWD_ATOL = 2e-4, 2e-5
# backward, bf16 outputs: BF16_ULPS ulps of each reference element plus
# 1e-5 of the tensor's largest magnitude (an element near zero is a
# float32 sum with cancellation; two summation orders differ there by
# about 1e-6 of the tensor's scale)
BWD_BF16_FLOOR = 1e-5
PREFILL_LOGITS_TOL = 2e-3  # 24 layers of f32 rounding between two attention paths
# Llama's prefill logits (32 layers) are held against a float64-attention
# reference: the kernels' distance from it may be this many times plain
# float32 attention's distance, measured in the same run. Each kernel
# output is held to F32_FWD_RTOL relative of the plain one, 168 float32
# unit roundoffs (2^-24): a perturbation that many times float32's
# rounding, carried through the same 32 layers, moves the logits at most
# about that many times as far.
LLAMA_LOGITS_FACTOR = F32_FWD_RTOL / 2.0 ** -24
# training, float32, kernels vs plain attention through 24 layers: loss
# relative 1e-4, each parameter's gradient relative L2 error 1e-3
TRAIN_LOSS_RTOL, TRAIN_GRAD_REL_L2 = 1e-4, 1e-3
# training, bf16: the kernels' gradients and plain attention's may differ by
# twice what bf16 puts between plain attention's and float32's (each
# parameter, relative L2): the bound two paths that are each as close to
# float32 as plain attention could reach (triangle inequality)
BF16_GRAD_SLACK = 2
DROPOUT_P = 0.1
TRAIN_BATCH, TRAIN_SEQ = 2, 1024     # bench.py bench_gpt_1p3b
TRAIN_WARMUP, TRAIN_TIMED = 5, 8
# the D = 256 step (phase_d256_step): gpt_1p3b width with 8 heads of 256;
# its attention, [TRAIN_BATCH, 8, TRAIN_SEQ, 256] bf16 causal, is also a
# case of the forward, backward and dropout phases
D256_STEP_HEADS = 8
# one rank's attention in the world-2 runs of bench_gpt_primary's GPT-350M
# (phase_distributed_training): [4, 16, 1024, 64] with the batch split in
# two (ZeRO over sdp = 2), [8, 8, 1024, 64] with the heads split (mp = 2)
DIST_ZERO_FWD = "dist_zero_bf16_B4_H16_L1024"
DIST_ZERO_BWD = "dist_zero_bfloat16_B4_H16_L1024"
DIST_MP_FWD = "dist_mp_bf16_B8_H8_L1024"
DIST_MP_BWD = "dist_mp_bfloat16_B8_H8_L1024"
D256_STEP_FWD = f"d256_step_bf16_B{TRAIN_BATCH}_H{D256_STEP_HEADS}_L{TRAIN_SEQ}"
D256_STEP_BWD = f"d256_step_bfloat16_B{TRAIN_BATCH}_H{D256_STEP_HEADS}_L{TRAIN_SEQ}"
# the float32 D = 256 run (phase_d256_f32): the D = 256 step's
# configuration in float32; its attention, [TRAIN_BATCH, 8, TRAIN_SEQ, 256]
# float32 causal, is also a case of the backward phase
D256_F32_BWD = f"d256_f32_float32_B{TRAIN_BATCH}_H{D256_STEP_HEADS}_L{TRAIN_SEQ}"
# the D = 256 prefill (phase_d256_prefill): its longest prompt's bucket,
# [1, 8, 2048, 256] float32 causal, is a case of the forward phase
D256_PREFILL_LENGTHS = (900, 1900)
D256_PREFILL_FWD = "prefill_f32_d256_L2048"
# Llama-2-7B (phase 7): its attention, [1, 32, 4096, 128] causal, from
# separate q/k/v projections, is a case of the forward phase in float32
# (serving prefill's 4096 bucket) and bf16 (training), and of the
# backward phase in bf16
LLAMA_SEQ, LLAMA_HEADS = 4096, 32
LLAMA_PREFILL_FWD = f"llama_prefill_f32_L{LLAMA_SEQ}"
LLAMA_TRAIN_FWD = f"llama_train_bf16_L{LLAMA_SEQ}"
LLAMA_TRAIN_BWD = f"llama_train_bfloat16_L{LLAMA_SEQ}"
LLAMA_TRAIN_LAYERS = 8  # of 32: AdamW's state at 16 bytes a parameter
LLAMA_GQA_KV_HEADS, LLAMA_GQA_LAYERS = 8, 2
LLAMA_PROMPT_LENGTHS = (60, 700, 1500, 3000, 4000)
# float16 (phase fp16_training): the GPT step's attention [2, 16, 1024, 128]
# and Llama's [1, 32, 4096, 128] in float16, cases of the forward and the
# backward phase on the wgmma_f16 route, where the float16 wgmma_f32
# kernels they replace are timed beside them
F16_TRAIN_FWD = f"train_f16_B{TRAIN_BATCH}_L{TRAIN_SEQ}"
F16_TRAIN_BWD = f"train_float16_B{TRAIN_BATCH}_L{TRAIN_SEQ}"
F16_LLAMA_FWD = f"llama_f16_L{LLAMA_SEQ}"
F16_LLAMA_BWD = f"llama_float16_L{LLAMA_SEQ}"
# the float16 D = 256 step (phase_d256_fp16_step): the D = 256 step's
# configuration in float16 O2; its attention, [TRAIN_BATCH, 8, TRAIN_SEQ,
# 256] float16 causal, is also a case of the forward and backward phases
D256_FP16_STEP_FWD = (f"d256_fp16_step_f16_B{TRAIN_BATCH}"
                      f"_H{D256_STEP_HEADS}_L{TRAIN_SEQ}")
D256_FP16_STEP_BWD = (f"d256_fp16_step_float16_B{TRAIN_BATCH}"
                      f"_H{D256_STEP_HEADS}_L{TRAIN_SEQ}")
# a float16 D = 256 backward case with dO at a loss scale (dP passes
# float16's 65504; the gradients stay inside its range): the absolute
# part of its tolerance scales with dO
F16_LOSS_SCALE = 2.0 ** 13
F16_D256_LOSS_SCALE_BWD = "d256_loss_scale_float16_B1_L1024"
# the tensor-core products per kept pair of the wgmma_f16 kernels at
# D = 256 (csrc/flash_attention_bwd_f16_d256_sm90.cu): dQ S, dP and five
# pairs for dS K; dK/dV S^T and dP^T in both warpgroups, two for dV and
# five for dK
F16_D256_PRODUCTS = {"dq": 7, "dkv": 11}
LLAMA_SAMPLED_LENGTH = 1200
LLAMA_LOGITS_PROMPT = 3000
# the serving options (phase_serving_options): gpt_1p3b at 2048 positions,
# 4 slots; six requests share a 1024-token prefix (suffixes of these
# lengths), one does not; the prefix pool's budget and block size
OPTIONS_PREFIX, OPTIONS_SUFFIXES, OPTIONS_UNRELATED = 1024, (20, 60, 120,
                                                             180, 240, 300), 500
OPTIONS_POOL = dict(max_bytes=512 << 20, block_tokens=16)
# the reference's bound on teacher-forced int8 logit drift, relative to the
# largest logit (tests/test_kv_quant.py:190), over this many decode steps
KV_DRIFT_LIMIT, KV_DRIFT_STEPS = 0.05, 16
# two tenants under fair queueing: "loud" sends 10x the requests of
# "quiet"; every tenant's bucket holds TENANT_BURST tokens and refills at
# TENANT_RATE a second, so the loud tenant's last few are rate-limited
FAIR_LOUD, FAIR_QUIET, TENANT_RATE, TENANT_BURST = 20, 2, 0.5, 16.0
# speculative decoding (phase_speculative): a 1-layer draft of gpt_1p3b
SPEC_K, SPEC_PROMPTS, SPEC_NEW = 4, (300, 900), 64
# the serve preset (phase_serve_preset): tools/decode_bench.py:51-57's
# model behind serve_bench's prefix-heavy trace
PRESET_REQUESTS, PRESET_PREFIX, PRESET_PREFIX_FRAC = 16, 512, 0.9
PRESET_SUFFIX, PRESET_NEW, PRESET_SLOTS = (16, 128), 16, 8
PRESET_POOL_BYTES = 256 << 20
# its pool-less prefill's attention at the 1024 bucket, [1, 16, 1024, 64]
# float32 causal, is a case of the forward phase
PRESET_FWD = "serve_preset_f32_d64_L1024"


def bf16_ulp(x):
    """The bf16 spacing at |x|, elementwise (8 significant bits): 2^(e-8)
    for 2^(e-1) <= |x| < 2^e; 0 where x is 0."""
    import torch

    _, e = torch.frexp(x.float().abs())
    return torch.where(x == 0, 0.0, torch.exp2((e - 8).float()))


def f16_ulp(x):
    """The float16 spacing at |x|, elementwise (11 significant bits;
    2^-24 among the subnormals below 2^-14)."""
    import torch

    _, e = torch.frexp(x.float().abs())
    return torch.exp2(torch.clamp(e - 11, min=-24).float())


def output_tolerance(o_ref, route):
    """The elementwise limit on |o - o_ref| of a forward output of
    ``route``: BF16_ULPS ulps of o_ref plus 1e-6 for bfloat16, F32_FWD_ATOL
    + F32_FWD_RTOL |o_ref| on the wgmma_f32 and wgmma_f16 routes, plus one
    float16 ulp of o_ref for float16 (kernel and plain version each round a
    float32 value once to float16, and two values within the float32
    tolerance may round to neighbours), F32_TOL for the float32 FMA
    kernel."""
    import torch

    if o_ref.dtype == torch.bfloat16:
        return BF16_ULPS * bf16_ulp(o_ref) + 1e-6
    if route in ("wgmma_f32", "wgmma_f16"):
        tol = F32_FWD_ATOL + F32_FWD_RTOL * o_ref.float().abs()
        return tol + f16_ulp(o_ref) if o_ref.dtype == torch.float16 else tol
    return torch.full_like(o_ref, F32_TOL, dtype=torch.float32)


def lse_tolerance(lse_ref, route):
    """The elementwise limit on the LSE's error: as the output's on the
    wgmma_f32 and wgmma_f16 routes (without the float16 ulp: the LSE is
    float32), else 10 F32_TOL."""
    if route in ("wgmma_f32", "wgmma_f16"):
        return F32_FWD_ATOL + F32_FWD_RTOL * lse_ref.abs()
    return F32_TOL * 10


def bwd_tolerance(ref, do_scale: float = 1.0):
    """The elementwise limit on a backward output's error: BWD_ATOL +
    BWD_RTOL |ref| for float32, plus one float16 ulp of ref for float16
    (one rounding of a float32 value on each side); BF16_ULPS ulps plus
    BWD_BF16_FLOOR of the largest magnitude for bfloat16. The gradients
    are linear in dO, so for a dO ``do_scale`` times the unit-scale inputs
    the tolerance was set for (a loss scale), BWD_ATOL scales with it."""
    import torch

    if ref.dtype == torch.bfloat16:
        return (BF16_ULPS * bf16_ulp(ref)
                + BWD_BF16_FLOOR * ref.float().abs().max())
    tol = BWD_ATOL * do_scale + BWD_RTOL * ref.float().abs()
    return tol + f16_ulp(ref) if ref.dtype == torch.float16 else tol


def check_close(name, got, ref, limit) -> dict:
    """Max |got - ref| and its largest share of ``limit``; raises when an
    element is past its limit or not finite, or when the reference is all
    zeros (a check that could not fail)."""
    if not ref.abs().max().item() > 0:
        raise AssertionError(f"{name}: the plain version is all zeros")
    diff = (got.float() - ref.float()).abs()
    err = diff.max().item()
    share = (diff / limit).max().item()
    if not (math.isfinite(err) and share <= 1.0):
        raise AssertionError(f"{name}: kernel vs plain max|err| {err} at "
                             f"{share} of its limit")
    return {"max_abs_err": err, "err_share_of_tol": share}


_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line; ``elapsed_s`` is the host time since the script
    started (to budget its time limit)."""
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": time.perf_counter() - _START}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# A spin kernel of this many cycles (about 10 ms) runs ahead of each timed
# loop, so the host has queued the whole loop before its first launch
# starts: the events then time the device's work back to back, not the
# host's launch rate (a Python wrapper takes tens of microseconds a call,
# more than a 0.05 ms kernel).
HOST_LEAD_CYCLES = 20_000_000


def _timed_loop(fn, iters: int) -> float:
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOST_LEAD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls,
    between two CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    return _timed_loop(fn, iters)


def timed_in_turns(fns, loops: int = 20, rounds: int = 3) -> dict:
    """Device ms per call of each of ``fns`` (name -> callable), taken in
    turns so that drift of the card's clock falls on all alike: after one
    warm-up loop each, every round runs each callable's loop of ``loops``
    calls in order and then in reverse (A, B, B, A), so each gets
    ``2 * rounds`` loops. Returns ``{name: {"median", "min", "max"}}``."""
    import statistics

    for fn in fns.values():
        for _ in range(3):
            fn()
    samples = {name: [] for name in fns}
    order = list(fns)
    for _ in range(rounds):
        for name in order + order[::-1]:
            samples[name].append(_timed_loop(fns[name], loops))
    return {name: {"median": statistics.median(v), "min": min(v),
                   "max": max(v)} for name, v in samples.items()}


def _route_of(fa, which: str) -> str:
    """The one route of wrapper ``which`` launched since the last reset."""
    used = [r for r, n in fa.launch_counts()[which].items() if n]
    if len(used) != 1:
        raise AssertionError(f"{which}: launches by route "
                             f"{fa.launch_counts()[which]}, expected one route")
    return used[0]


def kept_pairs(Lq, Lk, causal):
    """The (query, key) pairs a top-left causal mask keeps (all without)."""
    if causal:  # row i keeps min(i + 1, Lk) keys
        return sum(min(i + 1, Lk) for i in range(Lq))
    return Lq * Lk


def _term_pairs(route, dtype) -> int:
    """The tensor-core products a bound counts per product of the kernel:
    6 bf16 term pairs for float32 on the wgmma_f32 route (the least work
    that keeps float32 accuracy on those units), 1 otherwise: bf16, and
    float16 on either route, whose least work is one float16 product at
    the same peak (the wgmma_f32 route does 6 term pairs for it, 4 of them
    non-zero; the wgmma_f16 kernels 3 products for the forward's 2, 7 for
    dQ's 3 and 9 for dK/dV's 4, 11 at D = 256: F16_D256_PRODUCTS)."""
    import torch

    return 6 if route == "wgmma_f32" and dtype == torch.float32 else 1


def _bound(flops, nbytes, tensor_cores):
    ops_ms = flops / (PEAK_BF16_TC_FLOPS if tensor_cores else PEAK_F32_FLOPS) * 1e3
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def attention_bound_ms(B, H, Lq, Lk, D, causal, dtype_bytes, bias_bytes,
                       tensor_cores: bool, term_pairs: int = 1):
    """The least time an H100 could take for one attention forward: the
    larger of (bytes moved once: q, k, v, bias read; o, lse written) over
    HBM bandwidth and (FLOPs of the pairs this run's mask keeps: 2*D for
    QK^T and 2*D for PV per pair, times ``term_pairs``) over the peak rate
    of the units that do them. Float32 operands on the bf16 tensor cores
    need 6 term pairs per product (``wgmma_f32``: three bf16 terms of each
    operand, pairs i + j <= 2), the least work that keeps float32 accuracy
    there. Exponentials are not counted."""
    flops = 4.0 * D * kept_pairs(Lq, Lk, causal) * B * H * term_pairs
    nbytes = (B * H * (Lq + 2 * Lk) * D * dtype_bytes      # q, k, v
              + B * H * Lq * D * dtype_bytes + B * H * Lq * 4  # o, lse
              + bias_bytes)
    return _bound(flops, nbytes, tensor_cores)


def bwd_bound_ms(kernel, B, H, Lq, Lk, D, causal, dtype_bytes, bias_bytes,
                 ds_bytes, tensor_cores: bool, term_pairs: int = 1):
    """The least time an H100 could take for one backward kernel: the
    larger of its bytes (q, k, v, dO, lse, delta and bias read once; dQ
    and dS, or dK and dV, written once) over HBM bandwidth and its FLOPs
    (per kept pair 6D for dQ: Q K^T, dO V^T, dS K; 8D for dK/dV: those two
    again, P^T dO and dS^T Q; times ``term_pairs``) over the peak of the
    units that do them. Float32 operands on the bf16 tensor cores
    (``wgmma_f32``) take 6 term pairs per product and read q, k, v and dO
    as their three bf16 terms too (6 bytes an element)."""
    per_pair = 6 if kernel == "dq" else 8
    flops = per_pair * D * kept_pairs(Lq, Lk, causal) * B * H * term_pairs
    nbytes = (B * H * (2 * Lq + 2 * Lk) * D * dtype_bytes   # q, do, k, v
              + 2 * B * H * Lq * 4 + bias_bytes)              # lse, delta
    if term_pairs > 1:
        nbytes += B * H * (2 * Lq + 2 * Lk) * D * 3 * 2     # their terms
    if kernel == "dq":
        nbytes += B * H * Lq * D * dtype_bytes + ds_bytes
    else:
        nbytes += 2 * B * H * Lk * D * dtype_bytes
    return _bound(flops, nbytes, tensor_cores)


def longest_cta_floor_ms(kernel, Lq, Lk, D, causal, products):
    """The least time of the heaviest CTA of a wgmma_f16 D = 256 backward
    kernel (one CTA per 64 query rows for dQ, per 64 keys for dK/dV): its
    64 x 64 x D tiles (causal: dQ's last query tile sees every key tile up
    to the diagonal, dK/dV's first key tile every query tile), times
    ``products`` tensor-core products a tile, at one SM's share of the
    tensor cores' peak. With no more CTAs than SMs it bounds the kernel's
    time from below, whatever the total work's bound says."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_q, n_k = -(-Lq // 64), -(-Lk // 64)
    tiles = (min(n_q, n_k) if causal else n_k) if kernel == "dq" else n_q
    flops = tiles * products * 2 * 64 * 64 * D
    return flops / (PEAK_BF16_TC_FLOPS / sms) * 1e3


def _views(g, B, L, H, D, dtype, n=3):
    """``n`` [B, H, L, D] tensors as the GPT path hands them to the
    kernels: strided views of one fused [B, L, n, H, D] tensor."""
    import torch

    t = torch.randn(B, L, n, H, D, generator=g, device="cuda").to(dtype)
    return tuple(t[:, :, i].transpose(1, 2) for i in range(n))


def _blhd_views(g, B, L, H, D, dtype, n=3):
    """``n`` [B, H, L, D] tensors as the Llama path hands them to the
    kernels: transposed views of separate [B, L, H, D] tensors (the
    rotated q and k, v; K and V repeated for GQA)."""
    import torch

    return tuple(torch.randn(B, L, H, D, generator=g, device="cuda")
                 .to(dtype).transpose(1, 2) for _ in range(n))


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


def ptxas_report(log: str) -> list:
    """Per kernel of one source's build log (``-Xptxas -v``): its name and
    template arguments, registers, and spill stores and loads in bytes."""
    import re

    out = []
    for entry in log.split("Compiling entry function")[1:]:
        # the mangled name: length-prefixed nested names, the last one the
        # kernel's, then its integer and bool template arguments
        mangled = entry.split("'")[1]
        i = 3 if mangled.startswith("_ZN") else 2
        name = mangled
        while i < len(mangled) and mangled[i].isdigit():
            j = i
            while mangled[j].isdigit():
                j += 1
            name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
        targs = mangled[i:].split("Ev")[0]
        args = [v if k == "i" else ("false", "true")[int(v)]
                for k, v in re.findall(r"L([ib])(\d+)E", targs)]
        if "__half" in targs:  # the float16-output instantiations
            args.append("__half")
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          entry)
        out.append(dict(kernel=f"{name}<{', '.join(args)}>" if args else name,
                        registers=int(re.search(r"Used (\d+) registers",
                                                entry).group(1)),
                        spill_stores=int(spill.group(1)) if spill else 0,
                        spill_loads=int(spill.group(2)) if spill else 0))
    return out


def phase_build(seed: int, fail_on_spill: bool = True) -> dict:
    """Build every kernel source, fail on a spill in the wgmma kernels
    (unless ``fail_on_spill`` is False: a spill is then only reported),
    and hold the wgmma/TMA self-check against torch.matmul (the forward
    routes' forms: bf16 and float16 native products, m64n256k16 included,
    and float32 through the three-term products). Returns each source's
    ptxas report (:func:`ptxas_report`)."""
    import torch

    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa

    t0 = time.perf_counter()
    libs = {s: p.name for s, p in _build.build_all().items()}
    ptxas = {s: ptxas_report(_build.build_log(s)) for s in libs}
    emit("build", seconds=time.perf_counter() - t0, libraries=libs,
         ptxas=ptxas)
    spills = [(s, k) for s in (fa._FWD_SM90_SOURCE, fa._FWD_F32_SM90_SOURCE,
                               fa._FWD_F16_SM90_SOURCE,
                               fa._DQ_SM90_SOURCE, fa._DKV_SM90_SOURCE,
                               fa._BWD_F32_SM90_SOURCE,
                               fa._BWD_F32_D256_SM90_SOURCE,
                               fa._BWD_F16_SM90_SOURCE,
                               fa._BWD_F16_D256_SM90_SOURCE)
              for k in ptxas[s] if k["spill_stores"] or k["spill_loads"]]
    # registers and spills of each instantiation of the float16 kernels
    for source in (fa._FWD_F16_SM90_SOURCE, fa._BWD_F16_SM90_SOURCE,
                   fa._BWD_F16_D256_SM90_SOURCE):
        emit("build_wgmma_f16", source=source, ptxas=ptxas[source])
    if spills and fail_on_spill:
        raise AssertionError(f"register spills in the wgmma kernels: {spills}")
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    out = {}
    # the head dims of each dtype's tensor-core forward
    for dtype, D in [(dtype, D) for dtype in fa._DTYPE_ROUTES
                     for D in fa.SUPPORTED_HEAD_DIMS]:
        a, b, c1, c2 = fa.wgmma_selfcheck(D, "cuda", g, dtype=dtype)
        torch.cuda.synchronize()
        for name, got, x, y in (("kmajor", c1, a, b.T), ("transposed_b", c2,
                                                        a[:, :64], b)):
            # bf16 and float16 products are exact in float32; a float32
            # sum of K terms is within K 2^-24 of sum |x y| of the exact
            # one. float32 operands as six bf16 term pairs drop a few
            # 2^-24 more.
            k = x.shape[1] + (4 if dtype == torch.float32 else 0)
            limit = 2 * k * 2.0 ** -24 * (x.double().abs() @ y.double().abs())
            key = f"{name}_{_dtype_name(a)}_d{D}"
            out[key] = check_close(f"wgmma self-check {key}", got,
                                   x.double() @ y.double(), limit + 1e-30)
    emit("selfcheck", **out)
    return ptxas


def _fwd_cases(g):
    """(name, q, k, v, causal, bias, route, tol) of the forward checks."""
    import torch

    bf16_tol = f"{BF16_ULPS} bf16 ulps + 1e-6"
    f32_tol = f"{F32_FWD_ATOL} + {F32_FWD_RTOL} |ref|"
    f16_tol = f32_tol + " + 1 float16 ulp"
    cases = []
    for L in (64, 512, 1024, 2048):  # the serving path's prefill buckets
        cases.append((f"prefill_f32_L{L}", *_views(g, 1, L, 16, 128, torch.float32),
                      True, None, "wgmma_f32", f32_tol))
    cases.append(("d64_causal_f32_B2_L1024", *_views(g, 2, 1024, 16, 64, torch.float32),
                  True, None, "wgmma_f32", f32_tol))
    # the serve preset's pool-less prefill (phase_serve_preset), h1024 with
    # 16 heads of 64, at its 1024 bucket
    cases.append((PRESET_FWD, *_views(g, 1, 1024, 16, 64, torch.float32),
                  True, None, "wgmma_f32", f32_tol))
    # D = 256, float32: the wgmma_f32 forward at [1, 8, 1024, 256] and at
    # the D = 256 prefill's longest bucket (phase_d256_prefill)
    cases.append(("d256_causal_f32_L1024", *_views(g, 1, 1024, 8, 256, torch.float32),
                  True, None, "wgmma_f32", f32_tol))
    cases.append((D256_PREFILL_FWD, *_views(g, 1, 2048, D256_STEP_HEADS, 256,
                                            torch.float32),
                  True, None, "wgmma_f32", f32_tol))
    cases.append(("causal_bf16_L2048", *_views(g, 1, 2048, 16, 128, torch.bfloat16),
                  True, None, "wgmma", bf16_tol))
    # the training step's attention: [2, 16, 1024, 128] bf16, causal
    cases.append(("train_bf16_B2_L1024", *_views(g, 2, 1024, 16, 128, torch.bfloat16),
                  True, None, "wgmma", bf16_tol))
    cases.append(("d64_causal_bf16_B2_L1024", *_views(g, 2, 1024, 16, 64, torch.bfloat16),
                  True, None, "wgmma", bf16_tol))
    # bench.py bench_gpt_primary's attention: [8, 16, 1024, 64] bf16, causal
    cases.append(("primary_bf16_B8_L1024", *_views(g, 8, 1024, 16, 64, torch.bfloat16),
                  True, None, "wgmma", bf16_tol))
    # GPT-350M's attention as its saved program serves it
    # (phase_inference_export): [1, 1024] and [4, 512] from one artifact
    for (B, L), name in INFER_FWD_CASES.items():
        cases.append((name, *_views(g, B, L, 16, 64, torch.bfloat16),
                      True, None, "wgmma", bf16_tol))
    # the same attention on one rank of the world-2 runs
    # (phase_distributed_training): half the batch under ZeRO, half the
    # heads under mp = 2
    cases.append((DIST_ZERO_FWD, *_views(g, 4, 1024, 16, 64, torch.bfloat16),
                  True, None, "wgmma", bf16_tol))
    cases.append((DIST_MP_FWD, *_views(g, 8, 1024, 8, 64, torch.bfloat16),
                  True, None, "wgmma", bf16_tol))
    # D = 256: the wgmma forward at two sizes, and at the D = 256 step's
    # own [2, 8, 1024, 256] (phase_d256_step)
    cases.append(("d256_causal_bf16_L1024", *_views(g, 1, 1024, 8, 256, torch.bfloat16),
                  True, None, "wgmma", bf16_tol))
    cases.append(("d256_causal_bf16_B2_L1024", *_views(g, 2, 1024, 16, 256, torch.bfloat16),
                  True, None, "wgmma", bf16_tol))
    cases.append((D256_STEP_FWD, *_views(g, TRAIN_BATCH, TRAIN_SEQ, D256_STEP_HEADS,
                                         256, torch.bfloat16),
                  True, None, "wgmma", bf16_tol))
    # Llama-2-7B's attention: serving prefill's 4096 bucket (float32) and
    # the training step's (bf16)
    cases.append((LLAMA_PREFILL_FWD, *_blhd_views(g, 1, LLAMA_SEQ, LLAMA_HEADS,
                                                  128, torch.float32),
                  True, None, "wgmma_f32", f32_tol))
    cases.append((LLAMA_TRAIN_FWD, *_blhd_views(g, 1, LLAMA_SEQ, LLAMA_HEADS,
                                                128, torch.bfloat16),
                  True, None, "wgmma", bf16_tol))
    # float16 (float16 O2 training) on the wgmma_f16 route: the GPT step's
    # [2, 16, 1024, 128], Llama's [1, 32, 4096, 128], and D 64 and 256
    cases.append((F16_TRAIN_FWD, *_views(g, TRAIN_BATCH, TRAIN_SEQ, 16, 128,
                                         torch.float16),
                  True, None, "wgmma_f16", f16_tol))
    cases.append((F16_LLAMA_FWD, *_blhd_views(g, 1, LLAMA_SEQ, LLAMA_HEADS,
                                              128, torch.float16),
                  True, None, "wgmma_f16", f16_tol))
    cases.append(("d64_causal_f16_B2_L1024", *_views(g, 2, 1024, 16, 64,
                                                     torch.float16),
                  True, None, "wgmma_f16", f16_tol))
    cases.append(("d256_causal_f16_L1024", *_views(g, 1, 1024, 8, 256,
                                                   torch.float16),
                  True, None, "wgmma_f16", f16_tol))
    cases.append((D256_FP16_STEP_FWD, *_views(g, TRAIN_BATCH, TRAIN_SEQ,
                                              D256_STEP_HEADS, 256,
                                              torch.float16),
                  True, None, "wgmma_f16", f16_tol))
    for dtype, D, H, route, tol in (
            (torch.float32, 128, 16, "wgmma_f32", f32_tol),
            (torch.float32, 256, 8, "wgmma_f32", f32_tol),
            (torch.bfloat16, 64, 16, "wgmma", bf16_tol),
            (torch.float16, 128, 16, "wgmma_f16", f16_tol)):
        q = torch.randn(1, H, 384, D, generator=g, device="cuda").to(dtype)
        k = torch.randn(1, H, 640, D, generator=g, device="cuda").to(dtype)
        v = torch.randn(1, H, 640, D, generator=g, device="cuda").to(dtype)
        bias = torch.randn(1, H, 384, 640, generator=g, device="cuda")
        cases.append((f"bias_noncausal_{_dtype_name(q)}_d{D}_Lq384_Lk640",
                      q, k, v, False, bias, route, tol))
    for dtype, route, tol in ((torch.float32, "wgmma_f32", f32_tol),
                              (torch.bfloat16, "wgmma", bf16_tol),
                              (torch.float16, "wgmma_f16", f16_tol)):
        q, k, v = _views(g, 1, 1500, 16, 128, dtype)
        cases.append((f"ragged_causal_{_dtype_name(q)}_L1500", q, k, v, True,
                      None, route, tol))
    return cases


def split_case(fa, name, q, k, v) -> dict:
    """The wgmma_f32 route's pre-pass (``split_bf16_terms``) on q, k, v
    against its plain version, bit for bit, and timed: its bound is its
    bytes (float32 or float16 read once, three bf16 terms written
    once)."""
    import torch

    got = fa.split_bf16_terms(q, k, v)
    torch.cuda.synchronize()
    if not all(torch.equal(t, fa._plain_split(x)) for t, x in zip(got, (q, k, v))):
        raise AssertionError(f"{name}: the split kernel differs from its "
                             f"plain version")
    t = timed_in_turns({"kernel": lambda: fa.split_bf16_terms(q, k, v)})
    # the input read once, three bf16 terms written once
    nbytes = sum(x.numel() * (x.element_size() + 3 * 2) for x in (q, k, v))
    out = dict(shape=list(q.shape), max_abs_err=0.0, bit_exact=True,
               ms=t["kernel"]["median"],
               ms_range=[t["kernel"]["min"], t["kernel"]["max"]],
               plain_ms=cuda_ms(lambda: [fa._plain_split(x) for x in (q, k, v)],
                                iters=5),
               bound_ms=nbytes / PEAK_HBM_BYTES * 1e3, bound_by="bytes",
               library_ms=None)
    emit("kernels_split", case=name, **out)
    return out


# the D = 256 cases at which the FMA forward, which the tensor-core ones
# replace there, is timed beside them
FWD_FMA_COMPARED = ("d256_causal_f32_L1024", D256_PREFILL_FWD,
                    "d256_causal_bf16_L1024", "d256_causal_bf16_B2_L1024",
                    D256_STEP_FWD)
# the float16 cases at which the wgmma_f32 forward, which the wgmma_f16 one
# replaces, is checked and timed beside it, on its split's terms, with the
# split timed in the same turns
F16_FWD_COMPARED = (F16_TRAIN_FWD, F16_LLAMA_FWD)


def phase_kernels(seed: int) -> dict:
    """The forward kernels against their plain version."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    results = {}
    for name, q, k, v, causal, bias, want, tol in _fwd_cases(g):
        if (want == "wgmma_f32" and bias is None) or name in F16_FWD_COMPARED:
            results[f"split_{name}"] = split_case(fa, name, q, k, v)
        fa.reset_launch_counts()
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, bias=bias)
        again = fa.flash_attention_fwd(q, k, v, causal=causal, bias=bias)
        torch.cuda.synchronize()
        route = _route_of(fa, "fwd")
        if route != want:
            raise AssertionError(f"{name}: forward took the {route} kernel, "
                                 f"expected {want}")
        # no atomics: the same inputs give the same O and LSE
        if not (torch.equal(o, again[0]) and torch.equal(lse, again[1])):
            raise AssertionError(f"{name}: the {route} forward does not "
                                 f"replay bit for bit")
        o_ref, lse_ref = fa.reference_attention_fwd(q, k, v, causal=causal,
                                                    bias=bias)
        num = check_close(name, o, o_ref, output_tolerance(o_ref, route))
        lse_err = check_close(f"{name} lse", lse, lse_ref,
                              lse_tolerance(lse_ref, route))["max_abs_err"]
        fns = {"kernel": lambda: fa.flash_attention_fwd(q, k, v,
                                                        causal=causal,
                                                        bias=bias),
               "library": lambda: F.scaled_dot_product_attention(
                   q, k, v, attn_mask=bias, is_causal=causal)}
        # a forward a route replaced, on the same inputs, launched
        # directly: the FMA one at D = 256, the float16 wgmma_f32 one on
        # its split's terms (and the split)
        others = {}
        if name in FWD_FMA_COMPARED:
            others["fma"] = lambda: fa._launch_fwd_fma(q, k, v, causal, bias,
                                                       None, 0.0, 0)
        if name in F16_FWD_COMPARED:
            terms = fa.split_bf16_terms(q, k, v)
            others["wgmma_f32"] = lambda: fa._launch_fwd_sm90(
                "wgmma_f32", q, k, v, causal, bias, None, 0.0, 0, terms)
            fns["wgmma_f32_split"] = lambda: fa.split_bf16_terms(q, k, v)
        fns.update(others)
        t = timed_in_turns(fns)
        plain_ms = cuda_ms(lambda: fa.reference_attention_fwd(
            q, k, v, causal=causal, bias=bias), iters=5)
        B, H, Lq, D = q.shape
        bound_ms, bound_by = attention_bound_ms(
            B, H, Lq, k.shape[2], D, causal, q.element_size(),
            0 if bias is None else bias.numel() * bias.element_size(),
            tensor_cores=route != "fma", term_pairs=_term_pairs(route, q.dtype))
        ms = t["kernel"]["median"]
        results[name] = dict(shape=[B, H, Lq, k.shape[2], D],
                             dtype=_dtype_name(q), causal=causal,
                             bias=bias is not None, route=route, **num,
                             lse_max_abs_err=lse_err, tol=tol,
                             replay_bit_exact=True,
                             ms=ms, ms_range=[t["kernel"]["min"], t["kernel"]["max"]],
                             plain_ms=plain_ms,
                             library_ms=t["library"]["median"],
                             library_ms_range=[t["library"]["min"],
                                               t["library"]["max"]],
                             bound_ms=bound_ms, bound_by=bound_by,
                             roofline_share=bound_ms / ms)
        for other, launch in others.items():
            # on no path; held to its own route's tolerance here
            o_other, _ = launch()
            err = check_close(f"{name} {other}", o_other, o_ref,
                              output_tolerance(o_ref, other))
            bound, by = attention_bound_ms(
                B, H, Lq, k.shape[2], D, causal, q.element_size(),
                0 if bias is None else bias.numel() * bias.element_size(),
                tensor_cores=other != "fma",
                term_pairs=_term_pairs(other, q.dtype))
            results[name].update({
                f"{other}_ms": t[other]["median"],
                f"{other}_ms_range": [t[other]["min"], t[other]["max"]],
                f"{other}_max_abs_err": err["max_abs_err"],
                f"{other}_bound_ms": bound, f"{other}_bound_by": by})
        if "wgmma_f32_split" in t:
            s = t["wgmma_f32_split"]
            results[name].update(wgmma_f32_split_ms=s["median"],
                                 wgmma_f32_split_ms_range=[s["min"],
                                                           s["max"]])
        emit("kernels", case=name, **results[name])
    return results


def _sdpa_fns(q, k, v, do, bias, causal):
    """The library yardstick of the backward, as two callables: the
    forward of F.scaled_dot_product_attention, and its forward plus
    backward through ``torch.autograd.grad`` (nothing accumulates into
    ``.grad``). The backward's time is the difference of their medians."""
    import torch
    import torch.nn.functional as F

    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

    def fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qg, kg, vg, attn_mask=bias,
                                           is_causal=causal)

    def fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=bias,
                                           is_causal=causal)
        torch.autograd.grad(o, (qg, kg, vg), do)

    return fwd, fwd_bwd


def _both(route):
    """The routes of a backward case whose dQ and dK/dV take one route."""
    return {"dq": route, "dkv": route}


def _bwd_cases(g):
    """(name, q, k, v, dO, causal, bias, routes) of the backward checks;
    ``routes`` holds the route of the dQ and of the dK/dV kernel."""
    import torch

    def rn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    cases = []
    for dtype, route in ((torch.bfloat16, "wgmma"),
                         (torch.float32, "wgmma_f32")):
        # the training step's shape; q/k/v views of the fused qkv and dO a
        # view of the [B, L, H, D] gradient, as autograd hands them over
        q, k, v = _views(g, 2, 1024, 16, 128, dtype)
        do = rn(2, 1024, 16, 128).to(dtype).transpose(1, 2)
        cases.append((f"train_{_dtype_name(q)}_B2_L1024", q, k, v, do, True,
                      None, _both(route)))
    for dtype, D, H, route in ((torch.float32, 128, 16, "wgmma_f32"),
                               (torch.bfloat16, 64, 16, "wgmma"),
                               (torch.float32, 256, 8, "wgmma_f32"),
                               (torch.float16, 128, 16, "wgmma_f16"),
                               (torch.float16, 256, 8, "wgmma_f16")):
        q, k, v = (rn(1, H, n, D).to(dtype) for n in (384, 640, 640))
        cases.append((f"bias_noncausal_{_dtype_name(q)}_d{D}_Lq384_Lk640", q,
                      k, v, rn(1, H, 384, D).to(dtype), False,
                      rn(1, H, 384, 640), _both(route)))
    # a trained bias under the causal mask: dS of the key tiles no row of a
    # query tile sees must come back as zeros (also at D = 256: bf16, where
    # two warpgroups share the zeroing, and float32)
    for dtype, D, H, route in ((torch.bfloat16, 128, 16, "wgmma"),
                               (torch.float32, 128, 16, "wgmma_f32"),
                               (torch.bfloat16, 256, 8, "wgmma"),
                               (torch.float32, 256, 8, "wgmma_f32")):
        q, k, v, do = (rn(1, H, 1024, D).to(dtype) for _ in range(4))
        d256 = "_d256" if D == 256 else ""
        cases.append((f"causal_bias_{_dtype_name(q)}{d256}_L1024", q, k, v,
                      do, True, rn(1, H, 1024, 1024), _both(route)))
    for dtype, D, H, route in ((torch.float32, 128, 16, "wgmma_f32"),
                               (torch.bfloat16, 128, 16, "wgmma"),
                               (torch.float32, 256, 8, "wgmma_f32"),
                               (torch.float16, 128, 16, "wgmma_f16"),
                               (torch.float16, 256, 8, "wgmma_f16")):
        q, k, v = _views(g, 1, 1500, H, D, dtype)
        d256 = "_d256" if D == 256 else ""
        cases.append((f"ragged_causal_{_dtype_name(q)}{d256}_L1500", q, k, v,
                      rn(1, 1500, H, D).to(dtype).transpose(1, 2), True,
                      None, _both(route)))
    # D = 64 at the training batch and at bench_gpt_primary's batch of 8,
    # and D = 256 (float16 at two shapes: one wave of 128 CTAs, and 512)
    for dtype, D, B, H, routes in (
            (torch.float32, 64, 2, 16, _both("wgmma_f32")),
            (torch.float32, 256, 1, 8, _both("wgmma_f32")),
            (torch.float16, 64, 2, 16, _both("wgmma_f16")),
            (torch.float16, 256, 1, 8, _both("wgmma_f16")),
            (torch.float16, 256, 2, 16, _both("wgmma_f16")),
            (torch.bfloat16, 64, 2, 16, _both("wgmma")),
            (torch.bfloat16, 64, 8, 16, _both("wgmma")),
            (torch.bfloat16, 256, 1, 8, _both("wgmma")),
            (torch.bfloat16, 256, 2, 16, _both("wgmma"))):
        q, k, v, do = (rn(B, H, 1024, D).to(dtype) for _ in range(4))
        cases.append((f"d{D}_causal_{_dtype_name(q)}_B{B}_L1024", q, k, v, do,
                      True, None, routes))
    # one rank's attention in the world-2 runs, as its autograd hands it
    # over: half the batch (ZeRO) and half the heads (mp = 2)
    for name, B, H in ((DIST_ZERO_BWD, 4, 16), (DIST_MP_BWD, 8, 8)):
        q, k, v = _views(g, B, 1024, H, 64, torch.bfloat16)
        do = rn(B, 1024, H, 64).to(torch.bfloat16).transpose(1, 2)
        cases.append((name, q, k, v, do, True, None, _both("wgmma")))
    # the attention of the D = 256 step (bf16), of the float32 D = 256 run
    # and of the float16 D = 256 step, as their autograd hands it over
    for name, dtype, route in ((D256_STEP_BWD, torch.bfloat16, "wgmma"),
                               (D256_F32_BWD, torch.float32, "wgmma_f32"),
                               (D256_FP16_STEP_BWD, torch.float16,
                                "wgmma_f16")):
        q, k, v = _views(g, TRAIN_BATCH, TRAIN_SEQ, D256_STEP_HEADS, 256,
                         dtype)
        do = rn(TRAIN_BATCH, TRAIN_SEQ, D256_STEP_HEADS, 256).to(
            dtype).transpose(1, 2)
        cases.append((name, q, k, v, do, True, None, _both(route)))
    # float16 at D = 256 with dO at a loss scale: dP passes 65504
    q, k, v = (rn(1, 8, 1024, 256).half() for _ in range(3))
    do = (rn(1, 8, 1024, 256) * F16_LOSS_SCALE).half()
    cases.append((F16_D256_LOSS_SCALE_BWD, q, k, v, do, True, None,
                  _both("wgmma_f16")))
    # Llama-2-7B's training attention, as its autograd hands it over, in
    # bf16 (wgmma) and float16 (wgmma_f16)
    for name, dtype, route in ((LLAMA_TRAIN_BWD, torch.bfloat16, "wgmma"),
                               (F16_LLAMA_BWD, torch.float16, "wgmma_f16")):
        q, k, v = _blhd_views(g, 1, LLAMA_SEQ, LLAMA_HEADS, 128, dtype)
        do = rn(1, LLAMA_SEQ, LLAMA_HEADS, 128).to(dtype).transpose(1, 2)
        cases.append((name, q, k, v, do, True, None, _both(route)))
    # the float16 GPT step's attention (fp16_training), as its autograd
    # hands it over
    q, k, v = _views(g, TRAIN_BATCH, TRAIN_SEQ, 16, 128, torch.float16)
    do = rn(TRAIN_BATCH, TRAIN_SEQ, 16, 128).half().transpose(1, 2)
    cases.append((F16_TRAIN_BWD, q, k, v, do, True, None,
                  _both("wgmma_f16")))
    return cases


# the cases at which the FMA dQ and dK/dV kernels, which the tensor-core ones
# replace (the wgmma_f32 pair at float32 D = 64, 128 and 256, the wgmma pair
# at bf16 D = 256), are timed beside them; at the float32 ones they are also
# held to the backward's tolerance
FMA_COMPARED = ("train_float32_B2_L1024", "d64_causal_float32_B2_L1024",
                "d256_causal_float32_B1_L1024", D256_F32_BWD,
                "d256_causal_bfloat16_B1_L1024",
                "d256_causal_bfloat16_B2_L1024", D256_STEP_BWD)


# the float16 cases at which the wgmma_f32 dQ and dK/dV, which the wgmma_f16
# kernels replace (at D = 128 and at D = 256), are checked and timed beside
# them
F16_COMPARED = (F16_TRAIN_BWD, F16_LLAMA_BWD, "d256_causal_float16_B1_L1024",
                "d256_causal_float16_B2_L1024")


def _f32_route_bwd_fns(fa, q, k, v, bias, do, lse, delta, causal, emit_ds):
    """The float16 wgmma_f32 dQ and dK/dV on the same inputs, launched
    directly (no route takes them), on q, k, v and dO's bf16 terms split
    once here; ``{"dq_wgmma_f32", "dkv_wgmma_f32"}``, each returning its
    gradients."""
    import torch

    terms = fa._backward_terms(q, k, v, do)

    def dq():
        ds = (torch.empty(*q.shape[:3], k.shape[2], device=q.device)
              if emit_ds else None)
        out = fa._empty_like_rows(q)
        fa._launch_bwd_sm90("dq", "wgmma_f32", q, k, v, bias, do, lse, delta,
                            out, ds, out.stride()[:3], causal, 0.0, 0, terms)
        return {"dq": out}

    def dkv():
        dk, dv = fa._empty_like_rows(k), fa._empty_like_rows(v)
        fa._launch_bwd_sm90("dkv", "wgmma_f32", q, k, v, bias, do, lse,
                            delta, dk, dv, (*dk.stride()[:3], *dv.stride()[:3]),
                            causal, 0.0, 0, terms)
        return {"dk": dk, "dv": dv}

    return {"dq_wgmma_f32": dq, "dkv_wgmma_f32": dkv}


def _fma_bwd_fns(fa, q, k, v, bias, do, lse, delta, causal, emit_ds):
    """The FMA dQ and dK/dV kernels on the same inputs, launched directly
    (no route takes them); ``{"dq_fma", "dkv_fma"}``, each returning its
    gradients."""
    import torch

    def dq_fma():
        ds = (torch.empty(*q.shape[:3], k.shape[2], device=q.device)
              if emit_ds else None)
        dq = fa._empty_like_rows(q)
        fa._launch_bwd("dq", q, k, v, bias, do, lse, delta, {"dq": dq}, ds,
                       causal, 0.0, 0)
        return {"dq": dq}

    def dkv_fma():
        dk, dv = fa._empty_like_rows(k), fa._empty_like_rows(v)
        fa._launch_bwd("dkv", q, k, v, bias, do, lse, delta,
                       {"dk": dk, "dv": dv}, None, causal, 0.0, 0)
        return {"dk": dk, "dv": dv}

    return {"dq_fma": dq_fma, "dkv_fma": dkv_fma}


def phase_backward(seed: int) -> dict:
    """The dQ and dK/dV kernels against the plain backward, the
    tensor-core kernels replayed bit for bit, and each kernel, the split
    pre-pass and the whole backward wrapper timed beside SDPA's backward
    (and beside the kernels a route replaced: FMA_COMPARED, F16_COMPARED)."""
    import torch

    from paddle_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 1)
    results = {}
    for name, q, k, v, do, causal, bias, want in _bwd_cases(g):
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, bias=bias)
        fa.reset_launch_counts()
        got = fa.flash_attention_bwd(q, k, v, bias, o, lse, do, causal)
        torch.cuda.synchronize()
        routes = {w: _route_of(fa, w) for w in ("dq", "dkv")}
        if routes != want:
            raise AssertionError(f"{name}: backward took {fa.launch_counts()}"
                                 f", expected {want}")
        dq, dk, dv, ds = fa.reference_attention_bwd(q, k, v, bias, o, lse, do,
                                                    causal)
        refs = {"dq": dq, "dk": dk, "dv": dv}
        if bias is not None:
            refs["dbias"] = ds.sum(0, keepdim=True)
        do_scale = F16_LOSS_SCALE if name == F16_D256_LOSS_SCALE_BWD else 1.0
        if do_scale > 1.0:
            dp_max = torch.einsum("bhqd,bhkd->bhqk", do.float(),
                                  v.float()).abs().max().item()
            if not dp_max > 65504:
                raise AssertionError(f"{name}: dP reaches {dp_max}, not past "
                                     f"float16's range")
        errs = {}
        for (key, ref), x in zip(refs.items(), got):
            errs[key] = check_close(f"{name} {key}", x, ref,
                                    bwd_tolerance(ref, do_scale))
        if bias is not None and causal and not bool((got[3].triu(1) == 0).all()):
            raise AssertionError(f"{name}: dS is not zero above the diagonal")
        delta = (do.float() * o.float()).sum(-1).contiguous()
        emit_ds = bias is not None
        used = set(routes.values())
        do_k = (do if not used & {"wgmma", "wgmma_f16"} or fa._tma_ok(do)
                else do.contiguous())
        # the wgmma_f32 kernels read the split's terms: timed apart from it
        terms = fa._backward_terms(q, k, v, do_k) if "wgmma_f32" in used \
            else None

        def dq_call():
            return fa.flash_attention_bwd_dq(q, k, v, bias, do_k, lse, delta,
                                             causal, emit_ds=emit_ds,
                                             terms=terms)

        def dkv_call():
            return fa.flash_attention_bwd_dkv(q, k, v, bias, do_k, lse, delta,
                                              causal, terms=terms)

        # no atomics: the same inputs give the same dQ (and dS), dK, dV from
        # every tensor-core kernel
        calls = [c for w, c in (("dq", dq_call), ("dkv", dkv_call))
                 if routes[w] != "fma"]
        if calls:
            first, again = ([x for c in calls for x in c() if x is not None]
                            for _ in range(2))
            if not all(torch.equal(a, b) for a, b in zip(first, again)):
                raise AssertionError(f"{name}: the {routes} backward does "
                                     f"not replay bit for bit")
        sdpa_fwd, sdpa_fwd_bwd = _sdpa_fns(q, k, v, do, bias, causal)
        fns = {"dq": dq_call, "dkv": dkv_call,
               "bwd": lambda: fa.flash_attention_bwd(q, k, v, bias, o, lse,
                                                     do, causal),
               "sdpa_fwd": sdpa_fwd, "sdpa_fwd_bwd": sdpa_fwd_bwd}
        if terms is not None:
            fns["split"] = lambda: fa._backward_terms(q, k, v, do_k)
        fma_errs, f32_errs = {}, {}
        if name in F16_COMPARED:
            fns.update(_f32_route_bwd_fns(fa, q, k, v, bias, do_k, lse,
                                          delta, causal, emit_ds))
            fns["split"] = lambda: fa._backward_terms(q, k, v, do_k)
            f32_out = {**fns["dq_wgmma_f32"](), **fns["dkv_wgmma_f32"]()}
            torch.cuda.synchronize()
            f32_errs = {key: check_close(f"{name} wgmma_f32 {key}", x,
                                         refs[key], bwd_tolerance(refs[key]))
                        for key, x in f32_out.items()}
        if name in FMA_COMPARED:
            fns.update(_fma_bwd_fns(fa, q, k, v, bias, do_k, lse, delta,
                                    causal, emit_ds))
            if q.dtype == torch.float32:
                # on no route: held to the float32 tolerance here
                fma_out = {**fns["dq_fma"](), **fns["dkv_fma"]()}
                torch.cuda.synchronize()
                fma_errs = {key: check_close(f"{name} fma {key}", x,
                                             refs[key], bwd_tolerance(refs[key]))
                            for key, x in fma_out.items()}
        t = timed_in_turns(fns)
        plain_ms = cuda_ms(lambda: fa.reference_attention_bwd(
            q, k, v, bias, o, lse, do, causal), iters=5)
        library_ms = t["sdpa_fwd_bwd"]["median"] - t["sdpa_fwd"]["median"]
        B, H, Lq, D = q.shape
        Lk = k.shape[2]
        common = (B, H, Lq, Lk, D, causal, q.element_size(),
                  0 if bias is None else bias.numel() * 4)
        dq_bound, dq_by = bwd_bound_ms(
            "dq", *common, B * H * Lq * Lk * 4 if emit_ds else 0,
            tensor_cores=routes["dq"] != "fma",
            term_pairs=_term_pairs(routes["dq"], q.dtype))
        dkv_bound, dkv_by = bwd_bound_ms(
            "dkv", *common, 0, tensor_cores=routes["dkv"] != "fma",
            term_pairs=_term_pairs(routes["dkv"], q.dtype))
        dq_ms, dkv_ms = t["dq"]["median"], t["dkv"]["median"]
        # the wgmma_f16 kernels at D = 256: the longest CTA's floor too
        floors = {}
        if D == 256 and set(routes.values()) == {"wgmma_f16"}:
            floors = {f"{w}_cta_floor_ms": longest_cta_floor_ms(
                w, Lq, Lk, D, causal, F16_D256_PRODUCTS[w])
                for w in ("dq", "dkv")}
        fma = {}
        for w in ("dq", "dkv"):
            for other in ("fma", "wgmma_f32"):
                if f"{w}_{other}" not in t:
                    continue
                # the float16 wgmma_f32 pair does the same work: one
                # float16 product a pair at the least (_term_pairs)
                bound, by = bwd_bound_ms(
                    w, *common, B * H * Lq * Lk * 4 if emit_ds and w == "dq"
                    else 0, tensor_cores=other != "fma")
                f = f"{w}_{other}"
                fma.update({f"{f}_ms": t[f]["median"],
                            f"{f}_ms_range": [t[f]["min"], t[f]["max"]],
                            f"{f}_bound_ms": bound, f"{f}_bound_by": by})
        results[name] = dict(
            shape=[B, H, Lq, Lk, D], dtype=_dtype_name(q), causal=causal,
            bias=bias is not None, routes=routes, errors=errs,
            replay_bit_exact=bool(calls) or None,
            tol=("2 bf16 ulps + 1e-5 of max" if q.dtype == torch.bfloat16
                 else f"rtol {BWD_RTOL} atol {BWD_ATOL * do_scale}"
                 + (" + 1 float16 ulp" if q.dtype == torch.float16 else "")),
            do_scale=do_scale,
            dq_ms=dq_ms, dq_ms_range=[t["dq"]["min"], t["dq"]["max"]],
            dkv_ms=dkv_ms, dkv_ms_range=[t["dkv"]["min"], t["dkv"]["max"]],
            bwd_ms=t["bwd"]["median"],
            bwd_ms_range=[t["bwd"]["min"], t["bwd"]["max"]],
            split_ms=t["split"]["median"] if "split" in t else None,
            **floors, **fma, fma_errors=fma_errs or None,
            wgmma_f32_errors=f32_errs or None,
            dq_bound_ms=dq_bound, dq_bound_by=dq_by,
            dkv_bound_ms=dkv_bound, dkv_bound_by=dkv_by,
            plain_ms=plain_ms, library_ms=library_ms,
            library_fwd_bwd_ms_range=[t["sdpa_fwd_bwd"]["min"],
                                      t["sdpa_fwd_bwd"]["max"]],
            library_fwd_ms_range=[t["sdpa_fwd"]["min"], t["sdpa_fwd"]["max"]],
            dq_roofline_share=dq_bound / dq_ms,
            dkv_roofline_share=dkv_bound / dkv_ms)
        emit("kernels_bwd", case=name, **results[name])
    return results


def _plain_bits(fa, seed, B, H, L):
    import torch

    def ar(n, dim):
        shape = [1, 1, 1, 1]
        shape[dim] = n
        return torch.arange(n, device="cuda").view(shape)

    return fa.philox_bits(seed, ar(L, 3), ar(L, 2), ar(H, 1),
                          ar(B, 0)).expand(B, H, L, L)


def phase_dropout(seed: int) -> dict:
    """The CUDA Philox mask against the plain one, its keep rate, replay,
    and forward/backward at p = DROPOUT_P against the plain versions given
    the same mask."""
    import torch

    from paddle_tpu_torch.kernels import flash_attention as fa

    B, H, L, D = 2, 16, 1024, 128
    mseed = 1234 + seed
    bits = fa.dropout_bits(mseed, B, H, L, L, device="cuda")
    if not torch.equal(bits, _plain_bits(fa, mseed, B, H, L)):
        raise AssertionError("CUDA dropout bits differ from the plain Philox")
    window = fa.dropout_bits(mseed, B, H, 100, 300, device="cuda",
                             row0=517, col0=211)
    if not torch.equal(window, bits[:, :, 517:617, 211:511]):
        raise AssertionError("a window of the CUDA mask differs from the "
                             "same window of the full mask")
    if not torch.equal(bits, fa.dropout_bits(mseed, B, H, L, L, device="cuda")):
        raise AssertionError("the CUDA mask does not replay its seed")
    threshold = min(int(DROPOUT_P * 2 ** 32), 2 ** 32 - 1)
    n = bits.numel()
    kept = int((bits >= threshold).sum())
    sigma = math.sqrt(n * DROPOUT_P * (1 - DROPOUT_P))
    if abs(kept - n * (1 - DROPOUT_P)) > 5 * sigma:
        raise AssertionError(f"keep rate {kept / n} outside 5 sigma of "
                             f"{1 - DROPOUT_P}")
    del bits, window
    keep = fa.dropout_mask(mseed, B, H, L, L, DROPOUT_P, "cuda")

    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 2)
    # the least time one kernel could take to draw the mask of this run's
    # kept (causal) pairs on the CUDA cores' integer units
    mask_bound_ms = (kept_pairs(L, L, True) * B * H * PHILOX_OPS
                     / PEAK_INT32_OPS * 1e3)
    out = dict(mask_bits_equal_plain=True, keep_rate=kept / n,
               keep_rate_sigma=sigma / n, mask_bound_ms=mask_bound_ms,
               mask_bound_by="operations")
    # D = 256 at both of its timed shapes and at the D = 256 step's, and
    # float32 at D = 256; float16 (the wgmma_f16 forward and backward, at
    # D 128 and 256): the mask
    # of the first Bc batches and Hc heads is the corner of the full one
    # (Philox keys by (b, h, row, col))
    for dtype, D, Bc, Hc in ((torch.float32, D, B, H),
                             (torch.bfloat16, D, B, H),
                             (torch.float16, D, B, H),
                             (torch.float16, 256, 1, 8),
                             (torch.bfloat16, 256, B, H),
                             (torch.bfloat16, 256, 1, 8),
                             (torch.bfloat16, 256, TRAIN_BATCH,
                              D256_STEP_HEADS),
                             (torch.float32, 256, 1, 8)):
        kp = keep[:Bc, :Hc]
        q, k, v = _views(g, Bc, L, Hc, D, dtype)
        do = torch.randn(Bc, L, Hc, D, generator=g, device="cuda") \
            .to(dtype).transpose(1, 2)
        fa.reset_launch_counts()
        o, lse = fa.flash_attention_fwd(q, k, v, causal=True,
                                        dropout_p=DROPOUT_P, seed=mseed)
        o2, _ = fa.flash_attention_fwd(q, k, v, causal=True,
                                       dropout_p=DROPOUT_P, seed=mseed)
        got = fa.flash_attention_bwd(q, k, v, None, o, lse, do, True,
                                     DROPOUT_P, mseed)
        got2 = fa.flash_attention_bwd(q, k, v, None, o, lse, do, True,
                                      DROPOUT_P, mseed)
        torch.cuda.synchronize()
        routes = {w: fa.kernel_route(dtype, D, w) for w in ("fwd", "dq", "dkv")}
        if {w: _route_of(fa, w) for w in routes} != routes:
            raise AssertionError(f"dropout {dtype}: launches "
                                 f"{fa.launch_counts()}, expected {routes}")
        if not (torch.equal(o, o2)
                and all(torch.equal(a, b) for a, b in zip(got[:3], got2[:3]))):
            raise AssertionError("dropout kernels do not replay a fixed seed")
        o_ref, lse_ref = fa.reference_attention_fwd(q, k, v, causal=True,
                                                    keep_mask=kp)
        d256 = "_d256" if D == 256 else ""
        name = f"dropout_{_dtype_name(q)}{d256}_B{Bc}_H{Hc}_L1024"
        errs = {"o": check_close(f"{name} o", o, o_ref,
                                 output_tolerance(o_ref, routes["fwd"]))}
        errs["lse"] = check_close(f"{name} lse", lse, lse_ref,
                                  lse_tolerance(lse_ref, routes["fwd"]))
        ref = fa.reference_attention_bwd(q, k, v, None, o, lse, do, True, kp)
        for key, x, y in zip(("dq", "dk", "dv"), got, ref):
            errs[key] = check_close(f"{name} {key}", x, y, bwd_tolerance(y))
        delta = (do.float() * o.float()).sum(-1).contiguous()
        do_k = (do if not set(routes.values()) & {"wgmma", "wgmma_f16"}
                or fa._tma_ok(do) else do.contiguous())
        # each kernel's least time: its products at p = 0 or this case's
        # mask draws, whichever is larger (they run on different units)
        mask_ms = (kept_pairs(L, L, True) * Bc * Hc * PHILOX_OPS
                   / PEAK_INT32_OPS * 1e3)
        tc = {w: r != "fma" for w, r in routes.items()}
        pairs = {w: _term_pairs(r, dtype) for w, r in routes.items()}
        common = (Bc, Hc, L, L, D, True, q.element_size(), 0)
        bounds = {"fwd": attention_bound_ms(*common, tensor_cores=tc["fwd"],
                                            term_pairs=pairs["fwd"])[0],
                  **{w: bwd_bound_ms(w, *common, 0, tensor_cores=tc[w],
                                     term_pairs=pairs[w])[0]
                     for w in ("dq", "dkv")}}
        out[name] = dict(
            shape=[Bc, Hc, L, L, D], errors=errs, routes=routes,
            mask_bound_ms=mask_ms,
            **{f"{w}_bound_ms": max(t, mask_ms) for w, t in bounds.items()},
            fwd_ms=cuda_ms(lambda: fa.flash_attention_fwd(
                q, k, v, causal=True, dropout_p=DROPOUT_P, seed=mseed)),
            dq_ms=cuda_ms(lambda: fa.flash_attention_bwd_dq(
                q, k, v, None, do_k, lse, delta, True, DROPOUT_P, mseed)),
            dkv_ms=cuda_ms(lambda: fa.flash_attention_bwd_dkv(
                q, k, v, None, do_k, lse, delta, True, DROPOUT_P, mseed)))
    emit("dropout", p=DROPOUT_P, shape=[B, H, L, L], **out)
    return out


def _serve_and_check(model, requests, slots: int, geo: dict):
    """Serve ``requests`` behind ``InferenceServer(model, slots)`` and hold
    the run to the serving checks: every request completed, none requeued
    or failed, one prefill each, the flash forward launched on the
    wgmma_f32 route only (float32 prefill), it and its split exactly once
    per layer per prefill, and every stream equal to a solo generate()
    with the same arguments. Returns ``(handles, snapshot, launches,
    split launches, wall seconds)``."""
    import numpy as np

    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.serving import InferenceServer

    server = InferenceServer(model, slots=slots, device="cuda", **geo)
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    handles = [server.submit(**r) for r in requests]
    streams = [h.result(timeout=900) for h in handles]
    wall_s = time.perf_counter() - t0
    counts = fa.launch_counts()["fwd"]
    launches, split_launches = counts["wgmma_f32"], fa.split_bf16_terms.launches
    if counts["fma"] or counts["wgmma"]:
        raise AssertionError(f"float32 prefill launched a forward other than "
                             f"wgmma_f32: {fa.launch_counts()}")
    server.shutdown(timeout=60)
    snap = server.snapshot()

    if snap["requests_completed"] != len(requests):
        raise AssertionError(f"{snap['requests_completed']} of "
                             f"{len(requests)} requests completed")
    # the server recovers from a fault in admit/step by resetting the engine
    # and re-running the request; a smoke run must need no such recovery
    if snap["requests_requeued"] or snap["requests_failed"]:
        raise AssertionError(f"{snap['requests_requeued']} requests requeued, "
                             f"{snap['requests_failed']} failed")
    layers = model.cfg.num_layers
    need = layers * len(requests)
    if snap["prefills"] != len(requests) or (launches, split_launches) != (need, need):
        raise AssertionError(f"wgmma_f32 forward launched {launches} times "
                             f"and its split {split_launches} over "
                             f"{snap['prefills']} prefills in the served run, "
                             f"expected exactly {need} each ({layers} "
                             f"layers x {len(requests)} requests)")
    for r, got in zip(requests, streams):
        solo = model.generate(r["prompt"][None], **{k: v for k, v in r.items()
                                                     if k != "prompt"}, **geo)[0]
        if got.shape != (r["max_new_tokens"],) or not np.array_equal(got, solo):
            raise AssertionError(f"served stream {got.tolist()} != solo "
                                 f"generate {solo.tolist()} (prompt "
                                 f"{len(r['prompt'])})")
    return handles, snap, launches, split_launches, wall_s


def _prefill_logits_err(model, prompt, cache_len: int) -> float:
    """The kernel path against the plain-attention path, end to end: the
    largest difference of one prompt's prefill logits through every layer
    (raises past PREFILL_LOGITS_TOL or on a non-finite logit)."""
    import torch

    from paddle_tpu_torch.models.generation import init_cache

    ids = torch.as_tensor(prompt[None], device="cuda")
    with torch.inference_mode():
        def prefill_logits():
            return model(ids, cache=init_cache(model, 1, cache_len),
                         position_offset=0)[0]

        flash_logits = prefill_logits()
        model.cfg.use_flash_attention = False
        try:
            plain_logits = prefill_logits()
        finally:
            model.cfg.use_flash_attention = True
    if not bool(torch.isfinite(flash_logits).all()):
        raise AssertionError("non-finite prefill logits")
    err = (flash_logits - plain_logits).abs().max().item()
    if err > PREFILL_LOGITS_TOL:
        raise AssertionError(f"prefill logits, kernel vs plain attention: "
                             f"max|err| {err} > {PREFILL_LOGITS_TOL}")
    return err


def _model_cls(cfg):
    """The port's causal-LM class of ``cfg``'s family."""
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    return LlamaForCausalLM if isinstance(cfg, LlamaConfig) else GPTForCausalLM


def _gpt_serving_config(**overrides):
    """gpt_1p3b for serving: dropout 0, bf16 KV cache."""
    from paddle_tpu_torch.models.gpt import gpt_1p3b

    return gpt_1p3b(hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                    dtype="bfloat16", **overrides)


def _serving_model(seed: int, cfg):
    """A model of ``cfg`` for serving (float32 parameters, random weights
    from ``seed``), warmed up outside any measured run (cuBLAS handles,
    allocator pools); ``(model, build s)``."""
    import numpy as np
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    model = _model_cls(cfg)(cfg, device="cuda", generator=gen).eval()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    model.generate(np.zeros((1, 8), np.int64), max_new_tokens=2,
                   max_length=cfg.max_position_embeddings)
    torch.cuda.synchronize()
    return model, build_s


def phase_serving(seed: int) -> dict:
    """gpt_1p3b (full width, random weights from ``seed``) behind
    InferenceServer(slots=4, max_length=2048): six requests held to the
    serving checks (_serve_and_check), and one prompt's prefill logits
    through all 24 layers against plain attention's."""
    import numpy as np
    import torch

    torch.cuda.reset_peak_memory_stats()
    model, build_s = _serving_model(seed, _gpt_serving_config())
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    requests = [dict(prompt=rng.integers(0, cfg.vocab_size, n), max_new_tokens=16)
                for n in (40, 300, 900, 1500, 1900)]
    requests.append(dict(prompt=rng.integers(0, cfg.vocab_size, 700),
                         max_new_tokens=16, do_sample=True, seed=7,
                         temperature=0.8, top_p=0.9))
    geo = dict(max_length=2048)
    handles, snap, launches, split_launches, wall_s = _serve_and_check(
        model, requests, 4, geo)
    # the prefill logits of one full-width prompt through all 24 layers
    logit_err = _prefill_logits_err(model, requests[1]["prompt"], 512)

    out = dict(model="gpt_1p3b", params=sum(p.numel() for p in model.parameters()),
               model_build_s=build_s, requests=len(requests),
               prompt_lens=[len(r["prompt"]) for r in requests],
               streams_equal_solo=True, flash_launches=launches,
               split_launches=split_launches,
               prefills=snap["prefills"], decode_steps=snap["decode_steps"],
               wall_s=wall_s, tokens=snap["tokens_emitted"],
               tokens_per_s=snap["tokens_emitted"] / wall_s,
               ttft_ms=[h.ttft_s * 1e3 for h in handles],
               decode_ms_per_token=snap["inter_token"]["mean_ms"],
               decode_ms_per_token_p50=snap["inter_token"]["p50_ms"],
               prefill_logits_max_abs_err=logit_err,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               card=nvidia_smi_line())
    emit("serving", **out)
    return out


def phase_d256_prefill(seed: int) -> dict:
    """gpt_1p3b width with 8 heads of 256 (D = 256) and 2 layers, random
    weights from ``seed``, behind InferenceServer(slots=2,
    max_length=2048): two greedy prompts of D256_PREFILL_LENGTHS tokens, 8
    new tokens each, held to the serving checks (_serve_and_check: the
    wgmma_f32 forward at D = 256 once per layer per prefill), and the
    kernel path's prefill logits against plain attention's."""
    import numpy as np

    n = 2  # layers
    model, build_s = _serving_model(seed, _gpt_serving_config(
        num_layers=n, num_heads=D256_STEP_HEADS))
    rng = np.random.default_rng(seed + 3)
    requests = [dict(prompt=rng.integers(0, model.cfg.vocab_size, length),
                     max_new_tokens=8) for length in D256_PREFILL_LENGTHS]
    handles, snap, launches, split_launches, wall_s = _serve_and_check(
        model, requests, 2, dict(max_length=2048))
    logit_err = _prefill_logits_err(model, requests[0]["prompt"], 1024)
    out = dict(model="gpt_1p3b width, 8 heads of 256, 2 layers",
               head_dim=256, layers=n, model_build_s=build_s,
               prompt_lens=list(D256_PREFILL_LENGTHS), streams_equal_solo=True,
               flash_launches=launches, split_launches=split_launches,
               prefills=snap["prefills"], wall_s=wall_s,
               ttft_ms=[h.ttft_s * 1e3 for h in handles],
               prefill_logits_max_abs_err=logit_err)
    emit("d256_prefill", **out)
    return out


def _forward_launches(fa) -> tuple:
    """(wgmma_f32 forwards, forwards on any other route, splits) since
    the last reset."""
    fwd = fa.launch_counts()["fwd"]
    return (fwd["wgmma_f32"], sum(n for r, n in fwd.items() if r != "wgmma_f32"),
            fa.split_bf16_terms.launches)


def _solo_streams(model, requests, geo, kv_dtype=None) -> list:
    """Each request's stream from a solo generate() (the pool-less,
    batch-1 path) with the same arguments."""
    return [model.generate(r["prompt"][None], kv_dtype=kv_dtype, **geo,
                           **{k: v for k, v in r.items() if k != "prompt"})[0]
            for r in requests]


def _check_streams(label, requests, got, want) -> None:
    import numpy as np

    for r, a, b in zip(requests, got, want):
        if a.shape != (r["max_new_tokens"],) or not np.array_equal(a, b):
            raise AssertionError(f"{label}: stream {a.tolist()} != "
                                 f"{b.tolist()} (prompt {len(r['prompt'])})")


def _check_clean(label, snap, n) -> None:
    """``n`` requests completed, none requeued, failed or expired."""
    if (snap["requests_completed"], snap["requests_requeued"],
            snap["requests_failed"], snap["requests_expired"]) != (n, 0, 0, 0):
        raise AssertionError(
            f"{label}: {snap['requests_completed']} of {n} completed, "
            f"{snap['requests_requeued']} requeued, {snap['requests_failed']} "
            f"failed, {snap['requests_expired']} expired")


def _pooled_server(model, geo, kv_dtype):
    from paddle_tpu_torch.serving import InferenceServer

    return InferenceServer(model, slots=4, device=model.device,
                           kv_dtype=kv_dtype,
                           prefix_cache=dict(OPTIONS_POOL), **geo)


def _pooled_run(model, requests, geo, kv_dtype, pool_less, first_shared: int):
    """Serve ``requests`` one after another behind a pooled
    InferenceServer (OPTIONS_POOL): the first sharer is cold, every later
    sharer hits the whole prefix, the unrelated request misses, and no
    flash forward or split launches. With the bf16 cache every stream
    equals the pool-less path's (``pool_less``). With the int8 cache a
    pooled admit's suffix attends the DEQUANTIZED cache, a miss at 0
    included (the reference's traced offset), where a pool-less prefill
    attends the un-quantized block: the two paths differ by design, so
    every stream is held to the same request served alone by a fresh
    pooled server (a cold admit through the same continuation), and the
    streams equal to the pool-less path's are counted."""
    import numpy as np

    from paddle_tpu_torch.kernels import flash_attention as fa

    server = _pooled_server(model, geo, kv_dtype)
    fa.reset_launch_counts()
    handles, streams = [], []
    for r in requests:   # one at a time: TTFT without queueing
        h = server.submit(**r)
        streams.append(h.result(timeout=900))
        handles.append(h)
    launches = _forward_launches(fa)
    server.shutdown(timeout=60)
    snap = server.snapshot()
    label = f"pooled admits (kv_dtype={kv_dtype})"
    _check_clean(label, snap, len(requests))
    if launches != (0, 0, 0):
        raise AssertionError(f"{label} launched flash forwards (wgmma_f32, "
                             f"other, split) {launches}; expected none")
    hits = [h.cache_hit_tokens for h in handles]
    shared = len(OPTIONS_SUFFIXES)
    need = [0] + [first_shared] * (shared - 1) + [0] * (len(requests) - shared)
    if hits != need:
        raise AssertionError(f"{label}: prefix hits {hits}, expected {need}")
    equal_pool_less = int(sum(np.array_equal(a, b)
                              for a, b in zip(streams, pool_less)))
    if kv_dtype is None:
        _check_streams(f"{label} vs the pool-less path", requests, streams,
                       pool_less)
    else:
        alone = []
        for r in requests:
            solo_server = _pooled_server(model, geo, kv_dtype)
            alone.append(solo_server.submit(**r).result(timeout=900))
            solo_server.shutdown(timeout=60)
            del solo_server
        _check_streams(f"{label} vs served alone", requests, streams, alone)
    return dict(kv_dtype=kv_dtype or "bfloat16", cache_hit_tokens=hits,
                flash_launches=0, split_launches=0,
                cold_ttft_ms=handles[0].ttft_s * 1e3,
                hit_ttft_ms=[h.ttft_s * 1e3 for h in handles[1:shared]],
                unrelated_ttft_ms=handles[-1].ttft_s * 1e3,
                prefix_hit_rate=snap["prefix_hit_rate"],
                pool=snap["prefix_cache"],
                streams_equal_pool_less=equal_pool_less,
                streams_equal_served_alone=kv_dtype is not None)


def _int8_logits(model, prompt, cache_len: int) -> dict:
    """Prefill logits with the int8 and the bf16 cache (bit-identical:
    prefill attends the un-quantized block), and the teacher-forced
    relative logit drift of the int8 cache over KV_DRIFT_STEPS decode
    steps (the bf16 run's argmax chain fed to both)."""
    import torch

    from paddle_tpu_torch.models.generation import init_cache

    ids = torch.as_tensor(prompt[None], device=model.device)
    with torch.inference_mode():
        full = init_cache(model, 1, cache_len)
        quant = init_cache(model, 1, cache_len, kv_dtype="int8")
        lf, full = model(ids, cache=full, position_offset=0)
        lq, quant = model(ids, cache=quant, position_offset=0)
        if not torch.equal(lf[:, -1], lq[:, -1]):
            raise AssertionError("int8 cache: prefill logits differ from the "
                                 "bf16 cache's")
        worst, L = 0.0, ids.shape[1]
        tok = torch.argmax(lf[:, -1], dim=-1)
        for step in range(KV_DRIFT_STEPS):
            lf, full = model(tok[:, None], cache=full, position_offset=L + step)
            lq, quant = model(tok[:, None], cache=quant,
                              position_offset=L + step)
            a, b = lf[:, -1], lq[:, -1]
            worst = max(worst, ((a - b).abs().max() / a.abs().max()).item())
            tok = torch.argmax(a, dim=-1)
    if not worst < KV_DRIFT_LIMIT:
        raise AssertionError(f"int8 cache: teacher-forced logit drift {worst} "
                             f">= {KV_DRIFT_LIMIT}")
    return dict(prefill_logits_bit_identical=True, drift=worst,
                drift_limit=KV_DRIFT_LIMIT, drift_steps=KV_DRIFT_STEPS)


def _fair_run(model, seed: int) -> dict:
    """warmup(), then two tenants under fair queueing with token buckets:
    FAIR_LOUD requests from "loud" (its last ones rate-limited) and
    FAIR_QUIET from "quiet", all submitted before the worker takes any.
    The admission order must be the one the port's scheduler gives on the
    CPU for the same submit sequence and take budgets (deficit round
    robin, as the reference's), the quiet tenant is served within the
    first two rounds, and a request whose predicted wait exceeds its
    deadline is shed at the door; rate limits and sheds are counted,
    not failed."""
    import numpy as np

    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.serving import (FifoScheduler, InferenceServer,
                                          Overloaded, RateLimited, Request)

    opts = dict(max_length=2048, fair_queueing=True, tenant_rate=TENANT_RATE,
                tenant_burst=TENANT_BURST, shed_on_overload=True)
    server = InferenceServer(model, slots=4, device=model.device, **opts)
    fa.reset_launch_counts()
    warm = server.engine.warmup()
    warm_launches = _forward_launches(fa)
    takes = []
    real_take = server.scheduler.take

    def logged_take(free):
        admit, expired = real_take(free)
        takes.append((free, [r.id for r in admit]))
        return admit, expired

    server.scheduler.take = logged_take
    rng = np.random.default_rng(seed + 13)
    order = (["loud"] * (FAIR_LOUD // 2) + ["quiet"]
             + ["loud"] * (FAIR_LOUD - FAIR_LOUD // 2) + ["quiet"])
    accepted, limited = [], 0
    fa.reset_launch_counts()
    with server._cv:   # the worker takes nothing until all are queued
        for tenant in order:
            prompt = rng.integers(0, model.cfg.vocab_size,
                                  int(rng.integers(40, 200)))
            try:
                h = server.submit(prompt, max_new_tokens=8, tenant=tenant)
            except RateLimited:
                limited += 1
                continue
            accepted.append((tenant, h))
    for _, h in accepted:
        h.result(timeout=900)
    launches = _forward_launches(fa)
    fair_takes = list(takes)
    # the shed: the queue holds work again and the cadence is known, so a
    # request whose deadline is shorter than its predicted wait fails at
    # the door with Overloaded
    with server._cv:
        extra = [server.submit(rng.integers(0, model.cfg.vocab_size, 64),
                               max_new_tokens=4, tenant="quiet")
                 for _ in range(3)]
        try:
            server.submit(rng.integers(0, model.cfg.vocab_size, 64),
                          max_new_tokens=4, tenant="quiet", deadline=1e-3)
            shed = 0
        except Overloaded:
            shed = 1
    for h in extra:
        h.result(timeout=900)
    server.shutdown(timeout=60)
    snap = server.snapshot()
    _check_clean("fair queueing", snap, len(accepted) + len(extra))
    if (limited, snap["requests_rate_limited"]) != (FAIR_LOUD - int(TENANT_BURST),) * 2:
        raise AssertionError(f"fair queueing: {limited} rate-limited submits, "
                             f"{snap['requests_rate_limited']} counted; "
                             f"expected {FAIR_LOUD - int(TENANT_BURST)}")
    if (shed, snap["requests_shed"]) != (1, 1):
        raise AssertionError(f"fair queueing: {snap['requests_shed']} shed "
                             f"counted, the door shed raised: {bool(shed)}")
    # the same submit sequence and take budgets through the port's
    # scheduler on the CPU
    cpu = FifoScheduler(max_prefills_per_step=server.scheduler.max_prefills_per_step,
                        fair_queueing=True)
    ids = {}
    for tenant, h in accepted:
        r = Request(prompt=[0], tenant=tenant)
        ids[r.id] = h.request.id
        cpu.submit(r)
    want = [[ids[r.id] for r in cpu.take(free)[0]] for free, _ in fair_takes]
    got = [admitted for _, admitted in fair_takes]
    if got != want:
        raise AssertionError(f"fair queueing: admission order {got} != the "
                             f"scheduler's on the CPU {want}")
    tenant_of = {h.request.id: t for t, h in accepted}
    admitted = [tenant_of[i] for batch in got for i in batch]
    if "quiet" not in admitted[:4]:
        raise AssertionError(f"fair queueing: the quiet tenant waited behind "
                             f"the loud one: {admitted}")
    prefills = len(accepted)
    layers = model.cfg.num_layers
    if launches != (layers * prefills, 0, layers * prefills):
        raise AssertionError(f"fair queueing: forwards (wgmma_f32, other, "
                             f"split) {launches} over {prefills} prefills")
    return dict(warmup=warm, warmup_launches=list(warm_launches),
                accepted=len(accepted), rate_limited=limited, shed=shed,
                admission_tenants=admitted, takes=len(fair_takes),
                order_equals_cpu_scheduler=True, flash_launches=launches[0],
                split_launches=launches[2],
                bucket_levels=server.scheduler.bucket_levels())


def phase_serving_options(seed: int) -> dict:
    """gpt_1p3b (full width, float32 parameters, bf16 cache, random
    weights from ``seed``) behind InferenceServer(slots=4,
    max_length=2048) with the serving options: (a) the prefix pool
    (OPTIONS_POOL) on six requests sharing a 1024-token prefix and one
    unrelated request, (b) the int8 cache (its bytes per slot, prefill
    logits, teacher-forced drift, a pool-less int8 server, and (a) again
    on the int8 cache and pool), (c) warmup() and fair queueing with
    token buckets and shedding (_fair_run)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.serving import InferenceServer

    mem_before = _check_freed("serving_options")
    model, build_s = _serving_model(seed, _gpt_serving_config())
    cfg = model.cfg
    rng = np.random.default_rng(seed + 11)
    prefix = rng.integers(0, cfg.vocab_size, OPTIONS_PREFIX)
    requests = [dict(prompt=np.concatenate(
        [prefix, rng.integers(0, cfg.vocab_size, n)]), max_new_tokens=16)
        for n in OPTIONS_SUFFIXES]
    requests[3].update(do_sample=True, seed=11, temperature=0.8, top_p=0.9)
    requests.append(dict(prompt=rng.integers(0, cfg.vocab_size,
                                             OPTIONS_UNRELATED),
                         max_new_tokens=16))
    geo = dict(max_length=2048)
    out = dict(model="gpt_1p3b", model_build_s=build_s,
               mem_before_gib=mem_before,
               prompt_lens=[len(r["prompt"]) for r in requests])

    # (a) the prefix pool, against the pool-less path's streams
    bf16_solo = _solo_streams(model, requests, geo)
    out["pool"] = _pooled_run(model, requests, geo, None, bf16_solo,
                              OPTIONS_PREFIX)

    # (b) the int8 cache
    slot_bytes = {}
    for kv_dtype in (None, "int8"):
        server = InferenceServer(model, slots=4, device=model.device,
                                 kv_dtype=kv_dtype, **geo)
        slot_bytes[kv_dtype or "bfloat16"] = server.engine.cache_bytes_per_slot()
        del server
    D, H, S, n = cfg.hidden_size // cfg.num_heads, cfg.num_heads, 2048, cfg.num_layers
    need = {"bfloat16": n * 2 * S * H * D * 2, "int8": n * 2 * S * H * (D + 4)}
    if slot_bytes != need:
        raise AssertionError(f"cache bytes per slot {slot_bytes}, the "
                             f"arithmetic gives {need}")
    out["cache_bytes_per_slot"] = slot_bytes
    out["cache_bytes_ratio"] = slot_bytes["int8"] / slot_bytes["bfloat16"]
    out["int8_logits"] = _int8_logits(model, requests[1]["prompt"], S)
    int8_solo = _solo_streams(model, requests, geo, kv_dtype="int8")
    server = InferenceServer(model, slots=4, device=model.device, kv_dtype="int8",
                             **geo)
    fa.reset_launch_counts()
    handles = [server.submit(**r) for r in requests]
    streams = [h.result(timeout=900) for h in handles]
    launches = _forward_launches(fa)
    server.shutdown(timeout=60)
    snap = server.snapshot()
    _check_clean("int8 server", snap, len(requests))
    _check_streams("int8 server vs solo generate(kv_dtype='int8')", requests,
                   streams, int8_solo)
    need = n * len(requests)
    if launches != (need, 0, need):
        raise AssertionError(f"int8 server: forwards (wgmma_f32, other, "
                             f"split) {launches}, expected ({need}, 0, {need})")
    out["int8_server"] = dict(streams_equal_solo=True, flash_launches=need,
                              split_launches=need,
                              ttft_ms=[h.ttft_s * 1e3 for h in handles],
                              decode_ms_per_token_p50=snap["inter_token"]["p50_ms"])
    out["int8_pool"] = _pooled_run(model, requests, geo, "int8", int8_solo,
                                   OPTIONS_PREFIX)

    # (c) warmup and fair queueing
    out["fair"] = _fair_run(model, seed)
    out["flash_launches"] = (out["int8_server"]["flash_launches"]
                             + out["fair"]["flash_launches"]
                             + out["fair"]["warmup_launches"][0])
    out["split_launches"] = (out["int8_server"]["split_launches"]
                             + out["fair"]["split_launches"]
                             + out["fair"]["warmup_launches"][2])
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["card"] = nvidia_smi_line()
    emit("serving_options", **out)
    return out


def phase_speculative(seed: int) -> dict:
    """SpeculativeEngine(gpt_1p3b float32 target, build_draft_model(target,
    1), k=SPEC_K) on prompts of SPEC_PROMPTS tokens, SPEC_NEW new tokens:
    greedy output token-identical to solo greedy generate(), a fixed seed
    replaying its tokens and acceptance trace, both again on the int8
    cache; each generate launches exactly one wgmma_f32 forward (and
    split) per target and draft layer, for the two prefills; tokens per
    round, acceptance rate and ms per token against solo decode."""
    import numpy as np
    import torch

    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models.speculative import (SpeculativeEngine,
                                                     build_draft_model)

    mem_before = _check_freed("speculative")
    model, build_s = _serving_model(seed, _gpt_serving_config())
    draft = build_draft_model(model, 1)
    rng = np.random.default_rng(seed + 17)
    geo = dict(max_length=2048)
    per_generate = model.cfg.num_layers + draft.cfg.num_layers
    runs, launches_total = [], 0
    for kv_dtype in (None, "int8"):
        eng = SpeculativeEngine(model, draft, k=SPEC_K, kv_dtype=kv_dtype, **geo)
        for L in SPEC_PROMPTS:
            ids = rng.integers(0, model.cfg.vocab_size, (1, L))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solo = model.generate(ids, max_new_tokens=SPEC_NEW,
                                  kv_dtype=kv_dtype, **geo)
            torch.cuda.synchronize()
            solo_s = time.perf_counter() - t0
            fa.reset_launch_counts()
            t0 = time.perf_counter()
            got, stats = eng.generate(ids, max_new_tokens=SPEC_NEW,
                                      return_stats=True)
            torch.cuda.synchronize()
            spec_s = time.perf_counter() - t0
            launches = _forward_launches(fa)
            if launches != (per_generate, 0, per_generate):
                raise AssertionError(f"speculative generate: forwards "
                                     f"(wgmma_f32, other, split) {launches}, "
                                     f"expected ({per_generate}, 0, "
                                     f"{per_generate})")
            launches_total += per_generate
            if not np.array_equal(got, solo):
                raise AssertionError(f"speculative greedy (kv_dtype={kv_dtype}"
                                     f", prompt {L}) {got.tolist()} != solo "
                                     f"{solo.tolist()}")
            kw = dict(max_new_tokens=SPEC_NEW, do_sample=True, temperature=0.8,
                      top_p=0.9, seed=21, return_stats=True)
            s1, t1 = eng.generate(ids, **kw)
            s2, t2 = eng.generate(ids, **kw)
            if not (np.array_equal(s1, s2) and np.array_equal(
                    t1["acceptance_trace"], t2["acceptance_trace"])):
                raise AssertionError(f"speculative sampling (kv_dtype="
                                     f"{kv_dtype}, prompt {L}) does not replay "
                                     f"from its seed")
            runs.append(dict(
                kv_dtype=kv_dtype or "bfloat16", prompt=L,
                greedy_equals_solo=True, sampled_replays=True,
                rounds=stats["rounds"],
                tokens_per_round=(SPEC_NEW - 1) / max(stats["rounds"], 1),
                acceptance_rate=stats["acceptance_rate"],
                sampled_acceptance_rate=t1["acceptance_rate"],
                spec_ms_per_token=spec_s / SPEC_NEW * 1e3,
                solo_ms_per_token=solo_s / SPEC_NEW * 1e3,
                flash_launches=launches[0], split_launches=launches[2]))
    out = dict(model="gpt_1p3b", draft_layers=1, k=SPEC_K,
               model_build_s=build_s, mem_before_gib=mem_before, runs=runs,
               flash_launches=launches_total, split_launches=launches_total,
               card=nvidia_smi_line())
    emit("speculative", **out)
    return out


def _preset_config(num_layers: int = 24):
    """tools/decode_bench.py:51-57's serving preset: GPT h1024, 24 layers,
    16 heads of 64, vocab 50304, 1024 positions, dropout 0, bf16 cache."""
    from paddle_tpu_torch.models.gpt import GPTConfig

    return GPTConfig(vocab_size=50304, hidden_size=1024,
                     num_layers=num_layers, num_heads=16,
                     max_position_embeddings=1024, hidden_dropout_prob=0.0,
                     attention_dropout_prob=0.0, dtype="bfloat16")


def _preset_server(model, pooled: bool):
    """The preset's InferenceServer (int8 cache, PRESET_SLOTS slots,
    max_length 1024, the PRESET_POOL_BYTES pool when ``pooled``)."""
    from paddle_tpu_torch.serving import InferenceServer

    return InferenceServer(
        model, slots=PRESET_SLOTS, max_length=1024, kv_dtype="int8",
        prefix_cache=PRESET_POOL_BYTES if pooled else None,
        device=model.device)


def _preset_serve(model, requests, pooled: bool, together: bool = True):
    """Serve ``requests`` behind the preset's InferenceServer (int8
    cache, PRESET_SLOTS slots, the pool when ``pooled``); returns
    (streams, snapshot, forward launches)."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    server = _preset_server(model, pooled)
    fa.reset_launch_counts()
    handles = [server.submit(**r) for r in requests]
    streams = [h.result(timeout=900) for h in handles]
    launches = _forward_launches(fa)
    server.shutdown(timeout=60)
    return streams, server.snapshot(), launches


def phase_serve_preset(seed: int) -> dict:
    """The serve preset (_preset_config, float32 parameters) behind
    InferenceServer(slots=8, max_length=1024, kv_dtype="int8") with and
    without a 256 MiB prefix pool, on serve_bench's prefix-heavy trace
    shape: PRESET_REQUESTS requests, PRESET_PREFIX_FRAC of them opening
    with one shared PRESET_PREFIX-token prefix and a 16-128-token suffix,
    PRESET_NEW new tokens each. Every request completes (none requeued or
    failed); the pool-less run launches exactly one wgmma_f32 D = 64
    forward (and split) per layer per prefill, the pooled run none; every
    stream equals the same request served alone by a fresh server of the
    same configuration. Returns ``(record, yardstick)``: the model, the
    requests and both runs' streams, which fleet_serving holds the fleet
    to."""
    import numpy as np
    import torch

    mem_before = _check_freed("serve_preset")
    torch.cuda.reset_peak_memory_stats()
    model, build_s = _serving_model(seed, _preset_config())
    requests, prefix = _preset_requests(seed, model.cfg.vocab_size)
    shared = sum(len(r["prompt"]) > PRESET_PREFIX
                 and np.array_equal(r["prompt"][:PRESET_PREFIX], prefix)
                 for r in requests)
    layers = model.cfg.num_layers
    out = dict(model="serve preset (h1024, 24 layers, 16 heads of 64)",
               params=sum(p.numel() for p in model.parameters()),
               model_build_s=build_s, mem_before_gib=mem_before,
               requests=len(requests), shared_prefix_requests=int(shared),
               prompt_lens=[len(r["prompt"]) for r in requests])
    int8_solo = _solo_streams(model, requests, dict(max_length=1024),
                              kv_dtype="int8")
    yard = dict(model=model, requests=requests, prefix=prefix)
    for pooled in (False, True):
        label = "pooled" if pooled else "pool_less"
        t0 = time.perf_counter()
        streams, snap, launches = _preset_serve(model, requests, pooled)
        wall_s = time.perf_counter() - t0
        _check_clean(f"serve preset ({label})", snap, len(requests))
        need = (0, 0, 0) if pooled else (layers * len(requests), 0,
                                         layers * len(requests))
        if launches != need:
            raise AssertionError(f"serve preset ({label}): forwards "
                                 f"(wgmma_f32, other, split) {launches}, "
                                 f"expected {need}")
        alone = [_preset_serve(model, [r], pooled)[0][0] for r in requests]
        _check_streams(f"serve preset ({label}) vs served alone", requests,
                       streams, alone)
        yard[label] = streams
        out[label] = dict(
            flash_launches=launches[0], split_launches=launches[2],
            streams_equal_served_alone=True,
            streams_equal_solo_generate=int(sum(
                np.array_equal(a, b) for a, b in zip(streams, int8_solo))),
            wall_s=wall_s, tokens=snap["tokens_emitted"],
            tokens_per_s=snap["tokens_emitted"] / wall_s,
            ttft_p50_ms=snap["ttft"]["p50_ms"],
            ttft_p99_ms=snap["ttft"]["p99_ms"],
            inter_token_p50_ms=snap["inter_token"]["p50_ms"],
            prefix_hit_tokens=snap["prefix_hit_tokens"],
            prefix_hit_rate=snap["prefix_hit_rate"],
            card=nvidia_smi_line())
    out["flash_launches"] = out["pool_less"]["flash_launches"]
    out["split_launches"] = out["pool_less"]["split_launches"]
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    emit("serve_preset", **out)
    return out, yard


# the fleet over the serve preset (phase_fleet_serving)
FLEET_PATH = ("fleet serving (serve preset, float32 prefill at D = 64, int8 "
              "cache, two pool-less replicas behind ReplicaRouter)")
FLEET_HEALTH_S = 0.25      # the router's heartbeat in the child's run
FLEET_KILL_AFTER = 3       # the child's pool-less prefills before SIGKILL
FLEET_DECODE_STEPS = 64    # serving steps of each mode a round (alternating)
FLEET_ROUNDS = 4           # rounds, each admitting the slots afresh; few,
                           # for the whole smoke's 1200 s


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _routed(router, requests, fa, label):
    """Serve ``requests`` through ``router`` at once; returns (handles,
    streams, forward launches)."""
    if fa is not None:
        fa.reset_launch_counts()
    handles = [router.submit(**r) for r in requests]
    streams = [h.result(timeout=900) for h in handles]
    launches = _forward_launches(fa) if fa is not None else (0, 0, 0)
    snap = router.snapshot()
    if snap["requests_rerouted"] or snap["replicas_failed"]:
        raise AssertionError(f"{label}: {snap['requests_rerouted']} rerouted,"
                             f" {snap['replicas_failed']} replicas failed")
    return handles, streams, launches


def _fleet_child_lines(proc, lines, on_line):
    """Reader thread body: collect the child's stdout lines."""
    for raw in proc.stdout:
        line = raw.rstrip("\n")
        lines.append(line)
        if line.startswith('{"fleet_child"'):
            on_line(json.loads(line)["fleet_child"])


def fleet_child(weights: str, endpoint: str, device: str) -> int:
    """The fleet phase's child process: the parent's model (weights from
    ``weights``) behind a pooled prefill server and a pool-less replica,
    hosted over rpc as ``prefill`` and ``remote`` until the parent asks it
    to stop (or kills it). After each admit it prints its own forward
    launches and prefills, one JSON line."""
    import torch

    from paddle_tpu_torch import default_device
    from paddle_tpu_torch.distributed import rpc
    from paddle_tpu_torch.serving import remote

    default_device(device)   # TF32 off on the card, as in the parent
    rpc.init_rpc("child", rank=1, world_size=2, master_endpoint=endpoint)
    blob = torch.load(weights, map_location=device, weights_only=False)
    cfg = blob["cfg"]
    model = _model_cls(cfg)(cfg, device=device)
    model.load_state_dict(blob["state"])
    model.eval()
    del blob
    fa = None
    if device == "cuda":
        from paddle_tpu_torch.kernels import flash_attention as fa
    import numpy as np

    model.generate(np.zeros((1, 8), np.int64), max_new_tokens=2,
                   max_length=1024)   # warm: kernels loaded, cuBLAS handles
    if fa is not None:
        fa.reset_launch_counts()
    prefills = {"prefill": 0, "remote": 0}
    servers = {"prefill": _preset_server(model, True),
               "remote": _preset_server(model, False)}
    for name, srv in servers.items():
        admit = srv.engine.admit

        def counted(req, slot, _admit=admit, _name=name):
            out = _admit(req, slot)
            prefills[_name] += 1
            got = _forward_launches(fa) if fa is not None else (0, 0, 0)
            print(json.dumps({"fleet_child": {
                "server": _name, "prefills": dict(prefills),
                "fwd_wgmma_f32": got[0], "fwd_other": got[1],
                "split": got[2]}}), flush=True)
            return out

        srv.engine.admit = counted
        remote.host_server(srv, name)
    print(json.dumps({"fleet_child": {"ready": True}}), flush=True)
    remote.wait_for_stop()
    for srv in servers.values():
        srv.shutdown(drain=False, timeout=60)
    rpc.shutdown(timeout=10.0)
    return 0


def replica_child(weights: str, endpoint: str, device: str) -> int:
    """The replica fleet_serving's Autoscaler spawns: the parent's model
    (weights from ``weights``) behind one pool-less preset server, hosted
    over rpc as ``default`` (the name ProcessReplicaSpawner asks for) at
    the parent's fresh store ``endpoint``, until the parent asks it to
    stop."""
    import numpy as np
    import torch

    from paddle_tpu_torch import default_device
    from paddle_tpu_torch.distributed import rpc
    from paddle_tpu_torch.serving import remote

    default_device(device)
    rpc.init_rpc("auto-replica", rank=1, world_size=2,
                 master_endpoint=endpoint)
    blob = torch.load(weights, map_location=device, weights_only=False)
    cfg = blob["cfg"]
    model = _model_cls(cfg)(cfg, device=device)
    model.load_state_dict(blob["state"])
    model.eval()
    del blob
    model.generate(np.zeros((1, 8), np.int64), max_new_tokens=2,
                   max_length=1024)   # warm: kernels loaded, cuBLAS handles
    srv = _preset_server(model, False)
    remote.host_server(srv, "default")
    remote.wait_for_stop()
    srv.shutdown(drain=True, timeout=60)
    rpc.shutdown(timeout=10.0)
    return 0


def _autoscale_out(model, requests, yard, weights, env, device, fa) -> dict:
    """An Autoscaler over a router of one local replica scales out on a
    burning SLO report through a ProcessReplicaSpawner; the spawned child
    serves requests[0] (its launches read over rpc), then scale-in drains
    it."""
    from paddle_tpu_torch.distributed import rpc
    from paddle_tpu_torch.serving import (Autoscaler, ProcessReplicaSpawner,
                                          ReplicaRouter, remote)

    here = os.path.dirname(os.path.abspath(__file__))
    endpoint = f"127.0.0.1:{_free_port()}"
    spawner = ProcessReplicaSpawner(
        [sys.executable, os.path.abspath(__file__), "--replica-child",
         weights, endpoint, device], "auto-replica",
        init=lambda: rpc.init_rpc("parent", rank=0, world_size=2,
                                  master_endpoint=endpoint),
        rpc_timeout=120.0, ready_timeout=600.0, env=env)
    router = ReplicaRouter()
    local = _preset_server(model, False)
    router.add_replica(local, "local")
    auto = Autoscaler(router, spawner, sustain_ticks=1, cooldown_s=0.0,
                      max_replicas=2, scale_in_load=10.0)
    burning = {"tenants": {"__fleet__": {
        "burn_slow": 5.0, "burn_fast": 10.0, "slow_breached": True,
        "window_slow": {"total": 10}}}}
    quiet = {"tenants": {"__fleet__": {
        "burn_slow": 0.0, "burn_fast": 0.0, "slow_breached": False,
        "window_slow": {"total": 10}}}}
    try:
        router.slo_report = lambda: burning
        grow = auto.tick()
        if grow is None or grow["action"] != "scale_out":
            raise AssertionError(f"autoscaler: no scale-out: {grow}")
        replica = router._replicas[grow["replica"]].server
        if fa is not None:
            rpc.rpc_sync("auto-replica", fa.reset_launch_counts)
        stream = replica.submit(**requests[0]).result(timeout=900)
        _check_streams("autoscaled replica vs serve_preset", requests[:1],
                       [stream], yard["pool_less"][:1])
        counts = (rpc.rpc_sync("auto-replica", fa.launch_counts)
                  if fa is not None else None)
        want = model.cfg.num_layers if fa is not None else 0
        got = (counts["fwd"]["wgmma_f32"] if counts is not None else 0)
        if got != want:
            raise AssertionError(f"autoscaled replica: {got} wgmma_f32 "
                                 f"forwards, expected {want}")
        router.slo_report = lambda: quiet
        shrink = auto.tick()
        if shrink is None or shrink["action"] != "scale_in" \
                or router.replicas()[grow["replica"]] != "dead":
            raise AssertionError(f"autoscaler: no drain: {shrink}, "
                                 f"{router.replicas()}")
        return dict(spawn_s=grow["spawn_s"], replica=grow["replica"],
                    corr=grow["corr"], child_flash_launches=got,
                    scale_in=shrink["action"],
                    statusz={k: v for k, v in auto.statusz().items()
                             if k in ("scale_outs", "scale_ins",
                                      "spawn_failures")})
    finally:
        router.shutdown(timeout=60)
        live = [p for p in spawner.procs if p.poll() is None]
        if live:
            try:
                rpc.rpc_sync("auto-replica", remote._host_request_stop,
                             timeout=10)
            except Exception:
                pass
        # the child's rpc.shutdown waits at a barrier for this one
        rpc.shutdown(timeout=10.0)
        for proc in live:
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=60)


def _lane_check(spans, corr, child_names, parent_names) -> dict:
    """One request's stitched lane: the child's spans (src "child") and
    the parent's (no src) carry the names asked, and the lane reads in
    time order (the prefill on the child before the decode replica's
    admit, the parent's stream_end last)."""
    mine = [s for s in spans if s.get("corr") == corr]
    child = [s["name"] for s in mine if s.get("src") == "child"]
    parent = [s["name"] for s in mine if s.get("src") is None]
    for names, want, who in ((child, child_names, "child"),
                             (parent, parent_names, "parent")):
        missing = [n for n in want if n not in names]
        if missing:
            raise AssertionError(f"fleet trace of {corr}: the {who}'s spans "
                                 f"{names} lack {missing}")
    t0s = [s["t0"] for s in mine]
    if t0s != sorted(t0s):
        raise AssertionError(f"fleet trace of {corr} is not in time order")
    first = {(s.get("src"), s["name"]): s["t0"] for s in reversed(mine)}
    if not (first[("child", "prefill")] <= first[(None, "prefill")]
            and mine[-1]["name"] in ("stream_end", "decode")):
        raise AssertionError(f"fleet trace of {corr}: lane out of order "
                             f"{[(s.get('src'), s['name']) for s in mine]}")
    return dict(spans=len(mine), child=sorted(set(child)),
                parent=sorted(set(parent)))


def _profile_request(model, request, tmp, device) -> dict:
    """One served request under the port's Profiler: the serve:prefill and
    serve:decode ranges, and (on the card) the launches and kernels each
    holds in its time span."""
    from paddle_tpu_torch.profiler import Profiler

    srv = _preset_server(model, False)
    srv.submit(**request).result(timeout=900)   # warm, outside the capture
    prof = Profiler(trace_dir=tmp)
    prof.start()
    srv.submit(**request).result(timeout=900)
    prof.stop()
    srv.shutdown(timeout=60)
    with open(prof.last_trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    out = {}
    for name in ("serve:prefill", "serve:decode"):
        ranges = [e for e in events if e["name"] == name
                  and e.get("cat") != "gpu_user_annotation"]
        if not ranges:
            raise AssertionError(f"profile: no {name} range in "
                                 f"{prof.last_trace_path}")

        def inside(e, ranges=ranges):
            return any(r["tid"] == e["tid"] and r["ts"] <= e["ts"]
                       and e["ts"] + e.get("dur", 0) <= r["ts"] + r["dur"]
                       for r in ranges)

        launches = [e for e in events if "LaunchKernel" in e["name"]
                    and inside(e)]
        corr = {e["args"].get("correlation") for e in launches
                if e.get("args")}
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"
                   and e.get("args", {}).get("correlation") in corr]
        out[name] = dict(ranges=len(ranges), launches=len(launches),
                         kernels=len(kernels),
                         flash_kernels=sum("flash_fwd_f32_sm90" in k
                                           for k in kernels),
                         split_kernels=sum("split_terms" in k
                                           for k in kernels))
    if device == "cuda":
        pre, dec = out["serve:prefill"], out["serve:decode"]
        layers = model.cfg.num_layers
        if not (pre["launches"] and dec["launches"]):
            raise AssertionError(f"profile: kernel launches outside the "
                                 f"serving ranges: {out}")
        if (pre["flash_kernels"], pre["split_kernels"],
                dec["flash_kernels"]) != (layers, layers, 0):
            raise AssertionError(f"profile: serve:prefill holds "
                                 f"{pre['flash_kernels']} flash forwards and "
                                 f"{pre['split_kernels']} splits, "
                                 f"serve:decode {dec['flash_kernels']}; "
                                 f"expected {layers}, {layers} and 0")
    out["trace_file_mb"] = os.path.getsize(prof.last_trace_path) / 2 ** 20
    return out


def _decode_tracing_cost(model, requests) -> dict:
    """What tracing costs the preset server's serving step
    (``InferenceServer._tick``: the engine's decode step, its read-back,
    the metrics and the per-token ``decode`` spans) with all PRESET_SLOTS
    slots live, on the host clock (the step reads its tokens back, so the
    host waits for the card). The step is host-bound and the host shared,
    so its time drifts by tens of percent over seconds: tracing is turned
    on and off every step, and the cost is the median difference of
    adjacent on/off pairs. Each of FLEET_ROUNDS rounds admits the slots
    afresh and times FLEET_DECODE_STEPS steps of each mode, its first
    step on in even rounds and off in odd ones. Besides: the spans a
    traced step records, and one ``record_span`` call's host time."""
    import threading

    import numpy as np

    from paddle_tpu_torch.observability import tracing

    srv = _preset_server(model, False)
    # the steps are driven by hand below: submit() must not start the
    # server's own loop
    srv._thread = threading.current_thread()
    new = 2 * FLEET_DECODE_STEPS + 16      # admission ticks decode too
    steps = {"on": [], "off": []}
    rounds = {"on": [], "off": []}
    diffs, spans = [], 0
    was = tracing.enabled()
    try:
        for rnd in range(FLEET_ROUNDS):
            handles = [srv.submit(prompt=r["prompt"][:1024 - new - 8],
                                  max_new_tokens=new)
                       for r in requests[:PRESET_SLOTS]]
            while srv.engine.active_count < PRESET_SLOTS:
                srv._tick()
            srv._tick()   # warm
            order = ("on", "off") if rnd % 2 == 0 else ("off", "on")
            got = {"on": [], "off": []}
            for i in range(2 * FLEET_DECODE_STEPS):
                mode = order[i % 2]
                tracing.enable(mode == "on")
                before = tracing.stats()["recorded"]
                t0 = time.perf_counter()
                srv._tick()
                got[mode].append((time.perf_counter() - t0) * 1e3)
                if mode == "on":
                    spans += tracing.stats()["recorded"] - before
            diffs += [a - b for a, b in zip(got["on"], got["off"])]
            for m in got:
                steps[m] += got[m]
                rounds[m].append(float(np.median(got[m])))
            tracing.enable(was)
            while srv.engine.active_count:
                srv._tick()
            for h in handles:
                h.result(timeout=60)
        tracing.enable(True)
        n = 20000
        t0 = time.perf_counter()
        for _ in range(n):
            tracing.record_span("decode", 0.0, 1.0, corr="span-cost",
                                tags={"slot": 0})
        span_us = (time.perf_counter() - t0) * 1e6 / n
    finally:
        tracing.enable(was)
        srv.shutdown(drain=False)
    q25, q50, q75 = np.percentile(diffs, [25, 50, 75])
    return dict(
        decode_step_ms_tracing_on=float(np.median(steps["on"])),
        decode_step_ms_tracing_off=float(np.median(steps["off"])),
        tracing_cost_ms_per_step=float(q50),
        tracing_cost_ms_quartiles=[float(q25), float(q75)],
        pairs=len(diffs),
        round_medians_ms_on=rounds["on"], round_medians_ms_off=rounds["off"],
        spans_per_traced_step=spans / len(steps["on"]),
        record_span_us=span_us)


def phase_fleet_serving(seed: int, yard: dict, device: str = "cuda") -> dict:
    """serve_preset's model and requests through the fleet (see the module
    docstring, fleet_serving): ``yard`` is serve_preset's yardstick (the
    model, the requests and both runs' streams)."""
    import signal
    import tempfile
    import threading

    import numpy as np
    import torch

    from paddle_tpu_torch.distributed import rpc
    from paddle_tpu_torch.observability import (default_registry, flight,
                                                tracing)
    from paddle_tpu_torch.serving import (DisaggClient, RemoteReplica,
                                          ReplicaRouter, remote)
    from paddle_tpu_torch.serving.prefix_cache import last_migrate_stats

    cuda = device == "cuda"
    fa = None
    if cuda:
        from paddle_tpu_torch.kernels import flash_attention as fa
    model, requests = yard["model"], yard["requests"]
    prefix = yard["prefix"]
    layers = model.cfg.num_layers
    n = len(requests)
    shared = [i for i, r in enumerate(requests)
              if len(r["prompt"]) > len(prefix)
              and np.array_equal(r["prompt"][:len(prefix)], prefix)]
    out = dict(requests=n, shared_prefix_requests=len(shared),
               card=nvidia_smi_line())
    tmp = tempfile.mkdtemp(prefix="fleet_smoke_")
    flight.configure(dump_dir=os.path.join(tmp, "flight"))

    # 1. two pool-less replicas
    router = ReplicaRouter()
    for name in ("a", "b"):
        router.add_replica(_preset_server(model, False), name)
    t0 = time.perf_counter()
    handles, streams, launches = _routed(router, requests, fa, "pool-less")
    wall = time.perf_counter() - t0
    placed = {name: sum(h.replica == name for h in handles)
              for name in ("a", "b")}
    for name, rep in router.snapshot()["replicas"].items():
        _check_clean(f"fleet pool-less replica {name}", rep, placed[name])
    if min(placed.values()) == 0:
        raise AssertionError(f"fleet pool-less: placement {placed}")
    need = (layers * n, 0, layers * n) if cuda else (0, 0, 0)
    if launches != need:
        raise AssertionError(f"fleet pool-less: forwards (wgmma_f32, other, "
                             f"split) {launches}, expected {need}")
    _check_streams("fleet pool-less vs serve_preset", requests, streams,
                   yard["pool_less"])
    snap = router.snapshot()
    out["pool_less"] = dict(
        placement=placed, flash_launches=launches[0],
        split_launches=launches[2], wall_s=wall,
        ttft_p50_ms=float(np.median([h.ttft_s for h in handles]) * 1e3),
        tokens_per_s=snap["tokens_emitted"] / wall)
    router.shutdown(timeout=60)
    del router

    # 2. two pooled replicas, prefix affinity
    router = ReplicaRouter()
    for name in ("a", "b"):
        router.add_replica(_preset_server(model, True), name)
    handles, streams, launches = _routed(router, requests, fa, "pooled")
    if launches != (0, 0, 0):
        raise AssertionError(f"fleet pooled: forwards {launches}, expected "
                             f"none")
    _check_streams("fleet pooled vs serve_preset", requests, streams,
                   yard["pooled"])
    placed = {name: [i for i, h in enumerate(handles) if h.replica == name]
              for name in ("a", "b")}
    cold = {name: sum(handles[i].cache_hit_tokens == 0 for i in idx
                      if i in shared) for name, idx in placed.items()}
    if max(cold.values()) > 1:
        raise AssertionError(f"fleet pooled: cold shared-prefix misses per "
                             f"replica {cold}, at most 1 each")
    snap = router.snapshot()
    out["pooled"] = dict(
        placement={k: len(v) for k, v in placed.items()},
        shared_by_replica={k: sum(i in shared for i in v)
                           for k, v in placed.items()},
        cold_shared_misses=cold,
        hit_tokens={k: r["prefix_hit_tokens"]
                    for k, r in snap["replicas"].items()},
        prefix_hit_rate=snap["prefix_hit_rate"], flash_launches=0)
    router.shutdown(timeout=60)
    del router

    # 3. one child process on the same card
    weights = os.path.join(tmp, "weights.pt")
    torch.save({"cfg": model.cfg, "state": model.state_dict()}, weights)
    endpoint = f"127.0.0.1:{_free_port()}"
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        PT_FLIGHT_DIR=os.path.join(tmp, "child_flight"))
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--fleet-child", weights,
         endpoint, device], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=here, env=env)
    lines, child = [], {"last": None, "killed_at": None}
    kill = {"armed": False}

    def on_line(rec):
        if "server" not in rec:
            return
        child["last"] = rec
        if kill["armed"] and rec["prefills"]["remote"] >= FLEET_KILL_AFTER \
                and child["killed_at"] is None:
            os.kill(proc.pid, signal.SIGKILL)
            child["killed_at"] = time.perf_counter()
            child["at_kill"] = rec

    reader = threading.Thread(target=_fleet_child_lines,
                              args=(proc, lines, on_line), daemon=True)
    reader.start()
    local_servers = []
    try:
        t0 = time.perf_counter()
        rpc.init_rpc("parent", rank=0, world_size=2, master_endpoint=endpoint)
        pre = RemoteReplica("child", "prefill", rpc_timeout=120.0)
        rem = RemoteReplica("child", "remote", rpc_timeout=30.0)
        if not (pre.wait_ready(timeout=600) and rem.wait_ready(timeout=60)):
            raise AssertionError("fleet child never hosted its servers: "
                                 + "\n".join(lines[-20:]))
        out["child_boot_s"] = time.perf_counter() - t0

        # 3a. disaggregated prefill (child) and decode (parent)
        dec_srv = _preset_server(model, True)
        local_servers.append(dec_srv)
        remote.host_server(dec_srv, "decode")
        dec = RemoteReplica("parent", "decode", rpc_timeout=120.0)
        client = DisaggClient([pre], [dec], block_tokens=16)
        d_handles, d_streams = [], []
        if fa is not None:
            fa.reset_launch_counts()
        t0 = time.perf_counter()
        for i in shared:        # one at a time: migration and TTFT alone
            h = client.submit(requests[i]["prompt"],
                              max_new_tokens=requests[i]["max_new_tokens"])
            d_streams.append(h.result(timeout=900))
            d_handles.append(h)
        d_wall = time.perf_counter() - t0
        # the parent's launches here are the decode replica's alone (the
        # prefill server runs in the child): migrated admits run
        # cached_attention, never the flash forward
        d_launches = _forward_launches(fa) if fa is not None else (0, 0, 0)
        if d_launches != (0, 0, 0):
            raise AssertionError(f"disagg decode replica: forwards "
                                 f"(wgmma_f32, other, split) {d_launches}, "
                                 f"expected none")
        st = client.statusz()
        if (st["migrations"], st["fallbacks"]) != (len(shared), 0):
            raise AssertionError(f"disagg: {st}")
        _check_streams("disagg vs serve_preset pooled",
                       [requests[i] for i in shared], d_streams,
                       [yard["pooled"][i] for i in shared])
        hits = [h.cache_hit_tokens for h in d_handles]
        pool = dec_srv.engine.pool
        want = [pool._matchable_blocks(len(requests[i]["prompt"]))
                * pool.block_tokens for i in shared]
        sent = rpc.rpc_sync("child", last_migrate_stats)
        dsnap = dec_srv.snapshot()
        if hits != want or sum(hits) != dsnap["prefix_hit_tokens"] or \
                sum(hits) != 16 * sent["blocks_out"]:
            raise AssertionError(f"disagg: decode hits {hits}, prompts' "
                                 f"blocks {want}, decode replica "
                                 f"{dsnap['prefix_hit_tokens']}, migrated "
                                 f"{16 * sent['blocks_out']} tokens")
        out["disagg"] = dict(
            requests=len(shared), migrations=st["migrations"],
            decode_flash_launches=d_launches[0],
            decode_split_launches=d_launches[2],
            fallbacks=st["fallbacks"], blocks_migrated=sent["blocks_out"],
            blocks_landed=st["migrated_tokens"] // 16,
            bytes_migrated=st["migrated_bytes"],
            migrate_ms_per_request=st["migrate_s"] * 1e3 / len(shared),
            decode_hit_tokens=sum(hits), migrated_tokens=16 * sent[
                "blocks_out"],
            ttft_p50_ms=float(np.median([h.ttft_s for h in d_handles])
                              * 1e3), wall_s=d_wall,
            decode_pool=dsnap["prefix_cache"])

        # 3b. observability across the two processes
        local = _preset_server(model, False)
        local_servers.append(local)
        router = ReplicaRouter(health_check_interval=FLEET_HEALTH_S)
        router.add_replica(local, "local")
        router.add_replica(rem, "child")
        text = router.fleet_metrics_text()
        for rep in ("_local", "child"):
            if f'replica="{rep}"' not in text or not any(
                    line.startswith("serving_requests_completed{")
                    and f'replica="{rep}"' in line
                    for line in text.splitlines()):
                raise AssertionError(f"fleet metrics text lacks replica "
                                     f"{rep}'s serving series")
        corr = d_handles[-1].correlation_id
        spans, reports = router.collect_fleet_trace(corr=corr)
        lane = _lane_check(spans, corr,
                           ("submit", "queue_wait", "prefill", "stream_end"),
                           ("submit", "queue_wait", "prefill", "decode",
                            "stream_end"))
        end = max(s["t1"] for s in spans if s.get("corr") == corr)
        begin = min(s["t0"] for s in spans if s.get("corr") == corr)
        steps = [s for s in tracing.spans(name="decode_step")
                 if begin <= s["t0"] <= end]
        if not steps:
            raise AssertionError("no decode_step span in the lane's window")
        out["observability"] = dict(
            metrics_lines=len(text.splitlines()),
            replicas_in_metrics=["_local", "child"], lane=lane,
            decode_steps_in_window=len(steps),
            clock=reports)

        # 3c. the remote replica and its death
        if fa is not None:
            fa.reset_launch_counts()
        kill["armed"] = True
        done_at = {}
        r_handles, first_placed = [], []

        def wait(i, h):
            h.result(timeout=900)
            done_at[i] = time.perf_counter()

        threads = []
        for i, r in enumerate(requests):
            # alternate the first placement: a remote replica's load view
            # refreshes only at its probes, so a burst would all land on it
            h = router.submit(**r, prefer=("local", "child")[i % 2])
            r_handles.append(h)
            first_placed.append(h.replica)
            t = threading.Thread(target=wait, args=(i, h), daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=900)
        r_streams = [h.result(timeout=1) for h in r_handles]
        _check_streams("fleet with a killed child vs serve_preset",
                       requests, r_streams, yard["pool_less"])
        if child["killed_at"] is None:
            raise AssertionError(f"the child was never killed: "
                                 f"{child['last']}")
        proc.wait(timeout=60)
        at = child["at_kill"]
        if (at["fwd_wgmma_f32"], at["fwd_other"], at["split"]) != (
                (layers * at["prefills"]["remote"], 0,
                 layers * at["prefills"]["remote"]) if cuda else (0, 0, 0)):
            raise AssertionError(f"child launches at the kill: {at}")
        rerouted = [i for i, h in enumerate(r_handles) if h.reroutes]
        if not rerouted or router.replicas()["child"] != "dead":
            raise AssertionError(f"no reroute after the kill: "
                                 f"{router.replicas()}, {rerouted}")
        dumps = sorted(f for f in os.listdir(os.path.join(tmp, "flight"))
                       if "replica_dead" in f)
        if not dumps:
            raise AssertionError("no replica_dead flight dump")
        with open(os.path.join(tmp, "flight", dumps[-1])) as f:
            dump = json.load(f)
        inflight = set(dump["extra"]["inflight"])
        corrs = {r_handles[i].correlation_id for i in rerouted}
        if not inflight or not inflight <= {h.correlation_id
                                            for h in r_handles}:
            raise AssertionError(f"replica_dead dump inflight {inflight} "
                                 f"is not among the run's requests")
        failed = {k: v for k, v in default_registry().snapshot()[
            "counters"].items() if k.startswith("router.replicas_failed")
            and v}
        if not failed:
            raise AssertionError("the registry shows no failed replica")
        parent_prefills = local.snapshot()["prefills"]
        got = _forward_launches(fa) if fa is not None else (0, 0, 0)
        if got != ((layers * parent_prefills, 0, layers * parent_prefills)
                   if cuda else (0, 0, 0)):
            raise AssertionError(f"parent launches {got} over "
                                 f"{parent_prefills} prefills")
        out["death"] = dict(
            placement={name: first_placed.count(name)
                       for name in ("local", "child")},
            child_prefills_at_kill=at["prefills"]["remote"],
            child_flash_launches_at_kill=at["fwd_wgmma_f32"],
            child_split_launches_at_kill=at["split"],
            parent_prefills=parent_prefills, parent_flash_launches=got[0],
            rerouted=len(rerouted), dump_inflight=len(inflight),
            dump_names_rerouted=len(corrs & inflight),
            registry_failed=failed,
            kill_to_last_rerouted_ms=(max(done_at[i] for i in rerouted)
                                      - child["killed_at"]) * 1e3)
        router.shutdown(timeout=60)
    finally:
        if proc.poll() is None:
            try:
                rpc.rpc_sync("child", remote._host_request_stop, timeout=10)
            except Exception:
                pass
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=60)
        remote.unhost_server("decode")
        for srv in local_servers:
            srv.shutdown(drain=False, timeout=60)
        rpc.shutdown(timeout=4.0)
        reader.join(timeout=30)
    out["child_exit"] = proc.returncode

    # 3d. an Autoscaler's scale-out through a spawned process
    try:
        out["autoscale"] = _autoscale_out(model, requests, yard, weights,
                                          env, device, fa)
    finally:
        os.remove(weights)

    # 4. one replica's own costs
    out["profile"] = _profile_request(model, requests[shared[0]],
                                      os.path.join(tmp, "prof"), device)
    out["decode"] = _decode_tracing_cost(model, requests)
    out["flash_launches"] = out["pool_less"]["flash_launches"]
    out["split_launches"] = out["pool_less"]["split_launches"]
    shutil.rmtree(tmp, ignore_errors=True)
    emit("fleet_serving", **out)
    return out


_COUNT_NAMES = ("fwd_fma", "fwd_wgmma", "fwd_wgmma_f32", "fwd_wgmma_f16",
                "dq_fma", "dq_wgmma", "dq_wgmma_f32", "dq_wgmma_f16",
                "dkv_fma", "dkv_wgmma", "dkv_wgmma_f32", "dkv_wgmma_f16")


def _need(**launches) -> tuple:
    """Launches by kernel and route (names of _COUNT_NAMES, the rest 0), in
    the order of _COUNT_NAMES."""
    unknown = set(launches) - set(_COUNT_NAMES)
    if unknown:
        raise ValueError(f"no such kernel and route: {sorted(unknown)}")
    return tuple(launches.get(name, 0) for name in _COUNT_NAMES)


def _step_need(dtype: str, n: int) -> tuple:
    """The launches of one training step of ``n`` layers (forward and its
    recompute, dQ, dK/dV) at any head dim in ``dtype``: wgmma for bf16,
    wgmma_f16 for float16."""
    if dtype == "float16":
        return _need(fwd_wgmma_f16=2 * n, dq_wgmma_f16=n, dkv_wgmma_f16=n)
    return _need(fwd_wgmma=2 * n, dq_wgmma=n, dkv_wgmma=n)


def _counts(fa):
    """Launches since the last reset, in the order of _COUNT_NAMES."""
    c = fa.launch_counts()
    return tuple(c[kernel][route] for kernel, route in
                 (n.split("_", 1) for n in _COUNT_NAMES))


def _train_config(**overrides):
    """bench.py bench_gpt_1p3b's configuration (hidden 2048, 24 layers,
    16 heads, vocab 50304, 1024 positions, recompute, flash attention,
    chunked loss of 256, dropout 0)."""
    from paddle_tpu_torch.models.gpt import gpt_1p3b

    cfg = dict(max_position_embeddings=TRAIN_SEQ, hidden_dropout_prob=0.0,
               attention_dropout_prob=0.0, use_recompute=True,
               use_flash_attention=True, loss_chunk=256, dtype="bfloat16")
    cfg.update(overrides)
    return gpt_1p3b(**cfg)


def _o2_step(cfg, seed: int, global_seed: int, dtype: str = "bfloat16",
             optimizer=None, scaler=None):
    """A TrainStep over a seeded model under amp.decorate O2 in ``dtype``,
    with ``optimizer`` (default AdamW(1e-4, wd 0.01), as the bench builds
    it) and ``scaler``."""
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.framework import random as framework_random
    from paddle_tpu_torch.framework.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW

    framework_random.seed(global_seed)
    model = _model_cls(cfg)(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(seed)).train()
    if optimizer is None:
        optimizer = AdamW(learning_rate=1e-4, weight_decay=0.01)
    model, opt = amp.decorate(model, optimizer, level="O2", dtype=dtype)
    return TrainStep(model, opt, loss_fn=None, scaler=scaler)


def _free():
    import torch

    gc.collect()
    torch.cuda.empty_cache()


# what may stay allocated on the card between phases (the RoPE tables,
# cuBLAS workspaces): a phase that finds more was left a model
LEFTOVER_GIB = 2.0


def _check_freed(phase: str) -> float:
    """GiB allocated on the card as ``phase`` starts; raises past
    LEFTOVER_GIB."""
    import torch

    gib = torch.cuda.memory_allocated() / 2 ** 30
    if gib > LEFTOVER_GIB:
        raise AssertionError(f"{phase}: {gib} GiB still allocated from the "
                             f"phases before it")
    return gib


def _train_run(phase: str, label: str, step, ids, need, flops_per_token,
               build_s: float, call=None, **report) -> dict:
    """TRAIN_WARMUP + TRAIN_TIMED steps of ``step`` on ``(ids, ids)``
    (through ``call(batch) -> loss`` when given): finite losses that fall,
    exactly ``need`` launches (in the order of _COUNT_NAMES) every step,
    and a fresh batch's loss afterwards above half the first loss (no step
    saw the tokens it predicts); reports the median of the timed steps
    (host clock, synchronised), tokens/s, MFU against the bf16 peak and
    peak memory."""
    import numpy as np
    import torch

    from paddle_tpu_torch.kernels import flash_attention as fa

    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, per_step = [], [], []
    fa.reset_launch_counts()
    for _ in range(TRAIN_WARMUP + TRAIN_TIMED):
        before = _counts(fa)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = (call or step)((ids, ids))
        losses.append(float(loss))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append(tuple(a - b for a, b in zip(_counts(fa), before)))
    launches = _counts(fa)
    if any(c != need for c in per_step):
        raise AssertionError(f"{phase}: launches per step {_COUNT_NAMES} "
                             f"{per_step}, expected {need} every step")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: losses {losses}: not finite or not "
                             f"falling")
    # the steps repeat one batch, and a model that can see only earlier
    # tokens learns nothing from it about a fresh batch, whose loss stays
    # high however far the trained batch's falls; an attention mask that
    # let a position see the token it predicts would let the model copy
    # it, and the fresh batch's loss fall as well
    fresh = torch.as_tensor(np.random.default_rng(ids.size).integers(
        0, step.model.cfg.vocab_size, ids.shape), device="cuda")
    with torch.no_grad():
        fresh_loss = float(step.model(fresh, fresh))
    if not fresh_loss > losses[0] / 2:
        raise AssertionError(f"{phase}: a fresh batch's loss {fresh_loss} "
                             f"after training on one batch (first loss "
                             f"{losses[0]}): the model may see the tokens "
                             f"it predicts")
    timed = step_ms[TRAIN_WARMUP:]
    tokens_per_s = ids.size * TRAIN_TIMED / (sum(timed) / 1e3)
    out = dict(model=label, **report, batch=list(ids.shape),
               params=sum(p.numel() for p in step.params.values()),
               model_build_s=build_s, losses=losses,
               fresh_batch_loss=fresh_loss,
               launches=dict(zip(_COUNT_NAMES, launches)),
               launches_per_step=dict(zip(_COUNT_NAMES, need)),
               step_ms=step_ms, step_ms_median=float(np.median(timed)),
               tokens_per_s=tokens_per_s,
               mfu=tokens_per_s * flops_per_token / PEAK_BF16_TC_FLOPS,
               flops_per_token=flops_per_token,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               card=nvidia_smi_line())
    emit(phase, **out)
    return out


def phase_training(seed: int) -> dict:
    """The GPT-3 1.3B bf16 (O2) pretrain step, 5 warm-up and 8 timed."""
    import numpy as np
    import torch

    from paddle_tpu_torch.models.gpt import gpt_flops_per_token

    cfg = _train_config()
    t0 = time.perf_counter()
    step = _o2_step(cfg, seed, seed)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ids = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)
    # bf16 at D = 128: the wgmma forward (and its recompute), dQ and dK/dV
    need = _step_need("bfloat16", cfg.num_layers)
    return _train_run("training", "gpt_1p3b O2 bf16", step, ids, need,
                      gpt_flops_per_token(cfg, TRAIN_SEQ), build_s)


def _bits(t):
    """``t``'s bits as integers (``torch.equal`` on them is bit equality,
    NaN and the sign of zero included)."""
    import torch

    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.view(ints[t.element_size()]) if t.is_floating_point() else t


def _state_tensors(step) -> list:
    """Every parameter, master, moment and the step count of a TrainStep,
    each tensor once, in a fixed order."""
    import torch

    tensors, seen = [], set()

    def walk(tree):
        if isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k])
        elif isinstance(tree, torch.Tensor) and id(tree) not in seen:
            seen.add(id(tree))
            tensors.append(tree.detach())

    walk({"params": step.params, "opt": step.opt_state})
    return tensors


def _state_bits(step) -> list:
    """A copy of ``step``'s state as integers (on the card: a snapshot the
    size of the state)."""
    return [_bits(t).clone() for t in _state_tensors(step)]


def _same_bits(step, saved) -> bool:
    """Whether ``step``'s state still has the bits of ``saved``
    (_state_bits), tensor by tensor."""
    import torch

    now = _state_tensors(step)
    return len(now) == len(saved) and all(
        torch.equal(_bits(a), b) for a, b in zip(now, saved))


def _fp16_recipe():
    """The float16 pretraining recipe: AdamW(wd 0.01) under warm-up into
    cosine decay, clipped by global norm."""
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import (CosineAnnealingDecay,
                                               LinearWarmup)

    return AdamW(learning_rate=LinearWarmup(CosineAnnealingDecay(
        1e-4, T_max=8), 2, 0.0, 1e-4), weight_decay=0.01,
        grad_clip=ClipGradByGlobalNorm(1.0))


def phase_fp16_training(seed: int, bf16: dict) -> dict:
    """GPT-3 1.3B (bench_gpt_1p3b's configuration, full width and depth)
    trained in float16 O2 with GradScaler (defaults), AdamW under
    LinearWarmup(CosineAnnealingDecay) and ClipGradByGlobalNorm(1.0),
    through TrainStep(scaler=...): TRAIN_WARMUP + TRAIN_TIMED steps held to
    _train_run's checks with exactly 48 wgmma_f16 forward, 24 wgmma_f16
    dQ, 24 wgmma_f16 dK/dV and no split launch a step; the printed
    per-step overflow flags, replayed through update_scale on the host,
    give the printed scale trajectory; at least one step updates the
    parameters. Then a poisoned
    step (inject_anomaly) leaves every parameter, master, moment and the
    step count bit-equal and the scale where it was, the next step trains,
    and under FLAGS_check_nan_inf a poisoned step raises
    FloatingPointError with the state bit-equal. Reports the step beside
    the bf16 step of the same run and the guarded update's cost against
    the unguarded one's. Frees what it allocates."""
    import numpy as np
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.amp.grad_scaler import (init_scale_state,
                                                  unscale_and_check,
                                                  update_scale)
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models.gpt import gpt_flops_per_token

    mem_before = _check_freed("fp16_training")
    cfg = _train_config(dtype="float16")
    t0 = time.perf_counter()
    step = _o2_step(cfg, seed, seed, dtype="float16",
                    optimizer=_fp16_recipe(), scaler=amp.GradScaler())
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ids = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)
    n = cfg.num_layers
    # float16 at D = 128: the wgmma_f16 forward (and its recompute), dQ and
    # dK/dV, none with a split
    need = _step_need("float16", n)
    need_splits = 0
    # a weight of std 0.02, whose float16 spacing is far below a step of lr
    probe = "gpt.h.0.attn.qkv_proj.weight"
    first = step.params[probe].detach().clone()
    found, oks, scales, splits = [], [], [], []

    def call(batch):
        before = fa.split_bf16_terms.launches
        loss, ok, found_inf = step.watchdog_call(batch)
        splits.append(fa.split_bf16_terms.launches - before)
        found.append(found_inf)
        oks.append(ok)
        scales.append(step.scaler_state["scale"].clone())
        return loss

    run = _train_run("fp16_training_steps", "gpt_1p3b O2 float16", step,
                     ids, need, gpt_flops_per_token(cfg, TRAIN_SEQ), build_s,
                     call=call, mem_before_gib=mem_before)
    found = [bool(f) for f in found]
    scales = [float(x) for x in scales]
    if any(x != need_splits for x in splits) or not all(bool(o) for o in oks):
        raise AssertionError(f"fp16_training: splits per step {splits} "
                             f"(expected {need_splits}), ok {oks}")
    # the scale trajectory, replayed on the host from the flags
    replay, state = [], init_scale_state()
    for f in found:
        state = update_scale(state, f)
        replay.append(float(state["scale"]))
    updates = int(step.opt_state["step"])
    if replay != scales or updates != found.count(False) or updates < 1 \
            or torch.equal(first, step.params[probe]):
        raise AssertionError(f"fp16_training: scales {scales}, replayed "
                             f"{replay}, overflow flags {found}, {updates} "
                             f"updates; {probe} changed: "
                             f"{not torch.equal(first, step.params[probe])}")
    # a poisoned step: an anomaly, the state bit-equal, no back-off
    saved = _state_bits(step)
    scale, bad_steps = (step.scaler_state["scale"].clone(),
                        int(step.scaler_state["bad_steps"]))
    step.inject_anomaly()
    loss, ok, found_inf = step.watchdog_call((ids, ids))
    if math.isfinite(float(loss)) or bool(ok) or bool(found_inf) \
            or not _same_bits(step, saved) \
            or not torch.equal(scale, step.scaler_state["scale"]) \
            or int(step.scaler_state["bad_steps"]) != bad_steps:
        raise AssertionError(f"fp16_training: the poisoned step (loss "
                             f"{float(loss)}, ok {bool(ok)}, overflow "
                             f"{bool(found_inf)}) changed the state or the "
                             f"scale")
    loss, ok, found_inf = step.watchdog_call((ids, ids))
    after = float(loss)
    if not (math.isfinite(after) and bool(ok)):
        raise AssertionError(f"fp16_training: the step after the anomaly: "
                             f"loss {after}, ok {bool(ok)}")
    # FLAGS_check_nan_inf: a poisoned step raises, the state bit-equal
    saved = _state_bits(step)
    flags.set_flags({"FLAGS_check_nan_inf": True})
    try:
        step.inject_anomaly()
        step((ids, ids))
        raised = False
    except FloatingPointError:
        raised = True
    finally:
        flags.set_flags({"FLAGS_check_nan_inf": False})
    if not raised or not _same_bits(step, saved):
        raise AssertionError(f"FLAGS_check_nan_inf: raised {raised}, state "
                             f"bit-equal {_same_bits(step, saved)}")
    del saved
    # a fresh batch's loss after all of it
    fresh = torch.as_tensor(np.random.default_rng(seed + 11).integers(
        0, cfg.vocab_size, ids.shape), device="cuda")
    with torch.no_grad():
        fresh_loss = float(step.model(fresh, fresh))
    if not math.isfinite(fresh_loss):
        raise AssertionError(f"fp16_training: fresh loss {fresh_loss}")
    # the guarded update's cost: the same gradients through the update
    # with a guard that skips (both passes, the state kept), and through
    # the plain one (committed: the last steps of this phase, at the
    # schedule's rate 0)
    model, opt = step.model, step.optimizer
    ids_t = torch.as_tensor(ids, device="cuda")
    with torch.enable_grad():
        scaled = model(ids_t, ids_t).float() * step.scaler_state["scale"]
        grads = dict(zip(step.params, torch.autograd.grad(
            scaled, list(step.params.values()))))
    del scaled

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    skip = torch.ones((), dtype=torch.bool, device="cuda")
    unscaled, _ = unscale_and_check(grads, step.scaler_state)
    fns = {"unscale": lambda: unscale_and_check(grads, step.scaler_state),
           "guarded": lambda: opt.update(unscaled, step.opt_state,
                                         step.params, guard=lambda ok: skip),
           "plain": lambda: opt.update(unscaled, step.opt_state,
                                       step.params)}
    # in turns (A B C C B A, twice), host clock around synchronised calls
    ms = {name: [] for name in fns}
    for _ in range(2):
        for name in list(fns) + list(fns)[::-1]:
            ms[name].append(timed(fns[name]))
    unscale_ms, guarded_ms, plain_ms = (float(np.median(ms[n]))
                                        for n in fns)
    del grads, unscaled, fns
    out = dict(run, overflow_flags=found, scales=scales,
               scale_replay_equal=True, updates=updates,
               split_launches=sum(splits),
               split_launches_per_step=need_splits,
               anomaly_state_bit_equal=True, loss_after_anomaly=after,
               check_nan_inf_raised=True, fresh_batch_loss=fresh_loss,
               bf16_step_ms_median=bf16["step_ms_median"],
               bf16_tokens_per_s=bf16["tokens_per_s"],
               update_guarded_ms=guarded_ms, update_plain_ms=plain_ms,
               unscale_check_ms=unscale_ms,
               guard_overhead_ms=guarded_ms + unscale_ms - plain_ms,
               card=nvidia_smi_line())
    del step, model, opt
    emit("fp16_training", **out)
    return out


def phase_fp16_step(seed: int) -> dict:
    """_o2_step_vs_plain in float16 (GradScaler at its defaults) at
    gpt_1p3b width, cut to 2 layers: the gradients and one guarded step
    through the float16 kernels (the wgmma_f16 forward, dQ and dK/dV, no
    split) against plain attention."""
    import numpy as np

    vocab = _train_config().vocab_size
    ids = np.random.default_rng(seed + 3).integers(
        0, vocab, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)
    return _o2_step_vs_plain(
        seed, "fp16_step",
        lambda flash: _train_config(num_layers=2, dtype="float16",
                                    use_flash_attention=flash), ids,
        dtype="float16", model="gpt_1p3b width, 2 layers, O2 float16",
        head_dim=128)


def phase_train_parity(seed: int) -> dict:
    """One float32 forward and backward of the training configuration,
    with the flash kernels and with plain attention, no update."""
    return _float32_parity(seed, "train_parity")


def phase_d256_f32(seed: int) -> dict:
    """phase_train_parity at gpt_1p3b width with 8 heads of 256 (D = 256),
    cut to 2 layers: the float32 forward and backward through the
    wgmma_f32 kernels at D = 256 against plain attention."""
    return _float32_parity(seed, "d256_f32", num_layers=2,
                           num_heads=D256_STEP_HEADS)


def _float32_parity(seed: int, phase: str, **overrides) -> dict:
    """One float32 forward and backward (no ``amp.decorate``, no update) of
    the training configuration with ``overrides``, with the flash kernels
    and with plain attention: the loss within TRAIN_LOSS_RTOL and every
    parameter's gradient within TRAIN_GRAD_REL_L2 (relative L2), and the
    kernel run's launches exactly 2 wgmma_f32 forwards (recompute
    included), one dQ and one dK/dV per layer and 4 of the split, no FMA
    kernel."""
    import numpy as np
    import torch

    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models.gpt import GPTForCausalLM

    cfg = _train_config(**overrides)
    model = GPTForCausalLM(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(seed)).train()
    params = list(model.parameters())
    ids = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)), device="cuda")

    def run(flash: bool):
        model.cfg.use_flash_attention = flash
        loss = model(ids, ids)
        return loss.item(), torch.autograd.grad(loss, params)

    fa.reset_launch_counts()
    loss_k, grads_k = run(True)
    launches, split_launches = _counts(fa), fa.split_bf16_terms.launches
    loss_p, grads_p = run(False)
    model.cfg.use_flash_attention = True
    # float32: the wgmma_f32 forward (and its recompute), dQ and dK/dV; the
    # split once per forward and twice per backward (q, k, v; dO)
    n = cfg.num_layers
    if launches != _need(fwd_wgmma_f32=2 * n, dq_wgmma_f32=n,
                         dkv_wgmma_f32=n) or split_launches != 4 * n:
        raise AssertionError(f"float32 kernel run launched "
                             f"{dict(zip(_COUNT_NAMES, launches))} and the "
                             f"split {split_launches} times")
    rel = [((a - b).norm() / b.norm().clamp_min(1e-30)).item()
           for a, b in zip(grads_k, grads_p)]
    worst = max(rel)
    if not (abs(loss_k - loss_p) <= TRAIN_LOSS_RTOL * abs(loss_p)
            and worst <= TRAIN_GRAD_REL_L2):
        raise AssertionError(f"float32 training, kernels vs plain: loss "
                             f"{loss_k} vs {loss_p}, worst grad rel L2 {worst}")
    names = [n for n, _ in model.named_parameters()]
    out = dict(dtype="float32", layers=n, head_dim=cfg.hidden_size // cfg.num_heads,
               loss_kernel=loss_k, loss_plain=loss_p,
               grad_rel_l2_max=worst, grad_rel_l2_worst_param=names[rel.index(worst)],
               tol=dict(loss_rtol=TRAIN_LOSS_RTOL, grad_rel_l2=TRAIN_GRAD_REL_L2),
               launches=dict(zip(_COUNT_NAMES, launches)),
               split_launches=split_launches)
    emit(phase, **out)
    return out


def phase_dropout_replay(seed: int) -> dict:
    """Full width, 2 layers, dropout 0.1: two TrainSteps from the same seed
    give bit-identical losses over 2 steps; another seed does not."""
    import numpy as np

    from paddle_tpu_torch.kernels import flash_attention as fa

    cfg = _train_config(num_layers=2, hidden_dropout_prob=DROPOUT_P,
                        attention_dropout_prob=DROPOUT_P)
    ids = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)

    def losses(global_seed):
        step = _o2_step(cfg, seed, global_seed)
        return [float(step((ids, ids))) for _ in range(2)]

    fa.reset_launch_counts()
    a, b = losses(seed), losses(seed)
    launches = _counts(fa)
    other = losses(seed + 1)
    # 2 runs x 2 steps x 2 layers x (forward + recompute), bf16: wgmma
    need = _need(fwd_wgmma=16, dq_wgmma=8, dkv_wgmma=8)
    if a != b or launches != need or other == a:
        raise AssertionError(f"dropout replay: {a} vs {b} (other seed "
                             f"{other}), launches {launches} != {need}")
    out = dict(layers=2, p=DROPOUT_P, losses=a, replay_losses=b,
               other_seed_losses=other,
               launches=dict(zip(_COUNT_NAMES, launches)))
    emit("dropout_replay", **out)
    return out


def _loss_and_grads(model, ids):
    """The loss of ``model(ids, ids)`` and its gradient for every
    parameter, in ``named_parameters`` order; no update."""
    import torch

    loss = model(ids, ids).float()
    return loss.item(), torch.autograd.grad(loss, list(model.parameters()))


def _o2_step_vs_plain(seed: int, phase: str, make_cfg, ids,
                      dtype: str = "bfloat16", **report):
    """The O2 step in ``dtype`` (bf16; or float16, guarded by a GradScaler
    at its defaults) of ``make_cfg(flash)`` from one seed with the flash
    kernels and with plain attention. Before each step, the gradients of
    its loss: the kernels' may differ from plain attention's by at most
    BF16_GRAD_SLACK times what ``dtype`` puts between plain attention's
    and a float32 reference (the same weights, plain attention, float32),
    parameter by parameter in relative L2. Then one step each: the losses
    agree within BF16_ULPS ulps of ``dtype``, and the kernel step launches
    exactly 2 forwards per layer (recompute included), one dQ and one
    dK/dV, all on the dtype's routes (wgmma for bf16, wgmma_f16 for
    float16), and no split, the plain step none."""
    import copy

    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.kernels import flash_attention as fa

    n = make_cfg(True).num_layers
    ids_t = torch.as_tensor(ids, device="cuda")
    half = dtype == "float16"
    need = _step_need(dtype, n)

    def one_step(flash: bool):
        step = _o2_step(make_cfg(flash), seed, seed, dtype=dtype,
                        scaler=amp.GradScaler() if half else None)
        _, grads = _loss_and_grads(step.model, ids_t)
        ref_grads = None
        if not flash:
            # the float32 reference: the same weights (bf16, exact in
            # float32) before the update, plain attention
            ref = copy.deepcopy(step.model).float()
            _, ref_grads = _loss_and_grads(ref, ids_t)
            del ref
        fa.reset_launch_counts()
        loss = float(step((ids, ids)))
        names = [name for name, _ in step.model.named_parameters()]
        return (loss, _counts(fa) + (fa.split_bf16_terms.launches,), grads,
                ref_grads, names)

    loss_k, launches, grads_k, _, names = one_step(True)
    _free()
    loss_p, plain_launches, grads_p, grads_ref, _ = one_step(False)
    # the kernel step's launches by route, then its splits: none
    if launches != need + (0,) or any(plain_launches):
        raise AssertionError(f"{phase}: step launches {_COUNT_NAMES} and "
                             f"splits {launches}, expected {need} and 0; "
                             f"the plain step {plain_launches}")
    ulp = f16_ulp if half else bf16_ulp
    tol = BF16_ULPS * ulp(torch.tensor(loss_p)).item()
    if not (math.isfinite(loss_k) and abs(loss_k - loss_p) <= tol):
        raise AssertionError(f"{phase}: loss {loss_k} with the kernels, "
                             f"{loss_p} with plain attention (limit {tol})")
    # per parameter, relative to the reference's norm: kernels vs plain
    # attention, plain attention vs the float32 reference, and the share of
    # the limit BF16_GRAD_SLACK * (plain vs reference) + 2^-24
    rel_kp, rel_pr, share = [], [], []
    for gk, gp, gr in zip(grads_k, grads_p, grads_ref):
        gk, gp, gr = gk.double(), gp.double(), gr.double()
        ref_norm = gr.norm().clamp_min(1e-30)
        rel_kp.append(((gk - gp).norm() / ref_norm).item())
        rel_pr.append(((gp - gr).norm() / ref_norm).item())
        share.append(rel_kp[-1] / (BF16_GRAD_SLACK * rel_pr[-1] + 2.0 ** -24))
    worst = max(range(len(share)), key=share.__getitem__)
    if not all(math.isfinite(x) for x in rel_kp) or share[worst] > 1.0:
        raise AssertionError(
            f"{phase}: gradients, kernels vs plain attention: {names[worst]} "
            f"at relative L2 {rel_kp[worst]}, {share[worst]} of its limit "
            f"({BF16_GRAD_SLACK} x plain attention's {rel_pr[worst]} from "
            f"the float32 reference)")
    out = dict(**report, dtype=dtype, layers=n, batch=list(ids.shape),
               loss_kernel=loss_k, loss_plain=loss_p, tol=tol,
               grad_rel_l2_kernel_vs_plain_max=max(rel_kp),
               grad_rel_l2_plain_vs_f32_max=max(rel_pr),
               grad_worst_param=names[worst],
               grad_worst_share_of_tol=share[worst],
               launches=dict(zip(_COUNT_NAMES, launches)),
               split_launches=launches[-1])
    emit(phase, **out)
    return out


def phase_d256_step(seed: int) -> dict:
    """_o2_step_vs_plain at gpt_1p3b width with 8 heads of 256 (D = 256)
    and 2 layers, batch TRAIN_BATCH x TRAIN_SEQ."""
    import numpy as np

    vocab = _train_config().vocab_size
    ids = np.random.default_rng(seed).integers(
        0, vocab, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)
    return _o2_step_vs_plain(
        seed, "d256_step",
        lambda flash: _train_config(num_layers=2, num_heads=D256_STEP_HEADS,
                                    use_flash_attention=flash), ids,
        model="gpt_1p3b width, 8 heads of 256, 2 layers, O2 bf16",
        head_dim=256)


def phase_d256_fp16_step(seed: int) -> dict:
    """_o2_step_vs_plain in float16 (GradScaler at its defaults) at
    gpt_1p3b width with 8 heads of 256 (D = 256) and 2 layers, batch
    TRAIN_BATCH x TRAIN_SEQ: the gradients and one guarded step through
    the wgmma_f16 forward, dQ and dK/dV at D = 256 (exactly 4, 2 and 2
    launches, no split, no wgmma_f32 kernel) against plain attention. The
    first path that launches the float16 forward and backward at D = 256."""
    import numpy as np

    vocab = _train_config().vocab_size
    ids = np.random.default_rng(seed + 4).integers(
        0, vocab, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)
    return _o2_step_vs_plain(
        seed, "d256_fp16_step",
        lambda flash: _train_config(num_layers=2, num_heads=D256_STEP_HEADS,
                                    dtype="float16",
                                    use_flash_attention=flash), ids,
        dtype="float16",
        model="gpt_1p3b width, 8 heads of 256, 2 layers, O2 float16",
        head_dim=256)


def _llama_config(**overrides):
    """llama2_7b at full width (bf16 KV cache: serving's storage type)."""
    from paddle_tpu_torch.models.llama import llama2_7b

    return llama2_7b(dtype="bfloat16", **overrides)


def _attention_f64(q, k, v, dropout_p=0.0, training=True, use_flash=True):
    """Causal attention on [B, L, H, D] in float64, cast back to q's
    dtype: the reference of the Llama prefill logits check."""
    import torch

    del dropout_p, training, use_flash  # prefill: no dropout, no kernel
    L, D = q.shape[1], q.shape[3]
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) / math.sqrt(D)
    s.masked_fill_(torch.ones(L, L, dtype=torch.bool,
                              device=q.device).triu(1), -math.inf)
    p = torch.softmax(s, dim=-1)
    del s
    return torch.einsum("bhqk,bkhd->bqhd", p, v.double()).to(q.dtype)


def _prefill_logits_vs_f64(model, prompt, cache_len: int) -> dict:
    """One prompt's prefill logits through every layer with the kernels,
    with plain float32 attention and with float64 attention (the rest of
    the model float32 in all three): the kernels' distance from the
    float64 logits may be LLAMA_LOGITS_FACTOR times plain attention's."""
    import torch

    from paddle_tpu_torch.models import lm_utils
    from paddle_tpu_torch.models.generation import init_cache

    ids = torch.as_tensor(prompt[None], device="cuda")

    def prefill_logits():
        with torch.inference_mode():
            return model(ids, cache=init_cache(model, 1, cache_len),
                         position_offset=0)[0]

    flash = prefill_logits()
    plain_attention = lm_utils.causal_attention
    model.cfg.use_flash_attention = False
    try:
        plain = prefill_logits()
        lm_utils.causal_attention = _attention_f64
        ref = prefill_logits()
    finally:
        lm_utils.causal_attention = plain_attention
        model.cfg.use_flash_attention = True
    if not bool(torch.isfinite(flash).all()):
        raise AssertionError("non-finite prefill logits")
    err_kernel = (flash - ref).abs().max().item()
    err_plain = (plain - ref).abs().max().item()
    limit = LLAMA_LOGITS_FACTOR * err_plain
    if not err_kernel <= limit:
        raise AssertionError(f"prefill logits, kernels vs float64 attention: "
                             f"max|err| {err_kernel} > {limit} "
                             f"({LLAMA_LOGITS_FACTOR} x plain float32 "
                             f"attention's {err_plain})")
    return dict(prompt_len=len(prompt), logits_max_abs=ref.abs().max().item(),
                kernel_vs_f64_max_abs_err=err_kernel,
                plain_vs_f64_max_abs_err=err_plain,
                kernel_vs_plain_max_abs_err=(flash - plain).abs().max().item(),
                limit=limit, share_of_limit=err_kernel / limit)


def phase_llama_serving(seed: int) -> dict:
    """llama2_7b at full width and depth (random float32 weights from
    ``seed``, bf16 KV cache) behind InferenceServer(slots=4,
    max_length=4096): six requests held to the serving checks
    (_serve_and_check: the wgmma_f32 forward and its split 32 times per
    prefill), and the 3000-token prompt's prefill logits against float64
    attention (_prefill_logits_vs_f64)."""
    import numpy as np
    import torch

    mem_before = _check_freed("llama_serving")
    torch.cuda.reset_peak_memory_stats()
    model, build_s = _serving_model(seed, _llama_config())
    cfg = model.cfg
    rng = np.random.default_rng(seed + 5)
    requests = [dict(prompt=rng.integers(0, cfg.vocab_size, n),
                     max_new_tokens=16) for n in LLAMA_PROMPT_LENGTHS]
    requests.append(dict(prompt=rng.integers(0, cfg.vocab_size,
                                             LLAMA_SAMPLED_LENGTH),
                         max_new_tokens=16, do_sample=True, seed=7,
                         temperature=0.8, top_p=0.9))
    handles, snap, launches, split_launches, wall_s = _serve_and_check(
        model, requests, 4, dict(max_length=LLAMA_SEQ))
    logits = _prefill_logits_vs_f64(
        model, requests[LLAMA_PROMPT_LENGTHS.index(LLAMA_LOGITS_PROMPT)]["prompt"],
        LLAMA_SEQ)
    out = dict(model="llama2_7b", layers=cfg.num_layers, heads=cfg.num_heads,
               kv_heads=cfg.num_kv_heads,
               params=sum(p.numel() for p in model.parameters()),
               model_build_s=build_s, mem_before_gib=mem_before,
               requests=len(requests),
               prompt_lens=[len(r["prompt"]) for r in requests],
               streams_equal_solo=True, flash_launches=launches,
               split_launches=split_launches,
               prefills=snap["prefills"], decode_steps=snap["decode_steps"],
               wall_s=wall_s, tokens=snap["tokens_emitted"],
               tokens_per_s=snap["tokens_emitted"] / wall_s,
               ttft_ms=[h.ttft_s * 1e3 for h in handles],
               decode_ms_per_token=snap["inter_token"]["mean_ms"],
               decode_ms_per_token_p50=snap["inter_token"]["p50_ms"],
               prefill_logits=logits,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               card=nvidia_smi_line())
    emit("llama_serving", **out)
    return out


def phase_llama_training(seed: int) -> dict:
    """The bf16 O2 step of llama2_7b at full width, cut to
    LLAMA_TRAIN_LAYERS layers (recompute, chunked loss of 256, AdamW(1e-4,
    wd 0.01), batch 1 x 4096): 5 warm-up and 8 timed steps, exactly 16
    wgmma forward, 8 dQ and 8 dK/dV launches per step."""
    import numpy as np
    import torch

    from paddle_tpu_torch.models.llama import llama_flops_per_token

    mem_before = _check_freed("llama_training")
    cfg = _llama_config(num_layers=LLAMA_TRAIN_LAYERS, use_recompute=True,
                        loss_chunk=256)
    t0 = time.perf_counter()
    step = _o2_step(cfg, seed, seed)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ids = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, LLAMA_SEQ)).astype(np.int32)
    n = cfg.num_layers
    need = _step_need("bfloat16", n)
    return _train_run("llama_training",
                      f"llama2_7b, {n} of 32 layers, O2 bf16", step, ids,
                      need, llama_flops_per_token(cfg, LLAMA_SEQ), build_s,
                      reduced=f"num_layers 32 -> {n} (optimizer state)",
                      mem_before_gib=mem_before)


def phase_llama_gqa_grads(seed: int) -> dict:
    """_o2_step_vs_plain on llama2_7b with LLAMA_GQA_KV_HEADS KV heads
    (4 query heads each) and LLAMA_GQA_LAYERS layers at [1, 4096]: GQA's
    repeat of K and V (a sum over each group in the backward) feeds the
    kernels' dK and dV."""
    import numpy as np

    mem_before = _check_freed("llama_gqa_grads")
    ids = np.random.default_rng(seed + 6).integers(
        0, _llama_config().vocab_size, (1, LLAMA_SEQ)).astype(np.int32)
    return _o2_step_vs_plain(
        seed, "llama_gqa_grads",
        lambda flash: _llama_config(
            num_layers=LLAMA_GQA_LAYERS, num_kv_heads=LLAMA_GQA_KV_HEADS,
            use_recompute=True, loss_chunk=256, use_flash_attention=flash),
        ids, model=f"llama2_7b width, {LLAMA_GQA_KV_HEADS} KV heads, "
                   f"{LLAMA_GQA_LAYERS} layers, O2 bf16",
        kv_heads=LLAMA_GQA_KV_HEADS, head_dim=128,
        reduced=f"num_layers 32 -> {LLAMA_GQA_LAYERS}, num_kv_heads 32 -> "
                f"{LLAMA_GQA_KV_HEADS}", mem_before_gib=mem_before)


# ------------------------------------------------------------ encoder path
# Transformer-base (phase_transformer_base): the port's nn.Transformer() at
# its defaults (d_model 512, 8 heads of 64, 6 + 6 layers, FFN 2048, ReLU,
# dropout 0.1) between a shared source/target embedding of TB_VOCAB words
# (the WMT14 en-de joint BPE vocabulary of the Transformer paper) and a tied
# output projection, label smoothing 0.1; batch TB_BATCH x source TB_SRC /
# target TB_TGT with per-row lengths from the seed
TB_VOCAB, TB_MODEL, TB_HEADS, TB_LAYERS = 37000, 512, 8, 6
TB_BATCH, TB_SRC, TB_TGT = 32, 256, 200
TB_SRC_MIN, TB_TGT_MIN, TB_PAD = 128, 100, 0
TB_LABEL_SMOOTHING = 0.1
TB_PATH = "training (Transformer-base bf16 O2 step, dropout 0.1)"
# its three attention calls a layer: (name, Lq, Lk, the mask's key)
TB_ATTENTION = (("enc_self", TB_SRC, TB_SRC, "src_mask"),
                ("dec_self", TB_TGT, TB_TGT, "tgt_mask"),
                ("cross", TB_TGT, TB_SRC, "memory_mask"))
# BERT-base (phase_bert_base): sequence classification at [32, 128] with
# rows of 32-128 tokens, BertForPretraining at [8, 512] with 76 masked
# positions a row (15 % of 512), ERNIE-3.0-base forward at [8, 512]
BERT_BATCH, BERT_SEQ, BERT_MIN_LEN = 32, 128, 32
BERT_PRETRAIN_BATCH, BERT_PRETRAIN_SEQ, BERT_MASKED = 8, 512, 76
BERT_LR, BERT_LR_WARMUP = 5e-5, 5
# a float32 BertModel against the same module in float64 on the card:
# max |f32 - f64| over the largest |f64| of the outputs. Each of the 12
# post-LN layers rounds its float32 sums (contractions of 768 to 3072
# terms) at 2^-24 relative; 1e-4 is about 1700 such roundings, far above
# what 12 layers of them accumulate and far below what a wrong operation
# gives (order 1 after a LayerNorm)
BERT_F64_RTOL = 1e-4


def _encoder_masks(seed: int):
    """The Transformer-base batch's masks on the card, from per-row
    lengths drawn from ``seed`` (source TB_SRC_MIN..TB_SRC, target
    TB_TGT_MIN..TB_TGT): ``src_mask`` bool ``[B, 1, Ls, Ls]`` (key
    padding), ``tgt_mask`` float ``[B, 1, Lt, Lt]`` (0 where kept, -inf
    above the diagonal and on padded keys), ``memory_mask`` bool ``[B, 1,
    Lt, Ls]`` (source key padding). Every query row keeps key 0, so no row
    is fully masked."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    src_len = rng.integers(TB_SRC_MIN, TB_SRC + 1, TB_BATCH)
    tgt_len = rng.integers(TB_TGT_MIN, TB_TGT + 1, TB_BATCH)
    dev = "cuda"
    src_keep = (torch.arange(TB_SRC, device=dev)[None, :]
                < torch.as_tensor(src_len, device=dev)[:, None])
    tgt_keep = (torch.arange(TB_TGT, device=dev)[None, :]
                < torch.as_tensor(tgt_len, device=dev)[:, None])
    causal = torch.ones(TB_TGT, TB_TGT, dtype=torch.bool, device=dev).tril()
    tgt_keep_qk = causal[None] & tgt_keep[:, None, :]
    tgt_mask = torch.zeros(TB_BATCH, 1, TB_TGT, TB_TGT, device=dev)
    tgt_mask.masked_fill_(~tgt_keep_qk[:, None], float("-inf"))
    return dict(
        src_len=src_len, tgt_len=tgt_len,
        src_mask=src_keep[:, None, None, :].expand(
            TB_BATCH, 1, TB_SRC, TB_SRC).contiguous(),
        tgt_mask=tgt_mask,
        memory_mask=src_keep[:, None, None, :].expand(
            TB_BATCH, 1, TB_TGT, TB_SRC).contiguous())


def _sdpa_bias(mask):
    """The bias SDPA hands the kernels for ``mask``: a boolean keep-mask as
    float32 0 / -1e30, a float mask as it is."""
    import torch

    if mask.dtype != torch.bool:
        return mask
    return torch.zeros(mask.shape, device=mask.device).masked_fill_(
        ~mask, -1e30)


class _PathTally:
    """Counts, while open, the launches of the tensor-core forward, dQ and
    dK/dV kernels by the (Lq, Lk) of their q and k (at the launch
    functions the wrappers call, whose counts stay the wrappers' own), and
    the dS outputs that reach autograd (each passes through
    ``_reduce_dbias``)."""

    def __init__(self, fa):
        self.fa = fa
        self.calls = {"fwd": {}, "dq": {}, "dkv": {}}
        self.ds_outputs = 0

    def _note(self, kernel, q, k):
        key = (q.shape[2], k.shape[2])
        self.calls[kernel][key] = self.calls[kernel].get(key, 0) + 1

    def __enter__(self):
        fa = self.fa
        self._saved = (fa._launch_fwd_sm90, fa._launch_bwd_sm90,
                       fa._reduce_dbias)
        launch_fwd, launch_bwd, reduce = self._saved

        def fwd(route, q, k, *args, **kwargs):
            self._note("fwd", q, k)
            return launch_fwd(route, q, k, *args, **kwargs)

        def bwd(which, route, q, k, *args, **kwargs):
            self._note(which, q, k)
            return launch_bwd(which, route, q, k, *args, **kwargs)

        def counted_reduce(ds, bias):
            self.ds_outputs += 1
            return reduce(ds, bias)

        fa._launch_fwd_sm90, fa._launch_bwd_sm90 = fwd, bwd
        fa._reduce_dbias = counted_reduce
        return self

    def __exit__(self, *exc):
        fa = self.fa
        fa._launch_fwd_sm90, fa._launch_bwd_sm90, fa._reduce_dbias = \
            self._saved
        return False

    def snapshot(self):
        return ({k: dict(v) for k, v in self.calls.items()}, self.ds_outputs)


def _transformer_base_lm(seed: int):
    """A thin driver of ported public modules only: a shared source/target
    ``Embedding(TB_VOCAB, 512)`` (scaled by sqrt(512)) plus a learned
    position ``Embedding``, ``nn.Transformer()`` at its defaults, an output
    projection tied to the shared embedding, and ``F.cross_entropy`` with
    label smoothing, ignoring the pad id. ``forward(src, tgt_in, tgt_out,
    src_mask, tgt_mask, memory_mask)`` returns the loss."""
    import torch
    from torch import nn

    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn.initializer import Normal
    from paddle_tpu_torch.distributed.parallel.mp_layers import parallel_matmul
    from paddle_tpu_torch.nn.layers.common import Embedding
    from paddle_tpu_torch.nn.layers.transformer import Transformer

    class TransformerBaseLM(nn.Module):
        def __init__(self):
            super().__init__()
            g = torch.Generator(device="cuda").manual_seed(seed)
            self.embed = Embedding(TB_VOCAB, TB_MODEL, padding_idx=TB_PAD,
                                   weight_attr=Normal(0.0, TB_MODEL ** -0.5),
                                   device="cuda", generator=g)
            self.pos = Embedding(TB_SRC, TB_MODEL,
                                 weight_attr=Normal(0.0, 0.02),
                                 device="cuda", generator=g)
            self.transformer = Transformer(device="cuda", generator=g)

        def _embed(self, ids):
            pos = torch.arange(ids.shape[1], device=ids.device)
            return self.embed(ids) * TB_MODEL ** 0.5 + self.pos(pos)

        def forward(self, src, tgt_in, tgt_out, src_mask, tgt_mask,
                    memory_mask):
            h = self.transformer(self._embed(src), self._embed(tgt_in),
                                 src_mask, tgt_mask, memory_mask)
            logits = parallel_matmul(h, self.embed.weight, transpose_y=True)
            return F.cross_entropy(logits, tgt_out, ignore_index=TB_PAD,
                                   label_smoothing=TB_LABEL_SMOOTHING)

    return TransformerBaseLM()


def _transformer_base_batch(seed: int):
    """The Transformer-base step's batch on the card, ``(src, tgt_in,
    tgt_out, src_mask, tgt_mask, memory_mask)``: seeded tokens padded
    (TB_PAD) past each row's length, the target shifted by one, and the
    masks of :func:`_encoder_masks` (returned too)."""
    import numpy as np
    import torch

    masks = _encoder_masks(seed)
    rng = np.random.default_rng(seed + 3)

    def tokens(lengths, L):
        ids = rng.integers(1, TB_VOCAB, (TB_BATCH, L))
        ids[np.arange(L)[None, :] >= lengths[:, None]] = TB_PAD
        return torch.as_tensor(ids, device="cuda")

    src = tokens(masks["src_len"], TB_SRC)
    # a row of length n has n + 1 target tokens: n in, n out
    tgt = tokens(masks["tgt_len"] + 1, TB_TGT + 1)
    return (src, tgt[:, :-1].contiguous(), tgt[:, 1:].contiguous(),
            masks["src_mask"], masks["tgt_mask"], masks["memory_mask"]), masks


def _encoder_train_run(phase: str, step, batch, need, tokens: int,
                       tally=None, **report) -> dict:
    """TRAIN_WARMUP + TRAIN_TIMED steps of ``step`` on ``batch``: finite
    losses that fall, exactly ``need`` launches (in the order of
    _COUNT_NAMES) every step; with ``tally`` (a :class:`_PathTally`) its
    per-step calls by shape and dS outputs. Reports the median step
    (host clock, synchronised), ``tokens`` a step per second and peak
    memory."""
    import numpy as np
    import torch

    from paddle_tpu_torch.kernels import flash_attention as fa

    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, per_step, per_step_shapes = [], [], [], []
    fa.reset_launch_counts()
    for _ in range(TRAIN_WARMUP + TRAIN_TIMED):
        before = _counts(fa)
        shapes_before = tally.snapshot() if tally is not None else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(batch)
        losses.append(float(loss))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append(tuple(a - b for a, b in zip(_counts(fa), before)))
        if tally is not None:
            (calls, ds), (calls0, ds0) = tally.snapshot(), shapes_before
            per_step_shapes.append((
                {w: {s: n - calls0[w].get(s, 0) for s, n in c.items()}
                 for w, c in calls.items()}, ds - ds0))
    if any(c != need for c in per_step):
        raise AssertionError(f"{phase}: launches per step {_COUNT_NAMES} "
                             f"{per_step}, expected {need} every step")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: losses {losses}: not finite or not "
                             f"falling")
    timed = step_ms[TRAIN_WARMUP:]
    out = dict(**report, losses=losses,
               launches=dict(zip(_COUNT_NAMES, _counts(fa))),
               launches_per_step=dict(zip(_COUNT_NAMES, need)),
               step_ms=step_ms, step_ms_median=float(np.median(timed)),
               tokens_per_step=tokens,
               tokens_per_s=tokens * TRAIN_TIMED / (sum(timed) / 1e3),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               card=nvidia_smi_line())
    if tally is not None:
        out["per_step_shapes"] = per_step_shapes
    return out


def phase_transformer_base(seed: int) -> dict:
    """Transformer-base at full width through TrainStep, bf16 O2 AdamW:
    every attention call on the flash kernels (non-causal with a mask as
    a bias; Lq 200 / Lk 256 in cross-attention; dropout 0.1 in the
    kernels): exactly 18 wgmma forward, 18 dQ and 18 dK/dV launches a step
    (6 of each attention shape), no dS output, falling losses."""
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.framework import random as framework_random
    from paddle_tpu_torch.framework.jit import TrainStep
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW

    leftover = _check_freed("transformer_base")
    framework_random.seed(seed)
    t0 = time.perf_counter()
    model = _transformer_base_lm(seed).train()
    model, opt = amp.decorate(model, AdamW(learning_rate=5e-4,
                                           weight_decay=0.01),
                              level="O2", dtype="bfloat16")
    step = TrainStep(model, opt, loss_fn=None)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    batch, masks = _transformer_base_batch(seed)
    n_layers = 3 * TB_LAYERS  # self-attention x 2 stacks, cross-attention
    need = _need(fwd_wgmma=n_layers, dq_wgmma=n_layers, dkv_wgmma=n_layers)
    with _PathTally(fa) as tally:
        out = _encoder_train_run(
            "transformer_base", step, batch, need,
            tokens=TB_BATCH * (TB_SRC + TB_TGT), tally=tally,
            model="Transformer-base (nn.Transformer defaults)",
            batch_shape=[TB_BATCH, TB_SRC, TB_TGT], vocab=TB_VOCAB,
            dropout=DROPOUT_P, label_smoothing=TB_LABEL_SMOOTHING,
            params=sum(p.numel() for p in step.params.values()),
            model_build_s=build_s, leftover_gib_at_start=leftover,
            source_tokens=int(masks["src_len"].sum()),
            target_tokens=int(masks["tgt_len"].sum()))
        calls, ds_outputs = tally.snapshot()
    want_shape = {(Lq, Lk): TB_LAYERS for _, Lq, Lk, _ in TB_ATTENTION}
    for shapes, ds in out.pop("per_step_shapes"):
        if any(shapes[w] != want_shape for w in shapes) or ds:
            raise AssertionError(f"transformer_base: calls by (Lq, Lk) "
                                 f"{shapes} and {ds} dS outputs in a step, "
                                 f"expected {want_shape} and 0")
    launches = out["launches"]
    for w in ("fwd", "dq", "dkv"):
        if sum(calls[w].values()) != launches[f"{w}_wgmma"]:
            raise AssertionError(f"transformer_base: {calls[w]} {w} calls "
                                 f"against {launches[f'{w}_wgmma']} launches")
    out["launches_by_shape"] = {
        name: {w: calls[w].get((Lq, Lk), 0) for w in calls}
        for name, Lq, Lk, _ in TB_ATTENTION}
    out["ds_outputs"] = ds_outputs
    out["target_tokens_per_s"] = (out["target_tokens"] * TRAIN_TIMED
                                  / (sum(out["step_ms"][TRAIN_WARMUP:]) / 1e3))
    emit("transformer_base", **out)
    del step, model, opt, batch, masks
    _free()
    return out


def _grad_rel_l2(got, ref) -> float:
    return ((got.float() - ref.float()).norm() / ref.float().norm()).item()


def _sdpa_check(F, fa, name, q, k, v, do, mask, dtype, want_route,
                trained: bool = False) -> dict:
    """The port's SDPA on the card (the kernel branch) against its plain
    branch on the same inputs: the output and the gradients of q, k, v
    (and of a trained float ``mask``) through autograd. float32: the
    kernels' stated tolerances against the float32 plain branch. bf16:
    the output within 2 bf16 ulps of the float32 plain branch's, and each
    gradient's relative L2 distance from the float32 plain branch's
    within BF16_GRAD_SLACK times the bf16 plain branch's own."""
    import torch

    def run(branch, xs, m):
        xs = [x.detach().requires_grad_() for x in xs]
        wrt = list(xs)
        if trained:
            m = m.detach().requires_grad_()
            wrt.append(m)
        o = branch(*xs, m)
        return o, torch.autograd.grad(o, wrt, do.to(o.dtype))

    fa.reset_launch_counts()
    o, grads = run(lambda q_, k_, v_, m: F.scaled_dot_product_attention(
        q_, k_, v_, attn_mask=m, training=False), (q, k, v), mask)
    torch.cuda.synchronize()
    routes = {w: _route_of(fa, w) for w in ("fwd", "dq", "dkv")}
    if set(routes.values()) != {want_route}:
        raise AssertionError(f"{name}: routes {fa.launch_counts()}, "
                             f"expected {want_route}")
    plain = F._plain_attention
    m32 = mask if mask.dtype == torch.bool else mask.float()
    o32, g32 = run(plain, [x.float() for x in (q, k, v)], m32)
    keys = ("dq", "dk", "dv", "dmask")[:len(grads)]
    out = dict(shape=list(q.shape[:1]) + [q.shape[2], q.shape[1], k.shape[1],
                                          q.shape[3]],
               mask=list(mask.shape), mask_dtype=_dtype_name(mask),
               trained_mask=trained, dtype=_dtype_name(q), routes=routes)
    if dtype == torch.float32:
        out["errors"] = {"o": check_close(f"{name} o", o, o32,
                                          output_tolerance(o32, want_route))}
        for key, g, r in zip(keys, grads, g32):
            out["errors"][key] = check_close(f"{name} {key}", g, r,
                                             bwd_tolerance(r))
        out["tol"] = (f"o {F32_FWD_ATOL} + {F32_FWD_RTOL} |ref|; grads rtol "
                      f"{BWD_RTOL} atol {BWD_ATOL}")
        return out
    out["errors"] = {"o": check_close(f"{name} o", o, o32, output_tolerance(
        o32.to(dtype), want_route))}
    _, g16 = run(plain, (q, k, v), mask)
    for key, g, r, p in zip(keys, grads, g32, g16):
        got, bf16_plain = _grad_rel_l2(g, r), _grad_rel_l2(p, r)
        if not (math.isfinite(got) and got <= BF16_GRAD_SLACK * bf16_plain):
            raise AssertionError(f"{name} {key}: kernels' relative L2 "
                                 f"distance from float32 {got}, plain "
                                 f"bf16's {bf16_plain}")
        out["errors"][key] = dict(
            max_abs_err=(g.float() - r.float()).abs().max().item(),
            rel_l2=got, plain_bf16_rel_l2=bf16_plain)
    out["tol"] = (f"o {BF16_ULPS} bf16 ulps + 1e-6 of float32's; grads "
                  f"relative L2 within {BF16_GRAD_SLACK} x plain bf16's")
    return out


def _sdpa_dropout_check(fa, name, q, k, v, do, bias, seed) -> dict:
    """The bf16 kernels at p = DROPOUT_P, as the Transformer-base step runs
    them, against their plain versions given the same Philox mask, at the
    kernels' stated bf16 tolerances."""
    import torch

    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    B, H, Lq, _ = qt.shape
    keep = fa.dropout_mask(seed, B, H, Lq, kt.shape[2], DROPOUT_P, "cuda")
    o, lse = fa.flash_attention_fwd(qt, kt, vt, bias=bias,
                                    dropout_p=DROPOUT_P, seed=seed)
    got = fa.flash_attention_bwd(qt, kt, vt, bias, o, lse, dot, False,
                                 DROPOUT_P, seed, bias_grad=False)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.reference_attention_fwd(qt, kt, vt, bias=bias,
                                                keep_mask=keep)
    errs = {"o": check_close(f"{name} o", o, o_ref,
                             output_tolerance(o_ref, "wgmma")),
            "lse": check_close(f"{name} lse", lse, lse_ref,
                               lse_tolerance(lse_ref, "wgmma"))}
    ref = fa.reference_attention_bwd(qt, kt, vt, bias, o, lse, dot, False,
                                     keep)
    for key, x, y in zip(("dq", "dk", "dv"), got, ref):
        errs[key] = check_close(f"{name} {key}", x, y, bwd_tolerance(y))
    return errs


def _time_path_kernels(fa, q, k, v, do, mask, seed) -> dict:
    """Device times of the forward, dQ and dK/dV kernels at one attention
    call of the Transformer-base step (bf16, non-causal, p = DROPOUT_P, the
    mask as SDPA hands it over, no dS), in turns with torch's SDPA on the
    same mask and dropout rate (forward, and forward + backward: the
    backward is the difference), beside their plain versions and bounds,
    and the time of SDPA's mask conversion and the wrappers' bias
    preparation (once per forward); the kernels at p = 0 as well."""
    import torch

    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    bias = _sdpa_bias(mask)
    B, H, Lq, D = qt.shape
    Lk = kt.shape[2]
    o, lse = fa.flash_attention_fwd(qt, kt, vt, bias=bias,
                                    dropout_p=DROPOUT_P, seed=seed)
    do_k = dot if fa._tma_ok(dot) else dot.contiguous()
    delta = (do_k.float() * o.float()).sum(-1).contiguous()
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
    # torch's fused SDPA takes a float mask in the query's dtype only
    lib_mask = mask if mask.dtype == torch.bool else mask.to(qt.dtype)

    def sdpa_fwd():
        with torch.no_grad():
            torch.nn.functional.scaled_dot_product_attention(
                qg, kg, vg, attn_mask=lib_mask, dropout_p=DROPOUT_P)

    def sdpa_fwd_bwd():
        out = torch.nn.functional.scaled_dot_product_attention(
            qg, kg, vg, attn_mask=lib_mask, dropout_p=DROPOUT_P)
        torch.autograd.grad(out, (qg, kg, vg), dot)

    t = timed_in_turns({
        "fwd": lambda: fa.flash_attention_fwd(qt, kt, vt, bias=bias,
                                              dropout_p=DROPOUT_P, seed=seed),
        "dq": lambda: fa.flash_attention_bwd_dq(
            qt, kt, vt, bias, do_k, lse, delta, False, DROPOUT_P, seed),
        "dkv": lambda: fa.flash_attention_bwd_dkv(
            qt, kt, vt, bias, do_k, lse, delta, False, DROPOUT_P, seed),
        # the same kernels without dropout: what the Philox draws cost
        "fwd_p0": lambda: fa.flash_attention_fwd(qt, kt, vt, bias=bias),
        "dq_p0": lambda: fa.flash_attention_bwd_dq(
            qt, kt, vt, bias, do_k, lse, delta, False),
        "dkv_p0": lambda: fa.flash_attention_bwd_dkv(
            qt, kt, vt, bias, do_k, lse, delta, False),
        "sdpa_fwd": sdpa_fwd, "sdpa_fwd_bwd": sdpa_fwd_bwd,
        "mask_bias": lambda: fa._kernel_bias(_sdpa_bias(mask), B, H, Lq, Lk,
                                             q.device)})
    keep = fa.dropout_mask(seed, B, H, Lq, Lk, DROPOUT_P, "cuda")
    plain_fwd = cuda_ms(lambda: fa.reference_attention_fwd(
        qt, kt, vt, bias=bias, keep_mask=keep), iters=5)
    plain_bwd = cuda_ms(lambda: fa.reference_attention_bwd(
        qt, kt, vt, bias, o, lse, dot, False, keep), iters=5)
    # each kernel's least time: its bytes or products, or this call's mask
    # draws on the integer units, whichever is larger
    mask_ms = B * H * Lq * Lk * PHILOX_OPS / PEAK_INT32_OPS * 1e3
    common = (B, H, Lq, Lk, D, False, qt.element_size(), bias.numel() * 4)
    bounds = {"fwd": attention_bound_ms(*common, tensor_cores=True),
              "dq": bwd_bound_ms("dq", *common, 0, tensor_cores=True),
              "dkv": bwd_bound_ms("dkv", *common, 0, tensor_cores=True)}
    library = {"fwd": t["sdpa_fwd"]["median"],
               "bwd": t["sdpa_fwd_bwd"]["median"] - t["sdpa_fwd"]["median"]}
    out = {}
    for w in ("fwd", "dq", "dkv"):
        bound, by = bounds[w]
        if mask_ms > bound:
            bound, by = mask_ms, "operations"
        out[w] = dict(ms=t[w]["median"], ms_range=[t[w]["min"], t[w]["max"]],
                      ms_p0=t[f"{w}_p0"]["median"],
                      ms_p0_range=[t[f"{w}_p0"]["min"], t[f"{w}_p0"]["max"]],
                      plain_ms=plain_fwd if w == "fwd" else plain_bwd,
                      bound_ms=bound, bound_by=by,
                      library_ms=library["fwd" if w == "fwd" else "bwd"],
                      roofline_share=bound / t[w]["median"])
    out["mask_bias_ms"] = t["mask_bias"]["median"]
    out["library_fwd_bwd_ms"] = t["sdpa_fwd_bwd"]["median"]
    return out


def phase_sdpa_routes(seed: int) -> dict:
    """The port's SDPA at the Transformer-base step's three attention
    calls, in bf16 and float32, against its plain branch (the kernels'
    stated tolerances; a float32 -inf mask too, and left padding whose
    first key tile is all -inf); a trained float mask broadcast over the
    batch and over the heads (the dQ kernel's dS and its reduction); the
    bf16 kernels at p = DROPOUT_P against their plain versions given the
    same mask; causal attention with Lq != Lk, which must launch no
    kernel and mask bottom-right; and each kernel at each call timed
    against torch's SDPA with the same mask."""
    import numpy as np
    import torch

    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.nn import functional as F

    leftover = _check_freed("sdpa_routes")
    masks = _encoder_masks(seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 4)
    D = TB_MODEL // TB_HEADS

    def rn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    out = dict(leftover_gib_at_start=leftover, checks={}, timing={})
    # left padding: every row's first pad keys (64-100, so the first key
    # tile of a row is all -inf) masked with -inf in a float mask
    pad = np.random.default_rng(seed + 5).integers(64, 101, TB_BATCH)
    left = torch.zeros(TB_BATCH, 1, TB_TGT, TB_TGT, device="cuda")
    left.masked_fill_((torch.arange(TB_TGT, device="cuda")[None, :]
                       < torch.as_tensor(pad, device="cuda")[:, None])
                      [:, None, None, :], float("-inf"))
    cases = [(name, Lq, Lk, masks[key]) for name, Lq, Lk, key in TB_ATTENTION]
    cases.append(("dec_self_left_pad", TB_TGT, TB_TGT, left))
    for dtype, route in ((torch.bfloat16, "wgmma"),
                         (torch.float32, "wgmma_f32")):
        for name, Lq, Lk, mask in cases:
            q, do = (rn(TB_BATCH, Lq, TB_HEADS, D, dtype=dtype)
                     for _ in range(2))
            k, v = (rn(TB_BATCH, Lk, TB_HEADS, D, dtype=dtype)
                    for _ in range(2))
            case = f"{name}_{_dtype_name(q)}"
            out["checks"][case] = _sdpa_check(F, fa, case, q, k, v, do, mask,
                                              dtype, route)
            if dtype == torch.bfloat16 and name != "dec_self_left_pad":
                out["checks"][case]["dropout_errors"] = _sdpa_dropout_check(
                    fa, case, q, k, v, do, _sdpa_bias(mask), seed + 7)
                out["timing"][name] = _time_path_kernels(
                    fa, q, k, v, do, mask, seed + 7)
            del q, k, v, do
        # trained float masks at the encoder's self-attention, broadcast
        # over the batch ([1, H, L, L]) and over the heads ([B, 1, L, L]):
        # the dQ kernel writes dS, summed over the broadcast dimension
        for mshape in ((1, TB_HEADS, TB_SRC, TB_SRC),
                       (TB_BATCH, 1, TB_SRC, TB_SRC)):
            q, k, v, do = (rn(TB_BATCH, TB_SRC, TB_HEADS, D, dtype=dtype)
                           for _ in range(4))
            case = f"trained_mask_{'x'.join(map(str, mshape))}_{_dtype_name(q)}"
            with _PathTally(fa) as tally:
                out["checks"][case] = _sdpa_check(
                    F, fa, case, q, k, v, do, rn(*mshape), dtype, route,
                    trained=True)
            if tally.ds_outputs != 1:
                raise AssertionError(f"{case}: {tally.ds_outputs} dS outputs, "
                                     f"expected 1")
    # the dQ kernel with its dS output at the trained [1, H, L, L] mask
    # (bf16), and the reduction of dS over the batch, timed
    q, k, v, do = (rn(TB_BATCH, TB_SRC, TB_HEADS, D,
                      dtype=torch.bfloat16).transpose(1, 2) for _ in range(4))
    bias = rn(1, TB_HEADS, TB_SRC, TB_SRC)
    o, lse = fa.flash_attention_fwd(q, k, v, bias=bias)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    do_k = do if fa._tma_ok(do) else do.contiguous()
    ds = fa.flash_attention_bwd_dq(q, k, v, bias, do_k, lse, delta,
                                   emit_ds=True)[1]
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    mg = bias.detach().to(q.dtype).requires_grad_()  # torch's dtype rule

    def sdpa_fwd():
        with torch.no_grad():
            torch.nn.functional.scaled_dot_product_attention(
                qg, kg, vg, attn_mask=mg)

    def sdpa_fwd_bwd():
        o_ = torch.nn.functional.scaled_dot_product_attention(
            qg, kg, vg, attn_mask=mg)
        torch.autograd.grad(o_, (qg, kg, vg, mg), do)

    t = timed_in_turns({
        "dq_ds": lambda: fa.flash_attention_bwd_dq(
            q, k, v, bias, do_k, lse, delta, emit_ds=True),
        "reduce": lambda: fa._reduce_dbias(ds, bias),
        "sdpa_fwd": sdpa_fwd, "sdpa_fwd_bwd": sdpa_fwd_bwd})
    B, H, L, _ = q.shape
    bound, by = bwd_bound_ms("dq", B, H, L, L, D, False, 2, bias.numel() * 4,
                             B * H * L * L * 4, tensor_cores=True)
    out["timing"]["trained_mask_ds"] = dict(
        shape=[B, H, L, L, D], mask=list(bias.shape), ms=t["dq_ds"]["median"],
        ms_range=[t["dq_ds"]["min"], t["dq_ds"]["max"]],
        reduce_ms=t["reduce"]["median"], bound_ms=bound, bound_by=by,
        roofline_share=bound / t["dq_ds"]["median"],
        library_ms=t["sdpa_fwd_bwd"]["median"] - t["sdpa_fwd"]["median"],
        plain_ms=cuda_ms(lambda: fa.reference_attention_bwd(
            q, k, v, bias, o, lse, do, False), iters=5))
    del q, k, v, do, o, lse, delta, do_k, ds, qg, kg, vg, mg
    # causal with Lq != Lk: the plain branch alone, bottom-right aligned
    q = rn(TB_BATCH, TB_TGT, TB_HEADS, D, dtype=torch.bfloat16)
    k, v = (rn(TB_BATCH, TB_SRC, TB_HEADS, D, dtype=torch.bfloat16)
            for _ in range(2))
    fa.reset_launch_counts()
    got = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                         training=False)
    torch.cuda.synchronize()
    if any(n for c in fa.launch_counts().values() for n in c.values()):
        raise AssertionError(f"causal Lq != Lk launched {fa.launch_counts()}")
    # the same plain computation with the mask spelled out: bottom-right
    # gives the same bits, top-left (the kernels' alignment) does not
    ones = torch.ones(TB_TGT, TB_SRC, dtype=torch.bool, device="cuda")
    bottom_right = F._plain_attention(q, k, v, ones.tril(TB_SRC - TB_TGT))
    top_left = F._plain_attention(q, k, v, ones.tril())
    if not torch.equal(got, bottom_right) or torch.equal(got, top_left):
        raise AssertionError("causal Lq != Lk is not aligned bottom-right")
    out["checks"]["causal_lq_ne_lk_bf16"] = dict(
        shape=[TB_BATCH, TB_HEADS, TB_TGT, TB_SRC, D], launches=0,
        aligned="bottom-right", equal_to_bottom_right_mask=True,
        top_left_max_abs_diff=(got.float() - top_left.float()).abs()
        .max().item())
    del q, k, v, got, bottom_right, top_left, masks, left
    emit("sdpa_routes", **out)
    _free()
    return out


def _bert_optimizer():
    """BERT fine-tuning's recipe: AdamW at BERT_LR after a linear warm-up
    of BERT_LR_WARMUP steps from 0. At a constant 1e-4 the first updates
    of the random post-LN encoder threw the loss from 0.67 to 1.9, and 13
    steps on one batch ended near the start (0.66): nothing learned."""
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import LinearWarmup

    return AdamW(learning_rate=LinearWarmup(BERT_LR, BERT_LR_WARMUP, 0.0,
                                            BERT_LR), weight_decay=0.01)


def _bert_classification_batch(seed: int, vocab: int):
    """The BERT-base step's batch on the card, ``(ids, None, None,
    labels)`` (``[BERT_BATCH, BERT_SEQ]`` seeded ids padded with 0 past
    row lengths of BERT_MIN_LEN..BERT_SEQ, two classes), and the
    lengths."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed + 12)
    lengths = rng.integers(BERT_MIN_LEN, BERT_SEQ + 1, BERT_BATCH)
    ids = rng.integers(1, vocab, (BERT_BATCH, BERT_SEQ))
    ids[np.arange(BERT_SEQ)[None, :] >= lengths[:, None]] = 0
    labels = rng.integers(0, 2, BERT_BATCH)
    return (torch.as_tensor(ids, device="cuda"), None, None,
            torch.as_tensor(labels, device="cuda")), lengths


def phase_bert_base(seed: int) -> dict:
    """BertForSequenceClassification(bert_base()) through TrainStep, bf16
    O2 AdamW, on one padded batch: falling losses and no flash launch (its
    attention is plain by design); BertForPretraining forward and backward
    at [8, 512] with 76 masked positions a row; ERNIE-3.0-base's
    classifier forward at [8, 512]; a float32 BertModel forward against
    the same module in float64."""
    import copy

    import numpy as np
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.framework import random as framework_random
    from paddle_tpu_torch.framework.jit import TrainStep
    from paddle_tpu_torch.models.bert import (BertForPretraining,
                                              BertForSequenceClassification,
                                              BertModel, bert_base)
    from paddle_tpu_torch.models.ernie import (ErnieForSequenceClassification,
                                               ernie_3_base)
    from paddle_tpu_torch.optimizer import AdamW

    leftover = _check_freed("bert_base")
    rng = np.random.default_rng(seed + 11)

    def padded_ids(B, L, lo, vocab):
        lengths = rng.integers(lo, L + 1, B)
        ids = rng.integers(1, vocab, (B, L))
        ids[np.arange(L)[None, :] >= lengths[:, None]] = 0  # pad_token_id
        return torch.as_tensor(ids, device="cuda"), lengths

    def gen(offset):
        return torch.Generator(device="cuda").manual_seed(seed + offset)

    cfg = bert_base()
    framework_random.seed(seed)
    t0 = time.perf_counter()
    model = BertForSequenceClassification(cfg, device="cuda",
                                          generator=gen(0)).train()
    model, opt = amp.decorate(model, _bert_optimizer(), level="O2",
                              dtype="bfloat16")
    step = TrainStep(model, opt, loss_fn=None)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    batch, lengths = _bert_classification_batch(seed, cfg.vocab_size)
    out = _encoder_train_run(
        "bert_base", step, batch, _need(),
        tokens=int(lengths.sum()), model="bert_base classification",
        batch_shape=[BERT_BATCH, BERT_SEQ], params=sum(
            p.numel() for p in step.params.values()),
        model_build_s=build_s, leftover_gib_at_start=leftover)
    del step, model, opt
    _free()

    # masked-LM + next-sentence pretraining, bf16 O2: one forward and
    # backward, timed over 3 after one warm-up
    model = amp.decorate(BertForPretraining(cfg, device="cuda",
                                            generator=gen(1)).train(),
                         level="O2", dtype="bfloat16")
    pids, _ = padded_ids(BERT_PRETRAIN_BATCH, BERT_PRETRAIN_SEQ,
                         BERT_PRETRAIN_SEQ // 2, cfg.vocab_size)
    positions = torch.as_tensor(np.stack([
        np.sort(rng.choice(BERT_PRETRAIN_SEQ, BERT_MASKED, replace=False))
        for _ in range(BERT_PRETRAIN_BATCH)]), device="cuda")
    mlm_labels = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (BERT_PRETRAIN_BATCH, BERT_MASKED)), device="cuda")
    mlm_labels[:, -4:] = -1  # padded label slots are ignored
    nsp = torch.as_tensor(rng.integers(0, 2, BERT_PRETRAIN_BATCH),
                          device="cuda")
    params = list(model.parameters())

    def pretrain_step():
        loss = model(pids, positions, mlm_labels, nsp)
        return loss, torch.autograd.grad(loss, params)

    torch.cuda.reset_peak_memory_stats()
    loss, grads = pretrain_step()
    loss = float(loss.detach())
    if not (math.isfinite(loss)
            and all(bool(torch.isfinite(g).all()) for g in grads)):
        raise AssertionError(f"bert pretraining: loss {loss} or "
                             f"gradients not finite")
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pretrain_step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
    out["pretraining"] = dict(
        batch=[BERT_PRETRAIN_BATCH, BERT_PRETRAIN_SEQ],
        masked_per_row=BERT_MASKED, loss=loss, fwd_bwd_ms=ms,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del model, grads, params
    _free()

    ecfg = ernie_3_base()
    ernie = amp.decorate(ErnieForSequenceClassification(
        ecfg, device="cuda", generator=gen(2)).eval(), level="O2",
        dtype="bfloat16")
    eids, _ = padded_ids(BERT_PRETRAIN_BATCH, BERT_PRETRAIN_SEQ,
                         BERT_PRETRAIN_SEQ // 2, ecfg.vocab_size)
    task = torch.ones_like(eids)
    with torch.no_grad():
        logits = ernie(eids, task_type_ids=task)
        torch.cuda.synchronize()
        ernie_ms = cuda_ms(lambda: ernie(eids, task_type_ids=task), iters=3,
                           warmup=1)
    if tuple(logits.shape) != (BERT_PRETRAIN_BATCH, 2) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"ernie: logits {tuple(logits.shape)} not "
                             f"finite or not [B, 2]")
    out["ernie_3_base"] = dict(batch=[BERT_PRETRAIN_BATCH, BERT_PRETRAIN_SEQ],
                               params=sum(p.numel() for p in ernie.parameters()),
                               forward_ms=ernie_ms)
    del ernie, logits
    _free()

    # float32 against float64, the same weights and inputs, dropout off
    m32 = BertModel(bert_base(hidden_dropout_prob=0.0,
                              attention_dropout_prob=0.0), device="cuda",
                    generator=gen(3)).eval()
    m64 = copy.deepcopy(m32).double()
    fids, _ = padded_ids(8, BERT_SEQ, BERT_MIN_LEN, cfg.vocab_size)
    with torch.no_grad():
        seq32, pooled32 = m32(fids)
        seq64, pooled64 = m64(fids)
    errs = {}
    for key, a, b in (("sequence", seq32, seq64), ("pooled", pooled32,
                                                    pooled64)):
        rel = ((a.double() - b).abs().max() / b.abs().max()).item()
        if not rel <= BERT_F64_RTOL:
            raise AssertionError(f"bert float32 {key} output {rel} of the "
                                 f"largest float64 value from float64, "
                                 f"limit {BERT_F64_RTOL}")
        errs[key] = rel
    out["float32_vs_float64"] = dict(rel_max_err=errs, limit=BERT_F64_RTOL,
                                     batch=[8, BERT_SEQ])
    del m32, m64
    emit("bert_base", **out)
    _free()
    return out


# --------------------------------------------------------------------------
# the convolutional path: ResNet-50 at bench.py's bench_resnet50
# --------------------------------------------------------------------------

# bench.py bench_resnet50 (bench.py:326-354): ResNet-50, 1000 classes,
# batch 64 at 224 x 224, labels drawn in [0, 10), Momentum(0.1, 0.9), bf16
# O2, float32 images from default_rng(0), 20 warm-up and 20 timed steps.
# The reference computes this configuration in float32 (the convs cast
# their bf16 weights to the images' dtype, and float32 activations meet
# the bf16 BatchNorm and classifier weights with JAX's promotion); part (c)
# feeds bf16 images, its bf16 compute path.
RN_CLASSES, RN_LABELS = 1000, 10
RN_BATCH, RN_SIZE = 64, 224
RN_LR, RN_MOMENTUM = 0.1, 0.9
RN_WARMUP, RN_TIMED = 20, 20
RN_PATH = "training (ResNet-50 bf16 O2 Momentum step, bench_resnet50)"
# part (a): one float32 step of ResNet-50 at batch 4 on the card, held to
# the same step on the CPU in float64 from the same weights and batch, and
# read by these gates (each the largest |card - cpu| over the largest
# |cpu| unless named otherwise). The CPU's own float32 step is read against
# the same float64 one: what float32 itself costs (the update through 53
# batch-normalised layers moves a few percent between two float32 runs:
# 2.4 % between an H100's step and the CPU's). The readings of a sound run
# and of the planted faults are in PERF.md §6.
RN_YARD_BATCH = 4
RN_LOSS_RTOL = 1e-4     # |card - cpu| / |cpu| of the loss
RN_LOGITS_RTOL = 1e-3   # the step's training-mode logits
RN_STATS_RTOL = 1e-4    # every running statistic, worst buffer
# ||card update - cpu update|| / ||cpu update|| over the model: at most
# this many times the CPU float32 step's own, plus a floor
RN_UPDATE_FACTOR, RN_UPDATE_FLOOR = 3.0, 1e-3
# planted in the card's run only; each must trip its gate
RN_FAULTS = {"torch_momentum": "stats_rel_err",
             "biased_variance": "stats_rel_err",
             "no_rollback": "rollback_max_change"}


@contextlib.contextmanager
def _rn_fault(fault):
    """Plant ``fault`` in the port while the block runs: torch's
    batch-norm momentum convention (``momentum`` the new value's share), a
    biased running variance, or a skipped step that keeps the statistics
    its forward moved."""
    from paddle_tpu_torch.framework import jit
    from paddle_tpu_torch.nn import functional as PF

    real_bn = PF.batch_norm
    real_rollback = jit.TrainStep.__dict__["_rollback_buffers"]

    def planted(x, running_mean, running_var, weight=None, bias=None,
                training=False, momentum=0.9, epsilon=1e-5,
                data_format="NCHW", use_global_stats=None, name=None):
        out, nm, nv = real_bn(x, running_mean, running_var, weight, bias,
                              training, momentum, epsilon, data_format,
                              use_global_stats)
        if not training or use_global_stats:
            return out, nm, nv
        m = momentum
        batch_mean = (nm - m * running_mean) / (1 - m)
        batch_var = (nv - m * running_var) / (1 - m)   # unbiased
        if fault == "torch_momentum":
            return (out, (1 - m) * running_mean + m * batch_mean,
                    (1 - m) * running_var + m * batch_var)
        ch = 1 if data_format.startswith("NC") else x.ndim - 1
        n = x.numel() // x.shape[ch]
        return out, nm, m * running_var + (1 - m) * batch_var * (n - 1) / n

    if fault in ("torch_momentum", "biased_variance"):
        PF.batch_norm = planted
    elif fault == "no_rollback":
        jit.TrainStep._rollback_buffers = staticmethod(lambda *a: None)
    elif fault is not None:
        raise ValueError(f"no such fault: {fault}")
    try:
        yield
    finally:
        PF.batch_norm = real_bn
        jit.TrainStep._rollback_buffers = real_rollback


def _rn_loss(out, batch):
    from paddle_tpu_torch.nn import functional as F

    return F.cross_entropy(out, batch[1])


def _rn_yard_run(model, x, y) -> dict:
    """One Momentum(0.1, 0.9) TrainStep of ``model`` on ``(x, y)`` and
    then a poisoned one: the step's training-mode logits (an EvalStep
    before it: batch statistics, buffers kept), its loss, the parameters
    and statistics after it, whether the poisoned step was skipped, and
    how far it moved any statistic."""
    from paddle_tpu_torch.framework.jit import EvalStep, TrainStep
    from paddle_tpu_torch.optimizer import Momentum

    step = TrainStep(model, Momentum(RN_LR, RN_MOMENTUM), loss_fn=_rn_loss)
    logits = EvalStep(model)(x)
    loss = float(step((x, y)))
    params = {k: p.detach().cpu().clone() for k, p in
              model.named_parameters()}
    stats = {k: b.detach().cpu().clone() for k, b in model.named_buffers()}
    step.inject_anomaly()
    _, ok, _ = step.watchdog_call((x, y))
    moved = max(float((b.detach().cpu() - stats[k]).abs().max())
                for k, b in model.named_buffers())
    return dict(logits=logits.detach().cpu(), loss=loss, params=params,
                stats=stats, skipped=not bool(ok), moved=moved)


def _rn_readings(run: dict, ref: dict, initial: dict,
                 mean_in_std: bool = False) -> dict:
    """Part (a)'s readings of a run against the float64 one. With
    ``mean_in_std`` a running mean's error is read in units of its
    feature's running standard deviation rather than of its own largest
    value: a BatchNorm fed by a linear conv of another BatchNorm's
    zero-mean output (MobileNet's projections) has batch means of rounding
    size, which no relative reading can hold."""
    def rel(a, b):
        return float((a.double() - b.double()).abs().max()
                     / b.double().abs().max())

    def stat_err(k, v):
        if mean_in_std and k.endswith("_mean"):
            std = ref["stats"][k[:-len("_mean")] + "_variance"].double()
            return float(((v.double() - ref["stats"][k].double()).abs()
                          / std.sqrt()).max())
        return rel(v, ref["stats"][k])

    stats = {k: stat_err(k, v) for k, v in run["stats"].items()}
    worst_stat = max(stats, key=stats.get)
    num = den = 0.0
    leaf = {}
    for k, p in run["params"].items():
        d_ref = ref["params"][k].double() - initial[k].double()
        diff = (p.double() - initial[k].double()) - d_ref
        num += float((diff ** 2).sum())
        den += float((d_ref ** 2).sum())
        leaf[k] = float(diff.norm() / max(float(d_ref.norm()), 1e-30))
    worst_leaf = max(leaf, key=leaf.get)
    return dict(loss_rel_err=abs(run["loss"] - ref["loss"]) / abs(ref["loss"]),
                logits_rel_err=rel(run["logits"], ref["logits"]),
                stats_rel_err=stats[worst_stat], worst_stat=worst_stat,
                update_err=(num / den) ** 0.5,
                update_err_worst_leaf=leaf[worst_leaf], worst_leaf=worst_leaf,
                skipped=run["skipped"], rollback_max_change=run["moved"],
                loss=run["loss"])


def _rn_gates_pass(r: dict, update_limit: float) -> bool:
    return (r["loss_rel_err"] <= RN_LOSS_RTOL
            and r["logits_rel_err"] <= RN_LOGITS_RTOL
            and r["stats_rel_err"] <= RN_STATS_RTOL
            and r["update_err"] <= update_limit
            and r["skipped"] and r["rollback_max_change"] == 0.0)


def _rn_gate_trips(fault: str, r: dict) -> bool:
    if RN_FAULTS[fault] == "stats_rel_err":
        return r["stats_rel_err"] > RN_STATS_RTOL
    return r["rollback_max_change"] > 0.0


def _rn_yardstick(seed: int, device: str, ctor,
                  phase: str = "resnet50_training",
                  mean_in_std: bool = False) -> dict:
    """Part (a): the float32 step on ``device`` against the CPU's float64
    one, sound and with each of RN_FAULTS planted in the ``device`` run;
    the CPU's float32 step read against it too (float32's own cost).
    ``phase`` names the phase that reports a failure; ``mean_in_std`` as
    :func:`_rn_readings`."""
    import copy

    import numpy as np
    import torch

    gen = torch.Generator().manual_seed(seed + 30)
    base = ctor(num_classes=RN_CLASSES, device="cpu", generator=gen).train()
    initial = {k: p.detach().clone() for k, p in base.named_parameters()}
    rng = np.random.default_rng(seed + 31)
    x = rng.standard_normal((RN_YARD_BATCH, 3, RN_SIZE, RN_SIZE)).astype(
        np.float32)
    y = rng.integers(0, RN_LABELS, RN_YARD_BATCH)
    t0 = time.perf_counter()
    ref = _rn_yard_run(copy.deepcopy(base).double(), x.astype(np.float64),
                       y)
    cpu64_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    floor = _rn_readings(_rn_yard_run(copy.deepcopy(base), x, y), ref,
                         initial, mean_in_std)
    cpu32_s = time.perf_counter() - t0
    update_limit = RN_UPDATE_FACTOR * floor["update_err"] + RN_UPDATE_FLOOR
    runs = {}
    for fault in (None,) + tuple(RN_FAULTS):
        with _rn_fault(fault):
            run = _rn_yard_run(copy.deepcopy(base).to(device), x, y)
        runs[fault or "sound"] = _rn_readings(run, ref, initial,
                                              mean_in_std)
    out = dict(batch=[RN_YARD_BATCH, 3, RN_SIZE, RN_SIZE],
               cpu_float64_step_s=cpu64_s, cpu_float32_step_s=cpu32_s,
               cpu_loss_float64=ref["loss"],
               gates=dict(loss=RN_LOSS_RTOL, logits=RN_LOGITS_RTOL,
                          stats=RN_STATS_RTOL, update=update_limit,
                          rollback=0.0),
               cpu_float32=floor, readings=runs)
    failed = [] if _rn_gates_pass(runs["sound"], update_limit) else ["sound"]
    failed += [f for f in RN_FAULTS if not _rn_gate_trips(f, runs[f])]
    if failed:
        emit(phase, yardstick=out)
        raise AssertionError(f"{phase} (a): {failed} on the wrong side of "
                             f"their gates (the sound run must pass every "
                             f"gate, each planted fault trip its own)")
    return out


def _rn_timed_steps(step, batch, device: str, warmup: int = RN_WARMUP,
                    timed: int = RN_TIMED) -> dict:
    """``warmup`` + ``timed`` steps of ``step`` on ``batch``: each step's
    ms between CUDA events (host clock on the CPU), its loss, and the peak
    memory over the timed steps."""
    import numpy as np
    import torch

    cuda = device != "cpu"
    losses, ms = [], []
    for i in range(warmup + timed):
        if i == warmup and cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss = step(batch)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            loss = step(batch)
            ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    timed = ms[warmup:]
    return dict(losses=losses, step_ms=ms,
                step_ms_median=float(np.median(timed)),
                step_ms_min=min(timed), step_ms_max=max(timed),
                step_ms_p25=float(np.percentile(timed, 25)),
                step_ms_p75=float(np.percentile(timed, 75)),
                peak_mem_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                              if cuda else None))


def _rn_bench_step(seed: int, device: str = "cuda", ctor=None,
                   batch: int = RN_BATCH, size: int = RN_SIZE):
    """bench_resnet50's model, optimizer and step on ``device``: ResNet-50
    (1000 classes) under bf16 O2 with Momentum(0.1, 0.9), and its batch
    (float32 images and labels in [0, 10) from default_rng(0), numpy as
    the bench feeds them). Returns ``(step, (x, y))``."""
    import numpy as np
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.framework import random as framework_random
    from paddle_tpu_torch.framework.jit import TrainStep
    from paddle_tpu_torch.models.resnet import resnet50
    from paddle_tpu_torch.optimizer import Momentum

    framework_random.seed(seed)
    model = (ctor or resnet50)(
        num_classes=RN_CLASSES, device=device,
        generator=torch.Generator(device).manual_seed(seed)).train()
    model, opt = amp.decorate(model, Momentum(RN_LR, RN_MOMENTUM),
                              level="O2", dtype="bfloat16")
    step = TrainStep(model, opt, loss_fn=_rn_loss)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((batch, 3, size, size)).astype(np.float32)
    y = rng.integers(0, RN_LABELS, batch)
    return step, (x, y)


def phase_resnet50_training(seed: int, device: str = "cuda", ctor=None,
                            batch: int = RN_BATCH,
                            size: int = RN_SIZE) -> dict:
    """ResNet-50 through the port's TrainStep (no flash kernel on this
    path: convolutions, pooling and batch norm are torch ops, cuDNN on the
    card). (a) a float32 step at batch 4 on the card against the same step
    on the CPU (loss, logits, running statistics, update), with planted
    faults that each gate must catch; (b) bench_resnet50 at full width and
    depth (batch 64 at 224 x 224, bf16 O2 on float32 images: float32
    compute, as the reference): 20 warm-up and 20 timed steps, ms, images/s,
    peak, MFU from the ported flops(); (c) the same model fed bf16 images;
    (d) a poisoned step and an EvalStep leave every parameter, velocity
    and statistic bit-equal. ``device="cpu"``, ``ctor`` (a smaller
    ResNet), ``batch`` and ``size`` give a dry run on the CPU."""
    import torch

    from paddle_tpu_torch.framework.jit import EvalStep
    from paddle_tpu_torch.hapi.dynamic_flops import count_flops
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models.resnet import resnet50

    ctor = ctor or resnet50
    cuda = device != "cpu"
    leftover = _check_freed("resnet50_training") if cuda else None
    out = dict(path=RN_PATH, leftover_gib_at_start=leftover,
               card=nvidia_smi_line())
    t0 = time.perf_counter()
    out["yardstick"] = _rn_yardstick(seed, device, ctor)
    out["yardstick"]["seconds"] = time.perf_counter() - t0
    if cuda:
        _free()

    # (b) the bench's configuration
    t0 = time.perf_counter()
    step, (x, y) = _rn_bench_step(seed, device, ctor, batch, size)
    model = step.model
    build_s = time.perf_counter() - t0
    flops = count_flops(model, (1, 3, size, size))
    fwd_flops = float(sum(flops.values()))
    stats_before = {k: b.clone() for k, b in model.named_buffers()}
    fa.reset_launch_counts()
    bench = _rn_timed_steps(step, (x, y), device)
    flash = sum(_counts(fa))
    with torch.no_grad():
        logits = EvalStep(model)(x[:2])
    moved = any(not torch.equal(b, stats_before[k])
                for k, b in model.named_buffers())
    finite = all(bool(torch.isfinite(b).all()) for b in model.buffers())
    if not all(math.isfinite(v) for v in bench["losses"]) or not moved \
            or not finite or flash or logits.dtype != torch.float32:
        raise AssertionError(
            f"resnet50 (b): losses {bench['losses']}, statistics moved "
            f"{moved} and finite {finite}, {flash} flash launches (0 "
            f"expected), logits {logits.dtype} (float32 expected)")
    images_per_s = batch / (bench["step_ms_median"] / 1e3)
    out["bench"] = dict(
        **bench, batch=[batch, 3, size, size], classes=RN_CLASSES,
        images="float32", compute_dtype=str(logits.dtype).split(".")[-1],
        images_per_s=images_per_s, flops_forward_per_image=flops,
        mfu=images_per_s * 3 * fwd_flops / PEAK_BF16_TC_FLOPS,
        flash_launches=flash, model_build_s=build_s,
        params=sum(p.numel() for p in model.parameters()))

    # (c) the same model fed bf16 images: the reference's bf16 path
    xb = torch.as_tensor(x, device=device).to(torch.bfloat16)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    bf16 = _rn_timed_steps(step, (xb, y), device)
    with torch.no_grad():
        logits_b = EvalStep(model)(xb[:2])
    if not all(math.isfinite(v) for v in bf16["losses"]):
        raise AssertionError(f"resnet50 (c): losses {bf16['losses']}")
    images_per_s = batch / (bf16["step_ms_median"] / 1e3)
    out["bf16_images"] = dict(
        **bf16, compute_dtype=str(logits_b.dtype).split(".")[-1],
        images_per_s=images_per_s,
        mfu=images_per_s * 3 * fwd_flops / PEAK_BF16_TC_FLOPS)

    # (d) a poisoned step and an EvalStep on the bench's step
    def state():
        return ([p.detach().clone() for p in model.parameters()]
                + [t.clone() for slot in ("velocity", "master_weights")
                   for t in step.opt_state[slot].values()]
                + [b.clone() for b in model.buffers()])

    saved = state()
    step.inject_anomaly()
    _, ok, _ = step.watchdog_call((x, y))
    skipped_equal = all(torch.equal(a, b) for a, b in zip(state(), saved))
    with torch.no_grad():
        EvalStep(model)(x)
    eval_equal = all(torch.equal(a, b) for a, b in zip(state(), saved))
    if bool(ok) or not skipped_equal or not eval_equal:
        raise AssertionError(f"resnet50 (d): poisoned step ok={bool(ok)}, "
                             f"state bit-equal after it {skipped_equal}, "
                             f"after an EvalStep {eval_equal}")
    out["guards"] = dict(poisoned_step_skipped=not bool(ok),
                         state_bit_equal_after_skip=skipped_equal,
                         state_bit_equal_after_eval_step=eval_equal,
                         tensors=len(saved))
    del step, model, x, xb
    emit("resnet50_training", **out)
    return out


# --------------------------------------------------------------------------
# the vision zoo: every constructor at full width, MobileNetV3-Large and
# ShuffleNetV2 trained from an ImageFolder, beam search (no flash kernel)
# --------------------------------------------------------------------------

ZOO_PATH = ("training (MobileNetV3-Large and ShuffleNetV2 x1.0 bf16 O2 "
            "Momentum through Model.fit from an ImageFolder)")
# (a): every constructor of vision.models but the re-exported ResNet
# family (models/resnet.py's, which resnet50_training runs), its native
# input side and channels, and whether it is its family's one run on the
# CPU too
ZOO_CTORS = (
    ("LeNet", 28, 1, True), ("vgg11", 224, 3, True), ("vgg13", 224, 3, False),
    ("vgg16", 224, 3, False), ("vgg19", 224, 3, False),
    ("vgg11_bn", 224, 3, False), ("vgg13_bn", 224, 3, False),
    ("vgg16_bn", 224, 3, False), ("vgg19_bn", 224, 3, False),
    ("mobilenet_v1", 224, 3, True), ("mobilenet_v2", 224, 3, True),
    ("mobilenet_v3_small", 224, 3, True), ("mobilenet_v3_large", 224, 3, True),
    ("alexnet", 224, 3, True), ("squeezenet1_0", 224, 3, True),
    ("squeezenet1_1", 224, 3, False), ("shufflenet_v2_x1_0", 224, 3, True),
    ("shufflenet_v2_x0_25", 224, 3, False),
    ("shufflenet_v2_x0_33", 224, 3, False),
    ("shufflenet_v2_x0_5", 224, 3, False),
    ("shufflenet_v2_x1_5", 224, 3, False),
    ("shufflenet_v2_x2_0", 224, 3, False),
    ("shufflenet_v2_swish", 224, 3, False), ("densenet121", 224, 3, True),
    ("densenet161", 224, 3, False), ("densenet169", 224, 3, False),
    ("densenet201", 224, 3, False), ("densenet264", 224, 3, False),
    ("googlenet", 224, 3, True), ("inception_v3", 299, 3, True))
ZOO_FWD_RTOL = 1e-3     # |card - cpu| over the largest |cpu logit|, float32
# (b): bench_resnet50's recipe (RN_*) on an ImageFolder of JPEG files
ZOO_TRAINED = ("mobilenet_v3_large", "shufflenet_v2_x1_0")
ZOO_WARMUP, ZOO_TIMED = 3, 10
ZOO_IMAGE_SIDE = 256    # the JPEG files' side, cropped to RN_SIZE
ZOO_CLASS_DIRS = 16     # class subdirectories written (labels < 1000)
# the card's host makes about 110 such images a second whatever the
# worker count (tools/torch_image_pipeline.py there: 8.2 ms an image in one
# process; 13 batches of 64 in 7.31 s with four workers, 7.68 s with
# seven), so four leave the main process more of the host
ZOO_WORKERS, ZOO_PREFETCH = 4, 2
ZOO_MEAN, ZOO_STD = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
# (c): beam search over an LSTM cell
BEAM_VOCAB, BEAM_HIDDEN, BEAM_WIDTH, BEAM_BATCH, BEAM_STEPS = \
    32000, 512, 4, 32, 64
BEAM_LP_RTOL = 1e-5     # final log-probabilities, card against the CPU


def _zoo_ctor(name):
    """A constructor of vision.models by name; ``<vgg>_bn`` is
    ``<vgg>(batch_norm=True)``."""
    import functools

    from paddle_tpu_torch.vision import models

    if name.endswith("_bn"):
        return functools.partial(getattr(models, name[:-3]), batch_norm=True)
    return getattr(models, name)


def _zoo_forwards(seed: int, device: str = "cuda",
                  ctors=ZOO_CTORS) -> dict:
    """(a): each constructor built on ``device`` from a seeded generator
    and run once on a batch-2 float32 image in eval mode: logits finite
    and [2, classes]; the first of each family also built on the CPU from
    the same seed, run there, moved to ``device`` and held to the CPU's
    logits. Each model is freed (its last reference dropped, so the
    allocator reuses its memory) before the next is built."""
    import numpy as np
    import torch

    out = {}
    for i, (name, side, chans, held) in enumerate(ctors):
        ctor = _zoo_ctor(name)
        classes = 10 if name == "LeNet" else RN_CLASSES
        x = np.random.default_rng(seed + 40 + i).standard_normal(
            (2, chans, side, side)).astype(np.float32)
        t0 = time.perf_counter()
        row = {}
        if held:
            model = ctor(device="cpu", generator=torch.Generator().manual_seed(
                seed + i)).eval()
            with torch.no_grad():
                ref = model(torch.from_numpy(x))
            row["cpu_s"] = time.perf_counter() - t0
            model.to(device)
        else:
            model = ctor(device=device, generator=torch.Generator(
                device).manual_seed(seed + i)).eval()
        t1 = time.perf_counter()
        with torch.no_grad():
            logits = model(torch.from_numpy(x).to(device))
        _sync(device)
        row["card_s"] = time.perf_counter() - t1
        row["params"] = sum(p.numel() for p in model.parameters())
        if tuple(logits.shape) != (2, classes) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"vision_zoo (a) {name}: logits "
                                 f"{tuple(logits.shape)}, finite "
                                 f"{bool(torch.isfinite(logits).all())}")
        if held:
            scale = float(ref.abs().max())
            err = float((logits.cpu() - ref).abs().max()) / scale
            row.update(max_abs_logit=scale, rel_err=err)
            if not err <= ZOO_FWD_RTOL:
                raise AssertionError(f"vision_zoo (a) {name}: card logits "
                                     f"{err} of the largest CPU logit off "
                                     f"(limit {ZOO_FWD_RTOL})")
        out[name] = row
        del model, logits
    _free()
    return out


class _LabelledFolder:
    """``vision.datasets.ImageFolder`` (unlabelled, as the reference's)
    read with each image's class directory as its label: ``(image,
    int64 label)``. Decoding and the transforms run in the loader's
    worker processes, on the host only."""

    def __init__(self, root, transform):
        from paddle_tpu_torch.vision.datasets import ImageFolder

        self.folder = ImageFolder(root, loader=_pil_rgb, transform=transform)

    def __len__(self):
        return len(self.folder)

    def __getitem__(self, i):
        import numpy as np

        (img,) = self.folder[i]
        label = os.path.basename(os.path.dirname(self.folder.samples[i]))
        return img, np.int64(int(label))


def _pil_rgb(path):
    import numpy as np
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _write_jpegs(root: str, n: int, seed: int) -> float:
    """``n`` JPEG files of ZOO_IMAGE_SIDE squares (smooth seeded colour
    fields, quality 90) in ZOO_CLASS_DIRS class directories; returns the
    seconds taken (encoded on threads)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, RN_CLASSES, ZOO_CLASS_DIRS)
    for c in labels:
        os.makedirs(os.path.join(root, f"{c:04d}"), exist_ok=True)
    coarse = rng.integers(0, 256, (n, 16, 16, 3)).astype(np.uint8)

    def write(k):
        img = Image.fromarray(coarse[k]).resize(
            (ZOO_IMAGE_SIDE, ZOO_IMAGE_SIDE), Image.BILINEAR)
        img.save(os.path.join(root, f"{labels[k % ZOO_CLASS_DIRS]:04d}",
                              f"{k:05d}.jpg"), quality=90)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, range(n)))
    return time.perf_counter() - t0


@contextlib.contextmanager
def _captured_prefetchers():
    """Every ``prefetch_to_device`` iterator made while the block runs
    (Model.fit makes one an epoch), so their ``stats()`` can be read
    after the fit has closed them."""
    from paddle_tpu_torch.io import device_prefetch

    real = device_prefetch.prefetch_to_device
    made = []

    def recording(*a, **k):
        it = real(*a, **k)
        made.append(it)
        return it

    device_prefetch.prefetch_to_device = recording
    try:
        yield made
    finally:
        device_prefetch.prefetch_to_device = real


def _no_dropout(ctor):
    """``ctor`` with its Dropout layers at p = 0: the card's generator and
    the CPU's draw different masks, and (b)'s yardstick holds one step's
    arithmetic."""
    from paddle_tpu_torch.nn.layers.common import Dropout

    def build(**kw):
        model = ctor(**kw)
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
        return model

    return build


def _zoo_fit(name: str, root: str, seed: int, device: str = "cuda",
             batch: int = RN_BATCH, size: int = RN_SIZE) -> dict:
    """(b) for one model: bench_resnet50's recipe through Model.fit over
    the ImageFolder, ZOO_WARMUP + ZOO_TIMED steps (host clock per batch,
    the loss read back), then one step on a device batch traced for its
    launches and the card's idle share."""
    import numpy as np
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.framework import random as framework_random
    from paddle_tpu_torch.framework.jit import EvalStep
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision import transforms as T

    framework_random.seed(seed)
    t0 = time.perf_counter()
    cuda = device != "cpu"
    net = _zoo_ctor(name)(num_classes=RN_CLASSES, device=device,
                          generator=torch.Generator(device).manual_seed(seed))
    net, opt = amp.decorate(net.train(), Momentum(RN_LR, RN_MOMENTUM),
                            level="O2", dtype="bfloat16")
    model = Model(net)
    model.prepare(opt, loss=CrossEntropyLoss())
    build_s = time.perf_counter() - t0
    data = _LabelledFolder(root, T.Compose([
        T.RandomResizedCrop(size), T.RandomHorizontalFlip(),
        T.ToTensor(), T.Normalize(ZOO_MEAN, ZOO_STD)]))
    loader = DataLoader(data, batch_size=batch, shuffle=True,
                        drop_last=True, num_workers=ZOO_WORKERS, seed=seed)
    clock = _fit_clock(None)
    np.random.seed(seed)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with _captured_prefetchers() as made:
        model.fit(loader, epochs=1, prefetch_depth=ZOO_PREFETCH, verbose=0,
                  callbacks=[clock])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else None
    ms = clock.step_ms()
    timed = ms[ZOO_WARMUP:]
    if len(ms) != ZOO_WARMUP + ZOO_TIMED or \
            not all(math.isfinite(v) for v in clock.losses):
        raise AssertionError(f"vision_zoo (b) {name}: {len(ms)} steps, "
                             f"losses {clock.losses}")
    stats = made[0].stats()
    # one step on a batch already on the card: its launches, kernel time
    # and idle share, beside the same step untraced
    x = torch.from_numpy(np.stack([data[k][0] for k in range(batch)])
                         ).to(device)
    y = torch.from_numpy(np.stack([data[k][1] for k in range(batch)])
                         ).to(device)
    bare = []
    for _ in range(3):
        _sync(device)
        t1 = time.perf_counter()
        model.train_batch([x], [y])
        _sync(device)
        bare.append((time.perf_counter() - t1) * 1e3)
    prof = _step_profile(lambda: model.train_batch([x], [y]), device)
    bare_ms = float(np.median(bare))
    with torch.no_grad():
        logits = EvalStep(net)(x[:2])
    out = dict(
        losses=clock.losses, step_ms=ms,
        step_ms_median=float(np.median(timed)), step_ms_min=min(timed),
        step_ms_max=max(timed),
        images_per_s=batch / (float(np.median(timed)) / 1e3),
        images_per_s_over_timed=batch * len(timed) / (sum(timed) / 1e3),
        peak_mem_gib=peak, batch=[batch, 3, size, size],
        compute_dtype=str(logits.dtype).split(".")[-1],
        model_build_s=build_s,
        params=sum(p.numel() for p in net.parameters()),
        input_stall_s=stats["consumer_stall_s"],
        input_stall_per_step_ms=stats["consumer_stall_s"]
        / max(stats["batches"], 1) * 1e3,
        prefetch_batches=stats["batches"],
        producer_busy_s=stats["producer_busy_s"],
        bare_step_ms=bare_ms, launches_per_step=prof["launches"],
        kernel_ms_per_step=prof["kernel_ms"],
        idle_share=(None if prof["kernel_ms"] is None
                    else 1.0 - prof["kernel_ms"] / bare_ms),
        card=nvidia_smi_line() if cuda else None)
    del model, net, opt, x, y
    _free()
    return out


def _beam_modules(seed: int, device: str):
    """The decoder's LSTM cell, embedding and output layer, seeded on the
    CPU and moved to ``device`` (the card's and the CPU's runs hold the
    same weights)."""
    import torch

    from paddle_tpu_torch import nn

    g = torch.Generator().manual_seed(seed)
    cell = nn.LSTMCell(BEAM_HIDDEN, BEAM_HIDDEN, device="cpu", generator=g)
    emb = torch.randn(BEAM_VOCAB, BEAM_HIDDEN, generator=g) * 0.1
    head = nn.Linear(BEAM_HIDDEN, BEAM_VOCAB, device="cpu", generator=g)
    h0 = torch.randn(BEAM_BATCH, BEAM_HIDDEN, generator=g) * 0.5
    return cell.to(device), emb.to(device), head.to(device), h0.to(device)


def _beam_decode(seed: int, device: str) -> tuple:
    """(c)'s decode on ``device``: ``(sequences, log-probs, seconds)``."""
    import torch

    from paddle_tpu_torch import nn

    cell, emb, head, h0 = _beam_modules(seed, device)
    dec = nn.BeamSearchDecoder(cell, start_token=0, end_token=1,
                               beam_size=BEAM_WIDTH,
                               embedding_fn=lambda ids: emb[ids],
                               output_fn=head)
    _sync(device)
    t0 = time.perf_counter()
    with torch.no_grad():
        seq, lp = nn.dynamic_decode(dec, (h0, torch.zeros_like(h0)),
                                    max_step_num=BEAM_STEPS)
    _sync(device)
    return seq.cpu(), lp.cpu(), time.perf_counter() - t0


def _zoo_beam(seed: int, device: str = "cuda") -> dict:
    """(c): the card's beam search against the CPU's, same weights."""
    import torch

    _beam_decode(seed, device)   # builds cuBLAS's plans
    seq, lp, card_s = _beam_decode(seed, device)
    seq_c, lp_c, cpu_s = _beam_decode(seed, "cpu")
    equal = bool(torch.equal(seq, seq_c))
    err = float((lp - lp_c).abs().max() / lp_c.abs().max())
    if not equal or not err <= BEAM_LP_RTOL:
        raise AssertionError(f"vision_zoo (c): sequences equal {equal}, "
                             f"log-probs {err} relative (limit "
                             f"{BEAM_LP_RTOL})")
    _free()
    return dict(sequences=list(seq.shape), steps=seq.shape[-1],
                card_ms=card_s * 1e3, card_ms_per_step=card_s * 1e3
                / seq.shape[-1], cpu_s=cpu_s, lp_rel_err=err,
                sequences_equal=equal)


def phase_vision_zoo(seed: int, device: str = "cuda", ctors=ZOO_CTORS,
                     batch: int = RN_BATCH, size: int = RN_SIZE) -> dict:
    """The vision zoo (no flash kernel on its paths). (a) every
    constructor of vision.models at full width on the card, one family
    member each also held to the CPU; (b) MobileNetV3-Large and
    ShuffleNetV2 x1.0 trained through Model.fit on bench_resnet50's recipe
    from an ImageFolder of JPEG files, each also held with a batch-4
    float32 step against the CPU (resnet50_training's yardstick); (c)
    beam search over an LSTM cell, the card against the CPU.
    ``device="cpu"``, ``ctors`` (fewer constructors), ``batch`` and
    ``size`` give a dry run on the CPU."""
    import tempfile

    import torch

    from paddle_tpu_torch.kernels import flash_attention as fa

    cuda = device != "cpu"
    leftover = _check_freed("vision_zoo") if cuda else None
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    out = dict(path=ZOO_PATH, leftover_gib_at_start=leftover,
               card=nvidia_smi_line() if cuda else None)
    out["forwards"] = _zoo_forwards(seed, device, ctors)
    out["forwards_s"] = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="vision_zoo_")
    try:
        n = batch * (ZOO_WARMUP + ZOO_TIMED)
        out["jpeg_write_s"] = _write_jpegs(tmp, n, seed)
        out["images"] = n
        for i, name in enumerate(ZOO_TRAINED):
            t1 = time.perf_counter()
            run = _zoo_fit(name, tmp, seed + i, device, batch, size)
            ctor = _zoo_ctor(name)
            run["yardstick"] = _rn_yardstick(
                seed + i, device, _no_dropout(ctor), phase="vision_zoo",
                mean_in_std=True)
            _free()
            run["seconds"] = time.perf_counter() - t1
            out[name] = run
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t1 = time.perf_counter()
    out["beam_search"] = _zoo_beam(seed, device)
    out["beam_search"]["seconds"] = time.perf_counter() - t1
    out["flash_launches"] = sum(_counts(fa))
    if out["flash_launches"]:
        raise AssertionError(f"vision_zoo: {out['flash_launches']} flash "
                             f"launches (0 expected)")
    out["seconds"] = time.perf_counter() - t0
    out["leftover_gib_at_end"] = (torch.cuda.memory_allocated() / 2 ** 30
                                  if cuda else None)
    emit("vision_zoo", **out)
    return out


# --------------------------------------------------------------------------
# the detection and OCR path: PP-YOLOE-s, YOLOv3 and CRNN (no flash kernel)
# --------------------------------------------------------------------------

DET_PATH = ("training and serving (PP-YOLOE-s at 640, YOLOv3 at 608, "
            "float32)")
OCR_PATH = "training and decode (CRNN with CTC at 32 x 320, float32 Adam)"
DET_CLASSES = 80
DET_GT, DET_GT_REAL = 32, (1, 20)   # gt rows an image; real boxes in it
# PaddleDetection's per-card batches and image sizes: PP-YOLOE 8 at 640,
# YOLOv3 8 at 608; Momentum(0.9) with L2 decay 5e-4 for both
PPYOLOE_BATCH, PPYOLOE_SIZE, PPYOLOE_LR = 8, 640, 0.01
YOLO_BATCH, YOLO_SIZE, YOLO_LR, YOLO_WIDTH = 8, 608, 1e-3, 32
DET_MOMENTUM, DET_DECAY = 0.9, 5e-4
DET_WARMUP, DET_TIMED = 5, 10
SERVE_REPEATS = 3
# PP-OCR's recognition crop and per-card batch; 6623 characters of its
# Chinese dictionary, space and blank; labels of 1-25 characters
OCR_CLASSES, OCR_BATCH, OCR_H, OCR_W = 6625, 128, 32, 320
OCR_MAX_LABEL, OCR_LR = 25, 1e-3
# part (a): one float32 step on the card against the CPU's float64 step;
# a reading passes under YARD_FACTOR times the CPU float32 step's own
# reading (float32's cost, against the same float64 step) or its floor
YARD_BATCH, YARD_SIZE = 2, 320
OCR_YARD_BATCH, OCR_YARD_W = 4, 64
YARD_FACTOR = 10.0
YARD_FLOORS = dict(loss=1e-5, logits=1e-4, stats=1e-4, update=1e-3,
                   target_loss=1e-5)
# fused PP-YOLOE against unfused, eval mode: of the largest |output|
FUSE_RTOL = 1e-4
# planted in the card's run only; each must trip its gate
DET_FAULTS = {"ppyoloe": {"argmax_last": "assignment",
                          "no_detach": "update"},
              "yolov3": {"padded_rows_write": "target_loss",
                         "first_row_wins": "target_loss"}}
OCR_FAULTS = {"ctc_neg_inf": "infeasible", "ctc_skip_equal": "loss"}


class _TorchArgmaxLast:
    """``torch`` with ``argmax`` taking the last of equal maxima (a
    planted fault)."""

    def __getattr__(self, name):
        import torch

        return getattr(torch, name)

    @staticmethod
    def argmax(x, dim):
        import torch

        return x.shape[dim] - 1 - torch.argmax(x.flip(dim), dim=dim)


@contextlib.contextmanager
def _path_fault(fault):
    """Plant ``fault`` in the port while the block runs: the TAL argmax
    taking the last maximum, the assignment reading attached scores and
    boxes (no ``.detach()``), ``yolo_loss`` letting padded rows write
    cell (0, 0) or the first of two rows in one cell win, CTC's impossible
    paths at ``-inf``, or CTC skipping between equal labels."""
    import torch

    from paddle_tpu_torch.models import ppyoloe as TP
    from paddle_tpu_torch.nn import functional as PF
    from paddle_tpu_torch.vision import ops as V

    real_winners = V._scatter_winners
    patches = {
        None: [],
        "argmax_last": [(TP, "torch", _TorchArgmaxLast())],
        "no_detach": [(torch.Tensor, "detach", lambda self: self)],
        "padded_rows_write": [(V, "_scatter_winners",
                               lambda cell, resp: torch.ones_like(resp))],
        "first_row_wins": [(V, "_scatter_winners", lambda cell, resp:
                            real_winners(cell.flip(1), resp.flip(1)).flip(1))],
        "ctc_neg_inf": [(PF, "_CTC_NEG", float("-inf"))],
        "ctc_skip_equal": [(PF, "_ctc_skip_ok", lambda ext: torch.cat(
            [torch.zeros_like(ext[:, :2], dtype=torch.bool),
             torch.ones_like(ext[:, 2:], dtype=torch.bool)], dim=1))]}[fault]
    saved = [(obj, name, name in vars(obj), getattr(obj, name))
             for obj, name, _ in patches]
    for obj, name, value in patches:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for obj, name, own, value in reversed(saved):
            if own:
                setattr(obj, name, value)
            else:
                delattr(obj, name)


def _det_batch(rng, batch, size, kind, duplicate=False):
    """``(images, gt_boxes, gt_labels)`` as numpy: float32 images, 1-20
    boxes an image padded to DET_GT rows (label -1), xyxy pixels for
    PP-YOLOE, normalised (cx, cy, w, h) for YOLOv3 (padding zeros).
    ``duplicate`` puts two boxes of image 0 in one stride-32 cell with the
    same best anchor and different classes."""
    import numpy as np

    x = rng.standard_normal((batch, 3, size, size)).astype(np.float32)
    boxes = np.zeros((batch, DET_GT, 4), np.float32)
    labels = np.full((batch, DET_GT), -1, np.int64)
    for b in range(batch):
        k = int(rng.integers(DET_GT_REAL[0], DET_GT_REAL[1] + 1))
        wh = rng.uniform(0.04, 0.6, (k, 2))
        ctr = rng.uniform(wh / 2, 1 - wh / 2)
        if kind == "ppyoloe":
            boxes[b, :k] = np.concatenate([ctr - wh / 2, ctr + wh / 2],
                                          1) * size
        else:
            boxes[b, :k] = np.concatenate([ctr, wh], 1)
        labels[b, :k] = rng.integers(0, DET_CLASSES, k)
    if kind == "ppyoloe":
        boxes[labels < 0] = -1.0
    if duplicate:
        boxes[0, :2] = [[0.45, 0.55, 0.36, 0.30], [0.47, 0.57, 0.38, 0.29]]
        labels[0, :2] = [3, 41]
    return x, boxes, labels


def _ppyoloe_ctor(**kw):
    from paddle_tpu_torch.models.ppyoloe import ppyoloe_s

    return ppyoloe_s(num_classes=DET_CLASSES, **kw)


def _yolo_ctor(**kw):
    from paddle_tpu_torch.models.yolo import YOLOv3

    return YOLOv3(num_classes=DET_CLASSES, width=YOLO_WIDTH, **kw)


def _crnn_ctor(**kw):
    from paddle_tpu_torch.models.ocr import CRNN

    return CRNN(OCR_CLASSES, **kw)


def _det_opt(kind):
    from paddle_tpu_torch.optimizer import Adam, Momentum

    if kind == "crnn":
        return Adam(learning_rate=OCR_LR)
    lr = PPYOLOE_LR if kind == "ppyoloe" else YOLO_LR
    return Momentum(lr, DET_MOMENTUM, weight_decay=DET_DECAY)


def _outputs(kind, out) -> list:
    """The logits of a forward: PP-YOLOE's class and box logits, YOLOv3's
    three heads, CRNN's ``[T, B, classes]``."""
    return list(out[:2]) if kind == "ppyoloe" else \
        list(out) if kind == "yolov3" else [out]


def _yard_run(kind, model, batch) -> dict:
    """One TrainStep of ``model`` (a training-mode forward through
    EvalStep before it: batch statistics, buffers kept): its loss, logits,
    parameters and statistics after it, and the path's own check on the
    forward's outputs (the TAL assignment, the per-image yolo_loss of each
    head, CTC on an infeasible label), all read back to the host."""
    import torch

    from paddle_tpu_torch.framework.jit import EvalStep, LossAdapter, \
        TrainStep
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.vision import ops as V

    def host(t):
        return t.detach().cpu().clone()

    step = TrainStep(LossAdapter(model), _det_opt(kind))
    out = EvalStep(model)(batch[0])
    dev = next(model.parameters()).device
    check = {}
    with torch.no_grad():
        if kind == "ppyoloe":
            cls, reg, pts, strs = out
            scores, boxes = torch.sigmoid(cls), model._decode(reg, pts, strs)
            got = model._assign(scores, boxes, pts,
                                torch.as_tensor(batch[1], device=dev).to(
                                    boxes.dtype),
                                torch.as_tensor(batch[2], device=dev))
            check = dict(inputs=[host(scores), host(boxes), host(pts)],
                         assign=[host(t) for t in got])
        elif kind == "yolov3":
            check = dict(heads=[host(h) for h in out], losses=[
                host(V.yolo_loss(h, batch[1], batch[2], model.anchors, m,
                                 DET_CLASSES, model.ignore_thresh, ds))
                for h, m, ds in zip(out, model.anchor_masks,
                                    model.downsample_ratios)])
    if kind == "crnn":
        logits = out.detach().clone().requires_grad_()
        labels, in_len, lab_len = _ocr_infeasible(batch, logits.shape[0])
        loss = F.ctc_loss(logits, labels, in_len, lab_len, reduction="none")
        loss.sum().backward()
        check = dict(logits=host(logits), loss=host(loss),
                     grad_finite=bool(torch.isfinite(logits.grad).all()))
    loss = step(batch).item()
    return dict(loss=loss, logits=[host(t) for t in _outputs(kind, out)],
                params={k: host(p) for k, p in model.named_parameters()},
                stats={k: host(b) for k, b in model.named_buffers()},
                check=check)


def _ocr_infeasible(batch, frames: int):
    """The batch's labels with the first sequence given more labels than
    its ``frames`` can emit (repeats need a blank between them)."""
    import numpy as np

    labels = np.array(batch[1])
    lab_len = np.array(batch[2])
    labels[0, :frames] = np.arange(frames) % 7 + 1
    lab_len[0] = min(frames, labels.shape[1])
    in_len = np.full(labels.shape[0], frames, np.int64)
    in_len[0] = frames // 2
    return labels, in_len, lab_len


def _rel(a, b) -> float:
    return float((a.double() - b.double()).abs().max()
                 / max(float(b.double().abs().max()), 1e-30))


def _yard_readings(kind, run: dict, ref: dict, initial: dict, base,
                   batch) -> dict:
    """Part (a)'s readings of a run against the float64 one; the path's
    own check is recomputed on the CPU (float32 CTC and assignment,
    float64 yolo_loss) from the run's own inputs."""
    import torch

    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.vision import ops as V

    stats = {k: _rel(v, ref["stats"][k]) for k, v in run["stats"].items()}
    worst_stat = max(stats, key=stats.get)
    num = den = 0.0
    leaf = {}
    for k, p in run["params"].items():
        d_ref = ref["params"][k].double() - initial[k].double()
        diff = (p.double() - initial[k].double()) - d_ref
        num += float((diff ** 2).sum())
        den += float((d_ref ** 2).sum())
        leaf[k] = float(diff.norm() / max(float(d_ref.norm()), 1e-30))
    worst_leaf = max(leaf, key=leaf.get)
    r = dict(loss=run["loss"],
             loss_rel_err=abs(run["loss"] - ref["loss"]) / abs(ref["loss"]),
             logits_rel_err=max(_rel(a, b) for a, b in
                                zip(run["logits"], ref["logits"])),
             stats_rel_err=stats[worst_stat], worst_stat=worst_stat,
             update_err=(num / den) ** 0.5,
             update_err_worst_leaf=leaf[worst_leaf], worst_leaf=worst_leaf)
    c = run["check"]
    if kind == "ppyoloe":
        scores, boxes, pts = c["inputs"]
        want = base._assign(scores, boxes, pts, torch.as_tensor(batch[1]),
                            torch.as_tensor(batch[2]))
        got = c["assign"]
        r["fg"] = int(got[0].sum())
        r["assignment_equal"] = all(torch.equal(g, w) for g, w in
                                    zip(got[:3], want[:3]))
        r["assigned_scores_rel_err"] = _rel(got[3], want[3])
    elif kind == "yolov3":
        r["target_loss_rel_err"] = max(
            _rel(got, V.yolo_loss(h.double(), batch[1], batch[2],
                                  base.anchors, m,
                                  DET_CLASSES, base.ignore_thresh, ds))
            for got, h, m, ds in zip(c["losses"], c["heads"],
                                     base.anchor_masks,
                                     base.downsample_ratios))
    else:
        labels, in_len, lab_len = _ocr_infeasible(batch,
                                                  c["logits"].shape[0])
        want = F.ctc_loss(c["logits"], labels, in_len, lab_len,
                          reduction="none")
        r["infeasible_loss"] = float(c["loss"][0])
        r["infeasible_rel_err"] = _rel(c["loss"], want) \
            if bool(torch.isfinite(c["loss"]).all()) else float("inf")
        r["infeasible_grad_finite"] = c["grad_finite"]
    return r


def _gates(kind, floor: dict) -> dict:
    g = {k: max(YARD_FACTOR * floor[f"{k}_rel_err"], YARD_FLOORS[k])
         for k in ("loss", "logits", "stats")}
    g["update"] = max(YARD_FACTOR * floor["update_err"],
                      YARD_FLOORS["update"])
    if kind == "yolov3":
        g["target_loss"] = max(YARD_FACTOR * floor["target_loss_rel_err"],
                               YARD_FLOORS["target_loss"])
    if kind == "ppyoloe":
        g["assigned_scores"] = 1e-5
    if kind == "crnn":
        g["infeasible"] = 1e-5
    return g


def _gate_fails(kind, r: dict, g: dict) -> list:
    """The gates reading ``r`` fails."""
    bad = [k for k in ("loss", "logits", "stats")
           if not r[f"{k}_rel_err"] <= g[k]]
    if not r["update_err"] <= g["update"]:
        bad.append("update")
    if kind == "ppyoloe" and not (r["assignment_equal"] and
                                  r["assigned_scores_rel_err"] <=
                                  g["assigned_scores"]):
        bad.append("assignment")
    if kind == "yolov3" and not r["target_loss_rel_err"] <= g["target_loss"]:
        bad.append("target_loss")
    if kind == "crnn" and not (r["infeasible_rel_err"] <= g["infeasible"]
                               and r["infeasible_grad_finite"]):
        bad.append("infeasible")
    return bad


def _yardstick(kind, phase: str, seed: int, device: str, ctor, batch,
               faults: dict) -> dict:
    """Part (a): the float32 step on ``device`` against the CPU's float64
    one, sound and with each planted fault in the ``device`` run; the
    CPU's float32 step read against it too (float32's own cost)."""
    import copy

    import numpy as np
    import torch

    base = ctor(device="cpu",
                generator=torch.Generator().manual_seed(seed)).train()
    initial = {k: p.detach().clone() for k, p in base.named_parameters()}
    t0 = time.perf_counter()
    b64 = tuple(a.astype(np.float64) if a.dtype == np.float32 else a
                for a in batch)
    ref = _yard_run(kind, copy.deepcopy(base).double(), b64)
    cpu64_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    floor = _yard_readings(kind, _yard_run(kind, copy.deepcopy(base), batch),
                           ref, initial, base, batch)
    cpu32_s = time.perf_counter() - t0
    gates = _gates(kind, floor)
    runs = {}
    for fault in (None,) + tuple(faults):
        with _path_fault(fault):
            run = _yard_run(kind, copy.deepcopy(base).to(device), batch)
        runs[fault or "sound"] = _yard_readings(kind, run, ref, initial, base,
                                                batch)
    out = dict(batch=list(batch[0].shape), cpu_float64_step_s=cpu64_s,
               cpu_float32_step_s=cpu32_s, cpu_loss_float64=ref["loss"],
               gates=gates, cpu_float32=floor, readings=runs,
               faults=dict(faults))
    failed = ["sound"] if _gate_fails(kind, runs["sound"], gates) else []
    failed += [f for f, gate in faults.items()
               if gate not in _gate_fails(kind, runs[f], gates)]
    if failed:
        emit(phase, model=kind, yardstick=out)
        raise AssertionError(f"{phase} (a) {kind}: {failed} on the wrong "
                             f"side of their gates (the sound run must pass "
                             f"every gate, each planted fault trip its own)")
    return out


def _step_profile(fn, device: str) -> dict:
    """Kernel launches and kernel ms of one call of ``fn`` from
    torch.profiler (CUDA kernels of its trace, copies included), and the
    ms of its host-to-device and device-to-host copies alone; None on the
    CPU or when the trace holds no device time."""
    import torch

    if torch.device(device).type != "cuda":
        return dict(launches=None, kernel_ms=None, h2d_ms=None, d2h_ms=None)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    launches, us, copies = 0, 0.0, {"HtoD": 0.0, "DtoH": 0.0}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        launches += ev.count
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        us += t
        for way in copies:
            if way in ev.key:
                copies[way] += t
    return dict(launches=launches, kernel_ms=us / 1e3 if us else None,
                h2d_ms=copies["HtoD"] / 1e3, d2h_ms=copies["DtoH"] / 1e3)


def _path_train_run(phase: str, kind, seed: int, device: str, ctor, batch,
                  fa) -> tuple:
    """Part (b): DET_WARMUP + DET_TIMED steps of ``kind`` at its
    configuration on ``device`` on one repeated batch, and one step traced
    for its launches and idle share. Returns ``(report, model)``."""
    import torch

    from paddle_tpu_torch.framework import random as framework_random
    from paddle_tpu_torch.framework.jit import LossAdapter, TrainStep

    framework_random.seed(seed)
    t0 = time.perf_counter()
    model = ctor(device=device, generator=torch.Generator(device).manual_seed(
        seed)).train()
    step = TrainStep(LossAdapter(model), _det_opt(kind))
    dev_batch = tuple(torch.as_tensor(a, device=device) for a in batch)
    build_s = time.perf_counter() - t0
    fa.reset_launch_counts()
    run = _rn_timed_steps(step, dev_batch, device, DET_WARMUP, DET_TIMED)
    flash = sum(_counts(fa))
    prof = _step_profile(lambda: step(dev_batch), device)
    losses = run["losses"]
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0] or flash:
        raise AssertionError(f"{phase} (b) {kind}: losses {losses}, {flash} "
                             f"flash launches (0 expected)")
    n = batch[0].shape[0]
    kernel_ms = prof["kernel_ms"]
    report = dict(
        **run, batch=list(batch[0].shape), images_per_s=n / (
            run["step_ms_median"] / 1e3), flash_launches=flash,
        launches_per_step=prof["launches"], kernel_ms_per_step=kernel_ms,
        idle_share=(None if kernel_ms is None
                    else 1.0 - kernel_ms / run["step_ms_median"]),
        model_build_s=build_s,
        params=sum(p.numel() for p in model.parameters()))
    del step
    return report, model


def _host_ms(fn, device: str, repeats: int = SERVE_REPEATS):
    """``fn()``'s result and its median host ms over ``repeats`` calls
    after one warm-up, each ended by a synchronisation."""
    import statistics

    out = fn()
    ms = []
    for _ in range(repeats):
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, statistics.median(ms)


def _serve(kind, model, size: int, seed: int, device: str) -> dict:
    """Part (c): ``predict`` at batch 1 (PP-YOLOE fused first, held to the
    unfused model in eval mode), each stage timed (forward, decode, NMS,
    ms an image), its rows held to the CPU port's matrix_nms given the
    same decoded arrays."""
    import copy

    import numpy as np
    import torch

    from paddle_tpu_torch.vision import ops as V

    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((1, 3, size, size)).astype(
        np.float32), device=device)
    model.eval()
    out = {}
    with torch.no_grad():
        if kind == "ppyoloe":
            unfused = model(x)
            model = copy.deepcopy(model)
            model.fuse_rep()
            fused = model(x)
            out["fused_rel_err"] = max(_rel(a, b) for a, b in
                                       zip(fused[:2], unfused[:2]))
            if not out["fused_rel_err"] <= FUSE_RTOL:
                raise AssertionError(f"detection (c): fused PP-YOLOE off "
                                     f"the unfused by {out['fused_rel_err']}")
            del unfused, fused
            heads, fwd_ms = _host_ms(lambda: model(x), device)

            def decode():
                cls, reg, pts, strs = heads
                return (model._decode(reg, pts, strs),
                        torch.sigmoid(cls).transpose(1, 2))

            rows = model.predict(x)
        else:
            img = torch.tensor([[size, size]], device=device)
            heads, fwd_ms = _host_ms(lambda: model(x), device)

            def decode():
                return model._decode(heads, img, 0.01)

            rows = model.predict(x, img)
        (boxes, scores), dec_ms = _host_ms(decode, device)
        nms_args = (0.01, 0.01, 400, 100)
        _, nms_ms = _host_ms(lambda: V.matrix_nms(
            boxes, scores, *nms_args, background_label=-1), device)
        want = V.matrix_nms(boxes.cpu(), scores.cpu(), *nms_args,
                            background_label=-1)
    equal = all(torch.equal(a.cpu(), b) for a, b in zip(rows, want))
    if not equal:
        raise AssertionError(f"detection (c) {kind}: predict's rows differ "
                             f"from the CPU matrix_nms of the same arrays")
    out.update(batch=[1, 3, size, size], forward_ms=fwd_ms,
               decode_ms=dec_ms, nms_ms=nms_ms,
               ms_per_image=fwd_ms + dec_ms + nms_ms,
               candidates=int((scores > 0.01).sum()),
               detections=int(rows[1].sum()), rows_equal_cpu=equal)
    return out


def phase_detection_training(seed: int, device: str = "cuda",
                             sizes=None) -> dict:
    """The detectors through the port's TrainStep (LossAdapter over each
    model's ``loss``; no flash kernel on this path): (a) one float32 step
    of ppyoloe_s and of YOLOv3(80, 32) at batch 2, 320 x 320, on the card
    against the CPU's float64 step (loss, logits, every statistic, the
    update; the TAL assignment against the CPU's on the same inputs;
    yolo_loss of each head against the CPU's in float64), sound and with
    two planted faults a model that must trip their gates; (b) ppyoloe_s
    at [8, 3, 640, 640] and YOLOv3 at [8, 3, 608, 608], float32,
    Momentum(0.9) with L2 5e-4, DET_WARMUP + DET_TIMED steps on CUDA
    events (ms, images/s, peak, launches and idle share of one traced
    step, falling loss, 0 flash launches); (c) serving at batch 1.
    ``device="cpu"`` and ``sizes`` (``{kind: (batch, size)}``, with
    "yard" the yardstick's) give a dry run on the CPU."""
    import numpy as np

    from paddle_tpu_torch.kernels import flash_attention as fa

    cuda = device != "cpu"
    sizes = sizes or {}
    leftover = _check_freed("detection_training") if cuda else None
    out = dict(path=DET_PATH, leftover_gib_at_start=leftover,
               card=nvidia_smi_line())
    yb, ys = sizes.get("yard", (YARD_BATCH, YARD_SIZE))
    for kind, ctor, faults, dup in (
            ("ppyoloe", _ppyoloe_ctor, DET_FAULTS["ppyoloe"], False),
            ("yolov3", _yolo_ctor, DET_FAULTS["yolov3"], True)):
        t0 = time.perf_counter()
        batch = _det_batch(np.random.default_rng(seed + 40), yb, ys, kind,
                           duplicate=dup)
        yard = _yardstick(kind, "detection_training", seed + 41, device,
                          ctor, batch, faults)
        yard["seconds"] = time.perf_counter() - t0
        out[f"{kind}_yardstick"] = yard
        if cuda:
            _free()
    for kind, ctor, (batch, size) in (
            ("ppyoloe", _ppyoloe_ctor, sizes.get(
                "ppyoloe", (PPYOLOE_BATCH, PPYOLOE_SIZE))),
            ("yolov3", _yolo_ctor, sizes.get("yolov3",
                                              (YOLO_BATCH, YOLO_SIZE)))):
        t0 = time.perf_counter()
        data = _det_batch(np.random.default_rng(seed + 42), batch, size,
                          kind)
        report, model = _path_train_run("detection_training", kind, seed + 43,
                                      device, ctor, data, fa)
        fa.reset_launch_counts()
        report["serving"] = _serve(kind, model, size, seed + 44, device)
        report["serving"]["flash_launches"] = sum(_counts(fa))
        report["seconds"] = time.perf_counter() - t0
        out[kind] = report
        del model
        if cuda:
            _free()
    emit("detection_training", **out)
    return out


def _ocr_batch(rng, batch: int, width: int, repeats: bool = False):
    """``(images, labels, label_lengths)``: float32 crops of height 32,
    1-OCR_MAX_LABEL ids in [1, OCR_CLASSES) an image padded with 0 (the
    blank); ``repeats`` makes every label pair up with its neighbour (the
    CTC skip rule's case)."""
    import numpy as np

    x = rng.standard_normal((batch, 3, OCR_H, width)).astype(np.float32)
    frames = width // 4
    longest = min(OCR_MAX_LABEL, frames // 2)
    lab_len = rng.integers(1, longest + 1, batch).astype(np.int64)
    labels = rng.integers(1, OCR_CLASSES, (batch, OCR_MAX_LABEL))
    if repeats:
        labels[:, 1::2] = labels[:, 0::2][:, :labels[:, 1::2].shape[1]]
    labels[np.arange(OCR_MAX_LABEL)[None, :] >= lab_len[:, None]] = 0
    return x, labels.astype(np.int64), lab_len


def _lstm_and_ctc_yardsticks(device: str, seed: int) -> dict:
    """The port's LSTM (a loop over time) and CTC (the alpha recursion),
    forward + backward at the full configuration's shapes, beside
    torch.nn.LSTM (cuDNN) and torch's ctc_loss on the same inputs: ms a
    call, host clock, synchronised."""
    import numpy as np
    import torch

    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn.layers.rnn import LSTM

    T, B, C, H = OCR_W // 4, OCR_BATCH, 128, 64
    g = torch.Generator(device).manual_seed(seed)
    x = torch.randn(T, B, C, device=device, generator=g, requires_grad=True)
    port = LSTM(C, H, direction="bidirect", time_major=True, device=device,
                generator=g)
    lib = torch.nn.LSTM(C, H, bidirectional=True).to(device)

    def port_lstm():
        port(x)[0].sum().backward()

    def lib_lstm():
        lib(x)[0].sum().backward()

    logits = torch.randn(T, B, OCR_CLASSES, device=device, generator=g,
                         requires_grad=True)
    _, labels, lab_len = _ocr_batch(np.random.default_rng(seed), B, OCR_W)
    labels_t = torch.as_tensor(labels, device=device)
    lab_len_t = torch.as_tensor(lab_len, device=device)
    in_len = torch.full((B,), T, dtype=torch.long, device=device)

    def port_ctc():
        F.ctc_loss(logits, labels_t, in_len, lab_len_t).backward()

    def lib_ctc():
        torch.nn.functional.ctc_loss(
            torch.log_softmax(logits, -1), labels_t, in_len,
            lab_len_t).backward()

    out = {}
    for name, fn in (("lstm_port_ms", port_lstm), ("lstm_cudnn_ms", lib_lstm),
                     ("ctc_port_ms", port_ctc), ("ctc_torch_ms", lib_ctc)):
        out[name] = _host_ms(fn, device)[1]
    out["shapes"] = dict(lstm=[T, B, C, H, "bidirect"],
                         ctc=[T, B, OCR_CLASSES, OCR_MAX_LABEL])
    return out


def phase_ocr_training(seed: int, device: str = "cuda", batch=None,
                       width=None) -> dict:
    """CRNN(6625) through the port's TrainStep (LossAdapter over ``loss``:
    the conv stack, the bidirectional LSTM as a loop over time, CTC's
    alpha recursion; no flash kernel): (a) one float32 Adam step at batch
    4 on [4, 3, 32, 64] on the card against the CPU's float64 step (loss,
    logits, statistics, update; an infeasible label's loss the CPU's
    finite value), sound and with two planted faults that must trip their
    gates; (b) [128, 3, 32, 320] (T = 80), DET_WARMUP + DET_TIMED steps
    (ms, images/s, peak, launches and idle share of a traced step,
    falling loss, 0 flash launches), with the port's LSTM and CTC timed
    beside cuDNN's LSTM and torch's ctc_loss; (c) greedy decode of the
    batch equal to the CPU's decode of the same logits. ``device="cpu"``,
    ``batch`` and ``width`` give a dry run on the CPU."""
    import numpy as np
    import torch

    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models.ocr import CRNN

    cuda = device != "cpu"
    leftover = _check_freed("ocr_training") if cuda else None
    out = dict(path=OCR_PATH, leftover_gib_at_start=leftover,
               card=nvidia_smi_line())
    t0 = time.perf_counter()
    yard_batch = _ocr_batch(np.random.default_rng(seed + 50),
                            OCR_YARD_BATCH, OCR_YARD_W, repeats=True)
    out["yardstick"] = _yardstick("crnn", "ocr_training", seed + 51, device,
                                  _crnn_ctor, yard_batch, OCR_FAULTS)
    out["yardstick"]["seconds"] = time.perf_counter() - t0
    if cuda:
        _free()
    t0 = time.perf_counter()
    data = _ocr_batch(np.random.default_rng(seed + 52), batch or OCR_BATCH,
                      width or OCR_W)
    report, model = _path_train_run("ocr_training", "crnn", seed + 53, device,
                                  _crnn_ctor, data, fa)
    model.eval()
    x = torch.as_tensor(data[0], device=device)
    with torch.no_grad():
        decoded, decode_ms = _host_ms(lambda: model.decode(x), device)
        ids = torch.argmax(model(x).cpu(), dim=-1).numpy()
    report["decode_ms"] = decode_ms
    report["decode_equal_cpu"] = decoded == CRNN.greedy_collapse(ids)
    if not report["decode_equal_cpu"]:
        raise AssertionError("ocr_training (c): the card's greedy decode "
                             "differs from the CPU's of the same logits")
    report["frames"] = int(ids.shape[0])
    if cuda and batch is None:
        report["yardsticks"] = _lstm_and_ctc_yardsticks(device, seed + 54)
    report["seconds"] = time.perf_counter() - t0
    out["crnn"] = report
    del model
    if cuda:
        _free()
    emit("ocr_training", **out)
    return out


# --------------------------------------------------------------------------
# the parameter-server and graph path: host C++ tables and graph store,
# the PS and graph services, CTR and DeepWalk training (no flash kernel)
# --------------------------------------------------------------------------

PS_PATH = ("training (CTR: SparseEmbedding over a 2M-key adagrad table, "
           "Linear(32, 32), Linear(32, 1), batch 8192)")
GRAPH_PATH = ("training (DeepWalk skip-gram over GraphDataGenerator on a "
              "10M-edge graph, [1M, 64] float32; GraphSAGE message passing)")
# tools/ps_bench.py:31-45: 2M keys drawn from [0, 2^40), dim 16, adagrad,
# batches of 8192, 100 hot-pull and push batches
PS_KEYS = 2_000_000
PS_DIM = 16
PS_BATCH = 8192
PS_BENCH_ITERS = 100
# examples/ps_ctr_train.py:28-60: SparseEmbedding(16, adagrad, lr 0.1,
# seed 0), Linear(32, 32), Linear(32, 1), BCE with logits, dense SGD 0.05
PS_LR_SPARSE = 0.1
PS_LR_DENSE = 0.05
# 40 steps cut to 20: with 40 the whole smoke took 1264.5 s of its 1200 on
# an H100 host running slow (1072.2 s on another)
PS_STEPS = 20
PS_WARMUP = 5               # steps before the timed median
# a reading passes under YARD_FACTOR times the CPU float32 run's own
# distance from the CPU float64 run (at least these floors)
PS_FLOORS = dict(loss=1e-6, update=1e-5, rows=1e-5)
PS_FAULTS = {"skip_push": "rows", "merge_duplicates": "rows"}
# tools/graph_bench.py:193-202: 10M edges, nodes = edges // 10, batch
# 4096, sample size 10, walk length 20, 50 iterations (25 over the shards)
GRAPH_EDGES = 10_000_000
GRAPH_BATCH, GRAPH_SAMPLE, GRAPH_WALK = 4096, 10, 20
GRAPH_ITERS = 50
# graph_bench's bench_overlap (:111-190): GraphDataGenerator(4096, walk 8,
# window 2, 4 negatives, seed 0), embedding [N, 64], lr 0.1, 30 steps
DW_BATCH, DW_DIM, DW_LR, DW_STEPS = 4096, 64, 0.1, 30
DW_FLOORS = dict(loss=1e-6, emb=1e-6)
# GraphSAGE's published fan-outs (25, 10) from 1024 seeds, 64-wide features
KHOP_SEEDS, KHOP_SIZES, KHOP_DIM = 1024, (25, 10), 64
MP_RTOL = 1e-5

_NATIVE: dict = {}


def _start_native_build() -> None:
    """Compile the port's native runtime (g++) on a thread, so it overlaps
    the device-bound phases; :func:`_native_built` joins it."""
    import threading

    def run():
        t0 = time.perf_counter()
        try:
            from paddle_tpu_torch import native

            _NATIVE["library"] = native.build()
        except BaseException as e:  # re-raised by _native_built
            _NATIVE["error"] = e
        _NATIVE["build_s"] = time.perf_counter() - t0

    _NATIVE["thread"] = threading.Thread(target=run, daemon=True)
    _NATIVE["thread"].start()


def _native_built() -> dict:
    """The native build's library and seconds (started here if no one
    started it); raises if it failed."""
    if "thread" not in _NATIVE:
        _start_native_build()
    _NATIVE["thread"].join()
    if "error" in _NATIVE:
        raise RuntimeError("the native runtime did not build") \
            from _NATIVE["error"]
    return dict(library=os.path.relpath(_NATIVE["library"]),
                build_s=_NATIVE["build_s"])


def _host_info() -> dict:
    return dict(cpu_count=os.cpu_count(),
                cpus_usable=len(os.sched_getaffinity(0)))


def _in_background(fn, *args):
    """``fn(*args)`` on a thread (server start-up overlapping other work):
    ``join()`` returns its result or raises its exception. The thread
    lives on until ``release()``: a server started with PDEATHSIG dies
    with the thread that started it, not with the process."""
    import threading

    box, ready, done = {}, threading.Event(), threading.Event()

    def run():
        try:
            box["out"] = fn(*args)
        except BaseException as e:
            box["err"] = e
        ready.set()
        done.wait()

    th = threading.Thread(target=run, daemon=True)
    th.start()

    class Job:
        @staticmethod
        def join():
            ready.wait()
            if "err" in box:
                raise box["err"]
            return box["out"]

        @staticmethod
        def release():
            done.set()
            th.join()

    return Job


def _flash_idle(fa, phase: str) -> dict:
    counts = fa.launch_counts()
    if any(n for routes in counts.values() for n in routes.values()):
        raise AssertionError(f"{phase}: flash kernels launched on a path "
                             f"that has no attention: {counts}")
    return {k: 0 for k in counts}


def _rel_l2(a, b) -> float:
    """||a - b|| / ||b|| in float64 (0 for two zero arrays)."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    den = float(np.linalg.norm(b))
    num = float(np.linalg.norm(a - b))
    return num / den if den else num


def _ctr_table():
    from paddle_tpu_torch.distributed.ps import MemorySparseTable

    return MemorySparseTable(embed_dim=PS_DIM, optimizer="adagrad",
                             learning_rate=PS_LR_SPARSE, seed=0)


def _ctr_model(table, device, dtype, state):
    """examples/ps_ctr_train.py's CTRModel at its widths over ``table``,
    its dense tower in ``dtype`` with the weights ``state``."""
    import torch

    from paddle_tpu_torch.distributed.ps import SparseEmbedding
    from paddle_tpu_torch.nn.layers.common import Linear

    class CTRModel(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.emb = SparseEmbedding(PS_DIM, table=table, device=device)
            self.fc1 = Linear(2 * PS_DIM, 32, device=device)
            self.fc2 = Linear(32, 1, device=device)

        def tower(self, u, v):
            x = torch.cat([u, v], -1).to(self.fc1.weight.dtype)
            return self.fc2(torch.relu(self.fc1(x)))[:, 0]

        def forward(self, user_ids, item_ids):
            return self.tower(self.emb(user_ids), self.emb(item_ids))

    model = CTRModel()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in state:
                p.data = state[name].to(device=device, dtype=dtype).clone()
    return model.train()


def _bce(logits, labels):
    import torch

    labels = labels.to(logits.dtype)
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def _ctr_batches(universe, seed: int, steps: int, batch: int):
    """User and item ids drawn with repeats (squared-uniform positions in
    the key universe, graph_bench's skew), labels by the example's rule."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        users, items = (universe[(rng.random(batch) ** 2
                                  * universe.size).astype(np.int64)]
                        for _ in range(2))
        labels = ((users % 3 == 0) & (items % 2 == 0)).astype(np.float32)
        out.append((users, items, labels))
    return out


class _TableClock:
    """Host seconds spent in a table's pull and push (instance wrappers)."""

    def __init__(self, table):
        self.table, self.pull_s, self.push_s = table, 0.0, 0.0
        self._pull, self._push = table.pull, table.push

        def pull(keys):
            t0 = time.perf_counter()
            try:
                return self._pull(keys)
            finally:
                self.pull_s += time.perf_counter() - t0

        def push(keys, grads):
            t0 = time.perf_counter()
            try:
                return self._push(keys, grads)
            finally:
                self.push_s += time.perf_counter() - t0

        table.pull, table.push = pull, push

    def reset(self):
        self.pull_s = self.push_s = 0.0


@contextlib.contextmanager
def _ps_fault(fault):
    """A planted fault in the lookup's backward: ``skip_push`` drops the
    push, ``merge_duplicates`` sums duplicate ids' gradients and pushes
    each key once (adagrad then sees one merged step, not one per
    occurrence)."""
    if fault is None:
        yield
        return
    import numpy as np
    import torch

    from paddle_tpu_torch.distributed.ps import embedding as E

    saved = E._Lookup.__dict__["backward"]

    def backward(ctx, grad):
        g = grad.detach().reshape(-1, ctx.table.embed_dim).to(
            "cpu", torch.float32).numpy()
        if fault == "merge_duplicates":
            uniq, inv = np.unique(ctx.flat, return_inverse=True)
            merged = np.zeros((uniq.size, g.shape[1]), np.float32)
            np.add.at(merged, inv, g)
            ctx.table.push(uniq, merged)
        shape, dtype, device = ctx.anchor_meta
        return None, torch.zeros(shape, dtype=dtype, device=device), None, \
            None

    E._Lookup.backward = staticmethod(backward)
    try:
        yield
    finally:
        E._Lookup.backward = saved


def _ctr_run(path, batches, state, device, dtype, *, table=None,
             staged=False, manual=False, fault=None, timed=False) -> dict:
    """One CTR training run from the table file ``path`` (or ``table``,
    already loaded) and the dense weights ``state``: through the lookup
    path (SparseEmbedding's Function; the port's TrainStep with SGD, or
    ``manual`` SGD in the tower's dtype for the float64 reference) or
    ``staged`` (StagedPull: one deduplicated pull and a merged push a
    step). Returns the losses, the dense update, the touched keys and
    their rows after the run, and with ``timed`` the step's split on the
    card."""
    import statistics

    import numpy as np
    import torch

    from paddle_tpu_torch.distributed.ps import StagedPull
    from paddle_tpu_torch.framework.jit import TrainStep
    from paddle_tpu_torch.optimizer import SGD

    cuda = torch.device(device).type == "cuda"
    out = {}
    if table is None:
        t0 = time.perf_counter()
        table = _ctr_table()
        table.load(path)
        out["load_s"] = time.perf_counter() - t0
    keys = np.unique(np.concatenate([np.concatenate(b[:2])
                                     for b in batches]))
    model = _ctr_model(table, device, dtype, state)
    dense = [p for n, p in model.named_parameters() if n.startswith("fc")]
    init = [p.detach().to("cpu", torch.float64).clone() for p in dense]
    stager = StagedPull(table, device=device) if staged else None

    def manual_step(b):
        users, items, labels = b
        lab = torch.as_tensor(labels, device=device)
        if staged:
            rows, inv, uniq = stager.pull(np.concatenate([users, items]))
            rows.requires_grad_(True)
            emb = StagedPull.lookup(rows, inv)
            loss = _bce(model.tower(emb[:users.size], emb[users.size:]), lab)
            grads = torch.autograd.grad(loss, [rows] + dense)
            stager.push(uniq, grads[0])
            grads = grads[1:]
        else:
            ids = [torch.as_tensor(a, device=device) for a in (users, items)]
            loss = _bce(model(*ids), lab)
            # the anchor among the inputs, so the lookup's backward (the
            # push) runs
            grads = torch.autograd.grad(
                loss, dense + [model.emb.grad_anchor])[:-1]
        with torch.no_grad():
            for p, g in zip(dense, grads):
                p.sub_(PS_LR_DENSE * g)
        return loss.detach()

    run = manual_step if (manual or staged) else TrainStep(
        model, SGD(learning_rate=PS_LR_DENSE),
        loss_fn=lambda o, b: _bce(o, b[2]), inputs_fn=lambda b: (b[0], b[1]))
    clock = _TableClock(table) if timed else None
    losses, ms, split = [], [], []
    with _ps_fault(fault):
        for i, b in enumerate(batches):
            if clock is not None:
                clock.reset()
            t0 = time.perf_counter()
            losses.append(run(b))
            if cuda:
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if clock is not None:
                split.append((clock.pull_s * 1e3, clock.push_s * 1e3))
    out["losses"] = [float(x) for x in torch.stack(losses).cpu()]
    out["update"] = [p.detach().to("cpu", torch.float64) - q
                     for p, q in zip(dense, init)]
    out["rows"] = table.pull(keys)
    out["keys"] = keys
    if timed and cuda:  # one more step, traced, after the readings
        b = batches[-1]
        clock.reset()
        t0 = time.perf_counter()
        prof = _step_profile(lambda: run(b), device)
        prof["step_ms"] = (time.perf_counter() - t0) * 1e3
        prof["pull_ms"], prof["push_ms"] = (clock.pull_s * 1e3,
                                            clock.push_s * 1e3)
        # kernel_ms counts the copies too: the device's busy time
        prof["device_ms"] = (prof["kernel_ms"] - prof["h2d_ms"]
                             - prof["d2h_ms"])
        prof["device_idle_share"] = 1.0 - prof["kernel_ms"] / prof["step_ms"]
        out["traced_step"] = prof
    if timed:
        warm = ms[PS_WARMUP:] or ms
        out["step_ms"] = statistics.median(warm)
        out["step_ms_range"] = [min(warm), max(warm)]
        if split:
            out["pull_ms"] = statistics.median(s[0] for s in split[
                PS_WARMUP:] or split)
            out["push_ms"] = statistics.median(s[1] for s in split[
                PS_WARMUP:] or split)
    out["model"], out["table"] = model, table
    return out


def _ctr_readings(run: dict, ref: dict, rows0) -> dict:
    import numpy as np

    l, lr = np.asarray(run["losses"]), np.asarray(ref["losses"])
    return dict(
        loss_rel_err=float(np.max(np.abs(l - lr) / np.maximum(np.abs(lr),
                                                              1e-30))),
        update_err=_rel_l2(np.concatenate([u.reshape(-1).numpy()
                                        for u in run["update"]]),
                        np.concatenate([u.reshape(-1).numpy()
                                        for u in ref["update"]])),
        rows_err=float(np.linalg.norm(
            run["rows"].astype(np.float64) - ref["rows"]) /
            np.linalg.norm(ref["rows"].astype(np.float64) - rows0)))


def _ctr_gates(floor: dict) -> dict:
    return {k: max(YARD_FACTOR * floor[f"{k}_rel_err" if k == "loss"
                                       else f"{k}_err"], PS_FLOORS[k])
            for k in PS_FLOORS}


def _ctr_fails(r: dict, gates: dict) -> list:
    return [k for k in gates
            if not r[f"{k}_rel_err" if k == "loss" else f"{k}_err"]
            <= gates[k]]


def _ctr_held(label, path, subset, batches, state, device, faults=(),
              staged=False) -> dict:
    """The timed run on ``device`` from the whole table file ``path``,
    held against the CPU's float64 run (the CPU float32 run read against
    it too: float32's own cost), and each planted fault on ``device``,
    which must trip its gate; those runs start from ``subset``, the same
    rows of every key the batches touch."""
    import numpy as np
    import torch

    from paddle_tpu_torch.distributed.ps.table import read_table_rows

    clock = {}

    def timed_run(name, table_file, *a, **kw):
        t0 = time.perf_counter()
        r = _ctr_run(table_file, batches, state, *a, **kw)
        clock[name] = time.perf_counter() - t0
        return r

    ref = timed_run("cpu_float64", subset, "cpu", torch.float64,
                    staged=staged, manual=True)
    rows0 = read_table_rows(subset, ref["keys"])[:, :PS_DIM].astype(
        np.float64)
    floor = _ctr_readings(timed_run("cpu_float32", subset, "cpu",
                                    torch.float32, staged=staged), ref, rows0)
    gates = _ctr_gates(floor)
    run = timed_run("sound", path, device, torch.float32, staged=staged,
                    timed=True)
    readings = {"sound": _ctr_readings(run, ref, rows0)}
    for fault in faults:
        readings[fault] = _ctr_readings(timed_run(
            fault, subset, device, torch.float32, fault=fault), ref, rows0)
    failed = ["sound"] if _ctr_fails(readings["sound"], gates) else []
    failed += [f for f in faults
               if PS_FAULTS[f] not in _ctr_fails(readings[f], gates)]
    losses = run["losses"]
    out = dict(gates=gates, cpu_float32=floor, readings=readings,
               losses=[losses[0], losses[-1]],
               cpu_float64_losses=[ref["losses"][0], ref["losses"][-1]],
               load_s=run.get("load_s"), run_s=clock)
    for k in ("step_ms", "step_ms_range", "pull_ms", "push_ms",
              "traced_step"):
        if k in run:
            out[k] = run[k]
    if "step_ms" in out:
        out["examples_per_s"] = len(batches[0][0]) / out["step_ms"] * 1e3
    if failed or not losses[-1] < losses[0]:
        emit("ps_ctr_training", part=label, **out)
        raise AssertionError(f"ps_ctr_training {label}: {failed} on the "
                             f"wrong side of their gates, or the loss did "
                             f"not fall ({losses[0]} -> {losses[-1]})")
    out["run"] = run
    return out


def phase_ps_ctr_training(seed: int, device: str = "cuda", keys=None,
                          batch=None, steps=None, bench_iters=None) -> dict:
    """The CTR regime of examples/ps_ctr_train.py at tools/ps_bench.py's
    scale: (a) the native runtime's build seconds, a 2M-key adagrad table
    filled with ps_bench's keys and its cold pull, hot pull and push rates
    at batch 8192 (the push's also with one key in half of each batch);
    (b) the example's CTRModel (SparseEmbedding(16), the
    dense tower through TrainStep with SGD(0.05)) trained 20 steps at batch
    8192 on ids drawn with repeats, from that table's file, held against
    the CPU's float64 run (losses, dense update, touched rows), sound and
    with two planted faults that must trip the rows gate, its step split
    into pull, copies, kernels and push on the card, and replayed bit for
    bit; (c) the same through StagedPull; (d) the same over two PsServer
    processes, sync (rows bit-equal to (b) where (b) replays) and through
    an async Communicator; (e) serving under eval() and no_grad: the rows
    unchanged, each key's show count up by its occurrences. ``device="cpu"``
    with small ``keys``, ``batch``, ``steps`` and ``bench_iters`` gives a
    dry run."""
    import tempfile

    import numpy as np
    import torch

    from paddle_tpu_torch.distributed.ps import launch_servers
    from paddle_tpu_torch.distributed.ps.table import write_table_subset
    from paddle_tpu_torch.kernels import flash_attention as fa

    cuda = device != "cpu"
    keys, batch = keys or PS_KEYS, batch or PS_BATCH
    steps, bench_iters = steps or PS_STEPS, bench_iters or PS_BENCH_ITERS
    out = dict(path=PS_PATH, host=_host_info(), card=nvidia_smi_line(),
               leftover_gib_at_start=_check_freed("ps_ctr_training")
               if cuda else None)
    fa.reset_launch_counts()
    t_phase = time.perf_counter()
    out["native"] = _native_built()
    servers = _in_background(launch_servers, 2, PS_DIM, "adagrad",
                             PS_LR_SPARSE, 0)
    # (a) the table at ps_bench's scale
    rng = np.random.default_rng(seed)
    universe = rng.integers(0, 2 ** 40, keys).astype(np.int64)
    table = _ctr_table()
    fill = keys // PS_BATCH * PS_BATCH
    t0 = time.perf_counter()
    for i in range(0, fill, PS_BATCH):
        table.pull(universe[i:i + PS_BATCH])
    cold = fill / (time.perf_counter() - t0)
    table.pull(universe[fill:])
    hot_batches = [rng.choice(universe, PS_BATCH) for _ in range(bench_iters)]
    t0 = time.perf_counter()
    for b in hot_batches:
        table.pull(b)
    hot = PS_BATCH * bench_iters / (time.perf_counter() - t0)
    grads = rng.standard_normal((PS_BATCH, PS_DIM)).astype(np.float32)
    t0 = time.perf_counter()
    for b in hot_batches:
        table.push(b, grads)
    push = PS_BATCH * bench_iters / (time.perf_counter() - t0)
    tmp = tempfile.mkdtemp(prefix="ps_ctr_")
    path = os.path.join(tmp, "table.bin")
    t0 = time.perf_counter()
    table.save(path)
    save_s = time.perf_counter() - t0
    # after the save: a CTR slot's hot value, one key in half of each batch
    # (the C++ push applies that key's repeats in order on one thread)
    pick = np.random.default_rng(seed + 4)
    for b in hot_batches:
        b[pick.random(PS_BATCH) < 0.5] = universe[0]
    t0 = time.perf_counter()
    for b in hot_batches:
        table.push(b, grads)
    push_hot = PS_BATCH * bench_iters / (time.perf_counter() - t0)
    out["tables"] = dict(
        keys=keys, rows=len(table), dim=PS_DIM, optimizer="adagrad",
        batch=PS_BATCH, cold_pull_keys_per_s=cold, hot_pull_keys_per_s=hot,
        push_adagrad_keys_per_s=push,
        push_half_one_key_keys_per_s=push_hot,
        save_s=save_s, file_bytes=os.path.getsize(path))
    del table, hot_batches
    try:
        # (b) the lookup path
        gen = torch.Generator().manual_seed(seed + 1)
        from paddle_tpu_torch.nn.layers.common import Linear

        state = {f"fc1.{k}": v for k, v in Linear(
            2 * PS_DIM, 32, device="cpu", generator=gen).state_dict().items()}
        state.update({f"fc2.{k}": v for k, v in Linear(
            32, 1, device="cpu", generator=gen).state_dict().items()})
        batches = _ctr_batches(universe, seed + 2, steps, batch)
        flat = np.concatenate([np.concatenate(b[:2]) for b in batches])
        _, counts = np.unique(flat, return_counts=True)
        b0 = np.concatenate(batches[0][:2])
        out["batches"] = dict(
            steps=steps, batch=batch, distinct_keys=int(counts.size),
            step0_ids=int(b0.size), step0_distinct=int(np.unique(b0).size),
            max_repeats_in_a_step=int(np.unique(b0, return_counts=True)[
                1].max()))
        t0 = time.perf_counter()
        subset = os.path.join(tmp, "touched.bin")
        write_table_subset(path, np.unique(flat), subset)
        out["batches"]["subset_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        look = _ctr_held("b", path, subset, batches, state, device,
                         faults=tuple(PS_FAULTS))
        replay = _ctr_run(subset, batches, state, device, torch.float32)
        run = look.pop("run")
        look["replay_bit_equal"] = bool(
            replay["losses"] == run["losses"]
            and np.array_equal(replay["rows"], run["rows"])
            and all(torch.equal(a, b) for a, b in zip(replay["update"],
                                                      run["update"])))
        look["seconds"] = time.perf_counter() - t0
        out["lookup"] = look
        # (e) serving the replayed model: eval() and no_grad, pulls only
        t0 = time.perf_counter()
        out["serving"] = _ctr_serving(replay, seed + 3, batch, tmp, device)
        out["serving"]["seconds"] = time.perf_counter() - t0
        del replay
        # (c) StagedPull: one deduplicated pull, one merged push a step
        t0 = time.perf_counter()
        staged = _ctr_held("c", path, subset, batches, state, device,
                           staged=True)
        staged.pop("run")
        staged["seconds"] = time.perf_counter() - t0
        out["staged"] = staged
        # (d) two PsServer processes, sync then async
        t0 = time.perf_counter()
        out["network"] = _ctr_network(servers.join(), subset, batches,
                                      state, device, run,
                                      look["replay_bit_equal"],
                                      look["gates"])
        out["network"]["seconds"] = time.perf_counter() - t0
        del run
    finally:
        try:   # a phase that failed before (d) leaves its servers up
            _reap(servers.join()[0], timeout=0)
        finally:
            servers.release()
            shutil.rmtree(tmp, ignore_errors=True)
    out["flash_launches"] = _flash_idle(fa, "ps_ctr_training")
    out["seconds"] = time.perf_counter() - t_phase
    if cuda:
        _free()
    emit("ps_ctr_training", **out)
    return out


def _ctr_serving(run, seed, batch, tmp, device) -> dict:
    """The trained model under eval() and no_grad over one batch of the
    keys it trained (drawn as the batches were): logits finite, every row
    and adagrad state unchanged, each served key's show count up by its
    occurrences (the reference's pull), no push."""
    import numpy as np
    import torch

    from paddle_tpu_torch.distributed.ps.table import read_table_file

    model, table, keys = run["model"], run["table"], run["keys"]
    rng = np.random.default_rng(seed)
    users, items = (keys[(rng.random(batch) ** 2 * keys.size)
                         .astype(np.int64)] for _ in range(2))
    before, after = (os.path.join(tmp, n) for n in ("serve0.bin",
                                                    "serve1.bin"))
    t0 = time.perf_counter()
    table.save(before)
    save_s = time.perf_counter() - t0
    model.eval()
    clock = _TableClock(table)
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = model(torch.as_tensor(users, device=device),
                       torch.as_tensor(items, device=device))
        finite = bool(torch.isfinite(logits).all())
    ms = (time.perf_counter() - t0) * 1e3
    table.save(after)
    a, b = read_table_file(before), read_table_file(after)
    show = PS_DIM * 2          # adagrad: [emb, g2sum, show, click]
    served, occ = np.unique(np.concatenate([users, items]),
                            return_counts=True)
    at = np.searchsorted(a["key"], served)
    rise = b["v"][at, show] - a["v"][at, show]
    unchanged = bool(np.array_equal(a["key"], b["key"]) and np.array_equal(
        np.delete(a["v"], show, axis=1), np.delete(b["v"], show, axis=1)))
    others = np.ones(a.size, bool)
    others[at] = False
    out = dict(ids=int(users.size + items.size), distinct=int(served.size),
               forward_ms=ms, pull_ms=clock.pull_s * 1e3, save_s=save_s,
               logits_finite=finite,
               rows_and_state_unchanged=unchanged,
               show_rise_equals_occurrences=bool(np.array_equal(rise, occ)),
               other_shows_unchanged=bool(np.array_equal(
                   a["v"][others, show], b["v"][others, show])))
    if not (finite and unchanged and out["show_rise_equals_occurrences"]
            and out["other_shows_unchanged"]):
        emit("ps_ctr_training", part="e", **out)
        raise AssertionError("ps_ctr_training (e): serving changed a row or "
                             "its shows did not rise as its pulls")
    return out


def _ctr_network(servers, path, batches, state, device, local,
                 local_replays: bool, gates: dict) -> dict:
    """(d): the lookup run over a PsClient of two PsServer processes, each
    loaded with the table file ``path`` (the touched keys' rows; a key is
    only ever asked of its owner): sync, then through an async
    Communicator from the same rows, flushed."""
    import numpy as np
    import torch

    from paddle_tpu_torch.distributed.ps import Communicator, PsClient

    procs, endpoints = servers
    client = PsClient(endpoints, PS_DIM)
    out = dict(servers=len(procs))
    try:
        for s in range(len(procs)):
            os.symlink(path, f"{path}.shard{s}")
        t0 = time.perf_counter()
        client.load(path)
        out["load_s"] = time.perf_counter() - t0
        sync = _ctr_run(path, batches, state, device, torch.float32,
                        table=client, timed=True)
        equal = bool(sync["losses"] == local["losses"]
                     and np.array_equal(sync["rows"], local["rows"]))
        rows_err = _rel_l2(sync["rows"], local["rows"])
        out["sync"] = dict(step_ms=sync["step_ms"],
                           step_ms_range=sync["step_ms_range"],
                           pull_ms=sync.get("pull_ms"),
                           push_ms=sync.get("push_ms"),
                           losses=[sync["losses"][0], sync["losses"][-1]],
                           bit_equal_to_local=equal,
                           rows_rel_diff_to_local=rows_err)
        del sync
        if (local_replays and not equal) or rows_err > gates["rows"]:
            emit("ps_ctr_training", part="d", **out)
            raise AssertionError("ps_ctr_training (d): the sync run over "
                                 "the servers differs from the local run")
        client.load(path)
        comm = Communicator(client, mode="async")

        class Async:
            embed_dim = PS_DIM
            pull = staticmethod(comm.pull)
            push = staticmethod(comm.push)

        run = _ctr_run(path, batches, state, device, torch.float32,
                       table=Async(), timed=True)
        t0 = time.perf_counter()
        comm.flush()
        flush_ms = (time.perf_counter() - t0) * 1e3
        comm.stop()
        rows = client.pull(run["keys"])
        out["async"] = dict(step_ms=run["step_ms"],
                            step_ms_range=run["step_ms_range"],
                            flush_ms=flush_ms,
                            losses=[run["losses"][0], run["losses"][-1]],
                            rows_rel_diff_to_sync_local=_rel_l2(
                                rows, local["rows"]))
        if not (np.isfinite(rows).all()
                and run["losses"][-1] < run["losses"][0]):
            emit("ps_ctr_training", part="d", **out)
            raise AssertionError("ps_ctr_training (d): the async run's "
                                 "rows are not finite or its loss did not "
                                 "fall")
    finally:
        client.stop_servers()
        client.close()
        _reap(procs)
    return out


def _reap(procs, timeout: float = 30.0) -> None:
    """Wait up to ``timeout`` s for each server process to exit after its
    STOP, then kill what is left."""
    import subprocess as sp

    for p in procs:
        try:
            p.wait(timeout=timeout)
        except sp.TimeoutExpired:
            p.kill()
            p.wait(timeout=10)


def _graph_build(num_nodes: int, num_edges: int, seed: int):
    """tools/graph_bench.py build_graph: uniform sources, squared-uniform
    destinations; ``(graph, src, dst, build seconds)``."""
    import numpy as np

    from paddle_tpu_torch.distributed.ps.graph import GraphTable

    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_nodes, num_edges, dtype=np.int64)
    dst = (rng.random(num_edges) ** 2 * num_nodes).astype(np.int64)
    g = GraphTable()
    t0 = time.perf_counter()
    g.add_edges(src, dst)
    g.build()
    return g, src, dst, time.perf_counter() - t0


def _graph_rates(store, ids, iters: int, keep=None):
    """graph_bench's neighbour-sampling and walk rates: ``(samples/s,
    hops/s, [sample results], [walks])`` over ``iters`` batches each."""
    import numpy as np

    rng = np.random.default_rng(1)
    batches = [rng.choice(ids, GRAPH_BATCH) for _ in range(iters)]
    store.sample_neighbors(batches[0], GRAPH_SAMPLE)
    t0 = time.perf_counter()
    samples = [store.sample_neighbors(b, GRAPH_SAMPLE) for b in batches]
    s_rate = GRAPH_BATCH * GRAPH_SAMPLE * iters / (time.perf_counter() - t0)
    rng = np.random.default_rng(2)
    batches = [rng.choice(ids, GRAPH_BATCH) for _ in range(iters)]
    store.random_walk(batches[0], GRAPH_WALK, seed=0)
    t0 = time.perf_counter()
    walks = [store.random_walk(b, GRAPH_WALK, seed=i)
             for i, b in enumerate(batches)]
    w_rate = GRAPH_BATCH * GRAPH_WALK * iters / (time.perf_counter() - t0)
    return s_rate, w_rate, samples, walks


def _skipgram_loss(e, c, x, negs):
    """bench_overlap's skip-gram loss (softplus of the positive and the
    negative dot products)."""
    import torch
    import torch.nn.functional as F

    ce, xe, ne = e[c], e[x], e[negs]
    pos = torch.sum(ce * xe, -1)
    neg = torch.einsum("bd,bkd->bk", ce, ne)
    return torch.mean(F.softplus(-pos)) + torch.mean(F.softplus(neg))


def _dw_batches(g, steps: int, batch: int):
    from paddle_tpu_torch.distributed.ps.graph import GraphDataGenerator

    gen = GraphDataGenerator(g, batch_size=batch, walk_len=8, window=2,
                             num_neg=4, seed=0)
    count = 0
    while count < steps:
        produced = False
        for b in gen:
            produced = True
            yield b
            count += 1
            if count >= steps:
                return
        if not produced:
            raise RuntimeError("graph too small for one DeepWalk batch")


def _dw_train(emb, batches, device) -> list:
    """The dense skip-gram step on ``emb`` (a leaf requiring grad, updated
    in place: ``emb - lr * grad``) over ``batches``; the losses (on the
    device)."""
    import torch

    losses = []
    for c, x, negs in batches:
        ids = [torch.as_tensor(a, device=device) for a in (c, x, negs)]
        loss = _skipgram_loss(emb, *ids)
        (grad,) = torch.autograd.grad(loss, emb)
        with torch.no_grad():
            emb.sub_(DW_LR * grad)
        losses.append(loss.detach())
    return losses


def _dw_reference(e0, touched, batches, dtype):
    """The same steps on the CPU in ``dtype`` over the touched rows only
    (the other rows get no gradient): ``(rows after, losses)``."""
    import numpy as np
    import torch

    sub = torch.tensor(e0, dtype=dtype)
    losses = []
    for c, x, negs in batches:
        flat = np.concatenate([c, x, negs.reshape(-1)])
        uniq, inv = np.unique(np.searchsorted(touched, flat),
                              return_inverse=True)
        rows = sub[torch.as_tensor(uniq)].clone().requires_grad_(True)
        inv = torch.as_tensor(inv)
        n = c.size
        loss = _skipgram_loss(rows, inv[:n], inv[n:2 * n],
                              inv[2 * n:].reshape(negs.shape))
        (grad,) = torch.autograd.grad(loss, rows)
        with torch.no_grad():
            sub[torch.as_tensor(uniq)] = rows - DW_LR * grad
        losses.append(float(loss.detach()))
    return sub.numpy(), losses


def phase_graph_training(seed: int, device: str = "cuda", edges=None,
                         iters=None, steps=None, dw_batch=None) -> dict:
    """tools/graph_bench.py's regime at its defaults: (a) build_graph(1M
    nodes, 10M edges) on a single host (edges/s), neighbour samples/s and
    walk hops/s at batch 4096, sample size 10, walk length 20, then the
    same over two graph-shard server processes with every sample and walk
    equal to the single host's; (b) bench_overlap's DeepWalk skip-gram
    step on an embedding [N, 64] on the card, 30 steps sequential and
    overlapped with a producer thread (seconds, speed-up), each held to
    the CPU's float64 run against float32's own error, the overlapped run
    to the sequential one, falling loss; (c) 64-wide node features,
    khop_sampler_from_store from 1024 seeds at fan-outs (25, 10),
    reindex_graph against its first hop, two hops of send_u_recv (sum,
    mean, max) on the card against the CPU (max bit-equal), ms a hop.
    ``device="cpu"`` with small ``edges``, ``iters``, ``steps`` and
    ``dw_batch`` gives a dry run."""
    import queue
    import statistics
    import threading

    import numpy as np
    import torch

    from paddle_tpu_torch import geometric as G
    from paddle_tpu_torch.distributed.ps.graph import (DistGraphClient,
                                                       launch_graph_servers)
    from paddle_tpu_torch.kernels import flash_attention as fa

    cuda = device != "cpu"
    edges, iters = edges or GRAPH_EDGES, iters or GRAPH_ITERS
    steps, dw_batch = steps or DW_STEPS, dw_batch or DW_BATCH
    nodes = max(edges // 10, 1000)
    out = dict(path=GRAPH_PATH, host=_host_info(), card=nvidia_smi_line(),
               leftover_gib_at_start=_check_freed("graph_training")
               if cuda else None)
    fa.reset_launch_counts()
    t_phase = time.perf_counter()
    out["native"] = _native_built()
    servers = _in_background(launch_graph_servers, 2)
    # (a) the graph, single host then two shards
    g, src, dst, build_s = _graph_build(nodes, edges, 0)
    ids = g.node_ids()
    s_rate, w_rate, samples, walks = _graph_rates(g, ids, iters)
    single = dict(build_edges_per_s=edges / build_s,
                  neighbor_samples_per_s=s_rate, walk_hops_per_s=w_rate)
    procs, endpoints = servers.join()
    client = None
    try:
        client = DistGraphClient(endpoints)
        t0 = time.perf_counter()
        client.add_edges(src, dst)
        client.build()
        shard_build_s = time.perf_counter() - t0
        iters2 = max(iters // 2, 5)
        # the single host's node list, so both draw the same batches
        s2, w2, samples2, walks2 = _graph_rates(client, ids, iters2)
        equal = (np.array_equal(client.node_ids(), np.sort(ids)) and all(
            np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
            for a, b in zip(samples2, samples)) and all(
            np.array_equal(a, b) for a, b in zip(walks2, walks)))
    finally:
        try:
            if client is not None:
                client.stop_servers()
                client.close()
            _reap(procs)
        finally:
            servers.release()
    out["graph"] = dict(
        nodes=nodes, edges=edges, nodes_with_edges=int(ids.size),
        batch=GRAPH_BATCH, sample_size=GRAPH_SAMPLE, walk_len=GRAPH_WALK,
        iters=iters, single_host=single,
        two_shard=dict(build_edges_per_s=edges / shard_build_s,
                       neighbor_samples_per_s=s2, walk_hops_per_s=w2,
                       iters=iters2, equal_to_single_host=bool(equal)))
    del samples, walks, samples2, walks2, src, dst
    if not equal:
        emit("graph_training", **out)
        raise AssertionError("graph_training (a): samples or walks over the "
                             "two shards differ from the single host's")
    # (b) DeepWalk on the card
    n = int(ids.max()) + 1
    gen = torch.Generator(device=device).manual_seed(seed)
    e0 = torch.randn((n, DW_DIM), generator=gen, device=device) * 0.1
    m = min(n, 4096)
    warm = e0[:m].clone().requires_grad_(True)   # cuBLAS, the allocator
    rng = np.random.default_rng(seed)
    _dw_train(warm, [tuple(rng.integers(0, m, s) for s in
                           ((dw_batch,), (dw_batch,), (dw_batch, 4)))],
              device)
    del warm
    if cuda:
        torch.cuda.synchronize()
    emb = e0.clone().requires_grad_(True)
    t0 = time.perf_counter()
    pending = list(_dw_batches(g, steps, dw_batch))
    seq_losses = _dw_train(emb, pending, device)
    if cuda:
        torch.cuda.synchronize()
    t_seq = time.perf_counter() - t0
    emb_ovl = e0.clone().requires_grad_(True)
    q: queue.Queue = queue.Queue(maxsize=4)

    def producer():
        for b in _dw_batches(g, steps, dw_batch):
            q.put(b)
        q.put(None)

    t0 = time.perf_counter()
    th = threading.Thread(target=producer, daemon=True)
    th.start()
    ovl_losses = _dw_train(emb_ovl, iter(q.get, None), device)
    if cuda:
        torch.cuda.synchronize()
    th.join()
    t_ovl = time.perf_counter() - t0
    with torch.no_grad():   # the first batch's loss after training
        after = float(_skipgram_loss(emb, *(
            torch.as_tensor(a, device=device) for a in pending[0])))
    touched = np.unique(np.concatenate([np.concatenate(
        [c, x, negs.reshape(-1)]) for c, x, negs in pending]))
    tt = torch.as_tensor(touched, device=device)
    e0_rows = e0[tt].cpu().numpy()
    seq_rows = emb.detach()[tt].cpu().numpy()
    ovl_rows = emb_ovl.detach()[tt].cpu().numpy()
    seq_l = [float(x) for x in torch.stack(seq_losses).cpu()]
    ovl_l = [float(x) for x in torch.stack(ovl_losses).cpu()]
    del emb, emb_ovl, e0, tt
    t0 = time.perf_counter()
    ref_rows, ref_l = _dw_reference(e0_rows, touched, pending,
                                    torch.float64)
    f32_rows, f32_l = _dw_reference(e0_rows, touched, pending,
                                    torch.float32)
    ref_s = time.perf_counter() - t0

    def readings(rows, losses):
        lr = np.asarray(ref_l)
        return dict(loss_rel_err=float(np.max(np.abs(np.asarray(losses) - lr)
                                              / np.abs(lr))),
                    emb_err=float(np.linalg.norm(rows - ref_rows)
                                  / np.linalg.norm(ref_rows - e0_rows)))

    floor = readings(f32_rows, f32_l)
    gates = dict(loss=max(YARD_FACTOR * floor["loss_rel_err"],
                          DW_FLOORS["loss"]),
                 emb=max(YARD_FACTOR * floor["emb_err"], DW_FLOORS["emb"]))
    seq, ovl = readings(seq_rows, seq_l), readings(ovl_rows, ovl_l)
    ovl_vs_seq = float(np.linalg.norm(ovl_rows - seq_rows)
                       / np.linalg.norm(seq_rows - e0_rows))
    out["deepwalk"] = dict(
        embedding=[n, DW_DIM], batch=dw_batch, steps=steps, lr=DW_LR,
        touched_rows=int(touched.size), sequential_s=t_seq,
        overlapped_s=t_ovl, speedup=t_seq / t_ovl,
        losses=[seq_l[0], seq_l[-1]], first_batch_loss_after=after,
        cpu_reference_s=ref_s, gates=gates,
        cpu_float32=floor, sequential=seq, overlapped=ovl,
        overlapped_vs_sequential=ovl_vs_seq,
        overlapped_bit_equal=bool(np.array_equal(ovl_rows, seq_rows)))
    ok = all(r["loss_rel_err"] <= gates["loss"] and r["emb_err"]
             <= gates["emb"] for r in (seq, ovl)) and \
        ovl_vs_seq <= gates["emb"] and after < seq_l[0]
    del seq_rows, ovl_rows, ref_rows, f32_rows, e0_rows, pending
    if not ok:
        emit("graph_training", **out)
        raise AssertionError("graph_training (b): DeepWalk on the card off "
                             "its gates, or the first batch's loss did not "
                             "fall")
    # (c) message passing over a khop minibatch
    rng = np.random.default_rng(seed + 1)
    t0 = time.perf_counter()
    g.set_features(ids, rng.standard_normal((ids.size, KHOP_DIM),
                                            dtype=np.float32))
    feat_s = time.perf_counter() - t0
    seeds = rng.choice(ids, KHOP_SEEDS, replace=False)
    t0 = time.perf_counter()
    es, ed, idx, feats = G.khop_sampler_from_store(
        g, seeds, KHOP_SIZES, seed=seed, with_features=True)
    khop_s = time.perf_counter() - t0
    nb, cnt = g.sample_neighbors(seeds, KHOP_SIZES[0], seed=seed)
    rs, rd, rn = G.reindex_graph(seeds, nb[nb >= 0], cnt)
    reindex_ok = bool(np.array_equal(rs, es[:rs.size])
                      and np.array_equal(rd, ed[:rd.size])
                      and np.array_equal(rn, idx[:rn.size]))
    x_dev = torch.as_tensor(feats, device=device)
    s_dev, d_dev = (torch.as_tensor(a, device=device) for a in (es, ed))
    x_cpu, s_cpu, d_cpu = (torch.as_tensor(a) for a in (feats, es, ed))
    mp = dict(seeds=KHOP_SEEDS, fanouts=list(KHOP_SIZES),
              subgraph_nodes=int(idx.size), subgraph_edges=int(es.size),
              feature_dim=KHOP_DIM, set_features_s=feat_s, khop_s=khop_s,
              reindex_equal_to_first_hop=reindex_ok, ops={})
    ok = reindex_ok
    for op in ("sum", "mean", "max"):
        def hops(x, s, d):
            h = G.send_u_recv(x, s, d, op, out_size=idx.size)
            return G.send_u_recv(h, s, d, op, out_size=idx.size)

        got = hops(x_dev, s_dev, d_dev).cpu().numpy()
        want = hops(x_cpu, s_cpu, d_cpu).numpy()
        err = float(np.max(np.abs(got - want)))
        scale = float(np.max(np.abs(want)))
        hop_ms = (cuda_ms(lambda: G.send_u_recv(x_dev, s_dev, d_dev, op,
                                                out_size=idx.size))
                  if cuda else None)
        exact = bool(np.array_equal(got, want))
        good = exact if op == "max" else err <= MP_RTOL * max(scale, 1.0)
        mp["ops"][op] = dict(max_abs_err=err, max_abs=scale,
                             bit_equal=exact, hop_ms=hop_ms, ok=good)
        ok = ok and good
    out["message_passing"] = mp
    del x_dev, s_dev, d_dev, g
    out["flash_launches"] = _flash_idle(fa, "graph_training")
    out["seconds"] = time.perf_counter() - t_phase
    if cuda:
        _free()
    emit("graph_training", **out)
    if not ok:
        raise AssertionError("graph_training (c): message passing on the "
                             "card differs from the CPU, or reindex_graph "
                             "from the khop sampler's first hop")
    return out


# --------------------------------------------------------------------------
# the fit loop: Model.fit with the DataLoader, device prefetch, callbacks,
# crash-safe checkpoints and the training supervisor
# --------------------------------------------------------------------------

# bench.py bench_gpt_primary (bench.py:374-378): GPT h1024, 24 layers, 16
# heads of 64, vocab 50304, batch 8 x 1024, bf16 O2 AdamW(1e-4, wd 0.01),
# chunked loss of 256, no recompute, dropout 0
HF_BATCH, HF_SEQ = 8, 1024
HF_STEPS = TRAIN_WARMUP + TRAIN_TIMED    # the timed fit's batches
HF_WORKERS, HF_PREFETCH = 2, 2
HF_PROBE_STEPS = 8                       # bench.py's prefetch probe
HF_RESUME_BATCHES, HF_KILL_AFTER = 12, 6
HF_SAVE_INTERVAL, HF_KEEP_MAX = 4, 2
HF_POISON_AFTER = 5                      # train.data drops batches 5 and 6
# the fit loop's cost over a bare step: rounds alternating which side runs
# first, each side warm-up + timed steps a round, both timed alike
# two rounds, one of each order: the whole smoke's 1200 s allow no more
HF_OVH_ROUNDS, HF_OVH_WARMUP, HF_OVH_TIMED = 2, 3, 16
HF_PATH = "training (GPT-350M bf16 O2 step through Model.fit)"
# the fit's attention: bf16 at D = 64, one forward (no recompute), dQ and
# dK/dV a layer
HF_NEED = dict(fwd_wgmma=24, dq_wgmma=24, dkv_wgmma=24)
HF_FWD_CASE = "primary_bf16_B8_L1024"
HF_BWD_CASE = "d64_causal_bfloat16_B8_L1024"
# BERT-base through Model.fit(train, eval): ragged rows in two buckets and a
# padded tail batch
HB_BATCH, HB_TRAIN, HB_EVAL, HB_EPOCHS = 32, 138, 70, 3
HB_BUCKETS = (64, 128)
# EarlyStopping on the eval loss with no patience and a margin no epoch of
# this run can gain (on random labels the eval loss stays near ln 2 = 0.69
# or above, so an epoch would have to start above 1.69): the second
# evaluation stops the fit, one epoch short of HB_EPOCHS
HB_STOP_DELTA = 1.0


def _primary_config(**overrides):
    """bench.py bench_gpt_primary's GPT (see HF_BATCH)."""
    from paddle_tpu_torch.models.gpt import GPTConfig

    cfg = dict(vocab_size=50304, hidden_size=1024, num_layers=24,
               num_heads=16, max_position_embeddings=HF_SEQ,
               hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
               use_recompute=False, use_flash_attention=True,
               loss_chunk=256, dtype="bfloat16")
    cfg.update(overrides)
    return GPTConfig(**cfg)


def _primary_net(cfg, seed: int, device: str = "cuda", bind: bool = False):
    """A seeded GPT under bf16 O2 with the bench's AdamW; the global seed
    (the step's base seed) is reset too, so two builds train alike. With
    ``bind`` the optimizer is bound to the model (``parameters=net``), for
    the stateful ``opt.step()`` of the dygraph loop."""
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.framework import random as framework_random
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    framework_random.seed(seed)
    net = GPTForCausalLM(cfg, device=device, generator=torch.Generator(
        device=device).manual_seed(seed)).train()
    return amp.decorate(net, AdamW(learning_rate=1e-4, weight_decay=0.01,
                                   parameters=net if bind else None),
                        level="O2", dtype="bfloat16")


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _dir_bytes(path: str) -> int:
    import os

    if os.path.isfile(path):
        return os.path.getsize(path)
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def _ckpt_timing(records: list):
    """A context that times each checkpoint save (``AutoCheckpoint.save``,
    with its bytes), each supervisor restore and each load, and each crc
    pass (``validate_checkpoint``) into ``records``."""
    import contextlib

    from paddle_tpu_torch.distributed import checkpoint as ck
    from paddle_tpu_torch.framework import supervisor as sv

    @contextlib.contextmanager
    def ctx():
        orig = (ck.AutoCheckpoint.save, ck.load_state, ck.validate_checkpoint,
                sv.TrainingSupervisor.restore)

        def timed(kind, fn, path_of=None):
            def run(*args, **kwargs):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                rec = dict(kind=kind(args, kwargs) if callable(kind)
                           else kind, s=time.perf_counter() - t0)
                if path_of is not None:
                    path = path_of(args, kwargs)
                    rec.update(path=path, bytes=_dir_bytes(path))
                records.append(rec)
                return out
            return run

        def pass_kind(args, kwargs):
            crc = kwargs.get("checksums", args[1] if len(args) > 1 else True)
            return "crc_pass" if crc else "stat_pass"

        ck.AutoCheckpoint.save = timed(
            "save", orig[0], lambda a, k: f"{a[0].root}/step_{a[1]}")
        ck.load_state = timed("load", orig[1], lambda a, k: a[0])
        ck.validate_checkpoint = timed(pass_kind, orig[2],
                                       lambda a, k: a[0])
        sv.TrainingSupervisor.restore = timed("restore", orig[3])
        try:
            yield records
        finally:
            (ck.AutoCheckpoint.save, ck.load_state, ck.validate_checkpoint,
             sv.TrainingSupervisor.restore) = orig

    return ctx()


def _fit_clock(fa):
    """A callback recording, per train batch, the host time at its end
    (``train_batch`` reads the loss back, so the step is done), the loss
    and the flash launches; and the time of the epoch-end and train-end
    hooks after it (the ModelCheckpoint saves before them)."""
    from paddle_tpu_torch.hapi import Callback

    class Clock(Callback):
        def __init__(self):
            super().__init__()
            self.ends, self.losses, self.launches, self.marks = [], [], [], {}

        def on_train_begin(self, logs=None):
            self.marks["train_begin"] = time.perf_counter()

        def on_train_batch_begin(self, step, logs=None):
            self._before = _counts(fa) if fa is not None else None

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(float(logs["loss"]))
            self.ends.append(time.perf_counter())
            if fa is not None:
                self.launches.append(tuple(
                    a - b for a, b in zip(_counts(fa), self._before)))

        def on_epoch_end(self, epoch, logs=None):
            self.marks["epoch_end"] = time.perf_counter()

        def on_train_end(self, logs=None):
            self.marks["train_end"] = time.perf_counter()

        def step_ms(self):
            starts = [self.marks["train_begin"]] + self.ends[:-1]
            return [(b - a) * 1e3 for a, b in zip(starts, self.ends)]

    return Clock()


def _bits_equal(a, b) -> bool:
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        a, b = a.contiguous().view(torch.uint8), b.contiguous().view(
            torch.uint8)
    return torch.equal(a, b)


def _host_params(model) -> dict:
    return {k: v.detach().to("cpu", copy=True)
            for k, v in model._train_step.params.items()}


def _hf_timed_fit(cfg, ids, seed, tmp, device, fa):
    """(a): Model.fit over the seeded batches with workers, the device
    prefetch and ModelCheckpoint at epoch end; then the saved ``final``
    loaded into a fresh model must give the trained model's eval loss."""
    import os

    import numpy as np
    import torch

    from paddle_tpu_torch.hapi import Model, ModelCheckpoint
    from paddle_tpu_torch.io import TensorDataset

    net, opt = _primary_net(cfg, seed, device)
    model = Model(net, labels=[])
    model.prepare(opt)
    clock = _fit_clock(fa)
    save_dir = os.path.join(tmp, "model_checkpoint")
    if fa is not None:
        fa.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
    hist = model.fit(TensorDataset([ids, ids]), batch_size=HF_BATCH,
                     epochs=1, shuffle=False, num_workers=HF_WORKERS,
                     prefetch_depth=HF_PREFETCH, verbose=0,
                     callbacks=[ModelCheckpoint(save_dir=save_dir), clock])
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if fa is not None else None)
    launches = _counts(fa) if fa is not None else None
    # ModelCheckpoint saves "0" at the epoch's end and "final" at the
    # fit's, each hook just before the clock's
    saves = {name: dict(bytes=sum(_dir_bytes(os.path.join(save_dir,
                                                          name + ext))
                                  for ext in (".pdparams", ".pdopt")),
                        s=t) for name, t in (
        ("0", clock.marks["epoch_end"] - clock.ends[-1]),
        ("final", clock.marks["train_end"] - clock.marks["epoch_end"]))}
    batch0 = (ids[:HF_BATCH], ids[:HF_BATCH])
    trained_loss = model.predict_batch(batch0)
    del model, net, opt
    _free()
    # a fresh model (other weights) loads the trained ``final``
    fresh, _ = _primary_net(cfg, seed + 1, device)
    m2 = Model(fresh, labels=[])
    m2.prepare()
    t0 = time.perf_counter()
    m2.load(os.path.join(save_dir, "final"))
    _sync(device)
    load_s = time.perf_counter() - t0
    loaded_loss = m2.predict_batch(batch0)
    if np.asarray(loaded_loss).tobytes() != np.asarray(trained_loss).tobytes():
        raise AssertionError(f"hapi_gpt_fit: Model.load of final gives eval "
                             f"loss {loaded_loss}, the trained model "
                             f"{trained_loss}")
    del m2, fresh
    _free()
    return dict(losses=clock.losses, step_ms=clock.step_ms(),
                history_loss=hist["loss"], launches=launches,
                per_step=clock.launches, peak_mem_gib=peak,
                model_checkpoint=saves, eval_loss=float(trained_loss),
                load_final_s=load_s)


def _hf_bare_steps(cfg, ids, seed, device):
    """The same batches, in the same order, through a bare TrainStep from
    the same seed; then bench.py's prefetch probe: fresh host batches
    streamed through prefetch_to_device, each held against its host array
    after the step that read it (the comparison queued behind the step on
    the same stream)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.framework.jit import TrainStep
    from paddle_tpu_torch.io import prefetch_to_device

    net, opt = _primary_net(cfg, seed, device)
    step = TrainStep(net, opt, loss_fn=None)
    losses, step_ms = [], []
    for k in range(HF_STEPS):
        b = ids[k * HF_BATCH:(k + 1) * HF_BATCH]
        _sync(device)
        t0 = time.perf_counter()
        losses.append(float(step((b, b))))
        _sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
    rng = np.random.default_rng(seed + 5)
    hosts = [rng.integers(0, cfg.vocab_size, (HF_BATCH, HF_SEQ)).astype(
        np.int32) for _ in range(HF_PROBE_STEPS)]
    refs = [torch.as_tensor(h, device=device) for h in hosts]
    pf = prefetch_to_device(((np.array(h), np.array(h)) for h in hosts),
                            depth=HF_PREFETCH, device=device)
    same = []
    for k, b in enumerate(pf):
        loss = step(b)
        same.append((b[0] == refs[k]).all() & (b[1] == refs[k]).all())
    float(loss)
    stats = pf.stats()
    pf.close()
    same = [bool(s) for s in same]
    if len(same) != HF_PROBE_STEPS or not all(same):
        raise AssertionError(f"hapi_gpt_fit: prefetched batches equal to "
                             f"their host arrays: {same}")
    probe = dict(compile_count=step.cache_stats()["compiles"],
                 step_calls=step.cache_stats()["calls"],
                 input_stall_s=stats["consumer_stall_s"],
                 input_stall_per_step_ms=stats["consumer_stall_s"]
                 / max(stats["batches"], 1) * 1e3,
                 prefetch_batches=stats["batches"],
                 producer_busy_s=stats["producer_busy_s"],
                 batches_equal_host=same)
    del step, net, opt
    _free()
    return losses, step_ms, probe


def _hf_fit_overhead(cfg, seed, device) -> dict:
    """The fit loop's cost over a bare TrainStep, in HF_OVH_ROUNDS rounds
    that alternate which side runs first. Each side takes HF_OVH_WARMUP +
    HF_OVH_TIMED + 1 steps a round and is timed the same way: the device
    synchronised at each step's end, a step the host time from one end to
    the next. The fit side is ``Model.fit`` with the workers and the
    device prefetch; the bare side calls a TrainStep of a second model from
    the same seed on the same host arrays."""
    import numpy as np

    from paddle_tpu_torch.framework.jit import TrainStep
    from paddle_tpu_torch.hapi import Callback, Model
    from paddle_tpu_torch.io import TensorDataset

    n = HF_OVH_WARMUP + HF_OVH_TIMED + 1
    ids = np.random.default_rng(seed + 9).integers(
        0, cfg.vocab_size, (n * HF_BATCH, HF_SEQ)).astype(np.int32)
    net, opt = _primary_net(cfg, seed, device)
    model = Model(net, labels=[])
    model.prepare(opt)
    bnet, bopt = _primary_net(cfg, seed, device)
    bare = TrainStep(bnet, bopt, loss_fn=None)

    class Ends(Callback):
        def __init__(self):
            super().__init__()
            self.ends = []

        def on_train_batch_end(self, step, logs=None):
            _sync(device)
            self.ends.append(time.perf_counter())

    def run_fit():
        clock = Ends()
        model.fit(TensorDataset([ids, ids]), batch_size=HF_BATCH, epochs=1,
                  shuffle=False, num_workers=HF_WORKERS,
                  prefetch_depth=HF_PREFETCH, verbose=0, callbacks=[clock])
        return clock.ends

    def run_bare():
        ends = []
        for k in range(n):
            b = ids[k * HF_BATCH:(k + 1) * HF_BATCH]
            bare((b, b))
            _sync(device)
            ends.append(time.perf_counter())
        return ends

    def timed(ends):
        return [(b - a) * 1e3 for a, b in zip(ends, ends[1:])][-HF_OVH_TIMED:]

    fit_ms, bare_ms, rounds = [], [], []
    for r in range(HF_OVH_ROUNDS):
        order = ("fit", "bare") if r % 2 == 0 else ("bare", "fit")
        got = {}
        for side in order:
            got[side] = timed(run_fit() if side == "fit" else run_bare())
        fit_ms += got["fit"]
        bare_ms += got["bare"]
        rounds.append(dict(first=order[0],
                           fit_median_ms=float(np.median(got["fit"])),
                           bare_median_ms=float(np.median(got["bare"])),
                           diff_ms=float(np.median(got["fit"])
                                         - np.median(got["bare"]))))
    del model, net, opt, bare, bnet, bopt
    _free()
    diffs = [x["diff_ms"] for x in rounds]

    def spread(xs):
        return dict(median=float(np.median(xs)),
                    p25=float(np.percentile(xs, 25)),
                    p75=float(np.percentile(xs, 75)),
                    min=float(min(xs)), max=float(max(xs)), n=len(xs))

    return dict(rounds=rounds, fit_ms=spread(fit_ms), bare_ms=spread(bare_ms),
                round_diff_ms=spread(diffs),
                overhead_ms=float(np.median(fit_ms) - np.median(bare_ms)),
                overhead_pct=float((np.median(fit_ms) / np.median(bare_ms)
                                    - 1) * 100))


def _hf_supervised(cfg, ids, seed, ckdir, device, callbacks=(), plan=None,
                   **policy):
    """Model.fit(recovery=...) over the HF_RESUME_BATCHES batches; returns
    the final parameters on the host and what the fit raised, if it was
    preempted."""
    import warnings

    from paddle_tpu_torch.framework.supervisor import (RecoveryPolicy,
                                                       TrainingPreempted)
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.io import TensorDataset

    net, opt = _primary_net(cfg, seed, device)
    model = Model(net, labels=[])
    model.prepare(opt)
    preempted = None
    pol = dict(checkpoint_dir=ckdir, save_interval_steps=HF_SAVE_INTERVAL,
               keep_max=HF_KEEP_MAX, async_save=False)
    pol.update(policy)
    if plan is not None:
        plan.install()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            model.fit(TensorDataset([ids, ids]), batch_size=HF_BATCH,
                      epochs=1, shuffle=False, num_workers=HF_WORKERS,
                      verbose=0, callbacks=list(callbacks),
                      recovery=RecoveryPolicy(**pol))
    except TrainingPreempted as e:
        preempted = e
    finally:
        if plan is not None:
            plan.uninstall()
    params = _host_params(model)
    count = model._train_step._count
    del model, net, opt
    _free()
    return params, preempted, count


def _hf_recovery(cfg, ids, seed, tmp, device) -> dict:
    """(b) SIGTERM resume and (c) rollback, each against an uninterrupted
    fit of the same batches, bit for bit."""
    import os
    import shutil
    import signal

    from paddle_tpu_torch.distributed.resilience import FaultPlan
    from paddle_tpu_torch.hapi import Callback

    class KillAfter(Callback):
        """SIGTERM to this process after the N-th batch (the real handler
        runs, as in tests/test_self_healing.py:259-275)."""

        def __init__(self, at):
            super().__init__()
            self.at, self.seen, self.preempted = at, 0, []

        def on_train_batch_end(self, step, logs=None):
            self.seen += 1
            if self.seen == self.at:
                os.kill(os.getpid(), signal.SIGTERM)

        def on_preemption(self, logs=None):
            self.preempted.append(logs)

    class Rollbacks(Callback):
        def __init__(self):
            super().__init__()
            self.events = []

        def on_rollback(self, logs=None):
            self.events.append(dict(rollbacks=logs["rollbacks"],
                                    cursor=logs["cursor"].as_state(),
                                    skip=logs["skip"]))

    def differing(a, b):
        return [k for k in a if not _bits_equal(a[k], b[k])]

    records, out = [], {}
    handler = signal.getsignal(signal.SIGTERM)
    with _ckpt_timing(records):
        d = os.path.join(tmp, "uninterrupted")
        t0 = time.perf_counter()
        ref, _, ref_count = _hf_supervised(
            cfg, ids, seed, d, device, save_interval_steps=10 ** 9)
        out["uninterrupted"] = dict(s=time.perf_counter() - t0,
                                    steps=ref_count)
        shutil.rmtree(d)
        # (b) SIGTERM after batch HF_KILL_AFTER, then a fresh model (other
        # weights) resumes from the same directory
        d = os.path.join(tmp, "sigterm")
        kill = KillAfter(HF_KILL_AFTER)
        _, pre, _ = _hf_supervised(cfg, ids, seed, d, device,
                                   callbacks=[kill])
        if pre is None or not pre.saved or not kill.preempted:
            raise AssertionError(f"hapi_gpt_fit: SIGTERM after batch "
                                 f"{HF_KILL_AFTER} gave {pre!r}, callbacks "
                                 f"{kill.preempted}")
        if signal.getsignal(signal.SIGTERM) != handler:
            raise AssertionError("hapi_gpt_fit: the SIGTERM handler was not "
                                 "restored after the supervised fit")
        kept = sorted(os.listdir(d))
        resumed, _, count = _hf_supervised(cfg, ids, seed + 7, d, device)
        bad = differing(ref, resumed)
        if bad or count != ref_count:
            raise AssertionError(f"hapi_gpt_fit: the SIGTERM-resumed fit "
                                 f"differs from the uninterrupted one in "
                                 f"{len(bad)} parameters ({bad[:3]}), steps "
                                 f"{count} / {ref_count}")
        out["sigterm"] = dict(preempted_at_step=pre.global_step,
                              saved=pre.saved, dirs_after_kill=kept,
                              resumed_steps=count, params_bit_equal=True)
        shutil.rmtree(d)
        # (c) train.data dropped at two consecutive batches: both skipped,
        # then a rollback to the last snapshot and a clean replay
        d = os.path.join(tmp, "rollback")
        plan = FaultPlan([{"site": "train.data", "kind": "drop", "times": 2,
                           "after": HF_POISON_AFTER}], seed=seed)
        rb = Rollbacks()
        rolled, _, count = _hf_supervised(cfg, ids, seed, d, device,
                                          callbacks=[rb], plan=plan,
                                          max_consecutive=2)
        bad = differing(ref, rolled)
        if plan.fired != [2] or len(rb.events) != 1 or bad \
                or count != ref_count:
            raise AssertionError(f"hapi_gpt_fit: rollback run: plan fired "
                                 f"{plan.fired}, rollbacks {rb.events}, "
                                 f"{len(bad)} parameters differ ({bad[:3]}),"
                                 f" steps {count} / {ref_count}")
        out["rollback"] = dict(poisoned_batches=[HF_POISON_AFTER,
                                                 HF_POISON_AFTER + 1],
                               rollbacks=len(rb.events), events=rb.events,
                               params_bit_equal=True)
        shutil.rmtree(d)
    out["checkpoint_io"] = records
    return out


def phase_hapi_gpt_fit(seed: int, device: str = "cuda", cfg=None) -> dict:
    """bench_gpt_primary's GPT-350M through the port's fit loop: (a) the
    timed Model.fit with workers, prefetch and ModelCheckpoint, against a
    bare TrainStep on the same batches, the prefetch probe, and the saved
    model reloaded; (b) a SIGTERM-resumed and (c) a rolled-back supervised
    fit, each bit-identical to an uninterrupted one."""
    import shutil
    import tempfile

    import numpy as np

    from paddle_tpu_torch.models.gpt import gpt_flops_per_token

    cuda = device == "cuda"
    fa = None
    if cuda:
        from paddle_tpu_torch.kernels import flash_attention as fa
    leftover = _check_freed("hapi_gpt_fit") if cuda else None
    cfg = cfg or _primary_config()
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (HF_STEPS * HF_BATCH, HF_SEQ)) \
        .astype(np.int32)
    tmp = tempfile.mkdtemp(prefix="hapi_gpt_fit-")
    try:
        disk_free_gib = shutil.disk_usage(tmp).free / 2 ** 30
        fit = _hf_timed_fit(cfg, ids, seed, tmp, device, fa)
        bare_losses, bare_ms, probe = _hf_bare_steps(cfg, ids, seed, device)
        overhead = _hf_fit_overhead(cfg, seed, device)
        if fit["losses"] != bare_losses:
            raise AssertionError(f"hapi_gpt_fit: Model.fit losses "
                                 f"{fit['losses']} differ from a bare "
                                 f"TrainStep's {bare_losses} on the same "
                                 f"batches")
        if not all(math.isfinite(x) for x in fit["losses"]) \
                or not fit["losses"][-1] < fit["losses"][0]:
            raise AssertionError(f"hapi_gpt_fit: losses {fit['losses']}: "
                                 f"not finite or not falling")
        if cuda:
            need = _need(**HF_NEED)
            if any(c != need for c in fit["per_step"]):
                raise AssertionError(
                    f"hapi_gpt_fit: launches per step {_COUNT_NAMES} "
                    f"{fit['per_step']}, expected {need} every step")
        recovery = _hf_recovery(
            cfg, ids[:HF_RESUME_BATCHES * HF_BATCH], seed, tmp, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    timed = fit["step_ms"][TRAIN_WARMUP:]
    tokens_per_s = HF_BATCH * HF_SEQ * TRAIN_TIMED / (sum(timed) / 1e3)
    flops = gpt_flops_per_token(cfg, HF_SEQ)
    bare_timed = bare_ms[TRAIN_WARMUP:]
    out = dict(model="bench_gpt_primary GPT-350M bf16 O2", path=HF_PATH,
               batch=[HF_BATCH, HF_SEQ], layers=cfg.num_layers,
               num_workers=HF_WORKERS, prefetch_depth=HF_PREFETCH,
               fit_losses=fit["losses"], bare_losses=bare_losses,
               losses_bit_equal=True, fit_step_ms=fit["step_ms"],
               fit_step_ms_median=float(np.median(timed)),
               bare_step_ms=bare_ms,
               bare_step_ms_median=float(np.median(bare_timed)),
               tokens_per_s=tokens_per_s,
               bare_tokens_per_s=HF_BATCH * HF_SEQ * TRAIN_TIMED
               / (sum(bare_timed) / 1e3),
               mfu=tokens_per_s * flops / PEAK_BF16_TC_FLOPS,
               flops_per_token=flops, prefetch_probe=probe,
               fit_overhead=overhead,
               launches=(dict(zip(_COUNT_NAMES, fit["launches"]))
                         if cuda else None),
               launches_per_step=dict(zip(_COUNT_NAMES, _need(**HF_NEED))),
               peak_mem_gib=fit["peak_mem_gib"],
               model_checkpoint=fit["model_checkpoint"],
               load_final_s=fit["load_final_s"],
               eval_loss_after_load_bit_equal=True,
               disk_free_gib=disk_free_gib, leftover_gib_at_start=leftover,
               **recovery, card=nvidia_smi_line() if cuda else device)
    emit("hapi_gpt_fit", **out)
    return out


def _hb_rows(seed: int, n: int, vocab: int):
    """``n`` seeded classification rows: ids of lengths BERT_MIN_LEN ..
    BERT_SEQ (no padding: the loader buckets them) and a label of 2."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lengths = rng.integers(BERT_MIN_LEN, BERT_SEQ + 1, n)
    return [(rng.integers(1, vocab, int(L)).astype(np.int64),
             np.int64(rng.integers(0, 2))) for L in lengths]


# --------------------------------------------------------------------------
# the dygraph front door: GPT-350M trained by loss.backward(), the ops, the
# eager tape
# --------------------------------------------------------------------------

# four steps, not six: the whole smoke passed 1100 s with six (1112.1 s on
# a slow host, the phase 16.3 s of it), and this phase's steps go first
EAGER_STEPS = 4
EAGER_PATH = ("training (GPT-350M bf16 O2 through the dygraph loop: "
              "to_tensor, loss.backward(), opt.step(), opt.clear_grad())")
# bf16 O2: the losses of the eager loop and TrainStep at the distributed
# tests' rtol; parameters (when not bit-equal) within what EAGER_STEPS
# AdamW steps of lr 1e-4 taken the other way could part them (2 lr a step)
# plus a bf16 ulp of a weight near 0.1
EAGER_LOSS_RTOL = 2e-2
EAGER_PARAM_ATOL = 2 * EAGER_STEPS * 1e-4 + 2 ** -10


def _eager_gpt_run(cfg, batches, seed, device, fa, eager_loop: bool):
    """EAGER_STEPS steps of a seeded bf16 O2 GPT on ``batches``: the dygraph
    loop (``loss = net(paddle.to_tensor(ids), ...)``, ``loss.backward()``,
    ``opt.step()``, ``opt.clear_grad()``, the optimizer bound to the
    model) or a TrainStep. Returns losses, step times, launches per step,
    attention calls, peak memory and the final parameters."""
    import numpy as np
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework.jit import TrainStep
    from paddle_tpu_torch.models import gpt as gpt_mod

    net, opt = _primary_net(cfg, seed, device, bind=eager_loop)
    step = None if eager_loop else TrainStep(net, opt, loss_fn=None)
    calls = [0]
    attend = gpt_mod.causal_attention

    def counted(*args, **kwargs):
        calls[0] += 1
        return attend(*args, **kwargs)

    cuda = device == "cuda"
    losses, ms, per_step = [], [], []
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
    gpt_mod.causal_attention = counted
    try:
        for ids in batches:
            before = _counts(fa) if cuda else None
            _sync(device)
            t0 = time.perf_counter()
            if eager_loop:
                x = paddle.to_tensor(ids)
                loss = net(x, x)
                loss.backward()
                opt.step()
                opt.clear_grad()
            else:
                loss = step((ids, ids))
            losses.append(float(loss.detach()))
            _sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
            if cuda:
                per_step.append(tuple(a - b for a, b in
                                      zip(_counts(fa), before)))
    finally:
        gpt_mod.causal_attention = attend
    if eager_loop and any(p.grad is not None for p in net.parameters()):
        raise AssertionError("eager_training: opt.clear_grad() left a "
                             "gradient")
    params = {k: p.detach().clone() for k, p in net.named_parameters()}
    out = dict(losses=losses, step_ms=ms,
               step_ms_median=float(np.median(ms[1:])), per_step=per_step,
               launches=_counts(fa) if cuda else None,
               attention_calls=calls[0],
               peak_mem_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                             if cuda else None))
    del net, opt, step
    _free() if cuda else gc.collect()
    return out, params


def _eager_ops_on_card(device: str) -> dict:
    """Every case of the ops' CPU parity table on ``device`` against the
    port's CPU result at the per-dtype tolerance (factorizations by their
    reconstructions), and every random op's seeded replay, range and
    moments on ``device``."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools"))
    import torch_op_cases as C

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import ops as P

    checked = 0
    try:
        for name, spec in C.CASES:
            args, kw = spec(C.G(name))
            if name in C.FACTORS:
                paddle.set_device(device)
                got = C.call_port_factors(name, args, kw, device)
                paddle.set_device("cpu")
                C.factors_check(name, args, got,
                                C.call_port_factors(name, args, kw, "cpu"))
            else:
                paddle.set_device(device)
                got = getattr(P, name)(*C.to_torch(args, device), **kw)
                paddle.set_device("cpu")
                want = getattr(P, name)(*C.to_torch(args, "cpu"), **kw)
                C.compare(got, want, f"{name} on {device}")
            checked += 1
        paddle.set_device(device)
        for name in C.RANDOM:
            C.check_random(name, device)
    finally:
        paddle.set_device(device)
    return dict(op_cases=checked, random_ops=len(C.RANDOM))


def _eager_tape_on_card(device: str) -> dict:
    """PyLayer, paddle.grad and a tensor hook on ``device`` tensors."""
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import eager

    class Cube(eager.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x * x

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor()
            return dy * 3 * x * x

    data = [0.5, -1.0, 2.0]
    x = paddle.to_tensor(data, stop_gradient=False)
    y = Cube.apply(x)
    seen = []
    y.register_hook(lambda g: (seen.append(g.numpy().copy()), g * 2)[1])
    (y * 3).sum().backward()
    want = torch.tensor([2 * 3 * 3 * v * v for v in data])
    if x.grad.device.type != torch.device(device).type or len(seen) != 1 \
            or not torch.allclose(x.grad.cpu(), want):
        raise AssertionError(f"eager_training: PyLayer and hook on "
                             f"{device}: grad {x.grad}, hook calls {seen}")
    z = paddle.to_tensor(data, stop_gradient=False)
    (gz,) = paddle.grad([(z * z).sum()], [z])
    if not torch.allclose(gz._data.cpu(),
                          torch.tensor([2 * v for v in data])) \
            or z.grad is not None:
        raise AssertionError(f"eager_training: paddle.grad on {device}: "
                             f"{gz}")
    return dict(pylayer_grad=x.grad.cpu().tolist(), hook_calls=len(seen),
                partial_grad=gz._data.cpu().tolist())


def phase_eager_training(seed: int, device: str = "cuda", cfg=None,
                         steps: int = EAGER_STEPS) -> dict:
    """The dygraph front door on the card: (a) bench_gpt_primary's
    GPT-350M trained by ``loss.backward()`` against TrainStep on the same
    seeded weights and batches (losses, parameters, the bf16 D = 64
    kernels' launches a step, no plain attention, the eager step's time
    against TrainStep's, peak memory); (b) the ops' parity table on the
    card against the port's CPU results, and the random ops' replay and
    moments there; (c) PyLayer, paddle.grad and a hook on card tensors."""
    import numpy as np
    import torch

    import paddle_tpu_torch as paddle

    t_start = time.perf_counter()
    cuda = device == "cuda"
    fa = None
    if cuda:
        from paddle_tpu_torch.kernels import flash_attention as fa
    leftover = _check_freed("eager_training") if cuda else None
    paddle.set_device(device)
    cfg = cfg or _primary_config()
    # one batch repeated, so that the losses fall within a few steps
    ids = np.random.default_rng(seed + 24).integers(
        0, cfg.vocab_size, (HF_BATCH, HF_SEQ))
    batches = [ids] * steps
    eager_run, eager_params = _eager_gpt_run(cfg, batches, seed, device, fa,
                                             eager_loop=True)
    step_run, step_params = _eager_gpt_run(cfg, batches, seed, device, fa,
                                           eager_loop=False)
    losses, ref = eager_run["losses"], step_run["losses"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
    bit_equal = losses == ref and all(
        torch.equal(eager_params[k], step_params[k]) for k in step_params)
    param_err = max(float((eager_params[k].float() - step_params[k].float())
                          .abs().max()) for k in step_params)
    del eager_params, step_params
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"eager_training: losses {losses}: not finite "
                             f"or not falling")
    if loss_err > EAGER_LOSS_RTOL or param_err > EAGER_PARAM_ATOL:
        raise AssertionError(
            f"eager_training: the dygraph loop against TrainStep: loss "
            f"rel err {loss_err} (limit {EAGER_LOSS_RTOL}), parameter abs "
            f"err {param_err} (limit {EAGER_PARAM_ATOL}); losses {losses} "
            f"vs {ref}")
    layers = cfg.num_layers
    for run in (eager_run, step_run):
        if run["attention_calls"] != layers * steps:
            raise AssertionError(f"eager_training: {run['attention_calls']}"
                                 f" attention calls in {steps} steps of "
                                 f"{layers} layers")
    if cuda:
        need = _need(fwd_wgmma=layers, dq_wgmma=layers, dkv_wgmma=layers)
        for label, run in (("eager", eager_run), ("TrainStep", step_run)):
            if any(c != need for c in run["per_step"]):
                raise AssertionError(
                    f"eager_training ({label}): launches per step "
                    f"{_COUNT_NAMES} {run['per_step']}, expected {need} "
                    f"every step")
    plain = eager_run["attention_calls"] - (
        dict(zip(_COUNT_NAMES, eager_run["launches"]))["fwd_wgmma"]
        if cuda else 0)
    ops = _eager_ops_on_card(device)
    tape = _eager_tape_on_card(device)
    seconds = time.perf_counter() - t_start
    out = dict(model="bench_gpt_primary GPT-350M bf16 O2", path=EAGER_PATH,
               batch=[HF_BATCH, HF_SEQ], layers=layers, steps=steps,
               eager_losses=losses, trainstep_losses=ref,
               losses_rel_err=loss_err, params_max_abs_err=param_err,
               bit_equal=bit_equal, loss_rtol=EAGER_LOSS_RTOL,
               param_atol=EAGER_PARAM_ATOL,
               eager_step_ms=eager_run["step_ms"],
               eager_step_ms_median=eager_run["step_ms_median"],
               trainstep_step_ms=step_run["step_ms"],
               trainstep_step_ms_median=step_run["step_ms_median"],
               eager_peak_mem_gib=eager_run["peak_mem_gib"],
               trainstep_peak_mem_gib=step_run["peak_mem_gib"],
               launches=(dict(zip(_COUNT_NAMES, eager_run["launches"]))
                         if cuda else None),
               launches_per_step=dict(zip(_COUNT_NAMES, _need(
                   fwd_wgmma=layers, dq_wgmma=layers, dkv_wgmma=layers))),
               attention_calls=eager_run["attention_calls"],
               plain_attention_calls=plain, **ops, **tape,
               leftover_gib_at_start=leftover, phase_s=seconds,
               card=nvidia_smi_line() if cuda else device)
    if cuda and plain:
        raise AssertionError(f"eager_training: {plain} attention calls took "
                             f"the plain path")
    emit("eager_training", **out)
    return out


# ------------------------------------------------------ inference_export
INFER_PATH = ("serving (GPT-350M bf16 saved by jit.save, served by "
              "inference.create_predictor from its artifact)")
INFER_SHAPES = ((1, 1024), (4, 512))   # [batch, length] from one artifact
INFER_FWD_CASES = {(1, 1024): "infer_bf16_B1_L1024",
                   (4, 512): "infer_bf16_B4_L512"}
INFER_RUNS = 5              # timed runs a shape, after the first
INFER_CPU_SAVED_LAYERS = 2  # the GPT-350M saved on the CPU, full width
INFER_RN_SIZE = 224         # ResNet-50's image side
INFER_DM_BATCH, INFER_DM_MICRO = 4, 2
INFER_C_RTOL, INFER_C_ATOL = 1e-5, 1e-6   # tests/test_jit_export.py:221
# the card's ResNet-50 program moved to the CPU, of max|ref|: 1.7e-6 read
# (my chip runs, 4092 the largest logit); TF32 or a batch-norm statistic
# off on one side moves it by 1e-4 or more
INFER_CPU_RTOL = 1e-5
INFER_C_TIMEOUT_S = 300
INFER_DISPATCH_CALLS = 200   # host-timed calls of the operator, a sample


def _flash_nodes(program) -> tuple:
    """(flash-attention operator nodes, softmax nodes) of a program."""
    import torch

    op = torch.ops.paddle_tpu_torch.flash_attention_fwd.default
    nodes = list(program.graph.nodes)
    flash = sum(n.target is op for n in nodes)
    soft = sum("softmax" in str(n.target) for n in nodes
               if n.op == "call_function")
    return flash, soft


def _c_consumer(lib: str, demo: str, prefix: str, x, tmp: str,
                device: str):
    """Start tools/torch_infer_demo.c on ``prefix`` with input ``x``
    (float32); returns the process, its input path and its start time."""
    import site

    path = os.path.join(tmp, "c_input.bin")
    with open(path, "wb") as f:
        f.write(x.astype("float32").tobytes())
    pkgs = [p for p in sys.path if "site-packages" in p] + site.getsitepackages()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__))] + pkgs))
    if device == "cpu":
        env["PT_INFER_DEVICE"] = "cpu"
    proc = subprocess.Popen([demo, lib, prefix, path, *map(str, x.shape)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    return proc, time.perf_counter()


def _c_result(proc, started: float, shape):
    import numpy as np

    try:
        out, err = proc.communicate(timeout=INFER_C_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"inference_export: the C consumer exited "
                             f"{proc.returncode}: {err[-2000:]}")
    lines = out.strip().splitlines()
    if lines[0].split() != ["shape", *map(str, shape)]:
        raise AssertionError(f"inference_export: the C consumer's output "
                             f"{lines[0]!r}, expected shape {shape}")
    got = np.asarray([float(v) for v in lines[1:]], np.float32)
    return got.reshape(shape), time.perf_counter() - started


def phase_inference_export(seed: int, device: str = "cuda", cfg=None,
                           rn_ctor=None, rn_size: int = INFER_RN_SIZE,
                           shapes=INFER_SHAPES) -> dict:
    """The deployment path on the card: (a) bench_gpt_primary's GPT-350M,
    bf16, seeded, saved by ``jit.save`` with ``InputSpec([None, None],
    "int64")``, loaded by ``inference.create_predictor`` and run at
    ``[1, 1024]`` and ``[4, 512]`` from one artifact: logits against the
    eager model's, the wgmma forward launched 24 times a run by the loaded
    program (24 operator nodes, no softmax), ``set_state_dict`` changing
    the output; capture, write, load, first and median run times, the
    artifact's bytes; then the same model at INFER_CPU_SAVED_LAYERS layers
    saved on the CPU and served on the card, which must launch the kernel
    (the gate admits CPU tensors while ``torch.export`` captures) and equal
    its eager model there. (b) ResNet-50, float32, saved as one DistModel
    stage:
    the plain-C consumer (``tools/torch_infer_demo.c`` over the C API) at
    batch 1 against the Python predictor, ``DistModel`` at batch 4 in two
    micro-batches against it, and the card's program moved to the CPU by
    ``Config.disable_gpu()``."""
    import copy
    import dataclasses
    import shutil
    import statistics
    import tempfile
    import threading

    import numpy as np
    import torch

    from paddle_tpu_torch import inference, jit
    from paddle_tpu_torch.distributed.launch.kv_server import KVServer
    from paddle_tpu_torch.hapi import InputSpec
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.models.resnet import resnet50

    t_start = time.perf_counter()
    cuda = device == "cuda"
    fa = None
    if cuda:
        from paddle_tpu_torch.kernels import flash_attention as fa
    leftover = _check_freed("inference_export") if cuda else None
    built = {}

    def build():
        try:
            built["lib"] = inference.build_capi()
            built["demo"] = inference.build_demo()
        except Exception as exc:  # raised below, in the phase's thread
            built["error"] = exc

    capi_build = threading.Thread(target=build, daemon=True)
    capi_build.start()
    tmp = tempfile.mkdtemp(prefix="inference_export_")
    consumer = None
    try:
        # ------------- (b) first: ResNet-50 float32 saved as one stage, and
        # the C consumer started on it, to run beside the GPT part
        rng = np.random.default_rng(seed + 25)
        gen = torch.Generator(device=device).manual_seed(seed + 26)
        rn = (rn_ctor or resnet50)(device=device, generator=gen).eval()
        dm_prefix = os.path.join(tmp, "resnet50")
        spec = [InputSpec([None, 3, rn_size, rn_size], "float32")]
        inference.save_dist_model([rn], dm_prefix, input_spec=spec)
        rn_save_s = dict(jit.save.seconds)
        stage = f"{dm_prefix}.stage0"
        rn_bytes = {ext: os.path.getsize(stage + ext)
                    for ext in (".pdmodel", ".pdiparams")}
        x1 = rng.standard_normal((1, 3, rn_size, rn_size)).astype(np.float32)
        capi_build.join()
        if "error" in built:
            raise built["error"]
        consumer, c_start = _c_consumer(built["lib"], built["demo"], stage,
                                        x1, tmp, device)

        # ---------------------------------------------- (a) GPT-350M bf16
        cfg = cfg or _primary_config()
        gen = torch.Generator(device=device).manual_seed(seed + 25)
        model = GPTForCausalLM(cfg, device=device, generator=gen)
        model = model.to(torch.bfloat16).eval()
        prefix = os.path.join(tmp, "gpt")
        jit.save(model, prefix, input_spec=[InputSpec([None, None], "int64")])
        save_s = dict(jit.save.seconds)
        nbytes = {ext: os.path.getsize(prefix + ext)
                  for ext in (".pdmodel", ".pdiparams")}
        t0 = time.perf_counter()
        cfg_pred = inference.Config(prefix)
        if not cuda:
            cfg_pred.disable_gpu()
        pred = inference.create_predictor(cfg_pred)
        load_s = time.perf_counter() - t0
        flash_nodes, softmax_nodes = _flash_nodes(pred._layer.program)
        layers = cfg.num_layers
        if cuda and (flash_nodes != layers or softmax_nodes):
            raise AssertionError(
                f"inference_export: the loaded program has {flash_nodes} "
                f"flash-attention nodes and {softmax_nodes} softmax nodes; "
                f"expected {layers} and 0")

        def timed(fn):
            t0 = time.perf_counter()
            out = fn()
            if cuda:
                torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) * 1e3

        runs, max_err = {}, 0.0
        for B, L in shapes:
            ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, L)),
                                  device=device)
            with torch.no_grad():
                want = model(ids)
                eager_ms = [timed(lambda: model(ids))[1]
                            for _ in range(INFER_RUNS)]
            if fa is not None:
                torch.cuda.synchronize()
                fa.reset_launch_counts()
            got, first_ms = timed(lambda: pred.run_tensors([ids])[0])
            times = []
            for _ in range(INFER_RUNS):
                again, ms = timed(lambda: pred.run_tensors([ids])[0])
                times.append(ms)
            counts = _counts(fa) if fa is not None else None
            err = float((got.float() - want.float()).abs().max())
            max_err = max(max_err, err)
            if tuple(got.shape) != (B, L, cfg.vocab_size) or \
                    not torch.isfinite(got).all():
                raise AssertionError(f"inference_export: logits "
                                     f"{tuple(got.shape)} at [{B}, {L}], "
                                     f"finite {bool(torch.isfinite(got).all())}")
            if err > 0.0 or not torch.equal(got, again):
                raise AssertionError(
                    f"inference_export: the loaded program's logits at "
                    f"[{B}, {L}] differ from the eager model's by {err} "
                    f"(replay equal: {torch.equal(got, again)})")
            need = _need(fwd_wgmma=layers * (1 + INFER_RUNS))
            if cuda and counts != need:
                raise AssertionError(
                    f"inference_export: [{B}, {L}]: launches {_COUNT_NAMES} "
                    f"{counts} over {1 + INFER_RUNS} runs, expected {need}")
            runs[f"B{B}_L{L}"] = dict(
                first_ms=first_ms, median_ms=statistics.median(times),
                ms=times, eager_median_ms=statistics.median(eager_ms),
                launches=(dict(zip(_COUNT_NAMES, counts))
                          if counts else None),
                max_abs_err=err)
            del want, got, again
        # the handle API with host copies, once, at the first shape
        B, L = shapes[0]
        ids_np = rng.integers(0, cfg.vocab_size, (B, L))
        handle = pred.get_input_handle(pred.get_input_names()[0])
        handle.copy_from_cpu(ids_np)
        t0 = time.perf_counter()
        host_out = pred.run()[0]
        host_run_ms = (time.perf_counter() - t0) * 1e3
        with torch.no_grad():
            want = model(torch.as_tensor(ids_np, device=device)).float()
        host_err = float(np.abs(host_out - want.cpu().numpy()).max())
        if host_err > 0.0:
            raise AssertionError(f"inference_export: Predictor.run's host "
                                 f"output differs by {host_err}")
        # the host's cost of the operator's dispatch: one call of the
        # registered operator against the direct launch it wraps, both
        # launching the kernel, at a shape small enough that the host is
        # the bound (medians of INFER_DISPATCH_CALLS calls each, in turns)
        dispatch_us = None
        if fa is not None:
            q, k, v = _views(torch.Generator(device=device).manual_seed(seed),
                             1, 128, 2, 64, torch.bfloat16)
            calls = {"operator": lambda: fa.flash_attention_fwd(
                         q, k, v, causal=True),
                     "direct": lambda: fa._launch_fwd(q, k, v, True, None,
                                                      None, 0.0, 0)}
            samples = {name: [] for name in calls}
            for _ in range(3):
                for name, fn in list(calls.items()) + list(
                        reversed(calls.items())):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(INFER_DISPATCH_CALLS):
                        fn()
                    samples[name].append((time.perf_counter() - t0) * 1e6
                                         / INFER_DISPATCH_CALLS)
            torch.cuda.synchronize()
            dispatch_us = {name: statistics.median(v)
                           for name, v in samples.items()}
        # TranslatedLayer's state changes what the program computes
        loaded = pred._layer
        sd = loaded.state_dict()
        key = "p_gpt__ln_f__weight"
        ids = torch.as_tensor(ids_np, device=device)
        base = pred.run_tensors([ids])[0]
        loaded.set_state_dict({key: sd[key] * 2})
        changed = pred.run_tensors([ids])[0]
        loaded.set_state_dict({key: sd[key]})
        restored = pred.run_tensors([ids])[0]
        state_moves = not torch.equal(base, changed)
        if not state_moves or not torch.equal(base, restored):
            raise AssertionError(
                f"inference_export: set_state_dict({key}): output changed "
                f"{state_moves}, restored {torch.equal(base, restored)}")
        del model, pred, loaded, sd, base, changed, restored, want, host_out
        if cuda:
            _free()

        # ---- (a') a program saved on the CPU launches the kernel on the card
        small_cfg = dataclasses.replace(cfg, num_layers=min(
            cfg.num_layers, INFER_CPU_SAVED_LAYERS))
        gen = torch.Generator(device=device).manual_seed(seed + 27)
        small = GPTForCausalLM(small_cfg, device=device, generator=gen)
        small = small.to(torch.bfloat16).eval()
        cpu_prefix = os.path.join(tmp, "gpt_cpu")
        jit.save(copy.deepcopy(small).cpu(), cpu_prefix,
                 input_spec=[InputSpec([None, None], "int64")])
        cpu_saved_capture_s = jit.save.seconds.get("capture")
        small_cfg_pred = inference.Config(cpu_prefix)
        if not cuda:
            small_cfg_pred.disable_gpu()
        small_pred = inference.create_predictor(small_cfg_pred)
        cpu_saved_nodes = _flash_nodes(small_pred._layer.program)
        B, L = shapes[0]
        ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, L)),
                              device=device)
        if fa is not None:
            torch.cuda.synchronize()
            fa.reset_launch_counts()
        got = small_pred.run_tensors([ids])[0]
        cpu_saved_counts = _counts(fa) if fa is not None else None
        with torch.no_grad():
            want = small(ids)
        cpu_saved_err = float((got.float() - want.float()).abs().max())
        need = _need(fwd_wgmma=small_cfg.num_layers)
        if cpu_saved_err > 0.0 or (cuda and (
                cpu_saved_nodes != (small_cfg.num_layers, 0)
                or cpu_saved_counts != need)):
            raise AssertionError(
                f"inference_export: the program saved on the CPU: "
                f"(flash, softmax) nodes {cpu_saved_nodes}, launches "
                f"{_COUNT_NAMES} {cpu_saved_counts} (expected {need}), "
                f"logits {cpu_saved_err} from its eager model")
        del small, small_pred, got, want
        if cuda:
            _free()

        # --------- (b) the Python predictor, the CPU, DistModel, the consumer
        rn_cfg = inference.Config(stage)
        if not cuda:
            rn_cfg.disable_gpu()
        rn_pred = inference.create_predictor(rn_cfg)
        ref1 = rn_pred.run([x1])[0]
        with torch.no_grad():
            eager1 = rn(torch.as_tensor(x1, device=device)).cpu().numpy()
        eager_err = float(np.abs(ref1 - eager1).max())
        # DistModel: one stage, two micro-batches of a batch of 4
        x4 = rng.standard_normal((INFER_DM_BATCH, 3, rn_size,
                                  rn_size)).astype(np.float32)
        ref4 = rn_pred.run([x4])[0]
        kv = KVServer(0).start()
        try:
            dm = inference.DistModel(inference.DistModelConfig(
                model_prefix=dm_prefix, rank=0, nranks=1,
                master_endpoint=f"127.0.0.1:{kv.port}",
                num_micro=INFER_DM_MICRO, device=device))
            try:
                t0 = time.perf_counter()
                dm_out = dm.run([x4])[0]
                dm_ms = (time.perf_counter() - t0) * 1e3
            finally:
                dm.shutdown()
        finally:
            kv.stop()
        c_out, c_s = _c_result(consumer, c_start, ref1.shape)
        consumer = None
        # the card's program on the CPU (Config.disable_gpu)
        cpu_cfg = inference.Config(stage)
        cpu_cfg.disable_gpu()
        t0 = time.perf_counter()
        cpu_out = inference.create_predictor(cpu_cfg).run([x1])[0]
        cpu_s = time.perf_counter() - t0
        cpu_err = float(np.abs(cpu_out - ref1).max())
        scale = float(np.abs(ref1).max())
        c_err = float(np.abs(c_out - ref1).max())
        dm_err = float(np.abs(dm_out - ref4).max())
        checks = {"c_consumer": (c_out, ref1), "dist_model": (dm_out, ref4)}
        for name, (got, want) in checks.items():
            if not np.allclose(got, want, rtol=INFER_C_RTOL,
                               atol=INFER_C_ATOL):
                raise AssertionError(
                    f"inference_export: {name} against the Python "
                    f"predictor: max abs err "
                    f"{float(np.abs(got - want).max())} beyond rtol "
                    f"{INFER_C_RTOL} / atol {INFER_C_ATOL}")
        if not np.isfinite(ref1).all() or eager_err > 0.0 or \
                cpu_err > INFER_CPU_RTOL * scale:
            raise AssertionError(
                f"inference_export: ResNet-50's predictor against its eager "
                f"model {eager_err}, on the CPU {cpu_err} (limit "
                f"{INFER_CPU_RTOL} x {scale})")
        del rn, rn_pred
    finally:
        if consumer is not None and consumer.poll() is None:
            consumer.kill()
            consumer.communicate()
        shutil.rmtree(tmp, ignore_errors=True)
    out = dict(
        path=INFER_PATH, model="bench_gpt_primary GPT-350M bf16", layers=layers,
        shapes=[list(s) for s in shapes], capture_s=save_s.get("capture"),
        write_s=save_s.get("write"), load_s=load_s, artifact_bytes=nbytes,
        flash_nodes=flash_nodes, softmax_nodes=softmax_nodes, runs=runs,
        logits_max_abs_err=max_err, host_run_ms=host_run_ms,
        host_run_max_abs_err=host_err, set_state_dict_changes_output=True,
        dispatch_us_per_call=dispatch_us,
        cpu_saved=dict(layers=small_cfg.num_layers,
                       capture_s=cpu_saved_capture_s,
                       flash_nodes=cpu_saved_nodes[0],
                       softmax_nodes=cpu_saved_nodes[1],
                       launches=(dict(zip(_COUNT_NAMES, cpu_saved_counts))
                                 if cpu_saved_counts else None),
                       max_abs_err=cpu_saved_err),
        launches_per_run=dict(zip(_COUNT_NAMES, _need(fwd_wgmma=layers))),
        resnet50=dict(batch=1, size=rn_size, capture_s=rn_save_s.get(
            "capture"), write_s=rn_save_s.get("write"),
            artifact_bytes=rn_bytes, c_consumer_max_abs_err=c_err,
            c_consumer_s=c_s, eager_max_abs_err=eager_err,
            cpu_max_abs_err=cpu_err, cpu_scale=scale, cpu_s=cpu_s,
            dist_model_batch=INFER_DM_BATCH, dist_model_micro=INFER_DM_MICRO,
            dist_model_max_abs_err=dm_err, dist_model_ms=dm_ms,
            rtol=INFER_C_RTOL, atol=INFER_C_ATOL),
        leftover_gib_at_start=leftover,
        phase_s=time.perf_counter() - t_start,
        card=nvidia_smi_line() if cuda else device)
    emit("inference_export", **out)
    return out


def phase_hapi_bert_fit(seed: int, device: str = "cuda", cfg=None) -> dict:
    """BertForSequenceClassification(bert_base()) bf16 O2 through
    Model.fit(train, eval) with Accuracy, tail padding and length buckets,
    LRScheduler over the linear warm-up and EarlyStopping; then evaluate
    and predict, held to a direct EvalStep over the same batches' real
    rows (the loss a batch's mean, averaged over batches, as evaluate
    takes it)."""
    import numpy as np
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.framework import random as framework_random
    from paddle_tpu_torch.framework.jit import EvalStep, _to_device
    from paddle_tpu_torch.hapi import (EarlyStopping, InputSpec,
                                       LRScheduler, Model)
    from paddle_tpu_torch.io import DataLoader, Dataset
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.models.bert import (BertForSequenceClassification,
                                              bert_base)
    from paddle_tpu_torch.nn import functional as F

    cuda = device == "cuda"
    fa = None
    if cuda:
        from paddle_tpu_torch.kernels import flash_attention as fa
    leftover = _check_freed("hapi_bert_fit") if cuda else None
    cfg = cfg or bert_base()

    class Rows(Dataset):
        def __init__(self, rows):
            self.rows = rows

        def __len__(self):
            return len(self.rows)

        def __getitem__(self, i):
            return self.rows[i]

    train = Rows(_hb_rows(seed + 21, HB_TRAIN, cfg.vocab_size))
    evalset = Rows(_hb_rows(seed + 22, HB_EVAL, cfg.vocab_size))
    framework_random.seed(seed)
    net = BertForSequenceClassification(cfg, device=device,
                                        generator=torch.Generator(
                                            device=device).manual_seed(seed))
    net, opt = amp.decorate(net.train(), _bert_optimizer(), level="O2",
                            dtype="bfloat16")
    model = Model(net, inputs=[InputSpec((None, None), "int64")],
                  labels=[InputSpec((None, 1), "int64")])
    model.prepare(opt, loss=lambda logits, label: F.cross_entropy(logits,
                                                                  label),
                  metrics=Accuracy())
    clock = _fit_clock(fa)
    stop = EarlyStopping(monitor="loss", patience=0, min_delta=HB_STOP_DELTA,
                         verbose=0, save_best_model=False)
    kw = dict(batch_size=HB_BATCH, pad_batches=True,
              length_buckets=HB_BUCKETS)
    if fa is not None:
        fa.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
    hist = model.fit(train, evalset, epochs=HB_EPOCHS, shuffle=False,
                     verbose=0, callbacks=[LRScheduler(), stop, clock],
                     num_workers=HF_WORKERS, prefetch_depth=HF_PREFETCH,
                     **kw)
    launches = _counts(fa) if fa is not None else None
    if not all(math.isfinite(x) for x in clock.losses):
        raise AssertionError(f"hapi_bert_fit: losses {clock.losses}")
    # EarlyStopping's decision, replayed on the eval losses it saw: each
    # evaluation that does not beat the best by HB_STOP_DELTA stops the fit
    evals = [float(np.asarray(x).reshape(-1)[0]) for x in hist["eval_loss"]]
    best, want_epochs = math.inf, HB_EPOCHS
    for e, v in enumerate(evals):
        if v + HB_STOP_DELTA < best:
            best = v
        else:
            want_epochs = e + 1
            break
    if not model.stop_training or len(hist["loss"]) != want_epochs \
            or want_epochs != 2:
        raise AssertionError(f"hapi_bert_fit: EarlyStopping: stopped "
                             f"{model.stop_training} after "
                             f"{len(hist['loss'])} of {HB_EPOCHS} epochs; "
                             f"the eval losses {evals} stop it after "
                             f"{want_epochs}, and this run expects 2")
    # the held-out comparison runs without dropout on both sides
    net.eval()
    ev = model.evaluate(evalset, verbose=0, **kw)
    pred = model.predict(DataLoader(evalset, **kw), stack_outputs=True)
    step = EvalStep(net)
    losses, hits, rows, direct = [], 0, 0, []
    for ids, label, mask in DataLoader(evalset, **kw):
        logits = step(ids)
        keep = torch.from_numpy(mask).to(logits.device)
        lab = _to_device(label[mask], logits.device)
        with torch.no_grad():
            losses.append(float(F.cross_entropy(logits[keep], lab)))
        real = logits[keep].float()
        # top-1 as Accuracy ranks (a stable argsort, reversed)
        top1 = torch.argsort(real, dim=-1, stable=True)[:, -1]
        hits += int((top1 == lab.reshape(-1)).sum())
        rows += int(mask.sum())
        direct.append(real.cpu().numpy())
    want = dict(loss=sum(losses) / len(losses), acc=hits / rows)
    direct = np.concatenate(direct)
    if ev != want or pred.shape != direct.shape \
            or not np.array_equal(pred.astype(np.float32), direct):
        raise AssertionError(f"hapi_bert_fit: evaluate {ev} / predict "
                             f"{pred.shape} against a direct EvalStep "
                             f"{want} / {direct.shape}")
    out = dict(model="bert_base classification bf16 O2",
               train_rows=HB_TRAIN, eval_rows=HB_EVAL, batch=HB_BATCH,
               buckets=list(HB_BUCKETS), epochs=HB_EPOCHS,
               losses=clock.losses, step_ms=clock.step_ms(),
               history={k: [float(np.asarray(x).reshape(-1)[0]) for x in v]
                        for k, v in hist.items()},
               evaluate=ev, direct_eval=want, predict_shape=list(pred.shape),
               stopped_early=model.stop_training,
               epochs_run=len(hist["loss"]),
               launches=(dict(zip(_COUNT_NAMES, launches))
                         if cuda else None),
               peak_mem_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                             if cuda else None),
               leftover_gib_at_start=leftover,
               card=nvidia_smi_line() if cuda else device)
    del model, net, opt, step
    _free()
    emit("hapi_bert_fit", **out)
    return out


# --------------------------------------------------------------------------
# multi-tenant LoRA: an adapter fit at bench_gpt_primary's GPT-350M and
# adapter serving at the serve preset
# --------------------------------------------------------------------------

# the adapter fit: hapi_gpt_fit's model, batches and loop, through
# Model.fit(lora=LoraConfig(rank=8, alpha=16)); attention as the full
# fit's (the adapters on qkv_proj take their gradient through it)
LORA_FIT_RANK, LORA_FIT_ALPHA = 8, 16.0
LORA_FIT_PATH = ("training (GPT-350M bf16 O2 adapter fit through "
                 "Model.fit(lora=...))")
# tools/serve_bench.py's adapter traffic as tools/lora_bench_results.json
# ran it (--adapters 8 --adapter-frac 0.85 --max-loaded 5): rank 4 (its
# --adapter-rank), alpha 2 x rank, leaves Normal(0, 0.02) from seed + 777,
# Zipf popularity 1 / (k + 1) ** 1.1
LORA_TENANTS, LORA_FRAC, LORA_MAX_LOADED = 8, 0.85, 5
LORA_SERVE_RANK, LORA_ZIPF = 4, 1.1
# that run's --requests 24, at the serve preset's request lengths
LORA_REQUESTS = 24
LORA_SERVE_PATH = ("serving (serve preset, 8 LoRA tenants, float32 prefill "
                   "at D = 64, pool-less)")
# decode steps timed and traced per engine, all 8 slots live
LORA_DECODE_STEPS = 16
# the serve preset's depth here: 12 of its 24 layers, width kept (the
# whole smoke ran 1177.7 s of its 1200 once inference_export joined it)
LORA_SERVE_LAYERS = 12


def _tensor_bytes(tree, skip=()) -> int:
    """Bytes of the tensors in ``tree`` (nested dicts), ``skip`` (tensors
    counted elsewhere, by identity) left out."""
    import torch

    if isinstance(tree, dict):
        return sum(_tensor_bytes(v, skip) for v in tree.values())
    if isinstance(tree, torch.Tensor) and not any(tree is s for s in skip):
        return tree.numel() * tree.element_size()
    return 0


def phase_lora_fit(seed: int, device: str = "cuda", cfg=None,
                   full=None) -> dict:
    """bench_gpt_primary's GPT-350M (hapi_gpt_fit's model, batches, workers
    and prefetch) through Model.fit(lora=LoraConfig(rank=8, alpha=16)): 5
    warm-up and 8 timed steps; exactly 24 wgmma forward, dQ and dK/dV
    launches a step; the base bitwise unchanged, the lora_B leaves moved,
    only adapter leaves in the step, the optimizer state under a tenth of
    the model's bytes; the adapter saved and loaded back bit-equal. Step
    ms, tokens/s and peak memory beside the full fit's (``full``, the
    hapi_gpt_fit result of the same run)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.lora import (LoraConfig, is_lora_param,
                                       load_adapter, lora_state,
                                       save_adapter, set_adapter)

    cuda = device == "cuda"
    fa = None
    if cuda:
        from paddle_tpu_torch.kernels import flash_attention as fa
    leftover = _check_freed("lora_fit") if cuda else None
    cfg = cfg or _primary_config()
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (HF_STEPS * HF_BATCH, HF_SEQ)) \
        .astype(np.int32)
    net, opt = _primary_net(cfg, seed, device)
    base = {k: v.detach().clone() for k, v in net.named_parameters()}
    model = Model(net, labels=[])
    model.prepare(opt)
    clock = _fit_clock(fa)
    if cuda:
        fa.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
    model.fit(TensorDataset([ids, ids]), batch_size=HF_BATCH, epochs=1,
              shuffle=False, num_workers=HF_WORKERS,
              prefetch_depth=HF_PREFETCH, verbose=0, callbacks=[clock],
              lora=LoraConfig(rank=LORA_FIT_RANK, alpha=LORA_FIT_ALPHA))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else None
    launches = _counts(fa) if cuda else None
    step = model._train_step
    if not all(math.isfinite(x) for x in clock.losses):
        raise AssertionError(f"lora_fit: losses {clock.losses}")
    if cuda:
        need = _need(**HF_NEED)
        if any(c != need for c in clock.launches):
            raise AssertionError(
                f"lora_fit: launches per step {_COUNT_NAMES} "
                f"{clock.launches}, expected {need} every step")
    named = dict(net.named_parameters())
    changed = [k for k, v in base.items() if not _bits_equal(v, named[k])]
    if changed:
        raise AssertionError(f"lora_fit: the frozen base moved: "
                             f"{changed[:3]} ({len(changed)} leaves)")
    if not step.params or not all(is_lora_param(k) for k in step.params):
        raise AssertionError(f"lora_fit: the step trains "
                             f"{sorted(step.params)[:3]}...")
    moved = sum(bool(v.abs().max() > 0) for k, v in step.params.items()
                if k.endswith("lora_B"))
    if not moved:
        raise AssertionError("lora_fit: no lora_B leaf moved")
    params = list(net.parameters())
    model_bytes = _tensor_bytes({str(i): p for i, p in enumerate(params)})
    # a float32 adapter leaf is its own master: counted with the model
    opt_bytes = _tensor_bytes(step.opt_state, skip=params)
    if not opt_bytes * 10 < model_bytes:
        raise AssertionError(f"lora_fit: optimizer state {opt_bytes} bytes "
                             f"against the model's {model_bytes}")
    adapter = {k: v.detach().to("cpu", copy=True)
               for k, v in lora_state(net).items()}
    tmp = tempfile.mkdtemp(prefix="lora_fit-")
    try:
        t0 = time.perf_counter()
        save_adapter(tmp, net)
        save_s = time.perf_counter() - t0
        adapter_bytes = _dir_bytes(tmp)
        state, meta = load_adapter(tmp, net)
        set_adapter(net, state)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    reloaded = lora_state(net)
    if set(state) != set(adapter) or not all(
            _bits_equal(adapter[k], state[k])
            and _bits_equal(adapter[k], reloaded[k].detach().cpu())
            for k in adapter):
        raise AssertionError("lora_fit: save_adapter / load_adapter did not "
                             "give the trained leaves back bit for bit")
    timed = clock.step_ms()[TRAIN_WARMUP:]
    tokens_per_s = HF_BATCH * HF_SEQ * TRAIN_TIMED / (sum(timed) / 1e3)
    out = dict(model="bench_gpt_primary GPT-350M bf16 O2, LoRA",
               path=LORA_FIT_PATH, rank=LORA_FIT_RANK, alpha=LORA_FIT_ALPHA,
               batch=[HF_BATCH, HF_SEQ], layers=cfg.num_layers,
               targets=len(step.params) // 2,
               adapter_params=sum(v.numel() for v in step.params.values()),
               model_params=sum(p.numel() for p in params),
               adapter_dtype=str(next(iter(step.params.values())).dtype),
               losses=clock.losses, step_ms=clock.step_ms(),
               step_ms_median=float(np.median(timed)),
               tokens_per_s=tokens_per_s,
               full_fit_step_ms_median=(full or {}).get("fit_step_ms_median"),
               full_fit_tokens_per_s=(full or {}).get("tokens_per_s"),
               full_fit_peak_mem_gib=(full or {}).get("peak_mem_gib"),
               optimizer_state_bytes=opt_bytes, model_bytes=model_bytes,
               base_bit_equal=True, lora_b_moved=moved,
               adapter_checkpoint_bytes=adapter_bytes,
               save_adapter_s=save_s, reload_bit_equal=True,
               base_fingerprint=meta["base_fingerprint"],
               launches=(dict(zip(_COUNT_NAMES, launches))
                         if cuda else None),
               launches_per_step=dict(zip(_COUNT_NAMES, _need(**HF_NEED))),
               peak_mem_gib=peak, leftover_gib_at_start=leftover,
               card=nvidia_smi_line() if cuda else device)
    del model, net, opt, step, base, named, params, reloaded
    _free()
    emit("lora_fit", **out)
    return out


def _preset_requests(seed: int, vocab: int, n: int = PRESET_REQUESTS
                     ) -> tuple:
    """serve_bench's prefix-heavy trace at the serve preset: ``n``
    requests, PRESET_PREFIX_FRAC of them opening with one
    shared PRESET_PREFIX-token prefix and a PRESET_SUFFIX-token suffix,
    the rest random lengths; PRESET_NEW new tokens each. Returns
    ``(requests, prefix)``."""
    import numpy as np

    rng = np.random.default_rng(seed + 19)
    prefix = rng.integers(0, vocab, PRESET_PREFIX)
    requests = []
    for _ in range(n):
        if rng.random() < PRESET_PREFIX_FRAC:
            sfx = rng.integers(0, vocab, int(rng.integers(
                PRESET_SUFFIX[0], PRESET_SUFFIX[1] + 1)))
            prompt = np.concatenate([prefix, sfx])
        else:
            prompt = rng.integers(0, vocab, int(rng.integers(
                4, 1024 - PRESET_NEW + 1)))
        requests.append(dict(prompt=prompt, max_new_tokens=PRESET_NEW))
    return requests, prefix


def _lora_tenants(model, seed: int):
    """serve_bench's synthetic tenants on an injected model: names, leaves
    (Normal(0, 0.02) from ``seed + 777``, in lora_state order) and the
    Zipf popularity weights."""
    import numpy as np

    from paddle_tpu_torch.lora import lora_state

    zero = lora_state(model)
    arng = np.random.default_rng(seed + 777)
    names = [f"tenant{k}" for k in range(LORA_TENANTS)]
    trees = {n: {k: arng.normal(0.0, 0.02, tuple(v.shape)).astype(
        np.float32) for k, v in zero.items()} for n in names}
    w = np.array([1.0 / (k + 1) ** LORA_ZIPF for k in range(LORA_TENANTS)])
    return names, trees, w / w.sum()


def _lora_store(model, names, trees):
    from paddle_tpu_torch.lora import AdapterStore

    store = AdapterStore(model, max_loaded=LORA_MAX_LOADED)
    for n in names:
        store.register(n, trees[n])
    return store


def _decode_profile(model, store, tenants, prompts, device) -> dict:
    """All PRESET_SLOTS slots live on one engine (``store`` or none),
    ``tenants`` one per slot: LORA_DECODE_STEPS decode steps timed (host
    clock, synchronised), then as many traced for their kernel launches
    (CUDA kernels in the profiler's trace)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.serving import ContinuousBatchingEngine, Request

    eng = ContinuousBatchingEngine(model, slots=PRESET_SLOTS, max_length=1024,
                                   adapter_store=store)
    for slot, (t, p) in enumerate(zip(tenants, prompts)):
        eng.admit(Request(prompt=p, max_new_tokens=3 * LORA_DECODE_STEPS,
                          adapter_id=t), slot)
    eng.step()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(LORA_DECODE_STEPS):
        eng.step()
    _sync(device)
    step_ms = (time.perf_counter() - t0) * 1e3 / LORA_DECODE_STEPS
    launches = None
    if torch.device(device).type == "cuda":
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(LORA_DECODE_STEPS):
                eng.step()
            torch.cuda.synchronize()
        launches = sum(ev.count for ev in prof.key_averages()
                       if ev.device_type == DeviceType.CUDA) \
            / LORA_DECODE_STEPS
    for slot in range(PRESET_SLOTS):
        eng.release(slot)
    del eng
    return dict(decode_step_ms=step_ms, launches_per_decode_step=launches,
                rows=[0 if t is None else t for t in tenants],
                prompt_lens=[int(len(p)) for p in prompts])


def _lora_served(model, requests, tenants, store, pooled: bool, fa):
    """Serve ``requests`` (``tenants[i]`` for request ``i``) behind the
    preset's InferenceServer with ``store`` (or none), the pool when
    ``pooled``; returns (handles, streams, snapshot, forward launches,
    wall seconds)."""
    from paddle_tpu_torch.serving import InferenceServer

    server = InferenceServer(
        model, slots=PRESET_SLOTS, max_length=1024, adapter_store=store,
        prefix_cache=PRESET_POOL_BYTES if pooled else None,
        device=model.device)
    if fa is not None:
        fa.reset_launch_counts()
    t0 = time.perf_counter()
    handles = [server.submit(adapter_id=t, **r)
               for r, t in zip(requests, tenants)]
    streams = [h.result(timeout=900) for h in handles]
    wall_s = time.perf_counter() - t0
    launches = _forward_launches(fa) if fa is not None else None
    server.shutdown(timeout=60)
    return handles, streams, server.snapshot(), launches, wall_s


def _common_prefix(a, b) -> int:
    import numpy as np

    n = min(len(a), len(b))
    diff = np.nonzero(np.asarray(a[:n]) != np.asarray(b[:n]))[0]
    return int(diff[0]) if diff.size else n


def phase_lora_serving(seed: int, device: str = "cuda", cfg=None) -> dict:
    """The serve preset (_preset_config, float32 parameters, its bf16
    cache) behind InferenceServer(slots=8, max_length=1024) with
    serve_bench's adapter traffic (8 tenants, rank 4, 85 % of requests
    carrying a Zipf-drawn tenant, max_loaded=5, so the LRU churns), on the
    serve preset's request lengths, pool-less and with a 256 MiB pool.
    First the base model alone (no injection) on the same requests,
    without and with the pool. Every request completes; every pool-less
    stream equals the request's solo generate() with its adapter set (or
    cleared), and the base requests equal the base model's streams; every
    pooled stream equals solo generate() or, where it parts from it, the
    request served alone by a fresh pooled server (a pooled admit attends
    the bf16 cache where a pool-less prefill attends its float32 block,
    the reference's design; the base model's pooled run parts alike, and
    both counts are printed); the pool-less run launches exactly one
    wgmma_f32 D = 64 forward a layer (LORA_SERVE_LAYERS)
    and splits per prefill and the pooled run none; evictions > 0; a
    pooled request hits only
    blocks an earlier request of its own tenant wrote, and one prompt sent
    by tenant A, tenant B, A again and the base hits only on A's second
    send. Launches and ms per decode step with all 8 slots live, on the
    base model and through the store."""
    import numpy as np
    import torch

    from paddle_tpu_torch.lora import (LoraConfig, apply_lora,
                                       clear_adapter, set_adapter)
    from paddle_tpu_torch.models.gpt import GPTForCausalLM

    cuda = device == "cuda"
    fa = None
    if cuda:
        from paddle_tpu_torch.kernels import flash_attention as fa
        torch.cuda.reset_peak_memory_stats()
    leftover = _check_freed("lora_serving") if cuda else None
    cfg = cfg or _preset_config(num_layers=LORA_SERVE_LAYERS)
    model = GPTForCausalLM(cfg, device=device, generator=torch.Generator(
        device=device).manual_seed(seed)).eval()
    model.generate(np.zeros((1, 8), np.int64), max_new_tokens=2,
                   max_length=1024)   # warm: cuBLAS handles, allocator
    requests, prefix = _preset_requests(seed, cfg.vocab_size, LORA_REQUESTS)
    n = len(requests)
    layers = cfg.num_layers
    prompts8 = [r["prompt"][:64 + 8 * i] for i, r in
                enumerate((requests * 2)[:PRESET_SLOTS])]
    out = dict(model=f"serve preset (h1024, {layers} of its 24 layers, "
                     "16 heads of 64), float32 parameters, bf16 cache",
               requests=n, prompt_lens=[len(r["prompt"]) for r in requests],
               leftover_gib_at_start=leftover)
    # the base model, before injection: the same traffic, no store, without
    # and with the pool (a pooled admit attends the bf16 cache, a pool-less
    # prefill its float32 block: their streams may part)
    _, base_streams, snap, launches, wall = _lora_served(
        model, requests, [None] * n, None, False, fa)
    _check_clean("lora_serving (base)", snap, n)
    _, base_pooled, bsnap, _, _ = _lora_served(
        model, requests, [None] * n, None, True, None)
    _check_clean("lora_serving (base, pooled)", bsnap, n)
    out["base_only"] = dict(
        pooled_streams_equal_pool_less=int(sum(
            np.array_equal(a, b) for a, b in zip(base_pooled, base_streams))),
        ttft_p50_ms=snap["ttft"]["p50_ms"], ttft_p99_ms=snap["ttft"]["p99_ms"],
        inter_token_p50_ms=snap["inter_token"]["p50_ms"],
        inter_token_p99_ms=snap["inter_token"]["p99_ms"], wall_s=wall,
        tokens_per_s=snap["tokens_emitted"] / wall,
        **_decode_profile(model, None, [None] * PRESET_SLOTS, prompts8,
                          device))
    apply_lora(model, LoraConfig(rank=LORA_SERVE_RANK,
                                 alpha=2.0 * LORA_SERVE_RANK))
    names, trees, zipf = _lora_tenants(model, seed)
    trng = np.random.default_rng(seed + 23)
    tenants = [None if trng.random() >= LORA_FRAC
               else names[int(trng.choice(LORA_TENANTS, p=zipf))]
               for _ in range(n)]
    solo = [None] * n
    for name in [None] + names:
        if name is None:
            clear_adapter(model)
        else:
            set_adapter(model, trees[name])
        for i, r in enumerate(requests):
            if tenants[i] == name:
                solo[i] = model.generate(r["prompt"][None], max_length=1024,
                                         max_new_tokens=r["max_new_tokens"])[0]
    clear_adapter(model)
    # the live requests are a window of at most PRESET_SLOTS consecutive
    # ones (FIFO admission, PRESET_NEW tokens each); with more slots than
    # rows, a window holding more than LORA_MAX_LOADED tenants would find
    # every row pinned, and the store fails such a request (AdapterError,
    # the reference's rule); the trace must churn the LRU without that
    windows = max(len({t for t in tenants[i:i + PRESET_SLOTS] if t})
                  for i in range(n))
    if windows > LORA_MAX_LOADED or not len(set(tenants) - {None}) \
            > LORA_MAX_LOADED:
        raise AssertionError(
            f"lora_serving: the trace's tenants {tenants} hold up to "
            f"{windows} tenants in {PRESET_SLOTS} consecutive requests and "
            f"{len(set(tenants) - {None})} in all: it must hold at most "
            f"{LORA_MAX_LOADED} and more than {LORA_MAX_LOADED}")
    out.update(tenants=[t or "base" for t in tenants],
               distinct_tenants=len({t for t in tenants if t}),
               rank=LORA_SERVE_RANK, max_loaded=LORA_MAX_LOADED)
    for pooled in (False, True):
        label = "pooled" if pooled else "pool_less"
        store = _lora_store(model, names, trees)
        handles, streams, snap, launches, wall = _lora_served(
            model, requests, tenants, store, pooled, fa)
        _check_clean(f"lora_serving ({label})", snap, n)
        equal_solo = int(sum(np.array_equal(a, b)
                             for a, b in zip(streams, solo)))
        if pooled:
            # a stream that parts from solo generate() must equal the
            # request alone through a fresh pooled server and store (a
            # cold admit through the same continuation)
            parted = [i for i in range(n)
                      if not np.array_equal(streams[i], solo[i])]
            alone = [_lora_served(model, [requests[i]], [tenants[i]],
                                  _lora_store(model, names, trees), True,
                                  None)[1][0] for i in parted]
            _check_streams(f"lora_serving ({label}) vs served alone",
                           [requests[i] for i in parted],
                           [streams[i] for i in parted], alone)
        else:
            _check_streams(f"lora_serving ({label}) vs solo generate",
                           requests, streams, solo)
            # row 0 is the base model exactly
            _check_streams("lora_serving: base requests vs the base model",
                           [r for r, t in zip(requests, tenants) if t is None],
                           [a for a, t in zip(streams, tenants) if t is None],
                           [b for b, t in zip(base_streams, tenants)
                            if t is None])
        if fa is not None:
            need = (0, 0, 0) if pooled else (layers * n, 0, layers * n)
            if launches != need:
                raise AssertionError(
                    f"lora_serving ({label}): forwards (wgmma_f32, other, "
                    f"split) {launches}, expected {need}")
        st = store.stats()
        if not st["evictions"] > 0:
            raise AssertionError(f"lora_serving ({label}): no eviction with "
                                 f"max_loaded={LORA_MAX_LOADED}: {st}")
        hits = [h.cache_hit_tokens for h in handles]
        if pooled:
            # admission is FIFO: a hit can only come from an earlier
            # request of the same tenant sharing at least that prefix
            for i, hit in enumerate(hits):
                best = max([_common_prefix(requests[i]["prompt"],
                                           requests[j]["prompt"])
                            for j in range(i) if tenants[j] == tenants[i]],
                           default=0)
                if hit > best:
                    raise AssertionError(
                        f"lora_serving (pooled): request {i} "
                        f"({tenants[i]}) hit {hit} tokens, but no earlier "
                        f"request of its tenant shares more than {best}")
        out[label] = dict(
            flash_launches=None if launches is None else launches[0],
            split_launches=None if launches is None else launches[2],
            flash_per_prefill=(None if launches is None
                               else launches[0] / n),
            streams_equal_solo_generate=equal_solo,
            parted_streams_equal_served_alone=(n - equal_solo
                                               if pooled else None),
            wall_s=wall,
            tokens=snap["tokens_emitted"],
            tokens_per_s=snap["tokens_emitted"] / wall,
            ttft_p50_ms=snap["ttft"]["p50_ms"],
            ttft_p99_ms=snap["ttft"]["p99_ms"],
            inter_token_p50_ms=snap["inter_token"]["p50_ms"],
            inter_token_p99_ms=snap["inter_token"]["p99_ms"],
            prefix_hit_tokens=hits, store=st,
            per_adapter=snap["per_adapter"])
        del store, handles
    # the salt, alone: one prompt from tenant A, B, A and the base
    store = _lora_store(model, names, trees)
    prompt = np.concatenate([prefix, requests[0]["prompt"][-8:]])
    order = (names[0], names[1], names[0], None)
    hs, got, snap, launches, _ = _lora_served(
        model, [dict(prompt=prompt, max_new_tokens=4)] * 4, order, store,
        True, fa)
    salt_hits = [h.cache_hit_tokens for h in hs]
    if salt_hits[0] or salt_hits[1] or salt_hits[3] or not salt_hits[2]:
        raise AssertionError(f"lora_serving: one prompt from tenants "
                             f"{order} hit {salt_hits} tokens; only the "
                             f"third may hit (its own tenant's blocks)")
    out["salt_check"] = dict(order=[t or "base" for t in order],
                             hit_tokens=salt_hits)
    # decode steps with all 8 slots live: five tenants, the base and two
    # repeats, through a store of its own (a store serves one engine)
    slots = [names[0], names[1], names[2], names[3], names[4], None,
             names[0], names[1]]
    store = _lora_store(model, names, trees)
    out["store_decode"] = _decode_profile(model, store, slots, prompts8,
                                          device)
    out["page_bytes"] = store.page_bytes
    out["flash_launches"] = out["pool_less"]["flash_launches"]
    out["split_launches"] = out["pool_less"]["split_launches"]
    out["peak_mem_gib"] = (torch.cuda.max_memory_allocated() / 2 ** 30
                           if cuda else None)
    out["card"] = nvidia_smi_line() if cuda else device
    del store, model, hs
    _free()
    emit("lora_serving", **out)
    return out


# --------------------------------------------------------------------------
# hybrid-parallel training at world 2 on the one card
# --------------------------------------------------------------------------

DIST_PATH = ("training (GPT-350M bf16 O2 step at world 2 on one card, gloo "
             "with CUDA tensors)")
# (label, mesh, DistributedTrainStep options, the rank's attention cases)
DIST_RUNS = (
    ("sdp2_zero2_overlap", {"sdp": 2},
     dict(sharding_stage=2, overlap_grad_reduce=True),
     DIST_ZERO_FWD, DIST_ZERO_BWD),
    ("mp2", {"mp": 2}, {}, DIST_MP_FWD, DIST_MP_BWD),
    ("sdp2_zero3", {"sdp": 2}, dict(sharding_stage=3),
     DIST_ZERO_FWD, DIST_ZERO_BWD),
)
DIST_BACKEND = "gloo"        # two ranks on one device: NCCL refuses them
# GPT-350M's width at 12 of its 24 layers: the three world-2 runs took
# 121-133 s of the smoke's 1200 at 24 (gloo's loopback, a few s a step),
# and the vision zoo's phase needed the room
DIST_LAYERS = 12
DIST_CHILD_TIMEOUT_S = 600   # one run's two ranks, start to exit
DIST_NCCL_TIMEOUT_S = 120    # the NCCL checks (a refusal may hang a peer)
# bf16 tolerances against the single-process step on the same batches.
# The update error of a float32 master is ||world-2 master - yardstick's||
# over ||yardstick's - initial||: the share of what the 13 steps learned
# that the run got wrong (a run that never updates reads 1), gated on the
# worst leaf and on the whole model. Each limit lies between the sound
# runs' readings and those of runs with a planted fault, read on an H100
# by tools/torch_dist_faults.py: worst leaf 0.42 / 0.54 / 0.42 sound
# (ZeRO-2, mp = 2, ZeRO-3) against 1.00 / 1.04 / 1.34 (no update, no
# gradient reduction, no input-gradient all-reduce over mp); the model
# 0.037 / 0.070 / 0.037 against 0.999 / 0.904 / 1.011; the losses' largest
# relative error 3.5e-5 / 9.3e-5 / 3.5e-5 against 3.5e-3 / 1.1e-3 /
# 1.05e-3.
DIST_UPDATE_RTOL = 0.75
DIST_UPDATE_MODEL_RTOL = 0.25
DIST_LOSS_RTOL = 3e-4
DIST_LR = 1e-4


def _dist_batches(cfg, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed + 20)
    return [rng.integers(0, cfg.vocab_size, (HF_BATCH, HF_SEQ))
            .astype(np.int64) for _ in range(TRAIN_WARMUP + TRAIN_TIMED)]


def _dist_reference(cfg, seed: int, path: str) -> dict:
    """The single-process TrainStep on the runs' batches: its losses,
    float32 masters and the norm of each master's move from its initial
    value, saved to ``path`` for the ranks to compare with."""
    import torch

    from paddle_tpu_torch.framework.jit import TrainStep

    model, opt = _primary_net(cfg, seed)
    step = TrainStep(model, opt, loss_fn=None)
    live = step.opt_state["master_weights"]
    init = {k: v.detach().clone() for k, v in live.items()}
    losses = [float(step((ids, ids))) for ids in _dist_batches(cfg, seed)]
    moved = {k: float((v.detach() - init[k]).norm()) for k, v in live.items()}
    masters = {k: v.detach().float().cpu() for k, v in live.items()}
    torch.save({"losses": losses, "masters": masters, "moved": moved}, path)
    del step, model, opt, masters, init
    _free()
    return {"losses": losses}


def _update_error(step, mesh, ref: dict) -> dict:
    """The run's float32 masters against the yardstick's ``ref`` (see
    DIST_UPDATE_RTOL), without gathering them: each rank compares its own
    block of every master with the same block of the yardstick's (a
    block held by several ranks counts on one), and the per-leaf sums
    meet in two small all-reduces. The worst leaf's update error and its
    name, the whole model's, the largest element difference and the share
    of elements more than one lr apart."""
    import torch

    from paddle_tpu_torch.convert import shard_tensor
    from paddle_tpu_torch.distributed import collective as C

    names = list(ref["masters"])
    sums = torch.zeros(len(names), 3, dtype=torch.float64)  # d², >lr, n
    biggest = torch.zeros(len(names), dtype=torch.float64)
    for i, k in enumerate(names):
        spec = step.update_specs[k]
        if any(mesh.coordinate[a] for a in mesh.axis_names
               if a not in spec.axes()):
            continue   # another rank holds the same block
        mine = step.opt_state["master_weights"][k].float()
        d = (mine - shard_tensor(ref["masters"][k], spec, mesh).to(
            mine.device)).abs()
        sums[i, 0] = float(d.double().square().sum())
        sums[i, 1] = float((d > DIST_LR).sum())
        sums[i, 2] = d.numel()
        biggest[i] = float(d.max())
    sums = C.all_reduce(sums, C.ReduceOp.SUM, mesh.axis_names, mesh)
    biggest = C.all_reduce(biggest, C.ReduceOp.MAX, mesh.axis_names, mesh)
    worst, worst_name, num, den = -1.0, None, 0.0, 0.0
    for i, k in enumerate(names):
        err, moved = math.sqrt(float(sums[i, 0])), ref["moved"][k]
        rel = err / moved if moved else (0.0 if err == 0 else math.inf)
        if rel > worst:
            worst, worst_name = rel, k
        num += err * err
        den += moved * moved
    return dict(update_err_worst_leaf=worst, worst_leaf=worst_name,
                update_err_model=math.sqrt(num / den),
                master_max_abs_err=float(biggest.max()),
                master_frac_beyond_lr=float(sums[:, 1].sum()
                                            / sums[:, 2].sum()))


def dist_child(runs: str, ref_path: str) -> int:
    """One rank of phase_distributed_training (RANK, WORLD_SIZE,
    MASTER_ADDR and MASTER_PORT in the environment). ``runs`` is
    "nccl_two_ranks" (two ranks on one device over NCCL, the default
    backend) or labels of DIST_RUNS joined by commas, run one after the
    other in this process over gloo. Prints one JSON line
    ``{"dist_child": {...}}`` a run."""
    import torch
    import torch.distributed as tdist

    from paddle_tpu_torch import default_device
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import env

    default_device("cuda")
    rank = int(os.environ["RANK"])

    def report(run, **fields):
        print(json.dumps({"dist_child": dict(rank=rank, run=run, **fields)}),
              flush=True)

    if runs == "nccl_two_ranks":
        try:
            env.init_parallel_env(timeout=60.0)   # the default: NCCL
        except Exception as e:   # the refusal is this run's result
            report(runs, ok=False, error=f"{type(e).__name__}: {e}"[:2000])
            return 0
        report(runs, ok=True, backend=env.backend(),
               world=env.get_world_size())
        tdist.destroy_process_group()
        return 0

    from paddle_tpu_torch.distributed.mesh import init_mesh, set_mesh
    from paddle_tpu_torch.distributed.shard import DistributedTrainStep
    from paddle_tpu_torch.kernels import flash_attention as fa

    env.init_parallel_env(backend=DIST_BACKEND)
    cfg = _primary_config(num_layers=DIST_LAYERS)
    seed = int(os.environ["DIST_SEED"])
    batches = _dist_batches(cfg, seed)
    ref = torch.load(ref_path, weights_only=False, mmap=True)
    for run in runs.split(","):
        t0 = time.perf_counter()
        leftover = torch.cuda.memory_allocated() / 2 ** 30
        mesh_shape, options = next((r[1], r[2]) for r in DIST_RUNS
                                   if r[0] == run)
        mesh = init_mesh(mesh_shape)
        model, opt = _primary_net(cfg, seed)
        step = DistributedTrainStep(model, opt, loss_fn=None, mesh=mesh,
                                    **options)
        _free()
        build_s = time.perf_counter() - t0
        fa.reset_launch_counts()
        C.reset_stats()
        torch.cuda.reset_peak_memory_stats()
        losses, per_step = [], []
        for i, ids in enumerate(batches):
            if i == TRAIN_WARMUP:
                torch.cuda.synchronize()
                t_timed = time.perf_counter()
            before = _counts(fa)
            losses.append(float(step((ids, ids))))
            per_step.append([a - b for a, b in zip(_counts(fa), before)])
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t_timed) * 1e3 / TRAIN_TIMED
        launches = _counts(fa)
        stats = C.stats()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out = dict(ok=True, backend=env.backend(), mesh=mesh_shape,
                   options=options, coordinate=mesh.coordinate,
                   leftover_gib_at_start=leftover, build_s=build_s, losses=losses, step_ms=step_ms,
                   tokens_per_s=HF_BATCH * HF_SEQ / (step_ms / 1e3),
                   peak_gib=peak, launches=dict(zip(_COUNT_NAMES, launches)),
                   per_step=per_step, collective_bytes=stats["bytes"],
                   collective_calls=stats["calls"],
                   staged_bytes=stats["staged_bytes"],
                   buckets=len(step.collective_schedule()),
                   buckets_issued_in_backward=step.buckets_issued_in_backward,
                   zero_fallback_params=len(step.zero_fallback_params),
                   local_param_shapes={
                       k: list(v.shape) for k, v in step.params.items()
                       if k in ("gpt.h.0.attn.qkv_proj.weight",
                                "gpt.embeddings.word_embeddings.weight")},
                   ref_losses=ref["losses"], loss_max_rel_err=max(
                       abs(a - b) / abs(b)
                       for a, b in zip(losses, ref["losses"])),
                   **_update_error(step, mesh, ref))
        del step, model, opt
        set_mesh(None)
        _free()
        report(run, run_s=time.perf_counter() - t0, **out)
    tdist.destroy_process_group()
    return 0


def _nccl_world_of_one() -> dict:
    """The default backend on the card: this process alone joins a world
    of one over NCCL (``init_parallel_env``'s default; it runs one
    all-reduce), then leaves it."""
    import torch.distributed as tdist

    from paddle_tpu_torch.distributed import env

    env.init_parallel_env(timeout=60.0)
    try:
        got = dict(backend=env.backend(), world=env.get_world_size())
    finally:
        tdist.destroy_process_group()
    if got != dict(backend="nccl", world=1):
        raise AssertionError(f"NCCL world of one: {got}")
    return got


def _start_world(runs: str, world: int, ref_path: str, seed: int, tmp: str,
                 child=None) -> tuple:
    """Start ``world`` fresh rank processes of ``runs`` (see dist_child);
    ``child`` is the rank's command (default: this script's
    ``--dist-child runs ref_path``). Returns the handle _join_world
    takes."""
    here = os.path.dirname(os.path.abspath(__file__))
    port = _free_port()
    child = child or [os.path.abspath(__file__), "--dist-child", runs,
                      ref_path]
    procs, logs = [], []
    for r in range(world):
        log = open(os.path.join(tmp, f"{runs}_rank{r}.log"), "w+")
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), DIST_SEED=str(seed),
                   NCCL_DEBUG=os.environ.get("NCCL_DEBUG", "WARN"),
                   PYTHONPATH=os.pathsep.join(
                       [here] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]))
        procs.append(subprocess.Popen(
            [sys.executable] + child, stdout=log, stderr=subprocess.STDOUT,
            text=True, cwd=here, env=env))
        logs.append(log)
    return runs, procs, logs


def _join_world(handle, timeout: float = DIST_CHILD_TIMEOUT_S,
                may_hang: bool = False) -> list:
    """Wait for the ranks of ``handle`` and collect their reports: a list
    a run, of one report a rank. A rank that hangs past ``timeout`` is
    killed with its peers, and the world fails unless ``may_hang`` (then
    each rank's report is ``{"ok": False, "hung": True}``)."""
    runs, procs, logs = handle
    deadline = time.monotonic() + timeout
    hung = False
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        hung = True
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
    reports, tails = [[] for _ in procs], []
    for r, log in enumerate(logs):
        log.seek(0)
        text = log.read()
        log.close()
        for line in text.splitlines():
            if line.startswith('{"dist_child"'):
                reports[r].append(json.loads(line)["dist_child"])
        tails.append(f"rank {r} (exit {procs[r].returncode}):\n"
                     + "\n".join(text.splitlines()[-25:]))
    nccl = [[line for line in tail.splitlines()
             if "NCCL" in line or "Duplicate" in line][-6:] for tail in tails]
    if hung and may_hang:
        return [[dict(rep[0] if rep else {}, ok=False, hung=True,
                      log_tail=log) for rep, log in zip(reports, nccl)]]
    n_runs = len(runs.split(","))
    if any(len(rep) != n_runs for rep in reports) or any(
            p.returncode != 0 for p in procs):
        raise AssertionError(f"distributed_training {runs}: a rank failed\n"
                             + "\n".join(tails))
    return [[dict(rep[i], log_tail=log) for rep, log in zip(reports, nccl)]
            for i in range(n_runs)]


# the launched job (distributed_training_launch): two elastic launcher
# processes as two nodes, each running one rank of
# tools/torch_launch_train.py on the card over gloo; node B is SIGKILLed
# once the checkpoint of step LAUNCH_KILL_AFTER is published, and node A
# resumes it at world 1. One save before the kill and none after it: a
# save every 4 steps cost the run a second world-2 save and a world-1 one
# at step 12, about 7 s on the H100
LAUNCH_SAVE_EVERY = 8
LAUNCH_KILL_AFTER = 8
LAUNCH_LOCALSGD_STEPS = 4
LAUNCH_TTL_S = 2.0
LAUNCH_TIMEOUT_S = 420       # the job, start to node A's exit
LAUNCH_PATH = ("training launched by distributed.launch (GPT-350M bf16 "
               "O2, ZeRO-2 at sdp = 2 over gloo, a node killed, resumed "
               "at world 1)")


def _launch_reports(out_dir: str) -> list:
    rows = []
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name)) as f:
            rows += [json.loads(line) for line in f]
    return rows


def _launch_run(cfg, seed: int, ref_path: str, ref_losses, need,
                tmp: str) -> dict:
    """The elastic job of LAUNCH_PATH: its gates (see the module
    docstring, 16) and what it measured."""
    import signal
    import statistics

    from paddle_tpu_torch.distributed.launch import KVServer

    here = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(tmp, "launch_out")
    root = os.path.join(tmp, "launch_ckpt")
    tool = os.path.join(here, "tools", "torch_launch_train.py")
    args = [tool, "--out", out_dir, "--ckpt", root, "--ref", ref_path,
            "--seed", str(seed), "--steps", str(len(ref_losses)),
            "--save-every", str(LAUNCH_SAVE_EVERY), "--layers",
            str(cfg.num_layers), "--batch", str(HF_BATCH), "--seq",
            str(HF_SEQ), "--localsgd-steps", str(LAUNCH_LOCALSGD_STEPS)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t_start = time.time()
    procs, logs = [], []
    with KVServer(0, host="127.0.0.1") as server:
        common = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
                  "--nnodes", "1:2", "--nproc_per_node", "1", "--master",
                  f"127.0.0.1:{server.port}", "--job_id", "smoke",
                  "--elastic_ttl", str(LAUNCH_TTL_S)]
        try:
            for node in ("a", "b"):
                log = open(os.path.join(tmp, f"launcher_{node}.log"), "w+")
                logs.append(log)
                procs.append(subprocess.Popen(
                    common + ["--node_rank", "1" if node == "a" else "2",
                              "--log_dir", os.path.join(tmp, f"logs_{node}")]
                    + args, stdout=log, stderr=subprocess.STDOUT, text=True,
                    cwd=here, env=env, start_new_session=True))
            deadline = time.monotonic() + LAUNCH_TIMEOUT_S
            published = os.path.join(root, f"step_{LAUNCH_KILL_AFTER}")
            while not os.path.isdir(published):
                if time.monotonic() > deadline or any(
                        p.poll() is not None for p in procs):
                    raise AssertionError(
                        f"{LAUNCH_PATH}: step_{LAUNCH_KILL_AFTER} was never "
                        f"published at world 2")
                time.sleep(0.05)
            t_kill = time.time()
            os.killpg(procs[1].pid, signal.SIGKILL)   # node B: lost
            procs[0].wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                p.wait(timeout=60)
    texts = []
    for log in logs:
        log.seek(0)
        texts.append(log.read())
        log.close()
    if procs[0].returncode != 0:
        raise AssertionError(f"{LAUNCH_PATH}: node A exited "
                             f"{procs[0].returncode}\n{texts[0][-4000:]}")
    if "membership changed; resizing" not in texts[0]:
        raise AssertionError(f"{LAUNCH_PATH}: node A never resized\n"
                             f"{texts[0][-4000:]}")
    rows = _launch_reports(out_dir)
    two = [r for r in rows if r["world"] == 2]
    one = [r for r in rows if r["world"] == 1]

    def event(rs, name, rank=None):
        got = [r for r in rs if r["event"] == name
               and (rank is None or r["rank"] == rank)]
        if not got:
            raise AssertionError(f"{LAUNCH_PATH}: no {name!r} event"
                                 + (f" from rank {rank}" if rank is not None
                                    else ""))
        return got

    checks = [event(two, "collectives", r)[0]["checks"] for r in (0, 1)]
    sgd = [event(two, "localsgd", r)[0]["rows"] for r in (0, 1)]
    if [x["equal"] for x in sgd[0]] != [False, True, False, True]:
        raise AssertionError(f"{LAUNCH_PATH}: LocalSGD checksums {sgd[0]}")
    # rank 0's single-process replay of the segment (the tool gates on it)
    replay = event(two, "localsgd_reference", 0)[0]
    sgd_launches = [event(two, "localsgd_done", r)[0]["launches"]
                    for r in (0, 1)]
    want_sgd = [LAUNCH_LOCALSGD_STEPS * n for n in need]
    if any(got != want_sgd for got in sgd_launches):
        raise AssertionError(f"{LAUNCH_PATH}: LocalSGD launches "
                             f"{sgd_launches}, expected {want_sgd}")
    restore = event(one, "restore")[0]
    if not restore["bit_equal"] or restore["step"] != LAUNCH_KILL_AFTER \
            or restore["written_on"]["axes"] != {"sdp": 2} \
            or restore["mesh"] != {"sdp": 1}:
        raise AssertionError(f"{LAUNCH_PATH}: restore {restore}")
    steps = event(two, "step") + event(one, "step")
    for r in steps:
        if r["launches"] != list(need):
            raise AssertionError(f"{LAUNCH_PATH}: rank {r['rank']} world "
                                 f"{r['world']} step {r['step']}: launches "
                                 f"{r['launches']}, expected {list(need)}")
    loss_err = max(abs(r["loss"] - ref_losses[r["step"]])
                   / abs(ref_losses[r["step"]]) for r in steps)
    done = event(one, "done")[0]
    resumed = event(one, "step")
    if [r["step"] for r in resumed] != list(range(LAUNCH_KILL_AFTER,
                                                  len(ref_losses))):
        raise AssertionError(f"{LAUNCH_PATH}: world-1 steps "
                             f"{[r['step'] for r in resumed]}")
    if loss_err > DIST_LOSS_RTOL \
            or done["update_err_worst_leaf"] > DIST_UPDATE_RTOL \
            or done["update_err_model"] > DIST_UPDATE_MODEL_RTOL:
        raise AssertionError(
            f"{LAUNCH_PATH}: losses' max rel error {loss_err} (limit "
            f"{DIST_LOSS_RTOL}), update error {done['update_err_worst_leaf']}"
            f" at {done['worst_leaf']} (limit {DIST_UPDATE_RTOL}), the "
            f"model's {done['update_err_model']} (limit "
            f"{DIST_UPDATE_MODEL_RTOL})")
    saves = event(two, "save")
    boots = event(rows, "boot")
    return dict(
        path=LAUNCH_PATH, seconds=time.time() - t_start,
        collective_checks=checks, localsgd=sgd[0],
        localsgd_launches=sgd_launches[0],
        localsgd_seconds=event(two, "localsgd_done", 0)[0]["seconds"],
        localsgd_replay={k: replay[k] for k in (
            "loss_max_rel_err", "update_err_worst_leaf", "worst_leaf",
            "update_err_model", "master_max_abs_err", "seconds")},
        boot_seconds={f"w{r['world']}_r{r['rank']}": r["seconds"]
                      for r in boots},
        built_seconds={f"w{r['world']}_r{r['rank']}": r["seconds"]
                       for r in event(rows, "built")},
        # seconds the step waited (the host copies); the files are
        # written on the save's thread, joined at the end (final_wait_s)
        saves=[dict(step=r["step"], rank=r["rank"], seconds=r["seconds"],
                    bytes=r["bytes"]) for r in saves],
        final_wait_s=event(one, "done")[0]["wait_seconds"],
        restore=dict(step=restore["step"], seconds=restore["seconds"],
                     verify_seconds=restore["verify_seconds"],
                     bytes_read=restore["bytes_read"],
                     peak_resident_bytes=restore["peak_resident_bytes"],
                     shard_files_checked=restore["shard_files_checked"],
                     bit_equal=restore["bit_equal"],
                     written_on=restore["written_on"], mesh=restore["mesh"]),
        resize_s=resumed[0]["wall"] - t_kill,
        # the launcher's part (lease, resize, a new worker) and the new
        # worker's (boot, build, restore, checks) of resize_s
        relaunch_s=event(one, "boot")[0]["started"] - t_kill,
        worker_to_first_step_s=resumed[0]["wall"]
        - event(one, "boot")[0]["started"],
        # each incarnation's events, seconds after its worker started
        timelines={f"w{b['world']}_r{b['rank']}": {
            r["event"] + (str(r["step"]) if r["event"] == "step" else ""):
            r["time"] - b["started"] for r in rows
            if (r["world"], r["rank"]) == (b["world"], b["rank"])}
            for b in boots},
        losses={f"w{r['world']}_r{r['rank']}_s{r['step']}": r["loss"]
                for r in steps},
        loss_max_rel_err=loss_err,
        step_ms_median={f"w{w}": 1e3 * statistics.median(
            r["seconds"] for r in steps if r["world"] == w) for w in (1, 2)},
        launches_per_step=list(need),
        peak_gib={f"w{r['world']}_r{r['rank']}": r["peak_gib"]
                  for r in steps},
        update_err_worst_leaf=done["update_err_worst_leaf"],
        worst_leaf=done["worst_leaf"],
        update_err_model=done["update_err_model"],
        launcher_a_tail=texts[0].splitlines()[-6:])


def phase_distributed_training(seed: int) -> dict:
    """See the module docstring (14)."""
    import tempfile

    from paddle_tpu_torch.models.gpt import gpt_flops_per_token

    leftover = _check_freed("distributed_training")
    cfg = _primary_config(num_layers=DIST_LAYERS)
    tmp = tempfile.mkdtemp(prefix="dist_smoke_")
    out = dict(model="bench_gpt_primary GPT-350M bf16 O2", path=DIST_PATH,
               batch=[HF_BATCH, HF_SEQ], layers=cfg.num_layers,
               reduced=f"num_layers 24 -> {DIST_LAYERS} (time)",
               backend=DIST_BACKEND, card=nvidia_smi_line(),
               leftover_gib_at_start=leftover,
               tolerances=dict(loss_rtol=DIST_LOSS_RTOL,
                               update_rtol=DIST_UPDATE_RTOL,
                               update_model_rtol=DIST_UPDATE_MODEL_RTOL))
    try:
        ref_path = os.path.join(tmp, "reference.pt")
        # the NCCL pair needs no reference: it starts while the yardstick
        # trains
        pair = _start_world("nccl_two_ranks", 2, ref_path, seed, tmp)
        t0 = time.perf_counter()
        ref = _dist_reference(cfg, seed, ref_path)
        out["reference"] = dict(losses=ref["losses"],
                                seconds=time.perf_counter() - t0)
        out["nccl_world1"] = _nccl_world_of_one()
        two = _join_world(pair, timeout=DIST_NCCL_TIMEOUT_S, may_hang=True)
        out["nccl_two_ranks_on_one_device"] = [
            dict(ok=r["ok"], hung=r.get("hung", False),
                 error=r.get("error"), nccl_log=r["log_tail"])
            for r in two[0]]
        emit("distributed_training_nccl", world1=out["nccl_world1"],
             two_ranks_on_one_device=out["nccl_two_ranks_on_one_device"])
        need = _need(**{k: DIST_LAYERS for k in HF_NEED})
        flops = gpt_flops_per_token(cfg, HF_SEQ)
        # one pair of rank processes runs the three, one after the other
        labels = ",".join(r[0] for r in DIST_RUNS)
        runs = _join_world(_start_world(labels, 2, ref_path, seed, tmp))
        for (label, mesh, options, fwd_case, bwd_case), ranks in zip(
                DIST_RUNS, runs):
            for rep in ranks:
                rep.pop("log_tail", None)
                if any(c != list(need) for c in rep["per_step"]):
                    raise AssertionError(
                        f"{label} rank {rep['rank']}: launches per step "
                        f"{_COUNT_NAMES} {rep['per_step']}, expected {need}")
                if rep["backend"] != DIST_BACKEND:
                    raise AssertionError(f"{label}: backend {rep['backend']}")
            r0 = ranks[0]
            if r0["loss_max_rel_err"] > DIST_LOSS_RTOL \
                    or r0["update_err_worst_leaf"] > DIST_UPDATE_RTOL \
                    or r0["update_err_model"] > DIST_UPDATE_MODEL_RTOL:
                raise AssertionError(
                    f"{label}: losses {r0['losses']} against "
                    f"{r0['ref_losses']} (max rel {r0['loss_max_rel_err']}, "
                    f"limit {DIST_LOSS_RTOL}), update error "
                    f"{r0['update_err_worst_leaf']} at {r0['worst_leaf']} "
                    f"(limit {DIST_UPDATE_RTOL}), the model's "
                    f"{r0['update_err_model']} (limit "
                    f"{DIST_UPDATE_MODEL_RTOL})")
            for rep in ranks:
                rep.pop("per_step")
                # the two ranks together take the global batch a step
                rep["mfu_of_one_card"] = (rep["tokens_per_s"] * flops
                                          / PEAK_BF16_TC_FLOPS)
            out[label] = dict(mesh=mesh, options=options, ranks=ranks,
                              attention_fwd_case=fwd_case,
                              attention_bwd_case=bwd_case,
                              seconds=r0["run_s"])
            emit(f"distributed_training_{label}", **out[label])
        # the same model launched as an elastic job, a node lost mid-run
        out["launch"] = _launch_run(cfg, seed, ref_path, ref["losses"], need,
                                    tmp)
        emit("distributed_training_launch", card=nvidia_smi_line(),
             **out["launch"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("distributed_training", **out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels-only", action="store_true",
                    help="run phases 1-3 and stop, printing no result "
                         "line, with a register spill reported but not "
                         "fatal: to compare kernel builds in turns, each "
                         "from its own checkout")
    ap.add_argument("--only", choices=("inference_export",
                                       "distributed_training"),
                    help="build the kernels and run this phase alone, "
                         "printing its line and no result line")
    ap.add_argument("--fleet-child", nargs=3,
                    metavar=("WEIGHTS", "ENDPOINT", "DEVICE"),
                    help=argparse.SUPPRESS)   # fleet_serving's child
    ap.add_argument("--replica-child", nargs=3,
                    metavar=("WEIGHTS", "ENDPOINT", "DEVICE"),
                    help=argparse.SUPPRESS)   # fleet_serving's scale-out
    ap.add_argument("--dist-child", nargs=2, metavar=("RUNS", "REFERENCE"),
                    help=argparse.SUPPRESS)   # a distributed_training rank
    args = ap.parse_args(argv)
    if args.fleet_child:
        return fleet_child(*args.fleet_child)
    if args.replica_child:
        return replica_child(*args.replica_child)
    if args.dist_child:
        return dist_child(*args.dist_child)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    from paddle_tpu_torch import default_device

    default_device("cuda")  # pins float32 matmul precision (no TF32)
    card = nvidia_smi_line()
    emit("device", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    ptxas = phase_build(args.seed, fail_on_spill=not args.kernels_only)
    if args.only:
        globals()[f"phase_{args.only}"](args.seed)
        return 0
    if not args.kernels_only:
        # g++ on a thread while the card runs the kernel phases
        _start_native_build()
    fwd = phase_kernels(args.seed)
    bwd = phase_backward(args.seed)
    phase_dropout(args.seed)
    if args.kernels_only:
        return 0
    serve = phase_serving(args.seed)
    _free()
    options = phase_serving_options(args.seed)
    _free()
    spec = phase_speculative(args.seed)
    _free()
    preset, yard = phase_serve_preset(args.seed)
    fleet = phase_fleet_serving(args.seed, yard)
    del yard
    _free()
    train = phase_training(args.seed)
    _free()
    fp16 = phase_fp16_training(args.seed, train)
    _free()
    phase_fp16_step(args.seed)
    _free()
    parity = phase_train_parity(args.seed)
    _free()
    phase_dropout_replay(args.seed)
    _free()
    d256 = phase_d256_step(args.seed)
    _free()
    d256_fp16 = phase_d256_fp16_step(args.seed)
    _free()
    d256_f32 = phase_d256_f32(args.seed)
    _free()
    d256_prefill = phase_d256_prefill(args.seed)
    _free()
    tbase = phase_transformer_base(args.seed)
    _free()
    sdpa = phase_sdpa_routes(args.seed)
    _free()
    phase_bert_base(args.seed)
    _free()
    phase_resnet50_training(args.seed)
    _free()
    phase_vision_zoo(args.seed)
    _free()
    phase_detection_training(args.seed)
    _free()
    phase_ocr_training(args.seed)
    _free()
    phase_ps_ctr_training(args.seed)
    _free()
    phase_graph_training(args.seed)
    _free()
    hapi_gpt = phase_hapi_gpt_fit(args.seed)
    _free()
    lora_fit = phase_lora_fit(args.seed, full=hapi_gpt)
    _free()
    lora_serve = phase_lora_serving(args.seed)
    _free()
    phase_hapi_bert_fit(args.seed)
    _free()
    eager_gpt = phase_eager_training(args.seed)
    _free()
    infer = phase_inference_export(args.seed)
    _free()
    dist = phase_distributed_training(args.seed)
    _free()
    llama_serve = phase_llama_serving(args.seed)
    _free()
    llama_train = phase_llama_training(args.seed)
    _free()
    llama_gqa = phase_llama_gqa_grads(args.seed)

    src = "paddle_tpu_torch/kernels/csrc/"
    ref = "paddle_tpu/kernels/flash_attention.py:"

    def fwd_row(name, source, case, launches, path, other=None):
        c = fwd[case]
        # other: a forward the case's route replaced ("fma" or the float16
        # "wgmma_f32"), checked and timed beside it
        f = f"{other}_" if other else ""
        return dict(name=name, route="cuda", source=src + source,
                    replaces=ref + "131", launches=launches, main_path=path,
                    max_abs_err=c[f + "max_abs_err"], ms=c[f + "ms"],
                    ms_range=c[f + "ms_range"], plain_ms=c["plain_ms"],
                    bound_ms=c[f + "bound_ms"], bound_by=c[f + "bound_by"],
                    library_ms=c["library_ms"],
                    library_ms_range=c.get("library_ms_range"),
                    shape=c["shape"], dtype=c.get("dtype", "float32"),
                    causal=c.get("causal"))

    def bwd_row(name, source, which, case, launches, path, other=None):
        c = bwd[case]
        keys = ("dq",) if which == "dq" else ("dk", "dv")
        # other: a kernel the case's route replaced ("fma" or the float16
        # "wgmma_f32"), checked and timed beside it
        errs = c[f"{other}_errors"] if other else c["errors"]
        f = f"{which}_{other}" if other else which
        row = dict(name=name, route="cuda", source=src + source,
                   replaces=ref + ("198" if which == "dq" else "269"),
                   launches=launches, main_path=path,
                   max_abs_err=max(errs[k]["max_abs_err"] for k in keys),
                   ms=c[f"{f}_ms"], ms_range=c[f"{f}_ms_range"],
                   plain_ms=c["plain_ms"], bound_ms=c[f"{f}_bound_ms"],
                   bound_by=c[f"{f}_bound_by"],
                   library_ms=c["library_ms"], shape=c["shape"],
                   dtype=c["dtype"], causal=c["causal"])
        return row

    def with_ptxas(row, source, which):
        """``row`` with the registers and spills of each instantiation of
        ``which``'s kernel in ``source`` (with and without dropout)."""
        row["ptxas"] = [k for k in ptxas[source]
                        if f"_{which}_" in k["kernel"]]
        return row

    step = "training (bf16 O2 step)"
    f32_step = "training (float32 parity run)"
    prefill = "serving (float32 prefill)"
    options_path = ("serving options (gpt_1p3b float32 prefill: int8 cache, "
                    "warmup, fair queueing)")
    spec_path = "speculative (gpt_1p3b target and draft float32 prefills)"
    preset_path = ("serve preset (h1024, float32 prefill at D = 64, int8 "
                   "cache, pool-less)")
    d256_step = "training (bf16 O2 step, D = 256, 2 layers)"
    d256_prefill_path = "serving (float32 prefill, D = 256, 2 layers)"
    d256_f32_path = "training (float32 parity run, D = 256, 2 layers)"
    d256_fp16_path = "training (float16 O2 step, D = 256, 2 layers)"
    d256_counts = d256["launches"]
    kernels = [
        fwd_row("flash_attention_fwd_f32_sm90",
                "flash_attention_fwd_f32_sm90.cu", "prefill_f32_L2048",
                serve["flash_launches"], prefill),
        fwd_row("split_bf16_terms", "flash_attention_fwd_f32_sm90.cu",
                "split_prefill_f32_L2048", serve["split_launches"], prefill),
        # the serving options' pool-less admits (the int8 server, warmup,
        # the fair-queueing run) and the speculative prefills, at D = 128;
        # pooled admits and speculative rounds launch none
        fwd_row("flash_attention_fwd_f32_sm90_serving_options",
                "flash_attention_fwd_f32_sm90.cu", "prefill_f32_L2048",
                options["flash_launches"], options_path),
        fwd_row("split_bf16_terms_serving_options",
                "flash_attention_fwd_f32_sm90.cu", "split_prefill_f32_L2048",
                options["split_launches"], options_path),
        fwd_row("flash_attention_fwd_f32_sm90_speculative",
                "flash_attention_fwd_f32_sm90.cu", "prefill_f32_L1024",
                spec["flash_launches"], spec_path),
        fwd_row("split_bf16_terms_speculative",
                "flash_attention_fwd_f32_sm90.cu", "split_prefill_f32_L1024",
                spec["split_launches"], spec_path),
        # the serve preset's pool-less prefills: float32 at D = 64
        fwd_row("flash_attention_fwd_f32_sm90_d64",
                "flash_attention_fwd_f32_sm90.cu", PRESET_FWD,
                preset["flash_launches"], preset_path),
        fwd_row("split_bf16_terms_d64", "flash_attention_fwd_f32_sm90.cu",
                "split_" + PRESET_FWD, preset["split_launches"], preset_path),
        # the fleet's two pool-less replicas behind ReplicaRouter (the
        # serve preset's D = 64 prefills again, 24 a prefill)
        fwd_row("flash_attention_fwd_f32_sm90_d64_fleet",
                "flash_attention_fwd_f32_sm90.cu", PRESET_FWD,
                fleet["flash_launches"], FLEET_PATH),
        fwd_row("split_bf16_terms_d64_fleet",
                "flash_attention_fwd_f32_sm90.cu", "split_" + PRESET_FWD,
                fleet["split_launches"], FLEET_PATH),
        fwd_row("flash_attention_fwd_f32_sm90_d256",
                "flash_attention_fwd_f32_sm90.cu", D256_PREFILL_FWD,
                d256_prefill["flash_launches"], d256_prefill_path),
        # no route takes the FMA forward since every head dim runs on the
        # tensor cores: 0 launches on a path, checked and timed beside the
        # wgmma_f32 forward at [1, 8, 1024, 256]
        fwd_row("flash_attention_fwd", "flash_attention_fwd.cu",
                "d256_causal_f32_L1024", 0, None, other="fma"),
        fwd_row("flash_attention_fwd_sm90", "flash_attention_fwd_sm90.cu",
                "train_bf16_B2_L1024", train["launches"]["fwd_wgmma"], step),
        fwd_row("flash_attention_fwd_sm90_d256", "flash_attention_fwd_sm90.cu",
                D256_STEP_FWD, d256_counts["fwd_wgmma"], d256_step),
        # no route takes the FMA dQ and dK/dV since every head dim runs on
        # the tensor cores: 0 launches on a path, checked and timed beside
        # the wgmma_f32 pair at [1, 8, 1024, 256]
        bwd_row("flash_attention_bwd_dq", "flash_attention_bwd.cu", "dq",
                "d256_causal_float32_B1_L1024", 0, None, other="fma"),
        bwd_row("flash_attention_bwd_dq_bf16_d256",
                "flash_attention_bwd_dq_sm90.cu", "dq", D256_STEP_BWD,
                d256_counts["dq_wgmma"], d256_step),
        bwd_row("flash_attention_bwd_dq_sm90",
                "flash_attention_bwd_dq_sm90.cu", "dq",
                "train_bfloat16_B2_L1024", train["launches"]["dq_wgmma"],
                step),
        bwd_row("flash_attention_bwd_dq_f32_sm90",
                "flash_attention_bwd_f32_sm90.cu", "dq",
                "train_float32_B2_L1024", parity["launches"]["dq_wgmma_f32"],
                f32_step),
        bwd_row("flash_attention_bwd_dkv", "flash_attention_bwd.cu", "dkv",
                "d256_causal_float32_B1_L1024", 0, None, other="fma"),
        bwd_row("flash_attention_bwd_dkv_sm90",
                "flash_attention_bwd_dkv_sm90.cu", "dkv",
                "train_bfloat16_B2_L1024", train["launches"]["dkv_wgmma"],
                step),
        bwd_row("flash_attention_bwd_dkv_sm90_d256",
                "flash_attention_bwd_dkv_sm90.cu", "dkv",
                D256_STEP_BWD, d256_counts["dkv_wgmma"], d256_step),
        bwd_row("flash_attention_bwd_dkv_f32_sm90",
                "flash_attention_bwd_f32_sm90.cu", "dkv",
                "train_float32_B2_L1024", parity["launches"]["dkv_wgmma_f32"],
                f32_step),
        # bench_gpt_primary's attention, [8, 16, 1024, 64] bf16, on the fit
        # loop's path (hapi_gpt_fit's timed fit: 24 of each a step)
        fwd_row("flash_attention_fwd_sm90_d64", "flash_attention_fwd_sm90.cu",
                HF_FWD_CASE, hapi_gpt["launches"]["fwd_wgmma"], HF_PATH),
        bwd_row("flash_attention_bwd_dq_sm90_d64",
                "flash_attention_bwd_dq_sm90.cu", "dq", HF_BWD_CASE,
                hapi_gpt["launches"]["dq_wgmma"], HF_PATH),
        bwd_row("flash_attention_bwd_dkv_sm90_d64",
                "flash_attention_bwd_dkv_sm90.cu", "dkv", HF_BWD_CASE,
                hapi_gpt["launches"]["dkv_wgmma"], HF_PATH),
        # the same attention on the dygraph loop's path (eager_training:
        # 24 of each an eager step)
        fwd_row("flash_attention_fwd_sm90_d64_eager",
                "flash_attention_fwd_sm90.cu", HF_FWD_CASE,
                eager_gpt["launches"]["fwd_wgmma"], EAGER_PATH),
        bwd_row("flash_attention_bwd_dq_sm90_d64_eager",
                "flash_attention_bwd_dq_sm90.cu", "dq", HF_BWD_CASE,
                eager_gpt["launches"]["dq_wgmma"], EAGER_PATH),
        bwd_row("flash_attention_bwd_dkv_sm90_d64_eager",
                "flash_attention_bwd_dkv_sm90.cu", "dkv", HF_BWD_CASE,
                eager_gpt["launches"]["dkv_wgmma"], EAGER_PATH),
        # the same attention served from GPT-350M's saved program
        # (inference_export: 24 a run at each shape)
        *[fwd_row(f"flash_attention_fwd_sm90_d64_infer_B{B}_L{L}",
                  "flash_attention_fwd_sm90.cu", INFER_FWD_CASES[(B, L)],
                  infer["runs"][f"B{B}_L{L}"]["launches"]["fwd_wgmma"],
                  INFER_PATH)
          for B, L in INFER_SHAPES],
        # the same attention on the adapter fit's path (lora_fit: 24 of
        # each a step, the gradient reaching the qkv_proj adapters)
        fwd_row("flash_attention_fwd_sm90_d64_lora_fit",
                "flash_attention_fwd_sm90.cu", HF_FWD_CASE,
                lora_fit["launches"]["fwd_wgmma"], LORA_FIT_PATH),
        bwd_row("flash_attention_bwd_dq_sm90_d64_lora_fit",
                "flash_attention_bwd_dq_sm90.cu", "dq", HF_BWD_CASE,
                lora_fit["launches"]["dq_wgmma"], LORA_FIT_PATH),
        bwd_row("flash_attention_bwd_dkv_sm90_d64_lora_fit",
                "flash_attention_bwd_dkv_sm90.cu", "dkv", HF_BWD_CASE,
                lora_fit["launches"]["dkv_wgmma"], LORA_FIT_PATH),
        # one rank's attention in each world-2 run (distributed_training:
        # rank 0's launches over the run's 13 steps, 24 of each a step)
        *[row for label, _, _, fwd_case, bwd_case in DIST_RUNS
          for row in (
              fwd_row(f"flash_attention_fwd_sm90_d64_{label}",
                      "flash_attention_fwd_sm90.cu", fwd_case,
                      dist[label]["ranks"][0]["launches"]["fwd_wgmma"],
                      f"{DIST_PATH}: {label}"),
              bwd_row(f"flash_attention_bwd_dq_sm90_d64_{label}",
                      "flash_attention_bwd_dq_sm90.cu", "dq", bwd_case,
                      dist[label]["ranks"][0]["launches"]["dq_wgmma"],
                      f"{DIST_PATH}: {label}"),
              bwd_row(f"flash_attention_bwd_dkv_sm90_d64_{label}",
                      "flash_attention_bwd_dkv_sm90.cu", "dkv", bwd_case,
                      dist[label]["ranks"][0]["launches"]["dkv_wgmma"],
                      f"{DIST_PATH}: {label}"))],
        # the serve preset's float32 D = 64 prefill with the adapters
        # (lora_serving's pool-less run, 12 of the 24 layers: 12 of each a
        # prefill)
        fwd_row("flash_attention_fwd_f32_sm90_d64_lora_serving",
                "flash_attention_fwd_f32_sm90.cu", PRESET_FWD,
                lora_serve["flash_launches"], LORA_SERVE_PATH),
        fwd_row("split_bf16_terms_d64_lora_serving",
                "flash_attention_fwd_f32_sm90.cu", "split_" + PRESET_FWD,
                lora_serve["split_launches"], LORA_SERVE_PATH),
        bwd_row("flash_attention_bwd_dq_f32_sm90_d256",
                "flash_attention_bwd_f32_d256_sm90.cu", "dq", D256_F32_BWD,
                d256_f32["launches"]["dq_wgmma_f32"], d256_f32_path),
        bwd_row("flash_attention_bwd_dkv_f32_sm90_d256",
                "flash_attention_bwd_f32_d256_sm90.cu", "dkv", D256_F32_BWD,
                d256_f32["launches"]["dkv_wgmma_f32"], d256_f32_path),
    ]
    # float16: the wgmma_f16 forward, dQ and dK/dV at the GPT step's
    # attention on the float16 O2 step's path, and at D = 256 on the
    # float16 D = 256 step's; Llama's shape and D = 64 on no path (no Llama
    # phase trains in float16); the float16 wgmma_f32 kernels the wgmma_f16
    # ones replaced, and the forward's split, on no path since, checked and
    # timed beside them at both training shapes and at D = 256
    fp16_path = "training (float16 O2 step, GradScaler)"
    kernels += [
        fwd_row("flash_attention_fwd_f16_sm90",
                "flash_attention_fwd_f16_sm90.cu", F16_TRAIN_FWD,
                fp16["launches"]["fwd_wgmma_f16"], fp16_path),
        fwd_row("flash_attention_fwd_f16_sm90_llama_shape",
                "flash_attention_fwd_f16_sm90.cu", F16_LLAMA_FWD, 0, None),
        fwd_row("flash_attention_fwd_f16_sm90_d64",
                "flash_attention_fwd_f16_sm90.cu", "d64_causal_f16_B2_L1024",
                0, None),
        fwd_row("flash_attention_fwd_f16_sm90_d256",
                "flash_attention_fwd_f16_sm90.cu", D256_FP16_STEP_FWD,
                d256_fp16["launches"]["fwd_wgmma_f16"], d256_fp16_path),
        fwd_row("flash_attention_fwd_f32_sm90_f16",
                "flash_attention_fwd_f32_sm90.cu", F16_TRAIN_FWD,
                fp16["launches"]["fwd_wgmma_f32"], None, other="wgmma_f32"),
        fwd_row("split_bf16_terms_f16", "flash_attention_fwd_f32_sm90.cu",
                "split_" + F16_TRAIN_FWD, fp16["split_launches"], None),
        bwd_row("flash_attention_bwd_dq_f16_sm90",
                "flash_attention_bwd_f16_sm90.cu", "dq", F16_TRAIN_BWD,
                fp16["launches"]["dq_wgmma_f16"], fp16_path),
        bwd_row("flash_attention_bwd_dkv_f16_sm90",
                "flash_attention_bwd_f16_sm90.cu", "dkv", F16_TRAIN_BWD,
                fp16["launches"]["dkv_wgmma_f16"], fp16_path),
        bwd_row("flash_attention_bwd_dq_f32_sm90_f16",
                "flash_attention_bwd_f32_sm90.cu", "dq", F16_TRAIN_BWD, 0,
                None, other="wgmma_f32"),
        bwd_row("flash_attention_bwd_dkv_f32_sm90_f16",
                "flash_attention_bwd_f32_sm90.cu", "dkv", F16_TRAIN_BWD, 0,
                None, other="wgmma_f32"),
        fwd_row("flash_attention_fwd_f32_sm90_f16_llama_shape",
                "flash_attention_fwd_f32_sm90.cu", F16_LLAMA_FWD, 0, None,
                other="wgmma_f32"),
        fwd_row("split_bf16_terms_f16_llama_shape",
                "flash_attention_fwd_f32_sm90.cu", "split_" + F16_LLAMA_FWD,
                0, None),
        bwd_row("flash_attention_bwd_dq_f32_sm90_d256_f16",
                "flash_attention_bwd_f32_d256_sm90.cu", "dq",
                "d256_causal_float16_B1_L1024", 0, None, other="wgmma_f32"),
        bwd_row("flash_attention_bwd_dkv_f32_sm90_d256_f16",
                "flash_attention_bwd_f32_d256_sm90.cu", "dkv",
                "d256_causal_float16_B1_L1024", 0, None, other="wgmma_f32")]
    # the wgmma_f16 dQ and dK/dV at D = 256, at the float16 D = 256 step's
    # attention on its path
    for which in ("dq", "dkv"):
        kernels.append(with_ptxas(bwd_row(
            f"flash_attention_bwd_{which}_f16_sm90_d256",
            "flash_attention_bwd_f16_d256_sm90.cu", which, D256_FP16_STEP_BWD,
            d256_fp16["launches"][f"{which}_wgmma_f16"], d256_fp16_path),
            "flash_attention_bwd_f16_d256_sm90.cu", which))
    for which in ("dq", "dkv"):
        kernels += [
            bwd_row(f"flash_attention_bwd_{which}_f16_sm90_llama_shape",
                    "flash_attention_bwd_f16_sm90.cu", which, F16_LLAMA_BWD,
                    0, None),
            bwd_row(f"flash_attention_bwd_{which}_f32_sm90_f16_llama_shape",
                    "flash_attention_bwd_f32_sm90.cu", which, F16_LLAMA_BWD,
                    0, None, other="wgmma_f32")]
    # Llama-2-7B's attention, [1, 32, 4096, 128] causal, per Llama path
    llama_prefill = "serving (llama2_7b float32 prefill)"
    kernels += [
        fwd_row("flash_attention_fwd_f32_sm90_llama",
                "flash_attention_fwd_f32_sm90.cu", LLAMA_PREFILL_FWD,
                llama_serve["flash_launches"], llama_prefill),
        fwd_row("split_bf16_terms_llama", "flash_attention_fwd_f32_sm90.cu",
                "split_" + LLAMA_PREFILL_FWD, llama_serve["split_launches"],
                llama_prefill)]
    for suffix, run, path in (
            ("llama", llama_train,
             f"training (llama2_7b bf16 O2 step, {LLAMA_TRAIN_LAYERS} layers)"),
            ("llama_gqa", llama_gqa,
             f"training (llama2_7b GQA gradients, {LLAMA_GQA_LAYERS} layers)")):
        counts = run["launches"]
        kernels += [
            fwd_row(f"flash_attention_fwd_sm90_{suffix}",
                    "flash_attention_fwd_sm90.cu", LLAMA_TRAIN_FWD,
                    counts["fwd_wgmma"], path),
            bwd_row(f"flash_attention_bwd_dq_sm90_{suffix}",
                    "flash_attention_bwd_dq_sm90.cu", "dq", LLAMA_TRAIN_BWD,
                    counts["dq_wgmma"], path),
            bwd_row(f"flash_attention_bwd_dkv_sm90_{suffix}",
                    "flash_attention_bwd_dkv_sm90.cu", "dkv", LLAMA_TRAIN_BWD,
                    counts["dkv_wgmma"], path)]
    # the encoder path: each kernel at each of the Transformer-base step's
    # three attention calls (bf16, p = DROPOUT_P, the mask as a bias, no
    # dS), held against its plain version given the same dropout mask
    kfiles = {"fwd": ("flash_attention_fwd_sm90.cu", "131", ("o",)),
              "dq": ("flash_attention_bwd_dq_sm90.cu", "198", ("dq",)),
              "dkv": ("flash_attention_bwd_dkv_sm90.cu", "269", ("dk", "dv"))}
    for call, Lq, Lk, mask_key in TB_ATTENTION:
        errs = sdpa["checks"][f"{call}_bfloat16"]["dropout_errors"]
        for w, (source, line, keys) in kfiles.items():
            t = sdpa["timing"][call][w]
            kernels.append(dict(
                name=f"flash_attention_{w}_sm90_{call}", route="cuda",
                source=src + source, replaces=ref + line,
                launches=tbase["launches_by_shape"][call][w],
                main_path=TB_PATH,
                max_abs_err=max(errs[k]["max_abs_err"] for k in keys),
                ms=t["ms"], ms_range=t["ms_range"], plain_ms=t["plain_ms"],
                bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                library_ms=t["library_ms"], ms_p0=t["ms_p0"],
                shape=[TB_BATCH, TB_HEADS, Lq, Lk, TB_MODEL // TB_HEADS],
                dtype="bfloat16", causal=False, mask=mask_key,
                dropout_p=DROPOUT_P))
    # the dQ kernel writing dS for a trained float mask (sdpa_routes): on
    # no model path of this run
    t = sdpa["timing"]["trained_mask_ds"]
    kernels.append(dict(
        name="flash_attention_bwd_dq_sm90_trained_mask_ds", route="cuda",
        source=src + "flash_attention_bwd_dq_sm90.cu", replaces=ref + "198",
        launches=0, main_path=None,
        max_abs_err=sdpa["checks"][
            f"trained_mask_1x{TB_HEADS}x{TB_SRC}x{TB_SRC}_bfloat16"][
            "errors"]["dmask"]["max_abs_err"],
        ms=t["ms"], ms_range=t["ms_range"], plain_ms=t["plain_ms"],
        bound_ms=t["bound_ms"], bound_by=t["bound_by"],
        library_ms=t["library_ms"], shape=t["shape"], dtype="bfloat16",
        causal=False, mask=t["mask"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
