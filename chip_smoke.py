#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vision_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure:
  1. environment: a CUDA device is required (no CPU continuation); prints the
     card's name and power limit, the torch and CUDA versions, and turns TF32
     off for the f32 comparisons;
  2. build: compiles the hand-written kernel library from the sources in
     vision_tpu_torch/csrc/ (one nvcc per source, in parallel) and prints the
     build seconds and ptxas's registers and spills for every instance;
  3. each kernel against its plain PyTorch version on the card, at the main
     paths' shapes and at edge shapes: flash attention at the token counts
     the Depth-Anything requests reach (depth_tokens of DEPTH_EXTENTS) and
     the vision-bench Depth-Anything rows (BENCH_DEPTH_T, 6 and 12 heads),
     SAM 3's global layers at its published widths, batch 4 ((64, 5184,
     64), also within a relative RMS of FLASH_D80_BF16_REL_RMS), D 32 and
     128, cross attention, Tq and Tk one past a key tile, and f32 cases;
     the window kernel at TinyViT's three stages (bf16 and f32 biases), one
     T > 200 case that reads its mask and bias from L2, and f32 cases; and
     the window kernel's launch plan, the library's against window_plan's,
     at every TinyViT and SWIN-L stage (two waves of the card at least);
  4. the Depth-Anything path: a Depth-Anything-V2-Small GGUF with random
     weights (seed 0) is written, loaded with depthany_load_model and served
     through ImageServer (batch 4): 8 requests in two extent buckets, each
     bucket's CUDA graph captured by a warmup first (a capture's eager
     warm-up forward launches the kernels too); the kernels' launch counts
     are zeroed just before and read just after;
  5. Depth-Anything parity: one request's raw depth on the card (bf16, kernel
     route) against the same port's f32 forward on the CPU (plain route);
  6. Depth-Anything timings, each beside the card name and power limit: the
     flash kernel and its plain version by the card's own time (device_ms:
     back-to-back calls queued behind a spin kernel) and the kernel by CUDA events
     around single calls (median_ms, the host's launch work included); the
     forward by CUDA events; and a torch.profiler trace of a batch-4
     forward (the flash kernel's share);
  7. the MobileSAM path: a mobile-sam GGUF of random_mobile_sam_params(0)
     (full TinyViT-5M) is written, loaded with sam_load_model on the card and
     on the CPU, and 12 requests (6 points, 6 boxes over 1024x1024, 640x480
     and 1600x1200) are served through SamServer (batch 6), the counts zeroed
     just before and read just after;
  8. MobileSAM parity: one request on the card in bf16 (kernel route) against
     the CPU's f32, stage by stage; and the encoder in f32 on the card
     (kernel route, TF32 off) against the CPU's f32;
  9. MobileSAM timings: the window kernel against its plain version (the
     card's own time, and per call with the host's launch work), encode
     img/s over batch, single-mask latency, decode-only, the served numbers
     and the host's pre/post work, each beside the card name and power limit;
 10. the conv3x3 kernel against its plain version: bf16 at the RRDB shapes
     (the five RDB convs, the stem and the last conv at 256x256), f32 edge
     cases (ragged H and W, batch, Cin 3 and 4, Cout 3, one pixel wide);
     then each epilogue and view form the Real-ESRGAN path gives it (conv1-4
     into a channel slice of a 192-channel buffer with leaky ReLU, conv5's
     x + 0.2 * y into the next buffer, RDB3's double residual written over
     its residual, the stem into a buffer, the trunk's skip, hr's leaky ReLU,
     the last conv), in bf16 at 256x256 and in bf16 and f32 at a ragged
     (2, 19, 23), every channel outside the written view checked unchanged;
     and one bf16 input of more than 2^31 elements, (4, 4096, 4096, 64 ->
     64);
 11. the Real-ESRGAN path: an esrgan GGUF of random_esrgan_params(0) (the
     full RealESRGAN-x4 RRDBNet: nf 64, gc 32, 23 blocks) is written, loaded
     with esrgan_load_model on the card and on the CPU, 6 requests (4 at
     256x256, 2 at 320x240) are served through EsrganServer (batch 4), and
     one 640x480 image goes through EsrganModel.compute's tiles, each
     shape's graph captured first, the counts zeroed just before and read
     just after each; per extent, the RGBA graph's replay (the served
     form) equals the RGB replay with alpha 255 bit for bit, and the served
     answers equal it, at the random weights (answers all 0) and again with
     the last conv rescaled so that the answers spread over 0..255;
 12. Real-ESRGAN parity on a crop of one request: the card's bf16 float
     output against the CPU's f32, stage by stage in esrgan_generate's
     structure (each RRDB on its dense-block buffers, the biases, leaky
     ReLUs and residuals in the conv's epilogue); the card's f32 forward
     (kernel route, TF32 off, 351 launches) against the CPU's f32; the
     served u8 against the card's float forward;
 13. Real-ESRGAN timings: the conv kernel at the RDB shapes at 1024x1024 and
     the tail shapes at 4096x4096, with its path's epilogue and views and
     bare, against its plain version and F.conv2d (cuDNN, a yardstick the
     port never calls) with the bound beside each, by the card's own time
     (device_ms) and per call; forward_u8 at 1024x1024 and 512x512 x 4, and
     a profile of the latter that must hold fewer launches of other kernels
     than RRDBs (no elementwise pass per RRDB); the served and tiled
     numbers; and the yardsticks of the attention kernels
     (F.scaled_dot_product_attention, which the port never calls), by the
     card's own time and per call;
 14. the deform kernels against their plain versions: the column sampler
     (csrc/deform_sample.cu, off every served path) in bf16 at the 20 shapes
     of a batch-4 1024x1024 BiRefNet forward (Cin 112; k 1, 1, 3, 7 at
     256^2, 128^2, 64^2 and twice at 32^2; offsets within +-3) and f32 edge
     cases (Cin 5 and 12, stride 2, samples outside the image, bound 2 with
     offsets of +-9, no mask, f16 offsets, one column of more than 2^31
     elements); the fused deformable conv (csrc/deform_conv.cu) at the same
     20 shapes in bf16 with the path's epilogue (bias, BatchNorm, ReLU) into
     28-channel views of a 140-channel buffer (the other channels checked
     unchanged), its bf16 precision at k 7 256^2 against the f32 result
     rounded once, and f32 and bf16 edge cases (Cin 5, 8, 120, 200; Cout 1,
     28, 64, 100; stride 2; samples outside; bound 2 with offsets of +-9; no
     mask; f16 offsets; offsets of +-9 without a bound; more than 2^31
     column elements); and the window
     kernel with SWIN's per-window masks at the SWIN-L stage shapes (T 144,
     heads 6/12/24/48) and SWIN-T's T 49;
 15. the BiRefNet path: a birefnet GGUF of random_birefnet_params("large",
     0) (SWIN-L, 1024x1024) is written, loaded with birefnet_load_model on
     the card and on the CPU, and 8 requests (4 at 1024x1024, 2 at
     1280x720, 2 at 800x600, one extent bucket) are served through
     ImageServer (batch 4), the counts zeroed just before and read just
     after: 48 window launches (24 masked), 20 deform_conv launches and no
     deform_sample launch a batch;
 16. BiRefNet parity at 384x384: the card's bf16 against the CPU's f32,
     stage by stage; the card's f32 forward (kernel routes, TF32 off)
     against the CPU's f32; the served u8 mask against the card's float
     mask;
 17. BiRefNet timings, by the card's own time: the fused deformable conv
     per shape and per forward against its bound, its plain version, the
     yardstick F.grid_sample + mask product + torch.matmul (library calls
     the port never makes) and the parent's route (the column sampler, then
     torch.matmul), and the sampler alone; the masked window kernel against
     SDPA given the combined mask (the card's own time, and per call);
     forward_u8 at 1024x1024 batch 1 and 4 with the peak memory of each
     (the eager forward's: a replay allocates only its output);
     the served numbers; and a torch.profiler trace of a batch-4 forward;
 18. the flash kernel's head-dim-80 instance against its plain version, in
     bf16 and f32: SAM3's global layers at batch 1 and 4 ((16 or 64, 5184,
     80)), a ragged cross case (Tq 1000, Tk 1300) and one past a tile;
     bf16 within BF16_MAX_ABS and a relative RMS of FLASH_D80_BF16_REL_RMS;
 19. the SAM3 path: a sam3 GGUF in f16 (random_sam3_vision_params(0), the
     ViT-H RoPE encoder at 1008 px with its FPN neck, under det.ve.; the
     CLIP text encoder of sam3_text_params, under det.te.; a synthetic
     49408-token vocabulary; ~2 GB, deleted after loading) is loaded with
     sam3_load_model on the card and on the CPU; the card model's window
     stack is built (allocated MiB before, after and at the peak: the flat
     window copies freed); encode_vision (the window-major trunk) runs on a
     1008x1008 and a 1600x1200 image (the four FPN levels' shapes, finite,
     4 flash launches each and no other hand-written kernel, the counts
     zeroed just before and read just after each) and encode_text on 4
     prompts ((1, 32, 1024), finite, no hand-written kernel);
 20. SAM3 parity, on the window-major trunk: the first two layers (one
     window, one global at T 5184) and the neck at 1008x1008, card f32
     (TF32 off) and card bf16 against the CPU's f32; encode_text card bf16
     against the CPU's f32; the full depth card bf16 against card f32,
     beside the same with the global layers on the kernel's plain version;
 21. SAM3 timings: the D-80 kernel against its plain version, SDPA and the
     bound by the card's own time; host prep per request; Sam3Model's
     encode_vision p50; the encode_vision function at batch 1 and 4 (ms,
     img/s, TFLOP/s from sam3_vision_flops); encode_text p50; a
     torch.profiler trace of a batch-1 encode_vision; and one window layer
     (window-major and spatial) and one global layer with their parts (the
     spatial trunk's window partition and reverse, RoPE, the weight
     products) by the card's own time;
 22. the conv3x3 kernel with YOLOv9t's epilogue forms against its plain
     version: every distinct stride-1 3x3 call of a batch-8 640x640
     forward (recorded from the eager forward itself: Cin and Cout 16 to 128,
     Cout 80 in 32-channel splits, at 160^2, 80^2, 40^2 and 20^2) in bf16
     with its BN + SiLU, the RepConv's 1x1 branch as r1, the shortcut as
     r2 and the views it reads and writes (channels outside the written
     view checked unchanged); ragged f32 and bf16 cases;
 23. the YOLOv9t path: a yolov9t GGUF of random_yolov9t_params(0) is
     written, loaded with yolov9t_load_model on the card and on the CPU,
     and 16 requests (4 each at 640x480, 1280x720, 500x375 and 640x640, one
     letterboxed 640^2 bucket) are served through YoloServer (batch 8), the
     counts zeroed just before and read just after: 112 conv3x3 launches a
     forward and no other hand-written kernel;
 24. YOLOv9t parity on one request: the detect inputs f[15], f[18], f[21]
     and the raw boxes and scores, card bf16 and card f32 (TF32 off)
     against the CPU's f32; NMS on the card's f32 outputs against NMS on
     the CPU's;
 25. the MI-GAN path: a migan GGUF of random_migan_params(512, 0) is
     loaded on the card and the CPU, 8 (image, mask) requests (4 at
     512x512, 2 at 1024x768, 2 RGBA at 640x480) are served through
     ImageServer (batch 4) with no hand-written kernel launch; one
     request's raw output, card bf16 and f32 against the CPU's f32;
 26. YOLOv9t and MI-GAN timings: the conv kernel at each YOLOv9t call by
     the card's own time beside its bound, its plain version and the
     yardstick F.conv2d + BN + SiLU (+ add), and the sums over a forward's
     112 convs; YOLOv9t forward_u8 at 640x640 batch 1 and 8; a profile of
     the batch-8 forward; the host's letterbox and NMS per request; the
     served numbers; MI-GAN forward_u8 at 512x512 batch 1 and 4, a
     profile, and the served numbers;
 27. CUDA graphs (core/graph.py): the six families' random full-width GGUFs
     are written once (the writers above) and loaded with load_model; each
     of the five graphed forward_u8s (Depth-Anything 518^2, BiRefNet 1024^2,
     Real-ESRGAN 256^2 with its float output, MI-GAN 512^2, YOLOv9t 640^2),
     at its server's batch and then at batch 1: the replay against the eager
     forward (_forward_u8; max abs difference, 0 expected), the first
     call's ms (eager warm-up, capture, replay) and launches (twice a
     forward's), the graph pool's MiB before and after the capture beside
     the eager forward's peak allocation and its memory in a fresh pool of
     its own (the second capture must grow the shared pool by less than
     its eager peak), the median ms of eager and replay, and a profile of
     one replay (device busy, idle share of the replay median, launches per
     hand-written kernel, which must equal what the counters added); then
     SAM 3's image encoder at its published widths (SAM3_PUBLISHED, random
     weights built in process) as Sam3Server runs it, forward_u8 at batch 4
     on 1008^2 the same way, one more replay with every launch count zeroed
     just before (4 flash launches, no other hand-written kernel), and the
     flash kernel at its global layers' shape (64, 5184, 64) against its
     bound, by the card's own time;
 28. the CLI: python -m vision_tpu_torch.cli as a subprocess for depthany
     (CLI_SUBPROCESS_VERB, the entry point's one interpreter start), and
     cli.main in process for birefnet --composite, esrgan --tile 224,
     migan, yolov9t and sam on a 640x480 PNG (and a mask), each output PNG
     equal to the in-process model.compute on the card (the composite and
     yolov9t's detection count too), then info and compare; each verb's
     wall seconds; then
     --composite's foreground estimate at 1024x1024, radius 30, through the
     host-ops library and through its numpy forms, timed on the host;
 29. the served phases' p50s (their forwards now graph replays) and the
     graphs' eager against replay ms;
 30. the HTTP front end (serve_http.py): VisionHTTPServer over the six
     models of phases 27-28 on 127.0.0.1, port 0, each service at its
     default batch, every bucket's graph captured first; 8 client threads
     send 34 PNG bodies (the port's encode_png) at once: Depth-Anything 8
     at 518x518 and 700x500, BiRefNet 4 at 1024x1024 and 1280x720, SAM 6
     (3 points, 3 boxes) at 1024x1024 and 640x480, Real-ESRGAN 4 at
     256x256, MI-GAN 4 RGBA at 512x512, YOLOv9t 8 at 640x480 and 1280x720.
     Every response is 200 and equals the same request through the
     in-process service within one u8 level on at most 0.1% of its values
     (YOLOv9t's JSON its Detections, within the JSON's roundings); the
     hand-written launches, counted from 0, equal each service's
     per-forward count (12 flash; 48 window and 20 deform_conv; 10 window
     an encoder batch; 351 and 112 conv3x3; none for MI-GAN) times its
     batches; /healthz reports the six services, one with fewer batches than
     requests; no result is copied to the host on a handler thread; a
     truncated PNG gets 400, an unknown route 404, a Content-Length past
     MAX_BODY_BYTES 413; the host codec's ms (decode of each body extent,
     encode of each response); then each endpoint alone gets a stream of
     HTTP_STREAM (64) requests (its bodies, cycled), 8 in flight at a time, over HTTP and
     then straight to its service: p50, p99 and req/s of each, and the
     service's own p50 and p99 of the HTTP requests;
 31. bulk (bulk.py): bulk_run on the card over a directory of 12 PNGs at
     three extents (Depth-Anything) and one of 8 (YOLOv9t, with
     detections.json), each file against the in-process server (YOLOv9t's
     annotations may move a box edge by a pixel; its JSON within its
     roundings), the launches equal to the per-forward count times the
     forwards the server called; img/s and occupancy;
 32. the verbs, ``serve`` as a subprocess and the others through cli.main
     in process: ``eval -m`` Depth-Anything over phase 31's
     images against the port's CPU f32 depth (AbsRel within EVAL_ABSREL)
     and YOLOv9t against the CPU's detections.json (mAP printed, not gated);
     ``serve`` with Depth-Anything and YOLOv9t on port 0 (each route
     answered, 404 for the families not loaded, then SIGINT and exit 0
     within 30 s); ``depthany -i <dir>``, its files equal to phase 31's; a
     16-frame video through ``depthany`` where OpenCV imports (where it
     does not, a line says video_run was not driven); last, the readings
     that place eval's bound: the AbsRel of the served depth before its u8
     store, and of bulk_run's files from a Depth-Anything with a fault
     planted in the flash kernel's entry point (the ragged last key tile
     dropped; the first 64-key tile dropped), each of which must pass the
     bound;
 33. the dequant kernel (csrc/dequant.cu) against its plain version, bit for
     bit, for the seven int8-resident block formats (Q8_0, Q4_0, Q4_1, Q5_0,
     Q5_1, IQ4_NL, IQ4_XS) in bf16 and f32: the identity at an n that is no
     multiple of a block of threads, a conv stored (O, H, W, I) under the
     permute (0, 3, 1, 2) and a depthwise conv stored (H, W, 1, C) under
     (3, 2, 0, 1); the f32 result also against the file's own dequant;
 34. quantized residency on the served paths: requantize_gguf writes Q8_0
     copies of phase 27's Depth-Anything, MobileSAM, BiRefNet, MI-GAN and
     YOLOv9t GGUFs (MI-GAN's and YOLOv9t's stored cwhn first, cwhn_gguf, so
     that their 3x3 convs' rows divide the block) and Q4_1 and IQ4_NL copies
     of Depth-Anything; each copy is loaded on the card expanded and
     int8-resident (keep_quantized): store bytes and allocated MiB of each,
     every resident weight's dequant bit-equal to the expanded weight, the
     forward (a graph replay at the server's batch; MobileSAM's encode_u8 and
     decode, eager) bit-equal, the same hand-written launches, and as many
     dequant launches as the resident model's forward looks up weights on
     the CPU; replay (or eager) ms and graph pool MiB of each. The resident
     Depth-Anything serves 8 requests through ImageServer, equal to the
     expanded one's; one BiRefNet forward's dequants are timed as one graph,
     kernel and plain, beside their bytes bound;
 35. the quantize verb as a subprocess (``quantize -t q8_0 --verify``) over
     the Depth-Anything GGUF: its report, and a file equal to phase 34's
     in-process requantize_gguf copy.

 36. gradients: each kernel's autograd function (Conv3x3Fn, WindowAttentionFn,
     DeformConvFn: the kernel forward, a PyTorch backward) against autograd
     of the kernel's plain version on the same CUDA tensors, TF32 off, at
     the training path's shapes: the conv with Real-ESRGAN's epilogues at
     the recipe's 16^2 LR batch of 4 and its 32^2 / 64^2 tail; SWIN-L's
     four window stages at 256^2, batch 2, unmasked and shift-masked, the
     per-head bias a leaf; the ASPP's deformable convs at 256^2 (extents
     8^2-64^2, k 1, 3, 7) with bias, BatchNorm and ReLU; f32 within
     GRAD_F32_REL_RMS, one bf16 case each within GRAD_BF16_REL_RMS;
 37. the three recipes at full width on 8 PNGs the run writes (with
     same-stem masks): Real-ESRGAN x4 on 64^2 patches (batch 4), BiRefNet
     SWIN-L at 256^2 (batch 2, flip and color jitter), Depth-Anything-V2-Base
     distilled into V2-Small at 252^2 (batch 4, rank-8 LoRA over an
     int8-resident base). For each, through train.py as the recipe drives
     it: the first step's loss and every trainable leaf's gradient on the
     card (f32) against the port's CPU f32 on the same batch; a step's
     hand-written launches equal to a forward's (351 conv3x3; 48 window, 24
     masked, and 20 deform_conv; the student's dequant lookups) and none
     other; the trainable leaves moved, the int8 residents bit-unchanged; a
     checkpoint restored bit-equal into a fresh state. Then the recipe
     function itself (finetune_esrgan with an EMA, finetune_birefnet,
     distill_depthany with lora_out), 2 steps with a checkpoint and the
     export: its launches, a finite loss, the exported GGUF loaded with
     load_model and serving one request on the card;
 38. training timings beside the card's name and power limit: ms a step
     (median of 3 after a warm-up), peak allocated memory above what the
     run held before the recipe's state, and profiles of
     one step and of one forward (device busy ms; the hand-written kernels'
     ms and share; the backward and update's share of the step);
 39. the kernels as vtt operators (ops/cuda/library.py): torch.library.opcheck
     of each on the card at a served shape (Depth-Anything's flash attention,
     TinyViT's and SWIN-L's masked window attention, Real-ESRGAN's conv1
     fresh and into its buffer's view, BiRefNet's deformable conv fresh and
     into its branch's view, the sampler, a Q8_0 dequant); the _out ops
     equal to the fresh ones with the channels outside their view unchanged;
     the dispatch cost a call (DISPATCH_CALLS host-timed calls of a small
     conv through vtt::conv3x3 and straight to its launch); YOLOv9t's and
     Real-ESRGAN's eager and replay ms of phase 27, through the operators;
 40. export (export.py): a bundle per family at full width and its server's
     batch (EXPORT_CASES; BiRefNet and SAM3 program-only), a Q8_0
     Depth-Anything and a YOLOv9t exported on the CPU, each traced in a
     writer process of its own (EXPORT_WRITER), all at once, SAM3 in the
     run's own process meanwhile; a loader subprocess a bundle
     (EXPORT_LOADER), all at once, loads it with load_bundle (the CPU one
     with device="cuda"), calls each entry (first calls overlapping, the
     steady calls after every loader's first calls, one loader at a time)
     and prints the modules it holds:
     no model module among them; each output bit-equal to the in-process
     forward (or within E2E_REL_RMS, said so), the CPU export's within
     EXPORT_CPU_F32_REL_RMS of the CPU's f32 forward; each call's launches a
     forward's; export s, bundle MB, load s, first and steady call ms beside
     phase 27's eager and replay ms;
 41. the C ABI (capi.py, native/c_api.cpp): the shim built with g++ where
     this interpreter's Python.h is (else capi.py is driven in process and a
     line says why), a C program (CAPI_PROGRAM, gcc at run time) through
     visp_init, visp_device_init(2), detect, load and compute over the six
     FAMILIES' GGUFs of phase 27, each output's bytes equal to
     capi.model_compute in process (on the card's models of phase 40); the error codes and visp_get_last_error
     for a bad path and a family mismatch;
 42. count_flops (utils/flops.py) of each family's forward at phase 40's
     shapes on the card's route and on the CPU's (models loaded with the
     card's flags): equal, and beside the forward's ms as TFLOP/s against
     H100_BF16_TFLOPS; the yolov9t verb with --profile (a trace holding the
     vtt ops and the conv kernel) and --dump on the card, its 22 maps against
     the CPU's (--dump's function in process) by compare_dumps within
     E2E_REL_RMS.

 43. meshes at one NCCL rank (parallel/): make_mesh(1) makes a world of one
     (NCCL for the card's tensors; one all_reduce on the card checks it);
     the six families of phase 27 are loaded through their loaders with
     mesh= and served through their servers (MESH_SERVED: one full batch
     each, the bucket captured first), each result bit-equal to the same
     weights' unmeshed model's and the launches of a served batch
     (MESH_KERNELS) equal to the unmeshed ones; SAM3's meshed model (phase
     19's weights) encodes an image (4 flash launches) and a prompt,
     bit-equal; the mesh's own ms a call (meshed against unmeshed
     forward_u8 at the server's batch); then the CLI's ``depthany -i DIR
     --dp 1`` in process (files byte-equal to bulk_run of the unmeshed
     model) and ``serve --dp 1`` as a subprocess (one request, SIGINT,
     exit 0);
 44. the flash, window (masked and unmasked) and deformable conv kernels
     against their plain versions at the shapes a shard gives them
     (MESH_FLASH: Depth-Anything's and SAM3's heads at tp 2 and 4;
     MESH_WINDOW: TinyViT's and SWIN-L's at tp 2; BiRefNet's 20 deformable
     convs at batch 2, a dp 2 shard), bf16, one launch each, timed by the
     card's own time beside the plain version; and the flash kernel at a
     SAM3 sequence-parallel rank's shapes (MESH_SP_FLASH: sp 3, sp 9, sp 3
     x tp 2; Tq its queries, Tk the image's 5184 keys) beside its plain
     version, SDPA and its bound, with its max abs error;
 45. dryrun_multichip over 2 and 4 cards, each in a subprocess, where the
     machine has them; otherwise a line says which world sizes did not run.
     The world sizes that ran are printed.
 46. the training meshes at one NCCL rank (a world of one made through
     init_distributed): each of phase 37's recipe steps (Real-ESRGAN,
     BiRefNet, the QLoRA distillation) on create_train_state(mesh=) /
     make_train_step(mesh=) against the same start unmeshed (and a second
     unmeshed run, the control), TRAIN_MESH_STEPS steps over the same
     batches under PyTorch's deterministic algorithms (deterministic: the
     backward's atomics otherwise vary the last bits run to run): losses and
     parameters bit-equal, each step's launches a forward's (351 conv3x3;
     48 window, 24 masked, and 20 deform_conv; 105 dequant) on both, ms a
     step of each; ``finetune --dp 1`` (Real-ESRGAN) and ``distill --dp 1
     --qlora`` through cli.main (deterministic too), their GGUFs and
     adapters byte-equal to the runs without --dp; the dry
     run's step 5 (train_step_check) at world 1; a meshed MobileSAM exported
     with embed_params=False (meta["mesh"] dp 1) whose call_sharded is
     bit-equal to the in-process encode_u8, with its launches.
 47. SAM3's window-major trunk (sam3_scan_phase) on phase 19's model: the
     stack's memory; 4 flash launches and no other hand-written kernel an
     encode_vision at 1008x1008 and 1600x1200; the window-major against the
     spatial trunk on the same weights, bf16 within SAM3_TRUNK_BF16_REL_RMS
     and f32 within SAM3_F32_REL_RMS; both trunks' eager ms and profiles
     (busy, idle, launches); at one NCCL rank a Sam3Model on an sp-1 mesh
     bit-equal to the unmeshed one, encode_vision_pipelined on a pp-1 mesh
     over 2 images (from stage weights and from the stack) against the
     window-major trunk, and the dry run's SAM3 tp / sp / pp checks at
     world 1.
 48. vision-bench (benchmark.py, bench_phase), after phase 47's models are
     freed: run_benchmark over its eleven rows in process, each row's step
     (the family's full-width forward on random weights of seed 0, summed)
     run eagerly once, captured into a CUDA graph and timed as BENCH_REPEATS
     runs of BENCH_K replays between CUDA events; the table beside the card's
     name and power limit; each row's mean and stdev finite, the mean above
     0, GFLOP above 0, MFU at most 1, one replay bit-equal to the eager step
     and the capture's hand-written launches equal to BENCH_KERNELS; the
     forwards of the rows whose kernels no served path runs at their shapes
     (BENCH_PARITY: SWIN-T BiRefNet in f32 and bf16, Depth-Anything-Small
     and -Base at 518x714 in bf16) on the card against the CPU's f32, each
     within its bound and with its row's launches (phase 3 also holds the
     flash kernel at those two rows' shapes against its plain version); and
     ``python -m vision_tpu_torch.cli bench --bench-args yolov9t-640
     --json`` as a subprocess, its JSON line parsed.

The line before the last is a JSON object describing every kernel of the
paths (its vtt ops, its launches a training step, meshed and not, in each
exported call and in each vision-bench row); the last line is {"ok": true,
"device": {...}}.

    python3 chip_smoke.py --parent DIR

runs phases 1 and 2 and then only compare_with_parent: the attention and
conv kernels of another checkout of the port at DIR (say the parent commit,
unpacked with git archive) against this checkout's, in turns on one card,
then Real-ESRGAN's forward_u8 at 512x512 x 4 and BiRefNet's at 1024x1024 x
4 in each checkout (its own process, its own package and kernel library),
in turns.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

BF16_MAX_ABS = 3e-2  # tests/test_pallas.py:55 allows 5e-2 for the Pallas bf16 path
F32_ATOL, F32_RTOL = 1e-4, 1e-3  # summation order differs; TF32 is off
E2E_REL_RMS = 5e-2  # bf16 card forward vs f32 CPU forward, whole model
RESAMPLE_RING = 0.1  # overshoot allowed past [0, 1] after the resize back
SAM_EMBED_REL_RMS = 5e-2  # bf16 card TinyViT embedding vs f32 CPU
SAM_MASK_REL_RMS = 1e-1  # bf16 card mask logits vs f32 CPU (the decoder adds its own bf16 roundings)
SAM_F32_REL_RMS = 1e-4  # f32 card encoder (kernel route, TF32 off) vs f32 CPU: summation order only
SAM_EXTENTS = ((1024, 1024), (640, 480), (1600, 1200))  # as is, upscaled, downscaled
SAM_STAGES = ((361, 49, 4), (25, 196, 5), (100, 49, 10))  # per image: windows, T, heads (hd = 32)
ESRGAN_RDB = ((64, 32), (96, 32), (128, 32), (160, 32), (192, 64))  # (Cin, Cout) of conv1..conv5
ESRGAN_TAIL = ((64, 64), (64, 3))  # hr and last, at 4x the input's width and height
ESRGAN_CONVS = 351  # 1 + 23 * 3 * 5 + 1 + 2 + 1 + 1 per forward at scale 4
ESRGAN_FLOP_PER_PIXEL = 35.85e6  # per input pixel, all 351 convs at scale 4
ESRGAN_F32_REL_RMS = 1e-4  # f32 card forward (kernel route, TF32 off) vs f32 CPU: summation order only
# BiRefNet at 1024x1024: the decoder blocks' extents (squeeze and block4 at
# 32^2, block3 64^2, block2 128^2, block1 256^2) and each block's four
# deformable convs (aspp1 and the 1/3/7 branches), Cin 112
BIREF_BLOCK_HW = (32, 32, 64, 128, 256)
BIREF_DEFORM_KS = (1, 1, 3, 7)
BIREF_CIN = 112
BIREF_COUT = 28  # each ASPP branch's width, inter // 4; the branches fill a 5 * 28-channel buffer
DEFORM_F32_REL_RMS = 2e-5  # f32 fused deformable conv vs its plain version (TF32 off): summation order only
# the bf16 fused deformable conv's relative RMS error at most this times that
# of the f32 result rounded once to bf16 (its columns enter the product as a
# bf16 hi/lo pair, so the output is rounded once)
DEFORM_ROUNDING_RATIO = 1.15
BIREF_DEFORMS = 20  # 5 decoder blocks x 4 deformable convs per forward
BIREF_WINDOWS, BIREF_MASKED = 48, 24  # SWIN-L blocks per forward (both scales), the shifted half
BIREF_EXTENTS = ((1024, 1024),) * 4 + ((1280, 720),) * 2 + ((800, 600),) * 2  # (w, h); one 1024^2 bucket
BIREF_PARITY_HW = 384
BIREF_F32_REL_RMS = 1e-4  # f32 card forward (kernel routes, TF32 off) vs f32 CPU: summation order only
# SWIN-L's windowed attention at 1024x1024: (token grid side, heads); window 12, T 144
SWIN_L_STAGES = ((256, 6), (128, 12), (64, 24), (32, 48))
# the Depth-Anything requests' extents (w, h): 518x518 and 700x500, which
# depthany_image_extent snaps to 728x518
DEPTH_EXTENTS = ((518, 518), (700, 500))
BENCH_DEPTH_T = 1 + (518 // 14) * (714 // 14)  # the vision-bench Depth-Anything rows' tokens at 518x714 (1888)
# SAM3 (phases 18-21): the repo's configuration (random_sam3_vision_params'
# defaults, Sam3VitParams) at 1008 px, 4 global layers of 5184 tokens at head
# dim 80; the text encoder the smoke makes (sam3_text_params); requests at
# 1008x1008 (as is) and 1600x1200 (resized)
SAM3_TEXT = {"layers": 24, "width": 1024, "heads": 16, "mlp": 4096, "vocab": 49408, "max_length": 32}
SAM3_EXTENTS = ((1008, 1008), (1600, 1200))
SAM3_PROMPTS = ("a cat", "the red car on the left", "2 dogs!", "")
SAM3_FPN = ((288, 256), (144, 256), (72, 256), (36, 256))  # (side, channels) of the four levels at 1008 px
SAM3_F32_REL_RMS = 1e-4  # f32 card (kernel route, TF32 off) vs f32 CPU, first two layers + neck: summation order only
SAM3_PLAIN_RATIO = 1.1  # full depth, if bf16 vs f32 misses E2E_REL_RMS: its RMS vs that with the plain global layers
# the bf16 D-80 flash kernel vs its plain version's f32 result, relative RMS:
# BF16_MAX_ABS alone is ~1.3x a typical output at T 5184 (outputs ~0.02),
# too loose to see a dropped key tile there; bf16 rounding of p and o gives
# ~2-3e-3
FLASH_D80_BF16_REL_RMS = 1e-2
# SAM 3's image encoder at its published widths (facebook/sam3's vision
# backbone: width 1024, 16 heads of 64, MLP 4736, a 24 x 24 position table
# tiled 3 x 3; the benchmark's sam3_vision_1008 configuration), the
# arguments of random_sam3_vision_params; its global layers' tokens at 1008
# px; Sam3Server's batch
SAM3_PUBLISHED = {"dim": 1024, "mlp": 4736, "pos_grid": 24}
SAM3_T = (1008 // 14) ** 2
SAM3_SERVE_BATCH = 4
# the card's published peaks (NVIDIA H100 SXM data sheet, dense): bf16 tensor
# cores, f32 outside the tensor cores, device memory
PEAK_BF16_FLOPS, PEAK_F32_FLOPS, PEAK_BYTES = 989e12, 67e12, 3.35e12
# the deformable conv's bilinear blend per column element: the mask folded
# into the four corner weights once per (pixel, tap), then one product and
# three FMAs, 7 f32 FLOPs
BLEND_FLOPS = 7.0
# device_ms: a spin kernel of ~20 ms at the card's 1.98 GHz boost clock runs
# ahead of each timed run; and how the attention kernels' times in the
# kernels line were taken
SPIN_CYCLES = 40_000_000
DEVICE_TIMING = "the card's own time per call: CUDA events around 20 calls enqueued behind a spin kernel, over 20"
# YOLOv9t (phases 22-24, 26): random_yolov9t_params(0) at 640 px, served at
# YoloServer's default batch 8; 16 requests, 4 at each extent (w, h), all
# letterboxed into one 640^2 bucket
YOLO_CONVS = 112  # stride-1 3x3 convs a forward: 7 RepNCSPELAN4 x (2 RepCSP x 3 x 2 + 2), ELAN1's 2, the head's 12
YOLO_BATCH = 8
YOLO_EXTENTS = ((640, 480), (1280, 720), (500, 375), (640, 640))
YOLO_F32_REL_RMS = 1e-4  # f32 card forward (kernel route, TF32 off) vs f32 CPU: summation order only
# NMS on the card's f32 outputs vs on the CPU's: the share of the card's
# detections the CPU's keeps too. Random weights put the class scores close
# together, so f32 rounding can reorder near-ties among the candidates.
YOLO_NMS_MATCH = 0.9
# MI-GAN (phases 25-26): random_migan_params(512, 0), ImageServer batch 4; 8
# (image, mask) requests, the last two RGBA images with the mask as alpha
MIGAN_RES = 512
MIGAN_BATCH = 4
MIGAN_EXTENTS = ((512, 512),) * 4 + ((1024, 768),) * 2 + ((640, 480),) * 2
MIGAN_F32_REL_RMS = 1e-4  # f32 card forward (TF32 off) vs f32 CPU: summation order only


_START = time.perf_counter()


def phase(name: str) -> None:
    """A phase's heading, with the seconds since the script started (the
    run's time limit is the budget the phases share)."""
    print(f"== {name} [at {time.perf_counter() - _START:.1f} s]", flush=True)


def zero_counts() -> None:
    """Set every hand-written kernel's launch counts to 0."""
    from vision_tpu_torch.ops.cuda import conv3x3, deform_conv, deform_sample, dequant, flash_attention
    from vision_tpu_torch.ops.cuda import window_attention

    for m in (conv3x3, deform_conv, deform_sample, dequant, flash_attention, window_attention):
        m.launches = 0
    window_attention.masked_launches = 0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, calls: int = 20, warmup: int = 3, reps: int = 3) -> float:
    """The card's own time for one call of ``fn``: CUDA events around
    ``calls`` calls back to back, over the count, the median of ``reps``
    runs. Before each run a 20 ms spin kernel keeps the card busy while the
    host enqueues the calls, so the card runs them with no gap between.
    CUDA events around a single call (median_ms) also take in the host's
    time before the launch while the card idles: tens of microseconds of
    Python and launch work, as much as an attention kernel itself takes."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def depth_tokens(extent: tuple[int, int]) -> int:
    """DINOv2's token count for a Depth-Anything-V2 request of ``extent``
    (w, h): the patches of the extent depthany_image_extent snaps it to,
    and the class token."""
    from vision_tpu_torch.models.depth_anything import DepthAnythingParams, depthany_image_extent

    p = DepthAnythingParams()
    w, h = depthany_image_extent(extent, p)
    return (w // p.dino.patch_size) * (h // p.dino.patch_size) + 1


def kernel_cases(fa, torch) -> float:
    """Phase 3: the flash kernel against flash_attention_plain. Returns the
    largest absolute difference seen."""
    t_sq, t_wide = (depth_tokens(e) for e in DEPTH_EXTENTS)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # (label, B, H, Tq, Tk, D, dtype)
        ("served 518x518", 4, 6, t_sq, t_sq, 64, bf16),
        ("served 700x500 (518x728)", 4, 6, t_wide, t_wide, 64, bf16),
        # the vision-bench rows' 518x714 input (phase 48): Depth-Anything-V2-Small's and -Base's heads
        ("vision-bench depthany-small", 1, 6, BENCH_DEPTH_T, BENCH_DEPTH_T, 64, bf16),
        ("vision-bench depthany-base", 1, 12, BENCH_DEPTH_T, BENCH_DEPTH_T, 64, bf16),
        # SAM 3's global layers at its published widths, as Sam3Server's batch runs them
        ("SAM3 global, published widths", SAM3_SERVE_BATCH, 16, SAM3_T, SAM3_T, 64, bf16),
        ("D=32 bf16", 2, 4, 700, 700, 32, bf16),
        ("D=128 bf16", 2, 4, 700, 700, 128, bf16),
        ("cross Tq 7, Tk 150 bf16", 1, 2, 7, 150, 64, bf16),
        (f"cross Tq {t_sq}, Tk {t_wide} bf16", 1, 6, t_sq, t_wide, 64, bf16),
        ("one past a 128 tile bf16", 2, 3, 129, 129, 64, bf16),
        ("one past a 64-key tile D=128 bf16", 1, 2, 129, 65, 128, bf16),
        ("one past a tile D=32 bf16", 1, 2, 257, 129, 32, bf16),
        ("ragged f32", 2, 3, 300, 300, 32, f32),
        ("one past a tile f32", 1, 2, 1025, 1025, 64, f32),
        ("cross f32", 1, 2, 7, 150, 32, f32),
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    for label, b, h, tq, tk, d, dtype in cases:
        q = torch.randn(b, h, tq, d, device="cuda", generator=gen).to(dtype)
        k = torch.randn(b, h, tk, d, device="cuda", generator=gen).to(dtype)
        v = torch.randn(b, h, tk, d, device="cuda", generator=gen).to(dtype)
        scale = d**-0.5
        before = fa.launches
        out = fa.flash_attention(q, k, v, scale=scale)
        torch.cuda.synchronize()
        if fa.launches != before + 1:
            raise AssertionError(f"{label}: launch count went {before} -> {fa.launches}")
        if out.shape != q.shape or out.dtype != dtype:
            raise AssertionError(f"{label}: output {tuple(out.shape)} {out.dtype}")
        ref = fa.flash_attention_plain(q.float(), k.float(), v.float(), scale)
        diff = (out.float() - ref).abs()
        err = float(diff.max())
        worst = max(worst, err)
        if dtype == torch.float32:
            bound = F32_ATOL + F32_RTOL * ref.abs()
            ok = bool((diff <= bound).all())
            rule = f"atol {F32_ATOL} rtol {F32_RTOL}"
        else:
            ok = err <= BF16_MAX_ABS
            rule = f"max abs <= {BF16_MAX_ABS}"
        print(f"kernel flash_attention {label} (B={b} H={h} Tq={tq} Tk={tk} D={d} {dtype}): "
              f"max_abs_err {err:.3e} [{rule}] {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"flash_attention {label}: max abs err {err}")
        if dtype == bf16 and tk >= SAM3_T:  # the max-abs bound is too loose at T 5184: the D-80 limit too
            rms = rel_rms_t(out.float(), ref)
            print(f"kernel flash_attention {label}: relative RMS {rms:.3e} (output RMS "
                  f"{float(ref.pow(2).mean().sqrt()):.3e}) [<= {FLASH_D80_BF16_REL_RMS}] "
                  f"{'ok' if rms <= FLASH_D80_BF16_REL_RMS else 'FAIL'}", flush=True)
            if not rms <= FLASH_D80_BF16_REL_RMS:
                raise AssertionError(f"flash_attention {label}: relative RMS {rms}")
        del q, k, v, out, ref, diff
    return worst


def window_cases(wa, torch, batch: int = 6) -> float:
    """Phase 3: the window kernel against window_attention_plain, at the
    three TinyViT stage shapes of a batch of ``batch`` 1024x1024 images in
    bf16 with a bf16 bias (stage 1 also with an f32 one), and at ragged and
    f32 edge cases. Returns the largest absolute difference seen."""
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(f"stage {i + 1}", nw * batch, t, h, 32, bf16, bf16) for i, (nw, t, h) in enumerate(SAM_STAGES)]
    cases += [
        # (label, NW, T, H, hd, dtype, bias dtype or None)
        ("stage 1, f32 bias", SAM_STAGES[0][0] * batch, 49, 4, 32, bf16, f32),
        ("T=20 ragged bf16, no bias", 7, 20, 2, 32, bf16, None),
        ("T=100 bf16", 5, 100, 3, 32, bf16, bf16),
        ("T=256 bf16, f32 bias (read from L2)", 6, 256, 2, 32, bf16, f32),
        ("T=20 ragged f32", 7, 20, 2, 32, f32, f32),
        ("no bias f32", 9, 49, 4, 32, f32, None),
        ("one window f32", 1, 49, 4, 32, f32, f32),
        ("H=5 T=196 f32", 3, 196, 5, 32, f32, f32),
    ]
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = 0.0
    for label, nw, t, h, hd, dtype, bias_dtype in cases:
        q, k, v = (torch.randn(nw, t, h * hd, device="cuda", generator=gen).to(dtype) for _ in range(3))
        with_bias = bias_dtype is not None
        bias = (torch.randn(h, t, t, device="cuda", generator=gen) * 0.5).to(bias_dtype) if with_bias else None
        scale = hd**-0.5
        before = wa.launches
        out = wa.window_attention(q, k, v, bias, h, scale)
        torch.cuda.synchronize()
        if wa.launches != before + 1:
            raise AssertionError(f"{label}: launch count went {before} -> {wa.launches}")
        if out.shape != q.shape or out.dtype != dtype:
            raise AssertionError(f"{label}: output {tuple(out.shape)} {out.dtype}")
        ref = wa.window_attention_plain(q, k, v, bias, h, scale).float()
        diff = (out.float() - ref).abs()
        err = float(diff.max())
        worst = max(worst, err)
        if dtype == torch.float32:
            ok = bool((diff <= F32_ATOL + F32_RTOL * ref.abs()).all())
            rule = f"atol {F32_ATOL} rtol {F32_RTOL}"
        else:
            ok = err <= BF16_MAX_ABS
            rule = f"max abs <= {BF16_MAX_ABS}"
        print(f"kernel window_attention {label} (NW={nw} T={t} H={h} hd={hd} {dtype}, "
              f"bias {bias_dtype}): max_abs_err {err:.3e} [{rule}] {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"window_attention {label}: max abs err {err}")
    return worst


def window_plan_cases(wa, build, sam_batch: int = 6, swin_batch: int = 4) -> None:
    """Phase 3: the window kernel's launch plan, as the kernel library makes
    it (vtt_window_attention_plan), against window_plan, at TinyViT's three
    stages and SWIN-L's four (bf16 biases; SWIN with its shift masks); each
    must fill at least two waves of the card's SMs."""
    import ctypes

    from vision_tpu_torch.models.swin import compute_attention_mask

    lib = build.load_library()
    shapes = [(f"TinyViT stage {i + 1}", nw * sam_batch, t, h, 0) for i, (nw, t, h) in enumerate(SAM_STAGES)]
    for i, (side, h) in enumerate(SWIN_L_STAGES):
        n_masks = compute_attention_mask(side, side, 12).shape[0]
        shapes.append((f"SWIN-L stage {i + 1}", n_masks * swin_batch, 144, h, n_masks))
    for label, nw, t, h, n_masks in shapes:
        out = (ctypes.c_longlong * 6)()
        if lib.vtt_window_attention_plan(nw, t, h, n_masks, 2, out) != 0:
            raise AssertionError(f"{label}: vtt_window_attention_plan refused (NW={nw}, T={t}, H={h})")
        plan = wa.window_plan(nw, t, h, n_masks, 2)
        mine = (plan.blocks, plan.threads, plan.smem, plan.heads, plan.run, int(plan.staged))
        print(f"window_attention plan {label} (NW={nw}, T={t}, H={h}, {n_masks} masks): {plan.blocks} blocks of "
              f"{plan.threads} threads, {plan.smem} B shared memory, {plan.heads} heads x {plan.run} windows a "
              f"block, staged {plan.staged}, {plan.blocks_per_sm} blocks an SM, {plan.waves:.2f} waves", flush=True)
        if tuple(out) != mine or plan.waves < 2:
            raise AssertionError(f"{label}: library plan {tuple(out)}, window_plan {mine}, {plan.waves:.2f} waves")


def conv_cases(cc, torch) -> float:
    """Phase 10: the conv3x3 kernel against conv3x3_plain, bare, then with
    each epilogue and view form of the Real-ESRGAN path (epilogue_cases).
    Returns the largest absolute difference seen."""
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(f"RDB {ci}->{co}", 1, 256, 256, ci, co, bf16) for ci, co in ESRGAN_RDB]
    cases += [
        # (label, N, H, W, Cin, Cout, dtype)
        ("stem 3->64", 1, 256, 256, 3, 64, bf16),
        ("last 64->3", 1, 256, 256, 64, 3, bf16),
        ("ragged bf16, Cin 20 -> 12", 2, 7, 13, 20, 12, bf16),
        ("half a chunk bf16, Cin 24 -> 40", 3, 19, 23, 24, 40, bf16),
        ("two output tiles bf16, Cout 96", 1, 33, 17, 32, 96, bf16),
        ("W=13 H=7 f32", 1, 7, 13, 16, 8, f32),
        ("batch 3 f32", 3, 20, 19, 32, 32, f32),
        ("Cin 4 -> Cout 4 f32", 2, 9, 10, 4, 4, f32),
        ("Cin 3 f32", 1, 17, 18, 3, 64, f32),
        ("Cout 3 f32", 1, 15, 33, 64, 3, f32),
        ("one pixel wide f32", 2, 21, 1, 8, 8, f32),
    ]
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst = 0.0
    for label, n, h, w, ci, co, dtype in cases:
        x = (torch.randn(n, h, w, ci, device="cuda", generator=gen) * 0.5).to(dtype)
        wt = (torch.randn(co, ci, 3, 3, device="cuda", generator=gen) / (9 * ci) ** 0.5).to(dtype)
        before = cc.launches
        out = cc.conv3x3(x, wt)
        torch.cuda.synchronize()
        if cc.launches != before + 1:
            raise AssertionError(f"{label}: launch count went {before} -> {cc.launches}")
        if out.shape != (n, h, w, co) or out.dtype != dtype:
            raise AssertionError(f"{label}: output {tuple(out.shape)} {out.dtype}")
        ref = cc.conv3x3_plain(x.float(), wt.float())
        err = check_close(f"conv3x3 {label} ({n}, {h}, {w}, {ci}) -> {co} {dtype}", out, ref, dtype, torch)
        worst = max(worst, err)
    for dtype, (n, h, w) in ((bf16, (1, 256, 256)), (bf16, (2, 19, 23)), (f32, (2, 19, 23))):
        worst = max(worst, epilogue_cases(cc, torch, gen, n, h, w, dtype))

    # more than 2^31 elements: 64-bit offsets; the last image against the
    # plain version run on that image alone
    n, hw, c = 4, 4096, 64
    x = torch.empty(n, hw, hw, c, device="cuda", dtype=bf16)
    for i in range(n):  # one image at a time: each is below 2^31 elements
        x[i] = torch.randn(hw, hw, c, device="cuda", dtype=bf16, generator=gen)
    wt = (torch.randn(c, c, 3, 3, device="cuda", generator=gen) / (9 * c) ** 0.5).to(bf16)
    out = cc.conv3x3(x, wt)
    torch.cuda.synchronize()
    ref = cc.conv3x3_plain(x[n - 1 :].float(), wt.float())
    err = check_close(f"conv3x3 large ({n}, {hw}, {hw}, {c}) -> {c} bf16, {x.numel()} input elements, last image",
                      out[n - 1 :], ref, bf16, torch)
    del x, out, ref
    torch.cuda.empty_cache()
    return max(worst, err)


def epilogue_cases(cc, torch, gen, n: int, h: int, w: int, dtype) -> float:
    """Phase 10: each form the Real-ESRGAN path gives the kernel, on dense-
    block buffers of (n, h, w, 192), against conv3x3_plain on the same
    values: conv1-4 (a channel prefix in, 32 channels written after it,
    bias and leaky ReLU), conv5 (all 192 in, x + 0.2 * (conv + b) into the
    next buffer), RDB3's conv5 (the RRDB's residual too, written over it in
    place), the stem (Cin 3 into a buffer), the trunk conv (+ skip), hr
    (bias, leaky) and the last conv (Cout 3). Every channel a call must not
    write is checked unchanged. Returns the largest absolute difference."""
    nf, gc = 64, 32

    def rnd(*shape, scale=0.5):
        return (torch.randn(*shape, device="cuda", generator=gen) * scale).to(dtype)

    def weight(co, ci):
        return (torch.randn(co, ci, 3, 3, device="cuda", generator=gen) / (9 * ci) ** 0.5).to(dtype), rnd(co, scale=0.1)

    buf, nxt, res = rnd(n, h, w, nf + 4 * gc), rnd(n, h, w, nf + 4 * gc), rnd(n, h, w, nf + 4 * gc)
    x3, feat = rnd(n, h, w, 3), rnd(n, h, w, nf)
    forms = []  # (label, input view, weight, bias, kwargs, output view, its buffer)
    for k in range(4):
        c = nf + k * gc
        forms.append((f"conv{k + 1} {c}->{gc} into channels {c}:{c + gc}", buf[..., :c], *weight(gc, c),
                      {"slope": 0.2}, buf[..., c : c + gc], buf))
    forms.append(("conv5 192->64, x + 0.2 * y into the next buffer", buf, *weight(nf, 192),
                  {"r1": buf[..., :nf], "s1": 0.2}, nxt[..., :nf], nxt))
    forms.append(("RDB3 conv5, r2 + 0.2 * (x + 0.2 * y) over r2", buf, *weight(nf, 192),
                  {"r1": buf[..., :nf], "s1": 0.2, "r2": res[..., :nf], "s2": 0.2}, res[..., :nf], res))
    forms.append(("stem 3->64 into a buffer", x3, *weight(nf, 3), {}, nxt[..., :nf], nxt))
    forms.append(("trunk 64->64 + skip", buf[..., :nf], *weight(nf, nf), {"r1": feat}, None, None))
    forms.append(("hr 64->64, leaky", feat, *weight(nf, nf), {"slope": 0.2}, None, None))
    forms.append(("last 64->3", feat, *weight(3, nf), {}, None, None))
    worst = 0.0
    for label, x, wt, b, kw, out, whole in forms:
        ref = cc.conv3x3_plain(x.float(), wt.float(), b.float(),
                               **{k: (v.float() if torch.is_tensor(v) else v) for k, v in kw.items()})
        before_whole = None if whole is None else whole.clone()
        count = cc.launches
        got = cc.conv3x3(x, wt, b, out=out, **kw)
        torch.cuda.synchronize()
        if cc.launches != count + 1:
            raise AssertionError(f"{label}: launch count went {count} -> {cc.launches}")
        if out is not None:
            if got.data_ptr() != out.data_ptr():
                raise AssertionError(f"{label}: the result is not the given out view")
            keep = torch.ones(whole.shape[-1], dtype=torch.bool, device="cuda")
            keep[out.storage_offset() % whole.shape[-1] :][: out.shape[-1]] = False
            if not torch.equal(whole[..., keep], before_whole[..., keep]):
                raise AssertionError(f"{label}: channels outside the out view changed")
        worst = max(worst, check_close(f"conv3x3 epilogue {label} ({n}, {h}, {w}) {dtype}", got, ref, dtype, torch))
    return worst


def check_close(label: str, out, ref, dtype, torch) -> float:
    """Kernel output against the plain version's f32 result: max abs <=
    BF16_MAX_ABS in bf16, atol + rtol in f32. Returns the max abs error."""
    diff = (out.float() - ref).abs()
    err = float(diff.max())
    if dtype == torch.float32:
        ok = bool((diff <= F32_ATOL + F32_RTOL * ref.abs()).all())
        rule = f"atol {F32_ATOL} rtol {F32_RTOL}"
    else:
        ok = err <= BF16_MAX_ABS
        rule = f"max abs <= {BF16_MAX_ABS}"
    print(f"kernel {label}: max_abs_err {err:.3e} [{rule}] {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: max abs err {err}")
    return err


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bf16 tensor-core
    time and the device-memory time, and which of the two it is."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def conv_bound(pixels: int, ci: int, co: int, residuals: int = 0) -> tuple[float, str]:
    """bf16 3x3 conv: each input and output element, each residual read and
    the weight once."""
    return bound_ms(18.0 * pixels * ci * co, 2.0 * (pixels * (ci + co * (1 + residuals)) + 9 * ci * co))


def conv_path_forms(torch, gen, hw: int, ci: int, co: int):
    """The input, weight, bias and epilogue keywords of the Real-ESRGAN
    path's call at this shape: a growth conv reads a channel prefix of a
    192-channel buffer and writes its 32 channels after it with leaky ReLU,
    conv5 writes x + 0.2 * y into the next buffer, hr (64 -> 64) fuses the
    leaky ReLU, the last conv (-> 3) only the bias. Values of scale 0.5, as
    phase 10's, keep the outputs below 4, where a bf16 ulp is within
    BF16_MAX_ABS. Returns (x, w, b, kw, residuals read)."""
    bf16 = torch.bfloat16
    wt = (torch.randn(co, ci, 3, 3, device="cuda", generator=gen) / (9 * ci) ** 0.5).to(bf16)
    b = (torch.randn(co, device="cuda", generator=gen) * 0.1).to(bf16)
    if hw == 4096:
        x = (torch.randn(1, hw, hw, ci, device="cuda", generator=gen) * 0.5).to(bf16)
        return x, wt, b, ({"slope": 0.2} if co == 64 else {}), 0
    buf = (torch.randn(1, hw, hw, 192, device="cuda", generator=gen) * 0.5).to(bf16)
    if co == 32:
        return buf[..., :ci], wt, b, {"slope": 0.2, "out": buf[..., ci : ci + co]}, 0
    nxt = torch.empty(1, hw, hw, 192, device="cuda", dtype=bf16)
    return buf, wt, b, {"r1": buf[..., :co], "s1": 0.2, "out": nxt[..., :co]}, 1


def conv_timings(cc, torch, card: str) -> list:
    """Phase 13: the kernel bare and with its path's epilogue and views, its
    plain version and F.conv2d (channels-last cuDNN, bare), at the RDB
    shapes at 1024x1024 and the tail shapes at 4096x4096: the card's own
    time (device_ms, in turns) and, for the kernel, per call with the host's
    launch work (median_ms). Returns (label, pixels, Cin, Cout, kernel ms
    with the epilogue, bare kernel ms, plain ms, library ms, per-call ms,
    residuals read)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for hw, shapes in ((1024, ESRGAN_RDB), (4096, ESRGAN_TAIL)):
        for ci, co in shapes:
            x, wt, b, kw, res = conv_path_forms(torch, gen, hw, ci, co)
            xd = x.contiguous()
            xc = xd.permute(0, 3, 1, 2)  # an NHWC tensor is a channels-last NCHW one
            run_e = lambda: cc.conv3x3(x, wt, b, **kw)  # noqa: E731
            run_k = lambda: cc.conv3x3(xd, wt)  # noqa: E731
            run_l = lambda: F.conv2d(xc, wt, None, 1, 1)  # noqa: E731
            e1, k1, l1, e2, k2, l2 = (device_ms(f) for f in (run_e, run_k, run_l, run_e, run_k, run_l))
            p_ms = device_ms(lambda: cc.conv3x3_plain(xd, wt), calls=2, warmup=1, reps=1)
            call = median_ms(run_e, 10)
            bound, by = conv_bound(hw * hw, ci, co, res)
            rows.append((f"({hw}x{hw}, {ci}) -> {co}", hw * hw, ci, co, min(e1, e2), min(k1, k2), p_ms, min(l1, l2),
                         call, res))
            print(f"conv3x3 (1, {hw}, {hw}, {ci}) -> {co} bf16 on the card: kernel with the path's epilogue "
                  f"({', '.join(sorted(kw)) or 'bias'}) {e1:.4f} / {e2:.4f} ms, bare {k1:.4f} / {k2:.4f} ms, plain "
                  f"{p_ms:.4f} ms, F.conv2d {l1:.4f} / {l2:.4f} ms, bound {bound:.4f} ms ({by}); per call with the "
                  f"host's launch work {call:.4f} ms; {18.0 * hw * hw * ci * co / (min(e1, e2) * 1e-3) / 1e12:.1f} "
                  f"TFLOP/s [{card}]", flush=True)
            del x, xd, xc, kw
    torch.cuda.empty_cache()
    return rows


def attention_yardsticks(fa, wa, torch, card: str) -> tuple[float, float]:
    """Phase 13: F.scaled_dot_product_attention beside each attention kernel
    at its main path's shapes, a yardstick the port never calls: the card's
    own time of each (device_ms, in turns) and CUDA events around single
    calls (median_ms, the host's launch work included). Returns the library's
    device ms at the flash shapes by token count, and at the window kernel's
    TinyViT stage 1."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(7)
    flash = {}
    for t in (depth_tokens(e) for e in DEPTH_EXTENTS):
        q, k, v = (torch.randn(4, 6, t, 64, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(3))
        run_k = lambda: fa.flash_attention(q, k, v)  # noqa: E731
        run_l = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
        k1, l1, k2, l2 = (device_ms(f) for f in (run_k, run_l, run_k, run_l))
        ek, el = (median_ms(f, 20) for f in (run_k, run_l))
        flash[t] = min(l1, l2)
        b, by = bound_ms(4.0 * 24 * t * t * 64, 4 * 2.0 * 24 * t * 64)
        print(f"flash_attention (24, {t}, 64) bf16 on the card: kernel {k1:.4f} / {k2:.4f} ms, SDPA {l1:.4f} / "
              f"{l2:.4f} ms, bound {b:.4f} ms ({by}); per call with the host's launch work: kernel {ek:.4f} ms, SDPA "
              f"{el:.4f} ms [{card}]", flush=True)
    win = []
    for i, (nw, t, h) in enumerate(SAM_STAGES):
        q, k, v = (torch.randn(6 * nw, t, h * 32, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(3))
        bias = (torch.randn(h, t, t, device="cuda", generator=gen) * 0.5).to(torch.bfloat16)
        # SDPA takes heads apart: (NW, H, T, hd), laid out before the timing
        q4, k4, v4 = (z.view(6 * nw, t, h, 32).transpose(1, 2).contiguous() for z in (q, k, v))
        run_k = lambda: wa.window_attention(q, k, v, bias, h, 32**-0.5)  # noqa: E731
        run_l = lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=bias)  # noqa: E731
        k1, l1, k2, l2 = (device_ms(f) for f in (run_k, run_l, run_k, run_l))
        ek, el = (median_ms(f, 20) for f in (run_k, run_l))
        win.append(min(l1, l2))
        b, by = bound_ms(4.0 * 6 * nw * h * t * t * 32, 4 * 2.0 * 6 * nw * t * h * 32 + 2.0 * h * t * t)
        print(f"window_attention stage {i + 1} (NW={6 * nw}, T={t}, H={h}, hd=32) bf16 on the card: kernel "
              f"{k1:.4f} / {k2:.4f} ms, SDPA with the bias as attn_mask {l1:.4f} / {l2:.4f} ms, bound {b:.4f} ms "
              f"({by}); per call with the host's launch work: kernel {ek:.4f} ms, SDPA {el:.4f} ms [{card}]",
              flush=True)
    return flash, win[0]


def profile_forward(model, x, torch, card: str, names=("conv3x3",)) -> dict:
    """Phases 6, 13 and 17: profile_run over one model.forward_u8(x)."""
    return profile_run(lambda: model.forward_u8(x), f"forward_u8 {tuple(x.shape)}", torch, card, names)


def profile_run(run, label: str, torch, card: str, names=("conv3x3",), counts=None) -> dict:
    """Where one call of ``run`` spends its time, from a torch.profiler
    trace: device busy time (the sum of kernel times), the host's wall
    time, the idle share, the share of each named hand-written kernel, the
    launches of every other kernel, and the heaviest kernels. Returns the
    busy ms, wall ms, the named kernels' ms and launches, the other
    launches, and with ``counts`` (a callable that reads the launch
    counters) what the counters added during the profiled call. The
    profiler traces one call as a warm-up step first and keeps the second:
    right after it starts, the tracer can drop the first records of a burst
    (a CUDA graph's replay sends its kernels at once), about ten on the
    card (measured on one H100)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        run()
        torch.cuda.synchronize()
        prof.step()
        before = counts() if counts else {}
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        counted = {k: v - before[k] for k, v in counts().items() if v != before[k]} if counts else {}
        prof.step()
    # the schedule's step annotation, and any other user annotation (the
    # optimizer's step), spans its kernels on the device too: not a kernel
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.key.startswith("ProfilerStep")
               and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        raise AssertionError(f"profile of one {label}: the profiler recorded no device time")
    shares, named_ms = [], {}
    for name in names:
        ms = sum(e.self_device_time_total for e in kernels if name in e.key) / 1e3
        named_ms[name] = ms
        shares.append(f"{name} {ms:.3f} ms ({ms / busy_ms:.2%} of busy)")
    others = sum(e.count for e in kernels if not any(name in e.key for name in names))
    launches = f"{sum(e.count for e in kernels)} kernel launches, " + (
        f"{others} of them not of {'/'.join(names)}" if names else "no hand-written kernel in this forward")
    print(f"profile of one {label}: wall {wall_ms:.3f} ms (profiler on), device busy "
          f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.2%}, {''.join(s + ', ' for s in shares)}"
          f"{launches} [{card}]", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:100]}", flush=True)
    named_launches = {name: sum(e.count for e in kernels if name in e.key) for name in names}
    return {"busy_ms": busy_ms, "wall_ms": wall_ms, "named_ms": named_ms, "named_launches": named_launches,
            "other_launches": others, "counted": counted}


def esrgan_stages(params, x_u8, p, dtype, device):
    """RRDBNet stage by stage, in esrgan_generate's structure (each RRDB on
    its dense-block buffers, every bias, leaky ReLU and residual in the conv
    kernel's epilogue): a list of (name, output) ending with the forward's
    float output."""
    import torch

    from vision_tpu_torch.core.params import Params
    from vision_tpu_torch.models import esrgan
    from vision_tpu_torch.ops import conv_3x3_fused, normalize_u8

    out = []
    with torch.inference_mode():
        m = Params(params)["model"]
        block = m[1]["sub"]
        feat = conv_3x3_fused(m[0], normalize_u8(x_u8.to(device), dtype=dtype))
        out.append(("stem", feat))
        sub = feat
        for i in range(p.n_blocks):
            sub = esrgan.rrdb(block[i], sub)
            if i in (0, p.n_blocks // 2, p.n_blocks - 1):
                out.append((f"after RRDB {i}", sub))
        x = conv_3x3_fused(block[p.n_blocks], sub, r1=feat)
        out.append(("trunk sum", x))
        seq = 2
        for _ in range(int(np.log2(p.scale))):
            x = esrgan._upsample(m[seq + 1], x)
            seq += 3
        out.append(("output", conv_3x3_fused(m[seq + 2], conv_3x3_fused(m[seq], x, slope=0.2))))
    return out


def write_esrgan_gguf(path: str) -> None:
    from vision_tpu_torch.core.gguf import GGUFWriter
    from vision_tpu_torch.models.random_weights import random_esrgan_params

    w = GGUFWriter(path, "esrgan")
    w.add("esrgan.scale", 4)
    w.add("esrgan.block_count", 23)
    for name, a in random_esrgan_params(0).items():
        w.add_tensor(name, a)
    w.write()


def esrgan_rgba_check(torch, model, reqs, served, batch: int) -> None:
    """Phase 11's check of the served output form: per extent of ``reqs``
    (in order, padded to ``batch`` with the bucket's first image, as
    EsrganServer pads), the RGBA graph's replay against the RGB replay with
    alpha 255, and the server's answers to ``reqs`` against the RGBA replay,
    bit for bit. First ``served``, at the random weights, whose answers are
    all 0 below the alpha; then ``reqs`` served again with the last conv
    (``model.10``, the x4 model's) rescaled in place so that the answers
    spread over 0..255, restored after: the replays read the weights where
    they lie, so no graph is captured again."""
    from vision_tpu_torch.serve import EsrganServer

    buckets = {}
    for i, img in enumerate(reqs):
        buckets.setdefault(img.extent, []).append(i)

    def compare(answers, label):
        for (w, h), idx in buckets.items():
            x = torch.from_numpy(np.stack([reqs[i].to_rgb_u8() for i in idx + [idx[0]] * (batch - len(idx))]))
            rgb = model.forward_u8(x).cpu().numpy()
            rgba = model.forward_u8(x, rgba=True).cpu().numpy()
            want = np.concatenate([rgb, np.full((*rgb.shape[:3], 1), 255, np.uint8)], axis=3)
            if rgba.shape != want.shape or not np.array_equal(rgba, want):
                raise AssertionError(f"{label}: RGBA replay at {w}x{h} x {batch}: {rgba.shape}, differs from the "
                                     "RGB replay with alpha 255 on "
                                     f"{int((rgba != want).sum()) if rgba.shape == want.shape else '-'} values")
            bad = [i for k, i in enumerate(idx) if not np.array_equal(answers[i].data, rgba[k])]
            if bad:
                raise AssertionError(f"{label}: served answers {bad} at {w}x{h} differ from the RGBA replay")
            print(f"{label}: RGBA replay {w}x{h} x {batch} is the RGB replay with alpha 255, bit for bit, and its "
                  f"{len(idx)} served answers equal it; {float((rgb > 0).mean()):.4%} of RGB values above 0, "
                  f"{len(np.unique(rgb))} distinct", flush=True)

    compare(served, "random weights")
    weight, bias = model.params["model.10.weight"], model.params["model.10.bias"]
    kept = weight.clone(), bias.clone()
    try:
        x = torch.from_numpy(reqs[0].to_rgb_u8()[None])
        y = model.forward_u8(x, to_u8=False).float()
        k = 0.25 / float(y.std())  # the answers become k (y - mean) + 0.5
        weight.copy_(weight.float() * k)
        bias.copy_(bias.float() * k + (0.5 - k * float(y.mean())))
        with EsrganServer(model, batch_size=batch, max_delay_ms=50) as srv:
            again = [f.result(timeout=600) for f in [srv.submit(img) for img in reqs]]
        compare(again, "last conv rescaled")
    finally:
        weight.copy_(kept[0])
        bias.copy_(kept[1])


def rel_rms(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / (np.sqrt(np.mean(b**2)) + 1e-12))


def rel_rms_t(a, b) -> float:
    """rel_rms of two tensors on the card, in f64 there."""
    a, b = a.double(), b.double()
    return float((a - b).pow(2).mean().sqrt() / (b.pow(2).mean().sqrt() + 1e-12))


def sam_requests(rng, Image, ImageFormat):
    """6 point and 6 box requests over the three extents: (image, point, box)."""
    out = []
    for i in range(12):
        w, h = SAM_EXTENTS[i % 3]
        img = Image(rng.integers(0, 256, (h, w, 4), np.uint8), ImageFormat.rgba_u8)
        if i % 2 == 0:
            out.append((img, (w // 3, h // 2), None))
        else:
            out.append((img, None, ((w // 8, h // 8), (w * 5 // 8, h * 3 // 4))))
    return out


def encoder_stages(params, x_u8, dtype, device):
    """The TinyViT encoder stage by stage, as tiny_vit runs it: a list of
    (name, output) ending with the embedding."""
    import torch

    from vision_tpu_torch.core.params import Params
    from vision_tpu_torch.models import mobile_sam as sam
    from vision_tpu_torch.ops import IMAGENET_MEAN, IMAGENET_STD, normalize_u8

    tp = sam.TinyVitParams()
    out = []
    with torch.inference_mode():
        p = Params(params)["enc"]
        x = normalize_u8(x_u8.to(device), IMAGENET_MEAN, IMAGENET_STD, dtype)
        x = sam.patch_embed(p["patch_embed"], x)
        out.append(("patch_embed", x))
        x = sam.conv_layer(p["layers"][0], x, tp.layers[0])
        out.append(("layers.0 (MBConv)", x))
        for i in range(1, len(tp.layers)):
            x = sam.basic_layer(p["layers"][i], x, tp.layers[i])
            out.append((f"layers.{i} (windows)", x))
        res = tp.layers[-1].resolution
        x = sam.conv_2d(p["neck"][0], x.reshape(x.shape[0], res, res, x.shape[-1]))
        x = sam.layer_norm(p["neck"][1], x)
        x = sam.conv_2d(p["neck"][2], x, 1, 1)
        out.append(("embedding", sam.layer_norm(p["neck"][3], x)))
    return out


def write_sam_gguf(path: str) -> None:
    from vision_tpu_torch.core.gguf import GGUFWriter
    from vision_tpu_torch.models.random_weights import random_mobile_sam_params

    w = GGUFWriter(path, "mobile-sam")
    for name, a in random_mobile_sam_params(0).items():
        w.add_tensor(name, a)
    w.write()


def write_small_gguf(path: str) -> None:
    from vision_tpu_torch.core.gguf import GGUFWriter
    from vision_tpu_torch.models.random_weights import random_depth_anything_params

    w = GGUFWriter(path, "depthanything")
    w.add("dino.patch_size", 14)
    w.add("dino.embed_dim", 384)
    w.add("dino.n_heads", 6)
    w.add("dino.n_layers", 12)
    w.add("depthanything.image_size", 518)
    w.add("depthanything.feature_layers", [2, 5, 8, 11])
    w.add("depthanything.tensor_data_layout", "torch")
    for name, a in random_depth_anything_params("small", seed=0).items():
        w.add_tensor(name, a)
    w.write()

def deform_inputs(gen, torch, b, hw, cin, k, dtype, off_range=3.0, stride=1, pad=None, with_mask=True,
                  off_dtype=None):
    """x (b, hw, hw, cin), offsets within +-off_range and a mask in [0, 2] at
    the output extent of a k x k conv (pad k // 2 unless given)."""
    pad = k // 2 if pad is None else pad
    ho = (hw + 2 * pad - k) // stride + 1
    x = (torch.randn(b, hw, hw, cin, device="cuda", generator=gen) * 0.5).to(dtype)
    off = ((torch.rand(b, ho, ho, 2 * k * k, device="cuda", generator=gen) * 2 - 1) * off_range).to(
        off_dtype or dtype)
    mask = (torch.rand(b, ho, ho, k * k, device="cuda", generator=gen) * 2).to(dtype) if with_mask else None
    return x, off, mask, pad


def check_columns(label: str, out, ref, dtype, torch) -> float:
    """Sampler columns against the plain version's f32 columns: f32 within
    atol + rtol; bf16 within one bf16 ulp of the reference (the kernel
    rounds each column once, from an f32 blend whose FMAs may round its last
    f32 bit otherwise). Returns the max abs error."""
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    if dtype == torch.float32:
        ok = bool((diff <= F32_ATOL + F32_RTOL * ref.abs()).all())
        rule = f"atol {F32_ATOL} rtol {F32_RTOL}"
    else:
        ok = bool((diff <= 2.0**-7 * ref.float().abs() + 1e-6).all())
        rule = "within one bf16 ulp"
    print(f"kernel deform_sample {label}: max_abs_err {err:.3e} [{rule}] {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"deform_sample {label}: max abs err {err}")
    return err


def deform_cases(dsm, torch) -> float:
    """Phase 14: the sampler against deform_sample_plain. The 256^2 shapes
    compare the batch's last image (the plain version's f32 temporaries of
    the whole batch are tens of gigabytes). Returns the largest absolute
    difference seen."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    bf16, f32 = torch.bfloat16, torch.float32
    worst = 0.0
    for hw in BIREF_BLOCK_HW:
        for k in BIREF_DEFORM_KS:
            x, off, mask, pad = deform_inputs(gen, torch, 4, hw, BIREF_CIN, k, bf16)
            before = dsm.launches
            out = dsm.deform_sample(x, off, mask, k, k, 1, pad)
            torch.cuda.synchronize()
            if dsm.launches != before + 1 or out.shape != (4, hw, hw, k * k, BIREF_CIN) or out.dtype != bf16:
                raise AssertionError(f"deform_sample ({hw}, k={k}): {tuple(out.shape)} {out.dtype}, "
                                     f"{dsm.launches - before} launches")
            s = slice(3, 4) if hw == 256 else slice(0, 4)
            ref = dsm.deform_sample_plain(x[s].float(), off[s], mask[s], k, k, 1, pad)
            err = check_columns(f"BiRefNet (4, {hw}, {hw}, {BIREF_CIN}) k={k} bf16", out[s], ref, bf16, torch)
            worst = max(worst, err)
            del x, off, mask, out, ref
    cases = [
        # (label, b, hw, cin, k, stride, pad, dtype, off_range, bound, mask, off_dtype)
        ("Cin 5 f32", 2, 9, 5, 3, 1, 1, f32, 3.0, None, True, None),
        ("Cin 12 f32 (16-byte path)", 2, 11, 12, 3, 1, 1, f32, 3.0, None, True, None),
        ("Cin 12 bf16 (one element a thread)", 2, 11, 12, 3, 1, 1, bf16, 3.0, None, True, None),
        ("stride 2 f32", 2, 17, 16, 3, 2, 1, f32, 3.0, None, True, None),
        ("samples outside the image f32", 1, 10, 8, 3, 1, 1, f32, 12.0, None, True, None),
        ("bound 2, offsets +-9 f32", 2, 12, 8, 7, 1, 3, f32, 9.0, 2, True, None),
        ("no mask f32", 2, 12, 16, 7, 1, 3, f32, 3.0, None, False, None),
        ("f16 offsets read as f32, f32 x", 1, 12, 16, 3, 1, 1, f32, 3.0, None, True, torch.float16),
    ]
    for label, b, hw, cin, k, stride, pad, dtype, rng, bound, with_mask, off_dtype in cases:
        x, off, mask, pad = deform_inputs(gen, torch, b, hw, cin, k, dtype, rng, stride, pad, with_mask, off_dtype)
        out = dsm.deform_sample(x, off, mask, k, k, stride, pad, bound)
        torch.cuda.synchronize()
        ref = dsm.deform_sample_plain(x.float(), off, mask, k, k, stride, pad, bound)
        worst = max(worst, check_columns(f"{label} ({b}, {hw}, {hw}, {cin}) k={k}", out, ref, dtype, torch))

    # more than 2^31 column elements: 64-bit offsets; the last image against
    # the plain version run on that image alone
    x, off, mask, pad = deform_inputs(gen, torch, 6, 256, BIREF_CIN, 7, f32)
    out = dsm.deform_sample(x, off, mask, 7, 7, 1, pad)
    torch.cuda.synchronize()
    ref = dsm.deform_sample_plain(x[5:], off[5:], mask[5:], 7, 7, 1, pad)
    err = check_columns(f"large (6, 256, 256, {BIREF_CIN}) k=7 f32, {out.numel()} column elements, last image",
                        out[5:], ref, f32, torch)
    del x, off, mask, out, ref
    torch.cuda.empty_cache()
    return max(worst, err)


def deform_conv_path_forms(torch, gen, b: int, hw: int, k: int, branch: int, dtype=None, cin: int = BIREF_CIN,
                           cout: int = BIREF_COUT):
    """The inputs and keywords of the BiRefNet path's call of the fused
    deformable conv for ASPP branch ``branch`` (0-3) at this shape: x, the
    offsets (within +-3) and the 2 * sigmoid mask of deform_inputs, a weight
    of scale 1 / sqrt(k^2 Cin), the conv bias, the BatchNorm's scale and
    shift, ReLU, ``out`` the branch's channels of a (b, hw, hw, 5 Cout)
    buffer filled with noise, and the weight's layout, which BirefnetModel
    makes once. Returns (x, w, off, mask, pad, kw, buf)."""
    from vision_tpu_torch.ops.cuda.deform_conv import weight_layout

    dtype = dtype or torch.bfloat16
    x, off, mask, pad = deform_inputs(gen, torch, b, hw, cin, k, dtype)
    w = (torch.randn(cout, cin, k, k, device="cuda", generator=gen) / (k * k * cin) ** 0.5).to(dtype)
    bias, shift = ((torch.randn(cout, device="cuda", generator=gen) * 0.1).to(dtype) for _ in range(2))
    scale = (torch.rand(cout, device="cuda", generator=gen) + 0.5).to(dtype)
    buf = torch.randn(b, hw, hw, 5 * cout, device="cuda", generator=gen).to(dtype)
    kw = {"bias": bias, "scale": scale, "shift": shift, "relu": True,
          "out": buf[..., branch * cout:(branch + 1) * cout], "layout": weight_layout(w, dtype)}
    return x, w, off, mask, pad, kw, buf


def deform_conv_cases(dcm, torch) -> tuple[float, float]:
    """Phase 14: the fused deformable conv against deform_conv_plain. bf16
    at the 20 shapes of a batch-4 1024x1024 BiRefNet forward with the path's
    epilogue (bias, BatchNorm scale and shift, ReLU) into its branch's
    channels of a 140-channel buffer, max abs <= BF16_MAX_ABS and every other
    channel unchanged (the 256^2 shapes compare the batch's last image); at
    k 7, 256^2 its relative RMS against the f32 result is at most
    DEFORM_ROUNDING_RATIO times that of the f32 result rounded once to bf16;
    edge cases in f32 (relative RMS <= DEFORM_F32_REL_RMS, TF32 off) and
    bf16, one with more than 2^31 column elements (which the kernel never
    holds). Returns the largest absolute difference seen and the precision
    ratio."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    bf16, f32 = torch.bfloat16, torch.float32
    worst, ratio = 0.0, None
    for hw in BIREF_BLOCK_HW:
        for branch, k in enumerate(BIREF_DEFORM_KS):
            x, w, off, mask, pad, kw, buf = deform_conv_path_forms(torch, gen, 4, hw, k, branch)
            before, keep = dcm.launches, buf.clone()
            out = dcm.deform_conv(x, w, off, mask, k, k, 1, pad, **kw)
            torch.cuda.synchronize()
            if dcm.launches != before + 1 or out.data_ptr() != kw["out"].data_ptr():
                raise AssertionError(f"deform_conv ({hw}, k={k}): {dcm.launches - before} launches, out not in place")
            c0, c1 = branch * BIREF_COUT, (branch + 1) * BIREF_COUT
            if not (torch.equal(buf[..., :c0], keep[..., :c0]) and torch.equal(buf[..., c1:], keep[..., c1:])):
                raise AssertionError(f"deform_conv ({hw}, k={k}): channels outside the view changed")
            s = slice(3, 4) if hw == 256 else slice(0, 4)
            epi = {n: v.float() for n, v in kw.items() if n in ("bias", "scale", "shift")}
            ref = dcm.deform_conv_plain(x[s].float(), w.float(), off[s], mask[s], k, k, 1, pad, relu=True, **epi)
            label = (f"deform_conv BiRefNet (4, {hw}, {hw}, {BIREF_CIN}) k={k} -> {BIREF_COUT} bf16, bias, BN, ReLU "
                     f"into channels {c0}:{c1} of {5 * BIREF_COUT}")
            worst = max(worst, check_close(label, out[s], ref, bf16, torch))
            if hw == 256 and k == 7:
                k_err, once = rel_rms_t(out[s].float(), ref), rel_rms_t(ref.to(bf16).float(), ref)
                ratio = k_err / once
                print(f"deform_conv k=7 256^2 bf16: relative RMS against the f32 result {k_err:.4e}, the f32 result "
                      f"rounded once to bf16 {once:.4e}: ratio {ratio:.4f} (bound {DEFORM_ROUNDING_RATIO})", flush=True)
                if not ratio <= DEFORM_ROUNDING_RATIO:
                    raise AssertionError(f"deform_conv bf16 precision ratio {ratio}")
            del x, w, off, mask, kw, buf, keep, out, ref
    cases = [
        # (label, b, hw, cin, cout, k, stride, pad, dtype, off_range, bound, mask, off_dtype)
        ("Cin 5, Cout 1", 2, 9, 5, 1, 3, 1, 1, f32, 3.0, None, True, None),
        ("Cin 8, Cout 28", 2, 11, 8, 28, 3, 1, 1, f32, 3.0, None, True, None),
        ("Cin 120, Cout 64", 1, 13, 120, 64, 3, 1, 1, f32, 3.0, None, True, None),
        ("stride 2", 2, 17, 16, 28, 3, 2, 1, f32, 3.0, None, True, None),
        ("samples outside the image", 1, 10, 8, 28, 3, 1, 1, f32, 12.0, None, True, None),
        ("bound 2, offsets +-9", 2, 12, 8, 28, 7, 1, 3, f32, 9.0, 2, True, None),
        ("no mask", 2, 12, 16, 28, 7, 1, 3, f32, 3.0, None, False, None),
        ("f16 offsets read as f32", 1, 12, 16, 28, 3, 1, 1, f32, 3.0, None, True, torch.float16),
        ("Cin 5, Cout 1 (one element a load)", 2, 9, 5, 1, 3, 1, 1, bf16, 3.0, None, True, None),
        ("Cin 24, Cout 64 (64-wide tile)", 2, 13, 24, 64, 3, 1, 1, bf16, 3.0, None, True, None),
        ("Cin 112, Cout 100 (two 64-wide tiles)", 1, 19, 112, 100, 7, 1, 3, bf16, 3.0, None, True, None),
        ("stride 2, bound 2, offsets +-9", 2, 21, 32, 28, 3, 2, 1, bf16, 9.0, 2, True, None),
        ("no mask, ragged 8x8 tiles", 3, 11, 16, 28, 7, 1, 3, bf16, 3.0, None, False, None),
        ("Cin 200 (two blend passes), Cout 28", 1, 13, 200, 28, 3, 1, 1, bf16, 3.0, None, True, None),
        ("Cin 112, offsets +-9 (corners far from the tile)", 1, 40, 112, 28, 7, 1, 3, bf16, 9.0, None, True, None),
    ]
    for label, b, hw, cin, cout, k, stride, pad, dtype, rng, bound, with_mask, off_dtype in cases:
        x, off, mask, pad = deform_inputs(gen, torch, b, hw, cin, k, dtype, rng, stride, pad, with_mask, off_dtype)
        w = (torch.randn(cout, cin, k, k, device="cuda", generator=gen) / (k * k * cin) ** 0.5).to(dtype)
        bias = (torch.randn(cout, device="cuda", generator=gen) * 0.1).to(dtype)
        out = dcm.deform_conv(x, w, off, mask, k, k, stride, pad, bound, bias=bias)
        torch.cuda.synchronize()
        ref = dcm.deform_conv_plain(x.float(), w.float(), off, mask, k, k, stride, pad, bound, bias=bias.float())
        label = f"deform_conv {label} ({b}, {hw}, {hw}, {cin}) k={k} -> {cout} {dtype}"
        if dtype == f32:
            err = rel_rms_t(out, ref)
            print(f"kernel {label}: relative RMS {err:.3e} [<= {DEFORM_F32_REL_RMS}] "
                  f"{'ok' if err <= DEFORM_F32_REL_RMS else 'FAIL'}", flush=True)
            if not err <= DEFORM_F32_REL_RMS:
                raise AssertionError(f"{label}: relative RMS {err}")
            err = float((out - ref).abs().max())
        else:
            err = check_close(label, out, ref, dtype, torch)
        worst = max(worst, err)

    # more than 2^31 column elements (B Ho Wo k^2 Cin): the last image against
    # the plain version run on that image alone
    x, w, off, mask, pad, kw, buf = deform_conv_path_forms(torch, gen, 6, 256, 7, 3, f32)
    out = dcm.deform_conv(x, w, off, mask, 7, 7, 1, pad, **kw)
    torch.cuda.synchronize()
    epi = {n: v for n, v in kw.items() if n in ("bias", "scale", "shift")}
    ref = dcm.deform_conv_plain(x[5:], w, off[5:], mask[5:], 7, 7, 1, pad, relu=True, **epi)
    err = rel_rms_t(out[5:], ref)
    print(f"kernel deform_conv large (6, 256, 256, {BIREF_CIN}) k=7 f32, {6 * 256 * 256 * 49 * BIREF_CIN} column "
          f"elements, last image: relative RMS {err:.3e} [<= {DEFORM_F32_REL_RMS}]", flush=True)
    if not err <= DEFORM_F32_REL_RMS:
        raise AssertionError(f"deform_conv large: relative RMS {err}")
    del x, w, off, mask, kw, buf, out, ref
    torch.cuda.empty_cache()
    return worst, ratio


def swin_windows(torch, gen, side: int, window: int, heads: int, batch: int, dtype, bias_dtype=None):
    """q, k, v of one SWIN stage's windows (the token grid padded to the
    window), a bias (heads, T, T) in ``bias_dtype`` (default ``dtype``) and
    the stage's shift mask (nW, T, T) f32 on the card."""
    from vision_tpu_torch.models.swin import compute_attention_mask

    mask = torch.tensor(compute_attention_mask(side, side, window), device="cuda")
    nw, t = mask.shape[0] * batch, window * window
    q, k, v = (torch.randn(nw, t, heads * 32, device="cuda", generator=gen).to(dtype) for _ in range(3))
    bias = (torch.randn(heads, t, t, device="cuda", generator=gen) * 0.5).to(bias_dtype or dtype)
    return q, k, v, bias, mask


def masked_window_cases(wa, torch) -> float:
    """Phase 14: the window kernel with per-window masks against
    window_attention_plain: SWIN-L's four stages at 1024x1024, batch 4, in
    bf16 with a bf16 bias (stage 1 also with an f32 one); SWIN-T's T 49
    (window 7); windows of 15 and 16 (T 225 and 256: mask and bias read from
    L2, in pairs where T is even) and f32 cases. Returns the largest absolute
    difference seen."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(f"SWIN-L stage {i + 1}", side, 12, h, 4, bf16, bf16) for i, (side, h) in enumerate(SWIN_L_STAGES)]
    cases += [("SWIN-L stage 1, f32 bias", 256, 12, 6, 4, bf16, f32),
              ("SWIN-T stage 1 at 224^2", 56, 7, 3, 2, bf16, bf16),
              ("window 15, T=225 (L2)", 30, 15, 2, 2, bf16, bf16),
              ("window 16, T=256 (L2)", 32, 16, 3, 2, bf16, f32),
              ("SWIN-L stage 4 f32", 32, 12, 48, 2, f32, f32),
              ("SWIN-T T=49 f32", 20, 7, 6, 3, f32, f32)]
    worst = 0.0
    for label, side, window, h, batch, dtype, bias_dtype in cases:
        q, k, v, bias, mask = swin_windows(torch, gen, side, window, h, batch, dtype, bias_dtype)
        before, before_masked = wa.launches, wa.masked_launches
        out = wa.window_attention(q, k, v, bias, h, 32**-0.5, mask)
        torch.cuda.synchronize()
        if wa.launches != before + 1 or wa.masked_launches != before_masked + 1:
            raise AssertionError(f"{label}: launch counts went {before} -> {wa.launches}")
        ref = wa.window_attention_plain(q, k, v, bias, h, 32**-0.5, mask).float()
        err = check_close(f"window_attention masked {label} (NW={q.shape[0]}, T={q.shape[1]}, H={h}, "
                          f"{mask.shape[0]} masks) {dtype}, bias {bias.dtype}", out, ref, dtype, torch)
        if not torch.isfinite(out).all():
            raise AssertionError(f"{label}: non-finite output")
        worst = max(worst, err)
    return worst


def write_birefnet_gguf(path: str) -> None:
    from vision_tpu_torch.core.gguf import GGUFWriter
    from vision_tpu_torch.models.random_weights import random_birefnet_params

    w = GGUFWriter(path, "birefnet")
    w.add("birefnet.image_size", 1024)
    w.add("birefnet.image_multiple", 32)
    w.add("swin.embed_dim", 192)
    for name, a in random_birefnet_params("large", 0).items():
        w.add_tensor(name, a)
    w.write()


def birefnet_stages(model, x_u8, params=None, dtype=None):
    """birefnet_predict stage by stage on the model's device: the four
    encoder levels, the squeeze block, the four decoder blocks and the mask,
    as a list of (name, output). The stages are read by wrapping the
    module's encode and basic_decoder_block for one call."""
    import torch

    from vision_tpu_torch.core.params import Params
    from vision_tpu_torch.models import birefnet as bn
    from vision_tpu_torch.ops import IMAGENET_MEAN, IMAGENET_STD, normalize_u8

    out = []
    encode, block = bn.encode, bn.basic_decoder_block

    def encode_rec(*a):
        xs = encode(*a)
        out.extend((f"encoder level {i}", f) for i, f in enumerate(xs))
        return xs

    def block_rec(*a):
        y = block(*a)
        out.append((("squeeze", "block4", "block3", "block2", "block1")[len(out) - 4], y))
        return y

    bn.encode, bn.basic_decoder_block = encode_rec, block_rec
    try:
        with torch.inference_mode():
            dt = dtype or model.dtype
            x = normalize_u8(x_u8.to(model.device.torch_device), IMAGENET_MEAN, IMAGENET_STD, dt)
            mask = bn.birefnet_predict(Params(params or model.params), x, model.p, model.deform_bound)
    finally:
        bn.encode, bn.basic_decoder_block = encode, block
    return out + [("mask", mask)]


def deform_bound_ms(b: int, hw: int, cin: int, k: int, nbytes_el: int = 2) -> tuple[float, str]:
    """The sampler's least time: columns written, x, offsets and mask read
    once (bytes), or its f32 blend on the CUDA cores (operations):
    BLEND_FLOPS per column element."""
    cols = b * hw * hw * k * k * cin
    nbytes = nbytes_el * (cols + b * hw * hw * cin + b * hw * hw * 3 * k * k)
    t_ops, t_bytes = BLEND_FLOPS * cols / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def grid_sample_yardstick(x, off, k: int, pad: int, torch):
    """F.grid_sample over all taps: the same bilinear samples (zeros outside,
    no modulation) of the NCHW view of x at the deformed positions, laid
    out (B, Cin, Ho, Wo * K^2). Returns the call and its grid (made here,
    outside the timing)."""
    import torch.nn.functional as F

    b, h, w, _ = x.shape
    ho, wo = off.shape[1], off.shape[2]
    kk = k * k
    o = off.float().reshape(b, ho, wo, kk, 2)
    ky = torch.arange(k, device="cuda").repeat_interleave(k)
    kx = torch.arange(k, device="cuda").repeat(k)
    py = (torch.arange(ho, device="cuda") - pad)[:, None, None] + ky + o[..., 0]
    px = (torch.arange(wo, device="cuda") - pad)[None, :, None] + kx + o[..., 1]
    # align_corners=False: pixel i's centre is at (2i + 1) / n - 1
    grid = torch.stack([(2 * px + 1) / w - 1, (2 * py + 1) / h - 1], dim=-1).reshape(b, ho, wo * kk, 2).to(x.dtype)
    xc = x.permute(0, 3, 1, 2)  # an NHWC tensor is a channels-last NCHW one
    return lambda: F.grid_sample(xc, grid, "bilinear", "zeros", align_corners=False)


def deform_conv_bound_ms(b: int, hw: int, cin: int, cout: int, k: int) -> tuple[float, str]:
    """The fused deformable conv's least time in bf16: x, the offsets, the
    mask and the weight read once and the output written once (bytes), or
    the larger of its f32 blend on the CUDA cores (BLEND_FLOPS per column
    element) and its product on the tensor cores (operations), in the
    kernel's order: blend the Cin channels of each (pixel, tap), then
    multiply. The columns are never written. The other order, a product of
    every input pixel with each tap's weight and then a blend of its Cout
    results, does fewer operations where Cout < Cin (BiRefNet's 28 < 112:
    a blend a quarter as long, with the same product at stride 1); this
    bound does not count that order."""
    cols = b * hw * hw * k * k * cin
    nbytes = 2.0 * (b * hw * hw * (cin + 3 * k * k + cout) + k * k * cin * cout)
    t_ops = max(BLEND_FLOPS * cols / PEAK_F32_FLOPS, 2.0 * cols * cout / PEAK_BF16_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def deform_timings(dsm, dcm, torch, card: str) -> dict:
    """Phase 17: at each distinct (extent, k) of a batch-4 1024x1024 BiRefNet
    forward, by the card's own time (device_ms): the fused kernel with the
    path's epilogue and view (and bare), against the parent's route (the
    column sampler, then torch.matmul of its columns) in turns; the plain
    version; the yardstick, F.grid_sample over all taps, the mask product
    and torch.matmul of (B Ho Wo, k^2 Cin) columns, each timed alone and
    summed (library calls the port never makes); the sampler alone with
    its plain version; and the weight's layout (two device passes that the
    model makes once, and a call given no layout at every call), alone and
    per call with the host's work. Returns {(hw, k): {name: ms, ...}}."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    bf16 = torch.bfloat16
    rows = {}
    for hw in sorted(set(BIREF_BLOCK_HW)):
        for k in sorted(set(BIREF_DEFORM_KS)):
            kk = k * k
            x, w, off, mask, pad, kw, _ = deform_conv_path_forms(torch, gen, 4, hw, k, 3)
            wmat = w.permute(2, 3, 1, 0).reshape(kk * BIREF_CIN, BIREF_COUT).contiguous()
            cols = torch.empty(4 * hw * hw, kk * BIREF_CIN, device="cuda", dtype=bf16).normal_(generator=gen)
            run_f = lambda: dcm.deform_conv(x, w, off, mask, k, k, 1, pad, **kw)  # noqa: E731
            run_b = lambda: dcm.deform_conv(x, w, off, mask, k, k, 1, pad, layout=kw["layout"])  # noqa: E731
            run_l = lambda: dcm.weight_layout(w, bf16)  # noqa: E731
            plain_kw = {n: v for n, v in kw.items() if n != "layout"}  # the plain version reads the weight
            run_p = lambda: dcm.deform_conv_plain(x, w, off, mask, k, k, 1, pad, **plain_kw)  # noqa: E731
            run_s = lambda: dsm.deform_sample(x, off, mask, k, k, 1, pad)  # noqa: E731
            run_sp = lambda: dsm.deform_sample_plain(x, off, mask, k, k, 1, pad)  # noqa: E731
            run_r = lambda: torch.matmul(run_s().view(-1, kk * BIREF_CIN), wmat)  # noqa: E731
            run_g = grid_sample_yardstick(x, off, k, pad, torch)
            sampled = run_g()  # (B, Cin, Ho, Wo k^2)
            m4 = mask.reshape(4, 1, hw, hw * kk)
            run_m = lambda: sampled * m4  # noqa: E731
            run_mm = lambda: torch.matmul(cols, wmat)  # noqa: E731
            f1, r1, f2, r2 = (device_ms(fn) for fn in (run_f, run_r, run_f, run_r))
            t = {"fused": min(f1, f2), "route": min(r1, r2), "bare": device_ms(run_b), "sampler": device_ms(run_s),
                 "grid_sample": device_ms(run_g), "mask_product": device_ms(run_m), "matmul": device_ms(run_mm),
                 "plain": device_ms(run_p, calls=2, warmup=1, reps=1),
                 "sampler_plain": device_ms(run_sp, calls=1, warmup=1, reps=1),
                 "layout": device_ms(run_l), "layout_call": median_ms(run_l, 10)}
            t["library"] = t["grid_sample"] + t["mask_product"] + t["matmul"]
            # what one call allocates above its inputs: the fused kernel
            # nothing but its output, the parent's route its columns too
            for key, fn in (("fused_alloc_mib", run_b), ("route_alloc_mib", run_r)):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                fn()
                torch.cuda.synchronize()
                t[key] = (torch.cuda.max_memory_allocated() - before) / 2**20
            t["bound"], t["bound_by"] = deform_conv_bound_ms(4, hw, BIREF_CIN, BIREF_COUT, k)
            t["sampler_bound"], t["sampler_bound_by"] = deform_bound_ms(4, hw, BIREF_CIN, k)
            rows[(hw, k)] = t
            print(f"deform_conv (4, {hw}, {hw}, {BIREF_CIN}) k={k} -> {BIREF_COUT} bf16 on the card: fused kernel with "
                  f"the path's epilogue into a view {f1:.4f} / {f2:.4f} ms, bare {t['bare']:.4f} ms; the weight's "
                  f"layout {t['layout']:.4f} ms ({t['layout_call']:.4f} ms a call with the host's work), made once by "
                  f"the model; parent's route "
                  f"(sampler + matmul) {r1:.4f} / {r2:.4f} ms, sampler alone {t['sampler']:.4f} ms; yardstick "
                  f"{t['library']:.4f} ms (F.grid_sample {t['grid_sample']:.4f} + mask product "
                  f"{t['mask_product']:.4f} + matmul {t['matmul']:.4f}); plain {t['plain']:.4f} ms, sampler plain "
                  f"{t['sampler_plain']:.4f} ms; bound {t['bound']:.4f} ms ({t['bound_by']}), sampler's "
                  f"{t['sampler_bound']:.4f} ms ({t['sampler_bound_by']}); one call allocates "
                  f"{t['fused_alloc_mib']:.1f} MiB fused, {t['route_alloc_mib']:.1f} MiB by the parent's route "
                  f"[{card}]", flush=True)
            del x, w, off, mask, kw, wmat, cols, sampled, m4, run_g
            torch.cuda.empty_cache()
    return rows


def masked_window_yardsticks(wa, torch, card: str) -> list:
    """Phase 17: the masked window kernel against its plain version and SDPA
    given the combined mask (bias + the stage's shift mask, per window),
    at SWIN-L's four stages, batch 4: the card's own time of each
    (device_ms, in turns) and CUDA events around single calls of the kernel
    and SDPA. Returns (label, kernel, plain, library, bound, bound_by), the
    times the card's own."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = []
    for i, (side, h) in enumerate(SWIN_L_STAGES):
        q, k, v, bias, mask = swin_windows(torch, gen, side, 12, h, 4, torch.bfloat16)
        nw, t, c = q.shape
        q4, k4, v4 = (z.view(nw, t, h, 32).transpose(1, 2).contiguous() for z in (q, k, v))
        combined = (bias.float()[None] + mask.repeat(nw // mask.shape[0], 1, 1)[:, None]).to(torch.bfloat16)
        run_k = lambda: wa.window_attention(q, k, v, bias, h, 32**-0.5, mask)  # noqa: E731
        run_p = lambda: wa.window_attention_plain(q, k, v, bias, h, 32**-0.5, mask)  # noqa: E731
        run_l = lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=combined)  # noqa: E731
        k1, p1, l1, k2, p2, l2 = (device_ms(f) for f in (run_k, run_p, run_l, run_k, run_p, run_l))
        ek, el = (median_ms(f, 10) for f in (run_k, run_l))
        b, by = bound_ms(4.0 * nw * h * t * t * 32, 4 * 2.0 * nw * t * c + 2.0 * h * t * t + 4.0 * mask.numel())
        label = f"SWIN-L stage {i + 1} (NW={nw}, T={t}, H={h}, hd=32) bf16, {mask.shape[0]} masks"
        rows.append((label, min(k1, k2), min(p1, p2), min(l1, l2), b, by))
        print(f"window_attention masked {label} on the card: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / "
              f"{p2:.4f} ms, SDPA with the combined mask {l1:.4f} / {l2:.4f} ms, bound {b:.4f} ms ({by}); per call "
              f"with the host's launch work: kernel {ek:.4f} ms, SDPA {el:.4f} ms [{card}]", flush=True)
        del q, k, v, q4, k4, v4, combined
        torch.cuda.empty_cache()
    return rows


def sam3_text_params(seed: int = 1) -> dict[str, np.ndarray]:
    """CLIP text-encoder weights at the widths the JAX package's SAM3 code
    assumes (24 layers, vision_tpu/models/sam3.py:195; 16 heads, :174; width
    1024 with an MLP of 4096; the 49408-token vocabulary, :91-94; 32
    positions, the max_length of :983), random from ``seed``, in f16 under
    the GGUF names (``det.te.text_model.*``; no text projection, which the
    converter skips). The repo holds no SAM3 checkpoint to take them from."""
    rng = np.random.default_rng(seed)
    c, m = SAM3_TEXT["width"], SAM3_TEXT["mlp"]
    pre = "det.te.text_model."
    p = {}

    def w(name, *shape, scale=None):
        scale = 1.0 / np.sqrt(shape[-1]) if scale is None else scale
        p[pre + name] = (rng.standard_normal(shape, dtype=np.float32) * scale).astype(np.float16)

    def ln(name):
        p[pre + name + ".weight"] = np.ones(c, np.float16)
        p[pre + name + ".bias"] = np.zeros(c, np.float16)

    def lin(name, ci, co):
        w(name + ".weight", co, ci)
        p[pre + name + ".bias"] = np.zeros(co, np.float16)

    w("embeddings.token_embedding.weight", SAM3_TEXT["vocab"], c, scale=0.02)
    w("embeddings.position_embedding.weight", SAM3_TEXT["max_length"], c, scale=0.02)
    for i in range(SAM3_TEXT["layers"]):
        base = f"encoder.layers.{i}"
        ln(f"{base}.layer_norm1")
        ln(f"{base}.layer_norm2")
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            lin(f"{base}.self_attn.{proj}", c, c)
        lin(f"{base}.mlp.fc1", c, m)
        lin(f"{base}.mlp.fc2", m, c)
    ln("final_layer_norm")
    return p


def sam3_vocab() -> tuple[list[str], list[str]]:
    """A synthetic CLIP vocabulary of 49408 entries (BOS 49406, EOS 49407)
    and a few merges, enough for the prompts of SAM3_PROMPTS to take real
    BPE steps."""
    chars = "abcdefghijklmnopqrstuvwxyz0123456789!?.,"
    tokens = list(chars) + [ch + "</w>" for ch in chars]
    merges = [("c", "a"), ("ca", "t</w>"), ("t", "h"), ("th", "e</w>"), ("r", "e"), ("re", "d</w>"),
              ("c", "ar</w>"), ("a", "r</w>"), ("d", "o"), ("do", "g"), ("dog", "s</w>"), ("l", "e"),
              ("le", "f"), ("lef", "t</w>")]
    tokens += [a + b for a, b in merges if a + b not in tokens]
    tokens += [f"<unused{i}>" for i in range(SAM3_TEXT["vocab"] - 2 - len(tokens))]
    tokens += ["<|startoftext|>", "<|endoftext|>"]
    return tokens, [f"{a} {b}" for a, b in merges]


def write_sam3_gguf(path: str) -> int:
    """A SAM3 GGUF in f16: random_sam3_vision_params(0) (ViT-H, 1280 wide,
    32 layers, FPN 256) under det.ve., sam3_text_params() under det.te.,
    the synthetic vocabulary and sam3.tokenizer.max_length. Returns its
    size in bytes."""
    from vision_tpu_torch.core.gguf import GGUFWriter
    from vision_tpu_torch.models.random_weights import random_sam3_vision_params

    w = GGUFWriter(path, "sam3")
    tokens, merges = sam3_vocab()
    w.add("tokenizer.ggml.tokens", tokens)
    w.add("tokenizer.ggml.merges", merges)
    w.add("tokenizer.ggml.bos_token_id", len(tokens) - 2)
    w.add("tokenizer.ggml.eos_token_id", len(tokens) - 1)
    w.add("tokenizer.ggml.padding_token_id", len(tokens) - 1)
    w.add("tokenizer.ggml.unknown_token_id", len(tokens) - 1)
    w.add("sam3.tokenizer.max_length", SAM3_TEXT["max_length"])
    for name, a in random_sam3_vision_params(0).items():
        w.add_tensor(f"det.ve.{name}", a.astype(np.float16))
    for name, a in sam3_text_params().items():
        w.add_tensor(name, a)
    w.write()
    return os.path.getsize(path)


def sam3_vision_flops(vp, batch: int, dim: int = 1280, fpn_ch: int = 256) -> float:
    """FLOPs of one encode_vision at vp's image size, counted from the
    shapes: the patch conv, each layer's four projections (over the padded
    windows' tokens in a window layer) and MLP (4x), each window and global
    attention (q k^T and p v), and the neck's transposed convs and 1x1 / 3x3
    projections."""
    g = vp.image_size // vp.patch_size
    t = g * g
    flops = 2.0 * t * 3 * vp.patch_size**2 * dim
    n_win = (-(-g // vp.window_size)) ** 2  # zero-padded windows: their tokens are projected and attended too
    for i in range(vp.n_layers):
        flops += 2.0 * t * 8 * dim * dim  # MLP
        if i in vp.global_attn_indexes:
            flops += 2.0 * t * 4 * dim * dim + 4.0 * t * t * dim
        else:
            flops += 2.0 * n_win * vp.window_size**2 * 4 * dim * dim + 4.0 * n_win * vp.window_size**4 * dim
    flops += 2 * (2.0 * t * dim * (dim // 2) * 4)  # levels 0 and 1: dim -> dim/2 transposed conv at g^2
    flops += 2.0 * (4 * t) * (dim // 2) * (dim // 4) * 4  # level 0: dim/2 -> dim/4 at (2g)^2
    for side, ci in ((4 * g, dim // 4), (2 * g, dim // 2), (g, dim), (g // 2, dim)):
        flops += 2.0 * side * side * fpn_ch * (ci + 9 * fpn_ch)
    return batch * flops


def sam3_stack(params: dict, n: int | None = None) -> dict:
    """The window-major trunk's stacked window weights a Sam3Model keeps in
    its params (det.ve.backbone.window_stack.*), their first ``n`` layers
    (a trunk cut to depth)."""
    from vision_tpu_torch.models.sam3 import _SAM3_LAYER_LEAVES, WINDOW_STACK

    return {leaf: params[f"det.ve.backbone.{WINDOW_STACK}.{leaf}"][:n] for leaf in _SAM3_LAYER_LEAVES}


def sam3_two_layers(params: dict) -> tuple[dict, dict]:
    """Phase 20's two-layer trunk (Sam3VitParams(n_layers=2,
    global_attn_indexes=(1,))) on a stacked model's weights: the first
    window layer from the stack, and layer 1's weights (a window layer of
    the full trunk) run as the global layer, as flat views of the stack.
    Returns (params, win_stack)."""
    from vision_tpu_torch.models.sam3 import window_layers

    two = dict(params)
    two.update({f"det.ve.backbone.layers.1.{leaf}": v for leaf, v in window_layers(sam3_stack(params, 2))[1].items()})
    return two, sam3_stack(params, 1)


def sam3_spatial_twin(params: dict, vp) -> dict:
    """``params`` with the flat window-layer weights the spatial trunk reads,
    as views of the model's stack (no copy): the spatial trunk on the same
    weights, for the trunks' comparison."""
    from vision_tpu_torch.models.sam3 import window_layers

    twin = dict(params)
    win_idx = [i for i in range(vp.n_layers) if i not in vp.global_attn_indexes]
    for i, layer in zip(win_idx, window_layers(sam3_stack(params))):
        twin.update({f"det.ve.backbone.layers.{i}.{leaf}": v for leaf, v in layer.items()})
    return twin


def sam3_flash_cases(fa, torch) -> float:
    """Phase 18: the flash kernel at head dim 80 against its plain version:
    SAM3's global layers at batch 1 and 4, a ragged cross case, in bf16 and
    f32; bf16 also within FLASH_D80_BF16_REL_RMS of the f32 result. Returns
    the largest absolute difference seen."""
    bf16, f32 = torch.bfloat16, torch.float32
    t = (1008 // 14) ** 2
    cases = [  # (label, B, H, Tq, Tk, dtype)
        ("SAM3 global, batch 1", 1, 16, t, t, bf16),
        ("SAM3 global, batch 4", 4, 16, t, t, bf16),
        ("ragged cross", 2, 3, 1000, 1300, bf16),
        ("ragged, one past a tile", 1, 2, 129, 257, bf16),
        ("SAM3 global, batch 1", 1, 16, t, t, f32),
        ("ragged cross", 2, 3, 1000, 1300, f32),
    ]
    gen = torch.Generator(device="cuda").manual_seed(18)
    worst = 0.0
    for label, b, h, tq, tk, dtype in cases:
        q = torch.randn(b, h, tq, 80, device="cuda", generator=gen).to(dtype)
        k, v = (torch.randn(b, h, tk, 80, device="cuda", generator=gen).to(dtype) for _ in range(2))
        before = fa.launches
        out = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        if fa.launches != before + 1 or out.shape != q.shape or out.dtype != dtype:
            raise AssertionError(f"{label}: launches {before} -> {fa.launches}, output {tuple(out.shape)} {out.dtype}")
        ref = fa.flash_attention_plain(q.float(), k.float(), v.float(), 80**-0.5)
        name = f"flash_attention {label} (B={b} H={h} Tq={tq} Tk={tk} D=80 {dtype})"
        worst = max(worst, check_close(name, out, ref, dtype, torch))
        if dtype == bf16:
            rms = rel_rms_t(out.float(), ref)
            ok = rms <= FLASH_D80_BF16_REL_RMS
            print(f"kernel {name}: relative RMS {rms:.3e} (output RMS {float(ref.pow(2).mean().sqrt()):.3e}) "
                  f"[<= {FLASH_D80_BF16_REL_RMS}] {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"{name}: relative RMS {rms}")
        del q, k, v, out, ref
    return worst


def sam3_flash_timings(fa, torch, card: str) -> list:
    """Phase 21: the D-80 instance at SAM3's global shapes, batch 1 and 4,
    against its plain version, SDPA (a yardstick the port never calls) and
    the bound, by the card's own time, in turns. Returns per shape (BH,
    kernel ms, plain ms, SDPA ms, bound ms, bound by)."""
    import torch.nn.functional as F

    t = (1008 // 14) ** 2
    gen = torch.Generator(device="cuda").manual_seed(21)
    rows = []
    for b in (1, 4):
        q, k, v = (torch.randn(b, 16, t, 80, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(3))
        run_k = lambda: fa.flash_attention(q, k, v)  # noqa: E731
        run_p = lambda: fa.flash_attention_plain(q, k, v, 80**-0.5)  # noqa: E731
        run_l = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
        k1, p1, l1, l2, p2, k2 = (device_ms(f, calls=c) for f, c in ((run_k, 20), (run_p, 5), (run_l, 20),
                                                                  (run_l, 20), (run_p, 5), (run_k, 20)))
        bh = 16 * b
        bound, by = bound_ms(4.0 * bh * t * t * 80, 4 * 2.0 * bh * t * 80)
        rows.append((bh, min(k1, k2), min(p1, p2), min(l1, l2), bound, by))
        print(f"flash_attention ({bh}, {t}, 80) bf16 on the card: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / "
              f"{p2:.4f} ms, SDPA {l1:.4f} / {l2:.4f} ms, bound {bound:.4f} ms ({by}), kernel at "
              f"{bound / min(k1, k2):.2%} of the bound; per call with the host's launch work: kernel "
              f"{median_ms(run_k, 20):.4f} ms [{card}]", flush=True)
        del q, k, v
    return rows


def sam3_layer_breakdown(torch, card: str, params: dict, vp, busy_ms: float) -> None:
    """Phase 21: one window layer (window-major, as the model's trunk runs
    it, and spatial) and one global layer of the trunk at batch 1 and vp's
    image size, and the parts of them that are not products, by the card's
    own time: the spatial trunk's window partition and reverse (which the
    window-major trunk drops), RoPE on q and k, the six weight products,
    and (in the global layer) the flash kernel."""
    import torch.nn.functional as F

    from vision_tpu_torch.core.params import Params
    from vision_tpu_torch.models.mobile_sam import window_partition, window_reverse
    from vision_tpu_torch.models.sam3 import (_vision_layer_tokens, apply_rope_2d, rope_attention, vision_layer,
                                              window_layers)

    layers = Params(params)["det.ve.backbone.layers"]
    g, w, heads = vp.image_size // vp.patch_size, vp.window_size, vp.n_heads
    glob_i = vp.global_attn_indexes[0]
    lp = Params(window_layers(sam3_stack(params, 1))[0])  # the first window layer, a view of the stack
    c = lp["mlp.fc1"].weight("weight").shape[1]
    gen = torch.Generator(device="cuda").manual_seed(22)
    x = torch.randn(1, g, g, c, device="cuda", generator=gen).to(torch.bfloat16)
    tok = x.reshape(1, g * g, c)
    n_win = window_partition(x, w).shape[0]
    qw = torch.randn(n_win, w * w, heads, c // heads, device="cuda", generator=gen).to(torch.bfloat16)
    qg = torch.randn(1, heads, g * g, c // heads, device="cuda", generator=gen).to(torch.bfloat16)
    ws = [lp[f"attention.{n}"].weight("weight") for n in ("q_proj", "k_proj", "v_proj", "o_proj")]
    fc1, fc2 = lp["mlp.fc1"].weight("weight"), lp["mlp.fc2"].weight("weight")
    hidden = torch.randn(1, g * g, fc1.shape[0], device="cuda", generator=gen).to(torch.bfloat16)
    scale_global = float(w) / float(g)
    xw = window_partition(x, w)
    parts = [
        ("window layer, window-major (the model's trunk)", lambda: _vision_layer_tokens(lp, xw, heads, w, 1.0)),
        ("window layer, spatial (partition and reverse inside)", lambda: vision_layer(lp, x, w, heads, w, 1.0)),
        ("rope_attention, window form (q, k, v, RoPE, the attention, o)",
         lambda: rope_attention(lp["attention"], xw, heads, w, 1.0)),
        ("global layer", lambda: vision_layer(layers[glob_i], x, 0, heads, g, scale_global, flash=True)),
        ("window partition + reverse", lambda: window_reverse(window_partition(x, w), g, g, w)),
        ("RoPE of q and k, window form", lambda: [apply_rope_2d(qw, w, 1.0, "bthd") for _ in range(2)]),
        ("RoPE of q and k, global form", lambda: [apply_rope_2d(qg, g, scale_global) for _ in range(2)]),
        ("six weight products (q, k, v, o, fc1, fc2)",
         lambda: ([F.linear(tok, wt) for wt in ws], F.linear(tok, fc1), F.linear(hidden, fc2))),
    ]
    with torch.inference_mode():
        times = {name: device_ms(run, calls=10) for name, run in parts}
    n_window = vp.n_layers - len(vp.global_attn_indexes)
    for name, ms in times.items():
        print(f"SAM3 trunk at batch 1, {vp.image_size}x{vp.image_size} bf16: {name} {ms:.4f} ms [{card}]", flush=True)
    pr, rope = times["window partition + reverse"], times["RoPE of q and k, window form"]
    products = times["six weight products (q, k, v, o, fc1, fc2)"]
    # the four projections are a third of the six products' FLOPs
    core = times["rope_attention, window form (q, k, v, RoPE, the attention, o)"] - rope - products / 3
    print(f"the spatial trunk's {n_window} window partitions + reverses: {n_window * pr:.3f} ms, "
          f"{n_window * pr / busy_ms:.2%} of a batch-1 window-major encode_vision's {busy_ms:.3f} ms busy (what that "
          f"trunk drops); "
          f"their RoPE {n_window * rope / busy_ms:.2%}; their attention past RoPE and the projections (logits, scale, "
          f"f32 softmax, casts, P V, layout copies; rope_attention less RoPE and a third of the six products) "
          f"~{core:.4f} ms a layer, ~{n_window * core / busy_ms:.2%}; all layers' products "
          f"{vp.n_layers * products / busy_ms:.2%} [{card}]", flush=True)


def sam3_phases(torch, card: str, fa, wa, cc, dsm, dcm) -> dict:
    """Phases 18-21: the flash kernel's D-80 instance against its plain
    version; SAM3 through Sam3Model (a GGUF written at run time); its parity
    on the card against the CPU; its timings. Returns what the kernels line
    reports of it."""
    from vision_tpu_torch.core.device import backend_init
    from vision_tpu_torch.core.params import Params
    from vision_tpu_torch.image import Image, ImageFormat
    from vision_tpu_torch.models.sam3 import Sam3VitParams, encode_vision, sam3_load_model, sam3_process_input

    phase("18 flash kernel at head dim 80 (SAM3's global layers) against its plain version")
    worst80 = sam3_flash_cases(fa, torch)

    phase("19 SAM3 path: ViT-H RoPE encoder + FPN neck and the CLIP text encoder through Sam3Model")
    s3rng = np.random.default_rng(19)
    s3_imgs = [Image(s3rng.integers(0, 256, (h, w, 4), np.uint8), ImageFormat.rgba_u8) for w, h in SAM3_EXTENTS]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sam3-random.gguf")
        t0 = time.perf_counter()
        gguf_bytes = write_sam3_gguf(path)
        gguf_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        s3model = sam3_load_model(path, backend_init("gpu"))
        load_s = time.perf_counter() - t0
        cpu_s3model = sam3_load_model(path, backend_init("cpu"))
    vp = s3model.vp
    print(f"model on {s3model.device.torch_device} {s3model.dtype}, flash={s3model.flash}, {vp}, "
          f"{s3model.n_text_layers} text layers, max_tokens {s3model.max_tokens}; f16 GGUF of {gguf_bytes / 2**30:.2f} "
          f"GiB written in {gguf_s:.1f} s, loaded on the card in {load_s:.1f} s (deleted since)", flush=True)
    # the window-major trunk's stack, built at the model's first vision use:
    # allocated MiB before and after, and the peak between (the flat window
    # copies must be freed, not kept beside the stack)
    win_idx = [i for i in range(vp.n_layers) if i not in vp.global_attn_indexes]
    flat_mib = sum(v.numel() * v.element_size() for k, v in s3model.params.items()
                   if any(k.startswith(f"det.ve.backbone.layers.{i}.") for i in win_idx)) / 2**20
    torch.cuda.synchronize()
    stack_mib = {"before": torch.cuda.memory_allocated() / 2**20}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s3model._vision_stack()
    torch.cuda.synchronize()
    stack_mib.update(after=torch.cuda.memory_allocated() / 2**20, peak=torch.cuda.max_memory_allocated() / 2**20,
                     flat=flat_mib, seconds=time.perf_counter() - t0)
    print(f"window stack of {len(win_idx)} layers built in {stack_mib['seconds']:.3f} s: allocated "
          f"{stack_mib['before']:.1f} MiB before, {stack_mib['after']:.1f} MiB after (peak {stack_mib['peak']:.1f}); "
          f"the flat window copies {flat_mib:.1f} MiB, freed {stack_mib['before'] + flat_mib - stack_mib['after']:.1f} "
          f"MiB of them net of the stack [{card}]", flush=True)
    if stack_mib["after"] > stack_mib["before"] + 0.05 * flat_mib:
        raise AssertionError(f"the window stack kept the flat copies: {stack_mib}")
    want = {"flash": len(vp.global_attn_indexes), "window": 0, "conv3x3": 0, "deform_conv": 0, "deform_sample": 0}
    sam3_launches = 0
    for img in s3_imgs:
        zero_counts()
        fpn = s3model.encode_vision(img)
        torch.cuda.synchronize()
        got = {"flash": fa.launches, "window": wa.launches, "conv3x3": cc.launches, "deform_conv": dcm.launches,
               "deform_sample": dsm.launches}
        sam3_launches += fa.launches
        shapes = [tuple(h.shape) for h in fpn]
        if shapes != [(1, side, side, ch) for side, ch in SAM3_FPN] or got != want:
            raise AssertionError(f"encode_vision {img.extent}: levels {shapes}, launches {got} (expected {want})")
        if not all(bool(torch.isfinite(h).all()) for h in fpn):
            raise AssertionError(f"encode_vision {img.extent}: non-finite output")
        print(f"encode_vision {img.extent[0]}x{img.extent[1]}: levels {shapes} {fpn[0].dtype}, finite; launches {got}",
              flush=True)
    zero_counts()
    texts = [s3model.encode_text(t) for t in SAM3_PROMPTS]
    torch.cuda.synchronize()
    text_launches = fa.launches + wa.launches + cc.launches + dsm.launches + dcm.launches
    width = SAM3_TEXT["width"]
    for prompt, out in zip(SAM3_PROMPTS, texts):
        if tuple(out.shape) != (1, SAM3_TEXT["max_length"], width) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"encode_text {prompt!r}: {tuple(out.shape)}, finite {bool(torch.isfinite(out).all())}")
    if text_launches:
        raise AssertionError(f"encode_text launched {text_launches} hand-written kernels (its masked attention has none)")
    print(f"encode_text x{len(SAM3_PROMPTS)}: (1, {SAM3_TEXT['max_length']}, {width}) {texts[0].dtype}, finite; "
          f"ids of {SAM3_PROMPTS[1]!r}: {s3model.tokenizer.tokenize(SAM3_PROMPTS[1], 12).token_ids.tolist()}",
          flush=True)

    phase("20 SAM3 parity: card bf16 and f32 (kernel route) vs CPU f32 (plain route)")
    vp2 = Sam3VitParams(n_layers=2, global_attn_indexes=(1,))
    x_cpu = torch.from_numpy(sam3_process_input(s3_imgs[0], vp.image_size)[None])
    cpu_s3model._vision_stack()  # the CPU model's window-major trunk (its stack; the flat window copies dropped)
    # f32 on the card from the CPU model's weights (the file's f16 values, exact in f32)
    f32_params = {k: v.to("cuda") for k, v in cpu_s3model.params.items() if k.startswith("det.ve.")}
    with torch.inference_mode():
        t0 = time.perf_counter()
        two, stack1 = sam3_two_layers(cpu_s3model.params)
        cpu_two = encode_vision(Params(two)["det.ve"], x_cpu, vp2, flash=cpu_s3model.flash, win_stack=stack1)
        cpu_s = time.perf_counter() - t0
        before = fa.launches
        two, stack1 = sam3_two_layers(f32_params)
        f32_two = encode_vision(Params(two)["det.ve"], x_cpu.cuda(), vp2, flash=True, win_stack=stack1)
        two, stack1 = sam3_two_layers(s3model.params)
        bf16_two = encode_vision(Params(two)["det.ve"], x_cpu.cuda().bfloat16(), vp2, flash=True, win_stack=stack1)
        del two, stack1
        torch.cuda.synchronize()
    if fa.launches != before + 2:
        raise AssertionError(f"two-layer forwards launched flash {fa.launches - before} times (2 expected)")
    two_f32, two_bf16 = [], []
    for i, (c, f, b) in enumerate(zip(cpu_two.fpn_hidden_states, f32_two.fpn_hidden_states,
                                      bf16_two.fpn_hidden_states)):
        two_f32.append(rel_rms(f.cpu(), c))
        two_bf16.append(rel_rms(b.float().cpu(), c))
        print(f"two layers (window, global at T {(vp.image_size // vp.patch_size) ** 2}, D 80) + neck, level {i} "
              f"{tuple(c.shape)}: relative RMS card f32 vs CPU f32 {two_f32[-1]:.4e} (bound {SAM3_F32_REL_RMS}), "
              f"card bf16 vs CPU f32 {two_bf16[-1]:.4e} (bound {E2E_REL_RMS})", flush=True)
    print(f"CPU f32 two-layer forward: {cpu_s:.1f} s", flush=True)
    if not (max(two_f32) <= SAM3_F32_REL_RMS and max(two_bf16) <= E2E_REL_RMS):
        raise AssertionError(f"SAM3 two-layer parity: f32 {two_f32}, bf16 {two_bf16}")
    text_rms = [rel_rms(out.float().cpu(), cpu_s3model.encode_text(t)) for t, out in zip(SAM3_PROMPTS, texts)]
    print(f"encode_text card bf16 vs CPU f32, relative RMS per prompt: {[f'{r:.4e}' for r in text_rms]} "
          f"(bound {E2E_REL_RMS})", flush=True)
    if not max(text_rms) <= E2E_REL_RMS:
        raise AssertionError(f"encode_text parity {text_rms}")
    card_stack = s3model._window_layers()
    with torch.inference_mode():
        x_gpu = x_cpu.cuda()
        full_f32 = encode_vision(Params(f32_params)["det.ve"], x_gpu, vp, flash=True,
                                 win_stack=sam3_stack(f32_params)).fpn_hidden_states
        full_bf16 = encode_vision(Params(s3model.params)["det.ve"], x_gpu.bfloat16(), vp, flash=True,
                                  win_stack=card_stack).fpn_hidden_states
        kernel_route = fa.flash_attention
        fa.flash_attention = lambda q, k, v, scale=None, mask=None: fa.flash_attention_plain(q, k, v, scale)
        try:
            plain_bf16 = encode_vision(Params(s3model.params)["det.ve"], x_gpu.bfloat16(), vp, flash=True,
                                       win_stack=card_stack).fpn_hidden_states
        finally:
            fa.flash_attention = kernel_route
    full_rms = max(rel_rms_t(b.float(), f) for b, f in zip(full_bf16, full_f32))
    plain_rms = max(rel_rms_t(b.float(), f) for b, f in zip(plain_bf16, full_f32))
    full_ok = full_rms <= E2E_REL_RMS or full_rms <= SAM3_PLAIN_RATIO * plain_rms
    print(f"full depth ({vp.n_layers} layers) + neck, worst level: relative RMS card bf16 vs card f32 {full_rms:.4e}, "
          f"with the global layers on the plain version {plain_rms:.4e} (ratio {full_rms / plain_rms:.4f}); bound "
          f"{E2E_REL_RMS}, else the ratio <= {SAM3_PLAIN_RATIO}: {'ok' if full_ok else 'FAIL'}", flush=True)
    if not full_ok:
        raise AssertionError(f"SAM3 full-depth bf16 {full_rms} vs {plain_rms} with the plain global layers")
    del f32_params, full_f32, full_bf16, plain_bf16, f32_two, bf16_two, cpu_two

    phase(f"21 SAM3 timings on {card}")
    s3_rows = sam3_flash_timings(fa, torch, card)
    for img in s3_imgs:
        t_prep = []
        for _ in range(3):
            t0 = time.perf_counter()
            sam3_process_input(img, vp.image_size)
            t_prep.append((time.perf_counter() - t0) * 1e3)
        print(f"host prep of a {img.extent[0]}x{img.extent[1]} request (sam3_process_input: resize to "
              f"{vp.image_size}x{vp.image_size}, [-1, 1] f32): median {float(np.median(t_prep)):.3f} ms [{card}]",
              flush=True)
    walls = []
    for _ in range(7):
        t0 = time.perf_counter()
        s3model.encode_vision(s3_imgs[0])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"Sam3Model.encode_vision 1008x1008 (host prep included): p50 {float(np.median(walls[2:])):.3f} ms over "
          f"{len(walls) - 2} [{card}]", flush=True)
    s3_fwd = {}
    with torch.inference_mode():
        for b in (1, 4):
            xb = x_cpu.cuda().bfloat16().repeat(b, 1, 1, 1)
            run = lambda: encode_vision(Params(s3model.params)["det.ve"], xb, vp, flash=True,  # noqa: E731
                                        win_stack=card_stack)
            f1 = median_ms(run, 5, warmup=2)
            f2 = median_ms(run, 5, warmup=0)
            ms = min(f1, f2)
            flops = sam3_vision_flops(vp, b)
            s3_fwd[b] = ms
            print(f"encode_vision batch {b} at 1008x1008 bf16: median {f1:.3f} / {f2:.3f} ms, {b / ms * 1e3:.3f} img/s, "
                  f"{flops / ms / 1e9:.1f} TFLOP/s ({flops / 1e12:.4f} TFLOP; {flops / ms / 1e9 / 989:.2%} of the "
                  f"989 TFLOP/s bf16 peak) [{card}]", flush=True)
            if b == 1:
                s3_profile = profile_run(run, "encode_vision batch 1 at 1008x1008", torch, card,
                                         ("flash_attention",))
                sam3_layer_breakdown(torch, card, s3model.params, vp, s3_profile["busy_ms"])
            del xb
    t_text = []
    for _ in range(7):
        t0 = time.perf_counter()
        s3model.encode_text(SAM3_PROMPTS[1])
        torch.cuda.synchronize()
        t_text.append((time.perf_counter() - t0) * 1e3)
    print(f"Sam3Model.encode_text ({SAM3_TEXT['layers']} layers, {SAM3_TEXT['max_length']} tokens): p50 "
          f"{float(np.median(t_text[2:])):.3f} ms [{card}]", flush=True)
    # the card's and the CPU's models go on to phases 40, 42, 43 and 47
    return {"worst": worst80, "rows": s3_rows, "launches": sam3_launches, "models": (s3model, cpu_s3model),
            "stack_mib": stack_mib, "images": s3_imgs}


# YOLOv9t and MI-GAN (phases 22-26)


def write_yolo_gguf(path: str) -> None:
    from vision_tpu_torch.core.gguf import GGUFWriter
    from vision_tpu_torch.models.random_weights import random_yolov9t_params

    w = GGUFWriter(path, "yolov9t")
    for name, a in random_yolov9t_params(0).items():
        w.add_tensor(name, a)
    w.write()


def cwhn_gguf(src: str, dst: str) -> None:
    """A copy of the GGUF at ``src``, whose tensors are all stored in the
    canonical layout (as random_weights makes them for Depth-Anything,
    MI-GAN and YOLOv9t), in the cwhn layout that the converter's ``--layout
    cwhn`` writes: every conv weight (the converter's is_conv_2d)
    stored (O, H, W, I), depthwise (H, W, 1, C), and
    ``{arch}.tensor_data_layout`` cwhn. A weight whose stored form the
    loader's shape heuristic (weights.unpermute_cwhn) would not read back
    as it was stays in its own layout, which must read back unchanged. Block quantization runs along the
    innermost stored dim, so in this layout the 3x3 convs' rows are their
    input channels and a Q8_0 copy keeps them int8 where Cin divides 32."""
    from vision_tpu_torch.convert.convert import conv_2d_to_nhwc, is_conv_2d
    from vision_tpu_torch.core.gguf import GGUFFile, GGUFWriter
    from vision_tpu_torch.core.weights import unpermute_cwhn

    f = GGUFFile(src)
    w = GGUFWriter(dst, f.arch)
    for k, v in f.metadata.items():
        if k != f"{f.arch}.tensor_data_layout":
            w.add(k, v, vtype=f.kv_types.get(k))
    w.add(f"{f.arch}.tensor_data_layout", "cwhn")
    for name in f.tensor_names():
        a = f.tensor(name)
        stored = conv_2d_to_nhwc(a) if is_conv_2d(name, a) else a
        if not np.array_equal(unpermute_cwhn(name, stored), a):
            stored = a
            if not np.array_equal(unpermute_cwhn(name, stored), a):
                raise RuntimeError(f"cwhn_gguf: {name} {a.shape} reads back in neither layout")
        w.add_tensor(name, stored)
    w.write()


def write_migan_gguf(path: str, resolution: int = MIGAN_RES) -> None:
    from vision_tpu_torch.core.gguf import GGUFWriter
    from vision_tpu_torch.models.random_weights import random_migan_params

    w = GGUFWriter(path, "migan")
    w.add("migan.image_size", resolution)
    for name, a in random_migan_params(resolution, 0).items():
        w.add_tensor(name, a)
    w.write()


def yolo_conv_calls(cc, run) -> list:
    """The conv3x3 calls that ``run()`` makes, in order: (N, H, W, Cin,
    Cout, x's pixel stride, x's first channel, r1 given, r2 given, out's
    pixel stride (0: no out), out's first channel). The calls go on to the
    real wrapper."""
    calls = []
    real = cc.conv3x3

    def spy(x, w, b=None, **kw):
        out = kw.get("out")
        view = lambda t: (t.stride(2), t.storage_offset() % t.stride(2))  # noqa: E731
        calls.append((*x.shape, int(w.shape[0]), *view(x), kw.get("r1") is not None, kw.get("r2") is not None,
                      *(view(out) if out is not None else (0, 0))))
        return real(x, w, b, **kw)

    cc.conv3x3 = spy
    try:
        run()
    finally:
        cc.conv3x3 = real
    return calls


def yolo_shapes(calls) -> dict:
    """The distinct calls of a forward with how often each comes."""
    counts = {}
    for c in calls:
        counts[c] = counts.get(c, 0) + 1
    return counts


def yolo_form_label(call) -> str:
    n, h, w, cin, cout, x_ps, x_off, r1, r2, o_ps, o_off = call
    parts = ["BN + SiLU"]
    if r1:
        parts = ["r1 (the 1x1 branch) + BN, then SiLU"]
    if r2:
        parts.append("+ shortcut r2")
    if x_ps != cin:
        parts.append(f"x channels {x_off}:{x_off + cin} of {x_ps}")
    if o_ps:
        parts.append(f"into channels {o_off}:{o_off + cout} of {o_ps}")
    return f"({n}, {h}, {w}, {cin}) -> {cout}, " + ", ".join(parts)


def yolo_call_inputs(torch, gen, call, dtype):
    """Inputs on the card for one recorded call: x (a channel view where the
    path's was), the weight, the BN's scale and shift, r1 / r2, out (a view
    of a wider buffer where the path's was) and that buffer. Values of scale
    0.5 keep the outputs below 4, where a bf16 ulp is within BF16_MAX_ABS."""
    n, h, w, cin, cout, x_ps, x_off, r1, r2, o_ps, o_off = call

    def rnd(*shape, scale=0.5):
        return (torch.randn(*shape, device="cuda", generator=gen) * scale).to(dtype)

    x = rnd(n, h, w, x_ps)[..., x_off : x_off + cin]
    wt = (torch.randn(cout, cin, 3, 3, device="cuda", generator=gen) / (9 * cin) ** 0.5).to(dtype)
    kw = {"scale": (1.0 + rnd(cout, scale=0.1).float()).to(dtype), "shift": rnd(cout, scale=0.1), "silu": True}
    if r1:
        kw["r1"] = rnd(n, h, w, cout)
    if r2:
        kw["r2"] = rnd(n, h, w, cout)
    buf = None
    if o_ps:
        buf = rnd(n, h, w, o_ps)
        kw["out"] = buf[..., o_off : o_off + cout]
    return x, wt, kw, buf


def yolo_epilogue_cases(cc, torch, shapes: dict) -> float:
    """Phase 22: the conv kernel with YOLOv9t's epilogue forms against
    conv3x3_plain on the same values: every distinct call of a batch-8
    640x640 forward in bf16 (channels outside a written view checked
    unchanged), then ragged f32 and bf16 cases. Returns the largest
    absolute difference."""
    gen = torch.Generator(device="cuda").manual_seed(22)
    cases = [(yolo_form_label(c), c, torch.bfloat16) for c in shapes]
    # ragged edges: (N, H, W, Cin, Cout, x_ps, x_off, r1, r2, o_ps, o_off)
    for dtype in (torch.float32, torch.bfloat16):
        for c in ((2, 19, 23, 16, 16, 16, 0, True, False, 0, 0), (3, 7, 13, 24, 24, 24, 0, False, True, 72, 24),
                  (1, 11, 17, 64, 80, 64, 0, False, False, 0, 0), (2, 9, 30, 16, 48, 32, 16, False, False, 112, 64),
                  (1, 1, 5, 32, 32, 32, 0, True, True, 0, 0)):
            cases.append((yolo_form_label(c), c, dtype))
    worst = 0.0
    for label, call, dtype in cases:
        x, wt, kw, buf = yolo_call_inputs(torch, gen, call, dtype)
        ref = cc.conv3x3_plain(x.float(), wt.float(), **{k: (v.float() if torch.is_tensor(v) else v)
                                                         for k, v in kw.items() if k != "out"})
        before = None if buf is None else buf.clone()
        count = cc.launches
        got = cc.conv3x3(x, wt, **kw)
        torch.cuda.synchronize()
        if cc.launches != count + 1:
            raise AssertionError(f"{label}: launch count went {count} -> {cc.launches}")
        if buf is not None:
            o_off, cout = call[10], call[4]
            keep = torch.ones(buf.shape[-1], dtype=torch.bool, device="cuda")
            keep[o_off : o_off + cout] = False
            if got.data_ptr() != kw["out"].data_ptr() or not torch.equal(buf[..., keep], before[..., keep]):
                raise AssertionError(f"{label}: not written into the out view alone")
        worst = max(worst, check_close(f"conv3x3 YOLOv9t {label} {dtype}", got, ref, dtype, torch))
        del x, wt, kw, buf, before, ref, got
    torch.cuda.empty_cache()
    return worst


def yolo_stages(params, x_u8, yp, dtype, device):
    """The detect inputs f[15], f[18], f[21] and the raw boxes and scores of
    one forward: a list of (name, tensor)."""
    import torch

    from vision_tpu_torch.core.params import Params
    from vision_tpu_torch.models.yolov9t import detect_forward, yolov9t_backbone
    from vision_tpu_torch.ops import normalize_u8

    with torch.inference_mode():
        x = normalize_u8(x_u8.to(device), dtype=dtype)
        f = yolov9t_backbone(Params(params), x, yp.n_csp)
        out = detect_forward(Params(params), [f[15], f[18], f[21]], yp)
    return [("f[15]", f[15]), ("f[18]", f[18]), ("f[21]", f[21]), ("boxes", out.boxes), ("scores", out.scores)]


def match_detections(a, b, iou: float = 0.9) -> float:
    """The share of detections ``a`` that ``b`` keeps too: the same class and
    a box with IoU >= ``iou``, each of b used once, in a's order."""
    if not a:
        return 1.0 if not b else 0.0
    used = [False] * len(b)
    hits = 0
    for d in a:
        for j, e in enumerate(b):
            if used[j] or e.class_id != d.class_id:
                continue
            ix = max(0.0, min(d.x2, e.x2) - max(d.x1, e.x1))
            iy = max(0.0, min(d.y2, e.y2) - max(d.y1, e.y1))
            inter = ix * iy
            union = (d.x2 - d.x1) * (d.y2 - d.y1) + (e.x2 - e.x1) * (e.y2 - e.y1) - inter
            if union > 0 and inter / union >= iou:
                used[j] = True
                hits += 1
                break
    return hits / len(a)


def yolo_conv_timings(cc, torch, card: str, shapes: dict) -> dict:
    """Phase 26: the kernel at each distinct call of a batch-8 640x640
    forward with its path's epilogue and views, by the card's own time
    (device_ms, in turns with the yardstick), beside its bound, its plain
    version and the yardstick F.conv2d + BN + SiLU (+ the branch, + the
    shortcut) in channels-last bf16, library calls the port never makes;
    and the sums over one forward's 112 calls."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(26)
    rows = []
    for call, count in shapes.items():
        n, h, w, cin, cout = call[:5]
        x, wt, kw, _ = yolo_call_inputs(torch, gen, call, torch.bfloat16)
        xc = x.contiguous().permute(0, 3, 1, 2)  # an NHWC tensor is a channels-last NCHW one
        sc, sh = kw["scale"].view(1, -1, 1, 1), kw["shift"].view(1, -1, 1, 1)
        r1 = kw["r1"].permute(0, 3, 1, 2) if "r1" in kw else None
        r2 = kw["r2"].permute(0, 3, 1, 2) if "r2" in kw else None

        def run_l():
            y = F.conv2d(xc, wt, None, 1, 1) * sc + sh
            y = F.silu(y if r1 is None else y + r1)
            return y if r2 is None else y + r2

        run_k = lambda: cc.conv3x3(x, wt, **kw)  # noqa: E731
        k1, l1, k2, l2 = (device_ms(f) for f in (run_k, run_l, run_k, run_l))
        plain = {k: v for k, v in kw.items() if k != "out"}
        p_ms = device_ms(lambda: cc.conv3x3_plain(x, wt, **plain), calls=2, warmup=1, reps=1)
        res = int("r1" in kw) + int("r2" in kw)
        bound, by = conv_bound(n * h * w, cin, cout, res)
        row = {"shape": yolo_form_label(call), "count": count, "ms": min(k1, k2), "plain_ms": p_ms,
               "library_ms": min(l1, l2), "bound_ms": bound, "bound_by": by}
        rows.append(row)
        print(f"conv3x3 YOLOv9t {row['shape']} bf16 x{count} a forward: kernel {k1:.4f} / {k2:.4f} ms, plain "
              f"{p_ms:.4f} ms, F.conv2d + BN + SiLU{' + add' * res} {l1:.4f} / {l2:.4f} ms, bound {bound:.4f} ms "
              f"({by}) [{card}]", flush=True)
        del x, wt, kw, xc, r1, r2
    torch.cuda.empty_cache()
    total = {k: sum(r[k] * r["count"] for r in rows) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    total["bound_by"] = max(("bytes", "operations"), key=[r["bound_by"] for r in rows].count)
    print(f"conv3x3 over one batch-8 640x640 YOLOv9t forward's {sum(r['count'] for r in rows)} convs: kernel "
          f"{total['ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, F.conv2d + BN + SiLU (+ add) "
          f"{total['library_ms']:.4f} ms, bound {total['bound_ms']:.4f} ms (mostly {total['bound_by']}) [{card}]",
          flush=True)
    return {"rows": rows, **total}


def yolo_migan_phases(torch, card: str, fa, wa, cc, dsm, dcm) -> dict:
    """Phases 22-26: the conv kernel's YOLOv9t epilogue forms against its
    plain version; YOLOv9t through YoloServer and MI-GAN through
    ImageServer (GGUFs written at run time); their parity on the card
    against the CPU; their timings. Returns what the kernels line reports
    of it."""
    from vision_tpu_torch.core.device import backend_init
    from vision_tpu_torch.core.params import Params
    from vision_tpu_torch.image import Image, ImageFormat
    from vision_tpu_torch.models.migan import migan_generate, migan_load_model
    from vision_tpu_torch.models.yolov9t import letterbox, non_max_suppression, yolov9t_load_model
    from vision_tpu_torch.serve import ImageServer, YoloServer

    def counts():
        return {"flash": fa.launches, "window": wa.launches, "conv3x3": cc.launches, "deform_conv": dcm.launches,
                "deform_sample": dsm.launches}

    yrng = np.random.default_rng(23)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "yolov9t-random.gguf")
        write_yolo_gguf(path)
        ymodel = yolov9t_load_model(path, backend_init("gpu"))
        cpu_ymodel = yolov9t_load_model(path, backend_init("cpu"))
    yp = ymodel.p
    x8 = torch.from_numpy(yrng.integers(0, 256, (YOLO_BATCH, yp.input_size, yp.input_size, 3), np.uint8)).cuda()
    shapes = yolo_shapes(yolo_conv_calls(cc, lambda: ymodel._forward_u8(x8)))
    torch.cuda.synchronize()

    phase("22 conv3x3 kernel with YOLOv9t's epilogue forms (BN, SiLU, r1, r2, views) against its plain version")
    print(f"a batch-{YOLO_BATCH} {yp.input_size}x{yp.input_size} forward makes {sum(shapes.values())} conv3x3 calls "
          f"of {len(shapes)} distinct shapes and forms", flush=True)
    if sum(shapes.values()) != YOLO_CONVS:
        raise AssertionError(f"{sum(shapes.values())} conv3x3 calls a forward, expected {YOLO_CONVS}")
    conv_worst = yolo_epilogue_cases(cc, torch, shapes)

    phase("23 YOLOv9t path: random_yolov9t_params(0) through YoloServer")
    print(f"model on {ymodel.device.torch_device} {ymodel.dtype}, {yp}", flush=True)
    reqs = [Image(yrng.integers(0, 256, (h, w, 4), np.uint8), ImageFormat.rgba_u8)
            for w, h in YOLO_EXTENTS for _ in range(4)]
    with YoloServer(ymodel, batch_size=YOLO_BATCH, max_delay_ms=1000) as srv:  # a window that fills each batch
        srv.warmup()
        zero_counts()
        t0 = time.perf_counter()
        futures = [srv.submit(img) for img in reqs]
        dets = [f.result(timeout=600) for f in futures]
        torch.cuda.synchronize()
        y_wall_s = time.perf_counter() - t0
        got = counts()
        y_req, y_batches, y_p50 = srv.stats.requests, srv.stats.batches, srv.stats.p50_latency_ms
    want = {"flash": 0, "window": 0, "conv3x3": YOLO_CONVS * y_batches, "deform_conv": 0, "deform_sample": 0}
    if y_req != len(reqs) or y_batches != len(reqs) // YOLO_BATCH or got != want:
        raise AssertionError(f"YoloServer: {y_req} requests in {y_batches} batches, launches {got} (expected {want})")
    for img, d in zip(reqs, dets):
        w, h = img.extent
        ok = len(d) <= 300 and all(0 <= e.x1 <= e.x2 <= w and 0 <= e.y1 <= e.y2 <= h and 0 <= e.class_id < 80
                                   and 0.25 <= e.confidence <= 1.0 for e in d)
        if not ok:
            raise AssertionError(f"detections for {img.extent}: {d[:3]} ...")
    print(f"served {y_req} requests ({', '.join(f'4 at {w}x{h}' for w, h in YOLO_EXTENTS)}) in {y_batches} batches "
          f"of {YOLO_BATCH}; launches {got}: {YOLO_CONVS} conv3x3 a forward, no other hand-written kernel; "
          f"detections per request {[len(d) for d in dets]}", flush=True)

    phase("24 YOLOv9t parity: card bf16 and f32 (kernel route) vs CPU f32 (plain route)")
    arr, gain, dw, dh = letterbox(reqs[0], yp.input_size)
    x1 = torch.from_numpy(arr[None])
    t0 = time.perf_counter()
    cpu_st = yolo_stages(cpu_ymodel.params, x1, yp, torch.float32, "cpu")
    cpu_s = time.perf_counter() - t0
    f32_params = {k: v.to("cuda") for k, v in cpu_ymodel.params.items()}
    zero_counts()
    f32_st = yolo_stages(f32_params, x1, yp, torch.float32, "cuda")
    f32_launches = cc.launches
    bf16_st = yolo_stages(ymodel.params, x1, yp, ymodel.dtype, "cuda")
    y_f32, y_bf16 = {}, {}
    for (name, c), (_, f), (_, b) in zip(cpu_st, f32_st, bf16_st):
        y_f32[name], y_bf16[name] = rel_rms(f.float().cpu(), c), rel_rms(b.float().cpu(), c)
        print(f"{name} {tuple(c.shape)}: relative RMS card f32 vs CPU f32 {y_f32[name]:.4e} (bound "
              f"{YOLO_F32_REL_RMS}), card bf16 vs CPU f32 {y_bf16[name]:.4e} (bound {E2E_REL_RMS})", flush=True)
    print(f"CPU f32 forward at {yp.input_size}x{yp.input_size}: {cpu_s:.2f} s; card f32 forward: {f32_launches} conv3x3 "
          f"launches", flush=True)
    finite = all(bool(torch.isfinite(t).all()) for _, t in f32_st + bf16_st)
    if not (finite and f32_launches == YOLO_CONVS and max(y_f32.values()) <= YOLO_F32_REL_RMS
            and max(y_bf16.values()) <= E2E_REL_RMS):
        raise AssertionError(f"YOLOv9t parity: f32 {y_f32}, bf16 {y_bf16}, finite {finite}, {f32_launches} launches")
    boxes = {k: dict(st)["boxes"][0].float().cpu().numpy() for k, st in (("cpu", cpu_st), ("f32", f32_st))}
    scores = {k: dict(st)["scores"][0].float().cpu().numpy() for k, st in (("cpu", cpu_st), ("f32", f32_st))}
    t0 = time.perf_counter()
    nms = {k: non_max_suppression(boxes[k], scores[k]) for k in ("cpu", "f32")}
    nms_ms = (time.perf_counter() - t0) * 1e3 / 2
    cands = int((scores["cpu"] >= 0.25).sum())
    share = match_detections(nms["f32"], nms["cpu"])
    print(f"NMS (conf 0.25, iou 0.45, {cands} candidates at or above 0.25 on the CPU, max_nms 30000): card f32 keeps "
          f"{len(nms['f32'])}, CPU f32 {len(nms['cpu'])}; {share:.2%} of the card's also kept on the CPU (same class, "
          f"IoU >= 0.9; bound {YOLO_NMS_MATCH:.0%}); {nms_ms:.1f} ms a call on the host", flush=True)
    if share < YOLO_NMS_MATCH or abs(len(nms["f32"]) - len(nms["cpu"])) > (1 - YOLO_NMS_MATCH) * len(nms["cpu"]):
        raise AssertionError(f"NMS on the card's f32 outputs vs the CPU's: {share:.2%} matched")
    del f32_params, cpu_ymodel, cpu_st, f32_st, bf16_st

    phase("25 MI-GAN path: random_migan_params(512, 0) through ImageServer with (image, mask)")
    mrng = np.random.default_rng(25)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "migan-random.gguf")
        write_migan_gguf(path)
        mmodel = migan_load_model(path, backend_init("gpu"))
        cpu_mmodel = migan_load_model(path, backend_init("cpu"))
    print(f"model on {mmodel.device.torch_device} {mmodel.dtype}, {mmodel.p}", flush=True)

    def mask_for(w, h):
        m = np.zeros((h, w, 1), np.uint8)
        y0, x0 = mrng.integers(0, h // 2), mrng.integers(0, w // 2)
        m[y0 : y0 + h // 3, x0 : x0 + w // 3] = 255
        return m

    mreqs = []
    for i, (w, h) in enumerate(MIGAN_EXTENTS):
        m = mask_for(w, h)
        if i >= 6:  # RGBA: the alpha holds the mask, as a client may send it
            img = Image(np.concatenate([mrng.integers(0, 256, (h, w, 3), np.uint8), m], 2), ImageFormat.rgba_u8)
        else:
            img = Image(mrng.integers(0, 256, (h, w, 3), np.uint8), ImageFormat.rgb_u8)
        mreqs.append((img, Image(m, ImageFormat.alpha_u8)))
    with ImageServer(mmodel, batch_size=MIGAN_BATCH, max_delay_ms=1000) as srv:
        srv.warmup()
        zero_counts()
        t0 = time.perf_counter()
        futures = [srv.submit(r) for r in mreqs]
        inpainted = [f.result(timeout=600) for f in futures]
        torch.cuda.synchronize()
        m_wall_s = time.perf_counter() - t0
        m_got = counts()
        m_req, m_batches, m_p50 = srv.stats.requests, srv.stats.batches, srv.stats.p50_latency_ms
    if m_req != len(mreqs) or m_batches != len(mreqs) // MIGAN_BATCH or any(m_got.values()):
        raise AssertionError(f"MI-GAN ImageServer: {m_req} requests in {m_batches} batches, launches {m_got}")
    for (img, mask), res in zip(mreqs, inpainted):
        if res.extent != img.extent or res.format != ImageFormat.rgba_u8 or not np.array_equal(res.data[..., 3:],
                                                                                                mask.data):
            raise AssertionError(f"MI-GAN result {res.extent} {res.format} for {img.extent}, alpha not the mask")
    print(f"served {m_req} (image, mask) requests (4 at 512x512, 2 at 1024x768, 2 RGBA at 640x480) in {m_batches} "
          f"batches of {MIGAN_BATCH}; launches {m_got}: no hand-written kernel; alpha = the mask", flush=True)
    img0, mask0 = mreqs[0]
    xi = torch.from_numpy(img0.to_rgb_u8()[None])
    xm = torch.from_numpy(mask0.data[None])
    t0 = time.perf_counter()
    m_cpu = cpu_mmodel.forward_u8(xi, xm)
    m_cpu_s = time.perf_counter() - t0
    zero_counts()
    m_bf16 = mmodel.forward_u8(xi, xm).float().cpu()
    f32_mmodel = type(mmodel)({}, mmodel.p, mmodel.device)  # the card's model in f32: the CPU's weights on the card
    f32_mmodel.params, f32_mmodel.dtype = {k: v.to("cuda") for k, v in cpu_mmodel.params.items()}, torch.float32
    m_f32 = f32_mmodel.forward_u8(xi, xm).float().cpu()
    m_parity_launches = sum(counts().values())
    m_rms_f32, m_rms_bf16 = rel_rms(m_f32, m_cpu), rel_rms(m_bf16, m_cpu)
    print(f"raw output {tuple(m_cpu.shape)}: relative RMS card f32 vs CPU f32 {m_rms_f32:.4e} (bound "
          f"{MIGAN_F32_REL_RMS}), card bf16 vs CPU f32 {m_rms_bf16:.4e} (bound {E2E_REL_RMS}); output range CPU "
          f"[{float(m_cpu.min()):.4e}, {float(m_cpu.max()):.4e}], RMS {float(m_cpu.pow(2).mean().sqrt()):.4e}; CPU f32 "
          f"forward {m_cpu_s:.2f} s; {m_parity_launches} hand-written launches", flush=True)
    if not (bool(torch.isfinite(m_bf16).all()) and m_rms_f32 <= MIGAN_F32_REL_RMS and m_rms_bf16 <= E2E_REL_RMS
            and m_parity_launches == 0):
        raise AssertionError(f"MI-GAN parity: f32 {m_rms_f32}, bf16 {m_rms_bf16}, {m_parity_launches} launches")
    del cpu_mmodel, f32_mmodel, m_cpu, m_bf16, m_f32

    phase(f"26 YOLOv9t and MI-GAN timings on {card}")
    conv = yolo_conv_timings(cc, torch, card, shapes)
    y_fwd = {}
    for b in (1, YOLO_BATCH):
        xb = x8[:b]
        f1 = median_ms(lambda: ymodel.forward_u8(xb), 10, warmup=2)
        f2 = median_ms(lambda: ymodel.forward_u8(xb), 10, warmup=0)
        y_fwd[b] = min(f1, f2)
        print(f"YOLOv9t forward_u8 batch {b} at {yp.input_size}x{yp.input_size} bf16: median {f1:.3f} / {f2:.3f} ms, "
              f"{b / y_fwd[b] * 1e3:.3f} img/s [{card}]", flush=True)
    y_profile = profile_run(lambda: ymodel.forward_u8(x8), f"YOLOv9t forward_u8 batch {YOLO_BATCH} at "
                            f"{yp.input_size}x{yp.input_size}", torch, card)
    for w, h in YOLO_EXTENTS:
        img = next(r for r in reqs if r.extent == (w, h))
        t_lb = []
        for _ in range(5):
            t0 = time.perf_counter()
            letterbox(img, yp.input_size)
            t_lb.append((time.perf_counter() - t0) * 1e3)
        print(f"host letterbox of a {w}x{h} request: median {float(np.median(t_lb)):.3f} ms [{card}]", flush=True)
    srv_tmp = YoloServer(ymodel, batch_size=YOLO_BATCH)
    try:
        cb, cs = srv_tmp.candidates(x8[:1])
        cb, cs = cb[0].cpu().numpy(), cs[0].cpu().numpy()
    finally:
        srv_tmp.close()
    t_nms = []
    for _ in range(5):
        t0 = time.perf_counter()
        kept = non_max_suppression(cb, cs)
        t_nms.append((time.perf_counter() - t0) * 1e3)
    print(f"host NMS of one served request ({cb.shape[0]} top-K anchors x {cs.shape[1]} classes, "
          f"{int((cs >= 0.25).sum())} candidates at or above 0.25, {len(kept)} kept): median "
          f"{float(np.median(t_nms)):.3f} ms [{card}]", flush=True)
    print(f"YoloServer {y_req} requests (batch {YOLO_BATCH}): p50 latency {y_p50:.3f} ms, {y_req / y_wall_s:.3f} img/s, "
          f"{y_batches} batches [{card}]", flush=True)
    m_fwd = {}
    mx = torch.from_numpy(mrng.integers(0, 256, (MIGAN_BATCH, MIGAN_RES, MIGAN_RES, 3), np.uint8)).cuda()
    mm = torch.from_numpy((mrng.random((MIGAN_BATCH, MIGAN_RES, MIGAN_RES, 1)) > 0.7).astype(np.uint8) * 255).cuda()
    for b in (1, MIGAN_BATCH):
        f1 = median_ms(lambda: mmodel.forward_u8(mx[:b], mm[:b]), 10, warmup=2)
        f2 = median_ms(lambda: mmodel.forward_u8(mx[:b], mm[:b]), 10, warmup=0)
        m_fwd[b] = min(f1, f2)
        print(f"MI-GAN forward_u8 batch {b} at {MIGAN_RES}x{MIGAN_RES} bf16: median {f1:.3f} / {f2:.3f} ms, "
              f"{b / m_fwd[b] * 1e3:.3f} img/s [{card}]", flush=True)
    m_profile = profile_run(lambda: mmodel.forward_u8(mx, mm), f"MI-GAN forward_u8 batch {MIGAN_BATCH} at "
                            f"{MIGAN_RES}x{MIGAN_RES}", torch, card, ())
    print(f"ImageServer MI-GAN {m_req} requests (batch {MIGAN_BATCH}): p50 latency {m_p50:.3f} ms, "
          f"{m_req / m_wall_s:.3f} img/s, {m_batches} batches [{card}]", flush=True)
    del ymodel, mmodel, x8, mx, mm
    torch.cuda.empty_cache()
    return {"worst": conv_worst, "conv": conv, "launches_per_forward": got["conv3x3"] // y_batches,
            "forward_ms": y_fwd, "profile": y_profile, "migan_forward_ms": m_fwd, "migan_profile": m_profile,
            "p50_ms": y_p50, "migan_p50_ms": m_p50}


# the front door (phases 27-29): each graphed forward at its smoke size, at
# its server's batch and then batch 1 (the second graph shares the first's
# pool, whose free blocks are large enough for it); the hand-written kernels
# a forward launches (family, batches, per-image input shapes, forward
# flags); Real-ESRGAN's float output, since its u8 output is all 0 with these
# random weights
GRAPH_CASES = (
    ("depthany", (4, 1), ((518, 518, 3),), {}),
    ("birefnet", (4, 1), ((1024, 1024, 3),), {}),
    ("esrgan", (4, 1), ((256, 256, 3),), {"to_u8": False}),
    ("migan", (MIGAN_BATCH, 1), ((MIGAN_RES, MIGAN_RES, 3), (MIGAN_RES, MIGAN_RES, 1)), {}),
    ("yolov9t", (YOLO_BATCH, 1), ((640, 640, 3),), {}),
)
GRAPH_KERNELS = {  # family -> {counter: launches a forward}
    "depthany": {"flash": 12},
    "birefnet": {"window": BIREF_WINDOWS, "deform_conv": BIREF_DEFORMS},
    "esrgan": {"conv3x3": ESRGAN_CONVS},
    "migan": {},
    "yolov9t": {"conv3x3": YOLO_CONVS},
    "sam3": {"flash": 4},  # SAM 3's four global layers; the window layers and the neck run no hand-written kernel
}
# the kernel names of the counters, as the profiler shows them (substrings)
COUNTER_KERNELS = {"flash": "flash_attention", "window": "window_attention", "conv3x3": "conv3x3",
                   "deform_conv": "deform_conv", "deform_sample": "deform_sample"}
# phases 30-32, the front ends: each HTTP service's request bodies, (w, h)
# each (SAM's alternate a point and a box; MI-GAN's are RGBA with the mask in
# alpha), sent by HTTP_CLIENTS threads at once
HTTP_EXTENTS = {
    "depthany": ((518, 518),) * 4 + ((700, 500),) * 4,
    "birefnet": ((1024, 1024),) * 2 + ((1280, 720),) * 2,
    "sam": ((1024, 1024), (640, 480)) * 3,
    "esrgan": ((256, 256),) * 4,
    "migan": ((512, 512),) * 4,
    "yolo": ((640, 480),) * 4 + ((1280, 720),) * 4,
}
HTTP_CLIENTS = 8
# phase 30's latency: each endpoint alone gets a stream of HTTP_STREAM requests
# (its bodies of HTTP_EXTENTS, cycled), HTTP_CLIENTS in flight at a time, over
# HTTP and then straight to its service
HTTP_STREAM = 64
HTTP_ROUTES = {"sam": "/v1/sam/mask", "esrgan": "/v1/esrgan", "birefnet": "/v1/birefnet", "depthany": "/v1/depthany",
               "migan": "/v1/migan", "yolo": "/v1/yolo"}
SERVICE_FAMILIES = {"sam": "sam", "esrgan": "esrgan", "birefnet": "birefnet", "depthany": "depthany",
                    "migan": "migan", "yolo": "yolov9t"}  # HTTP service -> model family
# each service's hand-written launches a forward (SAM: an encoder batch)
SERVICE_KERNELS = {**{s: GRAPH_KERNELS[f] for s, f in SERVICE_FAMILIES.items() if f in GRAPH_KERNELS},
                   "sam": {"window": 10}}
MAX_SHARE_OFF = 1e-3  # a served image against the in-process one: values off by one u8 level at most, this share
BULK_EXTENTS = {"depthany": ((518, 518), (700, 500), (640, 480)) * 4, "yolov9t": YOLO_EXTENTS * 2}
# eval -m depthany scores the card's served u8 depth (bf16) against the CPU's
# f32 depth shifted into [1, 2]: the affine alignment absorbs the shift, which
# keeps AbsRel's division away from the min-max normalized map's zero. The
# bound lies between the readings of depth_eval_readings on the card: 7.09e-4
# sound (6.87e-4 of it bf16's own, before the u8 store) and 1.64e-3 with the
# subtler DEPTH_FAULTS fault (3.14e-3 with the other)
EVAL_ABSREL = 1.1e-3
# the flash kernel faults planted in a Depth-Anything that EVAL_ABSREL must
# catch: which keys of T each attention keeps (the kernel's key loop stopping
# at the last full 64-key tile; skipping the first tile)
DEPTH_FAULTS = {"ragged last key tile dropped": lambda t: slice(0, t // 64 * 64),
                "first 64-key tile dropped": lambda t: slice(64, t)}
VIDEO_FRAMES = 16
SERVE_EXIT_S = 30  # the serve verb must exit 0 this soon after SIGINT
CLI_EXTENT = (640, 480)  # the CLI phase's input image (w, h)
CLI_SUBPROCESS_VERB = "depthany"  # phase 28's one start of python -m vision_tpu_torch.cli: ESRGAN cuts it into 224-pixel tiles
HOST_OPS_CASE = ((1024, 1024), 30)  # --composite's foreground estimate: BiRefNet's extent, the CLI's radius


def pool_mib(torch, pool) -> float:
    """The device memory of the CUDA-graph pool ``pool`` (the segments the
    caching allocator holds for it), in MiB."""
    if pool is None:
        return 0.0
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == tuple(pool)) / 2**20


def front_door_ggufs(tmp: str) -> dict:
    """The six served families' random full-width GGUFs (the writers of the
    earlier phases) in ``tmp``: family -> path."""
    writers = {"depthany": write_small_gguf, "birefnet": write_birefnet_gguf, "esrgan": write_esrgan_gguf,
               "migan": write_migan_gguf, "yolov9t": write_yolo_gguf, "sam": write_sam_gguf}
    paths = {}
    for family, write in writers.items():
        paths[family] = os.path.join(tmp, f"{family}.gguf")
        write(paths[family])
    return paths


def graph_case(torch, card: str, family: str, model, xs: list, flags: dict, counts) -> dict:
    """One forward_u8 key of ``model``: the eager forward (``_forward_u8``)
    first, with the memory it allocates at its peak, and once more in a
    fresh memory pool of its own, whose size is what the caching allocator
    reserves for one eager forward from nothing (a graph's first capture
    into an empty pool starts from nothing too); then the
    first forward_u8 call (warm-up, capture, replay) with its ms and
    launches, the replay against the eager output, the graph pool's MiB
    before and after the capture, the median ms of eager and replay, and a
    profile of one replay whose launches per hand-written kernel must equal
    what the counters added. The idle share is the replay median's time
    outside the profiled busy time (the profiler's own wall is longer: it
    traces every kernel of the graph).

    A capture into a pool that already holds another graph of the model
    must grow it by no more than the forward's eager peak allocation: the
    graphs share the pool's free blocks (captured on one stream), so a
    pool holds about its largest graph, not the sum of them."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    eager = model._forward_u8(*xs, **flags)
    torch.cuda.synchronize()
    eager_peak_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
    fresh = torch.cuda.MemPool()
    with torch.cuda.use_mem_pool(fresh):
        model._forward_u8(*xs, **flags)  # its output is freed at once; the constants exist already
    torch.cuda.synchronize()
    eager_reserved_mib = pool_mib(torch, fresh.id)
    del fresh
    torch.cuda.empty_cache()
    pool_before = pool_mib(torch, model.graphs.pool)
    c0 = counts()
    t0 = time.perf_counter()
    out = model.forward_u8(*xs, **flags)
    torch.cuda.synchronize()
    capture_ms = (time.perf_counter() - t0) * 1e3
    capture_launches = {k: v - c0[k] for k, v in counts().items() if v != c0[k]}
    pairs = list(zip(out, eager)) if isinstance(out, tuple) else [(out, eager)]
    diff = max(float((a.float() - b.float()).abs().max()) for a, b in pairs)
    rms = max(rel_rms_t(a.float(), b.float()) for a, b in pairs)
    eager_ms = median_ms(lambda: model._forward_u8(*xs, **flags), 10, warmup=1)
    replay_ms = median_ms(lambda: model.forward_u8(*xs, **flags), 10, warmup=1)
    label = f"{family} forward_u8 {tuple(xs[0].shape)}"
    names = tuple(COUNTER_KERNELS[k] for k in GRAPH_KERNELS[family])
    want = dict(GRAPH_KERNELS[family])
    # the tracer can drop records of a replay's burst even past its warm-up
    # step (one flash launch of 12 once in ~30 profiles on the card); it never
    # adds any, so a profile short of the counters is taken again, up to
    # three times, and one that matches shows what a replay launched
    for attempt in range(3):
        prof = profile_run(lambda: model.forward_u8(*xs, **flags), f"replay of {label}", torch, card, names,
                           counts=counts)
        short = {k: n for k, n in want.items() if prof["named_launches"].get(COUNTER_KERNELS[k], 0) < n}
        if not short:
            break
        print(f"{label}: profile {attempt + 1} recorded fewer launches of {sorted(short)} than one replay makes "
              f"({prof['named_launches']} against the counters' {prof['counted']})", flush=True)
    row = {"capture_ms": capture_ms, "eager_ms": eager_ms, "replay_ms": replay_ms, "max_abs_diff": diff,
           "rel_rms": rms, "pool_before_mib": pool_before, "pool_mib": pool_mib(torch, model.graphs.pool),
           "eager_peak_mib": eager_peak_mib, "eager_reserved_mib": eager_reserved_mib, "busy_ms": prof["busy_ms"],
           "idle": max(0.0, 1 - prof["busy_ms"] / replay_ms),
           "launches": prof["named_launches"], "counted": prof["counted"]}
    print(f"{label}: replay vs eager max abs difference {diff:.4e} (relative RMS {rms:.4e}); first call (eager "
          f"warm-up + capture + replay) {capture_ms:.3f} ms with launches {capture_launches}; graph pool "
          f"{pool_before:.1f} -> {row['pool_mib']:.1f} MiB (the eager forward allocates {eager_peak_mib:.1f} MiB at "
          f"its peak and reserves {eager_reserved_mib:.1f} MiB in a fresh pool); median "
          f"eager {eager_ms:.3f} ms, replay {replay_ms:.3f} ms; one replay: device busy {row['busy_ms']:.3f} ms, "
          f"idle share {row['idle']:.2%} of the replay median, hand-written launches by the profiler "
          f"{prof['named_launches']}, by the counters {prof['counted']} [{card}]", flush=True)
    by_profile = {k: prof["named_launches"].get(COUNTER_KERNELS[k], 0) for k in want}
    counted = {k: prof["counted"].get(k, 0) for k in want}
    if by_profile != want or counted != want or set(prof["counted"]) - set(want):
        raise AssertionError(f"{label}: one replay launched {by_profile} by the profiler and {prof['counted']} by "
                             f"the counters; expected {want}")
    doubled = {k: 2 * n for k, n in want.items()}
    if capture_launches != doubled:
        raise AssertionError(f"{label}: the first call launched {capture_launches}; expected {doubled} (the eager "
                             f"warm-up and one replay)")
    if diff != 0.0 and not rms <= E2E_REL_RMS:
        raise AssertionError(f"{label}: replay differs from the eager forward, relative RMS {rms}")
    if pool_before > 0 and row["pool_mib"] - pool_before > eager_peak_mib:
        raise AssertionError(f"{label}: the capture grew the shared graph pool from {pool_before:.1f} to "
                             f"{row['pool_mib']:.1f} MiB, more than the forward's eager peak {eager_peak_mib:.1f} MiB")
    return row


def sam3_published_graph_case(torch, card: str, fa, counts, rng) -> dict:
    """Phase 27's SAM 3 row: a vision-only Sam3Model at the published
    widths (SAM3_PUBLISHED; random weights in f32, cast to bf16 on the
    card), forward_u8 at Sam3Server's batch on 1008^2 u8 images through
    graph_case (replay against the eager forward, launches by the profiler
    and the counters); then one more replay with every hand-written
    kernel's launch count zeroed just before: 4 flash launches and nothing
    else; then the flash kernel at the global layers' shape, (B*16, 5184,
    64) bf16, by the card's own time against its bound. The model is freed
    before returning."""
    from vision_tpu_torch.core.device import backend_init
    from vision_tpu_torch.models.random_weights import random_sam3_vision_params
    from vision_tpu_torch.models.sam3 import Sam3Model, Sam3VitParams
    from vision_tpu_torch.ops.cuda import conv3x3, deform_conv, deform_sample, dequant, window_attention

    b = SAM3_SERVE_BATCH
    t0 = time.perf_counter()
    params = {f"det.ve.{k}": torch.from_numpy(v).cuda()
              for k, v in random_sam3_vision_params(24, **SAM3_PUBLISHED).items()}
    model = Sam3Model(params, None, 0, backend_init("gpu"), vp=Sam3VitParams())
    del params
    n_params = sum(v.numel() for v in model.params.values())
    print(f"SAM 3 image encoder at the published widths {SAM3_PUBLISHED}: {n_params / 1e6:.1f} M parameters in "
          f"{model.dtype}, built in {time.perf_counter() - t0:.1f} s", flush=True)
    x = torch.from_numpy(rng.integers(0, 256, (b, 1008, 1008, 3), np.uint8)).cuda()
    row = graph_case(torch, card, "sam3", model, [x], {}, counts)
    if len(model.graphs.cache) != 1:
        raise AssertionError(f"sam3: {len(model.graphs.cache)} graphs for one key")

    zero_counts()
    out = model.forward_u8(x)
    torch.cuda.synchronize()
    kernels = {"flash": fa, "window": window_attention, "conv3x3": conv3x3, "deform_conv": deform_conv,
               "deform_sample": deform_sample, "dequant": dequant}
    launched = {k: m.launches for k, m in kernels.items()}
    launched["window masked"] = window_attention.masked_launches
    want = {k: GRAPH_KERNELS["sam3"].get(k, 0) for k in launched}
    shapes = [tuple(y.shape) for y in out]
    print(f"sam3 forward_u8 {tuple(x.shape)}: one replay with the counts zeroed just before launched {launched}; "
          f"levels {shapes} {out[0].dtype} [{card}]", flush=True)
    if launched != want:
        raise AssertionError(f"sam3 forward_u8: one replay launched {launched}; expected {want}")
    if shapes != [(b, s, s, c) for s, c in SAM3_FPN] or out[0].dtype != torch.float16:
        raise AssertionError(f"sam3 forward_u8: levels {shapes} {out[0].dtype}")
    del out, x, model
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(27)
    q, k, v = (torch.randn(b, 16, SAM3_T, 64, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(3))
    k1, k2 = (device_ms(lambda: fa.flash_attention(q, k, v), calls=20) for _ in range(2))
    bh = 16 * b
    bound, by = bound_ms(4.0 * bh * SAM3_T * SAM3_T * 64, 4 * 2.0 * bh * SAM3_T * 64)
    row["flash_ms"], row["flash_bound_ms"] = min(k1, k2), bound
    print(f"flash_attention ({bh}, {SAM3_T}, 64) bf16, SAM 3's global layer at the published widths: kernel "
          f"{k1:.4f} / {k2:.4f} ms, bound {bound:.4f} ms ({by}), kernel at {bound / min(k1, k2):.2%} of the bound "
          f"(by the card's own time) [{card}]", flush=True)
    return row


def host_ops_timing(card: str) -> dict:
    """--composite's foreground estimate (image_estimate_foreground) at
    HOST_OPS_CASE through the host-ops library and through its numpy forms
    (box_blur_plain in the library's place), and the blur and the f32
    erosion alone, each the median of 5 calls on the host; the results must
    agree (blur atol 1e-5, erosion exact)."""
    from vision_tpu_torch import native
    from vision_tpu_torch.image import Image, ImageFormat, image_estimate_foreground
    from vision_tpu_torch.image.image import box_blur_plain, erosion_plain

    (w, h), radius = HOST_OPS_CASE
    rng = np.random.default_rng(28)
    img = Image(rng.random((h, w, 4), np.float32), ImageFormat.rgba_f32)
    mask = Image(rng.random((h, w, 1), np.float32), ImageFormat.alpha_f32)

    fg_native = image_estimate_foreground(img, mask, radius).data
    fg_native_ms = host_median_ms(lambda: image_estimate_foreground(img, mask, radius))
    library = native.box_blur
    native.box_blur = box_blur_plain  # image_estimate_foreground imports it at each call
    try:
        fg_numpy = image_estimate_foreground(img, mask, radius).data
        fg_numpy_ms = host_median_ms(lambda: image_estimate_foreground(img, mask, radius))
    finally:
        native.box_blur = library
    a = img.data
    e = mask.data
    times = {"foreground": (fg_native_ms, fg_numpy_ms),
             "blur": (host_median_ms(lambda: native.box_blur(a, radius)), host_median_ms(lambda: box_blur_plain(a, radius))),
             "erosion": (host_median_ms(lambda: native.erosion_f32(e, radius)), host_median_ms(lambda: erosion_plain(e, radius)))}
    fg_diff = float(np.abs(fg_native - fg_numpy).max())
    blur_diff = float(np.abs(native.box_blur(a, radius) - box_blur_plain(a, radius)).max())
    erosion_same = np.array_equal(native.erosion_f32(e, radius), erosion_plain(e, radius)[:, :, 0])
    print(f"host ops at {w}x{h}, radius {radius} (median of 5 on the host): " + "; ".join(
        f"{k} library {lib:.3f} ms, numpy {plain:.3f} ms ({plain / lib:.2f}x)" for k, (lib, plain) in times.items())
        + f"; max abs difference foreground {fg_diff:.3e}, blur {blur_diff:.3e}, erosion "
        f"{'0' if erosion_same else 'nonzero'} [{card}]", flush=True)
    if not (fg_diff <= 1e-5 and blur_diff <= 1e-5 and erosion_same):
        raise AssertionError("the host-ops library disagrees with its numpy forms")
    return times


def cli_run(args: list, label: str) -> tuple[float, str]:
    """``python -m vision_tpu_torch.cli`` with ``args`` from the checkout's
    root; raises unless it exits 0. Returns its wall seconds and output."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "vision_tpu_torch.cli", *args], cwd=root, capture_output=True,
                         text=True, timeout=600)
    wall_s = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"CLI {label} exited {res.returncode}:\n{res.stdout}\n{res.stderr}")
    return wall_s, res.stdout


def cli_main(args: list, label: str) -> tuple[float, str]:
    """``vision_tpu_torch.cli.main(args)`` in this process, its standard
    output captured; raises unless it returns 0. Returns its wall seconds
    and output (no interpreter start: cli_run drives the module entry point
    once a phase)."""
    import contextlib
    import io

    from vision_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(args))
    wall_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"CLI {label} (in process) returned {rc}:\n{buf.getvalue()}")
    return wall_s, buf.getvalue()


def front_door_phases(torch, card: str, fa, wa, cc, dsm, dcm, tmp: str) -> dict:
    """Phases 27-28: every graphed forward_u8 of the five models, eager
    against replay (GRAPH_CASES); then the CLI as a subprocess, each model
    verb's output PNG against the in-process model.compute, plus info and
    compare. The six GGUFs are written into ``tmp``. Returns what phase 29
    reports of it, and the GGUFs' paths, the six models on the card and the
    launch-count reader, which phases 30-32 reuse."""
    import gc

    from vision_tpu_torch import load_model
    from vision_tpu_torch.cli import _composite
    from vision_tpu_torch.core.device import backend_init
    from vision_tpu_torch.image import (
        Image,
        ImageFormat,
        image_difference_rms,
        image_f32_to_u8,
        image_load,
        image_save,
    )
    from vision_tpu_torch.models.yolov9t import draw_detections

    def counts():
        return {"flash": fa.launches, "window": wa.launches, "conv3x3": cc.launches, "deform_conv": dcm.launches,
                "deform_sample": dsm.launches}

    gc.collect()  # the earlier phases' models and their graphs
    torch.cuda.empty_cache()
    rng = np.random.default_rng(27)
    rows = {}
    t0 = time.perf_counter()
    paths = front_door_ggufs(tmp)
    print(f"the six families' random full-width GGUFs written in {time.perf_counter() - t0:.1f} s", flush=True)

    phase("27 CUDA graphs: each forward_u8 replayed against its eager forward")
    gpu = backend_init("gpu")
    models = {}
    for family, batches, shapes, flags in GRAPH_CASES:
        models[family] = model = load_model(paths[family], gpu)
        for b in batches:
            xs = [torch.from_numpy(rng.integers(0, 256, (b, *sh), np.uint8)).cuda() for sh in shapes]
            if family == "migan":
                xs[1] = (xs[1] > 180).to(torch.uint8) * 255
            rows[(family, b)] = graph_case(torch, card, family, model, xs, flags, counts)
        if len(model.graphs.cache) != len(batches):
            raise AssertionError(f"{family}: {len(model.graphs.cache)} graphs for {len(batches)} keys")
    rows[("sam3", SAM3_SERVE_BATCH)] = sam3_published_graph_case(torch, card, fa, counts, rng)

    phase("28 CLI: python -m vision_tpu_torch.cli, every model verb and info and compare")
    w, h = CLI_EXTENT
    y, x = np.mgrid[0:h, 0:w]
    px = np.stack([(x * 3 + y) % 256, (y * 5) % 256, (x * y // 7) % 256], -1)
    px = (px + rng.integers(0, 24, px.shape)).clip(0, 255).astype(np.uint8)
    mask = np.zeros((h, w, 1), np.uint8)
    mask[h // 4 : h * 3 // 4, w // 3 : w * 2 // 3] = 255
    src, msk = os.path.join(tmp, "in.png"), os.path.join(tmp, "mask.png")
    image_save(Image(px, ImageFormat.rgb_u8), src)
    image_save(Image(mask, ImageFormat.alpha_u8), msk)
    image, mask_img = image_load(src), image_load(msk)
    out = lambda name: os.path.join(tmp, f"out_{name}.png")  # noqa: E731
    verbs = {
        "depthany": ["-i", src],
        "birefnet": ["-i", src, "--composite", out("composite")],
        "esrgan": ["-i", src, "--tile", "224"],
        "migan": ["-i", src, msk],
        "yolov9t": ["-i", src],
        "sam": ["-i", src, "-p", str(w // 2), str(h // 3)],
    }
    cli_s = {}
    for verb, extra in verbs.items():
        # the module entry point once, as a subprocess; the other verbs through cli.main in this process
        run = cli_run if verb == CLI_SUBPROCESS_VERB else cli_main
        cli_s[verb], stdout = run([verb, "-m", paths[verb], "-o", out(verb), *extra], verb)
        got = image_load(out(verb))
        if verb not in models:  # SAM: phase 30 serves it too
            models[verb] = load_model(paths[verb], gpu)
        model = models[verb]
        if verb == "depthany":
            want = image_f32_to_u8(model.compute(image), ImageFormat.alpha_u8)
        elif verb == "esrgan":
            want = model.compute(image, tile_size=224)
        elif verb == "migan":
            want = model.compute(image, mask_img)
        elif verb == "yolov9t":
            dets = model.compute(image, 0.25, 0.45)
            want = draw_detections(image, dets)
            if f"Found {len(dets)} objects:" not in stdout:
                raise AssertionError(f"CLI yolov9t printed {stdout[:300]!r}, in-process found {len(dets)}")
        elif verb == "sam":
            model.encode(image)
            want = model.compute(point=(w // 2, h // 3))
        else:
            want = model.compute(image)
            _composite(image, want, out("composite_in_process"))
            if not np.array_equal(image_load(out("composite")).data,
                                  image_load(out("composite_in_process")).data):
                raise AssertionError("CLI birefnet --composite differs from the in-process composite")
        same = got.format == want.format and np.array_equal(got.data, want.data)
        off = float((got.data != want.data).mean()) if got.data.shape == want.data.shape else 1.0
        phases_line = " | ".join(ln for ln in stdout.splitlines() if "done (" in ln)
        how = "a subprocess" if verb == CLI_SUBPROCESS_VERB else "cli.main in process"
        print(f"CLI {verb} ({how}): exit 0 in {cli_s[verb]:.2f} s wall ({phases_line}); {got.extent} "
              f"{got.format.value}, "
              f"{'equal to' if same else f'{off:.4%} of values differ from'} the in-process model.compute "
              f"[{card}]", flush=True)
        if not same:
            raise AssertionError(f"CLI {verb}: output differs from the in-process model.compute")
    cli_s["info"], stdout = cli_main(["info", "-m", paths["birefnet"]], "info")
    if "family: birefnet" not in stdout:
        raise AssertionError(f"CLI info printed {stdout[:300]!r}")
    matte = image_load(out("birefnet"))
    image_save(matte, out("birefnet_copy"))
    cli_s["compare"], stdout = cli_main(["compare", "-i", out("birefnet"), out("birefnet_copy"), "--max-rms", "0"],
                                        "compare")
    if not stdout.startswith("rms  0.000000") or image_difference_rms(matte, image_load(out("birefnet_copy"))):
        raise AssertionError(f"CLI compare printed {stdout!r}")
    print(f"CLI info {cli_s['info']:.2f} s, compare {cli_s['compare']:.2f} s wall (cli.main in process): exit 0 "
          f"[{card}]", flush=True)
    host_ops = host_ops_timing(card)
    from vision_tpu_torch.ops.cuda import dequant as dqm

    counters = {"flash": fa, "window": wa, "conv3x3": cc, "deform_conv": dcm, "deform_sample": dsm, "dequant": dqm}
    return {"graphs": rows, "cli_s": cli_s, "host_ops": host_ops, "paths": paths, "models": models, "counts": counts,
            "counters": counters}


def front_images(rng, extents, channels: int = 3) -> list:
    """Smooth seeded u8 images, one per (w, h) extent: the CLI phase's
    pattern plus noise. With 4 channels the alpha is MI-GAN's mask: 255 to
    keep, a hole of 0 in the middle."""
    out = []
    for w, h in extents:
        y, x = np.mgrid[0:h, 0:w]
        px = np.stack([(x * 3 + y) % 256, (y * 5) % 256, (x * y // 7) % 256], -1)
        px = (px + rng.integers(0, 24, px.shape)).clip(0, 255).astype(np.uint8)
        if channels == 4:
            alpha = np.full((h, w, 1), 255, np.uint8)
            alpha[h // 4 : h // 2, w // 3 : w * 2 // 3] = 0
            px = np.concatenate([px, alpha], axis=2)
        out.append(px)
    return out


def http_requests(rng) -> list:
    """Phase 30's requests in the order the clients send them (a seeded
    shuffle of HTTP_EXTENTS): (service, path with its query, pixels,
    prompt), the prompt SAM's ("point", (x, y)) or ("box", ((x0, y0), (x1,
    y1))), else None."""
    reqs = []
    for service, extents in HTTP_EXTENTS.items():
        for i, px in enumerate(front_images(rng, extents, 4 if service == "migan" else 3)):
            h, w = px.shape[:2]
            path, prompt = HTTP_ROUTES[service], None
            if service == "sam" and i % 2 == 0:
                prompt = ("point", (w // 3, h // 2))
                path += f"?x={w // 3}&y={h // 2}"
            elif service == "sam":
                prompt = ("box", ((w // 8, h // 8), (w * 5 // 8, h * 3 // 4)))
                path += f"?box={w // 8},{h // 8},{w * 5 // 8},{h * 3 // 4}"
            reqs.append((service, path, px, prompt))
    return [reqs[i] for i in rng.permutation(len(reqs))]


def submit_in_process(svc, service: str, img, prompt):
    """The request the HTTP handler makes of a decoded body, straight to the
    service: SAM's prompt, MI-GAN's alpha as the mask."""
    from vision_tpu_torch.image import Image, ImageFormat

    if service == "sam":
        kind, where = prompt
        return svc.submit(img, **{kind: where})
    if service == "migan":
        return svc.submit((img, Image(np.ascontiguousarray(img.data[:, :, 3:4]), ImageFormat.alpha_u8)))
    return svc.submit(img)


def response_pixels(service: str, result) -> np.ndarray:
    """What the HTTP endpoint encodes of a server result (serve_http's
    _png_bytes through result_u8); MI-GAN's RGB."""
    from vision_tpu_torch.image.image import result_u8

    a = result_u8(result.data)
    return a[:, :, :3] if service == "migan" else a


def lsb_close(got: np.ndarray, want: np.ndarray, max_diff: int = 1) -> tuple[bool, int, float]:
    """(within ``max_diff`` u8 levels on at most MAX_SHARE_OFF of the
    values, max difference, share of values that differ). An annotated
    YOLOv9t image takes max_diff 255: a box edge lands a pixel apart where
    a coordinate within 1e-3 px of the other crosses a pixel boundary."""
    if got.shape != want.shape:
        return False, -1, 1.0
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    mx, share = int(diff.max()), float((diff > 0).mean())
    return mx <= max_diff and share <= MAX_SHARE_OFF, mx, share


def detections_match(doc: list, dets: list, box_round: float, conf_round: float) -> bool:
    """A JSON detection list (the HTTP endpoint's or bulk's) against
    Detections: the same classes in order, boxes and confidences within
    their roundings (``box_round``, ``conf_round``: half the last digit
    kept) plus 1e-3 px and 1e-4."""
    if len(doc) != len(dets):
        return False
    for j, d in zip(doc, dets):
        cls = j["class_id"] if "class_id" in j else j["class"]
        if cls not in (d.class_id, _class_name(d.class_id)):
            return False
        if max(abs(a - b) for a, b in zip(j["box"], (d.x1, d.y1, d.x2, d.y2))) > box_round + 1e-3:
            return False
        if abs(j["confidence"] - d.confidence) > conf_round + 1e-4:
            return False
    return True


def _class_name(class_id: int) -> str:
    from vision_tpu_torch.models.yolov9t import COCO_CLASS_NAMES

    return COCO_CLASS_NAMES[class_id] if class_id < len(COCO_CLASS_NAMES) else str(class_id)


def http_call(port: int, method: str, path: str, body: bytes | None = None, headers: dict | None = None):
    """One request to 127.0.0.1:port: (status, body, content type). The
    headers as given (default: the body's Content-Length)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.putrequest(method, path, skip_accept_encoding=True)
        for k, v in (headers if headers is not None else {"Content-Length": str(len(body or b""))}).items():
            conn.putheader(k, v)
        conn.endheaders()
        if body:
            conn.send(body)
        r = conn.getresponse()
        return r.status, r.read(), r.getheader("Content-Type")
    finally:
        conn.close()


# phase 30's HTTP client, a process of its own (no torch): argv port, a JSON
# plan [[path, body file], ...], an output directory ("-": keep no response)
# and the thread count. Each thread reads its body first, then times the
# request; each response is written to <dir>/<i>.bin; prints {"answers":
# [[status, content type, ms], ...], "wall_s": the plan's wall seconds}.
HTTP_CLIENT = """
import http.client, json, sys, time
from concurrent.futures import ThreadPoolExecutor
port, plan, out = int(sys.argv[1]), json.load(open(sys.argv[2])), sys.argv[3]
def send(i):
    path, body_file = plan[i]
    body = open(body_file, "rb").read()
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("POST", path, body)
    r = conn.getresponse()
    data = r.read()
    ms = (time.perf_counter() - t0) * 1e3
    conn.close()
    if out != "-":
        open(f"{out}/{i}.bin", "wb").write(data)
    return [r.status, r.getheader("Content-Type"), ms]
t0 = time.perf_counter()
with ThreadPoolExecutor(int(sys.argv[4])) as pool:
    answers = list(pool.map(send, range(len(plan))))
print(json.dumps({"answers": answers, "wall_s": time.perf_counter() - t0}))
"""


def http_client(port: int, plan: list, plan_path: str, out_dir: str) -> dict:
    """HTTP_CLIENT over ``plan`` ([[path, body file], ...], written to
    ``plan_path``) from HTTP_CLIENTS threads; raises unless it exits 0 and
    every answer is 200. Returns its printed object."""
    with open(plan_path, "w") as f:
        json.dump(plan, f)
    res = subprocess.run([sys.executable, "-c", HTTP_CLIENT, str(port), plan_path, out_dir, str(HTTP_CLIENTS)],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise AssertionError(f"the HTTP client exited {res.returncode}:\n{res.stderr}")
    got = json.loads(res.stdout)
    bad = [(i, a[0]) for i, a in enumerate(got["answers"]) if a[0] != 200]
    if bad:
        raise AssertionError(f"HTTP answers other than 200 (plan index, status): {bad[:10]}")
    return got


def stream_plan(reqs: list, service: str, n: int) -> list:
    """The indexes into ``reqs`` of ``service``'s latency stream: its
    requests in their order, cycled to ``n``."""
    mine = [i for i, r in enumerate(reqs) if r[0] == service]
    return [mine[k % len(mine)] for k in range(n)]


def latency_streams(card: str, srv, reqs: list, body_files: list, decoded: list, tmp: str) -> dict:
    """Phase 30's latency: each endpoint alone, HTTP_STREAM requests
    (stream_plan) from HTTP_CLIENTS threads of the client process, then the
    same requests from HTTP_CLIENTS threads of this process straight to the
    service (the bodies decoded beforehand). Each stream's p50 and p99 over
    all its requests and its req/s; for the HTTP stream also the service's
    own p50 and p99 of the same requests (submit to result, its stats) and
    its batches. Returns service -> those numbers."""
    from concurrent.futures import ThreadPoolExecutor

    rows = {}
    for service in HTTP_EXTENTS:
        svc, plan = srv.services[service], stream_plan(reqs, service, HTTP_STREAM)
        svc.stats.reset()
        got = http_client(srv.port, [[reqs[i][1], body_files[i]] for i in plan],
                          os.path.join(tmp, f"stream_{service}.json"), "-")
        http_ms = [a[2] for a in got["answers"]]
        stats = svc.stats
        row = {"http_p50": float(np.percentile(http_ms, 50)), "http_p99": float(np.percentile(http_ms, 99)),
               "http_rps": len(plan) / got["wall_s"], "svc_p50": stats.p50_latency_ms,
               "svc_p99": stats.p99_latency_ms, "batches": stats.batches}
        in_ms = []

        def submit(i, svc=svc, service=service, in_ms=in_ms):
            t0 = time.perf_counter()
            submit_in_process(svc, service, decoded[i], reqs[i][3]).result(timeout=600)
            in_ms.append((time.perf_counter() - t0) * 1e3)

        t0 = time.perf_counter()
        with ThreadPoolExecutor(HTTP_CLIENTS) as pool:
            list(pool.map(submit, plan))
        row.update(in_p50=float(np.percentile(in_ms, 50)), in_p99=float(np.percentile(in_ms, 99)),
                   in_rps=len(plan) / (time.perf_counter() - t0))
        rows[service] = row
        print(f"{service}: {len(plan)} requests, {HTTP_CLIENTS} in flight: HTTP p50 {row['http_p50']:.3f} ms, p99 "
              f"{row['http_p99']:.3f} ms, {row['http_rps']:.3f} req/s in {row['batches']} batches (the service's "
              f"own p50 {row['svc_p50']:.3f} ms, p99 {row['svc_p99']:.3f} ms of them); in-process p50 "
              f"{row['in_p50']:.3f} ms, p99 {row['in_p99']:.3f} ms, {row['in_rps']:.3f} req/s [{card}]", flush=True)
    return rows


def host_median_ms(fn) -> float:
    """The median of 5 calls of ``fn`` on the host's clock, in ms, after
    one call to warm up."""
    fn()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def expected_launches(batches: dict) -> dict:
    """The hand-written launches of ``batches`` (service -> batches run):
    each service's per-forward counts (SERVICE_KERNELS) times its batches,
    summed by counter; every counter of COUNTER_KERNELS, 0 where none."""
    want = {k: 0 for k in COUNTER_KERNELS}
    for service, n in batches.items():
        for k, per in SERVICE_KERNELS[service].items():
            want[k] += per * n
    return want


def http_phase(torch, card: str, fd: dict, tmp: str) -> dict:
    """Phase 30: VisionHTTPServer over the six models on 127.0.0.1, port 0,
    each service at its default batch; HTTP_CLIENTS threads of a client
    process of their own (HTTP_CLIENT) send the bodies of http_requests (the
    port's encode_png) at once. Every response is 200 and equals the same
    request through the in-process service within lsb_close (YOLOv9t's JSON
    its Detections); the hand-written launches equal SERVICE_KERNELS times
    each service's batches; /healthz reports the six services, one of them
    with fewer batches than requests; no result is copied to the host on a
    handler thread; a truncated PNG gets 400, an unknown route 404, a
    Content-Length past MAX_BODY_BYTES 413. Prints the host codec's ms and
    each endpoint's latency_streams, which it returns."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from vision_tpu_torch import serve_http as thttp
    from vision_tpu_torch.image.png import encode_png, read_png

    phase("30 HTTP: VisionHTTPServer over the six families at full width, 8 clients at once")
    models, counts = fd["models"], fd["counts"]
    reqs = http_requests(np.random.default_rng(30))
    bodies = [encode_png(px) for _, _, px, _ in reqs]
    out_dir = os.path.join(tmp, "http_responses")
    os.makedirs(out_dir)
    body_files = [os.path.join(tmp, f"http_body_{i}.png") for i in range(len(bodies))]
    for path, body in zip(body_files, bodies):
        with open(path, "wb") as f:
            f.write(body)
    srv = thttp.VisionHTTPServer(**{f"{s}_model": models[f] for s, f in SERVICE_FAMILIES.items()}, port=0)
    tensor_cpu = torch.Tensor.cpu
    try:
        svcs = srv.services
        # every bucket's graph is captured before the counted run (a capture's
        # eager warm-up launches the kernels too); warmup() resets the stats
        svcs["depthany"].warmup()
        svcs["depthany"].warmup((700, 500))
        svcs["esrgan"].warmup((256, 256))
        for name in ("birefnet", "sam", "migan", "yolo"):
            svcs[name].warmup()
        srv.start()
        host_copies = []  # the threads that copy a tensor to the host while clients send

        def spy_cpu(self, *args, **kw):
            host_copies.append(threading.current_thread().name)
            return tensor_cpu(self, *args, **kw)

        for m in fd["counters"].values():
            m.launches = 0
        torch.Tensor.cpu = spy_cpu
        got = http_client(srv.port, [[path, f] for (_, path, _, _), f in zip(reqs, body_files)],
                          os.path.join(tmp, "http_plan.json"), out_dir)
        torch.Tensor.cpu = tensor_cpu
        launched = counts()
        batches = {name: svc.stats.batches for name, svc in svcs.items()}
        health = json.loads(http_call(srv.port, "GET", "/healthz")[1])
        responses = []
        for i, (status, ctype, _) in enumerate(got["answers"]):
            with open(os.path.join(out_dir, f"{i}.bin"), "rb") as f:
                responses.append((status, f.read(), ctype))
        want = expected_launches(batches)
        print(f"{len(reqs)} HTTP requests from {HTTP_CLIENTS} client threads of a process of their own in "
              f"{got['wall_s']:.3f} s; batches {batches}; hand-written launches {launched}, expected {want} [{card}]",
              flush=True)
        if launched != want:
            raise AssertionError(f"launches {launched}, expected {want} (per forward times batches)")
        sent = {s: len(e) for s, e in HTTP_EXTENTS.items()}
        models_health = health["models"]
        if set(models_health) != set(sent) or any(models_health[s]["requests"] != n for s, n in sent.items()):
            raise AssertionError(f"/healthz {health}, sent {sent}")
        shared = [s for s in sent if models_health[s]["batches"] < models_health[s]["requests"]]
        print(f"/healthz: {json.dumps(models_health)}; services whose clients shared a forward: {shared}",
              flush=True)
        if health["status"] != "ok" or not shared:
            raise AssertionError(f"/healthz shows no shared forward: {health}")
        on_handlers = sorted({t for t in host_copies if "process_request_thread" in t})
        if not host_copies or on_handlers:
            raise AssertionError(f"host copies on handler threads {on_handlers} (of {len(host_copies)})")
        print(f"{len(host_copies)} copies to the host while clients sent, all on the servers' batch workers "
              f"({sorted(set(host_copies))[:3]}...)", flush=True)

        depth_body = bodies[next(i for i, r in enumerate(reqs) if r[0] == "depthany")]
        errors = {
            "truncated PNG": (http_call(srv.port, "POST", "/v1/depthany", depth_body[: len(depth_body) // 2]), 400),
            "unknown route": (http_call(srv.port, "POST", "/v1/nope", b"x"), 404),
            "Content-Length past MAX_BODY_BYTES": (http_call(
                srv.port, "POST", "/v1/migan", b"x", {"Content-Length": str(thttp.MAX_BODY_BYTES + 1)}), 413),
        }
        for label, ((status, body, _), want_status) in errors.items():
            print(f"{label}: HTTP {status} {body[:120]!r}", flush=True)
            if status != want_status:
                raise AssertionError(f"{label}: HTTP {status}, expected {want_status}")

        # the same requests through the same services in process, from 8 threads in the same order
        decoded = [thttp._load_image_bytes(b) for b in bodies]
        results = [None] * len(reqs)

        def submit(i):
            service, _, _, prompt = reqs[i]
            results[i] = submit_in_process(svcs[service], service, decoded[i], prompt).result(timeout=600)

        with ThreadPoolExecutor(HTTP_CLIENTS) as pool:
            list(pool.map(submit, range(len(reqs))))
        worst = {}
        for (service, path, _, _), (_, body, ctype), res in zip(reqs, responses, results):
            if service == "yolo":
                if ctype != "application/json" or not detections_match(json.loads(body), res, 0.005, 5e-5):
                    raise AssertionError(f"{path}: the JSON differs from the in-process Detections")
                continue
            ok, mx, share = lsb_close(read_png(body), response_pixels(service, res))
            prev = worst.get(service, (0, 0.0))
            worst[service] = (max(prev[0], mx), max(prev[1], share))
            if ctype != "image/png" or not ok:
                raise AssertionError(f"{path}: max difference {mx}, {share:.4%} of values differ from in-process")
        print("HTTP responses against the in-process services: " + "; ".join(
            f"{s} max u8 difference {mx}, {share:.4%} of values off" for s, (mx, share) in worst.items())
              + "; yolo's JSON equal to the Detections within its roundings", flush=True)

        # the host codec: decode of each body extent, encode of each service's response
        decode_ms = {}
        for (service, _, px, _), body in zip(reqs, bodies):
            key = f"{px.shape[1]}x{px.shape[0]}x{px.shape[2]}"
            if key not in decode_ms:
                decode_ms[key] = host_median_ms(lambda: read_png(body))
        encode_ms = {}
        for (service, _, _, _), res in zip(reqs, results):
            if service != "yolo" and service not in encode_ms:
                enc_img = res
                if service == "migan":
                    from vision_tpu_torch.image import Image, ImageFormat

                    enc_img = Image(np.ascontiguousarray(res.data[:, :, :3]), ImageFormat.rgb_u8)
                encode_ms[service] = (host_median_ms(lambda: thttp._png_bytes(enc_img)),
                                      f"{res.width}x{res.height}x{response_pixels(service, res).shape[2]}")
        print("host codec (median of 5 on the host): decode " + ", ".join(f"{k} {v:.3f} ms" for k, v in
                                                                        decode_ms.items())
              + "; encode " + ", ".join(f"{s} {ext} {ms:.3f} ms" for s, (ms, ext) in encode_ms.items())
              + f" [{card}]", flush=True)
        return latency_streams(card, srv, reqs, body_files, decoded, tmp)
    finally:
        torch.Tensor.cpu = tensor_cpu
        srv.close()


def count_forwards(model) -> list:
    """Shadows ``model.forward_u8`` with a wrapper that appends to the
    returned list at each call; ``del model.forward_u8`` brings the class's
    method back."""
    calls, forward = [], model.forward_u8

    def counted(*args, **kw):
        calls.append(1)
        return forward(*args, **kw)

    model.forward_u8 = counted
    return calls


def bulk_phase(torch, card: str, fd: dict, tmp: str) -> dict:
    """Phase 31: bulk_run on the card over a directory of 12 PNGs at mixed
    extents (Depth-Anything) and one of 8 (YOLOv9t, with detections.json),
    each Depth-Anything bucket's graph captured first. Every written file
    equals that image through the in-process server within lsb_close
    (YOLOv9t's annotation and JSON against its Detections), and the
    hand-written launches equal the per-forward count times the forwards
    that bulk_run's server called. Prints img/s and occupancy."""
    from vision_tpu_torch.bulk import bulk_inputs, bulk_run
    from vision_tpu_torch.image import Image, ImageFormat, image_load, image_save
    from vision_tpu_torch.models.depth_anything import depthany_image_extent
    from vision_tpu_torch.models.yolov9t import draw_detections
    from vision_tpu_torch.serve import ImageServer, YoloServer

    phase("31 bulk: bulk_run over directories of PNGs (Depth-Anything at mixed extents, YOLOv9t)")
    models, counts = fd["models"], fd["counts"]
    rng = np.random.default_rng(31)
    dm = models["depthany"]
    for w, h in sorted({depthany_image_extent(e, dm.p) for e in BULK_EXTENTS["depthany"]}):
        dm.forward_u8(torch.zeros((4, h, w, 3), dtype=torch.uint8, device=dm.device.torch_device))  # bulk's batch
    out = {"dirs": {}, "outs": {}}  # family -> its input and output directory, which phase 32 reads
    for family, service in (("depthany", "depthany"), ("yolov9t", "yolo")):
        src = os.path.join(tmp, f"bulk_in_{family}")
        os.makedirs(src)
        for i, px in enumerate(front_images(rng, BULK_EXTENTS[family])):
            image_save(Image(px, ImageFormat.rgb_u8), os.path.join(src, f"{family}_{i:02d}.png"))
        inputs, dst, logs = bulk_inputs(src), os.path.join(tmp, f"bulk_out_{family}"), []
        model = models[family]
        forwards = count_forwards(model)
        for m in fd["counters"].values():
            m.launches = 0
        try:
            t0 = time.perf_counter()
            written = bulk_run(model, inputs, dst, log=logs.append)
            wall_s = time.perf_counter() - t0
        finally:
            del model.forward_u8  # the class's method again
        launched = counts()
        want = expected_launches({service: len(forwards)})
        print(f"bulk_run {family}: {len(inputs)} images -> {len(written)} files in {wall_s:.3f} s, "
              f"{len(inputs) / wall_s:.3f} img/s; its summary: {logs[-1].strip()}; {len(forwards)} forwards; "
              f"hand-written launches {launched}, expected {want} [{card}]", flush=True)
        if launched != want:
            raise AssertionError(f"bulk {family}: launches {launched}, expected {want}")
        if family == "depthany":
            with ImageServer(models[family]) as srv:
                res = [f.result(timeout=600) for f in [srv.submit(image_load(p)) for p in inputs]]
            checks = [(os.path.join(dst, os.path.basename(p)), response_pixels("depthany", r), 1)
                      for p, r in zip(inputs, res)]
        else:
            with YoloServer(models[family]) as srv:
                imgs = [image_load(p) for p in inputs]
                res = [f.result(timeout=600) for f in [srv.submit(img) for img in imgs]]
            doc = json.load(open(os.path.join(dst, "detections.json")))
            for p, dets in zip(inputs, res):
                if not detections_match(doc[os.path.splitext(os.path.basename(p))[0]], dets, 0.05, 5e-5):
                    raise AssertionError(f"bulk yolov9t: detections.json for {p} differs from the in-process")
            checks = [(os.path.join(dst, os.path.basename(p)), draw_detections(img, d).data, 255)
                      for p, img, d in zip(inputs, imgs, res)]
        worst = (0, 0.0)
        for path, want_px, max_diff in checks:
            got = image_load(path).data
            ok, mx, share = lsb_close(got, want_px, max_diff)
            worst = (max(worst[0], mx), max(worst[1], share))
            if not ok:
                raise AssertionError(f"bulk {path}: max difference {mx}, {share:.4%} of values off")
        print(f"bulk_run {family}: every file against the in-process server: max difference {worst[0]}, "
              f"share off {worst[1]:.4%}", flush=True)
        out["dirs"][family], out["outs"][family] = src, dst
    return out


def serve_verb(card: str, fd: dict, tmp: str) -> None:
    """Phase 32's serve: ``python -m vision_tpu_torch.cli serve`` with
    Depth-Anything and --extra-model YOLOv9t on port 0, the port read from
    its "serving on port N" line; one request to each of the six routes
    (the four families not loaded get 404), the two answers against the
    in-process servers; then SIGINT, after which it must exit 0 within
    SERVE_EXIT_S."""
    import queue
    import signal
    import threading

    from vision_tpu_torch import serve_http as thttp
    from vision_tpu_torch.image.png import encode_png, read_png
    from vision_tpu_torch.serve import ImageServer, YoloServer

    paths, models = fd["paths"], fd["models"]
    root = os.path.dirname(os.path.abspath(__file__))
    err_path = os.path.join(tmp, "serve_stderr.txt")
    with open(err_path, "w") as err:
        proc = subprocess.Popen([sys.executable, "-m", "vision_tpu_torch.cli", "serve", "-m", paths["depthany"],
                                 "--extra-model", paths["yolov9t"], "--port", "0"], cwd=root,
                                stdout=subprocess.PIPE, stderr=err, text=True)
    try:
        lines: queue.Queue = queue.Queue()
        threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout] + [lines.put(None)],
                         daemon=True).start()
        t0 = time.perf_counter()
        port, seen = None, []
        while port is None:
            line = lines.get(timeout=600)
            if line is None:
                raise AssertionError(f"serve exited {proc.wait()} before listening:\n{''.join(seen)}\n"
                                     f"{open(err_path).read()}")
            seen.append(line)
            if line.startswith("serving on port "):
                port = int(line.split()[3].rstrip(":"))
        start_s = time.perf_counter() - t0
        rng = np.random.default_rng(32)
        depth_px, yolo_px = front_images(rng, ((700, 500), (1280, 720)))
        answers = {route: http_call(port, "POST", route, encode_png(depth_px if "depth" in route else yolo_px))
                   for route in HTTP_ROUTES.values()}
        with ImageServer(models["depthany"]) as srv:
            depth_want = srv.submit(thttp._load_image_bytes(encode_png(depth_px))).result(timeout=600)
        with YoloServer(models["yolov9t"]) as srv:
            yolo_want = srv.submit(thttp._load_image_bytes(encode_png(yolo_px))).result(timeout=600)
        for route, (status, body, ctype) in answers.items():
            service = next(s for s, r in HTTP_ROUTES.items() if r == route)
            if service == "depthany":
                ok = status == 200 and lsb_close(read_png(body), response_pixels("depthany", depth_want))[0]
            elif service == "yolo":
                ok = status == 200 and detections_match(json.loads(body), yolo_want, 0.005, 5e-5)
            else:
                ok = status == 404 and json.loads(body) == {"error": f"no {service} model loaded"}
            print(f"serve subprocess {route}: HTTP {status} ({ctype}), {'as expected' if ok else 'UNEXPECTED'}",
                  flush=True)
            if not ok:
                raise AssertionError(f"serve subprocess {route}: HTTP {status} {body[:200]!r}")
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=SERVE_EXIT_S)
        exit_s = time.perf_counter() - t1
        print(f"serve subprocess: listening {start_s:.2f} s after start (port {port}); exit {rc} "
              f"{exit_s:.2f} s after SIGINT [{card}]", flush=True)
        if rc != 0:
            raise AssertionError(f"serve exited {rc} on SIGINT:\n{open(err_path).read()}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def verbs_phase(torch, card: str, fd: dict, tmp: str, bulk: dict) -> None:
    """Phase 32: the CLI's new verbs on the card, ``serve`` as a subprocess
    (its SIGINT exit), the others through cli.main in process. ``eval -m``
    for Depth-Anything over phase 31's 12 images, its ground truth the
    port's CPU f32 depth of the same images shifted into [1, 2] (.npy):
    AbsRel within EVAL_ABSREL. ``eval -m`` for YOLOv9t, its ground truth the
    CPU f32 detections.json: its mAP printed, not gated (random weights put
    every score near 0.5). ``serve`` (serve_verb). ``depthany -i <dir>``,
    whose files must equal phase 31's within lsb_close. A video through
    ``depthany`` where OpenCV imports, and otherwise a line that says it was
    not driven (video_verb). Last, depth_eval_readings: every planted flash
    fault must put AbsRel past EVAL_ABSREL."""
    from vision_tpu_torch import load_model
    from vision_tpu_torch.bulk import bulk_inputs, bulk_run
    from vision_tpu_torch.core.device import backend_init
    from vision_tpu_torch.image import image_load

    phase("32 the verbs: eval -m, serve (a subprocess), a directory -i, a video (cli.main in process)")
    paths = fd["paths"]
    cpu = backend_init("cpu")
    t0 = time.perf_counter()
    gt_depth, gt_yolo = os.path.join(tmp, "gt_depth"), os.path.join(tmp, "gt_yolov9t")
    os.makedirs(gt_depth)
    cpu_model = load_model(paths["depthany"], cpu)
    for f in bulk_inputs(bulk["dirs"]["depthany"]):
        depth = cpu_model.compute(image_load(f)).data
        np.save(os.path.join(gt_depth, os.path.splitext(os.path.basename(f))[0] + ".npy"), depth + 1.0)
    cpu_model = load_model(paths["yolov9t"], cpu)
    bulk_run(cpu_model, bulk_inputs(bulk["dirs"]["yolov9t"]), gt_yolo, log=lambda *_: None)
    del cpu_model
    print(f"ground truth from the port's f32 forwards on the CPU in {time.perf_counter() - t0:.1f} s", flush=True)

    scores = {}
    for family, gt in (("depthany", gt_depth), ("yolov9t", os.path.join(gt_yolo, "detections.json"))):
        result = os.path.join(tmp, f"eval_{family}.json")
        wall, stdout = cli_main(["eval", "-m", paths[family], "-i", bulk["dirs"][family], "--gt", gt, "-o", result],
                                f"eval -m {family}")
        r = json.load(open(result))
        report = "\n".join(ln for ln in stdout[stdout.index("task "):].splitlines() if not ln.startswith("-> "))
        print(f"CLI eval -m {family}: exit 0 in {wall:.2f} s wall; " + " | ".join(report.splitlines()) + f" [{card}]",
              flush=True)
        want_task = "depth" if family == "depthany" else "detection"
        if r["task"] != want_task or r["n_images"] != len(BULK_EXTENTS[family]):
            raise AssertionError(f"eval {family}: {r['task']} over {r['n_images']} images")
        scores[family] = r["mean"]
    depth, det = scores["depthany"], scores["yolov9t"]
    print(f"eval -m depthany, card bf16 against CPU f32: AbsRel {depth['absrel']:.4e} (bound {EVAL_ABSREL}), "
          f"delta1 {depth['delta1']:.6f}; eval -m yolov9t against the CPU's detections: mAP@0.5 "
          f"{det['map50']:.4f}, mAP@[.5:.95] {det['map50_95']:.4f} (random weights: printed, not gated)", flush=True)
    if not depth["absrel"] <= EVAL_ABSREL:
        raise AssertionError(f"eval -m depthany AbsRel {depth['absrel']} past {EVAL_ABSREL}")

    serve_verb(card, fd, tmp)

    dst = os.path.join(tmp, "cli_bulk_depthany")
    wall, stdout = cli_main(["depthany", "-m", paths["depthany"], "-i", bulk["dirs"]["depthany"], "-o", dst],
                            "depthany -i <dir>")
    worst, equal = (0, 0.0), 0
    for name in sorted(os.listdir(bulk["outs"]["depthany"])):
        got, want = image_load(os.path.join(dst, name)).data, image_load(os.path.join(bulk["outs"]["depthany"],
                                                                                     name)).data
        ok, mx, share = lsb_close(got, want)
        worst, equal = (max(worst[0], mx), max(worst[1], share)), equal + (mx == 0)
        if not ok:
            raise AssertionError(f"CLI depthany -i <dir>: {name} differs from phase 31's (max {mx}, {share:.4%})")
    print(f"CLI depthany -i <dir>: exit 0 in {wall:.2f} s wall; {equal} of {len(BULK_EXTENTS['depthany'])} files "
          f"equal to phase 31's, max difference {worst[0]}, share off {worst[1]:.4%} [{card}]", flush=True)

    video_verb(card, fd, tmp)

    faults = depth_eval_readings(card, fd, bulk_inputs(bulk["dirs"]["depthany"]), gt_depth, tmp)
    missed = {k: v for k, v in faults.items() if not v > EVAL_ABSREL}
    if missed:
        raise AssertionError(f"planted flash faults within eval -m's AbsRel bound {EVAL_ABSREL}: {missed}")


def video_verb(card: str, fd: dict, tmp: str) -> None:
    """Phase 32's video: ``depthany -i <clip>`` on a VIDEO_FRAMES-frame clip
    that VideoWriter made, where OpenCV imports; otherwise a line that says
    it was not driven and why."""
    paths = fd["paths"]
    try:
        import cv2  # noqa: F401
    except ImportError as e:
        print(f"video: video_run was not driven on this machine: OpenCV (cv2) does not import ({e}), and "
              f"video.py decodes and encodes through it", flush=True)
        return
    from vision_tpu_torch.video import VideoReader, VideoWriter

    clip, clip_out = os.path.join(tmp, "clip.avi"), os.path.join(tmp, "clip_depth.avi")
    with VideoWriter(clip, 12.0, (640, 480)) as w:
        for px in front_images(np.random.default_rng(33), ((640, 480),) * VIDEO_FRAMES):
            w.write(px)
    wall, _ = cli_main(["depthany", "-m", paths["depthany"], "-i", clip, "-o", clip_out], "depthany -i <video>")
    with VideoReader(clip_out) as r:
        n, extent = sum(1 for _ in r), r.extent
    print(f"CLI depthany -i <video>: exit 0 in {wall:.2f} s wall; {n} frames of {extent} written for "
          f"{VIDEO_FRAMES} [{card}]", flush=True)
    if n != VIDEO_FRAMES or extent != (640, 480):
        raise AssertionError(f"video: {n} frames of {extent}")


def depth_eval_readings(card: str, fd: dict, inputs: list, gt_dir: str, tmp: str) -> dict:
    """What eval -m depthany's AbsRel can see, as evaluate scores it against
    ``gt_dir``: the card's served depth (ImageServer, bf16) before its u8
    store, as .npy; and, for each DEPTH_FAULTS fault planted in the flash
    kernel's entry point, the u8 files bulk_run writes from a fresh
    Depth-Anything (its graphs capture the fault). Prints them all and
    returns fault -> AbsRel."""
    import vision_tpu_torch.ops.cuda.flash_attention as flash_mod
    from vision_tpu_torch import load_model
    from vision_tpu_torch.bulk import bulk_run
    from vision_tpu_torch.core.device import backend_init
    from vision_tpu_torch.evaluate import evaluate
    from vision_tpu_torch.image import image_load
    from vision_tpu_torch.serve import ImageServer

    floats = os.path.join(tmp, "depth_f32_card")
    os.makedirs(floats)
    with ImageServer(fd["models"]["depthany"]) as srv:
        futures = [(p, srv.submit(image_load(p))) for p in inputs]
        for p, fut in futures:
            np.save(os.path.join(floats, os.path.splitext(os.path.basename(p))[0] + ".npy"),
                    fut.result(timeout=600).data)
    before_u8 = evaluate("depth", floats, gt_dir)["mean"]["absrel"]
    faults = {}
    flash = flash_mod.flash_attention
    for n, (label, keys) in enumerate(DEPTH_FAULTS.items()):
        def faulty(q, k, v, *args, keys=keys, **kw):
            keep = keys(k.shape[2])
            return flash(q, k[:, :, keep].contiguous(), v[:, :, keep].contiguous(), *args, **kw)

        dst = os.path.join(tmp, f"depth_fault_{n}")
        flash_mod.flash_attention = faulty
        try:
            model = load_model(fd["paths"]["depthany"], backend_init("gpu"))
            bulk_run(model, inputs, dst, log=lambda *_: None)
        finally:
            flash_mod.flash_attention = flash
        del model
        faults[label] = evaluate("depth", dst, gt_dir)["mean"]["absrel"]
    print(f"eval -m depthany's AbsRel beside its readings: served float depth, before the u8 store {before_u8:.4e}; "
          + "; ".join(f"u8 files, {k} {v:.4e}" for k, v in faults.items()) + f" (bound {EVAL_ABSREL}) [{card}]",
          flush=True)
    return faults


class ParentConvEntry:
    """A parent library whose conv entry point predates the BatchNorm / SiLU
    epilogue (no scale and shift arguments): this checkout's wrapper calls
    it with its own arguments, and the path's forms that the A/B times (the
    Real-ESRGAN ones) pass neither. Every other entry point passes
    through."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def vtt_conv3x3_fwd(self, x, x_ps, w, b, scale, shift, *rest):
        if scale is not None or shift is not None:
            raise ValueError("the parent's conv kernel takes no scale or shift")
        return self._lib.vtt_conv3x3_fwd(x, x_ps, w, b, *rest)


# phases 33-35: quantized residency. The seven block formats a weight can
# stay int8-resident in (core/gguf.py _RESIDENT_TYPES)
QUANT_TYPES = ("Q8_0", "Q4_0", "Q4_1", "Q5_0", "Q5_1", "IQ4_NL", "IQ4_XS")
# phase 34's families, their Q8_0 copies' sources (MI-GAN's and YOLOv9t's
# stored cwhn first, cwhn_gguf), and the graphed ones' forward_u8 at their
# server's batch (as phase 27)
RESIDENT_FAMILIES = ("depthany", "sam", "birefnet", "migan", "yolov9t")
RESIDENT_CWHN = ("migan", "yolov9t")
RESIDENT_GRAPHS = {"depthany": (4, ((518, 518, 3),)), "birefnet": (4, ((1024, 1024, 3),)),
                   "migan": (MIGAN_BATCH, ((MIGAN_RES, MIGAN_RES, 3), (MIGAN_RES, MIGAN_RES, 1))),
                   "yolov9t": (YOLO_BATCH, ((640, 640, 3),))}
# the CPU runs that count a forward's resident lookups: small inputs (the
# count does not depend on the extent; MI-GAN's is its resolution)
LOOKUP_SHAPES = {"depthany": ((1, 126, 126, 3),), "birefnet": ((1, 128, 128, 3),),
                 "migan": ((1, MIGAN_RES, MIGAN_RES, 3), (1, MIGAN_RES, MIGAN_RES, 1)), "yolov9t": ((1, 64, 64, 3),)}
DEPTH_QUANT_EXTRA = ("q4_1", "iq4_nl")  # Depth-Anything's other copies
# the Q8_0 copies' dequant launches a full-width forward (one a weight's use),
# held as numbers: the CPU's count of lookups moves with the code it counts
RESIDENT_LAUNCHES = {"depthany": {"forward": 74}, "sam": {"encode": 40}, "birefnet": {"forward": 198}}
DISTILL_DEQUANTS = 105  # the QLoRA student's forward in the distillation step (phase 37)


def dequant_inputs(torch, rng, name: str, file_shape: tuple):
    """A random tensor of ``file_shape`` encoded in block format ``name`` by
    the port's quantizer, decomposed by quant_blocks: (q, scale, minv) on
    the card, and the file's own f32 dequant (numpy) of the same bytes."""
    from vision_tpu_torch.core.gguf import _DEQUANTIZE, GGMLType, quant_blocks
    from vision_tpu_torch.core.quantize import quantize_blocks

    fmt = GGMLType[name]
    n = int(np.prod(file_shape))
    x = rng.standard_normal(n).astype(np.float32) * rng.uniform(0.01, 2.0)
    raw = quantize_blocks(fmt, x)
    q, scale, minv = quant_blocks(fmt, raw, n)
    expanded = _DEQUANTIZE[fmt][0](raw, n).reshape(file_shape)
    on = [None if a is None else torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in (q, scale, minv)]
    return on, expanded


def same_bits(torch, a, b) -> bool:
    """Bit equality of two float tensors of one type (a -0.0 is not a 0.0)."""
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(view), b.view(view))


def dequant_cases(dqm, torch) -> int:
    """Phase 33: the dequant kernel against its plain version on the card,
    bit for bit, for every resident format in bf16 and f32: the identity at
    an n that is no multiple of a block of threads (256 threads of 8
    elements), a conv stored (O, H, W, I) under the permute (0, 3, 1, 2)
    and a depthwise conv stored (H, W, 1, C) under (3, 2, 0, 1); the f32
    result also against the file's own dequant. Returns the cases run and
    the largest absolute difference from the plain version (0 when every
    case is bit-equal)."""
    rng = np.random.default_rng(33)
    cases, worst = 0, 0.0
    for name in QUANT_TYPES:
        width = 256 if name == "IQ4_XS" else 96  # IQ4_XS encodes 256-element super-blocks
        for file_shape, permute in (((67, width), None), ((5, 3, 3, width), (0, 3, 1, 2)),
                                    ((3, 3, 1, 3 * width), (3, 2, 0, 1))):
            (q, scale, minv), expanded = dequant_inputs(torch, rng, name, file_shape)
            want = expanded if permute is None else expanded.transpose(permute)
            for dtype in (torch.bfloat16, torch.float32):
                out = dqm.dequant(q, scale, minv, file_shape, permute, dtype)
                ref = dqm.dequant_plain(q, scale, minv, file_shape, permute, dtype)
                torch.cuda.synchronize()
                worst = max(worst, float((out.float() - ref.float()).abs().max()))
                if not (out.is_contiguous() and same_bits(torch, out, ref)):
                    bad = int((out.float() != ref.float()).sum())
                    raise AssertionError(f"dequant {name} {file_shape} permute {permute} {dtype}: {bad} of "
                                         f"{out.numel()} elements differ from the plain version")
                if dtype == torch.float32 and not np.array_equal(out.cpu().numpy().view(np.uint32),
                                                                 np.ascontiguousarray(want).view(np.uint32)):
                    raise AssertionError(f"dequant {name} {file_shape} permute {permute}: differs from the "
                                         f"file's own dequant")
                cases += 1
            print(f"dequant {name:6s} {str(file_shape):16s} permute {str(permute):12s} n {int(np.prod(file_shape))}: "
                  f"bf16 and f32 bit-equal to the plain version, f32 to the file's dequant", flush=True)
    return cases, worst


def resident_lookups(model, run) -> list:
    """The keys of ``model``'s int8-resident weights that one call of
    ``run`` dequantizes, in order, repeats included (a spy on
    QuantResident.dequant)."""
    from vision_tpu_torch.core.quant import QuantResident, is_quant

    names = {id(v): k for k, v in model.params.items() if is_quant(v)}
    seen, real = [], QuantResident.dequant

    def spy(self):
        seen.append(names[id(self)])
        return real(self)

    QuantResident.dequant = spy
    try:
        run()
    finally:
        QuantResident.dequant = real
    return seen


def cpu_lookups(torch, path: str) -> dict:
    """One forward's resident lookups of the resident model of ``path``
    loaded on the CPU (f32): per run (forward, or SAM's encode and decode),
    the keys in order."""
    from vision_tpu_torch import load_model
    from vision_tpu_torch.core.device import BuildFlag, backend_init

    cpu = backend_init("cpu")
    model = load_model(path, cpu.with_flags(cpu.flags | BuildFlag.keep_quantized))
    rng = np.random.default_rng(34)
    if not hasattr(model, "graphs"):  # MobileSAM: the encoder and the decoder
        x = torch.from_numpy(rng.integers(0, 256, (1, 1024, 1024, 3), np.uint8))
        coords = np.array([[[500.0, 400.0], [0.0, 0.0]]], np.float32)
        emb = []
        encode = resident_lookups(model, lambda: emb.append(model.encode_u8(x)))
        return {"encode": encode, "decode": resident_lookups(model, lambda: model.decode(emb[0], coords, "point"))}
    family = {"DepthAnythingModel": "depthany", "BirefnetModel": "birefnet", "MiganModel": "migan",
              "Yolov9tModel": "yolov9t"}[type(model).__name__]
    xs = [torch.from_numpy(rng.integers(0, 256, sh, np.uint8)) for sh in LOOKUP_SHAPES[family]]
    return {"forward": resident_lookups(model, lambda: model._forward_u8(*xs))}


def dequant_graph_ms(torch, fn, residents) -> float:
    """The card's time for ``fn`` over ``residents`` (each result dropped at
    once, as in a forward), captured as one CUDA graph and replayed: the
    median of 10 replays by CUDA events."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for r in residents:
            fn(r)
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for r in residents:
            fn(r)
    ms = median_ms(graph.replay, 10, warmup=2)
    del graph
    return ms


def dequant_bound_ms(torch, residents) -> tuple[float, str]:
    """The least time for dequantizing ``residents``: q, the scales and the
    minimums read once and the output written once, over the memory rate;
    one f32 product (and sum) an element over the f32 rate."""
    nbytes = flops = 0
    for r in residents:
        n = r.q.numel()
        nbytes += r.nbytes + n * torch.empty(0, dtype=r.dtype).element_size()
        flops += n * (1 if r.minv is None else 2)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def loaded(torch, load):
    """``load()`` and the device memory it left allocated, in MiB."""
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = load()
    torch.cuda.synchronize()
    return model, (torch.cuda.memory_allocated() - base) / 2**20


def resident_weights_equal(torch, res, exp) -> int:
    """Every weight a resident forward sees (its dequant on the card) against
    the expanded load's tensor, bit for bit. Returns how many."""
    from vision_tpu_torch.core.quant import is_quant

    n = 0
    for k, v in res.params.items():
        if is_quant(v):
            w = v.dequant()
            if not (w.is_contiguous() and same_bits(torch, w, exp.params[k])):
                raise AssertionError(f"resident weight {k} {tuple(v.shape)} permute {v.permute}: its dequant differs "
                                     f"from the expanded load's")
            n += 1
        elif not torch.equal(v, exp.params[k]):
            raise AssertionError(f"weight {k} differs between the resident and the expanded load")
    return n


def residency_case(torch, card: str, family: str, label: str, path: str, lookups: dict, counts) -> dict:
    """One quantized GGUF loaded on the card expanded and int8-resident:
    store bytes, allocated MiB, every resident weight against the expanded
    one, the forward (a graph replay at its server's batch; SAM's encode_u8
    and decode, eager) resident against expanded, bit for bit, with the
    hand-written launches of each and the dequant launches against the CPU's
    count of lookups, the replay or eager ms and the graph pool's MiB."""
    from vision_tpu_torch import load_model
    from vision_tpu_torch.core.device import BuildFlag, backend_init
    from vision_tpu_torch.core.quant import is_quant, store_nbytes

    gpu = backend_init("gpu")
    exp, exp_mib = loaded(torch, lambda: load_model(path, gpu))
    res, res_mib = loaded(torch, lambda: load_model(path, gpu.with_flags(gpu.flags | BuildFlag.keep_quantized)))
    n_res = sum(is_quant(v) for v in res.params.values())
    b_res, b_exp = store_nbytes(res.params), store_nbytes(exp.params)
    if not (n_res > 0 and b_res < b_exp and not any(is_quant(v) for v in exp.params.values())):
        raise AssertionError(f"{label}: {n_res} residents, store {b_res} B resident against {b_exp} B expanded")
    n_equal = resident_weights_equal(torch, res, exp)
    rng = np.random.default_rng(34)
    row = {"residents": n_res, "store_mb": (b_res / 1e6, b_exp / 1e6), "alloc_mib": (res_mib, exp_mib),
           "weights_equal": n_equal}
    runs = {}
    if family in RESIDENT_GRAPHS:
        batch, shapes = RESIDENT_GRAPHS[family]
        xs = [torch.from_numpy(rng.integers(0, 256, (batch, *sh), np.uint8)).cuda() for sh in shapes]
        if family == "migan":
            xs[1] = (xs[1] > 180).to(torch.uint8) * 255
        runs["forward"] = {m: (lambda m=m: m.forward_u8(*xs)) for m in (res, exp)}
        for m in (res, exp):
            m.forward_u8(*xs)  # the eager warm-up and the capture
    else:
        x = torch.from_numpy(rng.integers(0, 256, (1, 1024, 1024, 3), np.uint8)).cuda()
        coords = np.array([[[500.0, 400.0], [0.0, 0.0]]], np.float32)
        emb = exp.encode_u8(x)
        runs["encode"] = {m: (lambda m=m: m.encode_u8(x)) for m in (res, exp)}
        runs["decode"] = {m: (lambda m=m: tuple(m.decode(emb, coords, "point"))) for m in (res, exp)}
    for name, fns in runs.items():
        outs, launched = {}, {}
        for m, fn in fns.items():
            torch.cuda.synchronize()
            zero_counts()
            out = fn()
            torch.cuda.synchronize()
            outs[m], launched[m] = out if isinstance(out, tuple) else (out,), counts()
        hand_res = {k: v for k, v in launched[res].items() if k != "dequant" and v}
        hand_exp = {k: v for k, v in launched[exp].items() if k != "dequant" and v}
        want = len(lookups[name])
        fixed = RESIDENT_LAUNCHES.get(family, {}).get(name) if label.endswith("q8_0") else None
        if fixed is not None and want != fixed:
            raise AssertionError(f"{label} {name}: the CPU's forward looks up {want} residents, not {fixed}")
        if hand_res != hand_exp or launched[exp].get("dequant", 0) != 0 or launched[res].get("dequant", 0) != want:
            raise AssertionError(f"{label} {name}: resident launches {launched[res]}, expanded {launched[exp]}; "
                                 f"expected the same hand-written launches and {want} dequant launches (the CPU "
                                 f"run's resident lookups) resident, none expanded")
        if not all(same_bits(torch, a, b) if a.is_floating_point() else torch.equal(a, b)
                   for a, b in zip(outs[res], outs[exp])):
            diff = max(float((a.float() - b.float()).abs().max()) for a, b in zip(outs[res], outs[exp]))
            raise AssertionError(f"{label} {name}: the resident output differs from the expanded one (max abs "
                                 f"{diff})")
        ms = {m: median_ms(fn, 10, warmup=1) for m, fn in fns.items()}
        row[name] = {"dequant_launches": want, "hand_written": hand_res, "ms": (ms[res], ms[exp])}
    if family in RESIDENT_GRAPHS:
        row["pool_mib"] = (pool_mib(torch, res.graphs.pool), pool_mib(torch, exp.graphs.pool))
    else:  # eager: what one dequant costs the caller, host work and launch included
        rs = [res.params[k] for k in lookups["decode"]]
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for r in rs:
                r.dequant()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) / len(rs) * 1e6)
        row["eager_dequant_us"] = float(np.median(walls))
        for name, fns in runs.items():  # where the eager runs spend the difference: host or device
            for m, fn in fns.items():
                kind = "resident" if m is res else "expanded"
                prof = profile_run(fn, f"{label} {kind} {name} (eager)", torch, card, names=("dequant", "window"))
                row[name][f"busy_ms_{kind}"] = prof["busy_ms"]
    parts = [f"{n}: {r['ms'][0]:.3f} ms resident, {r['ms'][1]:.3f} ms expanded"
             + (f" (device busy {r['busy_ms_resident']:.3f} and {r['busy_ms_expanded']:.3f} ms)"
                if "busy_ms_resident" in r else "")
             + f", {r['dequant_launches']} dequant launches, hand-written {r['hand_written']}"
             for n, r in row.items() if isinstance(r, dict)]
    pool = (f"; graph pool {row['pool_mib'][0]:.1f} MiB resident, {row['pool_mib'][1]:.1f} MiB expanded"
            if "pool_mib" in row else f"; an eager dequant {row['eager_dequant_us']:.1f} µs a call (host clock, the "
            f"decode's {len(lookups['decode'])} in turn)")
    print(f"{label}: {n_res} residents; store {row['store_mb'][0]:.1f} MB resident, {row['store_mb'][1]:.1f} MB "
          f"expanded ({b_res / b_exp:.3f}x); allocated after load {res_mib:.1f} MiB resident, {exp_mib:.1f} MiB "
          f"expanded; {n_equal} resident weights bit-equal to the expanded ones; "
          f"{'; '.join(parts)}{pool}; outputs bit-equal [{card}]", flush=True)
    row["models"] = (res, exp)
    return row


def residency_phase(torch, card: str, fd: dict, tmp: str) -> dict:
    """Phase 34: Q8_0 copies (requantize_gguf) of phase 27's Depth-Anything,
    MobileSAM, BiRefNet, MI-GAN and YOLOv9t GGUFs (MI-GAN's and YOLOv9t's
    stored cwhn first), and Q4_1 and IQ4_NL copies of Depth-Anything, each
    loaded on the card expanded and int8-resident (residency_case); the
    resident Depth-Anything serves 8 requests through ImageServer against
    the expanded one; one BiRefNet forward's dequants timed as a graph,
    kernel and plain. Returns the copies' paths, the rows and the kernel's
    figures."""
    from vision_tpu_torch.core.gguf import requantize_gguf
    from vision_tpu_torch.ops.cuda import dequant as dqm

    def counts():
        out = dict(fd["counts"]())
        out["dequant"] = dqm.launches
        return out

    gc.collect()
    torch.cuda.empty_cache()
    copies, rows = {}, {}
    for family in RESIDENT_FAMILIES:
        src = fd["paths"][family]
        if family in RESIDENT_CWHN:
            cwhn_gguf(src, os.path.join(tmp, f"{family}-cwhn.gguf"))
            src = os.path.join(tmp, f"{family}-cwhn.gguf")
        for ftype in ("q8_0",) + (DEPTH_QUANT_EXTRA if family == "depthany" else ()):
            t0 = time.perf_counter()
            copies[(family, ftype)] = str(requantize_gguf(src, os.path.join(tmp, f"{family}-{ftype}.gguf"), ftype))
            print(f"{family} {ftype} copy written by requantize_gguf in {time.perf_counter() - t0:.1f} s "
                  f"({os.path.getsize(copies[(family, ftype)]) / 1e6:.1f} MB, from {os.path.getsize(src) / 1e6:.1f} "
                  f"MB)", flush=True)
    served = biref = None
    for (family, ftype), path in copies.items():
        t0 = time.perf_counter()
        lookups = cpu_lookups(torch, path)
        print(f"{family} {ftype}: the CPU's resident forward looks up "
              f"{', '.join(f'{len(v)} resident weights a {k}' for k, v in lookups.items())} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        row = residency_case(torch, card, family, f"{family} {ftype}", path, lookups, counts)
        res, exp = row.pop("models")
        rows[(family, ftype)] = row
        if family == "birefnet":
            biref = [res.params[k] for k in lookups["forward"]]
        if (family, ftype) == ("depthany", "q8_0"):
            served = serve_resident_depth(torch, card, res, exp, len(lookups["forward"]), counts)
        del res, exp
        gc.collect()
        torch.cuda.empty_cache()
    kernel_ms = dequant_graph_ms(torch, lambda r: r.dequant(), biref)
    plain_ms = dequant_graph_ms(torch, lambda r: dqm.dequant_plain(r.q, r.scale, r.minv, r.file_shape, r.permute,
                                                                    r.dtype), biref)
    bound, by = dequant_bound_ms(torch, biref)
    print(f"dequant: one BiRefNet (SWIN-L) resident forward's {len(biref)} dequants as one graph: kernel "
          f"{kernel_ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound:.3f} ms ({by}; "
          f"{kernel_ms / bound:.2f}x the bound) [{card}]", flush=True)
    del biref
    gc.collect()
    torch.cuda.empty_cache()
    return {"copies": copies, "rows": rows, "served": served, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by}


def serve_resident_depth(torch, card: str, res, exp, per_forward: int, counts) -> dict:
    """The resident Depth-Anything serves 8 requests (phase 4's extents)
    through ImageServer, then the expanded one the same requests: equal
    results, 12 flash and ``per_forward`` dequant launches a batch."""
    from vision_tpu_torch.image import Image, ImageFormat
    from vision_tpu_torch.serve import ImageServer

    rng = np.random.default_rng(4)
    (w_sq, h_sq), (w_wide, h_wide) = DEPTH_EXTENTS
    requests = [Image(rng.integers(0, 256, (h, w, 4), np.uint8), ImageFormat.rgba_u8)
                for w, h in [(w_sq, h_sq)] * 5 + [(w_wide, h_wide)] * 3]
    out = {}
    for label, model in (("resident", res), ("expanded", exp)):
        with ImageServer(model, batch_size=4, max_delay_ms=20) as srv:
            srv.warmup()
            srv.warmup((w_wide, h_wide))
            zero_counts()
            t0 = time.perf_counter()
            results = [f.result(timeout=600) for f in [srv.submit(img) for img in requests]]
            wall_s = time.perf_counter() - t0
            launched, stats = counts(), srv.stats
        want = {"flash": 12 * stats.batches, "dequant": per_forward * stats.batches if model is res else 0}
        got = {k: launched.get(k, 0) for k in want}
        if stats.requests != 8 or got != want or any(v for k, v in launched.items() if k not in want):
            raise AssertionError(f"{label} Depth-Anything served {stats.requests} requests in {stats.batches} "
                                 f"batches with launches {launched}; expected {want}")
        out[label] = {"results": results, "p50_ms": stats.p50_latency_ms, "wall_s": wall_s, "launches": got}
    for a, b in zip(out["resident"]["results"], out["expanded"]["results"]):
        if not np.array_equal(a.data, b.data):
            raise AssertionError("the resident Depth-Anything's served depth differs from the expanded one's")
    r, e = out["resident"], out["expanded"]
    print(f"ImageServer 8 Depth-Anything requests (batch 4): resident p50 {r['p50_ms']:.3f} ms, launches "
          f"{r['launches']}; expanded p50 {e['p50_ms']:.3f} ms, launches {e['launches']}; results equal [{card}]",
          flush=True)
    return {"launches": r["launches"]["dequant"], "p50_ms": (r["p50_ms"], e["p50_ms"])}


def quantize_verb_phase(card: str, src: str, in_process: str, tmp: str) -> float:
    """Phase 35: ``python -m vision_tpu_torch.cli quantize -t q8_0 --verify``
    over the Depth-Anything GGUF as a subprocess: exit 0, its per-tensor
    report, and a file equal to the in-process requantize_gguf's."""
    out = os.path.join(tmp, "depthany-verb-q8_0.gguf")
    wall_s, stdout = cli_run(["quantize", "-m", src, "-o", out, "-t", "q8_0", "--verify"], "quantize")
    lines = stdout.splitlines()
    if not (lines[0].startswith("Quantizing to q8_0... done") and any("rel-rms" in ln for ln in lines)
            and lines[-1].startswith(f"-> {out} (")):
        raise AssertionError(f"quantize printed:\n{stdout}")
    with open(out, "rb") as a, open(in_process, "rb") as b:
        if a.read() != b.read():
            raise AssertionError("the quantize verb's file differs from requantize_gguf's")
    worst = next((ln.strip() for ln in lines if ln.strip().startswith("worst rel-rms")), "")
    print(f"CLI quantize -t q8_0 --verify: exit 0 in {wall_s:.2f} s wall; {len(lines) - 2} tensor lines, {worst}; "
          f"file equal to requantize_gguf's [{card}]", flush=True)
    return wall_s


# -- training (phases 36-38): the three recipes of finetune.py at full width --
#
# Real-ESRGAN x4 (the full RRDBNet) on 64^2 HR patches (16^2 LR), batch 4;
# BiRefNet (SWIN-L) on (image, mask) pairs at 256^2, batch 2, augmented;
# Depth-Anything-V2-Base distilled into V2-Small at 252^2, batch 4, with
# rank-8 LoRA over an int8-resident (QLoRA) base. Each on TRAIN_IMAGES PNGs
# of TRAIN_EXTENT (w, h) the run writes.
TRAIN_IMAGES = 8
TRAIN_EXTENT = (300, 270)
TRAIN_LR = 1e-4
TRAIN_STEPS = 2  # the recipe functions' steps
TRAIN_TIMED = 3  # the harness's timed steps, after one warm-up step
ESRGAN_TRAIN = {"batch": 4, "patch": 64}
BIREF_TRAIN = {"batch": 2, "size": 256}
DISTILL_TRAIN = {"batch": 4, "size": 252, "lora_rank": 8}
# an autograd function's gradients against autograd of its kernel's plain
# version on the same CUDA tensors: f32 (TF32 off) differs by the order of
# the sums (the conv's backward is cuDNN's, its plain version's nine
# products); bf16 by one rounding of each gradient to bf16 (~2-4e-3)
GRAD_F32_REL_RMS = 1e-4
GRAD_BF16_REL_RMS = 1e-2
# a recipe's first step on the card (f32, TF32 off) against the port's CPU
# f32 on the same batch: the loss, and each leaf's gradient relative to its
# RMS or to 1% of all the gradients' RMS where that is larger (a leaf whose
# gradient is zero in exact arithmetic, such as attention's key biases,
# holds rounding noise in both). The gradients' bound is wider than the
# losses': a bilinear sample's derivative in its position jumps where the
# position crosses a pixel and a ReLU's at 0, so a value within rounding of
# one takes the other side on the other device, and a bias's gradient sums
# terms that cancel (measured on one H100: BiRefNet's deformable ASPP and
# gates 1.5-3.4e-3, Real-ESRGAN's worst leaf 2.1e-5)
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_REL_RMS = 1e-2
STEP_GRAD_FLOOR = 1e-2
TRAIN_DEVICE = "cuda"  # where phases 36-38 put their tensors (a CPU rehearsal sets "cpu")


def grad_case(label: str, kernel_fn, plain_fn, inputs: dict, dtype, torch, counter=None) -> float:
    """Phase 36, one case: ``kernel_fn`` (the wrapper, whose CUDA route under
    autograd is the kernel's autograd function) and ``plain_fn`` (the
    kernel's plain version), each a function of a dict of leaves, on the
    same CUDA leaves (``inputs``, cloned to require grad): the outputs
    (check_close) and
    each leaf's gradient for one cotangent (relative RMS). ``counter``:
    (module, launches the kernel's forward must add). The bf16 outputs are
    held by relative RMS too (an output of magnitude ~8 has a bf16 ulp of
    0.03, past BF16_MAX_ABS). Returns the worst gradient error."""
    results = []
    for fn in (kernel_fn, plain_fn):
        leaves = {k: v.detach().clone().requires_grad_() for k, v in inputs.items()}
        before = counter[0].launches if counter else 0
        out = fn(leaves)
        if fn is kernel_fn and counter and counter[0].launches - before != counter[1]:
            raise AssertionError(f"{label}: {counter[0].launches - before} kernel launches, not {counter[1]}")
        if fn is kernel_fn and out.grad_fn is None:
            raise AssertionError(f"{label}: the kernel's output has no autograd function")
        gen = torch.Generator(device=TRAIN_DEVICE).manual_seed(36)
        cot = torch.randn(out.shape, generator=gen, device=TRAIN_DEVICE)
        grads = torch.autograd.grad(out, list(leaves.values()), cot.to(out.dtype))
        torch.cuda.synchronize()
        results.append((out.detach(), grads))
    (out, grads), (ref, ref_grads) = results
    bound = GRAD_F32_REL_RMS if dtype == torch.float32 else GRAD_BF16_REL_RMS
    if dtype == torch.float32:
        check_close(f"{label} forward", out, ref.float(), dtype, torch)
    elif not rel_rms_t(out.float(), ref.float()) <= bound:
        raise AssertionError(f"{label} forward: relative RMS {rel_rms_t(out.float(), ref.float())} past {bound}")
    errs = {k: rel_rms_t(g.float(), r.float()) for k, g, r in zip(inputs, grads, ref_grads)}
    bad = {k: e for k, e in errs.items() if not e <= bound}
    print(f"grad {label}: output {rel_rms_t(out.float(), ref.float()):.2e}, "
          + ", ".join(f"d{k} {e:.2e}" for k, e in errs.items())
          + f" [relative RMS <= {bound}] {'FAIL' if bad else 'ok'}", flush=True)
    if bad:
        raise AssertionError(f"{label}: gradients off {bad}")
    return max(errs.values())


def grad_cases(torch) -> dict:
    """Phase 36: each autograd function on the card against autograd of its
    kernel's plain version, at the training path's shapes, in f32 (TF32 off)
    and one bf16 case each: the conv with Real-ESRGAN's epilogues at the
    recipe's 16^2 LR batch of 4 (and its 32^2 / 64^2 tail); SWIN-L's four
    window stages at 256^2, batch 2, unmasked and with the shift mask, the
    per-head bias a leaf; the ASPP's deformable convs at 256^2 (decoder
    extents 8^2 to 64^2, k 1, 3, 7, Cin 112 -> 28) with bias, BatchNorm
    scale and shift and ReLU, the offsets and the mask leaves. Returns the
    worst gradient error of each."""
    from vision_tpu_torch.models.swin import compute_attention_mask
    from vision_tpu_torch.ops.cuda import conv3x3 as cc
    from vision_tpu_torch.ops.cuda import deform_conv as dcm
    from vision_tpu_torch.ops.cuda import window_attention as wa

    gen = torch.Generator(device=TRAIN_DEVICE).manual_seed(36)
    f32, bf16 = torch.float32, torch.bfloat16

    def rnd(*shape, dt=f32, scale=1.0):
        return (torch.randn(*shape, device=TRAIN_DEVICE, generator=gen) * scale).to(dt)

    worst = {"conv3x3": 0.0, "window_attention": 0.0, "deform_conv": 0.0}
    b, lo = ESRGAN_TRAIN["batch"], ESRGAN_TRAIN["patch"] // 4
    conv_forms = [("stem", 3, 64, lo, {}, ())] + [
        (f"conv{k + 1}", ci, co, lo, {"slope": 0.2}, ()) for k, (ci, co) in enumerate(ESRGAN_RDB[:4])] + [
        ("conv5 x + 0.2 y", 192, 64, lo, {"s1": 0.2}, ("r1",)),
        ("RDB3 conv5 r2 + 0.2 (x + 0.2 y)", 192, 64, lo, {"s1": 0.2, "s2": 0.2}, ("r1", "r2")),
        ("trunk + skip", 64, 64, lo, {}, ("r1",)),
        ("upsample", 64, 64, 2 * lo, {"slope": 0.2}, ()), ("upsample, hr", 64, 64, 4 * lo, {"slope": 0.2}, ()),
        ("last", 64, 3, 4 * lo, {}, ())]
    for dt in (f32, bf16):
        for name, ci, co, hw, kw, res in (conv_forms if dt == f32 else conv_forms[6:7]):
            inputs = {"x": rnd(b, hw, hw, ci, dt=dt), "w": rnd(co, ci, 3, 3, dt=dt, scale=0.1),
                      "b": rnd(co, dt=dt, scale=0.1)} | {r: rnd(b, hw, hw, co, dt=dt) for r in res}

            def conv(fn, kw=kw):
                return lambda t: fn(t["x"], t["w"], t["b"], r1=t.get("r1"), r2=t.get("r2"), **kw)

            label = f"conv3x3 {name} ({b}, {hw}, {hw}, {ci} -> {co}) {str(dt).removeprefix('torch.')}"
            worst["conv3x3"] = max(worst["conv3x3"], grad_case(
                label, conv(cc.conv3x3), conv(cc.conv3x3_plain), inputs, dt, torch, (cc, 1)))
    bw, window = BIREF_TRAIN["batch"], 12
    for dt in (f32, bf16):
        for side, heads in (((64, 6), (32, 12), (16, 24), (8, 48)) if dt == f32 else ((64, 6),)):
            padded = -(-side // window) * window
            nw, t, c = bw * (padded // window) ** 2, window * window, 32 * heads
            for masked in ((False, True) if dt == f32 else (True,)):
                inputs = {"q": rnd(nw, t, c, dt=dt), "k": rnd(nw, t, c, dt=dt), "v": rnd(nw, t, c, dt=dt),
                          "bias": rnd(heads, t, t, dt=dt)}
                mask = torch.tensor(compute_attention_mask(side, side, window), device=TRAIN_DEVICE) if masked else None

                def attn(fn, heads=heads, mask=mask):
                    return lambda tt: fn(tt["q"], tt["k"], tt["v"], tt["bias"], heads, 32**-0.5, mask)

                label = (f"window_attention SWIN-L {side}^2 ({nw}, {t}, {c}) {'masked' if masked else 'unmasked'} "
                         f"{str(dt).removeprefix('torch.')}")
                worst["window_attention"] = max(worst["window_attention"], grad_case(
                    label, attn(wa.window_attention), attn(wa.window_attention_plain), inputs, dt, torch, (wa, 1)))
    for dt in (f32, bf16):
        for hw, k in ([(hw, k) for hw in (8, 16, 32, 64) for k in (1, 3, 7)] if dt == f32 else [(64, 7)]):
            x, off, mask, pad = deform_inputs(gen, torch, bw, hw, BIREF_CIN, k, dt)
            inputs = {"x": x, "w": rnd(BIREF_COUT, BIREF_CIN, k, k, dt=dt, scale=0.05), "offset": off, "mask": mask,
                      "bias": rnd(BIREF_COUT, dt=dt, scale=0.1), "scale": rnd(BIREF_COUT, dt=dt),
                      "shift": rnd(BIREF_COUT, dt=dt, scale=0.1)}

            def deform(fn, k=k, pad=pad):
                return lambda t: fn(t["x"], t["w"], t["offset"], t["mask"], k, k, 1, pad, bias=t["bias"],
                                    scale=t["scale"], shift=t["shift"], relu=True)

            label = (f"deform_conv ({bw}, {hw}, {hw}, {BIREF_CIN} -> {BIREF_COUT}) k={k} "
                     f"{str(dt).removeprefix('torch.')}")
            worst["deform_conv"] = max(worst["deform_conv"], grad_case(
                label, deform(dcm.deform_conv), deform(dcm.deform_conv_plain), inputs, dt, torch, (dcm, 1)))
    return worst


def write_depth_base_gguf(path: str) -> None:
    """Depth-Anything-V2-Base (DINOv2-B: 768 wide, 12 heads, 12 layers; the
    DPT head at 128) with random weights, seed 1: the distillation's
    teacher."""
    from vision_tpu_torch.core.gguf import GGUFWriter
    from vision_tpu_torch.models.random_weights import random_depth_anything_params

    w = GGUFWriter(path, "depthanything")
    for k, v in (("dino.patch_size", 14), ("dino.embed_dim", 768), ("dino.n_heads", 12), ("dino.n_layers", 12),
                 ("depthanything.image_size", 518), ("depthanything.feature_layers", [2, 5, 8, 11]),
                 ("depthanything.tensor_data_layout", "torch")):
        w.add(k, v)
    for name, a in random_depth_anything_params("base", seed=1).items():
        w.add_tensor(name, a)
    w.write()


def train_folder(tmp: str) -> tuple[list, str]:
    """TRAIN_IMAGES random PNGs of TRAIN_EXTENT and a same-stem mask for
    each (0 / 255), in ``tmp``: (image paths, mask directory)."""
    from vision_tpu_torch.image import Image, ImageFormat, image_save

    rng = np.random.default_rng(36)
    w, h = TRAIN_EXTENT
    os.makedirs(os.path.join(tmp, "train"), exist_ok=True)
    os.makedirs(os.path.join(tmp, "masks"), exist_ok=True)
    paths = []
    for i in range(TRAIN_IMAGES):
        paths.append(os.path.join(tmp, "train", f"im{i}.png"))
        image_save(Image(rng.integers(0, 256, (h, w, 3), np.uint8), ImageFormat.rgb_u8), paths[-1])
        mask = ((rng.random((h, w, 1)) > 0.5) * 255).astype(np.uint8)
        image_save(Image(mask, ImageFormat.alpha_u8), os.path.join(tmp, "masks", f"im{i}.png"))
    return paths, os.path.join(tmp, "masks")


def _to(batch, device):
    if isinstance(batch, (tuple, list)):
        return type(batch)(_to(b, device) for b in batch)
    return batch.to(device) if hasattr(batch, "to") else batch


def first_step_check(torch, label: str, loss_fn, card_params: dict, cpu_params: dict, names, batch) -> dict:
    """Phase 37: the first step's loss and each trainable leaf's gradient on
    the card (f32, the kernels' autograd functions) against the port's CPU
    f32 (the plain versions) on the same batch. Returns each leaf's max
    gradient magnitude on the CPU (0: a leaf the step does not move)."""
    out = []
    for params, b in ((card_params, batch), (cpu_params, _to(batch, "cpu"))):
        leaves = [params[k] for k in names]
        loss = loss_fn(params, b)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        out.append((float(loss.detach()), [torch.zeros_like(p) if g is None else g.float().cpu()
                                           for p, g in zip(leaves, grads)]))
    (loss, grads), (ref_loss, ref_grads) = out
    overall = float(torch.cat([g.flatten().double() for g in ref_grads]).pow(2).mean().sqrt())
    errs = {k: float((g.double() - r.double()).pow(2).mean().sqrt()
                     / max(float(r.double().pow(2).mean().sqrt()), STEP_GRAD_FLOOR * overall))
            for k, g, r in zip(names, grads, ref_grads)}
    worst = sorted(errs, key=errs.get, reverse=True)[:3]
    bad = [k for k in names if not errs[k] <= STEP_GRAD_REL_RMS]
    ok = abs(loss - ref_loss) <= STEP_LOSS_RTOL * abs(ref_loss) and not bad
    print(f"{label} first step, card f32 vs CPU f32 on one batch: loss {loss:.7f} / {ref_loss:.7f} "
          f"[rtol {STEP_LOSS_RTOL}]; {len(names)} leaves, worst gradients "
          + ", ".join(f"{errs[k]:.2e} ({k})" for k in worst)
          + f" [relative RMS <= {STEP_GRAD_REL_RMS}, floor {STEP_GRAD_FLOOR} of all] "
          f"{'ok' if ok else 'FAIL ' + str(bad[:5])}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: first step off the CPU's")
    return {k: float(r.abs().max()) for k, r in zip(names, ref_grads)}


def train_harness(torch, card: str, label: str, host: dict, trainable, loss_fn, batches: list, per_step: dict,
                  counts, kernels: tuple, tmp: str) -> dict:
    """Phases 37-38 for one recipe, through the train module as the recipe
    drives it: the first step against the CPU; a warm-up step whose launches
    equal ``per_step`` (every other counter 0); TRAIN_TIMED steps timed on
    the host clock (each ending in a synchronize) with the peak memory; the
    trainable leaves moved (every one with a nonzero first gradient) and the
    frozen int8 residents bit-unchanged; a checkpoint restored into a fresh
    state bit-equal; and profiles of one step and of one forward (the
    hand-written ``kernels``' device ms in each). Returns the readings."""
    from vision_tpu_torch.core.quant import is_quant
    from vision_tpu_torch.core.weights import params_from_numpy
    from vision_tpu_torch.train import adam, create_train_state, make_train_step, restore_checkpoint
    from vision_tpu_torch.train import save_checkpoint

    held = torch.cuda.memory_allocated() / 2**20  # what the run holds before this recipe's state
    state = create_train_state(params_from_numpy(host, TRAIN_DEVICE, torch.float32), adam(TRAIN_LR),
                               trainable=trainable)
    cpu = create_train_state(params_from_numpy(host, "cpu", torch.float32), adam(TRAIN_LR), trainable=trainable)
    step = make_train_step(loss_fn)
    first = first_step_check(torch, label, loss_fn, state.params, cpu.params, state.names, batches[0])
    del cpu
    gc.collect()
    initial = {k: state.params[k].detach().clone() for k in state.names}
    residents = {k: (v.q.clone(), v.scale.clone()) for k, v in state.params.items() if is_quant(v)}
    zero_counts()
    before = counts()
    state, metrics = step(state, batches[0])
    torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in counts().items()}
    want = {k: per_step.get(k, 0) for k in launches}
    print(f"{label} one step: loss {float(metrics['loss']):.6f}, hand-written launches {launches} "
          f"[{'ok' if launches == want else 'FAIL: want ' + str(want)}]", flush=True)
    if launches != want or not np.isfinite(float(metrics["loss"])):
        raise AssertionError(f"{label}: a step launched {launches}, want {want}; loss {float(metrics['loss'])}")
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(TRAIN_TIMED):
        t0 = time.perf_counter()
        state, metrics = step(state, batches[(i + 1) % len(batches)])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**20
    moved = [k for k in state.names if not torch.equal(state.params[k], initial[k])]
    still = [k for k in state.names if k not in moved and first[k] > 0]
    frozen = all(torch.equal(state.params[k].q, q) and torch.equal(state.params[k].scale, s)
                 for k, (q, s) in residents.items())
    print(f"{label}: {len(moved)} of {len(state.names)} trainable leaves moved in {TRAIN_TIMED + 1} steps "
          f"({len(state.names) - len(moved)} with a zero first gradient stay), {len(residents)} int8 residents "
          f"{'bit-unchanged' if frozen else 'CHANGED'}; step ms {', '.join(f'{t:.3f}' for t in times)} "
          f"(median {float(np.median(times)):.3f}), peak allocated {peak:.1f} MiB, {peak - held:.1f} MiB above the "
          f"{held:.1f} MiB held before the recipe's state [{card}]", flush=True)
    if still or not frozen or not moved:
        raise AssertionError(f"{label}: leaves with a gradient did not move {still[:5]} or residents changed")
    path = save_checkpoint(os.path.join(tmp, f"ckpt-{label.split()[0]}", f"step_{state.step}"), state)
    fresh = create_train_state(params_from_numpy(host, TRAIN_DEVICE, torch.float32), adam(TRAIN_LR),
                               trainable=trainable)
    restore_checkpoint(path, fresh)
    saved, back = state.optimizer.state_dict(), fresh.optimizer.state_dict()
    equal = fresh.step == state.step and all(
        torch.equal(v, fresh.params[k]) for k, v in state.params.items() if isinstance(v, torch.Tensor)) and all(
        torch.equal(torch.as_tensor(v).cpu(), torch.as_tensor(back["state"][i][key]).cpu())
        for i, st in saved["state"].items() for key, v in st.items())
    print(f"{label}: checkpoint at step {state.step} ({os.path.getsize(os.path.join(path, 'state.pt')) / 2**20:.1f} "
          f"MiB) restored into a fresh state {'bit-equal' if equal else 'DIFFERENT'}", flush=True)
    if not equal:
        raise AssertionError(f"{label}: the restored checkpoint differs from the state saved")
    del fresh
    gc.collect()
    prof_step = profile_run(lambda: step(state, batches[0]), f"{label} train step", torch, card, kernels)
    prof_fwd = profile_run(lambda: loss_fn(state.params, batches[0]), f"{label} forward (loss)", torch, card, kernels)
    hand = sum(prof_step["named_ms"].values())
    print(f"{label}: step busy {prof_step['busy_ms']:.3f} ms, forward busy {prof_fwd['busy_ms']:.3f} ms "
          f"({prof_fwd['busy_ms'] / prof_step['busy_ms']:.2%} of the step; backward and update "
          f"{1 - prof_fwd['busy_ms'] / prof_step['busy_ms']:.2%}); hand-written kernels {hand:.3f} ms, "
          f"{hand / prof_step['busy_ms']:.2%} of the step's busy time and {hand / prof_fwd['busy_ms']:.2%} of the "
          f"forward's [{card}]", flush=True)
    result = {"step_ms": float(np.median(times)), "steps_ms": times, "peak_mib": peak - held, "launches": launches,
              "step_busy_ms": prof_step["busy_ms"], "forward_busy_ms": prof_fwd["busy_ms"], "kernels_ms": hand,
              "trainable_leaves": len(state.names)}
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return result


def recipe_run(torch, card: str, label: str, run, dst: str, per_step: dict, counts, serve, export=None) -> float:
    """Phase 37: one recipe function end to end (TRAIN_STEPS steps, a
    checkpoint, the export): its launches, TRAIN_STEPS times the harness's
    step's plus ``export``'s (the QLoRA merge dequantizes each resident
    once); a finite loss; the exported GGUF loaded with load_model on the
    card and serving one request (``serve(model)`` -> its output). Returns
    the wall seconds."""
    from vision_tpu_torch.api import load_model
    from vision_tpu_torch.core.device import backend_init

    zero_counts()
    before = counts()
    t0 = time.perf_counter()
    stats = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in counts().items()}
    want = {k: per_step.get(k, 0) * TRAIN_STEPS + (export or {}).get(k, 0) for k in launches}
    model = load_model(dst, backend_init())
    out = np.asarray(serve(model), np.float32)
    ok = (launches == want and stats["steps"] == TRAIN_STEPS and np.isfinite(stats["first_loss"])
          and np.isfinite(stats["last_loss"]) and np.isfinite(out).all())
    print(f"{label} recipe: {TRAIN_STEPS} steps in {wall:.2f} s wall (load, steps, checkpoint, export), loss "
          f"{stats['first_loss']:.6f} -> {stats['last_loss']:.6f}, launches {launches}; {os.path.basename(dst)} "
          f"({os.path.getsize(dst) / 1e6:.1f} MB) loaded with load_model and served one request "
          f"({out.shape}) [{'ok' if ok else 'FAIL'}; {card}]", flush=True)
    if not ok:
        raise AssertionError(f"{label} recipe: launches {launches} (want {want}), stats {stats}")
    del model
    return wall


def training_phases(torch, card: str, fd: dict, tmp: str) -> dict:
    """Phases 36-38: gradients against the plain versions, the three recipes
    at full width, and their timings (see the module docstring)."""
    from vision_tpu_torch import finetune as ft
    from vision_tpu_torch.bulk import pair_masks
    from vision_tpu_torch.core.device import backend_init
    from vision_tpu_torch.core.gguf import GGUFFile
    from vision_tpu_torch.core.params import Params
    from vision_tpu_torch.core.quant import is_quant
    from vision_tpu_torch.core.weights import load_weights, params_from_numpy
    from vision_tpu_torch.image import Image, ImageFormat
    from vision_tpu_torch.models.birefnet import birefnet_detect_params
    from vision_tpu_torch.models.birefnet import fixup_weights as biref_fixup
    from vision_tpu_torch.models.depth_anything import depthany_detect_params, depthany_predict
    from vision_tpu_torch.models.depth_anything import fixup_weights as depth_fixup
    from vision_tpu_torch.models.esrgan import esrgan_detect_params
    from vision_tpu_torch.ops.cuda import dequant as dqm
    from vision_tpu_torch.ops.cuda import window_attention as wa
    from vision_tpu_torch.train import data_loader, prefetch_to_device

    def counts():
        return dict(fd["counts"](), dequant=dqm.launches, **{"window masked": wa.masked_launches})

    gc.collect()
    torch.cuda.empty_cache()
    phase("36 gradients: each kernel's autograd function against autograd of its plain version on the card")
    t0 = time.perf_counter()
    worst = grad_cases(torch)
    print(f"phase 36 in {time.perf_counter() - t0:.1f} s", flush=True)

    phase(f"37-38 the three recipes at full width on {TRAIN_IMAGES} PNGs of {TRAIN_EXTENT[0]}x{TRAIN_EXTENT[1]}: "
          f"first step vs the CPU, launches, leaves, checkpoint, timings; then the recipe functions and their exports")
    images, masks = train_folder(tmp)
    dev = backend_init()
    rows = {}
    probe = Image(np.random.default_rng(37).integers(0, 256, (TRAIN_EXTENT[1], TRAIN_EXTENT[0], 3), np.uint8),
                  ImageFormat.rgb_u8)

    # Real-ESRGAN: the full RRDBNet on 64^2 patches
    t0 = time.perf_counter()
    efile = GGUFFile(fd["paths"]["esrgan"])
    b, patch = ESRGAN_TRAIN["batch"], ESRGAN_TRAIN["patch"]
    epoch = data_loader(list(enumerate(images)), b, load=ft._patch_load(patch, 37), shuffle=True, seed=37)
    batches = list(prefetch_to_device(epoch, device=TRAIN_DEVICE))
    per = {"conv3x3": ESRGAN_CONVS}
    cases = {"esrgan": (load_weights(efile, as_numpy=True), None, ft.esrgan_loss(esrgan_detect_params(efile), patch),
                        batches, per)}
    rows["esrgan"] = train_harness(torch, card, "Real-ESRGAN", *cases["esrgan"][:4], per, counts, ("conv3x3",), tmp)
    rows["esrgan"]["recipe_s"] = recipe_run(
        torch, card, "Real-ESRGAN", lambda: ft.finetune_esrgan(
            efile, images, os.path.join(tmp, "esrgan-tuned.gguf"), steps=TRAIN_STEPS, lr=TRAIN_LR, batch=b,
            patch=patch, ema_decay=0.999, device=dev, ckpt_dir=os.path.join(tmp, "ck-esrgan"),
            ckpt_every=TRAIN_STEPS),
        os.path.join(tmp, "esrgan-tuned.gguf"), per, counts, lambda m: m.compute(probe).data)
    print(f"Real-ESRGAN phases 37-38 in {time.perf_counter() - t0:.1f} s", flush=True)

    # BiRefNet (SWIN-L) on (image, mask) pairs at 256^2, augmented
    t0 = time.perf_counter()
    bfile = GGUFFile(fd["paths"]["birefnet"])
    b, size = BIREF_TRAIN["batch"], BIREF_TRAIN["size"]
    pairs = pair_masks(images, masks)
    seeds = np.random.default_rng(38)
    epoch = data_loader(pairs, b, load=ft._mask_load(size), shuffle=True, seed=38)
    batches = [(x, m, (int(seeds.integers(2**62)), b), torch.arange(b))
               for x, m in prefetch_to_device(epoch, device=TRAIN_DEVICE)]
    per = {"window": BIREF_WINDOWS, "window masked": BIREF_MASKED, "deform_conv": BIREF_DEFORMS}
    cases["birefnet"] = (biref_fixup(bfile, load_weights(bfile, as_numpy=True)), None,
                         ft.mask_loss(birefnet_detect_params(bfile), True), batches, per)
    rows["birefnet"] = train_harness(torch, card, "BiRefNet", *cases["birefnet"][:4], per, counts,
                                     ("window_attention", "deform_conv"), tmp)
    rows["birefnet"]["recipe_s"] = recipe_run(
        torch, card, "BiRefNet", lambda: ft.finetune_birefnet(
            bfile, images, os.path.join(tmp, "birefnet-tuned.gguf"), masks=masks, steps=TRAIN_STEPS, lr=TRAIN_LR,
            batch=b, size=size, device=dev, ckpt_dir=os.path.join(tmp, "ck-birefnet"), ckpt_every=TRAIN_STEPS),
        os.path.join(tmp, "birefnet-tuned.gguf"), per, counts, lambda m: m.compute(probe).data)
    print(f"BiRefNet phases 37-38 in {time.perf_counter() - t0:.1f} s", flush=True)

    # Depth-Anything-V2-Base -> V2-Small, rank-8 LoRA over an int8-resident base
    t0 = time.perf_counter()
    teacher = os.path.join(tmp, "depth-base.gguf")
    write_depth_base_gguf(teacher)
    tfile, sfile = GGUFFile(teacher), GGUFFile(fd["paths"]["depthany"])
    b, size, rank = DISTILL_TRAIN["batch"], DISTILL_TRAIN["size"], DISTILL_TRAIN["lora_rank"]
    host, trainable = ft._student_params(depth_fixup(sfile, load_weights(sfile, as_numpy=True)), None, rank, True,
                                         0, "distill")
    t_params = params_from_numpy(depth_fixup(tfile, load_weights(tfile, as_numpy=True)), TRAIN_DEVICE, torch.bfloat16)
    tp, sp = depthany_detect_params(tfile), depthany_detect_params(sfile)
    epoch = data_loader(images, b, load=ft._resize_load(size), shuffle=True, seed=39)
    with torch.no_grad():
        batches = [(x, depthany_predict(Params(t_params), x.to(torch.bfloat16), tp))
                   for x in prefetch_to_device(epoch, device=TRAIN_DEVICE)]
    del t_params
    loss = ft.ssi_loss(sp)
    probe_params = params_from_numpy(host, TRAIN_DEVICE, torch.float32)
    before = dqm.launches
    with torch.no_grad():
        loss(probe_params, batches[0])
    per = {"dequant": dqm.launches - before}  # one a resident lookup of the student's forward
    del probe_params
    if per["dequant"] != DISTILL_DEQUANTS:
        raise AssertionError(f"the QLoRA student's forward launched {per['dequant']} dequants, not {DISTILL_DEQUANTS}")
    cases["distill"] = (host, trainable, loss, batches, per)
    rows["distill"] = train_harness(torch, card, "Depth-Anything distill (QLoRA)", host, trainable, loss, batches,
                                    per, counts, ("dequant",), tmp)
    rows["distill"]["recipe_s"] = recipe_run(
        torch, card, "Depth-Anything distill (QLoRA)", lambda: ft.distill_depthany(
            tfile, sfile, images, os.path.join(tmp, "depth-distilled.gguf"), steps=TRAIN_STEPS, lr=TRAIN_LR, batch=b,
            size=size, lora_rank=rank, qlora=True, lora_out=os.path.join(tmp, "depth-adapters.gguf"), device=dev,
            ckpt_dir=os.path.join(tmp, "ck-distill"), ckpt_every=TRAIN_STEPS),
        os.path.join(tmp, "depth-distilled.gguf"), per, counts, lambda m: m.compute(probe).data,
        export={"dequant": sum(is_quant(v) for v in host.values())})
    print(f"Depth-Anything phases 37-38 in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, r in rows.items():
        print(f"training {name}: {r['step_ms']:.3f} ms a step (median of {TRAIN_TIMED}), peak {r['peak_mib']:.1f} "
              f"MiB above the run's earlier holdings, step busy {r['step_busy_ms']:.3f} ms, forward {r['forward_busy_ms']:.3f} ms, hand-written "
              f"kernels {r['kernels_ms']:.3f} ms, {r['launches']} [{card}]", flush=True)
    return {"worst": worst, "rows": rows, "cases": cases, "images": images, "teacher": teacher}


def parent_library(parent: str, build):
    """The kernel library of another checkout of the port at ``parent``,
    built from its vision_tpu_torch/csrc/ with this build's flags into
    build/parent_kernels/; its attention and conv entry points have this
    checkout's signatures, or the conv's the one before the BatchNorm /
    SiLU epilogue (ParentConvEntry) (the BiRefNet A/B runs each checkout's
    forward in its own process)."""
    import ctypes
    from pathlib import Path

    out = build.BUILD_DIR.parent / "parent_kernels"
    out.mkdir(parents=True, exist_ok=True)
    sources = sorted((Path(parent) / "vision_tpu_torch" / "csrc").glob("*.cu"))
    objs = [out / f"{s.stem}.o" for s in sources]
    nvcc = build._nvcc()
    build._run_all([[nvcc, *build.NVCC_FLAGS, "-c", str(s), "-o", str(o)] for s, o in zip(sources, objs)])
    path = out / "libparent.so"
    build._run_all([[nvcc, "-shared", "-o", str(path), *map(str, objs)]])
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vtt_flash_attention_fwd.argtypes = [p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
    lib.vtt_window_attention_fwd.argtypes = [p, p, p, p, p, i, p, i, i, i, i, i, i, ctypes.c_float, p]
    q, f = ctypes.c_longlong, ctypes.c_float
    old_conv = "const void* scale" not in (Path(parent) / "vision_tpu_torch" / "csrc" / "conv3x3.cu").read_text()
    lib.vtt_conv3x3_fwd.argtypes = [p, q, p, p, *([] if old_conv else [p, p]), p, q, p, q, f, p, q, f, i, f,
                                    i, i, i, i, i, i, p]
    lib.vtt_flash_attention_fwd.restype = lib.vtt_window_attention_fwd.restype = lib.vtt_conv3x3_fwd.restype = i
    return ParentConvEntry(lib) if old_conv else lib


# run in a checkout's root with ``python -c``, so that it imports that
# checkout's package: Real-ESRGAN forward_u8 at 512x512 x 4 (random weights,
# seed 0), CUDA events around single forwards and the profiler's busy time;
# the last line is a JSON object
FORWARD_AB = """
import json, time
import numpy as np, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from vision_tpu_torch.core.device import backend_init
from vision_tpu_torch.core.weights import params_from_numpy
from vision_tpu_torch.models import esrgan
from vision_tpu_torch.models.random_weights import random_esrgan_params
model = esrgan.EsrganModel(params_from_numpy(random_esrgan_params(0), "cuda", torch.float32),
                           esrgan.EsrganParams(4, 23), backend_init("gpu"))
x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (4, 512, 512, 3), np.uint8)).to("cuda")
y = model.forward_u8(x, to_u8=False).float()
times = []
for _ in range(3):
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record(); model.forward_u8(x); e.record(); e.synchronize(); times.append(s.elapsed_time(e))
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    model.forward_u8(x); torch.cuda.synchronize()
ks = [k for k in prof.key_averages() if k.device_type == DeviceType.CUDA]
print(json.dumps({"ms": sorted(times)[1], "busy_ms": sum(k.self_device_time_total for k in ks) / 1e3,
                  "launches": sum(k.count for k in ks), "out_rms": float(y.pow(2).mean().sqrt()),
                  "out_sum": float(y.double().sum())}))
"""


# the same for BiRefNet (SWIN-L, random_birefnet_params("large", 0)):
# forward_u8 at 1024x1024 x 4, with the peak memory the forward allocates
FORWARD_BIREF = """
import json
import numpy as np, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from vision_tpu_torch.core.device import backend_init
from vision_tpu_torch.core.weights import params_from_numpy
from vision_tpu_torch.models import birefnet
from vision_tpu_torch.models.random_weights import random_birefnet_params
from vision_tpu_torch.models.swin import SWIN_L_PARAMS
p = birefnet.BirefnetParams(1024, 32, (1024, 1024), SWIN_L_PARAMS)
model = birefnet.BirefnetModel(params_from_numpy(random_birefnet_params("large", 0), "cuda", torch.bfloat16), p,
                               backend_init("gpu"))
x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (4, 1024, 1024, 3), np.uint8)).to("cuda")
y = model.forward_u8(x).float()
torch.cuda.synchronize()
torch.cuda.reset_peak_memory_stats()
base = torch.cuda.memory_allocated()
model.forward_u8(x)
torch.cuda.synchronize()
peak = torch.cuda.max_memory_allocated()
times = []
for _ in range(3):
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record(); model.forward_u8(x); e.record(); e.synchronize(); times.append(s.elapsed_time(e))
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    model.forward_u8(x); torch.cuda.synchronize()
ks = [k for k in prof.key_averages() if k.device_type == DeviceType.CUDA]
busy = sum(k.self_device_time_total for k in ks) / 1e3
deform = sum(k.self_device_time_total for k in ks if "deform" in k.key) / 1e3
print(json.dumps({"ms": sorted(times)[1], "busy_ms": busy, "deform_ms": deform, "launches": sum(k.count for k in ks),
                  "peak_mib": peak / 2**20, "above_mib": (peak - base) / 2**20,
                  "out_mean": float(y.double().mean())}))
"""


def forward_in(checkout: str, script: str = FORWARD_AB) -> dict:
    """``script`` (FORWARD_AB or FORWARD_BIREF) run in ``checkout`` (its
    package, its kernel library)."""
    out = subprocess.run([sys.executable, "-c", script], cwd=checkout, capture_output=True, text=True,
                         timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"forward in {checkout} failed:\n{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def compare_conv_with_parent(libs: dict, torch, card: str) -> None:
    """``--parent DIR``: the conv kernel of the checkout at DIR against this
    checkout's, both through this checkout's wrapper with the path's
    epilogue and views, in turns (parent, this, this, parent) by the card's
    own time, beside F.conv2d (bare) and the bound, at phase 13's shapes;
    each held against the plain version."""
    import torch.nn.functional as F

    from vision_tpu_torch.ops.cuda import build
    from vision_tpu_torch.ops.cuda import conv3x3 as cc

    gen = torch.Generator(device="cuda").manual_seed(14)
    for hw, shapes in ((1024, ESRGAN_RDB), (4096, ESRGAN_TAIL)):
        for ci, co in shapes:
            x, wt, b, kw, res = conv_path_forms(torch, gen, hw, ci, co)
            xc = x.contiguous().permute(0, 3, 1, 2)
            ref = cc.conv3x3_plain(x, wt, b, **{n: v for n, v in kw.items() if n != "out"})
            run = lambda: cc.conv3x3(x, wt, b, **kw)  # noqa: E731
            errs, times = {}, {}
            for name in ("parent", "this", "this", "parent"):
                build._lib = libs[name]
                if name not in errs:
                    errs[name] = float((run().float() - ref.float()).abs().max())
                times.setdefault(name, []).append(device_ms(run))
            build._lib = libs["this"]
            lib_ms = device_ms(lambda: F.conv2d(xc, wt, None, 1, 1))
            bound, by = conv_bound(hw * hw, ci, co, res)
            print(f"A/B conv3x3 (1, {hw}, {hw}, {ci}) -> {co} bf16 with the path's epilogue: parent "
                  f"{'/'.join(f'{t:.4f}' for t in times['parent'])}, this {'/'.join(f'{t:.4f}' for t in times['this'])}"
                  f" ms; F.conv2d {lib_ms:.4f} ms; bound {bound:.4f} ms ({by}); max abs err parent "
                  f"{errs['parent']:.3e}, this {errs['this']:.3e} [{card}]", flush=True)
            if max(errs.values()) > BF16_MAX_ABS:
                raise AssertionError(f"conv3x3 ({hw}, {ci}) -> {co}: max abs err {errs}")
            del x, xc, kw, ref
    torch.cuda.empty_cache()


def compare_with_parent(parent: str, torch, card: str) -> None:
    """``--parent DIR``: the attention kernels of the checkout at DIR against
    this checkout's, both through this checkout's wrappers on the same
    inputs, each held against the plain version, and timed in turns
    (parent, this, this, parent) beside SDPA and the bound: the card's own
    time (device_ms) and CUDA events around single calls (median_ms), at
    the main paths' shapes: flash at the Depth-Anything token counts
    (batch 4), the window kernel at TinyViT's three stages (batch 6) and
    SWIN-L's four, masked (batch 4). Then the conv kernel
    (compare_conv_with_parent), Real-ESRGAN's forward and BiRefNet's
    (forward_in each checkout, in turns: wall, busy and deform time, peak
    memory)."""
    import torch.nn.functional as F

    from vision_tpu_torch.models.swin import compute_attention_mask
    from vision_tpu_torch.ops.cuda import build
    from vision_tpu_torch.ops.cuda import flash_attention as fa
    from vision_tpu_torch.ops.cuda import window_attention as wa

    libs = {"this": build.load_library(), "parent": parent_library(parent, build)}
    gen = torch.Generator(device="cuda").manual_seed(13)
    cases = []
    for t in (depth_tokens(e) for e in DEPTH_EXTENTS):
        q, k, v = (torch.randn(4, 6, t, 64, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(3))
        cases.append((f"flash_attention (24, {t}, 64) bf16",
                      lambda q=q, k=k, v=v: fa.flash_attention(q, k, v),
                      lambda q=q, k=k, v=v: fa.flash_attention_plain(q, k, v, 0.125),
                      lambda q=q, k=k, v=v: F.scaled_dot_product_attention(q, k, v),
                      bound_ms(4.0 * 24 * t * t * 64, 4 * 2.0 * 24 * t * 64)))
    stages = [(f"TinyViT stage {i + 1}", 6 * nw, t, h, None) for i, (nw, t, h) in enumerate(SAM_STAGES)]
    stages += [(f"SWIN-L stage {i + 1} masked", None, side, h, 12) for i, (side, h) in enumerate(SWIN_L_STAGES)]
    for label, nw, t, h, window in stages:
        if window:
            q, k, v, bias, mask = swin_windows(torch, gen, t, window, h, 4, torch.bfloat16)
            nw, t = q.shape[:2]
            combined = (bias.float()[None] + mask.repeat(nw // mask.shape[0], 1, 1)[:, None]).to(torch.bfloat16)
            mask_bytes = 4.0 * mask.numel()
        else:
            q, k, v = (torch.randn(nw, t, h * 32, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(3))
            bias = combined = (torch.randn(h, t, t, device="cuda", generator=gen) * 0.5).to(torch.bfloat16)
            mask, mask_bytes = None, 0.0
        q4, k4, v4 = (z.view(nw, t, h, 32).transpose(1, 2).contiguous() for z in (q, k, v))
        cases.append((f"window_attention {label} (NW={nw}, T={t}, H={h}, hd=32) bf16",
                      lambda q=q, k=k, v=v, b=bias, h=h, m=mask: wa.window_attention(q, k, v, b, h, 32**-0.5, m),
                      lambda q=q, k=k, v=v, b=bias, h=h, m=mask: wa.window_attention_plain(q, k, v, b, h, 32**-0.5, m),
                      lambda q=q4, k=k4, v=v4, c=combined: F.scaled_dot_product_attention(q, k, v, attn_mask=c),
                      bound_ms(4.0 * nw * h * t * t * 32, 4 * 2.0 * nw * t * h * 32 + 2.0 * h * t * t + mask_bytes)))
    for label, run, plain, sdpa, (bound, by) in cases:
        ref = plain().float()
        errs = {}
        for name, lib in libs.items():
            build._lib = lib
            errs[name] = float((run().float() - ref).abs().max())
        times = {}
        for timer in (device_ms, median_ms):
            for name in ("parent", "this", "this", "parent"):
                build._lib = libs[name]
                times.setdefault((timer, name), []).append(timer(run, 20))
            times[(timer, "SDPA")] = [timer(sdpa, 20) for _ in range(2)]
        build._lib = libs["this"]
        line = "; ".join(
            f"{what} parent {'/'.join(f'{x:.4f}' for x in times[(timer, 'parent')])}, this "
            f"{'/'.join(f'{x:.4f}' for x in times[(timer, 'this')])}, SDPA "
            f"{'/'.join(f'{x:.4f}' for x in times[(timer, 'SDPA')])} ms"
            for timer, what in ((device_ms, "device"), (median_ms, "per call (events)")))
        print(f"A/B {label}: {line}; bound {bound:.4f} ms ({by}); max abs err parent {errs['parent']:.3e}, this "
              f"{errs['this']:.3e} [{card}]", flush=True)
        if max(errs.values()) > BF16_MAX_ABS:
            raise AssertionError(f"{label}: max abs err {errs}")
    build._lib = libs["this"]
    compare_conv_with_parent(libs, torch, card)
    # Real-ESRGAN forward_u8, each checkout in its own process, in turns
    here = os.path.dirname(os.path.abspath(__file__))
    runs = {}
    for name, where in (("parent", parent), ("this", here), ("this", here), ("parent", parent)):
        runs.setdefault(name, []).append(forward_in(where))
    print("A/B Real-ESRGAN forward_u8 (4, 512, 512) bf16: " + "; ".join(
        f"{name} " + ", ".join(f"{r['ms']:.3f} ms (busy {r['busy_ms']:.3f} ms, {r['launches']} launches)" for r in rs)
        for name, rs in runs.items()) + f"; output RMS parent {runs['parent'][0]['out_rms']:.6e}, this "
        f"{runs['this'][0]['out_rms']:.6e} [{card}]", flush=True)
    # BiRefNet forward_u8, each checkout in its own process, in turns
    runs = {}
    for name, where in (("parent", parent), ("this", here), ("this", here), ("parent", parent)):
        runs.setdefault(name, []).append(forward_in(where, FORWARD_BIREF))
    print("A/B BiRefNet forward_u8 (4, 1024, 1024) bf16: " + "; ".join(
        f"{name} " + ", ".join(f"{r['ms']:.3f} ms (busy {r['busy_ms']:.3f} ms, deform {r['deform_ms']:.3f} ms, "
                               f"{r['launches']} launches, peak {r['peak_mib']:.1f} MiB, {r['above_mib']:.1f} MiB "
                               f"above the weights and input)" for r in rs)
        for name, rs in runs.items()) + f"; mask mean parent {runs['parent'][0]['out_mean']:.6e}, this "
        f"{runs['this'][0]['out_mean']:.6e} [{card}]", flush=True)
    saved = min(r["peak_mib"] for r in runs["parent"]) - max(r["peak_mib"] for r in runs["this"])
    print(f"A/B BiRefNet peak memory: this checkout allocates {saved:.1f} MiB less at peak [{card}]", flush=True)


# ---------------------------------------------------------------------------
# phases 39-42: the kernels as vtt operators, export bundles, the C ABI,
# flops, profiles and dumps

# the vtt operators of each kernel, as the kernels line names them
KERNEL_OPS = {"flash_attention": ["vtt::flash_attention"], "window_attention": ["vtt::window_attention"],
              "conv3x3": ["vtt::conv3x3", "vtt::conv3x3_out"], "deform_conv": ["vtt::deform_conv", "vtt::deform_conv_out"],
              "deform_sample": ["vtt::deform_sample"], "dequant": ["vtt::dequant"]}
DISPATCH_CALLS = 2000  # host-timed calls of a small conv, through the operator and straight to its launch
# phase 40's bundles: family -> (batch, extent or None); BiRefNet and SAM3 program-only
EXPORT_CASES = {"depthany": (4, (518, 518)), "sam": (6, None), "birefnet": (4, (1024, 1024)),
                "esrgan": (4, (256, 256)), "migan": (MIGAN_BATCH, None), "yolov9t": (YOLO_BATCH, None),
                "sam3": (1, None)}
EXPORT_PROGRAM_ONLY = ("birefnet", "sam3")
EXPORT_STEADY_CALLS = 3
# the CPU-exported bundle served on the card against the CPU's f32 forward:
# the f32 kernel against the plain version, summation order only
EXPORT_CPU_F32_REL_RMS = 1e-4
H100_BF16_TFLOPS = 989.0  # dense bf16 peak of an H100 SXM at 700 W (NVIDIA's data sheet)
CAPI_EXTENT = (320, 240)
CAPI_ARGS = {"sam": [160, 120], "yolov9t": [250, 450]}  # SAM's point; YOLOv9t's thresholds in permille

EXPORT_LOADER = r"""
import fcntl, json, os, sys, time
import torch
from vision_tpu_torch.export import load_bundle
from vision_tpu_torch.ops.cuda import conv3x3, deform_conv, deform_sample, dequant, flash_attention, window_attention

MODS = {"flash": flash_attention, "window": window_attention, "conv3x3": conv3x3, "deform_conv": deform_conv,
        "deform_sample": deform_sample, "dequant": dequant}

def counts():
    return dict({k: m.launches for k, m in MODS.items()}, **{"window masked": window_attention.masked_launches})

def zero():
    for m in MODS.values():
        m.launches = 0
    window_attention.masked_launches = 0

out = []
bundles = {}
calls = []
for item in json.load(open(sys.argv[1])):
    key = (item["bundle"], item["device"])
    t0 = time.perf_counter()
    if key not in bundles:
        bundles[key] = load_bundle(item["bundle"], item["device"])
    load_s = time.perf_counter() - t0
    b = bundles[key]
    args = [a.cuda() for a in torch.load(item["inputs"])]
    if item["params"]:
        args = [torch.load(item["params"], map_location="cuda")] + args
    torch.cuda.synchronize()
    zero()
    t0 = time.perf_counter()
    y = b.call(item["entry"], *args)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = counts()
    torch.save(torch.utils._pytree.tree_map(lambda t: t.cpu(), y), item["out"])
    calls.append((b, item, args))
    out.append({"name": item["name"], "load_s": load_s, "first_ms": first_ms,
                "launches": {k: v for k, v in launches.items() if v}})
# the steady calls once every loader's first calls are done (a ready file each), then one loader at a time
# (a lock file): the card is not shared while they are timed
open(sys.argv[1] + ".ready", "w").close()
others, deadline = sys.argv[3].split(","), time.time() + 600  # a loader that failed never gets ready
while sum(os.path.exists(p + ".ready") for p in others) < len(others) and time.time() < deadline:
    time.sleep(0.05)
with open(sys.argv[2], "a") as lock:
    fcntl.flock(lock, fcntl.LOCK_EX)
    for (b, item, args), row in zip(calls, out):
        times = []
        for _ in range(item["steady"]):
            t0 = time.perf_counter()
            b.call(item["entry"], *args)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        row["steady_ms"] = sorted(times)[len(times) // 2]
    fcntl.flock(lock, fcntl.LOCK_UN)
mods = sorted(m for m in sys.modules if m.split(".")[0] in ("vision_tpu_torch", "vision_tpu", "jax", "jaxlib"))
print(json.dumps({"entries": out, "modules": mods}))
"""

EXPORT_WRITER = r"""
import json, sys, time
import torch
from vision_tpu_torch.api import load_model
from vision_tpu_torch.core.device import BuildFlag, backend_init
from vision_tpu_torch.export import export_model

job = json.loads(sys.argv[1])
dev = backend_init(job["device"])
flags = dev.flags | BuildFlag.flash_attention  # the card's routes, on the CPU too
if job["keep_quantized"]:
    flags |= BuildFlag.keep_quantized
model = load_model(job["gguf"], dev.with_flags(flags))
t0 = time.perf_counter()
entries = export_model(model, job["dst"], extent=job["extent"] and tuple(job["extent"]), batch=job["batch"],
                       embed_params=not job["program_only"])
export_s = time.perf_counter() - t0
if job["program_only"]:
    torch.save({k: v.cpu() for k, v in model.params.items()}, job["params"])
print(json.dumps({"entries": entries, "export_s": export_s}))
"""

CAPI_PROGRAM = r"""
#include <stdio.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
typedef struct { int32_t width, height, stride, format; void* data; } view;
extern const char* visp_get_last_error(void);
extern int32_t visp_init(const char* dir);
extern int32_t visp_device_init(int32_t type, void** out);
extern int32_t visp_device_type(const void*);
extern int32_t visp_model_detect_family(const char*, int32_t*);
extern int32_t visp_model_load(const char*, const void*, int32_t, void**);
extern int32_t visp_model_compute(void*, int32_t, const view*, int32_t, const int32_t*, int32_t, view*, void**);
extern void visp_image_destroy(void*);
extern void visp_model_destroy(void*, int32_t);
extern void visp_device_destroy(void*);

/* argv: repo, out dir, width, height, then (gguf, n args, args...) per model */
int main(int argc, char** argv) {
    if (!visp_init(argv[1])) { printf("init failed: %s\n", visp_get_last_error()); return 1; }
    void* dev = 0;
    if (!visp_device_init(2, &dev)) { printf("device failed: %s\n", visp_get_last_error()); return 1; }
    printf("device type %d\n", visp_device_type(dev));
    int w = atoi(argv[3]), h = atoi(argv[4]);
    unsigned char* rgb = malloc((size_t)w * h * 3);
    unsigned char* mask = malloc((size_t)w * h);
    for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
            unsigned char* p = rgb + ((size_t)y * w + x) * 3;
            p[0] = (unsigned char)((x * 3 + y) % 256);
            p[1] = (unsigned char)((y * 5) % 256);
            p[2] = (unsigned char)((x * y / 7 + 11 * (x % 5)) % 256);
            mask[(size_t)y * w + x] = (y > h / 4 && y < h / 2 && x > w / 3 && x < 2 * w / 3) ? 255 : 0;
        }
    void* model = 0;
    if (visp_model_load("/does/not/exist.gguf", dev, -1, &model)) { printf("unexpected load\n"); return 1; }
    printf("error bad path: %s\n", visp_get_last_error());
    int i = 5;
    while (i < argc) {
        const char* path = argv[i];
        int n = atoi(argv[i + 1]);
        int32_t args[4] = {0, 0, 0, 0};
        for (int k = 0; k < n; ++k) args[k] = atoi(argv[i + 2 + k]);
        i += 2 + n;
        int32_t fam = -1;
        if (!visp_model_detect_family(path, &fam)) { printf("detect failed: %s\n", visp_get_last_error()); return 1; }
        if (visp_model_load(path, dev, fam == 0 ? 4 : 0, &model)) { printf("unexpected mismatch load\n"); return 1; }
        printf("error family mismatch %d: %s\n", fam, visp_get_last_error());
        if (!visp_model_load(path, dev, fam, &model)) { printf("load failed: %s\n", visp_get_last_error()); return 1; }
        view in[2] = {{w, h, w * 3, 3, rgb}, {w, h, w, 4, mask}};
        view out;
        void* img = 0;
        if (!visp_model_compute(model, fam, in, fam == 3 ? 2 : 1, args, n, &out, &img)) {
            printf("compute failed: %s\n", visp_get_last_error());
            return 1;
        }
        char name[4096];
        snprintf(name, sizeof name, "%s/%d.bin", argv[2], fam);
        FILE* f = fopen(name, "wb");
        fwrite(out.data, 1, (size_t)out.stride * out.height, f);
        fclose(f);
        printf("family %d out %d %d %d %d\n", fam, out.width, out.height, out.stride, out.format);
        visp_image_destroy(img);
        visp_model_destroy(model, fam);
    }
    visp_device_destroy(dev);
    free(rgb);
    free(mask);
    printf("C-ABI-OK\n");
    return 0;
}
"""


def capi_inputs(family: str) -> tuple[list, list]:
    """The images (the ABI's tuples) and args of CAPI_PROGRAM's request of
    ``family``, made in numpy as the C program makes them."""
    w, h = CAPI_EXTENT
    y, x = np.mgrid[0:h, 0:w]
    rgb = np.stack([(x * 3 + y) % 256, (y * 5) % 256, (x * y // 7 + 11 * (x % 5)) % 256], -1).astype(np.uint8)
    mask = np.where((y > h // 4) & (y < h // 2) & (x > w // 3) & (x < 2 * w // 3), 255, 0).astype(np.uint8)
    images = [(w, h, w * 3, 3, rgb.tobytes())]
    if family == "migan":
        images.append((w, h, w, 4, mask.tobytes()))
    return images, CAPI_ARGS.get(family, [])


def vtt_counts(torch) -> dict:
    from vision_tpu_torch.ops.cuda import conv3x3, deform_conv, deform_sample, dequant, flash_attention
    from vision_tpu_torch.ops.cuda import window_attention

    c = {"flash": flash_attention.launches, "window": window_attention.launches, "conv3x3": conv3x3.launches,
         "deform_conv": deform_conv.launches, "deform_sample": deform_sample.launches, "dequant": dequant.launches,
         "window masked": window_attention.masked_launches}
    return {k: v for k, v in c.items() if v}


def op_samples(torch, gen) -> list:
    """(op, args) for torch.library.opcheck at one served shape each, on
    the card in bf16: Depth-Anything's flash attention at 518^2 batch 4;
    TinyViT's first window stage at batch 6 and SWIN-L's first masked
    stage at 1024^2; Real-ESRGAN's conv1 at 256^2 with its leaky ReLU, into
    a fresh tensor and into its 32 channels of the dense block's buffer;
    BiRefNet's k 3 deformable conv at 64^2 with its epilogue, fresh and
    into its branch's view; the sampler at the same shape; a Q8_0 dequant
    of a (384, 384, 3, 3) weight."""
    bf16 = torch.bfloat16
    vtt = torch.ops.vtt
    t = depth_tokens((518, 518))
    q, k, v = (torch.randn(4, 6, t, 64, device="cuda", generator=gen).to(bf16) for _ in range(3))
    nw, tw, heads = SAM_STAGES[0]
    wq, wk, wv = (torch.randn(6 * nw, tw, heads * 32, device="cuda", generator=gen).to(bf16) for _ in range(3))
    wb = (torch.randn(heads, tw, tw, device="cuda", generator=gen) * 0.5).to(bf16)
    sq, sk, sv, sb, smask = swin_windows(torch, gen, 256, 12, 6, 1, bf16)
    x, w, b, kw, _ = conv_path_forms(torch, gen, 256, 64, 32)
    dx, dw, doff, dmask, pad, dkw, _ = deform_conv_path_forms(torch, gen, 1, 64, 3, 2)
    n = 384 * 384 * 9
    qi = torch.randint(-127, 128, (n,), dtype=torch.int8, device="cuda", generator=gen)
    qs = torch.rand(n // 32, device="cuda", generator=gen) * 0.01
    epi = (dkw["bias"], dkw["scale"], dkw["shift"], True, dkw["layout"])
    return [
        (vtt.flash_attention.default, (q, k, v, 0.125)),
        (vtt.window_attention.default, (wq, wk, wv, wb, heads, 32**-0.5, None)),
        (vtt.window_attention.default, (sq, sk, sv, sb, 6, 32**-0.5, smask)),
        (vtt.conv3x3.default, (x, w, b, None, None, False, 0.2, None, 1.0, None, 1.0)),
        (vtt.conv3x3_out.default, (x, w, b, None, None, False, 0.2, None, 1.0, None, 1.0, kw["out"])),
        (vtt.deform_conv.default, (dx, dw, doff, dmask, 3, 3, 1, pad, None, *epi[:3], epi[3], epi[4])),
        (vtt.deform_conv_out.default, (dx, dw, doff, dmask, 3, 3, 1, pad, None, *epi[:3], epi[3], epi[4], dkw["out"])),
        (vtt.deform_sample.default, (dx, doff, dmask, 3, 3, 1, pad, None)),
        (vtt.dequant.default, (qi, qs, None, [384, 384, 3, 3], None, bf16)),
    ]


def ops_phase(torch, card: str, fd: dict) -> dict:
    """Phase 39: opcheck of every vtt operator on the card; the _out forms
    on channel views; the operator's dispatch cost per call; eager and
    replay ms of YOLOv9t and Real-ESRGAN beside the graphs'."""
    from vision_tpu_torch.ops.cuda import conv3x3 as cc

    gen = torch.Generator(device="cuda").manual_seed(39)
    samples = op_samples(torch, gen)
    for op, args in samples:
        res = torch.library.opcheck(op, args)
        if any(v != "SUCCESS" for v in res.values()):
            raise AssertionError(f"opcheck {op}: {res}")
        print(f"opcheck {op.name()} at {[tuple(a.shape) for a in args if isinstance(a, torch.Tensor)][:2]}: "
              f"{', '.join(res)} pass", flush=True)
    # the _out forms write their view and nothing else, as the fresh form computes it
    for op, fresh, args, out_at in (
        ("conv3x3_out", "conv3x3", samples[4][1], 11),
        ("deform_conv_out", "deform_conv", samples[6][1], 14),
    ):
        view = args[out_at]
        buf = view._base
        before = buf.clone()
        getattr(torch.ops.vtt, op)(*args)
        want = getattr(torch.ops.vtt, fresh)(*args[:out_at])
        c0, c1 = view.storage_offset() % buf.shape[-1], view.storage_offset() % buf.shape[-1] + view.shape[-1]
        kept = torch.equal(buf[..., :c0], before[..., :c0]) and torch.equal(buf[..., c1:], before[..., c1:])
        if not (torch.equal(view, want) and kept):
            raise AssertionError(f"{op}: view equal to {fresh} {torch.equal(view, want)}, other channels kept {kept}")
        print(f"{op} into channels [{c0}, {c1}) of a {buf.shape[-1]}-channel buffer: equal to {fresh}, the other "
              f"channels unchanged", flush=True)
    # dispatch cost: the same small conv through the operator and straight to its launch
    x = torch.randn(1, 8, 16, 16, device="cuda", dtype=torch.bfloat16)
    w = torch.randn(16, 16, 3, 3, device="cuda", dtype=torch.bfloat16)
    direct = lambda: cc.launch(x, w, None, None, None, False, None, None, 1.0, None, 1.0)  # noqa: E731
    via_op = lambda: torch.ops.vtt.conv3x3(x, w, None, None, None, False, None, None, 1.0, None, 1.0)  # noqa: E731
    host_us = {"op": [], "launch": []}
    for label, fn in (("op", via_op), ("launch", direct), ("launch", direct), ("op", via_op)):  # in turns
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DISPATCH_CALLS):
            fn()
        torch.cuda.synchronize()
        host_us[label].append((time.perf_counter() - t0) / DISPATCH_CALLS * 1e6)
    op_us, launch_us = min(host_us["op"]), min(host_us["launch"])
    print(f"host per call of a (1, 8, 16, 16) bf16 conv3x3, {DISPATCH_CALLS} calls, best of 2: through vtt::conv3x3 "
          f"{op_us:.2f} us, straight to its launch {launch_us:.2f} us: dispatch {op_us - launch_us:.2f} us a call "
          f"[{card}]", flush=True)
    eager = {}
    for family, b in (("yolov9t", YOLO_BATCH), ("esrgan", 4)):
        row = fd["graphs"][(family, b)]
        eager[family] = {"eager_ms": row["eager_ms"], "replay_ms": row["replay_ms"]}
        print(f"{family} batch {b}: eager _forward_u8 {row['eager_ms']:.3f} ms, graph replay {row['replay_ms']:.3f} ms "
              f"(phase 27, through the vtt operators) [{card}]", flush=True)
    return {"dispatch_us": op_us - launch_us, "op_us": op_us, "launch_us": launch_us, "eager": eager}


def export_forwards(model, family: str):
    """entry -> the in-process tensor forward the entry exports."""
    if family == "sam":
        return {"encode": model.encode_u8, "decode_point": lambda e, c: model._dec_point(e, c[None]),
                "decode_box": lambda e, c: model._dec_box(e, c[None])}
    if family == "sam3":
        return {"encode_vision": model._encode_vision, "encode_text": model._encode_text}
    return {("upscale" if family == "esrgan" else "forward"): model._forward_u8}


def export_inputs(torch, rng, bundle, entry: str, model, family: str) -> list:
    """The inputs of one call of ``entry``, as its input specs ask: u8
    images (MI-GAN's mask a hole of 255), SAM's encode of the first image
    and a point or box, SAM3's processed images and a tokenized prompt."""
    specs = bundle.input_specs(entry)
    if bundle.meta["params_embedded"] is False:
        specs = specs[len(model.params):]
    if family == "sam" and entry != "encode":
        s = model.p.image_size
        x = torch.from_numpy(rng.integers(0, 256, (1, s, s, 3), np.uint8))
        coords = [[300.0, 400.0], [0.0, 0.0]] if entry == "decode_point" else [[100.0, 120.0], [700.0, 600.0]]
        return [model.encode_u8(x).clone().cpu(), torch.tensor(coords)]
    if family == "sam3":
        if entry == "encode_text":
            toks = model.tokenizer.tokenize(SAM3_PROMPTS[1], model.max_tokens)
            return [torch.from_numpy(toks.token_ids[None].astype(np.int32)), torch.from_numpy(toks.attention_mask)]
        (shape, _), = specs
        return [torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)).to(model.dtype)]
    out = [torch.from_numpy(rng.integers(0, 256, shape, np.uint8)) for shape, _ in specs]
    if family == "migan":
        out[1] = (out[1] > 180).to(torch.uint8) * 255
    return out


def output_leaves(out) -> list:
    """An output's tensors in a fixed order: NamedTuples as dicts, dicts by
    key (a bundle returns a NamedTuple of the forward as a dict)."""
    if hasattr(out, "_fields"):
        out = out._asdict()
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in output_leaves(out[k])]
    if isinstance(out, (list, tuple)):
        return [t for v in out for t in output_leaves(v)]
    return [out]


def same_output(torch, got, want) -> tuple[bool, float]:
    """Whether two outputs (tensors, or dicts and tuples of them) are
    bit-equal, and the largest relative RMS between their leaves."""
    g, w = output_leaves(got), output_leaves(want)
    if len(g) != len(w) or any(a.shape != b.shape or a.dtype != b.dtype for a, b in zip(g, w)):
        raise AssertionError(f"outputs differ in structure: {[tuple(a.shape) for a in g]} vs {[tuple(b.shape) for b in w]}")
    equal = all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(g, w))
    return equal, max(rel_rms_t(a.float().cpu(), b.float().cpu()) for a, b in zip(g, w))


def export_phase(torch, card: str, fd: dict, models: dict, cpu_models: dict, tmp: str) -> dict:
    """Phase 40: one bundle per family at full width (BiRefNet and SAM3
    program-only), a Q8_0 Depth-Anything and a CPU-exported YOLOv9t; one
    subprocess loads them all with load_bundle, calls each entry and holds
    no model module; each output against the in-process forward, each
    call's launches against a forward's."""
    from vision_tpu_torch.core.device import BuildFlag, backend_init
    from vision_tpu_torch.api import load_model
    from vision_tpu_torch.core.gguf import requantize_gguf
    from vision_tpu_torch.export import export_model, load_bundle

    rng = np.random.default_rng(40)
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep))
    d = os.path.join(tmp, "export")
    os.makedirs(d, exist_ok=True)
    q8 = os.path.join(d, "depthany-q8_0.gguf")
    requantize_gguf(fd["paths"]["depthany"], q8, "q8_0")
    gpu = backend_init("gpu")
    # name -> (model in process, GGUF or None (SAM3: exported here), batch, extent, program-only, load device)
    cases = {family: (models[family], fd["paths"].get(family), *EXPORT_CASES[family], family in EXPORT_PROGRAM_ONLY,
                      None) for family in EXPORT_CASES}
    cases["depthany_q8"] = (load_model(q8, gpu.with_flags(gpu.flags | BuildFlag.keep_quantized)), q8,
                            *EXPORT_CASES["depthany"], False, None)
    cases["yolov9t_cpu"] = (cpu_models["yolov9t"], fd["paths"]["yolov9t"], 1, None, False, "cuda")
    # export is host work, one trace a family: a writer process each, all at once, and SAM3 here meanwhile
    with open(os.path.join(d, "writer.py"), "w") as f:
        f.write(EXPORT_WRITER)
    t0 = time.perf_counter()
    writers = {}
    for name, (model, gguf, batch, extent, program_only, device) in cases.items():
        if gguf is None:
            continue
        job = {"gguf": gguf, "dst": os.path.join(d, f"{name}.vxp"), "batch": batch, "extent": extent,
               "program_only": program_only, "device": "cpu" if device else "gpu",
               "keep_quantized": name == "depthany_q8", "params": os.path.join(d, f"{name}.params.pt")}
        log = open(os.path.join(d, f"{name}.writer.log"), "w")
        writers[name] = (subprocess.Popen([sys.executable, os.path.join(d, "writer.py"), json.dumps(job)], cwd=root,
                                          env=env, stdout=log, stderr=subprocess.STDOUT), log)
    rows = {}
    for name, (model, gguf, batch, extent, program_only, device) in cases.items():
        if gguf is None:
            t1 = time.perf_counter()
            entries = export_model(model, os.path.join(d, f"{name}.vxp"), extent=extent, batch=batch,
                                   embed_params=not program_only)
            torch.save({k: v.cpu() for k, v in model.params.items()}, os.path.join(d, f"{name}.params.pt"))
            rows[name] = {"export_s": time.perf_counter() - t1, "entries": entries}
    for name, (proc, log) in writers.items():
        proc.wait(timeout=900)
        log.close()
        with open(log.name) as f:
            text = f.read()
        if proc.returncode != 0:
            raise AssertionError(f"export writer {name} exited {proc.returncode}:\n{text[-6000:]}")
        rows[name] = json.loads(text.strip().splitlines()[-1])
    print(f"{len(cases)} bundles exported in {time.perf_counter() - t0:.1f} s ({len(writers)} writer processes at "
          f"once and SAM3 in this one)", flush=True)
    plan, expected = [], {}
    for name, (model, gguf, batch, extent, program_only, device) in cases.items():
        family = name.split("_")[0]
        dst = os.path.join(d, f"{name}.vxp")
        bundle = load_bundle(dst)
        rows[name]["mb"] = os.path.getsize(dst) / 1e6
        print(f"export {name}: {', '.join(rows[name]['entries'])} at batch {batch}"
              f"{' ' + str(bundle.meta.get('extent')) if 'extent' in bundle.meta else ''}, "
              f"{'program-only' if program_only else 'weights embedded'}, exported on the "
              f"{'CPU' if device else 'card'}: {rows[name]['mb']:.2f} MB, {rows[name]['export_s']:.1f} s to export "
              f"[{card}]", flush=True)
        for entry in rows[name]["entries"]:
            inputs = export_inputs(torch, rng, bundle, entry, model, family)
            path = os.path.join(d, f"{name}.{entry}")
            torch.save(inputs, path + ".in.pt")
            forward = export_forwards(model, family)[entry]
            torch.cuda.synchronize()
            zero_counts()
            want = forward(*[a.to("cpu" if device else "cuda") for a in inputs])
            torch.cuda.synchronize()
            expected[(name, entry)] = (want, vtt_counts(torch) if not device else None)
            plan.append({"name": f"{name}.{entry}", "bundle": dst, "entry": entry, "device": device,
                         "inputs": path + ".in.pt", "params": os.path.join(d, f"{name}.params.pt") if program_only
                         else None, "out": path + ".out.pt", "steady": EXPORT_STEADY_CALLS})
    with open(os.path.join(d, "loader.py"), "w") as f:
        f.write(EXPORT_LOADER)
    # a loader process a bundle, all at once: their loads and first calls are host work and overlap;
    # their steady calls take turns (a lock file)
    groups: dict = {}
    for item in plan:
        groups.setdefault(item["bundle"], []).append(item)
    t0 = time.perf_counter()
    loaders = []
    plans = [os.path.join(d, f"plan{i}.json") for i in range(len(groups))]
    for path, items in zip(plans, groups.values()):
        with open(path, "w") as f:
            json.dump(items, f)
    for path in plans:
        loaders.append(subprocess.Popen([sys.executable, os.path.join(d, "loader.py"), path,
                                         os.path.join(d, "steady.lock"), ",".join(plans)], cwd=root, env=env,
                                        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    by_name, modules = {}, set()
    for proc in loaders:
        stdout, stderr = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"bundle loader failed:\n{stdout[-4000:]}{stderr[-8000:]}")
        part = json.loads(stdout.strip().splitlines()[-1])
        by_name.update({e["name"]: e for e in part["entries"]})
        modules.update(part["modules"])
    report = {"entries": [by_name[item["name"]] for item in plan], "modules": sorted(modules)}
    print(f"{len(loaders)} loader subprocesses at once (one a bundle) loaded {len(groups)} bundles and called "
          f"{len(plan)} entries in {time.perf_counter() - t0:.1f} s (first calls overlapping, steady calls after all "
          f"first calls, one loader at a time); their modules of the port: {len(report['modules'])}", flush=True)
    bad = [m for m in report["modules"] if m.startswith(("vision_tpu_torch.models", "vision_tpu.", "jax"))
           or m in ("vision_tpu", "jax")]
    if bad:
        raise AssertionError(f"a bundle loader imported {bad}")
    graphs = fd["graphs"]
    for item, r in zip(plan, report["entries"]):
        name, entry = item["name"].split(".", 1)
        want, want_launches = expected[(name, entry)]
        got = torch.load(item["out"])
        family = name.split("_")[0]
        if item["device"]:  # exported on the CPU, served on the card in f32: the kernels against the plain route
            _, worst = same_output(torch, got, want)
            want_launches = {"conv3x3": YOLO_CONVS}
            if worst > EXPORT_CPU_F32_REL_RMS or r["launches"] != want_launches:
                raise AssertionError(f"{item['name']} (CPU export on the card): rel RMS {worst:.3g}, launches "
                                     f"{r['launches']} (expected {want_launches})")
            verdict = f"rel RMS {worst:.3g} against the CPU's f32 forward"
        else:
            equal, worst = same_output(torch, got, want)
            if not equal and worst > E2E_REL_RMS:
                raise AssertionError(f"{item['name']}: rel RMS {worst:.3g} against the in-process forward")
            if r["launches"] != want_launches:
                raise AssertionError(f"{item['name']}: launches {r['launches']}, a forward's {want_launches}")
            verdict = "bit-equal to the in-process forward" if equal else (
                f"NOT bit-equal to the in-process forward: rel RMS {worst:.3g} (within E2E_REL_RMS)")
        key = (family, EXPORT_CASES.get(family, (None,))[0])
        beside = (f"; eager {graphs[key]['eager_ms']:.3f} ms, replay {graphs[key]['replay_ms']:.3f} ms (phase 27)"
                  if key in graphs and name == family else "")
        r["verdict"] = verdict
        rows.setdefault(name, {})[entry] = r
        print(f"{item['name']}: {verdict}; launches {r['launches']}; load {r['load_s']:.2f} s, first call "
              f"{r['first_ms']:.1f} ms, steady {r['steady_ms']:.3f} ms{beside} [{card}]", flush=True)
    return rows


def capi_phase(torch, card: str, fd: dict, models: dict, tmp: str) -> dict:
    """Phase 41: the C ABI built and driven from a C program on
    visp_device_init(2) over the six families, each output against
    capi.model_compute in process (on handles of the card's models, as
    capi.model_load makes them); the error codes."""
    import shutil
    import sysconfig
    import threading

    from vision_tpu_torch import capi

    include = sysconfig.get_paths()["include"]
    families = list(capi.FAMILIES)
    paths = {f: fd["paths"]["depthany" if f == "depth_anything" else f] for f in families}
    if not os.path.isfile(os.path.join(include, "Python.h")):
        print(f"the C ABI shim was not built: no Python.h in {include}; driving capi.py in process instead",
              flush=True)
        dev = capi.device_init(2)
        for f in families:
            capi.model_compute(capi.model_load(paths[f], dev, -1), *capi_inputs(f))
        return {"built": False}
    from vision_tpu_torch.native import build_capi

    d = os.path.join(tmp, "capi")
    os.makedirs(d, exist_ok=True)
    t0 = time.perf_counter()
    lib = build_capi()
    build_s = time.perf_counter() - t0
    src = os.path.join(d, "main.c")
    with open(src, "w") as f:
        f.write(CAPI_PROGRAM)
    exe = os.path.join(d, "main")
    subprocess.run([shutil.which("gcc") or "gcc", src, "-o", exe, str(lib), f"-Wl,-rpath,{lib.parent}"], check=True)
    argv = [exe, os.path.dirname(os.path.abspath(__file__)), d, str(CAPI_EXTENT[0]), str(CAPI_EXTENT[1])]
    for f in families:
        a = capi_inputs(f)[1]
        argv += [paths[f], str(len(a)), *map(str, a)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.dirname(os.path.abspath(__file__)), *sys.path[1:]]))
    t0 = time.perf_counter()
    r = subprocess.run(argv, capture_output=True, text=True, env=env, timeout=600)
    run_s = time.perf_counter() - t0
    if r.returncode != 0 or "C-ABI-OK" not in r.stdout or "device type 2" not in r.stdout:
        raise AssertionError(f"the C program failed:\n{r.stdout[-4000:]}{r.stderr[-4000:]}")
    for line in r.stdout.splitlines():
        if line.startswith("error "):
            print("C program:", line, flush=True)
    if "No such file" not in r.stdout and "exist.gguf" not in r.stdout:
        raise AssertionError("the bad path's error does not name the file")
    for i, f in enumerate(families):
        handle = (models["depthany" if f == "depth_anything" else f], i, threading.Lock())
        data, w, h, stride, fmt = capi.model_compute(handle, *capi_inputs(f))
        got = np.fromfile(os.path.join(d, f"{i}.bin"), np.uint8)
        meta = f"family {i} out {w} {h} {stride} {fmt}"
        if meta not in r.stdout or not np.array_equal(got, np.asarray(data).reshape(-1)):
            raise AssertionError(f"C ABI {f}: {meta} in the program's output {meta in r.stdout}, bytes equal "
                                 f"{got.size == data.size and np.array_equal(got, np.asarray(data).reshape(-1))}")
        print(f"C ABI {f}: {w}x{h} format {fmt}, bytes equal to capi.model_compute in process", flush=True)
    print(f"C ABI shim {lib.name} built in {build_s:.2f} s; the C program (interpreter start, six loads and "
          f"computes on visp_device_init(2)) ran in {run_s:.1f} s [{card}]", flush=True)
    return {"built": True, "build_s": build_s, "run_s": run_s}


def flops_phase(torch, card: str, fd: dict, models: dict, cpu_models: dict, tmp: str) -> dict:
    """Phase 42: count_flops of each family's forward on the card's route
    and on the CPU route at the same shapes, beside the forward's ms as
    TFLOP/s; --profile on the yolov9t verb; yolov9t --dump on the card
    against the CPU's dump."""
    from vision_tpu_torch.utils import compare_dumps
    from vision_tpu_torch.utils.flops import count_flops

    rng = np.random.default_rng(42)
    rows = {}
    for family, (batch, extent) in EXPORT_CASES.items():
        model, cpu = models[family], cpu_models[family]
        if family == "sam3":
            s = model.vp.image_size
            shapes, fn = [(batch, s, s, 3)], "_encode_vision"
        elif family == "sam":
            shapes, fn = [(batch, 1024, 1024, 3)], "encode_u8"
        else:
            w, h = extent or {"migan": (MIGAN_RES, MIGAN_RES), "yolov9t": (640, 640)}[family]
            shapes = [(batch, h, w, 3)] + ([(batch, h, w, 1)] if family == "migan" else [])
            fn = "_forward_u8"
        xs = [torch.from_numpy(rng.integers(0, 256, sh, np.uint8)) for sh in shapes]
        if family == "sam3":
            xs = [x.to(model.dtype) for x in xs]
        card_flops = count_flops(getattr(model, fn), *[x.cuda() for x in xs])
        cpu_flops = count_flops(getattr(cpu, fn), *[x.float() if family == "sam3" else x for x in xs])
        if card_flops != cpu_flops or card_flops <= 0:
            raise AssertionError(f"count_flops {family}: card route {card_flops:.6g}, CPU route {cpu_flops:.6g}")
        key = (family, batch)
        if key in fd["graphs"]:
            ms, how = fd["graphs"][key]["replay_ms"], "graph replay (phase 27)"
        else:
            xc = [x.cuda() for x in xs]
            ms, how = median_ms(lambda: getattr(model, fn)(*xc), 10), "eager, median of 10"
        rows[family] = {"flops": card_flops, "ms": ms, "tflops": card_flops / ms / 1e9}
        print(f"count_flops {family} {shapes[0]}: {card_flops:.6g} FLOP on the card's route = the CPU route's; "
              f"{how} {ms:.3f} ms: {rows[family]['tflops']:.2f} TFLOP/s, {rows[family]['tflops'] / H100_BF16_TFLOPS:.2%} "
              f"of {H100_BF16_TFLOPS:.0f} TFLOP/s bf16 dense [{card}]", flush=True)

    # --profile and --dump on the yolov9t verb, as subprocesses on the card and the CPU
    d = os.path.join(tmp, "tools")
    os.makedirs(d, exist_ok=True)
    w, h = CLI_EXTENT
    img = front_images(rng, [(w, h)])[0]
    from vision_tpu_torch.image import Image, ImageFormat, image_save

    image_save(Image(img, ImageFormat.rgb_u8), os.path.join(d, "in.png"))
    base = ["yolov9t", "-m", fd["paths"]["yolov9t"], "-i", os.path.join(d, "in.png")]
    cli_run(base + ["-o", os.path.join(d, "gpu.png"), "--profile", os.path.join(d, "prof"), "--dump",
                    os.path.join(d, "dump_gpu")], "yolov9t --profile --dump (card)")
    from vision_tpu_torch.cli import _dump_yolov9t

    _dump_yolov9t(cpu_models["yolov9t"], Image(img, ImageFormat.rgb_u8), os.path.join(d, "dump_cpu"))  # --dump's own
    traces = [f for f in os.listdir(os.path.join(d, "prof")) if f.endswith(".json")]
    if len(traces) != 1:
        raise AssertionError(f"--profile wrote {traces}")
    with open(os.path.join(d, "prof", traces[0])) as f:
        events = json.load(f)["traceEvents"]
    ops = {e["name"] for e in events if e.get("name", "").startswith("vtt::")}
    kernels = {e["name"] for e in events if e.get("cat") == "kernel" and "conv3x3" in e.get("name", "")}
    if not {"vtt::conv3x3", "vtt::conv3x3_out"} <= ops or not kernels:
        raise AssertionError(f"--profile trace: vtt ops {ops}, conv3x3 kernels {kernels}")
    print(f"--profile: {traces[0]} holds {len(events)} events, the ops {sorted(ops)} and the kernels "
          f"{sorted(kernels)[:3]}", flush=True)
    gpu_files, cpu_files = sorted(os.listdir(os.path.join(d, "dump_gpu"))), sorted(os.listdir(os.path.join(d, "dump_cpu")))
    if gpu_files != cpu_files or len(gpu_files) != 22:
        raise AssertionError(f"--dump: {len(gpu_files)} files on the card, {len(cpu_files)} on the CPU")
    report = compare_dumps(os.path.join(d, "dump_cpu"), os.path.join(d, "dump_gpu"))
    worst = 0.0
    for name, r in report.items():
        ref = np.load(os.path.join(d, "dump_cpu", name))
        rel = r["rms"] / max(float(np.sqrt(np.mean(ref.astype(np.float64) ** 2))), 1e-12)
        worst = max(worst, rel)
    if worst > E2E_REL_RMS:
        raise AssertionError(f"--dump: the card's bf16 maps against the CPU's f32 at rel RMS {worst:.3g}")
    print(f"--dump: 22 feature maps on the card and on the CPU; compare_dumps' worst rel RMS {worst:.3g} "
          f"(bound {E2E_REL_RMS}); {sum(r['status'] == 'ok' for r in report.values())} of 22 within its allclose",
          flush=True)
    return {"flops": rows, "dump_worst": worst}


def tooling_phases(torch, card: str, fd: dict, tmp: str, sam3_models: tuple) -> dict:
    """Phases 39-42 over phase 27's GGUFs and the SAM3 models of phase 19."""
    from vision_tpu_torch.api import load_model
    from vision_tpu_torch.core.device import BuildFlag, backend_init

    gc.collect()
    torch.cuda.empty_cache()
    phase("39 the kernels as vtt operators: opcheck on the card, _out views, dispatch cost, eager and replay ms")
    ops = ops_phase(torch, card, fd)
    gpu, cpu = backend_init("gpu"), backend_init("cpu")
    cpu = cpu.with_flags(cpu.flags | BuildFlag.flash_attention)  # the CPU routed as the card routes
    models = {f: load_model(fd["paths"][f], gpu) for f in EXPORT_CASES if f != "sam3"}
    cpu_models = {f: load_model(fd["paths"][f], cpu) for f in EXPORT_CASES if f != "sam3"}
    models["sam3"], cpu_models["sam3"] = sam3_models
    cpu_models["sam3"].flash = True  # phase 19 loaded it with the CPU's flags
    phase("40 export: a bundle per family at full width, loaded and called in loader subprocesses without model "
          "modules")
    export = export_phase(torch, card, fd, models, cpu_models, tmp)
    phase("41 the C ABI: a C program over the six families on visp_device_init(2)")
    capi_row = capi_phase(torch, card, fd, models, tmp)
    phase("42 count_flops on the card's and the CPU's routes, --profile and --dump")
    flops = flops_phase(torch, card, fd, models, cpu_models, tmp)
    return {"ops": ops, "export": export, "capi": capi_row, "flops": flops}


# meshes (phases 43-45): the serving families at one NCCL rank, the kernels
# at the shapes a tensor-parallel shard gives them, and more ranks where the
# machine has the cards
MESH_SERVED = {  # family -> (server, batch, request extents (w, h)), each request in one bucket
    "depthany": ("ImageServer", 4, ((518, 518),) * 4),
    "birefnet": ("ImageServer", 4, ((1024, 1024),) * 4),
    "esrgan": ("EsrganServer", 4, ((256, 256),) * 4),
    "migan": ("ImageServer", MIGAN_BATCH, ((MIGAN_RES, MIGAN_RES),) * MIGAN_BATCH),
    "yolov9t": ("YoloServer", YOLO_BATCH, ((640, 480),) * YOLO_BATCH),
    "sam": ("SamServer", 6, ((1024, 1024),) * 6),
}
MESH_KERNELS = {**{c[0]: GRAPH_KERNELS[c[0]] for c in GRAPH_CASES}, "sam": {"window": 10}}  # launches a served batch
# phase 44: each attention output at a shard shape (flash and window, bf16)
# against its plain version's f32, relative RMS, beside BF16_MAX_ABS: the
# max-abs bound alone is ~0.7x a typical output at T 1370 and ~0.2x at the
# windows' T 144, too loose to see a dropped key tile; the D-80 limit, as
# bf16 rounding of p and o gives ~2-3e-3 at every one of these shapes
SHARD_BF16_REL_RMS = FLASH_D80_BF16_REL_RMS
# (label, B*H, T, D): Depth-Anything's 6 heads at tp 2 (batch 4), SAM3's 16 at tp 2 and 4
MESH_FLASH = (("Depth-Anything tp 2: 3 of 6 heads, batch 4", 12, 1370, 64),
              ("SAM3 tp 2: 8 of 16 heads", 8, 5184, 80), ("SAM3 tp 4: 4 of 16 heads", 4, 5184, 80))
# (label, B*H, Tq, Tk, D): SAM3's global layer on a sequence-parallel rank at batch 1, its share of the 5184
# window-major queries against every key of the image (gathered over sp)
MESH_SP_FLASH = (("SAM3 sp 3: 1728 of 5184 queries", 16, 1728, 5184, 80),
                 ("SAM3 sp 9: 576 of 5184 queries", 16, 576, 5184, 80),
                 ("SAM3 sp 3 x tp 2: 8 of 16 heads, 1728 queries", 8, 1728, 5184, 80))
# (label, windows, T, heads, side and window of a SWIN mask or None): TinyViT's stages 1 and 3 at tp 2 (stage 2's
# 5 heads stay whole), SWIN-L's four stages at tp 2, shifted (masked) and not, at batch 2 (a dp 2 shard of 4)
MESH_WINDOW = tuple(
    [(f"TinyViT stage {i + 1} tp 2: {h // 2} of {h} heads, batch 3", nw * 3, t, h // 2, None)
     for i, (nw, t, h) in enumerate(SAM_STAGES) if h % 2 == 0]
    + [(f"SWIN-L stage {i + 1} tp 2{m}: {h // 2} of {h} heads, batch 2", None, 144, h // 2, (side, masked))
       for i, (side, h) in enumerate(SWIN_L_STAGES) for masked, m in ((True, " masked"), (False, ""))])
MESH_DP_CLI_IMAGES = 4


def mesh_serve(torch, family: str, model, reqs: list, counts):
    """``reqs`` through ``family``'s server on ``model`` (one group; its
    bucket warmed first): the results as arrays and the hand-written
    launches (``counts()``) of the served batch."""
    from vision_tpu_torch import serve

    kind, batch, _ = MESH_SERVED[family]
    with getattr(serve, kind)(model, batch_size=batch, max_delay_ms=10_000) as srv:
        def run():
            if family == "sam":
                futs = [srv.submit(img, point=(img.width // 3, img.height // 2)) for img in reqs]
            else:
                futs = [srv.submit(r) for r in reqs]
            return [f.result(timeout=600) for f in futs]

        run()  # the bucket's graph captured (its warm-up launches the kernels too)
        torch.cuda.synchronize()
        zero_counts()
        out = run()
        torch.cuda.synchronize()
        launches = {k: v for k, v in counts().items() if v}
    if family == "yolov9t":
        arrays = [np.array([[d.x1, d.y1, d.x2, d.y2, d.confidence, d.class_id] for d in dets], np.float64)
                  for dets in out]
    else:
        arrays = [r.data for r in out]
    return arrays, launches


def mesh_requests(rng, family: str) -> list:
    from vision_tpu_torch.image import Image, ImageFormat

    _, _, extents = MESH_SERVED[family]
    if family == "migan":
        return [(Image(px[..., :3].copy(), ImageFormat.rgb_u8), Image(px[..., 3:].copy(), ImageFormat.alpha_u8))
                for px in front_images(rng, extents, channels=4)]
    return [Image(px, ImageFormat.rgb_u8) for px in front_images(rng, extents)]


def mesh_one_rank(torch, card: str, fd: dict, sam3_models: tuple, tmp: str) -> dict:
    """Phase 43: a world of one NCCL rank, joined through init_distributed
    (a file store) as every rank of an N-card world joins, then
    make_mesh(1); each family
    loaded through its loader with ``mesh=`` and served through its server,
    against the same weights without a mesh: every result bit-equal, the
    same launches, those a served batch makes; SAM3's encoders on the
    meshed model; then ``depthany -i DIR --dp 1`` and ``serve --dp 1``
    (mesh_dp1_cli)."""
    import torch.distributed as dist

    from vision_tpu_torch.api import family_loader, model_detect_family
    from vision_tpu_torch.core.device import backend_init
    from vision_tpu_torch.models.sam3 import Sam3Model
    from vision_tpu_torch.ops.cuda import dequant, window_attention
    from vision_tpu_torch.parallel import init_distributed, make_mesh
    from vision_tpu_torch.parallel.sharding import mesh_shape

    def counts():
        return {**fd["counts"](), "window masked": window_attention.masked_launches, "dequant": dequant.launches}

    dev = backend_init()
    if dist.is_initialized():
        raise AssertionError("phase 43: a process group exists before init_distributed")
    init_distributed("file://" + os.path.join(tmp, "mesh_store"), 1, 0)
    mesh = make_mesh(1)
    group = mesh.get_group("tp")
    probe = torch.arange(4.0, device="cuda")
    dist.all_reduce(probe, group=group)  # NCCL's own collective on the card, a world of one
    torch.cuda.synchronize()
    if not torch.equal(probe, torch.arange(4.0, device="cuda")):
        raise AssertionError(f"one-rank all_reduce changed its input: {probe}")
    print(f"mesh world size {dist.get_world_size()} (init_distributed, a file store): {mesh_shape(mesh)}, backend "
          f"{dist.get_backend(group)}, TORCH_NCCL_BLOCKING_WAIT {os.environ.get('TORCH_NCCL_BLOCKING_WAIT')} [{card}]",
          flush=True)
    rng = np.random.default_rng(43)
    rows = {}
    for family in MESH_SERVED:
        t0 = time.perf_counter()
        meshed = family_loader(model_detect_family(fd["paths"][family]))(fd["paths"][family], dev, mesh=mesh)
        load_s = time.perf_counter() - t0
        plain = type(meshed)(meshed.params, meshed.p, dev)  # the same weights, no mesh
        reqs = mesh_requests(rng, family)
        t1 = time.perf_counter()
        got, got_n = mesh_serve(torch, family, meshed, reqs, counts)
        mesh_s = time.perf_counter() - t1
        want, want_n = mesh_serve(torch, family, plain, reqs, counts)
        same = all(np.array_equal(a, b) for a, b in zip(got, want)) and len(got) == len(want)
        expect = {k: v for k, v in MESH_KERNELS[family].items() if v}
        if family == "birefnet":
            expect["window masked"] = BIREF_WINDOWS // 2
        print(f"mesh {family} at one rank through {MESH_SERVED[family][0]} (batch {MESH_SERVED[family][1]}): "
              f"{len(reqs)} results {'bit-equal' if same else 'DIFFER'} to the unmeshed model's; launches "
              f"{got_n} meshed, {want_n} unmeshed, {expect} expected; load {load_s:.2f} s, serve (with capture) "
              f"{mesh_s:.2f} s [{card}]", flush=True)
        if not same or got_n != want_n or got_n != expect:
            raise AssertionError(f"mesh {family}: results equal {same}, launches {got_n} / {want_n} / {expect}")
        rows[family] = got_n
        case = next((c for c in GRAPH_CASES if c[0] == family), None)
        if case is not None:  # the mesh's own cost a call at one rank: header, scatter, gather
            _, (batch, _), shapes, flags = case
            xs = [torch.from_numpy(rng.integers(0, 256, (batch, *sh), np.uint8)) for sh in shapes]
            ms = {label: median_ms(lambda m=m: m.forward_u8(*xs, **flags), 10)
                  for label, m in (("meshed", meshed), ("unmeshed", plain))}
            rows[f"{family}_ms"] = ms
            print(f"mesh {family} forward_u8 batch {batch} at one rank: {ms['meshed']:.3f} ms meshed, "
                  f"{ms['unmeshed']:.3f} ms unmeshed ({ms['meshed'] - ms['unmeshed']:+.3f} ms: the header "
                  f"broadcast, the scatter, the tally of errors and the gather) [{card}]", flush=True)
        del meshed, plain
    card_s3 = sam3_models[0]
    meshed3 = Sam3Model(card_s3.params, card_s3.tokenizer, card_s3.max_tokens, dev, vp=card_s3.vp, mesh=mesh)
    from vision_tpu_torch.image import Image, ImageFormat

    img = Image(front_images(rng, ((1008, 1008),))[0], ImageFormat.rgb_u8)
    zero_counts()
    a = meshed3.encode_vision(img)
    torch.cuda.synchronize()
    n3 = counts()["flash"]
    b = card_s3.encode_vision(img)
    ta, tb = meshed3.encode_text(SAM3_PROMPTS[0]), card_s3.encode_text(SAM3_PROMPTS[0])
    same3 = all(torch.equal(x, y) for x, y in zip(a, b)) and torch.equal(ta, tb)
    print(f"mesh SAM3 at one rank: encode_vision (four FPN levels) and encode_text "
          f"{'bit-equal' if same3 else 'DIFFER'} to the unmeshed model's; {n3} flash launches a meshed encode_vision "
          f"[{card}]", flush=True)
    if not same3 or n3 != 4:
        raise AssertionError(f"mesh SAM3: equal {same3}, {n3} flash launches")
    rows["sam3"] = {"flash": n3}
    del meshed3
    rows["cli"] = mesh_dp1_cli(card, fd, tmp)
    dist.destroy_process_group()  # before tmp and its store go: the group's threads read the store
    return rows


def mesh_dp1_cli(card: str, fd: dict, tmp: str) -> dict:
    """The CLI's ``depthany -i DIR --dp 1`` in this process (its ``main``:
    this process's world of one is its mesh) against bulk_run of the
    unmeshed model (the verb's own path: files byte-equal), and ``serve --dp
    1`` as a subprocess (a world of its own; one request answered, then
    SIGINT, exit 0 within SERVE_EXIT_S)."""
    import queue
    import signal
    import threading

    from vision_tpu_torch.image import Image, ImageFormat, image_save
    from vision_tpu_torch.image.png import encode_png, read_png

    src = os.path.join(tmp, "mesh_in")
    os.makedirs(src, exist_ok=True)
    for i, px in enumerate(front_images(np.random.default_rng(44), ((700, 500), (518, 518)) * 2)):
        image_save(Image(px, ImageFormat.rgb_u8), os.path.join(src, f"m{i}.png"))
    from vision_tpu_torch import cli, load_model
    from vision_tpu_torch.bulk import bulk_inputs, bulk_run

    walls = {}
    t0 = time.perf_counter()
    rc = cli.main(["depthany", "-m", fd["paths"]["depthany"], "-i", src, "-o", os.path.join(tmp, "mesh_out_dp1"),
                   "--dp", "1"])
    walls["dp1"] = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"depthany -i DIR --dp 1 exited {rc}")
    t0 = time.perf_counter()
    bulk_run(load_model(fd["paths"]["depthany"]), bulk_inputs(src), os.path.join(tmp, "mesh_out_plain"))
    walls["plain"] = time.perf_counter() - t0
    names = sorted(os.listdir(os.path.join(tmp, "mesh_out_plain")))
    same = len(names) == MESH_DP_CLI_IMAGES and all(
        open(os.path.join(tmp, "mesh_out_dp1", n), "rb").read() == open(os.path.join(tmp, "mesh_out_plain", n),
                                                                         "rb").read() for n in names)
    print(f"depthany -i DIR --dp 1 (cli.main here): {len(names)} files {'byte-equal' if same else 'DIFFER'} to "
          f"bulk_run of the unmeshed model; {walls['dp1']:.2f} s (bulk_run {walls['plain']:.2f} s) [{card}]",
          flush=True)
    if not same:
        raise AssertionError("depthany --dp 1 wrote other files")
    root = os.path.dirname(os.path.abspath(__file__))
    err_path = os.path.join(tmp, "serve_dp1_stderr.txt")
    with open(err_path, "w") as err:
        proc = subprocess.Popen([sys.executable, "-m", "vision_tpu_torch.cli", "serve", "-m", fd["paths"]["depthany"],
                                 "--port", "0", "--dp", "1"], cwd=root, stdout=subprocess.PIPE, stderr=err, text=True)
    try:
        lines: queue.Queue = queue.Queue()
        threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout] + [lines.put(None)], daemon=True).start()
        port, seen = None, []
        while port is None:
            line = lines.get(timeout=600)
            if line is None:
                raise AssertionError(f"serve --dp 1 exited {proc.wait()}:\n{''.join(seen)}{open(err_path).read()}")
            seen.append(line)
            if line.startswith("serving on port "):
                port = int(line.split()[3].rstrip(":"))
        body = encode_png(front_images(np.random.default_rng(45), ((700, 500),))[0])
        status, resp, _ = http_call(port, "POST", HTTP_ROUTES["depthany"], body)
        depth = read_png(resp) if status == 200 else None
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=SERVE_EXIT_S)
        exit_s = time.perf_counter() - t1
        ok = status == 200 and depth is not None and depth.shape[:2] == (500, 700) and rc == 0
        print(f"serve --dp 1 subprocess: {''.join(s for s in seen if s.startswith('dp mesh')).strip()}; "
              f"/v1/depthany HTTP {status} {None if depth is None else depth.shape}; exit {rc} {exit_s:.2f} s after "
              f"SIGINT [{card}]", flush=True)
        if not ok:
            raise AssertionError(f"serve --dp 1: HTTP {status}, exit {rc}:\n{open(err_path).read()}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return {"dir_s": walls["dp1"], "plain_dir_s": walls["plain"]}


def mesh_shard_kernels(torch, card: str, fa, wa, dcm) -> dict:
    """Phase 44: the flash, window (masked and unmasked) and deformable conv
    kernels against their plain versions at the shapes a tp (or dp) shard
    gives them (MESH_FLASH, MESH_WINDOW; BiRefNet's 20 deformable convs at
    batch 2, the dp 2 shard of a batch of 4, whose weights no tp rule
    shards), bf16, each one launch, and each timed by the card's own time
    beside its plain version. The attention outputs are also held to
    SHARD_BF16_REL_RMS of the plain version's f32 (shard_rel_rms). The
    flash kernel at a sequence-parallel rank's shapes (MESH_SP_FLASH: Tq
    the rank's queries, Tk the image's keys) beside its plain version, SDPA
    and its bound too (sp_rows)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(44)
    bf16 = torch.bfloat16
    rows, worst, worst_rms, sp_rows = [], 0.0, {}, []
    for label, bh, t, d in MESH_FLASH:
        q, k, v = (torch.randn(1, bh, t, d, device="cuda", generator=gen).to(bf16) for _ in range(3))
        before = fa.launches
        out = fa.flash_attention(q, k, v, scale=d**-0.5)
        torch.cuda.synchronize()
        if fa.launches != before + 1:
            raise AssertionError(f"flash {label}: {fa.launches - before} launches")
        ref = fa.flash_attention_plain(q.float(), k.float(), v.float(), d**-0.5)
        name = f"flash_attention shard {label} ({bh}, {t}, {d})"
        worst = max(worst, check_close(name, out, ref, bf16, torch))
        worst_rms["flash_attention"] = max(worst_rms.get("flash_attention", 0.0), shard_rel_rms(name, out, ref))
        ms = device_ms(lambda: fa.flash_attention(q, k, v, scale=d**-0.5))
        plain = device_ms(lambda: fa.flash_attention_plain(q, k, v, d**-0.5))
        rows.append(("flash_attention", label, ms, plain))
        del q, k, v, out, ref
    for label, bh, tq, tk, d in MESH_SP_FLASH:
        q = torch.randn(1, bh, tq, d, device="cuda", generator=gen).to(bf16)
        k, v = (torch.randn(1, bh, tk, d, device="cuda", generator=gen).to(bf16) for _ in range(2))
        before = fa.launches
        out = fa.flash_attention(q, k, v, scale=d**-0.5)
        torch.cuda.synchronize()
        if fa.launches != before + 1:
            raise AssertionError(f"flash {label}: {fa.launches - before} launches")
        ref = fa.flash_attention_plain(q.float(), k.float(), v.float(), d**-0.5)
        name = f"flash_attention sp shard {label} (BH {bh}, Tq {tq}, Tk {tk}, D {d})"
        err = check_close(name, out, ref, bf16, torch)
        worst = max(worst, err)
        worst_rms["flash_attention"] = max(worst_rms["flash_attention"], shard_rel_rms(name, out, ref))
        run_k = lambda: fa.flash_attention(q, k, v, scale=d**-0.5)  # noqa: E731
        run_p = lambda: fa.flash_attention_plain(q, k, v, d**-0.5)  # noqa: E731
        run_l = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
        k1, p1, l1, l2, p2, k2 = (device_ms(f, calls=c) for f, c in ((run_k, 20), (run_p, 5), (run_l, 20),
                                                                  (run_l, 20), (run_p, 5), (run_k, 20)))
        bound, by = bound_ms(4.0 * bh * tq * tk * d, 2.0 * bh * d * (2 * tq + 2 * tk))
        sp_rows.append({"shape": f"{label}: q ({bh}, {tq}, {d}), k and v ({bh}, {tk}, {d}) bf16", "ms": min(k1, k2),
                        "plain_ms": min(p1, p2), "library_ms": min(l1, l2), "bound_ms": bound, "bound_by": by,
                        "max_abs_err": err})
        print(f"flash_attention at a sequence-parallel shard, {label}: kernel {k1:.4f} / {k2:.4f} ms, plain "
              f"{p1:.4f} / {p2:.4f} ms, SDPA {l1:.4f} / {l2:.4f} ms, bound {bound:.4f} ms ({by}), kernel at "
              f"{bound / min(k1, k2):.2%} of the bound, by the card's own time [{card}]", flush=True)
        del q, k, v, out, ref
    for label, nw, t, h, swin in MESH_WINDOW:
        mask = None
        if swin is None:
            q, k, v = (torch.randn(nw, t, h * 32, device="cuda", generator=gen).to(bf16) for _ in range(3))
            bias = (torch.randn(h, t, t, device="cuda", generator=gen) * 0.5).to(bf16)
        else:
            q, k, v, bias, mask = swin_windows(torch, gen, swin[0], 12, h, 2, bf16)
            mask = mask if swin[1] else None
        before = wa.launches
        out = wa.window_attention(q, k, v, bias, h, 32**-0.5, mask)
        torch.cuda.synchronize()
        if wa.launches != before + 1:
            raise AssertionError(f"window {label}: {wa.launches - before} launches")
        ref = wa.window_attention_plain(q, k, v, bias, h, 32**-0.5, mask).float()
        name = f"window_attention shard {label} (NW={q.shape[0]}, T={t}, H={h})"
        worst = max(worst, check_close(name, out, ref, bf16, torch))
        ref32 = wa.window_attention_plain(q.float(), k.float(), v.float(), bias.float(), h, 32**-0.5, mask)
        worst_rms["window_attention"] = max(worst_rms.get("window_attention", 0.0), shard_rel_rms(name, out, ref32))
        ms = device_ms(lambda: wa.window_attention(q, k, v, bias, h, 32**-0.5, mask))
        plain = device_ms(lambda: wa.window_attention_plain(q, k, v, bias, h, 32**-0.5, mask))
        rows.append(("window_attention", label, ms, plain))
        del q, k, v, out, ref, ref32
    for hw in BIREF_BLOCK_HW:
        for branch, k in enumerate(BIREF_DEFORM_KS):
            x, w, off, mask, pad, kw, buf = deform_conv_path_forms(torch, gen, 2, hw, k, branch)
            before = dcm.launches
            out = dcm.deform_conv(x, w, off, mask, k, k, 1, pad, **kw)
            torch.cuda.synchronize()
            if dcm.launches != before + 1:
                raise AssertionError(f"deform_conv shard ({hw}, k {k}): {dcm.launches - before} launches")
            epi = {n: v.float() for n, v in kw.items() if n in ("bias", "scale", "shift")}
            ref = dcm.deform_conv_plain(x.float(), w.float(), off, mask, k, k, 1, pad, relu=True, **epi)
            worst = max(worst, check_close(f"deform_conv shard (2, {hw}, {hw}, {BIREF_CIN}) k={k} -> {BIREF_COUT}",
                                           out, ref, bf16, torch))
            if hw == 256 and k == 7:
                ms = device_ms(lambda: dcm.deform_conv(x, w, off, mask, k, k, 1, pad, **kw))
                plain = device_ms(lambda: dcm.deform_conv_plain(x, w, off, mask, k, k, 1, pad, relu=True, **epi),
                                  calls=3, reps=1)
                rows.append(("deform_conv", f"BiRefNet dp 2 shard: (2, 256, 256, {BIREF_CIN}) k 7", ms, plain))
            del x, w, off, mask, kw, buf, out, ref
    for name, label, ms, plain in rows:
        print(f"{name} at a shard shape, {label}: {ms:.4f} ms, plain {plain:.4f} ms, by the card's own time "
              f"[{card}]", flush=True)
    return {"worst": worst, "worst_rel_rms": worst_rms, "rows": rows, "sp_rows": sp_rows}


def shard_rel_rms(name: str, out, ref) -> float:
    """Phase 44: a bf16 attention output's relative RMS against its plain
    version's f32 ``ref``; raises past SHARD_BF16_REL_RMS."""
    rms = rel_rms_t(out.float(), ref)
    ok = rms <= SHARD_BF16_REL_RMS
    print(f"kernel {name}: relative RMS {rms:.3e} (output RMS {float(ref.pow(2).mean().sqrt()):.3e}) "
          f"[<= {SHARD_BF16_REL_RMS}] {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: relative RMS {rms}")
    return rms


def mesh_more_ranks(card: str) -> list:
    """Phase 45: dryrun_multichip over 2 cards (dp 2) where the machine has
    them and over 4 (dp 2 x tp 2 for MobileSAM, BiRefNet and SAM3) where it
    has 4, each in a subprocess of its own (one rank a card); the world
    sizes that ran are printed, and where there are too few cards a line
    says so."""
    import torch

    n = torch.cuda.device_count()
    ran = [1]
    for size in (2, 4):
        if n < size:
            print(f"mesh world size {size}: not run, this machine has {n} card(s) "
                  f"(torch.cuda.device_count() = {n}) [{card}]", flush=True)
            continue
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-c", f"from vision_tpu_torch.parallel import dryrun_multichip; "
                              f"dryrun_multichip({size})"], cwd=os.path.dirname(os.path.abspath(__file__)),
                             capture_output=True, text=True, timeout=900)
        print(res.stdout, end="", flush=True)
        if res.returncode != 0:
            raise AssertionError(f"dryrun_multichip({size}) exited {res.returncode}:\n{res.stderr[-4000:]}")
        print(f"mesh world size {size}: dryrun_multichip ran in {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
        ran.append(size)
    print(f"mesh world sizes run: {ran}", flush=True)
    return ran


# phase 46: the training meshes at one NCCL rank
TRAIN_MESH_STEPS = 2  # steps compared, meshed against unmeshed, from one start
TRAIN_MESH_TIMED = 5  # steps timed of each, in turns (host-bound steps: more than phase 38's TRAIN_TIMED)
TRAIN_MESH_COUNTERS = {"esrgan": "conv3x3", "birefnet": "window", "distill": "dequant"}


@contextlib.contextmanager
def deterministic(torch):
    """PyTorch's deterministic algorithms (cuDNN's, index_add's and
    index_put's sorted forms; a warning where an op has none) while the
    block runs: a training step's backward otherwise sums with atomics in
    an order that varies from run to run, so two runs of one step differ in
    their last bits, mesh or not."""
    before = (torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled(),
              torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = before[2], before[3]


def train_mesh_recipe(torch, card: str, label: str, case: tuple, mesh, counts) -> dict:
    """Phase 46 for one recipe's step: the same start on the card on
    ``mesh`` (create_train_state / make_train_step with mesh=) and twice
    unmeshed, TRAIN_MESH_STEPS steps each over the same batches under
    deterministic(): the two unmeshed runs bit-equal to each other (the
    step reproduces), the meshed losses and, after the steps, its parameters
    (gathered) bit-equal to the unmeshed ones, the hand-written launches of
    each step equal and a forward's; then TRAIN_MESH_TIMED steps meshed and
    unmeshed, in turns, timed on the host clock (deterministic() off)."""
    from vision_tpu_torch.core.weights import params_from_numpy
    from vision_tpu_torch.train import adam, create_train_state, full_params, make_train_step

    host, trainable, loss_fn, batches, per = case
    runs = {"meshed": mesh, "unmeshed": None, "again": None}
    states = {r: create_train_state(params_from_numpy(host, TRAIN_DEVICE, torch.float32), adam(TRAIN_LR), mesh=m,
                                    trainable=trainable) for r, m in runs.items()}
    steps = {r: make_train_step(loss_fn, mesh=m) for r, m in runs.items()}
    losses, launches = {r: [] for r in runs}, {r: [] for r in runs}
    with deterministic(torch):
        for i in range(TRAIN_MESH_STEPS):
            for r in runs:
                torch.cuda.synchronize()
                zero_counts()
                states[r], metrics = steps[r](states[r], batches[i % len(batches)])
                torch.cuda.synchronize()
                launches[r].append({k: v for k, v in counts().items() if v})
                losses[r].append(metrics["loss"].detach().clone())
    want = {k: v for k, v in per.items() if v}
    whole = {r: full_params(st.params) for r, st in states.items()}

    def same(a: str, b: str) -> bool:
        return all(torch.equal(x, y) for x, y in zip(losses[a], losses[b])) and all(
            torch.equal(v, whole[b][k]) for k, v in whole[a].items() if isinstance(v, torch.Tensor))

    reproduces, meshed_same = same("again", "unmeshed"), same("meshed", "unmeshed")
    ok_launches = all(x == want for r in runs for x in launches[r])
    del states["again"]
    times = {"meshed": [], "unmeshed": []}
    for i in range(TRAIN_MESH_TIMED):
        for r in times:
            t0 = time.perf_counter()
            states[r], _ = steps[r](states[r], batches[(i + 1) % len(batches)])
            torch.cuda.synchronize()
            times[r].append((time.perf_counter() - t0) * 1e3)
    ms = {r: float(np.median(t)) for r, t in times.items()}
    print(f"train mesh {label} at one rank: {TRAIN_MESH_STEPS} steps under deterministic algorithms, losses "
          f"({', '.join(f'{float(v):.6f}' for v in losses['meshed'])}) and parameters "
          f"{'bit-equal' if meshed_same else 'DIFFER'} meshed against unmeshed (two unmeshed runs "
          f"{'bit-equal' if reproduces else 'DIFFER'}); launches a step {launches['meshed'][0]} meshed, "
          f"{launches['unmeshed'][0]} unmeshed, {want} expected; ms a step (median of {TRAIN_MESH_TIMED}, "
          f"deterministic algorithms off) {ms['meshed']:.3f} meshed, {ms['unmeshed']:.3f} unmeshed "
          f"({ms['meshed'] - ms['unmeshed']:+.3f} ms) [{card}]", flush=True)
    if not (reproduces and meshed_same and ok_launches):
        raise AssertionError(f"train mesh {label}: unmeshed runs equal {reproduces}, meshed equal {meshed_same}, "
                             f"launches {launches} (want {want})")
    del states, whole
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches["meshed"][0], "ms": ms}


def train_mesh_phase(torch, card: str, fd: dict, tmp: str, train: dict) -> dict:
    """Phase 46: the training meshes at one NCCL rank (a world of one joined
    through init_distributed and a file store, then make_mesh(1)): each of
    phase 37's recipe steps meshed against unmeshed (train_mesh_recipe); the
    CLI's ``finetune --dp 1`` (Real-ESRGAN) and ``distill --dp 1 --qlora``
    through cli.main, their GGUFs (and the adapters) byte-equal to the runs
    without --dp; the dry run's step 5 at world 1; a dp-1 meshed SAM bundle
    (export_model of a meshed SamModel, embed_params=False) whose
    call_sharded is bit-equal to the in-process encode, with its launches."""
    import torch.distributed as dist

    from vision_tpu_torch.core.device import backend_init
    from vision_tpu_torch.export import export_model, load_bundle
    from vision_tpu_torch.models.mobile_sam import SamModel, SamParams, sam_load_model
    from vision_tpu_torch.ops.cuda import dequant, window_attention
    from vision_tpu_torch.parallel import init_distributed, make_mesh
    from vision_tpu_torch.parallel.dryrun import train_step_check

    def counts():
        return {**fd["counts"](), "window masked": window_attention.masked_launches, "dequant": dequant.launches}

    phase("46 training meshes at one NCCL rank: each recipe's step meshed against unmeshed, finetune / distill "
          "--dp 1, the dry run's step 5, a meshed SAM bundle's call_sharded")
    kind = "cpu" if TRAIN_DEVICE == "cpu" else "cuda"  # a CPU rehearsal sets TRAIN_DEVICE
    dev = backend_init("cpu" if kind == "cpu" else "gpu")
    init_distributed("file://" + os.path.join(tmp, "train_mesh_store"), 1, 0, device=kind)
    mesh = make_mesh(1, device=kind)
    rows = {"launches": {}, "ms": {}}
    labels = {"esrgan": "Real-ESRGAN", "birefnet": "BiRefNet", "distill": "Depth-Anything distill (QLoRA)"}
    for name, case in train["cases"].items():
        r = train_mesh_recipe(torch, card, labels[name], case, mesh, counts)
        rows["launches"][name], rows["ms"][name] = r["launches"], r["ms"]

    d = os.path.join(tmp, "train_mesh_cli")
    os.makedirs(d, exist_ok=True)
    b, patch = ESRGAN_TRAIN["batch"], ESRGAN_TRAIN["patch"]
    common = ["-i", *train["images"], "--steps", str(TRAIN_STEPS), "--batch", str(b), "--lr", str(TRAIN_LR)]
    runs = {
        "finetune": ["finetune", "-m", fd["paths"]["esrgan"], *common, "--patch", str(patch)],
        "distill": ["distill", "-m", train["teacher"], "--student", fd["paths"]["depthany"], *common, "--size",
                    str(DISTILL_TRAIN["size"]), "--lora", str(DISTILL_TRAIN["lora_rank"]), "--qlora"],
    }
    rows["cli_s"] = {}
    for verb, args in runs.items():  # under deterministic(): each run two steps, compared bit for bit
        outs = {}
        for dp in (["--dp", "1"], []):
            tag = "dp1" if dp else "none"
            out = os.path.join(d, f"{verb}-{tag}.gguf")
            extra = ["--lora-out", os.path.join(d, f"{verb}-{tag}-adapters.gguf")] if verb == "distill" else []
            backend = ["-b", "cpu"] if kind == "cpu" else []
            with deterministic(torch):
                rows["cli_s"][(verb, tag)], stdout = cli_main(args + ["-o", out, *extra, *dp, *backend],
                                                              f"{verb} {' '.join(dp)}")
            if dp and f"dp mesh: 1 rank(s) on {kind}" not in stdout:
                raise AssertionError(f"{verb} --dp 1 made no mesh:\n{stdout}")
            outs[tag] = [out] + [e for e in extra if e.endswith(".gguf")]
        same = all(open(a, "rb").read() == open(b_, "rb").read() for a, b_ in zip(outs["dp1"], outs["none"]))
        print(f"CLI {verb} --dp 1 (cli.main, this process's world of one): {rows['cli_s'][(verb, 'dp1')]:.2f} s, "
              f"without --dp {rows['cli_s'][(verb, 'none')]:.2f} s; its {len(outs['dp1'])} GGUF(s) "
              f"{'byte-equal' if same else 'DIFFER'} [{card}]", flush=True)
        if not same:
            raise AssertionError(f"{verb} --dp 1 wrote other bytes than the run without --dp")

    t0 = time.perf_counter()
    train_step_check(1, 1, dev, kind)
    print(f"the dry run's step 5 at world 1 in {time.perf_counter() - t0:.1f} s [{card}]", flush=True)

    meshed = sam_load_model(fd["paths"]["sam"], dev, mesh=mesh)
    plain = SamModel(meshed.params, SamParams(), dev)
    dst = os.path.join(d, "sam_dp1.vxp")
    t0 = time.perf_counter()
    names = export_model(meshed, dst, batch=1, embed_params=False, entries=("encode",))
    export_s = time.perf_counter() - t0
    bundle = load_bundle(dst)
    x = torch.from_numpy(np.random.default_rng(46).integers(0, 256, (1, 1024, 1024, 3), np.uint8)).to(dev.torch_device)
    zero_counts()
    want = plain.encode_u8(x)
    torch.cuda.synchronize()
    want_n = {k: v for k, v in counts().items() if v}
    bundle.call_sharded("encode", plain.params, x)  # the first call loads the program
    torch.cuda.synchronize()
    zero_counts()
    got = bundle.call_sharded("encode", plain.params, x)
    torch.cuda.synchronize()
    got_n = {k: v for k, v in counts().items() if v}
    same = torch.equal(got, want)
    print(f"meshed SAM bundle {names} (meta mesh {bundle.meta['mesh']}, exported in {export_s:.1f} s): call_sharded "
          f"{'bit-equal to' if same else 'DIFFERS from'} the in-process encode_u8; launches {got_n}, in process "
          f"{want_n} [{card}]", flush=True)
    if not same or got_n != want_n or bundle.meta["mesh"]["dp"] != 1:
        raise AssertionError(f"meshed SAM bundle: equal {same}, launches {got_n} / {want_n}")
    rows["sam_bundle"] = got_n
    del meshed, plain, bundle
    dist.destroy_process_group()  # before tmp and its store go
    return rows


def mesh_phases(torch, card: str, fd: dict, tmp: str, sam3_models: tuple, fa, wa, dcm) -> dict:
    """Phases 43-45 (the meshes of parallel/)."""
    phase("43 meshes at one NCCL rank: each family's meshed loader and server against its unmeshed model, --dp 1")
    t0 = time.perf_counter()
    served = mesh_one_rank(torch, card, fd, sam3_models, tmp)
    t1 = time.perf_counter()
    phase("44 the kernels at the shapes a tensor- or data-parallel shard gives them")
    shards = mesh_shard_kernels(torch, card, fa, wa, dcm)
    t2 = time.perf_counter()
    phase("45 more ranks where the machine has the cards")
    ran = mesh_more_ranks(card)
    print(f"mesh phases: 43 {t1 - t0:.1f} s, 44 {t2 - t1:.1f} s, 45 {time.perf_counter() - t2:.1f} s [{card}]",
          flush=True)
    return {"served": served, "shards": shards, "world_sizes": ran}


# phase 47: SAM3's window-major trunk at full width, and its sp / pp paths at one NCCL rank
# two bf16 evaluations of the 32-layer trunk in other orders differ by about
# bf16's own error at full depth (phase 20 reads ~1.4e-2 for bf16 against
# f32), so a bf16 trunk is held to the bf16 end-to-end bound; the trunks'
# equivalence is the f32 comparison's (SAM3_F32_REL_RMS)
SAM3_TRUNK_BF16_REL_RMS = E2E_REL_RMS
SAM3_PIPELINE_IMAGES = 2  # microbatches of encode_vision_pipelined at pp 1


def kernel_counts() -> dict:
    """Every hand-written kernel's launch count since the last zero_counts()."""
    from vision_tpu_torch.ops.cuda import conv3x3, deform_conv, deform_sample, dequant, flash_attention
    from vision_tpu_torch.ops.cuda import window_attention

    return {"flash": flash_attention.launches, "window": window_attention.launches, "conv3x3": conv3x3.launches,
            "deform_conv": deform_conv.launches, "deform_sample": deform_sample.launches, "dequant": dequant.launches}


def sam3_scan_phase(torch, card: str, s3: dict, tmp: str) -> dict:
    """Phase 47: phase 19's ViT-H model, whose encode_vision runs the
    window-major trunk: the stack's memory (phase 19's reading); 4 flash
    launches and no other hand-written kernel an encode at 1008^2 and
    1600x1200; the window-major trunk against the spatial trunk on the same
    weights (the flat window weights as views of the stack), bf16 within
    SAM3_TRUNK_BF16_REL_RMS and f32 (the CPU model's weights, TF32 off)
    within SAM3_F32_REL_RMS; both trunks' eager median ms in turns and a
    profile of each (busy, idle, launches). Then at one NCCL rank (a world
    of one, init_distributed): a Sam3Model on a make_mesh(1, sp=1) mesh
    bit-equal to the unmeshed model with its launches;
    encode_vision_pipelined on a pp-1 mesh over SAM3_PIPELINE_IMAGES images
    from sam3_pipeline_weights and from the stack, against the window-major
    trunk; and the dry run's SAM3 tp / sp / pp checks at world 1."""
    import torch.distributed as dist

    from vision_tpu_torch.core.device import backend_init
    from vision_tpu_torch.core.params import Params
    from vision_tpu_torch.models.sam3 import (Sam3Model, encode_vision, encode_vision_pipelined, sam3_pipeline_weights,
                                              sam3_process_input)
    from vision_tpu_torch.parallel import init_distributed, make_mesh
    from vision_tpu_torch.parallel.dryrun import sam3_checks
    from vision_tpu_torch.parallel.sharding import mesh_shape

    phase("47 SAM3's window-major trunk at full width against the spatial one; sp / pp at one NCCL rank")
    t_start = time.perf_counter()
    model, cpu_model = s3["models"]
    vp, imgs, m = model.vp, s3["images"], s3["stack_mib"]
    print(f"window stack (phase 19): allocated {m['before']:.1f} MiB before it was built, {m['after']:.1f} MiB after, "
          f"peak {m['peak']:.1f}: the {m['flat']:.1f} MiB of flat window copies freed "
          f"({m['before'] + m['flat'] - m['after']:.1f} MiB net of the stack) [{card}]", flush=True)
    want = {"flash": len(vp.global_attn_indexes), "window": 0, "conv3x3": 0, "deform_conv": 0, "deform_sample": 0,
            "dequant": 0}
    launches = 0
    for img in imgs:
        zero_counts()
        model.encode_vision(img)
        torch.cuda.synchronize()
        got = kernel_counts()
        if got != want:
            raise AssertionError(f"window-major encode_vision {img.extent}: launches {got} (expected {want})")
        launches += got["flash"]
    print(f"Sam3Model.encode_vision (window-major trunk) at {' and '.join(f'{w}x{h}' for w, h in SAM3_EXTENTS)}: "
          f"launches {want} each [{card}]", flush=True)

    x = torch.from_numpy(sam3_process_input(imgs[0], vp.image_size)[None]).cuda()
    layers = model._window_layers()
    twin = sam3_spatial_twin(model.params, vp)

    def scan(params, xx, views=None):
        return encode_vision(Params(params)["det.ve"], xx, vp, flash=True,
                             win_stack=views if views is not None else sam3_stack(params)).fpn_hidden_states

    def spatial(params, xx):
        return encode_vision(Params(params)["det.ve"], xx, vp, flash=True).fpn_hidden_states

    def worst(outs, refs):
        return max(rel_rms_t(a.float(), b.float()) for a, b in zip(outs, refs))

    with torch.inference_mode():
        f32 = {k: v.cuda() for k, v in cpu_model.params.items() if k.startswith("det.ve.")}
        ref = scan(f32, x.float())
        rms = {"f32": worst(ref, spatial(sam3_spatial_twin(f32, vp), x.float()))}
        del f32
        bf16 = {"window-major": scan(model.params, x.bfloat16(), layers), "spatial": spatial(twin, x.bfloat16())}
        rms["bf16"] = worst(bf16["window-major"], bf16["spatial"])
        rms.update({f"bf16 {k} vs f32": worst(v, ref) for k, v in bf16.items()})
    del ref, bf16
    torch.cuda.empty_cache()
    ok = (rms["f32"] <= SAM3_F32_REL_RMS and rms["bf16"] <= SAM3_TRUNK_BF16_REL_RMS
          and max(rms["bf16 window-major vs f32"], rms["bf16 spatial vs f32"]) <= SAM3_TRUNK_BF16_REL_RMS)
    print(f"window-major vs spatial trunk + neck at {vp.image_size}x{vp.image_size}, worst level, relative RMS: f32 "
          f"(TF32 off) {rms['f32']:.4e} (bound {SAM3_F32_REL_RMS}); bf16 {rms['bf16']:.4e}, each bf16 trunk against "
          f"the f32 window-major one: window-major {rms['bf16 window-major vs f32']:.4e}, spatial "
          f"{rms['bf16 spatial vs f32']:.4e} (bound {SAM3_TRUNK_BF16_REL_RMS}): {'ok' if ok else 'FAIL'} [{card}]",
          flush=True)
    if not ok:
        raise AssertionError(f"window-major against spatial trunk: {rms}")

    xb = x.bfloat16()
    runs = {"window-major": lambda: scan(model.params, xb, layers), "spatial": lambda: spatial(twin, xb)}
    with torch.inference_mode():
        ms = {name: [] for name in runs}
        for name in ("window-major", "spatial", "spatial", "window-major"):
            ms[name].append(median_ms(runs[name], 5, warmup=2))
        prof = {name: profile_run(run, f"{name} encode_vision batch 1 at {vp.image_size}^2 (eager)", torch, card,
                                  ("flash_attention",)) for name, run in runs.items()}
    total = {name: p["other_launches"] + p["named_launches"]["flash_attention"] for name, p in prof.items()}
    side = f"{vp.image_size}x{vp.image_size}"
    print(f"eager encode_vision batch 1 at {side} bf16: window-major {ms['window-major'][0]:.3f} / "
          f"{ms['window-major'][1]:.3f} ms, spatial {ms['spatial'][0]:.3f} / {ms['spatial'][1]:.3f} ms; busy "
          f"{prof['window-major']['busy_ms']:.3f} vs {prof['spatial']['busy_ms']:.3f} ms "
          f"({prof['window-major']['busy_ms'] - prof['spatial']['busy_ms']:+.3f}), launches {total['window-major']} vs "
          f"{total['spatial']} ({total['window-major'] - total['spatial']:+d}) [{card}]", flush=True)
    t_trunks = time.perf_counter() - t_start

    dev = backend_init("gpu")
    init_distributed("file://" + os.path.join(tmp, "sam3_mesh_store"), 1, 0)
    mesh = make_mesh(1, sp=1)
    meshed = Sam3Model(model.params, model.tokenizer, model.max_tokens, dev, vp=vp, mesh=mesh)
    zero_counts()
    a = meshed.encode_vision(imgs[0])
    torch.cuda.synchronize()
    mesh_n = kernel_counts()
    b = model.encode_vision(imgs[0])
    same = all(torch.equal(u, v) for u, v in zip(a, b))
    print(f"Sam3Model on {mesh_shape(mesh)} at one NCCL rank: encode_vision {'bit-equal' if same else 'DIFFERS'} to "
          f"the unmeshed model's; launches {mesh_n} [{card}]", flush=True)
    if not same or mesh_n != want:
        raise AssertionError(f"sp-1 meshed SAM3: equal {same}, launches {mesh_n}")
    del meshed, a, b

    pmesh = make_mesh(1, pp=1)
    xs = torch.from_numpy(np.stack([sam3_process_input(im, vp.image_size) for im in
                                    (imgs * SAM3_PIPELINE_IMAGES)[:SAM3_PIPELINE_IMAGES]])).cuda().bfloat16()
    stage_w = sam3_pipeline_weights(Params(model.params)["det.ve.backbone"], sam3_stack(model.params), vp, pmesh)
    pipe = {}
    with torch.inference_mode():
        ref = scan(model.params, xs, layers)
        for form, kw in (("stage_weights", {"stage_weights": stage_w}), ("win_stack", {"win_stack": sam3_stack(
                model.params)})):
            zero_counts()
            out = encode_vision_pipelined(Params(model.params)["det.ve"], xs, vp, flash=True, mesh=pmesh,
                                          **kw).fpn_hidden_states
            torch.cuda.synchronize()
            pipe[form] = (max(rel_rms_t(u.float(), v.float()) for u, v in zip(out, ref)), kernel_counts()["flash"])
    del stage_w, ref, out
    torch.cuda.empty_cache()
    ok = all(r <= SAM3_TRUNK_BF16_REL_RMS and n == SAM3_PIPELINE_IMAGES * len(vp.global_attn_indexes)
             for r, n in pipe.values())
    print(f"encode_vision_pipelined on {mesh_shape(pmesh)} over {SAM3_PIPELINE_IMAGES} images, against the "
          f"window-major trunk (bf16, worst level): " + "; ".join(f"from {k} relative RMS {r:.4e}, {n} flash launches"
                                                                  for k, (r, n) in pipe.items())
          + f" (bound {SAM3_TRUNK_BF16_REL_RMS}): {'ok' if ok else 'FAIL'} [{card}]", flush=True)
    if not ok:
        raise AssertionError(f"pp-1 pipelined SAM3: {pipe}")
    t0 = time.perf_counter()
    ran = sam3_checks(1, 1, dev, "cuda")
    print(f"the dry run's SAM3 tp / sp / pp checks at world 1 ({' / '.join(str(r) for r in ran)}) in "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    dist.destroy_process_group()  # before tmp and its store go
    print(f"phase 47: {time.perf_counter() - t_start:.1f} s (the trunks {t_trunks:.1f} s) [{card}]", flush=True)
    return {"launches": launches, "rel_rms": rms, "ms": {k: min(v) for k, v in ms.items()},
            "busy_ms": {k: p["busy_ms"] for k, p in prof.items()}, "total_launches": total,
            "pipelined": {k: {"rel_rms": r, "flash_launches": n} for k, (r, n) in pipe.items()},
            "mesh_sp1_launches": mesh_n, "stack_mib": m}



# phase 48, vision-bench (vision_tpu_torch/benchmark.py): each row's
# hand-written launches a step, under the benchmark's names (the window
# kernel's masked launches as "window_attention masked")
BENCH_KERNELS = {
    "sam-encode-1024": {"window_attention": 10},  # TinyViT's windowed blocks, as phase 7 counts a batch
    "sam-decode": {},
    "esrgan-512": {"conv3x3": ESRGAN_CONVS},
    "esrgan-1024": {"conv3x3": ESRGAN_CONVS},
    "depthany-small": {"flash_attention": 12},
    "depthany-base": {"flash_attention": 12},
    "migan-512": {},
    "yolov9t-640": {"conv3x3": YOLO_CONVS},
    # SWIN-T's 12 blocks at both scales, the shifted half masked
    "birefnet-1024": {"window_attention": 24, "window_attention masked": 12, "deform_conv": BIREF_DEFORMS},
    "birefnet-full-1024": {"window_attention": BIREF_WINDOWS, "window_attention masked": BIREF_MASKED,
                           "deform_conv": BIREF_DEFORMS},
    "sam3-vision-1008": {"flash_attention": 4},  # the four global layers
}
BENCH_K, BENCH_REPEATS = 8, 3  # graph replays a timed repeat, repeats a row
# the rows whose kernels run at shapes no served path gives them, each
# row's forward on the card in these dtypes against the CPU's f32 forward,
# within these relative-RMS bounds: SWIN-T BiRefNet (the window and fused
# deformable conv kernels at SWIN-T's widths; f32 the FMA kernels, bf16 the
# rows' own) and Depth-Anything at 518x714 (flash at T 1888, 6 and 12 heads)
BENCH_PARITY = {
    "birefnet-1024": (("float32", BIREF_F32_REL_RMS), ("bfloat16", E2E_REL_RMS)),
    "depthany-small": (("bfloat16", E2E_REL_RMS),),
    "depthany-base": (("bfloat16", E2E_REL_RMS),),
}
BENCH_CLI_ROW = "yolov9t-640"  # the row the bench verb runs as a subprocess


def bench_launches(row: dict) -> dict:
    """A row's capture tally without the kernels it launched no time."""
    return {k: n for k, n in row["launches"].items() if n}


def bench_counts() -> dict:
    """kernel_counts() since the last zero_counts() under the benchmark's
    kernel names (the window kernel's masked launches as "window_attention
    masked"), without the kernels launched no time."""
    from vision_tpu_torch.ops.cuda import window_attention

    names = {"flash": "flash_attention", "window": "window_attention"}
    got = {names.get(k, k): n for k, n in kernel_counts().items()}
    got["window_attention masked"] = window_attention.masked_launches
    return {k: n for k, n in got.items() if n}


def bench_rows(rows: list, kernel: str) -> dict:
    """row -> ``kernel``'s launches in one vision-bench step (phase 48's
    rows), for the kernels line; raises unless that is every row and count
    BENCH_KERNELS gives the kernel."""
    got = {r["name"]: r["launches"][kernel] for r in rows if r["launches"].get(kernel)}
    want = {name: n[kernel] for name, n in BENCH_KERNELS.items() if kernel in n}
    if got != want:
        raise AssertionError(f"{kernel}'s vision-bench launches {got}, expected {want}")
    return got


def bench_forward(torch, name: str, device: str, dtype):
    """BENCHMARKS[name]'s forward (the step before its sum) once on
    ``device`` in ``dtype``: its output in f32 on the host, the
    hand-written launches it made (bench_counts) and its seconds."""
    from vision_tpu_torch.benchmark import BENCHMARKS
    from vision_tpu_torch.core.device import backend_init

    step, params, x = BENCHMARKS[name](backend_init(device), dtype)
    zero_counts()
    with torch.inference_mode():
        t0 = time.perf_counter()
        out = step.forward(params, x)
        if device == "gpu":
            torch.cuda.synchronize()
        s = time.perf_counter() - t0
    return out.float().cpu().numpy(), bench_counts(), s


def bench_parity(torch, card: str) -> dict:
    """Phase 48's parity: each BENCH_PARITY row's forward on the card in
    each of its dtypes (kernel routes, TF32 off) against the same forward in
    f32 on the CPU (plain routes), within its bound and with the row's
    BENCH_KERNELS launches. Returns "<row> <dtype>" -> relative RMS."""
    parity = {}
    for name, forms in BENCH_PARITY.items():
        cpu_out, _, cpu_s = bench_forward(torch, name, "cpu", torch.float32)
        for dtype_name, bound in forms:
            out, got, _ = bench_forward(torch, name, "gpu", getattr(torch, dtype_name))
            finite = bool(np.isfinite(out).all())
            rms = rel_rms(out, cpu_out)
            parity[f"{name} {dtype_name}"] = rms
            ok = finite and out.shape == cpu_out.shape and got == BENCH_KERNELS[name] and rms <= bound
            print(f"{name} forward {dtype_name} on the card (kernel routes, TF32 off, launches {got}) vs the CPU's "
                  f"f32 (plain routes, {cpu_s:.1f} s): relative RMS {rms:.4e} (bound {bound}); shape {out.shape}, "
                  f"range [{float(out.min()):.4f}, {float(out.max()):.4f}]: {'ok' if ok else 'FAIL'} [{card}]",
                  flush=True)
            if not ok:
                raise AssertionError(f"{name} {dtype_name} parity: relative RMS {rms}, launches {got}, finite "
                                     f"{finite}, shape {out.shape} vs {cpu_out.shape}")
            del out
            gc.collect()
            torch.cuda.empty_cache()
    return parity


def bench_phase(torch, card: str) -> dict:
    """Phase 48: vision-bench (run_benchmark) over its eleven rows on the
    card, in process: the table, each row's mean and stdev finite and the
    mean above 0, GFLOP above 0, MFU at most 1, the capture's hand-written
    launches equal to BENCH_KERNELS (run_benchmark itself raises where a
    step does not capture or a replay is not bit-equal to the eager step;
    this checks the values it returns too); then each BENCH_PARITY row's
    forward on the card in each of its dtypes (kernel routes, TF32 off)
    against the same forward in f32 on the CPU (plain routes) within its
    bound, with BENCH_KERNELS' launches; and the bench verb as a subprocess
    over BENCH_CLI_ROW, its JSON line."""
    from vision_tpu_torch.benchmark import BENCHMARKS, print_rows, run_benchmark

    phase(f"48 vision-bench: the {len(BENCHMARKS)} rows as CUDA-graph replays timed by CUDA events, TF/s and MFU; "
          f"{', '.join(BENCH_PARITY)} on the card vs the CPU's f32; the bench verb")
    t_start = time.perf_counter()
    print(card, flush=True)
    rows = run_benchmark(k=BENCH_K, repeats=BENCH_REPEATS)
    print_rows(rows)
    bad = []
    for r in rows:
        print(f"{r['name']}: mean {r['mean_ms']:.4f} ms, stdev {r['stdev_ms']:.4f} ms over {BENCH_REPEATS} repeats "
              f"of {r['k']} replays, {r['gflop']:.3f} GFLOP, {r['tf_per_sec']:.2f} TF/s, MFU "
              f"{'unknown card' if r['mfu'] is None else format(r['mfu'], '.4%')}, launches {bench_launches(r)}, "
              f"step value {r['value']!r} (eager and replay alike) [{card}]", flush=True)
        ok = (np.isfinite(r["mean_ms"]) and np.isfinite(r["stdev_ms"]) and r["mean_ms"] > 0 and r["gflop"] > 0
              and np.isfinite(r["value"]) and bench_launches(r) == BENCH_KERNELS[r["name"]])
        if not ok:
            bad.append(r["name"])
        if r["mfu"] is not None and r["mfu"] > 1.0:
            raise AssertionError(f"{r['name']}: MFU {r['mfu']} above 1 ({r['gflop']} GFLOP in {r['mean_ms']} ms)")
    if [r["name"] for r in rows] != list(BENCHMARKS) or bad:
        raise AssertionError(f"vision-bench rows {[r['name'] for r in rows]}; failing {bad}")
    t_rows = time.perf_counter() - t_start

    parity = bench_parity(torch, card)

    wall_s, out = cli_run(["bench", "--bench-args", BENCH_CLI_ROW, "--json"], f"bench {BENCH_CLI_ROW}")
    rec = json.loads(out.strip().splitlines()[-1])
    print(f"python -m vision_tpu_torch.cli bench --bench-args {BENCH_CLI_ROW} --json: {rec} ({wall_s:.1f} s, "
          f"interpreter start and row included) [{card}]", flush=True)
    if not (rec["metric"] == BENCH_CLI_ROW and rec["unit"] == "ms/iter" and rec["value"] > 0 and rec["gflop"] > 0
            and 0 < rec.get("mfu", 0) <= 1.0):
        raise AssertionError(f"bench verb's JSON line: {rec}")
    print(f"phase 48: {time.perf_counter() - t_start:.1f} s (the rows {t_rows:.1f} s) [{card}]", flush=True)
    return {"rows": rows, "parity_rel_rms": parity, "cli": rec}


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", metavar="DIR", help="only time the attention and conv kernels and the Real-ESRGAN "
                        "and BiRefNet forwards of the port's checkout at DIR against this checkout's "
                        "(compare_with_parent), after phases 1 and 2")
    args = parser.parse_args(argv)

    phase("1 environment")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs a CUDA card",
              file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from vision_tpu_torch.core.device import backend_init
    from vision_tpu_torch.image import Image, ImageFormat
    from vision_tpu_torch.models.depth_anything import depthany_load_model
    from vision_tpu_torch.models.mobile_sam import (
        best_masks,
        sam_load_model,
        sam_process_input_u8,
        sam_process_mask,
        sam_process_point,
    )
    from vision_tpu_torch.models.birefnet import birefnet_load_model
    from vision_tpu_torch.models.esrgan import esrgan_load_model
    from vision_tpu_torch.ops.cuda import build
    from vision_tpu_torch.ops.cuda import conv3x3 as cc
    from vision_tpu_torch.ops.cuda import deform_conv as dcm
    from vision_tpu_torch.ops.cuda import deform_sample as dsm
    from vision_tpu_torch.ops.cuda import dequant as dqm
    from vision_tpu_torch.ops.cuda import flash_attention as fa
    from vision_tpu_torch.ops.cuda import window_attention as wa
    from vision_tpu_torch.serve import EsrganServer, ImageServer, SamServer

    phase("2 build")
    t0 = time.perf_counter()
    build.load_library()
    print(f"kernel library {build.library_path().name}: ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.build_info['seconds']:.2f} s)", flush=True)
    for line in build.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line or "Potential" in line:
            print("ptxas:", line.strip())
    if args.parent:
        phase(f"A/B the attention and conv kernels and the Real-ESRGAN and BiRefNet forwards of {args.parent} "
              "against this checkout's")
        compare_with_parent(args.parent, torch, card)
        return 0

    phase("3 kernels against their plain versions")
    worst = kernel_cases(fa, torch)
    win_worst = window_cases(wa, torch)
    window_plan_cases(wa, build)
    build_s = build.build_info["seconds"]

    phase("4 Depth-Anything path: Depth-Anything-V2-Small through ImageServer")
    rng = np.random.default_rng(0)

    def u8_img(h, w):
        return Image(rng.integers(0, 256, (h, w, 4), np.uint8), ImageFormat.rgba_u8)

    (w_sq, h_sq), (w_wide, h_wide) = DEPTH_EXTENTS
    requests = [u8_img(h_sq, w_sq) for _ in range(5)] + [u8_img(h_wide, w_wide) for _ in range(3)]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "depth-anything-v2-small-random.gguf")
        write_small_gguf(path)
        model = depthany_load_model(path, backend_init("gpu"))
        cpu_model = depthany_load_model(path, backend_init("cpu"))
    print(f"model on {model.device.torch_device} {model.dtype}, flash={model.flash}", flush=True)
    with ImageServer(model, batch_size=4, max_delay_ms=20) as srv:
        srv.warmup()
        srv.warmup((w_wide, h_wide))  # each bucket's graph is captured before the counted run
        zero_counts()
        t_start = time.perf_counter()
        futures = [srv.submit(img) for img in requests]
        results = [f.result(timeout=600) for f in futures]
        wall_s = time.perf_counter() - t_start
        main_launches, depth_win_launches, depth_conv_launches = fa.launches, wa.launches, cc.launches
        other_deform = {"Depth-Anything": (dsm.launches, dcm.launches)}
        stats = srv.stats
        n_req, n_batches = stats.requests, stats.batches
        p50_ms = stats.p50_latency_ms
    for img, res in zip(requests, results):
        d = res.data
        if res.extent != img.extent or res.format != ImageFormat.alpha_f32:
            raise AssertionError(f"result {res.extent} {res.format} for request {img.extent}")
        # min-max normalized: [0, 1] exactly at the processed extent; a result
        # resampled back to its request's extent carries the stb filters'
        # ringing (Catmull-Rom/Mitchell, unclamped like the reference's float
        # resize), a few hundredths at most
        ring = 0.0 if img.extent == (518, 518) else RESAMPLE_RING
        if not (np.isfinite(d).all() and d.min() >= -ring and d.max() <= 1.0 + ring and d.max() > d.min()):
            raise AssertionError(f"result for {img.extent}: range [{d.min()}, {d.max()}]")
    if n_req != 8:
        raise AssertionError(f"stats.requests {n_req}")
    if (main_launches == 0 or main_launches != 12 * n_batches or depth_win_launches != 0
            or depth_conv_launches != 0):
        raise AssertionError(f"flash_attention launches {main_launches} for {n_batches} batches of 12 layers, "
                             f"window_attention launches {depth_win_launches}, conv3x3 launches "
                             f"{depth_conv_launches}")
    print(f"served {n_req} requests in {n_batches} batches; flash_attention launches {main_launches}, "
          f"window_attention launches {depth_win_launches}, conv3x3 launches {depth_conv_launches}", flush=True)

    phase("5 Depth-Anything parity: card bf16 (kernel route) vs CPU f32 (plain route)")
    x = torch.from_numpy(requests[0].to_rgb_u8()[None])
    gpu_depth = model.forward_u8(x).float().cpu().numpy()
    cpu_depth = cpu_model.forward_u8(x).float().numpy()
    if gpu_depth.shape != (1, 518, 518, 1) or not np.isfinite(gpu_depth).all():
        raise AssertionError(f"forward_u8 gave {gpu_depth.shape}")
    depth_rms = rel_rms(gpu_depth, cpu_depth)
    print(f"depth relative RMS card vs CPU: {depth_rms:.4e} (bound {E2E_REL_RMS})", flush=True)
    if not depth_rms <= E2E_REL_RMS:
        raise AssertionError(f"end-to-end relative RMS {depth_rms}")

    phase(f"6 Depth-Anything timings on {card}")
    gen = torch.Generator(device="cuda").manual_seed(1)
    timings = []
    for t in (depth_tokens(e) for e in DEPTH_EXTENTS):
        q, k, v = (torch.randn(4, 6, t, 64, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(3))
        run_k = lambda: fa.flash_attention(q, k, v)  # noqa: E731
        run_p = lambda: fa.flash_attention_plain(q, k, v, 64**-0.5)  # noqa: E731
        k1, p1, k2, p2 = (device_ms(f) for f in (run_k, run_p, run_k, run_p))
        timings.append((t, min(k1, k2), min(p1, p2)))
        print(f"flash_attention (24, {t}, 64) bf16 on the card: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / "
              f"{p2:.4f} ms; per call with the host's launch work: kernel {median_ms(run_k, 20):.4f} ms [{card}]",
              flush=True)
    xb = torch.from_numpy(np.stack([r.to_rgb_u8() for r in requests[:4]]))
    fwd_ms = median_ms(lambda: model.forward_u8(xb), 5, warmup=2)
    print(f"forward_u8 batch 4 at 518x518 bf16: median {fwd_ms:.3f} ms [{card}]", flush=True)
    profile_forward(model, torch.from_numpy(np.stack([r.to_rgb_u8() for r in requests[:4]])), torch, card,
                    ("flash_attention",))
    print(f"ImageServer 8 requests (5 at 518x518, 3 at 700x500): p50 latency {p50_ms:.3f} ms, "
          f"{8 / wall_s:.3f} img/s [{card}]", flush=True)
    del model, cpu_model

    phase("7 MobileSAM path: TinyViT-5M + SAM decoder through SamServer")
    srng = np.random.default_rng(3)
    sam_reqs = sam_requests(srng, Image, ImageFormat)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mobile-sam-random.gguf")
        write_sam_gguf(path)
        smodel = sam_load_model(path, backend_init("gpu"))
        cpu_smodel = sam_load_model(path, backend_init("cpu"))
    print(f"model on {smodel.device.torch_device} {smodel.dtype}, flash={smodel.flash}", flush=True)
    with SamServer(smodel, batch_size=6, max_delay_ms=5_000) as ssrv:
        ssrv.warmup()
        zero_counts()
        t_start = time.perf_counter()
        futures = [ssrv.submit(img, point=pt, box=bx) for img, pt, bx in sam_reqs]
        masks = [f.result(timeout=600) for f in futures]
        sam_wall_s = time.perf_counter() - t_start
        sam_win_launches, sam_flash_launches, sam_conv_launches = wa.launches, fa.launches, cc.launches
        other_deform["MobileSAM"] = (dsm.launches, dcm.launches)
        sstats = ssrv.stats
        s_req, s_batches, s_p50 = sstats.requests, sstats.batches, sstats.p50_latency_ms
    for (img, _, _), m in zip(sam_reqs, masks):
        if m.extent != img.extent or m.format != ImageFormat.alpha_u8 or not set(np.unique(m.data)) <= {0, 255}:
            raise AssertionError(f"mask {m.extent} {m.format} for request {img.extent}")
    if s_req != 12:
        raise AssertionError(f"stats.requests {s_req}")
    if (sam_win_launches == 0 or sam_win_launches != 10 * s_batches or sam_flash_launches != 0
            or sam_conv_launches != 0):
        raise AssertionError(f"window_attention launches {sam_win_launches} for {s_batches} encoder batches "
                             f"of 10 windowed blocks, flash_attention launches {sam_flash_launches}, conv3x3 "
                             f"launches {sam_conv_launches}")
    print(f"served {s_req} requests in {s_batches} batches; window_attention launches {sam_win_launches}, "
          f"flash_attention launches {sam_flash_launches}, conv3x3 launches {sam_conv_launches}; mask foreground shares "
          f"{[round(float((m.data > 0).mean()), 4) for m in masks]}", flush=True)

    phase("8 MobileSAM parity: card bf16 (kernel route) vs CPU f32 (plain route)")
    img, pt, _ = sam_reqs[2]  # a 1600x1200 point request (downscaled)
    x = torch.from_numpy(sam_process_input_u8(img)[None])
    coords = sam_process_point(pt, img.extent)[None]
    gpu_stages = encoder_stages(smodel.params, x, smodel.dtype, "cuda")
    cpu_stages = encoder_stages(cpu_smodel.params, x, torch.float32, "cpu")
    for (name, g), (_, c) in zip(gpu_stages, cpu_stages):
        print(f"stage {name}: relative RMS card bf16 vs CPU f32 {rel_rms(g.float().cpu(), c):.4e}", flush=True)
    g_embed, c_embed = gpu_stages[-1][1], cpu_stages[-1][1]
    embed_rms = rel_rms(g_embed.float().cpu(), c_embed)
    g_pred = smodel.decode(g_embed, coords, "point")
    c_pred = cpu_smodel.decode(c_embed, coords, "point")
    g_masks, c_masks = g_pred.masks.float().cpu().numpy(), c_pred.masks.numpy()
    if g_masks.shape != (1, 4, 256, 256) or g_pred.masks.dtype != torch.float32 or not np.isfinite(g_masks).all():
        raise AssertionError(f"masks {g_masks.shape} {g_pred.masks.dtype}")
    mask_rms = rel_rms(g_masks, c_masks)
    agree = float(((g_masks > 0) == (c_masks > 0)).mean())
    iou_diff = (g_pred.iou.float().cpu().numpy() - c_pred.iou.numpy())[0]
    print(f"embedding relative RMS {embed_rms:.4e} (bound {SAM_EMBED_REL_RMS}); 4 mask logits relative RMS "
          f"{mask_rms:.4e} (bound {SAM_MASK_REL_RMS}); thresholded pixels agreeing {agree:.6f}; IoU card - CPU "
          f"{[float(d) for d in iou_diff]}", flush=True)
    if not (embed_rms <= SAM_EMBED_REL_RMS and mask_rms <= SAM_MASK_REL_RMS):
        raise AssertionError(f"MobileSAM bf16 parity: embedding {embed_rms}, masks {mask_rms}")
    f32_params = {k: v.to("cuda") for k, v in cpu_smodel.params.items()}
    before = wa.launches
    f32_embed = encoder_stages(f32_params, x, torch.float32, "cuda")[-1][1]
    f32_launches = wa.launches - before
    f32_rms = rel_rms(f32_embed.cpu(), c_embed)
    print(f"encoder f32 on the card (kernel route, {f32_launches} window launches, TF32 off) vs CPU f32: "
          f"relative RMS {f32_rms:.4e} (bound {SAM_F32_REL_RMS})", flush=True)
    if f32_launches != 10 or not f32_rms <= SAM_F32_REL_RMS:
        raise AssertionError(f"f32 encoder on the card: relative RMS {f32_rms}, {f32_launches} launches")
    del cpu_smodel, f32_params

    phase(f"9 MobileSAM timings on {card}")
    win_times = []
    for i, (nw, t, h) in enumerate(SAM_STAGES):
        q, k, v = (torch.randn(6 * nw, t, h * 32, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(3))
        bias = (torch.randn(h, t, t, device="cuda", generator=gen) * 0.5).to(torch.bfloat16)
        run_k = lambda: wa.window_attention(q, k, v, bias, h, 32**-0.5)  # noqa: E731
        run_p = lambda: wa.window_attention_plain(q, k, v, bias, h, 32**-0.5)  # noqa: E731
        k1, p1, k2, p2 = (device_ms(f) for f in (run_k, run_p, run_k, run_p))
        win_times.append((f"({6 * nw}, {t}, {h * 32}) bf16, H={h}", min(k1, k2), min(p1, p2)))
        print(f"window_attention stage {i + 1} (NW={6 * nw}, T={t}, H={h}, hd=32) bf16 on the card: kernel "
              f"{k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms; per call with the host's launch work: kernel "
              f"{median_ms(run_k, 20):.4f} ms [{card}]", flush=True)
    base = np.stack([sam_process_input_u8(r[0]) for r in sam_reqs[:8]])
    for b in (1, 2, 4, 6, 8):
        xb = torch.from_numpy(base[:b]).to("cuda")
        enc_ms = median_ms(lambda: smodel.encode_u8(xb), 20, warmup=3)
        print(f"encode (encode_batch's forward) batch {b} at 1024x1024 bf16: median {enc_ms:.3f} ms, "
              f"{b / enc_ms * 1e3:.3f} img/s [{card}]", flush=True)
    x1 = torch.from_numpy(base[:1]).to("cuda")
    pt_coords = np.array([[[0.1, 0.2], [0.0, 0.0]]], np.float32)

    def one_mask():
        return best_masks(smodel.decode(smodel.encode_u8(x1), pt_coords, "point"))

    mask_ms = median_ms(one_mask, 21, warmup=3)
    embed1 = smodel.encode_u8(x1)
    dec_ms = median_ms(lambda: best_masks(smodel.decode(embed1, pt_coords, "point")), 21, warmup=3)
    print(f"single mask (u8 1024x1024 -> encode -> point -> decode -> best mask) bf16: p50 {mask_ms:.3f} ms "
          f"over 21 runs [{card}]", flush=True)
    print(f"decode only, one point prompt: median {dec_ms:.3f} ms [{card}]", flush=True)
    print(f"SamServer 12 requests (6 points, 6 boxes; 1024x1024, 640x480, 1600x1200): p50 latency "
          f"{s_p50:.3f} ms, {12 / sam_wall_s:.3f} img/s, {s_batches} batches [{card}]", flush=True)
    fake_masks = np.random.default_rng(5).standard_normal((1, 256, 256)).astype(np.float32)
    for r in sam_reqs[:3]:
        t0 = time.perf_counter()
        sam_process_input_u8(r[0])
        t1 = time.perf_counter()
        sam_process_mask(fake_masks, 0, r[0].extent)
        t2 = time.perf_counter()
        print(f"host per request at {r[0].extent[0]}x{r[0].extent[1]}: prep (sam_process_input_u8) "
              f"{(t1 - t0) * 1e3:.3f} ms, post (sam_process_mask) {(t2 - t1) * 1e3:.3f} ms [{card}]", flush=True)

    del smodel, embed1

    phase("10 conv3x3 kernel against its plain version")
    conv_worst = conv_cases(cc, torch)

    phase("11 Real-ESRGAN path: RealESRGAN-x4 RRDBNet through EsrganServer and the tiled compute")
    erng = np.random.default_rng(6)
    esr_reqs = [u8_img(256, 256) for _ in range(4)] + [u8_img(240, 320) for _ in range(2)]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "realesrgan-x4-random.gguf")
        write_esrgan_gguf(path)
        emodel = esrgan_load_model(path, backend_init("gpu"))
        cpu_emodel = esrgan_load_model(path, backend_init("cpu"))
    print(f"model on {emodel.device.torch_device} {emodel.dtype}, {emodel.p}", flush=True)
    with EsrganServer(emodel, batch_size=4, max_delay_ms=50) as esrv:
        esrv.warmup((256, 256))
        esrv.warmup((320, 240))  # each bucket's graph is captured before the counted run
        zero_counts()
        t_start = time.perf_counter()
        futures = [esrv.submit(img) for img in esr_reqs]
        upscaled = [f.result(timeout=600) for f in futures]
        esr_wall_s = time.perf_counter() - t_start
        esr_conv_launches, esr_flash_launches, esr_win_launches = cc.launches, fa.launches, wa.launches
        other_deform["Real-ESRGAN"] = (dsm.launches, dcm.launches)
        estats = esrv.stats
        e_req, e_batches, e_p50 = estats.requests, estats.batches, estats.p50_latency_ms
    for img, res in zip(esr_reqs, upscaled):
        want = (4 * img.extent[0], 4 * img.extent[1])
        if res.extent != want or res.format != ImageFormat.rgba_u8 or not (res.data[..., 3] == 255).all():
            raise AssertionError(f"result {res.extent} {res.format} for request {img.extent}")
    if e_req != 6 or e_batches != 2:
        raise AssertionError(f"stats: {e_req} requests in {e_batches} batches, expected 6 in 2")
    if esr_conv_launches != ESRGAN_CONVS * e_batches or esr_flash_launches != 0 or esr_win_launches != 0:
        raise AssertionError(f"conv3x3 launches {esr_conv_launches} for {e_batches} batches of {ESRGAN_CONVS} "
                             f"convs, flash_attention {esr_flash_launches}, window_attention {esr_win_launches}")
    print(f"served {e_req} requests in {e_batches} batches; conv3x3 launches {esr_conv_launches}, "
          f"flash_attention launches {esr_flash_launches}, window_attention launches {esr_win_launches}", flush=True)
    big = Image(erng.integers(0, 256, (480, 640, 4), np.uint8), ImageFormat.rgba_u8)
    emodel.compute(big)  # captures the tiles' graph before the counted, timed run
    torch.cuda.synchronize()
    cc.launches = dsm.launches = dcm.launches = 0
    t0 = time.perf_counter()
    tiled = emodel.compute(big)
    torch.cuda.synchronize()
    tiled_ms = (time.perf_counter() - t0) * 1e3
    tiled_launches = cc.launches
    other_deform["Real-ESRGAN tiled"] = (dsm.launches, dcm.launches)
    if any(any(n) for n in other_deform.values()):
        raise AssertionError(f"(deform_sample, deform_conv) launches on the other paths: {other_deform}")
    if tiled.extent != (2560, 1920) or tiled.format != ImageFormat.rgba_u8 or tiled_launches != 3 * ESRGAN_CONVS:
        raise AssertionError(f"tiled compute: {tiled.extent} {tiled.format}, {tiled_launches} conv3x3 launches "
                             f"(9 tiles of 224x176 in 3 chunks of 4: {3 * ESRGAN_CONVS})")
    print(f"tiled compute 640x480 -> {tiled.extent}: {tiled_launches} conv3x3 launches (3 chunks of 4 tiles)",
          flush=True)
    esrgan_rgba_check(torch, emodel, esr_reqs, upscaled, 4)

    phase("12 Real-ESRGAN parity: card bf16 (kernel route) vs CPU f32 (plain route)")
    crop = torch.from_numpy(np.ascontiguousarray(esr_reqs[0].to_rgb_u8()[:64, :64])[None])
    t0 = time.perf_counter()
    cpu_stages = esrgan_stages(cpu_emodel.params, crop, cpu_emodel.p, torch.float32, "cpu")
    cpu_s = time.perf_counter() - t0
    gpu_stages = esrgan_stages(emodel.params, crop, emodel.p, emodel.dtype, "cuda")
    for (name, g), (_, c) in zip(gpu_stages, cpu_stages):
        print(f"stage {name}: relative RMS card bf16 vs CPU f32 {rel_rms(g.float().cpu(), c):.4e}", flush=True)
    g_out, c_out = gpu_stages[-1][1].float().cpu().numpy(), cpu_stages[-1][1].numpy()
    if g_out.shape != (1, 256, 256, 3) or not np.isfinite(g_out).all():
        raise AssertionError(f"output {g_out.shape}")
    esr_rms = rel_rms(g_out, c_out)
    print(f"output relative RMS card bf16 vs CPU f32 {esr_rms:.4e} (bound {E2E_REL_RMS}); CPU f32 forward at "
          f"64x64 took {cpu_s:.3f} s; output range card [{g_out.min():.4e}, {g_out.max():.4e}], CPU "
          f"[{c_out.min():.4e}, {c_out.max():.4e}], RMS {float(np.sqrt(np.mean(c_out**2))):.4e}", flush=True)
    if not esr_rms <= E2E_REL_RMS:
        raise AssertionError(f"Real-ESRGAN bf16 parity: relative RMS {esr_rms}")
    f32_params = {k: v.to("cuda") for k, v in cpu_emodel.params.items()}
    cc.launches = 0
    f32_out = esrgan_stages(f32_params, crop, cpu_emodel.p, torch.float32, "cuda")[-1][1]
    f32_launches = cc.launches
    esr_f32_rms = rel_rms(f32_out.cpu(), c_out)
    print(f"forward f32 on the card (kernel route, {f32_launches} conv3x3 launches, TF32 off) vs CPU f32: "
          f"relative RMS {esr_f32_rms:.4e} (bound {ESRGAN_F32_REL_RMS})", flush=True)
    if f32_launches != ESRGAN_CONVS or not esr_f32_rms <= ESRGAN_F32_REL_RMS:
        raise AssertionError(f"f32 forward on the card: relative RMS {esr_f32_rms}, {f32_launches} launches")
    del cpu_emodel, f32_params, cpu_stages, gpu_stages
    # the served u8 against the same image's float forward on the card: a
    # consistency check only (with these weights the u8 image is mostly 0)
    x0 = torch.from_numpy(esr_reqs[0].to_rgb_u8()[None])
    y0 = emodel.forward_u8(x0, to_u8=False).float()
    want_u8 = (torch.clamp(y0, 0.0, 1.0) * 255.0).to(torch.uint8)[0].cpu().numpy().astype(np.int16)
    served = upscaled[0].data[..., :3].astype(np.int16)
    u8_diff = int(np.abs(served - want_u8).max())
    print(f"served u8 vs clip(float forward) * 255 on the card: max difference {u8_diff} level(s); float output "
          f"range [{float(y0.min()):.4e}, {float(y0.max()):.4e}], u8 range [{served.min()}, {served.max()}], "
          f"{float((served > 0).mean()):.4%} of u8 values above 0", flush=True)
    if u8_diff > 1:
        raise AssertionError(f"served u8 differs from the float forward by {u8_diff} levels")

    phase(f"13 Real-ESRGAN timings on {card}")
    conv_rows = conv_timings(cc, torch, card)
    esr_profile = {}
    for b, hw in ((1, 1024), (4, 512)):
        xb = torch.from_numpy(erng.integers(0, 256, (b, hw, hw, 3), np.uint8)).to("cuda")
        f1 = median_ms(lambda: emodel.forward_u8(xb), 3, warmup=1)
        f2 = median_ms(lambda: emodel.forward_u8(xb), 3, warmup=0)
        f_ms = min(f1, f2)
        tflops = ESRGAN_FLOP_PER_PIXEL * b * hw * hw / (f_ms * 1e-3) / 1e12
        print(f"forward_u8 batch {b} at {hw}x{hw} bf16: median {f1:.3f} / {f2:.3f} ms, {b / f_ms * 1e3:.3f} img/s, "
              f"{tflops:.3f} TFLOP/s achieved [{card}]", flush=True)
        if b == 4:
            esr_profile = profile_forward(emodel, xb, torch, card)
        del xb
    # no elementwise pass per RRDB: what is not a conv launch is the input's
    # normalisation, the two nearest upsamplings and the u8 output
    if esr_profile["other_launches"] >= emodel.p.n_blocks:
        raise AssertionError(f"{esr_profile['other_launches']} launches other than conv3x3 in one forward of "
                             f"{emodel.p.n_blocks} RRDBs")
    print(f"EsrganServer 6 requests (4 at 256x256, 2 at 320x240; batch 4): p50 latency {e_p50:.3f} ms, "
          f"{6 / esr_wall_s:.3f} img/s, {e_batches} batches [{card}]", flush=True)
    print(f"tiled compute 640x480 (9 tiles of 224x176, 3 chunks of 4): {tiled_ms:.3f} ms [{card}]", flush=True)
    print(f"kernel build (nvcc, every source in parallel): {build_s:.2f} s [{card}]", flush=True)
    flash_libs, win_lib = attention_yardsticks(fa, wa, torch, card)
    del emodel

    phase("14 deform kernels and masked window kernel against their plain versions")
    deform_worst = deform_cases(dsm, torch)
    dconv_worst, dconv_ratio = deform_conv_cases(dcm, torch)
    win_worst = max(win_worst, masked_window_cases(wa, torch))

    phase("15 BiRefNet path: SWIN-L BiRefNet through ImageServer")
    brng = np.random.default_rng(12)
    bir_reqs = [Image(brng.integers(0, 256, (h, w, 4), np.uint8), ImageFormat.rgba_u8) for w, h in BIREF_EXTENTS]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "birefnet-swin-l-random.gguf")
        t0 = time.perf_counter()
        write_birefnet_gguf(path)
        gguf_s = time.perf_counter() - t0
        bmodel = birefnet_load_model(path, backend_init("gpu"))
        cpu_bmodel = birefnet_load_model(path, backend_init("cpu"))
    print(f"model on {bmodel.device.torch_device} {bmodel.dtype}, extent {bmodel.p.image_extent}, deform bound "
          f"{bmodel.deform_bound}; GGUF written in {gguf_s:.1f} s", flush=True)
    with ImageServer(bmodel, batch_size=4, max_delay_ms=5_000) as bsrv:
        bsrv.warmup()
        zero_counts()
        t_start = time.perf_counter()
        futures = [bsrv.submit(img) for img in bir_reqs]
        mattes = [f.result(timeout=600) for f in futures]
        bir_wall_s = time.perf_counter() - t_start
        bir_launches = {"window": wa.launches, "window masked": wa.masked_launches, "deform_conv": dcm.launches,
                        "deform_sample": dsm.launches, "flash": fa.launches, "conv3x3": cc.launches}
        bstats = bsrv.stats
        b_req, b_batches, b_p50 = bstats.requests, bstats.batches, bstats.p50_latency_ms
    for img, m in zip(bir_reqs, mattes):
        if m.extent != img.extent or m.format != ImageFormat.alpha_u8:
            raise AssertionError(f"matte {m.extent} {m.format} for request {img.extent}")
    want = {"window": BIREF_WINDOWS * b_batches, "window masked": BIREF_MASKED * b_batches,
            "deform_conv": BIREF_DEFORMS * b_batches, "deform_sample": 0, "flash": 0, "conv3x3": 0}
    if b_req != 8 or b_batches != 2 or bir_launches != want:
        raise AssertionError(f"{b_req} requests in {b_batches} batches (8 in 2 expected); launches {bir_launches}, "
                             f"expected {want}")
    print(f"served {b_req} requests in {b_batches} batches; launches {bir_launches}; matte means "
          f"{[round(float(m.data.mean()), 2) for m in mattes]}", flush=True)

    phase(f"16 BiRefNet parity at {BIREF_PARITY_HW}x{BIREF_PARITY_HW}: card bf16 (kernel routes) vs CPU f32 "
          "(plain routes)")
    # birefnet_predict takes any extent that is a multiple of 32
    xs = torch.from_numpy(brng.integers(0, 256, (1, BIREF_PARITY_HW, BIREF_PARITY_HW, 3), np.uint8))
    t0 = time.perf_counter()
    cpu_stages = birefnet_stages(cpu_bmodel, xs)
    cpu_s = time.perf_counter() - t0
    gpu_stages = birefnet_stages(bmodel, xs)
    for (name, g), (_, c) in zip(gpu_stages, cpu_stages):
        print(f"stage {name} {tuple(g.shape)}: relative RMS card bf16 vs CPU f32 {rel_rms(g.float().cpu(), c):.4e}",
              flush=True)
    g_mask, c_mask = gpu_stages[-1][1].float().cpu().numpy(), cpu_stages[-1][1].numpy()
    if g_mask.shape != (1, BIREF_PARITY_HW, BIREF_PARITY_HW, 1) or not np.isfinite(g_mask).all():
        raise AssertionError(f"mask {g_mask.shape}")
    bir_rms = rel_rms(g_mask, c_mask)
    print(f"mask relative RMS card bf16 vs CPU f32 {bir_rms:.4e} (bound {E2E_REL_RMS}); CPU f32 forward took "
          f"{cpu_s:.3f} s; mask range card [{g_mask.min():.4e}, {g_mask.max():.4e}], CPU mean {c_mask.mean():.4e}",
          flush=True)
    if not bir_rms <= E2E_REL_RMS:
        raise AssertionError(f"BiRefNet bf16 parity: relative RMS {bir_rms}")
    f32_params = {k: v.to("cuda") for k, v in cpu_bmodel.params.items()}
    wa.launches = dcm.launches = dsm.launches = 0
    f32_mask = birefnet_stages(bmodel, xs, f32_params, torch.float32)[-1][1]
    f32_launches = (wa.launches, dcm.launches, dsm.launches)
    bir_f32_rms = rel_rms(f32_mask.cpu(), c_mask)
    print(f"forward f32 on the card (kernel routes, {f32_launches[0]} window, {f32_launches[1]} deform_conv and "
          f"{f32_launches[2]} deform_sample launches, "
          f"TF32 off) vs CPU f32: relative RMS {bir_f32_rms:.4e} (bound {BIREF_F32_REL_RMS})", flush=True)
    if f32_launches != (BIREF_WINDOWS, BIREF_DEFORMS, 0) or not bir_f32_rms <= BIREF_F32_REL_RMS:
        raise AssertionError(f"f32 forward on the card: relative RMS {bir_f32_rms}, launches {f32_launches}")
    del cpu_bmodel, f32_params, cpu_stages, gpu_stages
    # the served u8 against the card's float mask of the same one-image
    # forward: a server of batch 1 runs exactly that forward
    x0 = torch.from_numpy(bir_reqs[0].to_rgb_u8()[None])
    with ImageServer(bmodel, batch_size=1) as one:
        served = one.compute(bir_reqs[0]).data.astype(np.int16)
    y0 = bmodel.forward_u8(x0).float()[0].cpu().numpy()
    want_u8 = (np.clip(y0, 0.0, 1.0) * 255.0).astype(np.int16)
    u8_diff = int(np.abs(served - want_u8).max())
    print(f"served u8 matte vs clip(float mask) * 255 on the card: max difference {u8_diff} level(s); float range "
          f"[{y0.min():.4e}, {y0.max():.4e}]", flush=True)
    if u8_diff > 1:
        raise AssertionError(f"served u8 differs from the float mask by {u8_diff} levels")

    phase(f"17 BiRefNet timings on {card}")
    d_rows = deform_timings(dsm, dcm, torch, card)
    fwd_shapes = [(hw, k) for hw in BIREF_BLOCK_HW for k in BIREF_DEFORM_KS]  # a forward's 20 convs
    d_sum = {key: sum(d_rows[sh][key] for sh in fwd_shapes) for key in d_rows[fwd_shapes[0]]
             if not key.endswith("bound_by")}
    for key in ("bound_by", "sampler_bound_by"):  # what bounds most of the 20's summed bound
        d_sum[key] = max(("bytes", "operations"), key=lambda by, key=key: sum(
            d_rows[sh][key[:-3]] for sh in fwd_shapes if d_rows[sh][key] == by))
    print(f"deform over one batch-4 1024x1024 forward's {len(fwd_shapes)} convs, by the card's own time: fused "
          f"deform_conv {d_sum['fused']:.4f} ms (bare {d_sum['bare']:.4f}; the weights' layouts, made once "
          f"by the model: {d_sum['layout']:.4f} ms, {d_sum['layout_call']:.4f} ms with the host's work), bound "
          f"{d_sum['bound']:.4f} ms "
          f"({d_sum['bound_by']}), plain {d_sum['plain']:.4f} ms, yardstick F.grid_sample + mask product + matmul "
          f"{d_sum['library']:.4f} ms, parent's route sampler + matmul {d_sum['route']:.4f} ms (sampler "
          f"{d_sum['sampler']:.4f} ms, bound {d_sum['sampler_bound']:.4f} ms ({d_sum['sampler_bound_by']}), plain "
          f"{d_sum['sampler_plain']:.4f} ms) [{card}]", flush=True)
    mw_rows = masked_window_yardsticks(wa, torch, card)
    print("window_attention masked, SWIN-L stages 2-4 at batch 4, by the card's own time: " + "; ".join(
        f"stage {i + 2} kernel {k:.4f} ms, bound {bd:.4f} ms ({by}, {k / bd:.2f}x), SDPA with the combined mask "
        f"{lib:.4f} ms ({k / lib:.2f}x)" for i, (_, k, _, lib, bd, by) in enumerate(mw_rows[1:])) + f" [{card}]",
          flush=True)
    for b in (1, 4):
        xb = torch.from_numpy(brng.integers(0, 256, (b, 1024, 1024, 3), np.uint8)).to("cuda")
        f1 = median_ms(lambda: bmodel.forward_u8(xb), 3, warmup=1)
        f2 = median_ms(lambda: bmodel.forward_u8(xb), 3, warmup=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mb = torch.cuda.memory_allocated() / 2**20
        bmodel._forward_u8(xb)  # the eager forward: a replay allocates nothing beyond its output
        torch.cuda.synchronize()
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        print(f"BiRefNet forward_u8 batch {b} at 1024x1024 bf16: median {f1:.3f} / {f2:.3f} ms, "
              f"{b / min(f1, f2) * 1e3:.3f} img/s; peak allocated {peak_mb:.1f} MiB ({peak_mb - base_mb:.1f} MiB "
              f"above the {base_mb:.1f} MiB held before) [{card}]", flush=True)
        if b == 4:
            bir_profile = profile_forward(bmodel, xb, torch, card, ("window_attention", "deform_conv"))
            bir_profile["peak_mib"] = peak_mb
        del xb
    print(f"ImageServer 8 BiRefNet requests (4 at 1024x1024, 2 at 1280x720, 2 at 800x600; batch 4): p50 latency "
          f"{b_p50:.3f} ms, {8 / bir_wall_s:.3f} img/s, {b_batches} batches [{card}]", flush=True)
    from vision_tpu_torch.image import image_scale, preprocess_scale_method
    from vision_tpu_torch.models.birefnet import birefnet_process_output

    fake_mask = brng.random((1024, 1024, 1), dtype=np.float32)
    for img in (bir_reqs[0], bir_reqs[4], bir_reqs[6]):  # one request of each extent
        t0 = time.perf_counter()
        if img.extent != (1024, 1024):
            image_scale(img, (1024, 1024), preprocess_scale_method()).to_rgb_u8()
        else:
            img.to_rgb_u8()
        t1 = time.perf_counter()
        birefnet_process_output(fake_mask, img.extent)
        t2 = time.perf_counter()
        print(f"host per BiRefNet request at {img.extent[0]}x{img.extent[1]}: prep (resize to 1024x1024, rgb u8) "
              f"{(t1 - t0) * 1e3:.3f} ms, post (birefnet_process_output) {(t2 - t1) * 1e3:.3f} ms [{card}]",
              flush=True)
    del bmodel

    s3 = sam3_phases(torch, card, fa, wa, cc, dsm, dcm)
    ym = yolo_migan_phases(torch, card, fa, wa, cc, dsm, dcm)
    with tempfile.TemporaryDirectory() as fd_tmp:
        fd = front_door_phases(torch, card, fa, wa, cc, dsm, dcm, fd_tmp)

        phase(f"29 served p50s through graph replays, and the graphs' eager against replay ms, on {card}")
        served = {"Depth-Anything (8 requests, batch 4)": p50_ms, "MobileSAM (12, batch 6; encoder eager)": s_p50,
                  "Real-ESRGAN (6, batch 4)": e_p50, "BiRefNet (8, batch 4)": b_p50,
                  f"YOLOv9t (16, batch {YOLO_BATCH})": ym["p50_ms"],
                  f"MI-GAN (8, batch {MIGAN_BATCH})": ym["migan_p50_ms"]}
        print("served p50 latency: " + "; ".join(f"{k} {v:.3f} ms" for k, v in served.items()) + f" [{card}]",
              flush=True)
        for (family, b), r in fd["graphs"].items():
            print(f"{family} batch {b}: eager {r['eager_ms']:.3f} ms, replay {r['replay_ms']:.3f} ms "
                  f"({r['eager_ms'] / r['replay_ms']:.2f}x), replay busy {r['busy_ms']:.3f} ms, idle "
                  f"{r['idle']:.2%}, first call {r['capture_ms']:.1f} ms, pool {r['pool_before_mib']:.1f} -> "
                  f"{r['pool_mib']:.1f} MiB (eager peak {r['eager_peak_mib']:.1f}, reserved "
                  f"{r['eager_reserved_mib']:.1f}) [{card}]", flush=True)

        # phases 30-32 over phase 27's GGUFs and the models phases 27-28 loaded
        http_phase(torch, card, fd, fd_tmp)
        verbs_phase(torch, card, fd, fd_tmp, bulk_phase(torch, card, fd, fd_tmp))
        del fd["models"]

        phase("33 dequant kernel against its plain version: the seven resident formats, bf16 and f32, three layouts")
        dq_cases, dq_worst = dequant_cases(dqm, torch)
        phase("34 quantized residency on the served paths: Q8_0 (and Q4_1, IQ4_NL) copies loaded expanded and "
              "int8-resident")
        quant = residency_phase(torch, card, fd, fd_tmp)
        phase("35 the quantize verb as a subprocess")
        quantize_verb_phase(card, fd["paths"]["depthany"], quant["copies"][("depthany", "q8_0")], fd_tmp)
        train = training_phases(torch, card, fd, fd_tmp)
        s3_models = s3.pop("models")
        tools = tooling_phases(torch, card, fd, fd_tmp, s3_models)
        mesh = mesh_phases(torch, card, fd, fd_tmp, s3_models, fa, wa, dcm)
        train_mesh = train_mesh_phase(torch, card, fd, fd_tmp, train)
        del train["cases"]
        scan = sam3_scan_phase(torch, card, {**s3, "models": s3_models}, fd_tmp)
        del s3_models
    gc.collect()
    torch.cuda.empty_cache()
    bench = bench_phase(torch, card)

    # one RDB's five convs at 1024x1024 as the path runs them, summed
    rdb = conv_rows[: len(ESRGAN_RDB)]
    rdb_bounds = [conv_bound(px, ci, co, res) for _, px, ci, co, *_, res in rdb]
    rdb_bound = sum(ms for ms, _ in rdb_bounds)
    rdb_by = max(("bytes", "operations"), key=[by for _, by in rdb_bounds].count)  # what bounds most of the five
    (t_sq, k_ms, p_ms), (t_wide, k_wide, p_wide) = timings
    w_shape, w_ms, w_plain_ms = win_times[0]
    nw, t, h = SAM_STAGES[0]
    flash_bound, flash_by = bound_ms(4.0 * 24 * t_sq**2 * 64, 4 * 2.0 * 24 * t_sq * 64)
    wide_bound, wide_by = bound_ms(4.0 * 24 * t_wide**2 * 64, 4 * 2.0 * 24 * t_wide * 64)
    win_bound, win_by = bound_ms(4.0 * 6 * nw * h * t * t * 32, 4 * 2.0 * 6 * nw * t * h * 32 + 2.0 * h * t * t)
    def shard_rows(name: str) -> list:
        """phase 44's shard shapes of kernel ``name``: label, ms, plain ms."""
        return [{"shape": label, "ms": ms, "plain_ms": plain} for n, label, ms, plain in mesh["shards"]["rows"]
                if n == name]

    def mesh_launches(counter: str) -> dict:
        """family -> this kernel's launches in a served batch of the meshed model at one rank (phase 43)."""
        return {f: r[counter] for f, r in mesh["served"].items()
                if isinstance(r, dict) and counter in r and not f.endswith("_ms")}

    def train_mesh_launches(counter: str) -> dict:
        """recipe -> this kernel's launches in one meshed training step at one rank (phase 46)."""
        return {r: n.get(counter, 0) for r, n in train_mesh["launches"].items()}

    def export_launches(counter: str) -> dict:
        """entry -> this kernel's launches in one call of the exported entry (phase 40)."""
        return {f"{name}.{entry}": r["launches"][counter] for name, row in tools["export"].items()
                for entry, r in row.items() if isinstance(r, dict) and counter in r.get("launches", {})}

    print(card)
    print(json.dumps({"kernels": [
        {
            "name": "flash_attention",
            "ops": KERNEL_OPS["flash_attention"],
            "route": "cuda",
            "launches_export": export_launches("flash"),
            "source": "vision_tpu_torch/csrc/flash_attention.cu",
            "replaces": "vision_tpu/ops/pallas/flash_attention.py:26",
            "launches": main_launches,
            "launches_bench": bench_rows(bench["rows"], "flash_attention"),
            "max_abs_err": max(worst, s3["worst"]),
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": flash_bound,
            "bound_by": flash_by,
            "library_ms": flash_libs[t_sq],
            "timed_shape": f"(24, {t_sq}, 64) bf16",
            "timing": DEVICE_TIMING,
            f"at_{t_wide}_tokens": {"ms": k_wide, "plain_ms": p_wide, "bound_ms": wide_bound, "bound_by": wide_by,
                                    "library_ms": flash_libs[t_wide]},
            **{key: dict(zip(("shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by"),
                             (f"({bh}, {(1008 // 14) ** 2}, 80) bf16", *rest)))
               for key, (bh, *rest) in zip(("at_sam3_global", "at_sam3_global_batch4"), s3["rows"])},
            "launches_sam3": s3["launches"],
            "op_dispatch_us": tools["ops"]["dispatch_us"],
            "launches_train_step_distill": train["rows"]["distill"]["launches"]["flash"],
            "launches_mesh_one_rank": mesh_launches("flash"),
            "launches_train_mesh_one_rank": train_mesh_launches("flash"),
            "mesh_shards": shard_rows("flash_attention"),
            "mesh_shard_max_abs_err": mesh["shards"]["worst"],
            "mesh_shard_rel_rms": mesh["shards"]["worst_rel_rms"]["flash_attention"],
            "mesh_sp_shards": mesh["shards"]["sp_rows"],
            "launches_sam3_window_major": scan["launches"],
            "sam3_window_major_trunk": {k: scan[k] for k in ("rel_rms", "ms", "busy_ms", "total_launches",
                                                             "pipelined", "mesh_sp1_launches", "stack_mib")},
        },
        {
            "name": "window_attention",
            "ops": KERNEL_OPS["window_attention"],
            "route": "cuda",
            "launches_export": export_launches("window"),
            "source": "vision_tpu_torch/csrc/window_attention.cu",
            "replaces": "scripts/exp_winattn2.py:19",
            "launches": sam_win_launches,
            "launches_bench": bench_rows(bench["rows"], "window_attention"),
            "launches_bench_masked": bench_rows(bench["rows"], "window_attention masked"),
            "max_abs_err": win_worst,
            "ms": w_ms,
            "plain_ms": w_plain_ms,
            "bound_ms": win_bound,
            "bound_by": win_by,
            "library_ms": win_lib,
            "timed_shape": w_shape,
            "timing": DEVICE_TIMING,
            "launches_birefnet": bir_launches["window"],
            "launches_birefnet_masked": bir_launches["window masked"],
            "birefnet_masked_stage1": dict(zip(("label", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by"),
                                               mw_rows[0])),
            "launches_train_step_birefnet": train["rows"]["birefnet"]["launches"]["window"],
            "launches_train_step_birefnet_masked": train["rows"]["birefnet"]["launches"]["window masked"],
            "backward": "WindowAttentionFn: PyTorch ops, the probabilities recomputed at the forward's rounding",
            "grad_max_rel_rms": train["worst"]["window_attention"],
            "launches_mesh_one_rank": mesh_launches("window"),
            "launches_train_mesh_one_rank": train_mesh_launches("window"),
            "mesh_shards": shard_rows("window_attention"),
            "mesh_shard_rel_rms": mesh["shards"]["worst_rel_rms"]["window_attention"],
        },
        {
            "name": "conv3x3",
            "ops": KERNEL_OPS["conv3x3"],
            "route": "cuda",
            "launches_export": export_launches("conv3x3"),
            "source": "vision_tpu_torch/csrc/conv3x3.cu",
            "replaces": "scripts/exp_pallas_conv.py:36",
            "launches": esr_conv_launches,
            "launches_bench": bench_rows(bench["rows"], "conv3x3"),
            "max_abs_err": max(conv_worst, ym["worst"]),
            "ms": sum(r[4] for r in rdb),
            "plain_ms": sum(r[6] for r in rdb),
            "bound_ms": rdb_bound,
            "bound_by": rdb_by,
            "library_ms": sum(r[7] for r in rdb),
            "timed_shape": "one RDB's five convs at (1, 1024, 1024) bf16 with the path's epilogue and views, "
                           "summed: " + ", ".join(f"{ci}->{co}" for ci, co in ESRGAN_RDB),
            "timing": DEVICE_TIMING,
            "bare_ms": sum(r[5] for r in rdb),
            "shapes": [dict(zip(("shape", "ms", "bare_ms", "plain_ms", "library_ms", "per_call_ms"),
                                (r[0], r[4], r[5], r[6], r[7], r[8]))) for r in conv_rows],
            "forward_512x4_busy_ms": esr_profile["busy_ms"],
            "forward_512x4_other_launches": esr_profile["other_launches"],
            "launches_yolov9t_per_forward": ym["launches_per_forward"],
            "yolov9t": {
                **{k: ym["conv"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                "timed_shape": f"one batch-{YOLO_BATCH} 640x640 YOLOv9t forward's {YOLO_CONVS} stride-1 3x3 convs "
                               f"with the path's epilogue (BN, SiLU, r1, r2) and views, summed",
                "library_call": "F.conv2d + the BN's product and sum + F.silu (+ the branch, + the shortcut)",
                "shapes": ym["conv"]["rows"],
                "forward_batch8_busy_ms": ym["profile"]["busy_ms"],
                "forward_batch8_conv3x3_ms": ym["profile"]["named_ms"]["conv3x3"],
            },
            "launches_train_step_esrgan": train["rows"]["esrgan"]["launches"]["conv3x3"],
            "backward": "Conv3x3Fn: PyTorch ops, F.conv2d recomputing the pre-activation and convolution_backward",
            "grad_max_rel_rms": train["worst"]["conv3x3"],
            "launches_mesh_one_rank": mesh_launches("conv3x3"),
            "launches_train_mesh_one_rank": train_mesh_launches("conv3x3"),
        },
        {
            "name": "deform_conv",
            "ops": KERNEL_OPS["deform_conv"],
            "route": "cuda",
            "launches_export": export_launches("deform_conv"),
            "source": "vision_tpu_torch/csrc/deform_conv.cu",
            "replaces": "scripts/exp_deform_pallas.py:56",
            "launches": bir_launches["deform_conv"],
            "launches_bench": bench_rows(bench["rows"], "deform_conv"),
            "max_abs_err": dconv_worst,
            "ms": d_sum["fused"],
            "plain_ms": d_sum["plain"],
            "bound_ms": d_sum["bound"],
            "bound_by": d_sum["bound_by"],
            "library_ms": d_sum["library"],
            "timed_shape": f"one batch-4 1024x1024 BiRefNet forward's 20 deformable convs with the path's epilogue "
                           f"into 28-channel views, summed: Cin {BIREF_CIN} -> {BIREF_COUT} bf16, k 1, 1, 3, 7 at "
                           f"256^2, 128^2, 64^2 and twice at 32^2",
            "timing": DEVICE_TIMING,
            "library_call": "F.grid_sample over all taps + the mask product + torch.matmul, each timed alone, summed",
            "parent_route_ms": d_sum["route"],
            "weight_layout_ms": d_sum["layout"],
            "bf16_rounding_ratio_k7_256": dconv_ratio,
            "forward_1024x4_busy_ms": bir_profile["busy_ms"],
            "forward_1024x4_peak_mib": bir_profile["peak_mib"],
            "alloc_mib_k7_256": {"fused": d_rows[(256, 7)]["fused_alloc_mib"],
                                 "parent_route": d_rows[(256, 7)]["route_alloc_mib"]},
            "launches_train_step_birefnet": train["rows"]["birefnet"]["launches"]["deform_conv"],
            "backward": "DeformConvFn: autograd of deform_conv_plain, recomputed from the saved inputs",
            "grad_max_rel_rms": train["worst"]["deform_conv"],
            "launches_mesh_one_rank": mesh_launches("deform_conv"),
            "launches_train_mesh_one_rank": train_mesh_launches("deform_conv"),
            "mesh_shards": shard_rows("deform_conv"),
        },
        {
            "name": "deform_sample",
            "ops": KERNEL_OPS["deform_sample"],
            "route": "cuda",
            "launches_export": export_launches("deform_sample"),
            "source": "vision_tpu_torch/csrc/deform_sample.cu",
            "replaces": "scripts/exp_deform_pallas.py:56",
            "launches": bir_launches["deform_sample"],
            "launches_bench": bench_rows(bench["rows"], "deform_sample"),
            "max_abs_err": deform_worst,
            "ms": d_sum["sampler"],
            "plain_ms": d_sum["sampler_plain"],
            "bound_ms": d_sum["sampler_bound"],
            "bound_by": d_sum["sampler_bound_by"],
            "library_ms": d_sum["grid_sample"],
            "timed_shape": f"the columns of one batch-4 1024x1024 BiRefNet forward's 20 deformable convs, summed: "
                           f"Cin {BIREF_CIN} bf16; the standalone column kernel, off every served path",
            "timing": DEVICE_TIMING,
            "launches_train_step_birefnet": train["rows"]["birefnet"]["launches"]["deform_sample"],
            "launches_train_mesh_one_rank": train_mesh_launches("deform_sample"),
        },
        {
            "name": "dequant",
            "ops": KERNEL_OPS["dequant"],
            "route": "cuda",
            "launches_export": export_launches("dequant"),
            "source": "vision_tpu_torch/csrc/dequant.cu",
            # no Pallas kernel: the JAX package's QuantResident.dequant, which XLA fuses into the consumer
            "replaces": "vision_tpu/core/quant.py:93",
            "launches": quant["served"]["launches"],
            "launches_bench": bench_rows(bench["rows"], "dequant"),
            "max_abs_err": dq_worst,
            "ms": quant["ms"],
            "plain_ms": quant["plain_ms"],
            "bound_ms": quant["bound_ms"],
            "bound_by": quant["bound_by"],
            "library_ms": None,
            "timed_shape": "one BiRefNet (SWIN-L, Q8_0) resident forward's dequants to bf16, replayed as one CUDA graph",
            "timing": "CUDA events around one graph replay, the median of 10",
            "cases_bit_equal": dq_cases,
            "launches_train_step_distill": train["rows"]["distill"]["launches"]["dequant"],
            "launches_train_mesh_one_rank": train_mesh_launches("dequant"),
            "per_forward": {f"{family} {ftype}": {
                name: {"dequant_launches": r[name]["dequant_launches"], "ms_resident": r[name]["ms"][0],
                       "ms_expanded": r[name]["ms"][1],
                       **{k: v for k, v in r[name].items() if k.startswith("busy_ms")}}
                for name in ("forward", "encode", "decode") if name in r}
                | {"store_mb_resident": r["store_mb"][0], "store_mb_expanded": r["store_mb"][1],
                   "alloc_mib_resident": r["alloc_mib"][0], "alloc_mib_expanded": r["alloc_mib"][1]}
                | ({"pool_mib_resident": r["pool_mib"][0], "pool_mib_expanded": r["pool_mib"][1]}
                   if "pool_mib" in r else {"eager_dequant_us": r["eager_dequant_us"]})
                for (family, ftype), r in quant["rows"].items()},
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
