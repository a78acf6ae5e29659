#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Eight serving paths, seven training paths and the evaluation entry points
on every test YAML, each at full width with random weights made from a
seed or trained here:

- IR-SDE deraining (configs/deraining/test/ir-sde.yml): ConditionalUNet
  (nf=64, depth=4) in bf16 with float32 parameters, 128 px images at
  batch 8, cosine T=100 schedule, 100-step reverse sampling;
- Refusion latent dehazing (configs/latent-dehazing/test/nasde.yml): the
  compressor UNet (ch 8, ch_mult [4, 8, 8, 16], embed_dim 8, float32)
  encodes 512 px images to 64x64x8 latents; ConditionalNAFNet (width 64,
  enc [1, 1, 1, 28], mid 1, dec [1, 1, 1, 1], bf16 with float32 parameters)
  runs 100 reverse steps on them, its 28-block level fused (kernel K3);
  the compressor decodes with the LQ skips;
- Refusion DiT latent dehazing (configs/latent-dehazing/train/dit.yml for
  the network, compressor and SDE; posterior mode and 1024 px are this
  script's serving constants): the same compressor encodes 1024 px images
  to 128x128x8 latents; DiT-L/2 (hidden 1024, 24 blocks, 16 heads of 64:
  4096 tokens, bf16 compute, parameters cast to bf16 once per request)
  runs 100 reverse steps, its attention through kernel K4; and the same
  path through DiT-XL/2 (the YAML with ``network_G.which_model: DiT_XL_2``:
  hidden 1152, 28 blocks, 16 heads of 72, what the bare DiT class builds);
- tiled large images: a 1536x1536 uint8 image as four 1024 px tiles in one
  call of the DiT sampler, blended on the card;
- the public op ``ops.linear_attention.linear_attention`` (kernel K5) at
  the token counts of the deraining UNet's levels;
- Gaussian denoising (configs/denoising/test/ir-sde.yml): the unconditional
  ConditionalUNet (nf=64, depth=4, full attention in the mid block) in bf16,
  DenoisingSDE (max_sigma 70, T 1000, cosine), the reverse ODE from the
  optimal timestep of sigma 50 (414 steps);
- stereo super-resolution (configs/stereo-sr/test/refusion.yml): the stereo
  NAFNet (width 64, enc [1, 1, 1, 28], mid 1, dec [1, 1, 1, 1], a SCAM after
  every block) in bf16, 100 posterior steps;
- latent bokeh (configs/latent-bokeh/test/refusion.yml): the compressor
  UNet (ch 64, ch_mult [1, 2, 4], embed_dim 4) and the bokeh NAFNet (width
  64, enc [2, 2, 4, 8], mid 12, dec [2, 2, 2, 2], lens conditioning) in
  bf16, 100 posterior steps on H/4 latents;
- pixel-space training through the port's train entry point
  (``python -m image_restoration_sde_tpu_torch.train``), float32, batch 4
  of 128 px crops: IR-SDE deraining (configs/deraining/train/ir-sde.yml:
  ConditionalUNet nf=64, depth=4, Adam, MultiStepLR, L1) and Refusion
  deraining (configs/deraining/train/refusion.yml: ConditionalNAFNet width
  64, enc [1, 1, 1, 28], its 28-block level one K3 launch at 16x16x512,
  Lion, TrueCosineAnnealingLR);
- latent, DiT and stereo training through the same entry point, float32,
  each at its YAML's batch and crop: the Refusion compressor
  (configs/unet-latent/train/train_haze.yml: UNet ch 8, ch_mult [4, 8, 8,
  16], batch 16 of 256 px), then with its last checkpoint as the frozen
  compressor the latent NAFNet (configs/latent-dehazing/train/nasde.yml,
  batch 8 of 1024 px: 128x128x8 latents, the 28-block level one K3 launch
  at 16x16x512) and DiT-L/2 (configs/latent-dehazing/train/dit.yml, batch
  8 of 1024 px: 4096 tokens, K4 at 24 sites with the streamed backward);
  latent bokeh (configs/latent-bokeh/train/refusion.yml: a seeded ch 64
  compressor, the bokeh NAFNet with lens values, batch 8 of 512 px, no
  EMA) and stereo super-resolution (configs/stereo-sr/train/refusion.yml:
  the SCAM NAFNet, batch 8 of 128 px pairs from 32 px LR).  Each run is cut
  in ``niter``, its checkpoint interval and its data only (TRAIN_PATHS):
  synthetic image folders written from the seed to a temporary directory;
- evaluation through the port's test entry point (``python -m
  image_restoration_sde_tpu_torch.test``) on each of the 16 test YAMLs
  (configs/*/test/*.yml) as shipped, float32 as the runners' validation,
  with the training paths' last checkpoints where they trained the YAML's
  network, else seeded weights, on synthetic test sets near the public
  sets' sizes (EVAL_PATHS), the samplers cut to EVAL_SAMPLE_T steps; plus
  TLSC (CNAFNetLocal), a tiled run, the inference and restore entry
  points, LPIPS and FID, and Gaussian denoising's kernel path against its
  plain path;
- serving: the kernels as ``irsde::`` operators under
  ``torch.library.opcheck``; the deraining, latent and denoising samplers
  exported (``exporting.py``) and loaded in a fresh process; the port's
  HTTP server (``python -m image_restoration_sde_tpu_torch.serve``) on the
  deraining artifact under the port's ``bench_serve``; ``bench_cuda.py``
  (the main path's bench) and a batch sweep;
- data parallelism: the deraining IR-SDE train YAML through the train
  entry point under ``torchrun``, one NCCL rank and two gloo ranks on the
  one card (and one NCCL rank a card where there are two or more), held
  against the one-process run; the symbolic deraining artifact loaded over
  two devices (``load_artifact(devices=...)``);
- tensor parallelism: the DiT-L/2 train YAML through the train entry
  point with ``train.model_parallel: 2`` under ``torchrun``, two gloo
  ranks sharing the card, one model group splitting the net (K4 on each
  rank's 8 heads), its batch cut from 8 to 2; held against the
  one-process step; and ``dryrun 2`` (ConditionalUNet nf 16 split over two
  gloo ranks on the card: K1 and K2 at full width on each);
- the benches: ``bench_train`` (the UNet and the Refusion latent NAFNet
  train steps, img/s/GPU and MFU) and ``bench_refusion`` (the latent
  pipeline at 1024 px, NAFNet and DiT-L/2).

Every sampler path runs as the port runs it on the card: each call's whole
chain (encode, every step and decode) replayed from one CUDA graph
captured per call signature (``sde/captured.py``).  Each main path first
captures its requests' graphs (``sample.prepare``: the capture seconds, the
graph pool's MiB and the warm-up's launches printed apart), then serves its
requests from them, then runs requests again through the same sampler with
``capture=False``, each form from a generator of one seed: the outputs must
be bit-equal and the generators' states equal after, and the wall ms a
step of each form is printed (``[captured]`` JSON line).

Every train path of phase 21 trains as the port's train entry point trains
on the card: each step replayed from one CUDA graph of its forward,
backward and update captured per step signature (``training/captured.py``),
held against the same steps eager (``train(..., capture=False)``) from
the same checkpoint and generator.  The data- and tensor-parallel runs,
their one-process references and the dry run step eagerly (their
collectives are not captured).

Phases, each printing its lines and its seconds (the serving phases run
where their nets are built: export deraining after 5, export latent after
7, export denoising, serve, bench, bench train and bench refusion after 14;
train dp after phase 21's IR-SDE run, train tp after its DiT run, demo
after phase 21).  Work that is host-bound or light on the card runs in
child processes beside the phases (``Background``), each joined where its
result is held: ops and dryrun tp start after phase 3 and are joined
before phase 19 (no kernel is timed while the dry run launches); the
server starts after phase 13 and loads and warms during phase 14; the
artifacts' loading process runs beside phase 22, the restore entry point
within it; train tp's torchrun runs from phase 21's DiT run to the end of
phase 22, after which its K4 and K3 sites are timed alone.  The phases
these overlap record host-clock seconds only, which the overlap can
stretch; no kernel timing overlaps a child but the ops child's few
launches:

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernels, from this checkout's sources;
3. kernels: each kernel against its plain PyTorch version at the paths'
   shapes (K1 and K2 at every path's, the DiT and tiled requests'
   compressor included), float32 and bfloat16, with both times, the time
   of one PyTorch call computing the same function where there is one, and
   the least time the card could take (bytes or operations at the H100's
   published peaks; K3's at the float32 rate its arithmetic runs at); K1
   and K2 at the deraining sites, K2 also at the denoising 512 px
   request's (and K5 in phase 12) timed from a CUDA graph of 20
   back-to-back calls, since one launch between CUDA events reads the
   host's enqueue, with that earlier figure beside it; K2 run twice on
   every input, the two runs bit-equal; K3 also block by block, as
   chained one-block launches that must end bit-equal to the one launch;
   the packed op's gradient on the card against the plain composition's,
   and K1, K3 and K4 differentiable (a grad_fn on each output);
4. net: one forward of the full-width UNet, kernel path against plain
   path; and a 100-step float32 chain on a small input, kernel against plain;
5. main path: the deraining sampler serves two posterior batches of 8, one
   sde batch of 8 and one odd-size single image; per net call exactly 18
   K1 and 9 K2a, K2b launches, and no K3; the first posterior batch and
   the odd image held bit-equal to the eager chain (phase bench holds the
   sde chain);
6. latent net: one forward of the full-width latent NAFNet and one of the
   deraining Refusion NAFNet (configs/deraining/test/refusion.yml, 128 px,
   batch 8), and the compressor's encode and decode at batch 4, 512 px and
   at 704x1024, each kernel path against plain path;
7. latent main path: the latent sampler serves two posterior batches of 4
   at 512 px, one sde batch of 4 and one 700x1000 image (padded to
   704x1024); per 100-step request exactly 100 K3, 16 x 100 + 4 K1, 2 K2a
   and 2 K2b launches;
8. DiT kernels: K4 against its plain version in float32 and bfloat16 at
   (B, N, H, D) = (2, 4096, 16, 64) (the slice), (1, 2816, 16, 64) (the
   odd request), (2, 1024, 16, 64) (512 px), (1, 4096, 16, 72) (DiT-XL's
   head), (1, 1000, 16, 64), (3, 35, 4, 64), (1, 1000, 16, 72) and
   (3, 35, 4, 72) (ragged), (4, 4096, 16, 64) (the tiled call), (2, 4096,
   16, 72) and (1, 2816, 16, 72) (the DiT-XL requests), and on strided views
   of packed (2, 4096, 3, 16, 64) and (2, 4096, 3, 16, 72) qkv; bfloat16 also
   against a plain version that rounds p where the kernel does; beside
   F.scaled_dot_product_attention (float32: TF32 matmuls off) and the
   bound (float32: on the FMA units and as the kernel's 3xTF32 products);
9. DiT net: one forward of DiT-L/2 at batch 2 on 128x128x8 latents, kernel
   path against plain path, float32 and bfloat16; the path's compressor,
   kernel path against plain path, at each DiT request's shape and at the
   tiled call's (batch 4, 1024 px);
10. DiT main path: the latent sampler serves two posterior batches of 2 at
   1024 px, one sde batch of 2 and one 1000x700 image (padded to
   1024x704: 2816 tokens); per 100-step request exactly 2400 K4, 4 K1,
   2 K2a, 2 K2b and no K3 launches;
11. tiled path: ``tiling.tiled_restore_device`` on a 1x1536x1536 uint8
   image, tile 1024, overlap 64, tile_batch 4 (four tiles, one sampler
   call capturing its chunk's graph: 2400 K4 launches), and through the
   eager sampler: the same bytes;
dit-xl net (after 11): phase 9's forward through DiT-XL/2, kernel path
   against plain path, float32 and bfloat16, 28 K4 launches a bf16 forward;
dit-xl main path: phase 10's first posterior batch and odd image through
   DiT-XL/2 (the compressor of phase 9); per 100-step request exactly 2800
   K4, 4 K1, 2 K2a, 2 K2b and no K3 launches; then the wall ms a step and
   the host's enqueue of one forward (the median of ENQUEUE_REPS);
12. linear attention: the op path at (BH, N, d) = (32, 16384, 32),
   (32, 4096, 32), (32, 1024, 32), (32, 256, 32) (the deraining UNet's
   levels at batch 8 x 4 heads), (6, 1000, 32), (8, 4096, 16) and
   (8, 4096, 64), float32 and bfloat16, one context and one apply launch
   per call; each against its plain version, both passes timed beside
   their plain halves and the bound; one gradient through the op;
13. denoise net: one forward of the unconditional UNet at batch 8, 128 px,
   kernel path against plain path (17 K1, 8 K2a, 8 K2b per forward), and
   K1, K2 at its sites and those of the 512 px request;
14. denoise main path: ``make_denoising_sampler`` (t0 = 414) serves a batch
   of 8 noisy 128 px images: exactly 7038 K1, 3312 K2a and 3312 K2b
   launches;
15. stereo net: one forward at batch 4 pairs, 128 px, kernel path against
   plain path (144 K1 per forward, no K3), and K1 at its sites and those
   of the 140x200 request;
16. stereo main path: the restoration sampler serves a posterior batch
   of 4 pairs at 128 px: exactly 14400 K1 launches;
17. bokeh net: the compressor's kernel path against its plain path at
   batch 4, 512 px and at 704x1024; the bokeh NAFNet's at batch 4 on
   128x128x4 latents (72 K1 per forward, no K3); K1, K2 at both nets' sites;
18. bokeh main path: the latent sampler with seeded lens values serves a
   posterior batch of 4 at 512 px and one 700x1000 image (padded to
   704x1024); per request exactly 7204 K1, 2 K2a and 2 K2b launches;
19. train kernels: K1's gradient (x and g) at each site of the deraining
   UNet's train step (batch 4, 128 px) and K3's (x, temb and every block
   tensor) at (4, 16, 16, 512), 28 blocks, float32, against the plain
   compositions' (their backwards), within 1e-5 of each gradient's max;
   forward and backward timed, kernel path against plain path; then K4
   under autograd (``phase_flash_backward``): at (2, 4096, 16, 64) one
   launch with a grad_fn and none in the streamed backward, the gradients
   of q, k, v against the un-tiled ``ref_mha_plain``'s (float32 1e-5,
   bfloat16 2e-2 of each max); at the DiT train shape (8, 4096, 16, 64) the
   backward at each block of BWD_BLOCKS, its time and peak memory under its
   limit, and the forward against its plain version, SDPA and the bounds,
   float32 and bfloat16;
20. train nets: one loss and backward of each of the seven full-width
   train nets through its train step (the DiT at batch 1), eager, kernel
   path against plain path, the same parameters, batch and injected
   (timesteps, x_t): the loss within 1e-4, each gradient within 1e-3 of
   its max; exact launches, none in the backward; one DiT step at batch 8
   without and one with remat (48 K4 launches), each with its peak
   memory, and the remat step captured (one graph, its replay's 48 K4);
21. train main path, for each of the seven train YAMLs (TRAIN_PATHS, the
   compressor first, whose last checkpoint the latent and DiT paths load
   as ``pretrain_model_L``): ``train.train`` for the path's steps, each
   replayed from the step's captured graph as the entry point runs it on
   the card (checkpoints half-way and at the end, one validation at the end
   through the task's sampler or, for the compressor, its cross decode),
   each net it builds fresh held to the JAX package's initialisation first
   (``init_check``: flax's constants exact, kernels within 2 sigma', a
   fresh DiT's forward exactly 0), exactly
   ``train_counts`` launches per step (none in the backward) and
   ``val_counts`` per validation image; a finite loss; the run resumed
   eagerly from the half-way checkpoint (no validation, no checkpoint
   written) held against the captured run: bit-equal (losses, final
   parameters, optimizer state, EMA) on the compressor (cuDNN's
   deterministic algorithms: TRAIN_DETERMINISTIC), latent and DiT
   paths; on the pixel, bokeh and stereo paths its first step's loss
   within 1e-6 and the parameters after it within 2 lr, the IR-SDE path's
   two eager runs from that checkpoint printed first; the generators'
   states equal after the last step on every path; the compressor with
   ``grad_accum: 2`` eager, captured and captured from the eager run's
   checkpoint, bit-equal; then the path's plain-path steps (none launching
   a kernel; no checkpoint written); train ms/step, host ms/step and peak
   memory captured and eager, the capture's seconds and pool, and the
   plain path (a record);
22. eval (``phase_eval``, in phase 21's temporary directory, cuDNN TF32 on
   as a user's run has it): each test YAML of EVAL_PATHS through
   ``test.evaluate`` (what the test entry point runs) on its synthetic set,
   exactly ``eval_counts`` K1/K2a/K2b/K3 launches per image (recorded
   around each image the entry point restores), the output, LQ and GT PNGs
   (per eye for stereo) and finite PSNR, SSIM, PSNR-Y and SSIM-Y; seconds
   per image and peak memory per YAML (a record); then CNAFNetLocal over a
   set whose 28-block level's TLSC window covers its map (one K3 a step)
   and one where it does not (none: the 28 blocks run one by one, 2 K1
   each); deraining by tiles with ``tile_device`` (one sampler run per
   chunk of tiles); the inference entry point with ``--sigma 8`` (100 ODE
   steps an image); the restore entry point in its own process, by tiles;
   the compressor's YAML with ``--lpips-pth`` and ``--fid-pth`` (seeded
   weights), the card's LPIPS distances and InceptionV3 features against
   the CPU's within 1e-4 (TF32 off) and their milliseconds per image; and
   Gaussian denoising with its noisy LQ given (the reverse ODE) through the
   kernel path and the plain path of one seeded net, the output PNGs
   within one level of 255.  Every K1, K2 and K3 launch of the phase
   records its site, and after the runs each kernel is held against its
   plain version at every distinct float32 site the test YAMLs gave it
   (K2a up to N = 921600 at 720x1280, K3 up to (1, 90, 160, 512)), with
   phase 3's bounds for K1 and K2 (K2a's ctx against the float64
   composition) and phase 5's for K3.
demo (after phase 21, in its temporary directory): the demo YAMLs of
   configs/demo/ (Refusion stage 1 and 2, stereo SR, bokeh stage 1 and 2),
   copied by ``chip_learn.py``'s code, on ``gen_synth``'s data (DEMO_DATA),
   each through the train entry point for DEMO_STEPS steps and one
   validation (TRAIN_VAL_SAMPLE_T sampler steps), each net it builds
   fresh held by ``init_check``: exactly ``demo_counts`` launches per step
   and per validation image, finite losses and PSNR;
   each stage 2's compressor, named ``{iter}_G`` as the shipped YAMLs name
   it, bit-equal to the ``{iter}_G.pth`` its stage 1 wrote; the test entry
   point on the Refusion stage 2's ``lastest_EMA.pth`` (exact launches per
   image, PNGs, finite metrics); each kernel held against its plain version
   at every site the phase launched it at.  The learning curves are
   ``chip_learn.py``'s;

native (after the build): the native resampler (``data/native.py``)
   built on the card's host from the checkout and taken by ``imresize``
   (counted), matlab x1/4 and bicubic x2 of a NATIVE_SIDE px image within
   NATIVE_BOUND of the numpy weights, both timed; LMDB roots of the
   synthetic deraining set written by ``create_lmdb`` and the deraining
   train dataset from them bit-equal to the same dataset from the folders,
   ms a sample for each;
tools (after eval): ``interpolation`` at TOOLS_SIDE px, T = TOOLS_T (its
   PNGs; the card's states against the CPU's with the same noise),
   ``app``'s restore callable and ``eval_parity`` (exit code 0 at
   ``--target-psnr 0``) on the deraining net's seeded weights with exact
   launches, ``trace_summary`` on a profiler capture of one restore;
ops: ``torch.library.opcheck`` (schema, autograd registration, the fake
   implementation against the kernel's output, the dynamic-shape autograd
   trace) of each operator on CUDA tensors at one site of a path that
   launches it (phase_ops, in ``--ops-child``);
export deraining / latent / denoising: the deraining sampler (posterior,
   bf16 on parameters cast to bf16, per-sample seeds) at a fixed batch of 8
   and at a symbolic batch, the nasde latent sampler at 4 x 512 px and the
   Gaussian denoising sampler at 8 x 128 px, each with its seconds, bytes
   and header, and the eager sampler's outputs for the same inputs and
   generators (K1 and K2 held against their plain versions at the sites of
   the deraining runs, batches 1, 3 and 8);
artifacts: each artifact loaded in a fresh process that builds no net and
   reads no YAML (``--artifact-child``, beside phase 22), each call (the symbolic one at
   batches 1, 3 and 8) against the eager sampler within EXPORT_BOUND
   (bit-equality reported), with exact launches per call, its captured
   chain bit-equal to the artifact loaded with ``capture=False`` (the
   generators' states equal after), and the server's answers byte-equal to
   the eager loader's rows;
serve: the server on the fixed-batch per-sample-seed deraining artifact,
   port 0: /health, SERVE_N requests at SERVE_CONCURRENCY through the port's
   ``bench_serve`` (req/s, p50, p99, mean device batch; one batch's launches
   per device call), the same (image, seed) in two batch compositions with
   the same bytes, every response a PNG of its input's size, seeds -1 and
   2**32 refused with 400 while their companion is served,
   ``seed_reproducible`` as the run showed;
bench: ``python3 bench_cuda.py`` in its own process (batch 8, the captured
   chain), its line checked and printed; its sampler at batch 8 captured
   and eager (img/s, every call's seconds), the two bit-equal; then at
   batches BENCH_SWEEP (exact launches), and K1 and K2 held against their
   plain versions at each sweep batch's sites;
artifacts also loads the symbolic deraining artifact over
   DP_ARTIFACT_DEVICES (``[dp-artifact]``): at DP_ARTIFACT_BATCHES, a chain
   for each row block with its own seeds, bit-equal to the one-device
   loader on the same blocks, within DP_ARTIFACT_BOUND of the eager
   sampler on the whole batch, exact launches;
bench train: ``bench_train`` at BENCH_TRAIN (UNet nf 64 depth 4, batch 32
   at 128 px; the Refusion NAFNet on 64x64x8 latents, batch 32), captured
   then eager, its line (img/s/GPU, MFU against the card's bf16 peak, step
   ms, peak GiB of each form) and exact launches on every step;
bench refusion: ``bench_refusion`` for nafnet and dit at 1024 px, 100
   steps, BENCH_REFUSION_REPS timed calls after two warm-ups, its line and
   exact launches; before each, one one-step call records the sites of
   K1, K2, K3 and K4 and each is held against its plain version there;
train dp (after phase 21's IR-SDE run, in its directory): the train entry
   point under ``torchrun`` (``--dp-child``; run (b), two gloo ranks on the
   card, in phase train tp's torchrun), DP_STEPS steps of batch 4
   resumed from phase 21's half-way checkpoint (DP_AT), for each of
   dp_runs, against phase 21's same steps of its eager run resumed from
   that checkpoint: one rank
   bit-equal; more ranks their first step's loss within 1e-6, its
   all-reduced gradients within DP_GRAD_REL of max|grad| of the same
   ranks' gradients averaged in the script's process and the
   parameters after it within 2 lr_G, the later steps' losses within
   DP_LATER_LOSS; each rank exactly the one-process
   step's launches, the ranks equal, rank 0 alone logging the
   data-parallel line;
train tp (after phase 21's DiT run, in its directory, with its last
   compressor checkpoint): the TP_PATHS YAMLs, each first in this process
   (TP_STEPS eager steps, no validation, no checkpoint; its losses, step
   times and step-1 gradients kept on the host), then all with
   ``train.model_parallel: TP_RANKS`` in one ``torchrun`` (``--ranks-child``,
   TP_RANKS gloo ranks on the card, after train dp's run (b)), cuDNN TF32
   off on both sides: the
   DiT YAML at batch TP_BATCH (DIT_DEPTH K4 a step on a rank's heads at
   TP_SITE; from ``random_pth``'s weights, whose step-1 attention
   gradients are not zero, their max|grad| held above 0) and the
   deraining Refusion YAML (the flagship NAFNet, batch 4
   of 128 px, Lion: 16 K1 and one K3 a step, the K3 at TP_NAF_SITE on the
   28-block level's tensors gathered from the ranks, each launch held
   against its plain version on them).  Rank 0 alone logs the mesh, every
   rank exactly the one-process step's launches, each output with a
   grad_fn, the ranks' losses equal, step 1's loss within TP_LOSS_REL and
   its gradients assembled from the ranks within TP_GRAD_REL of max|grad|
   of the one-process step's, the later losses within DP_LATER_LOSS, the
   split share above TP_SHARE; ms per step on rank 0 against one process,
   peak memory a rank, parameter bytes a rank; then K4 at TP_SITE and K3
   at TP_NAF_SITE held against their plain versions and timed beside
   them (K4 beside SDPA) and their bounds;
dryrun tp: ``dryrun.dryrun_multichip(2)`` (in ``--dryrun-child``), two gloo ranks
   sharing the card as one model group (ConditionalUNet nf 16 split: time
   and ResBlock MLPs, convolutions at least 64 channels wide), the dry
   run's checks (the one-process step's loss, gradients within 2e-4 of
   max|grad|, parameters within 2 lr, each rank the one-process step's
   launches, K1, K2a and K2b among them).

K1 is also timed over one bf16 forward of each path's score net (phases 3,
6, 13, 15 and 17: each site from a CUDA graph of 20 calls, beside
F.layer_norm and the bound by bytes), one ``[k1-path]`` line a path and
``by_path`` on K1's entry of the JSON line.

Launch counts are set to 0 just before each main path and read just after,
less the launches of the warm-ups that precede captures (``Kernel.warmups``,
counted apart: ``request_counts``).
Then a ``[benches]`` JSON line with the two benches' lines, a ``[demo]``
one with the demo stages' records, a ``[serving]`` one with the exports,
loaded calls, served requests and bench, a ``[train]`` one with the train
paths' times (and the data-parallel runs'), an ``[eval]`` one with the test YAMLs' seconds per image, peak memory and
metrics, one JSON line
with each kernel's launches, error, times and bound, and last
``{"ok": true, "device": {...}}``.  Any failed check raises: the
script exits non-zero and prints no result.  Without CUDA it exits at once.

TF32 is off for the whole run (``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32`` False), so float32 comparisons
are float32 on both sides; only phases 21, demo and 22 run the train and
test entry points with torch's default (cuDNN TF32 on), as a user's run
gets it (phase 22's LPIPS, FID and plain-path comparisons turn it off
again).
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "deraining", "test", "ir-sde.yml")
LATENT_CONFIG = os.path.join(REPO, "configs", "latent-dehazing", "test", "nasde.yml")
REFUSION_CONFIG = os.path.join(REPO, "configs", "deraining", "test", "refusion.yml")
DIT_CONFIG = os.path.join(REPO, "configs", "latent-dehazing", "train", "dit.yml")
DENOISE_CONFIG = os.path.join(REPO, "configs", "denoising", "test", "ir-sde.yml")
STEREO_CONFIG = os.path.join(REPO, "configs", "stereo-sr", "test", "refusion.yml")
BOKEH_CONFIG = os.path.join(REPO, "configs", "latent-bokeh", "test", "refusion.yml")
BATCH, SIZE, SEED = 8, 128, 0
ODD_HW = (100, 140)
LN_PER_FORWARD, ATTN_PER_FORWARD = 18, 9
LATENT_BATCH, LATENT_SIZE, LATENT_ODD_HW = 4, 512, (700, 1000)
# per latent request: K1 at the 8 unfused NAFBlocks (2 each) per step plus
# the compressor's 4 (deepest level, encode and decode); K2 twice; K3 once
# per step
NAF_LN_PER_FORWARD, COMPRESSOR_LN, COMPRESSOR_ATTN = 16, 4, 2
# the DiT path's serving constants: posterior sampling at 1024 px, batch 2
DIT_MODE, DIT_BATCH, DIT_SIZE, DIT_ODD_HW = "posterior", 2, 1024, (1000, 700)
TILED_HW, TILE, TILE_OVERLAP, TILE_BATCH = (1536, 1536), 1024, 64, 4
# K5's (BH, N, d): the deraining UNet's 128, 64, 32 and 16 px levels at
# batch 8 x 4 heads (K5b's and K5a's regimes on the TPU), an N where the JAX
# op falls back to its composition, and the other two head dims; one
# gradient through the op at LIN_ATTN_GRAD_SHAPE
LIN_ATTN_SHAPES = [(32, 16384, 32), (32, 4096, 32), (32, 1024, 32), (32, 256, 32), (6, 1000, 32),
                   (8, 4096, 16), (8, 4096, 64)]
LIN_ATTN_GRAD_SHAPE = (4, 1000, 32)
# the serving constants of the denoising, stereo and bokeh paths: batch 8
# at 128 px (the train crop) and one 500x500 image (McMaster's size),
# sigma 50 -> t0 = 414 reverse ODE steps; batch 4 pairs at 128 px and one
# 140x200 pair; batch 4 at 512 px (the train GT_size) and one 700x1000
# image.  K1 and K2 launches per net forward
DENOISE_ODD_HW, DENOISE_T0, DENOISE_LN_PER_FORWARD, DENOISE_ATTN_PER_FORWARD = (500, 500), 414, 17, 8
STEREO_BATCH, STEREO_ODD_HW, STEREO_LN_PER_FORWARD = 4, (140, 200), 144
BOKEH_BATCH, BOKEH_SIZE, BOKEH_ODD_HW, BOKEH_LN_PER_FORWARD = 4, 512, (700, 1000), 72
# the train paths (configs/*/train/*.yml, float32): each YAML as it is but
# for niter, the checkpoint interval and its data, synthetic folders written
# from the seed (the repository holds no dataset).  Per path: its YAML, its
# kind of data (TRAIN_DATA), and the cuts: steps, the checkpoint interval
# (the resumed run starts there; it runs no validation), plain-path steps
# (none for the DiT: its plain attention keeps B H N^2 float32 scores a
# block for the backward, 8.6 GB a block at batch 8; 3 for the others but
# the pixel paths' 4, cut to the script's time limit: the third step is
# timed) and validation images; the validation's sampler cut to
# TRAIN_VAL_SAMPLE_T steps (sample_T, else T, of the YAML).  The compressor
# runs first: its last checkpoint is the latent and DiT paths' frozen
# compressor (stage 2); the bokeh path's compressor (ch 64) is seeded
TRAIN_PATHS = {
    "ir-sde": (("deraining", "train", "ir-sde.yml"), "pixel", 24, 12, 4, 2),
    "refusion": (("deraining", "train", "refusion.yml"), "pixel", 24, 12, 4, 2),
    "compressor": (("unet-latent", "train", "train_haze.yml"), "compressor", 12, 6, 3, 2),
    "latent": (("latent-dehazing", "train", "nasde.yml"), "latent", 8, 4, 3, 1),
    "dit": (("latent-dehazing", "train", "dit.yml"), "latent", 3, 2, 0, 1),
    "bokeh": (("latent-bokeh", "train", "refusion.yml"), "bokeh", 8, 4, 3, 1),
    "stereo": (("stereo-sr", "train", "refusion.yml"), "stereo", 8, 4, 3, 1),
}
LATENT_TRAIN = ("latent", "dit", "bokeh")  # frozen compressor, score net on its latents
TRAIN_VAL_SAMPLE_T = 15
TRAIN_BIT_EQUAL = ("compressor", "latent", "dit")  # captured runs held bit-equal to eager ones
# the paths whose runs take cuDNN's deterministic algorithms: cuDNN's
# default weight-gradient algorithms for the compressor's 256 px stem sum
# in another order from run to run (two eager runs' Lion momenta differ in
# their last bits, their parameters not at all); with deterministic ones
# eager and captured runs are bit-equal there too
TRAIN_DETERMINISTIC = ("compressor",)
# the pixel path whose eager step is run twice from one checkpoint: how far
# the card's own summation order moves a step, the bound the captured step
# is held to on the paths outside TRAIN_BIT_EQUAL
TRAIN_TWIN = "ir-sde"
# the compressor's train.grad_accum: 2 runs (grad_accum_runs): calls, a
# checkpoint half-way
GRAD_ACCUM_STEPS = 4
# the synthetic data by kind: (writer, train images, their side range, the
# validation images' side range): 128-256 px pairs for the 128 px pixel
# crops, 256-320 px for the compressor's 256 px crops, 1024-1280 px for the
# latent paths' 1024 px crops, bokeh triplets for 512 px crops, stereo
# pairs for 128 px (HR) crops; TRAIN_VAL_IMAGES validation images each
TRAIN_DATA = {"pixel": ("pairs", 8, (128, 256), (128, 192)), "compressor": ("pairs", 16, (256, 320), (256, 320)),
              "latent": ("pairs", 8, (1024, 1280), (256, 320)), "bokeh": ("bokeh", 8, (512, 640), (256, 320)),
              "stereo": ("stereo", 8, (128, 192), (128, 160))}
TRAIN_VAL_IMAGES = 2
# phase 20's batch where it cuts the YAML's: the DiT's plain path (its
# attention's B H N^2 float32 scores, ~2 GB a block at batch 1)
TRAIN_NET_BATCH = {"dit": 1}
TRAIN_BATCH, TRAIN_SIZE = 4, 128  # the pixel train paths' batch and crop
TRAIN_NAF_LEVEL = (28, 512)  # the Refusion net's fused level: blocks, channels (at TRAIN_SIZE / 8)
DIT_DEPTH = 24  # DiT-L/2's blocks: K4 launches a forward
# DiT-XL/2 (hidden 1152, 28 blocks, 16 heads of 72), what the bare DiT
# class builds: the DiT YAML with network_G.which_model set to this in
# memory (dit_xl_opt); its main path serves XL_SERVED of the DiT path's
# requests
DIT_XL = "DiT_XL_2"
# K4's (B, N, H, D): the slice first; phase 8 adds the shapes of every DiT
# and tiled request (dit_path_shapes) and of the DiT-XL requests that are
# not among these; the strided views of a packed qkv at FLASH_PACKED
FLASH_SHAPES = [(2, 4096, 16, 64), (1, 2816, 16, 64), (2, 1024, 16, 64), (1, 4096, 16, 72),
                (1, 1000, 16, 64), (3, 35, 4, 64), (1, 1000, 16, 72), (3, 35, 4, 72)]
FLASH_PACKED = [(2, 4096, 16, 64), (2, 4096, 16, 72)]
# host enqueue of one DiT-XL forward: the median of this many, each on an
# idle card (chip_profile.py's ENQUEUE_REPS); sampler steps timed for the
# wall ms a step
ENQUEUE_REPS, XL_TIMED_STEPS = 5, 10
# the DiT-XL main path serves these of phase 10's requests: the first
# posterior batch and the odd image (the second posterior batch and the sde
# batch cut to the script's time limit)
XL_SERVED = (0, 3)
# K4 under autograd (phase 19): the gradient's shape, where the un-tiled
# reference's B H N^2 float32 scores fit (2.1 GB; 8.6 GB at batch 8 and
# ~4x that under autograd), and the DiT-L/2 train step's attention shape
# (batch 8 of 1024 px crops: 128x128x8 latents, 64x64 patches of 2); the
# streamed backward's block sizes swept there, and its peak memory limit:
# FLASH_BWD_BUFFERS float32 (B, H, block, N) buffers (the scores and their
# softmax, the softmax's gradient and, in bf16, the rounded p) and
# FLASH_BWD_ROWS float32 (B, N, H, D) ones (k, v and their accumulators
# in float32, dq, dk, dv, a block's q and cotangent rows)
FLASH_GRAD_SHAPE, FLASH_TRAIN_SHAPE = (2, 4096, 16, 64), (8, 4096, 16, 64)
BWD_BLOCKS = (256, 512, 1024, 2048)
FLASH_BWD_BUFFERS, FLASH_BWD_ROWS = 4, 10
# bf16 K4 against flash_mha_tiled_plain: the share of elements that may lie
# past two ulps (a p whose rounding a float32 difference in s flips)
FLASH_FLIP_SHARE = 5e-4
# serving (phases ops, export, artifacts, serve, bench): opcheck's
# dynamic-shape autograd test (test_aot_dispatch_dynamic) traces K3's plain
# backward, which at 28 blocks takes minutes of host time; K3 takes it at
# this many blocks of the same map (its other tests at 28)
OPCHECK_NAF_DYNAMIC_K = 1
# the latent path's fused level at 512 px: blocks, channels, H, W
LATENT_NAF_LEVEL = (28, 512, 8, 8)
# the symbolic deraining artifact's batches; a loaded call against the eager
# sampler with the same generators: max|d| within this share of max|eager|
# (the step programs run the eager samplers' operators in their order)
EXPORT_SYMBOLIC_BATCHES = (1, 3, 8)
EXPORT_BOUND = 1e-3
# the HTTP server on the fixed-batch deraining artifact: its collection
# window (long enough for a group of concurrent requests to share a call),
# the bench's requests, concurrency and untimed warm-up requests
SERVE_WINDOW_MS, SERVE_N, SERVE_CONCURRENCY, SERVE_WARMUP = 50.0, 32, 8, 8
# bench_cuda.py's batch sweep at 128 px, reps per batch (after two warm-ups):
# its ends, beside bench_cuda.py's own batch 8 (the three PERF.md quotes)
BENCH_SWEEP, BENCH_SWEEP_REPS = (1, 32), 2
BENCH_REPS = 3  # timed calls of each form at batch 8 (bench_cuda.py's default 5, cut to the time limit)
# data parallelism (phase train dp): steps of the deraining train YAML
# under torchrun, resumed from phase 21's half-way checkpoint of that YAML
# (its step DP_RESUME): the steps DP_AT[0]..DP_AT[1], with Adam's moments
# warm.  From a fresh optimizer the first step is a sign step of lr_G on
# every element, which moves the elements whose near-zero gradient flips
# its sign between two sums 2 lr_G apart, and from the JAX package's
# initialisation that first step lifts the deraining UNet's loss sixfold,
# where those moves showed 3.6e-4 in the next loss on an H100.  The
# data-parallel artifact's batches (phase artifacts)
DP_STEPS = 3
DP_RESUME = TRAIN_PATHS["ir-sde"][3]
DP_AT = (DP_RESUME + 1, DP_RESUME + DP_STEPS)
# (b) and (c): the first step's gradients after the all-reduce against the
# same ranks' gradients averaged in this process (block_mean_grads), each
# tensor within this share of its max|grad| (the CPU tests' bound for the
# port's gradients against JAX's); the losses of the later steps against
# the one-process run's, which start from parameters that differ within
# 2 lr_G (1.33e-5 measured from step 1 of torch's default initialisation)
DP_GRAD_REL, DP_LATER_LOSS = 2e-4, 1e-4
DP_ARTIFACT_BATCHES = (3, 8)
DP_ARTIFACT_DEVICES = ["cuda:0", "cuda:0"]
# tensor parallelism (phase train tp): the DiT YAML's first TP_STEPS steps
# through the train entry point with train.model_parallel TP_RANKS, on
# TP_RANKS gloo ranks sharing the card (NCCL takes one rank a card), its
# batch cut from 8 to TP_BATCH (the cut that pays for the two ranks'
# activation all-reduces through the host: 33.5 MB each at batch 2, four a
# block and step); K4 then runs on a rank's 8 of the 16 heads (TP_SITE).
# Step 1 against the one-process step at that batch, rows and generator,
# cuDNN TF32 off on both sides: the loss within TP_LOSS_REL of itself,
# each gradient assembled from the ranks within TP_GRAD_REL of its
# tensor's max|grad| (float32 GEMMs whose sums a row split cuts in two,
# the halves added by the all-reduce); the later steps' losses within
# DP_LATER_LOSS (Lion's first update moves an element by lr_G either way
# where its gradient's sign flips)
TP_STEPS, TP_BATCH, TP_RANKS = 2, 2, 2
TP_GRAD_REL = 2e-4
TP_SITE = (TP_BATCH, 4096, 16 // TP_RANKS, 64)
# and the deraining Refusion YAML at its own batch (TRAIN_BATCH of
# 128 px crops, Lion) in the same torchrun: the flagship NAFNet split (its
# 28-block level's tensors gathered before K3, which runs on the whole
# level at TP_NAF_SITE a rank and step); its step 1 within 1e-6 (a
# NAFNet's partial sums are shorter), the later losses within
# DP_LATER_LOSS (Lion's steps move an element by lr_G either way where a
# near-zero gradient's sign flips); the split share above TP_SHARE (the
# JAX package's bar for the flagship: tests/test_tp_scale.py)
TP_PATHS = {"dit": TP_BATCH, "refusion": None}  # label -> batch (None: the YAML's)
# the paths whose one-process and split runs start from random_pth's
# weights: a fresh DiT's gates are closed (adaLN-Zero), so its step-1
# attention and MLP gradients are exactly 0 and would agree with anything
TP_RANDOM_START = ("dit",)
TP_LOSS_REL = {"dit": 1e-5, "refusion": 1e-6}
TP_SHARE = {"dit": 0.9, "refusion": 0.85}
TP_NAF_SITE = (TRAIN_BATCH, TRAIN_SIZE // 8, TRAIN_SIZE // 8, TRAIN_NAF_LEVEL[1])
# the data-parallel artifact against the eager sampler on the whole batch:
# its blocks run the bf16 chain at other batch sizes, where cuDNN picks
# other algorithms, so a row rounds otherwise; within one bf16 ulp of
# max|eager| (each block is held bit for bit against the one-device loader
# on the same rows)
DP_ARTIFACT_BOUND = 2.0**-8
# the native resampler (phase native): the image side it resizes, and its
# bound against the numpy weights (float64 sums in another order, each
# rounded to float32: one float32 ulp of values in [0, 1] is 6e-8); the
# tools (phase tools): the interpolation's and app's image side and the
# interpolation's steps
NATIVE_SIDE, NATIVE_BOUND = 1024, 1e-6
TOOLS_SIDE, TOOLS_T, TOOLS_TRACE_T = 256, 100, 5
# the benches (phases bench train, bench refusion): bench_train's workloads
# (arch, pipe, batch, crop) at its defaults and its timed steps;
# bench_refusion's arches, image size, steps and timed calls
BENCH_TRAIN = (("unet", "latent", 32, 128), ("refusion", "latent", 32, 1024))
BENCH_TRAIN_STEPS = 5
BENCH_REFUSION, BENCH_REFUSION_SIZE, BENCH_REFUSION_STEPS, BENCH_REFUSION_REPS = ("nafnet", "dit"), 1024, 100, 2
# timing, cut to the script's time limit: the events a measurement may
# spend before it stops at 3 reps (cuda_ms), and the call time above which
# graph_ms times by events (a plain composition of tens of milliseconds;
# a kernel's launch, which events around one call would read, is far below)
TIMING_BUDGET_MS, GRAPH_MS_ABOVE = 200.0, 10.0
# NVIDIA H100 SXM published peaks (dense): HBM bytes/s, and FLOP/s for
# bfloat16 and TF32 on the tensor cores and float32 outside them
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 494.7e12, "float32": 67e12}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


class Background:
    """A child process started now and joined later, so that its work
    (host-bound or light on the card) overlaps the phases in between; its
    output goes to a file and is printed where it is joined, and a non-zero
    exit fails the run.  ``children`` (the script's list of the processes
    it started) holds it until the script ends, which ends it (``end``) if
    it was never joined."""

    def __init__(self, name, argv, children, timeout=900):
        self.name, self.timeout, self.t0 = name, timeout, time.perf_counter()
        self.log = tempfile.TemporaryFile(mode="w+")
        env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
        self.proc = subprocess.Popen(argv, stdout=self.log, stderr=subprocess.STDOUT, text=True, cwd=REPO, env=env)
        children.append(self.proc)

    def join(self, echo=True) -> str:
        """Wait for the child, print its output (``echo``) and its seconds
        since it started; returns the output."""
        rc = self.proc.wait(timeout=self.timeout)
        seconds = time.perf_counter() - self.t0
        self.log.seek(0)
        out = self.log.read()
        self.log.close()
        if echo:
            sys.stdout.write(out)
        print(f"[background] {self.name}: exit {rc}, {seconds:.1f} s from its start to its join")
        check(rc == 0, f"{self.name}: exit code {rc}: {out[-3000:]}")
        return out


def end(proc) -> None:
    """Stop a child process that is still running: SIGTERM (torchrun passes
    it to its ranks), then SIGKILL after 30 s."""
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=60)


def event_ms(fn) -> float:
    """Milliseconds of one call of ``fn`` on the card, by CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` on the card, by CUDA events: ``reps``
    timed calls after ``warmup``, or fewer (at least 3) once the timed
    calls have taken TIMING_BUDGET_MS, for the plain compositions that run
    for tens or hundreds of milliseconds a call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        times.append(event_ms(fn))
        if len(times) >= 3 and sum(times) > TIMING_BUDGET_MS:
            break
    return statistics.median(times)


def graph_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Milliseconds per call of ``fn`` on the card: ``n`` back-to-back calls
    captured in one CUDA graph and replayed (median of ``reps`` replays,
    CUDA events) over ``n``.  For kernels shorter than the host's ~40 us
    per launch, where ``cuda_ms`` around one launch reads the host; a call
    that takes over GRAPH_MS_ABOVE hides the host's launch, and is timed
    by ``cuda_ms``."""
    import torch

    fn()
    if event_ms(fn) > GRAPH_MS_ABOVE:
        return cuda_ms(fn, warmup=0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    return statistics.median(times)


def bf16_bound(ref, ulps: int = 1):
    """Per element: ``ulps`` bfloat16 ulps at its magnitude (both sides
    round a float32 value, either way) plus the float32 bound, 1e-5 of
    max|ref| (near-zero outputs are sums that cancel)."""
    import torch

    mag = ref.float().abs().clamp_min(2.0**-126)
    return ulps * torch.exp2(torch.floor(torch.log2(mag)) - 7) + 1e-5 * mag.max()


def bound(nbytes: float, flops: float, dtype: str):
    """(least ms, "bytes" or "operations"): the larger of the bytes over the
    HBM rate and the operations over the peak rate for ``dtype``."""
    ms_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    ms_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (ms_bytes, "bytes") if ms_bytes >= ms_ops else (ms_ops, "operations")


def flash_f32_bounds(shape):
    """K4 in float32 on (B, N, H, D): ((ms, by) on the FMA units, (ms, by)
    as the kernel's three TF32 products a product at the TF32 peak), the
    function's FLOP and bytes (flash_work) in both."""
    nbytes, flops, _ = flash_work(shape, 4)
    return bound(nbytes, flops, "float32"), bound(nbytes, 3 * flops, "tf32")


def flash_f32_bound_text(shape):
    (f_ms, f_by), (t_ms, t_by) = flash_f32_bounds(shape)
    return f"least {t_ms:.4f} ms ({t_by}) as 3xTF32 on the tensor cores, {f_ms:.4f} ms ({f_by}) on the FMA units"


def naf_blocks(K, C, T, dev, seed):
    """K NAFBlocks' tensors in the reference key space, on the card: kernels
    with variance 1/fan_in, biases and residual scales ~0.1-0.2, gains ~1."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device=dev) * scale + shift

    return [{
        "conv1.weight": randn(2 * C, C, 1, 1, scale=C**-0.5), "conv1.bias": randn(2 * C, scale=0.1),
        "conv2.weight": randn(2 * C, 1, 3, 3, scale=1 / 3), "conv2.bias": randn(2 * C, scale=0.1),
        "sca.1.weight": randn(C, C, 1, 1, scale=C**-0.5), "sca.1.bias": randn(C, scale=0.1, shift=1.0),
        "conv3.weight": randn(C, C, 1, 1, scale=C**-0.5), "conv3.bias": randn(C, scale=0.1),
        "conv4.weight": randn(2 * C, C, 1, 1, scale=C**-0.5), "conv4.bias": randn(2 * C, scale=0.1),
        "conv5.weight": randn(C, C, 1, 1, scale=C**-0.5), "conv5.bias": randn(C, scale=0.1),
        "norm1.g": randn(1, C, 1, 1, scale=0.2, shift=1.0), "norm2.g": randn(1, C, 1, 1, scale=0.2, shift=1.0),
        "beta": randn(1, C, 1, 1, scale=0.2), "gamma": randn(1, C, 1, 1, scale=0.2),
        "mlp.1.weight": randn(4 * C, T // 2, scale=(T // 2) ** -0.5), "mlp.1.bias": randn(4 * C, scale=0.1),
    } for _ in range(K)]


def naf_stack_work(x, blocks):
    """(bytes, FLOP) that K3 must move and do on x (B, H, W, C): each weight
    it reads, x, tmod and the output once; per pixel and block the four 1x1
    products (12 C^2), the depthwise conv (36 C), norms, gates and
    residuals (~30 C), and per sample the SCA product (2 C^2)."""
    from image_restoration_sde_tpu_torch.ops.naf_stack import PARAM_ORDER

    B, H, W, C = x.shape
    K = len(blocks)
    weights = sum(blk[k].numel() for blk in blocks for k in PARAM_ORDER) * 4
    nbytes = weights + 2 * x.numel() * x.element_size() + K * B * 4 * C * 4
    flops = K * (B * H * W * (12 * C * C + 36 * C + 30 * C) + B * 2 * C * C)
    return nbytes, flops


def path_shapes(batch=BATCH):
    """(C, rows) of the 18 LayerNorm sites and N of the 9 attention sites
    of one ConditionalUNet(nf=64, depth=4) forward at ``batch``, 128 px."""
    ln, attn = [], []
    for i in range(4):
        res = SIZE >> i
        down_c, up_c = 64 << i, 64 << (i + 1)
        ln += [(down_c, batch * res * res)] * 2 + [(up_c, batch * res * res)] * 2
        attn += [res * res] * 2
    mid = SIZE >> 3
    ln += [(1024, batch * mid * mid)] * 2
    attn += [mid * mid]
    return ln, attn


def denoise_attn_sites():
    """(batch, N) of the 8 K2 sites of one denoising UNet forward on the
    512 px request (the 500x500 image padded): two per level, no mid-block
    linear attention."""
    h, w = pad64(DENOISE_ODD_HW)
    return [(1, (h >> i) * (w >> i)) for i in range(4) for _ in range(2)]


def la_work(batch, N, itemsize):
    """(bytes, FLOP) of one K2a or one K2b call: K2a reads k and v (256 of
    the 384 channels) and writes ctx, K2b reads q and ctx and writes out
    (256 channels of traffic a row either way); 2 FLOP for each of a head's
    32 x 32 products a row, and 4 for each exponential and sum."""
    ctx_bytes = batch * 4 * 32 * 32 * 4
    return batch * N * 256 * itemsize + ctx_bytes, 2 * batch * N * 4 * 32 * 32 + 4 * batch * N * 128


def ln_work(sites):
    """(bytes, FLOP) of K1 over bf16 (C, rows) sites: x read and y written
    once, g (float32) read once a site; ~8 FLOP an element."""
    return sum(2 * rows * C * 2 + C * 4 for C, rows in sites), sum(8 * rows * C for C, rows in sites)


def k1_site_times(dev, sites):
    """{(C, rows): (K1 ms, F.layer_norm ms)} for each distinct bf16 site
    (eps 1e-3, seeded x and g), each from a CUDA graph of 20 calls."""
    import torch
    import torch.nn.functional as F

    from image_restoration_sde_tpu_torch.ops import layernorm as LN

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 23)
    times = {}
    for C, rows in sorted(set(sites)):
        x = (torch.randn(rows, C, generator=gen, device=dev) * 2 + 0.5).bfloat16()
        g = torch.randn(C, generator=gen, device=dev) * 0.2 + 1
        g_lib = g.bfloat16()
        times[C, rows] = (graph_ms(lambda: LN.channel_layernorm_cuda(x, g, 1e-3)),
                          graph_ms(lambda: F.layer_norm(x, (C,), g_lib, None, 1e-3)))
    return times


def k1_path(label, sites, times, stats):
    """Print and record (stats[K1]["by_path"]) K1 over one forward's bf16
    sites: the sum of each site's time, its bound by bytes and
    F.layer_norm's sum."""
    from image_restoration_sde_tpu_torch.ops import LAYERNORM

    ms = sum(times[site][0] for site in sites)
    lms = sum(times[site][1] for site in sites)
    bms, by = bound(*ln_work(sites), "bfloat16")
    print(f"[k1-path] {label}: {len(sites)} K1 launches a forward over {len(set(sites))} (C, rows) sites, bf16: "
          f"K1 {ms:.4f} ms, least {bms:.4f} ms ({by}), F.layer_norm {lms:.4f} ms (graphs of 20 calls per site)")
    stats[LAYERNORM]["by_path"][label] = {"launches": len(sites), "ms": ms, "bound_ms": bms, "bound_by": by,
                                          "library_ms": lms}


def counts(**nonzero):
    """Expected launch counts by kernel symbol: the named kernels' (by
    their ops attribute name), 0 for every other kernel of ops.KERNELS."""
    from image_restoration_sde_tpu_torch import ops

    want = {k.symbol: 0 for k in ops.KERNELS}
    want.update({getattr(ops, name).symbol: n for name, n in nonzero.items()})
    return want


def request_counts() -> dict:
    """Each kernel's launches by symbol, less those made warming a captured
    chain up before its capture (``Kernel.warmups``, counted apart): the
    launches and replayed graph nodes of the requests themselves."""
    from image_restoration_sde_tpu_torch.ops import KERNELS

    return {k.symbol: k.launches - k.warmups for k in KERNELS}


def reset_counts() -> None:
    """Every kernel's launches and warm-up launches set to 0."""
    from image_restoration_sde_tpu_torch.ops import KERNELS

    for k in KERNELS:
        k.launches = k.warmups = 0


def warmup_counts() -> dict:
    from image_restoration_sde_tpu_torch.ops import KERNELS

    return {k.symbol: k.warmups for k in KERNELS if k.warmups}


def pad64(hw):
    return tuple(-(-n // 64) * 64 for n in hw)


def latent_requests():
    """(batch, H, W) of the latent path's requests after padding."""
    return [(LATENT_BATCH, LATENT_SIZE, LATENT_SIZE), (1, *pad64(LATENT_ODD_HW))]


def dit_requests():
    """(batch, H, W) of the DiT path's requests after padding, and of the
    tiled path's one sampler call (TILE_BATCH tiles of TILE px)."""
    return [(DIT_BATCH, DIT_SIZE, DIT_SIZE), (1, *pad64(DIT_ODD_HW)), (TILE_BATCH, TILE, TILE)]


def compressor_shapes(comp, requests):
    """(C, rows) of the K1 sites and (batch, N) of the K2 sites of the
    compressor's deepest level at H/8 (K1 at its two widths, K2 once per
    width) for each (batch, H, W) request."""
    ln, attn = set(), set()
    for batch, h, w in requests:
        lh, lw = h // 8, w // 8
        ln |= {(comp["ch"] * m, batch * lh * lw) for m in comp["ch_mult"][-2:]}
        attn.add((batch, lh * lw))
    return ln, attn


def dit_path_shapes(dit_opt, requests=None):
    """The DiT and tiled paths' kernel shapes (or those of ``requests``):
    the compressor's K1 (C, rows) and K2 (batch, N), and K4's (B, N, H, D)
    on the latent's patch grid."""
    import torch

    from image_restoration_sde_tpu_torch.models import build_network

    requests = requests or dit_requests()
    with torch.device("meta"):
        net = build_network(dit_opt["network_G"]["which_model"], dit_opt["network_G"]["setting"])
    p, heads = net.patch_size, net.blocks[0].attn.heads
    dh = net.blocks[0].attn.proj.in_features // heads
    ln, attn = compressor_shapes(dit_opt["network_L"]["setting"], requests)
    flash = [(batch, (h // 8 // p) * (w // 8 // p), heads, dh) for batch, h, w in requests]
    return sorted(ln), sorted(attn), flash


def dit_xl_opt(dit_opt):
    """The DiT YAML with ``network_G.which_model`` set to DIT_XL."""
    import copy

    opt = copy.deepcopy(dit_opt)
    opt["network_G"]["which_model"] = DIT_XL
    return opt


def latent_path_shapes(latent_opt):
    """(C, rows) of the K1 sites and (batch, N) of the K2 sites that the
    latent path gives its kernels, for both request shapes (batch 4 at
    512 px, and one 700x1000 image padded to 704x1024): the compressor's
    (compressor_shapes), and the NAFNet's levels that run an unfused block,
    on the latent zero-padded to a multiple of 2^depth (a run of 4 or more
    blocks runs K3 instead)."""
    naf = latent_opt["network_G"]["setting"]
    enc, dec = naf["enc_blk_nums"], naf["dec_blk_nums"]
    runs = [(enc[i], dec[len(dec) - 1 - i]) for i in range(len(enc))] + [(naf["middle_blk_num"],)]
    ln, attn = compressor_shapes(latent_opt["network_L"]["setting"], latent_requests())
    for batch, h, w in latent_requests():
        lh, lw = h // 8, w // 8
        pad = 2 ** len(enc)
        ph, pw = -(-lh // pad) * pad, -(-lw // pad) * pad
        for i, nums in enumerate(runs):
            if any(0 < n < 4 for n in nums):
                ln.add((naf["width"] << i, batch * (ph >> i) * (pw >> i)))
    return sorted(ln), sorted(attn)


# ---------------------------------------------------------------- phases
def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.device_count()} visible; nvidia-smi:")
    print(smi)
    return smi


def phase_build():
    from image_restoration_sde_tpu_torch import kernels

    path, seconds = kernels.build()
    kernels.load_library()
    print(f"[build] {path.relative_to(REPO)} built in {seconds:.1f} s")
    for line in (path.parent / "ptxas.log").read_text().splitlines():
        if any(w in line for w in ("Used", "spill", "Compiling entry", "Performance", "setmaxnreg", "rror")):
            print(f"[build]   {line.strip()}")


def phase_kernels(dev, stats, latent_opt, dit_opt):
    import torch
    import torch.nn.functional as F

    from image_restoration_sde_tpu_torch.ops import layernorm as LN
    from image_restoration_sde_tpu_torch.ops import linear_attention as LA

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    ln_sites, attn_sites = path_shapes()
    latent_ln, latent_attn = latent_path_shapes(latent_opt)
    dit_ln, dit_attn, _ = dit_path_shapes(dit_opt)

    # K1 at the deraining path's sites (the ones its stats sum), two ragged
    # shapes and the latent, DiT and tiled paths' sites: bf16 (eps 1e-3) and
    # f32 (eps 1e-5); bound: f32 1e-5 of max|y|, bf16 bf16_bound.  Library
    # call: F.layer_norm on the same rows (its bias-free affine with g in
    # x's dtype)
    shapes = sorted(set(ln_sites))
    shapes += sorted({(64, 1001), (1024, 999), *latent_ln, *dit_ln} - set(shapes))
    site_times = {}
    for dtype, eps in ((torch.bfloat16, 1e-3), (torch.float32, 1e-5)):
        for C, rows in shapes:
            x = (torch.randn(rows, C, generator=gen, device=dev) * 2 + 0.5).to(dtype)
            g = torch.randn(C, generator=gen, device=dev) * 0.2 + 1
            y = LN.channel_layernorm_cuda(x, g, eps)
            ref = LN.channel_layernorm_plain(x, g, eps)
            err = (y.float() - ref.float()).abs()
            if dtype == torch.float32:
                ok = err.max().item() <= 1e-5 * ref.abs().max().item()
            else:
                ok = bool((err <= bf16_bound(ref)).all())
            stats[LN.LAYERNORM]["err"] = max(stats[LN.LAYERNORM]["err"], err.max().item())
            check(ok, f"K1 {dtype} C={C} rows={rows}: max|dy|={err.max().item():.3g}")
            g_lib = g.to(dtype)
            timer = graph_ms if dtype == torch.bfloat16 and (C, rows) in ln_sites else cuda_ms
            ms = timer(lambda: LN.channel_layernorm_cuda(x, g, eps))
            pms = timer(lambda: LN.channel_layernorm_plain(x, g, eps))
            lms = timer(lambda: F.layer_norm(x, (C,), g_lib, None, eps))
            ems = cuda_ms(lambda: LN.channel_layernorm_cuda(x, g, eps)) if timer is graph_ms else ms
            how = "graph of 20" if timer is graph_ms else "events"
            print(f"[kernels] K1 {str(dtype)[6:]:8s} C={C:5d} rows={rows:6d} max|dy|={err.max().item():.3g} "
                  f"kernel {ms:.4f} ms plain {pms:.4f} ms F.layer_norm {lms:.4f} ms ({how}; "
                  f"kernel by events around one launch {ems:.4f} ms)")
            if timer is graph_ms:
                site_times[C, rows] = (ms, lms)
                n = ln_sites.count((C, rows))
                stats[LN.LAYERNORM]["ms"] += n * ms
                stats[LN.LAYERNORM]["event_ms"] += n * ems
                stats[LN.LAYERNORM]["plain_ms"] += n * pms
                stats[LN.LAYERNORM]["library_ms"] += n * lms
    # bound over one forward's 18 sites, bf16: read x, write y, read g
    stats[LN.LAYERNORM]["bound_ms"], stats[LN.LAYERNORM]["bound_by"] = bound(*ln_work(ln_sites), "bfloat16")
    k1_path(f"deraining {BATCH}x{SIZE}px", ln_sites, site_times, stats)

    # K2a / K2b at the deraining path's N (batch 8), the denoising 512 px
    # request's (batch 1), N = 1 and a ragged N, and the latent, DiT and
    # tiled paths' (batch, N); bound: ctx (f32) and f32 outputs 1e-5 of
    # max|ref| (ctx against the float64 composition past N = 16384, where
    # the plain float32 version's own sums drift past that bound); bf16
    # outputs bf16_bound.  Every pair runs each kernel twice: the two runs
    # must be bit-equal
    denoise_sites = denoise_attn_sites()
    timed_sites = {(BATCH, N) for N in attn_sites} | set(denoise_sites)
    pairs = [(BATCH, N) for N in sorted(set(attn_sites), reverse=True)]
    pairs += sorted(set(denoise_sites), reverse=True)
    pairs += sorted({(BATCH, 36), (3, 1), *latent_attn, *dit_attn} - set(pairs))
    per_step = {"K2a": 0.0, "K2b": 0.0, "K2a events": 0.0, "K2b events": 0.0, "bound": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for batch, N in pairs:
            qkv = (torch.randn(batch, N, 384, generator=gen, device=dev) * 1.5).to(dtype)
            ctx = LA.linear_attention_ctx_cuda(qkv)
            ctx_ref = LA.linear_attention_ctx_plain(qkv)
            if N > 16384:
                ref64 = ctx_float64(qkv)
                cerr = (ctx.double() - ref64).abs().max().item()
                cbound, cref = 1e-5 * ref64.abs().max().item(), "float64 composition"
                del ref64
            else:
                cerr = (ctx - ctx_ref).abs().max().item()
                cbound, cref = 1e-5 * ctx_ref.abs().max().item(), "plain"
            check(cerr <= cbound, f"K2a {dtype} B={batch} N={N}: max|dctx|={cerr:.3g} against the {cref}")
            out = LA.linear_attention_apply_cuda(qkv, ctx_ref)
            ref = LA.linear_attention_apply_plain(qkv, ctx_ref)
            err = (out.float() - ref.float()).abs()
            if dtype == torch.float32:
                ok = err.max().item() <= 1e-5 * ref.abs().max().item()
            else:
                ok = bool((err <= bf16_bound(ref)).all())
            check(ok, f"K2b {dtype} B={batch} N={N}: max|dout|={err.max().item():.3g}")
            same = (torch.equal(ctx, LA.linear_attention_ctx_cuda(qkv))
                    and torch.equal(out, LA.linear_attention_apply_cuda(qkv, ctx_ref)))
            check(same, f"K2 {dtype} B={batch} N={N}: two runs differ")
            stats[LA.LA_CTX]["err"] = max(stats[LA.LA_CTX]["err"], cerr)
            stats[LA.LA_APPLY]["err"] = max(stats[LA.LA_APPLY]["err"], err.max().item())
            site = dtype == torch.bfloat16 and (batch, N) in timed_sites
            timer = graph_ms if site else cuda_ms
            ms_c = timer(lambda: LA.linear_attention_ctx_cuda(qkv))
            pms_c = timer(lambda: LA.linear_attention_ctx_plain(qkv))
            ms_a = timer(lambda: LA.linear_attention_apply_cuda(qkv, ctx_ref))
            pms_a = timer(lambda: LA.linear_attention_apply_plain(qkv, ctx_ref))
            ems_c = cuda_ms(lambda: LA.linear_attention_ctx_cuda(qkv)) if site else ms_c
            ems_a = cuda_ms(lambda: LA.linear_attention_apply_cuda(qkv, ctx_ref)) if site else ms_a
            bms, by = bound(*la_work(batch, N, qkv.element_size()), str(dtype)[6:])
            print(f"[kernels] K2 {str(dtype)[6:]:8s} B={batch} N={N:6d} max|dctx|={cerr:.3g} ({cref}) "
                  f"max|dout|={err.max().item():.3g} bit-equal reruns "
                  f"K2a {ms_c:.4f} ms plain {pms_c:.4f} ms | K2b {ms_a:.4f} ms plain {pms_a:.4f} ms | "
                  f"least {bms:.4f} ms each ({by}) ({'graph of 20' if site else 'events'}; kernels by events "
                  f"around one launch {ems_c:.4f} / {ems_a:.4f} ms)")
            if site and batch == BATCH:
                n = attn_sites.count(N)
                stats[LA.LA_CTX]["ms"] += n * ms_c
                stats[LA.LA_CTX]["event_ms"] += n * ems_c
                stats[LA.LA_CTX]["plain_ms"] += n * pms_c
                stats[LA.LA_APPLY]["ms"] += n * ms_a
                stats[LA.LA_APPLY]["event_ms"] += n * ems_a
                stats[LA.LA_APPLY]["plain_ms"] += n * pms_a
            if site and (batch, N) in denoise_sites:
                n = denoise_sites.count((batch, N))
                for key, v in (("K2a", ms_c), ("K2b", ms_a), ("K2a events", ems_c), ("K2b events", ems_a),
                               ("bound", bms)):
                    per_step[key] += n * v
            del qkv, ctx, ctx_ref, out, ref, err
    print(f"[kernels] K2 bf16 over one denoising 512 px step's {len(denoise_sites)} sites: K2a "
          f"{per_step['K2a']:.4f} ms, K2b {per_step['K2b']:.4f} ms (graphs of 20; by events around one launch "
          f"{per_step['K2a events']:.4f} / {per_step['K2b events']:.4f} ms), least {per_step['bound']:.4f} ms each")
    # bounds over one deraining forward's 9 sites, bf16
    work = [la_work(BATCH, N, 2) for N in attn_sites]
    for k in (LA.LA_CTX, LA.LA_APPLY):
        stats[k]["bound_ms"], stats[k]["bound_by"] = bound(sum(w[0] for w in work), sum(w[1] for w in work),
                                                           "bfloat16")

    phase_naf_stack(dev, stats)
    check_gradients(dev)


def check_gradients(dev):
    """The packed op's gradient on the card (its forward launches K2a and
    K2b, its backward is the plain composition's) against the plain
    composition's, float32, within 1e-5 of max|grad|; and K1, K3 and K4
    return outputs with a grad_fn under grad (their gradients are held in
    phase 19)."""
    import torch

    from image_restoration_sde_tpu_torch.ops import flash_attention as FA
    from image_restoration_sde_tpu_torch.ops import layernorm as LN
    from image_restoration_sde_tpu_torch.ops import linear_attention as LA
    from image_restoration_sde_tpu_torch.ops import naf_stack as NS

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 18)
    qkv = (torch.randn(2, 1000, 384, generator=gen, device=dev) * 1.5).requires_grad_()
    g = torch.randn(2, 1000, 128, generator=gen, device=dev)
    before = (LA.LA_CTX.launches, LA.LA_APPLY.launches)
    out = LA.linear_attention_packed(qkv)
    check((LA.LA_CTX.launches - before[0], LA.LA_APPLY.launches - before[1]) == (1, 1),
          "K2 gradient: the forward did not launch K2a and K2b once each")
    (got,) = torch.autograd.grad(out, qkv, g)
    (want,) = torch.autograd.grad(LA.linear_attention_packed_plain(qkv), qkv, g)
    rel = ((got - want).abs().max() / want.abs().max()).item()
    check(rel <= 1e-5, f"K2 gradient: max|dgrad| / max|grad| = {rel:.3g}")

    x = torch.randn(64, 64, generator=gen, device=dev)
    w = torch.ones(64, device=dev, requires_grad=True)
    blocks = naf_blocks(2, 64, 64, dev, SEED + 19)
    blocks[0]["conv1.weight"].requires_grad_()
    q = torch.randn(1, 64, 2, 64, generator=gen, device=dev, requires_grad=True)
    graphed = []
    temb = torch.randn(2, 64, generator=gen, device=dev)
    for name, call in (("K1", lambda: LN.channel_layernorm(x, w, 1e-5)),
                       ("K3", lambda: NS.naf_stack(x.view(2, 4, 8, 64), blocks, temb, 1e-5)),
                       ("K4", lambda: FA.flash_mha(q, q, q, 0.125))):
        if call().grad_fn is not None:
            graphed.append(name)
    check(graphed == ["K1", "K3", "K4"], f"grad functions: {graphed} returned a grad_fn")
    print(f"[kernels] K2 gradient through the op on the card at (2, 1000, 384) f32: max|dgrad| / max|grad| = "
          f"{rel:.3g} (bound 1e-5); K1, K3 and K4 differentiable")


def hold_naf_stack(tag, x, blocks, tmod, stacked, eps):
    """K3 on ``x`` against its plain version.  Bound: f32 1e-4 of max|ref|;
    bf16 twice the plain bf16 result's distance from the plain float32
    result on the same input.

    Each block's rounding is held block by block: the K blocks run again as
    K chained one-block launches, each against the one-block plain version
    on the same input (f32 1e-5 of max|ref|, bf16 bf16_bound: one ulp), and
    the chain's end must equal the K-block launch bit for bit (every sum
    runs in a fixed order and the grid is sized without K, so a kernel that
    kept the activation in float32 across blocks would differ).  Returns
    (max|dy|, its bound, the one-block chain's max|dy|)."""
    import torch

    from image_restoration_sde_tpu_torch.ops import naf_stack as NS

    K, dtype, shape = len(blocks), x.dtype, tuple(x.shape)
    y = NS.naf_stack_cuda(x, blocks, tmod, eps)
    ref = NS.naf_stack_plain(x, stacked, eps)
    err = (y.float() - ref.float()).abs().max().item()
    check(bool(torch.isfinite(y).all()), f"{tag}: K3 {dtype} {shape}: output not finite")
    if dtype == torch.float32:
        limit = 1e-4 * ref.abs().max().item()
    else:
        limit = 2 * (ref.float() - NS.naf_stack_plain(x.float(), stacked, eps)).abs().max().item()
    check(err <= limit, f"{tag}: K3 {dtype} {shape} K={K}: max|dy|={err:.3g} (bound {limit:.3g})")
    z, one_err = x, 0.0
    for i in range(K):
        zi = NS.naf_stack_cuda(z, blocks[i : i + 1], tmod[i : i + 1], eps)
        one = NS.naf_stack_plain(z, {k: v[i : i + 1] for k, v in stacked.items()}, eps)
        e = (zi.float() - one.float()).abs()
        if dtype == torch.float32:
            ok = e.max().item() <= 1e-5 * one.abs().max().item()
        else:
            ok = bool((e <= bf16_bound(one)).all())
        check(ok, f"{tag}: K3 {dtype} {shape} block {i} alone: max|dy|={e.max().item():.3g}")
        one_err, z = max(one_err, e.max().item()), zi
    check(torch.equal(z, y), f"{tag}: K3 {dtype} {shape}: K={K} in one launch differs from {K} chained launches")
    return err, limit, one_err


def naf_stack_inputs(shape, K, dev, gen):
    """Seeded inputs of K3 on a (B, H, W, C) map: K blocks (naf_blocks), x
    and a time embedding; returns (x float32, blocks, tmod, stacked)."""
    import torch

    from image_restoration_sde_tpu_torch.ops import naf_stack as NS

    C = shape[-1]
    blocks = naf_blocks(K, C, 4 * C // 8, dev, SEED + K)
    x32 = torch.randn(shape, generator=gen, device=dev)
    temb = torch.randn(shape[0], 4 * C // 8, generator=gen, device=dev)
    return x32, blocks, NS.time_modulation(blocks, temb), NS.stack_middle_params(blocks, temb)


def phase_naf_stack(dev, stats):
    """K3 against its plain version (hold_naf_stack) at the latent path's
    shapes (28 blocks, C = 512): batch 4 at 512 px, the 700x1000 request's
    12x16 map, the deraining Refusion net's 16x16 map at batch 8; and a
    ragged 3x5x7x64 stack of 4; bf16 and f32, each timed."""
    import torch

    from image_restoration_sde_tpu_torch.ops import naf_stack as NS

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    main_shape = (LATENT_BATCH, 8, 8, 512)
    cases = [(main_shape, 28), ((1, 12, 16, 512), 28), ((8, 16, 16, 512), 28), ((3, 5, 7, 64), 4)]
    for shape, K in cases:
        x32, blocks, tmod, stacked = naf_stack_inputs(shape, K, dev, gen)
        for dtype, eps in ((torch.bfloat16, 1e-3), (torch.float32, 1e-5)):
            x = x32.to(dtype)
            err, limit, one_err = hold_naf_stack("kernels", x, blocks, tmod, stacked, eps)
            stats[NS.NAF_STACK]["err"] = max(stats[NS.NAF_STACK]["err"], err)
            # the card's time from a CUDA graph of 5 launches; beside it one launch
            # between CUDA events, the earlier figure, which also holds the host's
            # ~0.5-1 ms of pointer-table and argument work before each launch
            ms = graph_ms(lambda: NS.naf_stack_cuda(x, blocks, tmod, eps), n=5, reps=3)
            ems = cuda_ms(lambda: NS.naf_stack_cuda(x, blocks, tmod, eps), reps=10)
            pms = cuda_ms(lambda: NS.naf_stack_plain(x, stacked, eps), reps=10)
            nbytes, flops = naf_stack_work(x, blocks)
            # K3 computes in float32 (FMA) whatever x's dtype: the float32 peak
            bms, by = bound(nbytes, flops, "float32")
            print(f"[kernels] K3 {str(dtype)[6:]:8s} {shape} K={K}: max|dy|={err:.3g} (bound {limit:.3g}), "
                  f"one block at a time max|dy|={one_err:.3g}, chained launches bit-equal; "
                  f"kernel {ms:.4f} ms (graph of 5; one launch between events {ems:.4f} ms) plain {pms:.4f} ms; "
                  f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP, "
                  f"least {bms:.4f} ms ({by}, float32 FMA; bytes alone {bound(nbytes, 0, 'float32')[0]:.4f} ms), "
                  f"{nbytes / ms / 1e9:.3f} TB/s, {flops / ms / 1e9:.2f} TFLOP/s")
            if dtype == torch.bfloat16 and shape == main_shape:
                stats[NS.NAF_STACK].update(ms=ms, event_ms=ems, plain_ms=pms, bound_ms=bms, bound_by=by)


@contextlib.contextmanager
def recorded_naf_sites():
    """Record the (map shape, blocks, dtype, eps) of every K3 launch made
    inside the block, into the yielded list."""
    from image_restoration_sde_tpu_torch.ops import naf_stack as NS

    sites, cuda = [], NS.naf_stack_cuda

    def rec(x, blocks, tmod, eps):
        sites.append((tuple(x.shape), len(blocks), x.dtype, eps))
        return cuda(x, blocks, tmod, eps)

    NS.naf_stack_cuda = rec
    try:
        yield sites
    finally:
        NS.naf_stack_cuda = cuda


def hold_naf_sites(tag, dev, sites, stats):
    """K3 against its plain version (hold_naf_stack) at each recorded (map
    shape, blocks, dtype, eps) site, on seeded blocks and inputs."""
    import torch

    from image_restoration_sde_tpu_torch.ops import naf_stack as NS

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 16)
    for shape, K, dtype, eps in sorted(set(sites), key=str):
        x32, blocks, tmod, stacked = naf_stack_inputs(shape, K, dev, gen)
        err, limit, one_err = hold_naf_stack(tag, x32.to(dtype), blocks, tmod, stacked, eps)
        stats[NS.NAF_STACK]["err"] = max(stats[NS.NAF_STACK]["err"], err)
        print(f"[{tag}] K3 {str(dtype)[6:]} {shape} K={K} eps {eps:g}: max|dy|={err:.3g} (bound {limit:.3g}), "
              f"one block at a time max|dy|={one_err:.3g}, chained launches bit-equal")
        del x32, blocks, tmod, stacked


def make_net(cls, setting, dtype, plain, dev, state=None):
    import torch

    from image_restoration_sde_tpu_torch.models import init_params_

    if state is None:
        # init_params_ sets every parameter (the nets hold no buffers), from
        # the CPU generator: no default initialiser runs
        with torch.device("meta"):
            net = cls(**setting, dtype=dtype, plain=plain)
        gen = torch.Generator()
        gen.manual_seed(SEED)
        init_params_(net.to_empty(device=dev), gen)
    else:
        with torch.device(dev):  # the default initialisers run on the card; state's weights replace them
            net = cls(**setting, dtype=dtype, plain=plain)
        net.load_state_dict(state)
    return net.to(dev).eval()


def make_nets(cls, setting, dev):
    """The same seeded weights in the four (dtype, plain) variants."""
    import torch

    nets, state = {}, None
    for dtype in (torch.bfloat16, torch.float32):
        for plain in (False, True):
            nets[dtype, plain] = make_net(cls, setting, dtype, plain, dev, state)
            state = nets[dtype, plain].state_dict()
    return nets


def compare_nets(tag, name, nets, inputs):
    """One forward of each variant: kernel path against plain path.  f32:
    the two agree to float32 rounding through the net, 1e-4 of max|ref|;
    bf16: the kernel path may differ from the plain bf16 path by at most
    twice the plain bf16 path's own distance from float32."""
    import torch

    with torch.inference_mode():
        outs = {key: net(*inputs) for key, net in nets.items()}
    torch.cuda.synchronize()
    for o in outs.values():
        check(o.shape == inputs[0].shape and bool(torch.isfinite(o).all()), f"{name}: output shape/finite")
    f32_ref = outs[torch.float32, True]
    f32_err = (outs[torch.float32, False] - f32_ref).abs().max().item()
    f32_bound = 1e-4 * f32_ref.abs().max().item()
    bf_err = (outs[torch.bfloat16, False] - outs[torch.bfloat16, True]).abs().max().item()
    bf_floor = (outs[torch.bfloat16, True] - f32_ref).abs().max().item()
    print(f"[{tag}] {name}: f32 kernel-vs-plain max|d|={f32_err:.3g} (bound {f32_bound:.3g}); "
          f"bf16 kernel-vs-plain max|d|={bf_err:.3g} (bound 2 x bf16-vs-f32 {bf_floor:.3g})")
    check(f32_err <= f32_bound, f"f32 {name}: kernel path differs from plain path")
    check(bf_err <= 2 * bf_floor, f"bf16 {name}: kernel path differs from plain path")


def phase_net(dev, setting, sde_opt):
    import torch

    from image_restoration_sde_tpu_torch.models import ConditionalUNet
    from image_restoration_sde_tpu_torch.sampling import make_restoration_sampler
    from image_restoration_sde_tpu_torch.sde import IRSDE

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    lq = torch.rand(BATCH, SIZE, SIZE, 3, generator=gen, device=dev)
    xt = lq + 10 / 255 * torch.randn(lq.shape, generator=gen, device=dev)
    t = torch.randint(1, 101, (BATCH,), generator=gen, device=dev)

    nets = make_nets(ConditionalUNet, setting, dev)
    compare_nets("net", f"nf={setting['nf']} depth={setting['depth']} batch {BATCH} {SIZE}px", nets, (xt, lq, t))

    # 100-step f32 posterior chain, kernel vs plain, on a small input with
    # the same seeded noise; bound 1e-3 of max|ref|
    sde = IRSDE.create(sde_opt["max_sigma"], sde_opt["T"], sde_opt["schedule"], sde_opt["eps"], device=dev)
    small = lq[:2, :32, :32]
    chain = {}
    for plain in (False, True):
        g = torch.Generator(device=dev)
        g.manual_seed(SEED + 2)
        chain[plain] = make_restoration_sampler(sde, nets[torch.float32, plain], mode="posterior",
                                                capture=False)(small, g)
    c_err = (chain[False] - chain[True]).abs().max().item()
    c_bound = 1e-3 * chain[True].abs().max().item()
    print(f"[net] 100-step f32 posterior chain 2x32x32 kernel-vs-plain max|d|={c_err:.3g} (bound {c_bound:.3g})")
    check(bool(torch.isfinite(chain[False]).all()) and c_err <= c_bound, "f32 chain: kernel path differs from plain path")
    return nets[torch.bfloat16, False]


def phase_main_path(dev, net, sde_opt, smi):
    """The deraining sampler serves two posterior batches of 8, one sde
    batch of 8 and the odd 100x140 image (padded to 128x192)."""
    from image_restoration_sde_tpu_torch.sampling import make_restoration_sampler
    from image_restoration_sde_tpu_torch.sde import IRSDE

    sde = IRSDE.create(sde_opt["max_sigma"], sde_opt["T"], sde_opt["schedule"], sde_opt["eps"], device=dev)
    samplers = {m: make_restoration_sampler(sde, net, mode=m) for m in ("posterior", "sde")}
    eager = {"posterior": make_restoration_sampler(sde, net, mode="posterior", capture=False)}
    gen = rng_generator(dev, SEED + 3)
    rng = np.random.default_rng(SEED + 3)
    requests = [("posterior", rng.random((BATCH, SIZE, SIZE, 3), np.float32), (gen,)),
                ("posterior", rng.random((BATCH, SIZE, SIZE, 3), np.float32), (gen,)),
                ("sde", rng.random((BATCH, SIZE, SIZE, 3), np.float32), (gen,)),
                ("posterior", rng.random((1, *ODD_HW, 3), np.float32), (gen,))]
    # one chunk: the default runs the whole batch at once
    want = counts(LAYERNORM=LN_PER_FORWARD * sde.T, LA_CTX=ATTN_PER_FORWARD * sde.T, LA_APPLY=ATTN_PER_FORWARD * sde.T)
    return serve("main", dev, requests, samplers, want, smi, BATCH, pad=64, eager=eager, steps=sde.T,
                 compare=(0, 3))


def compare_compressor(tag, compressor, plain, img):
    """The float32 compressor's kernel path against its plain path on one
    image batch: encode (the latent and every skip), then decode of the
    plain path's latent and skips; each within 1e-4 of max|ref|.  Encode
    and decode together launch K1 4 times and K2a, K2b twice each."""
    import torch

    from image_restoration_sde_tpu_torch.ops import LA_APPLY, LA_CTX, LAYERNORM

    counted = (LAYERNORM, LA_CTX, LA_APPLY)
    before = [k.launches for k in counted]
    with torch.inference_mode():
        latent, hs = compressor.encode(img)
        latent_ref, hs_ref = plain.encode(img)
        out = compressor.decode(latent_ref, hs_ref, img.shape[1:3])
        ref = plain.decode(latent_ref, hs_ref, img.shape[1:3])
    grew = [k.launches - b for k, b in zip(counted, before)]
    check(grew == [COMPRESSOR_LN, COMPRESSOR_ATTN, COMPRESSOR_ATTN], f"compressor launches {grew}")
    worst = 0.0
    for name, got, want in [("latent", latent, latent_ref), *((f"skip {i}", a, b) for i, (a, b) in
                                                              enumerate(zip(hs, hs_ref))), ("decode", out, ref)]:
        err = (got - want).abs().max().item()
        check(got.shape == want.shape and bool(torch.isfinite(got).all()), f"compressor {name}: shape/finite")
        check(err <= 1e-4 * want.abs().max().item(), f"compressor {name}: kernel path differs from plain path")
        worst = max(worst, err / want.abs().max().item())
    check(out.shape == img.shape, f"compressor output shape {tuple(out.shape)}")
    print(f"[{tag}] compressor f32 {tuple(img.shape)}: latent, {len(hs)} skips and decode kernel-vs-plain "
          f"max|d| / max|ref| = {worst:.3g} (bound 1e-4); launches K1, K2a, K2b {grew}")


def phase_latent_net(dev, latent_opt, refusion_setting, stats):
    """One forward of each full-width NAFNet, kernel path against plain
    path: the latent net at batch 4 on 64x64x8 latents (K3 at 8x8), and the
    deraining Refusion net at batch 8, 128 px (K3 at 16x16).  The kernel
    forward of the latent net launches K3 once and K1 16 times.  Then the
    compressor, kernel path against plain path, at batch 4, 512 px and on
    the 704x1024 request."""
    import torch

    from image_restoration_sde_tpu_torch.models import ConditionalNAFNet, UNet, init_params_
    from image_restoration_sde_tpu_torch.ops import LAYERNORM, NAF_STACK

    latent_setting = latent_opt["network_G"]["setting"]

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 6)
    kept = None
    for name, setting, batch, size in (("latent NAFNet", latent_setting, LATENT_BATCH, LATENT_SIZE // 8),
                                       ("deraining NAFNet", refusion_setting, BATCH, SIZE)):
        nets = make_nets(ConditionalNAFNet, setting, dev)
        ch = setting.get("img_channel", 3)
        cond = torch.randn(batch, size, size, ch, generator=gen, device=dev)
        xt = cond + torch.randn(cond.shape, generator=gen, device=dev)
        t = torch.randint(1, 101, (batch,), generator=gen, device=dev)
        if kept is None:
            before = (LAYERNORM.launches, NAF_STACK.launches)
            with recorded_sites() as (ln, _), torch.inference_mode():
                nets[torch.bfloat16, False](xt, cond, t)
            grew = (LAYERNORM.launches - before[0], NAF_STACK.launches - before[1])
            check(grew == (NAF_LN_PER_FORWARD, 1), f"{name}: K1, K3 launches {grew} per forward")
            kept = nets[torch.bfloat16, False]
            ln = [(C, rows) for C, rows, _ in ln]
            k1_path(f"latent {batch}x{LATENT_SIZE}px", ln, k1_site_times(dev, ln), stats)
        compare_nets("latent-net", f"{name} batch {batch} {size}x{size}x{ch}", nets, (xt, cond, t))
        del nets

    comp_setting = latent_opt["network_L"]["setting"]
    compressor = init_params_(UNet(**comp_setting), torch.Generator().manual_seed(SEED + 7)).to(dev).eval()
    plain = UNet(**comp_setting, plain=True)
    plain.load_state_dict(compressor.state_dict())
    plain.to(dev).eval()
    for request in latent_requests():
        compare_compressor("latent-net", compressor, plain, torch.rand(*request, 3, generator=gen, device=dev))
    return kept, compressor


def phase_latent_main_path(dev, net, compressor, latent_opt, smi):
    """The latent sampler serves two batches of 4 at 512 px in the YAML's
    mode, one sde batch of 4 and the odd 700x1000 image (704x1024)."""
    from image_restoration_sde_tpu_torch.sde import IRSDE
    from image_restoration_sde_tpu_torch.training import make_latent_sampler

    sde_opt = latent_opt["sde"]
    sde = IRSDE.create(sde_opt["max_sigma"], sde_opt["T"], sde_opt["schedule"], sde_opt["eps"], device=dev)
    steps, mode = sde_opt["sample_T"], sde_opt["sampling_mode"]
    samplers = {m: make_latent_sampler(sde, net, compressor, mode=m, steps=steps) for m in (mode, "sde")}
    eager = {mode: make_latent_sampler(sde, net, compressor, mode=mode, steps=steps, capture=False)}
    gen = rng_generator(dev, SEED + 8)
    rng = np.random.default_rng(SEED + 8)
    full = (LATENT_BATCH, LATENT_SIZE, LATENT_SIZE, 3)
    requests = [(mode, rng.random(full, np.float32), (gen,)), (mode, rng.random(full, np.float32), (gen,)),
                ("sde", rng.random(full, np.float32), (gen,)),
                (mode, rng.random((1, *LATENT_ODD_HW, 3), np.float32), (gen,))]
    want = counts(LAYERNORM=NAF_LN_PER_FORWARD * steps + COMPRESSOR_LN, LA_CTX=COMPRESSOR_ATTN,
                  LA_APPLY=COMPRESSOR_ATTN, NAF_STACK=steps)
    return serve("latent-main", dev, requests, samplers, want, smi, LATENT_BATCH, pad=64, eager=eager, steps=steps)


def flash_work(shape, itemsize):
    """(bytes, FLOP, exponentials) of attention on (B, N, H, D): q, k, v read
    and the output written once; q k^T and p v; one exp per score."""
    B, N, H, D = shape
    return 4 * B * N * H * D * itemsize, 4 * B * H * N * N * D, B * H * N * N


def softmax_peak(q, k, scale):
    """(B, N, H, 1) float32: each row's largest softmax weight, one batch
    element at a time."""
    import torch

    peaks = []
    for qb, kb in zip(q, k):
        s = torch.einsum("ihd,jhd->hij", qb.float(), kb.float()) * scale
        peaks.append(torch.exp(s.amax(dim=-1) - s.logsumexp(dim=-1)).transpose(0, 1))
        del s
    return torch.stack(peaks)[..., None]


def flash_bf16_agreement(out, tiled, q, k, v, scale):
    """bf16 K4 against flash_mha_tiled_plain, which rounds p where the
    kernel does: (share of elements past two ulps plus 1e-5 of max|ref|,
    largest error over that bound plus one bf16 ulp of the row's largest
    p v term).  A float32 difference in s flips the rounding of a p now and
    then, and one flip moves an element by at most that last term.  Phase
    8 also prints the share of flash_mha_plain, which rounds p at the row
    max: what a kernel that rounds p elsewhere would show."""
    err = (out.float() - tiled.float()).abs()
    tight = bf16_bound(tiled, ulps=2)
    flip = 2.0**-7 * softmax_peak(q, k, scale) * v.float().abs().max()
    return (err > tight).float().mean().item(), (err / (tight + flip)).max().item()


def phase_flash(dev, stats, dit_opt):
    """K4 against its plain version at FLASH_SHAPES and the DiT and tiled
    requests' shapes, and on strided views of a packed qkv product.
    Bounds: float32 1e-5 of max|ref|; bfloat16 twice the plain bf16
    result's distance from the plain float32 result on the same inputs
    (kernel and plain version round p at other maxima), and against
    flash_mha_tiled_plain, which rounds p at the kernel's running maxima,
    flash_bf16_agreement: at most FLASH_FLIP_SHARE of the elements past
    two ulps, none past the flip allowance.  Library call:
    F.scaled_dot_product_attention on the same tensors as (B, H, N, D),
    transposed beforehand, in both dtypes (float32 with TF32 matmuls off,
    as the whole script runs); float32 bounds both on the FMA units and as
    the kernel's 3xTF32 products (flash_f32_bounds)."""
    import torch
    import torch.nn.functional as F

    from image_restoration_sde_tpu_torch.ops import FLASH_ATTN
    from image_restoration_sde_tpu_torch.ops import flash_attention as FA

    shapes = list(FLASH_SHAPES)
    for s in dit_path_shapes(dit_opt)[2] + dit_path_shapes(dit_xl_opt(dit_opt), dit_requests()[:2])[2]:
        if s not in shapes:
            shapes.append(s)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 9)
    for dtype in (torch.bfloat16, torch.float32):
        for shape in shapes:
            D = shape[-1]
            scale = D**-0.5
            q, k, v = ((torch.randn(shape, generator=gen, device=dev) * 1.5).to(dtype) for _ in range(3))
            out = FA.flash_mha_cuda(q, k, v, scale)
            ref = FA.flash_mha_plain(q, k, v, scale)
            err = (out.float() - ref.float()).abs().max().item()
            check(out.shape == shape and bool(torch.isfinite(out).all()), f"K4 {dtype} {shape}: shape/finite")
            share, worst, tiled = 0.0, 0.0, ""
            if dtype == torch.float32:
                limit = 1e-5 * ref.abs().max().item()
            else:
                f32 = FA.flash_mha_plain(q.float(), k.float(), v.float(), scale)
                limit = 2 * (ref.float() - f32).abs().max().item()
                del f32
                tiled_ref = FA.flash_mha_tiled_plain(q, k, v, scale)
                share, worst = flash_bf16_agreement(out, tiled_ref, q, k, v, scale)
                row_max = flash_bf16_agreement(ref, tiled_ref, q, k, v, scale)[0]
                del tiled_ref
                tiled = (f"; vs tiled plain {share:.3g} past two ulps (un-tiled plain {row_max:.3g}), "
                         f"worst {worst:.3g} of the flip allowance")
            stats[FLASH_ATTN]["err"] = max(stats[FLASH_ATTN]["err"], err)
            reps = 10 if shape[1] >= 2048 else 20
            ms = cuda_ms(lambda: FA.flash_mha_cuda(q, k, v, scale), reps=reps)
            pms = cuda_ms(lambda: FA.flash_mha_plain(q, k, v, scale), reps=reps)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale), reps=reps)
            del qt, kt, vt
            nbytes, flops, exps = flash_work(shape, q.element_size())
            bms, by = bound(nbytes, flops, str(dtype)[6:])
            least = f"least {bms:.4f} ms ({by})"
            if dtype == torch.float32:
                least = flash_f32_bound_text(shape)
                tf32_ms = flash_f32_bounds(shape)[1][0]
                stats[FLASH_ATTN].setdefault("float32", []).append(
                    {"shape": list(shape), "ms": ms, "plain_ms": pms, "library_ms": lms, "bound_ms": bms,
                     "bound_by": by, "tf32x3_bound_ms": tf32_ms, "max_abs_err": err})
            print(f"[dit-kernels] K4 {str(dtype)[6:]:8s} {shape}: max|dy|={err:.3g} (bound {limit:.3g}){tiled}; "
                  f"kernel {ms:.4f} ms plain {pms:.4f} ms sdpa {lms:.4f} ms"
                  f"{' (TF32 matmuls off)' if dtype == torch.float32 else ''}; {flops / 1e9:.1f} GFLOP, "
                  f"{nbytes / 1e6:.1f} MB, {exps / 1e6:.0f} M exp, {least}, {flops / ms / 1e9:.1f} TFLOP/s")
            check(err <= limit, f"K4 {dtype} {shape}: max|dy|={err:.3g} (bound {limit:.3g})")
            check(share <= FLASH_FLIP_SHARE and worst <= 1,
                  f"K4 {dtype} {shape} against the tiled plain version: {share:.3g} of the elements past two ulps "
                  f"(bound {FLASH_FLIP_SHARE}), worst {worst:.3g} of the flip allowance")
            if dtype == torch.bfloat16 and shape == FLASH_SHAPES[0]:
                stats[FLASH_ATTN].update(ms=ms, plain_ms=pms, library_ms=lms, bound_ms=bms, bound_by=by)
            if dtype == torch.bfloat16 and D == 72:
                stats[FLASH_ATTN].setdefault("bfloat16_d72", []).append(
                    {"shape": list(shape), "ms": ms, "plain_ms": pms, "library_ms": lms, "bound_ms": bms,
                     "bound_by": by, "max_abs_err": err})
            del q, k, v, out, ref

        # strided views of a packed (B, N, 3, H, D) product, as the DiT gives them
        for B, N, H, D in FLASH_PACKED:
            qkv = (torch.randn(B, N, 3, H, D, generator=gen, device=dev) * 1.5).to(dtype)
            q, k, v = qkv.unbind(2)
            out = FA.flash_mha_cuda(q, k, v, D**-0.5)
            same = torch.equal(out, FA.flash_mha_cuda(q.contiguous(), k.contiguous(), v.contiguous(), D**-0.5))
            err = (out.float() - FA.flash_mha_plain(q, k, v, D**-0.5).float()).abs().max().item()
            check(same, f"K4 {dtype} D={D}: strided q/k/v views differ from contiguous copies")
            print(f"[dit-kernels] K4 {str(dtype)[6:]:8s} strided views of a packed ({B}, {N}, 3, {H}, {D}) qkv: "
                  f"bit-equal to contiguous copies, max|dy| vs plain {err:.3g}")
            del qkv, q, k, v, out


def phase_dit_net(dev, dit_opt, tag="dit-net", with_compressor=True):
    """One forward of the YAML's full-width DiT (DiT-L/2; DiT-XL/2 through
    dit_xl_opt) at batch 2 on 128x128x8 latents, kernel path against plain
    path, float32 and bfloat16 (bounds of compare_nets).  Seeded weights
    with flax's default initialisers on every layer: flax zeroes adaLN and
    the final layer, and a net whose output is exactly 0 would agree with
    anything.  The bf16 kernel forward launches K4 once per block.  Then,
    ``with_compressor``, the path's float32 compressor, kernel path against
    plain path, at each DiT request's shape and the tiled call's
    (compare_compressor); else None in its place."""
    import functools

    import torch

    from image_restoration_sde_tpu_torch.models import build_network, init_params_
    from image_restoration_sde_tpu_torch.ops import FLASH_ATTN

    which, setting = dit_opt["network_G"]["which_model"], dit_opt["network_G"]["setting"]
    nets = make_nets(functools.partial(build_network, which), setting, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 10)
    lat = DIT_SIZE // 8
    cond = torch.randn(DIT_BATCH, lat, lat, setting["in_channels"], generator=gen, device=dev)
    xt = cond + torch.randn(cond.shape, generator=gen, device=dev)
    t = torch.randint(1, 101, (DIT_BATCH,), generator=gen, device=dev)
    before = FLASH_ATTN.launches
    with torch.inference_mode():
        nets[torch.bfloat16, False](xt, cond, t)
    depth = len(nets[torch.bfloat16, False].blocks)
    check(FLASH_ATTN.launches - before == depth, f"{which} forward: {FLASH_ATTN.launches - before} K4 launches")
    compare_nets(tag, f"{which} batch {DIT_BATCH} {lat}x{lat}x{setting['in_channels']}, {depth} K4 launches a bf16 "
                 f"forward", nets, (xt, cond, t))
    net = nets.pop((torch.bfloat16, False))
    del nets
    if not with_compressor:
        return net, None

    comp_opt = dit_opt["network_L"]
    compressor = build_network(comp_opt["which_model"], comp_opt["setting"])
    compressor = init_params_(compressor, torch.Generator().manual_seed(SEED + 11)).to(dev).eval()
    plain = build_network(comp_opt["which_model"], comp_opt["setting"], plain=True)
    plain.load_state_dict(compressor.state_dict())
    plain.to(dev).eval()
    for request in dit_requests():
        compare_compressor("dit-net", compressor, plain, torch.rand(*request, 3, generator=gen, device=dev))
    return net, compressor


def dit_want(steps, depth):
    """Launches per 100-step DiT request: K4 once per block and step, the
    compressor's K1 and K2 once per request, no K3."""
    return counts(LAYERNORM=COMPRESSOR_LN, LA_CTX=COMPRESSOR_ATTN, LA_APPLY=COMPRESSOR_ATTN,
                  FLASH_ATTN=depth * steps)


def phase_dit_main_path(dev, net, compressor, dit_opt, smi, tag="dit-main", served=(0, 1, 2, 3)):
    """The DiT latent sampler (compressor float32; DiT bf16 compute with its
    parameters cast to bf16 once per request) serves two posterior batches
    of 2 at 1024 px, one sde batch of 2 and the odd 1000x700 image (padded
    to 1024x704: 2816 tokens), or those of them that ``served`` names."""
    import torch

    from image_restoration_sde_tpu_torch.sde import IRSDE
    from image_restoration_sde_tpu_torch.training import make_latent_sampler

    sde_opt = dit_opt["sde"]
    sde = IRSDE.create(sde_opt["max_sigma"], sde_opt["T"], sde_opt["schedule"], sde_opt["eps"], device=dev)
    steps = sde_opt["sample_T"]
    samplers = {m: make_latent_sampler(sde, net, compressor, mode=m, steps=steps, cast_params=torch.bfloat16)
                for m in (DIT_MODE, "sde")}
    eager = {DIT_MODE: make_latent_sampler(sde, net, compressor, mode=DIT_MODE, steps=steps,
                                           cast_params=torch.bfloat16, capture=False)}
    gen = rng_generator(dev, SEED + 12)
    rng = np.random.default_rng(SEED + 12)
    full = (DIT_BATCH, DIT_SIZE, DIT_SIZE, 3)
    requests = [(DIT_MODE, rng.random(full, np.float32), (gen,)), (DIT_MODE, rng.random(full, np.float32), (gen,)),
                ("sde", rng.random(full, np.float32), (gen,)),
                (DIT_MODE, rng.random((1, *DIT_ODD_HW, 3), np.float32), (gen,))]
    requests = [requests[i] for i in served]
    launches, record = serve(tag, dev, requests, samplers, dit_want(steps, len(net.blocks)), smi, DIT_BATCH, pad=64,
                             eager=eager, steps=steps)
    return launches, record, (samplers[DIT_MODE], eager[DIT_MODE])


def phase_dit_xl_main_path(dev, net, compressor, xl_opt, smi):
    """phase_dit_main_path's XL_SERVED requests through DiT-XL/2 (28 K4
    launches a step at head dim 72); then, on the 128x128x8 latents of
    batch 2 with the parameters cast to bf16 as the sampler casts them, the
    host's enqueue of one forward (no synchronisation: the card runs behind; the median of
    ENQUEUE_REPS, each on an idle card, as chip_profile.py measures it: a
    tensor-map cache miss would show here) and the wall ms a step (host
    clock around XL_TIMED_STEPS posterior steps ending in a
    synchronisation, after a warm run)."""
    import torch

    from image_restoration_sde_tpu_torch.ops import FLASH_ATTN
    from image_restoration_sde_tpu_torch.sampling import make_noise_fn
    from image_restoration_sde_tpu_torch.sde import IRSDE, samplers

    launches, record, _ = phase_dit_main_path(dev, net, compressor, xl_opt, smi, tag="dit-xl-main", served=XL_SERVED)
    s = xl_opt["sde"]
    sde = IRSDE.create(s["max_sigma"], s["T"], s["schedule"], s["eps"], device=dev)
    fn = make_noise_fn(net, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    lat = DIT_SIZE // 8
    mu = torch.randn(DIT_BATCH, lat, lat, net.in_channels, generator=gen, device=dev)
    xt, tvec = mu + 0.1, torch.full((DIT_BATCH,), 50, device=dev)
    noise = torch.zeros(XL_TIMED_STEPS, *xt.shape, device=dev)
    depth = len(net.blocks)
    with torch.inference_mode():
        def run():
            return samplers.reverse_posterior(sde, fn, xt, mu, None, steps=XL_TIMED_STEPS, noise_seq=noise)

        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / XL_TIMED_STEPS * 1e3
        check(bool(torch.isfinite(out).all()), "DiT-XL steps: output not finite")
        enqueues = []
        for _ in range(ENQUEUE_REPS):
            torch.cuda.synchronize()
            before = FLASH_ATTN.launches
            t0 = time.perf_counter()
            fn(xt, mu, tvec)
            enqueues.append((time.perf_counter() - t0) * 1e3)
            check(FLASH_ATTN.launches - before == depth, f"DiT-XL forward: {FLASH_ATTN.launches - before} K4 launches")
        torch.cuda.synchronize()
    print(f"[dit-xl-main] {DIT_XL} bf16, cast parameters, batch {DIT_BATCH} on {lat}x{lat}x{net.in_channels}: "
          f"wall {wall:.3f} ms a step ({XL_TIMED_STEPS} posterior steps, host clock), host enqueue "
          f"{statistics.median(enqueues):.3f} ms a forward (median of {ENQUEUE_REPS}: "
          f"{', '.join(f'{e:.3f}' for e in enqueues)}), {depth} K4 launches a forward (card: {smi})")
    return launches, record


def phase_tiled(dev, samplers, steps, depth, smi):
    """tiled_restore_device on a 1x1536x1536 uint8 image through the DiT
    posterior sampler: four 1024 px tiles in one call of tile_batch 4, a
    chunk shape whose graph the call captures first (its warm-up's launches
    apart).  Then the same image through the eager sampler (``samplers``:
    captured, eager): the same bytes.  Returns (launches, record)."""
    from image_restoration_sde_tpu_torch.tiling import tiled_restore_device

    sampler, eager = samplers
    img = np.random.default_rng(SEED + 13).integers(0, 256, (1, *TILED_HW, 3)).astype(np.uint8)
    reset_counts()
    graphs = len(sampler.graphs)
    runs = {}
    for form, s in (("captured", sampler), ("eager", eager)):
        t0 = time.perf_counter()
        runs[form] = (tiled_restore_device(s, img, SEED, tile=TILE, overlap=TILE_OVERLAP, tile_batch=TILE_BATCH,
                                           device=dev), time.perf_counter() - t0)
        if form == "captured":
            launches = request_counts()
    out, seconds = runs["captured"]
    (_, entry), = sampler.graphs.entries()[graphs:]
    check(out.shape == img.shape and out.dtype == np.uint8, f"tiled output {out.shape} {out.dtype}")
    check(launches == dit_want(steps, depth), f"tiled launch counts {launches}")
    same = bool(np.array_equal(out, runs["eager"][0]))
    check(same, "tiled: the captured sampler's image is not the eager sampler's")
    print(f"[tiled] 1x{TILED_HW[0]}x{TILED_HW[1]} uint8, tile {TILE}, overlap {TILE_OVERLAP}, tile_batch "
          f"{TILE_BATCH}: {seconds:.3f} s per image with the chunk's capture (warm-up {entry.warm_s:.3f} s, capture "
          f"{entry.capture_s:.3f} s, warm-up launches {warmup_counts()} apart), eager {runs['eager'][1]:.3f} s, the "
          f"same bytes; output {out.dtype} {out.shape} (mean {out.mean():.2f}), launches {launches} (host clock; "
          f"card: {smi})")
    return launches, {"bit_equal": same, "seconds": {"captured_with_capture": seconds, "eager": runs["eager"][1]},
                      "warm_s": entry.warm_s, "capture_s": entry.capture_s}


def lin_attn_work(shape, itemsize):
    """(bytes, FLOP) of the K5 op on (BH, N, d): q, k, v read and the output
    written once; the d x d outer products of the context and the d x d
    product of the apply, 2 N d^2 FLOP each per slice."""
    BH, N, d = shape
    return 4 * BH * N * d * itemsize, 4 * BH * N * d * d


def phase_lin_attn(dev, stats):
    """The public op ``ops.linear_attention.linear_attention`` (K5) at
    LIN_ATTN_SHAPES, float32 and bfloat16: the op path (counts set to 0,
    one call of the op per shape and dtype, counts read: exactly one
    context and one apply launch per call), then each call's output against
    ``linear_attention_plain`` on the same inputs (float32 1e-5 of
    max|ref|, bfloat16 bf16_bound), each pass timed beside its plain half
    and the op's bound; then one gradient through the op on the card
    against the plain composition's (float32, 1e-5 of max|grad|).  No
    single PyTorch call computes the function: library_ms is null."""
    import torch

    from image_restoration_sde_tpu_torch.ops import KERNELS, LIN_ATTN_APPLY, LIN_ATTN_CTX
    from image_restoration_sde_tpu_torch.ops import linear_attention as LA

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 14)
    cases = [(dtype, shape) for dtype in (torch.bfloat16, torch.float32) for shape in LIN_ATTN_SHAPES]
    inputs = {case: [(torch.randn(case[1], generator=gen, device=dev) * 1.5).to(case[0]) for _ in range(3)]
              for case in cases}
    for k in KERNELS:
        k.launches = 0
    outs = {case: LA.linear_attention(*inputs[case]) for case in cases}
    torch.cuda.synchronize()
    launches = {k.symbol: k.launches for k in KERNELS}
    check(launches == counts(LIN_ATTN_CTX=len(cases), LIN_ATTN_APPLY=len(cases)),
          f"linear_attention path launch counts {launches}")
    print(f"[lin-attn] op path: {len(cases)} calls, launches {launches}")
    for case in cases:
        dtype, shape = case
        q, k, v = inputs[case]
        out, ref = outs[case], LA.linear_attention_plain(q, k, v)
        err = (out.float() - ref.float()).abs()
        check(out.shape == shape and out.dtype == dtype and bool(torch.isfinite(out).all()),
              f"K5 {dtype} {shape}: shape/dtype/finite")
        if dtype == torch.float32:
            ok = err.max().item() <= 1e-5 * ref.abs().max().item()
        else:
            ok = bool((err <= bf16_bound(ref)).all())
        check(ok, f"K5 {dtype} {shape}: max|dy|={err.max().item():.3g}")
        ctx = LA.linear_attention_context_cuda(k, v)
        ctx_ref = LA.linear_attention_context_plain(k, v)
        cerr = (ctx - ctx_ref).abs().max().item()
        check(cerr <= 1e-5 * ctx_ref.abs().max().item(), f"K5 {dtype} {shape}: max|dctx|={cerr:.3g}")
        stats[LIN_ATTN_CTX]["err"] = max(stats[LIN_ATTN_CTX]["err"], cerr)
        stats[LIN_ATTN_APPLY]["err"] = max(stats[LIN_ATTN_APPLY]["err"], err.max().item())
        ms_c = graph_ms(lambda: LA.linear_attention_context_cuda(k, v))
        pms_c = graph_ms(lambda: LA.linear_attention_context_plain(k, v))
        ms_a = graph_ms(lambda: LA.linear_attention_apply_heads_cuda(q, ctx))
        pms_a = graph_ms(lambda: LA.linear_attention_apply_heads_plain(q, ctx))
        ems_c = cuda_ms(lambda: LA.linear_attention_context_cuda(k, v))
        ems_a = cuda_ms(lambda: LA.linear_attention_apply_heads_cuda(q, ctx))
        nbytes, flops = lin_attn_work(shape, q.element_size())
        bms, by = bound(nbytes, flops, str(dtype)[6:])
        half = bound(nbytes / 2, flops / 2, str(dtype)[6:])
        print(f"[lin-attn] K5 {str(dtype)[6:]:8s} {shape}: max|dctx|={cerr:.3g} max|dy|={err.max().item():.3g}; "
              f"context {ms_c:.4f} ms plain {pms_c:.4f} ms | apply {ms_a:.4f} ms plain {pms_a:.4f} ms | op "
              f"{ms_c + ms_a:.4f} ms, least {bms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), "
              f"{nbytes / (ms_c + ms_a) / 1e9:.3f} TB/s (graph of 20; by events around one launch: context "
              f"{ems_c:.4f} ms, apply {ems_a:.4f} ms)")
        if case == cases[0]:
            stats[LIN_ATTN_CTX].update(ms=ms_c, event_ms=ems_c, plain_ms=pms_c, bound_ms=half[0], bound_by=half[1])
            stats[LIN_ATTN_APPLY].update(ms=ms_a, event_ms=ems_a, plain_ms=pms_a, bound_ms=half[0],
                                         bound_by=half[1])
        del q, k, v, out, ref, ctx, ctx_ref
    del inputs, outs

    ins = [torch.randn(LIN_ATTN_GRAD_SHAPE, generator=gen, device=dev, requires_grad=True) for _ in range(3)]
    g = torch.randn(LIN_ATTN_GRAD_SHAPE, generator=gen, device=dev)
    got = torch.autograd.grad(LA.linear_attention(*ins), ins, g)
    want = torch.autograd.grad(LA.linear_attention_plain(*ins), ins, g)
    errs = [((a - b).abs().max() / b.abs().max()).item() for a, b in zip(got, want)]
    check(max(errs) <= 1e-5, f"K5 gradient: max|dgrad| / max|grad| = {errs}")
    print(f"[lin-attn] gradient through the op at {LIN_ATTN_GRAD_SHAPE} f32: max|dgrad| / max|grad| "
          f"(q, k, v) = {', '.join(f'{e:.3g}' for e in errs)} (bound 1e-5)")
    return launches


@contextlib.contextmanager
def recorded_sites():
    """Record the (C, rows, dtype) of every K1 launch and the (B, N, dtype)
    of every K2 launch made inside the block, into the yielded lists."""
    from image_restoration_sde_tpu_torch.ops import layernorm as LN
    from image_restoration_sde_tpu_torch.ops import linear_attention as LA

    ln, attn = [], []
    ln_cuda, ctx_cuda = LN.channel_layernorm_cuda, LA.linear_attention_ctx_cuda

    def ln_rec(x, g, eps):
        ln.append((x.shape[-1], x.numel() // x.shape[-1], x.dtype))
        return ln_cuda(x, g, eps)

    def ctx_rec(qkv, *a):
        attn.append((qkv.shape[0], qkv.shape[1], qkv.dtype))
        return ctx_cuda(qkv, *a)

    LN.channel_layernorm_cuda, LA.linear_attention_ctx_cuda = ln_rec, ctx_rec
    try:
        yield ln, attn
    finally:
        LN.channel_layernorm_cuda, LA.linear_attention_ctx_cuda = ln_cuda, ctx_cuda


def ctx_float64(qkv, heads=4, dim_head=32):
    """K2a's function, linear_attention_ctx_plain's math in float64."""
    import torch

    B, N, _ = qkv.shape
    x = qkv.double().reshape(B, N, 3, heads, dim_head)
    return torch.einsum("bnhd,bnhe->bhed", torch.softmax(x[:, :, 1], dim=1), x[:, :, 2] / N)


def hold_sites(tag, dev, ln_sites, attn_sites, stats, forwards):
    """K1 and K2b against their plain versions at each recorded site shape,
    on seeded inputs, with phase 3's bounds; K2a's ctx within 1e-5 of
    max|ctx| of the float64 composition (at N >= 65536 the plain float32
    version's own sums over N drift past that bound; the kernel's do not).
    Then K1 timed over each of ``forwards`` ({label: the (C, rows, dtype)
    of one bf16 forward's K1 launches}, k1_path)."""
    import torch

    from image_restoration_sde_tpu_torch.ops import layernorm as LN
    from image_restoration_sde_tpu_torch.ops import linear_attention as LA

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 15)

    def agree(out, ref):
        err = (out.float() - ref.float()).abs()
        if out.dtype == torch.float32:
            return err.max().item() <= 1e-5 * ref.abs().max().item(), err.max().item()
        return bool((err <= bf16_bound(ref)).all()), err.max().item()

    worst = [0.0, 0.0]
    for C, rows, dtype in sorted(set(ln_sites), key=str):
        eps = 1e-5 if dtype == torch.float32 else 1e-3
        x = (torch.randn(rows, C, generator=gen, device=dev) * 2 + 0.5).to(dtype)
        g = torch.randn(C, generator=gen, device=dev) * 0.2 + 1
        ok, err = agree(LN.channel_layernorm_cuda(x, g, eps), LN.channel_layernorm_plain(x, g, eps))
        check(ok, f"{tag}: K1 {dtype} C={C} rows={rows}: max|dy|={err:.3g}")
        worst[0] = max(worst[0], err)
    ctx_rel = [0.0, 0.0]  # kernel and plain float32 ctx against float64, / max|ctx|
    for batch, N, dtype in sorted(set(attn_sites), key=str):
        qkv = (torch.randn(batch, N, 384, generator=gen, device=dev) * 1.5).to(dtype)
        ctx, ctx_ref = LA.linear_attention_ctx_cuda(qkv), LA.linear_attention_ctx_plain(qkv)
        ref64 = ctx_float64(qkv)
        scale = ref64.abs().max().item()
        rel = [(c.double() - ref64).abs().max().item() / scale for c in (ctx, ctx_ref)]
        ctx_rel = [max(a, b) for a, b in zip(ctx_rel, rel)]
        check(rel[0] <= 1e-5, f"{tag}: K2a {dtype} B={batch} N={N}: max|dctx| = {rel[0]:.3g} of max|ctx|")
        ok, err = agree(LA.linear_attention_apply_cuda(qkv, ctx_ref), LA.linear_attention_apply_plain(qkv, ctx_ref))
        check(ok, f"{tag}: K2b {dtype} B={batch} N={N}: max|dout|={err:.3g}")
        worst[1] = max(worst[1], err)
        del qkv, ref64
    print(f"[{tag}] K1 at the path's {len(set(ln_sites))} (C, rows, dtype) sites and K2 at its "
          f"{len(set(attn_sites))} (B, N, dtype) sites against their plain versions: max|dy| {worst[0]:.3g}, "
          f"max|dout| {worst[1]:.3g} (phase 3's bounds); K2a's ctx against the float64 composition "
          f"{ctx_rel[0]:.3g} of max|ctx| (bound 1e-5), the plain float32 version's {ctx_rel[1]:.3g}")
    forwards = {label: [(C, rows) for C, rows, _ in sites] for label, sites in forwards.items()}
    times = k1_site_times(dev, [site for sites in forwards.values() for site in sites])
    for label, sites in forwards.items():
        k1_path(label, sites, times, stats)


def serve(tag, dev, requests, samplers, want, smi, rate_batch, pad=None, eager=None, steps=None, compare=(0,)):
    """Each request (mode, NHWC float32 array, extra arguments) through
    ``samplers[mode](x, *extra)``, with exact launch counts per request (``want``);
    counts set to 0 before the first and read after the last.  ``pad``
    pads each request to a bucket multiple first (pad_to_bucket) and crops
    the output back.  The samplers capture their chains on the card: each
    request's graph is captured first (``sample.prepare``: its warm-up's
    launches, the capture seconds and the graph pool's MiB reported apart),
    so every request replays.  Then (``eager``: the same samplers with
    ``capture=False``) the requests ``compare`` names again, captured and
    eager, each from a generator of the same seed: the outputs bit-equal,
    the generators' states equal after, and the wall ms a step (``steps`` a
    request) of each form; returns (launches, that record)."""
    import torch

    from image_restoration_sde_tpu_torch.sampling import pad_to_bucket, unpad

    def prepared(img):
        padded, hw = pad_to_bucket(img, pad) if pad else (img, img.shape[1:3])
        return torch.from_numpy(padded).to(dev), hw

    reset_counts()
    t0 = time.perf_counter()
    for mode, img, args in requests:
        samplers[mode].prepare(prepared(img)[0], *args)
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    distinct = {id(s): s for s in samplers.values()}.values()
    entries = [e for sampler in distinct for _, e in sampler.graphs.entries()]
    pool_mib = sum(sampler.graphs.pool_bytes() for sampler in distinct) / 2**20
    capture = {"graphs": len(entries), "prepare_s": prepare_s, "warm_s": sum(e.warm_s for e in entries),
               "capture_s": sum(e.capture_s for e in entries), "pool_mib": pool_mib,
               "inputs_mib": sum(e.input_bytes() for e in entries) / 2**20, "warmup_launches": warmup_counts()}
    check(not any(request_counts().values()), f"{tag}: the captures counted launches {request_counts()}")
    print(f"[{tag}] captured {capture['graphs']} chain graph(s) in {prepare_s:.3f} s (warm-up {capture['warm_s']:.3f} "
          f"s, capture {capture['capture_s']:.3f} s; warm-up launches {capture['warmup_launches']}, apart); graph "
          f"pool {pool_mib:.1f} MiB, static inputs {capture['inputs_mib']:.1f} MiB (card: {smi})")
    reset_counts()
    rates = {}
    for i, (mode, img, args) in enumerate(requests):
        before = request_counts()
        x, hw = prepared(img)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = unpad(samplers[mode](x, *args), hw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check(out.shape == img.shape and out.dtype == torch.float32, f"{tag} {mode} output shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), f"{tag} {mode} output not finite")
        grew = {sym: n - before[sym] for sym, n in request_counts().items()}
        check(grew == want, f"{tag} launch counts {grew}, expected {want}")
        if img.shape[0] == rate_batch:
            rates.setdefault(mode, []).append(rate_batch / seconds)
        print(f"[{tag}] {mode:9s} {'x'.join(map(str, img.shape))} (run as {tuple(x.shape[1:3])}): "
              f"{seconds:.3f} s, {img.shape[0] / seconds:.4f} img/s, launches {grew}")
    for mode, r in rates.items():
        print(f"[{tag}] img/s at batch {rate_batch}, {mode}: {r[-1]:.4f} (last), {r[0]:.4f} (first) "
              f"(host clock; card: {smi})")
    launched = request_counts()
    held = [captured_against_eager(tag, dev, requests[i], samplers, eager, steps, prepared, smi) for i in compare]
    return launched, {**capture, "against_eager": held}


def captured_against_eager(tag, dev, request, samplers, eager, steps, prepared, smi):
    """``request`` through the captured sampler and the eager one, each from
    a generator seeded alike: the outputs bit-equal and the generators'
    states equal after; the wall ms a step of each (host clock to a
    synchronisation)."""
    import torch

    mode, img, args = request
    x, _ = prepared(img)
    runs = {}
    for form, sampler in (("captured", samplers[mode]), ("eager", eager[mode])):
        gen = rng_generator(dev, SEED + 400)  # the denoising sampler (no arguments) draws nothing
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sampler(x, *((gen, *args[1:]) if args else ()))
        torch.cuda.synchronize()
        runs[form] = (out, gen.get_state(), (time.perf_counter() - t0) / steps * 1e3)
    (yc, sc, wc), (ye, se, we) = runs["captured"], runs["eager"]
    same, states = bool(torch.equal(yc, ye)), bool(torch.equal(sc, se))
    check(same, f"{tag}: the captured chain is not the eager chain bit for bit: max|d| "
                f"{(yc - ye).abs().max().item():.3g}")
    check(states, f"{tag}: the generators' states differ after the captured and the eager chain")
    print(f"[{tag}] captured against eager, {mode} {'x'.join(map(str, img.shape))}: bit-equal, generator states "
          f"equal; wall {wc:.3f} ms a step captured, {we:.3f} eager ({steps} steps, host clock; card: {smi})")
    return {"request": f"{mode} {'x'.join(map(str, img.shape))}", "bit_equal": same, "states_equal": states,
            "wall_ms_step": {"captured": wc, "eager": we}, "steps": steps}


def phase_denoise_net(dev, opt, stats):
    """The denoising UNet (configs/denoising/test/ir-sde.yml's setting with
    conditional=False: full attention in the mid block) at full width:
    one forward at batch 8, 128 px, kernel path against plain path in
    float32 and bfloat16 (compare_nets); the bf16 kernel forward launches
    K1 17 times and K2a, K2b 8 times each; K1 and K2 at the sites of that
    forward and of the 512 px request, against their plain versions."""
    import torch

    from image_restoration_sde_tpu_torch.models import ConditionalUNet

    setting = {**opt["network_G"]["setting"], "conditional": False}
    nets = make_nets(ConditionalUNet, setting, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 16)
    x = torch.rand(BATCH, SIZE, SIZE, 3, generator=gen, device=dev)
    t = torch.randint(1, 415, (BATCH,), generator=gen, device=dev)
    net = nets[torch.bfloat16, False]
    with recorded_sites() as (ln, attn), torch.inference_mode():
        net(x, None, t)
        big = torch.rand(1, *pad64(DENOISE_ODD_HW), 3, generator=gen, device=dev)
        net(big, None, t[:1])
    check((len(ln), len(attn)) == (2 * DENOISE_LN_PER_FORWARD, 2 * DENOISE_ATTN_PER_FORWARD),
          f"denoising forward: {len(ln) // 2} K1, {len(attn) // 2} K2 launches")
    compare_nets("denoise-net", f"unconditional nf={setting['nf']} depth={setting['depth']} batch {BATCH} "
                 f"{SIZE}px", nets, (x, None, t))
    n = DENOISE_LN_PER_FORWARD
    hold_sites("denoise-net", dev, ln, attn, stats, {f"denoising {BATCH}x{SIZE}px": ln[:n],
                                                     f"denoising 1x{pad64(DENOISE_ODD_HW)[0]}px": ln[n:]})
    del nets
    return net


def phase_denoise_main_path(dev, net, opt, smi):
    """make_denoising_sampler (DenoisingSDE max_sigma 70, T 1000, cosine;
    sigma 50 -> t0 reverse ODE steps; bf16 net, f32 parameters) serves a
    batch of 8 noisy 128 px images; exactly 17 t0 K1 and 8 t0 K2a, K2b
    launches."""
    import torch

    from image_restoration_sde_tpu_torch.sampling import make_denoising_sampler
    from image_restoration_sde_tpu_torch.sde import DenoisingSDE

    sde_opt, sigma = opt["sde"], float(opt["degradation"]["sigma"])
    sde = DenoisingSDE.create(sde_opt["max_sigma"], sde_opt["T"], sde_opt["schedule"], device=dev)
    sample = make_denoising_sampler(sde, net, sigma)
    eager = {"ode": make_denoising_sampler(sde, net, sigma, capture=False)}
    check(sample.t0 == DENOISE_T0, f"optimal timestep {sample.t0} for sigma {sigma}, expected {DENOISE_T0}")
    rng = np.random.default_rng(SEED + 17)

    def noisy(shape):
        clean = rng.random(shape, np.float32)
        return (clean + sigma / 255 * rng.standard_normal(shape, np.float32)).astype(np.float32)

    # one request: a 500x500 image's 414 steps would cost a capture of ~9 s
    # and a 4.8 s replay; inference and eval restore 500x500 images through
    # the same sampler
    requests = [("ode", noisy((BATCH, SIZE, SIZE, 3)), ())]
    want = counts(LAYERNORM=DENOISE_LN_PER_FORWARD * sample.t0, LA_CTX=DENOISE_ATTN_PER_FORWARD * sample.t0,
                  LA_APPLY=DENOISE_ATTN_PER_FORWARD * sample.t0)
    print(f"[denoise-main] sigma {sigma:g} -> t0 = {sample.t0} reverse ODE steps per request")
    return serve("denoise-main", dev, requests, {"ode": sample}, want, smi, BATCH, pad=64, eager=eager,
                 steps=sample.t0)


def phase_stereo_net(dev, opt, stats):
    """The stereo NAFNet (configs/stereo-sr/test/refusion.yml: width 64, enc
    [1, 1, 1, 28], mid 1, dec [1, 1, 1, 1], a SCAM after every block) at
    full width and depth: one forward at batch 4 pairs, 128 px, kernel path
    against plain path (compare_nets); the bf16 kernel forward launches K1
    144 times (36 blocks: norm1, norm2 and SCAM's two) and K3 never; K1 at
    the sites of that forward and of the 140x200 request."""
    import torch

    from image_restoration_sde_tpu_torch.models import StereoConditionalNAFNet
    from image_restoration_sde_tpu_torch.ops import NAF_STACK

    setting = opt["network_G"]["setting"]
    nets = make_nets(StereoConditionalNAFNet, setting, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 18)
    lq = torch.rand(STEREO_BATCH, SIZE, SIZE, 6, generator=gen, device=dev)
    xt = lq + torch.randn(lq.shape, generator=gen, device=dev) * 0.2
    t = torch.randint(1, 101, (STEREO_BATCH,), generator=gen, device=dev)
    net = nets[torch.bfloat16, False]
    k3 = NAF_STACK.launches
    with recorded_sites() as (ln, attn), torch.inference_mode():
        net(xt, lq, t)
        odd = torch.rand(1, *STEREO_ODD_HW, 6, generator=gen, device=dev)
        net(odd, odd, t[:1])
    check((len(ln), len(attn), NAF_STACK.launches - k3) == (2 * STEREO_LN_PER_FORWARD, 0, 0),
          f"stereo forward: {len(ln) // 2} K1, {len(attn)} K2, {NAF_STACK.launches - k3} K3 launches")
    compare_nets("stereo-net", f"stereo NAFNet batch {STEREO_BATCH} pairs {SIZE}px", nets, (xt, lq, t))
    hold_sites("stereo-net", dev, ln, attn, stats,
               {f"stereo {STEREO_BATCH}x{SIZE}px pairs": ln[:STEREO_LN_PER_FORWARD]})
    del nets
    return net


def phase_stereo_main_path(dev, net, opt, smi):
    """The IR-SDE restoration sampler with the stereo net (max_sigma 50,
    T 100, cosine, eps 0.005; posterior, 100 steps; bf16 net): a batch of 4
    pairs at 128 px; exactly 144 x 100 K1.  (The second batch of 4 pairs
    was cut to the script's time limit, and so was the 140x200 pair, whose
    capture takes ~11 s: phase 15 runs the net on it, phase 22 the test
    entry point's sampler on its own odd pair.)"""
    from image_restoration_sde_tpu_torch.sampling import make_restoration_sampler
    from image_restoration_sde_tpu_torch.sde import IRSDE

    sde_opt = opt["sde"]
    sde = IRSDE.create(sde_opt["max_sigma"], sde_opt["T"], sde_opt["schedule"], sde_opt["eps"], device=dev)
    mode = sde_opt["sampling_mode"]
    sampler = {mode: make_restoration_sampler(sde, net, mode=mode)}
    eager = {mode: make_restoration_sampler(sde, net, mode=mode, capture=False)}
    gen = rng_generator(dev, SEED + 19)
    rng = np.random.default_rng(SEED + 19)
    full = (STEREO_BATCH, SIZE, SIZE, 6)
    requests = [(mode, rng.random(full, np.float32), (gen,))]
    return serve("stereo-main", dev, requests, sampler, counts(LAYERNORM=STEREO_LN_PER_FORWARD * sde.T), smi,
                 STEREO_BATCH, eager=eager, steps=sde.T)


def rng_generator(dev, seed):
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def phase_bokeh_net(dev, opt, stats):
    """The bokeh path's nets (configs/latent-bokeh/test/refusion.yml): the
    compressor UNet (ch 64, ch_mult [1, 2, 4], embed_dim 4: latents at H/4),
    kernel path against plain path at each request's shape
    (compare_compressor); the bokeh NAFNet (img_channel 4, width 64, enc
    [2, 2, 4, 8], mid 12, dec [2, 2, 2, 2], lens conditioning) at batch 4 on
    128x128x4 latents, kernel path against plain path (compare_nets); its
    bf16 kernel forward launches K1 72 times and K3 never; K1 and K2 at the
    sites of both nets at both request shapes."""
    import functools

    import torch

    from image_restoration_sde_tpu_torch.models import build_network, init_params_
    from image_restoration_sde_tpu_torch.ops import NAF_STACK

    comp_opt = opt["network_L"]
    compressor = build_network(comp_opt["which_model"], comp_opt["setting"])
    compressor = init_params_(compressor, torch.Generator().manual_seed(SEED + 20)).to(dev).eval()
    plain = build_network(comp_opt["which_model"], comp_opt["setting"], plain=True)
    plain.load_state_dict(compressor.state_dict())
    plain.to(dev).eval()
    gen = rng_generator(dev, SEED + 21)
    sites = ([], [])
    for batch, h, w in bokeh_requests():
        img = torch.rand(batch, h, w, 3, generator=gen, device=dev)
        with recorded_sites() as (ln, attn):
            compare_compressor("bokeh-net", compressor, plain, img)
        sites[0].extend(ln)
        sites[1].extend(attn)
    del plain

    setting = opt["network_G"]["setting"]
    nets = make_nets(functools.partial(build_network, "BokehConditionalNAFNet"), setting, dev)
    ch, down = setting["img_channel"], 2 ** (len(comp_opt["setting"]["ch_mult"]) - 1)
    lat = BOKEH_SIZE // down
    cond = torch.randn(BOKEH_BATCH, lat, lat, ch, generator=gen, device=dev)
    xt = cond + torch.randn(cond.shape, generator=gen, device=dev)
    t = torch.randint(1, 101, (BOKEH_BATCH,), generator=gen, device=dev)
    lens = bokeh_lens(np.random.default_rng(SEED + 21), BOKEH_BATCH, dev)
    net = nets[torch.bfloat16, False]
    k3 = NAF_STACK.launches
    with recorded_sites() as (ln, attn), torch.inference_mode():
        net(xt, cond, t, lens)
        _, oh, ow = bokeh_requests()[1]
        odd = torch.rand(1, oh // down, ow // down, ch, generator=gen, device=dev)
        net(odd, odd, t[:1], tuple(v[:1] for v in lens))
    check((len(ln), len(attn), NAF_STACK.launches - k3) == (2 * BOKEH_LN_PER_FORWARD, 0, 0),
          f"bokeh forward: {len(ln) // 2} K1, {len(attn)} K2, {NAF_STACK.launches - k3} K3 launches")
    compare_nets("bokeh-net", f"bokeh NAFNet batch {BOKEH_BATCH} {lat}x{lat}x{ch}", nets, (xt, cond, t, lens))
    hold_sites("bokeh-net", dev, sites[0] + ln, sites[1] + attn, stats,
               {f"bokeh {BOKEH_BATCH}x{BOKEH_SIZE}px": ln[:BOKEH_LN_PER_FORWARD]})
    del nets
    return net, compressor


def bokeh_requests():
    """(batch, H, W) of the bokeh path's requests after padding."""
    return [(BOKEH_BATCH, BOKEH_SIZE, BOKEH_SIZE), (1, *pad64(BOKEH_ODD_HW))]


def bokeh_lens(rng, batch, dev):
    """Seeded lens values (src, tgt, disparity), each (batch,): lens
    apertures in [1, 20) and a disparity in [0, 1)."""
    import torch

    vals = [rng.uniform(1, 20, batch), rng.uniform(1, 20, batch), rng.random(batch)]
    return tuple(torch.tensor(v, dtype=torch.float32, device=dev) for v in vals)


def phase_bokeh_main_path(dev, net, compressor, opt, smi):
    """The latent sampler with the bokeh net (max_sigma 50, T 100, cosine,
    eps 0.005; posterior, 100 steps; bf16 score net, f32 compressor; lens
    values from the seed as the per-sample cond): a batch of 4 at 512 px;
    exactly 72 x 100 + 4 K1 and 2 K2a, K2b launches.  (The second batch of
    4 was cut to the script's time limit, and so was the 700x1000 image,
    whose capture takes ~6 s: phase 17 runs the nets at its shape, phase 22
    the test entry point's sampler on its own.)"""
    from image_restoration_sde_tpu_torch.sde import IRSDE
    from image_restoration_sde_tpu_torch.training import make_latent_sampler

    sde_opt = opt["sde"]
    sde = IRSDE.create(sde_opt["max_sigma"], sde_opt["T"], sde_opt["schedule"], sde_opt["eps"], device=dev)
    mode = sde_opt["sampling_mode"]
    sampler = {mode: make_latent_sampler(sde, net, compressor, mode=mode)}
    eager = {mode: make_latent_sampler(sde, net, compressor, mode=mode, capture=False)}
    gen = rng_generator(dev, SEED + 22)
    rng = np.random.default_rng(SEED + 22)
    full = (BOKEH_BATCH, BOKEH_SIZE, BOKEH_SIZE, 3)
    requests = [(mode, rng.random(full, np.float32), (gen, bokeh_lens(rng, BOKEH_BATCH, dev)))]
    want = counts(LAYERNORM=BOKEH_LN_PER_FORWARD * sde.T + COMPRESSOR_LN, LA_CTX=COMPRESSOR_ATTN,
                  LA_APPLY=COMPRESSOR_ATTN)
    return serve("bokeh-main", dev, requests, sampler, want, smi, BOKEH_BATCH, pad=64, eager=eager, steps=sde.T)


# ---------------------------------------------------------------- training
def train_counts(label):
    """Launches per train step of the train path ``label``: its forward's,
    none in the backward.  The compressor's deepest level launches 2 K1 and
    one K2a and K2b per encode and per decode (COMPRESSOR_LN and
    COMPRESSOR_ATTN count one of each): the compressor step encodes LQ and
    GT and decodes twice; a latent step encodes its 2B batch once, frozen,
    then runs the score net: the NAFNet's 8 unfused blocks (2 K1 each) and
    its fused 28-block level (K3), DiT-L/2's DIT_DEPTH attention sites (K4),
    the bokeh NAFNet's 36 blocks; the stereo NAFNet's 36 blocks and SCAMs."""
    enc_ln, enc_attn = COMPRESSOR_LN // 2, COMPRESSOR_ATTN // 2
    return {
        "ir-sde": counts(LAYERNORM=LN_PER_FORWARD, LA_CTX=ATTN_PER_FORWARD, LA_APPLY=ATTN_PER_FORWARD),
        "refusion": counts(LAYERNORM=NAF_LN_PER_FORWARD, NAF_STACK=1),
        "compressor": counts(LAYERNORM=2 * COMPRESSOR_LN, LA_CTX=2 * COMPRESSOR_ATTN, LA_APPLY=2 * COMPRESSOR_ATTN),
        "latent": counts(LAYERNORM=enc_ln + NAF_LN_PER_FORWARD, LA_CTX=enc_attn, LA_APPLY=enc_attn, NAF_STACK=1),
        "dit": counts(LAYERNORM=enc_ln, LA_CTX=enc_attn, LA_APPLY=enc_attn, FLASH_ATTN=DIT_DEPTH),
        "bokeh": counts(LAYERNORM=enc_ln + BOKEH_LN_PER_FORWARD, LA_CTX=enc_attn, LA_APPLY=enc_attn),
        "stereo": counts(LAYERNORM=STEREO_LN_PER_FORWARD),
    }[label]


def val_counts(label, steps):
    """Launches per validation image of the train path ``label`` whose
    sampler runs ``steps`` reverse steps: the pixel paths' score net once a
    step; the compressor's validation encodes LQ and GT and decodes once; a
    latent path's sampler encodes and decodes once and runs its score net
    once a step."""
    step = train_counts(label)
    if label in ("ir-sde", "refusion", "stereo"):
        return {k: steps * n for k, n in step.items()}
    enc = counts(LAYERNORM=COMPRESSOR_LN // 2, LA_CTX=COMPRESSOR_ATTN // 2, LA_APPLY=COMPRESSOR_ATTN // 2)
    if label == "compressor":
        return {k: 3 * n for k, n in enc.items()}
    return {k: steps * (n - enc[k]) + 2 * enc[k] for k, n in step.items()}


class Injected:
    """An SDE whose ``generate_random_states`` returns the given
    ``(timesteps, x_t)``; every other attribute is the wrapped SDE's."""

    def __init__(self, sde, timesteps, xt):
        self._sde, self._states = sde, (timesteps, xt)

    def __getattr__(self, name):
        return getattr(self._sde, name)

    def generate_random_states(self, *args):
        return self._states


def phase_train_kernels(dev):
    """K1's and K3's gradients on the card, float32, against the plain
    compositions' on the same inputs: K1 (x and g) at each (C, rows) site of
    the deraining UNet's train step (batch 4, 128 px), K3 (x, temb and every
    block tensor) at the Refusion pixel net's fused level (4, 16, 16, 512),
    28 blocks.  Each forward launches its kernel once and has a grad_fn; the
    backward (the plain composition's autograd on the saved inputs)
    launches none.  Bound: each gradient within 1e-5 of its max.  Times:
    forward and backward together, kernel path against plain path."""
    import torch

    from image_restoration_sde_tpu_torch.ops import layernorm as LN
    from image_restoration_sde_tpu_torch.ops import naf_stack as NS

    gen = rng_generator(dev, SEED + 30)

    def held(tag, launched, fn, inputs, cot, plain_fn):
        before = launched.launches
        y = fn(*inputs)
        check(launched.launches == before + 1 and y.grad_fn is not None, f"{tag}: one launch with a grad_fn")
        got = torch.autograd.grad(y, inputs, cot)
        check(launched.launches == before + 1, f"{tag}: the backward launched the kernel")
        want = torch.autograd.grad(plain_fn(*inputs), inputs, cot)
        rel = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item() for a, b in zip(got, want))
        check(rel <= 1e-5, f"{tag}: max|dgrad| / max|grad| = {rel:.3g} (bound 1e-5)")
        ms = cuda_ms(lambda: torch.autograd.grad(fn(*inputs), inputs, cot), reps=5)
        pms = cuda_ms(lambda: torch.autograd.grad(plain_fn(*inputs), inputs, cot), reps=5)
        return rel, ms, pms

    ln_sites, _ = path_shapes(TRAIN_BATCH)
    total = [0.0, 0.0]
    for C, rows in sorted(set(ln_sites)):
        x = (torch.randn(rows, C, generator=gen, device=dev) * 2 + 0.5).requires_grad_()
        g = (torch.randn(C, generator=gen, device=dev) * 0.2 + 1).requires_grad_()
        cot = torch.randn(rows, C, generator=gen, device=dev)
        rel, ms, pms = held(f"K1 gradient C={C} rows={rows}", LN.LAYERNORM,
                            lambda a, b: LN.channel_layernorm(a, b, 1e-5), (x, g), cot,
                            lambda a, b: LN.channel_layernorm_plain(a, b, 1e-5))
        n = ln_sites.count((C, rows))
        total = [total[0] + n * ms, total[1] + n * pms]
        print(f"[train-kernels] K1 f32 C={C:5d} rows={rows:6d} x{n}: max|dgrad|/max|grad| {rel:.3g} (bound 1e-5); "
              f"forward+backward kernel {ms:.4f} ms, plain {pms:.4f} ms (events)")
    print(f"[train-kernels] K1 over the UNet train step's {len(ln_sites)} sites, forward+backward: kernel "
          f"{total[0]:.4f} ms, plain {total[1]:.4f} ms")

    K, C = TRAIN_NAF_LEVEL
    blocks = [{k: v.requires_grad_() for k, v in blk.items()} for blk in naf_blocks(K, C, 4 * C // 8, dev, SEED + 31)]
    x = torch.randn(TRAIN_BATCH, TRAIN_SIZE // 8, TRAIN_SIZE // 8, C, generator=gen, device=dev).requires_grad_()
    temb = torch.randn(TRAIN_BATCH, 4 * C // 8, generator=gen, device=dev).requires_grad_()
    cot = torch.randn(x.shape, generator=gen, device=dev)
    inputs = (x, temb, *(v for blk in blocks for v in blk.values()))
    n = len(blocks[0])

    def unflat(ts):
        return [dict(zip(blocks[0], ts[i : i + n])) for i in range(0, len(ts), n)]

    rel, ms, pms = held(f"K3 gradient {tuple(x.shape)} K={K}", NS.NAF_STACK,
                        lambda a, t, *ts: NS.naf_stack(a, unflat(ts), t, 1e-5), inputs, cot,
                        lambda a, t, *ts: NS.naf_stack_plain(a, NS.stack_middle_params(unflat(ts), t), 1e-5))
    print(f"[train-kernels] K3 f32 {tuple(x.shape)} K={K}: gradients of x, temb and {len(inputs) - 2} block "
          f"tensors max|dgrad|/max|grad| {rel:.3g} (bound 1e-5); forward+backward kernel {ms:.4f} ms, plain "
          f"{pms:.4f} ms (events)")


def flash_bwd_work(shape, itemsize):
    """(bytes, FLOP) of K4's backward on (B, N, H, D): q, k, v and the
    output cotangent read and dq, dk, dv written once; five products of
    2 B H N^2 D FLOP each (the recomputed scores, dv, the gradient of p, dq,
    dk)."""
    B, N, H, D = shape
    return 7 * B * N * H * D * itemsize, 10 * B * H * N * N * D


def phase_flash_backward(dev, stats):
    """K4 under autograd on the card, float32 and bfloat16.  At
    FLASH_GRAD_SHAPE: one launch with a grad_fn, none in the backward
    (``flash_mha_backward``, streamed over BWD_BLOCK query rows), and the
    gradients of q, k and v against autograd through the un-tiled
    ``ref_mha_plain`` (its B H N^2 float32 scores fit at batch 2); bounds,
    each gradient, of its max|grad|: float32 1e-5 (float32 sums in another
    order), bfloat16 2e-2 (the roundings of p and of its gradient to bf16,
    which a float32 difference may flip).  At FLASH_TRAIN_SHAPE (one
    attention site of the DiT-L/2 train step) the backward's peak memory
    beyond its inputs at each block of BWD_BLOCKS, held under
    FLASH_BWD_BUFFERS float32 (B, H, block, N) buffers plus
    FLASH_BWD_ROWS float32 (B, N, H, D) ones, and its time; the kernel's
    forward beside its plain version, F.scaled_dot_product_attention
    (forward, and forward with backward) and the bounds; in float32 the
    forward also held against its plain version within 1e-5 of max|ref|."""
    import torch
    import torch.nn.functional as F

    from image_restoration_sde_tpu_torch.ops import FLASH_ATTN
    from image_restoration_sde_tpu_torch.ops import flash_attention as FA

    gen = rng_generator(dev, SEED + 34)
    record = {}
    for dtype, rel_bound in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        name = str(dtype)[6:]
        shape = FLASH_GRAD_SHAPE
        scale = shape[-1] ** -0.5
        q, k, v = ((torch.randn(shape, generator=gen, device=dev) * 1.5).to(dtype).requires_grad_() for _ in range(3))
        cot = torch.randn(shape, generator=gen, device=dev).to(dtype)
        before = FLASH_ATTN.launches
        out = FA.flash_mha(q, k, v, scale)
        check(FLASH_ATTN.launches == before + 1 and out.grad_fn is not None, f"K4 {name}: one launch with a grad_fn")
        got = torch.autograd.grad(out, (q, k, v), cot)
        check(FLASH_ATTN.launches == before + 1, f"K4 {name}: the backward launched the kernel")
        want = torch.autograd.grad(FA.ref_mha_plain(q, k, v, scale), (q, k, v), cot)
        rels = [((a.float() - b.float()).abs().max() / b.float().abs().max()).item() for a, b in zip(got, want)]
        print(f"[flash-bwd] K4 {name} {shape}: gradients of q, k, v against the un-tiled ref_mha_plain's: "
              f"max|dgrad|/max|grad| {', '.join(f'{r:.3g}' for r in rels)} (bound {rel_bound})")
        check(max(rels) <= rel_bound, f"K4 {name} gradient: {rels}")
        del q, k, v, cot, out, got, want
        torch.cuda.empty_cache()

        shape = FLASH_TRAIN_SHAPE
        B, N, H, D = shape
        q, k, v = ((torch.randn(shape, generator=gen, device=dev) * 1.5).to(dtype) for _ in range(3))
        cot = torch.randn(shape, generator=gen, device=dev).to(dtype)
        bwd_bytes, bwd_flops = flash_bwd_work(shape, q.element_size())
        b_ms, b_by = bound(bwd_bytes, bwd_flops, name)
        sweep = {}
        for block in BWD_BLOCKS:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            grads = FA.flash_mha_backward(q, k, v, cot, scale, block=block)
            torch.cuda.synchronize()
            extra = torch.cuda.max_memory_allocated() - base
            del grads
            limit = FLASH_BWD_BUFFERS * B * H * block * N * 4 + FLASH_BWD_ROWS * B * N * H * D * 4
            ms = cuda_ms(lambda: FA.flash_mha_backward(q, k, v, cot, scale, block=block), reps=5, warmup=1)
            sweep[block] = {"ms": ms, "extra_bytes": extra}
            print(f"[flash-bwd] K4 backward {name} {shape} block {block:4d}: {ms:.3f} ms, peak extra memory "
                  f"{extra / 2**30:.3f} GiB (limit {limit / 2**30:.3f} GiB: {FLASH_BWD_BUFFERS} (B, H, block, N) and "
                  f"{FLASH_BWD_ROWS} (B, N, H, D) float32 buffers); least {b_ms:.3f} ms ({b_by}), "
                  f"{bwd_flops / ms / 1e9:.1f} TFLOP/s")
            check(extra <= limit, f"K4 backward {name} block {block}: {extra} bytes past its limit {limit}")
        torch.cuda.empty_cache()
        held = ""
        if dtype == torch.float32:  # phase 8's float32 bound at the train step's own shape
            ref = FA.flash_mha_plain(q, k, v, scale)
            err = (FA.flash_mha_cuda(q, k, v, scale) - ref).abs().max().item()
            limit = 1e-5 * ref.abs().max().item()
            del ref
            stats[FLASH_ATTN]["err"] = max(stats[FLASH_ATTN]["err"], err)
            check(err <= limit, f"K4 forward {name} {shape}: max|dy|={err:.3g} (bound {limit:.3g})")
            held = f"max|dy|={err:.3g} (bound {limit:.3g}); "
        ms = cuda_ms(lambda: FA.flash_mha_cuda(q, k, v, scale), reps=10)
        pms = cuda_ms(lambda: FA.flash_mha_plain(q, k, v, scale), reps=3, warmup=1)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale), reps=10)
        cott = cot.transpose(1, 2).contiguous()
        for t in (qt, kt, vt):
            t.requires_grad_()
        lbms = cuda_ms(lambda: torch.autograd.grad(F.scaled_dot_product_attention(qt, kt, vt, scale=scale),
                                                   (qt, kt, vt), cott), reps=5, warmup=1)
        del qt, kt, vt, cott
        nbytes, flops, _ = flash_work(shape, q.element_size())
        f_ms, f_by = bound(nbytes, flops, name)
        least = flash_f32_bound_text(shape) if dtype == torch.float32 else f"least {f_ms:.3f} ms ({f_by})"
        print(f"[flash-bwd] K4 forward {name} {shape}: {held}kernel {ms:.3f} ms, plain {pms:.3f} ms, "
              f"F.scaled_dot_product_attention {lms:.3f} ms, {least}, "
              f"{flops / ms / 1e9:.1f} TFLOP/s; forward and backward: kernel + "
              f"backward(block {FA.BWD_BLOCK}) {ms + sweep[FA.BWD_BLOCK]['ms']:.3f} ms, sdpa {lbms:.3f} ms; card: "
              f"{torch.cuda.get_device_name(dev)}")
        record[name] = {"shape": list(shape), "ms": ms, "plain_ms": pms, "library_ms": lms, "bound_ms": f_ms,
                        "bound_by": f_by, "backward_ms": sweep[FA.BWD_BLOCK]["ms"], "backward_bound_ms": b_ms,
                        "library_fwd_bwd_ms": lbms, "bwd_block": FA.BWD_BLOCK,
                        "bwd_sweep": {str(b): r for b, r in sweep.items()}}
        if dtype == torch.float32:
            record[name]["tf32x3_bound_ms"] = flash_f32_bounds(shape)[1][0]
        del q, k, v, cot
        torch.cuda.empty_cache()
    stats[FLASH_ATTN]["train"] = record


def train_batch(label, opt, dev, gen, batch=None):
    """(lq, gt, cond) at the path's YAML crop and ``batch`` (by default its
    YAML's, or TRAIN_NET_BATCH's where that cuts it), float32 on the card;
    cond the bokeh lens values."""
    import torch

    ds = opt["datasets"]["train"]
    batch = batch or TRAIN_NET_BATCH.get(label, ds["batch_size"])
    size, channels = ds["GT_size"], 6 if label == "stereo" else 3
    lq = torch.rand(batch, size, size, channels, generator=gen, device=dev)
    gt = (lq - 0.2 * torch.rand(lq.shape, generator=gen, device=dev)).clamp(0, 1)
    cond = None
    if label == "bokeh":
        cond = tuple(torch.rand(batch, generator=gen, device=dev) * s for s in (160.0, 160.0, 1.0))
    return lq, gt, cond


def train_network(label, opt) -> tuple:
    """(which, setting) of the net the path ``label`` trains, as its runner
    builds it: the compressor of ``network_L`` (else ``network_G``), the
    stereo and bokeh NAFNets for their datasets; without the ``upscale``
    that ``options.parse`` adds to sr settings."""
    from image_restoration_sde_tpu_torch.utils import options

    which, setting = options.network_setting(opt, "network_L" if label == "compressor" and opt["network_L"]
                                             else "network_G")
    which = {"stereo": "StereoConditionalNAFNet", "bokeh": "BokehConditionalNAFNet"}.get(label, which)
    return which, {k: v for k, v in setting.items() if k != "upscale"}


def train_net_step(label, opt, dev, gen, plain, state_dicts, batch, remat=False, capture=False):
    """One train step of the path ``label``'s nets (kernel or plain path)
    with a zero learning rate on ``batch``: eager, the pixel and latent
    paths with injected ``(timesteps, x_t)`` drawn from ``gen``; or
    ``capture``d (a latent path: its states drawn from ``gen`` by the step,
    one graph captured and replayed).  Returns (loss, {name: gradient},
    launches by kernel symbol (a capture's warm-up's apart), the score
    net)."""
    import torch

    from image_restoration_sde_tpu_torch import runners
    from image_restoration_sde_tpu_torch.models import build_network
    from image_restoration_sde_tpu_torch.training import ScheduledOptimizer, build_optimizer, create_train_state, \
        make_compressor_train_step, make_latent_train_step, make_train_step
    from image_restoration_sde_tpu_torch.utils import options

    nopt = options.dict_to_nonedict(opt)
    which, setting = train_network(label, nopt)
    with torch.device(dev):  # the default initialisers run on the card; the state dicts' weights replace them
        net = build_network(which, setting, plain=plain).train()
    net.load_state_dict(state_dicts["net"])
    optimizer = ScheduledOptimizer(build_optimizer(opt["train"]["optimizer"], net.parameters()), lambda s: 0.0)
    state = create_train_state(net, optimizer, ema=False)
    lq, gt, cond = batch
    sde = runners._make_irsde(nopt["sde"], dev)
    if label == "compressor":
        step, args = make_compressor_train_step(capture=False), (lq, gt, None)
    elif label in LATENT_TRAIN:
        which_l, setting_l = options.network_setting(nopt, "network_L")
        with torch.device(dev):
            comp = build_network(which_l, setting_l, plain=plain)
        comp.load_state_dict(state_dicts["compressor"])
        if not capture:
            with torch.no_grad():
                lat = comp.encode(lq[:1])[0]
            z = torch.randn(lq.shape[0], *lat.shape[1:], generator=gen, device=dev)
            sde = Injected(sde, *sde.generate_random_states(gen, z, z + 0.2))
        step, args = make_latent_train_step(sde, comp, remat=remat, capture=capture), (lq, gt, gen, cond)
    else:
        t, xt = sde.generate_random_states(gen, gt, lq)
        step, args = make_train_step(Injected(sde, t, xt), capture=False), (lq, gt, None)
    before = request_counts()
    _, metrics = step(state, *args)
    grew = {sym: n - before[sym] for sym, n in request_counts().items()}
    check(len(step.graphs or ()) == int(capture), f"train net {label}: graphs {step.graphs}")
    return metrics["loss"].item(), {k: p.grad.clone() for k, p in net.named_parameters()}, grew, net


def phase_train_nets(dev, train_opts):
    """One loss and backward of each full-width train net through its train
    step (``training.make_train_step``, ``make_compressor_train_step``,
    ``make_latent_train_step``), float32 at its YAML's batch and crop (the
    DiT at TRAIN_NET_BATCH: the plain path's attention keeps B H N^2 float32
    scores a block for the backward), with a zero learning rate: kernel path
    against plain path, the same parameters (seeded, every parameter
    non-zero; a latent path's compressor too), batch and injected
    ``(timesteps, x_t)``.  Bound: the loss within 1e-4 of itself and each
    parameter's gradient within 1e-3 of its max|grad| (the kernel path's
    forward is held to 1e-4 of its output's max in phases 4-17; the
    gradient flows back through those activations).  Launches per step: the
    forward's, none in the backward.  Then one DiT-L/2 step at its YAML's
    batch without and one with ``remat`` (K4 twice per attention site: the
    forward again in the backward), each with its peak memory."""
    import gc

    import torch

    from image_restoration_sde_tpu_torch.models import build_network, init_params_
    from image_restoration_sde_tpu_torch.utils import options

    def seeded_state(which, setting, seeded):
        # init_params_ sets every parameter (the nets hold no buffers): no default initialiser runs
        with torch.device("meta"):
            net = build_network(which, setting)
        return init_params_(net.to_empty(device="cpu"), seeded).state_dict()

    gen = rng_generator(dev, SEED + 32)
    for label, opt in train_opts.items():
        nopt = options.dict_to_nonedict(opt)
        which, setting = train_network(label, nopt)
        seeded = torch.Generator().manual_seed(SEED + 33)
        state_dicts = {"net": seeded_state(which, setting, seeded)}
        if label in LATENT_TRAIN:
            which_l, setting_l = options.network_setting(nopt, "network_L")
            state_dicts["compressor"] = seeded_state(which_l, setting_l, seeded)
        batch = train_batch(label, opt, dev, gen)
        step_gen = rng_generator(dev, SEED + 35)
        out = {}
        for plain in (False, True):
            step_gen.manual_seed(SEED + 35)
            loss, grads, grew, net = train_net_step(label, opt, dev, step_gen, plain, state_dicts, batch)
            check(grew == (counts() if plain else train_counts(label)), f"train net {label} plain={plain}: {grew}")
            out[plain] = (loss, grads)
            del net, grads
            torch.cuda.empty_cache()
        loss_rel = abs(out[False][0] - out[True][0]) / abs(out[True][0])
        worst, worst_name = 0.0, None
        for k, want in out[True][1].items():
            scale = want.abs().max().item()
            check(scale > 0, f"train net {label}: {k} has a zero gradient")
            rel = (out[False][1][k] - want).abs().max().item() / scale
            if rel > worst:
                worst, worst_name = rel, k
        shape = tuple(batch[0].shape)
        print(f"[train-net] {label} {which} f32 batch {shape[0]} at {shape[1]}x{shape[2]}x{shape[3]}: loss kernel "
              f"{out[False][0]:.6g} plain {out[True][0]:.6g} (rel {loss_rel:.3g}, bound 1e-4); "
              f"{len(out[True][1])} gradients, worst max|dgrad|/max|grad| {worst:.3g} at {worst_name} (bound 1e-3); "
              f"launches per step {train_counts(label)}")
        check(loss_rel <= 1e-4 and worst <= 1e-3, f"train net {label}: kernel path differs from plain path")
        del out, batch
        torch.cuda.empty_cache()
        if label == "dit":
            ds = opt["datasets"]["train"]
            batch = train_batch(label, opt, dev, gen, batch=ds["batch_size"])
            for remat, capture in ((False, False), (True, False), (True, True)):
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                loss, grads, grew, net = train_net_step(label, opt, dev, step_gen, False, state_dicts, batch,
                                                        remat=remat, capture=capture)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                want = {k: n * (2 if remat and k == "irsde_flash_attention" else 1)
                        for k, n in train_counts(label).items()}
                form = "captured (its warm-up and capture included)" if capture else "eager (with its warm-up)"
                check(grew == want and np.isfinite(loss), f"train net dit remat={remat} {form}: {grew}, loss {loss}")
                print(f"[train-net] dit {which} f32 batch {ds['batch_size']} at {ds['GT_size']} px, remat {remat} "
                      f"(torch.utils.checkpoint around the whole net), {form}: one step {seconds:.2f} s, launches "
                      f"{grew}, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
                del grads, net
                gc.collect()
                torch.cuda.empty_cache()
            del batch


def data_roots(kind, data, split):
    """The dataset keys of a YAML for the synthetic ``kind`` folders under
    ``data`` (write_train_data)."""
    root = f"{data}/{kind}/{split}"
    if kind == "bokeh":
        return dict(dataroot_GT=f"{root}/tgt", dataroot_LQ=f"{root}/src", dataroot_alpha=f"{root}/alpha",
                    dataroot_meta=f"{root}/meta.txt")
    if kind == "stereo":
        return dict(dataroot_GT=f"{root}/HR", dataroot_LQ=f"{root}/LR_x4")
    return dict(dataroot_GT=f"{root}/GT", dataroot_LQ=f"{root}/LQ")


def write_train_data(data):
    """The synthetic train and validation folders of TRAIN_DATA under
    ``data``, made from the seed."""
    from image_restoration_sde_tpu_torch.data.synthetic import write_bokeh, write_pairs, write_stereo

    writers = {"pairs": write_pairs, "bokeh": write_bokeh, "stereo": write_stereo}
    for i, (kind, (writer, n, train_hw, val_hw)) in enumerate(sorted(TRAIN_DATA.items())):
        writers[writer](f"{data}/{kind}/train", n, SEED + 40 + 2 * i, *train_hw)
        writers[writer](f"{data}/{kind}/val", TRAIN_VAL_IMAGES, SEED + 41 + 2 * i, *val_hw)


def write_train_yaml(path, label, opt, root, data, niter, save_freq, val_freq, resume=None, plain=False, name=None,
                     pretrain_l=None, batch=None, train=None, pretrain_g=None):
    """``opt`` (a train YAML) with its data on the synthetic folders, its
    iteration count and frequencies cut to this run, its validation's
    sampler to ``val_steps`` and, for a latent path, its frozen
    compressor's ``.pth`` (``pretrain_l``, or None: seeded), written to
    ``path``; ``plain`` the plain path of every net; ``batch`` in place of
    its batch size, ``train`` keys added to its ``train`` section;
    ``pretrain_g`` the trained net's starting ``.pth`` (None: as the YAML
    says)."""
    import copy

    import yaml

    opt = copy.deepcopy(opt)
    kind, val_images = TRAIN_PATHS[label][1], TRAIN_PATHS[label][5]
    opt["name"] = name or opt["name"]
    opt["use_tb_logger"] = False
    ds = opt["datasets"]
    ds["train"].update(data_roots(kind, data, "train"))
    ds["val"].update(data_roots(kind, data, "val"), max_images=val_images)
    opt["path"].update(root=root, resume_state=resume)
    if "pretrain_model_L" in opt["path"]:
        opt["path"]["pretrain_model_L"] = pretrain_l
    if pretrain_g:
        opt["path"]["pretrain_model_G"] = pretrain_g
    opt["train"].update(niter=niter, val_freq=val_freq, **(train or {}))
    if batch:
        ds["train"]["batch_size"] = batch
    opt["logger"].update(print_freq=4, save_checkpoint_freq=save_freq)
    if opt.get("sde"):
        opt["sde"]["sample_T"] = val_steps(opt)
    if plain:
        for key in ("network_G", "network_L"):
            if key in opt:
                opt[key]["setting"] = {**opt[key]["setting"], "plain": True}
    with open(path, "w") as f:
        yaml.safe_dump(opt, f)
    return path


def val_steps(opt):
    """Reverse steps of a train YAML's validation sampler: its sample_T
    (else T) cut to TRAIN_VAL_SAMPLE_T."""
    return min(TRAIN_VAL_SAMPLE_T, int(opt["sde"].get("sample_T") or opt["sde"]["T"]))


@contextlib.contextmanager
def no_checkpoints():
    """The train entry point writes no checkpoint inside the block (the
    resumed and plain-path runs of phase 21: nothing reads their files, and
    the machine's disk counts every byte written, ~2 GB a checkpoint of the
    pixel nets and ~7 GB of the DiT's)."""
    from image_restoration_sde_tpu_torch import train

    save = train.save_checkpoint
    train.save_checkpoint = lambda *args: None
    try:
        yield
    finally:
        train.save_checkpoint = save


@contextlib.contextmanager
def recorded_steps(snapshot_at=(), grads_at=(), control_at=None):
    """Record every train step and validation the train tasks make inside
    the block: per step its launches by kernel symbol (less a capture's
    warm-up's, ``request_counts``), card milliseconds (host clock between
    synchronisations) and loss (``steps``), the host milliseconds up to its
    return, before the synchronisation (``host_ms``), and the state of the
    run's generator after it (``gens``); the net's parameters
    (on the host) after each step of ``snapshot_at`` (``snapshots``, by
    step) and the gradients the optimizer stepped on (under DDP the ranks'
    mean) at each step of ``grads_at`` (``grads``, by step); what step
    ``control_at`` begins with (``control``: the task, its batch, the
    generators' states and the parameters; ``block_mean_grads``); the
    step's captured graphs after each capture (``capture``: their count,
    the warm-ups' and captures' seconds, the pool's MiB); per
    validation its launches and image count.  A split net's gradients are
    assembled from its model group (a collective of its ranks)."""
    import copy

    import torch

    from image_restoration_sde_tpu_torch import runners

    rec = {"steps": [], "host_ms": [], "gens": [], "vals": [], "snapshots": {}, "grads": {}, "capture": None}
    classes = [c for c in (runners.PixelDiffusionTask, runners.GaussianDenoisingTask, runners.CompressorTask,
                           runners.LatentDiffusionTask) if "step" in vars(c)]
    originals = {c: (c.step, c.validate) for c in classes}

    def recording(step, validate):
        def step_rec(self, state, batch, gen):
            if control_at == state.step + 1:
                rec["control"] = {"task": self, "step": step, "batch": batch, "gen": gen.get_state(),
                                  "device": gen.device, "deg": copy.deepcopy(self.deg_rng.bit_generator.state),
                                  "params": {k: v.detach().clone() for k, v in state.net.named_parameters()}}
            before = request_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(self, state, batch, gen)
            host = (time.perf_counter() - t0) * 1e3
            loss = metrics["loss"].item()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            rec["steps"].append(({sym: n - before[sym] for sym, n in request_counts().items()}, ms, loss))
            rec["host_ms"].append(host)
            rec["gens"].append(gen.get_state())
            graphs = getattr(self._train_step, "graphs", None)
            if graphs is not None and len(graphs) != (rec["capture"] or {}).get("graphs", 0):
                entries = [e for _, e in graphs.entries()]
                rec["capture"] = {"graphs": len(entries), "warm_s": [e.warm_s for e in entries],
                                  "capture_s": [e.capture_s for e in entries],
                                  "pool_mib": graphs.pool_bytes() / 2**20}
            if state.step in snapshot_at:
                rec["snapshots"][state.step] = {k: v.detach().cpu() for k, v in state.net.named_parameters()}
            if state.step in grads_at:
                grads = {k: v.grad.detach() for k, v in state.net.named_parameters() if v.grad is not None}
                if state.layout is not None:
                    grads = state.layout.whole(grads)
                rec["grads"][state.step] = {k: v.cpu() for k, v in grads.items()}
            return state, metrics

        def validate_rec(self, state, loader, gen, out_dir, at):
            before = request_counts()
            vm = validate(self, state, loader, gen, out_dir, at)
            rec["vals"].append(({sym: n - before[sym] for sym, n in request_counts().items()}, vm))
            return vm

        return step_rec, validate_rec

    for c, (step, validate) in originals.items():
        c.step, c.validate = recording(step, validate)
    try:
        yield rec
    finally:
        for c, (step, validate) in originals.items():
            c.step, c.validate = step, validate


def block_mean_grads(control, state, n):
    """The gradients that n data-parallel ranks average at the step that
    ``control`` recorded (``recorded_steps``): rank r's step on its rows
    of the batch and of the global batch's draws (``state.shard``), from
    the step's parameters and generators, backward only; each divided by
    n and summed in rank order, as DDP's all-reduce of two ranks sums
    them.  Leaves ``state.net`` at the step's parameters, without
    gradients; returns the mean on the host."""
    import copy

    import torch

    from image_restoration_sde_tpu_torch.training import trainer

    task, batch, net = control["task"], control["batch"], state.net
    local = len(next(iter(batch.values()))) // n
    apply, total = trainer._apply_update, None

    def backward_only(state, loss):
        loss.backward()
        return state

    trainer._apply_update = backward_only
    try:
        for r in range(n):
            with torch.no_grad():
                for k, v in net.named_parameters():
                    v.copy_(control["params"][k])
                    v.grad = None
            gen = torch.Generator(device=control["device"])
            gen.set_state(control["gen"])
            task.deg_rng.bit_generator.state = copy.deepcopy(control["deg"])
            state.shard = (r, n)
            control["step"](task, state, {k: v[r * local:(r + 1) * local] for k, v in batch.items()}, gen)
            grads = {k: v.grad.detach() / n for k, v in net.named_parameters() if v.grad is not None}
            total = grads if total is None else {k: total[k] + g for k, g in grads.items()}
    finally:
        trainer._apply_update, state.shard = apply, None
        for v in net.parameters():
            v.grad = None
    return {k: v.cpu() for k, v in total.items()}


def phase_train_main_path(dev, label, opt, workdir, smi, pretrain_l=None, keep=None):
    """The port's train entry point (``train.train``, what ``python -m
    image_restoration_sde_tpu_torch.train -opt=<yml>`` runs) on the train
    path ``label``'s YAML (TRAIN_PATHS), float32 with torch's default TF32
    settings, which the entry point runs with (cuDNN TF32 on: with it off,
    cuDNN runs the UNet's float32 convolutions through FFTs at ~5x the step
    time; ``chip_profile.py``), its data on the synthetic folders
    (TRAIN_DATA), ``niter`` cut to the path's steps with a checkpoint
    half-way and one validation (the path's validation images, the YAML's
    sampler) at the end, every net it builds fresh held by ``init_check``
    (``fresh_nets``); cuDNN's deterministic algorithms on the paths of
    TRAIN_DETERMINISTIC.  Its steps are captured, as the entry point runs them
    on the card: one graph (``training/captured.py``), whose capture
    seconds and pool are reported.  Per train step exactly the forward's
    launches (``train_counts``; a replay counts its recorded nodes, the
    warm-up's apart), none in the backward, and a finite loss; per
    validation image exactly ``val_counts``; the checkpoints on disk
    (``lastest_EMA.pth`` where the task keeps an EMA).  Then the eager
    side: the run resumed from the captured run's half-way checkpoint (the
    same YAML with ``path.resume_state``, ``train(..., capture=False)``),
    its steps against the captured run's, bit-equal for the paths of
    TRAIN_BIT_EQUAL (losses, final parameters, optimizer state and EMA),
    else (the pixel, bokeh and stereo paths) its first step's loss within
    1e-6 and the parameters after it elementwise within 2 lr_G (Adam's and
    Lion's sign-sensitive steps on gradients the card may sum in another
    order; on TRAIN_TWIN a second eager run from the same checkpoint prints
    how far two eager steps differ); on every path the generator's state
    after the last step equal.  On the compressor, ``grad_accum_runs``.
    Then the path's plain-path steps (no kernel launches) for their time.
    Returns the launches of the captured run by kernel symbol and a record
    of the captured and eager ms and host ms a step, the capture's seconds
    and pool, and the peak memory; ``keep`` (a dict) gets the eager run's
    losses and milliseconds at the steps of DP_AT, its parameters after
    them, the gradients of the first, the half-way checkpoint (``state``,
    ``weights``) and, for each world size of ``dp_runs`` past 1, the first
    step's gradients that that many ranks average (``block_mean_grads``,
    computed after the path's launches were read), which phase train dp
    holds its runs (eager, resumed from the same checkpoint) against."""
    import torch

    cudnn_tf32, deterministic = torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic
    torch.backends.cudnn.allow_tf32 = True  # torch's default
    torch.backends.cudnn.deterministic = label in TRAIN_DETERMINISTIC
    try:
        return train_main_path(dev, label, opt, workdir, smi, pretrain_l, keep)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = cudnn_tf32, deterministic


def final_state(state, label) -> dict:
    """What a train run ends with, on the host: its step count and
    parameters and, on the paths held bit for bit (TRAIN_BIT_EQUAL), the
    optimizer's counts and state (``state_tensors``) and the EMA's count
    and parameters."""
    out = {"step": state.step, "params": [p.detach().cpu() for p in state.net.parameters()]}
    if label in TRAIN_BIT_EQUAL:
        opt = state.optimizer
        out.update(counts=(opt.updates, opt.mini_step), opt=[t.cpu() for t in opt.state_tensors()])
        if state.ema is not None:
            out.update(ema_step=state.ema.step, ema=[t.cpu() for t in state.ema.params.values()])
    return out


def final_differs(a: dict, b: dict) -> list:
    """The parts in which two runs' ``final_state`` differ (none: bit-equal)."""
    import torch

    def same(x, y):
        if isinstance(x, list):
            return len(x) == len(y) and all(u.shape == v.shape and torch.equal(u, v) for u, v in zip(x, y))
        return x == y

    return sorted(k for k in a.keys() | b.keys() if k not in a or k not in b or not same(a[k], b[k]))


def train_main_path(dev, label, opt, workdir, smi, pretrain_l, keep):
    import gc
    import statistics as stats_

    import torch

    from image_restoration_sde_tpu_torch import train
    from image_restoration_sde_tpu_torch.utils import options

    _, kind, steps, save, plain_steps, val_images = TRAIN_PATHS[label]
    data = os.path.join(workdir, "data")
    root = os.path.join(workdir, label)
    os.makedirs(root, exist_ok=True)
    batch, crop = opt["datasets"]["train"]["batch_size"], opt["datasets"]["train"]["GT_size"]
    lr = float(opt["train"]["lr_G"])
    yml = write_train_yaml(os.path.join(root, "run.yml"), label, opt, root, data, steps, save, steps,
                           pretrain_l=pretrain_l)
    exp = options.parse(yml)["path"]["experiments_root"]
    want = train_counts(label)
    reset_counts()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with recorded_steps(snapshot_at=(save + 1,)) as rec, fresh_nets(f"train {label}", dev) as inits:
        t0 = time.perf_counter()
        state = train.train(yml, dev)  # captured: the entry point's default on the card
        seconds = time.perf_counter() - t0
    check(len(inits) == (2 if label in LATENT_TRAIN else 1), f"train {label}: {len(inits)} fresh nets")  # + compressor
    peak = torch.cuda.max_memory_allocated()
    launches = request_counts()
    keeps_ema = state.ema is not None
    final = final_state(state, label)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    check(keeps_ema is (label not in ("compressor", "bokeh")), f"train {label}: EMA kept: {keeps_ema}")
    check(len(rec["steps"]) == steps, f"train {label}: {len(rec['steps'])} steps")
    for i, (grew, _, loss) in enumerate(rec["steps"]):
        check(grew == want, f"train {label} step {i + 1}: launches {grew}, expected {want}")
        check(np.isfinite(loss), f"train {label} step {i + 1}: loss {loss}")
    cap = rec["capture"]
    check(cap is not None and cap["graphs"] == 1, f"train {label}: captured graphs {cap}")
    check(len(rec["vals"]) == 1, f"train {label}: {len(rec['vals'])} validations")
    per_image = val_counts(label, val_steps(opt))
    for grew, vm in rec["vals"]:
        sampler = {sym: n * val_images for sym, n in per_image.items()}
        check(grew == sampler and np.isfinite(vm["psnr"]), f"train {label} validation: {grew}, psnr {vm['psnr']}")
    saved = sorted(os.listdir(os.path.join(exp, "models")))
    check(saved == sorted([f"{save}_G.pth", f"{steps}_G.pth"] + (["lastest_EMA.pth"] if keeps_ema else [])),
          f"train {label}: models {saved}")
    losses = [r[2] for r in rec["steps"]]

    # the eager side: the captured run's half-way checkpoint resumed with
    # every step eager (no validation, no checkpoint written)
    state_file = os.path.join(exp, "training_state", f"{save}.state")
    yml_resume = write_train_yaml(os.path.join(root, "resume.yml"), label, opt, root, data, steps, save,
                                  steps * 10, resume=state_file, pretrain_l=pretrain_l)

    def eager_run(snapshot_at, grads_at=(), control_at=None, niter=None):
        yml_ = yml_resume if niter is None else write_train_yaml(
            os.path.join(root, "resume_twin.yml"), label, opt, root, data, niter, save, steps * 10, resume=state_file,
            pretrain_l=pretrain_l)
        torch.cuda.reset_peak_memory_stats()
        with recorded_steps(snapshot_at, grads_at, control_at) as rec_, no_checkpoints():
            state_ = train.train(yml_, dev, capture=False)
        return rec_, state_, torch.cuda.max_memory_allocated()

    rec_eager, state, eager_peak = eager_run(
        (save + 1, *(DP_AT if keep is not None else ())), DP_AT[:1] if keep is not None else (),
        DP_AT[0] if keep is not None else None)
    eager_final = final_state(state, label)
    if keep is not None:  # phase train dp's one-process reference: these eager steps, resumed as its runs are
        window = rec_eager["steps"][DP_AT[0] - save - 1:DP_AT[1] - save]
        keep.update(losses=[r[2] for r in window], ms=[r[1] for r in window],
                    params={at: rec_eager["snapshots"][at] for at in DP_AT}, grads=rec_eager["grads"][DP_AT[0]],
                    lr=lr, state=state_file, weights=os.path.join(exp, "models", f"{save}_G.pth"))
        keep["block_grads"] = {n: block_mean_grads(rec_eager["control"], state, n) for _, n, _ in dp_runs()
                               if n and n > 1}
        del rec_eager["control"]
    del state
    gc.collect()
    torch.cuda.empty_cache()
    check(len(rec_eager["steps"]) == steps - save and not rec_eager["vals"],
          f"train {label} eager: {len(rec_eager['steps'])} steps, {len(rec_eager['vals'])} validations")
    check(all(grew == want for grew, _, _ in rec_eager["steps"]), f"train {label} eager steps: launches")
    check(rec_eager["capture"] is None, f"train {label} eager: a graph was captured")

    def step_diff(loss, snapshot):
        """Step save + 1's ``loss`` and the parameters after it against the
        eager run's: loss rel, parameters max|d|."""
        want = rec_eager["steps"][0][2]
        return abs(loss - want) / abs(want), max((snapshot[k] - v).abs().max().item()
                                                 for k, v in rec_eager["snapshots"][save + 1].items())

    if label == TRAIN_TWIN:  # two eager runs from the same checkpoint: how far the card's own order moves a step
        rec_twin, state, _ = eager_run((save + 1,), niter=save + 1)
        del state
        gc.collect()
        torch.cuda.empty_cache()
        twin_rel, twin_dparam = step_diff(rec_twin["steps"][0][2], rec_twin["snapshots"][save + 1])
        print(f"[train-main] {label}: two eager runs resumed from step {save}: step {save + 1} loss rel "
              f"{twin_rel:.3g}, parameters after it max|d| {twin_dparam:.3g} (2 lr_G = {2 * lr:.3g})")
    loss_rel, dparam = step_diff(rec["steps"][save][2], rec["snapshots"][save + 1])
    equal_losses = [a[2] for a in rec_eager["steps"]] == losses[save:]
    differs = final_differs(final, eager_final)
    equal_gens = torch.equal(rec["gens"][-1], rec_eager["gens"][-1])
    held = "parameters, optimizer state and EMA" if label in TRAIN_BIT_EQUAL else "parameters"
    print(f"[train-main] {label}: captured run against its step-{save} checkpoint resumed eagerly (the checkpoint "
          f"written captured, read eager): step {save + 1} loss {losses[save]:.8g} captured, "
          f"{rec_eager['steps'][0][2]:.8g} eager (rel {loss_rel:.3g}); parameters after it max|d| {dparam:.3g} "
          f"(2 lr_G = {2 * lr:.3g}); steps {save + 1}..{steps} losses bit-equal: {equal_losses}, final {held} "
          f"bit-equal: {not differs}{f' (differ: {differs})' if differs else ''}; generator states equal after step "
          f"{steps}: {equal_gens}")
    if label in TRAIN_BIT_EQUAL:
        check(equal_losses and not differs and dparam == 0, f"train {label}: captured and eager runs differ")
    else:
        check(loss_rel <= 1e-6 and dparam <= 2 * lr, f"train {label}: the captured and eager steps differ")
    check(equal_gens, f"train {label}: the generators' states differ")
    del final, eager_final
    if label == "compressor":
        grad_accum_runs(dev, label, opt, root, data, smi)

    p_ms = None
    if plain_steps:
        yml_plain = write_train_yaml(os.path.join(root, "plain.yml"), label, opt, root, data, plain_steps,
                                     steps * 10, steps * 10, plain=True, name=f"{opt['name']}_plain",
                                     pretrain_l=pretrain_l)
        before = sum(request_counts().values())
        with recorded_steps() as rec_plain, no_checkpoints():
            train.train(yml_plain, dev, capture=False)  # eager: a capture would cost more than its few steps
        gc.collect()
        torch.cuda.empty_cache()
        check(sum(request_counts().values()) == before, f"train {label}: the plain path launched a kernel")
        p_ms = stats_.median([r[1] for r in rec_plain["steps"][2:]])
    k_ms, k_host = stats_.median([r[1] for r in rec["steps"][2:]]), stats_.median(rec["host_ms"][2:])
    later = slice(1, None) if len(rec_eager["steps"]) > 1 else slice(None)  # past the eager run's first step
    e_ms = stats_.median([r[1] for r in rec_eager["steps"][later]])
    e_host = stats_.median(rec_eager["host_ms"][later])
    capture_s = sum(cap["warm_s"]) + sum(cap["capture_s"])
    print(f"[train-main] {label}: {steps} steps, batch {batch} at {crop}px, float32 (cuDNN TF32 on), {seconds:.1f} s "
          f"with {steps // save + 1} saves and one validation of {val_images} image(s); loss {losses[0]:.4g} -> "
          f"{losses[-1]:.4g}; launches per step {want}; peak memory captured {peak / 2**30:.2f} GiB, eager "
          f"{eager_peak / 2**30:.2f} GiB")
    plain_text = (f"plain path (eager) {p_ms:.3f} ({batch * 1e3 / p_ms:.3f} img/s) over {plain_steps - 2} steps"
                  if p_ms else "plain path not run (TRAIN_PATHS)")
    print(f"[train-main] {label}: ms/step captured {k_ms:.3f} ({batch * 1e3 / k_ms:.3f} img/s; median of steps 3..), "
          f"eager {e_ms:.3f} ({batch * 1e3 / e_ms:.3f} img/s); host ms/step captured {k_host:.3f}, eager "
          f"{e_host:.3f}; capture {capture_s:.2f} s (warm-up {sum(cap['warm_s']):.2f}, capture "
          f"{sum(cap['capture_s']):.2f}), graph pool {cap['pool_mib']:.1f} MiB; {plain_text}; card: {smi}")
    record = {"ms_per_step": k_ms, "img_per_s": batch * 1e3 / k_ms, "host_ms_per_step": k_host,
              "eager_ms_per_step": e_ms, "eager_img_per_s": batch * 1e3 / e_ms, "eager_host_ms_per_step": e_host,
              "capture_s": capture_s, "warm_s": sum(cap["warm_s"]), "pool_mib": cap["pool_mib"],
              "plain_ms_per_step": p_ms, "plain_img_per_s": batch * 1e3 / p_ms if p_ms else None,
              "peak_memory_gib": peak / 2**30, "eager_peak_memory_gib": eager_peak / 2**30,
              "batch": batch, "crop": crop, "launches_per_step": want, "init": inits, "card": smi}
    return launches, record, os.path.join(exp, "models", f"{steps}_G.pth")


def grad_accum_runs(dev, label, opt, root, data, smi):
    """``train.grad_accum: 2`` on the path ``label`` (the compressor's),
    GRAD_ACCUM_STEPS calls (half as many updates): eager, writing a
    checkpoint half-way and at the end; captured from the start (one graph
    a cycle position); and captured from the eager run's half-way
    checkpoint (the checkpoint written eager, read captured).  Both
    captured runs bit-equal to the eager one (losses, final parameters,
    optimizer state, generator), exact launches a call."""
    import gc

    import torch

    from image_restoration_sde_tpu_torch import train
    from image_restoration_sde_tpu_torch.utils import options

    n, half = GRAD_ACCUM_STEPS, GRAD_ACCUM_STEPS // 2
    want, runs = train_counts(label), {}
    yml = write_train_yaml(os.path.join(root, "accum.yml"), label, opt, root, data, n, half, n * 10,
                           name=f"{opt['name']}_accum", train={"grad_accum": 2})
    exp = options.parse(yml)["path"]["experiments_root"]
    captured = write_train_yaml(os.path.join(root, "accum_captured.yml"), label, opt, root, data, n, n * 10,
                                n * 10, name=f"{opt['name']}_accum_captured", train={"grad_accum": 2})
    resume = write_train_yaml(os.path.join(root, "accum_resume.yml"), label, opt, root, data, n, half, n * 10,
                              name=f"{opt['name']}_accum", train={"grad_accum": 2},
                              resume=os.path.join(exp, "training_state", f"{half}.state"))
    for form, path, capture in (("eager", yml, False), ("captured", captured, True),
                                ("resumed captured", resume, True)):
        with recorded_steps() as rec, contextlib.ExitStack() as stack:
            if form != "eager":
                stack.enter_context(no_checkpoints())
            state = train.train(path, dev, capture=capture)
        runs[form] = (rec, final_state(state, label), state.optimizer.updates)
        del state
        gc.collect()
        torch.cuda.empty_cache()
        check(all(grew == want for grew, _, _ in rec["steps"]), f"train {label} grad_accum {form}: launches")
    (eager, e_final, e_updates) = runs["eager"]
    for form in ("captured", "resumed captured"):
        rec, final, updates = runs[form]
        at = half if form.startswith("resumed") else 0
        graphs = (rec["capture"] or {}).get("graphs")
        differs = final_differs(final, e_final)
        same = ([r[2] for r in rec["steps"]] == [r[2] for r in eager["steps"][at:]] and not differs
                and torch.equal(rec["gens"][-1], eager["gens"][-1]) and updates == e_updates == n // 2)
        print(f"[train-main] {label} grad_accum 2, {form}{f' from the eager step-{half} checkpoint' if at else ''}: "
              f"{len(rec['steps'])} calls, {updates} updates, {graphs} graphs (one a cycle position), against "
              f"eager: losses, final parameters, optimizer state and generator bit-equal: {same}"
              f"{f' (differ: {differs})' if differs else ''} (card: {smi})")
        check(same and graphs == 2, f"train {label} grad_accum {form}: differs from eager")


# ---------------------------------------------------------------- the train initialisation
# every net the train entry point builds fresh starts as the JAX package's
# (flax's initialisers): the tensors flax makes constant, by parameter
# name, hold their constant exactly (biases, the NAFBlock and SCAM scales
# beta / gamma, the DiT's modulations and final linear map 0; the channel
# LayerNorms' gains g 1); every other weight is a lecun_normal kernel:
# within 2 sigma' = 2 sqrt(1/fan_in) / INIT_TRUNCATED_STD (float32 scaling:
# INIT_ULP of slack) and, from INIT_STD_MIN_SIZE elements, a std within
# INIT_STD_REL of sqrt(1/fan_in) (~4.5 sampling errors at that size); the
# Fourier features' frequencies (``weights``) drawn N(0, 1); a fresh DiT
# returns exactly 0
INIT_ZERO = ("bias", "beta", "gamma")
INIT_DIT_ZERO = ("adaLN_modulation.1.weight", "final_layer.linear.weight")
INIT_TRUNCATED_STD, INIT_ULP = 0.87962566103423978, 1e-6
INIT_STD_MIN_SIZE, INIT_STD_REL = 1024, 0.10


def init_check(tag, net, dev) -> dict:
    """Hold one fresh net (see INIT_ZERO): its constants, its kernels and,
    for a DiT, one forward on the card at a 16x16 latent (its K4 launches
    taken off the counts: they are not the path's).  Returns a record."""
    import torch

    from image_restoration_sde_tpu_torch.models import DiT
    from image_restoration_sde_tpu_torch.ops import KERNELS

    constants, kernels, worst, ratios = 0, 0, 0.0, []
    with torch.no_grad():
        for name, p in net.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in INIT_ZERO or leaf == "g" or name.endswith(INIT_DIT_ZERO):
                want = 1.0 if leaf == "g" else 0.0
                check(bool((p == want).all()), f"{tag}: {name} is not flax's constant {want}")
                constants += 1
            elif leaf == "weights":  # Fourier frequencies, N(0, 1)
                check(p.numel() < 2 or bool((p != p.flatten()[0]).any()), f"{tag}: {name} is constant")
            else:
                check(p.dim() in (2, 4), f"{tag}: {name} {tuple(p.shape)}: not a conv or dense kernel")
                fan_in = p[0].numel()
                sigma = fan_in**-0.5 / INIT_TRUNCATED_STD
                worst = max(worst, p.abs().max().item() / sigma)
                if p.numel() >= INIT_STD_MIN_SIZE:
                    ratios.append(p.double().std().item() * fan_in**0.5)
                kernels += 1
    check(worst <= 2 * (1 + INIT_ULP), f"{tag}: a kernel reaches {worst:.6f} sigma' (bound 2)")
    check(ratios and all(abs(r - 1) <= INIT_STD_REL for r in ratios),
          f"{tag}: kernel std / sqrt(1/fan_in) {min(ratios, default=0):.4f}..{max(ratios, default=0):.4f}")
    rec = {"constants": constants, "kernels": kernels, "max_abs_over_sigma": worst,
           "std_ratio": [min(ratios), max(ratios)], "kernels_std_held": len(ratios)}
    if isinstance(net, DiT):
        launches = [k.launches for k in KERNELS]
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 19)
        x, cond = (torch.randn(2, 16, 16, net.in_channels, generator=gen, device=dev) for _ in range(2))
        with torch.no_grad():
            out = net(x, cond, torch.tensor([5.0, 60.0], device=dev))
        for k, n in zip(KERNELS, launches):
            k.launches = n
        check(out.shape == x.shape and not out.any(), f"{tag}: a fresh DiT returns max|out| {out.abs().max().item()}")
        rec["dit_forward_zero"] = True
    print(f"[init] {tag}: {type(net).__name__}: {constants} tensors at flax's constants exactly, {kernels} kernels "
          f"within {worst:.6f} sigma' (bound 2), std / sqrt(1/fan_in) {min(ratios):.4f}..{max(ratios):.4f} over the "
          f"{len(ratios)} of at least {INIT_STD_MIN_SIZE} elements (bound {INIT_STD_REL})"
          + ("; its first forward on the card exactly 0" if "dit_forward_zero" in rec else ""))
    return rec


@contextlib.contextmanager
def fresh_nets(tag, dev):
    """Every net the train entry point builds inside the block
    (``runners._seeded_network``: the trained net, a latent task's seeded
    compressor) moved to the card and held by ``init_check`` before the
    task takes it; yields the records."""
    from image_restoration_sde_tpu_torch import runners

    build, rec = runners._seeded_network, []

    def checked(which, setting, seed):
        net = build(which, setting, seed).to(dev)
        rec.append({"which": which, **init_check(f"{tag} {which}", net, dev)})
        return net

    runners._seeded_network = checked
    try:
        yield rec
    finally:
        runners._seeded_network = build


# ---------------------------------------------------------------- the demos
# The demo YAMLs (configs/demo/: the two-stage Refusion and bokeh chains,
# stereo SR), copied as chip_learn.py copies them (its dataroots, path.root
# and a stage 2's pretrain_model_L in the directory its stage 1 wrote,
# spelled {iter}_G) and cut in niter and val_freq only (DEMO_STEPS steps, one
# validation at the end, its sampler at TRAIN_VAL_SAMPLE_T steps), on
# gen_synth's data at DEMO_DATA (2 train, 1 val, the sides the crops take);
# the learning runs themselves are chip_learn.py's.  A stage whose files
# nothing reads writes none (a save point of the 77M-parameter NAFNet with
# its training state is ~1.5 GB); the Refusion stage 2, which the test
# entry point reads, its weights only
DEMO_STEPS = 2
DEMO_DATA = {"refusion": {"n_train": 2, "n_val": 1, "size": 512}, "stereo": {"n_train": 2, "n_val": 1},
             "bokeh": {"n_train": 2, "n_val": 1}}
DEMO_SAVES = {("refusion", "stage1"): "all", ("refusion", "stage2"): "weights", ("stereo", "stereo_sr"): None,
              ("bokeh", "stage1"): "all", ("bokeh", "stage2"): None}


def demo_counts(opt):
    """Launches (per train step, per validation image) of a demo stage's
    YAML: the compressor's (stage 1), the Refusion latent path's, the
    stereo NAFNet's, or the bokeh NAFNet's, whose blocks (2 K1 each) fuse
    no level, on the frozen compressor's encode (train) and encode and
    decode (validation)."""
    steps, setting = val_steps(opt), opt["network_G"]["setting"]
    if opt["model"] == "latent":
        return train_counts("compressor"), val_counts("compressor", steps)
    if opt["datasets"]["train"]["mode"].startswith("Ste"):
        return train_counts("stereo"), val_counts("stereo", steps)
    if not opt["datasets"]["train"]["mode"].startswith("Bokeh"):
        return train_counts("latent"), val_counts("latent", steps)
    blocks = sum(setting["enc_blk_nums"]) + setting["middle_blk_num"] + sum(setting["dec_blk_nums"])
    enc = counts(LAYERNORM=COMPRESSOR_LN // 2, LA_CTX=COMPRESSOR_ATTN // 2, LA_APPLY=COMPRESSOR_ATTN // 2)
    net = counts(LAYERNORM=2 * blocks)
    return ({k: enc[k] + net[k] for k in enc},
            {k: steps * net[k] + 2 * enc[k] for k in enc})


@contextlib.contextmanager
def demo_saves(kind):
    """The train entry point's save points inside the block: ``all`` as
    they are, ``weights`` the net's and EMA's ``.pth`` files only (no
    training state: nothing resumes), None nothing (``no_checkpoints``)."""
    from image_restoration_sde_tpu_torch import train
    from image_restoration_sde_tpu_torch.training import checkpoint

    if kind == "all":
        yield
        return
    if kind is None:
        with no_checkpoints():
            yield
        return

    def weights(opt_path, state, epoch, iter_step, generator, extra=None):
        whole = checkpoint.whole_state(state)
        checkpoint.save_params(opt_path["models"], whole["net"], f"{iter_step}_G")
        if state.ema is not None:
            checkpoint.save_params(opt_path["models"], checkpoint.ema_state_dict(state, whole), "lastest_EMA")

    save = train.save_checkpoint
    train.save_checkpoint = weights
    try:
        yield
    finally:
        train.save_checkpoint = save


@contextlib.contextmanager
def loaded_compressors():
    """The frozen compressor of every latent task (``pretrain_model_L`` as
    the YAML spells it, its tensors on the host after loading) built
    inside the block."""
    from image_restoration_sde_tpu_torch import runners

    rec, load = [], runners.LatentDiffusionTask.maybe_load_pretrained

    def recording(self, state):
        load(self, state)
        rec.append((self.opt["path"]["pretrain_model_L"],
                    {k: v.detach().cpu() for k, v in self.compressor.state_dict().items()}))

    runners.LatentDiffusionTask.maybe_load_pretrained = recording
    try:
        yield rec
    finally:
        runners.LatentDiffusionTask.maybe_load_pretrained = load


def phase_demo(dev, workdir, smi, stats):
    """The demo chains of ``chip_learn.py`` through the train entry point
    (``train.train``), at torch's default TF32 settings as phase 21:
    ``gen_synth``'s data at DEMO_DATA, each of the five demo YAMLs copied by
    ``chip_learn``'s code and cut to DEMO_STEPS steps and one validation;
    per step exactly ``demo_counts``' launches and a finite loss, per
    validation image exactly its launches and a finite PSNR; each stage 2's
    frozen compressor, named ``{iter}_G`` as the shipped YAMLs name it,
    loaded from the ``{iter}_G.pth`` its stage 1 wrote, bit-equal to it;
    then the test entry point on the Refusion stage 2's ``lastest_EMA.pth``
    (exactly ``eval_counts`` launches an image, the PNGs, finite metrics).
    Every K1, K2 and K3 launch records its site, and each kernel is then
    held against its plain version at every distinct site (``hold_sites``,
    ``hold_naf_sites``).  Returns the launches and a record."""
    import torch

    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # torch's default, as the entry points run
    try:
        with recorded_sites() as (ln, attn), recorded_naf_sites() as naf:
            result = demo_main_path(dev, os.path.join(workdir, "demo"), smi)
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    hold_sites("demo", dev, ln, attn, stats, {})
    hold_naf_sites("demo", dev, naf, stats)
    return result


def demo_main_path(dev, root, smi):
    import gc

    import torch

    import chip_learn
    from image_restoration_sde_tpu_torch import train
    from image_restoration_sde_tpu_torch.ops import KERNELS
    from image_restoration_sde_tpu_torch.utils import options

    total, record = {k.symbol: 0 for k in KERNELS}, {}
    for demo, data_kw in DEMO_DATA.items():
        (kind, _), stages = chip_learn.DEMOS[demo]
        base = os.path.join(root, demo)
        t0 = time.perf_counter()
        data = chip_learn.write_data(kind, os.path.join(base, "data"), **data_kw)
        print(f"[demo] {demo}: gen_synth {kind} {data_kw} in {time.perf_counter() - t0:.1f} s")
        done = {}
        for label, shipped, changes in stages:
            if "resume" in changes:  # resumed train runs: phase 21
                continue
            opt = chip_learn.stage_opt(load_yaml(shipped), kind, data, os.path.join(base, "run"), changes)
            opt["train"].update(niter=DEMO_STEPS, val_freq=DEMO_STEPS)
            opt["sde"]["sample_T"] = val_steps(opt)
            chip_learn.link(opt, changes, done)
            yml = chip_learn.dump_yaml(opt, os.path.join(base, "yml", f"{label}.yml"))
            models = options.parse(yml, is_train=True)["path"]["models"]
            want_step, want_val = demo_counts(opt)
            reset_counts()
            t0 = time.perf_counter()
            with recorded_steps() as rec, loaded_compressors() as loaded, demo_saves(DEMO_SAVES[demo, label]), \
                    fresh_nets(f"demo {demo} {label}", dev) as inits:
                state = train.train(yml, dev)
            seconds = time.perf_counter() - t0
            for sym, n in request_counts().items():
                total[sym] += n
            keeps_ema = state.ema is not None
            del state
            gc.collect()
            torch.cuda.empty_cache()
            tag = f"demo {demo} {label}"
            check(len(rec["steps"]) == DEMO_STEPS, f"{tag}: {len(rec['steps'])} steps")
            for i, (grew, _, loss) in enumerate(rec["steps"]):
                check(grew == want_step, f"{tag} step {i + 1}: launches {grew}, expected {want_step}")
                check(np.isfinite(loss), f"{tag} step {i + 1}: loss {loss}")
            check(len(rec["vals"]) == 1, f"{tag}: {len(rec['vals'])} validations")
            ((grew, vm),) = rec["vals"]
            check(grew == want_val and np.isfinite(vm["psnr"]), f"{tag} validation: {grew}, psnr {vm['psnr']}")
            check(len(inits) == 1 + ("compressor" in changes), f"{tag}: {len(inits)} fresh nets")
            line = {"seconds": seconds, "losses": [r[2] for r in rec["steps"]], "val_psnr": vm["psnr"],
                    "launches_per_step": want_step, "launches_per_validation": want_val, "ema": keeps_ema,
                    "init": inits}
            if "compressor" in changes:
                s1_models, s1_iter = done[changes["compressor"]]
                spelled = opt["path"]["pretrain_model_L"]
                saved = torch.load(os.path.join(s1_models, f"{s1_iter}_G.pth"), map_location="cpu",
                                   weights_only=True)
                ((name, got),) = loaded
                check(name == spelled and not os.path.exists(spelled) and sorted(got) == sorted(saved)
                      and all(torch.equal(got[k], v) for k, v in saved.items()),
                      f"{tag}: the compressor loaded from {name} is not stage 1's {s1_iter}_G.pth")
                line["compressor"] = f"{os.path.basename(spelled)} -> {s1_iter}_G.pth, bit-equal"
            print(f"[demo] {demo} {label}: {DEMO_STEPS} steps of batch {opt['datasets']['train']['batch_size']} at "
                  f"{opt['datasets']['train']['GT_size']} px in {seconds:.1f} s, losses "
                  f"{[round(x, 6) for x in line['losses']]}, launches per step {want_step}; validation at "
                  f"{val_steps(opt)} sampler steps: PSNR {vm['psnr']:.4f}, launches {grew}"
                  + (f"; compressor {line['compressor']}" if "compressor" in line else "") + f"; card: {smi}")
            record[f"{demo}/{label}"] = line
            done[label] = (models, DEMO_STEPS)
            if (demo, label) == ("refusion", "stage2"):
                weights = os.path.join(models, "lastest_EMA.pth" if keeps_ema else f"{DEMO_STEPS}_G.pth")
                check(keeps_ema, f"{tag}: no EMA")
                test_opt = chip_learn.test_opt(opt, weights, os.path.join(base, "run"))
                test_yml = chip_learn.dump_yaml(test_opt, os.path.join(base, "test", "yml", f"{label}.yml"))
                result, per_image, run = run_test(test_yml, dev)
                for sym, n in run.items():
                    total[sym] += n
                want = eval_counts(test_opt, val_steps(opt))
                check_outputs(f"{tag} test", test_yml, result, per_image, want)
                (res,) = result.values()
                record[f"{demo}/{label}/test"] = eval_line(f"demo {demo} {label} test (lastest_EMA.pth)", res, want,
                                                           smi)
    return total, record


# ---------------------------------------------------------------- evaluation
# The test YAMLs (configs/<task>/test/<file>), each through the test entry
# point at its own full width (its sampling steps cut): per YAML its synthetic
# test set (a kind of EVAL data, the images, their (H, W): near the public
# set's, or a range for bokeh and stereo), and the train path of phase 21
# whose last checkpoint it loads where phase 21 trained its network (the
# same class and setting), else None: a seeded .pth the phase writes.
# Cuts, each to the time budget: one image a set; GoPro's 720x1280
# kept, the shadow set's 1440x1920 cut to 720x960, bokeh's to 512-768 px,
# Flickr1024's pairs to 256-384 px HR; the samplers that run the YAML's
# sample_T (or T) steps cut to EVAL_SAMPLE_T (the Gaussian denoising YAMLs
# keep their optimal timestep's ODE steps, DENOISE_STEPS); 15 steps pay,
# with TRAIN_VAL_SAMPLE_T's, for the tensor-parallel phases
EVAL_SAMPLE_T = 15
EVAL_PATHS = {
    ("deblurring", "ir-sde.yml"): ("pairs", 1, (720, 1280), "ir-sde"),
    ("deblurring", "refusion.yml"): ("pairs", 1, (720, 1280), "refusion"),
    ("denoising", "ir-sde.yml"): ("gt", 1, (500, 500), None),
    ("denoising", "refusion.yml"): ("gt", 1, (500, 500), None),
    ("deraining", "ir-sde.yml"): ("pairs", 1, (321, 481), "ir-sde"),
    ("deraining", "refusion.yml"): ("pairs", 1, (321, 481), "refusion"),
    ("deshadow", "ir-sde.yml"): ("pairs", 1, (720, 960), None),
    ("deshadow", "refusion.yml"): ("pairs", 1, (720, 960), "refusion"),
    ("inpainting", "ir-sde.yml"): ("gt", 1, (256, 256), "ir-sde"),
    ("inpainting", "refusion.yml"): ("gt", 1, (256, 256), "refusion"),
    ("latent-bokeh", "refusion.yml"): ("bokeh", 1, (512, 768), "bokeh"),
    ("latent-dehazing", "nasde.yml"): ("pairs", 1, (500, 700), "latent"),
    ("sisr", "ir-sde.yml"): ("sr", 1, (228, 344), "ir-sde"),
    ("sisr", "refusion.yml"): ("sr", 1, (228, 344), "refusion"),
    ("stereo-sr", "refusion.yml"): ("stereo", 1, (256, 384), "stereo"),
    ("unet-latent", "test_latent.yml"): ("pairs", 1, (500, 700), "compressor"),
}
# the Gaussian denoising nets' reverse ODE steps: get_optimal_timestep of
# sigma on the cosine T 1000, max_sigma 70 schedule (the JAX package's
# integers, tests/test_torch_denoising.py)
DENOISE_STEPS = {50: DENOISE_T0, 8: 100, 5: 71}
# the Gaussian denoising test YAMLs' noise cut to sigma 5 (71 ODE steps;
# ir-sde.yml's 50 takes 414, and a capture of them ~9 s more), to the time
# limit: the main path and the denoising artifact run 414; the inference
# entry point's sigma (100 steps)
EVAL_DENOISE_SIGMA = 5
INFERENCE_SIGMA = 8
# TLSC (CNAFNetLocal: deraining/test/refusion.yml's net with windows of a
# 256 px train crop, 1.5 x 256 / 8 = 48 at the 28-block level): a 224x240
# set, whose padded 224x240 map (28x30 at that level) the window covers, so
# K3 fuses the level; and a 321x481 set (padded 336x496: 42x62), where it
# does not, and the 28 blocks run one by one on the windowed mean (2 K1
# each)
TLSC_TRAIN, TLSC_SETS = 256, {"covered": (224, 240), "windowed": (321, 481)}
# the tiled run: deraining/test/ir-sde.yml by tiles of 256 px, overlap 32,
# 4 a sampler call, on the card (tile_device)
EVAL_TILE = (256, 32, 4)
# the kernel path against the plain path: Gaussian denoising with its LQ
# given (GT + noise of EVAL_PLAIN_SIGMA: the reverse ODE, deterministic),
# TF32 off (with TF32 on, a float32 difference in a conv's input can flip
# its TF32 rounding), the saved PNGs within EVAL_PLAIN_LEVELS of 255; a
# small image: the plain K2's softmax over the tokens takes 90 s for 414
# steps at 256x320; sigma 5 (71 ODE steps; 50, the YAML's, takes 414), a
# cut that pays for the native, tools, NAFNet tensor-parallel and captured
# train phases
EVAL_PLAIN_HW, EVAL_PLAIN_LEVELS, EVAL_PLAIN_SIGMA = (60, 90), 1, 5
# LPIPS and FID on the card against the same modules on the CPU (TF32 off):
# LPIPS within 1e-4 of each distance, pool3 features within 1e-4 of max|f|
LPIPS_FID_IMAGES, LPIPS_FID_BOUND = 3, 1e-4


def eval_yaml(parts):
    """configs/<task>/test/<file>, its sampler cut to EVAL_SAMPLE_T steps
    where it runs sample_T (or T) of them, a Gaussian denoising YAML's noise
    to EVAL_DENOISE_SIGMA."""
    opt = load_yaml(os.path.join(REPO, "configs", parts[0], "test", parts[1]))
    if opt.get("sde") and opt.get("distortion") != "denoising":
        opt["sde"]["sample_T"] = min(EVAL_SAMPLE_T, int(opt["sde"].get("sample_T") or opt["sde"]["T"]))
    if opt.get("distortion") == "denoising":
        opt["degradation"]["sigma"] = min(EVAL_DENOISE_SIGMA, opt["degradation"]["sigma"])
    return opt


def eval_steps(opt):
    """Reverse steps a test YAML's sampler runs on one image."""
    if opt["distortion"] == "denoising":
        return DENOISE_STEPS[int(opt["degradation"]["sigma"])]
    return int(opt["sde"].get("sample_T") or opt["sde"]["T"])


def eval_counts(opt, steps):
    """Launches per image of a test YAML's task: its net's per forward times
    ``steps``; a latent task's compressor encodes and decodes once (the
    compressor task: two encodes and a decode, no SDE).  The UNet of depth
    d launches 2 K1 and one K2 at each of its 2d + 1 linear attentions (the
    unconditional net's middle one is full attention: one K1)."""
    model, setting = opt["model"], opt["network_G"]["setting"]
    which = opt["network_G"].get("which_model_G") or opt["network_G"].get("which_model")
    enc_ln, enc_attn = COMPRESSOR_LN // 2, COMPRESSOR_ATTN // 2
    if model == "latent":
        return counts(LAYERNORM=3 * enc_ln, LA_CTX=3 * enc_attn, LA_APPLY=3 * enc_attn)
    if model == "latent_denoising":
        bokeh = opt["distortion"] == "bokeh"
        ln = BOKEH_LN_PER_FORWARD if bokeh else NAF_LN_PER_FORWARD
        return counts(LAYERNORM=steps * ln + COMPRESSOR_LN, LA_CTX=COMPRESSOR_ATTN, LA_APPLY=COMPRESSOR_ATTN,
                      NAF_STACK=0 if bokeh else steps)
    if which == "ConditionalUNet":
        sites = 2 * int(setting["depth"]) + 1 - (opt["distortion"] == "denoising")
        ln = 2 * sites + (opt["distortion"] == "denoising")
        return counts(LAYERNORM=steps * ln, LA_CTX=steps * sites, LA_APPLY=steps * sites)
    if opt["datasets"]["test1"]["mode"].startswith("Ste"):
        return counts(LAYERNORM=steps * STEREO_LN_PER_FORWARD)
    return counts(LAYERNORM=steps * NAF_LN_PER_FORWARD, NAF_STACK=steps)


def scaled(want, n):
    return {k: n * v for k, v in want.items()}


def write_eval_data(path, kind, n, hw, seed):
    """A synthetic test set of ``kind`` under ``path``; returns its dataset
    keys."""
    from image_restoration_sde_tpu_torch.data.synthetic import write_bokeh, write_pairs, write_stereo

    if kind == "bokeh":
        write_bokeh(path, n, seed, *hw)
        return dict(dataroot_LQ=f"{path}/src", dataroot_alpha=f"{path}/alpha", dataroot_meta=f"{path}/meta.txt")
    if kind == "stereo":
        write_stereo(path, n, seed, *hw)
        return dict(dataroot_GT=f"{path}/HR", dataroot_LQ=f"{path}/LR_x4")
    write_pairs(path, n, seed, shape=hw)
    if kind == "pairs":
        return dict(dataroot_GT=f"{path}/GT", dataroot_LQ=f"{path}/LQ")
    return dict(dataroot_GT=f"{path}/GT", dataroot_LQ=None)  # gt; sr: the dataset downscales x4


def seeded_pth(path, opt):
    """A test YAML's net (and a latent task's compressor) with ``init_params_``
    weights from the seed (the score nets' NAFBlock beta and gamma random,
    not torch's zeros), saved as ``.pth`` files; returns their paths."""
    import copy

    import torch

    from image_restoration_sde_tpu_torch import runners
    from image_restoration_sde_tpu_torch.models import init_params_
    from image_restoration_sde_tpu_torch.utils import options

    opt = options.dict_to_nonedict(copy.deepcopy(opt))
    opt["path"]["pretrain_model_G"] = opt["path"]["pretrain_model_L"] = None
    task = runners.build_task(opt, SEED, "cpu")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    nets = {"G": task.net, "L": getattr(task, "compressor", None)}
    paths = {}
    for label, net in nets.items():
        if net is not None:
            init_params_(net, torch.Generator().manual_seed(SEED + len(paths)))
            paths[label] = f"{path}_{label}.pth"
            torch.save(net.state_dict(), paths[label])
    return paths


def bokeh_train_compressor(path):
    """The compressor phase 21's bokeh run froze: its task's seeded one
    (the train YAML's seed + 1, ``runners``), saved as a ``.pth``."""
    import torch

    from image_restoration_sde_tpu_torch import runners
    from image_restoration_sde_tpu_torch.utils import options

    opt = load_yaml(os.path.join(REPO, "configs", *TRAIN_PATHS["bokeh"][0]))
    which, setting = options.network_setting(opt, "network_L")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(runners._seeded_network(which, setting, int(opt["train"]["manual_seed"]) + 1).state_dict(), path)
    return path


def eval_weights(root, opt, label, trained):
    """``(pretrain_model_G, pretrain_model_L)`` of a test YAML: phase 21's
    last checkpoints where it trained the network (a latent task's frozen
    compressor: the compressor path's, or the bokeh run's seeded one), else
    seeded weights."""
    if label == "latent" and label in trained:
        return trained["latent"], trained["compressor"]
    if label == "bokeh" and label in trained:
        return trained["bokeh"], bokeh_train_compressor(os.path.join(root, "bokeh_L.pth"))
    return trained_or_seeded(root, opt, label, trained)


def trained_or_seeded(root, opt, label, trained):
    """Phase 21's last checkpoint of the train path ``label``, else seeded
    weights (``seeded_pth``)."""
    if label in trained:
        return trained[label], None
    paths = seeded_pth(os.path.join(root, "seeded"), opt)
    return paths["G"], paths.get("L")


def write_eval_yaml(root, parts, opt, sets, weights, name=None, **top):
    """The test YAML ``opt`` with its test sets on ``sets`` (set name ->
    dataset keys, each set otherwise the YAML's first), its weights
    (``pretrain_model_G``, ``pretrain_model_L``), results under ``root``
    and the ``top`` keys, written to ``root/<task>/test/<file>`` (the task
    is the YAML's grandparent directory)."""
    import copy

    import yaml

    opt = copy.deepcopy(opt)
    base = opt["datasets"]["test1"]
    opt["datasets"] = {f"test{i + 1}": {**base, "name": set_name, **keys}
                       for i, (set_name, keys) in enumerate(sets.items())}
    opt["name"] = name or opt["name"]
    opt["path"] = {"root": root, "pretrain_model_G": weights[0], "pretrain_model_L": weights[1], "strict_load": True}
    opt.update(top)
    path = os.path.join(root, parts[0], "test", parts[1])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(opt, f)
    return path


def test_set(opt, data):
    """The YAML's one test set, by its name, on ``data``."""
    return {opt["datasets"]["test1"]["name"]: data}


@contextlib.contextmanager
def recorded_images():
    """Launches by kernel symbol of each image the test entry point restores
    inside the block (wrapping its ``restore``)."""
    from image_restoration_sde_tpu_torch import test as test_entry
    from image_restoration_sde_tpu_torch.ops import KERNELS

    rec, original = [], test_entry.restore

    def restore(*args):
        before = request_counts()
        out = original(*args)
        rec.append({sym: n - before[sym] for sym, n in request_counts().items()})
        return out

    test_entry.restore = restore
    try:
        yield rec
    finally:
        test_entry.restore = original


def run_test(yml, dev, *flags):
    """``python -m image_restoration_sde_tpu_torch.test -opt=<yml>`` (its
    ``evaluate``, in this process), every launch count set to 0 just
    before and read just after; prints its seconds and those of them spent
    restoring (the rest: building the task, loading weights, data, PNGs,
    metrics); returns its result by set, each image's launches and the
    run's."""
    import gc

    import torch

    from image_restoration_sde_tpu_torch import test as test_entry
    from image_restoration_sde_tpu_torch.ops import KERNELS

    lpips_pth, fid_pth = (flags + (None, None))[:2]
    reset_counts()
    t0 = time.perf_counter()
    with recorded_images() as rec:
        result = test_entry.evaluate(yml, dev, lpips_pth, fid_pth)
    seconds = time.perf_counter() - t0
    restoring = sum(r["seconds"] for res in result.values() for r in res["images"])
    print(f"[test-entry] {os.path.relpath(yml, os.path.dirname(os.path.dirname(os.path.dirname(yml))))}: "
          f"{seconds:.1f} s in the entry point, {restoring:.1f} s of it restoring")
    run = request_counts()
    check(run == {k.symbol: sum(r[k.symbol] for r in rec) for k in KERNELS}, f"{yml}: launches outside the images")
    gc.collect()
    torch.cuda.empty_cache()
    return result, rec, run


def check_outputs(tag, yml, result, rec, want, stereo=False):
    """Per image exactly ``want`` launches (a dict, or a list by set), the
    output, LQ and GT PNGs (one per eye of a pair) and, with a GT, finite
    metrics."""
    from image_restoration_sde_tpu_torch.utils import options

    opt = options.parse(yml, is_train=False)
    wants = want if isinstance(want, list) else [want] * len(result)
    per_image = [w for w, res in zip(wants, result.values()) for _ in res["images"]]
    check(rec == per_image, f"{tag}: launches per image {rec}, expected {per_image}")
    for name, res in result.items():
        files = os.listdir(os.path.join(opt["path"]["results_root"], name))
        for r in res["images"]:
            kinds = ("", "_LQ", "_GT") if "psnr" in r else ("", "_LQ")
            names = {f"{r['name']}{k}{eye}.png" for k in kinds for eye in (("_L", "_R") if stereo else ("",))}
            check(names <= set(files), f"{tag}: {sorted(names - set(files))} not written")
            check("psnr" not in r or all(np.isfinite(r[k]) for k in ("psnr", "ssim", "psnr_y", "ssim_y")),
                  f"{tag}: metrics {r}")


def eval_line(tag, res, per_image, smi):
    secs = [r["seconds"] for r in res["images"]]
    scores = "" if "psnr" not in res else (f"; PSNR {res['psnr']:.4f} SSIM {res['ssim']:.4f} PSNR-Y "
                                           f"{res['psnr_y']:.4f} SSIM-Y {res['ssim_y']:.4f}")
    print(f"[eval] {tag}: {len(secs)} image(s), s/image {[round(s, 3) for s in secs]}, peak memory "
          f"{res['peak_memory_bytes'] / 2**30:.3f} GiB above the {res['held_memory_bytes'] / 2**30:.3f} GiB "
          f"held before the set, launches per image "
          f"{ {k: v for k, v in per_image.items() if v} }{scores}; card: {smi}")
    return {"seconds": secs, "peak_memory_gib": res["peak_memory_bytes"] / 2**30,
            "held_memory_gib": res["held_memory_bytes"] / 2**30, "launches_per_image": per_image,
            **{k: res.get(k) for k in ("psnr", "ssim", "psnr_y", "ssim_y", "lpips", "fid")}}


def phase_eval(dev, workdir, smi, trained, stats, children):
    """Every test YAML through the test entry point (``test.evaluate``, what
    ``python -m image_restoration_sde_tpu_torch.test -opt=<yml>`` runs), at
    torch's default TF32 settings (cuDNN TF32 on), as a user's run gets
    them: EVAL_PATHS' test sets and weights, exactly ``eval_counts``
    launches per image, the PNGs and finite metrics; then the TLSC run, the
    tiled run, an inference run (``--sigma`` INFERENCE_SIGMA), the restore CLI in its own
    process, an LPIPS and FID run (seeded weights, held against the CPU),
    and Gaussian denoising's kernel path against its plain path.  Every K1,
    K2 and K3 launch of these runs records its site (shape and dtype), and
    after them each kernel is held against its plain version at every
    distinct site (``hold_sites``, ``hold_naf_sites``: the float32 sites of
    the full-size images, 720x1280 included).  Returns the launches by path
    and a record of the times and peak memory."""
    import torch

    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # torch's default
    try:
        with recorded_sites() as (ln, attn), recorded_naf_sites() as naf:
            result = eval_main_path(dev, os.path.join(workdir, "eval"), smi, trained, children)
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    hold_sites("eval", dev, ln, attn, stats, {})
    hold_naf_sites("eval", dev, naf, stats)
    return result


def eval_main_path(dev, root, smi, trained, children):
    launches, record, restore = {}, {}, None
    for i, (parts, (kind, n, hw, label)) in enumerate(EVAL_PATHS.items()):
        key = "/".join(parts)
        opt = eval_yaml(parts)
        data = write_eval_data(os.path.join(root, "data", key.replace("/", "_")), kind, n, hw, SEED + 60 + i)
        top = {}
        if (opt.get("degradation") or {}).get("mask_root"):
            from image_restoration_sde_tpu_torch.data.synthetic import write_masks

            top["degradation"] = {**opt["degradation"], "mask_root": write_masks(os.path.join(root, "masks"), 8,
                                                                                  SEED + 59, max(hw))}
        weights = eval_weights(os.path.join(root, key.replace("/", "_")), opt, label, trained)
        yml = write_eval_yaml(root, parts, opt, test_set(opt, data), weights, **top)
        per_image = eval_counts(opt, eval_steps(opt))
        result, rec, launches[f"test_{key}"] = run_test(yml, dev)
        check_outputs(key, yml, result, rec, per_image, stereo=kind == "stereo")
        (res,) = result.values()
        record[key] = eval_line(key, res, per_image, smi)
        if parts == ("deraining", "ir-sde.yml"):
            restore = start_restore_cli(root, children)
    launches["test_tlsc"], record["tlsc"] = eval_tlsc(dev, root, smi, trained)
    launches["test_tiled"], record["tiled"] = eval_tiled(dev, root, smi, trained)
    launches["inference"], record["inference"] = eval_inference(dev, root, smi)
    record["restore_cli"] = eval_restore_cli(restore)
    launches["test_lpips_fid"], record["lpips_fid"] = eval_lpips_fid(dev, root, smi, trained)
    launches["test_plain"], record["plain"] = eval_plain(dev, root, smi)
    return launches, record


def eval_tlsc(dev, root, smi, trained):
    """CNAFNetLocal on deraining/test/refusion.yml's net (TLSC_TRAIN px
    train crop) over the two TLSC_SETS: per step one K3 launch where the
    28-block level's window covers its map, none where it does not (there
    the level's 28 blocks launch 2 K1 each)."""
    parts = ("deraining", "refusion.yml")
    opt = eval_yaml(parts)
    opt["network_G"] = {"which_model_G": "CNAFNetLocal",
                        "setting": {**opt["network_G"]["setting"], "train_size": [1, 3, TLSC_TRAIN, TLSC_TRAIN]}}
    root = os.path.join(root, "tlsc")
    sets = {name: write_eval_data(os.path.join(root, "data", name), "pairs", 1, hw, SEED + 80 + i)
            for i, (name, hw) in enumerate(TLSC_SETS.items())}
    yml = write_eval_yaml(root, parts, opt, sets, trained_or_seeded(root, opt, "refusion", trained), name="tlsc")
    steps, window = eval_steps(opt), TLSC_TRAIN * 3 // 2 // 8  # the window at the 28-block level (1/8 scale)
    wants = []
    for hw in TLSC_SETS.values():
        covered = all(window >= -(-side // 16) * 16 // 8 for side in hw)  # the map: padded to 16, at 1/8
        check(covered == (hw == TLSC_SETS["covered"]), f"tlsc: {hw} covered: {covered}")
        wants.append(counts(LAYERNORM=steps * (NAF_LN_PER_FORWARD + (0 if covered else 2 * 28)),
                            NAF_STACK=steps if covered else 0))
    result, rec, run = run_test(yml, dev)
    check_outputs("tlsc", yml, result, rec, wants)
    return run, {name: eval_line(f"tlsc {name} {TLSC_SETS[name]}", res, want, smi)
                   for (name, res), want in zip(result.items(), wants)}


def eval_tiled(dev, root, smi, trained):
    """deraining/test/ir-sde.yml with ``tile``, ``tile_overlap``,
    ``tile_batch`` (EVAL_TILE) and ``tile_device``: per image the sampler
    runs once a chunk of tiles."""
    from image_restoration_sde_tpu_torch.tiling import tile_grid

    parts, hw = ("deraining", "ir-sde.yml"), (321, 481)
    opt = eval_yaml(parts)
    root = os.path.join(root, "tiled")
    data = write_eval_data(os.path.join(root, "data"), "pairs", 1, hw, SEED + 85)
    tile, overlap, tile_batch = EVAL_TILE
    yml = write_eval_yaml(root, parts, opt, test_set(opt, data), trained_or_seeded(root, opt, "ir-sde", trained),
                          name="tiled", tile=tile, tile_overlap=overlap, tile_batch=tile_batch, tile_device=True)
    tiles = len(tile_grid(hw[0], min(tile, hw[0]), overlap)) * len(tile_grid(hw[1], min(tile, hw[1]), overlap))
    want = scaled(eval_counts(opt, eval_steps(opt)), -(-tiles // tile_batch))
    result, rec, run = run_test(yml, dev)
    check_outputs("tiled", yml, result, rec, want)
    (res,) = result.values()
    return run, eval_line(f"tiled {hw}, {tiles} tiles of {tile} px, {tile_batch} a call", res, want, smi)


def eval_inference(dev, root, smi):
    """``python -m image_restoration_sde_tpu_torch.inference`` (its
    ``infer``) on denoising/test/ir-sde.yml with ``--sigma`` INFERENCE_SIGMA:
    GT plus noise of that sigma, the reverse ODE from its optimal timestep; one PNG
    and exactly those steps' launches an image."""
    import copy

    from image_restoration_sde_tpu_torch import inference
    from image_restoration_sde_tpu_torch.ops import KERNELS

    parts, sigma, n = ("denoising", "ir-sde.yml"), INFERENCE_SIGMA, 1  # one image: a depth cut to the time limit
    opt = eval_yaml(parts)
    root = os.path.join(root, "inference")
    data = write_eval_data(os.path.join(root, "data"), "gt", n, (500, 500), SEED + 86)
    yml = write_eval_yaml(root, parts, opt, test_set(opt, data), trained_or_seeded(root, opt, None, {}),
                          name="inference")
    with_sigma = copy.deepcopy(opt)
    with_sigma["degradation"]["sigma"] = sigma
    want = scaled(eval_counts(with_sigma, eval_steps(with_sigma)), n)
    reset_counts()
    (times,) = inference.infer(yml, dev, sigma).values()
    grew = request_counts()
    out_dir = os.path.join(root, "results", parts[0], "inference", opt["datasets"]["test1"]["name"])
    check(grew == want and len(times) == n and len(os.listdir(out_dir)) == n,
          f"inference: launches {grew}, expected {want}; {os.listdir(out_dir)}")
    print(f"[eval] inference --sigma {sigma}: {n} images of 500x500, {eval_steps(with_sigma)} steps, s/image "
          f"{[round(t, 3) for t in times]}; launches {grew}; card: {smi}")
    return grew, {"seconds": times, "steps": eval_steps(with_sigma)}


def start_restore_cli(root, children):
    """``python -m image_restoration_sde_tpu_torch.restore`` in its own
    process, by tiles, on the deraining sweep's YAML and LQ image, started
    as soon as they are written: its start (imports, the net, the weights)
    overlaps the sweep."""
    yml = os.path.join(root, "deraining", "test", "ir-sde.yml")
    src = sorted(os.listdir(os.path.join(root, "data", "deraining_ir-sde.yml", "LQ")))[0]
    src = os.path.join(root, "data", "deraining_ir-sde.yml", "LQ", src)
    dst = os.path.join(root, "restored.png")
    argv = [sys.executable, "-m", "image_restoration_sde_tpu_torch.restore", f"-opt={yml}", "-i", src, "-o", dst,
            "--tile", "256", "--tile-overlap", "32"]
    return Background("restore CLI", argv, children, timeout=600), src, dst


def eval_restore_cli(started):
    """Join the restore CLI: exit 0 and an output of the input's size."""
    from image_restoration_sde_tpu_torch.data.io_utils import read_img_uint8

    child, src, dst = started
    said = [line for line in child.join().splitlines() if line.startswith("restored ")]
    check(len(said) == 1 and read_img_uint8(dst).shape == read_img_uint8(src).shape, f"restore CLI: {said}")
    print(f"[eval] restore CLI (tiles of 256 px): {said[0]}")
    return {"stdout": said[0]}


def eval_lpips_fid(dev, root, smi, trained):
    """The compressor's test YAML with ``--lpips-pth`` (alex) and
    ``--fid-pth``, seeded weights of both: a finite LPIPS per image and FID
    per set; then on the set's output and GT PNGs, TF32 off, the card's
    LPIPS distances and pool3 features against the same modules on the CPU
    (LPIPS_FID_BOUND), and their milliseconds per image on the card."""
    import torch

    from image_restoration_sde_tpu_torch.data.io_utils import read_img_uint8
    from image_restoration_sde_tpu_torch.utils import fid, lpips

    parts, n, hw = ("unet-latent", "test_latent.yml"), LPIPS_FID_IMAGES, (321, 481)
    opt = eval_yaml(parts)
    root = os.path.join(root, "lpips_fid")
    data = write_eval_data(os.path.join(root, "data"), "pairs", n, hw, SEED + 87)
    lpips_pth, fid_pth = os.path.join(root, "lpips_alex.pth"), os.path.join(root, "fid_inception.pth")
    torch.save(lpips.seeded_state_dict("alex", SEED), lpips_pth)
    torch.save(fid.seeded_state_dict(SEED), fid_pth)
    yml = write_eval_yaml(root, parts, opt, test_set(opt, data), trained_or_seeded(root, opt, "compressor", trained),
                          name="lpips_fid")
    result, rec, run = run_test(yml, dev, lpips_pth, fid_pth)
    want = eval_counts(opt, 0)
    check_outputs("lpips_fid", yml, result, rec, want)
    ((name, res),) = result.items()
    check(all(np.isfinite(r["lpips"]) for r in res["images"]) and np.isfinite(res["fid"]), f"lpips/fid: {res}")

    out_dir = os.path.join(root, "results", parts[0], "lpips_fid", name)
    pairs = [(read_img_uint8(os.path.join(out_dir, f"{r['name']}.png")),
              read_img_uint8(os.path.join(out_dir, f"{r['name']}_GT.png"))) for r in res["images"]]
    lp_card, lp_cpu = lpips.make_lpips_fn(lpips_pth, dev), lpips.make_lpips_fn(lpips_pth, "cpu")
    nets = {d: fid.load_inception(fid_pth, d) for d in (dev, "cpu")}
    imgs = [torch.from_numpy(o)[None].float() / 255.0 for o, _ in pairs]
    lp_card(*pairs[0])  # warm up at the default TF32 settings, then time
    fid.inception_pool3_features(nets[dev], [im.to(dev) for im in imgs])
    t0 = time.perf_counter()
    for o, g in pairs:
        lp_card(o, g)  # returns a float: synchronised
    lpips_ms = (time.perf_counter() - t0) * 1e3 / len(pairs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fid.inception_pool3_features(nets[dev], [im.to(dev) for im in imgs]).cpu()
    fid_ms = (time.perf_counter() - t0) * 1e3 / len(imgs)
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        lp_err = max(abs(lp_card(o, g) - lp_cpu(o, g)) / abs(lp_cpu(o, g)) for o, g in pairs)
        f_card = fid.inception_pool3_features(nets[dev], [im.to(dev) for im in imgs]).cpu()
        f_cpu = fid.inception_pool3_features(nets["cpu"], imgs)
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    f_err = ((f_card - f_cpu).abs().max() / f_cpu.abs().max()).item()
    print(f"[eval] lpips/fid: {n} images of {hw[0]}x{hw[1]}: LPIPS (alex, seeded) {res['lpips']:.6f}, FID (seeded) "
          f"{res['fid']:.6f}; card against CPU (TF32 off): LPIPS rel {lp_err:.3g}, pool3 features "
          f"{f_err:.3g} of max (bound {LPIPS_FID_BOUND}); LPIPS {lpips_ms:.3f} ms/image, InceptionV3 features "
          f"{fid_ms:.3f} ms/image (batch of {len(imgs)}, resize included); card: {smi}")
    check(lp_err <= LPIPS_FID_BOUND and f_err <= LPIPS_FID_BOUND, f"lpips/fid: card against CPU {lp_err}, {f_err}")
    return run, {**eval_line("lpips/fid", res, want, smi), "lpips_ms_per_image": lpips_ms,
                    "fid_features_ms_per_image": fid_ms, "lpips_card_vs_cpu_rel": lp_err,
                    "fid_features_card_vs_cpu": f_err}


def eval_plain(dev, root, smi):
    """denoising/test/ir-sde.yml with its noisy LQ given (GT plus noise of
    EVAL_PLAIN_SIGMA, an LQGT set): the reverse ODE, deterministic, through the
    kernel path and the plain path (``plain: true``) of the same seeded
    net, TF32 off: the output PNGs within EVAL_PLAIN_LEVELS of 255; no
    launch on the plain path."""
    import torch

    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return eval_plain_paths(dev, root, smi)
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32


def eval_plain_paths(dev, root, smi):
    import copy

    from image_restoration_sde_tpu_torch.data.io_utils import read_img_uint8, save_img

    parts = ("denoising", "ir-sde.yml")
    opt = eval_yaml(parts)
    opt["degradation"]["sigma"] = EVAL_PLAIN_SIGMA
    root = os.path.join(root, "plain")
    data = write_eval_data(os.path.join(root, "data"), "gt", 1, EVAL_PLAIN_HW, SEED + 88)
    noise = np.random.default_rng(SEED + 89)
    for f in sorted(os.listdir(data["dataroot_GT"])):
        gt = read_img_uint8(os.path.join(data["dataroot_GT"], f)).astype(np.float64)
        lq = gt + noise.normal(0, opt["degradation"]["sigma"], gt.shape)
        save_img(np.clip(np.round(lq), 0, 255).astype(np.uint8), os.path.join(root, "data", "LQ", f))
    data.update(dataroot_LQ=os.path.join(root, "data", "LQ"))
    weights = trained_or_seeded(root, opt, None, {})
    opt["datasets"]["test1"]["mode"] = "LQGT"
    plain = copy.deepcopy(opt)
    plain["network_G"]["setting"]["plain"] = True
    want = eval_counts(opt, eval_steps(opt))
    outs, secs, runs = {}, {}, {}
    for label, o in (("kernel", opt), ("plain", plain)):
        yml = write_eval_yaml(os.path.join(root, label), parts, o, test_set(o, data), weights, name=label)
        result, rec, runs[label] = run_test(yml, dev)
        check_outputs(f"plain {label}", yml, result, rec, want if label == "kernel" else counts())
        (res,) = result.values()
        out_dir = os.path.join(root, label, "results", parts[0], label, o["datasets"]["test1"]["name"])
        outs[label] = [read_img_uint8(os.path.join(out_dir, f"{r['name']}.png")).astype(int) for r in res["images"]]
        secs[label] = [r["seconds"] for r in res["images"]]
    diff = max(np.abs(a - b).max() for a, b in zip(outs["kernel"], outs["plain"]))
    share = np.mean([(a != b).mean() for a, b in zip(outs["kernel"], outs["plain"])])
    print(f"[eval] kernel path against plain path, {parts[0]}/{parts[1]} with its LQ given ({EVAL_PLAIN_HW}, "
          f"{eval_steps(opt)} ODE steps, TF32 off): output PNGs max |d| {diff} level(s) (bound {EVAL_PLAIN_LEVELS}), "
          f"{share:.3g} of the values differ; s/image kernel {secs['kernel']}, plain {secs['plain']}; card: {smi}")
    check(diff <= EVAL_PLAIN_LEVELS, f"plain: kernel path against plain path {diff} levels")
    return runs["kernel"], {"max_levels": int(diff), "share_differing": float(share), "seconds": secs}


# ---------------------------------------------------------------- serving
def phase_ops(dev):
    """``torch.library.opcheck`` on CUDA tensors for each ``irsde::``
    operator at one site of a path that launches it (its schema, autograd
    registration, fake implementation against the kernel's output, and the
    dynamic-shape autograd trace against eager): K1 at the deraining UNet's
    128 px level, K2 at its 128 px attention, K3 at the latent path's
    28-block level (the dynamic-shape test at OPCHECK_NAF_DYNAMIC_K blocks
    of it), K4 at a DiT-L/2 site, K5 at the deraining UNet's first level.
    It runs in a process of its own (``ops_child``) beside the phases after
    phase 3: its traces are host work, and it launches little."""
    import torch

    from image_restoration_sde_tpu_torch.ops import flash_attention as FA
    from image_restoration_sde_tpu_torch.ops import layernorm as LN
    from image_restoration_sde_tpu_torch.ops import linear_attention as LA
    from image_restoration_sde_tpu_torch.ops import naf_stack as NS

    gen = rng_generator(dev, SEED + 90)

    def leaf(*shape, scale=1.0, dtype=torch.bfloat16):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(dtype).requires_grad_()

    C = LATENT_NAF_LEVEL[1]
    x, blocks, tmod, _ = naf_stack_inputs((LATENT_BATCH, *LATENT_NAF_LEVEL[2:], C), LATENT_NAF_LEVEL[0], dev, gen)
    tensors = [blk[k].requires_grad_() for blk in blocks for k in NS.PARAM_ORDER]
    naf = (x.bfloat16().requires_grad_(), tmod.requires_grad_(), 1e-3, tensors)
    k = OPCHECK_NAF_DYNAMIC_K
    naf_small = (naf[0], tmod[:k].detach().requires_grad_(), 1e-3, tensors[: k * len(NS.PARAM_ORDER)])
    B, N, H, D = FLASH_SHAPES[0]
    sites = [  # the K3 dynamic-shape trace, host work alone, last
        ("K1", LN.OP, (leaf(BATCH, SIZE, SIZE, 64, scale=2.0), leaf(64, dtype=torch.float32), 1e-3), None),
        ("K2", LA.PACKED_OP, (leaf(BATCH, SIZE * SIZE, 384), 4, 32), None),
        ("K3", NS.OP, naf, ("test_schema", "test_autograd_registration", "test_faketensor")),
        ("K4", FA.OP, (leaf(B, N, H, D), leaf(B, N, H, D), leaf(B, N, H, D), D**-0.5), None),
        ("K5", LA.HEADS_OP, tuple(leaf(*LIN_ATTN_SHAPES[0]) for _ in range(3)), None),
        ("K3", NS.OP, naf_small, ("test_aot_dispatch_dynamic",)),
    ]
    for name, op, args, tests in sites:
        t0 = time.perf_counter()
        kw = {} if tests is None else {"test_utils": tests}
        result = torch.library.opcheck(op, args, **kw)
        torch.cuda.synchronize()
        shapes = [tuple(a.shape) if hasattr(a, "shape") else (f"{len(a)} tensors" if isinstance(a, list) else a)
                  for a in args]
        check(all(v == "SUCCESS" for v in result.values()), f"opcheck {name}: {result}")
        print(f"[ops] {name} {op}: {shapes}: {', '.join(result)} SUCCESS ({time.perf_counter() - t0:.1f} s)")


def ops_child() -> int:
    """``chip_smoke.py --ops-child``: ``phase_ops`` in a process of its own,
    TF32 off as in the script."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, REPO)
    t0 = time.perf_counter()
    phase_ops(torch.device("cuda", 0))
    print(f"[ops] every operator in {time.perf_counter() - t0:.1f} s")
    return 0


def export_to(workdir, name, export, **kw):
    """Export one artifact to ``workdir``; prints its seconds, bytes and
    header; returns (path, header, record)."""
    from image_restoration_sde_tpu_torch import exporting

    t0 = time.perf_counter()
    data = export(**kw)
    seconds = time.perf_counter() - t0
    path = os.path.join(workdir, f"{name}.irsdet")
    with open(path, "wb") as f:
        f.write(data)
    header = exporting.read_header(path)
    check(header["format"] == "torch.export" and header["program"] == "step" and header["kernels"],
          f"{name}: header {header}")
    shown = {k: header[k] for k in ("kind", "mode", "steps", "size", "batch", "seed", "n_params", "custom_ops")
             if k in header}
    print(f"[export] {name}: exported in {seconds:.1f} s, {len(data)} bytes; {json.dumps(shown)}")
    return path, header, {"export_s": seconds, "bytes": len(data)}


def export_job(workdir, name, path, want, runs):
    """An artifact for ``artifact_child``: each run (lq, seed, eager output)
    saved beside it; ``want`` the launches per call."""
    job = {"name": name, "path": path, "want": want, "runs": []}
    for i, (lq, seed, eager) in enumerate(runs):
        stem = os.path.join(workdir, f"{name}.{i}")
        np.save(stem + ".lq.npy", lq.cpu().numpy())
        np.save(stem + ".eager.npy", eager.cpu().numpy())
        job["runs"].append({"lq": stem + ".lq.npy", "seed": seed, "out": stem + ".out.npy",
                            "eager": stem + ".eager.npy"})
    return job


def phase_export_deraining(dev, net, sde_opt, workdir, stats):
    """The deraining sampler (posterior, bf16 compute on parameters cast to
    bf16, per-sample seeds) exported at a fixed batch of 8 and at a symbolic
    batch, with the eager sampler's outputs for the same lq and seeds.  The
    eager runs record the K1 and K2 sites of every batch the artifacts are
    called at (EXPORT_SYMBOLIC_BATCHES), and each kernel is held against
    its plain version there (``hold_sites``)."""
    import torch

    from image_restoration_sde_tpu_torch import exporting
    from image_restoration_sde_tpu_torch.sampling import make_restoration_sampler
    from image_restoration_sde_tpu_torch.sde import IRSDE, rng

    sde = IRSDE.create(sde_opt["max_sigma"], sde_opt["T"], sde_opt["schedule"], sde_opt["eps"], device=dev)
    kw = dict(sde=sde, net=net, size=(SIZE, SIZE), mode="posterior", cast_params=torch.bfloat16,
              per_sample_seed=True)
    eager = make_restoration_sampler(sde, net, mode="posterior", cast_params=torch.bfloat16, capture=False)
    gen = rng_generator(dev, SEED + 92)
    want = counts(LAYERNORM=LN_PER_FORWARD * sde.T, LA_CTX=ATTN_PER_FORWARD * sde.T, LA_APPLY=ATTN_PER_FORWARD * sde.T)
    jobs, record, sites = [], {}, ([], [])
    for name, batch, batches in (("deraining_b8", BATCH, (BATCH,)), ("deraining_sym", None, EXPORT_SYMBOLIC_BATCHES)):
        path, header, record[name] = export_to(workdir, name, exporting.export_restoration_sampler, batch=batch, **kw)
        check(header["batch"] == ("symbolic" if batch is None else batch) and header["seed"] == "per_sample",
              f"{name}: header batch {header['batch']}, seed {header['seed']}")
        runs = []
        for b in batches:
            lq = torch.rand(b, SIZE, SIZE, 3, generator=gen, device=dev)
            seeds = [SEED + 100 + 7 * i for i in range(b)]
            with recorded_sites() as (ln, attn):
                runs.append((lq, seeds, eager(lq, rng.generators_for_seeds(seeds, dev))))
            sites[0].extend(ln)
            sites[1].extend(attn)
        jobs.append(export_job(workdir, name, path, want, runs))
    # the symbolic artifact on DP_ARTIFACT_DEVICES at DP_ARTIFACT_BATCHES
    # (phase artifacts): the same runs, their own outputs
    dp_runs = [{**run, "out": run["out"][: -len(".out.npy")] + ".dp.out.npy"}
               for run, b in zip(jobs[-1]["runs"], EXPORT_SYMBOLIC_BATCHES) if b in DP_ARTIFACT_BATCHES]
    jobs.append({**jobs[-1], "name": "deraining_sym_dp", "devices": DP_ARTIFACT_DEVICES, "runs": dp_runs})
    hold_sites("export", dev, *sites, stats, {})
    return jobs, record


def phase_export_latent(dev, net, compressor, latent_opt, workdir):
    """The nasde latent sampler (the YAML's mode and steps, the score net's
    parameters cast to bf16, a scalar seed) exported at a fixed batch of 4,
    512 px, with the eager sampler's output for the same lq and seed."""
    import torch

    from image_restoration_sde_tpu_torch import exporting
    from image_restoration_sde_tpu_torch.sde import IRSDE, rng
    from image_restoration_sde_tpu_torch.training import make_latent_sampler

    sde_opt = latent_opt["sde"]
    sde = IRSDE.create(sde_opt["max_sigma"], sde_opt["T"], sde_opt["schedule"], sde_opt["eps"], device=dev)
    steps, mode = sde_opt["sample_T"], sde_opt["sampling_mode"]
    path, header, record = export_to(workdir, "nasde_b4", exporting.export_latent_sampler, sde=sde, net=net,
                                     compressor=compressor, size=(LATENT_SIZE, LATENT_SIZE), mode=mode, steps=steps,
                                     batch=LATENT_BATCH, cast_params=torch.bfloat16)
    check("irsde::naf_stack" in header["custom_ops"], f"nasde: custom ops {header['custom_ops']}")
    lq = torch.rand(LATENT_BATCH, LATENT_SIZE, LATENT_SIZE, 3, generator=rng_generator(dev, SEED + 93), device=dev)
    eager = make_latent_sampler(sde, net, compressor, mode=mode, steps=steps, cast_params=torch.bfloat16,
                                capture=False)
    want = counts(LAYERNORM=NAF_LN_PER_FORWARD * steps + COMPRESSOR_LN, LA_CTX=COMPRESSOR_ATTN,
                  LA_APPLY=COMPRESSOR_ATTN, NAF_STACK=steps)
    seed = SEED + 94
    job = export_job(workdir, "nasde_b4", path, want, [(lq, seed, eager(lq, rng.generator(seed, dev)))])
    return [job], {"nasde_b4": record}


def phase_export_denoising(dev, net, opt, workdir):
    """The Gaussian denoising sampler (sigma 50: 414 reverse-ODE steps; bf16
    compute on parameters cast to bf16) exported at a fixed batch of 8,
    128 px, with the eager sampler's output for the same noisy batch."""
    import torch

    from image_restoration_sde_tpu_torch import exporting
    from image_restoration_sde_tpu_torch.sampling import make_denoising_sampler
    from image_restoration_sde_tpu_torch.sde import DenoisingSDE

    sde_opt, sigma = opt["sde"], float(opt["degradation"]["sigma"])
    sde = DenoisingSDE.create(sde_opt["max_sigma"], sde_opt["T"], sde_opt["schedule"], device=dev)
    path, header, record = export_to(workdir, "denoising_b8", exporting.export_denoising_sampler, sde=sde, net=net,
                                     size=(SIZE, SIZE), sigma=sigma, batch=BATCH, cast_params=torch.bfloat16)
    check(header["steps"] == DENOISE_T0 and header["seed"] == "ignored", f"denoising: header {header}")
    gen = rng_generator(dev, SEED + 95)
    noisy = torch.rand(BATCH, SIZE, SIZE, 3, generator=gen, device=dev)
    noisy = noisy + sigma / 255 * torch.randn(noisy.shape, generator=gen, device=dev)
    eager = make_denoising_sampler(sde, net, sigma, cast_params=torch.bfloat16, capture=False)
    want = counts(LAYERNORM=DENOISE_LN_PER_FORWARD * DENOISE_T0, LA_CTX=DENOISE_ATTN_PER_FORWARD * DENOISE_T0,
                  LA_APPLY=DENOISE_ATTN_PER_FORWARD * DENOISE_T0)
    job = export_job(workdir, "denoising_b8", path, want, [(noisy, 0, eager(noisy))])
    return [job], {"denoising_b8": record}


def artifact_child(manifest: str) -> int:
    """``chip_smoke.py --artifact-child <manifest>``: in a fresh process that
    builds no net and reads no YAML, load each artifact of the manifest
    (``exporting.load_artifact``) and call it on each run's lq and seed:
    first its graph captured (``prepare``, seconds and warm-up launches
    apart), then the launch counts set to 0 just before the call and read
    just after; the outputs go beside the runs, the report (load, prepare
    and call seconds, launches, each job's seconds in all) to
    ``<manifest>.out.json``.  Each one-device call is also held bit for bit
    against the same artifact loaded with ``capture=False`` on the same lq,
    from generators of the run's seeds, their states equal after.  A job
    with ``devices`` loads the artifact over those devices
    (``load_artifact(devices=...)``) and also holds each call bit for bit
    against the one-device loader (the artifact's earlier job) called on
    the same row blocks.  The manifest's ``serve``: the (image, seed) pairs
    the server answered, each answer held byte for byte against the eager
    loader's row encoded as the server encodes it.  TF32 is off, as in the
    parent process that ran the eager samplers."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, REPO)
    from image_restoration_sde_tpu_torch import exporting

    with open(manifest) as f:
        spec = json.load(f)
    report, one_device, eager = {}, {}, {}

    def eager_call(path):
        if path not in eager:
            eager[path] = exporting.load_artifact(path, "cuda", capture=False)[0]
        return eager[path]

    for job in spec["jobs"]:
        t_job = t0 = time.perf_counter()
        call, _ = exporting.load_artifact(job["path"], "cuda", devices=job.get("devices"))
        one_device.setdefault(job["path"], call)
        entry = {"load_s": time.perf_counter() - t0, "runs": []}
        for run in job["runs"]:
            lq = torch.from_numpy(np.load(run["lq"])).cuda()
            reset_counts()
            t0 = time.perf_counter()
            call.prepare(lq, run["seed"])
            torch.cuda.synchronize()
            prepare_s, warm = time.perf_counter() - t0, warmup_counts()
            reset_counts()
            t0 = time.perf_counter()
            out = call(lq, run["seed"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            np.save(run["out"], out.cpu().numpy())
            entry["runs"].append({"batch": lq.shape[0], "seconds": seconds, "prepare_s": prepare_s,
                                  "warmup_launches": warm, "launches": request_counts()})
            if "devices" in job:
                one, blocks = one_device[job["path"]], [rows for _, rows in call.blocks(lq.shape[0])]
                by_block = torch.cat([one(lq[rows], run["seed"][rows]) for rows in blocks])
                entry["runs"][-1].update(blocks=len(blocks), blocks_bit_equal=bool(torch.equal(out, by_block)))
                continue
            forms = {}
            for form, loaded in (("captured", call), ("eager", eager_call(job["path"]))):
                gen = loaded._generators(run["seed"], lq.shape[0])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                y = loaded.run(lq, gen=gen)
                torch.cuda.synchronize()
                states = [g.get_state() for g in (gen if isinstance(gen, list) else [gen] if gen is not None else [])]
                forms[form] = (y, states, time.perf_counter() - t0)
            (yc, sc, tc), (ye, se, te) = forms["captured"], forms["eager"]
            entry["runs"][-1].update(captured_bit_equal=bool(torch.equal(yc, ye)), captured_seconds=tc,
                                     eager_seconds=te,
                                     states_equal=len(sc) == len(se) and all(map(torch.equal, sc, se)))
        entry["job_s"] = time.perf_counter() - t_job
        report[job["name"]] = entry
    if spec.get("serve"):
        report["serve"] = served_against_eager(spec["serve"], eager_call(spec["serve"]["path"]))
    with open(manifest + ".out.json", "w") as f:
        json.dump(report, f)
    return 0


def served_against_eager(served, loaded) -> dict:
    """Each answer the server gave (``served``: the artifact, and per answer
    its image, seed and PNG) against the eager loader's row for that
    (image, seed) at the artifact's fixed batch, made as the server makes
    it (``serve.build_handler``'s restore: [0, 1] floats in, the row clipped,
    rounded to uint8 and encoded as a PNG).  A row depends only on its own
    image and seed at a fixed batch, so the companions do not matter."""
    from image_restoration_sde_tpu_torch.data.io_utils import decode_img_bytes, encode_png

    pairs = sorted({(a["image"], a["seed"]) for a in served["answers"]})
    imgs = [decode_img_bytes(open(path, "rb").read()).astype(np.float32) / 255.0 for path, _ in pairs]
    batch = loaded.header["batch"]
    xs = np.stack(imgs + [imgs[-1]] * (batch - len(imgs)))
    seeds = [seed for _, seed in pairs] + [pairs[-1][1]] * (batch - len(pairs))
    out = loaded(xs, seeds).cpu().numpy()
    want = {pair: encode_png((np.clip(row, 0.0, 1.0) * 255.0).round().astype(np.uint8))
            for pair, row in zip(pairs, out)}
    same = [want[a["image"], a["seed"]] == open(a["png"], "rb").read() for a in served["answers"]]
    return {"answers": len(same), "bytes_equal": sum(same)}


def start_artifacts(workdir, jobs, children, served=None):
    """Phase artifacts' loading process (``artifact_child``), in the
    background: it loads and calls every exported artifact beside the
    phases that follow (the evaluation's), and holds the server's answers
    (``served``, phase serve's) against the eager loader; ``phase_artifacts``
    joins it."""
    manifest = os.path.join(workdir, "manifest.json")
    with open(manifest, "w") as f:
        json.dump({"jobs": jobs, "serve": served}, f)
    return Background("artifacts", [sys.executable, os.path.abspath(__file__), "--artifact-child", manifest],
                      children), manifest


def phase_artifacts(dev, started, jobs, smi):
    """Every exported artifact loaded and called in a fresh process
    (``artifact_child``, started by ``start_artifacts``): each call's
    output against the eager sampler's with the same generators
    (EXPORT_BOUND of max|eager|; bit-equality reported) and its exact
    launches, its captured chain bit-equal to the same artifact's eager
    chain with the same generators, their states equal after.  The
    server's answers byte-equal to the eager loader's rows (``served``).
    The data-parallel job (the symbolic
    artifact over DP_ARTIFACT_DEVICES, a chain for each row block): one
    call's launches for each block, bit-equal to the one-device loader on
    the same blocks, and against the eager sampler on the whole batch
    within DP_ARTIFACT_BOUND (bit-equality reported).  Returns the
    launches, the data-parallel job's apart, and the record."""
    child, manifest = started
    child.join()
    with open(manifest + ".out.json") as f:
        report = json.load(f)
    print(f"[artifacts] the loading process by job (load, calls, captured against eager and block holds): "
          f"{', '.join(f'{job['name']} {report[job['name']]['job_s']:.1f}' for job in jobs)} s")
    launches, dp_launches, record = {}, {}, {}
    for job in jobs:
        entry = report[job["name"]]
        rec = record[job["name"]] = {"load_s": entry["load_s"], "job_s": entry["job_s"], "runs": []}
        for run, got in zip(job["runs"], entry["runs"]):
            out, eager = np.load(run["out"]), np.load(run["eager"])
            check(out.shape == eager.shape and np.isfinite(out).all(), f"{job['name']}: output {out.shape}")
            err = float(np.abs(out - eager).max() / max(np.abs(eager).max(), 1e-12))
            same = bool(np.array_equal(out, eager))
            limit = DP_ARTIFACT_BOUND if "devices" in job else EXPORT_BOUND
            check(err <= limit, f"{job['name']} batch {got['batch']}: {err:.3g} of max|eager| from eager")
            want = {sym: n * got.get("blocks", 1) for sym, n in job["want"].items()}
            check(got["launches"] == want, f"{job['name']}: launches {got['launches']}, want {want}")
            into = dp_launches if "devices" in job else launches
            for sym, n in got["launches"].items():
                into[sym] = into.get(sym, 0) + n
            rec["runs"].append({"batch": got["batch"], "seconds": got["seconds"], "prepare_s": got["prepare_s"],
                                "rel_err": err, "bit_equal": same})
            tag, more = "artifacts", ""
            if "devices" not in job:
                check(got["captured_bit_equal"] and got["states_equal"],
                      f"{job['name']} batch {got['batch']}: the captured chain is not the eager loader's "
                      f"(bit-equal {got['captured_bit_equal']}, generator states equal {got['states_equal']})")
                rec["runs"][-1].update(captured_s=got["captured_seconds"], eager_s=got["eager_seconds"])
                more = (f"; captured bit-equal to the eager loader, generator states equal (call "
                        f"{got['captured_seconds']:.3f} s captured, {got['eager_seconds']:.3f} eager; capture "
                        f"{got['prepare_s']:.3f} s, warm-up launches {got['warmup_launches']} apart)")
            else:
                check(got["blocks_bit_equal"], f"{job['name']} batch {got['batch']}: not the one-device blocks")
                rec["runs"][-1].update(devices=job["devices"], blocks=got["blocks"])
                tag, more = "dp-artifact", (f"; on {job['devices']} in {got['blocks']} row blocks, bit-equal to "
                                            f"the one-device loader on the same blocks")
            print(f"[{tag}] {job['name']} batch {got['batch']}: loaded call {got['seconds']:.3f} s, "
                  f"{err:.3g} of max|eager| from the eager sampler on the whole batch "
                  f"({'bit-equal' if same else 'not bit-equal'}), launches {got['launches']}{more} "
                  f"(load {entry['load_s']:.1f} s; card: {smi})")
    if "serve" in report:
        got = report["serve"]
        check(got["bytes_equal"] == got["answers"] > 0, f"serve: {got['bytes_equal']} of {got['answers']} answers "
                                                         f"byte-equal to the eager loader's rows")
        record["serve_against_eager"] = got
        print(f"[artifacts] the server's {got['answers']} answers (its captured chain) byte-equal to the eager "
              f"loader's rows: {got['bytes_equal']} of {got['answers']}")
    return launches, dp_launches, record


def post_group(addr, requests):
    """``(status, body)`` of each (image PNG, seed) request, all sent at
    once from their own threads."""
    import threading

    from image_restoration_sde_tpu_torch import bench_serve

    out = [None] * len(requests)
    gate = threading.Barrier(len(requests))

    def one(i):
        gate.wait()
        out[i] = bench_serve.post(addr, *requests[i])

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(all(r is not None for r in out), "serve: a request got no answer")
    return out


def start_server(artifact, children):
    """``python -m image_restoration_sde_tpu_torch.serve`` on the fixed-batch
    per-sample-seed deraining artifact, port 0, started ahead of phase
    serve: it loads and warms beside the phases in between."""
    from image_restoration_sde_tpu_torch import bench_serve

    proc = bench_serve.start_server(artifact, BATCH, SERVE_WINDOW_MS, device="cuda")
    children.append(proc)
    return proc


def phase_serve(dev, proc, smi, artifact, workdir):
    """The server ``start_server`` started (the fixed-batch per-sample-seed
    deraining ``artifact``, port 0; on the card its loader replays the
    chain's graph, captured by the server's warm-up call), once it is
    bound: ``/health``; SERVE_N
    requests at SERVE_CONCURRENCY through the port's ``bench_serve``, every
    device call launching exactly one batch's kernels; the same (image,
    seed) in two batches of other companions, at other positions, gives the
    same bytes, every response a PNG of its input's size; seeds -1 and 2**32
    get 400 while their companion gets 200; ``seed_reproducible`` is what
    the run showed.  Returns the launches, the record and the answers of
    those two batches (images, seeds and PNGs saved under ``workdir``),
    which phase artifacts holds against the eager loader."""
    from image_restoration_sde_tpu_torch import bench_serve
    from image_restoration_sde_tpu_torch.data.io_utils import decode_img_bytes

    per_call = counts(LAYERNORM=LN_PER_FORWARD * 100, LA_CTX=ATTN_PER_FORWARD * 100, LA_APPLY=ATTN_PER_FORWARD * 100)
    try:
        addr = bench_serve.server_address(proc)
        health = bench_serve.health(addr)
        serving = health["serving"]
        check(health["kind"] == "restoration_sampler" and serving["fixed_batch"] == BATCH
              and health["seed"] == "per_sample", f"serve: /health {serving}")
        before = serving
        result = bench_serve.bench(addr, SERVE_N, SERVE_CONCURRENCY, SERVE_WARMUP)
        after = bench_serve.health(addr)["serving"]
        calls = after["batches"] - before["batches"]
        grew = {k: after["launches"][k] - before["launches"][k] for k in after["launches"]}
        check(grew == {k: n * calls for k, n in per_call.items()}, f"serve: {grew} launches in {calls} calls")
        print(f"[serve] {SERVE_N} requests at concurrency {SERVE_CONCURRENCY} (after {SERVE_WARMUP} untimed): "
              f"{result['requests_per_s']:.4f} req/s, latency p50 {result['latency_ms']['p50']:.1f} ms, p99 "
              f"{result['latency_ms']['p99']:.1f} ms, mean device batch {result['mean_device_batch']:.3f} riders in "
              f"{result['device_calls']} calls of {BATCH}; launches {grew} (card: {smi})")

        images = [bench_serve.make_png((SIZE, SIZE), 3, seed=SEED + 200 + i) for i in range(5)]
        groups = [[(images[0], 7), (images[1], 3), (images[2], 5)], [(images[3], 9), (images[4], 11), (images[0], 7)]]
        answers = []
        for group in groups:
            b0 = bench_serve.health(addr)["serving"]
            got = post_group(addr, group)
            b1 = bench_serve.health(addr)["serving"]
            check((b1["batches"] - b0["batches"], b1["requests"] - b0["requests"]) == (1, len(group)),
                  f"serve: a group of {len(group)} took {b1['batches'] - b0['batches']} calls")
            for (status, body), (png, _) in zip(got, group):
                check(status == 200, f"serve: HTTP {status}: {body[:200]!r}")
                check(decode_img_bytes(body).shape == decode_img_bytes(png).shape, "serve: output size")
            answers.append(got)
        saved = []
        for g, (group, got) in enumerate(zip(groups, answers)):
            for i, ((png, seed), (_, body)) in enumerate(zip(group, got)):
                out = os.path.join(workdir, f"served.{g}.{i}.out.png")
                with open(out, "wb") as f:
                    f.write(body)
                saved.append({"image": os.path.join(workdir, f"served.in.{images.index(png)}.png"), "seed": seed,
                              "png": out})
        for i, png in enumerate(images):
            with open(os.path.join(workdir, f"served.in.{i}.png"), "wb") as f:
                f.write(png)
        same = answers[0][0][1] == answers[1][2][1]
        differ = answers[0][0][1] != answers[0][1][1]
        check(same and differ, f"serve: same (image, seed) bytes equal {same}; other seeds differ {differ}")
        check(serving["seed_reproducible"] is same, f"serve: seed_reproducible {serving['seed_reproducible']}")
        b0 = bench_serve.health(addr)["serving"]
        bad = post_group(addr, [(images[0], -1), (images[1], 2**32), (images[2], 5)])
        b1 = bench_serve.health(addr)["serving"]
        check([status for status, _ in bad] == [400, 400, 200], f"serve: bad seeds {[s for s, _ in bad]}")
        check(b1["requests"] - b0["requests"] == 1, "serve: a bad seed reached a batch")
        print(f"[serve] (image, seed) = (0, 7) in a call with seeds (7, 3, 5) and one with (9, 11, 7): the same "
              f"bytes ({same}); seed_reproducible {serving['seed_reproducible']}; seeds -1 and 2**32: 400, their "
              f"companion 200")
    finally:
        end(proc)
    return grew, result, {"path": artifact, "answers": saved}


def phase_bench(dev, smi, stats):
    """``python3 bench_cuda.py`` in its own process (batch 8, the captured
    chain), its line checked and printed; then in this process its sampler
    at batch 8 in both forms, captured and eager (``capture=False``),
    BENCH_REPS timed calls after two warm-ups each (img/s median and every
    call's seconds), and one call of each from generators of one seed: the
    outputs bit-equal, the generators' states equal after; then the
    captured sampler at each batch of BENCH_SWEEP at 128 px
    (BENCH_SWEEP_REPS timed calls after two warm-ups, the first capturing),
    with exact launches.  Then one forward of the bench's net at each sweep
    batch records its K1 and K2 sites, and each kernel is held against its
    plain version there (``hold_sites``; these launches are not the
    path's)."""
    import torch

    import bench_cuda

    run = subprocess.run([sys.executable, os.path.join(REPO, "bench_cuda.py")], capture_output=True, text=True,
                         timeout=600)
    check(run.returncode == 0, f"bench_cuda.py exited {run.returncode}: {run.stderr[-2000:]}")
    line = json.loads(run.stdout.strip().splitlines()[-1])
    check(set(line) >= {"metric", "value", "unit", "vs_baseline", "baseline_kind"} and line["unit"] == "img/s/GPU"
          and line["value"] > 0 and line["device"] == torch.cuda.get_device_name(0), f"bench line {line}")
    print(f"[bench] bench_cuda.py: {json.dumps(line)} (card: {smi})")
    net = bench_cuda.make_net(dev)
    sampler = bench_cuda.make_sampler(net, 100, False, dev)
    eager = bench_cuda.make_sampler(net, 100, False, dev, capture=False)
    forms = {}
    for form, s in (("captured", sampler), ("eager", eager)):
        times = bench_cuda.run(s, BATCH, SIZE, BENCH_REPS, dev)
        forms[form] = {"img_s": BATCH / statistics.median(times), "seconds": times}
        print(f"[bench] {form} batch {BATCH} at {SIZE}px, 100 sde steps: {forms[form]['img_s']:.4f} img/s (median "
              f"of {BENCH_REPS}: {', '.join(f'{t:.3f}' for t in times)} s; host clock; card: {smi})")
    lq = torch.rand(BATCH, SIZE, SIZE, 3, generator=rng_generator(dev, SEED + 97), device=dev)
    outs = {}
    for form, s in (("captured", sampler), ("eager", eager)):
        gen = rng_generator(dev, SEED + 98)
        outs[form] = (s(lq, gen), gen.get_state())
    same = bool(torch.equal(outs["captured"][0], outs["eager"][0]))
    states = bool(torch.equal(outs["captured"][1], outs["eager"][1]))
    check(same and states, f"bench: captured against eager bit-equal {same}, generator states equal {states}")
    print(f"[bench] captured against eager at batch {BATCH}: bit-equal, generator states equal")
    sweep = {BATCH: {"img_s": line["value"], "from": "bench_cuda.py"}}
    reset_counts()
    for b in BENCH_SWEEP:
        before = request_counts()
        times = bench_cuda.run(sampler, b, SIZE, BENCH_SWEEP_REPS, dev)
        grew = {sym: n - before[sym] for sym, n in request_counts().items()}
        calls = 2 + BENCH_SWEEP_REPS
        want = counts(LAYERNORM=LN_PER_FORWARD * 100 * calls, LA_CTX=ATTN_PER_FORWARD * 100 * calls,
                      LA_APPLY=ATTN_PER_FORWARD * 100 * calls)
        check(grew == want, f"bench batch {b}: launches {grew}")
        sweep[b] = {"img_s": b / statistics.median(times), "seconds": times}
        print(f"[bench] batch {b} at {SIZE}px, 100 sde steps: {sweep[b]['img_s']:.4f} img/s (median of "
              f"{BENCH_SWEEP_REPS}: {', '.join(f'{t:.3f}' for t in times)} s; card: {smi})")
    launched = request_counts()
    gen = rng_generator(dev, SEED + 96)
    with recorded_sites() as (ln, attn), torch.inference_mode():
        for b in BENCH_SWEEP:
            x = torch.rand(b, SIZE, SIZE, 3, generator=gen, device=dev)
            net(x, x, torch.full((b,), 50, dtype=torch.int32, device=dev))
    hold_sites("bench", dev, ln, attn, stats, {})
    return launched, {"bench_cuda": line, "forms": forms, "captured_bit_equal": same, "sweep": sweep}


# ---------------------------------------------------------------- data parallelism
def dp_child(yml: str, out: str, backend: str) -> int:
    """``torchrun ... chip_smoke.py --dp-child <yml> <out> <backend>``: one
    rank of the port's train entry point (``train.train``, what ``python -m
    image_restoration_sde_tpu_torch.train`` runs under torchrun) with its
    steps recorded (``recorded_steps``: launches, milliseconds, loss, the
    parameters after the steps of DP_AT, the gradients of the first: under
    DDP the ranks' mean); the record goes to ``<out>.<rank>.pt``.
    torch's default TF32 settings, as the one-process run of phase 21."""
    import torch

    sys.path.insert(0, REPO)
    from image_restoration_sde_tpu_torch import train

    with recorded_steps(snapshot_at=DP_AT, grads_at=DP_AT[:1]) as rec:
        train.train(yml, "cuda", backend)
    torch.save({"steps": rec["steps"], "params": rec["snapshots"], "grads": rec["grads"][DP_AT[0]]},
               f"{out}.{os.environ['RANK']}.pt")
    return 0


def dp_in_process(yml: str, out: str, backend: str) -> str:
    """``dp_child`` in this process, as torchrun's one rank (RANK 0 of
    WORLD_SIZE 1 on a free port; the group is left at the end), its log
    read from the run's log file; returns the log.  A torchrun process for
    (a) took 37.3 s on a slow host against 8.3 s here, the script's time
    limit is tight, and torchrun's own start is run by (b) and (c)."""
    import glob

    from image_restoration_sde_tpu_torch.parallel import dist
    from image_restoration_sde_tpu_torch.utils import options

    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost", MASTER_PORT=str(dist.free_port()))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        dp_child(yml, out, backend)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    log_dir = options.parse(yml)["path"]["log"]
    with open(max(glob.glob(os.path.join(log_dir, "train_*.log")), key=os.path.getmtime)) as f:
        return f.read()


def dp_runs():
    """(tag, ranks, backend) of phase train dp: (a) one NCCL rank (in this
    process: ``dp_in_process``); (b) two gloo ranks on the one card (NCCL
    takes one rank a card); (c) one NCCL rank a card where there are two or
    more, as many as divide the global batch (None on one card)."""
    import torch

    cards = torch.cuda.device_count()
    many = max((n for n in (2, 4) if n <= cards and TRAIN_BATCH % n == 0), default=None)
    return [("a", 1, "nccl"), ("b", 2, "gloo"), ("c", many, "nccl") if many else ("c", None, "nccl")]


def phase_train_dp(dev, label, opt, workdir, smi, reference):
    """The deraining IR-SDE train YAML's steps DP_AT (DP_STEPS of batch 4
    of 128 px crops, full width, the synthetic folders of phase 21),
    resumed from phase 21's half-way checkpoint (its ``.state`` and its
    weights copied to the run's own models directory), through the train
    entry point under ``torchrun`` (``dp_child``; run (b) in phase train
    tp's torchrun, ``ranks_child``), for each run of ``dp_runs``, held
    against phase 21's one-process run of the same YAML and seed
    (``reference``: its losses and step milliseconds at those steps, its
    parameters after them, the first one's gradients).  Rank 0
    alone logs the data-parallel line; every rank takes exactly the
    one-process step's launches per step (at its per-rank batch, none in
    the backward); the ranks end with the same parameters and gradients
    and report the same (global) losses.  (a), one rank, is bit-equal to
    the one-process run: every loss, the first step's gradients and the
    parameters after every recorded step.  (b) and (c) split the batch, so
    the gradients sum in another order: their first step's loss within
    1e-6 of the one-process step's, its gradients (after the all-reduce:
    the ranks' mean) each within DP_GRAD_REL of its tensor's max|grad| from
    the same ranks' gradients averaged in this process
    (``block_mean_grads``; from the whole batch's, which cuDNN's TF32
    convolutions round otherwise, reported), and the parameters after it
    within 2 lr_G (phase_train_main_path's bounds for the first step of a
    resumed run: Adam's step on an element whose gradient's sign flips may
    differ by up to that); the later steps start from those parameters,
    their losses within DP_LATER_LOSS of the one-process run's, and the
    parameters after the last step are reported.  Returns the launches of
    all ranks and runs and a record of step times against the one-process
    run's (both filled in further when run (b) is held), and run (b)
    pending: its YAML, which phase train tp's torchrun trains first
    (``ranks_child``: one torchrun start for both phases), and ``finish``,
    which holds it then."""
    import torch

    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # torch's default, which the torchrun ranks and phase 21 run with
    try:
        return train_dp(dev, label, opt, workdir, smi, reference)
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32


def train_dp(dev, label, opt, workdir, smi, reference):
    import shutil

    import torch

    from image_restoration_sde_tpu_torch.dryrun import grad_rel
    from image_restoration_sde_tpu_torch.ops import KERNELS
    from image_restoration_sde_tpu_torch.utils import options

    root, data = os.path.join(workdir, f"{label}_dp"), os.path.join(workdir, "data")
    os.makedirs(root, exist_ok=True)
    want, lr = train_counts(label), reference["lr"]
    ref_losses, ref_ms = reference["losses"], reference["ms"]
    first, last = DP_AT
    launches, record = {k.symbol: 0 for k in KERNELS}, {"one_process_ms_per_step": ref_ms, "card": smi}

    def hold(tag, n, backend, out, logged, seconds):
        line = f"Data parallel: {n} process(es), global batch {TRAIN_BATCH}, per-process batch {TRAIN_BATCH // n}"
        check(logged.count(line) == 1, f"train dp ({tag}): rank 0's line {line!r} not logged once")
        ranks = [torch.load(f"{out}.{r}.pt", weights_only=False) for r in range(n)]
        for r, rank in enumerate(ranks):
            check(len(rank["steps"]) == DP_STEPS, f"train dp ({tag}) rank {r}: {len(rank['steps'])} steps")
            for i, (grew, _, loss) in enumerate(rank["steps"]):
                check(grew == want, f"train dp ({tag}) rank {r} step {i + 1}: launches {grew}, expected {want}")
                for sym, c in grew.items():
                    launches[sym] += c
            check([st[2] for st in rank["steps"]] == [st[2] for st in ranks[0]["steps"]]
                  and all(torch.equal(v, ranks[0]["params"][at][k]) for at, p in rank["params"].items()
                          for k, v in p.items())
                  and all(torch.equal(v, ranks[0]["grads"][k]) for k, v in rank["grads"].items()),
                  f"train dp ({tag}): rank {r} differs from rank 0")
        losses = [st[2] for st in ranks[0]["steps"]]
        loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
        dparam = {at: max((v - reference["params"][at][k]).abs().max().item() for k, v in p.items())
                  for at, p in ranks[0]["params"].items()}
        check(sorted(ranks[0]["grads"]) == sorted(reference["grads"]), f"train dp ({tag}): gradients' keys")
        # one rank against the one-process step; more against the same
        # ranks' gradients averaged in this process (and, reported, the step's
        # on the whole batch, where cuDNN's TF32 convolutions round otherwise)
        dgrad = grad_rel(ranks[0]["grads"], reference["grads"] if n == 1 else reference["block_grads"][n])
        dgrad_whole = grad_rel(ranks[0]["grads"], reference["grads"])
        bit_equal = losses == ref_losses and dgrad_whole == 0 and all(d == 0 for d in dparam.values())
        ms = [st[1] for st in ranks[0]["steps"]]
        record[tag] = {"ranks": n, "backend": backend, "ms_per_step": ms, "seconds": seconds, "loss_rel": loss_rel,
                       "grad_rel": dgrad, "grad_rel_whole_batch": dgrad_whole, "param_max_abs": dparam,
                       "bit_equal": bit_equal}
        print(f"[train-dp] ({tag}) {n} {backend} rank(s) on {'one card' if tag != 'c' else f'{n} cards'}: "
              f"{DP_STEPS} steps of batch {TRAIN_BATCH} ({TRAIN_BATCH // n} a rank), losses {losses} against "
              f"{ref_losses} in one process (rel {', '.join(f'{x:.3g}' for x in loss_rel)}); step {first}'s gradients "
              f"{dgrad:.3g} of max|grad| from {'the' if n == 1 else f'{n} row blocks averaged in'} one process's "
              f"(bound {DP_GRAD_REL}), {dgrad_whole:.3g} from the whole batch's; parameters max|d| "
              f"after step {first} {dparam[first]:.3g}, after step {last} {dparam[last]:.3g} (2 lr_G = {2 * lr:.3g}); "
              f"bit-equal: {bit_equal}; launches per rank and step {want}; ms by step (rank 0) "
              f"{', '.join(f'{x:.1f}' for x in ms)} against {', '.join(f'{x:.1f}' for x in ref_ms)} in one process; "
              f"torchrun {seconds:.1f} s (card: {smi})")
        if n == 1:
            check(bit_equal, f"train dp ({tag}): one rank is not bit-equal to one process")
        else:
            check(loss_rel[0] <= 1e-6 and dgrad <= DP_GRAD_REL and dparam[first] <= 2 * lr,
                  f"train dp ({tag}): the first step differs")
            check(all(x <= DP_LATER_LOSS for x in loss_rel[1:]), f"train dp ({tag}): a later step's loss differs")

    pending = None
    for tag, n, backend in dp_runs():
        if n is None:
            print(f"[train-dp] ({tag}) one NCCL rank a card: not run, this machine has "
                  f"{torch.cuda.device_count()} card(s)")
            record[tag] = None
            continue
        yml = write_train_yaml(os.path.join(root, f"{tag}.yml"), label, opt, root, data, last, 10 * last, 10 * last,
                               resume=reference["state"], name=f"{opt['name']}_dp_{tag}")  # the final save alone
        models = options.parse(yml, is_train=True)["path"]["models"]  # where the resumed run reads its weights
        os.makedirs(models, exist_ok=True)
        shutil.copy(reference["weights"], os.path.join(models, os.path.basename(reference["weights"])))
        out = os.path.join(root, tag)
        if tag == "b":  # in phase train tp's torchrun (ranks_child): its start is paid once
            pending = {"yml": yml, "finish": lambda out_, logged, seconds, n=n, backend=backend:
                       hold("b", n, backend, out_, logged, seconds)}
            continue
        t0 = time.perf_counter()
        if n == 1:  # in this process, under the environment torchrun gives its one rank
            logged = dp_in_process(yml, out, backend)
        else:
            run = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
                                  str(n), os.path.abspath(__file__), "--dp-child", yml, out, backend],
                                 capture_output=True, text=True, timeout=600)
            check(run.returncode == 0, f"train dp ({tag}): torchrun exited {run.returncode}: {run.stderr[-3000:]}")
            logged = run.stderr
        hold(tag, n, backend, out, logged, time.perf_counter() - t0)
    return launches, record, pending


# ---------------------------------------------------------------- tensor parallelism
def ranks_child(out: str, *ymls: str) -> int:
    """``torchrun ... chip_smoke.py --ranks-child <out> <yml>...``: one gloo
    rank of the port's train entry point on each YAML in turn (one process
    group for all, joined here, so the runs share torchrun's start).  A
    YAML without ``train.model_parallel`` is phase train dp's run (b), as
    ``dp_child`` runs it: torch's default TF32 settings, its checkpoint
    written, the parameters after the steps of DP_AT and the first's
    gradients (DDP's mean) recorded.  One with it: cuDNN TF32 off as the
    one-process steps it is held against, writing no checkpoint, its steps
    recorded (``recorded_steps``: launches, milliseconds, loss; step 1's
    gradients assembled from the model group).  Each attention call's K4
    site, and each fused NAFNet level's K3 site, whether it got its blocks'
    whole tensors (gathered from the ranks) and whether its output carries
    a grad_fn; every K3 launch is held against its plain version on the
    same gathered weights and input (``hold_naf_stack``; those launches are
    taken off the count: they are not the step's).  The record of YAML
    ``<label>.yml``, with the rank's peak memory and the layout's split
    share and bytes a rank, goes to ``<out>.<label>.<rank>.pt`` (rank 0
    alone keeps the gradients)."""
    import gc

    import torch

    sys.path.insert(0, REPO)
    from image_restoration_sde_tpu_torch import train
    from image_restoration_sde_tpu_torch.models import dit, nafnet
    from image_restoration_sde_tpu_torch.ops import NAF_STACK
    from image_restoration_sde_tpu_torch.ops import naf_stack as NS
    from image_restoration_sde_tpu_torch.parallel import dist

    dist.init(torch.device("cuda"), "gloo")
    rank = dist.rank()
    sites = {"k4": [], "k3": [], "held": []}
    attend, stack, cuda = dit.flash_mha, nafnet.naf_stack, NS.naf_stack_cuda

    def recorded_k4(q, k, v, scale):
        out_ = attend(q, k, v, scale)
        sites["k4"].append((tuple(q.shape), q.dtype, out_.grad_fn is not None))
        return out_

    def recorded_k3(x, blocks, temb, eps):
        out_ = stack(x, blocks, temb, eps)
        C = x.shape[-1]
        whole = all(tuple(b["conv1.weight"].shape) == (2 * C, C, 1, 1) and b["mlp.1.weight"].shape[0] == 4 * C
                    for b in blocks)
        sites["k3"].append((tuple(x.shape), x.dtype, len(blocks), whole, out_.grad_fn is not None))
        return out_

    def held_k3(x, blocks, tmod, eps):
        y = cuda(x, blocks, tmod, eps)
        launches, NS.naf_stack_cuda = NAF_STACK.launches, cuda
        try:
            sites["held"].append(hold_naf_stack("train-tp", x, blocks, tmod, NS.stack_params(blocks, tmod), eps))
        finally:
            NS.naf_stack_cuda, NAF_STACK.launches = held_k3, launches
        return y

    dit.flash_mha, nafnet.naf_stack, NS.naf_stack_cuda = recorded_k4, recorded_k3, held_k3
    try:
        for yml in ymls:
            for v in sites.values():
                v.clear()
            torch.cuda.reset_peak_memory_stats()
            path = f"{out}.{os.path.basename(yml)[:-len('.yml')]}.{rank}.pt"
            if not load_yaml(yml)["train"].get("model_parallel"):
                torch.backends.cudnn.allow_tf32 = True  # torch's default, as dp_child's fresh process has it
                with recorded_steps(snapshot_at=DP_AT, grads_at=DP_AT[:1]) as rec:
                    state = train.train(yml, "cuda", "gloo")
                torch.save({"steps": rec["steps"], "params": rec["snapshots"], "grads": rec["grads"][DP_AT[0]]},
                           path)
                del state, rec
                continue
            torch.backends.cudnn.allow_tf32 = False
            with recorded_steps(grads_at=(1,)) as rec, no_checkpoints():
                state = train.train(yml, "cuda", "gloo")
            torch.save({"steps": rec["steps"], "grads": rec["grads"][1] if rank == 0 else None,
                        "k4": list(sites["k4"]), "k3": list(sites["k3"]), "held": list(sites["held"]),
                        "peak": torch.cuda.max_memory_allocated(), "share": state.layout.share,
                        "shard_bytes": state.layout.shard_bytes(state.net)}, path)
            del state, rec
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dit.flash_mha, nafnet.naf_stack, NS.naf_stack_cuda = attend, stack, cuda
        dist.shutdown()
    return 0


def random_pth(path, label, opt, dev) -> str:
    """The path ``label``'s net with ``init_params_`` weights (every
    tensor drawn, the DiT's zero-initialised modulations and final linear
    map too), saved as a ``.pth``: a start whose step-1 gradients are not
    zero where a fresh net's are."""
    import torch

    from image_restoration_sde_tpu_torch.models import build_network, init_params_
    from image_restoration_sde_tpu_torch.utils import options

    with torch.device(dev):
        net = build_network(*train_network(label, options.dict_to_nonedict(opt)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 20)
    torch.save(init_params_(net, gen).state_dict(), path)
    del net
    torch.cuda.empty_cache()
    return path


def phase_train_tp(dev, opts, workdir, smi, pretrain_l, children, dp_pending=None):
    """Phase train tp's first half: the TP_PATHS YAMLs in this process
    (the one-process references ``finish_train_tp`` holds the ranks
    against), then one ``torchrun`` of TP_RANKS gloo ranks (``ranks_child``;
    phase train dp's run (b) first where ``dp_pending`` holds it) started
    in the background, beside the phases up to ``finish_train_tp``.
    Returns what ``finish_train_tp`` takes."""
    import gc

    import torch

    from image_restoration_sde_tpu_torch import train

    data, root = os.path.join(workdir, "data"), os.path.join(workdir, "tp")
    os.makedirs(root, exist_ok=True)
    never, refs, ymls = 10 * TP_STEPS, {}, []
    for label, batch in TP_PATHS.items():
        opt, pl = opts[label], pretrain_l if label == "dit" else None
        pg = random_pth(os.path.join(root, f"{label}_G.pth"), label, opt, dev) if label in TP_RANDOM_START else None
        one_yml = write_train_yaml(os.path.join(root, f"{label}_one.yml"), label, opt, root, data, TP_STEPS, never,
                                   never, name=f"{opt['name']}_one", pretrain_l=pl, batch=batch, pretrain_g=pg)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with recorded_steps(grads_at=(1,)) as rec, no_checkpoints():
            train.train(one_yml, dev, capture=False)  # eager, as the split ranks' steps
        refs[label] = {"losses": [st[2] for st in rec["steps"]], "ms": [st[1] for st in rec["steps"]],
                       "grads": rec["grads"][1], "peak": torch.cuda.max_memory_allocated()}
        del rec
        ymls.append(write_train_yaml(os.path.join(root, f"{label}.yml"), label, opt, root, data, TP_STEPS, never,
                                     never, name=f"{opt['name']}_tp", pretrain_l=pl, batch=batch,
                                     train={"model_parallel": TP_RANKS}, pretrain_g=pg))
    gc.collect()
    torch.cuda.empty_cache()

    out = os.path.join(root, "tp")
    first = [] if dp_pending is None else [dp_pending["yml"]]
    child = Background("train tp torchrun", [sys.executable, "-m", "torch.distributed.run", "--standalone",
                                             "--nproc_per_node", str(TP_RANKS), os.path.abspath(__file__),
                                             "--ranks-child", out, *first, *ymls], children)
    return {"child": child, "refs": refs, "out": out, "first": first, "dp_pending": dp_pending}


def finish_train_tp(dev, started, smi, stats):
    """Join phase train tp's torchrun (``phase_train_tp``) and hold it: the
    TP_PATHS train YAMLs through the train entry point with
    ``train.model_parallel: TP_RANKS``, all in one ``torchrun``
    (``ranks_child``): TP_RANKS gloo ranks sharing the card, one model group
    splitting the net, TP_STEPS steps, no validation, no checkpoint.  The
    DiT YAML (DiT-L/2 at full width, 1024 px crops: 4096 tokens; phase
    21's compressor as its frozen ``pretrain_model_L``; ``random_pth``'s
    weights as its ``pretrain_model_G``, TP_RANDOM_START) at batch TP_BATCH:
    qkv by head, so K4 runs on each rank's heads, its step-1 attention
    gradients not zero (their max|grad| printed); the deraining Refusion
    YAML (the flagship NAFNet, batch 4 of 128 px crops, Lion): its
    convolutions by input channel and its 28-block level's split tensors
    gathered, so one K3 a rank and step runs on the whole level at
    TP_NAF_SITE.  Each held against the one-process run of the same YAML
    without the key, run first in this process (its results kept on the
    host): rank 0 alone logs the mesh; every rank takes exactly the
    one-process step's launches per step (``train_counts``) and reports
    the same losses; every K4 call at TP_SITE in float32 and every K3 call
    at TP_NAF_SITE in float32 on whole tensors, each output with a
    grad_fn, and each K3 launch within ``hold_naf_stack``'s bounds of its
    plain version on the rank's own gathered weights; step 1's loss within
    TP_LOSS_REL and its gradients, assembled from the ranks, within
    TP_GRAD_REL of max|grad| of the one-process step's; the later steps'
    losses within DP_LATER_LOSS; the split share above TP_SHARE.  Then K4
    at TP_SITE and K3 at TP_NAF_SITE against their plain versions, timed
    beside them (K4 also beside SDPA) and their bounds.  Returns the ranks'
    launches and a record per YAML (ms per step on rank 0 against one
    process, peak memory a rank, the split share and bytes a rank).

    ``dp_pending`` (phase train dp's run (b), two gloo ranks on the card
    without a model axis): its YAML trains first in the same torchrun,
    whose start it then shares, and its ``finish`` holds it as phase train
    dp would have."""
    import torch
    import torch.nn.functional as F

    from image_restoration_sde_tpu_torch.dryrun import grad_rel
    from image_restoration_sde_tpu_torch.ops import FLASH_ATTN, KERNELS, NAF_STACK
    from image_restoration_sde_tpu_torch.ops import flash_attention as FA
    from image_restoration_sde_tpu_torch.ops import naf_stack as NS

    child, refs, out, first, dp_pending = (started[k] for k in ("child", "refs", "out", "first", "dp_pending"))
    logged = child.join(echo=False)
    seconds = time.perf_counter() - child.t0
    if dp_pending is not None:
        dp_pending["finish"](f"{out}.{os.path.basename(first[0])[:-len('.yml')]}", logged, seconds)
    line = f"Tensor parallel: mesh {{'data': 1, 'model': {TP_RANKS}}} (data 1 x model {TP_RANKS})"
    check(logged.count(line) == len(TP_PATHS), f"train tp: rank 0's line {line!r} not logged once a run")
    launches, record = {k.symbol: 0 for k in KERNELS}, {"torchrun_seconds": seconds, "card": smi}
    for label in TP_PATHS:
        want, ref = train_counts(label), refs.pop(label)
        ranks = [torch.load(f"{out}.{label}.{r}.pt", weights_only=False) for r in range(TP_RANKS)]
        for r, rank in enumerate(ranks):
            check(len(rank["steps"]) == TP_STEPS, f"train tp {label} rank {r}: {len(rank['steps'])} steps")
            for i, (grew, _, _) in enumerate(rank["steps"]):
                check(grew == want, f"train tp {label} rank {r} step {i + 1}: launches {grew}, expected {want}")
                for sym, c in grew.items():
                    launches[sym] += c
            check([st[2] for st in rank["steps"]] == [st[2] for st in ranks[0]["steps"]],
                  f"train tp {label}: rank {r}'s losses differ from rank 0's")
            k4 = want[FLASH_ATTN.symbol] * TP_STEPS
            check(len(rank["k4"]) == k4 and all(shape == TP_SITE and dtype == torch.float32 and grad
                                                for shape, dtype, grad in rank["k4"]),
                  f"train tp {label} rank {r}: K4 calls {sorted(set(rank['k4']), key=str)}")
            k3 = want[NAF_STACK.symbol] * TP_STEPS
            check(len(rank["k3"]) == len(rank["held"]) == k3
                  and all(site == (TP_NAF_SITE, torch.float32, TRAIN_NAF_LEVEL[0], True, True) for site in rank["k3"]),
                  f"train tp {label} rank {r}: K3 calls {sorted(set(rank['k3']), key=str)}, {len(rank['held'])} held")
            for err, limit, _ in rank["held"]:
                stats[NAF_STACK]["err"] = max(stats[NAF_STACK]["err"], err)
        losses = [st[2] for st in ranks[0]["steps"]]
        loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
        check(sorted(ranks[0]["grads"]) == sorted(ref["grads"]), f"train tp {label}: gradients' keys")
        dgrad = grad_rel(ranks[0]["grads"], ref["grads"])
        # the attention's step-1 gradients (the DiT's), which zero gates would make exactly 0
        attn = [max((g.abs().max().item() for k, g in grads.items() if ".attn." in k), default=None)
                for grads in (ref["grads"], ranks[0]["grads"])]
        if label in TP_RANDOM_START:
            check(all(a is not None and a > 0 for a in attn), f"train tp {label}: attention gradients max|grad| {attn}")
        del ranks[0]["grads"], ref["grads"]
        ms = [st[1] for st in ranks[0]["steps"]]
        peaks = [rank["peak"] / 2**30 for rank in ranks]
        share, shard_bytes = ranks[0]["share"], ranks[0]["shard_bytes"]
        held = max((h[0] / h[1] for rank in ranks for h in rank["held"]), default=0.0)
        print(f"[train-tp] {label}: {TP_RANKS} gloo ranks on one card, mesh {{'data': 1, 'model': {TP_RANKS}}}, "
              f"{TP_STEPS} steps, float32, cuDNN TF32 off; losses {losses} against {ref['losses']} in one process "
              f"(rel {', '.join(f'{x:.3g}' for x in loss_rel)}; bounds {TP_LOSS_REL[label]}, then {DP_LATER_LOSS}); "
              f"step 1's gradients assembled from the ranks {dgrad:.3g} of max|grad| from one process's (bound "
              f"{TP_GRAD_REL})" + (f", the attention's max|grad| {attn[0]:.6g} in one process, {attn[1]:.6g} from "
                                   f"the ranks" if attn[0] is not None else "") +
              f"; launches per rank and step {want}; K4 calls a rank {len(ranks[0]['k4'])} at "
              f"{TP_SITE}, K3 calls a rank {len(ranks[0]['k3'])} at {TP_NAF_SITE} on whole (gathered) tensors, "
              f"each held against its plain version on them (worst {held:.3g} of its bound); card: {smi}")
        print(f"[train-tp] {label}: ms by step (rank 0) {', '.join(f'{x:.1f}' for x in ms)} against "
              f"{', '.join(f'{x:.1f}' for x in ref['ms'])} in one process; peak memory a rank "
              f"{', '.join(f'{p:.2f}' for p in peaks)} GiB (one process {ref['peak'] / 2**30:.2f}); {share:.4%} of "
              f"the parameter bytes split, {shard_bytes / 2**20:.1f} MiB of parameters a rank")
        check(loss_rel[0] <= TP_LOSS_REL[label] and dgrad <= TP_GRAD_REL, f"train tp {label}: the first step differs")
        check(all(x <= DP_LATER_LOSS for x in loss_rel[1:]), f"train tp {label}: a later step's loss differs")
        check(share > TP_SHARE[label], f"train tp {label}: {share:.2%} of the parameter bytes split")
        record[label] = {"ranks": TP_RANKS, "batch": TP_PATHS[label] or TRAIN_BATCH, "ms_per_step": ms,
                         "one_process_ms_per_step": ref["ms"], "loss_rel": loss_rel, "grad_rel": dgrad,
                         "attention_max_abs_grad": attn,
                         "peak_memory_gib": peaks, "one_process_peak_memory_gib": ref["peak"] / 2**30,
                         "split_share": share, "shard_bytes": shard_bytes}
    print(f"[train-tp] torchrun for {'train dp (b), ' if first else ''}{', '.join(TP_PATHS)}: {seconds:.1f} s from "
          f"its start to its join, beside the phases between")

    hold_flash_sites("train-tp", dev, [(TP_SITE, torch.float32)], stats)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 18)
    q, k, v = (torch.randn(TP_SITE, generator=gen, device=dev) * 1.5 for _ in range(3))
    scale = TP_SITE[-1] ** -0.5
    k_ms = cuda_ms(lambda: FA.flash_mha_cuda(q, k, v, scale), reps=10)
    p_ms = cuda_ms(lambda: FA.flash_mha_plain(q, k, v, scale), reps=10)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    l_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale), reps=10)
    (b_ms, by), (t_ms, _) = flash_f32_bounds(TP_SITE)
    del q, k, v, qt, kt, vt
    print(f"[train-tp] K4 float32 {TP_SITE}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, sdpa {l_ms:.4f} ms "
          f"(TF32 matmuls off), {flash_f32_bound_text(TP_SITE)}; card: {smi}")
    stats[FLASH_ATTN]["train_tp"] = {"shape": list(TP_SITE), "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                                     "bound_ms": b_ms, "bound_by": by, "tf32x3_bound_ms": t_ms,
                                     "launches_per_rank_step": DIT_DEPTH}
    x, blocks, tmod, stacked = naf_stack_inputs(TP_NAF_SITE, TRAIN_NAF_LEVEL[0], dev, gen)
    k_ms = cuda_ms(lambda: NS.naf_stack_cuda(x, blocks, tmod, 1e-5), reps=10)
    p_ms = cuda_ms(lambda: NS.naf_stack_plain(x, stacked, 1e-5), reps=10)
    nbytes, flops = naf_stack_work(x, blocks)
    b_ms, by = bound(nbytes, flops, "float32")
    del x, blocks, tmod, stacked
    torch.cuda.empty_cache()
    print(f"[train-tp] K3 float32 {TP_NAF_SITE} K={TRAIN_NAF_LEVEL[0]}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
          f"least {b_ms:.4f} ms ({by}); card: {smi}")
    stats[NAF_STACK]["train_tp"] = {"shape": list(TP_NAF_SITE), "blocks": TRAIN_NAF_LEVEL[0], "ms": k_ms,
                                    "plain_ms": p_ms, "library_ms": None, "bound_ms": b_ms, "bound_by": by,
                                    "launches_per_rank_step": 1}
    return launches, record


def dryrun_child(out: str) -> int:
    """``chip_smoke.py --dryrun-child <out>``: ``dryrun 2`` (what ``python -m
    image_restoration_sde_tpu_torch.dryrun 2`` runs here) in a process of
    its own, TF32 off as in the script: two gloo ranks sharing the card as
    one model group (``model_parallel`` 2), one train step of
    ConditionalUNet nf 16 split between them (its channel LayerNorms and
    linear attention at full width on each rank: K1, K2a and K2b launch on
    both), held by the dry run against the one-process step on the card,
    each rank exactly its launches; the launches a rank and the split
    parameters' count go to ``out`` (JSON)."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, REPO)
    from image_restoration_sde_tpu_torch import dryrun

    got = dryrun.dryrun_multichip(2)
    with open(out, "w") as f:
        json.dump({"launches": got["launches"], "split": len(got["split"])}, f)
    return 0


def start_dryrun_tp(workdir, children):
    """Phase dryrun tp in the background (``dryrun_child``); returns what
    ``finish_dryrun_tp`` takes."""
    out = os.path.join(workdir, "dryrun_tp.json")
    return Background("dryrun tp", [sys.executable, os.path.abspath(__file__), "--dryrun-child", out], children), out


def finish_dryrun_tp(started, smi):
    """Join the dry run; K1, K2a and K2b launched on each rank.  Returns
    the ranks' launches."""
    from image_restoration_sde_tpu_torch.ops import LA_APPLY, LA_CTX, LAYERNORM

    child, out = started
    child.join()
    with open(out) as f:
        got = json.load(f)
    grew = got["launches"]
    check(all(grew[k.symbol] > 0 for k in (LAYERNORM, LA_CTX, LA_APPLY)), f"dryrun tp: launches {grew}")
    print(f"[dryrun-tp] 2 gloo ranks on one card, mesh {{'data': 1, 'model': 2}}, {got['split']} parameters "
          f"split; launches a rank {grew}; card: {smi}")
    return {k: 2 * n for k, n in grew.items()}


# ---------------------------------------------------------------- the native resampler and the tools
def phase_native(smi):
    """The native resampler (``data/native.py``) on the card's host: ``g++``
    found, the library built from the checkout's ``csrc/resize.cpp``, and
    ``imresize`` taking it (one native call each, counted) for matlab's
    antialiased x1/4 and torch-bicubic x2 of a NATIVE_SIDE px RGB image,
    each within NATIVE_BOUND of the numpy weights it replaces (float64
    sums in another order, rounded to float32), both timed."""
    from image_restoration_sde_tpu_torch.data import imresize, native

    check(native.available(), "native resampler: no g++ on the card's host")
    t0 = time.perf_counter()
    lib = native.build()
    built = time.perf_counter() - t0
    calls, call = [], native.resize_cubic_native

    def counted(*args):
        calls.append(args[1])
        return call(*args)

    img = np.random.default_rng(SEED + 30).random((NATIVE_SIDE, NATIVE_SIDE, 3)).astype(np.float32)
    native.resize_cubic_native = counted
    try:
        for name, fn, scale, a, aa, boundary in (("matlab x1/4", imresize.imresize, 0.25, -0.5, True, "symmetric"),
                                                 ("bicubic x2", imresize.torch_bicubic_resize, 2.0, -0.75, False,
                                                  "replicate")):
            t0 = time.perf_counter()
            got = fn(img, scale)
            n_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            plain = imresize._resize_axis(img, got.shape[0], scale, 0, a, aa, boundary)
            plain = imresize._resize_axis(plain, got.shape[1], scale, 1, a, aa, boundary).astype(np.float32)
            p_ms = (time.perf_counter() - t0) * 1e3
            err = float(np.abs(got - plain).max())
            print(f"[native] {name} {img.shape} -> {got.shape}: max|d| from the numpy weights {err:.3g} (bound "
                  f"{NATIVE_BOUND}); native {n_ms:.1f} ms, numpy {p_ms:.1f} ms on the host")
            check(got.shape == plain.shape and err <= NATIVE_BOUND, f"native resampler {name}: max|d| {err:.3g}")
    finally:
        native.resize_cubic_native = call
    check(len(calls) == 2, f"native resampler: {len(calls)} native calls for 2 resizes")
    print(f"[native] {lib} built in {built:.1f} s (g++ {native.compiler()}); imresize took the native path; "
          f"card: {smi}")
    native_lmdb(smi)


def native_lmdb(smi):
    """LMDB on the card's host: the synthetic deraining set (TRAIN_DATA's
    pixel pairs) written as GT and LQ LMDB roots by ``python -m
    image_restoration_sde_tpu_torch.create_lmdb``, one process a root, both
    at once; the deraining train YAML's dataset (LQGT, 128 px crops, flips
    and rotations) from the LMDB roots against the same dataset from the
    folders: every sample bit-equal at one epoch seed, and ms a sample for
    each (the LMDB's first read opens its environment)."""
    from image_restoration_sde_tpu_torch.data import datasets
    from image_restoration_sde_tpu_torch.data.synthetic import write_pairs

    opt = load_yaml(os.path.join(REPO, "configs", *TRAIN_PATHS["ir-sde"][0]))["datasets"]["train"]
    _, n, train_hw, _ = TRAIN_DATA["pixel"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lmdb_") as root:
        write_pairs(root, n, SEED + 31, *train_hw)
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-m", "image_restoration_sde_tpu_torch.create_lmdb", "--input",
                                   f"{root}/{sub}", "--output", f"{root}/{sub}.lmdb"], cwd=REPO,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for sub in ("GT", "LQ")]
        outs = [proc.communicate()[0] for proc in procs]
        seconds = time.perf_counter() - t0
        check(all(proc.returncode == 0 and f"wrote {n} images" in out for proc, out in zip(procs, outs)),
              f"create_lmdb: {outs}")
        samples, ms = {}, {}
        for kind, ext in (("img", ""), ("lmdb", ".lmdb")):
            ds = datasets.create_dataset({**opt, "phase": "train", "scale": 1, "data_type": kind,
                                          "dataroot_GT": f"{root}/GT{ext}", "dataroot_LQ": f"{root}/LQ{ext}"})
            ds.set_epoch_seed((SEED, 0))
            t0 = time.perf_counter()
            samples[kind] = [ds[i] for i in range(len(ds))]
            ms[kind] = (time.perf_counter() - t0) * 1e3 / len(ds)
    same = len(samples["lmdb"]) == len(samples["img"]) == n and all(
        np.array_equal(a[key], b[key]) for a, b in zip(samples["img"], samples["lmdb"]) for key in ("LQ", "GT"))
    check(same, "LMDB: the deraining train dataset's samples differ from the image folders'")
    print(f"[native] LMDB: create_lmdb wrote the {n} GT and LQ images of the synthetic deraining set in {seconds:.1f} "
          f"s (two processes); its train dataset ({opt['GT_size']} px crops) from the LMDB roots bit-equal to the "
          f"folders', {ms['lmdb']:.2f} ms a sample against {ms['img']:.2f} from PNGs on the host; card: {smi}")


def phase_tools(dev, smi):
    """The remaining tools on the card: ``interpolation`` (its entry point
    at TOOLS_SIDE px, T = TOOLS_T: TOOLS_T PNGs; the states on the card
    against the CPU's with the same injected noise within 1e-5 of max);
    ``app``'s restore callable (no gradio) on one TOOLS_SIDE px image with
    the deraining test YAML's seeded net (its sampler: exact launches);
    ``eval_parity`` on two seeded synthetic pairs with the deraining net's
    seeded weights in a ``.pth``, seeded LPIPS weights and
    ``--target-psnr 0``: its exit code must be 0 (exact launches);
    ``trace_summary`` on a ``torch.profiler`` capture of one restore of a
    64 px crop by a callable whose YAML samples TOOLS_TRACE_T steps.
    Returns the launches."""
    import torch
    import yaml

    from image_restoration_sde_tpu_torch import app, eval_parity, interpolation, trace_summary
    from image_restoration_sde_tpu_torch.data.io_utils import save_img
    from image_restoration_sde_tpu_torch.data.synthetic import write_pairs
    from image_restoration_sde_tpu_torch.models import ConditionalUNet, init_params_
    from image_restoration_sde_tpu_torch.ops import KERNELS
    from image_restoration_sde_tpu_torch.utils import lpips, profiling

    launches = {k.symbol: 0 for k in KERNELS}
    r = np.random.default_rng(SEED + 31)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as root:
        src, tgt = (os.path.join(root, f"{n}.png") for n in ("src", "tgt"))
        for path in (src, tgt):
            save_img((r.random((TOOLS_SIDE, TOOLS_SIDE, 3)) * 255).astype(np.uint8), path)
        t0 = time.perf_counter()
        rc = interpolation.main(["-s", src, "-t", tgt, "--save", os.path.join(root, "states"), "-T", str(TOOLS_T),
                                 "--device", str(dev)])
        seconds = time.perf_counter() - t0
        check(rc == 0 and len(os.listdir(os.path.join(root, "states"))) == TOOLS_T, "interpolation: its PNGs")
        a, b = (r.random((TOOLS_SIDE, TOOLS_SIDE, 3)).astype(np.float32) for _ in range(2))
        noise = torch.from_numpy(r.standard_normal((TOOLS_T, 1, TOOLS_SIDE, TOOLS_SIDE, 3)).astype(np.float32))
        card = interpolation.interpolate(a, b, T=TOOLS_T, device=dev, noise_seq=noise.to(dev)).cpu()
        host = interpolation.interpolate(a, b, T=TOOLS_T, device="cpu", noise_seq=noise)
        err = (card - host).abs().max().item() / host.abs().max().item()
        print(f"[tools] interpolation {TOOLS_SIDE} px, T={TOOLS_T}: {TOOLS_T} states written in {seconds:.2f} s; "
              f"the card's states against the CPU's with the same noise {err:.3g} of max (bound 1e-5)")
        check(bool(torch.isfinite(card).all()) and err <= 1e-5, "interpolation: the card's states differ")

        opt = load_yaml(CONFIG)
        opt.update(datasets={}, path={"pretrain_model_G": None})
        yml = os.path.join(root, "app.yml")
        with open(yml, "w") as f:
            yaml.safe_dump(opt, f)
        steps = int(opt["sde"].get("sample_T") or opt["sde"]["T"])
        want = counts(LAYERNORM=steps * LN_PER_FORWARD, LA_CTX=steps * ATTN_PER_FORWARD,
                      LA_APPLY=steps * ATTN_PER_FORWARD)
        restore = app.make_restore(yml, dev)
        img = (r.random((TOOLS_SIDE, TOOLS_SIDE, 3)) * 255).astype(np.uint8)
        before = request_counts()
        t0 = time.perf_counter()
        out = restore(img)
        seconds = time.perf_counter() - t0
        grew = {sym: n - before[sym] for sym, n in request_counts().items()}
        print(f"[tools] app restore callable ({opt['name']}, seeded, {steps} steps): {img.shape} uint8 -> "
              f"{out.shape} {out.dtype} in {seconds:.2f} s; launches {grew}")
        check(out.shape == img.shape and out.dtype == np.uint8 and grew == want, f"app: launches {grew}, {want}")
        for sym, c in grew.items():
            launches[sym] += c
        opt["sde"]["sample_T"] = TOOLS_TRACE_T
        with open(yml, "w") as f:
            yaml.safe_dump(opt, f)
        traced = app.make_restore(yml, dev)
        before = request_counts()
        with profiling.trace(os.path.join(root, "trace")):
            traced(img[:64, :64])
        grew = {sym: n - before[sym] for sym, n in request_counts().items()}
        traced_want = {k: n // steps * TOOLS_TRACE_T for k, n in want.items()}
        check(grew == traced_want, f"app under the profiler: launches {grew}, {traced_want}")
        for sym, c in grew.items():
            launches[sym] += c
        trace_rc = trace_summary.main([os.path.join(root, "trace"), "--top", "8", "--device", str(dev)])
        check(trace_rc == 0, "trace_summary: no card events in the capture")

        pth, lp = os.path.join(root, "seeded_G.pth"), os.path.join(root, "lpips.pth")
        setting = opt["network_G"]["setting"]
        torch.save(init_params_(ConditionalUNet(**setting), torch.Generator().manual_seed(SEED + 32)).state_dict(),
                   pth)
        torch.save(lpips.seeded_state_dict("alex", seed=SEED + 33), lp)
        write_pairs(os.path.join(root, "pairs"), 2, SEED + 34, shape=(TOOLS_SIDE // 2, TOOLS_SIDE // 2))
        want = {k: 2 * n for k, n in want.items()}
        before = request_counts()
        rc = eval_parity.main(["--data", os.path.join(root, "pairs"), "--pth", pth, "--setting", json.dumps(setting),
                               "--T", str(steps), "--lpips-pth", lp, "--target-psnr", "0", "--device", str(dev)])
        grew = {sym: n - before[sym] for sym, n in request_counts().items()}
        print(f"[tools] eval_parity: exit {rc}; launches {grew}; card: {smi}")
        check(rc == 0 and grew == want, f"eval_parity: exit {rc}, launches {grew} against {want}")
        for sym, c in grew.items():
            launches[sym] += c
    return launches


# ---------------------------------------------------------------- the benches
@contextlib.contextmanager
def recorded_flash_sites():
    """Record the (shape, dtype) of every K4 launch made inside the block."""
    from image_restoration_sde_tpu_torch.ops import flash_attention as FA

    sites, cuda = [], FA.flash_mha_cuda

    def rec(q, k, v, scale):
        sites.append((tuple(q.shape), q.dtype))
        return cuda(q, k, v, scale)

    FA.flash_mha_cuda = rec
    try:
        yield sites
    finally:
        FA.flash_mha_cuda = cuda


def hold_flash_sites(tag, dev, sites, stats):
    """K4 against its plain version at each recorded (shape, dtype) site,
    on seeded contiguous inputs, with phase 8's bounds: float32 1e-5 of
    max|ref|; bfloat16 twice the plain bf16 result's distance from the
    plain float32 one, and against flash_mha_tiled_plain at most
    FLASH_FLIP_SHARE of the elements past two ulps, none past the flip
    allowance."""
    import torch

    from image_restoration_sde_tpu_torch.ops import FLASH_ATTN
    from image_restoration_sde_tpu_torch.ops import flash_attention as FA

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 17)
    for shape, dtype in sorted(set(sites), key=str):
        scale = shape[-1] ** -0.5
        q, k, v = ((torch.randn(shape, generator=gen, device=dev) * 1.5).to(dtype) for _ in range(3))
        out, ref = FA.flash_mha_cuda(q, k, v, scale), FA.flash_mha_plain(q, k, v, scale)
        err = (out.float() - ref.float()).abs().max().item()
        share, worst = 0.0, 0.0
        if dtype == torch.float32:
            limit = 1e-5 * ref.abs().max().item()
        else:
            limit = 2 * (ref.float() - FA.flash_mha_plain(q.float(), k.float(), v.float(), scale)).abs().max().item()
            share, worst = flash_bf16_agreement(out, FA.flash_mha_tiled_plain(q, k, v, scale), q, k, v, scale)
        stats[FLASH_ATTN]["err"] = max(stats[FLASH_ATTN]["err"], err)
        print(f"[{tag}] K4 {str(dtype)[6:]} {shape}: max|dy|={err:.3g} (bound {limit:.3g}); vs tiled plain "
              f"{share:.3g} past two ulps, worst {worst:.3g} of the flip allowance")
        check(err <= limit and share <= FLASH_FLIP_SHARE and worst <= 1, f"{tag}: K4 {dtype} {shape} disagrees")
        del q, k, v, out, ref


def bench_launches(before):
    return {sym: n - before[sym] for sym, n in request_counts().items()}


def phase_bench_train(dev, smi):
    """``bench_train`` (what ``python -m image_restoration_sde_tpu_torch.
    bench_train`` runs) on each workload of BENCH_TRAIN at full width,
    BENCH_TRAIN_STEPS timed steps, torch's default TF32 settings, captured
    then eager: its line printed and checked (the captured form's img/s/GPU
    and MFU against the card's bf16 peak, the eager form's beside them, the
    card's name), exactly the forward's launches on every step of both
    forms (the first, the timed ones and the eager FLOP-counting one; the
    captured form's warm-up apart), none in the backward.  Returns the
    launches and the lines."""
    import torch

    from image_restoration_sde_tpu_torch import bench_train
    from image_restoration_sde_tpu_torch.ops import KERNELS

    per_step = {"unet": train_counts("ir-sde"), "refusion": train_counts("refusion")}
    launches, lines = {k.symbol: 0 for k in KERNELS}, {}
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # torch's default, as the bench runs alone
    try:
        for arch, pipe, batch, size in BENCH_TRAIN:
            before = request_counts()
            line = bench_train.run(dev, arch, pipe, batch, size, BENCH_TRAIN_STEPS)
            grew = bench_launches(before)
            want = {sym: n * (2 * BENCH_TRAIN_STEPS + 3) for sym, n in per_step[arch].items()}
            check(grew == want, f"bench train {arch}: launches {grew}, expected {want}")
            check(line["unit"] == "img/s/GPU" and line["form"] == "captured" and line["value"] > 0
                  and 0 < line["mfu"] < 1 and line["eager"]["value"] > 0 and 0 < line["eager"]["mfu"] < 1
                  and line["device"] == torch.cuda.get_device_name(0), f"bench train {arch}: line {line}")
            for sym, n in grew.items():
                launches[sym] += n
            lines[arch] = line
            print(f"[bench-train] {arch} {pipe}: {json.dumps(line)} (card: {smi})")
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    return launches, lines


def phase_bench_refusion(dev, smi, stats):
    """``bench_refusion`` (what ``python -m image_restoration_sde_tpu_torch.
    bench_refusion`` runs) for each arch of BENCH_REFUSION at
    BENCH_REFUSION_SIZE px, BENCH_REFUSION_STEPS steps, BENCH_REFUSION_REPS
    timed calls, torch's default TF32 settings.  Before the bench, one
    one-step call of its sampler on the same input records the sites of
    K1, K2 (the compressor), K3 (nafnet) and K4 (dit), and each kernel is
    held against its plain version there (``hold_sites``,
    ``hold_naf_sites``, ``hold_flash_sites``; these launches are not the
    path's); then the bench, with exactly its calls' launches, its line
    printed and checked.  Returns the launches and the lines."""
    import torch

    from image_restoration_sde_tpu_torch import bench_refusion
    from image_restoration_sde_tpu_torch.ops import KERNELS
    from image_restoration_sde_tpu_torch.sde import rng

    steps, calls = BENCH_REFUSION_STEPS, 2 + BENCH_REFUSION_REPS  # two warm-up calls
    enc = counts(LAYERNORM=COMPRESSOR_LN, LA_CTX=COMPRESSOR_ATTN, LA_APPLY=COMPRESSOR_ATTN)
    per_step = {"nafnet": counts(LAYERNORM=NAF_LN_PER_FORWARD, NAF_STACK=1), "dit": counts(FLASH_ATTN=DIT_DEPTH)}
    launches, lines = {k.symbol: 0 for k in KERNELS}, {}
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for arch in BENCH_REFUSION:
            score, compressor, label = bench_refusion.build(arch, dev)
            one_step = bench_refusion.make_sampler(score, compressor, steps, True, dev, run_steps=1)
            lq = torch.rand(1, BENCH_REFUSION_SIZE, BENCH_REFUSION_SIZE, 3, generator=rng.generator(SEED + 97, dev),
                            device=dev)
            with recorded_sites() as (ln, attn), recorded_naf_sites() as naf, recorded_flash_sites() as fl:
                one_step(lq, rng.generator(SEED + 98, dev))
            hold_sites(f"bench-refusion-{arch}", dev, ln, attn, stats, {})
            hold_naf_sites(f"bench-refusion-{arch}", dev, naf, stats)
            hold_flash_sites(f"bench-refusion-{arch}", dev, fl, stats)
            check(bool(naf) == (arch == "nafnet") and bool(fl) == (arch == "dit"), f"bench {arch}: sites {naf} {fl}")
            sampler = bench_refusion.make_sampler(score, compressor, steps, True, dev)
            before = request_counts()
            line = bench_refusion.bench(dev, sampler, label, 1, BENCH_REFUSION_SIZE, steps, BENCH_REFUSION_REPS)
            grew = bench_launches(before)
            want = {sym: calls * (steps * per_step[arch][sym] + enc[sym]) for sym in grew}
            check(grew == want, f"bench refusion {arch}: launches {grew}, expected {want}")
            check(line["unit"] == "img/s/GPU" and line["value"] > 0 and line["peak_gib"] > 0
                  and line["device"] == torch.cuda.get_device_name(0), f"bench refusion {arch}: line {line}")
            for sym, n in grew.items():
                launches[sym] += n
            lines[arch] = line
            print(f"[bench-refusion] {arch}: {json.dumps(line)} (card: {smi})")
            del score, compressor, sampler, one_step
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    return launches, lines


def load_yaml(path):
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    children = []  # every process the script starts: ended on the way out
    try:
        return smoke(children)
    finally:
        for proc in children:
            end(proc)


def smoke(children) -> int:
    import torch

    sys.path.insert(0, REPO)
    from image_restoration_sde_tpu_torch.ops import KERNELS

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    opt, latent_opt, dit_opt = (load_yaml(p) for p in (CONFIG, LATENT_CONFIG, DIT_CONFIG))
    refusion_setting = load_yaml(REFUSION_CONFIG)["network_G"]["setting"]
    sde_opt = opt["sde"]
    setting = opt["network_G"]["setting"]

    t_start = time.perf_counter()

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        torch.cuda.synchronize()
        print(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")
        return result

    smi = timed("device", phase_device)
    timed("build", phase_build)
    timed("native", phase_native, smi)
    stats = {k: {"err": 0.0, "ms": 0.0, "event_ms": None, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": "bytes",
                 "library_ms": None} for k in KERNELS}
    for k in KERNELS[:3]:  # K1, K2a, K2b: summed over sites
        stats[k]["event_ms"] = 0.0
    stats[KERNELS[0]].update(library_ms=0.0, by_path={})  # K1: F.layer_norm; K1 per path
    timed("kernels", phase_kernels, dev, stats, latent_opt, dit_opt)
    serving_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_serve_")
    # host-bound phases that launch little, in processes of their own beside
    # the phases that follow (joined before phase 19's kernel timings)
    ops = Background("ops", [sys.executable, os.path.abspath(__file__), "--ops-child"], children)
    dryrun = start_dryrun_tp(serving_dir.name, children)
    net = timed("net", phase_net, dev, setting, sde_opt)
    launches, captured = {}, {}  # captured: each path's chain graphs, captured against eager
    launches["deraining"], captured["deraining"] = timed("main path", phase_main_path, dev, net, sde_opt, smi)
    jobs, exports = timed("export deraining", phase_export_deraining, dev, net, sde_opt, serving_dir.name, stats)
    del net
    latent_net, compressor = timed("latent net", phase_latent_net, dev, latent_opt, refusion_setting, stats)
    launches["latent_dehazing"], captured["latent_dehazing"] = timed(
        "latent main path", phase_latent_main_path, dev, latent_net, compressor, latent_opt, smi)
    more = timed("export latent", phase_export_latent, dev, latent_net, compressor, latent_opt, serving_dir.name)
    jobs += more[0]
    exports.update(more[1])
    del latent_net, compressor
    timed("dit kernels", phase_flash, dev, stats, dit_opt)
    dit_net, dit_compressor = timed("dit net", phase_dit_net, dev, dit_opt)
    launches["dit"], captured["dit"], dit_sampler = timed("dit main path", phase_dit_main_path, dev, dit_net,
                                                          dit_compressor, dit_opt, smi)
    launches["tiled"], captured["tiled"] = timed("tiled", phase_tiled, dev, dit_sampler, dit_opt["sde"]["sample_T"],
                                                 len(dit_net.blocks), smi)
    del dit_net, dit_sampler
    torch.cuda.empty_cache()
    xl_opt = dit_xl_opt(dit_opt)
    xl_net, _ = timed("dit-xl net", phase_dit_net, dev, xl_opt, "dit-xl-net", False)
    launches["dit_xl"], captured["dit_xl"] = timed("dit-xl main path", phase_dit_xl_main_path, dev, xl_net,
                                                   dit_compressor, xl_opt, smi)
    del xl_net, dit_compressor
    torch.cuda.empty_cache()

    launches["linear_attention"] = timed("linear attention", phase_lin_attn, dev, stats)
    denoise_opt, stereo_opt, bokeh_opt = (load_yaml(p) for p in (DENOISE_CONFIG, STEREO_CONFIG, BOKEH_CONFIG))
    denoise_net = timed("denoise net", phase_denoise_net, dev, denoise_opt, stats)
    server = start_server(jobs[0]["path"], children)  # it loads and warms beside the next phases
    launches["denoising"], captured["denoising"] = timed("denoise main path", phase_denoise_main_path, dev,
                                                         denoise_net, denoise_opt, smi)
    more = timed("export denoising", phase_export_denoising, dev, denoise_net, denoise_opt, serving_dir.name)
    jobs += more[0]
    exports.update(more[1])
    del denoise_net
    torch.cuda.empty_cache()
    launches["serve"], served, answers = timed("serve", phase_serve, dev, server, smi, jobs[0]["path"],
                                               serving_dir.name)
    launches["bench"], benched = timed("bench", phase_bench, dev, smi, stats)
    launches["bench_train"], benched_train = timed("bench train", phase_bench_train, dev, smi)
    more = timed("bench refusion", phase_bench_refusion, dev, smi, stats)
    launches["bench_refusion"] = more[0]
    print(f"[benches] {json.dumps({'bench_train': benched_train, 'bench_refusion': more[1]})}")
    stereo_net = timed("stereo net", phase_stereo_net, dev, stereo_opt, stats)
    launches["stereo_sr"], captured["stereo_sr"] = timed("stereo main path", phase_stereo_main_path, dev, stereo_net,
                                                         stereo_opt, smi)
    del stereo_net
    bokeh_net, bokeh_compressor = timed("bokeh net", phase_bokeh_net, dev, bokeh_opt, stats)
    launches["latent_bokeh"], captured["latent_bokeh"] = timed("bokeh main path", phase_bokeh_main_path, dev,
                                                               bokeh_net, bokeh_compressor, bokeh_opt, smi)
    del bokeh_net, bokeh_compressor
    torch.cuda.empty_cache()
    timed("ops", ops.join)
    launches["dryrun_tp"] = timed("dryrun tp", finish_dryrun_tp, dryrun, smi)

    train_opts = {label: load_yaml(os.path.join(REPO, "configs", *spec[0])) for label, spec in TRAIN_PATHS.items()}
    for label in ("ir-sde", "refusion"):
        train_ds = train_opts[label]["datasets"]["train"]
        check((train_ds["batch_size"], train_ds["GT_size"]) == (TRAIN_BATCH, TRAIN_SIZE), f"{label}: {train_ds}")
    timed("train kernels", phase_train_kernels, dev)
    timed("train kernels K4", phase_flash_backward, dev, stats)
    timed("train nets", phase_train_nets, dev, train_opts)
    train_record, trained = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as workdir:
        timed("train data", write_train_data, os.path.join(workdir, "data"))
        for label, o in train_opts.items():
            pretrain_l = trained["compressor"] if label in ("latent", "dit") else None
            keep = {} if label == "ir-sde" else None
            launches[f"train_{label}"], train_record[label], trained[label] = timed(
                f"train main path {label}", phase_train_main_path, dev, label, o, workdir, smi, pretrain_l, keep)
            if keep:
                launches["train_dp"], train_record["dp"], dp_pending = timed("train dp", phase_train_dp, dev, label,
                                                                             o, workdir, smi, keep)
                del keep
            if label == "dit":  # its torchrun runs beside the phases up to finish_train_tp
                tp = timed("train tp", phase_train_tp, dev, train_opts, workdir, smi, trained["compressor"],
                           children, dp_pending)
        launches["demo"], demo_record = timed("demo", phase_demo, dev, workdir, smi, stats)
        print(f"[demo] {json.dumps(demo_record)}")
        # the exported artifacts' loading process beside the evaluation
        artifacts = start_artifacts(serving_dir.name, jobs, children, answers)
        eval_launches, eval_record = timed("eval", phase_eval, dev, workdir, smi, trained, stats, children)
        launches["artifacts"], launches["dp_artifact"], loaded = timed("artifacts", phase_artifacts, dev, artifacts,
                                                                        jobs, smi)
        serving_dir.cleanup()
        print(f"[serving] {json.dumps({'export': exports, 'artifacts': loaded, 'serve': served, 'bench': benched})}")
        launches["train_tp"], train_record["tp"] = timed("train tp join", finish_train_tp, dev, tp, smi, stats)
        print(f"[train] {json.dumps(train_record)}")
    launches.update(eval_launches)
    print(f"[eval] {json.dumps(eval_record)}")
    print(f"[captured] {json.dumps(captured)}")
    launches["tools"] = timed("tools", phase_tools, dev, smi)

    report = []
    for k in KERNELS:
        by_path = {path: grew[k.symbol] for path, grew in launches.items()}
        report.append({
            "name": k.symbol, "route": "cuda", "source": k.source, "replaces": k.replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": stats[k]["err"], "ms": stats[k]["ms"], "plain_ms": stats[k]["plain_ms"],
            "bound_ms": stats[k]["bound_ms"], "bound_by": stats[k]["bound_by"],
            "library_ms": stats[k]["library_ms"],
        })
        if stats[k]["event_ms"] is not None:  # the earlier figure, one launch between CUDA events
            report[-1]["event_ms"] = stats[k]["event_ms"]
        if "by_path" in stats[k]:  # K1 over one forward of each path's score net
            report[-1]["by_path"] = stats[k]["by_path"]
        if "train" in stats[k]:  # K4 at the DiT-L/2 train shape: forward, streamed backward, sweep
            report[-1]["train"] = stats[k]["train"]
        if "train_tp" in stats[k]:  # K4 on a rank's heads (DiT-L/2), K3 on the gathered level (NAFNet)
            report[-1]["train_tp"] = stats[k]["train_tp"]
        if "float32" in stats[k]:  # K4 at each float32 shape of phase 8
            report[-1]["float32"] = stats[k]["float32"]
        if "bfloat16_d72" in stats[k]:  # K4 at each bfloat16 head-dim-72 shape of phase 8
            report[-1]["bfloat16_d72"] = stats[k]["bfloat16_d72"]
    print(f"[done] {time.perf_counter() - t_start:.1f} s; ms / plain_ms / bound_ms / library_ms: K1, K2a, K2b "
          f"summed over one deraining UNet forward's sites at batch {BATCH}, {SIZE}px, bf16, from CUDA graphs "
          f"of 20 calls (event_ms: one launch between CUDA events, the earlier figure); K3 one call at "
          f"batch {LATENT_BATCH}, 8x8x512, 28 blocks, bf16 (one latent NAFNet forward at {LATENT_SIZE}px); K4 one "
          f"call at {FLASH_SHAPES[0]} bf16 (one attention site of a DiT-L/2 forward at batch {DIT_BATCH}, "
          f"{DIT_SIZE}px), library_ms F.scaled_dot_product_attention, and bfloat16_d72 each bf16 head-dim-72 site of "
          f"phase 8 (DiT-XL/2's head); K5 (irsde_lin_attn_*) one call of each "
          f"pass at {LIN_ATTN_SHAPES[0]} bf16 from CUDA graphs, bound_ms half the op's bytes and FLOP each; "
          f"K1's by_path: one bf16 forward of each path's score net, from CUDA graphs")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--artifact-child"]:
        sys.exit(artifact_child(sys.argv[2]))
    if sys.argv[1:2] == ["--ops-child"]:
        sys.exit(ops_child())
    if sys.argv[1:2] == ["--dryrun-child"]:
        sys.exit(dryrun_child(sys.argv[2]))
    if sys.argv[1:2] == ["--dp-child"]:
        sys.exit(dp_child(*sys.argv[2:5]))
    if sys.argv[1:2] == ["--ranks-child"]:
        sys.exit(ranks_child(*sys.argv[2:]))
    sys.exit(main())
