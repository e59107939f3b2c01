#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # the whole run, one card
    python3 chip_smoke.py --quick    # card, build and kernel checks only

Phases, each printing its own line with the seconds it took:

1. card    — ``nvidia-smi`` name and power limit; TF32 off.
2. build   — the six hand-written kernel sources from
             ``src/repro_torch/kernels/csrc`` with ``nvcc`` (in parallel;
             the three merged-segment kernels with their fp32 and
             quantized entry points), with ``-Xptxas -v`` resources.
3. kernels — each kernel against its plain PyTorch version on the card:
             the convs over strides {1,2,3} × k {1,2,3,5,7,11}, ragged
             shapes, every activation, no bias, and the depthwise /
             channel-multiplier / grouped cases (``DW_CASES``: the
             depthwise kernel's scalar and vector paths); merged_ffn over
             M {1,8,37,1024} × D {32,96,576} × R {1,24,576,1152,1536}
             (1536: the replaced path's unmerged SmolLM FFN), at
             D 2560 × R {24,2560,7680} × M {8,1024} (RecurrentGemma), at
             D 2561 (rows not 16-byte aligned) × M {1,8,63,64,65,129,1024}
             (both tiles and their boundary) × R {24,2560} and R 7680 at
             M 8, and twice on the same inputs at D 2560, M {8,1024}:
             bitwise equal (the split reductions sum in a fixed order).
             Then the
             quantized variants in int8, w8a8 and fp8 against ``*_qref``:
             the convs over strides {1,2,3} × k {1,3,5,7} with the same
             cases, merged_ffn over M {1,8,37,1024} × D {96,576} ×
             R {24,576} and its four type pairs (fp32 or int8 panel × int8
             or e4m3 factors) at D 2560 × M {8,1024} × R {24,2560},
             within the same tolerance over the dequantized
             operands; ``quant.quantize_int8`` on the card bitwise
             equal to the CPU's; rmsnorm over M {1,8,37,1024} ×
             D {32,512,576,2560,2561}; rglru_scan over B {1,8} ×
             S {1,7,128,512} × C {32,256,2560,2561} (also bitwise), and
             its backward kernel at the same shapes, bitwise its plain
             version (``rglru_scan_bwd_ref``) and the plain scan's
             autograd;
             flash_attention over BH {1,8,80} × S {1,7,16,128,256,1000} ×
             D {32,64,256}, causal and not, with grouped and multi-query
             kv heads; ``benchmarks/run.py``'s three shapes; the
             gradient of ``flash_attention_op`` through the kernel; the
             bf16 bodies (:func:`bf16_sweep`: rmsnorm over M {1,37} ×
             D {32,576,2561}, g bf16 and fp32; flash_attention at
             D {36,64,100,256} × S {1,7,130}, grouped and multi-query,
             causal and not; each element within one bf16 ulp of the
             plain version, beyond the attention's fp32 allowance; the
             log's ``max_rel_err`` is then the most ulps); and
             twice on the same inputs, bitwise equal, flash_attention at
             the path's four shapes, depthwise_conv (fp32 and w8a8) at
             three MobileNetV2 units and merged_conv (fp32 and w8a8) at
             four, two of them split.  merged_conv and its four quantized
             type pairs also run ``CONV_CASES``, which must reach every
             instance of its launch plan (each tile, copy width, the
             dense panel, a split reduction, the int8 mma and int8 x int8
             in TF32), at the same tolerance; among them the DDPM UNet's
             distinct unit shapes (``UNET_CASES``: the Cin-4 stem, the
             Cout-3 output conv, the 768- and 384-channel concat convs,
             the merged 11×11 stride-2 unit).  Gradients
             (:func:`gradient_sweep`): every input's gradient through each
             op (the kernel forward, the plain version's gradient
             backward) against the plain version's autograd within
             ``RTOL · max|gradient| + ATOL``, one launch in the forward and
             none in the backward (the scan: its backward kernel, one
             launch, every gradient bitwise): the six fp32 ops (the convs at
             MobileNetV2's units, merged_ffn, rmsnorm and flash_attention
             at SmolLM-135M's replaced path, rglru_scan at (8, 128, 2560))
             and the three quantized bodies under w8a8.
4. compress — the main path: ``python -m repro_torch.compress`` on
             MobileNetV2 at full width (224², width 1.0, 1000 classes,
             batch 8, ``--max-span 6``, budget 0.6), latency tables timed
             on the card through the kernels (wall-clock oracle).
5. serve   — the artifact loaded on the card classifies seeded batches
             through ``execute``; every batch's logits are held against the
             same artifact on the CPU (plain versions) and against
             ``apply_replaced`` of the plan (merge exactness); CUDA-event
             latency of the original against the merged network, and
             their device times as CUDA-graph replays beside the
             predicted speedup.  The kernels' launch counts of phases 4-5
             (counted from zero) must both be > 0.
6. main-path kernels — each conv unit of the merged MobileNetV2 graph, at
             its shape and weights: kernel against plain version, and the
             time of kernel, plain version and the one-call library
             yardstick (``F.conv2d``, cuDNN, TF32 off) beside the bound
             and, for merged_conv, the launch plan it took (per unit in
             ``units.json``).
             Times are device times with a cold L2: 50 calls, each after
             a read that evicts the L2, captured in a CUDA graph and
             replayed, less the evicting reads alone, the two graphs
             replayed in 10 adjacent pairs and the median difference
             taken (:func:`kernel_time`; since PR 29, before which they
             were timed one after the other); so the inputs come from
             HBM, as the byte bound prices them.
7. resnet34 — ResNet34 at full width with the analytic oracle: lower,
             execute on the card (pool, projection shortcuts, the 7×7
             stride-2 stem), and hold against the CPU port; then each of
             its merged_conv units at batch 8 as in phase 6 (no plain
             version), against cuDNN (``resnet34.json``).  (b) the same
             compress on tables timed on the card (``--oracle
             wallclock``, every probe through merged_conv or the pool's
             plain version; no retry, no quarantine): probes, signatures
             and seconds, the card-timed plan beside the analytic one,
             the artifact held against the CPU port and
             ``apply_replaced`` of its plan, and the original's and the
             merged graph's CUDA-graph replays beside the predicted
             speedup (``resnet34_wallclock.json``).
8. lm compress — the transformer path: SmolLM-135M at full width in fp32
             (random weights, seed 0), ``CostEnv(batch=8, seq=128)``,
             ``method="depth"``, latency tables timed on the card (the
             lowrank probes through merged_ffn), budgets 0.6, 0.7, ... up
             to the first whose plan merges an FFN; that artifact is
             saved.  The ``layermerge`` 0.6 plan's census is printed
             beside it.
9. lm serve — the artifact loaded on the card serves 8 seeded prompts of
             16 tokens with 32 greedy tokens (KV cache) through the
             captured ``serve_loop`` (one CUDA-graph replay per prompt
             position and per generated token) and through
             ``serve_loop_pertoken`` (eager), which must give the same
             tokens, the captured decode no slower (:func:`serve_both`:
             prefill ms and decode tok/s of both loops, the capture's
             seconds, launches per step counted at the capture, and the
             captured decode's device-busy share from torch.profiler);
             every step's logits, teacher-forced with the card's tokens,
             are held against the same artifact on the CPU, and the
             prefill forward against ``replaced_apply``; the original
             model is served the same way.  merged_ffn's launch count
             over phases 8-9 (counted from zero) must be > 0.
10. merged_ffn shapes — the kernel at the path's shapes (each lowrank
             unit at M = 8, one decode step; one at M = 1024, a probe):
             kernel, plain version, ``torch.addmm(x, x @ U, V)`` (two
             cuBLAS calls) and the bound, as device times (phase 6), and
             the host microseconds an eager call takes.  merged_ffn's
             operations are priced at the tensor-core rate that gives its
             accuracy (``TC_RATES``: 3xTF32 for fp32 × fp32), as are
             merged_conv's and flash_attention's, every other kernel's at
             the fp32 FFMA rate; each row names its rate.
11. q serve — the quantized CNN path: MobileNetV2 as in phase 4 through
             the CLI with ``--quantize w8a8`` and phase 4's oracle (no
             signature timed twice), budgets 0.6, 0.5, 0.4 until the plan
             quantizes a dense and a depthwise unit; the v3 artifact
             classifies the seeded batches on the card, held against (a)
             the CPU port of the same artifact within NET_RTOL + 2·δ, δ
             being the CPU port's own activation rounding (its logits
             against the same artifact with w8a8 units run as int8): an
             activation code can differ by one step between the two
             devices where fp32 reassociation moved a value across a
             rounding boundary, and each device's rounding error is of
             δ's size, so the two differ by at most about 2·δ; (a') the
             CPU port fed the card's activation codes (:class:`ActCodes`)
             within NET_RTOL; (b) the fp lowering of the same plan within
             0.25 (the reference's criterion).  Launch counts of the
             quantized kernels over this phase must be > 0.
12. quantized conv units — each quantized unit of one forward, on its
             card input: kernel against plain version (phase-3
             tolerance), and the kernel, the activation quantization pass,
             the whole op, the fp32 kernel, the plain version and
             ``F.conv2d`` on the dequantized operands beside the bound at
             narrow widths, as device times.
13. lm q serve — SmolLM-135M w8a8 with ``method="depth"`` under the
             decode-shaped ``CostEnv(batch=8, seq=1)`` (phase 8's env
             prices every segment compute-bound and gets no sibling); if
             the DP picks no w8a8 lowrank unit at any budget, phase 8's
             plan with its lowrank segments set to w8a8.  The v3 artifact
             serves the prompts of phase 9 through both loops as phase 9
             does; every step's logits,
             teacher-forced, are held against the CPU port as in phase 11
             (a) and (a'), and each unit of the last step against its
             plain version on its card input; merged_ffn_q's launches over
             this phase must be > 0; decode tok/s beside the fp plan's.
14. merged_ffn_q shapes — each quantized lowrank unit at M = 8 timed as
             in phase 12 (``torch.addmm`` on the dequantized operands),
             and one unit's kernel alone in each variant (fp32, int8,
             w8a8, fp8).

15. rg compress — RecurrentGemma-2B at full width in fp32 and
             ``RG_LAYERS`` (13) of its 26 layers, the block pattern kept
             (rglru, rglru, attn_local; d 2560, 10 heads over 1 kv head,
             GeGLU 7680, vocab 256000; random weights drawn on the
             card, seed 0; phase 26 serves all 26 at bf16),
             ``CostEnv(batch=8, seq=128)``, ``method="depth"``, tables
             timed on the card (probes through rmsnorm, rglru_scan,
             flash_attention and merged_ffn), phase 8's budget ladder to
             the first plan that merges an FFN; the artifact is saved.
             Where the card's tables merge no FFN at any budget the phase
             fails, naming the ladder (a slow merged_ffn shows there).
16. rg serve — the artifact on the card serves phase 9's protocol (8
             prompts x 16 tokens, 32 greedy tokens, RG-LRU state and the
             local KV ring buffer; both loops, as in phase 9); every
             step's logits, teacher-forced, against the CPU port of the
             artifact (its loaded tensors copied to the host since PR 29;
             ``CPU_ROWS`` prompts, the first ``RG_CPU_STEPS``
             steps: the prompt and 8 decode steps), and the prefill
             forward against ``replaced_apply``; CUDA-event prefill and
             decode beside the original model; launches per decode step
             (counted at the capture) and per prefill forward.  The launches of rmsnorm,
             rglru_scan, flash_attention and merged_ffn over phases 15-16
             (counted from zero) must each be > 0.
17. rg kernels — rmsnorm, rglru_scan and flash_attention at the path's
             shapes (and SmolLM's), the scan's backward kernel at 8 × 128
             (beside its plain version, and the eager plain gradient
             that the train step took before the kernel), merged_ffn at D
             2560: kernel, plain version, library yardstick
             (``F.rms_norm``, ``F.scaled_dot_product_attention``,
             ``addmm``; none for the scan or its backward) and bound
             (attention's operations at the 3xTF32 rate), as device
             times; the new kernels' rows of the ``kernels`` line are
             their probe shapes (the backward's launches: phase 24's).
18. lm requests — phase 8's SmolLM-135M artifact serves
             ``ragged_prompts(0, 24, 4, 32, vocab)`` and phase 15's
             RecurrentGemma-2B artifact 8 such prompts through
             ``serve_requests(slots=8, tokens=32)``: sustained tok/s,
             rounds and dispositions; every request's tokens must equal
             ``serve_loop`` of its prompt alone at batch 1, and the last
             round served again with one slot's logits made NaN at
             generation index 2 must report that request alone aborted
             at 2, every other token-identical to the clean run.
19. lm continuous — the same artifacts and prompts through the
             continuous engine (``serve_continuous(slots=8, chunk=8,
             tokens=32)``, one captured chunk step, a position per
             slot): (a) all arriving at 0 on the real clock, sustained
             tok/s beside phase 18's, chunks and admissions; (b) a
             seeded Poisson trace at 20 requests/s, p50 and p99 latency;
             (c) on a ``TickClock``, ``nan@serve.nan`` on a request
             admitted mid-stream with ``delay@serve.arrival`` and
             ``delay@serve.chunk`` rules; (d) ``raise@serve.worker`` at
             the 3rd chunk through ``serve_with_failover``.  Every
             request's tokens must equal phase 18's single-prompt
             ``serve_loop``, the poisoned one alone aborted at 2, both
             delay rules fired, one failover replayed bit-identically,
             one graph replay per step, and the launches of (a), counted
             from zero, show ``rmsnorm`` and ``merged_ffn``; a
             torch.profiler trace of four chunks gives the captured
             step's device time and (a)'s busy share.

20. importance — the paper's Eq. 4 on the card (fine-tune each replaced
             network a few Adam steps, score ``exp(ΔPerf)``): (a)
             MobileNetV2 as in phase 4 with ``distill_loss`` (the untouched
             network as teacher), ``neg_loss_perf``, base 0, 4 steps at lr
             1e-3 on seeded (8, 224, 224, 3) batches, phase 4's oracle:
             210 scalar fine-tunes (every span holds BN, so the host
             declines the batch), the DP at 0.6 beside phase 4's magnitude
             plan, the plan lowered (merged_conv, depthwise_conv) and held
             against ``apply_replaced``, its artifact reloaded and timed
             as a CUDA-graph replay against phase 5's original, and the
             first 16 fine-tunes run again under deterministic cuDNN,
             bitwise equal; (b) the reference quickstart's protocol
             (``tiny_resnet(4, 16, 8, (2, 2))``, the quadrant-mean task:
             150 pre-training steps, compress at 0.6 with
             ``accuracy_perf`` Eq. 4 at 5 steps on a wall-clock oracle,
             150 fine-tuning steps, merged accuracy equal to replaced, the
             artifact reloaded) and the vmapped span batches forced
             against the sequential engine (rtol 1e-6, atol 1e-7); (c)
             SmolLM-135M at full width and the first ``EQ4_LM_LAYERS``
             (15) of phase 8's 30 layers (since PR 29; ``method="depth"``
             at the first budget from phase 8's on that merges an FFN,
             beside the magnitude plan of the same layers on phase 8's
             timings) with ``distill_loss`` on seeded (8, 128) tokens, 8
             steps: 15 fine-tunes through ``replaced_apply`` whose
             forwards launch merged_ffn, rmsnorm and flash_attention (each
             > 0, counted from zero), the plan and the original served as
             phase 9 serves.
             Each part prints probes, fine-tunes and batches, seconds and
             ms per fine-tune step, peak device memory, a torch.profiler
             busy share over one fine-tune and the importance column's
             min, median and max (``importance.json``).
21. tables — the crash-safe table build on the card, in a fresh
             ``build/chip_smoke/tables/``: (a) phase 4's compress through
             the CLI with ``--cache-dir``, twice: the first run publishes
             and leaves no journal, the second is a cache hit that times
             no signature (``T_orig`` included), with run 1's plan,
             ``T_orig`` and artifact fingerprint; (b) a child process
             (``python -m repro_torch.testing.faults --child``, phase 4's
             host, wall-clock oracle) killed at its 40th journaled bucket
             (``exit@tables.bucket:40``: status 17, one journal), resumed
             here: at least 39 journal hits, every journaled signature's
             seconds bitwise in the resumed tables and in ``T_orig``, the
             journal gone, a third build a bitwise cache hit; the same
             under the analytic oracle, bitwise an uninterrupted build;
             (c) a ``delay@probe.time`` straggler at 4x a 1 s budget
             retried and not quarantined, ``raise@probe.time`` on 3
             attempts quarantining exactly the first bucket to the
             analytic estimate, flagged in ``Tables.provenance`` and the
             artifact's ``probe_provenance`` (which reloads and runs), a
             truncated cache file and a truncated artifact each renamed
             to ``.corrupt`` (the artifact's error naming it and the
             re-publish); (d) phase 8's SmolLM-135M depth compress with
             ``--cache-dir``, twice: a cache hit with the same plan, and
             the seconds of the host's fingerprint; (e) phase 20 (b)'s
             quickstart Eq. 4 tables (analytic latency, a ``cache_token``)
             in a child killed at its 3rd ``tables.importance`` hit, then
             resumed: the importance column bitwise an uninterrupted
             build's.  Launches counted from zero: merged_conv and
             depthwise_conv > 0 over (a)-(c), merged_ffn, rmsnorm and
             flash_attention > 0 over (d).  Seconds, signatures timed,
             journal hits, retries and quarantines in ``tables.json``.
22. unet — the DDPM UNet as the reference builds it (``zoo.ddpm_unet()``:
             32², base 128, two down and two up levels with concat skips,
             GN(8) and SiLU after every conv but the output conv, one
             spatial attention barrier at 8×8, a 4-channel input; about
             11.7 M parameters, not Ho et al.'s 35.7 M UNet): (a)
             ``python -m repro_torch.compress --arch ddpm_unet --oracle
             wallclock --budget-ratio 0.6 --batch 8``, the convs timed
             through merged_conv and the attention and upsample barriers
             through their plain probes, no retry and no quarantine;
             probes, signatures, seconds, the plan and its units,
             ``T_orig`` and the predicted speedup; the graph must hold an
             upsample, an attention unit, a unit with ``concat_from`` and
             a conv with a group norm; (b) the artifact on the card runs
             two seeded (8, 32, 32, 4) batches through ``execute``, held
             against the same artifact on the CPU and ``apply_replaced``
             of its plan within NET_RTOL; (c) CUDA-event latency and
             CUDA-graph replay of the original and the merged network,
             the measured speedup beside the predicted one, the merged
             forward's busy share from torch.profiler; merged_conv's
             launches over (a)-(c), counted from zero, must be > 0; (d)
             each conv unit at its shape and weights as in phase 6
             (merged_conv, and depthwise_conv at the identity 1×1 units
             that pruned layers lower to): kernel, plain version, cuDNN,
             bound and launch plan (``unet.json``; the ``kernels`` line's
             ``merged_conv@ddpm_unet`` and ``depthwise_conv@ddpm_unet``
             rows).

23. archs — the reference's other transformer families, fp32, weights
             from seed 0, direct table builds with ``strict_probes()``
             (0 retries, 0 quarantines): (a) granite-moe-1b-a400m at full
             width (``ARCH_GRANITE_LAYERS`` = 12 of its 24 layers, d 1024,
             16/8 heads of 64, 32 experts top-8, ``moe_dff`` 512, vocab
             49155, tied; drawn on the card) compressed at budget 0.6 under ``CostEnv(batch=8, seq=128)``
             with ``method="layermerge"`` (MoE and attention sublayers
             are prune-or-keep; the depth baseline keeps every layer of
             a chain with no FFN and meets no budget under 1), lowered in
             memory (no artifact file: phase 16 covers multi-GB artifact
             I/O on the card, the CPU tests these kinds' round trips);
             plan and original served through the captured
             ``serve_loop`` and ``serve_loop_pertoken`` (8 seeded
             16-token prompts, 32 tokens: the same tokens), the served
             logits teacher-forced on the card against the CPU port with
             every MoE call's routing recorded (``RouteLog``: choices and
             keep flags that differ, the smallest top-k margin, dropped
             pairs a step at the config's 1.25); where a choice differs
             the CPU port replays the card's routing through ``route``'s
             test hook and that run is held to NET_RTOL; then
             ``ragged_prompts(0, 24, 4, 32, vocab)`` through
             ``serve_requests`` at capacity factor 8.0 (nothing drops),
             every request equal to its prompt served alone; (b)
             xlstm-125m at full size (12 layers, sLSTM at 3 and 9, d 768,
             4 heads of 192, vocab 50304, tied) likewise, plus the
             continuous engine (8 slots, chunks of 8) on the same 24
             prompts (every request equal to its prompt alone: the fresh
             state reset) and the captured decode bitwise equal to the
             eager one at every step; (c) qwen2-vl-7b at full width, 4
             of its 28 layers (d 3584, 28/4 heads of 128, QKV bias,
             SwiGLU 18944, vocab 152064, untied, embeddings frontend,
             M-RoPE), at the tightest budget from 0.6 up whose plan
             merges an FFN, 16 seeded embedding positions and 32 more
             through ``executor.decode_step`` with three distinct M-RoPE
             streams, held against the prefill forward, the CPU port
             (its first 4 rows) and ``replaced_apply``; each model's
             decode step as a captured graph (device ms, tok/s, busy
             share).  rmsnorm must launch
             in (a)-(c), flash_attention in (a) and (c), merged_ffn in
             (c).  (d) rmsnorm at D {1024, 768, 3584} × M {1024, 8},
             flash_attention at ``ARCH_ATTENTION``, merged_ffn at the
             served D 3584 unit × M {8, 1024}: kernel, plain version,
             library call and bound (``archs.json``; the ``kernels``
             line's ``@archs`` rows).
24. train — LM training (``repro_torch.train``), fp32, data from
             ``SyntheticTokens(vocab, B, S, seed=0)``: (a) SmolLM-135M at
             full width and ``TRAIN_LAYERS`` (15) of its 30 layers (since
             PR 29; 30 and 134.5 M parameters before), batch 8 x seq 1024 (the
             reference's ``examples/train_lm.py`` "100m" preset), AdamW
             lr 1e-3, warmup 20, 40 steps, weight decay 0.01, under
             ``train_loop`` (checkpoints every 10, keep 3) with a
             ``RuntimeError`` at step 25: exactly one restart, the state
             restored from step 20 bitwise what was saved
             (:class:`CkptSpy`), the loss of the last 5 steps under the
             first 5; the replayed steps' max |Δloss| and the gradient
             leaves that differ between two runs of one step; median ms
             a step and tok/s, steps with a checkpoint, the background
             writes' seconds, peak memory, launches a step (rmsnorm
             2L + 1, flash_attention L, as many as a forward: none in the
             backward), busy share over 3 steps; one loss and its
             gradients on 1 x 256 tokens against the CPU port (1e-5
             relative; 1e-4 of each leaf's max |g|); (b) phase 8's
             artifact fine-tuned 10 steps at 8 x 1024 through
             ``make_compressed_forward`` (merged_ffn at M 8192): the loss
             drops; the tuned graph saved, reloaded (logits bitwise) and
             served through the captured ``serve_loop``, 32 tokens of
             batch 8 equal to the eager decode of the tuned graph; (c)
             RecurrentGemma-2B at full size (weights drawn on the card),
             batch 8 x seq 128, 4 steps
             of ``make_train_step`` (no checkpoint): finite losses, ms a
             step, busy share, peak memory, launches a step (rglru_scan
             18, rglru_scan_bwd 18, flash_attention 8), the step's
             elementwise launches and device-to-device copies
             (torch.profiler) beside ``PLAIN_GRAD_STEP``'s; full width
             at 3 layers against the CPU port on 1 x 64 tokens as in
             (a); (d) rmsnorm (8192,
             576), flash_attention (8, 1024, 9, 64) over 3 kv heads and
             merged_ffn (8192, 576) at the plan's rank: kernel, plain
             version, library call and bound (``train.json``; the
             ``kernels`` line's ``@train`` rows, with launches over
             (a)-(c)).  Phase 3 holds the three shapes against their
             plain versions too.
25. dist  — the distributed table build
             (``repro_torch.core.dist_build``) of MobileNetV2 as phase 4
             builds it (224², batch 8, ``--max-span 6``: 262 probes, 127
             signatures), workers on the card: (a) two workers at once
             under the analytic oracle, the tables bitwise a
             single-process build's, a second call a cache hit that
             spawns no worker; (b) wall-clock, one worker after the other
             (``serial_spawn``), ``kill-worker:0@dist.item:40`` with a 2 s
             lease: worker 0 exits 17 holding item 40, worker 1 steals it
             and times the rest (127 items, ``strict_probes()``), every
             entry bitwise its merged record, a fresh coordinator's resume
             from those records bitwise with nothing timed; each
             signature's seconds over phase 21 (a)'s single-process
             seconds, and the 0.6 plan against phase 4's (reported, not
             failed); (c) ``python -m repro_torch.compress ... --workers
             2 --cache-dir``, its two workers timing the card at once,
             then again: a cache hit with 0 signatures timed and the same
             plan; each signature's seconds over (b)'s.  The workers'
             ``launch_counts`` (their final log lines) join the
             ``kernels`` line's merged_conv and depthwise_conv launches;
             both must be > 0 in (b) (``dist.json``; worker logs under
             ``build/chip_smoke/dist/w*/logs``).
26. bf16  — the published configs at their own dtype, bf16 (every
             published config is; fp32 is the reduced configs' and the
             compression paths'): (b) SmolLM-135M, RecurrentGemma-2B
             (about 5.4 GB), gemma-7b (28 layers, d 3072, 16 heads of
             256, GeGLU 24576, vocab 256000, tied; about 17 GB) and
             qwen2-7b (28 layers, d 3584, 28/4 heads of 128, QKV bias,
             SwiGLU 18944, vocab 152064, untied; about 15 GB) at full
             size, one after another, each drawn on the card from seed 0
             and freed before the next: 8 prompts x 16 tokens and 32 new
             tokens through the captured ``serve_loop`` and
             ``serve_loop_pertoken`` (the same tokens, finite logits;
             prefill ms, decode tok/s, launches a decode step, peak
             memory, the decode step beside its weight-read bound at
             3.35 TB/s, SmolLM's and RecurrentGemma's beside their fp32
             steps of phases 9 and 16), the full model's prefill forward,
             and the card against the CPU port at full width and 2 layers
             (RecurrentGemma 3), the card's own weights copied to the
             host: prefill logits and every step of a decode through the
             prompt, within ``BF16_NET_RTOL``; (c) SmolLM-135M trained in
             bf16 through ``python -m repro_torch.launch.train`` at 8 x
             1024 for 10 steps (warmup 2): the loss of the last 5 steps
             under the first 5, params bf16 and moments fp32, ms a step
             and peak memory beside phase 24's fp32 step, one loss and its
             gradients on 1 x 256 against the CPU port (``BF16_LOSS_RTOL``,
             ``BF16_GRAD_RTOL``); the bf16 bodies' launches over (b)-(c),
             counted from zero, must be > 0 (rglru_scan's too) and the
             fp32 bodies' of the norm and the attention 0; (a) rmsnorm's
             bf16 body at ``BF16_NORMS`` and flash_attention's at
             ``BF16_ATTENTION``: within one bf16 ulp of the plain version
             (the attention beyond its fp32 allowance; the most ulps and
             the elements beyond one are reported), bitwise across two
             calls, gradients through the op as phase 3 holds them, the
             norm bitwise the fp32 body's output on the widened operands
             rounded (the attention's, a kernel of its own that sums in
             another order, only reported: expected false), and cold-L2
             times beside the bf16 bound, ``F.rms_norm`` and SDPA on the
             same bf16 inputs (which rounds p to bf16: another function)
             and on the inputs widened to fp32 (``library_fp32_ms``: the
             same function, p fp32) (``bf16.json``; the ``kernels``
             line's ``rmsnorm_bf16`` and ``flash_attention_bf16`` rows,
             their launches those of (b)-(c)).  Phase 2 prints the bf16
             attention's instances with their registers and spills and
             fails on a spill, and counts its ``HGMMA`` (wgmma) and
             ``UTMALDG`` (TMA) instructions with ``cuobjdump``, failing
             where either is 0.
29. mesh  — sharded serving on a ('data', 'model') mesh
             (:func:`mesh_phase`; phases 27-28 redesigned kernels and
             added none), on the artifacts of phases 4, 11, 22 and 8:
             (a) four ``gloo`` ranks sharing the card
             (``repro_torch.testing.world.run_world``), mesh data 2 ×
             model 2 under ``make_unit_rules``, each loading its blocks
             with ``runtime.load(path, rules=)``: MobileNetV2 (fp32 and
             w8a8) and the UNet at batch 8 through ``GraphExecutor.apply``,
             the gathered outputs within ``NET_RTOL`` of max |y| of the
             single-device card forward in this process, every rank's w8a8
             activation codes bitwise the single device's block
             (``ActCodes``); SmolLM-135M at full width in fp32 (8 prompts
             of 16 tokens, ``random_prompts(0, ...)``, 32 new tokens
             through ``serve_loop_pertoken(rules=)``): its prefill and its
             logits teacher-forced at every step within ``NET_RTOL`` of
             max |y| of the single device (recorded in the loop's timed
             run where the rank's tokens are the single device's, which
             then fed every position the same token; computed on the
             single device's tokens otherwise), a differing greedy token
             failing only where its top-two margin exceeds that; every
             rank must launch merged_conv, depthwise_conv, merged_ffn,
             rmsnorm and flash_attention; the line prints each rank's
             launches, its collectives of one decode step with their
             bytes, its prefill and decode ms a step and its seconds by
             stage.  (b) one
             ``nccl`` rank (``make_host_mesh()``) serves phase 9's prompts
             through the captured ``serve_loop(rules=)``: one graph replay
             a token, the step's collectives issued inside the capture
             (the torch.profiler trace of the captured decode reports the
             NCCL kernels and device copies it shows: on one rank NCCL
             sums in place with no kernel), tokens and logits held as in
             (a) against phase 9's unsharded loop.  The two worlds run at once, beside
             this process's references (``mesh.json``).  Phase 3 also holds
             merged_ffn and merged_ffn_q with ``residual=False`` (the
             switch the tensor-parallel lowrank units use) against their
             plain versions at its shapes, each twice, bitwise.
30. mesh train — sharded training on a ('data', 'model') mesh
             (:func:`mesh_train_phase`): one ``run_world`` of four
             ``gloo`` ranks sharing the card, data 2 × model 2, batch 8 ×
             256 (4 rows a rank): (a) SmolLM-135M whole (fp32, 4 steps),
             (b) granite-moe-1b-a400m at 2 of 24 layers (16 experts and 8
             query heads a rank, at its own capacity factor 1.25: the
             single device routes in the mesh's 2 data groups,
             ``moe.grouped_routing``; 2 steps), (c) xlstm-125m at 6 of 12
             layers (heads on 'model'; 2 steps),
             each under ``make_rules(fsdp=True)`` with the optimizer-state
             placements as ``grad_shardings`` (ZeRO) and under
             ``fsdp=False`` without; every loss and grad norm, and every
             parameter after the last step, within ``MESH_TRAIN_TOL``
             (2e-4, the reference's) of the single-device steps this
             process takes on the card from the same seed; xLSTM's steps
             held teacher-forced (``MESH_TEACHER``: from the single
             device's state, its params within the tolerance or
             ``MESH_SPREAD`` times the single device's own spread between
             two summation orders).  xLSTM's 16-token greedy decode under
             the mesh gives the single device's tokens (or differs where
             the top-two margin is within ``NET_RTOL``).  (d)
             ``compressed_allreduce``'s codes and result bitwise the
             CPU's plain arithmetic; the SmolLM-135M checkpoint the 2 × 2
             run saved (blocks gathered, the main process writing) is
             each rank's blocks bitwise, and restores on a 1 × 2 mesh
             (``restore(shardings=)``) and on one process bitwise.  (e)
             ``python -m repro_torch.launch.train --arch smollm-135m
             --distributed --steps 5`` as one NCCL rank (``restarts=0``),
             then ``--resume --steps 7`` (resumed at step 5).  Prints each
             rank's step ms, collectives a step (calls and bytes each
             way) and launches of rmsnorm and flash_attention a step; the
             ``kernels`` line gains their ``@mesh-train`` rows (a rank's
             SmolLM-135M shapes, launches over the phase's training).
31. compressed — the compressed network at production scale, in phase
             30's world and this process meanwhile (:func:`comp_rank`,
             :func:`comp_checks`), on phase 8's SmolLM-135M artifact (not
             compressed again): (a) its graph's units as the legacy tuples
             through ``forward_compressed`` against ``execute`` on the
             card, 8 × 256, within ``NET_RTOL`` · max |y|; (b) trained
             sharded on data 2 × model 2 for ``COMP_STEPS`` steps, under
             FSDP with ``grad_shardings`` through
             ``forward_compressed_spec`` and under ``fsdp=False`` through
             ``make_compressed_forward``: losses, grad norms and every
             parameter within ``MESH_TRAIN_TOL`` of this process's
             single-device ``make_compressed_forward`` steps; (c)
             ``gpipe_forward`` of SmolLM-135M's 30 layers as 2 stages of
             15 on pod 2 × data 2 over the same ranks, 4 microbatches of
             4 × 256 (``GPIPE_MICRO``), within ``NET_RTOL`` · max |y| of
             the layers in sequence, each stage but the last sending
             once a tick; (d) ``python -m repro_torch.launch.dryrun
             --spec`` of (b)'s FSDP step on a fake world of 4 (a
             subprocess, no card): its collectives (calls and bytes each
             way) and argument bytes equal to rank 0's in (b), exactly.
             The ``kernels`` line gains ``@compressed`` rows (a rank's
             shapes in (b); launches of rmsnorm, flash_attention and
             merged_ffn over (a)-(c)); numbers in ``compressed.json``.

Each phase's seconds (its last log line's) end in a ``[phases]`` line
and ``phases.json``.

Any failed check raises, so the script exits non-zero.  Per-unit shapes,
times, bounds and launch plans land in ``build/chip_smoke/units.json``
(MobileNetV2), ``resnet34.json`` and ``resnet34_wallclock.json``,
``qunits.json`` and ``qffn.json`` (the quantized phases), RecurrentGemma's
in ``rg.json``, the serving numbers of phases 9, 13, 16, 18 and 19 in
``serve.json``, phase 20's in ``importance.json``, phase 21's in
``tables.json``, phase 22's in ``unet.json``, phase 23's in
``archs.json``, phase 24's in ``train.json``, phase 25's in
``dist.json``, phase 26's in ``bf16.json``, phase 29's in ``mesh.json``,
phase 30's in ``mesh_train.json``, phase 31's in ``compressed.json``.
It exits non-zero
without a result where ``torch.cuda.is_available()`` is false or the repo's
``src/`` is missing.  The last lines are the ``kernels`` JSON line, the
``nvidia-smi`` line, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

H100_FP32_FLOPS = 67e12          # fp32 outside the tensor cores, data sheet
H100_TF32_FLOPS = 495e12         # TF32 tensor cores, dense, data sheet
H100_FP16_FLOPS = 989e12         # fp16 tensor cores, dense, data sheet
H100_INT8_OPS = 1979e12          # int8 tensor cores, dense, data sheet
H100_HBM_BW = 3.35e12            # bytes/s, data sheet
H100_L2_BYTES = 50 * 2**20       # data sheet

# Kernel vs plain version: |y − ref| ≤ RTOL · (|x| ⋆ |w| + |b|) + ATOL per
# output.  Both sides accumulate in fp32 in different orders (the kernel
# sequentially over (u, v, c); cuDNN by its own algorithm), so their error
# is a few ulps of Σ|x·w| in practice and at most ~Ktot·2⁻²⁴ of it; an
# indexing fault is O(1) of it.
RTOL, ATOL = 1e-4, 1e-6
# Whole networks (50+ layers of fp32 reassociation): max |Δ| over max |y|.
NET_RTOL = 1e-4
# Depth-compression budgets tried for SmolLM-135M, tightest first.
LM_BUDGETS = (0.6, 0.7, 0.8, 0.9, 1.0)
# w8a8 MobileNetV2 budgets, until the plan quantizes a dense and a
# depthwise unit.
Q_BUDGETS = (0.6, 0.5, 0.4)
# Quantized network vs the fp lowering of the same plan: the reference's
# own criterion (tests/test_quant_pipeline.py), max |Δ| / max |y| < 0.25.
Q_FP_RTOL = 0.25
# The products of merged_ffn, merged_conv and flash_attention priced at
# the tensor-core rate that gives the result's accuracy, by operand types
# (the activation or panel, the weight or factor): fp32 x fp32 as 3xTF32,
# fp32 x narrow as 2xTF32 (a narrow value is exact in TF32), int8 x int8
# at the int8 rate, int8 x e4m3 at fp16's (both exact in fp16).
TC_RATES = {("fp32", "fp32"): (H100_TF32_FLOPS / 3, "3xTF32"),
             ("fp32", "narrow"): (H100_TF32_FLOPS / 2, "2xTF32"),
             ("int8", "int8"): (H100_INT8_OPS, "int8"),
             ("int8", "e4m3"): (H100_FP16_FLOPS, "fp16")}
# The rate every other kernel's operations are priced at.
FFMA_RATE = f"fp32 FFMA, {H100_FP32_FLOPS / 1e12:g} TFLOP/s"
# Per-unit timings of the quantized kernels summed over a forward / step.
#: Suffix of the ``kernels`` line's rows of the convs at the DDPM UNet's
#: units (phase 22), beside their MobileNetV2 rows.
UNET_ROW = "@ddpm_unet"
#: Suffix of the ``kernels`` line's rows of phase 23 (d): each kernel's
#: times summed over its shapes there, its launches over (a)-(c).
ARCH_ROW = "@archs"
#: flash_attention shapes (B, S, H, KVH, D) of phase 23's paths:
#: granite-moe-1b-a400m and qwen2-vl-7b at the probes' S 128 and the
#: prompts' 16.
ARCH_ATTENTION = ((8, 128, 16, 8, 64), (8, 16, 16, 8, 64),
                  (8, 128, 28, 4, 128), (8, 16, 28, 4, 128))
#: Phase 23 (a): granite-moe-1b-a400m's layers (of 24) at full width,
#: cut from 24 to make room for phase 30.
ARCH_GRANITE_LAYERS = 12
#: rmsnorm widths of phase 23's paths (granite, xLSTM, qwen2-vl).
ARCH_NORM_D = (1024, 768, 3584)
#: MoE capacity factor at which nothing drops (the reference pins it so
#: in ``tests/test_archs.py``): a request then routes as it would alone.
MOE_NO_DROP = 8.0
#: Rows of phase 23 (c)'s batch held against the CPU port (and of phase
#: 16's and phase 26 (b)'s).
CPU_ROWS = 4
#: Phase 23 (c): qwen2-vl-7b's layers (of 28) at full width.
QWEN2VL_LAYERS = 4
#: Phase 16: teacher-forced steps held against the CPU port (the prompt's
#: 16 positions and the first 8 decode steps).
RG_CPU_STEPS = 24
#: Layers of phases 15-16's fp32 RecurrentGemma-2B: 13 of its 26, the
#: block pattern kept (cut to make room for phase 29; phase 26 serves all
#: 26 at bf16).
RG_LAYERS = 13
#: Phase 20 (c): SmolLM-135M's Eq. 4 build runs the first this many of
#: phase 8's 30 layers (at full width), cut in PR 29 to keep the script
#: inside its time limit: its fine-tunes (one a layer) took 48-75 s at 30.
EQ4_LM_LAYERS = 15
#: Suffix of the ``kernels`` line's rows of phase 24 (d): the kernels at
#: the training shapes, their launches over phase 24 (a)-(c).
TRAIN_ROW = "@train"
#: Phase 24's SmolLM-135M batch (``examples/train_lm.py``'s "100m"
#: preset) and its kernel shapes: rmsnorm's rows, flash_attention's (B,
#: S, H, KVH, D).
TRAIN_BATCH = (8, 1024)
#: Phase 24 (a) trains SmolLM-135M at full width and this many of its 30
#: layers (cut in PR 29 to keep the script inside its time limit).
TRAIN_LAYERS = 15
TRAIN_NORM = (8 * 1024, 576)
TRAIN_ATTENTION = (8, 1024, 9, 3, 64)
#: Each kernel's source and the TPU kernel (``pl.pallas_call``) it ports.
KERNEL_SOURCES = {
    "merged_conv": ("src/repro_torch/kernels/csrc/merged_conv.cu",
                    "src/repro/kernels/merged_conv.py:347"),
    "depthwise_conv": ("src/repro_torch/kernels/csrc/depthwise_conv.cu",
                       "src/repro/kernels/depthwise_conv.py:280"),
    "merged_ffn": ("src/repro_torch/kernels/csrc/merged_ffn.cu",
                   "src/repro/kernels/merged_ffn.py:128"),
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:32"),
    "rglru_scan": ("src/repro_torch/kernels/csrc/rglru_scan.cu",
                   "src/repro/kernels/rglru_scan.py:45"),
    # no pallas_call: the gradient XLA takes of the reference's scan
    "rglru_scan_bwd": ("src/repro_torch/kernels/csrc/rglru_scan.cu",
                       "src/repro/models/rglru.py:81"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:78")}
for _k in ("merged_conv", "depthwise_conv", "merged_ffn"):
    KERNEL_SOURCES[_k + "_q"] = KERNEL_SOURCES[_k]   # quant=True
KERNEL_SOURCES["rmsnorm_bf16"] = KERNEL_SOURCES["rmsnorm"]   # the bf16 body
KERNEL_SOURCES["flash_attention_bf16"] = (          # a Hopper kernel of its own
    "src/repro_torch/kernels/csrc/flash_attention_bf16.cu",
    KERNEL_SOURCES["flash_attention"][1])
Q_FIELDS = ("ms", "plain_ms", "library_ms", "fp32_ms", "op_ms", "qpass_ms",
            "flops_ms", "bytes_ms", "bound_ms")

IMPORT_ERROR = ("chip_smoke.py runs from a checkout of the repository: "
                "src/repro_torch is missing")


#: Seconds of each logged phase (its last line's), in the order logged:
#: the ``[phases]`` line and ``phases.json``.
PHASE_SECONDS: dict = {}


def log(phase: str, t0: float, msg: str = "") -> None:
    secs = time.perf_counter() - t0
    PHASE_SECONDS[phase] = round(secs, 2)
    print(f"[{phase}] {secs:.2f}s {msg}".rstrip(), flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def strict_probes():
    """The probe policy of every direct table build on the main path: a
    probe that fails on the card raises.  The default policy retries it
    and then quarantines its bucket to the analytic estimate, which would
    pass a kernel that does not launch at some shape; only phase 21 (c)
    quarantines, on purpose."""
    from repro_torch.core import ProbeConfig
    return ProbeConfig(retries=0, quarantine=False)


def check_probes(oracle, summary, what: str) -> None:
    """A CLI compress on the main path (default probe policy) had no probe
    retried or quarantined.  ``oracle.flags`` holds every signature the
    oracle priced, ``T_orig``'s included; the summary counts the tables'
    retries and quarantines."""
    from repro_torch.core.probe_engine import PROBE_QUARANTINED
    bad = [sig for sig, f in oracle.flags.items() if f == PROBE_QUARANTINED]
    check(not bad and summary["retried"] == 0
          and summary["quarantined"] == 0,
          f"{what}: {summary['retried']} probe retries, "
          f"{summary['quarantined']} buckets and {len(bad)} signatures "
          f"quarantined to the analytic estimate")


_L2_EVICT = []


def l2_evict():
    """Read a buffer of four times the L2, so that nothing an earlier call
    left there is still cached."""
    import torch
    if not _L2_EVICT:
        # fp32: 4 bytes an element, so four L2s of bytes
        _L2_EVICT.append(torch.ones(H100_L2_BYTES, device="cuda"))
    return _L2_EVICT[0].sum()


def _replay_graph(fn, calls: int):
    """``calls`` calls of ``fn`` captured in one CUDA graph (after three
    eager calls on a side stream, as the wall-clock oracle warms up),
    replayed once."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    return graph


def kernel_time(fn, calls: int = 50, pairs: int = 10) -> float:
    """Device milliseconds per call of ``fn`` with a cold L2: ``calls``
    calls, each after :func:`l2_evict`, captured in a CUDA graph, and the
    evicting reads alone in another; the two replayed in turn ``pairs``
    times, and the median over the pairs of their difference per call.
    Each call then reads its inputs from HBM, as the byte bound
    (``H100_HBM_BW``) prices them; replaying warm inputs would let L2
    serve inputs under 50 MB and beat that bound.  Graph replays keep
    host dispatch from hiding a kernel's own time; timing the two graphs
    in adjacent pairs keeps a drift of the card's clocks between them
    out of the difference (timed one after the other, a 3 µs kernel
    once came out at -4 µs)."""
    import statistics

    import torch
    both = _replay_graph(lambda: (l2_evict(), fn()), calls)
    alone = _replay_graph(l2_evict, calls)
    events = []
    for _ in range(pairs):
        for graph in (both, alone):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            events.append((start, end))
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) / calls for s, e in events]
    return statistics.median(ms[2 * i] - ms[2 * i + 1] for i in range(pairs))


def check_bound(name: str, ms: float, bound_ms: float) -> None:
    """A kernel cannot beat its bound: a share above 1 means the byte or
    operation count, or the timing, is wrong."""
    check(bound_ms <= ms, f"{name}: {ms:.5f} ms is under its bound "
          f"{bound_ms:.5f} ms (share {bound_ms / ms:.3f})")


def cuda_time(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events
    around eager calls: host dispatch included)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# Kernel against plain version
# ---------------------------------------------------------------------------

def held(name, y, yr, scale, case) -> tuple[float, float]:
    """|y − yr| ≤ RTOL · scale + ATOL per output on the same card inputs;
    returns (max |Δ|, max |Δ| / scale)."""
    import torch
    torch.cuda.synchronize()
    check(y.shape == yr.shape, f"{name} {case}: shape {tuple(y.shape)} vs "
          f"{tuple(yr.shape)}")
    check(bool(torch.isfinite(y).all()), f"{name} {case}: non-finite output")
    err = (y - yr).abs()
    rel = float((err / (scale + ATOL)).max())
    check(not bool((err > RTOL * scale + ATOL).any()),
          f"{name} {case}: max|Δ|={float(err.max()):.3g} rel={rel:.3g} "
          f"beyond rtol={RTOL}")
    return float(err.max()), rel


#: (groups, cin_g, cout_g) of the depthwise kernel's sweeps: the scalar
#: path (13 channels; a channel multiplier with 18 outputs; general
#: grouped) and the vector path (16 channels; a multiplier with 8).
DW_CASES = ((13, 1, 1), (6, 1, 3), (3, 4, 5), (16, 1, 1), (4, 1, 2))


def compare_kernel(kind, x, w, b, stride, groups=None, activation=None):
    """Run the kernel op and its plain version on the same card inputs;
    returns (max |Δ|, max |Δ| / scale); raises beyond the tolerance."""
    from repro_torch import kernels
    from repro_torch.kernels import ref

    if kind == "merged_conv":
        y = kernels.merged_conv_op(x, w, b, stride=stride,
                                   activation=activation)
        yr = ref.merged_conv_ref(x, w, b, stride=stride)
        scale = ref.merged_conv_ref(x.abs(), w.abs(),
                                    None if b is None else b.abs(),
                                    stride=stride)
    else:
        y = kernels.depthwise_conv_op(x, w, b, stride=stride, groups=groups,
                                      activation=activation)
        yr = ref.depthwise_conv_ref(x, w, b, stride=stride, groups=groups)
        scale = ref.depthwise_conv_ref(x.abs(), w.abs(),
                                       None if b is None else b.abs(),
                                       stride=stride, groups=groups)
    return held(kind, y, ref.apply_activation(yr, activation), scale,
                f"x={tuple(x.shape)} w={tuple(w.shape)} s={stride} "
                f"g={groups} act={activation}")


# ---------------------------------------------------------------------------
# Quantized kernels against their plain versions
# ---------------------------------------------------------------------------

#: Quantized sweep modes: weight dtype of ``quant.quantize_weight`` and the
#: op's ``act_quant``.  fp8 is not a CLI mode, but the kernels take it.
QMODES = {"int8": ("int8", "none"), "w8a8": ("int8", "w8a8"),
          "fp8": ("fp8", "none")}


def print_profile(label, fn, arg, ms) -> None:
    """One line: device-busy share of ``fn(arg)`` against ``ms`` (its
    measured time per call) and its heaviest kernels (torch.profiler)."""
    busy_us, rows = device_kernels(lambda: fn(arg))
    if not rows:
        print(f"  {label}, torch.profiler: no device activity seen (busy "
              "share not measured)", flush=True)
        return
    print(f"  {label}, torch.profiler: device busy {busy_us:.1f} us per "
          f"call = {busy_us / (ms * 1e3):.3f} of its {ms:.3f} ms; by kernel: "
          + "; ".join(f"{name[:60]} {us:.1f}us x{n}"
                      for us, n, name in rows[:8]), flush=True)


def dequantized_input(x, act_quant):
    """The activation the quantized kernel sees, dequantized: the codes
    ``quant.quantize_int8`` gives for ``x`` on its device times their
    scale under w8a8 (the op quantizes the same ``x`` with the same
    function, so both sides see the same integers), else ``x``."""
    from repro_torch.kernels import quant
    if act_quant != "w8a8":
        return x
    return quant.dequantize(*quant.quantize_int8(x))


def compare_qkernel(kind, x, wq, ws, b, stride, act_quant, groups=None,
                    activation=None):
    """The quantized conv op against its plain version (``*_qref``) on the
    same card inputs: |Δ| ≤ RTOL · (|x̂| ⋆ |ŵ| + |b|) + ATOL per output,
    over the dequantized operands; returns (max |Δ|, max |Δ| / scale)."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import quant, ref

    xd, wd = dequantized_input(x, act_quant), quant.dequantize(wq, ws, axis=3)
    bb = None if b is None else b.abs()
    if kind == "merged_conv":
        y = kernels.merged_conv_op(x, wq, b, stride=stride, w_scale=ws,
                                   act_quant=act_quant, activation=activation)
        yr = ref.merged_conv_qref(x, wq, b, ws, stride=stride,
                                  act_quant=act_quant)
        scale = ref.merged_conv_ref(xd.abs(), wd.abs(), bb, stride=stride)
    else:
        y = kernels.depthwise_conv_op(x, wq, b, stride=stride, groups=groups,
                                      w_scale=ws, act_quant=act_quant,
                                      activation=activation)
        yr = ref.depthwise_conv_qref(x, wq, b, ws, stride=stride,
                                     groups=groups, act_quant=act_quant)
        scale = ref.depthwise_conv_ref(xd.abs(), wd.abs(), bb, stride=stride,
                                       groups=groups)
    check(y.dtype == torch.float32, f"{kind} quantized: {y.dtype} output")
    return held(f"{kind} quantized", y, ref.apply_activation(yr, activation),
                scale, f"x={tuple(x.shape)} w={tuple(wq.shape)} {wq.dtype} "
                f"s={stride} g={groups} act={activation} "
                f"act_quant={act_quant}")


def qkernel_sweep(dev) -> dict:
    """Each quantized conv kernel over modes × strides {1,2,3} × k
    {1,3,5,7}, ragged shapes, every activation, no bias on a third, and the
    depthwise / channel-multiplier / grouped cases."""
    import torch
    from repro_torch.kernels import quant
    g = torch.Generator().manual_seed(4)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    acts = [None, "relu", "relu6", "silu"]
    worst = {"merged_conv_q": [0.0, 0.0, 0], "depthwise_conv_q": [0.0, 0.0, 0]}

    def note(kind, res):
        w = worst[kind]
        w[0], w[1], w[2] = max(w[0], res[0]), max(w[1], res[1]), w[2] + 1

    n = 0
    for mode, (wmode, aq) in QMODES.items():
        for s in (1, 2, 3):
            for k in (1, 3, 5, 7):
                act = acts[n % 4]
                hw = (k + 5 * s + 1, k + 3 * s + 2)
                for cin, cout in ((5, 3), (19, 70), (64, 129)):
                    bias = None if n % 3 == 0 else rnd(cout)
                    wq, ws = quant.quantize_weight(
                        rnd(k, k, cin, cout) / (k * cin ** 0.5), wmode, axis=3)
                    note("merged_conv_q", compare_qkernel(
                        "merged_conv", rnd(2, *hw, cin), wq, ws, bias, s, aq,
                        activation=act))
                    n += 1
                for groups, cin_g, cout_g in DW_CASES:
                    cout = groups * cout_g
                    bias = None if n % 3 == 0 else rnd(cout)
                    wq, ws = quant.quantize_weight(
                        rnd(k, k, cin_g, cout) / k, wmode, axis=3)
                    note("depthwise_conv_q", compare_qkernel(
                        "depthwise_conv", rnd(2, *hw, groups * cin_g), wq, ws,
                        bias, s, aq, groups=groups, activation=act))
                    n += 1
    return worst


def compare_qffn(x, uq, us, vq, vs, act_quant):
    """The quantized merged_ffn op against ``merged_ffn_qref`` on the same
    card inputs: |Δ| ≤ RTOL · (|x| + (|x̂|·|Û|)·|V̂|) + ATOL per output,
    over the dequantized operands; returns (max |Δ|, max |Δ| / scale)."""
    from repro_torch import kernels
    from repro_torch.kernels import quant, ref

    y = kernels.merged_ffn_op(x, uq, vq, u_scale=us, v_scale=vs,
                              act_quant=act_quant)
    yr = ref.merged_ffn_qref(x, uq, vq, us, vs, act_quant=act_quant)
    scale = x.abs() + (dequantized_input(x, act_quant).abs()
                       @ quant.dequantize(uq, us, axis=1).abs()
                       ) @ quant.dequantize(vq, vs, axis=1).abs()
    return held("merged_ffn quantized", y, yr, scale,
                f"x={tuple(x.shape)} u={tuple(uq.shape)} {uq.dtype} "
                f"act_quant={act_quant}")


#: The quantized merged_ffn's four type pairs (the panel feeding P x the
#: narrow factors): the weight mode and the op's ``act_quant``.
QPAIRS = {"fp32 x int8": ("int8", "none"), "int8 x int8": ("int8", "w8a8"),
          "fp32 x e4m3": ("fp8", "none"), "int8 x e4m3": ("fp8", "w8a8")}


def qffn_sweep(dev):
    """Quantized merged_ffn over modes × M {1,8,37,1024} × D {96,576} ×
    R {24,576}, and each of the four type pairs at RecurrentGemma's
    D 2560 × M {8,1024} × R {24,2560}."""
    import torch
    from repro_torch.kernels import quant
    g = torch.Generator().manual_seed(5)
    worst = [0.0, 0.0, 0]
    cases = [(wmode, aq, m, d, r) for wmode, aq in QMODES.values()
             for m in (1, 8, 37, 1024) for d in (96, 576) for r in (24, 576)]
    cases += [(wmode, aq, m, 2560, r) for wmode, aq in QPAIRS.values()
              for m in (8, 1024) for r in (24, 2560)]
    for wmode, aq, m, d, r in cases:
        x = torch.randn(m, d, generator=g).to(dev)
        uq, us = quant.quantize_weight(
            (torch.randn(d, r, generator=g) / d ** 0.5).to(dev), wmode, axis=1)
        vq, vs = quant.quantize_weight(
            (torch.randn(r, d, generator=g) / r ** 0.5).to(dev), wmode, axis=1)
        err, rel = compare_qffn(x, uq, us, vq, vs, aq)
        worst = [max(worst[0], err), max(worst[1], rel), worst[2] + 1]
    return worst


def quantize_matches_cpu(dev) -> int:
    """``quant.quantize_int8`` on the card gives bitwise the CPU's codes
    and scale for the same fp32 input (per tensor and per channel);
    returns the number of inputs checked."""
    import torch
    from repro_torch.kernels import quant
    g = torch.Generator().manual_seed(6)
    n = 0
    for shape in ((8, 576), (8, 58, 58, 144), (37, 96), (3, 3, 96, 24)):
        x = torch.randn(*shape, generator=g) * 3.0
        for axis in (None, len(shape) - 1):
            q_c, s_c = quant.quantize_int8(x, axis=axis)
            q_d, s_d = quant.quantize_int8(x.to(dev), axis=axis)
            check(torch.equal(q_d.cpu(), q_c) and torch.equal(s_d.cpu(), s_c),
                  f"quantize_int8 {shape} axis={axis}: the card's codes or "
                  "scale differ from the CPU's")
            n += 1
    return n


def kernel_sweep(dev) -> dict:
    import torch
    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    acts = [None, "relu", "relu6", "silu"]
    worst = {"merged_conv": [0.0, 0.0, 0], "depthwise_conv": [0.0, 0.0, 0]}

    def note(kind, res):
        w = worst[kind]
        w[0], w[1], w[2] = max(w[0], res[0]), max(w[1], res[1]), w[2] + 1

    n = 0
    for s in (1, 2, 3):
        for k in (1, 2, 3, 5, 7, 11):
            act = acts[n % 4]
            hw = (k + 5 * s + 1, k + 3 * s + 2)          # ragged Ho / Wo
            for cin, cout in ((5, 3), (19, 70), (64, 129)):
                bias = None if n % 3 == 0 else rnd(cout)
                note("merged_conv", compare_kernel(
                    "merged_conv", rnd(2, *hw, cin), rnd(k, k, cin, cout)
                    / (k * (cin ** 0.5)), bias, s, activation=act))
                n += 1
            for groups, cin_g, cout_g in DW_CASES:
                cout = groups * cout_g
                bias = None if n % 3 == 0 else rnd(cout)
                note("depthwise_conv", compare_kernel(
                    "depthwise_conv", rnd(2, *hw, groups * cin_g),
                    rnd(k, k, cin_g, cout) / k, bias, s, groups=groups,
                    activation=act))
                n += 1
    return worst


#: merged_conv's instances: (x shape, w shape, stride) that reach each
#: tile (128 x 16 at MobileNetV2's Cin 3 stride-2 stem, Cout 16 and 24
#: and a split 14x14 unit; 128 x 32 at its merged 5x5 unit; 64 x 64 and
#: 128 x 128 at deep 3x3 units), the dense 1x1 panel, the 16-, 8- and
#: 4-byte and the element gathers, element copies of a ragged weight, and
#: split reductions; ``CONV_DEEP`` is deep enough (K = 2^17) that
#: int8 x int8 takes the TF32 instance, not the int8 mma.  The last five
#: are the DDPM UNet's (``UNET_CASES``).
CONV_CASES = (((8, 17, 17, 3), (3, 3, 3, 32), 2),
              ((2, 30, 31, 32), (1, 1, 32, 16), 1),
              ((2, 23, 21, 16), (3, 3, 16, 24), 2),
              ((2, 19, 18, 24), (1, 1, 24, 144), 1),
              ((2, 12, 11, 12), (3, 3, 12, 20), 1),
              ((8, 14, 14, 384), (1, 1, 384, 64), 1),
              ((8, 7, 7, 576), (1, 1, 576, 160), 1),
              ((8, 60, 60, 24), (5, 5, 24, 32), 2),
              ((8, 30, 30, 128), (3, 3, 128, 128), 1),
              ((4, 58, 58, 256), (3, 3, 256, 256), 1),
              ((2, 9, 8, 19), (2, 2, 19, 70), 3))
#: The DDPM UNet's distinct unit shapes at batch 8 (padded input, weight,
#: stride): the Cin-4 stem (a 16-byte pixel, one float4), the Cout-3
#: output conv (rows not 16-byte aligned), the convs after the 768- and
#: 384-channel concats, and boundaries 3 to 6 merged (a 3x3 s2 conv and
#: two 3x3 convs at half resolution: 11x11 at stride 2, a 16 MB weight).
UNET_CASES = (((8, 34, 34, 4), (3, 3, 4, 128), 1),
              ((8, 34, 34, 128), (3, 3, 128, 3), 1),
              ((8, 18, 18, 768), (3, 3, 768, 256), 1),
              ((8, 34, 34, 384), (3, 3, 384, 128), 1),
              ((8, 42, 42, 128), (11, 11, 128, 256), 2))
CONV_CASES += UNET_CASES
CONV_DEEP = ((1, 1, 3, 2 ** 17), (1, 1, 2 ** 17, 16), 1)


def conv_instance_sweep(dev) -> dict:
    """merged_conv and merged_conv_q (its four type pairs, ``QPAIRS``) over
    ``CONV_CASES`` (and ``CONV_DEEP`` in int8 x int8) against their plain
    versions, each relu6 with a bias; fails unless the plans taken reach
    every instance: each tile, the dense panel, each copy width of each
    operand type, a split reduction, the int8 mma and int8 x int8 in
    TF32."""
    import torch
    from repro_torch.kernels import quant
    g = torch.Generator().manual_seed(7)
    worst = {"merged_conv": [0.0, 0.0, 0], "merged_conv_q": [0.0, 0.0, 0]}
    seen = set()
    cases = [(c, pair) for c in CONV_CASES for pair in (None, *QPAIRS)]
    cases.append((CONV_DEEP, "int8 x int8"))
    for (xs, ws, st), mode in cases:
        x = torch.randn(*xs, generator=g).to(dev)
        w = (torch.randn(*ws, generator=g) / (ws[0] * ws[2] ** 0.5)).to(dev)
        b = torch.randn(ws[3], generator=g).to(dev)
        if mode is None:
            res = compare_kernel("merged_conv", x, w, b, st,
                                 activation="relu6")
            kind, xk, wk = "merged_conv", x, w
        else:
            wmode, aq = QPAIRS[mode]
            wq, wsc = quant.quantize_weight(w, wmode, axis=3)
            res = compare_qkernel("merged_conv", x, wq, wsc, b, st, aq,
                                  activation="relu6")
            kind, wk = "merged_conv_q", wq
            xk = quant.quantize_int8(x)[0] if aq == "w8a8" else x
        plan = conv_plan(xk, wk, st)
        types = f"{xk.dtype}x{wk.dtype}"
        seen |= {("tile", tuple(plan["tile"])), ("a_vec", str(xk.dtype),
                                                 plan["a_vec"]),
                 ("b_vec", str(wk.dtype), plan["b_vec"]),
                 ("dense", plan["dense"]), ("split", plan["splits"] > 1),
                 ("s8", types, plan["s8"])}
        w_ = worst[kind]
        w_[0], w_[1], w_[2] = max(w_[0], res[0]), max(w_[1], res[1]), w_[2] + 1
    i8 = "torch.int8"
    need = {("tile", t) for t in ((128, 16), (128, 32), (64, 64), (128, 128))}
    need |= {("dense", True), ("split", True), ("s8", f"{i8}x{i8}", True),
             ("s8", f"{i8}x{i8}", False),
             ("s8", f"{i8}xtorch.float8_e4m3fn", False)}
    need |= {("a_vec", "torch.float32", v) for v in (16, 4)}
    need |= {("a_vec", i8, v) for v in (16, 8, 4, 1)}
    need |= {("b_vec", "torch.float32", v) for v in (16, 4)}
    check(need <= seen, f"merged_conv instances not reached: "
          f"{sorted(map(str, need - seen))}")
    return worst


def conv_determinism(dev) -> int:
    """Two calls of merged_conv, fp32 and w8a8, on the same inputs give
    bitwise the same y (the split reductions sum in a fixed order) at
    MobileNetV2 unit shapes: the stem, a 56x56 1x1 unit, and the split
    14x14 and 7x7 units; returns the cases checked."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import quant
    g = torch.Generator().manual_seed(11)
    n = 0
    for xs, ws, st in (((8, 226, 226, 3), (3, 3, 3, 32), 2),
                       ((8, 56, 56, 24), (1, 1, 24, 144), 1),
                       ((8, 14, 14, 384), (1, 1, 384, 64), 1),
                       ((8, 7, 7, 576), (1, 1, 576, 160), 1)):
        x = torch.randn(*xs, generator=g).to(dev)
        w = (torch.randn(*ws, generator=g) / ws[2] ** 0.5).to(dev)
        b = torch.randn(ws[3], generator=g).to(dev)
        wq, wsc = quant.quantize_weight(w, "int8", axis=3)
        for kw in ({}, {"w_scale": wsc, "act_quant": "w8a8"}):
            y1, y2 = (kernels.merged_conv_op(
                x, wq if kw else w, b, stride=st, activation="relu6", **kw)
                for _ in range(2))
            torch.cuda.synchronize()
            check(torch.equal(y1, y2), f"merged_conv {xs}x{ws} "
                  f"{'w8a8' if kw else 'fp32'}: two calls on the same inputs "
                  "differ bitwise")
            n += 1
    return n


# ---------------------------------------------------------------------------
# rmsnorm, rglru_scan, flash_attention: sweeps against the plain versions
# ---------------------------------------------------------------------------

def compare_attention(q, k, v, causal):
    """flash_attention kernel vs the plain version on k, v expanded to q's
    heads; the scale is the same softmax applied to |v|, which bounds
    every output."""
    from repro_torch import kernels
    from repro_torch.kernels import ops
    return held("flash_attention", kernels.flash_attention_op(q, k, v, causal),
                ops._attention_plain(q, k, v, causal),
                ops._attention_plain(q, k, v.abs(), causal),
                f"q={tuple(q.shape)} kv={tuple(k.shape)} causal={causal}")


def norm_scan_attention_sweep(dev) -> dict:
    """rmsnorm over M {1,8,37,1024} × D {32,512,576,768,1024,2560,2561,
    3584}; rglru_scan over B {1,8} × S {1,7,128,512} × C {32,256,2560,
    2561} with a in (0.5, 1), also held bitwise, and its backward kernel
    at the same shapes, bitwise ``rglru_scan_bwd_ref`` and the plain
    version's autograd (:func:`scan_bwd_case`); flash_attention over
    BH {1,8,80} × S {1,7,16,128,256,1000} × D {32,64,256}, causal and not
    (BH 8 as B 2 × H 4 over 2 kv heads, BH 80 as B 8 × H 10 over 1, the
    MQA of RecurrentGemma); ``benchmarks/run.py``'s three shapes; and
    phase 23's (``ARCH_ATTENTION``: granite's 16 heads of 64 over 8 and
    qwen2-vl's 28 of 128 over 4, at S 128 and 16)."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(7)
    gw = torch.Generator().manual_seed(28)     # the scan's output gradients
    worst = {k: [0.0, 0.0, 0] for k in ("rmsnorm", "rglru_scan",
                                        "rglru_scan_bwd", "flash_attention")}

    def note(kind, res):
        w = worst[kind]
        w[0], w[1], w[2] = max(w[0], res[0]), max(w[1], res[1]), w[2] + 1

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    for m, d in [(m, d) for m in (1, 8, 37, 1024)
                 for d in (32, 512, 576, 768, 1024, 2560, 2561, 3584)] + [
                     TRAIN_NORM]:
        x, w = rnd(m, d) * 3.0, rnd(d) * 0.2
        yr = ref.rmsnorm_ref(x, w, 1e-6)
        note("rmsnorm", held("rmsnorm", kernels.rmsnorm_op(x, w, eps=1e-6),
                             yr, yr.abs(), f"x={(m, d)}"))
    scans = [(b, s, c) for b in (1, 8) for s in (1, 7, 128, 512)
             for c in (32, 256, 2560, 2561)] + [(4, 512, 256)]
    for b, s, c in scans:
        a = (torch.rand(b, s, c, generator=g) * 0.5 + 0.5).to(dev)
        x = rnd(b, s, c) * 0.1
        h, hr = kernels.rglru_scan_op(a, x), ref.rglru_scan_ref(a, x)
        note("rglru_scan", held("rglru_scan", h, hr,
                                ref.rglru_scan_ref(a, x.abs()),
                                f"a={(b, s, c)}"))
        check(torch.equal(h, hr), f"rglru_scan {(b, s, c)}: the kernel and "
              "its plain version round alike, yet differ bitwise")
        note("rglru_scan_bwd", scan_bwd_case(
            a, x, torch.randn(b, s, c, generator=gw).to(dev)))
    heads = {1: (1, 1, 1), 8: (2, 4, 2), 80: (8, 10, 1)}
    for bh, (b, h, kvh) in heads.items():
        for s in (1, 7, 16, 128, 256, 1000):
            for d in (32, 64, 256):
                q, k, v = rnd(b, s, h, d), rnd(b, s, kvh, d), rnd(b, s, kvh, d)
                for causal in (True, False):
                    note("flash_attention", compare_attention(q, k, v, causal))
    q, k, v = (rnd(2, 256, 4, 64) for _ in range(3))      # benchmarks/run.py
    note("flash_attention", compare_attention(q, k, v, True))
    for b, s, h, kvh, d in ARCH_ATTENTION + (TRAIN_ATTENTION,):
        q, k, v = rnd(b, s, h, d), rnd(b, s, kvh, d), rnd(b, s, kvh, d)
        note("flash_attention", compare_attention(q, k, v, True))
    return worst


def scan_bwd_case(a, x, w) -> tuple[float, float]:
    """The scan's backward kernel on a, the plain scan's output h and the
    output's gradient w against its plain version
    (``rglru_scan_bwd_ref``) and the plain scan's autograd: bitwise both
    (the same rounded product and sum a step; autograd's two-term sums
    commute and its zero-fill adds are exact), one launch.  Returns
    (max |Δ|, max |Δ| / scale), both 0 when it holds."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rg_mod
    h = ref.rglru_scan_ref(a, x)
    start = kernels.launch_counts()["rglru_scan_bwd"]
    da, db = rg_mod.rglru_scan_bwd(a, h, w)
    n = kernels.launch_counts()["rglru_scan_bwd"] - start
    want = ref.rglru_scan_bwd_ref(a, h, w)
    leaves = [a.clone().requires_grad_(), x.clone().requires_grad_()]
    auto = torch.autograd.grad(ref.rglru_scan_ref(*leaves), leaves, w)
    torch.cuda.synchronize()
    case = f"a={tuple(a.shape)}"
    check(n == 1, f"rglru_scan_bwd {case}: {n} launches (want 1)")
    err = 0.0
    for got, plain, grad, what in ((da, want[0], auto[0], "da"),
                                   (db, want[1], auto[1], "db")):
        check(bool(torch.isfinite(got).all()),
              f"rglru_scan_bwd {case}: non-finite {what}")
        err = max(err, float((got - plain).abs().max()))
        check(torch.equal(got, plain), f"rglru_scan_bwd {case}: {what} "
              f"differs bitwise from rglru_scan_bwd_ref (max |Δ| {err:.3g})")
        check(torch.equal(plain, grad), f"rglru_scan_bwd {case}: "
              f"rglru_scan_bwd_ref's {what} differs bitwise from the plain "
              "scan's autograd")
    return err, 0.0


def bf16_sweep(dev) -> dict:
    """The bf16 bodies off the configs' shapes: rmsnorm over M {1,37} ×
    D {32,576,2561} with g bf16 and fp32 (the vector and scalar paths);
    flash_attention over (B, S, H, KVH) {(2, S, 4, 2), (1, S, 10, 1)} ×
    S {1,7,130} × D {36,64,100,256} (16-byte and element copies), causal
    and not: each element within one bf16 ulp of the plain version
    (:func:`held_ulp`).  Returns ``{body: [max |Δ|, most ulps, cases,
    elements more than one ulp apart]}``."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import ops, ref
    g = torch.Generator().manual_seed(27)
    worst = {k: [0.0, 0.0, 0, 0] for k in ("rmsnorm_bf16",
                                           "flash_attention_bf16")}

    def note(kind, res):
        w = worst[kind]
        w[0], w[1], w[2] = max(w[0], res[0]), max(w[1], res[1]), w[2] + 1
        w[3] += res[2]

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev).bfloat16()

    for m in (1, 37):
        for d in (32, 576, 2561):
            x, w = rnd(m, d, scale=3.0), rnd(d, scale=0.2)
            for gw in (w, w.float()):
                note("rmsnorm_bf16", held_ulp(
                    "rmsnorm_bf16", kernels.rmsnorm_op(x, gw),
                    ref.rmsnorm_ref(x, gw), f"x={(m, d)} g {gw.dtype}"))
    for b, h, kvh in ((2, 4, 2), (1, 10, 1)):
        for s in (1, 7, 130):
            for d in (36, 64, 100, 256):
                q, k, v = rnd(b, s, h, d), rnd(b, s, kvh, d), rnd(b, s, kvh, d)
                for causal in (True, False):
                    note("flash_attention_bf16", held_ulp(
                        "flash_attention_bf16",
                        kernels.flash_attention_op(q, k, v, causal),
                        ops._attention_plain(q, k, v, causal),
                        f"q={(b, s, h, d)} kv={kvh} causal={causal}",
                        ops._attention_plain(q.float(), k.float(),
                                             v.float().abs(), causal)))
    return worst


def gradient_sweep(dev) -> dict:
    """The gradient through each kernel op against the plain version's
    autograd on the same card inputs: every input's gradient within
    ``RTOL · max|plain gradient| + ATOL``, the output carrying a
    ``grad_fn``, and the forward one kernel launch (the scan: its backward
    kernel one launch too, every gradient bitwise).  The fp32 ops at this
    slice's path shapes (merged_conv and depthwise_conv at MobileNetV2's
    units, batch 8; merged_ffn at M 1024, D 576, R 1536, rmsnorm at
    (8, 128, 576) and causal flash_attention at (8, 128, 9, 64) over 3 kv
    heads, SmolLM-135M's replaced path) and at one shape each off it
    (rglru_scan at (8, 128, 2560); the three quantized bodies under
    w8a8, whose plain version is their ``*_qref``).  Returns
    ``{op: [max |Δ|, max |Δ| / scale, cases]}``."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import quant, ref
    g = torch.Generator().manual_seed(11)
    worst: dict = {}

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    def case(name, kernel, op, plain, args, diff, bwd=None):
        """``op(*args)`` against ``plain(*args)``, differentiated in the
        inputs whose positions are in ``diff``; with ``bwd`` (the op's
        backward kernel) one launch of it too, and every gradient
        bitwise."""
        start = kernels.launch_counts()[kernel]
        bwd_start = kernels.launch_counts()[bwd] if bwd else 0
        sides = []
        for fn in (op, plain):
            leaves = [a.clone().requires_grad_() if n in diff else a
                      for n, a in enumerate(args)]
            sides.append((fn(*leaves), leaves))
        (y, leaves), (yr, ref_leaves) = sides
        check(y.grad_fn is not None, f"{name}: the output through the "
              "kernel has no grad_fn")
        w = torch.randn(y.shape, generator=g).to(dev)
        got = torch.autograd.grad(y, [leaves[n] for n in diff], w)
        want = torch.autograd.grad(yr, [ref_leaves[n] for n in diff], w)
        n_launch = kernels.launch_counts()[kernel] - start
        check(n_launch == 1, f"{name}: {n_launch} launches of {kernel} "
              "over the forward, the plain version and both backwards "
              "(want the forward's 1)")
        if bwd:
            n_bwd = kernels.launch_counts()[bwd] - bwd_start
            check(n_bwd == 1, f"{name}: {n_bwd} launches of {bwd} over "
                  "both backwards (want the op's 1)")
            for n, a, b in zip(diff, got, want):
                check(torch.equal(a, b), f"{name}: the gradient wrt input "
                      f"{n} differs bitwise from the plain autograd")
        for n, a, b in zip(diff, got, want):
            res = held(f"{name} gradient", a, b, b.abs().amax(),
                       f"wrt input {n} of {[tuple(t.shape) for t in args]}")
            wst = worst.setdefault(name, [0.0, 0.0, 0])
            wst[0], wst[1] = max(wst[0], res[0]), max(wst[1], res[1])
            wst[2] += 1

    def conv(kind, x, w, b, stride, activation=None, wq=None):
        op = kernels.merged_conv_op if kind == "merged_conv" else \
            kernels.depthwise_conv_op
        if wq is None:
            fref = ref.merged_conv_ref if kind == "merged_conv" else \
                ref.depthwise_conv_ref
            case(kind, kind,
                 lambda x, w, b: op(x, w, b, stride=stride,
                                    activation=activation),
                 lambda x, w, b: ref.apply_activation(
                     fref(x, w, b, stride=stride), activation),
                 (x, w, b), (0, 1, 2))
            return
        qref = ref.merged_conv_qref if kind == "merged_conv" else \
            ref.depthwise_conv_qref
        wq, ws = quant.quantize_weight(w, wq, axis=3)
        case(kind + "_q", kind + "_q",
             lambda x, b, ws: op(x, wq, b, stride=stride, w_scale=ws,
                                 act_quant="w8a8"),
             lambda x, b, ws: qref(x, wq, b, ws, stride=stride,
                                   act_quant="w8a8"),
             (x, b, ws), (0, 1, 2))

    # MobileNetV2 (batch 8): the padded stem, an expansion 1x1 with relu6,
    # the 144-channel stride-2 and a 192-channel stride-1 depthwise unit
    conv("merged_conv", rnd(8, 226, 226, 3), rnd(3, 3, 3, 32, scale=0.27),
         rnd(32, scale=0.1), 2)
    conv("merged_conv", rnd(8, 28, 28, 32), rnd(1, 1, 32, 192, scale=0.18),
         rnd(192, scale=0.1), 1, activation="relu6")
    conv("depthwise_conv", rnd(8, 58, 58, 144), rnd(3, 3, 1, 144, scale=0.33),
         rnd(144, scale=0.1), 2)
    conv("depthwise_conv", rnd(8, 30, 30, 192), rnd(3, 3, 1, 192, scale=0.33),
         rnd(192, scale=0.1), 1, activation="relu6")
    # SmolLM-135M's replaced path at (8, 128): an unmerged FFN, a pre-norm,
    # the causal attention over 3 kv heads
    case("merged_ffn", "merged_ffn", kernels.merged_ffn_op,
         ref.merged_ffn_ref, (rnd(1024, 576), rnd(576, 1536, scale=0.042),
                              rnd(1536, 576, scale=0.026)), (0, 1, 2))
    case("rmsnorm", "rmsnorm", lambda x, s: kernels.rmsnorm_op(x, s),
         lambda x, s: ref.rmsnorm_ref(x, s), (rnd(8, 128, 576) * 3.0,
                                             rnd(576, scale=0.2)), (0, 1))
    case("flash_attention", "flash_attention",
         lambda q, k, v: kernels.flash_attention_op(q, k, v, True),
         lambda q, k, v: kernels.ops._attention_plain(q, k, v, True),
         (rnd(8, 128, 9, 64), rnd(8, 128, 3, 64), rnd(8, 128, 3, 64)),
         (0, 1, 2))
    # off this slice's path: the scan, and the quantized bodies
    a = (torch.rand(8, 128, 2560, generator=g) * 0.5 + 0.5).to(dev)
    case("rglru_scan", "rglru_scan", kernels.rglru_scan_op,
         ref.rglru_scan_ref, (a, rnd(8, 128, 2560, scale=0.1)), (0, 1),
         bwd="rglru_scan_bwd")
    conv("merged_conv", rnd(8, 28, 28, 32), rnd(1, 1, 32, 192, scale=0.18),
         rnd(192, scale=0.1), 1, wq="int8")
    conv("depthwise_conv", rnd(8, 30, 30, 192), rnd(3, 3, 1, 192, scale=0.33),
         rnd(192, scale=0.1), 1, wq="int8")
    uq, us = quant.quantize_weight(rnd(576, 576, scale=0.042), "int8", axis=1)
    vq, vs = quant.quantize_weight(rnd(576, 576, scale=0.042), "int8", axis=1)
    case("merged_ffn_q", "merged_ffn_q",
         lambda x, us, vs: kernels.merged_ffn_op(
             x, uq, vq, u_scale=us, v_scale=vs, act_quant="w8a8"),
         lambda x, us, vs: ref.merged_ffn_qref(x, uq, vq, us, vs,
                                               act_quant="w8a8"),
         (rnd(8, 576), us, vs), (0, 1, 2))
    return worst


# ---------------------------------------------------------------------------
# Main-path unit shapes, timing and bounds
# ---------------------------------------------------------------------------

def unit_inputs(graph, batch: int, hw: int, cin: int):
    """(unit, padded input shape) of every conv unit of a CNN graph."""
    h = w = hw
    c = cin
    saved = {0: (h, w, c)}
    out = []
    for u in graph.units:
        if u.kind == "conv":
            K = u.params["w"].shape[0]
            out.append((u, (batch, h + K - 1, w + K - 1, c)))
            h, w = -(-h // u.stride), -(-w // u.stride)
            c = u.params["w"].shape[3]
        elif u.kind == "pool":
            h, w = -(-h // u.stride), -(-w // u.stride)
        elif u.kind == "upsample":
            h, w = h * u.factor, w * u.factor
        if getattr(u, "concat_from", None) is not None:
            c += saved[u.concat_from][2]
        if u.save_at is not None:
            saved[u.save_at] = (h, w, c)
    return out


def conv_plan(x, w, stride) -> dict:
    """The launch plan merged_conv takes for these operands (the wrapper's
    own arithmetic), as the JSON rows record it."""
    import torch
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import merged_conv as mc_mod
    n, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    codes = (0, 0) if w.dtype == torch.float32 else (
        cuda_build.X_TYPES[x.dtype], cuda_build.W_TYPES[w.dtype])
    plan = mc_mod.launch_plan(
        n, h, wd, cin, kh, kw, cout, stride, *codes,
        x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0,
        cuda_build.sm_count(x.device))
    return {"tile": [plan.bm, plan.bn], "splits": plan.splits,
            "k_chunk": plan.k_chunk, "a_vec": plan.a_vec,
            "b_vec": plan.b_vec, "dense": plan.dense, "s8": plan.s8,
            "blocks": plan.blocks}


def time_main_path_kernels(graph, dev, batch: int, plain: bool = True,
                           label: str = "", hw: int = 224,
                           cin: int = 3) -> dict:
    """Per-kernel sums over a CNN graph's conv units (worst error, kernel /
    plain / library milliseconds, FLOPs, bytes and bound) and, under
    ``rows``, each unit's shapes, times, bound, share and (merged_conv)
    the launch plan it took, for an (batch, hw, hw, cin) input.
    merged_conv's operations are priced at 3xTF32 (``TC_RATES``),
    depthwise_conv's at the fp32 FFMA rate.  ``plain=False`` leaves out
    the plain versions' times."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.kernels import ref

    g = torch.Generator().manual_seed(1)
    rates = {"merged_conv": (TC_RATES["fp32", "fp32"][0],
                             tc_rate_label(("fp32", "fp32"))),
             "depthwise_conv": (H100_FP32_FLOPS, FFMA_RATE)}
    tot = {k: {"units": 0, "max_abs_err": 0.0, "max_rel_err": 0.0, "ms": 0.0,
               "plain_ms": 0.0, "library_ms": 0.0, "flops": 0.0,
               "bytes": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0,
               "flops_ms": 0.0, "bound_rate": rates[k][1], "rows": []}
           for k in ("merged_conv", "depthwise_conv")}
    for u, shape in unit_inputs(graph, batch, hw, cin):
        x = torch.randn(*shape, generator=g).to(dev)
        w, b, s = u.params["w"], u.params["b"], u.stride
        kh, kw, cin_g, cout = w.shape
        groups = shape[3] // cin_g if u.depthwise else 1
        kind = "depthwise_conv" if u.depthwise else "merged_conv"
        err, rel = compare_kernel(kind, x, w, b, s, groups=groups)
        if u.depthwise:
            def run():
                return kernels.depthwise_conv_op(x, w, b, stride=s,
                                                 groups=groups)

            def plain_fn():
                return ref.depthwise_conv_ref(x, w, b, stride=s,
                                              groups=groups)
        else:
            def run():
                return kernels.merged_conv_op(x, w, b, stride=s)

            def plain_fn():
                return ref.merged_conv_ref(x, w, b, stride=s)
        x_cl = x.permute(0, 3, 1, 2)              # NHWC viewed channels_last
        w_oihw = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)

        def library():
            return F.conv2d(x_cl, w_oihw, b, stride=s, groups=groups)
        n, hp, wp, _ = shape
        ho, wo = (hp - kh) // s + 1, (wp - kw) // s + 1
        flops = 2.0 * n * ho * wo * cout * kh * kw * cin_g
        nbytes = 4.0 * (x.numel() + w.numel() + b.numel() + n * ho * wo * cout)
        f_ms = flops / rates[kind][0] * 1e3
        b_ms = nbytes / H100_HBM_BW * 1e3
        row = {"x": list(shape), "w": list(w.shape), "stride": s,
               "ms": kernel_time(run),
               "plain_ms": kernel_time(plain_fn) if plain else None,
               "library_ms": kernel_time(library), "flops_ms": f_ms,
               "bytes_ms": b_ms, "bound_ms": max(f_ms, b_ms),
               "max_abs_err": err}
        row["share"] = row["bound_ms"] / row["ms"]
        if not u.depthwise:
            row["plan"] = conv_plan(x, w, s)
        check_bound(f"{label}{kind} {tuple(shape)}x{tuple(w.shape)}",
                    row["ms"], row["bound_ms"])
        t = tot[kind]
        for k in ("ms", "plain_ms", "library_ms", "flops_ms", "bytes_ms",
                  "bound_ms"):
            t[k] += row[k] or 0.0
        t["flops"] += flops
        t["bytes"] += nbytes
        t["units"] += 1
        t["max_abs_err"] = max(t["max_abs_err"], err)
        t["max_rel_err"] = max(t["max_rel_err"], rel)
        t["rows"].append(row)
    return tot


def traced_kernels(prof) -> dict:
    """{name: (device µs, launches)} of the device activity in a finished
    torch.profiler trace, read from its raw events: building the
    profiler's ``FunctionEvent`` tree (``prof.events()``) costs seconds a
    trace, and the script takes dozens of traces."""
    from torch.autograd import DeviceType
    by_name: dict = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        us, n = by_name.get(ev.name(), (0.0, 0))
        by_name[ev.name()] = (us + ev.duration_ns() / 1e3, n + 1)
    return by_name


def device_kernels(fn, reps: int = 5):
    """(device µs per call, [(µs per call, launches per call, name)]) of
    the kernels ``fn`` runs, from a torch.profiler trace of ``reps``
    calls; (0.0, []) where the profiler sees no device activity.  The
    trace records device activity only: host ops add nothing to these
    numbers and would take the profiler seconds to collect."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((us / reps, n // reps, name)
                   for name, (us, n) in traced_kernels(prof).items()),
                  reverse=True)
    return sum(r[0] for r in rows), rows


# ---------------------------------------------------------------------------
# merged_ffn: sweep, main-path shapes, the transformer path
# ---------------------------------------------------------------------------

def compare_ffn(x, u, v):
    """merged_ffn kernel vs ``merged_ffn_ref`` on the same card inputs:
    |Δ| ≤ RTOL · (|x| + (|x|·|U|)·|V|) + ATOL per output; returns
    (max |Δ|, max |Δ| / scale)."""
    from repro_torch import kernels
    from repro_torch.kernels import ref

    return held("merged_ffn", kernels.merged_ffn_op(x, u, v),
                ref.merged_ffn_ref(x, u, v),
                ref.merged_ffn_ref(x.abs(), u.abs(), v.abs()),
                f"x={tuple(x.shape)} u={tuple(u.shape)}")


def ffn_sweep(dev):
    """merged_ffn against its plain version over ragged M, D and R; at
    RecurrentGemma's D = 2560 with R 24, 2560 (a merged unit) and 7680
    (the replaced path's unmerged FFN) at M 8 and 1024; at D 2561 (rows
    not 16-byte aligned: the element-wise copies) over M {1, 8, 63, 64,
    65, 129, 1024}, across the small / large tile boundary, with R 24 and
    2560, and R 7680 at M 8."""
    import torch
    g = torch.Generator().manual_seed(2)
    worst = [0.0, 0.0, 0]
    cases = [(m, d, r) for m in (1, 8, 37, 1024) for d in (32, 96, 576)
             for r in (1, 24, 576, 1152, 1536)]
    cases += [(m, 2560, r) for m in (8, 1024) for r in (24, 2560, 7680)]
    cases += [(m, 2561, r) for m in (1, 8, 63, 64, 65, 129, 1024)
              for r in (24, 2560)] + [(8, 2561, 7680)]
    cases += [(m, 3584, r) for m in (8, 1024) for r in (24, 3584)]
    cases += [(TRAIN_NORM[0], TRAIN_NORM[1], TRAIN_NORM[1])]
    for m, d, r in cases:
        x = torch.randn(m, d, generator=g).to(dev)
        u = (torch.randn(d, r, generator=g) / d ** 0.5).to(dev)
        v = (torch.randn(r, d, generator=g) / r ** 0.5).to(dev)
        err, rel = compare_ffn(x, u, v)
        worst = [max(worst[0], err), max(worst[1], rel), worst[2] + 1]
    return worst


def ffn_bound(m: int, d: int, r: int) -> tuple[float, float]:
    """(operations ms, bytes ms) of x + (x@U)@V in fp32: 4·M·D·R FLOPs at
    the 3xTF32 rate; x, U, V read once and y written once at the HBM rate
    (P is not counted: the function does not need it)."""
    flops = 4.0 * m * d * r
    nbytes = 4.0 * (2 * m * d + 2 * d * r)
    return (flops / TC_RATES["fp32", "fp32"][0] * 1e3,
            nbytes / H100_HBM_BW * 1e3)


def tc_rate_label(*pairs) -> str:
    """The rate(s) a merged_ffn row's operations are priced at."""
    return ", ".join(
        f"{TC_RATES[p][1]} {TC_RATES[p][0] / 1e12:.6g} "
        + ("TOP/s" if TC_RATES[p][1] == "int8" else "TFLOP/s")
        for p in pairs)


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds per eager call of ``fn``: the time to enqueue
    ``calls`` calls, the device left to catch up afterwards."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def host_split(x, u, v) -> dict:
    """Host microseconds of one eager merged_ffn call at each layer: the op
    (reshapes and the wrapper), the wrapper (checks, plan, the output and
    workspace allocations, the launch), ``cuda_build.launch`` and the bare
    C call (its two kernel launches)."""
    from repro_torch import kernels
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import merged_ffn as mf_mod
    import torch
    m, d = x.shape
    r = u.shape[1]
    plan = mf_mod.launch_plan(m, d, r, torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    y, p = kernels.merged_ffn_op(x, u, v), x.new_empty(plan.workspace)
    args = (x.data_ptr(), u.data_ptr(), v.data_ptr(), y.data_ptr(),
            p.data_ptr(), m, d, r, *plan.args(), 1)      # with the residual
    fn = cuda_build.kernel("merged_ffn")
    stream = torch.cuda.current_stream().cuda_stream
    return {"op": host_us(lambda: kernels.merged_ffn_op(x, u, v)),
            "wrapper": host_us(lambda: mf_mod.merged_ffn(x, u, v)),
            "launch": host_us(lambda: cuda_build.launch(
                "merged_ffn", x.device, *args)),
            "c_call": host_us(lambda: fn(*args, stream))}


def ffn_slots() -> tuple[dict, bool]:
    """Blocks of each merged_ffn tile resident at once by cluster size (1
    up to its most splits), as this card reports them
    (``cudaOccupancyMaxActiveClusters``), and whether they are the launch
    plan's model of an H100 (``merged_ffn.H100_SLOTS``; another SM count
    takes the generic model, so it is not compared)."""
    import torch
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import merged_ffn as mf_mod
    fn = cuda_build.kernel("merged_ffn_slots")
    out = {}
    for name, tile in (("small", mf_mod.SMALL), ("large", mf_mod.LARGE)):
        got = [fn(tile[0], tile[1], s) for s in range(1, tile[3] + 1)]
        check(min(got) > 0, f"merged_ffn_slots {name}: error {-min(got)}")
        out[name] = got
    same = (torch.cuda.get_device_properties(0).multi_processor_count != 132
            or all(tuple(out[n]) == mf_mod.H100_SLOTS[t] for n, t in
                   (("small", mf_mod.SMALL), ("large", mf_mod.LARGE))))
    return out, same


def ffn_partial_sweep(dev) -> dict:
    """merged_ffn and its quantized variant with ``residual=False`` (a
    rank's partial of a split over the rank, phase 29) at phase 3's
    shapes: ``ffn_sweep``'s and ``qffn_sweep``'s, each against its plain
    version's ``(x̂·U)·V`` within RTOL of ``(|x̂|·|U|)·|V|``, and each
    twice on the same inputs, bitwise."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import quant, ref
    g = torch.Generator().manual_seed(29)
    fp = [(None, None, m, d, r) for m in (1, 8, 37, 1024)
          for d in (32, 96, 576) for r in (1, 24, 576, 1152, 1536)]
    fp += [(None, None, m, 2560, r) for m in (8, 1024)
           for r in (24, 2560, 7680)]
    fp += [(None, None, m, 2561, r) for m in (1, 8, 63, 64, 65, 129, 1024)
           for r in (24, 2560)]
    qc = [(wmode, aq, m, d, r) for wmode, aq in QMODES.values()
          for m in (1, 8, 37, 1024) for d in (96, 576) for r in (24, 576)]
    qc += [(wmode, aq, m, 2560, r) for wmode, aq in QPAIRS.values()
           for m in (8, 1024) for r in (24, 2560)]
    worst = {"merged_ffn": [0.0, 0.0, 0], "merged_ffn_q": [0.0, 0.0, 0]}
    for wmode, aq, m, d, r in fp + qc:
        x = torch.randn(m, d, generator=g).to(dev)
        u = (torch.randn(d, r, generator=g) / d ** 0.5).to(dev)
        v = (torch.randn(r, d, generator=g) / r ** 0.5).to(dev)
        if wmode is None:
            key, kw = "merged_ffn", {}
            yr = ref.merged_ffn_ref(x, u, v, residual=False)
            scale = ref.merged_ffn_ref(x.abs(), u.abs(), v.abs(),
                                       residual=False)
        else:
            key = "merged_ffn_q"
            u, us = quant.quantize_weight(u, wmode, axis=1)
            v, vs = quant.quantize_weight(v, wmode, axis=1)
            kw = dict(u_scale=us, v_scale=vs, act_quant=aq)
            yr = ref.merged_ffn_qref(x, u, v, us, vs, act_quant=aq,
                                     residual=False)
            scale = (dequantized_input(x, aq).abs()
                     @ quant.dequantize(u, us, axis=1).abs()
                     ) @ quant.dequantize(v, vs, axis=1).abs()
        y = kernels.merged_ffn_op(x, u, v, residual=False, **kw)
        y2 = kernels.merged_ffn_op(x, u, v, residual=False, **kw)
        case = f"residual=False x={(m, d)} r={r} {wmode or 'fp32'} {aq or ''}"
        err, rel = held(key, y, yr, scale, case)
        check(torch.equal(y, y2), f"{key} {case}: two calls on the same "
              "inputs differ bitwise")
        w = worst[key]
        worst[key] = [max(w[0], err), max(w[1], rel), w[2] + 1]
    return {f"{k} residual=False": v for k, v in worst.items()}


def ffn_determinism(dev) -> int:
    """Two calls of merged_ffn on the same inputs give bitwise the same y
    (the split reductions sum in a fixed order): a D 2560 unit at M 8 (the
    decode splits) and at M 1024; returns the cases checked."""
    import torch
    from repro_torch import kernels
    g = torch.Generator().manual_seed(9)
    for m in (8, 1024):
        x = torch.randn(m, 2560, generator=g).to(dev)
        u = (torch.randn(2560, 2560, generator=g) / 2560 ** 0.5).to(dev)
        v = (torch.randn(2560, 2560, generator=g) / 2560 ** 0.5).to(dev)
        y1, y2 = kernels.merged_ffn_op(x, u, v), kernels.merged_ffn_op(x, u, v)
        torch.cuda.synchronize()
        check(torch.equal(y1, y2), f"merged_ffn {(m, 2560, 2560)}: two "
              "calls on the same inputs differ bitwise")
    return 2


def attn_dw_determinism(dev) -> int:
    """Two calls of flash_attention (the path's four shapes) and of
    depthwise_conv, fp32 and w8a8 (three MobileNetV2 units), on the same
    inputs give bitwise the same output (every sum in a fixed order);
    returns the cases checked."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import quant
    g = torch.Generator().manual_seed(10)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    n = 0
    for b, s, h, kvh, d in ((8, 128, 10, 1, 256), (8, 16, 10, 1, 256),
                            (8, 128, 9, 3, 64), (8, 16, 9, 3, 64)):
        q, k, v = rnd(b, s, h, d), rnd(b, s, kvh, d), rnd(b, s, kvh, d)
        o1, o2 = (kernels.flash_attention_op(q, k, v, True)
                  for _ in range(2))
        torch.cuda.synchronize()
        check(torch.equal(o1, o2), f"flash_attention {(b, s, h, kvh, d)}: "
              "two calls on the same inputs differ bitwise")
        n += 1
    for hw, c, s in ((112, 32, 1), (28, 192, 2), (7, 960, 1)):
        x, w, b = rnd(8, hw + 2, hw + 2, c), rnd(3, 3, 1, c) / 3, rnd(c)
        wq, ws = quant.quantize_weight(w, "int8", axis=3)
        for kw in ({}, {"w_scale": ws, "act_quant": "w8a8"}):
            y1, y2 = (kernels.depthwise_conv_op(
                x, wq if kw else w, b, stride=s, groups=c,
                activation="relu6", **kw) for _ in range(2))
            torch.cuda.synchronize()
            check(torch.equal(y1, y2), f"depthwise_conv {(hw, c, s)} "
                  f"{'w8a8' if kw else 'fp32'}: two calls on the same inputs "
                  "differ bitwise")
            n += 1
    return n


def time_ffn(x, u, v) -> dict:
    """Kernel, plain and library ms of one merged_ffn shape, beside its
    bound.  The library yardstick is ``torch.addmm(x, x @ U, V)``: two
    cuBLAS calls (TF32 off), timed here and used nowhere in the port."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import ref

    err, rel = compare_ffn(x, u, v)
    f_ms, b_ms = ffn_bound(x.shape[0], x.shape[1], u.shape[1])
    row = {"m": x.shape[0], "d": x.shape[1], "r": u.shape[1],
           "max_abs_err": err, "max_rel_err": rel,
           "ms": kernel_time(lambda: kernels.merged_ffn_op(x, u, v)),
           "plain_ms": kernel_time(lambda: ref.merged_ffn_ref(x, u, v)),
           "library_ms": kernel_time(lambda: torch.addmm(x, x @ u, v)),
           "eager_ms": cuda_time(lambda: kernels.merged_ffn_op(x, u, v)),
           "host_us": host_us(lambda: kernels.merged_ffn_op(x, u, v)),
           "flops_ms": f_ms, "bytes_ms": b_ms, "bound_ms": max(f_ms, b_ms),
           "bound_rate": tc_rate_label(("fp32", "fp32"))}
    check_bound(f"merged_ffn {tuple(x.shape)}x{tuple(u.shape)}", row["ms"],
                row["bound_ms"])
    return row


def forced_logits(step, cache, tokens):
    """``(B, T, V)`` logits of feeding ``tokens`` (B, T) one at a time."""
    import torch
    out = []
    for t in range(tokens.shape[1]):
        logits, cache = step(cache, tokens[:, t:t + 1])
        out.append(logits[:, -1])
    return torch.stack(out, dim=1)


class CountCalls:
    """Counts the calls of the method ``owner.name`` while active (it is
    wrapped): CUDA-graph replays, the engine's chunks."""

    def __init__(self, owner, name: str):
        self.owner, self.name = owner, name

    def __enter__(self):
        self.n = 0
        self._orig = orig = getattr(self.owner, self.name)

        def counted(*args, **kw):
            self.n += 1
            return orig(*args, **kw)
        setattr(self.owner, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self._orig)


def serve_both(label, step, new_cache, prompt, new_tokens, pertoken=None):
    """Serve ``prompt`` through the captured ``serve_loop`` and, on the
    same step, through ``serve_loop_pertoken`` (inside the context
    ``pertoken``, when given): the two must give the same tokens, the
    captured loop one graph replay per prompt position and per generated
    token, and a decode no slower than the per-token loop's.  Then one
    more capture of the same step gives the capture's seconds, the
    launches it counted (one step's) and, from a torch.profiler trace of
    its decode replays, the device-busy share of the captured decode."""
    import contextlib

    import torch
    from repro_torch.runtime import serving

    B, P = prompt.shape
    N = new_tokens
    with CountCalls(torch.cuda.CUDAGraph, "replay") as rp:
        pre, dec, lg, seqs = serving.serve_loop(step, new_cache, prompt, N)
    with pertoken or contextlib.nullcontext():
        pre_pt, dec_pt, lg_pt, seqs_pt = serving.serve_loop_pertoken(
            step, new_cache, prompt, N)
    steps = P + N - 1
    run = serving._StepGraph(step, new_cache(), B, steps)
    lengths = torch.full((B,), P)
    run.prepare(prompt, lengths)
    run.reset(prompt, lengths)
    run.advance(P + 1)
    busy_us, rows = device_kernels(lambda: run.advance(1), reps=N - 3)
    res = {"prefill_ms": pre * 1e3, "decode_ms": dec * 1e3,
           "tok_s": serving.decode_tok_s(N - 1, B, dec),
           "pertoken_prefill_ms": pre_pt * 1e3,
           "pertoken_decode_ms": dec_pt * 1e3,
           "pertoken_tok_s": serving.decode_tok_s(N - 1, B, dec_pt),
           "replays_per_token": rp.n / (2 * steps),
           "capture_s": run.capture_s, "launches_per_step": run.launches,
           "busy_us": busy_us, "busy_share": busy_us * 1e-6 / (dec / (N - 1)),
           "logits_vs_pertoken": rel_diff(lg, lg_pt),
           "logits_bitwise": bool(torch.equal(lg, lg_pt))}
    print(f"  {label}: captured prefill {res['prefill_ms']:.3f} ms, decode "
          f"{res['decode_ms']:.3f} ms ({res['tok_s']:.1f} tok/s); per-token "
          f"prefill {res['pertoken_prefill_ms']:.3f} ms, decode "
          f"{res['pertoken_decode_ms']:.3f} ms ({res['pertoken_tok_s']:.1f} "
          f"tok/s); {res['tok_s'] / res['pertoken_tok_s']:.3f}x; capture "
          f"{res['capture_s']:.3f}s; graph replays per prompt position and "
          f"generated token {res['replays_per_token']:.3f}; launches per "
          f"step (counted at the capture) {json.dumps(run.launches)}; "
          f"captured decode, torch.profiler: device busy {busy_us:.1f} us "
          f"per step = {res['busy_share']:.3f} of its served step; by "
          "kernel: " + ("; ".join(f"{name[:60]} {us:.1f}us x{n}"
                                  for us, n, name in rows[:6])
                        or "no device activity seen")
          + f"; last prefill logits captured vs per-token "
          f"{res['logits_vs_pertoken']:.3g} (bitwise "
          f"{res['logits_bitwise']})", flush=True)
    check(bool(torch.equal(seqs, seqs_pt)), f"{label}: the captured and the "
          "per-token loop give different tokens")
    check(rp.n == 2 * steps, f"{label}: {rp.n} graph replays for 2 x "
          f"{steps} steps")
    check(res["decode_ms"] <= res["pertoken_decode_ms"], f"{label}: the "
          f"captured decode ({res['decode_ms']:.3f} ms) is slower than the "
          f"per-token loop's ({res['pertoken_decode_ms']:.3f} ms)")
    return pre, dec, lg, seqs, res


def unit_census(graph) -> str:
    from repro_torch import runtime
    return json.dumps(runtime.count_units(graph), sort_keys=True)


# ---------------------------------------------------------------------------
# The quantized path: captured units, bounds, timing
# ---------------------------------------------------------------------------

class QuantCalls:
    """Records every quantized op call the executor makes while active
    (the package attributes it calls through are wrapped), with its
    arguments and output, so that each quantized unit can be checked and
    timed on the input it had on the main path."""

    NAMES = ("merged_conv_op", "depthwise_conv_op", "merged_ffn_op")

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch import kernels
        self._orig = {n: getattr(kernels, n) for n in self.NAMES}
        for n in self.NAMES:
            setattr(kernels, n, self._wrap(n, self._orig[n]))
        return self

    def _wrap(self, name, fn):
        def op(*args, **kw):
            y = fn(*args, **kw)
            if kw.get("w_scale") is not None or kw.get("u_scale") is not None:
                self.calls.append((name, args, kw, y))
            return y
        return op

    def __exit__(self, *exc):
        from repro_torch import kernels
        for n, fn in self._orig.items():
            setattr(kernels, n, fn)


class ActCodes:
    """While active, records the per-tensor int8 activation codes and
    scales that ``quant.quantize_int8`` gives (w8a8 units), or — given a
    record — replays them in the same order in place of the codes it
    computes, counting the codes that differ (``flips``): a CPU run of an
    artifact fed the card's activation codes computes what the card did,
    up to fp32 reassociation."""

    def __init__(self, replay=None):
        self.codes = [] if replay is None else replay
        self.replay = replay is not None
        self.used = self.flips = self.total = 0

    def __enter__(self):
        from repro_torch.kernels import quant
        self._orig = orig = quant.quantize_int8

        def quantize_int8(x, axis=None, **kw):
            q, s = orig(x, axis, **kw)
            if axis is not None:                     # a weight's channels
                return q, s
            if not self.replay:
                self.codes.append((q.cpu(), s.cpu()))
                return q, s
            qr, sr = self.codes[self.used]
            self.used += 1
            # (the card's op flattens leading axes, the plain version not)
            check(qr.numel() == q.numel(), "replayed activation codes out "
                  "of step with the run")
            qr = qr.reshape(q.shape)
            self.flips += int((qr != q.cpu()).sum())
            self.total += q.numel()
            return qr.to(q.device), sr.to(s.device)
        quant.quantize_int8 = quantize_int8
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import quant
        quant.quantize_int8 = self._orig


def act_unquantized(art):
    """``art`` with its w8a8 units run as int8 ones (narrow weights, fp32
    activations): the same network without activation rounding."""
    import dataclasses
    units = tuple(dataclasses.replace(u, quant="int8")
                  if getattr(u, "quant", "none") == "w8a8" else u
                  for u in art.graph.units)
    return dataclasses.replace(art, graph=dataclasses.replace(
        art.graph, units=units))


def rel_diff(a, b) -> float:
    """max |a − b| / max |b|, on the CPU."""
    a, b = a.detach().cpu(), b.detach().cpu()
    return float((a - b).abs().max() / b.abs().max())


def conv_call_parts(name, args, kw):
    """(kind, x, wq, ws, b, stride, groups, act_quant) of a recorded conv
    op call (the executor passes x, w, b positionally)."""
    x, wq, b = args
    kind = "depthwise_conv" if name == "depthwise_conv_op" else "merged_conv"
    groups = x.shape[-1] // wq.shape[2] if kind == "depthwise_conv" else 1
    return (kind, x, wq, kw["w_scale"], b, kw.get("stride", 1), groups,
            kw.get("act_quant", "none"))


def time_qconv(kind, x, wq, ws, b, stride, groups, aq) -> dict:
    """One quantized conv unit at its main-path shape: the kernel alone
    (on the codes and folded scale the op computes), the eager activation
    quantization pass, the whole op, the fp32 kernel on the dequantized
    weight, the plain version, and the library yardstick (one ``F.conv2d``
    on the dequantized operands: no PyTorch call takes int8 weights with a
    channel-scale epilogue), beside the bound at narrow widths."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.kernels import depthwise_conv as dw_mod
    from repro_torch.kernels import merged_conv as mc_mod
    from repro_torch.kernels import quant, ref

    xq, folded = x, ws
    if aq == "w8a8":
        xq, xs = quant.quantize_int8(x)
        folded = (ws * xs).contiguous()
    wd = quant.dequantize(wq, ws, axis=3)
    xd = dequantized_input(x, aq)
    if kind == "depthwise_conv":
        def run():
            return dw_mod.depthwise_conv(xq, wq, b, stride=stride,
                                         groups=groups, w_scale=folded)

        def op():
            return kernels.depthwise_conv_op(x, wq, b, stride=stride,
                                             groups=groups, w_scale=ws,
                                             act_quant=aq)

        def fp32():
            return kernels.depthwise_conv_op(x, wd, b, stride=stride,
                                             groups=groups)

        def plain():
            return ref.depthwise_conv_qref(x, wq, b, ws, stride=stride,
                                           groups=groups, act_quant=aq)
    else:
        def run():
            return mc_mod.merged_conv(xq, wq, b, stride=stride,
                                      w_scale=folded)

        def op():
            return kernels.merged_conv_op(x, wq, b, stride=stride,
                                          w_scale=ws, act_quant=aq)

        def fp32():
            return kernels.merged_conv_op(x, wd, b, stride=stride)

        def plain():
            return ref.merged_conv_qref(x, wq, b, ws, stride=stride,
                                        act_quant=aq)
    x_cl = xd.permute(0, 3, 1, 2)
    w_oihw = wd.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)

    def library():
        return F.conv2d(x_cl, w_oihw, b, stride=stride, groups=groups)
    n, hp, wp, _ = x.shape
    kh, kw, cin_g, cout = wq.shape
    ho, wo = (hp - kh) // stride + 1, (wp - kw) // stride + 1
    flops = 2.0 * n * ho * wo * cout * kh * kw * cin_g
    nbytes = (x.numel() * (1 if aq == "w8a8" else 4) + wq.numel()
              + 4.0 * (ws.numel() + (0 if b is None else b.numel()))
              + 4.0 * n * ho * wo * cout)
    if kind == "merged_conv":
        # priced at the tensor-core rate of the instance's operand types
        pair = (("int8", "int8" if wq.dtype == torch.int8 else "e4m3")
                if aq == "w8a8" else ("fp32", "narrow"))
        rate, rate_label = TC_RATES[pair][0], tc_rate_label(pair)
    else:
        rate, rate_label = H100_FP32_FLOPS, FFMA_RATE
    out = {"kind": kind, "x": list(x.shape), "w": list(wq.shape),
           "w_dtype": str(wq.dtype), "stride": stride, "act_quant": aq,
           "ms": kernel_time(run), "plain_ms": kernel_time(plain),
           "library_ms": kernel_time(library), "fp32_ms": kernel_time(fp32),
           "op_ms": kernel_time(op),
           "qpass_ms": (kernel_time(lambda: quant.quantize_int8(x))
                        if aq == "w8a8" else 0.0),
           "flops_ms": flops / rate * 1e3,
           "bytes_ms": nbytes / H100_HBM_BW * 1e3, "bound_rate": rate_label}
    out["bound_ms"] = max(out["flops_ms"], out["bytes_ms"])
    out["share"] = out["bound_ms"] / out["ms"]
    if kind == "merged_conv":
        out["plan"] = conv_plan(xq, wq, stride)
    return out


def time_qffn(x, uq, us, vq, vs, aq) -> dict:
    """One quantized merged_ffn unit at M = x.shape[0]: the kernel alone,
    the activation quantization pass, the whole op, the fp32 kernel on the
    dequantized factors, the plain version and ``torch.addmm(x, x̂ @ Û,
    V̂)`` on the dequantized operands (two cuBLAS calls), beside the
    bound at narrow widths."""
    from repro_torch import kernels
    from repro_torch.kernels import merged_ffn as mf_mod
    from repro_torch.kernels import quant, ref
    import torch

    xq, folded = None, us
    if aq == "w8a8":
        xq, xs = quant.quantize_int8(x)
        folded = (us * xs).contiguous()
    ud, vd = quant.dequantize(uq, us, axis=1), quant.dequantize(vq, vs, axis=1)
    xd = dequantized_input(x, aq)
    err, rel = compare_qffn(x, uq, us, vq, vs, aq)
    m, d = x.shape
    r = uq.shape[1]
    nbytes = (4.0 * 2 * m * d + (m * d if aq == "w8a8" else 0)
              + uq.numel() + vq.numel() + 4.0 * (r + d))
    # phase A: the panel x U, phase B: fp32 P x V
    pair_a = (("int8", "int8" if uq.dtype == torch.int8 else "e4m3")
              if aq == "w8a8" else ("fp32", "narrow"))
    pair_b = ("fp32", "narrow")
    flops_ms = sum(2.0 * m * d * r / TC_RATES[p][0] * 1e3
                   for p in (pair_a, pair_b))
    out = {"m": m, "d": d, "r": r, "w_dtype": str(uq.dtype), "act_quant": aq,
           "max_abs_err": err, "max_rel_err": rel,
           "ms": kernel_time(lambda: mf_mod.merged_ffn(
               x, uq, vq, u_scale=folded, v_scale=vs, xq=xq)),
           "op_ms": kernel_time(lambda: kernels.merged_ffn_op(
               x, uq, vq, u_scale=us, v_scale=vs, act_quant=aq)),
           "qpass_ms": (kernel_time(lambda: quant.quantize_int8(x))
                        if aq == "w8a8" else 0.0),
           "fp32_ms": kernel_time(lambda: kernels.merged_ffn_op(x, ud, vd)),
           "plain_ms": kernel_time(lambda: ref.merged_ffn_qref(
               x, uq, vq, us, vs, act_quant=aq)),
           "library_ms": kernel_time(lambda: torch.addmm(x, xd @ ud, vd)),
           "flops_ms": flops_ms, "bytes_ms": nbytes / H100_HBM_BW * 1e3,
           "bound_rate": tc_rate_label(pair_a, pair_b)}
    out["bound_ms"] = max(out["flops_ms"], out["bytes_ms"])
    return out


def cnn_quant_phases(compress_main, cnn_argv, oracle, host, batches,
                     orig_graph, dev, out_shape):
    """Phases 11-12: the w8a8 MobileNetV2 path (compress through the CLI
    with phase 4's oracle, artifact, served batches held against the CPU
    port and the plan's fp lowering), then each quantized unit checked and
    timed at its card input.  Returns (totals by kernel, launches)."""
    import torch
    from repro_torch import kernels, runtime

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    q_path = os.path.join(WORK, "mobilenetv2_w8a8.npz")
    ladder = []
    for ratio in Q_BUDGETS:
        summary = compress_main(cnn_argv + [
            "--budget-ratio", str(ratio), "--quantize", "w8a8", "--out",
            q_path], latency_oracle=oracle)
        check_probes(oracle, summary, f"w8a8 compress at {ratio}")
        art = runtime.load(q_path, device=dev)
        census = quant_census(art.graph)
        ladder.append(f"{ratio}: {json.dumps(census, sort_keys=True)}, "
                      f"predicted {summary['predicted_speedup']:.4f}")
        if census.get("conv_w8a8") and census.get("dwconv_w8a8"):
            break
    check(bool(census.get("conv_w8a8") and census.get("dwconv_w8a8")),
          f"w8a8: no budget in {Q_BUDGETS} gives a plan with a quantized "
          f"dense and depthwise unit ({'; '.join(ladder)})")
    with QuantCalls() as qcalls, ActCodes() as codes:
        outs = [art.apply(xb.to(dev)) for xb in batches]
        torch.cuda.synchronize()
    launch = kernels.launch_counts()
    art_cpu = runtime.load(q_path, device="cpu")
    fp_graph = host.lower_plan(fp_plan(art.plan))
    d_cpu = d_rep = d_act = d_fp = 0.0
    with ActCodes(codes.codes) as replay:
        rep_outs = [art_cpu.apply(xb) for xb in batches]
    for xb, y, y_rep in zip(batches, outs, rep_outs):
        check(tuple(y.shape) == out_shape and bool(torch.isfinite(y).all()),
              f"quantized network: logits {tuple(y.shape)} or non-finite")
        y_cpu = art_cpu.apply(xb)
        d_cpu = max(d_cpu, rel_diff(y, y_cpu))
        d_rep = max(d_rep, rel_diff(y, y_rep))
        d_act = max(d_act, rel_diff(y_cpu, act_unquantized(art_cpu).apply(xb)))
        d_fp = max(d_fp, rel_diff(y, runtime.execute(fp_graph, xb.to(dev),
                                                     device=dev)))
    n_fwd = len(qcalls.calls) // len(batches)
    parts = [conv_call_parts(name, args, kw)
             for name, args, kw, _ in qcalls.calls[:n_fwd]]
    bound = NET_RTOL + 2.0 * d_act
    xb = batches[0].to(dev)
    ms_q = cuda_time(lambda: art.apply(xb), iters=20)
    ms_fp = cuda_time(lambda: runtime.execute(fp_graph, xb, device=dev),
                      iters=20)
    ms_o = cuda_time(lambda: runtime.execute(orig_graph, xb, device=dev),
                     iters=20)
    log("q serve", t0, f"w8a8 budgets {'; '.join(ladder)}; census "
        f"{json.dumps(census, sort_keys=True)}; {len(batches)} batches, "
        f"worst logits vs CPU port {d_cpu:.3g} (bound {bound:.3g}: "
        f"{NET_RTOL} + 2 x {d_act:.3g}, the CPU port's activation rounding;"
        f" {replay.flips} of {replay.total} activation codes differ), vs "
        f"the CPU port fed the card's codes {d_rep:.3g} (limit {NET_RTOL}),"
        f" vs the fp lowering of the plan {d_fp:.3g} (limit {Q_FP_RTOL}); "
        f"forward quantized "
        f"{ms_q:.3f} ms, fp plan {ms_fp:.3f} ms, original {ms_o:.3f} ms "
        f"(measured {ms_o / ms_q:.3f}x, predicted "
        f"{summary['predicted_speedup']:.4f}x); launches phase 11 {launch}")
    print_profile("quantized forward", art.apply, xb, ms_q)
    check(d_cpu <= bound, f"quantized network: card vs CPU port differ by "
          f"{d_cpu} > {bound}")
    check(replay.used == len(codes.codes) and d_rep <= NET_RTOL,
          f"quantized network: card vs CPU port on the card's activation "
          f"codes differ by {d_rep} > {NET_RTOL}")
    check(d_fp < Q_FP_RTOL, f"quantized network: vs fp lowering {d_fp} >= "
          f"{Q_FP_RTOL}")
    for k in ("merged_conv_q", "depthwise_conv_q"):
        check(launch[k] > 0, f"kernel {k} never launched on the quantized "
              "path")

    # 12. each quantized unit of one forward, at its card input
    t0 = time.perf_counter()
    units = []
    for kind, x, wq, ws, b, st, g, aq in parts:
        err, rel = compare_qkernel(kind, x, wq, ws, b, st, aq, groups=g)
        units.append(dict(time_qconv(kind, x, wq, ws, b, st, g, aq),
                          max_abs_err=err, max_rel_err=rel))
    tot = {}
    for k, kind in (("merged_conv_q", "merged_conv"),
                    ("depthwise_conv_q", "depthwise_conv")):
        rows = [r for r in units if r["kind"] == kind]
        tot[k] = {f: sum(r[f] for r in rows) for f in Q_FIELDS}
        tot[k]["units"] = len(rows)
        tot[k]["max_abs_err"] = max((r["max_abs_err"] for r in rows),
                                    default=0.0)
        tot[k]["bound_rate"] = "; ".join(sorted({r["bound_rate"]
                                                 for r in rows}))
        for r in rows:
            check_bound(f"{k} {tuple(r['x'])}x{tuple(r['w'])}", r["ms"],
                        r["bound_ms"])
    with open(os.path.join(WORK, "qunits.json"), "w") as f:
        json.dump(units, f, indent=1)
    log("quantized conv units", t0, " ".join(
        f"{k}: {v['units']} units ms={v['ms']:.4f} (fp32 kernel "
        f"{v['fp32_ms']:.4f}; activation quantization {v['qpass_ms']:.4f}; "
        f"op {v['op_ms']:.4f}) plain={v['plain_ms']:.4f} "
        f"library(F.conv2d, dequantized)={v['library_ms']:.4f} "
        f"bound={v['bound_ms']:.4f} max|Δ|={v['max_abs_err']:.3g};"
        for k, v in tot.items()))
    return tot, launch


def lm_quant_phases(host, fp_res, oracle, lm_source, prompt, new_tokens,
                    fp_decode_s, dev):
    """Phases 13-14: the w8a8 transformer path under the decode-shaped
    ``CostEnv(batch=B, seq=1)`` (depth ladder; phase 8's plan with its
    lowrank segments set to w8a8 if the DP picks no w8a8 unit), the v3
    artifact served and held against the CPU port step by step, then each
    quantized merged_ffn unit timed at decode.  Returns (decode-step
    totals, launches, the serving numbers of :func:`serve_both`)."""
    import dataclasses

    import torch
    from repro_torch import kernels, runtime
    from repro_torch.core import compress
    from repro_torch.core.tables import build_tables, quant_sibling_entries
    from repro_torch.kernels import merged_ffn as mf_mod
    from repro_torch.kernels import quant
    from repro_torch.models.transformer_host import CostEnv, TransformerHost
    from repro_torch.runtime import serving

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    B, P = prompt.shape
    N = new_tokens
    cfg = host.cfg
    sib_fp = quant_sibling_entries(host, fp_res.tables.entries, "w8a8")[1]
    host_q = TransformerHost(cfg, host.params, env=CostEnv(batch=B, seq=1),
                             device=dev)
    wide, sib = quant_sibling_entries(host_q, build_tables(
        host_q, method="depth", latency_oracle=oracle,
        probe_config=strict_probes()).entries, "w8a8")
    ratios = [row[k][1] / row[k[0]][1] for row in wide.values()
              for k in row if isinstance(k, tuple)]
    res, ladder = None, []
    for ratio in LM_BUDGETS:
        r = compress(host_q, budget_ratio=ratio, method="depth",
                     latency_oracle=oracle, quantize="w8a8",
                     probe_config=strict_probes())
        n_q = 0 if r is None else quant_census(r.lower()).get(
            "lowrank_w8a8", 0)
        ladder.append(f"{ratio}: " + ("infeasible" if r is None else
                                      f"{n_q} w8a8 lowrank, predicted "
                                      f"{r.speedup:.4f}"))
        if n_q:
            res = r
            break
    if res is not None:
        plan, chosen = res.plan, f"chosen by the DP, predicted " \
            f"{res.speedup:.4f}"
    else:
        # The DP picked no w8a8 unit: serve phase 8's plan with its lowrank
        # segments set to w8a8 (a plan is data; lower_plan takes it).
        # (a segment has a merged rank map where it has a quantized cost)
        plan = dataclasses.replace(fp_res.plan, segments=tuple(
            dataclasses.replace(sg, quant="w8a8")
            if host_q.segment_cost(sg, quant="w8a8") is not None else sg
            for sg in fp_res.plan.segments))
        chosen = "not chosen by the DP: phase 8's plan, lowrank set to w8a8"
    path = os.path.join(WORK, "smollm135m_w8a8.npz")
    runtime.save(path, host_q.lower_plan(plan), plan=plan, meta={
        "source": lm_source, "quantized_units": sum(
            1 for sg in plan.segments if sg.quant != "none")})
    art = runtime.load(path, device=dev)

    def step(c, t):
        return art.decode(c, t)
    calls = QuantCalls()
    q_pre, q_dec, _, seqs, q_serve = serve_both(
        "w8a8 compressed", step, lambda: art.init_cache(B, P + N), prompt, N,
        pertoken=calls)
    launch = kernels.launch_counts()
    check(tuple(seqs.shape) == (B, N), f"served ids {tuple(seqs.shape)}")
    fed = torch.cat([prompt, seqs[:, :-1]], dim=1)
    with ActCodes() as codes:
        lg = forced_logits(step, art.init_cache(B, P + N), fed)
        torch.cuda.synchronize()
    check(bool(torch.isfinite(lg).all()), "non-finite quantized logits")
    check(bool((lg[:, P - 1:].argmax(-1) == seqs).all()),
          "quantized served ids are not the argmax of the forced logits")

    def cpu_logits(a):
        return forced_logits(lambda c, t: a.decode(c, t),
                             a.init_cache(B, P + N), fed.cpu())

    def worst_step(a, b):
        return float(((a.cpu() - b).abs().amax(dim=(0, 2))
                      / b.abs().amax(dim=(0, 2))).max())
    art_cpu = runtime.load(path, device="cpu")
    lg_cpu = cpu_logits(art_cpu)
    with ActCodes(codes.codes) as replay:
        lg_rep = cpu_logits(art_cpu)
    d_cpu, d_rep = worst_step(lg, lg_cpu), worst_step(lg, lg_rep)
    d_act = worst_step(lg_cpu, cpu_logits(act_unquantized(art_cpu)))
    bound = NET_RTOL + 2.0 * d_act
    # (c): each w8a8 unit of the last served step, on its card input
    n_units = sum(1 for u in art.graph.units if u.kind == "lowrank")
    unit_err = max(compare_qffn(x, uq, kw["u_scale"], vq, kw["v_scale"],
                                kw["act_quant"])[1]
                   for _, (x, uq, vq), kw, _ in calls.calls[-n_units:])
    n_qlr = quant_census(art.graph).get("lowrank_w8a8", 0)
    steps = N - 1
    log("lm q serve", t0, f"w8a8, CostEnv(batch={B}, seq=1): {sib} w8a8 "
        f"siblings (T_q / T_fp {min(ratios, default=1):.4f}-"
        f"{max(ratios, default=1):.4f}; phase 8's seq=128 env: {sib_fp}); "
        f"depth budgets {'; '.join(ladder)}; served: {n_qlr} w8a8 lowrank "
        f"units, {chosen}; {B} prompts x {P} tokens, {N} new; worst step "
        f"logits vs CPU port {d_cpu:.3g} (bound {bound:.3g}: {NET_RTOL} + "
        f"2 x {d_act:.3g}, the CPU port's activation rounding; "
        f"{replay.flips} of {replay.total} activation codes differ), vs "
        f"the CPU port fed the card's codes {d_rep:.3g} (limit {NET_RTOL});"
        f" units of the last step vs plain versions on their card inputs: "
        f"max |Δ| / scale {unit_err:.3g} (limit {RTOL}); decode "
        f"{q_dec * 1e3:.3f} ms "
        f"({serving.decode_tok_s(steps, B, q_dec):.1f} tok/s) against the "
        f"fp plan's {fp_decode_s * 1e3:.3f} ms "
        f"({serving.decode_tok_s(steps, B, fp_decode_s):.1f} tok/s); "
        f"prefill {q_pre * 1e3:.3f} ms; launches per decode step (counted "
        f"at the capture) {json.dumps(q_serve['launches_per_step'])}; "
        f"launches phase 13 {launch}")
    check(n_qlr >= 1, "the served plan has no w8a8 lowrank unit")
    check(d_cpu <= bound, f"quantized lm: card vs CPU port differ by "
          f"{d_cpu} > {bound}")
    check(replay.used == len(codes.codes) and d_rep <= NET_RTOL,
          f"quantized lm: card vs CPU port on the card's activation codes "
          f"differ by {d_rep} > {NET_RTOL}")
    check(launch["merged_ffn_q"] > 0,
          "merged_ffn_q never launched on the quantized transformer path")

    # 14. each quantized merged_ffn unit at decode (M = B)
    t0 = time.perf_counter()
    x = torch.randn(B, cfg.d_model,
                    generator=torch.Generator().manual_seed(3)).to(dev)
    rows = [time_qffn(x, u.params["u"], u.params["u_scale"], u.params["v"],
                      u.params["v_scale"], u.quant)
            for u in art.graph.units
            if u.kind == "lowrank" and u.quant != "none"]
    tot = {f: sum(r[f] for r in rows) for f in Q_FIELDS}
    tot["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    tot["bound_rate"] = " / ".join(sorted({r["bound_rate"] for r in rows}))
    # the first unit's factors in each variant the kernel takes, alone
    u0 = next(u for u in art.graph.units if u.kind == "lowrank")
    ud = quant.dequantize(u0.params["u"], u0.params["u_scale"], axis=1)
    vd = quant.dequantize(u0.params["v"], u0.params["v_scale"], axis=1)
    variants = {"fp32": kernel_time(lambda: mf_mod.merged_ffn(x, ud, vd))}
    xq, xs = quant.quantize_int8(x)
    for name, wmode, panel in (("int8", "int8", None), ("w8a8", "int8", xq),
                               ("fp8", "fp8", None)):
        uq, us = quant.quantize_weight(ud, wmode, axis=1)
        vq, vs = quant.quantize_weight(vd, wmode, axis=1)
        if panel is not None:
            us = us * xs
        variants[name] = kernel_time(lambda: mf_mod.merged_ffn(
            x, uq, vq, u_scale=us, v_scale=vs, xq=panel))
    with open(os.path.join(WORK, "qffn.json"), "w") as f:
        json.dump({"decode_units": rows, "decode_step": tot,
                   "variants_ms": variants}, f, indent=1)
    r = rows[0]
    log("merged_ffn_q shapes", t0, f"M={r['m']} D={r['d']} R={r['r']} "
        f"{r['w_dtype']} {r['act_quant']}: ms={r['ms']:.4f} (fp32 kernel "
        f"{r['fp32_ms']:.4f}; activation quantization {r['qpass_ms']:.4f}; "
        f"op {r['op_ms']:.4f}) plain={r['plain_ms']:.4f} "
        f"library(addmm, dequantized)={r['library_ms']:.4f} "
        f"bound={r['bound_ms']:.5f}; decode step ({len(rows)} units): "
        f"ms={tot['ms']:.4f} op={tot['op_ms']:.4f} "
        f"fp32={tot['fp32_ms']:.4f} plain={tot['plain_ms']:.4f} "
        f"library={tot['library_ms']:.4f} bound={tot['bound_ms']:.5f}; one "
        f"unit's kernel by variant (ms): {json.dumps(variants)}")
    return tot, launch, q_serve


def quant_census(graph) -> dict:
    """Units by precision, and the quantized ones by kind."""
    out = {"fp": 0, "int8": 0, "w8a8": 0}
    for u in graph.units:
        q = getattr(u, "quant", "none")
        out["fp" if q == "none" else q] += 1
        if q != "none":
            key = ("dwconv" if u.kind == "conv" and u.depthwise
                   else u.kind) + "_" + q
            out[key] = out.get(key, 0) + 1
    return out


def fp_plan(plan):
    """The same plan with every segment at full precision."""
    import dataclasses
    return dataclasses.replace(plan, segments=tuple(
        dataclasses.replace(s, quant="none") for s in plan.segments))


# ---------------------------------------------------------------------------
# RecurrentGemma-2B: compress, serve, the path's kernel shapes
# ---------------------------------------------------------------------------

def merged_segments(host, plan) -> int:
    """Segments of ``plan`` that lower to a lowrank unit, counted without
    lowering (at d 2560 each merged segment costs an SVD to lower)."""
    return sum(1 for sg in plan.segments
               if not sg.original and host._rank(sg) > 0)


def norm_bound(m: int, d: int) -> tuple[float, float]:
    """(operations ms, bytes ms) of rmsnorm on (M, D): 5 FLOPs an element;
    x read and y written once, g read once."""
    return (5.0 * m * d / H100_FP32_FLOPS * 1e3,
            4.0 * (2 * m * d + d) / H100_HBM_BW * 1e3)


def scan_bound(b: int, s: int, c: int) -> tuple[float, float]:
    """rglru_scan on (B, S, C): a multiply and an add an element; a and b
    read once, h written once."""
    return (2.0 * b * s * c / H100_FP32_FLOPS * 1e3,
            12.0 * b * s * c / H100_HBM_BW * 1e3)


def scan_bwd_bound(b: int, s: int, c: int) -> tuple[float, float]:
    """rglru_scan's backward on (B, S, C): a multiply and an add (d) and a
    multiply (da) an element; a, h and g read once, da and db written
    once."""
    return (3.0 * b * s * c / H100_FP32_FLOPS * 1e3,
            20.0 * b * s * c / H100_HBM_BW * 1e3)


def attention_bound(b, s, h, kvh, d, causal=True) -> tuple[float, float]:
    """flash_attention: 4·D FLOPs (q·k and p·v) for each (query, key) pair
    the mask keeps, S(S+1)/2 per head when causal, at the 3xTF32 rate of
    its fp32 × fp32 products (``TC_RATES``); q and o at H heads, k and v
    at the KVH heads the kernel reads."""
    pairs = s * (s + 1) / 2 if causal else s * s
    return (4.0 * b * h * d * pairs / TC_RATES[("fp32", "fp32")][0] * 1e3,
            4.0 * (2 * b * s * h * d + 2 * b * s * kvh * d) / H100_HBM_BW
            * 1e3)


def time_row(kernel, shape, run, plain, library, bound, err,
             rate=FFMA_RATE) -> dict:
    """Device times of the kernel op, its plain version and the library
    yardstick (None: no one PyTorch call computes the function); ``rate``
    names the operations' rate of the bound."""
    f_ms, b_ms = bound
    row = {"kernel": kernel, "shape": shape, "max_abs_err": err,
           "ms": kernel_time(run), "plain_ms": kernel_time(plain),
           "library_ms": None if library is None else kernel_time(library),
           "flops_ms": f_ms, "bytes_ms": b_ms, "bound_ms": max(f_ms, b_ms),
           "bound_rate": rate}
    check_bound(f"{kernel} {shape}", row["ms"], row["bound_ms"])
    return row


def time_rg_kernels(dev, cfg, art, host) -> list:
    """rmsnorm, rglru_scan and flash_attention at RecurrentGemma-2B's
    shapes (probe: batch 8 × seq 128; prefill: 8 × 16; decode: 8 rows)
    and SmolLM-135M's, the scan's backward kernel at 8 × 128 (beside its
    plain version, and the eager plain gradient the train step took
    before it), and merged_ffn at D 2560 (each served lowrank unit
    at M 8, 128, 1024; the replaced path's R 7680 unit at M 128): the
    kernel, the plain version and the library yardstick
    (``F.rms_norm``; ``F.scaled_dot_product_attention`` on k, v expanded,
    TF32 off; ``torch.addmm(x, x @ U, V)``), as device times, beside the
    bound.  The first row of each kernel is the probe shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rglru_scan as rg_mod
    g = torch.Generator().manual_seed(8)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    rows = []
    eps = cfg.norm_eps
    for m, d in ((1024, cfg.d_model), (128, cfg.d_model), (8, cfg.d_model),
                 (1024, 576)):
        x, w = rnd(m, d), rnd(d) * 0.2
        w1 = 1.0 + w
        yr = ref.rmsnorm_ref(x, w, eps)
        err = held("rmsnorm", kernels.rmsnorm_op(x, w, eps=eps), yr,
                   yr.abs(), f"x={(m, d)}")[0]
        rows.append(time_row(
            "rmsnorm", [m, d], lambda: kernels.rmsnorm_op(x, w, eps=eps),
            lambda: ref.rmsnorm_ref(x, w, eps),
            lambda: F.rms_norm(x, (d,), w1, eps), norm_bound(m, d), err))
    dr = cfg.rnn_width or cfg.d_model
    for b, s in ((8, 128), (8, 16)):
        a = (torch.rand(b, s, dr, generator=g) * 0.5 + 0.5).to(dev)
        x = rnd(b, s, dr) * 0.1
        err = held("rglru_scan", kernels.rglru_scan_op(a, x),
                   ref.rglru_scan_ref(a, x), ref.rglru_scan_ref(a, x.abs()),
                   f"a={(b, s, dr)}")[0]
        rows.append(time_row(
            "rglru_scan", [b, s, dr], lambda: kernels.rglru_scan_op(a, x),
            lambda: ref.rglru_scan_ref(a, x), None, scan_bound(b, s, dr),
            err))
    # the backward kernel at the training and probe shape, beside its plain
    # version (the reverse loop) and the plain gradient the card took
    # before it had one (autograd through the plain scan, its forward
    # recomputed; CUDA events around eager calls: what a train step paid)
    b, s = 8, 128
    gb = torch.Generator().manual_seed(28)
    a = (torch.rand(b, s, dr, generator=gb) * 0.5 + 0.5).to(dev)
    x, w = (torch.randn(b, s, dr, generator=gb).to(dev) for _ in range(2))
    x = x * 0.1
    h = ref.rglru_scan_ref(a, x)
    err = scan_bwd_case(a, x, w)[0]
    row = time_row("rglru_scan_bwd", [b, s, dr],
                   lambda: rg_mod.rglru_scan_bwd(a, h, w),
                   lambda: ref.rglru_scan_bwd_ref(a, h, w), None,
                   scan_bwd_bound(b, s, dr), err)
    leaves = [a.clone().requires_grad_(), x.clone().requires_grad_()]
    row["plain_grad_eager_ms"] = cuda_time(lambda: torch.autograd.grad(
        ref.rglru_scan_ref(*leaves), leaves, w), iters=5, warmup=2)
    row["eager_ms"] = cuda_time(lambda: rg_mod.rglru_scan_bwd(a, h, w))
    rows.append(row)
    for b, s, h, kvh, d in ((8, 128, cfg.num_heads, cfg.num_kv_heads,
                             cfg.head_dim),
                            (8, 16, cfg.num_heads, cfg.num_kv_heads,
                             cfg.head_dim),
                            (8, 128, 9, 3, 64), (8, 16, 9, 3, 64)):
        q, k, v = rnd(b, s, h, d), rnd(b, s, kvh, d), rnd(b, s, kvh, d)
        err = compare_attention(q, k, v, True)[0]
        qt, kt, vt = (t.repeat_interleave(h // t.shape[2], dim=2)
                      .transpose(1, 2) for t in (q, k, v))
        rows.append(time_row(
            "flash_attention", [b, s, h, kvh, d],
            lambda: kernels.flash_attention_op(q, k, v, True),
            lambda: ops._attention_plain(q, k, v, True),
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True),
            attention_bound(b, s, h, kvh, d), err,
            tc_rate_label(("fp32", "fp32"))))
    units = [u for u in art.graph.units if u.kind == "lowrank"]
    shapes = sorted({tuple(u.params["u"].shape) for u in units})
    for m in (1024, 128, 8):
        for shp in shapes:
            u = next(u for u in units if tuple(u.params["u"].shape) == shp)
            r = time_ffn(rnd(m, cfg.d_model), u.params["u"], u.params["v"])
            rows.append(dict(r, kernel="merged_ffn", shape=[m, *shp]))
    sub = next(s for s in host.subparams if s is not None
               and s["kind"] == "ffn")
    uf, vf = host._linear_factors(sub)
    r = time_ffn(rnd(128, cfg.d_model), uf.contiguous(), vf.contiguous())
    rows.append(dict(r, kernel="merged_ffn", shape=[128, *uf.shape],
                     note="replaced path: one linearized FFN, unmerged"))
    return rows


def card_lm_host(arch: str, dev, batch: int, seq: int,
                 layers: int | None = None):
    """(host, source) of a transformer config at full width in fp32 (all
    its layers, or the first ``layers`` of its block pattern), its weights
    drawn on the card from seed 0 (``build_host`` draws them on the host,
    minutes for billions of parameters)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.transformer_host import CostEnv, TransformerHost

    cfg = dataclasses.replace(get_config(arch), dtype="float32", remat=False)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    params, _ = T.init_model(cfg, torch.Generator(dev).manual_seed(0),
                             device=dev)
    host = TransformerHost(cfg, params, env=CostEnv(batch=batch, seq=seq),
                           device=dev)
    return host, {"arch": arch, "seed": 0, "family": "transformer",
                  "reduced": False, "layers": cfg.num_layers,
                  "generator": "cuda"}


def rg_phases(dev):
    """Phases 15-17: RecurrentGemma-2B at full width in fp32 (``RG_LAYERS``
    of its layers) compressed on
    card-timed tables, its artifact served and held against the CPU port
    and ``replaced_apply``, and the path's kernels at its shapes.
    Returns (rows of :func:`time_rg_kernels`, launches over 15-16)."""
    import dataclasses
    import shutil

    import torch
    from repro_torch import kernels, runtime
    from repro_torch.core import WallClockOracle, compress
    from repro_torch.models import transformer as T
    from repro_torch.runtime import serving
    from repro_torch.runtime.artifact import flatten_tree

    # 15. RecurrentGemma-2B compress --------------------------------------------
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    # RG_LAYERS of 26 layers (rglru, rglru, attn_local; window 2048), d
    # 2560, 10 heads over 1 kv head of 256, GeGLU 7680, vocab 256000, tied
    # embeddings: full width, fp32, weights drawn on the card from seed 0;
    # costed and probed at batch 8 x seq 128 (probes at M = 1024)
    host, source = card_lm_host("recurrentgemma-2b", dev, batch=8, seq=128,
                                layers=RG_LAYERS)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    cfg = host.cfg
    n_params = sum(t.numel() for t in flatten_tree(host.params).values())
    oracle = WallClockOracle()
    res, ladder, served = None, [], ""
    for ratio in LM_BUDGETS:
        r = compress(host, budget_ratio=ratio, method="depth",
                     latency_oracle=oracle, probe_config=strict_probes())
        n_m = 0 if r is None else merged_segments(host, r.plan)
        ladder.append(f"{ratio}: " + ("infeasible" if r is None else
                                      f"{n_m} merged, predicted speedup "
                                      f"{r.speedup:.4f}"))
        if n_m:
            res, served = r, f"card-timed tables, budget {ratio}"
            break
    t_tables = time.perf_counter() - t0 - t_init
    print("  signature timings (device, CUDA graph): " + "; ".join(
        f"{sig[1]} rank {sig[2]} {sec * 1e3:.4f} ms"
        for sig, sec in oracle.measured.items()), flush=True)
    check(res is not None, f"recurrentgemma-2b depth: the card-timed tables "
          f"merge no FFN at any budget ({'; '.join(ladder)})")
    free_gb = shutil.disk_usage(WORK).free / 1e9
    rg_path = os.path.join(WORK, "recurrentgemma2b_depth.npz")
    t_save = time.perf_counter()
    res.save(rg_path, extra_meta={"source": source})
    t_save = time.perf_counter() - t_save
    build_launches = kernels.launch_counts()
    st = res.tables.stats
    log("rg compress", t0, f"recurrentgemma-2b fp32 full width, "
        f"{cfg.num_layers} of 26 layers, "
        f"{n_params / 1e9:.3f} B parameters (init {t_init:.2f}s, tables and "
        f"DP {t_tables:.2f}s); depth budgets {'; '.join(ladder)}; served: "
        f"{served}, {len(res.plan.segments)} segments, "
        f"{merged_segments(host, res.plan)} merged, {st.num_latency_probes} "
        f"probes in {st.num_latency_buckets} signatures, "
        f"{len(oracle.measured)} timed on the card, predicted speedup "
        f"{res.speedup:.4f}; artifact {os.path.getsize(rg_path) / 1e9:.2f} "
        f"GB saved in {t_save:.2f}s ({free_gb:.1f} GB free before); table "
        f"builds' launches {build_launches}")

    # 16. RecurrentGemma-2B serve -----------------------------------------------
    t0 = time.perf_counter()
    art = runtime.load(rg_path, device="cuda")
    t_load = time.perf_counter() - t0
    census = runtime.count_units(art.graph)
    B, P, N = 8, 16, 32
    prompt = serving.random_prompts(11, B, P, cfg.vocab_size, device=dev)

    def c_step(c, t):
        return art.decode(c, t)

    def o_step(c, t):
        return T.decode_step(cfg, host.params, c, {"tokens": t})
    c_pre, c_dec, c_logits, seqs, c_serve = serve_both(
        "rg compressed", c_step, lambda: art.init_cache(B, P + N), prompt, N)
    o_pre, o_dec, _, _, o_serve = serve_both(
        "rg original", o_step, lambda: T.init_cache(cfg, B, P + N, device=dev),
        prompt, N)
    check(tuple(seqs.shape) == (B, N), f"rg served ids {tuple(seqs.shape)}")
    fed = torch.cat([prompt, seqs[:, :-1]], dim=1)
    lg = forced_logits(c_step, art.init_cache(B, P + N), fed)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(lg).all()), "rg: non-finite served logits")
    check(bool((lg[:, P - 1:].argmax(-1) == seqs).all()),
          "rg: served ids are not the argmax of the teacher-forced logits")
    d_fed = rel_diff(lg[:, P - 1], c_logits)
    check(d_fed <= 1e-6, f"rg: prefill logits of serve_loop and the forced "
          f"run differ by {d_fed}")
    y_merged = art.apply({"tokens": prompt})
    fn, p = host.replaced_apply(res.plan)
    y_rep = fn(p, {"tokens": prompt})
    check(tuple(y_merged.shape) == (B, P, cfg.vocab_size)
          and bool(torch.isfinite(y_merged).all()),
          f"rg prefill logits {tuple(y_merged.shape)}")
    d_rep = rel_diff(y_merged, y_rep)
    rg_launches = kernels.launch_counts()
    per_step = c_serve["launches_per_step"]
    kernels.reset_launch_counts()
    art.apply({"tokens": prompt})
    per_prefill = {k: n for k, n in kernels.launch_counts().items() if n}
    # the CPU port on CPU_ROWS rows and the first RG_CPU_STEPS steps
    # (decode is row-wise; the host's time goes to streaming the weights,
    # one pass a step), on the artifact's tensors copied to the host: the
    # file's bytes, as a second load from disk would give them
    t_cpu = time.perf_counter()
    cpu = dataclasses.replace(art, graph=cpu_copy(art.graph),
                              device=torch.device("cpu"))
    lg_cpu = forced_logits(lambda c, t: cpu.decode(c, t),
                           cpu.init_cache(CPU_ROWS, P + N),
                           fed[:CPU_ROWS, :RG_CPU_STEPS].cpu())
    t_cpu = time.perf_counter() - t_cpu
    del cpu
    d_steps = ((lg[:CPU_ROWS, :RG_CPU_STEPS].cpu() - lg_cpu).abs().amax(
        dim=(0, 2)) / lg_cpu.abs().amax(dim=(0, 2)))
    d_cpu, d_last = float(d_steps.max()), float(d_steps[-1])
    steps = N - 1
    log("rg serve", t0, f"artifact loaded on the card in {t_load:.2f}s, "
        f"units {json.dumps(census, sort_keys=True)}; {B} prompts x {P} "
        f"tokens, {N} new; worst step logits vs CPU port {d_cpu:.3g} (last "
        f"step {d_last:.3g}; {CPU_ROWS} prompts x {RG_CPU_STEPS} steps on "
        f"the CPU in {t_cpu:.2f}s), prefill forward vs replaced_apply {d_rep:.3g} "
        f"(limit {NET_RTOL}); compressed prefill {c_pre * 1e3:.3f} ms, "
        f"decode {c_dec * 1e3:.3f} ms "
        f"({serving.decode_tok_s(steps, B, c_dec):.1f} tok/s); original "
        f"prefill {o_pre * 1e3:.3f} ms, decode {o_dec * 1e3:.3f} ms "
        f"({serving.decode_tok_s(steps, B, o_dec):.1f} tok/s); decode "
        f"speedup {o_dec / c_dec:.3f}x (predicted {res.speedup:.4f}x); "
        f"launches per decode step {per_step} (counted at the capture), "
        f"per prefill forward {per_prefill}; phases 15-16 launches "
        f"{rg_launches}")
    check(census.get("lowrank", 0) >= 1, "rg: the served plan merges nothing")
    check(d_cpu <= NET_RTOL, f"rg: card vs CPU port differ by {d_cpu}")
    check(d_rep <= NET_RTOL, f"rg: merged vs replaced differ by {d_rep}")
    for k in ("rmsnorm", "rglru_scan", "flash_attention", "merged_ffn"):
        check(rg_launches[k] > 0, f"kernel {k} never launched on the "
              "RecurrentGemma path")

    # 17. the path's kernels at its shapes --------------------------------------
    t0 = time.perf_counter()
    rows = time_rg_kernels(dev, cfg, art, host)
    with open(os.path.join(WORK, "rg.json"), "w") as f:
        json.dump({"rows": rows, "launches_per_decode_step": per_step,
                   "launches_per_prefill_forward": per_prefill,
                   "launches_phases_15_16": rg_launches,
                   "ladder": ladder, "served": served}, f, indent=1)
    log("rg kernels", t0, " ".join(
        f"{r['kernel']} {r['shape']}: ms={r['ms']:.4f} "
        f"plain={r['plain_ms']:.4f} library="
        + ("none" if r["library_ms"] is None else f"{r['library_ms']:.4f}")
        + f" bound={r['bound_ms']:.5f} ("
        f"{'bytes' if r['bytes_ms'] >= r['flops_ms'] else 'operations'}, "
        f"share {r['bound_ms'] / r['ms']:.3f})"
        + (f" host {r['host_us']:.1f} us a call;" if "host_us" in r else "")
        + (f" eager {r['eager_ms']:.4f} ms, the plain gradient eager "
           f"(forward recomputed) {r['plain_grad_eager_ms']:.3f} ms;"
           if "plain_grad_eager_ms" in r else ";")
        for r in rows))
    return rows, rg_launches, art, {"recurrentgemma-2b compressed": c_serve,
                                    "recurrentgemma-2b original": o_serve}


def poison_hook(slot: int, step: int):
    """A ``logit_hook`` that makes ``slot``'s logits NaN at step ``step``
    of a round (``t`` is a device tensor: the hook runs in the graph)."""
    import torch

    def hook(logits, t):
        rows = torch.arange(logits.shape[0], device=logits.device) == slot
        bad = rows.view(-1, *([1] * (logits.ndim - 1))) & (t == step)
        return torch.where(bad, torch.nan, logits)
    return hook


def request_phase(dev, arts) -> tuple[dict, dict]:
    """Phase 18: each artifact serves ragged requests through
    ``serve_requests`` (8 slots, 32 tokens): every request's tokens
    against ``serve_loop`` of its prompt alone at batch 1, then the last
    round's requests again (the same padded width) with one slot's
    logits poisoned at generation index 2: that request alone is aborted
    at 2 and every other is token-identical to the clean run.  Returns
    the rows and, per label, the single-prompt tokens ``(n, 32)``."""
    import torch
    from repro_torch import kernels
    from repro_torch.runtime import serving

    out, solos = {}, {}
    for label, art, n_req in arts:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        cfg = art.graph.meta["config"]
        T_NEW, SLOTS = 32, 8
        prompts = serving.ragged_prompts(0, n_req, 4, 32, cfg.vocab_size)
        mat, lens = serving.pad_prompts(prompts)

        def step(c, t):
            return art.decode(c, t)
        served = serving.serve_requests(step, art.init_cache, mat, lens,
                                        tokens=T_NEW, slots=SLOTS)
        gen, secs = served
        rep = served.report
        launch = kernels.launch_counts()
        t_solo = time.perf_counter()
        differ, solo_rows = [], []
        for i, p in enumerate(prompts):
            p = p.long().to(dev)[None, :]
            solo = serving.serve_loop(
                step, lambda: art.init_cache(1, p.shape[1] + T_NEW), p,
                T_NEW, warm=False)[3][0].cpu()
            solo_rows.append(solo)
            if not torch.equal(solo, gen[i]):
                differ.append(i)
        solos[label] = torch.stack(solo_rows)
        t_solo = time.perf_counter() - t_solo
        start = (n_req - 1) // SLOTS * SLOTS
        r = 1
        hook = poison_hook(r, int(lens[start + r]) - 1 + 2)
        bad = serving.serve_requests(step, art.init_cache, mat[start:],
                                     lens[start:], tokens=T_NEW, slots=SLOTS,
                                     logit_hook=hook)
        others = [i for i in range(n_req - start) if i != r]
        same = all(torch.equal(bad[0][i], gen[start + i]) for i in others)
        poisoned_ok = (torch.equal(bad[0][r, :2], gen[start + r, :2])
                       and not bool(bad[0][r, 2:].any()))
        row = {"requests": n_req, "slots": SLOTS, "tokens": T_NEW,
               "prompt_lengths": lens.tolist(), "seconds": secs,
               "sustained_tok_s": serving.decode_tok_s(T_NEW, n_req, secs),
               "rounds": rep.rounds, "dispositions": rep.dispositions,
               "differ_from_single_prompt": differ,
               "poisoned_aborted": bad.report.aborted,
               "poisoned_dispositions": bad.report.dispositions,
               "others_identical": same, "launches": launch}
        out[label] = row
        log("lm requests", t0, f"{label}: {n_req} ragged prompts (lengths "
            f"{min(row['prompt_lengths'])}-{max(row['prompt_lengths'])}) x "
            f"{T_NEW} tokens in {SLOTS} slots: {rep.rounds} rounds in "
            f"{secs * 1e3:.3f} ms, sustained {row['sustained_tok_s']:.1f} "
            f"tok/s; dispositions {json.dumps(rep.dispositions)}; tokens "
            f"against single-prompt serve_loop at batch 1: "
            f"{n_req - len(differ)} of {n_req} equal ({t_solo:.2f}s); request "
            f"{start + r} poisoned at generation index 2: aborted "
            f"{bad.report.aborted} (relative to the round), the other "
            f"{len(others)} token-identical {same}; launches {launch}")
        check(rep.completed == list(range(n_req)) and rep.ok,
              f"{label} requests: dispositions {rep.dispositions}")
        check(not differ, f"{label} requests {differ} differ from serving "
              "their prompt alone")
        check(bad.report.aborted == {r: 2} and same and poisoned_ok,
              f"{label} requests: the poisoned run reports "
              f"{bad.report.aborted}, others identical {same}, poisoned "
              f"row kept its first 2 tokens and zeros after {poisoned_ok}")
        for k in ("rmsnorm", "merged_ffn"):
            check(launch[k] > 0, f"{label} requests: {k} never launched")
    return out, solos


def continuous_phase(arts, solos, fixed) -> dict:
    """Phase 19: each artifact serves phase 18's ragged prompts through
    the continuous engine (8 slots, chunks of 8 steps, 32 tokens):
    (a) all arriving at 0 on the real clock, beside phase 18's
    ``serve_requests``; (b) a seeded Poisson trace at 20 requests/s (the
    reference bench's recipe), p50/p99 latency; (c) on a ``TickClock``
    with staggered arrivals, ``nan@serve.nan`` on a request admitted
    mid-stream plus ``delay@serve.arrival`` and ``delay@serve.chunk``;
    (d) ``raise@serve.worker`` at the 3rd chunk through
    ``serve_with_failover``.  Every request's tokens must equal phase
    18's ``serve_loop`` of its prompt alone at batch 1 (``solos``), but
    the poisoned one, aborted at 2 alone; the failover replays
    bit-identically; the launch counts of (a), zeroed just before it,
    show ``merged_ffn`` and ``rmsnorm`` in the captured chunk step, and
    the chunks take one graph replay per step.  A torch.profiler trace
    of chunks of the captured step gives its device time a step, and
    with (a)'s steps and wall its busy share (0 where the profiler sees
    no device activity)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.runtime import serving
    from repro_torch.testing import faults

    T_NEW, SLOTS, CHUNK, RATE = 32, 8, 8, 20.0
    out = {}
    for label, art, n_req in arts:
        t0 = time.perf_counter()
        cfg = art.graph.meta["config"]
        prompts = serving.ragged_prompts(0, n_req, 4, 32, cfg.vocab_size)
        mat, lens = serving.pad_prompts(prompts)
        solo = solos[label]

        def step(c, t):
            return art.decode(c, t)

        def serve(fn=serving.serve_continuous, **kw):
            return fn(step, art.init_cache, mat, lens, tokens=T_NEW,
                      slots=SLOTS, chunk=CHUNK, **kw)

        def differ(gen, skip=()):
            return [i for i in range(n_req)
                    if i not in skip and not torch.equal(gen[i], solo[i])]

        # (a) throughput: every request arrives at 0, real clock
        kernels.reset_launch_counts()
        with CountCalls(serving._ChunkGraph, "run") as chunks, \
                CountCalls(torch.cuda.CUDAGraph, "replay") as rp:
            a = serve()
        launch = kernels.launch_counts()
        tok_s = serving.decode_tok_s(T_NEW, n_req, a[1])
        # where (a)'s time goes: the device time of a step of the captured
        # chunk (torch.profiler over 4 chunks of idle slots; the shapes,
        # and so the work, are those of every step) against (a)'s wall.
        # A chunk goes through `run`, which rewinds the step counter.
        eng = serving.ContinuousEngine(step, art.init_cache, slots=SLOTS,
                                       chunk=CHUNK,
                                       max_seq=int(mat.shape[1]) + T_NEW)
        idle = eng._build_feed()
        busy_us, krows = device_kernels(lambda: eng._graph.run(idle),
                                        reps=4)
        busy_us /= CHUNK
        krows = [(us / CHUNK, n // CHUNK, name) for us, n, name in krows]
        del eng
        steps = chunks.n * CHUNK
        # (b) a seeded Poisson arrival trace, real clock
        arrivals = np.cumsum(np.random.RandomState(11).exponential(
            1.0 / RATE, size=n_req)).tolist()
        b = serve(arrivals=arrivals)
        lat = sorted(b.report.latency_s.values())
        # (c) faults on a virtual clock; request R arrives at 0.5 R ticks,
        # after the first chunk, so it is admitted mid-stream
        R = n_req - 2
        spec = (f"nan@serve.nan:rid={R},t=2;delay@serve.arrival:2~0.02;"
                "delay@serve.chunk:3~0.02")
        with faults.inject(*faults.parse_env_spec(spec).rules) as plan:
            c = serve(arrivals=[0.5 * r for r in range(n_req)],
                      clock=faults.TickClock())
        delays = sorted({p for p, _, act in plan.fired if act == "delay"})
        poisoned_ok = (torch.equal(c[0][R, :2], solo[R, :2])
                       and not bool(c[0][R, 2:].any()))
        # (d) a worker lost before the 3rd chunk
        with faults.inject(faults.Fault("serve.worker", "raise", nth=3)):
            d = serve(fn=serving.serve_with_failover,
                      clock=faults.TickClock())
        row = {"requests": n_req, "slots": SLOTS, "chunk": CHUNK,
               "tokens": T_NEW, "seconds": a[1], "sustained_tok_s": tok_s,
               "engine_tok_s": a.report.sustained_tok_s,
               "fixed_tok_s": fixed[label]["sustained_tok_s"],
               "chunks": chunks.n, "admitted": a.report.admitted,
               "replays_per_step": rp.n / max(steps, 1),
               "busy_share": busy_us * 1e-6 * steps / a[1],
               "device_ms_per_step": busy_us * 1e-3,
               "served_ms_per_step": a[1] * 1e3 / max(steps, 1),
               "device_kernels": [(us, n, name[:80])
                                  for us, n, name in krows[:8]],
               "launches": launch, "differ": differ(a[0]),
               "trace_rate_req_s": RATE, "trace_seconds": b[1],
               "trace_tok_s": serving.decode_tok_s(T_NEW, n_req, b[1]),
               "trace_p50_s": float(np.percentile(lat, 50)),
               "trace_p99_s": float(np.percentile(lat, 99)),
               "trace_queue_peak": b.report.queue_peak,
               "trace_differ": differ(b[0]),
               "nan_rid": R, "nan_aborted": c.report.aborted,
               "nan_dispositions": c.report.dispositions,
               "nan_differ": differ(c[0], skip=(R,)),
               "delay_points_fired": delays,
               "failovers": d.report.failovers,
               "failover_replayed": d.report.replayed,
               "failover_completed": sorted(d.report.completed),
               "failover_identical": bool(torch.equal(d[0], a[0]))}
        out[label] = row
        log("lm continuous", t0, f"{label}: {n_req} ragged prompts x "
            f"{T_NEW} tokens, {SLOTS} slots, chunks of {CHUNK}: (a) "
            f"{a[1] * 1e3:.3f} ms, sustained {tok_s:.1f} tok/s (engine's "
            f"clock {a.report.sustained_tok_s:.1f}) against serve_requests' "
            f"{row['fixed_tok_s']:.1f} (phase 18), {chunks.n} chunks, "
            f"{a.report.admitted} admissions, {row['replays_per_step']:.3f} "
            f"graph replays per step, launches (warm-up + capture) "
            f"{json.dumps(launch)}; served {row['served_ms_per_step']:.3f} "
            f"ms a step, device (torch.profiler over 4 chunks) "
            f"{row['device_ms_per_step']:.3f} ms a step, busy "
            f"{row['busy_share']:.3f}; by kernel: " + "; ".join(
                f"{name[:60]} {us:.1f}us x{n}" for us, n, name in
                row["device_kernels"][:5]) + f"; (b) Poisson {RATE:g} req/s: "
            f"{b[1] * 1e3:.3f} ms, {row['trace_tok_s']:.1f} tok/s, latency "
            f"p50 {row['trace_p50_s'] * 1e3:.3f} ms p99 "
            f"{row['trace_p99_s'] * 1e3:.3f} ms, queue peak "
            f"{b.report.queue_peak}; tokens against single-prompt "
            f"serve_loop: (a) {n_req - len(row['differ'])} and (b) "
            f"{n_req - len(row['trace_differ'])} of {n_req} equal; (c) "
            f"request {R} poisoned at generation index 2: aborted "
            f"{c.report.aborted}, the other {n_req - 1} equal "
            f"{not row['nan_differ']}, delay rules fired at {delays}; (d) "
            f"worker lost at chunk 3: failovers {d.report.failovers}, "
            f"replayed {d.report.replayed}, tokens identical to (a) "
            f"{row['failover_identical']}")
        check(a.report.ok and sorted(a.report.completed) == list(
            range(n_req)), f"{label} continuous: {a.report.dispositions}")
        check(not row["differ"], f"{label} continuous: requests "
              f"{row['differ']} differ from serving their prompt alone")
        check(b.report.ok and not row["trace_differ"], f"{label} "
              f"continuous, Poisson trace: {b.report.dispositions}, "
              f"requests {row['trace_differ']} differ")
        check(c.report.aborted == {R: 2} and poisoned_ok
              and not row["nan_differ"] and len(c.report.completed)
              == n_req - 1, f"{label} continuous, NaN at request {R}: "
              f"aborted {c.report.aborted}, others differ "
              f"{row['nan_differ']}, truncated {poisoned_ok}")
        check(delays == ["serve.arrival", "serve.chunk"], f"{label} "
              f"continuous: delay rules fired at {delays}")
        check(d.report.failovers == 1 and d.report.replayed
              and row["failover_completed"] == list(range(n_req))
              and row["failover_identical"], f"{label} failover: "
              f"{d.report.failovers} failovers, completed "
              f"{row['failover_completed']}, identical "
              f"{row['failover_identical']}")
        check(row["replays_per_step"] == 1.0, f"{label} continuous: "
              f"{rp.n} graph replays for {chunks.n} chunks of {CHUNK}")
        for k in ("rmsnorm", "merged_ffn"):
            check(launch[k] > 0, f"{label} continuous: {k} never launched")
    return out


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Phase 20: the paper's Eq. 4 importance on the card
# ---------------------------------------------------------------------------

#: Eq. 4 fine-tunes of phase 20 (a) repeated, held bitwise.
EQ4_REPEAT = 16


def plan_line(plan) -> str:
    return (f"{len(plan.segments)} segments, |A| {len(plan.A)}, |C| "
            f"{len(plan.C)}/{plan.num_layers}")


#: Budgets at which phase 20 compares the Eq. 4 and the magnitude plans.
PLAN_RATIOS = (0.5, 0.6, 0.7, 0.8, 0.9)


def differing_budgets(host, eq4, mag, t_orig, method) -> list:
    """Budgets of :data:`PLAN_RATIOS` at which the DP on the Eq. 4 tables
    and on the magnitude tables (the same latency column) plans
    differently."""
    from repro_torch.core import solve_dp
    out = []
    for r in PLAN_RATIOS:
        a, b = (solve_dp(len(host.descs()), t.fn(), r * t_orig, 200,
                         method=method, original_k=host.original_k)
                for t in (eq4, mag))
        if (a is None) != (b is None) or (
                a is not None and a.plan.segments != b.plan.segments):
            out.append(r)
    return out


def recording(perf_fn, perfs: list):
    """``perf_fn`` that appends every score it returns to ``perfs``: the
    engine scores its fine-tunes in probe order, so ``perfs`` is the raw
    Eq. 4 column (before Pareto pruning drops entries)."""
    def perf(apply_fn, params, batches):
        v = perf_fn(apply_fn, params, batches)
        perfs.append(v)
        return v
    return perf


def fixed_teacher(teacher, *batches):
    """The teacher's outputs on the spec's fixed batches, computed once
    under ``no_grad`` (the same function as calling it every step)."""
    import torch
    with torch.no_grad():
        outs = [(b, teacher(b)) for b in batches]

    def fn(x):
        return next(y for b, y in outs if b is x)
    return fn


def eq4_report(label, tables, imps, steps, peak_bytes, one_finetune) -> dict:
    """Phase 20's accounting of one Eq. 4 table build: probes, fine-tunes,
    batches, seconds, ms per fine-tune step (eval included), peak device
    memory, a torch.profiler busy share over one more fine-tune, and the
    min / median / max of the raw importance column."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile
    st = tables.stats
    tunes = len(imps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_finetune()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # device activity only: a fine-tune dispatches thousands of host ops,
    # whose CPU events would take the profiler tens of seconds to collect
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        one_finetune()
        torch.cuda.synchronize()
    rows = sorted(((us, n, name)
                   for name, (us, n) in traced_kernels(prof).items()),
                  reverse=True)
    busy_us = sum(r[0] for r in rows)
    row = {"probes": st.num_importance_probes, "finetunes": tunes,
           "batches": st.num_importance_batches,
           "sequential": st.num_importance_sequential,
           "seconds": tables.build_seconds_importance,
           "ms_per_step": tables.build_seconds_importance * 1e3
           / max(tunes * steps, 1), "steps": steps,
           "peak_gb": peak_bytes / 1e9, "finetune_s": wall,
           "busy_us": busy_us, "busy_share": busy_us * 1e-6 / wall,
           "kernels": [(round(us, 1), n, name[:60])
                       for us, n, name in rows[:6]],
           "min": min(imps), "median": statistics.median(imps),
           "max": max(imps)}
    print(f"  {label}: {row['probes']} probes, {tunes} fine-tunes, "
          f"{row['batches']} vmapped batches, {row['sequential']} scalar; "
          f"importance {row['seconds']:.2f}s, {row['ms_per_step']:.2f} ms "
          f"per fine-tune step ({steps} steps, eval included); peak device "
          f"memory {row['peak_gb']:.3f} GB; one fine-tune {wall * 1e3:.1f} "
          f"ms, torch.profiler busy {busy_us / 1e3:.1f} ms = "
          f"{row['busy_share']:.3f}" + (
              f" (top: " + "; ".join(f"{n} {us:.0f}us x{c}"
                                     for us, c, n in row["kernels"][:3])
              + ")" if rows else " (no device activity seen: not measured)")
          + f"; importance min {row['min']:.6g} median {row['median']:.6g} "
          f"max {row['max']:.6g}", flush=True)
    check(all(math.isfinite(v) and v > 0 for v in imps),
          f"{label}: a non-finite or non-positive importance")
    return row


def toy_task(gen, n, hw, dev):
    """The reference quickstart's quadrant-mean task from a seeded
    generator: NHWC inputs and the argmax of the four quadrant means."""
    import torch
    x = torch.randn(n, hw, hw, 3, generator=gen)
    q = hw // 2
    means = torch.stack([x[:, :q, :q].mean((1, 2, 3)),
                         x[:, :q, q:].mean((1, 2, 3)),
                         x[:, q:, :q].mean((1, 2, 3)),
                         x[:, q:, q:].mean((1, 2, 3))], dim=1)
    return x.to(dev), means.argmax(1).to(dev)


def quickstart_host(dev):
    """The reference quickstart's network pre-trained on its task:
    ``tiny_resnet(4, 16, 8, (2, 2))`` from seed 0, 150 Adam steps at lr
    3e-3 on the quadrant-mean task; ``(host at batch 32, train batches,
    eval batches, base accuracy)``."""
    import torch
    from repro_torch.core import ImportanceSpec, accuracy_perf, xent_loss
    from repro_torch.core.importance import _adam_finetune
    from repro_torch.models import cnn, cnn_host, zoo

    net = zoo.tiny_resnet(num_classes=4, in_hw=16, width=8, blocks=(2, 2))
    params = cnn.init_params(net, torch.Generator().manual_seed(0),
                             device=dev)
    train = [toy_task(torch.Generator().manual_seed(1), 256, 16, dev)]
    evals = [toy_task(torch.Generator().manual_seed(2), 256, 16, dev)]

    def apply0(p, x):
        return cnn.apply_replaced(net, p, x)
    params = _adam_finetune(apply0, params, ImportanceSpec(
        xent_loss, accuracy_perf, train, evals, steps=150, lr=3e-3))
    return (cnn_host.CNNHost(net, params, batch=32, device=dev), train,
            evals, accuracy_perf(apply0, params, evals))


def importance_phase(dev, cnn_h, cnn_oracle, mag_plan, dev_orig_ms,
                     lm_host, lm_oracle, lm_budget, prompt,
                     new_tokens) -> dict:
    """Phase 20: (a) MobileNetV2 Eq. 4 tables (distill), DP, merge,
    artifact, 16 fine-tunes repeated bitwise under deterministic cuDNN;
    (b) the reference quickstart's protocol on tiny_resnet, the batched
    engine against the sequential one; (c) SmolLM-135M (the first
    ``EQ4_LM_LAYERS`` layers of phase 8's) Eq. 4 tables (distill) through
    ``replaced_apply`` and the kernels beside its magnitude plan, at the
    first budget from ``lm_budget`` on that merges an FFN, its plan and
    the original served as phase 9 serves."""
    import torch
    from repro_torch import kernels, runtime
    from repro_torch.core import (ImportanceSpec, WallClockOracle,
                                  accuracy_perf, build_tables, compress,
                                  distill_loss, enumerate_probes,
                                  measure_importance,
                                  measure_importances, neg_loss_perf,
                                  one_segment_plan, perf_to_importance,
                                  xent_loss)
    from repro_torch.core.importance import _adam_finetune
    from repro_torch.core.probe_engine import EngineStats
    from repro_torch.device import deterministic_cudnn
    from repro_torch.models import cnn
    from repro_torch.models import transformer as T
    from repro_torch.models.transformer_host import TransformerHost
    from repro_torch.tree import tree_map

    out: dict = {}

    # (a) MobileNetV2 at full size ----------------------------------------
    t0 = time.perf_counter()
    net, params = cnn_h.net, cnn_h.params
    g = torch.Generator().manual_seed(20)
    hw = net.in_hw
    xtr, xev = (torch.randn(cnn_h.batch, hw, hw, 3, generator=g).to(dev)
                for _ in range(2))
    dl = distill_loss(fixed_teacher(
        lambda x: cnn.apply_replaced(net, params, x), xtr, xev))
    perfs: list = []
    spec = ImportanceSpec(dl, neg_loss_perf(dl), [xtr], [xev], steps=4,
                          lr=1e-3)
    rec = ImportanceSpec(dl, recording(neg_loss_perf(dl), perfs), [xtr],
                         [xev], steps=4, lr=1e-3)
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with deterministic_cudnn():
        t1 = time.perf_counter()
        res = compress(cnn_h, budget_ratio=0.6, method="layermerge",
                       latency_oracle=cnn_oracle, importance=rec,
                       base_perf=0.0, probe_config=strict_probes())
        peak = torch.cuda.max_memory_allocated()
        check(res is not None, "mobilenetv2 Eq. 4: no plan fits 0.6")
        imps = [perf_to_importance(v, 0.0, spec) for v in perfs]
        segs = [p[5] for p in enumerate_probes(cnn_h) if not p[5].original]
        check(len(imps) == len(segs) == res.tables.stats
              .num_importance_sequential, f"mobilenetv2: {len(imps)} scores "
              f"for {len(segs)} probes")
        t2 = time.perf_counter()
        again = measure_importances(cnn_h, segs[:EQ4_REPEAT], spec, 0.0,
                                    engine="sequential")
        same = sum(a == b for a, b in zip(again, imps))
        t3 = time.perf_counter()
        fa, pa = cnn_h.replaced_apply(one_segment_plan(cnn_h, segs[0]))
        row = eq4_report("mobilenetv2", res.tables, imps, spec.steps, peak,
                         lambda: measure_importance(fa, pa, spec, 0.0))
        row.update(compress_s=t2 - t1, repeat_s=t3 - t2,
                   report_s=time.perf_counter() - t3)
    check(same == EQ4_REPEAT, f"mobilenetv2: {EQ4_REPEAT - same} of the "
          f"first {EQ4_REPEAT} fine-tunes differ run to run under "
          "deterministic cuDNN")
    diff = differing_budgets(cnn_h, res.tables, build_tables(
        cnn_h, latency_oracle=cnn_oracle, probe_config=strict_probes()),
        res.original_latency, "layermerge")
    y_merged = runtime.execute(res.lower(), xev, device=dev)
    y_rep = cnn.apply_replaced(net, params, xev, res.plan)
    d_rep = float((y_merged - y_rep).abs().max() / y_rep.abs().max())
    a_path = os.path.join(WORK, "mobilenetv2_eq4.npz")
    res.save(a_path)
    art = runtime.load(a_path, device=dev)
    y_art = art.apply(xev)
    d_art = float((y_art - y_merged).abs().max() / y_merged.abs().max())
    ms_eq4 = WallClockOracle().time_callable(lambda: art.apply(xev)) * 1e3
    launches = kernels.launch_counts()
    row.update(plan=plan_line(res.plan),
               same_as_magnitude=res.plan.segments == mag_plan.segments,
               magnitude_plan=plan_line(mag_plan), plans_differ_at=diff,
               merged_vs_replaced=d_rep,
               artifact_vs_live=d_art, device_ms=ms_eq4,
               original_device_ms=dev_orig_ms,
               speedup=dev_orig_ms / ms_eq4, predicted=res.speedup,
               repeated_bitwise=same, launches=launches)
    out["mobilenetv2"] = row
    log("importance mobilenetv2", t0, f"Eq. 4 plan: {row['plan']} (phase "
        f"4's magnitude plan: {row['magnitude_plan']}; same "
        f"{row['same_as_magnitude']}; the two tables plan differently at "
        f"budgets {diff} of {list(PLAN_RATIOS)}); merged vs replaced_apply "
        f"{d_rep:.3g} "
        f"(limit {NET_RTOL}), reloaded artifact vs live {d_art:.3g}; CUDA "
        f"graph forward {ms_eq4:.4f} ms against the original's "
        f"{dev_orig_ms:.4f} ms: {row['speedup']:.3f}x (predicted "
        f"{res.speedup:.4f}x); first {EQ4_REPEAT} fine-tunes repeated: "
        f"{same} bitwise equal; seconds: compress {row['compress_s']:.2f}, "
        f"repeat {row['repeat_s']:.2f}, report {row['report_s']:.2f}; "
        f"launches {launches}")
    check(d_rep <= NET_RTOL, f"mobilenetv2 Eq. 4: merged vs replaced "
          f"differ by {d_rep}")
    check(d_art <= NET_RTOL, f"mobilenetv2 Eq. 4: artifact differs by "
          f"{d_art}")
    for k in ("merged_conv", "depthwise_conv"):
        check(launches[k] > 0, f"mobilenetv2 Eq. 4: {k} never launched")
    del art, res

    # (b) the reference quickstart's protocol ------------------------------
    t0 = time.perf_counter()
    host, train, evals, base_acc = quickstart_host(dev)
    net, params, xev = host.net, host.params, evals[0][0]
    perfs = []
    ispec = ImportanceSpec(xent_loss, accuracy_perf, train, evals, steps=5,
                           lr=1e-3)
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    res = compress(host, budget_ratio=0.6, P=200, method="layermerge",
                   latency_oracle=WallClockOracle(warmup=2, iters=5),
                   probe_config=strict_probes(), importance=ImportanceSpec(
                       xent_loss, recording(accuracy_perf, perfs), train,
                       evals, steps=5, lr=1e-3), base_perf=base_acc)
    peak = torch.cuda.max_memory_allocated()
    check(res is not None, "quickstart: no plan fits 0.6")
    imps = [perf_to_importance(v, base_acc, ispec) for v in perfs]
    segs = [p[5] for p in enumerate_probes(host) if not p[5].original]
    fb, pb = host.replaced_apply(one_segment_plan(host, segs[0]))
    t2 = time.perf_counter()
    row = eq4_report("quickstart", res.tables, imps, ispec.steps, peak,
                     lambda: measure_importance(fb, pb, ispec, base_acc))
    row.update(pretrain_s=t1 - t0, compress_s=t2 - t1,
               report_s=time.perf_counter() - t2)
    ra, _ = host.replaced_apply(res.plan)
    params_ft = _adam_finetune(ra, params, ImportanceSpec(
        xent_loss, accuracy_perf, train, evals, steps=150, lr=1e-3))
    acc_ft = accuracy_perf(ra, params_ft, evals)
    ma, _ = host.merged_apply(res.plan, params_ft)
    acc_merged = accuracy_perf(ma, params_ft, evals)
    b_path = os.path.join(WORK, "tiny_resnet_eq4.npz")
    res.params = params_ft
    res.save(b_path)
    art = runtime.load(b_path, device=dev)
    d_b = float((art.apply(xev) - ma(params_ft, xev)).abs().max())
    stats = EngineStats()
    lanes: list = []
    bat = measure_importances(
        host, segs, ispec, base_acc, stats=stats, force_batching=True,
        progress=lambda m: lanes.append(m) if "lanes" in m else None)
    seq = measure_importances(host, segs, ispec, base_acc,
                              engine="sequential")
    worst = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(bat, seq))
    agree = all(abs(a - b) <= 1e-7 + 1e-6 * abs(b) for a, b in zip(bat, seq))
    row.update(plan=plan_line(res.plan), base_acc=base_acc,
               replaced_acc=acc_ft, merged_acc=acc_merged,
               artifact_max_abs=d_b, batched_lanes=lanes,
               batched_batches=stats.num_importance_batches,
               batched_scalar=stats.num_importance_sequential,
               batched_vs_sequential_max_rel=worst,
               batched_bitwise=bat == seq, predicted=res.speedup)
    out["quickstart"] = row
    log("importance quickstart", t0, f"pre-trained accuracy {base_acc:.4f}; "
        f"plan {row['plan']} (predicted {res.speedup:.4f}x); fine-tuned "
        f"replaced {acc_ft:.4f}, merged {acc_merged:.4f}; artifact reload "
        f"max|Δ| {d_b:.3g}; batched engine (forced): "
        f"{stats.num_importance_batches} batches {lanes}, "
        f"{stats.num_importance_sequential} scalar; vs sequential max rel "
        f"{worst:.3g} (bitwise {row['batched_bitwise']}); seconds: "
        f"pre-train {row['pretrain_s']:.2f}, compress "
        f"{row['compress_s']:.2f}, report {row['report_s']:.2f}")
    check(abs(acc_merged - acc_ft) < 1e-6, f"quickstart: merged accuracy "
          f"{acc_merged} differs from replaced {acc_ft}")
    check(art.plan == res.plan, "quickstart: artifact plan round-trip")
    check(d_b < 1e-5, f"quickstart: artifact reload differs by {d_b}")
    check(stats.num_importance_batches > 0, "quickstart: no vmapped batch")
    check(agree, f"quickstart: batched vs sequential importances differ "
          f"(max rel {worst:.3g}; limit rtol 1e-6, atol 1e-7)")
    del art, res, host

    # (c) SmolLM-135M at full width, EQ4_LM_LAYERS layers --------------------
    t0 = time.perf_counter()
    cfg, lparams = cut_layers(lm_host.cfg, lm_host.params, EQ4_LM_LAYERS)
    lparams = tree_map(lambda t: t.clone(), lparams)
    lm_host = TransformerHost(cfg, lparams, env=lm_host.env, device=dev)
    # its magnitude plan, on the timings phase 8's oracle holds (the
    # signatures are phase 8's), at the first budget from phase 8's on
    # that merges an FFN
    lm_mag = None
    for lm_budget in [b for b in LM_BUDGETS if b >= lm_budget]:
        r = compress(lm_host, budget_ratio=lm_budget, method="depth",
                     latency_oracle=lm_oracle, probe_config=strict_probes())
        if r is not None and runtime.count_units(r.lower()).get("lowrank",
                                                                0):
            lm_mag = r
            break
    check(lm_mag is not None, f"smollm-135m at {EQ4_LM_LAYERS} layers: no "
          f"budget in {LM_BUDGETS} merges an FFN")
    g = torch.Generator().manual_seed(21)
    shape = (lm_host.env.batch, lm_host.env.seq)
    btr, bev = ({"tokens": torch.randint(0, cfg.vocab_size, shape,
                                         generator=g).to(dev)}
                for _ in range(2))
    dl = distill_loss(fixed_teacher(lambda b: T.forward(cfg, lparams, b),
                                    btr, bev))
    perfs = []
    lspec = ImportanceSpec(dl, neg_loss_perf(dl), [btr], [bev], steps=8,
                           lr=1e-3)
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    res = compress(lm_host, budget_ratio=lm_budget, method="depth",
                   latency_oracle=lm_oracle, importance=ImportanceSpec(
                       dl, recording(neg_loss_perf(dl), perfs), [btr], [bev],
                       steps=8, lr=1e-3), base_perf=0.0,
                   probe_config=strict_probes())
    peak = torch.cuda.max_memory_allocated()
    launches = kernels.launch_counts()
    check(res is not None, f"smollm-135m Eq. 4: no plan fits {lm_budget}")
    imps = [perf_to_importance(v, 0.0, lspec) for v in perfs]
    segs = [p[5] for p in enumerate_probes(lm_host, "depth")
            if not p[5].original]
    fc, pc = lm_host.replaced_apply(one_segment_plan(lm_host, segs[0]))
    t2 = time.perf_counter()
    row = eq4_report("smollm-135m", res.tables, imps, lspec.steps, peak,
                     lambda: measure_importance(fc, pc, lspec, 0.0))
    t3 = time.perf_counter()
    c_path = os.path.join(WORK, "smollm135m_eq4.npz")
    res.save(c_path)
    art = runtime.load(c_path, device=dev)
    t4 = time.perf_counter()
    B, N = prompt.shape[0], new_tokens
    _, o_dec, _, _, _ = serve_both(
        f"smollm-135m original, {EQ4_LM_LAYERS} layers",
        lambda c, t: T.decode_step(cfg, lparams, c, {"tokens": t}),
        lambda: T.init_cache(cfg, B, prompt.shape[1] + N, device=dev),
        prompt, N)
    _, dec, _, _, served = serve_both(
        "smollm-135m Eq. 4 plan", lambda c, t: art.decode(c, t),
        lambda: art.init_cache(B, prompt.shape[1] + N), prompt, N)
    row.update(compress_s=t2 - t1, report_s=t3 - t2, artifact_s=t4 - t3,
               serve_s=time.perf_counter() - t4)
    diff = differing_budgets(lm_host, res.tables, lm_mag.tables,
                             res.original_latency, "depth")
    row.update(plan=plan_line(res.plan), units=unit_census(res.lower()),
               magnitude_plan=plan_line(lm_mag.plan), plans_differ_at=diff,
               same_as_magnitude=res.plan.segments == lm_mag.plan.segments,
               budget=lm_budget, layers=EQ4_LM_LAYERS, launches=launches,
               decode_tok_s=served["tok_s"], decode_speedup=o_dec / dec,
               predicted=res.speedup)
    out["smollm-135m"] = row
    log("importance smollm-135m", t0, f"{EQ4_LM_LAYERS} of 30 layers, "
        f"depth {lm_budget}: Eq. 4 plan "
        f"{row['plan']}, units {row['units']} (the magnitude plan: "
        f"{row['magnitude_plan']}; same {row['same_as_magnitude']}; the "
        f"two tables plan differently at budgets {diff} of "
        f"{list(PLAN_RATIOS)}); captured decode {served['tok_s']:.1f} tok/s, "
        f"{row['decode_speedup']:.3f}x the original's (predicted "
        f"{res.speedup:.4f}x); fine-tune launches {launches}; seconds: "
        f"compress {row['compress_s']:.2f}, report {row['report_s']:.2f}, "
        f"artifact {row['artifact_s']:.2f}, serve {row['serve_s']:.2f}")
    for k in ("merged_ffn", "rmsnorm", "flash_attention"):
        check(launches[k] > 0, f"smollm-135m Eq. 4: {k} never launched")
    return out


# ---------------------------------------------------------------------------
# Phase 21: the crash-safe table build on the card
# ---------------------------------------------------------------------------

#: Phase 21 (b): the journaled bucket at which the child dies (MobileNetV2
#: at --max-span 6 has 127 signatures).
KILL_AT_BUCKET = 40
#: Phase 21 (e): the ``tables.importance`` hit at which the child dies.
KILL_AT_IMPORTANCE = 3
#: Phase 21 (c): the probe budget, and a straggler's delay at 4x it.
PROBE_TIMEOUT_S, STRAGGLER_S = 1.0, 4.0
#: Phase 21 (c): failed timings in a row that quarantine a bucket.
PROBE_RETRIES = 2


def eq4_journal_build(cache_dir, dev):
    """Phase 21 (e)'s build, run alike by the crashed child and this
    process: the quickstart network pre-trained as phase 20 (b) does,
    then Eq. 4 tables (``accuracy_perf``, 5 steps at lr 1e-3, named by a
    ``cache_token``) on the analytic oracle, journaled in ``cache_dir``
    (None: no cache).  Under deterministic cuDNN, so the pre-trained
    weights — part of the cache key — and every fine-tune are bitwise
    the same in both processes."""
    from repro_torch.core import (AnalyticOracle, ImportanceSpec,
                                  accuracy_perf, build_tables, table_cache,
                                  xent_loss)
    from repro_torch.device import deterministic_cudnn

    with deterministic_cudnn():
        host, train, evals, base = quickstart_host(dev)
        spec = ImportanceSpec(xent_loss, accuracy_perf, train, evals,
                              steps=5, lr=1e-3, cache_token="quickstart-eq4")
        key = table_cache.cache_key(host, AnalyticOracle(), "layermerge",
                                    spec, base_perf=base)
        return key, build_tables(host, latency_oracle=AnalyticOracle(),
                                 importance=spec, base_perf=base,
                                 cache_dir=cache_dir)


def artifact_spec(path) -> tuple[dict, str]:
    """An artifact's spec and fingerprint, read without its weights."""
    import numpy as np
    with np.load(path, allow_pickle=False) as z:
        return (json.loads(z["__spec__"].item()),
                z["__fingerprint__"].item())


def table_phase(dev, cnn_h, lm_host, lm_budget) -> tuple[dict, dict]:
    """Phase 21: the table cache, the journal's kill and resume, the probe
    guards and the Eq. 4 journal on the card; ``(row, launches)``."""
    import glob
    import shutil

    import torch
    from repro_torch import kernels, runtime
    from repro_torch.compress import main as compress_main
    from repro_torch.core import (AnalyticOracle, ProbeConfig,
                                  WallClockOracle, compress,
                                  enumerate_probes, table_cache)
    from repro_torch.core.probe_engine import PROBE_QUARANTINED
    from repro_torch.testing import faults
    from repro_torch.testing.subproc import subprocess_env

    root = os.path.join(WORK, "tables")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    row: dict = {}
    kernels.reset_launch_counts()

    # (a) the cache: phase 4's compress through the CLI, twice -------------
    t0 = time.perf_counter()
    cache_a = os.path.join(root, "a")
    argv = ["--arch", "mobilenetv2", "--oracle", "wallclock",
            "--max-span", "6", "--budget-ratio", "0.6", "--batch", "8",
            "--cache-dir", cache_a]
    paths = [os.path.join(root, f"a{n}.npz") for n in (1, 2)]
    runs, secs = [], []
    for path in paths:
        t1 = time.perf_counter()
        ora = WallClockOracle()
        runs.append(compress_main(argv + ["--out", path], latency_oracle=ora))
        secs.append(time.perf_counter() - t1)
        check_probes(ora, runs[-1], f"(a) run {len(runs)}")
        if len(runs) == 1:
            left = glob.glob(os.path.join(cache_a, "*.journal"))
            check(not left, f"(a) run 1 left a journal: {left}")
            # run 1's single-process timings, phase 25's yardstick
            timings_a = {repr(sig): sec for sig, sec in ora.measured.items()}
    (s1, s2), specs = runs, [artifact_spec(p) for p in paths]
    row["a"] = {"run_s": secs, "timed": [r["signatures_timed"] for r in runs],
                "cache_hit": [r["cache_hit"] for r in runs],
                "signatures": s1["latency_signatures"],
                "timings": timings_a}
    log("tables cache", t0, f"mobilenetv2 through the CLI with --cache-dir: "
        f"run 1 {secs[0]:.2f}s, {s1['signatures_timed']} of "
        f"{s1['latency_signatures']} signatures timed, published; run 2 "
        f"{secs[1]:.2f}s, cache hit {s2['cache_hit']}, "
        f"{s2['signatures_timed']} timed (T_orig included); plans equal "
        f"{specs[0][0]['plan'] == specs[1][0]['plan']}, T_orig "
        f"{s1['original_latency_s']!r} and {s2['original_latency_s']!r}, "
        f"fingerprints equal {specs[0][1] == specs[1][1]}")
    check(not s1["cache_hit"] and s1["signatures_timed"] > 0,
          "(a) run 1 timed nothing")
    check(s2["cache_hit"] and s2["signatures_timed"] == 0,
          f"(a) run 2: cache hit {s2['cache_hit']}, "
          f"{s2['signatures_timed']} signatures timed")
    check(specs[0][0]["plan"] == specs[1][0]["plan"]
          and s1["original_latency_s"] == s2["original_latency_s"]
          and specs[0][1] == specs[1][1],
          "(a) the cache hit's plan, T_orig or artifact differs from run 1's")

    # (b) kill and resume: a child dies at its 40th journaled bucket -------
    t0 = time.perf_counter()
    kr = {o: faults.kill_resume_smoke(
        KILL_AT_BUCKET, device="cuda", oracle=o, arch="mobilenetv2",
        batch=8, max_span=6, work_dir=root) for o in ("wallclock",
                                                      "analytic")}
    row["b"] = kr
    w = kr["wallclock"]
    log("tables resume", t0, f"mobilenetv2, child killed at bucket "
        f"{KILL_AT_BUCKET} (exit 17, one journal of "
        f"{w['journal_records']} records; child {w['child_s']:.2f}s); "
        f"wall-clock resume {w['resume_s']:.2f}s: {w['journal_hits_on_resume']}"
        f" journal hits, {w['signatures_timed_on_resume']} signatures timed "
        f"(T_orig included), {w['entries_checked_against_journal']} entries "
        f"and {w['t_orig_layers_journaled']} T_orig terms bitwise the "
        f"journal's, journal gone, third build a bitwise cache hit; "
        f"analytic: {kr['analytic']['journal_hits_on_resume']} hits, "
        f"bitwise the uninterrupted build (child "
        f"{kr['analytic']['child_s']:.2f}s)")
    check(w["journal_hits_on_resume"] >= KILL_AT_BUCKET - 1,
          f"(b) {w['journal_hits_on_resume']} journal hits")

    # (c) hardening --------------------------------------------------------
    t0 = time.perf_counter()
    straggle = ProbeConfig(timeout_s=PROBE_TIMEOUT_S)
    with faults.inject(faults.Fault("probe.time", "delay",
                                    seconds=STRAGGLER_S)) as plan:
        rs = compress(cnn_h, budget_ratio=0.6, latency_oracle=WallClockOracle(),
                      probe_config=straggle)
    st = rs.tables.stats
    check(plan.fired == [("probe.time", 1, "delay")]
          and st.num_probe_retries == 1 and st.num_quarantined == 0
          and PROBE_QUARANTINED not in rs.tables.provenance.values(),
          f"(c) straggler: fired {plan.fired}, {st.num_probe_retries} "
          f"retries, {st.num_quarantined} quarantined")
    quar = ProbeConfig(retries=PROBE_RETRIES)
    ora = WallClockOracle()
    with faults.inject(faults.Fault("probe.time", "raise",
                                    times=PROBE_RETRIES + 1)):
        rq = compress(cnn_h, budget_ratio=0.6, latency_oracle=ora,
                      probe_config=quar)
    first = enumerate_probes(cnn_h)[0][5]
    sig = cnn_h.probe_signature(first)
    flagged = {ijk: f for ijk, f in rq.tables.provenance.items()
               if f == PROBE_QUARANTINED}
    estimate = AnalyticOracle().segment_latency(cnn_h.segment_cost(first))
    q_path = os.path.join(root, "quarantined.npz")
    rq.save(q_path)
    q_art = runtime.load(q_path, device=dev)
    y = q_art.apply(torch.randn(8, 224, 224, 3,
                                generator=torch.Generator().manual_seed(5))
                    .to(dev))
    prov = q_art.meta["probe_provenance"]
    (i, j, k) = next(iter(flagged), (None, None, None))
    row["c"] = {"straggler_retries": st.num_probe_retries,
                "quarantined": rq.tables.stats.num_quarantined,
                "flagged": [list(x) for x in flagged],
                "estimate_s": estimate, "artifact_provenance": prov}
    check(rq.tables.stats.num_quarantined == 1 and flagged
          and ora.recall(sig) == (None, PROBE_QUARANTINED)
          and rq.tables.entries[(i, j)][k][1] == estimate,
          f"(c) quarantine: {rq.tables.stats.num_quarantined} buckets, "
          f"flags {flagged}")
    check(prov == [{"i": a, "j": b, "k": c, "flag": f} for (a, b, c), f in
                   sorted(rq.tables.provenance.items())],
          f"(c) artifact provenance {prov}")
    check(tuple(y.shape) == (8, 1000) and bool(torch.isfinite(y).all()),
          "(c) the quarantined plan's artifact does not run")
    # a truncated cache file: quarantined, the entry rebuilt
    cached = glob.glob(os.path.join(cache_a, "tables_*.json"))
    check(len(cached) == 1, f"(c) cache files {cached}")
    with open(cached[0], "r+") as f:
        f.truncate(40)
    ora = WallClockOracle()
    s3 = compress_main(argv + ["--out", os.path.join(root, "a3.npz")],
                       latency_oracle=ora)
    check_probes(ora, s3, "(c) the rebuild of the truncated cache entry")
    key = os.path.basename(cached[0])[len("tables_"):-len(".json")]
    rebuilt = table_cache.load(cache_a, key)
    check(not s3["cache_hit"] and os.path.exists(cached[0] + ".corrupt")
          and rebuilt is not None, "(c) truncated cache file: hit "
          f"{s3['cache_hit']}, rebuilt {rebuilt is not None}")
    # a truncated artifact: quarantined, the hint in the error
    with open(paths[0], "r+b") as f:
        f.truncate(os.path.getsize(paths[0]) // 3)
    try:
        runtime.load(paths[0], device=dev)
        msg = None
    except runtime.ArtifactError as e:
        msg = str(e)
    check(msg is not None and "quarantined to" in msg and "re-publish"
          in msg and os.path.exists(paths[0] + ".corrupt")
          and not os.path.exists(paths[0]),
          f"(c) truncated artifact: {msg}")
    launch_c = kernels.launch_counts()
    log("tables guards", t0, f"straggler {STRAGGLER_S}s at a "
        f"{PROBE_TIMEOUT_S}s budget: {st.num_probe_retries} retries, "
        f"{st.num_quarantined} quarantined; raise@probe.time x"
        f"{PROBE_RETRIES + 1}: {rq.tables.stats.num_quarantined} bucket "
        f"quarantined ({sig[:8]}...), its entry the analytic "
        f"{estimate:.3e}s, flags {sorted(flagged)} in the tables and the "
        f"artifact, which reloads and runs on the card; truncated cache "
        f"file -> .corrupt, rebuilt ({s3['signatures_timed']} timed); "
        f"truncated artifact -> .corrupt: {msg!r}; launches (a)-(c) "
        f"{launch_c}")
    for name in ("merged_conv", "depthwise_conv"):
        check(launch_c[name] > 0, f"(a)-(c): {name} never launched")

    # (d) SmolLM-135M, phase 8's depth compress with --cache-dir, twice ---
    t0 = time.perf_counter()
    t1 = time.perf_counter()
    lm_host.fingerprint()
    fp_s = time.perf_counter() - t1
    cache_d = os.path.join(root, "d")
    argv_lm = ["--arch", "smollm-135m", "--full", "--method", "depth",
               "--oracle", "wallclock", "--batch", "8", "--seq", "128",
               "--budget-ratio", str(lm_budget), "--cache-dir", cache_d]
    lm_runs, lm_secs = [], []
    for n in (1, 2):
        t1 = time.perf_counter()
        ora = WallClockOracle()
        lm_runs.append(compress_main(argv_lm + ["--out", os.path.join(
            root, f"lm{n}.npz")], latency_oracle=ora))
        lm_secs.append(time.perf_counter() - t1)
        check_probes(ora, lm_runs[-1], f"(d) run {n}")
    lm_plans = [artifact_spec(os.path.join(root, f"lm{n}.npz"))[0]["plan"]
                for n in (1, 2)]
    launches = kernels.launch_counts()
    launch_d = {k: launches[k] - launch_c[k] for k in launches}
    r1, r2 = lm_runs
    row["d"] = {"fingerprint_s": fp_s, "run_s": lm_secs,
                "timed": [r["signatures_timed"] for r in lm_runs],
                "cache_hit": [r["cache_hit"] for r in lm_runs],
                "launches": launch_d}
    log("tables lm", t0, f"smollm-135m depth {lm_budget} with --cache-dir: "
        f"fingerprint (pytree digest of the fp32 weights) {fp_s:.2f}s; run "
        f"1 {lm_secs[0]:.2f}s, {r1['signatures_timed']} signatures timed; "
        f"run 2 {lm_secs[1]:.2f}s, cache hit {r2['cache_hit']}, "
        f"{r2['signatures_timed']} timed; plans equal "
        f"{lm_plans[0] == lm_plans[1]}; launches {launch_d}")
    check(r2["cache_hit"] and r2["signatures_timed"] == 0
          and lm_plans[0] == lm_plans[1]
          and r1["original_latency_s"] == r2["original_latency_s"],
          "(d) smollm-135m: the second run is not a cache hit of the "
          "first's plan")
    for name in ("merged_ffn", "rmsnorm", "flash_attention"):
        check(launch_d[name] > 0, f"(d): {name} never launched")

    # (e) the Eq. 4 journal: a child dies at its 3rd importance probe ------
    t0 = time.perf_counter()
    cache_e = os.path.join(root, "e")
    t1 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--eq4-child", cache_e],
        env=subprocess_env(device="cuda", faults_spec=f"exit@tables."
                           f"importance:{KILL_AT_IMPORTANCE}"),
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    child_s = time.perf_counter() - t1
    journals = glob.glob(os.path.join(cache_e, "*.journal"))
    check(r.returncode == 17 and len(journals) == 1,
          f"(e) child exited {r.returncode} leaving {journals}:\n"
          f"{r.stdout[-2000:]}{r.stderr[-2000:]}")
    t1 = time.perf_counter()
    key, resumed = eq4_journal_build(cache_e, dev)
    resume_s = time.perf_counter() - t1
    _, whole = eq4_journal_build(None, dev)
    hits = resumed.stats.num_journal_hits
    child_key = journals[0].split("tables_")[-1][:-len(".journal")]
    row["e"] = {"child_s": child_s, "resume_s": resume_s,
                "journal_hits": hits,
                "finetunes_on_resume": resumed.stats
                .num_importance_sequential,
                "probes": resumed.stats.num_importance_probes}
    log("tables eq4", t0, f"quickstart Eq. 4 tables (analytic latency), "
        f"child killed at importance probe {KILL_AT_IMPORTANCE} "
        f"({child_s:.2f}s); resume {resume_s:.2f}s: {hits} journal hits, "
        f"{resumed.stats.num_importance_sequential} of "
        f"{resumed.stats.num_importance_probes} probes fine-tuned; the "
        f"importance column bitwise the uninterrupted build's "
        f"{resumed.entries == whole.entries}")
    check(child_key == key, "(e) the child's cache key differs from this "
          "process's: the pre-trained weights are not bitwise equal")
    check(hits >= KILL_AT_IMPORTANCE, f"(e) {hits} journal hits")
    check(resumed.entries == whole.entries, "(e) the resumed importance "
          "column differs from the uninterrupted build's")
    return row, launches


# ---------------------------------------------------------------------------
# The paper's CNNs on card-timed tables: the DDPM UNet and ResNet34
# ---------------------------------------------------------------------------

def cnn_card_check(label, art, art_cpu, host, batches, shape) -> dict:
    """The artifact on the card against the same artifact on the CPU (the
    plain versions) and against ``apply_replaced`` of its plan on the
    card, each batch: finite outputs of ``shape``, max |Δ| over max |y|
    within ``NET_RTOL``; returns the worst of each."""
    import torch
    from repro_torch.models import cnn
    d_cpu = d_rep = 0.0
    for xb in batches:
        xd = xb.to(host.device)
        y = art.apply(xd)
        torch.cuda.synchronize()
        check(tuple(y.shape) == shape, f"{label}: output {tuple(y.shape)}, "
              f"want {shape}")
        check(bool(torch.isfinite(y).all()), f"{label}: non-finite output")
        y_cpu = art_cpu.apply(xb)
        d_cpu = max(d_cpu, float((y.cpu() - y_cpu).abs().max()
                                 / y_cpu.abs().max()))
        y_rep = cnn.apply_replaced(host.net, host.params, xd, art.plan)
        d_rep = max(d_rep, float((y - y_rep).abs().max()
                                 / y_rep.abs().max()))
    check(d_cpu <= NET_RTOL, f"{label}: card vs CPU port differ by {d_cpu}")
    check(d_rep <= NET_RTOL, f"{label}: merged vs apply_replaced differ by "
          f"{d_rep}")
    return {"batches": len(batches), "vs_cpu": d_cpu,
            "vs_replaced": d_rep, "limit": NET_RTOL}


def replay_ms(*fns) -> list:
    """Device milliseconds of each forward as a CUDA-graph replay (the
    tables' protocol)."""
    from repro_torch.core import WallClockOracle
    ora = WallClockOracle()
    return [ora.time_callable(fn) * 1e3 for fn in fns]


def plan_segments(plan) -> list:
    return [[s.i, s.j, s.k, list(s.kept)] for s in plan.segments]


def compress_row(summary, seconds: float) -> dict:
    return {"seconds": seconds, "probes": summary["latency_probes"],
            "signatures": summary["latency_signatures"],
            "signatures_timed": summary["signatures_timed"],
            "retried": summary["retried"],
            "quarantined": summary["quarantined"],
            "t_orig_s": summary["original_latency_s"],
            "t_plan_s": summary["compressed_latency_s"],
            "predicted_speedup": summary["predicted_speedup"]}


def unet_phase(dev, compress_main) -> tuple[dict, dict, dict]:
    """Phase 22: the DDPM UNet (``zoo.ddpm_unet()``, the reference's chain:
    32², base 128, two down and two up levels with concat skips, GN(8),
    one attention barrier at 8×8, a 4-channel input) compressed on
    card-timed tables, served on the card and timed.  Returns (the
    phase's numbers, merged_conv's per-unit sums, the launches of
    (a)-(c) counted from zero)."""
    import torch
    from repro_torch import kernels, runtime
    from repro_torch.compress import build_host
    from repro_torch.core import WallClockOracle
    from repro_torch.core.plan import identity_plan

    kernels.reset_launch_counts()
    out: dict = {}
    # (a) compress on tables timed on the card
    t0 = time.perf_counter()
    path = os.path.join(WORK, "ddpm_unet.npz")
    oracle = WallClockOracle()
    summary = compress_main(["--arch", "ddpm_unet", "--oracle", "wallclock",
                             "--budget-ratio", "0.6", "--batch", "8",
                             "--out", path], latency_oracle=oracle)
    check_probes(oracle, summary, "ddpm_unet compress")
    out["compress"] = compress_row(summary, time.perf_counter() - t0)
    art = runtime.load(path, device="cuda")
    units = art.graph.units
    census = runtime.count_units(art.graph)
    out["plan"] = plan_segments(art.plan)
    out["units"] = census
    log("unet compress", t0, f"{summary['latency_probes']} probes in "
        f"{summary['latency_signatures']} signatures, "
        f"{summary['signatures_timed']} timed on the card (0 retried, 0 "
        f"quarantined); plan {plan_line(art.plan)} "
        f"{json.dumps(out['plan'])}; units {json.dumps(census)}; T_orig "
        f"{summary['original_latency_s']:.6g} s; predicted speedup "
        f"{summary['predicted_speedup']:.4f}")
    check(any(u.kind == "upsample" for u in units), "unet: no upsample unit")
    check(any(u.kind == "attn" for u in units), "unet: no attention unit")
    check(any(getattr(u, "concat_from", None) is not None for u in units),
          "unet: no unit with concat_from")
    check(any(u.kind == "conv" and "gn" in u.params for u in units),
          "unet: no conv with a group norm")

    # (b) serve: the card against the CPU port and apply_replaced
    t0 = time.perf_counter()
    host, _ = build_host("ddpm_unet", seed=0, batch=8, device="cuda")
    gen = torch.Generator().manual_seed(2222)
    batches = [torch.randn(8, 32, 32, 4, generator=gen) for _ in range(2)]
    out["held"] = cnn_card_check("ddpm_unet", art,
                                 runtime.load(path, device="cpu"), host,
                                 batches, (8, 32, 32, 3))
    log("unet serve", t0, f"{len(batches)} batches (8, 32, 32, 4): worst "
        f"vs CPU port {out['held']['vs_cpu']:.3g}, vs apply_replaced "
        f"{out['held']['vs_replaced']:.3g} (limit {NET_RTOL})")

    # (c) time the original and the merged forward
    t0 = time.perf_counter()
    orig = host.lower_plan(identity_plan(host.net.L, host.descs()))
    xb = batches[0].to(dev)

    def merged():
        return art.apply(xb)

    def original():
        return runtime.execute(orig, xb)
    ev_merged = cuda_time(merged, iters=20)
    ev_orig = cuda_time(original, iters=20)
    dev_merged, dev_orig = replay_ms(merged, original)
    busy_us, busy_rows = device_kernels(merged)
    launches = kernels.launch_counts()
    out["timing"] = {
        "event_ms": {"original": ev_orig, "merged": ev_merged},
        "replay_ms": {"original": dev_orig, "merged": dev_merged},
        "measured_speedup": dev_orig / dev_merged,
        "predicted_speedup": summary["predicted_speedup"],
        "busy_us": busy_us,
        "busy_share": busy_us / (ev_merged * 1e3) if busy_rows else None,
        "by_kernel": [[name, us, n] for us, n, name in busy_rows[:10]]}
    out["launches"] = launches
    log("unet timing", t0, f"batch-8 forward (CUDA events) original "
        f"{ev_orig:.4f} ms, merged {ev_merged:.4f} ms; CUDA-graph replay "
        f"original {dev_orig:.4f} ms, merged {dev_merged:.4f} ms "
        f"({dev_orig / dev_merged:.3f}x, predicted "
        f"{summary['predicted_speedup']:.4f}x); merged forward device busy "
        + (f"{busy_us:.1f} us = {busy_us / (ev_merged * 1e3):.3f} of its "
           "CUDA-event time; by kernel: " + "; ".join(
               f"{name[:50]} {us:.1f}us x{n}"
               for us, n, name in busy_rows[:6]) if busy_rows else
           "not measured (the profiler saw no device activity)")
        + f"; launches (a)-(c) {launches}")
    check(launches["merged_conv"] > 0,
          "merged_conv never launched in phase 22")

    # (d) each conv unit at its shape, against cuDNN and the bound (the
    # depthwise units are the identity 1x1 convs of pruned segments)
    t0 = time.perf_counter()
    tots = time_main_path_kernels(art.graph, dev, 8, label="ddpm_unet ",
                                  hw=32, cin=4)
    out["kernels"] = tots
    log("unet units", t0, " ".join(
        f"{k}: {v['units']} units ms={v['ms']:.4f} plain={v['plain_ms']:.4f} "
        f"library(cuDNN)={v['library_ms']:.4f} bound={v['bound_ms']:.4f} "
        f"({v['bound_rate']});" for k, v in tots.items()) + " merged_conv "
        "by unit (x, w, stride, ms, cuDNN ms, share, tile): " + "; ".join(
            f"{r['x']} {r['w']} s{r['stride']} {r['ms']:.4f} "
            f"{r['library_ms']:.4f} {r['share']:.3f} {r['plan']['tile']}"
            for r in tots["merged_conv"]["rows"]))
    return out, tots, launches


def resnet34_wallclock(dev, compress_main, analytic, xr) -> dict:
    """Phase 7 (b): ResNet34 compressed as in phase 7 but on tables timed
    on the card; the artifact held against the CPU port and
    ``apply_replaced`` on ``xr``, and the original's and the merged
    graph's CUDA-graph replays beside the predicted speedup and the
    replay of phase 7's plan.  ``analytic``: phase 7's compress summary,
    seconds, plan and artifact (``art``)."""
    import torch
    from repro_torch import kernels, runtime
    from repro_torch.compress import build_host
    from repro_torch.core import WallClockOracle
    from repro_torch.core.plan import identity_plan

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    path = os.path.join(WORK, "resnet34_wallclock.npz")
    oracle = WallClockOracle()
    summary = compress_main(["--arch", "resnet34", "--oracle", "wallclock",
                             "--budget-ratio", "0.6", "--batch", "8",
                             "--out", path], latency_oracle=oracle)
    check_probes(oracle, summary, "resnet34 wall-clock compress")
    out = {"compress": compress_row(summary, time.perf_counter() - t0),
           "analytic": compress_row(analytic["summary"], analytic["seconds"])}
    art = runtime.load(path, device="cuda")
    out["plan"] = plan_segments(art.plan)
    out["analytic"]["plan"] = analytic["plan"]
    out["units"] = runtime.count_units(art.graph)
    log("resnet34 wallclock compress", t0, f"{summary['latency_probes']} "
        f"probes in {summary['latency_signatures']} signatures, "
        f"{summary['signatures_timed']} timed on the card (0 retried, 0 "
        f"quarantined); card-timed plan {plan_line(art.plan)}, predicted "
        f"speedup {summary['predicted_speedup']:.4f}, T_orig "
        f"{summary['original_latency_s']:.6g} s; analytic plan "
        f"{analytic['line']}, predicted "
        f"{analytic['summary']['predicted_speedup']:.4f}; same plan: "
        f"{out['plan'] == analytic['plan']}")
    t0 = time.perf_counter()
    host, _ = build_host("resnet34", seed=0, batch=8, device="cuda")
    out["held"] = cnn_card_check("resnet34 wallclock", art,
                                 runtime.load(path, device="cpu"), host,
                                 [xr], (xr.shape[0], 1000))
    orig = host.lower_plan(identity_plan(host.net.L, host.descs()))
    gen = torch.Generator().manual_seed(4321)
    xb = torch.randn(8, 224, 224, 3, generator=gen).to(dev)
    dev_merged, dev_orig = replay_ms(lambda: art.apply(xb),
                                     lambda: runtime.execute(orig, xb))
    out["launches"] = kernels.launch_counts()
    # phase 7's plan (analytic tables) on the same card and input: which
    # tables plan the faster network on this card
    dev_analytic, = replay_ms(lambda: analytic["art"].apply(xb))
    out["replay_ms"] = {"original": dev_orig, "merged": dev_merged,
                        "analytic_plan": dev_analytic}
    out["measured_speedup"] = dev_orig / dev_merged
    out["predicted_speedup"] = summary["predicted_speedup"]
    log("resnet34 wallclock serve", t0, f"logits vs CPU port "
        f"{out['held']['vs_cpu']:.3g}, vs apply_replaced "
        f"{out['held']['vs_replaced']:.3g} (limit {NET_RTOL}); batch-8 "
        f"CUDA-graph replay original {dev_orig:.4f} ms, merged "
        f"{dev_merged:.4f} ms ({dev_orig / dev_merged:.3f}x, predicted "
        f"{summary['predicted_speedup']:.4f}x), phase 7's analytic plan "
        f"{dev_analytic:.4f} ms ({dev_orig / dev_analytic:.3f}x); units "
        f"{json.dumps(out['units'])}; launches {out['launches']}")
    check(out["launches"]["merged_conv"] > 0,
          "merged_conv never launched in phase 7 (b)")
    return out


# ---------------------------------------------------------------------------
# 23. the reference's other transformer families
# ---------------------------------------------------------------------------

class RouteLog:
    """While active, every MoE ``route`` call records the experts it chose
    (on the host: eager runs only), their keep flags under the call's
    capacity and the smallest gap between the k-th and the (k+1)-th gate.
    Given ``forced`` (another run's records, in call order) each call
    instead replays that run's gates and experts through ``route``'s
    test hook: how the CPU port follows the card's routing where a
    near-tie flipped a choice."""

    def __init__(self, forced=None):
        self.forced = forced
        self.calls: list = []

    def __enter__(self):
        import torch
        from repro_torch.models import moe as MOE
        self._orig = orig = MOE.route

        def route(p, xt, cfg, forced=None):
            if self.forced is not None:
                rec = self.forced[len(self.calls)]
                g, e = orig(p, xt, cfg, forced=(rec["g"], rec["e"]))
            else:
                g, e = orig(p, xt, cfg)
            k, n_e = cfg.experts_per_token, cfg.num_experts
            gates = torch.softmax((xt @ p["router"]).float(), dim=-1)
            top = torch.topk(gates, k + 1, dim=-1).values
            # moe_ffn's capacity
            cap = max(int(math.ceil(xt.shape[0] * k / n_e
                                    * cfg.capacity_factor)), 1)
            keep = MOE.capacity_positions(e, n_e, cap)[1]
            self.calls.append({"g": g.detach().cpu(), "e": e.cpu(),
                               "keep": keep.cpu(), "margin": float(
                                   (top[:, k - 1] - top[:, k]).min())})
            return g, e
        MOE.route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as MOE
        MOE.route = self._orig

    def dropped(self) -> int:
        return sum(int((~c["keep"]).sum()) for c in self.calls)


def routing_diff(a, b) -> tuple[int, int]:
    """(routing choices, keep flags) that differ between two runs' route
    records: a token's k choices compared as a set (sorted by expert),
    with each choice's keep flag."""
    check(len(a) == len(b), f"route calls {len(a)} vs {len(b)}")
    n_e = n_k = 0
    for x, y in zip(a, b):
        ex, ix = x["e"].sort(dim=-1)
        ey, iy = y["e"].sort(dim=-1)
        n_e += int((ex != ey).sum())
        n_k += int((x["keep"].gather(1, ix) != y["keep"].gather(1, iy)).sum())
    return n_e, n_k


def step_rel(lg, ref) -> float:
    """Worst step of (B, T, V) logits: max over t of max |Δ| / max |y|."""
    lg, ref = lg.detach().cpu(), ref.detach().cpu()
    return float(((lg - ref).abs().amax(dim=(0, 2))
                  / ref.abs().amax(dim=(0, 2))).max())


def captured_logits(step, new_cache, fed):
    """(B, T, V) logits of feeding ``fed`` (B, T) teacher-forced through
    one captured step replayed per position (``serving._StepGraph``, every
    position inside the prompt), each step's logits copied out inside the
    graph."""
    import torch
    from repro_torch.runtime import serving

    B, T = fed.shape
    store = {}

    def hook(lg, t):
        if "buf" not in store:
            store["buf"] = torch.zeros((B, T, lg.shape[-1]), dtype=lg.dtype,
                                       device=lg.device)
        store["buf"].index_copy_(1, t.reshape(1), lg[:, -1:])
        return lg
    run = serving._StepGraph(step, new_cache(), B, T, hook)
    lengths = torch.full((B,), T)
    run.prepare(fed, lengths)
    run.reset(fed, lengths)
    run.advance(T)
    run.synchronize()
    return store["buf"].clone()


def mrope_streams(b: int, s: int, grid: int = 4):
    """(3, B, S) int32 M-RoPE position streams: a temporal ``arange``;
    height and width of a ``grid`` × ``grid`` patch grid over the first
    ``grid²`` positions, the text position after them."""
    import torch
    t = torch.arange(s)
    n = grid * grid
    h = torch.where(t < n, t // grid, t)
    w = torch.where(t < n, t % grid, t)
    return torch.stack([t, h, w])[:, None, :].expand(3, b, s).to(
        torch.int32).contiguous()


def graph_step_stats(fn, reps: int = 10) -> dict:
    """One call of ``fn`` captured in a CUDA graph: device ms a replay
    (the wall-clock oracle's protocol) and the busy share of a replay
    from a torch.profiler trace (None where it sees no device work)."""
    import torch
    from repro_torch.core import WallClockOracle
    ms = WallClockOracle().time_callable(fn) * 1e3
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    busy_us, rows = device_kernels(graph.replay, reps=reps)
    return {"ms": ms, "busy_us": busy_us,
            "busy_share": busy_us / (ms * 1e3) if rows else None,
            "by_kernel": [[name[:60], us, n] for us, n, name in rows[:6]]}


def card_compress(host, budgets, need_merge: bool,
                  method: str = "depth") -> tuple:
    """Compress on tables timed on the card (strict probes): the first
    budget of ``budgets`` whose plan is feasible (and, with
    ``need_merge``, merges an FFN).  Returns (result, the numbers)."""
    from repro_torch.core import WallClockOracle, compress

    t0 = time.perf_counter()
    oracle = WallClockOracle()
    res, ladder, budget = None, [], None
    for ratio in budgets:
        r = compress(host, budget_ratio=ratio, method=method,
                     latency_oracle=oracle, probe_config=strict_probes())
        n_m = 0 if r is None else merged_segments(host, r.plan)
        ladder.append(f"{ratio}: " + ("infeasible" if r is None else
                                      f"{n_m} merged, predicted speedup "
                                      f"{r.speedup:.4f}"))
        if r is not None and (n_m or not need_merge):
            res, budget = r, ratio
            break
    check(res is not None, f"{host.cfg.name}: no budget of {budgets} gives "
          f"a plan{' that merges an FFN' if need_merge else ''} "
          f"({'; '.join(ladder)})")
    st = res.tables.stats
    row = {"seconds": time.perf_counter() - t0,
           "probes": st.num_latency_probes,
           "signatures": st.num_latency_buckets,
           "signatures_timed": oracle.num_timed,
           "retried": st.num_probe_retries,
           "quarantined": st.num_quarantined,
           "t_orig_s": res.original_latency,
           "t_plan_s": res.compressed_latency,
           "predicted_speedup": res.speedup, "budget": budget,
           "method": method,
           "ladder": ladder, "plan": plan_line(res.plan),
           "merged": merged_segments(host, res.plan),
           "signature_ms": {f"{sig[1]} rank {sig[2]}": sec * 1e3
                            for sig, sec in oracle.measured.items()}}
    check(row["retried"] == 0 and row["quarantined"] == 0,
          f"{host.cfg.name}: {row['retried']} probe retries, "
          f"{row['quarantined']} quarantined")
    return res, row


def solo_requests(step, make_cache, prompts, tokens: int, *,
                  continuous: bool) -> dict:
    """Phase 23's request checks: the ragged ``prompts`` through
    ``serve_requests`` (8 slots) and, with ``continuous``, the continuous
    engine (8 slots, chunks of 8), each request held to its prompt served
    alone (``serve_requests`` with one slot: batch 1, one request a
    round)."""
    import torch
    from repro_torch.runtime import serving

    n = len(prompts)
    mat, lens = serving.pad_prompts(prompts)
    t0 = time.perf_counter()
    served = serving.serve_requests(step, make_cache, mat, lens,
                                    tokens=tokens, slots=8)
    solo = serving.serve_requests(step, make_cache, mat, lens,
                                  tokens=tokens, slots=1, warm=False)
    out = {"requests": n, "seconds": served[1], "rounds":
           served.report.rounds, "sustained_tok_s": serving.decode_tok_s(
               tokens, n, served[1]),
           "differ_from_alone": [i for i in range(n) if not torch.equal(
               served[0][i], solo[0][i])]}
    check(served.report.ok and solo.report.ok and
          served.report.completed == list(range(n)),
          f"requests: dispositions {served.report.dispositions}")
    check(not out["differ_from_alone"], f"requests "
          f"{out['differ_from_alone']} differ from serving them alone")
    if continuous:
        cont = serving.serve_continuous(step, make_cache, mat, lens,
                                        tokens=tokens, slots=8, chunk=8)
        out["continuous"] = {
            "seconds": cont[1], "admitted": cont.report.admitted,
            "sustained_tok_s": serving.decode_tok_s(tokens, n, cont[1]),
            "differ_from_alone": [i for i in range(n) if not torch.equal(
                cont[0][i], solo[0][i])]}
        check(cont.report.ok and cont.report.admitted == n,
              f"continuous: dispositions {cont.report.dispositions}")
        check(not out["continuous"]["differ_from_alone"], "continuous "
              f"requests {out['continuous']['differ_from_alone']} differ "
              "from serving them alone")
    out["wall_s"] = time.perf_counter() - t0
    return out


def cpu_copy(graph):
    """The CPU port of a lowered graph: every tensor copied to the host."""
    from repro_torch.tree import tree_map
    from repro_torch.runtime import ir
    return ir.bind_params(graph, tree_map(lambda t: t.cpu(),
                                           ir.graph_params(graph)))


def lm_card_vs_cpu(graph, fed, moe: bool) -> dict:
    """Teacher-forced logits of ``fed`` through the lowered ``graph`` on
    the card (eager) and on the CPU port (:func:`cpu_copy`).  For MoE the
    routing of both runs is recorded: the choices and keep flags that
    differ, the card's smallest top-k margin and dropped pairs; where any
    choice differs the CPU run is repeated on the card's routing
    (``route``'s test hook) and that run is held."""
    import contextlib

    from repro_torch import runtime

    B = fed.shape[0]
    S = fed.shape[1]
    def step(c, t):
        return runtime.decode_step(graph, c, {"tokens": t})
    with RouteLog() if moe else contextlib.nullcontext() as card_log:
        lg = forced_logits(step, runtime.init_cache(graph, B, S + 1), fed)
    t0 = time.perf_counter()
    cpu = cpu_copy(graph)

    def cpu_step(c, t):
        return runtime.decode_step(cpu, c, {"tokens": t})
    with RouteLog() if moe else contextlib.nullcontext() as cpu_log:
        lg_cpu = forced_logits(cpu_step, runtime.init_cache(cpu, B, S + 1),
                               fed.cpu())
    out = {"free_running": step_rel(lg, lg_cpu)}
    if moe:
        flips, keeps = routing_diff(card_log.calls, cpu_log.calls)
        out.update(choices_differ=flips, keeps_differ=keeps,
                   min_margin=min(c["margin"] for c in card_log.calls),
                   route_calls=len(card_log.calls),
                   dropped_per_step=card_log.dropped() / S)
        if flips or keeps:
            with RouteLog(forced=card_log.calls):
                lg_cpu = forced_logits(cpu_step,
                                       runtime.init_cache(cpu, B, S + 1),
                                       fed.cpu())
            out["forced"] = step_rel(lg, lg_cpu)
    out["vs_cpu"] = out.get("forced", out["free_running"])
    out["cpu_s"] = time.perf_counter() - t0
    out["logits"] = lg
    return out


def lm_family(dev, label, host, budget, *, moe=False,
              continuous=False, bitwise=False) -> tuple[dict, dict]:
    """(a) / (b) of phase 23: ``host`` compressed on card-timed tables at
    ``budget`` with ``method="layermerge"`` (its sublayers are all
    prune-or-keep: with no linearizable sublayer the depth baseline keeps
    every layer and meets no budget under 1), lowered in memory (phase
    16 writes and reads a gigabytes artifact on the card, and the CPU
    tests round-trip these kinds' artifacts; here that I/O would cost
    tens of seconds a model),
    the plan and the original served through the captured ``serve_loop``
    beside ``serve_loop_pertoken`` (8 seeded 16-token prompts, 32 greedy
    tokens), the served logits teacher-forced on the card against the
    CPU port and the captured step's, the prefill against
    ``replaced_apply``, then the ragged requests.  MoE requests run at
    ``MOE_NO_DROP``.  Returns (numbers, launches)."""
    import dataclasses

    import torch
    from repro_torch import kernels, runtime
    from repro_torch.models import transformer as T
    from repro_torch.runtime import serving
    from repro_torch.runtime.artifact import flatten_tree

    before = kernels.launch_counts()
    cfg = host.cfg
    out = {"parameters": sum(t.numel()
                             for t in flatten_tree(host.params).values())}
    res, out["compress"] = card_compress(host, (budget,), False,
                                         method="layermerge")
    graph = res.lower()
    out["units"] = runtime.count_units(graph)
    t0 = time.perf_counter()
    B, P, N = 8, 16, 32
    prompt = serving.random_prompts(13, B, P, cfg.vocab_size, device=dev)

    def c_step(c, t):
        return runtime.decode_step(graph, c, {"tokens": t})

    def c_cache(b, s):
        return runtime.init_cache(graph, b, s)

    def o_step(c, t):
        return T.decode_step(cfg, host.params, c, {"tokens": t})
    _, _, c_logits, seqs, c_serve = serve_both(
        f"{label} compressed", c_step, lambda: c_cache(B, P + N), prompt, N)
    _, _, _, _, o_serve = serve_both(
        f"{label} original", o_step,
        lambda: T.init_cache(cfg, B, P + N, device=dev), prompt, N)
    out["serve"] = {
        "compressed": c_serve, "original": o_serve, "batch": B,
        "decode_step_ms": {"compressed": c_serve["decode_ms"] / (N - 1),
                           "original": o_serve["decode_ms"] / (N - 1)},
        "tok_s": {"compressed": c_serve["tok_s"],
                  "original": o_serve["tok_s"]},
        "busy_share": {"compressed": c_serve["busy_share"],
                       "original": o_serve["busy_share"]}}
    fed = torch.cat([prompt, seqs[:, :-1]], dim=1)
    held_ = lm_card_vs_cpu(graph, fed, moe)
    lg = held_.pop("logits")
    check(bool(torch.isfinite(lg).all()), f"{label}: non-finite logits")
    check(bool((lg[:, P - 1:].argmax(-1) == seqs).all()),
          f"{label}: served ids are not the argmax of the forced logits")
    cap = captured_logits(c_step, lambda: c_cache(B, P + N), fed)
    held_["captured_bitwise"] = bool(torch.equal(cap, lg))
    held_["captured_vs_eager"] = step_rel(cap, lg)
    y_merged = runtime.execute(graph, {"tokens": prompt}, device=dev)
    fn, p = host.replaced_apply(res.plan)
    held_["vs_replaced"] = rel_diff(y_merged, fn(p, {"tokens": prompt}))
    check(tuple(y_merged.shape) == (B, P, cfg.vocab_size),
          f"{label}: prefill logits {tuple(y_merged.shape)}")
    out["held"] = held_
    out["serve"]["seconds"] = time.perf_counter() - t0
    check(held_["vs_cpu"] <= NET_RTOL, f"{label}: card vs CPU port "
          f"differ by {held_['vs_cpu']}")
    check(held_["vs_replaced"] <= NET_RTOL, f"{label}: merged vs replaced "
          f"differ by {held_['vs_replaced']}")
    if bitwise:
        check(held_["captured_bitwise"], f"{label}: the captured decode "
              f"differs from the eager one by {held_['captured_vs_eager']}")
    gr, mk = graph, c_cache
    if moe:   # requests at the factor where nothing drops
        gr = dataclasses.replace(graph, meta=dict(
            graph.meta, config=dataclasses.replace(
                cfg, capacity_factor=MOE_NO_DROP)))

        def mk(b, s, gr=gr):
            return runtime.init_cache(gr, b, s)

    def r_step(c, t, gr=gr):
        return runtime.decode_step(gr, c, {"tokens": t})
    prompts = serving.ragged_prompts(0, 24, 4, 32, cfg.vocab_size)
    out["requests"] = solo_requests(r_step, mk, prompts, N,
                                    continuous=continuous)
    after = kernels.launch_counts()
    launches = {k: after[k] - before[k] for k in after}
    out["launches"] = launches
    log(f"archs {label}", t0, json.dumps(
        {k: out[k] for k in ("parameters", "units")}) + " compress "
        + json.dumps({k: v for k, v in out["compress"].items()
                      if k != "signature_ms"})
        + f"; signature ms {json.dumps(out['compress']['signature_ms'])}; "
        f"held {json.dumps(held_)}; serve: decode step ms "
        f"{json.dumps(out['serve']['decode_step_ms'])}, tok/s "
        f"{json.dumps(out['serve']['tok_s'])}, busy share "
        f"{json.dumps(out['serve']['busy_share'])}; requests "
        f"{json.dumps(out['requests'])}; launches {launches}")
    return out, launches


def qwen2vl_phase(dev) -> tuple[dict, dict, object]:
    """(c) of phase 23: qwen2-vl-7b at full width, ``QWEN2VL_LAYERS`` of
    its 28 layers (weights drawn on the card from seed 0), compressed on
    card-timed tables at the tightest budget from 0.6 up whose plan
    merges an FFN; 16 seeded embedding positions then 32
    teacher-forced decode steps through ``executor.decode_step`` with
    three distinct M-RoPE streams, held against the prefill forward and
    the CPU port; the decode step of the plan and of the original, each
    a captured graph.  Returns (numbers, launches, the served artifact's
    lowrank units)."""
    import dataclasses

    import torch
    from repro_torch import kernels, runtime
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.transformer_host import CostEnv, \
        TransformerHost
    from repro_torch.runtime.artifact import flatten_tree

    before = kernels.launch_counts()
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("qwen2-vl-7b"),
                              num_layers=QWEN2VL_LAYERS, dtype="float32",
                              remat=False)
    params, _ = T.init_model(cfg, torch.Generator(dev).manual_seed(0),
                             device=dev)
    host = TransformerHost(cfg, params, env=CostEnv(batch=8, seq=128),
                           device=dev)
    out = {"parameters": sum(t.numel()
                             for t in flatten_tree(params).values()),
           "init_s": time.perf_counter() - t0}
    res, out["compress"] = card_compress(host, LM_BUDGETS, True)
    graph = res.lower()
    out["units"] = runtime.count_units(graph)
    t1 = time.perf_counter()
    B, S = 8, 16 + 32
    embeds = torch.randn(B, S, cfg.d_model,
                         generator=torch.Generator().manual_seed(17)) * 0.3
    batch = {"embeds": embeds, "mrope_positions": mrope_streams(B, S)}
    card = {k: v.to(dev) for k, v in batch.items()}

    def at(b, t):
        return {"embeds": b["embeds"][:, t:t + 1],
                "mrope_positions": b["mrope_positions"][:, :, t:t + 1]}

    def decode_all(graph, cache, b):
        lg = []
        for t in range(S):
            y, cache = runtime.decode_step(graph, cache, at(b, t))
            lg.append(y[:, -1])
        return torch.stack(lg, dim=1)
    dec = decode_all(graph, runtime.init_cache(graph, B, S), card)
    y = runtime.execute(graph, card, device=dev)
    fn, p = host.replaced_apply(res.plan)
    held_ = {"vs_prefill": step_rel(dec, y),
             "vs_replaced": rel_diff(y, fn(p, card))}
    check(tuple(y.shape) == (B, S, cfg.vocab_size)
          and bool(torch.isfinite(dec).all()),
          f"qwen2-vl: logits {tuple(y.shape)}")
    # the CPU port on the first CPU_ROWS rows (decode is row-wise; the
    # host's time goes to streaming the weights, not to the rows)
    t_cpu = time.perf_counter()
    cpu = cpu_copy(graph)
    rows = {k: v[:, :CPU_ROWS] if k == "mrope_positions" else v[:CPU_ROWS]
            for k, v in batch.items()}
    held_["vs_cpu"] = step_rel(dec[:CPU_ROWS], decode_all(
        cpu, runtime.init_cache(cpu, CPU_ROWS, S), rows))
    held_["cpu_s"] = time.perf_counter() - t_cpu
    del cpu
    for k in ("vs_prefill", "vs_replaced", "vs_cpu"):
        check(held_[k] <= NET_RTOL, f"qwen2-vl: {k} {held_[k]}")
    out["held"] = held_
    # a decode step of each model, captured: its device time and busy share
    one = at(card, 0)
    c_cache = runtime.init_cache(graph, B, S)
    o_cache = T.init_cache(cfg, B, S, device=dev)
    steps = {
        "compressed": graph_step_stats(
            lambda: runtime.decode_step(graph, c_cache, one)),
        "original": graph_step_stats(
            lambda: T.decode_step(cfg, params, o_cache, one))}
    for v in steps.values():
        v["tok_s"] = B / (v["ms"] * 1e-3)
    out["decode_step"] = steps
    out["serve_s"] = time.perf_counter() - t1
    after = kernels.launch_counts()
    launches = {k: after[k] - before[k] for k in after}
    out["launches"] = launches
    log("archs qwen2-vl", t0, json.dumps(
        {k: out[k] for k in ("parameters", "units", "init_s")})
        + " compress " + json.dumps(
            {k: v for k, v in out["compress"].items()
             if k != "signature_ms"})
        + f"; signature ms {json.dumps(out['compress']['signature_ms'])}"
        f"; held {json.dumps(held_)}; decode step "
        + json.dumps({k: {f: v[f] for f in ("ms", "tok_s", "busy_share")}
                      for k, v in steps.items()})
        + f"; launches {launches}")
    units = [u for u in graph.units if u.kind == "lowrank"]
    del host, params
    return out, launches, units


def time_kernel_rows(dev, norms, attentions, ffn_unit, ffn_ms,
                     seed: int) -> list:
    """rmsnorm at each (M, D) of ``norms``, flash_attention at each (B, S,
    H, KVH, D) of ``attentions`` (causal), merged_ffn with ``ffn_unit``'s
    factors at each M of ``ffn_ms``: kernel, plain version and library
    call (``F.rms_norm``; SDPA on k, v expanded; ``torch.addmm``) as
    cold-L2 device times beside the bound, each held against its plain
    version first."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.kernels import ops, ref
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    rows = []
    for m, d in norms:
        x, w = rnd(m, d), rnd(d) * 0.2
        w1 = 1.0 + w
        yr = ref.rmsnorm_ref(x, w, 1e-6)
        err = held("rmsnorm", kernels.rmsnorm_op(x, w, eps=1e-6), yr,
                   yr.abs(), f"x={(m, d)}")[0]
        rows.append(time_row(
            "rmsnorm", [m, d], lambda: kernels.rmsnorm_op(x, w, eps=1e-6),
            lambda: ref.rmsnorm_ref(x, w, 1e-6),
            lambda: F.rms_norm(x, (d,), w1, 1e-6), norm_bound(m, d), err))
    for b, s, h, kvh, d in attentions:
        q, k, v = rnd(b, s, h, d), rnd(b, s, kvh, d), rnd(b, s, kvh, d)
        err = compare_attention(q, k, v, True)[0]
        qt, kt, vt = (t.repeat_interleave(h // t.shape[2], dim=2)
                      .transpose(1, 2) for t in (q, k, v))
        rows.append(time_row(
            "flash_attention", [b, s, h, kvh, d],
            lambda: kernels.flash_attention_op(q, k, v, True),
            lambda: ops._attention_plain(q, k, v, True),
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True),
            attention_bound(b, s, h, kvh, d), err,
            tc_rate_label(("fp32", "fp32"))))
    u, v = (ffn_unit.params["u"], ffn_unit.params["v"]) if ffn_ms \
        else (None, None)
    for m in ffn_ms:
        r = time_ffn(rnd(m, u.shape[0]), u, v)
        rows.append(dict(r, kernel="merged_ffn", shape=[m, *u.shape]))
    for r in rows:
        r["slower_than_library"] = bool(r["library_ms"] is not None
                                        and r["ms"] > r["library_ms"])
    return rows


def kernel_rows_line(rows) -> str:
    return " ".join(
        f"{r['kernel']} {r['shape']}: ms={r['ms']:.4f} "
        f"plain={r['plain_ms']:.4f} library={r['library_ms']:.4f} "
        f"bound={r['bound_ms']:.5f} ("
        f"{'bytes' if r['bytes_ms'] >= r['flops_ms'] else 'operations'}, "
        f"share {r['bound_ms'] / r['ms']:.3f})"
        + (" SLOWER than the library;" if r["slower_than_library"] else ";")
        for r in rows)


def rows_by_kernel(rows) -> dict:
    """The ``kernels`` line's row of each kernel: its rows summed."""
    tot = {}
    for k in ("rmsnorm", "flash_attention", "merged_ffn"):
        rs = [r for r in rows if r["kernel"] == k]
        if not rs:
            continue
        tot[k] = {f: sum(r[f] for r in rs) for f in
                  ("ms", "plain_ms", "library_ms", "flops_ms", "bytes_ms",
                   "bound_ms")}
        tot[k].update(max_abs_err=max(r["max_abs_err"] for r in rs),
                      bound_rate=rs[0]["bound_rate"], shapes=len(rs))
    return tot


def time_arch_kernels(dev, lowrank) -> list:
    """Phase 23 (d): rmsnorm at (M, D) for D of granite, xLSTM and
    qwen2-vl and M 1024 (the probes) and 8 (a decode step);
    flash_attention at ``ARCH_ATTENTION``; merged_ffn at D 3584 with the
    served qwen2-vl unit at M 8 and 1024 (:func:`time_kernel_rows`)."""
    return time_kernel_rows(dev, [(m, d) for d in ARCH_NORM_D
                                  for m in (1024, 8)],
                            ARCH_ATTENTION, lowrank[0], (8, 1024), 23)


def arch_phase(dev, build_host) -> tuple[dict, dict, dict]:
    """Phase 23: granite-moe-1b-a400m at full width (``ARCH_GRANITE_LAYERS``
    of 24 layers), xlstm-125m at full size and qwen2-vl-7b at full width
    (4 of 28 layers), fp32, weights from seed
    0, each compressed on card-timed tables, served and held against the
    CPU port; then (d), the kernels at the new shapes.  Returns (the
    numbers, launches over (a)-(c) counted from zero, the ``kernels``
    line's ``@archs`` rows: each kernel's (d) rows summed)."""
    import gc

    import torch
    from repro_torch import kernels

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = {}
    # (a) granite-moe-1b-a400m: ARCH_GRANITE_LAYERS of its 24 layers, d
    # 1024, 16/8 heads of 64, 32 experts top-8 of moe_dff 512, vocab
    # 49155, tied; costed and probed at batch 8 x seq 128; its weights
    # drawn on the card (the host draw took 12-17 s)
    t = time.perf_counter()
    host, _ = card_lm_host("granite-moe-1b-a400m", dev, batch=8, seq=128,
                           layers=ARCH_GRANITE_LAYERS)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    out["granite"], la = lm_family(dev, "granite", host, 0.6, moe=True)
    out["granite"]["init_s"] = init_s
    del host
    gc.collect()
    torch.cuda.empty_cache()
    # (b) xlstm-125m: 12 layers (sLSTM at 3 and 9), d 768, 4 heads of 192,
    # vocab 50304, tied
    t = time.perf_counter()
    host, _ = build_host("xlstm-125m", seed=0, batch=8, seq=128,
                         full=True, device="cuda")
    init_s = time.perf_counter() - t
    out["xlstm"], lb = lm_family(dev, "xlstm", host, 0.6, continuous=True,
                                 bitwise=True)
    out["xlstm"]["init_s"] = init_s
    del host
    gc.collect()
    torch.cuda.empty_cache()
    # (c) qwen2-vl-7b, QWEN2VL_LAYERS layers
    out["qwen2vl"], lc, lowrank = qwen2vl_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    launches = kernels.launch_counts()
    for k, part in (("rmsnorm", (la, lb, lc)), ("flash_attention", (la, lc)),
                    ("merged_ffn", (lc,))):
        check(all(x[k] > 0 for x in part), f"phase 23: {k} never launched "
              f"in one of its models ({[x[k] for x in part]})")
    # (d) the kernels at the new shapes
    t = time.perf_counter()
    rows = time_arch_kernels(dev, lowrank)
    out["kernels"] = rows
    log("archs kernels", t, kernel_rows_line(rows))
    tot = rows_by_kernel(rows)
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    log("archs", t0, f"phase 23 in {out['seconds']:.2f}s; launches "
        f"(a)-(c) {launches}")
    return out, launches, tot


# ---------------------------------------------------------------------------
# 24. LM training
# ---------------------------------------------------------------------------

class CkptSpy:
    """While active, wraps ``checkpoint.ckpt.save`` (the background write of
    every ``AsyncCheckpointer`` save: its seconds, and the host arrays of
    the save at ``watch_step``) and ``restore`` (each restored tree is
    held bitwise against those arrays as it comes back, before a step
    writes it in place)."""

    def __init__(self, watch_step: int):
        self.watch_step = watch_step
        self.write_s, self.restored = [], []
        self.saved = None

    def __enter__(self):
        from repro_torch.checkpoint import ckpt as C
        from repro_torch.tree import flatten_tree
        self.C, self._save, self._restore = C, C.save, C.restore

        def save(ckpt_dir, step, tree, **kw):
            t = time.perf_counter()
            out = self._save(ckpt_dir, step, tree, **kw)
            self.write_s.append(time.perf_counter() - t)
            if step == self.watch_step:
                self.saved = flatten_tree(tree)
            return out

        def restore(ckpt_dir, step, like, **kw):
            out = self._restore(ckpt_dir, step, like, **kw)
            flat = flatten_tree(out)
            same = (step == self.watch_step and self.saved is not None
                    and sorted(flat) == sorted(self.saved)
                    and all(v.cpu().numpy().tobytes()
                            == self.saved[k].tobytes()
                            for k, v in flat.items()))
            self.restored.append({"step": step, "leaves": len(flat),
                                  "bitwise": same})
            return out
        C.save, C.restore = save, restore
        return self

    def __exit__(self, *exc):
        self.C.save, self.C.restore = self._save, self._restore


def grads_vs_cpu(cfg, params_cpu, batch_np, dev, forward_fn=None, *,
                 loss_rtol: float = 1e-5, grad_rtol: float = 1e-4) -> dict:
    """One ``make_loss_fn`` value and its gradients on the card against the
    CPU port, from the same weights and batch: the loss's relative
    difference (at most ``loss_rtol``), and each gradient leaf's max |Δ|
    over its max |g| (at most ``grad_rtol``), in fp32."""
    import torch
    from repro_torch.train.step import make_loss_fn, value_and_grad
    from repro_torch.tree import flatten_tree, tree_map
    b_cpu = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    l_cpu, g_cpu = value_and_grad(make_loss_fn(cfg, forward_fn), params_cpu,
                                  b_cpu)
    p_dev = tree_map(lambda t: t.to(dev), params_cpu)
    l_dev, g_dev = value_and_grad(make_loss_fn(cfg, forward_fn), p_dev,
                                  {k: v.to(dev) for k, v in b_cpu.items()})
    gd = flatten_tree(g_dev)
    worst, worst_key = 0.0, None
    for k, v in flatten_tree(g_cpu).items():
        v = v.float()
        r = float((gd[k].cpu().float() - v).abs().max()
                  / max(float(v.abs().max()), 1e-30))
        if r >= worst:
            worst, worst_key = r, k
    out = {"loss_cpu": float(l_cpu), "loss_card": float(l_dev),
           "loss_rel": abs(float(l_dev) - float(l_cpu)) / abs(float(l_cpu)),
           "grad_rel": worst, "grad_rel_leaf": worst_key,
           "leaves": len(gd)}
    check(out["loss_rel"] <= loss_rtol, f"loss on the card vs the CPU "
          f"port: {out['loss_rel']:.3g} relative (limit {loss_rtol})")
    check(worst <= grad_rtol, f"gradient {worst_key} on the card vs the CPU "
          f"port: {worst:.3g} of its max |g| (limit {grad_rtol})")
    return out


def nondeterministic_leaves(step_grads, params, batch) -> list:
    """Gradient leaves that differ bitwise between two runs of one loss
    and gradient on the same params and batch."""
    import torch
    from repro_torch.tree import flatten_tree
    a = flatten_tree(step_grads(params, batch)[1])
    b = flatten_tree(step_grads(params, batch)[1])
    return [k for k in a if not torch.equal(a[k], b[k])]


def launch_delta(fn) -> dict:
    """The kernel launches ``fn()`` makes (counted without a reset, so a
    phase's running totals keep them)."""
    import torch
    from repro_torch import kernels
    before = kernels.launch_counts()
    fn()
    torch.cuda.synchronize()
    return {k: v - before.get(k, 0)
            for k, v in kernels.launch_counts().items()}


#: PyTorch's small ops in a profile, by what the kernel's name holds:
#: ``[launches, µs, launches of its busiest name]`` of each kind a call
#: (:func:`step_busy`).
SMALL_OPS = (("vectorized_elementwise", "vectorized_elementwise_kernel"),
             ("elementwise", "elementwise_kernel"),
             ("memcpy_dtod", "Memcpy DtoD"))
#: Phase 24 (c)'s step while the scan's gradient was autograd of its plain
#: loop (no backward kernel), on an H100 80GB HBM3 at 700 W: the busiest
#: kernel name of each small-op kind (launches, device ms a step; the
#: totals over names were not taken) and the peak memory in GiB.
PLAIN_GRAD_STEP = {"vectorized_elementwise": (8388, 97.5),
                   "elementwise": (5547, 33.7), "memcpy_dtod": (2900, 30.3),
                   "peak_gib": 58.49}


def step_busy(fn, step_ms: float, reps: int) -> dict:
    """Device-busy share of ``reps`` calls of ``fn`` (torch.profiler): the
    device time a call over ``step_ms``, the top kernels, and the launches
    and µs a call of PyTorch's elementwise kernels and device-to-device
    copies (``small_ops``)."""
    busy_us, rows = device_kernels(fn, reps=reps)
    small = {k: [0, 0.0, 0] for k, _ in SMALL_OPS}
    for us, n, name in rows:
        kind = next((k for k, key in SMALL_OPS if key in name), None)
        if kind is not None:
            small[kind][0] += n
            small[kind][1] += us
            small[kind][2] = max(small[kind][2], n)
    return {"busy_us": busy_us, "busy_share": busy_us / (step_ms * 1e3),
            "top": [(name[:60], round(us, 1), n) for us, n, name in rows[:8]],
            "small_ops": small}


def smollm_train(dev) -> dict:
    """Phase 24 (a): SmolLM-135M full size, fp32, batch 8 x seq 1024,
    ``examples/train_lm.py``'s "100m" preset under ``train_loop`` (40
    steps, checkpoints every 10, keep 3) with one simulated device loss
    at step 25."""
    import dataclasses
    import shutil
    import statistics

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import GlobalBatcher, SyntheticTokens
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import LoopConfig, train_loop
    from repro_torch.train.step import (make_loss_fn, make_train_step,
                                        value_and_grad)
    from repro_torch.tree import tree_leaves, tree_map

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("smollm-135m"), dtype="float32",
                              remat=False, num_layers=TRAIN_LAYERS)
    p_cpu, _ = T.init_model(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    params = tree_map(lambda t: t.to(dev), p_cpu)
    n_params = sum(t.numel() for t in tree_leaves(params))
    B, S = TRAIN_BATCH
    batcher = GlobalBatcher(SyntheticTokens(cfg.vocab_size, B, S, seed=0),
                            device=dev)
    opt = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=40,
                      weight_decay=0.01)
    ckpt_dir = os.path.join(WORK, "train_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    loop = LoopConfig(total_steps=40, ckpt_every=10, keep=3,
                      ckpt_dir=ckpt_dir, log_every=10)
    calls, fired = [], []

    def hook(step):
        torch.cuda.synchronize()
        calls.append((step, time.perf_counter()))
        if step == 25 and not fired:
            fired.append(step)
            raise RuntimeError("simulated device loss at step 25")

    logs = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with CkptSpy(20) as spy:
        res = train_loop(cfg, opt, loop, params, batcher, failure_hook=hook,
                         logger=logs.append)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    # step intervals: hook to next hook, the same run; a step whose end
    # saves a checkpoint apart
    plain, with_ckpt = [], []
    for (s0, a), (s1, b) in zip(calls, calls[1:]):
        if s1 == s0 + 1:
            (with_ckpt if s1 % loop.ckpt_every == 0 else plain).append(b - a)
    step_ms = statistics.median(plain[1:]) * 1e3
    losses = res.losses
    replay = [abs(a - b) for a, b in zip(losses[20:25], losses[25:30])]
    out = {"params": n_params, "batch": [B, S], "loop_s": loop_s,
           "steps_run": len(losses), "restarts": res.restarts,
           "final_step": res.final_step, "losses": losses,
           "step_ms": step_ms, "tok_s": B * S / (step_ms * 1e-3),
           "step_ms_all": [x * 1e3 for x in plain],
           "ckpt_step_ms": [x * 1e3 for x in with_ckpt],
           "ckpt_write_s": spy.write_s, "restored": spy.restored,
           "peak_bytes": peak, "first5": statistics.mean(losses[:5]),
           "last5": statistics.mean(losses[-5:]),
           "replay_max_abs": max(replay), "log": logs}
    check(res.restarts == 1 and res.final_step == 40, f"smollm train: "
          f"{res.restarts} restarts, final step {res.final_step}")
    check(len(losses) == 45 and all(math.isfinite(x) for x in losses),
          "smollm train: losses missing or not finite")
    check(out["last5"] < out["first5"], f"smollm train: the loss did not "
          f"drop ({out['first5']:.4f} -> {out['last5']:.4f})")
    check([r["step"] for r in spy.restored] == [20]
          and spy.restored[0]["bitwise"], f"smollm train: the restored "
          f"state is not bitwise what step 20 saved ({spy.restored})")
    # what makes the replay differ, if it does: the gradient leaves that
    # differ between two runs of one step's gradient
    loss_fn = make_loss_fn(cfg)
    b0 = batcher(0)
    out["nondeterministic_grads"] = nondeterministic_leaves(
        lambda p, b: value_and_grad(loss_fn, p, b), res.params, b0)
    # launches of one step (the forward's kernels; the backward runs the
    # plain versions' gradients) against one forward
    step = make_train_step(cfg, opt)
    p, state = res.params, res.opt_state
    out["launches_per_step"] = launch_delta(lambda: step(p, state, b0))
    with torch.no_grad():
        out["launches_per_forward"] = launch_delta(
            lambda: T.forward(cfg, p, b0))
    out["busy"] = step_busy(lambda: step(p, state, b0), step_ms, 3)
    # card against the CPU port: one loss and its gradients, 1 x 256
    out["vs_cpu"] = grads_vs_cpu(cfg, p_cpu, SyntheticTokens(
        cfg.vocab_size, 1, 256, seed=0).batch_at(0), dev)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    check(out["launches_per_step"] == out["launches_per_forward"],
          f"smollm train: a step launched {out['launches_per_step']}, a "
          f"forward {out['launches_per_forward']}")
    lp = out["launches_per_forward"]
    L = cfg.num_layers
    check((lp["rmsnorm"], lp["flash_attention"]) == (2 * L + 1, L),
          f"smollm train: a forward of {L} layers launched {lp}")
    out["layers"] = L
    log("train smollm", t0, f"{L} of 30 layers, "
        f"{n_params / 1e6:.2f}M params, {B}x{S}, 40 "
        f"steps + {len(losses) - 40} replayed, restarts {res.restarts}; "
        f"step {step_ms:.2f} ms median ({out['tok_s']:.0f} tok/s), steps "
        f"with a checkpoint {[round(x, 1) for x in out['ckpt_step_ms']]} "
        f"ms, background writes {[round(x, 2) for x in spy.write_s]} s; "
        f"loss first 5 {out['first5']:.4f} -> last 5 {out['last5']:.4f}; "
        f"restored step 20 bitwise {spy.restored[0]['bitwise']} "
        f"({spy.restored[0]['leaves']} leaves); replayed steps 20-24 max "
        f"|dloss| {out['replay_max_abs']:.3g}, gradient leaves that differ "
        f"run to run {out['nondeterministic_grads']}; peak "
        f"{peak / 2**30:.2f} GiB; launches per step "
        f"{json.dumps(out['launches_per_step'])}; busy "
        f"{out['busy']['busy_share']:.3f} ({out['busy']['top'][:4]}); vs "
        f"CPU port (1x256) loss {out['vs_cpu']['loss_rel']:.3g}, gradients "
        f"{out['vs_cpu']['grad_rel']:.3g} ({out['vs_cpu']['grad_rel_leaf']})")
    return out


def compressed_finetune(dev, lm_path) -> tuple[dict, object]:
    """Phase 24 (b): phase 8's SmolLM-135M artifact fine-tuned 10 steps at
    batch 8 x seq 1024 through its unit graph, saved, reloaded (logits
    bitwise), and served through the captured ``serve_loop`` (the eager
    decode's tokens).  Returns the numbers and a lowrank unit."""
    import statistics

    import torch
    from repro_torch import runtime
    from repro_torch.data.pipeline import GlobalBatcher, SyntheticTokens
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.runtime import executor, serving
    from repro_torch.train.step import make_compressed_forward, \
        make_train_step
    from repro_torch.tree import tree_leaves

    t0 = time.perf_counter()
    art = runtime.load(lm_path, device=dev)
    graph = art.graph
    cfg = graph.meta["config"]
    gp = runtime.graph_params(graph)
    fwd = make_compressed_forward(graph, device=dev)
    B, S = TRAIN_BATCH
    batcher = GlobalBatcher(SyntheticTokens(cfg.vocab_size, B, S, seed=0),
                            device=dev)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1,
                                            total_steps=10), forward_fn=fwd)
    state = init_opt_state(gp)
    b0 = batcher(0)
    with torch.no_grad():
        per_forward = launch_delta(lambda: fwd(gp, b0))
    losses, times = [], []
    for i in range(10):
        t = time.perf_counter()
        gp, state, m = step(gp, state, batcher(i))
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t)
    step_ms = statistics.median(times[1:]) * 1e3
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"compressed fine-tune: losses {losses}")
    busy = step_busy(lambda: step(gp, state, b0), step_ms, 3)
    tuned = runtime.bind_params(graph, gp)
    path = os.path.join(WORK, "smollm135m_tuned.npz")
    t = time.perf_counter()
    runtime.save(path, tuned, plan=art.plan,
                 meta=dict(art.meta, finetune_steps=10))
    save_s = time.perf_counter() - t
    t = time.perf_counter()
    again = runtime.load(path, device=dev)
    load_s = time.perf_counter() - t
    with torch.no_grad():
        y_mem = runtime.execute(tuned, b0, device=dev)
        y_disk = again.apply(b0)
    bitwise = bool(torch.equal(y_mem, y_disk))
    del y_mem, y_disk
    check(bitwise, "compressed fine-tune: the reloaded artifact's logits "
          "differ from the tuned graph's")
    P, N = 16, 32
    prompt = serving.random_prompts(7, B, P, cfg.vocab_size, device=dev)
    with torch.no_grad():
        pre, dec, _, seqs = serving.serve_loop(
            lambda c, tok: again.decode(c, tok),
            lambda: again.init_cache(B, P + N), prompt, N)
        _, _, _, seqs_eager = serving.serve_loop_pertoken(
            lambda c, tok: executor.decode_step(tuned, c, {"tokens": tok}),
            lambda: executor.init_cache(tuned, B, P + N), prompt, N)
    same = bool(torch.equal(seqs, seqs_eager))
    check(same, "compressed fine-tune: the captured decode of the reloaded "
          "artifact and the eager decode of the tuned graph differ")
    out = {"units": json.loads(unit_census(graph)), "losses": losses,
           "step_ms": step_ms, "tok_s": B * S / (step_ms * 1e-3),
           "launches_per_forward": per_forward, "busy": busy,
           "param_leaves": len(tree_leaves(gp)), "save_s": save_s,
           "load_s": load_s, "artifact_bytes": os.path.getsize(path),
           "logits_bitwise": bitwise, "decode_tokens_equal": same,
           "decode_tok_s": serving.decode_tok_s(N - 1, B, dec),
           "seconds": time.perf_counter() - t0}
    os.remove(path)
    log("train compressed", t0, f"units {out['units']}; 10 steps at "
        f"{B}x{S}: {step_ms:.2f} ms a step ({out['tok_s']:.0f} tok/s), "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; {out['param_leaves']} "
        f"param leaves; busy {busy['busy_share']:.3f} ({busy['top'][:4]}); "
        f"launches per forward {json.dumps(per_forward)}; artifact "
        f"{out['artifact_bytes'] / 2**20:.1f} MiB saved {save_s:.2f} s, "
        f"loaded {load_s:.2f} s, logits bitwise {bitwise}; captured decode "
        f"of the reload = eager decode of the tuned graph: {same} "
        f"({out['decode_tok_s']:.1f} tok/s)")
    check(per_forward["merged_ffn"] > 0, "compressed fine-tune: merged_ffn "
          "never launched")
    unit = next(u for u in tuned.units if u.kind == "lowrank")
    return out, unit


def rg_train(dev) -> dict:
    """Phase 24 (c): RecurrentGemma-2B full size, fp32 (weights drawn on
    the card), batch 8 x seq 128: 4 steps of ``make_train_step`` (no
    loop, no checkpoint); then the card
    against the CPU port at full width and 3 layers on 1 x 64 tokens."""
    import dataclasses
    import gc
    import statistics

    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import GlobalBatcher, SyntheticTokens
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_leaves

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("recurrentgemma-2b"),
                              dtype="float32", remat=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params, _ = T.init_model(cfg, torch.Generator(dev).manual_seed(0),
                             device=dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    init_s = time.perf_counter() - t0
    B, S = 8, 128
    batcher = GlobalBatcher(SyntheticTokens(cfg.vocab_size, B, S, seed=0),
                            device=dev)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1,
                                            total_steps=4,
                                            weight_decay=0.01))
    state = init_opt_state(params)
    losses, times = [], []
    for i in range(4):
        before = kernels.launch_counts()
        t = time.perf_counter()
        params, state, m = step(params, state, batcher(i))
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t)
        if i == 0:
            per_step = {k: v - before[k]
                        for k, v in kernels.launch_counts().items()}
    step_ms = statistics.median(times[1:]) * 1e3
    b0 = batcher(0)
    busy = step_busy(lambda: step(params, state, b0), step_ms, 1)
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses), f"recurrentgemma train: "
          f"losses {losses}")
    del params, state, m, step
    gc.collect()
    torch.cuda.empty_cache()
    cfg3 = dataclasses.replace(cfg, num_layers=3)
    p3, _ = T.init_model(cfg3, torch.Generator().manual_seed(0),
                         device="cpu")
    vs = grads_vs_cpu(cfg3, p3, SyntheticTokens(
        cfg.vocab_size, 1, 64, seed=0).batch_at(0), dev)
    del p3
    gc.collect()
    torch.cuda.empty_cache()
    out = {"params": n_params, "init_s": init_s, "batch": [B, S],
           "losses": losses, "step_ms": step_ms,
           "step_ms_all": [x * 1e3 for x in times],
           "tok_s": B * S / (step_ms * 1e-3), "peak_bytes": peak,
           "launches_per_step": per_step, "busy": busy, "vs_cpu": vs,
           "seconds": time.perf_counter() - t0}
    small = busy["small_ops"]
    log("train recurrentgemma", t0, f"{n_params / 1e9:.3f} B params "
        f"(init {init_s:.2f} s), {B}x{S}: step {step_ms:.1f} ms median "
        f"(all {[round(x * 1e3, 1) for x in times]}), losses "
        f"{[round(x, 4) for x in losses]}; peak {peak / 2**30:.2f} GiB "
        f"(plain-gradient step: {PLAIN_GRAD_STEP['peak_gib']}); launches "
        f"per step {json.dumps(per_step)}; busy "
        f"{busy['busy_share']:.3f} ({busy['top'][:4]}); small ops a step "
        "(launches, device ms, launches of the busiest name; the "
        "plain-gradient step's busiest name in brackets): " + ", ".join(
            f"{k} {small[k][0]}, {small[k][1] / 1e3:.1f}, {small[k][2]} "
            f"[{PLAIN_GRAD_STEP[k][0]}, {PLAIN_GRAD_STEP[k][1]} ms]"
            for k, _ in SMALL_OPS)
        + f"; vs CPU port (3 layers, 1x64) loss "
        f"{vs['loss_rel']:.3g}, gradients {vs['grad_rel']:.3g} "
        f"({vs['grad_rel_leaf']})")
    check(per_step["rglru_scan"] == 18 and per_step["flash_attention"] == 8
          and per_step["rglru_scan_bwd"] == 18,
          f"recurrentgemma train: a step launched {per_step}")
    return out


def train_phase(dev, lm_path) -> tuple[dict, dict, dict]:
    """Phase 24: (a) SmolLM-135M under the fault-tolerant loop, (b) the
    compressed SmolLM-135M artifact fine-tuned, saved and served, (c)
    RecurrentGemma-2B's train steps, (d) the kernels at the training
    shapes.  Returns (the numbers, launches over (a)-(c) counted from
    zero, the ``kernels`` line's ``@train`` rows)."""
    import gc

    import torch
    from repro_torch import kernels

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"allocated_at_start": torch.cuda.memory_allocated()}
    launches: dict = {}

    def take():
        for k, v in kernels.launch_counts().items():
            launches[k] = launches.get(k, 0) + v
        kernels.reset_launch_counts()

    kernels.reset_launch_counts()
    out["smollm"] = smollm_train(dev)
    take()
    gc.collect()
    torch.cuda.empty_cache()
    out["compressed"], unit = compressed_finetune(dev, lm_path)
    take()
    gc.collect()
    torch.cuda.empty_cache()
    out["recurrentgemma"] = rg_train(dev)
    take()
    for k in ("rmsnorm", "flash_attention", "merged_ffn", "rglru_scan",
              "rglru_scan_bwd"):
        check(launches[k] > 0, f"phase 24: {k} never launched")
    t = time.perf_counter()
    rows = time_kernel_rows(dev, [TRAIN_NORM], [TRAIN_ATTENTION], unit,
                            (TRAIN_NORM[0],), 24)
    out["kernels"] = rows
    log("train kernels", t, kernel_rows_line(rows))
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    log("train", t0, f"phase 24 in {out['seconds']:.2f}s; launches (a)-(c) "
        f"{launches}")
    return out, launches, rows_by_kernel(rows)


# ---------------------------------------------------------------------------
# 25. the distributed table build
# ---------------------------------------------------------------------------

#: Phase 25 (b): the ``dist.item`` hit at which worker 0 dies, holding the
#: lease of its 40th item (it has timed 39), and a lease that expires
#: before worker 1 reaches that item.
DIST_KILL_AT = 40
DIST_LEASE_S = 2.0
#: MobileNetV2 as phases 4 and 21 build it, as the host spec the workers
#: rebuild (``cli_host`` is the CLI's ``build_host``: the same
#: fingerprint).
DIST_HOST = {"arch": "mobilenetv2", "seed": 0, "batch": 8, "seq": 128,
             "full": False, "max_span": 6, "device": "cuda"}
DIST_CLI = ["--arch", "mobilenetv2", "--oracle", "wallclock",
            "--max-span", "6", "--budget-ratio", "0.6", "--batch", "8",
            "--workers", "2"]


def log_tails(wd: str, workers: int, n: int = 20) -> str:
    """The last ``n`` lines of each worker's log, for a failed check."""
    from repro_torch.core.dist_build import worker_log_path
    parts = []
    for w in range(workers):
        try:
            with open(worker_log_path(wd, w)) as f:
                tail = f.read().splitlines()[-n:]
        except OSError as e:
            tail = [f"(no log: {e})"]
        parts.append(f"--- worker {w} ({worker_log_path(wd, w)}) ---\n"
                     + "\n".join(tail))
    return "\n".join(parts)


def ratio_stats(num: dict, den: dict) -> dict:
    """``num[sig] / den[sig]`` over the signatures both hold: median, 5th
    and 95th percentile, extremes, and the worst (farthest from 1)."""
    import numpy as np
    sigs = sorted(set(num) & set(den))
    r = np.array([num[s] / den[s] for s in sigs])
    w = int(np.argmax(np.abs(np.log(r))))
    return {"signatures": len(sigs), "median": float(np.median(r)),
            "p5": float(np.percentile(r, 5)),
            "p95": float(np.percentile(r, 95)), "min": float(r.min()),
            "max": float(r.max()), "worst": float(r[w]),
            "worst_sig": sigs[w]}


def ratio_line(st: dict) -> str:
    return (f"median {st['median']:.4f}, p5 {st['p5']:.4f}, p95 "
            f"{st['p95']:.4f}, worst {st['worst']:.4f} "
            f"({st['worst_sig']}) over {st['signatures']} signatures")


def worker_launches(lines: dict) -> dict:
    """The kernel launches the workers' summary lines report, summed."""
    out: dict = {}
    for line in lines.values():
        for k, v in ((line or {}).get("launches") or {}).items():
            out[k] = out.get(k, 0) + v
    return out


def start_line(lines: dict) -> str:
    return "; ".join(
        f"w{w} " + ("died" if line is None else
                    f"{line['items_done']} items, ready at "
                    f"{line['start_s']['host']:.2f}s (python "
                    f"{line['start_s']['python']:.2f}, imports "
                    f"{line['start_s']['imports']:.2f}, cuda "
                    f"{line['start_s']['cuda']:.2f}), probes "
                    f"{line['run_s']:.2f}s")
        for w, line in lines.items())


def cli_summary(out: str) -> dict:
    """The JSON summary ``python -m repro_torch.compress`` prints last."""
    lines = out.splitlines()
    start = max(i for i, ln in enumerate(lines) if ln == "{")
    return json.loads("\n".join(lines[start:]))


def dist_phase(dev, ref_timings=None, ref_plan=None) -> tuple[dict, dict]:
    """Phase 25: the distributed table build on the card; ``(row,
    launches)``, the launches the workers reported.  ``ref_timings``
    (phase 21 (a)'s single-process seconds by signature) and ``ref_plan``
    (phase 4's plan at 0.6) are timed and planned here when not given."""
    import glob
    import shutil

    from repro_torch.compress import build_host
    from repro_torch.core import (AnalyticOracle, WallClockOracle,
                                  build_tables, compress, dist_build_tables,
                                  enumerate_probes, latency_work_items,
                                  table_cache)
    from repro_torch.core.dist_build import merge_shards
    from repro_torch.core.probe_engine import PROBE_QUARANTINED
    from repro_torch.testing import faults
    from repro_torch.testing.subproc import subprocess_env

    t_phase = time.perf_counter()
    root = os.path.join(WORK, "dist")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    host, _ = build_host("mobilenetv2", seed=0, batch=8, max_span=6,
                         device=dev)
    spec = {"factory": "repro_torch.testing.hosts:cli_host",
            "kwargs": DIST_HOST}
    items = latency_work_items(host)
    n = len(items)
    key = table_cache.cache_key(host, WallClockOracle(), "layermerge",
                                "magnitude")
    row: dict = {"items": n}

    # (a) the protocol under the analytic oracle, two workers at once ------
    t0 = time.perf_counter()
    single = build_tables(host, latency_oracle=AnalyticOracle())
    wa, cache_a = os.path.join(root, "wa"), os.path.join(root, "a")
    kw_a = dict(cache_dir=cache_a, workers=2, host_spec=spec,
                work_dir=wa, keep_work_dir=True, lease_s=30.0)
    t1 = time.perf_counter()
    ta, ra = dist_build_tables(host, latency_oracle=AnalyticOracle(),
                               **kw_a)
    a_s = time.perf_counter() - t1
    check(ra.dead_workers == [] and ra.items == n
          and sum(ra.completed_by.values()) == n,
          f"(a) {ra.as_dict()}\n{log_tails(wa, 2)}")
    check(ta.entries == single.entries
          and ta.num_pruned == single.num_pruned,
          "(a) the distributed analytic tables are not the single-process "
          "build's")
    t1 = time.perf_counter()
    ta2, ra2 = dist_build_tables(host, latency_oracle=AnalyticOracle(),
                                 **kw_a)
    hit_s = time.perf_counter() - t1
    check(ra2.cache_hit and not ra2.exit_codes and ra2.items == 0
          and ta2.entries == ta.entries,
          f"(a) the second call is not a cache hit that spawns no worker: "
          f"{ra2.as_dict()}")
    row["a"] = {"wall_s": a_s, "completed_by": ra.completed_by,
                "coordinator_items": ra.coordinator_items,
                "workers": ra.worker_lines, "hit_s": hit_s}
    log("dist analytic", t0, f"mobilenetv2, {n} items over 2 concurrent "
        f"workers on the card in {a_s:.2f}s, completed by "
        f"{ra.completed_by}; {start_line(ra.worker_lines)}; tables bitwise "
        f"the single-process build's; second call a cache hit in "
        f"{hit_s:.3f}s, no worker spawned")

    # (b) worker 0 killed mid-bucket, wall-clock, one worker at a time ----
    t0 = time.perf_counter()
    wb, cache_b = os.path.join(root, "wb"), os.path.join(root, "b")
    with faults.inject(faults.Fault("dist.item", "kill-worker",
                                    nth=DIST_KILL_AT, widx=0)):
        tb, rb = dist_build_tables(
            host, cache_dir=cache_b, workers=2, host_spec=spec,
            latency_oracle=WallClockOracle(), probe_config=strict_probes(),
            lease_s=DIST_LEASE_S, serial_spawn=True, work_dir=wb,
            keep_work_dir=True)
    b_s = time.perf_counter() - t0
    killed = items[DIST_KILL_AT - 1].key
    records, _events, corrupt = merge_shards(wb, ["w0", "w1", "coord"])
    check(rb.dead_workers == [0] and rb.exit_codes == {0: 17, 1: 0}
          and killed in rb.reassigned and rb.coordinator_items == 0
          and sum(rb.completed_by.values()) == n
          and rb.completed_by.get("w0") == DIST_KILL_AT - 1
          and not corrupt and not rb.repaired,
          f"(b) worker 0 was to die with exit 17 at item {DIST_KILL_AT} "
          f"({killed}) and worker 1 to steal it: {rb.as_dict()}, corrupt "
          f"{corrupt}\n{log_tails(wb, 2)}")
    w1 = rb.worker_lines.get(1) or {}
    bad = [k for k, (v, p, _) in records.items()
           if v is None or p == PROBE_QUARANTINED]
    check(not bad and w1.get("retried") == 0 and w1.get("quarantined") == 0,
          f"(b) probes retried or quarantined: worker 1 {w1}, records "
          f"{bad[:4]}\n{log_tails(wb, 2)}")
    checked = 0
    for i, j, k, _, _, seg in enumerate_probes(host):
        opts = tb.entries.get((i, j), {})
        if k in opts:
            want = records[f"latb:{host.probe_signature(seg)!r}"][0]
            check(opts[k][1] == want, f"(b) entry ({i},{j}] k={k} "
                  f"{opts[k][1]!r} is not its merged record {want!r}")
            checked += 1
    # a fresh coordinator resumes from the merged records alone
    cache_f = os.path.join(root, "fresh")
    table_cache.BuildJournal(cache_f, key).put_many(
        [(k, v, p) for k, (v, p, _) in records.items()])
    ora_f = WallClockOracle()
    tf = build_tables(host, latency_oracle=ora_f, cache_dir=cache_f,
                      probe_config=strict_probes())
    check(tf.entries == tb.entries and tf.num_pruned == tb.num_pruned
          and ora_f.num_timed == 0 and tf.stats.num_journal_hits == n,
          f"(b) the fresh resume from the merged journal differs or timed "
          f"{ora_f.num_timed} signatures ({tf.stats.num_journal_hits} "
          "journal hits)")
    b_launch = worker_launches(rb.worker_lines)
    for name in ("merged_conv", "depthwise_conv"):
        check(b_launch.get(name, 0) > 0,
              f"(b) the workers never launched {name}: {b_launch}")
    b_sec = {k[len("latb:"):]: v for k, (v, _, _) in records.items()}
    if ref_timings is None or ref_plan is None:
        ora_r = WallClockOracle()         # phase 4 / 21 (a) in one process
        ref_plan = compress(host, budget_ratio=0.6, latency_oracle=ora_r,
                            probe_config=strict_probes()).plan
        ref_timings = {repr(sg): v for sg, v in ora_r.measured.items()}
    vs_single = ratio_stats(b_sec, ref_timings)
    ora_p = WallClockOracle()
    res_b = compress(host, budget_ratio=0.6, latency_oracle=ora_p,
                     cache_dir=cache_b, probe_config=strict_probes())
    check(res_b.tables.stats.cache_hit and ora_p.num_timed == 0,
          "(b) the 0.6 plan on (b)'s tables timed again")
    pb, pr = plan_segments(res_b.plan), plan_segments(ref_plan)
    plan_diff = {"b_only": [s for s in pb if s not in pr],
                 "phase4_only": [s for s in pr if s not in pb]}
    row["b"] = {"wall_s": b_s, "report": rb.as_dict(), "killed_item": killed,
                "entries_checked": checked, "launches": b_launch,
                "vs_single": vs_single, "plan_equal": pb == pr,
                "plan_diff": plan_diff,
                "predicted_speedup": res_b.speedup}
    log("dist kill", t0, f"wall-clock, serial workers: w0 exited "
        f"{rb.exit_codes[0]} at item {DIST_KILL_AT} after "
        f"{rb.completed_by.get('w0')} items, w1 stole it and timed "
        f"{rb.completed_by.get('w1')} ({start_line(rb.worker_lines)}); "
        f"{checked} entries bitwise their merged records, a fresh resume "
        f"from them bitwise with 0 timed; workers' launches {b_launch}; "
        f"seconds / phase 21 (a)'s single-process seconds: "
        f"{ratio_line(vs_single)}; 0.6 plan (speedup "
        f"{res_b.speedup:.4f}) " + ("equal to phase 4's" if pb == pr else
                                    f"differs from phase 4's: {plan_diff}"))

    # (c) the CLI, two workers timing the card at once, twice ------------
    t0 = time.perf_counter()
    cache_c = os.path.join(root, "c")
    runs, secs = [], []
    for m in (1, 2):
        t1 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.compress", *DIST_CLI,
             "--cache-dir", cache_c, "--out",
             os.path.join(root, f"c{m}.npz")],
            env=subprocess_env(device="cuda"), cwd=ROOT,
            capture_output=True, text=True, timeout=600)
        secs.append(time.perf_counter() - t1)
        kept = glob.glob(os.path.join(cache_c, "dist_*"))
        check(r.returncode == 0, f"(c) run {m} exited {r.returncode}:\n"
              f"{r.stdout[-3000:]}{r.stderr[-3000:]}"
              + "".join(log_tails(wd, 2) for wd in kept))
        runs.append(cli_summary(r.stdout))
    c1, c2 = runs
    d1, d2 = c1["dist"], c2["dist"]
    wl = d1["worker_lines"]
    check(d1["dead_workers"] == [] and not d1["cache_hit"]
          and d1["items"] == n and sum(d1["completed_by"].values()) == n
          and c1["signatures_timed"] == 0
          and all(w and w["retried"] == 0 and w["quarantined"] == 0
                  for w in wl.values()),
          f"(c) run 1: {json.dumps(c1)}")
    timings_c = table_cache.load(cache_c, key).timings
    check(all(v is not None for v, _ in timings_c.values()),
          "(c) a quarantined signature in the CLI's tables")
    plans = [artifact_spec(os.path.join(root, f"c{m}.npz"))[0]["plan"]
             for m in (1, 2)]
    check(c2["cache_hit"] and d2["cache_hit"]
          and c2["signatures_timed"] == 0 and plans[0] == plans[1]
          and c1["original_latency_s"] == c2["original_latency_s"],
          f"(c) run 2 is not a cache hit of run 1's plan: {json.dumps(c2)}")
    vs_b = ratio_stats({s: v for s, (v, _) in timings_c.items()}, b_sec)
    c_launch = worker_launches(wl)
    pc = [[sg["i"], sg["j"], sg["k"], sg["kept"]]
          for sg in plans[0]["segments"]]
    row["c"] = {"run_s": secs, "summaries": runs, "vs_b": vs_b,
                "launches": c_launch, "plan_equal_b": pc == pb}
    log("dist cli", t0, f"python -m repro_torch.compress --workers 2: run "
        f"1 {secs[0]:.2f}s (fan-out {d1['wall_s']:.2f}s, completed by "
        f"{d1['completed_by']}; {start_line({int(w): v for w, v in wl.items()})}"
        f"), {c1['signatures_timed']} signatures timed in the coordinator, "
        f"T_orig {c1['original_latency_s']!r}; run 2 {secs[1]:.2f}s, cache "
        f"hit, {c2['signatures_timed']} timed, the same plan; seconds "
        f"timed concurrently / timed alone in (b): {ratio_line(vs_b)}; "
        f"plan " + ("equal to (b)'s" if pc == pb else "differs from (b)'s")
        + f"; workers' launches {c_launch}")
    launches = {k: b_launch.get(k, 0) + c_launch.get(k, 0)
                + worker_launches(ra.worker_lines).get(k, 0)
                for k in ("merged_conv", "depthwise_conv")}
    row["seconds"] = time.perf_counter() - t_phase
    return row, launches


# ---------------------------------------------------------------------------
# 26. the published configs at their own dtype: bf16
# ---------------------------------------------------------------------------

#: Phase 26 (a): rmsnorm (M, D) at the four configs' widths (SmolLM-135M,
#: RecurrentGemma-2B, gemma-7b, qwen2-7b) and at 8 rows (a decode step),
#: 128 (a prefill of 8 x 16) and 1024 (8 x 128), SmolLM also at the
#: training rows (8 x 1024).
BF16_NORMS = tuple((m, d) for d in (576, 2560, 3072, 3584)
                   for m in (8, 128, 1024)) + (TRAIN_NORM,)
#: flash_attention (B, S, H, KVH, D) of the four configs at S 16 and 128,
#: then SmolLM-135M's training shape.
BF16_ATTENTION = tuple((8, s, h, kvh, d) for h, kvh, d in (
    (9, 3, 64), (10, 1, 256), (16, 16, 256), (28, 4, 128))
    for s in (16, 128)) + (TRAIN_ATTENTION,)
#: Phase 26 (b): the configs served at full size in bf16, one after
#: another, each with the layers held against the CPU port at full width
#: (RecurrentGemma's 3: rglru, rglru, attn_local).
BF16_SERVE = (("smollm-135m", 2), ("recurrentgemma-2b", 3), ("gemma-7b", 2),
              ("qwen2-7b", 2))
#: bf16 card against the CPU port, both at bf16 and rounding in other
#: orders (cuBLAS and the CPU's bf16 GEMMs): max |Δ| over max |y|, the
#: tolerance of tests/test_torch_bf16.py's whole models.
BF16_NET_RTOL = 4e-2
#: A bf16 loss and its gradients, card against the CPU port: the loss
#: relative, each gradient leaf's max |Δ| over its max |g| (the tolerances
#: of tests/test_torch_bf16.py's train step).
BF16_LOSS_RTOL, BF16_GRAD_RTOL = 1e-2, 5e-2
#: The rate a bf16 kernel's operations are priced at.
BF16_RATE = f"bf16 tensor cores, {H100_FP16_FLOPS / 1e12:g} TFLOP/s"
#: Phase 26 (c): SmolLM-135M trained through the launcher.
BF16_TRAIN_STEPS = 10


def bf16_ulp(y):
    """One bf16 ulp at each |y| (2^-7 of its binade), fp32."""
    import torch
    a = y.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def held_ulp(name, y, yr, case, scale=None) -> tuple[float, float, int]:
    """Each element of bf16 ``y`` within one bf16 ulp (of the larger of the
    two) of ``yr``, its plain version — beyond, where ``scale`` is given,
    the fp32 sums' own reassociation allowance ``RTOL · scale + ATOL``
    (phase 3's): two fp32 results that differ by δ round to bf16 values at
    most δ + 1 ulp apart, and where an output cancels to near zero (a sum
    of terms of both signs) δ exceeds its own ulp.  Returns (max |Δ|, the
    most ulps apart, the elements more than one ulp apart)."""
    import torch
    torch.cuda.synchronize()
    check(y.dtype == yr.dtype == torch.bfloat16 and y.shape == yr.shape,
          f"{name} {case}: {y.dtype} {tuple(y.shape)} vs {yr.dtype} "
          f"{tuple(yr.shape)}")
    check(bool(torch.isfinite(y).all()), f"{name} {case}: non-finite output")
    err = (y.float() - yr.float()).abs()
    ulp = bf16_ulp(torch.maximum(y.float().abs(), yr.float().abs()))
    limit = ulp if scale is None else ulp + RTOL * scale.float() + ATOL
    bad = int((err > limit).sum())
    check(bad == 0, f"{name} {case}: {bad} elements beyond one bf16 ulp"
          + ("" if scale is None else " and the fp32 allowance")
          + f" of the plain version (max |Δ| {float(err.max()):.3g})")
    return (float(err.max()), float((err / ulp).max()),
            int((err > ulp).sum()))


def norm_bound_bf16(m: int, d: int) -> tuple[float, float]:
    """rmsnorm's bf16 body on (M, D): 5 FLOPs an element; x read and y
    written once, g read once, 2 bytes each."""
    return (5.0 * m * d / H100_FP32_FLOPS * 1e3,
            2.0 * (2 * m * d + d) / H100_HBM_BW * 1e3)


def attention_bound_bf16(b, s, h, kvh, d) -> tuple[float, float]:
    """flash_attention's bf16 body, causal: 4·D FLOPs a kept (query, key)
    pair at the bf16 tensor-core rate; q and o at H heads, k and v at KVH,
    2 bytes an element."""
    pairs = s * (s + 1) / 2
    return (4.0 * b * h * d * pairs / H100_FP16_FLOPS * 1e3,
            2.0 * (2 * b * s * h * d + 2 * b * s * kvh * d) / H100_HBM_BW
            * 1e3)


def bf16_kernels(dev) -> tuple[list, dict]:
    """Phase 26 (a): the bf16 bodies at ``BF16_NORMS`` and
    ``BF16_ATTENTION``: each within one bf16 ulp of its plain version
    (the attention beyond its fp32 allowance, :func:`held_ulp`; the most
    ulps and the elements beyond one reported), bitwise equal across two
    calls, and timed (kernel, plain version,
    library call, bound; cold L2; the attention also against SDPA on the
    inputs widened to fp32, ``library_fp32_ms``, the one call that keeps p
    fp32 as the kernel does); the norm's output bitwise the fp32 body's on
    the widened operands, rounded (checked: one reduction order for both
    bodies); the attention's equality to it reported (expected false: the
    bf16 body is a kernel of its own, summing in another order); the
    gradients through each op against the plain version's autograd, as
    phase 3 holds them."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.kernels import ops, ref
    g = torch.Generator().manual_seed(26)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev).bfloat16()

    rows, same_fp32, ulp_stats = [], {}, {}
    for m, d in BF16_NORMS:
        x, w = rnd(m, d, scale=3.0), rnd(d, scale=0.2)
        y = kernels.rmsnorm_op(x, w, eps=1e-6)
        err, ulps, beyond = held_ulp(
            "rmsnorm_bf16", y, ref.rmsnorm_ref(x, w, 1e-6), f"x={(m, d)}")
        ulp_stats[f"rmsnorm {(m, d)}"] = [ulps, beyond, y.numel()]
        check(torch.equal(y, kernels.rmsnorm_op(x, w, eps=1e-6)),
              f"rmsnorm_bf16 {(m, d)}: two calls differ bitwise")
        same_fp32[f"rmsnorm {(m, d)}"] = bool(torch.equal(
            y, kernels.rmsnorm_op(x.float(), w.float(), eps=1e-6)
            .bfloat16()))
        check(same_fp32[f"rmsnorm {(m, d)}"], f"rmsnorm_bf16 {(m, d)}: not "
              "bitwise the fp32 body's output on the widened operands")
        w1 = 1.0 + w
        rows.append(time_row(
            "rmsnorm_bf16", [m, d],
            lambda: kernels.rmsnorm_op(x, w, eps=1e-6),
            lambda: ref.rmsnorm_ref(x, w, 1e-6),
            lambda: F.rms_norm(x, (d,), w1, 1e-6), norm_bound_bf16(m, d),
            err))
    for b, s, h, kvh, d in BF16_ATTENTION:
        q, k, v = rnd(b, s, h, d), rnd(b, s, kvh, d), rnd(b, s, kvh, d)
        y = kernels.flash_attention_op(q, k, v, True)
        err, ulps, beyond = held_ulp(
            "flash_attention_bf16", y, ops._attention_plain(q, k, v, True),
            f"q={(b, s, h, d)} kv={kvh}",
            ops._attention_plain(q.float(), k.float(), v.float().abs(),
                                 True))
        ulp_stats[f"flash_attention {(b, s, h, kvh, d)}"] = [ulps, beyond,
                                                            y.numel()]
        check(torch.equal(y, kernels.flash_attention_op(q, k, v, True)),
              f"flash_attention_bf16 {(b, s, h, kvh, d)}: two calls differ "
              "bitwise")
        same_fp32[f"flash_attention {(b, s, h, kvh, d)}"] = bool(torch.equal(
            y, kernels.flash_attention_op(q.float(), k.float(), v.float(),
                                          True).bfloat16()))
        qt, kt, vt = (t.repeat_interleave(h // t.shape[2], dim=2)
                      .transpose(1, 2) for t in (q, k, v))
        rows.append(time_row(
            "flash_attention_bf16", [b, s, h, kvh, d],
            lambda: kernels.flash_attention_op(q, k, v, True),
            lambda: ops._attention_plain(q, k, v, True),
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True),
            attention_bound_bf16(b, s, h, kvh, d), err, BF16_RATE))
        qf, kf, vf = qt.float(), kt.float(), vt.float()
        rows[-1]["library_fp32_ms"] = kernel_time(
            lambda: F.scaled_dot_product_attention(qf, kf, vf,
                                                   is_causal=True))
    for r in rows:
        r["slower_than_library"] = bool(r["ms"] > r["library_ms"])
    # gradients through the ops (the kernel forward, the plain version's
    # gradient backward) against the plain version's autograd
    grads = {}

    def grad_case(name, kernel, op, plain, args):
        start = kernels.launch_counts()[kernel]
        sides = []
        for fn in (op, plain):
            leaves = [a.clone().requires_grad_() for a in args]
            sides.append((fn(*leaves), leaves))
        (y, leaves), (yr, ref_leaves) = sides
        check(y.grad_fn is not None and y.dtype == torch.bfloat16,
              f"{name}: the output through the kernel has no grad_fn")
        wt = rnd(*y.shape)
        got = torch.autograd.grad(y, leaves, wt)
        want = torch.autograd.grad(yr, ref_leaves, wt)
        n_launch = kernels.launch_counts()[kernel] - start
        check(n_launch == 1, f"{name}: {n_launch} launches of {kernel} (want "
              "the forward's 1)")
        for n, (a, b) in enumerate(zip(got, want)):
            res = held(f"{name} gradient", a.float(), b.float(),
                       b.float().abs().amax(), f"wrt input {n}")
            wst = grads.setdefault(name, [0.0, 0.0, 0])
            wst[0], wst[1] = max(wst[0], res[0]), max(wst[1], res[1])
            wst[2] += 1

    grad_case("rmsnorm_bf16", "rmsnorm_bf16",
              lambda x, s: kernels.rmsnorm_op(x, s),
              lambda x, s: ref.rmsnorm_ref(x, s),
              (rnd(8, 128, 576, scale=3.0), rnd(576, scale=0.2)))
    for b, s, h, kvh, d in ((8, 128, 9, 3, 64), (8, 128, 16, 16, 256)):
        grad_case("flash_attention_bf16", "flash_attention_bf16",
                  lambda q, k, v: kernels.flash_attention_op(q, k, v, True),
                  lambda q, k, v: ops._attention_plain(q, k, v, True),
                  (rnd(b, s, h, d), rnd(b, s, kvh, d), rnd(b, s, kvh, d)))
    return rows, {"same_as_fp32_body": same_fp32, "gradients": grads,
                  "ulps": ulp_stats}


def cut_layers(cfg, params, layers: int):
    """(config, params) of the first ``layers`` layers of a stacked
    params tree: views of its tensors, the embeddings and the final norm
    shared."""
    import dataclasses

    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    cfg_n = dataclasses.replace(cfg, num_layers=layers)
    out = {k: v for k, v in params.items() if k != "groups"}
    out["groups"] = [tree_map(lambda t, n=g.count: t[:n], gp)
                     for g, gp in zip(T.layer_groups(cfg_n),
                                      params["groups"])]
    return cfg_n, out


def bf16_vs_cpu(cfg, params, prompt, layers: int) -> dict:
    """The model's first ``layers`` layers at full width, the card's own
    weights copied to the host, on ``CPU_ROWS`` prompts: the prefill
    logits and every step of a decode teacher-forced through the prompt
    (its first step included), card against CPU, within
    ``BF16_NET_RTOL``."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    cfg_n, p_dev = cut_layers(cfg, params, layers)
    p_cpu = tree_map(lambda t: t.cpu(), p_dev)
    rows = prompt[:CPU_ROWS]
    P = rows.shape[1]
    out = {}
    with torch.no_grad():
        for name, p, toks, dev in (("card", p_dev, rows, rows.device),
                                   ("cpu", p_cpu, rows.cpu(), "cpu")):
            out[name] = (
                T.forward(cfg_n, p, {"tokens": toks}),
                forced_logits(
                    lambda c, t, p=p: T.decode_step(cfg_n, p, c,
                                                    {"tokens": t}),
                    T.init_cache(cfg_n, CPU_ROWS, P, device=dev), toks))
    (y, lg), (y_cpu, lg_cpu) = out["card"], out["cpu"]
    check(bool(torch.isfinite(y).all() and torch.isfinite(lg).all()),
          f"{cfg.name} bf16: non-finite logits at {layers} layers")
    res = {"layers": layers, "prefill": rel_diff(y.float(), y_cpu.float()),
           "first_step": rel_diff(lg[:, 0].float(), lg_cpu[:, 0].float()),
           "steps": step_rel(lg.float(), lg_cpu.float()),
           "seconds": time.perf_counter() - t0}
    for k in ("prefill", "first_step", "steps"):
        check(res[k] <= BF16_NET_RTOL, f"{cfg.name} bf16 at {layers} layers: "
              f"{k} card vs CPU port {res[k]:.3g} (limit {BF16_NET_RTOL})")
    return res


def bf16_serve_one(dev, arch: str, layers: int, fp32_row) -> dict:
    """One config of phase 26 (b) at full size in bf16 (weights drawn on the
    card from seed 0): 8 prompts of 16 tokens and 32 new tokens through the
    captured ``serve_loop`` and ``serve_loop_pertoken`` (the same tokens,
    finite logits), the full model's prefill forward, peak memory, the
    decode step beside its weight-read bound, and :func:`bf16_vs_cpu`."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.runtime import serving
    from repro_torch.tree import tree_leaves

    t0 = time.perf_counter()
    cfg = get_config(arch)
    check(cfg.dtype == "bfloat16", f"{arch}: published dtype {cfg.dtype}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params, _ = T.init_model(cfg, torch.Generator(dev).manual_seed(0),
                             device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree_leaves(params)
    check(all(t.dtype == torch.bfloat16 for t in leaves),
          f"{arch}: a weight is not bf16")
    n_params = sum(t.numel() for t in leaves)
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves)
    B, P, N = 8, 16, 32
    prompt = serving.random_prompts(7, B, P, cfg.vocab_size, device=dev)

    def step(c, t):
        return T.decode_step(cfg, params, c, {"tokens": t})
    pre, dec, lg, seqs, res = serve_both(
        f"{arch} bf16", step, lambda: T.init_cache(cfg, B, P + N, device=dev),
        prompt, N)
    check(tuple(seqs.shape) == (B, N) and lg.dtype == torch.bfloat16
          and bool(torch.isfinite(lg).all()),
          f"{arch} bf16: served ids {tuple(seqs.shape)}, logits {lg.dtype}")
    with torch.no_grad():
        y = T.forward(cfg, params, {"tokens": prompt})
        fwd_ms = cuda_time(lambda: T.forward(cfg, params, {"tokens": prompt}),
                           iters=5, warmup=1)
    check(bool(torch.isfinite(y).all()), f"{arch} bf16: non-finite prefill")
    peak = torch.cuda.max_memory_allocated()
    # a decode step reads every weight once, but of an untied input
    # embedding only the batch's rows
    read = weight_bytes
    if not cfg.tie_embeddings:
        read -= params["embed"].numel() * 2 - B * cfg.d_model * 2
    step_ms = res["decode_ms"] / (N - 1)
    out = dict(res, params=n_params, weight_bytes=weight_bytes,
               init_s=init_s, prefill_forward_ms=fwd_ms,
               prefill_argmax_agrees=float(
                   (y[:, -1].argmax(-1) == seqs[:, 0]).float().mean()),
               peak_bytes=peak, decode_step_ms=step_ms,
               weight_read_bound_ms=read / H100_HBM_BW * 1e3)
    out["bound_share"] = out["weight_read_bound_ms"] / step_ms
    out["vs_cpu"] = bf16_vs_cpu(cfg, params, prompt, layers)
    if fp32_row is not None:
        out["fp32_decode_ms"] = fp32_row["decode_ms"] / (N - 1)
        out["fp32_tok_s"] = fp32_row["tok_s"]
    del params, y, lg
    out["seconds"] = time.perf_counter() - t0
    log(f"bf16 serve {arch}", t0, f"{n_params / 1e9:.3f} B parameters, "
        f"{weight_bytes / 1e9:.2f} GB (drawn on the card in {init_s:.2f}s); "
        f"captured prefill {out['prefill_ms']:.3f} ms, decode "
        f"{res['decode_ms']:.3f} ms ({res['tok_s']:.1f} tok/s), a step "
        f"{step_ms:.4f} ms against its weight-read bound "
        f"{out['weight_read_bound_ms']:.4f} ms (share "
        f"{out['bound_share']:.3f})"
        + (f"; fp32 (phases 9, 16) a step {out['fp32_decode_ms']:.4f} ms, "
           f"{out['fp32_tok_s']:.1f} tok/s" if fp32_row else "")
        + f"; per-token {res['pertoken_tok_s']:.1f} tok/s; launches per "
        f"step {json.dumps(res['launches_per_step'])}; prefill forward "
        f"{fwd_ms:.3f} ms (its last argmax = the first served token on "
        f"{out['prefill_argmax_agrees']:.3f} of rows); peak "
        f"{peak / 2**30:.2f} GiB; vs CPU port at {layers} layers "
        f"{json.dumps(out['vs_cpu'])}")
    return out


def bf16_train(dev, fp32_step=None) -> dict:
    """Phase 26 (c): the full SmolLM-135M config (bf16) trained through
    ``python -m repro_torch.launch.train`` (8 x 1024, ``BF16_TRAIN_STEPS``
    steps, warmup 2): the loss of the last 5 steps under the first 5, the
    params bf16 and the moments fp32; ms a step, peak memory beside phase
    24's fp32 step; one loss and its gradients on 1 x 256 tokens against
    the CPU port at ``BF16_LOSS_RTOL`` / ``BF16_GRAD_RTOL``."""
    import shutil
    import statistics

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves

    t0 = time.perf_counter()
    ckpt = os.path.join(WORK, "bf16_ckpt")
    B, S = TRAIN_BATCH
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = launch_train.main([
        "--arch", "smollm-135m", "--steps", str(BF16_TRAIN_STEPS),
        "--warmup", "2", "--batch", str(B), "--seq", str(S),
        "--ckpt-dir", ckpt])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    shutil.rmtree(ckpt, ignore_errors=True)
    losses = res.losses
    check(len(losses) == BF16_TRAIN_STEPS
          and all(math.isfinite(x) for x in losses),
          f"bf16 train: losses {losses}")
    first5, last5 = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    check(last5 < first5, f"bf16 train: the loss did not drop ({first5:.4f}"
          f" -> {last5:.4f})")
    check(all(t.dtype == torch.bfloat16 for t in tree_leaves(res.params)),
          "bf16 train: a param is not bf16")
    check(all(t.dtype == torch.float32 for t in tree_leaves(
        [res.opt_state["mu"], res.opt_state["nu"]])),
        "bf16 train: a moment is not fp32")
    step_ms = statistics.median(res.step_s[1:]) * 1e3
    del res
    cfg = get_config("smollm-135m")
    p_cpu, _ = T.init_model(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    t_cpu = time.perf_counter()
    vs = grads_vs_cpu(cfg, p_cpu, SyntheticTokens(
        cfg.vocab_size, 1, 256, seed=0).batch_at(0), dev,
        loss_rtol=BF16_LOSS_RTOL, grad_rtol=BF16_GRAD_RTOL)
    vs["seconds"] = time.perf_counter() - t_cpu
    out = {"batch": [B, S], "losses": losses, "first5": first5,
           "last5": last5, "step_ms": step_ms,
           "tok_s": B * S / (step_ms * 1e-3), "peak_bytes": peak,
           "vs_cpu": vs, "seconds": time.perf_counter() - t0}
    fp32 = "not run"
    if fp32_step is not None:
        out.update(fp32_step_ms=fp32_step["step_ms"],
                   fp32_layers=fp32_step["layers"],
                   fp32_peak_bytes=fp32_step["peak_bytes"])
        fp32 = (f"{fp32_step['step_ms']:.2f} ms a step at "
                f"{fp32_step['layers']} layers, peak "
                f"{fp32_step['peak_bytes'] / 2**30:.2f} GiB")
    log("bf16 train", t0, f"smollm-135m bf16 through launch.train, {B}x{S}, "
        f"{BF16_TRAIN_STEPS} steps: loss first 5 {first5:.4f} -> last 5 "
        f"{last5:.4f}; step {step_ms:.2f} ms median ({out['tok_s']:.0f} "
        f"tok/s); peak {peak / 2**30:.2f} GiB; fp32 (phase 24): {fp32}; "
        f"vs CPU port (1x256, "
        f"bf16) loss {vs['loss_rel']:.3g}, gradients {vs['grad_rel']:.3g} "
        f"({vs['grad_rel_leaf']}) in {vs['seconds']:.2f}s")
    return out


def bf16_phase(dev, serve_rows=None, trn=None) -> tuple[dict, dict, dict]:
    """Phase 26: the published configs at their own dtype.  (b) SmolLM-135M,
    RecurrentGemma-2B, gemma-7b and qwen2-7b served at full size in bf16;
    (c) SmolLM-135M trained in bf16 through the launcher; the bf16 bodies'
    launches over (b)-(c), counted from zero, must be > 0 and the fp32
    bodies' of the norm and the attention 0; then (a) the bf16 bodies at
    the four configs' shapes.  Returns (numbers, launches over (b)-(c), the
    ``kernels`` line's rows of the bf16 bodies).  ``serve_rows`` (phases 9
    and 16) and ``trn`` (phase 24) give the fp32 numbers to compare with;
    without them the phase runs alone."""
    import gc

    import torch
    from repro_torch import kernels

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"serve": {}}
    kernels.reset_launch_counts()
    serve_rows = serve_rows or {}
    # phase 16 serves RecurrentGemma-2B at RG_LAYERS layers, this phase at
    # 26: only SmolLM-135M's fp32 step is the same model's
    fp32 = {"smollm-135m": serve_rows.get("smollm-135m original")}
    for arch, layers in BF16_SERVE:
        out["serve"][arch] = bf16_serve_one(dev, arch, layers,
                                            fp32.get(arch))
        gc.collect()
        torch.cuda.empty_cache()
    out["train"] = bf16_train(dev, (trn or {}).get("smollm"))
    launches = kernels.launch_counts()
    out["launches"] = launches
    for k in ("rmsnorm_bf16", "flash_attention_bf16", "rglru_scan"):
        check(launches[k] > 0, f"phase 26: {k} never launched on the bf16 "
              "path")
    check(launches["rmsnorm"] == 0 and launches["flash_attention"] == 0,
          f"phase 26: the fp32 bodies launched on the bf16 path {launches}")
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    rows, extra = bf16_kernels(dev)
    out["kernels"] = rows
    out.update(extra)
    same = extra["same_as_fp32_body"]
    log("bf16 kernels", t, kernel_rows_line(rows) + "; SDPA on the inputs "
        "widened to fp32 (p fp32, the kernel's function) " + json.dumps(
            {str(r["shape"]): r["library_fp32_ms"] for r in rows
             if "library_fp32_ms" in r}) + "; most bf16 ulps "
        "from the plain version, elements beyond one ulp, elements "
        f"{json.dumps(extra['ulps'])}; the fp32 body's "
        "output on the widened operands, rounded, bitwise: the norm on "
        f"{sum(v for k, v in same.items() if k.startswith('rmsnorm'))}/"
        f"{sum(k.startswith('rmsnorm') for k in same)} shapes (checked), "
        "the attention on "
        f"{sum(v for k, v in same.items() if k.startswith('flash'))}/"
        f"{sum(k.startswith('flash') for k in same)} (reported); gradients "
        f"{json.dumps(extra['gradients'])}")
    tot = {}
    for k in ("rmsnorm_bf16", "flash_attention_bf16"):
        rs = [r for r in rows if r["kernel"] == k]
        tot[k] = {f: sum(r[f] for r in rs) for f in
                  ("ms", "plain_ms", "library_ms", "flops_ms", "bytes_ms",
                   "bound_ms")}
        if "library_fp32_ms" in rs[0]:
            tot[k]["library_fp32_ms"] = sum(r["library_fp32_ms"] for r in rs)
        tot[k].update(max_abs_err=max(r["max_abs_err"] for r in rs),
                      bound_rate=rs[0]["bound_rate"], shapes=len(rs))
    out["seconds"] = time.perf_counter() - t0
    log("bf16", t0, f"phase 26 in {out['seconds']:.2f}s; launches (b)-(c) "
        f"{launches}")
    return out, launches, tot


# ---------------------------------------------------------------------------
# Phase 29: sharded serving on a ('data', 'model') mesh
# ---------------------------------------------------------------------------

#: Phase 29's SmolLM-135M serve (batch, prompt, new tokens).
MESH_LM = (8, 16, 32)
#: Phase 29 (a)'s networks: the label, the artifact an earlier phase
#: wrote under ``WORK``, and the input's shape (seeded by ``mesh_input``).
MESH_CNN = (("mobilenetv2", "mobilenetv2.npz", (8, 224, 224, 3)),
            ("mobilenetv2 w8a8", "mobilenetv2_w8a8.npz", (8, 224, 224, 3)),
            ("ddpm_unet", "ddpm_unet.npz", (8, 32, 32, 4)))
#: The kernels every rank of phase 29 (a) must launch.
MESH_KERNELS = ("merged_conv", "depthwise_conv", "merged_ffn", "rmsnorm",
                "flash_attention")


def mesh_input(shape, seed: int = 29):
    """The seeded CPU input phase 29's parent and ranks both draw."""
    import torch
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def code_flips(whole, local, mesh) -> tuple[int, int]:
    """(codes of a rank's blocks that differ from the single device's,
    codes compared), over the ``ActCodes`` records of one forward each:
    a rank's code tensor is the block of the whole one at its data index
    (rows, where it holds fewer) and model index (channels)."""
    check(len(whole) == len(local), f"{len(local)} activation quantizations "
          f"on the rank, {len(whole)} on the single device")
    flips = total = 0
    for (w, ws), (q, qs) in zip(whole, local):
        check(bool((ws == qs).all()), f"activation scale {float(qs):.9g} on "
              f"the rank, {float(ws):.9g} on the single device")
        blk = w
        if q.shape[0] < w.shape[0]:
            n, i = q.shape[0], mesh.index("data")
            blk = blk[i * n:(i + 1) * n]
        if q.shape[-1] < w.shape[-1]:
            c, i = q.shape[-1], mesh.index("model")
            blk = blk[..., i * c:(i + 1) * c]
        check(blk.shape == q.shape, f"activation codes {tuple(q.shape)} are "
              f"no block of {tuple(w.shape)}")
        flips += int((blk != q).sum())
        total += q.numel()
    return flips, total


def _sha(a) -> str:
    import hashlib
    return hashlib.sha256(a.tobytes()).hexdigest()


def mesh_rank(rank, spec):
    """Phase 29 (a) in one of four ``gloo`` ranks sharing the card, mesh
    data 2 × model 2 under ``make_unit_rules``: each network loaded as
    the rank's blocks (``load(path, rules=)``) and run by
    ``GraphExecutor.apply``; SmolLM-135M's prefill, its
    ``serve_loop_pertoken(rules=)`` and its logits teacher-forced on the
    parent's tokens (those of the loop's timed run where its tokens are
    the parent's).  The w8a8 network's activation codes are recorded
    on the sharded run and on the single device's, on this card.
    Returns the outputs (rank 0 the large logits, every rank their
    hash), timings, launches and the collectives of one decode step."""
    import torch
    from repro_torch import kernels, runtime
    from repro_torch.device import resolve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime import serving
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.rules import make_unit_rules

    t_wall = time.time()
    t_start = time.perf_counter()
    dev = resolve("cuda")
    mesh = make_host_mesh(model=2)
    rules = make_unit_rules(mesh)
    out = {"rank": rank, "coords": dict(mesh.coords), "cnn": {}}
    whole_codes = {}
    for label, path, shape in spec["cnn"]:       # the single device's codes
        if "w8a8" in label:
            with ActCodes() as rec:
                runtime.load(path, device=dev).apply(mesh_input(shape).to(dev))
            whole_codes[label] = rec.codes
    stages = {"start": t_wall - spec["spawned"],
              "codes": time.perf_counter() - t_start}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for label, path, shape in spec["cnn"]:
        ex = runtime.load(path, rules=rules, device=dev).executor(rules)
        with ActCodes() as rec:
            y = ex.apply(mesh_input(shape).to(dev))
        row = {"y": y.cpu().numpy()}
        if label in whole_codes:
            row["flips"], row["codes"] = code_flips(whole_codes[label],
                                                    rec.codes, mesh)
            row["quantized"] = len(rec.codes)
        out["cnn"][label] = row
    out["cnn_s"] = time.perf_counter() - t0
    B, P, N = MESH_LM
    t0 = time.perf_counter()
    ex = runtime.load(spec["lm"], rules=rules, device=dev).executor(rules)
    prompt = spec["prompt"].to(dev)
    stages["lm_load"] = time.perf_counter() - t0
    pre = ex.apply({"tokens": prompt}).cpu().numpy()
    stages["lm_prefill"] = time.perf_counter() - t0 - stages["lm_load"]
    steps, run_logits = P + N - 1, []

    def step(cache, tok):
        # the loop runs twice, unmeasured then timed: the timed run's last
        # call is the decode step whose collectives are counted
        if len(run_logits) == 2 * steps - 1:
            C.reset_collective_counts()
        logits, cache = ex.decode(cache, tok)
        run_logits.append(logits[:, -1])
        return logits, cache
    t0 = time.perf_counter()
    pre_s, dec_s, _, seqs = serving.serve_loop_pertoken(
        step, lambda: ex.init_cache(B, P + N), prompt, N, rules=rules)
    step_collectives = C.collective_counts()
    stages["lm_pertoken"] = time.perf_counter() - t0
    # Where this rank's greedy tokens are the single device's, the timed
    # run fed every position the token teacher forcing feeds, from a fresh
    # cache through the same decode: its logits are the teacher-forced
    # ones.  Otherwise they are computed on the single device's tokens.
    t0 = time.perf_counter()
    fed = spec["fed"].to(dev)
    own = torch.equal(torch.cat([prompt, seqs[:, :-1]], dim=1), fed)
    forced = torch.stack(run_logits[steps:], dim=1) if own else \
        forced_logits(ex.decode, ex.init_cache(B, P + N), fed)
    forced = forced.cpu().numpy()
    stages["lm_forced"] = time.perf_counter() - t0
    out["stages"] = stages
    out["lm"] = {"prefill": pre if rank == 0 else None,
                 "prefill_sha": _sha(pre), "seqs": seqs.cpu().numpy(),
                 "forced": forced if rank == 0 else None,
                 "forced_sha": _sha(forced),
                 "forced_from": "timed run" if own else "forced run",
                 "prefill_ms": pre_s * 1e3 / P,
                 "decode_ms": dec_s * 1e3 / (N - 1),
                 "collectives_per_step": step_collectives}
    out["launches"] = {k: v for k, v in kernels.launch_counts().items() if v}
    out["seconds"] = time.perf_counter() - t_start
    return out


def mesh_nccl_rank(rank, spec):
    """Phase 29 (b) in one ``nccl`` rank (``make_host_mesh()``): phase 9's
    SmolLM-135M prompts through the captured ``serve_loop(rules=)`` (its
    graph replays counted), a torch.profiler trace of the captured decode
    replays (the NCCL kernels inside the graph), and the logits
    teacher-forced on phase 9's tokens."""
    import torch
    from repro_torch import kernels, runtime
    from repro_torch.device import resolve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime import serving
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.rules import make_unit_rules

    t_start = time.perf_counter()
    dev = resolve("cuda")
    rules = make_unit_rules(make_host_mesh())
    ex = runtime.load(spec["lm"], rules=rules, device=dev).executor(rules)
    B, P, N = MESH_LM
    prompt = spec["prompt"].to(dev)
    kernels.reset_launch_counts()
    C.reset_collective_counts()
    with CountCalls(torch.cuda.CUDAGraph, "replay") as rp:
        pre_s, dec_s, last, seqs = serving.serve_loop(
            ex.decode, lambda: ex.init_cache(B, P + N), prompt, N,
            rules=rules)
    steps = P + N - 1
    run = serving._StepGraph(ex.decode, ex.init_cache(B, P + N), B, steps)
    lengths = torch.full((B,), P)
    C.reset_collective_counts()
    run.prepare(prompt, lengths, rules)     # one eager step, one captured
    captured = {k: {"calls": v["calls"] // 2, "bytes": v["bytes"] // 2}
                for k, v in C.collective_counts().items()}
    run.reset(prompt, lengths)
    run.advance(P + 1)
    busy_us, rows = device_kernels(lambda: run.advance(1), reps=N - 3)
    forced = forced_logits(ex.decode, ex.init_cache(B, P + N),
                           spec["fed"].to(dev))
    return {"replays_per_token": rp.n / (2 * steps),
            "seqs": seqs.cpu().numpy(), "last": last.cpu().numpy(),
            "forced": forced.cpu().numpy(),
            "nccl": [r for r in rows if "nccl" in r[2].lower()],
            "copies": [r for r in rows if "memcpy" in r[2].lower()],
            "collectives_per_step": captured,
            "kernels": rows[:8], "busy_us": busy_us,
            "prefill_ms": pre_s * 1e3 / P, "decode_ms": dec_s * 1e3 / (N - 1),
            "capture_s": run.capture_s, "launches_per_step": run.launches,
            "launches": {k: v for k, v in kernels.launch_counts().items()
                         if v},
            "seconds": time.perf_counter() - t_start}


def held_steps(label, forced, ref) -> float:
    """The teacher-forced logits of each step within ``NET_RTOL`` of the
    reference's largest |y| at that step; returns the worst ratio."""
    import numpy as np
    err = np.abs(forced - ref).max(axis=(0, 2))
    scale = np.abs(ref).max(axis=(0, 2))
    worst = float((err / scale).max())
    check(forced.shape == ref.shape and bool(np.isfinite(forced).all()),
          f"{label}: teacher-forced logits {forced.shape} vs {ref.shape}")
    check(worst <= NET_RTOL, f"{label}: teacher-forced logits differ from "
          f"the single device by {worst:.3g} of max |y| (limit {NET_RTOL})")
    return worst


def token_flips(label, seqs, seqs_ref, ref, P) -> list:
    """Greedy tokens of ``seqs`` (B, N) that differ from ``seqs_ref``: at
    each row's first difference the single device's top-two margin there
    (its logits ``ref`` teacher-forced on its own tokens) must lie within
    ``NET_RTOL`` of its max |y|, or the phase fails; the row's later
    tokens follow another prefix and are not compared."""
    import numpy as np
    flips = []
    for b in range(seqs.shape[0]):
        diff = np.nonzero(seqs[b] != seqs_ref[b])[0]
        if not len(diff):
            continue
        t = int(diff[0])
        lg = ref[b, P - 1 + t]
        top = np.sort(lg)[-2:]
        margin = float(top[1] - top[0])
        tol = NET_RTOL * float(np.abs(ref[:, P - 1 + t]).max())
        flips.append({"row": b, "step": t, "margin": margin, "limit": tol})
        check(margin <= tol, f"{label}: row {b} token {t} differs from the "
              f"single device where its top-two margin {margin:.3g} exceeds "
              f"{tol:.3g}")
    return flips


def mesh_phase(dev, ref9) -> tuple[dict, dict]:
    """Phase 29 ("mesh"): sharded serving of earlier phases' artifacts.

    (a) four ``gloo`` ranks sharing the card (``run_world``), mesh data 2
    × model 2: MobileNetV2 (fp32 and w8a8) and the UNet at batch 8, their
    gathered outputs within ``NET_RTOL`` of the single-device card forward
    here, the w8a8 ranks' activation codes bitwise the single device's;
    SmolLM-135M at full width (``random_prompts(0, 8, 16, vocab)``, 32 new
    tokens through ``serve_loop_pertoken(rules=)``), its prefill and its
    logits teacher-forced at every step on this process's tokens within
    ``NET_RTOL`` of max |y|, a differing greedy token failing only where
    its top-two margin exceeds that (:func:`token_flips`).  (b) one
    ``nccl`` rank runs phase 9's prompts through the captured
    ``serve_loop(rules=)``: one replay per token, the step's collectives
    issued inside the capture (the NCCL kernels and device copies of the
    graph's trace reported), tokens and logits held as in (a) against
    phase 9's unsharded loop (``ref9``: its prompt, tokens and last logits).  Both
    worlds run at once, beside this process's single-device references.
    Returns (the phase's numbers, the ranks' launches summed)."""
    import threading

    import numpy as np
    import torch
    from repro_torch import runtime
    from repro_torch.runtime import serving
    from repro_torch.testing.world import run_world

    t0 = time.perf_counter()
    B, P, N = MESH_LM
    lm_path = os.path.join(WORK, "smollm135m_depth.npz")
    cnns = [(label, os.path.join(WORK, f), shape)
            for label, f, shape in MESH_CNN]
    single = runtime.load(lm_path, device=dev)
    vocab = single.graph.meta["config"].vocab_size
    prompt = serving.random_prompts(0, B, P, vocab, device="cpu")
    _, _, _, seqs_ref = serving.serve_loop_pertoken(
        single.decode, lambda: single.init_cache(B, P + N), prompt.to(dev), N)
    seqs_ref = seqs_ref.cpu()
    fed = torch.cat([prompt, seqs_ref[:, :-1]], dim=1)
    fed9 = torch.cat([ref9["prompt"].cpu(), ref9["seqs"].cpu()[:, :-1]], 1)
    worlds: dict = {}

    def start(key, *args, **kw):
        def run():
            try:
                worlds[key] = run_world(*args, **kw)
            except BaseException as e:          # re-raised below
                worlds[key] = e
        th = threading.Thread(target=run)
        th.start()
        return th

    threads = [
        start("a", mesh_rank, 4, backend="gloo", device="cuda", timeout=300,
              args=({"cnn": cnns, "lm": lm_path, "prompt": prompt,
                     "fed": fed, "spawned": time.time()},)),
        start("b", mesh_nccl_rank, 1, backend="nccl", device="cuda",
              timeout=300, args=({"lm": lm_path,
                                  "prompt": ref9["prompt"].cpu(),
                                  "fed": fed9},))]
    # the single-device references, on the card, while the worlds run
    ref_cnn = {label: runtime.load(path, device=dev).apply(
        mesh_input(shape).to(dev)).cpu().numpy()
        for label, path, shape in cnns}
    ref_pre = single.apply({"tokens": prompt.to(dev)}).cpu().numpy()
    ref_forced = forced_logits(single.decode, single.init_cache(B, P + N),
                               fed.to(dev)).cpu().numpy()
    ref_forced9 = forced_logits(single.decode, single.init_cache(B, P + N),
                                fed9.to(dev)).cpu().numpy()
    t_ref = time.perf_counter() - t0
    for th in threads:
        th.join()
    for key in ("a", "b"):
        if isinstance(worlds[key], BaseException):
            raise worlds[key]
    ranks, (nccl,) = worlds["a"], worlds["b"]
    out: dict = {"ref_s": t_ref, "ranks": [], "nccl": {}}
    launches: dict = {}
    for r in ranks:
        row = {"rank": r["rank"], "coords": r["coords"],
               "seconds": r["seconds"], "cnn_s": r["cnn_s"],
               "launches": r["launches"], "stages": r["stages"], "cnn": {}}
        for label, _, _ in cnns:
            c = r["cnn"][label]
            rel = rel_np(c["y"], ref_cnn[label])
            print(f"  mesh rank {r['rank']} {label}: vs single device "
                  f"{rel:.3g}" + (f", activation codes {c['codes']}, flips "
                                  f"{c['flips']}" if "codes" in c else ""),
                  flush=True)
            check(rel <= NET_RTOL, f"mesh {label} rank {r['rank']}: output "
                  f"differs from the single device by {rel:.3g} of max |y|")
            row["cnn"][label] = {"rel": rel, **{
                k: c[k] for k in ("flips", "codes", "quantized") if k in c}}
            if "w8a8" in label:
                check(c["codes"] > 0 and c["flips"] == 0,
                      f"mesh {label} rank {r['rank']}: {c['flips']} of "
                      f"{c['codes']} activation codes differ from the "
                      "single device's")
        lm = r["lm"]
        check(lm["prefill_sha"] == ranks[0]["lm"]["prefill_sha"]
              and lm["forced_sha"] == ranks[0]["lm"]["forced_sha"],
              f"mesh rank {r['rank']}: gathered logits differ from rank 0's")
        row["lm"] = {k: lm[k] for k in ("prefill_ms", "decode_ms",
                                        "collectives_per_step",
                                        "forced_from")}
        row["lm"]["token_flips"] = token_flips(
            f"mesh smollm rank {r['rank']}", lm["seqs"],
            seqs_ref.numpy(), ref_forced, P)
        for k in MESH_KERNELS:
            check(r["launches"].get(k, 0) > 0, f"mesh rank {r['rank']}: "
                  f"{k} never launched")
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
        out["ranks"].append(row)
    lm0 = ranks[0]["lm"]
    out["prefill_rel"] = rel_np(lm0["prefill"], ref_pre)
    check(out["prefill_rel"] <= NET_RTOL, f"mesh smollm prefill differs "
          f"from the single device by {out['prefill_rel']:.3g}")
    out["forced_rel"] = held_steps("mesh smollm", lm0["forced"], ref_forced)
    # (b) the captured loop over nccl
    check(nccl["replays_per_token"] == 1.0, f"mesh nccl: "
          f"{nccl['replays_per_token']} graph replays a token")
    # The step's collectives go to NCCL inside the capture.  On one rank
    # NCCL launches no kernel for them (a sum or max is complete in place;
    # an all-gather is one device copy), so the trace shows NCCL kernels
    # only where they exist; their count is reported, not required.
    check(sum(v["calls"] for v in nccl["collectives_per_step"].values())
          > 0, "mesh nccl: the captured step issued no collective")
    out["nccl"] = {k: nccl[k] for k in (
        "replays_per_token", "prefill_ms", "decode_ms", "capture_s",
        "busy_us", "launches_per_step", "launches", "seconds", "nccl",
        "copies", "collectives_per_step")}
    out["nccl"]["forced_rel"] = held_steps("mesh nccl", nccl["forced"],
                                           ref_forced9)
    out["nccl"]["last_rel"] = rel_np(nccl["last"],
                                     ref9["logits"].cpu().numpy())
    out["nccl"]["token_flips"] = token_flips(
        "mesh nccl", nccl["seqs"], ref9["seqs"].cpu().numpy(), ref_forced9,
        P)
    out["seconds"] = time.perf_counter() - t0
    log("mesh", t0, "(a) 4 gloo ranks, data 2 x model 2: " + "; ".join(
        f"rank {r['rank']} {r['coords']} in {r['seconds']:.2f}s: outputs vs "
        f"single device " + ", ".join(
            f"{k} {v['rel']:.3g}" + (f" (codes {v['codes']}, flips "
                                     f"{v['flips']})" if "codes" in v else "")
            for k, v in r["cnn"].items())
        + f"; smollm prefill {r['lm']['prefill_ms']:.3f} ms a position, "
        f"decode {r['lm']['decode_ms']:.3f} ms a step, token flips "
        f"{len(r['lm']['token_flips'])}, teacher-forced logits from the "
        f"{r['lm']['forced_from']}; seconds by stage "
        f"{json.dumps({k: round(v, 2) for k, v in r['stages'].items()})}; "
        f"launches {json.dumps(r['launches'])}"
        f"; collectives a decode step "
        f"{json.dumps(r['lm']['collectives_per_step'])}"
        for r in out["ranks"]) + f"; smollm prefill vs single device "
        f"{out['prefill_rel']:.3g}, teacher-forced worst step "
        f"{out['forced_rel']:.3g} (limit {NET_RTOL}); (b) 1 nccl rank: "
        f"captured serve_loop replays a token "
        f"{nccl['replays_per_token']}, prefill {nccl['prefill_ms']:.3f} ms "
        f"a position, decode {nccl['decode_ms']:.3f} ms a step, capture "
        f"{nccl['capture_s']:.3f}s, launches a step "
        f"{json.dumps(nccl['launches_per_step'])}, collectives captured "
        f"a step {json.dumps(nccl['collectives_per_step'])}, device busy "
        f"{nccl['busy_us']:.1f} us a step, NCCL kernels in the graph's "
        f"trace {len(nccl['nccl'])}: "
        + ("; ".join(f"{n[:50]} {us:.1f}us x{k}" for us, k, n in
                     nccl["nccl"]) or "none")
        + ", device copies: " + ("; ".join(
            f"{n[:40]} {us:.1f}us x{k}" for us, k, n in nccl["copies"])
            or "none")
        + f"; teacher-forced worst step {out['nccl']['forced_rel']:.3g}, "
        f"last logits vs phase 9 {out['nccl']['last_rel']:.3g}, token flips "
        f"{len(out['nccl']['token_flips'])}; references here "
        f"{t_ref:.2f}s")
    return out, launches


# ---------------------------------------------------------------------------
# 30. sharded training on a ('data', 'model') mesh
# ---------------------------------------------------------------------------

#: Phase 30's global batch (rows, tokens) and steps of each model.
MESH_TRAIN_BATCH = (8, 256)
MESH_TRAIN_STEPS = {"smollm-135m": 4, "granite-moe-1b-a400m": 2,
                    "xlstm-125m": 2}
#: Phase 30 (b) and (c): granite-moe-1b-a400m's layers (of 24) and
#: xlstm-125m's (of 12, the block pattern kept: one sLSTM) at full width,
#: cut to keep the script inside its time (4 and 12 in the first runs).
MESH_GRANITE_LAYERS = 2
MESH_XLSTM_LAYERS = 6
#: Phase 30 (c): xLSTM decode, prompt positions and new tokens.
MESH_XLSTM_DECODE = (16, 16)
#: The presets each model trains under: FSDP params with the
#: optimizer-state placements as ``grad_shardings`` (ZeRO), and params
#: whole over 'data' with no ``grad_shardings``.
MESH_PRESETS = ("fsdp+zero", "tp+dp")
#: Sharded vs single-device train steps: the reference's tolerance for
#: its SPMD check (tests/test_distributed.py), on losses, grad norms and
#: every parameter after the last step.
MESH_TRAIN_TOL = 2e-4
#: Models whose steps are held teacher-forced, each step from the single
#: device's state, and against the single device's own spread:
#: xlstm-125m's gradient is not a continuous function of its params (the
#: max of its stabilizers and the clamps of its normalizers switch
#: branch), so two summation orders of the same step part.  On an H100
#: 80GB HBM3 (700 W) the single device against itself, its batch in 2
#: microbatches instead of 1, had params 4.0e-4 apart after one step (7
#: elements past 2e-4) and 1.6e-3 after two (40,669 in the embedding
#: alone); SmolLM-135M's 6e-6 and 8e-6.  Each xLSTM step's losses and
#: grad norms are held to ``MESH_TRAIN_TOL``; its params to that
#: tolerance or, where the single device's two orders part by more, to
#: ``MESH_SPREAD`` times their spread at that step, measured in the same
#: rank.
MESH_TEACHER = ("xlstm-125m",)
MESH_SPREAD = 2.0
#: Suffix of the ``kernels`` line's rows of phase 30: the kernels at a
#: rank's SmolLM-135M shapes, their launches over phase 30's training.
MESH_TRAIN_ROW = "@mesh-train"
MESH_TRAIN_NORM = (4 * 256, 576)
MESH_TRAIN_ATTENTION = (4, 256, 9, 3, 64)


def mesh_train_opt():
    """AdamW for phase 30: eps 1e-6, so a gradient within eps of 0 cannot
    turn the last-bit noise of two summation orders into an O(lr) update
    (Adam divides by sqrt(v) + eps), which no tolerance on the params
    would then hold."""
    from repro_torch.optim.adamw import AdamWConfig
    return AdamWConfig(lr=1e-3, eps=1e-6, warmup_steps=1, total_steps=10)


def mesh_train_cfg(arch):
    """Phase 30's configs, fp32: SmolLM-135M whole, xlstm-125m at
    ``MESH_XLSTM_LAYERS`` layers, granite-moe at ``MESH_GRANITE_LAYERS``
    layers at its own capacity factor (1.25): the sharded step routes
    each data block as a group (the reference's grouping), and the
    single device routes in as many groups (:func:`mesh_train_single`)."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch), dtype="float32", remat=False)
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, num_layers=MESH_GRANITE_LAYERS)
    if arch == "xlstm-125m":
        cfg = dataclasses.replace(cfg, num_layers=MESH_XLSTM_LAYERS)
    return cfg


def mesh_train_init(cfg, dev):
    """The seeded weights, drawn on the card (every rank draws the same)."""
    import torch
    from repro_torch.models import transformer as T
    return T.init_model(cfg, torch.Generator(dev).manual_seed(30),
                        device=dev)


def mesh_train_data(cfg):
    from repro_torch.data.pipeline import SyntheticTokens
    B, S = MESH_TRAIN_BATCH
    return SyntheticTokens(cfg.vocab_size, B, S, seed=30)


def mesh_train_single(dev, arch, path) -> dict:
    """The single-device steps on this card: losses, grad norms, step
    ms, and the final params written to ``path`` (CPU tensors), with a
    ``.done`` marker the ranks wait for."""
    import torch
    from repro_torch.data.pipeline import GlobalBatcher
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import flatten_tree

    from repro_torch.models import moe as MOE

    cfg = mesh_train_cfg(arch)
    params, _ = mesh_train_init(cfg, dev)
    opt = init_opt_state(params)
    step = make_train_step(cfg, mesh_train_opt())
    gb = GlobalBatcher(mesh_train_data(cfg), device=dev)
    losses, norms, ms = [], [], []
    # the MoE routes each of the mesh's 2 data blocks as a group
    with MOE.grouped_routing(2):
        for i in range(MESH_TRAIN_STEPS[arch]):
            batch = gb(i)
            torch.cuda.synchronize()
            t = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t) * 1e3)
            norms.append(float(m["grad_norm"]))
    torch.save({"losses": losses, "norms": norms,
                "params": {k: v.cpu() for k, v in
                           flatten_tree(params).items()}}, path)
    open(path + ".done", "w").close()
    return {"losses": losses, "norms": norms, "step_ms": ms}


def mesh_xlstm_decode(cfg, params, dev, rules=None):
    """Greedy decode of ``MESH_XLSTM_DECODE`` from seeded prompts: the
    tokens (B, N) and the logits of every step (B, P + N - 1, V), on the
    card (under ``rules`` where given)."""
    import contextlib

    import torch
    from repro_torch.models import transformer as T
    from repro_torch.runtime import serving
    from repro_torch.sharding.rules import use_rules
    P, N = MESH_XLSTM_DECODE
    B = MESH_TRAIN_BATCH[0]
    prompt = serving.random_prompts(30, B, P, cfg.vocab_size, device=dev)
    ctx = use_rules(rules) if rules is not None else contextlib.nullcontext()
    with ctx, torch.no_grad():
        cache = T.init_cache(cfg, B, P + N, device=dev)
        logits, toks = [], []
        for t in range(P + N - 1):
            tok = prompt[:, t:t + 1] if t < P else toks[-1]
            lg, cache = T.decode_step(cfg, params, cache, {"tokens": tok})
            logits.append(lg[:, -1])
            if t >= P - 1:
                toks.append(torch.argmax(lg[:, -1], dim=-1)[:, None]
                            .to(torch.int32))
    return (torch.cat(toks, 1).cpu().numpy(),
            torch.stack(logits, 1).cpu().numpy())


def _wait_for(path: str, deadline: float) -> None:
    while not os.path.exists(path + ".done"):
        if os.path.exists(path + ".failed"):
            raise RuntimeError(f"the parent's reference {path} failed")
        if time.time() > deadline:
            raise RuntimeError(f"no reference {path} in time")
        time.sleep(0.2)


def _block_excess(local, ref_flat) -> dict:
    """This rank's param blocks against its blocks of the single device's
    params (``ref_flat``, by key path): the largest excess over
    ``MESH_TRAIN_TOL`` (|a − b| − tol·(1 + |b|), ≤ 0 where held), its
    leaf, and the largest |a − b|."""
    from repro_torch.sharding.rules import sharding_of
    from repro_torch.tree import flatten_tree
    worst_excess, worst_abs, worst_key = -1.0, 0.0, None
    for k, t in flatten_tree(local).items():
        r = ref_flat[k]
        place = sharding_of(t)
        if place is not None and place.split_dims():
            r = r[place.slices(r.shape)]
        r = r.to(t.device)
        check(tuple(r.shape) == tuple(t.shape),
              f"mesh train: {k} block {tuple(t.shape)} vs {tuple(r.shape)}")
        diff = (t - r).abs()
        excess = float((diff - MESH_TRAIN_TOL * (1 + r.abs())).max())
        if excess > worst_excess:
            worst_excess, worst_key = excess, k
        worst_abs = max(worst_abs, float(diff.max()))
    return {"excess": worst_excess, "max_abs": worst_abs, "key": worst_key}


#: The parent's references a rank has read, by path (both presets).
_REFS: dict = {}


def _held_blocks(local, ref_path, deadline) -> dict:
    """:func:`_block_excess` against the single device's final params,
    which the parent writes to ``ref_path``, with its losses and norms."""
    import torch
    if ref_path not in _REFS:
        _wait_for(ref_path, deadline)
        _REFS[ref_path] = torch.load(ref_path, map_location="cpu")
    ref = _REFS[ref_path]
    return {**_block_excess(local, ref["params"]), "losses": ref["losses"],
            "norms": ref["norms"]}


#: A rank's single-device trajectory of each teacher-forced model, shared
#: by its presets (the same init and batches).
_TRAJECTORIES: dict = {}


def _teacher_trajectory(arch, cfg, whole, dev):
    """``traj(i)``: the single device's state after step ``i`` from
    ``whole`` (params, moments, loss, grad norm), stepped on demand and
    kept for every preset, with the spread at that step: the largest
    |Δparam| between its batch taken whole and in 2 microbatches."""
    from repro_torch.data.pipeline import GlobalBatcher
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import flatten_tree

    steps = _TRAJECTORIES.setdefault(arch, [])
    single = make_train_step(cfg, mesh_train_opt())
    single2 = make_train_step(cfg, mesh_train_opt(), microbatches=2)
    gw = GlobalBatcher(mesh_train_data(cfg), device=dev)
    start = {"params": _copy_tree(whole), "opt": init_opt_state(whole)}

    def traj(i):
        while len(steps) <= i:
            prev = steps[-1] if steps else start
            batch = gw(len(steps))
            other, _, _ = single2(_copy_tree(prev["params"]),
                                  _copy_tree(prev["opt"]), batch)
            nxt, opt, m = single(_copy_tree(prev["params"]),
                                 _copy_tree(prev["opt"]), batch)
            ref = flatten_tree(nxt)
            steps.append({"params": nxt, "opt": opt,
                          "loss": float(m["loss"]),
                          "norm": float(m["grad_norm"]),
                          "spread": max(float((a - ref[k]).abs().max())
                                        for k, a in
                                        flatten_tree(other).items())})
        return steps[i]
    return traj


def _copy_tree(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.clone(), tree)


def mesh_train_run(arch, preset, dev, mesh, spec) -> dict:
    """One model's sharded steps under ``preset`` in this rank: losses,
    grad norms, step ms, the last step's collectives (each way) and
    launches, and the blocks held against the single device's.

    SmolLM-135M and granite run free, held after the last step against
    the parent's single-device run.  xLSTM runs teacher-forced
    (``MESH_TEACHER``): before each step the rank takes its blocks of the
    single device's params and moments, which it steps itself on the
    whole tree alongside, and each step is held on its own."""
    import statistics

    import torch
    from repro_torch import kernels
    from repro_torch.checkpoint import ckpt as CK
    from repro_torch.data.pipeline import GlobalBatcher
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.rules import (make_rules,
                                            param_shardings_with_shapes, put,
                                            use_rules)
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import flatten_tree

    cfg = mesh_train_cfg(arch)
    whole, axes = mesh_train_init(cfg, dev)
    fsdp = preset == "fsdp+zero"
    rules = make_rules(mesh, fsdp=fsdp)
    places = param_shardings_with_shapes(rules, axes, whole)
    gs = param_shardings_with_shapes(
        make_rules(mesh, fsdp=True, opt_state=True), axes, whole) \
        if fsdp else None
    teacher = arch in MESH_TEACHER
    params = put(_copy_tree(whole) if teacher else whole, places)
    opt = init_opt_state(params, shardings=gs)
    if teacher:
        traj = _teacher_trajectory(arch, cfg, whole, dev)
    del whole
    step = make_train_step(cfg, mesh_train_opt(), grad_shardings=gs)
    gb = GlobalBatcher(mesh_train_data(cfg), mesh=mesh, device=dev)
    losses, norms, ms = [], [], []
    ref_losses, ref_norms, held_steps = [], [], []
    launches: dict = {}
    for i in range(MESH_TRAIN_STEPS[arch]):
        if teacher and i:
            prev = traj(i - 1)
            params = put(_copy_tree(prev["params"]), places)
            opt = {"mu": put(_copy_tree(prev["opt"]["mu"]), gs or places),
                   "nu": put(_copy_tree(prev["opt"]["nu"]), gs or places),
                   "step": prev["opt"]["step"].clone()}
        batch = gb(i)
        with use_rules(rules):
            C.reset_collective_counts()
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t) * 1e3)
            norms.append(float(m["grad_norm"]))
            last = {k: v for k, v in kernels.launch_counts().items() if v}
            coll = C.collective_totals()
            ops = C.collective_counts()
        for k, v in last.items():
            launches[k] = launches.get(k, 0) + v
        if teacher:
            ref = traj(i)
            ref_losses.append(ref["loss"])
            ref_norms.append(ref["norm"])
            h = _block_excess(params, flatten_tree(ref["params"]))
            h["spread"] = ref["spread"]
            if h["excess"] > 0 and h["max_abs"] <= MESH_SPREAD * h["spread"]:
                h["excess"] = 0.0     # within the single device's spread
            held_steps.append(h)
    out_blocks = None
    if arch == "smollm-135m" and fsdp:           # (d)'s checkpoint
        CK.save(spec["ckpt"], MESH_TRAIN_STEPS[arch], params)
        out_blocks = params
    if teacher:
        worst = max(held_steps, key=lambda h: h["excess"])
        held = {**worst, "max_abs": max(h["max_abs"] for h in held_steps),
                "losses": ref_losses, "norms": ref_norms,
                "teacher_forced": True,
                "steps": [{k: h[k] for k in ("max_abs", "spread", "key")}
                          for h in held_steps]}
    else:
        held = _held_blocks(params, spec["refs"][arch], spec["deadline"])
    return {"losses": losses, "norms": norms, "step_ms": ms,
            "step_ms_median": statistics.median(ms[1:] or ms),
            "collectives_per_step": coll, "collective_ops": ops,
            "launches_last_step": last, "launches": launches,
            "held": held, "_blocks": out_blocks}


def mesh_elastic(spec, mesh, blocks, dev) -> dict:
    """(d) the 2 × 2 run's checkpoint: this rank's blocks bitwise the
    saved arrays' blocks, and restored on a data 1 × model 2 mesh of
    ranks 0 and 1 (``restore(shardings=)``) bitwise the saved arrays'
    blocks of that mesh's placements."""
    import numpy as np
    import torch
    from repro_torch.checkpoint import ckpt as CK
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.models import transformer as T
    from repro_torch.sharding.rules import (make_rules,
                                            param_shardings_with_shapes,
                                            sharding_of)
    from repro_torch.tree import flatten_tree, unflatten_tree

    step = MESH_TRAIN_STEPS["smollm-135m"]
    path = os.path.join(spec["ckpt"], f"step_{step}", "arrays.npz")
    with np.load(path) as z:
        saved = {k: z[k] for k in z.files}
    own = 0
    for k, t in flatten_tree(blocks).items():
        place = sharding_of(t)
        a = saved[k][place.slices(saved[k].shape)] if place is not None \
            and place.split_dims() else saved[k]
        check(np.array_equal(t.cpu().numpy(), a),
              f"mesh elastic: rank block {k} differs from the saved array")
        own += 1
    m12 = build_mesh({"data": 1, "model": 2}, (0, 1))   # every rank builds
    out = {"own_blocks": own, "restored_1x2": 0}
    if m12.coords is not None:
        cfg = mesh_train_cfg("smollm-135m")
        places = flatten_tree(param_shardings_with_shapes(
            make_rules(m12, fsdp=True), T.model_axes(cfg),
            unflatten_tree(saved)))
        got = CK.restore(spec["ckpt"], step,
                         {k: torch.empty(0, device=dev) for k in saved},
                         shardings=places)
        for k, t in got.items():
            place = places[k]
            a = saved[k][place.slices(saved[k].shape)] \
                if place.split_dims() else saved[k]
            check(np.array_equal(t.cpu().numpy(), a), f"mesh elastic: "
                  f"block {k} restored on 1 x 2 differs from the saved array")
            out["restored_1x2"] += 1
        out["split_1x2"] = sum(1 for p in places.values() if p.split_dims())
    torch.distributed.barrier()
    return out


def mesh_train_rank(rank, spec):
    """Phase 30 (a)-(d) in one of four ``gloo`` ranks sharing the card,
    mesh data 2 × model 2: each model's sharded steps under both presets,
    xLSTM's decode under the mesh, ``compressed_allreduce`` on seeded
    blocks, and the elastic restore of the SmolLM-135M checkpoint."""
    import torch
    from repro_torch.device import resolve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.compress import compressed_psum
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.rules import (make_rules,
                                            param_shardings_with_shapes, put)

    t_start = time.perf_counter()
    dev = resolve("cuda")
    mesh = make_host_mesh(model=2)
    out = {"rank": rank, "coords": dict(mesh.coords), "train": {},
           "start_s": time.time() - spec["spawned"]}
    blocks = None
    for arch in MESH_TRAIN_STEPS:
        for preset in MESH_PRESETS:
            row = mesh_train_run(arch, preset, dev, mesh, spec)
            if row["_blocks"] is not None:
                blocks = row["_blocks"]
            del row["_blocks"]
            out["train"][f"{arch} {preset}"] = row
            torch.cuda.empty_cache()
        _TRAJECTORIES.pop(arch, None)
        _REFS.pop(spec["refs"].get(arch), None)
    # (c) xLSTM decode with its heads split
    cfg = mesh_train_cfg("xlstm-125m")
    whole, axes = mesh_train_init(cfg, dev)
    rules = make_rules(mesh, fsdp=False)
    local = put(whole, param_shardings_with_shapes(rules, axes, whole))
    del whole
    t = time.perf_counter()
    out["xlstm_seqs"], _ = mesh_xlstm_decode(cfg, local, dev, rules)
    out["xlstm_decode_s"] = time.perf_counter() - t
    del local
    # (d) compressed_allreduce on this rank's seeded block
    g = torch.randn(MESH_CAR_SHAPE, generator=torch.Generator()
                    .manual_seed(300 + rank)).to(dev)
    codes: dict = {}
    C.reset_collective_counts()
    res = compressed_psum({"g": g}, mesh, ("data", "model"), codes=codes)
    out["car"] = {"result": res["g"].cpu().numpy(),
                  "codes": codes["g"].cpu().numpy(),
                  "collectives": C.collective_counts()}
    t = time.perf_counter()
    out["elastic"] = mesh_elastic(spec, mesh, blocks, dev)
    out["elastic_s"] = time.perf_counter() - t
    del blocks
    _REFS.clear()
    torch.cuda.empty_cache()
    # phase 31 (b)-(c) in the same world
    out["comp"] = comp_rank(spec, mesh, dev)
    out["seconds"] = time.perf_counter() - t_start
    return out


#: Phase 30 (d): each rank's block of the compressed all-reduce.
MESH_CAR_SHAPE = (256, 1024)


def compressed_sum_plain(blocks):
    """The reference's ``compressed_psum`` arithmetic on the CPU over the
    ranks' blocks: (result, summed int32 codes)."""
    import torch
    amax = max(b.abs().float().max() for b in blocks)
    amax = torch.clamp(amax, min=1e-30)
    scale = amax / torch.full_like(amax, 127.0)
    codes = sum(torch.clamp(torch.round(b.float() / scale), -127, 127)
                .to(torch.int32) for b in blocks)
    return codes.float() * scale, codes


def mesh_launcher() -> dict:
    """(e) ``python -m repro_torch.launch.train --arch smollm-135m
    --distributed --steps 5`` as one NCCL rank (the environment's process
    group: ``torchrun``'s variables), then ``--resume --steps 7`` from its
    checkpoint."""
    import shutil

    from repro_torch.testing.world import free_port
    ckpt = os.path.join(WORK, "mesh_launch_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               MASTER_ADDR="127.0.0.1", WORLD_SIZE="1", RANK="0",
               LOCAL_RANK="0")
    runs = {}
    for key, extra in (("first", ["--steps", "5"]),
                       ("resume", ["--steps", "7", "--resume"])):
        env["MASTER_PORT"] = str(free_port())
        t = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             "smollm-135m", "--distributed", "--ckpt-dir", ckpt, *extra],
            capture_output=True, text=True, timeout=300, env=env)
        runs[key] = {"rc": r.returncode, "seconds": time.perf_counter() - t,
                     "stdout": r.stdout[-2000:], "stderr": r.stderr[-2000:]}
    return runs


def mesh_train_phase(dev, lm_path) -> tuple:
    """Phase 30 ("mesh train"): sharded training on a ('data', 'model')
    mesh.  One ``run_world`` of four ``gloo`` ranks sharing the card,
    data 2 × model 2: (a) SmolLM-135M full size, (b) granite-moe at
    ``MESH_GRANITE_LAYERS`` layers (16 experts and 8 query heads a rank),
    (c) xlstm-125m at ``MESH_XLSTM_LAYERS``, each at batch
    ``MESH_TRAIN_BATCH`` for
    ``MESH_TRAIN_STEPS`` under both ``MESH_PRESETS``, every step's loss
    and grad norm and every parameter after the last within
    ``MESH_TRAIN_TOL`` of the single-device steps this process takes on
    the card meanwhile; xLSTM's 16-token decode under the mesh gives the
    single device's tokens (a differing token fails unless its top-two
    margin is within ``NET_RTOL``, :func:`token_flips`); (d)
    ``compressed_allreduce``'s codes and result bitwise the CPU's plain
    arithmetic on the same blocks, and the SmolLM-135M checkpoint the 2 ×
    2 run saved restored on a 1 × 2 mesh and on one process, every block
    bitwise the saved arrays'; (e) the launcher's ``--distributed`` as
    one NCCL rank, meanwhile.  Phase 31 runs in the same world and this
    process meanwhile (:func:`comp_rank`, :func:`comp_checks`): the
    compressed artifact at ``lm_path`` through ``forward_compressed``
    (a), trained sharded (b), GPipe (c) and the dry run of (b)'s step on
    a fake world (d, a subprocess started first).  Returns (the numbers,
    launches summed over the ranks' training, the ``kernels`` line's
    ``@mesh-train`` rows) of phase 30, then the same of phase 31."""
    import threading

    import numpy as np
    import torch
    from repro_torch.checkpoint import ckpt as CK
    from repro_torch.testing.world import run_world

    t0 = time.perf_counter()
    mdir = os.path.join(WORK, "mesh_train")
    os.makedirs(mdir, exist_ok=True)
    refs = {arch: os.path.join(mdir, f"ref_{arch}.pt")
            for arch in MESH_TRAIN_STEPS if arch not in MESH_TEACHER}
    comp_ref = os.path.join(mdir, "ref_compressed.pt")
    for p in list(refs.values()) + [comp_ref]:
        for suffix in ("", ".done", ".failed"):
            if os.path.exists(p + suffix):
                os.remove(p + suffix)
    ckpt = os.path.join(mdir, "ckpt")
    import shutil
    shutil.rmtree(ckpt, ignore_errors=True)
    from repro_torch import runtime
    art = runtime.load(lm_path, device=dev)
    comp_cfg, comp_spec, _ = comp_units(art)
    spec = {"refs": refs, "ckpt": ckpt, "spawned": time.time(),
            "deadline": time.time() + 400, "lm_path": lm_path,
            "comp_ref": comp_ref}
    result: dict = {}

    def dryrun():
        try:
            result["dryrun"] = comp_dryrun(comp_dryrun_cell(comp_cfg,
                                                            comp_spec))
        except BaseException as e:
            result["dryrun"] = e

    def world():
        try:
            result["ranks"] = run_world(mesh_train_rank, 4, backend="gloo",
                                        device="cuda", timeout=420,
                                        args=(spec,))
        except BaseException as e:              # re-raised below
            result["ranks"] = e

    def launcher():
        try:
            result["launch"] = mesh_launcher()
        except BaseException as e:
            result["launch"] = e

    threads = [threading.Thread(target=world),
               threading.Thread(target=launcher),
               threading.Thread(target=dryrun)]
    for th in threads:
        th.start()
    single = {}
    try:
        for arch, path in refs.items():
            single[arch] = mesh_train_single(dev, arch, path)
            gc.collect()
            torch.cuda.empty_cache()
        cfg = mesh_train_cfg("xlstm-125m")
        params, _ = mesh_train_init(cfg, dev)
        x_seqs, x_logits = mesh_xlstm_decode(cfg, params, dev)
        del params
        t_ref = time.perf_counter() - t0
        # phase 31 (a), and the yardsticks of (b) and (c)
        t31 = time.perf_counter()
        comp_fwd = comp_forward_check(dev, art)
        comp_one = comp_single(dev, art, comp_ref)
        gc.collect()
        torch.cuda.empty_cache()
        seq_ref = gpipe_reference(dev)
        t31 = time.perf_counter() - t31
    finally:
        for p in list(refs.values()) + [comp_ref]:
            if not os.path.exists(p + ".done"):
                open(p + ".failed", "w").close()
    for th in threads:
        th.join()
    for key in ("ranks", "launch", "dryrun"):
        if isinstance(result[key], BaseException):
            raise result[key]
    ranks = result["ranks"]
    out = {"ref_s": t_ref, "single": single, "ranks": [], "launcher": {}}
    launches: dict = {}
    fails: list = []

    def soft(ok, msg):
        """A failed check of the ranks' training, raised once every row
        is logged."""
        if not ok:
            fails.append(msg)
    for r in ranks:
        row = {"rank": r["rank"], "coords": r["coords"],
               "seconds": r["seconds"], "start_s": r["start_s"],
               "xlstm_decode_s": r["xlstm_decode_s"],
               "elastic_s": r["elastic_s"], "train": {}}
        for key, tr in r["train"].items():
            arch = key.split()[0]
            h = tr["held"]
            rel = [abs(a - b) - MESH_TRAIN_TOL * (1 + abs(b))
                   for a, b in zip(tr["losses"] + tr["norms"],
                                   h["losses"] + h["norms"])]
            soft(len(tr["losses"]) == len(h["losses"]) and max(rel) <= 0,
                  f"mesh train {key} rank {r['rank']}: losses "
                  f"{tr['losses']} grad norms {tr['norms']} vs the single "
                  f"device's {h['losses']} {h['norms']} (tol "
                  f"{MESH_TRAIN_TOL})")
            soft(h["excess"] <= 0, f"mesh train {key} rank {r['rank']}: "
                  f"param {h['key']} differs from the single device's by "
                  f"{h['max_abs']:.3g} beyond {MESH_TRAIN_TOL}")
            for k in ("rmsnorm",) + (("flash_attention",) if arch !=
                                     "xlstm-125m" else ()):
                soft(tr["launches"].get(k, 0) > 0, f"mesh train {key} "
                      f"rank {r['rank']}: {k} never launched")
            for k, v in tr["launches"].items():
                launches[k] = launches.get(k, 0) + v
            row["train"][key] = {
                "losses": tr["losses"], "norms": tr["norms"],
                "step_ms": tr["step_ms"],
                "step_ms_median": tr["step_ms_median"],
                "param_max_abs": h["max_abs"],
                "teacher_steps": h.get("steps"),
                "collectives_per_step": tr["collectives_per_step"],
                "collective_ops": tr["collective_ops"],
                "launches_per_step": {
                    k: tr["launches_last_step"].get(k, 0)
                    for k in ("rmsnorm", "flash_attention")}}
        out["ranks"].append(row)
    out["train_failures"] = fails
    if fails:
        with open(os.path.join(WORK, "mesh_train.json"), "w") as f:
            json.dump(out, f, indent=1, default=str)
    check(not fails, "; ".join(fails))
    # (c) decode tokens
    P = MESH_XLSTM_DECODE[0]
    out["xlstm_token_flips"] = [token_flips(
        f"mesh xlstm decode rank {r['rank']}", r["xlstm_seqs"], x_seqs,
        x_logits, P) for r in ranks]
    # (d) compressed all-reduce against the CPU's plain arithmetic
    blocks = [torch.randn(MESH_CAR_SHAPE, generator=torch.Generator()
                          .manual_seed(300 + i)) for i in range(4)]
    want, want_codes = compressed_sum_plain(blocks)
    for r in ranks:
        check(np.array_equal(r["car"]["codes"], want_codes.numpy())
              and np.array_equal(r["car"]["result"], want.numpy()),
              f"mesh compressed_allreduce rank {r['rank']}: codes or result "
              "differ from the CPU's")
    exact = sum(blocks)
    out["car"] = {"rel_to_exact": float((want - exact).abs().max()
                                        / exact.abs().max()),
                  "collectives": ranks[0]["car"]["collectives"]}
    # (d) the one-process restore of the 2 x 2 run's checkpoint
    step = MESH_TRAIN_STEPS["smollm-135m"]
    with np.load(os.path.join(ckpt, f"step_{step}", "arrays.npz")) as z:
        saved = {k: z[k] for k in z.files}
    got = CK.restore(ckpt, step, {k: torch.empty(0, device=dev)
                                  for k in saved})
    for k, v in got.items():
        check(np.array_equal(v.cpu().numpy(), saved[k]),
              f"mesh elastic: {k} restored on one process differs")
    out["elastic"] = {"one_process": len(got),
                      **{f"rank {r['rank']}": r["elastic"] for r in ranks}}
    check(ranks[0]["elastic"]["restored_1x2"] == len(saved)
          and ranks[1]["elastic"]["restored_1x2"] == len(saved),
          "mesh elastic: the 1 x 2 mesh restored "
          f"{ranks[0]['elastic']['restored_1x2']} of {len(saved)} leaves")
    # (e) the launcher
    la = result["launch"]
    for key in ("first", "resume"):
        check(la[key]["rc"] == 0, f"mesh launcher {key}: exit "
              f"{la[key]['rc']}: {la[key]['stderr'][-800:]}")
    check("restarts=0" in la["first"]["stdout"] and "final_step=5" in
          la["first"]["stdout"], "mesh launcher: no restarts=0 at step 5: "
          + la["first"]["stdout"][-500:])
    check("resumed from step 5" in la["resume"]["stdout"]
          and "final_step=7" in la["resume"]["stdout"],
          "mesh launcher --resume did not resume at step 5: "
          + la["resume"]["stdout"][-500:])
    out["launcher"] = {k: {"seconds": v["seconds"],
                           "tail": v["stdout"].strip().splitlines()[-3:]}
                       for k, v in la.items()}
    t = time.perf_counter()
    rows = time_kernel_rows(dev, [MESH_TRAIN_NORM], [MESH_TRAIN_ATTENTION],
                            None, (), 30)
    out["kernels"] = rows
    log("mesh train kernels", t, kernel_rows_line(rows))
    out["seconds"] = time.perf_counter() - t0
    log("mesh train", t0, "4 gloo ranks, data 2 x model 2: " + "; ".join(
        f"rank {r['rank']} {r['coords']} in {r['seconds']:.2f}s (started "
        f"{r['start_s']:.2f}s after the spawn): " + ", ".join(
            f"{k}: step ms {[round(x, 1) for x in v['step_ms']]}, losses "
            f"{[round(x, 5) for x in v['losses']]}, params max |d| "
            f"{v['param_max_abs']:.3g}"
            + (" (teacher-forced; a step's |d| and the single device's "
               "own spread: " + ", ".join(
                   f"{t['max_abs']:.3g}/{t['spread']:.3g}"
                   for t in v["teacher_steps"]) + ")"
               if v["teacher_steps"] else "") + ", collectives a step "
            f"{json.dumps(v['collectives_per_step'])}, launches a step "
            f"{json.dumps(v['launches_per_step'])}"
            for k, v in r["train"].items())
        + f"; xLSTM decode {r['xlstm_decode_s']:.2f}s, elastic "
        f"{r['elastic_s']:.2f}s"
        for r in out["ranks"]) + "; single device on the card: " + ", ".join(
        f"{a} losses {[round(x, 5) for x in s['losses']]} step ms "
        f"{[round(x, 1) for x in s['step_ms']]}" for a, s in single.items())
        + f" (references {t_ref:.2f}s); xLSTM token flips "
        f"{[len(f) for f in out['xlstm_token_flips']]}; "
        f"compressed_allreduce bitwise the CPU's, "
        f"{out['car']['rel_to_exact']:.3g} "
        f"of max |exact|; elastic restore bitwise on 1 x 2 and one process "
        f"({len(saved)} leaves); launcher --distributed (NCCL, one rank) "
        + "; ".join(f"{k} {v['seconds']:.2f}s {v['tail'][-1]}"
                    for k, v in out["launcher"].items()))
    ffn_unit = next(u for u in art.graph.units if u.kind == "lowrank")
    comp = comp_checks(dev, ranks, comp_one, comp_fwd, seq_ref,
                       result["dryrun"], ffn_unit, t31)
    return (out, launches, rows_by_kernel(rows)) + comp


# ---------------------------------------------------------------------------
# 31. the compressed network at production scale: forward_compressed,
#     sharded training of a compressed net, GPipe, the dry run
# ---------------------------------------------------------------------------

#: Phase 31 (b): the compressed SmolLM-135M's batch (rows, positions) and
#: steps, trained under both ``COMP_PRESETS`` in phase 30's world (3 steps
#: in the first runs; cut to 2 when the script's total passed its 887.59 s
#: before phase 31, on a slower machine, PERF.md §4).
COMP_BATCH = (8, 256)
COMP_STEPS = 2
#: fsdp+zero: FSDP params with the optimizer-state placements as
#: ``grad_shardings``, through ``forward_compressed_spec`` (the dry run's
#: forward); tp+dp: params whole over 'data', no ``grad_shardings``,
#: through ``make_compressed_forward`` (the executor's unit loops).
COMP_PRESETS = ("fsdp+zero", "tp+dp")
#: Phase 31 (c): SmolLM-135M's 30 layers as stages of 15 on pod 2 × data
#: 2, and its microbatches (count, rows, positions; 8 rows in the first
#: runs, cut with ``COMP_STEPS``).
GPIPE_STAGES = 2
GPIPE_MICRO = (4, 4, 256)
#: Suffix of the ``kernels`` line's rows of phase 31: the kernels at a
#: rank's shapes in (b), their launches over (a)-(c).
COMP_ROW = "@compressed"


def comp_units(art):
    """``(cfg, units_spec, spec params)`` of a compressed artifact: the
    spec from its plan (``plan_units_spec``), held unit by unit to the
    graph's kinds and ranks, and the graph's tensors in the spec's tree."""
    from repro_torch.models import transformer_host as TH
    graph = art.graph
    cfg = graph.meta["config"]
    spec = TH.plan_units_spec(cfg, art.plan)
    got = [("merged", u.params["u"].shape[1]) if u.kind == "lowrank"
           else ("orig", u.sub_kind) for u in graph.units]
    want = [(s[0], s[1]) if s[0] == "merged" else ("orig", s[2])
            for s in spec]
    check(got == want, f"compressed spec {want} differs from the "
          f"artifact's units {got}")
    params = {"units": [u.params for u in graph.units], **graph.params}
    return cfg, spec, params


def comp_batches(cfg, dev) -> list:
    """``COMP_STEPS`` seeded batches as the dry run's specs lay one out:
    int32 ``positions``, ``tokens``, ``targets`` (the next token)."""
    import torch
    B, S = COMP_BATCH
    g = torch.Generator().manual_seed(31)
    out = []
    for _ in range(COMP_STEPS):
        ids = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g,
                            dtype=torch.int32)
        out.append({"positions": torch.arange(S, dtype=torch.int32)
                    .expand(B, S).contiguous().to(dev),
                    "tokens": ids[:, :-1].contiguous().to(dev),
                    "targets": ids[:, 1:].contiguous().to(dev)})
    return out


def _graph_as_spec(gp):
    """``graph_params``' tree in the spec's: ``{"units", **globals}``."""
    return {"units": gp["units"], **gp["globals"]}


def comp_single(dev, art, path) -> dict:
    """(b)'s yardstick on this card: ``make_compressed_forward``'s
    single-device steps, the final params (the spec's tree) written to
    ``path`` with a ``.done`` marker the ranks wait for."""
    import torch
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.runtime import ir
    from repro_torch.train.step import make_compressed_forward, \
        make_train_step
    from repro_torch.tree import flatten_tree

    cfg = art.graph.meta["config"]
    params = _copy_tree(ir.graph_params(art.graph))
    opt = init_opt_state(params)
    step = make_train_step(cfg, mesh_train_opt(),
                           forward_fn=make_compressed_forward(
                               art.graph, device=dev))
    losses, norms, ms = [], [], []
    for batch in comp_batches(cfg, dev):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t) * 1e3)
        norms.append(float(m["grad_norm"]))
    torch.save({"losses": losses, "norms": norms,
                "params": {k: v.cpu() for k, v in flatten_tree(
                    _graph_as_spec(params)).items()}}, path)
    open(path + ".done", "w").close()
    return {"losses": losses, "norms": norms, "step_ms": ms}


def comp_forward_check(dev, art) -> dict:
    """(a) the artifact's graph as the legacy tuple units through
    ``forward_compressed`` against ``execute``, on the card, at
    ``COMP_BATCH``: max |Δ| ≤ ``NET_RTOL`` · max |y|; the kernels each
    launched."""
    import torch
    from repro_torch import kernels
    from repro_torch.models import transformer as T
    from repro_torch.runtime import executor

    graph = art.graph
    cfg = graph.meta["config"]
    batch = comp_batches(cfg, dev)[0]
    units = [("merged", (u.params["u"], u.params["v"]))
             if u.kind == "lowrank" else
             ("orig", {"norm": u.params["norm"], "p": u.params["p"],
                       "kind": u.sub_kind}) for u in graph.units]
    with torch.no_grad():
        kernels.reset_launch_counts()
        y = T.forward_compressed(cfg, graph.params, units, batch)
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.launch_counts().items() if v}
        ref = executor.execute(graph, batch, device=dev)
    check(bool(torch.isfinite(y).all()) and tuple(y.shape) == (
        *COMP_BATCH, cfg.vocab_size), f"forward_compressed: shape "
        f"{tuple(y.shape)} or non-finite logits")
    rel = float((y - ref).abs().max() / ref.abs().max())
    check(rel <= NET_RTOL, f"forward_compressed vs execute: max |d| / max "
          f"|y| = {rel:.3g} beyond {NET_RTOL}")
    for k in ("rmsnorm", "flash_attention", "merged_ffn"):
        check(launches.get(k, 0) > 0, f"forward_compressed: {k} never "
              f"launched ({launches})")
    return {"rel": rel, "launches": launches}


def gpipe_stage_params(whole):
    """SmolLM-135M's one stacked layer group cut into ``GPIPE_STAGES``
    stages: every leaf (L, ...) as (stages, L / stages, ...)."""
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.reshape(GPIPE_STAGES,
                                        t.shape[0] // GPIPE_STAGES,
                                        *t.shape[1:]),
                    whole["groups"][0])


def gpipe_stage_fn(cfg):
    """One stage: its layers in order on a microbatch of hidden states."""
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map

    def stage(p, x):
        pos = T.default_positions(x)
        for i in range(p["norm1"].shape[0]):
            x = T._layer_fn(cfg, "attn", pos, None,
                            tree_map(lambda t: t[i], p), x)
        return x
    return stage


def gpipe_reference(dev):
    """(c)'s yardstick: SmolLM-135M's 30 layers in sequence on the whole
    pipeline input, on this card (numpy)."""
    import torch
    cfg = mesh_train_cfg("smollm-135m")
    whole, _ = mesh_train_init(cfg, dev)
    x = gpipe_input(cfg, whole, dev)
    stage = gpipe_stage_fn(cfg)
    with torch.no_grad():
        y = stage(whole["groups"][0], x)
    return y.cpu().numpy()


def gpipe_input(cfg, whole, dev):
    """The pipeline's input: the embeddings of seeded tokens, the
    microbatches end to end (count × rows, positions, D)."""
    import torch
    from repro_torch.models import transformer as T
    n, b, s = GPIPE_MICRO
    tok = torch.randint(0, cfg.vocab_size, (n * b, s), generator=torch
                        .Generator().manual_seed(310)).to(dev)
    with torch.no_grad():
        return T.embed_in(cfg, whole, {"tokens": tok})


def comp_rank(spec, mesh, dev) -> dict:
    """Phase 31 (b) and (c) in one rank of phase 30's world: the compressed
    artifact's sharded steps under ``COMP_PRESETS`` (losses, norms, step
    ms, the last step's collectives and argument bytes, the blocks held
    against the single device's), and ``gpipe_forward`` of SmolLM-135M on
    pod 2 × data 2 (its output and sends)."""
    import torch
    from repro_torch import kernels, runtime
    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.models import transformer_host as TH
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.runtime import ir
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.rules import (make_rules,
                                            param_shardings_with_shapes, put,
                                            use_rules)
    from repro_torch.train.step import make_compressed_forward, \
        make_train_step
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    art = runtime.load(spec["lm_path"], device=dev)
    cfg, units_spec, sparams = comp_units(art)
    batches = comp_batches(cfg, dev)
    out = {"train": {}, "launches": {}}
    for preset in COMP_PRESETS:
        fsdp = preset == "fsdp+zero"
        rules = make_rules(mesh, fsdp=fsdp)
        if fsdp:
            whole = sparams
            axes = TH.compressed_model_axes(cfg, units_spec)
            forward_fn = TH.spec_forward(cfg, units_spec)
        else:
            whole = ir.graph_params(art.graph)
            axes = ir.graph_axes(art.graph)
            forward_fn = make_compressed_forward(art.graph, device=dev)
        params = put(_copy_tree(whole),
                     param_shardings_with_shapes(rules, axes, whole))
        gs = param_shardings_with_shapes(
            make_rules(mesh, fsdp=True, opt_state=True), axes, whole) \
            if fsdp else None
        opt = init_opt_state(params, shardings=gs)
        step = make_train_step(cfg, mesh_train_opt(), forward_fn=forward_fn,
                               grad_shardings=gs)
        losses, norms, ms = [], [], []
        for b in batches:
            batch = put(b, {k: rules.named(("batch", "seq"), tuple(v.shape))
                            for k, v in b.items()})
            with use_rules(rules):
                arg_bytes = tree_bytes((params, opt, batch))
                C.reset_collective_counts()
                kernels.reset_launch_counts()
                torch.cuda.synchronize()
                t = time.perf_counter()
                params, opt, m = step(params, opt, batch)
                losses.append(float(m["loss"]))
                ms.append((time.perf_counter() - t) * 1e3)
                norms.append(float(m["grad_norm"]))
                coll = C.collective_counts()
            for k, v in kernels.launch_counts().items():
                if v:
                    out["launches"][k] = out["launches"].get(k, 0) + v
        final = params if fsdp else _graph_as_spec(params)
        out["train"][preset] = {
            "losses": losses, "norms": norms, "step_ms": ms,
            "collective_ops": coll, "arg_bytes": arg_bytes,
            "held": _held_blocks(final, spec["comp_ref"],
                                 spec["deadline"])}
        del params, opt, final
        torch.cuda.empty_cache()
    del art, sparams
    # (c) GPipe: SmolLM-135M (phase 30's weights) as 2 stages of 15
    cfg30 = mesh_train_cfg("smollm-135m")
    whole, _ = mesh_train_init(cfg30, dev)
    pmesh = build_mesh({"pod": GPIPE_STAGES, "data": 2}, range(4))
    x = gpipe_input(cfg30, whole, dev)
    stages = gpipe_stage_params(whole)
    idx = pmesh.index("pod")
    block = tree_map(lambda t: t[idx:idx + 1], stages)
    del whole
    C.reset_collective_counts()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    y = C.gpipe_forward(gpipe_stage_fn(cfg30), block, x, mesh=pmesh,
                        axis="pod", num_micro=GPIPE_MICRO[0])
    torch.cuda.synchronize()
    out["gpipe"] = {"y": y.cpu().numpy(), "s": time.perf_counter() - t,
                    "collective_ops": C.collective_counts(),
                    "coords": dict(pmesh.coords)}
    for k, v in kernels.launch_counts().items():
        if v:
            out["launches"][k] = out["launches"].get(k, 0) + v
    out["seconds"] = time.perf_counter() - t0
    return out


def comp_dryrun_cell(cfg, units_spec) -> dict:
    """(d)'s ``--spec``: (b)'s fsdp+zero step, the compressed SmolLM-135M
    at ``COMP_BATCH`` on data 2 × model 2."""
    import dataclasses

    from repro_torch.configs import get_config
    base = get_config("smollm-135m")
    return {"arch": "smollm-135m",
            "overrides": {f.name: getattr(cfg, f.name) for f in
                          dataclasses.fields(cfg)
                          if getattr(cfg, f.name) != getattr(base, f.name)},
            "shape": {"seq_len": COMP_BATCH[1],
                      "global_batch": COMP_BATCH[0], "mode": "train"},
            "mesh": {"data": 2, "model": 2}, "options": {"fsdp": True},
            "units_spec": [list(u) for u in units_spec]}


def comp_dryrun(cell: dict) -> dict:
    """(d) ``python -m repro_torch.launch.dryrun --spec`` on ``cell``: a
    fake world of 4, every tensor on ``meta`` (no card)."""
    path = os.path.join(WORK, "dryrun_cell.json")
    with open(path, "w") as f:
        json.dump(cell, f)
    t = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--spec", path], capture_output=True, text=True,
                       timeout=300, cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=os.path.join(ROOT,
                                                                    "src")))
    return {"rc": r.returncode, "seconds": time.perf_counter() - t,
            "stdout": r.stdout, "stderr": r.stderr[-3000:]}


def comp_checks(dev, ranks, single, fwd, seq_ref, dry, ffn_unit, t_parent):
    """Phase 31's checks after phase 30's world: (b) every rank's losses,
    norms and blocks within ``MESH_TRAIN_TOL`` of ``single``; (c) every
    rank's pipeline output within ``NET_RTOL`` · max |y| of ``seq_ref``,
    the stages' sends counted; (d) the dry run's collectives (each way)
    and argument bytes equal to rank 0's fsdp+zero step's.  Returns (the
    numbers, launches summed over (a)-(c), the ``kernels`` line's
    rows)."""
    import numpy as np
    t0 = time.perf_counter()
    out = {"forward": fwd, "single": single, "ranks": [],
           "parent_s": t_parent}
    launches = dict(fwd["launches"])
    for r in ranks:
        c = r["comp"]
        row = {"rank": r["rank"], "seconds": c["seconds"], "train": {}}
        for preset, tr in c["train"].items():
            h = tr["held"]
            rel = [abs(a - b) - MESH_TRAIN_TOL * (1 + abs(b))
                   for a, b in zip(tr["losses"] + tr["norms"],
                                   h["losses"] + h["norms"])]
            check(max(rel) <= 0, f"compressed train {preset} rank "
                  f"{r['rank']}: losses {tr['losses']} norms {tr['norms']} "
                  f"vs the single device's {h['losses']} {h['norms']}")
            check(h["excess"] <= 0, f"compressed train {preset} rank "
                  f"{r['rank']}: {h['key']} differs by {h['max_abs']:.3g}")
            row["train"][preset] = {
                "losses": tr["losses"], "norms": tr["norms"],
                "step_ms": tr["step_ms"], "param_max_abs": h["max_abs"],
                "collective_ops": tr["collective_ops"],
                "arg_bytes": tr["arg_bytes"]}
        g = c["gpipe"]
        rel = float(np.abs(g["y"] - seq_ref).max() / np.abs(seq_ref).max())
        check(rel <= NET_RTOL, f"gpipe rank {r['rank']}: max |d| / max |y| "
              f"= {rel:.3g} beyond {NET_RTOL}")
        sends = g["collective_ops"].get("collective_permute",
                                        {"calls": 0})["calls"]
        want = GPIPE_MICRO[0] + GPIPE_STAGES - 1 \
            if g["coords"]["pod"] < GPIPE_STAGES - 1 else 0
        check(sends == want, f"gpipe rank {r['rank']}: {sends} sends, not "
              f"{want}")
        row["gpipe"] = {"rel": rel, "s": g["s"], "sends": sends,
                        "collective_ops": g["collective_ops"]}
        for k, v in c["launches"].items():
            launches[k] = launches.get(k, 0) + v
        out["ranks"].append(row)
    for k in ("rmsnorm", "flash_attention", "merged_ffn"):
        check(launches.get(k, 0) > 0, f"phase 31: {k} never launched")
    # (d) the dry run of (b)'s fsdp+zero step against rank 0's
    check(dry["rc"] == 0, f"dry run --spec: exit {dry['rc']}: "
          f"{dry['stderr'][-800:]}")
    rec = json.loads(dry["stdout"].strip().splitlines()[-1])
    mine = ranks[0]["comp"]["train"]["fsdp+zero"]
    check(rec["collective_ops"] == mine["collective_ops"],
          f"dry run collectives {rec['collective_ops']} differ from rank "
          f"0's {mine['collective_ops']}")
    check(rec["memory"]["argument_size_in_bytes"] == mine["arg_bytes"],
          f"dry run argument bytes {rec['memory']} vs rank 0's "
          f"{mine['arg_bytes']}")
    out["dryrun"] = {k: rec[k] for k in ("memory", "cost", "collectives",
                                         "lower_s", "compression")}
    out["dryrun"]["seconds"] = dry["seconds"]
    from types import SimpleNamespace
    half = ffn_unit.params["u"].shape[1] // 2
    unit = SimpleNamespace(params={
        "u": ffn_unit.params["u"][:, :half].contiguous(),
        "v": ffn_unit.params["v"][:half].contiguous()})
    rows = time_kernel_rows(dev, [MESH_TRAIN_NORM], [MESH_TRAIN_ATTENTION],
                            unit, (COMP_BATCH[0] // 2 * COMP_BATCH[1],), 31)
    out["kernels"] = rows
    out["checks_s"] = time.perf_counter() - t0
    path_launches = {k: launches.get(k, 0) for k in
                     ("rmsnorm", "flash_attention", "merged_ffn")}
    log("compressed", t0, "phase 31: (a) forward_compressed vs execute "
        f"{fwd['rel']:.3g} of max |y|, launches {fwd['launches']}; (b) "
        + "; ".join(
            f"rank {r['rank']} in {r['seconds']:.2f}s: " + ", ".join(
                f"{p} step ms {[round(x, 1) for x in v['step_ms']]} "
                f"losses {[round(x, 5) for x in v['losses']]} params max "
                f"|d| {v['param_max_abs']:.3g}" for p, v in
                r["train"].items())
            + f", gpipe {r['gpipe']['rel']:.3g} of max |y| in "
            f"{r['gpipe']['s']:.2f}s ({r['gpipe']['sends']} sends)"
            for r in out["ranks"])
        + f"; single device losses "
        f"{[round(x, 5) for x in single['losses']]} step ms "
        f"{[round(x, 1) for x in single['step_ms']]} (parent's share "
        f"{t_parent:.2f}s); (d) dry run in {dry['seconds']:.2f}s: "
        f"collectives and argument bytes "
        f"({mine['arg_bytes']}) equal rank 0's, flops "
        f"{rec['cost']['flops']:.4g}; rank 0's fsdp+zero collectives a "
        f"step {json.dumps(mine['collective_ops'])}; launches over (a)-(c) "
        f"{path_launches}; "
        + kernel_rows_line(rows))
    return out, launches, rows_by_kernel(rows)


def rel_np(a, b) -> float:
    """max |a − b| / max |b| of numpy arrays."""
    import numpy as np
    return float(np.abs(a - b).max() / np.abs(b).max())


def hopper_resources(build) -> dict:
    """The bf16 attention's instances (``Cfg<DP, DV, CW>``) with their
    registers and spill bytes from ``-Xptxas -v`` (a spill fails: its
    consumers hold the accumulator in registers), and the ``HGMMA`` (wgmma)
    and ``UTMALDG`` (TMA tensor load) instructions of its library's SASS
    (``cuobjdump -sass``; 0 of either fails).  Only the lines of a library
    built in this run are there to read: a cached one reports none."""
    import re

    from repro_torch.kernels import cuda_build
    inst, cur = {}, None
    for ln in build.log.splitlines():
        m = re.search(r"Function properties for \S*CfgILi(\d+)ELi(\d+)ELi(\d+)E",
                      ln)
        if m:
            cur = "Cfg<%s,%s,%s>" % m.groups()
            inst[cur] = {}
        elif cur and "spill stores" in ln:
            inst[cur]["spill_bytes"] = int(re.search(
                r"(\d+) bytes spill stores", ln).group(1))
        elif cur and "Used" in ln and "registers" in ln:
            inst[cur]["registers"] = int(re.search(r"Used (\d+) registers",
                                                   ln).group(1))
            cur = None
    for k, v in inst.items():
        print(f"  flash_attention_bf16 {k}: {v.get('registers')} registers, "
              f"{v.get('spill_bytes')} bytes spilled", flush=True)
        check(v.get("spill_bytes", 0) == 0,
              f"flash_attention_bf16 {k} spills {v['spill_bytes']} bytes")
    check(build.cached or len(inst) == 7, f"flash_attention_bf16: "
          f"{len(inst)} instances in ptxas's output (want 7)")
    sass = subprocess.run([os.path.join(os.path.dirname(cuda_build._nvcc()),
                                        "cuobjdump"), "-sass",
                           str(build.path)], capture_output=True, text=True,
                          timeout=120).stdout
    ops = {op: len(re.findall(r"\b" + op + r"\b", sass))
           for op in ("HGMMA", "UTMALDG")}
    check(all(ops.values()), f"flash_attention_bf16: SASS {ops} (wgmma and "
          "TMA loads expected)")
    return {"instances": inst, "sass": ops}


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
              "is False", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch import kernels, runtime
        from repro_torch.compress import build_host, main as compress_main
        from repro_torch.core import WallClockOracle, compress
        from repro_torch.core.plan import identity_plan
        from repro_torch.device import resolve
        from repro_torch.kernels import cuda_build
    except ImportError as e:
        print(f"{IMPORT_ERROR} ({e})", file=sys.stderr)
        return 2
    if argv[:1] == ["--eq4-child"]:          # phase 21 (e)'s crashed child
        eq4_journal_build(argv[1], resolve("cuda"))
        print("CHILD_COMPLETED")               # only reached if not killed
        return 0
    quick = "--quick" in argv
    os.makedirs(WORK, exist_ok=True)
    t_all = time.perf_counter()

    # 1. card ------------------------------------------------------------------
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0].strip() if smi else "nvidia-smi: no output"
    dev = resolve("cuda")
    name = torch.cuda.get_device_name(0)
    log("card", t0, f"{name} | {smi_line} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | tf32 cudnn="
        f"{torch.backends.cudnn.allow_tf32} matmul="
        f"{torch.backends.cuda.matmul.allow_tf32}")

    # 2. build -----------------------------------------------------------------
    t0 = time.perf_counter()
    builds = cuda_build.build()
    for b in builds.values():
        res = [ln.strip() for ln in b.log.splitlines()
               if "registers" in ln or "spill" in ln or "smem" in ln]
        print(f"  {b.name}: {b.seconds:.1f}s cached={b.cached} "
              f"{' | '.join(res)}", flush=True)
    hopper = hopper_resources(builds["flash_attention_bf16"])
    log("build", t0, f"{len(builds)} kernels; flash_attention_bf16 "
        f"{json.dumps(hopper)}")

    # 3. kernel sweep -----------------------------------------------------------
    t0 = time.perf_counter()
    sweep = kernel_sweep(dev)
    sweep["merged_ffn"] = ffn_sweep(dev)
    sweep.update(qkernel_sweep(dev))
    conv_inst = conv_instance_sweep(dev)
    for k, v in conv_inst.items():
        sweep[k] = [max(sweep[k][0], v[0]), max(sweep[k][1], v[1]),
                    sweep[k][2] + v[2]]
    sweep["merged_ffn_q"] = qffn_sweep(dev)
    sweep.update(ffn_partial_sweep(dev))
    sweep.update(norm_scan_attention_sweep(dev))
    sweep.update(bf16_sweep(dev))
    n_q = quantize_matches_cpu(dev)
    n_det = ffn_determinism(dev)
    n_det_ad = attn_dw_determinism(dev)
    n_det_conv = conv_determinism(dev)
    grads = gradient_sweep(dev)
    slots, slots_model = ffn_slots()
    log("kernels", t0, json.dumps(
        {k: {"cases": v[2], "max_abs_err": v[0], "max_rel_err": v[1]}
         for k, v in sweep.items()}) + f"; quantize_int8 card == CPU "
        f"bitwise on {n_q} inputs; merged_ffn bitwise run to run on "
        f"{n_det} inputs, flash_attention and depthwise_conv on "
        f"{n_det_ad}, merged_conv (fp32 and w8a8) on {n_det_conv} "
        f"(instance cases {json.dumps({k: v[2] for k, v in conv_inst.items()})}"
        f"); gradients through the kernel ops vs the plain versions' "
        f"autograd {json.dumps({k: {'cases': v[2], 'max_abs_err': v[0], 'max_rel_err': v[1]} for k, v in grads.items()})}"
        f"; merged_ffn resident blocks by cluster size "
        f"{json.dumps(slots)} ("
        + ("launch_plan's model" if slots_model else "NOT launch_plan's "
           "H100_SLOTS: its splits are planned for another card") + ")")
    if quick:
        print(smi_line)
        return 0

    # 4. main path: compress ----------------------------------------------------
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    art_path = os.path.join(WORK, "mobilenetv2.npz")
    argv_c = ["--arch", "mobilenetv2", "--oracle", "wallclock",
              "--max-span", "6", "--budget-ratio", "0.6", "--batch", "8",
              "--out", art_path]
    # One oracle times each MobileNetV2 signature once, for this phase and
    # the quantized compress of phase 11.
    cnn_oracle = WallClockOracle()
    summary = compress_main(argv_c, latency_oracle=cnn_oracle)
    check_probes(cnn_oracle, summary, "mobilenetv2 compress")
    log("compress", t0, f"plan: {summary['segments']} segments, "
        f"{summary['kept_layers']}/{summary['layers']} layers kept, "
        f"{summary['latency_probes']} probes in "
        f"{summary['latency_signatures']} signatures, "
        f"{summary['signatures_timed']} timed on the card, predicted "
        f"speedup {summary['predicted_speedup']:.4f}")

    # 5. serve -----------------------------------------------------------------
    t0 = time.perf_counter()
    art = runtime.load(art_path, device="cuda")
    census = runtime.count_units(art.graph)
    gen = torch.Generator().manual_seed(1234)
    batches = [torch.randn(8, 224, 224, 3, generator=gen) for _ in range(3)]
    cnn_h, _ = build_host("mobilenetv2", seed=0, batch=8, max_span=6,
                          device="cuda")
    held5 = cnn_card_check("mobilenetv2", art,
                           runtime.load(art_path, device="cpu"), cnn_h,
                           batches, (8, 1000))
    d_cpu, d_rep = held5["vs_cpu"], held5["vs_replaced"]
    orig_graph = cnn_h.lower_plan(identity_plan(cnn_h.net.L, cnn_h.descs()))
    xb = batches[0].to(dev)
    ms_merged = cuda_time(lambda: art.apply(xb), iters=20)
    ms_orig = cuda_time(lambda: runtime.execute(orig_graph, xb), iters=20)
    # the same forwards as device time (CUDA-graph replays, as the tables
    # time each segment): eager dispatch leaves the card mostly idle, so
    # the CUDA-event times measure the host as much as the card
    dev_merged, dev_orig = replay_ms(
        lambda: art.apply(xb), lambda: runtime.execute(orig_graph, xb))
    busy_us, busy_rows = device_kernels(lambda: art.apply(xb))
    launches = kernels.launch_counts()
    kernels.reset_launch_counts()
    art.apply(xb)
    per_forward = kernels.launch_counts()
    log("serve", t0, f"units {census}; {len(batches)} batches, worst logits "
        f"vs CPU port {d_cpu:.3g}, vs apply_replaced {d_rep:.3g} (limit "
        f"{NET_RTOL}); batch-8 forward "
        f"original {ms_orig:.3f} ms, merged {ms_merged:.3f} ms "
        f"({ms_orig / ms_merged:.3f}x); device time (CUDA graph) original "
        f"{dev_orig:.4f} ms, merged {dev_merged:.4f} ms "
        f"({dev_orig / dev_merged:.3f}x, predicted "
        f"{summary['predicted_speedup']:.4f}x); launches phases 4-5 "
        f"{launches}, per "
        f"merged forward {per_forward}")
    if busy_rows:
        print(f"  merged forward, torch.profiler: device busy {busy_us:.1f} "
              f"us per forward = {busy_us / (ms_merged * 1e3):.3f} of its "
              "CUDA-event time; by kernel: " + "; ".join(
                  f"{name[:60]} {us:.1f}us x{n}"
                  for us, n, name in busy_rows[:8]), flush=True)
    else:
        print("  merged forward, torch.profiler: no device activity seen "
              "(busy share not measured)", flush=True)
    for k in ("merged_conv", "depthwise_conv"):
        check(launches[k] > 0, f"kernel {k} never launched on the main path")

    # 6. main-path kernels ------------------------------------------------------
    t0 = time.perf_counter()
    tot = time_main_path_kernels(art.graph, dev, 8)
    # what the cold-L2 protocol charges the smallest kernel: one launch
    # that writes one element
    one = torch.zeros(1, device=dev)
    floor_ms = kernel_time(one.zero_)
    tot["merged_conv"]["floor_ms"] = floor_ms
    with open(os.path.join(WORK, "units.json"), "w") as f:
        json.dump(tot, f, indent=1)
    log("main-path kernels", t0, f"timing floor (a one-element fill) "
        f"{floor_ms:.4f} ms; " + " ".join(
        f"{k}: {v['units']} units ms={v['ms']:.4f} plain={v['plain_ms']:.4f} "
        f"library={v['library_ms']:.4f} bound={v['bound_ms']:.4f} "
        f"({v['bound_rate']}); units slower than the library "
        f"{sum(r['ms'] > r['library_ms'] for r in v['rows'])};"
        for k, v in tot.items()))

    # 7. resnet34 -----------------------------------------------------------------
    t0 = time.perf_counter()
    r_path = os.path.join(WORK, "resnet34.npz")
    r_sum = compress_main(["--arch", "resnet34", "--oracle", "analytic",
                           "--budget-ratio", "0.6", "--batch", "8",
                           "--out", r_path])
    r_sec = time.perf_counter() - t0
    r_art = runtime.load(r_path, device="cuda")
    units = r_art.graph.units
    check(any(u.kind == "pool" for u in units), "resnet34: no pool unit")
    check(any("proj" in u.params for u in units if u.kind == "conv"),
          "resnet34: no projection shortcut")
    check(any(u.kind == "conv" and u.params["w"].shape[0] >= 7
              and u.stride == 2 for u in units), "resnet34: no K>=7 s2 unit")
    xr = torch.randn(2, 224, 224, 3, generator=gen)
    kernels.reset_launch_counts()
    yr = r_art.apply(xr.to(dev))
    torch.cuda.synchronize()
    r_launch = kernels.launch_counts()
    yr_cpu = runtime.load(r_path, device="cpu").apply(xr)
    d_r = float((yr.cpu() - yr_cpu).abs().max() / yr_cpu.abs().max())
    log("resnet34", t0, f"units {runtime.count_units(r_art.graph)}; logits "
        f"vs CPU port {d_r:.3g}; launches {r_launch}")
    check(bool(torch.isfinite(yr).all()), "resnet34: non-finite logits")
    check(d_r <= NET_RTOL, f"resnet34: card vs CPU port differ by {d_r}")
    # its merged_conv units at batch 8, against cuDNN: 3x3 and larger
    # merged kernels, where operations bound the kernel
    t0 = time.perf_counter()
    r_tot = time_main_path_kernels(r_art.graph, dev, 8, plain=False,
                                   label="resnet34 ")["merged_conv"]
    with open(os.path.join(WORK, "resnet34.json"), "w") as f:
        json.dump(r_tot, f, indent=1)
    log("resnet34 units", t0, f"merged_conv: {r_tot['units']} units "
        f"ms={r_tot['ms']:.4f} library(cuDNN)={r_tot['library_ms']:.4f} "
        f"bound={r_tot['bound_ms']:.4f} ({r_tot['bound_rate']}); by unit "
        "(w, ms, cuDNN ms, share): " + "; ".join(
            f"{r['w']} s{r['stride']} {r['ms']:.4f} {r['library_ms']:.4f} "
            f"{r['share']:.3f}" for r in r_tot["rows"]))
    # 7 (b). the same compress on tables timed on the card
    t0 = time.perf_counter()
    r_wc = resnet34_wallclock(dev, compress_main, {
        "summary": r_sum, "seconds": r_sec, "plan": plan_segments(
            r_art.plan), "line": plan_line(r_art.plan), "art": r_art}, xr)
    r_wc["seconds"] = time.perf_counter() - t0
    with open(os.path.join(WORK, "resnet34_wallclock.json"), "w") as f:
        json.dump(r_wc, f, indent=1)
    log("resnet34 wallclock", t0, f"phase 7 (b) in {r_wc['seconds']:.2f}s")

    # 8. transformer compress ---------------------------------------------------
    from repro_torch.models import transformer as T
    from repro_torch.runtime import serving

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    # SmolLM-135M at full width in fp32 (30 layers, d 576, 9/3 heads,
    # SwiGLU 1536, vocab 49152, tied embeddings), costed and probed at
    # batch 8 x seq 128
    host, lm_source = build_host("smollm-135m", seed=0, batch=8, seq=128,
                                 full=True, device="cuda")
    t_init = time.perf_counter() - t0
    # Start at 0.6, where the analytic model merges 20 FFNs.  Tables timed
    # on the card decide what fits: depth compression can only replace
    # FFN sublayers, so the tightest budget it meets is bounded by the
    # attention sublayers' share.  One oracle times each signature once
    # for every rung; the first rung whose plan merges an FFN is served.
    oracle = WallClockOracle()
    res, ladder = None, []
    for ratio in LM_BUDGETS:
        r = compress(host, budget_ratio=ratio, method="depth",
                     latency_oracle=oracle, probe_config=strict_probes())
        n_lr = 0 if r is None else \
            runtime.count_units(r.lower()).get("lowrank", 0)
        ladder.append(f"{ratio}: " + ("infeasible" if r is None else
                                      f"{n_lr} lowrank, predicted speedup "
                                      f"{r.speedup:.4f}"))
        if n_lr:
            res, budget = r, ratio
            break
    print("  signature timings (device, CUDA graph): " + "; ".join(
        f"{sig[1]} rank {sig[2]} {sec * 1e3:.4f} ms"
        for sig, sec in oracle.measured.items()), flush=True)
    check(res is not None, f"smollm-135m depth: no budget in {LM_BUDGETS} "
          f"gives a plan with a lowrank unit ({'; '.join(ladder)})")
    lm_path = os.path.join(WORK, "smollm135m_depth.npz")
    res.save(lm_path, extra_meta={"source": lm_source})
    build_launches = kernels.launch_counts()
    graph = res.lower()
    n_lowrank = runtime.count_units(graph).get("lowrank", 0)
    st = res.tables.stats
    lm_res = compress(host, budget_ratio=0.6, method="layermerge",
                      latency_oracle=oracle, probe_config=strict_probes())
    lm_census = unit_census(host.lower_plan(lm_res.plan)) \
        if lm_res is not None else "infeasible"
    log("lm compress", t0, f"smollm-135m fp32 full width (init "
        f"{t_init:.2f}s), depth budgets {'; '.join(ladder)}; served depth "
        f"{budget}: {len(res.plan.segments)} segments, units "
        f"{unit_census(graph)}, {st.num_latency_probes} probes in "
        f"{st.num_latency_buckets} signatures, predicted speedup "
        f"{res.speedup:.4f}; {len(oracle.measured)} signatures timed on "
        f"the card for every plan of this phase; table builds' "
        f"launches {build_launches}; layermerge 0.6 (tables timed in this "
        f"run): units {lm_census}" + (
            f", predicted speedup {lm_res.speedup:.4f}" if lm_res else ""))
    check(n_lowrank >= 1, "depth plan has no lowrank unit")
    check(build_launches["merged_ffn"] > 0,
          "merged_ffn never launched in the table build")

    # 9. transformer serve ------------------------------------------------------
    t0 = time.perf_counter()
    lm_art = runtime.load(lm_path, device="cuda")
    cfg = lm_art.graph.meta["config"]
    B, P, N = 8, 16, 32
    prompt = serving.random_prompts(7, B, P, cfg.vocab_size, device=dev)

    def c_step(c, t):
        return lm_art.decode(c, t)

    def o_step(c, t):
        return T.decode_step(cfg, host.params, c, {"tokens": t})
    c_pre, c_dec, c_logits, seqs, c_serve = serve_both(
        "compressed", c_step, lambda: lm_art.init_cache(B, P + N), prompt, N)
    o_pre, o_dec, _, _, o_serve = serve_both(
        "original", o_step, lambda: T.init_cache(cfg, B, P + N, device=dev),
        prompt, N)
    lm_launches = kernels.launch_counts()
    check(tuple(seqs.shape) == (B, N), f"served ids {tuple(seqs.shape)}")
    # every step's logits, teacher-forced with the card's own tokens, on
    # the card and on the CPU port of the same artifact
    fed = torch.cat([prompt, seqs[:, :-1]], dim=1)
    lg = forced_logits(c_step, lm_art.init_cache(B, P + N), fed)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(lg).all()), "non-finite served logits")
    check(bool((lg[:, P - 1:].argmax(-1) == seqs).all()),
          "served ids are not the argmax of the teacher-forced logits")
    d_fed = float((lg[:, P - 1] - c_logits).abs().max()
                  / c_logits.abs().max())
    check(d_fed <= 1e-6, f"prefill logits of serve_loop and the forced run "
          f"differ by {d_fed}")
    lm_cpu = runtime.load(lm_path, device="cpu")
    lg_cpu = forced_logits(lambda c, t: lm_cpu.decode(c, t),
                           lm_cpu.init_cache(B, P + N), fed.cpu())
    d_steps = ((lg.cpu() - lg_cpu).abs().amax(dim=(0, 2))
               / lg_cpu.abs().amax(dim=(0, 2)))
    d_lm_cpu, d_last = float(d_steps.max()), float(d_steps[-1])
    y_merged = lm_art.apply({"tokens": prompt})
    fn, p = host.replaced_apply(res.plan)
    y_rep = fn(p, {"tokens": prompt})
    d_lm_rep = float((y_merged - y_rep).abs().max() / y_rep.abs().max())
    per_step = c_serve["launches_per_step"].get("merged_ffn", 0)
    steps = N - 1
    log("lm serve", t0, f"{B} prompts x {P} tokens, {N} new; worst step "
        f"logits vs CPU port {d_lm_cpu:.3g} (last step {d_last:.3g}), "
        f"prefill vs replaced_apply {d_lm_rep:.3g} (limit {NET_RTOL}); "
        f"compressed prefill {c_pre * 1e3:.3f} ms, decode {c_dec * 1e3:.3f} "
        f"ms ({serving.decode_tok_s(steps, B, c_dec):.1f} tok/s); original "
        f"prefill {o_pre * 1e3:.3f} ms, decode {o_dec * 1e3:.3f} ms "
        f"({serving.decode_tok_s(steps, B, o_dec):.1f} tok/s); decode "
        f"speedup {o_dec / c_dec:.3f}x (predicted {res.speedup:.4f}x); "
        f"merged_ffn launches per decode step {per_step} (counted at the "
        f"capture); phases 8-9 launches {lm_launches}")
    serve_rows = {"smollm-135m compressed": c_serve,
                  "smollm-135m original": o_serve}
    check(d_lm_cpu <= NET_RTOL, f"lm card vs CPU port differ by {d_lm_cpu}")
    check(d_lm_rep <= NET_RTOL, f"lm merged vs replaced differ by {d_lm_rep}")
    check(lm_launches["merged_ffn"] > 0,
          "merged_ffn never launched on the transformer path")

    # 10. merged_ffn at the path's shapes ----------------------------------------
    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(3)
    ffn_units = [u for u in lm_art.graph.units if u.kind == "lowrank"]
    d_model = cfg.d_model
    x8 = torch.randn(B, d_model, generator=g).to(dev)
    x1024 = torch.randn(8 * 128, d_model, generator=g).to(dev)
    per_unit = [time_ffn(x8, u.params["u"], u.params["v"])
                for u in ffn_units]
    probe = time_ffn(x1024, ffn_units[0].params["u"],
                     ffn_units[0].params["v"])
    step_tot = {k: sum(r[k] for r in per_unit)
                for k in ("ms", "plain_ms", "library_ms", "flops_ms",
                          "bytes_ms", "bound_ms")}
    step_tot["max_abs_err"] = max(r["max_abs_err"] for r in per_unit)
    step_tot["bound_rate"] = per_unit[0]["bound_rate"]
    split = host_split(x8, ffn_units[0].params["u"], ffn_units[0].params["v"])
    with open(os.path.join(WORK, "ffn.json"), "w") as f:
        json.dump({"decode_units": per_unit, "decode_step": step_tot,
                   "probe_m1024": probe, "host_us_m8": split}, f, indent=1)
    d1 = per_unit[0]
    log("merged_ffn shapes", t0, " ".join(
        f"M={r['m']} D={r['d']} R={r['r']}: ms={r['ms']:.4f} (eager "
        f"call {r['eager_ms']:.4f}, host {r['host_us']:.1f} us a call) "
        f"plain={r['plain_ms']:.4f} "
        f"library(addmm, 2 cuBLAS calls)="
        f"{r['library_ms']:.4f} bound={r['bound_ms']:.5f} ("
        f"{'bytes' if r['bytes_ms'] >= r['flops_ms'] else 'operations'}, "
        f"share {r['bound_ms'] / r['ms']:.3f});" for r in (d1, probe))
        + f" decode step ({len(per_unit)} units): ms={step_tot['ms']:.4f} "
        f"plain={step_tot['plain_ms']:.4f} "
        f"library={step_tot['library_ms']:.4f} "
        f"bound={step_tot['bound_ms']:.5f}; host us a call at M=8 by layer: "
        + json.dumps({k: round(t, 1) for k, t in split.items()}))
    tot["merged_ffn"] = step_tot
    launches["merged_ffn"] = lm_launches["merged_ffn"]

    # 11-12. the quantized CNN path ---------------------------------------------
    q_tot, q_launch = cnn_quant_phases(
        compress_main, ["--arch", "mobilenetv2", "--oracle", "wallclock",
                        "--max-span", "6", "--batch", "8"],
        cnn_oracle, cnn_h, batches, orig_graph, dev, (8, 1000))
    tot.update(q_tot)
    launches.update({k: q_launch[k] for k in q_tot})

    # 13-14. the quantized transformer path -------------------------------------
    tot["merged_ffn_q"], lq_launch, serve_rows["smollm-135m w8a8"] = \
        lm_quant_phases(host, res, oracle, lm_source, prompt, N, c_dec, dev)
    launches["merged_ffn_q"] = lq_launch["merged_ffn_q"]

    # 15-17. RecurrentGemma-2B ----------------------------------------------------
    rg_rows, rg_launch, rg_art, rg_serve = rg_phases(dev)
    serve_rows.update(rg_serve)

    # 18. ragged requests through the slot scheduler ----------------------------
    lm_arts = (("smollm-135m", lm_art, 24), ("recurrentgemma-2b", rg_art, 8))
    req_rows, solos = request_phase(dev, lm_arts)

    # 19. the continuous engine ----------------------------------------------
    cont_rows = continuous_phase(lm_arts, solos, req_rows)
    del rg_art, lm_arts
    with open(os.path.join(WORK, "serve.json"), "w") as f:
        json.dump({"loops": serve_rows, "requests": req_rows,
                   "continuous": cont_rows}, f, indent=1)
    for k in ("rmsnorm", "rglru_scan", "flash_attention"):
        tot[k] = next(r for r in rg_rows if r["kernel"] == k)
        launches[k] = rg_launch[k]
    # 20. Eq. 4 importance ------------------------------------------------------
    eq4 = importance_phase(dev, cnn_h, cnn_oracle, art.plan, dev_orig, host,
                           oracle, budget, prompt, N)
    with open(os.path.join(WORK, "importance.json"), "w") as f:
        json.dump(eq4, f, indent=1, default=str)
    # 21. the crash-safe table build --------------------------------------------
    t0 = time.perf_counter()
    tab, tab_launch = table_phase(dev, cnn_h, host, budget)
    tab["seconds"] = time.perf_counter() - t0
    with open(os.path.join(WORK, "tables.json"), "w") as f:
        json.dump(tab, f, indent=1, default=str)
    log("tables", t0, f"launches {tab_launch}")
    for k in ("merged_conv", "depthwise_conv", "merged_ffn", "rmsnorm",
              "flash_attention"):
        launches[k] += tab_launch[k]
    # 22. the DDPM UNet ---------------------------------------------------------
    t0 = time.perf_counter()
    unet, unet_tot, unet_launch = unet_phase(dev, compress_main)
    unet["seconds"] = time.perf_counter() - t0
    with open(os.path.join(WORK, "unet.json"), "w") as f:
        json.dump(unet, f, indent=1, default=str)
    log("unet", t0, f"phase 22 in {unet['seconds']:.2f}s")
    # 23. the reference's other transformer families ---------------------
    archs, arch_launch, arch_tot = arch_phase(dev, build_host)
    with open(os.path.join(WORK, "archs.json"), "w") as f:
        json.dump(archs, f, indent=1, default=str)
    # 24. LM training -------------------------------------------------------
    trn, trn_launch, trn_tot = train_phase(dev, lm_path)
    with open(os.path.join(WORK, "train.json"), "w") as f:
        json.dump(trn, f, indent=1, default=str)
    # the scan's backward: its row timed in phase 17, its launches those
    # of phase 24's training steps (the path that takes gradients)
    tot["rglru_scan_bwd"] = next(r for r in rg_rows
                                 if r["kernel"] == "rglru_scan_bwd")
    launches["rglru_scan_bwd"] = trn_launch["rglru_scan_bwd"]
    # 25. the distributed table build -----------------------------------------
    # phase 24's state is freed: the workers' own contexts and probe
    # buffers share the card
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dist, dist_launch = dist_phase(dev, tab["a"]["timings"], art.plan)
    with open(os.path.join(WORK, "dist.json"), "w") as f:
        json.dump(dist, f, indent=1, default=str)
    log("dist", t0, f"phase 25 in {dist['seconds']:.2f}s; the workers' "
        f"launches {dist_launch}")
    for k, v in dist_launch.items():
        launches[k] += v
    # 26. the published configs at their own dtype (bf16) ---------------------
    bf16, bf16_launch, bf16_tot = bf16_phase(dev, serve_rows, trn)
    with open(os.path.join(WORK, "bf16.json"), "w") as f:
        json.dump(bf16, f, indent=1, default=str)
    # 29. sharded serving on a ('data', 'model') mesh ---------------------------
    gc.collect()
    torch.cuda.empty_cache()
    mesh, mesh_launch = mesh_phase(dev, {"prompt": prompt, "seqs": seqs,
                                         "logits": c_logits})
    with open(os.path.join(WORK, "mesh.json"), "w") as f:
        json.dump(mesh, f, indent=1, default=str)
    for k, v in mesh_launch.items():
        if k in launches:
            launches[k] += v
    # 30. sharded training on a ('data', 'model') mesh -----------------------
    gc.collect()
    torch.cuda.empty_cache()
    # 31. the compressed network: forward_compressed, sharded training,
    # GPipe, the dry run (in phase 30's world) -----------------------------
    (mtrain, mtrain_launch, mtrain_tot, comp, comp_launch,
     comp_tot) = mesh_train_phase(dev, lm_path)
    with open(os.path.join(WORK, "mesh_train.json"), "w") as f:
        json.dump(mtrain, f, indent=1, default=str)
    with open(os.path.join(WORK, "compressed.json"), "w") as f:
        json.dump(comp, f, indent=1, default=str)
    sweep_err = {k: v[0] for k, v in sweep.items()}
    for k, v in bf16_tot.items():
        tot[k] = v
        launches[k] = bf16_launch[k]
    srcs = dict(KERNEL_SOURCES)
    for k, v in unet_tot.items():
        if v["units"]:
            tot[k + UNET_ROW] = v
            launches[k + UNET_ROW] = unet_launch[k]
            sweep_err[k + UNET_ROW] = sweep_err[k]
            srcs[k + UNET_ROW] = srcs[k]   # the same kernel, other shapes
    for row, rows_tot, row_launch in ((ARCH_ROW, arch_tot, arch_launch),
                                      (TRAIN_ROW, trn_tot, trn_launch),
                                      (MESH_TRAIN_ROW, mtrain_tot,
                                       mtrain_launch),
                                      (COMP_ROW, comp_tot, comp_launch)):
        for k, v in rows_tot.items():
            tot[k + row] = v
            launches[k + row] = row_launch[k]
            sweep_err[k + row] = sweep_err[k]
            srcs[k + row] = srcs[k]

    line = {"kernels": [{
        "name": k, "route": "cuda", "source": srcs[k][0],
        "replaces": srcs[k][1], "launches": launches[k],
        "max_abs_err": max(v["max_abs_err"], sweep_err[k]),
        "ms": v["ms"], "plain_ms": v["plain_ms"],
        "bound_ms": v["bound_ms"],
        "bound_by": "bytes" if v["bytes_ms"] >= v["flops_ms"]
        else "operations", "bound_rate": v.get("bound_rate", FFMA_RATE),
        "library_ms": v["library_ms"],
        **({"library_fp32_ms": v["library_fp32_ms"]}
           if "library_fp32_ms" in v else {})} for k, v in tot.items()]}
    for v in line["kernels"]:
        check_bound(v["name"], v["ms"], v["bound_ms"])
    with open(os.path.join(WORK, "phases.json"), "w") as f:
        json.dump(PHASE_SECONDS, f, indent=1)
    print("[phases] " + json.dumps(PHASE_SECONDS), flush=True)
    print(f"[total] {time.perf_counter() - t_all:.2f}s", flush=True)
    print(json.dumps(line))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
