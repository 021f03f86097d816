#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch/`) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build   -- compile the eight CUDA sources of `src/repro_torch/csrc/`
                (one nvcc per source, all started together), print
                ptxas's registers and spills per kernel, and count each
                flash kernel's tensor-core instructions (HMMA) and the
                XNOR GEMM's (IMMA) in their SASS: the bfloat16 forward,
                dkv and dq kernels and the GEMM must have some, the
                float32 flash kernels none ("sass" lines);
  2. kernels -- hold each kernel against its plain torch version on the
                card at the main paths' shapes plus a ragged shape (exact
                equality for the integer kernels; flash attention's float32
                output at the reference test's 2e-5, its bfloat16 output
                within about one bfloat16 ulp), and time kernel, plain
                version and, where one exists, one PyTorch call computing
                the same function (`torch._int_mm` on the +-1 int8
                operands for the GEMM, at its decode, prefill and FFN
                shapes, and a float32 matmul beside it; SDPA for flash
                attention); the sign packer at the FFN pair's and the
                packed weights' float32 shapes, the served bfloat16
                activations (decode [4, K], prefill [1024, K]), ragged K
                and views one element in (the scalar path), beside an
                empty kernel's launch (`launch_floor_ms`), after a
                warm-up graph of the first shape; the AAP
                interpreter on its packed stream
                at the serving decode shape (K=128, one full DRIM-R wave),
                the bulk phase's K=32 dot (one wave), the TMR stream
                fault-free over 4 waves and a ragged soup,
                against the plain replay and its plain twin ("detail"
                lines with slots, words_per_thread, block_cols and
                smem_bound_ms);
                the fault-injecting interpreter on its packed stream
                (stuck rows folded in) at the TMR-hardened K=128 stream
                over 4 DRIM-R waves and at a ragged shape with stuck
                rows, protected ops and a bank offset, against the plain
                replay and the packed twin (its slots, words_per_thread
                and smem_bound_ms); the bulk bit-wise kernels (not, the binary and
                the ternary ops), the bit-plane adder and the sign
                unpacker exactly, at the bulk phase's shapes and at ragged
                ones (a length no block divides, a start one word off
                16-byte alignment, empty tensors, 1 and 33 planes), the
                unpacker on the drim-bnn FFN weights packed by the pack
                kernel, in float32, bfloat16 and int8; the flash
                backward kernels (dkv, dq) at the training shape and the
                forward's other cases (float32 at the reference test's
                2e-4, bfloat16 within about one bfloat16 ulp), and at the
                train-families phase's attention shapes (llava-next-34b
                q [1, 56, 3072, 128] n_rep 7, zamba2 [4, 32, 512, 64],
                whisper-medium [4, 16, 256, 64]), with SDPA's
                backward as their yardstick; forward and backward also at
                the training shape and the bfloat16 tensor-core kernels'
                edges (FLASH_BF16_EDGES), the forward also at the families
                phase's prefills (zamba2 [4, 32, 512, 64], n_rep 1;
                qwen3-14b [4, 40, 256, 128] over 8 KV heads, n_rep 5;
                kimi-k2 [4, 64, 256, 128] over 8 KV heads, n_rep 8;
                whisper-medium's decoder [4, 16, 256, 64], n_rep 1;
                llava-next-34b [4, 56, 3072, 128] over 8 KV heads, n_rep
                7), and both, with the GEMM, at the tp phase's rank
                blocks (flash q [8, 6, 256, 64] forward and backward, [4,
                6, 256, 64] and [4, 20, 256, 128] forward; kimi-k2's [4,
                32, 256, 128]; zamba2's [4, 16, 512, 64] forward and
                backward, llava's [4, 28, 3072, 128] forward and [1, 28,
                3072, 128] forward and backward, n_rep 7; the GEMM's
                gate/up columns and down's output block at decode and
                prefill rows), a "detail" line each;
  3. path    -- one drim-bnn FFN BitLinear pair at full width (768 -> 3072
                -> 768) on M = 512 activation rows, weights from a seeded
                numpy generator, each projection served by the native
                packed route (pack + XNOR-GEMM kernels) and by the DRIM
                route (AAP interpreter kernel on the DRIM-R fleet); the
                int32 dots of both routes must equal the plain reference
                computed on the CPU, and the float outputs must agree;
  4. serve   -- the drim-bnn LM at full width and depth (12 layers,
                seeded weights) through `repro_torch.launch.serve`: batch
                4, a 256-token prompt (flash prefill), 8 greedy tokens, on
                the native dense route, the native packed route (with its
                bit-exactness check) and the DRIM packed route ("cuda"
                engine); the token ids must be identical across the three.
                Then `run_continuous` with prompts of 256 and 200 tokens
                (the second takes the dense-scores attention) into 2
                slots, native packed and DRIM packed, with identical
                tokens per request;
  4b. families -- the SSM, hybrid, dense, MoE, audio and vlm families at
                full width through `run_serve` on the "gpu" route under
                its default `--mesh host` (a 1x1 mesh of the card), seeded
                weights, batch 4, 8 greedy tokens: mamba2-130m at its 24
                layers (a 1024-token prompt, 4 SSD chunks), zamba2-1.2b at
                its 38 (512 tokens, 2 chunks; the shared attention block at
                its 6 group sites), qwen3-14b at full width cut from 40
                layers to 2 (256 tokens; GQA n_rep 5 at d_head 128),
                deepseek-v3-671b and kimi-k2-1t-a32b at full width cut from
                61 layers to 1 (256 tokens; 256 experts top-8 behind MLA,
                which takes dense scores; 384 experts top-8 behind GQA
                n_rep 8 at d_head 128), whisper-medium at its 24 + 24
                layers over 1500 zero frames (256 tokens; the decoder's
                self-attention on flash, the encoder and the
                cross-attention on dense scores), llava-next-34b at full
                width cut from 60 layers to 2 (a 3072-token prompt whose
                first 2880 positions are zero patch embeddings; GQA n_rep
                7 at d_head 128); each leg's host weight
                draw (init_s), prefill_s, decode tok/s and p50/p99 (host
                clock), every logits tensor finite and every token id
                inside the vocabulary, and after each, outside its count,
                3 decode steps under `torch.profiler` (device ms and
                launches a step, the idle share of the p50 step); the
                full-width deepseek-v3 decode step run twice, bitwise
                equal logits (the deterministic combine); the MoE legs'
                prefill takes the expert-parallel dispatch with one model
                shard (a spy), and beside each, with the same weights and
                prompt, the prefill runs three ways in one counted leg:
                under the host mesh (EP x1), with no mesh (grouped) and
                under a 1x8 mesh of the card (EP x8: 32 and 48 experts a
                shard), EP x1 bitwise equal to grouped in logits and
                caches, each EP x8 logit within a bf16 ulp
                (EP_LOGIT_RTOL) of its own value plus the logits' RMS,
                under a quarter of them moved
                (EP_MOVED_MAX) and the same greedy tokens save at an
                exact tie, two planted faults (shard 0's partial
                dropped, and added twice) failing that check, the
                three times printed ("families" "mesh" lines); then
                two mamba2
                requests (1024 and 512 tokens) through the continuous
                batcher, which must refuse zamba2 as the reference's does;
                then the float32 smoke configs of mamba2, zamba2,
                deepseek-v3, kimi-k2, whisper-medium and llava-next-34b
                (seeded patch embeddings) prefilled on the card and on
                the CPU (FAMILY_REF_TOL; the MoE archs' top-k
                expert choices that differ between the two counted), and
                one full-width mamba2 mixer's prefill state against
                stepping its decode token by token on the card (the
                reference's 0.05, SSM_EQUIV_TOL) ("families" lines);
  5. faults  -- Table-3 fault injection (the +-15% corner of the paper)
                on the carry-save K=128 serving dot at full width: DRIM-R,
                4 waves, 262,144 words per input plane, bare and hardened
                ("ecc", "tmr", "tmr+ecc"), on the "cuda", "resident" and
                (bare and "tmr") "baseline" engines, which must agree bit
                for bit, ECC verdicts included; against the clean numpy
                oracle the bare run must be corrupted, ECC must flag it
                and TMR must leave fewer bits wrong than bare; a
                fault-free TMR run must be exact;
  6. bulk    -- the paper's Fig. 8 ops on the card at its largest vector,
                2**29 bits (64 MiB planes from a seeded generator):
                not, xnor2 and add through `compile(op).lower("gpu")`
                (the native comparator, one bulk bit-wise kernel per op)
                and through `lower("cuda")` (the DRIM-R fleet's AAP
                interpreter over 256 waves), both exact against the plain
                version; the 32-bit word add as the bit-plane adder over
                [32, 2**19] planes; the carry-save K=32 serving dot at
                full DRIM-R width on "gpu" and "cuda" and the numpy
                oracle; the FFN weights packed and unpacked.  Then each
                op's kernel time, its Gbit/s beside the DRIM-R model and
                the paper's GPU model, and the op-averaged DRIM-R / H100
                ratio beside the paper's 8.4 ("bulk" lines);
  7. analog  -- the paper's Table-3 Monte-Carlo on the card (10,000
                trials at the five corners, seed 0, draws from the port's
                twin of jax.random): the wrong DRA and TRA results must
                equal `launch.analog.EXPECTED` and
                `FaultModel.from_corner(0.15, source="sim")` the rates of
                `launch.analog.FROM_CORNER`; then a 32-bit
                `multibit_add_program` over one DRIM-R wave (2**21
                elements) on the AAP interpreter must equal numpy's a + b;
                prints the phase's wall time ("analog" line);
  8. queue   -- the per-bank command queues at full DRIM-R width, one
                queue per bank: `lower("queued", n_queues=8)` on xnor2
                and on the carry-save K=32 dot over one wave, the same
                words as "resident", clean and at the +-15% corner;
                `bnn_dot_partitioned` at K=32 (4 and 8 queues, 2**21
                lanes) and K=128 (8 queues, the faults phase's 4 waves)
                on "cuda" and "queued", the dots equal to numpy's and the
                4-queue K=32 critical path 113 AAPs; then the K=32 dot
                over 8 queues with a stage-0 kill and a mid-graph kill,
                clean (exact) and TMR at the corner ("cuda" and "queued"
                bit for bit), each report's requeued segments and
                detecting stages those of the partition; the
                interpreters' times at the largest segment's queue block
                ("queue" and "chaos" lines);
  9. verdict -- the DRIM-vs-GPU placement Verdict (`Lowered.verdict`) at
                one DRIM-R wave (2**21 bits) of xnor2, the carry-save
                K=32 dot, the same under tmr+ecc at the faults phase's
                corner and the same over 4 queues, on "cuda": each
                simulated verdict runs on the card and must equal the
                closed form row for row; each distinct program once on
                "gpu", exact against numpy; then each "gpu" program's
                CUDA-graph time at 2**21 and 2**29 bits beside the
                Verdict's GPU row (`gpu_cost`), `serving_verdict` of the
                drim-bnn decode FFN pair at batch 4 on "resident", "cuda"
                and "queued" (8 queues), `plan_model_payloads` of
                drim-bnn, and `python -m repro_torch.pim.verify --k 32
                --partition 4 --harden tmr,ecc,tmr+ecc`, which must exit 0
                ("verdict" lines);
 10. telemetry -- the observability layer on the serving path at full
                width: `serve.main --telemetry --trace-out` on "cuda"
                --packed for 4 tokens (the disarmed leg's first 4 tokens
                and its launches for 4 steps, a parseable trace with 3
                "decode:token" spans and a "Lowered.run" span per
                interpreter launch; `build/trace_serve.json`),
                `--microbench` on "cuda" and "gpu" --packed (4 prefills,
                1 + 3 decode steps), `--resilient` on "cuda" with a decode
                fn that raises (2 retries, then "gpu" gives the "gpu
                packed" leg's tokens), and the queue phase's TMR run at
                the corner under a mid-graph kill, armed (the same words,
                report and launches; `build/trace_queue.json` holds one
                sim process of 8 queue tracks, the DEAD instant, requeue
                spans and the report's ``chaos.*`` gauges); "telemetry"
                lines print span counts by name and registry counters;
  11. drim   -- the `drim` import surface as `drim_torch`: the README's
                `@drim.jit` kernel (xnor -> full_add) over one DRIM-R wave
                on every engine ("resident" through `kernel(...)`,
                "baseline", "queued" over 4 queues, "cuda", "gpu",
                `partition=True` on "queued" and "cuda", `drim.lower` on
                "cuda"), every word equal to `graph_ref_results`; xnor2
                and the carry-save K=32 dot on "resident" under
                `fleet_mesh(DRIM_R)` (1x1) and under a 1x8 mesh over
                [cuda:0] * 8 on one DRIM-S wave (256 banks x 152
                sub-arrays), and the K=32 dot partitioned over 4 queues
                under a 1x2 mesh, the words equal to the unsharded run's
                (host wall times beside); each deprecated shim once at one
                DRIM-R wave ("cuda" where it takes an engine), its
                DeprecationWarning naming this file and its words (or
                report fields) the pipeline's; `examples/
                quickstart_torch.py` in this process ("drim" lines);
  11b. collective -- `optim.compress.compressed_allreduce` on a one-rank
                NCCL process group over the card: a gradient tree of the
                drim-bnn LM's parameter shapes, every full-size payload
                all-reduced as int8 (a spy on `dist.all_reduce`), the mean
                and the new residuals equal to the single-rank decode
                exactly, the call's time ("collective" line); and
                `serve.main` and `train.main` under `--mesh single` raise
                the production mesh's ValueError;
  12. train  -- the drim-bnn LM trained at full width and depth through
                `repro_torch.launch.train.main` under `--mesh host`
                (examples/train_bnn_lm.py's
                batch 8, seq 256, AdamW 3e-4; 10 steps, seeded weights,
                deterministic algorithms; the state placed on its ZeRO-1
                shardings over a 1x1 mesh, every AdamW moment's spec with
                a "data" entry, the sharded and replicated leaves
                counted): finite losses, the last below
                the first, s/step and tokens/s ("train" lines); then the
                step-5 checkpoint restored into a fresh state and trained
                5 more steps must equal the straight run's step-10 state
                bit for bit;
  12a. ranks -- the train phase's run (TRAIN) over 2 ranks on the one
                card: `python -m torch.distributed.run --nproc-per-node 2
                chip_smoke.py --ranks-worker DIR gloo`, each rank
                `launch.train.main` under torchrun's environment
                (`launch.mesh.init_ranks`: gloo, both on cuda:0), the
                (2, 1) mesh of ranks, 4 rows of each global batch a rank,
                ZeRO-1 moments cut over "data", deterministic: step 1's
                loss within RANKS_STEP1_TOL of the train phase's step 1,
                every later loss within RANKS_LOSS_BOUND; each rank's
                flash launches 24 / 12 / 12 a step; each rank's moment
                bytes half of one process's and equal to its specs'
                local bytes; the 5 + 5 restart (--resume) bitwise the
                straight 10 steps; the 2-rank checkpoint restored here in
                one process equal to each rank's blocks leaf for leaf; a
                planted fault (rank 1's gradients left out of the sum)
                past the loss bound; backend, devices, s/step, global
                tokens/s, peak GB and collective s a step per rank
                ("ranks" lines).  Then NCCL: with 2 or more cards the
                straight run at min(4, cards) ranks, a card each; with one
                card, the NCCL error of two ranks on it
                (`launch.rank_probe`; a line, not a failure).  Then, in
                the same torchrun, the optimizer legs (RANKS_OPT_LEGS:
                TRAIN cut to 2 layers and 4 steps, with adam8bit and with
                AdamW and --compress, each rank on its blocks of the
                state and residuals): step 1 within RANKS_STEP1_TOL of the
                same argv's one-process leg run here, later steps within
                RANKS_LOSS_BOUND; each rank's param, state and residual
                bytes its specs'; flash launches 4 / 2 / 2 a step;
  12b. train families -- one arch of each remaining family trained at
                its published width through `launch.train.main` under
                `--mesh host` and deterministic algorithms
                (TRAIN_FAMILIES, 6 steps each): mamba2-130m (4 x 1024)
                at 12 of its 24 layers, zamba2-1.2b (4 x 512) at 6 of its
                38 and whisper-medium (4 x 256, 1500 frames) at 6 + 6 of
                its 24 + 24, with AdamW, llava-next-34b at 2 of
                its 60 layers (1 x 3072: 2880 patches, 192 text
                positions) with AdamW, deepseek-v3-671b at 1 of its 61
                layers with 32 of its 256 experts and adafactor (2 x
                256): finite losses, the last below the first, s/step,
                tokens/s, peak GB; then a step from the final state run
                twice, bitwise the same loss and parameters, and 2 steps
                under `torch.profiler` (launches a step, the idle share)
                ("train families" lines);
  12c. tp   -- the train phase's run (TRAIN) and the serve phase's legs
                over a model axis of 2 ranks on the one card: `python -m
                torch.distributed.run --nproc-per-node 2 chip_smoke.py
                --tp-worker DIR gloo`, each rank `launch.train.main
                --model-axis 2` and `launch.serve.run_serve --model-axis
                2` under torchrun's environment (gloo, both on cuda:0),
                the (1, 2) mesh of ranks: each rank holds its model block
                of every param, moment and KV cache by the reference's
                specs (Megatron's column- and row-parallel products, the
                vocab-parallel embedding, head and cross-entropy,
                flash-decoding over the sequence-cut cache) and its
                block of the residual cut over the sequence
                (`seq_parallel`: the dense, vlm and MoE trunks and the
                audio encoder; each row-parallel output a float32
                reduce-scatter, each column-parallel input an
                all-gather).  Training:
                step 1's loss within TP_STEP1_TOL of the train phase's
                step 1, every later loss within TP_LOSS_BOUND, a planted
                fault (rank 1 drops layer 0's wo reduce for 8 steps) past
                it; flash 24 / 12 / 12 a step on each rank; each rank's
                param and moment bytes its specs' local bytes (half of
                one process's for every cut leaf); the 5 + 5 restart
                bitwise the straight run; the 2-rank checkpoint restored
                here in one process equal to each rank's blocks; s/step,
                global tokens/s, peak GB and collective calls, GB and s a
                step by axis and by kind per rank.  Serving (4 x 256, 8
                greedy tokens): drim-bnn cut to 6 layers (TP_ROUTE_LAYERS) on
                "gpu", "gpu --packed" and "cuda --packed", the same
                tokens on every route and rank; drim-bnn cut to 2 layers
                ("gpu") and qwen3-14b at 2 of its 40 layers, tokens equal
                to one process's but where its top two logits lie within
                TP_LOGIT_TOL, the prefill's last logits within it; each
                rank's KV cache bytes half of one process's, its launches
                the one-process leg's ("tp" lines).  Then, in the same
                worker, the MoE (TP_MOE_ARCHS): deepseek-v3 (MLA) and
                kimi-k2 (GQA) served as the families phase serves them
                (full width, 1 of 61 layers, all 256 / 384 experts, 128
                / 192 a rank, each rank drawing only its blocks), tokens
                and prefill logits held to that phase's one-process legs
                as qwen3-14b's, each rank's expert and cache bytes half
                of one process's, flash 0 / 1 a prefill, and a planted
                fault (rank 1's expert-parallel partial left out of the
                sum) failing that bound; deepseek-v3 trained at the
                train-families cut (1 layer, 32 experts, 2 x 256, 6
                steps) with that leg's adafactor 2e-5 on each rank's
                blocks, step 1 within TP_STEP1_TOL of the train-families
                leg's and every later step within TP_LOSS_BOUND of its,
                the losses finite and falling, each rank's param and
                state bytes its specs'.  Then, in the same worker, the
                ssm, hybrid and vlm families (TP_FAMILY_SERVE,
                TP_FAMILY_TRAIN):
                mamba2-130m served over (1, 2) (its params replicated,
                its 1024-token prompt cut over the sequence, 512 tokens
                a rank) and over the (2, 1) data mesh (one process's
                tokens bit for bit), zamba2-1.2b over (1, 2) (its mixer
                on cut params) at 6 of its 38 layers in bfloat16 and at
                full depth in float32 with the scan's bfloat16 roundings
                off (`float32_numerics`; prefill logits within
                TP_F32_LOGIT_TOL of one process's, and a planted fault,
                rank 1's out_proj partial of the last mixer left out of
                the sum, past it), llava-next-34b at 2 of 60 layers
                over (1, 2) (3072 tokens), as the families phase serves
                them and held to one-process legs as qwen3-14b's; each
                rank's param and cache bytes its specs' (`rank_cache_
                pspecs`: the SSM states over heads, the conv windows
                whole), its prefill and decode collectives by axis; the
                three trained over (1, 2) at their train-families legs
                (6 steps; mamba2 at 12 layers, zamba2 at 6, llava at 2,
                donated),
                step 1 within
                TP_STEP1_TOL of one process's and later steps within
                TP_LOSS_BOUND, each rank's param and moment bytes its
                specs'.  Then, in the same worker, the audio family
                (TP_AUDIO): whisper-medium at full width and depth served
                over (1, 2) (encoder and decoder on the rank's heads, the
                cross cache the rank's heads of every frame) and over the
                (2, 1) data mesh from one whole draw of its weights, held
                to the families phase's one-process leg as qwen3-14b's
                (whether the data mesh's tokens are bit for bit printed);
                over (1, 2) its prompts prefilled again over seeded
                frames (zero frames make every cross-attention output
                zero), within TP_LOGIT_TOL of one process's prefill of
                them, and with rank 1's cross-attention wo partials left
                out of the sum at every decoder layer, past it; trained
                over (1, 2) at 6 encoder and 6 decoder layers as zamba2
                at 6.  Last, the serving modes (TP_MODES) on drim-bnn cut
                to 2 layers: --continuous on "gpu --packed" and "cuda
                --packed" over (1, 2) and "gpu --packed" over (2, 1), the
                request tokens one process's but for near ties
                (`batcher_tap`), the two routes' equal; --microbench on
                "gpu --packed" over (1, 2), each stage's figures per rank
                and their maximum; --resilient on "cuda --packed" over
                (1, 2) with a decode fn failing on rank 1 alone from its
                third call (`failing_make_fn`): both ranks book retry,
                retry, fallback alike and give the tokens of the run with
                no failure; each rank's launches those of the same leg in
                one process.  Then the uneven-heads legs (UNEVEN_CUT):
                qwen3-14b's smoke config in float32 with 5 heads over 1
                KV head over (1, 2), 2.5 heads a rank, trained 2 steps
                (`train.main`) and served (`serve.run_serve`) through
                the flash forward and both backward kernels, held to the
                same legs in one process (UNEVEN_LOSS_TOL,
                UNEVEN_LOGIT_TOL; a planted shift of rank 1's wo columns
                past the logit bound), launches exact, each leg within
                UNEVEN_WALL_S.  Every training
                step of the worker's drim-bnn leg and of the ranks
                phase's, and every decode step of whisper's (1, 2) leg,
                keeps its own collective calls and bytes by axis, which
                the dryrun phase holds to the dry-run's rank trace.
                The worker's non-MoE legs read the trees
                the parent drew for the same seed and config from a
                temporary directory and keep their blocks
                (`shared_draws`).  With 2 or
                more cards the training run and the MoE serving legs
                over NCCL at (1, min(4, cards)), a card a rank; with one
                card a line;
  13. counts -- the launch counters are zeroed just before phase 3, before
                each of phase 4's five legs and phase 4b's legs, before
                phase 5, phase 6,
                phase 7, each of phase 8's three legs, phase 9, each of
                phase 10's five legs, each of phase 11's four legs,
                each of phase 12's two legs and in each rank each of
                phase 12a's and phase 12c's legs, and read just after
                each:
                phase 3 must launch the three BNN kernels, each serving
                leg exactly the launches its route implies
                (`expected_launches`), each of phase 4b's legs the
                flash forward once per attention site of its prefill
                (mamba2 0, zamba2 6, qwen3-14b 2, deepseek-v3 0, kimi-k2
                1, whisper-medium 24, llava-next-34b 2, continuous 0; the
                mesh legs three prefills: deepseek-v3 0, kimi-k2 3) and
                nothing else, phase 11b nothing, phase 5 the faulted interpreter
                once per faulted "cuda" run and the fault-free one once,
                phase 6 one bulk kernel per "gpu" op run and per non-copy
                graph node (by kind), the interpreter once per "cuda" run
                and never on "gpu", phase 7 the interpreter once, phase 8
                nothing on the uniform "queued" leg and the interpreter
                once per "cuda" segment run (a requeued one included; the
                faulted one instead under flips), phase 9 the interpreter
                25 times (1 + 1 + 23 segments), the faulted one once and
                one bulk kernel per "gpu" node, by kind, phase 10
                `expected_launches` per serving leg and the disarmed
                run's faulted launches on the chaos leg, phase 11 the
                interpreter 3 times and one binary and one ternary bulk
                kernel on its engines leg, nothing on its mesh leg, the
                interpreter 6 times on its shims leg and the packer
                twice, the GEMM and the adder once each on its quickstart
                leg, phase 12 and in each rank phases 12a and 12c per
                step the flash forward twice per layer (remat) and each
                backward kernel once per layer, each rank's phase 12c
                serving legs the launches of their one-process legs
                (the family legs' prefills mamba2 0, zamba2 6 (1 at 6
                layers), llava 2, whisper 24;
                their training per step twice a GQA site and each
                backward kernel once a site: 0, 1, 2, 6; the serving
                modes' those of the same leg in one process),
                phase 12b per step the flash forward twice per GQA site
                and each backward kernel once per site (mamba2 and
                deepseek-v3 none, zamba2 6 sites, whisper 24, llava 2),
                and its repeat legs two steps' worth, the uneven-heads
                legs (in one process and in each rank) a forward a layer
                at the served prefill (and the decode's launches, none)
                and per training step twice a layer and each backward
                kernel once a layer; a counter a leg does not
                name must stay 0; and
                each of these legs, and each of phases 3 to 12 as a
                whole, prints a "verify" line (the verify passes its
                lowerings ran: programs, clean, failed, wall seconds),
                which fails the script on any failure; a serving leg's
                line also carries `verify_s` beside its `compile_s`;
 14. check  -- a float32 smoke-config prefill, and the same config's
                first train step (loss and gradients), on the card held to
                the same on the CPU (after the counts are read); the
                first train step also for qwen3-14b, mamba2-130m,
                zamba2-1.2b, deepseek-v3-671b, kimi-k2-1t-a32b,
                whisper-medium and llava-next-34b, each within its
                family's bound (TRAIN_REF_TOL), which the card's
                gradient with its largest leaf zeroed must fail;
 15. dryrun -- first the dry-run's rank trace (`launch.dryrun.
                rank_trace`, a fake process group on meta tensors) of the
                legs RANK_LEGS names, as each of their 2 ranks, then
                `launch.dryrun.main(["--all", "--out", <a temporary
                file>])`, started in a process of its own on the host
                (no card visible to it) before phase 1 and read last:
                every cell of `all_cells()` with status "ok" and the
                fields of its rank trace as rank 0 of the production
                mesh, each cell's per-device argument bytes and whether
                they fit the card, rank 0's collective calls and payload
                bytes a step by axis and its wire bytes by kind, and the
                run's wall time ("dryrun" lines); then each leg's
                predicted calls and payload bytes a step by axis equal,
                rank for rank, to every step the ranks and tp phases
                measured ("dryrun ranks" lines): drim-bnn's TRAIN step
                over (1, 2) and (2, 1), its adam8bit and --compress legs
                over (2, 1), whisper-medium's decode step over (1, 2),
                the tp phase's deepseek-v3 adafactor step over (1, 2).

Prints the kernels' JSON line (the packer's entry also under "served" at
its decode [4, 768] bfloat16 and [3072, 768] float32 weight shapes), the
card's name and power limit, and last
`{"ok": true, "device": {...}}`.  Exits nonzero without a CUDA card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

# cuBLAS picks its reduction order per call unless its workspace is fixed
# before CUDA starts; the train phase's restart check needs that order to
# repeat (torch.use_deterministic_algorithms requires this setting).
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
M_ROWS = 512                      # activation rows: a 512-token prefill

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bandwidth, and the
# int32 rate of the CUDA cores -- 64 INT32 lanes per SM against the 128
# FP32 lanes behind the 67 TFLOP/s float32 figure, which counts an FMA as
# two operations, so a quarter of it.
HBM_BYTES_S = 3.35e12
INT32_OPS_S = 67e12 / 4
BF16_FLOPS_S = 989e12             # dense tensor-core bf16 peak
INT8_OPS_S = 1979e12              # dense tensor-core int8 peak

# flash attention, (atol, rtol) of out against the plain version: float32
# at the reference test's 2e-5 (tests/test_flash_attention.py); bfloat16
# at one bfloat16 ulp (at most 2**-7 of the value, 4e-3 near zero), since
# kernel and plain version each round a float32 result to bfloat16 once.
# lse at 1e-4.
FLASH_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (4e-3, 2 ** -7)}
LSE_TOL = 1e-4
# flash backward, (atol, rtol) of dq, dk, dv against the plain backward:
# float32 at the reference test's 2e-4 (tests/test_flash_attention.py:
# test_flash_backward); bfloat16 at one bfloat16 ulp, as FLASH_TOL, since
# kernel and plain version each round a float32 sum to bfloat16 once.
BWD_TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (4e-3, 2 ** -7)}
# bfloat16 flash cases beyond the main paths' shapes, for the tensor-core
# kernels' edges (b, h, hkv, sq, sk, d, bq, bk, causal, dtype): Sq != Sk
# at D = 128 causal, D = 32 non-causal, D = 16, n_rep 1, 3 and 4.
FLASH_BF16_EDGES = [
    (1, 4, 1, 64, 192, 128, 64, 64, True, torch.bfloat16),
    (1, 2, 2, 256, 256, 32, 128, 64, False, torch.bfloat16),
    (2, 6, 2, 128, 128, 16, 64, 64, True, torch.bfloat16),
    (2, 4, 4, 192, 320, 64, 64, 64, False, torch.bfloat16)]
# The flash backward at the train-families phase's attention shapes (b, h,
# hkv, sq, sk, d, causal, dtype): llava-next-34b (q [1, 56, 3072, 128],
# n_rep 7), zamba2-1.2b's shared block [4, 32, 512, 64] and whisper-
# medium's decoder [4, 16, 256, 64], n_rep 1.
FLASH_BWD_FAMILIES = [
    (1, 56, 8, 3072, 3072, 128, True, torch.bfloat16),
    (4, 32, 32, 512, 512, 64, True, torch.bfloat16),
    (4, 16, 16, 256, 256, 64, True, torch.bfloat16)]
# The train phase: examples/train_bnn_lm.py's run (batch 8, seq 256,
# AdamW at 3e-4) at full width and depth, cut to TRAIN_STEPS steps, with a
# checkpoint at RESTART_AT for the restart check.  10 steps and a 5 + 5
# restart leave the script's time for the tp phase's family legs; the
# ranks and tp phases run the same schedule (the warmup-cosine's decay
# depends on the step count), since both are held to this phase's
# losses.
TRAIN_STEPS, RESTART_AT = 10, 5
PROFILE_STEPS = 3               # steps traced after the restart check
TRAIN = ["--arch", "drim-bnn", "--steps", str(TRAIN_STEPS), "--batch", "8",
         "--seq", "256", "--mesh", "host", "--lr", "3e-4", "--log-every", "1",
         "--ckpt-every", str(RESTART_AT), "--seed", str(SEED)]
# The card's float32 smoke-config train step against the CPU's: both sum
# float32 in other orders (about 1e-6 relative, as the CPU tests measure
# against the reference); the gradient's bound leaves room for an STE
# sign flip of an activation within float32 noise of 0.
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-5, 1e-3
# The train-families phase: one arch of each family trained through the
# trainer's CLI at its published width: mamba2-130m, zamba2-1.2b and
# whisper-medium (1500 frames) **reduced**, for the script's time, to
# the depths the tp phase trains them at over ranks (12 of 24 layers,
# 6 of 38: one group and one shared-block site, 6 + 6 of 24 + 24:
# `depth_cut`), so that one leg serves as the one-process side of both;
# llava-next-34b cut from 60 layers to 2 (3072 tokens: its 2880 patches
# and 192 text positions, as the serve leg); deepseek-v3-671b cut from 61
# layers to 1 and from 256 experts to 32, with the dry-run's adafactor
# (`launch.dryrun.ARCH_OPTIMIZER`): one layer with all 256 experts is
# 13.4 B parameters, ~107 GB of adafactor state, and 32 experts make it
# 3.49 B (top-8, moe_d_ff 2048, d_model 7168, the MLA ranks and the
# vocabulary at their published sizes).  FAMILY_TRAIN_STEPS steps each,
# logged every step, at drim-bnn's 3e-4, but the two 7168-wide legs at
# 2e-5 (LLaVA-NeXT's published learning rate for its language model):
# an update at 3e-4 moves a logit by up to about 7168 * 3e-4, and on an
# H100 llava's loss rose from 11.44 to 13.64 in 6 steps; then one step
# from the final state run twice (bitwise the same loss and parameters)
# and FAMILY_PROFILE_STEPS steps under `torch.profiler`.  (arch, depth
# cut or 0, experts cut or 0, batch, sequence, optimizer, learning rate)
TRAIN_FAMILIES = (("mamba2-130m", 12, 0, 4, 1024, "adamw", 3e-4),
                  ("zamba2-1.2b", 6, 0, 4, 512, "adamw", 3e-4),
                  ("whisper-medium", 6, 0, 4, 256, "adamw", 3e-4),
                  ("llava-next-34b", 2, 0, 1, 3072, "adamw", 2e-5),
                  ("deepseek-v3-671b", 1, 32, 2, 256, "adafactor", 2e-5))
FAMILY_TRAIN_STEPS, FAMILY_PROFILE_STEPS = 6, 2
# The float32 smoke configs' first train step, card against CPU (loss
# relative error, whole-gradient and per-leaf relative L2).  A one-ulp
# (1e-7 relative) nudge of the weights moves the CPU's own gradients by
# 1.6-2.0e-6 in the dense, MoE, audio and vlm archs, 1.1e-3 / 1.5e-3
# (whole / worst leaf) in mamba2 and 3.5e-3 / 4.0e-3 in zamba2, whose SSD
# scans round their product operands to bfloat16 (a ten-ulp nudge: 9e-6,
# 2.0e-3, 1.0e-2).  The card's float32 flash kernels and cuBLAS sum in
# other orders than the CPU's dense scores, so each family is held at
# about ten times its ten-ulp reading: 1e-4 for the dense, MoE, audio
# and vlm archs (a top-k expert choice that a router near-tie flipped
# would move its experts' gradients by far more, and shows here), 1e-2
# for mamba2, 5e-2 for zamba2.  The loss at 1e-5 in all.  drim-bnn keeps
# its own bounds (TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL).  One leaf's card
# gradient zeroed (the largest) must fail each bound.
TRAIN_REF_TOL = {"qwen3-14b": 1e-4, "mamba2-130m": 1e-2,
                 "zamba2-1.2b": 5e-2, "deepseek-v3-671b": 1e-4,
                 "kimi-k2-1t-a32b": 1e-4, "whisper-medium": 1e-4,
                 "llava-next-34b": 1e-4}
SERVE_GEN = 8
SERVE = ["--arch", "drim-bnn", "--batch", "4", "--prompt-len", "256",
         "--gen", str(SERVE_GEN), "--seed", str(SEED), "--temperature", "0"]
SERVE_LEGS = {"gpu dense": ["--engine", "gpu"],
              "gpu packed": ["--engine", "gpu", "--packed"],
              "cuda packed": ["--engine", "cuda", "--packed"]}
# The families phase: the SSM, hybrid, dense, MoE, audio and vlm archs
# served at full width (arch, depth cut or 0 for the published depth,
# prompt length, flash launches of the one aligned prefill: a GQA
# attention site each -- none in mamba2, one per group site in zamba2, one
# per layer in qwen3-14b, kimi-k2 and llava, none behind deepseek-v3's
# MLA, one per decoder layer in whisper).  qwen3-14b keeps its width and
# is cut from 40 layers to 2, so that its host-side initialisation stays
# short; the two MoE archs keep theirs and are cut from 61 layers to 1
# (26.7 GB and 38.9 GB in bfloat16, 13.4 B and 19.4 B weights drawn on
# the host); llava-next-34b keeps its width and is cut from 60 layers to
# 2 (2.03 B weights drawn on the host, 4.07 GB in bfloat16, against
# 34.4 B for all 60).  llava's prompt is 3072 tokens, longer than its
# 2880 patches, so that 192 text positions follow them, and a multiple
# of 128, so that the prefill takes the flash kernel.
FAMILIES = (("mamba2-130m", 0, 1024, 0), ("zamba2-1.2b", 0, 512, 6),
            ("qwen3-14b", 2, 256, 2), ("deepseek-v3-671b", 1, 256, 0),
            ("kimi-k2-1t-a32b", 1, 256, 1), ("whisper-medium", 0, 256, 24),
            ("llava-next-34b", 2, 3072, 2))
FAMILY_BATCH, FAMILY_GEN = 4, 8
# The MoE legs' mesh check: EP over 8 model shards of one card (32
# experts a shard in deepseek-v3, 48 in kimi-k2).  EP x8 sums a token's 8
# expert outputs as per-shard partials, then across shards, where the
# grouped dispatch adds them in one sorted run, so the bf16 MoE output
# rounds apart by a ulp here and there.  A logit then moves by up to a
# bf16 ulp of its own value (its rounding) plus about a ulp of the
# logits' RMS (the hidden state's one-ulp change, carried through the
# head to every logit alike).  So each logit is held at EP_LOGIT_RTOL *
# (|logit| + RMS of the logits), and under EP_MOVED_MAX of them may move
# at all (tests/test_torch_ep.py, the one-ulp test, holds the same).  Two
# planted faults must fail that check: shard 0's partial dropped, and
# added twice.  FAMILY_REF_TOL's 1e-3 of the logits' magnitude, the
# float32 configs' bound, sits under the bf16 rounding of the logits; its
# reading is printed beside the check.
EP_SHARDS = 8
EP_LOGIT_RTOL = 2 ** -7
EP_MOVED_MAX = 0.25
FAMILY_CONTINUOUS = (1024, 512)         # two mamba2 requests' prompts
# The float32 smoke configs' prefill on the card against the CPU: mamba2
# at the drim-bnn check's 1e-3; zamba2 at 4 bfloat16 ulps of the logits'
# magnitude, since its scan rounds product operands to bfloat16 in
# float32 too and the shared attention amplifies a one-ulp change (a
# 1.2e-7 relative nudge of the embeddings moves its CPU logits by ~1e-4:
# tests/test_torch_families.py); deepseek-v3, kimi-k2, whisper-medium and
# llava-next-34b at the drim-bnn check's 1e-3 of the logits' magnitude
# (cuBLAS and the
# CPU sum float32 in other orders, ~1e-6 relative; a top-k choice that a
# near-tie flips would show as a larger error, and the check counts them).
FAMILY_REF_TOL = {"mamba2-130m": 1e-3, "zamba2-1.2b": 1.6e-2,
                  "deepseek-v3-671b": 1e-3, "kimi-k2-1t-a32b": 1e-3,
                  "whisper-medium": 1e-3, "llava-next-34b": 1e-3}
# A full-width mamba2 layer's prefill against stepping its decode token by
# token: the reference's tolerances (tests/test_ssm_equiv.py): state 0.05,
# outputs 0.08, conv window 1e-4.
SSM_EQUIV_TOL = {"state": 0.05, "y": 0.08, "conv": 1e-4}
# integer operations of one armed DRA/TRA's draw: the XOR of the slot
# hash with i * golden (one scalar per instruction), mix32 (3 xor-shifts,
# 2 multiplies) and the compare.  A draw belongs to a (sub-array, op)
# pair: the words of a row and the waves share it.  The rare failing
# draw's bit position and its one flipped word are not counted.
HASH_OPS = 10

# The queue phase's partitioned dots (K, queues, M, N): M x N lanes are one
# DRIM-R wave of words at K=32 and the faults phase's 4 waves at K=128.
QUEUE_DOTS = ((32, 4, 2048, 1024), (32, 8, 2048, 1024), (128, 8, 4096, 2048))

# The bulk phase: Fig. 8's largest vector (benchmarks/fig8_throughput.py
# sweeps 2**27..2**29 bits), 2**24 words, 64 MiB a plane: above the 50 MB
# L2, so every call streams from device memory.
BULK_BITS = 1 << 29
BULK_WORDS = BULK_BITS // 32
ADD_PLANES = (32, BULK_WORDS // 32)      # a 32-bit word add of 2**24 lanes
FIG8_OPS = ("not", "xnor2", "add")
# integer operations per word of each bulk bit-wise op (for its bound)
BITWISE_OPS = {"not": 1, "xnor": 2, "xor": 1, "and": 1, "or": 1, "nand": 2,
               "nor": 2, "maj3": 5, "min3": 6, "fa": 7}

# The verdict phase's payloads: one DRIM-R wave (offload.SIMULATE_MAX_BITS,
# the largest payload a verdict simulates) and Fig. 8's largest vector.
VERDICT_BITS = (1 << 21, BULK_BITS)
# Wall seconds of every verify pass, appended by `install_verify_tally`.
VERIFY_WALLS: list = []
# The telemetry phase's disarmed yardsticks: each static serving leg's
# tokens (by leg, from the serve phase) and the queue phase's TMR run at
# the corner under ARMED_KILL on "cuda" (feeds, faults, words, report,
# launches).
SERVED: dict = {}
# the train phase's per-step losses, which the ranks phase is held to
# ("losses"), and each train-families leg's (by arch), which the tp
# phase's MoE training leg is held to
TRAINED: dict = {}
# the one-process serving legs the tp phase is held to: drim-bnn's "gpu
# dense" and the families phase's qwen3-14b, deepseek-v3, kimi-k2,
# mamba2, zamba2 and llava (tokens, prefill logits and each token's
# top-two logit gap: `tap_values`)
ONE_PROCESS: dict = {}
CHAOS_DISARMED: dict = {}
ARMED_KILL = "mid-graph kill"
TRACE_DIR = ROOT / "build"


def cuda_ms(fn, iters: int) -> float:
    """Mean time per call of `fn`, called eagerly `iters` times after a
    warm-up, between two CUDA events: what a caller pays, host launch
    cost included when it exceeds the device time."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, iters: int, replays: int = 5) -> float:
    """Mean device time per call of `fn`: `iters` calls captured in one
    CUDA graph, replayed `replays` times between two CUDA events, so the
    host's per-call cost drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / (iters * replays)


def profiled_device_ms(fn, iters: int) -> float:
    """Device time per call of the kernels `fn` launches: `iters` calls
    after a warm-up under `torch.profiler`, each kernel's device time
    summed, so the host's per-call cost drops out."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.self_device_time_total > 0
               and e.device_type.name == "CUDA") / 1e3 / iters


def max_abs_err(got, want) -> int:
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def check_equal(what: str, got, want) -> int:
    err = max_abs_err(got, want)
    if err != 0:
        raise AssertionError(f"{what}: kernel differs from its plain "
                             f"version (max abs diff {err})")
    return err


def bound(bytes_moved: float, ops: float, ops_s: float = INT32_OPS_S):
    by_bytes = bytes_moved / HBM_BYTES_S * 1e3
    by_ops = ops / ops_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def check_close(what: str, got, want, atol: float,
                rtol: float | None = None) -> float:
    """|got - want| <= atol + rtol * |want| everywhere (numpy's
    assert_allclose; rtol defaults to atol); returns the max abs error."""
    rtol = atol if rtol is None else rtol
    got, want = got.to(torch.float32), want.to(torch.float32)
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    diff = (got - want).abs()
    if not bool((diff <= atol + rtol * want.abs()).all()):
        raise AssertionError(f"{what}: kernel differs from its plain "
                             f"version (max abs diff {float(diff.max())})")
    return float(diff.max())


def sm_clock_mhz() -> float:
    """The card's maximum SM clock, as nvidia-smi reads it."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    return float(smi.stdout.strip().splitlines()[0])


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.time()
    sources = ["pack_signs", "xnor_gemm", "aap_interp", "flash_attn_fwd",
               "flash_attn_bwd", "bitwise", "bitplane_add", "unpack_signs"]
    reports = _build.build(sources)
    missing = [n for n in sources if not _build._lib_path(n).exists()]
    if missing:
        raise AssertionError(f"no library built for {missing}")
    secs = time.time() - t0
    for name, text in sorted(reports.items()):
        entry = spill = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "spill stores" in line:
                spill = line.strip()
            elif "Used" in line:
                print(f"ptxas {name} {entry}: "
                      f"{line.split('info    :')[-1].strip()}; {spill}")
    print(f"build: {len(sources)} sources, {secs:.2f} s")
    check_tensor_cores(_build)


def check_tensor_cores(_build):
    """Count the tensor-core instructions of the flash kernels (HMMA) and
    of the XNOR GEMM (IMMA) in the built libraries' SASS ("sass" lines):
    the bfloat16 forward, dkv and dq kernels and the GEMM must have some,
    the float32 flash kernels none."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name, op in (("flash_attn_fwd", "HMMA"), ("flash_attn_bwd", "HMMA"),
                     ("xnor_gemm", "IMMA")):
        sass = subprocess.run([tool, "-sass", str(_build._lib_path(name))],
                              capture_output=True, text=True,
                              check=True).stdout
        counts = {}
        fn = None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[-1].strip()
                counts[fn] = 0
            elif fn is not None and op in line:
                counts[fn] += 1
        if not counts:
            raise AssertionError(f"{name}: no function in the SASS")
        for fn, n in sorted(counts.items()):
            print("sass " + json.dumps({"source": name, "function": fn,
                                        op.lower(): n}))
            want = "bf16_kernel" in fn if op == "HMMA" else True
            if want != (n > 0):
                raise AssertionError(f"{name} {fn}: {n} {op} instructions")


def phase_kernels(rng):
    """Each kernel against its plain version; returns the per-kernel
    records measured at the up-projection's shapes."""
    from repro_torch.core import AAP, DRIM_R
    from repro_torch.kernels import packbits, xnor_popcount
    from repro_torch.kernels.ref import unpack_signs_ref
    from repro_torch.pim import compile as drim_compile
    from repro_torch.pim.bnn import bnn_dot_graph_carrysave, serving_lowering
    dev = torch.device("cuda")
    d_model, d_ff = 768, 3072
    records = {}

    # -- sign packer ------------------------------------------------------
    # the FFN pair's float32 operands, the weights the packed serving route
    # packs once (float32, models/layers.py), the bfloat16 activations it
    # packs per forward (decode at batch 4, prefill at 4 x 256 tokens,
    # and the continuous batcher's), ragged K (the scalar path where a
    # row's bytes are not a multiple of 16) and a view one element in
    pack_shapes = [(M_ROWS, d_model, torch.float32, 0),   # up activations
                   (d_ff, d_model, torch.float32, 0),     # up weights
                   (M_ROWS, d_ff, torch.float32, 0),      # down activations
                   (d_model, d_ff, torch.float32, 0),     # down weights
                   (4, d_model, torch.bfloat16, 0),       # decode up
                   (4, d_ff, torch.bfloat16, 0),          # decode down
                   (1024, d_model, torch.bfloat16, 0),    # prefill up
                   (1024, d_ff, torch.bfloat16, 0),       # prefill down
                   # the continuous batcher's prefills (256 and 200
                   # tokens) and decode steps (2 slots)
                   (256, d_model, torch.bfloat16, 0),
                   (256, d_ff, torch.bfloat16, 0),
                   (200, d_model, torch.bfloat16, 0),
                   (200, d_ff, torch.bfloat16, 0),
                   (2, d_model, torch.bfloat16, 0),
                   (2, d_ff, torch.bfloat16, 0),
                   (300, 700, torch.bfloat16, 0),         # ragged R and K
                   (300, 700, torch.float32, 0),
                   (257, 33, torch.bfloat16, 0), (64, 1, torch.float32, 0),
                   (M_ROWS, d_model, torch.float32, 1),   # offset view
                   (1024, d_ff, torch.bfloat16, 1)]
    # beside the FFN pair's shape, the kernels line carries the served
    # shapes with the most launches: the decode activations and the weights
    served_keys = [(4, d_model, torch.bfloat16, 0),
                   (d_ff, d_model, torch.float32, 0)]
    served = []
    # Warm the packer up in a CUDA graph of its first timed shape before
    # anything is timed: the first shape timed cold read 3x its steady time
    warm = torch.ones(M_ROWS, d_model, device=dev)
    graph_ms(lambda: packbits.pack_signs(warm), 50, replays=20)
    floor_ms = graph_ms(packbits.launch_floor, 50)
    print("detail " + json.dumps({"kernel": "empty", "launch_floor_ms":
                                  floor_ms}))
    for rows, k, dt, offset in pack_shapes:
        flat = rng.standard_normal(rows * k + offset, dtype=np.float32)
        x = torch.from_numpy(flat).to(dev, dt)[offset:].view(rows, k)
        x[0, :4] = torch.tensor([-0.0, float("nan"), 0.0, -1e-30])[:k]
        got = packbits.pack_signs(x)
        err = check_equal(f"pack_signs {rows}x{k} {dt} +{offset}", got,
                          packbits.pack_signs_plain(x))
        ms = graph_ms(lambda: packbits.pack_signs(x), 50)
        call_ms = cuda_ms(lambda: packbits.pack_signs(x), 200)
        plain_ms = graph_ms(lambda: packbits.pack_signs_plain(x), 20)
        nbytes = x.numel() * x.element_size() + got.numel() * 4
        b_ms, b_by = bound(nbytes, x.numel())
        detail = {"shape": [rows, k], "dtype": str(dt), "offset": offset,
                  "path": packbits.pack_path(x), "ms": ms,
                  "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": b_ms}
        print("detail " + json.dumps({"kernel": "pack_signs", **detail,
                                      "launch_floor_ms": floor_ms}))
        if (rows, k, dt, offset) in served_keys:
            served.append(detail)
        if (rows, k, dt, offset) == (M_ROWS, d_model, torch.float32, 0):
            records["pack_signs"] = dict(
                max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                launch_floor_ms=floor_ms,
                shape=f"[{rows},{k}] float32 -> [{rows},{-(-k // 32)}] int32")
    records["pack_signs"]["served"] = served

    # -- XNOR-popcount GEMM -------------------------------------------------
    # the FFN pair at M_ROWS rows, the serving decode (batch 4) and prefill
    # (batch 4 x 256 tokens) through both projections, ragged shapes
    gemm_shapes = [("ffn", M_ROWS, d_ff, d_model),
                   ("ffn", M_ROWS, d_model, d_ff),
                   ("decode", 4, d_ff, d_model), ("decode", 4, d_model, d_ff),
                   ("prefill", 1024, d_ff, d_model),
                   ("prefill", 1024, d_model, d_ff),
                   ("ragged", 100, 77, 700), ("ragged", 17, 9, 1),
                   # the tp phase's rank blocks: gate and up's columns,
                   # down's output block over its gathered input
                   ("tp decode", 4, d_ff // TP, d_model),
                   ("tp decode", 4, d_model // TP, d_ff),
                   ("tp prefill", 1024, d_ff // TP, d_model),
                   ("tp prefill", 1024, d_model // TP, d_ff)]
    for use, m, n, k in gemm_shapes:
        w = -(-k // 32)
        a = torch.from_numpy(rng.integers(-2**31, 2**31, (m, w),
                                          dtype=np.int32)).to(dev)
        b = torch.from_numpy(rng.integers(-2**31, 2**31, (n, w),
                                          dtype=np.int32)).to(dev)
        got = xnor_popcount.xnor_gemm_packed(a, b, k)
        err = check_equal(f"xnor_gemm {m}x{n}x{k}", got,
                          xnor_popcount.xnor_gemm_plain(a, b, k))
        ms = graph_ms(lambda: xnor_popcount.xnor_gemm_packed(a, b, k), 50)
        call_ms = cuda_ms(lambda: xnor_popcount.xnor_gemm_packed(a, b, k), 200)
        plain_ms = graph_ms(lambda: xnor_popcount.xnor_gemm_plain(a, b, k), 3)
        # The same function as one PyTorch call, yardsticks the port never
        # calls: torch._int_mm on the +-1 int8 operands (exact in int32;
        # it takes M > 16 and K, N multiples of 8), and beside it a
        # float32 torch.matmul, TF32 off (exact: every partial sum is an
        # integer below 2**24).
        pa8 = unpack_signs_ref(a, torch.int8)[:, :k].contiguous()
        pb8 = unpack_signs_ref(b, torch.int8)[:, :k].contiguous()
        library_ms, library_note = None, None
        if m > 16 and k % 8 == 0 and n % 8 == 0:
            if not torch.equal(torch._int_mm(pa8, pb8.T), got):
                raise AssertionError("torch._int_mm yardstick disagrees")
            library_ms = graph_ms(lambda: torch._int_mm(pa8, pb8.T), 50)
        else:
            library_note = ("torch._int_mm takes M > 16 and K, N multiples "
                            f"of 8, not {m} x {k} x {n}")
        pa, pb = pa8.to(torch.float32), pb8.to(torch.float32).T.contiguous()
        if not torch.equal(torch.matmul(pa, pb).to(torch.int32), got):
            raise AssertionError("float32 torch.matmul yardstick disagrees")
        library_fp32_ms = graph_ms(lambda: torch.matmul(pa, pb), 50)
        # the least time: inputs read once and the int32 output written
        # once over HBM, against 2 M N K int8 operations on the tensor cores
        b_ms, b_by = bound((m + n) * w * 4 + m * n * 4, 2 * m * n * k,
                           INT8_OPS_S)
        print("detail " + json.dumps({
            "kernel": "xnor_gemm", "use": use, "shape": [m, n, k], "ms": ms,
            "call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_note": library_note,
            "library_fp32_ms": library_fp32_ms, "bound_ms": b_ms,
            "bound_by": b_by}))
        if (m, n, k) == (M_ROWS, d_ff, d_model):
            records["xnor_gemm"] = dict(
                max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms,
                library_fp32_ms=library_fp32_ms,
                shape=f"[{m},{w}] x [{n},{w}] int32, K={k} -> [{m},{n}] int32")

    # -- AAP interpreter ------------------------------------------------------
    low = serving_lowering(128, engine="cuda", geom=DRIM_R)
    fp = low.fp
    cols = DRIM_R.n_subarrays * DRIM_R.row_bits // 32
    # the decode shape the serving legs launch (K=128, one full DRIM-R
    # wave), the bulk phase's carry-save K=32 dot (one wave), the TMR
    # stream as the faults phase runs it fault-free (4 waves), and a
    # ragged soup
    graph, _ = bnn_dot_graph_carrysave(128)
    tmr = drim_compile(graph, geom=DRIM_R).lower("cuda", harden="tmr").fp
    k32 = drim_compile(bnn_dot_graph_carrysave(32)[0],
                       geom=DRIM_R).lower("cuda").fp
    cases = [("serving K=128", fp.program, fp.readback_rows,
              fp.template_rows, 1, len(fp.loaded_inputs), cols),
             ("K=32 dot", k32.program, k32.readback_rows, k32.template_rows,
              1, len(k32.loaded_inputs), cols),
             ("tmr K=128 fault-free", tmr.program, tmr.readback_rows,
              tmr.template_rows, 4, len(tmr.loaded_inputs), cols)]
    # ragged: a random soup over every word-line, DCC aliases included,
    # 3 waves of a column count that no block width divides
    n_rows = 20
    arity = {0: 2, 1: 3, 2: 3, 3: 4}
    soup = tuple(AAP(op, tuple(int(rng.integers(0, n_rows + 4))
                               for _ in range(arity[op])))
                 for op in (int(rng.integers(0, 4)) for _ in range(300)))
    cases.append(("ragged soup", soup, tuple(range(n_rows + 4)), n_rows, 3,
                  6, 1000))
    for case in cases:
        detail, err = interp_case(*case, rng)
        if case[0].startswith("serving"):
            records["aap_interp"] = dict(
                max_abs_err=err, library_ms=None,
                **{k: detail[k] for k in ("ms", "call_ms", "plain_ms",
                                          "bound_ms", "bound_by")},
                shape=f"{detail['n_ins']} AAPs over [{detail['waves']},"
                      f"{detail['n_in']},{detail['cols']}] int32, "
                      f"{detail['slots']} slots of {detail['n_state']} "
                      f"state rows")

    records["aap_interp_faulted"] = phase_faulted_kernel(rng)
    records["flash_attn_fwd"] = phase_flash(rng)
    records.update(phase_flash_bwd(rng))
    records.update(phase_bulk_kernels(rng))
    return records


def interp_case(label, prog, readback, n_rows_t, waves, n_in, ncols, rng):
    """The AAP interpreter on its packed stream over random tiles [waves,
    n_in, ncols], held exactly to the plain replay and the packed twin and
    timed ("detail" line); returns (detail, max_abs_err)."""
    from repro_torch.core import (dcc_state_rows, encode_kernel_stream,
                                  kstream_slot)
    from repro_torch.kernels import aap_interpreter
    dev = torch.device("cuda")
    sm_clock_hz = sm_clock_mhz() * 1e6
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream_np = encode_kernel_stream(prog, n_rows=n_rows_t)
    stream = torch.from_numpy(stream_np).to(dev)
    slot_list = [kstream_slot(r, n_rows_t) for r in readback]
    slots = torch.tensor(slot_list, dtype=torch.int32, device=dev)
    n_state = dcc_state_rows(n_rows_t)
    packed = aap_interpreter.pack_stream(stream_np, slot_list, n_state,
                                         n_in)
    tiles = torch.from_numpy(rng.integers(
        -2**31, 2**31, (waves, n_in, ncols), dtype=np.int32)).to(dev)

    def run():
        return aap_interpreter.aap_interp(stream, tiles, slots, n_state,
                                          packed=packed)
    got = run()
    err = check_equal(f"aap_interp {label}", got,
                      aap_interpreter.aap_interp_plain(
                          stream, tiles, slots, n_state))
    check_equal(f"aap_interp {label} (plain twin)", got,
                aap_interpreter.aap_interp_packed_plain(packed, tiles))
    ms = graph_ms(run, 10)
    call_ms = cuda_ms(run, 50)
    # The plain replay reads the stream to the host (`tolist`), which a
    # CUDA graph cannot capture: timed eagerly.
    plain_ms = cuda_ms(lambda: aap_interpreter.aap_interp_plain(
        stream, tiles, slots, n_state), 2)
    nbytes = tiles.numel() * 4 + got.numel() * 4 + \
        packed.words.nbytes + packed.loads.nbytes
    b_ms, b_by = bound(nbytes, len(prog) * waves * ncols)
    w, threads, _ = aap_interpreter.launch_geometry(
        packed.n_slots, ncols, waves, sms,
        aap_interpreter.words_choices(ncols, tiles.data_ptr()))
    detail = {
        "kernel": "aap_interp", "case": label, "n_ins": len(prog),
        "n_in": n_in, "n_state": n_state, "slots": packed.n_slots,
        "peak_live": packed.peak_live, "waves": waves, "cols": ncols,
        "words_per_thread": w, "block_threads": threads,
        "block_cols": threads * w, "ms": ms, "call_ms": call_ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "smem_bound_ms": smem_bound_ms(packed, waves, ncols, sms,
                                       sm_clock_hz),
        "sm_clock_mhz": sm_clock_hz / 1e6}
    print("detail " + json.dumps(detail))
    return detail, err


def smem_bound_ms(packed, waves: int, cols: int, sms: int,
                  sm_clock_hz: float) -> float:
    """The interpreter's shared-memory bound: per instruction its three
    reads and the writes that are read later (not to the sink, slot 1),
    per staged row its copy, per output its read, 4 bytes a word column,
    over the SMs' 128 bytes a clock."""
    fields = packed.words[:packed.n_ins].view(np.uint32)
    writes = np.stack([fields[:, 1] >> 16, fields[:, 2] & 0xFFFF,
                       fields[:, 2] >> 16, fields[:, 3] & 0xFFFF])
    accesses = 3 * packed.n_ins + int((writes != 1).sum()) + \
        len(packed.loads) - 4 + int((packed.out_map[:, 0] >= 0).sum())
    return accesses * 4 * waves * cols / (sms * 128 * sm_clock_hz) * 1e3


def faulted_operands(prog, n_rows, readback, waves, n_in, geom4, faults,
                     bank_geom, rng):
    """The fault-injecting interpreter's operands on the card, as the
    "cuda" engine builds them, over random tiles."""
    from repro_torch.core import dcc_state_rows, encode_kernel_stream, \
        kstream_slot
    from repro_torch.kernels import aap_interpreter
    dev = torch.device("cuda")
    c, b, s, w = geom4
    stream = torch.from_numpy(encode_kernel_stream(prog, n_rows=n_rows)).to(dev)
    thresh = torch.from_numpy(aap_interpreter._op_thresholds(
        prog, faults).view(np.int32)).to(dev)
    meta = aap_interpreter.column_meta(c, b, s, w, seed=faults.seed,
                                       bank_lo=bank_geom[0],
                                       banks_total=bank_geom[1], device=dev)
    slots = torch.tensor([kstream_slot(r, n_rows) for r in readback],
                         dtype=torch.int32, device=dev)
    stuck = torch.tensor(faults.stuck_rows, dtype=torch.int32,
                         device=dev).reshape(-1, 2)
    tiles = torch.from_numpy(rng.integers(
        -2**31, 2**31, (waves, n_in, c * b * s * w), dtype=np.int32)).to(dev)
    return (stream, thresh, meta, tiles, slots, dcc_state_rows(n_rows), stuck,
            32 * w)


def phase_faulted_kernel(rng):
    """The fault-injecting interpreter on its packed stream (stuck rows
    folded in, as the "cuda" engine packs it) against the plain replay and
    the packed twin: the TMR-hardened K=128 stream at the Table-3 corner
    over the faults phase's 4 DRIM-R waves, and a ragged soup with three
    stuck rows (an operand row, a result row and a DCC cell), protected
    ops and a bank offset.  Returns the record of the first."""
    from repro_torch.core import AAP, DRIM_R, FaultModel
    from repro_torch.launch import faults as payload
    from repro_torch.pim import compile as drim_compile
    from repro_torch.pim.bnn import bnn_dot_graph_carrysave
    graph, _ = bnn_dot_graph_carrysave(payload.K_BITS)
    tmr = drim_compile(graph, geom=DRIM_R).lower("cuda", harden="tmr")
    fp = tmr.fp
    corner = tmr._resolve_faults(FaultModel.from_corner(
        payload.CORNER, source="paper", seed=payload.SEED))
    geom4 = (DRIM_R.chips, DRIM_R.banks, DRIM_R.subarrays_per_bank,
             DRIM_R.row_bits // 32)
    n_rows = 20
    arity = {0: 2, 1: 3, 2: 3, 3: 4}
    soup = tuple(AAP(op, tuple(int(rng.integers(0, n_rows + 4))
                               for _ in range(arity[op])))
                 for op in (int(rng.integers(0, 4)) for _ in range(300)))
    ragged = FaultModel(p_dra=0.3, p_tra=0.4, seed=5,
                        stuck_rows=((2, 1), (17, 0), (21, 1)),
                        protected_ops=tuple(range(0, 300, 7)))
    cases = [("tmr K=128", fp.program, fp.readback_rows, fp.template_rows,
              payload.WAVES, len(fp.loaded_inputs), geom4, corner, (0, None)),
             ("ragged soup", soup, tuple(range(n_rows + 4)), n_rows, 3, 6,
              (1, 3, 37, 9), ragged, (2, 8))]
    record = None
    for case in cases:
        detail, err = faulted_case(*case, rng)
        if record is None:
            record = dict(
                max_abs_err=err, library_ms=None,
                **{k: detail[k] for k in ("ms", "call_ms", "plain_ms",
                                          "bound_ms", "bound_by")},
                shape=f"{detail['n_ins']} AAPs ({detail['armed']} armed) "
                      f"over [{detail['waves']},{detail['n_in']},"
                      f"{detail['cols']}] int32, {detail['slots']} slots of "
                      f"{detail['n_state']} state rows")
    return record


def faulted_case(label, prog, readback, n_rows_t, waves, n_in, g4, faults,
                 bank, rng):
    """The fault-injecting interpreter on its packed stream over random
    tiles of a [waves, n_in, chips, banks, subarrays, row_words] payload
    anchored at `bank` = (bank_lo, banks_total), held exactly to the plain
    replay and the packed twin, flipping some word, and timed ("detail"
    line); returns (detail, max_abs_err)."""
    from repro_torch.kernels import aap_interpreter
    sm_clock_hz = sm_clock_mhz() * 1e6
    sms = torch.cuda.get_device_properties("cuda").multi_processor_count
    args = faulted_operands(prog, n_rows_t, readback, waves, n_in, g4,
                            faults, bank, rng)
    stream, thresh, meta, tiles = args[:4]
    packed = aap_interpreter.pack_stream(
        stream.cpu().numpy(), args[4].tolist(), args[5], n_in,
        stuck=args[6].tolist())

    def run():
        return aap_interpreter.aap_interp_faulted(*args, packed=packed)
    got = run()
    err = check_equal(f"aap_interp_faulted {label}", got,
                      aap_interpreter.aap_interp_faulted_plain(*args))
    check_equal(f"aap_interp_faulted {label} (plain twin)", got,
                aap_interpreter.aap_interp_packed_plain(
                    packed, tiles, thresh, meta, args[7]))
    ms = graph_ms(run, 5)
    call_ms = cuda_ms(run, 10)
    # the plain replay reads the stream to the host: timed eagerly
    plain_ms = cuda_ms(lambda: aap_interpreter.aap_interp_faulted_plain(
        *args), 1)
    armed = int((thresh != 0).sum())
    cols = tiles.shape[2]
    nbytes = 4 * (tiles.numel() + got.numel() + stream.numel()
                  + thresh.numel() + meta.numel())
    n_sub = cols // g4[3]           # sub-arrays: one draw each
    b_ms, b_by = bound(nbytes, waves * cols * len(prog)
                       + n_sub * HASH_OPS * armed)
    w, threads, _ = aap_interpreter.launch_geometry(
        packed.n_slots, cols, waves, sms,
        aap_interpreter.words_choices(cols, tiles.data_ptr()),
        faulted=True)
    flips = int((got != aap_interpreter.aap_interp(
        stream, tiles, args[4], args[5])).sum())
    if flips == 0:
        raise AssertionError(f"aap_interp_faulted {label}: no word "
                             "differs from the fault-free kernel's")
    detail = {
        "kernel": "aap_interp_faulted", "case": label,
        "n_ins": len(prog), "armed": armed, "n_in": n_in,
        "n_state": args[5], "slots": packed.n_slots,
        "peak_live": packed.peak_live, "waves": waves, "cols": cols,
        "words_per_thread": w, "block_threads": threads,
        "stuck_rows": list(faults.stuck_rows),
        "words_differing_from_fault_free": flips,
        "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by,
        "smem_bound_ms": smem_bound_ms(packed, waves, cols, sms,
                                       sm_clock_hz),
        "sm_clock_mhz": sm_clock_hz / 1e6}
    print("detail " + json.dumps(detail))
    return detail, err


def phase_flash(rng):
    """Flash attention forward against its plain version; returns the
    record of the drim-bnn prefill shape."""
    from repro_torch.kernels import flash_attention as fa
    dev = torch.device("cuda")
    cases = [  # b, h, hkv, sq, sk, d, bq, bk, causal, dtype
        (4, 12, 4, 2048, 2048, 64, 128, 128, True, torch.bfloat16),
        (4, 12, 4, 256, 256, 64, 128, 128, True, torch.bfloat16),
        (1, 4, 1, 64, 192, 128, 64, 64, True, torch.float32),
        (1, 2, 2, 256, 256, 32, 128, 64, False, torch.float32),
        # the training step's shape, the families phase's prefills
        # (zamba2's shared block, n_rep 1; qwen3-14b, n_rep 5 at D = 128;
        # kimi-k2, n_rep 8 at D = 128; whisper's decoder, n_rep 1; llava,
        # n_rep 7 at D = 128 over 3072 tokens, whose plain version holds
        # [4, 56, 3072, 3072] float32 scores, 8.5 GB a tensor), then the
        # tensor-core kernel's edges
        (8, 12, 4, 256, 256, 64, 128, 128, True, torch.bfloat16),
        (4, 32, 32, 512, 512, 64, 128, 128, True, torch.bfloat16),
        (4, 40, 8, 256, 256, 128, 128, 128, True, torch.bfloat16),
        (4, 64, 8, 256, 256, 128, 128, 128, True, torch.bfloat16),
        (4, 16, 16, 256, 256, 64, 128, 128, True, torch.bfloat16),
        (4, 56, 8, 3072, 3072, 128, 128, 128, True, torch.bfloat16),
        *FLASH_BF16_EDGES,
        # the tp phase's rank heads (TP ranks): the drim-bnn training
        # step and prefill, qwen3-14b's prefill
        (8, 12 // TP, 4 // TP, 256, 256, 64, 128, 128, True,
         torch.bfloat16),
        (4, 12 // TP, 4 // TP, 256, 256, 64, 128, 128, True,
         torch.bfloat16),
        (4, 40 // TP, 8 // TP, 256, 256, 128, 128, 128, True,
         torch.bfloat16),
        # kimi-k2's prefill on a rank's heads (the tp phase's MoE leg)
        (4, 64 // TP, 8 // TP, 256, 256, 128, 128, 128, True,
         torch.bfloat16),
        # the tp phase's family legs on a rank's heads: zamba2's shared
        # block (n_rep 1), llava's serving prefill and training step
        # (n_rep 7)
        (4, 32 // TP, 32 // TP, 512, 512, 64, 128, 128, True,
         torch.bfloat16),
        (4, 56 // TP, 8 // TP, 3072, 3072, 128, 128, 128, True,
         torch.bfloat16),
        (1, 56 // TP, 8 // TP, 3072, 3072, 128, 128, 128, True,
         torch.bfloat16),
        # whisper-medium's decoder self-attention on a rank's heads (the
        # tp phase's audio legs' prefill and training step)
        (4, 16 // TP, 16 // TP, 256, 256, 64, 128, 128, True,
         torch.bfloat16)]
    record = None
    for b, h, hkv, sq, sk, d, bq, bk, causal, dt in cases:
        q, k, v = (torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(dev, dt)
            for shape in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
        n_rep = h // hkv

        def kernel():
            return fa.flash_fwd(q, k, v, causal=causal, n_rep=n_rep, bq=bq,
                                bk=bk)

        def plain():
            return fa.flash_attention_plain(q, k, v, causal, n_rep)

        out, lse = kernel()
        want, want_lse = plain()
        label = f"flash {list(q.shape)} {dt} causal={causal}"
        err = check_close(label + " out", out, want, *FLASH_TOL[dt])
        lse_err = check_close(label + " lse", lse, want_lse, LSE_TOL)
        ms = graph_ms(kernel, 20)
        call_ms = cuda_ms(kernel, 50)
        plain_ms = cuda_ms(plain, 3)
        library_ms = lib_err = None
        if causal and sq == sk:
            # One PyTorch call computing the same function, a yardstick
            # the port never calls.
            def library():
                return torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True)
            lib_err = float((library().float() - want.float()).abs().max())
            library_ms = graph_ms(library, 20)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() \
            + lse.numel() * 4
        flops = 4 * b * h * sq * sk * d * (0.5 if causal else 1.0)
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_S)
        print("detail " + json.dumps({
            "kernel": "flash_attn_fwd", "q": list(q.shape),
            "kv": list(k.shape), "dtype": str(dt), "causal": causal,
            "max_abs_err": err, "lse_max_abs_err": lse_err, "ms": ms,
            "call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_max_abs_err": lib_err,
            "bound_ms": b_ms, "bound_by": b_by}))
        if record is None:
            record = dict(
                max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                shape=f"q {list(q.shape)} k/v {list(k.shape)} bfloat16, "
                      "causal")
        del q, k, v, out, lse, want, want_lse
        torch.cuda.empty_cache()
    return record


def phase_flash_bwd(rng):
    """The flash backward kernels (dkv, dq) against the plain backward on
    the same q, k, v, do and the forward kernel's out and lse, also at
    the train-families phase's shapes (FLASH_BWD_FAMILIES); returns
    their records at the training shape (q [8,12,256,64], bf16, causal).
    `library_ms` is SDPA's backward, `torch.autograd.grad` over one
    retained graph, timed eagerly (the autograd engine runs the backward
    on the forward's stream, so it cannot be captured alone), and
    `library_device_ms` the device time of the kernels it launches, summed
    under `torch.profiler`, free of the host's speed."""
    from repro_torch.kernels import flash_attention as fa
    dev = torch.device("cuda")
    cases = [  # b, h, hkv, sq, sk, d, causal, dtype
        (8, 12, 4, 256, 256, 64, True, torch.bfloat16),
        (4, 12, 4, 2048, 2048, 64, True, torch.bfloat16),
        (1, 4, 1, 64, 192, 128, True, torch.float32),
        (1, 2, 2, 256, 256, 32, False, torch.float32),
        *(c[:6] + c[8:] for c in FLASH_BF16_EDGES),
        *FLASH_BWD_FAMILIES,
        # the tp phase's training step on each of its TP ranks' heads,
        # and its zamba2, llava and whisper training legs' rank heads
        (8, 12 // TP, 4 // TP, 256, 256, 64, True, torch.bfloat16),
        (4, 32 // TP, 32 // TP, 512, 512, 64, True, torch.bfloat16),
        (1, 56 // TP, 8 // TP, 3072, 3072, 128, True, torch.bfloat16),
        (4, 16 // TP, 16 // TP, 256, 256, 64, True, torch.bfloat16)]
    records = {}
    for b, h, hkv, sq, sk, d, causal, dt in cases:
        q, k, v, do = (torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(dev, dt) for shape in
            ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d), (b, h, sq, d)))
        n_rep = h // hkv
        out, lse = fa.flash_fwd(q, k, v, causal=causal, n_rep=n_rep, bq=64,
                                bk=64)
        delta = fa._delta(out, do)

        def dkv():
            return fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal,
                                    n_rep=n_rep)

        def dq():
            return fa.flash_bwd_dq(q, k, v, do, lse, delta, causal=causal,
                                   n_rep=n_rep)

        def plain():
            return fa.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                causal, n_rep)

        want_q, want_k, want_v = plain()
        label = f"flash bwd {list(q.shape)} {dt} causal={causal}"
        got_k, got_v = dkv()
        got_q = dq()
        errs = {"dk": check_close(label + " dk", got_k, want_k,
                                  *BWD_TOL[dt]),
                "dv": check_close(label + " dv", got_v, want_v,
                                  *BWD_TOL[dt]),
                "dq": check_close(label + " dq", got_q, want_q,
                                  *BWD_TOL[dt])}
        if causal and sk > sq:
            # keys past the last query: no query sees them
            hidden = torch.cat([got_k[:, :, sq:], got_v[:, :, sq:]])
            if bool(hidden.any()):
                raise AssertionError(f"{label}: dk/dv of keys no query sees "
                                     "are not exactly 0")
        plain_ms = cuda_ms(plain, 3)
        library_ms = library_device_ms = lib_err = None
        if causal and sq == sk:
            # One PyTorch call computing the same gradients, a yardstick
            # the port never calls.
            lq, lk, lv = (t.detach().clone().requires_grad_()
                          for t in (q, k, v))
            lo = torch.nn.functional.scaled_dot_product_attention(
                lq, lk, lv, is_causal=True, enable_gqa=True)

            def library():
                return torch.autograd.grad(lo, (lq, lk, lv), do,
                                           retain_graph=True)
            lib_err = max(float((g.float() - w.float()).abs().max())
                          for g, w in zip(library(), (want_q, want_k,
                                                      want_v)))
            library_ms = cuda_ms(library, 20)
            library_device_ms = profiled_device_ms(library, 20)
        half = 0.5 if causal else 1.0
        esize = q.element_size()
        for name, fn, n_prod, outs in (("flash_bwd_dkv", dkv, 4,
                                        k.numel() + v.numel()),
                                       ("flash_bwd_dq", dq, 3, q.numel())):
            ms = graph_ms(fn, 20)
            call_ms = cuda_ms(fn, 50)
            nbytes = (2 * q.numel() + k.numel() + v.numel() + outs) * esize \
                + 2 * lse.numel() * 4
            flops = 2 * n_prod * b * h * sq * sk * d * half
            b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_S)
            err = max(errs[g] for g in (("dk", "dv") if name ==
                                         "flash_bwd_dkv" else ("dq",)))
            rec = dict(max_abs_err=err, ms=ms, call_ms=call_ms,
                       plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=library_ms,
                       library_device_ms=library_device_ms,
                       shape=f"q {list(q.shape)} k/v {list(k.shape)} "
                             f"{str(dt).split('.')[-1]}, causal={causal}")
            print("detail " + json.dumps({
                "kernel": name, "causal": causal, "dtype": str(dt),
                "library_max_abs_err": lib_err, **rec}))
            records.setdefault(name, rec)
        del q, k, v, do, out, lse, delta, want_q, want_k, want_v
    return records


def card_words(rng, n: int, offset: int = 0) -> torch.Tensor:
    """n random int32 words on the card, starting `offset` words into
    their own buffer (offset 1 puts the start 4 bytes off 16-byte
    alignment)."""
    return torch.from_numpy(rng.integers(-2**31, 2**31, n + offset,
                                         dtype=np.int32)).cuda()[offset:]


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def bitwise_kernel(op: str):
    """(counter name, arity, words moved per operand word) of the bulk
    kernel that runs bit-wise `op`."""
    from repro_torch.kernels.bitwise import BINARY_OPS, TERNARY_OPS
    if op in TERNARY_OPS:
        return "bitwise_ternary", 3, 5 if op == "fa" else 4
    if op in BINARY_OPS:
        return "bitwise_binary", 2, 3
    return "bitwise_not", 1, 2


def phase_bulk_kernels(rng):
    """The bulk bit-wise kernels, the bit-plane adder and the sign
    unpacker against their plain versions, exactly, at the bulk phase's
    shapes and at ragged ones; returns their records (not, xor, fa at
    2**24 words; the adder at [32, 2**19]; the unpacker at the up
    projection's packed weights [3072, 24] to bfloat16)."""
    from repro_torch.kernels import bitserial_add, packbits
    from repro_torch.kernels.bitwise import (BINARY_OPS, TERNARY_OPS,
                                             UNARY_OPS, bitwise,
                                             bitwise_plain)
    records = {}
    # -- bitwise: every op at the bulk length, a ragged length, a
    # misaligned start and empty -----------------------------------------
    bulk = [card_words(rng, BULK_WORDS) for _ in range(3)]
    cases = [("bulk", bulk),
             ("ragged", [card_words(rng, 1000003) for _ in range(3)]),
             ("offset 1", [card_words(rng, 1000003, 1) for _ in range(3)]),
             ("offset 1, 2 words", [card_words(rng, 2, 1)
                                    for _ in range(3)]),
             ("empty", [card_words(rng, 0) for _ in range(3)])]
    arity = {op: bitwise_kernel(op)[1]
             for op in UNARY_OPS + BINARY_OPS + TERNARY_OPS}
    errs = {}
    for label, operands in cases:
        for op, k in arity.items():
            args = operands[:k]
            got, want = (as_tuple(bitwise(op, *args)),
                         as_tuple(bitwise_plain(op, *args)))
            for g, w in zip(got, want):
                errs[op] = max(errs.get(op, 0), check_equal(
                    f"bitwise {op} {label}", g, w))
    print("detail " + json.dumps({
        "kernel": "bitwise", "cases": [c[0] for c in cases],
        "ops": list(arity), "exact": True}))
    library = {"not": torch.bitwise_not, "xor": torch.bitwise_xor}
    for name, op in (("bitwise_not", "not"), ("bitwise_binary", "xor"),
                     ("bitwise_binary", "xnor"), ("bitwise_ternary", "fa")):
        args = bulk[:arity[op]]
        ms = graph_ms(lambda: bitwise(op, *args), 50)
        call_ms = cuda_ms(lambda: bitwise(op, *args), 200)
        plain_ms = graph_ms(lambda: bitwise_plain(op, *args), 20)
        library_ms = None
        if op in library:
            if not torch.equal(library[op](*args), bitwise(op, *args)):
                raise AssertionError(f"torch yardstick for {op} disagrees")
            library_ms = graph_ms(lambda: library[op](*args), 50)
        b_ms, b_by = bound(bitwise_kernel(op)[2] * 4 * BULK_WORDS,
                           BITWISE_OPS[op] * BULK_WORDS)
        rec = dict(max_abs_err=errs[op], ms=ms, call_ms=call_ms,
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=library_ms,
                   shape=f"{op}: {arity[op]} x [{BULK_WORDS}] int32 -> "
                         f"{2 if op == 'fa' else 1} x [{BULK_WORDS}]")
        print("detail " + json.dumps({"kernel": name, "op": op, **rec}))
        if op != "xnor":
            records[name] = rec
    del bulk, cases

    # -- bit-plane adder --------------------------------------------------
    add_cases = [("bulk", ADD_PLANES, 0), ("1 plane", (1, 1001), 0),
                 ("33 planes", (33, 1001), 0),
                 ("33 planes, offset 1", (33, 1000), 1),
                 ("empty", (8, 0), 0)]
    for label, (nbits, w), offset in add_cases:
        a, b = (card_words(rng, nbits * w, offset).view(nbits, w)
                for _ in range(2))
        s, c = bitserial_add.bitplane_add(a, b)
        want_s, want_c = bitserial_add.bitplane_add_plain(a, b)
        err = max(check_equal(f"bitplane_add {label} sum", s, want_s),
                  check_equal(f"bitplane_add {label} carry", c, want_c))
        if label != "bulk":
            continue
        ms = graph_ms(lambda: bitserial_add.bitplane_add(a, b), 50)
        call_ms = cuda_ms(lambda: bitserial_add.bitplane_add(a, b), 200)
        plain_ms = graph_ms(lambda: bitserial_add.bitplane_add_plain(a, b),
                            5)
        b_ms, b_by = bound(4 * (3 * nbits + 1) * w, 7 * nbits * w)
        records["bitplane_add"] = dict(
            max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            shape=f"2 x [{nbits},{w}] int32 -> [{nbits},{w}] + [{w}]")
        print("detail " + json.dumps({"kernel": "bitplane_add",
                                      **records["bitplane_add"]}))
    print("detail " + json.dumps({"kernel": "bitplane_add", "exact": True,
                                  "cases": [c[0] for c in add_cases]}))

    # -- sign unpacker: the drim-bnn up projection's weights [d_ff, d_model]
    # packed by the pack kernel, then ragged and empty ----------------------
    w_up = torch.from_numpy(rng.standard_normal((3072, 768),
                                                dtype=np.float32)).cuda()
    packed = packbits.pack_signs(w_up)
    unpack_cases = [("ffn weights", packed),
                    ("offset 1", card_words(rng, 130 * 33, 1).view(130, 33)),
                    ("empty", card_words(rng, 0).view(0, 4))]
    for label, p in unpack_cases:
        for dt in (torch.float32, torch.bfloat16, torch.int8):
            got = packbits.unpack_signs(p, dt)
            err = check_equal(f"unpack_signs {label} {dt}", got,
                              packbits.unpack_signs_plain(p, dt))
            if label != "ffn weights":
                continue
            if not torch.equal(got.to(torch.float32),
                               torch.where(w_up >= 0, 1.0, -1.0)):
                raise AssertionError("unpack(pack(w)) is not sign(w)")
            ms = graph_ms(lambda: packbits.unpack_signs(p, dt), 50)
            call_ms = cuda_ms(lambda: packbits.unpack_signs(p, dt), 200)
            plain_ms = graph_ms(lambda: packbits.unpack_signs_plain(p, dt),
                                20)
            n = p.numel()
            b_ms, b_by = bound(n * (4 + 32 * got.element_size()), 64 * n)
            rec = dict(max_abs_err=err, ms=ms, call_ms=call_ms,
                       plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=None,
                       shape=f"[{p.shape[0]},{p.shape[1]}] int32 -> "
                             f"[{p.shape[0]},{32 * p.shape[1]}] {dt}")
            print("detail " + json.dumps({"kernel": "unpack_signs",
                                          "dtype": str(dt), **rec}))
            if dt == torch.bfloat16:
                records["unpack_signs"] = rec
    return records


def sign_planes(x: np.ndarray, nbits: int) -> np.ndarray:
    """[nbits, n / 32] uint32 bit planes of uint64 values x: bit j of word
    c of plane i is bit i of element 32 c + j."""
    shifts = np.arange(32, dtype=np.uint64)
    return np.stack([(((x >> np.uint64(i)) & np.uint64(1)).reshape(-1, 32)
                      << shifts).sum(1).astype(np.uint32)
                     for i in range(nbits)])


def plane_values(planes: np.ndarray) -> np.ndarray:
    """The uint64 values of [nbits, W] uint32 bit planes (sign_planes'
    inverse)."""
    shifts = np.arange(32, dtype=np.uint64)
    vals = np.zeros(planes.shape[1] * 32, np.uint64)
    for i, plane in enumerate(planes.astype(np.uint64)):
        vals |= (((plane[:, None] >> shifts) & np.uint64(1)).ravel()
                 << np.uint64(i))
    return vals


def phase_analog(wrappers):
    """The paper's Table-3 Monte-Carlo on the card (five corners, 10,000
    trials, seed 0) and `FaultModel.from_corner(0.15, source="sim")`,
    held to the counts the port records (`launch.analog.EXPECTED`, held to
    the reference by the CPU tests); then a 32-bit `multibit_add_program`
    (7 AAPs a bit slice) over one full DRIM-R wave on the AAP interpreter,
    held to numpy's a + b.  Returns the phase's launch counts: the
    interpreter once, nothing else."""
    from repro_torch.core import (DRIM_R, dcc_state_rows,
                                  encode_kernel_stream, kstream_slot,
                                  make_subarray, multibit_add_program)
    from repro_torch.kernels import aap_interpreter
    from repro_torch.launch import analog
    dev = torch.device("cuda")
    nbits = 32
    sa = make_subarray(n_data=4 * nbits + 1, row_bits=32)   # a template
    a_rows, b_rows = range(nbits), range(nbits, 2 * nbits)
    cin = 2 * nbits                                         # stays zero
    sum_rows = range(cin + 1, cin + 1 + nbits)
    carry_rows = range(cin + 1 + nbits, cin + 1 + 2 * nbits)
    prog = multibit_add_program(sa, a_rows, b_rows, cin, sum_rows,
                                carry_rows)
    stream_np = encode_kernel_stream(prog, n_rows=sa.n_rows)
    slot_list = [kstream_slot(r, sa.n_rows)
                 for r in (*sum_rows, carry_rows[-1])]
    n_state = dcc_state_rows(sa.n_rows)
    cols = DRIM_R.n_subarrays * DRIM_R.row_bits // 32
    rng = np.random.default_rng([SEED, 19])
    a, b = (rng.integers(0, 1 << 32, cols * 32, dtype=np.uint64)
            for _ in range(2))
    tiles = np.concatenate([sign_planes(a, nbits), sign_planes(b, nbits)])
    packed = aap_interpreter.pack_stream(stream_np, slot_list, n_state,
                                         2 * nbits)

    def run():
        t0 = time.perf_counter()
        mc = analog.run(dev)
        out = aap_interpreter.aap_interp(
            torch.from_numpy(stream_np).to(dev),
            torch.from_numpy(tiles.view(np.int32)[None]).to(dev),
            torch.tensor(slot_list, dtype=torch.int32, device=dev),
            n_state, packed=packed)
        torch.cuda.synchronize()
        return mc, out, time.perf_counter() - t0

    (mc, out, wall_s), counts = counted(wrappers, "analog", run,
                                        lambda _: {"aap_interp": 1})
    got = plane_values(out[0].cpu().numpy().view(np.uint32))
    if not np.array_equal(got, a + b):
        bad = int(np.flatnonzero(got != a + b)[0])
        raise AssertionError(f"multibit add: element {bad} is {got[bad]}, "
                             f"not {a[bad]} + {b[bad]}")
    print("analog " + json.dumps({
        **mc, "multibit_add": {"bits": nbits, "aaps": len(prog),
                               "elements": cols * 32, "exact": True},
        "wall_s": wall_s}))
    return counts


def phase_bulk(wrappers):
    """Fig. 8 on the card: the paper's three ops at 2**29 bits on the
    native "gpu" comparator and on the DRIM-R fleet ("cuda"), the 32-bit
    word add, the carry-save serving dot at full width on both engines,
    and the FFN weights packed and unpacked, counted; then the times
    ("bulk" lines).  Returns the phase's launch counts."""
    from repro_torch.core import (DRIM_R, PAPER_CLAIMS, all_platforms,
                                  drim_throughput_bits)
    from repro_torch.kernels import ops
    from repro_torch.kernels.bitserial_add import bitplane_add_plain
    from repro_torch.kernels.bitwise import bitwise_plain
    from repro_torch.pim import compile as drim_compile, graph_ref_results
    from repro_torch.pim.bnn import bnn_dot_graph_carrysave
    from repro_torch.pim.compiler import NATIVE_OP
    from repro_torch.pim.scheduler import OP_ARITY
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    planes = [card_words(rng, BULK_WORDS) for _ in range(3)]
    graph, _ = bnn_dot_graph_carrysave(32)
    g_words = DRIM_R.n_subarrays * DRIM_R.row_bits // 32    # one wave
    g_feeds = {n: (np.zeros(g_words, np.uint32) if n == "zero" else
                   rng.integers(0, 1 << 32, g_words, dtype=np.uint32))
               for n in graph.input_names}
    w_up = torch.from_numpy(rng.standard_normal(
        (3072, 768), dtype=np.float32)).to(dev, torch.bfloat16)
    waves = BULK_BITS // DRIM_R.parallel_bits
    lowered = {op: drim_compile(op).lower("gpu") for op in FIG8_OPS}
    drim_s = {}

    def body():
        for op in FIG8_OPS:
            args = planes[:OP_ARITY[op]]
            low = lowered[op]
            got = low.run(*args, n_bits=BULK_BITS, device=dev)
            if low.schedule != low.cost(BULK_BITS):
                raise AssertionError(f"{op}: gpu schedule != cost")
            want = as_tuple(bitwise_plain(NATIVE_OP[op], *args))
            torch.cuda.synchronize()
            t = time.perf_counter()
            drim = drim_compile(op).lower("cuda").run(*args, device=dev)
            torch.cuda.synchronize()
            drim_s[op] = time.perf_counter() - t
            if low.schedule.n_bits != BULK_BITS or len(got) != len(want):
                raise AssertionError(f"{op}: bad result arity or n_bits")
            for g, w, d in zip(got, want, drim):
                check_equal(f"bulk {op} gpu vs plain", g, w)
                check_equal(f"bulk {op} gpu vs cuda (DRIM-R)", g, d)
            del got, want, drim
        a, b = (t.view(*ADD_PLANES) for t in planes[:2])
        s, c = ops.bitplane_add(a, b)
        want_s, want_c = bitplane_add_plain(a, b)
        check_equal("bulk 32-bit add sum", s, want_s)
        check_equal("bulk 32-bit add carry", c, want_c)
        del s, c, want_s, want_c
        on_card = {n: torch.from_numpy(v.view(np.int32)).to(dev)
                   for n, v in g_feeds.items()}
        native = drim_compile(graph).lower("gpu").run(on_card, device=dev)
        fleet = drim_compile(graph).lower("cuda").run(on_card, device=dev)
        oracle = graph_ref_results(graph, g_feeds)
        if set(native) != set(oracle) or set(fleet) != set(oracle):
            raise AssertionError("carry-save K=32: output names differ")
        for name, want in oracle.items():
            w = torch.from_numpy(want.view(np.int32))
            check_equal(f"carry-save {name} gpu vs cuda", native[name],
                        fleet[name])
            check_equal(f"carry-save {name} gpu vs oracle",
                        native[name].cpu(), w)
        signs = ops.unpack_signs(ops.pack_signs(w_up), torch.bfloat16)
        if not torch.equal(signs, torch.where(w_up >= 0, 1.0, -1.0)
                           .to(torch.bfloat16)):
            raise AssertionError("unpack(pack(w_up)) is not sign(w_up)")

    def expected(_):
        """One bulk kernel per "gpu" op run and per non-copy graph node,
        by kind; the interpreter once per "cuda" run; the adder, packer
        and unpacker once each."""
        nodes = [NATIVE_OP[op] for op, _, _ in graph.nodes if op != "copy"]
        per = {"bitwise_not": 0, "bitwise_binary": 0, "bitwise_ternary": 0}
        for op in [NATIVE_OP[op] for op in FIG8_OPS] + nodes:
            per[bitwise_kernel(op)[0]] += 1
        per.update(aap_interp=len(FIG8_OPS) + 1, bitplane_add=1,
                   pack_signs=1, unpack_signs=1)
        return per

    _, counts = counted(wrappers, "bulk", body, expected)
    print("bulk " + json.dumps({
        "exact": True, "n_bits": BULK_BITS, "drim_r_waves": waves,
        "carry_save_k32_words": g_words,
        "carry_save_k32_nodes": len(graph.nodes),
        "drim_r_cuda_run_s": drim_s}))

    # -- times (not counted) ---------------------------------------------------
    plats = all_platforms()
    h100, model_gpu, drim_r = {}, {}, {}
    for op in FIG8_OPS:
        args = planes[:OP_ARITY[op]]
        native = NATIVE_OP[op]
        kernel_ms = graph_ms(lambda: ops.bitwise(native, *args), 50)
        run_ms = cuda_ms(lambda: lowered[op].run(*args, device=dev), 50)
        line = {"op": op, "kernel": bitwise_kernel(native)[0],
                "bitwise_op": native, "kernel_ms": kernel_ms,
                "gpu_engine_run_ms": run_ms}
        moved = bitwise_kernel(native)[2] * 4 * BULK_WORDS
        if op == "add":
            # Fig. 8's GPU adds words (3 bits moved per output bit); the
            # full adder above is one bit-slice of DRIM's bit-serial add
            line.update(fa_gbit_s=BULK_BITS / (kernel_ms * 1e-3) / 1e9,
                        fa_hbm_share=moved / (kernel_ms * 1e-3)
                        / HBM_BYTES_S)
            a, b = (t.view(*ADD_PLANES) for t in planes[:2])
            kernel_ms = graph_ms(lambda: ops.bitplane_add(a, b), 50)
            moved = 4 * (3 * ADD_PLANES[0] + 1) * ADD_PLANES[1]
            line.update(word_add=f"bitplane_add {list(ADD_PLANES)}",
                        word_add_ms=kernel_ms)
        h100[op] = BULK_BITS / (kernel_ms * 1e-3) / 1e9
        drim_r[op] = drim_throughput_bits(DRIM_R, op) / 1e9
        model_gpu[op] = plats["GPU"].throughput_bits(op) / 1e9
        line.update(h100_gbit_s=h100[op],
                    hbm_share=moved / (kernel_ms * 1e-3) / HBM_BYTES_S,
                    drim_r_model_gbit_s=drim_r[op],
                    paper_gpu_model_gbit_s=model_gpu[op],
                    drim_over_h100=drim_r[op] / h100[op],
                    drim_over_paper_gpu=drim_r[op] / model_gpu[op])
        print("bulk " + json.dumps(line))

    def avg(rows):
        return float(np.mean([rows[op] for op in FIG8_OPS]))

    print("bulk " + json.dumps({
        "summary": "DRIM-R over GPU, op-averaged (fig8_throughput.ratios)",
        "drim_over_h100": avg(drim_r) / avg(h100),
        "drim_over_paper_gpu_model": avg(drim_r) / avg(model_gpu),
        "paper_claim": PAPER_CLAIMS[("DRIM-R", "GPU")]}))
    return counts


def oracle_dots(a_bits: np.ndarray, b_bits: np.ndarray) -> np.ndarray:
    """The +-1 dots C = (2a - 1)(2b - 1)^T of sign bits in numpy (float64:
    every partial sum is an integer far below 2**53)."""
    a = 2.0 * a_bits.astype(np.float64) - 1.0
    b = 2.0 * b_bits.astype(np.float64) - 1.0
    return (a @ b.T).astype(np.int32)


def phase_queue(wrappers):
    """The per-bank command queues at full DRIM-R width (8 banks x 1024
    sub-arrays x 256 bits), three counted legs:

      uniform     -- `lower("queued", n_queues=8)` on xnor2 and on the
                     carry-save K=32 dot over one DRIM-R wave: the same
                     words as "resident", clean and at the +-15 % corner
                     (no kernel: the queued body is plain torch);
      partitioned -- `bnn_dot_partitioned` at K=32 (4 and 8 queues, one
                     wave of lanes) and K=128 (8 queues, the faults
                     phase's 4 waves) on "cuda" and "queued": the dots
                     equal the numpy oracle, the 4-queue K=32 critical
                     path is 113 AAPs, and "cuda" launches the
                     interpreter once per segment;
      chaos       -- the K=32 dot over 8 queues with a stage-0 kill and a
                     mid-graph kill, clean (exact against the oracle) and
                     TMR at the corner ("cuda" and "queued" bit for bit):
                     the interpreter (the faulted one under flips) once
                     per executed and once per requeued segment.

    Then the interpreters' CUDA-graph times at the largest segment's queue
    block ("queue" lines).  Returns the legs' launch counts."""
    from repro_torch.core import DRIM_R, FaultModel
    from repro_torch.launch import faults as payload
    from repro_torch.pim import compile as drim_compile, graph_ref_results
    from repro_torch.pim.bnn import (bnn_dot_graph_carrysave,
                                     bnn_dot_partitioned)
    from repro_torch.pim.graph import partition_graph
    from repro_torch.pim.queue import bank_blocks
    dev = torch.device("cuda")
    nq = DRIM_R.banks                              # one queue per bank
    wave_words = DRIM_R.n_subarrays * DRIM_R.row_bits // 32
    corner = FaultModel.from_corner(payload.CORNER, source="paper",
                                    seed=payload.SEED)
    g32, _ = bnn_dot_graph_carrysave(32)
    feeds32 = payload.fault_feeds(g32, wave_words)
    oracle32 = graph_ref_results(g32, feeds32)
    card32 = {n: torch.from_numpy(a.view(np.int32)).to(dev)
              for n, a in feeds32.items()}
    counts = {}
    t_phase = time.perf_counter()

    # -- uniform: the same stream on every queue ---------------------------
    def uniform():
        rng = np.random.default_rng([SEED, 20])
        a, b = (card_words(rng, wave_words) for _ in range(2))
        for faults in (None, corner):
            got = drim_compile("xnor2").lower("queued", n_queues=nq).run(
                a, b, device=dev, faults=faults)
            want = drim_compile("xnor2").lower("resident").run(
                a, b, device=dev, faults=faults)
            check_equal(f"queued xnor2 faults={faults is not None}",
                        got[0], want[0])
            t = time.perf_counter()
            low = drim_compile(g32).lower("queued", n_queues=nq)
            got = low.run(card32, device=dev, faults=faults)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            want = drim_compile(g32).lower("resident").run(
                card32, device=dev, faults=faults)
            for name in want:
                check_equal(f"queued K=32 {name} faults={faults is not None}",
                            got[name], want[name])
                if faults is None:
                    check_equal(f"queued K=32 {name} vs oracle",
                                got[name].cpu(), torch.from_numpy(
                                    oracle32[name].view(np.int32)))
            sched = low.schedule
            print("queue " + json.dumps({
                "lowering": "uniform queued K=32", "n_queues": nq,
                "faults": "corner" if faults else None,
                "fence_stages": sched.fence_stages,
                "critical_path_aaps": sched.aaps_per_tile,
                "issued_aaps": sched.issued_aaps_per_tile,
                "stall_aaps": sched.contention_stall_aaps,
                "identical_to_resident": True, "wall_s": wall}))
    _, counts["queue uniform"] = counted(wrappers, "queue uniform", uniform,
                                         lambda _: {})

    # -- partitioned: bnn_dot_partitioned on both bodies -------------------
    rng = np.random.default_rng([SEED, 21])
    dots = []                  # (k, queues, a, b): lanes M x N
    for k, queues, m, n in QUEUE_DOTS:
        dots.append((k, queues, rng.integers(0, 2, (m, k), dtype=np.uint8),
                     rng.integers(0, 2, (n, k), dtype=np.uint8)))
    segments = {(k, q): partition_graph(bnn_dot_graph_carrysave(k)[0], q)
                .segments for k, q, _, _ in dots}

    def partitioned():
        for k, queues, a, b in dots:
            want = oracle_dots(a, b)
            outs = {}
            for engine in ("cuda", "queued"):
                torch.cuda.synchronize()
                t = time.perf_counter()
                got, sched = bnn_dot_partitioned(a, b, geom=DRIM_R,
                                                 n_queues=queues,
                                                 engine=engine, device=dev)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                check_equal(f"partitioned K={k}@{queues} {engine} vs "
                            "oracle", got.cpu(), torch.from_numpy(want))
                outs[engine] = got
                if (k, queues) == (32, 4) and sched.aaps_per_tile != 113:
                    raise AssertionError(f"K=32 over 4 queues: critical "
                                         f"path {sched.aaps_per_tile}, not "
                                         "113 AAPs")
                print("queue " + json.dumps({
                    "lowering": f"partitioned K={k}", "engine": engine,
                    "n_queues": queues, "lanes": a.shape[0] * b.shape[0],
                    "words_per_plane": a.shape[0] * b.shape[0] // 32,
                    "segments": len(segments[k, queues]),
                    "fence_stages": sched.fence_stages,
                    "critical_path_aaps": sched.aaps_per_tile,
                    "issued_aaps": sched.issued_aaps_per_tile,
                    "stall_aaps": sched.contention_stall_aaps,
                    "waves_per_queue": sched.waves, "wall_s": wall}))
            check_equal(f"partitioned K={k}@{queues} cuda vs queued",
                        outs["cuda"], outs["queued"])

    _, counts["queue partitioned"] = counted(
        wrappers, "queue partitioned", partitioned,
        lambda _: {"aap_interp": sum(len(segs) for segs in
                                     segments.values())})

    # -- chaos: dead queues requeued on survivors --------------------------
    kills = {"stage-0 kill": (3,), "mid-graph kill": ((0, 2),)}
    lows = {(engine, harden): drim_compile(g32).lower(
        engine, partition=True, n_queues=nq, harden=harden)
        for engine in ("cuda", "queued") for harden in (None, "tmr")}
    launched = {"aap_interp": 0, "aap_interp_faulted": 0}

    def chaos():
        for kill, dead in kills.items():
            for harden, flips in ((None, None), ("tmr", corner)):
                fm = (dataclasses.replace(flips, dead_queues=dead)
                      if flips else FaultModel(dead_queues=dead))
                death = dict(fm.dead_queues)
                outs = {}
                for engine in ("cuda", "queued"):
                    low = lows[engine, harden]
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    outs[engine] = low.run(card32, device=dev, faults=fm)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t
                    rep = low.chaos_report
                    orphans = [s for s in low.gp.segments
                               if s.stage >= death.get(s.part,
                                                       low.gp.n_stages)]
                    if rep is None or rep.requeued_segments != len(orphans) \
                            or rep.dead_queues != tuple(sorted(death)) \
                            or rep.detected_stages != tuple(sorted(
                                {s.stage for s in orphans})):
                        raise AssertionError(f"chaos {kill} {harden}: report "
                                             f"{rep}, orphans {orphans}")
                    if engine == "cuda":
                        launched["aap_interp_faulted" if flips else
                                 "aap_interp"] += \
                            len(low.gp.segments) - len(orphans) + \
                            rep.requeued_segments
                    if (engine, harden, kill) == ("cuda", "tmr", ARMED_KILL):
                        CHAOS_DISARMED.update(
                            feeds=card32, faults=fm, report=rep,
                            words={n: v.clone() for n, v in
                                   outs[engine].items()},
                            launches=len(low.gp.segments) - len(orphans)
                            + rep.requeued_segments)
                    print("chaos " + json.dumps({
                        "kill": kill, "engine": engine,
                        "harden": harden, "faults":
                        "corner" if flips else None,
                        "dead_queues": list(rep.dead_queues),
                        "death_stages": [list(d) for d in rep.death_stages],
                        "detected_stages": list(rep.detected_stages),
                        "requeued_segments": rep.requeued_segments,
                        "segments": len(low.gp.segments),
                        "data_parallel": rep.data_parallel,
                        "recovery_s": rep.recovery_s,
                        "compile_s": rep.compile_s, "wall_s": wall}))
                for name in oracle32:
                    check_equal(f"chaos {kill} {harden} {name} cuda vs "
                                "queued", outs["cuda"][name],
                                outs["queued"][name])
                    if harden is None:
                        check_equal(f"chaos {kill} {name} vs oracle",
                                    outs["cuda"][name].cpu(),
                                    torch.from_numpy(
                                        oracle32[name].view(np.int32)))

    _, counts["queue chaos"] = counted(wrappers, "queue chaos", chaos,
                                       lambda _: dict(launched))

    # -- the interpreters at the largest segment's queue block (not counted)
    trng = np.random.default_rng([SEED, 22])
    geom_q = dataclasses.replace(DRIM_R, banks=DRIM_R.banks // nq)
    cols = geom_q.n_subarrays * geom_q.row_bits // 32
    seg = max(segments[128, nq], key=lambda s: s.fp.aaps_per_tile)
    waves = payload.WAVES * nq           # the K=128 dot's 4 waves, per queue
    detail, _ = interp_case(f"queue segment K=128@{nq}", seg.fp.program,
                            seg.fp.readback_rows, seg.fp.template_rows,
                            waves, len(seg.fp.loaded_inputs), cols, trng)
    low = lows["cuda", "tmr"]
    seg = max(low.gp.segments, key=lambda s: s.fp.aaps_per_tile)
    prot = [k for i, lo, hi in seg.fp.node_spans
            if seg.node_ids[i] in low.protected_nodes
            for k in range(lo, hi)]
    fm = corner.with_protected(prot) if prot else corner
    g4 = (geom_q.chips, geom_q.banks, geom_q.subarrays_per_bank,
          geom_q.row_bits // 32)
    fdetail, _ = faulted_case(
        f"queue segment TMR K=32@{nq}", seg.fp.program, seg.fp.readback_rows,
        seg.fp.template_rows, wave_words // cols, len(seg.fp.loaded_inputs),
        g4, fm,
        (bank_blocks(DRIM_R.banks, nq)[seg.part][0], DRIM_R.banks), trng)
    for d in (detail, fdetail):
        print("queue " + json.dumps({
            "kernel": d["kernel"], "case": d["case"], "n_ins": d["n_ins"],
            "waves": d["waves"], "cols": d["cols"], "ms": d["ms"],
            "bound_ms": d["bound_ms"], "bound_by": d["bound_by"]}))
    print("queue " + json.dumps({"phase_wall_s":
                                 time.perf_counter() - t_phase}))
    return counts


def phase_verdict(wrappers):
    """The DRIM-vs-GPU placement Verdict on DRIM-R (`Lowered.verdict`,
    `pim.offload`) at one DRIM-R wave (`offload.SIMULATE_MAX_BITS`), four
    lowerings on "cuda": xnor2, the carry-save K=32 dot, the same under
    tmr+ecc at the faults phase's Table-3 corner, the same over 4 queues.

    Counted leg: each `verdict(simulate=True)` runs on the card (the
    interpreter once for the op and the fused dot, once per segment of the
    partition, the faulted one once under the corner) and its rows must
    equal `verdict(simulate=False)`'s field by field; each distinct program
    runs once on "gpu" (one bulk kernel per node), its words equal to
    numpy's.  Then, not counted: each "gpu" program's CUDA-graph time at
    2**21 and 2**29 bits beside the Verdict's GPU row (`gpu_cost`),
    `serving_verdict` of the drim-bnn decode FFN pair at batch 4 on
    "resident", "cuda" and "queued" (8 queues), `plan_model_payloads` of
    drim-bnn, and the verifier's CLI ("verdict" lines).  Returns the leg's
    counts."""
    from repro_torch.configs import get_config
    from repro_torch.core import FaultModel
    from repro_torch.launch import faults as payload
    from repro_torch.pim import (compile as drim_compile, graph_ref_results,
                                 plan_model_payloads, serving_verdict)
    from repro_torch.pim.bnn import bnn_dot_graph_carrysave
    from repro_torch.pim.compiler import (NATIVE_OP, _native_graph,
                                          _native_node)
    from repro_torch.pim.offload import SIMULATE_MAX_BITS, gpu_cost
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    n_bits = SIMULATE_MAX_BITS
    n_words = n_bits // 32
    corner = FaultModel.from_corner(payload.CORNER, source="paper",
                                    seed=payload.SEED)
    g32, _ = bnn_dot_graph_carrysave(32)
    cases = {"xnor2": ("xnor2", {}),
             "carry-save K=32": (g32, {}),
             "carry-save K=32 tmr+ecc": (g32, dict(harden="tmr+ecc",
                                                   faults=corner)),
             "carry-save K=32 over 4 queues": (g32, dict(partition=True,
                                                         n_queues=4))}
    # the distinct programs the GPU contender runs (a partition is the
    # fused dot's graph)
    gpu_cases = {"xnor2": ("xnor2", None), "carry-save K=32": (g32, None),
                 "carry-save K=32 tmr+ecc": (g32, "tmr+ecc")}
    feeds = payload.fault_feeds(g32, n_words)
    oracle = graph_ref_results(g32, feeds)
    on_card = {n: torch.from_numpy(a.view(np.int32)).to(dev)
               for n, a in feeds.items()}

    def body():
        lows, gpus = {}, {}
        for label, (src, kw) in cases.items():
            low = drim_compile(src).lower("cuda", **kw)
            torch.cuda.synchronize()
            t = time.perf_counter()
            sim = low.verdict(n_bits, simulate=True, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            closed = low.verdict(n_bits)
            if not sim.simulated or closed.simulated or \
                    (sim.workload, sim.n_nodes, sim.rows) != \
                    (closed.workload, closed.n_nodes, closed.rows):
                raise AssertionError(f"verdict {label}: simulated {sim} != "
                                     f"closed form {closed}")
            big = low.verdict(BULK_BITS)
            for v in (sim, big):
                print("verdict " + json.dumps({
                    "lowering": label, "engine": "cuda",
                    "workload": v.workload, "n_bits": v.n_bits,
                    "simulated": v.simulated, "winner": v.winner,
                    "drim_rows_equal_closed_form": True,
                    "rows": [dataclasses.asdict(r) for r in v.rows],
                    **({"simulate_wall_s": wall} if v is sim else {})}))
            lows[label] = low
        for label, (src, harden) in gpu_cases.items():
            low = drim_compile(src).lower("gpu", harden=harden)
            if low.kind == "op":
                a, b = on_card["a0"], on_card["b0"]
                check_equal("verdict gpu xnor2", low.run(a, b, device=dev)[0],
                            ~(a ^ b))
            else:
                got = low.run(on_card, device=dev)
                for name, want in oracle.items():
                    check_equal(f"verdict gpu {label} {name}", got[name].cpu(),
                                torch.from_numpy(want.view(np.int32)))
                if harden and low.last_ecc.mismatch_bits != 0:
                    raise AssertionError(f"verdict gpu {label}: ECC "
                                         f"{low.last_ecc}")
            gpus[label] = low
        return lows, gpus

    def expected(out):
        """The prediction: the interpreter once for the op, once for the
        fused dot, once per segment of the 4-queue partition (23), the
        faulted one once; one bulk kernel per "gpu" node, by kind."""
        lows, gpus = out
        segments = len(lows["carry-save K=32 over 4 queues"].gp.segments)
        if segments != 23:
            raise AssertionError(f"K=32 over 4 queues: {segments} segments, "
                                 "not 23")
        per = {"aap_interp": 25, "aap_interp_faulted": 1,
               "bitwise_not": 0, "bitwise_binary": 0, "bitwise_ternary": 0}
        for low in gpus.values():
            ops = [low.op] if low.kind == "op" else \
                [op for op, _, _ in low.graph.nodes if op != "copy"]
            for op in ops:
                per[bitwise_kernel(NATIVE_OP[op])[0]] += 1
        return per

    (lows, gpus), counts = counted(wrappers, "verdict", body, expected)

    # -- the GPU contender measured against its roofline (not counted) -----
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for bits in VERDICT_BITS:
        words = bits // 32
        planes = {n: (torch.zeros(words, dtype=torch.int32, device=dev)
                      if n == "zero" else torch.randint(
                          -2 ** 31, 2 ** 31, (words,), dtype=torch.int32,
                          device=dev, generator=gen))
                  for n in g32.input_names}
        for label, low in gpus.items():
            if low.kind == "op":
                def fn(a=planes["a0"], b=planes["b0"]):
                    return _native_node("xnor2", [a, b])
                kernels = 1
            else:
                def fn(graph=low.graph):
                    return _native_graph(graph, planes)
                kernels = sum(op != "copy" for op, _, _ in low.graph.nodes)
            ms = graph_ms(fn, 20 if bits < BULK_BITS else 3, replays=3)
            cost = gpu_cost(low, bits)
            print("verdict " + json.dumps({
                "gpu_program": label, "n_bits": bits,
                "kernels_per_call": kernels, "measured_ms": ms,
                "roofline_ms": cost.latency_s * 1e3,
                "roofline_bound_by": ("bytes" if cost.dma_s >= cost.compute_s
                                      else "operations"),
                "measured_over_roofline": ms / (cost.latency_s * 1e3)}))
        del planes

    # -- serving_verdict, model payloads, the verifier's CLI ----------------
    cfg = get_config("drim-bnn")
    for m, n, k in ((4, cfg.d_ff, cfg.d_model), (4, cfg.d_model, cfg.d_ff)):
        for engine, nq in (("resident", None), ("cuda", None), ("queued", 8)):
            v = serving_verdict(m, n, k, engine=engine, n_queues=nq)
            print("verdict " + json.dumps({
                "serving": v.workload, "engine": engine, "n_queues": nq,
                "n_nodes": v.n_nodes, "winner": v.winner,
                "rows": [dataclasses.asdict(r) for r in v.rows]}))
    for name, v in plan_model_payloads(cfg).items():
        print("verdict " + json.dumps({
            "payload": name, "arch": cfg.arch, "n_bits": v.n_bits,
            "winner": v.winner,
            "rows": [dataclasses.asdict(r) for r in v.rows]}))
    argv = ["--k", "32", "--partition", "4", "--harden", "tmr,ecc,tmr+ecc"]
    t = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.pim.verify", *argv],
        capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    cli_s = time.perf_counter() - t
    lines = cli.stdout.splitlines()
    if cli.returncode != 0 or not lines or \
            lines[-1] != "all lowerings verified clean":
        raise AssertionError(f"verify CLI exited {cli.returncode}: "
                             f"{cli.stdout[-2000:]}{cli.stderr[-2000:]}")
    walls = [float(line.split("wall=")[1].split("ms")[0])
             for line in lines if "wall=" in line]
    print("verdict " + json.dumps({
        "verify_cli": " ".join(argv), "exit": cli.returncode,
        "lowerings": len(walls), "wall_ms_total": sum(walls),
        "wall_ms_max": max(walls), "process_s": cli_s}))
    print("verdict " + json.dumps({"phase_wall_s":
                                   time.perf_counter() - t_phase}))
    return counts


def check_ste_product(rng):
    """The dense STE product on the card at a decode shape (M=4, K=3072,
    the down projection): the port's float32 product rounded once must
    equal the exact dot; also reports whether a plain bfloat16 matmul of
    the same ±1 operands (the formulation before the float32 repair)
    happens to round the same way on this card."""
    from repro_torch.models import layers
    dev = torch.device("cuda")
    x = torch.from_numpy(rng.standard_normal((4, 3072), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((3072, 768), dtype=np.float32))
    x, w = x.to(dev, torch.bfloat16), w.to(dev, torch.bfloat16)
    sx = torch.where(x >= 0, 1.0, -1.0)
    sw = torch.where(w >= 0, 1.0, -1.0)
    exact = (sx.double() @ sw.double()).to(torch.bfloat16)
    alpha = w.abs().mean(0)
    got = layers.bitlinear({"bkernel": w}, x)
    if not torch.equal(got, exact * alpha):
        raise AssertionError("dense STE product is not the exact dot")
    bf16 = sx.to(torch.bfloat16) @ sw.to(torch.bfloat16)
    print("detail " + json.dumps({
        "check": "bfloat16 ±1 product, M=4 K=3072 N=768",
        "float32_route_exact": True,
        "bfloat16_matmul_differs": int((bf16 != exact).sum())}))


def phase_path(rng):
    """The drim-bnn FFN BitLinear pair at full width, both routes."""
    from repro_torch.configs.drim_bnn import CONFIG
    from repro_torch.core import DRIM_R
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import xnor_gemm_dense_ref
    from repro_torch.models.layers import bitlinear_from_jax, serving_engine
    from repro_torch.pim.bnn import serve_bnn_matmul
    dev = torch.device("cuda")
    d_model, d_ff = CONFIG.d_model, CONFIG.d_ff
    x_np = rng.standard_normal((M_ROWS, d_model), dtype=np.float32)
    w_up = rng.standard_normal((d_model, d_ff), dtype=np.float32) \
        / np.sqrt(d_model)
    w_down = rng.standard_normal((d_ff, d_model), dtype=np.float32) \
        / np.sqrt(d_ff)

    x = torch.from_numpy(x_np).to(dev)
    x_cpu = torch.from_numpy(x_np)
    for name, w in (("up", w_up), ("down", w_down)):
        k = w.shape[0]
        t0 = time.perf_counter()
        layer = bitlinear_from_jax({"bkernel": w}, device=dev).pack()
        y_native = layer(x)
        d_native = ops.binary_matmul(x, layer.w_packed, k, dtype=torch.int32)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with serving_engine("cuda", geom=DRIM_R):
            y_drim = layer(x)
        d_drim = serve_bnn_matmul(
            ops.sign_bits(x), ops.unpack_sign_bits(layer.w_packed, k),
            engine="cuda", geom=DRIM_R, device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        d_ref = xnor_gemm_dense_ref(x_cpu, torch.from_numpy(w).T)
        for route, d in (("native", d_native), ("drim", d_drim)):
            if d.shape != (M_ROWS, w.shape[1]) or \
                    not torch.equal(d.cpu(), d_ref):
                raise AssertionError(f"{name}: {route} route dots differ "
                                     "from the plain reference")
        if not torch.equal(y_native, y_drim):
            raise AssertionError(f"{name}: native and DRIM BitLinear "
                                 "outputs differ")
        if not torch.isfinite(y_native).all():
            raise AssertionError(f"{name}: non-finite BitLinear output")
        print("path " + json.dumps({
            "projection": name, "m": M_ROWS, "k": k, "n": w.shape[1],
            "native_route_s": t1 - t0, "drim_route_s": t2 - t1,
            "dots_equal_reference": True}))
        x, x_cpu = y_native, y_native.cpu()


def serve_line(leg: str, stats, verified) -> None:
    """A leg's serving stats, with the verifier's wall seconds in it (all
    of it inside the warm-up step that `compile_s` times)."""
    keys = ("prefill_s", "compile_s", "decode_tok_per_s", "decode_p50_ms",
            "decode_p99_ms", "n_waves", "wall_s", "tok_per_s")
    line = {"leg": leg, **{k: stats[k] for k in keys if k in stats},
            "verify_programs": verified["programs"],
            "verify_s": verified["wall_s_total"]}
    if "compile_s" in stats:
        line["verify_share_of_compile"] = (verified["wall_s_total"]
                                           / stats["compile_s"])
    print("serve " + json.dumps(line))


def serve_launches(cfg, args):
    """`expected_launches` of a static serving leg of SERVE_GEN tokens:
    the prefill, then on the native packed route the bit-exactness
    check's packed step and every decode step (the warm-up included);
    the DRIM route decodes on the fleet."""
    native = 0 if not args.packed else 2 + (
        SERVE_GEN if args.engine == "gpu" else 0)
    return expected_launches(
        cfg, packed=args.packed, native_fwd=native,
        drim_steps=SERVE_GEN if args.engine == "cuda" else 0, aligned=1)


@contextlib.contextmanager
def logits_tap():
    """Record, without a host sync, the logits of the serving loop's
    prefill and the top-two gap of each decode call's logits (the warm-up
    step's first); yields {"prefill": [...], "gaps": [...]}."""
    from repro_torch.launch import batching, serve
    tap = {"prefill": [], "gaps": []}
    prefill, decode = serve.prefill, batching.decode_step

    def tapped_prefill(*args, **kw):
        lg, caches = prefill(*args, **kw)
        tap["prefill"].append(lg.detach().clone())
        return lg, caches

    def tapped_decode(*args, **kw):
        lg, caches = decode(*args, **kw)
        top = lg[:, -1].topk(2, -1).values
        tap["gaps"].append(top[:, 0] - top[:, 1])
        return lg, caches
    serve.prefill, batching.decode_step = tapped_prefill, tapped_decode
    try:
        yield tap
    finally:
        serve.prefill, batching.decode_step = prefill, decode


def tap_values(tap):
    """A tap's prefill logits [B, V] and the top-two gap of every
    generated token's logits [B, gen] (token 0 from the prefill, token t
    from decode call t: call 0 is the warm-up of token 1), on the host."""
    lg = tap["prefill"][0][:, -1].float().cpu()
    top = lg.topk(2, -1).values
    gaps = [top[:, 0] - top[:, 1]] + [g.float().cpu()
                                      for g in tap["gaps"][1:]]
    return {"prefill": lg, "gaps": torch.stack(gaps, 1)}


def expected_launches(cfg, *, packed: bool, native_fwd: int,
                      drim_steps: int, aligned: int):
    """The launches a serving leg must make: flash once per layer per
    prefill whose length is a multiple of 128 (`aligned` of them); on a
    packed route the packer once per BitLinear weight matrix (the offline
    packing) and, like the GEMM, once per BitLinear per native forward
    (`native_fwd`: each prefill, the bit-exactness check's packed step,
    each native decode step); the interpreter once per K chunk per
    BitLinear per DRIM decode step."""
    from repro_torch.pim.bnn import k_chunks
    n_bl = 3 * cfg.n_layers                      # gate, up, down per layer
    chunks = cfg.n_layers * sum(len(k_chunks(k)) for k in
                                (cfg.d_model, cfg.d_model, cfg.d_ff))
    gemm = n_bl * native_fwd if packed else 0
    return {"pack_signs": gemm + n_bl if packed else 0, "xnor_gemm": gemm,
            "aap_interp": chunks * drim_steps, "aap_interp_faulted": 0,
            "flash_attn_fwd": cfg.n_layers * aligned}


def install_verify_tally() -> None:
    """Record the wall time of every verify pass the pipeline runs (the
    verifier's own `VerifyReport.wall_s`), for the "verify" lines."""
    from repro_torch.pim import verify
    inner = verify.verify_state

    def timed(st):
        try:
            rep = inner(st)
        except verify.VerifyError as err:
            VERIFY_WALLS.append(err.report.wall_s)
            raise
        VERIFY_WALLS.append(rep.wall_s)
        return rep
    verify.verify_state = timed


def verify_mark():
    from repro_torch.pim.verify import VERIFY_STATS
    return dict(VERIFY_STATS), len(VERIFY_WALLS)


def verify_since(mark):
    """The verify passes run since `mark`: programs, clean, failed and
    their wall seconds (total and largest)."""
    from repro_torch.pim.verify import VERIFY_STATS
    stats, n = mark
    walls = VERIFY_WALLS[n:]
    got = {k: VERIFY_STATS[k] - stats.get(k, 0)
           for k in ("programs", "clean", "failed")}
    return {**got, "wall_s_total": sum(walls),
            "wall_s_max": max(walls, default=0.0)}


def verify_line(leg: str, mark):
    """Print a leg's "verify" line; fail if a program failed or went
    unrecorded."""
    got = verify_since(mark)
    print("verify " + json.dumps({"phase": leg, **got}))
    if got["failed"] or got["clean"] != got["programs"] \
            or len(VERIFY_WALLS) - mark[1] != got["programs"]:
        raise AssertionError(f"{leg}: verifier {got}")
    return got


def verified_phase(phase: str, run):
    """`run()` and print the "verify" line of the whole phase: lowerings
    a phase makes outside its counted legs are verified too."""
    mark = verify_mark()
    result = run()
    verify_line(f"{phase} (whole phase)", mark)
    return result


def counted(wrappers, leg: str, run, want_of):
    """Zero every launch counter, `run()`, read the counters and hold them
    to `want_of(result)` (a counter it does not name must stay 0), and
    print the leg's "verify" line; returns (result, counts)."""
    for fn in wrappers.values():
        fn.launches = 0
    mark = verify_mark()
    result = run()
    got = {name: fn.launches for name, fn in wrappers.items()}
    print("counts " + json.dumps({"phase": leg, **got}))
    verify_line(leg, mark)
    named = want_of(result)
    if not set(named) <= set(wrappers):
        raise AssertionError(f"{leg}: no counter for {set(named) - set(wrappers)}")
    want = {name: named.get(name, 0) for name in wrappers}
    if got != want:
        raise AssertionError(f"{leg}: launches {got}, expected {want}")
    return result, got


def phase_serve(wrappers):
    """The drim-bnn LM served at full width and depth through the serving
    entry points, three routes with identical tokens; then the continuous
    batcher on two routes.  Each leg's launches are counted on their own;
    returns them by leg."""
    from repro_torch.launch import serve
    legs = SERVE_LEGS
    cfg = serve.build_cfg(serve.parse_args(SERVE))
    n_gen = SERVE_GEN
    gens, counts = {}, {}
    for leg, extra in legs.items():
        args = serve.parse_args(SERVE + extra)
        mark = verify_mark()
        with logits_tap() as tap:
            (gen, stats), counts[leg] = counted(
                wrappers, leg, lambda: serve.run_serve(args),
                lambda _, args=args: serve_launches(cfg, args))
        if leg == "gpu dense":
            ONE_PROCESS["drim-bnn"] = {"gen": gen, **tap_values(tap)}
        if gen.shape != (4, n_gen) or gen.min() < 0 \
                or gen.max() >= cfg.vocab_size:
            raise AssertionError(f"{leg}: bad token ids {gen.tolist()}")
        gens[leg] = gen
        serve_line(leg, stats, verify_since(mark))
    SERVED.update(gens)
    first = gens["gpu dense"]
    for leg, gen in gens.items():
        if not np.array_equal(gen, first):
            raise AssertionError(f"{leg} tokens {gen.tolist()} differ from "
                                 f"gpu dense {first.tolist()}")
    print("serve " + json.dumps({"tokens_identical": True,
                                 "tokens": first.tolist()}))

    prompts = [np.random.default_rng([SEED, 2]).integers(0, cfg.vocab_size, n)
               for n in (256, 200)]
    results = {}
    for leg in ("gpu packed", "cuda packed"):
        args = serve.parse_args(SERVE + legs[leg] + ["--batch", "2",
                                                     "--continuous", "2"])
        drim = args.engine == "cuda"
        # one prefill per request, only the 256-token one aligned; one
        # decode step per wave
        mark = verify_mark()
        (res, stats), counts["continuous " + leg] = counted(
            wrappers, "continuous " + leg,
            lambda: serve.run_continuous(args, prompts=prompts),
            lambda out, drim=drim: expected_launches(
                cfg, packed=True,
                native_fwd=2 + (0 if drim else out[1]["n_waves"]),
                drim_steps=out[1]["n_waves"] if drim else 0, aligned=1))
        serve_line("continuous " + leg, stats, verify_since(mark))
        results[leg] = res
    for r in range(2):
        a, b = results["gpu packed"][r], results["cuda packed"][r]
        if len(a) != n_gen or not np.array_equal(a, b):
            raise AssertionError(f"continuous request {r}: {a.tolist()} vs "
                                 f"{b.tolist()}")
    print("serve " + json.dumps({"continuous_tokens_identical": True,
                                 "tokens": {r: v.tolist() for r, v in
                                            results["gpu packed"].items()}}))
    return counts


def span_counts(events, key: str = "name"):
    """{span name (or another key): count} of a trace's complete ("X")
    events."""
    counts: dict = {}
    for e in events:
        if e["ph"] == "X":
            counts[e[key]] = counts.get(e[key], 0) + 1
    return dict(sorted(counts.items()))


def namespaces(counters, names):
    return {k: v for k, v in counters.items()
            if k.rsplit(".", 1)[0] in names}


def phase_telemetry(wrappers):
    """The observability layer (`runtime.telemetry`) and the serve flags
    that need it, on the card, five counted legs:

      cuda packed armed    -- `serve.main` with --telemetry and
                              --trace-out, 4 tokens at the disarmed leg's
                              cache length: its tokens are the disarmed
                              "cuda packed" leg's first 4, its launches
                              `expected_launches` of 4 DRIM steps (arming
                              adds none), and the trace holds 3
                              "decode:token" spans and one "Lowered.run"
                              span per interpreter launch (3 steps' worth
                              inside the timed spans);
      microbench cuda/gpu  -- `run_microbench` (--gen 4): 4 prefills and
                              1 + 3 decode steps' launches;
      resilient fallback   -- `run_serve --resilient` on "cuda" --packed
                              whose "cuda" decode fn raises: 2 retries,
                              1 fallback to "gpu", the "gpu packed" leg's
                              tokens and launches, the incidents on the
                              registry;
      chaos armed          -- the queue phase's TMR run at the corner
                              under ARMED_KILL, armed: the same words,
                              report (timings aside) and launches, and a
                              trace with one sim process of 8 queue
                              tracks, a DEAD instant per dead queue,
                              requeue spans and ``chaos.*`` gauges equal
                              to the report.

    Registry counts are read as `delta`s: a `telemetry.fresh()` block
    would restore `VERIFY_STATS` under the "verify" lines.  Returns the
    legs' launch counts."""
    from repro_torch.core import DRIM_R
    from repro_torch.launch import batching, serve
    from repro_torch.pim import compile as drim_compile
    from repro_torch.pim.bnn import bnn_dot_graph_carrysave
    from repro_torch.runtime import telemetry
    cfg = serve.build_cfg(serve.parse_args(SERVE))
    counts = {}
    reg = telemetry.REGISTRY
    t_phase = time.perf_counter()

    # -- the armed serving leg ---------------------------------------------
    trace_serve = TRACE_DIR / "trace_serve.json"
    argv = SERVE + ["--engine", "cuda", "--packed", "--telemetry",
                    "--trace-out", str(trace_serve), "--gen", "4",
                    "--ctx", "264"]

    def armed_serve():
        out = io.StringIO()
        with telemetry.armed(False):            # main arms; disarm after
            telemetry.clear_trace()
            before = reg.snapshot()
            with contextlib.redirect_stdout(out):
                gen = serve.main(argv)
            delta = reg.delta(before)
            telemetry.clear_trace()
        return gen, json.loads(out.getvalue().strip().splitlines()[-1]), \
            delta

    mark = verify_mark()
    (gen, stats, delta), counts["cuda packed armed"] = counted(
        wrappers, "cuda packed armed", armed_serve,
        lambda _: expected_launches(cfg, packed=True, native_fwd=2,
                                    drim_steps=4, aligned=1))
    serve_line("cuda packed armed", stats, verify_since(mark))
    if not np.array_equal(gen, SERVED["cuda packed"][:, :4]):
        raise AssertionError(f"armed tokens {gen.tolist()} differ from the "
                             f"disarmed {SERVED['cuda packed'].tolist()}")
    with open(stats["trace_out"]) as f:
        events = json.load(f)["traceEvents"]
    spans = span_counts(events)
    decode = [e for e in events if e["ph"] == "X"
              and e["name"] == "decode:token"]
    runs = [e for e in events if e["ph"] == "X"
            and e["name"] == "Lowered.run"]
    timed = [e for e in runs if any(d["ts"] <= e["ts"] and e["ts"] + e["dur"]
                                    <= d["ts"] + d["dur"] for d in decode)]
    interp = counts["cuda packed armed"]["aap_interp"]
    if len(decode) != 3 or len(runs) != interp \
            or 4 * len(timed) != 3 * interp:
        raise AssertionError(f"armed trace: {len(decode)} decode spans, "
                             f"{len(runs)} runs ({len(timed)} timed) for "
                             f"{interp} interpreter launches")
    print("telemetry " + json.dumps({
        "leg": "cuda packed armed", "trace": str(trace_serve),
        "events": len(events), "spans": spans,
        "timed_runs": len(timed),
        "counters": namespaces(delta["counters"],
                               ("encode_cache", "lower_cache",
                                "drim.verify")),
        "decode_p50_ms_armed": stats["decode_p50_ms"],
        "armed": stats["telemetry"]["armed"]}))

    # -- the microbenchmark split ------------------------------------------
    for leg, extra in (("microbench cuda packed", ["--engine", "cuda"]),
                       ("microbench gpu packed", ["--engine", "gpu"])):
        args = serve.parse_args(SERVE + extra + ["--packed", "--microbench",
                                                 "--gen", "4"])
        drim = args.engine == "cuda"
        # 4 prefills (1 + 3 timed); 1 + 3 decode steps, native or DRIM
        stats, counts[leg] = counted(
            wrappers, leg, lambda args=args: serve.run_microbench(args)[1],
            lambda _, drim=drim: expected_launches(
                cfg, packed=True, native_fwd=4 + (0 if drim else 4),
                drim_steps=4 if drim else 0, aligned=4))
        print("serve " + json.dumps({"leg": leg, **stats["microbench"]}))

    # -- resilient fallback --------------------------------------------------
    def make_fn(cfg_, ctx_len, temperature, engine, n_queues):
        if engine == "cuda":
            def wedged(*args):
                raise RuntimeError("cuda decode wedged")
            return wedged
        return batching.make_decode_fn(cfg_, ctx_len, temperature, engine,
                                       n_queues)

    def resilient():
        before = reg.snapshot()
        out = serve.run_serve(serve.parse_args(
            SERVE + ["--engine", "cuda", "--packed", "--resilient"]),
            make_fn=make_fn, sleep=lambda s: None)
        return out, reg.delta(before)

    mark = verify_mark()
    ((gen, stats), delta), counts["resilient fallback"] = counted(
        wrappers, "resilient fallback", resilient,
        lambda _: expected_launches(cfg, packed=True, native_fwd=2 + 8,
                                    drim_steps=0, aligned=1))
    actions = [i["action"] for i in stats["incidents"]]
    incidents = namespaces(delta["counters"], ("serve",))
    if actions != ["retry(backoff=0.05s)", "retry(backoff=0.1s)",
                   "fallback:gpu"] or stats["engine"] != "gpu" \
            or incidents != {"serve.incident:retry": 2,
                             "serve.incident:fallback": 1} \
            or not np.array_equal(gen, SERVED["gpu packed"]):
        raise AssertionError(f"resilient fallback: {actions}, {incidents}, "
                             f"engine {stats['engine']}, tokens "
                             f"{gen.tolist()}")
    serve_line("resilient fallback", stats, verify_since(mark))
    print("serve " + json.dumps({"leg": "resilient fallback",
                                 "incidents": stats["incidents"],
                                 "counters": incidents,
                                 "tokens_equal_gpu_packed": True}))

    # -- the chaos leg, armed ------------------------------------------------
    ref = CHAOS_DISARMED
    nq = DRIM_R.banks
    low = drim_compile(bnn_dot_graph_carrysave(32)[0]).lower(
        "cuda", partition=True, n_queues=nq, harden="tmr")
    trace_queue = TRACE_DIR / "trace_queue.json"

    def chaos_armed():
        with telemetry.armed(True):
            telemetry.clear_trace()
            before = reg.snapshot()
            outs = low.run(ref["feeds"], device=torch.device("cuda"),
                           faults=ref["faults"])
            torch.cuda.synchronize()
            path = telemetry.export_trace(str(trace_queue))
            delta = reg.delta(before)
            telemetry.clear_trace()
        return outs, low.chaos_report, path, delta

    (outs, rep, path, delta), counts["chaos armed"] = counted(
        wrappers, "chaos armed", chaos_armed,
        lambda _: {"aap_interp_faulted": ref["launches"]})
    for name, want in ref["words"].items():
        check_equal(f"chaos armed {name}", outs[name], want)
    timings = ("recovery_s", "compile_s")
    got_rep, want_rep = (
        {k: v for k, v in dataclasses.asdict(r).items() if k not in timings}
        for r in (rep, ref["report"]))
    if got_rep != want_rep:
        raise AssertionError(f"chaos armed report {got_rep} != {want_rep}")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    sims = {e["pid"] for e in events if e["ph"] == "M"
            and e["name"] == "process_name"
            and e["args"]["name"].startswith("drim-sim")}
    tracks = [e["args"]["name"] for e in events if e["ph"] == "M"
              and e["name"] == "thread_name" and e["pid"] in sims]
    dead = [e for e in events if e.get("cat") == "chaos"
            and e["name"].endswith("DEAD")]
    requeues = [e for e in events if e.get("cat") == "chaos-requeue"]
    gauges = {k: v for k, v in delta["gauges"].items()
              if k.startswith("chaos.")}
    if len(sims) != 1 or len(tracks) != nq \
            or not all(t.startswith("queue ") for t in tracks) \
            or len(dead) != len(rep.dead_queues) or not requeues \
            or gauges != {"chaos.compile_s": rep.compile_s,
                          "chaos.recovery_s": rep.recovery_s} \
            or delta["counters"].get("chaos.requeued_segments") \
            != rep.requeued_segments:
        raise AssertionError(f"chaos armed trace: {len(sims)} sim "
                             f"processes, tracks {tracks}, {len(dead)} DEAD, "
                             f"{len(requeues)} requeue spans, gauges "
                             f"{gauges}, counters {delta['counters']}")
    print("telemetry " + json.dumps({
        "leg": "chaos armed", "kill": ARMED_KILL, "trace": path,
        "events": len(events),
        "host_spans": span_counts([e for e in events
                                   if e["pid"] not in sims]),
        "sim_spans_by_cat": span_counts([e for e in events
                                         if e["pid"] in sims], "cat"),
        "sim_processes": len(sims), "queue_tracks": len(tracks),
        "dead_instants": len(dead), "requeue_spans": len(requeues),
        "gauges": gauges,
        "counters": namespaces(delta["counters"], ("chaos", "faults",
                                                   "encode_cache"))}))
    print("telemetry " + json.dumps({"phase_wall_s":
                                     time.perf_counter() - t_phase}))
    return counts


def phase_faults(wrappers):
    """Table-3 fault injection on the K=128 serving dot at full width on
    DRIM-R, every harden scheme, engines held bit-identical; returns the
    phase's launch counts."""
    from repro_torch.core import DRIM_R, FaultModel
    from repro_torch.launch import faults as payload
    from repro_torch.pim import compile as drim_compile, graph_ref_results
    from repro_torch.pim.bnn import bnn_dot_graph_carrysave
    dev = torch.device("cuda")
    graph, _ = bnn_dot_graph_carrysave(payload.K_BITS)
    n_words = payload.WAVES * DRIM_R.n_subarrays * DRIM_R.row_bits // 32
    feeds = payload.fault_feeds(graph, n_words)
    t0 = time.perf_counter()
    oracle = graph_ref_results(graph, feeds)
    oracle_s = time.perf_counter() - t0
    on_card = {n: torch.from_numpy(a.view(np.int32)).to(dev)
               for n, a in feeds.items()}
    corner = FaultModel.from_corner(payload.CORNER, source="paper",
                                    seed=payload.SEED)

    def run(engine, scheme, faults):
        low = drim_compile(graph, geom=DRIM_R).lower(engine, harden=scheme,
                                                     faults=faults)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = low.run(on_card, device=dev)
        torch.cuda.synchronize()
        return low, out, time.perf_counter() - t

    def body():
        lines = {}
        for scheme in payload.SCHEMES:
            engines = ("cuda", "resident") + (
                ("baseline",) if scheme in (None, "tmr") else ())
            runs = {eng: run(eng, scheme, corner) for eng in engines}
            low, first, _ = runs["cuda"]
            if set(first) != set(oracle) or any(
                    t.shape != (n_words,) for t in first.values()):
                raise AssertionError(f"faults {scheme}: outputs "
                                     f"{sorted(first)} of the wrong shape")
            for eng, (other, out, _) in runs.items():
                if set(out) != set(first) or not all(
                        torch.equal(out[k], first[k]) for k in first):
                    raise AssertionError(f"faults {scheme}: engine {eng} "
                                         "differs from cuda")
                if other.last_ecc != low.last_ecc:
                    raise AssertionError(f"faults {scheme}: {eng} ECC "
                                         f"{other.last_ecc} != "
                                         f"{low.last_ecc}")
            line = {"scheme": scheme or "none", "aaps_per_tile": low.aaps,
                    "corrupted_bits": payload.corrupted_bits(first, oracle),
                    "ecc_mismatch_bits": (low.last_ecc.mismatch_bits
                                          if low.last_ecc else None),
                    "engines_identical": True,
                    "engine_s": {eng: r[2] for eng, r in runs.items()}}
            print("faults " + json.dumps(line))
            lines[scheme] = line
            del runs, first, low
        _, clean, secs = run("cuda", "tmr", None)
        if payload.corrupted_bits(clean, oracle) != 0:
            raise AssertionError("the fault-free tmr run differs from the "
                                 "oracle")
        print("faults " + json.dumps({"scheme": "tmr", "faults": None,
                                      "corrupted_bits": 0,
                                      "engine_s": {"cuda": secs},
                                      "oracle_cpu_s": oracle_s}))
        return lines

    lines, counts = counted(
        wrappers, "faults", body,
        lambda _: {"pack_signs": 0, "xnor_gemm": 0, "aap_interp": 1,
                   "aap_interp_faulted": len(payload.SCHEMES),
                   "flash_attn_fwd": 0})
    bare = lines[None]["corrupted_bits"]
    if bare <= 0:
        raise AssertionError("the bare run at the Table-3 corner corrupted "
                             "nothing")
    if lines["ecc"]["ecc_mismatch_bits"] <= 0:
        raise AssertionError("ECC flagged no mismatch at the corner")
    if lines["tmr"]["corrupted_bits"] >= bare:
        raise AssertionError(f"TMR left {lines['tmr']['corrupted_bits']} "
                             f"bits wrong, bare {bare}")
    for scheme, want in payload.EXPECTED.items():
        got = (lines[scheme]["corrupted_bits"],
               lines[scheme]["ecc_mismatch_bits"])
        if got != want:
            raise AssertionError(f"faults {scheme}: (corrupted, ECC "
                                 f"mismatch) bits {got}, expected {want} "
                                 "(launch.faults.EXPECTED)")
    return counts


def readme_kernel():
    """The README's "Write a kernel in 10 lines" kernel, through
    `drim_torch`."""
    import drim_torch as drim

    @drim.jit
    def kernel(a, b, c):
        x = drim.xnor(a, b)                 # 1 AAP fused (3 unfused)
        s, carry = drim.full_add(x, c, b)   # Table-2 adder slice, 7 AAPs
        return {"sum": s, "carry": carry}
    return kernel


def warns_here(what: str, call):
    """`call()` must raise the shims' DeprecationWarning naming this file
    (the caller), not the shim's module; returns its result."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = call()
    deps = [w for w in caught if issubclass(w.category, DeprecationWarning)
            and "staged pipeline" in str(w.message)]
    here = pathlib.Path(__file__).resolve()
    if not deps or any(pathlib.Path(w.filename).resolve() != here
                       for w in deps):
        named = [(w.filename, w.lineno) for w in deps]
        raise AssertionError(f"{what}: warnings at {named}, not one "
                             f"naming {here.name}")
    return out


def timed_run(low, *args):
    """(outputs, host wall s) of one `low.run` on the card, synchronized."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = low.run(*args, device=torch.device("cuda"))
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def phase_drim(wrappers):
    """The `drim` import surface as `drim_torch`, four counted legs:

      engines    -- the README's `@drim.jit` kernel (xnor -> full_add)
                    over one DRIM-R wave through `kernel(...)` on
                    "resident" and `drim.compile(kernel).lower(...)` on
                    "baseline", "queued" (4 queues), "cuda", "gpu", and
                    `partition=True` on "queued" and "cuda" (and
                    `drim.lower`): every output's words equal
                    `graph_ref_results`;
      mesh       -- xnor2 and the carry-save K=32 dot on "resident" under
                    `fleet_mesh(DRIM_R)` (1x1 on one card) over one DRIM-R
                    wave and under a 1x8 mesh over [cuda:0] * 8 over one
                    DRIM-S wave (256 banks x 152 sub-arrays, blocks of 32
                    banks), and the K=32 dot partitioned over 4 queues
                    under a 1x2 mesh: the words equal the unsharded run's
                    exactly; the host wall time of each ("drim" lines);
      shims      -- each deprecated `execute*`/`plan*` shim once at one
                    DRIM-R wave ("cuda" where it takes an engine): its
                    DeprecationWarning names this file, and its words (or
                    report fields) equal the pipeline's;
      quickstart -- `examples/quickstart_torch.py` in this process: it
                    holds the packer against its plain version, the
                    GEMM against sign(x) @ sign(w) and the adder
                    against its plain version and a + b, on the card.

    Returns the legs' launch counts."""
    import drim_torch as drim
    from repro_torch.core import DRIM_R, DRIM_S
    from repro_torch.launch import faults as payload
    from repro_torch.pim import (execute, execute_graph, execute_oplist,
                                 execute_partitioned, graph_ref_results,
                                 plan, plan_fused, plan_queued)
    from repro_torch.pim.bnn import bnn_dot_graph_carrysave
    from repro_torch.pim.graph import partition_graph
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    counts = {}
    kernel = readme_kernel()
    graph = kernel.trace().graph
    wave = DRIM_R.n_subarrays * DRIM_R.row_bits // 32
    rng = np.random.default_rng([SEED, 30])
    abc = [rng.integers(0, 1 << 32, wave, dtype=np.uint32)
           for _ in graph.input_names]
    feeds = dict(zip(graph.input_names, abc))
    oracle = graph_ref_results(graph, feeds)

    def check_words(what, got, want):
        for name, w in want.items():
            check_equal(f"{what} {name}", got[name].cpu(),
                        torch.from_numpy(np.asarray(w).view(np.int32))
                        if isinstance(w, np.ndarray) else w.cpu())

    # -- engines: compile -> lower -> run on every engine ------------------
    legs = (("baseline", {}), ("queued", {"n_queues": 4}), ("cuda", {}),
            ("gpu", {}), ("queued", {"partition": True}),
            ("cuda", {"partition": True}))
    segments = len(partition_graph(
        graph, drim.compile(graph).lower(partition=True).n_queues).segments)

    def engines():
        check_words("drim README resident", kernel(*abc, device=dev), oracle)
        for engine, kw in legs:
            low = drim.compile(kernel).lower(engine, **kw)
            check_words(f"drim README {engine} {kw}",
                        low.run(*abc, device=dev), oracle)
        low = drim.lower(kernel, engine="cuda")
        if low.program != drim.compile(kernel).lower("cuda").program:
            raise AssertionError("drim.lower differs from compile().lower()")
        check_words("drim README drim.lower cuda", low.run(*abc, device=dev),
                    oracle)
    _, counts["drim engines"] = counted(
        wrappers, "drim engines", engines,
        lambda _: {"aap_interp": 2 + segments, "bitwise_binary": 1,
                   "bitwise_ternary": 1})

    # -- mesh: sharded runs equal the unsharded ones -----------------------
    g32, _ = bnn_dot_graph_carrysave(32)

    def mesh_legs():
        cases = (("fleet_mesh(DRIM_R)", DRIM_R, drim.fleet_mesh(DRIM_R),
                  {"chips": 1, "banks": 1}),
                 ("1x8 over cuda:0", DRIM_S,
                  drim.fleet_mesh(DRIM_S, devices=[dev] * 8),
                  {"chips": 1, "banks": 8}))
        for label, geom, mesh, shape in cases:
            if mesh.shape != shape:
                raise AssertionError(f"{label}: mesh {mesh.shape}")
            words = geom.n_subarrays * geom.row_bits // 32
            ab = [card_words(rng, words) for _ in range(2)]
            card32 = {n: torch.from_numpy(a.view(np.int32)).to(dev)
                      for n, a in payload.fault_feeds(g32, words).items()}
            for name, src, args in (("xnor2", "xnor2", ab),
                                    ("carry-save K=32", g32, [card32])):
                lows = [drim.compile(src, geom=geom).lower("resident",
                                                           mesh=m)
                        for m in (None, mesh)]
                walls = [[], []]
                outs = [None, None]
                for _ in range(2):         # the first pair warms up
                    for i, low in enumerate(lows):
                        outs[i], wall = timed_run(low, *args)
                        walls[i].append(wall)
                if name == "xnor2":
                    check_equal(f"drim mesh {label} xnor2", outs[1][0],
                                outs[0][0])
                else:
                    check_words(f"drim mesh {label} K=32", outs[1], outs[0])
                print("drim " + json.dumps({
                    "leg": "mesh", "mesh": label, "mesh_shape": mesh.shape,
                    "program": name, "geom": [geom.chips, geom.banks,
                                              geom.subarrays_per_bank],
                    "words_per_plane": words, "engine": "resident",
                    "unsharded_wall_s": walls[0], "sharded_wall_s": walls[1],
                    "identical": True}))
        mesh2 = drim.fleet_mesh(DRIM_R, devices=[dev] * 2)
        card32 = {n: torch.from_numpy(a.view(np.int32)).to(dev)
                  for n, a in payload.fault_feeds(g32, wave).items()}
        lows = [drim.compile(g32, geom=DRIM_R).lower(partition=True,
                                                     n_queues=4, mesh=m)
                for m in (None, mesh2)]
        (want, wall_u), (got, wall_m) = (timed_run(low, card32)
                                         for low in lows)
        check_words("drim mesh 1x2 partitioned K=32", got, want)
        check_words("drim mesh 1x2 partitioned K=32 vs oracle", got,
                    graph_ref_results(g32, payload.fault_feeds(g32, wave)))
        print("drim " + json.dumps({
            "leg": "mesh", "mesh": "1x2 over cuda:0", "mesh_shape":
            mesh2.shape, "program": "partitioned carry-save K=32",
            "n_queues": 4, "words_per_plane": wave, "engine": "queued",
            "unsharded_wall_s": wall_u, "sharded_wall_s": wall_m,
            "identical": True}))
    _, counts["drim mesh"] = counted(wrappers, "drim mesh", mesh_legs,
                                     lambda _: {})

    # -- shims: the deprecated entry points name their caller --------------
    def shims():
        a, b = abc[0], abc[1]
        res, _ = warns_here("execute", lambda: execute(
            "xnor2", a, b, engine="cuda", device=dev))
        check_equal("drim shim execute", res[0], drim.compile(
            "xnor2").lower("cuda").run(a, b, device=dev)[0])
        [(res, _)] = warns_here("execute_oplist", lambda: execute_oplist(
            [("xnor2", (a, b))], engine="cuda", device=dev))
        check_equal("drim shim execute_oplist", res[0], drim.compile(
            "xnor2").lower("cuda").run(a, b, device=dev)[0])
        res, _ = warns_here("execute_graph", lambda: execute_graph(
            graph, feeds, engine="cuda", device=dev))
        check_words("drim shim execute_graph", res, drim.compile(
            graph).lower("cuda").run(feeds, device=dev))
        res, _ = warns_here("execute_partitioned", lambda: (
            execute_partitioned(graph, feeds, n_queues=4, device=dev)))
        check_words("drim shim execute_partitioned", res, drim.compile(
            graph).lower(partition=True, n_queues=4).run(feeds, device=dev))
        n_bits = wave * 32
        rep = warns_here("plan", lambda: plan(
            "xnor2", n_bits, simulate=True, device=dev))
        v = drim.compile("xnor2").lower().verdict(n_bits, simulate=True,
                                                  device=dev)
        fused = warns_here("plan_fused", lambda: plan_fused(
            graph, n_bits, simulate=True, device=dev))
        vg = drim.compile(graph).lower().verdict(n_bits, simulate=True,
                                                 device=dev)
        queued = warns_here("plan_queued", lambda: plan_queued(
            graph, n_bits, n_queues=4, simulate=True, device=dev))
        vq = drim.compile(graph).lower(partition=True, n_queues=4).verdict(
            n_bits, simulate=True, device=dev)
        pairs = {
            "plan drim_latency_s": (rep.drim_latency_s,
                                    v.row("DRIM-resident").latency_s),
            "plan gpu_latency_s": (rep.gpu_latency_s,
                                   v.row("GPU").latency_s),
            "plan_fused fused_latency_s": (fused.fused_latency_s,
                                           vg.row("DRIM-fused").compute_s),
            "plan_fused unfused_latency_s": (
                fused.unfused_latency_s, vg.row("DRIM-unfused").compute_s),
            "plan_queued queued_latency_s": (
                queued.queued_latency_s, vq.row("DRIM-queued").latency_s),
            "plan_queued critical_path_aaps": (
                queued.critical_path_aaps, vq.row("DRIM-queued").aaps)}
        for what, (got, want) in pairs.items():
            if got != want:
                raise AssertionError(f"drim shim {what}: {got} != {want}")
        if not (rep.simulated and fused.simulated and queued.simulated):
            raise AssertionError("drim shims: a plan* report did not run")
        print("drim " + json.dumps({
            "leg": "shims", "warned_at": pathlib.Path(__file__).name,
            "plan": rep.as_dict(), "winner_fused": fused.winner,
            "winner_queued": queued.winner}))
    _, counts["drim shims"] = counted(wrappers, "drim shims", shims,
                                      lambda _: {"aap_interp": 6})

    # -- quickstart: the example twin in this process ----------------------
    def quickstart():
        import runpy
        main_fn = runpy.run_path(
            str(ROOT / "examples" / "quickstart_torch.py"))["main"]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            main_fn([])
        text = out.getvalue()
        if "Quickstart complete" not in text:
            raise AssertionError(f"quickstart_torch.py: {text[-400:]}")
        lines = text.splitlines()
        # The example asserts each of these on the card, against the
        # plain packer, sign(x) @ sign(w) and the integer sum a + b.
        checked = [next((line for line in lines if line.startswith(start)
                         and end in line), None)
                   for start, end in (("sign-packed", "== the plain packer"),
                                      ("XNOR-popcount GEMM", "== sign(x)"),
                                      ("bit-plane ripple adder", "== a + b"),
                                      ("traced kernel", ""))]
        if None in checked:
            raise AssertionError(f"quickstart_torch.py: {text[-400:]}")
        print("drim " + json.dumps({"leg": "quickstart", "lines": checked}))
    _, counts["drim quickstart"] = counted(
        wrappers, "drim quickstart", quickstart,
        lambda _: {"pack_signs": 2, "xnor_gemm": 1, "bitplane_add": 1})

    print("drim " + json.dumps({"phase_wall_s": time.perf_counter() - t_phase,
                                "launches": counts}))
    return counts


@contextlib.contextmanager
def finite_logits():
    """Record, without a host sync, whether every logits tensor the
    serving loop's prefill and decode steps return is finite; yields the
    list of recorded flags (0-d bool tensors)."""
    from repro_torch.launch import batching, serve
    flags = []
    patched = ((serve, "prefill"), (batching, "prefill"),
               (batching, "decode_step"))
    inner = [getattr(mod, name) for mod, name in patched]

    def recording(fn):
        def call(*args, **kw):
            lg, caches = fn(*args, **kw)
            flags.append(torch.isfinite(lg).all())
            return lg, caches
        return call
    for (mod, name), fn in zip(patched, inner):
        setattr(mod, name, recording(fn))
    try:
        yield flags
    finally:
        for (mod, name), fn in zip(patched, inner):
            setattr(mod, name, fn)


def check_served(leg: str, gen, cfg, flags, n_gen: int, n_calls: int):
    """Token ids [..., n_gen] inside the vocabulary; `n_calls` logits
    tensors recorded, every one finite."""
    if gen.shape[-1] != n_gen or gen.min() < 0 \
            or gen.max() >= cfg.vocab_size:
        raise AssertionError(f"{leg}: bad token ids {gen.tolist()}")
    if len(flags) != n_calls or not all(bool(f) for f in flags):
        raise AssertionError(f"{leg}: {len(flags)} logits tensors (expected "
                             f"{n_calls}), finite {[bool(f) for f in flags]}")


def family_argv(arch: str, layers: int, prompt: int):
    """The families phase's serve flags of a leg (FAMILIES)."""
    argv = ["--arch", arch, "--batch", str(FAMILY_BATCH), "--prompt-len",
            str(prompt), "--gen", str(FAMILY_GEN), "--seed", str(SEED),
            "--temperature", "0"]
    return argv + (["--layers", str(layers)] if layers else [])


def attention_sites(cfg) -> int:
    """GQA attention sites of a prefill or a training forward, each one
    flash launch where the sequence is block-aligned: a layer each in the
    dense and vlm archs, the GQA moe archs and whisper's decoder (its
    encoder over 1500 frames and its cross-attention take dense scores),
    none behind MLA or in mamba2, a group site each in the hybrid."""
    if cfg.family in ("dense", "vlm", "audio") or (cfg.family == "moe"
                                                   and not cfg.mla):
        return cfg.n_layers
    return cfg.n_layers // cfg.attn_every if cfg.attn_every else 0


def phase_families(wrappers):
    """The SSM, hybrid, dense, MoE, audio and vlm families served through
    `run_serve` on the "gpu" route at full width: mamba2-130m, zamba2-1.2b
    and whisper-medium at their published depth, qwen3-14b and
    llava-next-34b cut to 2 layers, deepseek-v3 and kimi-k2 to 1; then
    two mamba2 requests
    through the continuous batcher, and the batcher refusing zamba2.  Each
    leg's launches are counted on their own (flash once per attention
    site of the aligned prefill); returns the phase's counts summed."""
    from repro_torch.configs import get_config
    from repro_torch.launch import batching, serve
    from repro_torch.models import init_params
    t_phase = time.perf_counter()
    counts = {}
    mamba_params = None
    for arch, layers, prompt, n_flash in FAMILIES:
        args = serve.parse_args(family_argv(arch, layers, prompt))
        cfg = serve.build_cfg(args)
        sites = attention_sites(cfg)
        if sites != n_flash:
            raise AssertionError(f"{arch}: {sites} attention sites, "
                                 f"FAMILIES expects {n_flash}")
        t0 = time.perf_counter()
        params = init_params(SEED, cfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        leg = f"families {arch}"
        with finite_logits() as flags, ep_calls() as eps, \
                logits_tap() as tap:
            (gen, stats), counts[leg] = counted(
                wrappers, leg,
                lambda args=args, params=params: serve.run_serve(
                    args, params=params),
                lambda _, n=n_flash: {"flash_attn_fwd": n} if n else {})
        if arch == "qwen3-14b" or arch in TP_MOE_ARCHS \
                or any(arch == a for a, *_ in TP_FAMILY_SERVE):
            ONE_PROCESS[arch] = {"gen": gen, **tap_values(tap)}
        if (arch, layers, True) in ((a, n, f32) for a, n, _, _, f32
                                    in TP_FAMILY_SERVE):
            # the tp phase's float32 leg's one-process run, on these
            # weights (bfloat16 params either way), not counted
            with float32_numerics(), logits_tap() as tap32:
                gen32, _ = serve.run_serve(args, params=params)
            ONE_PROCESS[one_process_key(arch, layers, True)] = {
                "gen": gen32, **tap_values(tap32)}
        if arch == TP_AUDIO:
            # the tp phase's prefill over seeded frames in one process, on
            # these weights, not counted
            toks = torch.as_tensor(serve._prompts(args, cfg, args.batch),
                                   device=params["embed"].device).long()
            with torch.no_grad():
                lg = serve.prefill(params, cfg, {
                    "tokens": toks, "frames": audio_frames(toks, cfg)})[0]
            ONE_PROCESS[f"{arch} seeded frames"] = {
                "prefill": lg[:, -1].float().cpu()}
            del toks, lg
        # under the default --mesh host every MoE prefill layer takes EP
        # with one model shard; decode (S == 1) never does
        want_eps = ([{"data": 1, "model": 1}] * cfg.n_layers
                    if cfg.family == "moe" else [])
        if eps != want_eps:
            raise AssertionError(f"{leg}: expert-parallel calls {eps}, "
                                 f"expected {want_eps}")
        # the prefill, the warm-up decode step and FAMILY_GEN - 1 more
        check_served(leg, gen, cfg, flags, FAMILY_GEN, FAMILY_GEN + 1)
        print("families " + json.dumps({
            "leg": arch, "family": cfg.family, "n_layers": cfg.n_layers,
            "published_layers": get_config(arch).n_layers,
            "encoder_layers": cfg.encoder_layers,
            "d_model": cfg.d_model, "n_patches": cfg.n_patches,
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "experts": cfg.n_experts, "top_k": cfg.top_k, "mla": cfg.mla,
            "batch": FAMILY_BATCH, "prompt": prompt, "gen": FAMILY_GEN,
            "init_s": init_s, "prefill_s": stats["prefill_s"],
            "compile_s": stats["compile_s"],
            "decode_tok_per_s": stats["decode_tok_per_s"],
            "decode_p50_ms": stats["decode_p50_ms"],
            "decode_p99_ms": stats["decode_p99_ms"],
            "flash_launches": counts[leg]["flash_attn_fwd"],
            "logits_finite": True, "ids_in_vocab": True,
            "sample_ids": stats["sample_ids"]}))
        profile_decode(arch, cfg, params, prompt, stats["decode_p50_ms"])
        if cfg.family == "moe" and cfg.mla:
            check_decode_repeats(arch, cfg, params, prompt)
        if cfg.family == "moe":
            mleg = f"families mesh {arch}"
            _, counts[mleg] = counted(
                wrappers, mleg,
                lambda args=args, cfg=cfg, params=params: check_moe_meshes(
                    args, cfg, params),
                lambda _, n=n_flash: {"flash_attn_fwd": 5 * n} if n else {})
        if arch == "mamba2-130m":
            mamba_params = params
        del params
        torch.cuda.empty_cache()

    # continuous batching: two mamba2 requests into two slots
    args = serve.parse_args(["--arch", "mamba2-130m", "--batch", "2",
                             "--continuous", "2", "--gen", str(FAMILY_GEN),
                             "--prompt-len", str(max(FAMILY_CONTINUOUS)),
                             "--seed", str(SEED)])
    cfg = serve.build_cfg(args)
    prompts = [np.random.default_rng([SEED, 5]).integers(0, cfg.vocab_size,
                                                         n)
               for n in FAMILY_CONTINUOUS]
    leg = "families continuous mamba2-130m"
    with finite_logits() as flags:
        (res, stats), counts[leg] = counted(
            wrappers, leg, lambda: serve.run_continuous(
                args, params=mamba_params, prompts=prompts),
            lambda _: {})
    # one prefill per request, one decode step a wave (every wave has an
    # active request: the second arrives a wave after the first)
    check_served(leg, np.stack([res[r] for r in sorted(res)]), cfg, flags,
                 FAMILY_GEN, len(prompts) + stats["n_waves"])
    print("families " + json.dumps({
        "leg": "continuous mamba2-130m", "prompts": list(FAMILY_CONTINUOUS),
        "n_waves": stats["n_waves"], "wall_s": stats["wall_s"],
        "tok_per_s": stats["tok_per_s"],
        "flash_launches": counts[leg]["flash_attn_fwd"],
        "logits_finite": True, "ids_in_vocab": True,
        "request_tokens": stats["request_tokens"]}))
    del mamba_params
    try:
        batching.WaveBatcher(serve.build_cfg(serve.parse_args(
            ["--arch", "zamba2-1.2b"])), None, n_slots=2, ctx_len=8)
    except NotImplementedError as err:
        print("families " + json.dumps({"leg": "continuous zamba2-1.2b",
                                        "refused": str(err)}))
    else:
        raise AssertionError("the wave batcher served the hybrid family")
    check_families_reference()
    check_ssm_prefill_decode()
    print("families " + json.dumps({
        "phase_wall_s": time.perf_counter() - t_phase}))
    return {name: sum(c[name] for c in counts.values()) for name in wrappers}


@contextlib.contextmanager
def ep_calls():
    """Record the mesh shape of every expert-parallel MoE block run in the
    scope (a spy on `moe._ep_shard_map`); yields the list."""
    from repro_torch.models import moe
    calls = []
    inner = moe._ep_shard_map

    def spy(*args):
        calls.append(dict(args[-1].shape))
        return inner(*args)
    moe._ep_shard_map = spy
    try:
        yield calls
    finally:
        moe._ep_shard_map = inner


def ep_logits_check(got, want, tol: float) -> dict:
    """EP x8's logits `got` against grouped's `want`: each within
    EP_LOGIT_RTOL of its own |value| plus the logits' RMS, under
    EP_MOVED_MAX of them moved, and the same greedy tokens save at an
    exact tie of `want`'s last-position logits.  The worst error over
    the bound with `tol` of the largest |logit| as the floor
    (FAMILY_REF_TOL) is printed, not held."""
    g, e = want.float(), got.float()
    err, mag = (e - g).abs(), g.abs()
    rms = float(g.pow(2).mean().sqrt())
    excess = float((err / (EP_LOGIT_RTOL * (mag + rms))).max())
    ref_floor = tol * max(1.0, float(mag.max()))
    moved = float((got != want).float().mean())
    g_tok, e_tok = want[:, -1].argmax(-1), got[:, -1].argmax(-1)
    rows = torch.nonzero(g_tok != e_tok).flatten().tolist()
    ties = all(bool(want[r, -1, e_tok[r]] == want[r, -1].max())
               for r in rows)
    return {"max_abs_err": float(err.max()), "logits_rms": rms,
            "worst_err_over_bound": excess, "logits_moved": moved,
            "worst_err_over_family_ref_tol": float(
                (err / (EP_LOGIT_RTOL * mag + ref_floor)).max()),
            "greedy_rows_differing": rows, "at_exact_ties": ties,
            "ok": bool(torch.isfinite(e).all()) and excess <= 1.0
            and moved < EP_MOVED_MAX and ties}


@contextlib.contextmanager
def planted_partial(fault: str):
    """A planted expert-parallel fault: every combine of model shard 0's
    partial (`moe._combine`, called once a shard in model order) comes
    back zero ("drop") or doubled ("twice")."""
    from repro_torch.models import moe
    inner, calls = moe._combine, [0]

    def combine(*args):
        out = inner(*args)
        calls[0] += 1
        if (calls[0] - 1) % EP_SHARDS == 0:
            out = out * (0 if fault == "drop" else 2)
        return out
    moe._combine = combine
    try:
        yield
    finally:
        moe._combine = inner


def check_moe_meshes(args, cfg, params):
    """A MoE leg's prefill (its weights and prompt) three ways: under the
    host mesh (EP with one model shard), with no mesh (the grouped
    dispatch) and under a 1x8 mesh of the card (EP over EP_SHARDS model
    shards).  EP x1 must equal grouped bit for bit in logits and caches;
    EP x8's logits must pass `ep_logits_check` against grouped's, and
    two more EP x8 prefills, with shard 0's partial planted dropped and
    doubled (`planted_partial`), must fail it.  (The one layer writes its
    caches before its MoE, so EP x8's caches say nothing here.)  Each of
    the three prefills timed on the host clock, synchronised."""
    from repro_torch.core.mesh import make_named_mesh
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import serve
    from repro_torch.models import prefill
    from repro_torch.tree import tree_leaves
    dev = torch.device("cuda", 0)
    toks = torch.as_tensor(serve._prompts(args, cfg, FAMILY_BATCH),
                           device=dev).long()
    batch = serve.model_batch(cfg, toks)
    ep8 = f"ep{EP_SHARDS}"

    def mesh8():
        return make_named_mesh((1, EP_SHARDS), ("data", "model"),
                               [dev] * EP_SHARDS)
    ways = {"ep1": lmesh.cli_mesh("host", torch.device("cuda")),
            "grouped": contextlib.nullcontext(), ep8: mesh8()}
    out, times, shapes = {}, {}, {}
    for way, ctx in ways.items():
        with ctx, ep_calls() as eps:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[way] = prefill(params, cfg, batch)
            torch.cuda.synchronize()
            times[way] = time.perf_counter() - t0
        shapes[way] = eps
    want = {"ep1": [{"data": 1, "model": 1}] * cfg.n_layers, "grouped": [],
            ep8: [{"data": 1, "model": EP_SHARDS}] * cfg.n_layers}
    if shapes != want:
        raise AssertionError(f"{cfg.arch}: expert-parallel calls {shapes}, "
                             f"expected {want}")
    g_logits, g_caches = out["grouped"]
    e_logits, e_caches = out["ep1"]
    bitwise = torch.equal(e_logits, g_logits) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(e_caches),
                                          tree_leaves(g_caches)))
    tol = FAMILY_REF_TOL[cfg.arch]
    check = ep_logits_check(out[ep8][0], g_logits, tol)
    planted = {}
    for fault in ("drop", "twice"):
        with mesh8(), planted_partial(fault):
            planted[fault] = ep_logits_check(prefill(params, cfg, batch)[0],
                                             g_logits, tol)
    print("families " + json.dumps({
        "mesh": cfg.arch, "experts": cfg.n_experts,
        "experts_per_shard": cfg.n_experts // EP_SHARDS,
        "batch": FAMILY_BATCH, "prompt": toks.shape[1],
        "prefill_s": times, "ep1_bitwise_equal_grouped": bitwise,
        "family_ref_tol": tol, "logit_rtol": EP_LOGIT_RTOL,
        "moved_max": EP_MOVED_MAX, ep8: check,
        "planted_shard0_partial": planted,
        "ep_calls": {k: len(v) for k, v in shapes.items()}}))
    if not bitwise:
        raise AssertionError(f"{cfg.arch}: EP x1 prefill differs from the "
                             "grouped dispatch")
    if not check["ok"]:
        raise AssertionError(f"{cfg.arch}: EP x{EP_SHARDS} prefill off the "
                             f"grouped one: {check}")
    caught = [f for f, c in planted.items() if not c["ok"]]
    if caught != list(planted):
        raise AssertionError(f"{cfg.arch}: the EP x{EP_SHARDS} check missed "
                             f"a planted fault: {planted}")
    return times


def profile_decode(arch: str, cfg, params, prompt: int, step_ms: float):
    """Where a family's decode step goes: the leg's prompt prefilled, then
    PROFILE_STEPS decode steps at its first position under
    `torch.profiler` (after one unprofiled step); device ms and kernel
    launches per step, and the device's idle share of the leg's
    unprofiled p50 step (`step_ms`)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import batching, serve
    from repro_torch.models import empty_caches, prefill
    dev = torch.device("cuda")
    toks = torch.from_numpy(np.random.default_rng([SEED, 8]).integers(
        0, cfg.vocab_size, (FAMILY_BATCH, prompt))).to(dev)
    ctx_len = prompt + FAMILY_GEN
    logits, pre = prefill(params, cfg, serve.model_batch(cfg, toks))
    caches = serve.splice_caches(empty_caches(cfg, FAMILY_BATCH, ctx_len,
                                              device=dev), pre)
    dec = batching.make_decode_fn(cfg, ctx_len)
    tok = logits[:, -1].argmax(-1)[:, None]
    pos = torch.full((FAMILY_BATCH,), prompt, dtype=torch.long, device=dev)
    dec(params, tok, caches, pos, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            dec(params, tok, caches, pos, 0)
        torch.cuda.synchronize()
    kernels = device_kernels(prof, PROFILE_STEPS)
    busy = sum(ms for _, ms, _ in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:5]
    print("families " + json.dumps({
        "profile": arch, "profile_steps": PROFILE_STEPS,
        "device_busy_ms_per_step": busy,
        "device_launches_per_step": sum(c for _, _, c in kernels),
        "p50_step_ms": step_ms,
        "device_idle_share": 1 - busy / step_ms if busy else None,
        "top_kernels_ms_per_step": [[name[:80], ms, cnt]
                                    for name, ms, cnt in top]}))


def check_decode_repeats(arch: str, cfg, params, prompt: int):
    """The same decode step of the leg's full-width model (its prompt
    prefilled) run twice on the card: bitwise-equal logits and caches.
    The MoE combine adds each token's k expert outputs in a fixed order
    (no atomics), so nothing in the step may vary between runs."""
    from repro_torch.launch import serve
    from repro_torch.models import decode_step, empty_caches, prefill
    from repro_torch.tree import tree_leaves
    dev = torch.device("cuda")
    toks = torch.from_numpy(np.random.default_rng([SEED, 9]).integers(
        0, cfg.vocab_size, (FAMILY_BATCH, prompt))).to(dev)
    ctx_len = prompt + FAMILY_GEN
    logits, pre = prefill(params, cfg, serve.model_batch(cfg, toks))
    caches = serve.splice_caches(empty_caches(cfg, FAMILY_BATCH, ctx_len,
                                              device=dev), pre)
    tok = logits[:, -1].argmax(-1)[:, None]
    pos = torch.full((FAMILY_BATCH,), prompt, dtype=torch.long, device=dev)
    runs = [decode_step(params, cfg, tok, caches, pos, ctx_len)
            for _ in range(2)]
    same = torch.equal(runs[0][0], runs[1][0]) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(runs[0][1]),
                                          tree_leaves(runs[1][1])))
    print("families " + json.dumps({
        "check": f"{arch} decode step run twice, bitwise equal",
        "equal": same,
        "max_abs_diff": float((runs[0][0] - runs[1][0]).abs().max())}))
    if not same:
        raise AssertionError(f"{arch}: a repeated decode step differs")


def check_families_reference():
    """The float32 smoke configs prefilled on the card (flash at every GQA
    site at 512 tokens) and on the CPU from the same seeded weights,
    tokens, (whisper) frames and (llava) patch embeddings, the last
    position's logits within
    FAMILY_REF_TOL; for the MoE archs, how many top-k expert choices the
    two runs made differently (a near-tie of router probabilities may
    flip one under cuBLAS's order of sums)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention
    from repro_torch.models import init_params, moe, prefill
    route = moe._route
    for arch, tol in FAMILY_REF_TOL.items():
        cfg = get_smoke_config(arch).replace(dtype="float32",
                                             param_dtype="float32")
        rng = np.random.default_rng([SEED, 6])
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (2, 512)))}
        if cfg.family == "audio":
            batch["frames"] = torch.from_numpy(rng.standard_normal(
                (2, cfg.n_frames, cfg.d_model), dtype=np.float32))
        if cfg.family == "vlm":
            batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
                (2, cfg.n_patches, cfg.d_model), dtype=np.float32))
        before = flash_attention.flash_fwd.launches
        logits, choices = {}, {}
        for dev in ("cuda", "cpu"):
            picks = choices.setdefault(dev, [])

            def recording(p, c, x, picks=picks):
                out = route(p, c, x)
                picks.append(out[1].cpu())
                return out
            moe._route = recording
            try:
                params = init_params(SEED, cfg, device=dev)
                lg, _ = prefill(params, cfg, {k: v.to(dev)
                                              for k, v in batch.items()})
            finally:
                moe._route = route
            logits[dev] = lg.cpu()
        ran = flash_attention.flash_fwd.launches - before
        if ran != attention_sites(cfg):
            raise AssertionError(f"{arch}: the card's prefill launched flash "
                                 f"{ran} times, not {attention_sites(cfg)}")
        err = float((logits["cuda"] - logits["cpu"]).abs().max())
        bound = tol * max(1.0, float(logits["cpu"].abs().max()))
        line = {"check": f"{arch} float32 smoke prefill, card vs CPU",
                "max_abs_err": err, "tolerance": bound}
        if cfg.family == "moe":
            line["expert_choices"] = sum(t.numel() for t in choices["cpu"])
            line["expert_choices_differing"] = sum(
                int((a != b).sum()) for a, b in zip(choices["cuda"],
                                                    choices["cpu"]))
        print("families " + json.dumps(line))
        if not (torch.isfinite(logits["cuda"]).all() and err <= bound):
            raise AssertionError(f"{arch}: card prefill differs from the "
                                 f"CPU's by {err}")


def check_ssm_prefill_decode():
    """One full-width mamba2-130m mixer on the card: its prefill over 512
    tokens (2 SSD chunks) against stepping `ssm_decode` token by token,
    at the reference's tolerances (SSM_EQUIV_TOL)."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    from repro_torch.tree import tree_map
    dev = torch.device("cuda")
    cfg = get_config("mamba2-130m")
    p = tree_map(lambda t: t.to(dev), ssm.ssm_init(
        torch.Generator().manual_seed(SEED), cfg))
    x = torch.from_numpy(np.random.default_rng([SEED, 7]).standard_normal(
        (2, 512, cfg.d_model), dtype=np.float32) * 0.1).to(dev)
    y_full, cache_full = ssm.ssm_mix(p, cfg, x)
    cache = ssm.ssm_empty_cache(cfg, 2, device=dev)
    ys = []
    for t in range(x.shape[1]):
        y_t, cache = ssm.ssm_decode(p, cfg, x[:, t:t + 1], cache)
        ys.append(y_t)
    pairs = {"y": (y_full, torch.cat(ys, 1)),
             "state": (cache_full["state"], cache["state"]),
             "conv": (cache_full["conv"], cache["conv"])}
    errs = {name: check_close(f"mamba2 layer {name}, prefill vs decode",
                              got, want, SSM_EQUIV_TOL[name])
            for name, (got, want) in pairs.items()}
    print("families " + json.dumps({
        "check": "mamba2-130m layer, prefill vs token-by-token decode",
        "tokens": x.shape[1], "max_abs_err": errs,
        "tolerance": SSM_EQUIV_TOL}))


def check_prefill_reference():
    """The float32 smoke config's prefill logits on the card (flash
    attention at S=128) against the same prefill on the CPU (dense
    scores), same seeded weights and tokens, within 1e-3."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention
    from repro_torch.models import init_params, prefill
    cfg = get_smoke_config("drim-bnn").replace(dtype="float32",
                                                param_dtype="float32")
    toks = torch.from_numpy(np.random.default_rng([SEED, 3]).integers(
        0, cfg.vocab_size, (2, 128)))
    before = flash_attention.flash_fwd.launches
    logits = {}
    for dev in ("cuda", "cpu"):
        params = init_params(SEED, cfg, device=dev)
        lg, _ = prefill(params, cfg, {"tokens": toks.to(dev)})
        logits[dev] = lg.cpu()
    if flash_attention.flash_fwd.launches != before + cfg.n_layers:
        raise AssertionError("the card's prefill did not run the flash "
                             "kernel in every layer")
    err = float((logits["cuda"] - logits["cpu"]).abs().max())
    if not (torch.isfinite(logits["cuda"]).all() and err <= 1e-3):
        raise AssertionError(f"card prefill differs from the CPU's by {err}")
    print("serve " + json.dumps({"prefill_vs_cpu_max_abs_err": err}))


def flat_leaves(tree):
    """(path, leaf) of a nested-dict tree, in sorted key order."""
    if not isinstance(tree, dict):
        return [("", tree)]
    return [(f"{k}/{p}".rstrip("/"), leaf) for k in sorted(tree)
            for p, leaf in flat_leaves(tree[k])]


def phase_collective(wrappers):
    """`compressed_allreduce` on a one-rank NCCL group over the card, on a
    gradient tree of the drim-bnn LM's parameter shapes (seeded gradients
    and residuals): every payload of a gradient's full size goes to
    `dist.all_reduce` as int8, and the mean and new residuals equal the
    single-rank decode (`decompress_tree(compress_tree(g, e))`) exactly.
    Then `--mesh single` refused by both CLIs.  Returns the counted leg's
    launches (none of the port's kernels)."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.models import abstract_params
    from repro_torch.optim import compress
    from repro_torch.tree import tree_leaves, tree_map
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shapes = abstract_params(get_config("drim-bnn"))
    grads = tree_map(lambda t: torch.randn(t.shape, generator=gen,
                                           device=dev), shapes)
    errors = tree_map(lambda t: 0.01 * torch.randn(t.shape, generator=gen,
                                                   device=dev), shapes)
    sizes = {t.numel() for t in tree_leaves(grads)}
    seen = []
    inner = dist.all_reduce

    def spy(t, *args, **kw):
        seen.append((t.dtype, t.numel()))
        return inner(t, *args, **kw)

    def run():
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1)
        dist.all_reduce = spy
        try:
            times = []
            for _ in range(3):
                seen.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mean, new_err = compress.compressed_allreduce(
                    grads, errors, ("data",))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            return mean, new_err, times
        finally:
            dist.all_reduce = inner
            dist.destroy_process_group()
    (mean, new_err, times), counts = counted(wrappers, "collective", run,
                                             lambda _: {})
    full = [(dt, n) for dt, n in seen if n in sizes]
    signs, scales, want_err = compress.compress_tree(grads, errors)
    want = compress.decompress_tree(signs, scales)
    exact = all(torch.equal(a, b) for a, b in zip(tree_leaves(mean),
                                                  tree_leaves(want)))
    exact_err = all(torch.equal(a, b) for a, b in zip(tree_leaves(new_err),
                                                      tree_leaves(want_err)))
    n_leaves = len(tree_leaves(grads))
    elements = sum(t.numel() for t in tree_leaves(grads))
    print("collective " + json.dumps({
        "backend": "nccl", "world_size": 1, "leaves": n_leaves,
        "elements": elements,
        "all_reduce_calls": len(seen),
        "full_size_payloads": len(full),
        "full_size_dtypes": sorted({str(dt) for dt, _ in full}),
        "payload_bytes": sum(n for dt, n in full),
        "first_call_s": times[0], "call_s": times[1:],
        "mean_equals_single_rank_decode": exact,
        "errors_equal_compress_tree": exact_err}))
    if len(full) != n_leaves or any(dt != torch.int8 for dt, _ in full):
        raise AssertionError(f"collective: full-size payloads {full}")
    if not (exact and exact_err):
        raise AssertionError("collective: the one-rank mean or residuals "
                             "differ from the single-rank decode")
    check_mesh_refusals()
    return counts


def check_mesh_refusals():
    """`--mesh single` on the serve and train CLIs: the production mesh's
    ValueError (one card, not 256), before any weight is drawn."""
    from repro_torch.launch import serve, train
    for name, main in (("serve", serve.main), ("train", train.main)):
        try:
            main(["--arch", "drim-bnn", "--mesh", "single"])
        except ValueError as err:
            if "needs 256 devices" not in str(err):
                raise
            print("collective " + json.dumps({"mesh_single": name,
                                              "refused": str(err)}))
        else:
            raise AssertionError(f"{name} --mesh single did not raise")


def phase_train(wrappers):
    """The drim-bnn LM trained at full width and depth through the
    trainer's CLI entry point (`launch.train.main`): batch 8, seq 256,
    AdamW at 3e-4, TRAIN_STEPS steps with checkpoints every RESTART_AT,
    under deterministic algorithms.  Then the restart check: the step-
    RESTART_AT checkpoint restored into a fresh state and trained to the
    end must give the very parameters and optimizer state the straight
    run saved.  Returns the launch counts of both legs."""
    from repro_torch.checkpoint.checkpoint import Checkpointer
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train
    dev = torch.device("cuda")
    counts = {}
    reset_peak()
    with deterministic(), \
            tempfile.TemporaryDirectory(prefix="drim_train_") as ckpt_dir:
        argv = TRAIN + ["--ckpt-dir", ckpt_dir]
        args = train.parse_args(argv)
        cfg, step_fn, init_state = train.build(args)
        per_step = {"flash_attn_fwd": (2 if cfg.remat else 1)
                    * cfg.n_layers, "flash_bwd_dkv": cfg.n_layers,
                    "flash_bwd_dq": cfg.n_layers}

        placed = []
        place = train.place

        def spy_place(tree, shardings, *shapes):
            placed.append(shardings)
            return place(tree, shardings, *shapes)

        def run():
            text = io.StringIO()
            train.place = spy_place
            try:
                with contextlib.redirect_stdout(text), \
                        trainer_spy(train) as seen:
                    final = train.main(argv)
            finally:
                train.place = place
            TRAINED["losses"] = seen["losses"]
            return final, [json.loads(line) for line in
                           text.getvalue().splitlines()]
        (final, lines), counts["train"] = counted(
            wrappers, "train", run,
            lambda _: {k: n * TRAIN_STEPS for k, n in per_step.items()})
        check_train_shardings(placed)
        steps = [line for line in lines if "step" in line]
        losses = [line["loss"] for line in steps]
        if len(steps) != TRAIN_STEPS or not np.all(np.isfinite(losses)) \
                or not np.isfinite(final):
            raise AssertionError(f"train: bad losses {losses} {final}")
        if not final < losses[0]:
            raise AssertionError(f"train: the loss did not fall "
                                 f"({losses[0]} -> {final})")
        # s/step after the first (warm-up) step; each logged step
        # ends with its metrics on the host
        s_step = (steps[-1]["wall_s"] - steps[0]["wall_s"]) \
            / (TRAIN_STEPS - 1)
        tokens = args.batch * args.seq
        print("train " + json.dumps({
            "arch": args.arch, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "bitlinear": cfg.bitlinear,
            "remat": cfg.remat, "batch": args.batch, "seq": args.seq,
            "steps": TRAIN_STEPS, "first_step_s": steps[0]["wall_s"],
            "s_per_step": s_step, "tokens_per_s": tokens / s_step,
            "first_loss": losses[0], "last_loss": final,
            "losses": losses,
            "grad_norm": [line["grad_norm"] for line in steps],
            "peak_mem_gb": peak_bytes() / 1e9}))

        def restart():
            ck = Checkpointer(ckpt_dir)
            fresh = init_state(SEED + 1, device=dev)
            state = ck.restore(RESTART_AT, fresh, device=dev)
            data = SyntheticLM(cfg.vocab_size, args.seq, args.batch,
                               seed=args.seed)
            for step in range(RESTART_AT, TRAIN_STEPS):
                state, _ = step_fn(state, train.batch_at(
                    data, cfg, step, args.seed, dev))
            torch.cuda.synchronize()
            return state, ck.restore(TRAIN_STEPS, fresh, device=dev)
        (resumed, straight), counts["train restart"] = counted(
            wrappers, "train restart", restart,
            lambda _: {k: n * (TRAIN_STEPS - RESTART_AT)
                       for k, n in per_step.items()})
        differ = [p for (p, a), (_, b) in zip(flat_leaves(resumed),
                                              flat_leaves(straight))
                  if not torch.equal(a, b)]
        if differ:
            raise AssertionError(f"restart: {len(differ)} leaves differ "
                                 f"from the straight run, e.g. "
                                 f"{differ[:3]}")
        print("train " + json.dumps({
            "restart": f"{RESTART_AT} + checkpoint + "
                       f"{TRAIN_STEPS - RESTART_AT} steps",
            "leaves": len(flat_leaves(straight)),
            "bit_identical_to_straight_run": True,
            "deterministic_algorithms": True}))
        data = SyntheticLM(cfg.vocab_size, args.seq, args.batch,
                           seed=args.seed)
        profile_train_steps(step_fn, resumed, [
            train.batch_at(data, cfg, TRAIN_STEPS + i, args.seed, dev)
            for i in range(PROFILE_STEPS)])
    return counts


def check_train_shardings(placed):
    """The trainer placed its state once, on a 1x1 mesh of the CLI's
    device (the card, `resolve_device()`), with ZeRO-1 specs: every AdamW
    moment's spec names "data"; prints the sharded and replicated leaves
    ("train" line)."""
    from repro_torch.device import resolve_device
    if len(placed) != 1:
        raise AssertionError(f"train: the state was placed {len(placed)} "
                             "times")
    leaves = flat_leaves(placed[0])
    mesh = leaves[0][1].mesh
    devices = {str(d) for d in mesh.devices.flat}
    if mesh.shape != {"data": 1, "model": 1} \
            or devices != {str(resolve_device())}:
        raise AssertionError(f"train: mesh {mesh}")
    sharded = [p for p, sh in leaves if any(e is not None for e in sh.spec)]
    moments = [(p, sh.spec) for p, sh in leaves
               if p.startswith(("opt/m/", "opt/v/"))]
    missing = [p for p, spec in moments if "data" not in tuple(spec)]
    print("train " + json.dumps({
        "mesh": mesh.shape, "devices": sorted(devices),
        "state_leaves": len(leaves), "sharded_leaves": len(sharded),
        "replicated_leaves": len(leaves) - len(sharded),
        "adamw_moments": len(moments),
        "moments_with_data_axis": len(moments) - len(missing)}))
    if not moments or missing:
        raise AssertionError(f"train: ZeRO-1 left moments without a data "
                             f"axis: {missing[:3]}")


# The ranks phase: the train phase's run (TRAIN) over RANKS ranks, each a
# process started by torchrun, on the one card over gloo (NCCL refuses two
# ranks on one card); on a machine with 2 or more cards the same run over
# NCCL at min(4, cards) ranks, a card each.  Step 1's loss within
# RANKS_STEP1_TOL of the one-process run's (the same parameters; only
# the CE's sum order differs); every later step within RANKS_LOSS_BOUND:
# the ranks' partial weight gradients round to bfloat16 apart from the
# whole batch's (2e-3 relative of the summed gradient on the CPU), which
# moves later losses by a few 1e-3 (the CPU at smoke and at mid size:
# at most 3.4e-3 and 3.7e-3 over 20 steps), while leaving one rank's
# gradients out of the sum moved them by 2.4e-2 and 5.7e-2 (the planted
# fault, RANKS_PLANTED_STEPS steps, must exceed the bound).
RANKS = 2
RANKS_STEP1_TOL = 1e-5
RANKS_LOSS_BOUND = 2e-2
RANKS_PLANTED_STEPS = 8
RANKS_TIMEOUT_S = 420
# a drim-bnn step's flash launches on each rank: the forward twice per
# layer (remat), each backward kernel once
RANKS_FLASH_PER_STEP = {"flash_attn_fwd": 24, "flash_bwd_dkv": 12,
                        "flash_bwd_dq": 12}
# The ranks phase's optimizer legs (ROADMAP item 16.3): TRAIN's batch and
# sequence at full width (d_model 768, vocab 32768) cut to
# RANKS_OPT_LAYERS layers and RANKS_OPT_STEPS steps over (2, 1), each
# rank on its blocks: adam8bit (embed's codes are cut over "data" by
# their columns, so the block maxima cross the ranks) and AdamW with
# --compress (the residuals cut over "data").  Each is held to the same
# argv and cut run in one process on the card: step 1 within
# RANKS_STEP1_TOL, the later steps RANKS_OPT_HELD names within
# RANKS_LOSS_BOUND; the flash launches 4 / 2 / 2 a step.  adam8bit's
# losses are held to step 2 (its first update): its int8 codes round a
# small second moment to 0, and where the next gradient is 0 (an
# embedding row the batch does not use) the update divides the first
# moment by eps, so from the second update on the trajectory turns on
# which way single codes round, which the float order of the gradient's
# sum over the ranks decides (the reference's optimizer, unchanged).  In
# their place one more update from the leg's final state is made by the
# rank path and by one process's `update` on the whole leaves gathered
# for the check, from the same summed gradients and clip norm, and must
# agree bit for bit (`rank_update_check`): the codes, scales and params.
RANKS_OPT_LAYERS, RANKS_OPT_STEPS = 2, 4
RANKS_OPT_LEGS = {"drim-bnn adam8bit (2, 1)": ["--optimizer", "adam8bit"],
                  "drim-bnn compress (2, 1)": ["--compress"]}
RANKS_OPT_HELD = {"drim-bnn adam8bit (2, 1)": 2,
                  "drim-bnn compress (2, 1)": RANKS_OPT_STEPS}


def ranks_opt_argv(leg: str) -> list:
    """The train CLI's flags of an optimizer leg (RANKS_OPT_LEGS)."""
    argv = list(TRAIN) + RANKS_OPT_LEGS[leg]
    argv[argv.index("--steps") + 1] = str(RANKS_OPT_STEPS)
    return argv


# Trees drawn once on the host for every process of the script that
# needs them: the parent writes each whole tree whose key
# (`shared_draw_keys`: the tp worker's non-MoE legs) it draws, in a
# temporary directory named in DRAWS_ENV, and the tp worker's ranks read
# it and keep their blocks (`serve.place_params`), the weights
# `init_params` inside their mesh would draw (init-then-cut, tested on
# the CPU).  The MoE legs draw their own blocks, as their check asks.
DRAWS_ENV = "CHIP_SMOKE_DRAWS"


def draw_key(seed: int, cfg) -> str:
    """A seeded tree's key: the seed and the config, whose activation
    dtype the draw does not read."""
    import hashlib
    text = repr((int(seed), cfg.replace(dtype="bfloat16")))
    return hashlib.sha1(text.encode()).hexdigest()[:20]


def shared_draw_keys() -> set:
    """The keys of the trees the tp worker's non-MoE legs draw."""
    from repro_torch.launch import serve, train
    keys = set()
    for argv in [tp_serve_argvs()["qwen3-14b"]] + [
            family_argv(arch, layers, prompt)
            for arch, layers, prompt, _, _ in TP_FAMILY_SERVE]:
        keys.add(draw_key(SEED, serve.build_cfg(serve.parse_args(argv))))
    for arch, layers in TP_FAMILY_TRAIN:
        argv, cut = family_train_argv(arch)
        cut.update(depth_cut(arch, layers))
        keys.add(draw_key(SEED, train.build_cfg(train.parse_args(argv))
                          .replace(**cut)))
    return keys


@contextlib.contextmanager
def shared_draws(directory: str, keys=None):
    """`init_params` as `repro_torch.models`, `launch.serve` and
    `runtime.steps` call it, reading a non-MoE tree another process drew
    from `directory` (`draw_key`; under a model axis over ranks this
    rank's blocks of it) and, where `keys` is given, writing there each
    whole tree it draws whose key is in `keys` (where the disk has room
    for it twice over)."""
    import shutil
    from repro_torch import models
    from repro_torch.core.mesh import model_ranks
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve
    from repro_torch.runtime import steps
    from repro_torch.tree import tree_leaves, tree_map
    inner = models.init_params

    def init(seed, cfg, *, device=None):
        if cfg.family == "moe" or not isinstance(seed, int):
            return inner(seed, cfg, device=device)
        key = draw_key(seed, cfg)
        path = os.path.join(directory, key + ".pt")
        mesh = model_ranks()
        if os.path.exists(path):
            dev = resolve_device(device)
            whole = torch.load(path, map_location="cpu", mmap=True,
                               weights_only=True)
            if mesh is not None:
                whole = serve.place_params(whole, mesh, cfg.family)
            return tree_map(lambda t: t.to(dev), whole)
        params = inner(seed, cfg, device=device)
        if keys is not None and key in keys and mesh is None:
            size = sum(t.numel() * t.element_size()
                       for t in tree_leaves(params))
            if shutil.disk_usage(directory).free > 2 * size:
                torch.save(tree_map(lambda t: t.detach().cpu(), params),
                           path + ".part")
                os.replace(path + ".part", path)
        return params
    names = [(models, "init_params"), (serve, "init_params"),
             (steps, "init_params")]
    saved = [getattr(m, n) for m, n in names]
    for m, n in names:
        setattr(m, n, init)
    try:
        yield
    finally:
        for (m, n), fn in zip(names, saved):
            setattr(m, n, fn)


def kernel_wrappers():
    """{counter name: the wrapper whose `.launches` counts its kernel}."""
    from repro_torch.kernels import (aap_interpreter, bitserial_add,
                                     flash_attention, packbits, xnor_popcount)
    from repro_torch.kernels.bitwise import (binary_kernel, not_kernel,
                                             ternary_kernel)
    return {"pack_signs": packbits.pack_signs,
            "xnor_gemm": xnor_popcount.xnor_gemm_packed,
            "aap_interp": aap_interpreter.aap_interp,
            "aap_interp_faulted": aap_interpreter.aap_interp_faulted,
            "flash_attn_fwd": flash_attention.flash_fwd,
            "flash_bwd_dkv": flash_attention.flash_bwd_dkv,
            "flash_bwd_dq": flash_attention.flash_bwd_dq,
            "bitwise_not": not_kernel, "bitwise_binary": binary_kernel,
            "bitwise_ternary": ternary_kernel,
            "bitplane_add": bitserial_add.bitplane_add,
            "unpack_signs": packbits.unpack_signs}


def torchrun(n: int, args, timeout: float):
    """`python -m torch.distributed.run --standalone --nproc-per-node n
    chip_smoke.py *args` in a session of its own, killed with every
    process it started after `timeout` s; returns (exit code, stdout,
    stderr, wall s)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(n), str(pathlib.Path(__file__).resolve()),
           *args]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out, err = proc.communicate()
        return 124, out, err, time.perf_counter() - t0
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()
    return proc.returncode, out, err, time.perf_counter() - t0


def sha_of(t: torch.Tensor) -> str:
    import hashlib
    return hashlib.sha256(t.detach().cpu().contiguous().view(-1)
                          .view(torch.uint8).numpy().tobytes()).hexdigest()


def ranks_worker(out: str, kind: str, model_axis: int = 1) -> int:
    """One rank of the ranks phase (`model_axis` 1) or of the tp phase
    (TP), started by torchrun (`chip_smoke.py --ranks-worker OUT KIND` or
    `--tp-worker OUT KIND`, KIND "gloo" or "nccl"): the legs through
    `launch.train.main --model-axis model_axis` under deterministic
    algorithms (`init_ranks` reads torchrun's environment): "straight"
    (TRAIN with checkpoints in OUT/straight), then for KIND "gloo" the
    "restart" (the step-RESTART_AT checkpoint, --resume, to the end in
    OUT/resumed) and the "planted" fault (RANKS_PLANTED_STEPS steps: over
    data ranks rank 1's gradients zeroed before the sum, over a model
    axis rank 1 skipping layer 0's wo reduce); over data ranks and gloo,
    then the optimizer legs (RANKS_OPT_LEGS, with `state_bytes`) ->
    OUT/rank<r>_<`opt_leg_file`>.json; over a model axis and
    gloo, then the tp serve legs (`tp_serve_legs`); over a model axis,
    then the MoE serving legs (`tp_moe_serve_legs`) and, for gloo, the
    MoE training leg (`tp_moe_train_leg`), -> OUT/rank<r>_moe.pt; over a
    model axis and gloo, then the ssm, hybrid, vlm and audio legs
    (`tp_family_serve_legs`, `tp_family_train_legs`) ->
    OUT/rank<r>_families.pt, the serving modes (`tp_mode_legs`) ->
    OUT/rank<r>_modes.pt and the uneven-heads legs (`uneven_legs`) ->
    OUT/rank<r>_uneven.pt.  Each
    training leg's launches, collective calls, bytes and seconds in all
    and by axis (apart from the checkpoint's gathers), peak bytes and
    printed lines, and each step's collectives (`trainer_spy`) go to
    OUT/rank<r>_<leg>.json."""
    import shutil
    from repro_torch.core import mesh as core_mesh
    from repro_torch.launch import train
    from repro_torch.launch.mesh import init_ranks
    torch.backends.cuda.matmul.allow_tf32 = False
    ranks = init_ranks(train.parse_args(TRAIN).device)
    wrappers = kernel_wrappers()
    mesh = train.cli_mesh("host", ranks.device, ranks, model_axis)
    draws = contextlib.ExitStack()
    if os.environ.get(DRAWS_ENV):
        draws.enter_context(shared_draws(os.environ[DRAWS_ENV]))
    axis = ["--model-axis", str(model_axis)]
    legs = [("straight", TRAIN + axis + ["--ckpt-dir", f"{out}/straight"])]
    if kind == "gloo":
        planted = list(TRAIN)
        planted[planted.index("--steps") + 1] = str(RANKS_PLANTED_STEPS)
        legs += [("restart", TRAIN + axis + ["--ckpt-dir", f"{out}/resumed",
                                             "--resume"]),
                 ("planted", planted + axis)]
    try:
        for leg, argv in legs:
            if leg == "restart":
                if ranks.rank == 0:
                    step_dir = f"step_{RESTART_AT:09d}"
                    os.makedirs(f"{out}/resumed")
                    shutil.copytree(f"{out}/straight/{step_dir}",
                                    f"{out}/resumed/{step_dir}")
                    with open(f"{out}/resumed/LATEST", "w") as f:
                        f.write(str(RESTART_AT))
                core_mesh.mesh_barrier(mesh)
            plant = (planted_fault(model_axis)
                     if leg == "planted" and ranks.rank == 1
                     else contextlib.nullcontext())
            record, seen = train_leg(ranks, wrappers, argv, plant)
            if leg == "straight":
                record.update(state_bytes(seen, mesh), hashes={
                    p: sha_of(t) for p, t in flat_leaves(seen["state"])})
            with open(os.path.join(out, f"rank{ranks.rank}_{leg}.json"),
                      "w") as f:
                json.dump(record, f, default=float)
        if model_axis == 1 and kind == "gloo":
            for leg in RANKS_OPT_LEGS:
                args = train.parse_args(ranks_opt_argv(leg))
                torch.cuda.empty_cache()
                record, seen = train_leg(ranks, wrappers, ranks_opt_argv(leg),
                                         contextlib.nullcontext(),
                                         n_layers=RANKS_OPT_LAYERS)
                record.update(state_bytes(seen, mesh, args.optimizer,
                                          args.compress))
                if RANKS_OPT_HELD[leg] < RANKS_OPT_STEPS:
                    record["update_check"] = rank_update_check(
                        seen, mesh, args.optimizer, args.lr)
                del seen
                with open(os.path.join(out, f"rank{ranks.rank}_"
                                       f"{opt_leg_file(leg)}.json"),
                          "w") as f:
                    json.dump(record, f, default=float)
        if model_axis > 1 and kind == "gloo":
            tp_serve_legs(out, ranks, wrappers)
        if model_axis > 1:
            moe = {"serve": tp_moe_serve_legs(ranks, wrappers, mesh)}
            if kind == "gloo":
                moe["train"] = tp_moe_train_leg(ranks, wrappers, mesh)
            torch.save(moe, os.path.join(out, f"rank{ranks.rank}_moe.pt"))
        if model_axis > 1 and kind == "gloo":
            fam = {"serve": tp_family_serve_legs(ranks, wrappers),
                   "train": tp_family_train_legs(ranks, wrappers, mesh)}
            torch.save(fam, os.path.join(out,
                                         f"rank{ranks.rank}_families.pt"))
            del fam
            torch.save(tp_mode_legs(ranks, wrappers),
                       os.path.join(out, f"rank{ranks.rank}_modes.pt"))
            torch.save(uneven_legs(wrappers, model_axis),
                       os.path.join(out, f"rank{ranks.rank}_uneven.pt"))
    finally:
        draws.close()
        ranks.close()
    return 0


def state_bytes(seen, mesh, optimizer: str = "adamw",
                compress: bool = False) -> dict:
    """A rank's state after a leg (`trainer_spy`'s dict) of `optimizer`:
    its param and moment bytes (AdamW's "m" and "v", Adafactor's factored
    "f", adam8bit's codes and scales "q"), their specs' local bytes, one
    process's bytes, and the bytes of the leaves the specs leave whole;
    with `compress`, the same of the error-feedback residuals."""
    from repro_torch.core.mesh import local_shape
    from repro_torch.optim import get_optimizer
    from repro_torch.runtime import steps
    from repro_torch.tree import tree_leaves
    state = seen["state"]
    specs, shapes = steps.state_pspecs(seen["cfg"], get_optimizer(optimizer),
                                       mesh, compress)
    keys = [k for k in shapes["opt"] if k != "step"]

    def local_bytes(part, keys):
        return int(sum(
            np.prod(local_shape(tuple(t.shape), sp, mesh))
            * t.element_size() for k in keys for t, sp in
            zip(tree_leaves(shapes[part][k] if k else shapes[part]),
                tree_leaves(specs[part][k] if k else specs[part]))))

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))
    moments = {k: state["opt"][k] for k in keys}
    out = dict(
        moment_bytes=nbytes(moments),
        moment_bytes_one_process=nbytes({k: shapes["opt"][k] for k in keys}),
        moment_bytes_of_specs=local_bytes("opt", keys),
        param_bytes=nbytes(state["params"]),
        param_bytes_one_process=nbytes(shapes["params"]),
        param_bytes_of_specs=local_bytes("params", (None,)),
        replicated_param_bytes=sum(
            t.numel() * t.element_size() for t, sp in
            zip(tree_leaves(shapes["params"]), tree_leaves(specs["params"]))
            if all(e is None for e in sp)))
    if compress:
        out.update(residual_bytes=nbytes(state["errors"]),
                   residual_bytes_one_process=nbytes(shapes["errors"]),
                   residual_bytes_of_specs=local_bytes("errors", (None,)))
    return out


def rank_update_check(seen, mesh, optimizer: str, lr: float) -> dict:
    """One more update from a leg's final state (`trainer_spy`'s dict) on
    its last batch, made twice from the same gradients (this rank's rows,
    summed over the ranks: `steps.sum_rank_grads`): by the rank path
    (`steps.rank_update`, each rank on its blocks) and by one process's
    `optimizer.update` on the whole leaves, gathered for the check (the
    same clip norm: at a data mesh of whole params `steps.tp_global_norm`
    and `global_norm` add the same sums in the same order).  Returns
    {"equal": whether the rank's new params and state are the whole
    update's cut bit for bit, "differ": the first leaves that are not,
    "leaves": how many were compared}."""
    from repro_torch.optim import get_optimizer
    from repro_torch.runtime import steps
    cfg, state, opt = seen["cfg"], seen["state"], get_optimizer(optimizer)
    specs, shapes = steps.state_pspecs(cfg, opt, mesh)
    with mesh:
        rows = steps.rank_rows(seen["batch"], mesh)[0]
        _, _, grads = steps._loss_and_grads(cfg, state["params"], rows)
        grads = steps.sum_rank_grads(cfg, grads, rows, mesh)
    lr = torch.tensor(lr, dtype=torch.float32, device=mesh.device)
    new_p, new_opt, _, _ = steps.rank_update(optimizer, opt, state, grads,
                                             lr, specs, shapes, mesh)
    want_p, want_opt = opt.update(
        steps.gather(grads, specs["params"], shapes["params"], mesh),
        steps.gather(state["opt"], specs["opt"], shapes["opt"], mesh),
        steps.gather(state["params"], specs["params"], shapes["params"],
                     mesh), lr)
    got = dict(flat_leaves({"params": new_p, "opt": new_opt}))
    want = flat_leaves(steps.cut({"params": want_p, "opt": want_opt},
                                 {k: specs[k] for k in ("params", "opt")},
                                 mesh))
    differ = [p for p, t in want if not torch.equal(got[p], t)]
    return {"equal": not differ and len(got) == len(want),
            "differ": differ[:5], "leaves": len(want)}


@contextlib.contextmanager
def planted_ep_fault(on: bool):
    """Where `on` (model index 1), this rank's expert-parallel partial
    left out of the sum: its `_combine` gives zeros, and the all-reduce
    still runs, so the ranks' collectives stay matched."""
    from repro_torch.models import moe
    if not on:
        yield
        return
    combine = moe._combine
    moe._combine = lambda *a: torch.zeros_like(combine(*a))
    try:
        yield
    finally:
        moe._combine = combine


def tp_moe_serve_legs(ranks, wrappers, mesh) -> dict:
    """The tp phase's MoE serving legs on this rank (TP_MOE_ARCHS, the
    families phase's flags, `serve.run_serve --model-axis M` over
    `mesh`'s M): each leg's tokens, prefill logits and top-two gaps
    (`tap_values`), launches (zeroed just before), the rank's expert bank
    and decode cache bytes, peak GB and wall s; then, outside the count,
    the leg again from the drawn blocks with the planted fault
    (`planted_ep_fault`) on model index 1: its tokens and prefill
    logits.  Returns {arch: record}."""
    from repro_torch.launch import serve
    from repro_torch.tree import tree_leaves
    res = {}
    m = mesh.shape["model"]
    for arch in TP_MOE_ARCHS:
        args = serve.parse_args(family_argv(arch, 1, 256)
                                + ["--model-axis", str(m)])
        drawn, caches = [], []
        init, splice = serve.init_params, serve.splice_rank_caches

        def spy_init(*a, **kw):
            drawn.append(init(*a, **kw))
            return drawn[-1]

        def spy_splice(*a, **kw):
            caches.append(splice(*a, **kw))
            return caches[-1]
        for fn in wrappers.values():
            fn.launches = 0
        torch.cuda.empty_cache()
        reset_peak()
        t0 = time.perf_counter()
        serve.init_params, serve.splice_rank_caches = spy_init, spy_splice
        try:
            with logits_tap() as tap:
                gen, stats = serve.run_serve(args)
        finally:
            serve.init_params, serve.splice_rank_caches = init, splice
        torch.cuda.synchronize()
        rec = {"gen": gen, "stats": stats, **tap_values(tap),
               "launches": {n: fn.launches for n, fn in wrappers.items()},
               "wall_s": time.perf_counter() - t0,
               "peak_gb": peak_bytes() / 1e9}
        params = drawn.pop()
        bank = params["layers"]["moe"]
        rec["expert_bytes"] = sum(bank[k].numel() * bank[k].element_size()
                                  for k in ("gate", "up", "down"))
        rec["cache_bytes"] = sum(t.numel() * t.element_size()
                                 for t in tree_leaves(caches.pop()))
        del caches, bank
        # the leg again from the drawn blocks, with the planted fault
        serve.init_params = lambda *a, **kw: params
        try:
            with planted_ep_fault(mesh.coords()[1] == 1), \
                    logits_tap() as tap:
                gen, _ = serve.run_serve(args)
        finally:
            serve.init_params = init
        rec.update(planted_gen=gen,
                   planted_prefill=tap_values(tap)["prefill"])
        del params, drawn, tap
        torch.cuda.empty_cache()
        res[arch] = rec
    return res


def tp_moe_train_argv() -> list:
    """`launch.train`'s arguments of the tp phase's MoE training leg
    (TP_MOE_TRAIN over (1, TP); the config's cut is `trainer_spy`'s)."""
    arch, _, _, batch, seq, opt, lr = TP_MOE_TRAIN
    return ["--arch", arch, "--steps", str(FAMILY_TRAIN_STEPS), "--batch",
            str(batch), "--seq", str(seq), "--mesh", "host", "--optimizer",
            opt, "--lr", str(lr), "--log-every", "1", "--seed", str(SEED),
            "--model-axis", str(TP)]


def tp_moe_train_leg(ranks, wrappers, mesh) -> dict:
    """The tp phase's MoE training leg on this rank (TP_MOE_TRAIN through
    `launch.train.main --model-axis TP`, the config cut by `trainer_spy`):
    `train_leg`'s record with the state's bytes (`state_bytes`)."""
    _, layers, experts, _, _, opt, _ = TP_MOE_TRAIN
    torch.cuda.empty_cache()
    record, seen = train_leg(ranks, wrappers, tp_moe_train_argv(),
                             contextlib.nullcontext(), n_layers=layers,
                             n_experts=experts)
    record.update(state_bytes(seen, mesh, opt))
    del seen
    torch.cuda.empty_cache()
    return record


def collective_since(before) -> dict:
    """`COLLECTIVE_STATS` minus its copy `before`."""
    from repro_torch.core import mesh as core_mesh
    return {k: v - before.get(k, 0)
            for k, v in core_mesh.COLLECTIVE_STATS.items()}


def tp_family_serve_legs(ranks, wrappers) -> dict:
    """The tp phase's ssm, hybrid, vlm and audio serving legs on this rank
    (TP_FAMILY_SERVE, the families phase's flags, `serve.run_serve
    --model-axis K`, under `float32_numerics` where the leg says): each
    leg's tokens, prefill logits and top-two gaps (`tap_values`),
    launches (zeroed just before), the rank's param and decode cache
    bytes, the collective calls, bytes and seconds of the prefill, of
    each decode call ("decode_collectives") and of the whole leg, peak GB
    and wall s.  An arch served by more than one
    leg at one depth is drawn whole once (`init_params` of the seed, the
    draw each leg would make) and handed to each leg, which keeps its
    blocks.  Right after the timed prefill, untimed: a float32 leg runs
    its prefill again with `planted_mixer_fault` on the last mixer
    ("planted_prefill"); an audio leg over a model axis prefills its
    prompts over seeded frames (TP_AUDIO_FRAMES), clean ("frames_prefill")
    and with `planted_cross_fault` at every decoder layer
    ("planted_prefill").  Their launches and collectives are left out of
    the leg's.  Returns {(arch, layers, K, float32): record}."""
    from repro_torch.core import mesh as core_mesh
    from repro_torch.launch import serve
    from repro_torch.launch.batching import make_decode_fn
    from repro_torch.models import init_params
    from repro_torch.tree import tree_leaves

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

    def counted_decode(*a, **kw):
        """`make_decode_fn` whose every call's collectives are kept
        ("decode_collectives")."""
        dec = make_decode_fn(*a, **kw)

        def run(*args):
            before = dict(core_mesh.COLLECTIVE_STATS)
            out, temp = measured_temp(lambda: dec(*args))
            decodes.append(collective_since(before))
            decode_temps.append(temp)
            return out
        return run
    legs_of = {}
    for arch, layers, *_ in TP_FAMILY_SERVE:
        legs_of[(arch, layers)] = legs_of.get((arch, layers), 0) + 1
    shared = {}
    res = {}
    for arch, layers, prompt, k, f32 in TP_FAMILY_SERVE:
        args = serve.parse_args(family_argv(arch, layers, prompt)
                                + ["--model-axis", str(k)])
        given = None
        if legs_of[(arch, layers)] > 1:
            if (arch, layers) not in shared:
                shared[(arch, layers)] = init_params(
                    SEED, serve.build_cfg(args), device=ranks.device)
            given = shared[(arch, layers)]
        caches, at_prefill, used, planted = [], [], {}, {}
        decodes, decode_temps = [], []
        inner = {n: getattr(serve, n) for n in
                 ("prefill", "splice_caches", "splice_rank_caches")}

        def spy_prefill(*a, **kw):
            before = dict(core_mesh.COLLECTIVE_STATS)
            out = inner["prefill"](*a, **kw)
            at_prefill.append(collective_since(before))
            if not used:
                used.update(args=a, kw=kw, bytes=nbytes(a[0]))
            return out

        def plant():
            """The untimed prefills, after the timed one."""
            a, kw = used.pop("args"), used.pop("kw")
            params, cfg, batch = a[0], a[1], a[2]
            before = dict(core_mesh.COLLECTIVE_STATS)
            counts = {n: fn.launches for n, fn in wrappers.items()}
            on = core_mesh.model_coord(core_mesh.model_ranks())[0] == 1
            if cfg.family == "audio":
                frames = {**batch, "frames": audio_frames(batch["tokens"],
                                                          cfg)}
                planted["frames_prefill"] = inner["prefill"](
                    params, cfg, frames)[0][:, -1].float().cpu()
                with planted_cross_fault(on):
                    lg = inner["prefill"](params, cfg, frames)[0]
            else:
                with planted_mixer_fault(on, cfg.n_layers - 1):
                    lg = inner["prefill"](*a, **kw)[0]
            planted.update(prefill=lg[:, -1].float().cpu(),
                           collective=collective_since(before),
                           launches={n: fn.launches - counts[n]
                                     for n, fn in wrappers.items()})

        def spy_splice(name):
            def spy(*a, **kw):
                if "args" in used and (f32 or (arch == TP_AUDIO
                                               and k > 1)):
                    plant()
                caches.append(inner[name](*a, **kw))
                return caches[-1]
            return spy
        for fn in wrappers.values():
            fn.launches = 0
        torch.cuda.empty_cache()
        reset_peak()
        before = dict(core_mesh.COLLECTIVE_STATS)
        t0 = time.perf_counter()
        serve.prefill = spy_prefill
        serve.splice_caches = spy_splice("splice_caches")
        serve.splice_rank_caches = spy_splice("splice_rank_caches")
        try:
            with float32_numerics(f32), logits_tap() as tap:
                gen, stats = serve.run_serve(args, params=given,
                                             make_fn=counted_decode)
        finally:
            for n, fn in inner.items():
                setattr(serve, n, fn)
        torch.cuda.synchronize()
        coll = collective_since(before)
        launches = {n: fn.launches for n, fn in wrappers.items()}
        if "launches" in planted:
            coll = {key: v - planted["collective"].get(key, 0)
                    for key, v in coll.items()}
            launches = {n: c - planted["launches"][n]
                        for n, c in launches.items()}
        res[(arch, layers, k, f32)] = {
            "gen": gen, "stats": stats, **tap_values(tap),
            "launches": launches,
            "wall_s": time.perf_counter() - t0,
            "peak_gb": peak_bytes() / 1e9,
            "param_bytes": used["bytes"], "cache_bytes": nbytes(caches[0]),
            "collective": coll, "prefill_collective": at_prefill[0],
            "decode_collectives": decodes, "decode_temp_b": decode_temps,
            "planted_prefill": planted.get("prefill"),
            "frames_prefill": planted.get("frames_prefill")}
        del caches, tap, used
        legs_of[(arch, layers)] -= 1
        if not legs_of[(arch, layers)]:
            shared.pop((arch, layers), None)
        torch.cuda.empty_cache()
    return res


def audio_frames(tokens: torch.Tensor, cfg) -> torch.Tensor:
    """Seeded frame embeddings [B, n_frames, d_model] in bfloat16 for
    `tokens`' rows (the global batch: `prefill` over ranks cuts them with
    the tokens) on their device (TP_AUDIO_FRAMES)."""
    rng = np.random.default_rng([SEED, TP_AUDIO_FRAMES])
    return torch.from_numpy(rng.standard_normal(
        (tokens.shape[0], cfg.n_frames, cfg.d_model)).astype(np.float32)) \
        .to(tokens.device, torch.bfloat16)


@contextlib.contextmanager
def planted_cross_fault(on: bool):
    """Where `on` (model index 1), every cross-attention call's `wo`
    partial left out of the sum: this rank's heads' outputs zeroed, the
    all-reduce still run, so the ranks' collectives stay matched."""
    from repro_torch.models import attention
    inner, out_fn = attention.cross_attend, attention._out

    def cross_attend(p, cfg, x, kv):
        if not on:
            return inner(p, cfg, x, kv)
        attention._out = lambda p, cfg, out: out_fn(p, cfg,
                                                    torch.zeros_like(out))
        try:
            return inner(p, cfg, x, kv)
        finally:
            attention._out = out_fn
    attention.cross_attend = cross_attend
    try:
        yield
    finally:
        attention.cross_attend = inner


def mode_argv(leg: str):
    """(the serve flags of a TP_MODES leg at TP_MODE_LAYERS layers, its
    model axis)."""
    k, extra = TP_MODES[leg]
    return SERVE + extra + ["--layers", str(TP_MODE_LAYERS)], k


def mode_prompts(cfg):
    """The serve phase's two continuous prompts (256 and 200 tokens)."""
    return [np.random.default_rng([SEED, 2]).integers(0, cfg.vocab_size, n)
            for n in (256, 200)]


def failing_make_fn(rank: int):
    """A `make_fn` for `serve.make_resilient_decode` whose decode fns on a
    DRIM engine fail on `rank` (the process itself where no group is
    initialised) from their TP_FAIL_FROM-th call on, after running the
    step: a failure found at the step's readback."""
    import torch.distributed as dist
    from repro_torch.launch import batching

    def make_fn(cfg, ctx_len, temperature, engine, n_queues):
        inner = batching.make_decode_fn(cfg, ctx_len, temperature, engine,
                                        n_queues)
        calls = [0]

        def dec(*args):
            out = inner(*args)
            calls[0] += 1
            me = dist.get_rank() if dist.is_initialized() else rank
            if me == rank and calls[0] >= TP_FAIL_FROM \
                    and engine != batching.NATIVE_ENGINE:
                raise RuntimeError(f"planted failure at call {calls[0]}")
            return out
        return dec
    return make_fn


@contextlib.contextmanager
def batcher_tap():
    """Record, for a continuous run, the top-two gap of the logits of
    each request's tokens (its first from its admission's prefill, the
    rest from the waves' decode steps at its slot); yields {rid:
    [gap, ...]}."""
    from repro_torch.launch import batching
    gaps, now = {}, {"rid": None, "slots": []}
    sample = batching.sample_tokens
    admit, pending = batching.WaveBatcher._admit, \
        batching.WaveBatcher._admit_pending

    def tapped_sample(logits, temperature, key):
        top = logits[:, -1].topk(2, -1).values
        gap = (top[:, 0] - top[:, 1]).float().cpu().tolist()
        if now["rid"] is not None:
            gaps.setdefault(now["rid"], []).append(gap[0])
        else:
            for slot, rid in enumerate(now["slots"]):
                if rid >= 0:
                    gaps.setdefault(rid, []).append(gap[slot])
        return sample(logits, temperature, key)

    def tapped_admit(self, req, slot):
        now["rid"] = req.rid
        try:
            return admit(self, req, slot)
        finally:
            now["rid"] = None

    def tapped_pending(self):
        out = pending(self)
        now["slots"] = list(self._slot_rid)
        return out
    batching.sample_tokens = tapped_sample
    batching.WaveBatcher._admit = tapped_admit
    batching.WaveBatcher._admit_pending = tapped_pending
    try:
        yield gaps
    finally:
        batching.sample_tokens = sample
        batching.WaveBatcher._admit = admit
        batching.WaveBatcher._admit_pending = pending


def run_mode(leg: str, wrappers, extra=()):
    """A TP_MODES leg through the serve CLI's entry point (`extra`: more
    flags, the model axis over ranks), its launch counters zeroed just
    before: {"out": the entry point's result, "launches", "gaps" (a
    continuous leg's, `batcher_tap`), "wall_s", "peak_gb"}."""
    from repro_torch.launch import serve
    argv, _ = mode_argv(leg)
    args = serve.parse_args(argv + list(extra))
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.empty_cache()
    reset_peak()
    t0 = time.perf_counter()
    with batcher_tap() as gaps:
        if args.continuous:
            out = serve.run_continuous(args, prompts=mode_prompts(
                serve.build_cfg(args)))
        elif args.microbench:
            out = serve.run_microbench(args)
        else:
            out = serve.run_serve(args, make_fn=failing_make_fn(1))
    torch.cuda.synchronize()
    return {"out": out, "gaps": {r: list(g) for r, g in gaps.items()},
            "launches": {n: fn.launches for n, fn in wrappers.items()},
            "wall_s": time.perf_counter() - t0,
            "peak_gb": peak_bytes() / 1e9}


def tp_mode_legs(ranks, wrappers) -> dict:
    """The tp phase's serving-mode legs on this rank (TP_MODES through
    `run_mode` with `--model-axis K`), each with its collective calls,
    bytes and seconds; returns {leg: record}."""
    from repro_torch.core import mesh as core_mesh
    res = {}
    for leg, (k, _) in TP_MODES.items():
        before = dict(core_mesh.COLLECTIVE_STATS)
        res[leg] = run_mode(leg, wrappers, ["--model-axis", str(k)])
        res[leg]["collective"] = collective_since(before)
    return res


def family_train_argv(arch: str):
    """The train CLI's flags of `arch`'s train-families leg
    (TRAIN_FAMILIES), and its config cut (`trainer_spy`'s)."""
    _, layers, experts, batch, seq, opt, lr = next(
        leg for leg in TRAIN_FAMILIES if leg[0] == arch)
    argv = ["--arch", arch, "--steps", str(FAMILY_TRAIN_STEPS), "--batch",
            str(batch), "--seq", str(seq), "--mesh", "host", "--optimizer",
            opt, "--lr", str(lr), "--log-every", "1", "--seed", str(SEED)]
    cut = depth_cut(arch, layers)
    if experts:
        cut["n_experts"] = experts
    return argv, cut


def depth_cut(arch: str, layers: int) -> dict:
    """The config cut of a training leg at depth `layers` (0: none): the
    layers, and for the audio family its encoder's as well."""
    if not layers:
        return {}
    cut = {"n_layers": layers}
    if arch == TP_AUDIO:
        cut["encoder_layers"] = layers
    return cut


def trained_key(arch: str, layers: int) -> str:
    """The TRAINED key of a training leg at depth `layers` (0: the
    published): the arch where its train-families leg has that depth,
    else "<arch> <layers> layers"."""
    _, cut = family_train_argv(arch)
    return arch if cut.get("n_layers", 0) == layers \
        else f"{arch} {layers} layers"


def tp_family_train_legs(ranks, wrappers, mesh) -> dict:
    """The tp phase's ssm, hybrid and vlm training legs on this rank
    (TP_FAMILY_TRAIN: their TRAIN_FAMILIES legs at the depth given,
    `launch.train.main --model-axis TP`, llava with --donate):
    `train_leg`'s records with the state's bytes (`state_bytes`), by
    arch."""
    res = {}
    for arch, layers in TP_FAMILY_TRAIN:
        argv, cut = family_train_argv(arch)
        argv += ["--model-axis", str(TP)]
        if arch == "llava-next-34b":
            argv.append("--donate")
        cut.update(depth_cut(arch, layers))
        torch.cuda.empty_cache()
        record, seen = train_leg(ranks, wrappers, argv,
                                 contextlib.nullcontext(), **cut)
        record.update(state_bytes(seen, mesh))
        del seen
        torch.cuda.empty_cache()
        res[arch] = record
    return res


def train_leg(ranks, wrappers, argv, plant, **cut):
    """`train.main(argv)` on this rank under deterministic algorithms and
    `plant` (a context: the planted fault, or nothing), the config cut by
    `cut` (`trainer_spy`), with the launch counters zeroed first; returns
    (the leg's record, `trainer_spy`'s dict).  The checkpoint's gathers
    are timed apart."""
    from repro_torch.core import mesh as core_mesh
    from repro_torch.launch import train
    for fn in wrappers.values():
        fn.launches = 0
    stats0 = dict(core_mesh.COLLECTIVE_STATS)
    gathers = {"s": 0.0}
    gather = train.gather

    def timed_gather(*a, **kw):
        t0 = time.perf_counter()
        try:
            return gather(*a, **kw)
        finally:
            gathers["s"] += time.perf_counter() - t0
    train.gather = timed_gather
    reset_peak()
    text = io.StringIO()
    t0 = time.perf_counter()
    try:
        with deterministic(), trainer_spy(train, **cut) as seen, plant, \
                contextlib.redirect_stdout(text):
            train.main(argv)
    finally:
        train.gather = gather
    torch.cuda.synchronize()
    record = {
        "rank": ranks.rank, "world_size": ranks.world,
        "backend": ranks.backend, "device": str(ranks.device),
        "launches": {n: fn.launches for n, fn in wrappers.items()},
        "collective": {k: v - stats0.get(k, 0)
                       for k, v in core_mesh.COLLECTIVE_STATS.items()},
        "checkpoint_gather_s": gathers["s"],
        "wall_s": time.perf_counter() - t0,
        "peak_gb": peak_bytes() / 1e9,
        "losses": seen["losses"],
        "step_collectives": seen["step_collectives"],
        "step_temp_b": seen["step_temp_b"],
        "lines": [json.loads(line) for line in text.getvalue().splitlines()
                  if line.startswith("{")]}
    return record, seen


@contextlib.contextmanager
def planted_fault(model_axis: int):
    """This rank's planted fault: over data ranks its gradients zeroed
    before the sum; over a model axis its layer-0 `wo` product left as
    its own partial (the sum still runs and carries the gradient, so the
    ranks' collectives, the backward's too, stay matched; its value is
    dropped).  Layer 0's leaves are the
    stacked leaves' first views, at storage offset 0."""
    from repro_torch.models import attention, layers
    from repro_torch.runtime import steps
    from repro_torch.tree import tree_map
    if model_axis == 1:
        sum_tree = steps._sum_tree
        steps._sum_tree = lambda tree, *a: sum_tree(
            tree_map(torch.zeros_like, tree), *a)
        try:
            yield
        finally:
            steps._sum_tree = sum_tree
        return
    from repro_torch.core import mesh as core_mesh
    out_fn, row_sum = attention._out, layers.row_sum

    def skipped(part, mesh, dtype=None):
        # the rank's own partial (its block of the sequence inside a
        # sequence cut) is handed on; the sum still runs and carries the
        # gradient, so its backward's collective runs too and the ranks'
        # collectives stay matched
        whole = row_sum(part, mesh, dtype)
        if core_mesh.sequence_ranks() is not None:
            index, m = core_mesh.model_coord(mesh)
            width = part.shape[layers.SEQ_DIM] // m
            part = part.narrow(layers.SEQ_DIM, index * width, width)
        return part.to(whole.dtype).detach() + (whole - whole.detach())

    def faulty_out(p, cfg, out):
        if p["wo"]["kernel"].storage_offset():       # not layer 0
            return out_fn(p, cfg, out)
        layers.row_sum = skipped
        try:
            return out_fn(p, cfg, out)
        finally:
            layers.row_sum = row_sum
    attention._out = faulty_out
    try:
        yield
    finally:
        attention._out = out_fn


def check_rank_leg(records, leg: str, n_steps: int,
                   per_step=RANKS_FLASH_PER_STEP):
    """Each rank's flash launches (`per_step`, TRAIN's by default, times
    the leg's steps) and nothing else; rank 0's losses; every rank's
    first line its own."""
    for r in records:
        want = {n: per_step.get(n, 0) * n_steps for n in r["launches"]}
        if r["launches"] != want:
            raise AssertionError(f"ranks {leg} rank {r['rank']}: launches "
                                 f"{r['launches']}, expected {want}")
        if r["rank"] and any("step" in line for line in r["lines"]):
            raise AssertionError(f"ranks {leg}: rank {r['rank']} printed "
                                 "steps")
    losses = records[0]["losses"]
    if records[1]["losses"] != losses:
        raise AssertionError(f"ranks {leg}: the ranks' losses differ")
    if len(losses) != n_steps or not np.all(np.isfinite(losses)):
        raise AssertionError(f"ranks {leg}: losses {losses}")
    return losses


def loss_gaps(losses, one):
    return [abs(a - b) for a, b in zip(losses, one)]


def opt_leg_file(leg: str) -> str:
    """The record files' stem of an optimizer leg (RANKS_OPT_LEGS)."""
    return "opt_" + leg.split()[1]


def one_process_opt_legs() -> dict:
    """Each optimizer leg's argv and cut (RANKS_OPT_LEGS) trained in one
    process on the card (`launch.train.main`, deterministic): {leg: its
    losses}."""
    from repro_torch.launch import train
    out = {}
    for leg in RANKS_OPT_LEGS:
        torch.cuda.empty_cache()
        with deterministic(), \
                trainer_spy(train, n_layers=RANKS_OPT_LAYERS) as seen, \
                contextlib.redirect_stdout(io.StringIO()):
            train.main(ranks_opt_argv(leg))
        out[leg] = list(seen["losses"])
        del seen
    torch.cuda.empty_cache()
    return out


def check_rank_opt_legs(tmp: str, one: dict) -> dict:
    """The optimizer legs over (2, 1) (RANKS_OPT_LEGS, the ranks' records
    in `tmp`) held to their one-process losses `one`: step 1 within
    RANKS_STEP1_TOL, the later steps RANKS_OPT_HELD names within
    RANKS_LOSS_BOUND and, where it names fewer than the leg's, each
    rank's `rank_update_check` bit for bit; each rank's flash launches 2
    forwards, a dkv and a dq a layer a step (remat); each rank's param,
    state and residual bytes its specs' local bytes, its state and
    residuals under one process's.  Fills
    MEASURED_RANK_LEGS and MEASURED_RANK_MEMORY; a "ranks" line a leg.
    Returns {leg: the ranks' launches, summed}."""
    per_step = {"flash_attn_fwd": 2 * RANKS_OPT_LAYERS,
                "flash_bwd_dkv": RANKS_OPT_LAYERS,
                "flash_bwd_dq": RANKS_OPT_LAYERS}
    counts = {}
    for leg in RANKS_OPT_LEGS:
        recs = [json.load(open(f"{tmp}/rank{r}_{opt_leg_file(leg)}.json"))
                for r in range(RANKS)]
        losses = check_rank_leg(recs, leg, RANKS_OPT_STEPS, per_step)
        gaps = loss_gaps(losses, one[leg])
        held = RANKS_OPT_HELD[leg]
        MEASURED_RANK_LEGS[leg] = [r["step_collectives"] for r in recs]
        MEASURED_RANK_MEMORY[leg] = [r["step_temp_b"] for r in recs]
        lines = [line for line in recs[0]["lines"] if "step" in line]
        per = recs[0]["step_collectives"]
        axes = sorted({k[len("calls:"):] for c in per for k in c
                       if k.startswith("calls:") and c[k]})
        parts = ("param", "moment") + (("residual",) if "residual_bytes"
                                       in recs[0] else ())
        print("ranks " + json.dumps({
            "leg": leg, "layers": RANKS_OPT_LAYERS, "steps": RANKS_OPT_STEPS,
            "s_per_step": (lines[-1]["wall_s"] - lines[0]["wall_s"])
            / (RANKS_OPT_STEPS - 1),
            "first_step_s": lines[0]["wall_s"],
            "peak_gb_per_rank": [r["peak_gb"] for r in recs],
            "rank0_calls_per_step_by_axis": {
                a: [c.get(f"calls:{a}", 0) for c in per] for a in axes},
            "rank0_gb_per_step_by_axis": {
                a: [c.get(f"bytes:{a}", 0) / 1e9 for c in per]
                for a in axes},
            "rank0_collective_s_per_step": [c.get("seconds", 0.0)
                                            for c in per],
            "bytes_per_rank": [{f"{k}_{w}": r[f"{k}_bytes{x}"]
                                for k in parts for w, x in (
                                    ("held", ""), ("specs", "_of_specs"),
                                    ("one_process", "_one_process"))}
                               for r in recs],
            "losses": losses, "one_process_losses": one[leg],
            "loss_gaps": gaps, "step1_tol": RANKS_STEP1_TOL,
            "loss_bound": RANKS_LOSS_BOUND, "steps_held": held,
            "update_check": [r.get("update_check") for r in recs]}))
        for r in recs:
            for k in parts:
                have, spec = r[f"{k}_bytes"], r[f"{k}_bytes_of_specs"]
                if have != spec or (k != "param" and not have
                                    < r[f"{k}_bytes_one_process"]):
                    raise AssertionError(
                        f"ranks {leg} rank {r['rank']}: {k} bytes {have}, "
                        f"the specs' {spec}, one process's "
                        f"{r[f'{k}_bytes_one_process']}")
        if gaps[0] > RANKS_STEP1_TOL \
                or max(gaps[1:held]) > RANKS_LOSS_BOUND:
            raise AssertionError(f"ranks {leg}: losses {losses} against "
                                 f"one process's {one[leg]}")
        if held < RANKS_OPT_STEPS and not all(
                r["update_check"]["equal"] for r in recs):
            raise AssertionError(f"ranks {leg}: the rank path's update is "
                                 f"not one process's: "
                                 f"{[r['update_check'] for r in recs]}")
        counts[leg] = {n: sum(r["launches"][n] for r in recs)
                       for n in recs[0]["launches"]}
    return counts


def phase_ranks(wrappers):
    """The train phase's run cut to TRAIN_STEPS steps over RANKS gloo
    ranks on the one card (each rank a process: `ranks_worker` under
    torchrun), held to the one-process run's first steps: step 1 within
    RANKS_STEP1_TOL, every later step within RANKS_LOSS_BOUND; each
    rank's flash launches 24 / 12 / 12 a step; each rank's AdamW moments
    half of one process's bytes, as the specs give; the 5 + 5 restart
    bitwise the straight 10 steps; the 2-rank
    checkpoint restored here (one process) equal, leaf for leaf, to each
    rank's own blocks; the planted fault past the loss bound.  Then NCCL:
    with 2 or more cards the straight run at min(4, cards) ranks; with
    one, two ranks' NCCL error.  The optimizer legs (RANKS_OPT_LEGS) run
    in the same torchrun, their one-process legs here first
    (`check_rank_opt_legs`).  Returns {"ranks": the ranks' launches
    (straight and restart legs, summed over the ranks), and each
    optimizer leg's}."""
    from repro_torch.checkpoint.checkpoint import Checkpointer
    from repro_torch.core.mesh import local_block
    from repro_torch.launch import train
    from repro_torch.optim import get_optimizer
    from repro_torch.runtime import steps
    one = TRAINED["losses"]
    args = train.parse_args(TRAIN)
    one_opt = one_process_opt_legs()
    with tempfile.TemporaryDirectory(prefix="drim_ranks_") as tmp:
        rc, out, err, wall = torchrun(RANKS, ["--ranks-worker", tmp, "gloo"],
                                      RANKS_TIMEOUT_S)
        if rc != 0:
            raise AssertionError(f"ranks: torchrun exited {rc}:\n"
                                 f"{out[-2000:]}\n{err[-4000:]}")
        legs = {leg: [json.load(open(f"{tmp}/rank{r}_{leg}.json"))
                      for r in range(RANKS)]
                for leg in ("straight", "restart", "planted")}
        straight = check_rank_leg(legs["straight"], "straight", TRAIN_STEPS)
        resumed = check_rank_leg(legs["restart"], "restart",
                                 TRAIN_STEPS - RESTART_AT)
        planted = check_rank_leg(legs["planted"], "planted",
                                 RANKS_PLANTED_STEPS)
        gaps = loss_gaps(straight, one)
        planted_gaps = loss_gaps(planted, one)
        recs = legs["straight"]
        MEASURED_RANK_LEGS["drim-bnn train (2, 1)"] = [
            r["step_collectives"] for r in recs]
        MEASURED_RANK_MEMORY["drim-bnn train (2, 1)"] = [
            r["step_temp_b"] for r in recs]
        lines = [line for line in recs[0]["lines"] if "step" in line]
        s_step = (lines[-1]["wall_s"] - lines[0]["wall_s"]) \
            / (TRAIN_STEPS - 1)
        coll = [r["collective"] for r in recs]
        print("ranks " + json.dumps({
            "backend": recs[0]["backend"], "world_size": RANKS,
            "devices": [r["device"] for r in recs],
            "steps": TRAIN_STEPS, "s_per_step": s_step,
            "global_tokens_per_s": args.batch * args.seq / s_step,
            "first_step_s": lines[0]["wall_s"],
            "peak_gb_per_rank": [r["peak_gb"] for r in recs],
            "collective_s_per_step": [
                (c["seconds"] - r["checkpoint_gather_s"]) / TRAIN_STEPS
                for c, r in zip(coll, recs)],
            "collective_calls": [c["calls"] for c in coll],
            "collective_gb": [c["bytes"] / 1e9 for c in coll],
            "checkpoint_gather_s": [r["checkpoint_gather_s"] for r in recs],
            "losses": straight, "one_process_losses": one,
            "loss_gaps": gaps, "loss_bound": RANKS_LOSS_BOUND,
            "torchrun_wall_s": wall}))
        for r in recs:
            print("ranks " + json.dumps({
                "rank": r["rank"], "device": r["device"],
                "moment_bytes": r["moment_bytes"],
                "moment_bytes_of_specs": r["moment_bytes_of_specs"],
                "moment_bytes_one_process": r["moment_bytes_one_process"]}))
            if not (r["moment_bytes"] == r["moment_bytes_of_specs"]
                    and 2 * r["moment_bytes"]
                    == r["moment_bytes_one_process"]):
                raise AssertionError(f"ranks: rank {r['rank']}'s moments "
                                     f"are not half the one-process bytes")
        if gaps[0] > RANKS_STEP1_TOL or max(gaps[1:]) > RANKS_LOSS_BOUND:
            raise AssertionError(f"ranks: losses {straight} against one "
                                 f"process's {one}")
        if max(planted_gaps) <= RANKS_LOSS_BOUND:
            raise AssertionError(f"ranks: the planted fault stayed inside "
                                 f"the bound: {planted_gaps}")
        print("ranks " + json.dumps({
            "planted": "rank 1's gradients left out of the sum",
            "steps": RANKS_PLANTED_STEPS, "loss_gaps": planted_gaps,
            "over_the_bound": True}))
        if resumed != straight[RESTART_AT:]:
            raise AssertionError(f"ranks: the restart's losses {resumed}")
        cfg = train.build_cfg(args)
        like = steps.abstract_train_state(cfg, get_optimizer("adamw"))
        step_dir = f"step_{TRAIN_STEPS:09d}"
        for name in os.listdir(f"{tmp}/straight/{step_dir}"):
            a = open(f"{tmp}/straight/{step_dir}/{name}", "rb").read()
            b = open(f"{tmp}/resumed/{step_dir}/{name}", "rb").read()
            if a != b:
                raise AssertionError(f"ranks: the restart's {name} differs")
        whole = Checkpointer(f"{tmp}/straight").restore(TRAIN_STEPS, like,
                                                        device="cpu")
        here = rank_mesh_here((RANKS, 1))
        specs = steps.state_pspecs(cfg, get_optimizer("adamw"), here)[0]
        cut = dict(zip((p for p, _ in flat_leaves(whole)),
                       (sp for _, sp in flat_leaves(specs))))
        for r in recs:
            differ = [p for p, t in flat_leaves(whole)
                      if sha_of(t[local_block(tuple(t.shape), cut[p], here,
                                              r["rank"])])
                      != r["hashes"][p]]
            if differ or len(r["hashes"]) != len(cut):
                raise AssertionError(f"ranks: rank {r['rank']}'s state "
                                     f"differs from the checkpoint in "
                                     f"{differ[:3]}")
        print("ranks " + json.dumps({
            "restart": f"{RESTART_AT} + checkpoint + "
                       f"{TRAIN_STEPS - RESTART_AT} steps over {RANKS} "
                       "ranks", "bit_identical_to_straight_run": True,
            "checkpoint_leaves": len(cut),
            "restored_in_one_process_equals_each_rank": True}))
        opt_counts = check_rank_opt_legs(tmp, one_opt)
        phase_ranks_nccl(tmp, one)
    counts = {n: sum(r["launches"][n] for leg in ("straight", "restart")
                     for r in legs[leg]) for n in wrappers}
    print("counts " + json.dumps({"phase": "ranks", **counts}))
    for leg, c in opt_counts.items():
        print("counts " + json.dumps({"phase": "ranks", "leg": leg, **c}))
    return {"ranks": counts, **opt_counts}


def phase_ranks_nccl(tmp: str, one) -> None:
    """With 2 or more cards, the straight run over NCCL at min(4, cards)
    ranks, a card each, held to the same bounds; with one card, NCCL's
    own error for two ranks on it (why the ranks phase runs gloo)."""
    from repro_torch.launch import rank_probe
    cards = torch.cuda.device_count()
    if cards < 2:
        t0 = time.perf_counter()
        said = rank_probe.run(rank_probe.probe_nccl, "cuda:0", [], 120)
        print("ranks " + json.dumps({
            "nccl": f"did not run: {cards} card visible, NCCL needs a card "
                    "a rank", "two_ranks_on_one_card": said,
            "probe_wall_s": time.perf_counter() - t0}))
        return
    n = min(4, cards)
    rc, out, err, wall = torchrun(n, ["--ranks-worker", f"{tmp}/nccl",
                                      "nccl"], RANKS_TIMEOUT_S)
    if rc != 0:
        raise AssertionError(f"ranks nccl: torchrun exited {rc}:\n"
                             f"{err[-4000:]}")
    recs = [json.load(open(f"{tmp}/nccl/rank{r}_straight.json"))
            for r in range(n)]
    losses = check_rank_leg(recs, "nccl", TRAIN_STEPS)
    gaps = loss_gaps(losses, one)
    print("ranks " + json.dumps({
        "backend": recs[0]["backend"], "world_size": n,
        "devices": [r["device"] for r in recs], "loss_gaps": gaps,
        "peak_gb_per_rank": [r["peak_gb"] for r in recs],
        "torchrun_wall_s": wall}))
    if recs[0]["backend"] != "nccl" or gaps[0] > RANKS_STEP1_TOL \
            or max(gaps[1:]) > RANKS_LOSS_BOUND:
        raise AssertionError(f"ranks nccl: {recs[0]['backend']}, {gaps}")


# The tp phase: the train phase's run (TRAIN) and the serve phase's legs
# over a model axis of TP ranks, `--model-axis TP` on the (1, TP) host
# mesh of ranks, a process each on the one card over gloo (torchrun runs
# `chip_smoke.py --tp-worker DIR gloo`).  Each rank holds its model block
# of every param and moment, so the forward differs from one process's
# in float order (the row products' partials summed in float32, then
# rounded to bfloat16) and in the vocab-parallel CE's.  Step 1 within
# TP_STEP1_TOL of the train phase's step 1, every later step within
# TP_LOSS_BOUND; the planted fault (rank 1 drops layer 0's wo reduce for
# RANKS_PLANTED_STEPS steps) must pass the bound.  On the CPU (this
# script's tp worker with "cuda" replaced by the CPU, drim-bnn at
# d_model 384, 6 heads over 2 KV heads, d_ff 1536, 6 layers, 8 x 256,
# 20 steps) the gaps were 1.17e-3 at step 1 and at most 5.44e-3 over 20
# steps; the planted fault's 0.103 at step 3, 0.192 at step 8.
TP = 2
TP_STEP1_TOL = 1e-2
TP_LOSS_BOUND = 2e-2
TP_TIMEOUT_S = 420
# The serving legs (`tp_serve_argvs`): drim-bnn on the serve phase's
# three routes at full depth, whose tokens must be the same on every
# route and rank; and, held to one process's, drim-bnn cut to 2 layers
# ("gpu") and qwen3-14b at 2 layers (the families phase's leg): tokens
# equal but from a row's first differing token on, where one process's
# top two logits there lie within TP_LOGIT_TOL (a near tie that float
# order may flip), and the prefill's last logits within TP_LOGIT_TOL,
# about four times the largest CPU reading of bfloat16 prefills at full
# width and 2 layers.  At drim-bnn's full depth the BNN's signs amplify
# float order (this phase's worker on the CPU: 12 layers moved them by
# 1.30 against an RMS of 0.28), so there the legs against one process
# are a reading, not a bound.
TP_LOGIT_TOL = 0.1
# The three routes' legs are held only to each other, so they run
# **reduced** from drim-bnn's 12 layers to 6 (PR 33, to make room for the
# audio and serving-mode legs).
TP_ROUTE_LAYERS = 6
# The tp phase's MoE legs, in the same worker after the dense legs (one
# torchrun start, one import, one kernel load; each leg frees its card
# memory before the next): deepseek-v3-671b (MLA) and kimi-k2-1t-a32b
# (GQA, q [4, 32, 256, 128] a rank, n_rep 8) served as the families
# phase serves them (full width cut from 61 layers to 1, FAMILY_BATCH x
# 256 tokens, FAMILY_GEN greedy), every expert (128 / 192 a rank), each
# rank drawing only its blocks; held to the families phase's one-process
# legs (ONE_PROCESS) as qwen3-14b's are; each rank's expert and cache
# bytes 1 / TP of one process's, its flash launches one process's; a
# planted fault (rank 1's expert-parallel partial left out of the sum)
# must move the prefill's last logits past TP_LOGIT_TOL.  Then
# deepseek-v3 trained at the train-families leg's cut (TP_MOE_TRAIN: 1
# layer, 32 experts, 2 x 256, FAMILY_TRAIN_STEPS steps) with that leg's
# Adafactor at its 2e-5, on each rank's blocks (`runtime.steps.
# rank_adafactor_update`: no leaf is gathered whole, so a rank holds its
# 1.75 B float32 params (7.0 GB), their gradients and its factored
# vectors; Adafactor has no in-place update, as the reference's has none,
# so the leg does not donate).  Step 1 (before any update) within
# TP_STEP1_TOL of the train-families leg's step 1, every later step within
# TP_LOSS_BOUND of the same step there (the same optimizer on the same
# data); each rank's param and state bytes its specs' local bytes, its
# peak printed.  Its steps are a RANK_LEGS leg: the dry-run's rank trace
# predicts each rank's collectives and temp.  The worker's time limit
# grows by TP_MOE_TIMEOUT_S for these legs.
TP_MOE_ARCHS = ("deepseek-v3-671b", "kimi-k2-1t-a32b")
TP_MOE_TRAIN = ("deepseek-v3-671b", 1, 32, 2, 256, "adafactor", 2e-5)
TP_MOE_LEG = "deepseek-v3-671b train (1, 2)"
TP_MOE_TIMEOUT_S = 420
# The tp phase's ssm, hybrid and vlm legs, in the same worker after the
# MoE legs.  Served as the families phase serves them (4 rows, FAMILY_GEN
# greedy tokens, each rank drawing its own blocks; arch, depth cut or 0,
# prompt, model axis, float32): mamba2-130m at full depth over 1024
# tokens on the (1, TP) mesh, its params replicated and its sequence cut
# over "model" (512 tokens, two SSD chunks a rank), and again over the
# (TP, 1) data mesh (2 rows a rank), whose tokens must be one process's
# bit for bit; zamba2-1.2b over 512 tokens (its Mamba2 mixer on params
# cut by the reference's specs, its shared block the dense one's) cut to
# 6 of its 38 layers (one group: six mixers and one site of the shared
# block) in bfloat16, and at full depth in float32 with the scan's
# bfloat16 roundings off (`float32_numerics`, in both runs);
# llava-next-34b cut to 2 of its 60 layers over 3072 tokens behind 2880
# zero patches.  Each held to its one-process leg (the families phase's,
# or the tp phase's own where that phase does not serve it) as
# qwen3-14b's is: tokens but for near ties, prefill last logits within
# TP_LOGIT_TOL, or TP_F32_LOGIT_TOL for the float32 leg.  zamba2 at full
# depth is not held in bfloat16: there its 38 layers turn one-ulp changes
# into O(1) logits (on an H100, one process's own prefill moved by 1.27
# when one bfloat16 ulp was added to a seventh of the embedding's
# columns, 0.082 at 6 layers; over (1, 2) the prefill was 0.034 from one
# process's at 6 layers, 0.19 at 12 and 0.50 at 38), while in float32
# with the scan unrounded, where float order cannot flip a rounding, the
# two were 3.2e-4 apart at 38 layers.  TP_F32_LOGIT_TOL is about 15 times
# that; the planted fault (rank 1's out_proj partial of the last mixer,
# layer 38's, left out of the sum in a second prefill: TP_F32_PLANTED)
# must read past it.  Each rank's flash launches one per attention site
# of its prefill (0 / 0 / 1 / 6 / 2) and nothing else; each rank's param
# and decode cache bytes its specs' local bytes (the ssm params whole,
# the SSM states over heads, the conv windows whole:
# `runtime.sharding.rank_cache_pspecs`).  Then each arch trained over
# (1, TP) at its train-families leg (TRAIN_FAMILIES: batch, sequence,
# learning rate; depth as TP_FAMILY_TRAIN gives it) for
# FAMILY_TRAIN_STEPS steps, the same schedule, llava donating its state:
# step 1 within TP_STEP1_TOL of one process's step 1 (the train-families
# leg's, or the tp phase's own one-process leg at the depth given),
# every later step within TP_LOSS_BOUND (on the CPU, the smoke configs'
# 3 CLI steps over (1, 2) and (2, 2) stayed within 1e-3 relative of the
# reference trainer's: tests/test_torch_ssm_ranks.py,
# test_torch_hybrid_ranks.py).  mamba2 trains at 12 of its 24 layers
# (**reduced** for the script's time: 4.0 s a step over (1, 2) at 24
# layers on an H100, mostly gloo), its train-families leg's depth, as
# zamba2's and whisper's are.  llava trains at its
# train-families leg's 2 layers (two ranks reckoned at ~24 GB each,
# donated), zamba2 at
# 6 of its 38 layers (one group, one shared-block site): at full depth
# over (1, 2) it took 9.7 s a step (4.0 GB of gloo
# collectives), and after its first update its trajectory at 3e-4 turns
# ulp-level gradient changes into loss gaps past the bound (AdamW's first
# update is about lr * sign(g)): on an H100 its steps 1-2 were 2.3e-3
# and 3.8e-3 from one process's, step 3 0.062, while one process's own
# full-depth leg moved by 0.015 at step 3 when one float32 ulp was added
# to a seventh of the initial embedding's columns; at 6 layers the gaps
# were 4.0e-4, 9.0e-5 and 2.7e-4.  Flash twice a GQA site a step (remat)
# and each backward kernel once a site (0 / 1 / 2); each rank's param
# and moment bytes its specs'.
#
# The audio family's legs follow in the same lists.  whisper-medium
# (TP_AUDIO) served at its full width and depth (24 encoder and 24
# decoder layers, 1500 zero frames, 256 tokens, as the families phase
# serves it) over (1, TP), its encoder and decoder on the rank's heads
# and its cross cache the rank's heads of every frame, and over the (TP,
# 1) data mesh, both from one whole draw of its weights (an arch served
# by two legs is drawn once); held to the families phase's one-process
# leg as qwen3-14b's is (the data mesh's tokens but for near ties, and
# whether they are bit for bit printed).  Zero frames make the encoder's
# output, and so every cross-attention output, exactly zero, so over
# (1, TP) the prompts are also prefilled over seeded frames
# (TP_AUDIO_FRAMES), held to one process's prefill of them (the families
# phase's, on the same weights) within TP_LOGIT_TOL, and again with
# rank 1's cross-attention `wo` partials left out of the sum at every
# decoder layer (TP_AUDIO_PLANTED), which must read past it (on an H100
# rank 1's partial of the last decoder layer alone moved the logits by
# 0.051, inside the bound).  Then
# whisper trained over (1, TP) at its train-families leg (4 x 256,
# AdamW 3e-4, FAMILY_TRAIN_STEPS steps), cut to 6 encoder and 6 decoder
# layers: at full depth the Megatron sums of the [4, 1500, 1024]
# encoder activations come to about 4-5 GB of gloo traffic a step a
# rank; held to the train-families leg at that depth, as zamba2's
# 6-layer leg is.  Flash once per decoder self-attention site
# of a prefill (24; none in the encoder or the cross-attention), twice a
# site a training step and each backward kernel once (6 sites).
TP_AUDIO = "whisper-medium"
TP_AUDIO_FRAMES = 6                     # the seeded frames' stream
TP_AUDIO_PLANTED = ("rank 1's cross-attention wo partials left out at "
                    "every decoder layer")
TP_FAMILY_SERVE = (("mamba2-130m", 0, 1024, TP, False),
                   ("mamba2-130m", 0, 1024, 1, False),
                   ("zamba2-1.2b", 6, 512, TP, False),
                   ("zamba2-1.2b", 0, 512, TP, True),
                   ("llava-next-34b", 2, 3072, TP, False),
                   (TP_AUDIO, 0, 256, TP, False),
                   (TP_AUDIO, 0, 256, 1, False))
TP_F32_LOGIT_TOL = 5e-3
TP_F32_PLANTED = "rank 1's out_proj partial of the last mixer left out"
TP_FAMILY_TRAIN = (("mamba2-130m", 12), ("zamba2-1.2b", 6),
                   ("llava-next-34b", 2), (TP_AUDIO, 6))
TP_FAMILY_TIMEOUT_S = 480
# The serving modes over ranks, last in the tp worker, on drim-bnn cut
# to 2 layers (the depth the tp phase holds to one process), the serve
# phase's flags: --continuous (its two prompts of 256 and 200 tokens, a
# wave apart, into 2 slots) on "gpu --packed" and "cuda --packed" over
# (1, TP) and on "gpu --packed" over (TP, 1), the
# request tokens held to a one-process continuous run at 2 layers (run
# here first) but for near ties (`batcher_tap`), the two routes' tokens
# over (1, TP) equal; --microbench on "gpu --packed" over (1, TP), every
# stage on every rank with each figure per rank and their maximum;
# --resilient on "cuda --packed" over (1, TP) with a decode fn that fails
# on rank 1 alone from its TP_FAIL_FROM-th call on (`failing_make_fn`,
# after running the step, so the ranks' collectives stay matched): both
# ranks book retry, retry, fallback, switch to "gpu" together, and give
# the tokens of the tp phase's "drim-bnn 2 layers" leg (every route the
# same tokens).  Each rank's launches those of the same leg in one
# process (the resilient one failing there too).
TP_MODES = {
    "continuous gpu packed": (TP, ["--engine", "gpu", "--packed", "--batch",
                                   "2", "--continuous", "2"]),
    "continuous cuda packed": (TP, ["--engine", "cuda", "--packed",
                                    "--batch", "2", "--continuous", "2"]),
    "continuous gpu packed data": (1, ["--engine", "gpu", "--packed",
                                       "--batch", "2", "--continuous", "2"]),
    "microbench gpu packed": (TP, ["--engine", "gpu", "--packed",
                                   "--microbench"]),
    "resilient cuda packed": (TP, ["--engine", "cuda", "--packed",
                                   "--resilient"]),
}
TP_MODE_LAYERS = 2
TP_FAIL_FROM = 3
TP_MODES_TIMEOUT_S = 240
# The uneven-heads legs, last in the tp worker: qwen3-14b's smoke config
# in float32 with 5 query heads over 1 KV head (d_head 32; UNEVEN_CUT,
# cut as `trainer_spy` and `serve_cut` cut a config) over (1, TP), 2.5
# heads a rank: each rank computes the 3 heads its block of 80 of wq's
# 160 columns overlaps (0-2 and 2-4) whole and hands exactly that block
# to the row-parallel wo.  Through the CLI entry points: `train.main`
# (UNEVEN_TRAIN: UNEVEN_STEPS AdamW steps on 4 x 256 seeded tokens,
# block-aligned, so the flash forward and both backward kernels run on
# the rank's 3 heads, n_rep 3) and `serve.run_serve` (UNEVEN_SERVE: a
# 4 x 256 prompt through the flash forward, then decode steps), held to
# the same legs in one process (run in the parent before the worker):
# the losses within UNEVEN_LOSS_TOL, the prefill's last logits within
# UNEVEN_LOGIT_TOL and the tokens equal but for near ties within it;
# both ranks' losses and tokens equal; on each side the launches exact
# and each leg within UNEVEN_WALL_S.  The bounds are float32's: on an
# H100 the rank and one-process logits read 2.98e-7 apart and the losses
# bit for bit.  A planted fault (`planted_uneven_fault`: rank 1 hands wo
# the first 80 of its 96 head columns instead of its block, which starts
# half a head in) must move the prefill's logits past UNEVEN_LOGIT_TOL.
UNEVEN_CUT = {"n_heads": 5, "n_kv_heads": 1, "dtype": "float32"}
UNEVEN_STEPS = 2
UNEVEN_TRAIN = ["--arch", "qwen3-14b", "--smoke-config", "--steps",
                str(UNEVEN_STEPS), "--batch", "4", "--seq", "256", "--mesh",
                "host", "--optimizer", "adamw", "--lr", "3e-4", "--warmup",
                "0", "--log-every", "1", "--seed", str(SEED)]
UNEVEN_SERVE = ["--arch", "qwen3-14b", "--smoke-config", "--batch", "4",
                "--prompt-len", "256", "--gen", "4", "--seed", str(SEED),
                "--temperature", "0"]
UNEVEN_LOGIT_TOL, UNEVEN_LOSS_TOL = 1e-4, 1e-5
UNEVEN_WALL_S = 15.0


def one_process_key(arch: str, layers: int, f32: bool = False) -> str:
    """The ONE_PROCESS key of a serving leg: the arch where the families
    phase serves it at that depth, else "<arch> <layers> layers" (and
    " float32" under `float32_numerics`)."""
    if not f32 and any((a, n) == (arch, layers)
                       for a, n, _, _ in FAMILIES):
        return arch
    return f"{arch} {layers} layers" + (" float32" if f32 else "")


@contextlib.contextmanager
def float32_numerics(on: bool = True):
    """Where `on`, the serve CLI's models in float32 activations with the
    SSD scan's bfloat16 roundings off (`ssm._bf` the identity)."""
    from repro_torch.launch import serve
    from repro_torch.models import ssm
    if not on:
        yield
        return
    build, bf = serve.build_cfg, ssm._bf
    serve.build_cfg = lambda args: build(args).replace(dtype="float32")
    ssm._bf = lambda t: t
    try:
        yield
    finally:
        serve.build_cfg, ssm._bf = build, bf


@contextlib.contextmanager
def planted_mixer_fault(on: bool, at: int):
    """Where `on` (model index 1), the `at`-th Mamba2 mixer call's
    out_proj partial left out of the sum: this rank's rows of y zeroed,
    the all-reduce still run, so the ranks' collectives stay matched."""
    from repro_torch.models import ssm
    inner, calls = ssm._out_proj, [0]

    def out_proj(p, cfg, y, mesh):
        calls[0] += 1
        if on and calls[0] - 1 == at:
            y = torch.zeros_like(y)
        return inner(p, cfg, y, mesh)
    ssm._out_proj = out_proj
    try:
        yield
    finally:
        ssm._out_proj = inner


def tp_serve_argvs():
    """{leg: serve flags} of the tp phase's serving legs."""
    legs = {leg: SERVE + extra + ["--layers", str(TP_ROUTE_LAYERS)]
            for leg, extra in SERVE_LEGS.items()}
    legs["drim-bnn 2 layers"] = SERVE + SERVE_LEGS["gpu dense"] \
        + ["--layers", "2"]
    legs["qwen3-14b"] = family_argv("qwen3-14b", 2, 256)
    return legs


def tp_serve_legs(out: str, ranks, wrappers) -> None:
    """The tp phase's serving legs on this rank (`tp_serve_argvs`)
    through `serve.run_serve --model-axis TP`, each
    with its launch counts, tokens, prefill logits and top-two gaps
    (`tap_values`), decode cache bytes and peak bytes ->
    OUT/rank<r>_serve.pt."""
    from repro_torch.launch import serve
    from repro_torch.tree import tree_leaves
    legs = tp_serve_argvs()
    res = {}
    splice = serve.splice_rank_caches
    for leg, argv in legs.items():
        args = serve.parse_args(argv + ["--model-axis", str(TP)])
        caches = []

        def spy(*a, **kw):
            caches.append(splice(*a, **kw))
            return caches[-1]
        for fn in wrappers.values():
            fn.launches = 0
        reset_peak()
        serve.splice_rank_caches = spy
        t0 = time.perf_counter()
        try:
            with logits_tap() as tap:
                gen, stats = serve.run_serve(args)
        finally:
            serve.splice_rank_caches = splice
        torch.cuda.synchronize()
        res[leg] = {"gen": gen, "stats": stats, **tap_values(tap),
                    "wall_s": time.perf_counter() - t0,
                    "launches": {n: fn.launches
                                 for n, fn in wrappers.items()},
                    "cache_bytes": sum(t.numel() * t.element_size()
                                       for t in tree_leaves(caches[0])),
                    "peak_gb": peak_bytes() / 1e9}
        del caches
        torch.cuda.empty_cache()
    torch.save(res, os.path.join(out, f"rank{ranks.rank}_serve.pt"))


def tp_bytes_check(r) -> dict:
    """A tp rank's param and moment bytes: its specs' local bytes, and
    half of one process's for every cut leaf (the replicated leaves
    whole: the norms' scales; a moment is float32 like its param)."""
    rep = r["replicated_param_bytes"]
    got = {"param_bytes": r["param_bytes"],
           "param_bytes_of_specs": r["param_bytes_of_specs"],
           "param_bytes_one_process": r["param_bytes_one_process"],
           "moment_bytes": r["moment_bytes"],
           "moment_bytes_of_specs": r["moment_bytes_of_specs"],
           "moment_bytes_one_process": r["moment_bytes_one_process"],
           "replicated_param_bytes": rep}
    if not (r["param_bytes"] == r["param_bytes_of_specs"]
            and TP * (r["param_bytes"] - rep)
            == r["param_bytes_one_process"] - rep
            and r["moment_bytes"] == r["moment_bytes_of_specs"]
            and TP * (r["moment_bytes"] - 2 * rep)
            == r["moment_bytes_one_process"] - 2 * rep):
        raise AssertionError(f"tp: rank {r['rank']}'s bytes {got}")
    return got


def by_axis(coll, steps: int):
    """A leg's collective calls, GB and seconds a step by axis."""
    return {axis: {"calls": coll.get(f"calls:{axis}", 0) / steps,
                   "gb": coll.get(f"bytes:{axis}", 0) / 1e9 / steps,
                   "s": coll.get(f"seconds:{axis}", 0.0) / steps}
            for axis in ("data", "model", "data+model")
            if coll.get(f"calls:{axis}", 0)}


def by_kind(coll, steps: int):
    """A leg's collective calls, GB and seconds a step by kind
    (`COLLECTIVE_STATS`' "calls/<kind>": all-reduce, all-gather,
    reduce-scatter, broadcast)."""
    return {key[len("calls/"):]: {
        "calls": n / steps,
        "gb": coll.get("bytes" + key[len("calls"):], 0) / 1e9 / steps,
        "s": coll.get("seconds" + key[len("calls"):], 0.0) / steps}
        for key, n in coll.items() if key.startswith("calls/") and n}


def first_difference_ok(leg: str, got, want, gaps,
                        tol: float = TP_LOGIT_TOL) -> list:
    """Tokens [B, gen] equal to one process's, but that a row may differ
    from its first differing token on, where one process's top two
    logits there lie within `tol`; returns the differing (row, token,
    gap)s."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise AssertionError(f"tp {leg}: tokens {got.shape} vs "
                             f"{want.shape}")
    ties = []
    for b in range(got.shape[0]):
        differ = np.nonzero(got[b] != want[b])[0]
        if len(differ):
            t = int(differ[0])
            gap = float(gaps[b, t])
            if gap > tol:
                raise AssertionError(
                    f"tp {leg}: row {b} token {t} is {got[b, t]}, one "
                    f"process {want[b, t]} (top-two gap {gap})")
            ties.append((b, t, gap))
    return ties


def phase_tp(wrappers):
    """The train phase's run and the serve phase's legs over a model axis
    of TP gloo ranks on the one card (`ranks_worker` and `tp_serve_legs`
    under torchrun, the (1, TP) mesh), held to the one-process runs:
    step 1 within TP_STEP1_TOL, every later step within TP_LOSS_BOUND,
    the planted fault past it; each rank's flash launches 24 / 12 / 12 a
    step (q [8, 6, 256, 64], n_rep 3); each rank's param and moment bytes
    its specs' (half of one process's for every cut leaf); the 5 + 5
    restart bitwise the straight 10 steps; the TP-rank checkpoint
    restored here (one process) equal to each rank's blocks; the serving
    legs (`check_tp_serving`; first the one-process drim-bnn cut to 2
    layers here); the MoE legs (`check_tp_moe`); the ssm, hybrid and vlm
    legs (`check_tp_families`; first their one-process legs that the
    families and train-families phases do not run, here); the serving
    modes (`check_tp_modes`) and the uneven-heads legs (`check_tp_uneven`;
    first their one-process legs, here).  Then NCCL at (1,
    min(4, cards)) where 2 or more cards show.  Returns the ranks'
    launches (straight, restart, serving and MoE legs, summed)."""
    from repro_torch.checkpoint.checkpoint import Checkpointer
    from repro_torch.core.mesh import local_block
    from repro_torch.launch import serve, train
    from repro_torch.optim import get_optimizer
    from repro_torch.runtime import steps
    one = TRAINED["losses"]
    args = train.parse_args(TRAIN)
    t_phase = time.perf_counter()
    cut = serve.parse_args(tp_serve_argvs()["drim-bnn 2 layers"])
    with logits_tap() as tap:
        gen, _ = serve.run_serve(cut)
    ONE_PROCESS["drim-bnn 2 layers"] = {"gen": gen, **tap_values(tap)}
    torch.cuda.empty_cache()
    for arch, layers, prompt, _, f32 in TP_FAMILY_SERVE:
        key = one_process_key(arch, layers, f32)
        if key not in ONE_PROCESS:
            with float32_numerics(f32), logits_tap() as tap:
                gen, _ = serve.run_serve(serve.parse_args(
                    family_argv(arch, layers, prompt)))
            ONE_PROCESS[key] = {"gen": gen, **tap_values(tap)}
            torch.cuda.empty_cache()
    for arch, layers in TP_FAMILY_TRAIN:
        if layers and trained_key(arch, layers) not in TRAINED:
            argv, cut = family_train_argv(arch)
            cut.update(depth_cut(arch, layers))
            with deterministic(), trainer_spy(train, **cut) as seen, \
                    contextlib.redirect_stdout(io.StringIO()):
                train.main(argv)
            TRAINED[trained_key(arch, layers)] = list(seen["losses"])
            del seen
            torch.cuda.empty_cache()
    one_uneven = uneven_legs(wrappers)
    torch.cuda.empty_cache()
    one_modes = {}
    for leg in TP_MODES:
        argv, _ = mode_argv(leg)
        same = next((m for m in one_modes if mode_argv(m)[0] == argv), None)
        one_modes[leg] = (one_modes[same] if same is not None
                          else run_mode(leg, wrappers))
    one_process_s = time.perf_counter() - t_phase
    with tempfile.TemporaryDirectory(prefix="drim_tp_") as tmp:
        rc, out, err, wall = torchrun(TP, ["--tp-worker", tmp, "gloo"],
                                      TP_TIMEOUT_S + TP_MOE_TIMEOUT_S
                                      + TP_FAMILY_TIMEOUT_S
                                      + TP_MODES_TIMEOUT_S)
        if rc != 0:
            raise AssertionError(f"tp: torchrun exited {rc}:\n"
                                 f"{out[-2000:]}\n{err[-4000:]}")
        legs = {leg: [json.load(open(f"{tmp}/rank{r}_{leg}.json"))
                      for r in range(TP)]
                for leg in ("straight", "restart", "planted")}
        straight = check_rank_leg(legs["straight"], "tp straight",
                                  TRAIN_STEPS)
        resumed = check_rank_leg(legs["restart"], "tp restart",
                                 TRAIN_STEPS - RESTART_AT)
        planted = check_rank_leg(legs["planted"], "tp planted",
                                 RANKS_PLANTED_STEPS)
        gaps, planted_gaps = loss_gaps(straight, one), loss_gaps(planted,
                                                                 one)
        recs = legs["straight"]
        MEASURED_RANK_LEGS["drim-bnn train (1, 2)"] = [
            r["step_collectives"] for r in recs]
        MEASURED_RANK_MEMORY["drim-bnn train (1, 2)"] = [
            r["step_temp_b"] for r in recs]
        lines = [line for line in recs[0]["lines"] if "step" in line]
        s_step = (lines[-1]["wall_s"] - lines[0]["wall_s"]) \
            / (TRAIN_STEPS - 1)
        print("tp " + json.dumps({
            "backend": recs[0]["backend"], "mesh": {"data": 1, "model": TP},
            "devices": [r["device"] for r in recs], "steps": TRAIN_STEPS,
            "s_per_step": s_step,
            "global_tokens_per_s": args.batch * args.seq / s_step,
            "first_step_s": lines[0]["wall_s"],
            "losses": straight, "one_process_losses": one,
            "loss_gaps": gaps, "step1_tol": TP_STEP1_TOL,
            "loss_bound": TP_LOSS_BOUND, "torchrun_wall_s": wall,
            "leg_wall_s": {leg: [r["wall_s"] for r in legs[leg]]
                           for leg in legs}}))
        for r in recs:
            coll = r["collective"]
            print("tp " + json.dumps({
                "rank": r["rank"], "device": r["device"],
                "peak_gb": r["peak_gb"],
                "collective_calls_per_step": coll["calls"] / TRAIN_STEPS,
                "collective_gb_per_step": coll["bytes"] / 1e9 / TRAIN_STEPS,
                "collective_s_per_step": (coll["seconds"]
                                          - r["checkpoint_gather_s"])
                / TRAIN_STEPS,
                "by_axis_per_step": by_axis(coll, TRAIN_STEPS),
                "by_kind_per_step": by_kind(coll, TRAIN_STEPS),
                "checkpoint_gather_s": r["checkpoint_gather_s"],
                **tp_bytes_check(r)}))
        if gaps[0] > TP_STEP1_TOL or max(gaps[1:]) > TP_LOSS_BOUND:
            raise AssertionError(f"tp: losses {straight} against one "
                                 f"process's {one}")
        if max(planted_gaps) <= TP_LOSS_BOUND:
            raise AssertionError(f"tp: the planted fault stayed inside the "
                                 f"bound: {planted_gaps}")
        print("tp " + json.dumps({
            "planted": "rank 1 drops layer 0's wo reduce",
            "steps": RANKS_PLANTED_STEPS, "loss_gaps": planted_gaps,
            "over_the_bound": True}))
        if resumed != straight[RESTART_AT:]:
            raise AssertionError(f"tp: the restart's losses {resumed}")
        step_dir = f"step_{TRAIN_STEPS:09d}"
        for name in os.listdir(f"{tmp}/straight/{step_dir}"):
            a = open(f"{tmp}/straight/{step_dir}/{name}", "rb").read()
            b = open(f"{tmp}/resumed/{step_dir}/{name}", "rb").read()
            if a != b:
                raise AssertionError(f"tp: the restart's {name} differs")
        cfg = train.build_cfg(args)
        like = steps.abstract_train_state(cfg, get_optimizer("adamw"))
        whole = Checkpointer(f"{tmp}/straight").restore(TRAIN_STEPS, like,
                                                        device="cpu")
        here = rank_mesh_here((1, TP))
        specs = steps.state_pspecs(cfg, get_optimizer("adamw"), here)[0]
        cut = dict(zip((p for p, _ in flat_leaves(whole)),
                       (sp for _, sp in flat_leaves(specs))))
        for r in recs:
            differ = [p for p, t in flat_leaves(whole)
                      if sha_of(t[local_block(tuple(t.shape), cut[p], here,
                                              r["rank"])])
                      != r["hashes"][p]]
            if differ or len(r["hashes"]) != len(cut):
                raise AssertionError(f"tp: rank {r['rank']}'s state "
                                     f"differs from the checkpoint in "
                                     f"{differ[:3]}")
        print("tp " + json.dumps({
            "restart": f"{RESTART_AT} + checkpoint + "
                       f"{TRAIN_STEPS - RESTART_AT} steps over a model "
                       f"axis of {TP}", "bit_identical_to_straight_run": True,
            "checkpoint_leaves": len(cut),
            "restored_in_one_process_equals_each_rank": True}))
        served = [torch.load(f"{tmp}/rank{r}_serve.pt", weights_only=False)
                  for r in range(TP)]
        serve_counts = check_tp_serving(served)
        moe_counts = check_tp_moe(tmp, TP)
        family_counts = check_tp_families(tmp, TP)
        mode_counts = check_tp_modes(tmp, TP, one_modes,
                                     served[0]["drim-bnn 2 layers"]["gen"])
        uneven_counts = check_tp_uneven(tmp, TP, one_uneven)
        phase_tp_nccl(tmp, one)
    counts = {n: sum(r["launches"][n] for leg in ("straight", "restart")
                     for r in legs[leg]) + serve_counts[n] + moe_counts[n]
              + family_counts[n] + mode_counts[n] + uneven_counts[n]
              for n in wrappers}
    print("tp " + json.dumps({"phase_wall_s":
                              time.perf_counter() - t_phase,
                              "one_process_legs_s": one_process_s,
                              "torchrun_wall_s": wall}))
    print("counts " + json.dumps({"phase": "tp", **counts}))
    return counts


def uneven_cfg():
    from repro_torch.configs import get_smoke_config
    return get_smoke_config("qwen3-14b").replace(**UNEVEN_CUT)


def uneven_expected(cfg):
    """The training leg's launches (UNEVEN_STEPS steps: the flash forward
    twice a layer under remat, each backward kernel once a layer)."""
    sites = cfg.n_layers * UNEVEN_STEPS
    return {"flash_attn_fwd": (2 if cfg.remat else 1) * sites,
            "flash_bwd_dkv": sites, "flash_bwd_dq": sites}


@contextlib.contextmanager
def serve_cut(**cut):
    """The serve CLI's config cut (`ModelConfig.replace(**cut)`), as
    `trainer_spy` cuts the trainer's."""
    from repro_torch.launch import serve
    build = serve.build_cfg
    serve.build_cfg = lambda args: build(args).replace(**cut)
    try:
        yield
    finally:
        serve.build_cfg = build


@contextlib.contextmanager
def planted_uneven_fault(on: bool):
    """Where `on` (model index 1), `_out` hands the row-parallel wo the
    first columns of the rank's heads, not its block of them, which
    starts inside the head it shares with its neighbour: the wrong
    columns of a shared head, the all-reduce still run."""
    from repro_torch.core.mesh import model_coord, model_ranks
    from repro_torch.models import attention
    out_fn = attention._out

    def shifted(p, cfg, out):
        mesh = model_ranks()
        lo = attention.head_columns(cfg, *model_coord(mesh))[0]
        at = lo - attention._rank_heads(cfg, mesh)[0] * cfg.d_head
        return out_fn(p, cfg, torch.roll(out, at, -1))
    if on:
        attention._out = shifted
    try:
        yield
    finally:
        attention._out = out_fn


def uneven_legs(wrappers, model_axis: int = 1) -> dict:
    """The uneven-heads legs (UNEVEN_CUT) through the CLI entry points,
    in one process or (`model_axis` > 1) as this rank of the tp worker:
    `train.main` (UNEVEN_TRAIN; its losses) and `serve.run_serve`
    (UNEVEN_SERVE; its tokens, prefill logits and top-two gaps), each
    with its launches (zeroed just before) and wall s.  Over ranks, after
    the serving leg, untimed: its prefill again under
    `planted_uneven_fault` ("planted")."""
    from repro_torch.core import mesh as core_mesh
    from repro_torch.launch import serve, train
    axis = ["--model-axis", str(model_axis)] if model_axis > 1 else []
    res = {}
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with deterministic(), trainer_spy(train, **UNEVEN_CUT) as seen, \
            contextlib.redirect_stdout(io.StringIO()):
        train.main(UNEVEN_TRAIN + axis)
    torch.cuda.synchronize()
    res["train"] = {"losses": seen["losses"],
                    "launches": {n: fn.launches
                                 for n, fn in wrappers.items()},
                    "wall_s": time.perf_counter() - t0}
    del seen
    inner, used = serve.prefill, []

    def spy_prefill(*a, **kw):
        used.append((a, kw, core_mesh.model_ranks()))
        return inner(*a, **kw)
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    serve.prefill = spy_prefill
    try:
        with serve_cut(**UNEVEN_CUT), logits_tap() as tap:
            gen, _ = serve.run_serve(serve.parse_args(UNEVEN_SERVE + axis))
    finally:
        serve.prefill = inner
    torch.cuda.synchronize()
    res["serve"] = {"gen": gen, **tap_values(tap),
                    "launches": {n: fn.launches
                                 for n, fn in wrappers.items()},
                    "wall_s": time.perf_counter() - t0}
    if model_axis > 1:
        a, kw, mesh = used[0]
        on = core_mesh.model_coord(mesh)[0] == 1
        with mesh, planted_uneven_fault(on):
            res["planted"] = inner(*a, **kw)[0][:, -1].float().cpu()
    return res


def check_tp_uneven(tmp: str, n: int, one: dict) -> dict:
    """The uneven-heads legs of the tp worker's n ranks (OUT/rank<r>_
    uneven.pt) against `one` (the same legs in one process): on every
    side the launches exact and each leg within UNEVEN_WALL_S; the ranks'
    losses and tokens equal; the losses within UNEVEN_LOSS_TOL of one
    process's, the prefill's last logits within UNEVEN_LOGIT_TOL, the
    tokens but for ties within it; the planted prefill past it.  Prints a
    "tp" line; returns the launches of every side, summed."""
    from repro_torch.launch import serve
    cfg = uneven_cfg()
    args = serve.parse_args(UNEVEN_SERVE)
    recs = [torch.load(f"{tmp}/rank{r}_uneven.pt", weights_only=False)
            for r in range(n)]
    want = {"train": uneven_expected(cfg),
            "serve": serve_launches(cfg, args)}
    for side, rec in [("one process", one)] + [
            (f"rank {r}", rec) for r, rec in enumerate(recs)]:
        for leg in ("train", "serve"):
            got = rec[leg]["launches"]
            if got != {k: want[leg].get(k, 0) for k in got}:
                raise AssertionError(f"tp uneven heads {side} {leg}: "
                                     f"launches {got}, expected "
                                     f"{want[leg]}")
            if rec[leg]["wall_s"] > UNEVEN_WALL_S:
                raise AssertionError(f"tp uneven heads {side} {leg}: "
                                     f"{rec[leg]['wall_s']} s, over "
                                     f"{UNEVEN_WALL_S}")
    losses = [r["train"]["losses"] for r in recs]
    if any(x != losses[0] for x in losses) or any(
            not np.array_equal(r["serve"]["gen"], recs[0]["serve"]["gen"])
            for r in recs):
        raise AssertionError(f"tp uneven heads: the ranks' losses or "
                             f"tokens differ: {losses}")
    ties = first_difference_ok("uneven heads", recs[0]["serve"]["gen"],
                               one["serve"]["gen"], one["serve"]["gaps"],
                               UNEVEN_LOGIT_TOL)
    err = max(float((r["serve"]["prefill"] - one["serve"]["prefill"])
                    .abs().max()) for r in recs)
    planted = max(float((r["planted"] - one["serve"]["prefill"])
                        .abs().max()) for r in recs)
    gaps = loss_gaps(losses[0], one["train"]["losses"])
    print("tp " + json.dumps({
        "uneven_heads": f"qwen3-14b smoke float32, {cfg.n_heads} heads over "
                        f"{cfg.n_kv_heads} KV head over (1, {n})",
        "train": {"batch": 4, "seq": 256, "steps": UNEVEN_STEPS,
                  "losses": losses[0],
                  "one_process_losses": one["train"]["losses"],
                  "loss_gaps": gaps, "loss_tol": UNEVEN_LOSS_TOL},
        "serve": {"tokens_equal": not ties, "ties": ties,
                  "prefill_logits_max_abs_diff": err,
                  "planted_max_abs_diff": planted,
                  "logit_tol": UNEVEN_LOGIT_TOL},
        "launches_a_side": want,
        "wall_s": {leg: {"one_process": one[leg]["wall_s"],
                         "ranks": [r[leg]["wall_s"] for r in recs]}
                   for leg in ("train", "serve")}}))
    if err > UNEVEN_LOGIT_TOL or max(gaps) > UNEVEN_LOSS_TOL:
        raise AssertionError(f"tp uneven heads: logits {err}, loss gaps "
                             f"{gaps}")
    if planted <= UNEVEN_LOGIT_TOL:
        raise AssertionError(f"tp uneven heads: the planted fault stayed "
                             f"inside the bound: {planted}")
    return {k: sum(r[leg]["launches"][k] for r in recs + [one]
                   for leg in ("train", "serve"))
            for k in one["train"]["launches"]}


def tp_launches(cfg, args):
    """A tp serving leg's launches on each rank: its one-process leg's
    (`serve_launches`; qwen3-14b's the flash forward once a layer)."""
    if cfg.arch == "drim-bnn":
        return serve_launches(cfg, args)
    return {"flash_attn_fwd": cfg.n_layers}


def check_tp_serving(served) -> dict:
    """The tp serving legs of every rank: the same tokens on every rank;
    drim-bnn's three routes (TP_ROUTE_LAYERS layers) the same tokens as
    its "gpu dense" leg; drim-bnn at 2 layers and qwen3-14b held to one
    process's (ONE_PROCESS, `first_difference_ok`, the
    prefill logits within TP_LOGIT_TOL); each rank's decode cache bytes
    1 / TP of one process's and its launches the one-process leg's.
    Returns the launches summed over the legs and ranks."""
    from repro_torch.launch import serve
    from repro_torch.models import abstract_caches
    from repro_torch.tree import tree_leaves
    total = {}
    for leg, argv in tp_serve_argvs().items():
        args = serve.parse_args(argv)
        cfg = serve.build_cfg(args)
        one_cache = sum(t.numel() * t.element_size() for t in tree_leaves(
            abstract_caches(cfg, args.batch, args.prompt_len + args.gen)))
        launches = tp_launches(cfg, args)
        first = served[0][leg]
        launches = {n: launches.get(n, 0) for n in first["launches"]}
        for r, res in enumerate(served):
            got = res[leg]
            if got["launches"] != launches:
                raise AssertionError(f"tp {leg} rank {r}: launches "
                                     f"{got['launches']}, expected "
                                     f"{launches}")
            if TP * got["cache_bytes"] != one_cache:
                raise AssertionError(f"tp {leg} rank {r}: cache bytes "
                                     f"{got['cache_bytes']} of {one_cache}")
            if not np.array_equal(got["gen"], first["gen"]):
                raise AssertionError(f"tp {leg}: rank {r}'s tokens differ")
        held = leg not in SERVE_LEGS
        stats = first["stats"]
        line = {"serve": leg, "held_to_one_process": held,
                "layers": cfg.n_layers}
        if held:
            want = ONE_PROCESS[leg]
            err = float((first["prefill"] - want["prefill"]).abs().max())
            ties = first_difference_ok(leg, first["gen"], want["gen"],
                                       want["gaps"])
            if err > TP_LOGIT_TOL:
                raise AssertionError(f"tp {leg}: prefill logits {err} from "
                                     "one process's")
            line.update(
                tokens_equal_one_process=int(np.sum(
                    np.asarray(first["gen"]) == np.asarray(want["gen"]))),
                tokens=int(np.asarray(want["gen"]).size),
                prefill_logits_max_abs_diff=err,
                one_process_logits_rms=float(
                    want["prefill"].pow(2).mean().sqrt()))
        elif not np.array_equal(first["gen"],
                                served[0]["gpu dense"]["gen"]):
            raise AssertionError(f"tp {leg}: tokens differ from gpu dense")
        line.update({
            "cache_bytes_per_rank": [r[leg]["cache_bytes"] for r in served],
            "cache_bytes_one_process": one_cache,
            "peak_gb_per_rank": [r[leg]["peak_gb"] for r in served],
            "prefill_s": stats["prefill_s"],
            "compile_s": stats["compile_s"],
            "decode_tok_per_s": stats["decode_tok_per_s"],
            "decode_p50_ms": stats["decode_p50_ms"],
            "launches_per_rank": {n: c for n, c in launches.items() if c},
            "leg_wall_s": first["wall_s"],
            "sample_ids": stats["sample_ids"]})
        if held:
            line.update(near_ties=ties, logit_tol=TP_LOGIT_TOL)
        print("tp " + json.dumps(line))
        for n, c in launches.items():
            total[n] = total.get(n, 0) + c * TP
    return total


def phase_tp_nccl(tmp: str, one) -> None:
    """With 2 or more cards, the tp straight run over NCCL at (1, min(4,
    cards)), a card a rank, held to the same bounds; with one card a
    line."""
    cards = torch.cuda.device_count()
    if cards < 2:
        print("tp " + json.dumps({
            "nccl": f"did not run: {cards} card visible, NCCL needs a card "
                    "a rank"}))
        return
    n = min(4, cards)
    rc, out, err, wall = torchrun(n, ["--tp-worker", f"{tmp}/nccl", "nccl",
                                      str(n)], TP_TIMEOUT_S
                                  + TP_MOE_TIMEOUT_S)
    if rc != 0:
        raise AssertionError(f"tp nccl: torchrun exited {rc}:\n"
                             f"{err[-4000:]}")
    recs = [json.load(open(f"{tmp}/nccl/rank{r}_straight.json"))
            for r in range(n)]
    losses = check_rank_leg(recs, "tp nccl", TRAIN_STEPS)
    gaps = loss_gaps(losses, one)
    print("tp " + json.dumps({
        "backend": recs[0]["backend"], "mesh": {"data": 1, "model": n},
        "devices": [r["device"] for r in recs], "loss_gaps": gaps,
        "peak_gb_per_rank": [r["peak_gb"] for r in recs],
        "torchrun_wall_s": wall}))
    if recs[0]["backend"] != "nccl" or gaps[0] > TP_STEP1_TOL \
            or max(gaps[1:]) > TP_LOSS_BOUND:
        raise AssertionError(f"tp nccl: {recs[0]['backend']}, {gaps}")
    check_tp_moe(f"{tmp}/nccl", n, label="tp nccl")


def check_tp_moe(tmp: str, n: int, label: str = "tp") -> dict:
    """The MoE legs of the tp worker's n ranks (OUT/rank<r>_moe.pt).
    Serving (`tp_moe_serve_legs`): the same tokens on every rank, held to
    the families phase's one-process legs (ONE_PROCESS,
    `first_difference_ok`, the prefill's last logits within
    TP_LOGIT_TOL); each rank's expert and decode cache bytes 1 / n of one
    process's; its launches one process's (flash once per GQA layer of
    the prefill); the planted fault's leg failing those bounds (its
    prefill logits past TP_LOGIT_TOL, or its tokens apart where one
    process's top two logits are no near tie).
    Training, where the worker ran it (`tp_moe_train_leg`): no launches
    (MLA), both ranks' losses equal, step 1 within TP_STEP1_TOL of the
    train-families leg's step 1 and every later step within
    TP_LOSS_BOUND of its, the losses finite and falling; each rank's
    param and moment bytes its specs' local bytes; each rank's steps'
    collectives and temps kept as the TP_MOE_LEG leg's measurements
    (MEASURED_RANK_LEGS, MEASURED_RANK_MEMORY).  Prints the "tp" lines;
    returns the launches summed over the legs and ranks."""
    from repro_torch.launch import serve
    from repro_torch.models import abstract_caches, abstract_params
    from repro_torch.tree import tree_leaves
    recs = [torch.load(f"{tmp}/rank{r}_moe.pt", weights_only=False)
            for r in range(n)]

    def nbytes(leaves):
        return sum(t.numel() * t.element_size() for t in leaves)
    total = {}
    for arch in TP_MOE_ARCHS:
        args = serve.parse_args(family_argv(arch, 1, 256))
        cfg = serve.build_cfg(args)
        one_cache = nbytes(tree_leaves(abstract_caches(
            cfg, args.batch, args.prompt_len + args.gen)))
        bank = abstract_params(cfg)["layers"]["moe"]
        one_expert = nbytes(bank[k] for k in ("gate", "up", "down"))
        first = recs[0]["serve"][arch]
        launches = {name: 0 for name in first["launches"]}
        launches["flash_attn_fwd"] = attention_sites(cfg)
        for r, rec in enumerate(recs):
            got = rec["serve"][arch]
            if got["launches"] != launches:
                raise AssertionError(f"{label} {arch} rank {r}: launches "
                                     f"{got['launches']}, expected "
                                     f"{launches}")
            if n * got["cache_bytes"] != one_cache \
                    or n * got["expert_bytes"] != one_expert:
                raise AssertionError(
                    f"{label} {arch} rank {r}: cache bytes "
                    f"{got['cache_bytes']} of {one_cache}, expert bytes "
                    f"{got['expert_bytes']} of {one_expert}")
            if not np.array_equal(got["gen"], first["gen"]):
                raise AssertionError(f"{label} {arch}: rank {r}'s tokens "
                                     "differ")
        want = ONE_PROCESS[arch]
        ties = first_difference_ok(f"{label} {arch}", first["gen"],
                                   want["gen"], want["gaps"])
        err = float((first["prefill"] - want["prefill"]).abs().max())
        if err > TP_LOGIT_TOL:
            raise AssertionError(f"{label} {arch}: prefill logits {err} "
                                 "from one process's")
        planted = float((first["planted_prefill"]
                         - want["prefill"]).abs().max())
        try:
            first_difference_ok(f"{label} {arch} planted",
                                first["planted_gen"], want["gen"],
                                want["gaps"])
            tokens_held = True
        except AssertionError:
            tokens_held = False
        if planted <= TP_LOGIT_TOL and tokens_held:
            raise AssertionError(f"{label} {arch}: the planted EP fault "
                                 f"stayed inside the bound ({planted})")
        stats = first["stats"]
        print(f"{label} " + json.dumps({
            "serve": arch, "mesh": {"data": 1, "model": n},
            "layers": cfg.n_layers, "experts": cfg.n_experts,
            "experts_per_rank": cfg.n_experts // n,
            "tokens_equal_one_process": int(np.sum(
                np.asarray(first["gen"]) == np.asarray(want["gen"]))),
            "tokens": int(np.asarray(want["gen"]).size),
            "near_ties": ties, "prefill_logits_max_abs_diff": err,
            "logit_tol": TP_LOGIT_TOL,
            "one_process_logits_rms": float(
                want["prefill"].pow(2).mean().sqrt()),
            "planted": "rank 1's EP partial left out of the sum",
            "planted_prefill_max_abs_diff": planted,
            "planted_tokens_held": tokens_held,
            "expert_bytes_per_rank": [r["serve"][arch]["expert_bytes"]
                                      for r in recs],
            "expert_bytes_one_process": one_expert,
            "cache_bytes_per_rank": [r["serve"][arch]["cache_bytes"]
                                     for r in recs],
            "cache_bytes_one_process": one_cache,
            "peak_gb_per_rank": [r["serve"][arch]["peak_gb"] for r in recs],
            "leg_wall_s": [r["serve"][arch]["wall_s"] for r in recs],
            "prefill_s": stats["prefill_s"],
            "compile_s": stats["compile_s"],
            "decode_tok_per_s": stats["decode_tok_per_s"],
            "decode_p50_ms": stats["decode_p50_ms"],
            "launches_per_rank": {k: c for k, c in launches.items() if c},
            "sample_ids": stats["sample_ids"]}))
        for name, c in launches.items():
            total[name] = total.get(name, 0) + c * n
    if "train" not in recs[0]:
        return total
    arch = TP_MOE_TRAIN[0]
    train_recs = [rec["train"] for rec in recs]
    for r in train_recs:
        if any(r["launches"].values()):
            raise AssertionError(f"{label} train {arch} rank {r['rank']}: "
                                 f"launches {r['launches']}")
    losses = train_recs[0]["losses"]
    if any(r["losses"] != losses for r in train_recs):
        raise AssertionError(f"{label} train {arch}: the ranks' losses "
                             "differ")
    one = TRAINED[arch]
    gaps = loss_gaps(losses, one)
    if len(losses) != FAMILY_TRAIN_STEPS or not np.all(np.isfinite(losses)) \
            or not losses[-1] < losses[0] or gaps[0] > TP_STEP1_TOL \
            or max(gaps[1:]) > TP_LOSS_BOUND:
        raise AssertionError(f"{label} train {arch}: losses {losses}, the "
                             f"train-families leg's {one}")
    MEASURED_RANK_LEGS[TP_MOE_LEG] = [r["step_collectives"]
                                      for r in train_recs]
    MEASURED_RANK_MEMORY[TP_MOE_LEG] = [r["step_temp_b"] for r in train_recs]
    lines = [line for line in train_recs[0]["lines"] if "step" in line]
    s_step = (lines[-1]["wall_s"] - lines[0]["wall_s"]) / (len(lines) - 1)
    _, _, _, batch, seq, opt, lr = TP_MOE_TRAIN
    print(f"{label} " + json.dumps({
        "train": arch, "mesh": {"data": 1, "model": n}, "layers": 1,
        "experts": TP_MOE_TRAIN[2], "optimizer": opt, "lr": lr,
        "batch": batch, "seq": seq, "losses": losses,
        "train_families_losses": one, "loss_gaps": gaps,
        "step1_tol": TP_STEP1_TOL, "loss_bound": TP_LOSS_BOUND,
        "s_per_step": s_step,
        "tokens_per_s": batch * seq / s_step,
        "first_step_s": lines[0]["wall_s"]}))
    for r in train_recs:
        coll = r["collective"]
        steps = len(losses)
        got = {"param_bytes": r["param_bytes"],
               "param_bytes_of_specs": r["param_bytes_of_specs"],
               "param_bytes_one_process": r["param_bytes_one_process"],
               "moment_bytes": r["moment_bytes"],
               "moment_bytes_of_specs": r["moment_bytes_of_specs"],
               "moment_bytes_one_process": r["moment_bytes_one_process"]}
        print(f"{label} " + json.dumps({
            "train": arch, "rank": r["rank"], "peak_gb": r["peak_gb"],
            "collective_calls_per_step": coll["calls"] / steps,
            "collective_gb_per_step": coll["bytes"] / 1e9 / steps,
            "collective_s_per_step": coll["seconds"] / steps,
            "by_axis_per_step": by_axis(coll, steps),
            "by_kind_per_step": by_kind(coll, steps), **got}))
        if r["param_bytes"] != r["param_bytes_of_specs"] \
                or r["moment_bytes"] != r["moment_bytes_of_specs"]:
            raise AssertionError(f"{label} train {arch} rank {r['rank']}: "
                                 f"bytes {got}")
    return total


def rank_mesh_here(shape):
    """A (data, model) mesh of ranks of `shape` over CPU stand-ins, built
    here without a process group (for `local_block` of any rank)."""
    from repro_torch.core.mesh import make_named_mesh
    n = int(np.prod(shape))
    return dataclasses.replace(
        make_named_mesh(tuple(shape), ("data", "model"),
                        [torch.device("cpu")] * n),
        ranks=np.arange(n).reshape(shape))


def local_bytes_of(whole, specs, mesh, rank: int) -> int:
    """The bytes of `rank`'s blocks of a tree of whole (meta) leaves under
    `specs`."""
    from repro_torch.core.mesh import local_shape
    from repro_torch.tree import tree_leaves
    return int(sum(np.prod(local_shape(tuple(t.shape), sp, mesh, rank))
                   * t.element_size() for t, sp in
                   zip(tree_leaves(whole), tree_leaves(specs))))


def check_tp_families(tmp: str, n: int) -> dict:
    """The ssm, hybrid and vlm legs of the tp worker's n ranks
    (OUT/rank<r>_families.pt).  Serving (`tp_family_serve_legs`): the
    same tokens on every rank; over a model axis held to the one-process
    legs (ONE_PROCESS at `one_process_key`, `first_difference_ok`, the
    prefill's last logits within TP_LOGIT_TOL, or TP_F32_LOGIT_TOL for
    a float32 leg, whose planted prefill must read past it), over the
    data mesh one process's tokens bit for bit; each rank's launches one
    per attention site of the prefill; its param and decode cache bytes
    its specs' local bytes (`param_pspecs` of the family,
    `rank_cache_pspecs`).  Training (`tp_family_train_legs`): both ranks'
    losses equal and finite, step 1 within TP_STEP1_TOL of one process's
    (TRAINED at `trained_key`), later steps within TP_LOSS_BOUND; each
    rank's flash launches twice a GQA site a step and each backward
    kernel once; its param and moment bytes its specs'.  Prints the "tp"
    lines; returns the launches summed over the legs and ranks."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import abstract_caches, abstract_params
    from repro_torch.runtime.sharding import param_pspecs, rank_cache_pspecs
    from repro_torch.tree import tree_leaves
    recs = [torch.load(f"{tmp}/rank{r}_families.pt", weights_only=False)
            for r in range(n)]

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))
    total = {}
    for arch, layers, prompt, k, f32 in TP_FAMILY_SERVE:
        leg = (arch, layers, k, f32)
        label = (f"tp {arch} {layers or 'all'} layers ({n // k}, {k})"
                 + (" float32" if f32 else ""))
        args = serve.parse_args(family_argv(arch, layers, prompt))
        with float32_numerics(f32):
            cfg = serve.build_cfg(args)
        here = rank_mesh_here((n // k, k))
        caches = abstract_caches(cfg, args.batch, args.prompt_len + args.gen)
        params = abstract_params(cfg)
        cache_specs = rank_cache_pspecs(here, caches)
        param_specs = param_pspecs(params, here, cfg.family)
        first = recs[0]["serve"][leg]
        launches = {name: 0 for name in first["launches"]}
        launches["flash_attn_fwd"] = attention_sites(cfg)
        for r, rec in enumerate(recs):
            got = rec["serve"][leg]
            want_bytes = (local_bytes_of(params, param_specs, here, r),
                          local_bytes_of(caches, cache_specs, here, r))
            if got["launches"] != launches:
                raise AssertionError(f"{label} rank {r}: launches "
                                     f"{got['launches']}, expected "
                                     f"{launches}")
            if (got["param_bytes"], got["cache_bytes"]) != want_bytes:
                raise AssertionError(
                    f"{label} rank {r}: param and cache bytes "
                    f"{got['param_bytes']}, {got['cache_bytes']}, the "
                    f"specs' {want_bytes}")
            if not np.array_equal(got["gen"], first["gen"]):
                raise AssertionError(f"{label}: rank {r}'s tokens differ")
        want = ONE_PROCESS[one_process_key(arch, layers, f32)]
        err = float((first["prefill"] - want["prefill"]).abs().max())
        tol = TP_F32_LOGIT_TOL if f32 else TP_LOGIT_TOL
        ties, planted = [], {}
        bitwise = bool(np.array_equal(first["gen"], want["gen"]))
        if k == 1 and cfg.family != "audio":
            if not bitwise:
                raise AssertionError(f"{label}: tokens {first['gen']}, one "
                                     f"process {want['gen']}")
        else:
            ties = first_difference_ok(label, first["gen"], want["gen"],
                                       want["gaps"], tol)
            if err > tol:
                raise AssertionError(f"{label}: prefill logits {err} from "
                                     "one process's")
        if first["planted_prefill"] is not None:
            base = want["prefill"]
            if cfg.family == "audio":
                base = ONE_PROCESS[f"{arch} seeded frames"]["prefill"]
                clean = float((first["frames_prefill"] - base).abs().max())
                if clean > tol:
                    raise AssertionError(f"{label}: the seeded frames' "
                                         f"prefill logits {clean} from one "
                                         "process's")
                planted["frames_prefill_max_abs_diff"] = clean
            moved = float((first["planted_prefill"] - base).abs().max())
            if moved <= tol:
                raise AssertionError(f"{label}: the planted fault stayed "
                                     f"inside the bound: {moved}")
            planted.update(planted=TP_F32_PLANTED if f32
                           else TP_AUDIO_PLANTED,
                           planted_prefill_max_abs_diff=moved)
        stats = first["stats"]
        decode_calls = FAMILY_GEN
        if (arch, k) == (TP_AUDIO, TP):
            MEASURED_RANK_LEGS["whisper-medium decode (1, 2)"] = [
                rec["serve"][leg]["decode_collectives"] for rec in recs]
            MEASURED_RANK_MEMORY["whisper-medium decode (1, 2)"] = [
                rec["serve"][leg]["decode_temp_b"] for rec in recs]
        per_rank = []
        for r, rec in enumerate(recs):
            got = rec["serve"][leg]
            coll, pre = got["collective"], got["prefill_collective"]
            dec = {key: v - pre.get(key, 0) for key, v in coll.items()}
            per_rank.append({
                "rank": r, "peak_gb": got["peak_gb"],
                "param_bytes": got["param_bytes"],
                "cache_bytes": got["cache_bytes"],
                "prefill_collective": {
                    "calls": pre.get("calls", 0),
                    "gb": pre.get("bytes", 0) / 1e9,
                    "s": pre.get("seconds", 0.0),
                    "by_kind": by_kind(pre, 1)},
                "decode_collective_per_step": by_axis(dec, decode_calls),
                "leg_wall_s": got["wall_s"]})
        print("tp " + json.dumps({
            "serve": arch, "family": cfg.family,
            "mesh": {"data": n // k, "model": k}, "layers": cfg.n_layers,
            "published_layers": get_config(arch).n_layers,
            "prompt": prompt, "batch": args.batch, "gen": args.gen,
            "float32_scan_unrounded": f32,
            "tokens_equal_one_process": int(np.sum(
                np.asarray(first["gen"]) == np.asarray(want["gen"]))),
            "tokens": int(np.asarray(want["gen"]).size),
            "tokens_bit_for_bit": bitwise,
            "near_ties": ties, "prefill_logits_max_abs_diff": err,
            "logit_tol": tol, **planted,
            "one_process_logits_rms": float(
                want["prefill"][want["prefill"] > -1e29].pow(2).mean()
                .sqrt()),
            "param_bytes_one_process": nbytes(params),
            "cache_bytes_one_process": nbytes(caches),
            "prefill_s": stats["prefill_s"],
            "compile_s": stats["compile_s"],
            "decode_tok_per_s": stats["decode_tok_per_s"],
            "decode_p50_ms": stats["decode_p50_ms"],
            "launches_per_rank": {key: c for key, c in launches.items()
                                  if c},
            "per_rank": per_rank, "sample_ids": stats["sample_ids"]}))
        for name, c in launches.items():
            total[name] = total.get(name, 0) + c * n
    for arch, layers in TP_FAMILY_TRAIN:
        label = f"tp train {arch}"
        _, _, _, batch, seq, opt, lr = next(
            leg for leg in TRAIN_FAMILIES if leg[0] == arch)
        cfg = get_config(arch).replace(**{**family_train_argv(arch)[1],
                                          **depth_cut(arch, layers)})
        sites = attention_sites(cfg)
        steps = FAMILY_TRAIN_STEPS
        launches = {name: 0 for name in recs[0]["train"][arch]["launches"]}
        if sites:
            launches.update(flash_attn_fwd=(2 if cfg.remat else 1) * sites
                            * steps, flash_bwd_dkv=sites * steps,
                            flash_bwd_dq=sites * steps)
        train_recs = [rec["train"][arch] for rec in recs]
        losses = train_recs[0]["losses"]
        for r in train_recs:
            if r["launches"] != launches:
                raise AssertionError(f"{label} rank {r['rank']}: launches "
                                     f"{r['launches']}, expected "
                                     f"{launches}")
            if r["losses"] != losses:
                raise AssertionError(f"{label}: the ranks' losses differ")
            if r["param_bytes"] != r["param_bytes_of_specs"] \
                    or r["moment_bytes"] != r["moment_bytes_of_specs"]:
                raise AssertionError(f"{label} rank {r['rank']}: param "
                                     f"and moment bytes not the specs'")
        one = TRAINED[trained_key(arch, layers)]
        gaps = loss_gaps(losses, one)
        if len(losses) != steps or not np.all(np.isfinite(losses)) \
                or gaps[0] > TP_STEP1_TOL or max(gaps[1:]) > TP_LOSS_BOUND:
            raise AssertionError(f"{label}: losses {losses}, the "
                                 f"train-families leg's {one}")
        lines = [line for line in train_recs[0]["lines"] if "step" in line]
        s_step = (lines[-1]["wall_s"] - lines[0]["wall_s"]) \
            / (len(lines) - 1)
        print("tp " + json.dumps({
            "train": arch, "family": cfg.family,
            "mesh": {"data": 1, "model": n}, "layers": cfg.n_layers,
            "optimizer": opt, "lr": lr, "batch": batch, "seq": seq,
            "donate": arch == "llava-next-34b", "losses": losses,
            "one_process_losses": one, "loss_gaps": gaps,
            "step1_tol": TP_STEP1_TOL, "loss_bound": TP_LOSS_BOUND,
            "s_per_step": s_step, "tokens_per_s": batch * seq / s_step,
            "first_step_s": lines[0]["wall_s"],
            "flash_launches_per_rank": {key: c for key, c in
                                        launches.items() if c}}))
        for r in train_recs:
            coll = r["collective"]
            print("tp " + json.dumps({
                "train": arch, "rank": r["rank"], "peak_gb": r["peak_gb"],
                "leg_wall_s": r["wall_s"],
                "collective_calls_per_step": coll["calls"] / steps,
                "collective_gb_per_step": coll["bytes"] / 1e9 / steps,
                "collective_s_per_step": coll["seconds"] / steps,
                "by_axis_per_step": by_axis(coll, steps),
                "by_kind_per_step": by_kind(coll, steps),
                **{key: r[key] for key in (
                    "param_bytes", "param_bytes_of_specs",
                    "param_bytes_one_process", "moment_bytes",
                    "moment_bytes_of_specs", "moment_bytes_one_process",
                    "replicated_param_bytes")}}))
        for name, c in launches.items():
            total[name] = total.get(name, 0) + c * n
    return total


def check_tp_modes(tmp: str, n: int, one: dict, static_gen) -> dict:
    """The serving-mode legs of the tp worker's n ranks
    (OUT/rank<r>_modes.pt) against their one-process runs (`one`, by
    leg): each rank's launches one process's; --continuous the same
    request tokens on every rank, one process's but for near ties
    (`first_difference_ok` on the requests' rows, TP_LOGIT_TOL), the two
    routes over (1, TP) equal; --microbench every stage on every rank,
    each figure per rank in rank order and its maximum; --resilient the
    same retry, retry, fallback incidents on every rank but for their
    `error` and `t_s`, "gpu" serving at the end, and `static_gen`'s
    tokens (the tp "drim-bnn 2 layers" leg's).  Prints the "tp" lines;
    returns the launches summed over the legs and ranks."""
    recs = [torch.load(f"{tmp}/rank{r}_modes.pt", weights_only=False)
            for r in range(n)]
    total, tokens = {}, {}
    for leg, (k, _) in TP_MODES.items():
        label = f"tp {leg} ({n // k}, {k})"
        want = one[leg]
        for r, rec in enumerate(recs):
            if rec[leg]["launches"] != want["launches"]:
                raise AssertionError(f"{label} rank {r}: launches "
                                     f"{rec[leg]['launches']}, one "
                                     f"process {want['launches']}")
        first = recs[0][leg]
        line = {"mode": leg, "mesh": {"data": n // k, "model": k},
                "layers": TP_MODE_LAYERS,
                "wall_s_per_rank": [rec[leg]["wall_s"] for rec in recs],
                "one_process_wall_s": want["wall_s"],
                "peak_gb_per_rank": [rec[leg]["peak_gb"] for rec in recs],
                "collective_per_rank": [{
                    "calls": rec[leg]["collective"].get("calls", 0),
                    "gb": rec[leg]["collective"].get("bytes", 0) / 1e9,
                    "s": rec[leg]["collective"].get("seconds", 0.0)}
                    for rec in recs],
                "launches_per_rank": {key: c for key, c in
                                      want["launches"].items() if c}}
        if leg.startswith("continuous"):
            res, stats = first["out"]
            for r, rec in enumerate(recs):
                got = rec[leg]["out"][0]
                if sorted(got) != sorted(res) or any(
                        not np.array_equal(got[q], res[q]) for q in res):
                    raise AssertionError(f"{label}: rank {r}'s tokens "
                                         "differ")
            rids = sorted(want["out"][0])
            got = np.stack([res[q] for q in rids])
            ref = np.stack([want["out"][0][q] for q in rids])
            gaps = np.array([want["gaps"][q] for q in rids])
            ties = first_difference_ok(label, got, ref, gaps)
            tokens[leg] = got
            line.update(tokens_equal_one_process=int(np.sum(got == ref)),
                        tokens=int(ref.size),
                        tokens_bit_for_bit=bool(np.array_equal(got, ref)),
                        near_ties=ties, logit_tol=TP_LOGIT_TOL,
                        n_waves=stats["n_waves"],
                        tok_per_s=stats["tok_per_s"],
                        one_process_tok_per_s=want["out"][1]["tok_per_s"])
        elif leg.startswith("microbench"):
            split = {}
            for r, rec in enumerate(recs):
                stages = rec[leg]["out"][1]["microbench"]
                if set(stages) != {"prefill", "insert", "generate"}:
                    raise AssertionError(f"{label} rank {r}: stages "
                                         f"{sorted(stages)}")
                for stage, fig in stages.items():
                    for key, every in fig["per_rank"].items():
                        if len(every) != n or every[r] != fig[key] \
                                or fig["max"][key] != max(every):
                            raise AssertionError(f"{label} rank {r}: "
                                                 f"{stage} {key} {fig}")
                split = stages
            line.update(microbench=split,
                        one_process=want["out"][1]["microbench"])
        else:
            books = []
            for r, rec in enumerate(recs):
                gen, stats = rec[leg]["out"]
                kinds = [i["action_kind"] for i in stats["incidents"]]
                if kinds != ["retry", "retry", "fallback"] \
                        or stats["engine"] != "gpu":
                    raise AssertionError(f"{label} rank {r}: incidents "
                                         f"{kinds}, engine "
                                         f"{stats['engine']}")
                if not np.array_equal(gen, static_gen):
                    raise AssertionError(f"{label} rank {r}: tokens "
                                         f"{gen.tolist()}, the run with no "
                                         f"failure {static_gen.tolist()}")
                books.append([{key: v for key, v in i.items()
                               if key not in ("error", "t_s")}
                              for i in stats["incidents"]])
            if any(b != books[0] for b in books):
                raise AssertionError(f"{label}: the ranks' incidents "
                                     f"differ: {books}")
            stats = first["out"][1]
            line.update(incidents=[{key: i[key] for key in (
                "action_kind", "engine", "attempt", "failed_ranks",
                "error")} for i in stats["incidents"]],
                errors_per_rank=[[i["error"] for i in rec[leg]["out"][1]
                                  ["incidents"]] for rec in recs],
                failure_flag_per_rank=[rec[leg]["out"][1]["failure_flag"]
                                       for rec in recs],
                decode_tok_per_s=stats["decode_tok_per_s"],
                tokens_equal_run_with_no_failure=True)
        print("tp " + json.dumps(line))
        for name, c in want["launches"].items():
            total[name] = total.get(name, 0) + c * n
    if not np.array_equal(tokens["continuous gpu packed"],
                          tokens["continuous cuda packed"]):
        raise AssertionError("tp continuous: the routes' tokens differ")
    return total


# whether `device_kernels`' sums agreed with `key_averages` on its first
# call (empty before it)
KEY_AVERAGES_CHECKED: list = []


def device_kernels(prof, n: int):
    """(name, device ms, launches) per call of each CUDA kernel a
    `torch.profiler` run over `n` calls recorded: `key_averages()`'s
    figures for its CUDA events, summed here from the profiler's raw
    device events alone (the name rewritten and filtered as
    `key_averages` does, an event's device time its duration), since
    `key_averages` builds an event object for every CPU op as well (the
    train-families phase's two profiled steps of 10,000-17,000 launches
    took 21-37 s a leg with it on the card's host, PR 33 run 2).  The
    first call runs both and keeps `key_averages` for every call unless
    the two agree (`KEY_AVERAGES_CHECKED`, a "profile" line); where the
    torch build lacks the helpers, `key_averages` alone."""
    def averaged():
        return [(e.key, e.self_device_time_total / 1e3 / n, e.count / n)
                for e in prof.key_averages()
                if e.self_device_time_total > 0
                and e.device_type.name == "CUDA"]
    try:
        from torch.autograd import DeviceType
        from torch.autograd.profiler_util import _filter_name, _rewrite_name
        events = prof.profiler.kineto_results.events()
    except (ImportError, AttributeError):
        return averaged()
    us, count = {}, {}
    for ev in events:
        if ev.device_type() != DeviceType.CUDA or _filter_name(ev.name()) \
                or getattr(ev, "is_hidden_event", lambda: False)() \
                or ev.is_async() \
                or ev.start_thread_id() != ev.end_thread_id():
            continue
        key = _rewrite_name(name=ev.name(), with_wildcard=True)
        us[key] = us.get(key, 0.0) + (ev.end_ns() - ev.start_ns()) / 1e3
        count[key] = count.get(key, 0) + 1
    got = [(key, t / 1e3 / n, count[key] / n) for key, t in us.items()
           if t > 0]
    if not KEY_AVERAGES_CHECKED:
        want = averaged()
        mine, theirs = ({key: (ms, c) for key, ms, c in kernels}
                        for kernels in (got, want))
        same = mine.keys() == theirs.keys() and all(
            mine[k][1] == theirs[k][1]
            and abs(mine[k][0] - theirs[k][0]) <= 1e-6 * max(theirs[k][0], 1)
            for k in theirs)
        KEY_AVERAGES_CHECKED.append(same)
        print("profile " + json.dumps({
            "device_kernels_equal_key_averages": same,
            "kernels": len(theirs)}))
        return want
    return got if KEY_AVERAGES_CHECKED[0] else averaged()


def profile_train_steps(step_fn, state, batches, arch: str = "drim-bnn",
                        tag: str = "train") -> dict:
    """Where a training step's time goes: a step per batch under
    `torch.profiler`, the device time of each kernel summed by kind (the
    flash kernels, GEMMs, the rest), the kernel launches per step, and the
    device's idle share of the host-clock wall time (a `tag` line);
    returns the line."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = len(batches)
    kernels = device_kernels(prof, n)
    busy = sum(ms for _, ms, _ in kernels)

    def kind(name: str) -> str:
        low = name.lower()
        if "flash" in low and ("bwd" in low or "fwd" in low):
            return "flash kernels (port)"
        if "gemm" in low or "xmma" in low or "cutlass" in low \
                or "nvjet" in low:
            return "gemm (cuBLAS)"
        return "other"
    by_kind = {}
    for name, ms, _ in kernels:
        by_kind[kind(name)] = by_kind.get(kind(name), 0.0) + ms
    top = sorted(kernels, key=lambda k: -k[1])[:10]
    line = {"arch": arch, "profile_steps": n,
            "wall_ms_per_step": wall * 1e3 / n,
            "device_busy_ms_per_step": busy,
            "device_idle_share": (1 - busy / (wall * 1e3 / n)) if busy
            else None,
            "device_launches_per_step": sum(c for _, _, c in kernels),
            "device_ms_per_step_by_kind": by_kind,
            "top_kernels_ms_per_step": [[name[:80], ms, cnt]
                                        for name, ms, cnt in top]}
    print(f"{tag} " + json.dumps(line))
    return line


@contextlib.contextmanager
def deterministic():
    """`torch.use_deterministic_algorithms(True)`, without its filling of
    every new tensor with NaN (a check for reads of uninitialized memory
    that costs a kernel per allocation and does not change which results
    repeat), so that s/step is the step's."""
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill


# The allocator's peak before the last reset `measured_temp` made: a leg
# whose steps are measured one by one reads its own peak as the most of
# these and the peak since (`peak_bytes`).
HELD_PEAK = [0]


def reset_peak() -> None:
    """Start a leg's peak (`peak_bytes`) afresh."""
    HELD_PEAK[0] = 0
    torch.cuda.reset_peak_memory_stats()


def peak_bytes() -> int:
    """The most bytes allocated on the card since `reset_peak`."""
    return max(HELD_PEAK[0], torch.cuda.max_memory_allocated())


def measured_temp(run):
    """(run(), the bytes it held on the card on top of what was allocated
    just before it: `max_memory_allocated()` over the call less
    `memory_allocated()` before it, the allocator's counterpart of the
    dry-run's mem_temp_b)."""
    HELD_PEAK[0] = peak_bytes()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = run()
    return out, torch.cuda.max_memory_allocated() - before


@contextlib.contextmanager
def trainer_spy(train, **cut):
    """`train.main` with its config cut (`ModelConfig.replace(**cut)`:
    depth, experts) and its step recorded: yields a dict that holds, once
    main returns, the step function, the config, the last state and
    batch the trainer stepped, every step's loss unrounded ("losses"),
    every step's rank collectives (`collective_since`:
    "step_collectives") and every step's bytes on top of what it was
    handed (`measured_temp`: "step_temp_b")."""
    from repro_torch.core import mesh as core_mesh
    build_cfg, build = train.build_cfg, train.build
    seen = {}

    def cut_cfg(args):
        cfg = build_cfg(args)
        return cfg.replace(**cut) if cut else cfg

    def spy_build(args, mesh=None):
        cfg, step_fn, init_state = build(args, mesh)

        def step(state, batch):
            before = dict(core_mesh.COLLECTIVE_STATS)
            (new, metrics), temp = measured_temp(
                lambda: step_fn(state, batch))
            seen["step_collectives"].append(collective_since(before))
            seen["step_temp_b"].append(temp)
            seen.update(state=new, batch=batch)
            seen["losses"].append(float(metrics["loss"]))
            return new, metrics
        seen.update(step_fn=step_fn, cfg=cfg, losses=[],
                    step_collectives=[], step_temp_b=[])
        return cfg, step, init_state
    train.build_cfg, train.build = cut_cfg, spy_build
    try:
        yield seen
    finally:
        train.build_cfg, train.build = build_cfg, build


def repeat_step(step_fn, state, batch):
    """One step from `state` run twice: (loss, whether the two losses and
    every new parameter are bitwise equal, the first run's bytes on top of
    what it was handed: `measured_temp`).  The first run's parameters
    wait on the host, so the card holds one new state at a time."""
    (new, metrics), temp = measured_temp(lambda: step_fn(state, batch))
    loss = metrics["loss"].cpu()
    first = [(p, t.cpu()) for p, t in flat_leaves(new["params"])]
    del new, metrics
    new, metrics = step_fn(state, batch)
    same = torch.equal(loss, metrics["loss"].cpu()) and all(
        torch.equal(a, b.cpu()) for (_, a), (_, b) in
        zip(first, flat_leaves(new["params"])))
    return float(loss), same, temp


def phase_train_families(wrappers):
    """One arch of each remaining family trained at its published width
    through the trainer's CLI entry point (`launch.train.main`, `--mesh
    host`), under deterministic algorithms (TRAIN_FAMILIES): finite
    losses falling from the first step to the last, s/step, tokens/s,
    peak GB; each step the flash forward twice per GQA site (remat) and
    each backward kernel once, nothing else; then a step from the final
    state run twice, bitwise the same, and FAMILY_PROFILE_STEPS steps
    under `torch.profiler` (launches a step, the idle share).  Returns
    the launch counts of the legs."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train
    dev = torch.device("cuda")
    counts = {}
    t_phase = time.perf_counter()
    with deterministic():
        for arch, _, _, batch, seq, opt, lr in TRAIN_FAMILIES:
            argv, cut = family_train_argv(arch)
            cfg = get_config(arch).replace(**cut)
            sites = attention_sites(cfg)
            per_step = ({"flash_attn_fwd": (2 if cfg.remat else 1) * sites,
                         "flash_bwd_dkv": sites, "flash_bwd_dq": sites}
                        if sites else {})
            torch.cuda.empty_cache()
            reset_peak()
            leg = f"train families {arch}"
            with trainer_spy(train, **cut) as seen:
                def run(argv=argv):
                    text = io.StringIO()
                    t0 = time.perf_counter()
                    with contextlib.redirect_stdout(text):
                        final = train.main(argv)
                    return final, time.perf_counter() - t0, [
                        json.loads(line) for line in
                        text.getvalue().splitlines()]
                (final, main_s, lines), counts[leg] = counted(
                    wrappers, leg, run,
                    lambda _, n=FAMILY_TRAIN_STEPS, ps=per_step:
                        {k: v * n for k, v in ps.items()})
            peak = peak_bytes() / 1e9
            TRAINED[arch] = list(seen["losses"])
            steps = [line for line in lines if "step" in line]
            losses = [line["loss"] for line in steps]
            if len(steps) != FAMILY_TRAIN_STEPS \
                    or not np.all(np.isfinite(losses)) \
                    or not np.isfinite(final):
                raise AssertionError(f"{leg}: bad losses {losses} {final}")
            if not final < losses[0]:
                raise AssertionError(f"{leg}: the loss did not fall "
                                     f"({losses[0]} -> {final})")
            if seen["cfg"] != cfg:
                raise AssertionError(f"{leg}: trained {seen['cfg']}")
            s_step = (steps[-1]["wall_s"] - steps[0]["wall_s"]) \
                / (FAMILY_TRAIN_STEPS - 1)
            # the final state, held here alone, so that the profiled
            # steps can drop it after their first step (the card holds
            # two of llava's states, not three)
            step_fn, held = seen.pop("step_fn"), [seen.pop("state")]
            data = SyntheticLM(cfg.vocab_size, seq, batch, seed=SEED)
            nxt = train.batch_at(data, cfg, FAMILY_TRAIN_STEPS, SEED, dev)
            t0 = time.perf_counter()
            (loss, same, temp), counts[leg + " repeat"] = counted(
                wrappers, leg + " repeat",
                lambda: repeat_step(step_fn, held[0], nxt),
                lambda _, ps=per_step: {k: 2 * v for k, v in ps.items()})
            repeat_s = time.perf_counter() - t0
            if not same:
                raise AssertionError(f"{leg}: a step repeated from the same "
                                     "state differs")
            if arch in HOST_MEMORY_LEGS:
                MEASURED_HOST_LEGS[arch] = {
                    "warm_temp_b": temp, "steps_temp_b": seen["step_temp_b"]}
            batches = [train.batch_at(data, cfg, FAMILY_TRAIN_STEPS + 1 + i,
                                      SEED, dev)
                       for i in range(FAMILY_PROFILE_STEPS)]
            t0 = time.perf_counter()
            prof = profile_train_steps(step_fn, held.pop(), batches,
                                       arch=arch, tag="train families")
            profile_s = time.perf_counter() - t0
            print("train families " + json.dumps({
                "leg": arch, "family": cfg.family, "layers": cfg.n_layers,
                "published_layers": get_config(arch).n_layers,
                "encoder_layers": cfg.encoder_layers,
                "experts": cfg.n_experts,
                "published_experts": get_config(arch).n_experts,
                "d_model": cfg.d_model, "params": cfg.param_count(),
                "optimizer": opt, "lr": lr, "remat": cfg.remat,
                "batch": batch,
                "seq": seq, "steps": FAMILY_TRAIN_STEPS,
                "main_s": main_s, "first_step_s": steps[0]["wall_s"],
                "s_per_step": s_step, "tokens_per_s": batch * seq / s_step,
                "first_loss": losses[0], "last_loss": final,
                "losses": losses,
                "grad_norm": [line["grad_norm"] for line in steps],
                "peak_mem_gb": peak, "flash_sites": sites,
                "flash_launches_per_step": per_step,
                "repeat_loss": loss, "repeat_bitwise_equal": True,
                "repeat_s": repeat_s, "profile_s": profile_s,
                "device_launches_per_step":
                    prof["device_launches_per_step"],
                "device_idle_share": prof["device_idle_share"]}))
            del seen, step_fn, nxt, batches
            torch.cuda.empty_cache()
    print("train families " + json.dumps({
        "phase_wall_s": time.perf_counter() - t_phase}))
    return counts


def train_step_grads(cfg, batch, dev: str):
    """(loss, [(path, gradient on the CPU)]) of `train_loss` at the seeded
    weights on `dev`."""
    from repro_torch.models import init_params, train_loss
    from repro_torch.tree import tree_map
    params = tree_map(lambda t: t.requires_grad_(True),
                      init_params(SEED, cfg, device=dev))
    leaves = flat_leaves(params)
    loss, _ = train_loss(params, cfg, {k: v.to(dev)
                                       for k, v in batch.items()})
    grads = torch.autograd.grad(loss, [t for _, t in leaves])
    return float(loss.detach()), [(p, g.cpu()) for (p, _), g in
                                  zip(leaves, grads)]


def grad_rel_l2(got, want):
    """(whole-gradient relative L2, worst leaf's relative L2, its path)."""
    num = sum(float(((a - b) ** 2).sum()) for (_, a), (_, b) in
              zip(got, want))
    den = sum(float((b ** 2).sum()) for _, b in want)
    leaf = [(float((a - b).norm() / b.norm().clamp_min(1e-30)), p)
            for (p, a), (_, b) in zip(got, want)]
    worst, path = max(leaf)
    return (num / den) ** 0.5, worst, path


def check_train_reference():
    """The float32 smoke configs' first-step loss and gradients on the
    card (flash forward and backward kernels at S=128) against the same
    step on the CPU (dense scores), same seeded weights and batch:
    drim-bnn's loss within TRAIN_LOSS_RTOL and whole gradient within
    TRAIN_GRAD_RTOL in relative L2; each family's arch (TRAIN_REF_TOL) its
    loss within 1e-5 and its whole gradient and every leaf within its
    bound.  The card's step must run the flash backward once per GQA
    site, and the card's gradient with its largest leaf zeroed must fail
    each bound."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention
    bounds = {"drim-bnn": (TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, None)}
    bounds.update({arch: (1e-5, tol, tol)
                   for arch, tol in TRAIN_REF_TOL.items()})
    for arch, (loss_rtol, grad_rtol, leaf_rtol) in bounds.items():
        cfg = get_smoke_config(arch).replace(dtype="float32",
                                             param_dtype="float32")
        rng = np.random.default_rng([SEED, 4])
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 129)))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.family == "audio":
            batch["frames"] = torch.from_numpy(rng.standard_normal(
                (2, cfg.n_frames, cfg.d_model), dtype=np.float32))
        if cfg.family == "vlm":
            batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
                (2, cfg.n_patches, cfg.d_model), dtype=np.float32))
        before = flash_attention.flash_bwd_dq.launches
        l_card, g_card = train_step_grads(cfg, batch, "cuda")
        ran = flash_attention.flash_bwd_dq.launches - before
        if ran != attention_sites(cfg):
            raise AssertionError(f"{arch}: the card's step ran the flash "
                                 f"backward {ran} times, not "
                                 f"{attention_sites(cfg)}")
        l_cpu, g_cpu = train_step_grads(cfg, batch, "cpu")

        def holds(grads):
            rel, worst, _ = grad_rel_l2(grads, g_cpu)
            return (np.isfinite(l_card)
                    and abs(l_card - l_cpu) <= loss_rtol * abs(l_cpu)
                    and rel <= grad_rtol
                    and (leaf_rtol is None or worst <= leaf_rtol))
        rel, worst, path = grad_rel_l2(g_card, g_cpu)
        big = max(range(len(g_card)), key=lambda i: float(g_card[i][1]
                                                          .norm()))
        planted = list(g_card)
        planted[big] = (planted[big][0], torch.zeros_like(planted[big][1]))
        p_rel, p_worst, _ = grad_rel_l2(planted, g_cpu)
        line = {"arch": arch, "family": cfg.family, "loss_card": l_card,
                "loss_cpu": l_cpu, "loss_rtol": loss_rtol,
                "grad_rel_l2": rel, "worst_leaf_rel_l2": worst,
                "worst_leaf": path, "grad_rtol": grad_rtol,
                "leaf_rtol": leaf_rtol, "flash_bwd_sites": ran,
                "planted_zeroed_leaf": planted[big][0],
                "planted_grad_rel_l2": p_rel,
                "planted_worst_leaf_rel_l2": p_worst}
        print("train " + json.dumps(line))
        if not holds(g_card):
            raise AssertionError(f"{arch}: the card's train step differs "
                                 f"from the CPU's: {line}")
        if holds(planted):
            raise AssertionError(f"{arch}: a zeroed gradient leaf passes "
                                 f"the bound: {line}")


# The dry-run's rank trace of the legs the ranks and tp phases run over
# 2 gloo ranks (leg: kind, mesh shape), predicted on the host
# (`predict_rank_legs`) and held equal, calls and payload bytes by axis,
# to every step each rank measured (MEASURED_RANK_LEGS, filled by those
# phases: the train steps from `trainer_spy`, whisper's decode steps
# from `tp_family_serve_legs`, the warm-up step among them).  TP_MOE_LEG
# is the tp phase's deepseek-v3 training leg (Adafactor on each rank's
# blocks).
RANK_LEGS = {"drim-bnn train (1, 2)": ("train", (1, 2)),
             "drim-bnn train (2, 1)": ("train", (2, 1)),
             **{leg: ("train", (2, 1)) for leg in RANKS_OPT_LEGS},
             "whisper-medium decode (1, 2)": ("decode", (1, 2)),
             TP_MOE_LEG: ("train", (1, TP))}
MEASURED_RANK_LEGS: dict = {}
# The same legs' bytes a step on top of what the step was handed, each
# rank's steps (`measured_temp` in `trainer_spy` and in the tp phase's
# decode calls), held to the trace's mem_temp_b (`check_memory_legs`).
MEASURED_RANK_MEMORY: dict = {}
# The train families legs whose warm repeated step (`repeat_step`) is
# held to the dry-run's one-process trace (`launch.dryrun.host_trace`):
# llava (2 layers, AdamW) and deepseek-v3 (1 layer, 32 experts,
# adafactor), the widest steps the card runs.
HOST_MEMORY_LEGS = ("llava-next-34b", "deepseek-v3-671b")
MEASURED_HOST_LEGS: dict = {}
# The bound, fixed before the first card run: the predicted temp within
# 10 % of the measured, or within 256 MiB where the measured temp is
# under 2.5 GiB.
MEMORY_RTOL, MEMORY_ATOL_B, MEMORY_SMALL_B = 0.10, 256 * 2**20, 2.5 * 2**30
# The planted prediction that must fail the bound: llava's step with
# `--donate` (AdamW in place, one state where the card's leg holds two).
# The dense-scores prediction cannot serve: every leg's peak falls in the
# optimizer's update, after the backward has freed the scores, so the
# meta trace with `attention_impl="xla"` gives each leg's flash temp to
# the byte (43,013,309,440 bytes for llava).
MEMORY_PLANT = ("llava-next-34b", "its step traced with --donate: AdamW "
                "in place, one state where the leg holds two")


def memory_holds(predicted: int, measured: int) -> bool:
    """The predicted temp within the bound of the measured."""
    gap = abs(predicted - measured)
    return gap <= MEMORY_RTOL * measured or (
        measured < MEMORY_SMALL_B and gap <= MEMORY_ATOL_B)


def predict_rank_legs(out: str) -> None:
    """`launch.dryrun.rank_trace` of each RANK_LEGS leg as each of its
    ranks, on meta tensors: drim-bnn's TRAIN run, the ranks phase's
    optimizer legs (`ranks_opt_argv`, cut to RANKS_OPT_LAYERS, with their
    optimizer and --compress) and the tp phase's MoE
    training leg (`tp_moe_train_argv`, the config cut as TP_MOE_TRAIN
    cuts it: its config, global batch and optimizer as `launch.train`
    builds them) and one decode step of the tp phase's whisper-medium
    leg (`family_argv`, its caches of prompt + gen positions); then
    `launch.dryrun.host_trace` of each HOST_MEMORY_LEGS leg (its
    TRAIN_FAMILIES row: the config cut, the trainer's batch of step 0 as
    meta tensors, the optimizer) and of the planted MEMORY_PLANT -> OUT,
    {leg: [each rank's fields], "host": {arch: fields}, "planted":
    fields}."""
    import math
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import dryrun, serve, train
    res = {}
    for leg, (kind, shape) in RANK_LEGS.items():
        axis = ["--model-axis", str(shape[1])]
        compress = False
        if kind == "train":
            moe = leg == TP_MOE_LEG
            args = train.parse_args(
                tp_moe_train_argv() if moe else ranks_opt_argv(leg) + axis
                if leg in RANKS_OPT_LEGS else TRAIN + axis)
            cfg, opt = train.build_cfg(args), args.optimizer
            compress = args.compress
            if moe:
                cfg = cfg.replace(n_layers=TP_MOE_TRAIN[1],
                                  n_experts=TP_MOE_TRAIN[2])
            if leg in RANKS_OPT_LEGS:
                cfg = cfg.replace(n_layers=RANKS_OPT_LAYERS)
            rows, width, ctx = args.batch, args.seq, 0
        else:
            args = serve.parse_args(family_argv(TP_AUDIO, 0, 256) + axis)
            cfg, opt = serve.build_cfg(args), "adamw"
            rows, width = args.batch, 1
            ctx = args.ctx or args.prompt_len + args.gen
        names = ("tokens", "labels") if kind == "train" else ("tokens",)
        batch = {k: torch.empty((rows, width), dtype=torch.long,
                                device="meta") for k in names}
        res[leg] = [dryrun.rank_trace(cfg, kind, shape, ("data", "model"),
                                      batch, ctx_len=ctx, optimizer=opt,
                                      compress=compress, rank=r,
                                      flops=False)
                    for r in range(math.prod(shape))]
    res["host"] = {}
    for arch, layers, experts, rows, seq, opt, _ in TRAIN_FAMILIES:
        if arch not in HOST_MEMORY_LEGS:
            continue
        cut = {"n_layers": layers} if layers else {}
        if experts:
            cut["n_experts"] = experts
        cfg = get_config(arch).replace(**cut)
        data = SyntheticLM(cfg.vocab_size, seq, rows, seed=SEED)
        batch = {k: torch.empty_like(v, device="meta") for k, v in
                 train.batch_at(data, cfg, 0, SEED, "cpu").items()}
        res["host"][arch] = dryrun.host_trace(cfg, batch, optimizer=opt)
        if arch == MEMORY_PLANT[0]:
            res["planted"] = dryrun.host_trace(cfg, batch, optimizer=opt,
                                               donate=True)
    with open(out, "w") as f:
        json.dump(res, f)


@contextlib.contextmanager
def dryrun_process():
    """The dry-run's predictions of the rank legs (`predict_rank_legs`),
    then of every cell, `launch.dryrun.main(["--all", "--out", <a
    temporary file>])`, in a process of its own on the host's CPU (no
    card visible to it), started now so that it runs beside the card's
    phases, at the lowest CPU priority (nice 19: it takes the cores the
    phases leave idle, and the threaded weight draws keep theirs);
    yields (process, records path, log path, predictions path); the
    process is killed if it still runs on exit."""
    tmp = tempfile.TemporaryDirectory(prefix="drim_dryrun_")
    out = os.path.join(tmp.name, "cells.jsonl")
    legs = os.path.join(tmp.name, "rank_legs.json")
    log = open(os.path.join(tmp.name, "dryrun.log"), "w")
    code = ("import os, sys, time\n"
            "os.nice(19)\n"
            "t0 = time.perf_counter()\n"
            "sys.path.insert(0, sys.argv[3])\n"
            "import chip_smoke\n"
            "chip_smoke.predict_rank_legs(sys.argv[2])\n"
            "print('rank_legs_s', time.perf_counter() - t0)\n"
            "from repro_torch.launch import dryrun\n"
            "rc = dryrun.main(['--all', '--out', sys.argv[1]])\n"
            "print('dryrun_wall_s', time.perf_counter() - t0)\n"
            "sys.exit(rc)\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, "-c", code, out, legs,
                             str(ROOT)], cwd=ROOT, env=env, stdout=log,
                            stderr=subprocess.STDOUT)
    try:
        yield proc, out, log.name, legs
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
        tmp.cleanup()


def phase_dryrun(proc, out: str, log: str, legs: str) -> None:
    """The dry-run's records: every cell of `all_cells()` with status
    "ok" and its rank trace's fields, each cell's per-device argument
    bytes beside the card's memory, rank 0's collective calls and payload
    bytes a step by axis and its wire bytes by kind ("dryrun" lines), and
    the run's wall time on the host; then the rank legs' predictions
    against the ranks' measured steps (`check_rank_legs`)."""
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    rc = proc.wait(timeout=900)
    waited = time.perf_counter() - t0
    text = open(log).read()
    if rc != 0:
        raise AssertionError(f"the dry-run exited {rc}: {text[-3000:]}")
    records = [json.loads(line) for line in open(out)]
    cells = [(r["arch"], r["shape"], r["mesh"]) for r in records]
    if cells != list(dryrun.all_cells()):
        raise AssertionError(f"the dry-run wrote cells {cells}")
    card = torch.cuda.get_device_properties(0).total_memory
    fields = ("collective_counts", "collective_by_kind",
              "collective_bytes_per_device", "collective_calls_by_axis",
              "collective_payload_b_by_axis", "flops_per_device",
              "mem_temp_b", "mem_peak_b")
    for r in records:
        if r["status"] != "ok" or any(k not in r for k in fields) \
                or not r["mem_temp_b"] > 0 or r["mem_peak_b"] != \
                r["mem_argument_b"] + r["mem_temp_b"]:
            raise AssertionError(f"dry-run cell {r}")
        print("dryrun " + json.dumps({
            "cell": f"{r['arch']} {r['shape']} {r['mesh']}",
            "optimizer": r["optimizer"], "lower_s": r["lower_s"],
            "mem_argument_b": r["mem_argument_b"],
            "mem_output_b": r["mem_output_b"],
            "arguments_fit_the_card": r["mem_argument_b"] < card,
            "mem_temp_b": r["mem_temp_b"], "mem_peak_b": r["mem_peak_b"],
            "rank0_argument_b": r["rank_argument_b"],
            "peak_fits_the_card": r["mem_peak_b"] < card,
            "flops_global": r["flops_global"],
            "model_flops_global": r["model_flops_global"],
            "rank0_calls_by_axis": r["collective_calls_by_axis"],
            "rank0_payload_b_by_axis": r["collective_payload_b_by_axis"],
            "rank0_wire_b_by_kind": {
                k: v for k, v in r["collective_by_kind"].items() if v},
            "rank0_wire_b": r["collective_bytes_per_device"],
            "rank0_flops": r["flops_per_device"],
            "rank_trace_s": r["rank_trace_s"]}))
    wall = [float(line.split()[1]) for line in text.splitlines()
            if line.startswith("dryrun_wall_s")]
    legs_s = [float(line.split()[1]) for line in text.splitlines()
              if line.startswith("rank_legs_s")]
    print("dryrun " + json.dumps({
        "cells": len(records), "ok": len(records),
        "fit_the_card": sum(r["mem_argument_b"] < card for r in records),
        "peak_fits_the_card": sum(r["mem_peak_b"] < card
                                  for r in records),
        "card_total_memory_b": card, "phase_wall_s": wall[0],
        "rank_legs_s": legs_s[0], "waited_s": waited}))
    predicted = json.load(open(legs))
    check_rank_legs(predicted)
    check_memory_legs(predicted)


def check_rank_legs(predicted) -> None:
    """Each RANK_LEGS leg's predicted calls and payload bytes a step by
    axis (`predict_rank_legs`) equal, rank for rank, to every step the
    rank measured (MEASURED_RANK_LEGS: `COLLECTIVE_STATS`' "calls:<axes>"
    and "bytes:<axes>"); a "dryrun ranks" line each."""
    for leg in RANK_LEGS:
        for rank, (want, steps) in enumerate(zip(
                predicted[leg], MEASURED_RANK_LEGS[leg])):
            pred = {axes: {"calls": n, "bytes":
                           want["collective_payload_b_by_axis"][axes]}
                    for axes, n in want["collective_calls_by_axis"].items()}
            seen = []
            for got in steps:
                have = {key[len("calls:"):]: {
                    "calls": n, "bytes": got["bytes" + key[len("calls"):]]}
                    for key, n in got.items()
                    if key.startswith("calls:") and n}
                if have not in seen:
                    seen.append(have)
            print("dryrun ranks " + json.dumps({
                "leg": leg, "rank": rank, "steps": len(steps),
                "predicted_per_step": pred, "measured_per_step": seen,
                "equal": seen == [pred]}))
            if seen != [pred] or not steps:
                raise AssertionError(f"dryrun ranks {leg} rank {rank}: "
                                     f"predicted {pred}, measured {seen}")


def check_memory_legs(predicted) -> None:
    """Each leg's predicted temp (the dry-run's mem_temp_b) against the
    allocator's (`measured_temp`) within the bound (`memory_holds`): every
    rank of each RANK_LEGS leg at every step from the second (the first,
    printed beside, also takes the card's one-off buffers), and the
    HOST_MEMORY_LEGS legs' warm repeated step; the planted prediction
    (MEMORY_PLANT) must fail it.  A "dryrun memory" line each."""
    def line(leg, pred, meas, **more):
        held = memory_holds(pred, meas)
        print("dryrun memory " + json.dumps({
            "leg": leg, **more, "predicted_temp_gb": pred / 1e9,
            "measured_temp_gb": meas / 1e9, "ratio": pred / meas,
            "bound": f"{MEMORY_RTOL:.0%}, or {MEMORY_ATOL_B // 2**20} MiB "
                     f"under {MEMORY_SMALL_B / 2**30} GiB",
            "within": held}))
        return held
    failed = []
    for leg in RANK_LEGS:
        for rank, (want, steps) in enumerate(zip(
                predicted[leg], MEASURED_RANK_MEMORY[leg])):
            if len(steps) < 2:
                failed.append(f"{leg} rank {rank}: {len(steps)} steps")
            for i, got in enumerate(steps[1:], 2):
                if not line(leg, want["mem_temp_b"], got, rank=rank,
                            step=i, step1_temp_gb=steps[0] / 1e9):
                    failed.append(f"{leg} rank {rank} step {i}")
    for arch in HOST_MEMORY_LEGS:
        got = MEASURED_HOST_LEGS[arch]
        if not line(f"train families {arch}",
                    predicted["host"][arch]["mem_temp_b"],
                    got["warm_temp_b"], step="warm repeat",
                    steps_temp_gb=[t / 1e9 for t in got["steps_temp_b"]]):
            failed.append(f"train families {arch}")
    arch, what = MEMORY_PLANT
    if line(f"planted {arch}", predicted["planted"]["mem_temp_b"],
            MEASURED_HOST_LEGS[arch]["warm_temp_b"], planted=what):
        failed.append(f"the planted prediction ({what}) held")
    if failed:
        raise AssertionError(f"dryrun memory: {failed}")


def read_counts(wrappers, names, phase: str):
    launches = {name: fn.launches for name, fn in wrappers.items()}
    idle = [n for n in names if launches[n] <= 0]
    if idle:
        raise AssertionError(f"{phase} never launched {idle}")
    print("counts " + json.dumps({"phase": phase, **launches}))
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--ranks-worker"]:
        return ranks_worker(*sys.argv[2:4])
    if sys.argv[1:2] == ["--tp-worker"]:
        return ranks_worker(*sys.argv[2:4], model_axis=int(
            sys.argv[4]) if len(sys.argv) > 4 else TP)
    with dryrun_process() as dry, \
            tempfile.TemporaryDirectory(prefix="drim_draws_") as draws, \
            shared_draws(draws, shared_draw_keys()):
        os.environ[DRAWS_ENV] = draws
        return run(dry)


def run(dry) -> int:
    """Every phase on the card; `dry` is the dry-run's process, which runs
    beside them and is read last."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(SEED)
    install_verify_tally()
    walls, t_last = {}, [time.perf_counter()]

    def lap(phase: str) -> None:
        """The wall seconds since the last lap, as `phase`'s."""
        now = time.perf_counter()
        walls[phase] = now - t_last[0]
        t_last[0] = now
    phase_build()
    lap("build")
    records = phase_kernels(rng)
    check_ste_product(rng)
    lap("kernels")

    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    mark = verify_mark()
    phase_path(rng)
    path_launches = read_counts(wrappers, ("pack_signs", "xnor_gemm",
                                           "aap_interp"), "path")
    verify_line("path", mark)
    lap("path")
    by_leg = verified_phase("serve", lambda: phase_serve(wrappers))
    lap("serve")
    by_leg["families"] = verified_phase("families",
                                        lambda: phase_families(wrappers))
    lap("families")
    by_leg["faults"] = verified_phase("faults",
                                      lambda: phase_faults(wrappers))
    by_leg["bulk"] = verified_phase("bulk", lambda: phase_bulk(wrappers))
    by_leg["analog"] = verified_phase("analog",
                                      lambda: phase_analog(wrappers))
    by_leg.update(verified_phase("queue", lambda: phase_queue(wrappers)))
    by_leg["verdict"] = verified_phase("verdict",
                                       lambda: phase_verdict(wrappers))
    lap("faults to verdict")
    by_leg.update(verified_phase("telemetry",
                                 lambda: phase_telemetry(wrappers)))
    by_leg.update(verified_phase("drim", lambda: phase_drim(wrappers)))
    by_leg["collective"] = verified_phase(
        "collective", lambda: phase_collective(wrappers))
    lap("telemetry to collective")
    by_leg.update(verified_phase("train", lambda: phase_train(wrappers)))
    lap("train")
    by_leg.update(phase_ranks(wrappers))
    lap("ranks")
    # before the tp phase, whose MoE training leg is held to its
    # deepseek-v3 leg's step 1
    by_leg.update(verified_phase(
        "train families", lambda: phase_train_families(wrappers)))
    lap("train families")
    by_leg["tp"] = phase_tp(wrappers)
    lap("tp")
    launches = {name: sum(c[name] for c in by_leg.values())
                for name in wrappers}
    idle = [name for name, n in launches.items() if n <= 0]
    if idle:
        raise AssertionError(f"the main paths never launched {idle}")
    check_prefill_reference()
    check_train_reference()
    lap("check")
    phase_dryrun(*dry)
    lap("dryrun wait")
    print("timing " + json.dumps({"phase_wall_s": walls,
                                  "total_s": sum(walls.values())}))

    meta = {
        "pack_signs": ("src/repro_torch/csrc/pack_signs.cu",
                       "src/repro/kernels/packbits.py:26 _pack_kernel"),
        "xnor_gemm": ("src/repro_torch/csrc/xnor_gemm.cu",
                      "src/repro/kernels/xnor_popcount.py:40 "
                      "_xnor_gemm_kernel"),
        "aap_interp": ("src/repro_torch/csrc/aap_interp.cu",
                       "src/repro/kernels/aap_interpreter.py:64 "
                       "_interp_kernel"),
        "aap_interp_faulted": ("src/repro_torch/csrc/aap_interp.cu",
                               "src/repro/kernels/aap_interpreter.py:106 "
                               "_interp_kernel_faulted"),
        "flash_attn_fwd": ("src/repro_torch/csrc/flash_attn_fwd.cu",
                           "src/repro/kernels/flash_attention.py:48 "
                           "_fwd_kernel"),
        "flash_bwd_dkv": ("src/repro_torch/csrc/flash_attn_bwd.cu",
                          "src/repro/kernels/flash_attention.py:127 "
                          "_bwd_dkv_kernel"),
        "flash_bwd_dq": ("src/repro_torch/csrc/flash_attn_bwd.cu",
                         "src/repro/kernels/flash_attention.py:169 "
                         "_bwd_dq_kernel"),
        "bitwise_not": ("src/repro_torch/csrc/bitwise.cu",
                        "src/repro/kernels/bitwise.py:64 _not_kernel"),
        "bitwise_binary": ("src/repro_torch/csrc/bitwise.cu",
                           "src/repro/kernels/bitwise.py:32 _binary_kernel"),
        "bitwise_ternary": ("src/repro_torch/csrc/bitwise.cu",
                            "src/repro/kernels/bitwise.py:50 "
                            "_ternary_kernel"),
        "bitplane_add": ("src/repro_torch/csrc/bitplane_add.cu",
                         "src/repro/kernels/bitserial_add.py:24 _add_kernel"),
        "unpack_signs": ("src/repro_torch/csrc/unpack_signs.cu",
                         "src/repro/kernels/packbits.py:34 _unpack_kernel"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        r = records[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "launches_by_leg": {leg: c[name] for leg, c in by_leg.items()},
            "path_launches": path_launches[name],
            "max_abs_err": r["max_abs_err"], "max_abs_diff": r["max_abs_err"],
            "ms": r["ms"], "kernel_ms": r["ms"], "call_ms": r["call_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "library_device_ms": r.get("library_device_ms"),
            "library_fp32_ms": r.get("library_fp32_ms"),
            "launch_floor_ms": r.get("launch_floor_ms"),
            "served": r.get("served"), "shape": r["shape"]})
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
